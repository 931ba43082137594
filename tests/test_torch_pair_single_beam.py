"""``python -m poreover_tpu_torch pair-decode --single beam`` on the CPU
(the plain versions of the 1D beam and of the acceptor) writes the same
files as ``python -m poreover_tpu pair-decode --single beam``:
byte-identical .1d.fasta and .2d.fasta, and a .log equal apart from its
``vars(args)`` header line.

Per model kind (poreover and bonito ``.npy``, flip-flop ``.csv``), a pairs
file of three small simulated pairs, read 2 the complement strand as
sequenced, ``--reverse_complement``; stage 1 is the 1D beam search at
width 25 and the banded Viterbi acceptor of its string, whose path maps
the signal to the sequence. The port takes G (the acceptor's gap prefix
sums) as float64 sums rounded once, the JAX package as XLA's float32
cumsum; the files are the same all the same.

Both packages skip some pairs of the two other kinds, as the reference
does: the acceptor's path puts the gap character between emissions, and
``get_sequence_mapping`` reads a bonito path as repeat-collapsed (a base
emitted at the step after the same base is merged: the pair is skipped
when that happens) and a flip-flop path as changes of state (every gap
between two emissions counts: every flip-flop pair is skipped). The
skipped rows must be the same rows.
"""
import contextlib

import jax
import pytest
import torch

from poreover_tpu.cli import main as jax_main

from poreover_tpu_torch.cli import main as torch_main
from poreover_tpu_torch.ops import acceptor as ta
from poreover_tpu_torch.ops import beam1d
from poreover_tpu_torch.sim import write_pairs

torch.set_num_threads(1)

BASECALLER = {"poreover": "poreover", "bonito": "bonito",
              "flipflop": "flappie"}
SUFFIXES = (".1d.fasta", ".2d.fasta")


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module", params=sorted(BASECALLER))
def kind_run(request, tmp_path_factory):
    kind = request.param
    d = tmp_path_factory.mktemp(kind)
    pairs, _ = write_pairs(str(d), 3, seed=17, lo=70, hi=100, kind=kind)
    common = ["pair-decode", pairs, "--dir", str(d), "--basecaller",
              BASECALLER[kind], "--reverse_complement", "--single", "beam",
              "--threads", "8"]
    launches = (ta.launch_count, beam1d.launch_count)
    torch_main(common + ["--out", str(d / "t"), "--device", "cpu"])
    assert (ta.launch_count, beam1d.launch_count) == launches
    with jax_f32():
        jax_main(common + ["--out", str(d / "j")])
    return kind, d


# the pairs each kind's run decodes (the others are skipped, see above)
DECODED = {"poreover": 3, "bonito": 1, "flipflop": 0}


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_fasta_byte_identical(kind_run, suffix):
    kind, d = kind_run
    t = (d / f"t{suffix}").read_bytes()
    assert t == (d / f"j{suffix}").read_bytes()
    n = DECODED[kind]
    assert t.count(b">") == (2 * n if suffix == ".1d.fasta" else n)


def test_log_equal_but_args_line(kind_run):
    kind, d = kind_run
    t = (d / "t.log").read_text().splitlines()
    j = (d / "j.log").read_text().splitlines()
    assert len(t) == len(j) == 3 + 3
    assert t[0] == j[0] and t[2] == j[2]
    assert t[3:] == j[3:]
    assert [r.split("\t")[-1] for r in t[3:]].count("0") == DECODED[kind]
