"""A flip-flop pair of ~650 bases under ``--reverse_complement``:
``python -m poreover_tpu_torch pair-decode --device cpu`` writes the same
.1d.fasta and .2d.fasta as ``python -m poreover_tpu pair-decode``, and in
both the consensus is less close to read 1's true sequence than read 1's
own Viterbi call.

Reverse-complementing a flip-flop trace reverses each homopolymer run's
flip / flop order, so an even run of the complement strand starts with a
flop, which the pair model allows only after the same base's flip. The
consensus of such pairs falls below the 1D call in the JAX package too;
``chip_smoke.py`` gates its full-size flip-flop pairs on a floor for that
reason.
"""
import contextlib

import jax
import pytest
import torch

from poreover_tpu.cli import main as jax_main

from poreover_tpu_torch import native
from poreover_tpu_torch.cli import main as torch_main
from poreover_tpu_torch.sim import write_pairs

torch.set_num_threads(1)

SUFFIXES = (".1d.fasta", ".2d.fasta")


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def read_fasta(path):
    return ["".join(r.splitlines()[1:])
            for r in path.read_text().split(">")[1:]]


def identity(a, b):
    x, z = native.global_pair_banded(a, b)
    return sum(p == q for p, q in zip(x, z)) / max(len(x), 1)


@pytest.fixture(scope="module")
def rc_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ff_rc")
    pairs, truth = write_pairs(str(d), 1, seed=31, lo=600, hi=700,
                               kind="flipflop")
    common = ["pair-decode", pairs, "--dir", str(d), "--basecaller",
              "flappie", "--reverse_complement", "--threads", "8"]
    torch_main(common + ["--out", str(d / "t"), "--device", "cpu"])
    with jax_f32():
        jax_main(common + ["--out", str(d / "j")])
    return d, truth[0]


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_fasta_byte_identical(rc_run, suffix):
    d, _ = rc_run
    t = (d / f"t{suffix}").read_bytes()
    assert t == (d / f"j{suffix}").read_bytes()
    assert t.count(b">") == (2 if suffix == ".1d.fasta" else 1)


def test_consensus_below_read1_call(rc_run):
    d, truth = rc_run
    cons = read_fasta(d / "j.2d.fasta")[0]
    call1 = read_fasta(d / "j.1d.fasta")[0]
    assert identity(cons, truth) < identity(call1, truth)
