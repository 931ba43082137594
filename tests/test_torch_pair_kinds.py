"""``python -m poreover_tpu_torch pair-decode`` for bonito and flip-flop
traces on the CPU (the kernels' plain versions) writes the same files as
``python -m poreover_tpu pair-decode``: byte-identical .1d.fasta and
.2d.fasta, and a .log equal apart from its ``vars(args)`` header line.

Per kind, a pairs file of two small simulated pairs (bonito ``.npy`` with
the blank in column 0, flip-flop ``.csv`` probabilities, read 2 the
complement strand as sequenced), with the default flags. The JAX package
decodes these kinds pair by pair; the port batches them in waves of one
kind (tests/test_torch_pair_mixed.py mixes kinds in one file,
tests/test_torch_pair_kinds_anchored.py runs ``--skip_matches``).
"""
import contextlib

import jax
import pytest
import torch

from poreover_tpu.cli import main as jax_main

from poreover_tpu_torch.cli import main as torch_main
from poreover_tpu_torch.sim import write_pairs

# the plain version runs many small ops: one intra-op thread is as fast
# and does not oversubscribe the CPU when test workers run in parallel
torch.set_num_threads(1)

BASECALLER = {"bonito": "bonito", "flipflop": "flappie"}


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


SUFFIXES = (".1d.fasta", ".2d.fasta")


def run_both(d, pairs, basecaller, extra=()):
    common = ["pair-decode", pairs, "--dir", str(d), "--basecaller",
              basecaller, "--reverse_complement", "--threads", "8", *extra]
    torch_main(common + ["--out", str(d / "t"), "--device", "cpu"])
    with jax_f32():
        jax_main(common + ["--out", str(d / "j")])


@pytest.fixture(scope="module", params=sorted(BASECALLER))
def kind_run(request, tmp_path_factory):
    kind = request.param
    d = tmp_path_factory.mktemp(kind)
    pairs, _ = write_pairs(str(d), 2, seed=13, lo=70, hi=100, kind=kind)
    run_both(d, pairs, BASECALLER[kind])
    return d


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_fasta_byte_identical(kind_run, suffix):
    t = (kind_run / f"t{suffix}").read_bytes()
    assert t == (kind_run / f"j{suffix}").read_bytes()
    assert t.count(b">") == (4 if suffix == ".1d.fasta" else 2)


def test_log_equal_but_args_line(kind_run):
    t = (kind_run / "t.log").read_text().splitlines()
    j = (kind_run / "j.log").read_text().splitlines()
    assert len(t) == len(j) == 3 + 2
    assert t[0] == j[0] and t[2] == j[2]
    assert t[3:] == j[3:]
    assert [r.split("\t")[-1] for r in t[3:]] == ["0", "0"]


def test_kernel_build_failure_raises(tmp_path, monkeypatch):
    """A Viterbi kernel that does not build ends the run: the pair loop's
    per-pair handler (a corrupt trace skips its pair) lets it through."""
    from poreover_tpu_torch import build
    from poreover_tpu_torch.ops import viterbi as tv

    def no_compiler(name, extra_dirs=()):
        raise RuntimeError(f"{name} not found")

    pairs, _ = write_pairs(str(tmp_path), 1, seed=13, lo=30, hi=40,
                           kind="flipflop")
    monkeypatch.setattr(build, "find_tool", no_compiler)
    monkeypatch.setattr(tv, "_libs", {})
    # stage 1 takes the kernel's route, as for tensors on the card
    monkeypatch.setattr(tv, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        torch_main(["pair-decode", pairs, "--dir", str(tmp_path),
                    "--basecaller", "flappie", "--reverse_complement",
                    "--out", str(tmp_path / "t"), "--device", "cpu"])
