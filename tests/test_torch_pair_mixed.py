"""``python -m poreover_tpu_torch pair-decode`` over a pairs file of mixed
model kinds on the CPU (the kernels' plain versions) writes the same files as
``python -m poreover_tpu pair-decode``: byte-identical .1d.fasta and
.2d.fasta, and a .log equal apart from its ``vars(args)`` header line.

A pairs file that mixes kinds under ``--basecaller poreover``: a CTC
``.npy`` pair and an 8-column CSV pair, which loads as a flip-flop model.
The JAX package decodes the flip-flop pair on its own; the port keeps one
queue of pending pairs per kind and flushes each as its own waves, so
every pair decodes, and ``--threads 1`` (a wave per pair) writes what
``--threads 8`` does.
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

@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def run_both(d, pairs, basecaller, threads="8"):
    common = ["pair-decode", pairs, "--dir", str(d), "--basecaller",
              basecaller, "--reverse_complement", "--threads", threads]
    torch_main(common + ["--out", str(d / "t"), "--device", "cpu"])
    with jax_f32():
        jax_main(common + ["--out", str(d / "j")])


SUFFIXES = (".1d.fasta", ".2d.fasta")


@pytest.fixture(scope="module")
def mixed_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("mixed")
    p, _ = write_pairs(str(d), 1, seed=13, lo=70, hi=100)
    lines = open(p).read()
    p, _ = write_pairs(str(d), 1, seed=14, lo=70, hi=100, kind="flipflop")
    lines += open(p).read()
    pairs = d / "mixed.txt"
    pairs.write_text(lines)
    common = ["pair-decode", str(pairs), "--dir", str(d), "--basecaller",
              "poreover", "--reverse_complement", "--threads", "8"]
    torch_main(common + ["--out", str(d / "t"), "--device", "cpu"])
    with jax_f32():
        jax_main(common + ["--out", str(d / "j")])
    return d


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_fasta_byte_identical(mixed_run, suffix):
    t = (mixed_run / f"t{suffix}").read_bytes()
    assert t == (mixed_run / f"j{suffix}").read_bytes()
    assert t.count(b">") == (4 if suffix == ".1d.fasta" else 2)
    assert b"s0_1.npy" in t or suffix == ".2d.fasta"


def test_log_equal_but_args_line(mixed_run):
    t = (mixed_run / "t.log").read_text().splitlines()
    j = (mixed_run / "j.log").read_text().splitlines()
    assert len(t) == len(j) == 3 + 2
    assert t[0] == j[0] and t[2] == j[2]
    assert t[3:] == j[3:]
    rows = [r.split("\t") for r in t[3:]]
    assert [r[0] for r in rows] == ["s0_1.npy", "s0_1.csv"]
    assert [r[-1] for r in rows] == ["0", "0"]


def test_threads_do_not_change_output(mixed_run, tmp_path):
    torch_main(["pair-decode", str(mixed_run / "mixed.txt"), "--dir",
                str(mixed_run), "--basecaller", "poreover",
                "--reverse_complement", "--threads", "1", "--out",
                str(tmp_path / "one"), "--device", "cpu"])
    for suffix in SUFFIXES:
        assert (tmp_path / f"one{suffix}").read_bytes() == (
            mixed_run / f"t{suffix}").read_bytes()
