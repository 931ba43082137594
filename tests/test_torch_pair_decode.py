"""``python -m poreover_tpu_torch pair-decode`` on the CPU (the kernel's
plain version) writes the same files as ``python -m poreover_tpu
pair-decode``: byte-identical .1d.fasta and .2d.fasta, and a .log equal
apart from its ``vars(args)`` header line. The pairs file holds three
small simulated pairs and one unrelated pair, which takes the
identity < 0.5 skip row."""
import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.cli import main as jax_main

from poreover_tpu_torch.cli import main as torch_main
from poreover_tpu_torch.sim import synth_read_pair, write_pairs

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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pairs")
    pairs, _ = write_pairs(str(d), 3, seed=13, lo=110, hi=150)
    rng = np.random.default_rng(99)
    a, _ = synth_read_pair(rng, 130)
    b, _ = synth_read_pair(rng, 130)
    np.save(d / "u_1.npy", a)
    np.save(d / "u_2.npy", b)
    with open(pairs, "a") as f:
        f.write("u_1.npy\tu_2.npy\n")
    common = ["pair-decode", pairs, "--dir", str(d), "--basecaller",
              "poreover", "--reverse_complement", "--threads", "4"]
    torch_main(common + ["--out", str(d / "t"), "--device", "cpu"])
    with jax_f32():
        jax_main(common + ["--out", str(d / "j")])
    return d


@pytest.mark.parametrize("suffix", [".1d.fasta", ".2d.fasta"])
def test_fasta_byte_identical(runs, suffix):
    t = (runs / f"t{suffix}").read_bytes()
    j = (runs / f"j{suffix}").read_bytes()
    assert t == j
    assert t.count(b">") == (6 if suffix == ".1d.fasta" else 3)


def test_log_equal_but_args_line(runs):
    t = (runs / "t.log").read_text().splitlines()
    j = (runs / "j.log").read_text().splitlines()
    assert len(t) == len(j) == 3 + 4
    assert t[0] == j[0] and t[2] == j[2]
    assert t[3:] == j[3:]
    rows = [r.split("\t") for r in t[3:]]
    assert [r[-1] for r in rows] == ["0", "0", "0", "1"]
    assert float(rows[3][4]) < 0.5


def test_threads_do_not_change_output(runs, tmp_path):
    pairs = str(runs / "pairs.txt")
    torch_main(["pair-decode", pairs, "--dir", str(runs), "--basecaller",
                "poreover", "--reverse_complement", "--threads", "1",
                "--out", str(tmp_path / "one"), "--device", "cpu"])
    for suffix in (".1d.fasta", ".2d.fasta"):
        assert (tmp_path / f"one{suffix}").read_bytes() == (
            runs / f"t{suffix}").read_bytes()


def test_two_read_form(runs):
    args = ["pair-decode", str(runs / "s1_1.npy"), str(runs / "s1_2.npy"),
            "--basecaller", "poreover", "--reverse_complement"]
    torch_main(args + ["--out", str(runs / "two_t"), "--device", "cpu"])
    with jax_f32():
        jax_main(args + ["--out", str(runs / "two_j")])
    t = (runs / "two_t.fasta").read_text()
    assert t == (runs / "two_j.fasta").read_text()
    assert t.startswith(">consensus;s1_1;s1_2")


@pytest.mark.parametrize("flag", ["--exact", "--f64"])
def test_exact_and_f64_write_the_jax_packages_files(runs, tmp_path, flag):
    """``--exact`` and ``--f64`` exited naming ROADMAP A11 before; now each
    decodes the pairs file to the JAX package's files with the same flag
    (--f64: float64 on the CPU in both; tests/test_torch_exact_cli.py and
    tests/test_torch_f64.py cover more runs)."""
    common = ["pair-decode", str(runs / "pairs.txt"), "--dir", str(runs),
              "--basecaller", "poreover", "--reverse_complement",
              "--threads", "4", flag]
    torch_main(common + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", flag == "--f64")
    try:
        jax_main(common + ["--out", str(tmp_path / "j")])
    finally:
        jax.config.update("jax_enable_x64", old)
    for suffix in (".1d.fasta", ".2d.fasta"):
        assert (tmp_path / f"t{suffix}").read_bytes() == (
            tmp_path / f"j{suffix}").read_bytes()
    t = (tmp_path / "t.log").read_text().splitlines()
    assert t[3:] == (tmp_path / "j.log").read_text().splitlines()[3:]
    assert [r.split("\t")[-1] for r in t[3:]] == ["0", "0", "0", "1"]


@pytest.mark.parametrize("basecaller,kind", [("bonito", "bonito"),
                                             ("flappie", "flipflop")])
def test_bonito_and_flipflop_pairs_decode(tmp_path, basecaller, kind):
    """The two kinds that exited before (ROADMAP A2b) now decode: the
    two-read form writes a consensus record (tests/test_torch_pair_kinds.py
    holds the files to the JAX package's)."""
    _, truth = write_pairs(str(tmp_path), 1, seed=3, lo=40, hi=50,
                           kind=kind)
    ext = ".csv" if kind == "flipflop" else ".npy"
    torch_main(["pair-decode", str(tmp_path / f"s0_1{ext}"),
                str(tmp_path / f"s0_2{ext}"), "--basecaller", basecaller,
                "--reverse_complement", "--out", str(tmp_path / "o"),
                "--device", "cpu"])
    rec = (tmp_path / "o.fasta").read_text().splitlines()
    assert rec[0] == ">consensus;s0_1;s0_2"
    assert 20 < len(rec[1]) < 2 * len(truth[0])


@pytest.mark.parametrize("cmd", [
    ["train", "--data", "d.npz", "--device", "cpu"],
    # call runs (ROADMAP A8, A9); a directory that is not a TF bundle or a
    # checkpoint of the port's trainer (the JAX package's orbax format)
    # exits naming the converter
    ["call", "x.fast5", "--weights", ".", "--device", "cpu"],
    ["call", "x.fast5", "--decode", "beam", "--weights", ".", "--device",
     "cpu"],
    ["benchmark", "--reference", "r.fa"]])
def test_other_subcommands_exit(cmd, tmp_path, monkeypatch):
    """The other subcommands are ported (train A12, benchmark A15): each
    runs and stops on its missing input, in an empty directory."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "r.fa").write_text(">chr1\nACGT\n")
    expect = {"train": (FileNotFoundError, "d.npz"),
              "call": (SystemExit, "orbax_to_torch"),
              "benchmark": (SystemExit, "required")}[cmd[0]]
    with pytest.raises(expect[0], match=expect[1]):
        torch_main(cmd)


def test_cpu_run_leaves_kernel_unlaunched(runs):
    from poreover_tpu_torch.ops import pair_beam_batch

    assert pair_beam_batch.launch_count == 0
    assert os.path.exists(runs / "t.2d.fasta")
