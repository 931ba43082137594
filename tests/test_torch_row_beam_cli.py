"""``pair-decode --beam_search_method row`` of the port on the CPU (the by-row
kernel's plain version) writes the JAX package's files: byte-identical
.1d.fasta and .2d.fasta, and a .log equal apart from its ``vars(args)``
header line, for all three kinds (poreover, bonito and flip-flop traces),
plain and anchored (``--skip_matches``). The port batches waves of pairs,
or a wave's anchored boxes, through one search; the JAX package decodes
them one by one. Also: ``--threads 1`` against ``--threads 8``, and
``--exact`` over the traversal (``--exact --beam_search_method row``
writes what ``--exact`` alone writes, in both packages)."""
import contextlib

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.cli import main as jax_main

from poreover_tpu_torch.cli import main as torch_main
from poreover_tpu_torch.ops import pair_row_beam as prb
from poreover_tpu_torch.sim import synth_read_pair, write_pairs

torch.set_num_threads(1)

BASECALLER = {"poreover": "poreover", "bonito": "bonito",
              "flipflop": "flappie"}


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def pairs_file(d, kind, n, seed):
    """n small simulated pairs of ``kind`` (~100-300 rows), and for
    poreover an unrelated pair that takes the identity < 0.5 skip row."""
    pairs, _ = write_pairs(str(d), n, seed=seed, lo=14, hi=40, kind=kind)
    if kind == "poreover":
        rng = np.random.default_rng(99)
        np.save(d / "u_1.npy", synth_read_pair(rng, 30)[0])
        np.save(d / "u_2.npy", synth_read_pair(rng, 30)[0])
        with open(pairs, "a") as f:
            f.write("u_1.npy\tu_2.npy\n")
    return pairs


def run_both(d, pairs, kind, name, flags, threads="4"):
    common = ["pair-decode", pairs, "--dir", str(d), "--basecaller",
              BASECALLER[kind], "--reverse_complement", "--threads",
              threads] + flags
    torch_main(common + ["--out", str(d / f"t_{name}"), "--device", "cpu"])
    with jax_f32():
        jax_main(common + ["--out", str(d / f"j_{name}")])


def same_files(d, a, b):
    for suffix in (".1d.fasta", ".2d.fasta"):
        assert (d / f"{a}{suffix}").read_bytes() == (
            d / f"{b}{suffix}").read_bytes(), suffix
    ta = (d / f"{a}.log").read_text().splitlines()
    tb = (d / f"{b}.log").read_text().splitlines()
    assert ta[0] == tb[0] and ta[2:] == tb[2:]
    return ta


ROW = ["--beam_search_method", "row"]
ANCHORED = ROW + ["--skip_matches", "--skip_threshold", "4"]


@pytest.fixture(scope="module")
def ctc_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("row_ctc")
    pairs = pairs_file(d, "poreover", 3, seed=41)
    before = prb.launch_count
    run_both(d, pairs, "poreover", "row", ROW)
    run_both(d, pairs, "poreover", "anch", ANCHORED)
    assert prb.launch_count == before  # the CPU runs the plain version
    return d, pairs


@pytest.mark.parametrize("name", ["row", "anch"])
def test_ctc_files_equal_the_jax_packages(ctc_runs, name):
    d, _ = ctc_runs
    log = same_files(d, f"t_{name}", f"j_{name}")
    assert [r.split("\t")[-1] for r in log[3:]] == ["0"] * 3 + ["1"]
    assert (d / f"t_{name}.2d.fasta").read_text().count(">") == 3


@pytest.mark.parametrize("name,flags", [("row", ROW), ("anch", ANCHORED)])
def test_threads_do_not_change_the_files(ctc_runs, name, flags):
    """One pair a wave against all of them in one wave (boxes: the wave's
    boxes in one search)."""
    d, pairs = ctc_runs
    for threads in ("1", "8"):
        torch_main(["pair-decode", pairs, "--dir", str(d), "--basecaller",
                    "poreover", "--reverse_complement", "--threads",
                    threads, "--out", str(d / f"t{threads}_{name}"),
                    "--device", "cpu"] + flags)
        same_files(d, f"t{threads}_{name}", f"t_{name}")


@pytest.mark.parametrize("kind", ["bonito", "flipflop"])
def test_other_kinds_equal_the_jax_packages(tmp_path, kind):
    pairs = pairs_file(tmp_path, kind, 2, seed=43)
    for name, flags in (("row", ROW), ("anch", ANCHORED)):
        run_both(tmp_path, pairs, kind, name, flags)
        log = same_files(tmp_path, f"t_{name}", f"j_{name}")
        assert len(log) == 3 + 2


def test_exact_takes_precedence_over_the_traversal(ctc_runs):
    """``--exact --beam_search_method row`` exited naming A13 before; it
    runs the graveyard engine, as ``--exact`` alone does, in both
    packages."""
    d, pairs = ctc_runs
    run_both(d, pairs, "poreover", "exact_row", ["--exact"] + ROW)
    same_files(d, "t_exact_row", "j_exact_row")
    torch_main(["pair-decode", pairs, "--dir", str(d), "--basecaller",
                "poreover", "--reverse_complement", "--threads", "4",
                "--exact", "--out", str(d / "t_exact"), "--device", "cpu"])
    same_files(d, "t_exact_row", "t_exact")
