"""``pair-decode --algorithm prefix`` on the CPU (the plain versions of the
gamma and prefix-level kernels) writes the JAX package's files: the
.1d.fasta and .2d.fasta byte for byte, the .log equal apart from its
``vars(args)`` line; with and without ``--skip_matches``, at ``--threads``
1 and 4, and under ``--f64`` (the JAX package with x64 on). The port
searches a wave's pairs, or its pairs' anchor boxes, in one batch where
the JAX package decodes them one by one. Bonito pairs are skipped in
both: the prefix search takes plain-CTC pairs only."""
import contextlib

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
def jax_x64(on: bool):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


# 27 boxes across the three pairs (at 3, 50 boxes: the JAX package
# compiles its search anew for each box shape)
ANCHORED = ["--skip_matches", "--skip_threshold", "5"]
# (name, --threads, more flags, run the JAX package too, its x64)
RUNS = [("env_4", 4, [], True, False),
        ("env_1", 1, [], False, False),
        ("box_4", 4, ANCHORED, True, False),
        ("box_1", 1, ANCHORED, False, False),
        ("f64_4", 4, ["--f64"], True, True),
        ("exact_4", 4, ["--exact"], False, False),
        ("grid_4", 4, ["--beam_search_method", "grid"], False, False)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three small simulated pairs and one unrelated pair (the identity <
    0.5 skip row), through both packages."""
    d = tmp_path_factory.mktemp("prefix")
    pairs, _ = write_pairs(str(d), 3, seed=13, lo=110, hi=150)
    rng = np.random.default_rng(99)
    a, _ = synth_read_pair(rng, 130)
    b, _ = synth_read_pair(rng, 130)
    np.save(d / "u_1.npy", a)
    np.save(d / "u_2.npy", b)
    with open(pairs, "a") as f:
        f.write("u_1.npy\tu_2.npy\n")
    for name, thr, extra, with_jax, x64 in RUNS:
        common = ["pair-decode", pairs, "--dir", str(d), "--basecaller",
                  "poreover", "--reverse_complement", "--threads", str(thr),
                  "--algorithm", "prefix", *extra]
        torch_main(common + ["--out", str(d / f"t_{name}"), "--device",
                             "cpu"])
        if with_jax:
            with jax_x64(x64):
                jax_main(common + ["--out", str(d / f"j_{name}")])
    return d


def _log(path):
    lines = path.read_text().splitlines()
    return lines[:1] + lines[2:]  # all but the vars(args) line


@pytest.mark.parametrize("name", ["env_4", "box_4", "f64_4"])
@pytest.mark.parametrize("suffix", [".1d.fasta", ".2d.fasta"])
def test_files_byte_identical(runs, name, suffix):
    t = (runs / f"t_{name}{suffix}").read_bytes()
    assert t == (runs / f"j_{name}{suffix}").read_bytes()
    assert t.count(b">") >= (2 if suffix == ".1d.fasta" else 1)


@pytest.mark.parametrize("name", ["env_4", "box_4", "f64_4"])
def test_log_equal_but_args_line(runs, name):
    t = _log(runs / f"t_{name}.log")
    assert t == _log(runs / f"j_{name}.log")
    assert len(t) == 2 + 4
    assert t[-1].split("\t")[-1] == "1"  # the unrelated pair


def test_the_pairs_decode(runs):
    """Without anchors every simulated pair decodes (and its consensus is
    not empty); with anchors at least one pair decodes through boxes."""
    rows = [r.split("\t") for r in _log(runs / "t_env_4.log")[2:]]
    assert [r[-1] for r in rows] == ["0", "0", "0", "1"]
    cons = (runs / "t_env_4.2d.fasta").read_text().split(">")[1:]
    assert len(cons) == 3 and all(len(c.splitlines()[1]) > 50 for c in cons)
    rows = [r.split("\t") for r in _log(runs / "t_box_4.log")[2:]]
    assert "0" in [r[-1] for r in rows]


@pytest.mark.parametrize("one,four", [("env_1", "env_4"),
                                      ("box_1", "box_4")])
@pytest.mark.parametrize("suffix", [".1d.fasta", ".2d.fasta", ".log"])
def test_threads_do_not_change_output(runs, one, four, suffix):
    if suffix == ".log":
        assert _log(runs / f"t_{one}{suffix}") == _log(
            runs / f"t_{four}{suffix}")
    else:
        assert (runs / f"t_{one}{suffix}").read_bytes() == (
            runs / f"t_{four}{suffix}").read_bytes()


@pytest.mark.parametrize("flag", ["exact", "grid"])
@pytest.mark.parametrize("suffix", [".1d.fasta", ".2d.fasta"])
def test_beam_only_flags_do_not_apply_to_prefix(runs, flag, suffix):
    """``--exact`` and ``--beam_search_method`` select the beam search's
    engine and traversal; the prefix search ignores them, as the JAX
    package does (``--beam_search_method grid`` exits naming A13 only
    for the beam search)."""
    assert (runs / f"t_{flag}_4{suffix}").read_bytes() == (
        runs / f"t_env_4{suffix}").read_bytes()


def test_two_read_form(runs):
    args = ["pair-decode", str(runs / "s1_1.npy"), str(runs / "s1_2.npy"),
            "--basecaller", "poreover", "--reverse_complement",
            "--algorithm", "prefix"]
    torch_main(args + ["--out", str(runs / "two_t"), "--device", "cpu"])
    with jax_x64(False):
        jax_main(args + ["--out", str(runs / "two_j")])
    t = (runs / "two_t.fasta").read_text()
    assert t == (runs / "two_j.fasta").read_text()
    assert t.startswith(">consensus;s1_1;s1_2")


def test_bonito_pairs_are_skipped_in_both(tmp_path):
    """The JAX package asserts a CTC model under prefix search and its
    `pair_decode` logs such a pair as skipped; so does the port."""
    pairs, _ = write_pairs(str(tmp_path), 2, seed=5, lo=60, hi=80,
                           kind="bonito")
    common = ["pair-decode", pairs, "--dir", str(tmp_path), "--basecaller",
              "bonito", "--reverse_complement", "--algorithm", "prefix"]
    torch_main(common + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    with jax_x64(False):
        jax_main(common + ["--out", str(tmp_path / "j")])
    for suffix in (".1d.fasta", ".2d.fasta"):
        t = (tmp_path / f"t{suffix}").read_bytes()
        assert t == (tmp_path / f"j{suffix}").read_bytes() == b""
    t = _log(tmp_path / "t.log")
    assert t == _log(tmp_path / "j.log")
    assert [r.split("\t")[-1] for r in t[2:]] == ["1", "1"]
