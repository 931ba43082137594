"""``pair-decode --method split`` and ``--method align`` of the port on the
CPU write the JAX package's files: the .1d.fasta and .2d.fasta byte for
byte, the .log equal apart from its ``vars(args)`` line. Each box is
decoded densely: the by-row beam search (CTC, bonito and flip-flop
traces) or the pair prefix search (``--algorithm prefix``, CTC); the port
batches a wave's boxes into one search where the JAX package decodes them
one by one. Also: one box (``U <= --window``), boxes with no row or no
column (the 1D prefix search), a box of one cell, a prefix box over
``MEM_LIMIT`` (patched in both packages) and one the JAX search raises
on, ``--debug``'s ``debug.p``, ``--threads 1`` against 4, ``--f64``, and
no kernel launched on the CPU. The kernels on dense boxes, on the card:
tests/test_torch_row_kernel.py and tests/test_torch_kernel.py (which
import no jax)."""
import contextlib
import logging
import pickle
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.cli import main as jax_main
from poreover_tpu.decoding import pair as jax_pair

from poreover_tpu_torch.cli import main as torch_main
from poreover_tpu_torch.decoding import pair as torch_pair
from poreover_tpu_torch.ops import gamma as gm
from poreover_tpu_torch.ops import pair_beam_batch as pbb
from poreover_tpu_torch.ops import pair_prefix as pps
from poreover_tpu_torch.ops import pair_row_beam as prb
from poreover_tpu_torch.sim import synth_read_pair, write_pairs

torch.set_num_threads(1)

BASECALLER = {"poreover": "poreover", "bonito": "bonito",
              "flipflop": "flappie"}
SPLIT = ["--method", "split", "--window", "20"]
ALIGN = ["--method", "align", "--skip_threshold", "3"]
PREFIX = ["--algorithm", "prefix"]


@contextlib.contextmanager
def jax_x64(on: bool = False):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def run_both(d, pairs, kind, name, flags, threads="4", x64=False):
    common = ["pair-decode", pairs, "--dir", str(d), "--basecaller",
              BASECALLER[kind], "--reverse_complement", "--threads",
              threads] + flags
    torch_main(common + ["--out", str(d / f"t_{name}"), "--device", "cpu"])
    with jax_x64(x64):
        jax_main(common + ["--out", str(d / f"j_{name}")])


def same_files(d, a, b):
    for suffix in (".1d.fasta", ".2d.fasta"):
        assert (d / f"{a}{suffix}").read_bytes() == (
            d / f"{b}{suffix}").read_bytes(), suffix
    ta = (d / f"{a}.log").read_text().splitlines()
    tb_ = (d / f"{b}.log").read_text().splitlines()
    assert ta[0] == tb_[0] and ta[2:] == tb_[2:]
    return ta


def launches():
    return (prb.launch_count, gm.launch_count, pps.launch_count,
            pbb.launch_count, pbb.single_launch_count,
            pbb.exact_launch_count)


# (name, flags): the CTC runs of both packages on the module's pairs file
CTC_RUNS = [("split", SPLIT), ("split_prefix", SPLIT + PREFIX),
            ("align", ALIGN), ("align_prefix", ALIGN + PREFIX)]


@pytest.fixture(scope="module")
def ctc_runs(tmp_path_factory):
    """Three small simulated CTC pairs and an unrelated pair (split
    decodes it; align skips it at identity < 0.5), through both
    packages in every CTC mode."""
    d = tmp_path_factory.mktemp("split_align")
    pairs, _ = write_pairs(str(d), 3, seed=41, lo=14, hi=40)
    rng = np.random.default_rng(99)
    np.save(d / "u_1.npy", synth_read_pair(rng, 30)[0])
    np.save(d / "u_2.npy", synth_read_pair(rng, 30)[0])
    with open(pairs, "a") as f:
        f.write("u_1.npy\tu_2.npy\n")
    before = launches()
    for name, flags in CTC_RUNS:
        run_both(d, pairs, "poreover", name, flags)
    assert launches() == before  # the CPU runs the plain versions
    return d, pairs


@pytest.mark.parametrize("name", [n for n, _ in CTC_RUNS])
def test_ctc_files_equal_the_jax_packages(ctc_runs, name):
    d, _ = ctc_runs
    log = same_files(d, f"t_{name}", f"j_{name}")
    n_cons = (d / f"t_{name}.2d.fasta").read_text().count(">")
    if name.startswith("split"):
        # no 1D stage and no skip rule: read names alone, every pair
        assert [len(r.split("\t")) for r in log[3:]] == [2] * 4
        assert n_cons == 4
        assert (d / f"t_{name}.1d.fasta").read_text() == ""
    else:
        assert [r.split("\t")[-1] for r in log[3:]] == ["0"] * 3 + ["1"]
        assert n_cons == 3


@pytest.mark.parametrize("name,flags", [("split", SPLIT),
                                        ("align_prefix", ALIGN + PREFIX)])
def test_threads_do_not_change_the_files(ctc_runs, name, flags):
    """One pair a wave against all four in one wave (their boxes in one
    by-row launch, or in one batched prefix search)."""
    d, pairs = ctc_runs
    torch_main(["pair-decode", pairs, "--dir", str(d), "--basecaller",
                "poreover", "--reverse_complement", "--threads", "1",
                "--out", str(d / f"t1_{name}"), "--device", "cpu"] + flags)
    same_files(d, f"t1_{name}", f"t_{name}")


@pytest.mark.parametrize("kind,name,flags", [
    ("bonito", "split", SPLIT), ("bonito", "align", ALIGN),
    ("flipflop", "split", SPLIT)])
def test_other_kinds_equal_the_jax_packages(tmp_path, kind, name, flags):
    pairs, _ = write_pairs(str(tmp_path), 2, seed=43, lo=14, hi=40,
                           kind=kind)
    run_both(tmp_path, pairs, kind, name, flags)
    log = same_files(tmp_path, f"t_{name}", f"j_{name}")
    assert len(log) == 3 + 2


def test_prefix_is_for_ctc_pairs_only(tmp_path):
    """``--algorithm prefix`` asserts CTC traces at a pair's first box
    with a 2D search: both packages skip a bonito pair."""
    pairs, _ = write_pairs(str(tmp_path), 1, seed=43, lo=14, hi=40,
                           kind="bonito")
    run_both(tmp_path, pairs, "bonito", "p", SPLIT + PREFIX)
    log = same_files(tmp_path, "t_p", "j_p")
    assert log[3].split("\t")[-1] == "1"


@pytest.mark.parametrize("flags", [[], PREFIX])
def test_one_box_when_read_1_fits_the_window(tmp_path, flags):
    """``U <= --window``: one box over the whole lattice."""
    pairs, _ = write_pairs(str(tmp_path), 2, seed=47, lo=14, hi=30)
    run_both(tmp_path, pairs, "poreover", "one",
             ["--method", "split", "--window", "100000"] + flags)
    same_files(tmp_path, "t_one", "j_one")


@pytest.mark.parametrize("flags", [[], PREFIX])
@pytest.mark.parametrize("U", [124, 125])
def test_boxes_with_no_column(tmp_path, flags, U):
    """Read 2 cut to a fifth of read 1 and a window of 2 rows: most boxes
    have no column of read 2 (read 1's 1D prefix search), the others a
    single one. At U = 125 the last box has one row, which the by-row
    search has nothing to search in (its rows are 1..U-1): both packages
    skip the pair under ``--algorithm beam``."""
    y1, y2 = synth_read_pair(np.random.default_rng(5), 20)
    assert len(y1) >= U
    np.save(tmp_path / "a.npy", y1[:U])
    np.save(tmp_path / "b.npy", y2[:len(y2) // 5])
    (tmp_path / "pairs.txt").write_text("a.npy\tb.npy\n")
    run_both(tmp_path, str(tmp_path / "pairs.txt"), "poreover", "cols",
             ["--method", "split", "--window", "2"] + flags)
    log = same_files(tmp_path, "t_cols", "j_cols")
    skipped = U % 2 == 1 and not flags
    assert log[3].endswith("\t1") == skipped


def test_prefix_box_over_the_memory_limit(ctc_runs, monkeypatch):
    """MEM_LIMIT patched in both packages below the larger boxes: those
    give "" and the error line, the others their search."""
    d, pairs = ctc_runs
    for mod in (jax_pair, torch_pair):
        monkeypatch.setattr(mod, "MEM_LIMIT", 8 * 300)
    run_both(d, pairs, "poreover", "mem", SPLIT + PREFIX)
    same_files(d, "t_mem", "j_mem")
    assert (d / "t_mem.2d.fasta").read_bytes() != (
        d / "t_split_prefix.2d.fasta").read_bytes()


def warnings_of(caplog, name):
    return [(r.levelno, r.getMessage()) for r in caplog.records
            if r.name == name and r.levelno >= logging.WARNING]


def torch_box(args, y1, y2, u1, u2, v1, v2):
    """The port's decode of one box as a pair's only box (u1, string)."""
    return torch_pair._dense_decode(args, "poreover", y1, y2,
                                    [(u1, u2, v1, v2)], lambda b: b[0], None)


def box_args(**kw):
    a = dict(algorithm="beam", beam_width=5, device="cpu", f64=False)
    a.update(kw)
    return SimpleNamespace(**a)


@pytest.fixture(scope="module")
def box_pair():
    y1, y2 = synth_read_pair(np.random.default_rng(3), 12)
    return y1, y2[::-1, [3, 2, 1, 0, 4]].copy()


# (u1, u2, v1, v2) relative to the reads' ends; a box past read 1's end
# makes the JAX prefix search raise (an empty read)
EDGE_BOXES = {"one cell": (3, 3, 5, 5), "no row": (4, 4, 2, 30),
              "no column": (2, 30, 6, 6), "plain": (5, 40, 3, 44),
              "past read 1": (1000, 1004, 0, 9)}


@pytest.mark.parametrize("algorithm", ["beam", "prefix"])
@pytest.mark.parametrize("box", list(EDGE_BOXES))
def test_box_rules_equal_the_jax_packages(box_pair, caplog, algorithm, box):
    """One box through the JAX package's ``_consensus_box_fn`` and the
    port's: the same (u1, string), stderr line and log records; or, for
    the by-row search on a box it cannot search, the same exception."""
    y1, y2 = box_pair
    args = box_args(algorithm=algorithm)
    u1, u2, v1, v2 = EDGE_BOXES[box]
    caplog.set_level(logging.INFO)
    jfn = jax_pair._consensus_box_fn(args, "poreover")
    if algorithm == "beam" and box == "past read 1":
        with jax_x64(), pytest.raises(ValueError):
            jfn(y1, y2, 0, 0, u1, u2, v1, v2)
        with pytest.raises(ValueError):
            torch_box(args, y1, y2, u1, u2, v1, v2)
        return
    with jax_x64():
        want = jfn(y1, y2, 0, 0, u1, u2, v1, v2)
    jrec = warnings_of(caplog, "poreover_tpu")
    caplog.clear()
    assert torch_box(args, y1, y2, u1, u2, v1, v2) == want
    assert warnings_of(caplog, "poreover_tpu_torch") == jrec
    if box == "past read 1":
        assert want == (1000, "") and jrec == [
            (logging.WARNING, "Error while basecalling box 1000-1004:0-9")]
    elif box != "one cell":
        assert want[1]


def test_box_over_the_memory_limit_logs_the_same(box_pair, caplog,
                                                 monkeypatch):
    y1, y2 = box_pair
    for mod in (jax_pair, torch_pair):
        monkeypatch.setattr(mod, "MEM_LIMIT", 8 * 36 * 42 - 1)
    args = box_args(algorithm="prefix")
    caplog.set_level(logging.INFO)
    got = []
    for fn, name in ((jax_pair._consensus_box_fn(args, "poreover"),
                      "poreover_tpu"),
                     (lambda *a: torch_box(args, *a[:2], *a[4:]),
                      "poreover_tpu_torch")):
        caplog.clear()
        with jax_x64():
            out = fn(y1, y2, 0, 0, 5, 40, 3, 44)
        got.append((out, warnings_of(caplog, name)))
    assert got[0] == got[1] == (
        (5, ""), [(logging.ERROR, "Box too large to basecall 5-40:3-44 "
                                  "(size: 1512 elements)")])


def test_stderr_lines_equal_the_jax_packages(tmp_path, capsys):
    """The box lines a two-read run prints (``b``/``b_tot``, the box and
    its size), and the two-read form's FASTA."""
    pairs, _ = write_pairs(str(tmp_path), 1, seed=41, lo=14, hi=40)
    argv = ["pair-decode", str(tmp_path / "s0_1.npy"),
            str(tmp_path / "s0_2.npy"), "--basecaller", "poreover",
            "--reverse_complement"] + SPLIT
    lines = []
    for main, name, extra in ((torch_main, "t", ["--device", "cpu"]),
                              (jax_main, "j", [])):
        capsys.readouterr()
        with jax_x64():
            main(argv + ["--out", str(tmp_path / name)] + extra)
        lines.append([x for x in capsys.readouterr().err.splitlines()
                      if "Basecalling box" in x])
    assert lines[0] == lines[1] and len(lines[0]) > 1
    t = (tmp_path / "t.fasta").read_text()
    assert t == (tmp_path / "j.fasta").read_text()
    assert t.startswith(">consensus;split;s0_1;s0_2")


def test_debug_pickle_under_align(tmp_path, monkeypatch):
    """``--debug`` under ``--method align`` dumps the anchors' debug.p,
    as the JAX package does, and decodes the boxes all the same."""
    write_pairs(str(tmp_path), 1, seed=41, lo=14, hi=40)
    dumps = []
    for main, name, extra in ((torch_main, "t", ["--device", "cpu"]),
                              (jax_main, "j", [])):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        with jax_x64():
            main(["pair-decode", str(tmp_path / "s0_1.npy"),
                  str(tmp_path / "s0_2.npy"), "--basecaller", "poreover",
                  "--reverse_complement", "--debug", "--out",
                  str(tmp_path / name)] + ALIGN + extra)
        with open(cwd / "debug.p", "rb") as f:
            dumps.append(pickle.load(f))
    t, j = dumps
    assert sorted(t) == sorted(j) and "basecall_boxes" in t
    for k in j:
        assert np.array_equal(np.asarray(t[k]), np.asarray(j[k])), k
    assert (tmp_path / "t.fasta").read_text() == (
        tmp_path / "j.fasta").read_text()


@pytest.mark.parametrize("name,flags", [("split", SPLIT),
                                        ("align_prefix", ALIGN + PREFIX)])
def test_f64_equals_the_jax_packages_x64_run(tmp_path, name, flags):
    pairs, _ = write_pairs(str(tmp_path), 2, seed=41, lo=14, hi=40)
    run_both(tmp_path, pairs, "poreover", name, flags + ["--f64"], x64=True)
    same_files(tmp_path, f"t_{name}", f"j_{name}")
