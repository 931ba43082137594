"""Anchored mode (``pair-decode --skip_matches``) of the PyTorch port on
the CPU against the JAX package: the host-side anchor / box decomposition
is equal object for object, and ``python -m poreover_tpu_torch pair-decode
--skip_matches --device cpu`` writes the same files as ``python -m
poreover_tpu pair-decode`` with the same flags under f32 (byte-identical
.1d.fasta and .2d.fasta, a .log equal apart from its ``vars(args)`` line),
for the pairs-file form at ``--threads 4`` and ``--threads 1`` and for the
two-read form. Inputs are seeded numpy simulations; tolerance: exact."""
import contextlib

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.cli import main as jax_main
from poreover_tpu.decoding import pair as jpair

from poreover_tpu_torch import native
from poreover_tpu_torch.cli import main as torch_main
from poreover_tpu_torch.decoding import envelope as envelope_mod
from poreover_tpu_torch.decoding import pair as tpair
from poreover_tpu_torch.io.trace import model_from_trace
from poreover_tpu_torch.sim import synth_read_pair, write_pairs

# the plain version runs many small ops: one intra-op thread is as fast
# and does not oversubscribe the CPU when test workers run in parallel
torch.set_num_threads(1)

_REVCOMP_CTC = [3, 2, 1, 0, 4]


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def make_agreeing_pairs(workdir, n_pairs=2, T=90):
    """The recipe of the JAX package's own anchored-mode test: reads whose
    basecalls agree in runs with scattered mismatches, so get_anchors finds
    match anchors and leaves boxes between them."""
    rng = np.random.default_rng(5)
    lines = []
    for i in range(n_pairs):
        seq = rng.integers(0, 4, size=T // 3)
        y = np.full((T, 5), 0.02, np.float32)
        for t in range(T):
            y[t, 4 if t % 3 == 2 else seq[t // 3]] = 0.92
        y /= y.sum(1, keepdims=True)
        y2 = y.copy()
        for t in (12, 13, 45, 46, 72):
            y2[t] = np.roll(y2[t], 1)
            y2[t] /= y2[t].sum()
        np.save(f"{workdir}/b{i}_1.npy", y)
        np.save(f"{workdir}/b{i}_2.npy", y2[::-1][:, _REVCOMP_CTC])
        lines.append(f"b{i}_1.npy b{i}_2.npy")
    with open(f"{workdir}/pairs.txt", "w") as f:
        f.write("\n".join(lines) + "\n")


def host_stages(d, r1, r2):
    """Stages 1-3 on one pair of files: what the anchor functions take."""
    m1 = model_from_trace(str(d / r1), "poreover")
    m2 = model_from_trace(str(d / r2), "poreover")
    m2.reverse_complement()
    b1, p1 = m1.viterbi_decode(return_path=True)
    b2, p2 = m2.viterbi_decode(return_path=True)
    s1, _ = tpair.get_sequence_mapping(p1, "poreover")
    s2, _ = tpair.get_sequence_mapping(p2, "poreover")
    a1, a2 = native.global_pair_banded(b1, b2)
    alignment = np.array([list(a1), list(a2)])
    env = envelope_mod.build_envelope(
        m1.log_prob, m2.log_prob,
        envelope_mod.get_alignment_columns(alignment), s1, s2, padding=5)
    return m1.log_prob, m2.log_prob, env, alignment, s1, s2


@pytest.fixture(scope="module")
def sim_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("anch")
    write_pairs(str(d), 3, seed=13, lo=110, hi=150)
    return d


@pytest.mark.parametrize("pair", range(3))
@pytest.mark.parametrize("matches", [3, 5])
def test_anchor_functions_equal_jax(sim_dir, pair, matches):
    y1, y2, env, alignment, s1, s2 = host_stages(
        sim_dir, f"s{pair}_1.npy", f"s{pair}_2.npy")
    assert tpair.get_anchors(alignment, matches, 100) == jpair.get_anchors(
        alignment, matches, 100)
    got_b, got_a = tpair.anchored_box_workloads(
        y1, y2, env, alignment, s1, s2, matches=matches)
    want_b, want_a = jpair.anchored_box_workloads(
        y1, y2, env, alignment, s1, s2, matches=matches)
    assert got_a == want_a and len(got_a) > 0
    assert len(got_b) == len(want_b) > 0
    for g, w in zip(got_b, want_b):
        assert g[0] == w[0]
        for x, z in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(x, z)


def test_get_anchors_indel_runs():
    a = np.array([list("ACGT--ACGTAC"), list("ACGTTTAC--AC")])
    assert tpair.get_anchors(a, 3, 2) == jpair.get_anchors(a, 3, 2)
    assert tpair.get_anchors(a, 3, 2)[1] == ["mat", "ins", "del"]


def test_no_anchor_gives_none(sim_dir):
    y1, y2, env, alignment, s1, s2 = host_stages(sim_dir, "s0_1.npy",
                                                 "s0_2.npy")
    assert tpair.anchored_box_workloads(
        y1, y2, env, alignment, s1, s2, matches=10 ** 6) == (None, None)


def test_extract_box_workloads_skips_empty_rows(sim_dir):
    y1, y2, env, *_ = host_stages(sim_dir, "s1_1.npy", "s1_2.npy")
    boxes = [(0, 40, 0, 0), (40, 40, 0, 0), (40, len(y1), 0, 0)]
    got = tpair.extract_box_workloads(y1, y2, env, boxes)
    want = jpair.extract_box_workloads(y1, y2, env, boxes)
    assert [g[0] for g in got] == [w[0] for w in want] == [0, 40]
    for g, w in zip(got, want):
        for x, z in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(x, z)


# (name, pairs file, --threads, --skip_threshold, run the JAX package too).
# The JAX package compiles its engine anew for every batch shape, and at
# --threads 1 for every box, so its runs are kept few and small.
RUNS = [("full_4_3", "pairs.txt", 4, 3, True),
        ("full_1_3", "pairs.txt", 1, 3, False),
        ("small_1_3", "small.txt", 1, 3, True),
        ("two_4_5", "two.txt", 4, 5, True)]
N_PAIRS = {"full_4_3": 5, "small_1_3": 2, "two_4_5": 2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages over the same pairs files. pairs.txt: three simulated
    pairs, two pairs of the agreeing recipe, and one unrelated pair (the
    identity < 0.5 skip row); small.txt: the two agreeing pairs; two.txt:
    one simulated and one agreeing pair."""
    d = tmp_path_factory.mktemp("pairs")
    make_agreeing_pairs(str(d))
    pairs, _ = write_pairs(str(d), 3, seed=13, lo=110, hi=150)
    rng = np.random.default_rng(99)
    a, _ = synth_read_pair(rng, 130)
    b, _ = synth_read_pair(rng, 130)
    np.save(d / "u_1.npy", a)
    np.save(d / "u_2.npy", b)
    with open(pairs, "a") as f:
        f.write("b0_1.npy\tb0_2.npy\nb1_1.npy\tb1_2.npy\n")
        f.write("u_1.npy\tu_2.npy\n")
    (d / "small.txt").write_text("b0_1.npy b0_2.npy\nb1_1.npy b1_2.npy\n")
    (d / "two.txt").write_text("s0_1.npy s0_2.npy\nb0_1.npy b0_2.npy\n")
    from poreover_tpu_torch.ops import box_beam, pair_beam_batch

    counts = (box_beam.box_launch_count, pair_beam_batch.launch_count)
    for name, pairs_file, thr, thresh, with_jax in RUNS:
        common = ["pair-decode", str(d / pairs_file), "--dir", str(d),
                  "--basecaller", "poreover", "--reverse_complement",
                  "--threads", str(thr), "--skip_matches",
                  "--skip_threshold", str(thresh)]
        torch_main(common + ["--out", str(d / f"t_{name}"), "--device",
                             "cpu"])
        if with_jax:
            with jax_f32():
                jax_main(common + ["--out", str(d / f"j_{name}")])
    # a CPU run launches no kernel
    assert counts == (box_beam.box_launch_count,
                      pair_beam_batch.launch_count)
    return d


@pytest.mark.parametrize("run", list(N_PAIRS))
@pytest.mark.parametrize("suffix", [".1d.fasta", ".2d.fasta"])
def test_fasta_byte_identical(runs, run, suffix):
    t = (runs / f"t_{run}{suffix}").read_bytes()
    j = (runs / f"j_{run}{suffix}").read_bytes()
    assert t == j
    n = N_PAIRS[run]
    assert t.count(b">") == (2 * n if suffix == ".1d.fasta" else n)


@pytest.mark.parametrize("run", list(N_PAIRS))
def test_log_equal_but_args_line(runs, run):
    t = (runs / f"t_{run}.log").read_text().splitlines()
    j = (runs / f"j_{run}.log").read_text().splitlines()
    assert t[0] == j[0] and t[2] == j[2]
    assert t[3:] == j[3:]
    want = ["0"] * N_PAIRS[run] + (["1"] if run == "full_4_3" else [])
    assert [r.split("\t")[-1] for r in t[3:]] == want


def test_threads_do_not_change_output(runs):
    for suffix in (".1d.fasta", ".2d.fasta"):
        assert (runs / f"t_full_1_3{suffix}").read_bytes() == (
            runs / f"t_full_4_3{suffix}").read_bytes()


def test_anchored_consensus_differs_from_a_1d_basecall(runs):
    """The boxes really were decoded: the consensus is neither read's 1D
    basecall for the simulated pairs, and close to the full-envelope
    consensus in length."""
    one_d = (runs / "t_full_4_3.1d.fasta").read_text().split(">")[1:]
    two_d = (runs / "t_full_4_3.2d.fasta").read_text().split(">")[1:]
    calls = ["".join(r.splitlines()[1:]) for r in one_d]
    cons = ["".join(r.splitlines()[1:]) for r in two_d]
    assert all(len(c) > 0 for c in cons)
    assert any(c not in calls for c in cons[:3])


@pytest.mark.parametrize("stem,thresh", [("b0", 3), ("b1", 4)])
def test_two_read_form(runs, stem, thresh):
    args = ["pair-decode", str(runs / f"{stem}_1.npy"),
            str(runs / f"{stem}_2.npy"), "--basecaller", "poreover",
            "--reverse_complement", "--skip_matches", "--skip_threshold",
            str(thresh)]
    torch_main(args + ["--out", str(runs / f"two_t{thresh}"), "--device",
                       "cpu"])
    with jax_f32():
        jax_main(args + ["--out", str(runs / f"two_j{thresh}")])
    t = (runs / f"two_t{thresh}.fasta").read_text()
    assert t == (runs / f"two_j{thresh}.fasta").read_text()
    assert t.startswith(f">consensus;{stem}_1;{stem}_2")
    assert len(t.splitlines()[1]) > 10


def test_pair_without_anchors_is_a_skipped_row(runs, tmp_path):
    """No run of matches as long as the threshold: the assertion of the
    helper becomes the skipped row of the JAX package."""
    pairs = tmp_path / "p.txt"
    pairs.write_text("s0_1.npy\ts0_2.npy\ns1_1.npy\ts1_2.npy\n")
    common = ["pair-decode", str(pairs), "--dir", str(runs), "--basecaller",
              "poreover", "--reverse_complement", "--threads", "4",
              "--skip_matches", "--skip_threshold", "100000"]
    torch_main(common + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    with jax_f32():
        jax_main(common + ["--out", str(tmp_path / "j")])
    t = (tmp_path / "t.log").read_text().splitlines()
    assert t[3:] == (tmp_path / "j.log").read_text().splitlines()[3:]
    assert t[3:] == ["s0_1.npy\ts0_2.npy\t\t\t\t1",
                     "s1_1.npy\ts1_2.npy\t\t\t\t1"]
    assert (tmp_path / "t.2d.fasta").read_bytes() == b""


def test_debug_pickle_has_the_anchor_keys(runs, tmp_path, monkeypatch):
    """``--debug`` writes debug.p into the working directory; the envelope
    stage's pickle is written last, as in the JAX package."""
    import pickle

    monkeypatch.chdir(tmp_path)
    torch_main(["pair-decode", str(runs / "s2_1.npy"),
                str(runs / "s2_2.npy"), "--basecaller", "poreover",
                "--reverse_complement", "--skip_matches",
                "--skip_threshold", "3", "--debug", "--out",
                str(tmp_path / "dbg"), "--device", "cpu"])
    with open(tmp_path / "debug.p", "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == ["alignment", "alignment_to_sequence",
                           "sequence_to_signal1", "sequence_to_signal2"]


def test_exact_anchored_still_exits(tmp_path):
    with pytest.raises(SystemExit, match="A11"):
        torch_main(["pair-decode", "x.npy", "y.npy", "--device", "cpu",
                    "--skip_matches", "--exact", "--out",
                    str(tmp_path / "o")])
