"""``pair-decode --f64`` (the pipeline in float64 on the CPU): ``python -m
poreover_tpu_torch`` writes the same files as ``python -m poreover_tpu``
with the same flags, which runs its engines in float64 on the host:
byte-identical .1d.fasta and .2d.fasta, a .log equal apart from its
``vars(args)`` line. Runs: two small simulated CTC pairs at the default
``--single viterbi`` and at ``--single beam``, two pairs whose basecalls
agree in runs under ``--skip_matches``, one bonito and one flip-flop pair.
The port's runs pass no ``--device``: ``--f64`` itself puts them on the
CPU (the default is the card). Inputs are seeded numpy simulations;
tolerance: exact."""
import contextlib

import jax
import pytest
import torch

from poreover_tpu.cli import main as jax_main

from poreover_tpu_torch.cli import main as torch_main
from poreover_tpu_torch.sim import write_pairs

from test_torch_anchored import make_agreeing_pairs

# the plain version runs many small ops: one intra-op thread is as fast
# and does not oversubscribe the CPU when test workers run in parallel
torch.set_num_threads(1)


@contextlib.contextmanager
def jax_x64(on: bool):
    """The JAX package's float type for a run: x64 for its --f64 (which
    turns x64 on itself), float32 otherwise; restored afterwards."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def inputs(d):
    """Small seeded inputs in ``d``: ``pairs.txt`` (two simulated CTC
    pairs), ``small.txt`` (two pairs of the anchored tests' agreeing
    recipe), ``bonito.txt`` and ``flipflop.txt`` (one pair each)."""
    write_pairs(str(d), 2, seed=13, lo=60, hi=80)
    make_agreeing_pairs(str(d))
    (d / "small.txt").write_text("b0_1.npy b0_2.npy\nb1_1.npy b1_2.npy\n")
    for kind, lo in (("bonito", 40), ("flipflop", 30)):
        sub = d / kind
        sub.mkdir()
        write_pairs(str(sub), 1, seed=13, lo=lo, hi=lo + 10, kind=kind)


BASECALLER = {"pairs.txt": "poreover", "small.txt": "poreover",
              "bonito": "bonito", "flipflop": "flappie"}


def run_both(d, name, where, flags, torch_flags=("--device", "cpu")):
    """One pair-decode run per package on the pairs file ``where``
    (``pairs.txt``, ``small.txt``, or a kind's directory); outputs
    ``t_{name}.*`` and ``j_{name}.*`` in ``d``."""
    pairs_dir = d / where if (d / where).is_dir() else d
    pairs = pairs_dir / ("pairs.txt" if pairs_dir != d else where)
    common = ["pair-decode", str(pairs), "--dir", str(pairs_dir),
              "--basecaller", BASECALLER[where], "--reverse_complement",
              "--threads", "2", *flags]
    torch_main(common + ["--out", str(d / f"t_{name}"), *torch_flags])
    with jax_x64("--f64" in flags):
        jax_main(common + ["--out", str(d / f"j_{name}")])


def assert_same_files(d, name, n_pairs):
    for suffix in (".1d.fasta", ".2d.fasta"):
        t = (d / f"t_{name}{suffix}").read_bytes()
        assert t == (d / f"j_{name}{suffix}").read_bytes(), suffix
        assert t.count(b">") == n_pairs * (2 if suffix == ".1d.fasta" else 1)
    t = (d / f"t_{name}.log").read_text().splitlines()
    j = (d / f"j_{name}.log").read_text().splitlines()
    assert t[0] == j[0] and t[2] == j[2]
    assert t[3:] == j[3:]
    assert [r.split("\t")[-1] for r in t[3:]] == ["0"] * n_pairs


# (name, pairs file, flags, pairs); the port's runs take no --device
RUNS = [("default", "pairs.txt", ["--f64"], 2),
        ("viterbi", "pairs.txt", ["--f64", "--single", "viterbi"], 2),
        ("beam", "pairs.txt", ["--f64", "--single", "beam"], 2),
        ("anchored", "small.txt", ["--f64", "--skip_matches",
                                   "--skip_threshold", "3"], 2),
        ("bonito", "bonito", ["--f64"], 1),
        ("flipflop", "flipflop", ["--f64"], 1)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("f64")
    inputs(d)
    from poreover_tpu_torch.ops import pair_beam_batch

    before = pair_beam_batch.launch_count + pair_beam_batch.exact_launch_count
    for name, where, flags, _ in RUNS:
        run_both(d, name, where, flags, torch_flags=())
    # --f64 ran on the CPU: no kernel launched
    assert before == (pair_beam_batch.launch_count
                      + pair_beam_batch.exact_launch_count)
    return d


@pytest.mark.parametrize("name,n", [(r[0], r[3]) for r in RUNS])
def test_f64_files_equal_the_jax_packages(runs, name, n):
    assert_same_files(runs, name, n)


def test_single_viterbi_is_the_default(runs):
    for suffix in (".1d.fasta", ".2d.fasta"):
        assert (runs / f"t_viterbi{suffix}").read_bytes() == (
            runs / f"t_default{suffix}").read_bytes()


def test_f64_says_it_runs_on_the_cpu(tmp_path, caplog):
    d = tmp_path
    write_pairs(str(d), 1, seed=3, lo=40, hi=50)
    with caplog.at_level("INFO", logger="poreover_tpu_torch"):
        torch_main(["pair-decode", str(d / "s0_1.npy"), str(d / "s0_2.npy"),
                    "--basecaller", "poreover", "--reverse_complement",
                    "--f64", "--out", str(d / "o")])
    assert "float64 on the CPU" in caplog.text
    assert (d / "o.fasta").read_text().startswith(">consensus;s0_1;s0_2")
