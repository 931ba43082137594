"""``pair-decode --exact`` (the graveyard engine; ROADMAP A11): ``python -m
poreover_tpu_torch --device cpu`` (the plain version of the pair kernel's
graveyard instance) writes the same files as ``python -m poreover_tpu``
with the same flags under float32: byte-identical .1d.fasta and
.2d.fasta, a .log equal apart from its ``vars(args)`` line. Runs: two
small simulated CTC pairs batched (``--threads 2``) and one at a time,
with ``--f64``, two agreeing pairs under ``--skip_matches`` (the JAX
package decodes each box with its exact engine; the port every box through
the pair kernel's graveyard instance in waves), one bonito and one
flip-flop pair. Inputs are seeded numpy simulations; tolerance: exact."""
import pytest
import torch

from test_torch_f64 import assert_same_files, inputs, run_both

# the plain version runs many small ops: one intra-op thread is as fast
# and does not oversubscribe the CPU when test workers run in parallel
torch.set_num_threads(1)

# (name, pairs file, flags, pairs)
RUNS = [("exact", "pairs.txt", ["--exact"], 2),
        ("exact_f64", "pairs.txt", ["--exact", "--f64"], 2),
        ("anchored", "small.txt", ["--exact", "--skip_matches",
                                   "--skip_threshold", "3"], 2),
        ("bonito", "bonito", ["--exact"], 1),
        ("flipflop", "flipflop", ["--exact"], 1)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("exact")
    inputs(d)
    for name, where, flags, _ in RUNS:
        run_both(d, name, where, flags)
    return d


@pytest.mark.parametrize("name,n", [(r[0], r[3]) for r in RUNS])
def test_exact_files_equal_the_jax_packages(runs, name, n):
    assert_same_files(runs, name, n)


def test_one_pair_at_a_time_equals_the_batch(runs):
    """``--exact --threads 1`` (waves of one pair) writes the batched
    run's files."""
    from poreover_tpu_torch.cli import main as torch_main

    torch_main(["pair-decode", str(runs / "pairs.txt"), "--dir", str(runs),
                "--basecaller", "poreover", "--reverse_complement",
                "--threads", "1", "--exact", "--out",
                str(runs / "one"), "--device", "cpu"])
    for suffix in (".1d.fasta", ".2d.fasta"):
        assert (runs / f"one{suffix}").read_bytes() == (
            runs / f"t_exact{suffix}").read_bytes()
