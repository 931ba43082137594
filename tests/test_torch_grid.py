"""``beam_search_2d(method="grid")`` (the reference's per-cell beam, host
code in ``decoding/replica2d.py``) and ``pair-decode --beam_search_method
grid`` of the port against the JAX package on the CPU; ``--exact`` over
the traversal; and ``--f64 --beam_search_method row`` (the by-row plain
version in float64) against the JAX package under x64."""
import contextlib

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.cli import main as jax_main
from poreover_tpu.ops.beam2d import beam_search_2d as jax_bs

from poreover_tpu_torch.cli import main as torch_main
from poreover_tpu_torch.ops.beam2d import beam_search_2d
from poreover_tpu_torch.sim import template_pairs, write_pairs

torch.set_num_threads(1)


@contextlib.contextmanager
def jax_x64(on):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("model", ["ctc", "ctc_merge_repeats",
                                   "ctc_flipflop"])
@pytest.mark.parametrize("half_width", [6, None])
def test_grid_equals_the_jax_packages(model, half_width):
    for y1, y2, env in template_pairs(model, 51, 2, 5, 9, half_width):
        assert beam_search_2d(y1, y2, env, beam_width=5, model=model,
                              method="grid") == jax_bs(
            y1, y2, env, beam_width=5, model=model, method="grid")


def test_grid_cell_guard():
    """Over 10M lattice cells both packages raise before any search."""
    y = np.zeros((2, 5), np.float32)
    env = np.array([[0, 6_000_000], [0, 6_000_000]])
    for fn in (beam_search_2d, jax_bs):
        with pytest.raises(MemoryError, match="10M-cell guard"):
            fn(y, y, env, method="grid")


def test_row_col_steps_is_not_ported():
    y = np.zeros((3, 5), np.float32)
    with pytest.raises(NotImplementedError, match="A13b-3"):
        beam_search_2d(y, y, method="row_col_steps", device="cpu")


@pytest.fixture(scope="module")
def small_pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("grid")
    pairs, _ = write_pairs(str(d), 2, seed=53, lo=8, hi=14)
    return d, pairs


def files(d, name):
    out = [(d / f"{name}{s}").read_bytes() for s in (".1d.fasta",
                                                      ".2d.fasta")]
    log = (d / f"{name}.log").read_text().splitlines()
    return out + [log[0]] + log[2:]


@pytest.mark.parametrize("name,flags,x64", [
    ("grid", ["--beam_search_method", "grid"], False),
    ("exact_grid", ["--exact", "--beam_search_method", "grid"], False),
    ("f64_row", ["--f64", "--beam_search_method", "row"], True),
])
def test_cli_files_equal_the_jax_packages(small_pairs, name, flags, x64):
    d, pairs = small_pairs
    common = ["pair-decode", pairs, "--dir", str(d), "--basecaller",
              "poreover", "--reverse_complement", "--threads", "2"] + flags
    torch_main(common + ["--out", str(d / f"t_{name}"), "--device", "cpu"])
    with jax_x64(x64):
        jax_main(common + ["--out", str(d / f"j_{name}")])
    got = files(d, f"t_{name}")
    assert got == files(d, f"j_{name}")
    assert got[1].count(b">") == 2
    if name == "exact_grid":
        torch_main(["pair-decode", pairs, "--dir", str(d), "--basecaller",
                    "poreover", "--reverse_complement", "--threads", "2",
                    "--exact", "--out", str(d / "t_exact"), "--device",
                    "cpu"])
        assert got == files(d, "t_exact")
