"""Exact mode's and ``--f64``'s sums (``beam2d._cumsum_xla``) against the
JAX engine's ``jnp.cumsum`` on the CPU, and the planes that carry them.

The JAX package runs exact mode and ``--f64`` through its XLA engine,
which takes the cumulative gap row of its CTC planes and its stay chains'
weights with ``jnp.cumsum`` in the engine's dtype; XLA's CPU backend
associates those sums as a blocked scan of base 16. The port's exact
mode and ``--f64`` sum the same way; its windowed float32 planes keep the
Pallas kernel's packing (a float64 sum rounded once), which the JAX
package runs on a TPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poreover_tpu.ops import pallas_pair_beam_batch as jpal
from poreover_tpu_torch.ops import beam2d_planned as tp
from poreover_tpu_torch.ops import pair_beam_batch as pbb
from poreover_tpu_torch.ops.beam2d import _cumsum_xla

LENGTHS = (1, 15, 16, 17, 255, 256, 257, 4097, 58996)
A = 4


@pytest.fixture
def x64():
    """Sets jax's x64 flag for a test and restores it afterwards."""
    old = jax.config.jax_enable_x64

    def set_(on: bool):
        jax.config.update("jax_enable_x64", on)

    yield set_
    jax.config.update("jax_enable_x64", old)


def log_gaps(n, seed):
    """Seeded log-probabilities, as a trace's gap column holds them."""
    return np.log(np.random.default_rng(seed).uniform(0.01, 1.0, n))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", LENGTHS)
def test_cumsum_xla_is_jnp_cumsum(x64, n, dtype):
    """Bit for bit ``jax.jit(jnp.cumsum)`` on the CPU: float32 with x64
    off, float64 with x64 on."""
    x64(dtype == np.float64)
    x = log_gaps(n, n).astype(dtype)
    want = np.asarray(jax.jit(jnp.cumsum)(jnp.asarray(x)))
    got = _cumsum_xla(torch.from_numpy(x)).numpy()
    assert want.dtype == got.dtype == dtype
    assert np.array_equal(want.view(np.uint8), got.view(np.uint8))
    if n > 255:  # the association shows: a plain sum in order differs
        assert not np.array_equal(np.cumsum(x), want)


@pytest.mark.parametrize("rows,n", [(25, 128), (1, 128), (7, 31), (3, 129)])
def test_cumsum_xla_along_rows_is_jnp_cumsum(x64, rows, n):
    """Along the last axis of a [rows, n] array (the JAX engine's stay
    chains: one chunk of weights per candidate row), float32."""
    x64(False)
    w = log_gaps(rows * n, rows + n).astype(np.float32).reshape(rows, n)
    w[:, n // 3:n // 2] = 0.0  # columns outside a window weigh 0
    want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=-1))(
        jnp.asarray(w)))
    got = _cumsum_xla(torch.from_numpy(w)).numpy()
    assert np.array_equal(want.view(np.uint8), got.view(np.uint8))


def trace(T, seed, dtype=np.float64):
    """A seeded [T, A+1] CTC log-prob trace whose values are float32
    values, as the port's readers give them (``np.log`` of float32
    probabilities, widened)."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(A + 1), size=T).astype(np.float32)
    return np.log(p).astype(dtype)


def plane_rows(packed, b, which=1):
    """Pair b's packed plane ``which`` as [A+2, T+1]."""
    m = packed["meta"][b]
    T, o = int(m[tp.M_T1 if which == 1 else tp.M_T2]), int(
        m[tp.M_Y1 if which == 1 else tp.M_Y2])
    flat = packed[f"planes{which}"]
    return flat[o:o + (A + 2) * (T + 1)].reshape(A + 2, T + 1)


def small_pairs(n=3):
    out = []
    for i in range(n):
        U, V = 300 + 37 * i, 280 + 41 * i
        env = np.stack([np.clip(np.arange(U) * V // U - 20, 0, V - 1),
                        np.clip(np.arange(U) * V // U + 20, 1, V)], 1)
        out.append((trace(U, 2 * i), trace(V, 2 * i + 1), env))
    return out


@pytest.mark.parametrize("exact,dtype", [(True, np.float32),
                                         (False, np.float64),
                                         (True, np.float64)])
def test_exact_and_f64_planes_carry_the_xla_row(x64, exact, dtype):
    """Exact mode's planes (float32) and ``--f64``'s (both modes) hold
    the root's cumulative gap row as the JAX engine sums it:
    ``jnp.cumsum`` of the trace's gap column in the dtype, from each
    plane's own start."""
    x64(dtype == np.float64)
    pairs = small_pairs()
    packed = tp.pack_pairs(pairs, G=tp.graveyard(exact)[0], dtype=dtype)
    for b, (y1, y2, _) in enumerate(pairs):
        for which, y in ((1, y1), (2, y2)):
            row = plane_rows(packed, b, which)[A + 1]
            want = np.asarray(jnp.cumsum(jnp.asarray(y[:, A], dtype)))
            assert row.dtype == dtype and row[0] == 0
            assert np.array_equal(row[1:].view(np.uint8),
                                  want.view(np.uint8))


def test_exact_boxes_sum_from_their_own_start(x64):
    """Anchored mode under ``--exact`` sends each box through the
    graveyard instance (``prepare_pairs(exact=True)``); the JAX package's
    pair-decode runs its exact engine once per box, so each box's row sums
    from the box's first column."""
    x64(False)
    boxes = [(np.asarray(y1), np.asarray(y2), np.asarray(env))
             for y1, y2, env in _boxes()[:6]]
    prep = pbb.prepare_pairs(boxes, device="cpu", exact=True)
    for r, i in enumerate(prep["live"]):
        y1 = boxes[i][0]
        row = plane_rows(prep, r)[A + 1]
        want = np.asarray(jnp.cumsum(jnp.asarray(y1[:, A], jnp.float32)))
        assert np.array_equal(row[1:].view(np.uint8), want.view(np.uint8))


def _boxes():
    from pathlib import Path

    d = np.load(Path(__file__).resolve().parent / "data" / "boxes.npz",
                allow_pickle=True)
    n = len([k for k in d.files if k.startswith("y1_")])
    return [(d[f"y1_{i}"], d[f"y2_{i}"], d[f"env_{i}"]) for i in range(n)]


@pytest.mark.parametrize("T", [1, 17, 1000, 5000])
def test_windowed_planes_are_the_pallas_packing(T):
    """Windowed float32 planes are byte for byte the Pallas kernel's
    packing (``pallas_pair_beam_batch._pack_plane``) on the port's traces:
    emission and gap rows, and the cumulative gap row (a float64 sum
    rounded once), over the T+1 columns the port keeps; the Pallas
    plane's fill outside the trace is -1e30 where the port's is -inf."""
    y1, y2 = trace(T, T), trace(T + 3, T + 1)
    env = np.stack([np.zeros(T, np.int64), np.full(T, T + 3)], 1)
    packed = tp.pack_pairs([(y1, y2, env)])
    for which, y in ((1, y1), (2, y2)):
        want = jpal._pack_plane(y, T + 8)[:A + 2, :len(y) + 1]
        want = np.where(want == np.float32(-1e30), -np.inf, want).astype(
            np.float32)
        got = plane_rows(packed, 0, which)
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
