"""The properties the pair kernels' search step rests on
(csrc/pair_search.cuh), checked on the CPU against the plain version's
arithmetic (ops/beam2d.py).

A window of at most NARROW_MAX columns is scanned in registers: seed and
columns in a segment of a power-of-two number of lanes, the odd/even tree
of jax.lax.associative_scan level by level with shuffles. That equals the
plain version's 129-wide chunk scan at the live positions only because the
tree is prefix-consistent (a): a position's value depends only on the
positions before it. (b) models the kernel's two schedules, the register
one and the shared-buffer one of the general path, element for element
and holds them bit-equal to ``_lse_scan``; the float64 prefix of the gap
weights likewise. (c) the cases ``chip_smoke.py`` runs on the card take
both paths. The kernels themselves run only on a card: the ``cuda``-marked
tests in tests/test_torch_kernel.py.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from poreover_tpu_torch.ops import beam2d_planned as tp
from poreover_tpu_torch.ops import pair_beam_batch as pbb
from poreover_tpu_torch.ops.beam2d import _cumsum_f32, _lse_scan
from test_torch_kernel import narrow_pair, wide_pair

torch.set_num_threads(1)

NEG_INF = float("-inf")


@pytest.fixture(autouse=True)
def elementwise_lse(monkeypatch):
    """On the CPU ``torch.logaddexp`` takes a vectorised path for the bulk
    of a tensor and a scalar one for its tail, and the two can differ in
    the last bit, so where an element falls would decide its bits. The
    card has one path. Here every combination takes one rounding of the
    same float64 ``log1p(exp(-|a - b|))``, whatever the shape, so the tests
    compare schedules (which pairs combine, in which order), nothing
    else. ``out=`` as torch's (``beam2d._lse_scan_`` writes in place)."""
    def lse(a, b, out=None):
        d = torch.log1p(torch.exp(-(a.double() - b.double()).abs())).float()
        r = torch.where(torch.isinf(a) & (a == b), a,
                        torch.maximum(a, b) + d)
        return r if out is None else out.copy_(r)

    monkeypatch.setattr(torch, "logaddexp", lse)


def bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def body(rng, n):
    """A scan body as the sweep makes it: seed, then E - cw, with some
    -inf (unreachable parents, a -inf seed)."""
    x = (rng.normal(size=n) * 30 - 50).astype(np.float32)
    x[rng.random(n) < 0.15] = -np.inf
    return torch.from_numpy(x)


def padded(x, L):
    return torch.cat([x, torch.full((L - len(x),), NEG_INF)])


@pytest.mark.parametrize("L", [2, 4, 8, 16, 32, 64, 129])
def test_lse_scan_is_prefix_consistent(L):
    """A live prefix of n elements padded with -inf to L gives, at the n
    live positions, the bits of the 129-wide scan, for every n <= L."""
    rng = np.random.default_rng(L)
    for n in range(1, L + 1):
        for _ in range(3):
            x = body(rng, n)
            want = _lse_scan(padded(x, 129))[:n]
            got = _lse_scan(padded(x, L))[:n]
            np.testing.assert_array_equal(bits(got), bits(want))


def register_tree(v: torch.Tensor, S: int) -> torch.Tensor:
    """pair_search.cuh:seg_tree_scan on a warp of 32 lanes, segments of S:
    each level shifts the warp up by s (a lane below s keeps its own
    value, as __shfl_up_sync does) and the selected lanes combine."""
    p = torch.arange(32) % S
    for lvl in range(S.bit_length() - 1):
        s = 1 << lvl
        u = torch.cat([v[:s], v[:-s]])
        v = torch.where((p + 1) % (2 * s) == 0, torch.logaddexp(u, v), v)
    st = S >> 2
    while st >= 1:
        u = torch.cat([v[:st], v[:-st]])
        sel = ((p + 1) % (2 * st) == st) & (p + 1 >= 3 * st)
        v = torch.where(sel, torch.logaddexp(u, v), v)
        st >>= 1
    return v


@pytest.mark.parametrize("S", [2, 4, 8, 16, 32])
def test_register_schedule_equals_lse_scan(S):
    """Each segment of the register schedule holds the bits of
    ``_lse_scan`` over that segment's live elements (the rest -inf)."""
    rng = np.random.default_rng(S)
    for _ in range(40):
        segs = []
        for _ in range(32 // S):
            n = int(rng.integers(1, S + 1))
            segs.append((n, padded(body(rng, n), S)))
        got = register_tree(torch.cat([x for _, x in segs]), S)
        for r, (n, x) in enumerate(segs):
            np.testing.assert_array_equal(
                bits(got[r * S:r * S + n]), bits(_lse_scan(x)[:n]))


def buffer_tree(buf: torch.Tensor, n: int) -> torch.Tensor:
    """pair_search.cuh:warp_tree_scan over buf[0..n): the up- and
    down-sweep of the recursive odd/even tree, pair by pair."""
    buf = buf.clone()
    nls, nl, s = [], n, 1
    while nl >= 2:
        half = nl // 2
        q = torch.arange(half) * 2 * s + 2 * s - 1
        buf[q] = torch.logaddexp(buf[q - s], buf[q])
        nls.append(nl)
        nl, s = half, s * 2
    for lvl in range(len(nls) - 1, -1, -1):
        st, nn = 1 << lvl, nls[lvl]
        i = torch.arange(1, (nn + 1) // 2)
        pe = 2 * i * st + st - 1
        buf[pe] = torch.logaddexp(buf[pe - st], buf[pe])
    return buf


@pytest.mark.parametrize("n0", range(1, 130, 16))
def test_buffer_schedule_equals_lse_scan(n0):
    """The general path's scan, cut to a chunk's live width n (n <= 129),
    gives the bits of the 129-wide ``_lse_scan`` at its n positions."""
    rng = np.random.default_rng(n0)
    for n in range(n0, min(n0 + 16, 130)):
        x = body(rng, n)
        got = buffer_tree(padded(x, 129), n)[:n]
        np.testing.assert_array_equal(
            bits(got), bits(_lse_scan(padded(x, 129))[:n]))


@pytest.mark.parametrize("S", [2, 4, 8, 16, 32])
def test_register_cw_equals_float64_cumsum(S):
    """cw of the register path (a float64 Hillis-Steele scan over the
    segment's live columns, rounded once) has the bits of the plain
    version's float64 cumsum rounded once, over the same gap weights."""
    rng = np.random.default_rng(100 + S)
    p = torch.arange(32) % S
    for _ in range(50):
        gap = torch.from_numpy(np.log(rng.uniform(0.02, 0.99, 32)).astype(
            np.float32))
        live = (p >= 1) & (p < torch.from_numpy(
            rng.integers(1, S + 1, 32 // S)).repeat_interleave(S))
        x = torch.where(live, gap.double(), 0.0)
        o = 1
        while o < S:
            x = torch.where(p >= o, x + torch.cat([x[:o], x[:-o]]), x)
            o *= 2
        got = x.float()
        for r in range(32 // S):
            seg = slice(r * S + 1, (r + 1) * S)
            n = int(live[seg].sum())
            want = _cumsum_f32(gap[seg][:n])
            np.testing.assert_array_equal(bits(got[seg][:n]), bits(want))


def test_sweep_paths_counts_windows():
    plan = np.array([[tp.MAIN, 0, 5, 0, 40], [tp.C0RUN, 0, 31, 9, 9],
                     [tp.C1RUN, 0, 0, 3, 3], [tp.MAIN, 4, 4, 2, 34]])
    # MAIN 5 and 40, C0RUN 31, the empty C1RUN window counts as neither,
    # MAIN 0 (neither) and 32
    assert pbb.sweep_paths(plan) == (2, 2)


def test_card_cases_take_both_sweep_paths():
    """chip_smoke.py's phase 2 batches (the envelope cases, the real
    boxes) exercise both of the kernel's sweep paths."""
    cases = chip_smoke.pallas_cases()
    narrow = general = 0
    for batch in ([cases[i]] for i in range(len(cases))):
        n, g = pbb.sweep_paths(tp.pack_pairs(batch)["plan"])
        narrow, general = narrow + n, general + g
    n, g = pbb.sweep_paths(tp.pack_pairs(chip_smoke.boxes())["plan"])
    assert n > 0 and g > 0
    assert general > 0 and narrow + n > 0


def test_path_pairs_take_one_path():
    """The pairs of test_torch_kernel.py's path tests: one sweeps on the
    narrow path only, the other on the general path only until its
    corner."""
    plan = tp.pack_pairs([narrow_pair()])["plan"]
    n, g = pbb.sweep_paths(plan)
    assert n > 0 and g == 0
    plan = tp.pack_pairs([wide_pair()])["plan"]
    assert pbb.sweep_paths(plan[:-pbb.NARROW_MAX])[0] == 0
    assert pbb.sweep_paths(plan)[1] > 0
