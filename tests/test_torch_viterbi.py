"""The port's Viterbi decoders against the JAX package's, on the CPU.

Paths are integer state sequences and must be equal; strings exact. Inputs
come from a numpy seed and go to both packages unchanged (float32 tables,
the flip-flop 0/1 transition mask).
"""
import numpy as np
import pytest
import torch

from poreover_tpu.models import transducer as jtrans
from poreover_tpu.ops import viterbi as jvit

from poreover_tpu_torch.models import transducer as ttrans
from poreover_tpu_torch.ops import viterbi as tvit

torch.set_num_threads(1)

MASK = jtrans.flipflop_transition_mask()


def dirichlet_log(T, S, seed):
    rng = np.random.default_rng(seed)
    return np.log(rng.dirichlet(np.ones(S), size=T)).astype(np.float32)


def test_transition_mask_is_the_same():
    np.testing.assert_array_equal(ttrans.flipflop_transition_mask(), MASK)


@pytest.mark.parametrize("mask_mode", ["additive", "hard"])
@pytest.mark.parametrize("T,seed", [(1, 0), (2, 1), (31, 2), (257, 3)])
def test_single_path_equals_jax(mask_mode, T, seed):
    y = dirichlet_log(T, 8, seed)
    want = np.asarray(jvit.viterbi_path_masked(y, MASK, mask_mode))
    got = tvit.viterbi_path_masked(y, MASK, mask_mode, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("mask_mode", ["additive", "hard"])
def test_batch_equals_jax_and_single(mask_mode):
    ys = [dirichlet_log(T, 8, 100 + s) for s, T in enumerate([31, 12, 45, 1])]
    want = jvit.viterbi_path_masked_batch(ys, MASK, mask_mode)
    got = tvit.viterbi_path_masked_batch(ys, MASK, mask_mode, device="cpu")
    assert len(got) == len(ys)
    for y, g, w in zip(ys, got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(
            g, tvit.viterbi_path_masked(y, MASK, mask_mode, device="cpu"))
    assert tvit.viterbi_path_masked_batch([], MASK, device="cpu") == []


def test_ties_take_the_first_maximum():
    """A table quantised to a few levels (as uint8 traces are) is full of
    exact ties; both packages must break them the same way."""
    rng = np.random.default_rng(9)
    y = np.log((rng.integers(1, 5, size=(200, 8)) / 4.0)).astype(np.float32)
    for mode in ("additive", "hard"):
        np.testing.assert_array_equal(
            tvit.viterbi_path_masked(y, MASK, mode, device="cpu"),
            np.asarray(jvit.viterbi_path_masked(y, MASK, mode)))


def test_five_state_table():
    y = dirichlet_log(60, 5, 4)
    mask = np.ones((5, 5), np.float32)
    np.testing.assert_array_equal(
        tvit.viterbi_path_masked(y, mask, device="cpu"),
        np.asarray(jvit.viterbi_path_masked(y, mask)))


def test_argmax_paths_equal_jax():
    y = np.stack([dirichlet_log(40, 5, s) for s in range(3)])
    want = np.asarray(jvit.argmax_path_batch(y))
    got = tvit.argmax_path_batch(y, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tvit.argmax_path(y[0], device="cpu").numpy(),
        np.asarray(jvit.argmax_path(y[0])))


@pytest.mark.parametrize("T,seed", [(12, 5), (90, 6), (300, 7)])
def test_flipflop_viterbi_decode_string(T, seed):
    y = dirichlet_log(T, 8, seed).astype(np.float64)
    want_s, want_p = jtrans.flipflop(y).viterbi_decode(return_path=True)
    got_s, got_p = ttrans.flipflop(y).viterbi_decode(return_path=True,
                                                     device="cpu")
    assert got_s == want_s
    np.testing.assert_array_equal(got_p, np.asarray(want_p))
    assert ttrans.flipflop(y).viterbi_decode(device="cpu") == want_s


def test_unknown_mask_mode_and_missing_card(monkeypatch):
    y = dirichlet_log(5, 8, 1)
    with pytest.raises(ValueError, match="mask_mode"):
        tvit.viterbi_path_masked(y, MASK, "soft", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvit.viterbi_path_masked(y, MASK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrans.flipflop(y).viterbi_decode()


@pytest.mark.parametrize("seed", [20, 21])
def test_pair_stage1_batch_equals_each_read(seed):
    """Stage 1 of a flip-flop pair: both reads' DPs in one batched call,
    each equal to the read's own decode and to the JAX package's."""
    ys = [dirichlet_log(T, 8, seed + k).astype(np.float64)
          for k, T in enumerate((140, 97))]
    models = [ttrans.flipflop(y) for y in ys]
    got = ttrans.viterbi_decode_batch(models, device="cpu")
    for y, m, (s, p) in zip(ys, models, got):
        want_s, want_p = jtrans.flipflop(y).viterbi_decode(return_path=True)
        assert s == want_s
        np.testing.assert_array_equal(p, np.asarray(want_p))
        s1, p1 = m.viterbi_decode(return_path=True, device="cpu")
        assert s1 == s
        np.testing.assert_array_equal(p1, p)


def test_batch_keeps_other_kinds_on_their_own_decode():
    y = dirichlet_log(50, 5, 8).astype(np.float64)
    ff = dirichlet_log(30, 8, 9).astype(np.float64)
    models = [ttrans.poreover(y), ttrans.flipflop(ff), ttrans.bonito(y)]
    got = ttrans.viterbi_decode_batch(models, device="cpu")
    for m, (s, p) in zip(models, got):
        s1, p1 = m.viterbi_decode(return_path=True, device="cpu")
        assert s == s1
        np.testing.assert_array_equal(p, p1)


def test_pair_decode_stage1_passes_the_device(tmp_path, monkeypatch):
    """pair-decode hands ``--device`` to the flip-flop DP (one batched
    call with both reads), so ``--device cpu`` never reaches for CUDA."""
    from poreover_tpu_torch.cli import build_parser
    from poreover_tpu_torch.decoding.pair import pair_decode_helper
    from poreover_tpu_torch.sim import write_pairs

    write_pairs(str(tmp_path), 1, seed=3, lo=40, hi=50, kind="flipflop")
    calls = []
    real = tvit.viterbi_path_masked_batch

    def spy(ys, transition, mask_mode="additive", device=None):
        calls.append((len(ys), device))
        return real(ys, transition, mask_mode, device=device)

    monkeypatch.setattr(tvit, "viterbi_path_masked_batch", spy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = build_parser().parse_args(
        ["pair-decode", "s0_1.csv", "s0_2.csv", "--dir", str(tmp_path),
         "--basecaller", "flappie", "--reverse_complement", "--device",
         "cpu"])
    got = []
    pair_decode_helper(args, lambda wl, *_: got.append(wl))
    assert calls == [(2, "cpu")]
    assert len(got) == 1


def test_cuda_route_takes_float32_tables_only(monkeypatch):
    """On a CUDA device the kernel computes in float32 and says so rather
    than casting a float64 table (checked before any launch)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    y = dirichlet_log(5, 8, 1).astype(np.float64)
    with pytest.raises(TypeError, match="float32"):
        tvit.viterbi_path_masked_batch([y], MASK, device="cuda")
    with pytest.raises(ValueError, match="length 0"):
        tvit.viterbi_path_masked_batch([y[:0].astype(np.float32)], MASK,
                                       device="cuda")


@pytest.mark.parametrize("mask_mode", ["additive", "hard"])
@pytest.mark.parametrize("T", [32, 33, 34, 512, 513, 514])
def test_chunk_and_segment_edges_equal_jax(mask_mode, T):
    """Lengths at the kernel's edges (32-step register chunks of the
    forward, 512-step segments of the traceback, +- 1): the plain version's
    path equals the JAX package's."""
    y = dirichlet_log(T, 8, T)
    want = np.asarray(jvit.viterbi_path_masked(y, MASK, mask_mode))
    got = tvit.viterbi_path_masked(y, MASK, mask_mode, device="cpu")
    np.testing.assert_array_equal(got, want)


def small_mask(S, seed):
    """A seeded 0/1 transition mask over S states, every state may stay."""
    rng = np.random.default_rng(seed)
    return np.maximum(rng.integers(0, 2, (S, S)),
                      np.eye(S, dtype=int)).astype(np.float32)


@pytest.mark.parametrize("mask_mode", ["additive", "hard"])
@pytest.mark.parametrize("S", range(1, 9))
def test_state_counts_and_mixed_lengths_equal_jax(mask_mode, S):
    """Every state count the kernel takes (S = 1..8; S = 8 the flip-flop
    mask), reads of very different lengths in one batch: each path equals
    the JAX package's."""
    mask = MASK if S == 8 else small_mask(S, S)
    ys = [dirichlet_log(T, S, 10 * S + k)
          for k, T in enumerate((1, 2, 33, 513, 1200))]
    want = jvit.viterbi_path_masked_batch(ys, mask, mask_mode)
    got = tvit.viterbi_path_masked_batch(ys, mask, mask_mode, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def segmented_traceback(ptr, end, K=16, lanes=32):
    """The kernel's traceback (csrc/viterbi.cu) in numpy: from step T - 1
    down, segments of lanes * K steps; lane q maps each state at its last
    step to the state before its first (steps before the read keep the
    state), the maps are composed across the lanes from the segment's end
    state, and each lane fills its K steps from the state that gave it.
    ``ptr`` [T, S]: row t >= 1 the from-state of each state at step t."""
    T, S = ptr.shape
    path = np.full(T, -1, np.int64)
    state, te = end, T - 1
    while te >= 1:
        his = [te - (lanes - 1 - q) * K for q in range(lanes)]
        maps = []
        for hi in his:
            m = []
            for e in range(S):
                s = e
                for t in range(hi, hi - K, -1):
                    s = ptr[t, s] if t >= 1 else s
                m.append(s)
            maps.append(m)
        mine = [0] * lanes
        for q in range(lanes - 1, -1, -1):
            mine[q] = state
            state = maps[q][state]
        for hi, s in zip(his, mine):
            for t in range(hi, hi - K, -1):
                if t >= 0:
                    path[t] = s
                s = ptr[t, s] if t >= 1 else s
        te -= lanes * K
    if te == 0:
        path[0] = state
    return path


@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("T", [1, 2, 16, 17, 511, 512, 513, 1025, 1100])
def test_segmented_traceback_equals_the_sequential_walk(S, T):
    """Composing per-lane maps of back-pointers is exact (integers): the
    kernel's traceback order gives the sequential walk's path."""
    rng = np.random.default_rng(T * 10 + S)
    ptr = rng.integers(0, S, (T, S))
    end = int(rng.integers(0, S))
    want = np.empty(T, np.int64)
    want[T - 1] = end
    for t in range(T - 1, 0, -1):
        want[t - 1] = ptr[t, want[t]]
    np.testing.assert_array_equal(segmented_traceback(ptr, end), want)
