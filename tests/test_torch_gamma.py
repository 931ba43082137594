"""The port's gamma DP (``ops/gamma.py``, the plain version of
``csrc/pair_gamma.cu``) against the JAX package's ``ops/gamma.py`` with x64
off, on the cases of tests/test_gamma.py, a U-row envelope, narrow and
stepping bands, a simulated pair, and bands on both sides of each
boundary of the kernel (``sim.gamma_band_cases``); the packing and the
kernel instance a launch takes.

Tolerance: every finite cell within ULP_TOL = 8 units in the last place of
float32 of the JAX value, and -inf exactly where JAX has -inf. Both add in
the same association (XLA's blocked cumsum, the associative_scan tree, the
alphabet in order); the cells differ only where the CPU's exp / log1p
round differently, by at most 4 ulps on these cases.
"""
import contextlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.ops import gamma as jg

from poreover_tpu_torch.ops import gamma as tg
from poreover_tpu_torch.sim import gamma_band_cases, synth_read_pair

torch.set_num_threads(1)

ULP_TOL = 8


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _rand_log_profile(rng, T, S):
    y = rng.random((T, S))
    return np.log(y / y.sum(axis=1, keepdims=True))


def assert_ulps(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    d = np.abs(got[fin].view(np.int32).astype(np.int64)
               - want[fin].view(np.int32).astype(np.int64))
    assert d.size == 0 or d.max() <= ULP_TOL, d.max()


def _sim_pair(seed, n):
    rng = np.random.default_rng(seed)
    a, b = synth_read_pair(rng, n)
    b = np.ascontiguousarray(b[::-1][:, [3, 2, 1, 0, 4]])
    U, V = len(a), len(b)
    c = np.arange(U) * V // U
    env = np.stack([np.clip(c - 9, 0, V), np.clip(c + 10, 0, V)], 1)
    return a, b, env


def _cases():
    rng = np.random.default_rng(0)
    out = [("dense 6x5 AB", _rand_log_profile(rng, 6, 3),
            _rand_log_profile(rng, 5, 3), None),
           ("dense 4x4 AB", _rand_log_profile(rng, 4, 3),
            _rand_log_profile(rng, 4, 3), None),
           ("dense 7x6", _rand_log_profile(rng, 7, 5),
            _rand_log_profile(rng, 6, 5), None)]
    y1, y2 = _rand_log_profile(rng, 10, 3), _rand_log_profile(rng, 10, 3)
    out.append(("wide band", y1, y2, np.array([[0, 10]] * 11)))
    y1, y2 = _rand_log_profile(rng, 5, 3), _rand_log_profile(rng, 5, 3)
    out.append(("U-row envelope", y1, y2, np.tile([0, 5], (5, 1))))
    y1, y2 = _rand_log_profile(rng, 9, 5), _rand_log_profile(rng, 8, 5)
    out.append(("stepping band", y1, y2,
                np.array([[0, 3], [0, 4], [1, 4], [2, 6], [2, 6], [4, 7],
                          [5, 8], [6, 8], [7, 8]])))
    out.append(("band starting below 0 and zero-width rows", y1, y2,
                np.array([[-2, 3], [0, 0], [1, 4], [4, 4], [2, 6], [3, 8],
                          [5, 8], [8, 8], [8, 8]])))
    out.append(("simulated pair", *_sim_pair(3, 40)))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_band_and_gamma00_match_jax(case):
    _, y1, y2, env = case
    if env is None:
        with jax_f32():
            want = np.asarray(jg.pair_gamma_log(y1, y2))
        got = tg.pair_gamma_log(y1, y2, device="cpu")
        assert_ulps(got, want)
        return
    with jax_f32():
        band, offs, g00 = jg.pair_gamma_log_envelope(y1, y2, env)
    got, goffs, gg00 = tg.pair_gamma_log_envelope(y1, y2, env, device="cpu")
    assert_ulps(got, np.asarray(band))
    np.testing.assert_array_equal(goffs, offs)
    assert_ulps(np.float32(gg00), np.float32(g00))


def _jax_g(y1, y2, env, band, offsets):
    """G[u, w] as the JAX package's host loop (pair_prefix.py:103-115)
    builds it from its band."""
    U = len(y1)
    band = np.asarray(band)
    Wb = int(np.max(env[:, 1] - env[:, 0]))
    want = np.full((U, Wb), -np.inf)
    for u in range(U):
        s, e = env[u]
        take = np.arange(s + 1 - offsets[u + 1], s + 1 - offsets[u + 1]
                         + e - s)
        valid = (take >= 0) & (take < band.shape[1])
        want[u, :e - s] = np.where(
            valid, band[u + 1][np.clip(take, 0, band.shape[1] - 1)], -np.inf)
    return want


@pytest.mark.parametrize("case", CASES[3:], ids=[c[0] for c in CASES[3:]])
def test_g_matches_the_jax_construction(case):
    """G[u, w] = gamma(u+1, env[u,0]+w+1), built on the device, against
    the JAX package's host loop (pair_prefix.py:103-115) over its band."""
    _, y1, y2, env = case
    env = np.asarray(env)[:len(y1)]
    with jax_f32():
        band, offsets, _ = jg.pair_gamma_log_envelope(y1, y2, env)
    want = _jax_g(y1, y2, env, band, offsets)
    prep = tg.prepare_gamma([(y1, y2, env)], device="cpu")
    _, G, _ = tg.gamma_plain(prep)
    assert_ulps(tg.unpack_g(prep, G, 0).numpy(), want)


# band widths on both sides of each boundary of the kernel: a warp's 32 E
# cells at E = 1, 2 and 4 cells a lane (31-33, 63-65, 127-129), and the
# CTA-wide instance past MAX_WARP_W (129; 511-513 and 1023-1025 across its
# 256 threads)
BAND_WIDTHS = (31, 32, 33, 63, 64, 65, 127, 128, 129, 511, 512, 513, 1023,
               1024, 1025)


@pytest.mark.parametrize("W", BAND_WIDTHS)
def test_band_widths_match_jax(W):
    """``gamma_band_cases``: rows narrower than W, a band starting below
    0 with zero-width rows, a boundary cell, 17 rows; the band, gamma(0,0)
    and G against the JAX package's, all three in one lockstep batch."""
    wls = gamma_band_cases(W)
    prep = tg.prepare_gamma(wls, device="cpu")
    assert prep["W_max"] == W
    band, G, g00 = tg.gamma_plain(prep)
    for b, (y1, y2, env) in enumerate(wls):
        assert (env[:, 0] < 0).any() == (b == 1)
        with jax_f32():
            jband, offs, jg00 = jg.pair_gamma_log_envelope(y1, y2, env)
        assert_ulps(tg.unpack_band(prep, band, b).numpy(), np.asarray(jband))
        assert_ulps(g00[b].numpy(), np.float32(jg00))
        assert_ulps(tg.unpack_g(prep, G, b).numpy(),
                    _jax_g(y1, y2, env, jband, offs))


def test_nan_frames_pass_on_as_in_jax():
    """NaN frames (``gamma_band_cases(nan_frames=True)``) give NaN in the
    same cells of the band, G and gamma(0,0) as the JAX package's, the
    other cells as before (the kernel's instances pass NaN on the same
    way: tests/test_torch_kernel.py)."""
    wls = gamma_band_cases(40, nan_frames=True)
    prep = tg.prepare_gamma(wls, device="cpu")
    band, G, g00 = tg.gamma_plain(prep)
    y1, y2, env = wls[0]
    with jax_f32():
        jband, offs, jg00 = jg.pair_gamma_log_envelope(y1, y2, env)
    got = tg.unpack_band(prep, band, 0).numpy()
    assert np.isnan(got).any() and not np.isnan(got).all()
    assert_ulps(got, np.asarray(jband))
    assert_ulps(g00[0].numpy(), np.float32(jg00))
    assert_ulps(tg.unpack_g(prep, G, 0).numpy(),
                _jax_g(y1, y2, env, jband, offs))


def test_band_cases_reach_their_cells():
    """The band cases hold rows of every kind the kernel branches on: a
    row W - 1 cells wide, rows of zero width, rows ending at read 2's end
    (the boundary cell), rows of fewer cells than a warp's lanes."""
    for W in (33, 513):
        a, b, c = gamma_band_cases(W)
        for y1, y2, env in (a, b, c):
            wid = env[:, 1] - env[:, 0]
            assert wid.max() == W - 1 and (wid < 32).mean() > 0.5
            assert (env[:, 1] == len(y2)).sum() == 3
        assert (b[2][:, 1] - b[2][:, 0] == 0).any() and len(c[0]) == 17


def test_packed_reads_have_zero_frames_past_the_end():
    """The packed frames keep their shape, and their storage holds at
    least 16 zero bytes past the last frame: the kernel's bulk copies read
    whole 16-byte words."""
    _, y1, y2, env = CASES[-1]
    prep = tg.prepare_gamma([(y1, y2, env)], device="cpu")
    y = prep["y"]
    assert y.shape == (len(y1) + len(y2), y1.shape[1]) and y.is_contiguous()
    flat = torch.tensor([], dtype=y.dtype).set_(y.untyped_storage())
    tail = flat[y.numel():]
    assert tail.numel() * tail.element_size() >= 16
    assert not tail.any()


def test_instance_choice(monkeypatch):
    """A warp's registers hold bands of up to MAX_WARP_W cells; wider
    launches take the CTA-wide instance, and forcing the warp instance
    on them raises before any launch."""
    assert tg.instance_for(1) == tg.instance_for(tg.MAX_WARP_W) == "warp"
    assert tg.instance_for(tg.MAX_WARP_W + 1) == "wide"
    prep = tg.prepare_gamma(gamma_band_cases(tg.MAX_WARP_W + 1),
                            device="cpu")
    prep["device"] = torch.device("cuda")
    monkeypatch.setattr(tg, "load_kernel", lambda *a: pytest.fail("load"))
    with pytest.raises(ValueError, match="no 'warp' instance"):
        tg.gamma_cuda(prep, instance="warp")


def test_wide_instance_storage():
    """The CTA-wide instance keeps a workload's rows in shared memory while
    they fit the card's (227 KB on an H100: bands of up to 11468 cells),
    else in global scratch; the rows' size and the limit are the kernel
    library's."""
    card = SimpleNamespace(smem_optin=232448,
                           pair_gamma_wide_floats=lambda W: 5 * W + W // 15
                           + 8)
    assert tg.wide_storage(129, card) == "shared"
    assert tg.wide_storage(6664, card) == "shared"
    assert tg.wide_storage(11468, card) == "shared"
    assert tg.wide_storage(11469, card) == "global"
    assert tg.wide_storage(12000, card) == "global"


def test_batch_equals_one_at_a_time():
    """Workloads of other lengths and widths in one lockstep batch give the
    bits each gives alone."""
    ws = [(y1, y2, env if env is not None else
           np.tile([0, len(y2)], (len(y1) + 1, 1)))
          for _, y1, y2, env in CASES if y1.shape[1] == 5]
    assert len(ws) >= 4
    prep = tg.prepare_gamma(ws, device="cpu")
    band, G, g00 = tg.gamma_plain(prep)
    for b, w in enumerate(ws):
        one = tg.prepare_gamma([w], device="cpu")
        b1, G1, g1 = tg.gamma_plain(one)
        assert torch.equal(tg.unpack_band(prep, band, b),
                           tg.unpack_band(one, b1, 0))
        assert torch.equal(tg.unpack_g(prep, G, b), tg.unpack_g(one, G1, 0))
        assert torch.equal(g00[b:b + 1], g1)


def test_truncated_rows_equal_the_full_run():
    """``n_rows`` computes each workload's last rows as the full run does
    (the card's check at full size compares these)."""
    y1, y2, env = _sim_pair(5, 30)
    prep = tg.prepare_gamma([(y1, y2, env)], device="cpu")
    full, _, _ = tg.gamma_plain(prep)
    part, _, _ = tg.gamma_plain(prep, n_rows=20)
    U = len(y1)
    a = tg.unpack_band(prep, full, 0)
    b = tg.unpack_band(prep, part, 0)
    assert torch.equal(a[U - 20:], b[U - 20:])
    assert torch.isinf(b[:U - 20]).all()


def test_gamma_batch_on_the_cpu_is_the_plain_version():
    """``gamma_batch`` gives the search's inputs, G and gamma(0,0), from
    the plain version for CPU tensors, without a launch."""
    ws = [(y1, y2, env) for _, y1, y2, env in CASES[3:]
          if y1.shape[1] == 5]
    prep = tg.prepare_gamma(ws, device="cpu")
    before = tg.launch_count
    got = tg.gamma_batch(prep)
    assert tg.launch_count == before
    want = tg.gamma_plain(prep)[1:]
    assert len(got) == 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_band_api_refuses_the_card(monkeypatch):
    """The band is the plain version's output (the kernel keeps a row of
    it at a time): the JAX package's band API raises on the card rather
    than run the plain version there."""
    monkeypatch.setattr(tg, "resolve_device", lambda d: torch.device("cuda"))
    _, y1, y2, env = CASES[3]
    with pytest.raises(ValueError, match="device='cpu'"):
        tg.pair_gamma_log_envelope(y1, y2, env)
    with pytest.raises(ValueError, match="device='cpu'"):
        tg.pair_gamma_log(y1, y2)


def test_front_rows_is_a_whole_workload_at_full_width():
    """``chip_smoke.front_rows``, the card's check of the gamma kernel's
    gamma(0,0) at full width: a copy cut to its first rows is a workload
    the search takes, of the full pair's band width, with a finite
    gamma(0,0), and its rows are the full pair's."""
    import chip_smoke
    from poreover_tpu_torch.ops.pair_prefix import workload_error

    y1, y2, env = _sim_pair(6, 60)
    env = env[:len(y1)]
    n = len(y1) // 3
    f1, f2, fenv = chip_smoke.front_rows((y1, y2, env), n)
    assert workload_error(f1, f2, fenv) is None
    assert len(f1) == n and np.array_equal(fenv, env[:n])
    assert len(f2) == fenv[:, 1].max() < len(y2)
    full = tg.prepare_gamma([(y1, y2, env)], device="cpu")
    cut = tg.prepare_gamma([(f1, f2, fenv)], device="cpu")
    assert cut["W_max"] == full["W_max"]
    _, G, g00 = tg.gamma_plain(cut)
    assert np.isfinite(float(g00[0]))
    assert tg.unpack_g(cut, G, 0).shape == (n, full["W_max"] - 1)


def test_float64_matches_jax_x64():
    _, y1, y2, env = CASES[-1]
    jax.config.update("jax_enable_x64", True)
    band, _, g00 = jg.pair_gamma_log_envelope(y1, y2, env)
    got, _, gg00 = tg.pair_gamma_log_envelope(y1, y2, env, device="cpu",
                                              dtype=np.float64)
    band = np.asarray(band)
    fin = np.isfinite(band)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], band[fin], rtol=1e-12)
    assert abs(gg00 - g00) <= 1e-12 * abs(g00)
