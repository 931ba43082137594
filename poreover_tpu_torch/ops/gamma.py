"""Pair gamma DP: the wrapper of the CUDA kernel ``csrc/pair_gamma.cu``
and its plain PyTorch version.

Port of ``poreover_tpu/ops/gamma.py`` (an XLA ``lax.scan``, not a Pallas
kernel; the reference's dense gamma, prefix_search.py:35-65, and its C++
envelope DP, Gamma.h:15-157). gamma(u, v) is the log-probability that
the suffixes y1[u:] and y2[v:] emit the same label; gamma(0, 0) is the
pair consensus's normaliser, and the banded matrix feeds the pair prefix
search (``ops/pair_prefix.py``).

Recursions (prefix_search.py:54-63):
  gamma*(u,v) = lse( gamma*(u,v+1) + y2[v,gap],
                     gamma(u+1,v+1) + lse_c(y1[u,c]+y2[v,c]) )
  gamma (u,v) = lse( gamma(u+1,v) + y1[u,gap], gamma*(u,v) )
with gamma(U,v) the suffix gap mass of y2, gamma(u,V) that of y1 and
gamma(U,V) = 0. Rows run u = U-1..0; within a row the gamma* chain is
solved in closed form, gamma* = revcumlse(C + cG2) - cG2 with cG2 the
window's exclusive gap prefix sums. Storage is row-banded [U+1, W] with
per-row offsets (the envelope's rows [start, end), stored through
``end``); cells outside read -inf.

Every sum keeps the JAX package's association, so that the float32
results sit within a few ulps of its own: the reverse scan is the
odd/even tree of ``jax.lax.associative_scan`` (``beam2d._lse_scan_`` on
the flipped row), the gap prefix sums and the suffix masses S1 / S2 are
XLA's blocked cumsum (``beam2d._cumsum_xla``), the sum over the alphabet
runs in order from character 0, and a slice that would leave its padded
row is clamped as ``lax.dynamic_slice`` clamps it.

A batch of workloads (pairs or anchor boxes) is packed into flat tensors
(``prepare_gamma``). For tensors on a CUDA device ``gamma_cuda`` runs the
DP in one launch of the kernel (per workload a warp on the rows' chain
and two warps computing ahead of it what does not depend on the row
below; bands wider than MAX_WARP_W cells across a CTA) and raises if it
does not build or launch; there is no fallback (the wide instance keeps
its rows in shared memory, or, for bands too wide for it, in global
scratch: ``wide_storage``). For tensors on the CPU
``gamma_plain`` runs the same rows in lockstep over the batch, a few
tensor ops per row. Both give what the
prefix search reads, ``G[u, w] = gamma(u+1, env[u,0]+w+1)`` of the
search rows (stored w-major) and gamma(0,0), and they agree bit for bit
on the card; the band itself is an output of the plain version only
(``pair_gamma_log_envelope``, the JAX package's API, on the CPU).
``launch_count`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..build import build_kernel
from ..device import resolve_device
from ..utils.logspace import LOG_0
from .beam2d import _cumsum_xla, _lse_scan_

_NEG_INF = LOG_0

launch_count = 0

# columns of the per-workload meta rows (int64) both routes read
(M_O1, M_U, M_O2, M_V, M_EOFF, M_W, M_G, M_S2) = range(8)
META_COLS = 8

PHASE_CLOCKS = "POREOVER_PHASE_CLOCKS"  # macro of the instrumented build
# the instrumented build's slots (csrc/pair_gamma.cu: CK_*): each part's
# phases, then its count of rows; read by chip_smoke.py:clock_breakdown
CLOCK_PARTS = (("wide", ("load", "cumsum", "up", "down", "final",
                         "gwrite", "barrier"), "row"),
               ("consumer", ("wait", "load", "up", "down", "final"), "row"),
               ("producer", ("wait", "flush", "stage", "inner", "cumsum",
                             "hand"), "row"))
CLOCK_SLOTS = sum(len(p) + 1 for _, p, _ in CLOCK_PARTS) + 1
# the kernel's instances (pair_gamma_launch's ``instance``): per workload a
# consumer warp and two producer warps, for bands of up to MAX_WARP_W cells
# (the main path's are 13-83); a CTA across the band
INSTANCES = {"warp": 1, "wide": 2}
MAX_WARP_W = 128
# zero frames after the packed reads: the kernel's bulk copies read whole
# 16-byte words, up to 12 bytes past a read's last frame
_Y_TAIL_ROWS = 4

_libs = {}


def _band_width(env: np.ndarray) -> int:
    return int(np.max(env[:, 1] - env[:, 0])) + 1  # inclusive storage cell


def extend_envelope(env, U: int) -> np.ndarray:
    """[U+1, 2] rows; a U-row envelope is extended by repeating its last
    row (the C++ reads one row past a U-row envelope,
    PairPrefixSearch.cpp:91-94; the JAX package gives that read defined
    semantics)."""
    env = np.asarray(env, dtype=np.int64)
    if env.shape[0] == U:
        env = np.concatenate([env, env[-1:]], axis=0)
    assert env.shape == (U + 1, 2), env.shape
    return env


def load_kernel(phase_clocks: bool = False):
    """Build (once) and load the kernel library; returns the ctypes lib.
    With ``phase_clocks`` the instrumented build (a library of its own,
    with ``phase_clocks_read``)."""
    if phase_clocks in _libs:
        return _libs[phase_clocks]
    lib = ctypes.CDLL(str(build_kernel(
        "pair_gamma", (PHASE_CLOCKS,) if phase_clocks else ())))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.pair_gamma_launch.restype = i
    lib.pair_gamma_launch.argtypes = [vp] * 5 + [i, i, i] + [vp] * 2 + [
        i, vp, vp]
    lib.pair_gamma_wide_floats.restype = ctypes.c_longlong
    lib.pair_gamma_wide_floats.argtypes = [i]
    lib.pair_gamma_smem_optin.restype = i
    lib.pair_gamma_smem_optin.argtypes = []
    lib.smem_optin = lib.pair_gamma_smem_optin()
    if lib.smem_optin < 0:
        raise RuntimeError("pair_gamma: the card's shared memory per CTA "
                           "could not be read")
    if phase_clocks:
        lib.phase_clocks_read.restype = i
        lib.phase_clocks_read.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong), i, i]
    _libs[phase_clocks] = lib
    return lib


def prepare_gamma(workloads, device=None, dtype=np.float32):
    """Pack (y1 [U, A+1], y2 [V, A+1], env [U(+1), 2]) workloads for one
    launch: the frames of both reads of every workload back to back
    (``y``; read 1 of workload b at ``meta[b, M_O1]``, read 2 at
    ``M_O2``; the storage holds a few zero frames past the last), the
    extended envelopes' rows (``env``, int32, U+1 rows at
    ``M_EOFF``), the suffix gap masses (``S1`` beside the rows, ``S2`` at
    ``M_S2``) and the outputs' offsets. The reads are rounded to ``dtype``
    (float64 only for the plain version, ``--f64``). Returns a dict of
    tensors on ``device`` and host-side sizes."""
    dev = resolve_device(device)
    dt = np.dtype(dtype)
    ys, envs, meta = [], [], []
    o = r = g = s2 = 0
    for y1, y2, env in workloads:
        # C order: a Fortran-ordered trace would make the packed frames
        # non-contiguous
        y1 = np.ascontiguousarray(np.asarray(y1, np.float64), dtype=dt)
        y2 = np.ascontiguousarray(np.asarray(y2, np.float64), dtype=dt)
        U, V = len(y1), len(y2)
        env = extend_envelope(env, U)
        W = _band_width(env)
        meta.append((o, U, o + U, V, r, W, g, s2))
        ys += [y1, y2]
        envs.append(env)
        o += U + V
        r += U + 1
        g += U * (W - 1)
        s2 += V + 1
    A = ys[0].shape[1] - 1
    meta = np.asarray(meta, dtype=np.int64).reshape(-1, META_COLS)
    ys.append(np.zeros((_Y_TAIL_ROWS, A + 1), dt))
    y = torch.as_tensor(np.concatenate(ys), device=dev)[:o]
    env_t = torch.as_tensor(np.concatenate(envs).astype(np.int32),
                            device=dev)
    S1, S2 = _suffix_gap_masses(y, meta, A)
    # the tensors' own device (cuda:0, not cuda), which the checks compare
    return dict(device=y.device, dtype=y.dtype, A=A, meta=meta,
                meta_t=torch.as_tensor(meta, device=dev), y=y, env=env_t,
                S1=S1, S2=S2, n_g=g,
                W_max=int(meta[:, M_W].max()))


def _suffix_gap_masses(y, meta, A: int):
    """S[t] = sum of the gap column from t to the end of the read, S[T] =
    0, for both reads of every workload: XLA's cumsum of the reversed
    column (``jnp.cumsum(y[::-1, -1])[::-1]``), all reads in one padded
    batch (a position's value does not depend on the length). Returns
    (S1 packed beside the envelope rows, S2 packed at ``M_S2``)."""
    dev = y.device
    reads = [(int(m[M_O1]), int(m[M_U])) for m in meta] + [
        (int(m[M_O2]), int(m[M_V])) for m in meta]
    Tm = max(T for _, T in reads)
    t = torch.arange(Tm, device=dev)
    starts = torch.as_tensor([s for s, _ in reads], device=dev)
    lens = torch.as_tensor([T for _, T in reads], device=dev)
    # reversed columns, left-aligned: rev[i, j] = gap[start + T - 1 - j]
    src = starts[:, None] + lens[:, None] - 1 - t[None, :]
    ok = t[None, :] < lens[:, None]
    rev = torch.where(ok, y[src.clamp(0, y.shape[0] - 1), A], 0.0)
    cs = _cumsum_xla(rev)
    outs = []
    for i, (_, T) in enumerate(reads):
        outs.append(torch.cat([cs[i, :T].flip(0), cs.new_zeros(1)]))
    B = len(meta)
    return torch.cat(outs[:B]), torch.cat(outs[B:])


def _clamp_start(start, size, length):
    """``lax.dynamic_slice``'s start index: clamped so that the slice of
    ``size`` fits in ``length``."""
    return torch.minimum(torch.clamp(start, min=0), length - size)


def _lse_in_order(x):
    """The JAX package's ``logsumexp`` over the last axis with the sum
    taken in order from element 0 (max-shifted; all -inf gives -inf)."""
    m = x.max(dim=-1).values
    fin = torch.isfinite(m)
    ms = torch.where(fin, m, 0.0)
    e = torch.exp(x - ms[..., None])
    s = e[..., 0]
    for a in range(1, x.shape[-1]):
        s = s + e[..., a]
    return torch.where(fin, torch.log(s) + ms, m)


def _padded(flat, starts, lens, Lm):
    """[B, Lm, ...] rows ``flat[starts[b] + l]`` for l < lens[b], zeros
    beyond (and the mask of real rows)."""
    dev = flat.device
    t = torch.arange(Lm, device=dev)
    ok = t[None, :] < lens[:, None]
    idx = (starts[:, None] + t[None, :]).clamp(0, max(flat.shape[0] - 1, 0))
    out = flat[idx]
    zero = torch.zeros((), dtype=flat.dtype, device=dev)
    shape = ok.shape + (1,) * (flat.dim() - 1)
    return torch.where(ok.reshape(shape), out, zero), ok


def gamma_plain(prep, n_rows: int | None = None):
    """The plain version: every workload's rows u = U-1..0 in lockstep,
    one row of the batch per iteration. Returns (band, G, gamma00):
    ``band`` [B, U_max+1, W_max] (workload b's in ``band[b, :U+1, :W]``,
    ``unpack_band``), ``G`` and gamma00 [B] in the packed layout the
    kernel writes (``G`` flat, [W-1, U] w-major at ``M_G``). With
    ``n_rows`` only rows u >= U - n_rows are computed (the others read
    -inf): the card's check of the kernel's last rows at full size."""
    meta, dev, dt, A = prep["meta"], prep["device"], prep["dtype"], prep["A"]
    y, env_f, S1f, S2f = prep["y"], prep["env"].long(), prep["S1"], prep["S2"]
    B = len(meta)
    mt = prep["meta_t"]
    U, V, W = mt[:, M_U], mt[:, M_V], mt[:, M_W]
    Um, Vm, Wm = int(U.max()), int(V.max()), int(W.max())
    p = W + 2  # the JAX row pads
    y1p, _ = _padded(y, mt[:, M_O1], U, Um)
    y2p, _ = _padded(y, mt[:, M_O2], V, Vm)
    envp, _ = _padded(env_f, mt[:, M_EOFF], U + 1, Um + 1)
    S1p, _ = _padded(S1f, mt[:, M_EOFF], U + 1, Um + 1)
    S2p, _ = _padded(S2f, mt[:, M_S2], V + 1, Vm + 1)
    bi = torch.arange(B, device=dev)
    w = torch.arange(Wm, device=dev)[None, :]
    neg = torch.tensor(_NEG_INF, dtype=dt, device=dev)
    Vc, Wc, pc = V[:, None], W[:, None], p[:, None]

    # ---- boundary row U: S2 on [start, end] and v < V, 0 at V
    offU, endU = envp[bi, U, 0], envp[bi, U, 1]
    st = _clamp_start(offU + p, W, V + 1 + 2 * p)
    si = st[:, None] + w - pc
    rowU = torch.where((si >= 0) & (si <= Vc),
                       S2p.gather(1, si.clamp(0, Vm)), neg)
    vU = offU[:, None] + w
    rowU = torch.where((vU <= endU[:, None]) & (vU < Vc), rowU, neg)
    rowU = torch.where((vU == Vc) & (Vc <= endU[:, None]),
                       torch.zeros((), dtype=dt, device=dev), rowU)
    band = torch.full((B, Um + 1, Wm), _NEG_INF, dtype=dt, device=dev)
    band[bi, U] = rowU

    g_next, off_next = rowU, offU
    steps = Um if n_rows is None else min(Um, n_rows)
    ridx = (Wc - 1 - w).clamp(min=0)  # the row flipped within its width
    for k in range(steps):
        u = U - 1 - k
        act = u >= 0
        uc = u.clamp(min=0)
        off, end = envp[bi, uc, 0], envp[bi, uc, 1]
        v = off[:, None] + w
        in_range = v < end[:, None]
        # gamma(u+1, v) and gamma(u+1, v+1) from the row below
        shift = off - off_next
        lim = 3 * W + 4 - W
        gu = torch.minimum((shift + p).clamp(min=0), lim)[:, None] + w - pc
        gd = torch.minimum((shift + 1 + p).clamp(min=0), lim)[:, None] + w - pc
        g_up = torch.where((gu >= 0) & (gu < Wc),
                           g_next.gather(1, gu.clamp(0, Wm - 1)), neg)
        g_diag = torch.where((gd >= 0) & (gd < Wc),
                             g_next.gather(1, gd.clamp(0, Wm - 1)), neg)
        # y2's window (the slice of the padded read, clamped)
        sy = _clamp_start(off + p, W, V + 2 * p)[:, None] + w - pc
        ok2 = (sy >= 0) & (sy < Vc)
        y2w = y2p[bi[:, None], sy.clamp(0, max(Vm - 1, 0))]  # [B, Wm, A+1]
        y2band = torch.where(ok2[..., None], y2w[..., :A], neg)
        y1u = y1p[bi, uc]  # [B, A+1]
        inner = _lse_in_order(y1u[:, None, :A] + y2band)
        C = torch.where(in_range, g_diag + inner, neg)
        g2 = torch.where(in_range & ok2, y2w[..., A], 0.0)
        cs = _cumsum_xla(g2)
        cG2 = torch.cat([torch.zeros_like(cs[:, :1]), cs[:, :-1]], dim=1)
        rev = _lse_scan_((C + cG2).gather(1, ridx)).gather(1, ridx)
        g_ast = torch.where(in_range, rev - cG2, neg)
        g_row = torch.where(in_range,
                            torch.logaddexp(g_up + y1u[:, A, None], g_ast),
                            neg)
        g_row = torch.where((v == Vc) & (Vc <= end[:, None]),
                            S1p[bi, uc][:, None], g_row)
        g_row = torch.where(act[:, None], g_row, g_next)
        band[bi, uc] = torch.where(act[:, None], g_row, band[bi, uc])
        g_next, off_next = g_row, torch.where(act, off, off_next)

    # ---- G[u, w] = gamma(u+1, env[u,0]+w+1) for w < env[u,1]-env[u,0]
    uu = torch.arange(Um, device=dev)
    s, e = envp[:, :Um, 0], envp[:, :Um, 1]
    src_off = envp[:, 1:Um + 1, 0]
    wb = torch.arange(max(Wm - 1, 0), device=dev)
    take = (s + 1 - src_off)[..., None] + wb
    valid = (take >= 0) & (take < W[:, None, None]) & (
        wb < (e - s)[..., None]) & (uu[None, :, None] < U[:, None, None])
    rows = band[:, 1:Um + 1]
    Gp = torch.where(valid, rows.gather(2, take.clamp(0, Wm - 1)), neg)

    off0 = envp[:, 0, 0]
    ok0 = (off0 <= 0) & (0 < off0 + W)
    g00 = torch.where(ok0, band[bi, 0, (-off0).clamp(0, Wm - 1)], neg)
    return band, _flatten_g(Gp, meta, prep), g00


def _flatten_g(Gp, meta, prep):
    out = torch.full((prep["n_g"],), _NEG_INF, dtype=Gp.dtype,
                     device=Gp.device)
    for b, m in enumerate(meta):
        U, Wb, o = int(m[M_U]), int(m[M_W]) - 1, int(m[M_G])
        out[o:o + U * Wb] = Gp[b, :U, :Wb].T.reshape(-1)
    return out


def wide_storage(W_max: int, lib=None) -> str:
    """Where the CTA-wide instance keeps a launch's rows: ``shared`` when
    a workload's (``pair_gamma_wide_floats`` of the kernel library ``lib``)
    fit a CTA's shared memory on the card (``smem_optin``, read when the
    library loads), else ``global`` scratch."""
    lib = lib or load_kernel()
    return ("shared" if 4 * lib.pair_gamma_wide_floats(W_max)
            <= lib.smem_optin else "global")


def instance_for(W_max: int) -> str:
    """The kernel instance a launch whose widest band is ``W_max`` cells
    takes: a warp's registers hold bands of up to MAX_WARP_W cells."""
    return "warp" if W_max <= MAX_WARP_W else "wide"


def gamma_cuda(prep, instance: str | None = None):
    """One launch of the kernel on the current stream over the packed
    workloads (float32, on one CUDA device). Returns (G, gamma00) as
    ``gamma_plain`` does, without synchronising. The instance is
    ``instance_for`` the widest band; ``instance`` ("warp" or "wide")
    forces it, for the card's checks. The wide instance's rows go where
    ``wide_storage`` puts them."""
    global launch_count
    dev = prep["device"]
    if dev.type != "cuda":
        raise ValueError(f"gamma_cuda: tensors on {dev}, expected cuda")
    if prep["dtype"] != torch.float32:
        raise TypeError(f"gamma_cuda: float32 only, got {prep['dtype']}")
    instance = instance or instance_for(prep["W_max"])
    if instance not in INSTANCES or (instance == "warp"
                                     and prep["W_max"] > MAX_WARP_W):
        raise ValueError(f"gamma_cuda: no {instance!r} instance for bands "
                         f"of {prep['W_max']} cells")
    lib = load_kernel()
    B = len(prep["meta"])
    scratch = None
    if instance == "wide" and wide_storage(prep["W_max"], lib) == "global":
        scratch = torch.empty(B * lib.pair_gamma_wide_floats(prep["W_max"]),
                              dtype=torch.float32, device=dev)
    G = torch.empty(max(prep["n_g"], 1), dtype=torch.float32, device=dev)
    g00 = torch.empty(B, dtype=torch.float32, device=dev)
    tensors = [prep["y"], prep["env"], prep["S1"], prep["S2"],
               prep["meta_t"]]
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("gamma_cuda: inputs must be contiguous on "
                             f"{dev}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pair_gamma_launch(
            *(t.data_ptr() for t in tensors), B, prep["A"], prep["W_max"],
            G.data_ptr(), g00.data_ptr(), INSTANCES[instance],
            None if scratch is None else scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pair_gamma kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return G[:prep["n_g"]], g00


def gamma_batch(prep):
    """(G, gamma00) on the prepared workloads' device: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if prep["device"].type == "cuda":
        return gamma_cuda(prep)
    return gamma_plain(prep)[1:]


def unpack_band(prep, band, b: int):
    """Workload b's band [U+1, W] from ``gamma_plain``'s."""
    m = prep["meta"][b]
    return band[b, :int(m[M_U]) + 1, :int(m[M_W])]


def unpack_g(prep, G, b: int):
    """Workload b's G [U, W-1] (u-major) from the packed output."""
    m = prep["meta"][b]
    U, Wb, o = int(m[M_U]), int(m[M_W]) - 1, int(m[M_G])
    return G[o:o + U * Wb].view(Wb, U).T


def pair_gamma_log_envelope(y1, y2, envelope, device=None,
                            dtype=np.float32):
    """Banded gamma matrix of one pair. ``envelope``: [U+1, 2] or [U, 2]
    int rows [start, end). Returns (gamma_band [U+1, W] numpy, offsets
    [U+1], gamma00 float), as ``poreover_tpu.ops.gamma`` does. The band is
    the plain version's (the kernel keeps only a row of it at a time), so
    this runs on the CPU: on the card it raises, and the prefix search
    takes G and gamma(0,0) from ``gamma_batch``."""
    if resolve_device(device).type != "cpu":
        raise ValueError("pair_gamma_log_envelope: the band is the plain "
                         "version's output; pass device='cpu' (the kernel "
                         "writes G and gamma(0,0): gamma_batch)")
    prep = prepare_gamma([(y1, y2, envelope)], device=device, dtype=dtype)
    band, _, g00 = gamma_plain(prep)
    env = extend_envelope(envelope, len(y1))
    return (unpack_band(prep, band, 0).cpu().numpy(), env[:, 0],
            float(g00[0]))


def pair_gamma_log(y1, y2, device=None, dtype=np.float32):
    """Dense gamma matrix [U+1, V+1] (reference prefix_search.py:35-65)."""
    U, V = len(y1), len(y2)
    env = np.tile(np.array([0, V], dtype=np.int64), (U + 1, 1))
    return pair_gamma_log_envelope(y1, y2, env, device, dtype)[0]
