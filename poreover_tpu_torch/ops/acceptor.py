"""Banded Viterbi acceptor: the wrapper of the CUDA kernel
``csrc/acceptor.cu`` and its plain PyTorch version.

Port of ``poreover_tpu/ops/acceptor.py`` (the reference's
viterbi_acceptor_poreover, poreover/decoding/Forward.h:14-121): align a
*given* label to a probability lattice by a banded [label x time] Viterbi
over emit / stay moves; the traceback returns the per-step path, with the
gap character where nothing is emitted. The JAX package computes it as a
``lax.scan`` over label rows (``_acceptor_scan``) and a reversed scan over
time (``_traceback``), not in Pallas.

Each label row is one update over its band window of W = min(2 * band + 2,
T + 2) steps. The in-row stay chain v(l, t) = max(emit(l, t), v(l, t-1) +
y[t, gap]) is solved in closed form with a cumulative max,
v = G + cummax(emit - G), where G is the prefix sum of the gap column. The
band bookkeeping (``_band_tables``) reproduces the reference's effective
storable cells; see the JAX module's docstring.

G is an input of both versions, from one helper (``gap_prefix``: float64
prefix sums rounded once, the port's rule for every prefix sum). The JAX
package takes ``jnp.cumsum`` in the working dtype, whose summation order is
XLA's own; ``viterbi_acceptor(..., G=...)`` takes a given G so that a test
can hand both packages the same one.

For tensors on a CUDA device the wrapper launches the kernel (one CTA per
read, both reads of a pair in one launch, the traceback on the device),
and raises if it does not build or launch; there is no fallback. For
tensors on the CPU ``acceptor_plain`` runs: the same inputs, the same
outputs, the same float32 operations in the same order (adds, subtractions
and maxima only, so the results are bit-equal). ``launch_count`` counts
kernel launches.

Packed inputs (``pack_acceptor``): emission planes ``y`` [S, sum T] (one
plane per column, reads back to back along time; the gap column is the
last plane), ``G`` [sum T], per label row ``rows`` int32 [sum L, 4] = (the
window's first step off, the first and last writable step, the label's
character), ``meta`` int64 [B, 8] = (first step, T, first row, L, W, first
pointer byte, band, first pointer-bits byte). Outputs: the path int8 [sum
T] and the pointers, in the plain version a byte band ``ptr`` int8 [sum L
* W] (row l-1's window of read b at ``meta[b, 5] + (l-1) * W``: 1 where
the cell emits), in the kernel the same pointers as bits, uint8 [sum L *
row_bytes(W)] (row l-1 at ``meta[b, 7] + (l-1) * row_bytes(W)``, window
cell w at bit w % 8 of byte w // 8), which ``unpack_pointers`` turns into
the byte band.

The gap column must be finite (a softmax output is): with a -inf gap
log-prob, G is -inf and emit - G is NaN, which the reference's
``cummax`` and the kernel's ``fmaxf`` treat differently.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..build import build_kernel
from ..device import resolve_device

launch_count = 0

WMAX = 2048  # the kernel's widest window
META_COLS = 8

PHASE_CLOCKS = "POREOVER_PHASE_CLOCKS"  # macro of the instrumented build
# the instrumented build's phase sums (csrc/acceptor.cu: CK_*), in order:
# per part its name, its phases and the unit its count slot counts; the
# count slots follow the phases, in the parts' order, then a sink slot
CLOCK_PARTS = (("rows", ("load", "emit", "scan", "bar1", "store", "bar2",
                         "ptr"), "row"),
               ("walk", ("stage", "walk"), "row"))
CLOCK_SLOTS = sum(len(p) + 1 for _, p, _ in CLOCK_PARTS) + 1

_libs = {}


def load_kernel(phase_clocks: bool = False):
    """Build (once) and load the kernel library; returns the ctypes lib.
    With ``phase_clocks`` the instrumented build (a library of its own,
    with ``phase_clocks_read``)."""
    if phase_clocks in _libs:
        return _libs[phase_clocks]
    lib = ctypes.CDLL(str(build_kernel(
        "acceptor", (PHASE_CLOCKS,) if phase_clocks else ())))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.acceptor_launch.restype = i
    lib.acceptor_launch.argtypes = [vp, ll, i, vp, vp, vp, i, i, vp, vp, vp]
    if phase_clocks:
        lib.phase_clocks_read.restype = i
        lib.phase_clocks_read.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong), i, i]
    _libs[phase_clocks] = lib
    return lib


def _band_tables(T: int, L: int, band: int):
    """Host-side band bookkeeping for rows 1..L (copy of the JAX module's
    ``_band_tables``): (rs, re, stored_lo, stored_hi), each [L+1], indexed
    by l; inclusive stored bounds, exclusive write end."""
    l = np.arange(L + 1, dtype=np.int64)
    center = (l * T) // L if L > 0 else l * 0
    rs = np.maximum(1, center - band)
    re = np.minimum(T, center + band)
    stored_lo = np.empty(L + 1, dtype=np.int64)
    stored_hi = np.empty(L + 1, dtype=np.int64)
    # rows 0 and 1 were pushed with [0, band] inclusive before the loop
    stored_lo[0:2] = 0
    stored_hi[0:2] = band
    if L >= 2:
        stored_lo[2:] = rs[1:L]
        stored_hi[2:] = re[1:L]  # SparseRow end is inclusive
    return rs, re, stored_lo, stored_hi


def window(T: int, band: int) -> int:
    """The band window's width W of a read of T steps."""
    return int(min(2 * band + 2, T + 2))


def row_table(T: int, label_int: np.ndarray, band: int) -> np.ndarray:
    """int32 [L, 4] per label row l = 1..L: the window's first step off =
    rs[l], the first and last writable step (the JAX scan's ``writable``
    mask as an interval: t < re[l], t >= l - 1, stored_lo[l] <= t <=
    stored_hi[l], inside the window) and the row's character."""
    L = len(label_int)
    rs, re, slo, shi = _band_tables(T, L, band)
    l = np.arange(1, L + 1)
    off = rs[l]
    lo = np.maximum(np.maximum(off, l - 1), slo[l])
    hi = np.minimum(np.minimum(re[l] - 1, shi[l]), off + window(T, band) - 1)
    return np.stack([off, lo, hi, label_int], 1).astype(np.int32)


def gap_prefix(y: np.ndarray) -> np.ndarray:
    """G: the prefix sums of the gap (last) column, accumulated in float64
    and rounded once to y's dtype."""
    return np.cumsum(np.asarray(y)[:, -1].astype(np.float64)).astype(y.dtype)


def row_bytes(W: int) -> int:
    """Bytes of one label row's pointer bits in the kernel's output: W
    bits, in whole 16-byte chunks (csrc/acceptor.cu: row_bytes)."""
    return 16 * ((W + 127) // 128)


def label_ints(label: str, alphabet: str = "ACGT") -> np.ndarray:
    lut = {c: i for i, c in enumerate(alphabet)}
    return np.array([lut[c] for c in label], dtype=np.int32)


def pack_acceptor(ys, labels, band_size: int = 1000, alphabet: str = "ACGT",
                  Gs=None, dtype=np.float32):
    """Pack reads ([T_i, S] log-probs, cast to ``dtype``) and their labels
    (strings over ``alphabet``) into the flat arrays the kernel and its
    plain version read: dict(y, G, rows, meta), numpy. ``Gs``: each read's
    G (default ``gap_prefix``)."""
    ys = [np.asarray(y, dtype=dtype) for y in ys]
    S = int(ys[0].shape[1])
    for y in ys:
        if y.ndim != 2 or y.shape[1] != S or y.shape[0] < 1:
            raise ValueError(f"read of shape {y.shape}: expected [T >= 1, "
                             f"{S}]")
    if Gs is None:
        Gs = [gap_prefix(y) for y in ys]
    rows, meta = [], []
    toff = loff = pofs = bofs = 0
    for y, label in zip(ys, labels):
        T = len(y)
        li = label_ints(label, alphabet)
        W = window(T, band_size)
        rows.append(row_table(T, li, band_size))
        meta.append([toff, T, loff, len(li), W, pofs, band_size, bofs])
        toff += T
        loff += len(li)
        pofs += len(li) * W
        bofs += len(li) * row_bytes(W)
    return dict(
        y=np.ascontiguousarray(np.concatenate(ys).T),
        G=np.concatenate([np.asarray(g, dtype=dtype) for g in Gs]),
        rows=np.concatenate(rows) if loff else np.zeros((0, 4), np.int32),
        meta=np.array(meta, np.int64).reshape(-1, META_COLS))


def _check(name, t, dtype, dim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: {t.dim()} dims, expected {dim}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_inputs(y, G, rows, meta, meta_h, gap_char: int):
    """Shape, type and layout checks shared by the kernel's wrapper and the
    plain version; returns (total steps, total pointer bytes, total
    pointer-bits bytes)."""
    dev = y.device
    _check("y", y, None, 2, dev)
    if y.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"y: dtype {y.dtype}, expected a float dtype")
    _check("G", G, y.dtype, 1, dev)
    _check("rows", rows, torch.int32, 2, dev)
    _check("meta", meta, torch.int64, 2, dev)
    meta_h = np.asarray(meta_h)
    if meta.shape[1] != META_COLS or meta_h.shape != tuple(meta.shape):
        raise ValueError(f"meta {tuple(meta.shape)} / host copy "
                         f"{meta_h.shape}: bad shape")
    n = int(meta_h[:, 1].sum())
    n_ptr = int((meta_h[:, 3] * meta_h[:, 4]).sum())
    bits = meta_h[:, 3] * row_bytes(meta_h[:, 4])
    starts = [np.concatenate([[0], np.cumsum(v)[:-1]]) for v in (
        meta_h[:, 1], meta_h[:, 3], meta_h[:, 3] * meta_h[:, 4], bits)]
    if len(meta_h) and (meta_h[:, 1].min() < 1 or any(
            not np.array_equal(meta_h[:, col], s)
            for col, s in zip((0, 2, 5, 7), starts))):
        raise ValueError("meta: reads must be non-empty and back to back")
    if len(meta_h) and meta_h[:, 4].min() < 1:
        raise ValueError("meta: a window of no steps")
    if y.shape[1] != n or G.shape[0] != n or rows.shape != (
            int(meta_h[:, 3].sum()), 4):
        raise ValueError(f"y {tuple(y.shape)}, G {tuple(G.shape)}, rows "
                         f"{tuple(rows.shape)} do not match meta")
    if not 0 <= gap_char < 128:
        raise ValueError(f"gap_char {gap_char} does not fit an int8")
    return n, n_ptr, int(bits.sum())


def acceptor_cuda(y, G, rows, meta, meta_h, gap_char: int):
    """Launch the kernel on the current stream: ``y`` float32 [S, n], ``G``
    float32 [n], ``rows`` int32 [sum L, 4], ``meta`` int64 [B, 8] (and its
    host copy ``meta_h``), all on one CUDA device. Returns (the pointer
    bits uint8 [sum L * row_bytes(W)], path int8 [n]) without
    synchronising."""
    global launch_count
    n, _, n_bits = _check_inputs(y, G, rows, meta, meta_h, gap_char)
    if len(meta_h) and np.asarray(meta_h)[:, 4].max() > WMAX:
        raise ValueError(f"the kernel takes windows of <= {WMAX} steps "
                         f"(band <= {(WMAX - 2) // 2}); got W "
                         f"{np.asarray(meta_h)[:, 4].max()}")
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"acceptor_cuda: tensors on {dev}, expected cuda")
    if y.dtype != torch.float32:
        raise TypeError(f"acceptor_cuda: float32 tables only, got {y.dtype}")
    lib = load_kernel()
    ptr = torch.empty(max(n_bits, 1), dtype=torch.uint8, device=dev)
    path = torch.empty(max(n, 1), dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.acceptor_launch(y.data_ptr(), y.shape[1], y.shape[0],
                                  G.data_ptr(), rows.data_ptr(),
                                  meta.data_ptr(), meta.shape[0], gap_char,
                                  ptr.data_ptr(), path.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"acceptor kernel launch failed: CUDA error {err}")
    launch_count += 1
    return ptr[:n_bits], path[:n]


def unpack_pointers(bits, meta_h) -> torch.Tensor:
    """The kernel's pointer bits as the plain version's byte band, int8
    [sum L * W], on the bits' device."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    out = []
    for _, _, _, L, W, _, _, b0 in np.asarray(meta_h).tolist():
        rb = row_bytes(W)
        rows = bits[b0:b0 + L * rb].view(L, rb)
        cells = (rows[:, :, None] >> shifts) & 1  # [L, rb, 8]: cell 8i + k
        out.append(cells.reshape(L, 8 * rb)[:, :W].reshape(-1))
    return (torch.cat(out) if out else bits[:0]).to(torch.int8)


def acceptor_plain(y, G, rows, meta, meta_h, gap_char: int):
    """The kernel's plain PyTorch version, on the inputs' device and in
    their dtype: ``_acceptor_scan`` row for row (the window update, the
    closed-form stay chain with the seed cell, the writable mask, the
    l == 1, t == 0 cell), then the traceback row by row (as the kernel
    walks it: per row, the last emitting step at or before the current
    one). Returns (ptr, path): the pointers as a byte band int8 [sum L *
    W], the path int8 [n]."""
    n, n_ptr, _ = _check_inputs(y, G, rows, meta, meta_h, gap_char)
    dev, dt = y.device, y.dtype
    S = y.shape[0]
    ninf = torch.tensor(float("-inf"), dtype=dt, device=dev)
    ptr = torch.zeros(n_ptr, dtype=torch.int8, device=dev)
    rows_h = rows.cpu().numpy()
    for toff, T, loff, L, W, pofs, band, _ in np.asarray(meta_h).tolist():
        if L == 0:
            continue
        yb = torch.cat([y[:, toff:toff + T],
                        ninf.expand(S, W + 1)], 1)  # -inf past the read
        Gb = G[toff:toff + T]
        Gp = torch.cat([Gb, ninf.expand(W + 1)])
        # v of the previous row over positions -1 .. T + W, at [p + 1]
        pos = torch.arange(-1, T + W + 1, device=dev)
        v = torch.where((pos >= 0) & (pos <= band) & (pos < T),
                        Gp[pos.clamp(0, T + W)], ninf)
        for l in range(1, L + 1):
            off, lo, hi, c = rows_h[loff + l - 1].tolist()
            t = torch.arange(off, off + W, device=dev)
            wr = (t >= lo) & (t <= hi)
            yc, yg, Gw = (yb[c, off:off + W], yb[S - 1, off:off + W],
                          Gp[off:off + W])
            emit = torch.where(wr, yc + v[off:off + W], ninf)
            H = torch.where(wr, emit - Gw, ninf)
            seed = yb[c, 0] if l == 1 and off == 1 else ninf
            h0 = seed - Gb[off - 1] if l == 1 and off == 1 else ninf
            chain = torch.cummax(torch.cat([h0[None], H]), 0).values[1:]
            vrow = torch.where(wr, Gw + chain, ninf)
            stay = torch.cat([seed[None], vrow[:-1]]) + yg
            ptr[pofs + (l - 1) * W:pofs + l * W] = (
                wr & (emit >= stay)).to(torch.int8)
            v = torch.full_like(v, float("-inf"))
            v[off + 1:off + 1 + W] = vrow
            if l == 1:
                v[1] = yb[c, 0]
    path = torch.from_numpy(_walk(ptr.cpu().numpy(), rows_h,
                                  np.asarray(meta_h), n, gap_char))
    return ptr, path.to(dev)


def _walk(ptr, rows, meta, n: int, gap_char: int) -> np.ndarray:
    """The traceback of ``_traceback`` (reference Forward.h:99-115), row
    by row: from row L and step T-1, each row emits at the last step at or
    before the current one whose pointer is set (row 1 at step 0 at the
    latest), the steps in between are gaps, and the walk goes up a row to
    the step before."""
    path = np.full(n, gap_char, np.int8)
    for toff, T, loff, L, W, pofs, _, _ in meta.tolist():
        l, t = L, T - 1
        while l > 0 and t >= 0:
            off, _, _, c = rows[loff + l - 1].tolist()
            hi = min(t, off + W - 1)
            row = ptr[pofs + (l - 1) * W:pofs + (l - 1) * W + max(
                hi - off + 1, 0)]
            nz = np.flatnonzero(row)
            found = off + int(nz[-1]) if len(nz) else (0 if l == 1 else -1)
            if found < 0:
                break
            path[toff + found] = c
            l, t = l - 1, found - 1
    return path


def acceptor(y, G, rows, meta, meta_h, gap_char: int):
    """(pointers, path): from the kernel for tensors on a CUDA device (the
    pointers as its bits; ``unpack_pointers`` gives the byte band), from
    the plain version for tensors on the CPU (the byte band)."""
    run = acceptor_cuda if y.device.type == "cuda" else acceptor_plain
    return run(y, G, rows, meta, meta_h, gap_char)


def upload(packed, device):
    """The packed arrays as tensors on ``device`` (pinned and without
    blocking on a CUDA device): (y, G, rows, meta)."""
    host = [torch.from_numpy(packed[k]) for k in ("y", "G", "rows", "meta")]
    if device.type == "cuda":
        host = [h.pin_memory() for h in host]
    return [h.to(device, non_blocking=True) for h in host]


def viterbi_acceptor_batch(ys, labels, band_size: int = 1000,
                           alphabet: str = "ACGT", device=None, Gs=None,
                           dtype=np.float32) -> list[np.ndarray]:
    """Per-step paths of each ``labels[i]`` through ``ys[i]`` (ints; gap =
    len(alphabet)), all reads in one launch on ``device`` (default cuda).
    Each path equals the read's own ``viterbi_acceptor``."""
    if len(ys) == 0:
        return []
    dev = resolve_device(device)
    packed = pack_acceptor(ys, labels, band_size, alphabet, Gs, dtype)
    if dev.type == "cuda":
        load_kernel()  # a build failure raises before the upload
    _, path = acceptor(*upload(packed, dev), packed["meta"], len(alphabet))
    path = path.cpu().numpy().astype(np.int64)
    return [path[o:o + t] for o, t in packed["meta"][:, :2].tolist()]


def viterbi_acceptor(y, label: str, band_size: int = 1000,
                     alphabet: str = "ACGT", device=None, G=None,
                     dtype=np.float32) -> np.ndarray:
    """Per-timestep path of ``label`` through ``y`` (ints; gap =
    len(alphabet)): the contract of the JAX package's ``viterbi_acceptor``
    (:164), on ``device`` in ``dtype``. ``G``: the gap column's prefix sums
    to use (default ``gap_prefix``)."""
    return viterbi_acceptor_batch(
        [y], [label], band_size, alphabet, device,
        None if G is None else [G], dtype)[0]
