"""Viterbi path search: the wrapper of the CUDA kernel ``csrc/viterbi.cu``
and its plain PyTorch version.

Port of ``poreover_tpu/ops/viterbi.py``, whose DP is a ``lax.scan`` over
time, not a Pallas kernel. For tables on a CUDA device the masked DP and
its traceback run in the port's own kernel (a CTA per read, many reads
per launch, S <= 8 states; scratch for v and the back-pointers), which
raises if it does not build or launch; there is no fallback. For tables on the CPU they run in the plain version
``_viterbi_masked_padded``: a Python loop over time on a dense [B, S] value
matrix, batched over padded reads, back-pointers kept as [T-1, B, S] uint8
and walked in numpy. Both compute in the same float32 order, so their
paths are equal. ``launch_count`` counts kernel launches.

Note on masking: the reference computes ``prev = transition.T + v[t-1]``
where ``transition`` is a 0/1 matrix, i.e. it ADDS the binary mask to the
log-probabilities (+1.0 for allowed, +0.0 for disallowed) rather than
forbidding disallowed transitions with -inf. That additive behavior is the
default, for output parity (``mask_mode="additive"``); a proper -inf mask
is ``mask_mode="hard"``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..build import build_kernel
from ..device import resolve_device
from ..utils.logspace import LOG_0

launch_count = 0

PHASE_CLOCKS = "POREOVER_PHASE_CLOCKS"  # macro of the instrumented build
# the instrumented build's phase sums (csrc/viterbi.cu: CK_*), in order:
# per part its name, its phases and the unit its count slot counts; the
# count slots follow the phases, in the parts' order, then a sink slot
CLOCK_PARTS = (("forward", ("bcast", "chain", "store", "load"), "step"),
               ("pointers", ("pointers",), "step"),
               ("traceback", ("maps", "compose", "fill"), "step"))
CLOCK_SLOTS = sum(len(p) + 1 for _, p, _ in CLOCK_PARTS) + 1

_libs = {}


def load_kernel(phase_clocks: bool = False):
    """Build (once) and load the kernel library; returns the ctypes lib.
    With ``phase_clocks`` the instrumented build (a library of its own,
    with ``phase_clocks_read``)."""
    if phase_clocks in _libs:
        return _libs[phase_clocks]
    lib = ctypes.CDLL(str(build_kernel(
        "viterbi", (PHASE_CLOCKS,) if phase_clocks else ())))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.viterbi_launch.restype = i
    lib.viterbi_launch.argtypes = [vp, vp, vp, i, i, ll, vp, vp, vp]
    lib.viterbi_max_states.restype = i
    lib.viterbi_max_states.argtypes = []
    if phase_clocks:
        lib.phase_clocks_read.restype = i
        lib.phase_clocks_read.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong), i, i]
    _libs[phase_clocks] = lib
    return lib


def viterbi_cuda(y, meta, trans):
    """Launch the kernel on the current stream: ``y`` float32 [sum T, S]
    (reads back to back), ``meta`` int64 [B, 2] (first row, T >= 1),
    ``trans`` float32 [S, S] (``_trans``), all on one CUDA device. Returns
    the paths, int32 [sum T], without synchronising."""
    global launch_count
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"viterbi_cuda: tensors on {dev}, expected cuda")
    for name, t, dt, dim in (("y", y, torch.float32, 2),
                             ("meta", meta, torch.int64, 2),
                             ("trans", trans, torch.float32, 2)):
        if t.dtype != dt or t.dim() != dim or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dt} tensor of "
                             f"{dim} dims on {dev}")
    n, S = y.shape
    lib = load_kernel()
    if not 1 <= S <= lib.viterbi_max_states() or trans.shape != (S, S):
        raise ValueError(f"kernel takes 1..{lib.viterbi_max_states()} "
                         f"states; got y [*, {S}], trans "
                         f"{tuple(trans.shape)}")
    # v as float32 [n, 8], then the back-pointers as uint8 [n, 8]
    scratch = torch.empty(max(n * 40, 1), dtype=torch.uint8, device=dev)
    path = torch.empty(max(n, 1), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.viterbi_launch(y.data_ptr(), meta.data_ptr(),
                                 trans.data_ptr(), meta.shape[0], S, n,
                                 scratch.data_ptr(), path.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"viterbi kernel launch failed: CUDA error {err}")
    launch_count += 1
    return path[:n]


def _viterbi_kernel_batch(ys, transition, mask_mode: str, dev):
    """The reads through one kernel launch; a list of [T_i] int32 paths.
    The kernel is built (or loaded) after the checks, before the upload."""
    lengths = [int(y.shape[0]) for y in ys]
    if min(lengths) < 1:
        raise ValueError("viterbi: a read of length 0")
    for y in ys:
        if y.dtype != np.float32:
            raise TypeError(f"viterbi on {dev}: float32 tables only, got "
                            f"{y.dtype}")
    load_kernel()
    offs = np.cumsum([0] + lengths[:-1])
    meta = torch.as_tensor(np.stack([offs, lengths], 1).astype(np.int64),
                           device=dev)
    y_d = torch.as_tensor(np.concatenate(ys), device=dev)
    path = viterbi_cuda(y_d, meta, _trans(transition, mask_mode,
                                          torch.float32, dev).contiguous())
    path = path.cpu().numpy()
    return [path[o:o + n] for o, n in zip(offs, lengths)]


def _trans(transition, mask_mode: str, dtype, dev):
    t = torch.as_tensor(np.asarray(transition), device=dev).to(dtype).T
    if mask_mode == "additive":
        return t  # trans[j, i]: score bonus moving i -> j
    if mask_mode == "hard":
        return torch.where(t > 0, 0.0, LOG_0).to(dtype)
    raise ValueError(f"unknown mask_mode {mask_mode!r}")


def _viterbi_masked_padded(y, lens, trans):
    """Length-masked Viterbi for a padded batch. y [B, T, S] on the
    device, lens [B] host ints, trans [S, S]. Steps at or beyond a read's
    length freeze its value vector and write identity back-pointers, so
    the traceback through the pad is a no-op and a path equals the
    unpadded run's. Returns paths [B, T] as numpy int32."""
    B, T, S = y.shape
    dev = y.device
    lens_h = np.asarray(lens)
    lens_d = torch.as_tensor(lens_h, device=dev)
    all_valid_until = int(lens_h.min())  # no read has ended before this
    ident = torch.arange(S, dtype=torch.uint8, device=dev).expand(B, S)
    ptrs = torch.empty(max(T - 1, 0), B, S, dtype=torch.uint8, device=dev)
    trans = trans[None, :, :]
    v = y[:, 0]
    for t in range(1, T):
        scores = trans + v[:, None, :]  # [B, S_to, S_from]
        best, ptr = scores.max(dim=2)  # the first maximum, as jnp.argmax
        if t < all_valid_until:
            ptrs[t - 1].copy_(ptr)
            v = y[:, t] + best
        else:
            valid_t = (t < lens_d)[:, None]
            ptrs[t - 1] = torch.where(valid_t, ptr.to(torch.uint8), ident)
            v = torch.where(valid_t, y[:, t] + best, v)
    state = v.argmax(dim=1).cpu().numpy()
    ptrs_h = ptrs.cpu().numpy()
    paths = np.empty((B, T), np.int32)
    rows = np.arange(B)
    for t in range(T - 1, 0, -1):
        paths[:, t] = state
        state = ptrs_h[t - 1, rows, state]
    paths[:, 0] = state
    return paths


def viterbi_path_masked_batch(ys, transition, mask_mode: str = "additive",
                              device=None):
    """Batched masked Viterbi over variable-length reads.

    ``ys`` is a list of [T_i, S] tables, decoded together on ``device``
    (default cuda): in one kernel launch on a CUDA device (float32 tables),
    padded to a shared length in the plain version on the CPU, in the
    tables' own dtype. A read's path does not depend on the others."""
    if len(ys) == 0:
        return []
    dev = resolve_device(device)
    ys = [np.asarray(y) for y in ys]
    if dev.type == "cuda":
        return _viterbi_kernel_batch(ys, transition, mask_mode, dev)
    lengths = [int(y.shape[0]) for y in ys]
    B, Tpad, S = len(ys), max(lengths), int(ys[0].shape[1])
    yb = np.zeros((B, Tpad, S), np.result_type(*ys))
    for i, y in enumerate(ys):
        yb[i, :lengths[i]] = y
    y_d = torch.as_tensor(yb, device=dev)
    paths = _viterbi_masked_padded(
        y_d, lengths, _trans(transition, mask_mode, y_d.dtype, dev))
    return [paths[i, :lengths[i]] for i in range(B)]


def viterbi_path_masked(y, transition, mask_mode: str = "additive",
                        device=None):
    """Best state path for a [T, S] table under a transition mask, in the
    table's own dtype (float32 on a CUDA device, where the kernel runs)."""
    return viterbi_path_masked_batch([y], transition, mask_mode, device)[0]


def argmax_path(y, device=None) -> torch.Tensor:
    """Per-step argmax path [T] (Viterbi for unconstrained CTC models); a
    tensor on ``device``."""
    return argmax_path_batch(y, device)


def argmax_path_batch(y, device=None) -> torch.Tensor:
    """[B, T, S] -> [B, T] per-step argmax paths (padded reads decode as a
    batch); a tensor on ``device``, not synchronised."""
    dev = resolve_device(device)
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(np.asarray(y))
    return torch.argmax(y.to(dev, non_blocking=True), dim=-1).to(torch.int32)
