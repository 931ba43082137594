"""Viterbi path search (PyTorch).

Port of ``poreover_tpu/ops/viterbi.py``, whose DP is a ``lax.scan`` over
time, not a Pallas kernel: here a Python loop over time on a dense [B, S]
value matrix (S = 5 or 8 states), batched over reads on the given device.
The back-pointers are kept as [T-1, B, S] uint8 on the device and fetched
once; the traceback runs in numpy.

Note on masking: the reference computes ``prev = transition.T + v[t-1]``
where ``transition`` is a 0/1 matrix, i.e. it ADDS the binary mask to the
log-probabilities (+1.0 for allowed, +0.0 for disallowed) rather than
forbidding disallowed transitions with -inf. That additive behavior is the
default, for output parity (``mask_mode="additive"``); a proper -inf mask
is ``mask_mode="hard"``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..utils.logspace import LOG_0


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

    ``ys`` is a list of [T_i, S] tables; they are padded to a shared
    length and decoded together on ``device`` (default cuda). Returns a
    list of [T_i] paths equal to per-read ``viterbi_path_masked``
    output."""
    if len(ys) == 0:
        return []
    dev = resolve_device(device)
    ys = [np.asarray(y) for y in ys]
    lengths = [int(y.shape[0]) for y in ys]
    B, Tpad, S = len(ys), max(lengths), int(ys[0].shape[1])
    yb = np.zeros((B, Tpad, S), np.float32)
    for i, y in enumerate(ys):
        yb[i, :lengths[i]] = y
    y_d = torch.as_tensor(yb, device=dev)
    paths = _viterbi_masked_padded(
        y_d, lengths, _trans(transition, mask_mode, y_d.dtype, dev))
    return [paths[i, :lengths[i]] for i in range(B)]


def viterbi_path_masked(y, transition, mask_mode: str = "additive",
                        device=None):
    """Best state path for a [T, S] table under a transition mask, in the
    table's own dtype."""
    dev = resolve_device(device)
    y_d = torch.as_tensor(np.asarray(y), device=dev)[None]
    return _viterbi_masked_padded(
        y_d, [y_d.shape[1]],
        _trans(transition, mask_mode, y_d.dtype, dev))[0]


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
