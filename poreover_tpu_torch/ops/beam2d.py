"""2D pair-consensus beam-search helpers (PyTorch).

Port of the helpers in ``poreover_tpu/ops/beam2d.py`` that the plan-driven
row_col engine (``beam2d_planned.py``) uses: the closed-form stay chain of
a windowed CTC sweep, the key hash-join, and window re-anchoring.

The chain's inclusive log-add-exp scan combines elements in the same
pairwise tree as ``jax.lax.associative_scan`` (``_lse_scan``), and the CUDA
kernel (``csrc/pair_beam_batch.cu``) walks that tree too, so the kernel and
this version agree bit for bit on the card.
"""
from __future__ import annotations

import torch

from ..utils.logspace import LOG_0

_NEG_INF = LOG_0


def _lse_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive logaddexp scan along the last axis, combining in the
    recursive odd/even tree of jax.lax.associative_scan."""
    n = x.shape[-1]
    if n < 2:
        return x
    odd = _lse_scan(torch.logaddexp(x[..., 0:n - 1:2], x[..., 1::2]))
    if n % 2 == 0:
        even = torch.logaddexp(odd[..., :-1], x[..., 2::2])
    else:
        even = torch.logaddexp(odd, x[..., 2::2])
    out = torch.empty_like(x)
    out[..., 0:1] = x[..., 0:1]
    out[..., 2::2] = even
    out[..., 1::2] = odd
    return out


def _cumsum_f32(w: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last axis, accumulated in float64 and
    rounded once to float32 (so the order of the additions does not show
    in the result, on the CPU, in torch on the card, or in the kernel)."""
    return torch.cumsum(w.to(torch.float64), dim=-1).to(w.dtype)


def _cumlse_chain(E, weights, seed):
    """p(w) = lse(E(w), p(w-1) + weights(w)), p(-1) = seed, vectorized.

    E [..., Wb], weights [..., Wb] (log multipliers of the stay chain),
    seed [...]. Returns p [..., Wb]. Closed form:
      p(w) = cw(w) + cumlse( concat(seed, E(w') - cw(w')) )
    with cw = inclusive cumsum of weights.
    """
    cw = _cumsum_f32(weights)
    body = torch.cat([seed[..., None], E - cw], dim=-1)
    return _lse_scan(body)[..., 1:] + cw


def _lookup_idx(qk1, qk2, tk1, tk2, tvalid):
    """First matching row index for each query key; -1 when absent.
    [..., Q] queries against [..., T] table rows."""
    eq = (qk1[..., :, None] == tk1[..., None, :]) & (
        qk2[..., :, None] == tk2[..., None, :])
    eq = eq & tvalid[..., None, :]
    T = tk1.shape[-1]
    rows = torch.arange(T, device=tk1.device)
    idx = torch.where(eq, rows, T).min(dim=-1).values
    return torch.where(idx < T, idx, -1)


def _shift_window(vec, prev_off, new_off, Wb: int, extra: int = 1,
                  width=None):
    """Re-window [..., Wb] stale values from [prev_off, prev_off+Wb) to
    positions new_off-extra .. new_off+Wb-1 -> [..., Wb+extra].

    Offsets are ints or tensors that broadcast against ``vec.shape[:-1]``.
    ``width`` (likewise) narrows a row's window to its first ``width``
    columns: columns at or beyond it read and stay -inf.
    """
    dev = vec.device
    d = torch.as_tensor(new_off, device=dev) - extra - torch.as_tensor(
        prev_off, device=dev)
    j = torch.arange(Wb + extra, device=dev)
    src = j + d[..., None]
    if width is None:
        ok = (src >= 0) & (src < Wb)
    else:
        lim = torch.as_tensor(width, device=dev)[..., None]
        ok = (src >= 0) & (src < lim) & (j < lim)
    shape = vec.shape[:-1] + (Wb + extra,)
    out = torch.gather(vec, -1, src.clamp(0, Wb - 1).expand(shape))
    return torch.where(ok.expand(shape), out, _NEG_INF)


def beam_search_2d(y1, y2, envelope=None, beam_width: int = 25,
                   alphabet: str = "ACGT", model: str = "ctc",
                   method: str = "row", device=None) -> str:
    """2D pair beam search for one pair (``poreover_tpu/ops/beam2d.py:
    beam_search_2d``; the reference's cpp_beam_search_2d).

    envelope: optional [U, 2] int array of per-u [row_start, row_end);
    None is the full lattice. Ported so far: ``method="row_col"`` for all
    three model kinds, which on a CUDA device runs in the pair-beam kernel
    launched with one CTA (``pair_beam_batch.pair_beam_single``, the port
    of the single-pair Pallas kernel; the JAX package runs bonito and
    flip-flop pairs through its XLA planned engine, whose semantics the
    kernel keeps) and on the CPU in the kernel's plain version. Other
    methods raise NotImplementedError."""
    import numpy as np

    if method not in ("row", "row_col", "row_col_steps", "grid"):
        raise ValueError(f"unsupported 2D beam method {method!r}")
    if method != "row_col":
        raise NotImplementedError(
            f"beam_search_2d method {method!r} is not ported to PyTorch yet "
            "(ROADMAP item A13)")
    from .beam2d_planned import _check_model
    from .pair_beam_batch import pair_beam_single

    _check_model(model, False)
    y1 = np.asarray(y1)
    y2 = np.asarray(y2)
    if envelope is None:
        envelope = np.tile(np.array([0, len(y2)], dtype=np.int64),
                           (len(y1), 1))
    return pair_beam_single(y1, y2, envelope, beam_width, alphabet, device,
                            model)
