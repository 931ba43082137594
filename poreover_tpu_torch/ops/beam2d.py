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
    return _lse_scan_(x.clone())


def _lse_scan_(x: torch.Tensor) -> torch.Tensor:
    """``_lse_scan`` in place, two launches per level of the tree.

    The recursion pairs a level's elements (0, 1), (2, 3), ... into the
    next level, scans that, and finishes each even element from the odd
    one before it. Level l's elements are x's columns 2^l - 1, 2^(l+1) - 1,
    ... (a strided view), so the pair sums land in place (up the tree),
    and the even elements are finished in place on the way down, each
    from the same two operands as in the recursion."""
    levels = [x]
    while levels[-1].shape[-1] > 1:
        v = levels[-1]
        odd = v[..., 1::2]
        torch.logaddexp(v[..., 0:2 * odd.shape[-1]:2], odd, out=odd)
        levels.append(odd)
    for v in reversed(levels[:-1]):
        even = v[..., 2::2]
        if even.shape[-1]:
            torch.logaddexp(v[..., 1:2 * even.shape[-1]:2], even, out=even)
    return x


def _cumsum_f32(w: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last axis, accumulated in float64 and
    rounded once to float32 (so the order of the additions does not show
    in the result, on the CPU, in torch on the card, or in the kernel)."""
    return torch.cumsum(w.to(torch.float64), dim=-1).to(w.dtype)


XLA_SCAN_BASE = 16


def _cumsum_xla(w: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last axis in ``w``'s own dtype, associated
    as XLA's CPU backend associates ``jnp.cumsum``.

    jax lowers ``cumsum`` to a ``reduce_window``
    (``cumred_reduce_window_impl``, ``jax/_src/lax/control_flow/loops.py``),
    and XLA's reduce-window rewrite turns that into a blocked scan of base
    16: each block of 16 elements is summed in order from 0, the blocks'
    totals are scanned the same way (recursively), and each block's
    exclusive prefix is added to its elements last; 16 elements or fewer
    are one sequential sum. A position's value does not depend on the
    length. Bit for bit ``jax.jit(jnp.cumsum)`` on the CPU, in float32 and
    (under x64) float64 (tests/test_torch_exact_sums.py). Elementwise adds
    only, in place on one copy (a launch per add of a column): torch's
    own cumsum accumulates in float64 on the CPU."""
    L, B = w.shape[-1], XLA_SCAN_BASE
    nb = -(-L // B)
    out = (torch.nn.functional.pad(w, (0, nb * B - L)) if nb * B > L
           else w.clone())
    _cumsum_in_order_(out.view(w.shape[:-1] + (nb, B)))
    if nb > 1:
        blocks = out.view(w.shape[:-1] + (nb, B))
        tot = _cumsum_xla(blocks[..., :-1, -1])
        blocks[..., 1:, :] += tot[..., None]
    return out[..., :L]


def _cumsum_in_order_(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last axis in place, one add at a time
    from 0."""
    cols = x.unbind(-1)
    for i in range(1, len(cols)):
        cols[i].add_(cols[i - 1])
    return x


def _cumlse_chain(E, weights, seed):
    """p(w) = lse(E(w), p(w-1) + weights(w)), p(-1) = seed, vectorized.

    E [..., Wb], weights [..., Wb] (log multipliers of the stay chain),
    seed [...]. Returns p [..., Wb]. Closed form:
      p(w) = cw(w) + cumlse( concat(seed, E(w') - cw(w')) )
    with cw = inclusive cumsum of weights (``_cumlse_cw``).
    """
    return _cumlse_cw(E, _cumsum_f32(weights), seed)


def _cumlse_cw(E, cw, seed):
    """``_cumlse_chain`` from the weights' inclusive prefix sums cw."""
    body = torch.cat([seed[..., None], E - cw], dim=-1)
    return _lse_scan_(body)[..., 1:] + cw


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

    _check_model(model)
    y1 = np.asarray(y1)
    y2 = np.asarray(y2)
    if envelope is None:
        envelope = np.tile(np.array([0, len(y2)], dtype=np.int64),
                           (len(y1), 1))
    return pair_beam_single(y1, y2, envelope, beam_width, alphabet, device,
                            model)
