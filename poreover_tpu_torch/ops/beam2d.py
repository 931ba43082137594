"""2D pair-consensus beam search (PyTorch): the helpers both engines
share, the by-row engine's plain version and the library entry.

Port of ``poreover_tpu/ops/beam2d.py``. The plan-driven row_col engine
(``beam2d_planned.py``) uses the closed-form stay chain of a windowed
sweep, the key hash-join and window re-anchoring from here. The by-row
engine (``method="row"``, the reference's default traversal, the JAX
package's ``_beam2d_row_scan``) is here in full: per row u of read 1 a
dedup and top-W prune of the C = W*(A+1) candidates, read 1's one-step
update, and a sweep of every candidate across the row's window of read
2, a node swept once, after its parent (the JAX engine's layered
``while_loop``: a node swept before its parent is done is thrown away
there), each sweep a closed form (cumulative log-add-exp chains).

The chain's inclusive log-add-exp scan combines elements in the same
pairwise tree as ``jax.lax.associative_scan`` (``_lse_scan``), and the
CUDA kernels (``csrc/pair_beam_batch.cu``, ``csrc/pair_row_beam.cu``)
walk that tree too, so each kernel and its plain version agree bit for
bit on the card.

Sums of the by-row engine (``ROW_SUMS``): the JAX package runs it as an
XLA scan, so the stay chains' prefix sums and the root's cumulative gap
rows are ``_cumsum_xla`` (XLA's CPU association of ``jnp.cumsum``), in
the working dtype. With ``_cumsum_f32`` (the Pallas kernels' float64
sums rounded once) a bonito row step parts from the JAX engine's beyond
the 1e-5 that tests/test_torch_row_beam.py allows; with ``_cumsum_xla``
only the two frameworks' log-add-exps' last bits differ.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.logspace import LOG_0
from .beam import (
    _MODEL_IDS, _child_keys, _dedup_mask, _init_candidates, _lookup,
    _node_update, _top_w,
)

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


# --------------------------------------------------------------------------
# the by-row engine (``poreover_tpu/ops/beam2d.py:_beam2d_row_scan``), with
# a leading batch dimension B: a wave of workloads padded to the widest
# window and the most rows; rows past a workload's last leave its table
# untouched, so a workload decodes the same alone as in any wave
# --------------------------------------------------------------------------

# the stay chains' prefix sums and the root's cumulative gap rows (module
# docstring)
ROW_SUMS = _cumsum_xla


def _row_sums(model_id: int, c_emit, c_emit2, gap_w, in_range):
    """The prefix sums of a row's stay-chain weights, as the JAX engine's
    ``_cumlse_chain`` takes them (``jnp.cumsum`` of each chain's weights):
    (gap, char emission, flop emission); None where a kind has no such
    chain."""
    cw_c = cw_f = None
    if model_id != 0:
        cw_c = ROW_SUMS(torch.where(in_range, c_emit, 0.0))
    if model_id == 2:
        cw_f = ROW_SUMS(torch.where(in_range, c_emit2, 0.0))
    return ROW_SUMS(gap_w), cw_c, cw_f


def _sweep_node_states(model_id: int, parent_ext, seed_self, c_emit, c_emit2,
                       same, gap_w, in_range, root_start_w=False,
                       sums=None):
    """Closed-form window sweep for every candidate at once.

    parent_ext [..., C, 2, Wb+1] parent values at v-1 (slot 0 = seed column)
    seed_self  [..., C, 2]       own stale value at row_start-1
    c_emit     [..., C, Wb]      y2[v, char] over the window
    c_emit2    [..., C, Wb]      y2[v, char+A] (flip-flop flop emissions)
    same       [..., C]          char == parent char
    gap_w      [..., 1, Wb]      y2[v, gap] over the window (0 out of range)
    in_range   [..., C, Wb]      window-cell validity
    sums       ``_row_sums`` of these inputs (computed here when None)
    Returns the new sweep [..., C, 2, Wb]."""
    if sums is None:
        sums = _row_sums(model_id, c_emit, c_emit2, gap_w, in_range)
    cw_gap, cw_c, cw_f = sums
    p0 = parent_ext[..., 0, :-1]
    p1 = parent_ext[..., 1, :-1]
    p_tot = torch.logaddexp(p0, p1)
    if model_id == 0:  # ctc: single component, stay weight = gap
        E = torch.where(in_range, p_tot + c_emit, _NEG_INF)
        out0 = _cumlse_cw(E, cw_gap, seed_self[..., 0])
        out1 = torch.full_like(out0, _NEG_INF)
    elif model_id == 1:  # bonito: (gap, no_gap)
        src = torch.where(same[..., None], p0, p_tot)
        ce = torch.where(in_range, c_emit, 0.0)
        # no_gap(w) = lse(src(w-1) + ce(w), no_gap(w-1) + ce(w))
        out_ng = _cumlse_cw(torch.where(in_range, src + ce, _NEG_INF), cw_c,
                            seed_self[..., 1])
        # total(w) = lse(no_gap(w), total(w-1) + gap(w))
        seed_tot = torch.logaddexp(seed_self[..., 0], seed_self[..., 1])
        tot = _cumlse_cw(torch.where(in_range, out_ng, _NEG_INF), cw_gap,
                         seed_tot)
        # gap(w) = total(w-1) + gap_w(w)
        tot_prev = torch.cat([seed_tot[..., None], tot[..., :-1]], dim=-1)
        out0 = torch.where(in_range, tot_prev + gap_w, _NEG_INF)
        out1 = out_ng
    else:  # flip-flop: (flip, flop); the stay weights are the emissions
        ce = torch.where(in_range, c_emit, 0.0)
        cf = torch.where(in_range, c_emit2, 0.0)
        emit_flip = torch.where(same[..., None], p1, p_tot) + ce
        emit_flop = torch.where(same[..., None], p0 + cf, _NEG_INF)
        # a root child may start on a flop at v == 0 (PrefixTree.h:606-608)
        emit_flop = torch.where(root_start_w, cf, emit_flop)
        out0 = _cumlse_cw(torch.where(in_range, emit_flip, _NEG_INF), cw_c,
                          seed_self[..., 0])
        out1 = _cumlse_cw(torch.where(in_range, emit_flop, _NEG_INF), cw_f,
                          seed_self[..., 1])
    out = torch.stack([out0, out1], dim=-2)
    return torch.where(in_range[..., None, :], out, _NEG_INF)


def _log_half(dtype):
    """log(0.5) rounded to ``dtype``, the flip-flop root's components."""
    return torch.tensor(np.log(0.5), dtype=dtype).item()


def _root_ext(model_id: int, rs, Wb: int, cum_pad, dtype, pad: int):
    """The root's read-2 state at v = rs-1 .. rs+Wb-1, [B, 2, Wb+1]. ctc
    2D roots hold the cumulative gap mass at every t and 0 at t=-1
    (PrefixTree.h:499-515); bonito / flip-flop roots only hold t=-1
    (PrefixTree.h:585-598, :674-688). ``cum_pad`` [B, L]: the cumulative
    gap mass at pad + t (zeros before t = 0, -inf past the read)."""
    k = torch.arange(Wb + 1, device=rs.device)
    v = rs[:, None] - 1 + k
    ninf = torch.full(v.shape, _NEG_INF, dtype=dtype, device=rs.device)
    if model_id == 0:
        vals = torch.gather(cum_pad, 1, v + pad)
        comp0 = torch.where(v >= -1, vals, _NEG_INF)
        comp1 = ninf
    elif model_id == 1:
        comp0 = torch.where(v == -1, 0.0, ninf)
        comp1 = ninf
    else:
        comp0 = comp1 = torch.where(v == -1, _log_half(dtype), ninf)
    return torch.stack([comp0, comp1], dim=1)


def _rows_of(x, idx):
    """x [B, C, ...] gathered along dim 1 at idx [B, N]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _layered_axis_sweep(model_id: int, A: int, Wb: int, rs, re,
                        nk1, nk2, npk1, npk2, nchar, npchar, nvalid,
                        stale, prev_off, psweep, poff, y_pad, cum_pad,
                        pad: int):
    """Sweep every candidate's read-2 state across its row's window [rs,
    re), each node once after its parent (the JAX engine's layered closed
    forms). rs, re, prev_off [B]; keys, chars, nvalid, poff [B, C]; stale,
    psweep [B, C, 2, Wb] (own previous sweep at prev_off, frozen parent
    copies at poff); y_pad [B, L, S], cum_pad [B, L] (``_root_ext``).
    Returns (new_sweep, new_psweep, new_poff, window_max [B, C])."""
    B, C = nk1.shape
    dev, dtype = stale.device, stale.dtype
    stale_ext = _shift_window(stale, prev_off[:, None, None],
                              rs[:, None, None], Wb, extra=1)
    seeds = stale_ext[..., 0]  # [B, C, 2] value at rs-1

    v_abs = rs[:, None] + torch.arange(Wb, device=dev)  # [B, Wb]
    in_range_row = v_abs < re[:, None]
    S = y_pad.shape[-1]
    y_w = torch.gather(y_pad, 1, (v_abs + pad)[..., None].expand(B, Wb, S))
    gap_w = torch.where(in_range_row, y_w[..., -1], 0.0)[:, None, :]
    yT = y_w.transpose(1, 2)  # [B, S, Wb]
    nchar_safe = nchar.clamp(min=0)
    c_emit = torch.gather(yT, 1, nchar_safe[..., None].expand(B, C, Wb))
    c_emit2 = (torch.gather(yT, 1, (nchar_safe + A)[..., None].expand(
        B, C, Wb)) if model_id == 2 else torch.zeros_like(c_emit))
    same = nchar == npchar
    in_range = in_range_row[:, None, :] & nvalid[..., None]

    parent_slot = _lookup_idx(npk1, npk2, nk1, nk2, nvalid)
    is_root_parent = (npk1 == 0) & (npk2 == 0)
    parent_slot = torch.where(is_root_parent, -1, parent_slot)
    has_parent = parent_slot >= 0
    pidx = parent_slot.clamp(min=0)

    root_vec = _root_ext(model_id, rs, Wb, cum_pad, dtype, pad)
    pstale_ext = _shift_window(psweep, poff[..., None],
                               rs[:, None, None], Wb, extra=1)
    parent_ext_external = torch.where(is_root_parent[..., None, None],
                                      root_vec[:, None], pstale_ext)
    root_start_w = is_root_parent[..., None] & (v_abs == 0)[:, None, :]
    sums = _row_sums(model_id, c_emit, c_emit2, gap_w, in_range)

    cur = torch.cat([seeds[..., None], torch.full(
        (B, C, 2, Wb), _NEG_INF, dtype=dtype, device=dev)], dim=-1)
    done = torch.zeros(B, C, dtype=torch.bool, device=dev)
    while True:
        parent_done = torch.where(has_parent, torch.gather(done, 1, pidx),
                                  True)
        ready = ~done & parent_done & nvalid
        if not bool(ready.any()):
            break
        parent_ext = torch.where(has_parent[..., None, None],
                                 _rows_of(cur, pidx), parent_ext_external)
        new = _sweep_node_states(model_id, parent_ext, seeds, c_emit,
                                 c_emit2, same, gap_w, in_range,
                                 root_start_w, sums)
        cur = torch.where(ready[..., None, None],
                          torch.cat([seeds[..., None], new], dim=-1), cur)
        done = done | ready
    new_sweep = cur[..., 1:]

    # frozen parent copies refreshed where the parent was swept this row
    new_psweep = torch.where(has_parent[..., None, None],
                             _rows_of(new_sweep, pidx), psweep)
    new_poff = torch.where(has_parent, rs[:, None], poff)
    tot = torch.logaddexp(new_sweep[..., 0, :], new_sweep[..., 1, :])
    window_max = torch.where(in_range, tot, _NEG_INF).max(dim=-1).values
    return new_sweep, new_psweep, new_poff, window_max


def _beam2d_row_iteration(model_id: int, W: int, A: int, Wb: int, cand,
                          u, rs, re, y1_u, consts):
    """One row u of the by-row search for a wave: u, rs, re [B]; y1_u
    [B, S] read 1's row u; consts (cum1 [B, U], y2_pad, cum2_pad, pad).
    Returns (new_cand, beam_src [B, W])."""
    cum1, y2_pad, cum2_pad, pad = consts
    B = u.shape[0]
    dtype = cand["state0"].dtype

    # ---- dedup + prune on the carried scores
    keep = _dedup_mask(cand["k1"], cand["k2"], cand["valid"])
    scores = torch.where(keep, cand["score"], _NEG_INF)
    beam_src = _top_w(scores, W)
    g = lambda name: _rows_of(cand[name], beam_src)  # noqa: E731
    bk1, bk2, bpk1, bpk2 = g("k1"), g("k2"), g("pk1"), g("pk2")
    bchar, bpchar = g("char"), g("pchar")
    bvalid = _rows_of(keep, beam_src)
    bstate0, bsweep1 = g("state0"), g("sweep1")
    bpsweep1, bpoff = g("psweep1"), g("poff")

    # ---- u-phase: read 1's state one step on (BeamSearch.h:132-144)
    parent0_prev = _lookup(bpk1, bpk2, cand["k1"], cand["k2"],
                           cand["valid"], cand["state0"])
    root_parent = (bpk1 == 0) & (bpk2 == 0)
    at0 = (u == 0)[:, None]
    ninf = torch.full((B, W), _NEG_INF, dtype=dtype, device=u.device)
    if model_id == 0:
        prev = torch.gather(cum1, 1, (u - 1).clamp(min=0)[:, None])
        root0_prev = torch.where(at0, 0.0, prev).expand(B, W)
        is_root = root_parent & bvalid
        root_state = torch.stack([root0_prev, ninf], dim=-1)
    elif model_id == 1:
        is_root = root_parent & bvalid & at0
        root_state = torch.stack([torch.zeros_like(ninf), ninf], dim=-1)
    else:
        is_root = root_parent & bvalid & at0
        root_state = torch.full((B, W, 2), _log_half(dtype), dtype=dtype,
                                device=u.device)
    parent0_prev = torch.where(is_root[..., None], root_state, parent0_prev)
    new_bstate0 = _node_update(model_id, bstate0, parent0_prev,
                               bchar.clamp(min=0), bpchar, y1_u, A,
                               root_start=root_parent & at0)
    new_bstate0 = torch.where(bvalid[..., None], new_bstate0, _NEG_INF)

    cchar = torch.arange(A, device=u.device).repeat(W)[None].expand(
        B, W * A)
    cp1 = bk1.repeat_interleave(A, dim=1)
    cp2 = bk2.repeat_interleave(A, dim=1)
    ck1, ck2 = _child_keys(cp1, cp2, cchar)
    cpchar = bchar.repeat_interleave(A, dim=1)
    child0_prev = _lookup(ck1, ck2, cand["k1"], cand["k2"], cand["valid"],
                          cand["state0"])
    new_cstate0 = _node_update(model_id, child0_prev,
                               bstate0.repeat_interleave(A, dim=1), cchar,
                               cpchar, y1_u, A)
    cvalid = bvalid.repeat_interleave(A, dim=1)
    new_cstate0 = torch.where(cvalid[..., None], new_cstate0, _NEG_INF)

    nk1, nk2 = torch.cat([bk1, ck1], 1), torch.cat([bk2, ck2], 1)
    npk1, npk2 = torch.cat([bpk1, cp1], 1), torch.cat([bpk2, cp2], 1)
    nchar, npchar = torch.cat([bchar, cchar], 1), torch.cat([bpchar, cpchar],
                                                            1)
    nvalid = torch.cat([bvalid, cvalid], 1)
    nstate0 = torch.cat([new_bstate0, new_cstate0], 1)

    # ---- stale read-2 sweeps of the new table
    child_stale_idx = _lookup_idx(ck1, ck2, cand["k1"], cand["k2"],
                                  cand["valid"])
    child_stale = torch.where(
        (child_stale_idx >= 0)[..., None, None],
        _rows_of(cand["sweep1"], child_stale_idx.clamp(min=0)), _NEG_INF)
    stale = torch.cat([bsweep1, child_stale], 1)
    prev_off = cand["off"]
    # frozen parent sweeps: stays keep theirs; a child's parent is a beam
    # node, so its frozen copy is that node's previous sweep
    psweep = torch.cat([bpsweep1, bsweep1.repeat_interleave(A, dim=1)], 1)
    poff = torch.cat([bpoff, prev_off[:, None].expand(B, W * A)], 1)

    # ---- v-phase: the layered closed-form sweep (BeamSearch.h:146-156)
    new_sweep1, new_psweep, new_poff, max1 = _layered_axis_sweep(
        model_id, A, Wb, rs, re, nk1, nk2, npk1, npk2, nchar, npchar,
        nvalid, stale, prev_off, psweep, poff, y2_pad, cum2_pad, pad)

    # ---- scores: last0 + max over the row of read 2 (node_greater_max)
    last0 = torch.logaddexp(nstate0[..., 0], nstate0[..., 1])
    nscore = torch.where(nvalid, last0 + max1, _NEG_INF)
    return dict(k1=nk1, k2=nk2, pk1=npk1, pk2=npk2, char=nchar,
                pchar=npchar, valid=nvalid, state0=nstate0,
                sweep1=new_sweep1, off=rs, score=nscore, psweep1=new_psweep,
                poff=new_poff), beam_src


# meta columns of a packed wave (one int64 row per workload): read 1's
# first row in ``y1`` / ``cum1`` and its length U, read 2's likewise, the
# first of its rows in ``rows`` and their count R, the u of its first row
# (0 with an envelope, 1 without), its window width Wb, its storage's
# first float in the kernel's global scratch (set by
# ``pair_row_beam.prepare_rows``; 0 here)
(RM_Y1, RM_U, RM_Y2, RM_V, RM_ROW, RM_R, RM_U0, RM_WB, RM_SCR) = range(9)
ROW_META_COLS = 9


def row_bounds(U: int, V: int, envelope=None):
    """The rows the by-row search visits, as the JAX entry builds them:
    (u0, rs, re) with an envelope u = 0..U-1 over its rows; without one u
    = 1..U-1 over the whole of read 2."""
    if envelope is None:
        n = max(U - 1, 0)
        return 1, np.zeros(n, np.int64), np.full(n, V, np.int64)
    env = np.asarray(envelope, dtype=np.int64)[:U]
    return 0, env[:, 0], env[:, 1]


def workload_error(y1, y2, envelope=None):
    """What the JAX package's by-row search raises on a workload before any
    result (None if nothing): no rows (ValueError: the JAX entry's window
    width is a maximum over none), an empty read 2 (IndexError: its root
    children read y2[0]) or an all-empty window (IndexError: its first
    column is written)."""
    u0, rs, re = row_bounds(len(y1), len(y2), envelope)
    if len(rs) == 0:
        return ValueError("zero-size array to reduction operation maximum "
                          "which has no identity")
    if len(y2) == 0:
        return IndexError("index is out of bounds for axis 0 with size 0")
    if int(np.max(re - rs)) <= 0:
        return IndexError("index is out of bounds for axis 2 with size 0")
    for name, ok in (("row starts", rs >= 0), ("row ends", re <= len(y2)),
                     ("rows", rs <= re)):
        if not ok.all():
            return ValueError(f"by-row search: {name} outside read 2")
    return None


def pack_rows(workloads, beam_width: int = 5, alphabet: str = "ACGT",
              model: str = "ctc", dtype=np.float32, n_rows=None):
    """Host-side packing of B (y1, y2, envelope) workloads of one model
    kind for the by-row search (its kernel and its plain version). Raises
    what the JAX engine raises on a workload (``workload_error``).

    Returns a dict of numpy arrays: ``y1`` / ``y2`` ([sum U, S] / [sum V,
    S] back to back), ``cum1`` / ``cum2`` (each read's cumulative gap
    mass, ``ROW_SUMS`` in ``dtype`` from its own start), ``rows`` int32
    [sum R, 2] (rs, re per row), ``meta`` int64 [B, ROW_META_COLS], and W,
    A and the kind's ``model_id``. ``n_rows`` (a list)
    cuts each workload to its first rows (the card's checks against the
    plain version), at the whole workload's window width."""
    A = len(alphabet)
    W = beam_width
    model_id = _MODEL_IDS[model]
    S = 2 * A if model_id == 2 else A + 1
    meta = np.zeros((len(workloads), ROW_META_COLS), np.int64)
    y1s, y2s, c1s, c2s, rows = [], [], [], [], []
    o1 = o2 = orow = 0
    for b, (y1, y2, envelope) in enumerate(workloads):
        err = workload_error(y1, y2, envelope)
        if err is not None:
            raise err
        # C order (a reverse-complemented trace may be a Fortran-order
        # view, which np.concatenate would keep)
        y1 = np.ascontiguousarray(y1, dtype=dtype)
        y2 = np.ascontiguousarray(y2, dtype=dtype)
        if y1.shape[1] != S or y2.shape[1] != S:
            raise ValueError(f"{model} traces take {S} columns; got "
                             f"{y1.shape[1]} and {y2.shape[1]}")
        u0, rs, re = row_bounds(len(y1), len(y2), envelope)
        Wb = int(np.max(re - rs))
        R = len(rs) if n_rows is None else min(len(rs), int(n_rows[b]))
        meta[b] = (o1, len(y1), o2, len(y2), orow, R, u0, Wb, 0)
        y1s.append(y1)
        y2s.append(y2)
        c1s.append(ROW_SUMS(torch.from_numpy(y1[:, -1].copy())).numpy())
        c2s.append(ROW_SUMS(torch.from_numpy(y2[:, -1].copy())).numpy())
        rows.append(np.stack([rs[:R], re[:R]], 1).astype(np.int32))
        o1 += len(y1)
        o2 += len(y2)
        orow += R
    cat = (lambda xs, shape, dt: np.concatenate(xs) if xs
           else np.zeros(shape, dt))
    return dict(y1=cat(y1s, (0, S), dtype), y2=cat(y2s, (0, S), dtype),
                cum1=cat(c1s, (0,), dtype), cum2=cat(c2s, (0,), dtype),
                rows=cat(rows, (0, 2), np.int32), meta=meta, W=W, A=A,
                alphabet=alphabet, model_id=model_id)


def _unpack(flat, meta_h, c_off: int, c_len: int, pad_front: int,
            pad_back: int, front, back):
    """Each workload's rows of ``flat`` ([n, ...]) into a padded [B, L,
    ...] tensor: ``pad_front`` rows of ``front`` first, ``back`` after."""
    B = meta_h.shape[0]
    L = pad_front + int(meta_h[:, c_len].max(initial=0)) + pad_back
    out = torch.full((B, L) + tuple(flat.shape[1:]), back,
                     dtype=flat.dtype, device=flat.device)
    out[:, :pad_front] = front
    for b in range(B):
        o, n = int(meta_h[b, c_off]), int(meta_h[b, c_len])
        out[b, pad_front:pad_front + n] = flat[o:o + n]
    return out


def row_scan(y1, y2, cum1, cum2, rows, meta, meta_h, W: int, A: int,
             model_id: int = 0):
    """The by-row search of a packed wave (``pack_rows``): the plain
    version of the kernel ``csrc/pair_row_beam.cu``, with the same inputs
    and outputs. Returns (src int16 [sum R, W]: each row's beam_src,
    score [B, C] and valid [B, C]: the final table, chars int8 [sum R]:
    the character each row's traceback step adds (-1 none), first int8
    [B]: the traceback's first character), on the inputs' device."""
    del meta  # the host copy drives the loop
    meta_h = np.asarray(meta_h)
    dev, dtype = y1.device, y1.dtype
    B = meta_h.shape[0]
    C = W * (A + 1)
    src = torch.zeros(len(rows), W, dtype=torch.int16, device=dev)
    if B == 0:
        e = torch.zeros(0, C, device=dev)
        return (src, e.to(dtype), e.bool(),
                torch.zeros(len(rows), dtype=torch.int8, device=dev),
                torch.zeros(0, dtype=torch.int8, device=dev))
    Wb = int(meta_h[:, RM_WB].max())
    pad = max(Wb + 2, 2)
    y1p = _unpack(y1, meta_h, RM_Y1, RM_U, 0, 0, 0.0, 0.0)
    cum1p = _unpack(cum1, meta_h, RM_Y1, RM_U, 0, 0, 0.0, 0.0)
    y2p = _unpack(y2, meta_h, RM_Y2, RM_V, pad, pad, _NEG_INF, _NEG_INF)
    cum2p = _unpack(cum2, meta_h, RM_Y2, RM_V, pad, pad, 0.0, _NEG_INF)
    consts = (cum1p, y2p, cum2p, pad)

    u0 = torch.as_tensor(meta_h[:, RM_U0], device=dev)
    cands = [_init_candidates(model_id, y1p[b, 0], W, A) for b in range(B)]
    init2 = [_init_candidates(model_id, y2p[b, pad], W, A)["state"]
             for b in range(B)]
    cand = {k: torch.stack([c[k] for c in cands]) for k in cands[0]}
    state0 = cand.pop("state")
    # a scan from u = 0 computes row 0 itself; from u = 1 it needs the
    # init value
    cand["state0"] = torch.where((u0 == 0)[:, None, None], _NEG_INF, state0)
    sweep1 = torch.full((B, C, 2, Wb), _NEG_INF, dtype=dtype, device=dev)
    sweep1[..., 0] = torch.stack(init2)
    cand.update(
        sweep1=sweep1, off=torch.zeros(B, dtype=torch.int64, device=dev),
        score=torch.where(cand["valid"], 0.0, _NEG_INF).to(dtype),
        psweep1=torch.full_like(sweep1, _NEG_INF),
        poff=torch.zeros(B, C, dtype=torch.int64, device=dev))

    R = meta_h[:, RM_R]
    rows_l = rows.to(torch.int64)
    row0 = torch.as_tensor(meta_h[:, RM_ROW], device=dev)
    R_d = torch.as_tensor(R, device=dev)
    for r in range(int(R.max())):
        active = r < R_d
        ri = row0 + torch.minimum(torch.as_tensor(r, device=dev),
                                  (R_d - 1).clamp(min=0))
        # a workload past its last row reads its last row's inputs and
        # keeps its table
        u = torch.minimum(u0 + r, torch.as_tensor(meta_h[:, RM_U] - 1,
                                                  device=dev))
        y1_u = _rows_of(y1p, u[:, None])[:, 0]
        new, beam_src = _beam2d_row_iteration(
            model_id, W, A, Wb, cand, u, rows_l[ri, 0], rows_l[ri, 1], y1_u,
            consts)
        cand = {k: torch.where(active.reshape((B,) + (1,) * (v.dim() - 1)),
                               v, cand[k]) for k, v in new.items()}
        on = np.nonzero(R > r)[0]
        src[torch.as_tensor(meta_h[on, RM_ROW] + r, device=dev)] = \
            beam_src[torch.as_tensor(on, device=dev)].to(torch.int16)
    chars, first = tracebacks_rows(src.cpu().numpy(), cand, meta_h, W, A)
    return (src, cand["score"], cand["valid"],
            torch.as_tensor(chars, device=dev),
            torch.as_tensor(first, device=dev))


def tracebacks_rows(src_h, cand, meta_h, W: int, A: int):
    """The JAX engine's traceback (``_beam2d_row_scan``'s ``back``): from
    the final table's best candidate (first maximum of the deduplicated
    scores) back through each row's beam_src. Returns (chars int8 [sum R],
    first int8 [B])."""
    keep = _dedup_mask(cand["k1"], cand["k2"], cand["valid"])
    scores = torch.where(keep, cand["score"], _NEG_INF)
    top = torch.argmax(scores, dim=-1).cpu().numpy()
    chars = np.full(len(src_h), -1, np.int8)
    first = np.full(len(top), -1, np.int8)
    for b, j in enumerate(top):
        o, n = int(meta_h[b, RM_ROW]), int(meta_h[b, RM_R])
        j = int(j)
        for r in range(o + n - 1, o - 1, -1):
            if j >= W:
                chars[r] = (j - W) % A
                j = int(src_h[r, (j - W) // A])
            else:
                j = int(src_h[r, j])
        first[b] = (j - W) % A if j >= W else -1
    return chars, first


def strings_of(packed, chars_h, first_h) -> list[str]:
    """The consensus of each workload of a packed wave from its traceback
    (``row_scan``'s chars and first, on the host)."""
    letters = np.array(list(packed["alphabet"]))
    out = []
    for b, m in enumerate(packed["meta"]):
        cs = np.concatenate([first_h[b:b + 1],
                             chars_h[m[RM_ROW]:m[RM_ROW] + m[RM_R]]])
        out.append("".join(letters[cs[cs >= 0]]))
    return out


def beam_search_2d(y1, y2, envelope=None, beam_width: int = 25,
                   alphabet: str = "ACGT", model: str = "ctc",
                   method: str = "row", device=None, dtype=np.float32) -> str:
    """2D pair beam search for one pair (``poreover_tpu/ops/beam2d.py:
    beam_search_2d``; the reference's cpp_beam_search_2d).

    envelope: optional [U, 2] int array of per-u [row_start, row_end);
    None is the full lattice. ``method``:
      - ``"row"`` (the reference's default traversal): on a CUDA device
        the kernel ``csrc/pair_row_beam.cu`` (``ops/pair_row_beam.py``),
        one CTA; on the CPU its plain version ``row_scan`` (in ``dtype``).
      - ``"row_col"``: the pair-beam kernel launched with one CTA
        (``pair_beam_batch.pair_beam_single``, the port of the single-pair
        Pallas kernel; the JAX package runs bonito and flip-flop pairs
        through its XLA planned engine, whose semantics the kernel keeps),
        on the CPU its plain version.
      - ``"grid"``: the reference's per-cell beam, host code
        (``decoding/replica2d.py``), on any device, guarded at 10M cells.
      - ``"row_col_steps"`` is not ported (NotImplementedError)."""
    if method not in ("row", "row_col", "row_col_steps", "grid"):
        raise ValueError(f"unsupported 2D beam method {method!r}")
    from .beam2d_planned import _check_model

    _check_model(model)
    y1 = np.asarray(y1)
    y2 = np.asarray(y2)
    if method == "grid":
        return _grid(y1, y2, envelope, beam_width, alphabet, model)
    if method == "row":
        from .pair_row_beam import pair_row_beam

        return pair_row_beam([(y1, y2, envelope)], beam_width, alphabet,
                             device=device, model=model, dtype=dtype)[0]
    if method != "row_col":
        raise NotImplementedError(
            f"beam_search_2d method {method!r} is not ported to PyTorch yet "
            "(ROADMAP item A13b-3)")
    from .pair_beam_batch import pair_beam_single

    if envelope is None:
        envelope = np.tile(np.array([0, len(y2)], dtype=np.int64),
                           (len(y1), 1))
    return pair_beam_single(y1, y2, envelope, beam_width, alphabet, device,
                            model)


GRID_CELL_LIMIT = 10_000_000


def _grid(y1, y2, envelope, beam_width, alphabet, model) -> str:
    """``method="grid"``: the reference's deprecated per-cell beam
    (BeamSearch2.h:33-184), exact host code, as in the JAX package
    (``poreover_tpu/ops/beam2d.py:468-501``), with its 10M-cell guard."""
    import logging

    logging.getLogger("poreover_tpu_torch").warning(
        "method='grid' is the reference's deprecated per-cell-beam "
        "benchmark control (BeamSearch2.h); it runs as an exact HOST-side "
        "parity implementation, not on the GPU — use method='row_col' for "
        "the accelerated path")
    U, V = len(y1), len(y2)
    if envelope is None:
        cells = U * V
    else:
        env_g = np.asarray(envelope, dtype=np.int64)[:U]
        cells = int(np.sum(np.maximum(env_g[:, 1], 0)
                           - np.maximum(env_g[:, 0], 0)))
    if cells > GRID_CELL_LIMIT:
        raise MemoryError(
            f"grid method over {cells} lattice cells exceeds the "
            "10M-cell guard (one beam per cell); use method='row_col'")
    from ..decoding.replica2d import beam_search_2d_grid_replica

    return beam_search_2d_grid_replica(y1, y2, alphabet=alphabet,
                                       beam_width=beam_width, model=model,
                                       envelope=envelope)
