"""Vectorized 1D CTC beam search and the candidate-table helpers of the
beam searches (PyTorch).

Port of ``poreover_tpu/ops/beam.py``: the helpers the 2D engines share,
and the 1D engine (``beam_search`` / ``beam_search_batch``) for all three
model kinds (ctc, ctc_merge_repeats, ctc_flipflop). The beam lives in a
fixed-shape candidate table of C = W*(A+1) slots: W surviving beam nodes
plus their W*A children. Prefix identity is a pair of 32-bit rolling
hashes. Torch has no uint32 multiply, so keys are carried as int64 holding
a value in [0, 2**32), and the multiply is split into 16-bit halves so no
int64 product overflows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.logspace import LOG_0

_NEG_INF = LOG_0

_M1 = 2654435761  # Knuth multiplicative hash constants
_M2 = 40503
_MASK32 = 0xFFFFFFFF
_MODEL_IDS = {"ctc": 0, "ctc_merge_repeats": 1, "ctc_flipflop": 2}


def _mul32(k: torch.Tensor, m: int) -> torch.Tensor:
    """(k * m) mod 2**32 for int64 k in [0, 2**32)."""
    lo = k & 0xFFFF
    hi = k >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _MASK32


def _child_keys(k1, k2, c):
    """Rolling prefix hash extension by character c (c in [0, A))."""
    cc = c.to(torch.int64) + 1
    return (_mul32(k1, _M1) + cc) & _MASK32, (_mul32(k2, _M2) + cc) & _MASK32


def _init_candidates(model_id: int, y0: torch.Tensor, W: int, A: int):
    """Candidate table after the reference's first iteration (t=0): the A
    root children, placed in the child slots of beam row 0. ``y0`` is the
    [A+1] (or [2A]) log-prob row at t=0; the state is [C, 2]."""
    C = W * (A + 1)
    dev, dtype = y0.device, y0.dtype
    state = torch.full((C, 2), _NEG_INF, dtype=dtype, device=dev)
    zeros = torch.zeros(C, dtype=torch.int64, device=dev)
    k1, k2, pk1, pk2 = zeros.clone(), zeros.clone(), zeros.clone(), zeros
    char = torch.full((C,), -1, dtype=torch.int64, device=dev)
    pchar = char.clone()
    valid = torch.zeros(C, dtype=torch.bool, device=dev)

    cs = torch.arange(A, dtype=torch.int64, device=dev)
    root = torch.zeros(A, dtype=torch.int64, device=dev)
    ck1, ck2 = _child_keys(root, root, cs)
    idx = W + cs  # children of beam slot 0
    ninf = torch.full((A,), _NEG_INF, dtype=dtype, device=dev)
    if model_id == 0:  # (y0[c], -inf)
        st = torch.stack([y0[cs], ninf], dim=-1)
    elif model_id == 1:  # (gap=-inf, no_gap=y0[c])
        st = torch.stack([ninf, y0[cs]], dim=-1)
    else:  # (flip=y0[c], flop=y0[c+A])
        st = torch.stack([y0[cs], y0[cs + A]], dim=-1)
    state[idx] = st
    k1[idx] = ck1
    k2[idx] = ck2
    char[idx] = cs
    # parent is the root: keys stay 0, pchar stays -1 (never equals a char)
    valid[idx] = True
    return dict(state=state, k1=k1, k2=k2, pk1=pk1, pk2=pk2, char=char,
                pchar=pchar, valid=valid)


def _dedup_mask(k1, k2, valid):
    """True for the first valid occurrence of each key; duplicates False.
    Works on [..., C] tables."""
    C = k1.shape[-1]
    eq = (k1[..., :, None] == k1[..., None, :]) & (
        k2[..., :, None] == k2[..., None, :])
    eq = eq & valid[..., :, None] & valid[..., None, :]
    earlier = torch.ones(C, C, dtype=torch.bool, device=k1.device).tril(-1)
    dup = (eq & earlier).any(dim=-1)
    return valid & ~dup


# --------------------------------------------------------------------------
# the 1D engine: port of poreover_tpu/ops/beam.py:_beam_search_scan, batched
# with a written-out batch dimension. A plain Python loop over time; the
# oracle the CUDA kernel's plain version (ops/beam1d.py) is held against.
# --------------------------------------------------------------------------

def _score(state):
    return torch.logaddexp(state[..., 0], state[..., 1])


def _node_update(model_id: int, state_prev, parent_prev, c, parent_c, y_t,
                 A: int, root_start=False):
    """One node's state update at time t, for [B, N] nodes.

    state_prev  [B, N, 2] : this node's state at t-1 (-inf,-inf if absent)
    parent_prev [B, N, 2] : parent node's state at t-1
    c, parent_c [B, N]    : last characters of node and parent
    y_t         [B, S]    : log-prob row at time t
    root_start            : parent is the root AND t == 0 (flip-flop may
        then start on a flop: emit_flop = y[0][c+A]); never true inside the
        scan, where ``_init_candidates`` has already folded it in.
    """
    y_c = torch.gather(y_t, 1, c)
    s0, s1 = state_prev[..., 0], state_prev[..., 1]
    p0, p1 = parent_prev[..., 0], parent_prev[..., 1]
    parent_total = torch.logaddexp(p0, p1)
    same = c == parent_c
    gap_y = y_t[:, -1:]

    if model_id == 0:  # ctc: state = (prob, -inf)
        new0 = torch.logaddexp(parent_total + y_c, s0 + gap_y)
        new1 = torch.full_like(new0, _NEG_INF)
    elif model_id == 1:  # bonito: state = (gap, no_gap)
        new0 = torch.logaddexp(s0, s1) + gap_y
        src = torch.where(same, p0, parent_total)
        new1 = torch.logaddexp(src + y_c, s1 + y_c)
    else:  # flipflop: state = (flip, flop); flop emissions at c+A
        y_cf = torch.gather(y_t, 1, c + A)
        emit_flip = torch.where(same, p1, parent_total) + y_c
        emit_flop = torch.where(same, p0 + y_cf, _NEG_INF)
        if root_start is not False:
            emit_flop = torch.where(root_start, y_cf, emit_flop)
        new0 = torch.logaddexp(emit_flip, s0 + y_c)
        new1 = torch.logaddexp(emit_flop, s1 + y_cf)
    return torch.stack([new0, new1], dim=-1)


def _lookup(qk1, qk2, tk1, tk2, tvalid, tstate):
    """Hash-join: for each query key [B, Q], the state of the matching
    table row of [B, C] (-inf,-inf when absent)."""
    eq = (qk1[:, :, None] == tk1[:, None, :]) & (
        qk2[:, :, None] == tk2[:, None, :])
    eq = eq & tvalid[:, None, :]
    # at most one real match; masked max recovers it
    masked = torch.where(eq[..., None], tstate[:, None, :, :], _NEG_INF)
    return masked.max(dim=2).values


def _top_w(scores, W: int):
    """Indices of the W largest along the last axis, equal scores by
    lowest index (as jax.lax.top_k orders them)."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :W]


def _pad_bucket(T: int, granule: int = 512) -> int:
    """Round a read length up to a padded bucket; the decode pipeline groups
    reads of one bucket into one wave."""
    return max(granule, ((T + granule - 1) // granule) * granule)


def _root_cum(blank: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative blank mass along the last axis, accumulated in
    float64 and rounded once (so the order of the additions does not show
    on any device)."""
    return torch.cumsum(blank.to(torch.float64), dim=-1).to(blank.dtype)


def _beam_search_scan(y, lens, model_id: int, W: int, A: int):
    """The engine's scan for a padded batch. y [B, T, S] (rows at or beyond
    a read's length are never read into the carry), lens [B] host ints.
    Returns (first_char [B], chars [T-1, B]) as numpy: the char decoded at
    each step, -1 for none."""
    B, T, _ = y.shape
    dev, dtype = y.device, y.dtype
    lens_h = np.asarray(lens, dtype=np.int64)
    lens_d = torch.as_tensor(lens_h, device=dev)
    cands = [_init_candidates(model_id, y[b, 0], W, A) for b in range(B)]
    cand = {k: torch.stack([c[k] for c in cands]) for k in cands[0]}
    if model_id == 0:
        t_ok = torch.arange(T, device=dev)[None, :] < lens_d[:, None]
        root_cum = _root_cum(torch.where(t_ok, y[:, :, -1], 0.0))
    cs = torch.arange(A, dtype=torch.int64, device=dev)
    cchar = cs.repeat(W)[None, :].expand(B, W * A)
    neg = torch.full((B, W), _NEG_INF, dtype=dtype, device=dev)
    srcs = torch.zeros(max(T - 1, 0), B, W, dtype=torch.int16, device=dev)

    def take(x, idx):
        if x.dim() == 3:
            return torch.gather(x, 1, idx[..., None].expand(-1, -1, 2))
        return torch.gather(x, 1, idx)

    for t in range(1, T):
        y_t = y[:, t]
        valid_t = t < lens_d
        # ---- dedup + prune to beam of W
        keep = _dedup_mask(cand["k1"], cand["k2"], cand["valid"])
        scores = torch.where(keep, _score(cand["state"]), _NEG_INF)
        beam_src = _top_w(scores, W)
        bstate = take(cand["state"], beam_src)
        bk1, bk2 = take(cand["k1"], beam_src), take(cand["k2"], beam_src)
        bpk1, bpk2 = take(cand["pk1"], beam_src), take(cand["pk2"], beam_src)
        bchar = take(cand["char"], beam_src)
        bpchar = take(cand["pchar"], beam_src)
        bvalid = take(keep, beam_src)

        # ---- stay-update each beam node
        parent_prev = _lookup(bpk1, bpk2, cand["k1"], cand["k2"],
                              cand["valid"], cand["state"])
        if model_id == 0:
            # a depth-1 node's parent is the root, whose prob at t-1 is
            # the cumulative blank mass
            is_root_parent = (bpk1 == 0) & (bpk2 == 0) & bvalid
            root_state = torch.stack(
                [root_cum[:, t - 1:t].expand(B, W), neg], dim=-1)
            parent_prev = torch.where(is_root_parent[..., None], root_state,
                                      parent_prev)
        new_bstate = _node_update(model_id, bstate, parent_prev,
                                  bchar.clamp(min=0), bpchar, y_t, A)
        new_bstate = torch.where(bvalid[..., None], new_bstate, _NEG_INF)

        # ---- expand children
        cp1 = bk1.repeat_interleave(A, dim=1)
        cp2 = bk2.repeat_interleave(A, dim=1)
        ck1, ck2 = _child_keys(cp1, cp2, cchar)
        cpchar = bchar.repeat_interleave(A, dim=1)
        child_prev = _lookup(ck1, ck2, cand["k1"], cand["k2"],
                             cand["valid"], cand["state"])
        parent_for_child = bstate.repeat_interleave(A, dim=1)
        new_cstate = _node_update(model_id, child_prev, parent_for_child,
                                  cchar, cpchar, y_t, A)
        cvalid = bvalid.repeat_interleave(A, dim=1)
        new_cstate = torch.where(cvalid[..., None], new_cstate, _NEG_INF)

        new_cand = dict(
            state=torch.cat([new_bstate, new_cstate], dim=1),
            k1=torch.cat([bk1, ck1], dim=1),
            k2=torch.cat([bk2, ck2], dim=1),
            pk1=torch.cat([bpk1, cp1], dim=1),
            pk2=torch.cat([bpk2, cp2], dim=1),
            char=torch.cat([bchar, cchar], dim=1),
            pchar=torch.cat([bpchar, cpchar], dim=1),
            valid=torch.cat([bvalid, cvalid], dim=1),
        )
        # steps beyond a read's length leave its table untouched
        cand = {
            k: torch.where(valid_t.reshape((B,) + (1,) * (v.dim() - 1)),
                           v, cand[k])
            for k, v in new_cand.items()
        }
        srcs[t - 1] = beam_src

    # ---- final top-1
    keep = _dedup_mask(cand["k1"], cand["k2"], cand["valid"])
    scores = torch.where(keep, _score(cand["state"]), _NEG_INF)
    j = _top_w(scores, 1)[:, 0].cpu().numpy()

    # ---- traceback through provenance, newest step first
    srcs_h = srcs.cpu().numpy()
    chars = np.full((max(T - 1, 0), B), -1, np.int64)
    rows = np.arange(B)
    for s in range(T - 2, -1, -1):
        adv = (s + 1) < lens_h
        is_child = j >= W
        c = np.where(is_child, (j - W) % A, -1)
        b = np.where(is_child, (j - W) // A, j)
        j = np.where(adv, srcs_h[s, rows, b], j)
        chars[s] = np.where(adv, c, -1)
    # j indexes the init table: a root child at W + c
    first_char = np.where(j >= W, (j - W) % A, -1)
    return first_char, chars


def beam_search_batch(ys, beam_width: int = 25, alphabet: str = "ACGT",
                      model: str = "ctc", device=None,
                      dtype=torch.float32) -> list[str]:
    """Beam-search decode a batch of reads with the engine, on ``device``
    (default cuda) in ``dtype``. Reads are padded to the longest; steps
    beyond a read's length are exact no-ops on its table, so a read
    decodes the same alone and in any batch. Returns sequences in input
    order."""
    from ..device import resolve_device

    dev = resolve_device(device)
    model_id = _MODEL_IDS[model]
    A = len(alphabet)
    if len(ys) == 0:
        return []
    ys = [np.asarray(y) for y in ys]
    lens = [int(y.shape[0]) for y in ys]
    B, T, S = len(ys), max(lens), int(ys[0].shape[1])
    yb = np.zeros((B, T, S), np.float64)
    for i, y in enumerate(ys):
        yb[i, :lens[i]] = y
    first_char, chars = _beam_search_scan(
        torch.as_tensor(yb, device=dev).to(dtype), lens, model_id,
        beam_width, A)
    letters = np.array(list(alphabet))
    out = []
    for i in range(B):
        cs = np.concatenate([first_char[i:i + 1], chars[:, i]])
        out.append("".join(letters[cs[cs >= 0]]))
    return out


def beam_search(y, beam_width: int = 25, alphabet: str = "ACGT",
                model: str = "ctc", device=None,
                dtype=torch.float32) -> str:
    """Beam-search decode one read with the engine."""
    return beam_search_batch([y], beam_width, alphabet, model, device,
                             dtype)[0]
