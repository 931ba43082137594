"""Plan-driven row_col 2D beam search: the plain PyTorch version.

Port of ``poreover_tpu/ops/beam2d_planned.py`` for all three model kinds
(``ctc``, ``ctc_merge_repeats`` for bonito, ``ctc_flipflop``), with the
windowed-memo semantics (``exact=False``) and the reference-exact
graveyard (``exact=True``), in float32 (or float64, for ``pair-decode
--f64``). It is the plain version of the CUDA kernels
``csrc/pair_beam_batch.cu`` and ``csrc/box_beam.cu``: they take the same
packed inputs (``pack_pairs``) and return the same outputs (per-step
winner provenance, final scores and validity), and the wrappers run this
version only for tensors on the CPU.

The (u, v) walk of the reference (BeamSearch.h:262-397) depends only on
the envelope, so the host precomputes it as a plan (``build_plan``):
MAIN steps (prune + expand + one windowed sweep per read) and merged
catch-up runs (C0RUN / C1RUN: one sweep of the current beam on one read).
Each candidate keeps a windowed history of its per-read sweep values,
[C, K, Wst] per read: K = 1 for plain CTC (the JAX engine's second state
component is -inf throughout there), K = 2 for bonito (gap, no gap) and
flip-flop (flip, flop). A sweep runs in CHUNK-column pieces; inside a
chunk the candidates are layered over their parent forest, and each
layer's stay chains have a closed form (cumulative log-add-exp,
``beam2d._lse_scan``): one chain for CTC, two chained ones for bonito
(the no-gap chain feeds the total), two independent ones for flip-flop.

The graveyard (``G`` > 0, the JAX engine's ``_planned_scan`` with G > 0):
a candidate that leaves the table keeps its storage for up to ``grace - 1``
further MAIN steps in one of G graveyard rows, and a child that is found
again resumes it instead of starting from -inf. The rows move with the
storage window (re-anchored on every sweep of their read) but are never
swept.

The engine is batched over B pairs in lockstep: each pair keeps its own
storage width Wst and its own plan length (steps past the end of a plan
leave that pair untouched), so a pair decodes the same alone as in any
batch, as in the kernel. A batch holds pairs of one model kind.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.logspace import LOG_0
from .beam import _MODEL_IDS, _child_keys, _dedup_mask, _init_candidates
from .beam2d import _cumlse_chain, _lookup_idx, _shift_window

_NEG_INF = LOG_0

CHUNK = 128

MAIN, C0RUN, C1RUN = 0, 1, 2

# reference-exact mode (the JAX engine's EXACT_G / EXACT_GRACE): graveyard
# rows, and the MAIN steps an evicted candidate's storage is kept for
EXACT_GRACE = 20
EXACT_G = 128

# meta columns of a packed batch (one int64 row per pair)
(M_T1, M_L1, M_Y1, M_T2, M_L2, M_Y2, M_PLAN, M_N, M_WST0, M_WST1,
 M_SCR) = range(11)
META_COLS = 12


def build_plan(env: np.ndarray, U: int, V: int):
    """Plan for an envelope, from the C++ walk (native/plan_walk.cpp)."""
    from .. import native

    return native.plan_walk_native(np.asarray(env, dtype=np.int64)[:U], U, V)


def plan_walk(env: np.ndarray, env_t: np.ndarray, U: int, V: int):
    """Simulate the reference walk on host; emit the merged step plan.

    Returns dict of int32 numpy arrays (length N): type, a_lo, a_hi
    (axis-0 sweep bounds), b_lo, b_hi (axis-1 bounds). For runs only the
    run axis bounds are meaningful.
    """
    steps = []
    u = v = 0
    prs = pre = pcs = pce = 0
    run_type = None
    run_start = 0
    run_len = 0

    def flush_run():
        nonlocal run_type, run_len
        if run_type == "c0":
            steps.append((C0RUN, run_start, run_start + run_len, 0, 0))
        elif run_type == "c1":
            steps.append((C1RUN, 0, 0, run_start, run_start + run_len))
        run_type = None
        run_len = 0

    while u <= U - 1 and v <= V - 1:
        rs, re = env[u]
        cs, ce = env_t[v]
        in_row = rs <= v < re
        if v < rs:
            if run_type != "c1":
                flush_run()
                run_type, run_start = "c1", v
            run_len += 1
            v += 1
            continue
        rs_e, re_e = (v, re) if in_row else (prs, pre)
        in_col = cs >= 0 and cs <= u < ce
        if cs >= 0 and u < cs:
            if run_type != "c0":
                flush_run()
                run_type, run_start = "c0", u
            prs, pre = rs_e, re_e
            run_len += 1
            u += 1
            continue
        flush_run()
        cs_e, ce_e = (u, ce) if in_col else (pcs, pce)
        steps.append((MAIN, cs_e, ce_e, rs_e, re_e))
        prs, pre, pcs, pce = rs_e, re_e, cs_e, ce_e
        u += 1
        v += 1
    flush_run()

    arr = np.asarray(steps, dtype=np.int32).reshape(-1, 5)
    return dict(
        type=arr[:, 0], a_lo=arr[:, 1], a_hi=arr[:, 2],
        b_lo=arr[:, 3], b_hi=arr[:, 4],
    )


def plan_wst(plan) -> tuple[int, int]:
    """Storage widths (Wst0, Wst1) for a plan: widest sweep window + 2."""
    w0 = np.where(plan["type"] != C1RUN, plan["a_hi"] - plan["a_lo"], 0)
    w1 = np.where(plan["type"] != C0RUN, plan["b_hi"] - plan["b_lo"], 0)
    return (int(max(w0.max(initial=0), 1)) + 2,
            int(max(w1.max(initial=0), 1)) + 2)


# --------------------------------------------------------------------------
# packing: the inputs shared by this version and the CUDA kernel
# --------------------------------------------------------------------------

def components(model_id: int) -> int:
    """State components a candidate keeps per read column: 1 for plain
    CTC, 2 for bonito (gap, no gap) and flip-flop (flip, flop)."""
    return 1 if model_id == 0 else 2


def plane_rows(model_id: int, A: int) -> int:
    """Rows of a packed plane (``_pack_plane``)."""
    return {0: A + 2, 1: A + 1, 2: 2 * A}[model_id]


def _pack_plane(y: np.ndarray, A: int, model_id: int = 0,
                dtype=np.float32) -> np.ndarray:
    """[T, S] log-probs -> [plane_rows, T+1] plane of ``dtype`` (float32,
    or float64 for ``--f64``); column T holds -inf emissions.

    - ctc: rows 0..A-1 emissions, row A gap, row A+1 the root's value at
      t-1 (0 at t=0, the cumulative gap mass through t-1 after);
    - bonito: rows 0..A-1 emissions, row A gap (its root holds a value at
      t = -1 only, which needs no row);
    - flip-flop: rows 0..A-1 flip emissions, rows A..2A-1 flop emissions
      (no gap, and the root as for bonito)."""
    T = len(y)
    R = plane_rows(model_id, A)
    yd = np.asarray(y, dtype=dtype)
    plane = np.full((R, T + 1), _NEG_INF, dtype)
    if model_id == 2:
        plane[:, :T] = yd[:, :2 * A].T
        return plane
    plane[:A + 1, :T] = yd[:, :A + 1].T
    if model_id == 0:
        plane[A + 1, 0] = 0.0
        plane[A + 1, 1:] = np.cumsum(yd[:, A].astype(np.float64)).astype(
            dtype)
    return plane


def pack_pairs(pairs, beam_width: int = 5, alphabet: str = "ACGT",
               plans=None, wst=None, model: str = "ctc", G: int = 0,
               dtype=np.float32):
    """Host-side packing of B (y1, y2, envelope) pairs of one model kind.

    Returns a dict of numpy arrays: ``planes1`` / ``planes2`` (each pair's
    ``_pack_plane`` flattened back to back), ``plan`` int32 [sum N, 5]
    (type, a_lo, a_hi, b_lo, b_hi), ``meta`` int64 [B, META_COLS] (lengths,
    offsets, storage widths, scratch offsets), the kind's ``model_id``,
    and the bookkeeping the traceback needs. Pairs whose plan is empty (an
    empty read) take no part in the batch and decode to "". ``plans`` /
    ``wst`` (lists, one entry per pair) override the plans and storage
    widths, for runs of truncated plans at the full plans' widths. ``G``
    graveyard rows (exact mode) widen each pair's kernel scratch; ``dtype``
    is the planes' (float32, or float64 for the plain version under
    ``--f64``).
    """
    A = len(alphabet)
    W = beam_width
    C = W * (A + 1)
    model_id = _MODEL_IDS[model]
    K = components(model_id)
    if plans is None:
        plans = []
        for y1, y2, envelope in pairs:
            U, V = len(y1), len(y2)
            if U == 0 or V == 0:
                plans.append(None)
                continue
            if envelope is None:
                envelope = np.tile(np.array([0, V], dtype=np.int64), (U, 1))
            env = np.asarray(envelope, dtype=np.int64)[:U]
            plans.append(build_plan(env, U, V))
    live = [i for i, p in enumerate(plans)
            if p is not None and len(p["type"]) > 0]
    meta = np.zeros((len(live), META_COLS), np.int64)
    planes1, planes2, plan_rows, types = [], [], [], []
    o1 = o2 = op = osc = 0
    for r, i in enumerate(live):
        y1, y2, _ = pairs[i]
        p = plans[i]
        w0, w1 = plan_wst(p) if wst is None else wst[i]
        q1 = _pack_plane(y1, A, model_id, dtype)
        q2 = _pack_plane(y2, A, model_id, dtype)
        n = len(p["type"])
        meta[r] = (len(y1), len(y1) + 1, o1, len(y2), len(y2) + 1, o2, op, n,
                   w0, w1, osc, 0)
        planes1.append(q1.reshape(-1))
        planes2.append(q2.reshape(-1))
        plan_rows.append(np.stack(
            [p["type"], p["a_lo"], p["a_hi"], p["b_lo"], p["b_hi"]],
            axis=1).astype(np.int32))
        types.append(np.asarray(p["type"]))
        o1 += q1.size
        o2 += q2.size
        op += n
        osc += (4 * C + 2 * G) * K * (w0 + w1)
    cat = (lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt))
    return dict(
        planes1=cat(planes1, dtype), planes2=cat(planes2, dtype),
        plan=(np.concatenate(plan_rows) if plan_rows
              else np.zeros((0, 5), np.int32)),
        meta=meta, live=live, n_pairs=len(pairs), types=types,
        scratch_floats=osc, W=W, A=A, alphabet=alphabet, model_id=model_id,
        G=G,
    )


def walk_provenance(prov: np.ndarray, types: np.ndarray, j: int, W: int,
                    A: int, alphabet: str) -> str:
    """Walk one search's per-step winner provenance back from slot ``j``
    of its final table (the tail of the JAX engine's _planned_scan).

    prov [N, W] (winner w of MAIN step t came from slot prov[t, w]),
    types [N]."""
    chars = []
    rows = prov.tolist()
    for t in np.flatnonzero(np.asarray(types) == MAIN)[::-1].tolist():
        if j >= W:
            chars.append((j - W) % A)
            j = (j - W) // A
        j = rows[t][j]
    first = (j - W) % A if j >= W else -1
    out = ([first] if first >= 0 else []) + chars[::-1]
    return "".join(alphabet[c] for c in out)


def traceback(prov: np.ndarray, types: np.ndarray, score: np.ndarray,
              valid: np.ndarray, W: int, A: int, alphabet: str) -> str:
    """One pair's consensus: ``walk_provenance`` from the best candidate
    of the final (deduplicated) table, score / valid [C]."""
    j = int(np.argmax(np.where(valid, score, -np.inf)))
    return walk_provenance(prov, types, j, W, A, alphabet)


def tracebacks(packed, prov, score, valid) -> list[str]:
    """Every pair's consensus from engine outputs (numpy)."""
    W, A = packed["W"], packed["A"]
    out = [""] * packed["n_pairs"]
    meta = packed["meta"]
    for r, i in enumerate(packed["live"]):
        o, n = int(meta[r, M_PLAN]), int(meta[r, M_N])
        out[i] = traceback(prov[o:o + n], packed["types"][r], score[r],
                           valid[r], W, A, packed["alphabet"])
    return out


# --------------------------------------------------------------------------
# chunked layered sweep
# --------------------------------------------------------------------------

def _jax_shift(d, Wst):
    """The storage shift the JAX engine applies for an anchor move of d.

    Its re-anchoring slices [Wst+1 pad, storage, Wst+1 pad] with
    ``lax.dynamic_slice``, which first wraps a negative start by the
    padded length and then clamps it: a backward move of more than Wst+1
    columns keeps a stale tail instead of clearing the row. Reproduced
    here (and in the CUDA kernel) so states match the JAX engine's."""
    start = d + Wst + 1
    start = torch.where(start < 0, start + 3 * Wst + 2, start)
    return torch.minimum(start.clamp(min=0), 2 * Wst + 2) - (Wst + 1)


def _rows(x, idx):
    """x[b, idx[b, j]] for x [B, C, ...] and idx [B, n] -> [B, n, ...]."""
    return x.gather(1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))


def _log_half(dtype) -> float:
    """log(1/2) in ``dtype``: a flip-flop root's flip and flop at t = -1."""
    return float(np.log(0.5).astype(
        np.float64 if dtype == torch.float64 else np.float32))


def _chunked_sweep(plane, A, lo, hi, active, n_chunks, k1, k2, pk1, pk2,
                   char, pchar, mask, storage, st_off, psweep, poff, Wst,
                   model_id=0):
    """Sweep the candidates in ``mask`` across window [lo, hi) of one read
    in CHUNK-column pieces, merging the values into ``storage`` (min-shift
    anchored). Pairs not ``active`` keep storage and offset.

    plane [B, R, Lm]; lo/hi/active/st_off/Wst [B]; table fields, mask,
    poff [B, C]; storage/psweep [B, C, K, Wm]; n_chunks is the host-side
    number of chunks of the widest active window.
    Returns (storage, st_off, window max [B, C]): the window maximum of a
    candidate's score, its value (ctc) or the log-add-exp of its two
    components (bonito, flip-flop).
    """
    B, C, K, Wm = storage.shape
    dev, dtype = storage.device, storage.dtype
    Lm = plane.shape[-1]
    R = plane.shape[1]

    # storage anchor: keep if the window fits, else minimal right shift;
    # must cover the seed column lo-1 AND the full window [lo, hi)
    new_off = torch.where(hi > st_off + Wst, hi - Wst, st_off)
    new_off = torch.minimum(new_off, lo - 1)
    new_off = torch.where(hi > new_off + Wst, hi - Wst, new_off)
    new_off = torch.where(active, new_off, st_off)
    storage = _shift_window(storage, 0, _jax_shift(new_off - st_off, Wst)[
        :, None, None], Wm, extra=0, width=Wst[:, None, None])

    is_root = (pk1 == 0) & (pk2 == 0)
    same = char == pchar
    parent_slot = _lookup_idx(pk1, pk2, k1, k2, mask)
    parent_slot = torch.where(is_root, -1, parent_slot)
    parent_swept = parent_slot >= 0
    pslot = parent_slot.clamp(min=0)

    n_ch = torch.where(active, (hi - lo).clamp(min=0) + CHUNK - 1,
                       0) // CHUNK
    # own value at lo-1 from the re-anchored storage (-inf before it)
    seed_pos = torch.minimum(lo - 1 - new_off, Wst - 1)
    seeds = storage.gather(
        3, seed_pos.clamp(0, Wm - 1)[:, None, None, None].expand(
            B, C, K, 1))[..., 0]
    seeds = torch.where((seed_pos >= 0)[:, None, None], seeds, _NEG_INF)

    w_idx = torch.arange(CHUNK, device=dev)
    j_idx = torch.arange(Wm, device=dev)
    char_w = char.clamp(min=0)[:, :, None].expand(B, C, CHUNK)
    window_max = torch.full((B, C), _NEG_INF, dtype=dtype, device=dev)
    for k in range(n_chunks):
        c_lo = lo + k * CHUNK
        t_abs = c_lo[:, None] + w_idx  # [B, CHUNK]
        ch_on = k < n_ch
        in_rng = (t_abs < hi[:, None]) & ch_on[:, None]
        swept = mask & ch_on[:, None]
        in_range = in_rng[:, None, :] & swept[:, :, None]

        cols = plane.gather(
            2, t_abs.clamp(max=Lm - 1)[:, None, :].expand(B, R, CHUNK))
        gap_w = torch.where(in_rng, cols[:, A], 0.0) if model_id < 2 \
            else None
        c_emit = cols[:, :A].gather(1, char_w)
        # parent values at t-1: the root's, or the frozen parent copy
        # (psweep window [poff, poff+Wst), -inf outside)
        fi = t_abs[:, None, :] - 1 - poff[:, :, None]
        pfro = psweep.gather(
            3, fi.clamp(0, Wm - 1)[:, :, None, :].expand(B, C, K, CHUNK))
        pfro = torch.where(((fi >= 0) & (fi < Wst[:, None, None]))[
            :, :, None, :], pfro, _NEG_INF)
        if model_id == 0:
            # the cumulative gap mass at t-1
            root_ext = cols[:, None, None, A + 1]
        else:
            # bonito (gap = 0, no gap = -inf) and flip-flop (log 1/2 each)
            # at t = -1 only
            at0 = t_abs == 0
            r0 = torch.where(at0, 0.0 if model_id == 1 else _log_half(dtype),
                             _NEG_INF).to(dtype)
            r1 = r0 if model_id == 2 else torch.full_like(r0, _NEG_INF)
            root_ext = torch.stack([r0, r1], 1)[:, None]
        parent_ext = torch.where(is_root[:, :, None, None], root_ext, pfro)

        # layers over the parent forest: a candidate sweeps once its
        # parent's chunk values are final (chain depth <= W+1; C+1 bounds
        # the loop even if a hash collision ever formed a cycle). Each
        # layer computes only its ready rows (flattened pair*C+slot).
        done = torch.zeros(B * C, dtype=torch.bool, device=dev)
        cur = torch.full((B * C, K, CHUNK), _NEG_INF, dtype=dtype, device=dev)
        f_swept = swept.reshape(-1)
        f_pswept = parent_swept.reshape(-1)
        f_par = (torch.arange(B, device=dev)[:, None] * C
                 + pslot).reshape(-1)
        f_seeds = seeds.reshape(B * C, K)
        f_ext = parent_ext.reshape(B * C, K, CHUNK)
        f_emit = c_emit.reshape(B * C, CHUNK)
        f_inr = in_range.reshape(B * C, CHUNK)
        if model_id < 2:
            f_gap = gap_w[:, None, :].expand(B, C, CHUNK).reshape(B * C,
                                                                  CHUNK)
        if model_id == 2:
            f_emit2 = cols[:, A:].gather(1, char_w).reshape(B * C, CHUNK)
            f_rs = (is_root[:, :, None] & (t_abs == 0)[:, None, :]).reshape(
                B * C, CHUNK)
        f_same = same.reshape(-1)
        for _ in range(C + 1):
            pending = ~done & f_swept
            ready = pending & torch.where(f_pswept, done[f_par], True)
            rows = ready.nonzero()[:, 0]
            if rows.numel() == 0:
                break
            par = f_par[rows]
            par_shift = torch.cat([f_seeds[par][:, :, None],
                                   cur[par, :, :-1]], 2)
            par_vals = torch.where(f_pswept[rows][:, None, None], par_shift,
                                   f_ext[rows])
            inr = f_inr[rows]
            s_own = f_seeds[rows]
            if model_id == 0:
                E = torch.where(inr, par_vals[:, 0] + f_emit[rows], _NEG_INF)
                out = _cumlse_chain(E, f_gap[rows], s_own[:, 0])[:, None]
            else:
                p0, p1 = par_vals[:, 0], par_vals[:, 1]
                p_tot = torch.logaddexp(p0, p1)
                sm = f_same[rows][:, None]
                ce = torch.where(inr, f_emit[rows], 0.0)
                if model_id == 1:
                    # no gap: entered from the parent (its no-gap part on
                    # a repeat), stays weighted by the emission; the total
                    # chains on it with the gap as stay weight
                    src = torch.where(sm, p0, p_tot)
                    ong = _cumlse_chain(torch.where(inr, src + ce, _NEG_INF),
                                        ce, s_own[:, 1])
                    seed_tot = torch.logaddexp(s_own[:, 0], s_own[:, 1])
                    gap = f_gap[rows]
                    tot = _cumlse_chain(torch.where(inr, ong, _NEG_INF), gap,
                                        seed_tot)
                    tot_prev = torch.cat([seed_tot[:, None], tot[:, :-1]], 1)
                    o0 = torch.where(inr, tot_prev + gap, _NEG_INF)
                    o1 = ong
                else:
                    # flip from the parent's flop part on a repeat (else
                    # its total), flop from its flip part on a repeat; a
                    # root child may start on a flop at t = 0
                    cf = torch.where(inr, f_emit2[rows], 0.0)
                    ef = torch.where(sm, p1, p_tot) + ce
                    eo = torch.where(sm, p0 + cf, _NEG_INF)
                    eo = torch.where(f_rs[rows], cf, eo)
                    o0 = _cumlse_chain(torch.where(inr, ef, _NEG_INF), ce,
                                       s_own[:, 0])
                    o1 = _cumlse_chain(torch.where(inr, eo, _NEG_INF), cf,
                                       s_own[:, 1])
                out = torch.stack([o0, o1], 1)
            cur[rows] = torch.where(inr[:, None], out, _NEG_INF)
            done[rows] = True
        cur = cur.view(B, C, K, CHUNK)

        # merge the chunk into storage (swept candidates, in-range columns)
        wpos = j_idx[None, :] - (c_lo - new_off)[:, None]  # [B, Wm]
        wcl = wpos.clamp(0, CHUNK - 1)
        take = ((wpos >= 0) & (wpos < CHUNK) & in_rng.gather(1, wcl)
                & (j_idx[None, :] < Wst[:, None]))
        vals = cur.gather(3, wcl[:, None, None, :].expand(B, C, K, Wm))
        storage = torch.where(take[:, None, None, :]
                              & swept[:, :, None, None], vals, storage)
        # the window's columns are exactly the merged ones, so its max
        # over storage is the max over the chunks' in-range values
        tot = cur[:, :, 0] if K == 1 else torch.logaddexp(cur[:, :, 0],
                                                          cur[:, :, 1])
        window_max = torch.maximum(
            window_max, torch.where(in_range, tot, _NEG_INF).amax(dim=2))
        # next chunk seeds: value at (chunk end - 1)
        seeds = torch.where(swept[:, :, None], cur[..., -1], seeds)
    return storage, new_off, window_max


# --------------------------------------------------------------------------
# plan-driven scan
# --------------------------------------------------------------------------

def _unpack_planes(flat: torch.Tensor, meta_h: np.ndarray, col_l: int,
                   col_o: int, R: int) -> torch.Tensor:
    """Flat per-pair [R, L] planes -> [B, R, Lmax] padded with -inf."""
    B = len(meta_h)
    Lm = int(meta_h[:, col_l].max())
    out = torch.full((B, R, Lm), _NEG_INF, dtype=flat.dtype,
                     device=flat.device)
    for b in range(B):
        L, o = int(meta_h[b, col_l]), int(meta_h[b, col_o])
        out[b, :, :L] = flat[o:o + R * L].view(R, L)
    return out


def _gy_select(tab, keep, new, gy, grace: int, G: int):
    """The graveyard after a MAIN step (the JAX engine's ``_gy_select``):
    the pool is the old table's rows that are not in the new table (first
    occurrences of a key only), then the old graveyard's rows aged one more
    step, in slot order; the G youngest stay, ranked by (age, pool index)
    with a stable sort, and a row of age ``grace`` or more is evicted.
    Returns the new graveyard's keys, ages and validity, per new slot its
    pool index and whether it holds a row, and per pair the rows turned
    away because the graveyard was full."""
    def in_new(k1, k2):
        return _lookup_idx(k1, k2, new["k1"], new["k2"], new["valid"]) >= 0

    cand_elig = keep & ~in_new(tab["k1"], tab["k2"])
    if grace <= 1:
        cand_elig = torch.zeros_like(cand_elig)
    age = gy["gage"] + 1
    gy_elig = gy["gvalid"] & ~in_new(gy["gk1"], gy["gk2"]) & (age < grace)
    page = torch.cat([torch.ones_like(tab["k1"]), age], 1)
    skey = torch.where(torch.cat([cand_elig, gy_elig], 1), page, 1 << 30)
    sel = torch.sort(skey, dim=1, stable=True).indices[:, :G]
    ok = skey.gather(1, sel) < (1 << 30)
    pk1 = torch.cat([tab["k1"], gy["gk1"]], 1).gather(1, sel)
    pk2 = torch.cat([tab["k2"], gy["gk2"]], 1).gather(1, sel)
    out = dict(gk1=torch.where(ok, pk1, 0), gk2=torch.where(ok, pk2, 0),
               gage=torch.where(ok, page.gather(1, sel), 0), gvalid=ok)
    full = ((skey < (1 << 30)).sum(1) - G).clamp(min=0)
    return out, sel, ok, full


def _initial_state(P, meta_h, W: int, A: int, model_id: int, G: int):
    """The search state before the first plan step: the A root children in
    the child slots of beam row 0, their storage at t = 0, an empty
    graveyard, and no provenance yet."""
    dev, dtype = P[0].device, P[0].dtype
    B = len(meta_h)
    C = W * (A + 1)
    K = components(model_id)
    Wm = [int(meta_h[:, M_WST0].max()), int(meta_h[:, M_WST1].max())]
    init = _init_candidates(0, P[0][0, :A + 1, 0], W, A)
    state = {k: init[k][None].expand(B, C).clone()
             for k in ("k1", "k2", "pk1", "pk2", "char", "pchar", "valid")}
    state["score"] = torch.where(state["valid"], 0.0, _NEG_INF).to(dtype)
    for axis in range(2):
        st = torch.full((B, C, K, Wm[axis]), _NEG_INF, dtype=dtype,
                        device=dev)
        # the root children's state at t = 0: ctc (y0[c]), bonito (-inf,
        # y0[c]), flip-flop (y0[c], y0[c+A])
        y0 = P[axis][:, :, 0]
        if model_id == 0:
            st[:, W:W + A, 0, 0] = y0[:, :A]
        elif model_id == 1:
            st[:, W:W + A, 1, 0] = y0[:, :A]
        else:
            st[:, W:W + A, 0, 0] = y0[:, :A]
            st[:, W:W + A, 1, 0] = y0[:, A:2 * A]
        state[f"sweep{axis}"] = st
        state[f"psweep{axis}"] = torch.full_like(st, _NEG_INF)
        state[f"poff{axis}"] = torch.zeros(B, C, dtype=torch.int64,
                                           device=dev)
        state[f"off{axis}"] = torch.zeros(B, dtype=torch.int64, device=dev)
        if G:
            state[f"gsweep{axis}"] = torch.full(
                (B, G, K, Wm[axis]), _NEG_INF, dtype=dtype, device=dev)
    if G:
        zeros = torch.zeros(B, G, dtype=torch.int64, device=dev)
        state.update(gk1=zeros, gk2=zeros.clone(), gage=zeros.clone(),
                     gvalid=torch.zeros(B, G, dtype=torch.bool, device=dev))
        # counts per pair that show which cases a run exercised: rows
        # turned away by a full graveyard, children that resumed a
        # graveyard row, and those of them whose row had moved back with
        # a backward re-anchor while buried (``gback`` per row)
        state.update({k: torch.zeros(B, dtype=torch.int64, device=dev)
                      for k in GY_COUNTS},
                     gback=torch.zeros(B, G, dtype=torch.bool, device=dev))
    state["prov"] = torch.zeros(B, int(meta_h[:, M_N].max()), W,
                                dtype=torch.int8, device=dev)
    return state


GY_COUNTS = ("gfull", "gresume", "gresume_back")


def planned_scan(planes1, planes2, plan, meta, W: int, A: int,
                 return_state: bool = False, model_id: int = 0, G: int = 0,
                 grace: int = 1, state=None, steps=None):
    """The plain version of the pair-beam kernel.

    Inputs as packed by ``pack_pairs`` (torch tensors on one device):
    planes1/planes2 float32 (or float64) flat, plan int32 [sum N, 5], meta
    int64 [B, META_COLS]; ``model_id`` the batch's kind (0 ctc, 1 bonito,
    2 flip-flop); ``G`` graveyard rows (0: windowed memo; exact mode:
    EXACT_G, with eviction at ``grace`` MAIN steps). Returns (prov int8
    [sum N, W] winner provenance of MAIN steps (0 on run steps), score
    [B, C] and valid bool [B, C] of the final deduplicated table). With
    ``return_state`` returns the search state instead (dict of tensors,
    [B, ...]: the table, storage [B, C, K, Wst], the graveyard, ``prov``
    [B, N, W]; with G the counts GY_COUNTS, kept only then). ``state``
    (such a dict)
    resumes a search and ``steps`` = (i0, i1) runs only plan steps
    i0 <= i < i1.
    """
    dev = planes1.device
    meta_h = meta.cpu().numpy()
    B = len(meta_h)
    C = W * (A + 1)
    R = plane_rows(model_id, A)
    P = [_unpack_planes(planes1, meta_h, M_L1, M_Y1, R),
         _unpack_planes(planes2, meta_h, M_L2, M_Y2, R)]
    Wst = [torch.as_tensor(meta_h[:, M_WST0], device=dev),
           torch.as_tensor(meta_h[:, M_WST1], device=dev)]
    Wm = [int(meta_h[:, M_WST0].max()), int(meta_h[:, M_WST1].max())]

    # per-pair plans, padded with inactive steps (type -1)
    Ns = meta_h[:, M_N]
    Nm = int(Ns.max())
    plan_h = np.zeros((B, Nm, 5), np.int64)
    plan_h[:, :, 0] = -1
    plan_all = plan.cpu().numpy()
    for b in range(B):
        o, n = int(meta_h[b, M_PLAN]), int(Ns[b])
        plan_h[b, :n] = plan_all[o:o + n]
    ty_h = plan_h[:, :, 0]
    nch_h = []
    for axis, (lo_c, hi_c, run) in enumerate(((1, 2, C0RUN),
                                              (3, 4, C1RUN))):
        act = (ty_h == MAIN) | (ty_h == run)
        width = np.clip(plan_h[:, :, hi_c] - plan_h[:, :, lo_c], 0, None)
        nch_h.append(np.where(act, (width + CHUNK - 1) // CHUNK, 0).max(0))
    plan_d = torch.as_tensor(plan_h, device=dev)

    if state is None:
        state = _initial_state(P, meta_h, W, A, model_id, G)
    fields = ("k1", "k2", "pk1", "pk2", "char", "pchar", "valid")
    gfields = ("gk1", "gk2", "gage", "gvalid")
    tab = {k: state[k] for k in fields + ("score",)}
    S = [state["sweep0"], state["sweep1"]]
    PS = [state["psweep0"], state["psweep1"]]
    poff = [state["poff0"], state["poff1"]]
    off = [state["off0"], state["off1"]]
    prov = state["prov"].clone()
    if G:
        gy = {k: state[k] for k in gfields}
        GS = [state["gsweep0"], state["gsweep1"]]
    count = bool(G) and return_state
    if count:
        cnt = {k: state[k] for k in GY_COUNTS}
        gback = state["gback"]

    i0, i1 = (0, Nm) if steps is None else (steps[0], min(steps[1], Nm))
    cchar = torch.arange(A, device=dev).repeat(W)[None].expand(B, W * A)
    for i in range(i0, i1):
        ty = plan_d[:, i, 0]
        is_main = ty == MAIN
        mi = is_main[:, None]
        # prune: top-W of the deduplicated scores (ties: lowest slot)
        keep = _dedup_mask(tab["k1"], tab["k2"], tab["valid"])
        sc = torch.where(keep, tab["score"], _NEG_INF)
        beam_src = torch.sort(sc, dim=1, descending=True,
                              stable=True).indices[:, :W]
        b = {k: tab[k].gather(1, beam_src) for k in fields}
        bvalid = keep.gather(1, beam_src)
        # expand: the W winners and their W*A children
        cp1 = b["k1"].repeat_interleave(A, dim=1)
        cp2 = b["k2"].repeat_interleave(A, dim=1)
        ck1, ck2 = _child_keys(cp1, cp2, cchar)
        new = dict(
            k1=torch.cat([b["k1"], ck1], 1), k2=torch.cat([b["k2"], ck2], 1),
            pk1=torch.cat([b["pk1"], cp1], 1),
            pk2=torch.cat([b["pk2"], cp2], 1),
            char=torch.cat([b["char"], cchar], 1),
            pchar=torch.cat([b["pchar"],
                             b["char"].repeat_interleave(A, dim=1)], 1),
            valid=torch.cat([bvalid, bvalid.repeat_interleave(A, dim=1)], 1),
        )
        use = {k: torch.where(mi, new[k], tab[k]) for k in fields}
        # catch-up runs sweep the current beam only
        key_match = ((tab["k1"][:, :, None] == b["k1"][:, None, :])
                     & (tab["k2"][:, :, None] == b["k2"][:, None, :])
                     & bvalid[:, None, :])
        sel = tab["valid"] & key_match.any(dim=2)
        # a re-discovered child resumes its old storage: from the table,
        # else (exact mode) from the graveyard (slot C + g)
        if G:
            child_idx = _lookup_idx(
                ck1, ck2, torch.cat([tab["k1"], gy["gk1"]], 1),
                torch.cat([tab["k2"], gy["gk2"]], 1),
                torch.cat([tab["valid"], gy["gvalid"]], 1))
            new_gy, gsel, gok, full = _gy_select(tab, keep, new, gy, grace,
                                                 G)
            if count:
                resumed = mi & (child_idx >= C)
                back = gback.gather(1, (child_idx - C).clamp(0, G - 1))
                cnt["gfull"] = cnt["gfull"] + torch.where(is_main, full, 0)
                cnt["gresume"] = cnt["gresume"] + resumed.sum(1)
                cnt["gresume_back"] = cnt["gresume_back"] + (resumed
                                                             & back).sum(1)
                gback = torch.where(mi, gok & torch.cat(
                    [torch.zeros_like(tab["valid"]), gback], 1).gather(
                        1, gsel), gback)
        else:
            child_idx = _lookup_idx(ck1, ck2, tab["k1"], tab["k2"],
                                    tab["valid"])
        refresh_idx = _lookup_idx(use["pk1"], use["pk2"], use["k1"],
                                  use["k2"], use["valid"])

        maxes = []
        mi4 = mi[:, :, None, None]
        for axis in range(2):
            run = C0RUN if axis == 0 else C1RUN
            active = is_main | (ty == run)
            mask = torch.where(mi, use["valid"],
                               (ty == run)[:, None] & sel)
            st_old, ps_old = S[axis], PS[axis]
            # MAIN: stale storage of winners and re-discovered children,
            # frozen parent copies for the children
            bsweep = _rows(st_old, beam_src)
            pool = torch.cat([st_old, GS[axis]], 1) if G else st_old
            cst = _rows(pool, child_idx.clamp(min=0))
            cst = torch.where((child_idx >= 0)[:, :, None, None], cst,
                              _NEG_INF)
            stale = torch.where(mi4, torch.cat([bsweep, cst], 1), st_old)
            psw = torch.where(
                mi4,
                torch.cat([_rows(ps_old, beam_src),
                           bsweep.repeat_interleave(A, dim=1)], 1),
                ps_old)
            pof = torch.where(
                mi,
                torch.cat([poff[axis].gather(1, beam_src),
                           off[axis][:, None].expand(B, W * A)], 1),
                poff[axis])
            lo = plan_d[:, i, 1 + 2 * axis]
            hi = plan_d[:, i, 2 + 2 * axis]
            st, new_off, mx = _chunked_sweep(
                P[axis], A, lo, hi, active, int(nch_h[axis][i]),
                use["k1"], use["k2"], use["pk1"], use["pk2"], use["char"],
                use["pchar"], mask, stale, off[axis], psw, pof, Wst[axis],
                model_id)
            if G:
                # the graveyard's rows (the new ones on MAIN) move with the
                # window as the table's do, unswept
                gst = torch.where(gok[:, :, None, None], _rows(pool, gsel),
                                  _NEG_INF)
                gst = torch.where(mi4, gst, GS[axis])
                GS[axis] = _shift_window(
                    gst, 0, _jax_shift(new_off - off[axis], Wst[axis])[
                        :, None, None], Wm[axis], extra=0,
                    width=Wst[axis][:, None, None])
                if count:
                    gback = gback | (new_off < off[axis])[:, None]
            # frozen parent copies := parent's current storage where the
            # parent is in the table (last-known-values semantics)
            present = (refresh_idx >= 0) & active[:, None]
            psw = torch.where(present[:, :, None, None],
                              _rows(st, refresh_idx.clamp(min=0)), psw)
            pof = torch.where(present, new_off[:, None], pof)
            S[axis], PS[axis], poff[axis], off[axis] = st, psw, pof, new_off
            maxes.append(mx)
        score = torch.where(use["valid"], maxes[0] + maxes[1], _NEG_INF)
        tab = dict(use, score=torch.where(mi, score, tab["score"]))
        if G:
            gy = {k: torch.where(mi, new_gy[k], gy[k]) for k in gfields}
        prov[:, i] = torch.where(mi, beam_src, 0).to(torch.int8)

    state = dict(tab, sweep0=S[0], psweep0=PS[0], poff0=poff[0],
                 off0=off[0], sweep1=S[1], psweep1=PS[1], poff1=poff[1],
                 off1=off[1], prov=prov)
    if G:
        state.update(gy, gsweep0=GS[0], gsweep1=GS[1])
    if count:
        state.update(cnt, gback=gback)
    if return_state:
        return state
    return scan_outputs(state, meta_h, W)


def scan_outputs(state, meta_h, W: int):
    """(prov int8 [sum N, W], score [B, C], valid bool [B, C]) of a search
    state: the provenance of each pair's own plan steps, back to back, and
    the final table deduplicated."""
    keep = _dedup_mask(state["k1"], state["k2"], state["valid"])
    score = torch.where(keep, state["score"], _NEG_INF)
    prov = state["prov"]
    Ns = np.asarray(meta_h)[:, M_N]
    flat = torch.cat([prov[b, :int(Ns[b])] for b in range(len(Ns))]) \
        if len(Ns) else torch.zeros(0, W, dtype=torch.int8,
                                    device=prov.device)
    return flat, score, keep


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def _check_model(model: str) -> None:
    if model not in _MODEL_IDS:
        raise ValueError(f"unknown model {model!r}")


def graveyard(exact: bool) -> tuple[int, int]:
    """(G, grace) of a mode: (EXACT_G, EXACT_GRACE) for exact, (0, 1) for
    the windowed memo."""
    return (EXACT_G, EXACT_GRACE) if exact else (0, 1)


def _to_device(packed, device):
    from ..device import resolve_device

    dev = resolve_device(device)
    return (torch.as_tensor(packed["planes1"], device=dev),
            torch.as_tensor(packed["planes2"], device=dev),
            torch.as_tensor(packed["plan"], device=dev),
            torch.as_tensor(packed["meta"], device=dev))


def beam_search_2d_planned_batch(pairs, beam_width=5, alphabet="ACGT",
                                 model="ctc", exact: bool = False,
                                 device=None, dtype=np.float32) -> list[str]:
    """Batched plan-driven row_col pair beam search, plain PyTorch.

    pairs: list of (y1, y2, envelope) of the kind ``model``. Runs on
    ``device`` (default ``cuda``) in ``dtype`` (float32, or float64 as
    under ``--f64``); ``exact`` keeps the graveyard. This is the kernel's
    plain version, not the main path."""
    _check_model(model)
    G, grace = graveyard(exact)
    packed = pack_pairs(pairs, beam_width, alphabet, model=model, G=G,
                        dtype=dtype)
    if not packed["live"]:
        return [""] * len(pairs)
    prov, score, valid = planned_scan(*_to_device(packed, device),
                                      beam_width, len(alphabet),
                                      model_id=packed["model_id"], G=G,
                                      grace=grace)
    return tracebacks(packed, prov.cpu().numpy(), score.cpu().numpy(),
                      valid.cpu().numpy())


def beam_search_2d_planned(y1, y2, envelope, beam_width=5, alphabet="ACGT",
                           model="ctc", exact: bool = False,
                           device=None, dtype=np.float32) -> str:
    """Plan-driven row_col pair beam search for one pair, plain PyTorch."""
    return beam_search_2d_planned_batch(
        [(y1, y2, envelope)], beam_width, alphabet, model, exact, device,
        dtype)[0]


def beam_search_2d_planned_batch_seg(pairs, beam_width=5, alphabet="ACGT",
                                     model="ctc", exact: bool = True,
                                     seg: int = 4096, device=None,
                                     dtype=np.float32) -> list[str]:
    """The batched search in runs of ``seg`` plan steps, the search state
    (table, storage and graveyard) carried from one run to the next; the
    outputs equal ``beam_search_2d_planned_batch``'s (the JAX engine's
    segmented entry, whose segments bound the length of one launch)."""
    _check_model(model)
    G, grace = graveyard(exact)
    packed = pack_pairs(pairs, beam_width, alphabet, model=model, G=G,
                        dtype=dtype)
    if not packed["live"]:
        return [""] * len(pairs)
    tensors = _to_device(packed, device)
    state = None
    for s0 in range(0, int(packed["meta"][:, M_N].max()), seg):
        state = planned_scan(*tensors, beam_width, len(alphabet),
                             return_state=True, model_id=packed["model_id"],
                             G=G, grace=grace, state=state,
                             steps=(s0, s0 + seg))
    prov, score, valid = scan_outputs(state, packed["meta"], beam_width)
    return tracebacks(packed, prov.cpu().numpy(), score.cpu().numpy(),
                      valid.cpu().numpy())


def debug_state_after(y1, y2, envelope, n_steps=None, beam_width=5,
                      alphabet="ACGT", model="ctc", device=None, G=0,
                      grace=1):
    """Run the planned scan truncated to the first n_steps plan steps and
    return the final candidate table (numpy dict) — differential-test hook.

    As in the JAX engine, the storage widths come from the full plan and
    the truncated plan is padded back to full length with zero-width C0RUN
    steps, so the table matches ``poreover_tpu``'s ``debug_state_after``
    (with ``G`` graveyard rows and ``grace``: its ``_planned_scan(...,
    return_state=True)``) key for key. Sweep storage is [C, Wst] for plain
    CTC (the JAX table's first state component) and [C, 2, Wst] for bonito
    and flip-flop, as in the JAX table (``state_from_jax`` maps a JAX
    table to this layout); the graveyard's likewise [G, ...]."""
    _check_model(model)
    y1 = np.asarray(y1)
    y2 = np.asarray(y2)
    U, V = len(y1), len(y2)
    env = np.asarray(envelope, dtype=np.int64)[:U]
    plan = build_plan(env, U, V)
    wst = plan_wst(plan)
    if n_steps is not None:
        N_full = len(plan["type"])
        plan = {k: v[:n_steps] for k, v in plan.items()}
        npad = N_full - len(plan["type"])
        fills = dict(type=C0RUN, a_lo=0, a_hi=0, b_lo=0, b_hi=0)
        plan = {
            k: np.concatenate([v, np.full(npad, fills[k], v.dtype)])
            for k, v in plan.items()
        }
    packed = pack_pairs([(y1, y2, env)], beam_width, alphabet, plans=[plan],
                        wst=[wst], model=model, G=G)
    state = planned_scan(*_to_device(packed, device), beam_width,
                         len(alphabet), return_state=True,
                         model_id=packed["model_id"], G=G, grace=grace)
    state.pop("prov")
    out = {k: v[0].cpu().numpy() for k, v in state.items()}
    if packed["model_id"] == 0:
        for k in _SWEEPS:
            if k in out:
                out[k] = out[k][:, 0]
    return out


_SWEEPS = ("sweep0", "sweep1", "psweep0", "psweep1", "gsweep0", "gsweep1")


def state_from_jax(d, model: str = "ctc") -> dict[str, torch.Tensor]:
    """Map a ``poreover_tpu`` candidate table (numpy dict from its
    ``debug_state_after`` or ``_planned_scan(..., return_state=True)``)
    into this engine's layout: uint32 keys and int32 ages as int64; for
    plain CTC sweep storage [C, 2, Wst] -> [C, Wst], graveyard storage
    likewise (the second state component is -inf there, which is
    checked)."""
    out = {}
    for k, v in d.items():
        v = np.array(v)
        if model == "ctc" and k in _SWEEPS:
            if not np.all(np.isneginf(v[:, 1])):
                raise ValueError(f"{k}: second state component is not -inf")
            v = v[:, 0]
        if v.dtype in (np.uint32, np.int32):
            v = v.astype(np.int64)
        out[k] = torch.as_tensor(v)
    return out
