"""1D CTC beam search over a batch of reads: the wrapper of the CUDA kernel
``csrc/beam1d.cu``, and the kernel's plain PyTorch version.

Replaces ``poreover_tpu/ops/pallas_beam1d.py`` (the Pallas TPU kernel
``_build_kernel`` launched by ``_run_kernel``, and ``_traceback_device``),
with the same host API: ``prepare_beam1d`` / ``launch_beam1d`` /
``fetch_beam1d`` / ``beam1d_batch``. All three model kinds (ctc,
ctc_merge_repeats, ctc_flipflop) with C = W*(A+1) <= 128 candidate slots.
B reads decode in one launch, one CTA per read, each over its own length.

For tensors on a CUDA device the wrapper launches the kernel, and raises
if it does not build or launch; there is no fallback. For tensors on the
CPU it runs ``beam1d_plain``, which takes the same inputs and returns the
same outputs and repeats the kernel's algorithm step for step: the
selection (first valid slot of each key, ranked by score with equal
scores to the lowest slot, the first W win: what the TPU kernel's W rounds
of masked max + lowest lane + key-dedup sweep pick), masked-max hash-join
lookups, the per-kind node update, W source slots of provenance per step,
and the provenance walk. ``launch_count`` counts kernel launches (not
plain runs).

Inputs (``planes_from_numpy``): reads back to back as ``y`` float32
[sum T, S]; for ctc ``root`` float32 [sum T], the root's value at t-1 (the
cumulative blank through t-1, accumulated in float64 and rounded once);
``meta`` int64 [B, 2] = (first row, T). Outputs: ``prov`` uint8 [sum T, W]
(source slot + 1 of each winner, 0 = none), ``chars`` int8 [sum T] (the
char decoded at each step, -1 for none), and the final table ``st0`` /
``st1`` float32 [B, C], ``val`` bool [B, C]. log(0) is -inf throughout.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..build import build_kernel
from ..device import resolve_device
from .beam import (
    _M1, _M2, _MASK32, _MODEL_IDS, _NEG_INF, _dedup_mask, _mul32,
)

launch_count = 0

CMAX = 128  # candidate slots = threads of a CTA
WMAX = 32   # winners fit one warp
SMAX = 8    # widest emission row the kernel stages

PHASE_CLOCKS = "POREOVER_PHASE_CLOCKS"  # macro of the instrumented build
# the instrumented build's phase sums (csrc/beam1d.cu: CK_*), in order; then
# the count of steps (CLOCK_PARTS: one part, as ops/viterbi.py lays them out)
CLOCK_PHASES = ("refill", "dedup", "rank", "publish", "gather", "join",
                "update", "link", "barrier")
CLOCK_PARTS = (("step", CLOCK_PHASES, "step"),)
CLOCK_SLOTS = len(CLOCK_PHASES) + 1

_libs = {}


def load_kernel(phase_clocks: bool = False):
    """Build (once) and load the kernel library; returns the ctypes lib.
    With ``phase_clocks`` the instrumented build (a library of its own,
    with ``phase_clocks_read``)."""
    if phase_clocks in _libs:
        return _libs[phase_clocks]
    lib = ctypes.CDLL(str(build_kernel(
        "beam1d", (PHASE_CLOCKS,) if phase_clocks else ())))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.beam1d_launch.restype = i
    lib.beam1d_launch.argtypes = [vp, vp, vp, i, i, i, i, i, vp, vp, vp, vp,
                                  vp, vp]
    lib.beam1d_hash_bits.restype = i
    lib.beam1d_hash_bits.argtypes = [i, i]
    if phase_clocks:
        lib.phase_clocks_read.restype = i
        lib.phase_clocks_read.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong), i, i]
    _libs[phase_clocks] = lib
    return lib


def planes_from_numpy(ys, model: str = "ctc", A: int = 4):
    """Pack reads (a list of [T_i, S] log-prob arrays, as handed to
    ``beam_search_batch``) into the flat arrays the kernel and its plain
    version read: dict(y, root, meta), numpy."""
    model_id = _MODEL_IDS[model]
    S = 2 * A if model_id == 2 else A + 1
    ys = [np.asarray(y, dtype=np.float32) for y in ys]
    for y in ys:
        if y.ndim != 2 or y.shape[1] != S or y.shape[0] < 1:
            raise ValueError(f"read of shape {y.shape}: expected [T >= 1, "
                             f"{S}] for model {model!r}")
    lens = np.array([len(y) for y in ys], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    flat = (np.concatenate(ys) if ys else np.zeros((0, S), np.float32))
    if model_id == 0:
        # root's value at t = cumulative blank through t-1
        root = np.zeros(len(flat), np.float32)
        for o, y in zip(offs, ys):
            root[o + 1:o + len(y)] = np.cumsum(
                y[:-1, -1].astype(np.float64)).astype(np.float32)
    else:
        root = np.zeros(0, np.float32)
    return dict(y=np.ascontiguousarray(flat), root=root,
                meta=np.stack([offs, lens], 1).reshape(-1, 2))


def _check(name, t, dtype, dim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: {t.dim()} dims, expected {dim}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_inputs(y, root, meta, meta_h, W: int, A: int, model_id: int):
    """Shape, type and size checks shared by the kernel's wrapper and the
    plain version; returns (B, S, total rows)."""
    dev = y.device
    _check("y", y, torch.float32, 2, dev)
    _check("root", root, torch.float32, 1, dev)
    _check("meta", meta, torch.int64, 2, dev)
    if model_id not in (0, 1, 2):
        raise ValueError(f"model id {model_id}")
    S = 2 * A if model_id == 2 else A + 1
    if (W < 1 or W > WMAX or A < 1 or W * (A + 1) > CMAX or S > SMAX):
        raise ValueError(f"kernel supports W <= {WMAX}, W*(A+1) <= {CMAX} "
                         f"and rows of <= {SMAX}; got W={W}, A={A}")
    meta_h = np.asarray(meta_h)
    if meta.shape[1] != 2 or meta_h.shape != tuple(meta.shape):
        raise ValueError(f"meta {tuple(meta.shape)} / host copy "
                         f"{meta_h.shape}: bad shape")
    B = meta.shape[0]
    n = int(meta_h[:, 1].sum()) if B else 0
    if B and (meta_h[:, 1].min() < 1 or not np.array_equal(
            meta_h[:, 0], np.concatenate([[0], np.cumsum(meta_h[:-1, 1])]))):
        raise ValueError("meta: reads must be non-empty and back to back")
    if y.shape != (n, S):
        raise ValueError(f"y {tuple(y.shape)}, expected {(n, S)}")
    if root.shape[0] != (n if model_id == 0 else 0):
        raise ValueError(f"root has {root.shape[0]} rows")
    return B, S, n


def beam1d_cuda(y, root, meta, meta_h, W: int, A: int, model_id: int):
    """Launch the kernel on the current stream; returns (prov, chars, st0,
    st1, val) without synchronising. ``meta_h`` is the host copy of
    ``meta``."""
    global launch_count
    B, S, n = _check_inputs(y, root, meta, meta_h, W, A, model_id)
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"beam1d_cuda: tensors on {dev}, expected cuda")
    C = W * (A + 1)
    lib = load_kernel()
    prov = torch.empty(n, W, dtype=torch.uint8, device=dev)
    chars = torch.empty(n, dtype=torch.int8, device=dev)
    st0 = torch.empty(B, C, dtype=torch.float32, device=dev)
    st1 = torch.empty(B, C, dtype=torch.float32, device=dev)
    val = torch.empty(B, C, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.beam1d_launch(
            y.data_ptr(), root.data_ptr(), meta.data_ptr(), B, W, A, S,
            model_id, prov.data_ptr(), chars.data_ptr(), st0.data_ptr(),
            st1.data_ptr(), val.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"beam1d kernel launch failed: CUDA error {err}")
    launch_count += 1
    return prov, chars, st0, st1, val


def hash_bits(B: int, model_id: int, device=None) -> int:
    """log2 of the hash buckets per table that a launch of B reads of this
    model kind takes on ``device`` (the kernel picks it from B and what
    the card can keep resident: the most buckets with which the wave runs
    in the fewest rounds of CTAs)."""
    lib = load_kernel()
    with torch.cuda.device(resolve_device(device)):
        bits = lib.beam1d_hash_bits(B, model_id)
    if bits < 0:
        raise RuntimeError(f"beam1d_hash_bits failed: CUDA error {-bits}")
    return bits


def _select(sc, k1, k2, val, W: int):
    """The kernel's winner selection on [B, C] tables: keep the first valid
    slot of each key, order the kept slots by score (equal scores by
    lowest slot), take the first W. Returns [B, W] source slots, -1 where
    fewer were left.

    This picks what W rounds of "best remaining slot, then drop every slot
    with its keys" pick (the TPU kernel's form), because duplicate keys
    carry identical states and so identical scores. As in the kernel, a
    score enters as an order-preserving integer code (larger float, larger
    code; -0 as +0) above the slot number in one integer, so that one
    sort decides both."""
    C = sc.shape[1]
    bits = (sc + 0.0).view(torch.int32).to(torch.int64)
    u = bits & _MASK32
    code = torch.where(bits < 0, ~u & _MASK32, u | 0x80000000)
    slot = torch.arange(C, device=sc.device)
    first = _dedup_mask(k1, k2, val)
    rank_key = torch.where(first, code * CMAX + (CMAX - 1 - slot), 0)
    top = torch.sort(rank_key, dim=1, descending=True)
    return torch.where(top.values[:, :W] != 0, top.indices[:, :W], -1)


def beam1d_plain(y, root, meta, meta_h, W: int, A: int, model_id: int):
    """The kernel's plain PyTorch version: the same inputs, the same
    outputs, on the tensors' device. Reads advance in lockstep over a
    padded [B, max T] view; steps beyond a read's length leave its table
    untouched, which the kernel gets by giving each read its own loop."""
    B, S, n = _check_inputs(y, root, meta, meta_h, W, A, model_id)
    dev = y.device
    C = W * (A + 1)
    meta_h = np.asarray(meta_h)
    offs_h, lens_h = meta_h[:, 0], meta_h[:, 1]
    T = int(lens_h.max()) if B else 0
    lens = torch.as_tensor(lens_h, device=dev)
    offs = torch.as_tensor(offs_h, device=dev)
    tt = torch.arange(T, device=dev)
    inside = tt[None, :] < lens[:, None]                    # [B, T]
    rows = (offs[:, None] + tt[None, :]).clamp(max=max(n - 1, 0))
    yb = y[rows]                                            # [B, T, S]
    rb = root[rows] if model_id == 0 else None

    # ---- initial table (t = 0): the A root children in slots W..W+A-1
    slot = torch.arange(C, device=dev)
    child0 = (slot >= W) & (slot < W + A)
    c0 = (slot - W).clamp(0, A - 1)
    y0 = yb[:, 0] if B else y.new_zeros(0, S)
    e0 = torch.where(child0[None, :], y0[:, c0], _NEG_INF)
    ninf = torch.full((B, C), _NEG_INF, dtype=y.dtype, device=dev)
    if model_id == 0:
        st0, st1 = e0, ninf
    elif model_id == 1:
        st0, st1 = ninf, e0
    else:
        st0 = e0
        st1 = torch.where(child0[None, :], y0[:, c0 + A], _NEG_INF)
    sc = st0 if model_id == 0 else torch.logaddexp(st0, st1)
    k1 = torch.where(child0, slot - W + 1, 0)[None, :].repeat(B, 1)
    k2 = k1.clone()
    pk1 = torch.zeros_like(k1)
    pk2 = torch.zeros_like(k1)
    chr_ = torch.where(child0, slot - W, -1)[None, :].repeat(B, 1)
    pch = torch.full_like(chr_, -1)
    val = child0[None, :].repeat(B, 1)

    # which winner each new slot descends from, and the char it appends
    stay = slot < W
    widx = torch.where(stay, slot, (slot - W) // A)
    cchar = torch.where(stay, -1, (slot - W) % A)[None, :]
    prov_b = torch.zeros(B, T, W, dtype=torch.uint8, device=dev)

    for t in range(1, T):
        adv = (t < lens)[:, None]
        y_t = yb[:, t]
        src = _select(sc, k1, k2, val, W)                   # [B, W]
        prov_b[:, t] = torch.where(adv, src + 1, 0).to(torch.uint8)

        # the winner each slot descends from
        ok = (src >= 0)[:, widx]
        s = src.clamp(min=0)[:, widx]
        wk1 = torch.where(ok, k1.gather(1, s), 0)
        wk2 = torch.where(ok, k2.gather(1, s), 0)
        wpk1 = torch.where(ok, pk1.gather(1, s), 0)
        wpk2 = torch.where(ok, pk2.gather(1, s), 0)
        wch = torch.where(ok, chr_.gather(1, s), -1)
        wpch = torch.where(ok, pch.gather(1, s), -1)
        ws0 = torch.where(ok, st0.gather(1, s), _NEG_INF)
        ws1 = torch.where(ok, st1.gather(1, s), _NEG_INF)

        nk1 = torch.where(stay, wk1, (_mul32(wk1, _M1) + cchar + 1) & _MASK32)
        nk2 = torch.where(stay, wk2, (_mul32(wk2, _M2) + cchar + 1) & _MASK32)
        npk1 = torch.where(stay, wpk1, wk1)
        npk2 = torch.where(stay, wpk2, wk2)
        nch = torch.where(stay, wch, cchar)
        npch = torch.where(stay, wpch, wch)

        # hash join against the old table: a stay slot looks up its
        # parent, a child slot its own state at t-1
        q1 = torch.where(stay, wpk1, nk1)
        q2 = torch.where(stay, wpk2, nk2)
        eq = (val[:, None, :] & (q1[:, :, None] == k1[:, None, :])
              & (q2[:, :, None] == k2[:, None, :]))
        l0 = torch.where(eq, st0[:, None, :], _NEG_INF).max(dim=2).values
        l1 = torch.where(eq, st1[:, None, :], _NEG_INF).max(dim=2).values
        s0 = torch.where(stay, ws0, l0)
        s1 = torch.where(stay, ws1, l1)
        p0 = torch.where(stay, l0, ws0)
        p1 = torch.where(stay, l1, ws1)
        if model_id == 0:
            # a depth-1 node's parent is the root: cumulative blank
            is_root = stay & (wpk1 == 0) & (wpk2 == 0)
            p0 = torch.where(is_root, rb[:, t:t + 1], p0)

        same = nch == npch
        ch = nch.clamp(min=0)
        y_c = y_t.gather(1, ch)
        if model_id == 0:
            n0 = torch.logaddexp(p0 + y_c, s0 + y_t[:, -1:])
            n1 = ninf
        elif model_id == 1:
            n0 = torch.logaddexp(s0, s1) + y_t[:, -1:]
            frm = torch.where(same, p0, torch.logaddexp(p0, p1))
            n1 = torch.logaddexp(frm + y_c, s1 + y_c)
        else:
            y_cf = y_t.gather(1, ch + A)
            emit_flip = torch.where(same, p1, torch.logaddexp(p0, p1)) + y_c
            emit_flop = torch.where(same, p0 + y_cf, _NEG_INF)
            n0 = torch.logaddexp(emit_flip, s0 + y_c)
            n1 = torch.logaddexp(emit_flop, s1 + y_cf)
        n0 = torch.where(ok, n0, _NEG_INF)
        n1 = torch.where(ok, n1, _NEG_INF)
        nsc = n0 if model_id == 0 else torch.logaddexp(n0, n1)

        k1 = torch.where(adv, nk1, k1)
        k2 = torch.where(adv, nk2, k2)
        pk1 = torch.where(adv, npk1, pk1)
        pk2 = torch.where(adv, npk2, pk2)
        chr_ = torch.where(adv, nch, chr_)
        pch = torch.where(adv, npch, pch)
        st0 = torch.where(adv, n0, st0)
        st1 = torch.where(adv, n1, st1)
        sc = torch.where(adv, nsc, sc)
        val = torch.where(adv, ok, val)

    # ---- provenance walk from the best final slot, newest step first
    j = _select(sc, k1, k2, val, 1)[:, 0].cpu().numpy() if B else \
        np.zeros(0, np.int64)
    prov_h = prov_b.cpu().numpy()
    chars_b = np.full((B, T), -1, np.int8)
    ar = np.arange(B)
    for t in range(T - 1, 0, -1):
        child = j >= W
        w = np.where(child, (j - W) // A, j)
        c = np.where(child, (j - W) % A, -1)
        s = np.where(j >= 0, prov_h[ar, t, np.maximum(w, 0)].astype(
            np.int64) - 1, -1)
        moved = s >= 0
        j = np.where(moved, s, j)
        chars_b[:, t] = np.where(moved, c, -1)
    if T:
        chars_b[:, 0] = np.where(j >= W, (j - W) % A, -1)

    inside_h = inside.cpu().numpy()
    prov = prov_b[inside]
    chars = torch.as_tensor(chars_b[inside_h], device=dev)
    return prov, chars, st0, st1, val


def prepare_beam1d(ys, beam_width: int = 25, alphabet: str = "ACGT",
                   model: str = "ctc", device=None):
    """Host-side stage: pack a read batch (``planes_from_numpy``) and
    enqueue its upload (from pinned memory, without blocking), so a caller
    overlaps wave i+1's upload with wave i's kernel."""
    dev = resolve_device(device)
    A = len(alphabet)
    packed = planes_from_numpy(ys, model, A)
    host = [torch.from_numpy(packed[k]) for k in ("y", "root", "meta")]
    if dev.type == "cuda":
        host = [h.pin_memory() for h in host]
    return dict(meta=packed["meta"], device=dev, host=host,
                dev=[h.to(dev, non_blocking=True) for h in host],
                W=beam_width, A=A, alphabet=alphabet,
                model_id=_MODEL_IDS[model], n_reads=len(ys))


def launch_beam1d(prep):
    """Run a prepared batch: the kernel for a CUDA device (asynchronous),
    the plain version for the CPU. Returns (prov, chars, st0, st1, val)."""
    run = beam1d_cuda if prep["device"].type == "cuda" else beam1d_plain
    return run(*prep["dev"], prep["meta"], prep["W"], prep["A"],
               prep["model_id"])


def fetch_beam1d(prep, outs) -> list[str]:
    """Block on the outputs and copy the decoded chars to the host (one
    byte per step; the provenance stays on the device)."""
    chars = outs[1].cpu().numpy()
    letters = np.array(list(prep["alphabet"]))
    out = []
    for o, t in prep["meta"]:
        cs = chars[o:o + t]
        out.append("".join(letters[cs[cs >= 0]]))
    return out


def beam1d_batch(ys, beam_width: int = 25, alphabet: str = "ACGT",
                 model: str = "ctc", device=None) -> list[str]:
    """Beam-search decode a batch of reads; one kernel launch on
    ``device`` (default cuda). All three model kinds."""
    if len(ys) == 0:
        return []
    prep = prepare_beam1d(ys, beam_width=beam_width, alphabet=alphabet,
                          model=model, device=device)
    return fetch_beam1d(prep, launch_beam1d(prep))
