"""Segmented box-batch pair beam search: the wrapper of the CUDA kernel
``csrc/box_beam.cu``, the engine of anchored mode (``pair-decode
--skip_matches``).

Replaces ``poreover_tpu/ops/pallas_box_beam.py`` (the Pallas TPU kernel
``_build_kernel`` / ``_step_body`` launched by ``_run_kernel``) and keeps
its host API: ``prepare_box``, ``box_beam`` (for ``box_beam_pallas``),
``prepare_pairs_box`` / ``launch_prepared_box`` / ``fetch_prepared_box`` /
``pair_beam_box_batch``; its ``_traceback_box`` is
``beam2d_planned.walk_provenance`` from the slot the kernel picked. Many independent anchor boxes, each a small (y1,
y2, envelope) consensus problem, decode in one launch: the boxes stand in
a queue, longest plan first, and each persistent CTA runs one box after
another, every box from the t = 0 state. The kernel picks the best final
candidate itself, so only provenance and one slot index per box come back.

The boxes of a launch are of one model kind (one template instance of
the kernel per kind). A box's candidate storage lives in the CTA's shared
memory, ``16 * K * C * (Wst0 + Wst1)`` bytes (K state components: 1 for
plain CTC, 2 for bonito and flip-flop). ``STORAGE_LIMIT_BYTES`` is the static
budget: ``prepare_box`` returns ``None`` for a box over it, ``box_beam``
lists such boxes as overflow for the caller to decode with the pair kernel
(``ops/pair_beam_batch.py``), and the launcher checks the limit again.

For tensors on a CUDA device the wrapper launches the kernel, and raises
if it does not build or launch; there is no fallback. For tensors on the
CPU it runs the plain PyTorch version ``box_beam_plain`` (the plan-driven
engine ``beam2d_planned.planned_scan`` with the boxes as rows of a batch,
plus the final pick), which takes the same inputs and returns the same
outputs. ``box_launch_count`` counts kernel launches, not plain runs.

Not carried over from the TPU module, because they served that machine
only: the fast-memory budget and the recursive splitting of a launch that
exceeds it, plans padded to 128-step blocks, plane bases shifted by 128
columns, the host's lockstep simulation of the hot window, the lazy
ancestor maps, the strip-refresh DMA mode, the ablation switches, and the
splitting of wide windows (the search chunks a wide window itself, in the
same float32 order, so the strings are the same).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..build import build_kernel
from ..device import resolve_device
from .beam2d_planned import (
    M_N, M_PLAN, M_WST0, M_WST1, META_COLS, _MODEL_IDS, build_plan,
    pack_pairs, plan_wst, planned_scan, walk_provenance,
)
from .pair_beam_batch import (
    CLOCK_PARTS, CLOCK_SLOTS, CMAX, KERNEL_A, PHASE_CLOCKS, _check,
    bind_phase_clocks, fetch_prepared, launch_prepared, prepare_pairs,
    storage_bytes,
)
# CLOCK_PARTS, CLOCK_SLOTS: the box kernel runs the same search step

box_launch_count = 0  # launches of the box kernel

# storage a box may need in the kernel: the most at which two CTAs (each
# with the search's 7.6 KB of static shared memory beside it, the same in
# every kind's instance) still share an SM's 228 KB of shared memory, so
# that one large box never halves a launch's CTAs (csrc/box_beam.cu checks
# the same sum at compile time). A bonito or flip-flop box needs twice a
# CTC box's bytes per column, so its widest storage is half as wide.
STORAGE_LIMIT_BYTES = 105 * 1024

_libs = {}


def load_kernel(phase_clocks: bool = False):
    """Build (once) and load the kernel library; returns the ctypes lib.
    With ``phase_clocks`` the instrumented build (a library of its own)."""
    if phase_clocks in _libs:
        return _libs[phase_clocks]
    lib = ctypes.CDLL(str(build_kernel(
        "box_beam", (PHASE_CLOCKS,) if phase_clocks else ())))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.box_beam_storage_limit.restype = i
    lib.box_beam_storage_limit.argtypes = []
    lib.box_beam_launch.restype = i
    lib.box_beam_launch.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp, vp,
                                    vp, ctypes.POINTER(i), vp]
    _libs[phase_clocks] = bind_phase_clocks(lib) if phase_clocks else lib
    return lib


def prepare_box(y1, y2, envelope, beam_width: int = 5,
                alphabet: str = "ACGT", model: str = "ctc"):
    """Per-box host prep: the plan and its storage widths.

    Returns ``None`` when the box needs more storage than
    ``STORAGE_LIMIT_BYTES``: the caller decodes it with the pair kernel. A
    box with an empty read has an empty plan (``n`` 0) and decodes to ""."""
    y1 = np.asarray(y1)
    y2 = np.asarray(y2)
    U, V = len(y1), len(y2)
    if U == 0 or V == 0:
        return dict(y1=y1, y2=y2, plan=None, wst=(0, 0), n=0, storage=0)
    if envelope is None:
        envelope = np.tile(np.array([0, V], dtype=np.int64), (U, 1))
    env = np.asarray(envelope, dtype=np.int64)[:U]
    plan = build_plan(env, U, V)
    wst = plan_wst(plan)
    need = storage_bytes(wst, beam_width, len(alphabet), _MODEL_IDS[model])
    if need > STORAGE_LIMIT_BYTES:
        return None
    return dict(y1=y1, y2=y2, plan=plan, wst=wst, n=len(plan["type"]),
                storage=need)


def box_beam_cuda(planes1, planes2, plan, meta, meta_h, W: int,
                  A: int = KERNEL_A, max_ctas: int | None = None,
                  info: dict | None = None, model_id: int = 0):
    """Launch the kernel's instance for ``model_id`` on the current stream
    over the boxes of ``meta`` (packed as by ``beam2d_planned.pack_pairs``,
    in queue order); returns
    (prov int8 [sum N, W], pick int32 [n boxes]) without synchronising.
    ``meta_h`` is the host copy of ``meta``. ``max_ctas`` caps the grid (a
    box's result does not depend on it). ``info``, if given, receives the
    grid and the shared-memory size of the launch."""
    global box_launch_count
    dev = planes1.device
    _check("planes1", planes1, torch.float32, 1, dev)
    _check("planes2", planes2, torch.float32, 1, dev)
    _check("plan", plan, torch.int32, 2, dev)
    _check("meta", meta, torch.int64, 2, dev)
    C = W * (A + 1)
    if A != KERNEL_A or C > CMAX or W < 1:
        raise ValueError(f"kernel supports A={KERNEL_A} and W*(A+1) <= "
                         f"{CMAX}; got A={A}, W={W}")
    if model_id not in (0, 1, 2):
        raise ValueError(f"no kernel instance for model_id {model_id}")
    if dev.type != "cuda":
        raise ValueError(f"box_beam_cuda: tensors on {dev}, expected cuda")
    nbox = meta.shape[0]
    if meta.shape[1] != META_COLS or plan.shape[1] != 5:
        raise ValueError(f"meta {tuple(meta.shape)} / plan "
                         f"{tuple(plan.shape)}: bad shape")
    meta_h = np.asarray(meta_h)
    if meta_h.shape != tuple(meta.shape):
        raise ValueError("meta_h does not match meta")
    n_total = int(meta_h[:, M_N].sum()) if nbox else 0
    if plan.shape[0] != n_total:
        raise ValueError(f"plan has {plan.shape[0]} steps, meta {n_total}")
    need = int(storage_bytes((meta_h[:, M_WST0], meta_h[:, M_WST1]), W,
                             A, model_id).max(initial=0))
    if need > STORAGE_LIMIT_BYTES:
        raise ValueError(f"a box needs {need} bytes of storage, over the "
                         f"kernel's {STORAGE_LIMIT_BYTES}")
    lib = load_kernel()
    if lib.box_beam_storage_limit() < STORAGE_LIMIT_BYTES:
        raise RuntimeError("the kernel's storage limit is below "
                           "STORAGE_LIMIT_BYTES")
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    prov = torch.empty(max(n_total, 1), W, dtype=torch.int8, device=dev)
    pick = torch.empty(nbox, dtype=torch.int32, device=dev)
    grid = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.box_beam_launch(
            planes1.data_ptr(), planes2.data_ptr(), plan.data_ptr(),
            meta.data_ptr(), nbox, W, model_id, need, int(max_ctas or 0),
            queue.data_ptr(), prov.data_ptr(), pick.data_ptr(),
            ctypes.byref(grid), stream)
    if err != 0:
        raise RuntimeError(f"box_beam kernel launch failed: CUDA error "
                           f"{err}")
    box_launch_count += 1
    if info is not None:
        info.update(grid=grid.value, smem_bytes=need, boxes=nbox)
    return prov[:n_total], pick


def final_pick(score: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Best valid candidate of each final deduplicated table [B, C], ties
    to the lowest slot (slot 0 when none is valid): int32 [B]."""
    sc = torch.where(valid, score, float("-inf"))
    return torch.sort(sc, dim=1, descending=True,
                      stable=True).indices[:, 0].to(torch.int32)


def box_beam_plain(planes1, planes2, plan, meta, W: int, A: int = KERNEL_A,
                   model_id: int = 0):
    """The plain version of the box kernel: same inputs, same outputs
    (prov int8 [sum N, W], pick int32 [n boxes])."""
    if meta.shape[0] == 0:
        return (torch.zeros(0, W, dtype=torch.int8, device=planes1.device),
                torch.zeros(0, dtype=torch.int32, device=planes1.device))
    prov, score, valid = planned_scan(planes1, planes2, plan, meta, W, A,
                                      model_id=model_id)
    return prov, final_pick(score, valid)


def prepare_boxes(boxes, beam_width: int = 5, alphabet: str = "ACGT",
                  device=None, prepared=None, model: str = "ctc"):
    """Host stage of a launch over boxes of the kind ``model``:
    ``prepare_box`` per box (or ``prepared``),
    the fitting boxes packed in queue order (longest plan first), and the
    upload enqueued from pinned memory. ``overflow`` lists the boxes over
    the storage limit."""
    dev = resolve_device(device)
    preps = (prepared if prepared is not None else
             [prepare_box(*b, beam_width=beam_width, alphabet=alphabet,
                          model=model) for b in boxes])
    overflow = [i for i, p in enumerate(preps) if p is None]
    live = [i for i, p in enumerate(preps) if p is not None and p["n"] > 0]
    order = sorted(live, key=lambda i: -preps[i]["n"])
    packed = pack_pairs(
        [(preps[i]["y1"], preps[i]["y2"], None) for i in order], beam_width,
        alphabet, plans=[preps[i]["plan"] for i in order],
        wst=[preps[i]["wst"] for i in order], model=model)
    host = [torch.from_numpy(packed[k]) for k in
            ("planes1", "planes2", "plan", "meta")]
    if dev.type == "cuda":
        host = [h.pin_memory() for h in host]
    return dict(packed, device=dev, order=order, overflow=overflow,
                n_boxes=len(preps), info={},
                dev=[h.to(dev, non_blocking=True) for h in host])


def launch_boxes(prep, max_ctas: int | None = None):
    """Run a prepared launch: the kernel for a CUDA device (asynchronous),
    the plain version for the CPU. Returns (prov, pick)."""
    if not prep["order"]:
        return None
    if prep["device"].type == "cuda":
        return box_beam_cuda(*prep["dev"], prep["meta"], prep["W"],
                             prep["A"], max_ctas=max_ctas, info=prep["info"],
                             model_id=prep["model_id"])
    return box_beam_plain(*prep["dev"], prep["W"], prep["A"],
                          prep["model_id"])


def fetch_boxes(prep, outs) -> list:
    """Block on the outputs, copy them to the host and walk the
    tracebacks: one string per box, ``None`` for a box in ``overflow``."""
    seqs: list = [""] * prep["n_boxes"]
    for i in prep["overflow"]:
        seqs[i] = None
    if outs is None:
        return seqs
    prov, pick = (o.cpu().numpy() for o in outs)
    meta = prep["meta"]
    for r, i in enumerate(prep["order"]):
        o, n = int(meta[r, M_PLAN]), int(meta[r, M_N])
        seqs[i] = walk_provenance(prov[o:o + n], prep["types"][r],
                                  int(pick[r]), prep["W"], prep["A"],
                                  prep["alphabet"])
    return seqs


def box_beam(boxes, beam_width: int = 5, alphabet: str = "ACGT",
             device=None, max_ctas: int | None = None, model: str = "ctc"):
    """Decode many (y1, y2, envelope) anchor boxes of the kind ``model`` in
    one launch on ``device`` (default cuda). Returns (seqs, overflow_idx):
    seqs[i] is box i's consensus, or None when its storage is over the
    limit; those boxes are listed in overflow_idx for the caller to
    reroute."""
    prep = prepare_boxes(boxes, beam_width, alphabet, device, model=model)
    return fetch_boxes(prep, launch_boxes(prep, max_ctas)), prep["overflow"]


# --------------------------------------------------------------------------
# whole pairs through the box engine
# --------------------------------------------------------------------------

def prepare_pairs_box(pairs, beam_width: int = 5, alphabet: str = "ACGT",
                      steps_per_grid: int | None = None, prepared=None,
                      cap: int | None = None, device=None):
    """Host prep and upload of whole (y1, y2, envelope) pairs for the box
    engine. On the TPU this second whole-pair engine exists because the
    general kernel's cost per step grows there with the number of pairs;
    the port's pair kernel has one CTA per pair and no such cost, so this
    entry is kept for its signature and its strings: pairs whose storage
    fits the box kernel run in it, the rest in the pair kernel.
    ``prepared`` takes the pairs' ``prepare_box`` results where the caller
    has them. ``steps_per_grid`` and ``cap`` are accepted and unused (each
    CTA walks its whole plan, and chunks wide windows itself)."""
    del steps_per_grid, cap
    box = prepare_boxes(pairs, beam_width, alphabet, device, prepared)
    rest = prepare_pairs([pairs[i] for i in box["overflow"]],
                         beam_width=beam_width, alphabet=alphabet,
                         device=device)
    return dict(box=box, rest=rest)


def launch_prepared_box(prep):
    return launch_boxes(prep["box"]), launch_prepared(prep["rest"])


def fetch_prepared_box(prep, outs) -> list[str]:
    seqs = fetch_boxes(prep["box"], outs[0])
    for i, s in zip(prep["box"]["overflow"],
                    fetch_prepared(prep["rest"], outs[1])):
        seqs[i] = s
    return seqs


def pair_beam_box_batch(pairs, beam_width: int = 5, alphabet: str = "ACGT",
                        steps_per_grid: int | None = None, prepared=None,
                        cap: int | None = None, device=None) -> list[str]:
    """One-call wrapper: prepare + launch + fetch (see
    ``prepare_pairs_box``)."""
    prep = prepare_pairs_box(pairs, beam_width=beam_width, alphabet=alphabet,
                             steps_per_grid=steps_per_grid,
                             prepared=prepared, cap=cap, device=device)
    return fetch_prepared_box(prep, launch_prepared_box(prep))
