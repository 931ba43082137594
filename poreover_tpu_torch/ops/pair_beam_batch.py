"""Batched row_col pair-consensus beam search: the wrapper of the CUDA
kernel ``csrc/pair_beam_batch.cu``.

Replaces ``poreover_tpu/ops/pallas_pair_beam_batch.py`` (the Pallas TPU
kernel ``_build_kernel`` / ``_step_body`` launched by ``_run_kernel``),
with the same host API: ``prepare_pairs`` / ``launch_prepared`` /
``fetch_prepared`` / ``pair_beam_batch``. B read pairs of one model kind
(one wave of ``pair-decode --threads B``) decode in one launch, one CTA
per pair, each walking its own host plan. The kernel holds one template
instance per kind (ctc, bonito's ctc_merge_repeats, ctc_flipflop); the
TPU kernel took plain CTC only, and the JAX package runs the other two
kinds pair by pair through its XLA engine, whose semantics these
instances keep.

For tensors on a CUDA device the wrapper launches the kernel, and raises
if it does not build or launch; there is no fallback. For tensors on the
CPU it runs the kernel's plain PyTorch version,
``beam2d_planned.planned_scan``, which takes the same inputs and returns
the same outputs. ``launch_count`` counts kernel launches (not plain
runs), so a caller can show that its path went through the kernel.

Exact mode (``exact=True``, ``pair-decode --exact``): the kernel's
graveyard instances (one per kind) keep EXACT_G evicted candidates for
EXACT_GRACE MAIN steps, the JAX engine's ``_planned_scan`` with G > 0,
which the JAX package runs as an XLA scan; their plain version is
``planned_scan`` with the same G and grace. Their launches count in
``exact_launch_count``.

What bounds the kernel, and its design: see the note at the top of the
CUDA source. The library is built with nvcc for sm_90a at first use
(``build.py``), with no fast math.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..build import build_kernel
from ..device import resolve_device
from .beam2d_planned import (
    C0RUN, C1RUN, EXACT_G, M_N, M_WST0, M_WST1, META_COLS, components,
    graveyard, pack_pairs, planned_scan, tracebacks,
)

launch_count = 0  # launches for a batch of pairs (``pair_beam_batch``)
single_launch_count = 0  # launches of the single-pair entry (one CTA)
exact_launch_count = 0  # launches of the graveyard instances (either entry)

CMAX = 32  # candidate slots the kernel's table holds (one lane each)
KERNEL_A = 4  # alphabet size the kernel is compiled for
# widest window (columns) the kernel sweeps on its narrow path: seed and
# columns in one warp's lanes (csrc/pair_search.cuh: NARROW_MAX; checked
# against the built library when it loads)
NARROW_MAX = 31
# bytes of candidate storage a pair may keep in the kernel's shared memory
# (csrc/pair_beam_batch.cu: SMEM_STORAGE_LIMIT_BYTES; checked likewise); a
# wave whose largest pair needs more keeps its storage in global scratch
SMEM_STORAGE_LIMIT = 216 * 1024
# the same for the graveyard instances (csrc/pair_beam_batch.cu:
# EXACT_SMEM_STORAGE_LIMIT_BYTES; their bookkeeping takes shared memory too)
EXACT_SMEM_STORAGE_LIMIT = 208 * 1024

PHASE_CLOCKS = "POREOVER_PHASE_CLOCKS"  # macro of the instrumented build
# the instrumented build's slots (csrc/pair_search.cuh: CK_*), in order: per
# part its name, its phases and the unit its count slot counts; the count
# follows the phases, then the sweeps, the layers and the narrow sweeps of
# both groups
CLOCK_PARTS = (("step", ("prune", "expand", "permute", "loads", "layers",
                         "refresh", "score", "scan", "wait"), "plan step"),)
CLOCK_SLOTS = 9 + 1 + 3

_libs = {}


def bind_phase_clocks(lib):
    """Declare ``phase_clocks_read(out, n, reset)`` of a library built
    with ``PHASE_CLOCKS`` (csrc/pair_search.cuh: per-phase clock64 sums)."""
    lib.phase_clocks_read.restype = ctypes.c_int
    lib.phase_clocks_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                                      ctypes.c_int, ctypes.c_int]
    return lib


def load_kernel(phase_clocks: bool = False):
    """Build (once) and load the kernel library; returns the ctypes lib.
    With ``phase_clocks`` the instrumented build (a library of its own)."""
    if phase_clocks in _libs:
        return _libs[phase_clocks]
    lib = ctypes.CDLL(str(build_kernel(
        "pair_beam_batch", (PHASE_CLOCKS,) if phase_clocks else ())))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.pair_beam_storage_limit.restype = i
    lib.pair_beam_storage_limit.argtypes = []
    lib.pair_beam_narrow_max.restype = i
    lib.pair_beam_narrow_max.argtypes = []
    if lib.pair_beam_narrow_max() != NARROW_MAX:
        raise RuntimeError(f"the kernel's narrow path is "
                           f"{lib.pair_beam_narrow_max()} columns wide, "
                           f"NARROW_MAX says {NARROW_MAX}")
    lib.pair_beam_exact_storage_limit.restype = i
    lib.pair_beam_exact_storage_limit.argtypes = []
    lib.pair_beam_graveyard_rows.restype = i
    lib.pair_beam_graveyard_rows.argtypes = []
    for got, want, what in (
            (lib.pair_beam_storage_limit(), SMEM_STORAGE_LIMIT,
             "SMEM_STORAGE_LIMIT"),
            (lib.pair_beam_exact_storage_limit(), EXACT_SMEM_STORAGE_LIMIT,
             "EXACT_SMEM_STORAGE_LIMIT"),
            (lib.pair_beam_graveyard_rows(), EXACT_G, "EXACT_G")):
        if got != want:
            raise RuntimeError(f"the kernel has {got} for {what}, the "
                               f"wrapper {want}")
    lib.pair_beam_batch_launch.restype = i
    lib.pair_beam_batch_launch.argtypes = [vp, vp, vp, vp, i, i, i, i, vp,
                                           vp, vp, vp, vp]
    lib.pair_beam_exact_launch.restype = i
    lib.pair_beam_exact_launch.argtypes = [vp, vp, vp, vp, i, i, i, i, i,
                                           vp, vp, vp, vp, vp]
    _libs[phase_clocks] = bind_phase_clocks(lib) if phase_clocks else lib
    return lib


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


def storage_bytes(wst, beam_width: int, A: int = KERNEL_A,
                  model_id: int = 0, G: int = 0):
    """Bytes of candidate storage a search with storage widths ``wst`` (a
    pair of ints, or of arrays over pairs) needs in the pair and box
    kernels: sweep and frozen parent copy, double-buffered, per read and
    state component; with ``G`` graveyard rows (exact mode) also their
    sweeps, double-buffered."""
    C = beam_width * (A + 1)
    return 8 * components(model_id) * (2 * C + G) * (wst[0] + wst[1])


def _meta_storage(meta_h, W: int, A: int, model_id: int,
                  G: int = 0) -> np.ndarray:
    meta_h = np.asarray(meta_h)
    return storage_bytes((meta_h[:, M_WST0], meta_h[:, M_WST1]), W, A,
                         model_id, G)


def smem_limit(G: int = 0) -> int:
    """Storage bytes a pair may keep in shared memory: SMEM_STORAGE_LIMIT,
    or EXACT_SMEM_STORAGE_LIMIT for the graveyard instances (G > 0)."""
    return EXACT_SMEM_STORAGE_LIMIT if G else SMEM_STORAGE_LIMIT


def storage_path(prep) -> str:
    """Where the kernel keeps a prepared wave's storage: ``shared`` when
    its largest pair fits ``smem_limit``, else ``global``."""
    G = prep["G"]
    need = _meta_storage(prep["meta"], prep["W"], prep["A"],
                         prep["model_id"], G)
    return "shared" if need.max(initial=0) <= smem_limit(G) else "global"


def _launch(planes1, planes2, plan, meta, meta_h, W: int, A: int,
            in_smem: bool = True, model_id: int = 0, G: int = 0,
            grace: int = 1):
    """Check the tensors and launch the kernel's instance for ``model_id``
    (with ``G`` > 0: its graveyard instance, EXACT_G rows and eviction at
    ``grace``) on the current stream, one CTA per row of ``meta``; counts
    nothing. The storage lives in shared memory when the largest pair's
    fits (``storage_path``); ``in_smem=False`` puts it in global scratch all
    the same (``chip_smoke.py`` times both)."""
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
    if G not in (0, EXACT_G) or not 1 <= grace <= 1 << 30:
        raise ValueError(f"no kernel instance for G={G}, grace={grace}: G "
                         f"is 0 or {EXACT_G}, 1 <= grace <= 2**30")
    if dev.type != "cuda":
        raise ValueError(f"pair_beam_cuda: tensors on {dev}, expected cuda")
    B = meta.shape[0]
    if meta.shape[1] != META_COLS or plan.shape[1] != 5:
        raise ValueError(f"meta {tuple(meta.shape)} / plan "
                         f"{tuple(plan.shape)}: bad shape")
    meta_h = np.asarray(meta_h)
    if meta_h.shape != tuple(meta.shape):
        raise ValueError("meta_h does not match meta")
    n_total = int(meta_h[:, M_N].sum()) if B else 0
    if plan.shape[0] != n_total:
        raise ValueError(f"plan has {plan.shape[0]} steps, meta {n_total}")
    lib = load_kernel()
    need = _meta_storage(meta_h, W, A, model_id, G)
    # the storage in shared memory when the largest pair's fits
    smem = int(need.max(initial=0))
    if not in_smem or smem > smem_limit(G):
        smem = 0
    scratch = torch.empty(1 if smem else max(int(need.sum()) // 4, 1),
                          dtype=torch.float32, device=dev)
    prov = torch.empty(max(n_total, 1), W, dtype=torch.int8, device=dev)
    score = torch.empty(B, C, dtype=torch.float32, device=dev)
    valid = torch.empty(B, C, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (planes1.data_ptr(), planes2.data_ptr(), plan.data_ptr(),
            meta.data_ptr(), B, W, model_id)
    outs = (scratch.data_ptr(), prov.data_ptr(), score.data_ptr(),
            valid.data_ptr(), stream)
    with torch.cuda.device(dev):
        if G:
            err = lib.pair_beam_exact_launch(*ptrs, grace, smem, *outs)
        else:
            err = lib.pair_beam_batch_launch(*ptrs, smem, *outs)
    if err != 0:
        raise RuntimeError(f"pair_beam_batch kernel launch failed: CUDA "
                           f"error {err}")
    return prov[:n_total], score, valid


def pair_beam_cuda(planes1, planes2, plan, meta, meta_h, W: int,
                   A: int = KERNEL_A, model_id: int = 0, G: int = 0,
                   grace: int = 1):
    """Launch the kernel on the current stream (``G`` > 0: its graveyard
    instance, counted in ``exact_launch_count``); returns (prov int8
    [sum N, W], score float32 [B, C], valid bool [B, C]) without
    synchronising. ``meta_h`` is the host copy of ``meta`` (sizes the
    scratch without a device round trip)."""
    global launch_count, exact_launch_count
    outs = _launch(planes1, planes2, plan, meta, meta_h, W, A,
                   model_id=model_id, G=G, grace=grace)
    if G:
        exact_launch_count += 1
    else:
        launch_count += 1
    return outs


def sweep_paths(plan: np.ndarray) -> tuple[int, int]:
    """How many sweeps of a packed plan (int32 [N, 5]) the kernel runs on
    its narrow path (window of 1..NARROW_MAX columns) and how many on its
    general path (wider): MAIN steps sweep both reads, C0RUN / C1RUN one."""
    p = np.asarray(plan, dtype=np.int64).reshape(-1, 5)
    ty = p[:, 0]
    widths = np.concatenate([(p[:, 2] - p[:, 1])[ty != C1RUN],
                             (p[:, 4] - p[:, 3])[ty != C0RUN]])
    return (int(((widths > 0) & (widths <= NARROW_MAX)).sum()),
            int((widths > NARROW_MAX).sum()))


def prepare_pairs(pairs, beam_width: int = 5, alphabet: str = "ACGT",
                  steps_per_grid: int | None = None,
                  device_put: bool = True, device=None, model: str = "ctc",
                  exact: bool = False, dtype=np.float32):
    """Host-side stage: plans, storage widths and packed planes
    (``beam2d_planned.pack_pairs``) of pairs of the kind ``model``; with
    ``exact`` for the graveyard instance (``G`` and ``grace`` in the
    result). With ``device_put`` the tensors are enqueued for upload now
    (from pinned memory, without blocking), so a caller overlaps wave
    i+1's upload with wave i's kernel; otherwise at launch. ``dtype``
    float64 is for the plain version on the CPU (``--f64``); the kernel
    takes float32. ``steps_per_grid`` is accepted for the JAX package's
    signature and unused: each CTA walks its whole plan inside one
    launch."""
    del steps_per_grid
    dev = resolve_device(device)
    G, grace = graveyard(exact)
    packed = pack_pairs(pairs, beam_width, alphabet, model=model, G=G,
                        dtype=dtype)
    host = [torch.from_numpy(packed[k]) for k in
            ("planes1", "planes2", "plan", "meta")]
    if dev.type == "cuda":
        host = [h.pin_memory() for h in host]
    prep = dict(packed, device=dev, host=host, dev=None, grace=grace)
    if device_put:
        prep["dev"] = [h.to(dev, non_blocking=True) for h in host]
    return prep


def launch_prepared(prep):
    """Run a prepared batch: the kernel for a CUDA device (asynchronous),
    the plain version for the CPU. Returns (prov, score, valid)."""
    if not prep["live"]:
        return None
    tensors = prep["dev"] or [h.to(prep["device"], non_blocking=True)
                              for h in prep["host"]]
    if prep["device"].type == "cuda":
        return pair_beam_cuda(*tensors, prep["meta"], prep["W"], prep["A"],
                              prep["model_id"], prep["G"], prep["grace"])
    return planned_scan(*tensors, prep["W"], prep["A"],
                        model_id=prep["model_id"], G=prep["G"],
                        grace=prep["grace"])


def fetch_prepared(prep, outs) -> list[str]:
    """Block on the outputs, copy them to the host (~W bytes per plan
    step and pair) and walk the tracebacks."""
    if outs is None:
        return [""] * prep["n_pairs"]
    prov, score, valid = (o.cpu().numpy() for o in outs)
    return tracebacks(prep, prov, score, valid)


def pair_beam_batch(pairs, beam_width: int = 5, alphabet: str = "ACGT",
                    steps_per_grid: int | None = None, device=None,
                    model: str = "ctc", exact: bool = False,
                    dtype=np.float32) -> list[str]:
    """Batched row_col pair beam search over (y1, y2, envelope) pairs of
    the kind ``model``; one kernel launch on ``device`` (default cuda),
    of the graveyard instance with ``exact``."""
    prep = prepare_pairs(pairs, beam_width=beam_width, alphabet=alphabet,
                         steps_per_grid=steps_per_grid, device=device,
                         model=model, exact=exact, dtype=dtype)
    return fetch_prepared(prep, launch_prepared(prep))


def pair_beam_single(y1, y2, envelope, beam_width: int = 5,
                     alphabet: str = "ACGT", device=None,
                     model: str = "ctc", exact: bool = False) -> str:
    """The same search for one pair: the kernel launched with one CTA.

    Replaces ``poreover_tpu/ops/pallas_pair_beam.py`` (``pair_beam_pallas``,
    the single-pair Pallas kernel launched by its ``_run_kernel``). That
    kernel's scalar bookkeeping and sweep tiles were the TPU's way to run
    one pair; here one pair is a batch of one. A launch made here counts
    in ``single_launch_count`` (``exact``: in ``exact_launch_count``), not
    in ``launch_count``."""
    global single_launch_count, exact_launch_count
    prep = prepare_pairs([(y1, y2, envelope)], beam_width=beam_width,
                         alphabet=alphabet, device=device, model=model,
                         exact=exact)
    if not prep["live"]:
        return ""
    G, grace = prep["G"], prep["grace"]
    if prep["device"].type == "cuda":
        outs = _launch(*prep["dev"], prep["meta"], prep["W"], prep["A"],
                       model_id=prep["model_id"], G=G, grace=grace)
        if G:
            exact_launch_count += 1
        else:
            single_launch_count += 1
    else:
        outs = planned_scan(*prep["dev"], prep["W"], prep["A"],
                            model_id=prep["model_id"], G=G, grace=grace)
    return fetch_prepared(prep, outs)[0]
