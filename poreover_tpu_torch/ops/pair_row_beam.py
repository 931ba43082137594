"""By-row pair-consensus beam search (``pair-decode --beam_search_method
row``): the wrapper of the CUDA kernel ``csrc/pair_row_beam.cu``.

Replaces no Pallas kernel: the JAX package runs this search as an XLA
``lax.scan`` over the rows of read 1 (``poreover_tpu/ops/beam2d.py:
_beam2d_row_scan``), one pair at a time. Here B workloads of one model
kind (a wave of ``--threads`` pairs, or the anchored boxes of such a wave)
decode in one launch, one CTA per workload; a plain PyTorch version would
take one to two hundred launches a row, tens of seconds a full-size pair.
The kernel holds one template instance per kind (ctc, bonito's
ctc_merge_repeats, ctc_flipflop).

Host API, like ``ops/pair_beam_batch.py``: ``prepare_rows`` (packing,
``beam2d.pack_rows``, and the upload) / ``launch_prepared`` /
``fetch_prepared`` / ``pair_row_beam``. For tensors on a CUDA device the
wrapper launches the kernel, and raises if it does not build or launch;
there is no fallback. For tensors on the CPU it runs the kernel's plain
version ``beam2d.row_scan``, which takes the same inputs and returns the
same outputs (in float32, or float64 for ``pair-decode --f64``).
``launch_count`` counts kernel launches (not plain runs), so a caller can
show that its path went through the kernel.

A wave's storage (the read-2 sweeps and frozen parent copies, double
buffered, the row's prefix sums and the warps' scratch; ``storage_floats``
per workload) goes to one of STORAGE_PATHS by its largest workload: all
in dynamic shared memory when it fits SMEM_STORAGE_LIMIT, else all in
global scratch. What bounds the kernel, and its design: the note at the
top of the CUDA source. The library is built with nvcc for sm_90a at
first use (``build.py``), with no fast math.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..build import build_kernel
from ..device import resolve_device
from .beam2d import RM_R, RM_SCR, RM_WB, pack_rows, row_scan, strings_of

launch_count = 0  # kernel launches (``row_beam_cuda``)

KERNEL_A = 4  # alphabet size the kernel is compiled for
CMAX = 128  # candidate slots the kernel's table holds (W * (A + 1))
NWARPS = 16  # warps per CTA (csrc/pair_row_beam.cu: NT / 32)
SMAX = 8  # emission columns whose prefix sums a row keeps
# bytes of storage a workload may keep in the kernel's dynamic shared
# memory (csrc/pair_row_beam.cu: SMEM_STORAGE_LIMIT_BYTES; checked when the
# library loads); a wave whose largest workload needs more keeps all its
# storage in global scratch
SMEM_STORAGE_LIMIT = 200 * 1024
# where a launch keeps a wave's storage, chosen by its largest workload
STORAGE_PATHS = ("shared", "global")

_lib = None


def storage_floats(C: int, Wb: int) -> int:
    """Floats of one workload's storage (csrc/pair_row_beam.cu:
    storage_floats): sweeps [2][C][2][Wb + 1], frozen parent copies
    [2][C][2][Wb], the row's prefix sums [SMAX][Wb], and per warp a chain
    of Wb + 1 and Wb / 8 + 16 of prefix-sum scratch."""
    return (4 * C * (Wb + 1) + 4 * C * Wb + SMAX * Wb
            + NWARPS * (Wb + 1 + Wb // 8 + 16))


def load_kernel():
    """Build (once) and load the kernel library; returns the ctypes lib."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_kernel("pair_row_beam")))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.pair_row_beam_storage_floats.restype = ctypes.c_longlong
    lib.pair_row_beam_storage_floats.argtypes = [i, i]
    lib.pair_row_beam_smem_limit.restype = i
    lib.pair_row_beam_smem_limit.argtypes = []
    lib.pair_row_beam_cmax.restype = i
    lib.pair_row_beam_cmax.argtypes = []
    for got, want, what in (
            (lib.pair_row_beam_smem_limit(), SMEM_STORAGE_LIMIT,
             "SMEM_STORAGE_LIMIT"),
            (lib.pair_row_beam_cmax(), CMAX, "CMAX")):
        if got != want:
            raise RuntimeError(f"the kernel has {got} for {what}, the "
                               f"wrapper {want}")
    for C, Wb in ((25, 1), (25, 83), (125, 1000), (5, 70000)):
        if lib.pair_row_beam_storage_floats(C, Wb) != storage_floats(C, Wb):
            raise RuntimeError("the kernel's storage layout differs from "
                               "storage_floats")
    lib.pair_row_beam_launch.restype = i
    lib.pair_row_beam_launch.argtypes = [vp] * 6 + [i] * 4 + [vp] * 7
    _lib = lib
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


def _storage_bytes(meta_h, W: int, A: int = KERNEL_A) -> np.ndarray:
    C = W * (A + 1)
    return np.array([4 * storage_floats(C, int(wb))
                     for wb in np.asarray(meta_h)[:, RM_WB]], np.int64)


def storage_path(prep) -> str:
    """Where the kernel keeps a prepared wave's storage (STORAGE_PATHS):
    ``shared`` when its largest workload's fits SMEM_STORAGE_LIMIT, else
    ``global``."""
    need = _storage_bytes(prep["meta"], prep["W"], prep["A"])
    return "shared" if need.max(initial=0) <= SMEM_STORAGE_LIMIT else \
        "global"


def _launch(y1, y2, cum1, cum2, rows, meta, meta_h, W: int, A: int,
            model_id: int = 0, storage: str | None = None):
    """Check the tensors and launch the kernel's instance for ``model_id``
    on the current stream, one CTA per row of ``meta``; counts nothing.
    The storage goes where the largest workload's fits (``storage_path``);
    ``storage="global"`` puts it in global scratch all the same (the
    card's checks hold the paths to each other). Returns (src, score,
    valid, chars, first) without synchronising."""
    dev = y1.device
    S = 2 * A if model_id == 2 else A + 1
    _check("y1", y1, torch.float32, 2, dev)
    _check("y2", y2, torch.float32, 2, dev)
    _check("cum1", cum1, torch.float32, 1, dev)
    _check("cum2", cum2, torch.float32, 1, dev)
    _check("rows", rows, torch.int32, 2, dev)
    _check("meta", meta, torch.int64, 2, dev)
    C = W * (A + 1)
    if A != KERNEL_A or C > CMAX or W < 1:
        raise ValueError(f"kernel supports A={KERNEL_A} and W*(A+1) <= "
                         f"{CMAX}; got A={A}, W={W}")
    if model_id not in (0, 1, 2):
        raise ValueError(f"no kernel instance for model_id {model_id}")
    if y1.shape[1] != S or y2.shape[1] != S:
        raise ValueError(f"model_id {model_id} takes {S} emission columns")
    if dev.type != "cuda":
        raise ValueError(f"row_beam_cuda: tensors on {dev}, expected cuda")
    meta_h = np.asarray(meta_h)
    if meta_h.shape != tuple(meta.shape):
        raise ValueError("meta_h does not match meta")
    B = meta_h.shape[0]
    n_rows = int(meta_h[:, RM_R].sum()) if B else 0
    if rows.shape != (n_rows, 2):
        raise ValueError(f"rows {tuple(rows.shape)}, meta says {n_rows}")
    lib = load_kernel()
    path = storage_path(dict(meta=meta_h, W=W, A=A))
    if storage is not None:
        if storage not in STORAGE_PATHS or (
                STORAGE_PATHS.index(storage) < STORAGE_PATHS.index(path)):
            raise ValueError(f"storage {storage!r}: the wave needs {path!r}")
        path = storage
    need = _storage_bytes(meta_h, W, A)
    smem = int(need.max(initial=0)) if path == "shared" else 0
    scratch = torch.empty(1 if path == "shared" else
                          max(int(need.sum()) // 4, 1),
                          dtype=torch.float32, device=dev)
    src = torch.empty(max(n_rows, 1), W, dtype=torch.int16, device=dev)
    score = torch.empty(B, C, dtype=torch.float32, device=dev)
    valid = torch.empty(B, C, dtype=torch.bool, device=dev)
    chars = torch.empty(max(n_rows, 1), dtype=torch.int8, device=dev)
    first = torch.empty(max(B, 1), dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pair_row_beam_launch(
            y1.data_ptr(), y2.data_ptr(), cum1.data_ptr(), cum2.data_ptr(),
            rows.data_ptr(), meta.data_ptr(), B, W, model_id, smem,
            scratch.data_ptr(), src.data_ptr(), score.data_ptr(),
            valid.data_ptr(), chars.data_ptr(), first.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pair_row_beam kernel launch failed: CUDA error "
                           f"{err}")
    return src[:n_rows], score, valid, chars[:n_rows], first[:B]


def row_beam_cuda(y1, y2, cum1, cum2, rows, meta, meta_h, W: int,
                  A: int = KERNEL_A, model_id: int = 0):
    """Launch the kernel on the current stream (counted in
    ``launch_count``); returns (src int16 [sum R, W], score float32 [B,
    C], valid bool [B, C], chars int8 [sum R], first int8 [B]) without
    synchronising. ``meta_h`` is the host copy of ``meta`` (sizes the
    scratch without a device round trip)."""
    global launch_count
    outs = _launch(y1, y2, cum1, cum2, rows, meta, meta_h, W, A, model_id)
    launch_count += 1
    return outs


TENSORS = ("y1", "y2", "cum1", "cum2", "rows", "meta")


def prepare_rows(workloads, beam_width: int = 5, alphabet: str = "ACGT",
                 device=None, model: str = "ctc", dtype=np.float32,
                 n_rows=None):
    """Host-side stage: ``beam2d.pack_rows`` of (y1, y2, envelope)
    workloads of the kind ``model`` (``n_rows`` cuts each to its first
    rows), each workload's first float in the kernel's global scratch
    (meta's RM_SCR, from ``storage_floats``), and the upload, enqueued now
    from pinned memory without blocking. ``dtype`` float64 is for the
    plain version on the CPU (``--f64``); the kernel takes float32."""
    dev = resolve_device(device)
    packed = pack_rows(workloads, beam_width, alphabet, model=model,
                       dtype=dtype, n_rows=n_rows)
    floats = _storage_bytes(packed["meta"], packed["W"], packed["A"]) // 4
    packed["meta"][:, RM_SCR] = np.cumsum(floats) - floats
    host = [torch.from_numpy(packed[k]) for k in TENSORS]
    if dev.type == "cuda":
        host = [h.pin_memory() for h in host]
    return dict(packed, device=dev,
                dev=[h.to(dev, non_blocking=True) for h in host])


def launch_prepared(prep):
    """Run a prepared wave: the kernel for a CUDA device (asynchronous),
    the plain version for the CPU. Returns (src, score, valid, chars,
    first)."""
    if prep["device"].type == "cuda":
        return row_beam_cuda(*prep["dev"], prep["meta"], prep["W"],
                             prep["A"], prep["model_id"])
    return row_scan(*prep["dev"], prep["meta"], prep["W"], prep["A"],
                    prep["model_id"])


def fetch_prepared(prep, outs) -> list[str]:
    """Block on the traceback (a byte per row) and spell each workload's
    consensus."""
    chars, first = outs[3].cpu().numpy(), outs[4].cpu().numpy()
    return strings_of(prep, chars, first)


def pair_row_beam(workloads, beam_width: int = 5, alphabet: str = "ACGT",
                  device=None, model: str = "ctc",
                  dtype=np.float32) -> list[str]:
    """By-row pair beam search over (y1, y2, envelope) workloads of the
    kind ``model`` (envelope None: the whole lattice); one kernel launch on
    ``device`` (default cuda)."""
    prep = prepare_rows(workloads, beam_width, alphabet, device=device,
                        model=model, dtype=dtype)
    return fetch_prepared(prep, launch_prepared(prep))
