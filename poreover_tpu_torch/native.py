"""ctypes bindings for the C++ host runtime (``native/*.cpp``).

The port's own loader: it builds ``native/poreover_native.cpp``,
``pair_beam_cpu.cpp``, ``plan_walk.cpp`` and ``beam1d_cpu.cpp`` with
``g++ -O3 -std=c++17 -fPIC -shared`` into ``poreover_tpu_torch/_build/``
at first use (never into ``native/``), and raises when no compiler is
found. Covers the banded and full Needleman-Wunsch aligners, the fitting
aligner of ``benchmark``, the C++ plan walk, and the f64 windowed-memo oracle of the pair beam search.
"""
from __future__ import annotations

import ctypes

import numpy as np
from numpy.ctypeslib import ndpointer

from .build import REPO_DIR, build_shared, find_tool

_SOURCES = ("poreover_native.cpp", "pair_beam_cpu.cpp", "plan_walk.cpp",
            "beam1d_cpu.cpp")

_lib = None


def load():
    """Load the native library, building it on first use."""
    global _lib
    if _lib is not None:
        return _lib
    path = build_shared(
        "libporeover_native", find_tool("g++"),
        ["-O3", "-std=c++17", "-fPIC", "-shared"],
        [REPO_DIR / "native" / s for s in _SOURCES])
    lib = ctypes.CDLL(str(path))
    lib.nw_global_pair.restype = ctypes.c_int
    lib.nw_global_pair.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.nw_global_pair_banded.restype = ctypes.c_int
    lib.nw_global_pair_banded.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.pair_beam_row_col_cpu_emul.restype = ctypes.c_int
    lib.pair_beam_row_col_cpu_emul.argtypes = [
        ndpointer(np.float64, flags="C_CONTIGUOUS"), ctypes.c_int,
        ndpointer(np.float64, flags="C_CONTIGUOUS"), ctypes.c_int,
        ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_char_p,
    ]
    lib.nw_fit_align.restype = ctypes.c_int
    lib.nw_fit_align.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.plan_walk_native.restype = ctypes.c_int
    lib.plan_walk_native.argtypes = [
        ndpointer(np.int64, flags="C_CONTIGUOUS"), ctypes.c_int,
        ctypes.c_int, ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int,
    ]
    _lib = lib
    return _lib


def plan_walk_native(env, U: int, V: int):
    """C++ plan walk (native/plan_walk.cpp); returns the same dict as
    ops.beam2d_planned.plan_walk."""
    env = np.ascontiguousarray(env, dtype=np.int64)
    cap = U + V + 2
    out = np.empty((cap, 5), np.int32)
    n = load().plan_walk_native(env, U, V, out.reshape(-1), cap)
    if n < 0:
        raise RuntimeError(f"plan_walk_native: step capacity {cap} too small")
    arr = out[:n]
    return dict(
        type=arr[:, 0].copy(), a_lo=arr[:, 1].copy(), a_hi=arr[:, 2].copy(),
        b_lo=arr[:, 3].copy(), b_hi=arr[:, 4].copy(),
    )


def pair_beam_row_col_cpu_emul(y1, y2, envelope, beam_width: int = 5) -> str:
    """f64 single-core row_col pair beam search with the windowed-memo
    semantics of the accelerator engines (native/pair_beam_cpu.cpp emulate
    mode): the oracle a full-size consensus is held against."""
    y1 = np.ascontiguousarray(y1, dtype=np.float64)
    y2 = np.ascontiguousarray(y2, dtype=np.float64)
    env = np.ascontiguousarray(envelope, dtype=np.int64)
    out = ctypes.create_string_buffer(len(y1) + len(y2) + 1)
    n = load().pair_beam_row_col_cpu_emul(
        y1, len(y1), y2, len(y2), env, beam_width, out
    )
    return out.value[:n].decode()


def global_pair(seq1: str, seq2: str, match=2, mismatch=-1, gap_cost=-1):
    """Full Needleman-Wunsch global alignment; returns the gapped strings."""
    buflen = len(seq1) + len(seq2) + 1
    out1 = ctypes.create_string_buffer(buflen)
    out2 = ctypes.create_string_buffer(buflen)
    n = load().nw_global_pair(
        seq1.encode(), len(seq1), seq2.encode(), len(seq2),
        match, mismatch, gap_cost, out1, out2,
    )
    return out1.value[:n].decode(), out2.value[:n].decode()


def fit_align(query: str, ref_window: str, match=2, mismatch=-1,
              gap_cost=-1):
    """Fitting alignment: query global, reference-window overhang free;
    returns the gapped strings."""
    buflen = len(query) + len(ref_window) + 1
    out_q = ctypes.create_string_buffer(buflen)
    out_r = ctypes.create_string_buffer(buflen)
    n = load().nw_fit_align(
        query.encode(), len(query), ref_window.encode(), len(ref_window),
        match, mismatch, gap_cost, out_q, out_r,
    )
    return out_q.value[:n].decode(), out_r.value[:n].decode()


def global_pair_banded(
    seq1: str, seq2: str, band_width=500, match=2, mismatch=-1, gap_cost=-1
):
    """Banded Needleman-Wunsch global alignment; returns the gapped
    strings."""
    buflen = len(seq1) + len(seq2) + 1
    out1 = ctypes.create_string_buffer(buflen)
    out2 = ctypes.create_string_buffer(buflen)
    n = load().nw_global_pair_banded(
        seq1.encode(), len(seq1), seq2.encode(), len(seq2),
        band_width, match, mismatch, gap_cost, out1, out2,
    )
    return out1.value[:n].decode(), out2.value[:n].decode()
