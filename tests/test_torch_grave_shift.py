"""The rules the exact instances' graveyard relies on: a run of the JAX
engine's re-anchoring shifts is one shift by a composed descriptor, and
the graveyard's slots stay in age order.

A buried row is never swept, only moved with its read's storage window:
at every storage pass the plain version (``ops/beam2d_planned.py``) shifts
it by ``_jax_shift(d, Wst)`` for an anchor move d, whose wrap keeps a stale
tail on a backward move of more than Wst+1 columns. The kernel
(``csrc/pair_search.cuh``) instead keeps the row's storage frozen from its
burial and a descriptor (S, lo, hi): the row's value at column j is
frozen[j + S] for lo <= j < hi, and -inf elsewhere. Each shift s composes
in O(1), by the kernel's ``compose_shift``:

    S += s;
    lo = max(lo - s, 0);
    hi = min(hi - s, Wa);
    if (lo >= hi) S = lo = hi = 0;

The new graveyard is ranked by (age, pool index) with the old slots in the
pool in slot order; since its slots come out in age order, the old slots
that stay keep their relative order, and the kernel places them by a
prefix count instead of a rank over all G keys.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from poreover_tpu_torch.ops import beam2d_planned as tp
from poreover_tpu_torch.ops.beam2d import _shift_window
from poreover_tpu_torch.ops.beam2d_planned import _jax_shift
from poreover_tpu_torch.sim import exact_style_cases, stuttered

RULE = ("S += s;", "lo = max(lo - s, 0);", "hi = min(hi - s, Wa);",
        "if (lo >= hi) S = lo = hi = 0;")


def compose(desc, s, Wa):
    """The kernel's compose_shift, as quoted in this module's docstring."""
    S, lo, hi = desc
    S += s
    lo = max(lo - s, 0)
    hi = min(hi - s, Wa)
    if lo >= hi:
        S = lo = hi = 0
    return S, lo, hi


def read(frozen, desc, Wa):
    S, lo, hi = desc
    return np.array([frozen[j + S] if lo <= j < hi else -np.inf
                     for j in range(Wa)], np.float32)


def shifted(row, d, Wst):
    """One storage pass of the plain version on a buried row."""
    s = _jax_shift(torch.tensor([d]), torch.tensor([Wst]))
    return _shift_window(row[None], 0, s, Wst, extra=0,
                         width=torch.tensor([Wst]))[0]


@settings(max_examples=300, deadline=None)
@given(Wst=st.integers(1, 40),
       moves=st.lists(st.integers(-130, 130), max_size=12),
       seed=st.integers(0, 2 ** 31 - 1))
@example(Wst=16, moves=[3, -40, 5, 1], seed=1)
@example(Wst=5, moves=[-7, -7, 2, 9, -15], seed=2)
def test_composed_descriptor_is_the_run_of_shifts(Wst, moves, seed):
    """Shifting a row one anchor move at a time (with the wrap of backward
    moves beyond Wst+1) equals one read through the composed descriptor."""
    frozen = np.random.default_rng(seed).normal(size=Wst).astype(np.float32)
    row = torch.from_numpy(frozen.copy())
    desc = (0, 0, Wst)
    for d in moves:
        row = shifted(row, d, Wst)
        s = int(_jax_shift(torch.tensor(d), torch.tensor(Wst)))
        desc = compose(desc, s, Wst)
        assert np.array_equal(row.numpy(), read(frozen, desc, Wst))


def test_backward_moves_beyond_the_window_wrap():
    """The case the descriptor has to carry: a backward move of more than
    Wst+1 columns is not a shift by the move (a cleared row): it clears
    the row by a forward shift of Wst+1, or keeps a stale tail."""
    Wst = 10
    got = {d: int(_jax_shift(torch.tensor(d), torch.tensor(Wst)))
           for d in (-11, -12, -21, -22, -25, -31, -32, -40)}
    assert got == {-11: -11, -12: 11, -21: 11, -22: 10, -25: 7, -31: 1,
                   -32: 0, -40: -8}
    frozen = np.arange(Wst, dtype=np.float32)
    tail = read(frozen, compose((0, 0, Wst), got[-25], Wst), Wst)
    assert np.array_equal(tail[:3], frozen[7:])
    assert np.isneginf(tail[3:]).all()


def test_the_kernel_composes_by_the_quoted_rule():
    src = (Path(__file__).resolve().parents[1] / "poreover_tpu_torch" /
           "csrc" / "pair_search.cuh").read_text()
    body = re.search(r"void compose_shift\([^)]*\) \{(.*?)\n\}", src,
                     re.S).group(1)
    lines = [ln.strip() for ln in body.strip().splitlines()]
    assert tuple(lines) == RULE


def test_graveyard_slots_stay_in_age_order():
    """After every plan step of the plain graveyard engine the valid slots
    are 0 .. gn-1 with non-decreasing ages, through full graveyards,
    resumes and plans that step back past the storage window."""
    cases = exact_style_cases()
    plans, wsts = stuttered(cases, 3, 20)
    packed = tp.pack_pairs(cases, G=tp.EXACT_G, plans=plans, wst=wsts)
    tensors = tp._to_device(packed, "cpu")
    state, full = None, 0
    for i in range(int(packed["meta"][:, tp.M_N].max())):
        state = tp.planned_scan(*tensors, 5, 4, G=tp.EXACT_G,
                                grace=tp.EXACT_GRACE, return_state=True,
                                state=state, steps=(i, i + 1))
        for valid, age in zip(state["gvalid"].numpy(),
                              state["gage"].numpy()):
            n = int(valid.sum())
            assert valid[:n].all()
            assert (np.diff(age[:n]) >= 0).all()
            full += n == tp.EXACT_G
    assert full and int(state["gresume"].sum()) > 0
