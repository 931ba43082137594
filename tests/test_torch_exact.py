"""Exact mode (``pair-decode --exact``): the port's plain graveyard engine
(``beam2d_planned.planned_scan`` with G > 0, the plain version of the pair
kernel's graveyard instance) against the JAX package's exact engine
(``poreover_tpu.ops.beam2d_planned._planned_scan`` with G > 0), the C++
grace oracle and the reference's unbounded trie, on tests/test_exact.py's
cases (seeded here the same way). Strings are held exactly; the JAX
engine runs with jax_enable_x64 off (float32, the kernel's type; the suite
turns x64 on, so each test restores it). The state after n steps:
tests/test_torch_exact_state.py.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poreover_tpu.ops import beam2d_planned as jp

from poreover_tpu_torch import native
from poreover_tpu_torch.ops import beam2d_planned as tp
from poreover_tpu_torch.sim import exact_style_cases

# the plain version runs many small ops: one intra-op thread is as fast
# and does not oversubscribe the CPU when test workers run in parallel
torch.set_num_threads(1)

PLAN_KEYS = ("type", "a_lo", "a_hi", "b_lo", "b_hi")


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def cases(S=5):
    """tests/test_exact.py:cases() (seed 21), with S columns per row."""
    return exact_style_cases(S)


def plain(pairs, G, grace, model="ctc", plans=None, wst=None):
    """The plain engine on a batch: (strings, final state)."""
    packed = tp.pack_pairs(pairs, 5, model=model, G=G, plans=plans,
                           wst=wst)
    state = tp.planned_scan(*tp._to_device(packed, "cpu"), 5, 4,
                            return_state=True, model_id=packed["model_id"],
                            G=G, grace=grace)
    prov, score, valid = tp.scan_outputs(state, packed["meta"], 5)
    return tp.tracebacks(packed, prov.numpy(), score.numpy(),
                         valid.numpy()), state


@pytest.mark.parametrize("grace", [2, 4, 8, 20])
def test_graveyard_matches_grace_oracle(grace):
    """test_exact.py's grace test: G = 32 graveyard rows, held to the C++
    grace oracle (float64) and to the JAX engine (float32)."""
    cs = cases()
    got, state = plain(cs, 32, grace)
    with jax_f32():
        want_jax = _jax_strings(cs, 32, grace)
    for c, g, j in zip(cs, got, want_jax):
        assert g == native.pair_beam_row_col_cpu_emul_grace(
            *c, beam_width=5, grace=grace)
        assert g == j
    if grace == 20:
        # rows live long enough to fill the graveyard, which turns some away
        assert int(state["gfull"].sum()) > 0


def _jax_strings(cs, G, grace):
    """The JAX exact engine's strings of a batch (float32): its vmapped
    scan, plans padded with zero-width C0RUN steps to a common length and
    storage widths to the widest, as ``beam_search_2d_planned_batch``
    pads them (one compile per grace)."""
    plans = [jp.build_plan(env, len(y1), len(y2)) for y1, y2, env in cs]
    N = max(len(p["type"]) for p in plans)
    w0 = max(tp.plan_wst(p)[0] for p in plans)
    w1 = max(tp.plan_wst(p)[1] for p in plans)
    fills = dict(type=tp.C0RUN, a_lo=0, a_hi=0, b_lo=0, b_hi=0)

    def stack(k):
        return jnp.asarray(np.stack([np.concatenate(
            [p[k], np.full(N - len(p[k]), fills[k], p[k].dtype)])
            for p in plans]))

    def pady(y, T):
        return np.pad(y, ((0, T - len(y)), (0, 0)), constant_values=-np.inf)

    T1 = max(len(c[0]) for c in cs)
    T2 = max(len(c[1]) for c in cs)
    first, chars = jp._planned_scan_batch(
        jnp.asarray(np.stack([pady(c[0], T1) for c in cs]), jnp.float32),
        jnp.asarray(np.stack([pady(c[1], T2) for c in cs]), jnp.float32),
        *(stack(k) for k in PLAN_KEYS), 0, 5, 4, w0, w1, G=G, grace=grace)
    out = []
    for b in range(len(cs)):
        ids = [int(first[b])] + [int(c) for c in np.asarray(chars[b])]
        out.append("".join("ACGT"[c] for c in ids if c >= 0))
    return out


def test_exact_mode_matches_unbounded_trie():
    cs = cases()
    got = tp.beam_search_2d_planned_batch(cs, exact=True, device="cpu")
    for c, g in zip(cs, got):
        assert g == native.pair_beam_row_col_cpu(*c, beam_width=5)


def test_grace1_unchanged():
    """G > 0 with grace 1 reproduces the windowed engine."""
    cs = cases()
    assert plain(cs, 16, 1)[0] == tp.beam_search_2d_planned_batch(
        cs, device="cpu")


def test_segmented_exact_batch_bit_identical():
    """The segmented entry (the search state carried across runs of 64
    plan steps) equals the one-launch batch, and both the JAX package's
    exact batch."""
    cs = cases()
    want = tp.beam_search_2d_planned_batch(cs, exact=True, device="cpu")
    assert tp.beam_search_2d_planned_batch_seg(
        cs, exact=True, seg=64, device="cpu") == want
    with jax_f32():
        assert jp.beam_search_2d_planned_batch(cs, exact=True) == want


def test_batched_equals_per_pair():
    cs = cases()
    got = tp.beam_search_2d_planned_batch(cs, exact=True, device="cpu")
    assert got == [tp.beam_search_2d_planned(*c, exact=True, device="cpu")
                   for c in cs]
    # a pair's string does not depend on the batch it rides in
    assert tp.beam_search_2d_planned_batch(
        cs[::-1] + cs[:1], exact=True, device="cpu") == got[::-1] + got[:1]
