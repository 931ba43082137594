"""Exact mode: the port's plain graveyard engine's state after n plan
steps against the JAX package's exact engine
(``poreover_tpu.ops.beam2d_planned._planned_scan(..., return_state=True)``
with G > 0), for the three model kinds, on tests/test_exact.py's cases
(seeded here the same way; tests/test_torch_exact.py holds the strings).

Keys, ages, validity, offsets and every integer of the state are held
exactly, key for key. The JAX engine runs with jax_enable_x64 off
(float32, the kernel's type; the suite turns x64 on, so each test restores
it). Sweep values are held within the tolerance of
tests/test_torch_planned.py's state test (rtol = atol = 1e-5, -inf at the
same places): JAX's ``jnp.cumsum`` of a window's weights adds in another
order than the port's float64 sums rounded once, which moves the last bits
of a value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poreover_tpu.ops import beam2d_planned as jp

from poreover_tpu_torch.ops import beam2d_planned as tp
from poreover_tpu_torch.sim import stuttered

from test_torch_exact import PLAN_KEYS, cases, jax_f32, plain

# the plain version runs many small ops: one intra-op thread is as fast
# and does not oversubscribe the CPU when test workers run in parallel
torch.set_num_threads(1)


def _states(case, n_steps, model, plan=None, wst=None):
    """(JAX state, port state) after the first n_steps plan steps, the
    plan padded back to full length with zero-width C0RUN steps at the full
    plan's storage widths (as ``debug_state_after`` does)."""
    y1, y2, env = case
    y1 = np.asarray(y1, np.float32)
    y2 = np.asarray(y2, np.float32)
    full = plan or jp.build_plan(env, len(y1), len(y2))
    w0, w1 = wst or tp.plan_wst(full)
    N = len(full["type"])
    fills = dict(type=tp.C0RUN, a_lo=0, a_hi=0, b_lo=0, b_hi=0)
    cut = {k: np.concatenate([v[:n_steps], np.full(N - min(n_steps, N),
                                                  fills[k], v.dtype)])
           for k, v in full.items()}
    with jax_f32():
        st = jp._planned_scan(
            jnp.asarray(y1), jnp.asarray(y2),
            *(jnp.asarray(cut[k]) for k in PLAN_KEYS), jp._MODEL_IDS[model],
            5, 4, w0, w1, return_state=True, G=tp.EXACT_G,
            grace=tp.EXACT_GRACE)
        jst = tp.state_from_jax({k: np.asarray(v) for k, v in st.items()},
                                model)
    _, state = plain([(y1, y2, env)], tp.EXACT_G, tp.EXACT_GRACE, model,
                     plans=[cut], wst=[(w0, w1)])
    return jst, state


def _assert_states_equal(jst, state, model):
    assert set(jst) <= set(state)
    for k, a in jst.items():
        a = np.asarray(a)
        b = state[k][0].numpy()
        if model == "ctc" and k in tp._SWEEPS:
            b = b[:, 0]
        assert a.shape == b.shape, k
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        fa, fb = np.isfinite(a), np.isfinite(b)
        np.testing.assert_array_equal(fa, fb, err_msg=k)
        np.testing.assert_array_equal(a[~fa], b[~fb], err_msg=k)
        np.testing.assert_allclose(a[fa], b[fb], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("model,S", [("ctc", 5), ("ctc_merge_repeats", 5),
                                     ("ctc_flipflop", 8)])
@pytest.mark.parametrize("n_steps", [9, 40, 200])
def test_state_after_n_steps_matches_jax(model, S, n_steps):
    """The table, storage and graveyard (keys, ages, validity, storage)
    after n steps equal JAX ``_planned_scan(return_state=True)``'s key for
    key; 200 is past the plan's end. The graveyard is full by then."""
    jst, state = _states(cases(S)[1], n_steps, model)
    _assert_states_equal(jst, state, model)
    if n_steps >= 40:
        assert bool(state["gvalid"].all())


def test_state_on_a_plan_that_steps_back_matches_jax():
    """A plan whose windows move back (``sim.stuttered``;
    ``build_plan``'s walks never move back after their first step): rows
    buried before such a move resume after it, and the state still equals
    JAX's."""
    case = cases()[1]
    (plan,), (wst,) = stuttered([case])
    jst, state = _states(case, len(plan["type"]), "ctc", plan, wst)
    _assert_states_equal(jst, state, "ctc")
    assert int(state["gresume_back"][0]) > 0
