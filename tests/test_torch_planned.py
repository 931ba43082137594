"""The PyTorch port's plain planned engine (the plain version of the CUDA
pair-beam kernel) against the JAX package's planned engine in float32.

Reference strings come from poreover_tpu.ops.beam2d_planned with
jax_enable_x64 off (the suite turns it on; the engine picks its dtype
from it), restored afterwards. Inputs: the five envelope cases of
tests/test_pallas.py, the anchor boxes of tests/data/boxes.npz whose plans
have at most 200 steps (16 of the 24; the CUDA smoke test runs all 24 on
the card), and two small simulator pairs through the real stages 1-3.
Table state after truncated plans matches key for key.
"""
import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.ops import beam2d_planned as jp

from poreover_tpu_torch.ops import beam2d_planned as tp

# the plain version runs many small ops: one intra-op thread is as fast
# and does not oversubscribe the CPU when test workers run in parallel
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def pallas_cases(S=5):
    """tests/test_pallas.py:cases(), from the same seeded generator, with S
    columns per row (5 as there; 8 for flip-flop tables)."""
    rng = np.random.default_rng(7)

    def softmax_log(T, S=S):
        x = rng.normal(size=(T, S)) * 2
        return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(
            np.float32)

    out = []
    for (U, V) in [(40, 300), (60, 50), (25, 25)]:
        y1, y2 = softmax_log(U), softmax_log(V)
        out.append((y1, y2, np.tile(np.array([0, V], np.int64), (U, 1))))
    U, V = 80, 90
    y1, y2 = softmax_log(U), softmax_log(V)
    env = np.stack([np.clip(np.arange(U) - 10, 0, V - 1),
                    np.clip(np.arange(U) + 15, 1, V)], 1).astype(np.int64)
    out.append((y1, y2, env))
    U, V = 420, 460
    y1, y2 = softmax_log(U), softmax_log(V)
    lo = np.clip(np.arange(U) - 8, 0, V - 1)
    hi = np.clip(np.arange(U) + 12, 1, V)
    lo[50:340], hi[50:340] = 40, 64
    lo[340:350], hi[340:350] = 40, 440
    out.append((y1, y2, np.stack([lo, hi], 1).astype(np.int64)))
    return out


def small_boxes(max_steps=200):
    d = np.load(os.path.join(HERE, "data", "boxes.npz"))
    out = []
    for i in range(int(d["n"])):
        y1, y2, env = d[f"y1_{i}"], d[f"y2_{i}"], d[f"env_{i}"]
        if len(tp.build_plan(env, len(y1), len(y2))["type"]) <= max_steps:
            out.append((y1, y2, env))
    return out


def sim_workloads(tmp_path, n, seed, lo, hi):
    """Stages 1-3 of the port on simulated pairs: (y1, y2, envelope)."""
    from poreover_tpu_torch.cli import build_parser
    from poreover_tpu_torch.decoding.pair import pair_decode_helper
    from poreover_tpu_torch.sim import write_pairs

    write_pairs(str(tmp_path), n, seed, lo, hi)
    out = []
    for i in range(n):
        args = build_parser().parse_args(
            ["pair-decode", f"s{i}_1.npy", f"s{i}_2.npy", "--dir",
             str(tmp_path), "--basecaller", "poreover",
             "--reverse_complement"])
        pair_decode_helper(args, lambda wl, *_: out.append(wl))
    assert len(out) == n
    return out


@pytest.fixture(scope="module")
def cases():
    cs = pallas_cases()
    with jax_f32():
        ref = [jp.beam_search_2d_planned(*c, beam_width=5) for c in cs]
    got = tp.beam_search_2d_planned_batch(cs, beam_width=5, device="cpu")
    return cs, ref, got


@pytest.mark.parametrize("i", range(5))
def test_case_matches_jax_f32(cases, i):
    _, ref, got = cases
    assert got[i] == ref[i]


def test_single_pair_entry(cases):
    cs, ref, _ = cases
    assert tp.beam_search_2d_planned(*cs[3], device="cpu") == ref[3]


def test_batch_composition_does_not_change_a_pair(cases):
    cs, ref, _ = cases
    got = tp.beam_search_2d_planned_batch([cs[4], cs[1]], device="cpu")
    assert got == [ref[4], ref[1]]


@pytest.fixture(scope="module")
def boxes():
    bx = small_boxes()
    with jax_f32():
        ref = jp.beam_search_2d_planned_batch(bx, beam_width=5)
    got = tp.beam_search_2d_planned_batch(bx, beam_width=5, device="cpu")
    return ref, got


@pytest.mark.parametrize("i", range(16))
def test_box_matches_jax_f32(boxes, i):
    ref, got = boxes
    assert len(ref) == 16
    assert got[i] == ref[i]


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    wl = sim_workloads(tmp_path_factory.mktemp("sim"), 2, seed=41, lo=120,
                       hi=160)
    with jax_f32():
        ref = jp.beam_search_2d_planned_batch(wl, beam_width=5)
    got = tp.beam_search_2d_planned_batch(wl, beam_width=5, device="cpu")
    return ref, got


@pytest.mark.parametrize("i", range(2))
def test_sim_pair_matches_jax_f32(sims, i):
    ref, got = sims
    assert len(got[i]) > 50
    assert got[i] == ref[i]


KEYS_EXACT = ("k1", "k2", "pk1", "pk2", "char", "pchar", "valid", "off0",
              "off1", "poff0", "poff1")
KEYS_CLOSE = ("score", "sweep0", "sweep1", "psweep0", "psweep1")


@pytest.mark.parametrize("n_steps", [1, 9, 33, 80])
def test_table_state_matches_jax(cases, n_steps):
    y1, y2, env = cases[0][3]
    with jax_f32():
        jst = tp.state_from_jax(jp.debug_state_after(y1, y2, env,
                                                     n_steps=n_steps))
    tst = tp.debug_state_after(y1, y2, env, n_steps=n_steps, device="cpu")
    for k in KEYS_EXACT:
        np.testing.assert_array_equal(np.asarray(jst[k]),
                                      np.asarray(tst[k]), err_msg=k)
    for k in KEYS_CLOSE:
        a, b = np.asarray(jst[k]), np.asarray(tst[k])
        assert a.shape == b.shape, k
        fa, fb = np.isfinite(a), np.isfinite(b)
        np.testing.assert_array_equal(fa, fb, err_msg=k)
        np.testing.assert_array_equal(a[~fa], b[~fb], err_msg=k)
        np.testing.assert_allclose(a[fa], b[fb], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_unported_branches_raise():
    y = np.log(np.full((4, 5), 0.2, np.float32))
    env = np.tile(np.array([0, 4], np.int64), (4, 1))
    with pytest.raises(NotImplementedError, match="A11"):
        tp.beam_search_2d_planned(y, y, env, exact=True, device="cpu")


@pytest.mark.parametrize("model,S", [("ctc_merge_repeats", 5),
                                     ("ctc_flipflop", 8)])
def test_bonito_and_flipflop_branches_decode(model, S):
    """The kinds that raised before (ROADMAP A2b) decode, to the JAX
    engine's string (tests/test_torch_planned_kinds.py has more cases)."""
    rng = np.random.default_rng(5)
    y1, y2 = (np.log(rng.dirichlet(np.ones(S), size=T)).astype(np.float32)
              for T in (12, 10))
    env = np.tile(np.array([0, 10], np.int64), (12, 1))
    with jax_f32():
        want = jp.beam_search_2d_planned(y1, y2, env, model=model)
    got = tp.beam_search_2d_planned(y1, y2, env, model=model, device="cpu")
    assert got == want and len(got) > 0


def test_empty_read_decodes_to_empty():
    y = np.log(np.full((4, 5), 0.2, np.float32))
    empty = np.zeros((0, 5), np.float32)
    env = np.tile(np.array([0, 4], np.int64), (4, 1))
    out = tp.beam_search_2d_planned_batch(
        [(y, empty, np.zeros((4, 2), np.int64)), (y, y, env)], device="cpu")
    assert out[0] == ""
    assert out[1] == tp.beam_search_2d_planned(y, y, env, device="cpu")
