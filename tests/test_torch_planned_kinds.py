"""The port's plain planned engine (the plain version of the CUDA pair and
box kernels) for bonito (``ctc_merge_repeats``) and flip-flop
(``ctc_flipflop``) pairs, against the JAX package's planned engine in
float32.

Reference strings come from poreover_tpu.ops.beam2d_planned with
jax_enable_x64 off (the suite turns it on; the engine picks its dtype
from it), restored afterwards. Inputs: the random shapes of
tests/test_beam2d.py::TestPlanned (9 x S against 8 x S, alphabet AB, beam
width 4, a banded envelope) and small simulated ACGT pairs of each kind
through the port's stages 1-3. A pair decodes the same alone as in a batch
of mixed lengths, and the candidate table after truncated plans matches
the JAX engine's key for key, both state components within 1e-5.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.ops import beam2d_planned as jp

from poreover_tpu_torch.ops import beam2d_planned as tp

# the plain version runs many small ops: one intra-op thread is as fast
# and does not oversubscribe the CPU when test workers run in parallel
torch.set_num_threads(1)

KINDS = {"ctc_merge_repeats": "bonito", "ctc_flipflop": "flipflop"}


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def planned_shapes(model):
    """tests/test_beam2d.py::TestPlanned's random pairs (two trials)."""
    rng = np.random.default_rng(47)
    S = 4 if model == "ctc_flipflop" else 3
    env = np.array([(max(0, i - 2), min(i + 3, 8)) for i in range(9)])
    out = []
    for _ in range(2):
        y1 = rng.random((9, S))
        y2 = rng.random((8, S))
        out.append((np.log(y1 / y1.sum(1, keepdims=True)),
                    np.log(y2 / y2.sum(1, keepdims=True)), env))
    return out


def sim_workloads(tmp_path, kind, n=2, seed=41, lo=100, hi=120):
    """Stages 1-3 of the port on simulated pairs: (y1, y2, envelope)."""
    from poreover_tpu_torch.cli import build_parser
    from poreover_tpu_torch.decoding.pair import pair_decode_helper
    from poreover_tpu_torch.sim import write_pairs

    pairs, _ = write_pairs(str(tmp_path), n, seed, lo, hi, kind=kind)
    out = []
    for line in open(pairs):
        args = build_parser().parse_args(
            ["pair-decode", *line.split(), "--dir", str(tmp_path),
             "--basecaller", "flappie" if kind == "flipflop" else kind,
             "--reverse_complement", "--device", "cpu"])
        pair_decode_helper(args, lambda wl, *_: out.append(wl))
    assert len(out) == n
    return out


def head(pair, n):
    """The first n rows of read 1 with the part of read 2 their envelope
    reaches: a shorter pair."""
    y1, y2, env = pair
    V = int(env[n - 1, 1])
    return y1[:n], y2[:V], np.clip(env[:n], 0, V)


N_STEPS = (1, 9, 33, 80)


@pytest.fixture(scope="module", params=sorted(KINDS))
def kind_runs(request, tmp_path_factory):
    model = request.param
    small = planned_shapes(model)
    sims = sim_workloads(tmp_path_factory.mktemp(KINDS[model]), KINDS[model])
    short = head(sims[1], 60)
    with jax_f32():
        ref_small = [jp.beam_search_2d_planned(*c, beam_width=4,
                                               alphabet="AB", model=model)
                     for c in small]
        ref_sims = jp.beam_search_2d_planned_batch(sims, beam_width=5,
                                                   model=model)
        tables = {n: tp.state_from_jax(jp.debug_state_after(
            *short, n_steps=n, model=model), model) for n in N_STEPS}
    # the port: the two pairs with a short one between them, one batch of
    # mixed lengths (each pair its own plan length and storage widths)
    mixed = tp.beam_search_2d_planned_batch([sims[1], short, sims[0]],
                                            model=model, device="cpu")
    return dict(model=model, small=small, short=short, mixed=mixed,
                ref_small=ref_small, ref_sims=ref_sims, tables=tables)


@pytest.mark.parametrize("i", range(2))
def test_planned_shapes_match_jax_f32(kind_runs, i):
    r = kind_runs
    got = tp.beam_search_2d_planned(*r["small"][i], beam_width=4,
                                    alphabet="AB", model=r["model"],
                                    device="cpu")
    assert got == r["ref_small"][i]


@pytest.mark.parametrize("i", range(2))
def test_sim_pair_matches_jax_f32(kind_runs, i):
    r = kind_runs
    got = r["mixed"][2 - 2 * i]
    assert len(got) > 50
    assert got == r["ref_sims"][i]


def test_mixed_lengths_batch_decodes_each_pair_as_alone(kind_runs):
    r = kind_runs
    alone = tp.beam_search_2d_planned(*r["short"], model=r["model"],
                                      device="cpu")
    assert len(alone) > 5
    assert r["mixed"][1] == alone


KEYS_EXACT = ("k1", "k2", "pk1", "pk2", "char", "pchar", "valid", "off0",
              "off1", "poff0", "poff1")
KEYS_CLOSE = ("score", "sweep0", "sweep1", "psweep0", "psweep1")


@pytest.mark.parametrize("n_steps", N_STEPS)
def test_table_state_matches_jax(kind_runs, n_steps):
    r = kind_runs
    jst = r["tables"][n_steps]
    tst = tp.debug_state_after(*r["short"], n_steps=n_steps,
                               model=r["model"], device="cpu")
    assert tst["sweep0"].ndim == 3 and tst["sweep0"].shape[1] == 2
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
