"""The box-beam wrapper (ops/box_beam.py) on the CPU, where it runs the
kernel's plain version: host prep and the storage limit, string equality
with the JAX package's plan-driven f32 engine on the real anchor boxes of
tests/data/boxes.npz with plans of at most 200 steps (each box alone and
grouped as the JAX package's ``batched_box_decode`` groups them), independence of box order and of
the grid cap, rerouting under a lowered limit, degenerate boxes, whole
pairs through the box engine, and the launcher's argument checks.
Tolerance: strings and integer outputs exact."""
import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.decoding import pair as jpair
from poreover_tpu.ops import beam2d_planned as jp

from poreover_tpu_torch.decoding import pair as tpair
from poreover_tpu_torch.ops import beam2d_planned as tp
from poreover_tpu_torch.ops import box_beam as bb
from poreover_tpu_torch.ops import pair_beam_batch as pbb

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


def all_boxes():
    d = np.load(os.path.join(HERE, "data", "boxes.npz"))
    return [(d[f"y1_{i}"], d[f"y2_{i}"], d[f"env_{i}"])
            for i in range(int(d["n"]))]


def small_boxes(max_steps=200):
    return [b for b in all_boxes()
            if len(tp.build_plan(b[2], len(b[0]), len(b[1]))["type"])
            <= max_steps]


def lp(rng, T):
    x = rng.normal(size=(T, 5)) * 2
    return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32)


def synth_pairs():
    rng = np.random.default_rng(3)
    out = []
    for U, V in ((30, 40), (55, 35), (20, 20)):
        env = np.stack([np.clip(np.arange(U) * V // U - 6, 0, V - 1),
                        np.clip(np.arange(U) * V // U + 8, 1, V)], 1)
        out.append((lp(rng, U), lp(rng, V), env.astype(np.int64)))
    return out


# ---- host prep and the storage limit

def test_prepare_box_plan_and_widths():
    for y1, y2, env in small_boxes():
        pb = bb.prepare_box(y1, y2, env)
        plan = tp.build_plan(env, len(y1), len(y2))
        assert pb["wst"] == tp.plan_wst(plan)
        assert pb["n"] == len(plan["type"])
        np.testing.assert_array_equal(pb["plan"]["type"], plan["type"])
        assert pb["storage"] == 16 * 25 * sum(pb["wst"])
        assert pb["storage"] <= bb.STORAGE_LIMIT_BYTES


def test_prepare_box_over_the_limit_is_none():
    """Of the 24 real boxes one (U 3274, V 2521, storage widths 382 + 116)
    needs more shared memory than the kernel's static budget."""
    over = [i for i, b in enumerate(all_boxes())
            if bb.prepare_box(*b) is None]
    assert over == [11]


def test_prepare_box_limit_is_the_named_constant(monkeypatch):
    y1, y2, env = small_boxes()[5]
    need = bb.prepare_box(y1, y2, env)["storage"]
    monkeypatch.setattr(bb, "STORAGE_LIMIT_BYTES", need)
    assert bb.prepare_box(y1, y2, env) is not None
    monkeypatch.setattr(bb, "STORAGE_LIMIT_BYTES", need - 1)
    assert bb.prepare_box(y1, y2, env) is None


def test_storage_limit_leaves_two_ctas_per_sm():
    """Two CTAs, each with the search's static shared memory (7824 B, as
    ptxas reports it for csrc/box_beam.cu) and 1 KB the system reserves,
    fit an SM's 228 KB at the limit."""
    assert 2 * (bb.STORAGE_LIMIT_BYTES + 7824 + 1024) <= 228 * 1024


def test_prepare_box_empty_read():
    rng = np.random.default_rng(0)
    pb = bb.prepare_box(lp(rng, 6), np.zeros((0, 5), np.float32),
                        np.zeros((6, 2), np.int64))
    assert pb is not None and pb["n"] == 0 and pb["plan"] is None


# ---- strings against the JAX engine on the real boxes

@pytest.fixture(scope="module")
def real():
    bx = small_boxes()
    with jax_f32():
        grouped = jpair.batched_box_decode(bx, beam_width=5)
    got, over = bb.box_beam(bx, beam_width=5, device="cpu")
    assert over == []
    return bx, grouped, got


@pytest.mark.parametrize("i", range(16))
def test_box_equals_jax_grouped_and_alone(real, i):
    """Off the TPU the JAX package decodes boxes in waves of 32 sorted by
    length, each wave padded to its widest storage; a box alone has its
    own widths. The port gives every box its own widths. All three agree."""
    bx, grouped, got = real
    assert len(bx) == 16
    with jax_f32():
        alone = jp.beam_search_2d_planned_batch([bx[i]], beam_width=5)[0]
    assert grouped[i] == alone
    assert got[i] == alone
    assert bb.box_beam([bx[i]], device="cpu")[0] == [alone]


def test_box_order_and_grid_cap_do_not_change_a_box(real):
    bx, _, got = real
    rev, over = bb.box_beam(bx[::-1], device="cpu", max_ctas=2)
    assert over == [] and rev[::-1] == got
    rng = np.random.default_rng(4)
    perm = rng.permutation(len(bx))
    shuffled, _ = bb.box_beam([bx[j] for j in perm], device="cpu",
                              max_ctas=1)
    assert shuffled == [got[j] for j in perm]


def test_queue_is_longest_plan_first(real):
    bx, _, _ = real
    prep = bb.prepare_boxes(bx, device="cpu")
    n = prep["meta"][:, tp.M_N]
    assert list(n) == sorted(n, reverse=True)
    assert sorted(prep["order"]) == list(range(len(bx)))


def test_lowered_limit_reroutes_and_changes_no_string(real, monkeypatch):
    bx, _, got = real
    monkeypatch.setattr(bb, "STORAGE_LIMIT_BYTES", 30000)
    seqs, over = bb.box_beam(bx, device="cpu")
    assert 0 < len(over) < len(bx)
    assert [i for i, s in enumerate(seqs) if s is None] == over
    assert all(seqs[i] == got[i] for i in range(len(bx)) if i not in over)
    assert tpair.batched_box_decode(bx, beam_width=5, device="cpu") == got


def test_everything_over_the_limit(real, monkeypatch):
    bx, _, got = real
    monkeypatch.setattr(bb, "STORAGE_LIMIT_BYTES", 0)
    seqs, over = bb.box_beam(bx[:4], device="cpu")
    assert seqs == [None] * 4 and over == [0, 1, 2, 3]
    assert tpair.batched_box_decode(bx[:4], device="cpu") == got[:4]


# ---- degenerate boxes

def test_one_row_boxes(real):
    bx, grouped, got = real
    ones = [i for i, b in enumerate(bx) if len(b[0]) == 1]
    assert len(ones) == 5
    assert [got[i] for i in ones] == [grouped[i] for i in ones]


def test_empty_read_box_decodes_to_nothing():
    """A box whose y2 slice is empty has an empty plan and decodes to "",
    alone and inside a batch. (The JAX package's off-TPU engine raises on
    such a batch; see ROADMAP C.)"""
    rng = np.random.default_rng(1)
    empty = (lp(rng, 6), np.zeros((0, 5), np.float32),
             np.zeros((6, 2), np.int64))
    other = (lp(rng, 5), lp(rng, 7), np.tile(np.array([0, 7]), (5, 1)))
    with jax_f32():
        want = jp.beam_search_2d_planned_batch([other], beam_width=5)[0]
        with pytest.raises(ValueError, match="zero-size"):
            jpair.batched_box_decode([empty, other], beam_width=5)
    assert bb.box_beam([empty], device="cpu") == ([""], [])
    assert tpair.batched_box_decode([empty, other], device="cpu") == [
        "", want]
    assert bb.box_beam([], device="cpu") == ([], [])


# ---- the plain version's outputs

def test_plain_outputs_and_final_pick():
    pairs = synth_pairs()
    prep = bb.prepare_boxes(pairs, device="cpu")
    prov, pick = bb.box_beam_plain(*prep["dev"], prep["W"], prep["A"])
    p2, score, valid = tp.planned_scan(*prep["dev"], 5, 4)
    assert prov.dtype == torch.int8 and pick.dtype == torch.int32
    assert torch.equal(prov, p2) and pick.shape == (3,)
    want = np.argmax(np.where(valid.numpy(), score.numpy(), -np.inf), 1)
    np.testing.assert_array_equal(pick.numpy(), want)
    meta = prep["meta"]
    for r in range(3):
        o, n = int(meta[r, tp.M_PLAN]), int(meta[r, tp.M_N])
        assert tp.walk_provenance(
            prov[o:o + n].numpy(), prep["types"][r], int(pick[r]), 5, 4,
            "ACGT") == tp.traceback(
                prov[o:o + n].numpy(), prep["types"][r], score[r].numpy(),
                valid[r].numpy(), 5, 4, "ACGT")


def test_final_pick_ties_to_the_lowest_slot():
    score = torch.tensor([[1.0, 3.0, 3.0, 9.0], [-1.0, -1.0, 0.0, 0.0],
                          [5.0, 5.0, 5.0, 5.0]])
    valid = torch.tensor([[True, True, True, False],
                          [True, True, False, False],
                          [False, False, False, False]])
    assert bb.final_pick(score, valid).tolist() == [1, 0, 0]


# ---- whole pairs through the box engine

def test_pair_beam_box_batch_equals_pair_beam_batch(monkeypatch):
    pairs = synth_pairs()
    want = pbb.pair_beam_batch(pairs, device="cpu")
    assert all(len(s) > 5 for s in want)
    assert bb.pair_beam_box_batch(pairs, device="cpu") == want
    # the second pair's storage over the limit: it goes to the pair engine
    need = [bb.prepare_box(*p)["storage"] for p in pairs]
    monkeypatch.setattr(bb, "STORAGE_LIMIT_BYTES", sorted(need)[1])
    prep = bb.prepare_pairs_box(pairs, device="cpu")
    assert len(prep["box"]["overflow"]) == 1
    assert bb.fetch_prepared_box(prep, bb.launch_prepared_box(prep)) == want


def test_full_lattice_pair_through_the_box_engine():
    rng = np.random.default_rng(8)
    y1, y2 = lp(rng, 12), lp(rng, 15)
    assert bb.pair_beam_box_batch([(y1, y2, None)], device="cpu") == [
        tp.beam_search_2d_planned(y1, y2, None, device="cpu")]


# ---- the launcher's checks

@pytest.fixture
def packed_cpu():
    prep = bb.prepare_boxes(synth_pairs(), device="cpu")
    return prep, [t.clone() for t in prep["dev"]]


def test_cpu_tensors_are_refused_by_the_kernel(packed_cpu):
    prep, args = packed_cpu
    before = bb.box_launch_count
    with pytest.raises(ValueError, match="expected cuda"):
        bb.box_beam_cuda(*args, prep["meta"], 5)
    assert bb.box_launch_count == before


@pytest.mark.parametrize("which,bad,exc", [
    (0, lambda t: t.double(), TypeError),
    (1, lambda t: t.half(), TypeError),
    (2, lambda t: t.long(), TypeError),
    (3, lambda t: t.int(), TypeError),
    (0, lambda t: t.view(1, -1), ValueError),
    (2, lambda t: t.t(), ValueError),
])
def test_bad_arguments_raise(packed_cpu, which, bad, exc):
    prep, args = packed_cpu
    args[which] = bad(args[which])
    with pytest.raises(exc):
        bb.box_beam_cuda(*args, prep["meta"], 5)


def test_unsupported_width_raises(packed_cpu):
    prep, args = packed_cpu
    with pytest.raises(ValueError, match="W\\*\\(A\\+1\\)"):
        bb.box_beam_cuda(*args, prep["meta"], 7)


def test_cpu_route_counts_no_launch(real):
    assert bb.box_launch_count == 0


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bb.box_beam(synth_pairs())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpair.batched_box_decode(synth_pairs())
