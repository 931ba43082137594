"""The CUDA kernels' wrappers (ops/pair_beam_batch.py, ops/box_beam.py,
ops/beam1d.py, ops/viterbi.py).

On the CPU: argument checks, the packed layout both the pair-beam kernel
and its plain version read, and the plain route (the 1D kernel's CPU side
is in tests/test_torch_beam1d.py, the box kernel's in
tests/test_torch_box_beam.py). Tests marked ``cuda`` build and launch
each kernel and hold it against its plain version on the card; they
skip without one (run them with ``python -m pytest --noconftest -m cuda
tests/test_torch_kernel.py`` on a CUDA machine, where ``tests/conftest.py``
would import jax; ``python3 chip_smoke.py`` covers the same ground at full
size).
"""
import numpy as np
import pytest
import torch

from poreover_tpu_torch.ops import beam1d
from poreover_tpu_torch.ops import beam2d
from poreover_tpu_torch.ops import beam2d_planned as tp
from poreover_tpu_torch.ops import box_beam as bb
from poreover_tpu_torch.ops import pair_beam_batch as pbb
from poreover_tpu_torch.sim import exact_style_cases, stuttered

# the plain version runs many small ops: one intra-op thread is as fast
# and does not oversubscribe the CPU when test workers run in parallel
torch.set_num_threads(1)


def _pairs():
    rng = np.random.default_rng(3)

    def lp(T):
        x = rng.normal(size=(T, 5)) * 2
        return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(
            np.float32)

    out = []
    for U, V in ((30, 40), (55, 35), (20, 20)):
        env = np.stack([np.clip(np.arange(U) * V // U - 6, 0, V - 1),
                        np.clip(np.arange(U) * V // U + 8, 1, V)], 1)
        out.append((lp(U), lp(V), env.astype(np.int64)))
    return out


@pytest.fixture
def packed_cpu():
    prep = pbb.prepare_pairs(_pairs(), device="cpu")
    return prep, [h.clone() for h in prep["host"]]


def test_cpu_tensors_are_refused_by_the_kernel(packed_cpu):
    prep, (p1, p2, plan, meta) = packed_cpu
    with pytest.raises(ValueError, match="expected cuda"):
        pbb.pair_beam_cuda(p1, p2, plan, meta, prep["meta"], 5)


@pytest.mark.parametrize("which,bad,exc", [
    (0, lambda t: t.double(), TypeError),
    (2, lambda t: t.long(), TypeError),
    (3, lambda t: t.int(), TypeError),
    (0, lambda t: t.view(1, -1), ValueError),
    (2, lambda t: t.t(), ValueError),
])
def test_bad_arguments_raise(packed_cpu, which, bad, exc):
    prep, args = packed_cpu
    args[which] = bad(args[which])
    with pytest.raises(exc):
        pbb.pair_beam_cuda(*args, prep["meta"], 5)


def test_unsupported_width_raises(packed_cpu):
    prep, args = packed_cpu
    with pytest.raises(ValueError, match="W\\*\\(A\\+1\\)"):
        pbb.pair_beam_cuda(*args, prep["meta"], 7)


def test_packed_layout(packed_cpu):
    prep, (p1, p2, plan, meta) = packed_cpu
    m = prep["meta"]
    assert m.shape == (3, tp.META_COLS)
    assert plan.shape == (int(m[:, tp.M_N].sum()), 5)
    for b, (y1, y2, env) in enumerate(_pairs()):
        T, L, o = m[b, tp.M_T1], m[b, tp.M_L1], m[b, tp.M_Y1]
        assert (T, L) == (len(y1), len(y1) + 1)
        plane = p1[o:o + 6 * L].view(6, L).numpy()
        np.testing.assert_array_equal(plane[:5, :T], y1.T)
        assert np.all(np.isneginf(plane[:5, T]))
        assert plane[5, 0] == 0.0
        np.testing.assert_allclose(plane[5, 1:], np.cumsum(y1[:, 4]),
                                   rtol=1e-5)
        want = tp.build_plan(env, len(y1), len(y2))
        o, n = m[b, tp.M_PLAN], m[b, tp.M_N]
        np.testing.assert_array_equal(plan[o:o + n, 0].numpy(), want["type"])
        assert (m[b, tp.M_WST0], m[b, tp.M_WST1]) == tp.plan_wst(want)


def test_cpu_route_is_the_plain_version():
    before = pbb.launch_count
    pairs = _pairs()
    got = pbb.pair_beam_batch(pairs, device="cpu")
    assert got == tp.beam_search_2d_planned_batch(pairs, device="cpu")
    assert got == [tp.beam_search_2d_planned(*p, device="cpu") for p in pairs]
    assert pbb.launch_count == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    pairs = _pairs()
    prep = pbb.prepare_pairs(pairs, device=cuda_device)
    k = pbb.pair_beam_cuda(*prep["dev"], prep["meta"], 5)
    p = tp.planned_scan(*prep["dev"], 5, 4)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b.cpu())
    assert pbb.fetch_prepared(prep, k) == tp.beam_search_2d_planned_batch(
        pairs, device=cuda_device)


@pytest.mark.cuda
def test_main_path_counts_launches(cuda_device):
    before = pbb.launch_count
    pbb.pair_beam_batch(_pairs(), device=cuda_device)
    assert pbb.launch_count == before + 1


@pytest.mark.cuda
def test_single_pair_entry_launches_one_cta(cuda_device):
    y1, y2, env = _pairs()[0]
    before = (pbb.launch_count, pbb.single_launch_count)
    got = beam2d.beam_search_2d(y1, y2, env, beam_width=5, method="row_col",
                                device=cuda_device)
    assert (pbb.launch_count, pbb.single_launch_count) == \
        (before[0], before[1] + 1)
    assert got == tp.beam_search_2d_planned(y1, y2, env, device=cuda_device)


def _lp(rng, T):
    x = rng.normal(size=(T, 5)) * 2
    return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32)


def narrow_pair():
    """A pair whose every window is at most NARROW_MAX columns: the
    kernel sweeps it on its register path only."""
    rng = np.random.default_rng(11)
    U, V = 70, 80
    c = np.arange(U) * V // U
    env = np.stack([np.clip(c - 5, 0, V - 1), np.clip(c + 6, 1, V)], 1)
    return _lp(rng, U), _lp(rng, V), env.astype(np.int64)


def wide_pair():
    """A pair whose windows are all wider than NARROW_MAX columns but at
    the envelope's far corner, where every window closes (its last
    NARROW_MAX plan steps): the kernel's general path."""
    rng = np.random.default_rng(12)
    U = V = 120
    c = np.arange(U)
    env = np.stack([np.clip(c - 70, 0, V - 1), np.clip(c + 70, 1, V)], 1)
    return _lp(rng, U), _lp(rng, V), env.astype(np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("make", [narrow_pair, wide_pair])
def test_kernels_bit_equal_on_each_sweep_path(cuda_device, make):
    """Both pair kernels hold provenance, final scores (bits) and picks
    equal to their plain versions on a pair of each sweep path."""
    pair = make()
    prep = pbb.prepare_pairs([pair], device=cuda_device)
    k = pbb.pair_beam_cuda(*prep["dev"], prep["meta"], 5)
    p = tp.planned_scan(*prep["dev"], 5, 4)
    torch.cuda.synchronize()
    assert torch.equal(k[0].cpu(), p[0].cpu())
    assert torch.equal(k[1].cpu().view(torch.int32),
                       p[1].cpu().view(torch.int32))
    assert torch.equal(k[2].cpu(), p[2].cpu())
    bprep = bb.prepare_boxes([pair, pair], device=cuda_device)
    kb = bb.launch_boxes(bprep)
    pb = bb.box_beam_plain(*bprep["dev"], 5, 4)
    torch.cuda.synchronize()
    for a, b in zip(kb, pb):
        assert torch.equal(a.cpu(), b.cpu())


def _kind_pair(shape, S):
    """A pair with S columns per row (5 for bonito, 8 for flip-flop):
    narrow_pair's envelope, or a band of 57 columns, whose windows the
    kernel sweeps on its general path and whose two-component storage
    (100 KB) still fits the box kernel's limit."""
    rng = np.random.default_rng(13 + S)

    def lp(T):
        x = rng.normal(size=(T, S)) * 2
        return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(
            np.float32)

    if shape == "narrow":
        env = narrow_pair()[2]
    else:
        c = np.arange(120)
        env = np.stack([np.clip(c - 28, 0, 119), np.clip(c + 29, 1, 120)],
                       1).astype(np.int64)
    return lp(len(env)), lp(int(env[:, 1].max())), env


@pytest.mark.parametrize("model,S,rows", [("ctc_merge_repeats", 5, 5),
                                          ("ctc_flipflop", 8, 8)])
def test_packed_layout_of_the_two_component_kinds(model, S, rows):
    """A bonito plane is the emissions and the gap, a flip-flop plane the
    flips and the flops (no root row: their root holds a value at t = -1
    only); each candidate's storage has two components, so the scratch and
    a box's storage double."""
    pair = _kind_pair("narrow", S)
    packed = tp.pack_pairs([pair], model=model)
    T1 = len(pair[0])
    plane = packed["planes1"].reshape(rows, T1 + 1)
    np.testing.assert_array_equal(plane[:, :T1], pair[0].T)
    assert np.all(np.isneginf(plane[:, T1]))
    w0, w1 = (int(x) for x in packed["meta"][0, tp.M_WST0:tp.M_WST1 + 1])
    assert packed["scratch_floats"] == 8 * 25 * (w0 + w1)
    assert bb.storage_bytes((w0, w1), 5, model_id=packed["model_id"]) == \
        2 * bb.storage_bytes((w0, w1), 5)


@pytest.mark.parametrize("model,S", [("ctc_merge_repeats", 5),
                                     ("ctc_flipflop", 8)])
def test_kind_boxes_over_the_limit_take_the_pair_route(model, S,
                                                       monkeypatch):
    """Anchored mode's boxes of a kind over the box kernel's storage limit
    go through the pair kernel of the same kind (here both plain)."""
    from poreover_tpu_torch.decoding.pair import batched_box_decode

    boxes = [_kind_pair("narrow", S), _kind_pair("wide", S)]
    want = [tp.beam_search_2d_planned(*b, model=model, device="cpu")
            for b in boxes]
    need = [bb.prepare_box(*b, model=model)["storage"] for b in boxes]
    assert max(need) <= bb.STORAGE_LIMIT_BYTES
    monkeypatch.setattr(bb, "STORAGE_LIMIT_BYTES", min(need))
    _, over = bb.box_beam(boxes, device="cpu", model=model)
    assert over == [int(np.argmax(need))]
    assert batched_box_decode(boxes, device="cpu", model=model) == want


@pytest.mark.cuda
@pytest.mark.parametrize("model,S", [("ctc_merge_repeats", 5),
                                     ("ctc_flipflop", 8)])
@pytest.mark.parametrize("shape", ["narrow", "wide"])
def test_kind_kernels_bit_equal_on_each_sweep_path(cuda_device, model, S,
                                                   shape):
    """The bonito and flip-flop instances of both pair kernels hold
    provenance, final scores (bits) and picks equal to their plain
    versions, with the storage in shared memory and in global scratch."""
    pair = _kind_pair(shape, S)
    prep = pbb.prepare_pairs([pair], device=cuda_device, model=model)
    mid = prep["model_id"]
    k = pbb.pair_beam_cuda(*prep["dev"], prep["meta"], 5, model_id=mid)
    kg = pbb._launch(*prep["dev"], prep["meta"], 5, 4, in_smem=False,
                     model_id=mid)
    p = tp.planned_scan(*prep["dev"], 5, 4, model_id=mid)
    torch.cuda.synchronize()
    for got in (k, kg):
        assert torch.equal(got[0].cpu(), p[0].cpu())
        assert torch.equal(got[1].cpu().view(torch.int32),
                           p[1].cpu().view(torch.int32))
        assert torch.equal(got[2].cpu(), p[2].cpu())
    bprep = bb.prepare_boxes([pair, pair], device=cuda_device, model=model)
    kb = bb.launch_boxes(bprep)
    pb = bb.box_beam_plain(*bprep["dev"], 5, 4, mid)
    torch.cuda.synchronize()
    for a, b in zip(kb, pb):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("model,S", [("ctc_merge_repeats", 5),
                                     ("ctc_flipflop", 8)])
def test_kind_entries_count_their_launches(cuda_device, model, S):
    pair = _kind_pair("narrow", S)
    before = (pbb.launch_count, pbb.single_launch_count)
    got = pbb.pair_beam_batch([pair], device=cuda_device, model=model)
    one = beam2d.beam_search_2d(*pair, beam_width=5, model=model,
                                method="row_col", device=cuda_device)
    assert (pbb.launch_count, pbb.single_launch_count) == \
        (before[0] + 1, before[1] + 1)
    assert got == [one] == tp.beam_search_2d_planned_batch(
        [pair], model=model, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("mask_mode", ["additive", "hard"])
def test_viterbi_kernel_matches_plain_on_card(cuda_device, mask_mode):
    """The Viterbi kernel's paths equal its plain version's, on the card
    and on the CPU, for reads of mixed lengths in one launch (T = 1 and 2,
    the forward's 32-step register chunks and the traceback's 512-step
    segments +- 1), for S = 8 (the flip-flop mask) and S = 1..7 (a seeded
    0/1 mask)."""
    from poreover_tpu_torch.models.transducer import flipflop_transition_mask
    from poreover_tpu_torch.ops import viterbi as tv

    lengths = (1, 2, 31, 32, 33, 34, 63, 64, 65, 300, 512, 513, 514, 1025,
               3000)
    for S in range(1, 9):
        rng = np.random.default_rng(4 + S)
        ys = [np.log(rng.dirichlet(np.ones(S), size=T)).astype(np.float32)
              for T in lengths]
        mask = flipflop_transition_mask() if S == 8 else np.maximum(
            rng.integers(0, 2, (S, S)), np.eye(S, dtype=int))
        before = tv.launch_count
        got = tv.viterbi_path_masked_batch(ys, mask, mask_mode,
                                           device=cuda_device)
        assert tv.launch_count == before + 1
        want = tv.viterbi_path_masked_batch(ys, mask, mask_mode,
                                            device="cpu")
        for y, g, w in zip(ys, got, want):
            np.testing.assert_array_equal(g, w)
            yd = torch.as_tensor(y, device=cuda_device)[None]
            trans = tv._trans(mask, mask_mode, torch.float32, yd.device)
            np.testing.assert_array_equal(
                g, tv._viterbi_masked_padded(yd, [len(y)], trans)[0])


def _small_boxes():
    """The pairs above as boxes, one-row boxes and an empty-read box."""
    rng = np.random.default_rng(5)

    def lp(T):
        x = rng.normal(size=(T, 5)) * 2
        return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(
            np.float32)

    out = _pairs() * 3
    out += [(lp(1), lp(V), np.array([[0, V]], np.int64)) for V in (9, 13)]
    out.append((lp(4), np.zeros((0, 5), np.float32),
                np.zeros((4, 2), np.int64)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("max_ctas", [None, 1, 2])
def test_box_kernel_matches_plain_on_card(cuda_device, max_ctas):
    """Provenance and final picks are equal at every grid size: with one
    CTA all boxes run back to back in it, each from the t = 0 state."""
    boxes = _small_boxes()
    prep = bb.prepare_boxes(boxes, device=cuda_device)
    before = bb.box_launch_count
    k = bb.launch_boxes(prep, max_ctas=max_ctas)
    assert bb.box_launch_count == before + 1
    assert prep["info"]["grid"] == min(max_ctas or 99, len(boxes) - 1)
    p = bb.box_beam_plain(*prep["dev"], 5, 4)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b.cpu())
    got = bb.fetch_boxes(prep, k)
    assert got[-1] == "" and got == [
        tp.beam_search_2d_planned(*b, device=cuda_device) if len(b[1])
        else "" for b in boxes]


@pytest.mark.cuda
def test_box_kernel_limit_and_reroute_on_card(cuda_device, monkeypatch):
    from poreover_tpu_torch.decoding.pair import batched_box_decode

    boxes = _small_boxes()
    want, over = bb.box_beam(boxes, device=cuda_device)
    assert over == []
    need = sorted(bb.prepare_box(*b)["storage"] for b in boxes)
    monkeypatch.setattr(bb, "STORAGE_LIMIT_BYTES", need[len(need) // 2])
    counts = (bb.box_launch_count, pbb.launch_count)
    assert batched_box_decode(boxes, device=cuda_device) == want
    assert (bb.box_launch_count, pbb.launch_count) == (counts[0] + 1,
                                                       counts[1] + 1)
    # the launcher itself refuses a box over the limit
    prep = bb.prepare_boxes(boxes, device=cuda_device)
    monkeypatch.setattr(bb, "STORAGE_LIMIT_BYTES", need[0])
    with pytest.raises(ValueError, match="bytes of storage"):
        bb.launch_boxes(prep)


@pytest.mark.cuda
def test_pair_beam_box_batch_on_card(cuda_device):
    pairs = _pairs()
    assert bb.pair_beam_box_batch(pairs, device=cuda_device) == \
        pbb.pair_beam_batch(pairs, device=cuda_device)


def _reads(S):
    rng = np.random.default_rng(7)

    def lp(T):
        x = rng.normal(size=(T, S)) * 2
        return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(
            np.float32)

    return [lp(T) for T in (300, 257, 512, 100, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("model,S", [("ctc", 5), ("ctc_merge_repeats", 5),
                                     ("ctc_flipflop", 8)])
@pytest.mark.parametrize("W", [25, 5])
def test_beam1d_kernel_matches_plain_on_card(cuda_device, model, S, W):
    """Provenance, chars and the final table are bit-equal: both run the
    same float32 ops in the same order."""
    from poreover_tpu_torch.ops.beam import beam_search_batch

    ys = _reads(S)
    prep = beam1d.prepare_beam1d(ys, beam_width=W, model=model,
                                 device=cuda_device)
    before = beam1d.launch_count
    k = beam1d.launch_beam1d(prep)
    assert beam1d.launch_count == before + 1
    p = beam1d.beam1d_plain(*prep["dev"], prep["meta"], W, 4,
                            prep["model_id"])
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b.cpu())
    assert beam1d.fetch_beam1d(prep, k) == beam_search_batch(
        ys, W, model=model, device=cuda_device)


def _beam1d_on_card(ys, W, model, device):
    """Kernel and plain version on the same prepared batch: every output
    equal, the float ones bit for bit."""
    prep = beam1d.prepare_beam1d(ys, beam_width=W, model=model,
                                 device=device)
    before = beam1d.launch_count
    k = beam1d.launch_beam1d(prep)
    assert beam1d.launch_count == before + 1
    p = beam1d.beam1d_plain(*prep["dev"], prep["meta"], W, 4,
                            prep["model_id"])
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    return beam1d.fetch_beam1d(prep, k)


@pytest.mark.cuda
@pytest.mark.parametrize("model,S", [("ctc", 5), ("ctc_merge_repeats", 5),
                                     ("ctc_flipflop", 8)])
@pytest.mark.parametrize("case", ["W=1", "T=1", "lengths 100x", "ties",
                                  "1056 reads"])
def test_beam1d_kernel_edge_cases_on_card(cuda_device, model, S, case):
    """W=1, reads of one step, lengths differing a hundredfold in one
    launch, constant emissions (every score tied), and a wave of 1056
    reads, for which the kernel takes its smallest hash tables: chars,
    provenance and the final table bit-equal to the plain version."""
    rng = np.random.default_rng(17)

    def lp(T):
        x = rng.normal(size=(T, S)) * 2
        return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(
            np.float32)

    W = 25
    if case == "W=1":
        ys, W = [lp(T) for T in (300, 1, 57)], 1
    elif case == "T=1":
        ys = [lp(1), lp(1), lp(2)]
    elif case == "lengths 100x":
        ys = [lp(7), lp(700), lp(7)]
    elif case == "1056 reads":
        ys = [lp(int(T)) for T in rng.integers(1, 120, 1056)]
        assert beam1d.hash_bits(len(ys), beam1d._MODEL_IDS[model],
                                cuda_device) < 12
    else:
        ys = [np.full((T, S), np.log(1.0 / S), np.float32)
              for T in (200, 3, 1)]
    strings = _beam1d_on_card(ys, W, model, cuda_device)
    assert len(strings) == len(ys)



def _acceptor_reads(S, seed=23):
    """Reads and labels for the acceptor kernel: a full 2002-step window
    (band 1000, T > 2002), T < 2 * band, a band narrower than T / L (band
    10, through the ``band`` argument), L = 0, L = 1, T = 1 and T < L; at
    band 1000 windows of W = T + 2 cells at 8, 16 and a warp slot's 32
    cells +- 1, at a 16-byte row of pointer bits (128 cells) and a warp's
    256 cells +- 1 and W = 2001, labels at the walk's 32-row batches +- 1;
    at band 1023 the widest window (2048 cells)."""
    rng = np.random.default_rng(seed)

    def lp(T):
        x = rng.normal(size=(T, S)) * 2
        return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(
            np.float32)

    def label(L):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, L))

    return [(lp(T), label(L)) for T, L in
            ((3000, 420), (700, 90), (50, 0), (50, 1), (1, 1), (5, 9),
             (300, 41), (6, 2), (7, 3), (13, 4), (14, 5), (15, 3),
             (29, 6), (30, 7), (31, 8), (125, 31), (126, 32), (127, 33),
             (253, 20), (254, 64), (255, 65), (1999, 300), (2100, 360))]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [5, 8])
@pytest.mark.parametrize("band", [1000, 10, 1023])
def test_acceptor_kernel_matches_plain_on_card(cuda_device, S, band):
    """The acceptor kernel against its plain version on the card, all
    reads in one launch: pointer bytes (the kernel's bits unpacked) and
    paths equal (tolerance 0), the launch counted once; and the CPU's plain
    version gives the same."""
    from poreover_tpu_torch.ops import acceptor as ta

    reads = _acceptor_reads(S)
    packed = ta.pack_acceptor([y for y, _ in reads], [l for _, l in reads],
                              band)
    on_card = ta.upload(packed, cuda_device)
    before = ta.launch_count
    k_bits, k_path = ta.acceptor_cuda(*on_card, packed["meta"], 4)
    torch.cuda.synchronize()
    assert ta.launch_count == before + 1
    k_ptr = ta.unpack_pointers(k_bits, packed["meta"])
    p_ptr, p_path = ta.acceptor_plain(*on_card, packed["meta"], 4)
    assert torch.equal(k_ptr, p_ptr) and torch.equal(k_path, p_path)
    c_ptr, c_path = ta.acceptor_plain(*ta.upload(packed, torch.device("cpu")),
                                      packed["meta"], 4)
    assert torch.equal(k_ptr.cpu(), c_ptr) and torch.equal(k_path.cpu(),
                                                           c_path)
    paths = ta.viterbi_acceptor_batch([y for y, _ in reads],
                                      [l for _, l in reads], band,
                                      device=cuda_device)
    for (y, label), path, (o, t) in zip(reads, paths,
                                        packed["meta"][:, :2].tolist()):
        assert np.array_equal(path, k_path.cpu().numpy()[o:o + t])
        if band == 1000 and len(y) >= len(label):
            # an open band: every label character has its step
            assert "".join("ACGT"[c] for c in path if c < 4) == label


def _ctc_batch(rng, T=120):
    """A CTC batch: seeded logits N(0, 2) and labels with an empty label, a
    label longer than T, repeated bases, logit lengths below T and 0."""
    rows = [(rng.integers(0, 4, 30), T), ([], T),
            (rng.integers(0, 4, T + 9), T), ([1] * 70, T),
            (rng.integers(0, 4, 20), 55), ([0, 0, 3, 3] * 9, T),
            (rng.integers(0, 4, 4), 0)]
    L = max(len(r) for r, _ in rows)
    labels = np.zeros((len(rows), L), np.int32)
    for i, (r, _) in enumerate(rows):
        labels[i, :len(r)] = r
    logits = rng.normal(0, 2, (len(rows), T, 5)).astype(np.float32)
    return (logits, labels, np.array([len(r) for r, _ in rows], np.int32),
            np.array([t for _, t in rows], np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("merge", [False, True])
def test_ctc_kernel_matches_plain_on_card(cuda_device, merge):
    """The CTC kernels against ``ctc_plain`` on the card: the loss and the
    gradient in logp bit-equal (the plain version repeats the kernels'
    float32 operations and the warp's summation order), one launch per
    pass."""
    from poreover_tpu_torch.ops import ctc

    logits, labels, lab_len, logit_len = _ctc_batch(
        np.random.default_rng(7 + merge))
    args = [torch.as_tensor(a).to(cuda_device)
            for a in (labels, lab_len, logit_len)]
    logp = ctc.log_softmax(torch.as_tensor(logits).to(cuda_device))
    out = []
    for fn in (ctc.ctc_cuda, ctc.ctc_plain):
        x = logp.detach().clone().requires_grad_(True)
        before = (ctc.launch_count, ctc.grad_launch_count)
        nll = fn(x, *args, merge)
        g, = torch.autograd.grad(nll.mean(), x)
        torch.cuda.synchronize()
        out.append((nll, g, (ctc.launch_count - before[0],
                             ctc.grad_launch_count - before[1])))
    (kn, kg, kl), (pn, pg, pl) = out
    assert kl == (1, 1) and pl == (0, 0)
    assert torch.equal(kn, pn) and torch.equal(kg, pg)
    assert torch.isfinite(kg).all() and (kn[2] > 9e4)


@pytest.mark.cuda
@pytest.mark.parametrize("merge,S", [(False, 31), (False, 32), (False, 33),
                                     (False, 1023), (False, 1025),
                                     (True, 31), (True, 33), (True, 1023),
                                     (True, 1025)])
def test_ctc_kernel_state_counts_bit_equal(cuda_device, merge, S):
    """State counts S on either side of a warp's 32 and of the 1024 threads
    a CTA holds (merging: S = 2 L + 1 is odd): the loss and the gradient
    bit-equal to ``ctc_plain``, beside rows with an empty label, a logit
    length of 0 and one below T."""
    from poreover_tpu_torch.ops import ctc

    rng = np.random.default_rng(S + 100 * merge)
    Lb = (S - 1) // 2 if merge else S - 1
    T = S + 12
    rows = [(rng.integers(0, 4, Lb), T), ([], T), (rng.integers(0, 4, Lb), 0),
            (rng.integers(0, 4, Lb), T // 2)]
    labels = np.zeros((len(rows), Lb), np.int32)
    for i, (r, _) in enumerate(rows):
        labels[i, :len(r)] = r
    args = [torch.as_tensor(a).to(cuda_device) for a in (
        labels, np.array([len(r) for r, _ in rows], np.int32),
        np.array([t for _, t in rows], np.int32))]
    logits = rng.normal(0, 2, (len(rows), T, 5)).astype(np.float32)
    logp = ctc.log_softmax(torch.as_tensor(logits).to(cuda_device))
    assert ctc.padded_states(Lb, merge) == 32 * -(-S // 32)
    out = []
    for fn in (ctc.ctc_cuda, ctc.ctc_plain):
        x = logp.detach().clone().requires_grad_(True)
        before = (ctc.launch_count, ctc.grad_launch_count)
        nll = fn(x, *args, merge)
        g, = torch.autograd.grad(nll.mean(), x)
        torch.cuda.synchronize()
        out.append((nll, g, (ctc.launch_count - before[0],
                             ctc.grad_launch_count - before[1])))
    (kn, kg, kl), (pn, pg, pl) = out
    assert kl == (1, 1) and pl == (0, 0)
    assert torch.equal(kn, pn) and torch.equal(kg, pg)
    assert torch.isfinite(kg).all()
    assert torch.all(kg[2] == 0) and torch.all(kg[3, T // 2:] == 0)


@pytest.mark.cuda
def test_ctc_loss_on_card_goes_through_the_kernels(cuda_device):
    """``ctc_loss`` on CUDA logits launches the kernels and agrees with the
    CPU's plain route (loss within 1e-5 relative, gradient in the logits
    within 1e-5)."""
    from poreover_tpu_torch.ops import ctc

    logits, labels, lab_len, logit_len = _ctc_batch(np.random.default_rng(9))
    res = []
    for dev in (cuda_device, torch.device("cpu")):
        x = torch.as_tensor(logits).to(dev).requires_grad_(True)
        before = ctc.launch_count
        loss = ctc.ctc_loss(x, labels, lab_len, logit_len, True).mean()
        loss.backward()
        res.append((loss.item(), x.grad.cpu().numpy(),
                    ctc.launch_count - before))
    (lc, gc, nc), (lh, gh, nh) = res
    assert nc == 1 and nh == 0
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    np.testing.assert_allclose(gc, gh, rtol=0, atol=1e-5)


# ---- exact mode: the graveyard instances (EXACT_G rows), on
# tests/test_exact.py's cases (sim.exact_style_cases)

def test_exact_storage_counts_the_graveyard():
    """The graveyard's sweeps (2 buffers of K x G x Wst per read) add to
    the storage and the scratch, and decide shared or global memory."""
    assert pbb.storage_bytes((10, 20), 5) == 16 * 25 * 30
    assert pbb.storage_bytes((10, 20), 5, model_id=1, G=tp.EXACT_G) == (
        8 * 2 * (2 * 25 + tp.EXACT_G) * 30)
    pairs = exact_style_cases()
    win = tp.pack_pairs(pairs)
    ex = tp.pack_pairs(pairs, G=tp.EXACT_G)
    wst = ex["meta"][:, tp.M_WST0] + ex["meta"][:, tp.M_WST1]
    assert ex["scratch_floats"] == int(((4 * 25 + 2 * tp.EXACT_G) * wst).sum())
    assert win["scratch_floats"] == int((4 * 25 * wst).sum())
    prep = pbb.prepare_pairs(pairs, device="cpu", exact=True)
    assert (prep["G"], prep["grace"]) == (tp.EXACT_G, tp.EXACT_GRACE)
    assert pbb.storage_path(prep) == "shared"
    big = dict(prep, meta=prep["meta"].copy())
    big["meta"][0, tp.M_WST0] = 400
    assert pbb.storage_path(big) == "global"
    assert pbb.storage_path(dict(big, G=0)) == "shared"


def test_exact_cpu_route_is_the_plain_graveyard():
    pairs = exact_style_cases()
    before = (pbb.launch_count, pbb.exact_launch_count)
    got = pbb.pair_beam_batch(pairs, device="cpu", exact=True)
    assert got == tp.beam_search_2d_planned_batch(pairs, device="cpu",
                                                  exact=True)
    assert pbb.pair_beam_single(*pairs[1], device="cpu", exact=True) == \
        got[1]
    assert (pbb.launch_count, pbb.exact_launch_count) == before


def test_exact_kernel_refuses_other_graveyards(packed_cpu):
    prep, (p1, p2, plan, meta) = packed_cpu
    with pytest.raises(ValueError, match="G=16"):
        pbb._launch(p1, p2, plan, meta, prep["meta"], 5, 4, G=16)


@pytest.mark.cuda
@pytest.mark.parametrize("model,S", [("ctc", 5), ("ctc_merge_repeats", 5),
                                     ("ctc_flipflop", 8)])
@pytest.mark.parametrize("grace", [2, 20])
def test_exact_kernel_matches_plain_on_card(cuda_device, model, S, grace):
    """The graveyard instance against the plain graveyard engine: the
    provenance, the scores' bits and validity, with the storage in shared
    memory and in global scratch, and on plans that step back
    (``sim.stuttered``: buried rows move back)."""
    pairs = exact_style_cases(S)
    plans, wsts = stuttered(pairs)
    for kw in ({}, dict(plans=plans, wst=wsts)):
        packed = tp.pack_pairs(pairs, model=model, G=tp.EXACT_G, **kw)
        dev = [torch.as_tensor(packed[k], device=cuda_device)
               for k in ("planes1", "planes2", "plan", "meta")]
        mid = packed["model_id"]
        p = tp.planned_scan(*dev, 5, 4, model_id=mid, G=tp.EXACT_G,
                            grace=grace)
        for in_smem in (True, False):
            k = pbb._launch(*dev, packed["meta"], 5, 4, in_smem=in_smem,
                            model_id=mid, G=tp.EXACT_G, grace=grace)
            torch.cuda.synchronize()
            for a, b in zip(k, p):
                assert torch.equal(a.cpu().view(torch.int8),
                                   b.cpu().view(torch.int8))
