"""The port's 1D beam search against the JAX package's, on the CPU.

Three implementations must return identical strings on the same seeded
numpy inputs, for all three model kinds:

- ``poreover_tpu.ops.beam.beam_search_batch``, the XLA engine in float32
  (jax_enable_x64 off, restored afterwards). It is the plain reference of
  the Pallas kernel ``pallas_beam1d``, which cannot run off a TPU;
- ``poreover_tpu_torch.ops.beam.beam_search_batch``, the engine's port;
- ``poreover_tpu_torch.ops.beam1d.beam1d_batch(device="cpu")``, the CUDA
  kernel's plain version behind the kernel's wrapper.

Tolerances: strings exact. Final scores of the plain version and the
engine's port are compared as sets per read to 1e-4 absolute: both run in
float32 and add the same terms, but torch.logaddexp and the order of the
table's slots differ from step to step, so the last bits may.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.ops import beam as jbeam

from poreover_tpu_torch.ops import beam as tbeam
from poreover_tpu_torch.ops import beam1d

# many small ops: one intra-op thread is as fast and does not oversubscribe
# the CPU when test workers run in parallel
torch.set_num_threads(1)

KINDS = [("ctc", 5), ("ctc_merge_repeats", 5), ("ctc_flipflop", 8)]
LENGTHS = {"ctc": (300, 257, 512, 100, 421, 380, 256, 64),
           "ctc_merge_repeats": (300, 257, 512, 100, 401, 77),
           "ctc_flipflop": (300, 257, 512, 100, 401, 77)}


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def softmax_log(rng, T, S):
    x = rng.normal(size=(T, S)) * 2
    return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32)


def dirichlet_log(T, S, seed):
    rng = np.random.default_rng(seed)
    return np.log(rng.dirichlet(np.ones(S), size=T))


def mixed_reads(model, S, seed=7):
    rng = np.random.default_rng(seed)
    return [softmax_log(rng, T, S) for T in LENGTHS[model]]


def jax_strings(ys, W, model):
    with jax_f32():
        return jbeam.beam_search_batch(ys, beam_width=W, model=model)


@pytest.mark.parametrize("model,S", KINDS)
def test_width_25_mixed_lengths(model, S):
    """The lengths of the Pallas kernel's own tests, at the 1D default
    width."""
    ys = mixed_reads(model, S)
    want = jax_strings(ys, 25, model)
    assert tbeam.beam_search_batch(ys, 25, model=model, device="cpu") == want
    assert beam1d.beam1d_batch(ys, 25, model=model, device="cpu") == want
    assert all(len(s) > 0 for s in want)


@pytest.mark.parametrize("W", [5, 8])
@pytest.mark.parametrize("model,S", KINDS)
def test_narrow_widths_short_reads(model, S, W):
    ys = [dirichlet_log(T, S, seed)
          for seed, T in enumerate([23, 40, 17, 40])]
    want = jax_strings(ys, W, model)
    assert tbeam.beam_search_batch(ys, W, model=model, device="cpu") == want
    assert beam1d.beam1d_batch(ys, W, model=model, device="cpu") == want


@pytest.mark.parametrize("model,S", KINDS)
def test_batch_equals_single_and_any_batch(model, S):
    """A read decodes the same alone, in a batch, and in another batch."""
    ys = [dirichlet_log(T, S, 40 + seed)
          for seed, T in enumerate([31, 58, 17, 44, 1, 2])]
    for fn in (tbeam.beam_search_batch, beam1d.beam1d_batch):
        batch = fn(ys, 8, model=model, device="cpu")
        single = [fn([y], 8, model=model, device="cpu")[0] for y in ys]
        assert batch == single
        other = fn(ys[::-1][:4], 8, model=model, device="cpu")
        assert other == batch[::-1][:4]
    assert tbeam.beam_search(ys[1], 8, model=model, device="cpu") == \
        tbeam.beam_search_batch(ys, 8, model=model, device="cpu")[1]


@pytest.mark.parametrize("model,S", KINDS)
def test_plain_final_table_matches_engine(model, S):
    """The plain version's final table holds the same nodes as the
    engine's: per read, the sorted finite scores agree to 1e-4."""
    rng = np.random.default_rng(11)
    ys = [softmax_log(rng, T, S) for T in (90, 64, 33)]
    W, A = 8, 4
    p = beam1d.planes_from_numpy(ys, model, A)
    t = [torch.from_numpy(p[k]) for k in ("y", "root", "meta")]
    prov, chars, st0, st1, val = beam1d.beam1d_plain(
        *t, p["meta"], W, A, tbeam._MODEL_IDS[model])
    assert prov.shape == (sum(map(len, ys)), W) and prov.dtype == torch.uint8
    assert chars.shape == (sum(map(len, ys)),) and chars.dtype == torch.int8
    sc = torch.logaddexp(st0, st1)
    for b, y in enumerate(ys):
        # the engine's final table, by running it one read at a time
        yb = torch.as_tensor(y[None])
        cand = _engine_final(yb, [len(y)], tbeam._MODEL_IDS[model], W, A)
        keep = tbeam._dedup_mask(cand["k1"], cand["k2"], cand["valid"])[0]
        want = tbeam._score(cand["state"])[0][keep]
        # the plain version keeps duplicates: compare distinct values
        got = torch.unique(sc[b][val[b]])
        want = torch.unique(want)
        got, want = got[torch.isfinite(got)], want[torch.isfinite(want)]
        assert got.shape == want.shape
        assert torch.allclose(got, want, atol=1e-4, rtol=0)


def _engine_final(y, lens, model_id, W, A):
    """The engine's candidate table after the last step (a copy of the
    scan's body without the traceback)."""
    captured = {}
    orig = tbeam._dedup_mask

    def spy(k1, k2, valid):
        captured["last"] = dict(k1=k1, k2=k2, valid=valid)
        return orig(k1, k2, valid)

    orig_score = tbeam._score

    def spy_score(state):
        captured["state"] = state
        return orig_score(state)

    tbeam._dedup_mask, tbeam._score = spy, spy_score
    try:
        tbeam._beam_search_scan(y, lens, model_id, W, A)
    finally:
        tbeam._dedup_mask, tbeam._score = orig, orig_score
    return dict(captured["last"], state=captured["state"])


def test_planes_from_numpy_layout():
    rng = np.random.default_rng(5)
    ys = [softmax_log(rng, T, 5) for T in (7, 3, 12)]
    p = beam1d.planes_from_numpy(ys, "ctc", 4)
    assert p["meta"].tolist() == [[0, 7], [7, 3], [10, 12]]
    np.testing.assert_array_equal(p["y"], np.concatenate(ys))
    for (o, t), y in zip(p["meta"], ys):
        assert p["root"][o] == 0.0
        np.testing.assert_allclose(p["root"][o + 1:o + t],
                                   np.cumsum(y[:-1, 4]), rtol=1e-6)
    f = beam1d.planes_from_numpy([softmax_log(rng, 9, 8)], "ctc_flipflop", 4)
    assert f["root"].shape == (0,) and f["y"].shape == (9, 8)
    with pytest.raises(ValueError, match="expected"):
        beam1d.planes_from_numpy([np.zeros((4, 8), np.float32)], "ctc", 4)
    with pytest.raises(ValueError, match="expected"):
        beam1d.planes_from_numpy([np.zeros((0, 5), np.float32)], "ctc", 4)


def test_cpu_route_is_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(2)
    ys = [softmax_log(rng, T, 5) for T in (20, 31)]
    before = beam1d.launch_count
    prep = beam1d.prepare_beam1d(ys, beam_width=5, device="cpu")
    outs = beam1d.launch_beam1d(prep)
    want = beam1d.beam1d_plain(*prep["host"], prep["meta"], 5, 4, 0)
    for a, b in zip(outs, want):
        assert torch.equal(a, b)
    assert beam1d.fetch_beam1d(prep, outs) == \
        beam1d.beam1d_batch(ys, 5, device="cpu")
    assert beam1d.launch_count == before
    assert beam1d.beam1d_batch([], 5, device="cpu") == []


def test_kernel_refuses_cpu_tensors_and_bad_arguments():
    rng = np.random.default_rng(2)
    prep = beam1d.prepare_beam1d([softmax_log(rng, 9, 5)], device="cpu")
    y, root, meta = prep["host"]
    with pytest.raises(ValueError, match="expected cuda"):
        beam1d.beam1d_cuda(y, root, meta, prep["meta"], 25, 4, 0)
    with pytest.raises(ValueError, match="W\\*\\(A\\+1\\)"):
        beam1d.beam1d_cuda(y, root, meta, prep["meta"], 26, 4, 0)
    with pytest.raises(TypeError):
        beam1d.beam1d_cuda(y.double(), root, meta, prep["meta"], 25, 4, 0)
    with pytest.raises(ValueError):
        beam1d.beam1d_cuda(y.t(), root, meta, prep["meta"], 25, 4, 0)
    with pytest.raises(ValueError, match="root"):
        beam1d.beam1d_cuda(y, root[:3], meta, prep["meta"], 25, 4, 0)


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = np.log(np.full((4, 5), 0.2, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        beam1d.beam1d_batch([y])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbeam.beam_search_batch([y])


def test_ctc_log_likelihood_is_the_sum_over_alignments():
    """The simulator's forward sum against brute force: every placement of
    the string's bases on T steps, blanks elsewhere. Tolerance 1e-9: both
    add the same float64 terms, in another order."""
    import itertools

    from poreover_tpu_torch.sim import ctc_log_likelihood

    y = dirichlet_log(6, 5, seed=2)
    for seq in ("", "A", "GA", "TTC"):
        total = -np.inf
        for steps in itertools.combinations(range(len(y)), len(seq)):
            cols = np.full(len(y), 4)
            cols[list(steps)] = ["ACGT".index(c) for c in seq]
            total = np.logaddexp(total, y[np.arange(len(y)), cols].sum())
        assert abs(ctc_log_likelihood(y, seq) - total) < 1e-9


@pytest.mark.parametrize("seed", [11, 12])
def test_simulated_read_beam_string_is_likelier_than_viterbi(seed):
    """On a simulated read the beam's string differs from the true sequence
    more than the best path's does, and rightly so: under the read's own
    emissions it is the likelier string (the float64 forward sum), because
    a spurious base spread over the blank steps of a dwell adds up. The
    engines agree on it."""
    from poreover_tpu_torch.sim import ctc_log_likelihood, synth_ctc_read

    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, 200)
    true = "".join("ACGT"[c] for c in seq)
    y = synth_ctc_read(rng, seq, noise=0.8)
    got = beam1d.beam1d_batch([y], beam_width=25, device="cpu")[0]
    assert got == jax_strings([y], 25, "ctc")[0]
    path = y.argmax(1)
    best_path = "".join("ACGT"[c] for c in path[path < 4])
    ll = ctc_log_likelihood(y, got)
    assert ll >= ctc_log_likelihood(y, best_path)
    assert ll >= ctc_log_likelihood(y, true)
    assert len(got) >= len(true)
