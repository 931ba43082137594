"""The port's pair prefix search (``ops/pair_prefix.py``: the host loop
and the plain version of the level kernel ``csrc/pair_prefix.cu``) against
the JAX package's ``ops/pair_prefix.py`` with x64 off.

Labels are compared byte for byte. Probabilities within PROB_RTOL = 2e-5
relative: the port takes each level's label forward in closed form in
float64 and rounds it to float32, where the JAX package chains it step by
step in float32 (the largest difference seen on these cases is 4e-6
relative, on a 60-base simulated pair).
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.ops.pair_prefix import pair_prefix_search_log as jax_search

from poreover_tpu_torch.ops import pair_prefix as pp
from poreover_tpu_torch.sim import synth_read_pair

torch.set_num_threads(1)

PROB_RTOL = 2e-5


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _probs(rng, T, S):
    y = rng.random((T, S))
    return y / y.sum(axis=1, keepdims=True)


def _sim_pair(seed, n, lo=9, hi=10):
    rng = np.random.default_rng(seed)
    a, b = synth_read_pair(rng, n)
    b = np.ascontiguousarray(b[::-1][:, [3, 2, 1, 0, 4]])
    U, V = len(a), len(b)
    c = np.arange(U) * V // U
    env = np.stack([np.clip(c - lo, 0, V), np.clip(c + hi, 0, V)], 1)
    return a, b, env


def _cases():
    """(name, y1, y2, envelope or None, alphabet): tests/test_prefix.py's
    pair cases (the toy, five random 4x3 profiles, the 6x6 dense and full
    envelope), seeded simulated pairs, and a gap-dominant pair."""
    out = []
    y1 = np.array([[0.8, 0.1, 0.1], [0.1, 0.3, 0.6], [0.7, 0.2, 0.1],
                   [0.1, 0.1, 0.8]])
    y2 = np.array([[0.7, 0.2, 0.1], [0.2, 0.3, 0.5], [0.7, 0.2, 0.1],
                   [0.05, 0.05, 0.9]])
    out.append(("toy", np.log(y1), np.log(y2), None, "AB"))
    rng = np.random.default_rng(41)
    for i in range(5):
        out.append((f"random{i}", np.log(_probs(rng, 4, 3)),
                    np.log(_probs(rng, 4, 3)), None, "AB"))
    rng = np.random.default_rng(43)
    y1, y2 = np.log(_probs(rng, 6, 5)), np.log(_probs(rng, 6, 5))
    out.append(("dense 6x6", y1, y2, None, "ACGT"))
    out.append(("full envelope 6x6", y1, y2, np.tile([0, 6], (6, 1)),
                "ACGT"))
    for seed, n in ((3, 30), (4, 45), (6, 60)):
        out.append((f"sim{seed} {n} bases", *_sim_pair(seed, n), "ACGT"))
    out.append(("sim narrow band", *_sim_pair(8, 40, 4, 5), "ACGT"))
    gap = np.log(np.array([[0.05, 0.05, 0.9]] * 4))
    out.append(("gap dominant", gap, gap.copy(), None, "AB"))
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def jax_results():
    with jax_f32():
        return [jax_search(y1, y2, env, alphabet=ab)
                for _, y1, y2, env, ab in CASES]


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_label_and_probability_match_jax(jax_results, i):
    _, y1, y2, env, ab = CASES[i]
    label, prob = pp.pair_prefix_search_log(y1, y2, env, alphabet=ab,
                                            device="cpu")
    jl, jp = jax_results[i]
    assert label == jl
    assert abs(prob - jp) <= PROB_RTOL * max(1.0, abs(jp))


def test_gap_dominant_gives_the_empty_label(jax_results):
    label, prob = pp.pair_prefix_search_log(*CASES[-1][1:4], alphabet="AB",
                                            device="cpu")
    assert label == "" == jax_results[-1][0]
    # the empty label's probability: both gap columns' float64 sum
    assert prob == float(np.sum(CASES[-1][1][:, -1])
                         + np.sum(CASES[-1][2][:, -1]))


def test_batch_equals_one_at_a_time():
    """The lockstep batch (workloads of other lengths, widths and level
    counts, dropping out at their own stops) gives each workload what it
    gets alone, to the bit."""
    ws = [(y1, y2, env) for _, y1, y2, env, ab in CASES
          if env is not None and ab == "ACGT"]
    assert len(ws) >= 4
    trace = []
    got = pp.pair_prefix_search_batch(ws, device="cpu", trace=trace)
    assert len({len(t) for t in trace}) > 1  # workloads dropped out
    for w, g in zip(ws, got):
        assert pp.pair_prefix_search_batch([w], device="cpu")[0] == g


def test_float64_matches_jax_x64():
    _, y1, y2, env, ab = CASES[9]
    jax.config.update("jax_enable_x64", True)
    jl, jp = jax_search(y1, y2, env, alphabet=ab)
    label, prob = pp.pair_prefix_search_log(y1, y2, env, alphabet=ab,
                                            device="cpu", dtype=np.float64)
    assert label == jl
    assert abs(prob - jp) <= 1e-10 * abs(jp)


def _dict_search(levels, gap_prob, max_depth, alphabet="AB"):
    """The JAX package's host loop over given level outputs (a dict of
    every label, its max taken in insertion order)."""
    top_label, curr, label_probs = "", "", {"": gap_prob}
    for prefix_prob, label_prob in levels:
        for c in range(len(alphabet)):
            label_probs[curr + alphabet[c]] = float(label_prob[c])
        best_c = int(np.argmax(prefix_prob))
        if prefix_prob[best_c] < label_probs[top_label]:
            break
        top_label = max(label_probs.items(), key=lambda kv: kv[1])[0]
        curr = curr + alphabet[best_c]
        if len(curr) > max_depth:
            break
    return top_label, label_probs[top_label]


@pytest.mark.parametrize("seed", range(6))
def test_running_max_is_the_dict_order_max(seed):
    """Ties between label probabilities (values drawn from a few levels)
    resolve as Python's max over the JAX package's dict does: the first
    inserted of the largest; the stop test reads the previous level's
    top label; the depth limit stops the search."""
    rng = np.random.default_rng(seed)
    vals = np.float32([-3.0, -2.5, -2.0, -1.5])
    levels = []
    for _ in range(12):
        levels.append((rng.choice(vals, 2) + np.float32(0.5),
                       rng.choice(vals, 2)))
    gap_prob = float(rng.choice([-2.0, -1.0, -9.0]))
    depth = int(rng.integers(3, 15))
    want = _dict_search(levels, gap_prob, depth)
    s = pp._Search(np.zeros((depth, 3)), np.zeros((1, 3)), "AB")
    s.best = s.top = ((0, None), gap_prob)
    for prefix_prob, label_prob in levels:
        if s.level(prefix_prob, label_prob) is None:
            break
    assert s.result() == want


@pytest.mark.parametrize("y2_rows,env,exc", [
    (0, [[0, 0]] * 3, IndexError),
    (4, [[1, 1], [2, 2], [3, 3]], ValueError),
    (4, [[0, 3], [3, 1], [1, 4]], ValueError),
])
def test_workloads_jax_raises_on_raise(y2_rows, env, exc):
    """An empty read, a zero-width envelope or a row that ends before it
    starts: the JAX search raises (so its `pair_decode` skips the
    pair), and the port raises first."""
    rng = np.random.default_rng(1)
    y1 = np.log(_probs(rng, 3, 5))
    y2 = np.log(_probs(rng, max(y2_rows, 1), 5))[:y2_rows]
    env = np.array(env)
    with jax_f32(), pytest.raises(exc):
        jax_search(y1, y2, env)
    assert isinstance(pp.workload_error(y1, y2, env), exc)
    with pytest.raises(exc):
        pp.pair_prefix_search_log(y1, y2, env, device="cpu")


@pytest.mark.parametrize("seed", range(8))
def test_tiny_random_envelopes_raise_or_decode_as_jax(seed):
    """Tiny reads (V down to 0) under random envelopes, rows starting
    below 0 or past V and ending before they start among them: the port
    raises where the JAX search raises (the exception's type may differ:
    only whether a pair is skipped shows in the files), and elsewhere
    gives its label."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(6):
        U, V = int(rng.integers(1, 6)), int(rng.integers(0, 6))
        y1 = np.log(rng.dirichlet(np.ones(5), U)).astype(np.float32)
        y2 = np.log(rng.dirichlet(np.ones(5), max(V, 1))).astype(
            np.float32)[:V]
        s = rng.integers(-2, V + 2, U)
        env = np.stack([s, s + rng.integers(-2, 5, U)], 1)
        try:
            with jax_f32():
                want = jax_search(y1, y2, env)
        except Exception:
            want = None
        err = pp.workload_error(y1, y2, env)
        assert (err is None) == (want is not None), (U, V, env.tolist())
        if want is not None:
            label, prob = pp.pair_prefix_search_log(y1, y2, env,
                                                    device="cpu")
            assert label == want[0]
            assert prob == want[1] or abs(prob - want[1]) <= PROB_RTOL * max(
                1.0, abs(want[1]))
