"""The port's 1D prefix search against the JAX package's, on the CPU.

Labels exact; log-probabilities to 1e-4 absolute against the JAX package
in float32 (its step-by-step float32 loop is itself ~1e-5 from the exact
value at 400 steps; the port computes the label forward in closed form in
float64 on the float32-rounded window) and to 1e-9 in float64.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.ops import prefix as jprefix

from poreover_tpu_torch.ops import prefix as tprefix

torch.set_num_threads(1)


@contextlib.contextmanager
def jax_x64(on):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def peaked_log(T, seed, S=5):
    """A window that looks like a read: mostly blank, a peak now and then."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1.0, (T, S))
    ch = np.where(rng.random(T) < 0.2, rng.integers(0, S - 1, T), S - 1)
    logits[np.arange(T), ch] += 4.0
    return logits - np.log(np.exp(logits).sum(1, keepdims=True))


@pytest.mark.parametrize("T,seed", [(1, 0), (5, 1), (40, 2), (120, 3),
                                    (400, 4)])
def test_float32_equals_jax(T, seed):
    y = peaked_log(T, seed)
    with jax_x64(False):
        want, want_p = jprefix.prefix_search_log(y)
    got, got_p = tprefix.prefix_search_log(y, device="cpu")
    assert got == want
    assert abs(got_p - want_p) < 1e-4


@pytest.mark.parametrize("T,seed", [(5, 11), (60, 12), (200, 13)])
def test_float64_equals_jax(T, seed):
    y = peaked_log(T, seed)
    with jax_x64(True):
        want, want_p = jprefix.prefix_search_log(y)
    got, got_p = tprefix.prefix_search_log(y, device="cpu",
                                           dtype=torch.float64)
    assert got == want
    assert abs(got_p - want_p) < 1e-9


def test_two_letter_alphabet_and_gap_dominant():
    y = np.array([[0.8, 0.1, 0.1], [0.1, 0.3, 0.6], [0.7, 0.2, 0.1],
                  [0.1, 0.1, 0.8]])
    with jax_x64(False):
        want, want_p = jprefix.prefix_search_log(np.log(y), alphabet="AB")
    got, got_p = tprefix.prefix_search_log(np.log(y), alphabet="AB",
                                           device="cpu")
    assert (got, round(got_p, 4)) == (want, round(want_p, 4))
    y = np.log(np.array([[0.05, 0.05, 0.9]] * 4))
    label, prob = tprefix.prefix_search_log(y, alphabet="AB", device="cpu")
    assert label == "" and abs(prob - 4 * np.log(0.9)) < 1e-5
