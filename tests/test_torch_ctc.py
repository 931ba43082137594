"""The port's CTC loss (``poreover_tpu_torch/ops/ctc.py``, its plain
version on the CPU) against the JAX package's ``ctc_loss`` and
``jax.grad`` of its batch mean, both variants.

Inputs: ``tests/test_ctc.py``'s cases, and seeded random batches [B 4,
T 50, 5] with labels up to 20 long, including a label of length 0, an
infeasible label (longer than T; for merging, more labels plus repeats
than T), logit lengths below T and repeated labels. The JAX references
run with x64 off (restored after), in float32 like the port.

Tolerances: the loss within 1e-5 relative (both compute the same
float32 recursion; the CPU's and XLA's exp / log1p round differently;
observed <= 2.2e-7 relative over 30 seeded batches like these); the
gradient in the logits within 1e-5 absolute (autodiff's transposed sums
against the backward pass's order; observed <= 3.7e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poreover_tpu.ops.ctc import ctc_loss as jax_ctc_loss

from poreover_tpu_torch.ops import ctc

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5


def jax_f32(fn):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        return jax.tree.map(np.asarray, fn())
    finally:
        jax.config.update("jax_enable_x64", old)


def reference(logits, labels, lengths, logit_lengths, merge):
    """JAX: the per-sequence loss and the gradient of the batch mean."""
    def run():
        x = jnp.asarray(logits, jnp.float32)
        y = jnp.asarray(labels, jnp.int32)
        n = jnp.asarray(lengths, jnp.int32)
        t = (None if logit_lengths is None
             else jnp.asarray(logit_lengths, jnp.int32))
        loss = jax_ctc_loss(x, y, n, t, merge_repeated=merge)
        grad = jax.grad(lambda v: jnp.mean(jax_ctc_loss(
            v, y, n, t, merge_repeated=merge)))(x)
        return loss, grad

    return jax_f32(run)


def port(logits, labels, lengths, logit_lengths, merge):
    x = torch.tensor(np.asarray(logits, np.float32), requires_grad=True)
    loss = ctc.ctc_loss(x, labels, lengths, logit_lengths,
                        merge_repeated=merge)
    loss.mean().backward()
    return loss.detach().numpy(), x.grad.numpy()


def check(logits, labels, lengths, logit_lengths=None, merges=(False, True)):
    for merge in merges:
        want_l, want_g = reference(logits, labels, lengths, logit_lengths,
                                   merge)
        got_l, got_g = port(logits, labels, lengths, logit_lengths, merge)
        np.testing.assert_allclose(got_l, want_l, rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=GRAD_ATOL)
        assert np.all(np.isfinite(got_g))


def _rand_logits(rng, B, T, S):
    return (rng.normal(size=(B, T, S)) * 2).astype(np.float32)


# ---- tests/test_ctc.py's cases


def test_no_merge_case_of_test_ctc():
    rng = np.random.default_rng(0)
    labels = np.array([[0, 1, 0], [1, 1, 0], [0, 0, 0]], np.int32)
    check(_rand_logits(rng, 3, 6, 3), labels, np.array([3, 2, 1]))


def test_oracle_case_of_test_ctc():
    rng = np.random.default_rng(1)
    y = rng.random((5, 3))
    y = y / y.sum(axis=1, keepdims=True)
    check(np.log(y)[None], np.array([[0, 1, 0, 0, 0]], np.int32),
          np.array([2]))


def test_merge_case_of_test_ctc():
    rng = np.random.default_rng(2)
    B, T, L, S = 4, 8, 3, 5
    logits = _rand_logits(rng, B, T, S)
    labels = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    check(logits, labels, np.array([3, 2, 3, 1]))


def test_gradient_case_of_test_ctc():
    rng = np.random.default_rng(3)
    check(_rand_logits(rng, 2, 6, 5), np.array([[0, 1, 2], [3, 3, 0]]),
          np.array([3, 2]))


# ---- seeded random batches with the edge cases


def _batch(seed):
    """B 4, T 50, labels up to 20: one of length 0 (or of the full 20 with
    a run of repeats), and logit lengths below T on some rows."""
    rng = np.random.default_rng(seed)
    logits = _rand_logits(rng, 4, 50, 5)
    labels = rng.integers(0, 4, size=(4, 20)).astype(np.int32)
    labels[1, 3:9] = 2  # repeated labels
    lengths = np.array([20, 12, 0, 7])
    return logits, labels, lengths


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_random_batches(seed):
    logits, labels, lengths = _batch(seed)
    check(logits, labels, lengths)


@pytest.mark.parametrize("seed", [20, 21])
def test_logit_lengths_below_t(seed):
    logits, labels, lengths = _batch(seed)
    check(logits, labels, lengths, np.array([50, 31, 17, 9]))


def test_infeasible_labels():
    """Labels the logits cannot emit: longer than T in both variants; for
    merging, a repeated base needs a blank between repeats (L + repeats >
    T). The JAX loss stays finite (near 1e5), and so does the port's."""
    rng = np.random.default_rng(30)
    T = 12
    logits = _rand_logits(rng, 3, T, 5)
    labels = np.zeros((3, 16), np.int32)
    labels[0] = rng.integers(0, 4, 16)  # 16 > T
    labels[1, :9] = 1  # 9 <= T, but 9 + 8 repeats > T
    labels[2, :4] = [0, 1, 2, 3]
    lengths = np.array([16, 9, 4])
    check(logits, labels, lengths)
    plain, _ = port(logits, labels, lengths, None, False)
    merged, _ = port(logits, labels, lengths, None, True)
    assert plain[0] > 9e4 and merged[0] > 9e4 and merged[1] > 9e4
    assert plain[1] < 1e3 and plain[2] < 1e3 and merged[2] < 1e3


def test_logit_length_zero_and_label_length_zero():
    rng = np.random.default_rng(31)
    logits = _rand_logits(rng, 3, 9, 5)
    labels = np.array([[1, 2], [0, 0], [3, 1]], np.int32)
    check(logits, labels, np.array([2, 0, 0]), np.array([0, 9, 4]))


def test_steps_past_logit_lengths_get_no_gradient():
    rng = np.random.default_rng(32)
    logits = _rand_logits(rng, 2, 30, 5)
    labels = rng.integers(0, 4, (2, 6)).astype(np.int32)
    for merge in (False, True):
        _, g = port(logits, labels, np.array([6, 4]), np.array([30, 13]),
                    merge)
        assert np.all(g[1, 13:] == 0) and np.any(g[1, :13] != 0)


def test_plain_version_is_the_route_on_cpu_and_refuses_bad_arguments():
    rng = np.random.default_rng(33)
    logp = ctc.log_softmax(torch.as_tensor(_rand_logits(rng, 2, 7, 5)))
    labels = torch.zeros((2, 3), dtype=torch.int32)
    n = torch.tensor([3, 1], dtype=torch.int32)
    t = torch.tensor([7, 7], dtype=torch.int32)
    before = (ctc.launch_count, ctc.grad_launch_count)
    x = torch.as_tensor(_rand_logits(rng, 2, 7, 5)).requires_grad_(True)
    ctc.ctc_loss(x, labels, n).sum().backward()
    assert (ctc.launch_count, ctc.grad_launch_count) == before
    with pytest.raises(ValueError, match="expected cuda"):
        ctc.ctc_cuda(logp, labels, n, t)
    with pytest.raises(TypeError):
        ctc.ctc_plain(logp, labels.long(), n, t)
    with pytest.raises(TypeError):
        ctc.ctc_plain(logp.double(), labels, n, t)


@pytest.mark.parametrize("L,merge,sp", [(0, False, 32), (31, False, 32),
                                        (32, False, 64), (15, True, 32),
                                        (16, True, 64), (170, True, 352)])
def test_padded_states(L, merge, sp):
    assert ctc.padded_states(L, merge) == sp


def test_fold_is_the_warp_order():
    """``_fold`` sums each lane's states in round order, then the xor
    butterfly: for exactly representable values it is the plain sum."""
    x = torch.arange(96, dtype=torch.float32).reshape(1, 96)
    assert ctc._fold(x).item() == float(sum(range(96)))
    # the order: lane 0's rounds first, then 16 lanes, 8, 4, 2, 1
    y = torch.zeros(1, 64)
    y[0, 0], y[0, 32], y[0, 16] = 1.0, 2.0 ** 24, -(2.0 ** 24)
    # lane 0: 1 + 2^24 = 2^24 (rounded); then + lane 16's -2^24 = 0
    assert ctc._fold(y).item() == 0.0


@pytest.mark.parametrize("sp", [32, 1056, 9632])
def test_fold_of_stacked_classes_is_each_class_alone(sp):
    """The backward pass folds a step's classes in one call ([C, B, SP]):
    bit for bit the fold of each class's [B, SP] alone, the loop it
    replaced."""
    g = torch.Generator().manual_seed(sp)
    x = torch.randn(5, 3, sp, generator=g) * torch.exp(
        torch.randn(5, 3, sp, generator=g) * 8)
    alone = torch.stack([ctc._fold(x[c]) for c in range(5)])
    assert torch.equal(ctc._fold(x).view(torch.int32),
                       alone.view(torch.int32))


# ---- the kernels' launch geometry (ops/ctc.py:launch_geometry)


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("grad", [False, True])
def test_launch_geometry_fits_every_padded_state_count(merge, grad):
    """For every SP the kernels take: at most 1024 threads (768 for the
    K = 16 instance), a CTA's dynamic shared memory, each state owned by
    exactly one thread (s = k * threads + tid), a ring of at least one
    column per chunk (the alpha pass: Y_CHUNK rows), and the shared bytes
    the kernel's layout needs."""
    for SP in range(32, ctc.MAX_SP + 1, 32):
        threads, K, ring, smem = ctc.launch_geometry(SP, merge, grad)
        assert K in ctc.STATES_PER_THREAD
        assert threads % 32 == 0
        assert threads <= (768 if K == 16 else 1024)
        assert smem <= ctc.SMEM_MAX
        owner = np.zeros(SP, np.int64)
        for k in range(K):
            s = k * threads + np.arange(threads)
            np.add.at(owner, s[s < SP], 1)
        assert np.all(owner == 1), SP
        if grad:
            assert 1 <= ring <= ctc.RING_MAX
            slot = SP if merge else SP + ctc.Y_ROW
            need = ((2 if merge else 1) * SP + 2 * ring * slot) * 4
        else:
            assert ring == ctc.Y_CHUNK
            need = (2 * SP + 2 * ring * ctc.Y_ROW) * 4
        assert smem == need


def test_launch_geometry_at_the_trainers_shapes():
    """A train step's labels (~120-160 bases): one state per thread, the
    deepest ring."""
    assert ctc.launch_geometry(160, False, False)[:3] == (160, 1, 32)
    assert ctc.launch_geometry(160, False, True)[:3] == (160, 1, 8)
    assert ctc.launch_geometry(320, True, True)[:3] == (320, 1, 8)
    with pytest.raises(ValueError):
        ctc.launch_geometry(ctc.MAX_SP + 32 * 200, True, True)
