"""The PyTorch PoreOverNet (``poreover_tpu_torch/network/model.py``)
against the JAX package's flax model on the CPU, at small widths.

For each of the five architectures: flax ``init_params`` weights carried
across by ``params_from_flax``, the same seeded signal through both;
logits within atol 1e-5 (both compute in float32, but PyTorch's and XLA's
products and recurrences sum in different orders; observed <= 2e-7) and
equal per-step argmax strings. The GRU cell against the Keras
``reset_after`` formula of ``tests/test_network.py:30``, the port's seeded
initialiser against flax's tree shapes, and TF / flax ``SAME`` padding at
stride 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poreover_tpu.network import model as jm

from poreover_tpu_torch.network import model as tm

torch.set_num_threads(1)

ATOL = 1e-5
SMALL = dict(num_neurons=8, filters=4, kernel_size=9)


def flax_params(arch, seed=1, window=100, **kw):
    model = jm.build_model(arch, **{**SMALL, **kw})
    return model, jax.tree.map(np.asarray, jm.init_params(
        model, jax.random.PRNGKey(seed), window=window))


def signal(seed, B, T):
    return np.random.default_rng(seed).normal(size=(B, T, 1)).astype(
        np.float32)


@pytest.mark.parametrize("arch", tm.ARCHS)
def test_logits_match_flax(arch):
    model, params = flax_params(arch)
    x = signal(3, 2, 100)
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    finally:
        jax.config.update("jax_enable_x64", old)
    net = tm.load_network(params, arch, device="cpu", **SMALL)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    T_out = 50 if arch == "taiyaki_like" else 100
    assert got.shape == want.shape == (2, T_out, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    letters = np.array(list("ACGT-"))
    assert ["".join(letters[r]) for r in got.argmax(-1)] == \
        ["".join(letters[r]) for r in want.argmax(-1)]


@pytest.mark.parametrize("arch", tm.ARCHS)
def test_seeded_initialiser_has_flax_shapes(arch):
    _, params = flax_params(arch, window=20)
    ours = tm.init_params(arch, seed=7, **SMALL)
    assert jax.tree.map(np.shape, ours) == jax.tree.map(np.shape, params)
    assert all(v.dtype == np.float32 for v in jax.tree.leaves(ours))
    # the state dict it maps to is the module's, key for key
    net = tm.PoreOverNet(arch, **SMALL)
    assert sorted(tm.params_from_flax(ours, arch)) == sorted(
        net.state_dict())


def test_seeded_initialiser_is_reproducible():
    a = tm.init_params("conv1_bigru3", seed=11, **SMALL)
    b = tm.init_params("conv1_bigru3", seed=11, **SMALL)
    c = tm.init_params("conv1_bigru3", seed=12, **SMALL)
    assert all(np.array_equal(x, y) for x, y in zip(jax.tree.leaves(a),
                                                    jax.tree.leaves(b)))
    assert not np.array_equal(a["dense"]["kernel"], c["dense"]["kernel"])
    rk = a["bigru0"]["forward"]["cell"]["recurrent_kernel"]
    np.testing.assert_allclose(rk @ rk.T, np.eye(8), atol=1e-5)


def test_gru_cell_matches_keras_math():
    """One step of the port's GRU against the Keras reset_after formula
    (tests/test_network.py:30), with weights carried across from flax's
    cell layout."""
    rng = np.random.default_rng(0)
    H, D = 3, 2
    cell = {"kernel": rng.normal(size=(D, 3 * H)),
            "recurrent_kernel": rng.normal(size=(H, 3 * H)),
            "input_bias": rng.normal(size=3 * H),
            "recurrent_bias": rng.normal(size=3 * H)}
    x = rng.normal(size=(1, D))
    h = rng.normal(size=(1, H))
    layer = tm.GRULayer(D, H)
    layer.rnn.load_state_dict({k: torch.tensor(v, dtype=torch.float32)
                               for k, v in tm._cell(cell, "").items()})
    with torch.no_grad():
        got, _ = layer.rnn(torch.tensor(x[:, None], dtype=torch.float32),
                           torch.tensor(h[None], dtype=torch.float32))
    xk = x @ cell["kernel"] + cell["input_bias"]
    hk = h @ cell["recurrent_kernel"] + cell["recurrent_bias"]
    xz, xr, xn = np.split(xk, 3, axis=-1)
    hz, hr, hn = np.split(hk, 3, axis=-1)
    sig = lambda v: 1 / (1 + np.exp(-v))
    z = sig(xz + hz)
    r = sig(xr + hr)
    n = np.tanh(xn + r * hn)
    expect = (1 - z) * n + z * h
    assert np.allclose(got.numpy()[0], expect, atol=1e-6)


@pytest.mark.parametrize("T,pads", [(1000, (8, 9)), (99, (9, 9)),
                                    (20, (8, 9))])
def test_same_padding_at_stride_two(T, pads):
    """TF SAME at stride 2, kernel 19: max((ceil(T/2) - 1) * 2 + 19 - T, 0)
    in total, the smaller half on the left; the conv's output length is
    ceil(T / 2)."""
    conv = tm.SameConv(1, 1, 19, stride=2)
    total = max((-(-T // 2) - 1) * 2 + 19 - T, 0)
    assert (total // 2, total - total // 2) == pads
    with torch.no_grad():
        conv.conv.weight.fill_(1.0)
        conv.conv.bias.zero_()
        y = conv(torch.ones(1, T, 1))
    assert y.shape == (1, -(-T // 2), 1)
    # the first output sums 19 - left padded samples
    assert y[0, 0, 0].item() == 19 - pads[0]


def test_network_turns_tf32_off():
    torch.backends.cudnn.allow_tf32 = True
    tm.build_model("conv1_bigru3", **SMALL)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.benchmark


def test_unknown_architecture_raises():
    with pytest.raises(ValueError, match="unknown architecture"):
        tm.PoreOverNet("lstm")
