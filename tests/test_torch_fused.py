"""Fused basecall + decode (``poreover_tpu_torch/decoding/fused.py``) on
the CPU: the port's counterparts of ``tests/test_network.py:136`` (fused
Viterbi) and ``:175`` (fused beam), each against the port's own two-stage
path (forward -> softmax probabilities -> numpy log -> decode) and against
the JAX package's fused path, on a tiny conv1_bigru3 with flax's random
weights carried across. The strings must be equal. Then ``call --decode
viterbi|beam`` against ``call`` followed by ``decode`` through the CLI, on
FAST5 files: byte-identical FASTA.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from poreover_tpu.decoding import fused as jf
from poreover_tpu.network.model import build_model, init_params

from poreover_tpu_torch.cli import main as torch_main
from poreover_tpu_torch.decoding import fused as tf
from poreover_tpu_torch.io.fast5 import batch_input
from poreover_tpu_torch.models.transducer import poreover
from poreover_tpu_torch.network.call import make_forward
from poreover_tpu_torch.network.model import load_network
from poreover_tpu_torch.ops.beam import beam_search_batch

from test_torch_call import tiny  # noqa: F401

torch.set_num_threads(1)


@contextlib.contextmanager
def jax_f32():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def nets():
    with jax_f32():
        model = build_model("conv1_bigru3", num_neurons=8, filters=4,
                            kernel_size=9)
        params = init_params(model, jax.random.PRNGKey(3), window=100)
    net = load_network(jax.tree.map(np.asarray, params), "conv1_bigru3",
                       num_neurons=8, filters=4, kernel_size=9,
                       device="cpu")
    return model, params, net


def two_stage_log_probs(net, signal):
    """``call``'s probabilities of one signal (float32 softmax), then
    ``decode``'s numpy log."""
    forward = make_forward(net, torch.device("cpu"))
    batches, last = batch_input(signal, window_size=100)
    probs = np.concatenate([np.concatenate(forward(b)) for b in batches])
    if last:
        probs = probs[:(len(batches) - 1) * 128 * 100 + last]
    return np.log(probs)


def test_fused_viterbi_matches_two_stage_and_jax(nets):
    model, params, net = nets
    signal = np.random.default_rng(5).normal(size=23_456).astype(np.float32)
    run = tf.make_fused_viterbi(net, window=100, device="cpu")
    fused = tf.fused_basecall_viterbi(run, signal, window=100)
    two_stage = poreover(two_stage_log_probs(net, signal)).viterbi_decode()
    with jax_f32():
        jax_fused = jf.fused_basecall_viterbi(
            jf.make_fused_viterbi(model, params, window=100), signal,
            window=100)
    assert fused == two_stage == jax_fused
    assert len(fused) > 1000


def test_fused_beam_matches_two_stage_and_jax(nets):
    model, params, net = nets
    rng = np.random.default_rng(11)
    signals = [rng.normal(size=t).astype(np.float32)
               for t in (12_800 * 2, 7_345, 20_111)]
    fused = tf.make_fused_beam(net, window=100, beam_width=6,
                               device="cpu")(signals)
    two_stage = beam_search_batch(
        [two_stage_log_probs(net, s) for s in signals], beam_width=6,
        model="ctc", device="cpu")
    with jax_f32():
        jax_fused = jf.make_fused_beam(model, params, window=100,
                                       beam_width=6)(signals)
    assert fused == two_stage == jax_fused
    assert min(len(s) for s in fused) > 100


def test_pack_planes_is_planes_from_numpy():
    """The device-side packing equals the host's (``planes_from_numpy``)
    for ctc reads of mixed lengths, T = 1 among them."""
    from poreover_tpu_torch.ops.beam1d import planes_from_numpy

    rng = np.random.default_rng(2)
    ys = []
    for t in (300, 1, 77):
        x = rng.normal(size=(t, 5))
        ys.append((x - np.log(np.exp(x).sum(1, keepdims=True))).astype(
            np.float32))
    y, root, meta, meta_h = tf.pack_planes([torch.from_numpy(a) for a in ys])
    want = planes_from_numpy(ys, "ctc")
    assert np.array_equal(y.numpy(), want["y"])
    assert np.array_equal(root.numpy(), want["root"])
    assert np.array_equal(meta.numpy(), want["meta"])
    assert np.array_equal(meta_h, want["meta"])


@pytest.mark.parametrize("algorithm", ["viterbi", "beam"])
def test_cli_fused_equals_call_then_decode(tiny, tmp_path, algorithm):
    _, reads, prefix, cfg, _ = tiny
    common = ["--weights", prefix, "--model", str(cfg), "--window", "100",
              "--device", "cpu"]
    torch_main(["call", str(reads), "--dir", str(tmp_path), *common])
    torch_main(["decode", str(tmp_path), "--basecaller", "poreover",
                "--algorithm", algorithm, "--beam_width", "6",
                "--out", str(tmp_path / "two"), "--device", "cpu"])
    torch_main(["call", str(reads), "--decode", algorithm, "--beam_width",
                "6", "--out", str(tmp_path / "fused"), *common])
    two = (tmp_path / "two.fasta").read_bytes()
    assert two == (tmp_path / "fused.fasta").read_bytes()
    assert two.count(b">") == 3
