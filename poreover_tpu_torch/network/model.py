"""PoreOverNet architectures in PyTorch.

Port of ``poreover_tpu/network/model.py`` (the reference's Keras model zoo,
poreover/network/network.py:14-64): bigru3, conv1_bigru3 (default),
conv2_bigru3, conv1_gru5, taiyaki_like. The public forward keeps the JAX
layout: [B, T, 1] scaled signal in, [B, T', 5] logits out.

The Keras ``reset_after=True`` GRU cell of the JAX package
(``KerasGRUCell``) is the formula ``torch.nn.GRU`` computes:
  z = sigmoid(x W_z + b_iz + h U_z + b_hz)
  r = sigmoid(x W_r + b_ir + h U_r + b_hr)
  n = tanh  (x W_n + b_in + r * (h U_n + b_hn))
  h' = (1 - z) * n + z * h
Only the gate order differs (Keras and flax z, r, n; PyTorch r, z, n), and
the layouts: flax kernels are [D, 3H], PyTorch's ``weight_ih_l0`` [3H, D];
flax ``input_bias`` / ``recurrent_bias`` are PyTorch's ``bias_ih`` /
``bias_hh``. ``params_from_flax`` carries a flax parameter tree (numpy
arrays) across. A flax ``GRULayer(reverse=True)`` flips its input and
un-flips its output, which is PyTorch's backward direction.

Convolutions pad as TF / flax ``SAME`` does, explicitly with ``F.pad``
(PyTorch's ``padding="same"`` refuses a stride above 1): a total of
max((ceil(T / s) - 1) * s + k - T, 0), the smaller half on the left.

Building a network (``PoreOverNet``) turns TF32 off for cuDNN's
convolutions and RNNs and for cuBLAS's products, and cuDNN's benchmark
mode off (so that a batch shape always takes the same algorithm): a
float32 forward stays float32 on the card.

The network's products, recurrences and convolutions are PyTorch's own
(cuBLAS / cuDNN on the card): the JAX package computes them in flax (a
``lax.scan`` of matrix products and ``nn.Conv``), not in Pallas.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

ARCHS = ("bigru3", "conv1_bigru3", "conv2_bigru3", "conv1_gru5",
         "taiyaki_like")


def exact_float32() -> None:
    """float32 products, convolutions and RNNs without TF32, and one
    cuDNN algorithm per shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


class SameConv(nn.Module):
    """1D convolution over [B, T, C] with TF / flax ``SAME`` padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.k, self.stride = k, stride
        self.conv = nn.Conv1d(cin, cout, k, stride=stride)

    def forward(self, x):
        T = x.shape[1]
        total = max((math.ceil(T / self.stride) - 1) * self.stride + self.k
                    - T, 0)
        x = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
        return self.conv(x).transpose(1, 2)


class GRULayer(nn.Module):
    """A GRU over [B, T, D]: bidirectional (outputs concatenated, forward
    first, as Keras' Bidirectional), or one direction, optionally over the
    reversed sequence with the output un-reversed (flax ``GRULayer``)."""

    def __init__(self, din: int, h: int, bidirectional: bool = False,
                 reverse: bool = False):
        super().__init__()
        self.reverse = reverse
        self.rnn = nn.GRU(din, h, batch_first=True,
                          bidirectional=bidirectional)

    def forward(self, x):
        if self.reverse:
            x = x.flip(1)
        y, _ = self.rnn(x)
        return y.flip(1) if self.reverse else y


class PoreOverNet(nn.Module):
    """The reference's build_model variants, with flax's layer names."""

    def __init__(self, arch: str = "conv1_bigru3", num_neurons: int = 128,
                 kernel_size: int = 9, filters: int = 256,
                 num_labels: int = 4):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"unknown architecture {arch!r}")
        exact_float32()
        self.arch = arch
        H = num_neurons
        d = 1
        if arch in ("conv1_bigru3", "conv2_bigru3", "conv1_gru5"):
            self.conv0 = SameConv(1, filters, kernel_size)
            d = filters
        if arch == "conv2_bigru3":
            self.conv1 = SameConv(filters, filters, kernel_size)
        if arch == "taiyaki_like":
            self.conv0 = SameConv(1, 256, 19, stride=2)
            d = H = 256
        if arch.endswith("bigru3"):
            for i in range(3):
                self.add_module(f"bigru{i}",
                                GRULayer(d, H, bidirectional=True))
                d = 2 * H
        else:
            for i in range(5):
                self.add_module(f"gru{i}", GRULayer(d, H, reverse=i % 2 == 1))
                d = H
        self.dense = nn.Linear(d, num_labels + 1)

    def forward(self, x):
        """[B, T, 1] -> [B, T', num_labels + 1] logits."""
        for name, layer in self.named_children():
            x = layer(x)
            if name.startswith("conv"):
                x = torch.relu(x)
        return x


def build_model(arch: str = "conv1_bigru3", num_neurons: int = 128,
                kernel_size: int = 9, filters: int = 256) -> PoreOverNet:
    return PoreOverNet(arch=arch, num_neurons=num_neurons,
                       kernel_size=kernel_size, filters=filters)


_TORCH_GATES = (1, 0, 2)  # PyTorch's r, z, n from Keras' z, r, n


def _gates(a: np.ndarray) -> np.ndarray:
    """Reorder the last axis' three gate blocks from z, r, n to r, z, n."""
    return np.concatenate([np.split(a, 3, axis=-1)[g]
                           for g in _TORCH_GATES], axis=-1)


def _cell(cell: dict, suffix: str) -> dict:
    return {
        f"weight_ih_l0{suffix}": _gates(cell["kernel"]).T,
        f"weight_hh_l0{suffix}": _gates(cell["recurrent_kernel"]).T,
        f"bias_ih_l0{suffix}": _gates(cell["input_bias"]),
        f"bias_hh_l0{suffix}": _gates(cell["recurrent_bias"]),
    }


def params_from_flax(tree: dict, arch: str = "conv1_bigru3") -> dict:
    """The module's ``state_dict`` (float32 tensors) from a flax parameter
    tree of ``arch`` (nested dicts of numpy arrays, as
    ``poreover_tpu.network.model.init_params`` or ``io/tf_checkpoint.py``
    give it)."""
    if arch not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r}")
    sd = {}
    for name, sub in tree.items():
        if name.startswith("conv"):
            sd[f"{name}.conv.weight"] = np.transpose(sub["kernel"], (2, 1, 0))
            sd[f"{name}.conv.bias"] = sub["bias"]
        elif name.startswith("bigru"):
            for direction, suffix in (("forward", ""),
                                      ("backward", "_reverse")):
                for k, v in _cell(sub[direction]["cell"], suffix).items():
                    sd[f"{name}.rnn.{k}"] = v
        elif name.startswith("gru"):
            for k, v in _cell(sub["cell"], "").items():
                sd[f"{name}.rnn.{k}"] = v
        elif name == "dense":
            sd["dense.weight"] = sub["kernel"].T
            sd["dense.bias"] = sub["bias"]
        else:
            raise ValueError(f"unknown layer {name!r} for {arch!r}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def init_params(arch: str = "conv1_bigru3", num_neurons: int = 128,
                kernel_size: int = 9, filters: int = 256,
                seed: int = 0) -> dict:
    """A flax-shaped parameter tree of numpy float32 arrays from a numpy
    seed, with flax's initialisers' distributions (the numbers differ):
    GRU kernels Glorot uniform, recurrent kernels orthogonal, convolution
    and dense kernels LeCun normal, biases zero."""
    rng = np.random.default_rng(seed)

    def glorot(shape):
        lim = math.sqrt(6.0 / (shape[0] + shape[1]))
        return rng.uniform(-lim, lim, shape)

    def orthogonal(h):
        q, r = np.linalg.qr(rng.normal(size=(3 * h, h)))
        return (q * np.sign(np.diag(r))).T  # [h, 3h], orthonormal rows

    def lecun(shape, fan_in):
        return rng.normal(0.0, math.sqrt(1.0 / fan_in), shape)

    def cell(d, h):
        return {"cell": {"kernel": glorot((d, 3 * h)),
                         "recurrent_kernel": orthogonal(h),
                         "input_bias": np.zeros(3 * h),
                         "recurrent_bias": np.zeros(3 * h)}}

    def conv(k, cin, cout):
        return {"kernel": lecun((k, cin, cout), k * cin),
                "bias": np.zeros(cout)}

    if arch not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r}")
    H, d, tree = num_neurons, 1, {}
    if arch in ("conv1_bigru3", "conv2_bigru3", "conv1_gru5"):
        tree["conv0"] = conv(kernel_size, 1, filters)
        d = filters
    if arch == "conv2_bigru3":
        tree["conv1"] = conv(kernel_size, filters, filters)
    if arch == "taiyaki_like":
        tree["conv0"] = conv(19, 1, 256)
        d = H = 256
    if arch.endswith("bigru3"):
        for i in range(3):
            tree[f"bigru{i}"] = {"forward": cell(d, H),
                                 "backward": cell(d, H)}
            d = 2 * H
    else:
        for i in range(5):
            tree[f"gru{i}"] = cell(d, H)
            d = H
    tree["dense"] = {"kernel": lecun((d, 5), d), "bias": np.zeros(5)}

    def f32(t):
        return ({k: f32(v) for k, v in t.items()} if isinstance(t, dict)
                else np.asarray(t, np.float32))

    return f32(tree)


def load_network(tree: dict, arch: str = "conv1_bigru3",
                 num_neurons: int = 128, kernel_size: int = 9,
                 filters: int = 256, device=None) -> PoreOverNet:
    """A ``PoreOverNet`` with a flax parameter tree's weights, in eval mode
    on ``device`` (cuda unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    net = PoreOverNet(arch, num_neurons, kernel_size, filters)
    net.load_state_dict(params_from_flax(tree, arch))
    return net.eval().to(dev)
