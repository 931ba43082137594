"""``call``: neural-network basecalling forward pass -> per-read probabilities.

Port of ``poreover_tpu/network/call.py`` (reference call / call_helper,
poreover/network/network.py:181-298): window the scaled signal into
[128, window, 1] batches, run the forward pass and the softmax on the
device (``--device``, default cuda), concatenate, and save ``.npy``
float32 softmax probabilities (or ``.csv``), named by the FAST5 file's
stem or, with ``--use_id``, its read id.

Weights load from a TensorFlow bundle (the reference's Keras checkpoint
layout, ``io/tf_checkpoint.py``) named by its prefix, or from a
checkpoint of the port's trainer (``network/checkpoint.py``); a
directory stands for its newest ``checkpoint-N``, as in the JAX package.
The JAX package's other format, an orbax checkpoint, needs jax and orbax,
which the port does not import: such a path exits naming
``tools/orbax_to_torch.py``, which converts it.
"""
from __future__ import annotations

import glob
import json
import logging
import os
from pathlib import Path

import numpy as np
import torch

from ..build import REPO_DIR
from ..device import resolve_device
from ..io.fast5 import batch_input, parse_fast5
from .checkpoint import is_checkpoint, load_params
from .model import PoreOverNet, build_model, params_from_flax

log = logging.getLogger("poreover_tpu_torch")

# the reference project's bundled checkpoint (the JAX package's default
# weights), looked for inside this repository; it is not committed yet
DEFAULT_WEIGHTS = str(REPO_DIR / "data" / "model" / "checkpoint-124")


def latest_checkpoint(directory: str):
    """Newest checkpoint-N path inside ``directory`` (the JAX package's
    rule, which takes the port's checkpoint files, TF bundle prefixes and
    the JAX trainer's orbax directories alike)."""
    cands = sorted(
        glob.glob(os.path.join(directory, "checkpoint-*")),
        key=lambda p: (len(p), p),
    )
    cands = [c for c in cands if not c.endswith(".json")]
    return cands[-1] if cands else None


def _model_from_args(args) -> PoreOverNet:
    if getattr(args, "model", None):
        with open(args.model) as f:
            cfg = json.load(f)
        return PoreOverNet(**cfg)
    return build_model(
        num_neurons=getattr(args, "num_neurons", 128),
        kernel_size=getattr(args, "kernel_size", 9),
        filters=getattr(args, "filters", 256),
    )


def _is_tf_bundle(prefix: str) -> bool:
    return os.path.exists(prefix + ".index")


def weights_path(weights) -> str:
    """The checkpoint ``--weights`` names (the default checkpoint when it
    is None, the newest checkpoint of a directory): a TF bundle prefix or
    a checkpoint of the port's trainer; exits when there is none or it is
    neither."""
    if weights is None:
        weights = DEFAULT_WEIGHTS
        if not _is_tf_bundle(weights):
            raise SystemExit(
                "no --weights given and no bundled checkpoint found; train "
                "one with `poreover-tpu train`"
            )
    elif os.path.isdir(weights) and latest_checkpoint(weights):
        weights = latest_checkpoint(weights)
    if _is_tf_bundle(weights) or is_checkpoint(weights):
        return weights
    if os.path.isdir(weights):
        raise SystemExit(
            f"poreover-tpu-torch: --weights {weights} is a directory without "
            "a TensorFlow checkpoint bundle or a checkpoint of the port's "
            "trainer; if it is an orbax checkpoint of the JAX trainer, "
            "convert it with `python tools/orbax_to_torch.py CHECKPOINT "
            "OUT` and pass OUT")
    raise SystemExit(
        f"poreover-tpu-torch: --weights {weights} is neither a TensorFlow "
        "checkpoint bundle (no .index) nor a checkpoint of the port's "
        "trainer")


def load_model(args, device) -> PoreOverNet:
    """The network of ``--model`` with the weights of ``--weights``, in
    eval mode on ``device``."""
    from ..io.tf_checkpoint import load_keras_conv1_bigru3

    net = _model_from_args(args)
    path = weights_path(args.weights)
    if _is_tf_bundle(path):
        net.load_state_dict(params_from_flax(load_keras_conv1_bigru3(path),
                                             net.arch))
    else:
        net.load_state_dict(load_params(path))
    return net.eval().to(device)


def make_forward(net: PoreOverNet, device):
    """``forward(batch)``: a [128, window, 1] numpy batch -> float32
    softmax probabilities [128, window', 5] as numpy, computed on
    ``device``."""

    @torch.inference_mode()
    def forward(batch):
        x = torch.as_tensor(np.asarray(batch, np.float32)).to(device)
        return torch.softmax(net(x), dim=-1).cpu().numpy()

    return forward


def input_files(in_path: str) -> list[str]:
    if os.path.isdir(in_path):
        return sorted(glob.glob(os.path.join(in_path, "*.fast5")))
    return [in_path]


def call(args) -> None:
    dev = resolve_device(getattr(args, "device", None))
    forward = make_forward(load_model(args, dev), dev)
    for fast5 in input_files(getattr(args, "in")):
        call_helper(args, forward, fast5)


def call_helper(args, forward, fast5_file: str) -> None:
    read_id, signal = parse_fast5(fast5_file, scaling=args.scaling)
    if args.use_id:
        stem = (read_id.decode("utf-8") if isinstance(read_id, bytes)
                else str(read_id))
    else:
        stem = Path(fast5_file).stem
    call_signal(args, forward, signal, stem)


def call_signal(args, forward, signal: np.ndarray, stem: str) -> None:
    """The probabilities of one scaled signal, written as ``args.dir /
    stem`` (``.npy``, or ``.csv`` with ``--format csv``)."""
    padded_batches, last_index = batch_input(signal, window_size=args.window)

    outputs = []
    for batch in padded_batches:
        outputs.append(np.concatenate(forward(batch)))
    if last_index > 0:
        outputs[-1] = outputs[-1][:last_index]
    probs_concat = np.concatenate(outputs)

    out_prefix = os.path.join(args.dir, stem)
    if args.format == "csv":
        np.savetxt(
            out_prefix + ".csv", probs_concat, delimiter=",",
            header=",".join(["A", "C", "G", "T", ""]), comments="",
        )
    else:
        np.save(out_prefix, probs_concat)
    log.info("wrote %s probabilities for %s", probs_concat.shape, out_prefix)
