"""``train``: CTC training loop with checkpointing.

Port of ``poreover_tpu/network/train.py`` (reference train/train_ctc_model,
poreover/network/network.py:78-179): npz training data {signal, labels,
row_lengths}, Adam, a loss line every --loss_every steps, a checkpoint and
a validation every --save_every steps (step 0 included) plus a final
save, holdout validation by normalised edit distance of the greedy path,
a run directory "{model}_{name}_{date}_{time}" with ``train.log`` (the
arguments), ``model.json`` (the architecture) and ``metrics.jsonl``. The
shuffle and the holdout split are the JAX trainer's, so the batches are
the same.

The step (``train_step``) runs on ``--device`` (cuda unless cpu is asked
for): the network's forward, the CTC loss (``ops/ctc.py``: the kernels of
``csrc/ctc.cu`` on the card, their plain version on the CPU), the mean over
the batch, the backward pass and ``torch.optim.Adam`` with optax.adam's
defaults (betas 0.9 / 0.999, eps 1e-8; the two differ only in the order of
their float32 operations). Initial weights come from the port's seeded
numpy initialiser (``network/model.py:init_params``), so a run from scratch
does not follow the JAX trainer's ``jax.random`` weights; the network keeps
TF32 off (``network/model.py:exact_float32``). Checkpoints are the port's
own format (``network/checkpoint.py``).
"""
from __future__ import annotations

import datetime
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.ctc import ctc_loss
from .call import latest_checkpoint, make_forward
from .checkpoint import load_params, save_params
from .model import PoreOverNet, init_params, params_from_flax

log = logging.getLogger("poreover_tpu_torch")

# optax.adam's defaults (b1, b2, eps; eps_root 0)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def load_training_npz(path: str):
    """-> (signal [N, T, 1] float32, labels [N, Lmax] int32, lengths [N])."""
    with np.load(path) as data:
        signal = np.expand_dims(data["signal"], axis=2).astype(np.float32)
        flat = data["labels"].astype(np.int32)
        row_lengths = data["row_lengths"].astype(np.int32)
    Lmax = int(row_lengths.max())
    labels = np.zeros((len(row_lengths), Lmax), np.int32)
    pos = 0
    for i, n in enumerate(row_lengths):
        labels[i, :n] = flat[pos : pos + n]
        pos += n
    return signal, labels, row_lengths


def edit_distance(a, b) -> int:
    """Levenshtein distance (for validation error, reference network.py:69-76)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def greedy_labels(probs: np.ndarray) -> list:
    """argmax path, keep non-blank (reference validation: x[x < 4])."""
    paths = np.argmax(probs, axis=-1)
    return [p[p < 4] for p in paths]


def validation_error(forward, params, batches) -> float:
    """Mean normalised edit distance of the greedy paths over ``batches``;
    ``forward(params, X)`` returns softmax probabilities as numpy."""
    dists = []
    for X, y, ylen in batches:
        probs = np.asarray(forward(params, X))
        hyp = greedy_labels(probs)
        for h, lab, n in zip(hyp, y, ylen):
            truth = lab[:n]
            if len(truth) == 0:
                continue
            dists.append(edit_distance(list(h), list(truth)) / len(truth))
    return float(np.mean(dists)) if dists else float("nan")


def make_batches(signal, labels, row_lengths, batch_size: int,
                 holdout: float, seed: int):
    """The JAX trainer's shuffle and holdout split (reference
    network.py:154-179): (test batches, train batches), each a list of
    (X, y, ylen) numpy arrays."""
    order = np.random.default_rng(seed).permutation(len(signal))
    B = batch_size
    n_batches = len(signal) // B
    validation_size = int(n_batches * holdout)
    batches = [
        (
            signal[order[i * B : (i + 1) * B]],
            labels[order[i * B : (i + 1) * B]],
            row_lengths[order[i * B : (i + 1) * B]],
        )
        for i in range(n_batches)
    ]
    return batches[:validation_size], batches[validation_size:]


def make_optimizer(net, learning_rate: float) -> torch.optim.Adam:
    return torch.optim.Adam(net.parameters(), lr=learning_rate,
                            betas=ADAM_BETAS, eps=ADAM_EPS)


def to_device(X, y, ylen, device):
    """One batch's numpy arrays as tensors on ``device`` (float32 signal,
    int32 labels and lengths)."""
    return (torch.as_tensor(np.asarray(X, np.float32)).to(device),
            torch.as_tensor(np.asarray(y, np.int32)).to(device),
            torch.as_tensor(np.asarray(ylen, np.int32)).to(device))


def train_step(net: PoreOverNet, opt, X, y, ylen,
               merge: bool = False) -> torch.Tensor:
    """One update on a batch (tensors on the network's device): the mean
    CTC loss of the current weights, its gradient, one Adam step. Returns
    the loss (a 0-dim tensor, not synchronised)."""
    opt.zero_grad(set_to_none=True)
    loss = ctc_loss(net(X), y, ylen, merge_repeated=merge).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def train(args) -> None:
    dev = resolve_device(getattr(args, "device", None))
    out_dir = "{}_{}_{}".format(
        args.model, args.name, datetime.datetime.now().strftime("%Y-%m-%d_%H-%M")
    )
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "train.log"), "w") as f:
        print("Command-line arguments:", file=f)
        for k, v in vars(args).items():
            print(k, "=", v, file=f)

    seed = args.seed if args.seed is not None else 0

    signal, labels, row_lengths = load_training_npz(args.data)

    arch_config = dict(
        arch=args.model, num_neurons=args.num_neurons,
        kernel_size=args.kernel_size, filters=args.filters,
    )
    net = PoreOverNet(**arch_config)
    if args.restart:
        path = args.restart
        if os.path.isdir(path) and latest_checkpoint(path):
            path = latest_checkpoint(path)
        net.load_state_dict(load_params(path))
    else:
        net.load_state_dict(params_from_flax(
            init_params(seed=seed, **arch_config), args.model))
    net = net.to(dev).train()
    with open(os.path.join(out_dir, "model.json"), "w") as f:
        json.dump(arch_config, f)

    opt = make_optimizer(net, args.learning_rate)
    merge = bool(getattr(args, "ctc_merge_repeated", False))
    batch_probs = make_forward(net, dev)

    def forward(_, X):  # validation_error's (params, X) signature
        return batch_probs(X)

    test_batches, train_batches = make_batches(
        signal, labels, row_lengths, args.batch_size, args.holdout, seed)
    validation_size = len(test_batches)
    log.info(
        "training on %d batches of %d (holdout %d batches)",
        len(train_batches), args.batch_size, len(test_batches),
    )

    # scalar metrics stream to metrics.jsonl (one JSON object per event),
    # as the JAX trainer writes them
    with open(os.path.join(out_dir, "metrics.jsonl"), "w", 1) as metrics_f:

        def emit_metric(**kv):
            print(json.dumps(kv), file=metrics_f)

        t = 0
        checkpoint = 0
        t_start = time.perf_counter()
        for _epoch in range(args.epochs):
            for X, y, ylen in train_batches:
                loss = train_step(net, opt, *to_device(X, y, ylen, dev),
                                  merge)
                if t % args.save_every == 0:
                    save_params(
                        net,
                        os.path.join(out_dir, f"checkpoint-{checkpoint}"),
                        arch_config,
                    )
                    checkpoint += 1
                    if validation_size > 0:
                        err = validation_error(forward, net, test_batches)
                        print(
                            f"Iteration:{t}\tEdit distance (test):{err}",
                            file=sys.stderr,
                        )
                        emit_metric(step=t, test_edit_distance=float(err))
                if t % args.loss_every == 0:
                    print(f"Iteration:{t}\tLoss:{float(loss)}",
                          file=sys.stderr)
                    emit_metric(
                        step=t, loss=float(loss),
                        elapsed_s=round(time.perf_counter() - t_start, 3),
                    )
                t += 1
        save_params(net, os.path.join(out_dir, "final"), arch_config)
