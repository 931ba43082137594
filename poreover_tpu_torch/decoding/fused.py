"""Fused basecall + decode: raw signal in, sequence out, on the device.

Port of ``poreover_tpu/decoding/fused.py``. The two-stage pipeline saves
each read's [T, 5] softmax probabilities (``call``) and decodes them
(``decode``); here the network's output stays on the device and feeds the
decoder there:

- ``--decode viterbi``: the per-step argmax of the logits on the device
  (the poreover Viterbi path, models/transducer.py), only int8 paths come
  back. The argmax of the logits is the argmax of the saved softmax
  probabilities (softmax is monotone per row), up to probabilities that
  round to equal values.
- ``--decode beam``: the forward, then ``log(softmax(logits))`` as the same
  two ops the two-stage pipeline applies (``call`` saves the softmax,
  ``decode`` takes its log), then the reads packed on the device straight
  into the 1D beam kernel's inputs (``ops/beam1d.py``: rows back to back,
  the root's cumulative blank in float64 rounded once), one launch per
  wave of reads; only the decoded characters come back. The [T, 5]
  probabilities never visit the host. On the CPU, and for beams wider than
  the kernel takes, the beam search engine ``ops/beam.py`` decodes the
  same log-probabilities, as ``decode`` does.

The forward runs at ``call``'s batch shape, [128, window, 1], one
batch at a time: another shape may take other cuBLAS / cuDNN algorithms
and round the logits differently, and the decodes then differ from the
two-stage pipeline's (the JAX package records the same for its TPU
products, ``fused.py:fwd128``).

The two pipelines take the log on different processors: ``decode`` with
numpy on the host, this path with the device's ``log``. The two may differ
in the last bit; PERF.md records how often, and what that does to the
strings.
"""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..io.fast5 import batch_input, parse_fast5

log = logging.getLogger("poreover_tpu_torch")

WAVE = 32  # reads per launch of the 1D beam kernel


def _windows(signal: np.ndarray, window: int):
    """(the signal's [nb, 128, window, 1] float32 batches, its steps)."""
    batches, last_index = batch_input(np.asarray(signal, np.float32),
                                      window_size=window)
    T = (len(batches) - 1) * 128 * window + (
        last_index if last_index else 128 * window)
    return batches.astype(np.float32), T


def make_fused_viterbi(net, window: int = 1000, device=None):
    """Returns ``run(signal_windows [NB, 128, window, 1])`` -> int8 argmax
    paths [NB * 128 * window'] as numpy; the forward and the argmax run on
    ``device`` (default cuda), one [128, window, 1] batch at a time."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def run(sig):
        x = torch.as_tensor(np.asarray(sig, np.float32)).to(dev)
        return torch.cat([torch.argmax(net(x[k]), dim=-1).to(torch.int8)
                          .reshape(-1) for k in range(x.shape[0])]
                         ).cpu().numpy()

    return run


def fused_basecall_viterbi(run, signal: np.ndarray, window: int = 1000,
                           alphabet: str = "ACGT") -> str:
    """signal [T] -> sequence, via the fused device call ``run``."""
    batches, T = _windows(signal, window)
    path = run(batches)[:T]
    A = len(alphabet)
    return "".join(alphabet[c] for c in path if c < A)


def make_fused_beam(net, window: int = 1000, beam_width: int = 25,
                    alphabet: str = "ACGT", device=None):
    """Fused basecall + beam search (ctc). Returns ``decode_reads(signals)
    -> list[str]``: per wave of ``WAVE`` reads, each read's log-softmax
    probabilities computed on ``device`` (default cuda) and packed there
    into the 1D beam kernel's inputs, one launch per wave."""
    from .decode import _uses_kernel

    dev = resolve_device(device)
    A = len(alphabet)

    @torch.inference_mode()
    def log_probs(signal):
        batches, T = _windows(signal, window)
        x = torch.as_tensor(batches).to(dev)
        parts = [torch.log(torch.softmax(net(x[k]), dim=-1))
                 for k in range(x.shape[0])]
        return torch.cat([p.reshape(-1, p.shape[-1]) for p in parts])[:T]

    def decode_wave(ys) -> list[str]:
        if not _uses_kernel(dev, beam_width):
            from ..ops.beam import beam_search_batch

            return beam_search_batch([y.cpu().numpy() for y in ys],
                                     beam_width=beam_width, alphabet=alphabet,
                                     model="ctc", device=dev)
        from ..ops.beam1d import beam1d_cuda, fetch_beam1d

        y, root, meta, meta_h = pack_planes(ys)
        outs = beam1d_cuda(y, root, meta, meta_h, beam_width, A, 0)
        return fetch_beam1d(dict(meta=meta_h, alphabet=alphabet), outs)

    def decode_reads(signals) -> list[str]:
        out: list[str] = []
        for g0 in range(0, len(signals), WAVE):
            out.extend(decode_wave([log_probs(s)
                                    for s in signals[g0:g0 + WAVE]]))
        return out

    return decode_reads


def pack_planes(ys):
    """Device counterpart of ``ops/beam1d.py:planes_from_numpy`` for ctc:
    reads' [T_i, A+1] float32 log-probs on one device -> (y [sum T, A+1],
    root [sum T], meta int64 [B, 2] on the device, meta as numpy). The
    root's value at t is the read's cumulative blank through t-1, summed in
    float64 and rounded once."""
    lens = np.array([y.shape[0] for y in ys], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    y = torch.cat(ys).contiguous()
    root = torch.zeros(y.shape[0], dtype=torch.float32, device=y.device)
    for o, t in zip(offs.tolist(), lens.tolist()):
        root[o + 1:o + t] = torch.cumsum(
            y[o:o + t - 1, -1].to(torch.float64), 0).to(torch.float32)
    meta_h = np.stack([offs, lens], 1).reshape(-1, 2)
    return y, root, torch.as_tensor(meta_h).to(y.device), meta_h


def call_and_decode(args) -> None:
    """CLI: ``call --decode viterbi|beam``: fast5 signal -> FASTA, the
    network's output decoded on the device."""
    from ..network.call import input_files, load_model

    dev = resolve_device(getattr(args, "device", None))
    net = load_model(args, dev)
    files = input_files(getattr(args, "in"))
    names, signals = [], []
    for f in files:
        try:
            _, signal = parse_fast5(f, scaling=args.scaling)
        except Exception as exc:  # one unreadable file skips that read
            log.warning("fused basecall failed for %s: %s", f, exc)
            continue
        names.append(Path(f).stem)
        signals.append(signal)
    decode_signals(args, net, names, signals, dev)
    log.info("fused call+decode: %d of %d files read", len(signals),
             len(files))


def decode_signals(args, net, names, signals, dev) -> None:
    """The FASTA ``args.out + ".fasta"`` of the scaled ``signals``, one
    record per name, decoded by ``args.decode`` on the device ``dev``."""
    from ..utils.fasta import fasta_format

    if args.decode == "beam":
        seqs = make_fused_beam(
            net, window=args.window,
            beam_width=getattr(args, "beam_width", 25), device=dev)(signals)
    else:
        run = make_fused_viterbi(net, window=args.window, device=dev)
        seqs = [fused_basecall_viterbi(run, s, window=args.window)
                for s in signals]
    out_path = (args.out or "fused") + ".fasta"
    with open(out_path, "w") as out_f:
        for name, seq in zip(names, seqs):
            print(fasta_format(name, seq), file=out_f)
    log.info("fused call+decode: wrote %d sequences to %s", len(seqs),
             out_path)
