"""1D decode pipeline: probability traces -> FASTA.

Port of ``poreover_tpu/decoding/decode.py`` (the reference's,
poreover/decoding/decode.py:114-192): glob input files by basecaller
extension, decode each read with the selected algorithm, write one FASTA.
Reads are batched into waves by kind and length bucket and decoded on the
device; file IO stays on the host. The multi-host branch of the JAX package's
``decode`` is not ported.

On a CUDA device ``--algorithm beam`` with ``beam_width * 5 <= 128`` runs
in the hand-written kernel ``csrc/beam1d.cu`` (``ops/beam1d.py``); wider
beams, and the CPU, take the engine ``ops/beam.py:beam_search_batch``. A
read that fails to load or has the wrong shape is skipped with a warning.
A kernel that fails to build or launch, or a missing device, ends the run:
there is no per-read or CPU fallback.
"""
from __future__ import annotations

import glob
import logging
import os
from pathlib import Path

import numpy as np

from ..device import resolve_device
from ..io.trace import model_from_trace
from ..models.transducer import MODEL_STRING, remove_repeated
from ..utils.fasta import fasta_format
from ..utils.timers import timers

log = logging.getLogger("poreover_tpu_torch")

_BASECALLER_EXT = {
    "guppy": ".fast5",
    "flappie": ".hdf5",
    "bonito": ".npy",
    "poreover": ".npy",
}


def collect_input_files(in_paths, basecaller: str):
    if len(in_paths) == 1 and os.path.isdir(in_paths[0]):
        ext = _BASECALLER_EXT[basecaller]
        return sorted(glob.glob(os.path.join(in_paths[0], "*" + ext)))
    return list(in_paths)


def _uses_kernel(dev, beam_width: int) -> bool:
    """The kernel packs W*(A+1) candidates into one CTA of 128 threads;
    wider beams take the engine on the same device."""
    return dev.type == "cuda" and beam_width * 5 <= 128


def _dispatch_beam(log_probs, kind: str, beam_width: int, dev):
    """Start a beam-search decode of one wave; returns a function that
    blocks and yields the strings. On the kernel's route the upload and the
    launch are asynchronous; the engine's outputs are host strings
    already."""
    if _uses_kernel(dev, beam_width):
        from ..ops.beam1d import fetch_beam1d, launch_beam1d, prepare_beam1d

        with timers.stage("prepare_upload"):
            prep = prepare_beam1d(log_probs, beam_width=beam_width,
                                  model=MODEL_STRING[kind], device=dev)
        with timers.stage("launch"):
            outs = launch_beam1d(prep)

        def finalize():
            with timers.stage("fetch_traceback"):
                return fetch_beam1d(prep, outs)

        return finalize
    from ..ops.beam import beam_search_batch

    with timers.stage("engine"):
        seqs = beam_search_batch(log_probs, beam_width=beam_width,
                                 model=MODEL_STRING[kind], device=dev)
    return lambda: seqs


def decode_read(model, algorithm: str, beam_width: int = 25,
                window: int = 400, device=None) -> str:
    """Decode one read's probability table to a sequence string."""
    if algorithm == "viterbi":
        return model.viterbi_decode(device=device)
    if algorithm == "beam":
        return _dispatch_beam([model.log_prob], model.kind, beam_width,
                              resolve_device(device))()[0]
    if algorithm == "prefix":
        assert model.kind == "poreover"
        from ..ops.prefix import prefix_search_log

        # window the read as the reference does (decode.py:182-188) so
        # results are comparable with its chunked prefix search
        seq = []
        i = 0
        t_max = model.t_max
        while i + window < t_max:
            seq.append(prefix_search_log(model.log_prob[i:i + window],
                                         device=device)[0])
            i += window
        seq.append(prefix_search_log(model.log_prob[i:], device=device)[0])
        return "".join(seq)
    raise ValueError(f"unknown algorithm {algorithm!r}")


def _path_to_seq(model, path: np.ndarray) -> str:
    """Viterbi path -> sequence per model kind (transducer.py:72/83/148
    semantics, applied to a device-computed path)."""
    if model.kind == "poreover":
        return model.path_to_string(path)
    if model.kind == "bonito":
        keep = np.ones(len(path), dtype=bool)
        keep[1:] = path[1:] != path[:-1]
        return model.path_to_string(path[keep])
    return remove_repeated(model.path_to_string(path)).upper()


def _decode_batched(entries, algorithm: str, beam_width: int, wave: int,
                    device=None):
    """Decode (idx, path, model) entries in device batches ("waves").

    Reads are grouped by kind and, where a wave is padded to its longest
    read (the engine, the Viterbi decoders), by length bucket, as the JAX
    package groups them. The beam kernel pads nothing (each CTA loops over
    its own read), so on its route a kind is one group, sorted by length so
    that a wave's reads end together; a read decodes the same in any
    wave. One launch per wave instead of one per read. Waves are
    software-pipelined at depth 1: wave i+1 is prepared,
    uploaded and launched before wave i's results are fetched, so its host
    work and transfer overlap wave i's kernel, and the device holds at
    most two waves. Returns {idx: seq}. Nothing is caught: a wave that
    fails ends the run.
    """
    import torch

    from ..ops.beam import _pad_bucket

    dev = resolve_device(device)
    unpadded = algorithm == "beam" and _uses_kernel(dev, beam_width)
    groups: dict[tuple, list] = {}
    for e in sorted(entries, key=lambda e: e[2].t_max) if unpadded \
            else entries:
        key = (e[2].kind, 0 if unpadded else _pad_bucket(e[2].t_max))
        groups.setdefault(key, []).append(e)

    results = {}
    pending = []  # finalize functions in dispatch order

    def dispatch(batch, kind, bucket):
        if algorithm == "beam":
            fin = _dispatch_beam([e[2].log_prob for e in batch], kind,
                                 beam_width, dev)
            return lambda: [(e[0], s) for e, s in zip(batch, fin())]
        if kind == "flipflop":
            from ..ops.viterbi import viterbi_path_masked_batch

            with timers.stage("viterbi_dp"):
                paths = viterbi_path_masked_batch(
                    [e[2].log_prob.astype(np.float32) for e in batch],
                    batch[0][2].transition, device=dev)
            return lambda: [(e[0], _path_to_seq(e[2], np.asarray(p)))
                            for e, p in zip(batch, paths)]
        # unconstrained CTC kinds: Viterbi == per-step argmax
        from ..ops.viterbi import argmax_path_batch

        with timers.stage("prepare_upload"):
            yb = np.full(
                (len(batch), bucket, batch[0][2].log_prob.shape[1]),
                -np.inf, np.float32)
            # pad with blank-wins rows so the padded tail decodes to gaps
            # that drop out of the string
            yb[:, :, -1] = 0.0
            for i, e in enumerate(batch):
                yb[i, :e[2].t_max] = e[2].log_prob
            y_h = torch.from_numpy(yb)
            if dev.type == "cuda":
                y_h = y_h.pin_memory()
        with timers.stage("launch"):
            dev_paths = argmax_path_batch(y_h, device=dev)  # asynchronous

        def finalize():
            with timers.stage("fetch_traceback"):
                paths = dev_paths.cpu().numpy()
                return [(e[0], _path_to_seq(e[2], paths[i, :e[2].t_max]))
                        for i, e in enumerate(batch)]

        return finalize

    def drain_one():
        for idx, seq in pending.pop(0)():
            results[idx] = seq

    for (kind, bucket), group in sorted(groups.items()):
        for w0 in range(0, len(group), wave):
            batch = group[w0:w0 + wave]
            log.info(
                "decoding wave: %d reads (kind=%s, bucket=%d, algorithm=%s)",
                len(batch), kind, bucket, algorithm)
            pending.append(dispatch(batch, kind, bucket))
            while len(pending) > 1:
                drain_one()

    while pending:
        drain_one()
    return results


def decode(args) -> None:
    timers.reset()
    dev = resolve_device(getattr(args, "device", None))
    in_files = collect_input_files(getattr(args, "in"), args.basecaller)
    log.info("found %d reads to decode", len(in_files))
    out_path = args.out + ".fasta"
    threads = max(int(getattr(args, "threads", 1) or 1), 1)

    # host IO first, isolating per-read load failures (the reference's Pool
    # silently swallows crashed workers, decode.py:140-162; we log + skip)
    entries = []
    with timers.stage("load"):
        for idx, path in enumerate(in_files):
            try:
                model = model_from_trace(path, args.basecaller)
                if model.log_prob.ndim != 2 or model.t_max < 1:
                    raise ValueError(
                        f"trace of shape {model.log_prob.shape}")
                entries.append((idx, path, model))
            except Exception as exc:
                log.warning("skipping unreadable trace %s: %s", path, exc)

    results: dict[int, str] = {}
    if args.algorithm in ("viterbi", "beam") and len(entries) > 1:
        results = _decode_batched(
            entries, args.algorithm, args.beam_width, wave=max(16, threads),
            device=dev)
    else:
        for idx, path, model in entries:
            results[idx] = decode_read(
                model, args.algorithm, beam_width=args.beam_width,
                window=args.window, device=dev)

    with timers.stage("fasta"):
        with open(out_path, "w") as out_f:
            for idx, path in enumerate(in_files):
                if idx in results:
                    print(fasta_format(Path(path).stem, results[idx]),
                          file=out_f)
    log.info("wrote %d/%d sequences to %s", len(results), len(in_files),
             out_path)
    timers.log_summary("decode stage timers")
