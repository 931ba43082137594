"""1D^2 pair consensus decoding pipeline (PyTorch/CUDA port).

Port of ``poreover_tpu/decoding/pair.py`` for the main path: poreover CTC
traces, ``--method envelope``, ``--algorithm beam``, ``row_col``,
``--single viterbi``. Stages per pair (reference pair_decode.py:305-529):
  1. 1D basecall of both reads (per-step argmax, numpy)
  2. Global alignment of the two basecalls (banded NW, C++ via ctypes)
  3. Banded alignment envelope over the U x V lattice (numpy)
  4. Consensus: the row_col pair beam search over the envelope, in waves
     of ``--threads`` pairs through one launch of the CUDA kernel
     (ops/pair_beam_batch.py); on ``--device cpu`` its plain PyTorch
     version runs instead.

Skip rules and the TSV summary log match the reference: length mismatch
> 1000 bases (pair_decode.py:372-375), pairwise identity < 0.5 (:395-398).
Results are written in input order. Multi-host sharding of the JAX package
is not ported: one process drives one device.
"""
from __future__ import annotations

import copy
import logging
import os
import pickle
import sys
import time
from pathlib import Path

import numpy as np

from .. import native
from ..io.trace import model_from_trace
from ..utils.fasta import fasta_format
from ..utils.timers import timers
from . import envelope as envelope_mod

log = logging.getLogger("poreover_tpu_torch")

LOG_COLUMNS = ["read1", "read2", "length1", "length2", "sequence_identity", "skipped"]


def get_sequence_mapping(path, kind: str):
    """Map a Viterbi path to (sequence->signal, signal->sequence) indices
    (reference pair_decode.py:114-142)."""
    signal_to_sequence = []
    sequence_to_signal = []
    label_len = 0
    if kind == "poreover":
        for i, p in enumerate(path):
            if p < 4:
                sequence_to_signal.append(i)
                signal_to_sequence.append(label_len)
                label_len += 1
    elif kind == "flipflop":
        for i, _ in enumerate(path):
            if i == 0:
                sequence_to_signal.append(i)
                signal_to_sequence.append(label_len)
            else:
                if path[i] != path[i - 1]:
                    label_len += 1
                    sequence_to_signal.append(i)
                signal_to_sequence.append(label_len)
    elif kind == "bonito":
        for i, p in enumerate(path):
            if p == 4 or path[i] == path[i - 1]:
                pass
            else:
                sequence_to_signal.append(i)
                signal_to_sequence.append(label_len)
                label_len += 1
    return sequence_to_signal, signal_to_sequence


def _alignment_to_sequence(alignment):
    """Alignment column -> sequence index map (pair_decode.py:403-410)."""
    a2s = np.zeros(alignment.shape, dtype=int)
    for i, col in enumerate(alignment.T):
        for s in range(2):
            if col[s] == "-":
                a2s[s, i] = a2s[s, i - 1]
            else:
                a2s[s, i] = a2s[s, i - 1] + 1
    return a2s


def pair_decode_helper(args, _workload_sink=None):
    """Decode one pair.

    ``_workload_sink``: optional callable. When the pair reaches stage 4,
    the prepared (y1, y2, envelope) workload plus a ``finish(consensus)``
    continuation are handed to the sink and this function returns None;
    pair_decode batches the sunk workloads into kernel waves. Without a
    sink the pair's consensus runs here, as a wave of one.
    """
    in_path = list(getattr(args, "in"))
    assert len(in_path) == 2, "exactly two reads are required"

    path1 = Path(in_path[0])
    path2 = Path(in_path[1])
    if path1.suffix == ".fast5":
        path1 = path1.with_suffix(".npy")
    if path2.suffix == ".fast5":
        path2 = path2.with_suffix(".npy")

    model1 = model_from_trace(os.path.join(args.dir, path1), args.basecaller)
    model2 = model_from_trace(os.path.join(args.dir, path2), args.basecaller)
    U = model1.t_max
    V = model2.t_max

    if args.reverse_complement:
        model2.reverse_complement()
    assert model1.kind == model2.kind
    if model1.kind != "poreover":
        raise NotImplementedError(
            f"{model1.kind} pair consensus is not ported to PyTorch yet "
            "(ROADMAP item A2b)")

    summary = {"read1": in_path[0], "read2": in_path[1]}
    y1 = model1.log_prob
    y2 = model2.log_prob

    if not args.diagonal_envelope:
        # ---- stage 1: 1D basecalls ----
        _t0 = time.perf_counter()
        basecall1, viterbi_path1 = model1.viterbi_decode(return_path=True)
        basecall2, viterbi_path2 = model2.viterbi_decode(return_path=True)

        if abs(len(basecall1) - len(basecall2)) > 1000:
            log.warning("skipping pair due to length mismatch")
            summary.update(
                length1=len(basecall1), length2=len(basecall2), skipped=1
            )
            return (summary,)

        sequence_to_signal1, _ = get_sequence_mapping(viterbi_path1, model1.kind)
        assert len(sequence_to_signal1) == len(basecall1)
        sequence_to_signal2, _ = get_sequence_mapping(viterbi_path2, model2.kind)
        assert len(sequence_to_signal2) == len(basecall2)
        timers.seconds["1d_basecall"] += time.perf_counter() - _t0

        # ---- stage 2: align the 1D basecalls ----
        _t0 = time.perf_counter()
        if args.alignment == "full":
            a1, a2 = native.global_pair(basecall1, basecall2)[:2]
        else:
            a1, a2 = native.global_pair_banded(basecall1, basecall2)
        alignment = np.array([list(a1), list(a2)])
        sequence_identity = np.sum(alignment[0] == alignment[1]) / len(alignment[0])
        timers.seconds["align_1d"] += time.perf_counter() - _t0

        if sequence_identity < 0.5:
            log.warning(
                "skipping pair due to low pairwise identity (%.3f); did you "
                "mean --reverse_complement?", sequence_identity,
            )
            summary.update(
                length1=len(basecall1),
                length2=len(basecall2),
                sequence_identity=sequence_identity,
                skipped=1,
            )
            return (summary,)

        summary.update(
            length1=len(basecall1),
            length2=len(basecall2),
            sequence_identity=sequence_identity,
            skipped=0,
        )

    # ---- stage 3: envelope ----
    _t0 = time.perf_counter()
    if args.diagonal_envelope:
        alignment_envelope = envelope_mod.diagonal_envelope(
            U, V, args.diagonal_width
        )
    else:
        if args.debug:
            with open("debug.p", "wb") as pfile:
                pickle.dump(
                    {
                        "alignment_to_sequence": _alignment_to_sequence(
                            alignment),
                        "sequence_to_signal1": sequence_to_signal1,
                        "sequence_to_signal2": sequence_to_signal2,
                        "alignment": alignment,
                    },
                    pfile,
                )
        alignment_col = envelope_mod.get_alignment_columns(alignment)
        alignment_envelope = envelope_mod.build_envelope(
            y1, y2, alignment_col, sequence_to_signal1, sequence_to_signal2,
            padding=args.padding,
        )
    timers.seconds["envelope"] += time.perf_counter() - _t0

    if getattr(args, "debug_envelope", False):
        size = alignment_envelope[:, 1] - alignment_envelope[:, 0]
        print(
            path1.stem, path2.stem, len(basecall1), len(basecall2), U, V,
            np.mean(size), np.std(size), np.median(size), np.min(size),
            np.max(size),
        )
        return ({"skipped": 1},)

    def _format_result(joined_basecalls):
        if args.diagonal_envelope:
            return (
                fasta_format(
                    f"consensus;{path1.stem};{path2.stem}", joined_basecalls
                ),
                summary,
            )
        return (
            fasta_format(in_path[0], basecall1) + fasta_format(in_path[1], basecall2),
            fasta_format(f"consensus;{path1.stem};{path2.stem}", joined_basecalls),
            summary,
        )

    # ---- stage 4: consensus ----
    workload = (y1, y2, alignment_envelope)
    if _workload_sink is not None:
        _workload_sink(workload, _format_result, summary)
        return None
    return _format_result(_batched_consensus([workload], args)[0])


def _batched_consensus(workloads, args):
    """Decode prepared (y1, y2, envelope) workloads in waves of
    ``args.threads`` pairs, one kernel launch per wave. Wave i+1's host
    prep and upload are enqueued before wave i's results are fetched, so
    they overlap wave i's kernel on the card. A failed build or launch
    raises: there is no per-pair or CPU fallback."""
    from ..ops.pair_beam_batch import (
        fetch_prepared, launch_prepared, prepare_pairs,
    )

    wave = max(int(args.threads), 1)
    chunks = [workloads[i:i + wave] for i in range(0, len(workloads), wave)]
    out: list[str] = []
    _t0 = time.perf_counter()
    pending = None
    for i, chunk in enumerate(chunks):
        log.info("consensus wave %d/%d (one kernel launch)", i + 1,
                 len(chunks))
        prep = prepare_pairs(chunk, beam_width=args.beam_width,
                             device=args.device)
        outs = launch_prepared(prep)
        if pending is not None:
            out.extend(fetch_prepared(*pending))
        pending = (prep, outs)
    if pending is not None:
        out.extend(fetch_prepared(*pending))
    timers.seconds["consensus_2d"] += time.perf_counter() - _t0
    timers.add_work(
        "consensus_2d",
        float(sum(np.sum(env[:, 1] - env[:, 0]) for _, _, env in workloads)),
    )
    return out


def pair_decode(args) -> None:
    timers.reset()
    in_path = getattr(args, "in")
    if len(in_path) == 1:
        # pairs file: one "read1 read2" pair per line (pair_decode.py:252-297)
        with open(in_path[0]) as f:
            pairs = [line.split() for line in f if line.split()]

        out_1d = open(args.out + ".1d.fasta", "w")
        out_2d = open(args.out + ".2d.fasta", "w")
        log_f = open(args.out + ".log", "w", 1)
        print("# PoreOver-TPU pair-decode", file=log_f)
        print("# " + str(vars(args)), file=log_f)
        print("# " + "\t".join(LOG_COLUMNS), file=log_f)
        log.info("found %d read pairs in %s", len(pairs), in_path[0])

        def emit(result):
            if len(result) == 3:
                print(result[0], file=out_1d)
                print(result[1], file=out_2d)
                print(
                    "\t".join(str(result[2].get(k, "")) for k in LOG_COLUMNS),
                    file=log_f,
                )
            elif len(result) == 2:
                print(result[0], file=out_2d)
                print(
                    "\t".join(str(result[1].get(k, "")) for k in ["read1", "read2"]),
                    file=log_f,
                )
            else:
                print(
                    "\t".join(str(result[0].get(k, "")) for k in LOG_COLUMNS),
                    file=log_f,
                )

        # Results are buffered per pair index and emitted strictly in input
        # order. Stage-4 workloads flush in waves of `wave` pairs, so host
        # memory holds at most one wave of log-prob planes.
        wave = max(int(args.threads), 1)
        results: dict[int, tuple] = {}
        pending: list[tuple] = []  # (pair idx, workload, finish, summary)
        emit_cursor = 0

        def emit_ready():
            nonlocal emit_cursor
            while emit_cursor < len(pairs) and emit_cursor in results:
                emit(results[emit_cursor])
                emit_cursor += 1

        def flush_pending():
            if not pending:
                return
            seqs = _batched_consensus([wl for _, wl, _, _ in pending], args)
            for (idx, _, finish, _), seq in zip(pending, seqs):
                results[idx] = finish(seq)
            pending.clear()
            emit_ready()

        for idx, pair in enumerate(pairs):
            args_copy = copy.copy(args)
            setattr(args_copy, "in", pair)
            sink = (lambda wl, finish, summ, idx=idx:
                    pending.append((idx, wl, finish, summ)))
            try:
                r = pair_decode_helper(args_copy, _workload_sink=sink)
            except NotImplementedError:
                raise
            except Exception as exc:
                # one corrupt trace must not abort the whole pairs file (the
                # reference's Pool.apply_async swallows worker crashes)
                log.warning("pair %s failed: %s", pair, exc)
                r = ({"read1": pair[0], "read2": pair[1], "skipped": 1},)
            if r is not None:
                results[idx] = r
            emit_ready()
            if len(pending) >= wave:
                flush_pending()
        flush_pending()
        emit_ready()

        out_1d.close()
        out_2d.close()
        log_f.close()
        timers.log_summary("pair-decode stage timers")
    else:
        result = pair_decode_helper(args)
        print(result[-1], file=sys.stderr)
        with open(args.out + ".fasta", "w") as f:
            print(result[-2] if len(result) > 1 else "", file=f)
        timers.log_summary("pair-decode stage timers")
