"""1D^2 pair consensus decoding pipeline (PyTorch/CUDA port).

Port of ``poreover_tpu/decoding/pair.py`` for the main path: poreover,
bonito and flip-flop traces, ``--method envelope``, ``--algorithm beam``,
``row_col``, ``--single viterbi|beam``, and its anchored mode
``--skip_matches``. Stages per pair (reference pair_decode.py:305-529):
  1. 1D basecall of both reads: ``--single viterbi``, the per-step argmax
     (numpy; a flip-flop pair's two Viterbi DPs in one batched call on the
     device); ``--single beam``, the 1D beam search and the banded Viterbi
     acceptor's path of its string, each one launch for both reads
     (``models/transducer.py:beam_acceptor_batch``)
  2. Global alignment of the two basecalls (banded NW, C++ via ctypes)
  3. Banded alignment envelope over the U x V lattice (numpy)
  4. Consensus: the row_col pair beam search over the envelope, in waves
     of ``--threads`` pairs of one model kind through one launch of the
     CUDA kernel (ops/pair_beam_batch.py); on ``--device cpu`` its plain
     PyTorch version runs instead. ``--exact`` takes the kernel's graveyard
     instance (the reference's unbounded-memo semantics up to the
     graveyard's depth), ``--f64`` the plain version in float64 on the
     CPU (``cli.py`` sets the device).

Unlike the JAX package, which decodes bonito and flip-flop pairs one by
one through its XLA engine, the port batches every kind: a pairs file
keeps one queue of pending pairs per kind, each flushed as its own waves,
and the results are written in input order. The strings are the same.

Anchored mode (reference pair_decode.py:412-452): stretches where the two
1D basecalls agree for ``--skip_threshold`` bases are taken verbatim as
anchors, and only the boxes between anchors get a 2D consensus. The boxes
of a wave's pairs are pooled into one launch of the box kernel
(ops/box_beam.py); boxes over its storage limit go through the pair kernel.
Under ``--exact`` or ``--f64`` every box goes through the pair kernel (its
graveyard instance, or the float64 plain version), in waves of 32 sorted
by length, as the JAX package decodes such boxes with its planned engine.

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
from ..models.transducer import (
    MODEL_STRING, beam_acceptor_batch, viterbi_decode_batch,
)
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


def get_anchors(alignment, matches: int, indels: int):
    """Contiguous match/indel stretches usable as anchors
    (reference pair_decode.py:53-89)."""
    state_start = 0
    state_counter = 1
    prev_state = "START"
    anchor_ranges = []
    anchor_type = []
    for i, (a1, a2) in enumerate(alignment.T):
        if a1 == a2:
            state = "mat"
        elif a1 == "-":
            state = "ins"
        elif a2 == "-":
            state = "del"
        else:
            state = "mis"
        if prev_state == state and state != "mis":
            state_counter += 1
        else:
            if prev_state in ("ins", "del") and state_counter >= indels:
                anchor_ranges.append((state_start, i))
                anchor_type.append(prev_state)
            if prev_state == "mat" and state_counter >= matches:
                anchor_ranges.append((state_start, i))
                anchor_type.append(prev_state)
            prev_state = state
            state_counter = 1
            state_start = i
    return anchor_ranges, anchor_type


def _anchor_boxes(alignment, a2s, s2s1, s2s2, anchor_ranges, anchor_type,
                  U: int, V: int):
    """Anchors (sort_key, sequence) taken verbatim from the 1D alignment
    and the 4-coordinate signal boxes between them (reference
    pair_decode.py:412-452)."""
    boxes, anchors = [], []
    for i, (cs, ce) in enumerate(anchor_ranges):
        # 'mat' and 'del' take read 1's letters
        row = 1 if anchor_type[i] == "ins" else 0
        anchors.append((s2s1[a2s[0, cs]], "".join(alignment[row, cs:ce])))
        if i > 0:
            pe = anchor_ranges[i - 1][1]
            boxes.append((s2s1[a2s[0, pe]], s2s1[a2s[0, cs]],
                          s2s2[a2s[1, pe]], s2s2[a2s[1, cs]]))
        else:
            boxes.append((0, s2s1[a2s[0, cs]], 0, s2s2[a2s[1, cs]]))
    le = anchor_ranges[-1][1]
    boxes.append((s2s1[a2s[0, le]], U, s2s2[a2s[1, le]], V))
    return boxes, anchors


def anchored_box_workloads(y1, y2, envelope, alignment, s2s1, s2s2,
                           matches: int = 10, indels: int = 100):
    """Anchor/box decomposition for a prepared pair (the --skip_matches
    machinery as a standalone function): returns (box_workloads, anchors)
    where box_workloads are (sort_key, y1_slice, y2_slice, env_slice)
    consensus problems between anchors and anchors are (sort_key, sequence).
    Returns (None, None) when no anchors exist."""
    anchor_ranges, anchor_type = get_anchors(alignment, matches=matches,
                                             indels=indels)
    if not anchor_ranges:
        return None, None
    boxes, anchors = _anchor_boxes(
        alignment, _alignment_to_sequence(alignment), s2s1, s2s2,
        anchor_ranges, anchor_type, len(y1), len(y2))
    return extract_box_workloads(y1, y2, envelope, boxes), anchors


def extract_box_workloads(y1, y2, envelope, basecall_boxes):
    """Slice the per-pair consensus problem into independent anchor-box
    workloads (reference pair_decode.py:510-522 semantics): each box decodes
    the envelope restricted to its row range, rebased to its own y slices.
    Returns [(sort_key, y1_slice, y2_slice, env_slice), ...]; boxes with an
    empty row range contribute nothing (no signal)."""
    out = []
    for b in basecall_boxes:
        b0, b1 = b[0], b[1]
        env_slice = envelope[b0:b1]
        if len(env_slice) == 0:
            continue
        y2lo, y2hi = int(env_slice[0, 0]), int(env_slice[-1, 1])
        out.append((b0, y1[b0:b1], y2[y2lo:y2hi], env_slice - y2lo))
    return out


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
    the prepared (y1, y2, envelope) workload, a ``finish(consensus)``
    continuation, the pair's summary and its model kind are handed to the
    sink and this function returns None; pair_decode batches the sunk
    workloads of each kind into kernel waves. Without a sink the pair's
    consensus runs here, as a wave of one. In anchored mode the workload
    is the list of the pair's (y1, y2, envelope) boxes and ``finish``
    takes their consensi.
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
    kind = model1.kind

    summary = {"read1": in_path[0], "read2": in_path[1]}
    y1 = model1.log_prob
    y2 = model2.log_prob

    if not args.diagonal_envelope:
        # ---- stage 1: 1D basecalls ----
        _t0 = time.perf_counter()
        if args.single == "viterbi":
            # the flip-flop Viterbi DP is float32 even under --f64, as in
            # the JAX package
            decoded = viterbi_decode_batch([model1, model2],
                                           device=args.device)
        else:
            decoded = beam_acceptor_batch([model1, model2],
                                          device=args.device,
                                          dtype=_dtype(args))
        (basecall1, viterbi_path1), (basecall2, viterbi_path2) = decoded

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

        alignment_to_sequence = _alignment_to_sequence(alignment)

    # ---- anchor boxes for --skip_matches ----
    # (reference pair_decode.py:412-452: 4-coordinate boxes over both axes)
    if args.skip_matches:
        anchor_ranges, anchor_type = get_anchors(
            alignment, matches=args.skip_threshold, indels=100
        )
        assert len(anchor_ranges) > 0, (
            "No matches/indels of sufficient length found in alignment"
        )
        basecall_boxes, basecall_anchors = _anchor_boxes(
            alignment, alignment_to_sequence, sequence_to_signal1,
            sequence_to_signal2, anchor_ranges, anchor_type, U, V)
        assert abs(len(basecall_boxes) - len(basecall_anchors)) == 1

        if args.debug:
            with open("debug.p", "wb") as pfile:
                pickle.dump(
                    {
                        "alignment_to_sequence": alignment_to_sequence,
                        "sequence_to_signal1": sequence_to_signal1,
                        "sequence_to_signal2": sequence_to_signal2,
                        "alignment": alignment,
                        "basecall_boxes": basecall_boxes,
                        "basecall_anchors": basecall_anchors,
                        "anchor_ranges": anchor_ranges,
                    },
                    pfile,
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
                        "alignment_to_sequence": alignment_to_sequence,
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
    if args.skip_matches:
        # anchored mode: the pair's boxes join the wave's pooled box
        # launch; the finish continuation stitches the box consensi with
        # the anchor sequences
        box_workloads = extract_box_workloads(
            y1, y2, alignment_envelope, basecall_boxes
        )
        boxes = [(wl[1], wl[2], wl[3]) for wl in box_workloads]

        def _finish_boxes(seqs):
            joined = "".join(s for _, s in sorted(
                basecall_anchors
                + [(k, s) for (k, *_), s in zip(box_workloads, seqs)]
            ))
            return _format_result(joined)

        if _workload_sink is not None:
            _workload_sink(boxes, _finish_boxes, summary, kind)
            return None
        return _finish_boxes(_batched_box_consensus([boxes], args, kind)[0])
    workload = (y1, y2, alignment_envelope)
    if _workload_sink is not None:
        _workload_sink(workload, _format_result, summary, kind)
        return None
    return _format_result(_batched_consensus([workload], args, kind)[0])


def _dtype(args):
    """The float type of the plain versions: float64 under ``--f64`` (the
    JAX package's x64 host run), else float32."""
    return np.float64 if args.f64 else np.float32


def _batched_consensus(workloads, args, kind: str = "poreover"):
    """Decode prepared (y1, y2, envelope) workloads of the model ``kind``
    in waves of ``args.threads`` pairs, one kernel launch per wave
    (``--exact``: of the graveyard instance). Wave i+1's host prep and
    upload are enqueued before wave i's results are fetched, so they
    overlap wave i's kernel on the card. A failed build or launch raises:
    there is no per-pair, windowed or CPU fallback."""
    from ..ops.pair_beam_batch import (
        fetch_prepared, launch_prepared, prepare_pairs, storage_path,
    )

    wave = max(int(args.threads), 1)
    chunks = [workloads[i:i + wave] for i in range(0, len(workloads), wave)]
    out: list[str] = []
    _t0 = time.perf_counter()
    pending = None
    for i, chunk in enumerate(chunks):
        prep = prepare_pairs(chunk, beam_width=args.beam_width,
                             device=args.device, model=MODEL_STRING[kind],
                             exact=args.exact, dtype=_dtype(args))
        log.info("%s%s consensus wave %d/%d (one kernel launch; storage in "
                 "%s memory)", kind, " exact" if args.exact else "", i + 1,
                 len(chunks), storage_path(prep))
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


def batched_box_decode(flat_workloads, beam_width: int = 5, device=None,
                       model: str = "ctc", exact: bool = False,
                       dtype=np.float32):
    """Decode a flat list of (y1, y2, env) anchor boxes of the kind
    ``model``: one launch of the box kernel (ops/box_beam.py), then the
    boxes over its storage limit through the pair kernel of the same kind
    in waves of 32 sorted by length. With ``exact`` (the graveyard
    instance) or ``dtype`` float64 (the plain version, ``--f64``) every
    box takes the second route: the box kernel keeps the windowed memo in
    float32 only. On the CPU both run their plain versions, with the same
    limit and the same rerouting. Returns one sequence per box, in
    order."""
    from ..ops.box_beam import box_beam
    from ..ops.pair_beam_batch import pair_beam_batch

    n = len(flat_workloads)
    if exact or dtype != np.float32:
        seqs, overflow = [None] * n, list(range(n))
        log.info("%d boxes through the pair kernel%s", n,
                 " (graveyard instance)" if exact else "")
    else:
        seqs, overflow = box_beam(flat_workloads, beam_width=beam_width,
                                  device=device, model=model)
        if overflow:
            log.info("box kernel: %d/%d boxes over the storage limit; "
                     "rerouting through the pair kernel", len(overflow), n)
    order = sorted(overflow, key=lambda i: (len(flat_workloads[i][0])
                                            + len(flat_workloads[i][1])))
    wave = 32
    for i in range(0, len(order), wave):
        sel = order[i:i + wave]
        out = pair_beam_batch([flat_workloads[j] for j in sel],
                              beam_width=beam_width, device=device,
                              model=model, exact=exact, dtype=dtype)
        for j, s in zip(sel, out):
            seqs[j] = s
    return seqs


def _batched_box_consensus(box_lists, args, kind: str = "poreover"):
    """Anchored mode (--skip_matches): pool the anchor boxes of every pair
    of the model ``kind`` into one box-batch decode. The boxes between anchors are small independent
    consensus problems, so a wave's hundreds of them ride one launch.
    Returns one list of box sequences per input pair, in order. A failed
    build or launch raises: there is no per-pair or CPU fallback."""
    wls = [wl for boxes in box_lists for wl in boxes]
    log.info("anchored %s consensus: %d boxes across %d pairs", kind,
             len(wls), len(box_lists))
    _t0 = time.perf_counter()
    seqs = iter(batched_box_decode(wls, beam_width=args.beam_width,
                                   device=args.device,
                                   model=MODEL_STRING[kind],
                                   exact=args.exact, dtype=_dtype(args)))
    timers.seconds["consensus_2d"] += time.perf_counter() - _t0
    timers.add_work(
        "consensus_2d",
        float(sum(np.sum(env[:, 1] - env[:, 0]) for _, _, env in wls)),
    )
    return [[next(seqs) for _ in boxes] for boxes in box_lists]


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
        # order. Stage-4 workloads wait in one queue per model kind and
        # flush in waves of `wave` pairs of that kind, so host memory holds
        # at most one wave of log-prob planes per kind.
        wave = max(int(args.threads), 1)
        results: dict[int, tuple] = {}
        # kind -> [(pair idx, workload, finish, summary)]
        pending: dict[str, list] = {}
        emit_cursor = 0

        def emit_ready():
            nonlocal emit_cursor
            while emit_cursor < len(pairs) and emit_cursor in results:
                emit(results[emit_cursor])
                emit_cursor += 1

        def flush_pending(kind):
            queue = pending.pop(kind, [])
            if not queue:
                return
            consensus = (_batched_box_consensus if args.skip_matches
                         else _batched_consensus)
            seqs = consensus([wl for _, wl, _, _ in queue], args, kind)
            for (idx, _, finish, _), seq in zip(queue, seqs):
                results[idx] = finish(seq)
            emit_ready()

        for idx, pair in enumerate(pairs):
            args_copy = copy.copy(args)
            setattr(args_copy, "in", pair)
            sink = (lambda wl, finish, summ, kind, idx=idx:
                    pending.setdefault(kind, []).append(
                        (idx, wl, finish, summ)))
            try:
                r = pair_decode_helper(args_copy, _workload_sink=sink)
            except (NotImplementedError, RuntimeError):
                # an unported branch, or a kernel (or device) that does not
                # build or launch: never one pair's fault
                raise
            except Exception as exc:
                # one corrupt trace must not abort the whole pairs file (the
                # reference's Pool.apply_async swallows worker crashes)
                log.warning("pair %s failed: %s", pair, exc)
                r = ({"read1": pair[0], "read2": pair[1], "skipped": 1},)
            if r is not None:
                results[idx] = r
            emit_ready()
            for kind in [k for k, q in pending.items() if len(q) >= wave]:
                flush_pending(kind)
        for kind in list(pending):
            flush_pending(kind)
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
