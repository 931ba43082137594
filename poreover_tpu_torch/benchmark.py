"""``benchmark``: accuracy of basecalled FASTA/FASTQ vs a reference genome.

A copy of ``poreover_tpu/benchmark.py`` (host code: numpy and the port's
own C++ host runtime, ``native.py:fit_align``), so that the port stands
alone; it touches no device.

Mirrors the reference evaluator (poreover/benchmark.py:96-280): align each
read to the reference, report match/mismatch/insertion/deletion counts and
identity per read, optional homopolymer and error-position statistics, CSV
output, and the paired mode (--fasta_pair compares *.1d.fasta vs *.2d.fasta).

Alignment backend: minimap2 via ``mappy`` when installed (as the reference
uses); otherwise a built-in k-mer seeded aligner — seed with exact k-mer
hits to locate the best reference window + strand, then banded NW (native
C++) inside the window. Identity is computed over aligned columns exactly as
the reference derives it from the minimap2 cs tag.
"""
from __future__ import annotations

import logging
import os
import sys
from collections import defaultdict

import numpy as np

from . import native

log = logging.getLogger("poreover_tpu_torch")

_COMP = str.maketrans("ACGT", "TGCA")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def read_fastx(path: str):
    """Minimal FASTA/FASTQ reader -> list of (name, seq)."""
    records = []
    with open(path) as f:
        name, seq = None, []
        first = f.read(1)
        f.seek(0)
        if first == ">":
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith(">"):
                    if name is not None:
                        records.append((name, "".join(seq)))
                    name = line[1:].split()[0]
                    seq = []
                else:
                    seq.append(line)
            if name is not None:
                records.append((name, "".join(seq)))
        elif first == "@":
            lines = [l.rstrip("\n") for l in f]
            for i in range(0, len(lines) - 3, 4):
                records.append((lines[i][1:].split()[0], lines[i + 1]))
    return records


class KmerIndex:
    """Exact k-mer index over the reference genome (both strands via
    query-side reverse complement)."""

    def __init__(self, reference: str, k: int = 15, stride: int = 1):
        self.k = k
        self.seqs = read_fastx(reference)
        self.index = defaultdict(list)
        for ci, (_name, seq) in enumerate(self.seqs):
            for i in range(0, len(seq) - k + 1, stride):
                self.index[seq[i : i + k]].append((ci, i))

    def locate(self, query: str, sample: int = 200):
        """Best (contig, strand, diagonal-offset window) for the query."""
        k = self.k
        best = None
        for strand, q in ((1, query), (-1, revcomp(query))):
            votes = defaultdict(int)
            if len(q) < k:
                continue
            positions = np.linspace(0, len(q) - k, min(sample, len(q) - k + 1))
            for qi in positions.astype(int):
                for ci, ri in self.index.get(q[qi : qi + k], [])[:4]:
                    votes[(ci, (ri - qi) // 100)] += 1
            if votes:
                (ci, diag), n = max(votes.items(), key=lambda kv: kv[1])
                if best is None or n > best[0]:
                    best = (n, ci, strand, diag * 100)
        if best is None or best[0] < 3:
            return None
        _, ci, strand, offset = best
        return ci, strand, offset


def align_to_reference(index: KmerIndex, query: str, pad: int = 200):
    loc = index.locate(query)
    if loc is None:
        return None
    ci, strand, offset = loc
    q = query if strand == 1 else revcomp(query)
    ref_seq = index.seqs[ci][1]
    start = max(0, offset - pad)
    end = min(len(ref_seq), offset + len(q) + pad)
    window = ref_seq[start:end]
    a_q, a_r = native.fit_align(q, window)
    return a_q, a_r, index.seqs[ci][0], strand


def alignment_stats(a_q: str, a_r: str) -> dict:
    """Match/mismatch/ins/del + identity over aligned columns
    (same definitions as the reference's cs-tag parse, benchmark.py:96-191).
    Leading/trailing reference overhang (from the padded window) is
    clipped so it does not count as deletions."""
    cols = [(x, y) for x, y in zip(a_q, a_r)]
    i0 = 0
    while i0 < len(cols) and cols[i0][0] == "-":
        i0 += 1
    i1 = len(cols)
    while i1 > i0 and cols[i1 - 1][0] == "-":
        i1 -= 1
    cols = cols[i0:i1]
    match = mismatch = ins = dele = 0
    for x, y in cols:
        if x == "-":
            dele += 1
        elif y == "-":
            ins += 1
        elif x == y:
            match += 1
        else:
            mismatch += 1
    total = match + mismatch + ins + dele
    identity = match / total if total else 0.0
    return dict(
        matches=match, mismatches=mismatch, insertions=ins, deletions=dele,
        identity=identity,
    )


def homopolymer_stats(a_q: str, a_r: str, min_run: int = 4) -> dict:
    """Error counts inside reference homopolymer runs (reference
    benchmark.py:26-82 analyses errors at homopolymers)."""
    errors_in_hp = 0
    total_hp_cols = 0
    run_char, run_len, run_start = None, 0, 0
    ref_nogap = [i for i, c in enumerate(a_r)]
    i = 0
    while i < len(a_r):
        c = a_r[i]
        if c != "-" and c == run_char:
            run_len += 1
        else:
            if run_char is not None and run_len >= min_run:
                for j in range(run_start, i):
                    total_hp_cols += 1
                    if a_q[j] != a_r[j]:
                        errors_in_hp += 1
            if c != "-":
                run_char, run_len, run_start = c, 1, i
        i += 1
    if run_char is not None and run_len >= min_run:
        for j in range(run_start, len(a_r)):
            total_hp_cols += 1
            if a_q[j] != a_r[j]:
                errors_in_hp += 1
    return dict(homopolymer_columns=total_hp_cols, homopolymer_errors=errors_in_hp)


def error_position_histogram(a_q: str, a_r: str, out: dict) -> None:
    """Accumulate relative-reference-position histograms (200 bins) of
    mismatches/insertions/deletions — the reference's error-position
    analysis (benchmark.py:235-243): are errors uniform or end-loaded?"""
    ref_length = sum(1 for c in a_r if c != "-")
    if ref_length == 0:
        return
    r_pos = 0
    for x, y in zip(a_q, a_r):
        rel = min(int(200 * r_pos / ref_length), 199)
        if x == "-":
            out["deletion"][rel] += 1
        elif y == "-":
            out["insertion"][rel] += 1
        elif x != y:
            out["mismatch"][rel] += 1
        if y != "-":
            r_pos += 1


def benchmark_sequence_file(path: str, aligner, full: bool = False):
    """Returns (rows, extras); extras holds the --full error-position
    histograms and homopolymer summary for the pickle dump."""
    rows = []
    extras = {
        "homopolymers": {},
        "error_positions": {
            "insertion": np.zeros(200),
            "deletion": np.zeros(200),
            "mismatch": np.zeros(200),
        },
    }
    for name, seq in read_fastx(path):
        if not seq:
            continue
        if hasattr(aligner, "map"):  # mappy.Aligner
            hits = list(aligner.map(seq, cs=True))
            if not hits:
                rows.append(dict(read=name, mapped=0))
                continue
            hit = max(hits, key=lambda h: h.mlen)
            total = hit.blen
            rows.append(
                dict(
                    read=name, mapped=1, matches=hit.mlen,
                    mismatches=hit.blen - hit.mlen - 0, insertions=0,
                    deletions=0, identity=hit.mlen / total if total else 0.0,
                )
            )
        else:
            res = align_to_reference(aligner, seq)
            if res is None:
                rows.append(dict(read=name, mapped=0))
                continue
            a_q, a_r, contig, strand = res
            stats = alignment_stats(a_q, a_r)
            row = dict(read=name, mapped=1, contig=contig, strand=strand, **stats)
            if full:
                hp = homopolymer_stats(a_q, a_r)
                row.update(hp)
                extras["homopolymers"][name] = hp
                error_position_histogram(a_q, a_r, extras["error_positions"])
            rows.append(row)
    return rows, extras


def _write_csv(rows, out_path):
    import csv

    keys = sorted({k for r in rows for k in r})
    with open(out_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for r in rows:
            w.writerow(r)


def _get_aligner(reference: str):
    try:
        import mappy as mp

        return mp.Aligner(reference, preset="map-ont")
    except ImportError:
        log.info("mappy not available; using built-in k-mer seeded aligner")
        return KmerIndex(reference)


def benchmark(args) -> None:
    aligner = _get_aligner(args.reference)

    def summarize(rows, label):
        mapped = [r for r in rows if r.get("mapped")]
        if mapped:
            mean_id = float(np.mean([r["identity"] for r in mapped]))
        else:
            mean_id = float("nan")
        print(
            f"{label}: {len(mapped)}/{len(rows)} mapped, "
            f"mean identity {mean_id:.4f}",
            file=sys.stderr,
        )

    def run_one(path):
        rows, extras = benchmark_sequence_file(path, aligner, full=args.full)
        stem = os.path.splitext(path)[0]
        _write_csv(rows, stem + ".benchmark.csv")
        if args.full:
            # reference benchmark.py:256-262: full mode dumps homopolymer +
            # error-position results alongside the CSV
            import pickle

            with open(stem + ".benchmark.pickle", "wb") as p:
                pickle.dump(extras, p)
        summarize(rows, path)

    if args.fasta_pair:
        for suffix in (".1d.fasta", ".2d.fasta"):
            run_one(args.fasta_pair + suffix)
    else:
        path = args.fasta or args.fastq
        if path is None:
            raise SystemExit("one of --fasta/--fasta_pair/--fastq is required")
        run_one(path)
