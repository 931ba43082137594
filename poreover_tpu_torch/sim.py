"""Seeded read simulator (numpy): CTC read pairs for ``pair-decode`` and
single reads of all three model kinds for ``decode``.

The pair recipe is a copy of ``bench.py:_synth_read_pair``: a random
template strand and its reverse-complement strand (with ~5%
substitutions), each rendered as CTC emissions with geometric dwell (~7
steps/base) and Gaussian logit noise. At 5200-8200 bases a read has
~36k-58k time steps. Single reads use the same rendering.
"""
from __future__ import annotations

import os

import numpy as np

DNA = "ACGT"


def _dwell(rng: np.random.Generator, n: int):
    """Per-base dwell times, the step each base occupies, and which steps
    are the first of their base."""
    dw = 1 + rng.geometric(0.16, size=n)
    base_of = np.repeat(np.arange(n), dw)
    first = np.ones(len(base_of), bool)
    first[1:] = base_of[1:] != base_of[:-1]
    return base_of, first


def _log_softmax(logits):
    return (logits - np.log(np.exp(logits).sum(1, keepdims=True))
            ).astype(np.float32)


def synth_ctc_read(rng: np.random.Generator, seq: np.ndarray,
                   noise: float = 1.2) -> np.ndarray:
    """CTC emissions of one strand: float32 [T, 5] log-probs (A, C, G, T,
    blank); a base is one peak on its first step, then blanks. ``noise``
    is the standard deviation of the logits around a peak of 4."""
    base_of, first = _dwell(rng, len(seq))
    T = len(base_of)
    logits = rng.normal(0, noise, (T, 5)).astype(np.float32)
    logits[np.arange(T), np.where(first, seq[base_of], 4)] += 4.0
    return _log_softmax(logits)


def synth_flipflop_read(rng: np.random.Generator, seq: np.ndarray,
                        noise: float = 1.2) -> np.ndarray:
    """Flip-flop emissions of one strand: float32 [T, 8] log-probs (A, C,
    G, T flips, then a, c, g, t flops). A base holds its state for its
    whole dwell: a flip on a new base, the other of flip / flop on a
    repeated base."""
    base_of, _ = _dwell(rng, len(seq))
    flop = np.zeros(len(seq), bool)
    for i in range(1, len(seq)):
        flop[i] = seq[i] == seq[i - 1] and not flop[i - 1]
    state = seq + 4 * flop
    T = len(base_of)
    logits = rng.normal(0, noise, (T, 8)).astype(np.float32)
    logits[np.arange(T), state[base_of]] += 4.0
    return _log_softmax(logits)


def synth_read_pair(rng: np.random.Generator, n_bases: int):
    """Returns (y1, y2): float32 [T, 5] log-probs (A, C, G, T, blank); y2
    is the complementary strand as sequenced (reverse-complemented)."""
    comp = 3  # ACGT: complement = 3 - code
    seq = rng.integers(0, 4, n_bases)
    seq2 = seq.copy()
    m = rng.random(n_bases) < 0.05
    seq2[m] = (seq2[m] + rng.integers(1, 4, int(m.sum()))) % 4
    seq2 = (comp - seq2)[::-1]
    return synth_ctc_read(rng, seq), synth_ctc_read(rng, seq2)


def write_pairs(directory, n: int, seed: int, lo: int, hi: int):
    """Write n simulated pairs as ``s{i}_1.npy`` / ``s{i}_2.npy`` plus a
    tab-separated ``pairs.txt`` into ``directory``; returns the pairs
    file's path. Base counts are drawn from [lo, hi)."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        y1, y2 = synth_read_pair(rng, int(rng.integers(lo, hi)))
        np.save(os.path.join(directory, f"s{i}_1.npy"), y1)
        np.save(os.path.join(directory, f"s{i}_2.npy"), y2)
        lines.append(f"s{i}_1.npy\ts{i}_2.npy\n")
    path = os.path.join(directory, "pairs.txt")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def write_reads(directory, n: int, seed: int, lo: int, hi: int,
                kind: str = "poreover", noise: float = 0.8) -> list[str]:
    """Write n simulated single reads ``r{i}`` into ``directory`` in the
    format ``decode --basecaller`` loads for ``kind``, and return their
    true sequences. Base counts are drawn from [lo, hi). The default
    ``noise`` is lower than the pairs' 1.2, so that one read alone decodes
    to nearly its true sequence (a pair has its second read to vote out
    the spurious peaks that 1.2 produces).

    - ``poreover``: ``.npy`` log-probs [T, 5], blank last;
    - ``bonito``: ``.npy`` log-probs [T, 5] with the blank in column 0
      (the loader moves it last);
    - ``flipflop``: ``.csv`` of probabilities [T, 8] under a header row.
    """
    rng = np.random.default_rng(seed)
    truth = []
    for i in range(n):
        seq = rng.integers(0, 4, int(rng.integers(lo, hi)))
        truth.append("".join(DNA[c] for c in seq))
        stem = os.path.join(directory, f"r{i}")
        if kind == "poreover":
            np.save(stem + ".npy", synth_ctc_read(rng, seq, noise))
        elif kind == "bonito":
            np.save(stem + ".npy", synth_ctc_read(rng, seq, noise)[:, [4, 0, 1, 2, 3]])
        elif kind == "flipflop":
            np.savetxt(stem + ".csv", np.exp(synth_flipflop_read(rng, seq, noise)),
                       delimiter=",", fmt="%.8e", header="A,C,G,T,a,c,g,t",
                       comments="")
        else:
            raise ValueError(f"unknown kind {kind!r}")
    return truth


def ctc_log_likelihood(y: np.ndarray, seq: str) -> float:
    """log P(seq | y) of a poreover (non-merging CTC) read [T, 5], blank
    last: the forward sum over every alignment, in float64. For checking
    what a decoder returned: a summing beam search should find a string at
    least as likely as the best path's."""
    y = np.asarray(y, np.float64)
    s = np.array([DNA.index(c) for c in seq], np.int64)
    a = np.full(len(s) + 1, -np.inf)
    a[0] = 0.0
    move = np.full(len(s) + 1, -np.inf)
    for row in y:
        move[1:] = a[:-1] + row[s]
        a = np.logaddexp(a + row[4], move)
    return float(a[-1])
