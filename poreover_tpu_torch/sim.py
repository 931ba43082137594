"""Seeded read simulator (numpy): read pairs of all three model kinds for
``pair-decode`` and single reads of all three kinds for ``decode``.

The pair recipe is a copy of ``bench.py:_synth_read_pair``: a random
template strand and its reverse-complement strand (with ~5%
substitutions), each rendered as CTC emissions with geometric dwell (~7
steps/base) and Gaussian logit noise. At 5200-8200 bases a read has
~36k-58k time steps. Flip-flop reads render the same strands as flip-flop
emissions; single reads use the same rendering. Raw current traces
(``synth_raw_signal``, ``write_fast5``) feed the network's ``call``, and
labeled windows of a scaled current (``synth_training_windows``) its
``train``. Small envelope pairs for exact mode (``exact_style_cases``) and
plans whose windows step back (``stuttered``) feed the graveyard engine's
checks.
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


def _pair_strands(rng: np.random.Generator, n_bases: int):
    """A template strand and its complement strand as sequenced: the
    template with ~5% substitutions, reverse-complemented."""
    comp = 3  # ACGT: complement = 3 - code
    seq = rng.integers(0, 4, n_bases)
    seq2 = seq.copy()
    m = rng.random(n_bases) < 0.05
    seq2[m] = (seq2[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return seq, (comp - seq2)[::-1]


def synth_read_pair(rng: np.random.Generator, n_bases: int):
    """Returns (y1, y2): float32 [T, 5] log-probs (A, C, G, T, blank); y2
    is the complementary strand as sequenced (reverse-complemented)."""
    seq, seq2 = _pair_strands(rng, n_bases)
    return synth_ctc_read(rng, seq), synth_ctc_read(rng, seq2)


def _write_trace(stem: str, y: np.ndarray, kind: str) -> str:
    """One read's log-probs in the format ``--basecaller`` loads for
    ``kind``; returns the file's name."""
    if kind == "poreover":
        np.save(stem + ".npy", y)
        return os.path.basename(stem) + ".npy"
    if kind == "bonito":
        np.save(stem + ".npy", y[:, [4, 0, 1, 2, 3]])
        return os.path.basename(stem) + ".npy"
    if kind == "flipflop":
        np.savetxt(stem + ".csv", np.exp(y), delimiter=",", fmt="%.8e",
                   header="A,C,G,T,a,c,g,t", comments="")
        return os.path.basename(stem) + ".csv"
    raise ValueError(f"unknown kind {kind!r}")


def write_pairs(directory, n: int, seed: int, lo: int, hi: int,
                kind: str = "poreover", complement: bool = True):
    """Write n simulated pairs as ``s{i}_1`` / ``s{i}_2`` plus a
    tab-separated ``pairs.txt`` into ``directory``. Base counts are drawn
    from [lo, hi). Returns (the pairs file's path, each pair's template
    strand: read 1's true sequence, which the consensus also spells).

    Read 2 is the complement strand as sequenced, which
    ``--reverse_complement`` turns back; with ``complement=False`` it is
    that strand turned back before it is rendered (a second template-
    orientation read of the same strand, decoded without
    ``--reverse_complement``). ``kind`` is the format of the traces, as in
    ``write_reads``: ``poreover`` / ``bonito`` ``.npy`` CTC emissions
    (bonito with the blank in column 0), or ``flipflop`` ``.csv``
    probabilities [T, 8] under a header row."""
    rng = np.random.default_rng(seed)
    render = synth_flipflop_read if kind == "flipflop" else synth_ctc_read
    lines, truth = [], []
    for i in range(n):
        seq, seq2 = _pair_strands(rng, int(rng.integers(lo, hi)))
        if not complement:
            seq2 = (3 - seq2)[::-1]
        truth.append("".join(DNA[c] for c in seq))
        f1 = _write_trace(os.path.join(directory, f"s{i}_1"),
                          render(rng, seq), kind)
        f2 = _write_trace(os.path.join(directory, f"s{i}_2"),
                          render(rng, seq2), kind)
        lines.append(f"{f1}\t{f2}\n")
    path = os.path.join(directory, "pairs.txt")
    with open(path, "w") as f:
        f.writelines(lines)
    return path, truth


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
        if kind not in ("poreover", "bonito", "flipflop"):
            raise ValueError(f"unknown kind {kind!r}")
        render = synth_flipflop_read if kind == "flipflop" else \
            synth_ctc_read
        _write_trace(os.path.join(directory, f"r{i}"),
                     render(rng, seq, noise), kind)
    return truth


def synth_training_windows(rng: np.random.Generator, n: int,
                           window: int = 1000, noise: float = 0.2) -> dict:
    """n labeled training windows in ``io/labeled_data.py:to_npz``'s format:
    ``signal`` float32 [n, window], ``labels`` int64 (each window's bases,
    0-3 for ACGT, back to back) and ``row_lengths`` int64 [n]; write them
    with ``np.savez(path, **windows)``. One random strand is cut into
    consecutive windows: each base holds a current level for its dwell
    (``_dwell``, ~7.25 samples per base), the level drawn once per 5-mer
    (the base and two on each side) from a standard normal, plus Gaussian
    noise of standard deviation ``noise``. A window's labels are the bases
    whose first sample lies inside it."""
    total = n * window
    levels = rng.normal(0.0, 1.0, 4 ** 5)
    seq = np.zeros(0, np.int64)
    base_of = np.zeros(0, np.int64)
    first = np.zeros(0, bool)
    while len(base_of) < total:
        more = int((total - len(base_of)) / 7.25 * 1.1) + 16
        b, f = _dwell(rng, more)
        base_of = np.concatenate([base_of, b + len(seq)])
        first = np.concatenate([first, f])
        seq = np.concatenate([seq, rng.integers(0, 4, more)])
    base_of, first = base_of[:total], first[:total]
    padded = np.concatenate([rng.integers(0, 4, 2), seq,
                             rng.integers(0, 4, 2)])
    kmer = sum(padded[j:j + len(seq)] * 4 ** (4 - j) for j in range(5))
    signal = levels[kmer[base_of]] + rng.normal(0.0, noise, total)
    first = first.reshape(n, window)
    starts = seq[base_of].reshape(n, window)
    return dict(signal=signal.reshape(n, window).astype(np.float32),
                labels=starts[first].astype(np.int64),
                row_lengths=first.sum(1).astype(np.int64))


def synth_raw_signal(rng: np.random.Generator, n: int) -> np.ndarray:
    """A raw nanopore current trace of ``n`` samples for ``call``, as int16
    counts (a FAST5 file's ``Signal``): a level drawn in [350, 650) held
    for 8 samples, Gaussian noise of 15, and 5 samples at 900, outside the
    (200, 800) window that ``parse_fast5`` clips."""
    levels = rng.uniform(350, 650, n // 8 + 1).repeat(8)[:n]
    sig = levels + rng.normal(0, 15, n)
    sig[rng.choice(n, 5, replace=False)] = 900
    return sig.astype(np.int16)


def write_fast5(path, raw: np.ndarray, read_id: str) -> None:
    """One raw read in the FAST5 layout ``io/fast5.py:parse_fast5`` reads
    (``/Raw/Reads/Read_1`` with the signal and its attributes, the
    channel's ``UniqueGlobalKey/channel_id``); needs h5py."""
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("/Raw/Reads/Read_1")
        g.attrs["read_id"] = read_id.encode()
        g.attrs["duration"] = len(raw)
        g.create_dataset("Signal", data=np.asarray(raw, np.int16))
        ch = f.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["digitisation"] = 8192.0
        ch.attrs["range"] = 1402.8
        ch.attrs["offset"] = 6.0


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


def exact_style_cases(S=5):
    """Three small envelope pairs for exact mode (the JAX package's
    tests/test_exact.py cases, seed 21): seeded log-softmax planes with S
    columns per row (5: ctc and bonito, 8: flip-flop) and a diagonal
    envelope. A list of (y1, y2, envelope)."""
    rng = np.random.default_rng(21)

    def softmax_log(T):
        x = rng.normal(size=(T, S)) * 2
        return x - np.log(np.exp(x).sum(1, keepdims=True))

    out = []
    for U, V in [(40, 36), (70, 80), (120, 110)]:
        y1, y2 = softmax_log(U), softmax_log(V)
        lo = np.clip(np.arange(U) * V // U - 6, 0, V - 1)
        hi = np.clip(np.arange(U) * V // U + 8, 1, V)
        out.append((y1, y2, np.stack([lo, hi], 1).astype(np.int64)))
    return out


def stuttered(pairs, every=7, back=2):
    """Plans of ``pairs`` in which every ``every``-th step is followed by a
    repeat of the step ``back`` before it, at the plans' own storage widths:
    the windows move back there, which ``build_plan``'s walks never do
    after their first step. Returns (plans, storage widths)."""
    from poreover_tpu_torch.ops.beam2d_planned import build_plan, plan_wst

    plans, wsts = [], []
    for y1, y2, env in pairs:
        p = build_plan(env, len(y1), len(y2))
        idx = []
        for i in range(len(p["type"])):
            idx.append(i)
            if i >= back and i % every == 0:
                idx.append(i - back)
        plans.append({k: v[idx] for k, v in p.items()})
        wsts.append(plan_wst(p))
    return plans, wsts
