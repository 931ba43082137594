"""CTC-style transducer model registry.

Mirrors the behavioral surface of the reference's transducer classes
(poreover/decoding/transducer.py:11-106) — the same three model kinds with
the same decode/reverse-complement semantics. The poreover and bonito
Viterbi decodes are per-step argmax (numpy, on the host); the flip-flop
Viterbi DP runs in ``ops/viterbi.py`` on the requested device.

Model kinds (shared vocabulary with the decoding kernels):

- ``poreover`` (model string "ctc"): [T,5] log-probs, columns A,C,G,T,blank.
  Viterbi decode == per-step argmax with blanks dropped, repeats KEPT
  (reference transducer.py:72-73).
- ``bonito`` (model string "ctc_merge_repeats"): [T,5] blank-last.
  Viterbi decode == argmax path, collapse consecutive repeats (incl. blank
  runs), then drop blanks (reference transducer.py:83-89).
- ``flipflop`` (model string "ctc_flipflop"): [T,8] A,C,G,T,a,c,g,t with the
  8-state transition mask (reference transducer.py:94-103); decode is a true
  Viterbi DP + traceback, then collapse repeats and uppercase.
"""
from __future__ import annotations

import numpy as np

DNA = "ACGT"
# complement permutation of [A,C,G,T,blank] -> [T,G,C,A,blank]
_REVCOMP_CTC = np.array([3, 2, 1, 0, 4])
# complement permutation of [A,C,G,T,a,c,g,t] -> [T,G,C,A,t,g,c,a]
_REVCOMP_FLIPFLOP = np.array([3, 2, 1, 0, 7, 6, 5, 4])

MODEL_STRING = {
    "poreover": "ctc",
    "bonito": "ctc_merge_repeats",
    "flipflop": "ctc_flipflop",
    "guppy": "ctc_flipflop",
    "flappie": "ctc_flipflop",
}


def flipflop_transition_mask() -> np.ndarray:
    """Allowed transitions between the 8 flip-flop states.

    mask[i, j] == 1 iff state j can follow state i: any flip state is always
    reachable; a flop state only from itself or its flip twin
    (reference transducer.py:94-103).
    """
    size = 4
    ones = np.ones((size, size))
    eye = np.eye(size)
    return np.block([[ones, eye], [ones, eye]]).astype(np.float32)


def remove_repeated(s: str) -> str:
    out = []
    prev = None
    for ch in s:
        if ch != prev:
            out.append(ch)
        prev = ch
    return "".join(out)


class Transducer:
    """Log-probability table + alphabet, with decode helpers."""

    kind: str = "base"

    def __init__(self, log_prob: np.ndarray, alphabet):
        self.log_prob = np.asarray(log_prob, dtype=np.float64)
        self.alphabet = list(alphabet)
        assert self.log_prob.shape[1] == len(self.alphabet)

    @property
    def t_max(self) -> int:
        return len(self.log_prob)

    def __getitem__(self, i):
        return self.log_prob[i]

    def path_to_string(self, path: np.ndarray) -> str:
        return "".join(self.alphabet[int(p)] for p in path)

    def argmax_decode(self, return_path: bool = False):
        path = np.argmax(self.log_prob, axis=1)
        s = self.path_to_string(path)
        return (s, path) if return_path else s

    def viterbi_decode(self, return_path: bool = False, device=None):
        """Decode the best path. ``device`` places the flip-flop DP; the
        poreover and bonito kinds take it for the common signature and
        ignore it: their argmax runs in numpy on the host."""
        raise NotImplementedError

    def reverse_complement(self) -> None:
        raise NotImplementedError

    def __repr__(self):
        return (
            f"transducer(kind={self.kind}, alphabet={''.join(self.alphabet)}, "
            f"t_max={self.t_max})"
        )


class poreover(Transducer):
    kind = "poreover"

    def __init__(self, log_prob, alphabet: str = DNA):
        super().__init__(log_prob, list(alphabet) + [""])

    def reverse_complement(self) -> None:
        self.log_prob = self.log_prob[::-1, _REVCOMP_CTC]

    def viterbi_decode(self, return_path: bool = False, device=None):
        # With no transition constraints the Viterbi path is the per-step
        # argmax; blanks render as '' so they drop out of the string while
        # repeats are preserved (reference transducer.py:72-73).
        return self.argmax_decode(return_path)


class bonito(Transducer):
    kind = "bonito"

    def __init__(self, log_prob, alphabet: str = DNA):
        super().__init__(log_prob, list(alphabet) + [""])

    def reverse_complement(self) -> None:
        self.log_prob = self.log_prob[::-1, _REVCOMP_CTC]

    def viterbi_decode(self, return_path: bool = False, device=None):
        path = np.argmax(self.log_prob, axis=1)
        keep = np.ones(len(path), dtype=bool)
        keep[1:] = path[1:] != path[:-1]
        s = self.path_to_string(path[keep])
        return (s, path) if return_path else s


class flipflop(Transducer):
    kind = "flipflop"

    def __init__(self, log_prob):
        super().__init__(log_prob, list(DNA) + list(DNA.lower()))
        self.transition = flipflop_transition_mask()

    def reverse_complement(self) -> None:
        self.log_prob = self.log_prob[::-1, _REVCOMP_FLIPFLOP]

    def viterbi_decode(self, return_path: bool = False, device=None):
        """Masked Viterbi DP on ``device`` (default cuda), in float32."""
        s, path = viterbi_decode_batch([self], device)[0]
        return (s, path) if return_path else s


def viterbi_decode_batch(models, device=None) -> list[tuple]:
    """(string, path) of each model's Viterbi decode. The flip-flop
    models' DPs run together in one batched call on ``device`` (default
    cuda); each result equals the model's own ``viterbi_decode``."""
    out = [None] * len(models)
    ff = [i for i, m in enumerate(models) if m.kind == "flipflop"]
    if ff:
        from ..ops.viterbi import viterbi_path_masked_batch

        paths = viterbi_path_masked_batch(
            [models[i].log_prob.astype(np.float32) for i in ff],
            models[ff[0]].transition, device=device)
        for i, path in zip(ff, paths):
            s = remove_repeated(models[i].path_to_string(path)).upper()
            out[i] = (s, path)
    for i, m in enumerate(models):
        if out[i] is None:
            out[i] = m.viterbi_decode(return_path=True, device=device)
    return out


def beam_acceptor_batch(models, device=None, beam_width: int = 25,
                        band_size: int = 1000,
                        dtype=np.float32) -> list[tuple]:
    """(string, path) of each model's 1D beam search and the banded Viterbi
    acceptor's path of that string through the read: stage 1 of
    ``pair-decode --single beam`` (reference pair_decode.py, the JAX
    package's decoding/pair.py:344-354: ``beam_search`` at its default
    width 25, then ``viterbi_acceptor`` with ``band_size=1000``). The
    models are of one kind. On a CUDA device the beam search is one launch
    of the 1D beam kernel and the acceptor one launch of its kernel, for
    all the models together; on the CPU their plain versions run, in
    ``dtype`` (float64 under ``pair-decode --f64``; the kernels take
    float32). The stage timers ``beam_1d`` and ``acceptor`` split the
    two."""
    import torch

    from ..decoding.decode import _uses_kernel
    from ..device import resolve_device
    from ..ops.acceptor import viterbi_acceptor_batch
    from ..utils.timers import timers

    dev = resolve_device(device)
    ys = [m.log_prob for m in models]
    model = MODEL_STRING[models[0].kind]
    with timers.stage("beam_1d"):
        if _uses_kernel(dev, beam_width):
            from ..ops.beam1d import beam1d_batch

            seqs = beam1d_batch(ys, beam_width=beam_width, model=model,
                                device=dev)
        else:
            from ..ops.beam import beam_search_batch

            seqs = beam_search_batch(ys, beam_width=beam_width, model=model,
                                     device=dev,
                                     dtype=torch.float64
                                     if dtype == np.float64
                                     else torch.float32)
    with timers.stage("acceptor"):
        paths = viterbi_acceptor_batch(ys, seqs, band_size=band_size,
                                       device=dev, dtype=dtype)
    return list(zip(seqs, paths))


def from_kind(kind: str, log_prob) -> Transducer:
    cls = {"poreover": poreover, "bonito": bonito, "flipflop": flipflop}[kind]
    return cls(log_prob)
