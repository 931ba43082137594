"""1D prefix search (PyTorch).

Port of ``poreover_tpu/ops/prefix.py`` (the reference's
prefix_search_log, poreover/decoding/prefix_search.py:115-238), whose
search loop is a ``lax.while_loop``, not a Pallas kernel: here a Python
loop over prefix levels, all four extensions of a level together on the
given device.

Recursions (prefix_search.py:67-96):
  alpha      (label forward)  fw[t] = lse(y[t,gap]+fw[t-1], y[t,c]+prev[t-1])
  alpha_ast  (no-gap forward) = shift(prev) + y[:,c]   (LOG_1 seed at level 1)
Stop rule (prefix_search.py:162): best extension's prefix probability drops
below the best complete label's probability.

The label forward is the same stay chain as the 2D sweeps', so it takes
``beam2d._cumlse_chain`` (closed form over a pairwise log-add-exp tree)
instead of a step-by-step loop over the window, in ~10 tensor ops per
level instead of one per step. The closed form subtracts a running sum of
gap weights and loses ~30 ulps in float32 over a 400-step window, so the
search runs in float64 on the window rounded to ``dtype``: its labels and
probabilities then sit within the step-by-step float32 loop's own rounding
of the exact values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..utils.logspace import LOG_0
from .beam2d import _cumlse_chain

_NEG_INF = LOG_0


def _prefix_search(y: torch.Tensor, A: int = 4):
    """Run prefix search over a [T, A+1] window. Returns (top_chars list,
    top_prob float)."""
    T = y.shape[0]
    dtype, dev = y.dtype, y.device
    gap_col = y[:, -1]
    emis = y[:, :A]

    # level-0 forward vector: cumulative gap mass
    alpha_prev = torch.cumsum(gap_col, dim=0)
    top_prob = float(alpha_prev[-1])
    top_chars: list[int] = []
    curr_chars: list[int] = []

    while True:
        level = len(curr_chars) + 1
        first = level == 1
        # no-gap forward: shifted previous + emission
        seed = torch.full((1,), 0.0 if first else _NEG_INF, dtype=dtype,
                          device=dev)
        shifted = torch.cat([seed, alpha_prev[:-1]])
        alpha_ast = shifted[:, None] + emis  # [T, A]
        # label forward for all A chars together
        fw0 = emis[0] if first else torch.full((A,), _NEG_INF, dtype=dtype,
                                               device=dev)
        if T > 1:
            E = (emis[1:] + alpha_prev[:-1, None]).T  # [A, T-1]
            rest = _cumlse_chain(E, gap_col[1:].expand(A, T - 1), fw0)
            alpha = torch.cat([fw0[:, None], rest], dim=1)  # [A, T]
        else:
            alpha = fw0[:, None]
        prefix_prob = torch.logsumexp(alpha_ast, dim=0)  # [A]
        label_prob = alpha[:, -1]  # [A]

        best_c = int(torch.argmax(prefix_prob))
        new_label_c = int(torch.argmax(label_prob))
        new_label_best = float(label_prob[new_label_c])
        if new_label_best > top_prob:
            # the improving label is curr + new_label_c
            top_prob = new_label_best
            top_chars = curr_chars + [new_label_c]
        if float(prefix_prob[best_c]) < top_prob or level >= T:
            return top_chars, top_prob
        alpha_prev = alpha[best_c]
        curr_chars = curr_chars + [best_c]


def prefix_search_log(y, alphabet: str = "ACGT", device=None,
                      dtype=torch.float32):
    """Prefix-search decode one window on ``device`` (default cuda);
    returns (label, log_prob)."""
    dev = resolve_device(device)
    y_d = torch.as_tensor(np.asarray(y), device=dev).to(dtype).to(
        torch.float64)
    chars, prob = _prefix_search(y_d, A=len(alphabet))
    return "".join(alphabet[c] for c in chars), prob
