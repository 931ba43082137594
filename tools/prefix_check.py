#!/usr/bin/env python3
"""The pair prefix search of the JAX package (float32, x64 off) beside the
port's plain version on the CPU, on simulated pairs of ~1500 bases: a
check that the two searches choose the same characters at full depth (the
tests compare them on pairs of at most ~150 bases). It imports both
packages, as the tests do.

For each pair (``sim.write_pairs``, seed 17, 1400-1600 bases; the port's
stages 1-3 on the CPU give the envelope) it prints one JSON line: whether
the two consensus strings are equal, their lengths, the levels each search
ran, the first level at which their chosen characters part (null when
none does), the two probabilities, and the seconds each took. The JAX
search takes ~1 minute a pair on one CPU core:

    JAX_PLATFORMS=cpu python tools/prefix_check.py [N_PAIRS]
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def workloads(n):
    """(y1, y2, envelope) of ``n`` simulated pairs: the port's stages 1-3
    on the CPU."""
    from poreover_tpu_torch.cli import build_parser
    from poreover_tpu_torch.decoding.pair import pair_decode_helper
    from poreover_tpu_torch.sim import write_pairs

    out = []
    with tempfile.TemporaryDirectory() as d:
        write_pairs(d, n, seed=17, lo=1400, hi=1600)
        for i in range(n):
            args = build_parser().parse_args(
                ["pair-decode", f"s{i}_1.npy", f"s{i}_2.npy", "--dir", d,
                 "--basecaller", "poreover", "--reverse_complement",
                 "--device", "cpu"])
            pair_decode_helper(args, lambda wl, *_: out.append(wl))
    return out


def jax_search(y1, y2, env, alphabet="ACGT"):
    """``poreover_tpu.ops.pair_prefix.pair_prefix_search_log``'s loop,
    keeping the characters it chose level by level (its own function
    returns the top label only)."""
    import jax.numpy as jnp
    import numpy as np
    from poreover_tpu.ops.gamma import pair_gamma_log_envelope
    from poreover_tpu.ops.pair_prefix import _level_step

    y1 = np.asarray(y1, np.float64)
    y2 = np.asarray(y2, np.float64)
    U, V, A = len(y1), len(y2), len(alphabet)
    env = np.asarray(env, np.int64)
    band, offsets, g00 = pair_gamma_log_envelope(y1, y2, env)
    band = np.asarray(band)
    Wb = int(np.max(env[:, 1] - env[:, 0]))
    G = np.full((U, Wb), -np.inf)
    for u in range(U):
        s, e = env[u]
        take = np.arange(s + 1 - offsets[u + 1], e + 1 - offsets[u + 1])
        valid = (take >= 0) & (take < band.shape[1])
        G[u, :e - s] = np.where(
            valid, band[u + 1][np.clip(take, 0, band.shape[1] - 1)], -np.inf)
    y1j, y2j = jnp.asarray(y1, jnp.float32), jnp.asarray(y2, jnp.float32)
    Gj, env0 = jnp.asarray(G, jnp.float32), jnp.asarray(env[:, 0])
    label_probs = {"": float(np.sum(y1[:, -1]) + np.sum(y2[:, -1]))}
    top, curr = "", ""
    a1, a2 = jnp.cumsum(y1j[:, -1]), jnp.cumsum(y2j[:, -1])
    chosen = []
    while True:
        al1, al2, prefix_prob, label_prob = _level_step(
            y1j, y2j, a1, a2, jnp.asarray(len(curr) + 1), Gj, env0,
            jnp.asarray(g00, jnp.float32), A, Wb)
        prefix_prob, label_prob = np.asarray(prefix_prob), np.asarray(
            label_prob)
        for c in range(A):
            label_probs[curr + alphabet[c]] = float(label_prob[c])
        best_c = int(np.argmax(prefix_prob))
        if prefix_prob[best_c] < label_probs[top]:
            break
        top = max(label_probs.items(), key=lambda kv: kv[1])[0]
        curr += alphabet[best_c]
        chosen.append(best_c)
        a1, a2 = al1[best_c], al2[best_c]
        if len(curr) > max(U, V):
            break
    return top, label_probs[top], chosen, len(chosen) + 1


def port_search(y1, y2, env):
    """The port's plain search, keeping the characters it chose."""
    import numpy as np
    from poreover_tpu_torch.ops import pair_prefix as pp

    s = pp._Search(np.asarray(y1, np.float64), np.asarray(y2, np.float64),
                   "ACGT")
    real = pp._Search
    pp._Search = lambda *a: s
    try:
        label, prob = pp.pair_prefix_search_batch([(y1, y2, env)],
                                                  device="cpu")[0]
    finally:
        pp._Search = real
    return label, prob, list(s.curr), s.levels


def main():
    import jax
    import torch

    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(1)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    for i, (y1, y2, env) in enumerate(workloads(n)):
        t0 = time.perf_counter()
        jl, jp, jc, jn = jax_search(y1, y2, env)
        t1 = time.perf_counter()
        tl, tp, tc, tn = port_search(y1, y2, env)
        t2 = time.perf_counter()
        part = next((k + 1 for k, (a, b) in enumerate(zip(jc, tc))
                     if a != b), None)
        if part is None and len(jc) != len(tc):
            part = min(len(jc), len(tc)) + 1
        print(json.dumps({
            "pair": i, "U": len(y1), "V": len(y2), "equal": jl == tl,
            "len_jax": len(jl), "len_port": len(tl), "levels_jax": jn,
            "levels_port": tn, "first_level_parted": part,
            "prob_jax": jp, "prob_port": tp, "jax_s": round(t1 - t0, 1),
            "port_s": round(t2 - t1, 1)}), flush=True)


if __name__ == "__main__":
    main()
