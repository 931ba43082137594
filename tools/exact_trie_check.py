#!/usr/bin/env python3
"""How close exact mode comes to the reference's unbounded trie on
full-size simulated pairs, and why: a CPU check of the JAX package's exact
engine, run beside the port (it imports both packages, as the tests do).

For each pair of ``chip_smoke.py`` phase 3's wave (``sim.write_pairs``, 8
pairs, seed 7, 5200-8200 bases), after the port's stages 1-3 on the CPU:
the unbounded trie (``native.pair_beam_row_col_cpu``, float64), the grace
oracle at EXACT_GRACE without a capacity limit (float64) with the most
graveyard rows it held, and the JAX exact engine (``beam_search_2d_planned
(exact=True)``, float32, EXACT_G rows) with its identity to the trie, to
set beside ``chip_smoke.py`` phase 17's for the card's ``--exact``
consensus of the same pair. One JSON line per pair. The JAX engine takes ~5 minutes a
pair on one CPU core, so run a few pair indices per process:

    JAX_PLATFORMS=cpu python tools/exact_trie_check.py 0 1

``--diverge I`` instead runs pair I in windowed mode through the JAX
engine and the port's plain version (float32, CPU; ~6 minutes) and prints
the first plan step whose winners differ, and the two tables' best
scores after the steps before it (where the two engines' float32 sums
part).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def workloads(indices):
    """(y1, y2, envelope) of the wave's pairs ``indices``: the port's
    stages 1-3 on the CPU."""
    from poreover_tpu_torch.cli import build_parser
    from poreover_tpu_torch.decoding.pair import pair_decode_helper
    from poreover_tpu_torch.sim import write_pairs

    out = []
    with tempfile.TemporaryDirectory() as d:
        write_pairs(d, 8, seed=7, lo=5200, hi=8200)
        for i in indices:
            args = build_parser().parse_args(
                ["pair-decode", f"s{i}_1.npy", f"s{i}_2.npy", "--dir", d,
                 "--basecaller", "poreover", "--reverse_complement",
                 "--device", "cpu"])
            pair_decode_helper(args, lambda wl, *_: out.append(wl))
    return out


def diverge(i):
    """The first windowed-mode plan step of pair ``i`` whose winners
    differ between the JAX engine and the port's plain version, and both
    tables' best deduplicated scores after the steps before it."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_enable_x64", False)
    from poreover_tpu.ops import beam2d_planned as jp

    from poreover_tpu_torch.ops import beam2d_planned as tp

    y1, y2, env = workloads([i])[0]
    y1, y2 = np.float32(y1), np.float32(y2)
    plan = tp.build_plan(env, len(y1), len(y2))
    w0, w1 = tp.plan_wst(plan)
    keys = ("type", "a_lo", "a_hi", "b_lo", "b_hi")

    def jax_run(p, **kw):
        return jp._planned_scan(jnp.asarray(y1), jnp.asarray(y2),
                                *(jnp.asarray(p[k]) for k in keys), 0, 5, 4,
                                w0, w1, **kw)

    def port_run(p, **kw):
        packed = tp.pack_pairs([(y1, y2, env)], 5, plans=[p], wst=[(w0, w1)])
        return tp.planned_scan(*tp._to_device(packed, "cpu"), 5, 4, **kw)

    _, srcs, _ = jax_run(plan, return_prov=True)
    prov = port_run(plan)[0].numpy()
    bad = np.flatnonzero((np.asarray(srcs) != prov).any(1))
    out = {"pair": i, "steps": len(prov), "first_differing_step": None}
    if len(bad):
        t = int(bad[0])
        fills = dict(type=tp.C0RUN, a_lo=0, a_hi=0, b_lo=0, b_hi=0)
        cut = {k: np.concatenate([v[:t], np.full(len(v) - t, fills[k],
                                                 v.dtype)])
               for k, v in plan.items()}
        js = jax_run(cut, return_state=True)
        ts = port_run(cut, return_state=True)
        jkeep = np.asarray(jp._dedup_mask(js["k1"], js["k2"], js["valid"]))
        tkeep = tp._dedup_mask(ts["k1"], ts["k2"], ts["valid"])[0].numpy()
        out.update(
            first_differing_step=t,
            tables_keys_equal=bool(np.array_equal(
                np.asarray(js["k1"]), ts["k1"][0].numpy())),
            jax_best_scores=np.sort(np.where(jkeep, np.asarray(js["score"]),
                                             -np.inf))[::-1][:6].tolist(),
            port_best_scores=np.sort(np.where(
                tkeep, ts["score"][0].numpy(), -np.inf))[::-1][:6].tolist())
    print(json.dumps(out), flush=True)


def main(indices):
    import jax

    jax.config.update("jax_enable_x64", False)
    from poreover_tpu import native as jax_native
    from poreover_tpu.ops import beam2d_planned as jp

    from poreover_tpu_torch import native
    from poreover_tpu_torch.ops.beam2d_planned import EXACT_G, EXACT_GRACE

    def identity(a, b):
        x, z = native.global_pair_banded(a, b)
        return sum(p == q for p, q in zip(x, z)) / max(len(x), 1)

    for i, wl in zip(indices, workloads(indices)):
        trie = native.pair_beam_row_col_cpu(*wl, beam_width=5)
        grace, stats = jax_native.pair_beam_row_col_cpu_emul_grace(
            *wl, beam_width=5, grace=EXACT_GRACE, return_stats=True)
        t0 = time.perf_counter()
        exact = jp.beam_search_2d_planned(*wl, beam_width=5, exact=True)
        print(json.dumps({
            "pair": i, "trie_bases": len(trie),
            "grace_oracle_equals_trie": grace == trie,
            "grace_oracle_max_graveyard": int(stats[0]),
            "exact_G": EXACT_G,
            "jax_exact_bases": len(exact),
            "jax_exact_equals_trie": exact == trie,
            "jax_exact_identity_to_trie": identity(exact, trie),
            "jax_exact_s": round(time.perf_counter() - t0, 1)}),
            flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--diverge"]:
        diverge(int(sys.argv[2]))
    else:
        main([int(a) for a in sys.argv[1:]] or list(range(8)))
