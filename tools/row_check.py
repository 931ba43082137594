#!/usr/bin/env python3
"""The by-row pair beam search (``beam_search_2d(method="row")``) of the
JAX package (its XLA engine, float32, x64 off) beside the port's plain
version on the CPU, on the full-size simulated pairs of ``chip_smoke.py``'s
phase 3 (``sim.write_pairs``, seed 7, 5200-8200 bases; the port's stages
1-3 on the CPU give the envelopes): a check at full size that the two
engines spell the same consensus (the tests compare them on pairs of at
most a few hundred rows). It imports both packages, as the tests do.

For each pair index named it prints one JSON line: the rows, each
engine's consensus length, md5 and identity to the pair's true sequence,
whether the strings are equal, and the seconds each took. The JAX engine
takes ~30 s a pair on one CPU core, the port's plain version (``--port``)
several minutes:

    JAX_PLATFORMS=cpu python tools/row_check.py [--port] PAIR ...
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    argv = sys.argv[1:]
    port = "--port" in argv
    pairs = [int(a) for a in argv if a != "--port"] or [0]
    import jax

    jax.config.update("jax_enable_x64", False)
    import torch

    import chip_smoke as cs
    from poreover_tpu.ops.beam2d import beam_search_2d as jax_row
    from poreover_tpu_torch.ops.beam2d import beam_search_2d
    from poreover_tpu_torch.sim import write_pairs

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, truth = write_pairs(d, 8, seed=7, lo=5200, hi=8200)
        files = cs.pair_files(pairs_txt)
        wls = {i: cs.workload_of(d, *files[i], "poreover",
                                 ("--device", "cpu")) for i in pairs}
    for i, wl in wls.items():
        row = {"pair": i, "rows": len(wl[0])}
        for name, fn in (("jax", lambda: jax_row(*wl, beam_width=5)),
                         ("port", lambda: beam_search_2d(
                             *wl, beam_width=5, device="cpu"))):
            if name == "port" and not port:
                continue
            t0 = time.perf_counter()
            s = fn()
            row[name] = dict(
                length=len(s), md5=hashlib.md5(s.encode()).hexdigest(),
                identity=cs.identity(s, truth[i]),
                seconds=round(time.perf_counter() - t0, 1))
        if port:
            row["equal"] = row["jax"]["md5"] == row["port"]["md5"]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
