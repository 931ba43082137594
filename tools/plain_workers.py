"""How the pair kernel's plain version (``planned_scan``, hundreds of small
launches a plan step, bound by the host) scales over processes and
threads that share one CUDA card: the measurement behind
``chip_smoke.py``'s CARD_WORKERS.

    python3 tools/plain_workers.py [--procs 1,2,4,6] [--threads 2]

The job: ``planned_scan`` on ``chip_smoke.py``'s phase 2 batch "cases
B=8" (the five envelope cases of tests/test_pallas.py, twice over, cut
to eight), three times. It runs once alone in this process, then in N
processes at once for each of ``--procs`` (each process its own CUDA
context; the job's time is taken inside each process, after its start),
then in N threads of this process for each of ``--threads``, each
thread on a stream of its own (their outputs must equal the lone run's).
Prints the card's name and power limit and one line per run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

REPS = 3


def job(stream=None):
    """(seconds, outputs) of REPS runs of the plain version on the batch."""
    import torch
    from poreover_tpu_torch.ops.beam2d_planned import pack_pairs, planned_scan

    c = cs.pallas_cases()
    prep = cs.upload(pack_pairs((c * 2)[:8]))
    out = None
    t0 = time.perf_counter()
    with torch.cuda.stream(stream or torch.cuda.current_stream()):
        for _ in range(REPS):
            out = planned_scan(*prep["dev"], prep["W"], prep["A"],
                               model_id=0)
            torch.cuda.current_stream().synchronize()
    return time.perf_counter() - t0, [x.cpu().numpy() for x in out]


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", default="1,2,4,6")
    ap.add_argument("--threads", default="2")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/plain_workers.py: no CUDA card")
    torch.zeros(1, device=cs.DEVICE)
    if a.one:  # one of the N processes
        torch.set_num_threads(1)
        print(json.dumps({"s": job()[0]}))
        return
    print(cs.gpu_line(), flush=True)
    t1, ref = job()
    print(f"alone: {t1:.2f} s", flush=True)
    for n in (int(x) for x in a.procs.split(",") if x):
        t0 = time.perf_counter()
        ps = [subprocess.Popen([sys.executable, __file__, "--one"],
                               stdout=subprocess.PIPE, text=True)
              for _ in range(n)]
        ts = [json.loads(p.communicate()[0].strip().splitlines()[-1])["s"]
              for p in ps]
        print(f"{n} processes: job times {[round(t, 2) for t in ts]} s "
              f"(throughput {n * t1 / max(ts):.2f}x alone), wall with the "
              f"processes' start {time.perf_counter() - t0:.1f} s",
              flush=True)
    for n in (int(x) for x in a.threads.split(",") if x):
        res = [None] * n

        def run(i):
            res[i] = job(torch.cuda.Stream())

        ths = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        t0 = time.perf_counter()
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        same = all(all(np.array_equal(x, y) for x, y in zip(r[1], ref))
                   for r in res)
        print(f"{n} threads: job times {[round(r[0], 2) for r in res]} s, "
              f"wall {time.perf_counter() - t0:.1f} s, outputs equal to "
              f"the lone run's: {same}", flush=True)


if __name__ == "__main__":
    main()
