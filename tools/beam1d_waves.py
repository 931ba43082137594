"""Times the 1D beam kernel (``poreover_tpu_torch/csrc/beam1d.cu``) of one
or more checkouts on waves of full-size reads, on one CUDA card.

    python3 tools/beam1d_waves.py [--reads 32,264,1056] [--reps 3] TREE ...

Each TREE is a directory holding a ``poreover_tpu_torch`` package (this
checkout, or an unpacked ``git archive`` of another commit); naming trees
in the order A B B A compares two versions in one call. The reads are
those of ``chip_smoke.py``'s phase 6 (32 simulated reads, seed 11,
5200-8200 bases, poreover CTC, beam width 25), made once with this
checkout's simulator and repeated into waves of each size. Each tree runs
in a process of its own, which builds its kernel and times one launch per
wave with CUDA events (the mean of ``--reps`` after a warm-up). Prints the
card's name and power limit, one line per tree and wave, and a digest of
each wave's outputs (chars, provenance, final table bits); exits non-zero
if two trees' outputs differ on a wave.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_reads(d: str) -> None:
    sys.path.insert(0, HERE)
    from poreover_tpu_torch.io.trace import model_from_trace
    from poreover_tpu_torch.sim import write_reads

    with tempfile.TemporaryDirectory() as t:
        write_reads(t, 32, seed=11, lo=5200, hi=8200)
        for i in range(32):
            np.save(os.path.join(d, f"y{i}.npy"), model_from_trace(
                os.path.join(t, f"r{i}.npy"), "poreover").log_prob)


def time_tree(tree: str, reads_dir: str, sizes, reps: int) -> dict:
    """In this process: the kernel of ``tree`` on each wave size."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from poreover_tpu_torch.ops import beam1d

    ys = [np.load(os.path.join(reads_dir, f"y{i}.npy")) for i in range(32)]
    out = {"package": os.path.dirname(beam1d.__file__)}
    for B in sizes:
        prep = beam1d.prepare_beam1d([ys[i % 32] for i in range(B)],
                                     beam_width=25, device="cuda")
        beam1d.launch_beam1d(prep)  # builds, warms
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            outs = beam1d.launch_beam1d(prep)
        e1.record()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for x in outs:
            h.update(x.contiguous().view(torch.uint8).cpu().numpy())
        steps = int(prep["meta"][:, 1].sum())
        out[str(B)] = dict(ms=e0.elapsed_time(e1) / reps, steps=steps,
                           longest=int(prep["meta"][:, 1].max()),
                           digest=h.hexdigest()[:16])
        del prep, outs
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--reads", default="32,264,1056")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--reads-dir", help=argparse.SUPPRESS)
    a = ap.parse_args()
    sizes = [int(x) for x in a.reads.split(",")]
    if a.one:
        print(json.dumps(time_tree(a.one, a.reads_dir, sizes, a.reps)))
        return 0
    if not a.trees:
        ap.error("name at least one tree")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    digests: dict[int, str] = {}
    bad = False
    with tempfile.TemporaryDirectory() as d:
        make_reads(d)
        for tree in a.trees:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 "--reads-dir", d, "--reads", a.reads, "--reps",
                 str(a.reps)], capture_output=True, text=True)
            if r.returncode:
                print(r.stderr[-4000:], file=sys.stderr)
                return 1
            res = json.loads(r.stdout.strip().splitlines()[-1])
            for B in sizes:
                x = res[str(B)]
                same = digests.setdefault(B, x["digest"]) == x["digest"]
                bad |= not same
                print(f"{tree}: {B} reads {x['ms']:.3f} ms "
                      f"({x['ms'] * 1e3 / x['longest']:.3f} us per step of "
                      f"the longest read, {B / (x['ms'] / 1e3):.1f} reads/s)"
                      f" outputs {x['digest']}"
                      f"{'' if same else ' DIFFER'}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
