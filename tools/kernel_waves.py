"""Times the kernels of one or more checkouts on the full-size waves of
``chip_smoke.py``, or their CLI paths end to end, on one CUDA card.

    python3 tools/kernel_waves.py --waves beam1d [--reads 32,264,1056]
                                  [--reps 3] TREE ...
    python3 tools/kernel_waves.py --waves pair [--reps 3] TREE ...
    python3 tools/kernel_waves.py --waves kinds|exact [--reps 3] TREE ...
    python3 tools/kernel_waves.py --waves plain [--reps 1] TREE ...
    python3 tools/kernel_waves.py --waves gamma [--reps 3] TREE ...
    python3 tools/kernel_waves.py --waves row [--reps 3] TREE ...
    python3 tools/kernel_waves.py --waves e2e [--reps 3] TREE ...

Each TREE is a directory holding a ``poreover_tpu_torch`` package (this
checkout, or an unpacked ``git archive`` of another commit; ``--waves
pair`` also needs its ``native/``); naming trees in the order A B B A
compares two versions in one call. The waves, made once with this
checkout's simulator and stages:

- ``beam1d``: the 1D beam kernel (``csrc/beam1d.cu``) on the reads of
  ``chip_smoke.py``'s phase 6 (32 simulated reads, seed 11, 5200-8200
  bases, poreover CTC, beam width 25), repeated into waves of each
  ``--reads`` size;
- ``pair``: the pair kernel (``csrc/pair_beam_batch.cu``) and the box
  kernel (``csrc/box_beam.cu``) on the plain-CTC waves of phases 5 and 9:
  the 8 simulated pairs (seed 7, 5200-8200 bases,
  ``--reverse_complement``) with their envelopes, and their anchored boxes
  (``--skip_matches --skip_threshold 10``);
- ``kinds``: the pair kernel on phase 10's waves: those 8 pairs as bonito
  and flip-flop traces (one wave per kind);
- ``exact``: the pair kernel's graveyard instances (``exact=True``) on
  phase 17's waves: those 8 pairs as plain CTC, bonito and flip-flop
  traces;
- ``plain``: the pair kernel's plain version (``planned_scan``) on the
  card, on the first PLAIN_WAVE_STEPS plan steps of the first two pairs
  of each kind of the ``exact`` waves, windowed and exact; it runs
  hundreds of small launches per plan step, so its time is the host's
  (the wall time of the run, by CUDA events);
- ``gamma``: the pair gamma DP (``csrc/pair_gamma.cu``, as
  ``gamma_cuda`` launches it) on phase 18's launches: the 8 pairs' wave
  (``--algorithm prefix``, one search) and the anchored run's searches
  (their boxes sorted by length, ``PREFIX_BOX_WAVE`` to a search), the
  line's ms the wave's and, after it, the searches';
- ``row``: the by-row pair beam kernel (``csrc/pair_row_beam.cu``,
  ``pair-decode --beam_search_method row``) on phase 19's waves: the 8
  pairs as plain CTC, bonito and flip-flop traces (one wave per kind) and
  the CTC pairs' anchored boxes (``--skip_matches --skip_threshold 10``)
  in one launch;
- ``e2e``: the same 8 pairs and 32 reads as files, and the 8 pairs and
  the 32 reads as flip-flop traces, through each tree's CLI end to end
  (phases 3, 8, 12, 10 and 6): ``pair-decode --reverse_complement
  --threads 8``, the same with ``--skip_matches --skip_threshold 10`` and
  with ``--single beam``, the flip-flop pairs under ``--basecaller
  flappie``, ``decode --algorithm beam|viterbi --beam_width 25 --threads
  32``, and the flip-flop reads through ``decode --basecaller flappie
  --algorithm viterbi --threads 32`` (the Viterbi kernel);
  wall seconds of each of ``--reps`` runs after a warm-up run (which
  builds the kernels), and the last run's stage timers.

Each tree runs in a process of its own, which builds its kernels and times
one launch per wave with CUDA events (the mean of ``--reps`` after a
warm-up). Prints the card's name and power limit, one line per tree and
wave, and a digest of each wave's outputs; exits non-zero if two trees'
outputs differ on a wave.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the e2e runs: name -> (inputs, basecaller, CLI arguments after them)
PAIR_FLAGS = ["--reverse_complement", "--threads", "8"]
E2E_RUNS = {
    "pair-decode": ("pairs", "poreover", PAIR_FLAGS),
    "pair-decode --skip_matches": ("pairs", "poreover", PAIR_FLAGS + [
        "--skip_matches", "--skip_threshold", "10"]),
    "pair-decode --single beam": ("pairs", "poreover", PAIR_FLAGS + [
        "--single", "beam"]),
    "pair-decode flip-flop": ("pairs_ff", "flappie", PAIR_FLAGS),
    "decode beam": ("reads", "poreover", ["--algorithm", "beam",
                                          "--beam_width", "25",
                                          "--threads", "32"]),
    "decode viterbi": ("reads", "poreover", ["--algorithm", "viterbi",
                                             "--beam_width", "25",
                                             "--threads", "32"]),
    # flip-flop reads: the Viterbi kernel (csrc/viterbi.cu), one launch
    # per wave; the CTC kinds' viterbi decode is an argmax on the host
    "decode viterbi flip-flop": ("reads_ff", "flappie", [
        "--algorithm", "viterbi", "--threads", "32"]),
}


def make_inputs(waves: str, d: str) -> None:
    """The inputs of ``waves``, made with this checkout, written into
    ``d``."""
    sys.path.insert(0, HERE)
    if waves == "e2e":
        from poreover_tpu_torch.sim import write_pairs, write_reads

        for sub in ("pairs", "pairs_ff", "reads", "reads_ff"):
            os.makedirs(os.path.join(d, sub))
        write_pairs(os.path.join(d, "pairs"), 8, seed=7, lo=5200, hi=8200)
        write_pairs(os.path.join(d, "pairs_ff"), 8, seed=7, lo=5200,
                    hi=8200, kind="flipflop")
        write_reads(os.path.join(d, "reads"), 32, seed=11, lo=5200, hi=8200)
        write_reads(os.path.join(d, "reads_ff"), 32, seed=11, lo=5200,
                    hi=8200, kind="flipflop")
        return
    if waves == "beam1d":
        from poreover_tpu_torch.io.trace import model_from_trace
        from poreover_tpu_torch.sim import write_reads

        with tempfile.TemporaryDirectory() as t:
            write_reads(t, 32, seed=11, lo=5200, hi=8200)
            for i in range(32):
                np.save(os.path.join(d, f"y{i}.npy"), model_from_trace(
                    os.path.join(t, f"r{i}.npy"), "poreover").log_prob)
        return
    import chip_smoke as cs
    from poreover_tpu_torch.sim import write_pairs

    if waves == "gamma":
        with tempfile.TemporaryDirectory() as t:
            pairs_txt, _ = write_pairs(t, 8, seed=7, lo=5200, hi=8200)
            wave, searches = cs.gamma_searches(t, pairs_txt)
        with open(os.path.join(d, "waves.pkl"), "wb") as f:
            pickle.dump(dict(wave=wave, searches=searches), f)
        return
    if waves in ("kinds", "exact", "plain", "row"):
        inputs = {kind: cs.sim_workloads(8, 7, 5200, 8200, kind)
                  for kind in ("poreover", "bonito", "flipflop")}
        if waves == "row":
            with tempfile.TemporaryDirectory() as t:
                pairs_txt, _ = write_pairs(t, 8, seed=7, lo=5200, hi=8200)
                inputs["box"] = [b for r1, r2 in cs.pair_files(pairs_txt)
                                 for b in cs.anchored_boxes_of(t, r1, r2)[0]]
        with open(os.path.join(d, "waves.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        return
    with tempfile.TemporaryDirectory() as t:
        pairs_txt, _ = write_pairs(t, 8, seed=7, lo=5200, hi=8200)
        files = cs.pair_files(pairs_txt)
        wave = [cs.workload_of(t, r1, r2) for r1, r2 in files]
        boxes = [b for r1, r2 in files
                 for b in cs.anchored_boxes_of(t, r1, r2)[0]]
    with open(os.path.join(d, "waves.pkl"), "wb") as f:
        pickle.dump(dict(pair=wave, box=boxes), f)


def prepared_waves(waves: str, d: str, sizes):
    """(name, prepared launch, launch function, longest plan) of each wave,
    one at a time, with the package of the tree on ``sys.path``."""
    if waves == "beam1d":
        from poreover_tpu_torch.ops import beam1d

        ys = [np.load(os.path.join(d, f"y{i}.npy")) for i in range(32)]
        for B in sizes:
            prep = beam1d.prepare_beam1d([ys[i % 32] for i in range(B)],
                                         beam_width=25, device="cuda")
            yield (f"{B} reads", prep, beam1d.launch_beam1d,
                   int(prep["meta"][:, 1].max()))
        return
    with open(os.path.join(d, "waves.pkl"), "rb") as f:
        inputs = pickle.load(f)
    if waves == "gamma":
        from poreover_tpu_torch.ops import gamma as gm

        for name, wls in [("gamma 8-pair wave", inputs["wave"])] + [
                (f"gamma anchored search {i}", b)
                for i, b in enumerate(inputs["searches"])]:
            prep = gm.prepare_gamma(wls, device="cuda")
            yield (name, prep, gm.gamma_cuda,
                   int(prep["meta"][:, gm.M_U].max()))
        return
    if waves == "row":
        from poreover_tpu_torch.ops import pair_row_beam as prb

        for name, wls in inputs.items():
            prep = prb.prepare_rows(wls, device="cuda",
                                    model=MODELS.get(name, "ctc"))
            yield (f"row {name} wave", prep, prb.launch_prepared,
                   int(prep["meta"][:, 5].max()))
        return
    from poreover_tpu_torch.ops import box_beam as bb
    from poreover_tpu_torch.ops import pair_beam_batch as pbb
    if waves == "plain":
        yield from plain_waves(inputs)
        return
    if waves in ("kinds", "exact"):
        exact = waves == "exact"
        for kind, wave in inputs.items():
            if not exact and kind == "poreover":
                continue  # the ``pair`` waves
            prep = pbb.prepare_pairs(wave, device="cuda", exact=exact,
                                     model=MODELS[kind])
            yield (f"{kind} {'exact' if exact else 'pair'} wave", prep,
                   pbb.launch_prepared, int(prep["meta"][:, 7].max()))
        return
    for name, prep, launch in (
            ("pair wave", pbb.prepare_pairs(inputs["pair"], device="cuda"),
             pbb.launch_prepared),
            ("box wave", bb.prepare_boxes(inputs["box"], device="cuda"),
             bb.launch_boxes)):
        yield name, prep, launch, int(prep["meta"][:, 7].max())


MODELS = dict(poreover="ctc", bonito="ctc_merge_repeats",
              flipflop="ctc_flipflop")
PLAIN_WAVE_STEPS = 200


def plain_waves(inputs):
    """``prepared_waves`` of ``--waves plain``: per kind and mode the first
    two pairs cut to their first PLAIN_WAVE_STEPS plan steps (at the full
    plans' storage widths), packed by the tree's own ``pack_pairs``."""
    import torch
    from poreover_tpu_torch.ops import beam2d_planned as bp

    def launch(prep):
        return bp.planned_scan(*prep["dev"], prep["W"], prep["A"],
                               model_id=prep["model_id"], G=prep["G"],
                               grace=prep["grace"])

    for kind, wave in inputs.items():
        pairs = wave[:2]
        plans = [bp.build_plan(env, len(y1), len(y2))
                 for y1, y2, env in pairs]
        for mode, (G, grace) in (("windowed", (0, 1)),
                                 ("exact", (bp.EXACT_G, bp.EXACT_GRACE))):
            packed = bp.pack_pairs(
                pairs, model=MODELS[kind], G=G,
                plans=[{k: v[:PLAIN_WAVE_STEPS] for k, v in p.items()}
                       for p in plans],
                wst=[bp.plan_wst(p) for p in plans])
            prep = dict(W=packed["W"], A=packed["A"], G=G, grace=grace,
                        model_id=bp._MODEL_IDS[MODELS[kind]],
                        dev=[torch.as_tensor(packed[k], device="cuda")
                             for k in ("planes1", "planes2", "plan",
                                       "meta")])
            yield (f"{kind} {mode} plain, 2 pairs", prep, launch,
                   PLAIN_WAVE_STEPS)


def e2e_tree(d: str, reps: int) -> dict:
    """In this process: ``E2E_RUNS`` through the CLI of the tree on
    ``sys.path``."""
    import glob

    import torch
    from poreover_tpu_torch.cli import main as cli_main
    from poreover_tpu_torch.utils.timers import timers

    out = {}
    with tempfile.TemporaryDirectory() as o:
        for name, (inputs, basecaller, flags) in E2E_RUNS.items():
            src = os.path.join(d, inputs)
            dest = os.path.join(o, name.replace(" ", "_"))
            argv = (["pair-decode",
                     glob.glob(os.path.join(src, "*.txt"))[0], "--dir", src,
                     "--basecaller", basecaller]
                    if name.startswith("pair") else
                    # flip-flop traces are .csv files, which decode takes
                    # by name (a directory it globs for .hdf5)
                    ["decode", *(sorted(glob.glob(os.path.join(
                        src, "*.csv"))) or [src]), "--basecaller",
                     basecaller])
            argv += [*flags, "--out", dest]
            walls = []
            for _ in range(reps + 1):
                t0 = time.perf_counter()
                cli_main(argv)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            h = hashlib.sha256()  # the log's "#" lines hold the arguments
            for f in sorted(glob.glob(dest + ".*")):
                h.update(b"".join(ln for ln in open(f, "rb")
                                  if not ln.startswith(b"#")))
            out[name] = dict(runs=walls[1:], timers=dict(timers.seconds),
                             digest=h.hexdigest()[:16])
    return out


def time_tree(tree: str, waves: str, d: str, sizes, reps: int) -> dict:
    """In this process: the kernels of ``tree`` on each wave (``e2e``: its
    CLI paths)."""
    sys.path.insert(0, os.path.abspath(tree))
    if waves == "e2e":
        return e2e_tree(d, reps)
    import torch

    out = {}
    for name, prep, launch, longest in prepared_waves(waves, d, sizes):
        launch(prep)  # builds, warms
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            outs = launch(prep)
        e1.record()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for x in outs:
            h.update(x.contiguous().view(torch.uint8).cpu().numpy())
        out[name] = dict(ms=e0.elapsed_time(e1) / reps, longest=longest,
                         digest=h.hexdigest()[:16])
        del prep, outs
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--waves",
                    choices=("beam1d", "pair", "kinds", "exact", "plain",
                             "gamma", "row", "e2e"),
                    required=True)
    ap.add_argument("--reads", default="32,264,1056",
                    help="beam1d wave sizes")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    a = ap.parse_args()
    sizes = [int(x) for x in a.reads.split(",")]
    if a.one:
        print(json.dumps(time_tree(a.one, a.waves, a.inputs, sizes, a.reps)))
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
    digests: dict[str, str] = {}
    bad = False
    with tempfile.TemporaryDirectory() as d:
        make_inputs(a.waves, d)
        for tree in a.trees:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 "--waves", a.waves, "--inputs", d, "--reads", a.reads,
                 "--reps", str(a.reps)], capture_output=True, text=True)
            if r.returncode:
                print(r.stderr[-4000:], file=sys.stderr)
                return 1
            for name, x in json.loads(
                    r.stdout.strip().splitlines()[-1]).items():
                same = digests.setdefault(name, x["digest"]) == x["digest"]
                bad |= not same
                if a.waves == "e2e":
                    print(f"{tree}: {name} end to end " + " ".join(
                        f"{t:.3f}" for t in x["runs"]) + " s; last run's "
                        "stages " + " ".join(f"{k}={v:.3f}s" for k, v in
                                              x["timers"].items())
                        + f"; outputs {x['digest']}"
                        f"{'' if same else ' DIFFER'}", flush=True)
                    continue
                unit = ("row of the longest workload"
                        if a.waves in ("gamma", "row")
                        else "step of the longest plan")
                print(f"{tree}: {name} {x['ms']:.3f} ms "
                      f"({x['ms'] * 1e3 / x['longest']:.3f} us per {unit}) "
                      f"outputs {x['digest']}"
                      f"{'' if same else ' DIFFER'}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
