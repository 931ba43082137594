#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch/CUDA port's main paths (pair-decode,
decode and anchored pair-decode; pair-decode for all three model kinds;
pair-decode --single beam; call and call --decode; train; benchmark).

Run from a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each fails the run if it fails):
  1. build: the C++ host runtime (g++), the six CUDA kernels (nvcc,
     sm_90a; the pair kernels with one template instance per model kind)
     and their instrumented builds (``-DPOREOVER_PHASE_CLOCKS``), and the
     latency probe ``csrc/latency.cu`` (phases 10 and 12), one process
     each, all from the checkout's sources, in parallel; prints build
     seconds and the compiler's register / shared memory / spill report.
  2. kernels vs plain versions on the card.
     Pair beam (``pair_beam_cuda`` against ``planned_scan``): the five
     envelope cases of tests/test_pallas.py at B=1, 4 and 8, the anchor
     boxes of tests/data/boxes.npz with plans of at most REAL_BOX_STEPS
     steps (21 of 24) as one batch, and two simulated pairs of ~300
     bases. Strings, provenance at every plan step and final validity
     must be equal and the final scores bit-equal (both run the same ops
     in the same order). The sweeps these batches take on the kernel's
     narrow path (windows of at most 31 columns, scanned in registers) and
     on its general path are counted from the plans; neither may be 0.
     1D beam (``beam1d_cuda`` against ``beam1d_plain``): the mixed lengths
     of tests/test_pallas.py and a read of T=1 for ctc, ctc_merge_repeats
     and ctc_flipflop at W=25, 5 and 1. Strings, chars, provenance at
     every step and final validity must be equal, the final table
     bit-equal (int32 view), and the strings equal to the engine
     ``beam_search_batch`` on the card. Then waves of 264 and 1056 of
     those reads per kind (W=25), for which the kernel takes smaller hash
     tables (more CTAs per SM), held to the plain version the same way;
     the hash sizes taken are printed, and fewer than two fail the run.
     Box beam (``box_beam_cuda`` against ``box_beam_plain``): those anchor
     boxes in one launch capped at 3 CTAs (so that boxes run back to back
     in a CTA) and in a second launch at the default grid. Provenance, final
     picks and strings must be equal (tolerance 0: they are integers) to
     the plain version's and between the two launches; the boxes over the
     storage limit must be the ones their plans' storage widths predict
     (at least one; the pair kernel's batch of these boxes above holds
     them to their plain version).
     Bonito and flip-flop pairs (``ctc_merge_repeats``, ``ctc_flipflop``):
     the pair kernel against its plain version on the five envelope cases
     (S = 5 / 8; storage in global scratch, over the shared-memory limit)
     and on two simulated pairs of ~200 bases of the kind (storage in
     shared memory, then forced into global scratch, both bit-equal); the
     box kernel on the anchored boxes of two ~600-base pairs of the kind
     (plans of at most BOX_PLAIN_STEPS steps) at 3 CTAs and at the default
     grid, as above. The Viterbi kernel (``viterbi_path_masked_batch``)
     against its plain version ``_viterbi_masked_padded`` on reads of
     VITERBI_LENGTHS in one launch (T = 1 and 2, the forward's 32-step
     chunks and the traceback's 512-step segments +- 1, 5000), S = 8 (the
     flip-flop mask) and S = 1..7 (a seeded 0/1 mask), additive and hard
     masks: every path equal. The acceptor kernel (``acceptor_cuda``
     against ``acceptor_plain``) on ACCEPTOR_READS (a full 2002-step
     window, T < 2 * band, a band narrower than T / L, L = 0, L = 1, T = 1,
     T < L, windows at 8, 16 and a warp slot's 32 cells, at a 128-cell
     row of pointer bits and at a warp's 256 cells +- 1, W = 2001, labels
     at the walk's 32-row batches +- 1)
     in one launch, S = 5 and 8, bands 1000, 10 and 1023 (the widest
     window, 2048 cells): pointer bytes (the kernel's bits unpacked) and
     paths equal.
  3. pair-decode at full size, through the CLI entry point
     (``poreover_tpu_torch.cli.main``): 8 simulated pairs (seed 7,
     5200-8200 bases, ~36k-58k steps per read) decoded with
     ``--reverse_complement --threads 8``; launch counts are zeroed just
     before and read just after. Pair 0's consensus is held against the
     f64 windowed-memo C++ oracle (identity >= 0.999).
  4. the single-pair entry ``beam_search_2d(method="row_col")``: the five
     envelope cases against the plain version, then pair 0 of phase 3 at
     full size against the consensus phase 3 wrote, timed; its launch
     count is zeroed just before and read just after.
  5. timing of the pair kernel with CUDA events around ``launch_prepared``
     on phase 3's wave (ms, us per step of the longest plan) and the bound
     of that work; the same wave with the kernel's storage forced into
     global scratch (the path of pairs over its shared-memory limit); its
     cycle breakdown: one launch of the instrumented build, cycles per plan
     step of each phase of the search step (thread 0 of each CTA: prune,
     expand, permute, loads, layers, scan, wait, refresh, score) and layers
     per sweep;
     then kernel vs plain version again on the wave's first PLAIN_STEPS
     plan steps per pair (the plain version is too slow for the whole
     wave), timed both; the same for pair 0 alone (the single-pair entry's
     input).
  6. decode at full size, through the CLI: 32 simulated poreover reads
     (seed 11, 5200-8200 bases) with ``--algorithm beam --beam_width 25
     --threads 32``, launch count zeroed just before and read just after;
     32 records, each at identity >= 0.9 to its true sequence; then the
     same reads with ``--algorithm viterbi``. The shortest read's beam
     string must be at least as likely under the read's own emissions (the float64 forward sum over alignments) as its Viterbi
     string; how the beam's strings differ from the true ones (inserted,
     missing, substituted bases) is printed. Then 2 reads of ~950 bases
     each as bonito ``.npy`` and flip-flop ``.csv`` traces, ``beam`` and
     ``viterbi``, each byte-identical to the same command with ``--device
     cpu``.
  7. timing of the 1D kernel with CUDA events on phase 6's wave of 32
     reads (ms, us per step of the longest read), its bound, and its cycle
     breakdown: one launch of the instrumented build, cycles per step of
     each phase of the kernel's step (thread 0 of each CTA); the same 32
     reads repeated into waves of 264 and 1056, timed (ms, hash size
     taken), each read's outputs equal to its own in the 32-read wave;
     kernel vs
     plain version on that wave's reads cut to their first
     BEAM1D_PLAIN_STEPS steps, every step of every read (strings, chars,
     provenance, final table bits), timed both; the kernel's strings of the
     whole wave must be the ones phase 6's FASTA holds.
  8. anchored pair-decode at full size, through the CLI: phase 3's 8 pairs
     with ``--skip_matches --skip_threshold 10 --reverse_complement
     --threads 8``; per pair the 1D identity, anchors, boxes, plan steps
     per box and boxes over the storage limit are printed first; launch
     counts are zeroed just before and read just after. 8 records, none
     skipped; each pair's anchored consensus at identity >= 0.95 to phase
     3's full consensus; pair 0's boxes each decoded by the f64
     windowed-memo C++ oracle and stitched with the same anchors at
     identity >= 0.999 to the run's consensus; the box kernel equal to its
     plain version on pair 0's boxes with plans of at most BOX_PLAIN_STEPS
     steps, and its strings of all of pair 0's boxes, stitched, the run's
     consensus.
  9. timing of the box kernel with CUDA events on phase 8's wave (all
     boxes of the 8 pairs in one launch), its bound and its cycle
     breakdown as in phase 5; the pair kernel's time for the boxes over the
     limit, and for the same boxes with one CTA each.
 10. pair-decode for bonito and flip-flop traces at full size, per kind:
     8 simulated pairs (seed 7, 5200-8200 bases; bonito ``.npy``, flip-flop
     ``.csv``) through the CLI with ``--reverse_complement --threads 8``,
     launch counts zeroed just before and read just after (one pair-kernel
     launch for the wave; flip-flop: one Viterbi launch per pair); each
     bonito consensus at least as close to read 1's true sequence as read
     1's own Viterbi call (flip-flop: each consensus at identity >=
     FLIPFLOP_RC_FLOOR, since reversing a flip-flop trace puts a flop
     first in even homopolymer runs, which the pair model forbids; and
     the mean of a control of the same strands with read 2 rendered in
     template orientation and no ``--reverse_complement`` at least read
     1's mean);
     the same pairs with ``--skip_matches --skip_threshold
     10`` (one box launch; each anchored consensus at identity >= 0.95 to
     the full one); the pair kernel timed on the wave (CUDA events, us per
     step, bound, storage path) and held to its plain version on the
     wave's first PLAIN_STEPS_KINDS steps per pair; pair 0 through the
     single-pair entry equal to the CLI's consensus; the box kernel timed on
     the anchored wave, pair 0's boxes through the kernels stitched into
     the CLI's anchored consensus, and held to its plain version on pair
     0's boxes of <= BOX_PLAIN_STEPS steps with the wave's widest box cut
     to BOX_PLAIN_STEPS steps (a launch with the wave's shared memory per
     CTA); both waves' cycles per plan step by
     phase (the instrumented builds, as in phases 5 and 9); two ~300-base
     pairs on the card byte-identical to ``--device cpu``.
     Flip-flop stage 1: the Viterbi kernel per pair, on all 16 reads, and
     on one read through the wrapper and alone on device tensors, against
     the old loop (the plain version on the card), with the instrumented
     build's cycles per step (forward: broadcast, chain, store, load;
     pointer pass; traceback: maps, compose, fill) and the latency floor
     (T - 1 steps of the least dependent chain, worked out from the
     latencies ``csrc/latency.cu`` measures, at the card's maximum SM
     clock); with
     ``--parent DIR``, the parent tree's kernel on the same read in turns
     with this one, and per pair.
 11. a pairs file under ``--basecaller poreover`` with one CTC ``.npy`` pair
     and one 8-column CSV pair: both decode, one pair-kernel launch per
     kind.
 12. ``pair-decode --single beam`` at full size, through the CLI: phase 3's
     8 pairs, launch counts zeroed just before and read just after (one
     1D beam and one acceptor launch per pair, one pair-kernel launch); 8
     records, none skipped; pair 0 at >= 0.999 to the f64 oracle on the
     envelope this run built; each consensus's identity to the truth
     beside read 1's beam call and phase 3's consensus; stage timers with
     ``1d_basecall`` split into ``beam_1d`` and ``acceptor``; the
     acceptor kernel against its plain version on pair 0's two reads with
     the labels the 1D beam wrote (pointers and paths equal), timed per
     pair launch and per read, with its bound, the instrumented build's
     cycles per row (load, emit, scan, bar1, store, bar2, ptr; the walk's
     stage and walk) and the latency floor (rows x the least dependent
     chain of a row, from the same latencies); with ``--parent DIR``, the parent tree's kernel on the
     same pair in turns with this one; 3 small bonito and 3 small
     flip-flop pairs byte-identical to ``--device cpu`` (the JAX package
     skips some of those pairs, and so does the port), their stage 1
     strings and paths equal on the card and the CPU.
 13. ``call`` at full width: CALL_READS seeded raw signals of
     CALL_SAMPLES samples, conv1_bigru3 at 256 / 9 / 128 with the seeded
     initialiser's weights written as a TF bundle (``tools/tf_bundle.py``)
     and read back through ``--weights``. As FAST5 files through the CLI
     when h5py is installed; without it the
     same signals, scaled by ``parse_fast5``'s ``scale_signal``, enter
     below the FAST5 reader (``network/call.py:call_signal``). Samples/s
     end to end, the model's load, the forward ms per [128, 1000, 1]
     batch; read 0's probabilities against ``--device cpu`` within
     PROB_ATOL; each of the other four architectures, one batch on the
     card against the CPU within PROB_ATOL.
 14. ``call --decode viterbi`` and ``--decode beam`` on phase 13's reads
     (launch counts zeroed just before, read just after), against
     ``call`` then ``decode`` on the card: the Viterbi FASTA must be
     byte-identical; the beam's strings must equal a control that takes
     the saved probabilities' log on the card (the fused path's log) and
     packs it on the host with ``planes_from_numpy`` (the two-stage
     path's packer), and the fused packer's planes (y, root prefix sums,
     offsets) must equal the host packer's on those log values; the
     records that differ from ``decode --algorithm beam`` (which takes
     numpy's log on the host) are printed with the count of log values
     the two logs disagree on; the 1D kernel timed on the fused wave.
 15. ``train`` at full width. (a) the CTC kernels (``ctc_cuda``) against
     ``ctc_plain`` on the card, both variants: a train step's batch (B 64,
     T 1000, the labels of 64 seeded windows, seeded logits) and hand
     cases at T 200 (label length 0, a label longer than T, a repeated
     base that only the merging variant cannot emit, logit lengths below
     T and 0), the state counts CTC_BOUNDARY_STATES (either side of a
     warp and of a CTA's 1024 threads, each beside an empty label and
     logit lengths of 0 and below T) and, merging, a label of
     CTC_LONG_LABEL bases near MAX_SP; the loss bit-equal, the gradient
     within CTC_GRAD_ULP; each pass timed by CUDA events, the plain
     version's time, the bound; for merge, ``F.ctc_loss``'s forward and
     backward time, the kernel-to-library ratio and its loss against the
     kernel's; the instrumented build's cycles per step by phase of each
     pass and a latency floor from them. (b) ``train`` through the CLI on
     64 x 42 seeded windows (``sim.synth_training_windows``),
     conv1_bigru3 at 256 / 9 / 128, ``--batch_size 64 --save_every 20
     --loss_every 5 --seed 3`` (40 steps, 2 validation batches), launch
     counts zeroed just before and read just after: every logged loss
     finite, the last below the first, checkpoint-0 and -1, final,
     model.json and metrics.jsonl written, the validation edit distance
     printed. (e) ``call --weights
     <run dir> --model <run dir>/model.json`` on two of phase 13's
     signals: the newest checkpoint loaded, finite probabilities. (c) one
     ``train_step`` from the same weights on 8 windows on the card and on
     the CPU (tolerances at TRAIN_LOSS_RTOL and below). (d) a step at
     batch 64 split by CUDA events (upload, forward, log-softmax, CTC
     alpha, CTC gradient, the network's backward, Adam), samples/s and
     steps/s.
 16. ``benchmark --fasta_pair`` on phase 3's FASTA files against the 8
     simulated templates as the reference, and ``benchmark --fasta`` on
     phase 6's 32 Viterbi calls against their true sequences (host code):
     each ``.benchmark.csv`` written with a row per record and valid
     identities, phase 6's 32 calls all mapped; phase 3's mapped counts
     printed (the built-in aligner misses some of those insertion-heavy
     calls, as the JAX package's does); wall times.
 17. exact mode (``pair-decode --exact``, the pair kernel's graveyard
     instance). (a) per kind, the graveyard instance against the plain
     graveyard engine on the card (provenance, score bits, validity):
     tests/test_exact.py's three cases at EXACT_GRACES (CTC; the other
     kinds the first and last), in shared memory and in global scratch;
     the same cases on plans that step back (EXACT_STUTTER); the first
     EXACT_PLAIN_STEPS steps of two full-size pairs (phase 3's; phase 10's
     for bonito and flip-flop), timed both; the plain version's counts
     must show rows turned away from a full graveyard, resumed graveyard
     rows, and a row resumed after it moved back while buried. (b) phase
     3's 8 pairs through the CLI with ``--exact`` (launch counts zeroed
     just before, read just after; the windowed instance must not run):
     8 records; the wave's kernel time by CUDA events, us per step of the
     longest plan, bound; each consensus against the reference's
     unbounded trie (f64, on the host): ``trie_match k/8``, identities
     (gates: EXACT_TRIE_FLOOR, set from the runs, and each pair no further
     from the trie than its phase 3 windowed consensus); pair 0 through the
     single-pair entry equal to its string in the wave. (c) the same pairs
     with ``--exact --skip_matches``: 8 records, no box-kernel launch, the
     exact box waves' count and time. (d) phase 10's bonito and flip-flop
     pairs with ``--exact``: 8 records each, the wave's kernel time.

``python3 chip_smoke.py --first-look`` runs only a short first check of
the CTC kernels and the train step (``first_look``), ``--first-look dp``
one of the Viterbi and acceptor kernels (``first_look_dp``: builds,
``cuda`` tests, phase 2's cases, phase 10's and 12's full-size timings,
clocks and latency floors), ``--first-look exact`` phase 17 alone
(``first_look_exact``: the pair kernel's build and ``cuda`` exact tests
first, ~4 minutes); none prints a result. ``--parent DIR`` (a ``git archive`` of the parent commit,
unpacked) has phases 10 and 12, or ``--first-look dp``, time that tree's
Viterbi and acceptor kernels in turns with this checkout's.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(each kernel instance with the model kinds it ran, and with
``us_per_step``; the acceptor with ``us_per_row``; the CTC kernels with
each pass's time and the merging variant's numbers), and as its last line
``{"ok":
true, "device": {...}}``. Exits non-zero, printing no result, without a
CUDA device or without the package beside it.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, float32
# (non-tensor) FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# float operations per in-range cell of a swept candidate row, by model id.
# ctc: par + emit, E - cw, + cw, and ~2 log-add-exps of the scan (max, sub,
# abs, exp, log1p, add each). bonito: the parent's total (a log-add-exp),
# par + emit, - cw, the no-gap scan, + cw, - gap cw, the total's scan, +
# gap cw, + gap, and the score's log-add-exp of the two components.
# flip-flop: the parent's total, par + emit, - cw, par + flop, - flop cw,
# two scans, two + cw, the score's log-add-exp.
OPS_PER_CELL = {0: 3 + 2 * 6, 1: 6 + 2 + 12 + 2 + 12 + 2 + 6,
                2: 6 + 2 + 2 + 24 + 2 + 6}
# The plain versions run hundreds of small launches per step, ~13-25 ms
# per pair-search step and ~2 ms per 1D step on the card, bound by the
# host; these cut the depth at which they hold the kernels, so that the
# whole run stays well inside its time limit.
PLAIN_STEPS = 1000  # phase 5: plan steps per pair of the CTC wave
PLAIN_STEPS_SINGLE = 500  # phases 5 and 10: pair 0 alone
PLAIN_STEPS_KINDS = 1000  # phase 10: the bonito and flip-flop waves
# phase 17 (exact mode): plan steps of the two full-size pairs per kind held
# to the plain graveyard engine; the graces of the CTC cases (those of
# tests/test_exact.py; the other kinds take the first and last); plans that
# step back: every EXACT_STUTTER[0]-th step is followed by the step
# EXACT_STUTTER[1] before it again, so the windows (and the buried rows
# with them) move back and forth. Each exact consensus is held against the
# reference's unbounded trie twice: no further from it than phase 3's
# windowed consensus of the same pair, and at EXACT_TRIE_FLOOR, set from
# the runs: on seed 7's 8 pairs the grace oracle needs 154-171 graveyard
# rows, over the JAX engine's EXACT_G = 128, so exact mode lands
# 0.998-0.9998 from the trie: the JAX exact engine on the CPU
# 0.998192-0.999157 on the pairs measured (tools/exact_trie_check.py), the
# card 0.998192-0.999780
EXACT_PLAIN_STEPS = 500
EXACT_GRACES = (2, 4, 8, 20)
EXACT_STUTTER = (7, 2)
EXACT_TRIE_FLOOR = 0.998
BEAM1D_PLAIN_STEPS = 10000  # phase 7: steps per read of the 1D wave
REAL_BOX_STEPS = 2048  # phase 2: boxes.npz boxes held to the plain version
BOX_PLAIN_STEPS = 1000  # phases 2, 8, 10: plan steps of a compared box
DEVICE = "cuda"
PARENT = None  # --parent DIR: a tree of the parent commit (the command line)
LATENCIES = None  # instruction_latencies(), measured once a run
IDENTITY_FLOOR = 0.9  # a decoded simulated read against its true sequence
ANCHORED_FLOOR = 0.95  # a pair's anchored consensus against its full one
# phase 10, flip-flop under --reverse_complement: each consensus against
# read 1's true sequence. Such pairs decode below read 1's own call (in the
# JAX package as well; tests/test_torch_flipflop_rc.py), so the floor is
# set from the runs: 0.6620-0.6724 over seed 7's 8 pairs on the H100.
FLIPFLOP_RC_FLOOR = 0.65
N_CPU_READS = 2  # bonito / flip-flop reads also decoded with --device cpu
FEW_CTAS = 3  # grid cap that makes boxes run back to back in a CTA
# 1D beam, float operations per step and read: each of the C candidates
# updates its state (two adds and a log-add-exp of six ops; the two-state
# kinds do this twice and add a log-add-exp for the parent and one for the
# score). Picking the W best of C is integer comparisons and key lookups,
# no float operations, so it is left out of the count.
OPS_LSE = 6
BEAM1D_UPDATE_OPS = {0: 2 + OPS_LSE, 1: 2 * (2 + OPS_LSE) + 2 * OPS_LSE,
                     2: 2 * (2 + OPS_LSE) + 2 * OPS_LSE}
MIXED_LENGTHS = {"ctc": (300, 257, 512, 100, 421, 380, 256, 64, 1),
                 "ctc_merge_repeats": (300, 257, 512, 100, 401, 77, 1),
                 "ctc_flipflop": (300, 257, 512, 100, 401, 77, 1)}
BEAM1D_WIDTHS = (25, 5, 1)  # phase 2's 1D cases
# the pair kinds of pair-decode: --basecaller and the planned engine's model
BASECALLER = {"poreover": "poreover", "bonito": "bonito",
              "flipflop": "flappie"}
KIND_MODEL = {"poreover": "ctc", "bonito": "ctc_merge_repeats",
              "flipflop": "ctc_flipflop"}
# phase 2's Viterbi reads, in one launch: T = 1 and 2, the forward's
# register chunks (32 steps) and the traceback's segments (512 steps) +- 1
VITERBI_LENGTHS = (300, 1, 257, 64, 65, 2, 1000, 129, 32, 33, 34, 512, 513,
                   514, 1024, 1025, 1026, 5000)
BEAM1D_WAVES = (264, 1056)  # larger 1D waves (phases 2 and 7)
CALL_READS = 32  # phases 13-14: raw signals through call
CALL_SAMPLES = (50_000, 80_000)  # their lengths, drawn in [lo, hi)
# phase 13: the card's softmax probabilities against the CPU's. Both are
# float32 without TF32, but cuDNN's GRU and convolution sum in other orders
# than the CPU's over 1000 recurrent steps (observed 1.1e-6 on a full
# [128, 1000, 1] batch of conv1_bigru3)
PROB_ATOL = 1e-5
# phase 15: train at full width. 64 x 42 windows of 1000 samples: holdout
# 0.05 keeps 2 batches for validation and trains 40 steps.
TRAIN_WIDTH = dict(arch="conv1_bigru3", num_neurons=128, kernel_size=9,
                   filters=256)
TRAIN_BATCH = 64
TRAIN_BATCHES = 42
TRAIN_WINDOW = 1000
# phase 15(c): one train_step from the same weights on 8 windows, the card
# against the CPU, tolerances set like phase 13's PROB_ATOL (both float32
# without TF32, but cuDNN's GRU, convolution and their gradients sum in
# other orders than the CPU's): the loss within a relative TRAIN_LOSS_RTOL;
# each parameter's gradient within TRAIN_GRAD_RTOL of that tensor's largest
# gradient; the updated parameters within TRAIN_PARAM_ATOL wherever the
# gradient is resolved, |g| >= TRAIN_GRAD_FLOOR of the tensor's largest.
# Adam's first step is -lr g / (|g| + eps): a gradient below the
# comparison's resolution (cancelled sums near 0, whose sign the summation
# order decides) moves its parameter anywhere in [-lr, lr], so those
# parameters are only held within 2 lr and counted.
TRAIN_STEP_WINDOWS = 8
TRAIN_LR = 1e-3
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-5
TRAIN_GRAD_FLOOR = 1e-4
TRAIN_PARAM_ATOL = 1e-5
# CTC kernel against its plain version on the card: the loss bit-equal; the
# gradient within CTC_GRAD_ULP units in the last place (the kernel's and
# torch's CUDA expf)
CTC_GRAD_ULP = 0
# float operations per real state and active step of the CTC passes (a
# log-add-exp counted as OPS_LSE): plain forward 2 adds + lse; plain
# backward 2 adds, 2 subs, 2 exps, 2 muls, 2 class adds, the gamma add;
# merge forward 2 lse + add; merge backward 2 lse, 2 x (sub, exp, mul),
# the class add, then 2 x (sub, exp, mul) and 2 adds
CTC_OPS = {False: (2 + OPS_LSE, 11),
           True: (2 * OPS_LSE + 1, 2 * OPS_LSE + 6 + 1 + 8)}
# phase 15(a): state counts on either side of a warp's 32 and of the 1024
# threads a CTA takes at one state each (K = 2 above; merging: S = 2 L + 1
# is odd, so no 32), each beside an empty label, a logit length of 0 and
# one below T; and a merging label near MAX_SP (S = 9601 of 9664: K = 16,
# the shallowest ring), without repeats so that CTC_LONG_T steps can emit
# it
CTC_BOUNDARY_STATES = (31, 32, 33, 1023, 1025)
CTC_LONG_LABEL = 4800
CTC_LONG_T = 5000


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def pallas_cases(S=5):
    """The five envelope cases of tests/test_pallas.py:cases(), with S
    columns per row (5: ctc and bonito, 8: flip-flop)."""
    rng = np.random.default_rng(7)

    def softmax_log(T, S=S):
        x = rng.normal(size=(T, S)) * 2
        return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(
            np.float32)

    out = []
    for (U, V) in [(40, 300), (60, 50), (25, 25)]:
        y1, y2 = softmax_log(U), softmax_log(V)
        out.append((y1, y2, np.tile(np.array([0, V], np.int64), (U, 1))))
    U, V = 80, 90
    y1, y2 = softmax_log(U), softmax_log(V)
    env = np.stack([np.clip(np.arange(U) - 10, 0, V - 1),
                    np.clip(np.arange(U) + 15, 1, V)], 1).astype(np.int64)
    out.append((y1, y2, env))
    U, V = 420, 460
    y1, y2 = softmax_log(U), softmax_log(V)
    lo = np.clip(np.arange(U) - 8, 0, V - 1)
    hi = np.clip(np.arange(U) + 12, 1, V)
    lo[50:340], hi[50:340] = 40, 64
    lo[340:350], hi[340:350] = 40, 440
    out.append((y1, y2, np.stack([lo, hi], 1).astype(np.int64)))
    return out


def plan_steps(box) -> int:
    from poreover_tpu_torch.ops.beam2d_planned import build_plan

    y1, y2, env = box
    return len(build_plan(env, len(y1), len(y2))["type"]) \
        if len(y1) and len(y2) else 0


def boxes():
    """The real anchor boxes of tests/data/boxes.npz whose plans have at
    most REAL_BOX_STEPS steps (21 of the 24; box 11, over the box kernel's
    storage limit, among them)."""
    d = np.load(os.path.join(HERE, "tests", "data", "boxes.npz"))
    out = [(d[f"y1_{i}"], d[f"y2_{i}"], d[f"env_{i}"])
           for i in range(int(d["n"]))]
    return [b for b in out if plan_steps(b) <= REAL_BOX_STEPS]


def workload_of(d, r1, r2, kind="poreover", extra=()):
    """Stages 1-3 of the port for one pair of reads of the kind ``kind``
    (``extra``: more pair-decode flags): (y1, y2, env)."""
    from poreover_tpu_torch.decoding.pair import pair_decode_helper
    from poreover_tpu_torch.cli import build_parser

    args = build_parser().parse_args(
        ["pair-decode", r1, r2, "--dir", d, "--basecaller",
         BASECALLER[kind], "--reverse_complement", *extra])
    got = []
    pair_decode_helper(args, _workload_sink=lambda wl, *_: got.append(wl))
    if not got:
        fail(f"pair {r1} {r2} was skipped before stage 4")
    return got[0]


def pair_files(pairs_txt):
    return [line.split() for line in open(pairs_txt) if line.split()]


def sim_workloads(n, seed, lo, hi, kind="poreover"):
    from poreover_tpu_torch.sim import write_pairs

    with tempfile.TemporaryDirectory() as d:
        pairs_txt, _ = write_pairs(d, n, seed, lo, hi, kind=kind)
        return [workload_of(d, r1, r2, kind)
                for r1, r2 in pair_files(pairs_txt)]


def cells_of(prep) -> int:
    """In-range cells the sweeps compute: per step, each swept row (C on
    MAIN, the W-node beam on runs; the table is full after the first steps)
    times the window width of each read it sweeps."""
    from poreover_tpu_torch.ops.beam2d_planned import C0RUN, C1RUN, MAIN

    W, A = prep["W"], prep["A"]
    C = W * (A + 1)
    p = prep["plan"].astype(np.int64)
    ty = p[:, 0]
    w0 = np.clip(p[:, 2] - p[:, 1], 0, None)
    w1 = np.clip(p[:, 4] - p[:, 3], 0, None)
    main = ty == MAIN
    return int((C * (w0 + w1))[main].sum() + (W * w0)[ty == C0RUN].sum()
               + (W * w1)[ty == C1RUN].sum())


def bound_ms(prep, out_bytes=None) -> tuple[float, str, str]:
    """Least time for the work: bytes each input read once and each output
    written once over HBM bandwidth, vs float ops over f32 peak. Returns
    (ms, what bounds it, a line with both terms). ``out_bytes`` is what a
    problem writes besides its provenance: the pair kernel's final scores
    and validity (the default), or the box kernel's one picked slot."""
    n = len(prep["plan"])
    C = prep["W"] * (prep["A"] + 1)
    B = len(prep["meta"])
    nbytes = (prep["planes1"].nbytes + prep["planes2"].nbytes
              + prep["plan"].nbytes + prep["meta"].nbytes
              + n * prep["W"] + B * (C * 5 if out_bytes is None
                                     else out_bytes))
    ops_cell = OPS_PER_CELL[prep["model_id"]]
    nops = cells_of(prep) * ops_cell
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    terms = (f"{nbytes} bytes -> {t_bytes:.4g} ms at {HBM_BPS:.3g} B/s; "
             f"{nops} float ops ({cells_of(prep)} swept cells x "
             f"{ops_cell}) -> {t_ops:.4g} ms at {F32_FLOPS:.3g} FLOP/s")
    if t_bytes >= t_ops:
        return t_bytes, "bytes", terms
    return t_ops, "operations", terms


def upload(packed):
    """A packed batch (``pack_pairs``) with its tensors on the card."""
    import torch

    return dict(packed, dev=[torch.as_tensor(packed[k], device=DEVICE)
                             for k in ("planes1", "planes2", "plan", "meta")])


def compare(name, prep, stats, also_global=False, grace=None):
    """Kernel vs plain version on one packed batch, both on the card. With
    ``also_global`` the kernel runs a second time with its storage forced
    into global scratch, and must give the same outputs. A batch packed
    with graveyard rows (``G``) runs the graveyard instance and its plain
    version, with eviction at ``grace`` (default EXACT_GRACE), and adds the
    plain version's GY_COUNTS to ``stats``. Returns (kernel ms, plain ms),
    each one run timed with CUDA events."""
    import torch
    from poreover_tpu_torch.ops import pair_beam_batch as pbb
    from poreover_tpu_torch.ops.beam2d_planned import (
        EXACT_GRACE, GY_COUNTS, planned_scan, scan_outputs, tracebacks,
    )

    mid, G = prep["model_id"], prep["G"]
    grace = grace or (EXACT_GRACE if G else 1)
    k, t_k = timed(lambda: pbb.pair_beam_cuda(
        *prep["dev"], prep["meta"], prep["W"], prep["A"], model_id=mid,
        G=G, grace=grace))
    where = [pbb.storage_path(prep)]
    if also_global:
        kg = pbb._launch(*prep["dev"], prep["meta"], prep["W"], prep["A"],
                         in_smem=False, model_id=mid, G=G, grace=grace)
        if not all(torch.equal(a.view(torch.int8), b.view(torch.int8))
                   for a, b in zip(k, kg)):
            fail(f"{name}: the kernel with its storage in global scratch "
                 "differs from its run in shared memory")
        where.append("global")
    p, t_p = timed(lambda: planned_scan(*prep["dev"], prep["W"], prep["A"],
                                        model_id=mid, G=G, grace=grace,
                                        return_state=bool(G)))
    if G:
        for c in GY_COUNTS:
            stats[c] = stats.get(c, 0) + int(p[c].sum())
        p = scan_outputs(p, prep["meta"], prep["W"])
    k = [x.cpu().numpy() for x in k]
    p = [x.cpu().numpy() for x in p]
    fin = np.isfinite(k[1]) & np.isfinite(p[1])
    err = float(np.abs(k[1][fin] - p[1][fin]).max(initial=0.0))
    stats["max_abs_err"] = max(stats["max_abs_err"], err)
    sk = tracebacks(prep, *k)
    sp = tracebacks(prep, *p)
    if sk != sp:
        bad = [i for i, (a, b) in enumerate(zip(sk, sp)) if a != b]
        fail(f"{name}: kernel strings differ from the plain version at "
             f"pairs {bad}")
    n_prov = int((k[0] != p[0]).any(1).sum())
    if n_prov:
        fail(f"{name}: provenance differs from the plain version at {n_prov} "
             f"steps (first {int(np.flatnonzero((k[0] != p[0]).any(1))[0])})")
    if not np.array_equal(k[2], p[2]):
        fail(f"{name}: final validity differs")
    if not np.array_equal(k[1].view(np.int32), p[1].view(np.int32)):
        fail(f"{name}: final scores not bit-equal (max |err| {err:.3g} "
             "over the finite ones)")
    from poreover_tpu_torch.ops.pair_beam_batch import sweep_paths
    narrow, general = sweep_paths(prep["plan"])
    stats["narrow"] = stats.get("narrow", 0) + narrow
    stats["general"] = stats.get("general", 0) + general
    stats.setdefault("paths", set()).update(where)
    log(f"  {name}: B={len(prep['meta'])} steps={len(prep['plan'])} (max "
        f"{int(prep['meta'][:, 7].max())} per pair; "
        + (f"graveyard {G} rows, grace {grace}; " if G else "")
        + f"sweeps {narrow} narrow, "
        f"{general} general; storage in {' and '.join(where)} memory) "
        f"strings, provenance and validity equal, scores bit-equal; kernel "
        f"{t_k:.1f} ms, plain {t_p:.1f} ms")
    return t_k, t_p


def compare_boxes(name, bxs, stats, few_ctas=None, model="ctc",
                  prepared=None):
    """Box kernel vs plain version on one launch of boxes of the kind
    ``model``, both on the card: provenance, final picks and strings,
    tolerance 0. With ``few_ctas`` the kernel also runs capped at that many
    CTAs, and both launches must agree. ``prepared`` (``prepare_box`` of
    each box) may hold plans cut short. Returns (the strings, kernel ms,
    plain ms, the prepared launch)."""
    import torch
    from poreover_tpu_torch.ops import box_beam as bb
    from poreover_tpu_torch.ops.beam2d_planned import build_plan, plan_wst

    prep = bb.prepare_boxes(bxs, device=DEVICE, model=model,
                            prepared=prepared)
    want_over = [i for i, (y1, y2, env) in enumerate(bxs)
                 if len(y1) and len(y2) and bb.storage_bytes(
                     plan_wst(build_plan(env, len(y1), len(y2))), prep["W"],
                     model_id=prep["model_id"]) > bb.STORAGE_LIMIT_BYTES]
    if prep["overflow"] != want_over:
        fail(f"{name}: boxes over the limit {prep['overflow']}, predicted "
             f"{want_over}")
    k, t_k = timed(lambda: bb.launch_boxes(prep))
    info = dict(prep["info"])
    p, t_p = timed(lambda: bb.box_beam_plain(*prep["dev"], prep["W"],
                                             prep["A"], prep["model_id"]))
    runs = [("default grid", k)]
    if few_ctas:
        kf, t_f = timed(lambda: bb.launch_boxes(prep, max_ctas=few_ctas))
        if prep["info"]["grid"] > few_ctas:
            fail(f"{name}: grid {prep['info']['grid']} over the cap")
        runs.append((f"{few_ctas} CTAs, {t_f:.1f} ms", kf))
    sp = bb.fetch_boxes(prep, p)
    for what, out in runs:
        err = max(int((a.int() - b.int()).abs().max()) if a.numel() else 0
                  for a, b in zip(out, p))
        stats["max_abs_err"] = max(stats["max_abs_err"], float(err))
        if err or bb.fetch_boxes(prep, out) != sp:
            n_prov = int((out[0] != p[0]).any(1).sum())
            fail(f"{name} ({what}): kernel differs from the plain version: "
                 f"provenance at {n_prov} steps, picks at "
                 f"{int((out[1] != p[1]).sum())} boxes")
    steps = prep["meta"][:, 7]
    log(f"  {name}: {len(steps)} boxes in the kernel ({len(want_over)} over "
        f"the limit: {want_over}), steps={int(steps.sum())} (max "
        f"{int(steps.max())} per box), grid {info['grid']} CTAs x "
        f"{info['smem_bytes']} B storage; provenance, picks and strings "
        f"equal to the plain version ("
        + "; ".join(w for w, _ in runs) + f"); kernel {t_k:.1f} ms, plain "
        f"{t_p:.1f} ms")
    return sp, t_k, t_p, prep


def pair_kinds_phase2(kstats, kstats_box):
    """Phase 2 for the bonito and flip-flop kinds: the pair kernel against
    its plain version on the five envelope cases (S = 5 / 8; their storage
    is over the shared-memory limit, so it lives in global scratch) and on
    two simulated pairs of ~200 bases (in shared memory, then forced into
    global scratch); the box kernel on the anchored boxes of two ~600-base
    pairs (plans of at most BOX_PLAIN_STEPS steps) at FEW_CTAS CTAs and at
    the default grid. ``kstats`` / ``kstats_box``
    hold a stats dict per kind; both sweep paths must be exercised."""
    from poreover_tpu_torch.ops.beam2d_planned import pack_pairs
    from poreover_tpu_torch.sim import write_pairs

    for kind in ("bonito", "flipflop"):
        model = KIND_MODEL[kind]
        stats, stats_box = kstats[kind], kstats_box[kind]
        cs = pallas_cases(8 if kind == "flipflop" else 5)
        sims = sim_workloads(2, seed=3, lo=180, hi=220, kind=kind)
        with tempfile.TemporaryDirectory() as d:
            pairs_txt, _ = write_pairs(d, 2, seed=3, lo=550, hi=650,
                                       kind=kind)
            bxs = [b for r1, r2 in pair_files(pairs_txt)
                   for b in anchored_boxes_of(d, r1, r2, kind)[0]
                   if plan_steps(b) <= BOX_PLAIN_STEPS]
        compare(f"{kind}: cases B=5", upload(pack_pairs(cs, model=model)),
                stats)
        compare(f"{kind}: sim pairs ~200 bases B=2",
                upload(pack_pairs(sims, model=model)), stats,
                also_global=True)
        compare_boxes(
            f"{kind}: box beam, the anchored boxes of two ~600-base pairs "
            f"(plans of <= {BOX_PLAIN_STEPS} steps)", bxs, stats_box,
            few_ctas=FEW_CTAS, model=model)
        if not stats["narrow"] or not stats["general"]:
            fail(f"phase 2 does not exercise both sweep paths of the pair "
                 f"kernel for {kind}")
        if stats["paths"] != {"shared", "global"}:
            fail(f"phase 2 does not put {kind} storage in both shared "
                 "memory and global scratch")


def viterbi_mask(S, seed):
    """A seeded 0/1 transition mask over S states (every state may stay),
    or the flip-flop mask for S = 8."""
    from poreover_tpu_torch.models.transducer import flipflop_transition_mask

    if S == 8:
        return flipflop_transition_mask()
    rng = np.random.default_rng(seed)
    return np.maximum(rng.integers(0, 2, (S, S)), np.eye(S, dtype=int))


def compare_viterbi():
    """Phase 2: the Viterbi kernel against its plain version, both on the
    card, on reads of VITERBI_LENGTHS in one launch, for S = 1..8 states
    (S = 8: the flip-flop mask; else a seeded 0/1 mask) under both mask
    modes: every path equal. Returns (kernel ms, plain ms) of the flip-flop
    additive run."""
    import torch
    from poreover_tpu_torch.ops import viterbi as tv

    out = None
    for S in (8, 1, 2, 3, 4, 5, 6, 7):
        rng = np.random.default_rng(17 + S)
        ys = [softmax_log(rng, T, S) for T in VITERBI_LENGTHS]
        lens = [len(y) for y in ys]
        yb = np.zeros((len(ys), max(lens), S), np.float32)
        for i, y in enumerate(ys):
            yb[i, :len(y)] = y
        yb = torch.as_tensor(yb, device=DEVICE)
        mask = viterbi_mask(S, S)
        for mode in ("additive", "hard"):
            trans = tv._trans(mask, mode, torch.float32, yb.device)
            got, t_k = timed(lambda: tv.viterbi_path_masked_batch(
                ys, mask, mode, device=DEVICE))
            want, t_p = timed(lambda: tv._viterbi_masked_padded(yb, lens,
                                                                trans))
            bad = [i for i, (a, b) in enumerate(zip(got, want))
                   if not np.array_equal(a, b[:lens[i]])]
            if bad:
                fail(f"viterbi (S={S}, {mode} mask): kernel paths differ "
                     f"from the plain version's at reads {bad}")
            out = out or (t_k, t_p)
        log(f"  viterbi, S={S}, additive and hard masks: {len(ys)} reads "
            f"(lengths {lens}) in one launch, paths equal to the plain "
            f"version; kernel {t_k:.1f} ms, plain {t_p:.1f} ms (hard)")
    return out


# the acceptor's phase 2 reads: (T, label length) at bands 1000, 10 and 1023
# (the CPU tests' shapes: a full 2002-step window, T < 2 * band, a band
# narrower than T / L, L = 0, L = 1, T = 1, T < L; at band 1000 windows of
# W = T + 2 steps at 8 and 16 cells +- 1, at a warp slot's 32 cells +- 1,
# at 16-byte rows of pointer bits (128 cells) +- 1, at a warp's 256 cells
# +- 1 and W = 2001, labels at the walk's batches of 32 rows +- 1; at band
# 1023 the widest window, 2048 cells)
ACCEPTOR_READS = ((3000, 420), (700, 90), (50, 0), (50, 1), (1, 1), (5, 9),
                  (300, 41), (6, 2), (7, 3), (13, 4), (14, 5), (15, 3),
                  (29, 6), (30, 7), (31, 8), (125, 31), (126, 32),
                  (127, 33), (253, 20), (254, 64), (255, 65), (1999, 300),
                  (2100, 360))
ACCEPTOR_OPS_PER_CELL = 6  # emit add, H subtract, scan max, v add, stay
# add, the pointer's compare


def acceptor_bound_ms(packed) -> tuple[float, str]:
    """Least time for an acceptor launch: bytes (the planes, G and the row
    table read once; the pointer bits and the path written once) over HBM
    bandwidth, vs ACCEPTOR_OPS_PER_CELL float ops per writable cell (from
    the row table) over f32 peak."""
    from poreover_tpu_torch.ops.acceptor import row_bytes

    rows, meta = packed["rows"], packed["meta"]
    n_bytes = (packed["y"].nbytes + packed["G"].nbytes + rows.nbytes
               + int((meta[:, 3] * row_bytes(meta[:, 4])).sum())
               + int(meta[:, 1].sum()))
    cells = int(np.maximum(rows[:, 2] - rows[:, 1] + 1, 0).sum())
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = cells * ACCEPTOR_OPS_PER_CELL / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_acceptor(name, packed):
    """The acceptor kernel against its plain version, both on the card, on
    one packed launch: pointer bytes (the kernel's bits unpacked after the
    timed launch) and paths equal (tolerance 0, they are integers; the row
    table with each row's window offset is the input both read). Returns
    (kernel ms, plain ms)."""
    import torch
    from poreover_tpu_torch.ops import acceptor as ta

    args = ta.upload(packed, torch.device(DEVICE))
    (k_bits, k_path), t_k = timed(lambda: ta.acceptor_cuda(
        *args, packed["meta"], 4))
    k_ptr = ta.unpack_pointers(k_bits, packed["meta"])
    (p_ptr, p_path), t_p = timed(lambda: ta.acceptor_plain(
        *args, packed["meta"], 4))
    if not (torch.equal(k_ptr, p_ptr) and torch.equal(k_path, p_path)):
        bad = int((k_path != p_path).sum())
        fail(f"acceptor, {name}: the kernel differs from the plain version "
             f"({bad} path steps, {int((k_ptr != p_ptr).sum())} pointer "
             "bytes)")
    log(f"  acceptor, {name}: pointers ({k_ptr.numel()} bytes) and paths "
        f"({k_path.numel()} steps) equal to the plain version; kernel "
        f"{t_k:.2f} ms, plain {t_p:.1f} ms")
    return t_k, t_p


def compare_acceptor_cases():
    """Phase 2: the acceptor kernel against its plain version on
    ACCEPTOR_READS, all in one launch, for S = 5 and 8 columns and bands
    1000, 10 and 1023."""
    from poreover_tpu_torch.ops import acceptor as ta

    for S in (5, 8):
        for band in (1000, 10, 1023):
            rng = np.random.default_rng(23)
            ys = [softmax_log(rng, T, S) for T, _ in ACCEPTOR_READS]
            labels = ["".join("ACGT"[i] for i in rng.integers(0, 4, L))
                      for _, L in ACCEPTOR_READS]
            compare_acceptor(f"S={S} band={band}, {len(ys)} reads",
                             ta.pack_acceptor(ys, labels, band))


def anchored_boxes_of(d, r1, r2, kind="poreover"):
    """Stages 1-3 of the port in anchored mode for one pair of reads of
    the kind ``kind``: (its boxes [(y1, y2, env)], the continuation that
    stitches box consensi with the anchors into the pair's consensus, its
    summary)."""
    from poreover_tpu_torch.cli import build_parser
    from poreover_tpu_torch.decoding.pair import pair_decode_helper

    args = build_parser().parse_args(
        ["pair-decode", r1, r2, "--dir", d, "--basecaller",
         BASECALLER[kind], "--reverse_complement", "--skip_matches",
         "--skip_threshold", "10"])
    got = []
    pair_decode_helper(args, _workload_sink=lambda *a: got.append(a))
    if not got:
        fail(f"pair {r1} {r2} was skipped before stage 4")
    bxs, finish, summary, _ = got[0]

    def stitch(seqs):
        return "".join(finish(seqs)[1].splitlines()[1:])

    return bxs, stitch, summary


def timed(fn):
    """One call of fn, timed with CUDA events; returns (result, ms)."""
    import torch

    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


@contextlib.contextmanager
def instrumented(mod):
    """Inside the block the kernel wrapper module ``mod``
    (``ops.pair_beam_batch`` or ``ops.box_beam``) launches its instrumented
    build (``POREOVER_PHASE_CLOCKS``); yields that library."""
    normal, clk = mod.load_kernel(), mod.load_kernel(phase_clocks=True)
    mod._libs[False] = clk
    try:
        yield clk
    finally:
        mod._libs[False] = normal


def clock_parts(mod, c) -> dict:
    """The phase-clock slots ``c`` of ``mod``'s instrumented build, laid
    out as ``mod.CLOCK_PARTS`` says (each part's phases, then one count
    per part, in order), as {part: {phase: cycles per counted unit, ...,
    "total": their sum, "count": the count}}."""
    first = sum(len(ph) for _, ph, _ in mod.CLOCK_PARTS)
    out, i = {}, 0
    for j, (part, phases, _) in enumerate(mod.CLOCK_PARTS):
        count = c[first + j]
        per = {ph: c[i + k] / max(count, 1) for k, ph in enumerate(phases)}
        i += len(phases)
        out[part] = dict(per, total=sum(per.values()), count=count)
    return out


def clock_breakdown(name, mod, launch):
    """One ``launch`` (of one or more of ``mod``'s kernels) under ``mod``'s
    instrumented build (``instrumented``): prints the cycles per counted
    unit of each phase of each part (``clock_parts``; thread 0 of each
    CTA, clock64, summed over the CTAs); returns (those, the raw slots)."""
    import ctypes

    import torch

    n = mod.CLOCK_SLOTS
    buf = (ctypes.c_ulonglong * n)()
    torch.cuda.synchronize()
    with instrumented(mod) as lib:
        if lib.phase_clocks_read(buf, n, 1):
            fail(f"{name}: phase_clocks_read failed")
        launch()
        torch.cuda.synchronize()
        if lib.phase_clocks_read(buf, n, 0):
            fail(f"{name}: phase_clocks_read failed")
    c = list(buf)
    parts = clock_parts(mod, c)
    for part, _, unit in mod.CLOCK_PARTS:
        per = parts[part]
        log(f"  cycles per {unit}, {mod.__name__.split('.')[-1]} {part}, "
            f"{name} (thread 0 of each CTA, {per['count']} {unit}s): "
            + " ".join(f"{ph} {v:.1f}" for ph, v in per.items()
                       if ph not in ("total", "count"))
            + f"; total {per['total']:.1f}")
    return parts, c


def pair_breakdown(name, mod, launch):
    """``clock_breakdown`` of the pair search (``ops.pair_beam_batch`` or
    ``ops.box_beam``), then the layers per sweep from the slots after the
    step count (sweeps, layers, narrow sweeps of both groups)."""
    _, c = clock_breakdown(name, mod, launch)
    sweeps, layers, narrow = c[-3:]
    log(f"  {name}: {layers / max(sweeps, 1):.2f} layers per sweep over "
        f"{sweeps} sweeps ({narrow} narrow)")


def event_ms(fn, reps):
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def softmax_log(rng, T, S):
    x = rng.normal(size=(T, S)) * 2
    return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32)


def beam1d_bound_ms(prep) -> tuple[float, str, str]:
    """Least time for a 1D wave: bytes (emissions read once; provenance,
    chars and the final table written once) over HBM bandwidth, vs the
    float ops of the candidates' updates over f32 peak. The ctc root plane
    is left out of the bytes: it is derived from the emissions."""
    W, A = prep["W"], prep["A"]
    C = W * (A + 1)
    steps = int(prep["meta"][:, 1].sum())
    y, _, meta = prep["host"]
    nbytes = (y.numel() * y.element_size()
              + meta.numel() * meta.element_size()
              + steps * W + steps + len(prep["meta"]) * C * 9)
    per_step = C * BEAM1D_UPDATE_OPS[prep["model_id"]]
    nops = steps * per_step
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    terms = (f"{nbytes} bytes -> {t_bytes:.4g} ms at {HBM_BPS:.3g} B/s; "
             f"{nops} float ops ({steps} steps x {per_step}) -> "
             f"{t_ops:.4g} ms at {F32_FLOPS:.3g} FLOP/s")
    if t_bytes >= t_ops:
        return t_bytes, "bytes", terms
    return t_ops, "operations", terms


def compare_beam1d(name, prep, stats, engine_ys=None):
    """1D kernel vs plain version on one prepared batch, both on the card:
    strings, chars, provenance at every step, final validity and the final
    table's bits (int32 view) must be equal. Returns (the strings, kernel
    ms, plain ms), each one run timed with CUDA events."""
    import torch
    from poreover_tpu_torch.ops import beam1d
    from poreover_tpu_torch.ops.beam import _MODEL_IDS, beam_search_batch

    args = (*prep["dev"], prep["meta"], prep["W"], prep["A"],
            prep["model_id"])
    k, t_k = timed(lambda: beam1d.beam1d_cuda(*args))
    p, t_p = timed(lambda: beam1d.beam1d_plain(*args))
    sk, sp = beam1d.fetch_beam1d(prep, k), beam1d.fetch_beam1d(prep, p)
    if sk != sp:
        bad = [i for i, (a, b) in enumerate(zip(sk, sp)) if a != b]
        fail(f"{name}: kernel strings differ from the plain version at "
             f"reads {bad}")
    if not torch.equal(k[1], p[1]):
        fail(f"{name}: decoded chars differ")
    differ = (k[0] != p[0]).any(1)
    if differ.any():
        fail(f"{name}: provenance differs from the plain version at "
             f"{int(differ.sum())} steps (first "
             f"{int(torch.nonzero(differ)[0, 0])})")
    if not torch.equal(k[4], p[4]):
        fail(f"{name}: final validity differs")
    err = 0.0
    for a, b in ((k[2], p[2]), (k[3], p[3])):
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        if torch.equal(fa, fb) and fa.any():
            err = max(err, float((a[fa] - b[fb]).abs().max()))
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f"{name}: final table not bit-equal (max |err| {err:.3g} "
                 "over the finite values)")
    stats["max_abs_err"] = max(stats["max_abs_err"], err)
    eng = ""
    if engine_ys is not None:
        model = [m for m, i in _MODEL_IDS.items()
                 if i == prep["model_id"]][0]
        se = beam_search_batch(engine_ys, prep["W"], model=model,
                               device=DEVICE)
        if sk != se:
            fail(f"{name}: kernel strings differ from the engine's")
        eng = ", equal to the engine"
    bits = beam1d.hash_bits(len(prep["meta"]), prep["model_id"], DEVICE)
    stats.setdefault("hash_bits", set()).add(bits)
    log(f"  {name}: B={len(prep['meta'])} (2^{bits} hash buckets) steps="
        f"{int(prep['meta'][:, 1].sum())} (max "
        f"{int(prep['meta'][:, 1].max())} per read) strings, chars, "
        f"provenance and validity equal{eng}, final table bit-equal; "
        f"kernel {t_k:.1f} ms, plain {t_p:.1f} ms")
    return sk, t_k, t_p


def beam1d_cases(stats):
    """Phase 2's 1D cases: kernel vs plain version (and the engine) on the
    mixed lengths, a T=1 read among them, for each model kind at each
    width of BEAM1D_WIDTHS."""
    from poreover_tpu_torch.ops import beam1d

    for model, S in (("ctc", 5), ("ctc_merge_repeats", 5),
                     ("ctc_flipflop", 8)):
        for W in BEAM1D_WIDTHS:
            rng = np.random.default_rng(7)
            ys = [softmax_log(rng, T, S) for T in MIXED_LENGTHS[model]]
            prep = beam1d.prepare_beam1d(ys, beam_width=W, model=model,
                                         device=DEVICE)
            compare_beam1d(f"beam1d {model} W={W}", prep, stats,
                           engine_ys=ys)
        for B in BEAM1D_WAVES:
            rng = np.random.default_rng(B)
            lens = MIXED_LENGTHS[model]
            ys = [softmax_log(rng, lens[i % len(lens)], S) for i in range(B)]
            prep = beam1d.prepare_beam1d(ys, beam_width=25, model=model,
                                         device=DEVICE)
            compare_beam1d(f"beam1d {model} W=25, {B} reads", prep, stats)


def beam1d_timing(wave1d, gpu):
    """Phase 7's timing part: the 1D kernel with CUDA events on the 32-read
    wave, its bound and its cycle breakdown. Returns (prep, ms, us per
    step of the longest read, bound ms, bound_by)."""
    from poreover_tpu_torch.ops import beam1d

    prep = beam1d.prepare_beam1d(wave1d, beam_width=25, device=DEVICE)
    lens = prep["meta"][:, 1]
    b4_ms = event_ms(lambda: beam1d.launch_beam1d(prep), reps=3)
    b4_us = b4_ms * 1e3 / lens.max()
    b4_bound, b4_by, b4_terms = beam1d_bound_ms(prep)
    log(f"phase 7 [{gpu}]: beam1d {b4_ms:.1f} ms per 32-read wave, "
        f"{b4_us:.3f} us per step of the longest read "
        f"({int(lens.max())} steps; mean {lens.mean():.0f}); bound "
        f"{b4_bound:.4f} ms ({b4_by}); {32 / (b4_ms / 1e3):.1f} reads/s "
        f"(kernel)")
    log(f"  bound terms: {b4_terms}")
    clock_breakdown("decode wave", beam1d,
                    lambda: beam1d.launch_beam1d(prep))
    return prep, b4_ms, b4_us, b4_bound, b4_by


def beam1d_larger_waves(wave1d, prep32):
    """Phase 7: the 1D kernel on waves of BEAM1D_WAVES reads, phase 6's 32
    repeated: ms per wave (CUDA events) and the hash size taken; every
    read's chars, provenance and final table (bits) must equal its own in
    the 32-read wave ``prep32``. Returns {reads: (ms, hash bits)}."""
    import torch
    from poreover_tpu_torch.ops import beam1d

    ref = beam1d.launch_beam1d(prep32)
    m32 = prep32["meta"]
    res = {}
    for B in BEAM1D_WAVES:
        prep = beam1d.prepare_beam1d([wave1d[i % 32] for i in range(B)],
                                     beam_width=25, device=DEVICE)
        bits = beam1d.hash_bits(B, prep["model_id"], DEVICE)
        ms = event_ms(lambda: beam1d.launch_beam1d(prep), reps=3)
        outs = beam1d.launch_beam1d(prep)
        torch.cuda.synchronize()
        idx = torch.arange(B, device=DEVICE) % 32
        for k in (2, 3):
            if not torch.equal(outs[k].view(torch.int32),
                               ref[k].view(torch.int32)[idx]):
                fail(f"beam1d, {B} reads: final table differs from the "
                     "32-read wave's")
        if not torch.equal(outs[4], ref[4][idx]):
            fail(f"beam1d, {B} reads: final validity differs")
        for b, (o, t) in enumerate(prep["meta"]):
            o32, t32 = m32[b % 32]
            if t != t32 or not (
                    torch.equal(outs[1][o:o + t], ref[1][o32:o32 + t])
                    and torch.equal(outs[0][o:o + t], ref[0][o32:o32 + t])):
                fail(f"beam1d, {B} reads: read {b} differs from its own in "
                     "the 32-read wave")
        steps = int(prep["meta"][:, 1].sum())
        log(f"  beam1d, {B}-read wave (the 32 repeated; 2^{bits} hash "
            f"buckets): {ms:.1f} ms, {B / (ms / 1e3):.1f} reads/s, "
            f"{ms * 1e6 / steps:.2f} ns per read step; every read's "
            "outputs equal its own in the 32-read wave")
        res[B] = (ms, bits)
        del prep, outs
    return res


def fasta_records(path):
    recs = open(path).read().split(">")[1:]
    return {r.split("\n", 1)[0]: "".join(r.splitlines()[1:]) for r in recs}


def identity(a, b):
    from poreover_tpu_torch import native

    x, z = native.global_pair_banded(a, b)
    return sum(p == q for p, q in zip(x, z)) / max(len(x), 1)


def edits(got, true):
    """(inserted, missing, substituted) bases of ``got`` against ``true``,
    by the columns of their banded global alignment."""
    from poreover_tpu_torch import native

    x, z = native.global_pair_banded(got, true)
    ins = sum(q == "-" for q in z)
    miss = sum(p == "-" for p in x)
    return ins, miss, sum(p != q for p, q in zip(x, z)) - ins - miss


def decode_cli(d, inputs, basecaller, algorithm, out, device=None,
               threads=32):
    """One ``decode`` run through the CLI; returns (records, wall seconds,
    the run's stage timers)."""
    import torch
    from poreover_tpu_torch.cli import main as cli_main
    from poreover_tpu_torch.utils.timers import timers

    argv = ["decode", *inputs, "--basecaller", basecaller, "--algorithm",
            algorithm, "--beam_width", "25", "--threads", str(threads),
            "--out", os.path.join(d, out)]
    if device:
        argv += ["--device", device]
    t0 = time.perf_counter()
    cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (fasta_records(os.path.join(d, out + ".fasta")), wall,
            dict(timers.seconds))


def read_fasta(path):
    """The sequences of a FASTA file, in order."""
    return ["".join(r.splitlines()[1:])
            for r in open(path).read().split(">")[1:]]


def pair_decode_cli(d, pairs_txt, basecaller, out, extra=(), device=None,
                    rc=True):
    """One ``pair-decode --threads 8`` run through the CLI, with
    ``--reverse_complement`` unless ``rc`` is false; returns (consensus
    records, 1D records, log rows, wall seconds, the run's stage timers)."""
    import torch
    from poreover_tpu_torch.cli import main as cli_main
    from poreover_tpu_torch.utils.timers import timers

    out = os.path.join(d, out)
    argv = ["pair-decode", pairs_txt, "--dir", d, "--basecaller", basecaller,
            *(["--reverse_complement"] if rc else []), "--threads", "8",
            "--out", out, *extra]
    if device:
        argv += ["--device", device]
    t0 = time.perf_counter()
    cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [r.split("\t") for r in open(out + ".log").read().splitlines()
            if not r.startswith("#")]
    return (read_fasta(out + ".2d.fasta"), read_fasta(out + ".1d.fasta"),
            rows, wall, dict(timers.seconds))


def closer_than_1d(what, ids, ids1):
    """The gate: every consensus at least as close to read 1's true
    sequence as read 1's own Viterbi call."""
    if not all(np.isfinite(ids)) or any(a < b for a, b in zip(ids, ids1)):
        fail(f"{what}: a consensus is less close to the truth than read 1's "
             f"Viterbi call: {ids} against {ids1}")


def flipflop_template_control():
    """Phase 10, flip-flop: phase 10's 8 pairs with read 2 rendered in
    template orientation (its strand turned back before it is rendered, so
    both traces keep the flip / flop order a basecaller gives them),
    decoded without ``--reverse_complement``. The gate: the consensi are on
    average at least as close to read 1's true sequence as read 1's
    Viterbi calls. Per pair the margin is within the noise (read 2's
    strand carries ~5% substitutions against read 1's truth; pairs of
    ~1300 bases on the CPU: -0.011 to +0.024), so each pair is printed and
    the mean is gated."""
    from poreover_tpu_torch.sim import write_pairs

    with tempfile.TemporaryDirectory() as d:
        pairs_txt, truth = write_pairs(d, 8, seed=7, lo=5200, hi=8200,
                                       kind="flipflop", complement=False)
        cons, calls, rows, wall, _ = pair_decode_cli(d, pairs_txt, "flappie",
                                                     "tmpl", rc=False)
    if len(cons) != 8 or any(r[-1] != "0" for r in rows):
        fail(f"flip-flop control: {len(cons)} records, log rows {rows}")
    ids = [identity(c, t) for c, t in zip(cons, truth)]
    ids1 = [identity(c, t) for c, t in zip(calls[0::2], truth)]
    log(f"  flip-flop control, read 2 in template orientation ({wall:.2f} "
        "s): identity to read 1's true sequence, consensus / read 1's "
        "Viterbi call: " + " ".join(f"{a:.4f}/{b:.4f}"
                                   for a, b in zip(ids, ids1))
        + f"; mean {np.mean(ids):.4f}/{np.mean(ids1):.4f}")
    if not all(np.isfinite(ids)) or np.mean(ids) < np.mean(ids1):
        fail(f"flip-flop control: the consensi are on average less close to "
             f"the truth than read 1's Viterbi calls: {ids} against {ids1}")


def zero_counts():
    """Every kernel wrapper's launch counts to 0."""
    from poreover_tpu_torch.ops import acceptor as ta
    from poreover_tpu_torch.ops import beam1d
    from poreover_tpu_torch.ops import box_beam as bb
    from poreover_tpu_torch.ops import ctc
    from poreover_tpu_torch.ops import pair_beam_batch as pbb
    from poreover_tpu_torch.ops import viterbi as tv

    pbb.launch_count = pbb.single_launch_count = 0
    pbb.exact_launch_count = 0
    bb.box_launch_count = 0
    tv.launch_count = 0
    beam1d.launch_count = 0
    ta.launch_count = 0
    ctc.launch_count = ctc.grad_launch_count = 0


def viterbi_bound_ms(lengths, S=8) -> tuple[float, str]:
    """Least time for the Viterbi DP of reads of ``lengths``: bytes (the
    emissions read once, the back-pointers and the path written once) over
    HBM bandwidth, vs T * S^2 float adds over f32 peak."""
    T = int(sum(lengths))
    t_bytes = (T * S * 4 + T * S + T * 4) / HBM_BPS * 1e3
    t_ops = T * S * S / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pair_kind_full(kind, gpu, stats, stats_box):
    """Phase 10 for one kind (bonito or flip-flop): 8 full-size pairs
    through ``pair-decode``, then with ``--skip_matches``; the kernels
    timed on those waves and held to their plain versions (the box kernel
    on pair 0's boxes in a launch with the wave's shared memory per CTA);
    two ~300-base pairs on the card against ``--device cpu``. Returns the
    kind's entries of the kernels line."""
    from poreover_tpu_torch.ops import box_beam as bb
    from poreover_tpu_torch.ops import pair_beam_batch as pbb
    from poreover_tpu_torch.ops import viterbi as tv
    from poreover_tpu_torch.ops.beam2d import beam_search_2d
    from poreover_tpu_torch.ops.beam2d_planned import (
        build_plan, pack_pairs, plan_wst,
    )
    from poreover_tpu_torch.sim import write_pairs

    model, bc = KIND_MODEL[kind], BASECALLER[kind]
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, truth = write_pairs(d, 8, seed=7, lo=5200, hi=8200,
                                       kind=kind)
        zero_counts()
        cons, calls, rows, t_e2e, tm = pair_decode_cli(d, pairs_txt, bc,
                                                       "full")
        launches = pbb.launch_count
        vit_launches = tv.launch_count
        if len(cons) != 8 or any(r[-1] != "0" for r in rows):
            fail(f"{kind}: expected 8 consensus records and no skips; got "
                 f"{len(cons)} records, log rows {rows}")
        if launches != 1:
            fail(f"{kind}: {launches} pair-kernel launches for one wave of "
                 "8 pairs (the CPU route counts none)")
        want_vit = 8 if kind == "flipflop" else 0
        if vit_launches != want_vit:
            fail(f"{kind}: {vit_launches} Viterbi launches, expected "
                 f"{want_vit} (one per pair)")
        log(f"phase 10 {kind} pair-decode: 8 full-size pairs, {launches} "
            f"pair-kernel launch, {vit_launches} Viterbi launches; "
            f"end-to-end {t_e2e:.2f} s "
            f"({8 / t_e2e:.2f} pairs/s); stages "
            + " ".join(f"{k}={v:.3f}s" for k, v in tm.items()))
        ids = [identity(c, t) for c, t in zip(cons, truth)]
        ids1 = [identity(c, t) for c, t in zip(calls[0::2], truth)]
        log("  identity to read 1's true sequence, consensus / read 1's "
            "Viterbi call: " + " ".join(f"{a:.4f}/{b:.4f}"
                                       for a, b in zip(ids, ids1)))
        if kind == "bonito":
            closer_than_1d(kind, ids, ids1)
        else:
            log("  (flip-flop: reverse-complementing a trace reverses each "
                "homopolymer run's flip / flop order, so an even run of the "
                "complement strand starts with a flop, which the pair "
                "model allows only after the same base's flip: the "
                "reference's consensus of such pairs is below read 1's "
                f"call; the gate here is the floor {FLIPFLOP_RC_FLOOR}, "
                "and read 1's call is held to the template-orientation "
                "control below)")
            if not all(np.isfinite(ids)) or min(ids) < FLIPFLOP_RC_FLOOR:
                fail(f"{kind}: a consensus is below {FLIPFLOP_RC_FLOOR} "
                     f"identity to read 1's true sequence: {ids}")
        files = pair_files(pairs_txt)
        wave = [workload_of(d, r1, r2, kind) for r1, r2 in files]
        zero_counts()
        anch, _, arows, t_anch, atm = pair_decode_cli(
            d, pairs_txt, bc, "anch", ["--skip_matches", "--skip_threshold",
                                       "10"])
        box_launches, reroutes = bb.box_launch_count, pbb.launch_count
        if box_launches != 1 or len(anch) != 8 or any(
                r[-1] != "0" for r in arows):
            fail(f"{kind} --skip_matches: {box_launches} box launches, "
                 f"{len(anch)} records, log rows {arows}")
        aids = [identity(a, c) for a, c in zip(anch, cons)]
        log(f"  {kind} --skip_matches: 8 pairs, {box_launches} box launch, "
            f"{reroutes} pair-kernel launches for boxes over the limit; "
            f"end-to-end {t_anch:.2f} s; stages "
            + " ".join(f"{k}={v:.3f}s" for k, v in atm.items())
            + "; identity to the full consensus: "
            + " ".join(f"{x:.4f}" for x in aids))
        if not all(np.isfinite(aids)) or min(aids) < ANCHORED_FLOOR:
            fail(f"{kind}: anchored consensus identity {min(aids)} < "
                 f"{ANCHORED_FLOOR}")
        anchored = [anchored_boxes_of(d, r1, r2, kind) for r1, r2 in files]
        if kind == "flipflop":
            reads = pair_reads(d, files, bc)

    # ---- the pair kernel on the wave: time, bound, storage, plain version
    prep = pbb.prepare_pairs(wave, device=DEVICE, model=model)
    steps = prep["meta"][:, 7]
    wave_ms = event_ms(lambda: pbb.launch_prepared(prep), reps=2)
    wave_bound, wave_by, wave_terms = bound_ms(prep)
    log(f"  [{gpu}] {kind} pair kernel: {wave_ms:.1f} ms per 8-pair wave, "
        f"{wave_ms * 1e3 / steps.max():.2f} us per step of the longest plan "
        f"(bound {wave_bound:.4f} ms, {wave_by}; "
        f"{wave_bound * 1e3 / steps.max():.4f} us per step); storage in "
        f"{pbb.storage_path(prep)} memory; plan steps per pair "
        f"{steps.tolist()}")
    log(f"  bound terms: {wave_terms}")
    pair_breakdown(f"{kind} pair wave", pbb, lambda: pbb._launch(
        *prep["dev"], prep["meta"], prep["W"], prep["A"],
        model_id=prep["model_id"]))
    plans = [build_plan(env, len(y1), len(y2)) for y1, y2, env in wave]

    def truncated(pairs, pls, n):
        return upload(pack_pairs(
            pairs, plans=[{k: v[:n] for k, v in p.items()} for p in pls],
            wst=[plan_wst(p) for p in pls], model=model))

    short = truncated(wave, plans, PLAIN_STEPS_KINDS)
    short_k, short_p = compare(
        f"{kind} pair wave, first {PLAIN_STEPS_KINDS} steps", short, stats)
    short_bound = bound_ms(short)[0]
    # ---- the single-pair entry on pair 0
    prep1 = pbb.prepare_pairs(wave[:1], device=DEVICE, model=model)
    one_ms = event_ms(lambda: pbb.launch_prepared(prep1), reps=1)
    one_bound, one_by, _ = bound_ms(prep1)
    pbb.single_launch_count = 0
    got = beam_search_2d(*wave[0], beam_width=5, model=model,
                         method="row_col")
    single_launches = pbb.single_launch_count
    if single_launches != 1 or got != cons[0]:
        fail(f"{kind}: the single-pair entry ({single_launches} launches) "
             "differs from pair-decode's consensus of pair 0")
    stats_single = {"max_abs_err": 0.0}
    short1 = truncated(wave[:1], plans[:1], PLAIN_STEPS_SINGLE)
    short1_k, short1_p = compare(
        f"{kind} pair 0 alone, first {PLAIN_STEPS_SINGLE} steps", short1,
        stats_single)
    log(f"  {kind} single-pair entry: pair 0 equal to pair-decode's "
        f"consensus, {single_launches} launch; kernel {one_ms:.1f} ms "
        f"alone (bound {one_bound:.4f} ms, {one_by})")
    # ---- the box kernel on the anchored wave
    all_boxes = [b for bxs, _, _ in anchored for b in bxs]
    bprep = bb.prepare_boxes(all_boxes, device=DEVICE, model=model)
    box_ms = event_ms(lambda: bb.launch_boxes(bprep), reps=3)
    box_bound, box_by, box_terms = bound_ms(bprep, out_bytes=4)
    bsteps = bprep["meta"][:, 7]
    log(f"  [{gpu}] {kind} box kernel: {box_ms:.1f} ms per 8-pair anchored "
        f"wave: {len(all_boxes)} boxes ({len(bprep['overflow'])} over the "
        f"storage limit), {int(bsteps.sum())} plan steps (longest box "
        f"{int(bsteps.max())}), grid {bprep['info']['grid']} CTAs x "
        f"{bprep['info']['smem_bytes']} B storage; "
        f"{box_ms * 1e3 / bsteps.max():.2f} us per step of the longest box; "
        f"bound {box_bound:.4f} ms ({box_by})")
    pair_breakdown(f"{kind} anchored wave", bb, lambda: bb.box_beam_cuda(
        *bprep["dev"], bprep["meta"], bprep["W"], bprep["A"],
        model_id=bprep["model_id"]))
    # pair 0's boxes through the kernels (the box kernel, the pair kernel
    # for boxes over its limit), stitched: the consensus the CLI wrote
    bxs0, stitch0, _ = anchored[0]
    seqs0, over0 = bb.box_beam(bxs0, device=DEVICE, model=model)
    for i, sq in zip(over0, pbb.pair_beam_batch(
            [bxs0[i] for i in over0], device=DEVICE, model=model)):
        seqs0[i] = sq
    if stitch0(seqs0) != anch[0]:
        fail(f"{kind} pair 0: the stitched box strings differ from the "
             "consensus pair-decode --skip_matches wrote")
    log(f"  {kind} pair 0: its {len(bxs0)} boxes through the kernels "
        f"({len(over0)} over the box kernel's limit), stitched: the "
        "consensus pair-decode --skip_matches wrote")
    # the box kernel against its plain version on pair 0's boxes with plans
    # of <= BOX_PLAIN_STEPS steps and the wave's widest box cut to its first
    # BOX_PLAIN_STEPS steps (its storage width kept), so that the launch
    # takes the wave's shared memory per CTA
    need = bb.storage_bytes((bprep["meta"][:, bb.M_WST0],
                             bprep["meta"][:, bb.M_WST1]), bprep["W"],
                            bprep["A"], bprep["model_id"])
    widest = all_boxes[bprep["order"][int(np.argmax(need))]]
    cut = bb.prepare_box(*widest, model=model)
    cut["plan"] = {k: v[:BOX_PLAIN_STEPS] for k, v in cut["plan"].items()}
    cut["n"] = len(cut["plan"]["type"])
    short0 = [b for b in bxs0 if plan_steps(b) <= BOX_PLAIN_STEPS]
    _, box0_k, box0_p, prep0 = compare_boxes(
        f"{kind}: box beam, pair 0's {len(short0)} boxes with plans of <= "
        f"{BOX_PLAIN_STEPS} steps and the wave's widest box ({cut['n']} of "
        f"its {plan_steps(widest)} steps)", short0 + [widest], stats_box,
        model=model, prepared=[bb.prepare_box(*b, model=model)
                               for b in short0] + [cut])
    if prep0["info"]["smem_bytes"] != bprep["info"]["smem_bytes"]:
        fail(f"{kind}: the compared launch takes {prep0['info']['smem_bytes']}"
             f" B per CTA, the wave {bprep['info']['smem_bytes']} B")
    box0_bound = bound_ms(prep0, out_bytes=4)[0]
    del prep, prep1, short, short1, bprep, prep0
    # ---- small pairs on the card against --device cpu
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, _ = write_pairs(d, 2, seed=5, lo=280, hi=320, kind=kind)
        on_card = pair_decode_cli(d, pairs_txt, bc, "card")
        on_cpu = pair_decode_cli(d, pairs_txt, bc, "cpu", device="cpu")
        for suf in (".1d.fasta", ".2d.fasta"):
            a = open(os.path.join(d, "card" + suf), "rb").read()
            b = open(os.path.join(d, "cpu" + suf), "rb").read()
            if a != b or len(on_card[0]) != 2:
                fail(f"{kind}: the card's {suf} differs from --device cpu")
        log(f"  {kind}: 2 pairs of ~300 bases byte-identical to --device cpu "
            f"(.1d.fasta, .2d.fasta); card {on_card[3]:.2f} s, cpu "
            f"{on_cpu[3]:.2f} s")
    tag = f" ({model})"
    out = [{
        "name": "pair_beam_batch" + tag, "kinds": [model], "route": "cuda",
        "source": "poreover_tpu_torch/csrc/pair_beam_batch.cu",
        "replaces": "poreover_tpu/ops/pallas_pair_beam_batch.py:1169",
        "launches": launches, "max_abs_err": stats["max_abs_err"],
        "ms": wave_ms, "plain_ms": short_p, "bound_ms": wave_bound,
        "us_per_step": wave_ms * 1e3 / int(steps.max()),
        "bound_by": wave_by, "library_ms": None,
        "plain_input": f"pair wave, first {PLAIN_STEPS_KINDS} plan steps per "
                       "pair",
        "ms_on_plain_input": short_k, "bound_ms_on_plain_input": short_bound,
    }, {
        "name": "pair_beam_single" + tag, "kinds": [model], "route": "cuda",
        "source": "poreover_tpu_torch/csrc/pair_beam_batch.cu",
        "replaces": "poreover_tpu/ops/pallas_pair_beam.py:636",
        "launches": single_launches,
        "max_abs_err": stats_single["max_abs_err"],
        "ms": one_ms, "plain_ms": short1_p, "bound_ms": one_bound,
        "us_per_step": one_ms * 1e3 / int(steps[0]),
        "bound_by": one_by, "library_ms": None,
        "plain_input": f"pair 0, first {PLAIN_STEPS_SINGLE} plan steps",
        "ms_on_plain_input": short1_k,
    }, {
        "name": "box_beam" + tag, "kinds": [model], "route": "cuda",
        "source": "poreover_tpu_torch/csrc/box_beam.cu",
        "replaces": "poreover_tpu/ops/pallas_box_beam.py:1007",
        "launches": box_launches, "max_abs_err": stats_box["max_abs_err"],
        "ms": box_ms, "plain_ms": box0_p, "bound_ms": box_bound,
        "us_per_step": box_ms * 1e3 / int(bsteps.max()),
        "bound_by": box_by, "library_ms": None,
        "plain_input": f"pair 0's boxes of the anchored wave with plans of "
                       f"<= {BOX_PLAIN_STEPS} steps, and the wave's widest "
                       f"box cut to {BOX_PLAIN_STEPS} steps",
        "ms_on_plain_input": box0_k, "bound_ms_on_plain_input": box0_bound,
    }]
    if kind == "flipflop":
        flipflop_template_control()
        out.append(flipflop_stage1(reads, vit_launches, gpu))
    return out


def pair_reads(d, files, basecaller):
    """The float32 log-probabilities of each pair's reads in ``files``
    (read 2 reverse-complemented, as pair-decode takes it), in order."""
    from poreover_tpu_torch.io.trace import model_from_trace

    reads = []
    for r1, r2 in files:
        m1 = model_from_trace(os.path.join(d, r1), basecaller)
        m2 = model_from_trace(os.path.join(d, r2), basecaller)
        m2.reverse_complement()
        reads += [m1.log_prob.astype(np.float32),
                  m2.log_prob.astype(np.float32)]
    return reads


def parent_module(name):
    """The module ``poreover_tpu_torch.ops.<name>`` of the ``--parent``
    tree, imported under another package name (its kernels build from its
    own sources into its own ``_build/``)."""
    import importlib
    import importlib.util

    pkg = "poreover_parent"
    if pkg not in sys.modules:
        root = os.path.join(PARENT, "poreover_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            pkg, os.path.join(root, "__init__.py"),
            submodule_search_locations=[root])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[pkg] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{pkg}.ops.{name}")


def turns_ms(new, old, reps):
    """Two launches timed in turns new, old, old, new (``event_ms`` of
    ``reps`` launches each); returns (new ms, old ms), each the mean of its
    two turns."""
    a = [event_ms(new, reps)]
    b = [event_ms(old, reps), event_ms(old, reps)]
    a.append(event_ms(new, reps))
    return float(np.mean(a)), float(np.mean(b))


def flipflop_stage1(reads, launches, gpu):
    """Flip-flop stage 1 at full size: the Viterbi kernel per pair (both
    reads in one launch, as pair-decode calls it) and on all 16 reads of
    the wave in one launch, then on read 1 of pair 0: through the wrapper
    (upload and fetch included) and alone on device tensors
    (``viterbi_cuda``), against the old loop (the plain version, on the
    card), with the instrumented build's cycles per step; with
    ``--parent``, the parent tree's kernel on the same read and pairs, in
    turns with this one, its path equal. Returns the kernels-line entry."""
    import torch
    from poreover_tpu_torch.models.transducer import flipflop_transition_mask
    from poreover_tpu_torch.ops import viterbi as tv

    mask = flipflop_transition_mask()
    per_pair = [event_ms(lambda: tv.viterbi_path_masked_batch(
        reads[i:i + 2], mask, device=DEVICE), reps=1)
        for i in range(0, len(reads), 2)]
    all_ms = event_ms(lambda: tv.viterbi_path_masked_batch(
        reads, mask, device=DEVICE), reps=1)
    y0 = reads[0]
    one_ms = event_ms(lambda: tv.viterbi_path_masked(y0, mask,
                                                     device=DEVICE), reps=3)
    y_d = torch.as_tensor(y0, device=DEVICE)[None]
    trans = tv._trans(mask, "additive", torch.float32, y_d.device)
    want, plain_ms = timed(lambda: tv._viterbi_masked_padded(
        y_d, [len(y0)], trans))
    got = tv.viterbi_path_masked(y0, mask, device=DEVICE)
    if not np.array_equal(got, want[0]):
        fail("flip-flop stage 1: the kernel's path of read 1 of pair 0 "
             "differs from the old loop's")
    meta = torch.tensor([[0, len(y0)]], dtype=torch.int64, device=DEVICE)
    trans_c = trans.contiguous()
    kern_ms = event_ms(lambda: tv.viterbi_cuda(y_d[0], meta, trans_c),
                       reps=3)
    bound, by = viterbi_bound_ms([len(y0)])
    floor_ms, floor_cyc, lat, clocks = viterbi_floor_ms(y0, mask, len(y0))
    lens = [len(y) for y in reads]
    log(f"  [{gpu}] flip-flop stage 1 (viterbi_dp): per pair launch (2 "
        f"reads) " + " ".join(f"{x:.2f}" for x in per_pair) + " ms; all 16 "
        f"reads in one launch {all_ms:.2f} ms; read 1 of pair 0 "
        f"({len(y0)} steps): {one_ms:.2f} ms through the wrapper, kernel "
        f"alone {kern_ms:.3f} ms ({kern_ms * 1e3 / len(y0):.4f} us per "
        f"step; bound {bound:.4f} ms, {by}; latency floor {floor_ms:.3f} "
        f"ms: {floor_cyc:.1f} cycles a step, the shared-memory broadcast "
        f"{lat['warp_rt']:.1f}, two adds of {lat['add']:.1f} and a max tree "
        f"of depth {math.ceil(math.log2(y0.shape[1]))} at {lat['max']:.1f}; "
        f"clocked: the chain phase {clocks['forward']['chain']:.1f} cycles "
        f"with its clock reads), the old loop {plain_ms:.1f} ms, path "
        f"equal; reads {min(lens)}-{max(lens)} steps")
    entry = {
        "name": "viterbi", "kinds": ["ctc_flipflop"], "route": "cuda",
        "source": "poreover_tpu_torch/csrc/viterbi.cu",
        "replaces": "poreover_tpu/ops/viterbi.py:27 (a lax.scan, not a "
                    "Pallas kernel)",
        "launches": launches, "max_abs_err": 0.0, "ms": one_ms,
        "kernel_ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": by, "latency_floor_ms": floor_ms,
        "latency_floor_cycles": floor_cyc, "latencies": lat,
        "library_ms": None, "ms_per_pair": per_pair, "cycles": clocks,
        "plain_input": "read 1 of pair 0 of the flip-flop wave, as for ms",
    }
    if PARENT:
        pv = parent_module("viterbi")
        if not np.array_equal(pv.viterbi_path_masked(y0, mask,
                                                     device=DEVICE), got):
            fail("flip-flop stage 1: the parent tree's kernel gives another "
                 "path of read 1 of pair 0")
        new_ms, old_ms = turns_ms(
            lambda: tv.viterbi_cuda(y_d[0], meta, trans_c),
            lambda: pv.viterbi_cuda(y_d[0], meta, trans_c), reps=3)
        old_pair = [event_ms(lambda: pv.viterbi_path_masked_batch(
            reads[i:i + 2], mask, device=DEVICE), reps=1)
            for i in range(0, len(reads), 2)]
        log(f"  [{gpu}] the parent tree's Viterbi kernel, in turns with "
            f"this one on read 1 of pair 0: kernel alone {old_ms:.3f} ms "
            f"against {new_ms:.3f} ms ({old_ms / new_ms:.2f}x); per pair "
            "launch " + " ".join(f"{x:.2f}" for x in old_pair) + " ms")
        entry.update(old_kernel_ms=old_ms, kernel_ms_in_turns=new_ms,
                     old_ms_per_pair=old_pair)
    return entry


def instruction_latencies() -> dict:
    """The probe ``csrc/latency.cu`` on the card (built once): cycles of
    one dependent round of each kind: ``add``, ``max`` (an add then a max,
    less the add), ``shfl_max`` (a shuffle then a max), ``warp_rt`` and
    ``cta_rt`` (a store, ``__syncwarp`` / ``__syncthreads`` of 256
    threads, a load of another thread's word)."""
    import ctypes

    from poreover_tpu_torch import build

    global LATENCIES
    if LATENCIES is None:
        lib = ctypes.CDLL(str(build.build_kernel("latency")))
        lib.latency_probe.restype = ctypes.c_int
        lib.latency_probe.argtypes = [ctypes.POINTER(ctypes.c_double),
                                      ctypes.c_int]
        out = (ctypes.c_double * 5)()
        if lib.latency_probe(out, 4096):
            fail("the latency probe failed")
        add, add_max, shfl_max, warp_rt, cta_rt = out
        LATENCIES = dict(add=add, max=add_max - add, shfl_max=shfl_max,
                         warp_rt=warp_rt, cta_rt=cta_rt)
        if min(LATENCIES.values()) < 1:
            fail(f"the latency probe's rounds were folded: {LATENCIES}")
    return LATENCIES


def viterbi_floor_cycles(lat, S) -> float:
    """The least dependent chain of one Viterbi step (csrc/viterbi.cu's
    forward) at the latencies ``lat``: v to the warp through shared
    memory, the from-state add, the max tree of depth ceil(log2 S), the
    emission's add."""
    return (lat["warp_rt"] + 2 * lat["add"]
            + math.ceil(math.log2(S)) * lat["max"])


def acceptor_floor_cycles(lat, W) -> float:
    """The least dependent chain of one acceptor row over a window of W
    cells with one CTA barrier a row, at the latencies ``lat``: the row
    above through shared memory and the barrier, the emission's add and
    the subtraction of G, the max-scan's ceil(log2 W) levels (up to 5 of
    them across a warp's lanes by shuffles, the rest in registers), the
    add of G."""
    levels = math.ceil(math.log2(W))
    across = min(levels, 5)
    return (lat["cta_rt"] + 3 * lat["add"] + across * lat["shfl_max"]
            + (levels - across) * lat["max"])


def viterbi_floor_ms(y0, mask, T):
    """The instrumented build's cycles per step on ``y0``
    (``clock_breakdown``) and the latency floor: T - 1 steps of the least
    dependent chain (``viterbi_floor_cycles``) at the card's maximum SM
    clock. Returns (ms, floor cycles per step, latencies, clocks)."""
    from poreover_tpu_torch.ops import viterbi as tv

    clocks, _ = clock_breakdown(
        f"read 1 of pair 0 ({T} steps)", tv,
        lambda: tv.viterbi_path_masked(y0, mask, device=DEVICE))
    lat = instruction_latencies()
    cyc = viterbi_floor_cycles(lat, y0.shape[1])
    return (T - 1) * cyc / (sm_clock_mhz() * 1e3), cyc, lat, clocks


def mixed_pairs_file():
    """Phase 11: a pairs file under ``--basecaller poreover`` holding one
    CTC ``.npy`` pair and one 8-column CSV (flip-flop) pair, ~600 bases:
    both decode, one pair-kernel launch per kind, and each pair's
    consensus equals its own kind's run."""
    from poreover_tpu_torch.ops import pair_beam_batch as pbb
    from poreover_tpu_torch.sim import write_pairs

    with tempfile.TemporaryDirectory() as d:
        p, _ = write_pairs(d, 1, seed=21, lo=550, hi=650)
        lines = open(p).read()
        p, _ = write_pairs(d, 1, seed=22, lo=550, hi=650, kind="flipflop")
        lines += open(p).read()
        mixed = os.path.join(d, "mixed.txt")
        with open(mixed, "w") as f:
            f.write(lines)
        zero_counts()
        cons, _, rows, wall, _ = pair_decode_cli(d, mixed, "poreover", "mix")
        launches = pbb.launch_count
        alone = pair_decode_cli(d, p, "flappie", "ff")[0]
    if len(cons) != 2 or any(r[-1] != "0" for r in rows) or launches != 2:
        fail(f"mixed pairs file: {len(cons)} records, {launches} "
             f"pair-kernel launches, log rows {rows}")
    if cons[1] != alone[0]:
        fail("mixed pairs file: the flip-flop pair's consensus differs from "
             "its run under --basecaller flappie")
    log(f"phase 11 mixed pairs file (--basecaller poreover): a CTC pair and "
        f"a flip-flop CSV pair both decoded, {launches} pair-kernel "
        f"launches (one per kind), {wall:.2f} s; the flip-flop pair's "
        "consensus equals its own run's")


def single_beam_phase(gpu, truth, cons_viterbi):
    """Phase 12: ``pair-decode --single beam`` on phase 3's 8 full-size CTC
    pairs through the CLI (launch counts zeroed just before, read just
    after: one 1D beam and one acceptor launch per pair, one pair-kernel
    launch); 8 records, none skipped; pair 0 at >= 0.999 to the f64 oracle
    on this run's envelope; each consensus's identity to the truth beside
    read 1's beam call and phase 3's ``--single viterbi`` consensus; the
    acceptor kernel against its plain version on pair 0's two reads with
    the labels the 1D beam wrote, timed per read and per pair launch; the
    small bonito and flip-flop pairs of the CPU tests byte-identical to
    ``--device cpu``, and their stage 1 paths on the card equal to the
    CPU's. Returns the acceptor's entry of the kernels line."""
    from poreover_tpu_torch import native
    from poreover_tpu_torch.io.trace import model_from_trace
    from poreover_tpu_torch.models.transducer import beam_acceptor_batch
    from poreover_tpu_torch.ops import acceptor as ta
    from poreover_tpu_torch.ops import beam1d
    from poreover_tpu_torch.ops import pair_beam_batch as pbb
    from poreover_tpu_torch.sim import write_pairs

    sb = ("--single", "beam")
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, _ = write_pairs(d, 8, seed=7, lo=5200, hi=8200)
        zero_counts()
        cons, calls, rows, wall, tm = pair_decode_cli(d, pairs_txt,
                                                      "poreover", "sb", sb)
        launches = {"beam1d": beam1d.launch_count,
                    "acceptor": ta.launch_count,
                    "pair_beam_batch": pbb.launch_count}
        if len(cons) != 8 or any(r[-1] != "0" for r in rows):
            fail(f"--single beam: expected 8 consensus records and no "
                 f"skips; got {len(cons)} records, log rows {rows}")
        if min(launches.values()) < 1:
            fail(f"--single beam: a kernel of its path ran no time: "
                 f"{launches}")
        wl0 = workload_of(d, "s0_1.npy", "s0_2.npy", extra=sb)
        m1 = model_from_trace(os.path.join(d, "s0_1.npy"), "poreover")
        m2 = model_from_trace(os.path.join(d, "s0_2.npy"), "poreover")
        m2.reverse_complement()
    log(f"phase 12 pair-decode --single beam: 8 pairs, launches {launches}, "
        f"end-to-end {wall:.2f} s ({8 / wall:.2f} pairs/s; consensus "
        f"{8 / tm['consensus_2d']:.2f} pairs/s stage 4 wall); stages "
        + " ".join(f"{k}={v:.3f}s" for k, v in tm.items()))
    t0 = time.perf_counter()
    oracle = native.pair_beam_row_col_cpu_emul(*wl0, beam_width=5)
    ident = identity(cons[0], oracle)
    log(f"  pair 0: consensus {len(cons[0])} bases, f64 oracle on this run's "
        f"envelope {len(oracle)} bases ({time.perf_counter() - t0:.1f} s), "
        f"aligned identity {ident:.6f}")
    if not np.isfinite(ident) or ident < 0.999:
        fail(f"--single beam pair 0 identity {ident} to the f64 oracle < "
             "0.999")
    ids = [identity(c, t) for c, t in zip(cons, truth)]
    ids_call = [identity(c, t) for c, t in zip(calls[0::2], truth)]
    ids_vit = [identity(c, t) for c, t in zip(cons_viterbi, truth)]
    log("  identity to read 1's true sequence, --single beam consensus / "
        "read 1's beam call / --single viterbi consensus: "
        + " ".join(f"{a:.4f}/{b:.4f}/{c:.4f}"
                   for a, b, c in zip(ids, ids_call, ids_vit))
        + f"; means {np.mean(ids):.4f}/{np.mean(ids_call):.4f}/"
        f"{np.mean(ids_vit):.4f}")

    # the acceptor kernel on pair 0's reads, with the 1D beam's labels
    acc = acceptor_full_size([m1.log_prob, m2.log_prob], calls[:2], gpu)
    log(f"  1d_basecall {tm['1d_basecall']:.3f} s = beam_1d "
        f"{tm['beam_1d']:.3f} s + acceptor {tm['acceptor']:.3f} s + the "
        "sequence maps")

    # the other kinds: the CPU tests' small pairs, card against cpu
    for kind in ("bonito", "flipflop"):
        with tempfile.TemporaryDirectory() as d:
            pairs_txt, _ = write_pairs(d, 3, seed=17, lo=70, hi=100,
                                       kind=kind)
            outs = [pair_decode_cli(d, pairs_txt, BASECALLER[kind], f"o_{dv}",
                                    sb, device=dv) for dv in (DEVICE, "cpu")]
            for suffix in (".1d.fasta", ".2d.fasta", ".log"):
                a, b = (open(os.path.join(d, f"o_{dv}{suffix}")).read()
                        for dv in (DEVICE, "cpu"))
                if suffix == ".log":
                    a, b = a.splitlines()[2:], b.splitlines()[2:]
                if a != b:
                    fail(f"--single beam {kind}: {suffix} differs between "
                         "the card and --device cpu")
            ext = ".csv" if kind == "flipflop" else ".npy"
            bad = 0
            for r1, r2 in pair_files(pairs_txt):
                ms = [model_from_trace(os.path.join(d, r), BASECALLER[kind])
                      for r in (r1, r2)]
                ms[1].reverse_complement()
                on_card, on_cpu = (beam_acceptor_batch(ms, device=dv)
                                   for dv in (DEVICE, "cpu"))
                bad += sum(a[0] != b[0] or not np.array_equal(a[1], b[1])
                           for a, b in zip(on_card, on_cpu))
            if bad:
                fail(f"--single beam {kind}: {bad} stage 1 results differ "
                     "between the card and the CPU")
            n_ok = sum(r[-1] == "0" for r in outs[0][2])
        log(f"  --single beam {kind} ({ext} traces): 3 small pairs, files "
            f"byte-identical to --device cpu ({n_ok} decoded, the others "
            "skipped as in the JAX package); stage 1 strings and paths "
            "equal on both")
    acc["launches"] = launches["acceptor"]
    return acc


def acceptor_full_size(ys, labels, gpu):
    """The acceptor kernel on a full-size pair (``ys``, the 1D beam's
    ``labels``): held to its plain version (``compare_acceptor``), timed per
    pair launch and per read with its bound and latency floor, the cycles
    per row of the instrumented build; with ``--parent``, the parent
    tree's kernel on the same reads in turns with this one, its path equal.
    Returns the kernels-line entry (without ``launches``)."""
    import torch
    from poreover_tpu_torch.ops import acceptor as ta

    packed = ta.pack_acceptor(ys, labels, 1000)
    _, p_ms = compare_acceptor("pair 0 at full size, the 1D beam's labels",
                               packed)
    args = ta.upload(packed, torch.device(DEVICE))

    def launch():
        return ta.acceptor_cuda(*args, packed["meta"], 4)

    pair_ms = event_ms(launch, reps=3)
    bound, by = acceptor_bound_ms(packed)
    per_read = []
    for y, label in zip(ys, labels):
        one = ta.pack_acceptor([y], [label], 1000)
        a1 = ta.upload(one, torch.device(DEVICE))
        per_read.append((len(y), len(label), event_ms(
            lambda: ta.acceptor_cuda(*a1, one["meta"], 4), reps=3),
            acceptor_bound_ms(one)[0]))
    longer = int(np.argmax(packed["meta"][:, 3]))
    rows, W = (int(x) for x in packed["meta"][longer, [3, 4]])
    clocks, _ = clock_breakdown(
        f"pair 0 at full size ({rows} rows in the longer read)", ta, launch)
    lat = instruction_latencies()
    floor_cyc = acceptor_floor_cycles(lat, W)
    floor_ms = rows * floor_cyc / (sm_clock_mhz() * 1e3)
    log(f"  acceptor [{gpu}]: {pair_ms:.2f} ms per pair launch (bound "
        f"{bound:.4f} ms, {by}; latency floor {floor_ms:.3f} ms: {rows} "
        f"rows x {floor_cyc:.1f} cycles, the row above through shared "
        f"memory and a barrier {lat['cta_rt']:.1f}, three adds of "
        f"{lat['add']:.1f}, a max-scan over {W} cells of "
        f"{math.ceil(math.log2(W))} levels (shuffle and max "
        f"{lat['shfl_max']:.1f}, max {lat['max']:.1f}); clocked: emit, "
        f"scan and bar1 "
        f"{sum(clocks['rows'][p] for p in ('emit', 'scan', 'bar1')):.1f} "
        f"cycles a row with their clock reads); per read "
        + "; ".join(f"T={T} L={L}: {ms:.2f} ms ({ms * 1e3 / L:.3f} us per "
                    f"row, bound {b:.4f} ms)" for T, L, ms, b in per_read)
        + f"; plain version {p_ms:.1f} ms per pair")
    entry = {
        "name": "acceptor", "kinds": ["ctc", "ctc_merge_repeats",
                                      "ctc_flipflop"], "route": "cuda",
        "source": "poreover_tpu_torch/csrc/acceptor.cu",
        "replaces": "poreover_tpu/ops/acceptor.py:60 (a lax.scan, not a "
                    "Pallas kernel)",
        "max_abs_err": 0.0,  # pointers and paths are integers, held equal
        "ms": pair_ms, "plain_ms": p_ms,
        "bound_ms": bound, "bound_by": by, "latency_floor_ms": floor_ms,
        "latency_floor_cycles": floor_cyc, "library_ms": None,
        "ms_per_read": [ms for _, _, ms, _ in per_read],
        "us_per_row": [ms * 1e3 / L for _, L, ms, _ in per_read],
        "cycles": clocks,
        "plain_input": "pair 0 of the --single beam wave, both reads",
    }
    if PARENT:
        pa = parent_module("acceptor")
        old = pa.pack_acceptor(ys, labels, 1000)
        old_args = pa.upload(old, torch.device(DEVICE))

        def old_launch():
            return pa.acceptor_cuda(*old_args, old["meta"], 4)

        if not torch.equal(old_launch()[1], launch()[1]):
            fail("acceptor: the parent tree's kernel gives other paths of "
                 "pair 0")
        new_ms, old_ms = turns_ms(launch, old_launch, reps=3)
        log(f"  acceptor [{gpu}]: the parent tree's kernel, in turns with "
            f"this one on pair 0: {old_ms:.2f} ms per pair launch against "
            f"{new_ms:.2f} ms ({old_ms / new_ms:.2f}x)")
        entry.update(old_ms=old_ms, ms_in_turns=new_ms)
    return entry


def call_and_fused_phases(gpu):
    """Phases 13 and 14: ``call`` at full width, then ``call --decode
    viterbi|beam``, on CALL_READS seeded raw signals of CALL_SAMPLES
    samples (FAST5 files through the CLI when h5py is installed; without
    it, the same signals enter below ``parse_fast5``, scaled by its
    ``scale_signal``). The conv1_bigru3 network at 256 / 9 / 128 with the
    seeded initialiser's weights, written as a TF bundle and read back
    through ``--weights``."""
    import importlib.util

    import torch
    from poreover_tpu_torch.cli import build_parser
    from poreover_tpu_torch.cli import main as cli_main
    from poreover_tpu_torch.decoding import fused
    from poreover_tpu_torch.io.fast5 import batch_input, scale_signal
    from poreover_tpu_torch.network import call as nc
    from poreover_tpu_torch.network.model import (
        ARCHS, init_params, load_network,
    )
    from poreover_tpu_torch.ops import beam1d
    from poreover_tpu_torch.sim import synth_raw_signal, write_fast5
    from tools.tf_bundle import keras_conv1_bigru3_tensors, write_bundle

    have_h5py = importlib.util.find_spec("h5py") is not None
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(31)
    raws = [synth_raw_signal(rng, int(rng.integers(*CALL_SAMPLES)))
            for _ in range(CALL_READS)]
    names = [f"c{i:02d}" for i in range(CALL_READS)]
    signals = [scale_signal(r) for r in raws]
    n_samples = sum(len(s) for s in signals)
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "ckpt", "checkpoint-0")
        write_bundle(prefix, keras_conv1_bigru3_tensors(
            init_params("conv1_bigru3", seed=0)))
        reads = os.path.join(d, "reads")
        os.makedirs(reads)
        if have_h5py:
            for name, raw in zip(names, raws):
                write_fast5(os.path.join(reads, name + ".fast5"), raw, name)

        def run_call(out, device, n):
            """``call`` of the first n reads on ``device``; (wall seconds,
            of which loading the model, or None through the CLI)."""
            os.makedirs(out, exist_ok=True)
            t0 = time.perf_counter()
            t_load = None
            if have_h5py:
                src = reads if n == CALL_READS else os.path.join(
                    reads, names[0] + ".fast5")
                cli_main(["call", src, "--weights", prefix, "--dir", out,
                          "--device", device])
            else:
                args = build_parser().parse_args(
                    ["call", reads, "--weights", prefix, "--dir", out])
                dv = torch.device(device)
                fwd = nc.make_forward(nc.load_model(args, dv), dv)
                t_load = time.perf_counter() - t0
                for name, sig in zip(names[:n], signals[:n]):
                    nc.call_signal(args, fwd, sig, name)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, t_load

        zero_counts()
        call_wall, t_load = run_call(os.path.join(d, "probs"), DEVICE,
                                     CALL_READS)
        probs = [np.load(os.path.join(d, "probs", n + ".npy")) for n in names]
        if [len(p) for p in probs] != [len(s) for s in signals] or any(
                not np.all(np.isfinite(p)) for p in probs):
            fail("call: the probabilities' shapes or values are wrong")
        run_call(os.path.join(d, "probs_cpu"), "cpu", 1)
        cpu0 = np.load(os.path.join(d, "probs_cpu", names[0] + ".npy"))
        err = float(np.abs(cpu0 - probs[0]).max())
        net = nc.load_model(build_parser().parse_args(
            ["call", reads, "--weights", prefix]), dev)
        x = torch.as_tensor(batch_input(signals[0], 1000)[0][:1].astype(
            np.float32)).to(dev)[0]
        with torch.inference_mode():
            fwd_ms = event_ms(lambda: torch.softmax(net(x), -1), reps=5)
        how = ("FAST5 files through the CLI" if have_h5py else "no h5py on "
               "this machine: the signals enter below parse_fast5")
        log(f"phase 13 call [{gpu}] ({how}): {CALL_READS} reads, "
            f"{n_samples} samples, end to end "
            f"{call_wall:.2f} s ({n_samples / call_wall:.0f} samples/s"
            + (f"; model load {t_load:.2f} s, then "
               f"{(call_wall - t_load) * 1e3 / CALL_READS:.1f} ms per read"
               if t_load is not None else "") + "); "
            f"forward + softmax {fwd_ms:.2f} ms per [128, 1000, 1] batch; "
            f"read 0 against --device cpu: max abs difference "
            f"{err:.3g} (tolerance {PROB_ATOL})")
        if not err <= PROB_ATOL:
            fail(f"call: the card's probabilities differ from the CPU's by "
                 f"{err} > {PROB_ATOL}")
        xb = batch_input(signals[0], 1000)[0][0].astype(np.float32)
        for arch in ARCHS:
            if arch == "conv1_bigru3":
                continue
            tree = init_params(arch, seed=0)
            outs = []
            for dv in (dev, torch.device("cpu")):
                net_a = load_network(tree, arch, device=dv)
                with torch.inference_mode():
                    outs.append(torch.softmax(
                        net_a(torch.as_tensor(xb).to(dv)), -1).cpu().numpy())
            e = float(np.abs(outs[0] - outs[1]).max())
            same = float((outs[0].argmax(-1) == outs[1].argmax(-1)).mean())
            log(f"  {arch}: one [128, 1000, 1] batch, card against CPU max "
                f"abs difference {e:.3g}, argmax equal at {same:.6f} of "
                "steps")
            if not e <= PROB_ATOL:
                fail(f"{arch}: card against CPU {e} > {PROB_ATOL}")

        # ---- phase 14: fused decodes against call then decode
        def fused_run(algorithm):
            out = os.path.join(d, f"fused_{algorithm}")
            argv = ["call", reads, "--weights", prefix, "--decode",
                    algorithm, "--out", out]
            t0 = time.perf_counter()
            if have_h5py:
                cli_main(argv)
            else:
                args = build_parser().parse_args(argv)
                fused.decode_signals(args, nc.load_model(args, dev), names,
                                     signals, dev)
            torch.cuda.synchronize()
            return read_fasta(out + ".fasta"), time.perf_counter() - t0

        summary = {}
        for algorithm in ("viterbi", "beam"):
            zero_counts()
            got, wall = fused_run(algorithm)
            b4 = beam1d.launch_count
            two, two_wall, _ = decode_cli(os.path.join(d, "probs"),
                                          [os.path.join(d, "probs")],
                                          "poreover", algorithm, "two_" +
                                          algorithm)
            two = [two[n] for n in names]
            differ = [i for i, (a, b) in enumerate(zip(got, two)) if a != b]
            summary[algorithm] = (wall, two_wall, b4, differ)
            if len(got) != CALL_READS:
                fail(f"call --decode {algorithm}: {len(got)} records")
            if algorithm == "viterbi" and differ:
                fail(f"call --decode viterbi differs from call then decode "
                     f"at reads {differ}")
            if algorithm == "beam" and b4 < 1:
                fail("call --decode beam launched beam1d no time")
        # the beam's control: the saved probabilities' log taken on the card
        # (as the fused path takes it), then packed on the host by the
        # two-stage path's packer, so that only the log is shared with the
        # fused path; the fused packer's planes must equal the host's
        ys = [torch.log(torch.as_tensor(p).to(dev)) for p in probs]
        ys_h = [a.cpu().numpy() for a in ys]
        control = beam1d.beam1d_batch(ys_h, 25, device=dev)
        if control != got:
            fail("call --decode beam differs from the card-log decode of the "
                 "saved probabilities")
        y, root, meta, meta_h = fused.pack_planes(ys)
        planes_h = beam1d.planes_from_numpy(ys_h, "ctc")
        root_diff = int((root.cpu().numpy() != planes_h["root"]).sum())
        if (root_diff or not np.array_equal(meta_h, planes_h["meta"])
                or not np.array_equal(y.cpu().numpy(), planes_h["y"])):
            fail(f"fused.pack_planes differs from planes_from_numpy on the "
                 f"same log values ({root_diff} root prefix sums differ)")
        b4_ms = event_ms(lambda: beam1d.beam1d_cuda(y, root, meta, meta_h,
                                                    25, 4, 0), reps=2)
        host = [np.log(p) for p in probs]
        log_diff = sum(int((a != b).sum()) for a, b in zip(ys_h, host))
        n_log = sum(h.size for h in host)
        (v_wall, v_two, _, _), (b_wall, b_two, b4, differ) = (
            summary["viterbi"], summary["beam"])
        log(f"phase 14 fused [{gpu}]: call --decode viterbi {v_wall:.2f} s "
            f"({CALL_READS / v_wall:.2f} reads/s), FASTA byte-identical to "
            f"call then decode --algorithm viterbi ({v_two:.2f} s); call "
            f"--decode beam {b_wall:.2f} s ({CALL_READS / b_wall:.2f} "
            f"reads/s; {b4} beam1d launch(es), kernel {b4_ms:.1f} ms per "
            f"wave), equal to the card-log control; against call then "
            f"decode --algorithm beam ({b_two:.2f} s): {len(differ)} of "
            f"{CALL_READS} records differ {differ}")
        if differ:
            log("  the records that differ, aligned identity of the fused "
                "string to the two-stage one: " + " ".join(
                    f"{i}: {identity(got[i], two[i]):.6f}" for i in differ))
        log(f"  log of the saved probabilities, the card's torch.log against "
            f"numpy's np.log on this host: {log_diff} of {n_log} entries "
            f"differ ({log_diff / n_log:.2%}); the fused packer's planes "
            f"equal the host packer's on the card's log values (root plane: "
            f"{root_diff} of {len(planes_h['root'])} prefix sums differ)")


def ulp_diff(a, b) -> int:
    """Largest distance in units of the last place between two float32
    arrays of equal shape (0 where both are zeros of either sign)."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max()) if np.size(a) else 0


def ctc_case_inputs(rng, rows, T, dev):
    """One CTC batch on ``dev``: rows of (label, logit length); seeded
    logits N(0, 2) through the loss's log-softmax. Returns (logp, labels,
    label_lengths, logit_lengths) as the kernels take them."""
    import torch
    from poreover_tpu_torch.ops import ctc

    B = len(rows)
    L = max(1, max(len(lab) for lab, _ in rows))
    labels = np.zeros((B, L), np.int32)
    for i, (lab, _) in enumerate(rows):
        labels[i, :len(lab)] = lab
    logits = torch.as_tensor(rng.normal(0, 2, (B, T, 5)).astype(np.float32))
    def as_int(v):
        return torch.as_tensor(np.asarray(v, np.int32)).to(dev)

    return (ctc.log_softmax(logits.to(dev)).contiguous(), as_int(labels),
            as_int([len(lab) for lab, _ in rows]),
            as_int([tb for _, tb in rows]))


def ctc_fwd_bwd(fn, logp, labels, lab_len, logit_len, merge):
    """(nll, gradient in logp of the batch mean) through ``fn``."""
    import torch

    x = logp.detach().clone().requires_grad_(True)
    nll = fn(x, labels, lab_len, logit_len, merge)
    g, = torch.autograd.grad(nll.mean(), x)
    return nll.detach(), g


def ctc_bound_ms(logp, labels, lab_len, logit_len, merge):
    """Least time of one forward and backward: the bytes the function must
    move (logp and the labels read, the loss and the gradient written) over
    HBM bandwidth against its float operations over the float32 peak; and
    the same with the design's own traffic: the alpha columns written and
    read back once, then also the class terms (csrc/ctc.cu: plain two
    [B, T, SP] arrays, merging one) written and read back once."""
    from poreover_tpu_torch.ops.ctc import padded_states

    B, T, C = logp.shape
    L = labels.shape[1]
    Lb = lab_len.cpu().numpy().clip(0, L)
    Tb = logit_len.cpu().numpy().clip(0, T)
    S = 2 * Lb + 1 if merge else Lb + 1
    ops = float((S * Tb).sum()) * sum(CTC_OPS[merge])
    nbytes = 2 * B * T * C * 4 + B * L * 4 + 3 * B * 4
    SP = padded_states(L, merge)
    alpha_bytes = 2 * B * (T + 1) * SP * 4
    terms_bytes = 2 * (1 if merge else 2) * B * T * SP * 4
    t_ops = ops / F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    t_alpha = (nbytes + alpha_bytes) / HBM_BPS * 1e3
    t_design = (nbytes + alpha_bytes + terms_bytes) / HBM_BPS * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound[0], bound[1], max(t_alpha, t_ops), max(t_design, t_ops)


def compare_ctc(name, inputs, merge, timing=False):
    """The CTC kernels against ``ctc_plain`` on the card: the loss
    bit-equal, the gradient within CTC_GRAD_ULP. With ``timing``, the
    kernels' times (CUDA events, each pass apart), the plain version's
    (host clock around one forward and backward) and, for merge, the
    library's ``F.ctc_loss`` forward and backward and its difference from
    the kernel. Returns a dict of the numbers."""
    import torch
    import torch.nn.functional as F
    from poreover_tpu_torch.ops import ctc

    k_nll, k_g = ctc_fwd_bwd(ctc.ctc_cuda, *inputs, merge)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_nll, p_g = ctc_fwd_bwd(ctc.ctc_plain, *inputs, merge)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    kn, pn = k_nll.cpu().numpy(), p_nll.cpu().numpy()
    kg, pg = k_g.cpu().numpy(), p_g.cpu().numpy()
    ulp = ulp_diff(kg, pg)
    err = float(np.abs(kg - pg).max())
    if not np.all(np.isfinite(kn)) or not np.all(np.isfinite(kg)):
        fail(f"ctc {name}: the kernel's loss or gradient is not finite")
    if not np.array_equal(kn.view(np.int32), pn.view(np.int32)):
        fail(f"ctc {name}: the kernel's loss differs from the plain "
             f"version's at {np.flatnonzero(kn != pn).tolist()} (max abs "
             f"{np.abs(kn - pn).max()})")
    if ulp > CTC_GRAD_ULP:
        fail(f"ctc {name}: the gradient differs from the plain version's by "
             f"{ulp} ulp > {CTC_GRAD_ULP} (max abs {err})")
    out = {"max_abs_err": err, "grad_ulp": ulp, "plain_ms": plain_ms,
           "loss": kn}
    msg = (f"  ctc {'merge' if merge else 'plain'} {name}: loss bit-equal "
           f"to ctc_plain, gradient {ulp} ulp (max abs {err:.3g})")
    if timing:
        logp, labels, lab_len, logit_len = inputs
        go = torch.full_like(k_nll, 1.0 / len(k_nll))
        _, alpha = ctc.alpha_pass(*inputs, merge)
        out["alpha_ms"] = event_ms(lambda: ctc.alpha_pass(*inputs, merge), 5)
        out["grad_ms"] = event_ms(lambda: ctc.grad_pass(*inputs, merge,
                                                        alpha, go), 5)
        out["ms"] = out["alpha_ms"] + out["grad_ms"]
        (out["bound_ms"], out["bound_by"], out["bound_ms_with_alpha"],
         out["bound_ms_with_design_traffic"]) = ctc_bound_ms(*inputs, merge)
        out["library_ms"] = None
        msg += (f"; kernel {out['ms']:.3f} ms (alpha {out['alpha_ms']:.3f}, "
                f"gradient {out['grad_ms']:.3f}), plain version "
                f"{plain_ms:.0f} ms, bound {out['bound_ms']:.4f} ms "
                f"({out['bound_by']}; {out['bound_ms_with_alpha']:.4f} ms "
                f"with the alpha columns' bytes, "
                f"{out['bound_ms_with_design_traffic']:.4f} ms with the class "
                "terms' too)")
        if merge:
            lp_tbc = logp.transpose(0, 1)
            tgt = labels.long()

            def library():
                x = lp_tbc.detach().requires_grad_(True)
                loss = F.ctc_loss(x, tgt, logit_len.long(), lab_len.long(),
                                  blank=4, reduction="none")
                torch.autograd.grad(loss.mean(), x)
                return loss

            lib_nll = library().detach().cpu().numpy()
            out["library_ms"] = event_ms(library, 5)
            out["library_abs_diff"] = float(np.abs(lib_nll - kn).max())
            out["library_rel_diff"] = float(
                (np.abs(lib_nll - kn) / np.abs(kn)).max())
            msg += (f"; F.ctc_loss forward + backward "
                    f"{out['library_ms']:.3f} ms (kernel / library "
                    f"{out['ms'] / out['library_ms']:.3f}), its loss against "
                    f"the kernel's: max abs {out['library_abs_diff']:.3g}, "
                    f"relative {out['library_rel_diff']:.3g}")
    log(msg)
    return out


def ctc_breakdown(name, inputs, merge):
    """``clock_breakdown`` of one alpha and one gradient launch of the CTC
    kernels on ``inputs``: the cycles per step of each phase of the alpha
    pass and of the gradient pass's sequential kernel."""
    import torch
    from poreover_tpu_torch.ops import ctc

    go = torch.full((inputs[0].shape[0],), 1.0 / inputs[0].shape[0],
                    device=inputs[0].device)

    def launch():
        _, alpha = ctc.alpha_pass(*inputs, merge)
        ctc.grad_pass(*inputs, merge, alpha, go)

    return clock_breakdown(f"{'merge' if merge else 'plain'}, {name}", ctc,
                           launch)[0]


def ctc_hand_rows(rng, T):
    """Hand cases at T steps: label_length 0; a label longer than T
    (infeasible in both variants); one base repeated (feasible without
    merging, infeasible with it: L + repeats > T); logit_lengths < T; a
    label of repeated pairs; logit_length 0."""
    def rnd(n):
        return rng.integers(0, 4, n).tolist()
    return [([], T), (rnd(T + 50), T), ([2] * (T * 3 // 5), T),
            (rnd(T // 5), T * 2 // 5 - 3), ([0, 0, 1, 1, 3, 3] * 10, T),
            (rnd(5), 0), (rnd(T // 7), T)]


def ctc_boundary_rows(rng, S, merge):
    """Rows with S states (a label of S - 1 plain, (S - 1) / 2 merging) at
    T = S + 12, an empty label, a logit length of 0 and one below T;
    returns (rows, T)."""
    Lb = (S - 1) // 2 if merge else S - 1
    T = S + 12

    def lab():
        return rng.integers(0, 4, Lb).tolist()
    return [(lab(), T), ([], T), (lab(), 0), (lab(), T // 2)], T


def ctc_long_rows(rng):
    """A label of CTC_LONG_LABEL bases without a base repeated next to
    itself (so merging can emit it in CTC_LONG_T steps), and a short one."""
    lab = [int(rng.integers(0, 4))]
    while len(lab) < CTC_LONG_LABEL:
        c = int(rng.integers(0, 3))
        lab.append(c if c < lab[-1] else c + 1)
    return [(lab, CTC_LONG_T), (rng.integers(0, 4, 30).tolist(), CTC_LONG_T)]


def sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.split()[0])


def train_windows(n, seed):
    """n seeded training windows as ``load_training_npz`` returns them."""
    import tempfile as tf_
    from poreover_tpu_torch.network.train import load_training_npz
    from poreover_tpu_torch.sim import synth_training_windows

    with tf_.TemporaryDirectory() as d:
        path = os.path.join(d, "training.npz")
        np.savez(path, **synth_training_windows(np.random.default_rng(seed),
                                                n, TRAIN_WINDOW))
        return load_training_npz(path)


def ctc_phase(gpu, main_batch):
    """Phase 15(a): the CTC kernels against ``ctc_plain`` on the card, both
    variants, at the trainer's shape (``main_batch``: 64 windows' labels,
    seeded logits), on the hand cases, at the boundary state counts and
    (merging) on a label near MAX_SP; timed at the trainer's shape beside
    ``F.ctc_loss``, with the instrumented build's cycles per step and a
    latency floor from them. Returns {merge: numbers}."""
    from poreover_tpu_torch.ops import ctc

    _, y, ylen = main_batch
    rng = np.random.default_rng(41)
    rows = [(y[i, :ylen[i]].tolist(), TRAIN_WINDOW) for i in range(len(y))]
    main = ctc_case_inputs(rng, rows, TRAIN_WINDOW, DEVICE)
    hand = ctc_case_inputs(rng, ctc_hand_rows(rng, 200), 200, DEVICE)
    mhz = sm_clock_mhz()
    res = {}
    for merge in (False, True):
        name = (f"B {len(y)} T {TRAIN_WINDOW} (labels {int(ylen.min())}-"
                f"{int(ylen.max())})")
        res[merge] = r = compare_ctc(name, main, merge, timing=True)
        r["clocks"] = ctc_breakdown(name, main, merge)
        # T dependent steps per pass, each at least the alpha step's
        # log-add-exp phase (one plain, two merging), at the maximum clock
        r["latency_floor_ms"] = (2 * TRAIN_WINDOW * r["clocks"]["alpha"]["lse"]
                                 / (mhz * 1e3))
        checks = [compare_ctc("hand cases T 200", hand, merge)]
        loss = checks[0]["loss"]
        if not (loss[1] > 9e4 and (loss[2] > 9e4) == merge
                and loss[5] > 9e4):
            fail(f"ctc hand cases: the infeasible rows' losses {loss} are "
                 "not near 1e5")
        for S in CTC_BOUNDARY_STATES:
            if merge and S % 2 == 0:
                continue
            rows_s, T = ctc_boundary_rows(rng, S, merge)
            inputs = ctc_case_inputs(rng, rows_s, T, DEVICE)
            SP = ctc.padded_states(inputs[1].shape[1], merge)
            geo = (ctc.launch_geometry(SP, merge, False)[:2],
                   ctc.launch_geometry(SP, merge, True)[:3])
            checks.append(compare_ctc(
                f"S {S} (SP {SP}, geometry {geo[0]} / {geo[1]}), T {T}",
                inputs, merge))
        if merge:
            inputs = ctc_case_inputs(rng, ctc_long_rows(rng), CTC_LONG_T,
                                     DEVICE)
            SP = ctc.padded_states(CTC_LONG_LABEL, True)
            h = compare_ctc(
                f"label {CTC_LONG_LABEL} (S {2 * CTC_LONG_LABEL + 1}, SP {SP} "
                f"of MAX_SP {ctc.MAX_SP}, geometry "
                f"{ctc.launch_geometry(SP, True, True)[:3]}), T {CTC_LONG_T}",
                inputs, True)
            if not h["loss"][0] < 9e4:
                fail(f"ctc long label: loss {h['loss'][0]} is not feasible")
            checks.append(h)
        for h in checks:
            r["max_abs_err"] = max(r["max_abs_err"], h["max_abs_err"])
            r["grad_ulp"] = max(r["grad_ulp"], h["grad_ulp"])
    log(f"  ctc forward + backward at B {len(y)} T {TRAIN_WINDOW} [{gpu}]: "
        f"plain {res[False]['ms']:.3f} ms, merging {res[True]['ms']:.3f} ms, "
        f"F.ctc_loss {res[True]['library_ms']:.3f} ms (merging kernel / "
        f"library {res[True]['ms'] / res[True]['library_ms']:.3f}); latency "
        f"floor from the clocks (2 T x the alpha step's lse phase at "
        f"{mhz:.0f} MHz): plain {res[False]['latency_floor_ms']:.3f} ms, "
        f"merging {res[True]['latency_floor_ms']:.3f} ms")
    log(f"phase 15a ctc [{gpu}]: the kernels equal to the plain version on "
        "both variants")
    return res


def params_of(net):
    return {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}


def train_step_card_vs_cpu(batch):
    """Phase 15(c): one ``train_step`` from the same weights on the same
    windows, on the card and on the CPU. Returns the numbers the gate
    reads: the losses and their relative difference, the largest gradient
    difference relative to its tensor's largest gradient, the largest
    parameter difference where the gradient is resolved, the count of
    parameters where it is not and their largest difference, and the CPU's
    seconds."""
    import torch
    from poreover_tpu_torch.network.model import (
        PoreOverNet, init_params, params_from_flax,
    )
    from poreover_tpu_torch.network.train import (
        make_optimizer, to_device, train_step,
    )

    tree = init_params(seed=5, **TRAIN_WIDTH)
    out = []
    for dev in (torch.device(DEVICE), torch.device("cpu")):
        net = PoreOverNet(**TRAIN_WIDTH)
        net.load_state_dict(params_from_flax(tree, TRAIN_WIDTH["arch"]))
        net = net.to(dev).train()
        opt = make_optimizer(net, TRAIN_LR)
        t0 = time.perf_counter()
        loss = float(train_step(net, opt, *to_device(*batch, dev)))
        secs = time.perf_counter() - t0
        out.append((loss, {k: (p.grad.detach().cpu().numpy(),
                               p.detach().cpu().numpy())
                           for k, p in net.named_parameters()}, secs))
    (lc, card, _), (lh, cpu, cpu_s) = out
    r = {"loss_card": lc, "loss_cpu": lh, "loss_rel": abs(lc - lh) / abs(lh),
         "grad_rel": 0.0, "param_abs": 0.0, "unresolved": 0,
         "unresolved_abs": 0.0, "params": 0, "cpu_s": cpu_s}
    for k, (gh, ph) in cpu.items():
        gc, pc = card[k]
        scale = float(np.abs(gh).max())
        r["grad_rel"] = max(r["grad_rel"],
                            float(np.abs(gc - gh).max()) / scale)
        res = np.abs(gh) >= TRAIN_GRAD_FLOOR * scale
        d = np.abs(pc - ph)
        r["params"] += d.size
        r["param_abs"] = max(r["param_abs"], float(d[res].max(initial=0)))
        r["unresolved"] += int((~res).sum())
        r["unresolved_abs"] = max(r["unresolved_abs"],
                                  float(d[~res].max(initial=0)))
    return r


def check_train_step(r):
    log(f"  15c one train_step on {TRAIN_STEP_WINDOWS} windows, card against "
        f"CPU: loss {r['loss_card']:.6f} / {r['loss_cpu']:.6f} (relative "
        f"{r['loss_rel']:.3g}, tolerance {TRAIN_LOSS_RTOL}); gradient "
        f"{r['grad_rel']:.3g} of each tensor's largest (tolerance "
        f"{TRAIN_GRAD_RTOL}); updated parameters {r['param_abs']:.3g} where "
        f"|g| >= {TRAIN_GRAD_FLOOR} of the tensor's largest (tolerance "
        f"{TRAIN_PARAM_ATOL}); {r['unresolved']} of {r['params']} "
        f"parameters below that, {r['unresolved_abs']:.3g} apart (bound "
        f"{2 * TRAIN_LR}); the CPU's step {r['cpu_s']:.1f} s")
    if not (r["loss_rel"] <= TRAIN_LOSS_RTOL
            and r["grad_rel"] <= TRAIN_GRAD_RTOL
            and r["param_abs"] <= TRAIN_PARAM_ATOL
            and r["unresolved_abs"] <= 2 * TRAIN_LR):
        fail(f"train_step: the card's step differs from the CPU's: {r}")


def step_breakdown(batch, reps=5):
    """Phase 15(d): one train step at full width split by CUDA events:
    upload, forward, log-softmax, CTC alpha (with the mean), CTC gradient,
    the network's backward (log-softmax's included), Adam. Returns ms per
    part (mean of ``reps`` steps after a warm-up)."""
    import torch
    from poreover_tpu_torch.network.model import (
        PoreOverNet, init_params, params_from_flax,
    )
    from poreover_tpu_torch.network.train import make_optimizer, to_device
    from poreover_tpu_torch.ops import ctc

    dev = torch.device(DEVICE)
    net = PoreOverNet(**TRAIN_WIDTH)
    net.load_state_dict(params_from_flax(init_params(seed=5, **TRAIN_WIDTH),
                                         TRAIN_WIDTH["arch"]))
    net = net.to(dev).train()
    opt = make_optimizer(net, TRAIN_LR)
    parts = ("upload", "forward", "log_softmax", "ctc_alpha", "ctc_grad",
             "backward", "adam")
    sums = dict.fromkeys(parts, 0.0)
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        ev[0].record()
        X, y, ylen = to_device(*batch, dev)
        ev[1].record()
        logits = net(X)
        ev[2].record()
        logp = ctc.log_softmax(logits).contiguous()
        ev[3].record()
        T = logp.shape[1]
        nll = ctc.ctc_cuda(logp, y, ylen, torch.full_like(ylen, T), False)
        loss = nll.mean()
        ev[4].record()
        g_logp, = torch.autograd.grad(loss, logp, retain_graph=True)
        ev[5].record()
        logp.backward(g_logp)
        ev[6].record()
        opt.step()
        opt.zero_grad(set_to_none=True)
        ev[7].record()
        torch.cuda.synchronize()
        if rep:
            for i, p in enumerate(parts):
                sums[p] += ev[i].elapsed_time(ev[i + 1]) / reps
    return sums


def train_phase(gpu):
    """Phase 15(b)-(e): ``train`` through the CLI at full width on the
    seeded windows, the card's step against the CPU's, the step's
    breakdown, and ``call`` from the trained run directory."""
    import torch
    from poreover_tpu_torch.cli import build_parser
    from poreover_tpu_torch.cli import main as cli_main
    from poreover_tpu_torch.io.fast5 import scale_signal
    from poreover_tpu_torch.network import call as nc
    from poreover_tpu_torch.network.checkpoint import load_params
    from poreover_tpu_torch.network.model import PoreOverNet
    from poreover_tpu_torch.ops import ctc
    from poreover_tpu_torch.sim import synth_raw_signal, synth_training_windows

    res = {}
    n = TRAIN_BATCH * TRAIN_BATCHES
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        npz = os.path.join(d, "training.npz")
        np.savez(npz, **synth_training_windows(np.random.default_rng(3), n,
                                               TRAIN_WINDOW))
        zero_counts()
        os.chdir(d)
        try:
            t0 = time.perf_counter()
            cli_main(["train", "--data", npz, "--name", "smoke",
                      "--model", TRAIN_WIDTH["arch"],
                      "--num_neurons", str(TRAIN_WIDTH["num_neurons"]),
                      "--kernel_size", str(TRAIN_WIDTH["kernel_size"]),
                      "--filters", str(TRAIN_WIDTH["filters"]),
                      "--batch_size", str(TRAIN_BATCH), "--save_every", "20",
                      "--loss_every", "5", "--seed", "3"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        res["launches"] = (ctc.launch_count, ctc.grad_launch_count)
        runs = [r for r in os.listdir(d) if r.startswith("conv1_bigru3_smoke")]
        if len(runs) != 1:
            fail(f"train: expected one run directory, found {runs}")
        run = os.path.join(d, runs[0])
        have = set(os.listdir(run))
        need = {"checkpoint-0", "checkpoint-1", "final", "model.json",
                "metrics.jsonl", "train.log"}
        if not need <= have or "checkpoint-2" in have:
            fail(f"train: the run directory holds {sorted(have)}")
        metrics = [json.loads(x) for x in open(os.path.join(
            run, "metrics.jsonl")).read().splitlines()]
        losses = [m["loss"] for m in metrics if "loss" in m]
        steps = [m["step"] for m in metrics if "loss" in m]
        elapsed = [m["elapsed_s"] for m in metrics if "loss" in m]
        eds = [(m["step"], m["test_edit_distance"]) for m in metrics
               if "test_edit_distance" in m]
        log(f"phase 15b train [{gpu}]: {n} windows of {TRAIN_WINDOW}, "
            f"{TRAIN_WIDTH['arch']} at {TRAIN_WIDTH['filters']} / "
            f"{TRAIN_WIDTH['kernel_size']} / {TRAIN_WIDTH['num_neurons']}, "
            f"batch {TRAIN_BATCH}, 40 steps in "
            f"{wall:.2f} s through the CLI (checkpoints and validation "
            f"included); ctc launches {res['launches'][0]} alpha + "
            f"{res['launches'][1]} gradient; loss at steps {steps}: "
            + " ".join(f"{x:.3f}" for x in losses)
            + f"; seconds since the loop began at those steps {elapsed}"
            + "; validation edit distance (step, value): "
            + " ".join(f"({s}, {e:.4f})" for s, e in eds))
        if min(res["launches"]) < 40:
            fail(f"train: the CTC kernels launched {res['launches']} times in "
                 "40 steps")
        if (len(losses) != 8 or not all(np.isfinite(losses))
                or not losses[-1] < losses[0] or len(eds) != 2
                or not all(np.isfinite([e for _, e in eds]))):
            fail(f"train: losses {losses}, edit distances {eds}")
        res["wall_s"] = wall
        res["elapsed_s"] = elapsed
        res["losses"] = losses
        res["edit_distance"] = eds

        # (e) call from the trained run directory on two of phase 13's
        # signals (the same seed), below the FAST5 reader
        rng = np.random.default_rng(31)
        raws = [synth_raw_signal(rng, int(rng.integers(*CALL_SAMPLES)))
                for _ in range(2)]
        out = os.path.join(d, "probs")
        os.makedirs(out)
        args = build_parser().parse_args(
            ["call", d, "--weights", run, "--model",
             os.path.join(run, "model.json"), "--dir", out])
        dev = torch.device(DEVICE)
        net = nc.load_model(args, dev)
        fwd = nc.make_forward(net, dev)
        signals = [scale_signal(raw) for raw in raws]
        for i, sig in enumerate(signals):
            nc.call_signal(args, fwd, sig, f"c{i}")
        probs = [np.load(os.path.join(out, f"c{i}.npy")) for i in range(2)]
        direct = PoreOverNet(**TRAIN_WIDTH)
        direct.load_state_dict(load_params(os.path.join(run, "checkpoint-1")))
        sd_equal = all(torch.equal(a.cpu(), b) for a, b in zip(
            net.state_dict().values(), direct.state_dict().values()))
        if (not sd_equal
                or [len(p) for p in probs] != [len(x) for x in signals]
                or not all(np.all(np.isfinite(p)) for p in probs)):
            fail("call --weights <run dir>: wrong weights or probabilities")
        log(f"  15e call --weights <run dir> --model <run dir>/model.json: "
            f"the newest checkpoint (checkpoint-1) loaded; 2 signals of "
            f"{[len(x) for x in signals]} samples, probabilities finite")

    r = train_step_card_vs_cpu(train_windows(TRAIN_STEP_WINDOWS, seed=9))
    check_train_step(r)
    res["card_vs_cpu"] = r

    big = train_windows(TRAIN_BATCH, seed=10)
    parts = step_breakdown(big)
    step_ms = sum(parts.values())
    log(f"  15d train step at full width, batch {TRAIN_BATCH} [{gpu}]: "
        f"{step_ms:.2f} ms ({TRAIN_BATCH / step_ms * 1e3:.0f} samples/s, "
        f"{1e3 / step_ms:.2f} steps/s): "
        + " ".join(f"{k}={v:.3f}" for k, v in parts.items()) + " ms")
    res["step_ms"] = step_ms
    res["parts_ms"] = parts
    log(f"phase 15 [{gpu}]: train done")
    return res


def benchmark_csv(path):
    """(mapped, records, mean identity of the mapped) of a
    ``.benchmark.csv``; fails if it is missing or an identity is outside
    (0, 1]."""
    import csv

    if not os.path.exists(path):
        fail(f"benchmark: {path} was not written")
    with open(path) as f:
        rows = list(csv.DictReader(f))
    ids = [float(r["identity"]) for r in rows if r["mapped"] == "1"]
    if not all(0.0 < x <= 1.0 for x in ids):
        fail(f"benchmark: {path} holds identities {ids}")
    return len(ids), len(rows), float(np.mean(ids)) if ids else float("nan")


def benchmark_phase(gpu, keep, truth3, truth6):
    """Phase 16: ``benchmark --fasta_pair`` on phase 3's FASTA files (16
    1D calls, 8 consensi) against the 8 simulated templates, and
    ``benchmark --fasta`` on phase 6's 32 Viterbi calls against their 32
    true sequences (host code). Gates: every file's CSV holds a row per
    record; phase 6's calls (identity >= IDENTITY_FLOOR, few insertions)
    all map. Phase 3's records are mapped as far as the built-in k-mer
    aligner finds them: the argmax calls of the simulator's noisy reads
    carry ~18% inserted bases, which spread the aligner's diagonal votes
    (ROADMAP §C); the counts are printed."""
    from poreover_tpu_torch.cli import main as cli_main

    def reference(name, seqs):
        path = os.path.join(keep, name)
        with open(path, "w") as f:
            f.writelines(f">t{i}\n{t}\n" for i, t in enumerate(seqs))
        return path

    t0 = time.perf_counter()
    cli_main(["benchmark", "--fasta_pair", os.path.join(keep, "out"),
              "--reference", reference("ref3.fasta", truth3)])
    wall = time.perf_counter() - t0
    counts = {k: benchmark_csv(os.path.join(keep, f"out.{k}.benchmark.csv"))
              for k in ("1d", "2d")}
    t0 = time.perf_counter()
    cli_main(["benchmark", "--fasta", os.path.join(keep, "vit.fasta"),
              "--reference", reference("ref6.fasta", truth6)])
    wall6 = time.perf_counter() - t0
    counts["decode"] = benchmark_csv(os.path.join(keep, "vit.benchmark.csv"))
    log(f"phase 16 benchmark (host code): --fasta_pair of phase 3 "
        f"{wall:.2f} s, --fasta of phase 6 {wall6:.2f} s; mapped "
        + ", ".join(f"{k}: {m}/{n} (mean identity {i:.4f})"
                    for k, (m, n, i) in counts.items()))
    if counts["2d"][1] != 8 or counts["1d"][1] != 16:
        fail(f"benchmark: expected 8 consensus and 16 1D rows: {counts}")
    if counts["decode"][:2] != (32, 32):
        fail(f"benchmark: phase 6's Viterbi calls not all mapped: {counts}")
    return wall, counts


def exact_kernel_cases(full_pairs):
    """Phase 17(a): the graveyard instance of each kind against the plain
    graveyard engine on the card (``compare``: provenance, scores bits,
    validity): tests/test_exact.py's cases at EXACT_GRACES (CTC) or the
    first and last of them, with the storage in shared memory and in
    global scratch; the same cases on plans that step back
    (EXACT_STUTTER); the first EXACT_PLAIN_STEPS steps of ``full_pairs``
    (two full-size pairs per kind) at their full storage widths. Fails
    unless the runs turned rows away from a full graveyard, resumed
    graveyard rows, and resumed one that had moved back while buried
    (the plain version's GY_COUNTS). Returns per kind its stats, with
    (kernel ms, plain ms, bound ms) of the truncated pairs."""
    from poreover_tpu_torch.ops.beam2d_planned import (
        EXACT_G, GY_COUNTS, build_plan, pack_pairs, plan_wst,
    )
    from poreover_tpu_torch.sim import exact_style_cases, stuttered

    out = {}
    for kind in ("poreover", "bonito", "flipflop"):
        model = KIND_MODEL[kind]
        stats = {"max_abs_err": 0.0}
        cs = exact_style_cases(8 if kind == "flipflop" else 5)
        graces = EXACT_GRACES if kind == "poreover" else (
            EXACT_GRACES[0], EXACT_GRACES[-1])
        for g in graces:
            compare(f"{kind} exact: cases B=3, grace {g}",
                    upload(pack_pairs(cs, model=model, G=EXACT_G)), stats,
                    also_global=g == graces[-1], grace=g)
        pl, ws = stuttered(cs, *EXACT_STUTTER)
        compare(f"{kind} exact: cases B=3, plans stepping back",
                upload(pack_pairs(cs, model=model, G=EXACT_G, plans=pl,
                                  wst=ws)), stats)
        plans = [build_plan(env, len(y1), len(y2))
                 for y1, y2, env in full_pairs[kind]]
        short = upload(pack_pairs(
            full_pairs[kind], model=model, G=EXACT_G,
            plans=[{k: v[:EXACT_PLAIN_STEPS] for k, v in p.items()}
                   for p in plans], wst=[plan_wst(p) for p in plans]))
        t_k, t_p = compare(f"{kind} exact: two full-size pairs, first "
                           f"{EXACT_PLAIN_STEPS} steps", short, stats)
        stats["short"] = (t_k, t_p, bound_ms(short)[0])
        log(f"  {kind} exact, the plain version's counts over these runs: "
            + ", ".join(f"{c} {stats[c]}" for c in GY_COUNTS))
        if not stats["gfull"] or not stats["gresume"]:
            fail(f"{kind} exact: no row turned away from a full graveyard "
                 "or no graveyard row resumed")
        out[kind] = stats
    if not sum(st["gresume_back"] for st in out.values()):
        fail("exact: no graveyard row resumed after a backward re-anchor")
    return out


def exact_phase(gpu, kstats, cons_windowed):
    """Phase 17: exact mode (``pair-decode --exact``) at full size, after
    ``exact_kernel_cases`` (``kstats``). (b) phase 3's 8 CTC pairs through
    the CLI with ``--exact``: 8 records, the graveyard instance launched
    and the windowed one not; the wave's kernel time by CUDA events; each
    consensus beside the reference's unbounded trie
    (``native.pair_beam_row_col_cpu``, f64 on the host, one thread per
    pair): ``trie_match``, every identity >= EXACT_TRIE_FLOOR and >= that
    of phase 3's windowed consensus (``cons_windowed``) to the trie; pair
    0 through the single-pair entry byte-identical to its string in the
    wave. (c) the same pairs with ``--exact --skip_matches``: 8 records,
    no box-kernel launch, the exact box waves' launches and time. (d) 8
    bonito and 8 flip-flop pairs (phase 10's) with ``--exact``: 8 records
    each, the wave's kernel time. Returns the graveyard instance's
    entries of the kernels line, one per kind."""
    from poreover_tpu_torch import native
    from poreover_tpu_torch.ops import box_beam as bb
    from poreover_tpu_torch.ops import pair_beam_batch as pbb
    from poreover_tpu_torch.sim import write_pairs

    entries = []
    for kind in ("poreover", "bonito", "flipflop"):
        model, bc = KIND_MODEL[kind], BASECALLER[kind]
        with tempfile.TemporaryDirectory() as d:
            pairs_txt, _ = write_pairs(d, 8, seed=7, lo=5200, hi=8200,
                                       kind=kind)
            zero_counts()
            cons, _, rows, t_e2e, tm = pair_decode_cli(d, pairs_txt, bc,
                                                       "exact", ["--exact"])
            launches, windowed = pbb.exact_launch_count, pbb.launch_count
            if len(cons) != 8 or any(r[-1] != "0" for r in rows):
                fail(f"{kind} --exact: {len(cons)} records, log rows {rows}")
            if launches < 1 or windowed:
                fail(f"{kind} --exact: {launches} graveyard-instance and "
                     f"{windowed} windowed launches")
            files = pair_files(pairs_txt)
            wave = [workload_of(d, r1, r2, kind) for r1, r2 in files]
            if kind == "poreover":
                zero_counts()
                anch, _, arows, t_anch, atm = pair_decode_cli(
                    d, pairs_txt, bc, "exact_anch",
                    ["--exact", "--skip_matches", "--skip_threshold", "10"])
                a_launches = pbb.exact_launch_count
                if len(anch) != 8 or any(r[-1] != "0" for r in arows) or \
                        bb.box_launch_count or a_launches < 1:
                    fail(f"--exact --skip_matches: {len(anch)} records, "
                         f"{bb.box_launch_count} box launches, {a_launches} "
                         f"exact launches, log rows {arows}")
        log(f"phase 17 {kind} pair-decode --exact: 8 full-size pairs, "
            f"{launches} graveyard-instance launch(es); end-to-end "
            f"{t_e2e:.2f} s ({8 / t_e2e:.2f} pairs/s); stages "
            + " ".join(f"{k}={v:.3f}s" for k, v in tm.items()))
        prep = pbb.prepare_pairs(wave, device=DEVICE, model=model,
                                 exact=True)
        steps = prep["meta"][:, 7]
        wave_ms = event_ms(lambda: pbb.launch_prepared(prep), reps=1)
        wave_bound, wave_by, wave_terms = bound_ms(prep)
        log(f"  [{gpu}] {kind} graveyard instance: {wave_ms:.1f} ms per "
            f"8-pair wave, {wave_ms * 1e3 / steps.max():.2f} us per step of "
            f"the longest plan (bound {wave_bound:.4f} ms, {wave_by}); "
            f"storage in {pbb.storage_path(prep)} memory; plan steps per "
            f"pair {steps.tolist()}")
        log(f"  bound terms: {wave_terms}")
        if kind == "poreover":
            t0 = time.perf_counter()
            tries = [None] * len(wave)

            def trie(i):
                tries[i] = native.pair_beam_row_col_cpu(*wave[i],
                                                        beam_width=5)

            ths = [threading.Thread(target=trie, args=(i,))
                   for i in range(len(wave))]
            for th in ths:
                th.start()
            for th in ths:
                th.join()
            ids = [identity(c, t) for c, t in zip(cons, tries)]
            match = sum(c == t for c, t in zip(cons, tries))
            wids = [identity(c, w) for c, w in zip(cons, cons_windowed)]
            wtids = [identity(w, t) for w, t in zip(cons_windowed, tries)]
            log(f"  trie_match {match}/8 (the unbounded trie, f64 on the "
                f"host, {time.perf_counter() - t0:.1f} s); identity to it "
                + " ".join(f"{x:.6f}" for x in ids)
                + f", lowest {min(ids):.6f}; phase 3's windowed consensus "
                "to it " + " ".join(f"{x:.6f}" for x in wtids)
                + "; exact equal to windowed "
                f"{sum(c == w for c, w in zip(cons, cons_windowed))}/8, "
                "identity " + " ".join(f"{x:.6f}" for x in wids))
            if not all(np.isfinite(ids)) or min(ids) < EXACT_TRIE_FLOOR:
                fail(f"--exact: identity {min(ids)} to the unbounded trie < "
                     f"{EXACT_TRIE_FLOOR}")
            worse = [i for i, (x, w) in enumerate(zip(ids, wtids)) if x < w]
            if worse:
                fail(f"--exact: pairs {worse} further from the unbounded "
                     "trie than their windowed consensus")
            one, one_ms = timed(lambda: pbb.pair_beam_single(
                *wave[0], exact=True))
            if one != cons[0]:
                fail("--exact: pair 0 through the single-pair entry differs "
                     "from its string in the wave")
            aids = [identity(a, c) for a, c in zip(anch, cons)]
            log(f"  pair 0 alone (single-pair entry, one CTA): equal to the "
                f"wave's string, {one_ms:.1f} ms with host prep, upload and "
                f"fetch")
            log(f"  --exact --skip_matches: 8 pairs, {a_launches} exact box "
                f"wave(s) (no box-kernel launch); end-to-end {t_anch:.2f} s; "
                f"consensus stage {atm.get('consensus_2d', float('nan')):.3f}"
                " s; identity to the --exact consensus: "
                + " ".join(f"{x:.4f}" for x in aids))
        st = kstats[kind]
        t_k, t_p, b_short = st["short"]
        entries.append({
            "name": "pair_beam_exact", "kinds": [model], "route": "cuda",
            "source": "poreover_tpu_torch/csrc/pair_beam_batch.cu",
            "replaces": "poreover_tpu/ops/beam2d_planned.py:405 "
                        "(_planned_scan with G > 0, an XLA scan, not a "
                        "Pallas kernel)",
            "launches": launches, "max_abs_err": st["max_abs_err"],
            "ms": wave_ms, "plain_ms": t_p, "bound_ms": wave_bound,
            "us_per_step": wave_ms * 1e3 / int(steps.max()),
            "bound_by": wave_by, "library_ms": None,
            "plain_input": f"two full-size pairs, first {EXACT_PLAIN_STEPS} "
                           "plan steps",
            "ms_on_plain_input": t_k, "bound_ms_on_plain_input": b_short,
        })
        del prep, wave
    return entries


def first_look_exact():
    """``--first-look exact``: phase 17 alone (a few minutes): the pair
    kernel's build and ptxas report, its ``cuda``-marked exact tests of
    tests/test_torch_kernel.py, ``exact_kernel_cases`` and
    ``exact_phase`` (phase 3's windowed consensus decoded first, for the
    comparison). Prints the kernels line, no result line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from poreover_tpu_torch import build, native
    from poreover_tpu_torch.ops import pair_beam_batch as pbb
    from poreover_tpu_torch.sim import write_pairs

    gpu = gpu_line()
    log(gpu)
    log(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    native.load()
    pbb.load_kernel()
    log(f"build {time.perf_counter() - t0:.1f} s")
    for line in build.ptxas_report("pair_beam_batch"):
        log(f"ptxas pair_beam_batch: {line}")
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-k", "exact", "-p", "no:cacheprovider",
         os.path.join(HERE, "tests", "test_torch_kernel.py")],
        capture_output=True, text=True, cwd=HERE)
    log(tests.stdout.strip().splitlines()[-1])
    if tests.returncode != 0:
        fail(f"the exact tests: {tests.stdout[-3000:]}{tests.stderr[-2000:]}")
    full = {kind: sim_workloads(2, seed=7, lo=5200, hi=8200, kind=kind)
            for kind in ("poreover", "bonito", "flipflop")}
    kstats = exact_kernel_cases(full)
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, _ = write_pairs(d, 8, seed=7, lo=5200, hi=8200)
        cons = pair_decode_cli(d, pairs_txt, "poreover", "w")[0]
    log(json.dumps({"kernels": exact_phase(gpu, kstats, cons)}))


def build_all():
    """Phase 1: the host runtime, the six kernels and their instrumented
    builds, and the latency probe (``csrc/latency.cu``), one compiler
    process each, in parallel; prints the compiler's register / spill
    report."""
    from poreover_tpu_torch import build, native
    from poreover_tpu_torch.ops import acceptor as ta
    from poreover_tpu_torch.ops import beam1d
    from poreover_tpu_torch.ops import box_beam as bb
    from poreover_tpu_torch.ops import ctc
    from poreover_tpu_torch.ops import pair_beam_batch as pbb
    from poreover_tpu_torch.ops import viterbi as tv

    t0 = time.perf_counter()
    errs = []

    def run(fn):
        try:
            fn()
        except Exception as exc:  # reported below; the phase fails
            errs.append(exc)

    ths = [threading.Thread(target=run, args=(f,))
           for f in (native.load, pbb.load_kernel, beam1d.load_kernel,
                     bb.load_kernel, tv.load_kernel, ta.load_kernel,
                     ctc.load_kernel,
                     lambda: ctc.load_kernel(True),
                     lambda: pbb.load_kernel(True),
                     lambda: bb.load_kernel(True),
                     lambda: beam1d.load_kernel(True),
                     lambda: tv.load_kernel(True),
                     lambda: ta.load_kernel(True),
                     lambda: build.build_kernel("latency"))]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    if errs:
        fail(f"build: {errs[0]}")
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s")
    for kernel in ("pair_beam_batch", "beam1d", "box_beam", "viterbi",
                   "acceptor", "ctc"):
        for line in build.ptxas_report(kernel):
            log(f"  ptxas {kernel}: {line}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(HERE, "poreover_tpu_torch")):
        fail("poreover_tpu_torch/ is not beside this script")
    sys.path.insert(0, HERE)
    from poreover_tpu_torch import native
    from poreover_tpu_torch.ops import beam1d
    from poreover_tpu_torch.ops import box_beam as bb
    from poreover_tpu_torch.ops import pair_beam_batch as pbb

    t_start = time.perf_counter()
    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    build_all()

    # ---- phase 2: kernels vs plain versions on the card
    from poreover_tpu_torch.ops.beam2d_planned import (
        build_plan, pack_pairs, plan_wst,
    )

    stats = {"max_abs_err": 0.0}
    cs = pallas_cases()
    batches = [(f"case{i}", [c]) for i, c in enumerate(cs)]
    real = boxes()
    batches += [("cases B=4", cs[:4]), ("cases B=8", (cs * 2)[:8]),
                (f"boxes.npz, the {len(real)} with plans of <= "
                 f"{REAL_BOX_STEPS} steps", real),
                ("sim pairs ~300 bases B=2",
                 sim_workloads(2, seed=3, lo=280, hi=320))]
    for name, batch in batches:
        compare(name, upload(pack_pairs(batch)), stats)
    log(f"  pair kernel sweeps in phase 2: {stats['narrow']} on the narrow "
        f"path (<= {pbb.NARROW_MAX} columns), {stats['general']} on the "
        "general path, counted from the plans")
    if not stats["narrow"] or not stats["general"]:
        fail("phase 2 does not exercise both sweep paths of the pair kernel")

    stats1d = {"max_abs_err": 0.0}
    beam1d_cases(stats1d)
    log(f"  1D hash sizes taken: "
        f"{sorted(1 << b for b in stats1d['hash_bits'])} buckets")
    if len(stats1d["hash_bits"]) < 2:
        fail("phase 2 does not exercise more than one 1D hash size")
    stats_box = {"max_abs_err": 0.0}
    _, _, _, prep24 = compare_boxes("box beam, boxes.npz", real,
                                    stats_box, few_ctas=FEW_CTAS)
    if not prep24["overflow"]:
        fail("no box of boxes.npz is over the storage limit: the reroute "
             "is not exercised")
    log(f"  the boxes over the limit {prep24['overflow']} went through the "
        "pair kernel in 'boxes.npz' above, equal to their plain version")
    del prep24
    kstats = {k: {"max_abs_err": 0.0} for k in ("bonito", "flipflop")}
    kstats_box = {k: {"max_abs_err": 0.0} for k in ("bonito", "flipflop")}
    pair_kinds_phase2(kstats, kstats_box)
    compare_viterbi()
    compare_acceptor_cases()
    log(f"phase 2 done: {time.perf_counter() - t_start:.0f} s elapsed")

    # ---- phase 3: pair-decode at full size, through the CLI
    from poreover_tpu_torch.cli import main as cli_main
    from poreover_tpu_torch.sim import (
        ctc_log_likelihood, write_pairs, write_reads,
    )
    from poreover_tpu_torch.utils.timers import timers

    with tempfile.TemporaryDirectory() as d:
        pairs_txt, truth3 = write_pairs(d, 8, seed=7, lo=5200, hi=8200)
        out = os.path.join(d, "out")
        pbb.launch_count = 0
        t0 = time.perf_counter()
        cli_main(["pair-decode", pairs_txt, "--dir", d, "--basecaller",
                  "poreover", "--reverse_complement", "--threads", "8",
                  "--out", out])
        torch.cuda.synchronize()
        t_e2e = time.perf_counter() - t0
        launches = pbb.launch_count
        t_cons = timers.seconds.get("consensus_2d", float("nan"))
        if launches < 1:
            fail("pair-decode launched pair_beam_batch no time")
        recs = open(out + ".2d.fasta").read().split(">")[1:]
        rows = [r.split("\t") for r in open(out + ".log").read().splitlines()
                if not r.startswith("#")]
        if len(recs) != 8 or any(r[-1] != "0" for r in rows):
            fail(f"expected 8 consensus records and no skips; got "
                 f"{len(recs)} records, log rows {rows}")
        cons_full = ["".join(r.splitlines()[1:]) for r in recs]
        cons0 = cons_full[0]
        # phase 16 scores these FASTA files with ``benchmark``
        keep = tempfile.mkdtemp()
        for kind in ("1d", "2d"):
            shutil.copy(f"{out}.{kind}.fasta", os.path.join(
                keep, f"out.{kind}.fasta"))
        log(f"phase 3 pair-decode: 8 pairs, {launches} launch(es), "
            f"end-to-end {t_e2e:.2f} s, consensus stage {t_cons:.2f} s")
        wave = [workload_of(d, f"s{i}_1.npy", f"s{i}_2.npy")
                for i in range(8)]
    t0 = time.perf_counter()
    oracle = native.pair_beam_row_col_cpu_emul(*wave[0], beam_width=5)
    ident = identity(cons0, oracle)
    log(f"  pair 0: consensus {len(cons0)} bases, f64 oracle "
        f"{len(oracle)} bases ({time.perf_counter() - t0:.1f} s), aligned "
        f"identity {ident:.6f}")
    if not np.isfinite(ident) or ident < 0.999:
        fail(f"pair 0 identity {ident} to the f64 oracle < 0.999")

    # ---- phase 4: the single-pair entry
    from poreover_tpu_torch.ops.beam2d import beam_search_2d
    from poreover_tpu_torch.ops.beam2d_planned import beam_search_2d_planned

    for i, (y1, y2, env) in enumerate(cs):
        got = beam_search_2d(y1, y2, env, beam_width=5, method="row_col")
        want = beam_search_2d_planned(y1, y2, env, beam_width=5)
        if got != want:
            fail(f"single-pair entry, case{i}: differs from the plain "
                 "version")
    pbb.single_launch_count = 0
    got, single_ms = timed(lambda: beam_search_2d(
        *wave[0], beam_width=5, method="row_col"))
    single_launches = pbb.single_launch_count
    if single_launches < 1:
        fail("the single-pair entry launched the kernel no time")
    if got != cons0:
        fail("single-pair entry: pair 0 at full size differs from the "
             "consensus pair-decode wrote")
    log(f"phase 4 single-pair entry: 5 cases equal to the plain version; "
        f"pair 0 at full size equal to pair-decode's consensus, "
        f"{single_launches} launch(es), {single_ms:.1f} ms with host "
        f"prep, upload and fetch")

    # ---- phase 5: timing of the pair kernel on phase 3's wave
    prep = pbb.prepare_pairs(wave, device=DEVICE)
    steps = prep["meta"][:, 7]
    wave_ms = event_ms(lambda: pbb.launch_prepared(prep), reps=2)
    wave_bound, wave_by, wave_terms = bound_ms(prep)
    log(f"phase 5 [{gpu}]: kernel {wave_ms:.1f} ms per 8-pair wave, "
        f"{wave_ms * 1e3 / steps.max():.2f} us per step of the longest plan "
        f"(bound {wave_bound:.4f} ms, {wave_by}); plan steps per pair "
        f"{steps.tolist()} (mean {steps.mean():.0f}); consensus "
        f"{8 / (wave_ms / 1e3):.2f} pairs/s (kernel), "
        f"{8 / t_cons:.2f} pairs/s (stage 4 wall); end-to-end "
        f"{8 / t_e2e:.2f} pairs/s")
    log(f"  bound terms: {wave_terms}")
    glob_ms = event_ms(lambda: pbb._launch(
        *prep["dev"], prep["meta"], prep["W"], prep["A"], in_smem=False),
        reps=2)
    log(f"  the same wave with the storage in global scratch (the path of "
        f"pairs over the shared-memory limit): {glob_ms:.1f} ms; in shared "
        f"memory {(1 - wave_ms / glob_ms):.1%} faster")
    prep1 = pbb.prepare_pairs(wave[:1], device=DEVICE)
    one_ms = event_ms(lambda: pbb.launch_prepared(prep1), reps=1)
    one_bound, one_by, one_terms = bound_ms(prep1)
    log(f"  pair 0 alone (one CTA): kernel {one_ms:.1f} ms, "
        f"{one_ms * 1e3 / steps[0]:.2f} us per step (bound "
        f"{one_bound:.4f} ms, {one_by}); {one_terms}")
    wave_steps, one_steps = int(steps.max()), int(steps[0])
    pair_breakdown("pair wave", pbb, lambda: pbb._launch(
        *prep["dev"], prep["meta"], prep["W"], prep["A"]))
    # the plain version is far too slow for the whole wave (~10 ms per
    # plan step), so both run the wave's first PLAIN_STEPS plan steps per
    # pair, at the full plans' storage widths
    plans = [build_plan(env, len(y1), len(y2)) for y1, y2, env in wave]

    def truncated(pairs, pls, n):
        return upload(pack_pairs(
            pairs, plans=[{k: v[:n] for k, v in p.items()} for p in pls],
            wst=[plan_wst(p) for p in pls]))

    short = truncated(wave, plans, PLAIN_STEPS)
    short_k, short_p = compare(f"pair wave, first {PLAIN_STEPS} steps",
                               short, stats)
    short_bound = bound_ms(short)[0]
    stats_single = {"max_abs_err": 0.0}
    short1 = truncated(wave[:1], plans[:1], PLAIN_STEPS_SINGLE)
    short1_k, short1_p = compare(
        f"pair 0 alone, first {PLAIN_STEPS_SINGLE} steps", short1,
        stats_single)
    short1_bound = bound_ms(short1)[0]
    full_ctc = wave[:2]  # phase 17 holds the graveyard instance on these
    del wave, prep, prep1, short, short1

    # ---- phase 6: decode at full size, through the CLI
    with tempfile.TemporaryDirectory() as d:
        truth = write_reads(d, 32, seed=11, lo=5200, hi=8200)
        beam1d.launch_count = 0
        recs, dec_wall, dec_timers = decode_cli(d, [d], "poreover", "beam",
                                                "beam")
        dec_launches = beam1d.launch_count
        if dec_launches < 1:
            fail("decode --algorithm beam launched beam1d no time")
        if sorted(recs) != sorted(f"r{i}" for i in range(32)):
            fail(f"expected 32 FASTA records, got {sorted(recs)}")
        idents = [identity(recs[f"r{i}"], truth[i]) for i in range(32)]
        log(f"phase 6 decode beam: 32 reads, {dec_launches} launch(es), "
            f"end-to-end {dec_wall:.2f} s ({32 / dec_wall:.2f} reads/s); "
            f"stages " + " ".join(f"{k}={v:.3f}s"
                                  for k, v in dec_timers.items()))
        log("  identity to the true sequences: "
            + " ".join(f"{x:.4f}" for x in idents))
        if not all(np.isfinite(idents)) or min(idents) < IDENTITY_FLOOR:
            fail(f"beam identity {min(idents)} < {IDENTITY_FLOOR}")
        vrecs, vit_wall, vit_timers = decode_cli(d, [d], "poreover",
                                                 "viterbi", "vit")
        shutil.copy(os.path.join(d, "vit.fasta"),
                    os.path.join(keep, "vit.fasta"))
        if sorted(vrecs) != sorted(recs):
            fail("decode --algorithm viterbi: records missing")
        videns = [identity(vrecs[f"r{i}"], truth[i]) for i in range(32)]
        log(f"  decode viterbi: end-to-end {vit_wall:.2f} s; stages "
            + " ".join(f"{k}={v:.3f}s" for k, v in vit_timers.items())
            + f"; identity min {min(videns):.4f} mean "
            f"{np.mean(videns):.4f} (beam mean {np.mean(idents):.4f})")
        if min(videns) < IDENTITY_FLOOR:
            fail(f"viterbi identity {min(videns)} < {IDENTITY_FLOOR}")
        from poreover_tpu_torch.io.trace import model_from_trace

        wave1d = [model_from_trace(os.path.join(d, f"r{i}.npy"),
                                   "poreover").log_prob for i in range(32)]
    # why the beam's identity is below Viterbi's: what its strings differ
    # by, and which string the read's own emissions make more likely
    n_ins, n_miss, n_sub = (sum(x) for x in zip(*(
        edits(recs[f"r{i}"], truth[i]) for i in range(32))))
    v_ins, v_miss, v_sub = (sum(x) for x in zip(*(
        edits(vrecs[f"r{i}"], truth[i]) for i in range(32))))
    log(f"  beam vs true sequences, 32 reads: {n_ins} inserted, {n_miss} "
        f"missing, {n_sub} substituted bases; viterbi: {v_ins} inserted, "
        f"{v_miss} missing, {v_sub} substituted")
    i = int(np.argmin([len(y) for y in wave1d]))
    t0 = time.perf_counter()
    ll = {k: ctc_log_likelihood(wave1d[i], q) for k, q in
          (("beam", recs[f"r{i}"]), ("viterbi", vrecs[f"r{i}"]),
           ("true", truth[i]))}
    log(f"  read r{i} ({len(wave1d[i])} steps): log-likelihood of the "
        f"beam's string {ll['beam']:.2f}, Viterbi's {ll['viterbi']:.2f}, "
        f"the true sequence's {ll['true']:.2f} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not ll["beam"] >= ll["viterbi"]:
        fail(f"read r{i}: the beam's string is less likely ({ll['beam']}) "
             f"than Viterbi's ({ll['viterbi']})")
    for kind, basecaller in (("bonito", "bonito"), ("flipflop", "flappie")):
        with tempfile.TemporaryDirectory() as d:
            truth4 = write_reads(d, N_CPU_READS, seed=5, lo=900, hi=1000,
                                 kind=kind)
            inputs = [d] if kind == "bonito" else [
                os.path.join(d, f"r{i}.csv") for i in range(N_CPU_READS)]
            for alg in ("beam", "viterbi"):
                beam1d.launch_count = 0
                on_card, t_card, tm = decode_cli(d, inputs, basecaller, alg,
                                                 f"{alg}_cuda")
                n_l = beam1d.launch_count
                if alg == "beam" and n_l < 1:
                    fail(f"decode {kind} beam launched beam1d no time")
                on_cpu, t_cpu, _ = decode_cli(d, inputs, basecaller, alg,
                                              f"{alg}_cpu", device="cpu")
                a = open(os.path.join(d, f"{alg}_cuda.fasta"), "rb").read()
                b = open(os.path.join(d, f"{alg}_cpu.fasta"), "rb").read()
                if a != b or len(on_card) != N_CPU_READS:
                    fail(f"decode {kind} {alg}: the card's FASTA differs "
                         "from --device cpu")
                ids = [identity(on_card[f"r{i}"], truth4[i])
                       for i in range(N_CPU_READS)]
                log(f"  decode {kind} {alg}: {N_CPU_READS} reads "
                    f"byte-identical to "
                    f"--device cpu; card {t_card:.2f} s ({n_l} beam1d "
                    f"launches; stages "
                    + " ".join(f"{k}={v:.3f}s" for k, v in tm.items())
                    + f"), cpu {t_cpu:.2f} s; identity min {min(ids):.4f}")
                if min(ids) < IDENTITY_FLOOR:
                    fail(f"{kind} {alg} identity {min(ids)} < "
                         f"{IDENTITY_FLOOR}")
    log(f"phase 6 done: {time.perf_counter() - t_start:.0f} s elapsed")

    # ---- phase 7: timing of the 1D kernel on phase 6's wave
    prep, b4_ms, b4_us, b4_bound, b4_by = beam1d_timing(wave1d, gpu)
    log(f"  decode end to end {32 / dec_wall:.2f} reads/s")
    # the plain version is slow (hundreds of small launches per step, ~2
    # ms per step of the wave): it holds the kernel on each read's first
    # BEAM1D_PLAIN_STEPS steps, every step of each; the kernel's strings of
    # the whole wave are the ones decode wrote
    short1d = beam1d.prepare_beam1d([y[:BEAM1D_PLAIN_STEPS] for y in wave1d],
                                    beam_width=25, device=DEVICE)
    _, b4_short_k, b4_plain_ms = compare_beam1d(
        f"decode wave, first {BEAM1D_PLAIN_STEPS} steps per read", short1d,
        stats1d)
    b4_short_bound = beam1d_bound_ms(short1d)[0]
    del short1d
    full1d = beam1d.fetch_beam1d(prep, beam1d.launch_beam1d(prep))
    for i, got in enumerate(full1d):
        if recs[f"r{i}"] != got:
            fail(f"decode's FASTA record r{i} differs from the kernel's "
                 "string")
    log("  the kernel's 32 strings of the whole wave equal the records "
        "decode wrote")
    b4_waves = beam1d_larger_waves(wave1d, prep)

    del wave1d, prep
    log(f"phase 7 done: {time.perf_counter() - t_start:.0f} s elapsed")

    # ---- phase 8: anchored pair-decode at full size, through the CLI
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, _ = write_pairs(d, 8, seed=7, lo=5200, hi=8200)
        anch = [anchored_boxes_of(d, f"s{i}_1.npy", f"s{i}_2.npy")
                for i in range(8)]
        log("phase 8 anchored pair-decode (--skip_matches --skip_threshold "
            "10): the simulated pairs' boxes")
        for i, (bxs, _, summ) in enumerate(anch):
            preps = [bb.prepare_box(*b) for b in bxs]
            n = np.array([q["n"] for q in preps if q is not None])
            log(f"  pair {i}: 1D identity {summ['sequence_identity']:.4f}, "
                f"{len(bxs) - 1} anchors, {len(bxs)} boxes, plan steps per "
                f"box median {np.median(n):.0f} p99 "
                f"{np.percentile(n, 99):.0f} max {n.max()} (sum {n.sum()}), "
                f"{sum(q is None for q in preps)} over the storage limit")
        out = os.path.join(d, "anch")
        bb.box_launch_count = 0
        pbb.launch_count = 0
        t0 = time.perf_counter()
        cli_main(["pair-decode", pairs_txt, "--dir", d, "--basecaller",
                  "poreover", "--reverse_complement", "--threads", "8",
                  "--skip_matches", "--skip_threshold", "10", "--out", out])
        torch.cuda.synchronize()
        t_anch = time.perf_counter() - t0
        box_launches, reroute_launches = bb.box_launch_count, pbb.launch_count
        anch_timers = dict(timers.seconds)
        if box_launches < 1:
            fail("pair-decode --skip_matches launched box_beam no time")
        recs = open(out + ".2d.fasta").read().split(">")[1:]
        rows = [r.split("\t") for r in open(out + ".log").read().splitlines()
                if not r.startswith("#")]
        if len(recs) != 8 or any(r[-1] != "0" for r in rows):
            fail(f"anchored: expected 8 consensus records and no skips; got "
                 f"{len(recs)} records, log rows {rows}")
        cons_anch = ["".join(r.splitlines()[1:]) for r in recs]
    n_boxes = sum(len(bxs) for bxs, _, _ in anch)
    log(f"  8 pairs, {n_boxes} boxes, {box_launches} box launch(es) "
        f"({n_boxes / box_launches:.0f} boxes per launch), "
        f"{reroute_launches} pair-kernel launch(es) for boxes over the "
        f"limit; end-to-end {t_anch:.2f} s ({8 / t_anch:.2f} pairs/s; "
        f"full envelope {8 / t_e2e:.2f}); stages "
        + " ".join(f"{k}={v:.3f}s" for k, v in anch_timers.items()))
    idents = [identity(a, f) for a, f in zip(cons_anch, cons_full)]
    log("  identity of the anchored to the full consensus, per pair: "
        + " ".join(f"{x:.4f}" for x in idents))
    if not all(np.isfinite(idents)) or min(idents) < ANCHORED_FLOOR:
        fail(f"anchored consensus identity {min(idents)} < {ANCHORED_FLOOR}")
    bxs0, stitch0, _ = anch[0]
    t0 = time.perf_counter()
    oracle = stitch0([
        native.pair_beam_row_col_cpu_emul(*b, beam_width=5)
        if len(b[0]) and len(b[1]) else "" for b in bxs0])
    ident = identity(cons_anch[0], oracle)
    log(f"  pair 0: anchored consensus {len(cons_anch[0])} bases; its "
        f"{len(bxs0)} boxes by the f64 oracle, stitched: {len(oracle)} "
        f"bases ({time.perf_counter() - t0:.1f} s), aligned identity "
        f"{ident:.6f}")
    if not np.isfinite(ident) or ident < 0.999:
        fail(f"pair 0 anchored identity {ident} to the f64 oracle < 0.999")
    short0 = [b for b in bxs0 if plan_steps(b) <= BOX_PLAIN_STEPS]
    _, box0_k, box0_p, prep0 = compare_boxes(
        f"box beam, pair 0's {len(short0)} boxes with plans of <= "
        f"{BOX_PLAIN_STEPS} steps", short0, stats_box)
    seqs0, over0 = bb.box_beam(bxs0, device=DEVICE)
    if over0 or stitch0(seqs0) != cons_anch[0]:
        fail("pair 0: the stitched box strings differ from the consensus "
             "pair-decode --skip_matches wrote")
    log(f"  pair 0: its {len(bxs0)} boxes through the box kernel, "
        "stitched: the consensus pair-decode --skip_matches wrote")
    box0_bound = bound_ms(prep0, out_bytes=4)[0]
    del prep0

    # ---- phase 9: timing of the box kernel on phase 8's wave
    all_boxes = [b for bxs, _, _ in anch for b in bxs]
    prep = bb.prepare_boxes(all_boxes, device=DEVICE)
    box_ms = event_ms(lambda: bb.launch_boxes(prep), reps=3)
    box_bound, box_by, box_terms = bound_ms(prep, out_bytes=4)
    bsteps = prep["meta"][:, 7]
    info = prep["info"]
    log(f"phase 9 [{gpu}]: box_beam {box_ms:.1f} ms per 8-pair anchored "
        f"wave: {len(bsteps)} boxes, {int(bsteps.sum())} plan steps (longest "
        f"box {int(bsteps.max())}), grid {info['grid']} CTAs x "
        f"{info['smem_bytes']} B storage; {box_ms * 1e3 / bsteps.max():.2f} "
        f"us per step of the longest box; the CTAs are busy "
        f"{bsteps.sum() / (info['grid'] * bsteps.max()):.1%} of the launch "
        f"(plan steps over grid x longest box); bound {box_bound:.4f} ms "
        f"({box_by}); consensus "
        f"{8 / (box_ms / 1e3):.2f} pairs/s (kernel), "
        f"{8 / anch_timers['consensus_2d']:.2f} pairs/s (stage 4 wall)")
    log(f"  bound terms: {box_terms}")
    box_steps = int(bsteps.max())
    pair_breakdown("anchored wave", bb, lambda: bb.box_beam_cuda(
        *prep["dev"], prep["meta"], prep["W"], prep["A"]))
    in_kernel = [all_boxes[i] for i in prep["order"]]
    as_pairs = pbb.prepare_pairs(in_kernel, device=DEVICE)
    as_pairs_ms = event_ms(lambda: pbb.launch_prepared(as_pairs), reps=2)
    log(f"  the same {len(in_kernel)} boxes through the pair kernel (one "
        f"CTA per box): {as_pairs_ms:.1f} ms")
    if prep["overflow"]:
        over = pbb.prepare_pairs([all_boxes[i] for i in prep["overflow"]],
                                 device=DEVICE)
        over_ms = event_ms(lambda: pbb.launch_prepared(over), reps=2)
        log(f"  the {len(prep['overflow'])} boxes over the limit through "
            f"the pair kernel: {over_ms:.1f} ms")
    else:
        log("  no box of this wave is over the storage limit")
    del prep, as_pairs, anch, all_boxes, in_kernel
    log(f"phase 9 done: {time.perf_counter() - t_start:.0f} s elapsed")

    # ---- phase 10: pair-decode for bonito and flip-flop at full size
    kind_entries = []
    for kind in ("bonito", "flipflop"):
        kind_entries += pair_kind_full(kind, gpu, kstats[kind],
                                       kstats_box[kind])
        log(f"phase 10 {kind} done: {time.perf_counter() - t_start:.0f} s "
            "elapsed")

    # ---- phase 11: a pairs file of mixed kinds
    mixed_pairs_file()

    # ---- phase 12: pair-decode --single beam at full size
    acc = single_beam_phase(gpu, truth3, cons_full)
    log(f"phase 12 done: {time.perf_counter() - t_start:.0f} s elapsed")

    # ---- phases 13-14: call at full width, then the fused decodes
    call_and_fused_phases(gpu)
    log(f"phase 14 done: {time.perf_counter() - t_start:.0f} s elapsed")

    # ---- phase 15: train at full width
    ctc_res = ctc_phase(gpu, train_windows(TRAIN_BATCH, seed=10))
    tr = train_phase(gpu)
    log(f"phase 15 done: {time.perf_counter() - t_start:.0f} s elapsed")

    # ---- phase 16: benchmark on phase 3's and phase 6's FASTA files
    benchmark_phase(gpu, keep, truth3, truth)
    shutil.rmtree(keep)

    # ---- phase 17: exact mode (pair-decode --exact) at full size
    full = {"poreover": full_ctc}
    for kind in ("bonito", "flipflop"):
        full[kind] = sim_workloads(2, seed=7, lo=5200, hi=8200, kind=kind)
    exact_entries = exact_phase(gpu, exact_kernel_cases(full), cons_full)
    del full, full_ctc
    log(f"phase 17 done: {time.perf_counter() - t_start:.0f} s elapsed")

    kernels = [{
        "name": "pair_beam_batch", "kinds": ["ctc"], "route": "cuda",
        "source": "poreover_tpu_torch/csrc/pair_beam_batch.cu",
        "replaces": "poreover_tpu/ops/pallas_pair_beam_batch.py:1169",
        "launches": launches, "max_abs_err": stats["max_abs_err"],
        "ms": wave_ms, "plain_ms": short_p, "bound_ms": wave_bound,
        "us_per_step": wave_ms * 1e3 / wave_steps,
        "bound_by": wave_by, "library_ms": None,
        "plain_input": f"pair wave, first {PLAIN_STEPS} plan steps per pair",
        "ms_on_plain_input": short_k, "bound_ms_on_plain_input": short_bound,
    }, {
        "name": "pair_beam_single", "kinds": ["ctc"], "route": "cuda",
        "source": "poreover_tpu_torch/csrc/pair_beam_batch.cu",
        "replaces": "poreover_tpu/ops/pallas_pair_beam.py:636",
        "launches": single_launches,
        "max_abs_err": stats_single["max_abs_err"],
        "ms": one_ms, "plain_ms": short1_p, "bound_ms": one_bound,
        "us_per_step": one_ms * 1e3 / one_steps,
        "bound_by": one_by, "library_ms": None,
        "plain_input": f"pair 0, first {PLAIN_STEPS_SINGLE} plan steps",
        "ms_on_plain_input": short1_k,
        "bound_ms_on_plain_input": short1_bound,
    }, {
        "name": "beam1d",
        "kinds": ["ctc", "ctc_merge_repeats", "ctc_flipflop"], "route": "cuda",
        "source": "poreover_tpu_torch/csrc/beam1d.cu",
        "replaces": "poreover_tpu/ops/pallas_beam1d.py:374",
        "launches": dec_launches, "max_abs_err": stats1d["max_abs_err"],
        "ms": b4_ms, "plain_ms": b4_plain_ms, "bound_ms": b4_bound,
        "us_per_step": b4_us,
        "ms_by_wave": {str(B): v[0] for B, v in b4_waves.items()},
        "hash_bits_by_wave": {str(B): v[1] for B, v in b4_waves.items()},
        "bound_by": b4_by, "library_ms": None,
        "plain_input": f"the decode wave, first {BEAM1D_PLAIN_STEPS} steps "
                       "per read",
        "ms_on_plain_input": b4_short_k,
        "bound_ms_on_plain_input": b4_short_bound,
    }, {
        "name": "box_beam", "kinds": ["ctc"], "route": "cuda",
        "source": "poreover_tpu_torch/csrc/box_beam.cu",
        "replaces": "poreover_tpu/ops/pallas_box_beam.py:1007",
        "launches": box_launches, "max_abs_err": stats_box["max_abs_err"],
        "ms": box_ms, "plain_ms": box0_p, "bound_ms": box_bound,
        "us_per_step": box_ms * 1e3 / box_steps,
        "bound_by": box_by, "library_ms": None,
        "plain_input": f"pair 0's boxes of the anchored wave with plans of "
                       f"<= {BOX_PLAIN_STEPS} steps",
        "ms_on_plain_input": box0_k, "bound_ms_on_plain_input": box0_bound,
    }] + kind_entries + [acc, {
        "name": "ctc", "kinds": ["plain", "merge_repeated"], "route": "cuda",
        "source": "poreover_tpu_torch/csrc/ctc.cu",
        "replaces": "poreover_tpu/ops/ctc.py:37 (a lax.scan, not a Pallas "
                    "kernel)",
        "launches": sum(tr["launches"]),
        "max_abs_err": max(r["max_abs_err"] for r in ctc_res.values()),
        "grad_ulp": max(r["grad_ulp"] for r in ctc_res.values()),
        "ms": ctc_res[False]["ms"], "alpha_ms": ctc_res[False]["alpha_ms"],
        "grad_ms": ctc_res[False]["grad_ms"],
        "plain_ms": ctc_res[False]["plain_ms"],
        "bound_ms": ctc_res[False]["bound_ms"],
        "bound_by": ctc_res[False]["bound_by"],
        "bound_ms_with_alpha": ctc_res[False]["bound_ms_with_alpha"],
        "bound_ms_with_design_traffic":
            ctc_res[False]["bound_ms_with_design_traffic"],
        "latency_floor_ms": ctc_res[False]["latency_floor_ms"],
        "library_ms": None,
        "merge_repeated": {k: ctc_res[True][k] for k in (
            "ms", "alpha_ms", "grad_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_ms_with_alpha", "bound_ms_with_design_traffic",
            "latency_floor_ms", "library_ms", "library_abs_diff",
            "library_rel_diff")},
        "input": f"one train step's batch: B {TRAIN_BATCH}, T "
                 f"{TRAIN_WINDOW}, labels of seeded windows",
        "train_step_ms": tr["step_ms"],
    }] + exact_entries
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def first_look():
    """``--first-look``: a short first check of the CTC kernels and the
    trainer's step on the card (a few minutes), before the whole run: the
    versions; the CTC kernels' build (normal and instrumented) and ptxas
    report; the ``cuda``-marked CTC tests of tests/test_torch_kernel.py;
    phase 15(a) (the kernels against ``ctc_plain`` at the trainer's shape,
    on the hand cases, the boundary state counts and the long label,
    timed, with the cycle breakdown); phase 15(c) (one train step, the
    card against the CPU) and 15(d) (the step's breakdown). Prints no
    result line."""
    import importlib.util

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from poreover_tpu_torch import build
    from poreover_tpu_torch.ops import ctc

    gpu = gpu_line()
    log(gpu)
    log(sys.version.split()[0], torch.__version__, torch.version.cuda,
        "h5py" if importlib.util.find_spec("h5py") else "no h5py")
    t0 = time.perf_counter()
    ths = [threading.Thread(target=ctc.load_kernel, args=(f,))
           for f in (False, True)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    ctc.load_kernel()
    ctc.load_kernel(True)
    log(f"ctc build {time.perf_counter() - t0:.1f} s")
    for line in build.ptxas_report("ctc"):
        log("ptxas", line)
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-k", "ctc", "-p", "no:cacheprovider",
         os.path.join(HERE, "tests", "test_torch_kernel.py")],
        capture_output=True, text=True, cwd=HERE)
    log(tests.stdout.strip().splitlines()[-1])
    if tests.returncode != 0:
        fail(f"the ctc tests: {tests.stdout[-3000:]}{tests.stderr[-2000:]}")
    ctc_phase(gpu, train_windows(TRAIN_BATCH, seed=10))
    check_train_step(train_step_card_vs_cpu(
        train_windows(TRAIN_STEP_WINDOWS, seed=9)))
    parts = step_breakdown(train_windows(TRAIN_BATCH, seed=10))
    log(f"train step {sum(parts.values()):.2f} ms: "
        + " ".join(f"{k}={v:.3f}" for k, v in parts.items()))


def first_look_dp():
    """``--first-look dp``: a short check of the Viterbi and acceptor
    kernels on the card (a few minutes): their builds (normal and
    instrumented) and ptxas report; their ``cuda``-marked tests of
    tests/test_torch_kernel.py; phase 2's cases (``compare_viterbi``,
    ``compare_acceptor_cases``); phase 10's flip-flop stage 1 on the 16
    full-size reads (``flipflop_stage1``) and phase 12's acceptor on pair 0
    with the 1D beam's labels (``acceptor_full_size``), timed, with the
    cycle breakdowns and latency floors and, with ``--parent``, the parent
    tree's kernels in turns. Prints no result line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from poreover_tpu_torch import build
    from poreover_tpu_torch.io.trace import model_from_trace
    from poreover_tpu_torch.models.transducer import beam_acceptor_batch
    from poreover_tpu_torch.ops import acceptor as ta
    from poreover_tpu_torch.ops import beam1d
    from poreover_tpu_torch.ops import viterbi as tv
    from poreover_tpu_torch.sim import write_pairs

    gpu = gpu_line()
    log(gpu)
    log(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    loads = [tv.load_kernel, ta.load_kernel, beam1d.load_kernel,
             lambda: tv.load_kernel(True), lambda: ta.load_kernel(True),
             lambda: build.build_kernel("latency")]
    if PARENT:
        loads += [parent_module("viterbi").load_kernel,
                  parent_module("acceptor").load_kernel]
    ths = [threading.Thread(target=f) for f in loads]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    for f in loads:  # raises here if a build failed in its thread
        f()
    log(f"build {time.perf_counter() - t0:.1f} s")
    for kernel in ("viterbi", "acceptor"):
        for line in build.ptxas_report(kernel):
            log(f"ptxas {kernel}: {line}")
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-k", "viterbi or acceptor", "-p", "no:cacheprovider",
         os.path.join(HERE, "tests", "test_torch_kernel.py")],
        capture_output=True, text=True, cwd=HERE)
    log(tests.stdout.strip().splitlines()[-1])
    if tests.returncode != 0:
        fail(f"the Viterbi / acceptor tests: {tests.stdout[-3000:]}"
             f"{tests.stderr[-2000:]}")
    compare_viterbi()
    compare_acceptor_cases()
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, _ = write_pairs(d, 8, seed=7, lo=5200, hi=8200,
                                   kind="flipflop")
        reads = pair_reads(d, pair_files(pairs_txt), "flappie")
    flipflop_stage1(reads, 0, gpu)
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, _ = write_pairs(d, 1, seed=7, lo=5200, hi=8200)
        r1, r2 = pair_files(pairs_txt)[0]
        ms = [model_from_trace(os.path.join(d, r), "poreover")
              for r in (r1, r2)]
    ms[1].reverse_complement()
    labels = [s for s, _ in beam_acceptor_batch(ms, device=DEVICE)]
    ys = [m.log_prob for m in ms]
    acceptor_full_size(ys, labels, gpu)


if __name__ == "__main__":
    argv = sys.argv[1:]
    if "--parent" in argv:  # a tree of the parent commit, whose Viterbi and
        # acceptor kernels phases 10 and 12 time in turns with this one's
        i = argv.index("--parent")
        PARENT = os.path.abspath(argv[i + 1])
        del argv[i:i + 2]
    if argv == ["--first-look"]:
        first_look()
    elif argv == ["--first-look", "exact"]:
        first_look_exact()
    elif argv == ["--first-look", "dp"]:
        first_look_dp()
    elif argv:
        fail(f"unknown arguments {argv}")
    else:
        main()
