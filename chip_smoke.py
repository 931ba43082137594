#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch/CUDA port's main paths (pair-decode,
decode and anchored pair-decode; pair-decode for all three model kinds;
pair-decode --single beam, --exact, --algorithm prefix,
--beam_search_method row and --method split|align; call and call
--decode; train; benchmark).

Run from a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each fails the run if it fails):
  1. build: the C++ host runtime (g++), the nine CUDA kernels (nvcc,
     sm_90a; the pair kernels with one template instance per model kind)
     and seven instrumented builds (``-DPOREOVER_PHASE_CLOCKS``), and the
     latency probe ``csrc/latency.cu`` (phases 10, 12 and 18), one process
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
     kinds the first and last), in each storage path (shared memory; the
     graveyard's in global scratch; all in global scratch); the same
     cases on plans that step back (EXACT_STUTTER) and that step back
     past the storage window (EXACT_WRAP, every storage path: live
     graveyard rows carried across the wrap of the JAX engine's shift and
     resumed after it); the first
     EXACT_PLAIN_STEPS steps of two full-size pairs (phase 3's; phase 10's
     for bonito and flip-flop), timed both; the plain version's counts
     must show rows turned away from a full graveyard, resumed graveyard
     rows, and a row resumed after it moved back while buried. (b) phase
     3's 8 pairs through the CLI with ``--exact`` (launch counts zeroed
     just before, read just after; the windowed instance must not run):
     8 records, each string's md5 the JAX exact engine's (EXACT_CTC_MD5);
     the wave's kernel time by CUDA events, us per step of the
     longest plan, bound, and its cycles per plan step by phase (the
     instrumented build; the graveyard's selection and burials apart, and
     their share); each consensus against the reference's
     unbounded trie (f64, on the host): ``trie_match k/8``, identities
     (gates: EXACT_TRIE_FLOOR, set from the runs, and each pair no further
     from the trie than its phase 3 windowed consensus); pair 0 through the
     single-pair entry equal to its string in the wave. (c) the same pairs
     with ``--exact --skip_matches``: 8 records, no box-kernel launch, the
     exact box waves' count and time. (d) phase 10's bonito and flip-flop
     pairs with ``--exact``: 8 records each, the wave's kernel time and
     cycles per plan step by phase.
 18. the pair prefix search (``pair-decode --algorithm prefix``). (a) the
     gamma kernel (``csrc/pair_gamma.cu``) and the level kernel
     (``csrc/pair_prefix.cu``) against their plain versions, bit for bit:
     boxes.npz's boxes the JAX search takes, and two full-size pairs (the
     DP's G on the last PREFIX_GAMMA_ROWS rows of each, and G and
     gamma(0,0) whole on each pair cut to its first PREFIX_GAMMA_ROWS
     rows; the search's first PREFIX_PLAIN_LEVELS levels: every level's
     outputs); (b) the 8 pairs
     through the CLI with ``--algorithm prefix``, and with
     ``--skip_matches`` (counts zeroed just before, read just after: both
     kernels launched; 8 records, no skip), levels per pair, and each
     consensus's identity to the truth beside the beam consensus's,
     recorded, not gated; (d) two small pairs byte-identical to
     ``--device cpu``; (e) the gamma kernel's time per 8-pair wave and the
     level kernel's per launch (the launch alone) over the wave's first
     PREFIX_TIMED_LEVELS levels, with their bounds, and the consensus
     stage's rest per level (and, with ``--parent``, the parent tree's
     level kernel timed in turns); the gamma kernel's launches of both
     runs (the wave, and the anchored run's searches of PREFIX_BOX_WAVE
     boxes): each launch's W and row widths, ms per launch of the
     instance the main path takes, the anchored boxes' last
     GAMMA_ANCHORED_PLAIN_ROWS rows bit-equal to the plain version, cycles
     per row by phase of the instrumented build on the wave and the first
     search, and the latency floor (``gamma_floor_ms``, from
     ``csrc/latency.cu``'s log-add-exp); (f) the gamma kernel at
     GAMMA_WIDTHS, bit for bit, each width through the instance it takes
     (``gamma_width_cases``).
 19. the by-row search (``pair-decode --beam_search_method row``, the
     kernel ``csrc/pair_row_beam.cu``; ``row_phase``). (a) phase 3's 8
     pairs through the CLI with ``--beam_search_method row``, then with
     ``--skip_matches --skip_threshold 10`` (counts zeroed just before,
     read just after: the by-row kernel launched; 8 records, no skip);
     pair 0 through the single-pair entry equal to the CLI's consensus.
     (b) the kernel on phase 3's wave and phase 10's bonito and flip-flop
     waves (their workloads kept from there), one launch each through the
     library entry: ms a wave, us a row, the bound (``row_bound_ms``) and
     a latency floor from ``csrc/latency.cu``'s log-add-exp
     (``row_floor_ms``); phase 8's anchored boxes in one launch, timed.
     (c) the kernel bit-equal to its plain version on the card (every
     row's beam_src, the traceback, final validity and score bits): each
     wave and the anchored boxes cut to their first ROW_PLAIN_ROWS rows,
     the CTC cut once more with its storage in global scratch, timed
     both. (d) two small pairs byte-identical to ``--device cpu`` (its run
     in a CPU worker). (e) each consensus's identity to the truth beside
     row_col's, recorded, not gated.
 20. the dense boxes of ``pair-decode --method split|align`` (each box
     decoded whole, by the by-row kernel or the gamma and level kernels;
     ``dense_phase``). (a) phase 3's 8 pairs with ``--method split`` and
     ``--method align``, each under ``--algorithm beam`` and ``prefix``;
     (b) phase 10's bonito and flip-flop pairs with each method under
     ``--algorithm beam`` (each run: counts zeroed just before, read just
     after, the path's kernels launched; 8 records, no skip); (c) in the
     card's workers during phase 2 (``dense_job``, one a kind, its boxes
     made once): the by-row kernel bit-equal to its plain version on pair
     0's first DENSE_SPLIT_BOXES split boxes whole (shared memory) and on
     the widest align box cut to its first DENSE_ROWS rows (global
     scratch), per kind; the gamma kernel's wide instance on dense CTC
     boxes and the level kernel on their search (every level's outputs):
     split and ~1000-wide align boxes (rows in shared memory under 48 KB),
     the widest align box cut to its first DENSE_PREFIX_ROWS rows (shared
     memory past 48 KB) and a split box at ``--window DENSE_WIDE_WINDOW``
     cut the same way (global scratch); (d) two
     small pairs with each method byte-identical to ``--device cpu``
     (runs in CPU workers); (e) the by-row kernel's ms per dense-box wave
     of each run and its storage path, the gamma kernel's ms over each
     prefix run's launches (CUDA events around each launch in the runs
     themselves), the level kernel's ms a launch on the widest align
     search, and each CTC consensus's identity to the truth beside phase
     3's, recorded, not gated.

``python3 chip_smoke.py --first-look`` runs only a short first check of
the CTC kernels and the train step (``first_look``), ``--first-look dp``
one of the Viterbi and acceptor kernels (``first_look_dp``: builds,
``cuda`` tests, phase 2's cases, phase 10's and 12's full-size timings,
clocks and latency floors), ``--first-look exact`` phase 17 alone
(``first_look_exact``: the pair kernel's build and ``cuda`` exact tests
first, ~4 minutes), ``--first-look prefix`` phase 18 alone
(``first_look_prefix``: the two kernels' builds and ``cuda`` tests
first, ~2 minutes), ``--first-look gamma`` the gamma kernel alone
(``first_look_gamma``: builds, ``cuda`` tests, phase 18(f), timings and
clocks of both instances, GAMMA_INSTANCES; ~1 minute), ``--first-look
row`` phase 19 alone (``first_look_row``: the by-row kernel's build and
``cuda`` tests, then ``row_phase`` on inputs made from the same seeds),
``--first-look split`` phase 20 alone (``first_look_split``: the by-row,
gamma and level kernels' builds and ``cuda`` tests on dense boxes, then
``dense_phase`` with its checks and CPU references in this process);
none prints a result. ``--parent DIR`` (a ``git
archive`` of the parent commit, unpacked) has phases 10, 12 and 18, or
``--first-look dp`` / ``prefix``, time that tree's Viterbi, acceptor and
prefix-level kernels in turns with this checkout's.

Worker processes: phase 2's checks, phase 17(a)'s graveyard cases and
phase 20(c)'s dense-box checks run in CARD_WORKERS processes that share
the card, started before the build (they reach the card meanwhile) and
stopped at the end of phase 2, while this process waits (nothing is
timed meanwhile: each number of the kernels line is taken here, alone on
the card). The CPU references (the ``--device cpu`` runs of phases 6, 10,
12, 18(d), 19(d) and 20(d), phase 16's ``benchmark`` and phase 17's trie)
run in CPU_WORKERS processes that see no card, beside the whole run, on
inputs made from the same seeds as the card's (their digests must
agree). A failure in a worker fails the run; every worker is stopped on
exit.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(each kernel instance with the model kinds it ran, and with
``us_per_step``; the acceptor with ``us_per_row``; the CTC kernels with
each pass's time and the merging variant's numbers), and as its last line
``{"ok":
true, "device": {...}}``. Exits non-zero, printing no result, without a
CUDA device or without the package beside it.
"""
from __future__ import annotations

import atexit
import contextlib
import hashlib
import io
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

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
# plans that step back further than the storage window: every 3rd step is
# followed by the step 20 before it, a backward move of more than Wst+1
# columns on tests/test_exact.py's cases, so that live graveyard rows take
# the wrap of the JAX engine's re-anchoring shift and are resumed after it
EXACT_WRAP = (3, 20)
EXACT_TRIE_FLOOR = 0.998
# md5 of each CTC --exact consensus of phase 3's wave (pairs 0-7), as the
# JAX package's exact engine decodes them (float32, on the CPU): the jax_md5
# of JAX_PLATFORMS=cpu python tools/exact_trie_check.py --port-exact 0 1 2 3
# 4 5 6 7
EXACT_CTC_MD5 = ("4d7a414024f7ffa2b6e25890f678813b",
                 "4e76d5448145144394450cd55d8c11bd",
                 "57863af2e2cce91aedae0e634c53f055",
                 "da64e5f78c4d774a36d68bed77e3b417",
                 "b80caa4c5356b7f530ccb2f1d22b5934",
                 "c8b42d80ab58d474c35495eededda110",
                 "e5c660f7191b4607fab4df4638abf225",
                 "5266b5d622d6d896dae44a76d691ade5")
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


T_START = time.perf_counter()


def done(what):
    log(f"{what} done: {time.perf_counter() - T_START:.0f} s elapsed")


class CheckFailed(Exception):
    """``fail`` in a worker process; the main process fails the run."""


def fail(msg):
    if WORKER:
        raise CheckFailed(msg)
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    stop_workers()
    sys.exit(1)


# ---- worker processes
# The plain versions are bound by the host (hundreds of small launches a
# step), and the CPU references (--device cpu runs, the host's f64 trie)
# by the host's cores. Phase 2's checks and phase 17's graveyard cases run
# in CARD_WORKERS processes that share the card while the main process
# waits (nothing is timed meanwhile, and they are stopped before phase 3);
# the CPU references run in CPU_WORKERS processes that see no card, beside
# the whole run, each on inputs made from the same seeds as the card's
# (their files' digests are compared). A plain version runs slower in a
# worker than alone, since the processes take turns on the card, so no
# number of the kernels line is taken in a worker; phase 2 logs the
# workers' summed job time beside its own.
CARD_WORKERS = 4
CPU_WORKERS = 2
CPU_WORKER_THREADS = 2
WORKER = None  # "card" or "cpu" in a worker process
_POOLS = {}


def _worker_init(kind):
    global WORKER
    WORKER = kind
    if kind == "cpu":
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch

    torch.set_num_threads(CPU_WORKER_THREADS if kind == "cpu" else 1)
    if kind == "card":
        torch.zeros(1, device=DEVICE)  # the context, while the main builds


def _run_job(name, args, kwargs):
    """One job in a worker: (ok, result or the failure, its output)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            out = True, globals()[name](*args, **kwargs)
    except CheckFailed as exc:
        out = False, str(exc)
    except Exception:  # the main process fails the run with it
        out = False, traceback.format_exc()
    return (*out, buf.getvalue(), time.perf_counter() - t0)


class Job:
    """A call of a function of this module in a worker process."""

    def __init__(self, where, fn, args, kwargs):
        self.name = fn.__name__
        self.res = _POOLS[where].apply_async(_run_job,
                                             (self.name, args, kwargs))

    def wait(self):
        """Blocks until the job is done; fails the run now if it failed."""
        ok, _, _, self.seconds = self.res.get()
        if not ok:
            self.result()

    def result(self):
        """The function's result, after its output; fails the run if it
        failed. ``self.seconds``: the job's time in its worker."""
        ok, out, text, self.seconds = self.res.get()
        if text:
            sys.stdout.write(text)
            sys.stdout.flush()
        if not ok:
            fail(f"{self.name} (in a worker process): {out}")
        return out


def start_workers(where, n):
    if not _POOLS:
        atexit.register(stop_workers)
    _POOLS[where] = multiprocessing.get_context("spawn").Pool(
        n, _worker_init, (where,))


def card_job(fn, *args, **kwargs) -> Job:
    return Job("card", fn, args, kwargs)


def cpu_job(fn, *args, **kwargs) -> Job:
    return Job("cpu", fn, args, kwargs)


def stop_workers(*which):
    for where in which or list(_POOLS):
        pool = _POOLS.pop(where, None)
        if pool is not None:
            pool.terminate()
            pool.join()


def merge_stats(into, more):
    """Adds a worker's stats dict (``compare`` and its kin) to ``into``:
    the largest error, the union of sets, the sum of counts."""
    for k, v in more.items():
        if k == "max_abs_err":
            into[k] = max(into.get(k, 0.0), v)
        elif isinstance(v, set):
            into.setdefault(k, set()).update(v)
        elif isinstance(v, (int, float)):
            into[k] = into.get(k, 0) + v
        else:
            into[k] = v
    return into


def digest(d, names) -> str:
    """md5 of the files ``names`` in ``d``, in order: the inputs a CPU
    reference and the card's run share."""
    h = hashlib.md5()
    for n in names:
        h.update(n.encode())
        h.update(open(os.path.join(d, n), "rb").read())
    return h.hexdigest()


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


def pack_truncated(pairs, n, model="ctc", G=0):
    """``pack_pairs`` of ``pairs`` with each plan cut to its first ``n``
    steps, at the full plans' storage widths."""
    from poreover_tpu_torch.ops.beam2d_planned import (
        build_plan, pack_pairs, plan_wst,
    )

    plans = [build_plan(env, len(y1), len(y2)) for y1, y2, env in pairs]
    return pack_pairs(pairs, model=model, G=G,
                      plans=[{k: v[:n] for k, v in p.items()} for p in plans],
                      wst=[plan_wst(p) for p in plans])


def upload(packed):
    """A packed batch (``pack_pairs``) with its tensors on the card."""
    import torch

    return dict(packed, dev=[torch.as_tensor(packed[k], device=DEVICE)
                             for k in ("planes1", "planes2", "plan", "meta")])


def compare(name, prep, stats, also_global=False, grace=None):
    """Kernel vs plain version on one packed batch, both on the card. With
    ``also_global`` the kernel runs again in each storage path that takes
    less shared memory than its own (``pbb.STORAGE_PATHS``: the graveyard
    instance's split path, then global scratch), and must give the same
    outputs. A batch packed
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
        paths = pbb.STORAGE_PATHS[pbb.STORAGE_PATHS.index(where[0]) + 1:]
        for path in paths if G else [p for p in paths if p != "split"]:
            kg = pbb._launch(*prep["dev"], prep["meta"], prep["W"],
                             prep["A"], storage=path, model_id=mid, G=G,
                             grace=grace)
            if not all(torch.equal(a.view(torch.int8), b.view(torch.int8))
                       for a, b in zip(k, kg)):
                fail(f"{name}: the kernel with its storage in the {path} "
                     f"path differs from its run in the {where[0]} path")
            where.append(path)
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
        f"{general} general; storage paths {', '.join(where)}) "
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


def pair_batches_job(which):
    """Phase 2's CTC pair batches, kernel vs plain version (``compare``):
    ``which`` "cases" (the five envelope cases of tests/test_pallas.py
    alone, then at B=4 and B=8), "boxes" (the boxes.npz boxes with plans of
    at most REAL_BOX_STEPS steps, one batch) or "sims" (two simulated
    pairs of ~300 bases). Returns the stats."""
    from poreover_tpu_torch.ops.beam2d_planned import pack_pairs

    if which == "cases":
        cs = pallas_cases()
        batches = [(f"case{i}", [c]) for i, c in enumerate(cs)]
        batches += [("cases B=4", cs[:4]), ("cases B=8", (cs * 2)[:8])]
    elif which == "boxes":
        real = boxes()
        batches = [(f"boxes.npz, the {len(real)} with plans of <= "
                    f"{REAL_BOX_STEPS} steps", real)]
    else:
        batches = [("sim pairs ~300 bases B=2",
                    sim_workloads(2, seed=3, lo=280, hi=320))]
    stats = {"max_abs_err": 0.0}
    for name, batch in batches:
        compare(name, upload(pack_pairs(batch)), stats)
    return stats


def box_cases_job():
    """Phase 2's box kernel on the boxes.npz boxes (``compare_boxes``, at
    FEW_CTAS CTAs and at the default grid). Returns (stats, the boxes over
    the storage limit)."""
    stats = {"max_abs_err": 0.0}
    prep = compare_boxes("box beam, boxes.npz", boxes(), stats,
                         few_ctas=FEW_CTAS)[3]
    return stats, prep["overflow"]


def kind_phase2_job(kind, part):
    """Phase 2 for the bonito and flip-flop kinds, one ``part`` each:
    "cases", the pair kernel against its plain version on the five
    envelope cases (S = 5 / 8; their storage is over the shared-memory
    limit, so it lives in global scratch); "sims", on two simulated pairs
    of ~200 bases (in shared memory, then forced into global scratch);
    "boxes", the box kernel on the anchored boxes of two ~600-base pairs
    (plans of at most BOX_PLAIN_STEPS steps) at FEW_CTAS CTAs and at the
    default grid. Returns (the pair kernel's stats, the box kernel's);
    the main process checks that the parts together take both sweep paths
    and both storage places."""
    from poreover_tpu_torch.ops.beam2d_planned import pack_pairs
    from poreover_tpu_torch.sim import write_pairs

    model = KIND_MODEL[kind]
    stats, stats_box = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    if part == "cases":
        compare(f"{kind}: cases B=5", upload(pack_pairs(
            pallas_cases(8 if kind == "flipflop" else 5), model=model)),
            stats)
    elif part == "sims":
        sims = sim_workloads(2, seed=3, lo=180, hi=220, kind=kind)
        compare(f"{kind}: sim pairs ~200 bases B=2",
                upload(pack_pairs(sims, model=model)), stats,
                also_global=True)
    else:
        with tempfile.TemporaryDirectory() as d:
            pairs_txt, _ = write_pairs(d, 2, seed=3, lo=550, hi=650,
                                       kind=kind)
            bxs = [b for r1, r2 in pair_files(pairs_txt)
                   for b in anchored_boxes_of(d, r1, r2, kind)[0]
                   if plan_steps(b) <= BOX_PLAIN_STEPS]
        compare_boxes(
            f"{kind}: box beam, the anchored boxes of two ~600-base pairs "
            f"(plans of <= {BOX_PLAIN_STEPS} steps)", bxs, stats_box,
            few_ctas=FEW_CTAS, model=model)
    return stats, stats_box


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


def beam1d_cases(model):
    """Phase 2's 1D cases of one model kind: kernel vs plain version (and
    the engine) on the mixed lengths, a T=1 read among them, at each width
    of BEAM1D_WIDTHS, then the waves of BEAM1D_WAVES reads. Returns the
    stats."""
    from poreover_tpu_torch.ops import beam1d

    stats = {"max_abs_err": 0.0}
    S = 8 if model == "ctc_flipflop" else 5
    for W in BEAM1D_WIDTHS:
        rng = np.random.default_rng(7)
        ys = [softmax_log(rng, T, S) for T in MIXED_LENGTHS[model]]
        prep = beam1d.prepare_beam1d(ys, beam_width=W, model=model,
                                     device=DEVICE)
        compare_beam1d(f"beam1d {model} W={W}", prep, stats, engine_ys=ys)
    for B in BEAM1D_WAVES:
        rng = np.random.default_rng(B)
        lens = MIXED_LENGTHS[model]
        ys = [softmax_log(rng, lens[i % len(lens)], S) for i in range(B)]
        prep = beam1d.prepare_beam1d(ys, beam_width=25, model=model,
                                     device=DEVICE)
        compare_beam1d(f"beam1d {model} W=25, {B} reads", prep, stats)
    return stats


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
    if device != "cpu":
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
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [r.split("\t") for r in open(out + ".log").read().splitlines()
            if not r.startswith("#")]
    return (read_fasta(out + ".2d.fasta"), read_fasta(out + ".1d.fasta"),
            rows, wall, dict(timers.seconds))


def cpu_decode_ref(kind):
    """Phase 6's CPU reference, in a CPU worker: ``decode --device cpu``,
    ``beam`` then ``viterbi``, of N_CPU_READS seeded reads of the kind.
    Returns (the inputs' digest, {algorithm: (FASTA bytes, seconds)})."""
    from poreover_tpu_torch.sim import write_reads

    with tempfile.TemporaryDirectory() as d:
        write_reads(d, N_CPU_READS, seed=5, lo=900, hi=1000, kind=kind)
        inputs, dig = cpu_decode_inputs(d, kind)
        out = {}
        for alg in ("beam", "viterbi"):
            _, t_cpu, _ = decode_cli(d, inputs, BASECALLER[kind], alg,
                                     f"{alg}_cpu", device="cpu")
            out[alg] = (open(os.path.join(d, f"{alg}_cpu.fasta"),
                             "rb").read(), t_cpu)
    return dig, out


def cpu_decode_inputs(d, kind):
    """The inputs of phase 6's small decodes in ``d``, and their digest."""
    names = sorted(os.listdir(d))
    inputs = [d] if kind == "bonito" else [
        os.path.join(d, f"r{i}.csv") for i in range(N_CPU_READS)]
    return inputs, digest(d, names)


def cpu_pair_ref(kind, n, seed, lo, hi, extra=(), stage1=False):
    """A CPU reference, in a CPU worker: ``pair-decode --device cpu`` (with
    ``extra``) of n seeded pairs of the kind (``write_pairs``). Returns (the
    inputs' digest, {suffix: the output file's bytes}, seconds, and with
    ``stage1`` each pair's ``--single beam`` stage 1 on the CPU)."""
    from poreover_tpu_torch.io.trace import model_from_trace
    from poreover_tpu_torch.models.transducer import beam_acceptor_batch
    from poreover_tpu_torch.sim import write_pairs

    with tempfile.TemporaryDirectory() as d:
        pairs_txt, _ = write_pairs(d, n, seed=seed, lo=lo, hi=hi, kind=kind)
        dig = digest(d, sorted(os.listdir(d)))
        wall = pair_decode_cli(d, pairs_txt, BASECALLER[kind], "cpu", extra,
                               device="cpu")[3]
        files = {suf: open(os.path.join(d, "cpu" + suf), "rb").read()
                 for suf in (".1d.fasta", ".2d.fasta", ".log")}
        s1 = None
        if stage1:
            s1 = []
            for r1, r2 in pair_files(pairs_txt):
                ms = [model_from_trace(os.path.join(d, r), BASECALLER[kind])
                      for r in (r1, r2)]
                ms[1].reverse_complement()
                s1.append(beam_acceptor_batch(ms, device="cpu"))
    return dig, files, wall, s1


def same_as_cpu_ref(what, dig, job, outs):
    """The card's run against its CPU reference (``cpu_pair_ref``'s job):
    the same inputs (``dig``, the digest of the card's) and byte-equal
    files (a ``.log`` from its third line: the first two name the run);
    ``outs``: {suffix: the card's file}. Returns the reference."""
    ref = job.result()
    dig_ref, files = ref[0], ref[1]
    if dig_ref != dig:
        fail(f"{what}: the CPU reference ran on other inputs")
    for suf, path in outs.items():
        a, b = open(path, "rb").read(), files[suf]
        if suf == ".log":
            a, b = (x.splitlines()[2:] for x in (a, b))
        if a != b:
            fail(f"{what}: the card's {suf} differs from --device cpu")
    return ref


def trie_ref(wave, threads=CPU_WORKER_THREADS):
    """Phase 17's reference, in a CPU worker: each pair of ``wave`` through
    the reference's unbounded trie (``native.pair_beam_row_col_cpu``, f64
    on the host), ``threads`` pairs at a time. Returns (the wave's digest,
    the strings, seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    from poreover_tpu_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as ex:
        tries = list(ex.map(lambda wl: native.pair_beam_row_col_cpu(
            *wl, beam_width=5), wave))
    return wave_digest(wave), tries, time.perf_counter() - t0


def likelihoods(y, strings):
    """Phase 6's check, in a CPU worker: log P(string | y) of each of
    ``strings`` (``sim.ctc_log_likelihood``, float64). Returns ({name:
    log-likelihood}, seconds)."""
    from poreover_tpu_torch.sim import ctc_log_likelihood

    t0 = time.perf_counter()
    return ({k: ctc_log_likelihood(y, q) for k, q in strings.items()},
            time.perf_counter() - t0)


def wave_digest(wave) -> str:
    h = hashlib.md5()
    for wl in wave:
        for a in wl:
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


class InProcess:
    """A job's ``result`` for a call made in this process (the first-look
    runs, which start no workers)."""

    def __init__(self, fn, *args, **kwargs):
        self.call = lambda: fn(*args, **kwargs)

    def result(self):
        return self.call()


def cpu_reference_jobs():
    """The CPU references whose inputs come from seeds alone, started in the
    CPU workers at phase 2."""
    refs = {("decode", k): cpu_job(cpu_decode_ref, k)
            for k in ("bonito", "flipflop")}
    for k in ("bonito", "flipflop"):
        refs["pairs", k] = cpu_job(cpu_pair_ref, k, 2, 5, 280, 320)
        refs["single", k] = cpu_job(cpu_pair_ref, k, 3, 17, 70, 100,
                                   ("--single", "beam"), stage1=True)
    refs["prefix"] = cpu_job(cpu_pair_ref, "poreover", 2, 21, 250, 320,
                            ("--algorithm", "prefix"))
    refs["row"] = cpu_job(cpu_pair_ref, "poreover", 2, ROW_SEED, 250, 320,
                          ("--beam_search_method", "row"))
    for m in DENSE_METHODS:
        refs[m] = cpu_job(cpu_pair_ref, "poreover", 2, DENSE_SEED, 250, 320,
                          ("--method", m))
    return refs


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
    from poreover_tpu_torch.ops import gamma as gm
    from poreover_tpu_torch.ops import pair_beam_batch as pbb
    from poreover_tpu_torch.ops import pair_prefix as pps
    from poreover_tpu_torch.ops import pair_row_beam as prb
    from poreover_tpu_torch.ops import viterbi as tv

    prb.launch_count = 0
    gm.launch_count = pps.launch_count = 0
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


def pair_kind_full(kind, gpu, stats, stats_box, cpu_ref, row_waves):
    """Phase 10 for one kind (bonito or flip-flop): 8 full-size pairs
    through ``pair-decode``, then with ``--skip_matches``; the kernels
    timed on those waves and held to their plain versions (the box kernel
    on pair 0's boxes in a launch with the wave's shared memory per CTA);
    two ~300-base pairs on the card against ``--device cpu``
    (``cpu_ref``, ``cpu_pair_ref``'s job). Returns the kind's entries of
    the kernels line; keeps the wave's workloads in ``row_waves[kind]``
    (phase 19)."""
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
        row_waves[kind] = wave
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
        dig = digest(d, sorted(os.listdir(d)))
        on_card = pair_decode_cli(d, pairs_txt, bc, "card")
        if len(on_card[0]) != 2:
            fail(f"{kind}: {len(on_card[0])} consensus records of 2 pairs")
        ref = same_as_cpu_ref(kind, dig, cpu_ref, {
            suf: os.path.join(d, "card" + suf)
            for suf in (".1d.fasta", ".2d.fasta")})
        log(f"  {kind}: 2 pairs of ~300 bases byte-identical to --device cpu "
            f"(.1d.fasta, .2d.fasta); card {on_card[3]:.2f} s, cpu "
            f"{ref[2]:.2f} s (in a CPU worker)")
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
    threads, a load of another thread's word), ``lse`` (a log-add-exp,
    ``common.cuh:lse``, of two ready operands 1 apart: the probe's round
    less the add that makes its second operand), ``lse_near`` (operands
    0.05 apart), ``lse_mixed`` (the lanes' operands 0.05-7.8 apart),
    ``lse_two`` (a round of two independent chains), ``lse_flat`` and
    ``lse_flat_two`` (``common.cuh:lse_flat``, one and two chains)."""
    import ctypes

    from poreover_tpu_torch import build

    global LATENCIES
    if LATENCIES is None:
        lib = ctypes.CDLL(str(build.build_kernel("latency")))
        lib.latency_probe.restype = ctypes.c_int
        lib.latency_probe.argtypes = [ctypes.POINTER(ctypes.c_double),
                                      ctypes.c_int]
        out = (ctypes.c_double * 11)()
        if lib.latency_probe(out, 4096):
            fail("the latency probe failed")
        (add, add_max, shfl_max, warp_rt, cta_rt, lse, near, mixed, two,
         flat, flat_two) = out
        LATENCIES = dict(add=add, max=add_max - add, shfl_max=shfl_max,
                         warp_rt=warp_rt, cta_rt=cta_rt, lse=lse - add,
                         lse_near=near - add, lse_mixed=mixed - add,
                         lse_two=two - add, lse_flat=flat - add,
                         lse_flat_two=flat_two - add)
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


def single_beam_phase(gpu, truth, cons_viterbi, cpu_refs):
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
    CPU's (``cpu_refs``: kind -> ``cpu_pair_ref``'s job). Returns the
    acceptor's entry of the kernels line."""
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
            dig = digest(d, sorted(os.listdir(d)))
            rows = pair_decode_cli(d, pairs_txt, BASECALLER[kind], "o_cuda",
                                   sb)[2]
            ref = same_as_cpu_ref(f"--single beam {kind}", dig,
                                  cpu_refs[kind], {
                                      suffix: os.path.join(d, "o_cuda"
                                                           + suffix)
                                      for suffix in (".1d.fasta",
                                                     ".2d.fasta", ".log")})
            ext = ".csv" if kind == "flipflop" else ".npy"
            bad = 0
            for (r1, r2), cpu_s1 in zip(pair_files(pairs_txt), ref[3]):
                ms = [model_from_trace(os.path.join(d, r), BASECALLER[kind])
                      for r in (r1, r2)]
                ms[1].reverse_complement()
                on_card = beam_acceptor_batch(ms, device=DEVICE)
                bad += sum(a[0] != b[0] or not np.array_equal(a[1], b[1])
                           for a, b in zip(on_card, cpu_s1))
            if bad:
                fail(f"--single beam {kind}: {bad} stage 1 results differ "
                     "between the card and the CPU")
            n_ok = sum(r[-1] == "0" for r in rows)
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


def benchmark_phase(keep, truth3, truth6):
    """Phase 16, in a CPU worker: ``benchmark --fasta_pair`` on phase 3's
    FASTA files (16 1D calls, 8 consensi) against the 8 simulated
    templates, and ``benchmark --fasta`` on phase 6's 32 Viterbi calls
    against their 32 true sequences (host code). Gates: every file's CSV
    holds a row per record; phase 6's calls (identity >= IDENTITY_FLOOR,
    few insertions) all map. Phase 3's records are mapped as far as the
    built-in k-mer aligner finds them: the argmax calls of the
    simulator's noisy reads carry ~18% inserted bases, which spread the
    aligner's diagonal votes (ROADMAP §C); the counts are printed."""
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


def exact_cases(kind):
    """Phase 17(a)'s cases of one kind: the graveyard instance against the
    plain graveyard engine on the card (``compare``: provenance, scores
    bits, validity) on tests/test_exact.py's cases at EXACT_GRACES (CTC)
    or the first and last of them, the last in each storage path; the same
    cases on plans that step back (EXACT_STUTTER); on plans that step back
    past the storage window (EXACT_WRAP), in every storage path, which
    must carry live graveyard rows across the wrap of the JAX engine's
    shift and resume some of them (``gwrap``, ``gresume_wrap``). Returns
    the stats, with the plain version's GY_COUNTS."""
    from poreover_tpu_torch.ops.beam2d_planned import (
        EXACT_G, GY_COUNTS, pack_pairs,
    )
    from poreover_tpu_torch.sim import exact_style_cases, stuttered

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
    pl, ws = stuttered(cs, *EXACT_WRAP)
    wrap = {"max_abs_err": 0.0}
    compare(f"{kind} exact: cases B=3, plans stepping back past the "
            "storage window", upload(pack_pairs(
                cs, model=model, G=EXACT_G, plans=pl, wst=ws)), wrap,
            also_global=True)
    if not wrap["gwrap"] or not wrap["gresume_wrap"]:
        fail(f"{kind} exact: the wrap case carried {wrap['gwrap']} live "
             f"graveyard rows across a wrapping shift and resumed "
             f"{wrap['gresume_wrap']} of them")
    for c in GY_COUNTS:
        stats[c] = stats.get(c, 0) + wrap[c]
    stats["max_abs_err"] = max(stats["max_abs_err"], wrap["max_abs_err"])
    return stats


def exact_kernel_cases(full_pairs, case_jobs=None):
    """Phase 17(a): per kind ``exact_cases`` (``case_jobs``: their jobs in
    the card's workers, else run here), then the first EXACT_PLAIN_STEPS
    steps of ``full_pairs`` (two full-size pairs per kind) at their full
    storage widths. Fails unless the runs turned rows away from a full
    graveyard, resumed graveyard rows, and resumed one that had moved
    back while buried (the plain version's GY_COUNTS). Returns per kind
    its stats, with (kernel ms, plain ms, bound ms) of the truncated
    pairs."""
    from poreover_tpu_torch.ops.beam2d_planned import EXACT_G, GY_COUNTS

    out = {}
    for kind in ("poreover", "bonito", "flipflop"):
        stats = case_jobs[kind].result() if case_jobs else exact_cases(kind)
        short = upload(pack_truncated(full_pairs[kind], EXACT_PLAIN_STEPS,
                                      KIND_MODEL[kind], EXACT_G))
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


def exact_phase(gpu, kstats, cons_windowed, trie_job=None):
    """Phase 17: exact mode (``pair-decode --exact``) at full size, after
    ``exact_kernel_cases`` (``kstats``). (b) phase 3's 8 CTC pairs through
    the CLI with ``--exact``: 8 records, the graveyard instance launched
    and the windowed one not, each string's md5 the JAX exact engine's
    (EXACT_CTC_MD5); the wave's kernel time by CUDA events and its cycles
    per plan step by phase (the graveyard's share apart); each
    consensus beside the reference's unbounded trie (``trie_ref``:
    ``trie_job``, in a CPU worker since phase 3, else here, one thread per
    pair): ``trie_match``, every identity >= EXACT_TRIE_FLOOR and >= that
    of phase 3's windowed consensus (``cons_windowed``) to the trie; pair
    0 through the single-pair entry byte-identical to its string in the
    wave. (c) the same pairs with ``--exact --skip_matches``: 8 records,
    no box-kernel launch, the exact box waves' launches and time. (d) 8
    bonito and 8 flip-flop pairs (phase 10's) with ``--exact``: 8 records
    each, the wave's kernel time and cycles by phase. Returns the
    graveyard instance's entries of the kernels line, one per kind."""
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
            f"storage path {pbb.storage_path(prep)}; plan steps per "
            f"pair {steps.tolist()}")
        log(f"  bound terms: {wave_terms}")
        parts, _ = clock_breakdown(f"{kind} exact wave", pbb,
                                   lambda: pbb.launch_prepared(prep))
        step = parts["step"]
        grave = step["grave_select"] + step["grave_store"]
        log(f"  {kind} exact wave: the graveyard's phases {grave:.1f} of "
            f"{step['total']:.1f} cycles per plan step "
            f"({100 * grave / max(step['total'], 1):.1f}%: select "
            f"{step['grave_select']:.1f}, store {step['grave_store']:.1f})")
        if kind == "poreover":
            md5s = [hashlib.md5(c.encode()).hexdigest() for c in cons]
            bad = [i for i, (a, b) in enumerate(zip(md5s, EXACT_CTC_MD5))
                   if a != b]
            log(f"  --exact strings' md5 equal to the JAX exact engine's on "
                f"{8 - len(bad)}/8 pairs")
            if bad:
                fail(f"--exact: pairs {bad} differ from the JAX exact "
                     f"engine's strings (md5 {[md5s[i] for i in bad]})")
            where = "in a CPU worker" if trie_job else "here"
            dig, tries, t_trie = (trie_job or InProcess(
                trie_ref, wave, len(wave))).result()
            if dig != wave_digest(wave):
                fail("--exact: the trie ran on another wave than this "
                     "phase's")
            ids = [identity(c, t) for c, t in zip(cons, tries)]
            match = sum(c == t for c, t in zip(cons, tries))
            wids = [identity(c, w) for c, w in zip(cons, cons_windowed)]
            wtids = [identity(w, t) for w, t in zip(cons_windowed, tries)]
            log(f"  trie_match {match}/8 (the unbounded trie, f64 on the "
                f"host, {t_trie:.1f} s {where}); identity to it "
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
            "storage": pbb.storage_path(prep),
            "cycles_per_step": step["total"],
            "graveyard_cycles_per_step": grave,
        })
        del prep, wave
    return entries


# phase 18 (pair-decode --algorithm prefix): the gamma kernel is held to its
# plain version on the last PREFIX_GAMMA_ROWS rows of every workload (G; the
# boxes that have no more whole, gamma(0,0) too) and, whole, on a copy of
# each full-size pair cut to its first PREFIX_GAMMA_ROWS rows
# (``front_rows``: G and gamma(0,0) at full width); the level kernel on the
# two full-size pairs' first PREFIX_PLAIN_LEVELS levels (the plain level
# runs ~40 tensor ops on [2, 2, 4, T] and [2, 4, U, W] tensors, ~3.4 ms;
# by level 1000 the front is past row 5000, across the kernel's 2048-row
# envelope CTAs). The level kernel's time per launch is taken over the
# 8-pair wave's first PREFIX_TIMED_LEVELS levels
PREFIX_GAMMA_ROWS = 1000
PREFIX_PLAIN_LEVELS = 1000
PREFIX_TIMED_LEVELS = 300
# cycles of the spin kernel (``torch.cuda._sleep``, ~0.1 ms) queued before a
# timed level launch: the stream is busy while the host enqueues the launch,
# so the span between its events is the kernel's alone
PREFIX_SLEEP_CYCLES = 200_000
# the gamma kernel's instances (ops/gamma.py: INSTANCES) that
# ``--first-look gamma`` times and clocks on phase 18's launches: the main
# path's, and the CTA-wide one (the first design) beside it; the full run
# times the main path's alone
GAMMA_INSTANCES = ("warp", "wide")
# phase 18(f): band widths on both sides of each boundary of the gamma
# kernel: a warp's 32 E cells at E = 1, 2 and 4 cells a lane, and the
# CTA-wide instance past ops/gamma.py:MAX_WARP_W (128)
GAMMA_WIDTHS = (31, 32, 33, 63, 64, 65, 127, 128, 129, 511, 512, 513)
GAMMA_WIDTH_ROWS = 160  # five chunks of 32 rows: the ring of four wraps
# the anchored searches' last rows of each box held to the plain version
# (boxes of up to 7205 rows; all those of up to 1000 whole)
GAMMA_ANCHORED_PLAIN_ROWS = 1000
# H100 SXM float64 (non-tensor) FLOP/s, NVIDIA data sheet: the level
# kernel's label forward runs in float64
F64_FLOPS = 34e12
# float operations per envelope cell of the gamma DP: the alphabet's
# log-sum-exp (A adds, A maxes, A subs, A exps, A-1 adds, a log, an add),
# the cell's C, gap-sum and scan-input adds, the reverse scan's ~2
# log-add-exps, the gap subtraction, the up term's add and log-add-exp
# (a log-add-exp counted as 6: max, sub, abs, exp, log1p, add)
GAMMA_OPS_PER_CELL = 6 * 4 + 3 + 2 * 6 + 1 + 1 + 6
# float64 operations per frame and character of the label forward: the
# emission add, the cw subtraction, ~2 log-add-exps of the scan, the cw add
LEVEL_F64_OPS = 2 + 2 * 6 + 1
# float32 operations per envelope cell and character of the reduction's
# first pass (alpha*_2's add, the G add, the max); the exponentials of the
# rows near the front are data-dependent and left out of the bound
LEVEL_F32_OPS = 3


def front_rows(wl, n):
    """A copy of workload ``wl`` = (y1, y2, env [U, 2]) cut to its first
    ``n`` rows: y1[:n], the envelope's first n rows, y2 up to their last
    end. A workload of its own (the suffix masses are the cut reads'), at
    the full pair's band width."""
    y1, y2, env = wl
    env = np.asarray(env)[:n]
    V = max(int(env[:, 1].max()), 1)
    return y1[:n], y2[:V], env


def envelope_cells(prep) -> int:
    """The envelope's cells over rows 0..U-1 of every workload of the
    gamma DP's ``prep`` (each row's width end - start, at least 0): the
    cells of G, and those the DP computes."""
    from poreover_tpu_torch.ops import gamma as gm

    m = prep["meta"]
    env = prep["env"].cpu().numpy().astype(np.int64)
    cells = 0
    for row in m:
        e = env[row[gm.M_EOFF]:row[gm.M_EOFF] + row[gm.M_U]]
        cells += int(np.clip(e[:, 1] - e[:, 0], 0, None).sum())
    return cells


def prefix_gamma_bound_ms(prep) -> tuple[float, str]:
    """The gamma DP's least time: its inputs (both reads, the envelope
    rows, the suffix masses) read once and its outputs (G over the
    envelope's cells, gamma(0,0)) written once, against
    GAMMA_OPS_PER_CELL per envelope cell."""
    from poreover_tpu_torch.ops import gamma as gm

    m = prep["meta"]
    U, V = m[:, gm.M_U], m[:, gm.M_V]
    cells = envelope_cells(prep)
    nbytes = int(((U + V) * (prep["A"] + 1) * 4 + (U + 1) * 8
                  + (U + V + 2) * 4 + 4).sum()) + cells * 4
    t_b = nbytes / HBM_BPS
    t_o = cells * GAMMA_OPS_PER_CELL / F32_FLOPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def prefix_level_bound_ms(prep) -> tuple[float, str]:
    """One level's least time over every workload of the gamma DP's
    ``prep``: the frames' emissions and gap column, the chosen alpha rows
    and the envelope rows read once (the gap column's float64 prefix sums,
    ``cw``, are made from it once a search and not counted again), G read
    once within the envelope, the A alpha rows written once; the label
    forward's float64 operations over F64_FLOPS and the reduction's first
    pass over F32_FLOPS."""
    from poreover_tpu_torch.ops import gamma as gm

    A, m = prep["A"], prep["meta"]
    N = int((m[:, gm.M_U] + m[:, gm.M_V]).sum())
    cells = envelope_cells(prep)
    nbytes = N * ((A + 1) * 4 + 4 + A * 4) + int(m[:, gm.M_U].sum()) \
        * 8 + cells * 4
    t_b = nbytes / HBM_BPS
    t_o = N * A * LEVEL_F64_OPS / F64_FLOPS + cells * A * LEVEL_F32_OPS \
        / F32_FLOPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def gamma_searches(d, pairs_txt):
    """The gamma DP's launches in phase 18's two runs of the pairs of
    ``pairs_txt``: the 8-pair wave (one search) and the anchored run's
    searches (the boxes sorted by length, PREFIX_BOX_WAVE to a search, as
    ``decoding/pair.py:_prefix_box_consensus`` batches them). Returns
    (wave, [boxes of each search])."""
    from poreover_tpu_torch.decoding.pair import PREFIX_BOX_WAVE

    files = pair_files(pairs_txt)
    wave = [workload_of(d, r1, r2) for r1, r2 in files]
    bxs = [b for r1, r2 in files for b in anchored_boxes_of(d, r1, r2)[0]]
    bxs.sort(key=lambda b: len(b[0]) + len(b[1]))
    return wave, [bxs[i:i + PREFIX_BOX_WAVE]
                  for i in range(0, len(bxs), PREFIX_BOX_WAVE)]


def band_rows(prep):
    """Per workload of the gamma DP's ``prep``: (W, its rows' widths end -
    start, u = 0..U-1)."""
    from poreover_tpu_torch.ops import gamma as gm

    env = prep["env"].cpu().numpy().astype(np.int64)
    out = []
    for m in prep["meta"]:
        e = env[m[gm.M_EOFF]:m[gm.M_EOFF] + m[gm.M_U]]
        out.append((int(m[gm.M_W]), e[:, 1] - e[:, 0]))
    return out


def band_line(name, prep) -> str:
    """The W and row-width distribution of a launch's workloads."""
    rows = band_rows(prep)
    Ws = [W for W, _ in rows]
    wd = np.concatenate([w for _, w in rows])
    q = np.percentile(wd, [50, 90, 99])
    return (f"{name}: {len(rows)} workloads, W {min(Ws)}-{max(Ws)}, rows "
            f"{len(wd)} (longest {max(len(w) for _, w in rows)}); row width "
            f"end - start mean {wd.mean():.2f}, p50 {q[0]:.0f}, p90 "
            f"{q[1]:.0f}, p99 {q[2]:.0f}, max {wd.max()}; rows wider than "
            f"31: {np.mean(wd > 31):.4f}")


def gamma_row_levels(W, width):
    """Per row of a band of W cells: the levels of the reverse scan's tree
    (the odd/even tree of jax.lax.associative_scan over the flipped row)
    that hold a node with a cell of the row on both sides. The cells at w
    >= width are -inf and come first in the flipped row, and a node with
    one side all -inf returns the other side, so the other levels take
    no log-add-exp on the chain."""
    a = W - np.asarray(width, np.int64)
    n = np.zeros(a.shape, np.int64)
    s = 1
    while 2 * s <= W:
        n += (W // (2 * s)) * 2 * s - 1 - s >= a  # up: the last node
        m = (W - s) // (2 * s)  # down: the last node, s + 2 s m - 1
        if m >= 1:
            n += 2 * s * m - 1 >= a
        s *= 2
    return n


def gamma_floor_cycles(lat, W, width, lse="lse"):
    """The least dependent chain of each row of a band (csrc/pair_gamma.cu)
    at the latencies ``lat``: the row below's diagonal cell plus the
    alphabet's log-sum-exp, plus the gap prefix sum (two adds), the scan's
    levels (``gamma_row_levels``, a log-add-exp each), the prefix sum
    taken off again (an add) and the final log-add-exp with the up term;
    a row with no cell in range has none. ``lse``: the log-add-exp's
    latency, ``lat["lse"]`` (common.cuh:lse) or ``lat["lse_flat"]``
    (common.cuh:lse_flat, the same bits without branches)."""
    width = np.asarray(width, np.int64)
    lv = gamma_row_levels(W, width)
    return np.where(width > 0, 3 * lat["add"] + (lv + 1) * lat[lse], 0.0)


def gamma_floor_ms(prep, lat, mhz, lse="lse") -> float:
    """A launch's latency floor: the longest of its workloads' chains
    (``gamma_floor_cycles`` over every row) at ``mhz``."""
    return max(float(gamma_floor_cycles(lat, W, wd, lse).sum())
               for W, wd in band_rows(prep)) / (mhz * 1e3)


def gamma_timings(gpu, wave, searches, instances=("warp",), reps=2):
    """The gamma kernel on the 8-pair wave and on each anchored search, per
    instance (the main path's; ``--first-look gamma`` GAMMA_INSTANCES,
    held bit-equal to each other on every launch): ms per launch (CUDA
    events), the clocked build's cycles per row by phase
    (``clock_breakdown``), the bytes bound and the latency floor; the
    anchored boxes' last GAMMA_ANCHORED_PLAIN_ROWS rows held to the plain
    version, and G and gamma(0,0) of the clocked build to the normal
    build's. Returns {instance: {"wave": ms, "anchored": [ms per search],
    "cycles": {...}}} and the floors."""
    import torch
    from poreover_tpu_torch.ops import gamma as gm

    lat = instruction_latencies()
    mhz = sm_clock_mhz()
    preps = [("8-pair wave", gm.prepare_gamma(wave, device=DEVICE))] + [
        (f"anchored search {i}", gm.prepare_gamma(b, device=DEVICE))
        for i, b in enumerate(searches)]
    for name, prep in preps:
        log("  " + band_line(name, prep))
    floors = [gamma_floor_ms(prep, lat, mhz, "lse_flat") for _, prep in preps]
    floors_lse = [gamma_floor_ms(prep, lat, mhz) for _, prep in preps]
    bounds = [prefix_gamma_bound_ms(prep)[0] for _, prep in preps]
    log(f"  [{gpu}] gamma latency floor (lse_flat {lat['lse_flat']:.1f}, "
        f"two chains {lat['lse_flat_two']:.1f} a round; add "
        f"{lat['add']:.1f} cycles at {mhz:.0f} MHz): 8-pair wave "
        f"{floors[0]:.3f} ms, anchored searches "
        + " ".join(f"{x:.3f}" for x in floors[1:])
        + f" ms (sum {sum(floors[1:]):.3f}); at lse's {lat['lse']:.1f} "
        f"(operands 0.05 apart {lat['lse_near']:.1f}, the lanes' spread "
        f"{lat['lse_mixed']:.1f}; two chains {lat['lse_two']:.1f} a round): "
        f"{floors_lse[0]:.3f} / sum {sum(floors_lse[1:]):.3f} ms; bytes "
        f"bound {bounds[0]:.4f} / "
        + " ".join(f"{x:.4f}" for x in bounds[1:]) + " ms")
    # every launch's instances bit-equal; the anchored searches' last
    # GAMMA_ANCHORED_PLAIN_ROWS rows of each box to the plain version
    n = GAMMA_ANCHORED_PLAIN_ROWS
    n_whole = 0
    for name, prep in preps:
        outs = [gm.gamma_cuda(prep, instance=inst) for inst in instances]
        for inst, o in zip(instances[1:], outs[1:]):
            same_gamma(f"gamma {name}: {instances[0]} against {inst}", prep,
                       outs[0], o)
        if name.startswith("anchored"):
            n_whole += same_gamma(f"gamma {name}", prep, outs[0],
                                  gm.gamma_plain(prep, n)[1:], n)
    log(f"  gamma kernel, instances {instances}: the anchored boxes' last "
        f"{n} rows bit-equal to the plain version ({n_whole} of "
        f"{sum(len(b) for b in searches)} boxes whole)"
        + (" and the instances bit-equal on the wave and every anchored "
           "search" if len(instances) > 1 else ""))
    out = {}
    for inst in instances:
        ms = [event_ms(lambda: gm.gamma_cuda(prep, instance=inst), reps)
              for _, prep in preps]
        cyc = {}
        for name, prep in preps[:2]:
            want = gm.gamma_cuda(prep, instance=inst)
            got = []
            cyc[name], _ = clock_breakdown(
                f"{name}, instance {inst}", gm,
                lambda: got.append(gm.gamma_cuda(prep, instance=inst)))
            torch.cuda.synchronize()
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got[0], want)):
                fail(f"gamma {name}: the instrumented build's G differs")
        log(f"  [{gpu}] gamma kernel, instance {inst}: 8-pair wave "
            f"{ms[0]:.3f} ms ({ms[0] / floors[0]:.2f}x the floor), "
            f"anchored searches " + " ".join(f"{x:.3f}" for x in ms[1:])
            + f" ms (sum {sum(ms[1:]):.3f})")
        out[inst] = dict(wave=ms[0], anchored=ms[1:], cycles=cyc)
    return out, dict(wave=floors[0], anchored=floors[1:], lat=lat,
                     wave_at_lse=floors_lse[0],
                     anchored_at_lse=floors_lse[1:], bound=bounds[0],
                     anchored_bound=bounds[1:])


def same_gamma(name, prep, got, want, n_rows=None):
    """Fails unless the gamma kernel's (G, gamma00) ``got`` equal ``want``
    bit for bit: each workload's G rows u >= U - ``n_rows`` (all with
    None), and gamma(0,0) of the workloads compared whole. Returns how
    many were whole."""
    import torch
    from poreover_tpu_torch.ops import gamma as gm

    def same(what, b, x, y):
        if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
            fail(f"{name}, workload {b}: {what} differs")

    n_whole = 0
    for b in range(len(prep["meta"])):
        U = int(prep["meta"][b, gm.M_U])
        lo = 0 if n_rows is None else max(U - n_rows, 0)
        same("G", b, *(gm.unpack_g(prep, x[0], b)[lo:] for x in (got, want)))
        if lo == 0:
            n_whole += 1
            same("gamma00", b, got[1][b:b + 1], want[1][b:b + 1])
    return n_whole


def gamma_width_cases():
    """Phase 18(f): the gamma kernel at GAMMA_WIDTHS
    (``sim.gamma_band_cases``, GAMMA_WIDTH_ROWS rows), bit for bit against
    its plain version, each width through the instance it takes
    (``ops/gamma.py:instance_for``). Returns the launches compared."""
    from poreover_tpu_torch.ops import gamma as gm
    from poreover_tpu_torch.sim import gamma_band_cases

    taken = {}
    for W in GAMMA_WIDTHS:
        prep = gm.prepare_gamma(gamma_band_cases(W, GAMMA_WIDTH_ROWS, W),
                                device=DEVICE)
        inst = gm.instance_for(prep["W_max"])
        same_gamma(f"phase 18(f) gamma, W {W}, instance {inst}", prep,
                   gm.gamma_cuda(prep), gm.gamma_plain(prep)[1:])
        taken.setdefault(inst, []).append(W)
    log(f"phase 18(f) gamma kernel at band widths {GAMMA_WIDTHS} "
        f"({GAMMA_WIDTH_ROWS} rows): each bit-equal to the plain version "
        f"through the instance it takes ({taken})")
    return len(GAMMA_WIDTHS)


def clocked_search(wls, n_levels, route=None, mod=None, trace=None):
    """The search over ``wls`` (``mod``: this tree's ``ops.pair_prefix``
    or the parent tree's) for its first ``n_levels`` levels; returns
    (results, mean ms a level step, steps). A kernel step is the launch
    alone between CUDA events, behind a spin kernel of
    PREFIX_SLEEP_CYCLES so that the host's call is not in the span; a
    plain step (``route`` "plain") is ``level_plain``'s call between
    events."""
    import torch
    from poreover_tpu_torch.ops import pair_prefix as pps

    mod = mod or pps
    spans = []

    def clock(inner, sleep):
        def clocked(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            if sleep:
                torch.cuda._sleep(PREFIX_SLEEP_CYCLES)
            e0.record()
            out = inner(*a)
            e1.record()
            spans.append((e0, e1))
            return out
        return clocked

    if route == "plain":
        owner, name = mod, "level_plain"
    else:
        owner, name = mod.load_kernel(), "pair_prefix_launch"
    inner = getattr(owner, name)
    setattr(owner, name, clock(inner, route != "plain"))
    try:
        res = mod.pair_prefix_search_batch(wls, device=DEVICE,
                                           max_levels=n_levels, trace=trace,
                                           route=route)
    finally:
        setattr(owner, name, inner)
    torch.cuda.synchronize()
    if not spans:
        fail(f"phase 18: the search ran no level ({name})")
    return res, float(np.mean([a.elapsed_time(b) for a, b in spans])), \
        len(spans)


def prefix_kernel_cases(full2):
    """Phase 18(a): both kernels against their plain versions on the card,
    bit for bit: boxes.npz's anchor boxes (those the JAX search takes) and
    two full-size pairs. The gamma kernel runs whole; its G is held to the
    plain version's last PREFIX_GAMMA_ROWS rows of each workload (every
    row, and gamma(0,0), of the boxes that have no more), and on each
    full-size pair's ``front_rows`` copy G and gamma(0,0) whole (both
    timed there). The level kernel is held on the search's first
    PREFIX_PLAIN_LEVELS levels of the full-size pairs, the boxes' searches
    whole (every level's outputs and the strings so far). Returns timings
    for the kernels line, the levels' per step."""
    from poreover_tpu_torch.ops import gamma as gm
    from poreover_tpu_torch.ops import pair_prefix as pps

    d = np.load(os.path.join(HERE, "tests", "data", "boxes.npz"))
    bxs = [(d[f"y1_{i}"], d[f"y2_{i}"], d[f"env_{i}"])
           for i in range(int(d["n"]))]
    bxs = [b for b in bxs if pps.workload_error(*b) is None]
    n_rows = PREFIX_GAMMA_ROWS
    front = [front_rows(wl, n_rows) for wl in full2]
    cases = [(f"boxes.npz, {len(bxs)} boxes", bxs, None),
             ("two full-size pairs", full2, PREFIX_PLAIN_LEVELS),
             (f"two full-size pairs' first {n_rows} rows", front, 0)]
    out = {}
    for name, wls, n_levels in cases:
        prep = gm.prepare_gamma(wls, device=DEVICE)
        whole = n_levels == 0
        (kG, kg), k_ms = timed(lambda: gm.gamma_cuda(prep))
        (_, pG, pg), p_ms = timed(
            lambda: gm.gamma_plain(prep, None if whole else n_rows))
        n_whole = same_gamma(f"phase 18 gamma, {name}", prep, (kG, kg),
                             (pG, pg), None if whole else n_rows)
        if whole:
            g00 = kg.cpu().numpy()
            if not np.isfinite(g00).all():
                fail(f"phase 18 gamma, {name}: gamma(0,0) {g00} not finite")
            k_ms = event_ms(lambda: gm.gamma_cuda(prep), reps=2)
            out["front"] = dict(gamma_ms=k_ms, gamma_plain_ms=p_ms,
                                gamma_bound=prefix_gamma_bound_ms(prep)[0])
            log(f"phase 18(a) {name}: gamma kernel {k_ms:.3f} ms, plain "
                f"{p_ms:.1f} ms; G and gamma(0,0) ({g00[0]:.6g}, "
                f"{g00[1]:.6g}) bit-equal")
            continue
        tk, tpl = [], []
        k_res, lk_ms, n_k = clocked_search(wls, n_levels, trace=tk)
        p_res, lp_ms, n_p = clocked_search(wls, n_levels, route="plain",
                                           trace=tpl)
        if k_res != p_res or n_k != n_p or not all(
                np.array_equal(a.view(np.int32), b.view(np.int32))
                for a, b in zip(tk, tpl)):
            fail(f"phase 18 levels, {name}: the level kernel differs from "
                 "its plain version")
        log(f"phase 18(a) {name}: gamma kernel {k_ms:.2f} ms, plain "
            f"{p_ms:.1f} ms (G of each workload's last {n_rows} rows; "
            f"{n_whole} of {len(wls)} whole, gamma(0,0) too); {n_k} "
            f"levels, the level kernel {lk_ms:.3f} ms a launch, the plain "
            f"level {lp_ms:.1f} ms; G and every level's outputs bit-equal")
        out[name] = dict(levels=n_k, level_ms=lk_ms, level_plain_ms=lp_ms)
    return out


def prefix_phase(gpu, truth, cons_beam, cpu_ref=None):
    """Phase 18: ``pair-decode --algorithm prefix`` at full size. (a)
    ``prefix_kernel_cases``; (b) phase 3's 8 CTC pairs through the CLI:
    8 records, both kernels launched, levels per pair, each consensus's
    identity to the truth beside the beam consensus's (``cons_beam``),
    recorded, not gated; (c) the same with ``--skip_matches``; (d) two
    small pairs byte-identical to ``--device cpu``; (e) timings. Returns
    the two kernels' entries of the kernels line."""
    import torch
    from poreover_tpu_torch.ops import gamma as gm
    from poreover_tpu_torch.ops import pair_prefix as pps
    from poreover_tpu_torch.sim import write_pairs

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, _ = write_pairs(d, 8, seed=7, lo=5200, hi=8200)
        wave, searches = gamma_searches(d, pairs_txt)
        cases = prefix_kernel_cases(wave[:2])
        gamma_width_cases()
        runs = {}
        for name, extra in (("envelope", ()), ("anchored",
                                                ("--skip_matches",))):
            gm.launch_count = pps.launch_count = 0
            pps.levels_run.clear()
            cons, _, rows, wall, tmr = pair_decode_cli(
                d, pairs_txt, "poreover", f"p_{name}",
                ("--algorithm", "prefix", *extra))
            launches = (gm.launch_count, pps.launch_count)
            if len(cons) != 8 or any(r[-1] != "0" for r in rows):
                fail(f"phase 18 {name}: expected 8 consensus records and no "
                     f"skips; got {len(cons)}, rows {rows}")
            if min(launches) < 1:
                fail(f"phase 18 {name}: launches (gamma, level) {launches}")
            ids = [identity(c, t) for c, t in zip(cons, truth)]
            ids_b = [identity(c, t) for c, t in zip(cons_beam, truth)]
            if not all(np.isfinite(ids)) or min(len(c) for c in cons) < 1:
                fail(f"phase 18 {name}: an empty or unscorable consensus")
            levels = list(pps.levels_run)
            runs[name] = dict(wall=wall, launches=launches, ids=ids,
                              cons_s=tmr.get("consensus_2d", float("nan")))
            log(f"phase 18(b) pair-decode --algorithm prefix "
                f"{' '.join(extra)}: 8 pairs, {launches[0]} gamma and "
                f"{launches[1]} level launches, end-to-end {wall:.1f} s, "
                f"consensus stage {runs[name]['cons_s']:.1f} s; "
                f"{len(levels)} searches, {sum(levels)} levels"
                + (f" (per pair {levels})" if name == "envelope" else
                   f" (most {max(levels)})"))
            log("  identity to the truth, prefix: "
                + " ".join(f"{x:.4f}" for x in ids) + "; beam: "
                + " ".join(f"{x:.4f}" for x in ids_b))
        # (d) two small pairs, the card against the CPU, byte for byte
        small = os.path.join(d, "small")
        os.makedirs(small)
        spairs, _ = write_pairs(small, 2, seed=21, lo=250, hi=320)
        dig = digest(small, sorted(os.listdir(small)))
        pair_decode_cli(small, spairs, "poreover", "s_cuda",
                        ("--algorithm", "prefix"))
        same_as_cpu_ref("phase 18(d), two small pairs", dig,
                        cpu_ref or InProcess(cpu_pair_ref, "poreover", 2, 21,
                                             250, 320,
                                             ("--algorithm", "prefix")),
                        {s: os.path.join(small, f"s_cuda{s}")
                         for s in (".1d.fasta", ".2d.fasta")})
        log("phase 18(d) two small pairs: .1d/.2d.fasta byte-identical to "
            "--device cpu")
        # (e) timings on the 8-pair wave (the gamma kernel's also on the
        # anchored run's searches, clocked, beside its floor)
        prep8 = gm.prepare_gamma(wave, device=DEVICE)
        gt, gf = gamma_timings(gpu, wave, searches)
        g_ms = gt["warp"]["wave"]
        g_bound, g_by = prefix_gamma_bound_ms(prep8)
        _, l_ms, l_n = clocked_search(wave, PREFIX_TIMED_LEVELS)
        l_bound, l_by = prefix_level_bound_ms(prep8)
        if PARENT and os.path.isfile(os.path.join(
                PARENT, "poreover_tpu_torch", "ops", "pair_prefix.py")):
            old = parent_module("pair_prefix")
            ts = [clocked_search(wave, PREFIX_TIMED_LEVELS, mod=m)[1]
                  for m in (None, old, old, None)]
            log(f"  in turns with {PARENT}'s level kernel, the wave's first "
                f"{PREFIX_TIMED_LEVELS} levels: this tree "
                f"{ts[0]:.3f} / {ts[3]:.3f} ms a launch, the parent "
                f"{ts[1]:.3f} / {ts[2]:.3f} ms")
    full, front = cases["two full-size pairs"], cases["front"]
    env_run = runs["envelope"]
    host_ms = (env_run["cons_s"] * 1e3 - g_ms) / env_run["launches"][1] \
        - l_ms
    log(f"phase 18(e) [{gpu}]: gamma kernel {g_ms:.1f} ms per 8-pair wave "
        f"(bound {g_bound:.4f} ms, {g_by}; latency floor {gf['wave']:.3f} "
        f"ms), {sum(gt['warp']['anchored']):.2f} ms over the anchored run's "
        f"{len(searches)} searches; level kernel {l_ms:.4f} ms per "
        f"launch over the wave's first {l_n} levels (bound {l_bound:.4f} "
        f"ms, {l_by}); the consensus stage's rest per level (host loop and "
        f"copies): {host_ms:.4f} ms; plain level "
        f"{full['level_plain_ms']:.1f} ms a step on two pairs (the kernel "
        f"{full['level_ms']:.4f} ms there); phase "
        f"{time.perf_counter() - t0:.0f} s")
    return [{
        "name": "pair_gamma", "route": "cuda",
        "source": "poreover_tpu_torch/csrc/pair_gamma.cu",
        "replaces": "poreover_tpu/ops/gamma.py:42 (_gamma_scan, a lax.scan, "
                    "not a Pallas kernel)",
        "launches": runs["envelope"]["launches"][0], "max_abs_err": 0.0,
        "ms": g_ms, "plain_ms": front["gamma_plain_ms"], "bound_ms": g_bound,
        "bound_by": g_by, "library_ms": None,
        "plain_input": f"two full-size pairs cut to their first "
                       f"{PREFIX_GAMMA_ROWS} rows",
        "ms_on_plain_input": front["gamma_ms"],
        "bound_ms_on_plain_input": front["gamma_bound"],
        "anchored_launches": runs["anchored"]["launches"][0],
        "instance": gm.instance_for(prep8["W_max"]),
        "anchored_ms": gt["warp"]["anchored"],
        "latency_floor_ms": gf["wave"],
        "anchored_latency_floor_ms": gf["anchored"],
        "latency_floor_ms_at_lse": gf["wave_at_lse"],
        "latencies": gf["lat"],
        "cycles_per_row": {k: v["consumer"] for k, v in
                           gt["warp"]["cycles"].items()},
    }, {
        "name": "pair_prefix", "route": "cuda",
        "source": "poreover_tpu_torch/csrc/pair_prefix.cu",
        "replaces": "poreover_tpu/ops/pair_prefix.py:36 (_extend_all) and "
                    ":59 (_level_step), XLA, not Pallas kernels",
        "launches": runs["envelope"]["launches"][1], "max_abs_err": 0.0,
        "ms": l_ms, "plain_ms": full["level_plain_ms"], "bound_ms": l_bound,
        "bound_by": l_by, "library_ms": None,
        "plain_input": f"two full-size pairs, first {PREFIX_PLAIN_LEVELS} "
                       "levels (per level step)",
        "ms_on_plain_input": full["level_ms"],
        "host_ms_per_level": host_ms,
        "anchored_launches": runs["anchored"]["launches"][1],
        "e2e_s": runs["envelope"]["wall"],
        "anchored_e2e_s": runs["anchored"]["wall"],
        "identity_to_truth": runs["envelope"]["ids"],
        "anchored_identity_to_truth": runs["anchored"]["ids"],
    }]


def first_look_prefix():
    """``--first-look prefix``: phase 18 alone (a few minutes): the two
    kernels' builds and ptxas reports, their ``cuda``-marked tests of
    tests/test_torch_kernel.py, then ``prefix_phase`` (phase 3's beam
    consensus decoded first, for the identities). Prints the kernels
    line, no result line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from poreover_tpu_torch import build, native
    from poreover_tpu_torch.ops import gamma as gm
    from poreover_tpu_torch.ops import pair_prefix as pps
    from poreover_tpu_torch.sim import write_pairs

    gpu = gpu_line()
    log(gpu)
    log(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    native.load()
    gm.load_kernel()
    pps.load_kernel()
    log(f"build {time.perf_counter() - t0:.1f} s")
    for name in ("pair_gamma", "pair_prefix"):
        for line in build.ptxas_report(name):
            log(f"ptxas {name}: {line}")
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-k", "gamma or level", "-p", "no:cacheprovider", "-p",
         "no:warnings", "--tb=short",
         os.path.join(HERE, "tests", "test_torch_kernel.py")],
        capture_output=True, text=True, cwd=HERE)
    log(tests.stdout.strip().splitlines()[-1])
    if tests.returncode != 0:
        fail(f"the prefix tests: {tests.stdout[-4000:]}{tests.stderr[-2000:]}")
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, truth = write_pairs(d, 8, seed=7, lo=5200, hi=8200)
        cons = pair_decode_cli(d, pairs_txt, "poreover", "w")[0]
    log(json.dumps({"kernels": prefix_phase(gpu, truth, cons)}))


def first_look_gamma():
    """``--first-look gamma``: the gamma kernel alone (a few minutes): its
    builds and ptxas report, its ``cuda`` tests of
    tests/test_torch_kernel.py, ``gamma_width_cases``, then
    ``gamma_timings`` on phase 18's launches. Prints no result."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from poreover_tpu_torch import build, native
    from poreover_tpu_torch.ops import gamma as gm
    from poreover_tpu_torch.sim import write_pairs

    gpu = gpu_line()
    log(gpu)
    log(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    ths = [threading.Thread(target=f) for f in (
        native.load, gm.load_kernel, lambda: gm.load_kernel(True),
        lambda: build.build_kernel("latency"))]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    gm.load_kernel()
    gm.load_kernel(True)
    log(f"build {time.perf_counter() - t0:.1f} s")
    for line in build.ptxas_report("pair_gamma"):
        log(f"ptxas pair_gamma: {line}")
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-k", "gamma", "-p", "no:cacheprovider", "-p", "no:warnings",
         "--tb=short", os.path.join(HERE, "tests", "test_torch_kernel.py")],
        capture_output=True, text=True, cwd=HERE)
    log(tests.stdout.strip().splitlines()[-1])
    if tests.returncode != 0:
        fail(f"the gamma tests: {tests.stdout[-4000:]}{tests.stderr[-2000:]}")
    gamma_width_cases()
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, _ = write_pairs(d, 8, seed=7, lo=5200, hi=8200)
        wave, searches = gamma_searches(d, pairs_txt)
    gamma_timings(gpu, wave, searches, GAMMA_INSTANCES)


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


# ---- phase 19: the by-row pair beam search (--beam_search_method row)
ROW_PLAIN_ROWS = 500  # rows per workload the plain version holds the kernel on
ROW_SEED = 23  # phase 19(d): the small pairs against --device cpu
# log-add-exp chains on a sweep's dependent path: ctc one, bonito two in
# sequence (the total chain takes the no-gap chain), flip-flop two
# independent ones
ROW_CHAINS = {0: 1, 1: 2, 2: 1}


def row_bytes(prep) -> int:
    """Bytes a by-row wave must move: of each workload's inputs only what
    its rows read (y1 and cum1 up to its last row u0 + R - 1; y2 and cum2
    from its rows' first rs to their last re, and column 0, where its root
    starts), its rows and meta once; beam_src, the final table and the
    traceback written once. A wave cut to its first rows (``n_rows``)
    keeps whole reads in its packed tensors but reads only this."""
    from poreover_tpu_torch.ops.beam2d import RM_R, RM_ROW, RM_U, RM_U0

    W, A = prep["W"], prep["A"]
    C = W * (A + 1)
    m, rows = prep["meta"], prep["rows"].astype(np.int64)
    B, n = len(m), len(rows)
    # an emission row and its cumulative gap mass
    per = (prep["y1"].shape[1] + 1) * prep["y1"].itemsize
    cols = 0
    for b in range(B):
        r = rows[m[b, RM_ROW]:m[b, RM_ROW] + m[b, RM_R]]
        n1 = min(int(m[b, RM_U]), int(m[b, RM_U0] + m[b, RM_R]))
        lo, hi = (int(r[:, 0].min()), int(r[:, 1].max())) if len(r) \
            else (0, 1)
        cols += max(n1, 1) + (hi - lo) + (lo > 0)
    return (cols * per + prep["rows"].nbytes + m.nbytes
            + n * (2 * W + 1) + B * (5 * C + 1))


def row_bound_ms(prep) -> tuple[float, str, str]:
    """Least time for a by-row wave: bytes (``row_bytes``) over HBM
    bandwidth, vs float ops over f32 peak: per row the C candidates (the
    table is full after the first rows) times the row's in-range cells,
    at OPS_PER_CELL (the same chains as the pair kernel's sweeps).
    Returns (ms, what bounds it, a line with both terms)."""
    W, A = prep["W"], prep["A"]
    C = W * (A + 1)
    rows = prep["rows"].astype(np.int64)
    nbytes = row_bytes(prep)
    cells = int(C * np.clip(rows[:, 1] - rows[:, 0], 0, None).sum())
    ops_cell = OPS_PER_CELL[prep["model_id"]]
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = cells * ops_cell / F32_FLOPS * 1e3
    terms = (f"{nbytes} bytes -> {t_bytes:.4g} ms; {cells * ops_cell} "
             f"float ops ({cells} swept cells x {ops_cell}) -> {t_ops:.4g} "
             "ms")
    return (t_bytes, "bytes", terms) if t_bytes >= t_ops else \
        (t_ops, "operations", terms)


def scan_levels(n):
    """Levels of the odd/even scan tree over n elements that hold a
    log-add-exp: up, one per halving while two remain; down, one per
    level with an even element past the first."""
    n = np.asarray(n, np.int64)
    up = np.zeros(n.shape, np.int64)
    down = np.zeros(n.shape, np.int64)
    s = 1
    while True:
        more = (n // s) >= 2
        if not more.any():
            break
        up += more
        down += (n // s) >= 3
        s *= 2
    return up + down


def row_floor_ms(prep, lat, mhz) -> float:
    """A launch's latency floor (the longest workload's chain): per row,
    two layers of sweeps (a child's after its parent's, every row has
    both), each ROW_CHAINS[model] scans over the row's in-range cells
    and its seed, a log-add-exp a level (``lat["lse"]``, common.cuh:lse),
    at ``mhz``."""
    rows = prep["rows"].astype(np.int64)
    per_row = (2 * ROW_CHAINS[prep["model_id"]] * lat["lse"]
               * scan_levels(np.clip(rows[:, 1] - rows[:, 0], 0, None) + 1))
    m = prep["meta"]
    from poreover_tpu_torch.ops.beam2d import RM_R, RM_ROW

    return max(float(per_row[o:o + n].sum()) for o, n in
               zip(m[:, RM_ROW], m[:, RM_R])) / (mhz * 1e3)


def compare_rows(name, prep, storage=None):
    """The by-row kernel (``pair_row_beam._launch``, counted nowhere)
    against its plain version ``beam2d.row_scan`` on the card, on a
    prepared wave: every row's beam_src, the final validity and the
    traceback equal, the final scores bit for bit (both run the same ops
    in the same order). Returns (kernel ms, plain ms, max abs error)."""
    import torch
    from poreover_tpu_torch.ops import beam2d
    from poreover_tpu_torch.ops import pair_row_beam as prb

    args = (*prep["dev"], prep["meta"], prep["W"], prep["A"],
            prep["model_id"])
    k, k_ms = timed(lambda: prb._launch(*args, storage=storage))
    p, p_ms = timed(lambda: beam2d.row_scan(*args))
    k, p = [[x.cpu() for x in o] for o in (k, p)]
    for what, a, b in zip(("beam_src", "score", "valid", "chars", "first"),
                          k, p):
        if what == "score":
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            fail(f"{name}: the kernel's {what} differs from the plain "
                 f"version's (first at {bad})")
    fin = torch.isfinite(p[1])
    err = float((k[1] - p[1])[fin].abs().max()) if fin.any() else 0.0
    rows = prep["meta"][:, 5]
    log(f"  {name}: kernel = plain version ({len(rows)} workloads, "
        f"{int(rows.sum())} rows, storage {storage or 'by size'}: every "
        f"beam_src row, traceback, final validity and score bits); kernel "
        f"{k_ms:.1f} ms, plain {p_ms:.1f} ms")
    return k_ms, p_ms, err


def row_phase(gpu, truth, cons_rowcol, waves, ctc_boxes, cpu_ref):
    """Phase 19: ``pair-decode --beam_search_method row``. (a) phase 3's 8
    pairs through the CLI with ``--beam_search_method row`` and then with
    ``--skip_matches --skip_threshold 10`` (counts zeroed just before,
    read just after: the by-row kernel launched); 8/8 records, no skip;
    the single-pair entry on pair 0 equal to the CLI's consensus. (b) the
    kernel on the full-size waves ``waves`` (phase 3's CTC pairs, phase
    10's bonito and flip-flop pairs, their envelopes as built there)
    through the library entry (one launch each), timed per wave and row,
    with its bound and latency floor; phase 8's anchored boxes
    (``ctc_boxes``) timed in one launch. (c) the kernel bit-equal to its
    plain version on the card: each wave and the anchored boxes cut to
    their first ROW_PLAIN_ROWS rows, the CTC cut once more with its
    storage forced into global scratch. (d) two small pairs
    byte-identical to ``--device cpu`` (``cpu_ref``, run in a CPU
    worker). (e) each consensus's identity to the truth beside row_col's
    (``cons_rowcol``; none in the first look), recorded, not gated.
    Returns the kernels line's entries, one per kind."""
    import torch
    from poreover_tpu_torch.ops import pair_row_beam as prb
    from poreover_tpu_torch.ops.beam2d import RM_R, beam_search_2d
    from poreover_tpu_torch.sim import write_pairs

    t19 = time.perf_counter()
    lat, mhz = instruction_latencies(), sm_clock_mhz()
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, _ = write_pairs(d, 8, seed=7, lo=5200, hi=8200)
        runs = {}
        for name, extra in (("row", ()), ("anchored", (
                "--skip_matches", "--skip_threshold", "10"))):
            zero_counts()
            cons, _, rows, wall, tm = pair_decode_cli(
                d, pairs_txt, "poreover", name,
                ("--beam_search_method", "row", *extra))
            n_l = prb.launch_count
            if n_l < 1:
                fail(f"pair-decode --beam_search_method row ({name}) "
                     "launched the by-row kernel no time")
            if len(cons) != 8 or any(r[-1] != "0" for r in rows):
                fail(f"--beam_search_method row ({name}): expected 8 "
                     f"consensus records and no skips; got {len(cons)}, "
                     f"log rows {rows}")
            runs[name] = (cons, n_l)
            log(f"phase 19 pair-decode --beam_search_method row ({name}): 8 "
                f"pairs, {n_l} by-row launch(es), end-to-end {wall:.2f} s "
                f"({8 / wall:.2f} pairs/s); stages "
                + " ".join(f"{k}={v:.3f}s" for k, v in tm.items()))
    cons_row, launches = runs["row"]
    ids = [identity(c, t) for c, t in zip(cons_row, truth)]
    aids = [identity(c, t) for c, t in zip(runs["anchored"][0], truth)]
    line = "  identity to the truth, row / anchored row"
    if cons_rowcol is not None:
        line += " / row_col"
        rc = [identity(c, t) for c, t in zip(cons_rowcol, truth)]
    else:
        rc = [None] * 8
    log(line + ": " + " ".join(
        f"{a:.4f}/{b:.4f}" + ("" if c is None else f"/{c:.4f}")
        for a, b, c in zip(ids, aids, rc)) + " (recorded, not gated)")
    zero_counts()
    got = beam_search_2d(*waves["poreover"][0], beam_width=5, method="row",
                         device=DEVICE)
    if prb.launch_count != 1 or got != cons_row[0]:
        fail(f"the single-pair entry ({prb.launch_count} launches) differs "
             "from pair-decode's row consensus of pair 0")
    log("  single-pair entry beam_search_2d(method='row'): pair 0 equal to "
        "pair-decode's, 1 launch")

    entries = []
    for kind in ("poreover", "bonito", "flipflop"):
        model = KIND_MODEL[kind]
        wave = waves[kind]
        prep = prb.prepare_rows(wave, device=DEVICE, model=model)
        rows = prep["meta"][:, RM_R]
        if kind == "poreover":
            n_l = launches
        else:
            zero_counts()
            seqs = prb.pair_row_beam(wave, device=DEVICE, model=model)
            n_l = prb.launch_count
            if n_l != 1 or len(seqs) != 8:
                fail(f"{kind}: the by-row entry gave {n_l} launches, "
                     f"{len(seqs)} strings")
            # the JAX package's by-row engine collapses some of these
            # pairs to a few bases too (ROADMAP §C): recorded, not gated
            log(f"  {kind}: the by-row entry, 1 launch, consensus lengths "
                f"{[len(q) for q in seqs]}")
        args = (*prep["dev"], prep["meta"], prep["W"], prep["A"],
                prep["model_id"])
        if kind != "poreover" and prb.fetch_prepared(
                prep, prb._launch(*args)) != seqs:
            fail(f"{kind}: a second launch of the wave spells other strings")
        wave_ms = event_ms(lambda: prb._launch(*args), reps=2)
        bound, by, terms = row_bound_ms(prep)
        floor = row_floor_ms(prep, lat, mhz)
        log(f"  [{gpu}] by-row kernel, {kind}: {wave_ms:.1f} ms per 8-pair "
            f"wave, {wave_ms * 1e3 / rows.max():.2f} us per row of the "
            f"longest pair ({int(rows.max())} rows; storage "
            f"{prb.storage_path(prep)}, widest window "
            f"{int(prep['meta'][:, 7].max())}); bound {bound:.4f} ms "
            f"({by}; {terms}); latency floor {floor:.3f} ms (two layers of "
            f"{ROW_CHAINS[prep['model_id']]} scan(s) a row at lse "
            f"{lat['lse']:.1f} cycles, {mhz:.0f} MHz), the kernel "
            f"{wave_ms / floor:.1f}x it")
        cut = prb.prepare_rows(wave, device=DEVICE, model=model,
                               n_rows=[ROW_PLAIN_ROWS] * len(wave))
        k_ms, p_ms, err = compare_rows(
            f"{kind} wave, first {ROW_PLAIN_ROWS} rows per pair", cut)
        cut_bound, cut_by, cut_terms = row_bound_ms(cut)
        log(f"    bound on that cut {cut_bound:.5f} ms ({cut_by}; "
            f"{cut_terms})")
        entry = {
            "name": f"row_beam ({model})", "kinds": [model],
            "route": "cuda",
            "source": "poreover_tpu_torch/csrc/pair_row_beam.cu",
            "replaces": "poreover_tpu/ops/beam2d.py:379 (_beam2d_row_scan, "
                        "a lax.scan, not a Pallas kernel)",
            "launches": n_l, "max_abs_err": err, "ms": wave_ms,
            "us_per_row": wave_ms * 1e3 / int(rows.max()),
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "latency_floor_ms": floor, "library_ms": None,
            "plain_input": f"the wave's first {ROW_PLAIN_ROWS} rows per pair",
            "ms_on_plain_input": k_ms,
            "bound_ms_on_plain_input": cut_bound,
        }
        if kind == "poreover":
            g_ms, _, _ = compare_rows(
                f"{kind} wave, first {ROW_PLAIN_ROWS} rows, storage in "
                "global scratch", cut, storage="global")
            bprep = prb.prepare_rows(ctc_boxes, device=DEVICE)
            bargs = (*bprep["dev"], bprep["meta"], 5, 4, 0)
            box_ms = event_ms(lambda: prb._launch(*bargs), reps=2)
            brows = bprep["meta"][:, RM_R]
            log(f"  [{gpu}] by-row kernel, phase 8's {len(ctc_boxes)} "
                f"anchored boxes in one launch: {box_ms:.1f} ms (rows per "
                f"box median {np.median(brows):.0f}, max {brows.max()}; "
                f"bound {row_bound_ms(bprep)[0]:.4f} ms, latency floor "
                f"{row_floor_ms(bprep, lat, mhz):.3f} ms)")
            bcut = prb.prepare_rows(ctc_boxes, device=DEVICE,
                                    n_rows=[ROW_PLAIN_ROWS] * len(ctc_boxes))
            compare_rows(f"the anchored boxes, first {ROW_PLAIN_ROWS} rows "
                         "per box", bcut)
            entry.update(global_ms_on_plain_input=g_ms,
                         anchored_ms=box_ms,
                         anchored_launches=runs["anchored"][1])
            del bprep, bcut
        entries.append(entry)
        del prep, cut
    # ---- two small pairs on the card against --device cpu
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, _ = write_pairs(d, 2, seed=ROW_SEED, lo=250, hi=320)
        dig = digest(d, sorted(os.listdir(d)))
        on_card = pair_decode_cli(d, pairs_txt, "poreover", "card",
                                  ("--beam_search_method", "row"))
        if len(on_card[0]) != 2:
            fail(f"row: {len(on_card[0])} consensus records of 2 pairs")
        ref = same_as_cpu_ref("--beam_search_method row", dig, cpu_ref, {
            suf: os.path.join(d, "card" + suf)
            for suf in (".1d.fasta", ".2d.fasta", ".log")})
        log(f"  2 pairs of ~300 bases byte-identical to --device cpu "
            f"(.1d.fasta, .2d.fasta, .log); card {on_card[3]:.2f} s, cpu "
            f"{ref[2]:.2f} s")
    torch.cuda.synchronize()
    log(f"  phase 19: {time.perf_counter() - t19:.0f} s")
    return entries


def first_look_row():
    """``--first-look row``: phase 19 alone (a few minutes): the by-row
    kernel's build and ptxas report, its ``cuda`` tests
    (tests/test_torch_row_kernel.py), then ``row_phase`` on inputs made
    here (phase 3's pairs, phase 8's anchored boxes and phase 10's waves,
    from the same seeds; no row_col consensus beside the identities).
    Prints the kernels line, no result line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from poreover_tpu_torch import build, native
    from poreover_tpu_torch.ops import pair_row_beam as prb
    from poreover_tpu_torch.sim import write_pairs

    gpu = gpu_line()
    log(gpu)
    log(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    loads = [native.load, prb.load_kernel,
             lambda: build.build_kernel("latency")]
    ths = [threading.Thread(target=f) for f in loads]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    for f in loads:  # raises here if a build failed in its thread
        f()
    log(f"build {time.perf_counter() - t0:.1f} s")
    for line in build.ptxas_report("pair_row_beam"):
        log(f"ptxas pair_row_beam: {line}")
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-p", "no:cacheprovider", "-p", "no:warnings", "--tb=short",
         os.path.join(HERE, "tests", "test_torch_row_kernel.py")],
        capture_output=True, text=True, cwd=HERE)
    log(tests.stdout.strip().splitlines()[-1])
    if tests.returncode != 0:
        fail(f"the by-row tests: {tests.stdout[-4000:]}{tests.stderr[-2000:]}")
    waves = {}
    with tempfile.TemporaryDirectory() as d:
        pairs_txt, truth = write_pairs(d, 8, seed=7, lo=5200, hi=8200)
        files = pair_files(pairs_txt)
        waves["poreover"] = [workload_of(d, r1, r2) for r1, r2 in files]
        boxes = [b for r1, r2 in files
                 for b in anchored_boxes_of(d, r1, r2)[0]]
    for kind in ("bonito", "flipflop"):
        waves[kind] = sim_workloads(8, seed=7, lo=5200, hi=8200, kind=kind)
    cpu_ref = InProcess(cpu_pair_ref, "poreover", 2, ROW_SEED, 250, 320,
                        ("--beam_search_method", "row"))
    log(json.dumps({"kernels": row_phase(gpu, truth, None, waves, boxes,
                                         cpu_ref)}))


# ---- phase 20: the dense boxes of pair-decode --method split|align
DENSE_SEED = 32  # phase 20(d): two small pairs (both with anchors) vs the CPU
DENSE_SPLIT_BOXES = 3  # pair 0's whole split boxes held per kind
DENSE_ROWS = 200  # rows of the widest align box held, at its width
DENSE_GAMMA_SPLIT = 4  # pair 0's split boxes the gamma kernel is held on
# align boxes of about this width the gamma kernel is held on too (two)
DENSE_GAMMA_ALIGN_W = 1000
DENSE_LEVELS = 30  # first levels of the align boxes' search held and timed
# rows of the widest align box and of the wide split box the gamma and
# level kernels are held on, at their width
DENSE_PREFIX_ROWS = 400
# pair 0's first split box at this --window (12000 x 11813) is too wide
# for a CTA's shared memory: the gamma DP's wide instance in global scratch
DENSE_WIDE_WINDOW = 12000
DENSE_METHODS = ("split", "align")


def dense_boxes_of(d, r1, r2, kind, method, window=None):
    """The port's stages for one pair under ``--method method`` (and
    ``--window window``) up to the 2D searches: the pair's dense by-row
    workloads [(y1, y2, None)] (the boxes' lines printed to stderr are
    dropped)."""
    from poreover_tpu_torch.cli import build_parser
    from poreover_tpu_torch.decoding.pair import pair_decode_helper

    args = build_parser().parse_args(
        ["pair-decode", r1, r2, "--dir", d, "--basecaller",
         BASECALLER[kind], "--reverse_complement", "--method", method,
         "--device", DEVICE]
        + ([] if window is None else ["--window", str(window)]))
    got = []
    with contextlib.redirect_stderr(io.StringIO()):
        pair_decode_helper(args, _workload_sink=lambda *a: got.append(a))
    if not got:
        fail(f"--method {method}: pair {r1} {r2} has no box to search")
    return got[0][0]


def dense_cases(kind):
    """Phase 20(c)'s inputs of the kind, from phase 3's seed (phase 10's
    pairs for bonito and flip-flop), as by-row workloads (y1, y2, None):
    pair 0's split boxes, the align boxes of the 8 pairs and, for CTC,
    pair 0's first split box at ``--window DENSE_WIDE_WINDOW``."""
    from poreover_tpu_torch.sim import write_pairs

    with tempfile.TemporaryDirectory() as d:
        pairs_txt, _ = write_pairs(d, 8, seed=7, lo=5200, hi=8200,
                                   kind=kind)
        files = pair_files(pairs_txt)
        split = dense_boxes_of(d, *files[0], kind, "split")
        align = [b for r1, r2 in files
                 for b in dense_boxes_of(d, r1, r2, kind, "align")]
        wide = dense_boxes_of(d, *files[0], kind, "split",
                              DENSE_WIDE_WINDOW)[0] \
            if kind == "poreover" else None
    return split, align, wide


def full_envelopes(wls):
    """The prefix search's dense workloads: (y1, y2, [[0, V]] * U)."""
    return [(y1, y2, np.tile(np.array([0, len(y2)], np.int64),
                             (len(y1), 1))) for y1, y2, *_ in wls]


def dense_job(kind):
    """Phase 20(c), in a card worker: the kind's dense boxes made once
    (``dense_cases``), the by-row kernel held on them
    (``dense_row_checks``) and, for CTC, the gamma DP and the level
    kernel (``dense_prefix_checks``). Returns what was held."""
    split, align, wide = dense_cases(kind)
    out = dense_row_checks(kind, split, align)
    if kind == "poreover":
        out["prefix"] = dense_prefix_checks(split, align, wide)
    return out


def dense_row_checks(kind, split, align):
    """The by-row kernel against its plain version on dense boxes
    (``compare_rows``): pair 0's first DENSE_SPLIT_BOXES split boxes
    whole (storage in shared memory), and the widest align box of the 8
    pairs cut to its first DENSE_ROWS rows at its width (storage in
    global scratch)."""
    from poreover_tpu_torch.ops import pair_row_beam as prb
    from poreover_tpu_torch.ops.beam2d import RM_WB

    model = KIND_MODEL[kind]
    wide = max(align, key=lambda b: len(b[1]))
    out = {"max_abs_err": 0.0}
    for name, wls, n_rows, path in (
            (f"{DENSE_SPLIT_BOXES} whole split boxes",
             split[:DENSE_SPLIT_BOXES], None, "shared"),
            (f"the widest align box ({len(wide[0])} x {len(wide[1])}), "
             f"first {DENSE_ROWS} rows", [wide], [DENSE_ROWS], "global")):
        prep = prb.prepare_rows(wls, device=DEVICE, model=model,
                                n_rows=n_rows)
        if prb.storage_path(prep) != path:
            fail(f"phase 20 {kind}: {name} take the {prb.storage_path(prep)}"
                 f" path, not {path}")
        _, _, err = compare_rows(f"phase 20(c) {kind} dense, {name}, widest "
                                 f"window {int(prep['meta'][:, RM_WB].max())}",
                                 prep)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out[path] = name
    return out


def dense_prefix_checks(split, align, wide):
    """The gamma kernel's wide instance and the level kernel against
    their plain versions on dense CTC boxes: the gamma DP's G and
    gamma(0,0) bit for bit, every level's outputs of the search's first
    DENSE_LEVELS levels (all of the split boxes'). The boxes: pair 0's
    first DENSE_GAMMA_SPLIT split boxes and the two align boxes nearest
    DENSE_GAMMA_ALIGN_W columns wide (rows in shared memory under the
    default 48 KB); the widest align box (the widest band of the align
    run's searches) cut to its first DENSE_PREFIX_ROWS rows at its width
    (shared memory past 48 KB); the first split box at ``--window
    DENSE_WIDE_WINDOW`` cut the same way (global scratch). Returns what
    was held."""
    import torch
    from poreover_tpu_torch.ops import gamma as gm

    def cut(b):
        return b[0][:DENSE_PREFIX_ROWS], b[1], None

    widest = max(align, key=lambda b: len(b[1]))
    near = sorted(align, key=lambda b: abs(len(b[1]) - DENSE_GAMMA_ALIGN_W))
    cases = (("split", split[:DENSE_GAMMA_SPLIT], None, "shared"),
             ("align", near[:2], DENSE_LEVELS, "shared"),
             (f"widest align, first {DENSE_PREFIX_ROWS} rows", [cut(widest)],
              DENSE_LEVELS, "opt-in shared"),
             (f"--window {DENSE_WIDE_WINDOW} split, first "
              f"{DENSE_PREFIX_ROWS} rows", [cut(wide)], DENSE_LEVELS,
              "global"))
    lib = gm.load_kernel()
    out = {}
    for name, boxes, n_levels, where in cases:
        wls = full_envelopes(boxes)
        prep = gm.prepare_gamma(wls, device=DEVICE)
        W = prep["W_max"]
        smem = 4 * lib.pair_gamma_wide_floats(W)
        got = gm.wide_storage(W)
        if got == "shared" and smem > 48 * 1024:
            got = "opt-in shared"
        if gm.instance_for(W) != "wide" or got != where:
            fail(f"phase 20(c) gamma, {name} boxes (W {W}): the "
                 f"{gm.instance_for(W)} instance, rows in {got}, not the "
                 f"wide one in {where}")
        same_gamma(f"phase 20(c) gamma wide, {name} boxes, rows in {where}",
                   prep, gm.gamma_cuda(prep), gm.gamma_plain(prep)[1:])
        tk, tpl = [], []
        k_res, _, n_k = clocked_search(wls, n_levels, trace=tk)
        p_res, _, n_p = clocked_search(wls, n_levels, route="plain",
                                       trace=tpl)
        if k_res != p_res or n_k != n_p or not all(
                np.array_equal(a.view(np.int32), b.view(np.int32))
                for a, b in zip(tk, tpl)):
            fail(f"phase 20(c) levels, {name} boxes: the level kernel "
                 "differs from its plain version")
        torch.cuda.synchronize()
        shapes = [f"{len(y1)}x{len(y2)}" for y1, y2, _ in wls]
        log(f"  phase 20(c) dense {name} boxes {shapes}: gamma wide "
            f"instance (W {W}, {smem} B of rows a CTA, in {where} memory) "
            f"bit-equal to the plain version; {n_k} levels of the level "
            "kernel bit-equal")
        out[name] = dict(W=W, rows_in=where, levels=n_k)
    return out


@contextlib.contextmanager
def recorded(mod, name, launch, into):
    """Inside the block each call of ``mod.name`` appends its first
    argument (the prepared launch) and two CUDA events to ``into``: those
    recorded just before and after its call of ``launch`` of the module's
    kernel library, on the stream the kernel goes to. The span is the
    kernel's time in the run itself, without the wrapper's checks,
    allocations and uploads (the host enqueues the kernel within
    microseconds of the first event)."""
    import torch

    inner, lib = getattr(mod, name), mod.load_kernel()
    inner_launch = getattr(lib, launch)
    spans = []

    def timed_launch(*a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        err = inner_launch(*a)
        e1.record()
        spans.append((e0, e1))
        return err

    def rec(*a, **k):
        n = len(spans)
        out = inner(*a, **k)
        ((e0, e1),) = spans[n:]
        into.append((a[0], e0, e1))
        return out

    setattr(mod, name, rec)
    setattr(lib, launch, timed_launch)
    try:
        yield into
    finally:
        setattr(mod, name, inner)
        setattr(lib, launch, inner_launch)


def dense_run(d, pairs_txt, kind, method, algorithm):
    """One ``pair-decode --method method --algorithm algorithm`` run of
    ``pairs_txt`` (``--threads 8``; counts zeroed just before, read just
    after), its box lines kept from stderr. Gates: 8 records, no skip,
    the kernels of its path launched. Returns a dict: consensi, wall,
    stages, launches, boxes, and its by-row and gamma launches (each
    prep and its ms)."""
    from poreover_tpu_torch.ops import gamma as gm
    from poreover_tpu_torch.ops import pair_prefix as pps
    from poreover_tpu_torch.ops import pair_row_beam as prb

    zero_counts()
    pps.levels_run.clear()
    row_preps, gamma_preps = [], []
    err = io.StringIO()
    with recorded(prb, "launch_prepared", "pair_row_beam_launch",
                  row_preps), \
            recorded(gm, "gamma_cuda", "pair_gamma_launch", gamma_preps), \
            contextlib.redirect_stderr(err):
        cons, _, rows, wall, tm = pair_decode_cli(
            d, pairs_txt, BASECALLER[kind], f"{method}_{algorithm}",
            ("--method", method, "--algorithm", algorithm))
    n_box = sum("Basecalling box" in x for x in err.getvalue().splitlines())
    skipped = [r for r in rows if len(r) > 2 and r[-1] != "0"]
    if len(cons) != 8 or len(rows) != 8 or skipped:
        fail(f"phase 20 {kind} --method {method} --algorithm {algorithm}: "
             f"{len(cons)} consensus records, log rows {rows}")
    n = dict(row=prb.launch_count, gamma=gm.launch_count,
             level=pps.launch_count)
    need = ("row",) if algorithm == "beam" else ("gamma", "level")
    if any(n[k] < 1 for k in need):
        fail(f"phase 20 {kind} --method {method} --algorithm {algorithm}: "
             f"launches {n}")
    log(f"phase 20 {kind} pair-decode --method {method} --algorithm "
        f"{algorithm}: 8 pairs, {n_box} boxes, launches {n}, end-to-end "
        f"{wall:.2f} s ({8 / wall:.2f} pairs/s); stages "
        + " ".join(f"{k}={v:.3f}s" for k, v in tm.items())
        + (f"; {sum(pps.levels_run)} levels over {len(pps.levels_run)} "
           f"searches (most {max(pps.levels_run)})"
           if algorithm == "prefix" else ""))
    spans = [[(p, e0.elapsed_time(e1)) for p, e0, e1 in x]
             for x in (row_preps, gamma_preps)]
    return dict(cons=cons, wall=wall, stages=tm, launches=n, boxes=n_box,
                row=spans[0], gamma=spans[1])


def dense_phase(gpu, truth, cons_full, checks, cpu_refs):
    """Phase 20: ``pair-decode --method split|align`` at full size, each
    box decoded densely. (a) phase 3's 8 CTC pairs with each method under
    ``--algorithm beam`` and ``prefix``; (b) phase 10's bonito and
    flip-flop pairs with each method under ``--algorithm beam`` (each run:
    ``dense_run``'s gates); (c) ``checks``: the kernels held to their
    plain versions on dense boxes in the card's workers
    (``dense_job``); (d) two small pairs with
    each method byte-identical to ``--device cpu`` (``cpu_refs``, run in
    CPU workers); (e) the by-row kernel's ms per dense-box wave of each
    run and its storage path, the gamma kernel's wide instance per launch
    (``recorded``'s events around each launch in the runs), the level
    kernel's ms per launch on the align boxes' largest search's first
    DENSE_LEVELS levels, and each CTC consensus's identity to the truth
    beside phase 3's (``cons_full``; none in the first look), recorded,
    not gated. Returns {kernel: {key: value}} to add to the kernels
    line's entries."""
    import torch
    from poreover_tpu_torch.ops import gamma as gm
    from poreover_tpu_torch.ops import pair_row_beam as prb
    from poreover_tpu_torch.ops.beam2d import RM_R, RM_WB
    from poreover_tpu_torch.sim import write_pairs

    t20 = time.perf_counter()
    runs = {}
    for kind, algorithms in (("poreover", ("beam", "prefix")),
                             ("bonito", ("beam",)), ("flipflop", ("beam",))):
        with tempfile.TemporaryDirectory() as d:
            pairs_txt, truth_k = write_pairs(d, 8, seed=7, lo=5200, hi=8200,
                                             kind=kind)
            for method in DENSE_METHODS:
                for alg in algorithms:
                    runs[kind, method, alg] = dense_run(d, pairs_txt, kind,
                                                        method, alg)
    for kind in ("poreover", "bonito", "flipflop"):
        checked = checks[kind]
        log(f"  phase 20(c) by-row kernel, {kind}: bit-equal on "
            f"{checked['shared']} (shared memory) and {checked['global']} "
            "(global scratch)")
    log(f"  phase 20(c) gamma wide instance and level kernel: "
        f"{checks['poreover']['prefix']}")
    # (d) two small pairs per method, the card against the CPU
    with tempfile.TemporaryDirectory() as d:
        spairs, _ = write_pairs(d, 2, seed=DENSE_SEED, lo=250, hi=320)
        dig = digest(d, sorted(os.listdir(d)))
        for method in DENSE_METHODS:
            with contextlib.redirect_stderr(io.StringIO()):
                got = pair_decode_cli(d, spairs, "poreover", f"c_{method}",
                                      ("--method", method))
            if len(got[0]) != 2:
                fail(f"phase 20(d) --method {method}: {len(got[0])} records")
            ref = same_as_cpu_ref(
                f"phase 20(d) --method {method}", dig,
                cpu_refs[method], {s: os.path.join(d, f"c_{method}{s}")
                                   for s in (".1d.fasta", ".2d.fasta",
                                             ".log")})
            log(f"phase 20(d) two small pairs, --method {method}: "
                f".1d/.2d.fasta and .log byte-identical to --device cpu "
                f"(card {got[3]:.2f} s, cpu {ref[2]:.2f} s)")
    # (e) the kernels' times on the runs' launches
    extra = {"row": {}, "gamma": {}, "level": {}}
    for (kind, method, alg), r in runs.items():
        if alg != "beam":
            continue
        ((prep, ms),) = r["row"]  # one wave: 8 pairs at --threads 8
        m = prep["meta"]
        path = prb.storage_path(prep)
        log(f"  [{gpu}] by-row kernel, {kind} --method {method}: {ms:.1f} "
            f"ms for the wave's {len(m)} dense boxes in one launch (storage "
            f"{path}; widest window {int(m[:, RM_WB].max())}, median "
            f"{int(np.median(m[:, RM_WB]))}; rows per box median "
            f"{int(np.median(m[:, RM_R]))}, most {int(m[:, RM_R].max())})")
        extra["row"].setdefault(KIND_MODEL[kind], {}).update({
            f"dense_{method}_ms": ms, f"dense_{method}_storage": path,
            f"dense_{method}_boxes": len(m),
            f"dense_{method}_launches": r["launches"]["row"],
            f"dense_{method}_e2e_s": r["wall"]})
    for method in DENSE_METHODS:
        r = runs["poreover", method, "prefix"]
        preps = [p for p, _ in r["gamma"]]
        ms = [t for _, t in r["gamma"]]
        bounds = [prefix_gamma_bound_ms(p)[0] for p in preps]
        insts = sorted({gm.instance_for(p["W_max"]) for p in preps})
        stores = sorted({gm.wide_storage(p["W_max"]) for p in preps})
        log(f"  [{gpu}] gamma kernel, --method {method} --algorithm prefix: "
            f"{len(preps)} launches (instances {insts}, wide rows in "
            f"{stores}), W {min(p['W_max'] for p in preps)}-"
            f"{max(p['W_max'] for p in preps)}: {sum(ms):.2f} ms in all, "
            f"most {max(ms):.3f} ms a launch; bytes bound {sum(bounds):.4f} "
            f"ms in all")
        extra["gamma"].update({
            f"dense_{method}_ms": sum(ms), f"dense_{method}_max_ms": max(ms),
            f"dense_{method}_launches": r["launches"]["gamma"],
            f"dense_{method}_bound_ms": sum(bounds),
            f"dense_{method}_instances": insts,
            f"dense_{method}_e2e_s": r["wall"]})
        extra["level"].update({
            f"dense_{method}_launches": r["launches"]["level"],
            f"dense_{method}_e2e_s": r["wall"]})
        if method == "align":
            big = max(preps, key=lambda p: p["W_max"])
            wls = [(big["y"][m[gm.M_O1]:m[gm.M_O1] + m[gm.M_U]].cpu().numpy(),
                    big["y"][m[gm.M_O2]:m[gm.M_O2] + m[gm.M_V]].cpu().numpy(),
                    big["env"][m[gm.M_EOFF]:m[gm.M_EOFF] + m[gm.M_U]]
                    .cpu().numpy().astype(np.int64)) for m in big["meta"]]
            _, l_ms, l_n = clocked_search(wls, DENSE_LEVELS)
            l_bound, l_by = prefix_level_bound_ms(big)
            log(f"  [{gpu}] level kernel, the align boxes' widest search "
                f"({len(wls)} boxes, W {big['W_max']}): {l_ms:.4f} ms a "
                f"launch over its first {l_n} levels (bound {l_bound:.4f} "
                f"ms, {l_by})")
            extra["level"].update(dense_align_ms=l_ms,
                                  dense_align_bound_ms=l_bound)
    ids = {}
    for method in DENSE_METHODS:
        for alg in ("beam", "prefix"):
            ids[method, alg] = [identity(c, t) for c, t in
                                zip(runs["poreover", method, alg]["cons"],
                                    truth)]
    line = "  identity to the truth, split beam / prefix, align beam / prefix"
    full = [None] * 8
    if cons_full is not None:
        line += " / envelope (phase 3)"
        full = [identity(c, t) for c, t in zip(cons_full, truth)]
    log(line + ": " + "  ".join(
        "/".join(f"{ids[k][i]:.4f}" for k in ids)
        + ("" if full[i] is None else f"/{full[i]:.4f}") for i in range(8))
        + " (recorded, not gated)")
    for kind in ("bonito", "flipflop"):
        log(f"  {kind} consensus lengths, split / align: " + " ".join(
            f"{len(a)}/{len(b)}" for a, b in zip(
                runs[kind, "split", "beam"]["cons"],
                runs[kind, "align", "beam"]["cons"])))
    extra["level"]["dense_identity_to_truth"] = {
        f"{m} {a}": v for (m, a), v in ids.items()}
    torch.cuda.synchronize()
    log(f"  phase 20: {time.perf_counter() - t20:.0f} s")
    return extra


def dense_check_jobs(job):
    """Phase 20(c)'s checks as jobs (``card_job``, or ``InProcess`` in the
    first look)."""
    return {k: job(dense_job, k) for k in ("poreover", "bonito",
                                          "flipflop")}


def first_look_split():
    """``--first-look split``: phase 20 alone (a few minutes): the builds
    of the by-row, gamma and level kernels, their ``cuda`` tests on dense
    boxes, then ``dense_phase`` on inputs made from the same seeds (its
    checks and CPU references in this process; no envelope consensus
    beside the identities). Prints the kernels line's phase-20 keys, no
    result line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from poreover_tpu_torch import build, native
    from poreover_tpu_torch.ops import gamma as gm
    from poreover_tpu_torch.ops import pair_prefix as pps
    from poreover_tpu_torch.ops import pair_row_beam as prb
    from poreover_tpu_torch.sim import write_pairs

    gpu = gpu_line()
    log(gpu)
    log(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    loads = [native.load, prb.load_kernel, gm.load_kernel, pps.load_kernel,
             lambda: build.build_kernel("viterbi"),
             lambda: build.build_kernel("latency")]
    ths = [threading.Thread(target=f) for f in loads]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    for f in loads:  # raises here if a build failed in its thread
        f()
    log(f"build {time.perf_counter() - t0:.1f} s")
    for kernel in ("pair_row_beam", "pair_gamma", "pair_prefix"):
        for line in build.ptxas_report(kernel):
            log(f"ptxas {kernel}: {line}")
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-p", "no:cacheprovider", "-p", "no:warnings", "--tb=short", "-k",
         "dense or past_shared or align_width or gamma or level",
         os.path.join(HERE, "tests", "test_torch_row_kernel.py"),
         os.path.join(HERE, "tests", "test_torch_kernel.py")],
        capture_output=True, text=True, cwd=HERE)
    log(tests.stdout.strip().splitlines()[-1])
    if tests.returncode != 0:
        fail(f"the dense-box tests: {tests.stdout[-4000:]}"
             f"{tests.stderr[-2000:]}")
    checks = {k: j.result() for k, j in dense_check_jobs(InProcess).items()}
    cpu_refs = {m: InProcess(cpu_pair_ref, "poreover", 2, DENSE_SEED, 250,
                             320, ("--method", m)) for m in DENSE_METHODS}
    with tempfile.TemporaryDirectory() as d:
        _, truth = write_pairs(d, 8, seed=7, lo=5200, hi=8200)
    log(json.dumps({"phase 20": dense_phase(gpu, truth, None, checks,
                                            cpu_refs)}))


def build_all():
    """Phase 1: the host runtime, the nine kernels, the instrumented
    builds of seven of them, and the latency probe (``csrc/latency.cu``), one compiler
    process each, in parallel; prints the compiler's register / spill
    report."""
    from poreover_tpu_torch import build, native
    from poreover_tpu_torch.ops import acceptor as ta
    from poreover_tpu_torch.ops import beam1d
    from poreover_tpu_torch.ops import box_beam as bb
    from poreover_tpu_torch.ops import ctc
    from poreover_tpu_torch.ops import gamma as gm
    from poreover_tpu_torch.ops import pair_beam_batch as pbb
    from poreover_tpu_torch.ops import pair_prefix as pps
    from poreover_tpu_torch.ops import pair_row_beam as prb
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
                     ctc.load_kernel, gm.load_kernel, pps.load_kernel,
                     prb.load_kernel, lambda: ctc.load_kernel(True),
                     lambda: gm.load_kernel(True),
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
                   "acceptor", "ctc", "pair_gamma", "pair_prefix",
                   "pair_row_beam"):
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

    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    start_workers("card", CARD_WORKERS)
    build_all()
    start_workers("cpu", CPU_WORKERS)

    # ---- phase 2: kernels vs plain versions on the card, in the card's
    # worker processes (started before the build), the longest jobs first;
    # phase 17's graveyard cases and the CPU references join them
    t2 = time.perf_counter()
    jobs = {"boxes": card_job(pair_batches_job, "boxes"),
            ("flipflop", "sims"): card_job(kind_phase2_job, "flipflop",
                                          "sims"),
            "sims": card_job(pair_batches_job, "sims")}
    for kind, part in (("bonito", "sims"), ("flipflop", "boxes"),
                       ("bonito", "boxes")):
        jobs[kind, part] = card_job(kind_phase2_job, kind, part)
    jobs.update({("exact", k): card_job(exact_cases, k)
                 for k in ("poreover", "bonito", "flipflop")})
    jobs["cases"] = card_job(pair_batches_job, "cases")
    jobs["box"] = card_job(box_cases_job)
    jobs.update({m: card_job(beam1d_cases, m)
                 for m in ("ctc", "ctc_merge_repeats", "ctc_flipflop")})
    jobs["viterbi"] = card_job(compare_viterbi)
    jobs["flipflop", "cases"] = card_job(kind_phase2_job, "flipflop",
                                        "cases")
    jobs["acceptor"] = card_job(compare_acceptor_cases)
    jobs["bonito", "cases"] = card_job(kind_phase2_job, "bonito", "cases")
    dense_jobs = dense_check_jobs(card_job)  # phase 20(c)
    jobs.update({("dense", k): j for k, j in dense_jobs.items()})
    cpu_refs = cpu_reference_jobs()

    stats = {"max_abs_err": 0.0}
    for which in ("cases", "boxes", "sims"):
        merge_stats(stats, jobs[which].result())
    log(f"  pair kernel sweeps in phase 2: {stats['narrow']} on the narrow "
        f"path (<= {pbb.NARROW_MAX} columns), {stats['general']} on the "
        "general path, counted from the plans")
    if not stats["narrow"] or not stats["general"]:
        fail("phase 2 does not exercise both sweep paths of the pair kernel")

    stats1d = {"max_abs_err": 0.0}
    for model in ("ctc", "ctc_merge_repeats", "ctc_flipflop"):
        merge_stats(stats1d, jobs[model].result())
    log(f"  1D hash sizes taken: "
        f"{sorted(1 << b for b in stats1d['hash_bits'])} buckets")
    if len(stats1d["hash_bits"]) < 2:
        fail("phase 2 does not exercise more than one 1D hash size")
    stats_box, overflow = jobs["box"].result()
    if not overflow:
        fail("no box of boxes.npz is over the storage limit: the reroute "
             "is not exercised")
    log(f"  the boxes over the limit {overflow} went through the "
        "pair kernel in 'boxes.npz' above, equal to their plain version")
    kstats = {k: {"max_abs_err": 0.0} for k in ("bonito", "flipflop")}
    kstats_box = {k: {"max_abs_err": 0.0} for k in ("bonito", "flipflop")}
    for kind in ("bonito", "flipflop"):
        for part in ("cases", "sims", "boxes"):
            st, st_box = jobs[kind, part].result()
            merge_stats(kstats[kind], st)
            merge_stats(kstats_box[kind], st_box)
        if not kstats[kind]["narrow"] or not kstats[kind]["general"]:
            fail(f"phase 2 does not exercise both sweep paths of the pair "
                 f"kernel for {kind}")
        if kstats[kind]["paths"] != {"shared", "global"}:
            fail(f"phase 2 does not put {kind} storage in both shared "
                 "memory and global scratch")
    jobs["viterbi"].result()
    jobs["acceptor"].result()
    exact_jobs = {k: jobs["exact", k] for k in ("poreover", "bonito",
                                               "flipflop")}
    for job in exact_jobs.values():
        job.wait()
    dense_checks = {k: j.result() for k, j in dense_jobs.items()}
    stop_workers("card")
    log(f"  the card's workers: {len(jobs)} jobs (phase 17's graveyard "
        f"cases among them), {sum(j.seconds for j in jobs.values()):.0f} s "
        f"of job time in {CARD_WORKERS} processes, "
        f"{time.perf_counter() - t2:.0f} s of wall time")
    log("  the jobs' seconds: " + ", ".join(
        f"{'/'.join(k) if isinstance(k, tuple) else k} {j.seconds:.1f}"
        for k, j in sorted(jobs.items(), key=lambda kj: -kj[1].seconds)))
    done("phase 2")

    # ---- phase 3: pair-decode at full size, through the CLI
    from poreover_tpu_torch.cli import main as cli_main
    from poreover_tpu_torch.sim import write_pairs, write_reads
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
    trie_job = cpu_job(trie_ref, wave)  # phase 17's reference
    t0 = time.perf_counter()
    oracle = native.pair_beam_row_col_cpu_emul(*wave[0], beam_width=5)
    ident = identity(cons0, oracle)
    log(f"  pair 0: consensus {len(cons0)} bases, f64 oracle "
        f"{len(oracle)} bases ({time.perf_counter() - t0:.1f} s), aligned "
        f"identity {ident:.6f}")
    if not np.isfinite(ident) or ident < 0.999:
        fail(f"pair 0 identity {ident} to the f64 oracle < 0.999")

    done("phase 3")

    # ---- phase 4: the single-pair entry
    from poreover_tpu_torch.ops.beam2d import beam_search_2d
    from poreover_tpu_torch.ops.beam2d_planned import (
        beam_search_2d_planned, build_plan, pack_pairs, plan_wst,
    )

    cs = pallas_cases()
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

    done("phase 4")

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
        *prep["dev"], prep["meta"], prep["W"], prep["A"], storage="global"),
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
    row_waves = {"poreover": wave}  # phase 19 times the by-row kernel on it
    del wave, prep, prep1, short, short1

    done("phase 5")

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
        bench_job = cpu_job(benchmark_phase, keep, truth3, truth)
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
    ll_i = int(np.argmin([len(y) for y in wave1d]))
    ll_steps = len(wave1d[ll_i])
    ll_job = cpu_job(likelihoods, wave1d[ll_i], {
        "beam": recs[f"r{ll_i}"], "viterbi": vrecs[f"r{ll_i}"],
        "true": truth[ll_i]})  # read at the end of phase 7
    for kind, basecaller in (("bonito", "bonito"), ("flipflop", "flappie")):
        with tempfile.TemporaryDirectory() as d:
            truth4 = write_reads(d, N_CPU_READS, seed=5, lo=900, hi=1000,
                                 kind=kind)
            inputs, dig = cpu_decode_inputs(d, kind)
            dig_ref, ref = cpu_refs["decode", kind].result()
            if dig_ref != dig:
                fail(f"decode {kind}: the CPU reference ran on other inputs")
            for alg in ("beam", "viterbi"):
                beam1d.launch_count = 0
                on_card, t_card, tm = decode_cli(d, inputs, basecaller, alg,
                                                 f"{alg}_cuda")
                n_l = beam1d.launch_count
                if alg == "beam" and n_l < 1:
                    fail(f"decode {kind} beam launched beam1d no time")
                b, t_cpu = ref[alg]  # --device cpu, in a CPU worker
                a = open(os.path.join(d, f"{alg}_cuda.fasta"), "rb").read()
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
    done("phase 6")

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
    ll, t_ll = ll_job.result()
    log(f"  read r{ll_i} ({ll_steps} steps): log-likelihood of the "
        f"beam's string {ll['beam']:.2f}, Viterbi's {ll['viterbi']:.2f}, "
        f"the true sequence's {ll['true']:.2f} ({t_ll:.1f} s in a CPU "
        "worker)")
    if not ll["beam"] >= ll["viterbi"]:
        fail(f"read r{ll_i}: the beam's string is less likely "
             f"({ll['beam']}) than Viterbi's ({ll['viterbi']})")
    done("phase 7")

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

    done("phase 8")

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
    ctc_boxes = all_boxes  # phase 19 times the by-row kernel on them
    del prep, as_pairs, anch, all_boxes, in_kernel
    done("phase 9")

    # ---- phase 10: pair-decode for bonito and flip-flop at full size
    kind_entries = []
    for kind in ("bonito", "flipflop"):
        kind_entries += pair_kind_full(kind, gpu, kstats[kind],
                                       kstats_box[kind],
                                       cpu_refs["pairs", kind], row_waves)
        done(f"phase 10 {kind}")

    # ---- phase 11: a pairs file of mixed kinds
    mixed_pairs_file()

    done("phase 11")

    # ---- phase 12: pair-decode --single beam at full size
    acc = single_beam_phase(gpu, truth3, cons_full,
                            {k: cpu_refs["single", k]
                             for k in ("bonito", "flipflop")})
    done("phase 12")

    # ---- phases 13-14: call at full width, then the fused decodes
    call_and_fused_phases(gpu)
    done("phase 14")

    # ---- phase 15: train at full width
    ctc_res = ctc_phase(gpu, train_windows(TRAIN_BATCH, seed=10))
    done("phase 15a")
    tr = train_phase(gpu)
    done("phase 15")

    # ---- phase 16: benchmark on phase 3's and phase 6's FASTA files
    bench_job.result()
    shutil.rmtree(keep)
    done("phase 16")

    # ---- phase 17: exact mode (pair-decode --exact) at full size
    full = {"poreover": full_ctc}
    for kind in ("bonito", "flipflop"):
        full[kind] = sim_workloads(2, seed=7, lo=5200, hi=8200, kind=kind)
    exact_entries = exact_phase(gpu, exact_kernel_cases(full, exact_jobs),
                                 cons_full, trie_job)
    del full, full_ctc
    done("phase 17")

    # ---- phase 18: pair prefix search (pair-decode --algorithm prefix)
    prefix_entries = prefix_phase(gpu, truth3, cons_full, cpu_refs["prefix"])
    done("phase 18")

    # ---- phase 19: the by-row search (pair-decode --beam_search_method row)
    row_entries = row_phase(gpu, truth3, cons_full, row_waves, ctc_boxes,
                            cpu_refs["row"])
    del row_waves, ctc_boxes
    done("phase 19")

    # ---- phase 20: the dense boxes of pair-decode --method split|align
    dense = dense_phase(gpu, truth3, cons_full, dense_checks,
                        {m: cpu_refs[m] for m in DENSE_METHODS})
    for e in row_entries:
        e.update(dense["row"][e["kinds"][0]])
        e["max_abs_err"] = max(e["max_abs_err"], dense_checks[next(
            k for k, m in KIND_MODEL.items()
            if m == e["kinds"][0])]["max_abs_err"])
    prefix_entries[0].update(dense["gamma"])
    prefix_entries[1].update(dense["level"])
    done("phase 20")

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
    }] + exact_entries + prefix_entries + row_entries
    stop_workers()
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - T_START:.0f} s")
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
    elif argv == ["--first-look", "prefix"]:
        first_look_prefix()
    elif argv == ["--first-look", "gamma"]:
        first_look_gamma()
    elif argv == ["--first-look", "row"]:
        first_look_row()
    elif argv == ["--first-look", "split"]:
        first_look_split()
    elif argv == ["--first-look", "dp"]:
        first_look_dp()
    elif argv:
        fail(f"unknown arguments {argv}")
    else:
        main()
