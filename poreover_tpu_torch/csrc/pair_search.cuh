// The row_col pair-consensus beam search of one (y1, y2, plan) problem by
// one CTA: device code shared by pair_beam_batch.cu (one CTA per pair,
// storage in shared memory or global scratch) and box_beam.cu (many anchor
// boxes per CTA, storage in shared memory). Header only; part of both kernels' build hash.
//
// Computes what the plan-driven engine
// poreover_tpu/ops/beam2d_planned.py:_planned_scan computes in float32 for
// its three model kinds -- and what the port's plain PyTorch version
// ops/beam2d_planned.py:planned_scan computes, op for op, so kernel and
// plain version agree bit for bit on the card. run_search is a template
// over the kind (MODEL: 0 ctc, 1 ctc_merge_repeats for bonito, 2
// ctc_flipflop); each kernel instantiates all three. The ctc instance keeps
// one state value per storage column; the other two keep two (bonito: gap
// and no gap; flip-flop: flip and flop) and run two stay chains per row:
// bonito's no-gap chain feeds its total chain, flip-flop's two are
// independent. Their chains' weights are the emission of the row's own
// character, so the prefix sums of the weights are taken per character:
// once per column for a narrow sweep (all A or 2A of them), once per row
// for a general one. The windowed instances take those sums (cw) in
// float64 rounded once, as the Pallas kernel's packing does; the exact
// instances (G > 0) in XLA's association (narrow_cw_xla, chunk_cw<true>),
// as the JAX exact engine does on the CPU.
//
// What bounds a step: latency. It is a chain of small dependent phases, so
// the design cuts the chain's barriers and its serial and wasted work:
//
// - The candidate table (C = W*(A+1) <= 32 slots) lives in registers, one
//   lane per slot, and every warp holds its own copy and updates it the
//   same way: prune (dedup by __match_any_sync on the 64-bit key, ties to
//   the lowest slot; top-W by each lane's rank), expand (shuffles from the
//   winners' lanes) and the key lookups (first masked slot with a key, by
//   32 broadcasts) need no shared memory and no barrier.
// - The two reads sweep at the same time: warps 0-3 sweep read 0, warps
//   4-7 read 1, each group synchronised by its own named barrier. The
//   groups meet once per MAIN step, where a candidate's score is the sum
//   of its two window maxima; on a catch-up run (C0RUN / C1RUN) one group
//   sweeps and the other goes on to the next step.
// - A sweep costs its live columns. Inside a chunk the candidates are
//   layered over their parent forest, and each row's stay chain is the
//   closed form cw + cumlse(seed, E - cw), whose inclusive log-add-exp
//   scan walks the pairwise tree of jax.lax.associative_scan. That tree is
//   prefix-consistent (a position's value depends only on the positions
//   before it, combined in the same pairs whatever the length), so a
//   window of at most NARROW_MAX columns (most sweeps) runs in registers:
//   seed and columns in a segment of S = 2^k lanes, 32/S rows per warp,
//   the tree level by level with __shfl_up_sync. Wider windows take the
//   general path: CHUNK-column pieces, each scanned in a per-warp shared
//   buffer cut to the chunk's live width. A row's values go straight into
//   its storage, where its children read them after the layer's barrier.
// - The storage passes (the MAIN permutation with the re-anchoring shift,
//   the frozen-parent gather and refresh) run a row per warp, RB rows and
//   CPL columns per lane in flight.
//
// Each candidate's windowed per-read storage ("sweep") and its frozen
// parent copy ("psweep"), [K, C, Wst] float32 per read (K state components,
// component k of row i at k*C*Wst + i*Wst), live in the caller's `store`
// (4*K*C*(Wst0+Wst1) floats, double-buffered, so a MAIN step's permutation
// is one gather pass). No fast math: expf / log1pf stay IEEE;
// no TF32 or bf16 touches a log-prob. log(0) is -inf and lse(-inf, -inf)
// is -inf.
//
// The graveyard (run_search<MODEL, G> with G = GT rows; the pair kernel's
// exact instances, the JAX engine's _planned_scan with G > 0): a candidate
// that leaves the table at a MAIN step keeps its storage for up to
// grace - 1 further MAIN steps in one of G rows, and a child whose key is
// found there resumes that storage. Both read groups keep their own copy of
// the graveyard's bookkeeping (thread gt of a group holds slot gt's key, age
// and storage row in registers; GraveShared holds what the others read) and
// update it the same way, so the groups still meet only at the join. The
// new graveyard is ordered by (age, pool index), the pool being the old
// table's rows then the old graveyard's in slot order, as the JAX engine's
// stable argsort orders it. Its slots are therefore always in age order, so
// the old slots that stay keep their relative order: a stay's new slot is
// the count of buried table rows plus the stays before it, one prefix count
// over the group's ballots, and its valid rows are always slots 0 .. gn-1.
// A buried row's values only move with the window, never change, so it
// keeps its storage row frozen from the step it was buried and a
// descriptor (S, lo, hi) per read: its value at storage column j is
// frozen[j + S] for lo <= j < hi, -inf elsewhere, which composes each
// re-anchoring shift in O(1) (compose_shift) and includes the wrap of the
// JAX engine's shift. A burial copies one row once; a resume reads one row
// through its descriptor; a slot's row never moves, only the list of rows
// (by slot) is rebuilt, and rows the graveyard drops join a free list. Its
// storage ([K, G, Wst] per read, one buffer) lives apart from the
// candidates' (`gstore`), in shared memory when it fits beside them.
//
// run_search starts from the t = 0 state and rewrites every piece of table
// and storage state it later reads, so a CTA may run one problem after
// another in the same shared memory and storage: a problem's result does
// not depend on what ran before it.
#pragma once

#include "common.cuh"

namespace poreover {
namespace pair_search {

constexpr unsigned FULL = 0xffffffffu;

constexpr int CHUNK = 128;
constexpr int SCAN_N = CHUNK + 1;
constexpr int CMAX = 32;
constexpr int A = 4;
constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int GWARP = NWARP / 2;  // warps of one read's group
constexpr int GT = 32 * GWARP;    // threads of one read's group
constexpr int NARROW_MAX = 31;    // widest window of the register path
constexpr int RB = 4;   // storage passes: rows per warp at a time,
constexpr int CPL = 2;  // and columns per lane and row

enum { MAIN = 0, C0RUN = 1, C1RUN = 2 };
// columns of a problem's int64 meta row (ops/beam2d_planned.py:pack_pairs)
enum { M_T1, M_L1, M_Y1, M_T2, M_L2, M_Y2, M_PLAN, M_N, M_WST0, M_WST1,
       M_SCR, META_COLS = 12 };

// Phase clocks (common.cuh; -DPOREOVER_PHASE_CLOCKS only) of thread 0 of
// every CTA (thread 0 sweeps read 0, so the score phase holds its wait for
// read 1; layers are the rows' loads and stores, scan their lse trees,
// wait the group barriers), and counts of the sweeps and layers of both
// groups (CLK_COUNT: added at once by each group's first thread). Slots
// CK_STEPS.. are counts. The helpers a step calls take the clock mark and
// sums by reference (CLK_PARAM, CLK_ARG).
#ifdef POREOVER_PHASE_CLOCKS
enum { CK_PRUNE, CK_EXPAND, CK_PERMUTE, CK_LOADS, CK_LAYERS, CK_REFRESH,
       CK_SCORE, CK_SCAN, CK_WAIT, CK_GRAVE_SELECT, CK_GRAVE_STORE, CK_STEPS,
       CK_SWEEPS, CK_LAYER_N, CK_NARROW, CK_N };
__device__ unsigned long long g_phase_clocks[CK_N];
#define CLK_COUNT(p, v)                                       \
  do {                                                        \
    if (threadIdx.x % GT == 0)                                \
      atomicAdd(&g_phase_clocks[p], (unsigned long long)(v)); \
  } while (0)
#define CLK_PARAM , long long &clk_t_, unsigned long long (&clk_acc_)[CK_N]
#define CLK_ARG , clk_t_, clk_acc_
#else
#define CLK_COUNT(p, v)
#define CLK_PARAM
#define CLK_ARG
#endif

// One candidate slot; lane i of every warp holds slot i.
struct Row {
  unsigned k1, k2, pk1, pk2;
  int chr, pch, valid;
  float score;
};

// A warp's own scratch: the keys and scores of its copy of the table,
// which its lanes read back with broadcast vector loads (key lookups and
// ranks), and the rows of a narrow layer in the order of their slots
// (sharing the general path's scan buffer, which a narrow sweep leaves
// alone).
struct WarpScratch {
  uint2 key[CMAX];  // (k1, k2)
  float sc[CMAX];
  union {
    float scan[SCAN_N + 3];  // general path: the warp's scan tree
    int4 rows[CMAX];         // narrow path: (row, pslot, chr, poff)
  };
};

struct Shared {
  float mx[2][2][CMAX];  // [MAIN-step parity][read][slot]
  WarpScratch ws[NWARP];
};

// the largest grace the exact instances take (the JAX engine's rank key of
// a pool row that is not kept, 1 << 30)
constexpr int MAX_GRACE = 1 << 30;

// The graveyard's bookkeeping, one copy per read group (index [g]): by slot
// its keys and ages, and its storage rows in two lists that alternate by
// MAIN step (the old slots' list stays readable while the new one is
// written); by storage row the descriptor; the free rows (G - gn of them,
// two lists alternating likewise); the table rows buried this step; and
// the warps' ballots of the old slots that stay.
template <int G> struct GraveShared {
  alignas(16) uint2 key[2][G];
  int age[2][G];
  int phys[2][2][G];
  int dS[2][G], dlo[2][G], dhi[2][G];
  int freel[2][2][G];
  int src[2][CMAX];
  alignas(16) unsigned stay[2][GWARP];
};
template <> struct GraveShared<0> {};

// One more re-anchoring shift s (new[j] = old[j + s] inside [0, Wa), -inf
// outside) of a buried row whose value at column j is frozen[j + S] for lo
// <= j < hi: (S + s, max(lo - s, 0), min(hi - s, Wa)); an empty interval is
// kept as (0, 0, 0).
__device__ __forceinline__ void compose_shift(int& S, int& lo, int& hi,
                                              int s, int Wa) {
  S += s;
  lo = max(lo - s, 0);
  hi = min(hi - s, Wa);
  if (lo >= hi) S = lo = hi = 0;
}

// The storage anchor `no` of a sweep over [lo, hi) from anchor `so` (keep
// it if the window fits, else the least right shift; it must cover the
// seed column lo-1 and the window), and the shift `d` that re-anchors the
// storage: the JAX engine's (ops/beam2d_planned.py:_jax_shift), whose
// lax.dynamic_slice wraps a negative start, then clamps.
__device__ __forceinline__ void anchor_shift(int so, int lo, int hi, int Wa,
                                             int& no, int& d) {
  no = hi > so + Wa ? hi - Wa : so;
  no = min(no, lo - 1);
  if (hi > no + Wa) no = hi - Wa;
  d = no - so + Wa + 1;
  if (d < 0) d += 3 * Wa + 2;
  d = min(max(d, 0), 2 * Wa + 2) - (Wa + 1);
}

// One search problem: two reads' planes ([R, T+1] float32; ctc: rows 0..3
// emissions, 4 gap, 5 the root's value at t-1; bonito: rows 0..3
// emissions, 4 gap; flip-flop: rows 0..3 flips, 4..7 flops), its plan
// ([N, 5] int32: type, a_lo, a_hi, b_lo, b_hi) and its storage widths.
struct Problem {
  int T[2], Lp[2], Wst[2];
  const float* y[2];
  const int* pl;
  int N;
};

__device__ __forceinline__ Problem load_problem(const float* planes1,
                                                const float* planes2,
                                                const int* plan,
                                                const long long* m) {
  Problem pr;
  pr.T[0] = (int)m[M_T1];
  pr.T[1] = (int)m[M_T2];
  pr.Lp[0] = (int)m[M_L1];
  pr.Lp[1] = (int)m[M_L2];
  pr.Wst[0] = (int)m[M_WST0];
  pr.Wst[1] = (int)m[M_WST1];
  pr.y[0] = planes1 + m[M_Y1];
  pr.y[1] = planes2 + m[M_Y2];
  pr.pl = plan + m[M_PLAN] * 5;
  pr.N = (int)m[M_N];
  return pr;
}

// Warp-wide arg-max of (score, index) pairs, ties to the lowest index (as
// lax.top_k and a stable sort pick). Every lane returns the winner.
__device__ __forceinline__ void warp_argmax_lowest(float& bs, int& bi) {
  for (int o = 16; o > 0; o >>= 1) {
    const float os = __shfl_xor_sync(FULL, bs, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (os > bs || (os == bs && oi < bi)) {
      bs = os;
      bi = oi;
    }
  }
}

// Warp-wide maximum; every lane returns it.
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Synchronises the GT threads of read group g (named barrier g + 1).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "n"(GT) : "memory");
}

// First slot j in mask m whose key (ws.key[j]) equals (q1, q2); -1 if
// none. The keys come as broadcast 16-byte loads, two slots each, so the
// loads of all slots are in flight at once.
__device__ __forceinline__ int lookup(const WarpScratch& ws, unsigned m,
                                      unsigned q1, unsigned q2) {
  int r = -1;
#pragma unroll
  for (int j = CMAX - 2; j >= 0; j -= 2) {
    const uint4 k = *reinterpret_cast<const uint4*>(&ws.key[j]);
    if (((m >> (j + 1)) & 1u) && k.z == q1 && k.w == q2) r = j + 1;
    if (((m >> j) & 1u) && k.x == q1 && k.y == q2) r = j;
  }
  return r;
}

// Publishes the lane's key into its warp's scratch.
__device__ __forceinline__ void put_key(WarpScratch& ws, int lane,
                                        unsigned k1, unsigned k2) {
  __syncwarp();
  ws.key[lane] = make_uint2(k1, k2);
  __syncwarp();
}

// Position of the n-th (0-based) set bit of m; n < popc(m).
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int base = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int c = __popc((m >> base) & ((1u << s) - 1u));
    if (n >= c) {
      n -= c;
      base += s;
    }
  }
  return base;
}

// In-place inclusive lse scan of buf[0..n) by one warp, n <= SCAN_N: the
// up- and down-sweep form of jax.lax.associative_scan's recursive odd/even
// tree (same pairs combined in the same order).
__device__ __forceinline__ void warp_tree_scan(float* buf, int lane, int n) {
  int nls[8];
  int L = 0, nl = n, s = 1;
  while (nl >= 2) {
    const int half = nl / 2;
    for (int j = lane; j < half; j += 32) {
      const int p = 2 * j * s + s - 1, q = 2 * j * s + 2 * s - 1;
      buf[q] = lse(buf[p], buf[q]);
    }
    __syncwarp();
    nls[L++] = nl;
    nl = half;
    s *= 2;
  }
  for (int l = L - 1; l >= 0; --l) {
    const int st = 1 << l, nn = nls[l];
    for (int i = 1 + lane; 2 * i < nn; i += 32) {
      const int pe = 2 * i * st + st - 1, po = (2 * i - 1) * st + st - 1;
      buf[pe] = lse(buf[po], buf[pe]);
    }
    __syncwarp();
  }
}

// Whether lane's slot of the final table survives deduplication: valid,
// and no lower valid lane holds the same key.
__device__ __forceinline__ bool final_keep(const Row& r, int lane) {
  const unsigned grp =
      __match_any_sync(FULL, ((unsigned long long)r.k2 << 32) | r.k1) &
      __ballot_sync(FULL, r.valid);
  return r.valid && __ffs(grp) - 1 == lane;
}

// What a swept row needs besides the read's columns, shuffled from the
// row's lane.
struct RowIn {
  int ps, ch, po;
  bool root;
};

__device__ __forceinline__ RowIn row_in(int pslot, int chr, int poff,
                                        bool root, int row) {
  RowIn r;
  r.ps = __shfl_sync(FULL, pslot, row);
  r.ch = max(__shfl_sync(FULL, chr, row), 0);
  r.po = __shfl_sync(FULL, poff, row);
  r.root = __shfl_sync(FULL, (int)root, row) != 0;
  return r;
}

// A row's parent value at column t (storage column c of a swept parent):
// the swept parent's fresh value, the root's, or the frozen parent copy.
__device__ __forceinline__ float parent_at(const RowIn& ri, const float* St,
                                           const float* Pt, int Wa, int row,
                                           int c, int t, float root_t) {
  if (ri.ps >= 0) return St[ri.ps * Wa + c];
  if (ri.root) return root_t;
  const int fi = t - 1 - ri.po;
  return (fi >= 0 && fi < Wa) ? Pt[row * Wa + fi] : -INFINITY;
}

// A narrow sweep's columns, one per lane: position p of the lane's
// segment of Sg lanes (p = 0 the seed, p >= 1 column t = lo + p - 1), the
// column's emissions, root value and cw, and the storage columns of lo
// (pos) and of the seed (sp).
struct Narrow {
  int p, Sg, t, pos, sp;
  bool inr;
  float em[A], root_t, cw;
};

// Inclusive lse scans of N values per lane over each segment of Sg lanes
// (position p), interleaved level by level so that their latencies
// overlap: the odd/even tree of jax.lax.associative_scan for a segment of
// length Sg (up-sweep: position 2js+2s-1 takes 2js+s-1; down-sweep:
// (2i+1)st-1 takes 2i*st-1, i >= 1). By prefix consistency its first n
// values are those of the same tree over any n or more elements.
template <int N>
__device__ __forceinline__ void seg_scan(float (&v)[N], int p, int Sg) {
  for (int s = 1; s < Sg; s <<= 1) {
    float w[N];
#pragma unroll
    for (int u = 0; u < N; ++u) w[u] = __shfl_up_sync(FULL, v[u], s);
    if (((p + 1) & (2 * s - 1)) == 0) {
#pragma unroll
      for (int u = 0; u < N; ++u) v[u] = lse(w[u], v[u]);
    }
  }
  for (int st = Sg >> 2; st >= 1; st >>= 1) {
    float w[N];
#pragma unroll
    for (int u = 0; u < N; ++u) w[u] = __shfl_up_sync(FULL, v[u], st);
    if (((p + 1) & (2 * st - 1)) == st && p + 1 >= 3 * st) {
#pragma unroll
      for (int u = 0; u < N; ++u) v[u] = lse(w[u], v[u]);
    }
  }
}

// One round of the narrow path: each lane segment sweeps R of the layer's
// nr ready rows, `rows[q]` for q = q0 + u*nslots + slot, u < R ((row,
// pslot, chr + 4 if a root, poff) in slot order), the R rows' trees
// interleaved level by level so that their latencies overlap. All lanes of
// the warp call it.
template <int R>
__device__ __forceinline__ void narrow_round(
    const Narrow& nw, const int4* rows, int nr, int q0, int nslots,
    int slot, float* St, const float* Pt, int Wa, float* mxo CLK_PARAM) {
  int row[R];
  bool act[R];
  float v[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int q = q0 + u * nslots + slot;
    act[u] = q < nr;
    const int4 rr = rows[min(q, nr - 1)];
    row[u] = rr.x;
    RowIn ri;
    ri.ps = rr.y;
    ri.ch = rr.z & 3;
    ri.root = rr.z >= 4;
    ri.po = rr.w;
    v[u] = -INFINITY;
    if (act[u]) {
      if (nw.p == 0) {
        if (nw.sp >= 0) v[u] = St[row[u] * Wa + nw.sp];
      } else if (nw.inr) {
        const float pa = parent_at(ri, St, Pt, Wa, row[u],
                                   nw.pos + nw.p - 2, nw.t, nw.root_t);
        const float e = ri.ch == 0 ? nw.em[0] : ri.ch == 1 ? nw.em[1]
                        : ri.ch == 2 ? nw.em[2] : nw.em[3];
        v[u] = (pa + e) - nw.cw;
      }
    }
  }
  CLK(CK_LAYERS);
  const int p = nw.p;
  seg_scan<R>(v, p, nw.Sg);
  CLK(CK_SCAN);
  float m[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    m[u] = -INFINITY;
    if (act[u] && nw.inr) {
      m[u] = v[u] + nw.cw;
      St[row[u] * Wa + nw.pos + p - 1] = m[u];
    }
  }
  for (int o = 1; o < nw.Sg; o <<= 1) {
#pragma unroll
    for (int u = 0; u < R; ++u)
      m[u] = fmaxf(m[u], __shfl_xor_sync(FULL, m[u], o));
  }
#pragma unroll
  for (int u = 0; u < R; ++u)
    if (act[u] && p == 0) mxo[row[u]] = m[u];
}

// ---- the two-component kinds (bonito, flip-flop) ----

// State components per storage column, emission rows, and stay chains
// (prefix sums of weights) of a kind: bonito's chains are the A emissions
// and the gap, flip-flop's the A flips and the A flops.
template <int MODEL> struct Kind {
  static constexpr int K = MODEL == 0 ? 1 : 2;
  static constexpr int NE = MODEL == 2 ? 2 * A : A;
  static constexpr int NCW = MODEL == 2 ? 2 * A : A + 1;
};

// (float)log(0.5): a flip-flop root's flip and flop at t = -1
constexpr float LOG_HALF = (float)-0.69314718055994530942;

// arr[i] for a run-time i < N without local memory
template <int N>
__device__ __forceinline__ float pick(const float (&arr)[N], int i) {
  float r = arr[0];
#pragma unroll
  for (int c = 1; c < N; ++c)
    if (i == c) r = arr[c];
  return r;
}

// The root's two components at column t: bonito (0, -inf) and flip-flop
// (log 1/2, log 1/2) at t = -1, i.e. as a parent value at t = 0.
template <int MODEL>
__device__ __forceinline__ void root_at(int t, float& r0, float& r1) {
  r0 = t == 0 ? (MODEL == 1 ? 0.f : LOG_HALF) : -INFINITY;
  r1 = (MODEL == 2 && t == 0) ? LOG_HALF : -INFINITY;
}

// A row's two parent components at column t (storage column c of a swept
// parent): the swept parent's fresh values, the root's, or the frozen
// parent copy; cs is the component stride C*Wa.
__device__ __forceinline__ void parent_at2(const RowIn& ri, const float* St,
                                           const float* Pt, int Wa, int cs,
                                           int row, int c, int t, float r0,
                                           float r1, float& p0, float& p1) {
  if (ri.ps >= 0) {
    p0 = St[ri.ps * Wa + c];
    p1 = St[cs + ri.ps * Wa + c];
  } else if (ri.root) {
    p0 = r0;
    p1 = r1;
  } else {
    const int fi = t - 1 - ri.po;
    const bool ok = fi >= 0 && fi < Wa;
    p0 = ok ? Pt[row * Wa + fi] : -INFINITY;
    p1 = ok ? Pt[cs + row * Wa + fi] : -INFINITY;
  }
}

// A narrow sweep's columns for a two-component kind, one per lane (as
// Narrow): the column's emissions (and bonito's gap) and the cw of every
// chain of the kind, float64 prefix sums over the segment rounded once.
template <int MODEL> struct NarrowK {
  int p, Sg, t, pos, sp;
  bool inr;
  float em[Kind<MODEL>::NE], gap, cw[Kind<MODEL>::NCW];
};

// One round of the narrow path for a two-component kind (narrow_round's
// counterpart): R rows per lane segment, `rows[q]` = (row, pslot, chr + 4
// if a root + 8 if chr == pchar, poff).
template <int MODEL, int R>
__device__ __forceinline__ void narrow_round_k(
    const NarrowK<MODEL>& nw, const int4* rows, int nr, int q0, int nslots,
    int slot, float* St, const float* Pt, int Wa, int cs,
    float* mxo CLK_PARAM) {
  int row[R];
  bool act[R];
  float a[R], b[R];  // bonito: no-gap chain, seed of the total chain;
                     // flip-flop: flip chain, flop chain
  float cwa[R], cwb[R];
  float r0, r1;
  root_at<MODEL>(nw.t, r0, r1);
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int q = q0 + u * nslots + slot;
    act[u] = q < nr;
    const int4 rr = rows[min(q, nr - 1)];
    row[u] = rr.x;
    RowIn ri;
    ri.ps = rr.y;
    ri.ch = rr.z & 3;
    ri.root = (rr.z & 4) != 0;
    ri.po = rr.w;
    const bool same = (rr.z & 8) != 0;
    cwa[u] = pick(nw.cw, ri.ch);
    cwb[u] = pick(nw.cw, MODEL == 1 ? A : A + ri.ch);
    a[u] = b[u] = -INFINITY;
    if (act[u]) {
      if (nw.p == 0) {
        if (nw.sp >= 0) {
          const float s0 = St[row[u] * Wa + nw.sp];
          const float s1 = St[cs + row[u] * Wa + nw.sp];
          a[u] = MODEL == 1 ? s1 : s0;
          b[u] = MODEL == 1 ? lse(s0, s1) : s1;
        }
      } else if (nw.inr) {
        float p0, p1;
        parent_at2(ri, St, Pt, Wa, cs, row[u], nw.pos + nw.p - 2, nw.t, r0,
                   r1, p0, p1);
        const float e = pick(nw.em, ri.ch);
        const float pt = lse(p0, p1);
        if (MODEL == 1) {
          a[u] = ((same ? p0 : pt) + e) - cwa[u];
        } else {
          const float f = pick(nw.em, A + ri.ch);
          a[u] = ((same ? p1 : pt) + e) - cwa[u];
          const float eo = (ri.root && nw.t == 0) ? f
                           : same ? p0 + f : -INFINITY;
          b[u] = eo - cwb[u];
        }
      }
    }
  }
  CLK(CK_LAYERS);
  const int p = nw.p;
  float o0[R], o1[R];
  if (MODEL == 1) {
    seg_scan<R>(a, p, nw.Sg);
    // the no-gap chain's values feed the total chain
#pragma unroll
    for (int u = 0; u < R; ++u) {
      o1[u] = a[u] + cwa[u];
      if (p > 0) b[u] = nw.inr ? o1[u] - cwb[u] : -INFINITY;
    }
    seg_scan<R>(b, p, nw.Sg);
    // gap(w) = total(w-1) + gap weight(w); the seed's position holds the
    // seed's total
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const float tot = p == 0 ? b[u] : b[u] + cwb[u];
      o0[u] = __shfl_up_sync(FULL, tot, 1) + nw.gap;
    }
  } else {
    float v[2 * R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      v[u] = a[u];
      v[R + u] = b[u];
    }
    seg_scan<2 * R>(v, p, nw.Sg);
#pragma unroll
    for (int u = 0; u < R; ++u) {
      o0[u] = v[u] + cwa[u];
      o1[u] = v[R + u] + cwb[u];
    }
  }
  CLK(CK_SCAN);
  float m[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    m[u] = -INFINITY;
    if (act[u] && nw.inr) {
      St[row[u] * Wa + nw.pos + p - 1] = o0[u];
      St[cs + row[u] * Wa + nw.pos + p - 1] = o1[u];
      m[u] = lse(o0[u], o1[u]);
    }
  }
  for (int o = 1; o < nw.Sg; o <<= 1) {
#pragma unroll
    for (int u = 0; u < R; ++u)
      m[u] = fmaxf(m[u], __shfl_xor_sync(FULL, m[u], o));
  }
#pragma unroll
  for (int u = 0; u < R; ++u)
    if (act[u] && p == 0) mxo[row[u]] = m[u];
}

// cw of a narrow sweep's column (position p >= 1 of its segment, column
// w = p - 1 of the chunk; x its weight, 0 outside the window) in XLA's
// association (ops/beam2d.py:_cumsum_xla): the blocks of 16 columns from
// the window's start summed in order from 0, the first block's total added
// to the second's (a window of at most NARROW_MAX columns has two). Every
// lane of the warp calls it; lane seg0 + q holds position q.
__device__ __forceinline__ float narrow_cw_xla(float x, int p, int seg0) {
  const int w = p - 1, b = max(w, 0) >> 4;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float v = __shfl_sync(FULL, x, (seg0 + 1 + 16 * b + j) & 31);
    if (16 * b + j <= w) acc = acc + v;
  }
  const float tot0 = __shfl_sync(FULL, acc, (seg0 + 16) & 31);
  return b == 0 ? acc : acc + tot0;
}

// cw of one chunk of a plane row (row[c_lo .. c_lo + cl)); the lane holds
// columns 4*lane .. 4*lane+3 (general path). Float64 inclusive prefix sums
// rounded once, or with XLA (exact mode) XLA's association
// (ops/beam2d.py:_cumsum_xla): the 8 blocks of 16 columns (4 lanes each)
// summed in order from 0, the blocks' totals likewise, each block's
// exclusive prefix added last.
template <bool XLA>
__device__ __forceinline__ void chunk_cw(const float* row, int cl, int lane,
                                         float (&cw4)[4]) {
  if constexpr (XLA) {
    float x4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int w = 4 * lane + q;
      x4[q] = w < cl ? row[w] : 0.f;
    }
    const int b0 = lane & ~3;  // the block's first lane
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < 4; ++l)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = __shfl_sync(FULL, x4[q], b0 + l);
        if (b0 + l <= lane) acc = acc + v;
        if (b0 + l == lane) cw4[q] = acc;
      }
    // block k's total is lane 4k+3's last column
    float excl = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const float t = __shfl_sync(FULL, cw4[3], 4 * k + 3);
      if (4 * k < b0) excl = excl + t;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) cw4[q] = cw4[q] + excl;
    return;
  }
  double v4[4], run = 0.0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int w = 4 * lane + q;
    run += w < cl ? (double)row[w] : 0.0;
    v4[q] = run;
  }
  double incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  double excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.0;
#pragma unroll
  for (int q = 0; q < 4; ++q) cw4[q] = (float)(excl + v4[q]);
}

// A sweep of the rows in smask over window [lo, hi) (anchor no) for a
// two-component kind (bonito, flip-flop): run_search's narrow and general
// paths with two state values per column and two stay chains per row.
// All lanes of the read's group call it; returns the layers it ran.
template <int MODEL, bool XLA>
__device__ __forceinline__ int sweep_two(
    WarpScratch& ws, const Row& nt, unsigned smask, int pslot, bool root,
    int poff, int lo, int hi, int no, const float* ya, int La, int Ta,
    int Wa, int C, float* St, const float* Pt, float* mxo CLK_PARAM) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = warp / GWARP, gw = warp % GWARP;
  const int cs = C * Wa, width = hi - lo;
  int nlayers = 0;
  if (width <= NARROW_MAX) {
    // ---- narrow path, two-component kinds (as above)
    NarrowK<MODEL> nw;
    nw.Sg = 2;
    while (nw.Sg < width + 1) nw.Sg <<= 1;
    const int p = nw.p = lane & (nw.Sg - 1), rpw = 32 / nw.Sg;
    const int nslots = GWARP * rpw, slot = gw * rpw + lane / nw.Sg;
    const int t = nw.t = lo + p - 1, pos = nw.pos = lo - no;
    const bool inr = nw.inr = p >= 1 && p <= width;
    constexpr int NE = Kind<MODEL>::NE, NCW = Kind<MODEL>::NCW;
    nw.gap = 0.f;
#pragma unroll
    for (int c = 0; c < NE; ++c) nw.em[c] = -INFINITY;
    if (inr) {
#pragma unroll
      for (int c = 0; c < NE; ++c)
        if (t < Ta) nw.em[c] = ya[c * La + t];
      if (MODEL == 1) nw.gap = ya[A * La + t];
    }
    // cw of every chain of the kind: inclusive prefix sums of its weights
    // (an emission row; bonito's last chain the gap), in float64 rounded
    // once, or with XLA in XLA's association
    if constexpr (XLA) {
#pragma unroll
      for (int c = 0; c < NCW; ++c)
        nw.cw[c] = narrow_cw_xla(
            inr ? (c < NE ? nw.em[min(c, NE - 1)] : nw.gap) : 0.f, p,
            lane & ~(nw.Sg - 1));
    } else {
      double x[NCW];
#pragma unroll
      for (int c = 0; c < NCW; ++c)
        x[c] = inr ? (double)(c < NE ? nw.em[min(c, NE - 1)] : nw.gap)
                   : 0.0;
      for (int o = 1; o < nw.Sg; o <<= 1) {
#pragma unroll
        for (int c = 0; c < NCW; ++c) {
          const double y = __shfl_up_sync(FULL, x[c], o);
          if (p >= o) x[c] += y;
        }
      }
#pragma unroll
      for (int c = 0; c < NCW; ++c) nw.cw[c] = (float)x[c];
    }
    nw.sp = min(pos - 1, Wa - 1);  // the seed's column
    CLK(CK_LOADS);

    unsigned done = 0;
    for (int layer = 0; layer <= C; ++layer) {
      const bool r = (((smask & ~done) >> lane) & 1u) &&
                     (pslot < 0 || ((done >> pslot) & 1u));
      const unsigned rdy = __ballot_sync(FULL, r);
      if (!rdy) break;
      ++nlayers;
      const int nr = __popc(rdy);
      __syncwarp();
      if (r)
        ws.rows[__popc(rdy & ((1u << lane) - 1u))] = make_int4(
            lane, pslot,
            max(nt.chr, 0) + (root ? 4 : 0) + (nt.chr == nt.pch ? 8 : 0),
            poff);
      __syncwarp();
      const int R = nr <= nslots ? 1 : 3;
      for (int q0 = 0; q0 < nr; q0 += R * nslots) {
        if (R == 1)
          narrow_round_k<MODEL, 1>(nw, ws.rows, nr, q0, nslots, slot, St,
                                   Pt, Wa, cs, mxo CLK_ARG);
        else
          narrow_round_k<MODEL, 3>(nw, ws.rows, nr, q0, nslots, slot, St,
                                   Pt, Wa, cs, mxo CLK_ARG);
      }
      CLK(CK_LAYERS);
      group_sync(g);
      CLK(CK_WAIT);
      done |= rdy;
    }
    const unsigned stuck = smask & ~done;
    if (stuck) {
      if (gw == 0)
        for (unsigned m = stuck; m; m &= m - 1) {
          const int row = __ffs(m) - 1;
          if (inr) {
            St[row * Wa + pos + p - 1] = -INFINITY;
            St[cs + row * Wa + pos + p - 1] = -INFINITY;
          }
          if (lane == 0) mxo[row] = -INFINITY;
        }
      group_sync(g);
    }
    CLK_COUNT(CK_NARROW, 1);
  } else {
    // ---- general path, two-component kinds (as above): two scans per
    // row in the warp's buffer, the row's chains' cw taken per row
    float* buf = ws.scan;
    const int nch = (width + CHUNK - 1) / CHUNK;
    for (int kc = 0; kc < nch; ++kc) {
      const int c_lo = lo + kc * CHUNK, pos = c_lo - no;
      const int cl = min(CHUNK, hi - c_lo);
      const int sp = kc == 0 ? min(pos - 1, Wa - 1) : pos - 1;
      float cwg4[4];  // bonito's total chain: the gap's cw
      if (MODEL == 1) chunk_cw<XLA>(ya + A * La + c_lo, cl, lane, cwg4);
      CLK(CK_LOADS);

      unsigned done = 0;
      for (int layer = 0; layer <= C; ++layer) {
        const bool r = (((smask & ~done) >> lane) & 1u) &&
                       (pslot < 0 || ((done >> pslot) & 1u));
        const unsigned rdy = __ballot_sync(FULL, r);
        if (!rdy) break;
        ++nlayers;
        const int nr = __popc(rdy);
        for (int q0 = 0; q0 < nr; q0 += GWARP) {
          const int q = q0 + gw;
          const int row = nth_set_bit(rdy, min(q, nr - 1));
          const RowIn ri = row_in(pslot, nt.chr, poff, root, row);
          const bool same =
              __shfl_sync(FULL, (int)(nt.chr == nt.pch), row) != 0;
          if (q >= nr) continue;  // warp-uniform
          float cwa4[4], cwb4[4];
          chunk_cw<XLA>(ya + ri.ch * La + c_lo, cl, lane, cwa4);
          if (MODEL == 2) {
            chunk_cw<XLA>(ya + (A + ri.ch) * La + c_lo, cl, lane, cwb4);
          } else {
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4) cwb4[q4] = cwg4[q4];
          }
          const float s0 = sp >= 0 ? St[row * Wa + sp] : -INFINITY;
          const float s1 = sp >= 0 ? St[cs + row * Wa + sp] : -INFINITY;
          // the first chain's terms (bonito no gap, flip-flop flip)
          // and flip-flop's flop chain's
          float va[4], vb[4];
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            const int w = 4 * lane + q4, t = c_lo + w;
            va[q4] = vb[q4] = -INFINITY;
            if (w < cl) {
              float r0, r1, p0, p1;
              root_at<MODEL>(t, r0, r1);
              parent_at2(ri, St, Pt, Wa, cs, row, pos + w - 1, t, r0, r1,
                         p0, p1);
              const float e = t < Ta ? ya[ri.ch * La + t] : -INFINITY;
              const float pt = lse(p0, p1);
              if (MODEL == 1) {
                va[q4] = ((same ? p0 : pt) + e) - cwa4[q4];
              } else {
                const float f =
                    t < Ta ? ya[(A + ri.ch) * La + t] : -INFINITY;
                va[q4] = ((same ? p1 : pt) + e) - cwa4[q4];
                const float eo = (ri.root && t == 0) ? f
                                 : same ? p0 + f : -INFINITY;
                vb[q4] = eo - cwb4[q4];
              }
            }
          }
          if (lane == 0) buf[0] = MODEL == 1 ? s1 : s0;
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4)
            if (4 * lane + q4 < cl) buf[4 * lane + q4 + 1] = va[q4];
          __syncwarp();
          CLK(CK_LAYERS);
          warp_tree_scan(buf, lane, cl + 1);
          float o0[4], o1[4];
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            const int w = 4 * lane + q4;
            const float o = w < cl ? buf[w + 1] + cwa4[q4] : -INFINITY;
            if (MODEL == 1) o1[q4] = o;
            else o0[q4] = o;
          }
          __syncwarp();
          // the second chain: bonito's total (on the no-gap values),
          // flip-flop's flop
          if (lane == 0) buf[0] = MODEL == 1 ? lse(s0, s1) : s1;
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4)
            if (4 * lane + q4 < cl)
              buf[4 * lane + q4 + 1] =
                  MODEL == 1 ? o1[q4] - cwb4[q4] : vb[q4];
          __syncwarp();
          warp_tree_scan(buf, lane, cl + 1);
          if (MODEL == 1) {
            // gap(w) = total(w-1) + gap weight(w); buf[0] holds the
            // seed's total
            float tot[4];
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4) {
              const int w = 4 * lane + q4;
              tot[q4] = w < cl ? buf[w + 1] + cwb4[q4] : 0.f;
            }
            __syncwarp();
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4)
              if (4 * lane + q4 < cl) buf[4 * lane + q4 + 1] = tot[q4];
            __syncwarp();
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4) {
              const int w = 4 * lane + q4;
              o0[q4] = w < cl ? buf[w] + ya[A * La + c_lo + w]
                              : -INFINITY;
            }
          } else {
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4) {
              const int w = 4 * lane + q4;
              o1[q4] = w < cl ? buf[w + 1] + cwb4[q4] : -INFINITY;
            }
          }
          CLK(CK_SCAN);
          float m = -INFINITY;
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            const int w = 4 * lane + q4;
            if (w < cl) {
              St[row * Wa + pos + w] = o0[q4];
              St[cs + row * Wa + pos + w] = o1[q4];
              m = fmaxf(m, lse(o0[q4], o1[q4]));
            }
          }
          m = warp_max(m);
          if (lane == 0) mxo[row] = kc == 0 ? m : fmaxf(mxo[row], m);
          __syncwarp();
        }
        CLK(CK_LAYERS);
        group_sync(g);
        CLK(CK_WAIT);
        done |= rdy;
      }
      const unsigned stuck = smask & ~done;
      if (stuck) {
        if (gw == 0)
          for (unsigned m = stuck; m; m &= m - 1) {
            const int row = __ffs(m) - 1;
            for (int w = lane; w < cl; w += 32) {
              St[row * Wa + pos + w] = -INFINITY;
              St[cs + row * Wa + pos + w] = -INFINITY;
            }
            if (lane == 0 && kc == 0) mxo[row] = -INFINITY;
          }
        group_sync(g);
      }
    }
  }
  return nlayers;
}

// Runs problem `pr` of the kind MODEL from the t = 0 state through its
// whole plan; all NT threads of the CTA call it together. `store` holds
// 4*K*C*(Wst0+Wst1) floats (global or shared memory; its contents on
// entry do not matter), `pv` receives the winners' provenance, W int8 per
// plan step (0 on run steps). Returns the lane's slot of the final table,
// in every warp; the CTA is synchronised on return.
//
// G > 0 (G == GT): the graveyard, with eviction at `grace` MAIN steps (an
// argument at most MAX_GRACE); `gsh` its bookkeeping and `gstore` its
// storage, G*K*(Wst0+Wst1) floats (global or shared memory; its contents
// on entry do not matter).
template <int MODEL, int G = 0>
__device__ __forceinline__ Row run_search(Shared& sh, const Problem& pr,
                                          int W, float* store,
                                          signed char* pv,
                                          GraveShared<G>* gsh = nullptr,
                                          int grace = 1,
                                          float* gstore = nullptr) {
  static_assert(G == 0 || G == GT, "one graveyard slot per group thread");
  static_assert(GWARP == 4, "GraveShared::stay is read as one uint4");
  constexpr int K = Kind<MODEL>::K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = warp / GWARP, gw = warp % GWARP, gt = tid % GT;
  const int C = W * (A + 1);
  const int* pl = pr.pl;
  const int N = pr.N;
  // this group's read and its storage
  const int Wa = pr.Wst[g], Ta = pr.T[g], La = pr.Lp[g];
  const float* ya = pr.y[g];
  const int cs = C * Wa;  // component stride
  const int n_st = K * cs;
  // storage buffers b = 0, 1 at base + b*n_st, frozen copies at
  // base + (2+b)*n_st (offsets, not an array of pointers, keep the
  // pointers' address space known to the compiler)
  float* const base = store + (g == 0 ? 0 : 4 * C * K * pr.Wst[0]);
  // the graveyard's storage rows (row p, component kc at kc*gcs + p*Wa)
  const int gcs = G * Wa;
  float* const gbase =
      G > 0 ? gstore + (g == 0 ? 0 : G * K * pr.Wst[0]) : nullptr;

  // ---- initial table: the A root children in beam row 0's child slots
  Row cur;
  {
    const bool child = lane >= W && lane < W + A;
    const unsigned cc = (unsigned)(lane - W + 1);
    cur.k1 = child ? cc : 0u;
    cur.k2 = child ? cc : 0u;
    cur.pk1 = 0u;
    cur.pk2 = 0u;
    cur.chr = child ? lane - W : -1;
    cur.pch = -1;
    cur.valid = child && lane < C;
    cur.score = cur.valid ? 0.f : -INFINITY;
  }
  if constexpr (MODEL == 0) {
    for (int k = gt; k < n_st; k += GT) {
      const int i = k / Wa, j = k - i * Wa;
      base[k] = (j == 0 && i >= W && i < W + A) ? ya[(i - W) * La]
                                                 : -INFINITY;
      base[2 * n_st + k] = -INFINITY;
    }
  } else {
    // the root children's state at t = 0: bonito (-inf, y0[c]), flip-flop
    // (y0[c], y0[c+A])
    for (int k = gt; k < n_st; k += GT) {
      const int comp = k >= cs, kk = k - comp * cs;
      const int i = kk / Wa, j = kk - i * Wa;
      float v = -INFINITY;
      if (j == 0 && i >= W && i < W + A) {
        if (MODEL == 2) v = ya[(i - W + comp * A) * La];
        else if (comp == 1) v = ya[(i - W) * La];
      }
      base[k] = v;
      base[2 * n_st + k] = -INFINITY;
    }
  }
  // the group's state of its read: storage anchor, which buffers hold the
  // storage and the frozen copies, and (lane = slot) frozen-copy offsets;
  // par: which half of sh.mx the next MAIN step uses
  int off = 0, sb = 0, pb = 0, poff = 0, par = 0;
  // the graveyard: its valid rows (slots 0 .. gn-1), the table rows
  // buried at the last MAIN step, and (thread gt) slot gt's key, age and
  // storage row; every storage row starts free
  int gn = 0, n_bury = 0, gage = 0, gphys = 0;
  unsigned gk1 = 0u, gk2 = 0u;
  if constexpr (G > 0) gsh->freel[0][g][gt] = gt;
  __syncthreads();
  CLK_INIT();

  int nxt[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) nxt[c] = N > 0 ? pl[c] : 0;

  for (int step = 0; step < N; ++step) {
    const int ty = nxt[0];
    const int lo = nxt[1 + 2 * g], hi = nxt[2 + 2 * g];
    if (step + 1 < N) {
#pragma unroll
      for (int c = 0; c < 5; ++c) nxt[c] = pl[(step + 1) * 5 + c];
    }
    const bool is_main = ty == MAIN;

    // ---- prune: dedup + top-W by rank (ties to the lowest slot)
    WarpScratch& ws = sh.ws[warp];
    const bool in = lane < C;
    const unsigned vm = __ballot_sync(FULL, cur.valid);
    put_key(ws, lane, cur.k1, cur.k2);
    const bool keep =
        cur.valid && lookup(ws, vm & ((1u << lane) - 1u), cur.k1, cur.k2) < 0;
    const float sc = keep ? cur.score : -INFINITY;
    ws.sc[lane] = sc;
    __syncwarp();
    int rank = 0;  // slots that beat this one
#pragma unroll
    for (int j = 0; j < CMAX; j += 4) {
      const float4 o = *reinterpret_cast<const float4*>(&ws.sc[j]);
      rank += (j < C && (o.x > sc || (o.x == sc && j < lane))) +
              (j + 1 < C && (o.y > sc || (o.y == sc && j + 1 < lane))) +
              (j + 2 < C && (o.z > sc || (o.z == sc && j + 2 < lane))) +
              (j + 3 < C && (o.w > sc || (o.w == sc && j + 3 < lane)));
    }
    // src: the old slot this lane's new slot comes from (the winner of its
    // rank for a winner slot, of its beam row for a child slot)
    const int tr = lane < W ? lane : (lane - W) / A;
    int src = 0;
    for (int w = 0; w < W; ++w) {
      const int l = __ffs(__ballot_sync(FULL, in && rank == w)) - 1;
      if (tr == w) src = l;
    }
    if (warp == 0 && lane < W && !is_main)
      pv[(long long)step * W + lane] = 0;
    if (warp == 0 && in && rank < W && is_main)
      pv[(long long)step * W + rank] = (signed char)lane;
    CLK(CK_PRUNE);

    // ---- expand (MAIN) or select the beam (runs); key lookups
    Row nt = cur;   // the table this step's sweeps use
    int psrc = -1;  // MAIN: old storage row of this slot, -1 none
    // MAIN, a child resuming graveyard slot psrc - C: its row's frozen
    // storage (offset from gbase, S included) and valid columns [glo, ghi)
    int goff = 0, glo = 0, ghi = 0;
    int refresh, pslot;
    bool root;
    unsigned smask;  // swept slots
    if (is_main) {
      const unsigned p1 = __shfl_sync(FULL, cur.k1, src);
      const unsigned p2 = __shfl_sync(FULL, cur.k2, src);
      const unsigned pp1 = __shfl_sync(FULL, cur.pk1, src);
      const unsigned pp2 = __shfl_sync(FULL, cur.pk2, src);
      const int pc = __shfl_sync(FULL, cur.chr, src);
      const int ppc = __shfl_sync(FULL, cur.pch, src);
      const int kp = __shfl_sync(FULL, (int)keep, src);
      const int c = (lane - W) % A;
      const unsigned q1 = p1 * M1 + (unsigned)(c + 1);
      const unsigned q2 = p2 * M2 + (unsigned)(c + 1);
      int child_idx = lookup(ws, vm, q1, q2);
      if constexpr (G > 0) {
        // a child not in the table resumes its graveyard row, if any (the
        // first valid slot with its key): old storage row C + slot, read
        // through its descriptor (taken now: the selection below may hand
        // the row to a burial)
        const bool miss = lane >= W && in && child_idx < 0;
        if (__any_sync(FULL, miss)) {
          int r = -1;
          const uint2* gkey = gsh->key[g];
          for (int j = (gn - 1) & ~1; j >= 0; j -= 2) {
            const uint4 k = *reinterpret_cast<const uint4*>(&gkey[j]);
            if (j + 1 < gn && k.z == q1 && k.w == q2) r = j + 1;
            if (k.x == q1 && k.y == q2) r = j;
          }
          if (miss && r >= 0) {
            child_idx = C + r;
            const int p = gsh->phys[par][g][r];
            goff = p * Wa + gsh->dS[g][p];
            glo = gsh->dlo[g][p];
            ghi = gsh->dhi[g][p];
          }
        }
      }
      if (lane < W) {
        nt.k1 = p1;
        nt.k2 = p2;
        nt.pk1 = pp1;
        nt.pk2 = pp2;
        nt.chr = pc;
        nt.pch = ppc;
        nt.valid = kp;
        psrc = src;
      } else if (in) {
        nt.k1 = q1;
        nt.k2 = q2;
        nt.pk1 = p1;
        nt.pk2 = p2;
        nt.chr = c;
        nt.pch = pc;
        nt.valid = kp;
        psrc = child_idx;
      } else {
        nt.valid = 0;
      }
      smask = __ballot_sync(FULL, nt.valid);
      put_key(ws, lane, nt.k1, nt.k2);
      refresh = lookup(ws, smask, nt.pk1, nt.pk2);
      root = nt.pk1 == 0u && nt.pk2 == 0u;
      pslot = root ? -1 : refresh;
      if constexpr (G > 0) {
        CLK(CK_EXPAND);
        // ---- the new graveyard (both groups alike): the old table's
        // first occurrences not in the new table at age 1 (slots 0 ..
        // n_t-1), then the old slots not in the new table, aged one more
        // step, below grace, in slot order (their (age, pool index)
        // order), as many as fit
        const unsigned tmask = __ballot_sync(
            FULL, grace > 1 && in && keep &&
                      lookup(ws, smask, cur.k1, cur.k2) < 0);
        const int n_t = __popc(tmask);
        const bool stay = gt < gn && gage + 1 < grace &&
                          lookup(ws, smask, gk1, gk2) < 0;
        const unsigned below = (1u << lane) - 1u;
        const unsigned sw = __ballot_sync(FULL, stay);
        if (lane == 0) gsh->stay[g][gw] = sw;
        group_sync(g);
        const uint4 st4 = *reinterpret_cast<const uint4*>(gsh->stay[g]);
        const unsigned st[GWARP] = {st4.x, st4.y, st4.z, st4.w};
        int ns = 0, pre = __popc(sw & below);
#pragma unroll
        for (int w = 0; w < GWARP; ++w) {
          ns += __popc(st[w]);
          if (w < gw) pre += __popc(st[w]);
        }
        const int nk = min(ns, G - n_t);  // the stays that are kept
        const bool kept = stay && pre < nk;
        // the old slots dropped (not kept), per warp; their rows join the
        // free list after its G - gn entries, and burial r takes entry r
        unsigned drop[GWARP];
        int before = 0;
#pragma unroll
        for (int w = 0; w < GWARP; ++w) {
          const int m = min(max(nk - before, 0), __popc(st[w]));
          const unsigned kw = m == __popc(st[w]) ? st[w]
              : st[w] & ((1u << nth_set_bit(st[w], m)) - 1u);
          const int nl = min(max(gn - 32 * w, 0), 32);
          drop[w] = (nl == 32 ? FULL : (1u << nl) - 1u) & ~kw;
          before += __popc(st[w]);
        }
        int no, d;  // this step's anchor and shift of the group's read
        anchor_shift(off, lo, hi, Wa, no, d);
        const int nfree = G - gn;
        const int* fl_old = gsh->freel[par][g];
        int* fl_new = gsh->freel[par ^ 1][g];
        int* ph_new = gsh->phys[par ^ 1][g];
        if (kept) {
          const int r = n_t + pre;
          gsh->key[g][r] = make_uint2(gk1, gk2);
          gsh->age[g][r] = gage + 1;
          ph_new[r] = gphys;
          int S = gsh->dS[g][gphys], l = gsh->dlo[g][gphys],
              h = gsh->dhi[g][gphys];
          compose_shift(S, l, h, d, Wa);
          gsh->dS[g][gphys] = S;
          gsh->dlo[g][gphys] = l;
          gsh->dhi[g][gphys] = h;
        }
        if (gt >= n_t && gt < nfree) fl_new[gt - n_t] = fl_old[gt];
        if (gt < gn && !kept) {
          int k = __popc(drop[gw] & below);
#pragma unroll
          for (int w = 0; w < GWARP; ++w)
            if (w < gw) k += __popc(drop[w]);
          if (nfree + k >= n_t) fl_new[nfree + k - n_t] = gphys;
        }
        if (gw == 0 && ((tmask >> lane) & 1u)) {
          const int r = __popc(tmask & below);
          int p;
          if (r < nfree) {
            p = fl_old[r];
          } else {
            // the (r - nfree)-th dropped slot's row
            int k = r - nfree, q = 0;
#pragma unroll
            for (int w = 0; w < GWARP; ++w) {
              const int c = __popc(drop[w]);
              if (k >= 0 && k < c) q = 32 * w + nth_set_bit(drop[w], k);
              k -= c;
            }
            p = gsh->phys[par][g][q];
          }
          gsh->key[g][r] = make_uint2(cur.k1, cur.k2);
          gsh->age[g][r] = 1;
          ph_new[r] = p;
          gsh->src[g][r] = lane;
          // its storage is the old table row's, copied after the permute;
          // then this step's shift
          int S = 0, l = 0, h = Wa;
          compose_shift(S, l, h, d, Wa);
          gsh->dS[g][p] = S;
          gsh->dlo[g][p] = l;
          gsh->dhi[g][p] = h;
        }
        gn = n_t + nk;
        n_bury = n_t;
        CLK(CK_GRAVE_SELECT);
      }
    } else {
      // catch-up run: sweep the current beam only (the valid slots whose
      // key a surviving winner holds)
      const unsigned wkept = __ballot_sync(FULL, in && rank < W && keep);
      smask = __ballot_sync(
          FULL, cur.valid && lookup(ws, wkept, cur.k1, cur.k2) >= 0);
      refresh = lookup(ws, vm, cur.pk1, cur.pk2);
      const int ps = lookup(ws, smask, cur.pk1, cur.pk2);
      root = cur.pk1 == 0u && cur.pk2 == 0u;
      pslot = root ? -1 : ps;
    }
    CLK(CK_EXPAND);

    if (is_main || ty == (g == 0 ? C0RUN : C1RUN)) {
      const int so = off;
      int no, d;
      anchor_shift(so, lo, hi, Wa, no, d);
      // the buried rows move with the window: on a run each slot's
      // descriptor takes the shift (on MAIN the selection did)
      if constexpr (G > 0) {
        if (!is_main && d != 0 && gt < gn) {
          int S = gsh->dS[g][gphys], l = gsh->dlo[g][gphys],
              h = gsh->dhi[g][gphys];
          compose_shift(S, l, h, d, Wa);
          gsh->dS[g][gphys] = S;
          gsh->dlo[g][gphys] = l;
          gsh->dhi[g][gphys] = h;
        }
      }
      // the old table's storage, which this step's burials copy
      const float* const Sbury = base + sb * n_st;

      // ---- storage permute (MAIN) / re-anchor shift
      if (is_main || d != 0) {
        const float* Sold = base + sb * n_st;
        float* Snew = base + (1 - sb) * n_st;
        const float* Pold = base + (2 + pb) * n_st;
        float* Pnew = base + (3 - pb) * n_st;
        // warp gw takes rows gw, gw + GWARP, ..., RB of them at a time
        for (int i0 = gw; i0 < C; i0 += RB * GWARP) {
          int sr[RB];
          const float* rp[RB];  // the source row (component 0)
          int rcs[RB];          // and its component stride
          int rlo[RB], rhi[RB];  // a resumed graveyard row's valid columns
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const int i = i0 + r * GWARP;
            const int li = min(i, CMAX - 1);
            const int q = is_main ? __shfl_sync(FULL, psrc, li) : i;
            sr[r] = i < C ? q : -2;  // -2: no such row
            rp[r] = Sold + max(sr[r], 0) * Wa;
            rcs[r] = cs;
            rlo[r] = 0;
            rhi[r] = Wa;
            if constexpr (G > 0) {
              // a child resumed from the graveyard reads its frozen row
              // through its descriptor
              const int o = __shfl_sync(FULL, goff, li);
              const int l = __shfl_sync(FULL, glo, li);
              const int h = __shfl_sync(FULL, ghi, li);
              if (sr[r] >= C) {
                rp[r] = gbase + o;
                rcs[r] = gcs;
                rlo[r] = l;
                rhi[r] = h;
              }
            }
          }
#pragma unroll
          for (int kc = 0; kc < K; ++kc)
          for (int j0 = 0; j0 < Wa; j0 += 32 * CPL) {
            float sv[RB][CPL];
#pragma unroll
            for (int r = 0; r < RB; ++r)
#pragma unroll
              for (int c = 0; c < CPL; ++c) {
                const int j = j0 + 32 * c + lane, jj = j + d;
                const bool ok = G > 0 ? jj >= rlo[r] && jj < rhi[r]
                                      : jj >= 0 && jj < Wa;
                sv[r][c] = (sr[r] >= 0 && j < Wa && ok)
                               ? rp[r][kc * rcs[r] + jj] : -INFINITY;
              }
#pragma unroll
            for (int r = 0; r < RB; ++r)
#pragma unroll
              for (int c = 0; c < CPL; ++c) {
                const int j = j0 + 32 * c + lane;
                if (sr[r] != -2 && j < Wa)
                  Snew[kc * cs + (i0 + r * GWARP) * Wa + j] = sv[r][c];
              }
          }
        }
        if (is_main) {
          // frozen parent copies of the rows whose parent is not in the
          // table (the others are refreshed after the sweep and never read
          // theirs before): a winner keeps its source's, a child takes its
          // winner's storage
          const unsigned fmask = __ballot_sync(FULL, in && refresh < 0);
          const int nf = __popc(fmask);
          for (int q0 = gw; q0 < nf; q0 += RB * GWARP) {
            int i[RB];
            const float* fsrc[RB];
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const int q = q0 + r * GWARP;
              i[r] = q < nf ? nth_set_bit(fmask, q) : -1;
              const int fs = __shfl_sync(FULL, src, max(i[r], 0));
              fsrc[r] = (i[r] < W ? Pold : Sold) + fs * Wa;
            }
#pragma unroll
            for (int kc = 0; kc < K; ++kc)
            for (int j0 = 0; j0 < Wa; j0 += 32 * CPL) {
              float fv[RB][CPL];
#pragma unroll
              for (int r = 0; r < RB; ++r)
#pragma unroll
                for (int c = 0; c < CPL; ++c) {
                  const int j = j0 + 32 * c + lane;
                  fv[r][c] = (i[r] >= 0 && j < Wa) ? fsrc[r][kc * cs + j]
                                                   : 0.f;
                }
#pragma unroll
              for (int r = 0; r < RB; ++r)
#pragma unroll
                for (int c = 0; c < CPL; ++c) {
                  const int j = j0 + 32 * c + lane;
                  if (i[r] >= 0 && j < Wa)
                    Pnew[kc * cs + i[r] * Wa + j] = fv[r][c];
                }
            }
          }
        }
        if (is_main) {
          const int fpo = __shfl_sync(FULL, poff, src);
          if (refresh < 0) poff = lane < W ? fpo : so;
          pb = 1 - pb;
        }
        sb = 1 - sb;
        CLK(CK_PERMUTE);
        group_sync(g);
        CLK(CK_WAIT);
      }
      if constexpr (G > 0) {
        if (is_main) {
          // this slot of the new graveyard; then the burials: each buried
          // table row's old storage (unshifted; its descriptor holds this
          // step's shift) copied once into its storage row, which no
          // resume reads any more (the permute above is past)
          const uint2 k = gsh->key[g][gt];
          gk1 = gt < gn ? k.x : 0u;
          gk2 = gt < gn ? k.y : 0u;
          gage = gt < gn ? gsh->age[g][gt] : 0;
          gphys = gt < gn ? gsh->phys[par ^ 1][g][gt] : 0;
          for (int r0 = gw; r0 < n_bury; r0 += RB * GWARP) {
            const float* bs[RB];
            float* bd[RB];
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const int q = min(r0 + r * GWARP, n_bury - 1);
              bs[r] = Sbury + gsh->src[g][q] * Wa;
              bd[r] = gbase + gsh->phys[par ^ 1][g][q] * Wa;
            }
#pragma unroll
            for (int kc = 0; kc < K; ++kc)
            for (int j0 = 0; j0 < Wa; j0 += 32 * CPL) {
              float bv[RB][CPL];
#pragma unroll
              for (int r = 0; r < RB; ++r)
#pragma unroll
                for (int c = 0; c < CPL; ++c) {
                  const int j = j0 + 32 * c + lane;
                  bv[r][c] = j < Wa ? bs[r][kc * cs + j] : 0.f;
                }
#pragma unroll
              for (int r = 0; r < RB; ++r)
#pragma unroll
                for (int c = 0; c < CPL; ++c) {
                  const int j = j0 + 32 * c + lane;
                  if (r0 + r * GWARP < n_bury && j < Wa)
                    bd[r][kc * gcs + j] = bv[r][c];
                }
            }
          }
          CLK(CK_GRAVE_STORE);
        }
      }
      CLK(CK_PERMUTE);
      float* St = base + sb * n_st;
      const float* Pt = base + (2 + pb) * n_st;
      float* mxo = sh.mx[par][g];
      const int width = hi - lo;
      int nlayers = 0;
      if (width <= 0) {
        if (is_main && gw == 0) mxo[lane] = -INFINITY;
      } else if constexpr (MODEL != 0) {
        nlayers = sweep_two<MODEL, (G > 0)>(ws, nt, smask, pslot, root,
                                            poff, lo, hi, no, ya, La, Ta, Wa,
                                            C, St, Pt, mxo CLK_ARG);
      } else if (width <= NARROW_MAX) {
        // ---- narrow path: seed and columns in a segment of Sg lanes
        Narrow nw;
        nw.Sg = 2;
        while (nw.Sg < width + 1) nw.Sg <<= 1;
        const int p = nw.p = lane & (nw.Sg - 1), rpw = 32 / nw.Sg;
        const int nslots = GWARP * rpw, slot = gw * rpw + lane / nw.Sg;
        const int t = nw.t = lo + p - 1, pos = nw.pos = lo - no;
        const bool inr = nw.inr = p >= 1 && p <= width;
        nw.root_t = -INFINITY;
        float gap = 0.f;
#pragma unroll
        for (int c = 0; c < A; ++c) nw.em[c] = -INFINITY;
        if (inr) {
#pragma unroll
          for (int c = 0; c < A; ++c)
            if (t < Ta) nw.em[c] = ya[c * La + t];
          gap = ya[A * La + t];
          if (t <= Ta) nw.root_t = ya[(A + 1) * La + t];
        }
        // cw: inclusive prefix sum of the gap weights, in float64 rounded
        // once, or (exact mode) in XLA's association
        if constexpr (G > 0) {
          nw.cw = narrow_cw_xla(inr ? gap : 0.f, p, lane & ~(nw.Sg - 1));
        } else {
          double x = inr ? (double)gap : 0.0;
          for (int o = 1; o < nw.Sg; o <<= 1) {
            const double y = __shfl_up_sync(FULL, x, o);
            if (p >= o) x += y;
          }
          nw.cw = (float)x;
        }
        nw.sp = min(pos - 1, Wa - 1);  // the seed's column
        CLK(CK_LOADS);

        // ---- layers over the parent forest
        unsigned done = 0;
        for (int layer = 0; layer <= C; ++layer) {
          const bool r = (((smask & ~done) >> lane) & 1u) &&
                         (pslot < 0 || ((done >> pslot) & 1u));
          const unsigned rdy = __ballot_sync(FULL, r);
          if (!rdy) break;
          ++nlayers;
          const int nr = __popc(rdy);
          // the ready rows in slot order, with what their sweep needs
          __syncwarp();
          if (r)
            ws.rows[__popc(rdy & ((1u << lane) - 1u))] = make_int4(
                lane, pslot, max(nt.chr, 0) + (root ? 4 : 0), poff);
          __syncwarp();
          // rows per lane segment and round: one, or 3 when the layer
          // has more rows than segments
          const int R = nr <= nslots ? 1 : 3;
          for (int q0 = 0; q0 < nr; q0 += R * nslots) {
            if (R == 1)
              narrow_round<1>(nw, ws.rows, nr, q0, nslots, slot, St, Pt, Wa,
                              mxo CLK_ARG);
            else
              narrow_round<3>(nw, ws.rows, nr, q0, nslots, slot, St, Pt, Wa,
                              mxo CLK_ARG);
          }
          CLK(CK_LAYERS);
          group_sync(g);
          CLK(CK_WAIT);
          done |= rdy;
        }
        // rows never ready (only a parent cycle, i.e. a hash collision,
        // makes one): -inf, as in the plain version
        const unsigned stuck = smask & ~done;
        if (stuck) {
          if (gw == 0)
            for (unsigned m = stuck; m; m &= m - 1) {
              const int row = __ffs(m) - 1;
              if (inr) St[row * Wa + pos + p - 1] = -INFINITY;
              if (lane == 0) mxo[row] = -INFINITY;
            }
          group_sync(g);
        }
        CLK_COUNT(CK_NARROW, 1);
      } else {
        // ---- general path: CHUNK-column pieces, one row per warp
        float* buf = ws.scan;
        const int nch = (width + CHUNK - 1) / CHUNK;
        for (int kc = 0; kc < nch; ++kc) {
          const int c_lo = lo + kc * CHUNK, pos = c_lo - no;
          const int cl = min(CHUNK, hi - c_lo);
          const int sp = kc == 0 ? min(pos - 1, Wa - 1) : pos - 1;
          // cw: the gap weights' prefix sums
          float cw4[4];
          chunk_cw<(G > 0)>(ya + A * La + c_lo, cl, lane, cw4);
          CLK(CK_LOADS);

          unsigned done = 0;
          for (int layer = 0; layer <= C; ++layer) {
            const bool r = (((smask & ~done) >> lane) & 1u) &&
                           (pslot < 0 || ((done >> pslot) & 1u));
            const unsigned rdy = __ballot_sync(FULL, r);
            if (!rdy) break;
            ++nlayers;
            const int nr = __popc(rdy);
            for (int q0 = 0; q0 < nr; q0 += GWARP) {
              const int q = q0 + gw;
              const int row = nth_set_bit(rdy, min(q, nr - 1));
              const RowIn ri = row_in(pslot, nt.chr, poff, root, row);
              if (q >= nr) continue;  // warp-uniform
              if (lane == 0)
                buf[0] = sp >= 0 ? St[row * Wa + sp] : -INFINITY;
#pragma unroll
              for (int q4 = 0; q4 < 4; ++q4) {
                const int w = 4 * lane + q4, t = c_lo + w;
                if (w < cl) {
                  const float rt = (ri.root && t <= Ta)
                      ? ya[(A + 1) * La + t] : -INFINITY;
                  const float pa = parent_at(ri, St, Pt, Wa, row,
                                             pos + w - 1, t, rt);
                  const float e = t < Ta ? ya[ri.ch * La + t]
                                         : -INFINITY;
                  buf[w + 1] = (pa + e) - cw4[q4];
                }
              }
              __syncwarp();
              CLK(CK_LAYERS);
              warp_tree_scan(buf, lane, cl + 1);
              CLK(CK_SCAN);
              float m = -INFINITY;
#pragma unroll
              for (int q4 = 0; q4 < 4; ++q4) {
                const int w = 4 * lane + q4;
                if (w < cl) {
                  const float o = buf[w + 1] + cw4[q4];
                  St[row * Wa + pos + w] = o;
                  m = fmaxf(m, o);
                }
              }
              m = warp_max(m);
              if (lane == 0) mxo[row] = kc == 0 ? m : fmaxf(mxo[row], m);
              __syncwarp();
            }
            CLK(CK_LAYERS);
            group_sync(g);
            CLK(CK_WAIT);
            done |= rdy;
          }
          const unsigned stuck = smask & ~done;
          if (stuck) {
            if (gw == 0)
              for (unsigned m = stuck; m; m &= m - 1) {
                const int row = __ffs(m) - 1;
                for (int w = lane; w < cl; w += 32)
                  St[row * Wa + pos + w] = -INFINITY;
                if (lane == 0 && kc == 0) mxo[row] = -INFINITY;
              }
            group_sync(g);
          }
        }
      }
      CLK(CK_LAYERS);
      CLK_COUNT(CK_SWEEPS, 1);
      CLK_COUNT(CK_LAYER_N, nlayers);

      // ---- frozen parent copies := parent's current storage
      float* Pw = base + (2 + pb) * n_st;
      const unsigned fmask = __ballot_sync(FULL, lane < C && refresh >= 0);
      const int nf = __popc(fmask);
      // warp gw takes the refreshed rows gw, gw + GWARP, ... (in slot
      // order), RB of them at a time
      for (int q0 = gw; q0 < nf; q0 += RB * GWARP) {
        int i[RB], rf[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int q = q0 + r * GWARP;
          i[r] = q < nf ? nth_set_bit(fmask, q) : -1;
          rf[r] = __shfl_sync(FULL, refresh, max(i[r], 0));
        }
#pragma unroll
        for (int kc = 0; kc < K; ++kc)
        for (int j0 = 0; j0 < Wa; j0 += 32 * CPL) {
          float fv[RB][CPL];
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int c = 0; c < CPL; ++c) {
              const int j = j0 + 32 * c + lane;
              fv[r][c] = (i[r] >= 0 && j < Wa)
                             ? St[kc * cs + rf[r] * Wa + j] : 0.f;
            }
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int c = 0; c < CPL; ++c) {
              const int j = j0 + 32 * c + lane;
              if (i[r] >= 0 && j < Wa) Pw[kc * cs + i[r] * Wa + j] = fv[r][c];
            }
        }
      }
      if (refresh >= 0) poff = no;
      off = no;
      // the group's next passes read what this sweep wrote (on a MAIN
      // step the join below orders them)
      CLK(CK_REFRESH);
      if (!is_main) group_sync(g);
      CLK(CK_WAIT);
    }

    // ---- join (MAIN): a candidate's score is the sum of its window maxima
    if (is_main) {
      __syncthreads();
      nt.score = nt.valid ? sh.mx[par][0][lane] + sh.mx[par][1][lane]
                          : -INFINITY;
      cur = nt;
      par ^= 1;
    }
    CLK(CK_SCORE);
    if (tid == 0) CLK_COUNT(CK_STEPS, 1);
  }
  CLK_FLUSH(tid == 0);
  __syncthreads();
  return cur;
}

}  // namespace pair_search
}  // namespace poreover

#ifdef POREOVER_PHASE_CLOCKS
// The phase sums (common.cuh: phase_clocks_copy).
extern "C" int phase_clocks_read(unsigned long long* out, int n,
                                 int reset) {
  return poreover::phase_clocks_copy(poreover::pair_search::g_phase_clocks,
                                     out, n, reset);
}
#endif
