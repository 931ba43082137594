// By-row 2D pair beam search (pair-decode --beam_search_method row), CUDA
// for sm_90a.
//
// The port's own kernel: the JAX package computes this search as an XLA
// lax.scan over the rows u of read 1 (poreover_tpu/ops/beam2d.py:
// _beam2d_row_scan :379, a row _beam2d_row_iteration :268, its sweeps
// _layered_axis_sweep :177), not in Pallas. It computes what the plain
// PyTorch version ops/beam2d.py:row_scan computes, in the same float32
// order, so the two agree bit for bit on the card: per row a dedup and
// top-W prune of the C = W*(A+1) candidates (equal scores by lowest index,
// as lax.top_k), read 1's one-step update (lookups take the maximum over
// every valid match, as the plain version's masked max), then every
// candidate's sweep across the row's window [rs, re) of read 2, a node
// once after its parent: per state component a cumulative log-add-exp
// chain p(w) = lse(E(w), p(w-1) + weight(w)) in closed form, cw + the
// inclusive scan of (seed, E - cw), the scan in the odd/even tree of
// jax.lax.associative_scan (the plain version's _lse_scan_), the prefix
// sums cw of the weights in XLA's CPU association (base-16 blocks,
// _cumsum_xla), and the scores last0 + the row's maximum. Each row's
// beam_src goes to global memory; at the end thread 0 walks the traceback
// from the best candidate (the first maximum of the deduplicated scores).
//
// What bounds it: a row's dependent chain of barriers and scans, not bytes
// (y is read a few times per row, beam_src written once): per row ~2-4
// layers of sweeps, each a tree of ~2 log2(Wb + 1) levels of log-add-exps
// on one warp. This first design is simple: one CTA of 512 threads per
// workload (a pair or an anchored box), a thread per candidate for the
// table's bookkeeping, a warp per candidate for a sweep (its lanes over
// the window's columns; a tree level per __syncwarp), 16 candidates of a
// layer in flight. Its redesign for Hopper is a later step (ROADMAP §B).
//
// Storage per workload: the candidate table's keys, characters, read-1
// states, scores and offsets in static shared memory (two tables: a row's
// lookups read the previous one); the read-2 sweeps (a row of Wb + 1
// columns per candidate and component, column 0 the seed), the frozen
// parent copies (Wb columns), double-buffered likewise, the row's prefix
// sums (a row per emission column) and each warp's chain and sum scratch
// in dynamic shared memory when the wave's largest fits
// SMEM_STORAGE_LIMIT_BYTES, else in global scratch (a launch takes one or
// the other for all its CTAs; ops/pair_row_beam.py: storage_path).
//
// Interface (plain C, loaded with ctypes; see ops/pair_row_beam.py): y1 /
// y2 float32 [sum U, S] / [sum V, S] back to back, cum1 / cum2 float32
// each read's cumulative gap mass, rows int32 [sum R, 2] (rs, re), meta
// int64 [B, 9] (ops/beam2d.py: RM_*); out src int16 [sum R, W], score
// float32 [B, C], valid uint8 [B, C] (the final table), chars int8 [sum
// R] and first int8 [B] (the traceback).

#include <stdint.h>

#include "common.cuh"

namespace {

using poreover::lse;

constexpr int NT = 512;  // threads per CTA (one workload per CTA)
constexpr int NWARPS = NT / 32;
constexpr int A = 4;       // alphabet size the kernel is compiled for
constexpr int CMAX = 128;  // candidate slots: W * (A + 1) <= CMAX
constexpr int WMAX = CMAX / (A + 1);
constexpr int SMAX = 8;    // emission columns: A + 1, or 2A (flip-flop)
constexpr int SMEM_STORAGE_LIMIT_BYTES = 200 * 1024;
constexpr float NEG_INF = -INFINITY;
// log(0.5) rounded to float32: the flip-flop root's components
constexpr float LOG_HALF = -0.693147182464599609375f;
constexpr unsigned M1 = poreover::M1;
constexpr unsigned M2 = poreover::M2;

enum { RM_Y1, RM_U, RM_Y2, RM_V, RM_ROW, RM_R, RM_U0, RM_WB, RM_SCR,
       RM_COLS };

// floats of a warp's prefix-sum scratch: the block totals of every level
// of a sum over Wb (fewer than Wb / 15 + levels)
__host__ __device__ inline long long tmp_width(int Wb) {
  return Wb / 8 + 16;
}

// floats of a workload's storage: sweeps [2][C][2][Wb + 1], frozen parent
// copies [2][C][2][Wb], prefix sums [SMAX][Wb], per warp a chain [Wb + 1]
// and its sums' scratch
__host__ __device__ inline long long storage_floats(int C, int Wb) {
  return 4LL * C * (Wb + 1) + 4LL * C * Wb + (long long)SMAX * Wb +
         (long long)NWARPS * (Wb + 1 + tmp_width(Wb));
}

struct Table {
  unsigned k1[CMAX], k2[CMAX], pk1[CMAX], pk2[CMAX];
  float st0[CMAX][2];  // read 1's state at the row
  float score[CMAX];
  int poff[CMAX];      // offset of the frozen parent copy
  signed char ch[CMAX], pch[CMAX];
  unsigned char valid[CMAX];
  int off;             // offset of the sweeps (the row's rs)
};

// Inclusive scan of x[0 .. n) with log-add-exp in place, by one warp, in
// the recursive odd/even tree of jax.lax.associative_scan (level l's
// element k at x[2^l - 1 + k 2^l]): up, each odd element from the pair
// before it; down, each even element from the odd one before it.
__device__ void lse_scan_warp(float* x, int n, int lane) {
  int levels = 0;
  for (int nl = n, st = 1; nl > 1; nl >>= 1, st <<= 1, ++levels) {
    const int half = nl >> 1;
    for (int j = lane; j < half; j += 32) {
      const int pe = st - 1 + 2 * j * st;
      x[pe + st] = lse(x[pe], x[pe + st]);
    }
    __syncwarp();
  }
  for (int l = levels - 1; l >= 0; --l) {
    const int st = 1 << l;
    const int cnt = ((n >> l) - 1) >> 1;
    for (int j = lane + 1; j <= cnt; j += 32) {
      const int pk = st - 1 + 2 * j * st;
      x[pk] = lse(x[pk - st], x[pk]);
    }
    __syncwarp();
  }
}

// Inclusive prefix sums of a[0 .. L) in place, by one warp, associated as
// XLA's CPU backend associates jnp.cumsum (ops/beam2d.py:_cumsum_xla):
// blocks of 16 summed in order, the totals of all blocks but the last
// summed the same way (recursively, here level by level in tmp), each
// block's exclusive prefix added to its elements last.
__device__ void cumsum_xla_warp(float* a, int L, float* tmp, int lane) {
  float* lv[8];
  int len[8];
  int d = 0;
  lv[0] = a;
  len[0] = L;
  float* next = tmp;
  for (;;) {
    float* x = lv[d];
    const int n = len[d];
    const int nb = (n + 15) >> 4;
    for (int bk = lane; bk < nb; bk += 32) {
      const int lo = bk * 16, hi = min(lo + 16, n);
      float s = x[lo];
      for (int i = lo + 1; i < hi; ++i) {
        s = __fadd_rn(x[i], s);
        x[i] = s;
      }
    }
    __syncwarp();
    if (nb <= 1 || d == 7) break;
    const int m = nb - 1;
    for (int bk = lane; bk < m; bk += 32) next[bk] = x[bk * 16 + 15];
    __syncwarp();
    ++d;
    lv[d] = next;
    len[d] = m;
    next += m;
  }
  for (; d > 0; --d) {
    float* x = lv[d - 1];
    const int n = len[d - 1];
    const float* t = lv[d];
    for (int i = 16 + lane; i < n; i += 32)
      x[i] = __fadd_rn(x[i], t[(i >> 4) - 1]);
    __syncwarp();
  }
}

__device__ __forceinline__ void child_key(unsigned p1, unsigned p2, int c,
                                          unsigned& k1, unsigned& k2) {
  k1 = p1 * M1 + (unsigned)(c + 1);
  k2 = p2 * M2 + (unsigned)(c + 1);
}

// One node's read-1 update (ops/beam.py:_node_update): state s at u-1,
// parent p at u-1, characters c (>= 0) and pc, the row y of read 1.
template <int MODEL>
__device__ __forceinline__ void node_update(const float s[2],
                                            const float p[2], int c, int pc,
                                            const float* y, bool root_start,
                                            float out[2]) {
  constexpr int S = MODEL == 2 ? 2 * A : A + 1;
  const float yc = y[c];
  const float ptot = lse(p[0], p[1]);
  const bool same = c == pc;
  if (MODEL == 0) {
    out[0] = lse(__fadd_rn(ptot, yc), __fadd_rn(s[0], y[S - 1]));
    out[1] = NEG_INF;
  } else if (MODEL == 1) {
    out[0] = __fadd_rn(lse(s[0], s[1]), y[S - 1]);
    const float src = same ? p[0] : ptot;
    out[1] = lse(__fadd_rn(src, yc), __fadd_rn(s[1], yc));
  } else {
    const float ycf = y[c + A];
    const float emit_flip = __fadd_rn(same ? p[1] : ptot, yc);
    float emit_flop = same ? __fadd_rn(p[0], ycf) : NEG_INF;
    if (root_start) emit_flop = ycf;
    out[0] = lse(emit_flip, __fadd_rn(s[0], yc));
    out[1] = lse(emit_flop, __fadd_rn(s[1], ycf));
  }
}

template <int MODEL>
__global__ void __launch_bounds__(NT, 1)
    row_beam_kernel(const float* __restrict__ y1g,
                    const float* __restrict__ y2g,
                    const float* __restrict__ cum1g,
                    const float* __restrict__ cum2g,
                    const int* __restrict__ rowsg,
                    const long long* __restrict__ meta, int W, int use_smem,
                    float* scratch, short* src_out, float* score_out,
                    unsigned char* valid_out, signed char* chars_out,
                    signed char* first_out) {
  constexpr int S = MODEL == 2 ? 2 * A : A + 1;
  extern __shared__ float dyn[];
  __shared__ Table tab[2];
  __shared__ unsigned char keep[CMAX], done[CMAX], ready[CMAX];
  __shared__ unsigned char pkind[CMAX];  // frozen copy: 0 psweep, 1 sweep
  __shared__ int pslot[CMAX];  // parent's row in the new table; -1 none,
                               // -2 the root
  __shared__ int psrc[CMAX];   // the frozen copy's row in the old table
  __shared__ int bsrc[WMAX];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long* m = meta + (long long)blockIdx.x * RM_COLS;
  const int V = (int)m[RM_V], R = (int)m[RM_R];
  const int u0 = (int)m[RM_U0], Wb = (int)m[RM_WB];
  const long long row0 = m[RM_ROW];
  const float* y1 = y1g + m[RM_Y1] * S;
  const float* y2 = y2g + m[RM_Y2] * S;
  const float* cum1 = cum1g + m[RM_Y1];
  const float* cum2 = cum2g + m[RM_Y2];
  const int* rows = rowsg + row0 * 2;
  const int C = W * (A + 1);
  const int Wb1 = Wb + 1;

  float* st = use_smem ? dyn : scratch + m[RM_SCR];
  float* sw[2] = {st, st + 2LL * C * Wb1};
  float* ps[2] = {st + 4LL * C * Wb1, st + 4LL * C * Wb1 + 2LL * C * Wb};
  float* cw = st + 4LL * C * Wb1 + 4LL * C * Wb;
  float* xs = cw + (long long)SMAX * Wb + (long long)warp * Wb1;
  float* tmp = cw + (long long)SMAX * Wb + (long long)NWARPS * Wb1 +
               (long long)warp * tmp_width(Wb);
  auto swrow = [&](int t, int n, int k) {
    return sw[t] + ((long long)n * 2 + k) * Wb1;
  };
  auto psrow = [&](int t, int n, int k) {
    return ps[t] + ((long long)n * 2 + k) * Wb;
  };

  // ---- the initial table: the A root children in beam slot 0's child
  // slots, read 1's state from row 0 (unless the scan starts at u = 0),
  // read 2's from v = 0 at offset 0
  if (tid < C) {
    const int n = tid;
    Table& T0 = tab[0];
    T0.k1[n] = T0.k2[n] = T0.pk1[n] = T0.pk2[n] = 0;
    T0.ch[n] = T0.pch[n] = -1;
    T0.valid[n] = 0;
    T0.poff[n] = 0;
    float s1[2] = {NEG_INF, NEG_INF}, s2[2] = {NEG_INF, NEG_INF};
    T0.score[n] = NEG_INF;
    if (n >= W && n < W + A) {
      const int c = n - W;
      child_key(0u, 0u, c, T0.k1[n], T0.k2[n]);
      T0.ch[n] = (signed char)c;
      T0.valid[n] = 1;
      T0.score[n] = 0.0f;
      if (MODEL == 0) {
        s1[0] = y1[c];
        s2[0] = y2[c];
      } else if (MODEL == 1) {
        s1[1] = y1[c];
        s2[1] = y2[c];
      } else {
        s1[0] = y1[c];
        s1[1] = y1[c + A];
        s2[0] = y2[c];
        s2[1] = y2[c + A];
      }
    }
    T0.st0[n][0] = u0 == 0 ? NEG_INF : s1[0];
    T0.st0[n][1] = u0 == 0 ? NEG_INF : s1[1];
    for (int k = 0; k < 2; ++k) {
      float* r = swrow(0, n, k);
      r[0] = NEG_INF;
      for (int w = 0; w < Wb; ++w) r[1 + w] = w == 0 ? s2[k] : NEG_INF;
      float* q = psrow(0, n, k);
      for (int w = 0; w < Wb; ++w) q[w] = NEG_INF;
    }
  }
  if (tid == 0) tab[0].off = 0;
  __syncthreads();

  for (int r = 0; r < R; ++r) {
    const int t = r & 1, nt = t ^ 1;
    Table& O = tab[t];
    Table& N = tab[nt];
    const int u = u0 + r;
    const int rs = rows[2 * r], re = rows[2 * r + 1];
    const float* yu = y1 + (long long)u * S;
    // a scan's value at a position does not depend on the elements after
    // it (the tree combines by position), so the chains and sums stop at
    // the row's own width; the columns past it are -inf
    const int width = re - rs, nsc = width + 1;

    // ---- dedup (first valid occurrence of a key), and the row's prefix
    // sums: warp s < S sums emission column s over the window (0 out of
    // range), as the plain version's _row_sums
    if (tid < C) {
      const int i = tid;
      bool k = O.valid[i];
      for (int j = 0; j < i && k; ++j)
        if (O.valid[j] && O.k1[j] == O.k1[i] && O.k2[j] == O.k2[i])
          k = false;
      keep[i] = k;
    }
    if (warp < S) {
      float* a = cw + (long long)warp * Wb;
      for (int w = lane; w < Wb; w += 32)
        a[w] = rs + w < re ? y2[(long long)(rs + w) * S + warp] : 0.0f;
      __syncwarp();
      cumsum_xla_warp(a, width, tmp, lane);
    }
    __syncthreads();

    // ---- prune: the W best kept scores, equal scores by lowest index
    if (tid < C) {
      const int i = tid;
      const float si = keep[i] ? O.score[i] : NEG_INF;
      int rank = 0;
      for (int j = 0; j < C; ++j) {
        const float sj = keep[j] ? O.score[j] : NEG_INF;
        rank += (sj > si) || (sj == si && j < i);
      }
      if (rank < W) {
        bsrc[rank] = i;
        src_out[(row0 + r) * W + rank] = (short)i;
      }
    }
    __syncthreads();

    // ---- the new table: beam nodes 0..W-1 (stays), then their children;
    // read 1's step; each node's seed (its stale value at rs - 1) and the
    // source of its frozen parent copy
    if (tid < C) {
      const int n = tid;
      const bool beam = n < W;
      const int b = beam ? n : (n - W) / A;
      const int sidx = bsrc[b];
      const bool v = keep[sidx];
      unsigned k1, k2, pk1, pk2;
      int c, pc;
      if (beam) {
        k1 = O.k1[sidx];
        k2 = O.k2[sidx];
        pk1 = O.pk1[sidx];
        pk2 = O.pk2[sidx];
        c = O.ch[sidx];
        pc = O.pch[sidx];
      } else {
        c = (n - W) % A;
        pk1 = O.k1[sidx];
        pk2 = O.k2[sidx];
        child_key(pk1, pk2, c, k1, k2);
        pc = O.ch[sidx];
      }
      // lookups in the old table: the maximum over every valid match of
      // the state (the parent's for a beam node, its own for a child);
      // a child's stale sweep from the first valid match
      const unsigned q1 = beam ? pk1 : k1, q2 = beam ? pk2 : k2;
      float look[2] = {NEG_INF, NEG_INF};
      int first_match = -1;
      for (int j = 0; j < C; ++j) {
        if (O.valid[j] && O.k1[j] == q1 && O.k2[j] == q2) {
          look[0] = fmaxf(look[0], O.st0[j][0]);
          look[1] = fmaxf(look[1], O.st0[j][1]);
          if (first_match < 0) first_match = j;
        }
      }
      const bool root_parent = pk1 == 0u && pk2 == 0u;
      float out[2];
      const int cs = c < 0 ? 0 : c;
      if (beam) {
        float par[2] = {look[0], look[1]};
        if (MODEL == 0) {
          if (root_parent && v) {
            par[0] = u == 0 ? 0.0f : cum1[u - 1];
            par[1] = NEG_INF;
          }
        } else if (root_parent && v && u == 0) {
          par[0] = MODEL == 1 ? 0.0f : LOG_HALF;
          par[1] = MODEL == 1 ? NEG_INF : LOG_HALF;
        }
        node_update<MODEL>(O.st0[sidx], par, cs, pc, yu,
                           root_parent && u == 0, out);
      } else {
        node_update<MODEL>(look, O.st0[sidx], cs, pc, yu, false, out);
      }
      N.k1[n] = k1;
      N.k2[n] = k2;
      N.pk1[n] = pk1;
      N.pk2[n] = pk2;
      N.ch[n] = (signed char)c;
      N.pch[n] = (signed char)pc;
      N.valid[n] = v;
      N.st0[n][0] = v ? out[0] : NEG_INF;
      N.st0[n][1] = v ? out[1] : NEG_INF;
      const int stale = beam ? sidx : first_match;
      const int idx = rs - 1 - O.off;
      for (int k = 0; k < 2; ++k)
        swrow(nt, n, k)[0] = stale >= 0 && idx >= 0 && idx < Wb
                                 ? swrow(t, stale, k)[1 + idx]
                                 : NEG_INF;
      psrc[n] = sidx;
      pkind[n] = beam ? 0 : 1;
    }
    __syncthreads();

    // ---- parent slots in the new table (first valid match; -2 the root)
    if (tid < C) {
      const int n = tid;
      int p = -1;
      if (N.pk1[n] == 0u && N.pk2[n] == 0u) {
        p = -2;
      } else {
        for (int j = 0; j < C; ++j)
          if (N.valid[j] && N.k1[j] == N.pk1[n] && N.k2[j] == N.pk2[n]) {
            p = j;
            break;
          }
      }
      pslot[n] = p;
      done[n] = 0;
    }
    __syncthreads();
    // invalid nodes are never swept: their sweeps are -inf
    for (int n = warp; n < C; n += NWARPS) {
      if (N.valid[n]) continue;
      for (int k = 0; k < 2; ++k) {
        float* o = swrow(nt, n, k);
        for (int w = lane; w < Wb; w += 32) o[1 + w] = NEG_INF;
      }
    }

    // ---- the sweeps, layer by layer: a node whose parent is done (or
    // not in the table) is swept by one warp
    for (;;) {
      bool rd = false;
      if (tid < C) {
        const int n = tid, p = pslot[n];
        rd = !done[n] && N.valid[n] && (p < 0 || done[p]);
        ready[n] = rd;
      }
      if (!__syncthreads_or(rd)) break;
      for (int n = warp; n < C; n += NWARPS) {
        if (!ready[n]) continue;
        const int p = pslot[n];
        const int c = N.ch[n];
        const bool same = c == N.pch[n];
        const bool root = p == -2;
        // the parent's value of component k at v - 1 for column w
        // (position rs - 1 + w): its sweep this row (column w of its row,
        // column 0 its seed), the root's, or the frozen copy
        const int fsrc = psrc[n];
        const float* f0;
        const float* f1;
        int foff, fbase;
        if (pkind[n] == 0) {
          f0 = psrow(t, fsrc, 0);
          f1 = psrow(t, fsrc, 1);
          foff = O.poff[fsrc];
          fbase = 0;
        } else {
          f0 = swrow(t, fsrc, 0);
          f1 = swrow(t, fsrc, 1);
          foff = O.off;
          fbase = 1;
        }
        auto pval = [&](int k, int w) -> float {
          if (p >= 0) return swrow(nt, p, k)[w];
          const int pos = rs - 1 + w;
          if (root) {
            if (MODEL == 0) {
              if (k == 1) return NEG_INF;
              return pos == -1 ? 0.0f : (pos < V ? cum2[pos] : NEG_INF);
            }
            if (MODEL == 1) return k == 0 && pos == -1 ? 0.0f : NEG_INF;
            return pos == -1 ? LOG_HALF : NEG_INF;
          }
          const int idx = pos - foff;
          return idx >= 0 && idx < Wb ? (k == 0 ? f0 : f1)[fbase + idx]
                                      : NEG_INF;
        };
        float* o0 = swrow(nt, n, 0);
        float* o1 = swrow(nt, n, 1);
        const float seed0 = o0[0], seed1 = o1[0];
        const float* cwg = cw + (long long)(S - 1) * Wb;
        const float* cwc = cw + (long long)c * Wb;
        const float* cwf = cw + (long long)(c + A) * Wb;
        const float* yc = y2 + (long long)rs * S + c;
        if (MODEL == 0) {
          for (int w = lane; w < Wb; w += 32) {
            const bool in = rs + w < re;
            const float e = in ? __fadd_rn(lse(pval(0, w), pval(1, w)),
                                           yc[(long long)w * S])
                               : NEG_INF;
            xs[1 + w] = __fsub_rn(e, cwg[w]);
          }
          if (lane == 0) xs[0] = seed0;
          __syncwarp();
          lse_scan_warp(xs, nsc, lane);
          for (int w = lane; w < Wb; w += 32) {
            const bool in = rs + w < re;
            o0[1 + w] = in ? __fadd_rn(xs[1 + w], cwg[w]) : NEG_INF;
            o1[1 + w] = NEG_INF;
          }
        } else if (MODEL == 1) {
          // no-gap chain (weights: the emission), written masked to o1
          for (int w = lane; w < Wb; w += 32) {
            const bool in = rs + w < re;
            const float p0 = pval(0, w);
            const float src = same ? p0 : lse(p0, pval(1, w));
            const float e = in ? __fadd_rn(src, yc[(long long)w * S])
                               : NEG_INF;
            xs[1 + w] = __fsub_rn(e, cwc[w]);
          }
          if (lane == 0) xs[0] = seed1;
          __syncwarp();
          lse_scan_warp(xs, nsc, lane);
          for (int w = lane; w < Wb; w += 32) {
            const bool in = rs + w < re;
            o1[1 + w] = in ? __fadd_rn(xs[1 + w], cwc[w]) : NEG_INF;
          }
          __syncwarp();
          // total chain (weights: the gap); gap(w) = total(w-1) + gap_w
          const float seed_tot = lse(seed0, seed1);
          for (int w = lane; w < Wb; w += 32)
            xs[1 + w] = __fsub_rn(o1[1 + w], cwg[w]);
          if (lane == 0) xs[0] = seed_tot;
          __syncwarp();
          lse_scan_warp(xs, nsc, lane);
          const float* gp = y2 + (long long)rs * S + (S - 1);
          for (int w = lane; w < Wb; w += 32) {
            const bool in = rs + w < re;
            const float prev =
                w == 0 ? seed_tot : __fadd_rn(xs[w], cwg[w - 1]);
            o0[1 + w] = in ? __fadd_rn(prev, gp[(long long)w * S]) : NEG_INF;
          }
        } else {
          // flip chain, then flop chain (weights: their emissions)
          for (int w = lane; w < Wb; w += 32) {
            const bool in = rs + w < re;
            const float p0 = pval(0, w), p1 = pval(1, w);
            const float ef = __fadd_rn(same ? p1 : lse(p0, p1),
                                       in ? yc[(long long)w * S] : 0.0f);
            xs[1 + w] = __fsub_rn(in ? ef : NEG_INF, cwc[w]);
          }
          if (lane == 0) xs[0] = seed0;
          __syncwarp();
          lse_scan_warp(xs, nsc, lane);
          for (int w = lane; w < Wb; w += 32) {
            const bool in = rs + w < re;
            o0[1 + w] = in ? __fadd_rn(xs[1 + w], cwc[w]) : NEG_INF;
          }
          __syncwarp();
          for (int w = lane; w < Wb; w += 32) {
            const bool in = rs + w < re;
            const float cf = in ? yc[(long long)w * S + A] : 0.0f;
            float eo = same ? __fadd_rn(pval(0, w), cf) : NEG_INF;
            if (root && rs + w == 0) eo = cf;
            xs[1 + w] = __fsub_rn(in ? eo : NEG_INF, cwf[w]);
          }
          if (lane == 0) xs[0] = seed1;
          __syncwarp();
          lse_scan_warp(xs, nsc, lane);
          for (int w = lane; w < Wb; w += 32) {
            const bool in = rs + w < re;
            o1[1 + w] = in ? __fadd_rn(xs[1 + w], cwf[w]) : NEG_INF;
          }
        }
        __syncwarp();
      }
      __syncthreads();
      if (tid < C && ready[tid]) done[tid] = 1;
      __syncthreads();
    }

    // ---- frozen parent copies (the parent's new sweep where it is in the
    // table, else the copy carried on), and the scores: last0 + the
    // maximum over the row's window of read 2's total
    for (int n = warp; n < C; n += NWARPS) {
      const int p = pslot[n];
      const float* s0;
      const float* s1;
      int base, off;
      if (p >= 0) {
        s0 = swrow(nt, p, 0);
        s1 = swrow(nt, p, 1);
        base = 1;
        off = rs;
      } else if (pkind[n] == 0) {
        s0 = psrow(t, psrc[n], 0);
        s1 = psrow(t, psrc[n], 1);
        base = 0;
        off = O.poff[psrc[n]];
      } else {
        s0 = swrow(t, psrc[n], 0);
        s1 = swrow(t, psrc[n], 1);
        base = 1;
        off = O.off;
      }
      float* q0 = psrow(nt, n, 0);
      float* q1 = psrow(nt, n, 1);
      const float* o0 = swrow(nt, n, 0);
      const float* o1 = swrow(nt, n, 1);
      float mx = NEG_INF;
      for (int w = lane; w < Wb; w += 32) {
        q0[w] = s0[base + w];
        q1[w] = s1[base + w];
        if (rs + w < re) mx = fmaxf(mx, lse(o0[1 + w], o1[1 + w]));
      }
      for (int sh = 16; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      if (lane == 0) {
        N.poff[n] = off;
        N.score[n] = N.valid[n]
                         ? __fadd_rn(lse(N.st0[n][0], N.st0[n][1]), mx)
                         : NEG_INF;
      }
    }
    if (tid == 0) N.off = rs;
    __syncthreads();
  }

  // ---- the final table out; the best candidate (first maximum of the
  // deduplicated scores) and the traceback through each row's beam_src
  Table& F = tab[R & 1];
  if (tid < C) {
    const int i = tid;
    bool k = F.valid[i];
    for (int j = 0; j < i && k; ++j)
      if (F.valid[j] && F.k1[j] == F.k1[i] && F.k2[j] == F.k2[i]) k = false;
    keep[i] = k;
    score_out[(long long)blockIdx.x * C + i] = F.score[i];
    valid_out[(long long)blockIdx.x * C + i] = F.valid[i];
  }
  __syncthreads();
  if (tid == 0) {
    int j = 0;
    float best = keep[0] ? F.score[0] : NEG_INF;
    for (int i = 1; i < C; ++i) {
      const float s = keep[i] ? F.score[i] : NEG_INF;
      if (s > best) {
        best = s;
        j = i;
      }
    }
    for (int r = R - 1; r >= 0; --r) {
      const short* sr = src_out + (row0 + r) * W;
      if (j >= W) {
        chars_out[row0 + r] = (signed char)((j - W) % A);
        j = sr[(j - W) / A];
      } else {
        chars_out[row0 + r] = -1;
        j = sr[j];
      }
    }
    first_out[blockIdx.x] = j >= W ? (signed char)((j - W) % A) : -1;
  }
}

}  // namespace

extern "C" {

long long pair_row_beam_storage_floats(int C, int Wb) {
  return storage_floats(C, Wb);
}
int pair_row_beam_smem_limit() { return SMEM_STORAGE_LIMIT_BYTES; }
int pair_row_beam_cmax() { return CMAX; }

// Launches B CTAs of NT threads on `stream`, one per workload, the
// instance of `model_id`. smem_bytes > 0: each CTA's storage in that much
// dynamic shared memory (at most SMEM_STORAGE_LIMIT_BYTES); 0: in
// `scratch` at each workload's offset. Returns a cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take).
int pair_row_beam_launch(const float* y1, const float* y2, const float* cum1,
                         const float* cum2, const int* rows,
                         const long long* meta, int B, int W, int model_id,
                         int smem_bytes, float* scratch, short* src,
                         float* score, unsigned char* valid, signed char* chars,
                         signed char* first, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W * (A + 1) > CMAX || model_id < 0 || model_id > 2 ||
      smem_bytes < 0 || smem_bytes > SMEM_STORAGE_LIMIT_BYTES)
    return (int)cudaErrorInvalidValue;
  void (*kernels[3])(const float*, const float*, const float*, const float*,
                     const int*, const long long*, int, int, float*, short*,
                     float*, unsigned char*, signed char*, signed char*) = {
      row_beam_kernel<0>, row_beam_kernel<1>, row_beam_kernel<2>};
  auto kernel = kernels[model_id];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_STORAGE_LIMIT_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, NT, smem_bytes, (cudaStream_t)stream>>>(
      y1, y2, cum1, cum2, rows, meta, W, smem_bytes > 0 ? 1 : 0, scratch,
      src, score, valid, chars, first);
  return (int)cudaGetLastError();
}

}  // extern "C"
