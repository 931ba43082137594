// The row_col pair-consensus beam search of one (y1, y2, plan) problem by
// one CTA: device code shared by pair_beam_batch.cu (one CTA per pair,
// storage in global scratch) and box_beam.cu (many anchor boxes per CTA,
// storage in shared memory). Header only; part of both kernels' build hash.
//
// Computes what the plan-driven engine
// poreover_tpu/ops/beam2d_planned.py:_planned_scan computes for model "ctc"
// in float32 -- and what the port's plain PyTorch version
// ops/beam2d_planned.py:planned_scan computes, op for op, so kernel and
// plain version agree bit for bit on the card.
//
// The candidate table (C = W*(A+1) <= 32 slots: hash keys, chars, validity,
// scores, storage offsets, frozen-parent offsets) lives in shared memory
// (`Shared`); warp 0 does the dedup + top-W prune (ties to the lowest slot,
// as lax.top_k and a stable sort do). Each candidate's windowed per-read
// storage ("sweep") and its frozen parent copy ("psweep"), [C, Wst] float32
// per read, live in the caller's `store` (4*C*(Wst0+Wst1) floats,
// double-buffered, so a MAIN step's permutation is one gather pass). A
// sweep runs in CHUNK-column pieces; inside a chunk the candidates are
// layered over their parent forest, one warp per ready row, and each row's
// stay chain is the closed form cw + cumlse(seed, E - cw), whose inclusive
// log-add-exp scan walks the same pairwise tree as
// jax.lax.associative_scan. cw is a float64 prefix sum rounded once to
// float32. No fast math: expf / log1pf stay IEEE; no TF32 or bf16 touches a
// log-prob. log(0) is -inf and lse(-inf, -inf) is -inf.
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

constexpr int CHUNK = 128;
constexpr int SCAN_N = CHUNK + 1;
constexpr int CMAX = 32;
constexpr int A = 4;
constexpr int NT = 256;
constexpr int NWARP = NT / 32;

enum { MAIN = 0, C0RUN = 1, C1RUN = 2 };
// columns of a problem's int64 meta row (ops/beam2d_planned.py:pack_pairs)
enum { M_T1, M_L1, M_Y1, M_T2, M_L2, M_Y2, M_PLAN, M_N, M_WST0, M_WST1,
       M_SCR, META_COLS = 12 };

struct Table {
  unsigned k1[CMAX], k2[CMAX], pk1[CMAX], pk2[CMAX];
  int chr[CMAX], pch[CMAX], valid[CMAX];
  float score[CMAX];
};

struct Shared {
  Table tab[2];
  int keep[CMAX];
  int beam_src[CMAX];
  int child_idx[CMAX];    // new child slot -> old slot of the same key, -1
  int refresh_idx[CMAX];  // slot of the parent among valid rows, -1
  int pslot[CMAX];        // slot of the parent among swept rows, -1
  int is_root[CMAX];
  int smask[CMAX];        // swept rows of the current sweep
  int sel[CMAX];          // catch-up runs: rows of the current beam
  int poff[2][CMAX];
  float seeds[CMAX];
  float mx[2][CMAX];
  int done[CMAX], rdy[CMAX], rlist[CMAX];
  int nready;
  float emis[A][CHUNK];
  float gapw[CHUNK], root[CHUNK], cwv[CHUNK];
  float cur[CMAX][CHUNK];
  float scan[NWARP][SCAN_N + 3];
};

// One search problem: two reads' planes ([A+2, T+1] float32: rows 0..3
// emissions, 4 gap, 5 the root's value at t-1), its plan ([N, 5] int32:
// type, a_lo, a_hi, b_lo, b_hi) and its storage widths.
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

// In-place inclusive lse scan of buf[0..SCAN_N) by one warp: the up- and
// down-sweep form of jax.lax.associative_scan's recursive odd/even tree
// (same pairs combined in the same order).
__device__ __forceinline__ void warp_tree_scan(float* buf, int lane) {
  int nls[8];
  int L = 0, nl = SCAN_N, s = 1;
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
    const int st = 1 << l, n = nls[l];
    for (int i = 1 + lane; 2 * i < n; i += 32) {
      const int pe = 2 * i * st + st - 1, po = (2 * i - 1) * st + st - 1;
      buf[pe] = lse(buf[po], buf[pe]);
    }
    __syncwarp();
  }
}

// First slot j of `t` with key (q1, q2) among rows where mask[j]; -1 if none.
__device__ __forceinline__ int lookup(const unsigned* k1, const unsigned* k2,
                                      const int* mask, int C, unsigned q1,
                                      unsigned q2) {
  for (int j = 0; j < C; ++j)
    if (mask[j] && k1[j] == q1 && k2[j] == q2) return j;
  return -1;
}

// Whether slot i of the final table survives deduplication (valid, and no
// earlier valid slot holds the same key).
__device__ __forceinline__ int final_keep(const Table& t, int i) {
  int keep = t.valid[i];
  for (int j = 0; keep && j < i; ++j)
    if (t.valid[j] && t.k1[j] == t.k1[i] && t.k2[j] == t.k2[i]) keep = 0;
  return keep;
}

// Runs problem `pr` from the t = 0 state through its whole plan; all NT
// threads of the CTA call it together. `store` holds 4*C*(Wst0+Wst1)
// floats (global or shared memory; its contents on entry do not matter),
// `pv` receives the winners' provenance, W int8 per plan step (0 on run
// steps). Returns which of sh.tab[0..1] holds the final table; the CTA is
// synchronised on return.
__device__ __forceinline__ int run_search(Shared& sh, const Problem& pr,
                                          int W, float* store,
                                          signed char* pv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = W * (A + 1);
  const int T[2] = {pr.T[0], pr.T[1]};
  const int Lp[2] = {pr.Lp[0], pr.Lp[1]};
  const float* y[2] = {pr.y[0], pr.y[1]};
  const int* pl = pr.pl;
  const int N = pr.N;
  const int Wst[2] = {pr.Wst[0], pr.Wst[1]};
  float* base0 = store;
  float* base1 = base0 + 4LL * C * Wst[0];
  float* S[2][2] = {{base0, base0 + (long long)C * Wst[0]},
                    {base1, base1 + (long long)C * Wst[1]}};
  float* P[2][2] = {{base0 + 2LL * C * Wst[0], base0 + 3LL * C * Wst[0]},
                    {base1 + 2LL * C * Wst[1], base1 + 3LL * C * Wst[1]}};

  // ---- initial table: the A root children in beam row 0's child slots
  if (tid < CMAX) {
    Table& t0 = sh.tab[0];
    const int i = tid;
    const bool child = i >= W && i < W + A;
    const unsigned cc = (unsigned)(i - W + 1);
    t0.k1[i] = child ? cc : 0u;
    t0.k2[i] = child ? cc : 0u;
    t0.pk1[i] = 0u;
    t0.pk2[i] = 0u;
    t0.chr[i] = child ? i - W : -1;
    t0.pch[i] = -1;
    t0.valid[i] = child && i < C;
    t0.score[i] = (child && i < C) ? 0.f : -INFINITY;
    sh.poff[0][i] = 0;
    sh.poff[1][i] = 0;
  }
  for (int a = 0; a < 2; ++a) {
    const int n = C * Wst[a];
    for (int k = tid; k < n; k += NT) {
      const int i = k / Wst[a], j = k - i * Wst[a];
      S[a][0][k] = (j == 0 && i >= W && i < W + A) ? y[a][(i - W) * Lp[a]]
                                                    : -INFINITY;
      P[a][0][k] = -INFINITY;
    }
  }
  // per-thread copies of block-uniform state: current table, storage
  // offsets, and which of the two buffers holds storage / frozen copies
  int ct = 0;
  int off[2] = {0, 0}, sb[2] = {0, 0}, pb[2] = {0, 0};
  __syncthreads();

  for (int step = 0; step < N; ++step) {
    const int ty = pl[step * 5];
    const int lo_[2] = {pl[step * 5 + 1], pl[step * 5 + 3]};
    const int hi_[2] = {pl[step * 5 + 2], pl[step * 5 + 4]};
    const bool is_main = ty == MAIN;
    const Table& old = sh.tab[ct];

    // ---- prune: dedup + top-W (warp 0)
    if (warp == 0) {
      const int i = lane;
      const bool in = i < C;
      int keep = 0;
      float sc = -INFINITY;
      if (in && old.valid[i]) {
        keep = 1;
        for (int j = 0; j < i; ++j)
          if (old.valid[j] && old.k1[j] == old.k1[i] &&
              old.k2[j] == old.k2[i]) {
            keep = 0;
            break;
          }
        if (keep) sc = old.score[i];
      }
      sh.keep[i] = keep;
      bool taken = !in;
      for (int w = 0; w < W; ++w) {
        float bs = taken ? -INFINITY : sc;
        int bi = taken ? (1 << 20) : i;
        warp_argmax_lowest(bs, bi);
        if (i == bi) taken = true;
        if (i == 0) sh.beam_src[w] = bi;
      }
    }
    __syncthreads();
    if (tid < W) pv[(long long)step * W + tid] =
        is_main ? (signed char)sh.beam_src[tid] : (signed char)0;

    if (is_main) {
      // ---- expand: winners + their children into the other table
      Table& nt = sh.tab[1 - ct];
      if (tid < C) {
        const int i = tid;
        if (i < W) {
          const int s = sh.beam_src[i];
          nt.k1[i] = old.k1[s];
          nt.k2[i] = old.k2[s];
          nt.pk1[i] = old.pk1[s];
          nt.pk2[i] = old.pk2[s];
          nt.chr[i] = old.chr[s];
          nt.pch[i] = old.pch[s];
          nt.valid[i] = sh.keep[s];
        } else {
          const int b = (i - W) / A, c = (i - W) % A;
          const int s = sh.beam_src[b];
          const unsigned p1 = old.k1[s], p2 = old.k2[s];
          const unsigned q1 = p1 * M1 + (unsigned)(c + 1);
          const unsigned q2 = p2 * M2 + (unsigned)(c + 1);
          nt.k1[i] = q1;
          nt.k2[i] = q2;
          nt.pk1[i] = p1;
          nt.pk2[i] = p2;
          nt.chr[i] = c;
          nt.pch[i] = old.chr[s];
          nt.valid[i] = sh.keep[s];
          sh.child_idx[i] = lookup(old.k1, old.k2, old.valid, C, q1, q2);
        }
      }
      __syncthreads();
      if (tid < C) {
        const int i = tid;
        const int r = lookup(nt.k1, nt.k2, nt.valid, C, nt.pk1[i], nt.pk2[i]);
        const int root = nt.pk1[i] == 0u && nt.pk2[i] == 0u;
        sh.refresh_idx[i] = r;
        sh.is_root[i] = root;
        sh.pslot[i] = root ? -1 : r;
        sh.smask[i] = nt.valid[i];
      }
    } else {
      // ---- catch-up run: sweep the current beam only
      if (tid < C) {
        const int i = tid;
        int s = 0;
        if (old.valid[i])
          for (int w = 0; w < W; ++w) {
            const int b = sh.beam_src[w];
            if (sh.keep[b] && old.k1[i] == old.k1[b] &&
                old.k2[i] == old.k2[b]) {
              s = 1;
              break;
            }
          }
        sh.sel[i] = s;
      }
      __syncthreads();
      if (tid < C) {
        const int i = tid;
        const int root = old.pk1[i] == 0u && old.pk2[i] == 0u;
        sh.refresh_idx[i] =
            lookup(old.k1, old.k2, old.valid, C, old.pk1[i], old.pk2[i]);
        sh.is_root[i] = root;
        sh.pslot[i] =
            root ? -1 : lookup(old.k1, old.k2, sh.sel, C, old.pk1[i],
                               old.pk2[i]);
        sh.smask[i] = sh.sel[i];
      }
    }
    __syncthreads();
    const Table& tu = sh.tab[is_main ? 1 - ct : ct];  // table in use

    for (int a = 0; a < 2; ++a) {
      if (!is_main && ty != (a == 0 ? C0RUN : C1RUN)) continue;
      const int lo = lo_[a], hi = hi_[a], Wa = Wst[a];
      const int so = off[a];
      // storage anchor: keep if the window fits, else minimal right shift;
      // must cover the seed column lo-1 and the window [lo, hi)
      int no = hi > so + Wa ? hi - Wa : so;
      no = min(no, lo - 1);
      if (hi > no + Wa) no = hi - Wa;
      // the JAX engine's re-anchoring shift (ops/beam2d_planned.py:
      // _jax_shift): lax.dynamic_slice wraps a negative start, then clamps
      int d = no - so + Wa + 1;
      if (d < 0) d += 3 * Wa + 2;
      d = min(max(d, 0), 2 * Wa + 2) - (Wa + 1);
      const int n = C * Wa;

      // ---- storage permute (MAIN) / re-anchor shift
      if (is_main) {
        const float* Sold = S[a][sb[a]];
        float* Snew = S[a][1 - sb[a]];
        const float* Pold = P[a][pb[a]];
        float* Pnew = P[a][1 - pb[a]];
        for (int k = tid; k < n; k += NT) {
          const int i = k / Wa, j = k - i * Wa;
          const int src = i < W ? sh.beam_src[i] : sh.child_idx[i];
          const int jj = j + d;
          Snew[k] = (src >= 0 && jj >= 0 && jj < Wa)
                        ? Sold[(long long)src * Wa + jj] : -INFINITY;
          // frozen parent copies; rows whose parent is in the table are
          // refreshed after the sweep and never read it before
          if (sh.refresh_idx[i] < 0)
            Pnew[k] = i < W ? Pold[(long long)sh.beam_src[i] * Wa + j]
                            : Sold[(long long)sh.beam_src[(i - W) / A] * Wa + j];
        }
        const bool wr = tid < C && sh.refresh_idx[tid] < 0;
        const int npo = wr ? (tid < W ? sh.poff[a][sh.beam_src[tid]] : so)
                           : 0;
        __syncthreads();
        if (wr) sh.poff[a][tid] = npo;
        sb[a] = 1 - sb[a];
        pb[a] = 1 - pb[a];
      } else if (d != 0) {
        const float* Sold = S[a][sb[a]];
        float* Snew = S[a][1 - sb[a]];
        for (int k = tid; k < n; k += NT) {
          const int i = k / Wa, j = k - i * Wa;
          const int jj = j + d;
          Snew[k] = (jj >= 0 && jj < Wa) ? Sold[(long long)i * Wa + jj]
                                         : -INFINITY;
        }
        sb[a] = 1 - sb[a];
      }
      __syncthreads();
      float* St = S[a][sb[a]];
      float* Pt = P[a][pb[a]];
      const float* ya = y[a];
      const int La = Lp[a], Ta = T[a];

      // ---- seeds: own value at lo-1
      if (tid < C) {
        const int sp = min(lo - 1 - no, Wa - 1);
        sh.seeds[tid] = sp >= 0 ? St[(long long)tid * Wa + sp] : -INFINITY;
        sh.mx[a][tid] = -INFINITY;
      }
      __syncthreads();

      const int nch = hi > lo ? (hi - lo + CHUNK - 1) / CHUNK : 0;
      for (int kc = 0; kc < nch; ++kc) {
        const int c_lo = lo + kc * CHUNK;
        if (tid < CHUNK) {
          const int t = c_lo + tid;
          for (int c = 0; c < A; ++c)
            sh.emis[c][tid] = t < Ta ? ya[(long long)c * La + t] : -INFINITY;
          sh.gapw[tid] = t < hi ? ya[(long long)A * La + t] : 0.f;
          sh.root[tid] = t <= Ta ? ya[(long long)(A + 1) * La + t] : -INFINITY;
        }
        if (tid < CMAX) sh.done[tid] = 0;
        __syncthreads();
        if (warp == 0) {
          // cw: float64 inclusive prefix sum of the gap weights, rounded once
          double v[4], run = 0.0;
          for (int q = 0; q < 4; ++q) {
            run += (double)sh.gapw[4 * lane + q];
            v[q] = run;
          }
          double incl = run;
          for (int o = 1; o < 32; o <<= 1) {
            const double t = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += t;
          }
          double excl = __shfl_up_sync(FULL, incl, 1);
          if (lane == 0) excl = 0.0;
          for (int q = 0; q < 4; ++q)
            sh.cwv[4 * lane + q] = (float)(excl + v[q]);
        }
        __syncthreads();

        // ---- layers over the parent forest
        for (int layer = 0; layer <= C; ++layer) {
          if (tid < C) {
            const int ps = sh.pslot[tid];
            sh.rdy[tid] = !sh.done[tid] && sh.smask[tid] &&
                          (ps < 0 || sh.done[ps]);
          }
          __syncthreads();
          if (tid == 0) {
            int c = 0;
            for (int i = 0; i < C; ++i)
              if (sh.rdy[i]) sh.rlist[c++] = i;
            sh.nready = c;
          }
          __syncthreads();
          const int nr = sh.nready;
          if (nr == 0) break;
          for (int q = warp; q < nr; q += NWARP) {
            const int row = sh.rlist[q];
            float* buf = sh.scan[warp];
            const int ps = sh.pslot[row];
            const int ch = tu.chr[row] < 0 ? 0 : tu.chr[row];
            const int po = sh.poff[a][row];
            const bool rt = sh.is_root[row];
            for (int w = lane; w < CHUNK; w += 32) {
              const int t = c_lo + w;
              float par;
              if (ps >= 0) {
                par = w == 0 ? sh.seeds[ps] : sh.cur[ps][w - 1];
              } else if (rt) {
                par = sh.root[w];
              } else {
                const int fi = t - 1 - po;
                par = (fi >= 0 && fi < Wa) ? Pt[(long long)row * Wa + fi]
                                           : -INFINITY;
              }
              const float E = t < hi ? par + sh.emis[ch][w] : -INFINITY;
              buf[w + 1] = E - sh.cwv[w];
            }
            if (lane == 0) buf[0] = sh.seeds[row];
            __syncwarp();
            warp_tree_scan(buf, lane);
            float mxw = -INFINITY;
            for (int w = lane; w < CHUNK; w += 32) {
              const float o = c_lo + w < hi ? buf[w + 1] + sh.cwv[w]
                                            : -INFINITY;
              sh.cur[row][w] = o;
              mxw = fmaxf(mxw, o);
            }
            mxw = warp_max(mxw);
            if (lane == 0) sh.mx[a][row] = fmaxf(sh.mx[a][row], mxw);
            __syncwarp();
          }
          __syncthreads();
          if (tid < C && sh.rdy[tid]) sh.done[tid] = 1;
          __syncthreads();
        }

        // ---- merge the chunk into storage; next chunk's seeds
        const int pos = c_lo - no;
        for (int k = tid; k < C * CHUNK; k += NT) {
          const int i = k / CHUNK, w = k - i * CHUNK;
          if (sh.smask[i] && c_lo + w < hi)
            St[(long long)i * Wa + pos + w] = sh.cur[i][w];
        }
        __syncthreads();
        if (tid < C && sh.smask[tid]) sh.seeds[tid] = sh.cur[tid][CHUNK - 1];
        __syncthreads();
      }

      // ---- frozen parent copies := parent's current storage
      for (int k = tid; k < n; k += NT) {
        const int i = k / Wa, j = k - i * Wa;
        const int r = sh.refresh_idx[i];
        if (r >= 0) Pt[k] = St[(long long)r * Wa + j];
      }
      __syncthreads();
      if (tid < C && sh.refresh_idx[tid] >= 0) sh.poff[a][tid] = no;
      off[a] = no;
      __syncthreads();
    }

    if (is_main) {
      Table& nt = sh.tab[1 - ct];
      if (tid < C)
        nt.score[tid] = nt.valid[tid] ? sh.mx[0][tid] + sh.mx[1][tid]
                                      : -INFINITY;
      ct = 1 - ct;
    }
    __syncthreads();
  }
  return ct;
}

}  // namespace pair_search
}  // namespace poreover
