// CTC loss forward-backward over a batch of sequences, CUDA for sm_90a.
//
// The port's own kernel: the JAX package computes the CTC loss as a
// lax.scan over time (poreover_tpu/ops/ctc.py:37, the plain "poreover"
// variant's scan at :77 and the merge-repeated (Graves) variant's at :124)
// and takes its gradient by autodiff inside the trainer's jitted update; it
// has no Pallas kernel for it. Two kernels, one per pass of the autograd
// function ops/ctc.py:ctc_cuda; each computes what the plain PyTorch
// version ops/ctc.py:ctc_plain computes, with the same float32 operations
// in the same order (multiplies and adds as __fmul_rn / __fadd_rn, so that
// nothing is contracted into an FMA), so that the loss and the gradient are
// bit-equal.
//
// Semantics (those of the JAX loss). logp [B, T, 5] log-probabilities,
// blank last; labels [B, L] in 0..3 (clamped to that range); per sequence
// Lb = label_lengths[b] and Tb = logit_lengths[b] (clamped to [0, L] and
// [0, T]); NEG = -1e5 is the finite stand-in for log 0 everywhere; lse is
// jnp.logaddexp's max + log1p(exp(-|a - b|)).
//   plain, states s = 0..Lb, alpha_0 = (0, NEG, ...):
//     alpha'(0) = alpha(0) + gap
//     alpha'(s) = lse(alpha(s-1) + y[label s-1], alpha(s) + gap)
//     nll = -alpha_Tb(Lb)
//   merge, states s = 0..2Lb (even: blank, odd: label (s-1)/2), all NEG at
//   first; at t = 0 alpha'(0) = gap, alpha'(1) = y[label 0], else NEG; at
//   t >= 1
//     alpha'(s) = lse(lse(alpha(s), alpha(s-1)), skip(s) ? alpha(s-2) : NEG)
//                 + y[class of s]
//   (alpha(-1) = NEG; skip(s) for odd s >= 3 whose label differs from the
//   one before), nll = -lse(alpha_Tb(2Lb), Lb > 0 ? alpha_Tb(2Lb-1) : NEG).
//   Steps t >= Tb leave alpha as it is and get a zero gradient.
//
// The backward pass is the adjoint of that recursion as autodiff takes it
// (jnp.logaddexp's derivative is exp(input - output)): gamma_t(s) =
// d ll / d alpha_t(s), the posterior occupancy of state s before step t. It
// starts with weight only on the state(s) the loss reads (plain: 1 at Lb;
// merge: exp(alpha - ll) at 2Lb and 2Lb-1), zero elsewhere, and per step
//   plain: ge(s) = gamma'(s) exp(alpha(s-1) + y - alpha'(s))  (emit edge)
//          gs(s) = gamma'(s) exp(alpha(s) + gap - alpha'(s))  (stay edge;
//                  gs(0) = gamma'(0))
//          gamma(s) = gs(s) + ge(s+1)
//   merge: p1 = lse(alpha(s), alpha(s-1)), p2 = lse(p1, skip term),
//          gp1(s) = gamma'(s) exp(p1 - p2), gsk(s) = gamma'(s) exp(sk - p2),
//          gamma(s) = (gp1(s) exp(alpha(s) - p1(s))
//                      + gp1(s+1) exp(alpha(s) - p1(s+1))) + gsk(s+2)
// and the gradient of class c at step t is -grad_out[b] times the sum of
// the edge occupancies that emit c (plain: gs for the blank, ge for the
// labels; merge: gamma'(s) for the class of s; at t = 0 only states 0
// and 1), summed in a fixed order: for each position l = s % 32 its
// states in increasing s, then an xor butterfly over the 32 positions
// (16, 8, 4, 2, 1), as ops/ctc.py:_fold does.
//
// Design. One CTA per sequence and pass; its threads own the states, K
// each (a compile-time instance; K = 1 at the trainer's shapes): state s =
// k * NT + tid for NT threads, so a time step is one log-add-exp deep
// (plain) or two (merging) in all threads at once. ops/ctc.py:
// launch_geometry picks NT, K, the ring and the shared bytes from the
// padded state count SP; the launchers check the geometry and follow it.
//   Alpha pass: each thread keeps its states' alpha in registers and
//   publishes them to a double-buffered column in shared memory, where its
//   neighbours read s-1 and s-2; one __syncthreads per step. The
//   log-probabilities come in chunks of YC rows, double-buffered in shared
//   memory, each copied with cp.async a chunk ahead. Every alpha column is
//   written to global memory, [B, T+1, SP] float32, for the backward pass.
//   Gradient pass, sequential kernel (ctc_grad): the alpha columns (plain:
//   with their log-probability rows) come in chunks of DC, two chunks of
//   ring slots in shared memory, each copied with cp.async a chunk before
//   its use, so no step waits on a global load. A step is two phases, each
//   ended by a __syncthreads: (A) each thread computes its states' edge
//   weights from the staged column and their products with gamma' (plain
//   ge, gs; merging gp1, gsk), publishes the ones its neighbours need in
//   shared memory and stores the step's class terms (plain ge and gs,
//   merging gamma') to global memory; (B) it sums its states' gamma from
//   its own products and its neighbours'. The stores are not waited for.
//   Gradient pass, parallel kernel (ctc_class): one warp per step sums the
//   class terms in the fixed order above and writes the gradient, so the
//   class sums never lengthen gamma's chain; no atomics, a deterministic
//   gradient.
//
// What bounds it: the latency of T dependent steps per sequence (a
// log-add-exp or two and one or two block barriers each); the bytes (logp
// read once, alpha written once and read once, the class terms written
// once and read once, the gradient written once) take tens of
// microseconds at the trainer's shapes. B = 64 sequences fill 64 of the
// 132 SMs with one CTA each.
//
// Interface (plain C, loaded with ctypes; see ops/ctc.py): logp float32
// [B, T, 5], labels int32 [B, L], label_lengths / logit_lengths int32 [B],
// alpha float32 [B, T+1, SP], nll float32 [B]; grad_out float32 [B], the
// class-term scratch float32 [B, T, SP] (plain: two), grad float32
// [B, T, 5]; the geometry (threads, K, ring, shared bytes). Each launch
// returns the CUDA error code.

#include "common.cuh"

namespace {

constexpr int C = 5;          // classes, blank last
constexpr int GAP = C - 1;
constexpr float NEG = -1e5f;  // the JAX loss's finite log 0
constexpr int SKIP = 8;       // state-code flag: the s-2 -> s move is allowed
constexpr int YS = 8;         // floats per staged log-probability row
constexpr int YC = 32;        // alpha pass: log-probability rows per chunk
constexpr int RING_MAX = 8;   // gradient pass: most columns per chunk
constexpr int CLASS_WARPS = 8;  // ctc_class: steps (warps) per CTA
constexpr unsigned FULL = 0xffffffffu;

using poreover::lse;

// Phase clocks (common.cuh; -DPOREOVER_PHASE_CLOCKS only). Thread 0 of
// each CTA marks the alpha pass's phases (the loads of a
// step's inputs, the log-add-exps and stores, the chunk's cp.async wait,
// the barrier) and the gradient pass's sequential kernel (phase A's
// weights and products, barrier 1, phase B's gamma, the chunk's copies and
// wait, barrier 2). CLK_DEP(x) waits for a loaded value before the next
// mark. The *_STEPS slots count steps.
#ifdef POREOVER_PHASE_CLOCKS
enum { CK_A_LOAD, CK_A_LSE, CK_A_WAIT, CK_A_BARRIER, CK_G_WEIGHTS,
       CK_G_BARRIER1, CK_G_GAMMA, CK_G_PREFETCH, CK_G_BARRIER2, CK_A_STEPS,
       CK_G_STEPS, CK_SINK, CK_N };
__device__ unsigned long long g_phase_clocks[CK_N];
#endif

__device__ __forceinline__ int label_class(int x) {
  return min(max(x, 0), C - 2);
}

// State s's code (0 <= s < S): the class it emits (bits 0-2) and, merging,
// SKIP.
template <bool MERGE>
__device__ __forceinline__ int state_code(const int* lab, int s) {
  if (MERGE) {
    if (!(s & 1)) return GAP;
    const int c = label_class(lab[(s - 1) / 2]);
    return (s >= 3 && c != label_class(lab[(s - 3) / 2])) ? (c | SKIP) : c;
  }
  return s ? label_class(lab[s - 1]) : GAP;
}

// One float from global to shared memory with cp.async, and the group
// operations on this thread's copies.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Largest CTA of an instance: K = 16 serves SP up to 16 x 608 with fewer
// threads and more registers each.
constexpr int max_threads(int K) { return K >= 16 ? 768 : 1024; }

// Alpha pass, one thread per K states. Shared memory: two columns of SP
// floats, then two chunks of YC rows of YS floats (the log-probabilities).
template <bool MERGE, int K>
__global__ void __launch_bounds__(max_threads(K))
ctc_alpha(const float* __restrict__ logp, const int* __restrict__ labels,
          const int* __restrict__ lab_len, const int* __restrict__ logit_len,
          int T, int L, int SP, float* __restrict__ alpha,
          float* __restrict__ nll) {
  extern __shared__ float sm[];
  float* const buf0 = sm;
  float* const buf1 = sm + SP;
  float* const yr = sm + 2 * SP;
  const int b = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int Lb = min(max(lab_len[b], 0), L);
  const int Tb = min(max(logit_len[b], 0), T);
  const int S = MERGE ? 2 * Lb + 1 : Lb + 1;
  const int* const lab = labels + (long long)b * L;
  const float* const lp = logp + (long long)b * T * C;
  float* const out = alpha + (long long)b * (T + 1) * SP;
  // rows [q YC, (q+1) YC) of the log-probabilities into chunk q & 1
  auto stage_rows = [&](int q) {
    for (int i = tid; i < YC * C; i += NT) {
      const int r = q * YC + i / C;
      if (r < Tb)
        copy_async(yr + ((q & 1) * YC + i / C) * YS + i % C,
                   lp + (long long)r * C + i % C);
    }
    commit_group();
  };
  float av[K];  // alpha of the thread's states
  int code[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * NT + tid;
    const float v = (!MERGE && s == 0) ? 0.f : NEG;
    code[k] = s < S ? state_code<MERGE>(lab, s) : GAP;
    av[k] = v;
    if (s < S) {
      buf0[s] = v;
      out[s] = v;
    }
  }
  stage_rows(0);
  stage_rows(1);
  wait_groups<1>();
  __syncthreads();
  CLK_INIT();
  for (int t = 0, q = 0, r = 0; t < Tb; ++t) {
    // chunk q + 1 into the buffer chunk q - 1 used (read before the last
    // barrier)
    if (r == 0 && q > 0) stage_rows(q + 1);
    const float* const y = yr + ((q & 1) * YC + r) * YS;
    const float* const cur = (t & 1) ? buf1 : buf0;
    float* const nxt = (t & 1) ? buf0 : buf1;
    float* const row = out + (long long)(t + 1) * SP;
    const float g = y[GAP];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = k * NT + tid;
      if (s < S) {
        const float e = y[code[k] & 7];
        float v;
        // neighbours at safe indices, loaded unconditionally, then picked
        const float c1 = cur[max(s - 1, 0)];
        if (!MERGE) {
          CLK_DEP(c1);
          CLK_DEP(e);
          CLK(CK_A_LOAD);
          const float stay = __fadd_rn(av[k], g);
          v = s == 0 ? stay : lse(__fadd_rn(c1, e), stay);
        } else if (t == 0) {
          CLK_DEP(e);
          CLK(CK_A_LOAD);
          v = s < 2 ? e : NEG;
        } else {
          const float c2 = cur[max(s - 2, 0)];
          const float sh1 = s >= 1 ? c1 : NEG;
          const float sk = (code[k] & SKIP) ? c2 : NEG;
          CLK_DEP(sh1);
          CLK_DEP(sk);
          CLK_DEP(e);
          CLK(CK_A_LOAD);
          v = __fadd_rn(lse(lse(av[k], sh1), sk), e);
        }
        av[k] = v;
        nxt[s] = v;
        row[s] = v;
        CLK_DEP(v);
        CLK(CK_A_LSE);
      }
    }
    if (++r == YC) {
      // chunk q + 1 in place before its first step
      wait_groups<0>();
      r = 0;
      ++q;
    }
    CLK(CK_A_WAIT);
    __syncthreads();
    CLK(CK_A_BARRIER);
    CLK_ADD(CK_A_STEPS, 1);
  }
  CLK_FLUSH(tid == 0);
  if (tid == 0) {
    const float* const fin = (Tb & 1) ? buf1 : buf0;
    const float ll = MERGE ? lse(fin[2 * Lb], Lb > 0 ? fin[2 * Lb - 1] : NEG)
                           : fin[Lb];
    nll[b] = -ll;
  }
}

// Gradient pass, sequential part: one thread per K states. Shared memory,
// floats: plain ge [SP]; merge gp1 [SP], gsk [SP]; then two chunks of DC
// ring slots of SP floats each (plain SP + YS: the column's
// log-probability row after it). Iteration i = Tb - 1 - t uses slot i % DC
// of chunk (i / DC) & 1. Each step's class terms go to `terms` (plain: ge
// [B, T, SP] then gs [B, T, SP]; merge: gamma' [B, T, SP]) for ctc_class.
template <bool MERGE, int K>
__global__ void __launch_bounds__(max_threads(K))
ctc_grad(const float* __restrict__ logp, const int* __restrict__ labels,
         const int* __restrict__ lab_len, const int* __restrict__ logit_len,
         int T, int L, int SP, int DC, const float* __restrict__ alpha,
         float* __restrict__ terms) {
  extern __shared__ float sm[];
  float* const P = sm;       // plain: ge; merge: gp1
  float* const Q = sm + SP;  // merge: gsk
  const int RS = MERGE ? SP : SP + YS;
  float* const ring = sm + (MERGE ? 2 : 1) * SP;
  const int b = blockIdx.x, tid = threadIdx.x, NT = blockDim.x;
  const int Lb = min(max(lab_len[b], 0), L);
  const int Tb = min(max(logit_len[b], 0), T);
  const int S = MERGE ? 2 * Lb + 1 : Lb + 1;
  const int* const lab = labels + (long long)b * L;
  const float* const al = alpha + (long long)b * (T + 1) * SP;
  const float* const lp = logp + (long long)b * T * C;
  float* const te = terms + (long long)b * T * SP;  // plain ge; merge gamma'
  float* const ts = te + (long long)gridDim.x * T * SP;  // plain gs
  // columns of iterations [q DC, (q+1) DC) (their states s < S; plain:
  // and their log-probability rows) into chunk q & 1
  auto stage_chunk = [&](int q) {
#pragma unroll 1
    for (int j = 0; j < DC; ++j) {
      const int c = Tb - 1 - (q * DC + j);
      if (c < 0) break;
      float* const slot = ring + ((q & 1) * DC + j) * RS;
      const float* const src = al + (long long)c * SP;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = k * NT + tid;
        if (s < S) copy_async(slot + s, src + s);
      }
      if (!MERGE && tid < C) copy_async(slot + SP + tid, lp + c * C + tid);
    }
    commit_group();
  };

  // gamma at Tb: weight on the state(s) the loss reads, zero elsewhere
  const float* const fin = al + (long long)Tb * SP;
  const float ll =
      MERGE ? lse(fin[2 * Lb], Lb > 0 ? fin[2 * Lb - 1] : NEG) : 0.f;
  float gam[K];        // gamma' of the thread's states
  float an[K];         // plain: alpha' of the thread's states
  float pr[K];         // plain: gs; merge: gp1
  float e3[K], e4[K];  // merge: exp(alpha(s) - p1(s)), ... - p1(s+1))
  int code[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * NT + tid;
    float v = 0.f;
    code[k] = GAP;
    an[k] = pr[k] = e3[k] = e4[k] = 0.f;
    if (s < S) {
      code[k] = state_code<MERGE>(lab, s);
      if (!MERGE) {
        v = s == Lb ? 1.f : 0.f;
        an[k] = fin[s];
      } else {
        v = (s == 2 * Lb || (Lb > 0 && s == 2 * Lb - 1)) ? expf(fin[s] - ll)
                                                         : 0.f;
      }
    }
    gam[k] = v;
  }
  stage_chunk(0);
  stage_chunk(1);
  wait_groups<1>();
  __syncthreads();
  CLK_INIT();
  for (int t = Tb - 1, q = 0, j = 0; t >= 0; --t) {
    const float* const a = ring + ((q & 1) * DC + j) * RS;
    float* const tet = te + (long long)t * SP;
    // phase A: the edge weights of step t and their products with gamma'
    if (!MERGE) {
      const float g = a[SP + GAP];
      float* const tst = ts + (long long)t * SP;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = k * NT + tid;
        if (s < S) {
          // neighbours at safe indices, loaded unconditionally, then picked
          const float as = a[s];
          const float e = a[SP + (code[k] & 7)];
          const float am = a[max(s - 1, 0)];
          const float we = expf(__fadd_rn(am, e) - an[k]);
          const float ws = expf(__fadd_rn(as, g) - an[k]);
          const float ge = s > 0 ? __fmul_rn(gam[k], we) : 0.f;
          const float gs = s > 0 ? __fmul_rn(gam[k], ws) : gam[k];
          P[s] = ge;
          tet[s] = ge;
          tst[s] = gs;
          pr[k] = gs;
          an[k] = as;
          CLK_DEP(gs);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = k * NT + tid;
        if (s < S) tet[s] = gam[k];
      }
      if (t > 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int s = k * NT + tid;
          if (s < S) {
            const float as = a[s];
            const float a1 = a[max(s - 1, 0)], a2 = a[max(s - 2, 0)];
            const float an1 = a[min(s + 1, S - 1)];
            const float sh1 = s >= 1 ? a1 : NEG;
            const bool skip = code[k] & SKIP;
            const float sk = skip ? a2 : NEG;
            const float p1 = lse(as, sh1);
            const float p2 = lse(p1, sk);
            const float gp1 = __fmul_rn(gam[k], expf(p1 - p2));
            const float gsk = __fmul_rn(gam[k], expf(sk - p2));
            const float w4 = expf(as - lse(an1, as));
            P[s] = gp1;
            Q[s] = skip ? gsk : 0.f;
            pr[k] = gp1;
            e3[k] = expf(as - p1);
            e4[k] = s + 1 < S ? w4 : 0.f;
            CLK_DEP(e4[k]);
          }
        }
      }
    }
    CLK(CK_G_WEIGHTS);
    __syncthreads();
    CLK(CK_G_BARRIER1);
    // phase B: gamma before step t from this thread's and its neighbours'
    // products
    if (!MERGE || t > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = k * NT + tid;
        if (s < S) {
          float v;
          if (!MERGE) {
            v = __fadd_rn(pr[k], s + 1 < S ? P[s + 1] : 0.f);
          } else {
            v = __fmul_rn(pr[k], e3[k]);
            v = __fadd_rn(v, s + 1 < S ? __fmul_rn(P[s + 1], e4[k]) : 0.f);
            v = __fadd_rn(v, s + 2 < S ? Q[s + 2] : 0.f);
          }
          gam[k] = v;
          CLK_DEP(v);
        }
      }
    }
    CLK(CK_G_GAMMA);
    if (++j == DC) {
      // chunk q's buffer is read: chunk q + 2 into it, chunk q + 1 in place
      stage_chunk(q + 2);
      wait_groups<1>();
      j = 0;
      ++q;
    }
    CLK(CK_G_PREFETCH);
    __syncthreads();
    CLK(CK_G_BARRIER2);
    CLK_ADD(CK_G_STEPS, 1);
  }
  CLK_FLUSH(tid == 0);
}

// Gradient pass, parallel part: one warp per step t of sequence b sums the
// step's class terms in the order of ops/ctc.py:_fold (each lane its
// states s = lane, lane + 32, ... below S in turn, all five classes at
// once, then the xor butterfly) and writes -grad_out[b] times each sum
// (zeros at t >= Tb). Plain: gs to the blank, ge to the state's label;
// merge: gamma' to the state's class, at t = 0 only states 0 and 1.
template <bool MERGE>
__global__ void __launch_bounds__(CLASS_WARPS * 32)
ctc_class(const int* __restrict__ labels, const int* __restrict__ lab_len,
          const int* __restrict__ logit_len, int T, int L, int SP,
          const float* __restrict__ terms, const float* __restrict__ grad_out,
          float* __restrict__ grad) {
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int t = blockIdx.x * CLASS_WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const int Lb = min(max(lab_len[b], 0), L);
  const int Tb = min(max(logit_len[b], 0), T);
  const int S = MERGE ? 2 * Lb + 1 : Lb + 1;
  float* const gr = grad + ((long long)b * T + t) * C;
  if (t >= Tb) {
    if (lane < C) gr[lane] = 0.f;
    return;
  }
  const int* const lab = labels + (long long)b * L;
  const float* const te = terms + ((long long)b * T + t) * SP;
  const float* const ts = te + (long long)gridDim.y * T * SP;
  const int live = (MERGE && t == 0) ? 2 : S;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int s = lane; s < S; s += 32) {
    const int cls = state_code<MERGE>(lab, s) & 7;
    if (!MERGE) {
      const float ge = te[s];
      acc[GAP] = __fadd_rn(acc[GAP], ts[s]);
#pragma unroll
      for (int c = 0; c < C - 1; ++c)
        acc[c] = __fadd_rn(acc[c], cls == c ? ge : 0.f);
    } else {
      const float em = s < live ? te[s] : 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[c] = __fadd_rn(acc[c], cls == c ? em : 0.f);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[c] = __fadd_rn(acc[c], __shfl_xor_sync(FULL, acc[c], off));
  }
  float mine = acc[0];
#pragma unroll
  for (int c = 1; c < C; ++c)
    if (lane == c) mine = acc[c];
  if (lane < C) gr[lane] = __fmul_rn(-grad_out[b], mine);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The shared bytes a launch needs (ops/ctc.py:launch_geometry computes the
// same), or 0 if the kernels do not take the geometry. ring: the alpha
// pass's rows per chunk (YC), the gradient pass's columns per chunk (1 to
// RING_MAX); two chunks each.
size_t smem_needed(bool grad, bool merge, int SP, int threads, int K,
                   int ring) {
  if (threads % 32 || threads <= 0 || threads > max_threads(K) ||
      (long long)threads * K < SP ||
      (grad ? ring < 1 || ring > RING_MAX : ring != YC) ||
      (K != 1 && K != 2 && K != 4 && K != 8 && K != 16))
    return 0;
  if (!grad) return (size_t)(2 * SP + 2 * ring * YS) * sizeof(float);
  const size_t slot = merge ? SP : SP + YS;
  return ((merge ? 2 : 1) * (size_t)SP + 2 * ring * slot) * sizeof(float);
}

template <bool MERGE>
auto alpha_kernel(int K) {
  switch (K) {
    case 1: return ctc_alpha<MERGE, 1>;
    case 2: return ctc_alpha<MERGE, 2>;
    case 4: return ctc_alpha<MERGE, 4>;
    case 8: return ctc_alpha<MERGE, 8>;
    default: return ctc_alpha<MERGE, 16>;
  }
}

template <bool MERGE>
auto grad_kernel(int K) {
  switch (K) {
    case 1: return ctc_grad<MERGE, 1>;
    case 2: return ctc_grad<MERGE, 2>;
    case 4: return ctc_grad<MERGE, 4>;
    case 8: return ctc_grad<MERGE, 8>;
    default: return ctc_grad<MERGE, 16>;
  }
}

}  // namespace

extern "C" {

int ctc_alpha_launch(const float* logp, const int* labels,
                     const int* lab_len, const int* logit_len, int B, int T,
                     int L, int SP, int merge, int threads, int K, int ring,
                     int smem, float* alpha, float* nll,
                     cudaStream_t stream) {
  const size_t need = smem_needed(false, merge, SP, threads, K, ring);
  if (need == 0 || (size_t)smem != need) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  auto kernel = merge ? alpha_kernel<true>(K) : alpha_kernel<false>(K);
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<B, threads, smem, stream>>>(logp, labels, lab_len, logit_len, T,
                                       L, SP, alpha, nll);
  return (int)cudaGetLastError();
}

// terms: scratch of [B, T, SP] float32 (plain: two of them, ge then gs).
int ctc_grad_launch(const float* logp, const int* labels, const int* lab_len,
                    const int* logit_len, int B, int T, int L, int SP,
                    int merge, int threads, int K, int ring, int smem,
                    const float* alpha, const float* grad_out, float* terms,
                    float* grad, cudaStream_t stream) {
  const size_t need = smem_needed(true, merge, SP, threads, K, ring);
  if (need == 0 || (size_t)smem != need) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return 0;
  auto kernel = merge ? grad_kernel<true>(K) : grad_kernel<false>(K);
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<B, threads, smem, stream>>>(logp, labels, lab_len, logit_len, T,
                                       L, SP, ring, alpha, terms);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  const dim3 grid((T + CLASS_WARPS - 1) / CLASS_WARPS, B);
  auto sums = merge ? ctc_class<true> : ctc_class<false>;
  sums<<<grid, CLASS_WARPS * 32, 0, stream>>>(labels, lab_len, logit_len, T,
                                              L, SP, terms, grad_out, grad);
  return (int)cudaGetLastError();
}

#ifdef POREOVER_PHASE_CLOCKS
// The phase sums (common.cuh: phase_clocks_copy).
int phase_clocks_read(unsigned long long* out, int n, int reset) {
  return poreover::phase_clocks_copy(g_phase_clocks, out, n, reset);
}
#endif

}  // extern "C"
