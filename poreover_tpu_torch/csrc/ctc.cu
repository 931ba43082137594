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
// and 1).
//
// Design. One warp (one CTA of 32 threads) per sequence; state s is lane
// s % 32's, round s / 32. A time step is one pass over the warp's rounds
// reading the previous column from shared memory (double-buffered, a
// __syncwarp between steps: no block barrier); a step's five
// log-probabilities are read once by lanes 0-4, one step ahead, and handed
// to each state's lane with __shfl_sync by class. The forward pass writes
// every alpha column to global memory, [B, T+1, SP] float32 (SP: the
// padded state count, a multiple of 32), which the backward pass reads in
// reverse; the backward pass keeps gamma and the per-state edge terms in
// shared memory. Per class, each lane sums its states' terms in round
// order, then a __shfl_xor_sync butterfly (16, 8, 4, 2, 1) sums the 32
// lanes: a fixed order, no atomics, so the gradient is deterministic.
//
// What bounds it: the latency of T dependent steps per sequence (each a
// few log-add-exps per state per lane and a warp barrier); the bytes
// (logp read once, alpha written once and read once, the gradient
// written once) take tens of microseconds at the trainer's shapes, and
// B = 64 sequences fill 64 of the 132 SMs with one warp each.
//
// Interface (plain C, loaded with ctypes; see ops/ctc.py): logp float32
// [B, T, 5], labels int32 [B, L], label_lengths / logit_lengths int32 [B],
// alpha float32 [B, T+1, SP], nll float32 [B]; grad_out float32 [B], grad
// float32 [B, T, 5]. Each launch returns the CUDA error code.

#include "common.cuh"

namespace {

constexpr int C = 5;          // classes, blank last
constexpr int GAP = C - 1;
constexpr float NEG = -1e5f;  // the JAX loss's finite log 0
constexpr int SKIP = 8;       // state-table flag: the s-2 -> s move is allowed
constexpr unsigned FULL = 0xffffffffu;

using poreover::lse;

__device__ __forceinline__ int label_class(int x) {
  return min(max(x, 0), C - 2);
}

// Per state: the class it emits (bits 0-2) and, for merge, SKIP.
template <bool MERGE>
__device__ void fill_states(int* st, const int* lab, int S, int lane) {
  for (int s = lane; s < S; s += 32) {
    int code;
    if (MERGE) {
      if (s & 1) {
        const int c = label_class(lab[(s - 1) / 2]);
        code = c;
        if (s >= 3 && c != label_class(lab[(s - 3) / 2])) code |= SKIP;
      } else {
        code = GAP;
      }
    } else {
      code = s ? label_class(lab[s - 1]) : GAP;
    }
    st[s] = code;
  }
}

template <bool MERGE>
__global__ void __launch_bounds__(32)
ctc_alpha(const float* __restrict__ logp, const int* __restrict__ labels,
          const int* __restrict__ lab_len, const int* __restrict__ logit_len,
          int T, int L, int SP, float* __restrict__ alpha,
          float* __restrict__ nll) {
  extern __shared__ float sm[];
  float* const buf0 = sm;
  float* const buf1 = sm + SP;
  int* const st = reinterpret_cast<int*>(sm + 2 * SP);
  const int b = blockIdx.x, lane = threadIdx.x;
  const int Lb = min(max(lab_len[b], 0), L);
  const int Tb = min(max(logit_len[b], 0), T);
  const int S = MERGE ? 2 * Lb + 1 : Lb + 1;
  const int rounds = (S + 31) / 32;
  fill_states<MERGE>(st, labels + (long long)b * L, S, lane);
  float* const out = alpha + (long long)b * (T + 1) * SP;
  for (int s = lane; s < S; s += 32) {
    const float v = (!MERGE && s == 0) ? 0.f : NEG;
    buf0[s] = v;
    out[s] = v;
  }
  __syncwarp();
  const float* const lp = logp + (long long)b * T * C;
  float ynext = (lane < C && Tb > 0) ? lp[lane] : 0.f;
  for (int t = 0; t < Tb; ++t) {
    const float yl = ynext;
    if (lane < C && t + 1 < Tb) ynext = lp[(t + 1) * C + lane];
    const float g = __shfl_sync(FULL, yl, GAP);
    const float* const cur = (t & 1) ? buf1 : buf0;
    float* const nxt = (t & 1) ? buf0 : buf1;
    float* const row = out + (long long)(t + 1) * SP;
    for (int k = 0; k < rounds; ++k) {
      const int s = k * 32 + lane;
      const int code = s < S ? st[s] : GAP;
      const float e = __shfl_sync(FULL, yl, code & 7);
      if (s < S) {
        float v;
        if (!MERGE) {
          const float stay = __fadd_rn(cur[s], g);
          v = s == 0 ? stay : lse(__fadd_rn(cur[s - 1], e), stay);
        } else if (t == 0) {
          v = s < 2 ? e : NEG;
        } else {
          const float sh1 = s >= 1 ? cur[s - 1] : NEG;
          const float sk = (code & SKIP) ? cur[s - 2] : NEG;
          v = __fadd_rn(lse(lse(cur[s], sh1), sk), e);
        }
        nxt[s] = v;
        row[s] = v;
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    const float* const fin = (Tb & 1) ? buf1 : buf0;
    const float ll = MERGE ? lse(fin[2 * Lb], Lb > 0 ? fin[2 * Lb - 1] : NEG)
                           : fin[Lb];
    nll[b] = -ll;
  }
}

template <bool MERGE>
__global__ void __launch_bounds__(32)
ctc_grad(const float* __restrict__ logp, const int* __restrict__ labels,
         const int* __restrict__ lab_len, const int* __restrict__ logit_len,
         int T, int L, int SP, const float* __restrict__ alpha,
         const float* __restrict__ grad_out, float* __restrict__ grad) {
  extern __shared__ float sm[];
  float* const gam0 = sm;
  float* const gam1 = sm + SP;
  float* const X = sm + 2 * SP;  // plain: ge; merge: gp1
  float* const Y = sm + 3 * SP;  // plain: gs; merge: p1
  float* const Z = sm + 4 * SP;  // merge: gsk
  int* const st = reinterpret_cast<int*>(sm + 5 * SP);
  const int b = blockIdx.x, lane = threadIdx.x;
  const int Lb = min(max(lab_len[b], 0), L);
  const int Tb = min(max(logit_len[b], 0), T);
  const int S = MERGE ? 2 * Lb + 1 : Lb + 1;
  const int rounds = (S + 31) / 32;
  fill_states<MERGE>(st, labels + (long long)b * L, S, lane);
  const float* const al = alpha + (long long)b * (T + 1) * SP;
  const float* const lp = logp + (long long)b * T * C;
  float* const gr = grad + (long long)b * T * C;
  for (int i = Tb * C + lane; i < T * C; i += 32) gr[i] = 0.f;

  // gamma at Tb: weight on the state(s) the loss reads, zero elsewhere
  const float* const fin = al + (long long)Tb * SP;
  const float ll =
      MERGE ? lse(fin[2 * Lb], Lb > 0 ? fin[2 * Lb - 1] : NEG) : 0.f;
  {
    float* const g0 = (Tb & 1) ? gam1 : gam0;
    for (int s = lane; s < S; s += 32) {
      float v;
      if (!MERGE)
        v = s == Lb ? 1.f : 0.f;
      else
        v = (s == 2 * Lb || (Lb > 0 && s == 2 * Lb - 1)) ? expf(fin[s] - ll)
                                                         : 0.f;
      g0[s] = v;
    }
  }
  __syncwarp();
  const float mgo = -grad_out[b];
  float ynext = (lane < C && Tb > 0) ? lp[(Tb - 1) * C + lane] : 0.f;
  for (int t = Tb - 1; t >= 0; --t) {
    const float yl = ynext;
    if (lane < C && t > 0) ynext = lp[(t - 1) * C + lane];
    const float g = __shfl_sync(FULL, yl, GAP);
    const float* const gn = ((t + 1) & 1) ? gam1 : gam0;
    float* const gt = (t & 1) ? gam1 : gam0;
    const float* const a = al + (long long)t * SP;
    const float* const an = al + (long long)(t + 1) * SP;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    // pass 1: each state's edge terms and its class sums
    for (int k = 0; k < rounds; ++k) {
      const int s = k * 32 + lane;
      const int code = s < S ? st[s] : GAP;
      const float e = __shfl_sync(FULL, yl, code & 7);
      if (s < S) {
        const int cls = code & 7;
        const float gs_ = gn[s];
        if (!MERGE) {
          float ge = 0.f, gs = gs_;
          if (s > 0) {
            const float nw = an[s];
            ge = __fmul_rn(gs_, expf(__fadd_rn(a[s - 1], e) - nw));
            gs = __fmul_rn(gs_, expf(__fadd_rn(a[s], g) - nw));
          }
          X[s] = ge;
          Y[s] = gs;
          acc[GAP] = __fadd_rn(acc[GAP], gs);
#pragma unroll
          for (int c = 0; c < C - 1; ++c)
            acc[c] = __fadd_rn(acc[c], cls == c ? ge : 0.f);
        } else {
          float em = gs_;
          if (t == 0) {
            em = s < 2 ? gs_ : 0.f;
          } else {
            const float sh1 = s >= 1 ? a[s - 1] : NEG;
            const bool skip = code & SKIP;
            const float sk = skip ? a[s - 2] : NEG;
            const float p1 = lse(a[s], sh1);
            const float p2 = lse(p1, sk);
            X[s] = __fmul_rn(gs_, expf(p1 - p2));
            Y[s] = p1;
            Z[s] = skip ? __fmul_rn(gs_, expf(sk - p2)) : 0.f;
          }
#pragma unroll
          for (int c = 0; c < C; ++c)
            acc[c] = __fadd_rn(acc[c], cls == c ? em : 0.f);
        }
      }
    }
    __syncwarp();
    // pass 2: gamma before step t
    if (!MERGE || t > 0) {
      for (int k = 0; k < rounds; ++k) {
        const int s = k * 32 + lane;
        if (s < S) {
          float v;
          if (!MERGE) {
            v = __fadd_rn(Y[s], s + 1 < S ? X[s + 1] : 0.f);
          } else {
            const float as = a[s];
            v = __fmul_rn(X[s], expf(as - Y[s]));
            v = __fadd_rn(v, s + 1 < S ? __fmul_rn(X[s + 1],
                                                   expf(as - Y[s + 1]))
                                       : 0.f);
            v = __fadd_rn(v, s + 2 < S ? Z[s + 2] : 0.f);
          }
          gt[s] = v;
        }
      }
    }
    // the class sums over the warp, in a fixed order
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
    if (lane < C) gr[t * C + lane] = __fmul_rn(mgo, mine);
    __syncwarp();
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

int ctc_alpha_launch(const float* logp, const int* labels,
                     const int* lab_len, const int* logit_len, int B, int T,
                     int L, int SP, int merge, float* alpha, float* nll,
                     cudaStream_t stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)3 * SP * sizeof(float);
  auto kernel = merge ? ctc_alpha<true> : ctc_alpha<false>;
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<B, 32, smem, stream>>>(logp, labels, lab_len, logit_len, T, L, SP,
                                  alpha, nll);
  return (int)cudaGetLastError();
}

int ctc_grad_launch(const float* logp, const int* labels, const int* lab_len,
                    const int* logit_len, int B, int T, int L, int SP,
                    int merge, const float* alpha, const float* grad_out,
                    float* grad, cudaStream_t stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)6 * SP * sizeof(float);
  auto kernel = merge ? ctc_grad<true> : ctc_grad<false>;
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<B, 32, smem, stream>>>(logp, labels, lab_len, logit_len, T, L, SP,
                                  alpha, grad_out, grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
