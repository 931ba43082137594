// Masked Viterbi DP with traceback over a batch of reads, CUDA for sm_90a.
//
// The port's own kernel: the JAX package computes this DP as a lax.scan
// (poreover_tpu/ops/viterbi.py:27-95), not in Pallas. It is stage 1 of a
// flip-flop read (flip-flop `decode --algorithm viterbi`, and both reads
// of a flip-flop pair in `pair-decode`), and computes what the plain
// PyTorch version ops/viterbi.py:_viterbi_masked_padded computes, in the
// same float32 order, so the paths are equal: per step t and to-state j,
// best = the first maximum over from-states i of trans[j, i] + v[i], the
// back-pointer its i, and v'[j] = y[t, j] + best; the path ends in the
// first maximum of the last v. The transition matrix comes from the
// caller, so both mask modes (additive 0/1 bonuses, or -inf for a
// forbidden move) take the same kernel.
//
// Design. One warp per read, lane j < S the to-state (S <= 8): a step is S
// shuffles of v and a chain of compares, with no barrier. Each warp stages
// its read's emissions through shared memory CH steps at a time (one
// coalesced load) and writes the back-pointers (uint8) a chunk at a time.
// The traceback runs on the device too: the warp loads a chunk of
// back-pointers into shared memory, its lane 0 walks them, and the warp
// writes that chunk of the path. What bounds it: the latency of the step's
// dependent chain; one warp per read, so a batch of B reads keeps B warps
// busy.
//
// Interface (plain C, loaded with ctypes; see ops/viterbi.py): y float32
// [sum T, S] (reads back to back), meta int64 [B, 2] = (first row, T >= 1),
// trans float32 [S, S] (trans[j * S + i]: moving i -> j); scratch uint8
// [sum T, S] for the back-pointers; out path int32 [sum T].

#include "common.cuh"

namespace {

constexpr int SMAX = 8;
constexpr int WPB = 4;   // warps (reads) per CTA
constexpr int CH = 64;   // steps per staged chunk
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32 * WPB)
viterbi_kernel(const float* __restrict__ y, const long long* __restrict__ meta,
               const float* __restrict__ trans, int B, int S,
               unsigned char* __restrict__ ptrs, int* __restrict__ path) {
  __shared__ float ys[WPB][CH * SMAX];
  __shared__ unsigned char ps[WPB][CH * SMAX];
  __shared__ int pb[WPB][CH];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * WPB + w;
  if (b >= B) return;  // warp-uniform
  const long long o = meta[2 * b];
  const int T = (int)meta[2 * b + 1];
  const bool on = lane < S;
  float tr[SMAX];
#pragma unroll
  for (int i = 0; i < SMAX; ++i)
    tr[i] = (on && i < S) ? trans[lane * S + i] : -INFINITY;
  float v = on ? y[o * S + lane] : -INFINITY;

  // ---- forward: steps t0 .. t0 + n - 1 per chunk
  for (int t0 = 1; t0 < T; t0 += CH) {
    const int n = min(CH, T - t0);
    for (int k = lane; k < n * S; k += 32) ys[w][k] = y[(o + t0) * S + k];
    __syncwarp();
    for (int s = 0; s < n; ++s) {
      float best = tr[0] + __shfl_sync(FULL, v, 0);
      int arg = 0;
#pragma unroll
      for (int i = 1; i < SMAX; ++i) {
        if (i < S) {
          const float sc = tr[i] + __shfl_sync(FULL, v, i);
          if (sc > best) {
            best = sc;
            arg = i;
          }
        }
      }
      if (on) {
        v = ys[w][s * S + lane] + best;
        ps[w][s * S + lane] = (unsigned char)arg;
      }
    }
    __syncwarp();
    for (int k = lane; k < n * S; k += 32) ptrs[(o + t0) * S + k] = ps[w][k];
    __syncwarp();
  }

  // ---- the last state: the first maximum of v
  float bv = on ? v : -INFINITY;
  int bi = on ? lane : SMAX;
  for (int d = 16; d > 0; d >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, d);
    const int oi = __shfl_xor_sync(FULL, bi, d);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  // bi is lane 0's max only if some state is finite or all are equal;
  // with every v = -inf the first state wins, as in argmax
  int state = bi < S ? bi : 0;

  // ---- traceback, chunks of steps te down to tb
  for (int te = T - 1; te >= 1; te -= CH) {
    const int tb = max(1, te - CH + 1), n = te - tb + 1;
    __syncwarp();
    for (int k = lane; k < n * S; k += 32) ps[w][k] = ptrs[(o + tb) * S + k];
    __syncwarp();
    if (lane == 0) {
      for (int t = te; t >= tb; --t) {
        pb[w][t - tb] = state;
        state = ps[w][(t - tb) * S + state];
      }
    }
    state = __shfl_sync(FULL, state, 0);
    __syncwarp();
    for (int k = lane; k < n; k += 32) path[o + tb + k] = pb[w][k];
  }
  if (lane == 0) path[o] = state;
}

}  // namespace

extern "C" {

int viterbi_max_states() { return SMAX; }

// Launches ceil(B / WPB) CTAs of WPB warps on `stream`, one warp per read.
// Returns a cudaError_t (cudaErrorInvalidValue for S outside 1..SMAX).
int viterbi_launch(const float* y, const long long* meta, const float* trans,
                   int B, int S, unsigned char* ptrs, int* path,
                   void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || S > SMAX) return (int)cudaErrorInvalidValue;
  viterbi_kernel<<<(B + WPB - 1) / WPB, 32 * WPB, 0,
                   (cudaStream_t)stream>>>(y, meta, trans, B, S, ptrs, path);
  return (int)cudaGetLastError();
}

}  // extern "C"
