// Dependent latencies of the instructions the DP kernels' chains are made
// of, CUDA for sm_90a. A measuring probe, on no path: chip_smoke.py works
// out the latency floors of viterbi.cu (a step), acceptor.cu (a label
// row) and pair_gamma.cu (a row) from them, as the least dependent chain
// of the code at these latencies.
//
// One CTA of NT threads; thread 0 times (clock64) a loop of `iters`
// dependent rounds of each kind: a float add; an add then a max (the max
// alone is their difference: a max of a value with itself or a constant
// could be folded, an add then a max cannot); a shuffle then a max (a
// scan level); a round trip through shared memory within a warp (store,
// __syncwarp, load of another lane's word), and within the CTA (store,
// __syncthreads of NT threads, load); a log-add-exp (common.cuh: lse, IEEE
// expf and log1pf) of the last result and that result less a constant
// near 1 (the kernels' operands differ by a few units), less 0.05, and
// less 0.05 + lane / 4 (the lanes' operands spread over 0.05-7.8); two
// independent log-add-exp chains a round; the same two with lse_flat, and
// lse_flat alone. Runtime values
// throughout, so that nothing folds; the result feeds a sink.
//
// Interface (plain C, loaded with ctypes): latency_probe(out, iters)
// writes the cycles per round of each kind to out[P_N] (host doubles) and
// returns a cudaError_t.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // the acceptor's threads per CTA
constexpr int U = 8;     // rounds per loop iteration, unrolled
constexpr unsigned FULL = 0xffffffffu;
enum { P_ADD, P_ADD_MAX, P_SHFL_MAX, P_WARP_RT, P_CTA_RT, P_LSE,
       P_LSE_NEAR, P_LSE_MIXED, P_LSE_TWO, P_FLAT, P_FLAT_TWO, P_N };

__global__ void __launch_bounds__(NT)
latency_kernel(long long* out, int iters) {
  __shared__ float sh[2][NT];
  const int tid = threadIdx.x;
  float x = tid * 1e-3f;
  const float c = iters * 1e-6f;
  const float d = 1.0f + c;
  const float dn = 0.05f + c, dm = 0.05f + 0.25f * (tid % 32) + c;
  long long cyc[P_N];
  long long t;

  __syncthreads();
  t = clock64();
  if (tid < 32)
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(c));
    }
  cyc[P_ADD] = clock64() - t;

  __syncthreads();
  t = clock64();
  if (tid < 32)
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(c));
        asm volatile("max.f32 %0, %0, %1;" : "+f"(x) : "f"(c));
      }
    }
  cyc[P_ADD_MAX] = clock64() - t;

  __syncthreads();
  t = clock64();
  if (tid < 32)
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        x = fmaxf(x, __shfl_xor_sync(FULL, x, 1 << (u % 5)));
    }
  cyc[P_SHFL_MAX] = clock64() - t;

  __syncthreads();
  t = clock64();
  if (tid < 32)
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sh[u & 1][tid] = x;
        __syncwarp();
        x = sh[u & 1][tid ^ 1];
      }
    }
  cyc[P_WARP_RT] = clock64() - t;

  __syncthreads();
  t = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sh[u & 1][tid] = x;
      __syncthreads();
      x = sh[u & 1][tid ^ 1];
    }
  }
  cyc[P_CTA_RT] = clock64() - t;

  __syncthreads();
  t = clock64();
  if (tid < 32)
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) x = poreover::lse(x, x - d);
    }
  cyc[P_LSE] = clock64() - t;

  __syncthreads();  // operands 0.05 apart: expf's result near 1
  t = clock64();
  if (tid < 32)
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) x = poreover::lse(x, x - dn);
    }
  cyc[P_LSE_NEAR] = clock64() - t;

  __syncthreads();  // each lane's operands 0.05 + lane / 4 apart
  t = clock64();
  if (tid < 32)
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) x = poreover::lse(x, x - dm);
    }
  cyc[P_LSE_MIXED] = clock64() - t;

  // two independent chains a round (x and z), then lse_flat alone and
  // in two chains
  float z = x + 0.5f;
  __syncthreads();
  t = clock64();
  if (tid < 32)
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x = poreover::lse(x, x - d);
        z = poreover::lse(z, z - d);
      }
    }
  cyc[P_LSE_TWO] = clock64() - t;

  __syncthreads();
  t = clock64();
  if (tid < 32)
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) x = poreover::lse_flat(x, x - d);
    }
  cyc[P_FLAT] = clock64() - t;

  __syncthreads();
  t = clock64();
  if (tid < 32)
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x = poreover::lse_flat(x, x - d);
        z = poreover::lse_flat(z, z - d);
      }
    }
  cyc[P_FLAT_TWO] = clock64() - t;
  x += z;

  if (tid == 0)
    for (int p = 0; p < P_N; ++p) out[p] = cyc[p];
  if (x == 1234.5f) out[P_N] = 1;  // the sink: x is used
}

}  // namespace

extern "C" {

int latency_probe(double* out, int iters) {
  long long* d = nullptr;
  cudaError_t err = cudaMalloc(&d, (P_N + 1) * sizeof(long long));
  if (err != cudaSuccess) return (int)err;
  latency_kernel<<<1, NT>>>(d, iters);
  err = cudaGetLastError();
  long long cyc[P_N + 1];
  if (err == cudaSuccess)
    err = cudaMemcpy(cyc, d, sizeof(cyc), cudaMemcpyDeviceToHost);
  cudaFree(d);
  if (err != cudaSuccess) return (int)err;
  for (int p = 0; p < P_N; ++p)
    out[p] = (double)cyc[p] / ((double)iters * U);
  return 0;
}

}  // extern "C"
