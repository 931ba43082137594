// Device helpers shared by the port's CUDA kernels (pair_beam_batch.cu,
// beam1d.cu). Header only; part of every kernel's build hash.
//
// No fast math: expf / log1pf stay IEEE, so a kernel and its plain PyTorch
// version agree bit for bit on the card. log(0) is -inf and
// lse(-inf, -inf) is -inf, never NaN.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace poreover {

// Knuth multiplicative constants of the two rolling 32-bit prefix hashes
constexpr unsigned M1 = 2654435761u;
constexpr unsigned M2 = 40503u;

// log(exp(a) + exp(b)) by the formula of torch.logaddexp.
__device__ __forceinline__ float lse(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

}  // namespace poreover
