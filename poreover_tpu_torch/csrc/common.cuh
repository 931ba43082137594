// Device helpers shared by the port's CUDA kernels, and their phase
// clocks. Header only; part of every kernel's build hash.
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

// lse bit for bit, NaN included, without its early return, which puts a
// branch on every call's chain: log1pf's argument, expf of a value <= 0
// and so in [0, 1], is clamped to [0, 1] (a saturating multiply), which
// leaves it as it is; at a == b = +-inf expf gives NaN, clamped to 0, and
// m + log1pf(0) is a, as lse returns. The maximum is PTX's max.NaN, which
// is fmaxf's max but NaN if an operand is NaN (fmaxf returns the other),
// so that a NaN operand gives NaN, as lse does; it is off the chain, which
// runs through expf and log1pf.
__device__ __forceinline__ float lse_flat(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  const float e = fminf(fmaxf(expf(-fabsf(a - b)), 0.0f), 1.0f);
  return m + log1pf(e);
}

// Reads a kernel's phase clocks (below): copies the sums to out[n]
// (blocking) and, with reset, zeroes them; returns a cudaError_t
// (cudaErrorInvalidValue unless n is the slots' count).
template <int N>
int phase_clocks_copy(const unsigned long long (&clocks)[N],
                      unsigned long long* out, int n, int reset) {
  if (n != N) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyFromSymbol(out, clocks, sizeof(clocks));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[N] = {};
    err = cudaMemcpyToSymbol(clocks, zero, sizeof(zero));
  }
  return (int)err;
}

}  // namespace poreover

// Per-phase cycle sums, compiled only with -DPOREOVER_PHASE_CLOCKS
// (build.py: build_kernel(..., defines)): the normal build has none of this
// code. A kernel source names its slots in an enum that ends in CK_N (and
// has a CK_SINK slot where it uses CLK_DEP), defines
// `__device__ unsigned long long g_phase_clocks[CK_N]`, and exports
// `phase_clocks_read` through poreover::phase_clocks_copy. In the kernel:
// CLK_INIT() starts a thread's clock64 mark and its sums (in registers),
// CLK(p) adds the cycles since the last mark to slot p, CLK_DEP(x) waits
// for a value before the next mark, CLK_ADD(p, n) adds a count, and
// CLK_FLUSH(who) adds the sums of the threads where `who` holds to
// g_phase_clocks (once per CTA: atomics).
#ifdef POREOVER_PHASE_CLOCKS
#define CLK_INIT()                       \
  long long clk_t_ = clock64();          \
  unsigned long long clk_acc_[CK_N] = {}
#define CLK(p)                                        \
  do {                                                \
    const long long n_ = clock64();                   \
    clk_acc_[p] += (unsigned long long)(n_ - clk_t_); \
    clk_t_ = n_;                                      \
  } while (0)
#define CLK_DEP(x)                                              \
  do {                                                          \
    if (__float_as_uint(x) == 0x7fbfffffu) ++clk_acc_[CK_SINK]; \
  } while (0)
#define CLK_ADD(p, n) clk_acc_[p] += (n)
#define CLK_FLUSH(who)                                \
  do {                                                \
    if (who)                                          \
      for (int p_ = 0; p_ < CK_N; ++p_)               \
        atomicAdd(&g_phase_clocks[p_], clk_acc_[p_]); \
  } while (0)
#else
#define CLK_INIT()
#define CLK(p)
#define CLK_DEP(x)
#define CLK_ADD(p, n)
#define CLK_FLUSH(who)
#endif
