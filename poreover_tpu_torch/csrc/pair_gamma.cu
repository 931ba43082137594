// Pair gamma DP (ops/gamma.py): a CTA per workload walks the rows
// u = U-1..0 of its banded gamma matrix in order, the band's W cells
// across the threads. A row reads the row below it from shared memory and
// does, in the plain version's order: the log-sum-exp over the alphabet
// (in order from character 0), the window's gap prefix sums (XLA's blocked
// cumsum, base 16), the gamma* chain as a reverse inclusive log-add-exp
// scan (the odd/even tree of jax.lax.associative_scan on the flipped row)
// and the boundary cells. It writes only what the prefix search reads:
// the row of G[u, w] = gamma(u+1, env[u,0]+w+1) (w-major, [W-1][U], so
// that a level's threads over u read it coalesced) and gamma(0,0); the
// band itself stays in shared memory, a row at a time. Slices
// leaving the JAX package's padded rows are clamped as lax.dynamic_slice
// clamps them. IEEE expf / logf / log1pf, and each add that takes an expf or
// logf result is __fadd_rn, which is never contracted into the function's
// last product (the plain version adds in a launch of its own), so the
// kernel and the plain version agree bit for bit.
#include "common.cuh"

namespace {

using poreover::lse;

constexpr int kMaxA = 8;  // alphabet size the kernel takes (A+1 columns)
constexpr int kThreads = 256;
constexpr float kNegInf = -INFINITY;

// meta columns (ops/gamma.py: M_*)
enum { M_O1, M_U, M_O2, M_V, M_EOFF, M_W, M_G, M_S2, META_COLS };

__device__ __forceinline__ long long clamp_start(long long start,
                                                 long long size,
                                                 long long length) {
  start = start < 0 ? 0 : start;
  return start < length - size ? start : length - size;
}

// XLA's inclusive cumsum of x[0..n) in place (beam2d._cumsum_xla): blocks
// of 16 summed in order, the blocks' totals scanned the same way
// (recursively, in `scratch`), each block's exclusive prefix added last.
__device__ void cumsum_xla(float* x, int n, float* scratch) {
  float* lv[8];
  int ln[8];
  int depth = 0;
  lv[0] = x;
  ln[0] = n;
  float* sp = scratch;
  for (;;) {
    const int m = ln[depth];
    const int nb = (m + 15) / 16;
    float* v = lv[depth];
    for (int blk = threadIdx.x; blk < nb; blk += blockDim.x) {
      const int lo = blk * 16, hi = min(m, lo + 16);
      float acc = v[lo];
      for (int i = lo + 1; i < hi; ++i) {
        acc = __fadd_rn(v[i], acc);
        v[i] = acc;
      }
    }
    __syncthreads();
    if (nb <= 1) break;
    float* t = sp;
    sp += nb - 1;
    for (int k = threadIdx.x; k < nb - 1; k += blockDim.x)
      t[k] = v[k * 16 + 15];
    __syncthreads();
    ++depth;
    lv[depth] = t;
    ln[depth] = nb - 1;
  }
  for (int d = depth - 1; d >= 0; --d) {
    float* v = lv[d];
    const float* t = lv[d + 1];
    for (int i = 16 + threadIdx.x; i < ln[d]; i += blockDim.x)
      v[i] = __fadd_rn(v[i], t[i / 16 - 1]);
    __syncthreads();
  }
}

// Inclusive log-add-exp scan of x[0..n) in place, in the odd/even tree of
// jax.lax.associative_scan (beam2d._lse_scan_): level l's elements are
// x[(i+1) 2^l - 1]; up the tree odd elements take lse(even, odd), down
// it even elements (but the first) take lse(odd before, even).
__device__ void lse_scan(float* x, int n) {
  int lens[32];
  int L = 0, len = n, s = 1;
  while (len > 1) {
    const int half = len / 2;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int r = (2 * i + 2) * s - 1;
      x[r] = lse(x[r - s], x[r]);
    }
    __syncthreads();
    lens[L++] = len;
    len = half;
    s *= 2;
  }
  for (int l = L - 1; l >= 0; --l) {
    s = 1 << l;
    const int ne = (lens[l] - 1) / 2;
    for (int i = threadIdx.x; i < ne; i += blockDim.x) {
      const int k = i + 1;
      const int r = (2 * k + 1) * s - 1;
      x[r] = lse(x[r - s], x[r]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    pair_gamma_kernel(const float* __restrict__ y, const int* __restrict__ env,
                      const float* __restrict__ S1,
                      const float* __restrict__ S2,
                      const long long* __restrict__ meta, int A, int W_max,
                      float* __restrict__ G, float* __restrict__ g00) {
  extern __shared__ float smem[];
  const long long* m = meta + (long long)blockIdx.x * META_COLS;
  const long long o1 = m[M_O1], U = m[M_U], o2 = m[M_O2], V = m[M_V];
  const long long eoff = m[M_EOFF], W = m[M_W];
  const int C = A + 1;
  const long long p = W + 2;  // the JAX row pads
  float* gn = smem;           // the row below (u+1)
  float* gup = gn + W_max;    // gamma(u+1, v)
  float* cc = gup + W_max;    // C = gamma(u+1, v+1) + inner
  float* rb = cc + W_max;     // C + cG2, flipped, then scanned
  float* cs = rb + W_max;     // gap prefix sums
  float* lv = cs + W_max;     // their blocks' totals
  const float* y1 = y + o1 * C;
  const float* y2 = y + o2 * C;
  const float* S2w = S2 + m[M_S2];
  float* Gw = G + m[M_G];
  const int* ew = env + 2 * eoff;

  // ---- boundary row U: S2 on [start, end] and v < V, 0 at V
  long long off_next = ew[2 * U];
  {
    const long long endU = ew[2 * U + 1];
    const long long st = clamp_start(off_next + p, W, V + 1 + 2 * p);
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const long long si = st + w - p;
      float r = (si >= 0 && si <= V) ? S2w[si] : kNegInf;
      const long long v = off_next + w;
      if (!(v <= endU && v < V)) r = kNegInf;
      if (v == V && V <= endU) r = 0.0f;
      gn[w] = r;
    }
  }
  __syncthreads();

  for (long long u = U - 1; u >= 0; --u) {
    const long long off = ew[2 * u], end = ew[2 * u + 1];
    // G row u from the row below
    {
      const long long width = end - off;
      const long long lo = off + 1 - off_next;
      for (int w = threadIdx.x; w < W - 1; w += blockDim.x) {
        const long long take = lo + w;
        const float g = (w < width && take >= 0 && take < W) ? gn[take]
                                                              : kNegInf;
        Gw[(long long)w * U + u] = g;
      }
    }
    const long long shift = off - off_next;
    const long long lim = 2 * W + 4;
    const long long su = min(max(shift + p, 0LL), lim) - p;
    const long long sd = min(max(shift + 1 + p, 0LL), lim) - p;
    const long long sy = clamp_start(off + p, W, V + 2 * p) - p;
    const float* y1u = y1 + u * C;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const long long v = off + w;
      const bool in_range = v < end;
      const long long iu = su + w, id = sd + w;
      gup[w] = (iu >= 0 && iu < W) ? gn[iu] : kNegInf;
      const float gd = (id >= 0 && id < W) ? gn[id] : kNegInf;
      const long long vv = sy + w;
      const bool ok2 = vv >= 0 && vv < V;
      float x[kMaxA];
      float mx = kNegInf;
      for (int a = 0; a < A; ++a) {
        x[a] = __fadd_rn(y1u[a], ok2 ? y2[vv * C + a] : kNegInf);
        mx = fmaxf(mx, x[a]);
      }
      float inner = mx;
      if (isfinite(mx)) {
        float s = expf(__fsub_rn(x[0], mx));
        for (int a = 1; a < A; ++a)
          s = __fadd_rn(s, expf(__fsub_rn(x[a], mx)));
        inner = __fadd_rn(logf(s), mx);
      }
      cc[w] = in_range ? __fadd_rn(gd, inner) : kNegInf;
      cs[w] = (in_range && ok2) ? y2[vv * C + A] : 0.0f;
    }
    __syncthreads();
    cumsum_xla(cs, (int)W, lv);
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const float cg = w ? cs[w - 1] : 0.0f;
      rb[W - 1 - w] = __fadd_rn(cc[w], cg);
    }
    __syncthreads();
    lse_scan(rb, (int)W);
    const float gap1 = y1u[A];
    const float s1 = S1[eoff + u];
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const long long v = off + w;
      const bool in_range = v < end;
      const float cg = w ? cs[w - 1] : 0.0f;
      float r = kNegInf;
      if (in_range)
        r = lse(__fadd_rn(gup[w], gap1), __fsub_rn(rb[W - 1 - w], cg));
      if (v == V && V <= end) r = s1;
      gn[w] = r;
    }
    __syncthreads();
    off_next = off;
  }
  if (threadIdx.x == 0) {  // gn holds row 0
    const long long off0 = ew[0];
    g00[blockIdx.x] = (off0 <= 0 && 0 < off0 + W) ? gn[-off0] : kNegInf;
  }
}

}  // namespace

// Launches the DP of B packed workloads (ops/gamma.py: prepare_gamma) on
// `stream`; returns a cudaError_t.
extern "C" int pair_gamma_launch(const float* y, const int* env,
                                 const float* S1, const float* S2,
                                 const long long* meta, int B, int A,
                                 int W_max, float* G, float* g00,
                                 cudaStream_t stream) {
  if (B <= 0) return 0;
  if (A < 1 || A > kMaxA || W_max < 1) return (int)cudaErrorInvalidValue;
  // five rows and the cumsum's block totals (W/16 + W/256 + ... < W/15 + 4)
  const size_t smem = sizeof(float) * (5 * (size_t)W_max + W_max / 15 + 8);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pair_gamma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pair_gamma_kernel<<<B, kThreads, smem, stream>>>(y, env, S1, S2, meta, A,
                                                   W_max, G, g00);
  return (int)cudaGetLastError();
}
