// One level of the pair prefix search (ops/pair_prefix.py) for every live
// workload of a batch, in one launch. Per workload and extension
// character c:
//
// - the label forward, one CTA per read: alpha[t] = cw[t] +
//   cumlse(E - cw)[t] with E[t] = y[t,c] + prev[t-1] and the level-1 seed
//   y[0,c], in float64 through the odd/even tree of
//   jax.lax.associative_scan (in place in global scratch, the tree's levels
//   across the CTA's threads), rounded to float32 into this level's alpha
//   buffer. The second of the two CTAs to finish writes label_prob[c] =
//   alpha_1[U-1] + alpha_2[V-1] - gamma00.
// - the envelope reduction, one CTA per kRows rows u: prefix_prob[c] =
//   lse_u(alpha*_1[u] + lse_w(alpha*_2[env[u,0]+w] + G[w][u])) - gamma00,
//   alpha*[t] = prev[t-1] + y[t,c] (seed 0 at level 1). A first pass takes
//   each row's largest term, mt[u] = alpha*_1[u] + max_w(...), without
//   exponentials; a row whose mt is more than kSkip below the CTA's largest
//   (a lower bound of the largest val of all rows) is not summed: its term
//   exp(val[u] - max) underflows to exactly 0 in float32 (val[u] <= mt[u] +
//   log(width)), so leaving it out keeps every bit. The others' val[u] go
//   to global scratch, and the last CTA of the workload and character to
//   finish takes the largest of them and sums exp(val - max) over all rows.
//   Both log-sum-exps add their terms in a pairwise tree (adjacent pairs
//   over the length padded to a power of two with zeros), as the plain
//   version does: a thread sums a power-of-two run of terms with a stack of
//   subtree sums, the CTA sums the threads' runs in a tree in shared memory.
//
// The previous level's chosen row of alpha is picked by index (sel), so
// only the outputs (2 A floats per workload) go back to the host. IEEE
// expf / logf / log1pf / exp / log1p; each add that takes an expf or logf
// result is __fadd_rn, never contracted into the function's last product
// (the plain version adds in a launch of its own): bit-equal to the plain
// version on the card.
#include "common.cuh"

namespace {

using poreover::lse;

constexpr int kThreads = 512;
constexpr int kRows = 2048;  // envelope rows per CTA
constexpr float kNegInf = -INFINITY;
// a row whose largest term is this far below the largest row's is left out
// of the sum over rows: exp(x) is 0 in float32 below ~-103.3, and a row's
// sum over its window exceeds its largest term by at most log(width)
constexpr float kSkip = 160.0f;

// level meta columns (ops/pair_prefix.py: L_*)
enum { L_O1, L_U, L_O2, L_V, L_EOFF, L_WB, L_G, L_VOFF, LEVEL_COLS };

__device__ __forceinline__ double lse_d(double a, double b) {
  if (isinf(a) && a == b) return a;
  const double m = fmax(a, b);
  return m + log1p(exp(-fabs(a - b)));
}

// Inclusive log-add-exp scan of x[0..n) in place, the tree of
// jax.lax.associative_scan (as csrc/pair_gamma.cu: lse_scan), in float64.
__device__ void lse_scan_d(double* x, long long n) {
  long long lens[48];
  int L = 0;
  long long len = n, s = 1;
  while (len > 1) {
    const long long half = len / 2;
    for (long long i = threadIdx.x; i < half; i += blockDim.x) {
      const long long r = (2 * i + 2) * s - 1;
      x[r] = lse_d(x[r - s], x[r]);
    }
    __syncthreads();
    lens[L++] = len;
    len = half;
    s *= 2;
  }
  for (int l = L - 1; l >= 0; --l) {
    s = 1LL << l;
    const long long ne = (lens[l] - 1) / 2;
    for (long long i = threadIdx.x; i < ne; i += blockDim.x) {
      const long long r = (2 * (i + 1) + 1) * s - 1;
      x[r] = lse_d(x[r - s], x[r]);
    }
    __syncthreads();
  }
}

// Pairwise sum of a run of leaves, fed in order: the stack holds the sums
// of complete subtrees; `total` folds it as if the run were padded with
// zeros to a power of two.
struct PairSum {
  float stk[40];
  int sp = 0;
  long long n = 0;
  __device__ void add(float v) {
    for (long long k = n; k & 1; k >>= 1) v = __fadd_rn(stk[--sp], v);
    stk[sp++] = v;
    ++n;
  }
  __device__ float total() {
    if (sp == 0) return 0.0f;
    float r = stk[--sp];
    while (sp > 0) r = __fadd_rn(stk[--sp], r);
    return r;
  }
};

__device__ float block_max(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = fmaxf(red[threadIdx.x],
                                                  red[threadIdx.x + s]);
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// sum of the threads' values (thread order = leaf order) in a pairwise tree
__device__ float block_tree_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = 1; s < (int)blockDim.x; s <<= 1) {
    if ((threadIdx.x & (2 * s - 1)) == 0)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

struct Level {
  const float* y;
  const double* cw;
  const int* env;
  const float* G;
  const float* g00;
  const long long* meta;
  const int* live;
  const int* sel;
  float* alpha;
  double* scan;
  float* val;
  float* cmax;     // [n][A][chunks] each envelope CTA's largest val
  float* lastv;    // [n][A][2] each read's alpha at its last frame
  unsigned* cnt;   // [n][A][2] CTAs finished: label forward, envelope
  float* res;
  long long N, n_rows;
  int A, level, parity, chunks;
};

// Thread 0 of a CTA that wrote its part counts itself in; returns (to every
// thread) whether it was the group's last, after which the group's writes
// are visible to it (read them with __ldcg: L1 is not coherent).
__device__ bool last_of(unsigned* cnt, unsigned group) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(cnt, 1u) == group - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__device__ void label_forward(const Level& P, int i, int b, int c, int r) {
  const long long* m = P.meta + (long long)b * LEVEL_COLS;
  const int C = P.A + 1;
  const long long o = m[r ? L_O2 : L_O1], T = m[r ? L_V : L_U];
  const float* y = P.y + o * C;
  const float* prev =
      P.alpha + ((long long)(1 - P.parity) * P.A + P.sel[b]) * P.N + o;
  float* out = P.alpha + ((long long)P.parity * P.A + c) * P.N + o;
  const double* cw = P.cw + o;
  double* x = P.scan + (long long)c * P.N + o;
  const float fw0 = P.level == 1 ? y[c] : kNegInf;
  for (long long t = threadIdx.x; t < T; t += blockDim.x)
    x[t] = t == 0 ? (double)fw0
                  : __dsub_rn(__dadd_rn(y[t * C + c], prev[t - 1]), cw[t]);
  __syncthreads();
  lse_scan_d(x, T);
  for (long long t = threadIdx.x; t < T; t += blockDim.x)
    out[t] = t == 0 ? fw0 : __double2float_rn(__dadd_rn(x[t], cw[t]));
  const long long g = (long long)i * P.A + c;
  if (threadIdx.x == 0)
    P.lastv[2 * g + r] =
        T == 1 ? fw0 : __double2float_rn(__dadd_rn(x[T - 1], cw[T - 1]));
  if (last_of(P.cnt + 2 * g, 2) && threadIdx.x == 0) {
    P.res[((long long)i * 2 + 1) * P.A + c] = __fsub_rn(
        __fadd_rn(__ldcg(P.lastv + 2 * g), __ldcg(P.lastv + 2 * g + 1)),
        P.g00[b]);
    P.cnt[2 * g] = 0;  // for the next launch
  }
}

__device__ void envelope_sum(const Level& P, int i, int b, int c, int k,
                             float* red) {
  const long long* m = P.meta + (long long)b * LEVEL_COLS;
  const int C = P.A + 1;
  const long long U = m[L_U], V = m[L_V], Wb = m[L_WB];
  const long long chunks = (U + kRows - 1) / kRows;
  if (k >= chunks) return;
  const float seed = P.level == 1 ? 0.0f : kNegInf;
  const float* prev_buf =
      P.alpha + ((long long)(1 - P.parity) * P.A + P.sel[b]) * P.N;
  const float* prev1 = prev_buf + m[L_O1];
  const float* prev2 = prev_buf + m[L_O2];
  const float* y1 = P.y + m[L_O1] * C + c;
  const float* y2 = P.y + m[L_O2] * C + c;
  const int* env = P.env + 2 * m[L_EOFF];
  const float* G = P.G + m[L_G];
  float* val = P.val + (long long)c * P.n_rows + m[L_VOFF];
  const long long g = (long long)i * P.A + c;

  // the row's terms alpha*_2[v] + G[w][u], v = clip(env[u,0] + w, 0, V+Wb)
  auto term = [&](long long u, long long w, long long s) -> float {
    long long v = s + w;
    v = v < 0 ? 0 : (v > V + Wb ? V + Wb : v);
    const bool ok = v < V;
    const long long vi = ok ? v : 0;
    const float a2 = __fadd_rn(vi == 0 ? seed : prev2[vi - 1], y2[vi * C]);
    return ok ? __fadd_rn(a2, G[w * U + u]) : kNegInf;
  };
  auto alpha1 = [&](long long u) {
    return __fadd_rn(u == 0 ? seed : prev1[u - 1], y1[u * C]);
  };

  // pass 1: each row's largest term
  const long long u0 = k * kRows, u1 = min(U, u0 + kRows);
  float L = kNegInf;
  for (long long u = u0 + threadIdx.x; u < u1; u += blockDim.x) {
    const long long s = env[2 * u];
    const long long wn = min(env[2 * u + 1] - s, Wb);
    float mx = kNegInf;
#pragma unroll 4
    for (long long w = 0; w < wn; ++w) mx = fmaxf(mx, term(u, w, s));
    const float mt = __fadd_rn(alpha1(u), mx);
    val[u] = mt;
    L = fmaxf(L, mt);
  }
  L = block_max(L, red);
  // pass 2: the rows within kSkip of the largest, summed over w
  float M = kNegInf;
  for (long long u = u0 + threadIdx.x; u < u1; u += blockDim.x) {
    float v = kNegInf;
    if (isfinite(L) && val[u] >= L - kSkip) {
      const long long s = env[2 * u];
      const long long wn = min(env[2 * u + 1] - s, Wb);
      float mx = kNegInf;
#pragma unroll 4
      for (long long w = 0; w < wn; ++w) mx = fmaxf(mx, term(u, w, s));
      float inner = mx;
      if (isfinite(mx)) {
        PairSum ps;
        for (long long w = 0; w < wn; ++w)
          ps.add(expf(__fsub_rn(term(u, w, s), mx)));
        inner = __fadd_rn(logf(ps.total()), mx);
      }
      v = __fadd_rn(alpha1(u), inner);
    }
    val[u] = v;
    M = fmaxf(M, v);
  }
  M = block_max(M, red);
  if (threadIdx.x == 0) P.cmax[g * P.chunks + k] = M;
  if (!last_of(P.cnt + 2 * g + 1, (unsigned)chunks)) return;

  // the group's last CTA: the largest val, then the sum over all rows, a
  // power-of-two run of rows per thread
  M = kNegInf;
  for (long long j = 0; j < chunks; ++j)
    M = fmaxf(M, __ldcg(P.cmax + g * P.chunks + j));
  float out = M;
  if (isfinite(M)) {
    long long ch = 1;
    while (ch * blockDim.x < U) ch <<= 1;
    PairSum ps;
    const long long lo = (long long)threadIdx.x * ch;
    const long long hi = min(U, lo + ch);
    for (long long u = lo; u < hi; u += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = u + j < hi ? __ldcg(val + u + j) : kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (u + j < hi) ps.add(expf(__fsub_rn(x[j], M)));
    }
    const float S = block_tree_sum(ps.total(), red);
    out = __fadd_rn(logf(S), M);
  }
  if (threadIdx.x == 0) {
    P.res[((long long)i * 2) * P.A + c] = __fsub_rn(out, P.g00[b]);
    P.cnt[2 * g + 1] = 0;  // for the next launch
  }
}

// The label forwards first (blockIdx.x = live slot * 2 A + 2 c + read):
// they are the launch's longest CTAs, so they start in the first wave of
// CTAs; then the envelope rows (live slot * A chunks + A chunk + c).
__global__ void __launch_bounds__(kThreads)
    pair_prefix_kernel(Level P, int n) {
  __shared__ float red[kThreads];
  const int scans = n * 2 * P.A;
  if ((int)blockIdx.x < scans) {
    const int i = blockIdx.x / (2 * P.A), j = blockIdx.x % (2 * P.A);
    label_forward(P, i, P.live[i], j / 2, j % 2);
  } else {
    const int e = blockIdx.x - scans, per = P.A * P.chunks;
    const int i = e / per, j = e % per;
    envelope_sum(P, i, P.live[i], j % P.A, j / P.A, red);
  }
}

}  // namespace

// One level of the search over the n live workloads (ops/pair_prefix.py:
// level_cuda) on `stream`: N frames, n_rows envelope rows in all, at most
// `chunks` CTAs of kRows rows for a workload's envelope; returns a
// cudaError_t. `cnt` must be zero on entry (it is again on return).
extern "C" int pair_prefix_launch(const float* y, const double* cw,
                                  const int* env, const float* G,
                                  const float* g00, const long long* meta,
                                  const int* live, const int* sel,
                                  float* alpha, double* scan, float* val,
                                  float* cmax, float* lastv, unsigned* cnt,
                                  float* res, long long N, long long n_rows,
                                  int n, int A, int level, int parity,
                                  int chunks, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (A < 1 || level < 1 || chunks < 1) return (int)cudaErrorInvalidValue;
  const Level P{y,     cw,    env, G,   g00, meta,   live, sel,
                alpha, scan,  val, cmax, lastv, cnt, res,  N,
                n_rows, A,    level, parity, chunks};
  pair_prefix_kernel<<<n * A * (2 + chunks), kThreads, 0, stream>>>(P, n);
  return (int)cudaGetLastError();
}

extern "C" int pair_prefix_rows_per_cta() { return kRows; }
