// Pair gamma DP (ops/gamma.py): each workload's rows u = U-1..0 of its
// banded gamma matrix, in order. A row takes from the row below it, in the
// plain version's order: the log-sum-exp over the alphabet (in order from
// character 0), the window's gap prefix sums (XLA's blocked cumsum, base
// 16), the gamma* chain as a reverse inclusive log-add-exp scan (the
// odd/even tree of jax.lax.associative_scan on the flipped row) and the
// boundary cells. It writes only what the prefix search reads: the row of
// G[u, w] = gamma(u+1, env[u,0]+w+1) (w-major, [W-1][U], so that a level's
// threads over u read it coalesced) and gamma(0,0); the band itself stays
// on chip, a row at a time. Slices leaving the JAX package's padded rows
// are clamped as lax.dynamic_slice clamps them. IEEE expf / logf / log1pf,
// and each add that takes an expf or logf result is __fadd_rn, which is
// never contracted into the function's last product (the plain version
// adds in a launch of its own), so the kernel and the plain version agree
// bit for bit. It replaces no Pallas kernel: the JAX package runs this DP
// as a lax.scan (poreover_tpu/ops/gamma.py:_gamma_scan).
//
// What bounds it: one row's dependent chain. A row needs the row below, and
// its scan is ~2 log2(width) log-add-exps deep (an expf and a log1pf each,
// ~140-190 cycles on the H100), so a workload is a serial walk of rows of
// ~1.2-1.5k cycles at the least; the bytes (the reads, G) are ~15 us of a
// ~60 ms wave.
//
// The warp instance (bands of up to kMaxWarpW cells) takes that chain as
// its design. Each workload has a consumer warp and kNP producer warps:
// - the producers compute, for rows ahead of the chain, everything that
//   does not depend on the row below (the alphabet's log-sum-exp per cell,
//   the gap prefix sums, the row's shifts, boundary cell and which scan
//   levels have work) into a ring of kNB chunks of R rows in shared
//   memory, a chunk each in turn, handed over with mbarriers; each stages
//   its chunk's window of read 2 with one bulk asynchronous copy
//   (cp.async.bulk), loads the next row's own inputs a row ahead, and
//   flushes the G rows the consumer left in the chunk's tile along u,
//   coalesced;
// - the consumer runs only the chain: the row below's cells (a round trip
//   through shared memory within the warp), C = gd + inner, + the gap sums,
//   the scan and the final log-add-exp, with no CTA barrier. A row whose
//   cells lie in the flipped row's last 32 (nearly all of them) has a cell
//   a lane and every level by shuffles; a wider one has E consecutive cells
//   a lane (E = 1, 2 or 4 by the launch's widest band), the tree's levels
//   below E in registers, the others by shuffles. Either way the same nodes
//   combine the same operands as in the plain version. A row's cells at w
//   >= its width are -inf and sit first in the flipped row, and lse(-inf,
//   x) is x bit for bit (the scan's operands are never -0), so a level
//   whose nodes all have an all -inf side is skipped. The log-add-exp is
//   common.cuh:lse_flat, lse's bits without its early return.
// A CTA takes one workload. Bands wider than kMaxWarpW (wider than any the
// main path has, 13-83 cells; the dense boxes of pair-decode --method
// split|align) go to the CTA-wide instance (the first design): a CTA per
// workload, the band across 256 threads, a CTA barrier between the passes
// and the scan's levels, its rows in shared memory, or in global scratch
// for bands over ~11k cells.
#include "common.cuh"

namespace {

using poreover::lse;
using poreover::lse_flat;

constexpr int kMaxA = 8;  // alphabet size the kernel takes (A+1 columns)
constexpr int kThreads = 256;  // the CTA-wide instance
constexpr float kNegInf = -INFINITY;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNB = 4;            // chunks in a workload's ring
constexpr int kNP = 2;            // its producers, a chunk each in turn
constexpr int kWarps = 1 + kNP;   // a workload's warps
constexpr int kMaxR = 32;         // rows a chunk holds, at most
constexpr int kMaxE = 4;          // cells a consumer lane holds, at most
constexpr int kMaxWarpW = 32 * kMaxE;

#ifdef POREOVER_PHASE_CLOCKS
// per row: the CTA-wide instance's row loads and the alphabet's
// log-sum-exp, gap cumsum, scan up and down sweeps, final pass, G writes
// and CTA barrier waits; the warp instance's consumer (wait for a chunk,
// the row below and the chunk's inputs, up sweep, down sweep, final
// log-add-exp and hand-over of the row) and producer (wait for a free
// chunk, G flush, read 2's staging, the alphabet's log-sum-exp, gap
// cumsum, the row's scalars and hand-over) (ops/gamma.py: CLOCK_PARTS)
enum { CK_W_LOAD, CK_W_CUMSUM, CK_W_UP, CK_W_DOWN, CK_W_FINAL, CK_W_GW,
       CK_W_BAR, CK_C_WAIT, CK_C_LOAD, CK_C_UP, CK_C_DOWN, CK_C_FINAL,
       CK_P_WAIT, CK_P_FLUSH, CK_P_STAGE, CK_P_INNER, CK_P_CUMSUM,
       CK_P_HAND, CK_W_ROWS, CK_C_ROWS, CK_P_ROWS, CK_SINK, CK_N };
__device__ unsigned long long g_phase_clocks[CK_N];
#define CLK_PARAM , long long &clk_t_, unsigned long long (&clk_acc_)[CK_N]
#define CLK_ARG , clk_t_, clk_acc_
#else
#define CLK_PARAM
#define CLK_ARG
#endif
// a CTA barrier, its wait clocked apart from the phase p before it
#define SYNC_CLK(p)  \
  do {               \
    CLK(p);          \
    __syncthreads(); \
    CLK(CK_W_BAR);   \
  } while (0)

// meta columns (ops/gamma.py: M_*)
enum { M_O1, M_U, M_O2, M_V, M_EOFF, M_W, M_G, M_S2, META_COLS };

__device__ __forceinline__ long long clamp_start(long long start,
                                                 long long size,
                                                 long long length) {
  start = start < 0 ? 0 : start;
  return start < length - size ? start : length - size;
}

// ---- PTX: mbarriers, the bulk copy and the proxy fence
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "W: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra W;\n"
      "}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned), completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// orders this thread's earlier shared-memory accesses before the bulk
// copies it issues next
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// ---- end of PTX

// XLA's inclusive cumsum of x[0..n) in place (beam2d._cumsum_xla): blocks
// of 16 summed in order, the blocks' totals scanned the same way
// (recursively, in `scratch`), each block's exclusive prefix added last.
// By the CTA, or (kWarp) by the calling warp alone.
template <bool kWarp>
__device__ void cumsum_xla(float* x, int n, float* scratch CLK_PARAM) {
  const int tid = kWarp ? threadIdx.x % 32 : threadIdx.x;
  const int nt = kWarp ? 32 : blockDim.x;
  if constexpr (kWarp)
    if (n <= 16) {  // one block: a lane sums it in registers
      if (tid == 0 && n > 0) {  // x holds at least 16 floats
        float r[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) r[i] = x[i];
        float acc = r[0];
#pragma unroll
        for (int i = 1; i < 16; ++i)
          if (i < n) {
            acc = __fadd_rn(r[i], acc);
            x[i] = acc;
          }
      }
      __syncwarp();
      return;
    }
#define CUMSUM_SYNC()                \
  do {                               \
    if constexpr (kWarp) __syncwarp(); \
    else SYNC_CLK(CK_W_CUMSUM);      \
  } while (0)
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
    for (int blk = tid; blk < nb; blk += nt) {
      const int lo = blk * 16, cnt = min(m - lo, 16);
      float r[16];  // the block in registers, summed in order
#pragma unroll
      for (int i = 0; i < 16; ++i) r[i] = i < cnt ? v[lo + i] : 0.0f;
      float acc = r[0];
#pragma unroll
      for (int i = 1; i < 16; ++i)
        if (i < cnt) {
          acc = __fadd_rn(r[i], acc);
          v[lo + i] = acc;
        }
    }
    CUMSUM_SYNC();
    if (nb <= 1) break;
    float* t = sp;
    sp += nb - 1;
    for (int k = tid; k < nb - 1; k += nt) t[k] = v[k * 16 + 15];
    CUMSUM_SYNC();
    ++depth;
    lv[depth] = t;
    ln[depth] = nb - 1;
  }
  for (int d = depth - 1; d >= 0; --d) {
    float* v = lv[d];
    const float* t = lv[d + 1];
    for (int i = 16 + tid; i < ln[d]; i += nt)
      v[i] = __fadd_rn(v[i], t[i / 16 - 1]);
    CUMSUM_SYNC();
  }
#undef CUMSUM_SYNC
}

// log-sum-exp over the alphabet of y1[u, a] + y2[vv, a] (y2 reads -inf
// outside the read), in order from character 0; NA characters, or (NA =
// kMaxA) the first A of kMaxA. Unrolled, so that x stays in registers. A
// NaN term makes the maximum NaN, as torch.max's, and so the result.
template <int NA>
__device__ __forceinline__ float inner_lse_n(const float* y1u,
                                             const float* y2v, bool ok2,
                                             int A) {
  float x[NA];
  float mx = kNegInf;
  bool any_nan = false;
#pragma unroll
  for (int a = 0; a < NA; ++a)
    if (NA < kMaxA || a < A) {
      x[a] = __fadd_rn(y1u[a], ok2 ? y2v[a] : kNegInf);
      mx = fmaxf(mx, x[a]);
      any_nan |= isnan(x[a]);
    }
  if (any_nan) mx = NAN;
  float inner = mx;
  if (isfinite(mx)) {
    float s = expf(__fsub_rn(x[0], mx));
#pragma unroll
    for (int a = 1; a < NA; ++a)
      if (NA < kMaxA || a < A) s = __fadd_rn(s, expf(__fsub_rn(x[a], mx)));
    inner = __fadd_rn(logf(s), mx);
  }
  return inner;
}

__device__ __forceinline__ float inner_lse(const float* y1u,
                                           const float* y2v, bool ok2,
                                           int A) {
  return A == 4 ? inner_lse_n<4>(y1u, y2v, ok2, A)  // ACGT
                : inner_lse_n<kMaxA>(y1u, y2v, ok2, A);
}

// ======================= the CTA-wide instance ==========================

// Inclusive log-add-exp scan of x[0..n) in place, in the odd/even tree of
// jax.lax.associative_scan (beam2d._lse_scan_): level l's elements are
// x[(i+1) 2^l - 1]; up the tree odd elements take lse(even, odd), down
// it even elements (but the first) take lse(odd before, even).
__device__ void lse_scan(float* x, int n CLK_PARAM) {
  int lens[32];
  int L = 0, len = n, s = 1;
  while (len > 1) {
    const int half = len / 2;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int r = (2 * i + 2) * s - 1;
      x[r] = lse(x[r - s], x[r]);
    }
    SYNC_CLK(CK_W_UP);
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
    SYNC_CLK(CK_W_DOWN);
  }
}

// floats of a CTA-wide workload's rows: five rows of W_max and the
// cumsum's block totals (W/16 + W/256 + ... < W/15 + 4)
__host__ __device__ inline long long wide_floats(int W_max) {
  return 5LL * W_max + W_max / 15 + 8;
}

// The rows live in dynamic shared memory, or, when `scratch` is not null
// (bands too wide for a CTA's shared memory), in the CTA's wide_floats
// of global scratch; the same code reads them either way.
__global__ void __launch_bounds__(kThreads)
    pair_gamma_wide_kernel(const float* __restrict__ y,
                           const int* __restrict__ env,
                           const float* __restrict__ S1,
                           const float* __restrict__ S2,
                           const long long* __restrict__ meta, int A,
                           int W_max, float* __restrict__ G,
                           float* __restrict__ g00, float* scratch) {
  extern __shared__ float smem[];
  const long long* m = meta + (long long)blockIdx.x * META_COLS;
  const long long U = m[M_U], o2 = m[M_O2], V = m[M_V];
  const long long eoff = m[M_EOFF], W = m[M_W];
  const int C = A + 1;
  const long long p = W + 2;  // the JAX row pads
  // the row below (u+1)
  float* gn = scratch ? scratch + blockIdx.x * wide_floats(W_max) : smem;
  float* gup = gn + W_max;    // gamma(u+1, v)
  float* cc = gup + W_max;    // C = gamma(u+1, v+1) + inner
  float* rb = cc + W_max;     // C + cG2, flipped, then scanned
  float* cs = rb + W_max;     // gap prefix sums
  float* lv = cs + W_max;     // their blocks' totals
  const float* y1 = y + m[M_O1] * C;
  const float* y2 = y + o2 * C;
  const float* S2w = S2 + m[M_S2];
  float* Gw = G + m[M_G];
  const int* ew = env + 2 * eoff;
  CLK_INIT();

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
  SYNC_CLK(CK_W_LOAD);

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
      CLK(CK_W_GW);
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
      const float inner = inner_lse(y1u, y2 + vv * C, ok2, A);
      cc[w] = in_range ? __fadd_rn(gd, inner) : kNegInf;
      cs[w] = (in_range && ok2) ? y2[vv * C + A] : 0.0f;
    }
    SYNC_CLK(CK_W_LOAD);
    cumsum_xla<false>(cs, (int)W, lv CLK_ARG);
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const float cg = w ? cs[w - 1] : 0.0f;
      rb[W - 1 - w] = __fadd_rn(cc[w], cg);
    }
    SYNC_CLK(CK_W_LOAD);
    lse_scan(rb, (int)W CLK_ARG);
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
    SYNC_CLK(CK_W_FINAL);
    off_next = off;
  }
  CLK_ADD(CK_W_ROWS, U);
  CLK_FLUSH(threadIdx.x == 0);
  if (threadIdx.x == 0) {  // gn holds row 0
    const long long off0 = ew[0];
    g00[blockIdx.x] = (off0 <= 0 && 0 < off0 + W) ? gn[-off0] : kNegInf;
  }
}

// =========================== the warp instance ===========================

// What the producer hands over per row (k: the flipped row's cell, W-1-w)
struct RowInfo {
  int sd, su;      // gamma(u+1, v+1) / gamma(u+1, v) sit at k - sd / k - su
  int a;           // the first cell in range, W - width (cells k >= a)
  int kb;          // the boundary cell (v == V <= end), or -1
  float gap1, s1;  // y1[u, gap], S1[u]
  unsigned up, down;  // scan levels with work (bit l: nodes 2^l apart)
};

// One workload's shared memory (offsets in bytes from its base), for bands
// of up to W cells, chunks of R rows and E cells a consumer lane
struct Layout {
  int bars, info, ic, cg, tile, gk, stage, gsc, gsc_bytes, pre, total;
  int S;           // a chunk row's stride (floats)
  int span;        // read-2 frames a chunk's staging holds
  int stage_flt;   // floats of a staging buffer
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(int W, int R, int E, int C) {
  Layout L;
  L.S = (W + 3) & ~3;
  L.span = 2 * R + W;
  L.stage_flt = (L.span * C + 8 + 3) & ~3;
  int o = 0;
  L.bars = o;  // full[kNB], empty[kNB], staged[kNP][2]
  o = align16(o + 8 * (2 * kNB + 2 * kNP));
  L.info = o;
  o = align16(o + (int)sizeof(RowInfo) * kNB * R);
  L.ic = o;  // C's addend: the alphabet's log-sum-exp, -inf out of range
  o += 4 * kNB * R * L.S;
  L.cg = o;  // the gap's exclusive prefix sums
  o += 4 * kNB * R * L.S;
  L.tile = o;  // G rows of the chunk: [W-1][R+1]
  o = align16(o + 4 * kNB * (W > 1 ? W - 1 : 0) * (R + 1));
  L.gk = o;  // the row below, then the row: [2][E][32]
  o += 4 * 2 * 32 * E;
  L.stage = o;  // read 2's frames of a chunk, two buffers a producer
  o += 4 * 2 * kNP * L.stage_flt;
  L.gsc = o;  // each producer's gap sums and their blocks' totals
  L.gsc_bytes = align16(4 * (max(W, 16) + W / 15 + 8));
  o += kNP * L.gsc_bytes;
  L.pre = o;  // each producer's next row's inputs: [2][16] words
  o += kNP * 4 * 2 * 16;
  L.total = o;
  return L;
}

// cell k of a row exchanged through shared memory as [k % E][k / E]: lanes
// read cells a fixed distance apart without bank conflicts
template <int E>
__device__ __forceinline__ int xk(int k) {
  return (k % E) * 32 + k / E;
}

// E consecutive floats from shared memory (16-byte aligned for E >= 4),
// in the widest loads that take them
template <int E>
__device__ __forceinline__ void load_cells(const float* src, float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 q = *(const float4*)(src + e);
      v[e] = q.x, v[e + 1] = q.y, v[e + 2] = q.z, v[e + 3] = q.w;
    }
  } else if constexpr (E == 2) {
    const float2 q = *(const float2*)src;
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = src[0];
  }
}

// The reverse scan of the consumer's row, each lane's E cells x[] in
// registers: the tree's levels below E within the lane, the others by
// shuffles of the lanes' last cells; `up` / `down` say which levels have
// work.
template <int E>
__device__ __forceinline__ void warp_scan(float (&x)[E], unsigned up,
                                          unsigned down, int lane
                                              CLK_PARAM) {
  static_assert(E == 1 || E == 2 || E == 4, "E: 1, 2 or 4 cells a lane");
  constexpr int LE = E == 1 ? 0 : E == 2 ? 1 : 2;
#pragma unroll
  for (int l = 0; l < LE; ++l)
    if (up >> l & 1) {
      const int s = 1 << l;
#pragma unroll
      for (int i = 2 * s - 1; i < E; i += 2 * s) x[i] = lse_flat(x[i - s], x[i]);
    }
#pragma unroll
  for (int l = LE; l < LE + 5; ++l)
    if (up >> l & 1) {
      const int q = 1 << (l - LE);  // lanes between a node and its left
      const float v = __shfl_up_sync(kFull, x[E - 1], q);
      const float r = lse_flat(v, x[E - 1]);  // every lane, then a select
      if (((lane + 1) & (2 * q - 1)) == 0) x[E - 1] = r;
    }
  CLK_DEP(x[E - 1]);
  CLK(CK_C_UP);
#pragma unroll
  for (int l = LE + 4; l >= LE; --l)
    if (down >> l & 1) {
      const int q = 1 << (l - LE);
      const float v = __shfl_up_sync(kFull, x[E - 1], q);
      const float r = lse_flat(v, x[E - 1]);
      if (((lane + 1) & (2 * q - 1)) == q && lane + 1 >= 3 * q) x[E - 1] = r;
    }
  if constexpr (E > 1) {
    // the levels below E: node s - 1 of a lane takes the lane before's
    // last cell, final once the levels above are done
    const float prev = __shfl_up_sync(kFull, x[E - 1], 1);
#pragma unroll
    for (int l = LE - 1; l >= 0; --l)
      if (down >> l & 1) {
        const int s = 1 << l;
        const float r = lse_flat(prev, x[s - 1]);
        if (lane >= 1) x[s - 1] = r;
#pragma unroll
        for (int i = 3 * s - 1; i < E; i += 2 * s)
          x[i] = lse_flat(x[i - s], x[i]);
      }
  }
  CLK_DEP(x[0]);
  CLK(CK_C_DOWN);
}

// The reverse scan of a row whose cells lie in the flipped row's last 32,
// cell k at lane k - (W - 32): every level by shuffles; a node whose left
// side lies before the window has it all -inf and is skipped.
__device__ __forceinline__ float window_scan(float x, int k, unsigned up,
                                             unsigned down,
                                             int lane CLK_PARAM) {
  const int kk = k + 64;  // k's residues mod 2^6; k < 0 before a band of 32
#pragma unroll
  for (int l = 0; l < 5; ++l)
    if (up >> l & 1) {
      const int s = 1 << l;
      const float v = __shfl_up_sync(kFull, x, s);
      const float r = lse_flat(v, x);  // every lane, then a select
      if (lane >= s && ((kk + 1) & (2 * s - 1)) == 0) x = r;
    }
  CLK_DEP(x);
  CLK(CK_C_UP);
#pragma unroll
  for (int l = 4; l >= 0; --l)
    if (down >> l & 1) {
      const int s = 1 << l;
      const float v = __shfl_up_sync(kFull, x, s);
      const float r = lse_flat(v, x);
      if (lane >= s && ((kk + 1) & (2 * s - 1)) == s && k + 1 >= 3 * s) x = r;
    }
  CLK_DEP(x);
  CLK(CK_C_DOWN);
  return x;
}

struct Work {  // one workload's constants
  long long U, V, W, o1, o2, eoff, g, s2;
};

__device__ __forceinline__ Work work_of(const long long* meta, int b) {
  const long long* m = meta + (long long)b * META_COLS;
  return Work{m[M_U], m[M_V], m[M_W], m[M_O1], m[M_O2], m[M_EOFF], m[M_G],
              m[M_S2]};
}

// Producer warp q of workload `wk` (see the top of the file): chunks q,
// q + kNP, ... of the ring.
__device__ void gamma_producer(const Work& wk, int q,
                               const float* __restrict__ y,
                               const int* __restrict__ env,
                               const float* __restrict__ S1, int A, int R,
                               const Layout& L, unsigned char* base,
                               float* __restrict__ G) {
  const int lane = threadIdx.x % 32;
  const int C = A + 1;
  const long long U = wk.U, V = wk.V, W = wk.W, p = W + 2;
  unsigned long long* full = (unsigned long long*)(base + L.bars);
  unsigned long long* empty = full + kNB;
  unsigned long long* staged = empty + kNB + 2 * q;
  RowInfo* info = (RowInfo*)(base + L.info);
  float* ic = (float*)(base + L.ic);
  float* cg = (float*)(base + L.cg);
  float* tile = (float*)(base + L.tile);
  float* stage = (float*)(base + L.stage) + 2 * q * L.stage_flt;
  float* gsc = (float*)(base + L.gsc + q * L.gsc_bytes);
  float* gtot = gsc + W;  // the cumsum's blocks' totals
  unsigned* pre = (unsigned*)(base + L.pre) + 2 * 16 * q;
  const float* y1 = y + wk.o1 * C;
  const float* y2 = y + wk.o2 * C;
  const int* ew = env + 2 * wk.eoff;
  float* Gw = G + wk.g;
  const long long NC = (U + R - 1) / R;
  CLK_INIT();

  // read 2's frames [f0, f1) the rows of chunk c read (empty: f0 >= f1)
  auto span_of = [&](long long c, long long& f0, long long& f1) {
    long long lo = V, hi = 0;
    for (long long i = lane; i < R; i += 32) {
      const long long u = U - 1 - (c * R + i);
      if (u < 0) break;
      const long long off = ew[2 * u];
      const long long width = min(ew[2 * u + 1] - off, W);
      if (width <= 0) continue;
      const long long sy = clamp_start(off + p, W, V + 2 * p) - p;
      lo = min(lo, max(sy, 0LL));
      hi = max(hi, min(sy + width, V));
    }
    f0 = (long long)__reduce_min_sync(kFull, (unsigned)lo);
    f1 = (long long)__reduce_max_sync(kFull, (unsigned)hi);
  };
  // stage chunk c's frames into this producer's buffer t % 2 (t: its t-th
  // chunk; an empty arrival when they do not fit, read from global memory
  // then); returns the pointer the chunk reads frame f at, column a:
  // ys[f * C + a]
  auto stage_chunk = [&](long long c, long long t) -> const float* {
    long long f0, f1;
    span_of(c, f0, f1);
    float* buf = stage + (t & 1) * L.stage_flt;
    const float* src = y2 + f0 * C;
    const unsigned lead = (unsigned)((size_t)src & 15);
    const long long nbytes = f1 > f0 ? ((long long)lead + (f1 - f0) * C * 4
                                        + 15) & ~15LL : 0;
    const bool fits = nbytes > 0 && nbytes <= (long long)L.stage_flt * 4;
    if (lane == 0) {
      fence_proxy_async();
      mbar_arrive_tx(&staged[t & 1], fits ? (unsigned)nbytes : 0u);
      if (fits)
        bulk_copy(buf, (const char*)src - lead, (unsigned)nbytes,
                  &staged[t & 1]);
    }
    return fits ? buf + lead / 4 - f0 * C : y2;
  };

  // chunk c's G rows from the tile of buffer b, along u: a lane a row, the
  // cells in range from the tile, -inf past the row's width
  auto flush = [&](long long c, int b) {
    const long long c0 = c * R;
    const int nr = (int)min((long long)R, U - c0);
    const long long u = U - c0 - nr + lane;
    const long long width =
        lane < nr ? min((long long)(ew[2 * u + 1] - ew[2 * u]), W - 1) : 0;
    const float* t = tile + b * (W - 1) * (R + 1) + nr - 1 - lane;
    if (lane < nr)
      for (long long w = 0; w < W - 1; ++w)
        Gw[w * U + u] = w < width ? t[w * (R + 1)] : kNegInf;
  };

  // the next row's start, end, the start of the row below it, S1 and y1
  // row, loaded a row ahead into pre[j % 2] (lane i the i-th word): off
  // the chain
  auto fetch = [&](long long u) -> unsigned {
    if (u < 0 || lane >= 4 + C) return 0u;
    if (lane < 3) return (unsigned)ew[2 * u + lane];
    if (lane == 3) return __float_as_uint(S1[wk.eoff + u]);
    return __float_as_uint(y1[u * C + lane - 4]);
  };
  {
    const unsigned v = fetch(U - 1 - q * R);
    if (lane < 16) pre[lane] = v;
    __syncwarp();
  }
  long long j = 0;  // rows done

  const float* ys_next = q < NC ? stage_chunk(q, 0) : y2;
  for (long long c = q, t = 0; c < NC; c += kNP, ++t) {
    const int b = (int)(c % kNB);
    const float* ys = ys_next;
    if (c + kNP < NC) ys_next = stage_chunk(c + kNP, t + 1);
    CLK(CK_P_STAGE);
    mbar_wait(&empty[b], (unsigned)((c / kNB) & 1) ^ 1u);
    CLK(CK_P_WAIT);
    if (c >= kNB) {  // chunk c - kNB, this producer's (kNP divides kNB)
      flush(c - kNB, b);
      CLK(CK_P_FLUSH);
    }
    mbar_wait(&staged[t & 1], (unsigned)((t >> 1) & 1));
    CLK(CK_P_STAGE);
    const int nr = (int)min((long long)R, U - c * R);
    for (int i = 0; i < nr; ++i) {
      const long long u = U - 1 - (c * R + i);
      const unsigned nv =
          fetch(i + 1 < nr ? u - 1 : U - 1 - (c + kNP) * R);
      const unsigned* cur = pre + (j & 1) * 16;
      const long long off = (int)cur[0], end = (int)cur[1];
      const long long off_next = (int)cur[2];
      const long long width = end - off;
      const int wr = (int)max(0LL, min(width, W));  // cells in range
      const long long sy = clamp_start(off + p, W, V + 2 * p) - p;
      const float* y1u = (const float*)(cur + 4);
      float* icr = ic + (b * R + i) * L.S;
      float* cgr = cg + (b * R + i) * L.S;
      for (int w = lane; w < W; w += 32) {
        float v = kNegInf;
        if (w < wr) {
          const long long vv = sy + w;
          const bool ok2 = vv >= 0 && vv < V;
          v = inner_lse(y1u, ys + vv * C, ok2, A);
          gsc[w] = ok2 ? ys[vv * C + A] : 0.0f;
        } else {
          cgr[W - 1 - w] = 0.0f;  // C + cG2 is -inf out of range
        }
        icr[W - 1 - w] = v;
      }
      __syncwarp();
      CLK(CK_P_INNER);
      cumsum_xla<true>(gsc, wr, gtot CLK_ARG);
      for (int w = lane; w < wr; w += 32)
        cgr[W - 1 - w] = w ? gsc[w - 1] : 0.0f;
      CLK(CK_P_CUMSUM);
      // level l (lane l) has work if its last node below W has a cell in
      // range on its left side (nodes r, left r - s: up r + 1 = 2s m, down
      // r + 1 = s + 2s m, m >= 1)
      const int Wi = (int)W, a = (int)(W - wr);
      const int l = lane, s1 = 1 << (lane & 15);
      const bool lv = lane < 16 && (2 << lane) <= Wi;
      const int m = (Wi - s1) >> (l + 1);
      const unsigned up = __ballot_sync(
          kFull, lv && ((Wi >> (l + 1)) << (l + 1)) - 1 - s1 >= a);
      const unsigned down =
          __ballot_sync(kFull, lv && m >= 1 && (m << (l + 1)) - 1 >= a);
      if (lane == 0) {
        const long long shift = off - off_next;
        const long long lim = 2 * W + 4;
        const long long su = min(max(shift + p, 0LL), lim) - p;
        const long long sd = min(max(shift + 1 + p, 0LL), lim) - p;
        RowInfo ri;
        ri.sd = (int)sd;
        ri.su = (int)su;
        ri.a = a;
        const long long wb = V - off;  // v == V
        ri.kb = (V <= end && wb >= 0 && wb < W) ? (int)(W - 1 - wb) : -1;
        ri.gap1 = y1u[A];
        ri.s1 = __uint_as_float(cur[3]);
        ri.up = up;
        ri.down = down;
        info[b * R + i] = ri;
      }
      if (lane < 16) pre[((j + 1) & 1) * 16 + lane] = nv;
      __syncwarp();  // gsc and pre are the next row's
      ++j;
      CLK(CK_P_HAND);
    }
    if (lane == 0) mbar_arrive(&full[b]);
  }
  // this producer's chunks among the last kNB: their G rows
  for (long long c = q; c < NC; c += kNP) {
    if (c < NC - kNB) continue;
    const int b = (int)(c % kNB);
    mbar_wait(&empty[b], (unsigned)((c / kNB) & 1));
    CLK(CK_P_WAIT);
    flush(c, b);
    CLK(CK_P_FLUSH);
  }
  CLK_ADD(CK_P_ROWS, q == 0 ? U : 0);
  CLK_FLUSH(lane == 0);
}

// The consumer warp of workload `wk` (see the top of the file); its
// gamma(0,0) goes to *g00.
template <int E>
__device__ void gamma_consumer(const Work& wk, const int* __restrict__ env,
                               const float* __restrict__ S2, int R,
                               const Layout& L, unsigned char* base,
                               float* __restrict__ g00) {
  const int lane = threadIdx.x % 32;
  const long long U = wk.U, V = wk.V, p = wk.W + 2;
  const int W = (int)wk.W;
  unsigned long long* full = (unsigned long long*)(base + L.bars);
  unsigned long long* empty = full + kNB;
  const RowInfo* info = (const RowInfo*)(base + L.info);
  const float* ic = (const float*)(base + L.ic);
  const float* cg = (const float*)(base + L.cg);
  float* tile = (float*)(base + L.tile);
  float* gk = (float*)(base + L.gk);
  const int* ew = env + 2 * wk.eoff;
  const float* S2w = S2 + wk.s2;
  CLK_INIT();

  // ---- boundary row U: S2 on [start, end] and v < V, 0 at V
  {
    const long long offU = ew[2 * U], endU = ew[2 * U + 1];
    const long long st = clamp_start(offU + p, W, V + 1 + 2 * p);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = lane * E + e;
      float r = kNegInf;
      if (k < W) {
        const long long w = W - 1 - k;
        const long long si = st + w - p;
        r = (si >= 0 && si <= V) ? S2w[si] : kNegInf;
        const long long v = offU + w;
        if (!(v <= endU && v < V)) r = kNegInf;
        if (v == V && V <= endU) r = 0.0f;
      }
      gk[xk<E>(k)] = r;
    }
    __syncwarp();
  }

  int par = 0;  // gk[par]: the row below
  bool prev_window = false;  // the row below held only its last 32 cells
  const long long NC = (U + R - 1) / R;
  for (long long c = 0; c < NC; ++c) {
    const int b = (int)(c % kNB);
    mbar_wait(&full[b], (unsigned)((c / kNB) & 1));
    CLK(CK_C_WAIT);
    float* t = tile + b * (W - 1) * (R + 1);
    RowInfo next = info[b * R];  // a row ahead, off the chain
    for (int i = 0; i < R; ++i) {
      if (c * R + i >= U) break;
      const RowInfo ri = next;
      if (i + 1 < R) next = info[b * R + i + 1];
      const float* icr = ic + (b * R + i) * L.S;
      const float* cgr = cg + (b * R + i) * L.S;
      const float* below = gk + par * 32 * E;
      float* row = gk + (par ^ 1) * 32 * E;
      // the row below's cells held (the others are -inf)
      const int lo = prev_window ? max(W - 32, 0) : 0;
      // G[u, w] = gamma(u+1, off+w+1) = the diagonal cell, in range (the
      // producer's flush writes the rest)
      auto tile_at = [&](int k) -> float& {
        return t[(W - 1 - k) * (R + 1) + i];
      };
      prev_window = ri.a >= W - 31;
      if (prev_window) {
        // the row's cells, and its boundary cell, lie in the last 32: a
        // cell a lane
        const int k = W - 32 + lane;
        const int kd = k - ri.sd, ku = k - ri.su;
        const float gd = (kd >= lo && kd < W) ? below[xk<E>(kd)] : kNegInf;
        const float gu = (ku >= lo && ku < W) ? below[xk<E>(ku)] : kNegInf;
        const bool in = k >= ri.a;  // and k < W
        const float icv = k >= 0 ? icr[k] : kNegInf;
        const float cgv = k >= 0 ? cgr[k] : 0.0f;
        float x = __fadd_rn(__fadd_rn(gd, icv), cgv);
        if (in && k >= 1) tile_at(k) = gd;
        CLK_DEP(x);
        CLK(CK_C_LOAD);
        x = window_scan(x, k, ri.up, ri.down, lane CLK_ARG);
        float r = lse_flat(__fadd_rn(gu, ri.gap1), __fsub_rn(x, cgv));
        r = in ? r : kNegInf;
        if (k == ri.kb) r = ri.s1;
        if (k >= 0) row[xk<E>(k)] = r;
      } else {
        float x[E], gu[E], cgv[E], icv[E];
        load_cells<E>(icr + lane * E, icv);
        load_cells<E>(cgr + lane * E, cgv);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int k = lane * E + e;
          const int kd = k - ri.sd, ku = k - ri.su;
          const float gd =
              (kd >= lo && kd < W) ? below[xk<E>(kd)] : kNegInf;
          gu[e] = (ku >= lo && ku < W) ? below[xk<E>(ku)] : kNegInf;
          if (k >= W) icv[e] = kNegInf, cgv[e] = 0.0f;
          x[e] = __fadd_rn(__fadd_rn(gd, icv[e]), cgv[e]);
          if (k >= ri.a && k >= 1 && k < W) tile_at(k) = gd;
        }
        CLK_DEP(x[E - 1]);
        CLK(CK_C_LOAD);
        warp_scan<E>(x, ri.up, ri.down, lane CLK_ARG);
#pragma unroll
        for (int e = 0; e < E; ++e) {  // all lanes' cells, then a select:
          // the calls interleave
          const int k = lane * E + e;
          float r = lse_flat(__fadd_rn(gu[e], ri.gap1),
                             __fsub_rn(x[e], cgv[e]));
          r = (k >= ri.a && k < W) ? r : kNegInf;
          if (k == ri.kb) r = ri.s1;
          row[xk<E>(k)] = r;
        }
      }
      __syncwarp();
      par ^= 1;
      CLK(CK_C_FINAL);
    }
    if (lane == 0) mbar_arrive(&empty[b]);
  }
  CLK_ADD(CK_C_ROWS, U);
  CLK_FLUSH(lane == 0);
  if (lane == 0) {  // gk[par] holds row 0
    const long long off0 = ew[0];
    *g00 = (off0 <= 0 && 0 < off0 + W)
               ? gk[par * 32 * E + xk<E>((int)(W - 1 + off0))]
               : kNegInf;
  }
}

// A CTA per workload: warp 0 its consumer, warps 1..kNP its producers.
template <int E>
__global__ void __launch_bounds__(kWarps * 32, 1)
    pair_gamma_warp_kernel(const float* __restrict__ y,
                           const int* __restrict__ env,
                           const float* __restrict__ S1,
                           const float* __restrict__ S2,
                           const long long* __restrict__ meta, int A,
                           int W_max, int R, float* __restrict__ G,
                           float* __restrict__ g00) {
  extern __shared__ __align__(16) unsigned char base[];
  const Layout L = layout(W_max, R, E, A + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x;
  if (warp == 0 && lane == 0) {
    unsigned long long* bars = (unsigned long long*)(base + L.bars);
    for (int i = 0; i < kNB; ++i) {
      mbar_init(&bars[i], 1);        // full: the chunk's producer
      mbar_init(&bars[kNB + i], 1);  // empty: the consumer
    }
    for (int i = 0; i < 2 * kNP; ++i)  // staged: a producer's expect_tx
      mbar_init(&bars[2 * kNB + i], 1);
    fence_mbar_init();
  }
  __syncthreads();
  const Work wk = work_of(meta, b);
  if (warp == 0)
    gamma_consumer<E>(wk, env, S2, R, L, base, g00 + b);
  else
    gamma_producer(wk, warp - 1, y, env, S1, A, R, L, base, G);
}

template <int E>
int launch_warp(const float* y, const int* env, const float* S1,
                const float* S2, const long long* meta, int B, int A,
                int W_max, float* G, float* g00, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // chunks of up to kMaxR rows, fewer when they would not fit (the widest
  // bands of the widest alphabet)
  int R = kMaxR;
  while (R > 1 && layout(W_max, R, E, A + 1).total > max_smem) R /= 2;
  const int smem = layout(W_max, R, E, A + 1).total;
  if (smem > max_smem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(pair_gamma_warp_kernel<E>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  pair_gamma_warp_kernel<E><<<B, kWarps * 32, smem, stream>>>(
      y, env, S1, S2, meta, A, W_max, R, G, g00);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef POREOVER_PHASE_CLOCKS
extern "C" int phase_clocks_read(unsigned long long* out, int n, int reset) {
  return poreover::phase_clocks_copy(g_phase_clocks, out, n, reset);
}
#endif

// Launches the DP of B packed workloads (ops/gamma.py: prepare_gamma) on
// `stream`; returns a cudaError_t. `instance` (ops/gamma.py: instance_for):
// 1 the warp instance (bands of up to kMaxWarpW cells), 2 the CTA-wide one,
// whose rows go to `scratch` (B * pair_gamma_wide_floats(W_max) floats of
// global memory) when it is not null, else to shared memory.
extern "C" int pair_gamma_launch(const float* y, const int* env,
                                 const float* S1, const float* S2,
                                 const long long* meta, int B, int A,
                                 int W_max, float* G, float* g00,
                                 int instance, float* scratch,
                                 cudaStream_t stream) {
  if (B <= 0) return 0;
  if (A < 1 || A > kMaxA || W_max < 1 || instance < 1 || instance > 2 ||
      (instance == 1 && W_max > kMaxWarpW))
    return (int)cudaErrorInvalidValue;
  if (instance == 1) {
    const int E = (W_max + 31) / 32;
    if (E <= 1)
      return launch_warp<1>(y, env, S1, S2, meta, B, A, W_max, G, g00,
                            stream);
    if (E <= 2)
      return launch_warp<2>(y, env, S1, S2, meta, B, A, W_max, G, g00,
                            stream);
    return launch_warp<4>(y, env, S1, S2, meta, B, A, W_max, G, g00, stream);
  }
  const size_t smem = scratch ? 0 : sizeof(float) * wide_floats(W_max);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pair_gamma_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pair_gamma_wide_kernel<<<B, kThreads, smem, stream>>>(
      y, env, S1, S2, meta, A, W_max, G, g00, scratch);
  return (int)cudaGetLastError();
}

// Floats of a CTA-wide workload's rows at bands of W_max cells (its scratch
// in global memory, or its dynamic shared memory).
extern "C" long long pair_gamma_wide_floats(int W_max) {
  return wide_floats(W_max);
}

// The most dynamic shared memory a CTA may take on the current device
// (bytes), or -1.
extern "C" int pair_gamma_smem_optin() {
  int dev = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return max_smem;
}
