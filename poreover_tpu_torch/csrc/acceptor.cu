// Banded Viterbi acceptor with traceback over a batch of reads, CUDA for
// sm_90a.
//
// The port's own kernel: the JAX package computes this DP as a lax.scan
// over label rows (poreover_tpu/ops/acceptor.py:_acceptor_scan, :60) and
// its traceback as a reversed scan over time (_traceback, :140), not in
// Pallas. It is stage 1 of `pair-decode --single beam`: the path of the 1D
// beam's string through each read, from which the signal-to-sequence map
// is taken. It computes what the plain PyTorch version
// ops/acceptor.py:acceptor_plain computes, with the same float32 adds,
// subtractions and maxima in the same order, so the pointers and paths
// are equal.
//
// Per label row l = 1..L of a read (window of W <= 2048 steps from off):
//   emit(t) = y[c, t] + v_prev(t - 1)          on the writable steps
//   v(t)    = G(t) + max(seed - G(off - 1), max_{t' <= t} emit(t') - G(t'))
//   ptr(t)  = writable(t) && emit(t) >= v(t - 1) + y[gap, t]
// where G is the gap column's prefix sum (an input) and the seed is y[c, 0]
// for row 1 when off == 1, else -inf.
//
// Design. One CTA of 1024 threads per read; thread i owns window cells 2i
// and 2i + 1. A row is: the cells' emissions against the previous row
// (double-buffered in shared memory, indexed by step - (off - 1), so the
// shift from one row's window to the next is an offset), a block-wide
// max-scan (a warp-shuffle scan, then each warp reduces the 32 warp totals
// before it: two barriers per row), the row written to the other buffer,
// and the pointer bytes to global memory as [L, W] int8. The emission
// planes are [S, sum T] (one plane per column), so a window's loads are
// contiguous; each row's loads, and the row table two rows ahead, are
// issued one row early so that their latency hides behind the row before.
// After the last row the block's warp 0 walks the pointers: per row a
// __ballot_sync over 32 steps at a time finds the last emitting step at or
// before the current one, so the walk costs O(L + T / 32) warp steps; the
// path was filled with the gap character beforehand.
//
// What bounds it: the latency of one row (the loads that were not hidden,
// the two barriers of 32 warps, two shuffle chains); the bytes (y and G
// read once, the pointers written once) take microseconds.
//
// Interface (plain C, loaded with ctypes; see ops/acceptor.py): y float32
// [S, ystride], G float32 [ystride], rows int32 [sum L, 4] = (off, first
// and last writable step, character), meta int64 [B, 8] = (first step, T,
// first row, L, W, first pointer byte, band, 0); out ptr int8 [sum L * W],
// path int8 [ystride].

#include "common.cuh"

namespace {

constexpr int NT = 1024;             // threads per CTA
constexpr int IPT = 2;               // window cells per thread
constexpr int WMAX = NT * IPT;       // widest window
constexpr int NW = NT / 32;          // warps per CTA
constexpr unsigned FULL = 0xffffffffu;

// One row's inputs for this thread's cells, loaded ahead of the row.
struct Cells {
  float yc[IPT], g[IPT], yg[IPT];
};

__device__ __forceinline__ void load_cells(Cells& x, const int4 r, int tid,
                                           const float* yr, long long ys,
                                           const float* gb, const float* gp) {
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int t = r.x + IPT * tid + k;
    if (t >= r.y && t <= r.z) {
      x.yc[k] = yr[(long long)r.w * ys + t];
      x.g[k] = gb[t];
      x.yg[k] = gp[t];
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
acceptor_kernel(const float* __restrict__ y, long long ys, int S,
                const float* __restrict__ G, const int4* __restrict__ rows,
                const long long* __restrict__ meta, int gap_char,
                signed char* __restrict__ ptr,
                signed char* __restrict__ path) {
  __shared__ float vbuf[2][WMAX + 1];
  __shared__ float wtot[NW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long* m = meta + 8 * blockIdx.x;
  const long long toff = m[0], loff = m[2], pofs = m[5];
  const int T = (int)m[1], L = (int)m[3], W = (int)m[4], band = (int)m[6];
  const float* yr = y + toff;                          // plane 0 of the read
  const float* gp = y + (long long)(S - 1) * ys + toff;  // the gap plane
  const float* gb = G + toff;
  const int4* rw = rows + loff;

  for (int t = tid; t < T; t += NT) path[toff + t] = (signed char)gap_char;
  if (L > 0) {
    // row 0: G on [0, band], over positions off_1 - 1 .. off_1 + W - 1
    const int base0 = rw[0].x - 1;
    for (int i = tid; i <= W; i += NT) {
      const int p = base0 + i;
      vbuf[0][i] = (p <= band && p < T) ? gb[p] : -INFINITY;
    }
  }
  __syncthreads();

  int base = L > 0 ? rw[0].x - 1 : 0;  // position of the previous row's [0]
  int4 rn = L > 0 ? rw[0] : make_int4(0, 1, 0, 0);  // the next row
  int4 rnn = L > 1 ? rw[1] : make_int4(0, 1, 0, 0);  // the one after
  Cells nx;
  load_cells(nx, rn, tid, yr, ys, gb, gp);
  for (int l = 1; l <= L; ++l) {
    const int4 r = rn;
    const Cells cu = nx;
    rn = rnn;
    if (l + 1 < L) rnn = rw[l + 1];
    if (l < L) load_cells(nx, rn, tid, yr, ys, gb, gp);

    const float* vp = vbuf[(l - 1) & 1];
    float* vc = vbuf[l & 1];
    float emit[IPT], h[IPT];
    bool wr[IPT];
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int t = r.x + IPT * tid + k;
      wr[k] = t >= r.y && t <= r.z;
      emit[k] = -INFINITY;
      h[k] = -INFINITY;
      if (wr[k]) {
        const int i = t - 1 - base;
        const float v = (i >= 0 && i <= W) ? vp[i] : -INFINITY;
        emit[k] = cu.yc[k] + v;
        h[k] = emit[k] - cu.g[k];
      }
    }
    // inclusive max-scan: the thread's cells, the warp, the warps before
    float incl = fmaxf(h[0], h[1]);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl = fmaxf(incl, o);
    }
    if (lane == 31) wtot[warp] = incl;
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = -INFINITY;
    const bool seeded = l == 1 && r.x == 1;
    const float seed = seeded ? yr[(long long)r.w * ys] : -INFINITY;
    const float h0 = seeded ? seed - gb[0] : -INFINITY;
    __syncthreads();
    float pre = lane < warp ? wtot[lane] : -INFINITY;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      pre = fmaxf(pre, __shfl_xor_sync(FULL, pre, d));
    float chain = fmaxf(fmaxf(h0, pre), excl);
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int w = IPT * tid + k;
      chain = fmaxf(chain, h[k]);
      if (w < W) vc[w + 1] = wr[k] ? cu.g[k] + chain : -INFINITY;
    }
    if (tid == 0) vc[0] = seed;
    __syncthreads();
    // pointers: emit >= the stay move from the cell before
    signed char* pr = ptr + pofs + (long long)(l - 1) * W;
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int w = IPT * tid + k;
      if (w < W)
        pr[w] = (signed char)(wr[k] && emit[k] >= vc[w] + cu.yg[k]);
    }
    base = r.x - 1;
  }
  __syncthreads();  // the pointer bytes and the gap fill, for the walk

  if (warp != 0) return;
  int l = L, t = T - 1;
  while (l > 0 && t >= 0) {
    const int4 r = rw[l - 1];
    const signed char* pr = ptr + pofs + (long long)(l - 1) * W;
    int found = -1;
    for (int top = min(t, r.x + W - 1); top >= r.x && found < 0;
         top -= 32) {
      const int tt = top - lane;
      const unsigned hit = __ballot_sync(FULL, tt >= r.x && pr[tt - r.x]);
      if (hit) found = top - (__ffs(hit) - 1);
    }
    if (found < 0) {
      if (l != 1) break;  // no emitting step left: the rest are gaps
      found = 0;          // row 1 emits at step 0 at the latest
    }
    if (lane == 0) path[toff + found] = (signed char)r.w;
    --l;
    t = found - 1;
  }
}

}  // namespace

extern "C" {

// Launches B CTAs of NT threads on `stream`, one per read (W <= WMAX, as
// the wrapper checks). Returns a cudaError_t.
int acceptor_launch(const float* y, long long ys, int S, const float* G,
                    const int* rows, const long long* meta, int B,
                    int gap_char, signed char* ptr, signed char* path,
                    void* stream) {
  if (B <= 0) return 0;
  acceptor_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      y, ys, S, G, reinterpret_cast<const int4*>(rows), meta, gap_char, ptr,
      path);
  return (int)cudaGetLastError();
}

}  // extern "C"
