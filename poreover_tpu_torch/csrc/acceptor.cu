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
// What bounds it: the rows' dependency, per row a max-scan over the window
// (2002 cells at band 1000) between two CTA barriers; the bytes (planes,
// G, the row table, the pointer bits and the path) take microseconds.
// Clocked (thread 0, cycles per label row of a full-size pair, H100), the
// kernel before this design (1024 threads of 2 cells) spent 2940 a row: 816 on loads not
// hidden, 589 on the emissions, 427 on the warp scan, 484 on barrier 1 and
// the warp totals, 230 on the row store and barrier 2, 395 on the pointer
// bytes; and its walk 853 more a row, a dependent global load of byte
// pointers per row. 18.5 ms a pair.
//
// Design. One CTA of NT threads per read, IPT cells each: warp w owns
// cells [32 IPT w, 32 IPT (w + 1)), its lane l the cells 32 IPT w + 32 k +
// l (slot k), so that loads are coalesced, shared accesses free of bank
// conflicts and slot k one 32-bit word (a ballot) of the row's pointer
// bits. A row: the inputs (loaded a row ahead, two buffers alternating),
// the emissions against the row above (two row buffers, padded so that no
// read needs a bounds test), the warp's max-scan over its cells in order
// (transposed through a padded scratch: IPT consecutive cells a lane, one
// warp scan of the lanes' totals), barrier 1, the warps before from their
// totals (broadcast loads), the row stored, barrier 2, the pointer bits.
// After the last row warp 0 walks: the rows' bits and entries copied into
// shared memory RB rows at a time a batch ahead (cp.async), per row the
// last set bit at or before the current step from one word. Clocked: 2338
// cycles a row and 250 of walk (1.19 us a row, 12.8 ms a pair, 1.45x
// faster); no phase dominates, and taking any one out in a scratch build
// saves a share: the SM's instruction throughput with NT / 32 warps, not
// one latency, sets the row. Tried and slower (PERF.md): 8 contiguous
// cells a thread, per-slot warp scans, 128 and 512 threads, a wavefront
// of a row per warp.

//
// Interface (plain C, loaded with ctypes; see ops/acceptor.py): y float32
// [S, ystride], G float32 [ystride], rows int32 [sum L, 4] = (off, first
// and last writable step, character), meta int64 [B, 8] = (first step, T,
// first row, L, W, first pointer byte of the plain version's byte band,
// band, first byte of this kernel's pointer bits); out ptr uint8 [sum L *
// WB(W)]: row l-1 of a read at meta[7] + (l - 1) * WB(W), bit w of it
// (byte w / 8, bit w % 8) the pointer of window cell w, WB(W) = 16 *
// ceil(W / 128) bytes; path int8 [ystride].

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;           // threads per CTA (one read per CTA)
constexpr int WMAX = 2048;        // widest window
constexpr int IPT = WMAX / NT;    // window cells per thread
constexpr int NW = NT / 32;       // warps per CTA
constexpr int RB = 32;            // walk: label rows per staged batch
constexpr int WBMAX = WMAX / 8;   // bytes of a row's pointer bits
constexpr unsigned FULL = 0xffffffffu;
static_assert(NW % 4 == 0 && IPT <= 32, "warp totals as float4, a word per slot");

// Phase clocks (common.cuh; -DPOREOVER_PHASE_CLOCKS only) of thread 0 of
// each read's CTA. Per label row: the row's inputs (loaded a row ahead)
// waited for and the next row's loads issued, the cells' emissions, the
// warp's scan, barrier 1 with the warp totals, the row store, barrier 2,
// the pointer bits. The walk, per row walked: the batches' copies waited
// for, the walk itself. CK_ROWS and CK_WALK_ROWS count rows.
#ifdef POREOVER_PHASE_CLOCKS
enum { CK_LOAD, CK_EMIT, CK_SCAN, CK_BAR1, CK_STORE, CK_BAR2, CK_PTR,
       CK_STAGE, CK_WALK, CK_ROWS, CK_WALK_ROWS, CK_SINK, CK_N };
__device__ unsigned long long g_phase_clocks[CK_N];
#endif

// Bytes of a row's pointer bits for a window of W cells.
__device__ __forceinline__ int row_bytes(int W) {
  return 16 * ((W + 127) / 128);
}

// Window cell of slot k of a thread: warp w owns cells [32 IPT w, 32 IPT
// (w + 1)), its lane l cells 32 IPT w + 32 k + l, so that a warp's loads
// are coalesced and its shared-memory accesses free of bank conflicts, and
// slot k of a warp is one 32-bit word of the row's pointer bits.
__device__ __forceinline__ int cell(int tid, int k) {
  return 32 * IPT * (tid >> 5) + 32 * k + (tid & 31);
}

// One row's inputs for this thread's cells, loaded ahead of the row. Steps
// are clamped into the read (t >= 1 always), so every load is in bounds;
// a cell that is not writable ignores its values.
struct Cells {
  float yc[IPT], g[IPT], yg[IPT];
};

__device__ __forceinline__ void load_cells(Cells& x, const int4 r, int T,
                                           int tid, const float* yr,
                                           long long ys, const float* gb,
                                           const float* gp) {
  const float* yc = yr + (long long)r.w * ys;
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int t = min(r.x + cell(tid, k), T - 1);
    x.yc[k] = yc[t];
    x.g[k] = gb[t];
    x.yg[k] = gp[t];
  }
}

// Index of warp-local cell x in a warp's scan scratch: one pad word per 32,
// so that both a warp's slot-major writes and its lane-major reads (IPT
// consecutive cells per lane) are free of bank conflicts.
__device__ __forceinline__ int pad(int x) { return x + (x >> 5); }

// The walk's shared memory reuses the rows' value buffers.
union Smem {
  float vbuf[2][WMAX + 4];
  unsigned char bits[2][RB][WBMAX];
};

__global__ void __launch_bounds__(NT, 1)
acceptor_kernel(const float* __restrict__ y, long long ys, int S,
                const float* __restrict__ G, const int4* __restrict__ rows,
                const long long* __restrict__ meta, int gap_char,
                unsigned char* __restrict__ ptr,
                signed char* __restrict__ path) {
  __shared__ __align__(16) Smem sm;
  __shared__ __align__(16) float wtot[NW];
  __shared__ float hs[NW][32 * IPT + IPT];  // the warps' scan scratch
  __shared__ int4 rbuf[2][RB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long* m = meta + 8 * blockIdx.x;
  const long long toff = m[0], loff = m[2], pbits = m[7];
  const int T = (int)m[1], L = (int)m[3], W = (int)m[4], band = (int)m[6];
  const int WB = row_bytes(W);
  const float* yr = y + toff;                          // plane 0 of the read
  const float* gp = y + (long long)(S - 1) * ys + toff;  // the gap plane
  const float* gb = G + toff;
  const int4* rw = rows + loff;

  for (int t = tid; t < T; t += NT) path[toff + t] = (signed char)gap_char;
  // row 0: G on [0, band], over positions off_1 - 1 .. off_1 + W - 1; -inf
  // past W, where every row leaves -inf too (its cells past W are not
  // writable), and in the padding a read past the window is clamped to
  const int base0 = L > 0 ? rw[0].x - 1 : 0;
  for (int i = tid; i < WMAX + 4; i += NT) {
    const int p = base0 + i;
    sm.vbuf[0][i] = (i <= W && p <= band && p < T) ? gb[p] : -INFINITY;
    sm.vbuf[1][i] = -INFINITY;
  }
  __syncthreads();

  int base = base0;  // position of the previous row's [0]
  int4 rn = L > 0 ? rw[0] : make_int4(1, 1, 0, 0);  // the next row
  int4 rnn = L > 1 ? rw[1] : make_int4(1, 1, 0, 0);  // the one after
  float* hw = hs[warp];
  CLK_INIT();
  // row l from the inputs cu (loaded a row ahead), loading the next row's
  // into nx
  auto row = [&](int l, const Cells& cu, Cells& nx) {
    const int4 r = rn;
#ifdef POREOVER_PHASE_CLOCKS
    for (int k = 0; k < IPT; ++k) {
      CLK_DEP(cu.yc[k]);
      CLK_DEP(cu.g[k]);
      CLK_DEP(cu.yg[k]);
    }
#endif
    rn = rnn;
    if (l + 1 < L) rnn = rw[l + 1];
    if (l < L) load_cells(nx, rn, T, tid, yr, ys, gb, gp);
    CLK(CK_LOAD);

    const float* vp = sm.vbuf[(l - 1) & 1];
    float* vc = sm.vbuf[l & 1];
    // cell c reads the previous row at c + d (>= 0: off never decreases),
    // -inf past its window; it is writable for c in [r.y - off, r.z - off]
    const int d = r.x - 1 - base, lo = r.y - r.x;
    const unsigned nwr = (unsigned)max(r.z - r.y + 1, 0);
    float emit[IPT];
    bool wr[IPT];
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int c = cell(tid, k);
      wr[k] = (unsigned)(c - lo) < nwr;
      emit[k] = wr[k] ? cu.yc[k] + vp[min(c + d, WMAX + 1)] : -INFINITY;
      hw[pad(32 * k + lane)] = wr[k] ? emit[k] - cu.g[k] : -INFINITY;
    }
    __syncwarp();
    CLK(CK_EMIT);
    // the warp's inclusive max-scan over its cells in order: each lane's
    // IPT consecutive cells, then the lanes' totals; written back in place
    float pf[IPT];
    pf[0] = hw[pad(IPT * lane)];
#pragma unroll
    for (int j = 1; j < IPT; ++j)
      pf[j] = fmaxf(pf[j - 1], hw[pad(IPT * lane + j)]);
    float incl = pf[IPT - 1];
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1)
      incl = fmaxf(incl, __shfl_up_sync(FULL, incl, dd));
    if (lane == 31) wtot[warp] = incl;
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = -INFINITY;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < IPT; ++j) hw[pad(IPT * lane + j)] = fmaxf(excl, pf[j]);
    __syncwarp();
    float pfx[IPT];
#pragma unroll
    for (int k = 0; k < IPT; ++k) pfx[k] = hw[pad(32 * k + lane)];
    const bool seeded = l == 1 && r.x == 1;
    const float seed = seeded ? yr[(long long)r.w * ys] : -INFINITY;
    const float h0 = seeded ? seed - gb[0] : -INFINITY;
    CLK_DEP(pfx[IPT - 1]);
    CLK(CK_SCAN);
    __syncthreads();
    // the warps before this one: their totals, read as broadcasts
    float pre = -INFINITY;
#pragma unroll
    for (int q = 0; q < NW; q += 4) {
      const float4 x = *reinterpret_cast<const float4*>(&wtot[q]);
      if (q < warp) pre = fmaxf(pre, x.x);
      if (q + 1 < warp) pre = fmaxf(pre, x.y);
      if (q + 2 < warp) pre = fmaxf(pre, x.z);
      if (q + 3 < warp) pre = fmaxf(pre, x.w);
    }
    CLK_DEP(pre);
    CLK(CK_BAR1);
    const float carry = fmaxf(h0, pre);
#pragma unroll
    for (int k = 0; k < IPT; ++k)
      vc[cell(tid, k) + 1] =
          wr[k] ? cu.g[k] + fmaxf(carry, pfx[k]) : -INFINITY;
    if (tid == 0) vc[0] = seed;
    CLK(CK_STORE);
    __syncthreads();
    CLK(CK_BAR2);
    // pointer bits: emit >= the stay move from the cell before; slot k of
    // warp w is word IPT w + k of the row's bits, stored by lane k
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const unsigned b = __ballot_sync(
          FULL, wr[k] & (emit[k] >= vc[cell(tid, k)] + cu.yg[k]));
      if (lane == k) word = b;
    }
    if (lane < IPT && 32 * (IPT * warp + lane) < 8 * WB)
      reinterpret_cast<unsigned*>(ptr + pbits + (long long)(l - 1) * WB)
          [IPT * warp + lane] = word;
    base = r.x - 1;
    CLK(CK_PTR);
  };
  Cells ca, cb;
  if (L > 0) load_cells(ca, rn, T, tid, yr, ys, gb, gp);
  int l = 1;
  for (; l + 1 <= L; l += 2) {  // two rows a turn: the buffers swap roles
    row(l, ca, cb);
    row(l + 1, cb, ca);
  }
  if (l <= L) row(l, ca, cb);
  CLK_ADD(CK_ROWS, L);
  __syncthreads();  // the pointer bits and the gap fill, for the walk

  // ---- the walk, on warp 0: batches of RB rows (their pointer bits and
  // row entries) are copied into shared memory one batch ahead; per row
  // from row L and step T - 1, the last emitting step at or before the
  // current one (row 1 emits at step 0 at the latest); the steps in
  // between stay gaps. Every lane walks (the same loads, broadcast), lane
  // 0 writes the path.
  if (warp != 0) return;
  // rows [hi - RB + 1, hi] (1-based, >= 1) of batch k, hi = L - k * RB
  auto stage = [&](int k) {
    const int hi = L - k * RB, n = min(RB, hi);
    const int c = lane & 15;  // 16-byte chunk; a row's are WB / 16 <= 16
    for (int i = lane >> 4; i < n; i += 2)
      if (16 * c < WB)
        __pipeline_memcpy_async(
            &sm.bits[k & 1][i][16 * c],
            ptr + pbits + (long long)(hi - 1 - i) * WB + 16 * c, 16);
    if (lane < n)
      __pipeline_memcpy_async(&rbuf[k & 1][lane], &rw[hi - 1 - lane], 16);
    __pipeline_commit();
  };
  int t = T - 1;
  l = L;
  const int nb = (L + RB - 1) / RB;
  if (nb > 0) stage(0);
  CLK(CK_STAGE);
  for (int k = 0; k < nb && t >= 0; ++k) {
    if (k + 1 < nb) stage(k + 1);
    else __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncwarp();
    CLK(CK_STAGE);
    const int hi = L - k * RB, lo = max(1, hi - RB + 1);
    const int4* rb = rbuf[k & 1];
    int4 r = rb[0];
    for (; l >= lo; --l) {
      const int i = hi - l;
      const int4 rnext = rb[min(i + 1, RB - 1)];  // the next row's, early
      const unsigned* word = reinterpret_cast<const unsigned*>(
          sm.bits[k & 1][i]);
      // the highest cell at or before t, and its word
      const int top = min(t - r.x, W - 1);
      int wi = max(top, 0) >> 5;
      unsigned x = top >= 0 ? word[wi] & (FULL >> (31 - (top & 31))) : 0;
      while (x == 0 && wi > 0) x = word[--wi];
      int found = x ? r.x + 32 * wi + 31 - __clz(x) : -1;
      if (found < 0) {
        if (l != 1) {  // no emitting step left: the rest are gaps
          t = -1;
          break;
        }
        found = 0;  // row 1 emits at step 0 at the latest
      }
      if (lane == 0) path[toff + found] = (signed char)r.w;
      t = found - 1;
      r = rnext;
      CLK_ADD(CK_WALK_ROWS, 1);
      if (t < 0) break;
    }
    __syncwarp();  // the batch's buffer is refilled two batches on
    CLK(CK_WALK);
  }
  CLK_FLUSH(threadIdx.x == 0);
}

}  // namespace

extern "C" {

// Launches B CTAs of NT threads on `stream`, one per read (W <= WMAX, as
// the wrapper checks). Returns a cudaError_t.
int acceptor_launch(const float* y, long long ys, int S, const float* G,
                    const int* rows, const long long* meta, int B,
                    int gap_char, unsigned char* ptr, signed char* path,
                    void* stream) {
  if (B <= 0) return 0;
  acceptor_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      y, ys, S, G, reinterpret_cast<const int4*>(rows), meta, gap_char, ptr,
      path);
  return (int)cudaGetLastError();
}

#ifdef POREOVER_PHASE_CLOCKS
// The phase sums (common.cuh: phase_clocks_copy).
int phase_clocks_read(unsigned long long* out, int n, int reset) {
  return poreover::phase_clocks_copy(g_phase_clocks, out, n, reset);
}
#endif

}  // extern "C"
