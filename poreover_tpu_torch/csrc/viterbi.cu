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
// What bounds it: one read's chain of T - 1 dependent steps; the bytes (y
// read once, the path written once) take microseconds. Clocked (lane 0,
// cycles per step of a full-size flip-flop read, T 58996, H100), the
// kernel before this design (one warp per read, S shuffles and a compare
// chain over a runtime S) spent 482 of its 571 forward cycles in the shuffles and compares, 67
// on the emission load and pointer store, and 57 more per step in lane 0's
// traceback: 18.1 ms a read.
//
// Design. One CTA of NT threads per read. Warp 0 runs the forward: lane j
// < S is to-state j (S a template parameter); per step the lanes' v go
// through shared memory (a buffer per step parity, one __syncwarp), each
// lane adds its S transitions, takes their maximum as a tree of depth
// ceil(log2 S) and adds its emission, held in registers with the rest of
// a 32-step chunk loaded a chunk ahead; it stores v_t and nothing else. A
// step's chain is the broadcast, an add, the tree and an add: ~95 cycles
// (clocked: broadcast 40, adds and tree 57.5, store 12). The back-pointers
// are then computed by all NT threads at once from the stored v (the same
// adds; the first maximum, as the argmax chain takes it), a word per step
// with a byte per to-state, and warp 0 walks them in segments of SEG
// steps: each lane maps every state at the end of its K steps to the state
// before them, the 32 maps are composed across the lanes from the
// segment's end state (integers, exact), and each lane fills its K steps.
// Pointers and walk take ~8 cycles a step: 2.8 ms a read, 6.4x faster.

// Interface (plain C, loaded with ctypes; see ops/viterbi.py): y float32
// [n = sum T, S] (reads back to back), meta int64 [B, 2] = (first row, T >=
// 1), trans float32 [S, S] (trans[j * S + i]: moving i -> j); scratch uint8
// [40 n]: v as float32 [n, 8], then the back-pointers as uint8 [n, 8] (row
// t: one byte per to-state); out path int32 [n].

#include "common.cuh"

namespace {

constexpr int SMAX = 8;
constexpr int NT = 256;      // threads per CTA (one read per CTA)
constexpr int CH = 32;       // forward: steps of emissions held in registers
constexpr int K = 16;        // traceback: steps per lane of a segment
constexpr int SEG = 32 * K;  // traceback: steps per segment
constexpr unsigned FULL = 0xffffffffu;
// the back-pointer word of a step before the read: every state stays
constexpr unsigned long long IDENT = 0x0706050403020100ull;

// Phase clocks (common.cuh; -DPOREOVER_PHASE_CLOCKS only) of thread 0 of
// each read's CTA. The forward step's phases (warp 0): the broadcast of v
// (through shared memory, waited for), the chain (from-state adds, max
// tree, emission add; v waited for), the store of v and the loop; per
// chunk of CH steps the next chunk's loads. The pointer pass (all warps,
// thread 0's time with its barrier). The traceback's (warp 0), per
// segment: the lanes' maps (the pointer words' loads waited for), their
// composition, the fill. The *_STEPS slots count steps.
#ifdef POREOVER_PHASE_CLOCKS
enum { CK_BCAST, CK_CHAIN, CK_STORE, CK_LOAD, CK_POINTERS, CK_MAPS,
       CK_COMPOSE, CK_FILL, CK_STEPS, CK_PTR_STEPS, CK_TB_STEPS, CK_SINK,
       CK_N };
__device__ unsigned long long g_phase_clocks[CK_N];
#endif

// The maximum of x[LO .. LO + N), a tree of depth ceil(log2 N). A maximum
// is exact in any order, so it equals the argmax chain's value.
template <int LO, int N>
__device__ __forceinline__ float tree_max(const float (&x)[SMAX]) {
  if constexpr (N == 1) {
    return x[LO];
  } else {
    constexpr int H = (N + 1) / 2;
    return fmaxf(tree_max<LO, H>(x), tree_max<LO + H, N - H>(x));
  }
}

// The first maximum's index of x[LO .. LO + N): a tree whose left half
// holds the lower indices, taking the right only where it is strictly
// greater (the argmax chain's result).
template <int LO, int N>
__device__ __forceinline__ void first_max(const float (&x)[SMAX], float& m,
                                          int& i) {
  if constexpr (N == 1) {
    m = x[LO];
    i = LO;
  } else {
    constexpr int H = (N + 1) / 2;
    float ml, mr;
    int il, ir;
    first_max<LO, H>(x, ml, il);
    first_max<LO + H, N - H>(x, mr, ir);
    i = mr > ml ? ir : il;
    m = fmaxf(ml, mr);
  }
}

// Byte s (< 8) of a back-pointer word: the from-state of state s.
__device__ __forceinline__ int from_state(unsigned long long w, int s) {
  return __byte_perm((unsigned)w, (unsigned)(w >> 32), s) & 7;
}

template <int S>
__global__ void __launch_bounds__(NT)
viterbi_kernel(const float* __restrict__ y, const long long* __restrict__ meta,
               const float* __restrict__ trans, long long n,
               unsigned char* __restrict__ scratch, int* __restrict__ path) {
  __shared__ int end_state;
  __shared__ __align__(16) float vb[2][SMAX];  // v, broadcast to the lanes
  const int tid = threadIdx.x, lane = tid & 31;
  const long long o = meta[2 * blockIdx.x];
  const int T = (int)meta[2 * blockIdx.x + 1];
  float* vs = reinterpret_cast<float*>(scratch) + 8 * o;  // row t: v_t
  unsigned long long* pw =
      reinterpret_cast<unsigned long long*>(scratch + 32 * n) + o;
  CLK_INIT();

  // ---- forward (warp 0): lane j < S is to-state j (the other lanes
  // repeat state 0, writing its values where it does); per step v of every
  // state from the lanes, the S adds, the maximum, the emission; v_t is
  // stored for the pointer pass
  if (tid < 32) {
    const int j = lane < S ? lane : 0;
    float tr[SMAX];
#pragma unroll
    for (int i = 0; i < S; ++i) tr[i] = trans[j * S + i];
    const float* yp = y + o * S + j;
    float* vp = vs + j;
    float v = yp[0];
    vp[0] = v;
    auto step = [&](float yt, int t) {
      float sc[SMAX];
      vb[t & 1][j] = v;  // a buffer per step parity: one __syncwarp a step
      __syncwarp();
#pragma unroll
      for (int i = 0; i < S; ++i) sc[i] = vb[t & 1][i];
      CLK_DEP(sc[S - 1]);
      CLK(CK_BCAST);
#pragma unroll
      for (int i = 0; i < S; ++i) sc[i] += tr[i];
      v = yt + tree_max<0, S>(sc);
      CLK_DEP(v);
      CLK(CK_CHAIN);
      vp[8LL * t] = v;
      CLK(CK_STORE);
    };
    // full chunks of CH steps from registers, loaded a chunk ahead; the
    // tail
    const int nfull = (T - 1) / CH;
    float ya[CH], yb[CH];
    if (nfull > 0) {
#pragma unroll
      for (int s = 0; s < CH; ++s) ya[s] = yp[(1 + s) * S];
    }
    int t0 = 1;
    for (int c = 0; c < nfull; ++c, t0 += CH) {
      if (c + 1 < nfull) {
#pragma unroll
        for (int s = 0; s < CH; ++s) yb[s] = yp[(t0 + CH + s) * S];
      }
      CLK(CK_LOAD);
#pragma unroll
      for (int s = 0; s < CH; ++s) step(ya[s], t0 + s);
#pragma unroll
      for (int s = 0; s < CH; ++s) ya[s] = yb[s];
    }
    for (int t = t0; t < T; ++t) step(yp[(long long)t * S], t);
    // the last state: the first maximum of v (every v = -inf: state 0,
    // as in argmax)
    float bv = lane < S ? v : -INFINITY;
    int bi = lane < S ? lane : SMAX;
    for (int d = 16; d > 0; d >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, d);
      const int oi = __shfl_xor_sync(FULL, bi, d);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) end_state = bi < S ? bi : 0;
    CLK(CK_LOAD);
  }
  CLK_ADD(CK_STEPS, T - 1);
  __syncthreads();

  // ---- pointer pass (every thread): step t's word from v_{t-1}, byte j
  // the first maximum's from-state of to-state j, as the plain version
  float tm[SMAX][SMAX];
#pragma unroll
  for (int jj = 0; jj < S; ++jj)
#pragma unroll
    for (int i = 0; i < S; ++i) tm[jj][i] = trans[jj * S + i];
  for (int t = 1 + tid; t < T; t += NT) {
    float vv[SMAX];
#pragma unroll
    for (int i = 0; i < S; ++i) vv[i] = vs[8LL * (t - 1) + i];
    unsigned long long word = IDENT;
#pragma unroll
    for (int jj = 0; jj < S; ++jj) {
      float sc[SMAX];
#pragma unroll
      for (int i = 0; i < S; ++i) sc[i] = vv[i] + tm[jj][i];
      float best;
      int arg;
      first_max<0, S>(sc, best, arg);
      word = (word & ~(0xffull << (8 * jj))) |
             ((unsigned long long)arg << (8 * jj));
    }
    pw[t] = word;
  }
  __syncthreads();
  CLK(CK_POINTERS);
  CLK_ADD(CK_PTR_STEPS, T - 1);

  // ---- traceback (warp 0) by segments of SEG steps, te down to te - SEG
  // + 1: lane q takes K steps of it and maps each state at its last step
  // to the state before its first (steps before the read keep the state);
  // the maps are composed across the lanes from the segment's end state,
  // and each lane fills its steps from the state the composition gave it
  if (tid < 32) {
    auto load = [&](unsigned long long (&w)[K], int hi) {
#pragma unroll
      for (int k = 0; k < K; ++k) w[k] = hi - k >= 1 ? pw[hi - k] : IDENT;
    };
    unsigned long long w[K], wn[K];
    int state = end_state;
    int te = T - 1;
    if (te >= 1) load(w, te - (31 - lane) * K);
    for (; te >= 1; te -= SEG) {
      const int hi = te - (31 - lane) * K;
      if (te - SEG >= 1) load(wn, hi - SEG);
      unsigned map = 0;
#pragma unroll
      for (int e = 0; e < S; ++e) {
        int s = e;
#pragma unroll
        for (int k = 0; k < K; ++k) s = from_state(w[k], s);
        map |= (unsigned)s << (4 * e);
      }
      CLK_DEP(__int_as_float(map));
      CLK(CK_MAPS);
      int mine = 0;
#pragma unroll
      for (int q = 31; q >= 0; --q) {
        const unsigned mq = __shfl_sync(FULL, map, q);
        if (lane == q) mine = state;
        state = (mq >> (4 * state)) & 15;
      }
      CLK_DEP(__int_as_float(state));
      CLK(CK_COMPOSE);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (hi - k >= 0) path[o + hi - k] = mine;
        mine = from_state(w[k], mine);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) w[k] = wn[k];
      CLK(CK_FILL);
    }
    // te is 0 when the last segment ended at step 1 (or T is 1): step 0
    if (te == 0 && lane == 0) path[o] = state;
  }
  CLK_ADD(CK_TB_STEPS, T - 1);
  CLK_FLUSH(threadIdx.x == 0);
}

}  // namespace

extern "C" {

int viterbi_max_states() { return SMAX; }

// Launches B CTAs of NT threads on `stream`, one per read, the kernel
// instance of S states. `scratch` holds 40 bytes per step of the batch (n
// steps): v as float32 [n, 8], then the back-pointers as uint8 [n, 8].
// Returns a cudaError_t (cudaErrorInvalidValue for S outside 1..SMAX).
int viterbi_launch(const float* y, const long long* meta, const float* trans,
                   int B, int S, long long n, unsigned char* scratch,
                   int* path, void* stream) {
  if (B <= 0) return 0;
  void (*kernels[SMAX])(const float*, const long long*, const float*,
                        long long, unsigned char*, int*) = {
      viterbi_kernel<1>, viterbi_kernel<2>, viterbi_kernel<3>,
      viterbi_kernel<4>, viterbi_kernel<5>, viterbi_kernel<6>,
      viterbi_kernel<7>, viterbi_kernel<8>};
  if (S < 1 || S > SMAX) return (int)cudaErrorInvalidValue;
  kernels[S - 1]<<<B, NT, 0, (cudaStream_t)stream>>>(y, meta, trans, n,
                                                      scratch, path);
  return (int)cudaGetLastError();
}

#ifdef POREOVER_PHASE_CLOCKS
// The phase sums (common.cuh: phase_clocks_copy).
int phase_clocks_read(unsigned long long* out, int n, int reset) {
  return poreover::phase_clocks_copy(g_phase_clocks, out, n, reset);
}
#endif

}  // extern "C"
