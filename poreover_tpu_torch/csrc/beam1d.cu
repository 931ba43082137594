// 1D CTC beam search over time (all three model kinds), CUDA for sm_90a.
//
// Replaces the Pallas TPU kernel poreover_tpu/ops/pallas_beam1d.py
// (_build_kernel, launched by _run_kernel) and its on-device provenance
// walk (_traceback_device). Computes the beam search of
// poreover_tpu/ops/beam.py (width W, alphabet A, C = W*(A+1) <= 128
// candidate slots: W "stay" slots then W*A children, a 2-component node
// state per slot) -- and what the port's plain PyTorch version
// ops/beam1d.py:beam1d_plain computes, op for op, so the two agree bit for
// bit on the card.
//
// Design: one CTA of 128 threads per read, one thread per candidate slot.
// Each CTA loops over its own read's length, so no read is padded to the
// longest and there are no no-op steps. The candidate table (two hash
// keys, parent keys, chars, state, score code, validity) is double-buffered
// in shared memory. Per step:
//   1. the W winners, by rank instead of W serial arg-max rounds. The TPU
//      kernel picks the best remaining slot W times and drops every slot
//      with the winner's keys after each pick. Duplicate keys carry
//      identical states and so identical scores, so the same winners in the
//      same order come from: keep the first valid slot of each key; order
//      those by score, equal scores by lowest slot; take the first W. A
//      thread finds an earlier slot with its key in its key's hash chain
//      (below), then scans the table once to count the kept slots that
//      beat it (score as an order-preserving integer code above the slot
//      number in one 64-bit word, so one comparison decides; two words per
//      16-byte load); a kept slot of rank r < W is winner r. The winners'
//      source slots go to shared memory and, as W uint8 per step, to the
//      provenance in global memory.
//   2. every thread builds its new slot: a stay slot looks up its parent's
//      key in the old table, a child slot its own key, then applies the
//      per-kind node update, and links its slot into the new table's hash
//      chains.
// The key joins (the TPU kernel's masked-max reductions over all lanes) go
// through hash chains in shared memory: 256 bucket heads and one "next"
// link per slot, built with one atomic exchange per valid slot as the slot
// is written. A lookup walks its bucket's chain (mostly zero to two slots)
// and takes the maximum state over the slots with its key, which is what
// the masked max over the whole table gives; only valid slots are linked.
// Emissions are staged into shared memory CHUNK steps at a time (one
// coalesced read of the [CHUNK, S] rows). After the last step the CTA
// walks its own provenance backwards, CHUNK steps at a time through shared
// memory, and writes one char (or -1) per step.
//
// What bounds it: latency. A step is two chain walks, one 128-long scan of
// shared memory and a few log-add-exps behind three barriers, and only B
// CTAs run (one per read of a wave). Bytes (emissions in, W provenance
// bytes per step out) and float operations are both far below what the
// card offers.
//
// Interface (plain C, loaded with ctypes; see ops/beam1d.py): y float32
// [sum T, S] (reads back to back; S = A+1 blank-last, or 2A for flip-flop),
// root float32 [sum T] (ctc: the root's value at t-1, i.e. the cumulative
// blank through t-1; unused otherwise), meta int64 [B, 2] = (first row, T);
// outputs prov uint8 [sum T, W] (source slot + 1 of each winner, 0 = none;
// row 0 of a read is 0), chars int8 [sum T] (the char decoded at each step
// or -1), st0 / st1 float32 [B, C] and val uint8 [B, C] (the final table).

#include "common.cuh"

namespace {

using poreover::M1;
using poreover::M2;
using poreover::lse;

constexpr int NT = 128;      // threads per CTA = candidate slots
constexpr int CHUNK = 128;   // steps of emissions / provenance staged
constexpr int SMAX = 8;      // widest emission row (flip-flop, A = 4)
constexpr int WMAX = 32;     // widest beam (rows of the staged provenance)
constexpr int NBUCKET = 256; // hash-chain heads per table

typedef unsigned long long u64;

// Both 32-bit hash keys of a prefix as one word (k1 low, k2 high).
__device__ __forceinline__ u64 pack_key(unsigned k1, unsigned k2) {
  return ((u64)k2 << 32) | k1;
}

// Order-preserving code of a score: a larger float has a larger code, equal
// floats (-0 and +0 too) the same code, and every code is above 0, the code
// of "no candidate".
__device__ __forceinline__ unsigned order_code(float s) {
  s += 0.0f;  // -0 -> +0
  const unsigned u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct Table {
  u64 key[NT], pkey[NT];  // own and parent prefix keys
  int chr[NT], pch[NT];
  unsigned code[NT];      // order code of the score; 0 = invalid slot
  float st0[NT], st1[NT];  // an invalid slot's are -inf
  int head[NBUCKET];      // first slot of each bucket's chain, -1 = empty
  int next[NT];           // the chain's next slot, -1 = end
};

__device__ __forceinline__ int bucket_of(u64 key) {
  unsigned x = (unsigned)key ^ (unsigned)(key >> 32);  // fold all 64 bits
  x ^= x >> 16;
  x ^= x >> 8;
  return (int)(x & (NBUCKET - 1));
}

// Link a slot whose key is written into its bucket's chain. The atomic
// exchange hands each of the threads that link into one bucket a distinct
// predecessor, so every chain ends after as many slots as were linked.
__device__ __forceinline__ void chain_link(Table& t, int slot, u64 key) {
  t.next[slot] = atomicExch(&t.head[bucket_of(key)], slot);
}

struct Shared {
  Table tab[2];
  // kept slots: score code above NT-1-slot; read two per 16-byte load
  alignas(16) u64 rank_key[NT];
  int src[WMAX];             // winner w's source slot, -1 when none
  float y[CHUNK][SMAX + 1];  // emission rows of the current chunk
  float root[CHUNK];
  unsigned char prov[CHUNK * WMAX];
  signed char chars[CHUNK];
  int j;                     // the slot the provenance walk stands on
};

// The W best slots of the table into sh.src[0..W) (-1 where fewer are
// left): first valid slot of each key, by score, equal scores by lowest
// slot. All NT threads; ends behind a barrier.
__device__ __forceinline__ void rank_winners(const Table& t, Shared& sh,
                                             int W, int tid) {
  const u64 mykey = t.key[tid];
  const unsigned mycode = t.code[tid];
  u64 mine = 0ull;
  if (mycode != 0u) {
    bool dup = false;  // an earlier valid slot has this key
    for (int j = t.head[bucket_of(mykey)]; j >= 0; j = t.next[j])
      dup |= j < tid && t.key[j] == mykey;
    if (!dup) mine = ((u64)mycode << 32) | (unsigned)(NT - 1 - tid);
  }
  sh.rank_key[tid] = mine;
  if (tid < W) sh.src[tid] = -1;
  __syncthreads();
  int r0 = 0, r1 = 0;
  const ulonglong2* rk = reinterpret_cast<const ulonglong2*>(sh.rank_key);
#pragma unroll 8
  for (int j = 0; j < NT / 2; ++j) {
    const ulonglong2 two = rk[j];
    r0 += two.x > mine;
    r1 += two.y > mine;
  }
  if (mine != 0ull && r0 + r1 < W) sh.src[r0 + r1] = tid;
  __syncthreads();
}

template <int MODEL>
__global__ void __launch_bounds__(NT)
beam1d_kernel(const float* __restrict__ y, const float* __restrict__ root,
              const long long* __restrict__ meta, int W, int A, int S,
              unsigned char* prov, signed char* __restrict__ chars,
              float* __restrict__ st0_out, float* __restrict__ st1_out,
              unsigned char* __restrict__ val_out) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int C = W * (A + 1);
  const long long off = meta[2 * blockIdx.x];
  const int T = (int)meta[2 * blockIdx.x + 1];
  const float* yr = y + off * S;
  unsigned char* pv = prov + off * W;
  signed char* ch_out = chars + off;

  // ---- initial table (t = 0): the A root children in the child slots of
  // beam row 0; everything else invalid
  {
    const int i = tid;
    const bool child = i >= W && i < W + A;
    const int c = i - W;
    float s0 = -INFINITY, s1 = -INFINITY;
    if (child) {
      if (MODEL == 0) {
        s0 = yr[c];
      } else if (MODEL == 1) {
        s1 = yr[c];
      } else {
        s0 = yr[c];
        s1 = yr[c + A];
      }
    }
    for (int b = 0; b < 2; ++b) {
      Table& t = sh.tab[b];
      const bool live = child && b == 0;
      const unsigned cc = (unsigned)(c + 1);
      t.key[i] = child ? pack_key(cc, cc) : 0ull;
      t.pkey[i] = 0ull;
      t.chr[i] = child ? c : -1;
      t.pch[i] = -1;
      t.code[i] = live ? order_code(MODEL == 0 ? s0 : lse(s0, s1)) : 0u;
      t.st0[i] = live ? s0 : -INFINITY;
      t.st1[i] = live ? s1 : -INFINITY;
      t.next[i] = -1;
      for (int h = i; h < NBUCKET; h += NT) t.head[h] = -1;
    }
    if (tid < W) pv[tid] = 0;
    __syncthreads();
    if (child) {
      const unsigned cc = (unsigned)(c + 1);
      chain_link(sh.tab[0], i, pack_key(cc, cc));
    }
  }
  int cur = 0;
  // the winner this thread's slot descends from, and the char it appends
  const bool stay = tid < W;
  const int w = stay ? tid : (tid - W) / A;
  const int c = stay ? -1 : (tid - W) % A;
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    // ---- emissions: rows cb .. cb+CHUNK-1 into shared memory. The reads
    // of the previous chunk ended before the barrier that closed step t-1;
    // the barriers of the selection publish this one.
    const int cb = ((t - 1) / CHUNK) * CHUNK + 1;
    if (t == cb) {
      const float* src = yr + (long long)cb * S;
      const int n = min(CHUNK, T - cb) * S;
      for (int k = tid; k < n; k += NT) sh.y[k / S][k % S] = src[k];
      if (MODEL == 0 && cb + tid < T) sh.root[tid] = root[off + cb + tid];
    }
    const Table& old = sh.tab[cur];
    Table& nt = sh.tab[1 - cur];
    // empty the new table's chains; nothing reads them before the update
    for (int h = tid; h < NBUCKET; h += NT) nt.head[h] = -1;

    // ---- winners, and their provenance
    rank_winners(old, sh, W, tid);
    if (tid < W) pv[(long long)t * W + tid] = (unsigned char)(sh.src[tid] + 1);

    // ---- one new slot per thread
    if (tid < C) {
      const int i = tid;
      const int s = sh.src[w];
      const bool ok = s >= 0;
      u64 wkey = 0ull, wpkey = 0ull;
      int wch = -1, wpch = -1;
      float ws0 = -INFINITY, ws1 = -INFINITY;
      if (ok) {
        wkey = old.key[s];
        wpkey = old.pkey[s];
        wch = old.chr[s];
        wpch = old.pch[s];
        ws0 = old.st0[s];
        ws1 = old.st1[s];
      }
      u64 nkey, npkey, q;
      int nch, npch;
      if (stay) {
        nkey = wkey;
        npkey = wpkey;
        nch = wch;
        npch = wpch;
        q = wpkey;  // looks up its parent
      } else {
        nkey = pack_key((unsigned)wkey * M1 + (unsigned)(c + 1),
                        (unsigned)(wkey >> 32) * M2 + (unsigned)(c + 1));
        npkey = wkey;
        nch = c;
        npch = wch;
        q = nkey;  // looks up its own state at t-1
      }
      float n0 = -INFINITY, n1 = -INFINITY;
      if (ok) {
        // hash join against the old table: duplicate keys carry identical
        // states, so the maximum over the matches is the match
        float l0 = -INFINITY, l1 = -INFINITY;
        for (int j = old.head[bucket_of(q)]; j >= 0; j = old.next[j])
          if (old.key[j] == q) {
            l0 = fmaxf(l0, old.st0[j]);
            l1 = fmaxf(l1, old.st1[j]);
          }
        float s0, s1, p0, p1;  // own and parent state at t-1
        if (stay) {
          s0 = ws0;
          s1 = ws1;
          p0 = l0;
          p1 = l1;
          // a depth-1 node's parent is the root: cumulative blank (ctc)
          if (MODEL == 0 && wpkey == 0ull) p0 = sh.root[t - cb];
        } else {
          s0 = l0;
          s1 = l1;
          p0 = ws0;
          p1 = ws1;
        }
        const float* yt = sh.y[t - cb];
        const int ch = nch < 0 ? 0 : nch;
        const bool same = nch == npch;
        const float y_c = yt[ch];
        if (MODEL == 0) {
          n0 = lse(p0 + y_c, s0 + yt[S - 1]);
        } else if (MODEL == 1) {
          n0 = lse(s0, s1) + yt[S - 1];
          const float from = same ? p0 : lse(p0, p1);
          n1 = lse(from + y_c, s1 + y_c);
        } else {
          const float y_cf = yt[ch + A];
          const float emit_flip = (same ? p1 : lse(p0, p1)) + y_c;
          const float emit_flop = same ? p0 + y_cf : -INFINITY;
          n0 = lse(emit_flip, s0 + y_c);
          n1 = lse(emit_flop, s1 + y_cf);
        }
      }
      nt.key[i] = nkey;
      nt.pkey[i] = npkey;
      nt.chr[i] = nch;
      nt.pch[i] = npch;
      nt.code[i] = ok ? order_code(MODEL == 0 ? n0 : lse(n0, n1)) : 0u;
      nt.st0[i] = n0;
      nt.st1[i] = n1;
      if (ok) chain_link(nt, i, nkey);
    }
    cur = 1 - cur;
    __syncthreads();
  }

  // ---- final table and its best slot
  const Table& fin = sh.tab[cur];
  if (tid < C) {
    st0_out[blockIdx.x * C + tid] = fin.st0[tid];
    st1_out[blockIdx.x * C + tid] = fin.st1[tid];
    val_out[blockIdx.x * C + tid] = (unsigned char)(fin.code[tid] != 0u);
  }
  rank_winners(fin, sh, 1, tid);
  if (tid == 0) sh.j = sh.src[0];

  // ---- provenance walk, newest step first, CHUNK steps at a time
  for (int hi = T - 1; hi >= 1; hi -= CHUNK) {
    const int lo = max(hi - CHUNK + 1, 1), n = hi - lo + 1;
    __syncthreads();
    for (int k = tid; k < n * W; k += NT)
      sh.prov[k] = pv[(long long)lo * W + k];
    __syncthreads();
    if (tid == 0) {
      int j = sh.j;
      for (int t = hi; t >= lo; --t) {
        const bool child = j >= W;
        const int w = child ? (j - W) / A : j;
        int c = child ? (j - W) % A : -1;
        const int s = j >= 0 ? (int)sh.prov[(t - lo) * W + w] - 1 : -1;
        if (s >= 0) j = s; else c = -1;
        sh.chars[t - lo] = (signed char)c;
      }
      sh.j = j;
    }
    __syncthreads();
    if (tid < n) ch_out[lo + tid] = sh.chars[tid];
  }
  __syncthreads();
  // the walk ends in the initial table: a root child at slot W + c
  if (tid == 0) {
    const int j = sh.j;
    ch_out[0] = (signed char)(j >= W ? (j - W) % A : -1);
  }
}

}  // namespace

extern "C" {

// Launches one CTA per read on `stream`; returns cudaGetLastError().
int beam1d_launch(const float* y, const float* root, const long long* meta,
                  int B, int W, int A, int S, int model, unsigned char* prov,
                  signed char* chars, float* st0, float* st1,
                  unsigned char* val, void* stream) {
  if (W < 1 || W > WMAX || A < 1 || W * (A + 1) > NT || S > SMAX ||
      model < 0 || model > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (B > 0) {
    if (model == 0)
      beam1d_kernel<0><<<B, NT, 0, st>>>(y, root, meta, W, A, S, prov, chars,
                                         st0, st1, val);
    else if (model == 1)
      beam1d_kernel<1><<<B, NT, 0, st>>>(y, root, meta, W, A, S, prov, chars,
                                         st0, st1, val);
    else
      beam1d_kernel<2><<<B, NT, 0, st>>>(y, root, meta, W, A, S, prov, chars,
                                         st0, st1, val);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
