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
// What bounds it: latency. A step is a short chain of dependent phases
// (pick the W winners, build C new slots from them, one log-add-exp or a
// few per slot), and only B CTAs run (one per read of a wave): one warp
// per scheduler, so every shared-memory round trip and every 16-byte load
// a warp issues is paid in full. Bytes (emissions in, W
// provenance bytes per step out) and float operations are both far below
// what the card offers. The step, three barriers, one thread per slot:
//
// - dedup and survivors. The TPU kernel picks the best remaining slot W
//   times and drops every slot with the winner's keys; the same winners in
//   the same order come from: keep the first valid slot of each key, order
//   those by score (equal scores by lowest slot), take the first W
//   (duplicate keys carry identical states). A slot is kept when its hash
//   bucket's first slot is its own. The W stay slots come first and have
//   distinct keys, so when all are valid each is kept, and no slot scoring
//   below the lowest of them can win: that code (a warp min over the stays
//   as they are built) is a threshold. Each warp lists its kept slots at
//   or above it (a ballot; ~35 of 125 survive on the decode wave) as 32-bit
//   words: the score's order-preserving code above the threshold, over the
//   slot (rare "wide" steps, whose codes spread over 2^25 or more, compare
//   64-bit words with the codes read from the records).
// - ranks. Four threads count one survivor, each the words of one warp's
//   list that beat its own (8 unconditional 16-byte loads: the lists are
//   zero-padded, and a zero never beats a word; the lists' segments are
//   36 words apart so the four fall in different banks), summed by two
//   shuffles, 32 survivors per round; when more survive, two threads each
//   count two warps' lists, 64 survivors per round. The survivor of rank
//   r < W is winner r: its source slot and its record are staged for the
//   build.
// - build. Each thread reads its winner's staged record and this step's
//   emission row (prefetched as two 16-byte loads), looks up the state it
//   joins with (a stay its parent's, a child its own at t-1) in the old
//   table's hash table, claims its key's bucket in the new one, applies the
//   per-kind update, and raises the bucket's two states.
//
// The key joins (the TPU kernel's masked-max reductions over all lanes)
// and the dedup go through an open-addressed hash table per table (linear
// probing, the key in the bucket, in dynamic shared memory): each
// valid slot claims its key's bucket with a 64-bit compare-and-swap,
// lowers the bucket's first slot (atomicMin) and raises its two states
// (atomicMax on an order-preserving int); a lookup is one probe of two
// parallel loads. A table is emptied two steps later bucket by bucket, by
// the threads that used them. A key equal to the empty marker cannot go
// into the table; such slots (a hash collision with the marker) are found
// by scanning the table. More buckets give shorter probes (a warp waits
// for its longest) but fewer CTAs per SM: a launch takes the most buckets,
// from 2^NB_BITS_MAX (one CTA per SM) down to 2^NB_BITS_MIN (eight), with
// which its wave is resident in the fewest rounds (pick_bits). Emissions
// are staged into shared memory CHUNK steps at a time, the next chunk
// fetched with cp.async while the current one is used. After the last
// step the CTA walks its own provenance backwards, CHUNK steps at a time
// through shared memory, and writes one char (or -1) per step.
//
// Interface (plain C, loaded with ctypes; see ops/beam1d.py): y float32
// [sum T, S] (reads back to back; S = A+1 blank-last, or 2A for flip-flop),
// root float32 [sum T] (ctc: the root's value at t-1, i.e. the cumulative
// blank through t-1; unused otherwise), meta int64 [B, 2] = (first row, T);
// outputs prov uint8 [sum T, W] (source slot + 1 of each winner, 0 = none;
// row 0 of a read is 0), chars int8 [sum T] (the char decoded at each step
// or -1), st0 / st1 float32 [B, C] and val uint8 [B, C] (the final table).

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

using poreover::M1;
using poreover::M2;
using poreover::lse;

constexpr int NT = 128;      // threads per CTA = candidate slots
constexpr int NWARP = NT / 32;
constexpr int CHUNK = 64;    // steps of emissions / provenance staged
constexpr int SMAX = 8;      // widest emission row (flip-flop, A = 4)
constexpr int WMAX = 32;     // widest beam: the stays are warp 0's lanes
constexpr int NB_BITS_MAX = 12;  // hash buckets per table: 2^12 .. 2^8
constexpr int NB_BITS_MIN = 8;
constexpr int SEG = 36;      // stride of the survivor lists' segments
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

constexpr u64 EMPTY = ~0ull;          // key of an empty bucket
constexpr int NO_SLOT = 0x7fffffff;   // first slot of an empty bucket

// Phase clocks (common.cuh; -DPOREOVER_PHASE_CLOCKS only) of thread 0 of
// every CTA, per phase of the step. Slot CK_STEPS counts steps.
#ifdef POREOVER_PHASE_CLOCKS
enum { CK_REFILL, CK_DEDUP, CK_RANK, CK_PUBLISH, CK_GATHER, CK_JOIN,
       CK_UPDATE, CK_LINK, CK_BARRIER, CK_STEPS, CK_N };
__device__ unsigned long long g_phase_clocks[CK_N];
#endif

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

// A state as an int whose signed order is the float's (for atomicMax),
// and back. Never NaN here; -0 orders below +0, so the masked max of a
// -0 and a +0 (states of two slots with one key: a hash collision) is +0,
// where the plain version's reduction order picks one.
__device__ __forceinline__ int max_code(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float from_max_code(int e) {
  return __int_as_float(e >= 0 ? e : e ^ 0x7fffffff);
}

// One candidate slot, 32 bytes.
struct alignas(16) Rec {
  u64 key, pkey;   // own and parent prefix keys
  float st0, st1;  // an invalid slot's are -inf
  int chars;       // own char in the low 16 bits, parent's in the high
  unsigned code;   // order code of the score; 0 = invalid slot
};

__device__ __forceinline__ Rec load_rec(const Rec& r) {
  const uint4* p = reinterpret_cast<const uint4*>(&r);
  const uint4 a = p[0], b = p[1];
  Rec o;
  o.key = pack_key(a.x, a.y);
  o.pkey = pack_key(a.z, a.w);
  o.st0 = __uint_as_float(b.x);
  o.st1 = __uint_as_float(b.y);
  o.chars = (int)b.z;
  o.code = b.w;
  return o;
}

__device__ __forceinline__ void store_rec(Rec& r, const Rec& v) {
  uint4* p = reinterpret_cast<uint4*>(&r);
  p[0] = make_uint4((unsigned)v.key, (unsigned)(v.key >> 32),
                    (unsigned)v.pkey, (unsigned)(v.pkey >> 32));
  p[1] = make_uint4(__float_as_uint(v.st0), __float_as_uint(v.st1),
                    (unsigned)v.chars, v.code);
}

__device__ __forceinline__ int pack_chars(int chr, int pch) {
  return (chr & 0xffff) | (int)((unsigned)pch << 16);
}
__device__ __forceinline__ int own_char(int chars) {
  return (int)(short)(chars & 0xffff);
}
__device__ __forceinline__ int parent_char(int chars) { return chars >> 16; }

// v[i] of the 8 floats a, b (i in [0, 8)), without indexing registers.
__device__ __forceinline__ float pick8(const float4& a, const float4& b,
                                      int i) {
  const float x01 = (i & 1) ? a.y : a.x, x23 = (i & 1) ? a.w : a.z;
  const float x45 = (i & 1) ? b.y : b.x, x67 = (i & 1) ? b.w : b.z;
  const float lo = (i & 2) ? x23 : x01, hi = (i & 2) ? x67 : x45;
  return (i & 4) ? hi : lo;
}

// The open-addressed hash table of one candidate table's valid slots,
// 2^BITS buckets (at most NT keys: never full).
template <int BITS>
struct alignas(16) Hash {
  static constexpr int bits = BITS, NB = 1 << BITS;
  u64 key[NB];    // EMPTY, or the key of the slots in this bucket
  int first[NB];  // lowest slot with the key
  int2 st[NB];    // largest st0 / st1 over those slots (max_code)
  int marker;     // some valid slot's key equals EMPTY
};

// Empties one bucket.
template <class H>
__device__ __forceinline__ void clear_bucket(H& h, int b) {
  h.key[b] = EMPTY;
  h.first[b] = NO_SLOT;
  h.st[b] = make_int2(max_code(-INFINITY), max_code(-INFINITY));
}

template <class H>
__device__ __forceinline__ int bucket_of(u64 key) {
  unsigned x = (unsigned)key * 0x9e3779b1u + (unsigned)(key >> 32);
  x *= 0x85ebca6bu;
  return (int)(x >> (32 - H::bits));
}

// Empties a whole table (all NT threads); visible after the next barrier.
template <class H>
__device__ __forceinline__ void clear_hash(H& h, int tid) {
  for (int b = tid; b < H::NB; b += NT) clear_bucket(h, b);
  if (tid == 0) h.marker = 0;
}

// Inserting valid slot `slot` with key `key` (not EMPTY) takes two calls,
// so that the compare-and-swap's latency hides behind the caller's work:
// hash_claim tries the key's home bucket b; hash_settle probes on from
// there until the key's bucket, lowers its first slot and returns it.
template <class H>
__device__ __forceinline__ u64 hash_claim(H& h, u64 key, int& b) {
  b = bucket_of<H>(key);
  return atomicCAS(&h.key[b], EMPTY, key);
}
template <class H>
__device__ __forceinline__ int hash_settle(H& h, u64 key, int b, u64 prev,
                                           int slot) {
  while (prev != EMPTY && prev != key) {
    b = (b + 1) & (H::NB - 1);
    prev = atomicCAS(&h.key[b], EMPTY, key);
  }
  atomicMin(&h.first[b], slot);
  return b;
}

// How many of the n survivors listed at lst beat the rank word me, by
// their 64-bit words (the code above the slot), the codes read from recs
// (a step whose words need 64 bits; rare, out of line).
__device__ __noinline__ int count_wide(const unsigned* lst, int n,
                                       const Rec* recs, u64 me) {
  int r = 0;
  for (int k = 0; k < n; ++k) {
    const unsigned j = NT - 1 - (lst[k] & (NT - 1));
    r += (((u64)recs[j].code << 32) | (NT - 1 - j)) > me;
  }
  return r;
}

// The rare paths, out of line to keep the step's code small. A valid
// slot whose key equals EMPTY (a hash collision with the marker) is kept
// when no valid slot before it has that key; a lookup of EMPTY takes the
// largest states over the valid slots with it.
__device__ __noinline__ bool empty_key_first(const Rec* recs, int slot) {
  for (int j = 0; j < slot; ++j)
    if (recs[j].code != 0u && recs[j].key == EMPTY) return false;
  return true;
}
__device__ __noinline__ float2 empty_key_states(const Rec* recs, int C) {
  float2 l = make_float2(-INFINITY, -INFINITY);
  for (int j = 0; j < C; ++j)
    if (recs[j].code != 0u && recs[j].key == EMPTY) {
      l.x = fmaxf(l.x, recs[j].st0);
      l.y = fmaxf(l.y, recs[j].st1);
    }
  return l;
}

// The largest states over the valid slots with key q (-inf when none):
// the masked max over the whole table.
template <class H>
__device__ __forceinline__ void hash_lookup(const H& h, const Rec* recs,
                                            int C, u64 q, float& l0,
                                            float& l1) {
  l0 = -INFINITY;
  l1 = -INFINITY;
  if (q == EMPTY) {
    if (h.marker) {
      const float2 l = empty_key_states(recs, C);
      l0 = l.x;
      l1 = l.y;
    }
    return;
  }
  int b = bucket_of<H>(q);
  for (;;) {
    const u64 k = h.key[b];
    const int2 s = h.st[b];
    if (k == q) {
      l0 = from_max_code(s.x);
      l1 = from_max_code(s.y);
      return;
    }
    if (k == EMPTY) return;
    b = (b + 1) & (H::NB - 1);
  }
}

struct Shared {
  Rec rec[2][NT];
  // survivors' 32-bit rank words, a segment of 32 per warp, SEG apart (so
  // that the four segments' words at one offset fall in different banks)
  alignas(16) unsigned list32[NWARP * SEG];
  int wide;                    // a survivor's word needs 64 bits
  alignas(16) int cnt[NWARP];  // survivors listed by each warp
  int src[WMAX];               // winner w's source slot, -1 when none
  Rec wrec[WMAX];              // winner w's record
  unsigned tau;                // lowest stay code (0: some stay invalid)
  int j;                       // the slot the provenance walk stands on
  union {
    struct {  // the loop: the emission rows of two chunks
      alignas(16) float y[2][CHUNK][SMAX];
      float root[2][CHUNK];
    } e;
    struct {  // the provenance walk
      unsigned char prov[CHUNK * WMAX];
      signed char chars[CHUNK];
    } w;
  } u;
};

// The winners' source slots sh.src[r] and their records sh.wrec[r] from
// the survivor lists of table cur: survivor s is counted by threads
// P*s .. P*s+P-1 (NT/P survivors per round), thread P*s+g against the
// 4/P segments of the lists from (4/P)*g on; a survivor of rank r < W is
// winner r.
template <int P>
__device__ __forceinline__ void rank_survivors(Shared& sh, int cur,
                                               int4 cnt, int n_surv,
                                               bool wide, int W, int tid) {
  constexpr int G = 4 / P;  // segments per thread
  const int p1 = cnt.x, p2 = p1 + cnt.y, p3 = p2 + cnt.z;
  for (int s0 = 0; s0 < n_surv; s0 += NT / P) {
    const int s = s0 + tid / P, g = (tid % P) * G;
    // survivor s's place in the lists
    const int f = s < n_surv ? s : 0;
    const int at = f >= p3   ? 3 * SEG + f - p3
                   : f >= p2 ? 2 * SEG + f - p2
                   : f >= p1 ? SEG + f - p1
                             : f;
    int r = 0, slot;
    Rec rec;  // survivor s's record, loaded while it is counted
    if (!wide) {
      const unsigned me = sh.list32[at];
      slot = NT - 1 - (int)(me & (NT - 1));
      rec = load_rec(sh.rec[cur][slot]);
      int r0 = 0, r1 = 0, r2 = 0, r3 = 0;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const uint4* lst =
            reinterpret_cast<const uint4*>(sh.list32 + (g + q) * SEG);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint4 v = lst[k];
          r0 += v.x > me;
          r1 += v.y > me;
          r2 += v.z > me;
          r3 += v.w > me;
        }
      }
      r = (r0 + r1) + (r2 + r3);
    } else {
      slot = NT - 1 - (int)(sh.list32[at] & (NT - 1));
      rec = load_rec(sh.rec[cur][slot]);
      const u64 me = ((u64)rec.code << 32) | (unsigned)(NT - 1 - slot);
      const int ns[NWARP] = {cnt.x, cnt.y, cnt.z, cnt.w};
      for (int q = 0; q < G; ++q)
        r += count_wide(sh.list32 + (g + q) * SEG, ns[g + q], sh.rec[cur],
                        me);
    }
#pragma unroll
    for (int o = 1; o < P; o *= 2) r += __shfl_xor_sync(FULL, r, o);
    if (s < n_surv && tid % P == 0 && r < W) {
      sh.src[r] = slot;
      store_rec(sh.wrec[r], rec);
    }
  }
}

// Starts the copy of chunk k (rows 1 + k*CHUNK ..) of a read into buffer
// k & 1 (cp.async; __pipeline_wait_prior(0) waits for it).
template <int MODEL>
__device__ __forceinline__ void fetch_chunk(Shared& sh, const float* yr,
                                            const float* rr, int T, int S,
                                            int k, int tid) {
  const int cb = 1 + k * CHUNK;
  if (cb >= T) return;
  const int n = min(CHUNK, T - cb);
  const float* src = yr + (long long)cb * S;
  float(*dst)[SMAX] = sh.u.e.y[k & 1];
  for (int x = tid; x < n * S; x += NT)
    __pipeline_memcpy_async(&dst[x / S][x % S], src + x, sizeof(float));
  if (MODEL == 0 && tid < n)
    __pipeline_memcpy_async(&sh.u.e.root[k & 1][tid], rr + cb + tid,
                            sizeof(float));
  __pipeline_commit();
}

// NB_BITS_MIN's 2^8 buckets are for eight CTAs per SM: 64 registers.
template <int MODEL, int BITS>
__global__ void __launch_bounds__(NT, BITS == NB_BITS_MIN ? 8 : 1)
beam1d_kernel(const float* __restrict__ y, const float* __restrict__ root,
              const long long* __restrict__ meta, int W, int A, int S,
              unsigned char* prov, signed char* __restrict__ chars,
              float* __restrict__ st0_out, float* __restrict__ st1_out,
              unsigned char* __restrict__ val_out) {
  __shared__ Shared sh;
  // the two tables' hash tables, in dynamic shared memory (launch())
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  typedef Hash<BITS> H;
  H* hash = reinterpret_cast<H*>(dyn_smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int C = W * (A + 1);
  const long long off = meta[2 * blockIdx.x];
  const int T = (int)meta[2 * blockIdx.x + 1];
  const float* yr = y + off * S;
  const float* rr = root + off;
  unsigned char* pv = prov + off * W;
  signed char* ch_out = chars + off;

  // the winner this thread's slot descends from, and the char it appends
  const bool stay = tid < W;
  const int w = stay ? tid : (tid - W) / A;
  const int c = stay ? -1 : (tid - W) % A;

  // what this thread knows of its own slot in the current table
  unsigned my_code = 0u;  // 0: invalid
  int my_b = -1;          // its bucket; -1 for none or a key equal to EMPTY
  int old_b = -1;         // its bucket in the other table (two steps back)

  // ---- initial table (t = 0): the A root children in the child slots of
  // beam row 0; everything else invalid
  clear_hash(hash[0], tid);
  clear_hash(hash[1], tid);
  if (tid < W) pv[tid] = 0;
  fetch_chunk<MODEL>(sh, yr, rr, T, S, 0, tid);
  __syncthreads();
  {
    const bool child = tid >= W && tid < W + A;
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
    const unsigned cc = (unsigned)(c + 1);
    Rec r;
    r.key = child ? pack_key(cc, cc) : 0ull;
    r.pkey = 0ull;
    r.st0 = s0;
    r.st1 = s1;
    r.chars = pack_chars(child ? c : -1, -1);
    r.code = child ? order_code(MODEL == 0 ? s0 : lse(s0, s1)) : 0u;
    if (tid < C) store_rec(sh.rec[0][tid], r);
    if (child) {  // root children's keys are distinct and not EMPTY
      int b;
      const u64 prev = hash_claim(hash[0], r.key, b);
      my_b = hash_settle(hash[0], r.key, b, prev, tid);
      atomicMax(&hash[0].st[my_b].x, max_code(s0));
      atomicMax(&hash[0].st[my_b].y, max_code(s1));
    }
    my_code = r.code;
    if (tid == 0) {
      sh.tau = 0u;  // the stays are invalid
      sh.wide = 0;
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  int cur = 0;
  CLK_INIT();
  for (int t = 1;; ++t) {
    // ---- dedup and survivors of the current table
    bool kept = false;
    if (my_code != 0u) {
      if (my_b >= 0) {
        kept = hash[cur].first[my_b] == tid;
      } else {  // key EMPTY
        kept = empty_key_first(sh.rec[cur], tid);
      }
    }
    const bool surv = kept && my_code >= sh.tau;
    // its rank word: the score code above the slot (larger wins; equal
    // codes to the lower slot) in 32 bits when the code is less than 2^25
    // above the threshold (the usual case; else the step is "wide" and
    // the ranks compare 64-bit words, the codes read from the records)
    const unsigned d = my_code - sh.tau;
    const unsigned mine32 = surv ? (d << 7) | (unsigned)(NT - 1 - tid) : 0u;
    const unsigned m = __ballot_sync(FULL, surv);
    {
      // survivors first, in lane order; zeros after them, so that a count
      // may read a segment in whole groups of words
      const int n = __popc(m);
      const int pos = warp * SEG + __popc(m & ((1u << lane) - 1u));
      if (surv) sh.list32[pos] = mine32;
      if (lane >= n) sh.list32[warp * SEG + lane] = 0u;
      if (lane == 0) sh.cnt[warp] = n;
      if (surv && d >= (1u << 25)) sh.wide = 1;
    }
    // the other table was last read by the joins that built this one:
    // empty the buckets its slots took (each thread its own slot's), and
    // it is empty again
    if (old_b >= 0) clear_bucket(hash[cur ^ 1], old_b);
    if (tid == 0) hash[cur ^ 1].marker = 0;
    CLK(CK_DEDUP);
    __syncthreads();
    CLK(CK_BARRIER);

    // ---- ranks: each survivor (in list order) is counted by P threads of
    // one warp, each against 4/P segments' words (zeros past a segment's
    // survivors never beat a word; every load is issued at once), then
    // summed over the P; P = 4 when at most 32 survive, else 2
    static_assert(NWARP == 4, "cnt is read as one int4");
    const int4 cnt = *reinterpret_cast<const int4*>(sh.cnt);
    const bool wide = sh.wide != 0;
    const int n_surv = cnt.x + cnt.y + cnt.z + cnt.w;
    if (n_surv <= NT / 4)
      rank_survivors<4>(sh, cur, cnt, n_surv, wide, W, tid);
    else
      rank_survivors<2>(sh, cur, cnt, n_surv, wide, W, tid);
    // ranks no survivor took (fewer than W kept slots)
    if (tid < W && tid >= n_surv) sh.src[tid] = -1;
    CLK(CK_RANK);
    // the chunk the next update starts on has arrived
    if (t > 1 && (t - 1) % CHUNK == 0) __pipeline_wait_prior(0);
    __syncthreads();
    CLK(CK_PUBLISH);
    if (t == T) break;

    // ---- build the next table: one new slot per thread
    const int row = (t - 1) % CHUNK, kc = (t - 1) / CHUNK;
    if (row == 0) fetch_chunk<MODEL>(sh, yr, rr, T, S, kc + 1, tid);
    CLK(CK_REFILL);
    const int nxt = cur ^ 1;
    H& hn = hash[nxt];
    if (tid < W) pv[(long long)t * W + tid] = (unsigned char)(sh.src[tid] + 1);
    if (tid == 0) sh.wide = 0;
    my_code = 0u;
    old_b = my_b;
    my_b = -1;
    // this step's emission row, read before it is needed
    const float4 ya = *reinterpret_cast<const float4*>(&sh.u.e.y[kc & 1][row][0]);
    const float4 yb = *reinterpret_cast<const float4*>(&sh.u.e.y[kc & 1][row][4]);
    const float y_blank = pick8(ya, yb, S - 1);
    const float y_root = MODEL == 0 ? sh.u.e.root[kc & 1][row] : 0.0f;
    if (tid < C) {
      // the winner's record, staged by the ranks (both loads at once)
      const bool ok = sh.src[w] >= 0;
      Rec old = load_rec(sh.wrec[w]);
      if (!ok) {
        old.key = 0ull;
        old.pkey = 0ull;
        old.st0 = -INFINITY;
        old.st1 = -INFINITY;
        old.chars = pack_chars(-1, -1);
      }
      Rec nr;
      u64 q;
      if (stay) {
        nr.key = old.key;
        nr.pkey = old.pkey;
        nr.chars = old.chars;
        q = old.pkey;  // looks up its parent
      } else {
        nr.key = pack_key((unsigned)old.key * M1 + (unsigned)(c + 1),
                          (unsigned)(old.key >> 32) * M2 + (unsigned)(c + 1));
        nr.pkey = old.key;
        nr.chars = pack_chars(c, own_char(old.chars));
        q = nr.key;  // looks up its own state at t-1
      }
      CLK(CK_GATHER);
      float n0 = -INFINITY, n1 = -INFINITY;
      // its key into the new table: claimed here, settled after the update
      const bool ins = ok && nr.key != EMPTY;
      int b = 0;
      u64 prev = EMPTY;
      if (ok) {
        float l0, l1;
        hash_lookup(hash[cur], sh.rec[cur], C, q, l0, l1);
        if (ins) prev = hash_claim(hn, nr.key, b);
        CLK(CK_JOIN);
        float s0, s1, p0, p1;  // own and parent state at t-1
        if (stay) {
          s0 = old.st0;
          s1 = old.st1;
          p0 = l0;
          p1 = l1;
          // a depth-1 node's parent is the root: cumulative blank (ctc)
          if (MODEL == 0 && old.pkey == 0ull) p0 = y_root;
        } else {
          s0 = l0;
          s1 = l1;
          p0 = old.st0;
          p1 = old.st1;
        }
        const int nch = own_char(nr.chars);
        const int ch = nch < 0 ? 0 : nch;
        const bool same = nch == parent_char(nr.chars);
        const float y_c = pick8(ya, yb, ch);
        if (MODEL == 0) {
          n0 = lse(p0 + y_c, s0 + y_blank);
        } else if (MODEL == 1) {
          n0 = lse(s0, s1) + y_blank;
          const float from = same ? p0 : lse(p0, p1);
          n1 = lse(from + y_c, s1 + y_c);
        } else {
          const float y_cf = pick8(ya, yb, ch + A);
          const float emit_flip = (same ? p1 : lse(p0, p1)) + y_c;
          const float emit_flop = same ? p0 + y_cf : -INFINITY;
          n0 = lse(emit_flip, s0 + y_c);
          n1 = lse(emit_flop, s1 + y_cf);
        }
        my_code = order_code(MODEL == 0 ? n0 : lse(n0, n1));
      }
      CLK(CK_UPDATE);
      nr.st0 = n0;
      nr.st1 = n1;
      nr.code = my_code;
      store_rec(sh.rec[nxt][tid], nr);
      if (ins) {
        my_b = hash_settle(hn, nr.key, b, prev, tid);
        atomicMax(&hn.st[my_b].x, max_code(n0));
        atomicMax(&hn.st[my_b].y, max_code(n1));
      } else if (ok) {
        hn.marker = 1;  // a key equal to EMPTY: found by scans
      }
    }
    // the threshold: the lowest stay code, 0 when a stay is invalid
    if (warp == 0) {
      const unsigned tau = __reduce_min_sync(FULL, tid < W ? my_code : FULL);
      if (lane == 0) sh.tau = tau;
    }
    CLK(CK_LINK);
    __syncthreads();
    CLK(CK_BARRIER);
    CLK_ADD(CK_STEPS, 1);
    cur = nxt;
  }
  CLK_FLUSH(threadIdx.x == 0);

  // ---- final table; sh.src[0] is its best slot
  if (tid < C) {
    const Rec f = load_rec(sh.rec[cur][tid]);
    st0_out[blockIdx.x * C + tid] = f.st0;
    st1_out[blockIdx.x * C + tid] = f.st1;
    val_out[blockIdx.x * C + tid] = (unsigned char)(f.code != 0u);
  }
  if (tid == 0) sh.j = sh.src[0];

  // ---- provenance walk, newest step first, CHUNK steps at a time
  for (int hi = T - 1; hi >= 1; hi -= CHUNK) {
    const int lo = max(hi - CHUNK + 1, 1), n = hi - lo + 1;
    __syncthreads();
    for (int k = tid; k < n * W; k += NT)
      sh.u.w.prov[k] = pv[(long long)lo * W + k];
    __syncthreads();
    if (tid == 0) {
      int j = sh.j;
      for (int tt = hi; tt >= lo; --tt) {
        const bool child = j >= W;
        const int ww = child ? (j - W) / A : j;
        int cc = child ? (j - W) % A : -1;
        const int s = j >= 0 ? (int)sh.u.w.prov[(tt - lo) * W + ww] - 1 : -1;
        if (s >= 0) j = s; else cc = -1;
        sh.u.w.chars[tt - lo] = (signed char)cc;
      }
      sh.j = j;
    }
    __syncthreads();
    if (tid < n) ch_out[lo + tid] = sh.u.w.chars[tid];
  }
  __syncthreads();
  // the walk ends in the initial table: a root child at slot W + c
  if (tid == 0) {
    const int j = sh.j;
    ch_out[0] = (signed char)(j >= W ? (j - W) % A : -1);
  }
}

typedef void (*KernelFn)(const float*, const float*, const long long*, int,
                         int, int, unsigned char*, signed char*, float*,
                         float*, unsigned char*);

// The kernel with 2^BITS buckets, its dynamic shared memory allowed (and
// shared memory preferred over L1, as the occupancy it is picked by
// assumes).
template <int MODEL, int BITS>
cudaError_t kernel_of(KernelFn& fn, int& bytes) {
  fn = beam1d_kernel<MODEL, BITS>;
  bytes = 2 * (int)sizeof(Hash<BITS>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int MODEL>
cudaError_t kernel_of(int bits, KernelFn& fn, int& bytes) {
  static_assert(NB_BITS_MAX == 12 && NB_BITS_MIN == 8, "one case per size");
  switch (bits) {
    case 12: return kernel_of<MODEL, 12>(fn, bytes);
    case 11: return kernel_of<MODEL, 11>(fn, bytes);
    case 10: return kernel_of<MODEL, 10>(fn, bytes);
    case 9: return kernel_of<MODEL, 9>(fn, bytes);
    default: return kernel_of<MODEL, 8>(fn, bytes);
  }
}

// The bucket count of a wave of B reads, as its bit count: of the sizes
// whose CTAs fit the fewest rounds of the card's SMs (one round when the
// whole wave is resident at once), the largest.
template <int MODEL>
cudaError_t pick_bits(int B, int& bits) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long best = -1;
  for (int k = NB_BITS_MAX; err == cudaSuccess && k >= NB_BITS_MIN; --k) {
    KernelFn fn;
    int bytes = 0, per_sm = 0;
    err = kernel_of<MODEL>(k, fn, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT,
                                                          bytes);
    if (err != cudaSuccess || per_sm < 1) continue;
    const long long at_once = (long long)per_sm * sms;
    const long long rounds = (B + at_once - 1) / at_once;
    if (best < 0 || rounds < best) {
      best = rounds;
      bits = k;
    }
  }
  if (err == cudaSuccess && best < 0) err = cudaErrorInvalidConfiguration;
  return err;
}

// One CTA per read, the two hash tables in dynamic shared memory.
template <int MODEL, typename... Args>
int launch(int B, cudaStream_t st, Args... args) {
  int bits = NB_BITS_MAX, bytes = 0;
  KernelFn fn;
  cudaError_t err = pick_bits<MODEL>(B, bits);
  if (err == cudaSuccess) err = kernel_of<MODEL>(bits, fn, bytes);
  if (err != cudaSuccess) return (int)err;
  fn<<<B, NT, bytes, st>>>(args...);
  return (int)cudaGetLastError();
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
    if (model == 0) return launch<0>(B, st, y, root, meta, W, A, S, prov,
                                     chars, st0, st1, val);
    if (model == 1) return launch<1>(B, st, y, root, meta, W, A, S, prov,
                                     chars, st0, st1, val);
    return launch<2>(B, st, y, root, meta, W, A, S, prov, chars, st0, st1,
                     val);
  }
  return (int)cudaGetLastError();
}

// The bucket count's bits that a launch of B reads of this model takes
// (pick_bits), or -(a cudaError_t).
int beam1d_hash_bits(int B, int model) {
  if (model < 0 || model > 2) return -(int)cudaErrorInvalidValue;
  int bits = 0;
  const cudaError_t err = model == 0   ? pick_bits<0>(B, bits)
                          : model == 1 ? pick_bits<1>(B, bits)
                                       : pick_bits<2>(B, bits);
  return err == cudaSuccess ? bits : -(int)err;
}

#ifdef POREOVER_PHASE_CLOCKS
// The phase sums (common.cuh: phase_clocks_copy).
int phase_clocks_read(unsigned long long* out, int n, int reset) {
  return poreover::phase_clocks_copy(g_phase_clocks, out, n, reset);
}
#endif

}  // extern "C"
