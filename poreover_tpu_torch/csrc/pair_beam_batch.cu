// Batched row_col pair-consensus beam search, CUDA for sm_90a.
//
// Replaces the Pallas TPU kernel poreover_tpu/ops/pallas_pair_beam_batch.py
// (_build_kernel / _step_body, launched by _run_kernel), which takes plain
// CTC only. Computes what the plan-driven engine
// poreover_tpu/ops/beam2d_planned.py:_planned_scan computes in float32 for
// each of its three model kinds (one template instance per kind; a launch
// holds pairs of one kind) -- and what the port's plain PyTorch version
// ops/beam2d_planned.py:planned_scan computes, op for op, so the two agree
// bit for bit on the card.
//
// Design: one persistent CTA per pair walks that pair's own host plan
// (MAIN / C0RUN / C1RUN steps) inside one launch; no per-step host
// launches and no padding of plans to a common length. The search itself
// (candidate table in registers, both reads swept at once by two warp
// groups, register scans of narrow windows, bit-exactness rules) is
// pair_search.cuh:run_search, shared with box_beam.cu. Each candidate's
// windowed per-read storage and frozen parent copies live in the CTA's
// dynamic shared memory when the launch's largest pair fits
// (SMEM_STORAGE_LIMIT_BYTES; a full-size simulated pair needs ~70 KB),
// else in per-pair global scratch. On the full-size 8-pair wave of
// chip_smoke.py the shared-memory path is ~7% faster (H100 SXM: 704 ms
// against 759 ms), mostly in the storage passes.
//
// Exact mode (pair-decode --exact): a second set of instances, one per
// kind, keeps the graveyard of G = GT evicted candidates
// (pair_search.cuh: run_search<MODEL, G>), the JAX engine's
// _planned_scan with G > 0, which the JAX package runs as an XLA scan (no
// Pallas kernel has it). Its storage adds K*G*(Wst0+Wst1) floats per pair,
// one buffer whose rows stay put (~90 KB for a full-size CTC pair beside
// the candidates' 70 KB). It goes where it fits, by the wave's largest
// pair: all of a pair's storage in shared memory (full-size CTC pairs),
// else the candidates' in shared memory and the graveyard's in global
// scratch (full-size bonito and flip-flop pairs: a burial writes one row
// there and a resume reads one), else all in global scratch.
//
// What bounds it: latency, not bytes or FLOPs. A step is a chain of small
// dependent phases (see pair_search.cuh for what the step does about
// it); per MAIN step each read group moves ~2 rows-of-Wst copies per
// candidate (permute with frozen-parent gather, refresh). Only B CTAs run
// (one per pair of a wave), so at B=8 the card is mostly idle. Later
// work: more pairs per wave.
//
// Interface (plain C, loaded with ctypes; see ops/pair_beam_batch.py):
// planes: per pair a [R, T+1] float32 plane (pair_search.cuh: Problem),
// flat, at meta offsets; plan int32 [sum N, 5]; meta int64 [B, 12];
// model 0 ctc, 1 ctc_merge_repeats, 2 ctc_flipflop; scratch float32
// 4*K*C*(Wst0+Wst1) per pair, K = 1 for ctc and 2 otherwise (exact:
// (4*C + G)*K*(Wst0+Wst1), the graveyard's after the candidates'; the
// part in shared memory unused); outputs prov int8 [sum N, W], score
// float32 [B, C], valid uint8 [B, C].

#include "pair_search.cuh"

namespace {

using namespace poreover::pair_search;

// storage a pair may keep in shared memory: what a CTA may hold beside the
// search's static shared memory (one CTA per pair, so one per SM); the
// same bytes for every kind, so a bonito or flip-flop pair (two state
// components) fits at half a CTC pair's storage width
constexpr int SMEM_STORAGE_LIMIT_BYTES = 216 * 1024;
static_assert(SMEM_STORAGE_LIMIT_BYTES + sizeof(Shared) <= 227 * 1024,
              "a CTA's shared memory");
// graveyard rows of the exact instances, and their storage limit (the
// graveyard's bookkeeping takes static shared memory too)
constexpr int EXACT_G = GT;
constexpr int EXACT_SMEM_STORAGE_LIMIT_BYTES = 208 * 1024;
static_assert(EXACT_SMEM_STORAGE_LIMIT_BYTES + sizeof(Shared) +
                      sizeof(GraveShared<EXACT_G>) <= 227 * 1024,
              "a CTA's shared memory, exact");

// where a launch keeps its storage (exact: the candidates' and the
// graveyard's; windowed: the candidates'), in the order of
// ops/pair_beam_batch.py:STORAGE_PATHS ("shared", "split", "global")
enum Storage { ALL_SHARED = 0, GRAVE_GLOBAL = 1, ALL_GLOBAL = 2 };

#define PAIR_BEAM_PARAMS                                                      \
  const float *__restrict__ planes1, const float *__restrict__ planes2,     \
      const int *__restrict__ plan, const long long *__restrict__ meta,     \
      int W, int where, int grace, float *__restrict__ scratch,             \
      signed char *__restrict__ prov, float *__restrict__ score_out,        \
      unsigned char *__restrict__ valid_out
#define PAIR_BEAM_ARGS                                                    \
  planes1, planes2, plan, meta, W, where, grace, scratch, prov, score_out, \
      valid_out

// One CTA's pair: the search of kind MODEL (G > 0: with the graveyard)
// from its storage path `where`, then its final table.
template <int MODEL, int G>
__device__ __forceinline__ void pair_beam_body(PAIR_BEAM_PARAMS) {
  __shared__ Shared sh;
  __shared__ GraveShared<G> gsh;
  extern __shared__ float smem_store[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = W * (A + 1);
  const long long* m = meta + (long long)blockIdx.x * META_COLS;
  const Problem pr = load_problem(planes1, planes2, plan, m);
  // inlined copies of the search, one per storage path, so that each knows
  // the address space of its storage
  signed char* pv = prov + m[M_PLAN] * W;
  float* const scr = scratch + m[M_SCR];
  Row r;
  if constexpr (G == 0) {
    r = where == ALL_SHARED ? run_search<MODEL>(sh, pr, W, smem_store, pv)
                            : run_search<MODEL>(sh, pr, W, scr, pv);
  } else {
    // the graveyard's storage after the candidates'
    const int gat = 4 * C * Kind<MODEL>::K * (pr.Wst[0] + pr.Wst[1]);
    if (where == ALL_SHARED)
      r = run_search<MODEL, G>(sh, pr, W, smem_store, pv, &gsh, grace,
                               smem_store + gat);
    else if (where == GRAVE_GLOBAL)
      r = run_search<MODEL, G>(sh, pr, W, smem_store, pv, &gsh, grace,
                               scr + gat);
    else
      r = run_search<MODEL, G>(sh, pr, W, scr, pv, &gsh, grace, scr + gat);
  }

  // ---- final table, deduplicated
  if (warp == 0) {
    const bool keep = final_keep(r, lane);
    if (lane < C) {
      score_out[blockIdx.x * C + lane] = keep ? r.score : -INFINITY;
      valid_out[blockIdx.x * C + lane] = (unsigned char)keep;
    }
  }
}

// The windowed instances, at ptxas's own register budget.
template <int MODEL>
__global__ void __launch_bounds__(NT) pair_beam_kernel(PAIR_BEAM_PARAMS) {
  pair_beam_body<MODEL, 0>(PAIR_BEAM_ARGS);
}

// The exact instances: a CTA per pair, one per SM, so a thread may hold up
// to 255 registers; at ptxas's own budget (128) they spill 0.5-1.3 KB.
template <int MODEL>
__global__ void __launch_bounds__(NT, 1)
    pair_beam_exact_kernel(PAIR_BEAM_PARAMS) {
  pair_beam_body<MODEL, EXACT_G>(PAIR_BEAM_ARGS);
}

template <int MODEL, int G>
cudaError_t launch(const float* planes1, const float* planes2,
                   const int* plan, const long long* meta, int B, int W,
                   int grace, int smem_bytes, int where, float* scratch,
                   signed char* prov, float* score, unsigned char* valid,
                   cudaStream_t stream) {
  void (*const kernel)(PAIR_BEAM_PARAMS) =
      G > 0 ? pair_beam_exact_kernel<MODEL> : pair_beam_kernel<MODEL>;
  if (smem_bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, NT, (size_t)smem_bytes, stream>>>(
      planes1, planes2, plan, meta, W, where, grace, scratch, prov, score,
      valid);
  return cudaGetLastError();
}

// The instance of kind `model` (and graveyard G) on `stream`.
template <int G>
int launch_kind(const float* planes1, const float* planes2, const int* plan,
                const long long* meta, int B, int W, int model, int grace,
                int smem_bytes, int where, float* scratch, signed char* prov,
                float* score, unsigned char* valid, cudaStream_t st) {
  switch (model) {
    case 0:
      return (int)launch<0, G>(planes1, planes2, plan, meta, B, W, grace,
                               smem_bytes, where, scratch, prov, score, valid,
                               st);
    case 1:
      return (int)launch<1, G>(planes1, planes2, plan, meta, B, W, grace,
                               smem_bytes, where, scratch, prov, score, valid,
                               st);
    case 2:
      return (int)launch<2, G>(planes1, planes2, plan, meta, B, W, grace,
                               smem_bytes, where, scratch, prov, score, valid,
                               st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int pair_beam_storage_limit() { return SMEM_STORAGE_LIMIT_BYTES; }

// widest window the search sweeps on its narrow (register) path
int pair_beam_narrow_max() { return NARROW_MAX; }

// Launches the instance of kind `model` with one CTA per pair on `stream`.
// With smem_bytes > 0 (the largest pair's storage, at most the limit) each
// CTA keeps its storage in that much dynamic shared memory and scratch is
// not touched; with 0 it lives in scratch. Returns a cudaError_t
// (cudaErrorInvalidValue for an unknown kind or storage over the limit).
int pair_beam_batch_launch(const float* planes1, const float* planes2,
                           const int* plan, const long long* meta, int B,
                           int W, int model, int smem_bytes, float* scratch,
                           signed char* prov, float* score,
                           unsigned char* valid, void* stream) {
  if (B <= 0) return 0;
  if (smem_bytes < 0 || smem_bytes > SMEM_STORAGE_LIMIT_BYTES)
    return (int)cudaErrorInvalidValue;
  return launch_kind<0>(planes1, planes2, plan, meta, B, W, model, 1,
                        smem_bytes, smem_bytes > 0 ? ALL_SHARED : ALL_GLOBAL,
                        scratch, prov, score, valid, (cudaStream_t)stream);
}

int pair_beam_exact_storage_limit() { return EXACT_SMEM_STORAGE_LIMIT_BYTES; }

int pair_beam_graveyard_rows() { return EXACT_G; }

// As pair_beam_batch_launch, for the exact instances: the graveyard of
// EXACT_G rows with eviction at `grace` MAIN steps (1 <= grace <= 1 << 30);
// the storage in path `where` (Storage) with smem_bytes of dynamic shared
// memory, at most EXACT_SMEM_STORAGE_LIMIT_BYTES and 0 exactly when the
// path is ALL_GLOBAL.
int pair_beam_exact_launch(const float* planes1, const float* planes2,
                           const int* plan, const long long* meta, int B,
                           int W, int model, int grace, int smem_bytes,
                           int where, float* scratch, signed char* prov,
                           float* score, unsigned char* valid,
                           void* stream) {
  if (B <= 0) return 0;
  if (where < ALL_SHARED || where > ALL_GLOBAL || smem_bytes < 0 ||
      smem_bytes > EXACT_SMEM_STORAGE_LIMIT_BYTES ||
      (smem_bytes == 0) != (where == ALL_GLOBAL) || grace < 1 ||
      grace > MAX_GRACE)
    return (int)cudaErrorInvalidValue;
  return launch_kind<EXACT_G>(planes1, planes2, plan, meta, B, W, model,
                              grace, smem_bytes, where, scratch, prov, score,
                              valid, (cudaStream_t)stream);
}

}  // extern "C"
