// Batched row_col pair-consensus beam search (plain CTC), CUDA for sm_90a.
//
// Replaces the Pallas TPU kernel poreover_tpu/ops/pallas_pair_beam_batch.py
// (_build_kernel / _step_body, launched by _run_kernel). Computes what the
// plan-driven engine poreover_tpu/ops/beam2d_planned.py:_planned_scan
// computes for model "ctc" in float32 -- and what the port's plain PyTorch
// version ops/beam2d_planned.py:planned_scan computes, op for op, so the
// two agree bit for bit on the card.
//
// Design: one persistent CTA per pair walks that pair's own host plan
// (MAIN / C0RUN / C1RUN steps) inside one launch; no per-step host
// launches and no padding of plans to a common length. The search itself
// (candidate table in shared memory, layered chunked sweeps, bit-exactness
// rules) is pair_search.cuh:run_search, shared with box_beam.cu; here each
// candidate's windowed per-read storage and frozen parent copies live in
// per-pair global scratch.
//
// What bounds it: latency, not bytes or FLOPs. A step is a chain of small
// dependent phases separated by __syncthreads; per MAIN step the CTA moves
// ~6 rows-of-Wst copies per read (permute, frozen-parent gather, refresh)
// through L2. Only B CTAs run (one per pair of a wave), so at B=8 the card
// is mostly idle. Later work: warp-level top-k, storage tiles in shared
// memory, copy-on-write storage, more pairs per wave.
//
// Interface (plain C, loaded with ctypes; see ops/pair_beam_batch.py):
// planes: per pair a [A+2, T+1] float32 plane (rows 0..3 emissions, 4 gap,
// 5 the root's value at t-1), flat, at meta offsets; plan int32 [sum N, 5];
// meta int64 [B, 12]; scratch float32 4*C*(Wst0+Wst1) per pair; outputs
// prov int8 [sum N, W], score float32 [B, C], valid uint8 [B, C].

#include "pair_search.cuh"

namespace {

using namespace poreover::pair_search;

__global__ void __launch_bounds__(NT)
pair_beam_kernel(const float* __restrict__ planes1,
                 const float* __restrict__ planes2,
                 const int* __restrict__ plan,
                 const long long* __restrict__ meta, int W,
                 float* __restrict__ scratch, signed char* __restrict__ prov,
                 float* __restrict__ score_out,
                 unsigned char* __restrict__ valid_out) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int C = W * (A + 1);
  const long long* m = meta + (long long)blockIdx.x * META_COLS;
  const Problem pr = load_problem(planes1, planes2, plan, m);
  const int ct = run_search(sh, pr, W, scratch + m[M_SCR],
                            prov + m[M_PLAN] * W);

  // ---- final table, deduplicated
  if (tid < C) {
    const Table& t = sh.tab[ct];
    const int keep = final_keep(t, tid);
    score_out[blockIdx.x * C + tid] = keep ? t.score[tid] : -INFINITY;
    valid_out[blockIdx.x * C + tid] = (unsigned char)keep;
  }
}

}  // namespace

extern "C" {

// Launches one CTA per pair on `stream`; returns cudaGetLastError().
int pair_beam_batch_launch(const float* planes1, const float* planes2,
                           const int* plan, const long long* meta, int B,
                           int W, float* scratch, signed char* prov,
                           float* score, unsigned char* valid,
                           void* stream) {
  if (B > 0)
    pair_beam_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
        planes1, planes2, plan, meta, W, scratch, prov, score, valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
