// Segmented box-batch pair-consensus beam search, CUDA for sm_90a: many
// small anchor boxes of one model kind per launch (one template instance
// per kind: ctc, ctc_merge_repeats, ctc_flipflop), several back to back in
// each CTA.
//
// Replaces the Pallas TPU kernel poreover_tpu/ops/pallas_box_beam.py
// (_build_kernel / _step_body, launched by _run_kernel). It computes, per
// box, what pair_beam_batch.cu computes per pair (the same search,
// pair_search.cuh:run_search, bit-equal to the plain PyTorch version
// ops/beam2d_planned.py:planned_scan), plus the final pick: the best valid
// candidate of the final deduplicated table, ties to the lowest slot, so
// no score table comes back (the TPU kernel's zero-width "FIN" step).
//
// Design. A lane of the TPU kernel is a persistent CTA here. The boxes of a
// launch stand in a queue (the wrapper sorts them by descending plan
// length); a CTA takes the next box with one atomic add, runs it from the
// t = 0 state (run_search rewrites every piece of state it reads: the
// reset between boxes), writes its provenance and final pick at the box's
// own offsets, and takes the next. A box's result does not depend on which
// CTA ran it or on what ran before. Each candidate's windowed storage and
// frozen parent copies, 16*K*C*(Wst0+Wst1) bytes per box (K state
// components: 1 for ctc, 2 for the other kinds), live in dynamic
// shared memory beside the search's 7.6 KB of static shared memory: that
// is the static storage budget (STORAGE_LIMIT_BYTES, sized so that at
// least two CTAs share an SM; __launch_bounds__ keeps the registers of
// two). Boxes over it are not launched; the wrapper (ops/box_beam.py) hands
// them to the pair kernel. The grid is the number of CTAs the card holds at
// once at this launch's shared-memory size, or the number of boxes.
//
// What bounds it: latency, as for the pair kernel (a step is a chain of
// small dependent phases); with hundreds of boxes per
// launch every SM has work, which the pair kernel's one CTA per pair never
// gives. The largest box of a launch sets every CTA's shared-memory size
// and so the CTAs per SM (2 to 4); splitting a launch by box size is later
// work.
//
// Interface (plain C, loaded with ctypes; see ops/box_beam.py): planes,
// plan, meta and model as for pair_beam_batch.cu (meta's scratch column
// unused); queue int32 [1], zero on entry; outputs prov int8 [sum N, W] and
// pick int32 [nbox].

#include "pair_search.cuh"

namespace {

using namespace poreover::pair_search;

// storage a box may need (dynamic shared memory beside the static
// Shared, 7.6 KB, the same in every kind's instance): the most at which two
// CTAs, each with 1 KB the system reserves, still share an SM's 228 KB
constexpr int STORAGE_LIMIT_BYTES = 105 * 1024;
static_assert(2 * (STORAGE_LIMIT_BYTES + sizeof(Shared) + 16 + 1024) <=
                  228 * 1024,
              "two CTAs per SM at the storage limit");

template <int MODEL>
__global__ void __launch_bounds__(NT, 2)
box_beam_kernel(const float* __restrict__ planes1,
                const float* __restrict__ planes2,
                const int* __restrict__ plan,
                const long long* __restrict__ meta, int nbox, int W,
                int* __restrict__ queue, signed char* __restrict__ prov,
                int* __restrict__ pick) {
  __shared__ Shared sh;
  __shared__ int next_box;
  extern __shared__ float store[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = W * (A + 1);

  for (;;) {
    if (tid == 0) next_box = atomicAdd(queue, 1);
    __syncthreads();
    const int box = next_box;
    if (box >= nbox) break;
    const long long* m = meta + (long long)box * META_COLS;
    const Problem pr = load_problem(planes1, planes2, plan, m);
    const Row r = run_search<MODEL>(sh, pr, W, store, prov + m[M_PLAN] * W);

    // ---- final pick: arg-max of the deduplicated table, lowest slot
    if (warp == 0) {
      const bool in = lane < C;
      const bool keep = final_keep(r, lane);
      float bs = (in && keep) ? r.score : -INFINITY;
      int bi = in ? lane : (1 << 20);
      warp_argmax_lowest(bs, bi);
      if (lane == 0) pick[box] = bi;
    }
    __syncthreads();
  }
}

template <int MODEL>
cudaError_t launch(const float* planes1, const float* planes2,
                   const int* plan, const long long* meta, int nbox, int W,
                   int smem_bytes, int max_ctas, int* queue,
                   signed char* prov, int* pick, int* grid_out,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      box_beam_kernel<MODEL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      STORAGE_LIMIT_BYTES);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, box_beam_kernel<MODEL>, NT, (size_t)smem_bytes)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int grid = min(nbox, sms * per_sm);
  if (max_ctas > 0) grid = min(grid, max_ctas);
  box_beam_kernel<MODEL><<<grid, NT, (size_t)smem_bytes, stream>>>(
      planes1, planes2, plan, meta, nbox, W, queue, prov, pick);
  *grid_out = grid;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int box_beam_storage_limit() { return STORAGE_LIMIT_BYTES; }

// Launches the instance of kind `model` on `stream` with `smem_bytes` of
// storage per CTA (the largest box's need) and at most `max_ctas` CTAs (0:
// as many as the card holds at once); writes the grid it used to
// *grid_out. Returns a cudaError_t (cudaErrorInvalidValue for an unknown
// kind or storage over the limit).
int box_beam_launch(const float* planes1, const float* planes2,
                    const int* plan, const long long* meta, int nbox, int W,
                    int model, int smem_bytes, int max_ctas, int* queue,
                    signed char* prov, int* pick, int* grid_out,
                    void* stream) {
  *grid_out = 0;
  if (nbox <= 0) return 0;
  if (smem_bytes < 0 || smem_bytes > STORAGE_LIMIT_BYTES)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (model) {
    case 0:
      return (int)launch<0>(planes1, planes2, plan, meta, nbox, W,
                            smem_bytes, max_ctas, queue, prov, pick,
                            grid_out, st);
    case 1:
      return (int)launch<1>(planes1, planes2, plan, meta, nbox, W,
                            smem_bytes, max_ctas, queue, prov, pick,
                            grid_out, st);
    case 2:
      return (int)launch<2>(planes1, planes2, plan, meta, nbox, W,
                            smem_bytes, max_ctas, queue, prov, pick,
                            grid_out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
