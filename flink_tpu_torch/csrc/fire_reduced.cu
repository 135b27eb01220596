// G4 fire_reduced — evaluate the due windows for every key and reduce each
// fire lane to (emitted keys, value sum) on the device.
//
// Replaces (flink_tpu, the JAX reference): ops/window_kernels.py
// _eval_fire_lanes (:1203) plus the per-lane reduction of
// advance_and_fire_resident with reduced=True (:1507-1520), which equals
// reduce_fires (:1068) over the lane set (kernel K5). The scalar fire plan
// (_fire_plan, _purge_plan) runs before this kernel as small torch ops on
// the device, and hands it the per-lane window-end pane p_f[F] and the
// lane_ok[F] flags without a host round trip.
//
// Semantics: the window ending at pane p combines panes q = p-k+1 .. p; pane
// q lives in ring row q mod R and only counts where pane_ids[row] == q and
// the row's touch column is set (!= 0) for the key. A key is emitted when
// any of its k rows counts; its value is the sum of those rows.
//
// Bound: bytes. A due lane reads its k rows of the packed plane, 8 bytes x
// C each: 8 MB per lane at C = 1M, k = 1, about 2.4 us at 3.35 TB/s. A lane
// that is not due reads nothing.
//
// Design: grid (chunks of C, F). A block whose lane is not ok exits at
// once, the counterpart of the reference's lax.cond(n_now > 0) skipping a
// quiet slot, so a drain slot that crosses no window end costs one launch
// of empty blocks. The k row indices and presence bits are computed once
// per thread from the [R] pane_ids; keys stream as coalesced float2 loads.
// Counts and sums reduce per block and land with one atomic per lane and
// block (float sums therefore add in a run-dependent order: exact for
// integer-valued data).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPanes = 64;  // k <= ring - 1; the wrapper enforces it

__global__ void fire_reduced_kernel(const float2* __restrict__ acc,
                                    const int32_t* __restrict__ pane_ids,
                                    const int32_t* __restrict__ p_f,
                                    const uint8_t* __restrict__ lane_ok,
                                    int C, int R, int k,
                                    int32_t* __restrict__ counts,
                                    float* __restrict__ vsums) {
  const int f = blockIdx.y;
  if (!lane_ok[f]) return;  // uniform per block
  const int32_t p = p_f[f];
  __shared__ int32_t s_row[kMaxPanes];
  if (static_cast<int>(threadIdx.x) < k) {
    const int32_t q = p - (k - 1) + static_cast<int32_t>(threadIdx.x);
    const int32_t row = floor_mod(q, R);
    s_row[threadIdx.x] = pane_ids[row] == q ? row : -1;  // -1: not present
  }
  __syncthreads();

  int32_t emitted = 0;
  float sum = 0.0f;
  const int stride = gridDim.x * blockDim.x;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C; c += stride) {
    float v = 0.0f;
    bool emit = false;
    for (int j = 0; j < k; ++j) {
      const int32_t row = s_row[j];
      if (row < 0) continue;
      const float2 a = acc[static_cast<size_t>(row) * C + c];
      if (a.y != 0.0f) {
        v += a.x;
        emit = true;
      }
    }
    if (emit) {
      ++emitted;
      sum += v;
    }
  }
  emitted = block_sum(emitted);
  sum = block_sum(sum);
  if (threadIdx.x == 0 && emitted) {
    atomicAdd(&counts[f], emitted);
    atomicAdd(&vsums[f], sum);
  }
}

}  // namespace

extern "C" int fire_reduced(const void* acc, const void* pane_ids,
                            const void* p_f, const void* lane_ok, int C, int R,
                            int k, int F, void* counts, void* vsums,
                            void* stream) {
  if (k < 1 || k > kMaxPanes) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = (C + kThreads - 1) / kThreads;
  blocks = blocks < 1024 ? blocks : 1024;
  dim3 grid(blocks, F);
  if (blocks > 0 && F > 0) {
    fire_reduced_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(acc), static_cast<const int32_t*>(pane_ids),
        static_cast<const int32_t*>(p_f), static_cast<const uint8_t*>(lane_ok),
        C, R, k, static_cast<int32_t*>(counts), static_cast<float*>(vsums));
  }
  return static_cast<int>(cudaGetLastError());
}
