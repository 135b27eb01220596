// G4 fire_reduced — evaluate the due windows for every key and reduce each
// fire lane to (emitted keys, value sum) on the device.
//
// Replaces (flink_tpu, the JAX reference): ops/window_kernels.py
// _eval_fire_lanes (:1203) plus the per-lane reduction of
// advance_and_fire_resident with reduced=True (:1507-1520), which equals
// reduce_fires (:1068) over the lane set (kernel K5), for the builtin
// reduces on packed planes: sum and count (add), min and max, with W >= 1
// value columns (kernel K7: mean's [sum, count] is W = 2); and, with a
// fresh plane, the allowed-lateness re-fire lanes of advance_and_fire
// (:1309-1423, kernel K11), lanes f >= n_ontime, which emit the slots
// whose fresh flag is set (fire_eval.cuh). The scalar fire plan (_fire_plan,
// _purge_plan, the late lanes' selection) runs before this kernel as small
// torch ops on the device, and hands it the per-lane window-end pane
// p_f[F] and the lane_ok[F] flags without a host round trip.
//
// Semantics (fire_eval.cuh PlaneSrc): a key is emitted when any of its k
// rows counts (on-time lanes) or is fresh (re-fire lanes); its value
// combines the touched rows from the neutral. A lane's value sum adds
// every value column of every emitted key, as reduce_fires does.
//
// Bound: bytes. A due lane reads its k rows of the packed plane, 4 (W+1)
// bytes x C each (plus C fresh bytes each for a re-fire lane): 8 MB per
// lane at C = 1M, k = 1, W = 1, about 2.4 us at 3.35 TB/s. A lane that is
// not due reads nothing.
//
// Design: grid (chunks of C, F). A block whose lane is not ok exits at
// once, the counterpart of the reference's lax.cond(n_now > 0) skipping a
// quiet slot, so a drain slot that crosses no window end costs one launch
// of empty blocks. The k row indices and presence bits are computed once
// per block from the [R] pane_ids; keys stream as coalesced loads (one
// float2 a cell for a scalar). Counts and sums reduce per block and land
// with one atomic per lane and block (float sums therefore add in a
// run-dependent order: exact for integer-valued data).

#include "fire_eval.cuh"

namespace {

constexpr int kThreads = 256;

template <class Src>
__global__ void fire_reduced_kernel(Src src,
                                    const uint8_t* __restrict__ lane_ok,
                                    int32_t* __restrict__ counts,
                                    float* __restrict__ vsums) {
  constexpr int kW = Src::kWidth;
  const int f = blockIdx.y;
  if (!lane_ok[f]) return;  // uniform per block
  __shared__ int32_t s_row[kMaxPanes];
  src.prepare(f, s_row);
  const int nw = src.W();
  int32_t emitted = 0;
  float sum = 0.0f;
  const int stride = gridDim.x * blockDim.x;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < src.C; c += stride) {
    float v[kW ? kW : kMaxW];
    if (src.eval(f, s_row, c, v)) {
      ++emitted;
#pragma unroll
      for (int w = 0; w < (kW ? kW : kMaxW); ++w) {
        if (w < nw) sum += v[w];
      }
    }
  }
  emitted = block_sum(emitted);
  sum = block_sum(sum);
  if (threadIdx.x == 0 && emitted) {
    atomicAdd(&counts[f], emitted);
    atomicAdd(&vsums[f], sum);
  }
}

struct Launch {
  const uint8_t* lane_ok;
  int32_t* counts;
  float* vsums;
  int blocks, F;
  cudaStream_t s;

  template <class Src>
  void operator()(const Src& src) const {
    fire_reduced_kernel<Src><<<dim3(blocks, F), kThreads, 0, s>>>(
        src, lane_ok, counts, vsums);
  }
};

}  // namespace

extern "C" int fire_reduced(const void* acc, int W, int op, float neutral,
                            const void* fresh, int n_ontime,
                            const void* pane_ids, const void* p_f,
                            const void* lane_ok, int C, int R, int k, int F,
                            void* counts, void* vsums, void* stream) {
  if (k < 1 || k > kMaxPanes || W < 1 || W > kMaxW || op < 0 || op > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = (C + kThreads - 1) / kThreads;
  blocks = blocks < 1024 ? blocks : 1024;
  if (blocks <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  const PlaneArgs args{static_cast<const float*>(acc),
                       static_cast<const uint8_t*>(fresh),
                       static_cast<const int32_t*>(pane_ids),
                       static_cast<const int32_t*>(p_f), n_ontime, W, neutral,
                       C, R, k};
  with_plane(args, op,
             Launch{static_cast<const uint8_t*>(lane_ok),
                    static_cast<int32_t*>(counts), static_cast<float*>(vsums),
                    blocks, F, static_cast<cudaStream_t>(stream)});
  return static_cast<int>(cudaGetLastError());
}
