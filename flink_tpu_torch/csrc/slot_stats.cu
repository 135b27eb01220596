// G18 slot_stats — one live drain slot's flight-recorder row.
//
// Replaces (flink_tpu, the JAX reference): runtime/step.py
// _slot_drain_stats (kernel K15) and its call in
// build_window_resident_drain: the nine int32 fields of
// metrics/drain_stats.py DRAIN_STAT_FIELDS for one live slot, written
// after the slot's update and fire:
//   events          the slot's valid lanes (G1's fourth stats scalar)
//   activity        the update's activity
//   fire_lanes      the slot's valid fire lanes
//   fired_keys      the keys its fire lanes emitted
//   late_dropped    dropped_late after the fire less before the update
//   nofit_dropped   dropped_capacity after the fire less before the update
//   ovf_fill        the overflow ring's fill after the fire
//   kg_fill_max     the max bin of the slot's key-group fill (0 when off)
//   panes_advanced  max(0, floor(wm / slide) - floor(wb / slide)), with
//                   wb = max(wm_before, wm - 2^20), and 0 while
//                   wm_before < -2^30 (the MIN sentinel of a fresh job)
// ``slot_stats_begin`` (one thread, launched before the slot's update)
// saves wm_before, dropped_late and dropped_capacity into the slot's
// 3-int snapshot; ``slot_stats`` (one block, launched after its fire)
// writes the row. With ``defer`` (the reference's defer_fires, the chained
// drain's stage 0) it writes 0 into fire_lanes and fired_keys, which
// ``fire_columns`` fills after the slot loop.
//
// G22, two more instances of the same recorder:
//   fire_columns  (runtime/step.py _deferred_fire_columns, K15): columns 2
//                 and 3 (fire_lanes, fired_keys) of a drain's [D, 9]
//                 recorder stack from its stacked [D, F] fire lane_valid
//                 and counts, one warp a slot; a skipped slot's zero
//                 fires give 0;
//   stage_record  (the STAGE_STAT_FIELDS row of _chained_stage_tail,
//                 step.py:1962-1993, K14): one downstream stage's six
//                 fields for one drain: edge_demand, edge_events =
//                 min(demand, E), its fire lanes, the edge's dropped
//                 lanes, wm_lag_panes = max(wm_up - wm_j, 0) / slide and
//                 panes_advanced with G18's sentinel clamps.
// Both are launch-bound like G18: a few hundred bytes each.
//
// Bound: launches. The row reads a few hundred bytes (4 scalars, the snap,
// Ft lanes' valid flags and counts, maxp fill bins) and writes 36: about
// 0.1 us of memory traffic against 2-4 us a launch costs; drain-stats on
// adds these two launches to each slot's ~50.
//
// Design: one block of 256 threads. The fill's max and the fire lanes'
// sums reduce with warp shuffles and shared memory (common.cuh); thread 0
// does the scalar arithmetic. The pane count is computed in int64 so the
// jump clamp cannot overflow, and divides with floor semantics for
// negative watermarks (common.cuh floor_div); where the reference's int32
// wm - 2^20 would wrap, wm_before is below -2^30 and the row reads 0
// either way.

#include "common.cuh"

namespace {

constexpr int kFields = 9;

__global__ void slot_stats_begin_kernel(const int32_t* __restrict__ wm,
                                        const int32_t* __restrict__ late,
                                        const int32_t* __restrict__ cap,
                                        int32_t* __restrict__ snap) {
  snap[0] = *wm;
  snap[1] = *late;
  snap[2] = *cap;
}

__device__ __forceinline__ long long floor_div64(long long a, long long b) {
  long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Panes a watermark advance crossed, as the recorder counts them.
__device__ __forceinline__ int32_t panes_advanced(long long w_before,
                                                  long long w_after,
                                                  int slide) {
  const long long wb = max(w_before, w_after - (1LL << 20));
  long long panes = floor_div64(w_after, slide) - floor_div64(wb, slide);
  if (panes < 0 || w_before < -(1LL << 30)) panes = 0;
  return static_cast<int32_t>(panes);
}

__global__ void slot_stats_kernel(
    const int32_t* __restrict__ g1_stats, const int32_t* __restrict__ act,
    const uint8_t* __restrict__ lane_valid,
    const int32_t* __restrict__ counts, int Ft,
    const int32_t* __restrict__ late, const int32_t* __restrict__ cap,
    const int32_t* __restrict__ ovf_n, const int32_t* __restrict__ fill,
    int maxp, const int32_t* __restrict__ wm,
    const int32_t* __restrict__ snap, int slide, int defer,
    int32_t* __restrict__ row) {
  int32_t lanes = 0, keys = 0, fmax = 0;
  for (int f = threadIdx.x; f < Ft && !defer; f += blockDim.x) {
    if (lane_valid[f]) lanes += 1;
    keys += counts[f];
  }
  if (fill != nullptr) {
    for (int b = threadIdx.x; b < maxp; b += blockDim.x)
      fmax = max(fmax, fill[b]);
  }
  __shared__ int32_t s_lanes[32], s_keys[32], s_max[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  lanes = warp_sum(lanes);
  keys = warp_sum(keys);
  fmax = warp_max(fmax);
  if (lane == 0) {
    s_lanes[warp] = lanes;
    s_keys[warp] = keys;
    s_max[warp] = fmax;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int n_warps = blockDim.x >> 5;
  lanes = 0;
  keys = 0;
  fmax = 0;
  for (int w = 0; w < n_warps; ++w) {
    lanes += s_lanes[w];
    keys += s_keys[w];
    fmax = max(fmax, s_max[w]);
  }
  row[0] = g1_stats[3];
  row[1] = *act;
  row[2] = lanes;
  row[3] = keys;
  row[4] = *late - snap[1];
  row[5] = *cap - snap[2];
  row[6] = *ovf_n;
  row[7] = fmax;
  row[8] = panes_advanced(snap[0], *wm, slide);
}

__global__ void fire_columns_kernel(int32_t* __restrict__ ds, int D, int N,
                                    const uint8_t* __restrict__ lane_valid,
                                    const int32_t* __restrict__ counts,
                                    int F) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int d = threadIdx.x >> 5; d < D; d += n_warps) {
    int32_t lanes = 0, keys = 0;
    for (int f = lane; f < F; f += 32) {
      if (lane_valid[d * F + f]) lanes += 1;
      keys += counts[d * F + f];
    }
    lanes = warp_sum(lanes);
    keys = warp_sum(keys);
    if (lane == 0) {
      ds[d * N + 2] = lanes;
      ds[d * N + 3] = keys;
    }
  }
}

__global__ void stage_record_kernel(
    const int32_t* __restrict__ demand, int E,
    const uint8_t* __restrict__ lane_valid, int F,
    const int32_t* __restrict__ dropped, const int32_t* __restrict__ wm_up,
    const int32_t* __restrict__ wm_j, const int32_t* __restrict__ wm_before,
    const int32_t* __restrict__ wm_after, int slide,
    int32_t* __restrict__ row) {
  int32_t lanes = 0;
  for (int f = threadIdx.x; f < F; f += 32) {
    if (lane_valid[f]) lanes += 1;
  }
  lanes = warp_sum(lanes);
  if (threadIdx.x != 0) return;
  const int32_t dem = *demand;
  const long long lag = static_cast<long long>(*wm_up) - *wm_j;
  row[0] = dem;
  row[1] = min(dem, E);
  row[2] = lanes;
  row[3] = *dropped;
  row[4] = static_cast<int32_t>(lag > 0 ? lag / slide : 0);
  row[5] = panes_advanced(*wm_before, *wm_after, slide);
}

}  // namespace

extern "C" int slot_stats_begin(const void* wm, const void* late,
                                const void* cap, void* snap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  slot_stats_begin_kernel<<<1, 1, 0, s>>>(
      static_cast<const int32_t*>(wm), static_cast<const int32_t*>(late),
      static_cast<const int32_t*>(cap), static_cast<int32_t*>(snap));
  return static_cast<int>(cudaGetLastError());
}

// ``fill`` null: kg-fill off, kg_fill_max reads 0.
extern "C" int slot_stats(const void* g1_stats, const void* act,
                          const void* lane_valid, const void* counts, int Ft,
                          const void* late, const void* cap,
                          const void* ovf_n, const void* fill, int maxp,
                          const void* wm, const void* snap, int slide,
                          int defer, void* row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  slot_stats_kernel<<<1, 256, 0, s>>>(
      static_cast<const int32_t*>(g1_stats), static_cast<const int32_t*>(act),
      static_cast<const uint8_t*>(lane_valid),
      static_cast<const int32_t*>(counts), Ft,
      static_cast<const int32_t*>(late), static_cast<const int32_t*>(cap),
      static_cast<const int32_t*>(ovf_n), static_cast<const int32_t*>(fill),
      maxp, static_cast<const int32_t*>(wm),
      static_cast<const int32_t*>(snap), slide, defer,
      static_cast<int32_t*>(row));
  return static_cast<int>(cudaGetLastError());
}

// ``ds`` int32 [D, N], in place; ``lane_valid`` bool and ``counts`` int32
// [D, F].
extern "C" int fire_columns(void* ds, int D, int N, const void* lane_valid,
                            const void* counts, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fire_columns_kernel<<<1, 256, 0, s>>>(
      static_cast<int32_t*>(ds), D, N,
      static_cast<const uint8_t*>(lane_valid),
      static_cast<const int32_t*>(counts), F);
  return static_cast<int>(cudaGetLastError());
}

// Every scalar is an int32 0-d tensor; ``lane_valid`` bool [F]; ``row``
// int32 [6].
extern "C" int stage_record(const void* demand, int E, const void* lane_valid,
                            int F, const void* dropped, const void* wm_up,
                            const void* wm_j, const void* wm_before,
                            const void* wm_after, int slide, void* row,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stage_record_kernel<<<1, 32, 0, s>>>(
      static_cast<const int32_t*>(demand), E,
      static_cast<const uint8_t*>(lane_valid), F,
      static_cast<const int32_t*>(dropped), static_cast<const int32_t*>(wm_up),
      static_cast<const int32_t*>(wm_j),
      static_cast<const int32_t*>(wm_before),
      static_cast<const int32_t*>(wm_after), slide,
      static_cast<int32_t*>(row));
  return static_cast<int>(cudaGetLastError());
}
