// G3 scatter_update — accumulate one micro-batch into the packed pane plane
// of the state backend, one thread per lane.
//
// Replaces (flink_tpu, the JAX reference): the accumulate phase of
// ops/window_kernels.py update (window_kernels.py:735-916) with packed
// planes — the too-old drop against the new max_pane, the changelog bits
// kg_dirty, and the scatter of the value and the touch marker at the
// lane's slot. The slot comes in as an operand: in the direct layout
// where(hi == 0 and lo < C, lo, C), in the hash layout what G5
// hash_upsert placed or G8 hash_lookup found. A live lane with slot C has
// no slot ("nofit"): with the overflow ring on, G7 ring_append has already
// taken it to the ring and it is skipped here (count_nofit = 0); without
// the ring it counts into dropped_capacity. On this path it also carries
// the role of
// ops/segment.py segment_sort / reduce_sorted / scatter_combine (kernel
// K3): the reference sorts the batch by accumulator index and pre-combines
// duplicates because duplicate scatter indices serialize on a TPU.
//
// Bound: bytes. Per lane it reads pane, kg, slot (4 B each), live (1 B)
// and the value (4 B): 17 B; each touched (value, marker) cell of the plane
// is read and written once: 16 B. A 262,144-lane north-star batch moves
// about 8.6 MB, 2.6 us at 3.35 TB/s. In practice the scattered 8-byte
// updates land in random 32-byte sectors, so the plane traffic is
// sector-bound, not byte-bound.
//
// Design: no sort. Hopper's L2 atomic units resolve duplicate addresses in
// hardware, so each live lane issues two fire-and-forget float atomicAdds
// (value, touch marker 1.0). The resulting plane equals the reference's
// with precombine on and off up to float summation order, which is exact
// for integer-valued data. kg_dirty is a byte flag, stored only where it
// still reads 0 (max parallelism is 128, so without the read nearly every
// lane would store to the same few bytes); its races are benign, every
// writer stores 1. Dropped lanes reduce per block and land with one
// atomic.

#include "common.cuh"

namespace {

__global__ void scatter_update_kernel(
    float* __restrict__ acc, uint8_t* __restrict__ kg_dirty,
    int32_t* __restrict__ dropped_capacity, const int32_t* __restrict__ pane,
    const int32_t* __restrict__ kg, const uint8_t* __restrict__ live,
    const int32_t* __restrict__ slot, const float* __restrict__ values,
    const int32_t* __restrict__ max_pane,
    int B, int C, int R, int count_nofit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t dropped = 0;
  if (i < B && live[i]) {
    const int32_t p = pane[i];
    const int32_t oldest = *max_pane - (R - 1);  // ring horizon (:736)
    if (p < oldest) {
      dropped = 1;  // too old
    } else {
      // a set-only flag: read first, so the lanes of a key group after
      // its first do not all store to the same byte
      if (kg_dirty != nullptr && kg_dirty[kg[i]] == 0) kg_dirty[kg[i]] = 1;
      const uint32_t s = static_cast<uint32_t>(slot[i]);
      if (s < static_cast<uint32_t>(C)) {
        const size_t flat =
            static_cast<size_t>(floor_mod(p, R)) * C + s;  // pane-major
        atomicAdd(acc + 2 * flat, values != nullptr ? values[i] : 1.0f);
        atomicAdd(acc + 2 * flat + 1, 1.0f);  // touch marker
      } else {
        dropped = count_nofit;  // nofit: no slot, and no overflow ring
      }
    }
  }
  dropped = block_sum(dropped);
  if (threadIdx.x == 0 && dropped) atomicAdd(dropped_capacity, dropped);
}

}  // namespace

extern "C" int scatter_update(void* acc, void* kg_dirty,
                              void* dropped_capacity, const void* pane,
                              const void* kg, const void* live,
                              const void* slot, const void* values,
                              const void* max_pane, int B, int C, int R,
                              int count_nofit, void* stream) {
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  if (blocks > 0) {
    scatter_update_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(acc), static_cast<uint8_t*>(kg_dirty),
        static_cast<int32_t*>(dropped_capacity),
        static_cast<const int32_t*>(pane), static_cast<const int32_t*>(kg),
        static_cast<const uint8_t*>(live), static_cast<const int32_t*>(slot),
        static_cast<const float*>(values),
        static_cast<const int32_t*>(max_pane), B, C, R, count_nofit);
  }
  return static_cast<int>(cudaGetLastError());
}
