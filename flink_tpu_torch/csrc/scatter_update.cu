// G3 scatter_update — accumulate one micro-batch into the packed pane plane
// of the state backend, one thread per lane.
//
// Replaces (flink_tpu, the JAX reference): the accumulate phase of
// ops/window_kernels.py update (window_kernels.py:735-916) with packed
// planes — the too-old drop against the new max_pane, the changelog bits
// kg_dirty, and the scatter of the value columns and the touch marker at
// the lane's slot, for the builtin reduces sum and count (add), min and
// max (:850-915; ops/segment.py scatter_combine, :150, kernel K3, on float
// state) — and the allowed-lateness `fresh` marking (:936-945): a lane
// that lands in a pane at or before fired_through sets the cell's fresh
// flag and adds one to n_fresh, so the windows holding it re-fire. The
// slot comes in as an operand: in the direct layout where(hi == 0 and
// lo < C, lo, C), in the hash layout what G5 hash_upsert placed or G8
// hash_lookup found. A live lane with slot C has no slot ("nofit"): with
// the overflow ring on, G7 ring_append has already taken it to the ring
// and it is skipped here (count_nofit = 0); without the ring it counts
// into dropped_capacity. On this path it also carries the role of
// ops/segment.py segment_sort / reduce_sorted (kernel K3): the reference
// sorts the batch by accumulator index and pre-combines duplicates because
// duplicate scatter indices serialize on a TPU.
//
// Plane: acc [C*R, W+1] float32, pane-major; columns 0..W-1 hold the
// value (W = 1 for a scalar, 2 for mean's [sum, count]), column W the
// touch marker. Its neutral (the reduce's: 0 for add, +FLT_MAX for min,
// -FLT_MAX for max) means untouched; add scatters 1.0 into it, min and max
// scatter 0.0, which min/max-combines with the neutral to 0.0 and stays.
//
// Bound: bytes. Per lane it reads pane, kg, slot (4 B each), live (1 B)
// and W values (4 B each); each touched cell of the plane is read and
// written once ((W+1) x 4 B each way). A 262,144-lane north-star batch
// moves about 8.6 MB, 2.6 us at 3.35 TB/s. In practice the scattered
// updates land in random 32-byte sectors, so the plane traffic is
// sector-bound, not byte-bound.
//
// Design: no sort. Hopper's L2 atomic units resolve duplicate addresses in
// hardware: add issues fire-and-forget float atomicAdds; min and max loop
// on a 32-bit atomicCAS (common.cuh atomic_combine) with the reference's
// NaN and signed-zero order, and leave at once when the cell already holds
// the result, so a hot key's repeated lanes mostly cost one load. The
// touch marker of min and max is a plain store of 0.0 (every writer stores
// the same word). The resulting plane equals the reference's with
// precombine on and off: exactly for min and max, up to float summation
// order for add, which is exact for integer-valued data. kg_dirty is a
// byte flag, stored only where it still reads 0 (max parallelism is 128,
// so without the read nearly every lane would store to the same few
// bytes); its races are benign, every writer stores 1. fresh flags race
// the same benign way. Dropped lanes and fresh lanes reduce per block and
// land with one atomic each.

#include "common.cuh"

namespace {

__global__ void scatter_update_kernel(
    float* __restrict__ acc, int W, int op, uint8_t* __restrict__ kg_dirty,
    int32_t* __restrict__ dropped_capacity, const int32_t* __restrict__ pane,
    const int32_t* __restrict__ kg, const uint8_t* __restrict__ live,
    const int32_t* __restrict__ slot, const float* __restrict__ values,
    const int32_t* __restrict__ max_pane, int B, int C, int R,
    int count_nofit, uint8_t* __restrict__ fresh,
    const int32_t* __restrict__ fired_through,
    int32_t* __restrict__ n_fresh) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t dropped = 0, marked = 0;
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
        float* cell = acc + flat * (W + 1);
        for (int w = 0; w < W; ++w) {
          atomic_combine(cell + w,
                         values != nullptr
                             ? values[static_cast<size_t>(i) * W + w]
                             : 1.0f,
                         op);
        }
        if (op == 0) {
          atomicAdd(cell + W, 1.0f);  // touch marker
        } else {
          cell[W] = 0.0f;
        }
        if (fresh != nullptr && p <= *fired_through) {
          fresh[flat] = 1;  // a late lane of an already fired window
          marked = 1;
        }
      } else {
        dropped = count_nofit;  // nofit: no slot, and no overflow ring
      }
    }
  }
  dropped = block_sum(dropped);
  if (threadIdx.x == 0 && dropped) atomicAdd(dropped_capacity, dropped);
  if (fresh != nullptr) {  // uniform per launch
    marked = block_sum(marked);
    if (threadIdx.x == 0 && marked) atomicAdd(n_fresh, marked);
  }
}

}  // namespace

extern "C" int scatter_update(void* acc, int W, int op, void* kg_dirty,
                              void* dropped_capacity, const void* pane,
                              const void* kg, const void* live,
                              const void* slot, const void* values,
                              const void* max_pane, int B, int C, int R,
                              int count_nofit, void* fresh,
                              const void* fired_through, void* n_fresh,
                              void* stream) {
  if (W < 1 || op < 0 || op > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  if (blocks > 0) {
    scatter_update_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(acc), W, op, static_cast<uint8_t*>(kg_dirty),
        static_cast<int32_t*>(dropped_capacity),
        static_cast<const int32_t*>(pane), static_cast<const int32_t*>(kg),
        static_cast<const uint8_t*>(live), static_cast<const int32_t*>(slot),
        static_cast<const float*>(values),
        static_cast<const int32_t*>(max_pane), B, C, R, count_nofit,
        static_cast<uint8_t*>(fresh),
        static_cast<const int32_t*>(fired_through),
        static_cast<int32_t*>(n_fresh));
  }
  return static_cast<int>(cudaGetLastError());
}
