// G6 fire_compact — evaluate the due windows for every slot and compact the
// emitted ones into per-lane (key_hi, key_lo, value) prefixes on the device.
//
// Replaces (flink_tpu, the JAX reference): the compact branch of
// ops/window_kernels.py advance_and_fire_resident (:1490-1496, kernel K5):
// _eval_fire_lanes (:1203) followed by _pack_fire_lanes (:1079, kernel K11),
// the cumsum + searchsorted stream compaction that compact_fires (:1116)
// also uses. Lane f's emitted slots land, in slot order, in the prefix
// [0, counts[f]) of its rows, with the slot's key identity read from the
// table (direct layout: the identity rows (0, slot); hash layout: the
// placed keys) and the value summed over the window's panes. value_sums[f]
// is the lane's sum of emitted values. The scalar fire plan runs before
// this kernel as device torch ops and hands it p_f[F] and lane_ok[F]; a
// lane that is not due costs three launches of blocks that exit at once.
//
// Semantics of a slot, as in G4 fire_reduced: pane q of the window ending
// at pane p (q = p-k+1 .. p) lives in ring row q mod R and counts where
// pane_ids[row] == q and the row's touch column is set; the slot is emitted
// when any of its k panes counts, and its value adds those panes in order.
//
// Bound: bytes. A due lane reads its present rows of the packed plane once
// (8 B x C each: 84 MB for k = 5 at C = 2^21, about 25 us at 3.35 TB/s),
// the key word of each emitted slot (8 B) and writes 12 B per emitted row.
// This first version reads the rows twice (count, then write), so it moves
// about twice the bound.
//
// Design: a two-pass block scan, stable in slot order. Blocks own
// contiguous chunks of kChunk slots. (1) count: each block counts its
// emitted slots and sums their values into per-block scratch. (2) scan: one
// block per lane turns the per-block counts into exclusive offsets and
// writes counts[f] and value_sums[f] (the per-block sums added in block
// order, so the result does not depend on scheduling). (3) write: each
// block walks its chunk in tiles of blockDim slots (coalesced plane loads),
// ranks the emitted slots of a tile with a block scan, and writes them at
// its offset. The output rows are one arena per job, owned by the caller;
// nothing is zeroed, and only [0, counts[f]) is meaningful.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;   // ops/cuda.py COMPACT_CHUNK
constexpr int kMaxPanes = 64;  // k <= ring - 1

// rows[j] = ring row of pane j of the window ending at p, -1 if absent
__device__ __forceinline__ void window_rows(const int32_t* pane_ids, int32_t p,
                                            int R, int k, int32_t* rows) {
  if (static_cast<int>(threadIdx.x) < k) {
    const int32_t q = p - (k - 1) + static_cast<int32_t>(threadIdx.x);
    const int32_t row = floor_mod(q, R);
    rows[threadIdx.x] = pane_ids[row] == q ? row : -1;
  }
  __syncthreads();
}

__device__ __forceinline__ bool eval_slot(const float2* __restrict__ acc,
                                          const int32_t* rows, int k, int C,
                                          int c, float* v_out) {
  float v = 0.0f;
  bool emit = false;
  for (int j = 0; j < k; ++j) {
    const int32_t row = rows[j];
    if (row < 0) continue;
    const float2 a = acc[static_cast<size_t>(row) * C + c];
    if (a.y != 0.0f) {
      v += a.x;
      emit = true;
    }
  }
  *v_out = v;
  return emit;
}

__global__ void compact_count_kernel(const float2* __restrict__ acc,
                                     const int32_t* __restrict__ pane_ids,
                                     const int32_t* __restrict__ p_f,
                                     const uint8_t* __restrict__ lane_ok,
                                     int C, int R, int k,
                                     int32_t* __restrict__ blk_count,
                                     float* __restrict__ blk_sum) {
  const int f = blockIdx.y;
  if (!lane_ok[f]) return;  // uniform per block
  __shared__ int32_t s_row[kMaxPanes];
  window_rows(pane_ids, p_f[f], R, k, s_row);
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, C);
  int32_t n = 0;
  float sum = 0.0f;
  for (int c = start + threadIdx.x; c < end; c += blockDim.x) {
    float v;
    if (eval_slot(acc, s_row, k, C, c, &v)) {
      ++n;
      sum += v;
    }
  }
  n = block_sum(n);
  sum = block_sum(sum);
  if (threadIdx.x == 0) {
    blk_count[f * gridDim.x + blockIdx.x] = n;
    blk_sum[f * gridDim.x + blockIdx.x] = sum;
  }
}

__global__ void compact_scan_kernel(const uint8_t* __restrict__ lane_ok,
                                    int n_blk,
                                    const int32_t* __restrict__ blk_count,
                                    const float* __restrict__ blk_sum,
                                    int32_t* __restrict__ blk_off,
                                    int32_t* __restrict__ counts,
                                    float* __restrict__ vsums) {
  const int f = blockIdx.x;
  if (!lane_ok[f]) {
    if (threadIdx.x == 0) {
      counts[f] = 0;
      vsums[f] = 0.0f;
    }
    return;
  }
  int32_t carry = 0;
  float sum = 0.0f;
  for (int b0 = 0; b0 < n_blk; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const int32_t v = b < n_blk ? blk_count[f * n_blk + b] : 0;
    int32_t tile_total;
    const int32_t ex = block_exclusive_scan(v, &tile_total);
    if (b < n_blk) {
      blk_off[f * n_blk + b] = carry + ex;
      sum += blk_sum[f * n_blk + b];
    }
    carry += tile_total;
  }
  sum = block_sum(sum);
  if (threadIdx.x == 0) {
    counts[f] = carry;
    vsums[f] = sum;
  }
}

__global__ void compact_write_kernel(
    const float2* __restrict__ acc, const int32_t* __restrict__ pane_ids,
    const int32_t* __restrict__ p_f, const uint8_t* __restrict__ lane_ok,
    const unsigned long long* __restrict__ table, int C, int R, int k,
    const int32_t* __restrict__ blk_off, uint32_t* __restrict__ key_hi,
    uint32_t* __restrict__ key_lo, float* __restrict__ values) {
  const int f = blockIdx.y;
  if (!lane_ok[f]) return;  // uniform per block
  __shared__ int32_t s_row[kMaxPanes];
  window_rows(pane_ids, p_f[f], R, k, s_row);
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, C);
  int32_t out = blk_off[f * gridDim.x + blockIdx.x];
  const size_t lane_base = static_cast<size_t>(f) * C;
  for (int c0 = start; c0 < end; c0 += blockDim.x) {  // uniform trip count
    const int c = c0 + threadIdx.x;
    float v = 0.0f;
    const bool emit = c < end && eval_slot(acc, s_row, k, C, c, &v);
    int32_t tile_total;
    const int32_t pos = block_exclusive_scan(emit ? 1 : 0, &tile_total);
    if (emit) {
      const unsigned long long w = table[c];
      const size_t o = lane_base + static_cast<size_t>(out + pos);
      key_hi[o] = static_cast<uint32_t>(w >> 32);
      key_lo[o] = static_cast<uint32_t>(w);
      values[o] = v;
    }
    out += tile_total;
  }
}

}  // namespace

extern "C" int fire_compact(const void* acc, const void* pane_ids,
                            const void* p_f, const void* lane_ok,
                            const void* table, int C, int R, int k, int F,
                            void* blk_count, void* blk_off, void* blk_sum,
                            void* key_hi, void* key_lo, void* values,
                            void* counts, void* vsums, void* stream) {
  if (k < 1 || k > kMaxPanes) return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blk = (C + kChunk - 1) / kChunk;
  const dim3 grid(n_blk, F);
  compact_count_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float2*>(acc), static_cast<const int32_t*>(pane_ids),
      static_cast<const int32_t*>(p_f), static_cast<const uint8_t*>(lane_ok),
      C, R, k, static_cast<int32_t*>(blk_count), static_cast<float*>(blk_sum));
  compact_scan_kernel<<<F, 1024, 0, s>>>(
      static_cast<const uint8_t*>(lane_ok), n_blk,
      static_cast<const int32_t*>(blk_count),
      static_cast<const float*>(blk_sum), static_cast<int32_t*>(blk_off),
      static_cast<int32_t*>(counts), static_cast<float*>(vsums));
  compact_write_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float2*>(acc), static_cast<const int32_t*>(pane_ids),
      static_cast<const int32_t*>(p_f), static_cast<const uint8_t*>(lane_ok),
      static_cast<const unsigned long long*>(table), C, R, k,
      static_cast<const int32_t*>(blk_off), static_cast<uint32_t*>(key_hi),
      static_cast<uint32_t*>(key_lo), static_cast<float*>(values));
  return static_cast<int>(cudaGetLastError());
}
