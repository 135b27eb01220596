// G6 fire_compact — evaluate the due windows for every slot and compact the
// emitted ones into per-lane (key_hi, key_lo, value) prefixes on the device;
// and fire_pack, the same compaction of a dense fire result computed
// elsewhere.
//
// Replaces (flink_tpu, the JAX reference): the compact branch of
// ops/window_kernels.py advance_and_fire_resident (:1490-1496, kernel K5):
// _eval_fire_lanes (:1203) followed by _pack_fire_lanes (:1079, kernel K11),
// the cumsum + searchsorted stream compaction that compact_fires (:1116)
// also uses — for the builtin reduces on packed planes (sum, count, min,
// max; W >= 1 value columns, kernel K7) and, with a fresh plane, the
// allowed-lateness re-fire lanes of advance_and_fire (:1309-1423, kernel
// K11) that compact_fires packs after it. Lane f's emitted slots land, in
// slot order, in the prefix [0, counts[f]) of its rows, with the slot's key
// identity read from the table (direct layout: the identity rows (0, slot);
// hash layout: the placed keys) and its W value columns. value_sums[f] is
// the lane's sum of every emitted value column. The scalar fire plan runs
// before this kernel as device torch ops and hands it p_f[F] and
// lane_ok[F]; a lane that is not due costs three launches of blocks that
// exit at once. fire_pack takes the emitted mask [F, C] and values
// [F, C, W] of a generic reduce's fire, whose combine is the user's torch
// function and runs as torch ops before it (ops/window_kernels.py).
//
// Semantics of a slot: fire_eval.cuh, as in G4 fire_reduced.
//
// Bound: bytes. A due lane reads its present rows of the packed plane once
// (4 (W+1) B x C each: 84 MB for k = 5, W = 1 at C = 2^21, about 25 us at
// 3.35 TB/s), the key word of each emitted slot (8 B) and writes
// 8 + 4 W B per emitted row. This first version reads the rows twice
// (count, then write), so it moves about twice the bound.
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
// nothing is zeroed, and only [0, counts[f]) is meaningful. fire_pack
// without output rows (a device-reduce sink) runs passes 1 and 2 only.

#include "fire_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;   // ops/cuda.py COMPACT_CHUNK

template <class Src>
__global__ void compact_count_kernel(Src src,
                                     const uint8_t* __restrict__ lane_ok,
                                     int32_t* __restrict__ blk_count,
                                     float* __restrict__ blk_sum) {
  constexpr int kW = Src::kWidth;
  const int f = blockIdx.y;
  if (!lane_ok[f]) return;  // uniform per block
  __shared__ int32_t s_row[kMaxPanes];
  src.prepare(f, s_row);
  const int nw = src.W();
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, src.C);
  int32_t n = 0;
  float sum = 0.0f;
  for (int c = start + threadIdx.x; c < end; c += blockDim.x) {
    float v[kW ? kW : kMaxW];
    if (src.eval(f, s_row, c, v)) {
      ++n;
#pragma unroll
      for (int w = 0; w < (kW ? kW : kMaxW); ++w) {
        if (w < nw) sum += v[w];
      }
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

template <class Src>
__global__ void compact_write_kernel(
    Src src, const uint8_t* __restrict__ lane_ok,
    const unsigned long long* __restrict__ table,
    const int32_t* __restrict__ blk_off, uint32_t* __restrict__ key_hi,
    uint32_t* __restrict__ key_lo, float* __restrict__ values) {
  constexpr int kW = Src::kWidth;
  const int f = blockIdx.y;
  if (!lane_ok[f]) return;  // uniform per block
  __shared__ int32_t s_row[kMaxPanes];
  src.prepare(f, s_row);
  const int nw = src.W();
  const int C = src.C;
  const int start = blockIdx.x * kChunk;
  const int end = min(start + kChunk, C);
  int32_t out = blk_off[f * gridDim.x + blockIdx.x];
  const size_t lane_base = static_cast<size_t>(f) * C;
  for (int c0 = start; c0 < end; c0 += blockDim.x) {  // uniform trip count
    const int c = c0 + threadIdx.x;
    float v[kW ? kW : kMaxW];
    const bool emit = c < end && src.eval(f, s_row, c, v);
    int32_t tile_total;
    const int32_t pos = block_exclusive_scan(emit ? 1 : 0, &tile_total);
    if (emit) {
      const unsigned long long w = table[c];
      const size_t o = lane_base + static_cast<size_t>(out + pos);
      key_hi[o] = static_cast<uint32_t>(w >> 32);
      key_lo[o] = static_cast<uint32_t>(w);
#pragma unroll
      for (int j = 0; j < (kW ? kW : kMaxW); ++j) {
        if (j < nw) values[o * nw + j] = v[j];
      }
    }
    out += tile_total;
  }
}

struct Scratch {
  int32_t* blk_count;
  int32_t* blk_off;
  float* blk_sum;
  int32_t* counts;
  float* vsums;
};

template <class Src>
void launch(const Src& src, const uint8_t* lane_ok, int F,
            const unsigned long long* table, uint32_t* key_hi,
            uint32_t* key_lo, float* values, Scratch sc, cudaStream_t s) {
  const int n_blk = (src.C + kChunk - 1) / kChunk;
  const dim3 grid(n_blk, F);
  compact_count_kernel<Src><<<grid, kThreads, 0, s>>>(
      src, lane_ok, sc.blk_count, sc.blk_sum);
  compact_scan_kernel<<<F, 1024, 0, s>>>(lane_ok, n_blk, sc.blk_count,
                                         sc.blk_sum, sc.blk_off, sc.counts,
                                         sc.vsums);
  if (key_hi != nullptr) {
    compact_write_kernel<Src><<<grid, kThreads, 0, s>>>(
        src, lane_ok, table, sc.blk_off, key_hi, key_lo, values);
  }
}

struct Launch {
  const uint8_t* lane_ok;
  int F;
  const unsigned long long* table;
  uint32_t* key_hi;
  uint32_t* key_lo;
  float* values;
  Scratch sc;
  cudaStream_t s;

  template <class Src>
  void operator()(const Src& src) const {
    launch(src, lane_ok, F, table, key_hi, key_lo, values, sc, s);
  }
};

}  // namespace

extern "C" int fire_compact(const void* acc, int W, int op, float neutral,
                            const void* fresh, int n_ontime,
                            const void* pane_ids, const void* p_f,
                            const void* lane_ok, const void* table, int C,
                            int R, int k, int F, void* blk_count,
                            void* blk_off, void* blk_sum, void* key_hi,
                            void* key_lo, void* values, void* counts,
                            void* vsums, void* stream) {
  if (k < 1 || k > kMaxPanes || W < 1 || W > kMaxW || op < 0 || op > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  const PlaneArgs args{static_cast<const float*>(acc),
                       static_cast<const uint8_t*>(fresh),
                       static_cast<const int32_t*>(pane_ids),
                       static_cast<const int32_t*>(p_f), n_ontime, W, neutral,
                       C, R, k};
  const Scratch sc{static_cast<int32_t*>(blk_count),
                   static_cast<int32_t*>(blk_off),
                   static_cast<float*>(blk_sum), static_cast<int32_t*>(counts),
                   static_cast<float*>(vsums)};
  with_plane(args, op,
             Launch{static_cast<const uint8_t*>(lane_ok), F,
                    static_cast<const unsigned long long*>(table),
                    static_cast<uint32_t*>(key_hi),
                    static_cast<uint32_t*>(key_lo),
                    static_cast<float*>(values), sc,
                    static_cast<cudaStream_t>(stream)});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fire_pack(const void* mask, const void* values_in, int W,
                         const void* lane_ok, const void* table, int C, int F,
                         void* blk_count, void* blk_off, void* blk_sum,
                         void* key_hi, void* key_lo, void* values,
                         void* counts, void* vsums, void* stream) {
  if (W < 1 || W > kMaxW) return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 0 || F <= 0) return static_cast<int>(cudaGetLastError());
  const Scratch sc{static_cast<int32_t*>(blk_count),
                   static_cast<int32_t*>(blk_off),
                   static_cast<float*>(blk_sum), static_cast<int32_t*>(counts),
                   static_cast<float*>(vsums)};
  launch(DenseSrc{static_cast<const uint8_t*>(mask),
                     static_cast<const float*>(values_in), W, C},
            static_cast<const uint8_t*>(lane_ok), F,
            static_cast<const unsigned long long*>(table),
            static_cast<uint32_t*>(key_hi), static_cast<uint32_t*>(key_lo),
            static_cast<float*>(values), sc, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
