// G2 clear_rows — reset flagged ring rows of the packed pane plane, or of
// the split register and touched planes of a sketch stage.
//
// Replaces (flink_tpu, the JAX reference): the ring-reset sweep of
// ops/window_kernels.py update (window_kernels.py:715-729, which folds the
// deferred purge rows `clear_rows` in), the eviction count before it
// (:697-713), and _clear_rows_planes / apply_pending_purge (:1278-1306,
// kernel K6).
//
// Layout: acc is the packed plane [R*C, 2] float32, pane-major: ring row r
// holds keys 0..C-1 at acc[r*C + c] = (value, touch column). A row is
// cleared by writing the neutral 0 into both columns; an evicted row first
// counts its touched keys (touch column != 0) into dropped_capacity.
//
// Bound: bytes. The reference sweeps the whole [R, C, 2] plane on every
// batch, because a jnp.where cannot skip rows. This kernel reads the [R]
// mask and touches only the flagged rows: 8 bytes x C written per flagged
// row (plus 8 x C read for an evicted row), 8 MB a row at C = 1M, about
// 2.4 us at 3.35 TB/s. A batch that registers no new pane flags no row and
// costs one launch whose blocks exit at once.
//
// Design: grid (chunks of C, R); a block whose row is not flagged returns
// before touching memory. Each thread moves one float2 (8 bytes) per key,
// consecutive threads on consecutive keys. The eviction count reduces per
// block and lands with one atomic.
//
// Split planes (clear_rows_split, the sketch stages): acc is [R*C, W] int32
// registers, pane-major, and touched a separate [R*C] byte plane. A flagged
// row clears its C*W registers to the sketch neutral 0 and its C touched
// bytes; an evicted row first counts its touched bytes (each thread reads
// the bytes it then clears, so the count sees the row before the clear).
// Bound: bytes, C*W*4 + C written per flagged row: 268 MB for one ring row
// of the nexmark q16 distinct-count stage (C = 2^14 slots, W = 4,096
// registers), about 80 us at 3.35 TB/s. Blocks stride over the row in
// 16-byte stores (4-byte stores when C*W is not a multiple of 4, which
// would misalign the rows).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKeysPerThread = 8;

__global__ void clear_rows_kernel(float2* __restrict__ acc,
                                  const uint8_t* __restrict__ clear,
                                  const uint8_t* __restrict__ evicted,
                                  int32_t* __restrict__ dropped_capacity,
                                  int C) {
  const int r = blockIdx.y;
  if (!clear[r]) return;  // uniform per block
  const bool count = evicted != nullptr && evicted[r] != 0;
  float2* row = acc + static_cast<size_t>(r) * C;
  const int start = blockIdx.x * kThreads * kKeysPerThread + threadIdx.x;
  int32_t touched = 0;
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int c = start + j * kThreads;
    if (c < C) {
      if (count && row[c].y != 0.0f) ++touched;
      row[c] = make_float2(0.0f, 0.0f);
    }
  }
  if (count) {
    touched = block_sum(touched);
    if (threadIdx.x == 0 && touched) atomicAdd(dropped_capacity, touched);
  }
}

constexpr int kSplitBlocks = 1024;  // blocks per flagged row, grid-stride

__global__ void clear_rows_split_kernel(int32_t* __restrict__ acc,
                                        uint8_t* __restrict__ touched,
                                        const uint8_t* __restrict__ clear,
                                        const uint8_t* __restrict__ evicted,
                                        int32_t* __restrict__ dropped_capacity,
                                        int C, int W) {
  const int r = blockIdx.y;
  if (!clear[r]) return;  // uniform per block
  const bool count = evicted != nullptr && evicted[r] != 0;
  const size_t n = static_cast<size_t>(C) * W;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int32_t* row = acc + static_cast<size_t>(r) * n;
  if (n % 4 == 0) {
    int4* row4 = reinterpret_cast<int4*>(row);
    for (size_t i = first; i < n / 4; i += stride) row4[i] = make_int4(0, 0, 0, 0);
  } else {
    for (size_t i = first; i < n; i += stride) row[i] = 0;
  }
  uint8_t* trow = touched + static_cast<size_t>(r) * C;
  int32_t n_touched = 0;
  for (size_t c = first; c < static_cast<size_t>(C); c += stride) {
    if (count && trow[c]) ++n_touched;
    trow[c] = 0;
  }
  if (count) {
    n_touched = block_sum(n_touched);
    if (threadIdx.x == 0 && n_touched) atomicAdd(dropped_capacity, n_touched);
  }
}

}  // namespace

extern "C" int clear_rows_split(void* acc, void* touched, const void* clear,
                                const void* evicted, void* dropped_capacity,
                                int C, int R, int W, void* stream) {
  const size_t n4 = (static_cast<size_t>(C) * W + 3) / 4;
  size_t blocks = (n4 + kThreads - 1) / kThreads;
  blocks = blocks < kSplitBlocks ? blocks : kSplitBlocks;
  dim3 grid(static_cast<unsigned>(blocks), R);
  if (grid.x > 0 && R > 0) {
    clear_rows_split_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(acc), static_cast<uint8_t*>(touched),
        static_cast<const uint8_t*>(clear),
        static_cast<const uint8_t*>(evicted),
        static_cast<int32_t*>(dropped_capacity), C, W);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int clear_rows(void* acc, const void* clear, const void* evicted,
                          void* dropped_capacity, int C, int R,
                          void* stream) {
  const int per_block = kThreads * kKeysPerThread;
  dim3 grid((C + per_block - 1) / per_block, R);
  if (grid.x > 0 && R > 0) {
    clear_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float2*>(acc), static_cast<const uint8_t*>(clear),
        static_cast<const uint8_t*>(evicted),
        static_cast<int32_t*>(dropped_capacity), C);
  }
  return static_cast<int>(cudaGetLastError());
}
