// G2 clear_rows — reset flagged ring rows of the packed pane plane.
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

}  // namespace

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
