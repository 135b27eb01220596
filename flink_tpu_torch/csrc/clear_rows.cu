// G2 clear_rows — reset flagged ring rows of the packed pane plane, or of
// the split planes (a sketch's int32 registers, a generic reduce's float32
// values) beside their touched plane, and the allowed-lateness fresh rows;
// and fresh_rows, which counts each ring row's fresh flags.
//
// Replaces (flink_tpu, the JAX reference): the ring-reset sweep of
// ops/window_kernels.py update (window_kernels.py:715-730, which folds the
// deferred purge rows `clear_rows` in and, with allowed lateness, clears
// the fresh rows), the eviction count before it (:697-713), and
// _clear_rows_planes / apply_pending_purge (:1278-1306, kernel K6); and
// the per-row any() of advance_and_fire's late pass (:1350-1351) with the
// n_fresh sum after it (:1390), as fresh_rows.
//
// Layout: acc is the packed plane [R*C, Wc] float32, pane-major: ring row r
// holds keys 0..C-1 at acc[(r*C + c) * Wc], the value columns then the
// touch column (Wc = 2 for a scalar, 3 for mean's [sum, count]). A row is
// cleared by writing the reduce's neutral into every column (0 for sum and
// count, +FLT_MAX for min, -FLT_MAX for max); an evicted row first counts
// its touched keys (touch column != neutral) into dropped_capacity. The
// fresh plane [R*C] bytes clears on its own row mask (the fire clears the
// fresh rows whose re-fires are done, not the rows it purges).
//
// Bound: bytes. The reference sweeps the whole [R, C, Wc] plane on every
// batch, because a jnp.where cannot skip rows. This kernel reads the [R]
// masks and touches only the flagged rows: 4 x Wc bytes x C written per
// flagged row (plus the touch column read for an evicted row), 8 MB a row
// at C = 1M, Wc = 2, about 2.4 us at 3.35 TB/s, plus C bytes per fresh
// row. A batch that registers no new pane flags no row and costs one
// launch whose blocks exit at once.
//
// Design: grid (chunks of C, R); a block whose row is flagged in neither
// mask returns before touching memory. Each thread clears one key's
// cell: one float2 store when Wc = 2 (consecutive threads on consecutive
// keys), else Wc float stores. The eviction count reduces per block and
// lands with one atomic.
//
// Split planes (clear_rows_split): acc is [R*C, W] 32-bit words, pane-
// major, and touched a separate [R*C] byte plane. A flagged row fills its
// C*W words with the neutral pattern (P words, repeated: 1 word for a
// sketch's 0 or a scalar neutral, W for a vector neutral) and clears its
// C touched bytes; an evicted row first counts its touched bytes (each
// thread reads the bytes it then clears, so the count sees the row before
// the clear). Bound: bytes, C*W*4 + C written per flagged row: 268 MB for
// one ring row of the nexmark q16 distinct-count stage (C = 2^14 slots, W
// = 4,096 registers), about 80 us at 3.35 TB/s. Blocks stride over the row
// in 16-byte stores when the pattern is one word and C*W is a multiple of
// 4, else in 4-byte stores.
//
// fresh_rows: grid (chunks of C, R), each block counts its share of one
// row's set bytes, 16 a load, and adds it to counts[r] with one atomic.
// Bound: bytes, R*C read: 16.8 MB at C = 2^21, R = 8, about 5 us at
// 3.35 TB/s.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKeysPerThread = 8;

__global__ void clear_rows_kernel(float* __restrict__ acc, int Wc,
                                  float neutral,
                                  const uint8_t* __restrict__ clear,
                                  const uint8_t* __restrict__ evicted,
                                  int32_t* __restrict__ dropped_capacity,
                                  int C, uint8_t* __restrict__ fresh,
                                  const uint8_t* __restrict__ fresh_clear) {
  const int r = blockIdx.y;
  const bool rows = clear[r] != 0;
  const bool frows = fresh != nullptr && fresh_clear[r] != 0;
  if (!rows && !frows) return;  // uniform per block
  const bool count = rows && evicted != nullptr && evicted[r] != 0;
  const size_t row0 = static_cast<size_t>(r) * C;
  const int start = blockIdx.x * kThreads * kKeysPerThread + threadIdx.x;
  int32_t touched = 0;
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int c = start + j * kThreads;
    if (c >= C) continue;
    if (rows) {
      if (Wc == 2) {
        float2* cell = reinterpret_cast<float2*>(acc) + row0 + c;
        if (count && cell->y != neutral) ++touched;
        *cell = make_float2(neutral, neutral);
      } else {
        float* cell = acc + (row0 + c) * Wc;
        if (count && cell[Wc - 1] != neutral) ++touched;
        for (int w = 0; w < Wc; ++w) cell[w] = neutral;
      }
    }
    if (frows) fresh[row0 + c] = 0;
  }
  if (count) {  // uniform per block
    touched = block_sum(touched);
    if (threadIdx.x == 0 && touched) atomicAdd(dropped_capacity, touched);
  }
}

constexpr int kSplitBlocks = 1024;  // blocks per flagged row, grid-stride

__global__ void clear_rows_split_kernel(
    uint32_t* __restrict__ acc, uint8_t* __restrict__ touched,
    const uint32_t* __restrict__ pat, int P,
    const uint8_t* __restrict__ clear, const uint8_t* __restrict__ evicted,
    int32_t* __restrict__ dropped_capacity, int C, int W,
    uint8_t* __restrict__ fresh, const uint8_t* __restrict__ fresh_clear) {
  const int r = blockIdx.y;
  const bool rows = clear[r] != 0;
  const bool frows = fresh != nullptr && fresh_clear[r] != 0;
  if (!rows && !frows) return;  // uniform per block
  const bool count = rows && evicted != nullptr && evicted[r] != 0;
  const size_t n = static_cast<size_t>(C) * W;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t first =
      static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (rows) {
    uint32_t* row = acc + static_cast<size_t>(r) * n;
    if (P == 1 && n % 4 == 0) {
      const uint32_t x = pat[0];
      uint4* row4 = reinterpret_cast<uint4*>(row);
      for (size_t i = first; i < n / 4; i += stride) {
        row4[i] = make_uint4(x, x, x, x);
      }
    } else {
      for (size_t i = first; i < n; i += stride) row[i] = pat[i % P];
    }
  }
  uint8_t* trow = touched + static_cast<size_t>(r) * C;
  uint8_t* frow =
      fresh != nullptr ? fresh + static_cast<size_t>(r) * C : nullptr;
  int32_t n_touched = 0;
  for (size_t c = first; c < static_cast<size_t>(C); c += stride) {
    if (rows) {
      if (count && trow[c]) ++n_touched;
      trow[c] = 0;
    }
    if (frows) frow[c] = 0;
  }
  if (count) {  // uniform per block
    n_touched = block_sum(n_touched);
    if (threadIdx.x == 0 && n_touched) atomicAdd(dropped_capacity, n_touched);
  }
}

__global__ void fresh_rows_kernel(const uint8_t* __restrict__ fresh, int C,
                                  int32_t* __restrict__ counts) {
  const int r = blockIdx.y;
  const uint8_t* row = fresh + static_cast<size_t>(r) * C;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  int32_t n = 0;
  if (C % 16 == 0) {
    // 16 flags a load; a bool byte is 0 or 1, so a word's popcount is its
    // number of set flags (the row starts 16-byte aligned: the plane is a
    // torch allocation and C a multiple of 16)
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int i = first; i < C / 16; i += stride) {
      const uint4 x = row4[i];
      n += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
    }
  } else {
    for (int c = first; c < C; c += stride) n += row[c] != 0;
  }
  n = block_sum(n);
  if (threadIdx.x == 0 && n) atomicAdd(&counts[r], n);
}

}  // namespace

extern "C" int clear_rows_split(void* acc, void* touched, const void* pat,
                                int P, const void* clear, const void* evicted,
                                void* dropped_capacity, int C, int R, int W,
                                void* fresh, const void* fresh_clear,
                                void* stream) {
  if (P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n4 = (static_cast<size_t>(C) * W + 3) / 4;
  size_t blocks = (n4 + kThreads - 1) / kThreads;
  blocks = blocks < kSplitBlocks ? blocks : kSplitBlocks;
  dim3 grid(static_cast<unsigned>(blocks), R);
  if (grid.x > 0 && R > 0) {
    clear_rows_split_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(acc), static_cast<uint8_t*>(touched),
        static_cast<const uint32_t*>(pat), P,
        static_cast<const uint8_t*>(clear),
        static_cast<const uint8_t*>(evicted),
        static_cast<int32_t*>(dropped_capacity), C, W,
        static_cast<uint8_t*>(fresh),
        static_cast<const uint8_t*>(fresh_clear));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int clear_rows(void* acc, int Wc, float neutral, const void* clear,
                          const void* evicted, void* dropped_capacity, int C,
                          int R, void* fresh, const void* fresh_clear,
                          void* stream) {
  if (Wc < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kThreads * kKeysPerThread;
  dim3 grid((C + per_block - 1) / per_block, R);
  if (grid.x > 0 && R > 0) {
    clear_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(acc), Wc, neutral,
        static_cast<const uint8_t*>(clear),
        static_cast<const uint8_t*>(evicted),
        static_cast<int32_t*>(dropped_capacity), C,
        static_cast<uint8_t*>(fresh),
        static_cast<const uint8_t*>(fresh_clear));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fresh_rows(const void* fresh, int C, int R, void* counts,
                          void* stream) {
  const int per_thread = C % 16 == 0 ? 16 : 1;
  int blocks = (C / per_thread + kThreads - 1) / kThreads;
  blocks = blocks < 256 ? blocks : 256;
  dim3 grid(blocks, R);
  if (blocks > 0 && R > 0) {
    fresh_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(fresh), C, static_cast<int32_t*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}
