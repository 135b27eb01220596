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
// Design: one launch a call, its grid sized to the card (at most
// kBlocksPerSM blocks an SM, fewer when a row is small). Every warp
// reads the [R] row masks, a lane a row, and ballots them: no barrier
// holds a warp's stores back, and the flagged rows are the ballots' set
// bits. Every flagged row is spread over the whole grid, a 16-byte chunk
// a thread per step (grid stride), rows in turn. A row of the packed
// plane is one contiguous run of C*Wc words, all the neutral, so it
// fills with 16-byte stores whatever Wc is; a row that does not start
// 16-byte aligned (Wc = 3 with C not a multiple of 4) clears its
// unaligned head and tail words one at a time.
// An evicted row loads each chunk before it stores it and counts the touch
// words in it (word i of the row with i % Wc == Wc - 1, != neutral), so
// the count sees the row as it was; the chunk is the same 32-byte sectors
// a read of the touch column alone would fetch. The byte planes (the
// fresh flags; the split planes' touched flags) clear 16 bytes a store,
// and an evicted row's touched flags count with __popc over the loaded
// words (a bool byte is 0 or 1). Each thread sums its count over every
// row, and each warp adds its sum to dropped_capacity with one atomic.
//
// Split planes (clear_rows_split): acc is [R*C, W] 32-bit words, pane-
// major, and touched a separate [R*C] byte plane. A flagged row fills its
// C*W words with the neutral pattern (P words, repeated: 1 word for a
// sketch's 0 or a scalar neutral, W for a vector neutral: word i of the
// row takes pat[i % P]) and clears its C touched bytes; an evicted row
// first counts its touched bytes. Bound: bytes, C*W*4 + C written per
// flagged row: 268 MB for one ring row of the nexmark q16 distinct-count
// stage (C = 2^14 slots, W = 4,096 registers), about 80 us at 3.35 TB/s.
//
// fresh_rows: grid (chunks of C, R), each block counts its share of one
// row's set bytes, 16 a load, and adds it to counts[r] with one atomic.
// Bound: bytes, R*C read: 16.8 MB at C = 2^21, R = 8, about 5 us at
// 3.35 TB/s.

#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;
constexpr int kChunksPerThread = 4;  // a row's chunks a thread takes, at most

struct ClearArgs {
  uint32_t* acc;               // [R, n] words: packed cells or split values
  size_t n;                    // words a row: C * Wc (packed), C * W (split)
  const uint32_t* pat;         // the neutral words, P of them, repeated;
                               // null for one word given as `word`
  uint32_t word;
  int P;
  int touch_every;             // packed: Wc (count the words i % Wc ==
                               // Wc - 1 that differ from the neutral);
                               // split: 0 (count the touched bytes)
  float neutral;
  uint8_t* touched;            // split: [R, C] flags, cleared with the row
  uint8_t* fresh;              // [R, C] or null: cleared on fresh_clear
  const uint8_t* clear;
  const uint8_t* evicted;      // or null
  const uint8_t* fresh_clear;  // or null (no fresh plane)
  int32_t* dropped_capacity;
  int C, R;
};

__device__ __forceinline__ int32_t popc4(uint4 x) {
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}

// The chunk of words [i, i + 4) of a packed row: its touch words that
// differ from the neutral.
__device__ __forceinline__ int32_t touch_count(uint4 x, size_t i, int every,
                                               float neutral) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  int32_t n = 0;
  int k = static_cast<int>(i % every);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    n += k == every - 1 && __uint_as_float(w[j]) != neutral;
    k = k + 1 == every ? 0 : k + 1;
  }
  return n;
}

// Fill `n` words at `row` with the pattern (word i takes pat[i % P]),
// counting the touch words first when `count`.
__device__ __forceinline__ int32_t fill_words(const ClearArgs& a,
                                              uint32_t* row, bool count,
                                              size_t gtid, size_t stride) {
  const size_t n = a.n;
  const uint32_t x0 = a.pat != nullptr ? a.pat[0] : a.word;
  if (a.P == 1 && !(count && a.touch_every) &&
      (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    // the common case: one pattern word, nothing counted, an aligned row
    uint4* row4 = reinterpret_cast<uint4*>(row);
    const uint4 x4 = make_uint4(x0, x0, x0, x0);
    const size_t body = n / 4;
    for (size_t k = gtid; k < body; k += stride) row4[k] = x4;
    if (gtid < n - body * 4) row[body * 4 + gtid] = x0;
    return 0;
  }
  size_t head = (4 - (reinterpret_cast<uintptr_t>(row) >> 2) % 4) % 4;
  head = head < n ? head : n;
  const size_t body = (n - head) / 4;
  const size_t tail0 = head + body * 4;
  int32_t c = 0;
  auto word = [&](size_t i) { return a.P == 1 ? x0 : a.pat[i % a.P]; };
  auto one = [&](size_t i) {
    if (count && a.touch_every && i % a.touch_every == a.touch_every - 1 &&
        __uint_as_float(row[i]) != a.neutral) {
      ++c;
    }
    row[i] = word(i);
  };
  if (gtid < head) one(gtid);
  if (gtid < n - tail0) one(tail0 + gtid);
  uint4* row4 = reinterpret_cast<uint4*>(row + head);
  for (size_t k = gtid; k < body; k += stride) {
    const size_t i = head + 4 * k;
    if (count && a.touch_every) {
      c += touch_count(row4[k], i, a.touch_every, a.neutral);
    }
    row4[k] = a.P == 1 ? make_uint4(x0, x0, x0, x0)
                       : make_uint4(word(i), word(i + 1), word(i + 2),
                                    word(i + 3));
  }
  return c;
}

// Zero `n` bytes at `row`, counting the set ones first when `count`.
__device__ __forceinline__ int32_t zero_bytes(uint8_t* row, size_t n,
                                              bool count, size_t gtid,
                                              size_t stride) {
  size_t head = (16 - reinterpret_cast<uintptr_t>(row) % 16) % 16;
  head = head < n ? head : n;
  const size_t body = (n - head) / 16;
  const size_t tail0 = head + body * 16;
  int32_t c = 0;
  if (gtid < head) {
    c += count && row[gtid];
    row[gtid] = 0;
  }
  if (gtid < n - tail0) {
    c += count && row[tail0 + gtid];
    row[tail0 + gtid] = 0;
  }
  uint4* row16 = reinterpret_cast<uint4*>(row + head);
  for (size_t k = gtid; k < body; k += stride) {
    if (count) c += popc4(row16[k]);
    row16[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  return c;
}

__global__ void __launch_bounds__(kThreads) clear_kernel(ClearArgs a) {
  const size_t gtid = static_cast<size_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const int lane = threadIdx.x & 31;
  int32_t touched = 0;
  bool any_count = false;  // the same in every thread of the grid
  for (int r0 = 0; r0 < a.R; r0 += 32) {
    // 32 rows' masks a warp, a lane a row, then the warp's ballots (no
    // barrier: a warp starts its stores as soon as its own loads return)
    const int r = r0 + lane;
    const bool in = r < a.R;
    const unsigned cl = __ballot_sync(0xffffffffu, in && __ldg(a.clear + r));
    const unsigned ev = __ballot_sync(
        0xffffffffu, in && a.evicted != nullptr && __ldg(a.evicted + r));
    const unsigned fr = __ballot_sync(
        0xffffffffu,
        in && a.fresh_clear != nullptr && __ldg(a.fresh_clear + r));
    for (unsigned left = cl | fr; left != 0; left &= left - 1) {
      const int i = __ffs(left) - 1;
      const size_t base = static_cast<size_t>(r0 + i);
      if ((cl >> i) & 1u) {
        const bool count = (ev >> i) & 1u;
        any_count |= count;
        touched += fill_words(a, a.acc + base * a.n, count, gtid, stride);
        if (a.touched != nullptr) {
          touched += zero_bytes(a.touched + base * a.C, a.C,
                                count && !a.touch_every, gtid, stride);
        }
      }
      if ((fr >> i) & 1u) {
        zero_bytes(a.fresh + base * a.C, a.C, false, gtid, stride);
      }
    }
  }
  if (any_count) {  // uniform: a warp's sum, one atomic a warp
    touched = __reduce_add_sync(0xffffffffu, touched);
    if ((threadIdx.x & 31) == 0 && touched) {
      atomicAdd(a.dropped_capacity, touched);
    }
  }
}

int launch_clear(const ClearArgs& a, void* stream) {
  if (a.R <= 0 || a.C <= 0) return static_cast<int>(cudaGetLastError());
  // a row's 16-byte chunks of words (more than of its bytes: n >= C), one
  // more for an unaligned head
  const size_t chunks = a.n / 4 + 1;
  size_t blocks = (chunks + static_cast<size_t>(kThreads) * kChunksPerThread -
                   1) / (static_cast<size_t>(kThreads) * kChunksPerThread);
  const size_t cap = static_cast<size_t>(sm_count()) * kBlocksPerSM;
  blocks = blocks < cap ? blocks : cap;
  blocks = blocks > 0 ? blocks : 1;
  clear_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
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
  ClearArgs a{static_cast<uint32_t*>(acc),
              static_cast<size_t>(C) * W,
              static_cast<const uint32_t*>(pat),
              0u,
              P,
              0,
              0.0f,
              static_cast<uint8_t*>(touched),
              static_cast<uint8_t*>(fresh),
              static_cast<const uint8_t*>(clear),
              static_cast<const uint8_t*>(evicted),
              fresh != nullptr ? static_cast<const uint8_t*>(fresh_clear)
                               : nullptr,
              static_cast<int32_t*>(dropped_capacity),
              C,
              R};
  return launch_clear(a, stream);
}

// The packed plane: one pattern word, the neutral's bits; the touch word is
// the last of a cell's Wc.
extern "C" int clear_rows(void* acc, int Wc, float neutral, const void* clear,
                          const void* evicted, void* dropped_capacity, int C,
                          int R, void* fresh, const void* fresh_clear,
                          void* stream) {
  if (Wc < 2) return static_cast<int>(cudaErrorInvalidValue);
  uint32_t word;
  memcpy(&word, &neutral, sizeof(word));
  ClearArgs a{static_cast<uint32_t*>(acc),
              static_cast<size_t>(C) * Wc,
              nullptr,
              word,
              1,
              Wc,
              neutral,
              nullptr,
              static_cast<uint8_t*>(fresh),
              static_cast<const uint8_t*>(clear),
              static_cast<const uint8_t*>(evicted),
              fresh != nullptr ? static_cast<const uint8_t*>(fresh_clear)
                               : nullptr,
              static_cast<int32_t*>(dropped_capacity),
              C,
              R};
  return launch_clear(a, stream);
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
