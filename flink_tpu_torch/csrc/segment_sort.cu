// G10 segment_sort — a stable sort of B lanes by a 64-bit key, with the
// segment flags of the sorted order.
//
// Replaces (flink_tpu, the JAX reference): ops/segment.py argsort_ids (:71,
// jnp.argsort, stable), segment_sort (:89) and the two stable sorts of
// ops/session_windows.py _lexsort_slot_ts (:78-82), all in kernel family K3.
// ops/segment.py (the port's) builds the key: the state slot, with dead
// lanes given the slot C so they sort last (rolling and count windows), or
// (slot << 32) | (ts ^ 0x80000000) with dead lanes (C << 32) for sessions,
// so one sort orders by (slot, ts) and keeps lane order among equal keys,
// as the reference's two stable sorts do.
//
// Outputs: order (int32 [B], the gather permutation), key_s (the sorted
// keys) and seg_start (uint8 [B]: lane 0, and every lane whose key >>
// seg_shift differs from the lane before).
//
// Bound: bytes. The least is the key read once and the order, sorted key
// and flag written once, 21 B a lane: 5.5 MB, 1.6 us at 3.35 TB/s for
// 262,144 lanes. This sort is L2-resident: at 524,288 lanes the keys and
// indices of both ping-pong buffers come to 12.6 MB, inside the H100's
// 50 MB L2, so its time is set by its passes, grid barriers and look-back
// latency, not by HBM bytes; the bytes bound is kept as the yardstick.
//
// Design: one cooperative launch a call, an LSD radix sort over 8-bit
// digits in the manner of Merrill and Adinetz's onesweep. The grid holds
// at most the blocks the card runs at once (cudaLaunchCooperativeKernel
// refuses more), and they meet at grid barriers:
// (1) every block counts its lanes' digits, all ceil(bits / 8) of them
//     from one read of the keys (a warp whose lanes share a digit adds
//     once, others a lane at a time, in shared memory; then one global add
//     a bin), and the grid meets. Each block then reads the histograms,
//     scans each digit's first positions and marks the constant digits
//     (one bin holds all n lanes): every block skips those passes, with no
//     copy, and the buffers ping-pong over the live passes only, so the
//     last lands in the outputs.
// (2) a live pass: each block takes tiles of kTile lanes from an atomic
//     counter (a tile only waits on tiles that running blocks hold),
//     loads kItems lanes a thread, warp-striped and coalesced, and ranks
//     them stably: per warp and item, the lanes of a digit find each
//     other through an atomicOr of their lane bits into a shared word,
//     and a warp count in shared memory carries the earlier items. The
//     tile publishes its 256 digit counts in 32-bit status words
//     (aggregate, then inclusive prefix) and digit d's thread looks back
//     over the tiles before it (decoupled look-back, Merrill and Garland,
//     as G6 fire_compact does), kWindow words in flight, the first window
//     issued before the tile's keys are exchanged through shared memory
//     into digit order. Then the keys, and after them the indices, are
//     written as contiguous runs a digit (coalesced stores). The live
//     passes take the two halves of the status in turn, each zeroing the
//     other for the next, and the grid meets after each; a block takes the
//     next pass's first tile before it arrives.
// (3) the flags, from the sorted keys (or, when every digit is constant,
//     the keys copied and the identity order).
// The scratch is allocated once a device and stream: the status halves,
// the histogram's two halves (a call adds into the half of its parity and
// zeroes the other for the next call), the tile counters (zeroed by block
// 0 before the first barrier) and the barrier's words, each on a line of
// its own. Data that crosses blocks within the launch is read with
// ld.global.cg or volatile loads (L2, never a stale L1 line).
//
// Choices, measured on an H100 80GB HBM3 at 700 W (PERF.md §6 has the
// times): tiles of 512 threads x 4 lanes (ops/cuda.py SORT_TILE) against
// 256 x 4, 256 x 8 and 512 x 2, and a look-back window of 4 against 8, at
// the five G10 shapes of chip_smoke.py phase 3. 8-bit digits: an 11-bit
// digit has 2,048 bins, eight times the status words and look-back threads
// a tile and the warp counts, while the constant digits a (slot, tick) key
// has are already skipped.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;   // ops/cuda.py SORT_TILE
constexpr int kBins = 256;                 // threads [0, kBins) own a digit
constexpr int kMaxDigits = 8;
constexpr int kWindow = 4;                 // status words read at once
static_assert(kThreads >= kBins, "a thread a digit");
// the state words (ops/cuda.py SORT_STATE_WORDS): two histogram halves,
// then, a 128-byte line each, the tile counters, the grid barrier's
// count and its generation
constexpr int kHistWords = kMaxDigits * kBins;
constexpr int kLine = 32;
constexpr int kStateWords = 2 * kHistWords + 3 * kLine;

// a status word: flag << 30 | count, 0 until the tile publishes
constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kInclusive = 2u << 30;
constexpr uint32_t kFlags = 3u << 30;
constexpr uint32_t kCountMask = (1u << 30) - 1u;

struct Args {
  const unsigned long long* keys;
  int n;
  int n_digits;
  int seg_shift;
  int32_t* order;
  unsigned long long* key_s;
  uint8_t* seg_start;
  unsigned long long* kalt;
  int32_t* ialt;
  uint32_t* status;   // [2][status_tiles][kBins], live pass i in half i & 1
  int status_tiles;
  int32_t* state;      // [kStateWords]
  uint32_t parity;     // the call's histogram half
};

struct Smem {
  union {
    unsigned long long keys[kTile];   // a tile in digit order
    uint32_t idx[kTile];
    uint32_t match[kWarps][kBins];    // the ranking's lane masks
    int32_t hist[kMaxDigits][kBins];  // step (1)'s block counts
  } x;
  int32_t wh[kWarps][kBins];   // warp counts, then warp offsets
  int32_t goff[kMaxDigits][kBins];   // each pass's first position a digit
  int32_t texcl[kBins];        // the tile's first position a digit
  int32_t gbase[kBins];        // global position - tile position
  int32_t wsum[kWarps];
  int tile;
  unsigned skip;
};

__device__ __forceinline__ void publish(uint32_t* p, uint32_t flag,
                                        uint32_t n) {
  *reinterpret_cast<volatile uint32_t*>(p) = flag | n;
}

// Every block of the grid meets here; writes before it are visible after
// it (to ld.global.cg and volatile loads). The count resets itself; the
// generation, on a line of its own, only grows.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + kLine;
    const unsigned seen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + kLine, 1u);
    } else {
      while (*gen == seen) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The exclusive prefix of v over the block's threads.
__device__ __forceinline__ int32_t block_excl_scan(int32_t v, Smem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s.wsum[warp] = x;
  __syncthreads();
  int32_t before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? s.wsum[w] : 0;
  __syncthreads();
  return before + x - v;
}

__device__ __forceinline__ int digit_of(unsigned long long k, int p) {
  return static_cast<int>((k >> (8 * p)) & 255u);
}

// The decoupled look-back of thread d < kBins: the count of digit d in the
// tiles before `tile`, from their status words, nearest first, stopping at
// the nearest inclusive prefix; kWindow words in flight at once, the next
// window's while one is summed. `w` holds the first window, loaded by
// look_back_issue before the tile's exchange.
__device__ __forceinline__ void look_back_issue(const uint32_t* st, int top,
                                                uint32_t* w) {
#pragma unroll
  for (int k = 0; k < kWindow; ++k) {
    const int pred = top - k;
    w[k] = pred >= 0 ? *reinterpret_cast<const volatile uint32_t*>(
                           st + pred * kBins + threadIdx.x)
                     : kInclusive;   // before the first tile: an inclusive 0
  }
}

__device__ __forceinline__ uint32_t look_back(const uint32_t* st, int tile,
                                              uint32_t* w) {
  uint32_t excl = 0;
  for (int top = tile - 1;; top -= kWindow) {
    // a window that reaches tile 0 (always inclusive) ends the walk
    uint32_t nx[kWindow];
    if (top >= kWindow) look_back_issue(st, top - kWindow, nx);
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      const volatile uint32_t* p = st + (top - k) * kBins + threadIdx.x;
      while ((w[k] & kFlags) == 0u) w[k] = *p;
      excl += w[k] & kCountMask;
      if ((w[k] & kFlags) == kInclusive) return excl;
    }
#pragma unroll
    for (int k = 0; k < kWindow; ++k) w[k] = nx[k];
  }
}

// A tile index from the pass's counter, the same in every thread.
__device__ __forceinline__ int next_tile(int32_t* ctr, Smem& s) {
  if (threadIdx.x == 0) s.tile = atomicAdd(ctr, 1);
  __syncthreads();
  const int tile = s.tile;
  __syncthreads();
  return tile;
}

// One tile of one live pass: rank, publish, exchange, look back, write.
__device__ __forceinline__ void sort_tile(
    const Args& a, Smem& s, int tile, int p, uint32_t* st, bool first,
    const unsigned long long* __restrict__ src_k,
    const int32_t* __restrict__ src_i, unsigned long long* __restrict__ dst_k,
    int32_t* __restrict__ dst_i) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool owner = t < kBins;   // the thread of digit t
  const int base = tile * kTile;
  const int tile_n = min(kTile, a.n - base);
  const int w0 = warp * 32 * kItems;   // the warp's first lane in the tile
  for (int b = lane; b < kBins; b += 32) {
    s.wh[warp][b] = 0;
    s.x.match[warp][b] = 0u;
  }
  __syncwarp();

  unsigned long long key[kItems];
  int32_t idx[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int l = w0 + j * 32 + lane;
    const bool in = l < tile_n;
    // the input keys are never written; the ping-pong buffers are, by
    // other blocks earlier in this launch
    key[j] = in ? (first ? src_k[base + l] : __ldcg(src_k + base + l)) : 0ull;
    idx[j] = in ? (first ? base + l : __ldcg(src_i + base + l)) : 0;
  }

  // stable ranks within the warp, in lane order (item, lane): a digit's
  // lanes (their bits or-ed into its shared word), the warp's count of it
  // before this item, then the lanes' count added by the first of them
  const unsigned lt = (1u << lane) - 1u;
  int32_t rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool in = w0 + j * 32 + lane < tile_n;
    const int d = digit_of(key[j], p);
    if (in) atomicOr(&s.x.match[warp][d], 1u << lane);
    __syncwarp();
    const unsigned peers = in ? s.x.match[warp][d] : 0u;
    __syncwarp();
    const int leader = in ? __ffs(peers) - 1 : lane;
    int32_t old = 0;
    if (in && lane == leader) {
      s.x.match[warp][d] = 0u;
      old = s.wh[warp][d];
      s.wh[warp][d] = old + __popc(peers);
    }
    rank[j] = __shfl_sync(0xffffffffu, old, leader) + __popc(peers & lt);
    __syncwarp();
  }
  __syncthreads();

  // digit t's thread: the warps' offsets and the tile's count, published
  int32_t cnt = 0;
  if (owner) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = s.wh[w][t];
      s.wh[w][t] = cnt;
      cnt += c;
    }
    publish(st + tile * kBins + t, tile == 0 ? kInclusive : kAggregate,
            static_cast<uint32_t>(cnt));
  }
  uint32_t w[kWindow];
  if (owner && tile > 0) look_back_issue(st, tile - 1, w);
  const int32_t texcl = block_excl_scan(cnt, s);
  if (owner) s.texcl[t] = texcl;
  __syncthreads();

  // the keys into digit order in shared memory while the look-back's
  // first words are in flight
  int32_t lpos[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool in = w0 + j * 32 + lane < tile_n;
    const int d = digit_of(key[j], p);
    lpos[j] = in ? s.texcl[d] + s.wh[warp][d] + rank[j] : -1;
    if (in) s.x.keys[lpos[j]] = key[j];
  }
  if (owner) {
    const uint32_t excl = tile == 0 ? 0u : look_back(st, tile, w);
    if (tile > 0) publish(st + tile * kBins + t, kInclusive, excl + cnt);
    s.gbase[t] = s.goff[p][t] + static_cast<int32_t>(excl) - texcl;
  }
  __syncthreads();

  // contiguous runs a digit: keys, then indices through the same buffer
  int32_t pos[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = u * kThreads + t;
    pos[u] = -1;
    if (i < tile_n) {
      const unsigned long long k = s.x.keys[i];
      pos[u] = s.gbase[digit_of(k, p)] + i;
      dst_k[pos[u]] = k;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (lpos[j] >= 0) s.x.idx[lpos[j]] = static_cast<uint32_t>(idx[j]);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    if (pos[u] >= 0) {
      dst_i[pos[u]] = static_cast<int32_t>(s.x.idx[u * kThreads + t]);
    }
  }
  __syncthreads();   // the next tile reuses the shared buffers
}

__global__ void __launch_bounds__(kThreads) sort_kernel(Args a) {
  __shared__ Smem s;
  const int t = threadIdx.x, lane = t & 31;
  const bool owner = t < kBins;
  const int n = a.n;
  const int nd = a.n_digits;
  const int n_tiles = (n + kTile - 1) / kTile;
  int32_t* hist = a.state + a.parity * kHistWords;
  int32_t* next = a.state + (a.parity ^ 1u) * kHistWords;
  int32_t* ctr = a.state + 2 * kHistWords;
  unsigned* bar = reinterpret_cast<unsigned*>(ctr + kLine);

  // (1) the next call's histogram, this call's tile counters and the
  // first live pass's status words zeroed; every digit counted from one
  // read of the keys: a warp whose lanes share a digit adds once, others
  // a lane at a time
  if (blockIdx.x == 0) {
    for (int i = t; i < kHistWords; i += kThreads) next[i] = 0;
    if (t < kMaxDigits) ctr[t] = 0;
  }
  const int status_words = n_tiles * kBins;
  for (int i = blockIdx.x * kThreads + t; i < status_words;
       i += gridDim.x * kThreads) {
    a.status[i] = 0u;
  }
  for (int i = t; i < nd * kBins; i += kThreads) {
    s.x.hist[i / kBins][i % kBins] = 0;
  }
  __syncthreads();
  for (int i0 = blockIdx.x * kTile; i0 < n; i0 += gridDim.x * kTile) {
    unsigned long long k[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = i0 + j * kThreads + t;
      k[j] = i < n ? a.keys[i] : 0ull;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = i0 + j * kThreads + t < n;
      for (int p = 0; p < nd; ++p) {
        const int d = in ? digit_of(k[j], p) : kBins;
        if (__all_sync(0xffffffffu, d == __shfl_sync(0xffffffffu, d, 0))) {
          if (lane == 0 && in) atomicAdd(&s.x.hist[p][d], 32);
        } else if (in) {
          atomicAdd(&s.x.hist[p][d], 1);
        }
      }
    }
  }
  __syncthreads();
  for (int i = t; i < nd * kBins; i += kThreads) {
    const int32_t c = s.x.hist[i / kBins][i % kBins];
    if (c) atomicAdd(&hist[i], c);
  }
  grid_sync(bar);

  // the constant digits, seen alike by every block, and each digit's
  // first position
  if (t == 0) s.skip = 0;
  __syncthreads();
  for (int p = 0; p < nd; ++p) {
    const int32_t c = owner ? __ldcg(&hist[p * kBins + t]) : 0;
    if (c == n) atomicOr(&s.skip, 1u << p);
    const int32_t goff = block_excl_scan(c, s);
    if (owner) s.goff[p][t] = goff;
  }
  __syncthreads();
  const unsigned live = ((1u << nd) - 1u) & ~s.skip;
  const int n_live = __popc(live);

  if (n_live == 0) {  // every key equal: the keys as they are
    for (int i = blockIdx.x * kThreads + t; i < n; i += gridDim.x * kThreads) {
      a.key_s[i] = a.keys[i];
      a.order[i] = i;
      a.seg_start[i] = i == 0;
    }
    return;
  }

  // (2) the live passes; the last one writes the outputs. A block takes
  // the first tile of the next live pass before the grid meets.
  int tile = next_tile(ctr + (__ffs(live) - 1), s);
  int done = 0;
  for (int p = 0; p < nd; ++p) {
    if (!((live >> p) & 1u)) continue;
    const bool to_out = ((n_live - 1 - done) & 1) == 0;
    const bool first = done == 0;
    const unsigned long long* src_k =
        first ? a.keys : (to_out ? a.kalt : a.key_s);
    const int32_t* src_i = first ? nullptr : (to_out ? a.ialt : a.order);
    unsigned long long* dst_k = to_out ? a.key_s : a.kalt;
    int32_t* dst_i = to_out ? a.order : a.ialt;
    // this pass's status half, and the next live pass's zeroed meanwhile
    const size_t half = static_cast<size_t>(a.status_tiles) * kBins;
    uint32_t* st = a.status + (done & 1) * half;
    uint32_t* st_next = a.status + ((done + 1) & 1) * half;
    for (int i = blockIdx.x * kThreads + t; i < status_words;
         i += gridDim.x * kThreads) {
      st_next[i] = 0u;
    }
    while (tile < n_tiles) {
      sort_tile(a, s, tile, p, st, first, src_k, src_i, dst_k, dst_i);
      tile = next_tile(ctr + p, s);
    }
    const unsigned later = live & ~((2u << p) - 1u);
    if (later) tile = next_tile(ctr + (__ffs(later) - 1), s);
    grid_sync(bar);
    ++done;
  }

  // (3) the flags
  const int sh = a.seg_shift;
  for (int i = blockIdx.x * kThreads + t; i < n; i += gridDim.x * kThreads) {
    const unsigned long long k = __ldcg(a.key_s + i);
    a.seg_start[i] = i == 0 || (k >> sh) != (__ldcg(a.key_s + i - 1) >> sh);
  }
}

int g_grid[64];   // co-resident blocks a device, found once

}  // namespace

// Lanes a tile (ops/cuda.py SORT_TILE) and the state words.
extern "C" int segment_sort_tile() { return kTile; }
extern "C" int segment_sort_state_words() { return kStateWords; }

// keys: uint64 [n], each < 2^bits; scratch: kalt uint64 [n], ialt int32
// [n], status int32 [2 * status_tiles * 256] and state int32
// [kStateWords], zeroed once when allocated; parity: 0 or 1, flipped each
// call (the histogram half it adds into; it zeroes the other).
extern "C" int segment_sort(const void* keys, int n, int bits, int seg_shift,
                            void* order, void* key_s, void* seg_start,
                            void* kalt, void* ialt, void* status,
                            int status_tiles, void* state, unsigned int parity,
                            void* stream) {
  if (bits < 1 || bits > 64 || seg_shift < 0 || seg_shift > 63 ||
      n >= (1 << 30) || parity > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int n_tiles = (n + kTile - 1) / kTile;
  if (status_tiles < n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_grid[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sort_kernel,
                                                  kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (per_sm <= 0 || sms <= 0) return static_cast<int>(cudaGetLastError());
    g_grid[dev] = per_sm * sms;
  }
  Args a{static_cast<const unsigned long long*>(keys), n, (bits + 7) / 8,
         seg_shift, static_cast<int32_t*>(order),
         static_cast<unsigned long long*>(key_s),
         static_cast<uint8_t*>(seg_start),
         static_cast<unsigned long long*>(kalt), static_cast<int32_t*>(ialt),
         static_cast<uint32_t*>(status), status_tiles,
         static_cast<int32_t*>(state), parity};
  void* params[] = {&a};
  const int grid = min(n_tiles, g_grid[dev]);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(sort_kernel), dim3(grid), dim3(kThreads), params,
      0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
