// A single-pass stable compaction's tile offsets: decoupled look-back
// (Merrill and Garland) over status words that carry a tag kept on the
// device, used by G11 session_update.cu (its old fires and its watermark
// close), G7 ring_append.cu (the single-pass form of ring.cuh's three
// passes, the ring's base folded into tile 0's prefix) and G12
// count_update.cu (its words and tags, read a warp's rows at a time).
//
// Tiles are blocks in blockIdx order (the card starts lower blocks first,
// so a tile waits only on tiles that run or ran). A tile publishes its
// count of taken items as an aggregate, then the block reads the status
// words of the tiles before it, a window of blockDim.x at a time, back to
// the nearest inclusive prefix, and the tile publishes its own inclusive
// prefix. A status word is
// tag << 32 | flag << 30 | count (counts below 2^30). The tag is the call's
// (lb_tag): one more than a count of calls that the caller's scratch keeps
// and the call's last block advances, never 0, so the scratch is zeroed
// once and never cleared: a word of an earlier call reads as not yet
// published, and no epoch comes from the host.
#pragma once

#include "common.cuh"

constexpr unsigned long long kLbAggregate = 1ull << 30;
constexpr unsigned long long kLbInclusive = 2ull << 30;
constexpr unsigned long long kLbFlags = 3ull << 30;
constexpr uint32_t kLbCountMask = (1u << 30) - 1u;

// The call's tag from its scratch's count of calls (a value read, or the
// word to read).
__device__ __forceinline__ uint32_t lb_tag_of(uint32_t calls) {
  const uint32_t t = calls + 1u;
  return t + (t == 0u ? 1u : 0u);
}

__device__ __forceinline__ uint32_t lb_tag(const uint32_t* calls) {
  return lb_tag_of(__ldcg(calls));
}

__device__ __forceinline__ void lb_publish(unsigned long long* p, uint32_t tag,
                                           unsigned long long flag,
                                           uint32_t n) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      (static_cast<unsigned long long>(tag) << 32) | flag | n;
}

// The smallest of one int a thread, in every thread. Every thread of the
// block calls it (blockDim.x a multiple of 32, at most 1024).
__device__ __forceinline__ int lb_block_min(int v) {
  __shared__ int part[32];
  __shared__ int out;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_min_sync(0xffffffffu, v);
  __syncthreads();  // part[] and out may still be read by a previous call
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    const int w = __reduce_min_sync(0xffffffffu,
                                    lane < n_warps ? part[lane] : INT_MAX);
    if (lane == 0) out = w;
  }
  __syncthreads();
  return out;
}

// Every thread of the block, once a kernel: publish tile `tile`'s count
// `tile_n`, find the tiles' count before it and publish its inclusive
// prefix. Returns the count before the tile in every thread. The look-back
// reads blockDim.x status words a round, one a thread, back to the nearest
// inclusive prefix: every tile publishes its aggregate before it looks
// back, so a round waits on no look-back of another tile, and a tile that
// finds no inclusive prefix in its window goes on with the next one.
__device__ __forceinline__ uint32_t lb_tile_offset(unsigned long long* st,
                                                   int tile, uint32_t tag,
                                                   uint32_t tile_n) {
  __shared__ uint32_t s_excl;
  if (threadIdx.x == 0) {  // the aggregate first, for the tiles behind
    lb_publish(st + tile, tag, tile == 0 ? kLbInclusive : kLbAggregate,
               tile_n);
  }
  uint32_t excl = 0;
  if (tile > 0) {
    const int n = static_cast<int>(blockDim.x);
    for (int pred = tile - 1;; pred -= n) {
      const int idx = pred - static_cast<int>(threadIdx.x);
      // before the first tile: an inclusive 0
      unsigned long long w = (static_cast<unsigned long long>(tag) << 32) |
                             kLbInclusive;
      if (idx >= 0) {
        const volatile unsigned long long* p = st + idx;
        do {
          w = *p;
        } while (static_cast<uint32_t>(w >> 32) != tag);
      }
      const bool inc = (w & kLbFlags) == kLbInclusive;
      const int stop = lb_block_min(inc ? static_cast<int>(threadIdx.x) : n);
      const int32_t c = static_cast<int>(threadIdx.x) <= stop
                            ? static_cast<int32_t>(w & kLbCountMask)
                            : 0;
      excl += static_cast<uint32_t>(block_sum(c));  // thread 0's is valid
      if (stop < n) break;
    }
  }
  if (threadIdx.x == 0) {
    if (tile > 0) lb_publish(st + tile, tag, kLbInclusive, excl + tile_n);
    s_excl = excl;
  }
  __syncthreads();
  return s_excl;
}
