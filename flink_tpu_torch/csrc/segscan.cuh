// The segmented scan of G13 rolling_update.cu, its three passes' only
// user (G12 count_update.cu takes its block scan, block_seg_scan, inside
// a single pass, and G11 session_update.cu only its int32 wrapping
// helpers at the end): an inclusive scan of (flag, value) pairs over
// lanes sorted by segment (G10), under the reference's flagged operator
// (ops/segment.py segmented_reduce_sorted, :21-45)
//
//   (f1, v1) o (f2, v2) = (f1 | f2, f2 ? v2 : v1 (+) v2),
//
// so that each lane holds the reduction of its segment up to and including
// itself. A segment may span many blocks (a hot key holds thousands of
// lanes), so the scan is the stable three-pass block structure of ring.cuh
// (G7/G9): (1) each block reduces its chunk of kScanChunk lanes to one pair;
// (2) one block scans those pairs in place; (3) each block rescans its chunk
// with the pair of the blocks before it carried in and hands every lane's
// result to the caller's store(). The combine is applied in lane order
// within a warp, across warps and across blocks, so integer-valued data is
// exact; float sums round in another order than the reference's tree.
//
// A Src supplies: a value type V (trivially copyable, a multiple of 4
// bytes, default-constructible), the combine `static V op(V, V)`,
// `int32_t flag(int i)` (1 where a segment starts; lane 0 must start one),
// `V value(int i)` and `void store(int i, int32_t f, V incl)`. No neutral
// element is needed: a lane only combines with lanes before it in the
// same segment, and lane 0 starts a segment.
#pragma once

#include <cstring>

#include "common.cuh"

constexpr int kScanThreads = 256;
constexpr int kScanChunk = 1024;   // lanes per block; ops/cuda.py SCAN_CHUNK

template <class V>
struct SegPair {
  int32_t f;  // a segment starts in the span
  V v;        // the reduction since the span's last segment start
};

template <class V>
__device__ __forceinline__ V shfl_up_any(V x, int off) {
  static_assert(sizeof(V) % 4 == 0, "scan values are whole 32-bit words");
  constexpr int kWords = sizeof(V) / 4;
  int32_t w[kWords];
  memcpy(w, &x, sizeof(V));
#pragma unroll
  for (int k = 0; k < kWords; ++k) w[k] = __shfl_up_sync(0xffffffffu, w[k], off);
  memcpy(&x, w, sizeof(V));
  return x;
}

template <class Src>
__device__ __forceinline__ SegPair<typename Src::V> seg_combine(
    SegPair<typename Src::V> a, SegPair<typename Src::V> b) {
  return {a.f | b.f, b.f ? b.v : Src::op(a.v, b.v)};
}

// Inclusive segmented scan of one pair per thread, in thread order; *total
// receives the pair of the whole block in every thread. Every thread of the
// block must call it (blockDim.x a multiple of 32, at most 1024).
template <class Src>
__device__ SegPair<typename Src::V> block_seg_scan(
    SegPair<typename Src::V> x, SegPair<typename Src::V>* total) {
  using P = SegPair<typename Src::V>;
  __shared__ P warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    P y;
    y.f = __shfl_up_sync(0xffffffffu, x.f, off);
    y.v = shfl_up_any(x.v, off);
    if (lane >= off) x = seg_combine<Src>(y, x);
  }
  __syncthreads();  // warp_tot[] may still be read by a previous call
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    // lanes at or past n_warps hold stale pairs; they only feed lanes above
    // them, whose results are not used
    P t = warp_tot[lane < n_warps ? lane : 0];
    for (int off = 1; off < 32; off <<= 1) {
      P y;
      y.f = __shfl_up_sync(0xffffffffu, t.f, off);
      y.v = shfl_up_any(t.v, off);
      if (lane >= off) t = seg_combine<Src>(y, t);
    }
    if (lane < n_warps) warp_tot[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_tot[n_warps - 1];
  if (warp > 0) x = seg_combine<Src>(warp_tot[warp - 1], x);
  return x;
}

// Scan lanes [start, end) in tiles of blockDim lanes, with `carry` (the
// pair of everything before `start`) combined in when has_carry; kStore
// hands each lane's result to src.store. Returns the pair of the whole
// span (only meaningful when the span is whole tiles or the last one).
template <class Src, bool kStore>
__device__ SegPair<typename Src::V> chunk_scan(const Src& src, int start, int end,
                                               bool has_carry,
                                               SegPair<typename Src::V> carry) {
  using P = SegPair<typename Src::V>;
  for (int i0 = start; i0 < end; i0 += blockDim.x) {  // uniform trip count
    const int i = i0 + threadIdx.x;
    P x{1, typename Src::V{}};
    if (i < end) {
      x.f = src.flag(i);
      x.v = src.value(i);
    }
    P tile_total;
    P incl = block_seg_scan<Src>(x, &tile_total);
    if (has_carry) incl = seg_combine<Src>(carry, incl);
    if (kStore && i < end) src.store(i, incl.f, incl.v);
    carry = has_carry ? seg_combine<Src>(carry, tile_total) : tile_total;
    has_carry = true;
  }
  return carry;
}

template <class Src>
__global__ void seg_agg_kernel(Src src, int n, SegPair<typename Src::V>* blk) {
  const int start = blockIdx.x * kScanChunk;
  const int end = min(start + kScanChunk, n);
  const SegPair<typename Src::V> tot =
      chunk_scan<Src, false>(src, start, end, false, {});
  if (threadIdx.x == 0) blk[blockIdx.x] = tot;
}

// One block: the blocks' pairs scanned in place (inclusive).
template <class Src>
__global__ void seg_carry_kernel(int n_blk, SegPair<typename Src::V>* blk) {
  using P = SegPair<typename Src::V>;
  P carry{};
  bool has_carry = false;
  for (int b0 = 0; b0 < n_blk; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    P x{1, typename Src::V{}};
    if (b < n_blk) x = blk[b];
    P tile_total;
    P incl = block_seg_scan<Src>(x, &tile_total);
    if (has_carry) incl = seg_combine<Src>(carry, incl);
    if (b < n_blk) blk[b] = incl;
    carry = has_carry ? seg_combine<Src>(carry, tile_total) : tile_total;
    has_carry = true;
  }
}

template <class Src>
__global__ void seg_apply_kernel(Src src, int n,
                                 const SegPair<typename Src::V>* __restrict__ blk) {
  const int start = blockIdx.x * kScanChunk;
  const int end = min(start + kScanChunk, n);
  const bool has_carry = blockIdx.x > 0;
  SegPair<typename Src::V> carry{};
  if (has_carry) carry = blk[blockIdx.x - 1];
  chunk_scan<Src, true>(src, start, end, has_carry, carry);
}

// The three passes over lanes [0, n); `blk` holds ceil(n / kScanChunk)
// pairs (ops/cuda.py allocates SCAN_PAIR_BYTES each).
template <class Src>
int seg_scan_launch(const Src& src, int n, void* blk, cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  using P = SegPair<typename Src::V>;
  static_assert(sizeof(P) <= 16, "ops/cuda.py SCAN_PAIR_BYTES is 16");
  const int n_blk = (n + kScanChunk - 1) / kScanChunk;
  P* pairs = static_cast<P*>(blk);
  seg_agg_kernel<Src><<<n_blk, kScanThreads, 0, s>>>(src, n, pairs);
  seg_carry_kernel<Src><<<1, 1024, 0, s>>>(n_blk, pairs);
  seg_apply_kernel<Src><<<n_blk, kScanThreads, 0, s>>>(src, n, pairs);
  return static_cast<int>(cudaGetLastError());
}

// int32 arithmetic that wraps as jnp's does (signed overflow is undefined
// in C++).
__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sub_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
