// Stable append of masked lanes to the overflow ring, shared by G7
// ring_append.cu (the update's nofit lanes) and G9 compact_table.cu (the
// touched rows of keys that find no slot in the rebuilt table), as the
// reference shares ops/window_kernels.py ring_append between the two so
// that their lost-record accounting cannot diverge. G11 session_update.cu
// and G12 count_update.cu compact their fire rows with it too, into row
// buffers of their own (the Out type).
//
// Semantics (window_kernels.py:222): the lanes i < n with take(i), in lane
// order, go to ring positions ovf_n, ovf_n + 1, ...; those at positions
// >= O are lost and counted; ovf_n becomes min(ovf_n + taken, O).
//
// Design: a three-pass block scan (count, scan, write). Blocks own
// contiguous chunks of kRingChunk lanes. (1) count: each block counts its
// taken lanes. (2) scan: one block turns the counts into absolute ring
// positions, reading the base ovf_n on the card (so the host never syncs),
// advances ovf_n and adds the lost lanes to `lost`. (3) write: each block
// walks its chunk in tiles of blockDim lanes, ranks the taken lanes of a
// tile with a block scan and writes those that fit. The order is the lane
// order, so the result equals the plain version exactly (an atomicAdd
// cursor would not: which lanes are lost, and the order in which the host
// adds a key's contributions, depend on it).
#pragma once

#include "common.cuh"

constexpr int kRingThreads = 256;
constexpr int kRingChunk = 1024;  // lanes per block; ops/cuda.py RING_CHUNK

struct RingOut {
  uint32_t* hi;
  uint32_t* lo;
  int32_t* pane;
  float* val;  // [O, W] row-major
  int W = 1;
};

template <class Src>
__global__ void ring_count_kernel(Src src, int n, int32_t* __restrict__ blk_count) {
  const int start = blockIdx.x * kRingChunk;
  const int end = min(start + kRingChunk, n);
  int32_t c = 0;
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) c += src.take(i) ? 1 : 0;
  c = block_sum(c);
  if (threadIdx.x == 0) blk_count[blockIdx.x] = c;
}

// static: each source that includes this header gets its own copy
static __global__ void ring_scan_kernel(int n_blk, int O, const int32_t* __restrict__ blk_count,
                                 int32_t* __restrict__ blk_off, int32_t* ovf_n,
                                 int32_t* lost) {
  const int32_t base = *ovf_n;
  int32_t carry = 0;
  for (int b0 = 0; b0 < n_blk; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const int32_t v = b < n_blk ? blk_count[b] : 0;
    int32_t tile_total;
    const int32_t ex = block_exclusive_scan(v, &tile_total);
    if (b < n_blk) blk_off[b] = base + carry + ex;
    carry += tile_total;
  }
  __syncthreads();  // every thread has read *ovf_n
  if (threadIdx.x == 0) {
    const int32_t end = base + carry;  // the wrapper keeps O + n < 2^31
    *ovf_n = min(end, O);
    if (end > O) *lost += end - O;
  }
}

template <class Src, class Out>
__global__ void ring_write_kernel(Src src, int n, int O,
                                  const int32_t* __restrict__ blk_off, Out out) {
  const int start = blockIdx.x * kRingChunk;
  const int end = min(start + kRingChunk, n);
  int32_t pos0 = blk_off[blockIdx.x];
  if (pos0 >= O) return;  // uniform per block: the ring is full
  for (int i0 = start; i0 < end; i0 += blockDim.x) {  // uniform trip count
    const int i = i0 + threadIdx.x;
    const bool t = i < end && src.take(i);
    int32_t tile_total;
    const int32_t pos = pos0 + block_exclusive_scan(t ? 1 : 0, &tile_total);
    if (t && pos < O) src.lane(i, out, pos);
    pos0 += tile_total;
  }
}

// Launch the three passes over lanes [0, n). blk_count / blk_off hold
// ceil(n / kRingChunk) ints each.
template <class Src, class Out>
int ring_append_launch(const Src& src, int n, int O, Out out, int32_t* ovf_n,
                       int32_t* lost, int32_t* blk_count, int32_t* blk_off,
                       cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int n_blk = (n + kRingChunk - 1) / kRingChunk;
  ring_count_kernel<Src><<<n_blk, kRingThreads, 0, s>>>(src, n, blk_count);
  ring_scan_kernel<<<1, 1024, 0, s>>>(n_blk, O, blk_count, blk_off, ovf_n, lost);
  ring_write_kernel<Src, Out><<<n_blk, kRingThreads, 0, s>>>(src, n, O, blk_off, out);
  return static_cast<int>(cudaGetLastError());
}
