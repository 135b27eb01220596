// Shared helpers of the window-path kernels (route_lanes.cu, clear_rows.cu,
// scatter_update.cu, fire_reduced.cu, hash_upsert.cu, fire_compact.cu,
// sketch_update.cu, sketch_fire.cu and the rest of csrc/):
// int32 pane arithmetic with the reference's floor semantics (the divide by
// a multiply and a shift), the key-group hash of a key identity, block-wide
// reductions that end in one atomic per block, a block-wide scan, a
// shared-memory key-group histogram, the float min / max combines of the
// min and max reduces, and the card's multiprocessor count.
#pragma once

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

// flink_tpu/ops/window_kernels.py PANE_NONE: the "no pane" sentinel.
constexpr int32_t kPaneNone = INT32_MIN + 1;

// floor(a / d) (jnp.floor_divide) for a divisor d > 0 fixed at launch, by a
// multiply and a shift: the numerator n = a for a >= 0 and ~a = -a - 1 for
// a < 0 lies in [0, 2^31), and floor(a / d) is n / d for a >= 0 and
// ~(n / d) for a < 0. With l = ceil(log2 d) and m = ceil(2^(31 + l) / d) <
// 2^32, n / d == (n * m) >> (31 + l) for every n < 2^31 (Granlund and
// Montgomery: m d - 2^(31 + l) < d <= 2^l). div_magic computes m and the
// shift on the host.
struct DivMagic {
  uint32_t m;
  int shift;
};

inline DivMagic div_magic(int32_t d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  const unsigned long long m = ((1ULL << (31 + l)) + d - 1) / d;
  return DivMagic{static_cast<uint32_t>(m), 31 + l};
}

__device__ __forceinline__ int32_t floor_div(int32_t a, DivMagic dm) {
  const int32_t s = a >> 31;  // 0, or -1 for a negative a
  const uint32_t n = static_cast<uint32_t>(a ^ s);
  const uint32_t q = static_cast<uint32_t>(
      (static_cast<unsigned long long>(n) * dm.m) >> dm.shift);
  return static_cast<int32_t>(q) ^ s;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// core/keygroups.py murmur3_32: one 32-bit word, seed 0, length 4.
__device__ __forceinline__ uint32_t murmur3_32(uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  uint32_t h = rotl32(k, 13);
  h = h * 5u + 0xE6546B64u;
  h ^= 4u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The key group of a key identity (hi, lo): ops/hashing.py route_hash,
// then core/keygroups.py assign_to_key_group over maxp groups; the modulo
// is a mask when the caller knows maxp to be a power of two (``mask`` =
// maxp - 1; -1 otherwise).
__device__ __forceinline__ int32_t key_group(uint32_t hi, uint32_t lo,
                                             int maxp, int mask = -1) {
  const uint32_t h = murmur3_32(lo ^ (hi * 0x9E3779B9u));
  return static_cast<int32_t>(mask >= 0 ? h & static_cast<uint32_t>(mask)
                                        : h % static_cast<uint32_t>(maxp));
}

// a mod b in [0, b) for b > 0 (jnp.mod).
__device__ __forceinline__ int32_t floor_mod(int32_t a, int32_t b) {
  int32_t r = a % b;
  return r < 0 ? r + b : r;
}

// jnp.minimum / jnp.maximum on float32, as XLA's scatter-min and -max
// combine: NaN wins, and -0.0 orders below +0.0 (so min(+0, -0) is -0 and
// max(+0, -0) is +0 in either order). fminf / fmaxf do neither.
__device__ __forceinline__ float jnp_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return (__float_as_uint(a) & 0x80000000u) ? a : b;
  return a < b ? a : b;
}

__device__ __forceinline__ float jnp_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) return (__float_as_uint(a) & 0x80000000u) ? b : a;
  return a > b ? a : b;
}

// A builtin reduce's combine: op 0 add, 1 min, 2 max (ops/cuda.py OPS).
__device__ __forceinline__ float combine_op(int op, float a, float b) {
  return op == 0 ? a + b : (op == 1 ? jnp_min(a, b) : jnp_max(a, b));
}

// *p = min or max (op 1, 2) of *p and v, atomically, from ``old``, the
// word's value as the caller read it: a loop on a 32-bit atomicCAS that
// leaves at once when the cell already holds the result (a hot key's
// repeated max costs one load).
__device__ __forceinline__ void combine_from(float* p, unsigned int old,
                                             float v, int op) {
  unsigned int* q = reinterpret_cast<unsigned int*>(p);
  while (true) {
    const float cur = __uint_as_float(old);
    const unsigned int want =
        __float_as_uint(op == 1 ? jnp_min(cur, v) : jnp_max(cur, v));
    if (want == old) return;
    const unsigned int seen = atomicCAS(q, old, want);
    if (seen == old) return;
    old = seen;
  }
}

// *p = combine(*p, v), atomically. Add is the hardware float atomicAdd;
// min and max read the word, then combine_from.
__device__ __forceinline__ void atomic_combine(float* p, float v, int op) {
  if (op == 0) {
    atomicAdd(p, v);
    return;
  }
  combine_from(p, *reinterpret_cast<unsigned int*>(p), v, op);
}

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int32_t warp_max(int32_t v) {
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int32_t warp_min(int32_t v) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide sum; the result is valid in thread 0. Every thread of the
// block must call it (blockDim.x a multiple of 32, at most 1024).
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // part[] may still be read by a previous call
  if (lane == 0) part[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  v = (threadIdx.x < n_warps) ? part[threadIdx.x] : T(0);
  if (warp == 0) v = warp_sum(v);
  return v;
}

// Block-wide exclusive prefix sum of one int per thread, in thread order;
// *total receives the block's sum in every thread. Every thread of the
// block must call it (blockDim.x a multiple of 32, at most 1024).
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v,
                                                        int32_t* total) {
  __shared__ int32_t warp_incl[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int32_t x = v;  // inclusive scan within the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  __syncthreads();  // warp_incl[] may still be read by a previous call
  if (lane == 31) warp_incl[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t t = lane < n_warps ? warp_incl[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += y;
    }
    warp_incl[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_incl[n_warps - 1];
  return (warp > 0 ? warp_incl[warp - 1] : 0) + x - v;
}

// A block's key-group histogram in dynamic shared memory (``hist``, maxp
// int32 bins): every thread of the block calls kg_hist_zero, then counts
// its items with atomicAdd on hist (shared-memory atomics), then every
// thread calls kg_hist_flush, which adds each non-zero bin to the global
// histogram with one atomic. A block with n items touches at most n bins,
// so the flush issues at most n global atomics; it scans all maxp bins, so
// a caller gives each block many more items than maxp / blockDim.x.
__device__ __forceinline__ void kg_hist_zero(int32_t* hist, int maxp) {
  for (int b = threadIdx.x; b < maxp; b += blockDim.x) hist[b] = 0;
  __syncthreads();
}

__device__ __forceinline__ void kg_hist_flush(const int32_t* hist, int maxp,
                                              int32_t* __restrict__ out) {
  __syncthreads();
  for (int b = threadIdx.x; b < maxp; b += blockDim.x) {
    const int32_t v = hist[b];
    if (v) atomicAdd(&out[b], v);
  }
}

// The current device's multiprocessor count, asked once a device (132 on
// an H100 SXM when the query fails).
inline int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 132;
  }
  return sms[dev];
}

// Blocks for a histogramming pass over n items with maxp bins: enough
// blocks to fill the card (two a multiprocessor), and no more than one per
// ``threads`` items, each block taking at least 4 * maxp items when that
// still leaves two a multiprocessor.
inline int kg_hist_blocks(long long n, int maxp, int threads) {
  const int sms = sm_count();
  const long long most = (n + threads - 1) / threads;
  const long long per = 4LL * maxp > threads ? 4LL * maxp : threads;
  long long want = (n + per - 1) / per;
  const long long floor_blocks = 2LL * sms;
  if (want < floor_blocks) want = floor_blocks;
  if (want > most) want = most;
  return static_cast<int>(want < 1 ? 1 : want);
}

// Opt a histogramming kernel into more than the default 48 KB of dynamic
// shared memory (H100: up to 227 KB a block) when maxp bins need it.
template <typename K>
inline cudaError_t kg_hist_smem(K kernel, int maxp) {
  const int bytes = maxp * static_cast<int>(sizeof(int32_t));
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}
