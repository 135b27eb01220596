// Shared helpers of the window-path kernels (route_lanes.cu, clear_rows.cu,
// scatter_update.cu, fire_reduced.cu, hash_upsert.cu, fire_compact.cu,
// sketch_update.cu, sketch_fire.cu and the rest of csrc/):
// int32 pane arithmetic with the reference's floor semantics, block-wide
// reductions that end in one atomic per block, a block-wide scan, and the
// float min / max combines of the min and max reduces.
#pragma once

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

// flink_tpu/ops/window_kernels.py PANE_NONE: the "no pane" sentinel.
constexpr int32_t kPaneNone = INT32_MIN + 1;

// floor(a / b) for b > 0, also for negative a (jnp.floor_divide).
__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
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

// *p = combine(*p, v), atomically. Add is the hardware float atomicAdd;
// min and max loop on a 32-bit atomicCAS, leaving at once when the cell
// already holds the result (a hot key's repeated max costs one load).
__device__ __forceinline__ void atomic_combine(float* p, float v, int op) {
  if (op == 0) {
    atomicAdd(p, v);
    return;
  }
  unsigned int* q = reinterpret_cast<unsigned int*>(p);
  unsigned int old = *q;
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
