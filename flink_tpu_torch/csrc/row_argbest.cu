// G25 row_argbest — the best column of every row of a dense [N, K] float32
// matrix: KMeans' nearest center (row_argmin) and community detection's
// adopted label (row_argmax).
//
// Replaces (flink_tpu, the JAX reference), kernel K23:
// - ml/pipeline.py:230-237 (KMeans.fit's assign) and :252-259 (predict):
//   d = (|x|^2 - 2 P) + |c|^2 with P = X @ C^T, then jnp.argmin(d, axis=1).
//   row_argmin reads P (from torch.matmul), xx [N] and cc [K] and
//   computes each distance in that order with round-to-nearest float
//   operations the compiler may not contract into an FMA, so a distance
//   equals XLA's for the same P.
// - gelly/graph.py:293-300 (community_detection's superstep): best =
//   argmax(m, axis=1), best_mass = max(m, axis=1), has = best_mass > 0;
//   new label = best where has, else the old label; new score =
//   max(best_mass * delta, 1e-6) where has, else the old score.
//   row_argmax writes the new labels and scores.
//
// Ties go to the first column, and NaN follows jnp.argmin / jnp.argmax: a
// NaN beats every number, and the first NaN wins (so the row's max is NaN
// when one is there, as jnp.max gives). better_min / better_max are a
// strict total order on (value, column), so the best of any split of a
// row's columns, merged in any order, is the row's best.
//
// Bound: bytes. The matrix is read once (4 N K bytes) with a few bytes a
// row around it: KMeans' assignment at N = 2^20, K = 64 reads 268 MB (80
// us at 3.35 TB/s); community detection at V = 4,096 reads 67 MB (20 us),
// more than the L2 holds, so it streams from HBM.
//
// Design. row_argmin: one warp a row (K = 64: two columns a lane), its
// lanes striding along the row; each lane keeps its best (value, column),
// then five shuffles reduce the warp. row_argmax: enough bytes in flight
// to read HBM at its rate. A row of K >= kBlockRowK columns takes a whole
// block of 8 warps (V = 4,096: 4,096 blocks, 32,768 warps), a shorter row
// a warp. Each thread issues kSlots independent loads before it compares,
// 16-byte float4 loads where the rows are 16-byte aligned (K % 4 == 0 and
// an aligned base; scalar loads otherwise), and keeps one (value, column)
// candidate a slot, so no compare waits on the one before across slots.
// The slots merge, then the warp by shuffles, then the warps through
// shared memory; the first thread writes the epilogue.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // a block: 8 rows a warp each, or one row

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// Is (a, ia) a better minimum than (b, ib)?
__device__ __forceinline__ bool better_min(float a, int ia, float b, int ib) {
  if (is_nan(a)) return !is_nan(b) || ia < ib;
  if (is_nan(b)) return false;
  return a < b || (a == b && ia < ib);
}

// Is (a, ia) a better maximum than (b, ib)?
__device__ __forceinline__ bool better_max(float a, int ia, float b, int ib) {
  if (is_nan(a)) return !is_nan(b) || ia < ib;
  if (is_nan(b)) return false;
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_min(float* v, int* i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, *v, off);
    const int oi = __shfl_down_sync(0xffffffffu, *i, off);
    const bool take = oi >= 0 && (*i < 0 || better_min(ov, oi, *v, *i));
    if (take) {
      *v = ov;
      *i = oi;
    }
  }
}

__global__ void row_argmin_kernel(const float* __restrict__ P, int N, int K,
                                  const float* __restrict__ xx,
                                  const float* __restrict__ cc,
                                  long long* __restrict__ out) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // uniform across the warp
  const float* p = P + row * K;
  const float x = xx[row];
  float best = 0.0f;
  int bi = -1;
  for (int j = lane; j < K; j += 32) {
    const float d = __fadd_rn(__fsub_rn(x, __fmul_rn(2.0f, p[j])), cc[j]);
    if (bi < 0 || better_min(d, j, best, bi)) {
      best = d;
      bi = j;
    }
  }
  warp_min(&best, &bi);
  if (lane == 0) out[row] = bi;
}

constexpr int kSlots = 4;         // independent loads in flight a thread
constexpr int kBlockRowK = 1024;  // rows this long take a block each

// (best, bi) = (v, j) where (v, j) is the better maximum
__device__ __forceinline__ void take_max(float v, int j, float* best,
                                         int* bi) {
  if (better_max(v, j, *best, *bi)) {
    *best = v;
    *bi = j;
  }
}

// kTpr threads a row: 32 (a warp) or kThreads (the block). A slot's
// first candidate is (-inf, INT_MAX), which every column beats.
template <int kTpr>
__global__ void __launch_bounds__(kThreads)
    row_argmax_kernel(const float* __restrict__ m, int N, int K, bool vec,
                      const float* __restrict__ labels,
                      const float* __restrict__ scores, float delta,
                      float* __restrict__ new_labels,
                      float* __restrict__ new_scores) {
  constexpr int kRows = kThreads / kTpr;
  const int sub = threadIdx.x % kTpr;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRows + threadIdx.x / kTpr;
  if (row >= N) return;  // uniform across a row's threads
  const float* r = m + row * K;
  const float neg_inf = __uint_as_float(0xff800000u);
  float best[kSlots];
  int bi[kSlots];
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    best[u] = neg_inf;
    bi[u] = INT_MAX;
  }
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(r);
    const int K4 = K >> 2;
    for (int j0 = sub; j0 < K4; j0 += kSlots * kTpr) {
      float4 q[kSlots];
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int j = j0 + u * kTpr;
        if (j < K4) q[u] = __ldg(r4 + j);
      }
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int j = 4 * (j0 + u * kTpr);
        if (j < K) {
          take_max(q[u].x, j, &best[u], &bi[u]);
          take_max(q[u].y, j + 1, &best[u], &bi[u]);
          take_max(q[u].z, j + 2, &best[u], &bi[u]);
          take_max(q[u].w, j + 3, &best[u], &bi[u]);
        }
      }
    }
  } else {
    for (int j0 = sub; j0 < K; j0 += kSlots * kTpr) {
      float q[kSlots];
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int j = j0 + u * kTpr;
        if (j < K) q[u] = __ldg(r + j);
      }
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int j = j0 + u * kTpr;
        if (j < K) take_max(q[u], j, &best[u], &bi[u]);
      }
    }
  }
#pragma unroll
  for (int u = 1; u < kSlots; ++u) take_max(best[u], bi[u], &best[0], &bi[0]);
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best[0], off);
    const int oi = __shfl_down_sync(0xffffffffu, bi[0], off);
    take_max(ov, oi, &best[0], &bi[0]);
  }
  if constexpr (kTpr > 32) {
    __shared__ float s_v[kTpr / 32];
    __shared__ int s_i[kTpr / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
      s_v[warp] = best[0];
      s_i[warp] = bi[0];
    }
    __syncthreads();
    if (warp != 0) return;
    best[0] = lane < kTpr / 32 ? s_v[lane] : neg_inf;
    bi[0] = lane < kTpr / 32 ? s_i[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best[0], off);
      const int oi = __shfl_down_sync(0xffffffffu, bi[0], off);
      take_max(ov, oi, &best[0], &bi[0]);
    }
  }
  if (sub == 0) {
    const bool has = best[0] > 0.0f;  // false for NaN
    new_labels[row] = has ? static_cast<float>(bi[0]) : labels[row];
    new_scores[row] =
        has ? jnp_max(__fmul_rn(best[0], delta), 1e-6f) : scores[row];
  }
}

int blocks_for(int N) {
  const long long threads = static_cast<long long>(N) * 32;
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int row_argmin(const void* P, int N, int K, const void* xx,
                          const void* cc, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  row_argmin_kernel<<<blocks_for(N), kThreads, 0, st>>>(
      static_cast<const float*>(P), N, K, static_cast<const float*>(xx),
      static_cast<const float*>(cc), static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int row_argmax(const void* m, int N, int K, const void* labels,
                          const void* scores, float delta, void* new_labels,
                          void* new_scores, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* mm = static_cast<const float*>(m);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0;
  const auto* l = static_cast<const float*>(labels);
  const auto* sc = static_cast<const float*>(scores);
  auto* nl = static_cast<float*>(new_labels);
  auto* ns = static_cast<float*>(new_scores);
  if (K >= kBlockRowK) {
    row_argmax_kernel<kThreads><<<N, kThreads, 0, st>>>(mm, N, K, vec, l, sc,
                                                         delta, nl, ns);
  } else {
    row_argmax_kernel<32><<<blocks_for(N), kThreads, 0, st>>>(
        mm, N, K, vec, l, sc, delta, nl, ns);
  }
  return static_cast<int>(cudaGetLastError());
}
