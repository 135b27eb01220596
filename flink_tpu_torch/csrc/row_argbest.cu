// G25 row_argbest — the best column of every row of a dense [N, K] float32
// matrix, a warp a row: KMeans' nearest center (row_argmin) and community
// detection's adopted label (row_argmax).
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
// when one is there, as jnp.max gives).
//
// Bound: bytes. The matrix is read once (4 N K bytes) with a few bytes a
// row around it: KMeans' assignment at N = 2^20, K = 64 reads 268 MB (80
// us at 3.35 TB/s); community detection at V = 4,096 reads 67 MB (20 us).
//
// Design: one warp a row. Its 32 lanes stride along the row, so a warp
// reads 128 contiguous bytes a step; each lane keeps its best (value,
// column), strictly better only, then five shuffles reduce the warp's 32
// candidates with the column as the tie-break. Rows of 64 columns give a
// lane two elements; rows of 4,096 give 128.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 rows a block

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

template <bool kMin>
__device__ __forceinline__ void warp_best(float* v, int* i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, *v, off);
    const int oi = __shfl_down_sync(0xffffffffu, *i, off);
    const bool take = oi >= 0 && (*i < 0 || (kMin ? better_min(ov, oi, *v, *i)
                                                  : better_max(ov, oi, *v, *i)));
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
  warp_best<true>(&best, &bi);
  if (lane == 0) out[row] = bi;
}

__global__ void row_argmax_kernel(const float* __restrict__ m, int N, int K,
                                  const float* __restrict__ labels,
                                  const float* __restrict__ scores,
                                  float delta, float* __restrict__ new_labels,
                                  float* __restrict__ new_scores) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const float* r = m + row * K;
  float best = 0.0f;
  int bi = -1;
  for (int j = lane; j < K; j += 32) {
    const float v = r[j];
    if (bi < 0 || better_max(v, j, best, bi)) {
      best = v;
      bi = j;
    }
  }
  warp_best<false>(&best, &bi);
  if (lane == 0) {
    const bool has = best > 0.0f;  // false for NaN
    new_labels[row] = has ? static_cast<float>(bi) : labels[row];
    new_scores[row] =
        has ? jnp_max(__fmul_rn(best, delta), 1e-6f) : scores[row];
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
  row_argmax_kernel<<<blocks_for(N), kThreads, 0, st>>>(
      static_cast<const float*>(m), N, K, static_cast<const float*>(labels),
      static_cast<const float*>(scores), delta,
      static_cast<float*>(new_labels), static_cast<float*>(new_scores));
  return static_cast<int>(cudaGetLastError());
}
