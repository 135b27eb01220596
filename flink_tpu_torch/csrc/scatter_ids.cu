// G23 scatter_ids — combine N lanes of values into G rows by a group id
// a lane: the batch libraries' grouped reduce and scatter.
//
// Replaces (flink_tpu, the JAX reference): ops/segment.py:183
// grouped_reduce (kernel K3: count, sum, min, max and avg over dictionary-
// encoded group ids, each a jnp ``zeros(G).at[gid].add / min / max``) and
// the scatters of the batch libraries (kernel K23): gelly/graph.py's
// degrees (:113, :117), the Sum phase of scatter_gather (:141-150, with its
// has_msg ``set``), page_rank's out-degree and contribution sums (:193,
// :198), hits' two scatters an iteration (:260, :262), community
// detection's dense score mass over dst * V + label (:290-293),
// _neighbor_reduce (:413) and _sym_adjacency's max of 1.0 (:477); and
// ml/pipeline.py KMeans' per-center sums and counts (:241-242).
//
// Contract: target [G, W] float32 comes in holding the neutral of ``op``
// (0 for add, +inf for min, -inf for max; the wrapper fills it). Each lane
// i whose id idx[i] lies in [0, G) combines vals[i, :] into row idx[i] by
// add, min or max (common.cuh combine_op: jnp's NaN and signed-zero order
// for min and max), adds 1 to counts[idx[i]] when counts is given, and
// sets has[idx[i]] when has is given. Lanes outside [0, G) are dropped
// (the reference's mode="drop"). vals may be null (a count alone).
//
// Bound: bytes. Per lane it reads the id (4 or 8 B) and W values (4 B
// each); each row of the target, counts and has is written once: at TPC-H
// Q1's 6,001,215 lineitem rows into 4 groups 48 MB (14.3 us at 3.35
// TB/s), at KMeans' 2^20 points of D = 16 68 MB.
//
// Design: the reference's shapes range from 4 groups (Q1) to 2^24 cells
// (community detection at V = 4,096). When the block's copy of the target
// (G W floats, G counts, G touch bytes) fits 48 KB of shared memory and
// the blocks' flushes cost fewer combines than the lanes, each block
// grid-strides over the lanes combining into its shared copy (shared-
// memory atomics: Q1's 6M lanes on 4 rows would otherwise serialise on
// one L2 line), then combines each row it touched into the target with
// one global atomic a column. Otherwise one thread a lane combines
// straight into the target with global atomics (common.cuh
// atomic_combine). Float sums land in another order than XLA's, as in G3:
// exact for integer-valued data whose sums stay under 2^24.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBytes = 48 * 1024;

template <typename I>
__global__ void scatter_ids_shared(
    const I* __restrict__ idx, long long N, const float* __restrict__ vals,
    int W, int G, int op, float neutral, float* __restrict__ target,
    int32_t* __restrict__ counts, uint8_t* __restrict__ has) {
  extern __shared__ float s_target[];
  const int GW = vals != nullptr ? G * W : 0;
  int32_t* s_count = reinterpret_cast<int32_t*>(s_target + GW);
  uint8_t* s_touch =
      reinterpret_cast<uint8_t*>(s_count + (counts != nullptr ? G : 0));
  for (int j = threadIdx.x; j < GW; j += blockDim.x) s_target[j] = neutral;
  if (counts != nullptr) {
    for (int g = threadIdx.x; g < G; g += blockDim.x) s_count[g] = 0;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) s_touch[g] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < N; i += stride) {
    const long long g = static_cast<long long>(idx[i]);
    if (g < 0 || g >= G) continue;
    if (vals != nullptr) {
      const float* v = vals + i * W;
      float* t = s_target + g * W;
      for (int w = 0; w < W; ++w) atomic_combine(t + w, v[w], op);
    }
    if (counts != nullptr) atomicAdd(&s_count[g], 1);
    s_touch[g] = 1;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    if (!s_touch[g]) continue;
    if (vals != nullptr) {
      for (int w = 0; w < W; ++w) {
        atomic_combine(target + static_cast<long long>(g) * W + w,
                       s_target[g * W + w], op);
      }
    }
    if (counts != nullptr) atomicAdd(&counts[g], s_count[g]);
    if (has != nullptr) has[g] = 1;
  }
}

template <typename I>
__global__ void scatter_ids_global(
    const I* __restrict__ idx, long long N, const float* __restrict__ vals,
    int W, long long G, int op, float* __restrict__ target,
    int32_t* __restrict__ counts, uint8_t* __restrict__ has) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const long long g = static_cast<long long>(idx[i]);
  if (g < 0 || g >= G) return;
  if (vals != nullptr) {
    const float* v = vals + i * W;
    float* t = target + g * W;
    for (int w = 0; w < W; ++w) atomic_combine(t + w, v[w], op);
  }
  if (counts != nullptr) atomicAdd(&counts[g], 1);
  if (has != nullptr && has[g] == 0) has[g] = 1;
}

template <typename I>
cudaError_t launch(const I* idx, long long N, const float* vals, int W,
                   long long G, int op, float neutral, float* target,
                   int32_t* counts, uint8_t* has, cudaStream_t st) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long lane_blocks = (N + kThreads - 1) / kThreads;
  long long blocks = 2LL * sms;
  if (blocks > lane_blocks) blocks = lane_blocks;
  const long long cols = vals != nullptr ? W : 0;
  const long long smem = G * cols * 4 + (counts != nullptr ? G * 4 : 0) + G;
  if (smem <= kSharedBytes && G * (cols > 0 ? cols : 1) * blocks <= N) {
    scatter_ids_shared<I><<<static_cast<int>(blocks), kThreads,
                            static_cast<size_t>(smem), st>>>(
        idx, N, vals, W, static_cast<int>(G), op, neutral, target, counts,
        has);
  } else {
    scatter_ids_global<I><<<static_cast<unsigned int>(lane_blocks), kThreads,
                            0, st>>>(idx, N, vals, W, G, op, target, counts,
                                     has);
  }
  return cudaGetLastError();
}

}  // namespace

// idx_bytes 4 (int32 ids) or 8 (int64); vals, counts and has may be null
// (target too when vals is); op 0 add, 1 min, 2 max.
extern "C" int scatter_ids(const void* idx, int idx_bytes, long long N,
                           const void* vals, int W, long long G, int op,
                           float neutral, void* target, void* counts,
                           void* has, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0 || G == 0) return static_cast<int>(cudaGetLastError());
  const float* v = static_cast<const float*>(vals);
  float* t = static_cast<float*>(target);
  int32_t* c = static_cast<int32_t*>(counts);
  uint8_t* h = static_cast<uint8_t*>(has);
  cudaError_t e =
      idx_bytes == 8
          ? launch(static_cast<const long long*>(idx), N, v, W, G, op,
                   neutral, t, c, h, st)
          : launch(static_cast<const int32_t*>(idx), N, v, W, G, op,
                   neutral, t, c, h, st);
  return static_cast<int>(e);
}
