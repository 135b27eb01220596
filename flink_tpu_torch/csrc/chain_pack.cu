// G21 chain_pack — a drain's stacked fires packed into the next stage's
// edge lanes, and the next stage's coupled watermark.
//
// Replaces (flink_tpu, the JAX reference): runtime/step.py
// _chain_fires_to_lanes and _chain_stage_watermark (kernel K14), as
// _chained_stage_tail calls them once a drain for each downstream stage.
// The input is a stack of Pn = D * F fire planes (CompactFires: plane p's
// live rows are its first counts[p] of C, key halves and values, and one
// window end a plane). Every live row of a valid plane becomes one edge
// lane, in plane order then row order: (key_hi, key_lo, ts = end - 1, the
// row's value), ok = true. Lanes past the live total are zero with ok =
// false; rows past E lanes are dropped and counted. Scalars: demand (the
// live total, before the E clamp), dropped = max(demand - E, 0) and,
// when the upstream watermark is given, the coupled watermark
//   wm_j = min(up_wm, (clip(fired_through, -1, ft_cap) + 2) * slide - 2),
//   ft_cap = (2^31 - 4) / slide - 2,
// whose clamp keeps the end-of-stream jump of fired_through (~2^31 /
// slide) from wrapping int32.
//
// Bound: bytes. The E lanes are written whatever the demand (13 + 4 W
// bytes a lane), and each live row is read once (8 + 4 W bytes); the
// plane counts are a few hundred bytes. Nothing is proportional to Pn * C.
//
// Design: two launches on the caller's stream. The plan (one block of
// 1,024 threads, a thread a plane, Pn <= 1,024) clamps each plane's count
// to C (0 on an invalid plane), scans them into inclusive offsets and
// writes the scalars. The gather (a thread a lane, 256 a block) copies the
// offsets into shared memory, finds its lane's plane by a binary search
// (the first plane whose offset exceeds the lane: the reference's
// searchsorted(offs, lane + 1)) and copies the row. Values move as 32-bit
// words, so float32 and int32 values take the same path. The scan is in
// int32, as the reference's cumsum; the wrapper refuses Pn * C above
// 2^31 - 1, where it could wrap.

#include "common.cuh"

namespace {

constexpr int kPlanThreads = 1024;
constexpr int kGatherThreads = 256;

__global__ void chain_plan_kernel(const int32_t* __restrict__ counts,
                                  const uint8_t* __restrict__ lane_valid,
                                  int Pn, int C, int E,
                                  const int32_t* __restrict__ up_wm,
                                  const int32_t* __restrict__ fired_through,
                                  int slide, int32_t* __restrict__ offs,
                                  int32_t* __restrict__ scalars) {
  const int p = threadIdx.x;
  int32_t live = 0;
  if (p < Pn && lane_valid[p]) live = min(counts[p], C);
  int32_t total = 0;
  const int32_t excl = block_exclusive_scan(live, &total);
  if (p < Pn) offs[p] = excl + live;
  if (p != 0) return;
  scalars[0] = total;
  scalars[1] = max(total - E, 0);
  if (up_wm != nullptr) {
    const long long ft_cap = (2147483648LL - 4) / slide - 2;
    long long ft = *fired_through;
    ft = ft < -1 ? -1 : (ft > ft_cap ? ft_cap : ft);
    const long long horizon = (ft + 2) * slide - 2;
    const long long up = *up_wm;
    scalars[2] = static_cast<int32_t>(up < horizon ? up : horizon);
  }
}

__global__ void chain_gather_kernel(
    const int32_t* __restrict__ key_hi, const int32_t* __restrict__ key_lo,
    const uint32_t* __restrict__ values, const int32_t* __restrict__ ends,
    const int32_t* __restrict__ offs, const int32_t* __restrict__ scalars,
    int Pn, int C, int W, int E, int32_t* __restrict__ hi,
    int32_t* __restrict__ lo, int32_t* __restrict__ ts,
    uint32_t* __restrict__ vals, uint8_t* __restrict__ ok) {
  extern __shared__ int32_t s_offs[];
  for (int p = threadIdx.x; p < Pn; p += blockDim.x) s_offs[p] = offs[p];
  __syncthreads();
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= E) return;
  const int32_t total = scalars[0];
  if (e >= total) {
    hi[e] = 0;
    lo[e] = 0;
    ts[e] = 0;
    for (int w = 0; w < W; ++w) vals[e * W + w] = 0u;
    ok[e] = 0;
    return;
  }
  int a = 0, b = Pn - 1;  // the first plane whose offset exceeds e
  while (a < b) {
    const int m = (a + b) >> 1;
    if (s_offs[m] > e) b = m; else a = m + 1;
  }
  const int32_t start = a > 0 ? s_offs[a - 1] : 0;
  const long long row = static_cast<long long>(a) * C + (e - start);
  hi[e] = key_hi[row];
  lo[e] = key_lo[row];
  ts[e] = ends[a] - 1;
  for (int w = 0; w < W; ++w) vals[e * W + w] = values[row * W + w];
  ok[e] = 1;
}

}  // namespace

// ``up_wm`` / ``fired_through`` null: no watermark (scalars[2] untouched).
// ``offs`` is int32 [Pn] scratch; ``scalars`` int32 [3] (demand, dropped,
// wm_j).
extern "C" int chain_pack(const void* key_hi, const void* key_lo,
                          const void* values, const void* counts,
                          const void* lane_valid, const void* ends, int Pn,
                          int C, int W, int E, const void* up_wm,
                          const void* fired_through, int slide, void* offs,
                          void* scalars, void* hi, void* lo, void* ts,
                          void* vals, void* ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Pn > kPlanThreads) return static_cast<int>(cudaErrorInvalidValue);
  chain_plan_kernel<<<1, kPlanThreads, 0, s>>>(
      static_cast<const int32_t*>(counts),
      static_cast<const uint8_t*>(lane_valid), Pn, C, E,
      static_cast<const int32_t*>(up_wm),
      static_cast<const int32_t*>(fired_through), slide,
      static_cast<int32_t*>(offs), static_cast<int32_t*>(scalars));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || E == 0) return static_cast<int>(err);
  const int blocks = (E + kGatherThreads - 1) / kGatherThreads;
  chain_gather_kernel<<<blocks, kGatherThreads,
                        static_cast<size_t>(Pn) * sizeof(int32_t), s>>>(
      static_cast<const int32_t*>(key_hi), static_cast<const int32_t*>(key_lo),
      static_cast<const uint32_t*>(values), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(scalars), Pn, C, W, E,
      static_cast<int32_t*>(hi), static_cast<int32_t*>(lo),
      static_cast<int32_t*>(ts), static_cast<uint32_t*>(vals),
      static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}
