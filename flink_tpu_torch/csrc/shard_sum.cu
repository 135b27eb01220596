// G27 shard_sum — the cross-shard sum of the rolling reduce's masked
// per-lane outputs: out = sum over shards s (in index order) of
// where(valid_s, out_s, 0), and valid = OR over shards of valid_s.
//
// Replaces (flink_tpu, the JAX reference): runtime/step.py:2612-2617, the
// psum of build_rolling_step over the `shards` mesh axis (kernel K18's
// cross-shard half): each shard masks its outputs to the lanes it owns,
// lax.psum adds the masked outputs and the int32 valid flags (> 0 is the
// OR). The port stages the n shards' outputs on one device and sums them
// here (parallel/collectives.py psum).
//
// The sum runs in shard index order starting from shard 0's masked value,
// as the plain version (ops/cuda.py shard_sum_plain) adds, so the two
// agree bit for bit; a lane is owned by one shard, so every other term is
// +0.0.
//
// Bound: bytes. It reads n shards' [B, W] float32 outputs and [B] valid
// bytes once and writes one [B, W] and one [B]: at the rolling job's B =
// 262,144, W = 1 and n = 4, 5.5 MB, 1.6 us at 3.35 TB/s.
//
// Design: one thread a lane (its W words in a loop), the n shard pointers
// passed by value in the launch's parameters, reads of neighbouring lanes
// by neighbouring threads (coalesced).

#include "common.cuh"

namespace {

constexpr int kMaxShards = 64;     // ops/cuda.py SHARD_SUM_MAX_SHARDS

struct ShardPtrs {
  const float* out[kMaxShards];
  const uint8_t* valid[kMaxShards];
};

__global__ void shard_sum_kernel(ShardPtrs p, int n, int B, int W,
                                 float* __restrict__ out,
                                 uint8_t* __restrict__ valid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  bool any = false;
  for (int w = 0; w < W; ++w) {
    const long long j = static_cast<long long>(i) * W + w;
    float acc = 0.0f;
    for (int s = 0; s < n; ++s) {
      const bool v = p.valid[s][i] != 0;
      const float x = v ? p.out[s][j] : 0.0f;
      acc = s == 0 ? x : acc + x;
      any = any || v;
    }
    out[j] = acc;
  }
  valid[i] = any ? 1 : 0;
}

}  // namespace

extern "C" int shard_sum(const void* const* outs, const void* const* valids,
                         int n, int B, int W, void* out, void* valid,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  ShardPtrs p;
  for (int s = 0; s < n; ++s) {
    p.out[s] = static_cast<const float*>(outs[s]);
    p.valid[s] = static_cast<const uint8_t*>(valids[s]);
  }
  const int threads = 256;
  shard_sum_kernel<<<(B + threads - 1) / threads, threads, 0, st>>>(
      p, n, B, W, static_cast<float*>(out), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}
