// G26 exchange_pack — the bucket step of the keyed record exchange: one
// source shard's lanes packed into [n_shards * cap] send buffers, lane by
// owning shard, each lane at its stable rank within its target bucket.
//
// Replaces (flink_tpu, the JAX reference): parallel/exchange.py:49-96
// exchange_records up to the all_to_all (kernel K12): kg = assign_to_key_
// group(route_hash(hi, lo)); tgt = kg * n // maxp; pos = the lane's rank
// among the valid lanes of its target (a per-target cumsum, which keeps
// lane order); lanes with pos < cap scattered to [tgt * cap + pos] of
// zero-filled buffers (hi, lo, ts, the values' W words a lane, valid);
// the valid lanes past cap counted as overflow. The ranks are stable, so
// the lanes a target receives keep the source's lane order, and the
// update downstream accumulates in the reference's order.
//
// Bound: bytes. It reads each lane once (hi, lo, ts: 12 B, W words, the
// valid byte) and writes each of the n * cap send lanes once (12 + 4 W + 1
// B): at the north star's shapes (B / n = 65,536 lanes, n = 4, cap =
// 32,768, W = 1) about 3.3 MB, 1.0 us at 3.35 TB/s, under the launches'
// own cost: two launches of a few microseconds each.
//
// Design: pass 1 counts each block's valid lanes per target in shared
// memory (1,024 lanes a block) into counts[block][t]. Pass 2 gives each
// block the base of every target (the counts of the blocks before it) and
// the totals; a warp ranks its lanes among equal targets with
// __match_any_sync, the warps' per-target counts are scanned in shared
// memory, and each lane writes its row at base + the warps before it +
// its rank in the warp. The same blocks then zero each bucket's slots past
// its fill (grid-stride), so every send lane is written exactly once and
// the buffers need no memset. The overflow count is a block sum and one
// atomic a block (pass 1 zeroes it).

#include "common.cuh"

namespace {

constexpr int kLanes = 1024;       // lanes (and threads) a block
constexpr int kWarps = kLanes / 32;
constexpr int kMaxShards = 256;    // ops/cuda.py EXCHANGE_MAX_SHARDS

__device__ __forceinline__ int target_of(uint32_t hi, uint32_t lo, int maxp,
                                         int n) {
  const int32_t kg = key_group(hi, lo, maxp);
  return static_cast<int>((static_cast<long long>(kg) * n) / maxp);
}

__global__ void exchange_count_kernel(const uint32_t* __restrict__ hi,
                                      const uint32_t* __restrict__ lo,
                                      const uint8_t* __restrict__ valid,
                                      int B, int n, int maxp,
                                      int32_t* __restrict__ counts,
                                      int32_t* __restrict__ overflow) {
  __shared__ int32_t c[kMaxShards];
  for (int t = threadIdx.x; t < n; t += blockDim.x) c[t] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *overflow = 0;
  __syncthreads();
  const int i = blockIdx.x * kLanes + threadIdx.x;
  if (i < B && valid[i]) atomicAdd(&c[target_of(hi[i], lo[i], maxp, n)], 1);
  __syncthreads();
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    counts[blockIdx.x * n + t] = c[t];
}

__global__ void exchange_scatter_kernel(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const int32_t* __restrict__ ts, const uint32_t* __restrict__ vals,
    const uint8_t* __restrict__ valid, int B, int W, int n, int maxp,
    int cap, const int32_t* __restrict__ counts, uint32_t* __restrict__ s_hi,
    uint32_t* __restrict__ s_lo, int32_t* __restrict__ s_ts,
    uint32_t* __restrict__ s_vals, uint8_t* __restrict__ s_valid,
    int32_t* __restrict__ overflow) {
  __shared__ int32_t base[kMaxShards];
  __shared__ int32_t total[kMaxShards];
  __shared__ int32_t wc[kWarps][kMaxShards];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    int32_t before = 0, all = 0;
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b) {
      const int32_t v = counts[b * n + t];
      if (b < static_cast<int>(blockIdx.x)) before += v;
      all += v;
    }
    base[t] = before;
    total[t] = all;
  }
  for (int j = threadIdx.x; j < kWarps * n; j += blockDim.x)
    wc[j / n][j % n] = 0;
  __syncthreads();

  const int i = blockIdx.x * kLanes + threadIdx.x;
  const bool live = i < B && valid[i] != 0;
  const int tgt = live ? target_of(hi[i], lo[i], maxp, n) : -1;
  // the lanes of this warp that share the lane's target (or its dead-ness)
  const unsigned same = __match_any_sync(0xffffffffu, tgt);
  const unsigned below = same & ((1u << lane) - 1u);
  const int rank = __popc(below);
  if (live && below == 0) wc[warp][tgt] = __popc(same);  // the group leader
  __syncthreads();
  // exclusive scan over the warps, per target (thread t owns target t)
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    int32_t run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int32_t v = wc[w][t];
      wc[w][t] = run;
      run += v;
    }
  }
  __syncthreads();

  int32_t over = 0;
  if (live) {
    const int pos = base[tgt] + wc[warp][tgt] + rank;
    if (pos < cap) {
      const long long d = static_cast<long long>(tgt) * cap + pos;
      s_hi[d] = hi[i];
      s_lo[d] = lo[i];
      s_ts[d] = ts[i];
      for (int w = 0; w < W; ++w)
        s_vals[d * W + w] = vals[static_cast<long long>(i) * W + w];
      s_valid[d] = 1;
    } else {
      over = 1;
    }
  }
  const int32_t blk = block_sum(over);
  if (threadIdx.x == 0 && blk) atomicAdd(overflow, blk);

  // zero every bucket slot past its fill (written by no lane above)
  const long long slots = static_cast<long long>(n) * cap;
  for (long long d = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       d < slots; d += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int t = static_cast<int>(d / cap);
    const int p = static_cast<int>(d - static_cast<long long>(t) * cap);
    if (p < total[t]) continue;
    s_hi[d] = 0;
    s_lo[d] = 0;
    s_ts[d] = 0;
    for (int w = 0; w < W; ++w) s_vals[d * W + w] = 0;
    s_valid[d] = 0;
  }
}

}  // namespace

extern "C" int exchange_pack(const void* hi, const void* lo, const void* ts,
                             const void* vals, const void* valid, int B,
                             int W, int n, int maxp, int cap, void* counts,
                             void* s_hi, void* s_lo, void* s_ts,
                             void* s_vals, void* s_valid, void* overflow,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = B > 0 ? (B + kLanes - 1) / kLanes : 1;
  exchange_count_kernel<<<blocks, kLanes, 0, st>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const uint8_t*>(valid), B, n, maxp,
      static_cast<int32_t*>(counts), static_cast<int32_t*>(overflow));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  exchange_scatter_kernel<<<blocks, kLanes, 0, st>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const int32_t*>(ts), static_cast<const uint32_t*>(vals),
      static_cast<const uint8_t*>(valid), B, W, n, maxp, cap,
      static_cast<const int32_t*>(counts), static_cast<uint32_t*>(s_hi),
      static_cast<uint32_t*>(s_lo), static_cast<int32_t*>(s_ts),
      static_cast<uint32_t*>(s_vals), static_cast<uint8_t*>(s_valid),
      static_cast<int32_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}
