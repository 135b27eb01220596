// G24 sorted_probe — the probe of a broadcast hash join on one shard: each
// probe key found by binary search in the sorted unique build keys.
//
// Replaces (flink_tpu, the JAX reference): parallel/broadcast.py:55-61
// (the shard body of build_broadcast_join_step, kernel K21) as
// broadcast_join (:77-96) runs it on one shard: pos = searchsorted(tkeys,
// key) (side left), clamped to K - 1; hit = tkeys[pos] == key; joined =
// tvals[pos] where hit, else 0. The DataSet's broadcast-hash join
// (dataset/dataset.py _device_broadcast_join) probes through it with
// tvals = the build rows' positions.
//
// Keys are int64 on both sides and compared as int64 on the card (the
// reference's keys are genuine int64: the DataSet refuses others before
// it gets here).
//
// Bound: bytes. Per probe it reads its key (8 B) and writes pos (4 B), hit
// (1 B) and joined (4 B); the build side (K <= 10,000 keys and values, the
// DataSet's broadcast threshold) is read once: at 1,000,000 probes 17 MB,
// 5.1 us at 3.35 TB/s.
//
// Design: one thread a probe, a binary search of ceil(log2 (K + 1))
// steps over the build keys in global memory: at K =
// 10,000 they are 80 KB, which the first probes bring into L2 (and each
// SM's L1) for all the others, so the search reads cached lines.

#include "common.cuh"

namespace {

__global__ void sorted_probe_kernel(const long long* __restrict__ keys,
                                    int B, const long long* __restrict__ tkeys,
                                    int K, const float* __restrict__ tvals,
                                    int32_t* __restrict__ pos,
                                    uint8_t* __restrict__ hit,
                                    float* __restrict__ joined) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const long long k = keys[i];
  int lo = 0, hi = K;  // first j with tkeys[j] >= k
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(&tkeys[mid]) < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int p = lo < K ? lo : K - 1;
  const bool h = K > 0 && __ldg(&tkeys[p]) == k;
  pos[i] = p < 0 ? 0 : p;
  hit[i] = h ? 1 : 0;
  joined[i] = h ? __ldg(&tvals[p]) : 0.0f;
}

}  // namespace

extern "C" int sorted_probe(const void* keys, int B, const void* tkeys,
                            int K, const void* tvals, void* pos, void* hit,
                            void* joined, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  sorted_probe_kernel<<<(B + threads - 1) / threads, threads, 0, st>>>(
      static_cast<const long long*>(keys), B,
      static_cast<const long long*>(tkeys), K,
      static_cast<const float*>(tvals), static_cast<int32_t*>(pos),
      static_cast<uint8_t*>(hit), static_cast<float*>(joined));
  return static_cast<int>(cudaGetLastError());
}
