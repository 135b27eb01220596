// G10 segment_sort — a stable sort of B lanes by a 64-bit key, with the
// segment flags of the sorted order.
//
// Replaces (flink_tpu, the JAX reference): ops/segment.py argsort_ids (:71,
// jnp.argsort, stable), segment_sort (:89) and the two stable sorts of
// ops/session_windows.py _lexsort_slot_ts (:78-82), all in kernel family K3.
// ops/segment.py (the port's) builds the key: the state slot, with dead
// lanes given the slot C so they sort last (rolling and count windows), or
// (slot << 32) | (ts ^ 0x80000000) with dead lanes (C << 32) for sessions,
// so one sort orders by (slot, ts) and keeps lane order among equal keys,
// as the reference's two stable sorts do.
//
// Outputs: order (int32 [B], the gather permutation), key_s (the sorted
// keys) and seg_start (uint8 [B]: lane 0, and every lane whose key >>
// seg_shift differs from the lane before).
//
// Design: an LSD radix sort over 8-bit digits, ceil(bits / 8) passes, each
// three launches: (1) every tile of kSortTile lanes counts its digits;
// (2) one block scans the counts in (digit, tile) order into each tile's
// first output position per digit (each warp a contiguous run of them),
// and marks the pass as skippable when one digit holds every lane; (3)
// every tile scatters its lanes stably: in rounds of 256 lanes, each
// lane's rank among the round's lanes of its digit comes from
// __match_any_sync within its warp plus the counts of the warps before it,
// on top of the tile's running count of that digit. A skipped pass copies
// (a digit that is the same in every lane, as the high bits of a batch's
// ticks are, leaves the order as it is). Passes ping-pong between the
// outputs and scratch so that the last one lands in the outputs.
//
// Bound: bytes. The least is the key read once and the order, sorted key
// and flag written once, 21 B a lane: 5.5 MB, 1.6 us at 3.35 TB/s for
// 262,144 lanes. Each pass here reads the keys and indices twice (count
// and scatter) and writes them once, 36 B a lane, and its scan and
// scatter are one block each per SM or fewer: a slot sort at C = 2^22 (23
// bits, 3 passes) is bound by its launches and barriers, not its bytes.

#include "common.cuh"

namespace {

constexpr int kSortThreads = 256;   // one digit per thread in the scan steps
constexpr int kItems = 8;
constexpr int kSortTile = kSortThreads * kItems;   // ops/cuda.py SORT_TILE
constexpr int kWarps = kSortThreads / 32;

__global__ void sort_hist_kernel(const unsigned long long* __restrict__ keys,
                                 int n, int shift, int n_tiles,
                                 int32_t* __restrict__ hist) {
  __shared__ int32_t h[256];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int start = blockIdx.x * kSortTile;
  const int end = min(start + kSortTile, n);
  for (int i = start + threadIdx.x; i < end; i += kSortThreads) {
    atomicAdd(&h[(keys[i] >> shift) & 255u], 1);
  }
  __syncthreads();
  hist[threadIdx.x * n_tiles + blockIdx.x] = h[threadIdx.x];
}

// one block of 1024 threads: the exclusive scan of the [256][n_tiles]
// counts `hist`, in (digit, tile) order, into `off`. Each warp takes a
// contiguous run of the counts and reads it twice, coalesced: once to sum
// it, and, after one scan of the warps' sums, once to scan it. The scan is
// out of place so that the reads of a run do not wait on its writes.
// *skip = 1 when one digit holds all n lanes.
__global__ void sort_scan_kernel(const int32_t* __restrict__ hist,
                                 int32_t* __restrict__ off, int n_tiles, int n,
                                 int32_t* skip) {
  __shared__ int32_t wbase[32];
  __shared__ int32_t any;
  const int m = 256 * n_tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int per = (m + n_warps - 1) / n_warps;
  const int lo = min(m, warp * per), hi = min(m, lo + per);
  int32_t sum = 0;
#pragma unroll 8
  for (int j = lo + lane; j < hi; j += 32) sum += hist[j];
  sum = warp_sum(sum);
  if (lane == 0) wbase[warp] = sum;
  if (threadIdx.x == 0) any = 0;
  __syncthreads();
  if (warp == 0) {
    const int32_t v = lane < n_warps ? wbase[lane] : 0;
    int32_t x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane < n_warps) wbase[lane] = x - v;
  }
  __syncthreads();
  int32_t run = wbase[warp];
#pragma unroll 4
  for (int j0 = lo; j0 < hi; j0 += 32) {  // uniform across the warp
    const int j = j0 + lane;
    const int32_t v = j < hi ? hist[j] : 0;
    int32_t x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (j < hi) off[j] = run + x - v;
    run += __shfl_sync(0xffffffffu, x, 31);
  }
  __syncthreads();
  if (threadIdx.x < 256) {
    const int d = threadIdx.x;
    const int32_t first = off[d * n_tiles];
    const int32_t next = d == 255 ? n : off[(d + 1) * n_tiles];
    if (next - first == n) any = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) *skip = any;
}

__global__ void sort_scatter_kernel(const unsigned long long* __restrict__ kin,
                                    const int32_t* __restrict__ iin, int n,
                                    int shift, int n_tiles,
                                    const int32_t* __restrict__ off,
                                    const int32_t* __restrict__ skip,
                                    unsigned long long* __restrict__ kout,
                                    int32_t* __restrict__ iout) {
  const int start = blockIdx.x * kSortTile;
  const int end = min(start + kSortTile, n);
  if (*skip) {
    for (int i = start + threadIdx.x; i < end; i += kSortThreads) {
      kout[i] = kin[i];
      iout[i] = iin != nullptr ? iin[i] : i;
    }
    return;
  }
  __shared__ int32_t run[256];         // the tile's lanes placed, per digit
  __shared__ int32_t base[256];        // the tile's first position, per digit
  __shared__ int32_t wcnt[kWarps][256];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  run[t] = 0;
  base[t] = off[t * n_tiles + blockIdx.x];
  for (int i0 = start; i0 < end; i0 += kSortThreads) {  // uniform trip count
    const int i = i0 + t;
    const bool in = i < end;
    const unsigned long long k = in ? kin[i] : 0ull;
    const int d = in ? static_cast<int>((k >> shift) & 255u) : 256;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wcnt[w][t] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (in && rank == 0) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    int32_t acc = run[t];  // thread t: the prefix of digit t over the warps
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = wcnt[w][t];
      wcnt[w][t] = acc;
      acc += c;
    }
    run[t] = acc;
    __syncthreads();
    if (in) {
      const int32_t pos = base[d] + wcnt[warp][d] + rank;
      kout[pos] = k;
      iout[pos] = iin != nullptr ? iin[i] : i;
    }
    __syncthreads();  // wcnt[] is cleared by the next round
  }
}

__global__ void sort_flags_kernel(const unsigned long long* __restrict__ key_s,
                                  int n, int seg_shift,
                                  uint8_t* __restrict__ seg_start) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  seg_start[i] = i == 0 || (key_s[i] >> seg_shift) != (key_s[i - 1] >> seg_shift);
}

}  // namespace

// keys: uint64 [n], each < 2^bits; scratch: kalt uint64 [n], ialt int32 [n],
// hist int32 [2 * 256 * ceil(n / kSortTile)] (the counts, then their scan),
// skip int32 [ceil(bits / 8)].
extern "C" int segment_sort(const void* keys, int n, int bits, int seg_shift,
                            void* order, void* key_s, void* seg_start,
                            void* kalt, void* ialt, void* hist, void* skip,
                            void* stream) {
  if (bits < 1 || bits > 64 || seg_shift < 0 || seg_shift > 63) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pass = (bits + 7) / 8;
  const int n_tiles = (n + kSortTile - 1) / kSortTile;
  auto* kbuf0 = static_cast<unsigned long long*>(key_s);
  auto* ibuf0 = static_cast<int32_t*>(order);
  auto* kbuf1 = static_cast<unsigned long long*>(kalt);
  auto* ibuf1 = static_cast<int32_t*>(ialt);
  auto* h = static_cast<int32_t*>(hist);
  auto* sk = static_cast<int32_t*>(skip);
  const unsigned long long* kin = static_cast<const unsigned long long*>(keys);
  const int32_t* iin = nullptr;  // the first pass reads lane i as index i
  for (int p = 0; p < n_pass; ++p) {
    // the last pass writes the outputs: pass p writes them when
    // n_pass - 1 - p is even
    const bool to_out = ((n_pass - 1 - p) & 1) == 0;
    unsigned long long* kout = to_out ? kbuf0 : kbuf1;
    int32_t* iout = to_out ? ibuf0 : ibuf1;
    const int shift = 8 * p;
    sort_hist_kernel<<<n_tiles, kSortThreads, 0, s>>>(kin, n, shift, n_tiles, h);
    sort_scan_kernel<<<1, 1024, 0, s>>>(h, h + 256 * n_tiles, n_tiles, n,
                                        sk + p);
    sort_scatter_kernel<<<n_tiles, kSortThreads, 0, s>>>(
        kin, iin, n, shift, n_tiles, h + 256 * n_tiles, sk + p, kout, iout);
    kin = kout;
    iin = iout;
  }
  sort_flags_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      kbuf0, n, seg_shift, static_cast<uint8_t*>(seg_start));
  return static_cast<int>(cudaGetLastError());
}
