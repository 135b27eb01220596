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
// 32,768, W = 1) about 3.3 MB, 1.0 us at 3.35 TB/s, under a launch's own
// cost.
//
// Design: one cooperative launch a call (the grid at most the blocks the
// card holds at once), no fill. Each block owns a contiguous run of
// lanes, taken in passes of 256 (one lane a thread). Before it waits, a
// block loads the lanes of its first kHeld passes at once (valid, hi, lo,
// ts and, at W = 1, the value) and keeps them in registers, computes each
// lane's target once, ranks it among the lanes of its warp with the same
// target (__match_any_sync) and scans the warps' group counts per target
// in shared memory into a rank within the block (the target and rank kept
// in shared memory, a word a lane). It publishes its count a target as a
// word tagged with the call (the tag a count of calls in the scratch, as
// lookback.cuh's, so the scratch is zeroed once and never cleared). Then
// every block reads every block's tagged counts, the warps split among
// the targets, each lane with kBatch loads in flight: the counts of the
// blocks before it give its bases, all of them the totals. The reads are
// the grid's barrier: a block goes on once every block has published. So
// the rows go straight to their slots from registers, and the slots past
// each bucket's fill are zeroed by 16-byte stores, each bucket's span
// split among the blocks into stripes (no divide a slot). Block 0 writes
// the overflow (the totals past cap) and, having seen every block
// publish, advances the count of calls.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // lanes a pass, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShards = 256;    // ops/cuda.py EXCHANGE_MAX_SHARDS
constexpr int kHeld = 4;           // passes whose lanes stay in registers
constexpr int kBatch = 8;          // count words a lane has in flight
constexpr uint32_t kDead = 0xffffffffu;
static_assert(kMaxShards <= kThreads, "a thread a target in the scan");

struct Args {
  const uint32_t* hi;
  const uint32_t* lo;
  const int32_t* ts;
  const uint32_t* vals;  // [B, W] 32-bit words
  const uint8_t* valid;
  int B, W, n, maxp, cap;
  int passes;            // a block's lanes: passes * kThreads
  int kg_shift;          // log2(maxp) when maxp is a power of two, else -1
  uint32_t* s_hi;
  uint32_t* s_lo;
  int32_t* s_ts;
  uint32_t* s_vals;
  uint8_t* s_valid;
  int32_t* overflow;
  uint32_t* calls;                 // the scratch's count of calls
  unsigned long long* counts;      // [n][gridDim.x] tagged counts
};

__device__ __forceinline__ int target_of(const Args& a, uint32_t hi,
                                         uint32_t lo) {
  if (a.kg_shift >= 0) {
    const int32_t kg = key_group(hi, lo, a.maxp, a.maxp - 1);
    return static_cast<int>(
        (static_cast<unsigned long long>(kg) * a.n) >> a.kg_shift);
  }
  const int32_t kg = key_group(hi, lo, a.maxp);
  return static_cast<int>((static_cast<long long>(kg) * a.n) / a.maxp);
}

struct Held {
  uint32_t hi, lo, v;
  int32_t ts;
  bool live;
};

// Lane i's columns (v and ts only where `all`; v only at W = 1).
__device__ __forceinline__ Held load_lane(const Args& a, int i, bool all) {
  Held h{0u, 0u, 0u, 0, false};
  if (i < a.B) {
    h.live = a.valid[i] != 0;
    h.hi = a.hi[i];
    h.lo = a.lo[i];
    if (all) {
      h.ts = a.ts[i];
      if (a.W == 1) h.v = a.vals[i];
    }
  }
  return h;
}

struct Smem {
  uint32_t wc[kWarps][kMaxShards];  // a pass's group counts, zero between
  uint32_t wx[kWarps][kMaxShards];  // their exclusive scan over the warps
  uint32_t run[kMaxShards];         // the block's lanes a target so far
  int32_t base[kMaxShards];         // the lanes of the blocks before it
  int32_t total[kMaxShards];        // every block's
};

// One pass of the block's lanes: the lane's target and rank in the block,
// packed (rank << 8 | target) into lanes[p * kThreads + threadIdx.x], or
// kDead. Every thread of the block calls it.
__device__ __forceinline__ void rank_pass(const Args& a, Smem& s,
                                          uint32_t* lanes, int p,
                                          const Held& h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tgt = h.live ? target_of(a, h.hi, h.lo) : -1;
  // the lanes of this warp that share the lane's target (or its dead-ness)
  const unsigned same = __match_any_sync(0xffffffffu, tgt);
  const unsigned below = same & ((1u << lane) - 1u);
  if (h.live && below == 0) s.wc[warp][tgt] = __popc(same);  // the leader
  __syncthreads();
  for (int t = threadIdx.x; t < a.n; t += kThreads) {
    uint32_t r = s.run[t];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t v = s.wc[w][t];
      s.wc[w][t] = 0u;
      s.wx[w][t] = r;
      r += v;
    }
    s.run[t] = r;
  }
  __syncthreads();
  lanes[p * kThreads + threadIdx.x] =
      h.live ? ((s.wx[warp][tgt] + __popc(below)) << 8) |
                   static_cast<uint32_t>(tgt)
             : kDead;
}

// Zero bytes [b0, b1) of p: the stripe k of K of its 16-byte words, and
// (stripe 0) the bytes before the first and after the last whole word.
__device__ __forceinline__ void zero_span(void* p, size_t b0, size_t b1,
                                          int k, int K) {
  if (b0 >= b1) return;
  char* c = static_cast<char*>(p);
  const uintptr_t lo = reinterpret_cast<uintptr_t>(c + b0);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(c + b1);
  uintptr_t w0 = (lo + 15u) & ~static_cast<uintptr_t>(15u);
  uintptr_t w1 = hi & ~static_cast<uintptr_t>(15u);
  if (w0 > w1) w0 = w1 = hi;  // no whole word: bytes only
  const size_t words = (w1 - w0) / 16u;
  uint4* wp = reinterpret_cast<uint4*>(w0);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (size_t j = static_cast<size_t>(k) * kThreads + threadIdx.x; j < words;
       j += static_cast<size_t>(K) * kThreads) {
    wp[j] = z;
  }
  if (k == 0) {
    const size_t head = w0 - lo, tail = hi - w1;
    if (threadIdx.x < head) reinterpret_cast<char*>(lo)[threadIdx.x] = 0;
    if (threadIdx.x < tail) reinterpret_cast<char*>(w1)[threadIdx.x] = 0;
  }
}

__device__ __forceinline__ void write_row(const Args& a, int i, uint32_t e,
                                          const Smem& s, const Held& h) {
  const int tgt = static_cast<int>(e & 0xffu);
  const int pos = s.base[tgt] + static_cast<int>(e >> 8);
  if (pos >= a.cap) return;
  const size_t d = static_cast<size_t>(tgt) * a.cap + pos;
  a.s_hi[d] = h.hi;
  a.s_lo[d] = h.lo;
  a.s_ts[d] = h.ts;
  if (a.W == 1) {
    a.s_vals[d] = h.v;
  } else {
    for (int w = 0; w < a.W; ++w) {
      a.s_vals[d * a.W + w] = a.vals[static_cast<size_t>(i) * a.W + w];
    }
  }
  a.s_valid[d] = 1;
}

__global__ void __launch_bounds__(kThreads) exchange_pack_kernel(Args a) {
  extern __shared__ uint32_t lanes[];  // passes * kThreads packed ranks
  __shared__ Smem s;
  __shared__ uint32_t s_tag;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = static_cast<int>(gridDim.x);
  const int b = static_cast<int>(blockIdx.x);
  const int i0 = b * a.passes * kThreads;
  // the count of calls, read by thread 0 (its value reaches every
  // published word), in flight with the lanes' loads
  const uint32_t calls = threadIdx.x == 0 ? __ldcg(a.calls) : 0u;
  for (int j = threadIdx.x; j < kWarps * kMaxShards; j += kThreads) {
    (&s.wc[0][0])[j] = 0u;
  }
  for (int t = threadIdx.x; t < a.n; t += kThreads) s.run[t] = 0u;
  __syncthreads();

  // 1. targets and ranks; the first kHeld passes' lanes held, their
  // loads all in flight at once
  Held held[kHeld];
#pragma unroll
  for (int p = 0; p < kHeld; ++p) {
    held[p] = p < a.passes ? load_lane(a, i0 + p * kThreads + threadIdx.x,
                                       true)
                           : Held{0u, 0u, 0u, 0, false};
  }
  if (threadIdx.x == 0) s_tag = calls + 1u;  // read after rank_pass's sync
#pragma unroll
  for (int p = 0; p < kHeld; ++p) {
    if (p < a.passes) rank_pass(a, s, lanes, p, held[p]);
  }
  for (int p = kHeld; p < a.passes; ++p) {
    rank_pass(a, s, lanes, p,
              load_lane(a, i0 + p * kThreads + threadIdx.x, false));
  }
  // 2. the block's count a target, tagged (the tag taken 0 is skipped)
  const uint32_t tag = s_tag + (s_tag == 0u ? 1u : 0u);
  for (int t = threadIdx.x; t < a.n; t += kThreads) {
    s.base[t] = 0;
    s.total[t] = 0;
    *reinterpret_cast<volatile unsigned long long*>(
        a.counts + static_cast<size_t>(t) * G + b) =
        (static_cast<unsigned long long>(tag) << 32) | s.run[t];
  }
  __syncthreads();
  // 3. every block's counts: the warps split among the targets, each lane
  // with kBatch loads in flight; the counts of the blocks before this one
  // are its bases, all of them the totals
  const int wpt = max(1, kWarps / a.n);  // warps a target: 8, 4, 2 or 1
  for (int t = warp / wpt; t < a.n; t += kWarps / wpt) {
    const volatile unsigned long long* row =
        a.counts + static_cast<size_t>(t) * G;
    uint32_t before = 0u, all = 0u;
    const int stride = 32 * wpt;
    for (int q0 = (warp % wpt) * 32 + lane; q0 < G; q0 += kBatch * stride) {
      unsigned long long w[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int q = q0 + j * stride;
        w[j] = q < G ? row[q] : static_cast<unsigned long long>(tag) << 32;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int q = q0 + j * stride;
        while (static_cast<uint32_t>(w[j] >> 32) != tag) w[j] = row[q];
        const uint32_t c = static_cast<uint32_t>(w[j]);
        before += q < b ? c : 0u;
        all += c;
      }
    }
    before = __reduce_add_sync(0xffffffffu, before);
    all = __reduce_add_sync(0xffffffffu, all);
    if (lane == 0) {
      atomicAdd(&s.base[t], static_cast<int32_t>(before));
      atomicAdd(&s.total[t], static_cast<int32_t>(all));
    }
  }
  __syncthreads();
  if (b == 0 && threadIdx.x == 0) {
    int32_t over = 0;
    for (int t = 0; t < a.n; ++t) over += max(s.total[t] - a.cap, 0);
    *a.overflow = over;
    *a.calls = tag;  // every block has published: the next call's is one more
  }

  // 4. the rows, from registers where held
#pragma unroll
  for (int p = 0; p < kHeld; ++p) {
    if (p < a.passes) {
      const uint32_t e = lanes[p * kThreads + threadIdx.x];
      if (e != kDead) {
        write_row(a, i0 + p * kThreads + threadIdx.x, e, s, held[p]);
      }
    }
  }
  for (int p = kHeld; p < a.passes; ++p) {
    const uint32_t e = lanes[p * kThreads + threadIdx.x];
    if (e == kDead) continue;
    const int i = i0 + p * kThreads + threadIdx.x;
    write_row(a, i, e, s, load_lane(a, i, true));
  }

  // 5. zeros past each bucket's fill: K stripes a bucket over the blocks
  const int K = max(1, G / a.n);
  for (int item = b; item < a.n * K; item += G) {
    const int t = item / K, k = item - t * K;
    const size_t s0 = static_cast<size_t>(t) * a.cap + min(s.total[t], a.cap);
    const size_t s1 = static_cast<size_t>(t + 1) * a.cap;
    zero_span(a.s_hi, s0 * 4, s1 * 4, k, K);
    zero_span(a.s_lo, s0 * 4, s1 * 4, k, K);
    zero_span(a.s_ts, s0 * 4, s1 * 4, k, K);
    zero_span(a.s_vals, s0 * 4 * a.W, s1 * 4 * a.W, k, K);
    zero_span(a.s_valid, s0, s1, k, K);
  }
}

constexpr int kMaxDynamic = 160 * 1024;  // the ranks of 160 passes
constexpr int kCachedPasses = 32;

// Blocks a multiprocessor holds at p passes, asked once a device and p
// (up to kCachedPasses; beyond, each call asks).
cudaError_t blocks_per_sm(int dev, int p, int* out) {
  static int cache[64][kCachedPasses + 1] = {};
  static bool opted[64] = {};
  if (!opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        exchange_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxDynamic);
    if (e != cudaSuccess) return e;
    opted[dev] = true;
  }
  if (p <= kCachedPasses && cache[dev][p] > 0) {
    *out = cache[dev][p];
    return cudaSuccess;
  }
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, exchange_pack_kernel, kThreads,
      static_cast<size_t>(p) * kThreads * 4);
  if (e != cudaSuccess) return e;
  if (*out <= 0) return cudaErrorInvalidConfiguration;
  if (p <= kCachedPasses) cache[dev][p] = *out;
  return cudaSuccess;
}

// The grid and passes a call takes: blocks enough to fill the card twice
// over where the lanes allow (and, with few lanes, enough to zero the
// buckets), the grid within what the card holds at once.
cudaError_t plan(int B, int n, int cap, int* grid, int* passes) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  const int sms = sm_count();
  int want = 2 * sms;
  for (int round = 0; round < 8; ++round) {
    const int p =
        B > 0 ? (B + want * kThreads - 1) / (want * kThreads) : 1;
    if (p * kThreads * 4 > kMaxDynamic) return cudaErrorInvalidValue;
    int per_sm = 0;
    const cudaError_t e = blocks_per_sm(dev, p, &per_sm);
    if (e != cudaSuccess) return e;
    const int most = per_sm * sms;
    int g = B > 0 ? (B + p * kThreads - 1) / (p * kThreads) : 1;
    // blocks with no lane of their own still zero their stripes
    const long long fill = (static_cast<long long>(n) * cap + 8191) / 8192;
    g = static_cast<int>(max(static_cast<long long>(g),
                             min(fill, static_cast<long long>(want))));
    if (g <= most) {
      *grid = g;
      *passes = p;
      return cudaSuccess;
    }
    want = most;
  }
  return cudaErrorInvalidConfiguration;
}

}  // namespace

// The grid exchange_pack takes over B lanes (its scratch holds 1 + n *
// grid int64 words), or -1 for a B it does not take.
extern "C" long long exchange_pack_grid(int B, int n, int cap) {
  int grid = 0, passes = 0;
  if (n < 1 || n > kMaxShards || cap < 1 || B < 0 ||
      plan(B, n, cap, &grid, &passes) != cudaSuccess) {
    return -1;
  }
  return grid;
}

// scratch: int64 words, the count of calls, then [n][grid] tagged block
// counts (ops/cuda.py _stream_scratch), zeroed once.
extern "C" int exchange_pack(const void* hi, const void* lo, const void* ts,
                             const void* vals, const void* valid, int B,
                             int W, int n, int maxp, int cap, void* scratch,
                             void* s_hi, void* s_lo, void* s_ts,
                             void* s_vals, void* s_valid, void* overflow,
                             void* stream) {
  if (n < 1 || n > kMaxShards || n > maxp || cap < 1 || B < 0 || W < 1 ||
      static_cast<long long>(n) * cap * W >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int grid = 0, passes = 0;
  const cudaError_t e = plan(B, n, cap, &grid, &passes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int shift = -1;
  if ((maxp & (maxp - 1)) == 0) {
    shift = 0;
    while ((1 << shift) < maxp) ++shift;
  }
  Args a{static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
         static_cast<const int32_t*>(ts), static_cast<const uint32_t*>(vals),
         static_cast<const uint8_t*>(valid), B, W, n, maxp, cap, passes,
         shift, static_cast<uint32_t*>(s_hi), static_cast<uint32_t*>(s_lo),
         static_cast<int32_t*>(s_ts), static_cast<uint32_t*>(s_vals),
         static_cast<uint8_t*>(s_valid), static_cast<int32_t*>(overflow),
         static_cast<uint32_t*>(scratch),
         static_cast<unsigned long long*>(scratch) + 1};
  void* params[] = {&a};
  const cudaError_t le = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(exchange_pack_kernel), dim3(grid),
      dim3(kThreads), params, static_cast<size_t>(passes) * kThreads * 4,
      static_cast<cudaStream_t>(stream));
  if (le != cudaSuccess) return static_cast<int>(le);
  return static_cast<int>(cudaGetLastError());
}
