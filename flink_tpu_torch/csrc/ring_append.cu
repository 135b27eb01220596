// G7 ring_append — append the update's nofit lanes (live lanes whose key
// found no state slot) to the overflow ring, in lane order.
//
// Replaces (flink_tpu, the JAX reference): ops/window_kernels.py
// ring_append (:222, kernel K10) as update calls it (:832-838): the lanes'
// (key hi, key lo, pane, contribution) — the W value columns of a sum, a
// min or a max (W = 2 for mean's [sum, count], kernel K7), 1.0 for a
// count — go to ring positions from ovf_n on, the lanes past the ring's O
// lanes are lost and counted, and ovf_n = min(ovf_n + n, O). The host
// drains the ring into its spill stores (runtime/executor.py).
//
// Bound: bytes. Per lane it reads the mask (1 B), and for each taken lane
// its hi, lo, pane and values (12 + 4 W B) and writes as much to the ring.
// A 262,144-lane batch with 1 % of its lanes taken moves ~340 KB, about
// 0.1 us at 3.35 TB/s, so a call's fixed cost (one launch, one look-back)
// is what it pays; a batch of all-new keys in the fast step moves ~8.6 MB.
//
// Design: one launch a call, no fill and no allocation. A block a tile of
// kTile lanes in blockIdx order; each thread reads its kPer mask bytes in
// one 16-byte load (byte loads for a tail or an unaligned mask) and ranks
// its taken lanes by __popc, a warp scan of the threads' counts and the
// warps' totals in shared memory give each its first rank, and the tile's
// taken lanes are listed in lane order in shared memory. Each thread then
// loads the lane of its first rank (in flight during the look-back); the
// tile's offset comes from a decoupled look-back over status words tagged
// on the device (lookback.cuh). Tile 0 reads the base ovf_n on the card and
// folds it into its inclusive prefix, so every later tile's offset carries
// it; the last tile, whose look-back saw every tile publish (so every read
// of the base, one by tile 0, came first), writes ovf_n = min(end, O), adds
// the lanes past O to `lost` and advances the scratch's count of calls.
// The ranks keep lane order, so the ring equals the plain version's exactly
// (an atomicAdd cursor would not: which lanes are lost, and the order in
// which the host adds a key's contributions, depend on it). The status
// words hold counts below 2^30: the wrapper refuses O + B >= 2^30.
// G9's export keeps ring.cuh's three passes.

#include "lookback.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                 // mask bytes a thread: one 16-byte load
constexpr int kTile = kThreads * kPer;   // 2,048 lanes; ops/cuda.py RING_TILE
static_assert(kTile <= 65536, "tile ranks are 16-bit");

struct Args {
  const uint8_t* mask;
  const uint32_t* hi;
  const uint32_t* lo;
  const int32_t* pane;
  const float* vals;  // [B, W]; null: a count, every lane contributes 1.0
  int W, B, O;
  uint32_t* r_hi;
  uint32_t* r_lo;
  int32_t* r_pane;
  float* r_val;       // [O, W] row-major
  int32_t* ovf_n;
  int32_t* lost;
  uint32_t* calls;               // the scratch's count of calls (the tag)
  unsigned long long* status;    // a status word a tile
};

// bit k: byte k of x is nonzero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  const uint32_t nz = __vcmpne4(x, 0u);  // 0xff in each nonzero byte
  return (nz & 1u) | ((nz >> 7) & 2u) | ((nz >> 14) & 4u) | ((nz >> 21) & 8u);
}

struct Lane {
  uint32_t hi, lo;
  int32_t pane;
  float v0, v1;
};

__device__ __forceinline__ Lane load_lane(const Args& a, int i) {
  Lane l{a.hi[i], a.lo[i], a.pane[i], 1.0f, 1.0f};
  if (a.vals != nullptr) {
    l.v0 = a.vals[static_cast<size_t>(i) * a.W];
    if (a.W > 1) l.v1 = a.vals[static_cast<size_t>(i) * a.W + 1];
  }
  return l;
}

__device__ __forceinline__ void store_lane(const Args& a, int i, int32_t pos,
                                           const Lane& l) {
  a.r_hi[pos] = l.hi;
  a.r_lo[pos] = l.lo;
  a.r_pane[pos] = l.pane;
  float* v = a.r_val + static_cast<size_t>(pos) * a.W;
  v[0] = l.v0;
  if (a.W > 1) v[1] = l.v1;
  for (int w = 2; w < a.W; ++w) {
    v[w] = a.vals != nullptr ? a.vals[static_cast<size_t>(i) * a.W + w]
                             : 1.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    ring_append_kernel(Args a, int aligned) {
  __shared__ uint16_t s_idx[kTile];  // the tile's taken lanes, in lane order
  __shared__ int32_t s_warp[kWarps];
  __shared__ int32_t s_base;
  __shared__ uint32_t s_tag;
  const int tile = blockIdx.x;
  const int t0 = tile * kTile;
  const int n = min(kTile, a.B - t0);  // 0 for the one tile of B = 0
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the count of calls (the tag) and, in tile 0, the ring's fill: read by
  // the thread that publishes (its word depends on both), in flight with
  // the mask's load
  uint32_t calls = 0u;
  int32_t base0 = 0;
  if (threadIdx.x == 0) {
    calls = __ldcg(a.calls);
    if (tile == 0) base0 = __ldcg(a.ovf_n);
  }

  // 1. the thread's kPer mask bytes, a bit a taken lane
  const int first = threadIdx.x * kPer;
  uint32_t bits = 0u;
  if (aligned && first + kPer <= n) {
    const uint4 w = *reinterpret_cast<const uint4*>(a.mask + t0 + first);
    bits = nonzero_bytes(w.x) | (nonzero_bytes(w.y) << 4) |
           (nonzero_bytes(w.z) << 8) | (nonzero_bytes(w.w) << 12);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      bits |= first + j < n && a.mask[t0 + first + j] ? 1u << j : 0u;
    }
  }
  if (threadIdx.x == 0) {
    s_tag = lb_tag_of(calls);
    s_base = base0;
  }
  // 2. ranks in the tile: a warp scan of the threads' counts, then the
  // warps' totals
  const int c = __popc(bits);
  int x = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  const uint32_t tag = s_tag;
  int tile_n = 0, r = x - c;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = s_warp[w];
    r += w < warp ? v : 0;
    tile_n += v;
  }
  for (uint32_t b = bits; b; b &= b - 1u) {
    s_idx[r++] = static_cast<uint16_t>(first + __ffs(b) - 1);
  }
  __syncthreads();
  // 3. the lane of the thread's first rank, loaded while the tile looks back
  Lane held{};
  if (static_cast<int>(threadIdx.x) < tile_n) {
    held = load_lane(a, t0 + s_idx[threadIdx.x]);
  }
  // 4. the tile's offset; tile 0 folds in the base, read once on the card
  const uint32_t agg = static_cast<uint32_t>(tile_n + base0);
  const uint32_t excl = lb_tile_offset(a.status, tile, tag, agg);
  const int32_t pos0 = tile == 0 ? s_base : static_cast<int32_t>(excl);
  if (tile == static_cast<int>(gridDim.x) - 1 && threadIdx.x == 0) {
    const int32_t end = pos0 + tile_n;  // every tile has published
    *a.ovf_n = min(end, a.O);
    if (end > a.O) *a.lost += end - a.O;
    *a.calls = tag;  // every block has read it: the next call's is one more
  }
  // 5. the rows, consecutive threads at consecutive ring positions
  for (int k = threadIdx.x; k < tile_n; k += kThreads) {
    const int32_t pos = pos0 + k;
    if (pos >= a.O) break;  // ranks ascend: every later one is past the ring
    const int i = t0 + s_idx[k];
    store_lane(a, i, pos, k == static_cast<int>(threadIdx.x)
                              ? held : load_lane(a, i));
  }
}

}  // namespace

// scratch: int64 words, the count of calls, then a status word a tile
// (ops/cuda.py _ring_append_scratch), zeroed once.
extern "C" int ring_append(const void* mask, const void* hi, const void* lo,
                           const void* pane, const void* vals, int W, int B,
                           int O, void* ovf_hi, void* ovf_lo, void* ovf_pane,
                           void* ovf_val, void* ovf_n, void* lost,
                           void* scratch, void* stream) {
  if (B < 0 || O < 0 || W < 1 ||
      static_cast<long long>(O) + B >= (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = B > 0 ? (B + kTile - 1) / kTile : 1;
  uint32_t* calls = static_cast<uint32_t*>(scratch);
  Args a{static_cast<const uint8_t*>(mask),
         static_cast<const uint32_t*>(hi),
         static_cast<const uint32_t*>(lo),
         static_cast<const int32_t*>(pane),
         static_cast<const float*>(vals),
         W, B, O,
         static_cast<uint32_t*>(ovf_hi),
         static_cast<uint32_t*>(ovf_lo),
         static_cast<int32_t*>(ovf_pane),
         static_cast<float*>(ovf_val),
         static_cast<int32_t*>(ovf_n),
         static_cast<int32_t*>(lost),
         calls,
         static_cast<unsigned long long*>(scratch) + 1};
  const int aligned = (reinterpret_cast<uintptr_t>(mask) & 15u) == 0u;
  ring_append_kernel<<<tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, aligned);
  return static_cast<int>(cudaGetLastError());
}
