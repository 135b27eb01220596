// G1 route_lanes — key-group routing and the lane prologue of the window
// update, one thread per lane.
//
// Replaces (flink_tpu, the JAX reference):
//   ops/hashing.py route_hash, core/keygroups.py murmur3_32 /
//   compute_key_group_for_key_hash / assign_to_key_group (kernels K1, K2),
//   runtime/step.py mask_update_shard (the owned-key-group mask), and the
//   lane prologue of ops/window_kernels.py update (pane = floor(ts/slide),
//   the late check against the pre-batch watermark and purged_through with
//   the allowed lateness L — a lane drops only when the newest window
//   holding its pane has passed end - 1 + L, or the pane is purged — and
//   the batch max / min live pane, window_kernels.py:668-689).
//
// Bound: bytes. Per lane it reads hi, lo, ts (4 B each) and valid (1 B) and
// writes pane, kg (4 B each) and live (1 B): 22 B a lane, 5.8 MB for a
// 262,144-lane batch, about 1.7 us at 3.35 TB/s. The hash is a few dozen
// integer operations a lane, far below the card's integer rate.
//
// Design: every access is coalesced (lane i at address i). The three batch
// scalars (late count, max and min live pane) reduce in registers with warp
// shuffles, then through shared memory, so each block issues one atomic per
// scalar instead of one per lane. The scalars land in a 3-int buffer that a
// one-thread kernel initialises first on the same stream; the reference's
// bookkeeping that consumes them (ring registration) stays on the device.

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// core/keygroups.py murmur3_32: one 32-bit word, seed 0, length 4.
__device__ __forceinline__ uint32_t murmur3_32(uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  uint32_t h = rotl32(k, 13);
  h = h * 5u + 0xE6546B64u;
  h ^= 4u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void init_stats(int32_t* stats) {
  stats[0] = 0;          // late lanes
  stats[1] = kPaneNone;  // max live pane
  stats[2] = INT32_MAX;  // min live pane
}

__global__ void route_lanes_kernel(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const int32_t* __restrict__ ts, const uint8_t* __restrict__ valid, int B,
    const int32_t* __restrict__ watermark,
    const int32_t* __restrict__ purged_through, int slide, int k, int L,
    int maxp,
    int kg_start, int kg_end, int32_t* __restrict__ pane_out,
    int32_t* __restrict__ kg_out, uint8_t* __restrict__ live_out,
    int32_t* __restrict__ stats) {
  // late threshold (window_kernels.py:674-678): clamp before subtracting
  // the lateness so the MIN sentinel watermark cannot wrap int32
  const int32_t wm = *watermark;
  const int32_t purged = *purged_through;
  const int32_t floor_wm = INT32_MIN + 1 + slide + L;
  const int32_t base = (wm > floor_wm ? wm : floor_wm) - L;
  const int32_t wm_pane_l = floor_div(base + 1 - slide, slide);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t late = 0, mx = kPaneNone, mn = INT32_MAX;
  if (i < B) {
    const uint32_t h = lo[i] ^ (hi[i] * 0x9E3779B9u);  // route_hash
    const int32_t g = static_cast<int32_t>(murmur3_32(h) % static_cast<uint32_t>(maxp));
    const int32_t p = floor_div(ts[i], slide);
    const bool mine = valid[i] != 0 && g >= kg_start && g <= kg_end;
    const bool is_late = mine && (p + (k - 1) <= wm_pane_l || p <= purged);
    const bool live = mine && !is_late;
    pane_out[i] = p;
    kg_out[i] = g;
    live_out[i] = live ? 1 : 0;
    late = is_late ? 1 : 0;
    if (live) {
      mx = p;
      mn = p;
    }
  }
  __shared__ int32_t s_late[32], s_max[32], s_min[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  late = warp_sum(late);
  mx = warp_max(mx);
  mn = warp_min(mn);
  if (lane == 0) {
    s_late[warp] = late;
    s_max[warp] = mx;
    s_min[warp] = mn;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    late = lane < n_warps ? s_late[lane] : 0;
    mx = lane < n_warps ? s_max[lane] : kPaneNone;
    mn = lane < n_warps ? s_min[lane] : INT32_MAX;
    late = warp_sum(late);
    mx = warp_max(mx);
    mn = warp_min(mn);
    if (lane == 0) {
      if (late) atomicAdd(&stats[0], late);
      if (mx != kPaneNone) atomicMax(&stats[1], mx);
      if (mn != INT32_MAX) atomicMin(&stats[2], mn);
    }
  }
}

}  // namespace

extern "C" int route_lanes(const void* hi, const void* lo, const void* ts,
                           const void* valid, int B, const void* watermark,
                           const void* purged_through, int slide, int k,
                           int L, int maxp, int kg_start, int kg_end,
                           void* pane_out,
                           void* kg_out, void* live_out, void* stats,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  init_stats<<<1, 1, 0, s>>>(static_cast<int32_t*>(stats));
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  if (blocks > 0) {
    route_lanes_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
        static_cast<const int32_t*>(ts), static_cast<const uint8_t*>(valid), B,
        static_cast<const int32_t*>(watermark),
        static_cast<const int32_t*>(purged_through), slide, k, L, maxp,
        kg_start, kg_end, static_cast<int32_t*>(pane_out), static_cast<int32_t*>(kg_out),
        static_cast<uint8_t*>(live_out), static_cast<int32_t*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}
