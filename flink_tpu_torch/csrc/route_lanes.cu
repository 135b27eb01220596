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
// Design: every access is coalesced (lane i at address i). The batch
// scalars (late count, max and min live pane, valid lanes) reduce in
// registers with warp shuffles, then through shared memory, so each block
// issues one atomic per scalar instead of one per lane. The scalars land in
// a 4-int buffer that a one-thread kernel initialises first on the same
// stream; the reference's bookkeeping that consumes them (ring
// registration) stays on the device.
//
// Key-group fill (K4's kg_fill, window_kernels.py:896-915, 934, and K11's
// kg_batch_fill, :464): the FILL instance of the kernel also bincounts the
// key group of every owned, valid lane ("mine", counted before the late
// check, so late, too-old and no-fit lanes count) into an int32 [maxp]
// histogram. Each block counts into a maxp-bin histogram in shared memory
// and flushes its non-zero bins with one global atomic each; it walks a
// grid-stride loop over at least 4 * maxp lanes (kg_hist_blocks), so the
// zeroing and the flush scan of its maxp bins stay small beside its lanes.
// maxp runs to Flink's 32,768 bins, 128 KB, past the default 48 KB of
// dynamic shared memory: the launch opts in (kg_hist_smem). The fill adds
// 4 maxp bytes of output to the 22 B a lane. The instance without the
// fill is the kernel as it was: one lane a thread, no shared histogram.
//
// Residency (K10's kg_res divert, window_kernels.py:770-820, tiered
// key-group state): the RES instance takes the bool [maxp] residency mask
// and writes a cold lane mask, cold = live and not res[kg]. The executor
// diverts the cold lanes to the overflow ring (ops/window_kernels.py
// update): they claim no slot, add no activity, and still mark kg_dirty.
// Each block stages the mask in shared memory once, beside the fill
// histogram when both are on, and walks the same grid-stride loop as the
// fill, so the staging is amortised over at least 4 * maxp lanes; each
// lane then costs one shared-memory byte read and one byte written. The
// mode adds maxp bytes read and B bytes written to the 22 B a lane.

#include "common.cuh"

namespace {

__global__ void init_stats(int32_t* stats) {
  stats[0] = 0;          // late lanes
  stats[1] = kPaneNone;  // max live pane
  stats[2] = INT32_MAX;  // min live pane
  stats[3] = 0;          // valid lanes (the drain's "events")
}

template <bool FILL, bool RES>
__global__ void route_lanes_kernel(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const int32_t* __restrict__ ts, const uint8_t* __restrict__ valid, int B,
    const int32_t* __restrict__ watermark,
    const int32_t* __restrict__ purged_through, int slide, int k, int L,
    int maxp,
    int kg_start, int kg_end, int32_t* __restrict__ pane_out,
    int32_t* __restrict__ kg_out, uint8_t* __restrict__ live_out,
    int32_t* __restrict__ stats, int32_t* __restrict__ fill,
    const uint8_t* __restrict__ res, uint8_t* __restrict__ cold_out) {
  // FILL: maxp int32 bins, then RES: the maxp-byte residency mask
  extern __shared__ int32_t hist[];
  uint8_t* res_s = reinterpret_cast<uint8_t*>(hist + (FILL ? maxp : 0));
  if (RES) {
    for (int b = threadIdx.x; b < maxp; b += blockDim.x) res_s[b] = res[b];
  }
  if (FILL) {
    kg_hist_zero(hist, maxp);  // its barrier covers the staged mask too
  } else if (RES) {
    __syncthreads();
  }
  // late threshold (window_kernels.py:674-678): clamp before subtracting
  // the lateness so the MIN sentinel watermark cannot wrap int32
  const int32_t wm = *watermark;
  const int32_t purged = *purged_through;
  const int32_t floor_wm = INT32_MIN + 1 + slide + L;
  const int32_t base = (wm > floor_wm ? wm : floor_wm) - L;
  const int32_t wm_pane_l = floor_div(base + 1 - slide, slide);

  int32_t late = 0, mx = kPaneNone, mn = INT32_MAX, events = 0;
  const int stride = (FILL || RES) ? gridDim.x * blockDim.x : B;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < B; i += stride) {
    const int32_t g = key_group(hi[i], lo[i], maxp);
    const int32_t p = floor_div(ts[i], slide);
    const bool v = valid[i] != 0;
    const bool mine = v && g >= kg_start && g <= kg_end;
    const bool is_late = mine && (p + (k - 1) <= wm_pane_l || p <= purged);
    const bool live = mine && !is_late;
    pane_out[i] = p;
    kg_out[i] = g;
    live_out[i] = live ? 1 : 0;
    if (RES) cold_out[i] = (live && !res_s[g]) ? 1 : 0;
    late += is_late ? 1 : 0;
    events += v ? 1 : 0;
    if (live) {
      mx = max(mx, p);
      mn = min(mn, p);
    }
    if (FILL && mine) atomicAdd(&hist[g], 1);
  }
  __shared__ int32_t s_late[32], s_max[32], s_min[32], s_ev[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  late = warp_sum(late);
  events = warp_sum(events);
  mx = warp_max(mx);
  mn = warp_min(mn);
  if (lane == 0) {
    s_late[warp] = late;
    s_max[warp] = mx;
    s_min[warp] = mn;
    s_ev[warp] = events;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    late = lane < n_warps ? s_late[lane] : 0;
    mx = lane < n_warps ? s_max[lane] : kPaneNone;
    mn = lane < n_warps ? s_min[lane] : INT32_MAX;
    events = lane < n_warps ? s_ev[lane] : 0;
    late = warp_sum(late);
    events = warp_sum(events);
    mx = warp_max(mx);
    mn = warp_min(mn);
    if (lane == 0) {
      if (late) atomicAdd(&stats[0], late);
      if (mx != kPaneNone) atomicMax(&stats[1], mx);
      if (mn != INT32_MAX) atomicMin(&stats[2], mn);
      if (events) atomicAdd(&stats[3], events);
    }
  }
  if (FILL) kg_hist_flush(hist, maxp, fill);
}

// Dynamic shared memory of an instance: the fill's bins and the staged
// residency mask. maxp runs to 32,768 (128 KB of bins, 32 KB of mask),
// past the default 48 KB: the launch opts in.
template <bool FILL, bool RES>
cudaError_t launch(int B, int threads, cudaStream_t s, int maxp,
                   const uint32_t* h, const uint32_t* l, const int32_t* t,
                   const uint8_t* v, const int32_t* w, const int32_t* pt,
                   int slide, int k, int L, int kg_start, int kg_end,
                   int32_t* po, int32_t* ko, uint8_t* lv, int32_t* st,
                   int32_t* fill, const uint8_t* res, uint8_t* cold) {
  const int bytes = (FILL ? maxp * static_cast<int>(sizeof(int32_t)) : 0) +
                    (RES ? maxp : 0);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        route_lanes_kernel<FILL, RES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (FILL || RES) ? kg_hist_blocks(B, maxp, threads)
                                   : (B + threads - 1) / threads;
  route_lanes_kernel<FILL, RES><<<blocks, threads, bytes, s>>>(
      h, l, t, v, B, w, pt, slide, k, L, maxp, kg_start, kg_end, po, ko, lv,
      st, fill, res, cold);
  return cudaGetLastError();
}

}  // namespace

// ``fill`` null: no key-group fill; else an int32 [maxp] histogram, zeroed
// by the caller, that the mine lanes add to. ``res`` null: no residency
// (the kernel as it was); else a bool [maxp] mask, and ``cold_out`` a
// bool [B] output.
extern "C" int route_lanes(const void* hi, const void* lo, const void* ts,
                           const void* valid, int B, const void* watermark,
                           const void* purged_through, int slide, int k,
                           int L, int maxp, int kg_start, int kg_end,
                           void* pane_out,
                           void* kg_out, void* live_out, void* stats,
                           void* fill, const void* res, void* cold_out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  init_stats<<<1, 1, 0, s>>>(static_cast<int32_t*>(stats));
  const int threads = 256;
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if ((res == nullptr) != (cold_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t* h = static_cast<const uint32_t*>(hi);
  const uint32_t* l = static_cast<const uint32_t*>(lo);
  const int32_t* t = static_cast<const int32_t*>(ts);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const int32_t* w = static_cast<const int32_t*>(watermark);
  const int32_t* pt = static_cast<const int32_t*>(purged_through);
  int32_t* po = static_cast<int32_t*>(pane_out);
  int32_t* ko = static_cast<int32_t*>(kg_out);
  uint8_t* lv = static_cast<uint8_t*>(live_out);
  int32_t* st = static_cast<int32_t*>(stats);
  int32_t* f = static_cast<int32_t*>(fill);
  const uint8_t* r = static_cast<const uint8_t*>(res);
  uint8_t* c = static_cast<uint8_t*>(cold_out);
  cudaError_t e;
  if (f == nullptr && r == nullptr) {
    e = launch<false, false>(B, threads, s, maxp, h, l, t, v, w, pt, slide,
                             k, L, kg_start, kg_end, po, ko, lv, st, f, r, c);
  } else if (r == nullptr) {
    e = launch<true, false>(B, threads, s, maxp, h, l, t, v, w, pt, slide,
                            k, L, kg_start, kg_end, po, ko, lv, st, f, r, c);
  } else if (f == nullptr) {
    e = launch<false, true>(B, threads, s, maxp, h, l, t, v, w, pt, slide,
                            k, L, kg_start, kg_end, po, ko, lv, st, f, r, c);
  } else {
    e = launch<true, true>(B, threads, s, maxp, h, l, t, v, w, pt, slide,
                           k, L, kg_start, kg_end, po, ko, lv, st, f, r, c);
  }
  return static_cast<int>(e);
}
