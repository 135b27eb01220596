// G1 route_lanes — key-group routing and the lane prologue of the window
// update: one launch a call, a grid sized to the card, four lanes a thread.
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
// Design: one kernel a call. The grid is a few blocks a multiprocessor
// (kBlocksPerSM, from the cached count in common.cuh), fewer for a small
// batch, and each thread walks a grid-stride loop over groups of 4 lanes:
// 16-byte loads of hi, lo and ts and a 4-byte load of valid, 16-byte stores
// of pane and kg and 4-byte stores of live (and cold). A batch whose length
// is not a multiple of 4 takes its tail a lane a thread, and a call with any
// pointer off that alignment (lanes arrive as views: ring slots, a shard's
// or a DCN host's slice) takes every lane that way, in the same kernel. The
// pane divides by the launch's slide with a multiply and a shift computed
// on the host (common.cuh div_magic), the key group masks when maxp is a
// power of two. The batch scalars (late lanes, max and min live pane, valid
// lanes) reduce in registers, by warp reductions and once through shared
// memory; each block stores its four in its own slot of a scratch cached
// per device and stream (ops/cuda.py _stream_scratch) and takes a ticket
// from a counter. The block that draws the last ticket folds the slots into
// ``stats``, a thread a slot, and resets the counter for the next call, so
// no host code touches the scratch between calls and no word takes more
// than one atomic a block. No fence orders a slot before its ticket (on the
// H100 the two fences of that pattern cost more than the rest of the fold):
// each slot word carries the call's tag, a count of calls kept in the
// scratch beside the ticket, and the folding thread reads a word until it
// holds this call's tag. An empty batch launches one block, which writes
// the sentinels.
//
// Key-group fill (K4's kg_fill, window_kernels.py:896-915, 934, and K11's
// kg_batch_fill, :464): the FILL instance of the kernel also bincounts the
// key group of every owned, valid lane ("mine", counted before the late
// check, so late, too-old and no-fit lanes count) into an int32 [maxp]
// histogram. Each block counts into a maxp-bin histogram in shared memory
// and flushes its non-zero bins with one global atomic each; its grid is
// kg_hist_blocks' (at most one block a 4 * maxp lanes where the card stays
// full), so the zeroing and the flush scan of its maxp bins stay small
// beside its lanes. maxp runs to Flink's 32,768 bins, 128 KB, past the
// default 48 KB of dynamic shared memory: the launch opts in. The fill
// adds 4 maxp bytes of output to the 22 B a lane.
//
// Residency (K10's kg_res divert, window_kernels.py:770-820, tiered
// key-group state): the RES instance takes the bool [maxp] residency mask
// and writes a cold lane mask, cold = live and not res[kg]. The executor
// diverts the cold lanes to the overflow ring (ops/window_kernels.py
// update): they claim no slot, add no activity, and still mark kg_dirty.
// Each block stages the mask in shared memory once, beside the fill
// histogram when both are on, on the fill's grid; each lane then costs one
// shared-memory byte read and one byte written. The mode adds maxp bytes
// read and B bytes written to the 22 B a lane.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 4;
// the scratch's block slots: the grid never has more blocks
constexpr int kMaxBlocks = 2048;

struct RouteArgs {
  const uint32_t* hi;
  const uint32_t* lo;
  const int32_t* ts;
  const uint8_t* valid;
  int B;
  const int32_t* watermark;
  const int32_t* purged_through;
  int slide, k, L, maxp, kg_mask, kg_start, kg_end;
  DivMagic by_slide;
  bool vec;  // every lane pointer aligned for the 4-lane loads and stores
  int32_t* pane_out;
  int32_t* kg_out;
  uint8_t* live_out;
  int32_t* stats;
  int32_t* fill;
  const uint8_t* res;
  uint8_t* cold_out;
  // [kMaxBlocks] slots of four tagged words (late, max, min, valid lanes),
  // then the ticket (0 between calls) and the count of calls (the tag)
  unsigned long long* slots;
  unsigned int* ticket;
  unsigned int* calls;
};

// The four stats (late lanes, max and min live pane, valid lanes) as an
// int4: none yet, two combined, a warp's combined.
__device__ __forceinline__ int4 stats_none() {
  return make_int4(0, kPaneNone, INT32_MAX, 0);
}

__device__ __forceinline__ int4 combine(int4 a, int4 b) {
  return make_int4(a.x + b.x, max(a.y, b.y), min(a.z, b.z), a.w + b.w);
}

__device__ __forceinline__ int4 fold_warp(int4 v) {
  v.x = __reduce_add_sync(0xffffffffu, v.x);
  v.y = __reduce_max_sync(0xffffffffu, v.y);
  v.z = __reduce_min_sync(0xffffffffu, v.z);
  v.w = __reduce_add_sync(0xffffffffu, v.w);
  return v;
}

// a slot word: the call's tag above a stat's 32 bits
__device__ __forceinline__ unsigned long long tagged(unsigned int tag,
                                                     int32_t v) {
  return static_cast<unsigned long long>(tag) << 32 |
         static_cast<uint32_t>(v);
}

// The batch scalars of a thread, a warp, a block.
struct Stats {
  int32_t late, mx, mn, events;
};

template <bool FILL, bool RES>
struct Lane {
  const RouteArgs& a;
  int32_t wm_pane_l, purged;
  int32_t* hist;            // FILL: the block's bins
  const uint8_t* res_s;     // RES: the staged mask
  Stats st;

  // one lane: its pane, key group, live and cold flags; the stats
  __device__ __forceinline__ void operator()(uint32_t h, uint32_t l,
                                             int32_t t, bool v, int32_t& p,
                                             int32_t& g, bool& live,
                                             bool& cold) {
    g = key_group(h, l, a.maxp, a.kg_mask);
    p = floor_div(t, a.by_slide);
    const bool mine = v && g >= a.kg_start && g <= a.kg_end;
    // p + k - 1 wraps as the reference's int32 sum does
    const int32_t newest = static_cast<int32_t>(
        static_cast<uint32_t>(p) + static_cast<uint32_t>(a.k - 1));
    const bool is_late = mine && (newest <= wm_pane_l || p <= purged);
    live = mine && !is_late;
    cold = RES && live && !res_s[g];
    st.late += is_late;
    st.events += v;
    if (live) {
      st.mx = max(st.mx, p);
      st.mn = min(st.mn, p);
    }
    if (FILL && mine) atomicAdd(&hist[g], 1);
  }
};

// four bool lanes as the bytes of one word, lane 0 in the low byte
__device__ __forceinline__ uint32_t bytes4(const bool (&b)[4]) {
  return static_cast<uint32_t>(b[0]) | static_cast<uint32_t>(b[1]) << 8 |
         static_cast<uint32_t>(b[2]) << 16 | static_cast<uint32_t>(b[3]) << 24;
}

template <bool FILL, bool RES>
__global__ void __launch_bounds__(kThreads)
    route_lanes_kernel(const RouteArgs a) {
  // FILL: maxp int32 bins, then RES: the maxp-byte residency mask
  extern __shared__ int32_t hist[];
  uint8_t* res_s = reinterpret_cast<uint8_t*>(hist + (FILL ? a.maxp : 0));
  if (RES) {
    for (int b = threadIdx.x; b < a.maxp; b += blockDim.x) res_s[b] = a.res[b];
  }
  if (FILL) {
    for (int b = threadIdx.x; b < a.maxp; b += blockDim.x) hist[b] = 0;
  }
  if (FILL || RES) __syncthreads();
  // late threshold (window_kernels.py:674-678): clamp before subtracting
  // the lateness so the MIN sentinel watermark cannot wrap int32
  const int32_t wm = *a.watermark;
  const int32_t floor_wm = INT32_MIN + 1 + a.slide + a.L;
  const int32_t base = (wm > floor_wm ? wm : floor_wm) - a.L;
  Lane<FILL, RES> lane{a, floor_div(base + 1 - a.slide, a.by_slide),
                       *a.purged_through, hist, res_s,
                       Stats{0, kPaneNone, INT32_MAX, 0}};
  // this call's tag: never 0, so the zeroed scratch holds no call's slot
  unsigned int tag = __ldcg(a.calls) + 1;
  tag += tag == 0;

  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  int tail = 0;
  if (a.vec) {
    const int groups = a.B >> 2;
    const uint4* hi4 = reinterpret_cast<const uint4*>(a.hi);
    const uint4* lo4 = reinterpret_cast<const uint4*>(a.lo);
    const int4* ts4 = reinterpret_cast<const int4*>(a.ts);
    const uint32_t* v4 = reinterpret_cast<const uint32_t*>(a.valid);
    for (int gi = first; gi < groups; gi += stride) {
      const uint4 h = hi4[gi], l = lo4[gi];
      const int4 t = ts4[gi];
      const uint32_t v = v4[gi];
      int4 p, g;
      bool lv[4], cd[4];
      lane(h.x, l.x, t.x, v & 0xffu, p.x, g.x, lv[0], cd[0]);
      lane(h.y, l.y, t.y, (v >> 8) & 0xffu, p.y, g.y, lv[1], cd[1]);
      lane(h.z, l.z, t.z, (v >> 16) & 0xffu, p.z, g.z, lv[2], cd[2]);
      lane(h.w, l.w, t.w, v >> 24, p.w, g.w, lv[3], cd[3]);
      reinterpret_cast<int4*>(a.pane_out)[gi] = p;
      reinterpret_cast<int4*>(a.kg_out)[gi] = g;
      reinterpret_cast<uint32_t*>(a.live_out)[gi] = bytes4(lv);
      if (RES) reinterpret_cast<uint32_t*>(a.cold_out)[gi] = bytes4(cd);
    }
    tail = groups << 2;
  }
  for (int i = tail + first; i < a.B; i += stride) {
    int32_t p, g;
    bool lv, cd;
    lane(a.hi[i], a.lo[i], a.ts[i], a.valid[i] != 0, p, g, lv, cd);
    a.pane_out[i] = p;
    a.kg_out[i] = g;
    a.live_out[i] = lv;
    if (RES) a.cold_out[i] = cd;
  }

  // the block's stats: warp reductions, then warp 0 over the warps
  __shared__ int4 part[kWarps];
  __shared__ bool last;
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Stats s = lane.st;
  s.late = __reduce_add_sync(0xffffffffu, s.late);
  s.events = __reduce_add_sync(0xffffffffu, s.events);
  s.mx = __reduce_max_sync(0xffffffffu, s.mx);
  s.mn = __reduce_min_sync(0xffffffffu, s.mn);
  if (wl == 0) part[warp] = make_int4(s.late, s.mx, s.mn, s.events);
  __syncthreads();  // the warps' parts, and every lane's bin counts
  if (FILL) {
    for (int b = threadIdx.x; b < a.maxp; b += blockDim.x) {
      const int32_t n = hist[b];
      if (n) atomicAdd(&a.fill[b], n);
    }
  }
  if (warp == 0) {
    const int4 q = fold_warp(wl < kWarps ? part[wl] : stats_none());
    if (wl == 0) {
      // the block's slot: four words, each with the call's tag, stored
      // whole (volatile: the last block reads them as another block writes)
      volatile unsigned long long* w = a.slots + 4 * blockIdx.x;
      w[0] = tagged(tag, q.x);
      w[1] = tagged(tag, q.y);
      w[2] = tagged(tag, q.z);
      w[3] = tagged(tag, q.w);
      last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
    }
  }
  __syncthreads();  // ``last``; part[] read
  if (!last) return;
  // The last block: every block has stored its slot, maybe not yet where
  // this block reads it. No fence orders the slots before the tickets: a
  // thread a slot reads its words until each holds this call's tag (the
  // first read, as a rule).
  int4 r = stats_none();
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x) {
    const volatile unsigned long long* w = a.slots + 4 * b;
    unsigned long long x[4];
    bool ready;
    do {
      ready = true;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = w[j];
        ready &= (x[j] >> 32) == tag;
      }
    } while (!ready);
    r = combine(r, make_int4(static_cast<int32_t>(x[0]),
                             static_cast<int32_t>(x[1]),
                             static_cast<int32_t>(x[2]),
                             static_cast<int32_t>(x[3])));
  }
  r = fold_warp(r);
  if (wl == 0) part[warp] = r;
  __syncthreads();
  if (warp != 0) return;
  r = fold_warp(wl < kWarps ? part[wl] : stats_none());
  if (wl == 0) {
    a.stats[0] = r.x;  // late lanes
    a.stats[1] = r.y;  // max live pane (kPaneNone: none)
    a.stats[2] = r.z;  // min live pane (INT32_MAX: none)
    a.stats[3] = r.w;  // valid lanes (the drain's "events")
    *a.ticket = 0;     // for the next call on this scratch
    *a.calls = tag;    // the next call's tag is one more
  }
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// Dynamic shared memory of an instance: the fill's bins and the staged
// residency mask. maxp runs to 32,768 (128 KB of bins, 32 KB of mask),
// past the default 48 KB: the launch opts in.
template <bool FILL, bool RES>
cudaError_t launch(const RouteArgs& a, cudaStream_t s) {
  const int bytes =
      (FILL ? a.maxp * static_cast<int>(sizeof(int32_t)) : 0) +
      (RES ? a.maxp : 0);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        route_lanes_kernel<FILL, RES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  // a group of 4 lanes a thread
  const long long items = (static_cast<long long>(a.B) + 3) / 4;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (FILL || RES) {
    const long long h = kg_hist_blocks(a.B, a.maxp, 4 * kThreads);
    blocks = blocks < h ? blocks : h;
  }
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSM;
  blocks = blocks < cap ? blocks : cap;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  blocks = blocks > 0 ? blocks : 1;  // an empty batch writes the sentinels
  route_lanes_kernel<FILL, RES>
      <<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The scratch a call needs, in int32 words: kMaxBlocks 32-byte slots, the
// ticket and the count of calls, zeroed once by the caller.
extern "C" int route_lanes_scratch_words() { return kMaxBlocks * 8 + 4; }

// ``fill`` null: no key-group fill; else an int32 [maxp] histogram, zeroed
// by the caller, that the mine lanes add to. ``res`` null: no residency;
// else a bool [maxp] mask, and ``cold_out`` a bool [B] output. ``scratch``:
// route_lanes_scratch_words() int32 words, 16-byte aligned, zeroed before
// the first call and left as each call leaves it; one call at a time.
extern "C" int route_lanes(const void* hi, const void* lo, const void* ts,
                           const void* valid, int B, const void* watermark,
                           const void* purged_through, int slide, int k,
                           int L, int maxp, int kg_start, int kg_end,
                           void* pane_out, void* kg_out, void* live_out,
                           void* stats, void* fill, const void* res,
                           void* cold_out, void* scratch, void* stream) {
  // an empty batch's cold_out may be null (an empty tensor's pointer)
  if ((B > 0 && (res == nullptr) != (cold_out == nullptr)) || B < 0 ||
      slide < 1 || maxp < 1 || !aligned(scratch, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RouteArgs a;
  a.hi = static_cast<const uint32_t*>(hi);
  a.lo = static_cast<const uint32_t*>(lo);
  a.ts = static_cast<const int32_t*>(ts);
  a.valid = static_cast<const uint8_t*>(valid);
  a.B = B;
  a.watermark = static_cast<const int32_t*>(watermark);
  a.purged_through = static_cast<const int32_t*>(purged_through);
  a.slide = slide;
  a.k = k;
  a.L = L;
  a.maxp = maxp;
  a.kg_mask = (maxp & (maxp - 1)) == 0 ? maxp - 1 : -1;
  a.kg_start = kg_start;
  a.kg_end = kg_end;
  a.by_slide = div_magic(slide);
  a.pane_out = static_cast<int32_t*>(pane_out);
  a.kg_out = static_cast<int32_t*>(kg_out);
  a.live_out = static_cast<uint8_t*>(live_out);
  a.stats = static_cast<int32_t*>(stats);
  a.fill = static_cast<int32_t*>(fill);
  a.res = static_cast<const uint8_t*>(res);
  a.cold_out = static_cast<uint8_t*>(cold_out);
  a.slots = static_cast<unsigned long long*>(scratch);
  a.ticket = reinterpret_cast<unsigned int*>(a.slots + 4 * kMaxBlocks);
  a.calls = a.ticket + 1;
  a.vec = aligned(hi, 16) && aligned(lo, 16) && aligned(ts, 16) &&
          aligned(pane_out, 16) && aligned(kg_out, 16) && aligned(valid, 4) &&
          aligned(live_out, 4) &&
          (cold_out == nullptr || aligned(cold_out, 4));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (fill == nullptr && res == nullptr) {
    e = launch<false, false>(a, s);
  } else if (res == nullptr) {
    e = launch<true, false>(a, s);
  } else if (fill == nullptr) {
    e = launch<false, true>(a, s);
  } else {
    e = launch<true, true>(a, s);
  }
  return static_cast<int>(e);
}
