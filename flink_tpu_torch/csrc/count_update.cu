// G12 count_update — per-key tumbling windows of N elements for one
// micro-batch, over the lanes in G10's slot order.
//
// Replaces (flink_tpu, the JAX reference): ops/count_windows.py update
// (:57, kernel K17) after its upsert and sort: each lane's 1-based position
// within its key (a segmented count), its absolute index a = old_count +
// pos and window w = (a - 1) // N, the segmented reduce over (slot, w), the
// key's carried partial folded into its first window (:98-106), the
// complete windows (a a multiple of N) as fire rows, and the tail partial,
// the count and `touched` written back (:116-124).
//
// Inputs: key_s (uint64 [B], the slot or C), seg_start (uint8 [B]), order
// (int32 [B]) from G10; hi, lo, vals (lane order); the state count (int32
// [C]), acc (float32 [C]) and touched (uint8 [C]), written in place.
// Outputs: the fire rows (key hi, key lo, window ordinal, value) at row
// positions n_rows, n_rows + 1, ... in sorted-lane order, as the
// reference's mask over its sorted lanes orders them; n_rows advances.
//
// Design: two segmented scans (segscan.cuh): the position (a count per
// slot segment), then the window reduce, whose segments start where the
// slot changes or a - 1 is a multiple of N. The second scan's store pass
// folds the partial and leaves each lane's a, w, value and fire flag in
// scratch. Then ring.cuh compacts the fires to rows, stably, and a last
// launch writes the state back (lanes of one key in other blocks read it
// during the scans).
//
// Bound: bytes. Per lane: key (8 B), flag (1 B), order (4 B) and value
// (4 B); per fire: hi and lo through the order (8 B) and the row (16 B);
// per key of the batch count, acc and touched read and written (9 B
// each). The function reads hi and lo of the fired lanes only, about one
// lane in N.

#include "ring.cuh"
#include "segscan.cuh"

namespace {

struct PosSrc {
  using V = int32_t;
  const uint8_t* seg_start;
  int32_t* pos;

  __device__ static int32_t op(int32_t a, int32_t b) { return a + b; }
  __device__ int32_t flag(int i) const { return seg_start[i]; }
  __device__ int32_t value(int) const { return 1; }
  __device__ void store(int i, int32_t, int32_t incl) const { pos[i] = incl; }
};

struct CountScratch {
  int32_t* a;
  int32_t* w;
  float* v;
  uint8_t* fire;
};

struct WinSrc {
  using V = float;
  const unsigned long long* key_s;
  const uint8_t* seg_start;
  const int32_t* order;
  const float* vals;
  const int32_t* pos;
  const int32_t* count;
  const float* acc;
  const uint8_t* touched;
  CountScratch out;
  int C;
  int N;

  __device__ static float op(float a, float b) { return a + b; }
  __device__ int slot(int i) const { return static_cast<int>(key_s[i]); }
  __device__ int32_t old_count(int i) const {
    const int s = slot(i);
    return s < C ? count[s] : 0;
  }
  __device__ int32_t flag(int i) const {
    const int32_t a = old_count(i) + pos[i];
    return seg_start[i] || (a - 1) % N == 0;
  }
  __device__ float value(int i) const {
    return slot(i) < C ? vals[order[i]] : 0.0f;
  }
  __device__ void store(int i, int32_t, float incl) const {
    const int s = slot(i);
    const bool live = s < C;
    const int32_t old = live ? count[s] : 0;
    const int32_t a = old + pos[i];
    const int32_t w = (a - 1) / N;
    float rolled = incl;
    if (live && w == old / N && touched[s] && old % N != 0) rolled = acc[s] + incl;
    out.a[i] = a;
    out.w[i] = w;
    out.v[i] = rolled;
    out.fire[i] = live && a % N == 0;
  }
};

struct FireSrc {
  const uint8_t* fire;
  const int32_t* order;
  const uint32_t* hi;
  const uint32_t* lo;
  const int32_t* w;
  const float* v;

  __device__ bool take(int i) const { return fire[i] != 0; }
  __device__ void lane(int i, RingOut out, int32_t pos) const {
    const int32_t j = order[i];
    out.hi[pos] = hi[j];
    out.lo[pos] = lo[j];
    out.pane[pos] = w[i];
    out.val[pos] = v[i];
  }
};

__global__ void count_writeback_kernel(const unsigned long long* __restrict__ key_s,
                                       const uint8_t* __restrict__ seg_start,
                                       const int32_t* __restrict__ a_of,
                                       const float* __restrict__ v_of, int n,
                                       int C, int N, int32_t* __restrict__ count,
                                       float* __restrict__ acc,
                                       uint8_t* __restrict__ touched) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = static_cast<int>(key_s[i]);
  if (s < C && (i == n - 1 || seg_start[i + 1])) {
    const int32_t a = a_of[i];
    const bool tail = a % N != 0;
    count[s] = a;
    acc[s] = tail ? v_of[i] : 0.0f;
    touched[s] = tail;
  }
}

}  // namespace

// scratch: pos, a, w int32 [B]; v float32 [B]; fire uint8 [B]; blk (scan
// pairs); blk_count, blk_off int32 [ceil(B / kRingChunk)]; lost int32 0-d.
extern "C" int count_update(const void* key_s, const void* seg_start,
                            const void* order, const void* hi, const void* lo,
                            const void* vals, int B, int C, int N,
                            void* count, void* acc, void* touched, int O,
                            void* row_hi, void* row_lo, void* row_w,
                            void* row_val, void* n_rows, void* pos, void* a,
                            void* w, void* v, void* fire, void* blk,
                            void* blk_count, void* blk_off, void* lost,
                            void* stream) {
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ks = static_cast<const unsigned long long*>(key_s);
  const auto* ss = static_cast<const uint8_t*>(seg_start);
  const auto* ord = static_cast<const int32_t*>(order);
  const PosSrc ps{ss, static_cast<int32_t*>(pos)};
  int rc = seg_scan_launch(ps, B, blk, s);
  if (rc) return rc;
  const CountScratch sc{static_cast<int32_t*>(a), static_cast<int32_t*>(w),
                        static_cast<float*>(v), static_cast<uint8_t*>(fire)};
  const WinSrc ws{ks, ss, ord, static_cast<const float*>(vals),
                  static_cast<const int32_t*>(pos),
                  static_cast<const int32_t*>(count),
                  static_cast<const float*>(acc),
                  static_cast<const uint8_t*>(touched), sc, C, N};
  rc = seg_scan_launch(ws, B, blk, s);
  if (rc) return rc;
  const FireSrc fs{sc.fire, ord, static_cast<const uint32_t*>(hi),
                   static_cast<const uint32_t*>(lo), sc.w, sc.v};
  const RingOut out{static_cast<uint32_t*>(row_hi),
                    static_cast<uint32_t*>(row_lo),
                    static_cast<int32_t*>(row_w), static_cast<float*>(row_val)};
  rc = ring_append_launch(fs, B, O, out, static_cast<int32_t*>(n_rows),
                          static_cast<int32_t*>(lost),
                          static_cast<int32_t*>(blk_count),
                          static_cast<int32_t*>(blk_off), s);
  if (rc) return rc;
  if (B > 0) {
    count_writeback_kernel<<<(B + 255) / 256, 256, 0, s>>>(
        ks, ss, sc.a, sc.v, B, C, N, static_cast<int32_t*>(count),
        static_cast<float*>(acc), static_cast<uint8_t*>(touched));
  }
  return static_cast<int>(cudaGetLastError());
}
