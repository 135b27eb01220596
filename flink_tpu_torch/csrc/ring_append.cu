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
// Bound: bytes. Per lane it reads the mask (1 B) twice over (counted
// once), and for each taken lane its hi, lo, pane and values (12 + 4 W B)
// and writes as much to the ring. A 262,144-lane batch with no nofit lane
// reads 256 KB, about 0.08 us at 3.35 TB/s, so on the steady path the
// three launches' fixed cost dominates; a batch of all-new keys in the
// fast step moves ~8.6 MB.
//
// Design: ring.cuh, a stable three-pass block scan (count, scan, write),
// the base read on the card.

#include "ring.cuh"

namespace {

struct LaneSrc {
  const uint8_t* mask;
  const uint32_t* hi;
  const uint32_t* lo;
  const int32_t* pane;
  const float* vals;  // [B, W]; null: a count, every lane contributes 1.0

  __device__ bool take(int i) const { return mask[i] != 0; }
  __device__ void lane(int i, RingOut out, int32_t pos) const {
    out.hi[pos] = hi[i];
    out.lo[pos] = lo[i];
    out.pane[pos] = pane[i];
    for (int w = 0; w < out.W; ++w) {
      out.val[static_cast<size_t>(pos) * out.W + w] =
          vals != nullptr ? vals[static_cast<size_t>(i) * out.W + w] : 1.0f;
    }
  }
};

}  // namespace

extern "C" int ring_append(const void* mask, const void* hi, const void* lo,
                           const void* pane, const void* vals, int W, int B,
                           int O,
                           void* ovf_hi, void* ovf_lo, void* ovf_pane,
                           void* ovf_val, void* ovf_n, void* lost,
                           void* blk_count, void* blk_off, void* stream) {
  const LaneSrc src{static_cast<const uint8_t*>(mask),
                    static_cast<const uint32_t*>(hi),
                    static_cast<const uint32_t*>(lo),
                    static_cast<const int32_t*>(pane),
                    static_cast<const float*>(vals)};
  const RingOut out{static_cast<uint32_t*>(ovf_hi),
                    static_cast<uint32_t*>(ovf_lo),
                    static_cast<int32_t*>(ovf_pane),
                    static_cast<float*>(ovf_val), W};
  return ring_append_launch(src, B, O, out, static_cast<int32_t*>(ovf_n),
                            static_cast<int32_t*>(lost),
                            static_cast<int32_t*>(blk_count),
                            static_cast<int32_t*>(blk_off),
                            static_cast<cudaStream_t>(stream));
}
