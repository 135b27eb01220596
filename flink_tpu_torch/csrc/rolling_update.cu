// G13 rolling_update — the rolling keyed reduce of one micro-batch (sum;
// a count sums the ones its extractor gives), over the lanes in G10's
// slot order.
//
// Replaces (flink_tpu, the JAX reference): ops/rolling.py update (:54,
// kernel K18) after its upsert and sort: the segmented inclusive scan of
// the sorted values, the key's pre-batch accumulator folded into every
// lane of a touched key (:86-91), the outputs scattered back to lane
// order (:93-95: out[order[i]] = rolled[i]), and each segment's total and
// `touched` written back (:98-103).
//
// Inputs: key_s (uint64 [B], the sorted slot keys: the slot, or C for a
// lane with no slot), seg_start (uint8 [B]), order (int32 [B]) from G10;
// vals (float32 [B], lane order); the state acc (float32 [C]) and touched
// (uint8 [C]), written back in place; out (float32 [B], lane order).
//
// Design: segscan.cuh's three passes, the store pass adding the old
// accumulator and scattering to lane order; a fourth launch writes the
// segment totals back. The write-back is its own launch because lanes of
// one segment in other blocks read acc[slot] during the scan.
//
// Bound: bytes. Per lane it reads the key (8 B), flag (1 B), order (4 B)
// and value (4 B), and writes the output (4 B); per key of the batch it
// reads and writes acc and touched (5 B each). 262,144 lanes of ~190,000
// keys: ~7.4 MB, about 2.2 us at 3.35 TB/s.

#include "segscan.cuh"

namespace {

struct RollSrc {
  using V = float;
  const unsigned long long* key_s;
  const uint8_t* seg_start;
  const int32_t* order;
  const float* vals;
  const float* acc;
  const uint8_t* touched;
  float* out;
  int C;

  __device__ static float op(float a, float b) { return a + b; }
  __device__ int slot(int i) const { return static_cast<int>(key_s[i]); }
  __device__ int32_t flag(int i) const { return seg_start[i]; }
  __device__ float value(int i) const {
    return slot(i) < C ? vals[order[i]] : 0.0f;
  }
  __device__ void store(int i, int32_t, float incl) const {
    const int s = slot(i);
    out[order[i]] = (s < C && touched[s]) ? acc[s] + incl : incl;
  }
};

__global__ void roll_writeback_kernel(const unsigned long long* __restrict__ key_s,
                                      const uint8_t* __restrict__ seg_start,
                                      const int32_t* __restrict__ order,
                                      const float* __restrict__ out, int n,
                                      int C, float* __restrict__ acc,
                                      uint8_t* __restrict__ touched) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = static_cast<int>(key_s[i]);
  if (s < C && (i == n - 1 || seg_start[i + 1])) {
    acc[s] = out[order[i]];
    touched[s] = 1;
  }
}

}  // namespace

extern "C" int rolling_update(const void* key_s, const void* seg_start,
                              const void* order, const void* vals, int B,
                              int C, void* acc, void* touched, void* out,
                              void* blk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RollSrc src{static_cast<const unsigned long long*>(key_s),
                    static_cast<const uint8_t*>(seg_start),
                    static_cast<const int32_t*>(order),
                    static_cast<const float*>(vals),
                    static_cast<const float*>(acc),
                    static_cast<const uint8_t*>(touched),
                    static_cast<float*>(out), C};
  const int rc = seg_scan_launch(src, B, blk, s);
  if (rc) return rc;
  if (B > 0) {
    roll_writeback_kernel<<<(B + 255) / 256, 256, 0, s>>>(
        src.key_s, src.seg_start, src.order, src.out, B, C,
        static_cast<float*>(acc), static_cast<uint8_t*>(touched));
  }
  return static_cast<int>(cudaGetLastError());
}
