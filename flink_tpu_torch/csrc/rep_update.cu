// G16 rep_update — the gather and the set around a generic reduce's
// segment combine: rep_gather reads, for each lane of G10's sorted order,
// its value and its segment's old accumulator; rep_set writes each
// segment's merged value back at its representative and does the update's
// lane-order bookkeeping.
//
// Replaces (flink_tpu, the JAX reference): the generic branch of
// ops/window_kernels.py update (:916-927, kernel K4): ops/segment.py
// preaggregate's gather through the sort permutation with the neutral in
// dead lanes (:131, reduce_sorted :117, kernel K3), the gather of `old` and
// `touched` at the representatives, and the set of `merged`, with the
// touched plane's set, the kg_dirty marking of the live lanes, the drop
// count of too-old lanes and lanes with no slot (:735-760, :832-840) and
// the allowed-lateness fresh marking (:936-945); and the same gather and
// set of ops/rolling.py update (:54-110, kernel K18), whose lanes each
// emit their key's running value in lane order.
//
// The combine between the two launches is the user's function: the
// reference traces an arbitrary jnp callable into XLA, and no hand kernel
// can take an arbitrary Python callable. ops/window_kernels.py and
// ops/rolling.py run it as torch ops over a log-step (Hillis-Steele)
// segmented scan of G10's sorted order, then once more to merge with the
// old accumulator. This is the one path of the port whose combine has no
// hand kernel; its sort (G10), gather and set (G16) and compaction at
// fire (G6 fire_pack) are.
//
// Layout: acc [N, W] float32 rows (N = C*R pane-major cells for a window,
// C slots for a rolling reduce), touched [N] bytes; key_s int64 [B] the
// sorted lanes' row, N for a dead lane; order int32 [B] the gather
// permutation; values [B, W] in lane order.
//
// Bound: bytes. rep_gather reads order and key_s (12 B a lane), a lane's
// W values and its row's W + 1 (4 W + 4 W + 1 B), and writes 2 W floats
// and a byte: at B = 262,144, W = 1 about 8.4 MB, 2.5 us at 3.35 TB/s.
// rep_set reads the sorted keys and flags and the merged values and writes
// one row per segment, plus the lane-order bookkeeping (pane, kg, slot,
// live: 13 B a lane): about 7 MB, 2.1 us.
//
// Design: one thread per lane, W columns in a loop; the gathers at key_s
// are scattered (random rows of the plane). In rep_set the representative
// of a segment is its last sorted lane (the next lane starts a segment, or
// none follows), so each row is written by exactly one thread: no atomics
// on the plane. Thread i also handles lane i in lane order for the
// bookkeeping; drops and fresh lanes reduce per block and land with one
// atomic each, kg_dirty and fresh are set-only byte flags (benign races).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void rep_gather_kernel(const int32_t* __restrict__ order,
                                  const long long* __restrict__ key_s,
                                  const float* __restrict__ values,
                                  const float* __restrict__ acc,
                                  const uint8_t* __restrict__ touched,
                                  const float* __restrict__ neutral, int B,
                                  int W, long long N, float* __restrict__ v_s,
                                  float* __restrict__ old,
                                  uint8_t* __restrict__ old_t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const long long key = key_s[i];
  const bool live = key < N;
  const size_t src = static_cast<size_t>(order[i]);
  const size_t at = static_cast<size_t>(i) * W;
  for (int w = 0; w < W; ++w) {
    v_s[at + w] = live ? values[src * W + w] : neutral[w];
    old[at + w] = live ? acc[static_cast<size_t>(key) * W + w] : neutral[w];
  }
  old_t[i] = live && touched[key] ? 1 : 0;
}

__global__ void rep_set_kernel(
    float* __restrict__ acc, uint8_t* __restrict__ touched, int W,
    long long N, const int32_t* __restrict__ order,
    const long long* __restrict__ key_s, const uint8_t* __restrict__ seg_start,
    const float* __restrict__ merged, int B, float* __restrict__ out,
    const int32_t* __restrict__ pane, const int32_t* __restrict__ kg,
    const uint8_t* __restrict__ live, const int32_t* __restrict__ slot,
    const int32_t* __restrict__ max_pane, int C, int R,
    uint8_t* __restrict__ kg_dirty, int32_t* __restrict__ dropped_capacity,
    uint8_t* __restrict__ fresh, const int32_t* __restrict__ fired_through,
    int32_t* __restrict__ n_fresh) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t dropped = 0, marked = 0;
  if (i < B) {
    const long long key = key_s[i];
    const size_t at = static_cast<size_t>(i) * W;
    if (key < N && (i == B - 1 || seg_start[i + 1])) {
      float* row = acc + static_cast<size_t>(key) * W;
      for (int w = 0; w < W; ++w) row[w] = merged[at + w];
      touched[key] = 1;
    }
    if (out != nullptr) {
      const size_t o = static_cast<size_t>(order[i]) * W;
      for (int w = 0; w < W; ++w) out[o + w] = merged[at + w];
    }
    if (pane != nullptr && live[i]) {  // lane i, in lane order
      const int32_t p = pane[i];
      if (p < *max_pane - (R - 1)) {
        dropped = 1;  // too old
      } else {
        if (kg_dirty != nullptr && kg_dirty[kg[i]] == 0) kg_dirty[kg[i]] = 1;
        const uint32_t s = static_cast<uint32_t>(slot[i]);
        if (s >= static_cast<uint32_t>(C)) {
          dropped = 1;  // no slot (a generic reduce has no spill tier)
        } else if (fresh != nullptr && p <= *fired_through) {
          fresh[static_cast<size_t>(floor_mod(p, R)) * C + s] = 1;
          marked = 1;
        }
      }
    }
  }
  if (pane != nullptr) {  // uniform per launch
    dropped = block_sum(dropped);
    if (threadIdx.x == 0 && dropped) atomicAdd(dropped_capacity, dropped);
    if (fresh != nullptr) {
      marked = block_sum(marked);
      if (threadIdx.x == 0 && marked) atomicAdd(n_fresh, marked);
    }
  }
}

}  // namespace

extern "C" int rep_gather(const void* order, const void* key_s,
                          const void* values, const void* acc,
                          const void* touched, const void* neutral, int B,
                          int W, long long N, void* v_s, void* old,
                          void* old_t, void* stream) {
  if (W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kThreads - 1) / kThreads;
  if (blocks > 0) {
    rep_gather_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(order),
        static_cast<const long long*>(key_s),
        static_cast<const float*>(values), static_cast<const float*>(acc),
        static_cast<const uint8_t*>(touched),
        static_cast<const float*>(neutral), B, W, N,
        static_cast<float*>(v_s), static_cast<float*>(old),
        static_cast<uint8_t*>(old_t));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rep_set(void* acc, void* touched, int W, long long N,
                       const void* order, const void* key_s,
                       const void* seg_start, const void* merged, int B,
                       void* out, const void* pane, const void* kg,
                       const void* live, const void* slot,
                       const void* max_pane, int C, int R, void* kg_dirty,
                       void* dropped_capacity, void* fresh,
                       const void* fired_through, void* n_fresh,
                       void* stream) {
  if (W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kThreads - 1) / kThreads;
  if (blocks > 0) {
    rep_set_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(acc), static_cast<uint8_t*>(touched), W, N,
        static_cast<const int32_t*>(order),
        static_cast<const long long*>(key_s),
        static_cast<const uint8_t*>(seg_start),
        static_cast<const float*>(merged), B, static_cast<float*>(out),
        static_cast<const int32_t*>(pane), static_cast<const int32_t*>(kg),
        static_cast<const uint8_t*>(live), static_cast<const int32_t*>(slot),
        static_cast<const int32_t*>(max_pane), C, R,
        static_cast<uint8_t*>(kg_dirty),
        static_cast<int32_t*>(dropped_capacity),
        static_cast<uint8_t*>(fresh),
        static_cast<const int32_t*>(fired_through),
        static_cast<int32_t*>(n_fresh));
  }
  return static_cast<int>(cudaGetLastError());
}
