// G9 compact_table — rebuild the hash layout's key table around the keys
// that still hold pane state, and move their state to the new slots.
//
// Replaces (flink_tpu, the JAX reference): ops/window_kernels.py
// compact_table (:480-580, kernel K11) as runtime/step.py
// build_compact_step (:2391) runs it. A table never frees a slot (a probe
// chain must stay unbroken), so a stream whose keys churn fills it with
// dead keys; the executor compacts it after it drained the overflow ring.
// The steps, each a launch from ops/cuda.py compact_table:
//   1. alive: a slot is alive when any of its R ring rows is touched (the
//      packed plane's touch column differs from the reduce's neutral: 0
//      for sum and count, +FLT_MAX for min, -FLT_MAX for max; the `fresh`
//      plane the reference also reads is never set, since the spill tier
//      runs at allowed lateness 0 only);
//   2. G5 hash_upsert re-inserts the alive slots' keys into an empty table
//      (old slot c -> new slot[c], ok[c]); its CAS walk fails a key only
//      when every slot of its chain holds another key, where the reference
//      runs probe_len claim rounds;
//   3. move: each alive key's R packed cells (Wc = W + 1 floats: W value
//      columns, W = 2 for mean, and the touch column) go from its old slot
//      to its new one, every other cell of the new plane is the neutral;
//   4. export: the touched cells of alive keys that failed to fit go to the
//      overflow ring as (key, pane, W values) rows, in (row, slot) order, with
//      ring.cuh's stable append (G7's code), and are counted lost only when
//      the ring is full — the pane state of a live key is never dropped.
//
// Bound: bytes. The alive pass reads the touch column of every cell, the
// move writes every cell of the new plane and reads each alive key's cells
// once, and the table is read and rewritten: at C = 2^21, R = 12, Wc = 2
// about 2 x 201 MB + 2 x 16 MB, 0.13 ms at 3.35 TB/s. The alive pass reads
// the whole cell's sector for its touch column, and the move's reads of
// old cells are scattered by the new slot order.
//
// Design: the move is a gather over the new plane (coalesced writes, each
// cell written once, no separate clear) through an inverse map
// inv[new slot] = old slot that a scatter of the alive keys fills; the
// slot map is injective because the table holds each key once.

#include "ring.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void alive_kernel(const float* __restrict__ acc, int Wc,
                             float neutral, int C, int R,
                             uint8_t* __restrict__ alive) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  uint8_t a = 0;
  for (int r = 0; r < R && !a; ++r) {
    a = acc[(static_cast<size_t>(r) * C + c) * Wc + Wc - 1] != neutral;
  }
  alive[c] = a;
}

__global__ void inverse_kernel(const int32_t* __restrict__ slot,
                               const uint8_t* __restrict__ ok, int C,
                               int32_t* __restrict__ inv) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < C && ok[c]) inv[slot[c]] = c;
}

__global__ void move_kernel(const float* __restrict__ acc, int Wc,
                            float neutral, const int32_t* __restrict__ inv,
                            int C, float* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= C) return;
  const size_t row = static_cast<size_t>(blockIdx.y) * C;
  const int32_t c = inv[s];
  if (Wc == 2) {
    reinterpret_cast<float2*>(out)[row + s] =
        c >= 0 ? reinterpret_cast<const float2*>(acc)[row + c]
               : make_float2(neutral, neutral);
    return;
  }
  float* dst = out + (row + s) * Wc;
  for (int w = 0; w < Wc; ++w) {
    dst[w] = c >= 0 ? acc[(row + c) * Wc + w] : neutral;
  }
}

// the touched cells (lane i = r * C + c, the plane's own index) of alive
// keys that the new table could not take
struct EvictSrc {
  const float* acc;  // [R*C, Wc]
  const uint8_t* alive;
  const uint8_t* ok;
  const unsigned long long* table;
  const int32_t* pane_ids;
  int C;
  int Wc;
  float neutral;

  __device__ bool take(int i) const {
    const int c = i % C;
    return alive[c] && !ok[c] &&
           acc[static_cast<size_t>(i) * Wc + Wc - 1] != neutral;
  }
  __device__ void lane(int i, RingOut out, int32_t pos) const {
    const unsigned long long w = table[i % C];
    out.hi[pos] = static_cast<uint32_t>(w >> 32);
    out.lo[pos] = static_cast<uint32_t>(w);
    out.pane[pos] = pane_ids[i / C];
    for (int j = 0; j < out.W; ++j) {
      out.val[static_cast<size_t>(pos) * out.W + j] =
          acc[static_cast<size_t>(i) * Wc + j];
    }
  }
};

}  // namespace

extern "C" int compact_alive(const void* acc, int Wc, float neutral, int C,
                             int R, void* alive, void* stream) {
  if (C > 0) {
    alive_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(acc), Wc, neutral, C, R,
        static_cast<uint8_t*>(alive));
  }
  return static_cast<int>(cudaGetLastError());
}

// inv must hold -1 in every slot on entry
extern "C" int compact_move(const void* acc, int Wc, float neutral,
                            const void* slot, const void* ok, int C, int R,
                            void* inv, void* out, void* stream) {
  if (C <= 0 || R <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (C + kThreads - 1) / kThreads;
  inverse_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(slot), static_cast<const uint8_t*>(ok), C,
      static_cast<int32_t*>(inv));
  move_kernel<<<dim3(blocks, R), kThreads, 0, s>>>(
      static_cast<const float*>(acc), Wc, neutral,
      static_cast<const int32_t*>(inv), C, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int compact_export(const void* acc, int Wc, float neutral,
                              const void* alive, const void* ok,
                              const void* table, const void* pane_ids, int C,
                              int R, int O,
                              void* ovf_hi, void* ovf_lo, void* ovf_pane,
                              void* ovf_val, void* ovf_n, void* lost,
                              void* blk_count, void* blk_off, void* stream) {
  const EvictSrc src{static_cast<const float*>(acc),
                     static_cast<const uint8_t*>(alive),
                     static_cast<const uint8_t*>(ok),
                     static_cast<const unsigned long long*>(table),
                     static_cast<const int32_t*>(pane_ids), C, Wc, neutral};
  const RingOut out{static_cast<uint32_t*>(ovf_hi),
                    static_cast<uint32_t*>(ovf_lo),
                    static_cast<int32_t*>(ovf_pane),
                    static_cast<float*>(ovf_val), Wc - 1};
  return ring_append_launch(src, C * R, O, out, static_cast<int32_t*>(ovf_n),
                            static_cast<int32_t*>(lost),
                            static_cast<int32_t*>(blk_count),
                            static_cast<int32_t*>(blk_off),
                            static_cast<cudaStream_t>(stream));
}
