// G14 sketch_update — scatter one micro-batch into the sketch registers of
// the split state planes, one thread per lane.
//
// Replaces (flink_tpu, the JAX reference): the sketch branch of
// ops/window_kernels.py update (window_kernels.py:845-852, kernel K4),
// ops/sketches.py CountMinSketch.expand (:112) and HyperLogLog.expand
// (:195) (kernel K19), and the add / max scatter_combine of
// ops/segment.py (:150, kernel K3) that lands them; with them the update's
// too-old drop, its changelog bits kg_dirty and the split plane's touched
// scatter (:735-790, 916). The slot comes in as an operand, as for G3: what
// G5 hash_upsert placed or G8 hash_lookup found, or the key itself in the
// direct layout; C means none. A sketch stage has no overflow ring
// (overflow_supported is false for it, as in the reference), so a live lane
// with no slot counts into dropped_capacity.
//
// Layout: acc is the split register plane [R*C, W] int32, pane-major (ring
// row r, slot c at row r*C + c); touched is [R*C] bytes. The lane's item
// hash (a uint32, hashed on the host) arrives in the values column as int32
// bits. Count-Min (mode 0): W = D * width; row d's register is
// fmix32(h ^ seed_d) & (width - 1), and each of the D registers gains 1.
// HyperLogLog (mode 1): W = 2^p; x = fmix32(h), register x >> (32 - p)
// takes max(register, rho), rho = clz(x << p) + 1, or 33 - p when that
// word is 0.
//
// Bound: bytes. Per lane it reads pane, kg, slot, hash (4 B each) and live
// (1 B); each register it changes is read and written once (8 B), each
// touched byte written once. A 262,144-lane batch moves at most 6.6 MB
// (HyperLogLog) or 12.8 MB (Count-Min, D = 4), 2.0 or 3.8 us at
// 3.35 TB/s, and less where lanes share a register. The
// registers land in random 32-byte sectors, so the traffic is
// sector-bound, and hot addresses serialize: in a Count-Min batch of the
// nexmark bid stream a few thousand lanes add into the same D registers.
//
// Design: no sort and no pre-combine. Integer atomics are exact and
// order-free, so the planes equal the plain version's bit for bit: each
// Count-Min lane issues D fire-and-forget atomicAdds; a HyperLogLog lane
// reads its register first and issues its atomicMax only when it would
// raise it (registers only grow, so a stale read costs an atomic, never a
// wrong value), which keeps the many lanes of a saturated register off the
// L2 atomic units. touched and kg_dirty are byte flags stored only where
// they still read 0; their races are benign, every writer stores 1.
// Dropped lanes reduce per block and land with one atomic.

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__global__ void sketch_update_kernel(
    int32_t* __restrict__ acc, uint8_t* __restrict__ touched,
    uint8_t* __restrict__ kg_dirty, int32_t* __restrict__ dropped_capacity,
    const int32_t* __restrict__ pane, const int32_t* __restrict__ kg,
    const uint8_t* __restrict__ live, const int32_t* __restrict__ slot,
    const uint32_t* __restrict__ hashes,
    const int32_t* __restrict__ max_pane,
    const uint32_t* __restrict__ seeds, int B, int C, int R, int W,
    int mode, int depth, int row_width, int p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t dropped = 0;
  if (i < B && live[i]) {
    const int32_t pn = pane[i];
    const int32_t oldest = *max_pane - (R - 1);  // ring horizon
    if (pn < oldest) {
      dropped = 1;  // too old
    } else {
      if (kg_dirty != nullptr && kg_dirty[kg[i]] == 0) kg_dirty[kg[i]] = 1;
      const uint32_t s = static_cast<uint32_t>(slot[i]);
      if (s < static_cast<uint32_t>(C)) {
        const size_t flat = static_cast<size_t>(floor_mod(pn, R)) * C + s;
        if (touched[flat] == 0) touched[flat] = 1;
        int32_t* regs = acc + flat * static_cast<size_t>(W);
        const uint32_t h = hashes[i];
        if (mode == 0) {  // Count-Min: D increments
          for (int d = 0; d < depth; ++d) {
            const uint32_t pos = fmix32(h ^ seeds[d]) &
                                 static_cast<uint32_t>(row_width - 1);
            atomicAdd(regs + static_cast<size_t>(d) * row_width + pos, 1);
          }
        } else {  // HyperLogLog: one rank max
          const uint32_t x = fmix32(h);
          const uint32_t bucket = x >> (32 - p);
          const uint32_t w = x << p;
          const int32_t rho = w == 0u ? 32 - p + 1 : __clz(w) + 1;
          if (regs[bucket] < rho) atomicMax(regs + bucket, rho);
        }
      } else {
        dropped = 1;  // no slot, and a sketch stage has no overflow ring
      }
    }
  }
  dropped = block_sum(dropped);
  if (threadIdx.x == 0 && dropped) atomicAdd(dropped_capacity, dropped);
}

}  // namespace

extern "C" int sketch_update(void* acc, void* touched, void* kg_dirty,
                             void* dropped_capacity, const void* pane,
                             const void* kg, const void* live,
                             const void* slot, const void* hashes,
                             const void* max_pane, const void* seeds, int B,
                             int C, int R, int W, int mode, int depth,
                             int row_width, int p, void* stream) {
  if (mode == 0 && (row_width <= 0 || depth * row_width != W))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 1 && (p < 4 || p > 16 || W != (1 << p)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  if (blocks > 0) {
    sketch_update_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(acc), static_cast<uint8_t*>(touched),
        static_cast<uint8_t*>(kg_dirty),
        static_cast<int32_t*>(dropped_capacity),
        static_cast<const int32_t*>(pane), static_cast<const int32_t*>(kg),
        static_cast<const uint8_t*>(live), static_cast<const int32_t*>(slot),
        static_cast<const uint32_t*>(hashes),
        static_cast<const int32_t*>(max_pane),
        static_cast<const uint32_t*>(seeds), B, C, R, W, mode, depth,
        row_width, p);
  }
  return static_cast<int>(cudaGetLastError());
}
