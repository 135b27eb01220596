// G28 remove_slots — mark table slots empty: the hash layout's point
// removal.
//
// Replaces (flink_tpu, the JAX reference): ops/hashtable.py:191
// remove_slots (kernel K9): ``keys.at[where(mask, slots, C)].set(EMPTY,
// mode="drop")``. Each lane i with mask[i] clears table[slots[i]] to the
// empty word (EMPTY_WORD, the all-ones 64-bit key word the port keeps for
// the reference's EMPTY row). A slot in [-C, 0) counts from the end, as
// jnp's indexing wraps a negative index before the scatter drops what
// lies outside [0, C); any other slot, and every masked-off lane, is
// dropped. Lanes that clear one slot write the same word, so their order
// does not matter. Neither package calls it on a path (the reference's
// docstring keeps it for rebuilds): G5 and G8 stop at a chain's first
// empty slot, so a slot cleared mid-chain can hide the keys behind it.
//
// Bound: bytes. Per lane it reads the slot (4 or 8 B) and the mask (1 B)
// and writes one 8-byte word for each lane it clears (a scattered store:
// a 32-byte sector each).
//
// Design: one thread a lane, plain stores.

#include "common.cuh"

namespace {

template <typename I>
__global__ void remove_slots_kernel(unsigned long long* __restrict__ table,
                                    long long C, const I* __restrict__ slots,
                                    const uint8_t* __restrict__ mask, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B || !mask[i]) return;
  long long s = static_cast<long long>(slots[i]);
  if (s < 0) s += C;
  if (s >= 0 && s < C) table[s] = ~0ull;
}

}  // namespace

// slot_bytes 4 (int32 slots) or 8 (int64).
extern "C" int remove_slots(void* table, long long C, const void* slots,
                            int slot_bytes, const void* mask, int B,
                            void* stream) {
  if (C <= 0 || B < 0 || (slot_bytes != 4 && slot_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  auto* t = static_cast<unsigned long long*>(table);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto st = static_cast<cudaStream_t>(stream);
  if (blocks > 0 && slot_bytes == 8) {
    remove_slots_kernel<<<blocks, threads, 0, st>>>(
        t, C, static_cast<const long long*>(slots), m, B);
  } else if (blocks > 0) {
    remove_slots_kernel<<<blocks, threads, 0, st>>>(
        t, C, static_cast<const int32_t*>(slots), m, B);
  }
  return static_cast<int>(cudaGetLastError());
}
