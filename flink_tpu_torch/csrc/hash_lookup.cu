// G8 hash_lookup — find a micro-batch of keys in the hash state layout's
// table without inserting any, one thread per lane: the fast step's probe.
//
// Replaces (flink_tpu, the JAX reference): ops/hashtable.py lookup (:94,
// kernel K9, over _chain/_probe :75-91) as the lookup-only fast update of
// ops/window_kernels.py update(insert=False) runs it (:805-816, kernel K10):
// each lane's P-long linear probe from probe_hash(hi, lo) & (C - 1),
// wrapping at C; slot, or C when the key is absent; and the update's
// `activity` in fast mode, the valid lanes whose key is missing, reduced on
// the card so the executor's step tiering reads one scalar per drain.
//
// Outputs: slot (int32, C where not found), found (byte), n_missing (int32,
// added to, the caller zeroes it). An invalid lane is not looked up (slot
// C, not found, not counted). The key EMPTY (integer key -1) is never
// found, as in the reference; its valid lanes count as missing, and the
// update takes them to the overflow ring like any other absent key.
//
// Bound: bytes. Per lane it reads hi, lo (4 B each) and valid (1 B) and
// writes slot (4 B) and found (1 B), 14 B; each table word on a chain up
// to the key, or to the first EMPTY slot for an absent key, is read once,
// 8 B. The walk stops at the first EMPTY slot (hash_probe.cuh: a key never
// sits behind one), so an absent key costs about as much as a present one
// instead of P reads. The probe reads are scattered 8-byte loads, sector-
// bound rather than byte-bound, into a table (16 MB at C = 2^21) that fits
// the 50 MB L2.

#include "common.cuh"
#include "hash_probe.cuh"

namespace {

__global__ void hash_lookup_kernel(const unsigned long long* __restrict__ table,
                                   const uint32_t* __restrict__ hi,
                                   const uint32_t* __restrict__ lo,
                                   const uint8_t* __restrict__ valid, int B,
                                   int C, int P, int32_t* __restrict__ slot,
                                   uint8_t* __restrict__ found,
                                   int32_t* __restrict__ n_missing) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t missing = 0;
  if (i < B) {
    int32_t s = C;
    if (valid[i]) {
      s = find_key(table, hi[i], lo[i], C, P);
      missing = s == C;
    }
    slot[i] = s;
    found[i] = s < C;
  }
  missing = block_sum(missing);
  if (threadIdx.x == 0 && missing) atomicAdd(n_missing, missing);
}

}  // namespace

extern "C" int hash_lookup(const void* table, const void* hi, const void* lo,
                           const void* valid, int B, int C, int P, void* slot,
                           void* found, void* n_missing, void* stream) {
  if (C <= 0 || (C & (C - 1)) != 0 || P < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  if (blocks > 0) {
    hash_lookup_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned long long*>(table),
        static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
        static_cast<const uint8_t*>(valid), B, C, P,
        static_cast<int32_t*>(slot), static_cast<uint8_t*>(found),
        static_cast<int32_t*>(n_missing));
  }
  return static_cast<int>(cudaGetLastError());
}
