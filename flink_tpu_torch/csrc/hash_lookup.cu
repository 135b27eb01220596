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
// written). An invalid lane is not looked up (slot C, not found, not
// counted). The key EMPTY (integer key -1) is never found, as in the
// reference; its valid lanes count as missing, and the update takes them to
// the overflow ring like any other absent key.
//
// Bound: bytes. Per lane it reads hi, lo (4 B each) and valid (1 B) and
// writes slot (4 B) and found (1 B), 14 B; each table word on a chain up
// to the key, or the whole chain of an absent key, is read once, 8 B. The
// table's random reads set the time, one 32-byte sector a lane (G5's note:
// the sparse job's deepest key sits 34-38 deep); an absent key reads its
// whole chain, as the reference does (hash_probe.cuh find_key), five round
// trips and 544 bytes at P = 64.
//
// Design: one kernel a call, a thread a lane, find_key's sector-then-line
// walk. n_missing needs no fill: each block adds its count to a fold word
// of the stream's TableScratch with one atomic (blocks done in the high
// half), and the block that completes it writes n_missing and zeroes the
// word for the next call. An empty batch launches one block, which writes
// 0.

#include "common.cuh"
#include "hash_probe.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
lookup_kernel(const unsigned long long* __restrict__ table,
              const uint32_t* __restrict__ hi,
              const uint32_t* __restrict__ lo,
              const uint8_t* __restrict__ valid, int B, int C, int P,
              int32_t* __restrict__ slot, uint8_t* __restrict__ found,
              int32_t* __restrict__ n_missing, TableScratch* sc) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int32_t missing = 0;
  if (i < B) {
    int32_t s = C;
    if (valid[i]) {
      const uint32_t h = hi[i], l = lo[i];
      s = find_key<kVec>(table, key_word(h, l),
                         probe_hash(h, l) & (uint32_t(C) - 1u), C, P);
      missing = s == C;
    }
    slot[i] = s;
    found[i] = s < C;
  }
  missing = block_sum(missing);
  uint32_t total;
  if (threadIdx.x == 0 &&
      fold_last(&sc->lookup_fold, static_cast<uint32_t>(missing), &total)) {
    *n_missing = static_cast<int32_t>(total);
  }
}

}  // namespace

// scratch: a TableScratch, zeroed before the first call on its stream.
extern "C" int hash_lookup(const void* table, const void* hi, const void* lo,
                           const void* valid, int B, int C, int P, void* slot,
                           void* found, void* n_missing, void* scratch,
                           void* stream) {
  if (C <= 0 || (C & (C - 1)) != 0 || P < 1 || B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = B > 0 ? (B + kThreads - 1) / kThreads : 1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const unsigned long long*>(table);
  const auto* h = static_cast<const uint32_t*>(hi);
  const auto* l = static_cast<const uint32_t*>(lo);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* sl = static_cast<int32_t*>(slot);
  auto* f = static_cast<uint8_t*>(found);
  auto* nm = static_cast<int32_t*>(n_missing);
  auto* sc = static_cast<TableScratch*>(scratch);
  if (reinterpret_cast<uintptr_t>(table) % 16 == 0) {
    lookup_kernel<true><<<blocks, kThreads, 0, st>>>(t, h, l, v, B, C, P, sl,
                                                     f, nm, sc);
  } else {
    lookup_kernel<false><<<blocks, kThreads, 0, st>>>(t, h, l, v, B, C, P,
                                                      sl, f, nm, sc);
  }
  return static_cast<int>(cudaGetLastError());
}
