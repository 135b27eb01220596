// G5 hash_upsert — insert-or-find one micro-batch of keys in the hash state
// layout's open-addressing table, one thread per lane.
//
// Replaces (flink_tpu, the JAX reference): ops/hashing.py probe_hash (kernel
// K1's probe half) and ops/hashtable.py upsert_counted / _upsert_impl /
// _lookup_or_empty (kernel K9): a P-long linear probe chain from
// probe_hash(hi, lo) & (C - 1), wrapping at C, over a table of 64-bit key
// identities, with lanes of absent keys claiming the first free slot of
// their chain. The reference holds the table as uint32 [C, 2] rows and
// claims with four statically unrolled scatter rounds; here a slot is one
// 64-bit word (hi << 32) | lo, EMPTY is the all-ones word, and one
// atomicCAS claims it.
//
// Outputs: slot (int32, C when the lane is not ok), ok, and n_new — valid
// lanes whose key was absent before the call and present after, duplicates
// of a key placed in this call included (the reference's
// valid & ~found0 & found). A lane cannot tell "placed by a sibling in this
// batch" from "present before", so the work is two launches: a lookup pass
// that settles found0 (and the slot of every resident key; it stops at the
// first EMPTY slot of a chain, hash_probe.cuh), then a claim pass over the
// lanes still missing. The key equal to EMPTY (integer key -1)
// is never found nor placed, as in the reference: its lanes go to the
// overflow ring (G7), or drop as capacity loss without one.
//
// Claims: a missing lane walks its chain; a slot holding its key ends the
// walk (found), a free slot is claimed with atomicCAS(EMPTY -> key) — the
// CAS returning EMPTY or the lane's own key ends the walk — and a slot
// holding another key is passed. Slots only ever go from EMPTY to a key, so
// a key sits behind an unbroken run of occupied slots and is never placed
// twice. A lane fails only when all P slots of its chain hold other keys.
// The reference's four claim rounds can also fail a lane that lost four
// races while its chain still had room; below capacity both place every
// key, at overload both send the lanes they could not place to the
// overflow ring (or, without one, fail the job: "state backend over
// capacity").
//
// Bound: bytes. Per lane it reads hi, lo (4 B each) and valid (1 B) and
// writes slot (4 B) and ok (1 B), 14 B; each table word on a chain up to
// its key is read once, 8 B. A 262,144-lane batch of resident keys at a
// load of 0.5 reads ~3.7 MB of lanes and ~2-3 MB of table, about 2 us at
// 3.35 TB/s. The probe reads are scattered 8-byte loads, so they are
// sector-bound rather than byte-bound; the claim pass reads only the lanes
// in steady state, when every key is resident.

#include "common.cuh"
#include "hash_probe.cuh"

namespace {

__global__ void hash_lookup_kernel(const unsigned long long* __restrict__ table,
                                   const uint32_t* __restrict__ hi,
                                   const uint32_t* __restrict__ lo,
                                   const uint8_t* __restrict__ valid, int B,
                                   int C, int P, int32_t* __restrict__ slot,
                                   uint8_t* __restrict__ ok) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int32_t s = valid[i] ? find_key(table, hi[i], lo[i], C, P) : C;
  slot[i] = s;
  ok[i] = s < C;
}

__global__ void hash_claim_kernel(unsigned long long* table,
                                  const uint32_t* __restrict__ hi,
                                  const uint32_t* __restrict__ lo,
                                  const uint8_t* __restrict__ valid, int B,
                                  int C, int P, int32_t* __restrict__ slot,
                                  uint8_t* __restrict__ ok,
                                  int32_t* __restrict__ n_new) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t placed = 0;
  if (i < B && valid[i] && !ok[i]) {
    const unsigned long long key =
        (static_cast<unsigned long long>(hi[i]) << 32) | lo[i];
    if (key != kEmpty) {
      const uint32_t mask = static_cast<uint32_t>(C) - 1u;
      const uint32_t base = probe_hash(hi[i], lo[i]) & mask;
      for (int j = 0; j < P; ++j) {
        const uint32_t s = (base + static_cast<uint32_t>(j)) & mask;
        // a non-EMPTY word never changes again, so a stale read is safe:
        // an EMPTY one is settled by the CAS
        unsigned long long cur =
            *reinterpret_cast<volatile unsigned long long*>(table + s);
        if (cur == kEmpty) cur = atomicCAS(table + s, kEmpty, key);
        if (cur == kEmpty || cur == key) {
          slot[i] = static_cast<int32_t>(s);
          ok[i] = 1;
          placed = 1;
          break;
        }
      }
    }
  }
  placed = block_sum(placed);
  if (threadIdx.x == 0 && placed) atomicAdd(n_new, placed);
}

}  // namespace

extern "C" int hash_upsert(void* table, const void* hi, const void* lo,
                           const void* valid, int B, int C, int P, void* slot,
                           void* ok, void* n_new, void* stream) {
  if (C <= 0 || (C & (C - 1)) != 0 || P < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  if (blocks > 0) {
    hash_lookup_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const unsigned long long*>(table),
        static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
        static_cast<const uint8_t*>(valid), B, C, P,
        static_cast<int32_t*>(slot), static_cast<uint8_t*>(ok));
    hash_claim_kernel<<<blocks, threads, 0, s>>>(
        static_cast<unsigned long long*>(table),
        static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
        static_cast<const uint8_t*>(valid), B, C, P,
        static_cast<int32_t*>(slot), static_cast<uint8_t*>(ok),
        static_cast<int32_t*>(n_new));
  }
  return static_cast<int>(cudaGetLastError());
}
