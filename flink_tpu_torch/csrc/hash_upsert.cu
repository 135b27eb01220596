// G5 hash_upsert — insert-or-find one micro-batch of keys in the hash state
// layout's open-addressing table.
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
// batch" from "present before", so every lane's lookup ends before any
// claim: lookups read the whole chain (hash_probe.cuh find_key, the
// reference's rule, so a key behind a slot that remove_slots cleared is
// found), and no claim starts until every block has looked up its lanes.
// The key equal to EMPTY (integer key -1) is never found nor placed, as in
// the reference: its lanes go to the overflow ring (G7), or drop as
// capacity loss without one.
//
// Claims (hash_probe.cuh claim_key): a missing lane takes the first slot of
// its chain that holds its key or that its atomicCAS(EMPTY -> key) wins.
// Slots only ever go from EMPTY to a key within a call, so a key is never
// placed twice, and a lane fails only when all P slots of its chain hold
// other keys. The reference's four claim rounds can also fail a lane that
// lost four races while its chain still had room; below capacity both place
// every key, at overload both send the lanes they could not place to the
// overflow ring (or, without one, fail the job: "state backend over
// capacity").
//
// Bound: bytes. Per lane it reads hi, lo (4 B each) and valid (1 B) and
// writes slot (4 B) and ok (1 B), 14 B; each table word on a chain up to
// its key is read once, 8 B. A 262,144-lane batch of resident keys at a
// load of 0.48 reads ~3.7 MB of lanes and ~2.7 MB of table, 1.9 us at
// 3.35 TB/s. What sets the time is the table's random reads, one 32-byte
// sector a lane and more for deep keys, not the bytes: in the sparse job's
// table (1M keys in 2^21 slots, P = 64) the mean key sits 0.5 deep, and
// some 290-330 keys sit 16 or more deep, 1-4 keys 32 or more, the deepest
// 34-38 (the hash_table lines of chip_smoke.py); the first sector finds
// most keys and the deepest take three reads. The same walk a word at a
// time costs as much on the card: the rate of random reads, not the chain's
// tail, bounds it. A miss reads its whole chain, 544 bytes at P = 64.
//
// Design: one cooperative launch a call (the grid at most the blocks the
// card runs at once), a thread a lane, grid-stride, and no fill:
//   1. every lane's lookup (find_key), slot and ok written;
//   2. each block adds, in one atomic, its arrival and whether it has a lane
//      to claim to a word of the stream's TableScratch; the last block to
//      arrive, when no block has one (the steady state), writes n_new = 0
//      and resets the word: no block waits and no claim pass runs;
//   3. a block with lanes to claim waits (an acquire load, a short sleep)
//      until every block has arrived, claims its own missing lanes, and
//      adds its placed keys to a second fold word; the last such block
//      writes n_new and resets both words for the next call on the stream.

#include "common.cuh"
#include "hash_probe.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
upsert_kernel(unsigned long long* table, const uint32_t* __restrict__ hi,
              const uint32_t* __restrict__ lo,
              const uint8_t* __restrict__ valid, int B, int C, int P,
              int32_t* __restrict__ slot, uint8_t* __restrict__ ok,
              int32_t* __restrict__ n_new, TableScratch* sc) {
  const uint32_t mask = static_cast<uint32_t>(C) - 1u;
  const int stride = gridDim.x * kThreads;
  // 1. find every lane's key: the whole chain, before any claim
  int32_t miss = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < B; i += stride) {
    int32_t s = C;
    if (valid[i]) {
      const uint32_t h = hi[i], l = lo[i];
      const unsigned long long key = key_word(h, l);
      s = find_key<kVec>(table, key, probe_hash(h, l) & mask, C, P);
      miss += key != kEmpty && s == C;
    }
    slot[i] = s;
    ok[i] = s < C;
  }
  miss = block_sum(miss);
  __shared__ int claims;
  __shared__ uint32_t claimers;
  if (threadIdx.x == 0) {
    const unsigned long long old =
        atomicAdd(&sc->upsert_arrive, (1ull << 32) | (miss > 0 ? 1u : 0u));
    if ((old >> 32) == gridDim.x - 1 &&
        static_cast<uint32_t>(old) + (miss > 0) == 0) {
      *n_new = 0;              // the last block, and no lane to claim
      sc->upsert_arrive = 0;   // for the next call on the stream
    }
    claims = miss > 0;
  }
  __syncthreads();
  if (!claims) return;
  // 2. a block with lanes to claim waits until every block has looked up
  // its lanes (the grid is co-resident: a cooperative launch)
  if (threadIdx.x == 0) {
    unsigned long long w = load_acquire(&sc->upsert_arrive);
    while ((w >> 32) < gridDim.x) {
      __nanosleep(64);
      w = load_acquire(&sc->upsert_arrive);
    }
    claimers = static_cast<uint32_t>(w);
  }
  __syncthreads();
  // 3. its missing lanes claim: they hold slot C, a valid lane and a key
  // other than EMPTY
  int32_t placed = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < B; i += stride) {
    if (slot[i] != C || !valid[i]) continue;
    const uint32_t h = hi[i], l = lo[i];
    const unsigned long long key = key_word(h, l);
    if (key == kEmpty) continue;
    const int32_t s = claim_key<kVec>(table, key, probe_hash(h, l) & mask,
                                      C, P);
    if (s < C) {
      slot[i] = s;
      ok[i] = 1;
      ++placed;
    }
  }
  placed = block_sum(placed);
  if (threadIdx.x == 0) {
    const unsigned long long old = atomicAdd(
        &sc->upsert_fold, (1ull << 32) | static_cast<uint32_t>(placed));
    if ((old >> 32) == claimers - 1) {  // the last claiming block
      *n_new = static_cast<int32_t>(static_cast<uint32_t>(old) + placed);
      sc->upsert_fold = 0;
      sc->upsert_arrive = 0;  // every claimer has left its wait
    }
  }
}

// the blocks a card runs at once, asked once a device and instance
template <bool kVec>
int grid_limit() {
  static int limit[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (limit[dev] == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                  upsert_kernel<kVec>,
                                                  kThreads, 0);
    limit[dev] = per_sm * sm_count();
  }
  return limit[dev];
}

template <bool kVec>
int launch(unsigned long long* table, const uint32_t* hi, const uint32_t* lo,
           const uint8_t* valid, int B, int C, int P, int32_t* slot,
           uint8_t* ok, int32_t* n_new, TableScratch* sc, cudaStream_t s) {
  const int most = grid_limit<kVec>();
  if (most <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  int grid = (B + kThreads - 1) / kThreads;
  if (grid > most) grid = most;
  if (grid < 1) grid = 1;  // an empty batch still writes n_new
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, upsert_kernel<kVec>, table,
                                            hi, lo, valid, B, C, P, slot, ok,
                                            n_new, sc);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: a TableScratch, zeroed before the first call on its stream.
extern "C" int hash_upsert(void* table, const void* hi, const void* lo,
                           const void* valid, int B, int C, int P, void* slot,
                           void* ok, void* n_new, void* scratch,
                           void* stream) {
  if (C <= 0 || (C & (C - 1)) != 0 || P < 1 || B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* t = static_cast<unsigned long long*>(table);
  auto* h = static_cast<const uint32_t*>(hi);
  auto* l = static_cast<const uint32_t*>(lo);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* sl = static_cast<int32_t*>(slot);
  auto* o = static_cast<uint8_t*>(ok);
  auto* nn = static_cast<int32_t*>(n_new);
  auto* sc = static_cast<TableScratch*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(table) % 16 == 0) {
    return launch<true>(t, h, l, v, B, C, P, sl, o, nn, sc, st);
  }
  return launch<false>(t, h, l, v, B, C, P, sl, o, nn, sc, st);
}
