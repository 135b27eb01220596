// G9 compact_table — rebuild the hash layout's key table around the keys
// that still hold pane state, and move their state to the new slots.
//
// Replaces (flink_tpu, the JAX reference): ops/window_kernels.py
// compact_table (:480-580, kernel K11) as runtime/step.py
// build_compact_step (:2391) runs it. A table never frees a slot on the
// paths, so a stream whose keys churn fills it with dead keys; the executor
// compacts it after it drained the overflow ring. Its contract
// (ops/cuda.py compact_table_plain):
//   - alive: a slot is alive when any of its R ring rows is touched (the
//     packed plane's touch column differs from the reduce's neutral: 0
//     for sum and count, +FLT_MAX for min, -FLT_MAX for max; the `fresh`
//     plane the reference also reads is never set, since the spill tier
//     runs at allowed lateness 0 only);
//   - the alive slots' keys go into an empty table (G5's contract: a key
//     fails only when every slot of its chain holds another key, where
//     the reference runs probe_len claim rounds); old slot c -> slot[c],
//     ok[c];
//   - each placed key's R packed cells (Wc = W + 1 floats: W value
//     columns, W = 2 for mean, and the touch column) move to its new slot,
//     every other cell of the new plane is the neutral;
//   - the touched cells of alive keys that failed go to the overflow ring
//     as (key, pane, W values) rows, in (row, slot) order, with ring.cuh's
//     stable semantics (G7's), counted lost only when the ring is full:
//     the pane state of a live key is never dropped.
//
// Bound: bytes. The plane is read once and written once, the table read
// and written once: at C = 2^21, R = 12, Wc = 2 about 2 x 201 MB + 2 x 16
// MB, 0.13 ms at 3.35 TB/s.
//
// Design: four device operations a call, each sized to its bytes.
//   1. a memset of the new table to EMPTY (all ones);
//   2. the claim pass, a thread an old slot: its touch columns four rows
//      a round until one is touched, then its key word, then
//      hash_probe.cuh claim_key's CAS walk in the new table, with no lookup
//      (the old table holds each key once, and never the key EMPTY: an
//      alive slot that holds EMPTY fails, as in the plain version); it
//      writes slot, ok and inv[new] = old, and each 256-slot chunk's count
//      of failed alive keys, adding them to a device word
//      (TableScratch::compact_fail) only when there are some;
//   3. the move, a gather over the new plane: a thread two new slots
//      (Wc = 2: 16-byte stores) or one, its source read once from inv
//      where the new table holds a key (inv is never filled: a slot the
//      claim did not write is EMPTY in the new table), held in a register
//      across the R rows. The gather's reads are near: a key's old and new
//      slots both lie within P of its chain's start;
//   4. the export, one block that returns at its first read when no alive
//      key failed (the churn job's case). Otherwise it lists, in order,
//      the chunks with failures, then their failed slots (the alive test
//      read again) into inv's memory, and appends the touched cells row by
//      row over that list by block scans: (row, slot) order, positions from
//      the ring's count on the card, the overflow counted lost.

#include "hash_probe.cuh"
#include "ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads;  // old slots a claim block (COMPACT_CHUNK)
constexpr int kRowsAtOnce = 4;  // touch rows read before a test
constexpr int kExportThreads = 1024;

__device__ __forceinline__ bool touched(const float* __restrict__ acc, int Wc,
                                        float neutral, int C, int r, int c) {
  return acc[(static_cast<size_t>(r) * C + c) * Wc + Wc - 1] != neutral;
}

// any touch column of slot c, kRowsAtOnce loads in flight a test
__device__ __forceinline__ bool alive_at(const float* __restrict__ acc,
                                         int Wc, float neutral, int C, int R,
                                         int c) {
  for (int r0 = 0; r0 < R; r0 += kRowsAtOnce) {
    bool a = false;
#pragma unroll
    for (int k = 0; k < kRowsAtOnce; ++k) {
      if (r0 + k < R) a |= touched(acc, Wc, neutral, C, r0 + k, c);
    }
    if (a) return true;
  }
  return false;
}

// slot c's claim in the new table; returns 1 when an alive key failed
__device__ __forceinline__ int32_t place(
    int c, bool alive, const unsigned long long* __restrict__ table,
    unsigned long long* new_table, int C, int P, int32_t* __restrict__ slot,
    uint8_t* __restrict__ ok, int32_t* __restrict__ inv) {
  int32_t s = C;
  if (alive) {
    const unsigned long long w = table[c];
    if (w != kEmpty) {
      s = claim_key<true>(
          new_table, w,
          probe_hash(static_cast<uint32_t>(w >> 32), static_cast<uint32_t>(w))
              & (uint32_t(C) - 1u),
          C, P);
    }
  }
  slot[c] = s;
  ok[c] = s < C;
  if (s < C) inv[s] = c;
  return alive && s == C;
}

// the new table is 16-byte aligned (compact_table checks): sector loads
__global__ void __launch_bounds__(kThreads)
claim_kernel(const float* __restrict__ acc, int Wc, float neutral,
             const unsigned long long* __restrict__ table, int C, int R,
             int P, unsigned long long* new_table, int32_t* __restrict__ slot,
             uint8_t* __restrict__ ok, int32_t* __restrict__ inv,
             int32_t* __restrict__ blk_fail, TableScratch* sc) {
  const int c = blockIdx.x * kChunk + threadIdx.x;
  int32_t fail = 0;
  if (c < C) {
    fail = place(c, alive_at(acc, Wc, neutral, C, R, c), table, new_table,
                 C, P, slot, ok, inv);
  }
  fail = block_sum(fail);
  if (threadIdx.x == 0) {
    blk_fail[blockIdx.x] = fail;
    if (fail) {
      atomicAdd(reinterpret_cast<unsigned int*>(&sc->compact_fail),
                static_cast<unsigned int>(fail));
    }
  }
}

template <bool kPair>
__global__ void __launch_bounds__(kThreads)
move_kernel(const float* __restrict__ acc, int Wc, float neutral,
            const unsigned long long* __restrict__ new_table,
            const int32_t* __restrict__ inv, int C, int R,
            float* __restrict__ out) {
  if (kPair) {
    const int s = 2 * (blockIdx.x * kThreads + threadIdx.x);
    if (s >= C) return;
    const int32_t c0 = new_table[s] != kEmpty ? inv[s] : -1;
    const int32_t c1 = new_table[s + 1] != kEmpty ? inv[s + 1] : -1;
    const float2 nn = make_float2(neutral, neutral);
    const float2* src = reinterpret_cast<const float2*>(acc);
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const size_t row = static_cast<size_t>(r) * C;
      const float2 a = c0 >= 0 ? src[row + c0] : nn;
      const float2 b = c1 >= 0 ? src[row + c1] : nn;
      reinterpret_cast<float4*>(out)[(row + s) >> 1] =
          make_float4(a.x, a.y, b.x, b.y);
    }
    return;
  }
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= C) return;
  const int32_t c = new_table[s] != kEmpty ? inv[s] : -1;
  for (int r = 0; r < R; ++r) {
    const size_t row = static_cast<size_t>(r) * C;
    float* dst = out + (row + s) * Wc;
    for (int w = 0; w < Wc; ++w) {
      dst[w] = c >= 0 ? acc[(row + c) * Wc + w] : neutral;
    }
  }
}

struct ExportArgs {
  const float* acc;
  int Wc;
  float neutral;
  const unsigned long long* table;  // the old table
  const int32_t* pane_ids;
  const uint8_t* ok;
  int C, R, O;
  const int32_t* blk_fail;  // [n_blk] failed alive keys a chunk
  int n_blk;
  int32_t* list;            // [n_blk] the chunks with failures
  int32_t* failed;          // [C] the failed slots (inv's memory)
  RingOut out;
  int32_t* ovf_n;
  int32_t* lost;
  TableScratch* sc;
};

__global__ void __launch_bounds__(kExportThreads) export_kernel(ExportArgs a) {
  if (a.sc->compact_fail == 0) return;  // nothing failed: the common case
  // the chunks with failures, in chunk order
  int32_t n_list = 0;
  for (int b0 = 0; b0 < a.n_blk; b0 += kExportThreads) {
    const int b = b0 + threadIdx.x;
    const int32_t t = b < a.n_blk && a.blk_fail[b] > 0;
    int32_t tot;
    const int32_t ex = block_exclusive_scan(t, &tot);
    if (t) a.list[n_list + ex] = b;
    n_list += tot;
  }
  __syncthreads();
  // their failed slots, in slot order: a tile a few chunks
  constexpr int kPerTile = kExportThreads / kChunk;
  int32_t n_failed = 0;
  for (int k0 = 0; k0 < n_list; k0 += kPerTile) {
    const int k = k0 + threadIdx.x / kChunk;
    const int c =
        k < n_list ? a.list[k] * kChunk + threadIdx.x % kChunk : a.C;
    const int32_t t = c < a.C && !a.ok[c] &&
                      alive_at(a.acc, a.Wc, a.neutral, a.C, a.R, c);
    int32_t tot;
    const int32_t ex = block_exclusive_scan(t, &tot);
    if (t) a.failed[n_failed + ex] = c;
    n_failed += tot;
  }
  __syncthreads();
  // their touched cells, row by row: (row, slot) order
  const int32_t base = *a.ovf_n;
  int32_t pos0 = base;  // the wrapper keeps O + C * R < 2^31
  for (int r = 0; r < a.R; ++r) {
    for (int k0 = 0; k0 < n_failed; k0 += kExportThreads) {
      const int k = k0 + threadIdx.x;
      const int c = k < n_failed ? a.failed[k] : 0;
      const size_t cell = (static_cast<size_t>(r) * a.C + c) * a.Wc;
      const int32_t t = k < n_failed && a.acc[cell + a.Wc - 1] != a.neutral;
      int32_t tot;
      const int32_t pos = pos0 + block_exclusive_scan(t, &tot);
      if (t && pos < a.O) {
        const unsigned long long w = a.table[c];
        a.out.hi[pos] = static_cast<uint32_t>(w >> 32);
        a.out.lo[pos] = static_cast<uint32_t>(w);
        a.out.pane[pos] = a.pane_ids[r];
        for (int j = 0; j < a.out.W; ++j) {
          a.out.val[static_cast<size_t>(pos) * a.out.W + j] = a.acc[cell + j];
        }
      }
      pos0 += tot;
    }
  }
  __syncthreads();  // every thread has read *ovf_n
  if (threadIdx.x == 0) {
    *a.ovf_n = min(pos0, a.O);
    if (pos0 > a.O) *a.lost += pos0 - a.O;
    a.sc->compact_fail = 0;  // for the next call on the stream
  }
}

template <bool kPair>
void launch_passes(const float* acc, int Wc, float neutral,
                   const unsigned long long* table, int C, int R, int P,
                   unsigned long long* new_table, float* new_acc,
                   int32_t* slot, uint8_t* ok, int32_t* inv,
                   int32_t* blk_fail, TableScratch* sc, cudaStream_t s) {
  claim_kernel<<<(C + kChunk - 1) / kChunk, kThreads, 0, s>>>(
      acc, Wc, neutral, table, C, R, P, new_table, slot, ok, inv, blk_fail,
      sc);
  const int per = kPair ? 2 * kThreads : kThreads;
  move_kernel<kPair><<<(C + per - 1) / per, kThreads, 0, s>>>(
      acc, Wc, neutral, new_table, inv, C, R, new_acc);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// new_table [C] (16-byte aligned), new_acc [C*R, Wc], slot int32 [C] and ok
// [C] are outputs (every word written); inv int32 [C] and blk int32
// [2 * ceil(C / kChunk)] scratch; scratch a TableScratch, zeroed before the
// first call on its stream.
extern "C" int compact_table(const void* acc, int Wc, float neutral,
                             const void* table, const void* pane_ids, int C,
                             int R, int P, int O, void* ovf_hi, void* ovf_lo,
                             void* ovf_pane, void* ovf_val, void* ovf_n,
                             void* lost, void* new_table, void* new_acc,
                             void* slot, void* ok, void* inv, void* blk,
                             void* scratch, void* stream) {
  if (C <= 0 || (C & (C - 1)) != 0 || P < 1 || R < 1 || Wc < 2 ||
      !aligned16(new_table)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(
      new_table, 0xFF, static_cast<size_t>(C) * sizeof(unsigned long long),
      st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const auto* a = static_cast<const float*>(acc);
  const auto* t = static_cast<const unsigned long long*>(table);
  auto* nt = static_cast<unsigned long long*>(new_table);
  auto* na = static_cast<float*>(new_acc);
  auto* sl = static_cast<int32_t*>(slot);
  auto* o = static_cast<uint8_t*>(ok);
  auto* iv = static_cast<int32_t*>(inv);
  auto* bf = static_cast<int32_t*>(blk);
  auto* sc = static_cast<TableScratch*>(scratch);
  const bool pair = Wc == 2 && C >= 2 && aligned16(acc) && aligned16(new_acc);
  if (pair) {
    launch_passes<true>(a, Wc, neutral, t, C, R, P, nt, na, sl, o, iv, bf, sc,
                        st);
  } else {
    launch_passes<false>(a, Wc, neutral, t, C, R, P, nt, na, sl, o, iv, bf,
                         sc, st);
  }
  const int n_blk = (C + kChunk - 1) / kChunk;
  ExportArgs e{a, Wc, neutral, t, static_cast<const int32_t*>(pane_ids), o,
               C, R, O, bf, n_blk, bf + n_blk, iv,
               RingOut{static_cast<uint32_t*>(ovf_hi),
                       static_cast<uint32_t*>(ovf_lo),
                       static_cast<int32_t*>(ovf_pane),
                       static_cast<float*>(ovf_val), Wc - 1},
               static_cast<int32_t*>(ovf_n), static_cast<int32_t*>(lost), sc};
  export_kernel<<<1, kExportThreads, 0, st>>>(e);
  return static_cast<int>(cudaGetLastError());
}
