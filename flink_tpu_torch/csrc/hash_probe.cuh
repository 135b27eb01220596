// The hash state layout's probe chain, shared by G5 hash_upsert.cu, G8
// hash_lookup.cu and G9 compact_table.cu: ops/hashing.py probe_hash and
// the P-long linear probe of ops/hashtable.py over a table of 64-bit key
// words (hi << 32) | lo, EMPTY the all-ones word, C a power of two.
//
// A chain is read a sector at a time: the aligned 32-byte sector (four
// words) that holds the chain's first slot, then four sectors (128 bytes)
// a round trip. Position j of the chain is slot (base + j) & (C - 1); a
// chain longer than C visits each slot once (positions past C repeat
// slots already read). A sector of a table of at least four slots never
// straddles C, since C is a multiple of four.
#pragma once

#include <cstdint>

constexpr unsigned long long kEmpty = ~0ull;

// ops/hashing.py probe_hash, in uint32 arithmetic.
__device__ __forceinline__ uint32_t probe_hash(uint32_t hi, uint32_t lo) {
  uint32_t h = hi * 0x85EBCA6Bu;
  h ^= lo * 0xC2B2AE35u;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  return h ^ (h >> 15);
}

__device__ __forceinline__ unsigned long long key_word(uint32_t hi,
                                                       uint32_t lo) {
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// The four words of the sector that starts at slot s (a multiple of 4):
// two 16-byte loads when the table is 16-byte aligned (kVec). Through L1;
// the callers' tables do not change while they read (find_key).
template <bool kVec>
__device__ __forceinline__ void load_sector(
    const unsigned long long* __restrict__ table, uint32_t s,
    unsigned long long* w) {
  if (kVec) {
    const ulonglong2 a = reinterpret_cast<const ulonglong2*>(table + s)[0];
    const ulonglong2 b = reinterpret_cast<const ulonglong2*>(table + s)[1];
    w[0] = a.x;
    w[1] = a.y;
    w[2] = b.x;
    w[3] = b.y;
  } else {
    for (int k = 0; k < 4; ++k) w[k] = table[s + k];
  }
}

// The same from L2 (ld.global.cg), for a table that other threads claim
// slots of while this one reads: a word read stale can only be an EMPTY
// one that a CAS then settles.
template <bool kVec>
__device__ __forceinline__ void load_sector_cg(
    const unsigned long long* table, uint32_t s, unsigned long long* w) {
  if (kVec) {
    asm volatile("ld.global.cg.v2.u64 {%0, %1}, [%2];"
                 : "=l"(w[0]), "=l"(w[1]) : "l"(table + s));
    asm volatile("ld.global.cg.v2.u64 {%0, %1}, [%2];"
                 : "=l"(w[2]), "=l"(w[3]) : "l"(table + s + 2));
  } else {
    for (int k = 0; k < 4; ++k) {
      asm volatile("ld.global.cg.u64 %0, [%1];"
                   : "=l"(w[k]) : "l"(table + s + k));
    }
  }
}

// The walk that finds a key (find_key): the slot of `key` within its
// chain of P slots from `base`, or C when no slot of the chain holds it. A
// miss is settled only at the chain's end (flink_tpu/ops/hashtable.py
// _probe / lookup), so a key behind a slot that remove_slots (G28) cleared
// is still found; a hit ends the walk. Rounds: base's sector (positions 0
// to 3 - (base & 3)), then four sectors at a time, so a key costs one
// dependent read in its first sector and one more for each 16 positions
// past it, a miss at P = 64 five reads and at P = 16 two. The key EMPTY
// (integer key -1) is never found.

// Round 0, from the words of base's sector (C >= 4): the slot, C when the
// chain ends inside the sector without the key, or -1 when it runs on.
__device__ __forceinline__ int32_t find_in_first(const unsigned long long* w,
                                                 unsigned long long key,
                                                 uint32_t base, int C, int P) {
  const int off = static_cast<int>(base & 3u);
  const int L = P < C ? P : C;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= off && k - off < L && w[k] == key) {
      return static_cast<int32_t>(base - off + k);
    }
  }
  return off + L <= 4 ? C : -1;
}

// The rounds after the first (any C: a table of under four slots is read a
// word at a time from the start).
template <bool kVec>
__device__ __noinline__ int32_t find_rest(
    const unsigned long long* __restrict__ table, unsigned long long key,
    uint32_t base, int C, int P) {
  const uint32_t mask = static_cast<uint32_t>(C) - 1u;
  const int L = P < C ? P : C;
  if (C < 4) {
    for (int j = 0; j < L; ++j) {
      const uint32_t s = (base + static_cast<uint32_t>(j)) & mask;
      if (table[s] == key) return static_cast<int32_t>(s);
    }
    return C;
  }
  const int off = static_cast<int>(base & 3u);
  const uint32_t sec0 = base - static_cast<uint32_t>(off);
  const int n_sec = (off + L + 3) >> 2;  // sectors the chain touches
  for (int q0 = 1; q0 < n_sec; q0 += 4) {
    unsigned long long w[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (q0 + i < n_sec) {
        load_sector<kVec>(table, (sec0 + 4u * (q0 + i)) & mask, w + 4 * i);
      } else {
        w[4 * i] = w[4 * i + 1] = w[4 * i + 2] = w[4 * i + 3] = kEmpty;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // a sector past the chain holds kEmpty here, never the key
        if (w[4 * i + k] == key && 4 * (q0 + i) + k - off < L) {
          return static_cast<int32_t>((sec0 + 4u * (q0 + i) + k) & mask);
        }
      }
    }
  }
  return C;
}

template <bool kVec>
__device__ __forceinline__ int32_t find_key(
    const unsigned long long* __restrict__ table, unsigned long long key,
    uint32_t base, int C, int P) {
  if (key == kEmpty) return C;
  if (C >= 4) {
    unsigned long long w[4];
    load_sector<kVec>(table, base & ~3u, w);
    const int32_t s = find_in_first(w, key, base, C, P);
    if (s >= 0) return s;
  }
  return find_rest<kVec>(table, key, base, C, P);
}

// Claim a slot for `key`, which the caller knows to be absent from its
// chain or placed there only by a claim of this launch: the first slot of
// the chain, a sector a read, that holds the key or is EMPTY and taken by
// atomicCAS(EMPTY -> key). A slot only goes from EMPTY to a key within a
// launch, so a non-EMPTY word read stale is still right and an EMPTY one
// is settled by the CAS: lanes of one key meet at one slot, and a key is
// never placed twice. Returns the slot, or C when every slot of the chain
// holds another key.
template <bool kVec>
__device__ __forceinline__ int32_t claim_key(unsigned long long* table,
                                             unsigned long long key,
                                             uint32_t base, int C, int P) {
  const uint32_t mask = static_cast<uint32_t>(C) - 1u;
  const int L = P < C ? P : C;
  if (C < 4) {
    for (int j = 0; j < L; ++j) {
      const uint32_t s = (base + static_cast<uint32_t>(j)) & mask;
      unsigned long long cur = table[s];
      if (cur == kEmpty) cur = atomicCAS(table + s, kEmpty, key);
      if (cur == kEmpty || cur == key) return static_cast<int32_t>(s);
    }
    return C;
  }
  const int off = static_cast<int>(base & 3u);
  const uint32_t sec0 = base - static_cast<uint32_t>(off);
  const int n_sec = (off + L + 3) >> 2;
  for (int q = 0; q < n_sec; ++q) {
    const uint32_t s0 = (sec0 + 4u * q) & mask;
    unsigned long long w[4];
    load_sector_cg<kVec>(table, s0, w);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * q + k - off;
      if (j < 0 || j >= L) continue;
      unsigned long long cur = w[k];
      if (cur == kEmpty) cur = atomicCAS(table + s0 + k, kEmpty, key);
      if (cur == kEmpty || cur == key) return static_cast<int32_t>(s0 + k);
    }
  }
  return C;
}

// The hash kernels' scratch, one a device and stream (ops/cuda.py
// _table_scratch): zeroed once, and each call leaves the words it uses at
// 0 again, so no host code touches it between calls.
struct TableScratch {
  unsigned long long upsert_arrive;  // G5: blocks looked up << 32 | blocks
                                     // with a lane to claim
  unsigned long long upsert_fold;    // G5: claiming blocks done << 32 |
                                     // keys placed
  unsigned long long lookup_fold;   // G8: blocks done << 32 | lanes missing
  unsigned long long compact_fail;  // G9: alive keys that found no slot
};

// One block's count `v` added to a fold word that holds the blocks done in
// its high half; the block that completes the grid gets the total in
// *total and zeroes the word for the next call. One atomic a block and no
// fence: the count travels in the atomic itself. Thread 0 of each block
// calls it once.
__device__ __forceinline__ bool fold_last(unsigned long long* word,
                                          uint32_t v, uint32_t* total) {
  const unsigned long long old = atomicAdd(word, (1ull << 32) | v);
  if ((old >> 32) != gridDim.x - 1) return false;
  *total = static_cast<uint32_t>(old) + v;
  *word = 0;
  return true;
}

// A word other blocks write, read from L2 with acquire order: what this
// thread does after the read happens after the writes it saw.
__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
