// The hash state layout's probe chain, shared by G5 hash_upsert.cu and G8
// hash_lookup.cu: ops/hashing.py probe_hash and the P-long linear probe of
// ops/hashtable.py over a table of 64-bit key words (hi << 32) | lo, EMPTY
// the all-ones word.
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

// The slot of `key` within its P-slot chain, or C when it is absent. A
// slot only ever goes from EMPTY to a key, and a key is claimed at the
// first slot of its chain that was EMPTY, so a key never sits behind an
// EMPTY slot of its chain: the walk stops at the first one. The key EMPTY
// (integer key -1) is never found. Reads of the table must not race with
// claims (G5 runs its claim pass as a later launch).
__device__ __forceinline__ int32_t find_key(
    const unsigned long long* __restrict__ table, uint32_t hi, uint32_t lo,
    int C, int P) {
  const unsigned long long key = (static_cast<unsigned long long>(hi) << 32) | lo;
  if (key == kEmpty) return C;
  const uint32_t mask = static_cast<uint32_t>(C) - 1u;
  const uint32_t base = probe_hash(hi, lo) & mask;
  for (int j = 0; j < P; ++j) {
    const uint32_t s = (base + static_cast<uint32_t>(j)) & mask;
    const unsigned long long w = table[s];
    if (w == key) return static_cast<int32_t>(s);
    if (w == kEmpty) break;
  }
  return C;
}
