"""Key groups: max-parallelism-stable hash sharding of keyed state.

Reproduces the *semantics* of the reference's key-group scheme
(flink-runtime/.../state/KeyGroupRangeAssignment.java:40-111 and
KeyGroupRange.java:30): a key is hashed, the hash is scrambled with murmur3 and
reduced modulo ``max_parallelism`` to a *key group*; key groups are assigned to
operator subtasks (here: mesh shards) in contiguous ranges. Rescaling a job
re-slices key-group ranges, never re-hashes keys.

Differences from the reference (deliberate, documented):
  * The reference hashes Java ``Object.hashCode()``; we hash a 64-bit key id
    (arbitrary host keys are first mapped to 64 bits by ``ops.hashing``).
  * The hash functions take numpy (host batch prep) or a torch tensor (the
    plain version of kernel G1, ops/cuda.py). torch lacks uint32 shifts and
    remainders, so the torch flavor carries each 32-bit word in an int64
    masked with ``& 0xFFFFFFFF``; it matches numpy's uint32 bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

DEFAULT_MAX_PARALLELISM = 128
UPPER_BOUND_MAX_PARALLELISM = 1 << 15

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)
_M5 = np.uint32(5)
_N1 = np.uint32(0xE6546B64)
_F1 = np.uint32(0x85EBCA6B)
_F2 = np.uint32(0xC2B2AE35)


def _rotl32(x, r: int, xp):
    x = x.astype(xp.uint32) if hasattr(x, "astype") else xp.uint32(x)
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur3_32(code, xp=np):
    """murmur3 32-bit hash of a single 32-bit word (standard public algorithm,
    seed 0, length 4). Matches the scrambling role of the reference's
    MathUtils.murmurHash used by KeyGroupRangeAssignment.

    `code` may be a scalar or an array of uint32 (numpy, returns uint32), or
    a torch tensor of 32-bit words in any integer dtype (returns int64
    holding the uint32 value).
    """
    if isinstance(code, torch.Tensor):
        return _murmur3_32_torch(code)
    if xp is np:
        with np.errstate(over="ignore"):
            return _murmur3_32_impl(code, xp)
    return _murmur3_32_impl(code, xp)


def _murmur3_32_impl(code, xp):
    k = xp.asarray(code).astype(xp.uint32)
    k = k * _C1
    k = _rotl32(k, 15, xp)
    k = k * _C2
    h = k  # seed 0: h = 0 ^ k
    h = _rotl32(h, 13, xp)
    h = h * _M5 + _N1
    h = h ^ xp.uint32(4)  # length in bytes
    h = h ^ (h >> xp.uint32(16))
    h = h * _F1
    h = h ^ (h >> xp.uint32(13))
    h = h * _F2
    h = h ^ (h >> xp.uint32(16))
    return h


_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


def _rotl32_torch(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _murmur3_32_torch(code: torch.Tensor) -> torch.Tensor:
    k = (_u32(code) * int(_C1)) & _M32
    k = _rotl32_torch(k, 15)
    k = (k * int(_C2)) & _M32
    h = _rotl32_torch(k, 13)
    h = (h * int(_M5) + int(_N1)) & _M32
    h = h ^ 4
    h = h ^ (h >> 16)
    h = (h * int(_F1)) & _M32
    h = h ^ (h >> 13)
    h = (h * int(_F2)) & _M32
    return h ^ (h >> 16)


def compute_key_group_for_key_hash(key_hash, max_parallelism: int, xp=np):
    """key hash (uint32) -> key group in [0, max_parallelism).

    Semantics of KeyGroupRangeAssignment.computeKeyGroupForKeyHash (ref :62):
    murmur-scramble then modulo. A torch tensor in gives int64 key groups.
    """
    if isinstance(key_hash, torch.Tensor):
        return murmur3_32(key_hash) % max_parallelism
    return (murmur3_32(key_hash, xp) % xp.uint32(max_parallelism)).astype(xp.uint32)


def assign_to_key_group(key_hash, max_parallelism: int, xp=np):
    """Alias matching KeyGroupRangeAssignment.assignToKeyGroup (ref :51)."""
    return compute_key_group_for_key_hash(key_hash, max_parallelism, xp)


def compute_operator_index_for_key_group(
    max_parallelism: int, parallelism: int, key_group
):
    """key group -> operator (shard) index.

    Semantics of KeyGroupRangeAssignment.computeOperatorIndexForKeyGroup
    (ref :105): ``keyGroup * parallelism / maxParallelism`` in integer math,
    which yields contiguous, balanced ranges.
    Works on Python ints and numpy/jnp arrays (use int32-safe ranges:
    max_parallelism <= 2^15 so the product fits in int32).
    """
    return key_group * parallelism // max_parallelism


def key_group_range_for_operator(
    max_parallelism: int, parallelism: int, operator_index: int
) -> "KeyGroupRange":
    """Contiguous key-group range owned by one operator subtask.

    Semantics of KeyGroupRangeAssignment.computeKeyGroupRangeForOperatorIndex.
    """
    check_parallelism(max_parallelism, parallelism)
    start = (operator_index * max_parallelism + parallelism - 1) // parallelism
    end = ((operator_index + 1) * max_parallelism - 1) // parallelism
    return KeyGroupRange(start, end)


def check_parallelism(max_parallelism: int, parallelism: int) -> None:
    if not (0 < max_parallelism <= UPPER_BOUND_MAX_PARALLELISM):
        raise ValueError(
            f"max_parallelism must be in (0, {UPPER_BOUND_MAX_PARALLELISM}], "
            f"got {max_parallelism}"
        )
    if parallelism > max_parallelism:
        raise ValueError(
            f"parallelism {parallelism} exceeds max_parallelism {max_parallelism}"
        )


@dataclass(frozen=True)
class KeyGroupRange:
    """Inclusive range [start, end] of key groups (ref KeyGroupRange.java:30).

    An empty range is represented by start > end.
    """

    start: int
    end: int

    EMPTY: "KeyGroupRange" = None  # set below

    @property
    def num_key_groups(self) -> int:
        return 0 if self.start > self.end else self.end - self.start + 1

    def __contains__(self, key_group: int) -> bool:
        return self.start <= key_group <= self.end

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.start, self.end + 1))

    def __len__(self) -> int:
        return self.num_key_groups

    def intersect(self, other: "KeyGroupRange") -> "KeyGroupRange":
        s, e = max(self.start, other.start), min(self.end, other.end)
        return KeyGroupRange(s, e) if s <= e else KeyGroupRange.EMPTY


object.__setattr__  # (keep linters quiet about frozen dataclass idiom)
KeyGroupRange.EMPTY = KeyGroupRange(0, -1)
