"""Key hashing: host 64-bit key identity + device 32-bit probe/route hashes.

The reference derives everything from Java ``Object.hashCode()`` (32-bit) and
murmur-scrambles it (MathUtils.murmurHash used at KeyGroupRangeAssignment.java:62).
We use 64-bit key identities so 1M+ key cardinalities have negligible collision
probability, then derive 32-bit hashes on device from the (hi, lo) pair.

The host half is a copy of flink_tpu/ops/hashing.py; the device half holds
the plain torch versions of ``route_hash`` (kernel G1 in ops/cuda.py) and
``probe_hash`` (kernel G5).

Host: splitmix64 (public-domain mix) vectorized in numpy for numeric keys;
stable blake2b-based hash for strings/bytes/other objects (NOT Python's
``hash()``, which is salted per process and would break checkpoint restore).
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np
import torch

_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 -> uint64)."""
    z = np.asarray(x).astype(np.uint64) + _SM_GAMMA
    z = (z ^ (z >> np.uint64(30))) * _SM_M1
    z = (z ^ (z >> np.uint64(27))) * _SM_M2
    return z ^ (z >> np.uint64(31))


def _stable_obj_hash(obj) -> int:
    if isinstance(obj, bytes):
        data = obj
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
    else:
        data = repr(obj).encode("utf-8")
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")


def hash64_host(keys) -> np.ndarray:
    """Host keys -> MIXED uint64 hashes (sketch item hashing, state-backend
    addressing — anywhere hash *quality* matters).

    Numeric arrays go through vectorized splitmix64; object sequences through
    a stable per-object hash.
    """
    arr = np.asarray(keys)
    if arr.dtype.kind in "iub":
        return splitmix64(arr.astype(np.uint64))
    if arr.dtype.kind == "f":
        return splitmix64(arr.view(np.uint64) if arr.dtype == np.float64
                          else arr.astype(np.float64).view(np.uint64))
    return np.fromiter(
        (_stable_obj_hash(k) for k in (keys if not isinstance(keys, np.ndarray) else keys.tolist())),
        dtype=np.uint64,
        count=len(keys),
    )


def key_identity64(keys) -> np.ndarray:
    """Host keys -> uint64 key IDENTITIES (KeyCodec).

    An identity only needs to be collision-free and stable — all downstream
    hashing (slot probing, key-group routing) mixes the (hi, lo) pair again
    on device (probe_hash / route_hash, plus the murmur key-group
    scramble). For integers the raw two's-complement bits already ARE a
    perfect identity, ~7x cheaper per batch than splitmix64's uint64
    multiply chain on host — and decode() recovers non-negative ints
    without a reverse map. Floats use their IEEE bits (note -0.0 and +0.0
    are distinct identities, as they already were under splitmix of the
    same bits). Objects fall back to the stable hash.
    """
    arr = np.asarray(keys)
    if arr.dtype.kind in "iub":
        return arr.astype(np.int64, copy=False).view(np.uint64)
    if arr.dtype.kind == "f":
        return (arr.view(np.uint64) if arr.dtype == np.float64
                else arr.astype(np.float64).view(np.uint64))
    return hash64_host(keys)


# ---------------------------------------------------------------- device side

_M32 = 0xFFFFFFFF


def probe_hash(key_hi, key_lo, xp=np):
    """(hi, lo) uint32 pair -> uint32 slot-probe hash (device-friendly mix):
    the start of a key's probe chain in the hash state layout. numpy in
    gives uint32; torch tensors in give int64 holding the uint32 value (the
    plain version of kernel G5's hash, ops/cuda.py)."""
    if isinstance(key_hi, torch.Tensor):
        hi = key_hi.to(torch.int64) & _M32
        lo = key_lo.to(torch.int64) & _M32
        h = ((hi * 0x85EBCA6B) & _M32) ^ ((lo * 0xC2B2AE35) & _M32)
        h = h ^ (h >> 15)
        h = (h * 0x2C1B3C6D) & _M32
        h = h ^ (h >> 12)
        h = (h * 0x297A2D39) & _M32
        return h ^ (h >> 15)
    with np.errstate(over="ignore"):
        h = xp.asarray(key_hi).astype(xp.uint32) * np.uint32(0x85EBCA6B)
        h = h ^ (xp.asarray(key_lo).astype(xp.uint32) * np.uint32(0xC2B2AE35))
        h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(0x2C1B3C6D)
        h = h ^ (h >> np.uint32(12))
        h = h * np.uint32(0x297A2D39)
        return h ^ (h >> np.uint32(15))


def route_hash(key_hi, key_lo, xp=np):
    """(hi, lo) -> uint32 hash fed to key-group assignment.

    Independent from the slot-probe hash so slot probing and key-group
    routing don't correlate (the reference similarly separates hashCode
    from murmur scramble). numpy in gives uint32; torch tensors in give
    int64 holding the uint32 value (the plain version of kernel G1,
    ops/cuda.py — torch has no uint32 shifts or remainders).
    """
    if isinstance(key_hi, torch.Tensor):
        hi = key_hi.to(torch.int64) & _M32
        lo = key_lo.to(torch.int64) & _M32
        return lo ^ ((hi * 0x9E3779B9) & _M32)
    with np.errstate(over="ignore"):
        h = xp.asarray(key_lo).astype(xp.uint32) ^ (
            xp.asarray(key_hi).astype(xp.uint32) * np.uint32(0x9E3779B9)
        )
    return h
