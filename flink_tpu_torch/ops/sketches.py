"""Count-Min and HyperLogLog sketches as window state — the port of
flink_tpu/ops/sketches.py (BASELINE config #3).

Each (key, pane) holds a flat int32 register vector in the split state
planes of ``ops/window_kernels.py`` (``acc [C*R, W]``). A record's item is
hashed on the host to one uint32 word (``hash32_host``, the stage's
``value_prep``) and carried to the card in the values column; there
``_fmix32`` derives the register positions:

  * Count-Min: D row positions ``fmix32(h ^ seed_d) & (width - 1)``, each
    register + 1. Panes compose by ``+``.
  * HyperLogLog: bucket ``fmix32(h) >> (32 - p)`` and rank
    ``rho = clz(fmix32(h) << p) + 1`` (``33 - p`` when that word is 0),
    the register takes the max. Panes compose by ``max``.

A ``finalize`` turns a window's combined registers into what the fire
emits: the Q point estimates of a Count-Min ``query`` (the min over the D
rows at the query's positions), or HyperLogLog's cardinality estimate.

``expand`` and ``finalize`` here are the plain PyTorch versions of the
kernels G14 ``sketch_update`` and G15 ``sketch_fire`` (``ops/cuda.py``).
torch has no uint32 shifts on the CPU, so each 32-bit word rides in an
int64 masked with ``& 0xFFFFFFFF``, as ``ops/hashing.py`` does.
HyperLogLog's sum of ``2^-r`` is taken exactly, as the integer sum of
``2^(33 - p - r)`` (every register is at most ``33 - p``), so that it
does not depend on the order of the terms.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from flink_tpu_torch.ops.hashing import hash64_host, splitmix64

_M32 = 0xFFFFFFFF


def hash32_host(items) -> np.ndarray:
    """Host items -> uint32 base sketch hashes (stable across processes)."""
    h = hash64_host(items)
    return (h ^ (h >> np.uint64(32))).astype(np.uint32)


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 words holding uint32 values (the
    device mix of the reference's ``_fmix32``)."""
    h = h & _M32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _row_seeds(depth: int) -> np.ndarray:
    return splitmix64(np.arange(1, depth + 1, dtype=np.uint64)).astype(
        np.uint32
    )


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    """numpy mirror of _fmix32 (identical bit pattern, host path)."""
    h = np.asarray(h, np.uint32)
    with np.errstate(over="ignore"):
        h = h ^ (h >> np.uint32(16))
        h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
        h = h ^ (h >> np.uint32(13))
        h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    return h ^ (h >> np.uint32(16))


def _words(hashes: torch.Tensor) -> torch.Tensor:
    """int32 (uint32 bits) or int64 hashes -> int64 uint32 values."""
    return hashes.to(torch.int64) & _M32


def clz32(w: torch.Tensor) -> torch.Tensor:
    """Leading zeros of nonzero uint32 values held in int64 (32 for 0)."""
    n = torch.zeros_like(w)
    x = w.clone()
    for shift, limit in ((16, 0x0000FFFF), (8, 0x00FFFFFF), (4, 0x0FFFFFFF),
                         (2, 0x3FFFFFFF), (1, 0x7FFFFFFF)):
        small = x <= limit
        n = n + torch.where(small, shift, 0)
        x = torch.where(small, x << shift, x)
    return torch.where(w == 0, 32, n)


def _numeric(items) -> bool:
    return np.asarray(items).dtype.kind in "iufb"


class CountMinSketch:
    """Count-Min sketch spec: D x W int32 counters per (key, pane).

    query: optional fixed item list; fires then emit the Q point estimates
    (min over rows) instead of raw registers. Width must be a power of two.
    """

    op = "add"  # scatter reducer AND pane-composition combine
    neutral = 0

    def __init__(self, depth: int = 4, width: int = 1024,
                 query: Optional[Sequence] = None):
        if width <= 0 or width & (width - 1):
            raise ValueError("count-min width must be a power of two")
        self.depth = depth
        self.width = width
        self.value_shape = (depth * width,)
        self.dtype = torch.int32
        self.seeds = _row_seeds(depth)
        self.query = list(query) if query is not None else None
        if self.query is not None:
            qh = hash32_host(np.asarray(self.query)
                             if _numeric(self.query) else self.query)
            self.qpos = np.stack(
                [self._positions_np(qh, d) for d in range(depth)]
            )  # [D, Q] int32
            self.result_shape = (len(self.query),)
        else:
            self.qpos = None
            self.result_shape = self.value_shape
        self.result_dtype = torch.int32
        self._on_device = {}

    def _positions_np(self, h32: np.ndarray, d: int) -> np.ndarray:
        h = _fmix32_np((h32 ^ self.seeds[d]).astype(np.uint32))
        return (h & np.uint32(self.width - 1)).astype(np.int32)

    def positions(self, hashes: torch.Tensor) -> torch.Tensor:
        """[B] hashes -> int64 [B, D] register columns ``d * W + pos``."""
        seeds = torch.from_numpy(self.seeds.astype(np.int64)).to(
            hashes.device)
        mixed = _fmix32(_words(hashes)[:, None] ^ seeds[None, :])
        d_off = torch.arange(self.depth, dtype=torch.int64,
                             device=hashes.device) * self.width
        return d_off[None, :] + (mixed & (self.width - 1))

    def expand(self, flat, hashes, live):
        """Lane (ring row * C + slot) + item hash -> D register updates per
        record: (eidx int64 [B*D] into the flattened [C*R * D*W] register
        space, upd int32 [B*D], mask bool [B*D])."""
        eidx = flat.to(torch.int64)[:, None] * (self.depth * self.width) \
            + self.positions(hashes)
        upd = torch.ones_like(eidx, dtype=torch.int32)
        mask = live[:, None].expand(eidx.shape)
        return eidx.reshape(-1), upd.reshape(-1), mask.reshape(-1)

    def qcols(self) -> np.ndarray:
        """int32 [D, Q] register columns ``d * W + qpos[d, q]`` of the
        query (None without one)."""
        if self.qpos is None:
            return None
        d_off = np.arange(self.depth, dtype=np.int32)[:, None] * self.width
        return (d_off + self.qpos).astype(np.int32)

    def device_arrays(self, dev):
        """(seeds int32 [D], qcols int32 [D*Q] or None) on ``dev``, copied
        once per device: a copy from pageable host memory at each kernel
        launch would hold the host until the stream drained, inside the
        resident drain's slot loop."""
        key = str(dev)
        if key not in self._on_device:
            qc = self.qcols()
            self._on_device[key] = (
                torch.from_numpy(self.seeds.view(np.int32).copy()).to(dev),
                None if qc is None
                else torch.from_numpy(qc.reshape(-1).copy()).to(dev))
        return self._on_device[key]

    def finalize(self, vals: torch.Tensor) -> torch.Tensor:
        """[..., D*W] registers -> [..., Q] point estimates (min over
        rows)."""
        if self.qpos is None:
            return vals
        cols = torch.from_numpy(self.qcols().astype(np.int64)).to(
            vals.device)
        g = vals[..., cols]                                     # [..., D, Q]
        return g.min(dim=-2).values

    def estimate_np(self, sketch: np.ndarray, items) -> np.ndarray:
        """Host-side point query of a raw [D*W] sketch for arbitrary items."""
        qh = hash32_host(np.asarray(items) if _numeric(items) else items)
        v = np.asarray(sketch).reshape(self.depth, self.width)
        ests = np.stack(
            [v[d, self._positions_np(qh, d)] for d in range(self.depth)]
        )
        return ests.min(axis=0)

    # -- host path (generic window operator) ------------------------------
    def host_init(self) -> np.ndarray:
        return np.zeros(self.value_shape, np.int64)

    def host_add(self, acc: np.ndarray, item) -> np.ndarray:
        qh = hash32_host([item])
        for d in range(self.depth):
            acc[d * self.width + int(self._positions_np(qh, d)[0])] += 1
        return acc

    def host_merge(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return a + b

    def host_result(self, acc: np.ndarray):
        if self.qpos is None:
            return acc.copy()
        v = acc.reshape(self.depth, self.width)
        return v[np.arange(self.depth)[:, None], self.qpos].min(axis=0)


class HyperLogLog:
    """HLL spec: M = 2**p int32 rank registers per (key, pane).

    finalize -> float32 cardinality estimate with the standard small-range
    (linear counting) correction.
    """

    op = "max"
    neutral = 0

    def __init__(self, p: int = 12):
        if not 4 <= p <= 16:
            raise ValueError("HLL precision p must be in [4, 16]")
        self.p = p
        self.m = 1 << p
        self.value_shape = (self.m,)
        self.dtype = torch.int32
        self.result_shape = ()
        self.result_dtype = torch.float32
        m = self.m
        self.alpha = (
            0.673 if m == 16 else 0.697 if m == 32
            else 0.709 if m == 64 else 0.7213 / (1 + 1.079 / m)
        )
        # every register is at most 33 - p, so 2^-r = 2^(base - r) / 2^base
        # with an integer numerator
        self.base = 33 - p
        self.scale = self.alpha * m * m * 2.0 ** self.base
        self.log_m = math.log(m)

    def bucket_rho(self, hashes: torch.Tensor):
        """[B] hashes -> (bucket int64 [B], rho int32 [B])."""
        h = _fmix32(_words(hashes))  # decorrelate from the host hash
        bucket = h >> (32 - self.p)
        w = (h << self.p) & _M32
        rho = torch.where(w == 0, 32 - self.p + 1, clz32(w) + 1)
        return bucket, rho.to(torch.int32)

    def expand(self, flat, hashes, live):
        bucket, rho = self.bucket_rho(hashes)
        eidx = flat.to(torch.int64) * self.m + bucket
        return eidx, rho, live

    def register_sums(self, regs: torch.Tensor):
        """[..., M] registers -> (sum of 2^(base - r) int64, zero registers
        int64): the exact integer form of the estimate's inputs."""
        r = regs.to(torch.int64).clamp(0, self.base)
        terms = torch.bitwise_left_shift(torch.ones_like(r), self.base - r)
        return terms.sum(dim=-1), (regs == 0).sum(dim=-1)

    def estimate(self, s: torch.Tensor, zeros: torch.Tensor) -> torch.Tensor:
        """float32 estimates from register_sums, computed in float64."""
        e = self.scale / s.to(torch.float64)
        lin = self.m * (self.log_m
                        - torch.log(zeros.clamp_min(1).to(torch.float64)))
        use_lin = (e <= 2.5 * self.m) & (zeros > 0)
        return torch.where(use_lin, lin, e).to(torch.float32)

    def finalize(self, regs: torch.Tensor) -> torch.Tensor:
        """[..., M] registers -> float32 cardinality estimate."""
        return self.estimate(*self.register_sums(regs))

    # -- host path (generic window operator) ------------------------------
    def host_init(self) -> np.ndarray:
        return np.zeros(self.value_shape, np.int32)

    def host_add(self, acc: np.ndarray, item) -> np.ndarray:
        qh = hash32_host([item])
        h = int(_fmix32_np(qh)[0])
        bucket = h >> (32 - self.p)
        w = (h << self.p) & 0xFFFFFFFF
        rho = (32 - self.p + 1) if w == 0 else (32 - w.bit_length() + 1)
        acc[bucket] = max(acc[bucket], rho)
        return acc

    def host_merge(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return np.maximum(a, b)

    def host_result(self, acc: np.ndarray) -> float:
        z = float(np.sum(np.exp2(-acc.astype(np.float64))))
        e = self.alpha * self.m * self.m / z
        zeros = int(np.sum(acc == 0))
        if e <= 2.5 * self.m and zeros > 0:
            return float(self.m * np.log(self.m / zeros))
        return float(e)
