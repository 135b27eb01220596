"""The shard mesh — the port of flink_tpu/parallel/mesh.py's JAX-free parts.

The reference lays key-group shards over the ``shards`` axis of a
``jax.sharding.Mesh`` and runs one controller over it (``shard_map``).
The port keeps that single-controller design: a ``MeshContext`` holds an
explicit list of torch devices, one per shard, and the executor runs each
shard's kernels under its device's guard in one process. Records reach
their owning shard by replicate-and-mask or by the all_to_all exchange
(``parallel/exchange.py``); the collectives between shards are device
copies (``parallel/collectives.py``).

``mesh_devices(base)`` is every visible CUDA card for a CUDA base device,
``[cpu]`` for the CPU. ``force_device_count(n)`` makes it ``[base] * n``:
the counterpart of XLA's ``--xla_force_host_platform_device_count``, with
which the reference's tests get an 8-device mesh on one CPU. Several
shards then share one device, and their collectives are copies within it.

A mesh may span processes (the cross-process plane, ``runtime/dcn.py``:
the counterpart of the reference's global mesh over ``jax.devices()``).
Each process then holds ``L = len(devices)`` shards on its own devices,
``process_count x L`` shards in all: process p holds shards ``[p * L,
(p + 1) * L)``, and the key groups spread over every shard of every
process. The collectives between processes ride a Gloo group
(``parallel/collectives.py ProcessPlane``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from flink_tpu_torch.core.keygroups import (
    KeyGroupRange,
    check_parallelism,
    key_group_range_for_operator,
)

SHARD_AXIS = "shards"

# the forced device count (None: the visible devices); see force_device_count
_forced: List[Optional[int]] = [None]


def force_device_count(n: Optional[int]) -> None:
    """Make ``mesh_devices`` return ``n`` copies of its base device (``None``
    resets to the visible devices)."""
    if n is not None and int(n) < 1:
        raise ValueError(f"a forced device count must be >= 1, got {n}")
    _forced[0] = None if n is None else int(n)


@contextlib.contextmanager
def forced_device_count(n: int):
    """``force_device_count(n)`` for the block, then the previous count."""
    prev = _forced[0]
    force_device_count(n)
    try:
        yield
    finally:
        _forced[0] = prev


def mesh_devices(base) -> List[torch.device]:
    """The devices a job on ``base`` may spread its shards over: the forced
    count of ``base`` when one is set, else every visible CUDA card for a
    CUDA base and ``[base]`` otherwise."""
    base = torch.device(base)
    if _forced[0] is not None:
        return [base] * _forced[0]
    if base.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [base]


def device_guard(device):
    """The context a shard's launches run in: its card's guard, or nothing
    on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def validate_kg_slices(max_parallelism: int, n_shards: int, slices):
    """Check a custom contiguous key-group slicing: ``slices`` is a
    sequence of ``n_shards`` (start, end) pairs with INCLUSIVE ends,
    non-empty, strictly increasing, covering [0, max_parallelism-1]
    exactly (the reference's check: the ownership mapping and the route
    planner both assume exactly this shape)."""
    if len(slices) != n_shards:
        raise ValueError(
            f"kg_slices has {len(slices)} ranges for {n_shards} shards")
    lo = 0
    for i, (s, e) in enumerate(slices):
        s, e = int(s), int(e)
        if s != lo or e < s:
            raise ValueError(
                f"kg_slices[{i}]=({s},{e}) must start at {lo} and be "
                f"non-empty (inclusive ends, contiguous cover)")
        lo = e + 1
    if lo != max_parallelism:
        raise ValueError(
            f"kg_slices cover [0,{lo - 1}] but max_parallelism is "
            f"{max_parallelism}")


@dataclass
class MeshContext:
    """A job's shard topology: ``devices[s]`` holds this process's shard s,
    which owns the key groups ``local_key_group_ranges[s]``. Over
    ``process_count`` processes the mesh has ``n_shards = process_count x
    len(devices)`` shards, and process ``process_index`` holds shards
    ``local_shards`` of ``key_group_ranges``. ``kg_slices`` optionally
    replaces the uniform partition with a custom contiguous slicing of
    inclusive (start, end) pairs."""

    devices: List[torch.device]
    max_parallelism: int
    kg_slices: Optional[tuple] = None
    process_count: int = 1
    process_index: int = 0
    _ranges: Optional[list] = field(default=None, repr=False)

    @staticmethod
    def create(n_shards: Optional[int] = None, max_parallelism: int = 128,
               devices=None, kg_slices=None, process_count: int = 1,
               process_index: int = 0) -> "MeshContext":
        """``n_shards`` over this process's ``devices`` (one process), or
        ``n_shards = process_count x L`` over ``process_count`` processes,
        this one holding L shards on the first L of ``devices``."""
        devices = list(devices) if devices is not None else \
            mesh_devices("cpu")
        n = n_shards or len(devices) * process_count
        if n % process_count:
            raise ValueError(f"{n} shards do not split over "
                             f"{process_count} processes")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process index {process_index} outside "
                             f"[0, {process_count})")
        local = n // process_count
        if local > len(devices):
            raise ValueError(f"need {local} devices, have {len(devices)}")
        check_parallelism(max_parallelism, n)
        if kg_slices is not None:
            kg_slices = tuple((int(s), int(e)) for s, e in kg_slices)
            validate_kg_slices(max_parallelism, n, kg_slices)
        return MeshContext([torch.device(d) for d in devices[:local]],
                           max_parallelism, kg_slices, process_count,
                           process_index)

    @property
    def n_shards(self) -> int:
        return len(self.devices) * self.process_count

    @property
    def local_shards(self) -> range:
        """The global indices of this process's shards."""
        L = len(self.devices)
        return range(self.process_index * L, (self.process_index + 1) * L)

    @property
    def local_key_group_ranges(self) -> List[KeyGroupRange]:
        """The key-group ranges of this process's shards, in order."""
        return [self.key_group_ranges[s] for s in self.local_shards]

    @property
    def key_group_ranges(self) -> List[KeyGroupRange]:
        if self._ranges is None:
            if self.kg_slices is not None:
                self._ranges = [KeyGroupRange(s, e)
                                for s, e in self.kg_slices]
            else:
                self._ranges = [
                    key_group_range_for_operator(self.max_parallelism,
                                                 self.n_shards, i)
                    for i in range(self.n_shards)]
        return self._ranges

    def kg_bounds(self):
        """(starts[n_shards], ends[n_shards]) int32 arrays of key-group
        ranges."""
        starts = np.asarray([r.start for r in self.key_group_ranges],
                            np.int32)
        ends = np.asarray([r.end for r in self.key_group_ranges], np.int32)
        return starts, ends

    def shard_of_key_groups(self, kg: np.ndarray) -> np.ndarray:
        """Owning shard index per key group: searchsorted over the
        INCLUSIVE range ends with side='left' (the reference's one
        ownership mapping, shared by the route planner, the sharded batch
        ring and the restore's re-bucketing)."""
        return np.searchsorted(self.kg_bounds()[1], kg)
