"""Rolling (non-windowed) keyed aggregation on one shard, in PyTorch —
the counterpart of flink_tpu/ops/rolling.py (the reference's
StreamGroupedReduce analog).

Each key keeps one accumulator; every input record emits its key's
accumulator right after it is applied, in lane order. A batch is upserted
into the hash table (G5), sorted by slot (G10), scanned per key with the
pre-batch accumulator folded in, scattered back to lane order, and each
key's total written back: by G13 for a sum (a count sums the ones its
extractor gives), and for ``KeyedStream.reduce``'s generic reduce by
``segment.preaggregate`` — G16's gather, the user's combine as torch ops
over a log-step segmented scan, merged as ``combine(old, prefix)`` — and
G16's set, which also writes each lane's running value in lane order.

The reference's stage ignores ``state.probe-len`` and claims with 8
rounds; it has no spill tier, so a record whose key finds no slot is a
counted loss (``dropped_capacity``) and strict capacity fails the job at
its end. The port does the same with G5's CAS walk, which places every key
whose 16-slot chain has room.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import hashtable, segment

# the reference's leaves but ``table.keys``, with the port's dtypes
STATE_DTYPES = {"acc": torch.float32, "touched": torch.bool,
                "dropped_capacity": torch.int32}
STATE_FIELDS = ("table.keys",) + tuple(STATE_DTYPES)


@dataclass
class RollingShardState:
    """The reference's pytree field for field (``table.keys`` as one int64
    key word per slot, ``ops/hashtable.py``)."""

    table_keys: torch.Tensor        # int64 [C]
    acc: torch.Tensor               # float32 [C, *value_shape]
    touched: torch.Tensor           # bool [C]
    dropped_capacity: torch.Tensor  # int32 0-d

    @property
    def capacity(self) -> int:
        return self.table_keys.shape[0]


def init_state(capacity: int, device="cuda", red=None) -> RollingShardState:
    """An empty table; every accumulator at the reduce's neutral (0 for a
    sum, or ``red``'s for a generic reduce, of its ``value_shape``)."""
    dev = torch.device(device)
    acc = torch.zeros(capacity, dtype=torch.float32, device=dev)
    if red is not None and red.kind == "generic":
        acc = torch.as_tensor(red.neutral_value(), dtype=torch.float32).to(
            dev).expand((capacity,) + tuple(red.value_shape)).contiguous()
    return RollingShardState(
        table_keys=hashtable.create(capacity, dev),
        acc=acc,
        touched=torch.zeros(capacity, dtype=torch.bool, device=dev),
        dropped_capacity=torch.zeros((), dtype=torch.int32, device=dev),
    )


def update(state: RollingShardState, hi, lo, values, valid, red=None):
    """One micro-batch, state in place. hi/lo int32 [B] (uint32 bits),
    values float32 [B] (``[B, *value_shape]`` for a generic ``red``),
    valid bool [B]. Returns (state, outputs float32 [B, *value_shape],
    out_valid bool [B]): outputs[i] is record i's key accumulator right
    after record i (lane order = batch order); out_valid the lanes whose
    key has a slot."""
    C = state.capacity
    slot, ok = hashtable.upsert(state.table_keys, hi, lo, valid)
    state.dropped_capacity += (valid & ~ok).sum(dtype=torch.int32)
    live = valid & ok
    if red is None or red.kind != "generic":
        order, key_s, seg_start = segment.sort_slots(slot, live, C)
        out = kernels.rolling_update(state.acc, state.touched, order, key_s,
                                     seg_start, values)
        return state, out, live
    key = torch.where(live, slot.to(torch.int64), C)
    order, key_s, seg_start, merged = segment.preaggregate(
        key, values, state.acc, state.touched, red.neutral_value(),
        red.combine_fn(), C)
    out = torch.empty_like(merged)
    kernels.rep_set(state.acc, state.touched, order, key_s, seg_start,
                    merged, out=out)
    return state, out, live


def state_from_numpy(fields: Dict[str, np.ndarray],
                     device="cuda") -> RollingShardState:
    """A port state from host arrays named as the reference's
    ``RollingShardState`` leaves (``STATE_FIELDS``; ``table.keys`` the
    uint32 [C, 2] rows)."""
    return hashtable.keyed_state_from_numpy(RollingShardState, fields,
                                            STATE_DTYPES, device)


def state_to_numpy(state: RollingShardState) -> Dict[str, np.ndarray]:
    return hashtable.keyed_state_to_numpy(state, STATE_DTYPES)
