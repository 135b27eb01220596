"""Count windows on one shard, in PyTorch — the counterpart of
flink_tpu/ops/count_windows.py: per-key tumbling windows of N elements
(the reference's GlobalWindows + CountTrigger(N) + purging).

A batch is upserted (G5) and sorted by slot (G10); each lane's absolute
element index within its key gives its window; each (key, window) is
reduced, the key's carried partial folded into its first window, the
windows that fill to N fire as rows, and the trailing partial stays in
state (G12). Sum and count (a count sums ones). Capacity as in
``ops/rolling.py``: chains of 16, no spill tier, a key with no slot a
counted loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import hashtable, segment

# the reference's leaves but ``table.keys``, with the port's dtypes
STATE_DTYPES = {"count": torch.int32, "acc": torch.float32,
                "touched": torch.bool, "dropped_capacity": torch.int32}
STATE_FIELDS = ("table.keys",) + tuple(STATE_DTYPES)


@dataclass
class CountShardState:
    table_keys: torch.Tensor        # int64 [C]
    count: torch.Tensor             # int32 [C]: elements seen per key
    acc: torch.Tensor               # float32 [C]: the trailing partial
    touched: torch.Tensor           # bool [C]: the partial has data
    dropped_capacity: torch.Tensor  # int32 0-d

    @property
    def capacity(self) -> int:
        return self.table_keys.shape[0]


def init_state(capacity: int, device="cuda") -> CountShardState:
    dev = torch.device(device)
    return CountShardState(
        table_keys=hashtable.create(capacity, dev),
        count=torch.zeros(capacity, dtype=torch.int32, device=dev),
        acc=torch.zeros(capacity, dtype=torch.float32, device=dev),
        touched=torch.zeros(capacity, dtype=torch.bool, device=dev),
        dropped_capacity=torch.zeros((), dtype=torch.int32, device=dev),
    )


def update(state: CountShardState, n_per_window: int, hi, lo, values,
           valid):
    """One micro-batch, state in place. Returns (state, rows, n_rows):
    the completed windows as (key hi, key lo, 0-based window ordinal of
    the key, value) in the prefix ``[:n_rows]`` of the [B] row buffers,
    in the reference's sorted-lane order."""
    C = state.capacity
    slot, ok = hashtable.upsert(state.table_keys, hi, lo, valid)
    state.dropped_capacity += (valid & ~ok).sum(dtype=torch.int32)
    live = valid & ok
    order, key_s, seg_start = segment.sort_slots(slot, live, C)
    rows, n_rows = kernels.count_update(
        state.count, state.acc, state.touched, order, key_s, seg_start, hi,
        lo, values, N=n_per_window)
    return state, rows, n_rows


def state_from_numpy(fields: Dict[str, np.ndarray],
                     device="cuda") -> CountShardState:
    """A port state from host arrays named as the reference's
    ``CountShardState`` leaves (``STATE_FIELDS``)."""
    return hashtable.keyed_state_from_numpy(CountShardState, fields,
                                            STATE_DTYPES, device)


def state_to_numpy(state: CountShardState) -> Dict[str, np.ndarray]:
    return hashtable.keyed_state_to_numpy(state, STATE_DTYPES)
