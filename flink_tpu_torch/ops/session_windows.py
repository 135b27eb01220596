"""Event-time session windows on one shard, in PyTorch — the counterpart
of flink_tpu/ops/session_windows.py.

The reference's design, kept: within a batch, lanes sorted by (slot, tick)
are cut into sessions at a key change or a gap > G; each key holds at most
ONE open session in state (start, last, acc, active); a key's first batch
session within the gap of its open session merges into it, one beyond the
gap supersedes it and the superseded session fires at once, as does every
batch session but a key's last; the watermark closes open sessions with
last + G <= watermark. Session window end = last + G. The reference's
documented deviation holds here too: a key cannot hold two open sessions,
so with out-of-orderness beyond the gap a superseded session fires early.

Per batch: the late filter against the pre-batch watermark and the
counts, as torch ops; the upsert (G5); one sort by (slot, tick) (G10); the
cuts, merges, superseded fires, write-back and watermark close (G11), whose
fires are compacted on the card into one row buffer. Sum and count. No
spill tier: chains of 16, a key with no slot a counted loss.
Processing-time sessions are ROADMAP queue 1, item 9.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import hashtable, segment

WM_NONE = -(2**31) + 1
# the reference's leaves but ``table.keys``, with the port's dtypes
STATE_DTYPES = {"start": torch.int32, "last": torch.int32,
                "acc": torch.float32, "active": torch.bool,
                "watermark": torch.int32, "dropped_late": torch.int32,
                "dropped_capacity": torch.int32}
STATE_FIELDS = ("table.keys",) + tuple(STATE_DTYPES)


@dataclass
class SessionShardState:
    table_keys: torch.Tensor        # int64 [C]
    start: torch.Tensor             # int32 [C]: open session's first tick
    last: torch.Tensor              # int32 [C]: open session's last tick
    acc: torch.Tensor               # float32 [C]
    active: torch.Tensor            # bool [C]
    watermark: torch.Tensor         # int32 0-d
    dropped_late: torch.Tensor      # int32 0-d
    dropped_capacity: torch.Tensor  # int32 0-d

    @property
    def capacity(self) -> int:
        return self.table_keys.shape[0]


def init_state(capacity: int, device="cuda") -> SessionShardState:
    dev = torch.device(device)

    def i32(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int32, device=dev)

    return SessionShardState(
        table_keys=hashtable.create(capacity, dev),
        start=i32(capacity), last=i32(capacity),
        acc=torch.zeros(capacity, dtype=torch.float32, device=dev),
        active=torch.zeros(capacity, dtype=torch.bool, device=dev),
        watermark=i32(fill=WM_NONE), dropped_late=i32(),
        dropped_capacity=i32(),
    )


def update_and_fire(state: SessionShardState, gap: int, hi, lo, ts, values,
                    valid, new_watermark, marks=None):
    """One micro-batch and watermark advance, state in place. hi/lo int32
    [B] (uint32 bits), ts int32 [B] ticks, values float32 [B], valid bool
    [B], new_watermark int32 0-d. Returns (state, rows, n_rows): the fired
    sessions (key hi, key lo, start tick, end tick, value) in the prefix
    ``[:n_rows]`` of 2B + C row buffers — superseded open sessions, then
    superseded batch sessions, then watermark closes, the reference's
    emission order. ``marks`` (int32 [2]), when given, gets the row counts
    where the superseded batch sessions and the closes begin (G11's)."""
    C = state.capacity
    # late against the pre-batch watermark (the elements process before
    # their own batch's watermark advances, as in the reference); int32
    # wraps as jnp's does
    late = valid & (ts + gap <= state.watermark)
    state.dropped_late += late.sum(dtype=torch.int32)
    live = valid & ~late
    slot, ok = hashtable.upsert(state.table_keys, hi, lo, live)
    state.dropped_capacity += (live & ~ok).sum(dtype=torch.int32)
    live = live & ok
    torch.maximum(state.watermark, new_watermark,
                  out=state.watermark)                          # in place
    order, key_s, _ = segment.sort_slot_ts(slot, ts, live, C)
    rows, n_rows = kernels.session_update(
        state.start, state.last, state.acc, state.active, state.table_keys,
        state.watermark, order, key_s, hi, lo, values, G=gap, marks=marks)
    return state, rows, n_rows


def state_from_numpy(fields: Dict[str, np.ndarray],
                     device="cuda") -> SessionShardState:
    """A port state from host arrays named as the reference's
    ``SessionShardState`` leaves (``STATE_FIELDS``)."""
    return hashtable.keyed_state_from_numpy(SessionShardState, fields,
                                            STATE_DTYPES, device)


def state_to_numpy(state: SessionShardState) -> Dict[str, np.ndarray]:
    return hashtable.keyed_state_to_numpy(state, STATE_DTYPES)
