"""Sort lanes by segment and reduce each segment — the counterpart of
flink_tpu/ops/segment.py for the session, count-window and rolling stages.

The reference sorts a micro-batch by segment id with ``jnp.argsort``
(stable) and reduces runs of equal ids with a flagged associative scan.
Here one stable radix sort (kernel G10, ``ops/cuda.py``) orders the lanes
by a 64-bit key built below, and returns the flags of the sorted order;
the scan runs inside the operators' kernels (G11-G13,
``csrc/segscan.cuh``), and ``segmented_reduce_sorted`` is its plain
PyTorch form for any associative combine.

Keys: a slot sort (rolling, count windows) uses the slot, and the slot C
for lanes with no slot, so they sort last in lane order — the reference's
``big`` id, with as few bits as C needs. A session sort uses ``(slot <<
32) | (ts ^ 0x80000000)`` and ``C << 32`` for dead lanes, one sort in
place of the reference's two stable sorts (``_lexsort_slot_ts``).

``preaggregate``, ``scatter_combine`` and ``grouped_reduce`` have no
caller on the port's paths yet (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

from typing import Callable

import torch

from flink_tpu_torch.ops import cuda as kernels

INT32_MAX = 2**31 - 1


def _bits(n: int) -> int:
    return max(1, int(n).bit_length())


def argsort_ids(ids: torch.Tensor) -> torch.Tensor:
    """Permutation (int64) ordering int32 ``ids`` ascending, equal ids in
    lane order (the reference's ``jnp.argsort`` is stable whatever its
    ``stable`` flag says, so the port sorts stably always)."""
    key = ids.to(torch.int64) + 2**31       # int32 order as a uint32 key
    order, _, _ = kernels.segment_sort(key, bits=32, seg_shift=0)
    return order.long()


def invert_permutation(order: torch.Tensor) -> torch.Tensor:
    """out[order[i]] = i."""
    out = torch.empty_like(order)
    out[order.long()] = torch.arange(order.shape[0], dtype=order.dtype,
                                     device=order.device)
    return out


def segment_sort(seg_ids: torch.Tensor, valid: torch.Tensor):
    """The reference's ``segment_sort``: order lanes by int32 segment id
    with invalid lanes last (id INT32_MAX). Returns (order int64, ids_s,
    valid_s, seg_start, rep_mask) as it does."""
    ids = torch.where(valid, seg_ids, INT32_MAX).to(torch.int32)
    order = argsort_ids(ids)
    ids_s = ids[order]
    valid_s = valid[order]
    seg_start = torch.ones_like(valid_s)
    seg_start[1:] = ids_s[1:] != ids_s[:-1]
    end = torch.ones_like(valid_s)
    end[:-1] = seg_start[1:]
    return order, ids_s, valid_s, seg_start, end & (ids_s != INT32_MAX)


def segmented_reduce_sorted(values: torch.Tensor, seg_start: torch.Tensor,
                            combine: Callable) -> torch.Tensor:
    """Inclusive segmented scan of sorted ``values``: the last lane of each
    segment holds the segment's reduction."""
    return kernels.seg_scan_plain(seg_start, values, combine)


def reduce_sorted(order, valid_s, seg_start, values, combine: Callable,
                  neutral):
    """Gather ``values`` through ``order``, the neutral in invalid lanes,
    and reduce each segment."""
    v = values[order]
    v = torch.where(valid_s, v, torch.as_tensor(neutral, dtype=v.dtype))
    return segmented_reduce_sorted(v, seg_start, combine)


def sort_slots(slot: torch.Tensor, live: torch.Tensor, capacity: int):
    """G10 on the slot key: (order int32, key_s int64 — the slot, or
    ``capacity`` for a dead lane — seg_start bool)."""
    key = torch.where(live, slot.to(torch.int64), capacity)
    return kernels.segment_sort(key, bits=_bits(capacity), seg_shift=0)


def sort_slot_ts(slot: torch.Tensor, ts: torch.Tensor, live: torch.Tensor,
                 capacity: int):
    """G10 on the (slot, tick) key: (order int32, key_s int64 —
    ``(slot << 32) | (ts ^ 0x80000000)``, ``capacity << 32`` for a dead
    lane — seg_start bool, the starts of each slot's lanes)."""
    key = (slot.to(torch.int64) << 32) | (ts.to(torch.int64) + 2**31)
    key = torch.where(live, key, capacity << 32)
    return kernels.segment_sort(key, bits=32 + _bits(capacity),
                                seg_shift=32)
