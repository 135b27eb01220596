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

``preaggregate`` is the reference's pre-aggregation of a batch by
segment under a general associative combine, merged with each segment's
old accumulator: the generic window reduce and ``KeyedStream.reduce`` run
on it. The sort is G10, the gathers around the combine are G16's
``rep_gather``, and the combine itself — the user's torch function — runs
as torch ops over a log-step (Hillis-Steele) segmented scan, the one step
of the port with no hand kernel. The reference's float ``scatter_combine``
min and max are G3's (``ops/cuda.py`` ``scatter_update``, its plain
version ``_scatter_combine_rows``). ``grouped_reduce``, the batch
DataSet and Table path's per-group aggregate, is one launch of G23
(``scatter_ids``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from flink_tpu_torch.core.device import resolve_device
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


def preaggregate(key: torch.Tensor, values: torch.Tensor, acc: torch.Tensor,
                 touched: torch.Tensor, neutral, combine: Callable,
                 n_rows: int):
    """The reference's ``preaggregate`` (ops/segment.py:131) and the
    gather-combine of its generic update (window_kernels.py:916-927) and
    rolling reduce (rolling.py:54-110): lanes whose ``key`` (int64 [B], a
    row of ``acc`` in [0, n_rows), ``n_rows`` for a dead lane) is equal
    form a segment. G10 sorts them stably by key; G16's rep_gather gathers
    each sorted lane's value (``values`` [B, *v], the ``neutral`` in dead
    lanes) and its row's old value and touched bit; ``combine`` scans each
    segment in lane order (an inclusive segmented scan) and merges the old
    value of a touched row in front: ``combine(old, prefix)``. Returns
    (order int32 [B], key_s int64 [B], seg_start bool [B], merged float32
    [B, *v]): every sorted lane's running value, its segment's last lane
    the segment's total, for G16's rep_set."""
    order, key_s, seg_start = kernels.segment_sort(
        key, bits=_bits(n_rows), seg_shift=0)
    v_s, old, old_t = kernels.rep_gather(order, key_s, values, acc, touched,
                                         neutral)
    prefix = segmented_reduce_sorted(v_s, seg_start, combine)
    merged = torch.where(kernels._expand(old_t, old), combine(old, prefix),
                         prefix)
    return order, key_s, seg_start, merged.to(acc.dtype).contiguous()


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


def grouped_reduce(kind: str, gid, vals, n_groups: int, device=None):
    """Dictionary-encoded grouped reduction (the reference's
    ``flink_tpu/ops/segment.py:183 grouped_reduce``), shared by the batch
    DataSet and Table aggregation paths: one G23 launch an aggregate.

    gid: [N] int group ids in [0, n_groups); vals: [N] float values
    (ignored for 'count'); kind: count, sum, min, max, avg or mean.
    Returns a numpy float32 [n_groups]. ``avg`` is one launch that writes
    the sums and the counts; their quotient is NaN for a group with no
    row, as the reference's 0/0 is. Counts are exact integers (the
    reference adds 1.0 in float32, the same below 2^24 rows a group)."""
    if kind not in ("count", "sum", "min", "max", "avg", "mean"):
        raise ValueError(f"unknown aggregate kind {kind!r}")
    dev = resolve_device(device)
    g = torch.as_tensor(np.asarray(gid, np.int64), device=dev)
    if kind == "count":
        _, cnt, _ = kernels.scatter_ids(g, None, n_groups, counts=True)
        return cnt.to(torch.float32).cpu().numpy()
    v = torch.as_tensor(np.asarray(vals, np.float32), device=dev)
    op = {"sum": "add", "avg": "add", "mean": "add"}.get(kind, kind)
    target, cnt, _ = kernels.scatter_ids(g, v, n_groups, op=op,
                                         counts=kind in ("avg", "mean"))
    if cnt is not None:
        target = target / cnt.to(torch.float32)
    return target.cpu().numpy()
