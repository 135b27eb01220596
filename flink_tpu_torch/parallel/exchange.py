"""The keyed record exchange — the port of flink_tpu/parallel/exchange.py
(kernel K12): the keyBy hash shuffle between the shards of a mesh.

The host splits each batch into one lane slice a shard (B / n lanes). For
each source shard, G26 (``ops/cuda.py exchange_pack``) buckets its lanes
by owning shard into ``[n * cap]`` send buffers, at stable ranks so that
a target receives each source's lanes in order; ``parallel/collectives.py
all_to_all`` hands each target its buckets; the target's update masks the
received lanes to its key groups in G1 (``wk.update``'s ``kg_start`` /
``kg_end``: the reference's ``exchange_owned`` mask). Lanes past their
bucket's capacity are counted per source, never silently lost: the
caller adds them to the source shard's ``dropped_capacity``.

Over a mesh that spans processes (``exchange_across``) the five columns
of each send buffer travel packed as one int32 ``[n, 5, cap]`` block (the
values' float bits, the valid flag as 0 / 1) through the plane's
all_to_all (``parallel/collectives.py ProcessPlane``): one Gloo call a
round instead of five.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.parallel.mesh import device_guard
from flink_tpu_torch.parallel.collectives import all_to_all


def bucket_capacity(batch_per_device: int, n_shards: int,
                    factor: float = 2.0) -> int:
    """Per-(sender, target) bucket capacity: factor x expected fill,
    clamped to [8, batch_per_device] (the reference's)."""
    expected = max(1, batch_per_device // max(1, n_shards))
    return max(8, min(batch_per_device, int(round(factor * expected))))


def split_lanes(slot, n: int, devices) -> List[Tuple]:
    """A staged ``[B]`` batch ``(hi, lo, ts, values, valid)`` as n lane
    slices ``[s * B / n, (s + 1) * B / n)``, slice s on ``devices[s]``."""
    B = slot[0].shape[0]
    if B % n:
        raise ValueError(f"a {B}-lane batch does not split over {n} shards")
    bpd = B // n
    return [tuple(t[s * bpd:(s + 1) * bpd].to(devices[s], non_blocking=True)
                  for t in slot) for s in range(n)]


def exchange_records(slices: Sequence[Tuple], n: int, max_parallelism: int,
                     cap: int, devices):
    """Route each source shard's lane slice to the owning shards: G26 on
    every source, then one all_to_all per column. Returns ``(received,
    overflow)``: for each target t, ``(hi, lo, ts, values, valid)`` of
    ``n * cap`` lanes on ``devices[t]`` (every valid lane owned by t), and
    for each source s its int32 [1] count of lanes that found no room."""
    packs = []
    for s, (hi, lo, ts, values, valid) in enumerate(slices):
        dev = torch.device(devices[s])
        with device_guard(dev):
            packs.append(kernels.exchange_pack(hi, lo, ts, values, valid,
                                               n=n, maxp=max_parallelism,
                                               cap=cap))
    cols = [all_to_all([p[j] for p in packs], devices) for j in range(5)]
    received = [tuple(c[t] for c in cols) for t in range(n)]
    return received, [p.overflow for p in packs]



def exchange_across(plane, slices: Sequence[Tuple], n: int,
                    max_parallelism: int, cap: int, devices):
    """``exchange_records`` over a mesh of ``plane.nproc`` processes:
    ``slices[s]`` is this process's shard s's ``(hi, lo, ts, values,
    valid)`` lane slice (scalar float32 values) on ``devices[s]``, and
    ``n`` counts the shards of every process. G26 buckets each slice over
    the n shards, the plane's all_to_all hands each local target its
    buckets from every shard of every process. Returns ``(received,
    overflow)`` as ``exchange_records`` does, for this process's shards."""
    packed, overflow = [], []
    for s, (hi, lo, ts, values, valid) in enumerate(slices):
        dev = torch.device(devices[s])
        with device_guard(dev):
            p = kernels.exchange_pack(hi, lo, ts, values, valid, n=n,
                                      maxp=max_parallelism, cap=cap)
            cols = torch.stack([p.hi, p.lo, p.ts, p.values.view(torch.int32),
                                p.valid.to(torch.int32)])
            packed.append(cols.view(5, n, cap).transpose(0, 1).contiguous())
        overflow.append(p.overflow)
    received = []
    for t, buf in enumerate(plane.all_to_all(packed, devices)):
        with device_guard(devices[t]):
            col = [buf[:, c, :].reshape(-1) for c in range(5)]
            received.append((col[0], col[1], col[2],
                             col[3].view(torch.float32), col[4] != 0))
    return received, overflow


def owned_lanes(hi, lo, valid, kg_start: int, kg_end: int,
                max_parallelism: int) -> torch.Tensor:
    """The replicate-and-mask route's owner mask for a stage with no pane
    ring (rolling reduces, sessions, count windows, CEP): G1 over the
    shard's key-group range at slide 1, zero ticks and the MIN watermark,
    so that no lane is late and its live lanes are the valid lanes of the
    shard's key groups (the reference's ``valid & kg in [start, end]``).
    bool [B] on the lanes' device."""
    none = torch.tensor(kernels.PANE_NONE, dtype=torch.int32,
                        device=hi.device)
    return kernels.route_lanes(hi, lo, torch.zeros_like(hi), valid, none,
                               none, slide=1, k=1, maxp=max_parallelism,
                               kg_start=kg_start, kg_end=kg_end)[2]
