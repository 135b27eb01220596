"""Checkpoint-compatible pipelined ingest — the port of
flink_tpu/runtime/ingest.py, for one device and for a shard mesh.

The window job's cycle splits into a *prep* half (source poll with its
offsets, key / value encode, event times: pure host numpy) and an *apply*
half (watermark, setup, catch-up slicing, dispatch) that runs on the step
loop. ``IngestPipeline`` runs the prep half on one producer thread
(``pipeline.prefetch``) ahead of the step loop, or inline:

* **Epoch-tagged prefetch.** Every prepped batch carries the source
  offsets captured right after its poll and the pipeline epoch it was
  prepped under. The step loop marks each batch applied once its update
  is dispatched; a checkpoint cuts at ``applied_offsets()``, so batches
  polled ahead of the cut replay from the rewound source after a restore
  (whose epoch bump drops them).
* **Device staging** (``pipeline.device-staging``). With a plan
  installed (``IngestPlan``, made when the stage is set up) the producer
  pads each eligible batch and copies it to the card itself: into the
  next slot of the ``DeviceBatchRing`` when the job drains a ring
  (``pipeline.resident-loop: on | while``), else — or when the ring is
  full — through the ``StagingRing``'s pinned buffers into fresh device
  tensors. The first batch (it sets the stage up) and batches whose
  panes span more than the ring holds take the step loop's general path
  unplanned.

CUDA specifics (the reference's ``device_put`` has none of them): the
producer copies on its ring's own copy stream — stream contexts are per
thread — and records an event after each copy; the step loop's stream
waits on that event before the kernels read the slot (a device-side
wait). A ring slot's copy waits on the event the last step or drain that
read the slot recorded, so a slot is never overwritten while queued work
still reads it; a producer refills a slot's pinned host buffers only once
their previous copy has finished (it blocks on that, off the step loop).
A fresh device tensor is allocated on the copy stream; the step loop
marks it used on its own stream (``record_stream``) so that the caching
allocator does not hand its memory back to the copy stream early.

On the CPU (the tests) slots are plain tensors filled in place, and a
fresh batch is a tensor over a padded numpy copy.

Over a shard mesh (``plan.n_shards`` above 1) the plan routes each batch
as the reference's ``plan_route`` does: the all_to_all exchange when
every (source, target) bucket provably fits its capacity, else the
replicate-and-mask route; a batch is padded to ``B_step``, a multiple of
the shard count. With ``pipeline.data-parallel`` the device ring is a
``ShardedDeviceBatchRing``: ``plan_route_and_shards`` takes the sharded
route when each shard's slice fits its lane capacity, and the producer
partitions the batch (a stable sort) into one slot of each shard's own
ring.

Threading contract (the reference's): ONE producer — the prefetch thread,
or the step loop itself with ``pipeline.prefetch: off`` — and one
consumer, the step loop. ``pause()`` / ``resume()`` bracket every source
mutation (a restore). Copied from the reference: ``IngestThreadDied``,
``PreppedBatch``, ``FusedBatchAccumulator`` and ``IngestPipeline``'s
producer, epoch and restore protocol.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.keygroups import assign_to_key_group
from flink_tpu_torch.ops.hashing import route_hash
from flink_tpu_torch.testing import faults


class IngestThreadDied(RuntimeError):
    """The prefetch producer thread died without delivering a batch or
    an error (a hard death: an injected ``kill`` rule, a crash in the
    prep path). A restart recovers from it: the restore's epoch bump lets
    the next ``next()`` spawn a fresh producer."""


# ------------------------------------------------------------- batches

@dataclasses.dataclass
class PreppedBatch:
    """One prepped micro-batch from the ingest side to the step loop.
    ``offsets`` is the source position right after this batch's poll (the
    replay point); ``epoch`` the pipeline incarnation that prepped it."""

    end: bool
    n: int
    offsets: Any = None
    epoch: int = -1
    # host arrays (hi / lo uint32, values, event times ms); None once the
    # batch is staged to the device, or when n == 0
    hi: Any = None
    lo: Any = None
    values: Any = None
    ts_ms: Any = None
    # filled by the plan for batches of one pane group
    ticks: Any = None            # host int32 ticks of a planned, unstaged batch
    ticks_min: Optional[int] = None
    ticks_max: Optional[int] = None
    ts_max: Optional[int] = None
    # "mask" | "exchange" | "sharded" once planned; None: general path
    route: Optional[str] = None
    # the staged (hi, lo, ticks, values, valid) device tensors [B]; on the
    # sharded route a list of each shard's staged [shard_cap] tuple
    staged: Optional[Tuple] = None
    # CUDA: the event recorded after the staging copy (None on the CPU);
    # on the sharded route a list, one a shard
    copied: Any = None
    # the DeviceBatchRing slot sequence holding ``staged`` (None: fresh
    # tensors, outside the ring) and the ring itself; on the sharded route
    # ``ring_seqs`` holds each shard's sequence (None: that shard's ring
    # was full and its slice went out fresh)
    ring_seq: Optional[int] = None
    ring: Any = None
    ring_seqs: Optional[list] = None


@dataclasses.dataclass
class IngestPlan:
    """What the prep side needs once the stage is set up: the time
    domain, the batch geometry, the staging mode and the ring depth
    (0: no device ring, the split path's staging). Installed with
    ``IngestPipeline.set_plan`` by the stage's setup, again by a restore
    that moves the time origin."""

    td: Any                      # core.time.TimeDomain
    slide_ticks: int
    span_limit: int              # catch-up slicing threshold (panes)
    B: int                       # micro-batch lanes
    staging: bool                # stage to the device on the producer?
    device: Any = "cpu"
    value_shape: Tuple = ()
    value_dtype: Any = np.float32
    ring_depth: int = 0
    # the mesh (one shard: every field below at its default): the step's
    # lanes (B padded to a multiple of n_shards; 0 is B), the key-group
    # range ends of the shards, the exchange's per-(source, target)
    # bucket lanes (0: no exchange), the routes the stage built, the
    # sharded route's lanes a shard (0: no sharded ring) and each shard's
    # device
    B_step: int = 0
    n_shards: int = 1
    max_parallelism: int = 128
    kg_ends: Any = None
    exchange_cap: int = 0
    routes: Tuple[str, ...] = ("mask",)
    shard_cap: int = 0
    devices: Any = None

    @property
    def lanes(self) -> int:
        """The lanes a staged batch has: ``B_step``, or ``B``."""
        return self.B_step or self.B


def plan_route(plan: IngestPlan, hi: np.ndarray, lo: np.ndarray,
               kg: Optional[np.ndarray] = None) -> str:
    """Exact per-batch feasibility of the exchange (the reference's): every
    lane's owning shard by the key-group math the device uses, and the
    exchange route only when each (source shard, target shard) bucket
    fits ``plan.exchange_cap`` — a skewed batch takes the mask route, so
    the adaptive route is never lossy. Lane i's source is i // (B_step /
    n). ``kg`` skips the key-group pass when the caller has it."""
    if "exchange" not in plan.routes:
        return "mask"
    if "mask" not in plan.routes:
        return "exchange"        # exchange.mode=all_to_all forced
    n = plan.n_shards
    if kg is None:
        kg = assign_to_key_group(route_hash(hi, lo, np),
                                 plan.max_parallelism, np)
    shard = np.searchsorted(plan.kg_ends, kg)
    bpd = plan.lanes // n
    src = np.arange(len(hi)) // bpd
    counts = np.bincount(src * n + shard, minlength=n * n)
    return ("exchange" if counts.max(initial=0) <= plan.exchange_cap
            else "mask")


def plan_route_and_shards(plan: IngestPlan, hi: np.ndarray, lo: np.ndarray
                          ) -> Tuple[str, Optional[np.ndarray]]:
    """The data-parallel plan (the reference's): one key-group pass gives
    the route and every lane's owning shard. The sharded route when each
    shard's slice fits ``plan.shard_cap``, else ``plan_route`` on the same
    key groups (sharded, then exchange, then mask: never lossy)."""
    kg = assign_to_key_group(route_hash(hi, lo, np), plan.max_parallelism,
                             np)
    if "sharded" in plan.routes and plan.shard_cap > 0:
        shard = np.searchsorted(plan.kg_ends, kg)
        counts = np.bincount(shard, minlength=plan.n_shards)
        if counts.max(initial=0) <= plan.shard_cap:
            return "sharded", shard
    return plan_route(plan, hi, lo, kg=kg), None


# ---------------------------------------------------------- staging

def _host_buffers(depth: int, B: int, value_dtype, value_shape, pin: bool):
    def buf(dtype, tail=()):
        return torch.zeros((depth, B) + tuple(tail), dtype=dtype,
                           pin_memory=pin)
    vdt = torch.int32 if np.dtype(value_dtype) == np.uint32 \
        else torch.float32
    return {"hi": buf(torch.int32), "lo": buf(torch.int32),
            "ticks": buf(torch.int32),
            "values": buf(vdt, value_shape), "valid": buf(torch.bool)}


def _fill(host_np: dict, i: int, hi, lo, ticks, values, n: int) -> None:
    """Pad one batch into slot ``i`` of numpy views of the host buffers
    (uint32 halves and hashes as int32 bits)."""
    h = host_np
    h["hi"][i, :n] = np.asarray(hi[:n]).view(np.int32)
    h["lo"][i, :n] = np.asarray(lo[:n]).view(np.int32)
    h["ticks"][i, :n] = ticks[:n]
    values = np.asarray(values[:n])
    if h["values"].dtype == np.int32:
        values = values.view(np.int32)
    h["values"][i, :n] = values
    for k in ("hi", "lo", "ticks", "values"):
        h[k][i, n:] = 0
    h["valid"][i, :n] = True
    h["valid"][i, n:] = False


def stage_fresh(device, B: int, hi, lo, ticks, values, n: int,
                value_dtype=np.float32, value_shape=()) -> Tuple:
    """Stage one batch from the step loop's thread into fresh device
    tensors on the current stream (a catch-up slice, an unplanned batch,
    a batch with staging off): padded on the host, pinned, and copied
    without blocking the host (the pinned block's reuse waits on the
    copy: PyTorch's caching host allocator records it)."""
    dev = torch.device(device)
    host = _host_buffers(1, B, value_dtype, value_shape, pin=False)
    _fill({k: v.numpy() for k, v in host.items()}, 0, hi, lo, ticks,
          values, n)
    if dev.type != "cuda":
        return tuple(host[k][0] for k in ("hi", "lo", "ticks", "values",
                                          "valid"))
    return tuple(host[k][0].pin_memory().to(dev, non_blocking=True)
                 for k in ("hi", "lo", "ticks", "values", "valid"))


def adopt(pb: PreppedBatch) -> Tuple:
    """The step loop takes a staged batch: its current stream waits on
    the staging copy (on the device), and fresh tensors are marked used
    on that stream. Returns the (hi, lo, ticks, values, valid) tensors."""
    staged = pb.staged
    if pb.copied is not None:
        cur = torch.cuda.current_stream(staged[0].device)
        cur.wait_event(pb.copied)
        if pb.ring_seq is None:
            for t in staged:
                t.record_stream(cur)
    return staged


class StagingRing:
    """Pinned host padding buffers for the producer's staging outside the
    device ring (the reference's StagingRing): each batch is padded into
    the next slot's buffers and copied into fresh device tensors. A
    slot's buffers are refilled only after their last copy finished (the
    producer blocks on it), so depth 2 double-buffers."""

    def __init__(self, plan: IngestPlan, depth: int = 2):
        self.device = torch.device(plan.device)
        self.cuda = self.device.type == "cuda"
        self.depth = max(2, int(depth))
        self.B = int(plan.lanes)
        self.value_dtype, self.value_shape = (plan.value_dtype,
                                              tuple(plan.value_shape))
        if self.cuda:
            self._host = _host_buffers(self.depth, self.B, plan.value_dtype,
                                       plan.value_shape, pin=True)
            self._np = {k: v.numpy() for k, v in self._host.items()}
            self._stream = torch.cuda.Stream(self.device)
            self._last = [None] * self.depth
        self._i = 0

    def stage(self, plan: IngestPlan, hi, lo, ticks, values,
              n: int) -> Tuple[Tuple, Any]:
        """Pad into the next slot and copy; returns (staged tensors, the
        copy's event or None)."""
        if not self.cuda:
            return stage_fresh(self.device, self.B, hi, lo, ticks, values,
                               n, self.value_dtype, self.value_shape), None
        i = self._i
        self._i = (i + 1) % self.depth
        if self._last[i] is not None:
            self._last[i].synchronize()      # its buffers feed that copy
        _fill(self._np, i, hi, lo, ticks, values, n)
        ev = torch.cuda.Event()
        with torch.cuda.stream(self._stream):
            staged = tuple(self._host[k][i].to(self.device,
                                               non_blocking=True)
                           for k in ("hi", "lo", "ticks", "values",
                                     "valid"))
            ev.record(self._stream)
        self._last[i] = ev
        return staged, ev


class DeviceBatchRing:
    """Circular ring of ``depth`` device batch slots with a host write
    cursor (the reference's DeviceBatchRing, pipeline.resident-loop): the
    producer publishes into the next slot, the step loop drains slots and
    releases them. A slot is (seq, epoch); slot ``seq % depth`` holds the
    batch of sequence ``seq``. Each slot has pinned host buffers and
    device tensors (plain tensors on the CPU).

    ``try_publish`` stages into the next slot and advances the write
    cursor, or returns None when the ring is full (counted in
    ``refusals()``; the caller stages through the StagingRing, so a slow
    drain never blocks the poll). The cursor moves after the slot's copy
    is queued, under one lock. The step loop calls ``note_read`` for the
    slots a queued step or drain reads, then ``release_through``.
    ``write_cursor()`` is the while-drain's live bound (the reference's
    HBM cursor slot): the host write cursor, read under the lock."""

    sharded = False      # ShardedDeviceBatchRing overrides

    def __init__(self, plan: IngestPlan, depth: int):
        self.depth = D = max(2, int(depth))
        self.B = int(plan.lanes)
        self.device = torch.device(plan.device)
        self.cuda = self.device.type == "cuda"
        self._host = _host_buffers(D, self.B, plan.value_dtype,
                                   plan.value_shape, pin=self.cuda)
        self._np = {k: v.numpy() for k, v in self._host.items()}
        if self.cuda:
            self._dev = {k: torch.zeros_like(v, device=self.device)
                         for k, v in self._host.items()}
            self._stream = torch.cuda.Stream(self.device)
            self._copied = [torch.cuda.Event() for _ in range(D)]
            self._consumed = [torch.cuda.Event() for _ in range(D)]
            self._pending = [False] * D
        else:
            self._dev = self._host
        self._slots: list = [None] * D
        self._write = 0          # seq of the next slot to publish
        self._read = 0           # seq of the oldest unreleased slot
        self._refusals = 0
        # publish stamps (shard, seq, fill, max_tick, t) for the flight
        # recorder: appended only once the executor sets stats_enabled
        self.stats_enabled = False
        self._pub_samples: deque = deque(maxlen=4096)
        self._lock = threading.Lock()

    def slot(self, seq: int) -> Tuple:
        """Slot ``seq``'s (hi, lo, ticks, values, valid) device tensors."""
        i = seq % self.depth
        d = self._dev
        return (d["hi"][i], d["lo"][i], d["ticks"][i], d["values"][i],
                d["valid"][i])

    # -- producer --------------------------------------------------------
    def try_publish(self, plan: IngestPlan, hi, lo, ticks, values, n: int,
                    route: str, epoch: int):
        """Stage one batch into the next slot; returns (seq, staged
        tensors, copy event or None), or None when the ring is full."""
        if n > self.B:
            raise ValueError(f"{n} records exceed the ring's batch "
                             f"{self.B}")
        with self._lock:
            if self._write - self._read >= self.depth:
                self._refusals += 1
                return None
            seq = self._write
        i = seq % self.depth
        ev = None
        if self.cuda and self._pending[i]:
            # the pinned buffers of slot i may still feed its last copy
            self._copied[i].synchronize()
        _fill(self._np, i, hi, lo, ticks, values, n)
        if self.cuda:
            with torch.cuda.stream(self._stream):
                # never overwrite a slot queued work still reads
                self._stream.wait_event(self._consumed[i])
                for k, dev in self._dev.items():
                    dev[i].copy_(self._host[k][i], non_blocking=True)
                self._copied[i].record(self._stream)
            self._pending[i] = True
            ev = self._copied[i]
        max_tick = int(np.max(ticks[:n])) if n else None
        with self._lock:
            self._slots[i] = (seq, epoch)
            self._write = seq + 1
            if self.stats_enabled:
                self._pub_samples.append((0, seq, self._write - self._read,
                                          max_tick, time.perf_counter()))
        return seq, self.slot(seq), ev

    # -- consumer --------------------------------------------------------
    def note_read(self, seqs) -> None:
        """The work just queued on the current stream reads these slots:
        a later copy into any of them waits for it."""
        if not self.cuda:
            return
        cur = torch.cuda.current_stream(self.device)
        for s in seqs:
            self._consumed[s % self.depth].record(cur)

    def write_cursor(self) -> int:
        with self._lock:
            return self._write

    def occupancy(self) -> int:
        """Published but unreleased slots."""
        with self._lock:
            return self._write - self._read

    def release_through(self, seq: int) -> int:
        """Retire every slot up to and including ``seq``; returns how many.
        Seqs below the read cursor are a no-op (a restore's ``clear`` may
        have retired them)."""
        with self._lock:
            if seq < self._read:
                return 0
            upto = min(seq, self._write - 1)
            n = upto - self._read + 1
            for s in range(self._read, upto + 1):
                self._slots[s % self.depth] = None
            self._read = upto + 1
            return n

    def clear(self) -> int:
        """Restore path: retire every in-flight slot (the epoch bump drops
        the batches referencing them; the source replays them)."""
        with self._lock:
            n = self._write - self._read
            self._slots = [None] * self.depth
            self._read = self._write
            return n

    def refusals(self) -> list:
        with self._lock:
            return [self._refusals]

    def occupancy_shards(self) -> list:
        with self._lock:
            return [self._write - self._read]

    def publish_samples(self) -> list:
        """Drain the publish stamps (empty unless ``stats_enabled``)."""
        with self._lock:
            out = list(self._pub_samples)
            self._pub_samples.clear()
        return out


class ShardedDeviceBatchRing:
    """Per-shard device batch rings (pipeline.data-parallel; the
    reference's ShardedDeviceBatchRing): one ``DeviceBatchRing`` of
    ``plan.shard_cap`` lanes a shard, on the shard's device. The producer
    partitions each batch by owning shard with a stable sort (a key's
    records keep their order, so the accumulation matches the one-shard
    path) and publishes each shard's slice into that shard's ring. A full
    ring refuses only its own shard's slice, which is staged fresh
    (counted in that ring's refusals, its ``ring_seqs`` entry None), so
    one slow shard never blocks the others; the consumer releases each
    shard's ring on its own."""

    sharded = True

    def __init__(self, plan: IngestPlan, depth: int):
        self.depth = max(2, int(depth))
        self.n_shards = int(plan.n_shards)
        self.cap = int(plan.shard_cap)
        devices = plan.devices or [plan.device] * self.n_shards
        self.rings = [
            DeviceBatchRing(dataclasses.replace(plan, B=self.cap, B_step=0,
                                                device=d), self.depth)
            for d in devices]
        self.stats_enabled = False

    def publish_batch(self, plan: IngestPlan, hi, lo, ticks, values,
                      shard: np.ndarray, n: int, epoch: int):
        """Partition one planned batch by owning shard and publish each
        slice into its shard's ring. Returns ``(ring_seqs, staged,
        copied)``: per shard its slot sequence (None: staged fresh), its
        (hi, lo, ticks, values, valid) tensors and its copy event (None on
        the CPU)."""
        # a stable sort of small integers: numpy's radix sort for one-byte
        # keys, several times faster than its merge sort of int64 keys
        key = shard[:n].astype(np.uint8 if self.n_shards <= 256
                               else np.int32)
        order = np.argsort(key, kind="stable")
        counts = np.bincount(shard[:n], minlength=self.n_shards)
        srcs = (hi[order], lo[order], ticks[order], values[order])
        seqs, staged, copied = [], [], []
        pos = 0
        for s, ring in enumerate(self.rings):
            c = int(counts[s])
            part = [a[pos:pos + c] for a in srcs]
            pos += c
            pub = ring.try_publish(plan, *part, c, "sharded", epoch)
            if pub is None:
                seqs.append(None)
                staged.append(stage_fresh(
                    ring.device, self.cap, *part, c, plan.value_dtype,
                    plan.value_shape))
                copied.append(None)
            else:
                seqs.append(pub[0])
                staged.append(pub[1])
                copied.append(pub[2])
        return seqs, staged, copied

    def release_shards(self, seqs) -> None:
        """Retire each shard's slots up to and including ``seqs[s]`` (None:
        nothing of that shard)."""
        for ring, seq in zip(self.rings, seqs):
            if seq is not None:
                ring.release_through(seq)

    def note_read(self, seqs_by_shard) -> None:
        for ring, seqs in zip(self.rings, seqs_by_shard):
            ring.note_read(seqs)

    def clear(self) -> int:
        return sum(r.clear() for r in self.rings)

    def refusals(self) -> list:
        return [r.refusals()[0] for r in self.rings]

    def occupancy_shards(self) -> list:
        return [r.occupancy() for r in self.rings]

    def publish_samples(self) -> list:
        return []


def adopt_shard(pb: PreppedBatch, s: int) -> Tuple:
    """Shard ``s``'s staged slice of a sharded batch, adopted as ``adopt``
    adopts a whole one."""
    staged = pb.staged[s]
    ev = pb.copied[s] if pb.copied is not None else None
    if ev is not None:
        cur = torch.cuda.current_stream(staged[0].device)
        cur.wait_event(ev)
        if pb.ring_seqs[s] is None:
            for t in staged:
                t.record_stream(cur)
    return staged


# ------------------------------------------------------- drain group

class FusedBatchAccumulator:
    """The fused-dispatch slot (the reference's): up to ``k`` consecutive
    planned batches that share a route and a staging mode, which the step
    loop hands to one dispatch — a K-step megastep
    (``pipeline.steps-per-dispatch``, ``runtime/step.py
    build_window_megastep*``) or, in the resident modes, one ring drain.
    The flush triggers (full, a route or staging change, an idle poll,
    end of stream, a checkpoint cut, a restore, the time-jump fire and,
    without ``hold_fires``, a fire boundary) are the step loop's; this
    class keeps the slot's bookkeeping so that the grouping contract is
    testable on its own.

    ``hold_fires`` records that the dispatch fires inside itself (the
    fused-fire megastep, ``pipeline.fused-fire``, and every ring drain):
    a pane crossing inside the group no longer breaks it. Without it the
    step loop flushes at every fire boundary, so that the separate fire
    steps see every pending update.

    A batch in the slot has not been dispatched, so its offsets become
    the applied cut only at the flush, which marks the last flushed
    batch applied (the megastep-boundary cut)."""

    def __init__(self, k: int, hold_fires: bool = False):
        self.k = max(1, int(k))
        self.hold_fires = bool(hold_fires)
        self.items: list = []      # [(staged 5-tuple, wm_ms | None, pb)]
        self.route: Optional[str] = None
        self.staged: Optional[bool] = None

    def __len__(self):
        return len(self.items)

    def compatible(self, route: str, staged: bool) -> bool:
        """Can a batch of this route and staging mode join the group?"""
        return not self.items or (route == self.route
                                  and staged == self.staged)

    def push(self, args: Tuple, wm_ms, pb, route: str = "mask",
             staged: bool = True):
        if not self.items:
            self.route, self.staged = route, staged
        self.items.append((args, wm_ms, pb))

    def full(self) -> bool:
        return len(self.items) >= self.k

    def drain(self):
        """Take the group: ``(route, staged, items)``; the slot is empty
        after."""
        items, self.items = self.items, []
        route, staged = self.route, self.staged
        self.route = self.staged = None
        return route, staged, items

    def clear(self):
        """Restore path: the pending batches replay from the source."""
        self.items = []
        self.route = self.staged = None


# ------------------------------------------------------------- pipeline

class IngestPipeline:
    """Single-producer single-consumer prep pipeline with restore-safe
    epochs (the reference's).

    * ``next()`` — the step loop's intake: with prefetch it takes the
      bounded queue (stale-epoch batches skipped, producer errors raised
      here); without, it runs the prep function inline. Either way the
      batch is finished against the current plan (ticks, eligibility,
      staging).
    * ``try_next()`` — a ready batch or None, without waiting (the drain
      group's greedy fill).
    * ``mark_applied(pb)`` / ``applied_offsets()`` — the checkpoint cut.
    * ``pause()`` / ``resume(offsets)`` — bracket a restore: pause parks
      the producer off the source; resume bumps the epoch, drops queued
      batches, clears the device ring, re-arms the cut and unparks.

    The producer parks after delivering an end-of-stream batch or an
    error instead of exiting: a restore may rewind the source past
    either, and ``resume`` continues the same thread."""

    def __init__(self, prep_fn: Callable[[], PreppedBatch], *,
                 prefetch: bool, initial_offsets: Any = None,
                 depth: int = 2, ring_depth: int = 2):
        self.prep_fn = prep_fn
        self.prefetch = bool(prefetch)
        # serialises the source's wire: the producer holds it across each
        # poll, the step loop around checkpoint-complete notifications
        self.source_lock = threading.RLock()
        # (plan, staging ring, device ring), published as one attribute
        self._rings: Tuple = (None, None, None)
        self._ring_depth = max(2, int(ring_depth))
        self._applied = initial_offsets
        self._epoch = 0
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._gate = threading.Event()       # producer runs while set
        self._pause_req = threading.Event()
        self._parked = threading.Event()
        self._gate.set()
        self._thread: Optional[threading.Thread] = None
        # the epoch the live thread serves: a dead thread is respawned
        # only after a restore bumped the epoch (_ensure_thread)
        self._thread_epoch = -1

    # -- plan ------------------------------------------------------------
    @property
    def plan(self) -> Optional[IngestPlan]:
        return self._rings[0]

    @property
    def device_ring(self) -> Optional[DeviceBatchRing]:
        return self._rings[2]

    def set_plan(self, plan: IngestPlan) -> None:
        """Install or replace the plan; with ``plan.staging`` also the
        staging ring, and with ``plan.ring_depth > 0`` the device ring.
        A batch mid-prep finishes under whichever plan it read."""
        staging = dr = None
        if plan.staging:
            staging = StagingRing(plan, self._ring_depth)
            if plan.ring_depth > 0:
                ring_cls = (ShardedDeviceBatchRing
                            if plan.shard_cap > 0 and "sharded" in plan.routes
                            else DeviceBatchRing)
                dr = ring_cls(plan, plan.ring_depth)
        self._rings = (plan, staging, dr)

    def _finish(self, pb: PreppedBatch) -> PreppedBatch:
        """Apply the plan to a freshly prepped batch: ticks, pane-span
        eligibility, route, and (with staging) the copy to the device.
        An ineligible batch passes through unplanned."""
        plan, staging, dr = self._rings
        if plan is None or pb.n == 0:
            return pb
        pb.ts_max = int(pb.ts_ms.max())
        ticks = plan.td.to_ticks(pb.ts_ms)
        t_min, t_max = int(ticks.min()), int(ticks.max())
        values = pb.values
        eligible = (
            pb.n <= plan.B
            and (t_max // plan.slide_ticks) - (t_min // plan.slide_ticks)
            < plan.span_limit
            and isinstance(values, np.ndarray)
            and values.dtype == plan.value_dtype
            and values.shape[1:] == tuple(plan.value_shape)
        )
        if not eligible:
            return pb
        pb.ticks_min, pb.ticks_max = t_min, t_max
        shard_of = None
        if dr is not None and dr.sharded:
            # one key-group pass plans the route and the partition
            pb.route, shard_of = plan_route_and_shards(plan, pb.hi, pb.lo)
        else:
            pb.route = plan_route(plan, pb.hi, pb.lo)
        if staging is None:
            pb.ticks = ticks
            return pb
        pub = None
        if shard_of is not None:
            pb.ring_seqs, pb.staged, pb.copied = dr.publish_batch(
                plan, pb.hi, pb.lo, ticks, values, shard_of, pb.n, pb.epoch)
            pb.ring = dr
            pb.hi = pb.lo = pb.values = None
            return pb
        if dr is not None and not dr.sharded:
            pub = dr.try_publish(plan, pb.hi, pb.lo, ticks, values, pb.n,
                                 pb.route, pb.epoch)
        if pub is not None:
            pb.ring_seq, pb.staged, pb.copied = pub
            pb.ring = dr
        else:
            # the device ring is full (or the job drains none): stage
            # outside it; the batch still flows in order
            pb.staged, pb.copied = staging.stage(plan, pb.hi, pb.lo, ticks,
                                                 values, pb.n)
        # the staged copies own the batch; drop the host arrays
        pb.hi = pb.lo = pb.values = None
        return pb

    # -- producer --------------------------------------------------------
    def _producer(self):
        while not self._stop.is_set():
            if not self._gate.is_set():
                self._parked.set()
                self._gate.wait(0.1)
                continue
            self._parked.clear()
            # outside the delivery try: an injected raise kills the thread
            # without handing the consumer an error — the dead-producer
            # detection in next() is what it exercises
            faults.inject("ingest.producer", epoch=self._epoch)
            epoch = self._epoch
            park_after = False
            try:
                with self.source_lock:
                    pb = self.prep_fn()
                pb.epoch = epoch
                self._finish(pb)
                item = ("ok", epoch, pb)
                park_after = pb.end
            except Exception as e:   # delivered to the consumer
                item = ("err", epoch, e)
                park_after = True
            if park_after:
                # park BEFORE publishing: the consumer may pause and
                # resume (restore) the instant it sees the item
                self._gate.clear()
            self._put(item)
        self._parked.set()

    def _put(self, item):
        while not self._stop.is_set():
            if self._pause_req.is_set():
                # the consumer is pausing: the epoch is being invalidated
                # and it would skip this item anyway
                return
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def _ensure_thread(self):
        if self._thread is not None and not self._thread.is_alive():
            if self._thread_epoch == self._epoch:
                # a hard death, not a restore respawn: the thread may have
                # died mid-poll, past records it never delivered
                raise IngestThreadDied(
                    "ingest prefetch thread died without delivering a "
                    "batch or an error")
            self._thread = None
        if self._thread is None:
            t = threading.Thread(target=self._producer, daemon=True,
                                 name="flink-tpu-torch-ingest")
            self._thread = t
            self._thread_epoch = self._epoch
            t.start()

    # -- consumer --------------------------------------------------------
    def next(self) -> PreppedBatch:
        if not self.prefetch:
            with self.source_lock:
                pb = self.prep_fn()
            pb.epoch = self._epoch
            return self._finish(pb)
        self._ensure_thread()
        while True:
            try:
                kind, epoch, item = self._q.get(timeout=1.0)
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise IngestThreadDied(
                        "ingest prefetch thread died without delivering "
                        "a batch or an error")
                continue
            if epoch != self._epoch:
                continue     # a pre-restore batch: the source rewound
            if kind == "err":
                raise item
            return item

    def try_next(self) -> Optional[PreppedBatch]:
        """A ready batch, or None when the queue is empty now (and always
        inline: polling here would turn the greedy fill into a
        synchronous poll loop). A dead producer also returns None; the
        next ``next()`` raises."""
        if not self.prefetch:
            return None
        self._ensure_thread()
        while True:
            try:
                kind, epoch, item = self._q.get_nowait()
            except queue.Empty:
                return None
            if epoch != self._epoch:
                continue
            if kind == "err":
                raise item
            return item

    def mark_applied(self, pb: PreppedBatch):
        """Everything up to and including ``pb`` is dispatched to the
        device state: its offsets are the cut a snapshot takes."""
        self._applied = pb.offsets

    def applied_offsets(self):
        return self._applied

    # -- restore protocol ------------------------------------------------
    def pause(self):
        """Park the producer; returns once it is off the source (or was
        never started, or prefetch is off)."""
        self._pause_req.set()
        self._gate.clear()
        if not self.prefetch or self._thread is None:
            return
        while self._thread.is_alive() and not self._parked.is_set():
            self._parked.wait(0.1)

    def resume(self, applied_offsets: Any):
        """Drop every batch prepped before the pause and restart from the
        (rewound) source; ``applied_offsets`` re-arms the cut."""
        self._epoch += 1
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        dr = self.device_ring
        if dr is not None:
            dr.clear()
        self._applied = applied_offsets
        if self._thread is not None and self._thread.is_alive():
            # the parked producer serves the new epoch: a later hard death
            # must surface, not pass for a restore respawn
            self._thread_epoch = self._epoch
        self._pause_req.clear()
        self._gate.set()

    def close(self):
        self._stop.set()
        self._gate.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
