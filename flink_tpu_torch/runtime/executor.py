"""Local executor for one keyed event-time window stage on one device or
over a shard mesh — the main-path slice of flink_tpu/runtime/executor.py
(``_run_windowed``), and with ``dcn.coordinator`` set the multi-process
path (``_run_dcn``: the job's stage over a mesh that spans every worker
process running the same program, ``runtime/dcn.py``).

It runs ``source -> [assign timestamps] -> key_by -> tumbling or sliding
event-time window [-> allowed_lateness] -> sum | count | min | max | mean |
reduce | aggregate | distinct_count | count_min -> sinks``. Each cycle
splits into the reference's two halves (``runtime/ingest.py``):

  * **prep** (``prep_batch``): poll ``execution.micro-batch-size`` records
    with the post-poll source offsets, encode keys to 64-bit identities
    (``KeyCodec``, split (hi, lo)) and values, take the event times. With
    ``pipeline.prefetch`` (auto: on) it runs on the producer thread of an
    ``IngestPipeline`` ahead of the step loop, which also converts the
    times to int32 ticks and copies each batch of one pane group to the
    device (``pipeline.device-staging``); with checkpoints and a source
    that cannot replay, ``auto`` polls inline and ``on`` raises;
  * **apply** (the step loop): the watermark (``WatermarkStrategy.
    on_batch``), the stage's setup on the first batch (the time origin at
    ``floor(min_ts / size) * size``, as the reference fixes it), the
    time-jump guard, then the dispatch the mode gives.

The dispatch modes resolve as the reference resolves
``pipeline.resident-loop`` (executor.py:1639-1697, 5520-5615):

  * ``auto`` (and ``off``): the **split path** while
    ``pipeline.steps-per-dispatch`` is 1. One update step a batch
    (``build_window_update_step``: G1-G3, G5 or G8 in the hash layout, G7
    with an overflow ring), nothing read back; on CUDA the loop waits on
    the event of the dispatch ``pipeline.max-inflight-steps`` (4) back,
    never on the whole device. When the watermark crosses a pane boundary
    the fire steps run (``build_window_fire_reduced_step``, G4, for
    device-reduce sinks with no spill stores, else
    ``build_window_fire_step``, G6) until one fills fewer than F lanes.
    Every MON_EVERY-th step's (ring fill, activity, key-group fill) is
    read OVF_LAG samples late: it settles the insert / fast step tiering
    and drains a ring fuller than B / 8;
  * ``off``, and ``auto`` on the CPU or without staging, with
    ``steps-per-dispatch`` K above 1 (a single-stage job): the split path
    with **K-step megasteps** (the reference's dispatch fusion,
    executor.py:4136-4600). K planned batches of one route and staging
    mode group in the fused slot and run as one ``build_window_megastep``
    (a partial group — at end of stream, an idle poll, a route change,
    the time-jump fire, a checkpoint cut — as single steps); the flush
    marks the group's last batch applied. With ``pipeline.fused-fire``
    (auto: on) the group holds across crossings and runs as
    ``build_window_megastep_fired``, each sub-step firing under its own
    watermark; its fires are read before the next dispatch, and the
    flush runs the fire steps when the reference's lane-budget model
    says a backlog may remain (and after every group with allowed
    lateness). Without it the group flushes at each fire boundary, whose
    fire steps follow. ``auto`` with K above 1 on CUDA with staging is the
    scan drain, as the reference's;
  * ``on``: the **scan drain** — the producer publishes into the
    ``DeviceBatchRing`` and the step loop groups up to
    ``pipeline.ring-depth`` staged batches (taking every batch the queue
    already holds) into one resident drain (``build_window_resident_drain``);
  * ``while``: the **while-drain** (``build_window_while_drain``) over
    groups of up to ``pipeline.while-drain.max-slots`` (0: twice the ring
    depth, never below it), its bound re-reading the ring's write cursor
    before every slot; on the CPU it is the scan drain unless
    ``pipeline.while-drain.cpu-override: on``. ``on`` and ``while`` need
    prefetch and staging, and raise the reference's error without.

In the drain modes the first batch and catch-up spans (batches prepped
before the plan, or spanning more panes than the ring holds) take the
general path as 1-slot drains. A drain's fires are read once, before the
next dispatch — when every sink is a device-reduce sink the fires are
reduced on the device and the host reads the [D, F] ReducedFires
(``sink.invoke_reduced``); otherwise the drain compacts them to rows
(CompactFires); the host reads the small [D, F] fields once, then the
``[:count]`` row prefixes in one batched read, and hands each slot's rows
to ``invoke_columnar`` ({"key_id", "window_end_ms", "value"}) when every
sink is columnar, else ``invoke_batch`` with ``WindowResult(key,
window_end_ms, value)`` rows, keys decoded. At end of stream the job
flushes with the MAX watermark.

``mean`` and ``aggregate`` carry a result projection (``result_fn``): the
reference divides, or calls the AggregateFunction's ``get_result``, on the
host at emit, after the spill merge; the port does the same, so their
sinks get rows (never the device-reduced aggregates).

Allowed lateness L > 0 (``allowed_lateness``; the reference's, executor.py
:1847-1868, 5432): the pane ring grows by L / slide panes, the spill tier
is off (strict capacity: the host stores carry no freshness, so they
cannot replay a re-fire), and the auto layout resolves to hash. On a
drain every batch drains alone; on the split path every batch's update is
followed by fire steps. Each fires with the classic advance — F on-time
lanes,
then up to F re-fires of windows a late record reached, each re-emitting
only those keys with the window's corrected value — and the executor then
fires eagerly at the batch's watermark until a step fills fewer than F
lanes of either kind, before the next batch: the reference's split path
with ``drain_fires`` every cycle. Records beyond the lateness count into
``dropped_late``.

A sketch stage (``distinct_count``: HyperLogLog; ``count_min``: Count-Min,
``ops/sketches.py``) hashes each record's item on the host (the stage's
``value_prep``, as the reference does at executor.py:5472) and stages the
uint32 hashes in an int32 values column. Its state keeps the reference's
split planes (``state.packed-planes: on`` raises, as the reference's
does); it has no spill tier, so the ``auto`` layout resolves to hash, an
explicit ``state.backend.overflow-ring`` above 0 raises, and capacity is
strict. Its fires run on G15, and its rows carry a vector value (a
Count-Min query's ``[Q]`` int32 estimates, or its raw ``[D*W]``
registers) or HyperLogLog's float32 estimate: a columnar sink gets a
``value`` column of ``[n, Q]`` (or ``[n]``), a row sink
``WindowResult(key, window_end_ms, value)`` with the value as a list (or
a float), as the reference emits them.

The spill tier (the reference's, executor.py:4609-4840, 5040-5080), for
the builtin float32 reduces of at most one value dimension (sum, count,
min, max, mean) at allowed lateness 0: a
record whose key finds no state slot (a key past capacity in the direct
layout, a full probe chain in the hash layout) goes to the device overflow
ring, auto-sized as the reference sizes it unless
``state.backend.overflow-ring`` sets it (0: no ring, strict capacity).
With a ring, every drain returns the ring's fill after each slot with its
fires; when it is above 0, the host reads the ring and folds it into one
``SpillStore`` per pane — slot by slot, each slot's share before that
slot's fires are emitted, so a window merges exactly the records that
reached the card before it fired — and merges the stores into every row
it emits by the reduce's host combine (``HOST_REDUCE``: add, minimum or
maximum, column by column): a key on both sides is combined, a key only
in the stores adds a row. It then compacts a hash table (the dead keys'
slots are freed; a live key that no longer fits moves its state to the
ring, which is read again) and drops the stores of purged panes. With a ring and a hash
table, the executor also tiers its steps as the reference does: the
insert drain while new keys are placed, the lookup-only fast drain
(G8) once two drains in a row placed none, back on a miss.

The state layout follows ``state.backend.layout`` as the reference's does:
``auto`` takes the direct layout (key == slot) when the first batch's key
identities all fit ``[0, state capacity)``, else the hash table.

A drain whose last slot filled all F fire lanes may leave due windows
behind; the executor then fires them with watermark-only advances before
the next drain, as the reference's split drain does. A batch that spans
more panes than the ring can hold is cut into pane groups that fire
between them, and a jump of two or more panes between polls fires the
windows it would otherwise evict first — both as the reference does.

Telemetry (the reference's, executor.py:3686-3802), on an event-time
time-window job:

  * fire latency, always: every emitted window is one sample weighted by
    its keys (the ``metrics.fires`` delta) — a drain's fires at their
    consume, measured from the drain's dispatch; a watermark-only
    advance's from when the host saw the crossing.
    ``metrics.fire_latency_pct(q)`` answers the weighted percentile;
  * ``observability.drain-stats`` (default: the tracing flag, so off):
    the drain's flight recorder (G18), read with the drain's fires on
    every ``observability.drain-stats-every``-th drain into a
    ``DrainTelemetry`` that also takes each staged batch's publish stamp
    and each dispatch; ``env._pipeline_report()`` is its report;
  * ``observability.kg-stats`` (default: the tracing flag): the batches'
    lanes per key group (G1's fill), read with the drain's fires every
    MON_EVERY batches, and the live keys per key group (G17), refreshed at
    fire boundaries at most once an ``observability.kg-stats-interval-ms``;
    ``env._kg_report(k)`` reports both.

``observability.tracing`` (the reference's span tracer) is not ported: it
raises.

The pipeline doctor (``observability.doctor``, default on; the copied
``metrics/doctor.py``): ``env._doctor_report()`` joins the planes the port
has — ``pipeline`` (``_pipeline_report()``), ``metrics``
(``JobMetrics.GAUGE_FIELDS``), ``checkpoints`` and ``fire_latency_ms`` —
and returns the rule engine's ranked findings with the snapshot and the
``observability.doctor.*`` thresholds, as the reference's does
(executor.py:3814-3877); it has no ``compile`` plane (eager steps compile
nothing per shape) and no ``recovery`` plane (item 13). With
``controller.enabled`` the copied ``runtime/controller.py``
``RuntimeController`` is serviced at each poll-cycle cut, its actuators
where the reference registers them (executor.py:5640-5806):
``ring-fill-target`` in the resident modes and ``dispatch-group`` with K
above 1 (the fused slot's capacity: a move changes the next group), and
``drain-stats-cadence`` and ``tier-prefetch-ahead`` with the recorder and
tiered state; its ledger persists in the checkpoint directory and
``env._controller_report()`` serves it. Its rebalance arm needs more than
one shard and the flight recorder's key-group heat; when its skew test
fires, the rescale (the reference's savepoint-cut ``_rescale_live``)
raises (ROADMAP queue 1, item 10).

Checkpoints and restarts (the reference's sync-full path, executor.py:
2855-2960, 3327-3490, 6270-6360), for a single-stage window job:
``env.enable_checkpointing(n, dir)`` takes a checkpoint once n batches
have been applied since the last, at a poll-cycle boundary — every grouped
batch drained and every fire read, the windows due at the current
watermark fired, then the state, the spill stores and the offsets of the
last APPLIED batch (``IngestPipeline.applied_offsets``: the producer may
have polled past them) written as the reference's logical entries
(``runtime/checkpoint.py``). A restore pauses the producer, drops the
grouped and queued batches, clears the device ring (the epoch bump) and
rewinds the source before the producer resumes.
``execute(restore_from=dir)`` resumes from the newest checkpoint there
(the reference's own included), and ``restart-strategy`` restarts a
failed job in-process from the newest one of its own directory.

Tiered key-group state (``state.tiers.resident-key-groups``, the
reference's executor.py:1772-1986, 4840-5023): a budget of key groups
keeps device slot rows, the rest live in the spill tier's host stores.
The drains take the residency mask as one device operand (G1 diverts the
cold groups' lanes to the overflow ring); at each poll-cycle boundary the
copied ``runtime/tiers.py`` ``TierManager`` plans demotes and promotes
from the flight recorder's key-group heat (flat without it) and the
pending panes of the cold groups, and the job swaps them: the pending
fires read, the state staged to logical entries, the demoted groups'
entries folded into the stores, the promoted groups' taken out of them,
the state rebuilt around the rest and the mask rewritten.

Chained keyed window stages (the reference's stage graph,
executor.py:889-946, 1581-1591, 5279-5320): ``key_by -> window -> key_by(
r.key) -> window(...)(r.value)`` up to ``pipeline.stages.max-stages``
event-time tumbling or sliding stages with builtin reduces, validated by
the copied ``runtime/stages.py`` (a ``StageGraphError`` names the stage
or edge it cannot run). The chained drain is the job's only dispatch:
stage 0 takes the staged batches, each downstream stage the whole drain's
upstream fires once a drain through an edge of
``pipeline.stages.exchange-lanes`` lanes (G21); the sinks take the final
stage's rows. There is no spill tier (strict capacity; ``auto`` takes the
hash layout, as the reference's does), no fast step and no watermark-only
fire: a flush — at a pane jump, a pane group, a drain whose stage filled
all F lanes, the end of the stream — is the reference's empty chained
drains. Edge lanes past the budget count into the downstream stage's
``dropped_capacity``, which the job's strict-capacity check sums over
every stage.

Parallelism (the reference's executor.py:1596-1598, 2013-2052, 5620-
5631): a job runs ``n = max(1, min(parallelism, len(mesh_devices(
device))))`` shards (``parallel/mesh.py``; ``force_device_count(n)`` puts
n shards on one device), each owning a contiguous key-group range, one
state a shard. With n above 1 ``exchange.mode`` picks how records reach
their shard: ``auto`` plans each batch (``ingest.plan_route``: the
all_to_all exchange — G26, the all_to_all, G1's owner mask — when every
bucket of ``exchange.capacity-factor`` x the balanced share fits, else
replicate-and-mask), ``all_to_all`` always exchanges (a bucket's overflow
counts into ``dropped_capacity``), ``mask`` never does; the batch pads to
a multiple of n. ``pipeline.data-parallel`` (``auto``: on in a resident
mode at n above 1) adds the sharded route: the producer partitions each
batch into per-shard rings and each shard drains its own slots. The
shards' fires merge on the host; the spill stores are shared (the shards
own disjoint keys), each shard has its own overflow ring. Allowed
lateness runs each shard's fire steps with re-fires; the flight recorder
reads every shard's [D, 9] stack (a report row a ring lane: a shard with
the sharded ring, else one). A chained job drains each shard's stages
over its key groups (``step.build_sharded_chained_drain``: the mask
route, or with ``pipeline.data-parallel`` the sharded route, each shard
its own slots, count and watermark). Session and count windows, rolling
reduces and device CEP take n shards too (``keyed_jobs.py``,
``cep_job.py``). At n above 1 tiered state raises (ROADMAP queue 1,
item 10).

Rolling reduces (``key_by(...).sum(...)``, ``.reduce(fn)``), count
windows (``count_window(n)``) and event-time session windows go to the
runners of ``runtime/keyed_jobs.py``; ``CEP.pattern(...).select`` /
``flat_select`` (keyed or not, processing or event time, from an
element-mode or a columnar source) to the device CEP job of
``runtime/cep_job.py``. An element-mode source (``from_collection``)
feeds any stage as the reference's element mode: each selector called
per element. Anything else — another topology, processing-time windows,
the host CEP operator (``cep.device.enabled: false``), checkpoints of
anything but a single-stage window job, an operator after the stage,
sinks on more than one stage, a reduce other than sum or count over
session and count windows — raises NotImplementedError naming the
ROADMAP queue item that brings it.
Records lost to capacity (no ring, a full ring, or panes evicted from the
pane ring unfired) count into ``dropped_capacity``, and the job fails at
its end with the reference's "state backend over capacity" error.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.config import CoreOptions
from flink_tpu_torch.core.time import MAX_TS, TimeCharacteristic, TimeDomain
from flink_tpu_torch.datastream.window.assigners import (
    CountWindowAssigner,
    SessionWindowAssigner,
    WindowAssigner,
)
from flink_tpu_torch.graph import stream_graph as sg
from flink_tpu_torch.metrics.doctor import diagnose
from flink_tpu_torch.metrics.drain_stats import DrainTelemetry
from flink_tpu_torch.metrics.latency import LatencySamples
from flink_tpu_torch.native import SpillStore
from flink_tpu_torch.ops import window_kernels as wk
from flink_tpu_torch.ops.cuda import PANE_JUMP_CLAMP, WM_FRESH
from flink_tpu_torch.parallel.exchange import bucket_capacity
from flink_tpu_torch.parallel.mesh import MeshContext, mesh_devices
from flink_tpu_torch.runtime import cep_job, keyed_jobs
from flink_tpu_torch.runtime import checkpoint as ckpt
from flink_tpu_torch.runtime import controller as controller_mod
from flink_tpu_torch.runtime import sources as sources_mod
from flink_tpu_torch.runtime import tiers as tiers_mod
from flink_tpu_torch.runtime import ingest as ingest_mod
from flink_tpu_torch.runtime.job import (
    StageJob, batch_len, key_words, per_batch, split_poll,
)
from flink_tpu_torch.runtime.stages import StageGraph, StageGraphError
from flink_tpu_torch.runtime.step import (
    WindowStageSpec,
    build_sharded_chained_drain,
    build_sharded_drain,
    build_sharded_fire_step,
    build_sharded_megastep,
    build_sharded_update_step,
    clear_overflow,
    compact_step,
    init_shard_state,
    init_sharded_state,
    sharded_kg_occupancy,
)
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
from flink_tpu_torch.testing import faults

WindowResult = keyed_jobs.WindowResult
SessionResult = keyed_jobs.SessionResult

# The reference samples the ring's fill and the step activity every
# MON_EVERY micro-batches and reads a sample OVF_LAG samples late; its auto
# ring absorbs the full-batch overflow of that window. The port reads each
# drain's fill and activity with the drain's fires, one drain late, and
# sizes the ring by the same formula.
MON_EVERY = 8
OVF_LAG = 1
# builtin reduce kinds the spill tier merges on the host: kind ->
# (accumulating numpy ufunc, neutral element), the reference's _HOST_REDUCE
HOST_REDUCE = {
    "sum": (np.add, 0.0),
    "count": (np.add, 0.0),
    "min": (np.minimum, np.inf),
    "max": (np.maximum, -np.inf),
}
# consecutive drains that placed no key before the insert step gives way
# to the lookup-only fast step
TIER_QUIET_CHECKS = 2
WM_SENTINEL = -(2**31) + 1     # a fresh state's watermark


def panes_crossed(wm_before: int, wm_after: int, slide: int) -> int:
    """Panes a watermark advance from ``wm_before`` to ``wm_after`` ticks
    crosses, counted as the flight recorder (G18) counts them."""
    if wm_before < WM_FRESH:
        return 0
    wb = max(wm_before, wm_after - PANE_JUMP_CLAMP)
    return max(0, wm_after // slide - wb // slide)


@dataclasses.dataclass
class JobMetrics:
    records_in: int = 0
    records_out: int = 0        # rows (or aggregates) handed to the sinks
    fires: int = 0              # (key, window) results emitted
    steps: int = 0              # micro-batches applied
    resident_drains: int = 0    # drain dispatches (each up to ring depth)
    # K-step megastep dispatches (pipeline.steps-per-dispatch > 1), each
    # K micro-batches of ``steps``; of them, those that fired inside the
    # dispatch (pipeline.fused-fire)
    fused_dispatches: int = 0
    fused_fire_dispatches: int = 0
    fire_steps: int = 0         # watermark-only fire advances
    steps_fast: int = 0         # micro-batches run on the fast step
    ring_drains: int = 0        # overflow ring reads into the spill stores
    compactions: int = 0        # hash-table rebuilds (G9)
    spilled_records: int = 0    # ring lanes folded into the spill stores
    spill_peak_keys: int = 0    # most (pane, key) entries the stores held
    dropped_late: int = 0
    dropped_capacity: int = 0
    fire_step_fires: int = 0    # of ``fires``, those of watermark-only
                                # advances (the rest: the drains' own)
    fire_step_panes: int = 0    # panes the watermark-only advances crossed
                                # (counted as the flight recorder counts)
    chain_flush_drains: int = 0  # of ``resident_drains``, a chained job's
                                 # empty drains of its watermark flushes
    # CEP: the engine that ran ("device"; the host NFA is not ported), the
    # count NFA's steps, and the matches the card detected and the host
    # replay extracted — the two must agree
    cep_engine: str = ""
    cep_device_steps: int = 0
    cep_matches_detected: int = 0
    cep_matches_extracted: int = 0
    # fire latency: bounded weighted samples, one per emission weighted by
    # its windows (the reference's; the p99 half of the north-star metric)
    fire_latency: Any = None
    # checkpoints and restarts: restarts taken, the checkpoint history (the
    # reference's rows, newest last) and, for each restart, the ms from
    # the failure to the first drain dispatched after its restore
    restarts: int = 0
    checkpoint_stats: Any = None
    recovery_ms: Any = None
    # tiered state: host seconds spent in the tier swaps
    tier_swap_s: float = 0.0
    # full device-ring publishes the producer staged outside the ring: a
    # drain that cannot keep up, as backpressure (the reference's
    # ring_publish_refusals gauge)
    ring_publish_refusals: int = 0
    # over a shard mesh: how records reach their shard ("mask",
    # "all_to_all" or "adaptive"), the batches the exchange routed and
    # those the sharded drains took (pipeline.data-parallel)
    exchange_mode: str = ""
    steps_exchanged: int = 0
    steps_sharded: int = 0
    # the multi-process path (dcn.coordinator): the records this process's
    # lanes carried
    dcn_ingested_local: int = 0
    # the reference's counters of paths the port does not run yet; they
    # stay 0 (the failure budget and the watchdog: item 13)
    checkpoints_aborted: int = 0
    checkpoints_declined: int = 0
    watchdog_trips: int = 0

    # the counter fields the reference exports as gauges, and the doctor's
    # ``metrics`` plane
    GAUGE_FIELDS = (
        "records_in", "records_out", "fires", "steps", "steps_fast",
        "steps_sharded",
        "fused_dispatches", "fused_fire_dispatches", "resident_drains",
        "dropped_late", "dropped_capacity", "restarts",
        "checkpoints_aborted", "checkpoints_declined", "watchdog_trips",
    )

    def record_checkpoint(self, cid: int, trigger_ms: float,
                          duration_ms: float, nbytes: int,
                          entries: int) -> None:
        """A completed sync-full checkpoint (the reference's row; the
        whole duration stalls the loop, so it is the sync_ms too)."""
        if self.checkpoint_stats is None:
            self.checkpoint_stats = []
        self.checkpoint_stats.append({
            "id": cid, "status": "completed",
            "trigger_ms": round(trigger_ms, 1),
            "duration_ms": round(duration_ms, 2), "bytes": nbytes,
            "entries": entries, "kind": "full",
            "sync_ms": round(duration_ms, 2), "async_ms": 0.0,
            "staging_wait_ms": 0.0, "staging_occupancy": 0})
        del self.checkpoint_stats[:-200]      # bounded history

    def record_fire_latency(self, n_windows: int, ms: float) -> None:
        if self.fire_latency is None:
            self.fire_latency = LatencySamples()
        self.fire_latency.record(n_windows, ms)

    def fire_latency_pct(self, q: float):
        """Weighted percentile (0..100) over emitted windows; None if
        none."""
        if not self.fire_latency:
            return None
        return self.fire_latency.percentile(q)


@dataclasses.dataclass
class JobHandle:
    name: str
    metrics: JobMetrics
    state: Any = None      # final device state of the window stage


@dataclasses.dataclass
class _Pipeline:
    source: Any
    ts_transform: Optional[sg.TimestampsWatermarksTransformation]
    key_by: sg.KeyByTransformation
    window_agg: Optional[sg.WindowAggTransformation]
    sinks: List[Any]
    rolling: Optional[sg.KeyedProcessTransformation] = None
    process: Optional[sg.ProcessTransformation] = None   # CEP
    # chained keyed window stages after the first: [key_by, window_agg]
    # pairs in order, validated into ``graph`` (runtime/stages.py)
    stages: List[list] = dataclasses.field(default_factory=list)
    graph: Optional[StageGraph] = None
    # the partition annotation upstream of key_by (rebalance, rescale,
    # shuffle, global): the multi-process path's ingest partitioner, a
    # recorded no-op on one process (the reference's executor.py:925-927)
    ingest_partition: Optional[str] = None

    @property
    def stage(self):
        """The transformation whose output the sinks take."""
        if self.stages:
            return self.stages[-1][1]
        return self.rolling or self.process or self.window_agg


def _unsupported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to flink_tpu_torch yet ({item})")


def _chain_tail_error(stages) -> StageGraphError:
    return StageGraphError(
        f"stage[{len(stages)}] does not end in a window aggregation — a "
        f"chained keyed stage must be a keyBy→window pair (rolling reduces "
        f"and process functions cannot chain after a windowed stage)")


def _translate(sink_ts: List[sg.SinkTransformation],
               dcn: bool = False) -> _Pipeline:
    """Check the job is a topology the port runs and collect it:
    source -> [timestamps] -> [a partition annotation] -> key_by -> a
    window aggregation, a rolling reduce or a CEP pattern -> sinks.
    ``dcn``: the multi-process path, which checks the stage itself
    (``_run_dcn``)."""
    if not sink_ts:
        raise ValueError("job has no sinks")
    pipe = None
    partition = None
    for st in sink_ts:
        chain = sg.lineage(st)
        head, rest = chain[0], chain[1:]
        if not isinstance(head, sg.SourceTransformation):
            raise _unsupported(f"a {type(head).__name__} input",
                               "ROADMAP queue 1, item 9")
        ts_t = key_t = agg_t = None
        stages: List[list] = []
        for t in rest:
            if isinstance(t, sg.PartitionTransformation) and key_t is None:
                if t.mode not in ("broadcast", "forward"):
                    partition = t.mode
            elif isinstance(t, sg.TimestampsWatermarksTransformation) \
                    and key_t is None and ts_t is None:
                ts_t = t
            elif isinstance(t, sg.KeyByTransformation) and key_t is None:
                key_t = t
            elif isinstance(t, sg.KeyByTransformation) \
                    and isinstance(agg_t, sg.WindowAggTransformation):
                # a second keyed boundary: a chained stage (the
                # reference's executor.py:889-897)
                stages.append([t, None])
            elif isinstance(t, sg.WindowAggTransformation) and stages:
                if stages[-1][1] is not None:
                    raise StageGraphError(
                        f"two window aggregations with no keyBy between "
                        f"them after stage[{len(stages)}] — every chained "
                        f"stage is a keyBy→window pair")
                stages[-1][1] = t
            elif isinstance(t, sg.WindowAggTransformation) \
                    and isinstance(agg_t, sg.WindowAggTransformation):
                raise StageGraphError(
                    "two window aggregations with no keyBy between them "
                    "— a downstream window must re-key the upstream "
                    "stage's results (.key_by(lambda r: r.key))")
            elif isinstance(t, (sg.KeyedProcessTransformation,
                                sg.ProcessTransformation)) and stages:
                raise _chain_tail_error(stages)
            elif isinstance(t, (sg.WindowAggTransformation,
                                sg.KeyedProcessTransformation,
                                sg.ProcessTransformation)) \
                    and key_t is not None and agg_t is None:
                agg_t = t
            elif isinstance(t, sg.SinkTransformation) and t is st \
                    and agg_t is not None:
                pass
            else:
                raise _unsupported(
                    f"operator {t.name!r} ({type(t).__name__}) in this "
                    f"position", "ROADMAP queue 1, items 9-15")
        if stages and stages[-1][1] is None:
            raise _chain_tail_error(stages)
        if agg_t is None:
            raise _unsupported("a job without a keyed window",
                               "ROADMAP queue 1, item 9")
        final = stages[-1][1] if stages else agg_t
        if pipe is None:
            def of(cls):
                return agg_t if isinstance(agg_t, cls) else None
            pipe = _Pipeline(head.source, ts_t, key_t,
                             of(sg.WindowAggTransformation), [st.sink],
                             of(sg.KeyedProcessTransformation),
                             of(sg.ProcessTransformation), stages)
        elif final is pipe.stage:
            pipe.sinks.append(st.sink)
        else:
            raise _unsupported("sinks on more than one keyed stage or "
                               "branch of the job", "ROADMAP queue 1, item 9")
    pipe.ingest_partition = partition
    if pipe.stages:
        # every unsupported chain shape raises here, naming its stage or
        # edge, before anything runs (the reference's executor.py:1239-1245)
        pipe.graph = StageGraph.from_pipeline(pipe)
    if dcn or pipe.process is not None or pipe.rolling is not None:
        return pipe
    wagg = pipe.window_agg
    assigner = wagg.assigner
    if isinstance(assigner, SessionWindowAssigner) \
            and not assigner.is_event_time:
        raise _unsupported("processing-time session windows",
                           "ROADMAP queue 1, item 9")
    if not isinstance(assigner, (WindowAssigner, SessionWindowAssigner,
                                 CountWindowAssigner)) \
            or (isinstance(assigner, WindowAssigner)
                and not assigner.is_event_time):
        raise _unsupported(
            f"window assigner {type(assigner).__name__} (only event-time "
            f"tumbling, sliding and session windows and count windows are)",
            "ROADMAP queue 1, item 9")
    if wagg.trigger is not None or wagg.evictor is not None \
            or wagg.window_fn is not None or wagg.reduce_spec_factory is None:
        raise _unsupported("custom triggers, evictors and window functions",
                           "ROADMAP queue 1, item 9")
    if wagg.value_prep is not None \
            and not isinstance(assigner, WindowAssigner):
        raise _unsupported("sketches over session and count windows",
                           "ROADMAP queue 1, item 9")
    if not isinstance(assigner, WindowAssigner):
        kind = wagg.reduce_spec_factory().kind
        if kind not in ("sum", "count", "sketch"):
            raise _unsupported(f"{kind} reduces over session and count "
                               f"windows", "ROADMAP queue 1, item 9")
        if wagg.result_fn is not None or wagg.allowed_lateness_ms:
            raise _unsupported("result projections and allowed lateness "
                               "over session and count windows",
                               "ROADMAP queue 1, item 9")
    if wagg.allowed_lateness_ms and wagg.value_prep is not None:
        raise _unsupported("allowed lateness on sketch windows",
                           "ROADMAP queue 1, item 9")
    return pipe


class LocalExecutor:
    def __init__(self, env):
        self.env = env

    def run(self, job_name: str, sinks, restore_from=None) -> JobHandle:
        env = self.env
        checkpointing = (restore_from is not None
                         or env.checkpoint_interval_steps > 0)
        if checkpointing:
            _check_checkpoint_config(env.config)
        if env.config.get_bool("observability.tracing", False):
            raise _unsupported(
                "observability.tracing (the step-loop span tracer, the "
                "reference's metrics/tracing.py SpanTracer)",
                "ROADMAP queue 1, item 15")
        dcn = bool(env.config.get_str("dcn.coordinator", ""))
        pipe = _translate(sinks, dcn=dcn)
        # a time-window job replaces these with its own telemetry
        env._pipeline_report = _no_pipeline_report
        env._kg_report = _no_kg_report(env.max_parallelism)
        env._doctor_report = _no_doctor_report
        env._controller_report = _no_controller_report
        env._gauges = {}
        if dcn:
            # never single-host: the plane runs the job or it raises
            if pipe.stages:
                raise StageGraphError(
                    "multi-stage keyed chains are single-host for now — "
                    "the DCN lockstep plane runs one keyed stage")
            for s in pipe.sinks:
                s.open()
            pipe.source.open()
            try:
                return _run_dcn(env, pipe, JobMetrics(), job_name,
                                restore_from)
            finally:
                pipe.source.close()
                for s in pipe.sinks:
                    s.close()
        # rolling and count stages need no time characteristic; time and
        # session windows run in event time only
        if pipe.window_agg is not None \
                and not isinstance(pipe.window_agg.assigner,
                                   CountWindowAssigner) \
                and env.time_characteristic != TimeCharacteristic.EventTime:
            raise _unsupported(
                "processing-time session windows"
                if isinstance(pipe.window_agg.assigner, SessionWindowAssigner)
                else "processing-time windows", "ROADMAP queue 1, item 9")
        if pipe.process is not None:
            job_cls = _cep_job_class(env, pipe)
        elif pipe.rolling is not None:
            job_cls = keyed_jobs.RollingJob
        elif isinstance(pipe.window_agg.assigner, CountWindowAssigner):
            job_cls = keyed_jobs.CountJob
        elif isinstance(pipe.window_agg.assigner, SessionWindowAssigner):
            job_cls = keyed_jobs.SessionJob
        else:
            job_cls = _WindowJob
        if checkpointing and (job_cls is not _WindowJob
                              or pipe.graph is not None):
            raise _unsupported(
                "checkpoint snapshot and restore of chained stage graphs, "
                "session, count-window and rolling stages and CEP jobs",
                "ROADMAP queue 1, item 6")
        if job_cls is _WindowJob:
            job = _WindowJob(env, pipe, JobMetrics(), restore_from)
        else:
            job = job_cls(env, pipe, JobMetrics())
        for s in pipe.sinks:
            s.open()
        pipe.source.open()
        try:
            job.run()
        finally:
            pipe.source.close()
            for s in pipe.sinks:
                s.close()
        job.finish()
        states = getattr(job, "states", None)
        return JobHandle(job_name, job.metrics,
                         state=states if states is not None
                         and len(states) > 1 else job.state)


def _run_dcn(env, pipe: _Pipeline, metrics: JobMetrics, job_name,
             restore_from=None) -> JobHandle:
    """Multi-process execution over the DCN plane (the reference's
    ``_run_dcn``, executor.py:1298-1541): the SAME program runs in every
    worker process; ``dcn.coordinator``, ``dcn.num-processes`` and
    ``dcn.process-id`` select this path from ``env.execute()``. The
    pipeline's windowed keyed stage lowers to a ``DCNJobSpec``; each
    process ingests ITS source's records, and the keyed shuffle rides the
    plane's collectives (``runtime/dcn.py``). Covered: event-time
    tumbling, sliding and session windows over integer keys with a
    builtin reduce (sum, min, max, count; sessions sum and count). Every
    other stage raises the reference's error, or NotImplementedError
    naming the ROADMAP item, and never runs single-host."""
    from flink_tpu_torch.parallel.collectives import ProcessPlane
    from flink_tpu_torch.runtime import dcn

    cfg = env.config
    coord = cfg.get_str("dcn.coordinator")
    nproc = cfg.get_int("dcn.num-processes", 1)
    pid = cfg.get_int("dcn.process-id", 0)
    res_dcn = cfg.get_str("pipeline.resident-loop", "auto")
    # "on" and "while" drain up to ring-depth locally polled batches per
    # lockstep round in one dispatch (the slot count agreed as the pmax of
    # the hosts' fills); "auto" keeps the single-step lockstep dispatch
    if cfg.get_str("pipeline.data-parallel", "auto") == "on":
        raise ValueError(
            "pipeline.data-parallel=on is incompatible with the DCN "
            "lockstep plane: the sharded ring drain rides the "
            "resident loop, which the lockstep plane cannot run; "
            "unset it or use pipeline.data-parallel=auto"
        )
    wagg = pipe.window_agg
    if wagg is None or pipe.key_by is None:
        raise NotImplementedError(
            "dcn execution covers windowed keyed stages "
            "(tumbling/sliding/session); run other stage kinds "
            "single-host or restructure the job"
        )
    if env.time_characteristic != TimeCharacteristic.EventTime or (
        pipe.ts_transform is None and not pipe.source.columnar
    ):
        raise NotImplementedError(
            "dcn execution requires event time, with an "
            "assign_timestamps_and_watermarks stage or a columnar "
            "source carrying a timestamp array (the lockstep "
            "watermark is the pmin of per-host event-time watermarks)"
        )
    if (wagg.trigger is not None or wagg.evictor is not None
            or wagg.window_fn is not None or wagg.allowed_lateness_ms):
        raise NotImplementedError(
            "dcn execution does not cover custom triggers/evictors/"
            "window functions or allowed lateness — these stage "
            "shapes run single-host (the generic window operator)"
        )
    if wagg.reduce_spec_factory is None:
        raise NotImplementedError(
            "dcn execution requires a reduce aggregation "
            "(sum/min/max/count)"
        )
    red = wagg.reduce_spec_factory()
    if red.kind not in ("sum", "min", "max", "count") or \
            red.finalize is not None or \
            tuple(red.value_shape or ()) not in ((), (1,)):
        raise NotImplementedError(
            f"dcn execution supports scalar built-in reduces, not "
            f"{red.kind!r} with value shape {red.value_shape!r} (e.g. "
            f"mean() needs the composite-accumulator fire path)"
        )
    if wagg.result_fn is not None:
        raise NotImplementedError(
            "dcn execution does not apply result_fn finalization; "
            "use a plain sum/min/max/count reduce"
        )
    assigner = wagg.assigner
    spec_kw = dict(
        capacity_per_shard=env.state_capacity_per_shard,
        max_parallelism=env.max_parallelism,
        batch_per_host=env.batch_size,
        reduce_kind=red.kind,
        out_of_orderness_ms=(
            getattr(pipe.ts_transform.strategy, "out_of_orderness_ms", 0)
            if pipe.ts_transform is not None else 0),
        origin_ms=cfg.get_int("dcn.origin-ms", 0),
        steps_per_dispatch=cfg.get_int("pipeline.steps-per-dispatch", 1),
        resident=res_dcn in ("on", "while"),
        resident_ring_depth=cfg.get_int("pipeline.ring-depth", 16),
    )
    # the physical ingest partitioner: the API annotation wins, the
    # dcn.ingest-partitioner config is the fallback; the ring side
    # channel takes one host:port per process from dcn.rebalance-addrs
    part = pipe.ingest_partition or cfg.get_str("dcn.ingest-partitioner",
                                                "forward")
    if part == "rebalance":
        spec_kw.update(rebalance=True)
    elif part != "forward":
        spec_kw.update(ingest_partitioner=part)
    if part not in ("forward", "rescale") and nproc > 1:
        addrs = cfg.get_str("dcn.rebalance-addrs", "")
        if not addrs:
            raise ValueError(f"ingest partitioner {part!r} needs "
                             f"dcn.rebalance-addrs (one host:port per "
                             f"process)")
        spec_kw.update(rebalance_addrs=addrs.split(","))
    if isinstance(assigner, SessionWindowAssigner):
        if not assigner.is_event_time:
            raise NotImplementedError(
                "dcn execution covers event-time sessions only "
                "(processing-time sessions would close on the host "
                "clock, not the lockstep watermark)")
        if red.kind not in ("sum", "count"):
            raise _unsupported(f"{red.kind} reduces over session windows",
                               "ROADMAP queue 1, item 9")
        spec_kw.update(window_kind="session", gap_ms=assigner.gap_ms)
    elif isinstance(assigner, WindowAssigner) and assigner.is_event_time:
        spec_kw.update(size_ms=assigner.size_ms, slide_ms=assigner.slide_ms,
                       fires_per_step=cfg.get_int("window.fires-per-step",
                                                  4))
    else:
        raise NotImplementedError(
            f"dcn execution does not cover {type(assigner).__name__} "
            f"windows")
    if restore_from and (
            not env.checkpoint_dir
            or os.path.abspath(str(restore_from))
            != os.path.abspath(env.checkpoint_dir)):
        # the runner restores the latest GLOBAL cut from the job's own
        # lockstep checkpoint directory; substituting it for a named
        # savepoint would resume from different state
        raise NotImplementedError(
            "dcn execution restores from the job's configured checkpoint "
            "directory (the lockstep global cut); pass restore_from equal "
            "to the checkpoint directory, or point enable_checkpointing "
            "at the savepoint")

    key_sel = pipe.key_by.key_selector
    ts_fn = (pipe.ts_transform.timestamp_fn
             if pipe.ts_transform is not None else None)
    source = pipe.source

    class _PipeSource:
        """This process's pipeline source as the plane's per-host
        partition (poll / snapshot / restore)."""

        def poll(self, max_records):
            polled, end = source.poll(max_records)
            batch, src_ts = split_poll(polled)
            if not batch_len(batch):
                z = np.zeros(0, np.int64)
                return z, z, np.zeros(0, np.float32), end
            keys = np.asarray(per_batch(key_sel, batch))
            vals = np.asarray(per_batch(wagg.extractor, batch), np.float32)
            ts = np.asarray(per_batch(ts_fn, batch) if ts_fn is not None
                            else src_ts, np.int64)
            if not np.issubdtype(keys.dtype, np.integer):
                raise NotImplementedError(
                    "dcn execution requires integer keys (the key id IS "
                    "the 64-bit routing identity across processes; string "
                    "keys would need a coordinated codec)")
            metrics.records_in += len(keys)
            return keys.astype(np.int64), ts, vals.reshape(-1), end

        def snapshot(self):
            return source.snapshot_offsets()

        def restore(self, state):
            source.restore_offsets(state)

    spec = dcn.DCNJobSpec(source_factory=lambda _pid, _nproc: _PipeSource(),
                          **spec_kw)
    plane = ProcessPlane(nproc, pid, coord)
    try:
        runner = dcn.runner_for_spec(
            spec, pid, nproc, checkpoint_dir=env.checkpoint_dir or None,
            ckpt_every=env.checkpoint_interval_steps or 0,
            restore=bool(restore_from), device=env.device, plane=plane)
        out = runner.run()
    finally:
        plane.close()
    metrics.steps = out["cycles"]
    metrics.dcn_ingested_local = int(out["ingested_local"])
    metrics.dropped_capacity = int(out["dropped_capacity"])
    keys = out["key_id"].astype(np.uint64).view(np.int64)
    metrics.fires += len(keys)
    metrics.records_out += len(keys)
    if all(getattr(s, "columnar", False) for s in pipe.sinks):
        cols = {"key_id": out["key_id"], "window_end_ms": out["window_end_ms"],
                "value": out["value"]}
        if spec.window_kind == "session":
            cols["window_start_ms"] = out["window_start_ms"]
        for s in pipe.sinks:
            s.invoke_columnar(cols)
    else:
        if spec.window_kind == "session":
            rows = [SessionResult(k, int(a), int(b), float(v)) for k, a, b, v
                    in zip(keys.tolist(), out["window_start_ms"],
                           out["window_end_ms"], out["value"])]
        else:
            rows = [WindowResult(k, int(b), float(v)) for k, b, v in
                    zip(keys.tolist(), out["window_end_ms"], out["value"])]
        for s in pipe.sinks:
            s.invoke_batch(rows)
    return JobHandle(job_name, metrics)


def _check_checkpoint_config(cfg) -> None:
    """Checkpoints are sync-full: the incremental and asynchronous modes
    and the task-local snapshot cache raise."""
    if cfg.get_str("checkpoint.mode", "full") != "full":
        raise _unsupported("checkpoint.mode: incremental",
                           "ROADMAP queue 1, item 13")
    if cfg.get_bool("checkpoint.async", False):
        raise _unsupported("checkpoint.async", "ROADMAP queue 1, item 13")
    if cfg.get_bool("checkpoint.local.enabled", False):
        raise _unsupported("checkpoint.local.enabled (the task-local "
                           "snapshot cache)", "ROADMAP queue 1, item 13")


def _cep_job_class(env, pipe):
    """The device CEP job, or a refusal naming what the slice lacks: the
    reference's host CEP operator (``_run_process``), which it takes with
    ``cep.device.enabled: false`` and for an event-time job without a
    timestamp assigner."""
    if not env.config.get_bool("cep.device.enabled", True):
        raise _unsupported("cep.device.enabled: false (the host CEP "
                           "operator)", "ROADMAP queue 1, item 9")
    if pipe.process.fn.event_time and pipe.ts_transform is None:
        raise _unsupported("event-time CEP without a timestamp assigner "
                           "(the host CEP operator)",
                           "ROADMAP queue 1, item 9")
    return cep_job.CepJob


def _no_pipeline_report() -> dict:
    return {"available": False,
            "reason": "observability.drain-stats off or the resident loop "
                      "is not active"}


def _no_doctor_report() -> dict:
    return {"available": False,
            "reason": "the doctor serves keyed time-window jobs"}


def _no_controller_report() -> dict:
    return {"available": False, "reason": "controller.enabled off"}


def _no_kg_report(maxp: int):
    def kg_report(k: int = 10) -> dict:
        return {"key_groups": maxp, "n_shards": 1, "occupancy_top": [],
                "fill_top": [], "fill_sampled_batches": 0,
                "occupied_groups": None}
    return kg_report


def _top_k(arr, k: int):
    """The k largest non-zero entries of ``arr`` as {"group", "count"}."""
    if arr is None or not len(arr):
        return []
    k = max(1, min(int(k), len(arr)))
    idx = np.argsort(arr)[::-1][:k]
    return [{"group": int(g), "count": int(arr[g])} for g in idx if arr[g] > 0]


@dataclasses.dataclass
class _Dispatch:
    """How a window job feeds and dispatches its stage, resolved as the
    reference resolves it (executor.py:1639-1697, 5520-5615)."""

    prefetch: bool       # the prep half runs on the producer thread
    staging: bool        # the producer copies batches to the device
    resident: bool       # a ring drain (scan, while or chained) per group
    while_drain: bool    # the while-drain (resident-loop: while)
    max_slots: int       # pipeline.while-drain.max-slots, resolved
    k_fuse: int = 1      # pipeline.steps-per-dispatch
    fused_fire: bool = False   # K > 1 and pipeline.fused-fire not off
    data_parallel: bool = False   # the sharded route's drains


def _resolve_dispatch(cfg, chained: bool, can_snapshot: bool, source,
                      device, n_shards: int = 1) -> _Dispatch:
    """``pipeline.prefetch``, ``pipeline.device-staging`` and
    ``pipeline.resident-loop`` as the reference resolves them, with its
    errors. ``auto`` is the split path while ``steps-per-dispatch`` is 1;
    above 1 it is the scan drain on CUDA with staging (the reference
    lights its drain for its fused-fire megasteps on an accelerator), else
    the split path with K-step megasteps (the reference's platform gate
    runs them on the CPU). ``on`` is the scan drain, ``while`` the
    while-drain on CUDA (on the CPU the scan drain unless
    ``pipeline.while-drain.cpu-override: on``), ``off`` the split path,
    with megasteps when K is above 1. A chained job has no single steps:
    ``auto`` takes its drain whenever staging exists, and its setup
    refuses a job without one. ``pipeline.data-parallel: on`` needs the
    resident loop (the reference's error) and then runs the sharded
    drain; ``auto`` runs it in a resident mode over more than one
    shard."""
    res_cfg = cfg.get_str("pipeline.resident-loop", "auto")
    ff_cfg = cfg.get_str("pipeline.fused-fire", "auto")
    if ff_cfg not in ("auto", "on", "off"):
        raise ValueError(
            f"pipeline.fused-fire must be auto|on|off, got {ff_cfg!r}")
    k_fuse = max(1, cfg.get_int("pipeline.steps-per-dispatch", 1))
    use_fused_fire = k_fuse > 1 and ff_cfg != "off"
    ring_depth = max(2, cfg.get_int("pipeline.ring-depth", 16))
    max_slots = cfg.get_int("pipeline.while-drain.max-slots", 0)
    if max_slots <= 0:
        max_slots = 2 * ring_depth
    max_slots = max(ring_depth, max_slots)
    cpu_override = cfg.get_str("pipeline.while-drain.cpu-override",
                               "off") == "on"
    prefetch_cfg = cfg.get_str("pipeline.prefetch", "auto")
    if prefetch_cfg not in ("auto", "on", "off"):
        raise ValueError(
            f"pipeline.prefetch must be auto|on|off, got {prefetch_cfg!r}")
    use_prefetch = prefetch_cfg != "off"
    # the applied-offset cut needs a source that can rewind to it: with
    # checkpoints, a non-replayable source polls inline (auto) or raises
    if can_snapshot and not sources_mod.replayable(source):
        if prefetch_cfg == "on":
            raise ValueError(
                "pipeline.prefetch=on with checkpointing/savepoints "
                "requires a replayable source (snapshot_offsets "
                "returning a position): this source cannot rewind to "
                "the applied-offset cut, so batches prefetched past a "
                "snapshot would be lost on restore")
        use_prefetch = False
    staging_cfg = cfg.get_str("pipeline.device-staging", "auto")
    if staging_cfg not in ("auto", "on", "off"):
        raise ValueError(
            f"pipeline.device-staging must be auto|on|off, "
            f"got {staging_cfg!r}")
    if staging_cfg == "on" and not use_prefetch:
        raise ValueError(
            "pipeline.device-staging=on requires pipeline.prefetch: "
            "the staging transfer-completion wait runs on the ingest "
            "thread and would otherwise block the step loop")
    use_staging = use_prefetch and staging_cfg != "off"
    use_while = False
    if res_cfg in ("on", "while"):
        if not use_staging:
            raise ValueError(
                f"pipeline.resident-loop={res_cfg} requires pipeline."
                "prefetch + pipeline.device-staging: the drain "
                "consumes device-staged batches published into the "
                "HBM ring by the ingest thread")
        use_resident = True
        use_while = res_cfg == "while" and not chained and (
            torch.device(device).type != "cpu" or cpu_override)
    else:
        use_resident = (res_cfg == "auto" and use_fused_fire and use_staging
                        and torch.device(device).type != "cpu")
        if chained and res_cfg == "auto":
            use_resident = use_staging
    dp_cfg = cfg.get_str("pipeline.data-parallel", "auto")
    if dp_cfg == "on":
        if not use_resident:
            raise ValueError(
                "pipeline.data-parallel=on requires the resident "
                "loop (pipeline.resident-loop + prefetch + device "
                "staging): the sharded drain consumes per-shard "
                "ring slices published by the ingest thread")
        use_dp = True
    else:
        use_dp = dp_cfg == "auto" and use_resident and n_shards > 1
    return _Dispatch(use_prefetch, use_staging, use_resident, use_while,
                     max_slots, k_fuse, use_fused_fire, use_dp)


def _check_config(cfg, red: wk.ReduceSpec) -> None:
    """The reference's window-stage knobs: validated as it validates them;
    those naming a path this slice lacks raise."""
    for key, allowed in (("pipeline.update-precombine", ("auto", "on", "off")),
                         ("state.packed-planes", ("auto", "on", "off")),
                         ("pipeline.resident-loop",
                          ("auto", "on", "while", "off"))):
        v = cfg.get_str(key, "auto")
        if v not in allowed:
            raise ValueError(f"{key} must be {'|'.join(allowed)}, got {v!r}")
    if not wk.packed_eligible(red) and cfg.get_str("state.packed-planes",
                                                   "auto") == "on":
        # the reference's check (executor.py:1756-1761); a generic reduce
        # or a sketch keeps split planes whatever the knob says otherwise
        raise ValueError(
            "state.packed-planes=on requires a builtin sum/count/min/max "
            "reduce with the default neutral and an at-most-1-D value; "
            "unset it for this stage")
    layout = cfg.get_str("state.backend.layout", "auto")
    if layout not in ("auto", "hash", "direct"):
        raise ValueError(
            f"state.backend.layout must be auto|hash|direct, got {layout!r}")
    dp_cfg = cfg.get_str("pipeline.data-parallel", "auto")
    if dp_cfg not in ("auto", "on", "off"):
        raise ValueError(
            f"pipeline.data-parallel must be auto|on|off, got {dp_cfg!r}")
    dp_capf = cfg.get_float("pipeline.shard-capacity-factor", 2.0)
    if dp_capf < 1.0:
        raise ValueError(
            f"pipeline.shard-capacity-factor must be >= 1.0, got {dp_capf}")
    mode = cfg.get_str("exchange.mode", "auto")
    if mode not in ("auto", "all_to_all", "mask"):
        raise ValueError(
            f"exchange.mode must be auto|all_to_all|mask, got {mode!r}")


class _WindowJob(StageJob):
    """State of one run: the window stage, its ring and the host cursors."""

    CAPACITY_HINT = (" (raise state.backend.device.slots-per-shard or the "
                     "pane ring, or set state.backend.strict-capacity to "
                     "false to tolerate drops)")
    states: Optional[List[wk.WindowShardState]] = None   # one a shard

    @property
    def state(self) -> Optional[wk.WindowShardState]:
        """The first shard's state (the only one at parallelism 1)."""
        return None if self.states is None else self.states[0]

    @state.setter
    def state(self, st) -> None:
        if st is None:
            self.states = None
        elif self.states is None:
            self.states = [st]
        else:
            self.states[0] = st

    def __init__(self, env, pipe: _Pipeline, metrics, restore_from=None):
        cfg = env.config
        super().__init__(env, pipe, metrics, pipe.window_agg)
        _check_config(cfg, self.red)
        assigner = pipe.window_agg.assigner
        self.size_ms, self.slide_ms = assigner.size_ms, assigner.slide_ms
        self.wm_strategy = (
            pipe.ts_transform.strategy if pipe.ts_transform is not None
            else WatermarkStrategy.for_monotonous_timestamps()
        )
        self.depth = max(2, cfg.get_int("pipeline.ring-depth", 16))
        self.lateness_ms = pipe.window_agg.allowed_lateness_ms
        # a chained stage graph (runtime/stages.py): the sinks take the
        # final stage's rows, with its reduce and result projection
        self.graph = pipe.graph
        if self.graph is not None:
            self.CAPACITY_HINT = (
                " (raise state.backend.device.slots-per-shard or the pane "
                "ring — for chained stage graphs also "
                "pipeline.stages.exchange-lanes — or set "
                "state.backend.strict-capacity to false to tolerate drops)")
        self.emit_red = (self.graph.plan_reduces()[-1] if self.graph
                         else self.red)
        self.result_fn = (self.graph.stages[-1].wagg if self.graph
                          else pipe.window_agg).result_fn
        self.chain_specs: List[WindowStageSpec] = []
        self.chain_states: List[wk.WindowShardState] = []
        self.chain_full = False      # a chained drain's stage filled F lanes
        self.flushing = False        # inside drain_chained
        # a chained flush that a drain's read called for while batches
        # were staged: (watermark ms, crossing stamp), run once the drain
        # over those batches is queued (the flush stages into the ring)
        self.flush_owed: Optional[Tuple[int, float]] = None
        # the flush's crossing stamp: the latency origin of its rounds
        self.flush_t: Optional[float] = None
        # the spill tier (executor.py:1857-1868): a reduce the host can
        # combine, float32 values of at most one dimension, allowed
        # lateness 0 (the host stores carry no freshness for a re-fire),
        # and no chained stages (strict capacity: a spilled stage-0 record
        # would have to replay through every downstream stage)
        self.spillable = (wk.overflow_supported(self.red)
                          and self.red.dtype == torch.float32
                          and len(self.red.value_shape) <= 1
                          and self.lateness_ms == 0
                          and self.graph is None)
        self.ovf_cfg = cfg.get_int("state.backend.overflow-ring", -1)
        if self.ovf_cfg > 0 and not self.spillable:
            raise ValueError(
                "state.backend.overflow-ring is set but this window stage "
                "cannot use the spill tier (requires a builtin float32 "
                "sum/count/min/max reduce without finalize and allowed "
                "lateness 0); unset it to run with strict capacity")
        self.has_ring = self.spillable and self.ovf_cfg != 0
        # tiered key-group state rides the spill tier: a cold lane takes
        # the overflow ring into the host stores (executor.py:1902-1914)
        self.tier_budget = cfg.get_int("state.tiers.resident-key-groups", 0)
        if self.tier_budget > 0 and not self.has_ring:
            raise ValueError(
                "state.tiers.resident-key-groups is set but this window "
                "stage cannot run tiered state (requires the spill tier: a "
                "builtin float32 sum/count/min/max reduce without finalize, "
                "allowed lateness 0, no chained stage graph, and a non-zero "
                "overflow ring); unset it to keep every key-group resident")
        self.tier_mgr: Optional[tiers_mod.TierManager] = None
        self.kg_res: Optional[torch.Tensor] = None   # the device mask
        # checkpoints (executor.py:2626-2640): a storage when the job has a
        # directory, numbered on from what the directory holds
        self.restore_from = restore_from
        self.storage = (ckpt.CheckpointStorage(
            env.checkpoint_dir, retain=cfg.get_int("checkpoint.retain", 2))
            if env.checkpoint_dir else None)
        self.next_cid = (self.storage.latest() or 0) + 1 \
            if self.storage is not None else 1
        self.steps_at_ckpt = 0
        self.n_keys_logged = 0       # reverse-map keys in the keymap log
        self.t_failed: Optional[float] = None   # a failure not yet drained
        # the reference's emit modes (executor.py:2104-2108, 5025-5035):
        # the drains reduce on the device only when every sink wants only
        # aggregates and the stage has no overflow ring (a spill merge needs
        # per-key rows); else rows — columnar when every sink takes
        # columns, else WindowResult rows
        self.sink_device_reduce = self.result_fn is None and all(
            getattr(s, "device_reduce", False) for s in pipe.sinks)
        self.reduced = self.sink_device_reduce and not self.has_ring
        self.maxp = env.max_parallelism
        self.td: Optional[TimeDomain] = None
        self.spec: Optional[WindowStageSpec] = None
        # the shard mesh (executor.py:1596-1598): n shards, each with its
        # key-group range and device, at most the devices visible
        devs = mesh_devices(self.device)
        self.n_shards = max(1, min(env.parallelism, len(devs)))
        self.ctx = MeshContext.create(self.n_shards, self.maxp,
                                      devices=devs)
        if self.n_shards > 1 and self.tier_budget > 0:
            raise _unsupported(
                f"tiered key-group state (state.tiers.*) at parallelism "
                f"{self.n_shards}", "ROADMAP queue 1, item 10")
        self.ex_mode = cfg.get_str("exchange.mode", "auto")
        self.ex_capf = cfg.get_float("exchange.capacity-factor", 2.0)
        self.dp_capf = cfg.get_float("pipeline.shard-capacity-factor", 2.0)
        self.B_step = self.B             # the step's lanes (setup)
        self.exchange_cap = 0            # the exchange's bucket lanes
        self.shard_cap = 0               # the sharded route's lanes a shard
        self.chunk_route = "mask"        # a general-path chunk's route
        # the dispatch modes (the reference's resolution): the split
        # path's update and fire steps, or a ring drain per group
        self.mode = _resolve_dispatch(
            cfg, self.graph is not None, self.storage is not None,
            pipe.source, self.device, self.n_shards)
        # the kernels by route ("mask", "exchange", "sharded") and tier
        # ("insert", "fast"): the split path's update steps, the K-step
        # megasteps, the ring drains; ``drain`` is the first drain (a
        # chained job's one), set in the resident modes
        self.steps: Dict[str, Dict[str, Any]] = {}
        self.drains: Dict[str, Dict[str, Any]] = {}
        self.drain = None
        self.fire_step = None
        self.fire_reduced_step = None
        self.fire_rows = None        # the fire steps' [Ft, C] row buffers
        self.empty_slot = None       # a chained flush round's batch
        # the K-step megasteps by route and tier: a single-stage job on
        # the split path with pipeline.steps-per-dispatch above 1
        self.mega: Optional[Dict[str, Dict[str, Any]]] = None
        self.fuse_depth = 1          # K of the last dispatch (1: singles)
        # the fused slot: a drain's slots of staged batches (the resident
        # modes, which fire in the drain), else K batches of one megastep
        if self.mode.resident:
            self.group = ingest_mod.FusedBatchAccumulator(
                self.mode.max_slots if self.mode.while_drain else self.depth,
                hold_fires=True)
        else:
            self.group = ingest_mod.FusedBatchAccumulator(
                self.mode.k_fuse, hold_fires=self.mode.fused_fire)
        self.pending_batch = None    # a greedy fill's leftover batch
        # a dispatch's unread fires: (fires, count, last wm, mon, latency
        # origin, recorder, kg batches, follow) — ``follow``: fire the
        # windows its last lanes may have left due when it is read (a
        # drain; a megastep's group settles that at its flush)
        self.pending = None
        self.applied_max_pane: Optional[int] = None
        self.host_fired_pane = -(2**62)   # newest pane the split path fired
        # the split path's pacing: events of the last max-inflight-steps
        # dispatches (CUDA), and the lagged monitoring samples
        self.max_inflight = cfg.get_int("pipeline.max-inflight-steps", 4)
        self.inflight: deque = deque()
        self.mon_watch: deque = deque()
        # the prep half: inline, or on the producer thread
        self.ingest = ingest_mod.IngestPipeline(
            self.prep_batch, prefetch=self.mode.prefetch,
            initial_offsets=sources_mod.snapshot_offsets(pipe.source),
            depth=cfg.get_int("pipeline.prefetch-depth", 2),
            ring_depth=cfg.get_int("pipeline.staging-ring-depth", 2))
        # the spill tier's host half: pane -> SpillStore of key -> value
        self.stores: Dict[int, SpillStore] = {}
        self.host_ufunc, self.host_neutral = HOST_REDUCE.get(
            self.red.kind, (None, None))
        self.ovf_w = max(1, int(np.prod(self.red.value_shape,
                                        dtype=np.int64)))
        # step tiering (executor.py:1796-1810, 4674-4722)
        self.step_mode = "insert"
        self.tier_quiet = 0          # consecutive drains that placed no key
        self.miss_tolerance = 0      # fast-step misses that keep it fast
        self.bounce_miss = 0         # misses that sent it back to insert
        self.bounce_placed = False   # did that insert period place a key
        # telemetry (executor.py:3672-3715): both flags default to the
        # tracing flag, which is off here (tracing raises)
        tracing = cfg.get_bool("observability.tracing", False)
        self.kg_stats = cfg.get_bool("observability.kg-stats", tracing)
        self.kg_interval_s = cfg.get_float(
            "observability.kg-stats-interval-ms", 1000.0) / 1e3
        self.drain_stats = cfg.get_bool("observability.drain-stats", tracing)
        self.drain_stats_every = max(1, cfg.get_int(
            "observability.drain-stats-every", 8))
        self.telem: Optional[DrainTelemetry] = None  # built in setup()
        self.kg_fill_total = np.zeros(self.maxp, np.int64)
        self.kg_fill_sampled = 0     # batches the fill counts cover
        self.kg_occ: Optional[np.ndarray] = None
        self.kg_last_refresh = 0.0
        self.mon_skip = 0            # batches since the last fill sample
        self.ds_skip = 0             # drains since the last payload read
        self.wm_dev = WM_SENTINEL    # the device watermark, in ticks
        env._kg_report = self.kg_report
        env._pipeline_report = self.pipeline_report
        env._doctor_report = self.doctor_report
        # the self-tuning controller (runtime/controller.py): built only
        # with controller.enabled, serviced at the poll-cycle cut
        self.controller = (self.build_controller()
                           if cfg.get(CoreOptions.CONTROLLER_ENABLED)
                           else None)
        env._controller_report = self.controller_report

    # -- setup on the first batch ------------------------------------------
    def resolve_layout(self, hi: np.ndarray, lo: np.ndarray) -> str:
        """``state.backend.layout``, with ``auto`` resolved on the first
        batch: direct only when its identities fit [0, C) and the spill
        tier can take later keys that do not (executor.py:1925-1936,
        5952-5965)."""
        layout = self.env.config.get_str("state.backend.layout", "auto")
        if layout != "auto":
            return layout
        fits = (int(hi.max(initial=0)) == 0
                and int(lo.max(initial=0)) < self.env.state_capacity_per_shard)
        return "direct" if fits and self.spillable else "hash"

    def setup(self, origin_ms: int, layout: str) -> None:
        env = self.env
        cfg = env.config
        ppw = self.size_ms // self.slide_ms
        ring_cfg = cfg.get_int("window.ring-panes", 0)
        if ring_cfg and ring_cfg < ppw + 3:
            raise ValueError(
                f"window.ring-panes={ring_cfg} leaves no catch-up headroom "
                f"for a {ppw}-pane window (need ring >= panes_per_window + 3 "
                f"= {ppw + 3}); raise it or unset it to use the auto-sized "
                f"ring")
        ring = ring_cfg or max(
            8, 2 * ppw + (self.wm_strategy.out_of_orderness_ms
                          + self.lateness_ms) // self.slide_ms + 2)
        # overflow ring (executor.py:1854-1900): unset (-1) = auto, sized to
        # absorb the full-batch overflow of the lagged detection window;
        # 0 = none; an explicit size wins
        ovf = 0
        if self.spillable:
            grp_k = self.depth
            stride = -(-MON_EVERY // grp_k) * grp_k
            auto = (stride * (OVF_LAG + 1) + 4 + grp_k) * self.B + 8192
            ovf = self.ovf_cfg if self.ovf_cfg >= 0 else auto
        capacity = env.state_capacity_per_shard
        win = wk.WindowSpec(
            size_ticks=self.size_ms, slide_ticks=self.slide_ms, ring=ring,
            fires_per_step=cfg.get_int("window.fires-per-step", 4),
            lateness_ticks=self.lateness_ms, overflow=ovf,
        )
        self.td = TimeDomain(origin_ms=origin_ms, ms_per_tick=1)
        self.spec = WindowStageSpec(
            win=win, red=self.red, capacity_per_shard=capacity,
            layout=layout, probe_len=cfg.get_int("state.probe-len", 16))
        self.states = init_sharded_state(self.ctx, self.spec)
        mode = self.mode
        build_fast = bool(ovf) and layout == "hash"
        if self.graph is not None:
            self.setup_chain(ovf, {"kg_fill": self.kg_stats,
                                   "drain_stats": self.drain_stats})
        else:
            self.setup_routes(build_fast)
        if self.tier_budget > 0:
            self.setup_tiers()
        # the prep side's plan (executor.py:2456-2490): re-installed by a
        # restore that moves the origin, with the producer paused
        sketch = self.red.kind == "sketch"
        win = self.spec.win
        routes = tuple(self.steps) + (("sharded",) if "sharded"
                                      in self.drains else ())
        self.ingest.set_plan(ingest_mod.IngestPlan(
            td=self.td, slide_ticks=win.slide_ticks,
            span_limit=win.ring - max(2, win.panes_per_window + 1),
            B=self.B, staging=mode.staging, device=self.device,
            value_shape=() if sketch else tuple(self.red.value_shape),
            value_dtype=np.uint32 if sketch else np.float32,
            ring_depth=self.depth if mode.resident else 0,
            B_step=self.B_step, n_shards=self.n_shards,
            max_parallelism=self.maxp, kg_ends=self.ctx.kg_bounds()[1],
            exchange_cap=self.exchange_cap, routes=routes,
            shard_cap=self.shard_cap, devices=self.ctx.devices))
        self.telem = None
        dr = self.ingest.device_ring
        if self.drain_stats and mode.resident and dr is not None:
            dr.stats_enabled = True
            # the flight recorder's host half (executor.py:2325-2350): a
            # lane a shard with the sharded ring, else one lane (its
            # absorb folds the shards' rows)
            self.telem = DrainTelemetry(
                self.n_shards if mode.data_parallel else 1, self.depth,
                key_groups=self.maxp if self.kg_stats else 0,
                kg_alpha=cfg.get_float("observability.kg-heat-alpha", 0.05),
                n_stages=1 + len(self.chain_specs),
                exchange_lanes=(cfg.get(
                    CoreOptions.PIPELINE_STAGES_EXCHANGE_LANES)
                    if self.graph is not None else 0))

    def setup_routes(self, build_fast: bool) -> None:
        """The kernels of each route and tier (the reference's
        executor.py:2013-2455): ``exchange.mode`` with more than one shard
        picks the routes — ``auto`` both the exchange and the mask route
        (each batch planned), ``all_to_all`` the exchange alone, ``mask``
        the mask alone — and pads the batch to a multiple of the shards;
        the split path's update steps and megasteps, or the resident
        modes' drains of each route (with ``pipeline.data-parallel`` also
        the sharded route's, over per-shard rings of
        ``shard-capacity-factor`` x B / n lanes); the fire steps serve
        every mode's watermark-only fires. A fast variant shares its
        insert variant's arenas; every drain of a shard shares one."""
        ctx, n, mode = self.ctx, self.n_shards, self.mode
        want_ex = n > 1 and self.ex_mode in ("auto", "all_to_all")
        self.B_step = -(-self.B // n) * n if want_ex else self.B
        self.metrics.exchange_mode = (
            "adaptive" if want_ex and self.ex_mode == "auto"
            else "all_to_all" if want_ex else "mask")
        routes = []
        if not want_ex or self.ex_mode == "auto":
            routes.append("mask")
        if want_ex:
            routes.append("exchange")
            self.exchange_cap = bucket_capacity(self.B_step // n, n,
                                                self.ex_capf)
        self.shard_cap = (bucket_capacity(self.B_step, n, self.dp_capf)
                          if mode.data_parallel else 0)
        kg_fill = self.kg_stats
        tiered = self.tier_budget > 0
        share = None
        for route in routes:
            cap = self.exchange_cap if route == "exchange" else 0
            if not mode.resident:
                self.steps[route] = {
                    tier: build_sharded_update_step(
                        ctx, self.spec, route, insert=tier == "insert",
                        kg_fill=kg_fill, cap=cap)
                    if tier == "insert" or build_fast else None
                    for tier in ("insert", "fast")}
                if mode.k_fuse > 1:
                    if self.mega is None:
                        self.mega = {}
                    tiers = {}
                    for tier in ("insert", "fast"):
                        if tier == "fast" and not build_fast:
                            tiers[tier] = None
                            continue
                        tiers[tier] = build_sharded_megastep(
                            ctx, self.spec, mode.k_fuse, route,
                            insert=tier == "insert", kg_fill=kg_fill,
                            fused_fire=mode.fused_fire,
                            reduced=self.reduced, cap=cap, share=share,
                            tiered=tiered)
                        if mode.fused_fire and share is None:
                            share = tiers[tier]
                    self.mega[route] = tiers
            else:
                # the single steps' route table, for the plan (a drain
                # job's general path drains its chunks one slot each)
                self.steps[route] = {"insert": None, "fast": None}
        if mode.resident:
            depth = mode.max_slots if mode.while_drain else self.depth
            for route in routes + (["sharded"] if mode.data_parallel
                                   else []):
                cap = self.exchange_cap if route == "exchange" else 0
                tiers = {}
                for tier in ("insert", "fast"):
                    if tier == "fast" and not build_fast:
                        tiers[tier] = None
                        continue
                    tiers[tier] = build_sharded_drain(
                        ctx, self.spec, depth, route,
                        insert=tier == "insert", kg_fill=kg_fill,
                        reduced=self.reduced, while_drain=mode.while_drain,
                        cap=cap, share=share, drain_stats=self.drain_stats)
                    if share is None:
                        share = tiers[tier]
                self.drains[route] = tiers
            self.drain = self.drains[routes[0]]["insert"]
        self.fire_step = build_sharded_fire_step(ctx, self.spec,
                                                 out=self.fire_row_views)
        if self.sink_device_reduce:
            self.fire_reduced_step = build_sharded_fire_step(
                ctx, self.spec, reduced=True)


    def setup_tiers(self) -> None:
        """The tier manager (executor.py:1947-1986): made once, re-sliced
        by a restore so that its counters span the job; residency starts
        at the first ``budget`` key groups. Its mask goes to the device
        and its four gauges to ``env._gauges``."""
        cfg = self.env.config
        if self.tier_mgr is None:
            self.tier_mgr = tiers_mod.TierManager(
                self.maxp, [0], [self.maxp - 1], self.tier_budget,
                prefetch_ahead_panes=cfg.get(
                    CoreOptions.STATE_TIERS_PREFETCH_AHEAD_PANES),
                min_dwell_cycles=cfg.get(
                    CoreOptions.STATE_TIERS_MIN_DWELL_CYCLES),
                max_swaps_per_cycle=cfg.get(
                    CoreOptions.STATE_TIERS_MAX_SWAPS_PER_CYCLE))
        else:
            self.tier_mgr.rescale([0], [self.maxp - 1])
        self.kg_res = torch.from_numpy(self.tier_mgr.mask()).to(self.device)
        tm = self.tier_mgr
        self.env._gauges.update({
            "tier_resident_groups": tm.resident_groups,
            "tier_faults": lambda: tm.tier_faults,
            "tier_prefetch_hits": lambda: tm.prefetch_hits,
            "tier_prefetch_misses": lambda: tm.prefetch_misses,
        })

    def setup_chain(self, ovf: int, tel: dict) -> None:
        """Plan the downstream stages off stage 0's spec, refuse the
        runtime shapes the chained drain cannot serve (the reference's
        executor.py:1994-2010, 2032-2040) and build the chained drain, the
        job's only dispatch: there is no fast variant (strict capacity)
        and no watermark-only fire (a fire outside the drain would consume
        stage-0 fires without feeding stage 1)."""
        cfg = self.env.config
        graph = self.graph
        self.chain_specs = graph.plan_specs(self.spec,
                                            drain_depth=self.depth)
        graph.check_runtime(
            use_resident=self.mode.resident, overflow_lanes=ovf,
            drain_stats=self.drain_stats,
            reduced_fires=self.sink_device_reduce,
            max_stages=cfg.get(CoreOptions.PIPELINE_STAGES_MAX_STAGES))
        if cfg.get_str("exchange.mode", "auto") == "all_to_all":
            raise StageGraphError(
                "exchange.mode=all_to_all is not supported with chained "
                "stage graphs — the identity re-key keeps fires "
                "shard-local, so the chained drain runs the "
                "replicate-and-mask route; unset exchange.mode")
        # each shard's downstream stages, on its device
        self.chain_states = [[init_shard_state(cs, self.maxp, d)
                              for cs in self.chain_specs]
                             for d in self.ctx.devices]
        # the mask route's chained drain and, with pipeline.data-parallel,
        # the sharded route's over per-shard rings (executor.py:2144-2185)
        routes = ["mask"]
        if self.mode.data_parallel:
            routes.append("sharded")
            self.shard_cap = bucket_capacity(self.B_step, self.n_shards,
                                             self.dp_capf)
        self.steps["mask"] = {"insert": None, "fast": None}
        specs = (self.spec,) + tuple(self.chain_specs)
        for route in routes:
            self.drains[route] = {"insert": build_sharded_chained_drain(
                self.ctx, specs, self.depth, route, exchange_lanes=cfg.get(
                    CoreOptions.PIPELINE_STAGES_EXCHANGE_LANES), **tel),
                "fast": None}
        self.drain = self.drains["mask"]["insert"]
        # a flush round's batch: B lanes, none valid (read only)
        v_dtype, v_shape = self.value_layout()
        self.empty_slot = ingest_mod.stage_fresh(
            self.device, self.B, np.zeros(0, np.uint32),
            np.zeros(0, np.uint32), np.zeros(0, np.int32),
            np.zeros((0,) + v_shape, v_dtype), 0, v_dtype, v_shape)

    def wm_ticks(self, wm_ms: Optional[int]) -> int:
        """A watermark in ticks; None (a chunk that carries none) is the
        MIN sentinel, which advances nothing."""
        if wm_ms is None:
            return WM_SENTINEL
        return min(int(self.td.to_ticks(wm_ms)), 2**31 - 4)

    def wm_pane_of(self, wm_ms: int) -> int:
        """The newest pane a watermark closes (executor.py:5434-5437)."""
        slide = self.spec.win.slide_ticks
        b = max(self.wm_ticks(wm_ms), -(2**31) + 1 + slide)
        return (b + 1 - slide) // slide

    def to_device_i32(self, values) -> torch.Tensor:
        """A small int32 tensor (a watermark, a drain's watermarks) on the
        device without a host sync: pinned, copied on the current stream
        (the caching host allocator keeps the block until the copy ran)."""
        t = torch.tensor(values, dtype=torch.int32)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def fire_row_views(self, s: int = 0):
        """Shard ``s``'s fire-step [Ft, C] row buffers: its arena's slot 0
        when a compact drain or fused-fire megastep made one (every drain
        and megastep of the shard shares it, and its rows were read by
        then), else the shard's own, made at first use."""
        owner = self.drain
        if owner is None and self.mega:
            owner = next(iter(self.mega.values()))["insert"]
        shards = getattr(owner, "shards", None)
        arena_rows = getattr(shards[s], "arena_rows", None) if shards \
            else None
        rows = arena_rows(0) if arena_rows is not None else None
        if rows is not None:
            return rows
        if self.fire_rows is None:
            self.fire_rows = [None] * self.n_shards
        if self.fire_rows[s] is None:
            self.fire_rows[s] = wk.fire_row_buffers(
                self.spec.win.fire_lanes, self.spec.capacity_per_shard,
                self.ctx.devices[s], red=self.red)
        return self.fire_rows[s]

    # -- the prep half (the producer thread, or inline) --------------------
    def prep_batch(self) -> ingest_mod.PreppedBatch:
        """The front half of a cycle (the reference's prep_batch,
        executor.py:5439-5520): poll with the post-poll offsets, encode
        keys and values, take the event times. Pure host numpy that reads
        nothing the step loop mutates, so the producer runs it ahead."""
        polled, end, offsets = sources_mod.poll_with_offsets(
            self.pipe.source, self.B)
        cols, ts_ms = split_poll(polled)
        hi = lo = values = None
        n = 0
        if batch_len(cols):
            _keys, hi, lo, values = self.encode(cols, count=False)
            n = len(hi)
            ts_ms = self.event_ts(cols, ts_ms)
        return ingest_mod.PreppedBatch(
            end=end, n=n, offsets=offsets,
            hi=hi, lo=lo, values=values, ts_ms=ts_ms if n else None)

    # -- the step loop -----------------------------------------------------
    def run(self) -> None:
        """Restore from ``restore_from`` when given, then the poll loop and
        the end-of-stream flush inside the restart strategy's protection
        (executor.py:6336-6373): a failure anywhere in them — the producer
        thread's included — restores the newest checkpoint of the job's
        own directory and replays from its cut."""
        try:
            if self.restore_from is not None:
                self.restore(self.restore_from)
            restart = ckpt.restart_strategy(self.env.config)
            while True:
                try:
                    end = False
                    while not end:
                        end = self.poll_cycle()
                    self.end_of_stream()
                    return
                except Exception as exc:
                    self.recover(exc, restart)
        finally:
            self.ingest.close()

    def recover(self, exc: Exception, restart) -> None:
        """One failure -> a restored, runnable job, or ``exc`` raised: with
        no checkpoint to restart from, or when the strategy declines. A
        failure during the restore takes another of the strategy's
        attempts (executor.py:6275-6334)."""
        t_fail = time.perf_counter()
        while True:
            if self.storage is None or self.storage.latest() is None \
                    or not restart.should_restart():
                raise exc
            self.metrics.restarts += 1
            try:
                self.restore(self.storage)
                break
            except Exception as e2:
                exc = e2
        self.t_failed = t_fail

    def poll_cycle(self) -> bool:
        """One cycle (the reference's poll_cycle, executor.py:5884-6048):
        the tier cut, the next prepped batch, its apply, the applied cut
        and the checkpoint trigger. Returns whether the stream ended."""
        self.cycle_start()
        if self.pending_batch is not None:
            pb, self.pending_batch = self.pending_batch, None
        else:
            pb = self.ingest.next()
        self.metrics.records_in += pb.n
        deferred = False
        if pb.n:
            if self.td is None:
                self.setup((int(np.min(pb.ts_ms)) // self.size_ms)
                           * self.size_ms, self.resolve_layout(pb.hi, pb.lo))
            if pb.route is not None:
                deferred = self.apply_planned(pb)
                # a drain group takes every batch the queue already holds
                while self.drain is not None and deferred:
                    nxt = self.ingest.try_next()
                    if nxt is None:
                        break
                    if nxt.n and nxt.route is not None and not nxt.end:
                        self.metrics.records_in += nxt.n
                        if not self.apply_planned(nxt):
                            self.ingest.mark_applied(nxt)
                            break
                    else:
                        self.pending_batch = nxt
                        break
            else:
                self.apply_general(pb)
        elif self.td is not None:
            # an idle poll: dispatch what the group holds (its batches
            # precede this poll's offsets) and read the pending fires
            self.dispatch()
            self.consume()
        if pb.end:
            self.dispatch()
            self.consume()
            deferred = False
        if not deferred:
            self.ingest.mark_applied(pb)
        self.cycle_end()
        return pb.end

    def cycle_start(self) -> None:
        # tiered state's maintenance at the cycle's cut, between drains
        if self.tier_mgr is not None and self.td is not None:
            self.tier_maintenance()
        # the controller's seam (executor.py:5911-5916): at most one knob
        # move an interval, between dispatches
        if self.controller is not None and self.td is not None:
            self.controller.service()

    def cycle_end(self) -> None:
        interval = self.env.checkpoint_interval_steps
        if self.storage is not None and interval > 0 and self.td is not None \
                and self.metrics.steps - self.steps_at_ckpt >= interval:
            self.write_checkpoint()

    def end_of_stream(self) -> None:
        if self.td is None:
            return
        self.dispatch()
        self.consume()
        # end of stream: MAX watermark flush (ref Watermark.MAX_WATERMARK;
        # a chained job's goes through empty chained drains)
        self.fire_until_done(int(self.td.to_ms(MAX_TS - 2)),
                             time.perf_counter())

    def time_jump(self, g_wm: int, t_min: int, t_max: int) -> None:
        """A jump of 2+ panes past everything applied would rotate the ring
        over unfired panes: fire their windows first, at most up to the
        group's first pane (executor.py:5828-5840, 6134-6175)."""
        slide = self.spec.win.slide_ticks
        g_max_pane = t_max // slide
        if self.applied_max_pane is not None \
                and g_max_pane - self.applied_max_pane >= 2:
            self.dispatch()
            self.fire_until_done(
                min(g_wm, int(self.td.to_ms((t_min // slide) * slide)) - 1),
                time.perf_counter())
        self.applied_max_pane = (
            g_max_pane if self.applied_max_pane is None
            else max(self.applied_max_pane, g_max_pane))

    def apply_planned(self, pb) -> bool:
        """Apply one planned batch of one pane group (the reference's
        _apply_planned, executor.py:5808-5882): the watermark, the time
        jump guard, then into the drain group (resident modes: it fires
        in the drain), into the megastep group (K above 1: flushed when
        full, on a route or staging change and, without fused fire, at a
        fire boundary, whose fire steps then run), or one update step and,
        when the watermark crossed a pane, the fire steps (the split
        path). Returns True while the batch waits in the group (its
        offsets are not applied yet)."""
        wm_ms = self.wm_strategy.on_batch(pb.ts_max)
        self.time_jump(wm_ms, pb.ticks_min, pb.ticks_max)
        staged = pb.staged
        if staged is None:
            # staging off: the step loop copies the batch
            staged = ingest_mod.stage_fresh(
                self.device, self.B_step, pb.hi, pb.lo, pb.ticks, pb.values,
                pb.n, *self.value_layout())
        if self.drain is not None:
            # a drain serves one route: another route's batch waits for
            # the group's dispatch
            if not self.group.compatible(pb.route, True):
                self.dispatch()
            self.group.push(staged, wm_ms, pb, pb.route)
            self.metrics.steps += 1
            # with lateness every batch fires eagerly (the next batch's
            # update must see the re-fires of this one), so it drains alone
            if self.group.full() or self.lateness_ms:
                self.dispatch()
                return False
            return True
        wp = self.wm_pane_of(wm_ms)
        fire_now = bool(self.lateness_ms) or wp > self.host_fired_pane
        deferred = False
        if self.mega is not None:
            # a fused-fire group holds across crossings: its flush fires
            # them (fused_fire_bookkeep)
            in_scan = self.group.hold_fires
            staged_mode = pb.staged is not None
            if not self.group.compatible(pb.route, staged_mode):
                self.dispatch()
            self.group.push(staged, wm_ms, pb, pb.route, staged_mode)
            if self.group.full() or (fire_now and not in_scan):
                self.dispatch()
            else:
                deferred = True
            fire_now = fire_now and not in_scan
        else:
            self.run_update(staged, wm_ms, pb)
        if fire_now:
            self.fire_until_done(wm_ms, time.perf_counter())
            self.host_fired_pane = wp
        return deferred

    def value_layout(self):
        """The staged values column: (numpy dtype, per-lane shape)."""
        if self.red.kind == "sketch":
            return np.uint32, ()
        return np.float32, tuple(self.red.value_shape)

    def apply_general(self, pb) -> None:
        """The general path (the reference's _apply_general, executor.py:
        6050-6204): an unplanned batch — the first, one prepped before the
        plan, a catch-up span — after what the group holds. A batch that
        spans more panes than the ring holds is cut into pane groups that
        fire between them; each chunk of B lanes is one update step (a
        1-slot drain in a drain job, where the reference takes its single
        step), the watermark riding the last."""
        self.dispatch()
        hi, lo, values, ts_ms = pb.hi, pb.lo, pb.values, pb.ts_ms
        n = pb.n
        ticks = self.td.to_ticks(ts_ms)
        wm_ms = self.wm_strategy.on_batch(int(ts_ms.max()))
        win = self.spec.win
        panes = ticks // np.int32(win.slide_ticks)
        span_limit = win.ring - max(2, win.panes_per_window + 1)
        if int(panes.max()) - int(panes.min()) >= span_limit:
            order = np.argsort(panes, kind="stable")
            sorted_panes = panes[order]
            groups, i = [], 0
            while i < n:
                j = int(np.searchsorted(sorted_panes,
                                        sorted_panes[i] + span_limit, "left"))
                groups.append(order[i:j])
                i = j
        else:
            groups = [None]
        catch_up = groups[0] is not None
        ooo = self.wm_strategy.out_of_orderness_ms
        v_layout = self.value_layout()
        for sel in groups:
            if sel is None:
                g = (hi, lo, ticks, values)
                g_wm = wm_ms
            else:
                g = (hi[sel], lo[sel], ticks[sel], values[sel])
                # group-local watermark: later groups' records must not
                # be late against their own poll's final watermark
                g_wm = min(int(self.td.to_ms(int(g[2].max()))) - ooo - 1,
                           wm_ms)
            self.time_jump(g_wm, int(g[2].min()), int(g[2].max()))
            m = len(g[0])
            for off in range(0, m, self.B):
                end = min(off + self.B, m)
                chunk = [a[off:end] for a in g]
                staged = ingest_mod.stage_fresh(
                    self.device, self.B_step, *chunk, end - off, *v_layout)
                wm_chunk = g_wm if end == m else None
                route = self.pick_route(chunk[0], chunk[1])
                if self.drain is not None:
                    # a drain job's chunk is a 1-slot drain: a stage chain
                    # has no single step, and the flight recorder sees
                    # every batch
                    self.group.push(staged, wm_chunk, None, route)
                    self.metrics.steps += 1
                    self.dispatch()
                else:
                    self.chunk_route = route
                    self.run_update(staged, wm_chunk, None)
            if catch_up:
                self.fire_until_done(g_wm, time.perf_counter())
        wp = self.wm_pane_of(wm_ms)
        if self.lateness_ms or wp > self.host_fired_pane:
            self.fire_until_done(wm_ms, time.perf_counter())
            self.host_fired_pane = wp

    def pick_route(self, hi: np.ndarray, lo: np.ndarray) -> str:
        """The route of a batch the plan did not route (the reference's
        ``_pick_route``, executor.py:3960): the plan's one feasibility
        check on its host arrays."""
        plan = self.ingest.plan
        if plan is None or self.n_shards == 1:
            return "mask"
        return ingest_mod.plan_route(plan, hi, lo)

    def note_dispatch(self, t_disp: float) -> None:
        """The first dispatch after a restore ends its recovery."""
        if self.t_failed is not None:
            if self.metrics.recovery_ms is None:
                self.metrics.recovery_ms = []
            self.metrics.recovery_ms.append((t_disp - self.t_failed) * 1e3)
            self.t_failed = None

    # -- the split path ----------------------------------------------------
    def run_update(self, staged, wm_ms: Optional[int], pb) -> None:
        """Dispatch one update step (the reference's run_update,
        executor.py:3981-4091): nothing is read back; on CUDA the loop
        waits on the event of the step ``pipeline.max-inflight-steps``
        back, never on the whole device. Every MON_EVERY-th step's
        (fill, activity, key-group fill) is kept for a lagged read."""
        # a drain's pending fires (and the fires they call for) precede
        # this update, as they precede the next drain's
        self.consume()
        slot = (ingest_mod.adopt(pb) if pb is not None
                and pb.staged is not None else staged)
        # a planned batch carries its route; a general-path chunk's was
        # planned by apply_general
        route = pb.route if pb is not None else self.chunk_route
        wm = self.to_device_i32(self.wm_ticks(wm_ms))
        tiers = self.steps[route]
        fast = self.step_mode == "fast" and tiers["fast"] is not None
        step = tiers["fast" if fast else "insert"]
        _states, mon = step(self.states, slot, wm, kg_res=self.kg_res)
        self.note_dispatch(time.perf_counter())
        self.pace()
        if wm_ms is not None:
            self.wm_dev = max(self.wm_dev, self.wm_ticks(wm_ms))
        self.metrics.steps += 1
        if fast:
            self.metrics.steps_fast += 1
        if route == "exchange":
            self.metrics.steps_exchanged += 1
        if self.spec.win.overflow or self.kg_stats:
            self.mon_skip += 1
            if self.mon_skip >= MON_EVERY:
                self.mon_skip = 0
                self.mon_watch.append(mon + (1,))
                self.check_overflow_pressure()

    def pace(self) -> None:
        """On CUDA, wait on the event of the dispatch
        ``pipeline.max-inflight-steps`` back, never on the whole device."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self.inflight.append(ev)
            if len(self.inflight) > self.max_inflight:
                self.inflight.popleft().synchronize()

    def check_overflow_pressure(self) -> None:
        """Read the monitoring sample OVF_LAG samples back (the reference's
        check_overflow_pressure, executor.py:4674-4720): its key-group
        fill into the telemetry, its activity into the step tiering, and
        a ring fuller than B / 8 drained into the spill stores now."""
        if len(self.mon_watch) <= OVF_LAG:
            return
        ovf_n, act, kgf, n_batches = self.mon_watch.popleft()
        S = self.n_shards
        small = torch.cat([ovf_n.reshape(S), act.reshape(1),
                           kgf.reshape(-1)]).cpu().numpy().astype(np.int64)
        if kgf.numel():
            self.absorb_kg(small[S + 1:], n_batches)
        if self.has_fast:
            self.tier(int(small[S]))
        if int(small[:S].max()) > max(1, self.B // 8):
            self.drain_overflow()

    def drain_overflow(self) -> None:
        """The ring into the spill stores, then a hash table's compaction
        (the reference's drain_overflow); the queued fill samples go
        stale, their key-group counts are kept. A fused-fire megastep's
        unread fires are emitted first: their per-sub-step fills index
        the ring as it stands."""
        self.consume()
        fills = self.ring_fills()
        if not fills.any():
            return
        for s, n in enumerate(fills):
            if n:
                self.fold_ring(*self.read_ring(int(n), s))
        while self.mon_watch:
            _, _, kgf, n_batches = self.mon_watch.popleft()
            if kgf.numel():
                self.absorb_kg(kgf.cpu().numpy().astype(np.int64),
                               n_batches)
        self.after_ring_drain()

    # -- megasteps ---------------------------------------------------------
    def flush_fused(self) -> None:
        """Dispatch what the megastep group holds (the reference's
        flush_fused, executor.py:4445-4550): a full group as one megastep,
        a partial one as single update steps, then mark the last batch's
        offsets applied — the megastep-boundary cut. A fused-fire group
        also settles its crossings here (``fused_fire_bookkeep``)."""
        route, _staged, items = self.group.drain()
        full = len(items) == self.mode.k_fuse
        if full:
            self.run_update_fused(items, route)
        else:
            for args, wm_ms, pb in items:
                self.run_update(args, wm_ms, pb)
            self.fuse_depth = 1
        last_pb = items[-1][2]
        if last_pb is not None:
            self.ingest.mark_applied(last_pb)
        if self.group.hold_fires:
            self.fused_fire_bookkeep(items, full)

    def run_update_fused(self, items, route: str = "mask") -> None:
        """Dispatch one K-step megastep over a full group (the reference's
        run_update_fused, executor.py:4136-4226), on the fast tier when
        the tiering chose it; the sub-steps' watermarks go to the card as
        one pinned [K] copy. A fused-fire megastep's fires wait in
        ``pending`` and are read before the next dispatch (its arena is
        reused), with its ring fills, so the spill tier folds each
        sub-step's share of the ring before that sub-step's fires. The
        monitoring sample has the single step's shapes, ``mon_skip``
        advances by K and its key-group fill counts K batches."""
        self.consume()
        K = len(items)
        tiers = self.mega[route]
        fast = self.step_mode == "fast" and tiers["fast"] is not None
        step = tiers["fast" if fast else "insert"]
        slots = [ingest_mod.adopt(pb) if pb is not None
                 and pb.staged is not None else args
                 for args, _wm, pb in items]
        wms = [self.wm_ticks(w) for _a, w, _pb in items]
        wmv = self.to_device_i32(wms)
        # the device-loss seam of a dispatch, as the reference's
        faults.inject("step.dispatch", step=self.metrics.steps, k=K)
        out = step(self.states, slots, wmv, self.kg_res)
        t_disp = time.perf_counter()
        self.note_dispatch(t_disp)
        mon = out[1]
        m = self.metrics
        if route == "exchange":
            m.steps_exchanged += K
        if step.fused_fire:
            self.pending = (out[2], K, max(w for _a, w, _pb in items), mon,
                            t_disp, None, 0, False)
            m.fused_fire_dispatches += 1
            # the ring fills after the last sub-step, one a shard
            mon = (mon[0][:, -1],) + mon[1:]
        self.pace()
        self.wm_dev = max([self.wm_dev] + wms)
        m.steps += K
        m.fused_dispatches += 1
        self.fuse_depth = K
        if fast:
            m.steps_fast += K
        if self.spec.win.overflow or self.kg_stats:
            self.mon_skip += K
            if self.mon_skip >= MON_EVERY:
                self.mon_skip = 0
                self.mon_watch.append(mon + (K,))
                self.check_overflow_pressure()

    def fused_fire_bookkeep(self, items, fired_in_scan: bool) -> None:
        """The crossings of a fused-fire flush (the reference's
        _fused_fire_bookkeep, executor.py:4552-4600): a full group fired
        up to F lanes a sub-step inside the megastep, leftovers rolling to
        the next sub-step; the host models that lane budget (each crossing
        adds its panes, at most the ring plus a window's panes, and each
        fired sub-step retires F) and runs the fire steps when the model
        leaves a backlog, when a partial group ran as single steps over a
        crossing, or, with allowed lateness, after every group (its
        re-fires depend on the data). It also brings ``host_fired_pane``
        up to the group's last watermark."""
        win = self.spec.win
        cap = win.ring + win.size_ticks // win.slide_ticks
        backlog = 0
        prev = self.host_fired_pane
        last_wm = None
        crossed = False
        for _args, wm_ms, _pb in items:
            if wm_ms is None:
                continue
            last_wm = wm_ms
            wp = self.wm_pane_of(wm_ms)
            if wp > prev:
                crossed = True
                backlog += min(wp - prev, cap)
                prev = wp
            if fired_in_scan:
                backlog = max(0, backlog - win.fires_per_step)
        if last_wm is None:
            return
        self.host_fired_pane = max(self.host_fired_pane, prev)
        eager = bool(self.lateness_ms)
        if backlog > 0 or (not fired_in_scan and (crossed or eager)) \
                or (eager and fired_in_scan):
            self.fire_until_done(last_wm, time.perf_counter())

    # -- drains and fires --------------------------------------------------
    def dispatch(self) -> None:
        """Dispatch what the fused slot holds: a megastep group through
        ``flush_fused``, else one ring drain over the drain group (the
        reference's run_update_resident, executor.py:4223-4443), on the
        fast step when the tiering chose it, then release the ring slots
        it read and mark its last batch applied. The previous drain's
        fires are read first: they may call for watermark-only fires that
        must precede this drain's updates, and they settle the tier. A
        chained job's flush they call for runs once this drain is
        queued."""
        if not len(self.group):
            return
        if self.drain is None:
            return self.flush_fused()
        self.consume()
        route, _staged, items = self.group.drain()
        count = len(items)
        n = self.n_shards
        sharded = route == "sharded"
        if sharded:
            # each shard's slices of the group, from its own ring
            slots = [[ingest_mod.adopt_shard(pb, s) for _a, _w, pb in items]
                     for s in range(n)]
        else:
            slots = [ingest_mod.adopt(pb) if pb is not None
                     and pb.staged is not None else args
                     for args, _wm, pb in items]
        tiers = self.drains[route]
        fast = self.step_mode == "fast" and tiers["fast"] is not None
        drain = tiers["fast" if fast else "insert"]
        depth = drain.ring_depth
        wms = [self.wm_ticks(w) for _a, w, _pb in items]
        wmv = self.to_device_i32(wms + [WM_SENTINEL] * (depth - count))
        # the mid-drain crash seam of the exactly-once tests
        faults.inject("step.drain", step=self.metrics.steps, slots=count)
        ringed = [pb for _a, _w, pb in items
                  if pb is not None and pb.ring is not None]
        ring = ringed[0].ring if ringed else None
        ds = None
        counts = [count] * n if sharded else count
        if self.graph is not None:
            # one dispatch advances every stage of every shard; the sinks
            # take the final stages' fires, and mon each shard's fill after
            # the drain and, for the flush decision, every stage's last
            # advance's fire lanes
            out = drain([(st,) + tuple(cs) for st, cs in
                         zip(self.states, self.chain_states)], slots, wmv,
                        counts)
            states, mon, fires = out[:3]
            for s, st in enumerate(states):
                self.states[s], self.chain_states[s] = st[0], list(st[1:])
            mon = (mon[0][:, -1:], mon[1], mon[2], drain.stage_lanes)
            if self.drain_stats:
                ds = out[3]
        else:
            if drain.while_drain:
                # the loop bound re-reads the ring's write cursor; base
                # makes cursor - base this group's fill at dispatch
                # (executor.py:4322-4362), so the drain retires exactly
                # the staged slots — each shard's own ring's on the
                # sharded route
                if sharded:
                    cursors = [r.write_cursor for r in ring.rings]
                elif ring is not None:
                    cursors = [ring.write_cursor] * n
                else:
                    cursors = [count] * n
                bases = [(c() if callable(c) else c) - count
                         for c in cursors]
                out = drain(self.states, slots, wmv, counts, cursors, bases,
                            kg_res=self.kg_res)
            else:
                out = drain(self.states, slots, wmv, counts,
                            kg_res=self.kg_res)
            mon, fires = out[1], out[2]
            if self.drain_stats:
                # every shard's recorder, [n, D, 9] on the first device
                dev0 = self.ctx.devices[0]
                ds = torch.stack([d.to(dev0) for d in out[-1]])
        t_disp = time.perf_counter()
        self.note_dispatch(t_disp)
        last_wm = max((w for _a, w, _pb in items if w is not None),
                      default=None)
        released = None        # each ring lane's released-through seq
        if sharded:
            seqs = [[pb.ring_seqs[s] for pb in ringed
                     if pb.ring_seqs[s] is not None] for s in range(n)]
            ring.note_read(seqs)
            released = [max(q) if q else None for q in seqs]
            ring.release_shards(released)
        elif ring is not None:
            ring.note_read([pb.ring_seq for pb in ringed])
            released = [max(pb.ring_seq for pb in ringed)]
            ring.release_through(released[0])
        last_pb = items[-1][2]
        if last_pb is not None:
            self.ingest.mark_applied(last_pb)
        self.wm_dev = max([self.wm_dev] + wms)
        wp = None if last_wm is None else self.wm_pane_of(last_wm)
        if wp is not None:
            self.host_fired_pane = max(self.host_fired_pane, wp)
        # the sampled reads ride this drain's one read (executor.py:4400-
        # 4445): the key-group fill every MON_EVERY batches, the flight
        # recorder every drain-stats-every drains
        kg_batches = 0
        if self.kg_stats:
            self.mon_skip += count
            if self.mon_skip >= MON_EVERY:
                self.mon_skip = 0
                kg_batches = count
        if self.drain_stats:
            self.ds_skip += 1
            if self.ds_skip >= self.drain_stats_every:
                self.ds_skip = 0
            else:
                ds = None
        # the fires' latency origin: the dispatch, or within a chained
        # flush the watermark crossing that called for it
        t_lat = t_disp if self.flush_t is None else self.flush_t
        self.pending = (fires, count,
                        last_wm if last_wm is not None else self.wm_dev_ms(),
                        mon, t_lat, ds, kg_batches, True)
        self.metrics.resident_drains += 1
        if fast:
            self.metrics.steps_fast += count
        if route == "exchange":
            self.metrics.steps_exchanged += count
        elif sharded:
            self.metrics.steps_sharded += count
        if self.telem is not None:
            if ring is not None:
                self.telem.ingest_publish(ring.publish_samples())
            fills = ring.occupancy_shards() if ring is not None else [0]
            self.telem.on_drain([count] * len(fills), fills,
                                released or [None] * len(fills), t_disp)
        if self.flush_owed is not None:
            wm, t_cross = self.flush_owed
            self.flush_owed = None
            self.drain_chained(max(wm, self.pending[2]), t_cross)

    def wm_dev_ms(self) -> int:
        """The device watermark in ms (a drain whose chunks carried none)."""
        return int(self.td.to_ms(self.wm_dev))

    def consume(self) -> None:
        """Read the last drain's fires, ring fills and activity (the one
        host sync per drain), settle the step tier, emit the fires with the
        ring's records folded in, and fire any window-ends its F lanes left
        due."""
        if self.pending is None:
            return
        fires, count, last_wm, mon, t_lat, ds, kg_batches, follow = \
            self.pending
        self.pending = None
        fires_before = self.metrics.fires
        lanes = self.emit(fires, mon, ds, kg_batches)
        n = self.metrics.fires - fires_before
        if n:
            # a drain's fires: from its dispatch (or its flush's crossing)
            # to their emission
            self.metrics.record_fire_latency(
                n, (time.perf_counter() - t_lat) * 1e3)
        # with lateness the reference fires eagerly after every drain
        if self.graph is not None:
            if self.chain_full and not self.flushing:
                if len(self.group):
                    # called by dispatch before it queues the grouped
                    # batches: the flush must follow their drain
                    self.flush_owed = (last_wm, time.perf_counter())
                else:
                    self.drain_chained(last_wm, time.perf_counter())
        elif follow and (self.lateness_ms
                         or self.lanes_full(lanes[:, count - 1])):
            self.fire_until_done(last_wm, time.perf_counter())

    def lanes_full(self, lanes) -> bool:
        """Did an advance fill all F on-time lanes, or all F re-fire lanes,
        on any shard (backlog may remain)?"""
        F = self.spec.win.fires_per_step
        lanes = lanes.reshape(-1, self.spec.win.fire_lanes)
        return bool((lanes[:, :F].sum(1) == F).any()
                    or (lanes[:, F:].sum(1) == F).any())

    def fire_until_done(self, wm_ms: int, t_cross: Optional[float] = None
                        ) -> None:
        """The split path's fire steps at ``wm_ms`` until one fills fewer
        than F lanes of either kind (the reference's drain_fires,
        executor.py:5320-5414): the reduced fire step (G4) for
        device-reduce sinks with no spill stores, else the compact one
        (G6). ``t_cross``: when the host saw the watermark crossing; each
        step's windows record the time from it to their emission as their
        fire latency."""
        if self.graph is not None:
            return self.drain_chained(wm_ms, t_cross)
        self.consume()
        # the live keys per key group, before these fires purge panes
        self.refresh_kg_occupancy()
        wm_t = self.wm_ticks(wm_ms)
        wm_after = max(self.wm_dev, wm_t)
        self.metrics.fire_step_panes += panes_crossed(
            self.wm_dev, wm_after, self.spec.win.slide_ticks)
        self.wm_dev = wm_after
        wm = torch.tensor(wm_t, dtype=torch.int32, device=self.device)
        # the ring into the stores before any emission: whether the stores
        # exist is then fixed for the loop
        if self.spec.win.overflow:
            self.drain_overflow()
        reduced = self.fire_reduced_step is not None and not self.stores
        step = self.fire_reduced_step if reduced else self.fire_step
        m = self.metrics
        while True:
            _states, fires = step(self.states, wm)
            m.fire_steps += 1
            fires_before = m.fires
            lanes = self.emit(fires)
            n = m.fires - fires_before
            m.fire_step_fires += n
            if t_cross is not None:
                m.record_fire_latency(
                    n, (time.perf_counter() - t_cross) * 1e3)
            if not self.lanes_full(lanes):
                return

    def drain_chained(self, wm_ms: int, t_cross: Optional[float] = None
                      ) -> None:
        """A chained job's watermark flush (the reference's drain_chained,
        executor.py:5279-5318): empty chained drains at ``wm_ms``, each
        firing up to F window-ends a stage and forwarding them one edge
        down — one a stage and hop, plus ceil((ring + panes a window) / F)
        a stage, bound the backlog. Each round's fires are emitted before
        the next (the final stage's arena is reused), and record their
        latency from ``t_cross`` when given. Each round's batch is the
        job's one all-invalid slot, never a ring slot; nothing may be
        grouped (``dispatch`` runs a flush its read calls for once its own
        drain is queued)."""
        self.flushing = True
        try:
            self.consume()
            self.refresh_kg_occupancy()
            rounds = len(self.chain_specs) + 1
            for sp in (self.spec,) + tuple(self.chain_specs):
                w = sp.win
                rounds += -(-(w.ring + w.panes_per_window)
                            // w.fires_per_step)
            self.flush_t = t_cross
            for _ in range(rounds):
                self.group.push(self.empty_slot, wm_ms, None)
                self.dispatch()
                self.metrics.chain_flush_drains += 1
            self.consume()
        finally:
            self.flushing = False
            self.flush_t = None

    def emit(self, fires, mon=None, ds=None, kg_batches: int = 0
             ) -> np.ndarray:
        """Emit one payload — ``fires`` a list of each shard's [D, Ft] (or
        [Ft]) fires — with one device->host read of its small fields (on
        the first shard's device) — with a drain's, also its ``mon``: each
        shard's ring fill after each slot and the drain's activity, and
        when ``kg_batches`` is above 0 its key-group fill (covering that
        many batches), and the flight recorder ``ds`` when given — and,
        when rows are needed, one more of the row prefixes and one of each
        shard's ring. Returns the lanes that fired, bool [S, D, Ft]."""
        states = self.states
        S = len(fires)
        dev = states[0].device
        n_slots = fires[0].n_fires.numel()

        def on0(t):
            return t if t.device == dev else t.to(dev)

        if mon is None:
            # a watermark-only fire adds nothing to the ring and has no
            # activity (the value read in its place is not used)
            fills = torch.stack([on0(st.ovf_n) for st in states])
            activity = fills[0]
        else:
            fills, activity = mon[:2]
        parts = [on0(f.n_fires).reshape(-1) for f in fires]
        parts += [on0(st.purged_through).reshape(1) for st in states]
        parts += [activity.reshape(1), fills.reshape(-1)]
        for name in ("counts", "lane_valid", "window_end_ticks",
                     "value_sums"):
            parts += [on0(getattr(f, name)).reshape(-1) for f in fires]
        n_kg = mon[2].numel() if kg_batches else 0
        if n_kg:
            parts.append(mon[2])
        n_sl = mon[3].numel() if mon is not None and len(mon) > 3 else 0
        if n_sl:
            parts.append(mon[3])
        # the flight recorder: the shards' [n, D, 9] stacks, or a chained
        # drain's pair (stage 0's stacks, the downstream stages' [S - 1,
        # n, 6] records)
        ds_parts = () if ds is None else (
            ds if isinstance(ds, tuple) else (ds,))
        parts += [t.reshape(-1) for t in ds_parts]
        small = torch.cat([t.to(torch.float64) for t in parts]).cpu().numpy()
        F = self.spec.win.fire_lanes
        at = S * n_slots
        purged_through = int(small[at:at + S].min())
        at += S
        act = int(small[at])
        at += 1
        n_fill = fills.numel()
        fills = small[at:at + n_fill].astype(np.int64).reshape(S, -1)
        if fills.shape[1] != n_slots:
            fills = np.repeat(fills[:, -1:], n_slots, axis=1)
        at += n_fill
        counts, lanes, ends, vsums = (
            small[at:at + 4 * S * n_slots * F].reshape(4, S, n_slots, F))
        at += 4 * S * n_slots * F
        counts = (counts * lanes).astype(np.int64)
        lanes = lanes.astype(bool)
        ends = ends.astype(np.int64)
        if n_kg:
            self.absorb_kg(small[at:at + n_kg].astype(np.int64), kg_batches)
            at += n_kg
        if n_sl:
            # did any stage's last advance fill all F lanes (backlog may
            # remain)?
            full = small[at:at + n_sl].reshape(-1, F).astype(bool)
            self.chain_full = bool(full.all(1).any())
            at += n_sl
        if self.telem is not None and mon is not None:
            if ds_parts:
                rest = small[at:].astype(np.int64)
                n0 = ds_parts[0].numel()
                self.telem.absorb_payload(
                    rest[:n0].reshape(tuple(ds_parts[0].shape)))
                if len(ds_parts) > 1:
                    self.telem.absorb_stage_payload(
                        rest[n0:].reshape(tuple(ds_parts[1].shape)))
            if lanes.any():
                # event time to fire: each live lane is one window end
                # weighted by its keys
                self.telem.note_fires(list(zip(ends[lanes].tolist(),
                                               counts[lanes].tolist())))
        if mon is not None and self.has_fast:
            self.tier(act)
        n_ring = fills[:, -1]
        if self.reduced or not (self.stores or n_ring.any()):
            # aggregates only, or rows with no spill to merge (the
            # reference's emit_fires shortcut for device-reduce sinks)
            if self.sink_device_reduce:
                n = int(counts.sum())
                if n:
                    self.metrics.fires += n
                    self.metrics.records_out += n
                    for s in self.pipe.sinks:
                        s.invoke_reduced(n, float((vsums * lanes).sum()))
            elif counts.any():
                self.emit_rows(fires, counts, lanes, ends, fills, None)
        else:
            rings = [self.read_ring(int(k), s) if k else None
                     for s, k in enumerate(n_ring)]
            self.emit_rows(fires, counts, lanes, ends, fills, rings)
        if n_ring.any():
            self.after_ring_drain()
        self.prune_stores(purged_through)
        return lanes

    def emit_rows(self, fires, counts: np.ndarray, lanes: np.ndarray,
                  ends: np.ndarray, fills: np.ndarray, rings) -> None:
        """Read the ``[:count]`` row prefixes of every (shard, slot, lane)
        in one batched read (each shard's on its device), then for each
        slot fold each shard's share of its ring rows (``rings[s]``: host
        arrays of shard s's ``[:fills[s, -1]]`` ring lanes, or None) into
        the spill stores and hand the slot's rows of every shard, merged
        with the stores, to the sinks."""
        S, n_slots, F = counts.shape
        parts = [(s, d, f, int(counts[s, d, f])) for s in range(S)
                 for d in range(n_slots) for f in range(F)
                 if counts[s, d, f]]
        by_slot = {}
        red = self.emit_red
        v_shape = red.out_shape
        v_np = np.float32 if red.out_dtype == torch.float32 else np.int32
        width = int(np.prod(v_shape, dtype=np.int64))
        if parts:
            views = []
            for fr in fires:
                C = fr.key_hi.shape[-1]
                vals = fr.values.reshape(n_slots, F, C * width)
                if vals.dtype == torch.float32:
                    vals = vals.view(torch.int32)
                views.append((fr.key_hi.reshape(n_slots, F, C),
                              fr.key_lo.reshape(n_slots, F, C), vals))
            dev = fires[0].key_hi.device
            rows = torch.cat([
                torch.cat([views[s][0][d, f, :n], views[s][1][d, f, :n],
                           views[s][2][d, f, :n * width]]).to(dev)
                for s, d, f, n in parts]).cpu().numpy()
            at = 0
            for _s, d, f, n in parts:
                r = rows[at:at + (2 + width) * n]
                at += (2 + width) * n
                by_slot.setdefault(d, []).append((
                    r[:n].view(np.uint32), r[n:2 * n].view(np.uint32),
                    r[2 * n:].view(v_np).reshape((n,) + v_shape),
                    np.full(n, self.td.to_ms(int(ends[_s, d, f])),
                            np.int64)))
        prev = [0] * S
        for d in range(n_slots):
            for s in range(S):
                if rings is not None and rings[s] is not None \
                        and fills[s, d] > prev[s]:
                    self.fold_ring(*(a[prev[s]:fills[s, d]]
                                     for a in rings[s]))
                    prev[s] = int(fills[s, d])
            cols = [np.concatenate(c) for c in zip(*by_slot[d])] \
                if d in by_slot else None
            due = sorted({int(e) for e in ends[:, d][lanes[:, d]]})
            if self.stores and due:
                if cols is None:
                    cols = [np.zeros(0, np.uint32), np.zeros(0, np.uint32),
                            np.zeros((0,) + v_shape, np.float32),
                            np.zeros(0, np.int64)]
                cols = self.merge_spill(*cols, due)
            if cols is not None and len(cols[2]):
                self.emit_slot(*cols)

    def emit_slot(self, khi, klo, values, end_ms) -> None:
        """Hand one slot's rows to the sinks, values through the stage's
        result projection (mean's divide, an AggregateFunction's
        get_result) when it has one."""
        if self.result_fn is not None:
            values = np.asarray(self.result_fn(values))
        n = len(values)
        self.metrics.fires += n
        if self.columnar:
            self.sinks_columnar({"key_id": key_words(khi, klo),
                                 "window_end_ms": end_ms, "value": values})
            return
        keys = self.codec.decode(khi, klo)
        self.sinks_rows([WindowResult(k, int(e), v) for k, e, v in
                         zip(keys, end_ms.tolist(), values.tolist())])

    # -- checkpoints and restarts -------------------------------------------
    def write_checkpoint(self) -> None:
        """The checkpoint cut (the reference's write_checkpoint, sync-full,
        executor.py:2855-2960): every staged batch drained and its fires
        read, the windows due at the current watermark fired (an exact cut:
        no payload of the state is left unread), then the state staged to
        the host, the spill stores folded into its entries, and the cut
        written with the source offsets, the sinks' states and the aux
        scalars. The whole of it stalls the loop (``sync_ms``)."""
        t0 = time.perf_counter()
        trigger_ms = time.time() * 1000
        cid = self.next_cid
        self.dispatch()
        self.fire_until_done(int(self.wm_strategy.current()), t0)
        staged = ckpt.stage_sharded_state(self.states, self.red)
        dumped = self.dump_spill_stores()
        storage = self.storage
        if self.keep_reverse:
            items, self.n_keys_logged = self.codec.rev_slice(
                self.n_keys_logged)
            storage.append_keymap(items)
        aux = {
            "origin_ms": self.td.origin_ms,
            "wm_current": self.wm_strategy.current(),
            "codec_rev_count": self.n_keys_logged if self.keep_reverse else 0,
            "size_ms": self.size_ms, "slide_ms": self.slide_ms,
            "lateness_ms": self.lateness_ms,
            "state_layout": self.spec.layout,
            "sink_states": [s.snapshot_state() for s in self.pipe.sinks],
        }
        # the cut is the last APPLIED batch's offsets: the producer may
        # have polled past it (executor.py:2904-2960, ingest.py:1157-1166)
        offsets = self.ingest.applied_offsets()
        entries, scalars = ckpt.extract_entries(staged, self.spec.win)
        entries = self.fold_spill_entries(entries, dumped)
        path = storage.write(cid, entries, scalars, offsets, aux)
        with self.ingest.source_lock:
            self.pipe.source.notify_checkpoint_complete(cid, offsets)
        for s in self.pipe.sinks:
            s.notify_checkpoint_complete(cid)
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        self.metrics.record_checkpoint(
            cid, trigger_ms, (time.perf_counter() - t0) * 1e3, nbytes,
            len(entries["key_hi"]))
        self.next_cid += 1
        self.steps_at_ckpt = self.metrics.steps

    def restore(self, target) -> None:
        """Restore the newest checkpoint of ``target`` (a directory, or
        the job's own storage), the reference's restore_checkpoint
        (executor.py:3327-3490): staged batches and unread fires die with
        the failed state (the rewound source replays them, the restored
        cut re-fires them), the spill stores are dropped and re-seeded
        from the entries that do not fit the table, the state is rebuilt
        in the snapshot's layout (an ``auto`` layout resumes as it was
        taken), and the source offsets, the sinks' states, the watermark
        and the reverse key map rewind to the cut. A restore places every
        key anew, so whatever is keyed by slot starts over: the step
        tiering returns to the insert step, the occupancy view is
        dropped, and tiered state's residency re-slices to its first
        ``budget`` groups."""
        cfg = self.env.config
        if isinstance(target, ckpt.CheckpointStorage):
            st = target
        elif self.storage is not None and os.path.abspath(str(target)) \
                == os.path.abspath(self.storage.dir):
            st = self.storage
        else:
            st = ckpt.CheckpointStorage(str(target))
        cid = st.latest()
        if cid is None:
            raise FileNotFoundError(f"no checkpoint in {st.dir}")
        self.ingest.pause()
        self.pending = None
        self.pending_batch = None
        self.group.clear()
        self.inflight.clear()
        self.mon_watch.clear()
        for store in self.stores.values():
            store.close()
        self.stores = {}
        entries, scalars, offsets, aux = st.read(cid)
        if (aux["size_ms"], aux["slide_ms"]) != (self.size_ms,
                                                 self.slide_ms):
            raise ValueError("checkpoint window spec mismatch")
        if aux.get("chain_stages"):
            raise ValueError(
                "checkpoint carries chained stage state but the job is "
                "single-stage — restore with the matching pipeline")
        # re-arm the pane-jump guard: the restored ring holds unfired panes
        # up to the snapshot's newest
        self.applied_max_pane = (int(entries["pane"].max())
                                 if len(entries["pane"]) else None)
        if self.td is None or aux["origin_ms"] != self.td.origin_ms:
            layout = cfg.get_str("state.backend.layout", "auto")
            if layout == "auto":
                layout = aux.get("state_layout", "hash")
            self.setup(aux["origin_ms"], layout)
        leftover = [] if self.spec.win.overflow else None
        self.states = ckpt.restore_sharded_state(
            entries, scalars, self.ctx, self.spec, leftover=leftover)
        self.seed_spill_leftover(leftover)
        self.reset_step_tier()
        self.kg_occ = None
        self.wm_dev = int(scalars["watermark"])
        if self.tier_mgr is not None:
            self.setup_tiers()
        with self.ingest.source_lock:
            self.pipe.source.restore_offsets(offsets)
        sink_states = aux.get("sink_states")
        if sink_states:
            if len(sink_states) != len(self.pipe.sinks):
                raise ValueError(
                    f"checkpoint has {len(sink_states)} sink states but the "
                    f"job topology has {len(self.pipe.sinks)} sinks — "
                    f"restore with the matching pipeline")
            for s, ss in zip(self.pipe.sinks, sink_states):
                s.restore_state(ss)
        self.wm_strategy.restore(aux["wm_current"])
        count = aux.get("codec_rev_count", 0)
        if count:
            self.codec.restore(st.read_keymap(count))
        self.n_keys_logged = self.codec.size() if st is self.storage else 0
        self.steps_at_ckpt = self.metrics.steps
        # the restored cut fired every window due at its watermark
        self.host_fired_pane = self.wm_pane_of(int(aux["wm_current"]))
        # drop the batches prepped past the cut (the rewound source
        # replays them) and clear the device ring: the epoch bump
        self.ingest.resume(offsets)

    def dump_spill_stores(self):
        """The spill stores' contents as [(pane, keys uint64, values [n, W]
        float32)] copies (the reference's _dump_spill_stores)."""
        out = []
        for p, store in self.stores.items():
            ks, vs = store.dump()
            if len(ks):
                out.append((int(p), np.array(ks, copy=True),
                            np.array(vs, copy=True)))
        return out

    def fold_spill_entries(self, entries: dict, dumped) -> dict:
        """The spill stores ride the snapshot as logical entries, a (key,
        pane) held on both sides combined by the reduce (the reference's
        _fold_spill_entries; the restore scatter keeps the last write)."""
        if not dumped:
            return entries
        v_shape = tuple(self.red.value_shape)
        added = [dict(key_hi=(ks >> np.uint64(32)).astype(np.uint32),
                      key_lo=(ks & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                      pane=np.full(len(ks), p, np.int32),
                      value=vs.reshape((len(ks),) + v_shape),
                      fresh=np.zeros(len(ks), bool))
                 for p, ks, vs in dumped]
        entries = dict(entries, value=entries["value"].astype(np.float32))
        for a in added:
            entries = tiers_mod.concat_entries(entries, a)
        return tiers_mod.precombine_entries(entries, self.ovf_w,
                                            self.host_ufunc,
                                            self.host_neutral)

    def seed_spill_leftover(self, leftover) -> None:
        """Entries a restore could not place go back to the spill stores
        they came from (the reference's _seed_spill_leftover)."""
        for l_hi, l_lo, l_pane, l_val in leftover or ():
            k64 = key_words(l_hi, l_lo)
            for p in np.unique(l_pane):
                m = l_pane == p
                store = self.stores.get(int(p))
                if store is None:
                    store = self.stores[int(p)] = SpillStore(
                        width=self.ovf_w, initial_capacity=1024)
                store.put(k64[m],
                          l_val[m].reshape(-1, self.ovf_w).astype(np.float32))

    # -- telemetry ---------------------------------------------------------
    def absorb_kg(self, kg_sum: np.ndarray, n_batches: int) -> None:
        """Fold one sampled drain's key-group fill (int64 [maxp], covering
        ``n_batches`` batches) into the skew telemetry (executor.py:4633-
        4653)."""
        self.kg_fill_total += kg_sum
        self.kg_fill_sampled += n_batches
        if self.telem is not None:
            self.telem.absorb_kg_fill(kg_sum, n_batches)
        if self.tier_mgr is not None:
            # tier faults ride the same sampled vector (executor.py:4654)
            self.tier_mgr.note_sample(kg_sum)

    def refresh_kg_occupancy(self, force: bool = False) -> None:
        """Run G17 over the state and keep the host view, at most once an
        ``observability.kg-stats-interval-ms`` (executor.py:3725-3744).
        Called at fire boundaries, where the loop reads the device
        anyway; it only reads the state."""
        if not self.kg_stats or self.states is None:
            return
        now = time.monotonic()
        if not force and now - self.kg_last_refresh < self.kg_interval_s:
            return
        self.kg_last_refresh = now
        self.kg_occ = sharded_kg_occupancy(
            self.ctx, self.spec, self.states).cpu().numpy().astype(np.int64)

    def kg_report(self, k: int = 10) -> dict:
        """The reference's ``env._kg_report`` (executor.py:3757-3770)."""
        occ = self.kg_occ
        return {
            "key_groups": self.maxp,
            "n_shards": self.n_shards,
            "occupancy_top": _top_k(occ, k),
            "fill_top": _top_k(self.kg_fill_total, k),
            "fill_sampled_batches": self.kg_fill_sampled,
            "occupied_groups": (int((occ > 0).sum()) if occ is not None
                                else None),
        }

    def pipeline_report(self) -> dict:
        """The reference's ``env._pipeline_report`` (executor.py:3772-
        3802): the flight recorder's report, or why there is none. It
        also carries ``steps_per_dispatch``, the K of the last dispatch (1
        for single steps and partial groups), which the reference serves
        as a gauge of its metric groups (not ported: item 15)."""
        if self.telem is None:
            rep = _no_pipeline_report()
        else:
            # a row a ring lane, with its publish refusals
            dr = self.ingest.device_ring
            rep = self.telem.report(
                refusals=dr.refusals() if dr is not None else None)
            rep["drain_stats_every"] = self.drain_stats_every
        if self.tier_mgr is not None:
            # tiered jobs stay observable with drain-stats off
            rep["tiers"] = self.tier_mgr.report()
        rep["steps_per_dispatch"] = self.fuse_depth
        return rep

    def doctor_report(self) -> dict:
        """The reference's ``env._doctor_report`` (executor.py:3814-3877):
        the telemetry planes the port has joined into one snapshot —
        ``pipeline``, ``metrics`` (the gauge fields), ``checkpoints`` and
        ``fire_latency_ms`` — and the copied rule engine's ranked findings
        over it, with the snapshot and the ``observability.doctor.*``
        thresholds embedded, so that ``python -m flink_tpu_torch.doctor``
        replays the diagnosis. The ``compile`` plane is left out (eager
        steps compile nothing per shape; its rule finds nothing), and so
        is ``recovery`` (item 13)."""
        cfg = self.env.config
        if not cfg.get(CoreOptions.DOCTOR):
            return {"available": False, "reason": "observability.doctor off"}
        m = self.metrics
        snapshot = {
            "pipeline": self.pipeline_report(),
            "metrics": {f: getattr(m, f, 0) for f in JobMetrics.GAUGE_FIELDS},
            "checkpoints": list(m.checkpoint_stats or []),
            "fire_latency_ms": {"p50": m.fire_latency_pct(50),
                                "p99": m.fire_latency_pct(99)},
        }
        thresholds = {
            "starved": cfg.get(CoreOptions.DOCTOR_STARVED_THRESHOLD),
            "saturated": cfg.get(CoreOptions.DOCTOR_SATURATED_THRESHOLD),
            "edge_utilization": cfg.get(
                CoreOptions.DOCTOR_EDGE_UTILIZATION_THRESHOLD),
            "kg_skew": cfg.get(CoreOptions.DOCTOR_KG_SKEW_THRESHOLD),
            "recompile": cfg.get(CoreOptions.DOCTOR_RECOMPILE_THRESHOLD),
            "tier_churn": cfg.get(CoreOptions.DOCTOR_TIER_CHURN_THRESHOLD),
            "tier_miss": cfg.get(CoreOptions.DOCTOR_TIER_MISS_THRESHOLD),
        }
        payload = diagnose(snapshot, thresholds)
        payload["snapshot"] = snapshot
        payload["thresholds"] = thresholds
        return payload

    # -- the self-tuning controller ----------------------------------------
    def build_controller(self) -> controller_mod.RuntimeController:
        """The reference's controller wiring (executor.py:5640-5806), its
        actuators where the reference registers them: ``ring-fill-target``
        (the drain group's capacity) in the resident modes,
        ``dispatch-group`` (the megastep group's) with K above 1,
        ``drain-stats-cadence`` with the flight recorder on, and
        ``tier-prefetch-ahead`` with tiered state. Each is a host
        attribute write: a move changes only the next group."""
        cfg = self.env.config
        acts = {}
        group = self.group
        if self.mode.resident:
            acts["ring-fill-target"] = controller_mod.Actuator(
                "ring-fill-target", lambda: int(group.k),
                lambda v: setattr(group, "k", int(v)), lo=1, hi=self.depth)
        elif self.mode.k_fuse > 1:
            acts["dispatch-group"] = controller_mod.Actuator(
                "dispatch-group", lambda: int(group.k),
                lambda v: setattr(group, "k", int(v)), lo=1,
                hi=self.mode.k_fuse)
        if self.drain_stats:
            def ds_set(v):
                self.drain_stats_every = max(1, int(v))

            acts["drain-stats-cadence"] = controller_mod.Actuator(
                "drain-stats-cadence", lambda: int(self.drain_stats_every),
                ds_set, lo=1, hi=64)
        if self.tier_budget > 0:
            def tp_get():
                if self.tier_mgr is not None:
                    return int(self.tier_mgr.prefetch_ahead_panes)
                return int(cfg.get(
                    CoreOptions.STATE_TIERS_PREFETCH_AHEAD_PANES))

            def tp_set(v):
                if self.tier_mgr is not None:
                    self.tier_mgr.prefetch_ahead_panes = max(0, int(v))

            acts["tier-prefetch-ahead"] = controller_mod.Actuator(
                "tier-prefetch-ahead", tp_get, tp_set, lo=0, hi=16,
                step="additive")
        return controller_mod.RuntimeController(
            acts, self.controller_sensor,
            findings_fn=lambda: (self.doctor_report() or {}).get(
                "findings") or [],
            rebalancer=self.controller_rebalance,
            interval_cycles=int(cfg.get(
                CoreOptions.CONTROLLER_INTERVAL_CYCLES)),
            revert_threshold=float(cfg.get(
                CoreOptions.CONTROLLER_REVERT_THRESHOLD)),
            probation_cycles=int(cfg.get(
                CoreOptions.CONTROLLER_PROBATION_CYCLES)),
            cooldown_cycles=int(cfg.get(
                CoreOptions.CONTROLLER_COOLDOWN_CYCLES)),
            rebalance_threshold=float(cfg.get(
                CoreOptions.CONTROLLER_REBALANCE_THRESHOLD)),
            min_rebalance_interval=float(cfg.get(
                CoreOptions.CONTROLLER_MIN_REBALANCE_INTERVAL)),
            min_gain=float(cfg.get(CoreOptions.CONTROLLER_MIN_GAIN)),
            persist_dir=self.env.checkpoint_dir or None)

    def controller_sensor(self) -> dict:
        """The planes the controller decides on, all host values the loop
        already read: events in, the recorder's regime and key-group heat,
        and the shards' key-group ranges."""
        duty = starved = heat = None
        if self.telem is not None:
            duty, starved = self.telem.regime()
            h = getattr(self.telem, "_kg_heat", None)
            if h is not None and len(h) == self.maxp:
                heat = np.array(h, np.float64)
        starts, ends = self.ctx.kg_bounds()
        return {"records": int(self.metrics.records_in), "duty": duty,
                "starved": starved, "heat": heat,
                "kg_starts": starts.tolist(), "kg_ends": ends.tolist()}

    def controller_rebalance(self, starts, ends) -> None:
        """The rebalance arm re-slices the shards' key-group ranges through
        the reference's savepoint-cut rescale, which is not ported: a job
        of more than one shard with the flight recorder on fails when the
        arm's skew test fires."""
        raise _unsupported("the controller's live key-group rebalance "
                           "(the savepoint-cut rescale across shards)",
                           "ROADMAP queue 1, item 10")

    def controller_report(self) -> dict:
        """The reference's ``env._controller_report``: the decision ledger
        and the actuators, or the off stub."""
        if self.controller is None:
            return _no_controller_report()
        return self.controller.report()

    # -- the spill tier ----------------------------------------------------
    def tier(self, act: int) -> None:
        """The reference's step tiering (check_overflow_pressure): the
        insert step while keys are being placed; after TIER_QUIET_CHECKS
        drains that placed none, the fast step; back on a fast drain whose
        misses pass the tolerance. An insert period that placed nothing
        proves those misses were keys no chain can take, so their count
        becomes the fast step's tolerance (reset at each ring drain, since
        a compaction may change what fits)."""
        if self.step_mode == "insert":
            if act == 0:
                self.tier_quiet += 1
                if self.tier_quiet >= TIER_QUIET_CHECKS:
                    self.step_mode = "fast"
                    if self.bounce_miss and not self.bounce_placed:
                        self.miss_tolerance = max(self.miss_tolerance,
                                                  self.bounce_miss)
                    self.bounce_miss = 0
            else:
                self.tier_quiet = 0
                self.bounce_placed = True
        elif act > self.miss_tolerance:
            self.step_mode = "insert"
            self.tier_quiet = 0
            self.bounce_miss = act
            self.bounce_placed = False

    def reset_step_tier(self) -> None:
        """Back to the insert step with no history: after a restore or a
        tier swap, which place the table's keys anew."""
        self.step_mode = "insert"
        self.tier_quiet = self.miss_tolerance = self.bounce_miss = 0
        self.bounce_placed = False

    @property
    def has_fast(self) -> bool:
        """Does any route have the lookup-only fast variant?"""
        return any(tiers.get("fast") is not None
                   for table in (self.steps, self.mega or {}, self.drains)
                   for tiers in table.values())

    def ring_fills(self) -> np.ndarray:
        """Each shard's overflow-ring fill, read to the host."""
        dev = self.states[0].device
        return torch.stack([st.ovf_n.to(dev) for st in self.states]
                           ).cpu().numpy().astype(np.int64)

    def read_ring(self, n: int, s: int = 0):
        """Shard ``s``'s ring's first ``n`` lanes as host arrays (key word
        uint64, pane int64, values float32 [n, W]), in one read."""
        st = self.states[s]
        W = self.ovf_w
        raw = torch.cat([st.ovf_hi[:n], st.ovf_lo[:n], st.ovf_pane[:n],
                         st.ovf_val[:n].reshape(-1).view(torch.int32)]
                        ).cpu().numpy()
        hi, lo, pane = raw[:3 * n].reshape(3, n)
        val = raw[3 * n:].view(np.float32).reshape(n, W)
        k64 = (hi.view(np.uint32).astype(np.uint64) << np.uint64(32)) | \
            lo.view(np.uint32).astype(np.uint64)
        return k64, pane.astype(np.int64), val

    def fold_ring(self, k64, panes, vals) -> None:
        """Fold ring lanes (values [n, W]) into the per-pane stores (the
        reference's _merge_ring_into_stores): each pane's contributions
        combined per key by the host ufunc from its neutral, then combined
        with what the store holds."""
        self.metrics.spilled_records += len(k64)
        ufunc, W = self.host_ufunc, self.ovf_w
        for p in np.unique(panes):
            sel = panes == p
            uk, inv = np.unique(k64[sel], return_inverse=True)
            agg = np.full((len(uk), W), self.host_neutral, np.float32)
            ufunc.at(agg, inv, vals[sel].reshape(-1, W))
            store = self.stores.get(int(p))
            if store is None:
                store = self.stores[int(p)] = SpillStore(
                    width=W, initial_capacity=1024)
            old, found = store.get(uk)
            store.put(uk, np.where(found[:, None], ufunc(old, agg), agg))
        self.metrics.spill_peak_keys = max(
            self.metrics.spill_peak_keys,
            sum(len(s) for s in self.stores.values()))
        if self.tier_mgr is not None and len(k64):
            # the prefetcher's pending-pane index (executor.py:4761-4766)
            self.tier_mgr.note_cold(tiers_mod.entries_key_groups(
                {"key_hi": (k64 >> np.uint64(32)).astype(np.uint32),
                 "key_lo": (k64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)},
                self.maxp), panes)

    def after_ring_drain(self) -> None:
        """The rings have been folded into the stores: clear them, and
        compact each shard's hash table (the reference's drain_overflow).
        A live key that a rebuilt table cannot take moves its cells to its
        ring, which is folded at once; they belong to windows that have
        not fired yet."""
        for st in self.states:
            clear_overflow(st)
        self.metrics.ring_drains += 1
        self.miss_tolerance = 0
        if self.spec.layout != "hash":
            return
        for s, st in enumerate(self.states):
            self.states[s] = compact_step(st, self.spec)
        self.metrics.compactions += 1
        for s, n in enumerate(self.ring_fills()):
            if n:
                self.fold_ring(*self.read_ring(int(n), s))
                clear_overflow(self.states[s])

    def spill_window_contrib(self, end_pane: int):
        """The stores' combined contributions to the window ending at pane
        ``end_pane`` (its k panes): (sorted unique keys uint64, values
        float32 [n, W])."""
        k = self.spec.win.panes_per_window
        W = self.ovf_w
        ks_l, vs_l = [], []
        for q in range(end_pane - k + 1, end_pane + 1):
            store = self.stores.get(q)
            if store is None or len(store) == 0:
                continue
            ks, vs = store.dump()
            ks_l.append(ks)
            vs_l.append(vs)
        if not ks_l:
            return np.zeros(0, np.uint64), np.zeros((0, W), np.float32)
        uk, inv = np.unique(np.concatenate(ks_l), return_inverse=True)
        agg = np.full((len(uk), W), self.host_neutral, np.float32)
        self.host_ufunc.at(agg, inv, np.concatenate(vs_l))
        return uk, agg

    def merge_spill(self, khi, klo, values, end_ms, due_end_ticks):
        """Merge the stores into one slot's emission (the reference's
        _merge_spill): a key present on both sides is combined, a key only
        in the stores adds a row for each due window end (every lane here
        is on time)."""
        slide = self.spec.win.slide_ticks
        k64 = (khi.astype(np.uint64) << np.uint64(32)) | klo.astype(
            np.uint64)
        v_shape = values.shape[1:]
        v = values.reshape(len(values), self.ovf_w).astype(np.float32,
                                                           copy=True)
        add = []
        for e_ticks in due_end_ticks:
            uk, uv = self.spill_window_contrib(e_ticks // slide - 1)
            if not len(uk):
                continue
            e_ms = self.td.to_ms(e_ticks)
            sel = np.nonzero(end_ms == e_ms)[0]
            pos = np.minimum(np.searchsorted(uk, k64[sel]), len(uk) - 1)
            hit = uk[pos] == k64[sel]
            v[sel[hit]] = self.host_ufunc(v[sel[hit]], uv[pos[hit]])
            only = np.ones(len(uk), bool)
            only[pos[hit]] = False
            if only.any():
                ks = uk[only]
                add.append(((ks >> np.uint64(32)).astype(np.uint32),
                            (ks & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                            uv[only], np.full(len(ks), e_ms, np.int64)))
        if add:
            khi, klo, v, end_ms = (
                np.concatenate([a] + list(b))
                for a, b in zip((khi, klo, v, end_ms), zip(*add)))
        return khi, klo, v.reshape((len(v),) + v_shape), end_ms

    def prune_stores(self, purged_through: int) -> None:
        """Drop the stores of panes the card has purged (the reference's
        prune_stores): every window holding them has fired and emitted,
        and a later record of such a pane is late."""
        for q in [q for q in self.stores if q <= purged_through]:
            self.stores.pop(q).close()
        if self.tier_mgr is not None:
            # the same horizon for the prefetcher's index
            self.tier_mgr.prune_cold(purged_through)

    # -- tiered key-group state --------------------------------------------
    def tier_maintenance(self) -> None:
        """The poll-cycle tier pass (the reference's _tier_maintenance,
        executor.py:4993-5023): rank the key groups on the flight
        recorder's heat and recency (flat without it) and the watermark's
        next pane, and apply the plan at this cut. Planning is host numpy;
        an empty plan costs nothing on the card."""
        tm = self.tier_mgr
        telem = self.telem
        heat = getattr(telem, "_kg_heat", None) if telem is not None \
            else None
        if heat is not None and len(heat) == self.maxp:
            heat = np.asarray(heat, np.float64)
            last = np.asarray(telem._kg_last, np.int64)
            seq = int(telem._kg_seq)
        else:
            heat = np.zeros(self.maxp, np.float64)
            last = np.full(self.maxp, -1, np.int64)
            seq = 0
        wm_pane = None
        if self.wm_dev > WM_SENTINEL:
            slide = self.spec.win.slide_ticks
            b = max(self.wm_dev, -(2**31) + 1 + slide)
            wm_pane = (b + 1 - slide) // slide + 1
        self.apply_tier_plan(tm.plan(heat, last, seq, wm_pane=wm_pane))

    def fold_cold(self, entries: dict, fault_point: Optional[str]) -> None:
        """Fold entries into the spill stores, combined per (key, pane),
        and index them as cold (the reference's fold_cold)."""
        tiers_mod.fold_entries(
            entries, self.stores, self.ovf_w, self.host_ufunc,
            self.host_neutral,
            lambda: SpillStore(width=self.ovf_w, initial_capacity=1024),
            self.host_ufunc, fault_point=fault_point)
        if len(entries["pane"]):
            self.tier_mgr.note_cold(
                tiers_mod.entries_key_groups(entries, self.maxp),
                entries["pane"])

    def apply_tier_plan(self, plan) -> None:
        """The demote / promote swap at the cut (the reference's
        _apply_tier_plan, executor.py:4840-4991). The pending fires were
        computed against the current placement, so they are read first
        (with the ring) before any entry moves; batches staged for the
        next drain have not touched the state and apply under the new
        mask. Then the state is staged to logical entries, the demoted
        groups' entries fold into the stores (``tier.demote.write``), each
        promoted group's pending entries come out of them
        (``tier.promote.read``: those inside the pane ring join the device
        half, the rest fold back), the union is pre-combined per (key,
        pane) and the state rebuilt around it — its table, plane and fresh
        flags replaced, the swapped groups marked in kg_dirty — and the
        mask is rewritten. Entries the rebuilt table cannot place go back
        cold. Correctness does not depend on residency: a (key, pane) may
        be split across the card and the stores, and every emission,
        checkpoint and restore combines both halves."""
        tm = self.tier_mgr
        if plan:
            t0 = time.perf_counter()
            self.consume()
            n = int(self.state.ovf_n)
            if n:
                self.fold_ring(*self.read_ring(n))
                clear_overflow(self.state)
            W, win = self.ovf_w, self.spec.win
            staged = ckpt.stage_window_state(self.state, self.red)
            entries, scalars = ckpt.extract_entries(staged, win)
            kgs = tiers_mod.entries_key_groups(entries, self.maxp)
            dem_m = (np.isin(kgs, np.asarray(plan.demote, np.int64))
                     if plan.demote else np.zeros(len(kgs), bool))
            merged, demoted = tiers_mod.split_entries(entries, ~dem_m)
            # unconditional: the demote seam fires once a swap, whether or
            # not entries move
            self.fold_cold(demoted, "tier.demote.write")
            for g in plan.promote:
                got = tiers_mod.fetch_group_entries(
                    self.stores, g, self.maxp, W, staged["value_tail"],
                    staged["value_dtype"])
                tm.forget_cold(g)
                on, off = tiers_mod.ring_window(
                    got, int(scalars["max_pane"]), int(win.ring))
                # panes outside the live ring have no device row yet: back
                # to the stores, to merge at fire the spill tier's way
                self.fold_cold(off, None)
                merged = tiers_mod.concat_entries(merged, on)
            merged = tiers_mod.precombine_entries(
                merged, W, self.host_ufunc, self.host_neutral)
            leftover = []
            new = ckpt.restore_window_state(
                merged, scalars, self.spec, self.maxp, self.device,
                leftover=leftover)
            st = self.state
            st.table_keys, st.acc, st.fresh = (new.table_keys, new.acc,
                                               new.fresh)
            st.pane_ids.copy_(new.pane_ids)
            st.n_fresh.copy_(new.n_fresh)
            for l_hi, l_lo, l_pane, l_val in leftover:
                self.fold_cold({"key_hi": l_hi, "key_lo": l_lo,
                                "pane": l_pane, "value": l_val,
                                "fresh": np.ones(len(l_pane), bool)}, None)
            # the swap changed these groups' rows without the kernels
            # marking them
            groups = list(plan.demote) + list(plan.promote)
            if groups and st.kg_dirty.numel():
                st.kg_dirty[torch.as_tensor(groups, device=self.device)] = \
                    True
            # the rebuilt table placed its keys anew: the occupancy view
            # is stale, and the step tiering starts over at the insert step
            self.kg_occ = None
            self.reset_step_tier()
            self.metrics.tier_swap_s += time.perf_counter() - t0
        tm.apply(plan)
        if plan:
            self.kg_res.copy_(torch.from_numpy(tm.mask()))

    # -- end of job --------------------------------------------------------
    def loss_counters(self):
        # every shard's and stage's counters: an over-full edge lands its
        # lanes in the downstream stage's dropped_capacity (executor.py:
        # 6384-6405)
        states = list(self.states) + [st for cs in self.chain_states
                                      for st in cs]
        return (sum(int(st.dropped_late) for st in states),
                sum(int(st.dropped_capacity) for st in states))

    def finish(self) -> None:
        for store in self.stores.values():
            store.close()
        self.stores = {}
        dr = self.ingest.device_ring
        if dr is not None:
            self.metrics.ring_publish_refusals = sum(dr.refusals())
        super().finish()
