"""Local executor for one keyed event-time window stage on one device —
the main-path slice of flink_tpu/runtime/executor.py (``_run_windowed``).

It runs ``source -> [assign timestamps] -> key_by -> tumbling or sliding
event-time window -> sum | count -> sinks`` with allowed lateness 0 and no
checkpointing:

  1. poll the source (columnar batches of ``execution.micro-batch-size``);
  2. encode keys to 64-bit identities (``KeyCodec``), split (hi, lo);
  3. convert event time to int32 ticks; the origin is fixed by the first
     batch at ``floor(min_ts / size) * size``, as the reference does;
  4. advance the watermark through ``WatermarkStrategy.on_batch``;
  5. stage the batch into the next slot of the device ring;
  6. when ``pipeline.ring-depth`` slots are staged (or the stream ends),
     dispatch one resident drain over them;
  7. read the drain's fires and emit them — the read of drain g happens
     after the batches of drain g+1 are staged, so host polling overlaps
     the device. When every sink is a device-reduce sink the drain reduces
     its fires on the device and the host reads the [D, F] ReducedFires
     once (``sink.invoke_reduced``). Otherwise the drain compacts them to
     rows (CompactFires); the host reads the small [D, F] fields once, then
     the ``[:count]`` row prefixes in one batched read, and hands each
     slot's rows to ``invoke_columnar`` ({"key_id", "window_end_ms",
     "value"}) when every sink is columnar, else ``invoke_batch`` with
     ``WindowResult(key, window_end_ms, value)`` rows, keys decoded;
  8. at end of stream, flush with the MAX watermark.

The state layout follows ``state.backend.layout`` as the reference's does:
``auto`` takes the direct layout (key == slot) when the first batch's key
identities all fit ``[0, state capacity)``, else the hash table.

A drain whose last slot filled all F fire lanes may leave due windows
behind; the executor then fires them with watermark-only advances before
the next drain, as the reference's split drain does. A batch that spans
more panes than the ring can hold is cut into pane groups that fire
between them, and a jump of two or more panes between polls fires the
windows it would otherwise evict first — both as the reference does.

Anything else — another topology, processing time, allowed lateness,
checkpoints, parallelism above 1, an operator after the window, the
overflow ring — raises NotImplementedError naming the ROADMAP queue item
that brings it. Records that find no state slot (a key past capacity in
the direct layout, a full probe chain in the hash layout) count into
``dropped_capacity``. With ``state.backend.overflow-ring: 0`` (strict
capacity) the job then fails at its end with the reference's "state
backend over capacity" error. With the ring unset the reference would
take them into its spill tier, which is not ported: the job raises
NotImplementedError at the first drain that shows a drop.
"""

from __future__ import annotations

import dataclasses
from collections import namedtuple
from typing import Any, List, Optional

import numpy as np
import torch

from flink_tpu_torch.core.time import MAX_TS, TimeCharacteristic, TimeDomain
from flink_tpu_torch.core.types import KeyCodec
from flink_tpu_torch.datastream.window.assigners import WindowAssigner
from flink_tpu_torch.graph import stream_graph as sg
from flink_tpu_torch.ops import window_kernels as wk
from flink_tpu_torch.runtime.ingest import DeviceBatchRing
from flink_tpu_torch.runtime.step import (
    WindowStageSpec,
    build_window_resident_drain,
    fire_only,
    init_shard_state,
)
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy

WindowResult = namedtuple("WindowResult", ["key", "window_end_ms", "value"])


@dataclasses.dataclass
class JobMetrics:
    records_in: int = 0
    fires: int = 0              # (key, window) results emitted
    steps: int = 0              # micro-batches applied
    resident_drains: int = 0    # drain dispatches (each up to ring depth)
    fire_steps: int = 0         # watermark-only fire advances
    dropped_late: int = 0
    dropped_capacity: int = 0


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
    window_agg: sg.WindowAggTransformation
    sinks: List[Any]


def _unsupported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to flink_tpu_torch yet ({item})")


def _translate(sink_ts: List[sg.SinkTransformation]) -> _Pipeline:
    """Check the job is the one topology this slice runs and collect it."""
    if not sink_ts:
        raise ValueError("job has no sinks")
    pipe = None
    for st in sink_ts:
        chain = sg.lineage(st)
        head, rest = chain[0], chain[1:]
        if not isinstance(head, sg.SourceTransformation):
            raise _unsupported(f"a {type(head).__name__} input",
                               "ROADMAP queue 1, item 9")
        ts_t = key_t = agg_t = None
        for t in rest:
            if isinstance(t, sg.TimestampsWatermarksTransformation) \
                    and key_t is None and ts_t is None:
                ts_t = t
            elif isinstance(t, sg.KeyByTransformation) and key_t is None:
                key_t = t
            elif isinstance(t, sg.WindowAggTransformation) \
                    and key_t is not None and agg_t is None:
                agg_t = t
            elif isinstance(t, sg.SinkTransformation) and t is st \
                    and agg_t is not None:
                pass
            else:
                raise _unsupported(
                    f"operator {t.name!r} ({type(t).__name__}) in this "
                    f"position", "ROADMAP queue 1, items 9-15")
        if agg_t is None:
            raise _unsupported("a job without a keyed window",
                               "ROADMAP queue 1, item 9")
        if pipe is None:
            pipe = _Pipeline(head.source, ts_t, key_t, agg_t, [st.sink])
        elif agg_t is pipe.window_agg:
            pipe.sinks.append(st.sink)
        else:
            raise _unsupported("more than one window stage",
                               "ROADMAP queue 1, item 11")
    if not getattr(pipe.source, "columnar", False):
        raise _unsupported("an element-mode (non-columnar) source",
                           "ROADMAP queue 1, item 6")
    wagg = pipe.window_agg
    if not isinstance(wagg.assigner, WindowAssigner) \
            or not wagg.assigner.is_event_time:
        raise _unsupported(
            f"window assigner {type(wagg.assigner).__name__} "
            f"(only event-time tumbling/sliding is)", "ROADMAP queue 1, item 9")
    if wagg.trigger is not None or wagg.evictor is not None \
            or wagg.window_fn is not None or wagg.reduce_spec_factory is None:
        raise _unsupported("custom triggers, evictors and window functions",
                           "ROADMAP queue 1, item 9")
    if wagg.result_fn is not None or wagg.value_prep is not None:
        raise _unsupported("result projections and sketch value prep",
                           "ROADMAP queue 1, item 9")
    if wagg.allowed_lateness_ms:
        raise _unsupported("allowed lateness", "ROADMAP queue 2, K11")
    return pipe


class LocalExecutor:
    def __init__(self, env):
        self.env = env

    def run(self, job_name: str, sinks, restore_from=None) -> JobHandle:
        env = self.env
        if restore_from is not None or env.checkpoint_interval_steps > 0:
            raise _unsupported("checkpoint snapshot and restore",
                               "ROADMAP queue 1, item 6")
        if env.parallelism != 1:
            raise _unsupported(f"parallelism {env.parallelism}",
                               "ROADMAP queue 1, item 10")
        if env.time_characteristic != TimeCharacteristic.EventTime:
            raise _unsupported("processing-time windows",
                               "ROADMAP queue 1, item 9")
        pipe = _translate(sinks)
        job = _WindowJob(env, pipe)
        for s in pipe.sinks:
            s.open()
        pipe.source.open()
        try:
            job.run()
        finally:
            pipe.source.close()
            for s in pipe.sinks:
                s.close()
        return job.finish(job_name)


def _check_config(cfg) -> None:
    """The reference's window-stage knobs: validated as it validates them;
    those naming a path this slice lacks raise."""
    for key, allowed in (("pipeline.update-precombine", ("auto", "on", "off")),
                         ("state.packed-planes", ("auto", "on", "off")),
                         ("pipeline.resident-loop",
                          ("auto", "on", "while", "off"))):
        v = cfg.get_str(key, "auto")
        if v not in allowed:
            raise ValueError(f"{key} must be {'|'.join(allowed)}, got {v!r}")
    layout = cfg.get_str("state.backend.layout", "auto")
    if layout not in ("auto", "hash", "direct"):
        raise ValueError(
            f"state.backend.layout must be auto|hash|direct, got {layout!r}")
    if cfg.get_int("state.backend.overflow-ring", -1) > 0:
        raise _unsupported("the overflow ring and spill tier",
                           "ROADMAP queue 2, K10")
    if cfg.get_int("state.tiers.resident-key-groups", 0) > 0:
        raise _unsupported("tiered key-group state",
                           "ROADMAP queue 1, item 11")
    if cfg.get_int("pipeline.steps-per-dispatch", 1) > 1:
        raise _unsupported("megastep dispatch fusion",
                           "ROADMAP queue 2, K13")


class _WindowJob:
    """State of one run: the window stage, its ring and the host cursors."""

    def __init__(self, env, pipe: _Pipeline):
        cfg = env.config
        _check_config(cfg)
        self.env = env
        self.pipe = pipe
        self.metrics = JobMetrics()
        self.device = torch.device(env.device)
        self.red = pipe.window_agg.reduce_spec_factory()
        assigner = pipe.window_agg.assigner
        self.size_ms, self.slide_ms = assigner.size_ms, assigner.slide_ms
        self.wm_strategy = (
            pipe.ts_transform.strategy if pipe.ts_transform is not None
            else WatermarkStrategy.for_monotonous_timestamps()
        )
        self.B = env.batch_size
        self.depth = max(2, cfg.get_int("pipeline.ring-depth", 16))
        # the reference's emit modes (executor.py:5025-5035): reduced on
        # the device when every sink only wants aggregates, else rows —
        # columnar when every sink takes columns, else WindowResult rows
        self.reduced = all(getattr(s, "device_reduce", False)
                           for s in pipe.sinks)
        self.columnar = all(getattr(s, "columnar", False)
                            for s in pipe.sinks)
        self.codec = KeyCodec()
        # the reverse key map serves only WindowResult decoding (the port
        # has no checkpoint key map), so columnar-only jobs skip its cost
        self.keep_reverse = (cfg.get_bool("keys.reverse-map", True)
                             and not self.columnar)
        # unset (-1) = the reference's spill tier would absorb keys that
        # find no slot; 0 = strict capacity
        self.spill = cfg.get_int("state.backend.overflow-ring", -1) < 0
        self.maxp = env.max_parallelism
        self.td: Optional[TimeDomain] = None
        self.spec: Optional[WindowStageSpec] = None
        self.state: Optional[wk.WindowShardState] = None
        self.ring: Optional[DeviceBatchRing] = None
        self.drain = None
        self.staged = 0              # slots staged for the next drain
        self.staged_wm: List[int] = []
        self.pending = None          # (fires, count, last wm) unread
        self.applied_max_pane: Optional[int] = None

    # -- setup on the first batch ------------------------------------------
    def setup(self, origin_ms: int, hi: np.ndarray, lo: np.ndarray) -> None:
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
            8, 2 * ppw + self.wm_strategy.out_of_orderness_ms // self.slide_ms
            + 2)
        capacity = env.state_capacity_per_shard
        layout = cfg.get_str("state.backend.layout", "auto")
        if layout == "auto":
            # direct only when the first batch's identities fit [0, C)
            # (executor.py:1925-1936, 5952-5965; every stage this port runs
            # is spillable there)
            fits = (int(hi.max(initial=0)) == 0
                    and int(lo.max(initial=0)) < capacity)
            layout = "direct" if fits else "hash"
        win = wk.WindowSpec(
            size_ticks=self.size_ms, slide_ticks=self.slide_ms, ring=ring,
            fires_per_step=cfg.get_int("window.fires-per-step", 4),
        )
        self.td = TimeDomain(origin_ms=origin_ms, ms_per_tick=1)
        self.spec = WindowStageSpec(
            win=win, red=self.red, capacity_per_shard=capacity,
            layout=layout, probe_len=cfg.get_int("state.probe-len", 16))
        self.state = init_shard_state(self.spec, self.maxp, self.device)
        self.ring = DeviceBatchRing(self.depth, self.B, self.device)
        self.drain = build_window_resident_drain(
            self.spec, self.depth, self.maxp, reduced=self.reduced)

    def wm_ticks(self, wm_ms: int) -> int:
        return min(int(self.td.to_ticks(wm_ms)), 2**31 - 4)

    # -- the poll loop -----------------------------------------------------
    def run(self) -> None:
        pipe = self.pipe
        while True:
            (cols, ts_ms), end = pipe.source.poll(self.B)
            if cols:
                self.apply(cols, ts_ms)
            if end:
                break
        if self.td is None:
            return
        self.dispatch()
        self.consume()
        # end of stream: MAX watermark flush (ref Watermark.MAX_WATERMARK)
        self.fire_until_done(int(self.td.to_ms(MAX_TS - 2)))

    def apply(self, cols, ts_ms) -> None:
        pipe = self.pipe
        keys = np.asarray(pipe.key_by.key_selector(cols))
        n = len(keys)
        if n == 0:
            return
        hi, lo = self.codec.encode(keys, keep_reverse=self.keep_reverse)
        values = np.asarray(pipe.window_agg.extractor(cols), np.float32)
        if pipe.ts_transform is not None:
            ts_ms = np.asarray(pipe.ts_transform.timestamp_fn(cols), np.int64)
        elif ts_ms is None:
            raise ValueError(
                "event-time job but the columnar source provides no "
                "timestamps and no assign_timestamps_and_watermarks is set")
        ts_ms = np.asarray(ts_ms, np.int64)
        self.metrics.records_in += n
        if self.td is None:
            self.setup((int(ts_ms.min()) // self.size_ms) * self.size_ms,
                       hi, lo)
        ticks = self.td.to_ticks(ts_ms)
        wm_ms = self.wm_strategy.on_batch(int(ts_ms.max()))
        win = self.spec.win
        slide = win.slide_ticks
        panes = ticks // np.int32(slide)
        # a batch spanning more panes than the ring holds is cut into pane
        # groups that fire between them (the reference's catch-up slicing)
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
        ooo = self.wm_strategy.out_of_orderness_ms
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
            # a jump of 2+ panes past everything applied would rotate the
            # ring over unfired panes: fire their windows first
            g_max_pane = int(g[2].max()) // slide
            if self.applied_max_pane is not None \
                    and g_max_pane - self.applied_max_pane >= 2:
                g_min_pane = int(g[2].min()) // slide
                self.dispatch()
                self.fire_until_done(
                    min(g_wm, int(self.td.to_ms(g_min_pane * slide)) - 1))
            self.applied_max_pane = (
                g_max_pane if self.applied_max_pane is None
                else max(self.applied_max_pane, g_max_pane))
            self.stage(*g, g_wm)
            if sel is not None:
                self.dispatch()
                self.fire_until_done(g_wm)

    def stage(self, hi, lo, ticks, values, wm_ms: int) -> None:
        wm = self.wm_ticks(wm_ms)
        self.ring.stage(self.staged, hi, lo, ticks, values, wm)
        self.staged += 1
        self.staged_wm.append(wm_ms)
        self.metrics.steps += 1
        if self.staged == self.depth:
            self.dispatch()

    # -- drains and fires --------------------------------------------------
    def dispatch(self) -> None:
        """Queue one resident drain over the staged slots. The previous
        drain's fires are read first: they may call for watermark-only
        fires that must precede this drain's updates."""
        if not self.staged:
            return
        self.consume()
        count = self.staged
        slots = self.ring.slots(count)
        self.state, fires = self.drain(self.state, slots, self.ring.wmv,
                                       count)
        self.ring.release(count)
        self.pending = (fires, count, self.staged_wm[-1])
        self.staged = 0
        self.staged_wm = []
        self.metrics.resident_drains += 1

    def consume(self) -> None:
        """Read the last drain's fires (the one host sync per drain), emit
        them, and fire any window-ends its F lanes left due."""
        if self.pending is None:
            return
        fires, count, last_wm = self.pending
        self.pending = None
        n_now = self.emit(fires)
        if int(n_now[count - 1]) == self.spec.win.fires_per_step:
            self.fire_until_done(last_wm)

    def fire_until_done(self, wm_ms: int) -> None:
        """Watermark-only advances at ``wm_ms`` until an advance fills fewer
        than F lanes (the reference's drain_fires)."""
        self.consume()
        wm = torch.tensor(self.wm_ticks(wm_ms), dtype=torch.int32,
                          device=self.device)
        F = self.spec.win.fires_per_step
        # compact rows go to the drain's arena slot 0: every drain's rows
        # were read by the consume above
        out = None if self.reduced else self.drain.arena_rows(0)
        while True:
            self.state, fires = fire_only(self.state, self.spec, wm,
                                          reduced=self.reduced, out=out)
            self.metrics.fire_steps += 1
            if int(self.emit(fires).reshape(-1)[0]) < F:
                return

    def emit(self, fires) -> np.ndarray:
        """Emit one [D, F] (or [F]) fire payload with one device->host read
        of its small fields (and, for rows, one more of the row prefixes).
        Returns n_fires per slot."""
        st = self.state
        small = torch.cat([
            fires.n_fires.reshape(-1).to(torch.float64),
            st.dropped_capacity.reshape(1).to(torch.float64),
            fires.counts.reshape(-1).to(torch.float64),
            fires.lane_valid.reshape(-1).to(torch.float64),
            fires.window_end_ticks.reshape(-1).to(torch.float64),
            fires.value_sums.reshape(-1).to(torch.float64),
        ]).cpu().numpy()
        n_slots = fires.n_fires.numel()
        F = self.spec.win.fires_per_step
        n_now = small[:n_slots].astype(np.int64)
        dropped = int(small[n_slots])
        counts, lanes, ends, vsums = (
            small[n_slots + 1:].reshape(4, n_slots, F))
        if dropped and self.spill:
            raise _unsupported(
                f"{dropped} records lost to state capacity: the spill "
                f"tier, which takes records whose key finds no state slot "
                f"(set state.backend.overflow-ring: 0 for strict capacity),",
                "ROADMAP queue 1, item 8")
        counts = (counts * lanes).astype(np.int64)
        if self.reduced:
            n = int(counts.sum())
            if n:
                self.metrics.fires += n
                for s in self.pipe.sinks:
                    s.invoke_reduced(n, float((vsums * lanes).sum()))
        elif counts.any():
            self.emit_rows(fires, counts, ends.astype(np.int64))
        return n_now

    def emit_rows(self, fires: wk.CompactFires, counts: np.ndarray,
                  ends: np.ndarray) -> None:
        """Read the ``[:count]`` row prefixes of every (slot, lane) in one
        batched read, then hand each slot's rows to the sinks."""
        n_slots, F = counts.shape
        khi = fires.key_hi.reshape(n_slots, F, -1)
        klo = fires.key_lo.reshape(n_slots, F, -1)
        vals = fires.values.reshape(n_slots, F, -1).view(torch.int32)
        parts = [(d, f, int(counts[d, f])) for d in range(n_slots)
                 for f in range(F) if counts[d, f]]
        rows = torch.cat([
            torch.cat([khi[d, f, :n], klo[d, f, :n], vals[d, f, :n]])
            for d, f, n in parts]).cpu().numpy()
        by_slot = {}
        at = 0
        for d, f, n in parts:
            r = rows[at:at + 3 * n]
            at += 3 * n
            by_slot.setdefault(d, []).append((
                r[:n].view(np.uint32), r[n:2 * n].view(np.uint32),
                r[2 * n:].view(np.float32),
                np.full(n, self.td.to_ms(int(ends[d, f])), np.int64)))
        for d in sorted(by_slot):
            self.emit_slot(*(np.concatenate(c) for c in zip(*by_slot[d])))

    def emit_slot(self, khi, klo, values, end_ms) -> None:
        n = len(values)
        self.metrics.fires += n
        if self.columnar:
            kid = (khi.astype(np.uint64) << np.uint64(32)) | klo.astype(
                np.uint64)
            cols = {"key_id": kid, "window_end_ms": end_ms, "value": values}
            for s in self.pipe.sinks:
                s.invoke_columnar(cols)
            return
        keys = self.codec.decode(khi, klo)
        out = [WindowResult(k, int(e), v) for k, e, v in
               zip(keys, end_ms.tolist(), values.tolist())]
        for s in self.pipe.sinks:
            s.invoke_batch(out)

    # -- end of job --------------------------------------------------------
    def finish(self, job_name: str) -> JobHandle:
        m = self.metrics
        st = self.state
        if st is not None:
            m.dropped_late = int(st.dropped_late)
            m.dropped_capacity = int(st.dropped_capacity)
            if m.dropped_capacity and self.env.config.get_bool(
                    "state.backend.strict-capacity", True):
                raise RuntimeError(
                    f"state backend over capacity: {m.dropped_capacity} "
                    f"records lost (raise state.backend.device.slots-per-"
                    f"shard or the pane ring, or set state.backend.strict-"
                    f"capacity to false to tolerate drops)")
        return JobHandle(job_name, m, state=st)
