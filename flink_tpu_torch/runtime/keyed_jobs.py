"""Runners for the keyed stages without a pane ring — rolling reduces,
count windows and event-time session windows — on one device or over a
shard mesh: the counterparts of flink_tpu/runtime/executor.py
``_run_rolling`` (:7096), ``_run_count`` (:7446) and ``_run_session``
(:7231), which ``runtime/executor.py`` dispatches to.

At ``set_parallelism(n)`` a runner takes ``min(n, len(mesh_devices))``
shards, as the window job does: each shard owns a key-group range and
holds its state on its device, masks the replicated batch to its key
groups with G1 (``step.build_*_step_sharded``) and runs the one-shard
update. Rolling outputs merge through G27; count windows emit shard after
shard; sessions emit every shard's superseded open sessions, then every
shard's superseded batch sessions, then every shard's closes (the
reference's emission order, executor.py:7271-7310, 7472-7491).

Each runs ``source -> [assign timestamps] -> key_by -> stage -> sinks``
one step per polled batch: encode the keys (``KeyCodec``), copy the lanes
to the device, run the stage's step (``runtime/step.py``), and hand the
step's output handles to a ``_LaggedEmitter``, which reads them
``pipeline.max-inflight-steps`` steps later so that the read overlaps the
next steps. Rolling outputs come in input order, one per record; count
windows and sessions come as the rows their kernels compacted on the card
(G12, G11), read as the ``[:n_rows]`` prefixes. A sink that takes columns
gets ``{"key_id", "value"}`` (rolling), ``{"key_id", "window_end_ms",
"value"}`` (count windows; ``window_end_ms`` is the window's 0-based
ordinal within its key, as the reference's ``WindowResult`` carries it)
or ``{"key_id", "window_start_ms", "window_end_ms", "value"}`` (sessions);
any other sink gets the reference's rows: ``(key, value)`` tuples,
``WindowResult`` and ``SessionResult``.

At the end of the stream sessions close with a watermark of 2^31 - 4
ticks (the reference's flush, executor.py:7422-7430); the job then fails
with "state backend over capacity" if any record found no slot (strict
capacity, executor.py:7437-7443), as the reference's does: these stages
have no spill tier.
"""

from __future__ import annotations

from collections import deque, namedtuple
from typing import Optional

import numpy as np
import torch

from flink_tpu_torch.core.time import TimeDomain
from flink_tpu_torch.parallel.mesh import MeshContext, mesh_devices
from flink_tpu_torch.runtime import step as step_mod
from flink_tpu_torch.runtime.job import StageJob, key_words
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy

WindowResult = namedtuple("WindowResult", ["key", "window_end_ms", "value"])
SessionResult = namedtuple(
    "SessionResult", ["key", "window_start_ms", "window_end_ms", "value"])

# the reference's end-of-stream session flush, in ticks
FINAL_WM_TICKS = 2**31 - 4
WM_NONE = -(2**31) + 1


class _LaggedEmitter:
    """A copy of the reference's ``_LaggedEmitter`` (executor.py:98):
    up to ``lag`` steps' output handles are kept and read only when they
    fall out of the window, so the read overlaps the later dispatches.
    FIFO order is kept; ``lag == 0`` is synchronous. The reference's
    ``idle()``, which only drains, is left out: callers call ``drain()``."""

    CONFIG_KEY = "pipeline.max-inflight-steps"

    def __init__(self, env, emit_fn):
        self.lag = max(0, env.config.get_int(self.CONFIG_KEY, 4))
        self.emit_fn = emit_fn
        self._q = deque()

    def push(self, item):
        self._q.append(item)
        while len(self._q) > self.lag:
            self.emit_fn(self._q.popleft())

    def drain(self):
        while self._q:
            self.emit_fn(self._q.popleft())


class _KeyedJob(StageJob):
    """What the three runners add to ``StageJob``: lane staging, the
    lagged emitter, and the read of compacted rows."""

    def __init__(self, env, pipe, metrics, agg):
        super().__init__(env, pipe, metrics, agg)
        self.capacity = env.state_capacity_per_shard
        self.emitter = _LaggedEmitter(env, self.emit)
        # n shards as the window job takes them (executor.py:7107-7109)
        devs = mesh_devices(self.device)
        n = max(1, min(env.parallelism, len(devs)))
        self.ctx = MeshContext.create(n, env.max_parallelism, devices=devs)
        self.states = None

    @property
    def n_shards(self) -> int:
        return self.ctx.n_shards

    def init_states(self, init) -> None:
        """``init(device)`` a shard, on each shard's device."""
        self.states = [init(d) for d in self.ctx.devices]
        self.state = self.states[0]

    def loss_counters(self):
        """The shards' summed counters (``None`` late records where the
        state counts none)."""
        late = (sum(int(st.dropped_late) for st in self.states)
                if hasattr(self.states[0], "dropped_late") else None)
        return late, sum(int(st.dropped_capacity) for st in self.states)

    def lanes(self, *arrays):
        """Host lane arrays -> device tensors (uint32 halves as int32)."""
        out = []
        for a in arrays:
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            out.append(torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device, non_blocking=True))
        return out

    def run(self) -> None:
        super().run()
        self.emitter.drain()

    def idle(self) -> None:
        self.emitter.drain()      # an idle source must not withhold

    def read_rows(self, rows, n_rows):
        """The ``[:n]`` prefixes of int32 / float32 row buffers in one
        device-to-host read (two syncs: the count, then the rows)."""
        n = int(n_rows)
        if not n:
            return None
        raw = torch.cat([r[:n].view(torch.int32) for r in rows]).cpu()
        return raw.numpy().reshape(len(rows), n)

    def read_shard_rows(self, fires, cuts=None):
        """Every shard's row segments in two device-to-host reads (the
        counts, then the rows, on the first shard's device). ``fires[s]``
        is shard s's ``(rows, n_rows[, marks])``; ``cuts(counts)`` maps
        the read counts of shard s (n_rows, then the marks) to its
        segments ``[(start, end), ...]``. Returns the rows of every
        segment, grouped segment index first and shard second, as one
        int32 [len(rows), n] array, or None when no shard fired."""
        dev = self.ctx.devices[0]
        counts = torch.stack([torch.cat([f[1].reshape(1)] + [
            m.reshape(-1) for m in f[2:]]).to(dev) for f in fires]).cpu()
        counts = counts.numpy().astype(np.int64)
        segs = [cuts(c) if cuts is not None else [(0, int(c[0]))]
                for c in counts]
        order = [(s, a, b) for k in range(len(segs[0]))
                 for s, sg in enumerate(segs) for a, b in [sg[k]] if b > a]
        if not order:
            return None
        raw = torch.cat([torch.cat([r[a:b].view(torch.int32)
                                    for r in fires[s][0]]).to(dev)
                         for s, a, b in order]).cpu().numpy()
        width = len(fires[0][0])
        out, at = [], 0
        for _s, a, b in order:
            out.append(raw[at:at + width * (b - a)].reshape(width, b - a))
            at += width * (b - a)
        return np.concatenate(out, axis=1)


class RollingJob(_KeyedJob):
    """``key_by(...).sum(...)`` / ``.reduce(fn)``: every record emits its
    key's running sum or reduce (the reference's StreamGroupedReduce),
    through the stage's ``result_fn`` when it has one."""

    def __init__(self, env, pipe, metrics):
        super().__init__(env, pipe, metrics, pipe.rolling)
        self.result_fn = pipe.rolling.result_fn
        # rows carry the keys as polled, so no reverse map is needed
        self.keep_reverse = False
        self.spec = step_mod.RollingStageSpec(
            red=self.red, capacity_per_shard=self.capacity)
        # one shard runs the one-device step, more the masked steps and
        # G27's merge (step.build_rolling_step_sharded)
        self.init_states(lambda d: step_mod.init_rolling_state(self.spec, d))
        self.step = (step_mod.build_rolling_step(self.spec)
                     if self.n_shards == 1 else
                     step_mod.build_rolling_step_sharded(self.ctx,
                                                         self.spec))

    def apply(self, cols, _ts_ms) -> None:
        keys, hi, lo, values = self.encode(cols)
        n = len(hi)
        hi_t, lo_t, v_t = self.lanes(hi, lo, values)
        valid = torch.ones(n, dtype=torch.bool, device=self.device)
        if len(self.states) == 1:
            self.state, out, ok = self.step(self.state, hi_t, lo_t, v_t,
                                            valid)
        else:
            _states, out, ok = self.step(self.states, hi_t, lo_t, v_t,
                                         valid)
        self.metrics.steps += 1
        self.emitter.push((out, ok, keys, hi, lo))

    def emit(self, item) -> None:
        out, ok, keys, hi, lo = item
        raw = torch.cat([out.reshape(-1).view(torch.int32),
                         ok.to(torch.int32)]).cpu().numpy()
        out_np = raw[:out.numel()].view(np.float32).reshape(out.shape)
        ok_np = raw[out.numel():].astype(bool)
        if self.result_fn is not None:
            out_np = np.asarray(self.result_fn(out_np))
        if self.columnar:
            self.sinks_columnar({"key_id": key_words(hi, lo)[ok_np],
                                 "value": out_np[ok_np]})
            return
        klist = keys.tolist()
        self.sinks_rows([(k, v) for k, v, good in
                         zip(klist, out_np.tolist(), ok_np) if good])


class CountJob(_KeyedJob):
    """``count_window(N).sum(...)`` / ``.count()``: per-key tumbling
    windows of N elements."""

    def __init__(self, env, pipe, metrics):
        super().__init__(env, pipe, metrics, pipe.window_agg)
        self.spec = step_mod.CountStageSpec(
            red=self.red, n_per_window=pipe.window_agg.assigner.size_n,
            capacity_per_shard=self.capacity)
        self.init_states(lambda d: step_mod.init_count_state(self.spec, d))
        self.step = (step_mod.build_count_step(self.spec)
                     if self.n_shards == 1 else
                     step_mod.build_count_step_sharded(self.ctx, self.spec))

    def apply(self, cols, _ts_ms) -> None:
        _keys, hi, lo, values = self.encode(cols)
        hi_t, lo_t, v_t = self.lanes(hi, lo, values)
        valid = torch.ones(len(hi), dtype=torch.bool, device=self.device)
        if self.n_shards == 1:
            self.state, rows, n_rows = self.step(self.state, hi_t, lo_t,
                                                 v_t, valid)
            fires = [(rows, n_rows)]
        else:
            _states, fires = self.step(self.states, hi_t, lo_t, v_t, valid)
        self.metrics.steps += 1
        self.emitter.push(fires)

    def emit(self, fires) -> None:
        got = (self.read_rows(*fires[0]) if len(fires) == 1
               else self.read_shard_rows(fires))
        if got is None:
            return
        hi, lo, w, val = got
        hi, lo = hi.view(np.uint32), lo.view(np.uint32)
        val = val.view(np.float32)
        self.metrics.fires += len(val)
        if self.columnar:
            self.sinks_columnar({"key_id": key_words(hi, lo),
                                 "window_end_ms": w.astype(np.int64),
                                 "value": val})
            return
        keys = self.codec.decode(hi, lo)
        self.sinks_rows([WindowResult(k, int(wi), v) for k, wi, v in
                         zip(keys, w.tolist(), val.tolist())])


class SessionJob(_KeyedJob):
    """``window(EventTimeSessionWindows.with_gap(g)).sum(...)`` /
    ``.count()``: gap-merged session windows in event time."""

    def __init__(self, env, pipe, metrics):
        super().__init__(env, pipe, metrics, pipe.window_agg)
        self.spec = step_mod.SessionStageSpec(
            red=self.red, gap_ticks=pipe.window_agg.assigner.gap_ms,
            capacity_per_shard=self.capacity)
        self.init_states(
            lambda d: step_mod.init_session_state(self.spec, d))
        self.step = (step_mod.build_session_step(self.spec)
                     if self.n_shards == 1 else
                     step_mod.build_session_step_sharded(self.ctx,
                                                         self.spec))
        self.wm_strategy = (
            pipe.ts_transform.strategy if pipe.ts_transform is not None
            else WatermarkStrategy.for_monotonous_timestamps())
        self.td: Optional[TimeDomain] = None

    def apply(self, cols, ts_ms) -> None:
        _keys, hi, lo, values = self.encode(cols)
        ts_ms = self.event_ts(cols, ts_ms)
        if self.td is None:
            self.td = TimeDomain(origin_ms=int(ts_ms.min()), ms_per_tick=1)
        wm_ms = self.wm_strategy.on_batch(int(ts_ms.max()))
        self.run_once(hi, lo, self.td.to_ticks(ts_ms), values, wm_ms)

    def run_once(self, hi, lo, ticks, values, wm_ms) -> None:
        wm = (min(int(self.td.to_ticks(wm_ms)), FINAL_WM_TICKS)
              if wm_ms is not None else WM_NONE)
        hi_t, lo_t, ts_t, v_t = self.lanes(hi, lo, ticks, values)
        valid = torch.ones(len(hi), dtype=torch.bool, device=self.device)
        wm_t = torch.tensor(wm, dtype=torch.int32, device=self.device)
        if self.n_shards == 1:
            self.state, rows, n_rows = self.step(self.state, hi_t, lo_t,
                                                 ts_t, v_t, valid, wm_t)
            fires = [(rows, n_rows)]
        else:
            _states, fires = self.step(self.states, hi_t, lo_t, ts_t, v_t,
                                       valid, wm_t)
        self.metrics.steps += 1
        self.emitter.push(fires)

    def end_of_stream(self) -> None:
        if self.td is None:
            return
        empty_u = np.zeros(0, np.uint32)
        self.run_once(empty_u, empty_u, np.zeros(0, np.int32),
                      np.zeros(0, np.float32),
                      int(self.td.to_ms(FINAL_WM_TICKS)))

    @staticmethod
    def _kinds(counts):
        """A shard's three row segments from its (n_rows, marks): the
        superseded open sessions, the superseded batch sessions, the
        closes."""
        n, m0, m1 = (int(c) for c in counts)
        return [(0, m0), (m0, m1), (m1, n)]

    def emit(self, fires) -> None:
        got = (self.read_rows(*fires[0][:2]) if len(fires) == 1
               else self.read_shard_rows(fires, self._kinds))
        if got is None:
            return
        hi, lo, start, end, val = got
        hi, lo = hi.view(np.uint32), lo.view(np.uint32)
        val = val.view(np.float32)
        start_ms = self.td.to_ms(start)
        end_ms = self.td.to_ms(end)
        self.metrics.fires += len(val)
        if self.columnar:
            self.sinks_columnar({"key_id": key_words(hi, lo),
                                 "window_start_ms": start_ms,
                                 "window_end_ms": end_ms, "value": val})
            return
        keys = self.codec.decode(hi, lo)
        self.sinks_rows([SessionResult(k, int(s), int(e), v) for k, s, e, v
                         in zip(keys, start_ms.tolist(), end_ms.tolist(),
                                val.tolist())])
