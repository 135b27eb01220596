"""Runners for the keyed stages without a pane ring — rolling reduces,
count windows and event-time session windows — on one device: the
counterparts of flink_tpu/runtime/executor.py ``_run_rolling`` (:7096),
``_run_count`` (:7446) and ``_run_session`` (:7231), which
``runtime/executor.py`` dispatches to.

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
        self.state = step_mod.init_rolling_state(self.spec, self.device)
        self.step = step_mod.build_rolling_step(self.spec)

    def apply(self, cols, _ts_ms) -> None:
        keys, hi, lo, values = self.encode(cols)
        n = len(hi)
        hi_t, lo_t, v_t = self.lanes(hi, lo, values)
        valid = torch.ones(n, dtype=torch.bool, device=self.device)
        self.state, out, ok = self.step(self.state, hi_t, lo_t, v_t, valid)
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
        self.state = step_mod.init_count_state(self.spec, self.device)
        self.step = step_mod.build_count_step(self.spec)

    def apply(self, cols, _ts_ms) -> None:
        _keys, hi, lo, values = self.encode(cols)
        hi_t, lo_t, v_t = self.lanes(hi, lo, values)
        valid = torch.ones(len(hi), dtype=torch.bool, device=self.device)
        self.state, rows, n_rows = self.step(self.state, hi_t, lo_t, v_t,
                                             valid)
        self.metrics.steps += 1
        self.emitter.push((rows, n_rows))

    def emit(self, item) -> None:
        got = self.read_rows(*item)
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
        self.state = step_mod.init_session_state(self.spec, self.device)
        self.step = step_mod.build_session_step(self.spec)
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
        self.state, rows, n_rows = self.step(self.state, hi_t, lo_t, ts_t,
                                             v_t, valid, wm_t)
        self.metrics.steps += 1
        self.emitter.push((rows, n_rows))

    def end_of_stream(self) -> None:
        if self.td is None:
            return
        empty_u = np.zeros(0, np.uint32)
        self.run_once(empty_u, empty_u, np.zeros(0, np.int32),
                      np.zeros(0, np.float32),
                      int(self.td.to_ms(FINAL_WM_TICKS)))

    def emit(self, item) -> None:
        got = self.read_rows(*item)
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
