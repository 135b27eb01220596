"""DataStream API — the fluent user surface (the main-path subset of
flink_tpu/datastream/datastream.py).

Same shape as the reference (DataStream / KeyedStream / WindowedStream):
API calls record transformation nodes that ``env.execute()`` runs. The
port carries ``key_by``, ``time_window`` / ``window`` (tumbling, sliding
and event-time session assigners), ``count_window``, the window ``sum``,
``count``, ``min``, ``max``, ``mean``, ``reduce`` and ``aggregate``, the
sketch windows ``distinct_count`` (HyperLogLog) and ``count_min``, the
rolling ``KeyedStream.sum`` and ``KeyedStream.reduce``,
``allowed_lateness``, ``add_sink``, ``assign_timestamps_and_watermarks``
and, for ``CEP.pattern(...).select`` / ``flat_select``, the
``KeyedStream.process`` of a ``CEPProcessFunction``. A ``reduce``'s function is an
associative callable on torch tensors, as the reference's is on jnp
arrays. Every other method
of the reference exists and raises NotImplementedError naming the ROADMAP
item that brings it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from flink_tpu_torch.datastream.window.assigners import (
    CountWindowAssigner,
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.graph import stream_graph as sg
from flink_tpu_torch.ops import sketches as sk
from flink_tpu_torch.ops.window_kernels import ReduceSpec
from flink_tpu_torch.runtime import sinks as sink_mod
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy


def _field_extractor(pos):
    if callable(pos):
        return pos
    if isinstance(pos, (int, str)):
        return lambda e: e[pos]
    raise TypeError(f"cannot extract field {pos!r}")


def _later(owner: str, name: str, item: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"{owner}.{name} is not ported to flink_tpu_torch yet ({item})")
    method.__name__ = name
    return method


_OPS = "ROADMAP queue 1, item 9"
_MULTI = "ROADMAP queue 1, item 12"
_EDGES = "ROADMAP queue 1, item 15"


class DataStream:
    def __init__(self, env, transformation: sg.Transformation):
        self.env = env
        self.transformation = transformation

    def assign_timestamps_and_watermarks(
        self, timestamp_fn: Callable, strategy: Optional[WatermarkStrategy] = None
    ) -> "DataStream":
        t = sg.TimestampsWatermarksTransformation(
            "timestamps", self.transformation,
            timestamp_fn=timestamp_fn,
            strategy=strategy or WatermarkStrategy.for_monotonous_timestamps(),
        )
        return DataStream(self.env, t)

    def key_by(self, selector) -> "KeyedStream":
        t = sg.KeyByTransformation(
            "key_by", self.transformation, key_selector=_field_extractor(selector)
        )
        return KeyedStream(self.env, t)

    def add_sink(self, sink) -> "DataStream":
        if not isinstance(sink, sink_mod.Sink):
            raise NotImplementedError(
                f"function sinks are not ported to flink_tpu_torch yet "
                f"({_EDGES})")
        t = sg.SinkTransformation("sink", self.transformation, sink=sink)
        self.env._sinks.append(t)
        return DataStream(self.env, t)

    map = _later("DataStream", "map", _OPS)
    filter = _later("DataStream", "filter", _OPS)
    flat_map = _later("DataStream", "flat_map", _OPS)
    union = _later("DataStream", "union", _OPS)
    connect = _later("DataStream", "connect", _MULTI)
    join = _later("DataStream", "join", _OPS)
    co_group = _later("DataStream", "co_group", _OPS)
    split = _later("DataStream", "split", _OPS)
    iterate = _later("DataStream", "iterate", _OPS)
    broadcast = _later("DataStream", "broadcast", _MULTI)
    rebalance = _later("DataStream", "rebalance", _MULTI)
    rescale = _later("DataStream", "rescale", _MULTI)
    shuffle = _later("DataStream", "shuffle", _MULTI)
    global_ = _later("DataStream", "global_", _MULTI)
    forward = _later("DataStream", "forward", _MULTI)
    print_ = _later("DataStream", "print_", _EDGES)
    write_as_text = _later("DataStream", "write_as_text", _EDGES)


class KeyedStream(DataStream):
    def window(self, assigner) -> "WindowedStream":
        return WindowedStream(self.env, self, assigner)

    def time_window(self, size_ms: int, slide_ms: Optional[int] = None):
        if slide_ms is None:
            return self.window(TumblingEventTimeWindows.of(size_ms))
        return self.window(SlidingEventTimeWindows.of(size_ms, slide_ms))

    def count_window(self, size: int) -> "WindowedStream":
        """Per-key tumbling windows of ``size`` elements (the reference's
        ``count_window``, which takes no slide)."""
        return self.window(CountWindowAssigner(size))

    def sum(self, pos=None) -> DataStream:
        """Rolling sum per key (ref StreamGroupedReduce): every record
        emits its key's running sum."""
        t = sg.KeyedProcessTransformation(
            "rolling_sum", self.transformation,
            reduce_spec_factory=lambda: ReduceSpec("sum", torch.float32),
            extractor=_field_extractor(pos) if pos is not None
            else (lambda e: e),
        )
        return DataStream(self.env, t)

    def reduce(self, fn: Callable, extractor=None, neutral=0.0,
               dtype=torch.float32) -> DataStream:
        """Rolling reduce per key (ref StreamGroupedReduce): emits the
        updated accumulator for every input record. ``fn`` combines two
        float32 tensors associatively; ``neutral`` is its identity."""
        t = sg.KeyedProcessTransformation(
            "rolling_reduce", self.transformation,
            reduce_spec_factory=lambda: ReduceSpec(
                "generic", dtype, combine=fn, neutral=neutral),
            extractor=_field_extractor(extractor) if extractor is not None
            else (lambda e: e),
        )
        return DataStream(self.env, t)

    def process(self, fn) -> DataStream:
        """A keyed ProcessFunction stage. The port runs the one that
        ``CEP.pattern(...).select`` / ``flat_select`` builds (a
        ``CEPProcessFunction``, on the device CEP path); any other function
        raises (ROADMAP queue 1, item 9)."""
        from flink_tpu_torch.cep.operator import CEPProcessFunction

        if not isinstance(fn, CEPProcessFunction):
            raise NotImplementedError(
                f"KeyedStream.process with {type(fn).__name__} is not "
                f"ported to flink_tpu_torch yet ({_OPS})")
        t = sg.ProcessTransformation("process", self.transformation, fn=fn)
        return DataStream(self.env, t)

    as_queryable_state = _later("KeyedStream", "as_queryable_state", _EDGES)


class WindowedStream:
    def __init__(self, env, keyed: KeyedStream, assigner):
        self.env = env
        self.keyed = keyed
        self.assigner = assigner
        self._lateness_ms = 0

    def allowed_lateness(self, ms: int) -> "WindowedStream":
        self._lateness_ms = ms
        return self

    def _agg(self, name, spec_factory, extractor, result_fn=None,
             value_prep=None) -> DataStream:
        t = sg.WindowAggTransformation(
            name, self.keyed.transformation,
            assigner=self.assigner,
            extractor=extractor,
            reduce_spec_factory=spec_factory,
            result_fn=result_fn,
            value_prep=value_prep,
            allowed_lateness_ms=self._lateness_ms,
        )
        return DataStream(self.env, t)

    def sum(self, pos=None, dtype=torch.float32) -> DataStream:
        return self._agg(
            "window_sum",
            lambda: ReduceSpec("sum", dtype),
            _field_extractor(pos) if pos is not None else (lambda e: e),
        )

    def min(self, pos=None, dtype=torch.float32) -> DataStream:
        return self._agg(
            "window_min", lambda: ReduceSpec("min", dtype),
            _field_extractor(pos) if pos is not None else (lambda e: e),
        )

    def max(self, pos=None, dtype=torch.float32) -> DataStream:
        return self._agg(
            "window_max", lambda: ReduceSpec("max", dtype),
            _field_extractor(pos) if pos is not None else (lambda e: e),
        )

    def count(self) -> DataStream:
        def ones(e):
            # columnar batches need a per-lane column; scalar per element
            if isinstance(e, dict):
                n = len(next(iter(e.values())))
                return np.ones(n, np.float32)
            return 1.0

        return self._agg(
            "window_count", lambda: ReduceSpec("count", torch.float32), ones,
        )

    def mean(self, pos=None) -> DataStream:
        """sum+count composite accumulator, host-side divide at fire. The
        extractor pairs each value with 1.0 — for a columnar batch, its
        value column with a column of ones, ``[n, 2]``."""
        get = _field_extractor(pos) if pos is not None else (lambda e: e)

        def extractor(e):
            v = np.asarray(get(e), np.float32)
            return np.stack([v, np.ones_like(v)], axis=-1)

        return self._agg(
            "window_mean",
            lambda: ReduceSpec("sum", torch.float32, value_shape=(2,)),
            extractor,
            result_fn=lambda acc: acc[..., 0] / np.maximum(acc[..., 1], 1.0),
        )

    def reduce(self, fn: Callable, extractor=None, neutral=0.0,
               dtype=torch.float32, value_shape=()) -> DataStream:
        """General associative reduce. ``fn`` combines two float32 torch
        tensors ``[..., *value_shape]``; ``neutral`` is its identity; for
        arbitrary element types provide ``extractor`` (element -> array)
        and a result projection via ``.aggregate()``."""
        return self._agg(
            "window_reduce",
            lambda: ReduceSpec("generic", dtype, tuple(value_shape),
                               combine=fn, neutral=neutral),
            _field_extractor(extractor) if extractor is not None
            else (lambda e: e),
        )

    def aggregate(self, agg_fn) -> DataStream:
        """AggregateFunction contract (add/merge/get_result) — ref
        AggregatingState. agg_fn: state.AggregatingStateDescriptor or any
        object with .to_reduce_spec(), .extractor, .get_result."""
        return self._agg(
            "window_aggregate",
            agg_fn.to_reduce_spec,
            getattr(agg_fn, "extractor", lambda e: e),
            result_fn=getattr(agg_fn, "get_result", None),
        )

    def distinct_count(self, pos=None, precision: int = 12) -> DataStream:
        """Approximate per-key distinct count of the extracted item per
        window via a HyperLogLog register array in device state (BASELINE
        config #3). Emits a float estimate per key per window."""
        def factory(p=precision):
            h = sk.HyperLogLog(p)
            return ReduceSpec(
                "sketch", h.dtype, h.value_shape, sketch=h,
                finalize=h.finalize, result_shape=h.result_shape,
                result_dtype=h.result_dtype,
            )

        return self._agg(
            "window_hll",
            factory,
            _field_extractor(pos) if pos is not None else (lambda e: e),
            value_prep=sk.hash32_host,
        )

    def count_min(self, pos=None, depth: int = 4, width: int = 1024,
                  query=None) -> DataStream:
        """Per-key Count-Min sketch of the extracted items per window
        (BASELINE config #3). With `query` (a fixed item list) each fire
        emits the Q point estimates; otherwise the raw depth*width register
        vector (queryable via CountMinSketch.estimate_np)."""
        def factory(d=depth, w=width, q=query):
            cms = sk.CountMinSketch(d, w, query=q)
            kwargs = dict(sketch=cms)
            if q is not None:
                kwargs.update(finalize=cms.finalize,
                              result_shape=cms.result_shape,
                              result_dtype=cms.result_dtype)
            return ReduceSpec("sketch", cms.dtype, cms.value_shape, **kwargs)

        return self._agg(
            "window_cms",
            factory,
            _field_extractor(pos) if pos is not None else (lambda e: e),
            value_prep=sk.hash32_host,
        )

    trigger = _later("WindowedStream", "trigger", _OPS)
    evictor = _later("WindowedStream", "evictor", _OPS)
    apply = _later("WindowedStream", "apply", _OPS)
    fold = _later("WindowedStream", "fold", _OPS)
