"""Sinks (ref: api/functions/sink — print/socket/write/collect).

The port carries the sink contract, CountingSink (the north-star job's
device-reduce sink), CollectSink (the reference's rows) and
ColumnarCollectSink (every row as columns). A window stage reduces its
fires on the device when every sink is a device-reduce sink, and otherwise
emits one row per fired (key, window) through ``invoke_columnar`` or
``invoke_batch`` (runtime/executor.py). The rows a CollectSink gets are
the reference's: ``WindowResult(key, window_end_ms, value)`` for time and
count windows (a count window's ``window_end_ms`` is its 0-based ordinal
within the key), ``SessionResult(key, window_start_ms, window_end_ms,
value)`` for sessions, and ``(key, value)`` for rolling reduces, one per
record in input order (runtime/keyed_jobs.py). A sketch window's value is
HyperLogLog's float estimate or a Count-Min vector: a list in a
``WindowResult`` (the Q query estimates, or the raw registers), an
``[n, Q]`` array in a columnar ``value`` column; a device-reduce sink's
value sum adds every element.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


class Sink:
    #: set True when invoke_columnar is overridden (vectorized fast path)
    columnar = False
    #: set True when the sink only consumes per-emission AGGREGATES
    #: (count, value sum) and therefore never needs the fired keys/values
    #: transferred off-device. The executor then reduces window fires
    #: on-chip and delivers two scalars per drain instead of O(fires)
    #: bytes over the (slow) device->host link — the TPU-native analog of
    #: a pre-aggregating sink. invoke_reduced() receives the aggregates.
    device_reduce = False

    def open(self):
        pass

    def invoke_batch(self, elements: List[Any]):
        raise NotImplementedError

    def invoke_columnar(self, cols: dict):
        """Vectorized delivery: dict of equal-length numpy arrays."""
        names = list(cols)
        self.invoke_batch(list(zip(*[cols[n] for n in names])))

    def close(self):
        pass

    # -- exactly-once hooks (ref CheckpointedFunction on sinks, e.g.
    # BucketingSink.snapshotState / notifyCheckpointComplete) ------------
    def snapshot_state(self):
        return None

    def restore_state(self, state):
        pass

    def notify_checkpoint_complete(self, checkpoint_id: int):
        pass


class CountingSink(Sink):
    """Benchmark sink: O(1) per batch, tallies count and value sum.

    device_reduce: fired (key, window, value) rows are reduced on-chip and
    only (n, value_sum) cross the wire per drain — results identical to
    the columnar path, minus the per-row transfer."""

    columnar = True
    device_reduce = True

    def __init__(self):
        self.count = 0
        self.value_sum = 0.0

    def invoke_batch(self, elements):
        self.count += len(elements)
        for e in elements:
            v = e[-1] if isinstance(e, tuple) else getattr(e, "value", 0.0)
            self.value_sum += float(np.sum(v))

    def invoke_columnar(self, cols):
        self.count += len(cols["value"])
        self.value_sum += float(np.sum(cols["value"]))

    def invoke_reduced(self, n: int, value_sum: float):
        self.count += int(n)
        self.value_sum += float(value_sum)


class CollectSink(Sink):
    """Test sink gathering all outputs (ref test-utils collect pattern)."""

    def __init__(self):
        self.results: List[Any] = []

    def invoke_batch(self, elements):
        self.results.extend(elements)


class ColumnarCollectSink(Sink):
    """Keeps every row it is given, as columns: a window stage hands it
    ``{"key_id", "window_end_ms", "value"}`` arrays (key_id the uint64 key
    identity; value ``[n]``, or ``[n, Q]`` for a vector value), a session
    stage ``{"key_id", "window_start_ms",
    "window_end_ms", "value"}``, a rolling stage ``{"key_id", "value"}``;
    ``columns()`` joins them."""

    columnar = True

    def __init__(self):
        self.parts: List[Dict[str, np.ndarray]] = []

    def invoke_columnar(self, cols):
        self.parts.append({k: np.asarray(v) for k, v in cols.items()})

    def columns(self) -> Dict[str, np.ndarray]:
        if not self.parts:
            return {}
        return {k: np.concatenate([p[k] for p in self.parts])
                for k in self.parts[0]}
