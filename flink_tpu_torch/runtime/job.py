"""What every stage runner of the local executor shares: the poll loop,
key and value encoding, event-time timestamps, the sinks' output mode and
the end-of-job capacity check. ``runtime/executor.py``'s time-window job
and the session, count-window and rolling runners of
``runtime/keyed_jobs.py`` subclass ``StageJob``.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_tpu_torch.core.types import KeyCodec


def key_words(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) uint32 halves -> the uint64 key identities."""
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


class StageJob:
    """One run of one keyed stage. Subclasses give ``apply(cols, ts_ms)``
    for a non-empty polled batch, and may give ``idle()`` (the source had
    nothing new), ``end_of_stream()``, ``cycle_start()`` and
    ``cycle_end()``."""

    # appended to the strict-capacity error
    CAPACITY_HINT = ""

    def __init__(self, env, pipe, metrics, agg):
        self.env = env
        self.pipe = pipe
        self.metrics = metrics
        self.agg = agg
        self.device = torch.device(env.device)
        self.B = env.batch_size
        self.red = agg.reduce_spec_factory()
        # rows go as columns when every sink takes them
        self.columnar = all(getattr(s, "columnar", False) for s in pipe.sinks)
        # the reverse key map serves row decoding (and the checkpoints' key
        # map, which only row decoding reads back), so columnar-only jobs
        # skip its cost
        self.keep_reverse = (env.config.get_bool("keys.reverse-map", True)
                             and not self.columnar)
        self.codec = KeyCodec()
        self.state = None

    def run(self) -> None:
        pipe = self.pipe
        while True:
            self.cycle_start()
            (cols, ts_ms), end = pipe.source.poll(self.B)
            if cols and len(next(iter(cols.values()))):
                self.apply(cols, ts_ms)
            else:
                self.idle()
            self.cycle_end()
            if end:
                break
        self.end_of_stream()

    def apply(self, cols, ts_ms) -> None:
        raise NotImplementedError

    def idle(self) -> None:
        pass

    def cycle_start(self) -> None:
        """Before each poll: the cut between drains (tiered state)."""

    def cycle_end(self) -> None:
        """After each polled batch is applied (the checkpoint trigger)."""

    def end_of_stream(self) -> None:
        pass

    def encode(self, cols, count: bool = True):
        """A batch's keys (as polled), their (hi, lo) identities and the
        extractor's values: float32 ``[n, *value_shape]``, or what the
        stage's ``value_prep`` makes of them on the host (a sketch's uint32
        item hashes, the reference's ``value_prep`` at executor.py:5472);
        with ``count``, counts the records in (a window job counts them
        on the step loop, where it takes the prepped batch)."""
        keys = np.asarray(self.pipe.key_by.key_selector(cols))
        hi, lo = self.codec.encode(keys, keep_reverse=self.keep_reverse)
        prep = getattr(self.agg, "value_prep", None)
        if prep is not None:
            values = np.asarray(prep(self.agg.extractor(cols)))
            want = hi.shape
        else:
            values = np.asarray(self.agg.extractor(cols), np.float32)
            want = hi.shape + tuple(self.red.value_shape)
        if values.shape != want:
            raise ValueError(
                f"the extractor gave values of shape {values.shape} for "
                f"{len(hi)} keys; the stage's reduce takes {want}")
        if count:
            self.metrics.records_in += len(hi)
        return keys, hi, lo, values

    def event_ts(self, cols, ts_ms) -> np.ndarray:
        """The batch's event times in ms: the timestamp assigner's, else
        the source's."""
        if self.pipe.ts_transform is not None:
            ts_ms = self.pipe.ts_transform.timestamp_fn(cols)
        elif ts_ms is None:
            raise ValueError(
                "event-time job but the columnar source provides no "
                "timestamps and no assign_timestamps_and_watermarks is set")
        return np.asarray(ts_ms, np.int64)

    def sinks_columnar(self, cols) -> None:
        self.metrics.records_out += len(next(iter(cols.values())))
        for s in self.pipe.sinks:
            s.invoke_columnar(cols)

    def sinks_rows(self, rows) -> None:
        self.metrics.records_out += len(rows)
        for s in self.pipe.sinks:
            s.invoke_batch(rows)

    def loss_counters(self):
        """``(dropped_late, dropped_capacity)`` of the job's state, the
        first None where the state counts no late records."""
        st = self.state
        return (int(st.dropped_late) if hasattr(st, "dropped_late")
                else None, int(st.dropped_capacity))

    def finish(self) -> None:
        """Read the state's loss counters into the metrics; with strict
        capacity (the default) a record lost to capacity fails the job."""
        if self.state is None:
            return
        m = self.metrics
        late, m.dropped_capacity = self.loss_counters()
        if late is not None:
            m.dropped_late = late
        if m.dropped_capacity and self.env.config.get_bool(
                "state.backend.strict-capacity", True):
            raise RuntimeError(
                f"state backend over capacity: {m.dropped_capacity} "
                f"records lost{self.CAPACITY_HINT}")
