"""The device CEP job on one card — the counterpart of
flink_tpu/runtime/executor.py ``_run_cep_device`` (:6541-6822), which
``runtime/executor.py`` dispatches ``CEP.pattern(...).select`` /
``flat_select`` to.

It runs ``source -> [assign timestamps] -> [key_by] -> CEP -> sinks``:
poll the source (element mode, or a columnar source's rows as tuples
through ``runtime/union.py to_elements``), key each element, and hand
micro-batches to ``cep/accel.py DeviceCepOperator``, whose count NFA runs
on the card and whose host replay extracts the matches; each batch's
matches go through the select function to the sinks' ``invoke_batch``.

* Processing time: one step per polled batch, its within() pane from the
  wall clock.
* Event time: a host reorder buffer fronts the operator, as the
  reference's heap does. Each polled batch is buffered with its
  timestamps; the watermark (``WatermarkStrategy.on_batch``) releases the
  ripe prefix in (timestamp, arrival) order, cut into within() pane groups
  and each group into chunks of ``batch_size``; a chunk's pane is that of
  its first event. These are the reference's cuts, so within() expires
  exactly as it does there; the reference pads each chunk to
  ``batch_size`` for XLA's shapes, the port does not. End of stream
  releases everything.
* Every 64 polled batches ``prune_dead_keys`` drains the unflagged keys'
  buffers; any match it finds is emitted, never swallowed.

At the end ``JobMetrics`` gets ``cep_engine = "device"``, the device steps,
the matches detected on the card and extracted on the host, and the
records lost to capacity. Nothing else is refused here: the executor's
``_translate`` and ``LocalExecutor.run`` raise for what the slice does not
carry (the host NFA path, checkpoints, parallelism above 1).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from flink_tpu_torch.cep.accel import DeviceCepOperator
from flink_tpu_torch.runtime.union import to_elements
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy

# prune the host buffers every this many polled batches (the reference's)
PRUNE_EVERY = 64
END_OF_STREAM_MS = 2**62


class ReorderBuffer:
    """Buffered events in (timestamp, arrival) order — the order of the
    reference's ``(ts, seq)`` heap — with a vectorised sort per push."""

    def __init__(self):
        self.ts = np.zeros(0, np.int64)
        self.keys: list = []
        self.elements: list = []

    def __len__(self) -> int:
        return len(self.keys)

    def push(self, ts: np.ndarray, keys: list, elements: list) -> None:
        # the buffer is sorted and older than every new event, so a stable
        # sort on the timestamps keeps (timestamp, arrival) order
        all_ts = np.concatenate([self.ts, ts])
        order = np.argsort(all_ts, kind="stable").tolist()
        keys, elements = self.keys + keys, self.elements + elements
        self.ts = all_ts[order]
        self.keys = [keys[i] for i in order]
        self.elements = [elements[i] for i in order]

    def release(self, bound: int):
        """Every event with timestamp <= bound, in order: (ts, keys,
        elements)."""
        n = int(np.searchsorted(self.ts, bound, side="right"))
        out = (self.ts[:n], self.keys[:n], self.elements[:n])
        self.ts, self.keys = self.ts[n:], self.keys[n:]
        self.elements = self.elements[n:]
        return out


class CepJob:
    def __init__(self, env, pipe, metrics):
        self.env = env
        self.pipe = pipe
        self.metrics = metrics
        fn = pipe.process.fn
        self.op = DeviceCepOperator(
            fn.pattern,
            capacity=env.state_capacity_per_shard or (1 << 16),
            within_buckets=env.config.get_int("cep.device.within-buckets", 8),
            max_parallelism=env.max_parallelism,
            device=env.device,
        )
        metrics.cep_engine = "device"
        self.select_fn = fn.select_fn
        self.flat = fn.flat
        self.event_time = fn.event_time
        self.key_selector = pipe.key_by.key_selector
        ts_t = pipe.ts_transform
        self.ts_fn = ts_t.timestamp_fn if ts_t is not None else None
        self.wm_strategy = (ts_t.strategy if ts_t is not None else
                            WatermarkStrategy.for_monotonous_timestamps())
        self.pending = ReorderBuffer()

    @property
    def state(self):
        return self.op.state

    def run(self) -> None:
        env, pipe, op, m = self.env, self.pipe, self.op, self.metrics
        end = False
        n_batches = 0
        while not end:
            n_batches += 1
            polled, end = pipe.source.poll(env.batch_size)
            elements = to_elements(polled)
            if not elements:
                if end and self.event_time and len(self.pending):
                    self.emit(self.feed(self.pending.release(
                        END_OF_STREAM_MS)))
                continue
            m.records_in += len(elements)
            keys = [self.key_selector(e) for e in elements]
            if self.event_time:
                ts = np.fromiter((int(self.ts_fn(e)) for e in elements),
                                 np.int64, count=len(elements))
                self.pending.push(ts, keys, list(elements))
                wm = self.wm_strategy.on_batch(int(ts.max()))
                matches = self.feed(self.pending.release(
                    END_OF_STREAM_MS if end else wm))
            else:
                matches = op.process_batch(elements, keys,
                                           int(time.time() * 1000))
                m.steps += 1
            if n_batches % PRUNE_EVERY == 0:
                # matches here would be a count / extraction skew: emitted,
                # not swallowed, before the batch's own
                pruned = op.prune_dead_keys()
                if pruned:
                    self.emit(pruned)
            if matches:
                self.emit(matches)

    def feed(self, released) -> List[dict]:
        """Released events to the operator: within() pane groups (one group
        without within), each cut into chunks of ``batch_size``."""
        ts, keys, elements = released
        pane_ms = self.op.spec.pane_ms
        bs = max(1, self.env.batch_size)
        matches: List[dict] = []
        i, n = 0, len(keys)
        while i < n:
            if pane_ms:
                nxt = (int(ts[i]) // pane_ms + 1) * pane_ms
                j = int(np.searchsorted(ts, nxt, side="left"))
            else:
                j = n
            for off in range(i, j, bs):
                hi_off = min(off + bs, j)
                matches += self.op.process_batch(
                    elements[off:hi_off], keys[off:hi_off], int(ts[off]))
                self.metrics.steps += 1
            i = j
        return matches

    def emit(self, matches: List[dict]) -> None:
        fn = self.select_fn
        out = ([r for mt in matches for r in fn(mt)] if self.flat
               else [fn(mt) for mt in matches])
        for s in self.pipe.sinks:
            s.invoke_batch(out)

    def finish(self) -> None:
        # end of stream: live partials die (a match emits the moment it
        # completes; there is nothing to flush)
        m, op = self.metrics, self.op
        m.cep_device_steps = op.steps
        m.cep_matches_detected = op.matches_detected
        m.cep_matches_extracted = op.matches_extracted
        m.dropped_capacity += op.dropped_capacity
