"""Sources — batched, replayable, checkpointable.

Contract redesign of the reference's SourceFunction (run(SourceContext) on a
dedicated thread, emitting under the checkpoint lock — SURVEY §2.5) for a
micro-batch world:

    poll(max_records) -> (elements | columns, end_of_stream)
    snapshot_offsets() / restore_offsets(state)   — exactly-once replay
                                                   (FlinkKafkaConsumerBase
                                                   offset pattern, §2.8)

Offsets snapshot at step boundaries (the barrier), so restore + replay
reproduces the exact same micro-batches — the TPU analog of barrier-aligned
exactly-once.

Two data modes: object mode (list of Python elements, general API) and
columnar mode (dict of numpy arrays + timestamps, the fast path).

This slice of the port carries the source contract, the element-mode
``CollectionSource`` behind ``from_collection`` / ``from_elements`` (a
copy of the reference's) and the columnar generator. The ring-buffer,
socket and native-parser sources wait for their slices (ROADMAP queue 1,
items 6 and 15).
"""

from __future__ import annotations

from typing import Any, List, Optional


class Source:
    columnar = False

    def open(self):  # lifecycle (RichFunction.open analog)
        pass

    def close(self):
        pass

    def poll(self, max_records: int):
        raise NotImplementedError

    def poll_with_offsets(self, max_records: int):
        """Poll one batch AND capture the post-poll offsets in one call:
        ``(polled, end, offsets)``. This is the unit a prefetched batch
        carries (runtime/ingest.py) — the offsets name the exact replay
        point *after* this batch, so a checkpoint that snapshots the
        offsets of the last applied batch restores without skipping or
        double-applying records, no matter how far the prefetch thread
        has polled ahead. The default composition is atomic for every
        source polled from a single thread (the ingest pipeline
        guarantees one producer); sources whose offsets can move outside
        ``poll()`` should override to make the pair atomic."""
        polled, end = self.poll(max_records)
        return polled, end, self.snapshot_offsets()

    # -- checkpointing --------------------------------------------------
    def snapshot_offsets(self):
        return None

    def restore_offsets(self, state):
        pass

    def notify_checkpoint_complete(self, checkpoint_id: int, offsets=None):
        """Called once a checkpoint containing `offsets` is durable — the
        point where offsets may be committed externally (ref
        FlinkKafkaConsumerBase.notifyCheckpointComplete:384)."""


class CollectionSource(Source):
    """from_collection: finite in-memory source with replayable position."""

    def __init__(self, elements: List[Any]):
        self.elements = list(elements)
        self.pos = 0

    def poll(self, max_records: int):
        chunk = self.elements[self.pos : self.pos + max_records]
        self.pos += len(chunk)
        return chunk, self.pos >= len(self.elements)

    def snapshot_offsets(self):
        return self.pos

    def restore_offsets(self, state):
        self.pos = int(state)


class ColumnarSource(Source):
    """Base for the fast path: poll returns (columns dict, ts_ms array, end)."""

    columnar = True


class GeneratorSource(ColumnarSource):
    """Deterministic replayable generator: fn(offset, n) -> (columns, ts_ms).

    The Kafka-analog used by benchmarks: offset-addressable, infinite or
    bounded, exactly-once via offset snapshot/restore.
    """

    def __init__(self, fn, total: Optional[int] = None):
        self.fn = fn
        self.total = total
        self.offset = 0

    def poll(self, max_records: int):
        n = max_records
        if self.total is not None:
            n = min(n, self.total - self.offset)
        if n <= 0:
            return ({}, None), True
        cols, ts = self.fn(self.offset, n)
        self.offset += n
        end = self.total is not None and self.offset >= self.total
        return (cols, ts), end

    def snapshot_offsets(self):
        return self.offset

    def restore_offsets(self, state):
        self.offset = int(state)


def snapshot_offsets(source):
    """``source.snapshot_offsets()``, or None for a source object that
    does not derive from ``Source`` and has none."""
    snap = getattr(source, "snapshot_offsets", None)
    return None if snap is None else snap()


def poll_with_offsets(source, max_records: int):
    """``source.poll_with_offsets(max_records)``; for a source object that
    does not derive from ``Source``, its poll and no offsets."""
    poll = getattr(source, "poll_with_offsets", None)
    if poll is not None:
        return poll(max_records)
    polled, end = source.poll(max_records)
    return polled, end, None


def replayable(source) -> bool:
    """Whether ``source`` can rewind to a checkpoint's cut: it snapshots
    a position (the reference's test, ``snapshot_offsets() is None`` for
    a source that cannot). The prefetch thread polls ahead of the cut
    only from such a source."""
    return snapshot_offsets(source) is not None
