"""The poll loop and value encoding that every stage runner of the port
shares (``runtime/job.py``): the event-time tumbling window and the
session, count-window and rolling stages, each through the public API on
the CPU. A polled batch with no records between two with records changes
no row (the rows are compared exactly: every value is 1.0), and an
extractor that gives more than one value per record fails the job with
the same error in every stage.
"""

import numpy as np
import pytest

STAGES = ("tumbling", "session", "count", "rolling")
TOTAL, BATCH = 600, 128


class _Gaps:
    """A columnar source of TOTAL records, 3 per ms over 97 keys, that
    answers the third poll with an empty batch when ``gap`` is set."""

    columnar = True

    def __init__(self, gap):
        self.gap = gap
        self.offset = 0
        self.polls = 0

    def open(self):
        pass

    def close(self):
        pass

    def poll(self, max_records):
        self.polls += 1
        n = 0 if self.gap and self.polls == 3 else \
            min(max_records, TOTAL - self.offset)
        idx = np.arange(self.offset, self.offset + n, dtype=np.int64)
        self.offset += n
        cols = {"k": (idx * 7919) % 97, "v": np.ones(n, np.float32)}
        return (cols, idx // 3), self.offset >= TOTAL


def _run(stage, gap=False, values=lambda c: c["v"]):
    from flink_tpu_torch import StreamExecutionEnvironment
    from flink_tpu_torch.core.time import TimeCharacteristic
    from flink_tpu_torch.datastream.window.assigners import (
        EventTimeSessionWindows,
    )
    from flink_tpu_torch.runtime.sinks import ColumnarCollectSink

    env = StreamExecutionEnvironment(device="cpu")
    env.set_parallelism(1)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(256)
    env.batch_size = BATCH
    keyed = env.add_source(_Gaps(gap)).key_by(lambda c: c["k"])
    if stage == "tumbling":
        out = keyed.time_window(50).sum(values)
    elif stage == "session":
        out = keyed.window(EventTimeSessionWindows.with_gap(10)).sum(values)
    elif stage == "count":
        out = keyed.count_window(4).sum(values)
    else:
        out = keyed.sum(values)
    sink = ColumnarCollectSink()
    out.add_sink(sink)
    env.execute(stage)
    cols = sink.columns()
    names = sorted(cols)
    return names, sorted(zip(*(cols[n].tolist() for n in names)))


@pytest.mark.parametrize("stage", STAGES)
def test_an_empty_poll_changes_no_row(stage):
    names, rows = _run(stage)
    assert rows
    assert _run(stage, gap=True) == (names, rows)


@pytest.mark.parametrize("stage", STAGES)
def test_values_wider_than_one_per_record_fail_every_stage(stage):
    with pytest.raises(ValueError, match="the stage's reduce takes"):
        _run(stage, values=lambda c: np.stack([c["v"], c["v"]], axis=1))
