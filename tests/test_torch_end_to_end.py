"""The north-star job through both packages' public APIs on the CPU.

bench.py's generator rescaled to 2,048 keys at 20 events/ms: 5 s tumbling
windows, ~3 windows of data. The JAX reference runs on the CPU mesh with
parallelism 1 (the conftest mesh has 8 virtual devices) and the gated
knobs forced as on an accelerator; the port runs with device="cpu".
CountingSink.count and value_sum must be identical on both and equal a
numpy group-by. Every value is 1.0, so the sums are exact.
"""

import numpy as np
import pytest

N_KEYS, EVENTS_PER_MS, WINDOW_MS = 2048, 20, 5000
TOTAL = 3 * WINDOW_MS * EVENTS_PER_MS + 777
BATCH = 4096
CONFIG = {
    "keys.reverse-map": False,
    "window.fires-per-step": 2,
    "pipeline.update-precombine": "on",
    "state.packed-planes": "on",
    "pipeline.resident-loop": "on",
    "pipeline.ring-depth": 4,
    "state.backend.overflow-ring": 0,
}


def gen_batch(offset, n, bad_key_at=None):
    """bench.py's gen_batch formula; optionally one key past capacity."""
    idx = np.arange(offset, offset + n, dtype=np.int64)
    keys = (idx * 2862933555777941757) % N_KEYS
    if bad_key_at is not None:
        keys[(idx == bad_key_at)] = N_KEYS + 5
    return {"key": keys, "value": np.ones(n, np.float32)}, idx // EVENTS_PER_MS


def reference(total, size_ms=WINDOW_MS, slide_ms=WINDOW_MS):
    """(key, window) pairs a sliding/tumbling window emits, and the sum of
    every emitted window's value (each event counts once per window)."""
    idx = np.arange(total, dtype=np.int64)
    keys = (idx * 2862933555777941757) % N_KEYS
    ts = idx // EVENTS_PER_MS
    pairs = set()
    value_sum = 0
    for j in range(size_ms // slide_ms):
        start = (ts // slide_ms - j) * slide_ms
        pairs |= set(zip(keys.tolist(), start.tolist()))
        value_sum += total
    return len(pairs), float(value_sum)


def run_job(pkg, total=TOTAL, bad_key_at=None, slide_ms=None, count=False,
            config=None):
    if pkg == "jax":
        from flink_tpu import StreamExecutionEnvironment
        from flink_tpu.core.config import Configuration
        from flink_tpu.core.time import TimeCharacteristic
        from flink_tpu.runtime.sinks import CountingSink
        from flink_tpu.runtime.sources import GeneratorSource
        kw = {}
    else:
        from flink_tpu_torch import StreamExecutionEnvironment
        from flink_tpu_torch.core.config import Configuration
        from flink_tpu_torch.core.time import TimeCharacteristic
        from flink_tpu_torch.runtime.sinks import CountingSink
        from flink_tpu_torch.runtime.sources import GeneratorSource
        kw = {"device": "cpu"}
    env = StreamExecutionEnvironment(
        Configuration(dict(CONFIG, **(config or {}))), **kw)
    env.set_parallelism(1)
    env.set_max_parallelism(128)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(N_KEYS)
    env.batch_size = BATCH
    sink = CountingSink()
    windowed = (
        env.add_source(GeneratorSource(
            lambda o, n: gen_batch(o, n, bad_key_at), total=total))
        .key_by(lambda c: c["key"])
        .time_window(WINDOW_MS, slide_ms)
    )
    agg = windowed.count() if count else windowed.sum(lambda c: c["value"])
    agg.add_sink(sink)
    job = env.execute("north-star")
    return sink, job


def test_north_star_job_matches_reference_and_numpy():
    want_count, want_sum = reference(TOTAL)
    ref_sink, _ = run_job("jax")
    port_sink, job = run_job("torch")
    assert (port_sink.count, port_sink.value_sum) == (
        ref_sink.count, ref_sink.value_sum)
    assert (port_sink.count, port_sink.value_sum) == (want_count, want_sum)
    m = job.metrics
    assert m.records_in == TOTAL and m.fires == want_count
    assert m.resident_drains > 1 and m.dropped_capacity == 0


def test_key_past_capacity_raises_on_both():
    for pkg in ("jax", "torch"):
        with pytest.raises(RuntimeError, match="state backend over capacity"):
            run_job(pkg, total=3 * BATCH, bad_key_at=2 * BATCH + 7)


@pytest.mark.parametrize("slide_ms,count", [(None, True), (2500, False),
                                            (1000, True)])
def test_port_windows_match_numpy(slide_ms, count):
    """Tumbling count and sliding sum/count (k = 2 and k = 5 panes)."""
    want_count, want_sum = reference(TOTAL, WINDOW_MS, slide_ms or WINDOW_MS)
    sink, _ = run_job("torch", slide_ms=slide_ms, count=count)
    assert (sink.count, sink.value_sum) == (want_count, want_sum)


def test_time_jump_between_polls_fires_before_rotating():
    """A poll that jumps many panes past the ring still emits every window
    (the pre-fire guard), and a batch spanning more panes than the ring is
    cut into groups — both exactly as the numpy group-by says."""
    def gen(offset, n):
        cols, ts = gen_batch(offset, n)
        idx = np.arange(offset, offset + n)
        ts = np.where(idx >= BATCH, ts + 60_000, ts)       # jump
        # one event per ms: a batch spans 4,096 ms, 8+ panes of 500 ms
        ts = np.where(idx >= 3 * BATCH, 70_000 + idx - 3 * BATCH, ts)
        return cols, ts

    from flink_tpu_torch import StreamExecutionEnvironment
    from flink_tpu_torch.core.config import Configuration
    from flink_tpu_torch.core.time import TimeCharacteristic
    from flink_tpu_torch.runtime.sinks import CountingSink
    from flink_tpu_torch.runtime.sources import GeneratorSource

    total = 5 * BATCH
    env = StreamExecutionEnvironment(Configuration(CONFIG), device="cpu")
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(N_KEYS)
    env.batch_size = BATCH
    sink = CountingSink()
    (env.add_source(GeneratorSource(gen, total=total))
     .key_by(lambda c: c["key"]).time_window(500)
     .sum(lambda c: c["value"]).add_sink(sink))
    job = env.execute("jumps")
    cols, ts = gen(0, total)
    want = len(set(zip(cols["key"].tolist(), (ts // 500).tolist())))
    assert (sink.count, sink.value_sum) == (want, float(total))
    assert job.metrics.dropped_late == 0
    assert job.metrics.steps > 5          # the wide batches were cut


@pytest.mark.parametrize("change", [
    "processing_time", "parallelism", "lateness", "collect_sink",
    "hash_layout", "overflow_ring", "checkpointing",
])
def test_port_raises_for_what_this_slice_lacks(change):
    from flink_tpu_torch import StreamExecutionEnvironment
    from flink_tpu_torch.core.config import Configuration
    from flink_tpu_torch.core.time import TimeCharacteristic
    from flink_tpu_torch.runtime.sinks import CollectSink, CountingSink
    from flink_tpu_torch.runtime.sources import GeneratorSource

    cfg = dict(CONFIG)
    if change == "hash_layout":
        cfg["state.backend.layout"] = "hash"
    if change == "overflow_ring":
        cfg["state.backend.overflow-ring"] = 4096
    env = StreamExecutionEnvironment(Configuration(cfg), device="cpu")
    if change != "processing_time":
        env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    if change == "parallelism":
        env.set_parallelism(2)
    if change == "checkpointing":
        env.enable_checkpointing(10)
    win = (env.add_source(GeneratorSource(gen_batch, total=BATCH))
           .key_by(lambda c: c["key"]).time_window(WINDOW_MS))
    if change == "lateness":
        win = win.allowed_lateness(100)
    win.sum(lambda c: c["value"]).add_sink(
        CollectSink() if change == "collect_sink" else CountingSink())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        env.execute("unsupported")
