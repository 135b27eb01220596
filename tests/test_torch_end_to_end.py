"""The north-star job through both packages' public APIs on the CPU.

bench.py's generator rescaled to 2,048 keys at 20 events/ms: 5 s tumbling
windows, ~3 windows of data. The JAX reference runs on the CPU mesh with
parallelism 1 (the conftest mesh has 8 virtual devices) and the gated
knobs forced as on an accelerator; the port runs with device="cpu".
CountingSink.count and value_sum must be identical on both and equal a
numpy group-by. Every value is 1.0, so the sums are exact.

The hash state layout and per-row output run through the same API: sparse
64-bit ids (splitmix64 of the generator's keys) in a 10 s / 2 s sliding
count into a columnar row sink, and string keys into CollectSink. Both
packages must emit the same rows (sorted: which slot a key takes, and so
the order of a window's rows, differs in the hash layout).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

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
            config=None, capacity=N_KEYS):
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
    env.set_state_capacity(capacity)
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


def _collect_job(pkg, gen, total, key, size_ms, slide_ms, capacity,
                 sinks, config=None):
    """source -> key_by(key) -> sliding count -> sinks, on either package;
    returns the job handle."""
    if pkg == "jax":
        from flink_tpu import StreamExecutionEnvironment
        from flink_tpu.core.config import Configuration
        from flink_tpu.core.time import TimeCharacteristic
        from flink_tpu.runtime.sources import GeneratorSource
        kw = {}
    else:
        from flink_tpu_torch import StreamExecutionEnvironment
        from flink_tpu_torch.core.config import Configuration
        from flink_tpu_torch.core.time import TimeCharacteristic
        from flink_tpu_torch.runtime.sources import GeneratorSource
        kw = {"device": "cpu"}
    env = StreamExecutionEnvironment(
        Configuration(dict(CONFIG, **(config or {}))), **kw)
    env.set_parallelism(1)
    env.set_max_parallelism(128)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(capacity)
    env.batch_size = BATCH
    out = (env.add_source(GeneratorSource(gen, total=total))
           .key_by(lambda c: c[key]).time_window(size_ms, slide_ms).count())
    for sink in sinks:
        out.add_sink(sink)
    return env.execute("rows")


def _sparse_gen(offset, n):
    from flink_tpu_torch.ops.hashing import splitmix64
    cols, ts = gen_batch(offset, n)
    return {"id": splitmix64(cols["key"]).view(np.int64)}, ts


def test_sparse_ids_sliding_count_rows_match_reference_and_numpy():
    """auto resolves to the hash layout on both (the first batch's ids do
    not fit the capacity); every (id, window end, count) row is equal."""
    from flink_tpu.runtime.sinks import Sink as RefSink
    from flink_tpu_torch.runtime.sinks import ColumnarCollectSink

    class RefColumns(RefSink):
        columnar = True

        def __init__(self):
            self.parts = []

        def invoke_columnar(self, cols):
            self.parts.append({k: np.asarray(v) for k, v in cols.items()})

    size, slide, total = 10_000, 2_000, 4 * WINDOW_MS * EVENTS_PER_MS
    ref = RefColumns()
    port = ColumnarCollectSink()
    _collect_job("jax", _sparse_gen, total, "id", size, slide, 8192, [ref])
    job = _collect_job("torch", _sparse_gen, total, "id", size, slide, 8192,
                       [port])
    assert job.state.layout == "hash"

    def rows(cols):
        order = np.lexsort((cols["key_id"], cols["window_end_ms"]))
        return tuple(np.asarray(cols[k])[order]
                     for k in ("window_end_ms", "key_id", "value"))

    got = rows(port.columns())
    want = rows({k: np.concatenate([p[k] for p in ref.parts])
                 for k in ref.parts[0]})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # numpy: each event counts once in each of its 5 windows
    ids, ts = _sparse_gen(0, total)
    ends = {}
    for j in range(size // slide):
        end = (ts // slide + 1 + j) * slide
        for pair in zip(ids["id"].view(np.uint64).tolist(), end.tolist()):
            ends[pair] = ends.get(pair, 0) + 1
    assert len(got[0]) == len(ends)
    assert float(got[2].sum()) == float(total * (size // slide))
    assert dict(zip(zip(got[1].tolist(), got[0].tolist()),
                    got[2].tolist())) == ends
    assert job.metrics.dropped_capacity == 0 and job.metrics.dropped_late == 0


def test_string_keyed_job_collect_sink_matches_reference():
    """Word keys (hashed identities) into CollectSink and a CountingSink
    beside it: the same WindowResult rows on both packages, keys decoded
    through the reverse map."""
    from flink_tpu.runtime.sinks import CollectSink as RefCollect
    from flink_tpu.runtime.sinks import CountingSink as RefCounting
    from flink_tpu_torch.runtime.sinks import CollectSink, CountingSink

    words = np.array([f"w{i}" for i in range(300)], dtype=object)

    def gen(offset, n):
        cols, ts = gen_batch(offset, n)
        return {"word": words[cols["key"] % 300]}, ts

    total = 3 * WINDOW_MS * 2
    cfg = {"keys.reverse-map": True}
    results = []
    for pkg, sinks in (("jax", [RefCollect(), RefCounting()]),
                       ("torch", [CollectSink(), CountingSink()])):
        job = _collect_job(pkg, gen, total, "word", 2_000, 1_000, 1024,
                           sinks, cfg)
        rows = sorted((r.key, r.window_end_ms, r.value)
                      for r in sinks[0].results)
        assert sinks[1].count == len(rows)
        results.append(rows)
    assert results[0] == results[1]
    assert isinstance(results[1][0][0], str)
    assert sum(r[2] for r in results[1]) == 2 * total
    assert job.state.layout == "hash"


def test_explicit_hash_layout_runs_the_north_star():
    want_count, want_sum = reference(TOTAL)
    sink, job = run_job("torch", config={"state.backend.layout": "hash"},
                        capacity=2 * N_KEYS)
    assert (sink.count, sink.value_sum) == (want_count, want_sum)
    assert job.state.layout == "hash"


def test_drop_without_the_spill_tier_raises_not_implemented():
    """A key past capacity with state.backend.overflow-ring unset: both
    packages take its records into the spill tier (the auto-sized overflow
    ring, then the host stores) and finish exactly, with nothing dropped.
    (Before the spill tier was ported, the port raised
    NotImplementedError here.)"""
    cfg = {"state.backend.overflow-ring": -1}
    total, bad = 3 * BATCH, 2 * BATCH + 7
    cols, ts = gen_batch(0, total, bad)
    want_count = len(set(zip(cols["key"].tolist(),
                             (ts // WINDOW_MS).tolist())))
    want_sum = float(total)
    for pkg in ("jax", "torch"):
        sink, job = run_job(pkg, total=total, bad_key_at=bad, config=cfg)
        assert (sink.count, sink.value_sum) == (want_count, want_sum), pkg
        assert job.metrics.dropped_capacity == 0
    assert job.metrics.spilled_records == 1 and job.metrics.ring_drains == 1
    assert job.metrics.compactions == 0           # the direct layout


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
    "processing_time", "parallelism", "lateness", "min_reduce",
    "map_after_window", "overflow_ring", "checkpointing",
])
def test_port_raises_for_what_this_slice_lacks(change, tmp_path):
    from flink_tpu_torch import StreamExecutionEnvironment
    from flink_tpu_torch.core.config import Configuration
    from flink_tpu_torch.core.time import TimeCharacteristic
    from flink_tpu_torch.runtime.sinks import CountingSink
    from flink_tpu_torch.runtime.sources import GeneratorSource

    sink = CountingSink()

    def build():
        cfg = dict(CONFIG)
        if change == "overflow_ring":
            cfg["state.backend.overflow-ring"] = 4096
        env = StreamExecutionEnvironment(Configuration(cfg), device="cpu")
        if change != "processing_time":
            env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
        if change == "parallelism":
            env.set_parallelism(2)
        if change == "checkpointing":
            env.enable_checkpointing(1, str(tmp_path))
        win = (env.add_source(GeneratorSource(gen_batch, total=BATCH))
               .key_by(lambda c: c["key"]).time_window(WINDOW_MS))
        if change == "lateness":
            win = win.allowed_lateness(100)
        if change == "min_reduce":
            agg = win.min(lambda c: c["value"])
        else:
            agg = win.sum(lambda c: c["value"])
        if change == "map_after_window":
            agg = agg.map(lambda r: r)
        agg.add_sink(sink)
        return env

    if change == "overflow_ring":
        # the spill tier is ported: an explicit ring runs the job, exactly
        job = build().execute("explicit ring")
        assert (sink.count, sink.value_sum) == reference(BATCH)
        assert job.state.ovf_hi.numel() == 4096
        return
    if change == "checkpointing":
        # checkpoints of a single-stage window job are ported: the job
        # runs, exactly, and writes its cut
        job = build().execute("checkpointed")
        assert (sink.count, sink.value_sum) == reference(BATCH)
        assert len(job.metrics.checkpoint_stats) == 1
        return
    if change in ("lateness", "min_reduce"):
        # allowed lateness and min are ported: the job runs, exactly (every
        # value is 1.0, so a window's min is 1.0 and the sum of mins its
        # count); lateness drops the spill tier (strict capacity)
        job = build().execute(change)
        count, value_sum = reference(BATCH)
        assert (sink.count, sink.value_sum) == (
            (count, value_sum) if change == "lateness"
            else (count, float(count)))
        if change == "lateness":
            assert job.state.ovf_hi.numel() == 0
        return
    if change == "parallelism":
        # parallelism is ported: on one visible device parallelism 2 runs
        # one shard (n = min(parallelism, devices), as the reference's
        # executor.py:1596-1598), exactly
        job = build().execute("parallelism")
        assert (sink.count, sink.value_sum) == reference(BATCH)
        assert job.metrics.exchange_mode == "mask"
        return
    if change == "map_after_window":
        # refused where the job is built
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build()
        return
    env = build()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        env.execute("unsupported")
