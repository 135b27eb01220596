"""The port's copies of flink_tpu/metrics/latency.py and
flink_tpu/metrics/drain_stats.py against the originals: the cases of
tests/test_latency.py (LatencySamples, weighted_percentile) and the
DrainTelemetry cases of tests/test_doctor.py, each run on both packages'
modules as cases of one parametrised test; and the fire latency a port
job records, sample weights summing to its fires.

Weights are exact; percentile drift after compaction is held to the
bucket resolution tests/test_latency.py sets; the EWMA heat compares with
pytest.approx as tests/test_doctor.py does.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest

from flink_tpu.metrics import drain_stats as ds_ref
from flink_tpu.metrics import latency as lat_ref
from flink_tpu_torch import StreamExecutionEnvironment
from flink_tpu_torch.core.config import Configuration
from flink_tpu_torch.core.time import TimeCharacteristic
from flink_tpu_torch.metrics import drain_stats as ds_port
from flink_tpu_torch.metrics import latency as lat_port
from flink_tpu_torch.runtime.sinks import ColumnarCollectSink, CountingSink
from flink_tpu_torch.runtime.sources import GeneratorSource

LAT = pytest.mark.parametrize("lat", [lat_ref, lat_port],
                              ids=["reference", "port"])
DS = pytest.mark.parametrize("ds", [ds_ref, ds_port],
                             ids=["reference", "port"])


def _exact_percentile(weights, values, q):
    order = np.argsort(values)
    v, w = np.asarray(values)[order], np.asarray(weights)[order]
    cdf = np.cumsum(w) / w.sum()
    return float(v[min(int(np.searchsorted(cdf, q / 100.0)), len(v) - 1)])


# ------------------------------------------------ tests/test_latency.py

@LAT
def test_compact_conserves_total_weight(lat):
    ls = lat.LatencySamples(max_samples=64)
    rng = np.random.default_rng(7)
    total = 0
    for _ in range(1000):
        n = int(rng.integers(1, 50))
        total += n
        ls.record(n, float(rng.exponential(10.0)))
    assert len(ls) <= 64
    assert np.isclose(sum(n for n, _ in ls._samples), total)


@LAT
def test_compact_percentile_drift_bounded(lat):
    rng = np.random.default_rng(42)
    n_emissions = 20_000
    weights = rng.integers(1, 20, n_emissions).astype(float)
    values = rng.lognormal(mean=3.0, sigma=0.7, size=n_emissions)
    ls = lat.LatencySamples(max_samples=512)
    for w, v in zip(weights, values):
        ls.record(int(w), float(v))
    assert len(ls) <= 512
    retained = sorted(v for _, v in ls._samples)
    for q in (50.0, 95.0, 99.0):
        exact = _exact_percentile(weights, values, q)
        approx = ls.percentile(q)
        i = int(np.searchsorted(retained, exact))
        lo = max(0, i - 2)
        hi = min(len(retained) - 1, i + 2)
        resolution = max(
            np.diff(retained[lo:hi + 1]).max(initial=0.0), 1e-9)
        assert abs(approx - exact) <= 2 * resolution, (q, exact, approx)


@LAT
def test_compact_handles_odd_sample_count(lat):
    ls = lat.LatencySamples(max_samples=4)
    for i in range(5):
        ls.record(1, float(i))
    assert len(ls) == 3
    assert np.isclose(sum(n for n, _ in ls._samples), 5)


@LAT
def test_weighted_percentile_empty_single_and_ends(lat):
    assert lat.weighted_percentile([], 50) is None
    for q in (0.0, 50.0, 100.0):
        assert lat.weighted_percentile([(3.0, 42.5)], q) == 42.5
    samples = [(1.0, 10.0), (1.0, 20.0), (1.0, 30.0)]
    assert lat.weighted_percentile(samples, 0) == 10.0
    assert lat.weighted_percentile(samples, 100) == 30.0


@LAT
def test_weighted_percentile_respects_weights(lat):
    samples = [(99.0, 1.0), (1.0, 100.0)]
    assert lat.weighted_percentile(samples, 50) == 1.0
    assert lat.weighted_percentile(samples, 99.5) == 100.0


@LAT
def test_record_zero_weight_is_noop(lat):
    ls = lat.LatencySamples()
    ls.record(0, 5.0)
    assert len(ls) == 0 and not ls
    assert ls.percentile(50) is None


def test_the_copies_compute_alike():
    """The same stream of weighted samples through both packages' copies
    leaves the same samples and percentiles, and the same recorder
    report."""
    rng = np.random.default_rng(3)
    a, b = lat_ref.LatencySamples(256), lat_port.LatencySamples(256)
    for _ in range(3000):
        n, v = int(rng.integers(0, 30)), float(rng.exponential(5.0))
        a.record(n, v)
        b.record(n, v)
    assert a._samples == b._samples
    for q in (1.0, 50.0, 99.0):
        assert a.percentile(q) == b.percentile(q)
    t_ref = ds_ref.DrainTelemetry(1, 4, key_groups=8, kg_alpha=0.5)
    t_port = ds_port.DrainTelemetry(1, 4, key_groups=8, kg_alpha=0.5)
    for t in (t_ref, t_port):
        t.t0 = 0.0
        t.ingest_publish([(0, 0, 1, 120, 1.0), (0, 1, 2, 240, 2.0)])
        t.on_drain([2], [0], [1], t_wall=3.0)
        t.absorb_payload(np.arange(18, dtype=np.int64).reshape(1, 2, 9),
                         t_wall=3.0)
        t.absorb_kg_fill(np.arange(8, dtype=np.int64), 2)
        t.note_fires([(100, 7), (200, 3)], t_wall=4.0)
    assert t_ref.report() == t_port.report()
    assert ds_ref.DRAIN_STAT_FIELDS == ds_port.DRAIN_STAT_FIELDS


# ------------------------------------------------ tests/test_doctor.py

def _stage_payload(ds, n_shards=1, **kw):
    ss = np.zeros((1, n_shards, len(ds.STAGE_STAT_FIELDS)), np.int32)
    fi = {f: i for i, f in enumerate(ds.STAGE_STAT_FIELDS)}
    for f, v in kw.items():
        ss[0, 0, fi[f]] = v
    return ss


@DS
def test_stage_payload_counters_accumulate_and_levels_track_latest(ds):
    dt = ds.DrainTelemetry(1, 4, n_stages=2, exchange_lanes=100)
    dt.absorb_stage_payload(_stage_payload(
        ds, edge_demand=40, edge_events=40, fire_lanes=3, wm_lag_panes=5,
        panes_advanced=2))
    dt.absorb_stage_payload(_stage_payload(
        ds, edge_demand=90, edge_events=90, fire_lanes=1, wm_lag_panes=1,
        panes_advanced=1))
    assert dt.stage_stat(1, "edge_demand") == 130
    assert dt.stage_stat(1, "fire_lanes") == 4
    assert dt.stage_stat(1, "panes_advanced") == 3
    assert dt.stage_stat(1, "wm_lag_panes") == 1
    assert dt.stage_stat(2, "edge_demand") == 0
    assert dt.stage_stat(1, "nope") == 0
    rep = dt.report()
    (st,) = rep["stages"]
    assert st["stage"] == 1
    assert st["totals"]["edge_demand"] == 130
    assert st["levels"]["wm_lag_panes"] == 1
    assert st["edge_lane_budget"] == 100
    assert st["edge_peak_demand"] == 90
    assert st["edge_utilization"] == 0.9
    assert rep["stage_fields"] == list(ds.STAGE_STAT_FIELDS)


@DS
def test_stage_payload_sums_shards_and_accepts_2d(ds):
    dt = ds.DrainTelemetry(2, 4, n_stages=2, exchange_lanes=0)
    ss = _stage_payload(ds, n_shards=2, edge_demand=10)
    ss[0, 1, 0] = 30
    dt.absorb_stage_payload(ss)
    assert dt.stage_stat(1, "edge_demand") == 40
    dt.absorb_stage_payload(
        np.full((1, len(ds.STAGE_STAT_FIELDS)), 2, np.int32))
    assert dt.stage_stat(1, "edge_demand") == 42
    assert dt.report()["stages"][0]["edge_utilization"] is None


@DS
def test_single_stage_report_has_no_stages_block(ds):
    rep = ds.DrainTelemetry(1, 4).report()
    assert "stages" not in rep and "kg_heat" not in rep


class _FakeTracer:
    active = True

    def __init__(self):
        self.counters = []

    def rec_counter(self, track, t, **values):
        self.counters.append((track, values))


@DS
def test_stage_payload_emits_per_stage_counter_tracks(ds):
    tr = _FakeTracer()
    dt = ds.DrainTelemetry(1, 4, tracer=tr, n_stages=3, exchange_lanes=8)
    ss = np.zeros((2, 1, len(ds.STAGE_STAT_FIELDS)), np.int32)
    ss[:, 0, 1] = (4, 7)
    dt.absorb_stage_payload(ss)
    tracks = dict(tr.counters)
    assert set(tracks) == {"drain_stage1", "drain_stage2"}
    assert tracks["drain_stage2"]["edge_lanes"] == 7
    assert set(tracks["drain_stage1"]) == {
        "edge_lanes", "fire_lanes", "wm_lag_panes"}


@DS
def test_kg_heat_ewma_recency_and_cold_tail(ds):
    dt = ds.DrainTelemetry(1, 4, key_groups=8, kg_alpha=0.5)
    assert dt.kg_heat_block()["available"] is False
    fill = np.zeros(8, np.int64)
    fill[2] = 100
    dt.absorb_kg_fill(fill)
    dt.absorb_kg_fill(fill)
    assert dt.kg_heat_max() == pytest.approx(75.0)
    blk = dt.kg_heat_block(k=3)
    assert blk["available"] and blk["samples"] == 2
    assert blk["top"][0] == {"group": 2, "heat": 75.0,
                             "last_touched_ago": 0}
    assert blk["skew_ratio"] == 1.0
    assert blk["cold_tail"]["count"] == 7
    fill2 = np.zeros(8, np.int64)
    fill2[5] = 10
    dt.absorb_kg_fill(fill2)
    dt.absorb_kg_fill(np.zeros(8, np.int64))
    blk = dt.kg_heat_block(k=8)
    ago = {r["group"]: r["last_touched_ago"] for r in blk["top"]}
    assert ago[5] == 1 and ago[2] == 2
    assert dt.kg_heat_skew() > 1.0


@DS
def test_kg_heat_normalizes_by_batches_and_resizes(ds):
    dt = ds.DrainTelemetry(1, 4, key_groups=4, kg_alpha=1.0)
    dt.absorb_kg_fill(np.asarray([8, 0, 0, 0], np.int64), n_batches=4)
    assert dt.kg_heat_max() == pytest.approx(2.0)
    dt.absorb_kg_fill(np.zeros(6, np.int64))
    assert dt.kg_heat_block(k=1)["groups"] == 6
    assert dt.kg_heat_max() == pytest.approx(0.0)


# ------------------------------------------------ a job's fire latency

def _job(sink, extra=None, total=20_000, gap=False):
    env = StreamExecutionEnvironment(Configuration(
        {"pipeline.ring-depth": 4, "pipeline.resident-loop": "on",
         **(extra or {})}), device="cpu")
    env.set_parallelism(1)
    env.set_max_parallelism(8)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(1 << 12)
    env.batch_size = 1024

    def gen(offset, n):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        ts = idx // 10
        if gap:
            # event time jumps 5 s (ten windows) halfway: the executor
            # fires the open windows with watermark-only advances first
            ts = ts + np.where(idx >= total // 2, 5000, 0)
        return {"key": idx % 100, "value": np.ones(n, np.float32)}, ts

    (env.add_source(GeneratorSource(gen, total=total))
     .key_by(lambda c: c["key"]).time_window(500)
     .sum(lambda c: c["value"]).add_sink(sink))
    return env.execute("latency")


@pytest.mark.parametrize("sink,gap", [
    (CountingSink(), False),                # reduced on the device
    (ColumnarCollectSink(), False),         # compacted rows
    (ColumnarCollectSink(), True),          # + watermark-only fires
], ids=["reduced", "rows", "watermark-only"])
def test_fire_latency_weighs_every_window(sink, gap):
    """Every emitted window is one unit of sample weight: the weights sum
    to ``metrics.fires``, the drains' fires and the watermark-only
    advances' (the end-of-stream flush's last window; with the gap, the
    windows open at the jump) alike, and the percentiles answer in ms."""
    m = _job(sink, gap=gap).metrics
    assert m.fires == 400 and m.fire_latency is not None
    assert sum(n for n, _ in m.fire_latency._samples) == m.fires
    p50, p99 = m.fire_latency_pct(50), m.fire_latency_pct(99)
    assert 0.0 <= p50 <= p99
    assert m.fire_step_fires == (200 if gap else 100)


def test_fire_latency_none_before_a_fire():
    m = _job(CountingSink(), total=1000).metrics
    assert m.fires == 100            # the end-of-stream flush fires it
    from flink_tpu_torch.runtime.executor import JobMetrics
    assert JobMetrics().fire_latency_pct(99) is None
