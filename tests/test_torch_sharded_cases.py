"""The reference's own public-API cases of the shard mesh, run unchanged
against the port (``tests/torch_library_parity.py run_reference_case``,
``force_device_count(8)`` as the conftest forces 8 XLA devices): the five
job cases of ``tests/test_exchange_default.py``, ``tests/test_exchange.py
::test_exchange_mode_end_to_end`` and two cases of
``tests/test_data_parallel.py``; its planner case on the port's mesh and
the sharded ring's per-shard refusals and releases; the job kinds that
run at parallelism 4 — session and count windows, device CEP, chained
stages, allowed lateness and the flight recorder —, each job's rows equal
to numpy's; and the refusals that stay at parallelism 4: tiered state and
the controller's rebalance arm, each citing ROADMAP queue 1, item 10.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest

from torch_library_parity import reference_cases, run_reference_case
from test_torch_sharded import eight_devices  # noqa: F401 (the fixture)

from flink_tpu_torch import StreamExecutionEnvironment
from flink_tpu_torch.cep import CEP, NFA, Pattern
from flink_tpu_torch.core.config import Configuration
from flink_tpu_torch.core.keygroups import assign_to_key_group
from flink_tpu_torch.core.time import TimeCharacteristic
from flink_tpu_torch.ops.hashing import route_hash
from flink_tpu_torch.parallel.mesh import MeshContext
from flink_tpu_torch.runtime import ingest as ingest_mod
from flink_tpu_torch.runtime.sinks import CollectSink
from flink_tpu_torch.runtime.sources import GeneratorSource


DEFAULT_CASES = reference_cases("test_exchange_default.py", names=(
    "test_default_config_multi_device_uses_all_to_all",
    "test_auto_pads_batch_not_divisible_by_shards",
    "test_skewed_batches_fall_back_to_mask_without_loss",
    "test_mask_remains_explicit_fallback",
    "test_exchange_equals_mask_results"))


@pytest.mark.parametrize("test_file, name, params", DEFAULT_CASES)
def test_reference_exchange_default_cases(test_file, name, params, request,
                                          monkeypatch):
    run_reference_case(test_file, name, params, request, monkeypatch)


MESH_CASES = (
    reference_cases("test_exchange.py",
                    names=("test_exchange_mode_end_to_end",))
    + reference_cases("test_data_parallel.py", names=(
        "test_dp_job_exact_and_sharded_drains_dispatched",
        "test_dp_on_requires_resident_loop")))


@pytest.mark.parametrize("test_file, name, params", MESH_CASES)
def test_reference_mesh_cases(test_file, name, params, request,
                              monkeypatch):
    # tests/test_data_parallel.py imports the fault injector's device-loss
    # rule, which these two cases never call: the reference's own module
    run_reference_case(test_file, name, params, request, monkeypatch,
                       keep=("flink_tpu.testing.faults",))


def test_skewed_batch_falls_back_without_loss():
    """The reference's planner case (tests/test_data_parallel.py) on the
    port's mesh: a balanced batch takes the sharded route with the mesh's
    owning shards, an all-one-key batch the mask route."""
    maxp = 8
    ctx = MeshContext.create(4, maxp)
    plan = ingest_mod.IngestPlan(
        td=None, slide_ticks=1000, span_limit=8, B=64, staging=True,
        B_step=64, n_shards=4, max_parallelism=maxp,
        kg_ends=ctx.kg_bounds()[1], exchange_cap=0,
        routes=("mask", "sharded"), ring_depth=4, shard_cap=32)
    rng = np.random.default_rng(7)
    hi = rng.integers(0, 2**32, 64, dtype=np.uint32)
    lo = rng.integers(0, 2**32, 64, dtype=np.uint32)
    route, shard = ingest_mod.plan_route_and_shards(plan, hi, lo)
    assert route == "sharded" and shard is not None
    kg = assign_to_key_group(route_hash(hi, lo, np), maxp, np)
    starts, ends = ctx.kg_bounds()
    assert ((kg >= starts[shard]) & (kg <= ends[shard])).all()
    zeros = np.zeros(64, np.uint32)
    route, shard = ingest_mod.plan_route_and_shards(plan, zeros, zeros)
    assert route == "mask" and shard is None


def _gen(offset, n):
    idx = np.arange(offset, offset + n, dtype=np.int64)
    return {"key": idx % 50, "value": np.ones(n, np.float32)}, idx


TOTAL = 1024


def _env(parallelism=4, **cfg):
    env = StreamExecutionEnvironment(Configuration(cfg), device="cpu")
    env.set_parallelism(parallelism)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.batch_size = 256
    return env


def _keyed(env):
    return env.add_source(GeneratorSource(_gen, total=TOTAL)).key_by(
        lambda c: c["key"])


def _tumbling(size):
    """numpy's tumbling sums of _gen: {(key, window end): count}."""
    idx = np.arange(TOTAL)
    out = {}
    for k, t in zip((idx % 50).tolist(), idx.tolist()):
        kw = (k, (t // size + 1) * size)
        out[kw] = out.get(kw, 0.0) + 1.0
    return out


def _session(env):
    from flink_tpu_torch.datastream.window.assigners import (
        EventTimeSessionWindows,
    )
    sink = CollectSink()
    _keyed(env).window(EventTimeSessionWindows.with_gap(100)).sum(
        lambda c: c["value"]).add_sink(sink)
    # every key's records 50 ms apart: one session a key
    want = {(k, k, k + 50 * ((TOTAL - 1 - k) // 50) + 100):
            float((TOTAL - 1 - k) // 50 + 1) for k in range(50)}
    return sink, lambda: {(r.key, r.window_start_ms, r.window_end_ms):
                          r.value for r in sink.results}, want


def _count(env):
    sink = CollectSink()
    _keyed(env).count_window(10).sum(lambda c: c["value"]).add_sink(sink)
    want = {(k, w): 10.0 for k in range(50)
            for w in range(((TOTAL - 1 - k) // 50 + 1) // 10)}
    return sink, lambda: {(r.key, r.window_end_ms): r.value
                          for r in sink.results}, want


def _cep(env):
    env.set_stream_time_characteristic(TimeCharacteristic.ProcessingTime)
    evs = [(i % 7, "a" if i % 3 else "b", i) for i in range(200)]
    stream = env.from_collection(evs).key_by(lambda e: e[0])
    pattern = Pattern.begin("a").where(lambda e: e[1] == "a").followed_by(
        "b").where(lambda e: e[1] == "b")
    sink = CollectSink()
    CEP.pattern(stream, pattern).select(lambda m: (m["a"][2], m["b"][2])
                                        ).add_sink(sink)
    # the exact host NFA (cep/nfa.py), one key's events at a time
    nfa, want = NFA(pattern), []
    for k in range(7):
        partials = []
        for e in evs:
            if e[0] == k:
                partials, ms = nfa.process(partials, e, e[2])
                want += [(m["a"][2], m["b"][2]) for m in ms]
    return sink, lambda: sorted(sink.results), sorted(want)


def _chained(env):
    sink = CollectSink()
    (_keyed(env).time_window(100).sum(lambda c: c["value"])
     .key_by(lambda r: r.key).time_window(200).sum(lambda r: r.value)
     .add_sink(sink))
    return sink, lambda: {(r.key, r.window_end_ms): r.value
                          for r in sink.results}, _tumbling(200)


def _window(env):
    sink = CollectSink()
    _keyed(env).time_window(100).sum(lambda c: c["value"]).add_sink(sink)
    return sink, lambda: {(r.key, r.window_end_ms): r.value
                          for r in sink.results}, _tumbling(100)


def _late(env):
    sink = CollectSink()
    (_keyed(env).time_window(100).allowed_lateness(50)
     .sum(lambda c: c["value"]).add_sink(sink))
    return sink, lambda: {(r.key, r.window_end_ms): r.value
                          for r in sink.results}, _tumbling(100)


RESIDENT = {"pipeline.prefetch": "on", "pipeline.device-staging": "on",
            "pipeline.resident-loop": "on", "pipeline.ring-depth": 4}

RUNS = {
    "session": (_session, {}),
    "count": (_count, {}),
    "cep": (_cep, {}),
    "chained": (_chained, {}),
    "lateness": (_late, {}),
    "drain_stats": (_window, {**RESIDENT, "observability.drain-stats": True,
                              "observability.drain-stats-every": 1}),
}


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_parallelism_4_runs_the_item_10_kinds(kind):
    """What ROADMAP queue 1, item 10 refused at parallelism 4 until its
    sharded steps and drains came: it runs, its rows equal numpy's."""
    build, cfg = RUNS[kind]
    env = _env(**cfg)
    _sink, rows, want = build(env)
    job = env.execute(kind)
    assert rows() == want
    assert job.metrics.dropped_capacity == 0
    if kind == "drain_stats":
        rep = env._pipeline_report()
        assert sum(r["totals"]["events"] for r in rep["shards"]) == TOTAL


def _rebalance(env):
    """Every record on two key groups that shard 0 owns: the flight
    recorder's heat makes the rebalance arm fire at its first service."""
    from flink_tpu_torch.core.keygroups import assign_to_key_group
    cand = np.arange(4096, dtype=np.int64)
    kg = assign_to_key_group(cand.astype(np.uint32), 128, np)
    hot = np.concatenate([cand[kg == g][:2] for g in (3, 9)])

    def gen(offset, n):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        return ({"key": hot[idx % len(hot)],
                 "value": np.ones(n, np.float32)}, idx)

    (env.add_source(GeneratorSource(gen, total=8 * TOTAL))
     .key_by(lambda c: c["key"]).time_window(100)
     .sum(lambda c: c["value"]).add_sink(CollectSink()))


REFUSED = {
    "tiers": (lambda env: _window(env),
              {"state.tiers.resident-key-groups": 32}),
    "rebalance": (_rebalance, {
        **RESIDENT, "observability.drain-stats": True,
        "observability.kg-stats": True, "observability.kg-heat-alpha": 0.5,
        "controller.enabled": True, "controller.interval-cycles": 1,
        "controller.rebalance-threshold": 1.5,
        "controller.min-rebalance-interval": 0.0,
        "controller.min-gain": 1.01}),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_parallelism_4_refusals_cite_item_10(kind):
    build, cfg = REFUSED[kind]
    env = _env(**cfg)
    build(env)
    with pytest.raises(NotImplementedError, match="queue 1, item 10"):
        env.execute(kind)


def test_sharded_ring_refuses_and_releases_per_shard():
    """The ShardedDeviceBatchRing (the reference's unit cases): each batch
    is partitioned stably by owning shard into that shard's ring; a full
    ring refuses only its own shard's slice (staged fresh, its sequence
    None, counted in that shard's refusals); each shard releases on its
    own."""
    ctx = MeshContext.create(4, 8)
    plan = ingest_mod.IngestPlan(
        td=None, slide_ticks=1000, span_limit=8, B=64, staging=True,
        B_step=64, n_shards=4, max_parallelism=8,
        kg_ends=ctx.kg_bounds()[1], routes=("mask", "sharded"),
        ring_depth=2, shard_cap=64, devices=ctx.devices)
    ring = ingest_mod.ShardedDeviceBatchRing(plan, 2)
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 2**32, 64, dtype=np.uint32)
    lo = rng.integers(0, 2**32, 64, dtype=np.uint32)
    ticks = np.arange(64, dtype=np.int32)
    vals = np.arange(64, dtype=np.float32)
    route, shard = ingest_mod.plan_route_and_shards(plan, hi, lo)
    assert route == "sharded"
    for _ in range(2):
        seqs, staged, _ev = ring.publish_batch(plan, hi, lo, ticks, vals,
                                               shard, 64, 0)
    assert seqs == [1, 1, 1, 1]
    for s in range(4):
        mine = np.nonzero(shard == s)[0]       # in lane order: stable
        got = staged[s][3].numpy()[:len(mine)]
        np.testing.assert_array_equal(got, vals[mine])
        assert int(staged[s][4].sum()) == len(mine)
    ring.release_shards([1, None, None, None])   # shard 0 drained alone
    seqs, staged, _ev = ring.publish_batch(plan, hi, lo, ticks, vals, shard,
                                           64, 0)
    assert seqs == [2, None, None, None]
    assert ring.refusals() == [0, 1, 1, 1]
    assert ring.occupancy_shards() == [1, 2, 2, 2]
    assert ring.clear() == 7 and ring.occupancy_shards() == [0] * 4
