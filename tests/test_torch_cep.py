"""CEP through the public API: ``CEP.pattern(stream, p).select(fn)`` /
``flat_select(fn)`` on flink_tpu_torch (``device="cpu"``: the count NFA's
kernels run their plain versions) against flink_tpu on the same seeded
events, and the slice's refusals.

Each job's sink rows must equal the reference's in order (the match
extraction replays flagged keys in the same order in both packages), and
so must ``cep_engine``, ``cep_device_steps``, ``cep_matches_detected``,
``cep_matches_extracted``, ``steps`` and ``dropped_capacity``. Counts are
small integers, exact in float32 in both packages. Jobs run in
processing time without within() (its pane would come from the wall
clock) and in event time with and without within(), strict and relaxed,
keyed and not, from ``from_collection``, ``from_elements`` and a columnar
``GeneratorSource``."""

import torch_threads  # noqa: F401  (first: caps torch's threads)

from collections import namedtuple
from operator import itemgetter

import numpy as np
import pytest

import flink_tpu
from flink_tpu.cep import CEP as CEPJ
from flink_tpu.cep import Pattern as PJ
from flink_tpu.cep.accel import batch_gaps as batch_gaps_j
from flink_tpu.core.config import Configuration as ConfigJ
from flink_tpu.core.time import TimeCharacteristic as TCJ
from flink_tpu.runtime.sinks import CollectSink as CollectJ
from flink_tpu.runtime.sources import GeneratorSource as GenJ
from flink_tpu.runtime.watermarks import WatermarkStrategy as WSJ
from flink_tpu_torch import StreamExecutionEnvironment
from flink_tpu_torch.cep import CEP as CEPT
from flink_tpu_torch.cep import Pattern as PT
from flink_tpu_torch.cep.accel import DeviceCepOperator
from flink_tpu_torch.cep.accel import batch_gaps as batch_gaps_t
from flink_tpu_torch.core.config import Configuration as ConfigT
from flink_tpu_torch.core.time import TimeCharacteristic as TCT
from flink_tpu_torch.parallel.mesh import forced_device_count
from flink_tpu_torch.runtime.sinks import CollectSink as CollectT
from flink_tpu_torch.runtime.sources import GeneratorSource as GenT
from flink_tpu_torch.runtime.watermarks import WatermarkStrategy as WST

Ev = namedtuple("Ev", ["key", "name", "ts", "v"])
# field getters that read an Ev and a columnar source's tuple alike
KEY, NAME, TS, V = (itemgetter(i) for i in range(4))
N_EVENTS = 2_000
OOO_MS = 8

REF = dict(env=lambda cfg: flink_tpu.StreamExecutionEnvironment(
    ConfigJ(cfg)), CEP=CEPJ, P=PJ, sink=CollectJ, TC=TCJ, WS=WSJ, gen=GenJ)
PORT = dict(env=lambda cfg: StreamExecutionEnvironment(
    ConfigT(cfg), device="cpu"), CEP=CEPT, P=PT, sink=CollectT, TC=TCT,
    WS=WST, gen=GenT)


def events(seed=5, n=N_EVENTS, n_keys=30):
    """Keyed events of names a, b, c, x, arriving up to OOO_MS out of
    timestamp order."""
    rng = np.random.default_rng(seed)
    names = rng.choice(list("abcx"), n, p=[0.2, 0.2, 0.2, 0.4])
    keys = rng.integers(0, n_keys, n)
    ts = np.arange(n) // 2 + rng.integers(0, OOO_MS, n)
    return [Ev(int(k), str(a), int(t), i) for i, (k, a, t) in
            enumerate(zip(keys.tolist(), names.tolist(), ts.tolist()))]


def abc(P, strict=False, within=None, batch_where=False):
    """a followedBy b, then c (next or followedBy)."""
    p = P.begin("a")
    p = (p.where_batch(lambda es: np.array([NAME(e) == "a" for e in es]))
         if batch_where else p.where(lambda e: NAME(e) == "a"))
    p = p.followed_by("b").where(lambda e: NAME(e) == "b")
    p = (p.next("c") if strict else p.followed_by("c")).where(
        lambda e: NAME(e) == "c")
    return p.within(within) if within else p


def select(m):
    return (V(m["a"]), V(m["b"]), V(m["c"]))


def flat(m):
    return [(V(m["a"]),), (V(m["c"]),)]


def run(pkg, *, event_time, keyed=True, strict=False, within=None,
        flat_select=False, batch=256, batch_where=False, source="collection",
        cfg=None):
    """One CEP job through package ``pkg``'s public API; returns (rows,
    metrics)."""
    env = pkg["env"](cfg or {})
    env.batch_size = batch
    evs = events()
    if source == "collection":
        stream = env.from_collection(evs)
    elif source == "elements":
        stream = env.from_elements(*evs)
    else:
        cols = {f: np.array([getattr(e, f) for e in evs]) for f in Ev._fields}

        def gen(offset, n):
            return {f: c[offset:offset + n] for f, c in cols.items()}, None
        stream = env.add_source(pkg["gen"](gen, total=len(evs)))
    if event_time:
        env.set_stream_time_characteristic(pkg["TC"].EventTime)
        stream = stream.assign_timestamps_and_watermarks(
            TS, pkg["WS"].for_bounded_out_of_orderness(OOO_MS))
    if keyed:
        stream = stream.key_by(KEY)
    sink = pkg["sink"]()
    ps = pkg["CEP"].pattern(stream, abc(pkg["P"], strict, within,
                                        batch_where))
    (ps.flat_select(flat) if flat_select else ps.select(select)).add_sink(
        sink)
    m = env.execute("cep").metrics
    return sink.results, (m.cep_engine, m.cep_device_steps,
                          m.cep_matches_detected, m.cep_matches_extracted,
                          m.steps, m.dropped_capacity)


CASES = {
    "processing_time_relaxed": dict(event_time=False),
    "processing_time_strict": dict(event_time=False, strict=True),
    "processing_time_pruned": dict(event_time=False, batch=24),
    "event_time_relaxed": dict(event_time=True),
    "event_time_strict_within": dict(event_time=True, strict=True,
                                     within=40),
    "event_time_relaxed_within": dict(event_time=True, within=60),
    "flat_select_within": dict(event_time=True, within=60,
                               flat_select=True),
    "non_keyed": dict(event_time=True, keyed=False, within=20),
    "non_keyed_processing_time": dict(event_time=False, keyed=False,
                                      strict=True),
    "where_batch": dict(event_time=True, within=60, batch_where=True),
    "from_elements": dict(event_time=False, source="elements"),
    "columnar_source": dict(event_time=True, within=60, source="columnar"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rows_and_metrics_match_reference(case):
    rows_j, m_j = run(REF, **CASES[case])
    rows_t, m_t = run(PORT, **CASES[case])
    assert m_j[0] == m_t[0] == "device"
    assert rows_t == rows_j
    assert m_t == m_j
    rows_per_match = 2 if CASES[case].get("flat_select") else 1
    assert m_t[2] == m_t[3] == len(rows_t) // rows_per_match > 0
    assert m_t[5] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_gaps_matches_reference(seed):
    rng = np.random.default_rng(seed)
    B, G = 200, 17
    inv = rng.integers(0, G, B)
    hit = rng.random(B) < 0.4
    tin = rng.random(G) < 0.5
    gap_j, tout_j = batch_gaps_j(inv, hit, tin)
    gap_t, tout_t = batch_gaps_t(inv, hit, tin)
    np.testing.assert_array_equal(gap_t, gap_j)
    np.testing.assert_array_equal(tout_t, tout_j)
    empty = batch_gaps_t(np.zeros(0, np.int64), np.zeros(0, bool), tin)
    assert len(empty[0]) == 0 and (empty[1] == tin).all()


def _job(cfg=None, *, parallelism=1, checkpoint=False, event_time=False,
         timestamps=True):
    env = StreamExecutionEnvironment(ConfigT(cfg or {}), device="cpu")
    env.set_parallelism(parallelism)
    if checkpoint:
        env.enable_checkpointing(4)
    stream = env.from_collection(events(n=50))
    if event_time:
        env.set_stream_time_characteristic(TCT.EventTime)
        if timestamps:
            stream = stream.assign_timestamps_and_watermarks(TS)
    stream = stream.key_by(KEY)
    CEPT.pattern(stream, abc(PT)).select(select).add_sink(CollectT())
    return env


@pytest.mark.parametrize("what, make, item", [
    ("the host NFA", lambda: _job({"cep.device.enabled": False}), "item 9"),
    ("checkpoints", lambda: _job(checkpoint=True), "item 6"),
    ("event time without timestamps",
     lambda: _job(event_time=True, timestamps=False), "item 9"),
])
def test_unported_cep_paths_raise(what, make, item):
    env = make()
    with pytest.raises(NotImplementedError, match=item):
        env.execute("cep")


def test_window_stage_over_an_element_source_raises():
    """An element-mode source under a window stage runs as the reference's
    element mode (each selector called per element); what still raises
    under it is an unported window, as over a columnar source."""
    from flink_tpu_torch.datastream.window.assigners import (
        ProcessingTimeSessionWindows,
    )
    env = StreamExecutionEnvironment(device="cpu")
    env.set_stream_time_characteristic(TCT.EventTime)
    sink = CollectT()
    (env.from_elements(1, 2, 3, 12, 14).assign_timestamps_and_watermarks(
        lambda e: e).key_by(lambda e: e % 2).time_window(10).sum()
     .add_sink(sink))
    env.execute("window")
    assert sorted((r.key, r.window_end_ms, r.value) for r in sink.results) \
        == [(0, 10, 2.0), (0, 20, 26.0), (1, 10, 4.0)]
    env = StreamExecutionEnvironment(device="cpu")
    (env.from_elements(1, 2).key_by(lambda e: e)
     .window(ProcessingTimeSessionWindows.with_gap(10)).sum()
     .add_sink(CollectT()))
    with pytest.raises(NotImplementedError, match="item 9"):
        env.execute("window")


def test_process_with_another_function_raises():
    from flink_tpu_torch.datastream.functions import ProcessFunction
    env = StreamExecutionEnvironment(device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        env.from_elements(1, 2).key_by(lambda e: e).process(ProcessFunction())


def test_operator_refuses_shards_and_queryable_state():
    """Two shards need two mesh devices (the reference's MeshContext
    check) and match what one shard matches; queryable state still
    raises."""
    with pytest.raises(ValueError, match="need 2 devices"):
        DeviceCepOperator(abc(PT), n_shards=2, device="cpu")
    got = []
    for n in (1, 2):
        with forced_device_count(n):
            op = DeviceCepOperator(abc(PT), capacity=64, n_shards=n,
                                   device="cpu")
        evs = events(n=300)
        out = []
        for off in range(0, len(evs), 64):
            chunk = evs[off:off + 64]
            out += op.process_batch(chunk, [KEY(e) for e in chunk], 0)
        assert op.matches_detected == op.matches_extracted > 0
        got.append(sorted(select(m) for m in out))
    assert got[1] == got[0]
    op = DeviceCepOperator(abc(PT), capacity=64, device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        op.peek_state(1)
