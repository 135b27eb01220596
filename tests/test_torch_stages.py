"""Chained keyed window stages in the port against the reference:

* the one-device chained drain (``runtime/step.py
  build_window_chained_drain``: stage 0's slot loop, G21's edge, the
  downstream update, fire and purge, G22's recorder columns) against
  ``flink_tpu.runtime.step.build_window_chained_drain`` over a one-shard
  mesh on the same staged slots: every stage's state, the final fires and
  the flight recorder's ``(ds0, ss)`` equal;
* a chain's stage states carried from the reference into the port
  mid-stream and back, both continuing to the same fires;
* the public-API job of ``tests/test_stages.py`` through both packages:
  rows equal to each other and to a numpy oracle, in the direct and hash
  layouts, with a sliding stage 0, a max at stage 1 and three stages;
  the metrics and the drain-stats report's stage rows equal; a chain
  whose downstream windows come due more than F a drain, so that a flush
  is called for while batches are staged, loses none of them;
* the flush's windows timing their fire latency from the watermark
  crossing;
* every StageGraphError of ``tests/test_stages.py``, and the port's
  refusals of checkpoints (ROADMAP item 6); parallelism 2 runs, to the
  rows of parallelism 1.

Both packages force pre-combine, packed planes and the resident loop on
(the reference's ``RESIDENT_CFG``). The reference keeps split planes
downstream (its plan turns packed planes off there); the port keeps a
builtin reduce's packed plane, and the states compare cell by cell. All
data is integer-valued: bit-exact.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu import StreamExecutionEnvironment as RefEnv
from flink_tpu.core.config import Configuration as RefConfiguration
from flink_tpu.core.time import TimeCharacteristic as RefTC
from flink_tpu.ops import window_kernels as wkj
from flink_tpu.ops.hashtable import SlotTable
from flink_tpu.parallel.mesh import MeshContext
from flink_tpu.runtime import sinks as ref_sinks
from flink_tpu.runtime import sources as ref_sources
from flink_tpu.runtime import step as step_ref
from flink_tpu.runtime.stages import StageGraphError as RefStageGraphError
from flink_tpu_torch import StreamExecutionEnvironment
from flink_tpu_torch.core.config import Configuration
from flink_tpu_torch.core.time import TimeCharacteristic
from flink_tpu_torch.metrics.drain_stats import STAGE_STAT_FIELDS
from flink_tpu_torch.ops import window_kernels as wkt
from flink_tpu_torch.parallel.mesh import forced_device_count
from flink_tpu_torch.runtime import step as step_port
from flink_tpu_torch.runtime.sinks import CollectSink
from flink_tpu_torch.runtime.sources import GeneratorSource
from flink_tpu_torch.runtime.stages import StageGraph, StageGraphError
from torch_parity import C, F, MAXP, R, batches, lanes_torch

D, COUNT = 4, 3


# ------------------------------------------------------------ the drain

def chain_specs(sizes, layout, red_kinds=("sum", "sum")):
    """Both packages' specs for a chain of tumbling (size) or sliding
    ((size, slide)) stages over C slots; downstream rings sized as
    StageGraph.plan_specs sizes them."""
    out_j, out_t = [], []
    slide_up = None
    for i, (size, slide) in enumerate(sizes):
        if i == 0:
            ring = R
        else:
            ppw = size // slide
            ring = max(8, 2 * ppw + (D * F * slide_up) // slide + 2, ppw + 3)
        kind = red_kinds[i]
        win_j = wkj.WindowSpec(size, slide, ring=ring, fires_per_step=F)
        win_t = wkt.WindowSpec(size, slide, ring=ring, fires_per_step=F)
        out_j.append(step_ref.WindowStageSpec(
            win=win_j, red=wkj.ReduceSpec(kind, jnp.float32),
            capacity_per_shard=C, layout=layout, precombine=i == 0,
            packed=i == 0))
        out_t.append(step_port.WindowStageSpec(
            win=win_t, red=wkt.ReduceSpec(kind), capacity_per_shard=C,
            layout=layout))
        slide_up = slide
    return out_j, out_t


def ref_leaves(st) -> dict:
    """A one-shard stacked reference state's leaves as numpy fields."""
    out = {"table.keys": np.asarray(st.table.keys)[0]}
    for name in wkt.STATE_FIELDS[1:]:
        out[name] = np.asarray(getattr(st, name))[0]
    return out


def ref_state(fields: dict, packed: int):
    """A one-shard stacked reference state from numpy fields."""
    st = wkj.WindowShardState(
        SlotTable(jnp.asarray(fields["table.keys"]), 16),
        *(jnp.asarray(fields[n]) for n in wkt.STATE_FIELDS[1:]),
        packed=packed)
    return jax.tree_util.tree_map(lambda x: x[None], st)


def port_fields_as_ref(st: wkt.WindowShardState, packed: bool,
                       kind: str = "sum") -> dict:
    """A port state's fields in the reference's plane: packed as it is,
    or split into (acc, touched) for the reference's split downstream."""
    f = wkt.state_to_numpy(st)
    if not packed:
        acc, touched = wkt.split_packed(f["acc"], wkt.ReduceSpec(kind))
        f["acc"], f["touched"] = np.ascontiguousarray(acc), touched
    return f


def logical(fields: dict, packed: bool, kind: str):
    """Scalars, and the touched cells as sorted (key word, ring row,
    value) rows, so that two tables that put keys in other slots compare
    equal."""
    rows = fields["table.keys"].astype(np.uint64)
    words = (rows[:, 0] << np.uint64(32)) | rows[:, 1]
    cap = len(words)
    acc = np.asarray(fields["acc"])
    if packed:
        vals, touched = wkt.split_packed(acc, wkt.ReduceSpec(kind))
    else:
        vals, touched = acc, np.asarray(fields["touched"])
    r, s = np.nonzero(touched.reshape(-1, cap))
    cells = np.stack([words[s].astype(np.float64), r.astype(np.float64),
                      vals.reshape(-1, cap)[r, s].astype(np.float64)], 1)
    cells = cells[np.lexsort(cells.T[::-1])]
    scal = {k: np.asarray(v) for k, v in fields.items()
            if k not in ("table.keys", "acc", "touched", "fresh",
                         "kg_dirty")}
    return scal, cells, np.asarray(fields["kg_dirty"])


def assert_stage_equal(sj, st, ref_packed: bool, exact: bool,
                       kind: str = "sum"):
    want = ref_leaves(sj)
    got = wkt.state_to_numpy(st)
    ws, wc, wk = logical(want, ref_packed, kind)
    gs, gc, gk = logical(got, True, kind)
    for k in ws:
        np.testing.assert_array_equal(gs[k], ws[k], err_msg=k)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gk, wk)
    if exact:
        got_ref = port_fields_as_ref(st, ref_packed, kind)
        for k in ("table.keys", "acc", "touched"):
            np.testing.assert_array_equal(got_ref[k], want[k], err_msg=k)


def fire_rows_of(fr, lead):
    """{(window end, key word): value} of a [.., F, C] CompactFires."""
    counts = np.asarray(fr.counts).reshape(-1)
    lanes = np.asarray(fr.lane_valid).reshape(-1)
    ends = np.asarray(fr.window_end_ticks).reshape(-1)
    Cf = np.asarray(fr.key_hi).shape[-1]
    khi = np.asarray(fr.key_hi).reshape(-1, Cf).view(np.uint32)
    klo = np.asarray(fr.key_lo).reshape(-1, Cf).view(np.uint32)
    vals = np.asarray(fr.values).reshape(-1, Cf)
    out = {}
    for p in range(len(counts)):
        if not lanes[p]:
            continue
        for j in range(int(counts[p])):
            w = (int(khi[p, j]) << 32) | int(klo[p, j])
            out[(int(ends[p]), w)] = float(vals[p, j])
    return out


def assert_fires_equal(fj, ft):
    for name in ("counts", "window_end_ticks", "n_fires", "lane_valid"):
        np.testing.assert_array_equal(
            getattr(ft, name).numpy().reshape(-1),
            np.asarray(getattr(fj, name)).reshape(-1), err_msg=name)
    assert fire_rows_of(ft, 1) == fire_rows_of(fj, 1)


def drains(seed, layout, per=COUNT):
    """Groups of D staged slots (the last repeated as padding) with COUNT
    live, from torch_parity's six-batch schedule and a second one later
    in event time, so that windows fire in every stage."""
    seq = batches(seed)
    late = []
    for hi, lo, ts, vals, valid, wm, clear in batches(seed + 1):
        late.append((hi, lo, ts + 200, vals, valid, wm + 200, clear))
    seq = seq + late
    if layout == "hash":
        # sparse 64-bit identities of 1,500 keys (load 0.37) in place of
        # the slot-range keys
        seq = [(np.where(b[1] % 3 == 0, 3, 0).astype(np.uint32),
                ((b[1] % 1500) * np.uint32(2654435761)).astype(np.uint32),
                *b[2:]) for b in seq]
    out = []
    for first in range(0, len(seq), per):
        group = seq[first:first + per]
        count = len(group)
        group = group + [group[-1]] * (D - count)
        out.append((group, count))
    return out


CHAINS = {
    "two_direct": ([(10, 10), (40, 40)], "direct", ("sum", "sum"), 1024),
    "two_hash": ([(10, 10), (40, 40)], "hash", ("sum", "sum"), 1024),
    "three_sliding_max": ([(20, 10), (40, 20), (80, 80)], "direct",
                          ("sum", "max", "sum"), 1024),
    "over_full_edge": ([(10, 10), (40, 40)], "direct", ("sum", "sum"), 48),
}


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_chained_drain_matches_reference(case):
    sizes, layout, kinds, E = CHAINS[case]
    specs_j, specs_t = chain_specs(sizes, layout, kinds)
    ctx = MeshContext.create(1, MAXP, devices=jax.devices()[:1])
    drain_j = step_ref.build_window_chained_drain(
        ctx, specs_j, D, exchange_lanes=E, drain_stats=True)
    drain_t = step_port.build_window_chained_drain(
        specs_t, D, MAXP, exchange_lanes=E, drain_stats=True)
    sj = tuple(step_ref.init_sharded_state(ctx, sp) for sp in specs_j)
    st = tuple(step_port.init_shard_state(sp, MAXP, "cpu") for sp in specs_t)
    n_rows = 0
    totals = np.zeros(len(STAGE_STAT_FIELDS), np.int64)
    for group, count in drains(41, layout):
        flat = [a for b in group for a in b[:5]]
        wmv = np.array([[b[5] for b in group]], np.int32)
        sj, _mon_j, fj, (ds_j, ss_j) = drain_j(sj, *flat, wmv,
                                               np.int32(count))
        out = drain_t(st, [lanes_torch(*b[:5]) for b in group],
                      torch.from_numpy(wmv[0]), count)
        assert len(out) == 4
        st, mon_t, ft, (ds_t, ss_t) = out
        assert tuple(ft.counts.shape) == (1, F)
        assert_fires_equal(fj, ft)
        np.testing.assert_array_equal(ds_t.numpy(), np.asarray(ds_j)[0])
        np.testing.assert_array_equal(ss_t.numpy(), np.asarray(ss_j)[:, 0])
        for i, (a, b) in enumerate(zip(sj, st)):
            assert_stage_equal(a, b, ref_packed=i == 0,
                               exact=layout == "direct", kind=kinds[i])
        n_rows += int(ft.counts.sum())
        totals += ss_t.numpy().sum(0)
    assert n_rows > 0 and totals[0] > 0
    if case == "over_full_edge":
        assert totals[3] > 0 and int(st[1].dropped_capacity) >= totals[3]


def test_chain_states_carry_both_ways_mid_stream():
    """Two-slot drains: one in the reference; its stage states (stage 0
    packed, stage 1 split) carry into the port; two drains on both; the
    port's carry back into the reference; the last three drains on both.
    Fires and states stay equal."""
    specs_j, specs_t = chain_specs([(10, 10), (40, 40)], "direct")
    ctx = MeshContext.create(1, MAXP, devices=jax.devices()[:1])
    drain_j = step_ref.build_window_chained_drain(ctx, specs_j, D)
    drain_t = step_port.build_window_chained_drain(specs_t, D, MAXP)
    sj = tuple(step_ref.init_sharded_state(ctx, sp) for sp in specs_j)
    seq = drains(43, "direct", per=2)
    st = None
    n_rows = 0
    for i, (group, count) in enumerate(seq):
        flat = [a for b in group for a in b[:5]]
        wmv = np.array([[b[5] for b in group]], np.int32)
        if i == 1:
            st = tuple(
                wkt.state_from_numpy(ref_leaves(s), s.packed, device="cpu",
                                     red=sp.red)
                for s, sp in zip(sj, specs_t))
        if i == 3:
            sj = tuple(ref_state(port_fields_as_ref(s, k == 0),
                                 0 if k == 0 else -1)
                       for k, s in enumerate(st))
        sj, _m, fj, = drain_j(sj, *flat, wmv, np.int32(count))
        if st is None:
            continue
        st, _mt, ft = drain_t(st, [lanes_torch(*b[:5]) for b in group],
                              torch.from_numpy(wmv[0]), count)
        assert_fires_equal(fj, ft)
        n_rows += int(ft.counts.sum())
        for k, (a, b) in enumerate(zip(sj, st)):
            assert_stage_equal(a, b, ref_packed=k == 0, exact=True)
    assert n_rows > 0 and len(seq) > 5


# ------------------------------------------------------------ public API

N_KEYS = 64
W1 = 10_000
W2 = 20_000


def gen(offset, n):
    idx = np.arange(offset, offset + n)
    cols = {"key": (idx * 48271) % N_KEYS,
            "value": ((idx * 7) % 5).astype(np.float32)}
    return cols, (idx // 50) * 1000


def oracle(total, stages):
    """The host-chained answer: each stage's (key, window end) reduce of
    its input records, re-keyed into the next at ts = window end - 1."""
    idx = np.arange(total)
    recs = list(zip(((idx * 48271) % N_KEYS).tolist(),
                    ((idx // 50) * 1000).tolist(),
                    ((idx * 7) % 5).astype(float).tolist()))
    out = {}
    for size, slide, kind in stages:
        out = {}
        for k, t, v in recs:
            for j in range(size // slide):
                end = (t // slide + 1 + j) * slide
                if end - size <= t:
                    old = out.get((k, end))
                    out[(k, end)] = v if old is None else (
                        old + v if kind == "sum" else max(old, v))
        recs = [(k, e - 1, v) for (k, e), v in out.items()]
    return out


RESIDENT = {
    "pipeline.prefetch": "on",
    "pipeline.device-staging": "on",
    "pipeline.resident-loop": "on",
    "pipeline.update-precombine": "on",
    "state.packed-planes": "on",
    "pipeline.ring-depth": 4,
}


def build(pkg_env, conf_cls, tc, sources, sinks, stages, cfg, total,
          batch=256):
    env = (pkg_env(conf_cls(cfg), device="cpu") if pkg_env is
           StreamExecutionEnvironment else pkg_env(conf_cls(cfg)))
    env.set_parallelism(1).set_max_parallelism(MAXP)
    env.set_stream_time_characteristic(tc.EventTime)
    env.set_state_capacity(256)
    env.batch_size = batch
    sink = sinks.CollectSink()
    s = env.add_source(sources.GeneratorSource(gen, total=total))
    for i, (size, slide, kind) in enumerate(stages):
        get = (lambda c: c["value"]) if i == 0 else (lambda r: r.value)
        key = (lambda c: c["key"]) if i == 0 else (lambda r: r.key)
        w = s.key_by(key).time_window(size, slide)
        s = w.sum(get) if kind == "sum" else w.max(get)
    s.add_sink(sink)
    return env, sink


class _PortSinks:
    CollectSink = CollectSink


class _PortSources:
    GeneratorSource = GeneratorSource


def run_both(stages, cfg, total=4096, batch=256):
    env_j, sink_j = build(RefEnv, RefConfiguration, RefTC, ref_sources,
                          ref_sinks, stages, {**RESIDENT, **cfg}, total,
                          batch)
    env_j.execute("chained")
    env_t, sink_t = build(StreamExecutionEnvironment, Configuration,
                          TimeCharacteristic, _PortSources, _PortSinks,
                          stages, {**RESIDENT, **cfg}, total, batch)
    job = env_t.execute("chained")
    rows_j = {(r.key, r.window_end_ms): r.value for r in sink_j.results}
    rows_t = {(r.key, r.window_end_ms): r.value for r in sink_t.results}
    assert len(rows_t) == len(sink_t.results)
    for name in ("records_in", "fires", "dropped_late", "dropped_capacity"):
        assert getattr(job.metrics, name) == \
            getattr(env_j.last_job.metrics, name), name
    return rows_j, rows_t, env_j, env_t, job


JOBS = {
    "direct": ([(W1, W1, "sum"), (W2, W2, "sum")],
               {"state.backend.layout": "direct"}),
    "hash": ([(W1, W1, "sum"), (W2, W2, "sum")],
             {"state.backend.layout": "hash"}),
    "sliding_stage0": ([(W1, W1 // 2, "sum"), (W2, W2, "sum")], {}),
    "max_stage1": ([(W1, W1, "sum"), (W2, W2, "max")], {}),
    "three_stages": ([(W1, W1, "sum"), (W2, W2, "sum"), (2 * W2, 2 * W2,
                                                         "max")],
                     {"state.backend.layout": "direct"}),
    "three_stages_hash": ([(W1, W1, "sum"), (W2, W2, "max"),
                           (2 * W2, W2, "sum")],
                          {"state.backend.layout": "hash"}),
}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_chained_job_matches_reference_and_oracle(name):
    stages, cfg = JOBS[name]
    rows_j, rows_t, _ej, _et, job = run_both(stages, cfg)
    want = oracle(4096, stages)
    assert rows_t == rows_j == want
    assert job.metrics.resident_drains > 0 and job.metrics.fire_steps == 0


def test_chained_drain_stats_stage_rows_match_reference():
    cfg = {"observability.drain-stats": True,
           "observability.drain-stats-every": 1}
    stages = JOBS["direct"][0]
    rows_j, rows_t, env_j, env_t, _job = run_both(stages, cfg)
    assert rows_t == rows_j
    rep_j, rep_t = env_j._pipeline_report(), env_t._pipeline_report()
    assert rep_t["available"] and rep_t["stage_fields"] == list(
        STAGE_STAT_FIELDS)
    (sj,), (st,) = rep_j["stages"], rep_t["stages"]
    for key in ("stage", "totals", "levels", "edge_lane_budget"):
        assert st[key] == sj[key], key
    assert st["totals"]["edge_events"] == st["totals"]["edge_demand"] > 0
    assert 0 < st["edge_peak_demand"] <= st["edge_lane_budget"]
    # every stage-0 row crossed the edge
    s0 = {}
    idx = np.arange(4096)
    for k, t in zip(((idx * 48271) % N_KEYS).tolist(),
                    ((idx // 50) * 1000).tolist()):
        s0[(k, t // W1)] = True
    assert st["totals"]["edge_events"] == len(s0)


def test_chained_job_drain_stats_off_has_no_report():
    _rows_j, _rows_t, _ej, env_t, _job = run_both(JOBS["direct"][0], {},
                                                  total=2048)
    rep = env_t._pipeline_report()
    assert rep["available"] is False and "reason" in rep


# ------------------------------------------------------------ refusals

def port_env(**cfg):
    env = StreamExecutionEnvironment(Configuration({**RESIDENT, **cfg}),
                                     device="cpu")
    env.set_parallelism(1).set_max_parallelism(MAXP)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(256)
    env.batch_size = 256
    return env


def ref_env(**cfg):
    env = RefEnv(RefConfiguration({**RESIDENT, **cfg}))
    env.set_parallelism(1).set_max_parallelism(MAXP)
    env.set_stream_time_characteristic(RefTC.EventTime)
    env.set_state_capacity(256)
    env.batch_size = 256
    return env


def _chain(env, pkg, key_sel=None, extractor=None, tail="window"):
    src = pkg["GeneratorSource"](gen, total=512)
    s = (env.add_source(src).key_by(lambda c: c["key"]).time_window(W1)
         .sum(lambda c: c["value"]))
    if tail == "window":
        s = (s.key_by(key_sel or (lambda r: r.key)).time_window(W2)
             .sum(extractor or (lambda r: r.value)))
    elif tail == "deep":
        for w in (W2, 2 * W2):
            s = s.key_by(lambda r: r.key).time_window(w).sum(
                lambda r: r.value)
    elif tail == "rolling":
        s = s.key_by(lambda r: r.key).sum(lambda r: r.value)
    elif tail == "two_windows":
        s = s.key_by(lambda r: r.key).time_window(W2).sum(
            lambda r: r.value).key_by(lambda r: r.key).time_window(
            2 * W2).sum(lambda r: r.value)
    s.add_sink(pkg["CollectSink"]())


PORT = {"GeneratorSource": GeneratorSource, "CollectSink": CollectSink}
REF = {"GeneratorSource": ref_sources.GeneratorSource,
       "CollectSink": ref_sinks.CollectSink}

ERRORS = {
    # the cases of tests/test_stages.py, each raising in both packages
    "key_selector": (dict(key_sel=lambda r: r.value), {},
                     "does not preserve the upstream key"),
    "extractor": (dict(extractor=lambda r: r.key), {},
                  "value extractor does not pass"),
    "max_stages": (dict(tail="deep"), {"pipeline.stages.max-stages": 2},
                   "max-stages"),
    "prefetch_off": ({}, {"pipeline.prefetch": "off",
                          "pipeline.device-staging": "auto",
                          "pipeline.resident-loop": "auto"}, "resident"),
    "resident_off": ({}, {"pipeline.resident-loop": "off"}, "resident"),
    "rolling_tail": (dict(tail="rolling"), {}, "window aggregation"),
    "all_to_all": ({}, {"exchange.mode": "all_to_all"}, "all_to_all"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_stage_graph_errors_match_reference(case):
    kw, cfg, match = ERRORS[case]
    env = port_env(**cfg)
    _chain(env, PORT, **kw)
    with pytest.raises(StageGraphError, match=match) as got:
        env.execute("bad")
    env_j = ref_env(**cfg)
    _chain(env_j, REF, **kw)
    with pytest.raises(RefStageGraphError, match=match) as want:
        env_j.execute("bad")
    assert str(got.value) == str(want.value)


def test_stage_graph_validates_every_edge_like_the_reference():
    """Lateness, a count window and a sketch in a chain, and a window with
    no keyBy before it: the port's copied validation raises the
    reference's messages."""
    env = port_env()
    s = (env.add_source(GeneratorSource(gen, total=512))
         .key_by(lambda c: c["key"]).time_window(W1)
         .sum(lambda c: c["value"]))
    s.key_by(lambda r: r.key).time_window(W2).allowed_lateness(
        1000).sum(lambda r: r.value).add_sink(CollectSink())
    with pytest.raises(StageGraphError, match="allowed lateness"):
        env.execute("late")
    env = port_env()
    s = (env.add_source(GeneratorSource(gen, total=512))
         .key_by(lambda c: c["key"]).time_window(W1)
         .sum(lambda c: c["value"]))
    s.key_by(lambda r: r.key).count_window(3).sum(
        lambda r: r.value).add_sink(CollectSink())
    with pytest.raises(StageGraphError, match="count windows"):
        env.execute("count")
    env = port_env()
    s = (env.add_source(GeneratorSource(gen, total=512))
         .key_by(lambda c: c["key"]).time_window(W1)
         .sum(lambda c: c["value"]))
    s.key_by(lambda r: r.key).time_window(W2).distinct_count(
        lambda r: r.value).add_sink(CollectSink())
    with pytest.raises(StageGraphError):
        env.execute("sketch")
    with pytest.raises(StageGraphError, match="at least 2"):
        StageGraph([])


def test_chained_checkpoints_and_parallelism_refuse_naming_their_items(
        tmp_path):
    env = port_env()
    env.enable_checkpointing(1, str(tmp_path))
    _chain(env, PORT)
    with pytest.raises(NotImplementedError, match="item 6"):
        env.execute("ckpt")
    # parallelism 2 runs (the chained drains over the shard mesh), to the
    # rows of parallelism 1
    rows = []
    for n in (1, 2):
        with forced_device_count(2):
            env = port_env()
            env.set_parallelism(n)
            _chain(env, PORT)
            env.execute("sharded")
        rows.append(sorted(env._sinks[0].sink.results))
    assert rows[1] == rows[0] and rows[0]
    env = port_env()
    _chain(env, PORT)
    from flink_tpu_torch.runtime.executor import _translate
    graph = _translate(env._sinks).graph
    with pytest.raises(NotImplementedError, match="item 6"):
        graph.snapshot_chain([], [])
    with pytest.raises(NotImplementedError, match="item 6"):
        graph.restore_chain([], None, [])


def test_chained_job_over_full_edge_fails_strict_capacity():
    """An edge narrower than a drain's stage-0 rows drops lanes into the
    downstream stage's dropped_capacity, and strict capacity fails the
    job as the reference's does."""
    env = port_env(**{"pipeline.stages.exchange-lanes": 16})
    _chain(env, PORT)
    with pytest.raises(RuntimeError, match="exchange-lanes"):
        env.execute("narrow")
    env = port_env(**{"pipeline.stages.exchange-lanes": 16,
                      "state.backend.strict-capacity": False})
    _chain(env, PORT)
    job = env.execute("narrow")
    assert job.metrics.dropped_capacity > 0


def test_chain_two_windows_without_key_by_between_refuse():
    env = port_env()
    (env.add_source(GeneratorSource(gen, total=512))
     .key_by(lambda c: c["key"]).time_window(W1).sum(lambda c: c["value"])
     .add_sink(CollectSink()))
    from flink_tpu_torch.graph import stream_graph as sg
    from flink_tpu_torch.runtime.executor import _translate
    sink_t = env._sinks[0]
    wagg = sink_t.parent
    again = sg.WindowAggTransformation(
        "again", wagg, assigner=wagg.assigner, extractor=lambda r: r.value,
        reduce_spec_factory=wagg.reduce_spec_factory)
    sink_t.parent = again
    with pytest.raises(StageGraphError, match="no keyBy between"):
        _translate([sink_t])


def test_chain_refuses_device_reduced_sinks_and_an_overflow_ring():
    """A device-reduce sink (CountingSink) and an explicit overflow ring
    raise in the port as in the reference: the chain keeps strict capacity
    and emits the final stage's rows."""
    from flink_tpu_torch.runtime.sinks import CountingSink
    for pkg, env, err in ((PORT, port_env(), StageGraphError),
                          (REF, ref_env(), RefStageGraphError)):
        counting = (CountingSink if pkg is PORT
                    else ref_sinks.CountingSink)
        (env.add_source(pkg["GeneratorSource"](gen, total=512))
         .key_by(lambda c: c["key"]).time_window(W1)
         .sum(lambda c: c["value"]).key_by(lambda r: r.key)
         .time_window(W2).sum(lambda r: r.value).add_sink(counting()))
        with pytest.raises(err, match="device-reduced"):
            env.execute("counting")
    for env, pkg in ((port_env(**{"state.backend.overflow-ring": 4096}),
                      PORT),
                     (ref_env(**{"state.backend.overflow-ring": 4096}),
                      REF)):
        _chain(env, pkg)
        with pytest.raises(ValueError, match="overflow-ring is set"):
            env.execute("ring")


def test_chained_job_with_a_downstream_backlog_loses_no_batch(monkeypatch):
    """1 s windows rolled into 2 s ones, two fire lanes a step, 1 s
    batches and ring depth 4: each drain brings stage 1 two due windows,
    filling its lanes, so the next drain's read calls for a flush while
    that drain's batches are staged. The flush runs once they are drained,
    losing none of them: rows and metrics equal the reference's and the
    oracle's."""
    from flink_tpu_torch.runtime.executor import _WindowJob
    owed = []
    consume = _WindowJob.consume

    def spy(self):
        consume(self)
        if self.flush_owed is not None:
            owed.append(len(self.group))

    monkeypatch.setattr(_WindowJob, "consume", spy)
    stages = [(1000, 1000, "sum"), (2000, 2000, "sum")]
    rows_j, rows_t, _ej, _et, job = run_both(
        stages, {"window.fires-per-step": 2}, total=2048, batch=50)
    assert owed and min(owed) > 0
    assert rows_t == rows_j == oracle(2048, stages)
    assert job.metrics.dropped_capacity == 0


def test_chained_flush_records_fire_latency_from_the_crossing(monkeypatch):
    """The end-of-stream flush's rounds record their windows' fire latency
    from the watermark crossing, as the reference's drain_chained does,
    not from each round's own dispatch: under a clock that ticks 1 s a
    dispatch, each flush sample is the time since the crossing, and every
    window is one unit of weight."""
    import types
    from flink_tpu_torch.runtime import executor as ex
    clock = types.SimpleNamespace(t=0.0)
    monkeypatch.setattr(ex, "time", types.SimpleNamespace(
        perf_counter=lambda: clock.t, monotonic=lambda: clock.t))
    job_cls, metrics_cls = ex._WindowJob, ex.JobMetrics
    dispatch, flush = job_cls.dispatch, job_cls.drain_chained
    eos, record = job_cls.end_of_stream, metrics_cls.record_fire_latency
    seen = {"eos": False, "t_cross": None}
    samples = []

    def tick(self):
        clock.t += 1.0
        dispatch(self)

    def flush_spy(self, wm_ms, t_cross=None):
        if seen["eos"]:
            seen["t_cross"] = t_cross
        flush(self, wm_ms, t_cross)

    def eos_spy(self):
        seen["eos"] = True
        eos(self)

    def record_spy(self, n, ms):
        if seen["t_cross"] is not None:
            samples.append((ms, (clock.t - seen["t_cross"]) * 1e3))
        record(self, n, ms)

    monkeypatch.setattr(job_cls, "dispatch", tick)
    monkeypatch.setattr(job_cls, "drain_chained", flush_spy)
    monkeypatch.setattr(job_cls, "end_of_stream", eos_spy)
    monkeypatch.setattr(metrics_cls, "record_fire_latency", record_spy)
    env = port_env()
    _chain(env, PORT)
    m = env.execute("latency").metrics
    assert samples and all(ms == since for ms, since in samples)
    # timed from its own dispatch, a round's fires would read 1 s
    assert min(ms for ms, _ in samples) >= 2000.0
    assert sum(n for n, _ in m.fire_latency._samples) == m.fires > 0
