"""The port's skew telemetry and drain flight recorder against flink_tpu's,
on the same numpy-seeded inputs (the port on the CPU: each kernel's plain
version; the reference on its CPU mesh):

* the key-group fill — ``kg_batch_fill`` and the fill vector the update
  returns with ``kg_fill`` (G1's fill on the card) — against the
  reference's ``kg_batch_fill`` and ``update(..., kg_fill=maxp)`` with
  pre-combine on and off, over batches with late, too-old and no-fit
  lanes;
* ``kg_occupancy`` (G17 on the card) on reference states carried across
  with ``state_from_numpy``: packed sum and max planes, a generic
  reduce's split plane, the direct and hash layouts, and fresh cells of
  lateness set alike on both sides;
* the resident drain's ``[D, 9]`` flight-recorder payload (G18) and its
  summed fill, against the reference's drain built with ``kg_fill`` and
  ``drain_stats``, two drains of ``count < D`` live slots;
* whole jobs (the reference's ``tests/test_tracing.py`` windowed job):
  ``_pipeline_report()`` and ``_kg_report()`` at the keys the reference's
  gating tests assert, the off default building no recorder, and
  ``observability.tracing`` refused.

All of it is integer: every comparison is exact.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    C, MAXP, batches, jax_fields, lanes_torch, reduce_pair, reduce_values,
    sparse_batches, specs,
)

from flink_tpu import StreamExecutionEnvironment as RefEnv
from flink_tpu.core.config import Configuration as RefConfiguration
from flink_tpu.core.time import TimeCharacteristic as RefTC
from flink_tpu.ops import window_kernels as wkj
from flink_tpu.parallel.mesh import MeshContext
from flink_tpu.runtime import step as step_ref
from flink_tpu.runtime.sinks import CountingSink as RefCountingSink
from flink_tpu.runtime.sources import GeneratorSource as RefGeneratorSource
from flink_tpu_torch import StreamExecutionEnvironment
from flink_tpu_torch.core.config import Configuration
from flink_tpu_torch.core.time import TimeCharacteristic
from flink_tpu_torch.metrics.drain_stats import DRAIN_STAT_FIELDS
from flink_tpu_torch.ops import window_kernels as wkt
from flink_tpu_torch.runtime import step as step_port
from flink_tpu_torch.runtime.sinks import CountingSink
from flink_tpu_torch.runtime.sources import GeneratorSource

D, COUNT = 4, 3


# ------------------------------------------------------------ kg fill

def _ref_update(win, red, direct, precombine):
    def upd(st, hi, lo, ts, vals, valid, clear):
        return wkj.update(st, win, red, hi, lo, ts, vals, valid,
                          direct=direct, insert=True, precombine=precombine,
                          kg_fill=MAXP, clear_rows=clear)
    return jax.jit(upd)


@pytest.mark.parametrize("precombine", [True, False])
def test_update_fill_matches_reference(precombine):
    """Every batch's fill vector equals the reference's, counted before
    the late check: late, too-old and no-fit lanes (keys past capacity,
    a nonzero high word) included; and kg_batch_fill of the owned lanes
    equals both."""
    win_j, red_j, win_t, red_t = specs("sliding")
    sj = wkj.init_state(C, 16, win_j, red_j, layout="direct",
                        n_key_groups=MAXP, packed=True)
    st = wkt.init_state(C, win_t, red_t, n_key_groups=MAXP, device="cpu")
    upd = _ref_update(win_j, red_j, True, precombine)
    late_seen = nofit_seen = 0
    for hi, lo, ts, vals, valid, wm, clear in batches(23):
        late0 = int(st.dropped_late)
        sj, _act, kgf_j = upd(sj, hi, lo, ts, vals, valid, clear)
        lanes = lanes_torch(hi, lo, ts, vals, valid)
        _st, _act_t, kgf_t = wkt.update(
            st, win_t, red_t, *lanes, maxp=MAXP, kg_fill=MAXP,
            clear_rows=torch.from_numpy(clear))
        np.testing.assert_array_equal(kgf_t.numpy(), np.asarray(kgf_j))
        assert int(kgf_t.sum()) == int(valid.sum())
        kg = wkj.assign_to_key_group(
            wkj.route_hash(jnp.asarray(hi), jnp.asarray(lo), jnp), MAXP, jnp)
        np.testing.assert_array_equal(
            wkt.kg_batch_fill(torch.from_numpy(np.asarray(kg, np.int32)),
                              lanes[4], MAXP).numpy(),
            np.asarray(wkj.kg_batch_fill(kg, jnp.asarray(valid), MAXP)))
        late_seen += int(st.dropped_late) - late0
        nofit_seen += int(((hi != 0) | (lo >= C))[valid].sum())
        sj = dataclasses.replace(
            sj, watermark=jnp.maximum(sj.watermark, jnp.int32(int(wm))))
        st.watermark.copy_(torch.maximum(
            st.watermark, torch.tensor(int(wm), dtype=torch.int32)))
    assert late_seen > 0 and nofit_seen > 0


def test_mask_update_shard_fill_matches_reference():
    """The mask route's fill (the drains' per-slot body) in the hash
    layout, against the reference's mask_update_shard(kg_fill=True)."""
    win_j, red_j, win_t, red_t = specs("tumbling")
    spec_j = step_ref.WindowStageSpec(win=win_j, red=red_j,
                                      capacity_per_shard=C, layout="hash",
                                      precombine=True, packed=True)
    spec_t = step_port.WindowStageSpec(win=win_t, red=red_t,
                                       capacity_per_shard=C, layout="hash")
    sj = wkj.init_state(C, 16, win_j, red_j, layout="hash",
                        n_key_groups=MAXP, packed=True)
    st = step_port.init_shard_state(spec_t, MAXP, "cpu")
    body = jax.jit(lambda s, hi, lo, ts, v, ok, wm: step_ref.mask_update_shard(
        s, spec_j, jnp.int32(0), jnp.int32(MAXP - 1), hi, lo, ts, v, ok, wm,
        MAXP, kg_fill=True))
    for hi, lo, ts, vals, valid, wm, _clear in sparse_batches(29)[:4]:
        sj, _act, kgf_j = body(sj, hi, lo, ts, vals, valid, jnp.int32(wm))
        _st, _act_t, kgf_t = step_port.mask_update_shard(
            st, spec_t, 0, MAXP - 1, *lanes_torch(hi, lo, ts, vals, valid),
            torch.tensor(int(wm), dtype=torch.int32), MAXP, kg_fill=True)
        np.testing.assert_array_equal(kgf_t.numpy(), np.asarray(kgf_j))


def test_fill_off_is_empty_and_group_count_checked():
    _, _, win_t, red_t = specs("tumbling")
    st = wkt.init_state(C, win_t, red_t, n_key_groups=MAXP, device="cpu")
    hi, lo, ts, vals, valid, _wm, _c = batches(3)[0]
    _st, _act, kgf = wkt.update(st, win_t, red_t,
                                *lanes_torch(hi, lo, ts, vals, valid),
                                maxp=MAXP)
    assert kgf.shape == (0,) and kgf.dtype == torch.int32
    with pytest.raises(ValueError):
        wkt.update(st, win_t, red_t, *lanes_torch(hi, lo, ts, vals, valid),
                   maxp=MAXP, kg_fill=MAXP // 2)


# ------------------------------------------------------------ occupancy

OCC_CASES = [("sum", "direct"), ("max", "direct"), ("sum", "hash"),
             ("gsum", "direct"), ("gsum", "hash")]


def _occupancy_states(kind, layout):
    """A reference state after four batches of the schedule, and the same
    state carried to the port."""
    red_j, red_t, packed = reduce_pair(kind)
    win_j, _, win_t, _ = specs("sliding")
    sj = wkj.init_state(C, 16, win_j, red_j, layout=layout,
                        n_key_groups=MAXP, packed=packed)
    upd = jax.jit(lambda s, hi, lo, ts, v, ok, clear: wkj.update(
        s, win_j, red_j, hi, lo, ts, v, ok, direct=layout == "direct",
        insert=True, precombine=packed, clear_rows=clear)[0])
    seq = batches(31) if layout == "direct" else sparse_batches(31)
    for i, (hi, lo, ts, vals, valid, wm, clear) in enumerate(seq[:4]):
        sj = upd(sj, hi, lo, ts, reduce_values(kind, vals, i), valid, clear)
        sj = dataclasses.replace(
            sj, watermark=jnp.maximum(sj.watermark, jnp.int32(int(wm))))
    st = wkt.state_from_numpy(jax_fields(sj), sj.packed, device="cpu",
                              layout=layout, red=red_t)
    return sj, st, red_j, red_t, win_t


@pytest.mark.parametrize("kind,layout", OCC_CASES)
def test_kg_occupancy_matches_reference(kind, layout):
    sj, st, red_j, red_t, win_t = _occupancy_states(kind, layout)
    want = np.asarray(wkj.kg_occupancy(sj, MAXP, red=red_j))
    got = wkt.kg_occupancy(st, MAXP, red_t, win_t)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(got.sum()) <= C
    occ = step_port.build_kg_occupancy_step(
        step_port.WindowStageSpec(win=win_t, red=red_t,
                                  capacity_per_shard=C, layout=layout),
        MAXP)(st)
    np.testing.assert_array_equal(occ.numpy(), want)


@pytest.mark.parametrize("kind", ["sum", "gsum"])
def test_kg_occupancy_counts_fresh_cells(kind):
    """Lateness's fresh cells keep a slot alive: the same fresh flags, set
    on slots with no touched cell on both sides, count alike; a window
    spec without lateness does not read them."""
    sj, st, red_j, red_t, win_t = _occupancy_states(kind, "direct")
    R = win_t.ring
    rng = np.random.default_rng(5)
    touched = np.asarray(wkj.kg_occupancy(sj, MAXP, red=red_j)).sum()
    fresh = np.zeros(C * R, bool)
    fresh[rng.integers(0, C * R, 200)] = True
    sj = dataclasses.replace(sj, fresh=jnp.asarray(fresh))
    st.fresh.copy_(torch.from_numpy(fresh))
    want = np.asarray(wkj.kg_occupancy(sj, MAXP, red=red_j))
    win_l = dataclasses.replace(win_t, lateness_ticks=25)
    got = wkt.kg_occupancy(st, MAXP, red_t, win_l)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > touched
    assert int(wkt.kg_occupancy(st, MAXP, red_t, win_t).sum()) == touched


# ------------------------------------------------------------ the drain

@pytest.mark.parametrize("layout", ["direct", "hash"])
def test_drain_payload_matches_reference(layout):
    """The [D, 9] flight recorder and the summed fill of two drains with
    count = 3 < D = 4 live slots: zeros past count, every field equal."""
    win_j, red_j, win_t, red_t = specs("sliding")
    spec_j = step_ref.WindowStageSpec(win=win_j, red=red_j,
                                      capacity_per_shard=C, layout=layout,
                                      precombine=True, packed=True)
    spec_t = step_port.WindowStageSpec(win=win_t, red=red_t,
                                       capacity_per_shard=C, layout=layout)
    ctx = MeshContext.create(1, MAXP, devices=jax.devices()[:1])
    drain_j = step_ref.build_window_resident_drain(
        ctx, spec_j, D, reduced=True, kg_fill=True, drain_stats=True)
    drain_t = step_port.build_window_resident_drain(
        spec_t, D, MAXP, kg_fill=True, drain_stats=True)
    sj = step_ref.init_sharded_state(ctx, spec_j)
    st = step_port.init_shard_state(spec_t, MAXP, "cpu")
    seq = batches(37) if layout == "direct" else sparse_batches(37)
    totals = np.zeros(len(DRAIN_STAT_FIELDS), np.int64)
    for first in (0, COUNT):
        group = seq[first:first + D]
        group += [group[-1]] * (D - len(group))
        flat = [a for b in group for a in b[:5]]
        wmv = np.array([[b[5] for b in group]], np.int32)
        sj, (_o, _a, kgf_j), _fr, ds_j = drain_j(sj, *flat, wmv,
                                                 np.int32(COUNT))
        out = drain_t(st, [lanes_torch(*b[:5]) for b in group],
                      torch.from_numpy(wmv[0]), COUNT)
        assert len(out) == 4
        st, (_o_t, _a_t, kgf_t), _fr_t, ds_t = out
        assert tuple(ds_t.shape) == (D, len(DRAIN_STAT_FIELDS))
        np.testing.assert_array_equal(ds_t.numpy(), np.asarray(ds_j)[0])
        np.testing.assert_array_equal(kgf_t.numpy(), np.asarray(kgf_j)[0])
        assert not ds_t[COUNT:].any()
        totals += ds_t.numpy().sum(0)
    f = {n: totals[i] for i, n in enumerate(DRAIN_STAT_FIELDS)}
    # the drains reached what the recorder counts
    assert f["events"] > 0 and f["fired_keys"] > 0 and f["late_dropped"] > 0
    assert f["nofit_dropped"] > 0 and f["panes_advanced"] > 0


def test_drain_without_telemetry_keeps_three_outputs():
    _, _, win_t, red_t = specs("tumbling")
    spec_t = step_port.WindowStageSpec(win=win_t, red=red_t,
                                       capacity_per_shard=C)
    drain_t = step_port.build_window_resident_drain(spec_t, 2, MAXP)
    st = step_port.init_shard_state(spec_t, MAXP, "cpu")
    b = batches(4)[:2]
    out = drain_t(st, [lanes_torch(*x[:5]) for x in b],
                  torch.tensor([x[5] for x in b], dtype=torch.int32), 2)
    assert len(out) == 3 and out[1][2].shape == (0,)


# ------------------------------------------------------------ whole jobs

def _gen(offset, n):
    idx = np.arange(offset, offset + n, dtype=np.int64)
    return {"key": idx % 100, "value": np.ones(n, np.float32)}, idx // 10


def _windowed_env(port: bool, extra=None, total=8192):
    """tests/test_tracing.py's _windowed_env, on either package, with
    tracing off."""
    cfg = {"observability.tracing": False,
           "observability.kg-stats-interval-ms": 0, **(extra or {})}
    if port:
        env = StreamExecutionEnvironment(Configuration(cfg), device="cpu")
        tc, sink, src = TimeCharacteristic, CountingSink(), GeneratorSource
    else:
        env = RefEnv(RefConfiguration(cfg))
        tc, sink, src = RefTC, RefCountingSink(), RefGeneratorSource
    env.set_parallelism(1)
    env.set_max_parallelism(8)
    env.set_stream_time_characteristic(tc.EventTime)
    env.set_state_capacity(1 << 12)
    env.batch_size = 1024
    (env.add_source(src(_gen, total=total))
     .key_by(lambda c: c["key"]).time_window(500)
     .sum(lambda c: c["value"]).add_sink(sink))
    return env, sink


RESIDENT = {"pipeline.prefetch": "on", "pipeline.device-staging": "on",
            "pipeline.resident-loop": "on", "pipeline.ring-depth": 4}
TELEMETRY = {"observability.drain-stats": True,
             "observability.drain-stats-every": 1,
             "observability.kg-stats": True}


@pytest.mark.parametrize("port", [False, True], ids=["reference", "port"])
def test_reports_at_the_reference_keys(port):
    """drain-stats and kg-stats on without tracing: the keys and values
    the reference's test_drain_stats_gating and test_kg_stats_gating
    assert, and the same key sets from both packages. The port reads the
    recorder with every drain's fires, so its totals hold every event and
    its fill every lane of the sampled batches; the reference reads its
    payloads and fill samples lagged and leaves the last ones unread at
    the end of a stream, so there the totals are only above 0 and this
    short job's fill may have no sample."""
    env, sink = _windowed_env(port, {**RESIDENT, **TELEMETRY})
    env.execute("telemetry")
    assert sink.value_sum == 8192
    rep = env._pipeline_report()
    assert rep["available"] is True
    assert rep["n_shards"] == 1 and rep["ring_depth"] == 4
    assert rep["drains"] > 0 and rep["payload_fetches"] > 0
    shard = rep["shards"][0]
    assert shard["totals"]["events"] == 8192 if port else \
        shard["totals"]["events"] > 0
    assert shard["occupancy"]
    assert set(rep) >= {"available", "n_shards", "ring_depth", "drains",
                        "payload_fetches", "fields", "shards", "latency_ms",
                        "drain_stats_every", "kg_heat"}
    assert set(shard) >= {"shard", "duty_cycle", "ring_starved",
                          "slot_fill", "occupancy", "totals", "levels"}
    assert list(shard["totals"]) == ["events", "activity", "fire_lanes",
                                     "fired_keys", "late_dropped",
                                     "nofit_dropped", "panes_advanced"]
    kg = env._kg_report(8)
    assert set(kg) == {"key_groups", "n_shards", "occupancy_top",
                       "fill_top", "fill_sampled_batches",
                       "occupied_groups"}
    assert kg["key_groups"] == 8 and kg["occupied_groups"] > 0
    if port:
        assert kg["fill_sampled_batches"] > 0
        assert sum(r["count"] for r in kg["fill_top"]) == \
            1024 * kg["fill_sampled_batches"]


def test_port_telemetry_counts_every_fire_and_pane():
    """The port's recorder against the job's own counts: the drains' fired
    keys are the fires less the watermark-only advances', the panes its
    slots crossed plus those advances' are the stream's, and the
    occupancy at the last refresh holds the last window's 100 keys."""
    env, _sink = _windowed_env(True, {**RESIDENT, **TELEMETRY})
    job = env.execute("telemetry")
    m = job.metrics
    tot = env._pipeline_report()["shards"][0]["totals"]
    assert tot["fired_keys"] == m.fires - m.fire_step_fires
    assert tot["late_dropped"] == tot["nofit_dropped"] == 0
    # watermarks 101 after the first batch, 818 after the last (ticks
    # of 10 events), then the end-of-stream jump to 2^31 - 4
    from flink_tpu_torch.runtime.executor import panes_crossed
    want = 818 // 500 - 101 // 500 + panes_crossed(818, 2**31 - 4, 500)
    assert tot["panes_advanced"] + m.fire_step_panes == want
    kg = env._kg_report(8)
    assert sum(r["count"] for r in kg["occupancy_top"]) == 100


@pytest.mark.parametrize("port", [False, True], ids=["reference", "port"])
def test_telemetry_off_by_default(port):
    """Tracing off and no flag: no recorder, and no occupancy."""
    env, _ = _windowed_env(port, RESIDENT, total=4096)
    env.execute("default")
    rep = env._pipeline_report()
    assert rep["available"] is False and "reason" in rep
    kg = env._kg_report()
    assert kg["fill_sampled_batches"] == 0 and not kg["occupancy_top"]


def test_tracing_is_refused():
    env, _ = _windowed_env(True, {"observability.tracing": True})
    with pytest.raises(NotImplementedError, match="item 15"):
        env.execute("traced")
