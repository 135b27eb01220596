"""Tiered key-group state of flink_tpu_torch against flink_tpu and numpy,
on the CPU.

* kernel level: ``update(kg_res=)`` — G1's residency mode, which marks
  the live lanes of non-resident key groups cold, and the divert that
  sends them to the overflow ring with the lanes that have no slot —
  against the reference's ``update(kg_res=)`` on the same numpy-seeded
  lanes: plane, table, ring contents, ``kg_dirty`` and ``activity``
  exactly (a hash table's insert placement logically, since the two
  packages may give a contested key another slot);
* job level: the reference's ``tests/test_tiers.py`` cases through the
  port — a budget of 2 of 8 key groups, dwell 1 — against the port's
  all-resident job, the reference's tiered job and numpy (hash, direct,
  packed), the crash cases at ``tier.demote.write`` and
  ``tier.promote.read`` and a chaos soak (one shard: the reference's
  two-shard variants wait for multi-GPU), and the ``TierManager`` units
  through the port's copy of ``runtime/tiers.py``.

The reference runs with its gated knobs forced on; every value is an
integer, so every comparison is exact.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    C, F, MAXP, R, SLIDE, assert_states_equal, jax_fields, key_halves,
    lanes_torch, logical_state, set_watermark,
)

from flink_tpu.ops import window_kernels as wkj
from flink_tpu_torch.core.keygroups import assign_to_key_group
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import window_kernels as wkt
from flink_tpu_torch.ops.hashing import route_hash
from flink_tpu_torch.runtime import step as step_port
from flink_tpu_torch.runtime import tiers as tiers_mod
from flink_tpu_torch.testing import faults
from flink_tpu_torch.testing.faults import FaultInjector, FaultRule

B = 1024
O = 4096

# ------------------------------------------------------------ kernel level


def _specs():
    return (wkj.WindowSpec(2 * SLIDE, SLIDE, ring=R, fires_per_step=F,
                           overflow=O),
            wkj.ReduceSpec("sum", jnp.float32),
            wkt.WindowSpec(2 * SLIDE, SLIDE, ring=R, fires_per_step=F,
                           overflow=O),
            wkt.ReduceSpec("sum"))


def test_route_lanes_residency_mode():
    """G1's plain version with ``res``: the first four outputs equal G1
    without it, the fifth marks exactly the live lanes of the groups the
    mask leaves out; all groups resident gives no cold lane."""
    rng = np.random.default_rng(11)
    hi, lo = key_halves(rng.integers(-(2**62), 2**62, B))
    ts = rng.integers(0, 5 * SLIDE, B).astype(np.int32)
    valid = rng.random(B) < 0.9
    args = lanes_torch(hi, lo, ts, np.zeros(B, np.float32), valid)
    wm = torch.tensor(2 * SLIDE, dtype=torch.int32)
    pt = torch.tensor(0, dtype=torch.int32)
    kw = dict(slide=SLIDE, k=2, maxp=MAXP, kg_start=0, kg_end=MAXP - 1)
    base = kernels.route_lanes(args[0], args[1], args[2], args[4], wm, pt,
                               **kw)
    res = torch.from_numpy(rng.random(MAXP) < 0.5)
    before = kernels.route_lanes.launches
    got = kernels.route_lanes(args[0], args[1], args[2], args[4], wm, pt,
                              **kw, res=res)
    assert kernels.route_lanes.launches == before      # the plain version
    for a, b in zip(got[:4], base):
        assert torch.equal(a, b)
    pane, kg, live, _stats, cold = got
    assert torch.equal(cold, live & ~res[kg.long()])
    assert cold.any() and (live & ~cold).any()
    none = kernels.route_lanes(args[0], args[1], args[2], args[4], wm, pt,
                               **kw, res=torch.ones(MAXP, dtype=torch.bool))
    assert not none[4].any()


@pytest.mark.parametrize("layout, insert", [
    ("direct", True), ("hash", True), ("hash", False),
], ids=["direct", "hash-insert", "hash-fast"])
def test_update_diverts_cold_lanes_like_the_reference(layout, insert):
    """Four batches with a fresh random residency mask each, too-old
    lanes in the last: the cold lanes claim no slot, add no activity and
    join the ring in lane order beside the no-fit lanes, and still mark
    their groups in kg_dirty — as the reference's ``update(kg_res=)``.
    The fast step runs on a table the reference's insert steps built."""
    win_j, red_j, win_t, red_t = _specs()
    rng = np.random.default_rng(5)
    pool = rng.integers(-(2**63), 2**63 - 1, 1200, dtype=np.int64)
    sj = wkj.init_state(C, 16, win_j, red_j, layout=layout,
                        n_key_groups=MAXP, packed=True)

    def upd_fn(ins):
        @jax.jit
        def upd(st, hi, lo, ts, vals, valid, res):
            return wkj.update(st, win_j, red_j, hi, lo, ts, vals, valid,
                              insert=ins, direct=layout == "direct",
                              precombine=True, kg_res=res)[:2]
        return upd

    upd = upd_fn(insert)
    if not insert:
        # the reference's insert step builds the table the fast step reads
        ins = upd_fn(True)
        hi, lo = key_halves(pool[:1000])
        sj, _ = ins(sj, hi, lo, np.zeros(1000, np.int32),
                    np.ones(1000, np.float32), np.ones(1000, bool),
                    jnp.ones(MAXP, bool))
    st = wkt.state_from_numpy(jax_fields(sj), 0, device="cpu", layout=layout,
                              probe_len=16)
    n_cold = 0
    for i in range(4):
        keys = (rng.integers(0, C + 40, B) if layout == "direct"
                else pool[rng.integers(0, 1200, B)])
        hi, lo = key_halves(keys)
        ts = (rng.integers(i, i + 2, B) * SLIDE
              + rng.integers(0, SLIDE, B)).astype(np.int32)
        if i == 3:
            # 30 lanes nine panes ahead: the rest of the batch falls
            # behind the ring's horizon (too old), cold lanes among them
            ts[:30] = (i + 9) * SLIDE
        vals = rng.integers(1, 9, B).astype(np.float32)
        valid = rng.random(B) < 0.9
        res = rng.random(MAXP) < 0.5
        sj, act_j = upd(sj, hi, lo, ts, vals, valid, jnp.asarray(res))
        st, act_t, _ = wkt.update(st, win_t, red_t,
                                  *lanes_torch(hi, lo, ts, vals, valid),
                                  maxp=MAXP, insert=insert,
                                  kg_res=torch.from_numpy(res))
        sj = set_watermark(sj, st, i * SLIDE)
        assert int(act_t) == int(act_j)
        if layout == "hash" and insert:
            want = logical_state(jax_fields(sj), red_j)
            got = logical_state(wkt.state_to_numpy(st), red_t)
            assert want.keys() == got.keys()
            for name in want:
                np.testing.assert_array_equal(got[name], want[name],
                                              err_msg=name)
        else:
            assert_states_equal(sj, st)
        kg = assign_to_key_group(route_hash(hi, lo, np), MAXP, np)
        n_cold += int((~res[kg] & valid).sum())
    assert n_cold > 0 and int(st.ovf_n) > 0
    assert int(st.dropped_capacity) > 0    # too-old lanes, evicted panes


def test_update_refuses_residency_without_a_ring():
    _w, _r, win_t, red_t = _specs()
    win0 = wkt.WindowSpec(2 * SLIDE, SLIDE, ring=R, fires_per_step=F)
    st = wkt.init_state(C, win0, red_t, n_key_groups=MAXP, device="cpu")
    lanes = lanes_torch(*(np.zeros(4, np.uint32),) * 2,
                        np.zeros(4, np.int32), np.ones(4, np.float32),
                        np.ones(4, bool))
    with pytest.raises(ValueError, match="kg_res"):
        wkt.update(st, win0, red_t, *lanes, maxp=MAXP,
                   kg_res=torch.ones(MAXP, dtype=torch.bool))
    del win_t


def test_tiered_drain_takes_the_mask_as_data():
    """One drain serves every mask, and no mask: rewriting the ``kg_res``
    tensor between drains moves the divert without a rebuild."""
    _w, _r, win_t, red_t = _specs()
    spec = step_port.WindowStageSpec(win_t, red_t, capacity_per_shard=C)
    drain = step_port.build_window_resident_drain(spec, 2, MAXP,
                                                  reduced=False)
    st = step_port.init_shard_state(spec, MAXP, "cpu")
    hi, lo = key_halves(np.arange(64))
    lane = lanes_torch(hi, lo, np.full(64, 5, np.int32),
                       np.ones(64, np.float32), np.ones(64, bool))
    wmv = torch.zeros(2, dtype=torch.int32)
    mask = torch.zeros(MAXP, dtype=torch.bool)
    drain(st, [lane], wmv, 1, mask)
    assert int(st.ovf_n) == 64                    # every group cold
    assert not bool(st.acc.any())
    mask.fill_(True)
    drain(st, [lane], wmv, 1, mask)
    assert int(st.ovf_n) == 64                    # now all resident
    after_hot = st.acc.clone()
    assert bool(after_hot.any())
    drain(st, [lane], wmv, 1)                     # no mask: untiered
    assert int(st.ovf_n) == 64
    assert not torch.equal(st.acc, after_hot)


# ------------------------------------------------------------ job level

N_KEYS = 512
WINDOW_MS = 1000
TOTAL = N_KEYS * 6


def run_job(pkg="torch", tiers=0, packed=None, layout=None, n_keys=N_KEYS,
            capacity=1024, ckpt_dir=None, restart=None, total=TOTAL,
            config=None):
    """The reference test's job (``tests/test_tiers.py run_job``), with a
    ring depth of 2 so that drains, and so swaps, happen while the stream
    runs."""
    opts = {"keys.reverse-map": True, "pipeline.ring-depth": 2,
            **(config or {})}
    if tiers:
        opts["state.tiers.resident-key-groups"] = tiers
        opts["state.tiers.min-dwell-cycles"] = 1
    if packed is not None:
        opts["state.packed-planes"] = packed
    if layout is not None:
        opts["state.backend.layout"] = layout
    if restart:
        opts.update({
            "restart-strategy": "fixed-delay",
            "restart-strategy.fixed-delay.attempts": restart,
            "restart-strategy.fixed-delay.delay": 0,
        })
    if pkg == "jax":
        from flink_tpu import StreamExecutionEnvironment
        from flink_tpu.core.config import Configuration
        from flink_tpu.core.time import TimeCharacteristic
        from flink_tpu.runtime.sinks import CollectSink
        from flink_tpu.runtime.sources import GeneratorSource
        opts.setdefault("state.packed-planes", "on")
        opts.update({"pipeline.update-precombine": "on",
                     "pipeline.resident-loop": "on"})
        kw = {}
    else:
        from flink_tpu_torch import StreamExecutionEnvironment
        from flink_tpu_torch.core.config import Configuration
        from flink_tpu_torch.core.time import TimeCharacteristic
        from flink_tpu_torch.runtime.sinks import CollectSink
        from flink_tpu_torch.runtime.sources import GeneratorSource
        # the drains the tier swaps ride, as the reference's pin
        opts.setdefault("pipeline.resident-loop", "on")
        kw = {"device": "cpu"}
    env = StreamExecutionEnvironment(Configuration(opts), **kw)
    env.set_parallelism(1)
    env.set_max_parallelism(8)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(capacity)
    env.batch_size = 256
    if ckpt_dir:
        env.enable_checkpointing(1, str(ckpt_dir))

    def gen(offset, n):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        keys = idx % n_keys
        ts = (idx * 4 * WINDOW_MS) // total
        return {"key": keys, "value": np.ones(n, np.float32)}, ts

    sink = CollectSink()
    (
        env.add_source(GeneratorSource(gen, total=total))
        .key_by(lambda c: c["key"])
        .time_window(WINDOW_MS)
        .sum(lambda c: c["value"])
        .add_sink(sink)
    )
    env.execute("tiers-job")
    got = {}
    for r in sink.results:
        k = (int(r.key), int(r.window_end_ms))
        # a window re-emitted after a restore carries the same value
        assert got.get(k, float(r.value)) == float(r.value)
        got[k] = float(r.value)
    return env, got


def expected(n_keys=N_KEYS, total=TOTAL):
    idx = np.arange(total)
    keys = idx % n_keys
    ts = (idx * 4 * WINDOW_MS) // total
    out = {}
    for k, t in zip(keys.tolist(), ts.tolist()):
        we = (t // WINDOW_MS + 1) * WINDOW_MS
        out[(k, we)] = out.get((k, we), 0) + 1.0
    return out


METRICS = ("records_in", "fires", "steps", "dropped_late",
           "dropped_capacity", "restarts")


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(layout="direct", n_keys=200, capacity=256),
    dict(packed="on"),
], ids=["hash", "direct", "packed"])
def test_tiered_bit_exact_vs_all_resident(kwargs):
    """Budget 2 of 8 key groups, dwell 1 (maximum churn): every window
    equals the port's all-resident job, the reference's tiered job and
    numpy; both managers really swapped (how often depends on when each
    package's drains land between poll cycles — the reference's prefetch
    thread moves them from run to run); and the metrics the two packages
    share are equal."""
    _, base = run_job(**kwargs)
    env, tiered = run_job(tiers=2, **kwargs)
    env_j, tiered_j = run_job("jax", tiers=2, **kwargs)
    assert tiered == base == tiered_j == expected(
        kwargs.get("n_keys", N_KEYS))
    rep = env._pipeline_report()["tiers"]
    assert rep["budget_per_shard"] == 2
    assert rep["demotes"] > 0 and rep["promotes"] > 0
    rep_j = env_j._pipeline_report()["tiers"]
    assert rep_j["demotes"] > 0 and rep_j["promotes"] > 0
    assert rep["resident_groups"] == rep_j["resident_groups"] == 2
    m, mj = env.last_job.metrics, env_j.last_job.metrics
    assert {k: getattr(m, k) for k in METRICS} == \
        {k: getattr(mj, k) for k in METRICS}
    assert m.tier_swap_s > 0
    gauges = {k: f() for k, f in env._gauges.items()}
    assert gauges == {"tier_resident_groups": 2,
                      "tier_faults": rep["faults"],
                      "tier_prefetch_hits": rep["prefetch_hits"],
                      "tier_prefetch_misses": rep["prefetch_misses"]}


def test_tiers_feed_on_the_recorder_and_the_fill():
    """With drain-stats and kg-stats on, the manager ranks on the flight
    recorder's heat and counts tier faults from G1's sampled fill: the
    rows stay exact and the report rides the recorder's."""
    env, got = run_job(tiers=2, config={
        "observability.drain-stats": True,
        "observability.drain-stats-every": 1,
        "observability.kg-stats": True})
    assert got == expected()
    rep = env._pipeline_report()
    assert rep["available"] and rep["tiers"]["faults"] > 0
    assert rep["tiers"]["demotes"] > 0


def test_tiers_require_spillable_overflow():
    """The tier gate is a config error, never a silent downgrade: with
    the overflow ring forced off there is no cold route."""
    with pytest.raises(ValueError, match="state.tiers"):
        run_job(tiers=2, config={"state.backend.overflow-ring": 0})


# ------------------------------------ exactly-once across tier faults

@pytest.mark.parametrize("point, exc, at", [
    ("tier.demote.write", RuntimeError("injected demote crash"), 1),
    ("tier.promote.read", OSError("injected promote read failure"), 3),
], ids=["demote", "promote"])
def test_tier_crash_restores_exactly_once(tmp_path, point, exc, at):
    """A crash at a tier seam — between a demote and its checkpoint, or
    mid-read of a promote — restores the last cut, which re-seeds both
    tiers, and replays: nothing skipped, nothing double-counted."""
    inj = FaultInjector([FaultRule(point, exc=exc, at=at)])
    with faults.active(inj):
        env, got = run_job(tiers=2, ckpt_dir=tmp_path / "chk", restart=3)
    assert inj.fired_at(point), f"{point} never fired"
    assert env.last_job.metrics.restarts == 1
    assert got == expected()


def test_tier_chaos_soak_exactly_once(tmp_path):
    """Both tier seams and the drain seam fire repeatedly; every crash
    lands at a different swap. The final window set is numpy's."""
    inj = FaultInjector([
        FaultRule("tier.demote.write", exc=RuntimeError("chaos demote"),
                  every=4, times=2),
        FaultRule("tier.promote.read", exc=OSError("chaos promote"),
                  every=5, times=2),
        FaultRule("step.drain", exc=RuntimeError("chaos drain"), at=3),
    ], seed=18)
    with faults.active(inj):
        env, got = run_job(tiers=2, ckpt_dir=tmp_path / "chk", restart=8)
    fired = {f["point"] for f in inj.fired}
    assert fired == {"tier.demote.write", "tier.promote.read", "step.drain"}
    assert env.last_job.metrics.restarts >= 3
    assert got == expected()


# ------------------------------------------- TierManager planner units

def _mgr(**kw):
    return tiers_mod.TierManager(
        8, np.asarray([0]), np.asarray([7]), kw.pop("budget", 2), **kw)


def test_manager_rejects_zero_budget():
    with pytest.raises(ValueError):
        _mgr(budget=0)


def test_urgent_promote_beats_dwell_and_counts_hits():
    """A cold group with a pane due inside the watermark horizon is
    promoted though the incumbents' dwell has not expired; traffic on it
    is a prefetch hit, traffic on a demoted group a tier fault."""
    tm = _mgr(budget=2, min_dwell_cycles=100, prefetch_ahead_panes=2)
    heat = np.asarray([9.0, 8.0, 0.1, 0.0, 0, 0, 0, 0])
    last = np.asarray([0, 0, 0, -1, -1, -1, -1, -1])
    tm.note_cold([2], [5])
    tm._last_flip[2] = 0
    plan = tm.plan(heat, last, seq=1, wm_pane=4)
    assert 2 in set(plan.promote)
    assert len(plan.demote) == len(plan.promote)
    tm.apply(plan)
    assert tm.mask()[2]
    kg_sum = np.zeros(8, np.int64)
    kg_sum[2] = 10
    tm.note_sample(kg_sum)
    assert tm.report()["prefetch_hits"] == 1
    kg_sum2 = np.zeros(8, np.int64)
    kg_sum2[plan.demote[0]] = 3
    tm.note_sample(kg_sum2)
    assert tm.report()["faults"] == 1


def test_rescale_reslices_residency_and_keeps_counters():
    tm = _mgr(budget=2)
    assert tm.report()["resident_groups"] == 2
    tm.note_cold([5], [1])
    tm.rescale(np.asarray([0, 4]), np.asarray([3, 7]))
    rep = tm.report()
    assert rep["resident_groups"] == 4
    assert rep["cold_groups_pending"] == 1
    assert tm.shard_of(5) == 1


def test_max_swaps_cap_carries_residue_forward():
    tm = _mgr(budget=1, min_dwell_cycles=0, max_swaps_per_cycle=1)
    heat = np.zeros(8)
    heat[5] = 100.0
    last = np.full(8, -1, np.int64)
    last[5] = 0
    p1 = tm.plan(heat, last, seq=1)
    assert (p1.demote, p1.promote) == ([0], [])
    tm.apply(p1)
    p2 = tm.plan(heat, last, seq=2)
    assert (p2.demote, p2.promote) == ([], [5])
    tm.apply(p2)
    assert tm.mask()[5] and not tm.mask()[0]
    tm2 = _mgr(budget=1, min_dwell_cycles=0)
    p = tm2.plan(heat, last, seq=1)
    assert (p.demote, p.promote) == ([0], [5])


def test_rescale_accepts_unequal_ranges():
    tm = tiers_mod.TierManager(
        8, np.asarray([0, 4]), np.asarray([3, 7]), budget=2)
    assert sorted(np.nonzero(tm.mask())[0]) == [0, 1, 4, 5]
    tm._prefetched.add(3)
    tm.rescale(np.asarray([0, 6]), np.asarray([5, 7]))
    assert sorted(np.nonzero(tm.mask())[0]) == [0, 1, 6, 7]
    assert not tm._prefetched
    assert tm.shard_of(5) == 0 and tm.shard_of(6) == 1


def test_entry_helpers_match_the_reference():
    """The copied entry-plane helpers (key groups, ring window,
    pre-combine) give the reference's results on the same entries."""
    from flink_tpu.runtime import tiers as tiers_ref
    rng = np.random.default_rng(3)
    hi, lo = key_halves(rng.integers(0, 40, 300))
    entries = {"key_hi": hi, "key_lo": lo,
               "pane": rng.integers(0, 9, 300).astype(np.int32),
               "value": rng.integers(1, 5, 300).astype(np.float32),
               "fresh": rng.random(300) < 0.2}
    np.testing.assert_array_equal(
        tiers_mod.entries_key_groups(entries, 8),
        tiers_ref.entries_key_groups(entries, 8))
    for ours, theirs in zip(tiers_mod.ring_window(entries, 7, 4),
                            tiers_ref.ring_window(entries, 7, 4)):
        for k in entries:
            np.testing.assert_array_equal(ours[k], theirs[k])
    ours = tiers_mod.precombine_entries(entries, 1, np.add, 0.0)
    theirs = tiers_ref.precombine_entries(entries, 1, np.add, 0.0)
    for k in entries:
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert dataclasses.is_dataclass(tiers_mod.TierPlan)
