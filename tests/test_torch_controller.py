"""The port's self-tuning controller (flink_tpu_torch/runtime/controller.py,
a copy of the reference's) and its wiring in the window runner, on the
CPU:

* the reference's unit cases (tests/test_controller.py) on the port's
  copy: the actuators' moves, the heat-balanced partition and its gain,
  the hill-climb's probation, auto-revert and cooldown, the regime
  fallback, the rebalance arm's gates and failure ledger, interval
  gating, and the ledger persisted and merged across a restart;
* ``controller.enabled: true`` on port jobs: each actuator registered in
  the mode the reference registers it in (the same set as the
  reference's), a forced ``dispatch-group`` move mid-job with every row
  exact and the ledger persisted in the checkpoint directory, and a
  one-shard job under skewed key-group heat that never rebalances, its
  rebalancer raising ``NotImplementedError`` citing item 10 when called.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import json

import numpy as np
import pytest

from test_torch_ingest import build_env, expected, run_job

from flink_tpu_torch.runtime import controller as controller_mod
from flink_tpu_torch.runtime.controller import (
    ACTUATOR_NAMES,
    Actuator,
    RuntimeController,
    plan_balanced_slices,
    predicted_gain,
    shard_heats,
)
from flink_tpu_torch.runtime.sources import GeneratorSource

# ------------------------------------------------------------ actuators


def _holder_actuator(name="ring-fill-target", value=8, lo=1, hi=16,
                     step="geometric"):
    box = [value]
    return box, Actuator(name, lambda: box[0],
                         lambda v: box.__setitem__(0, v),
                         lo=lo, hi=hi, step=step)


def test_actuator_move_geometric_and_additive():
    _, act = _holder_actuator(value=8, lo=1, hi=16)
    assert act.move("up") == (8, 16)
    assert act.move("down") == (8, 4)
    box, act = _holder_actuator(value=16, lo=1, hi=16)
    assert act.move("up") == (16, 16)      # clamped at hi
    box[0] = 1
    assert act.move("down") == (1, 1)      # clamped at lo (1//2=0 -> 1)
    _, add = _holder_actuator(value=3, lo=0, hi=4, step="additive")
    assert add.move("up") == (3, 4)
    assert add.move("down") == (3, 2)


def test_unknown_actuator_rejected():
    _, act = _holder_actuator(name="ring-fill-target")
    with pytest.raises(ValueError, match="unregistered"):
        RuntimeController({"warp-factor": act}, sensor=lambda: {})
    # every declared name is accepted
    for name in ACTUATOR_NAMES:
        if name == "rebalance-key-groups":
            continue          # the rebalance arm, not a knob
        _, a = _holder_actuator(name=name)
        RuntimeController({name: a}, sensor=lambda: {})


# ------------------------------------------------- balanced partitioning


def test_balanced_slices_uniform_heat_is_even():
    starts, ends = plan_balanced_slices(np.ones(64), 4)
    assert starts == [0, 16, 32, 48]
    assert ends == [15, 31, 47, 63]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_balanced_slices_cover_and_monotone(n_shards):
    rng = np.random.default_rng(3)
    heat = rng.exponential(1.0, 32) * (rng.random(32) < 0.3)
    starts, ends = plan_balanced_slices(heat, n_shards)
    assert starts[0] == 0 and ends[-1] == 31
    for s in range(n_shards):
        assert ends[s] >= starts[s]          # every shard non-empty
        if s:
            assert starts[s] == ends[s - 1] + 1
    assert ends == sorted(ends)
    assert len(set(ends)) == n_shards        # strictly increasing


def test_balanced_slices_concentrated_heat():
    heat = np.zeros(64)
    heat[[1, 3, 5, 7]] = 100.0
    starts, ends = plan_balanced_slices(heat, 4)
    # closest-boundary prefix partition: one hot group per shard
    new = shard_heats(heat, starts, ends)
    assert new == [100.0, 100.0, 100.0, 100.0]
    gain = predicted_gain(heat, [0, 16, 32, 48], [15, 31, 47, 63],
                          starts, ends)
    assert gain == pytest.approx(4.0)


def test_balanced_slices_too_few_groups_raises():
    with pytest.raises(ValueError, match="cannot slice"):
        plan_balanced_slices(np.ones(3), 4)


def test_predicted_gain_identity():
    heat = np.array([4.0, 0.0, 0.0, 4.0])
    assert predicted_gain(heat, [0, 2], [1, 3], [0, 2], [1, 3]) == 1.0


# --------------------------------------------------- controller units


class _Rig:
    """Fake world: a records counter, a manual clock, a knob, and
    switchable doctor findings."""

    def __init__(self, **ctl_kw):
        self.t = [0.0]
        self.records = [0]
        self.findings = []
        self.heat = None
        self.kg = ([0, 4], [3, 7])
        self.rebalance_calls = []
        self.rebalance_exc = None
        self.box, self.act = _holder_actuator(value=8, lo=1, hi=16)
        kw = dict(interval_cycles=1, probation_cycles=2,
                  cooldown_cycles=4, rebalance_threshold=1.5,
                  min_rebalance_interval=10.0, min_gain=1.2,
                  clock=lambda: self.t[0])
        kw.update(ctl_kw)
        self.ctl = RuntimeController(
            {"ring-fill-target": self.act}, self.sensor,
            findings_fn=lambda: self.findings,
            rebalancer=self.rebalance, **kw)

    def sensor(self):
        starts, ends = self.kg
        return {"records": self.records[0], "duty": 0.2, "starved": 0.0,
                "heat": self.heat, "kg_starts": list(starts),
                "kg_ends": list(ends)}

    def rebalance(self, starts, ends):
        if self.rebalance_exc is not None:
            raise self.rebalance_exc
        self.rebalance_calls.append((list(starts), list(ends)))

    def tick(self, dt=1.0, drecords=1000):
        self.t[0] += dt
        self.records[0] += drecords
        self.ctl.service()


def test_tune_probation_autorevert_and_cooldown():
    rig = _Rig()
    rig.tick()                         # primes the trailing rate sample
    rig.findings = [{"rule": "ring-starved",
                     "action": {"actuator": "ring-fill-target",
                                "direction": "down"}}]
    rig.tick()                         # tune fires: 8 -> 4, probation
    assert rig.ctl.actions == 1 and rig.box[0] == 4
    assert rig.ctl.report()["probation"]["actuator"] == "ring-fill-target"
    # the move made things worse: rate collapses 1000/s -> 10/s
    rig.tick(drecords=10)              # probation window not over yet
    assert rig.ctl.reverts == 0
    rig.tick(drecords=10)              # window over -> auto-revert
    assert rig.ctl.reverts == 1
    assert rig.box[0] == 8             # knob restored
    kinds = [e["kind"] for e in rig.ctl.report()["ledger"]]
    assert kinds == ["tune", "revert"]
    ev = rig.ctl.report()["ledger"][-1]["evidence"]
    assert ev["rate_after"] < ev["rate_before"]
    # (actuator, direction) sits out the cooldown: findings still ask
    # for it, but no new move fires...
    for _ in range(3):
        rig.tick()
    assert rig.ctl.actions == 1
    # ...until the cooldown expires
    rig.tick()
    assert rig.ctl.actions == 2 and rig.box[0] == 4


def test_probation_pass_keeps_move():
    rig = _Rig()
    rig.tick()
    rig.findings = [{"rule": "device-saturated",
                     "action": {"actuator": "ring-fill-target",
                                "direction": "up"}}]
    rig.tick()                         # tune 8 -> 16
    assert rig.box[0] == 16
    rig.findings = []
    rig.tick()
    rig.tick()                         # rate held -> probation passes
    assert rig.ctl.reverts == 0 and rig.box[0] == 16
    assert [e["kind"] for e in rig.ctl.report()["ledger"]] == \
        ["tune", "probation-pass"]


def test_ledger_persists_and_merges_across_restart(tmp_path):
    """Decisions survive the restart that applied them — the jsonl
    ledger rides the checkpoint dir, a fresh controller reloads the
    tail, and report() serves ONE totally-ordered merged history with
    per-run stamps."""
    import json

    rig = _Rig(persist_dir=str(tmp_path))
    rig.tick()
    rig.findings = [{"rule": "device-saturated",
                     "action": {"actuator": "ring-fill-target",
                                "direction": "up"}}]
    rig.tick()                         # tune 8 -> 16, persisted
    rig.findings = []
    rig.tick()
    rig.tick()                         # probation passes, persisted
    path = tmp_path / "controller-ledger.jsonl"
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [e["kind"] for e in lines] == ["tune", "probation-pass"]
    assert all(e["run"] == 1 for e in lines)

    # restart: a fresh controller over the same dir serves the MERGED
    # history and keeps appending with a bumped run / continued seq
    rig2 = _Rig(persist_dir=str(tmp_path))
    rep = rig2.ctl.report()
    assert rep["run"] == 2 and rep["restored_entries"] == 2
    assert [e["kind"] for e in rep["ledger"]] == \
        ["tune", "probation-pass"]
    rig2.tick()
    rig2.findings = [{"rule": "device-saturated",
                      "action": {"actuator": "ring-fill-target",
                                 "direction": "up"}}]
    rig2.tick()                        # run-2 tune
    merged = rig2.ctl.report()["ledger"]
    assert [(e["run"], e["kind"]) for e in merged] == \
        [(1, "tune"), (1, "probation-pass"), (2, "tune")]
    seqs = [e["seq"] for e in merged]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)

    # a torn tail line (crash mid-append) is skipped, never fatal
    with open(path, "a") as f:
        f.write('{"seq": 99, "k')
    rig3 = _Rig(persist_dir=str(tmp_path))
    assert rig3.ctl.report()["restored_entries"] == 3
    assert rig3.ctl.report()["run"] == 3


def test_regime_fallback_picks_ring_fill_target():
    rig = _Rig()
    rig.tick()
    orig = rig.sensor

    def starved_sensor():
        s = orig()
        s["starved"] = 0.9
        return s

    rig.ctl.sensor = starved_sensor
    rig.tick()
    assert rig.ctl.actions == 1
    assert rig.ctl.report()["ledger"][-1]["evidence"]["why"] == \
        "regime:ring-starved"
    assert rig.box[0] == 4             # down: drain earlier


def test_rebalance_applies_and_rate_limits():
    rig = _Rig()
    # all heat in groups 0 and 4, current split [0..5] | [6..7]:
    # shard 0 carries everything -> skew 2.0 over the threshold
    rig.heat = np.array([60.0, 0, 0, 0, 40.0, 0, 0, 0])
    rig.kg = ([0, 6], [5, 7])
    rig.tick()
    assert rig.ctl.rebalances == 1
    (starts, ends), = rig.rebalance_calls
    assert ends == [0, 7]              # greedy prefix: 60 | 40
    ev = rig.ctl.report()["ledger"][-1]["evidence"]
    assert ev["ends_before"] == [5, 7] and ev["ends_after"] == [0, 7]
    assert ev["predicted_gain"] == pytest.approx(100 / 60, abs=0.01)
    # the sensor still reports the old slicing (we never updated kg):
    # same skew, but the rate limiter blocks a re-fire...
    rig.tick()
    assert rig.ctl.rebalances == 1
    # ...until min_rebalance_interval passes on the fake clock
    rig.tick(dt=20.0)
    assert rig.ctl.rebalances == 2


def test_rebalance_skip_dedup_on_unchanged_slices():
    rig = _Rig()
    rig.heat = np.ones(8)
    rig.kg = ([0, 4], [3, 7])          # already balanced
    # doctor ASKS for a rebalance (skew below threshold): planner finds
    # nothing better -> one deduped skip entry, not one per cycle
    rig.findings = [{"rule": "kg-heat-skew",
                     "action": {"actuator": "rebalance-key-groups"}}]
    rig.tick()
    rig.tick()
    rig.tick()
    assert rig.ctl.rebalances == 0
    assert rig.ctl.rebalance_skips == 1
    skips = [e for e in rig.ctl.report()["ledger"]
             if e["kind"] == "rebalance-skip"]
    assert len(skips) == 1


def test_rebalance_failure_ledgered_and_propagates():
    rig = _Rig()
    rig.heat = np.array([60.0, 0, 0, 0, 40.0, 0, 0, 0])
    rig.kg = ([0, 6], [5, 7])
    rig.rebalance_exc = RuntimeError("device fell over mid-cut")
    rig.t[0] += 1.0
    rig.records[0] += 1000
    with pytest.raises(RuntimeError, match="mid-cut"):
        rig.ctl.service()
    assert rig.ctl.rebalances == 0
    assert rig.ctl.rebalance_failures == 1
    assert rig.ctl.report()["ledger"][-1]["kind"] == "rebalance-failed"


def test_interval_gating_and_ledger_bound():
    calls = [0]

    def sensor():
        calls[0] += 1
        return {"records": 0}

    ctl = RuntimeController({}, sensor, interval_cycles=4)
    for _ in range(8):
        ctl.service()
    assert calls[0] == 2               # every 4th cycle only
    for i in range(150):
        ctl._log("noise", i=i)
    assert len(ctl.report()["ledger"]) == 100
    rep = ctl.report()
    for key in ("available", "cycle", "actions", "reverts",
                "rebalances", "actuators", "cooldowns", "probation"):
        assert key in rep


# ------------------------------------------------ the window runner

CTL = {"controller.enabled": True, "controller.interval-cycles": 2,
       "controller.probation-cycles": 2, "controller.cooldown-cycles": 4}
RESIDENT = {"pipeline.resident-loop": "on", "pipeline.ring-depth": 4}
MODES = {
    "split": ({}, set()),
    "megastep": ({"pipeline.steps-per-dispatch": 4,
                  "pipeline.resident-loop": "off"}, {"dispatch-group"}),
    "megastep_auto": ({"pipeline.steps-per-dispatch": 4},
                      {"dispatch-group"}),
    "drain": (RESIDENT, {"ring-fill-target"}),
    "drain_stats": ({**RESIDENT, "observability.drain-stats": True},
                    {"ring-fill-target", "drain-stats-cadence"}),
    "tiered": ({**RESIDENT, "state.tiers.resident-key-groups": 4},
               {"ring-fill-target", "tier-prefetch-ahead"}),
}


def _job(env):
    """The window job behind ``env`` (its report methods are bound)."""
    return env._controller_report.__self__


@pytest.mark.parametrize("mode", sorted(MODES))
def test_actuators_registered_as_the_reference_registers_them(mode):
    cfg, want = MODES[mode]
    env = build_env(**CTL, **cfg)
    got, _ = run_job(env, 2048)
    assert got == expected(2048)
    rep = env._controller_report()
    assert rep["available"] and set(rep["actuators"]) == want
    env_j = build_env(pkg="jax", **CTL, **cfg)
    run_job(env_j, 2048, pkg="jax")
    assert set(env_j._controller_report()["actuators"]) == want
    if "dispatch-group" in want:
        assert rep["actuators"]["dispatch-group"] == {
            "value": 4, "lo": 1, "hi": 4, "step": "geometric"}


def gen_slow(offset, n):
    idx = np.arange(offset, offset + n)
    return ({"key": (idx * 48271) % 200, "value": np.ones(n, np.float32)},
            (idx // 2000) * 1000)


def test_forced_dispatch_group_move_keeps_rows_exact(tmp_path, monkeypatch):
    """A finding that asks ``dispatch-group`` down (the recompile-storm
    rule's action) mid-job: the controller halves the megastep group
    between flushes — later groups are smaller than K and run as single
    steps —, every row stays numpy's, and each decision lands in
    ``controller-ledger.jsonl`` in the checkpoint directory."""
    monkeypatch.setattr(
        controller_mod.RuntimeController, "_findings",
        lambda self: [{"rule": "recompile-storm",
                       "action": {"actuator": "dispatch-group",
                                  "direction": "down"}}])
    total = 16384
    env = build_env(tmp_path / "chk", interval=8,
                    **{**CTL, "controller.interval-cycles": 12},
                    **{"pipeline.steps-per-dispatch": 4,
                       "pipeline.resident-loop": "off",
                       "pipeline.fused-fire": "off"})
    got, job = run_job(env, total,
                       source=GeneratorSource(gen_slow, total=total))
    want = {}
    idx = np.arange(total)
    for k, t in zip(((idx * 48271) % 200).tolist(),
                    ((idx // 2000) * 1000).tolist()):
        key = (k, (t // 10_000 + 1) * 10_000)
        want[key] = want.get(key, 0) + 1.0
    assert got == want
    m = job.metrics
    assert m.steps == total // 256 and m.fused_dispatches > 0
    assert m.fused_dispatches * 4 < m.steps      # later groups ran single
    rep = env._controller_report()
    tunes = [e for e in rep["ledger"] if e["kind"] == "tune"]
    assert tunes and tunes[0]["actuator"] == "dispatch-group"
    assert (tunes[0]["before"], tunes[0]["after"]) == (4, 2)
    path = tmp_path / "chk" / "controller-ledger.jsonl"
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [e["seq"] for e in lines] == [e["seq"] for e in rep["ledger"]]


SKEW = {**RESIDENT, **CTL, "observability.drain-stats": True,
        "observability.kg-stats": True, "observability.kg-heat-alpha": 0.5,
        "controller.rebalance-threshold": 1.5,
        "controller.min-rebalance-interval": 0.0,
        "controller.min-gain": 1.01}


def test_one_shard_job_never_rebalances():
    """90 % of the traffic on two key groups, the recorder's heat fed and
    the rebalance gates wide open: one shard owns every group, so the
    shard skew is 1 and the arm never fires (nor asks to). Called
    directly, the executor's rebalancer refuses, citing item 10."""
    from flink_tpu_torch.core.keygroups import assign_to_key_group

    cand = np.arange(2048, dtype=np.int64)
    kg = assign_to_key_group(cand.astype(np.uint32), 128, np)
    hot = np.concatenate([cand[kg == g][:2] for g in (3, 70)])
    rng = np.random.default_rng(7)
    total = 8192
    pool = cand[rng.integers(0, 200, total)]
    m = rng.random(total) < 0.9
    pool[m] = hot[rng.integers(0, len(hot), m.sum())]

    def gen(offset, n):
        idx = np.arange(offset, offset + n)
        return ({"key": pool[offset:offset + n],
                 "value": np.ones(n, np.float32)}, (idx // 50) * 1000)

    env = build_env(**SKEW)
    run_job(env, total, source=GeneratorSource(gen, total=total))
    rep = env._controller_report()
    assert rep["cycle"] > 2 * SKEW["controller.interval-cycles"]
    assert rep["rebalances"] == rep["rebalance_skips"] == 0
    assert rep["rebalance_failures"] == 0
    job = _job(env)
    heat = job.controller_sensor()["heat"]
    assert heat is not None and heat.max() > 4 * heat.mean()
    assert job.controller_sensor()["kg_ends"] == [127]
    with pytest.raises(NotImplementedError, match="item 10"):
        job.controller.rebalancer([0, 64], [63, 127])
