"""The port's pipeline doctor (flink_tpu_torch/metrics/doctor.py, its CLI
flink_tpu_torch/doctor.py and ``env._doctor_report()``) against the
reference's on the CPU, mirroring tests/test_doctor.py:

* ``diagnose`` on the same snapshots — one that fires each of the nine
  rules, one that ranks four findings, threshold overrides, and the empty
  snapshot — gives the reference's payload;
* the CLI's exit codes: 0 clean, 1 findings (with the stable ``--json``
  payload, and a served payload replayed through its embedded snapshot),
  2 an unreadable, malformed or missing snapshot;
* ``env._doctor_report()`` on port jobs: the planes the port has
  (``pipeline``, ``metrics``, ``checkpoints``, ``fire_latency_ms``), no
  ``compile`` or ``recovery`` plane, the same findings as the reference's
  ``diagnose`` on its snapshot, and the ``observability.doctor: false``
  stub;
* the contract checks: every remedy key is a declared option of the
  port's config, and every machine ``action`` names one of the port
  controller's actuators.
"""

import ast
import inspect
import json
import subprocess
import sys

import pytest

from test_torch_ingest import build_env, expected, run_job

from flink_tpu.metrics import doctor as doctor_ref
from flink_tpu_torch import doctor as cli
from flink_tpu_torch.metrics import doctor as doctor_port


def _shard(i, **kw):
    row = {"shard": i, "duty_cycle": 0.2, "ring_starved": 0.0,
           "totals": {}, "levels": {}}
    row.update(kw)
    return row


SNAPSHOTS = {
    "empty": ({}, None),
    "partial_planes": ({"pipeline": {}, "metrics": {}, "compile": {},
                        "checkpoints": []}, None),
    "ring_starved": ({"pipeline": {"shards": [
        _shard(0, ring_starved=0.85), _shard(1, ring_starved=0.1)]}}, None),
    "device_saturated": ({"pipeline": {"shards": [
        _shard(0, duty_cycle=0.97), _shard(1, duty_cycle=0.95)]}}, None),
    "edge_near_overflow": ({"pipeline": {"stages": [{
        "stage": 1, "edge_lane_budget": 1024, "edge_peak_demand": 900,
        "edge_utilization": 0.8789, "totals": {"dropped_capacity": 0},
        "levels": {}}]}}, None),
    "edge_overflowed": ({"pipeline": {"stages": [{
        "stage": 2, "edge_lane_budget": 64, "edge_peak_demand": 91,
        "edge_utilization": 1.4219, "totals": {"dropped_capacity": 27},
        "levels": {}}]}}, None),
    "kg_heat_skew": ({"pipeline": {"kg_heat": {
        "available": True, "skew_ratio": 9.3,
        "top": [{"group": 7, "heat": 93.0, "last_touched_ago": 0}],
        "cold_tail": {"count": 90, "fraction": 0.7}}}}, None),
    "recompile_storm": ({"compile": {"compiles": 40, "by_stage": {
        "steady": {"count": 31, "time_ms": 9000.0}}}}, None),
    "checkpoint_budget_burn": ({
        "metrics": {"checkpoints_aborted": 2, "checkpoints_declined": 1},
        "checkpoints": [{"id": 3, "status": "completed"},
                        {"id": 4, "status": "aborted",
                         "failure_reason": "injected fault: publish"}]},
        None),
    "ring_refusals": ({"pipeline": {"shards": [
        _shard(0, publish_refusals=5), _shard(1, publish_refusals=0)]}},
        None),
    "watchdog_trips": ({"metrics": {"watchdog_trips": 1, "restarts": 1}},
                       None),
    "tier_churn": ({"pipeline": {"tiers": {
        "demotes": 30, "promotes": 30, "faults": 2, "prefetch_hits": 9,
        "prefetch_misses": 1, "budget_per_shard": 2, "resident_groups": 4,
        "cold_groups_pending": 3}}, "metrics": {"resident_drains": 40}},
        None),
    "tier_miss": ({"pipeline": {"tiers": {
        "demotes": 1, "promotes": 1, "prefetch_hits": 1,
        "prefetch_misses": 5}}, "metrics": {"steps": 400}}, None),
    "ranked": ({"pipeline": {"shards": [_shard(0, ring_starved=0.9,
                                               publish_refusals=3)]},
                "compile": {"by_stage": {"steady": {"count": 50}}},
                "metrics": {"watchdog_trips": 7}}, None),
    "threshold_override": ({"pipeline": {"shards": [
        _shard(0, duty_cycle=0.5)]}}, {"saturated": 0.4, "kg_skew": None}),
}


@pytest.mark.parametrize("case", sorted(SNAPSHOTS))
def test_diagnose_matches_reference(case):
    """The copied rule engine gives the reference's payload — findings,
    their ranking, evidence, remedies and actions — on each snapshot."""
    snap, th = SNAPSHOTS[case]
    got = doctor_port.diagnose(snap, th)
    assert got == doctor_ref.diagnose(snap, th)
    if case in ("empty", "partial_planes"):
        assert got["clean"] and got["findings"] == []
    else:
        assert got["findings"]
    assert got["rules"] == list(doctor_port.RULE_NAMES)
    assert len(doctor_port.RULE_NAMES) == 9


# ------------------------------------------------------------ the CLI

def _write(tmp_path, name, obj):
    p = tmp_path / name
    p.write_text(obj if isinstance(obj, str) else json.dumps(obj))
    return str(p)


def test_cli_exit_codes(tmp_path, capsys):
    """0 clean, 1 findings (the ``--json`` payload the engine's, the text
    naming each remedy), 2 for a missing file, malformed JSON, no
    snapshot, or both a snapshot and ``--url``."""
    clean = _write(tmp_path, "clean.json", {})
    assert cli.main([clean]) == cli.EXIT_CLEAN
    assert "clean" in capsys.readouterr().out
    snap = {"metrics": {"watchdog_trips": 3},
            "compile": {"by_stage": {"steady": {"count": 20}}}}
    sick = _write(tmp_path, "sick.json", snap)
    assert cli.main([sick, "--json"]) == cli.EXIT_FINDINGS
    payload = json.loads(capsys.readouterr().out)
    assert payload == doctor_ref.diagnose(snap)
    assert [f["rule"] for f in payload["findings"]] == [
        "recompile-storm", "watchdog-trips"]
    assert cli.main([sick]) == cli.EXIT_FINDINGS
    assert "pipeline.steps-per-dispatch" in capsys.readouterr().out
    bad = _write(tmp_path, "bad.json", "{not json")
    for argv in ([str(tmp_path / "missing.json")], [bad], [],
                 [clean, "--url", "http://localhost:1/"]):
        assert cli.main(argv) == cli.EXIT_ERROR, argv
    capsys.readouterr()


def test_cli_replays_a_served_payload(tmp_path, capsys):
    """A saved ``env._doctor_report()`` payload re-diagnoses to the same
    findings through its embedded snapshot and thresholds — also when run
    as ``python -m flink_tpu_torch.doctor``."""
    snap = {"metrics": {"watchdog_trips": 2}}
    served = doctor_port.diagnose(snap)
    served["snapshot"] = snap
    served["thresholds"] = dict(doctor_port.DEFAULT_THRESHOLDS)
    p = _write(tmp_path, "served.json", served)
    assert cli.main([p, "--json"]) == cli.EXIT_FINDINGS
    assert json.loads(capsys.readouterr().out)["findings"] == \
        served["findings"]
    r = subprocess.run([sys.executable, "-m", "flink_tpu_torch.doctor", p],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stderr
    assert "watchdog-trips" in r.stdout


# ------------------------------------------------- env._doctor_report()

DRAIN = {"pipeline.resident-loop": "on", "pipeline.ring-depth": 4,
         "observability.drain-stats": True,
         "observability.drain-stats-every": 1,
         "observability.kg-stats": True}


@pytest.mark.parametrize("cfg", [
    {}, DRAIN,
    {"pipeline.steps-per-dispatch": 4, "pipeline.resident-loop": "off"},
], ids=["split", "drain_stats", "megastep"])
def test_doctor_report_on_a_port_job(cfg):
    """The port's planes, and the reference's findings on them: a job's
    payload is the reference's ``diagnose`` of its embedded snapshot."""
    env = build_env(**cfg)
    got, job = run_job(env, 4096)
    assert got == expected(4096)
    rep = env._doctor_report()
    assert rep["available"] is True
    snap = rep["snapshot"]
    assert set(snap) == {"pipeline", "metrics", "checkpoints",
                         "fire_latency_ms"}
    assert snap["metrics"]["steps"] == job.metrics.steps == 16
    assert snap["metrics"]["records_in"] == 4096
    assert snap["metrics"]["fires"] == snap["metrics"]["records_out"] \
        == len(expected(4096))
    assert snap["fire_latency_ms"]["p99"] is not None
    assert snap["pipeline"]["available"] is bool(cfg.get(
        "observability.drain-stats"))
    assert set(rep["thresholds"]) == set(doctor_port.DEFAULT_THRESHOLDS)
    want = doctor_ref.diagnose(json.loads(json.dumps(snap)),
                               rep["thresholds"])
    assert {k: rep[k] for k in want} == want
    if "pipeline.steps-per-dispatch" in cfg:
        assert snap["metrics"]["fused_dispatches"] > 0


def test_doctor_and_controller_off_stubs():
    env = build_env(**{"observability.doctor": False})
    run_job(env, 1024)
    assert env._doctor_report() == {"available": False,
                                    "reason": "observability.doctor off"}
    assert env._controller_report() == {"available": False,
                                        "reason": "controller.enabled off"}


# ------------------------------------------------ controller contract

def _finding_call_sites():
    tree = ast.parse(inspect.getsource(doctor_port))
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "id", "") == "_finding"]


def test_doctor_remedy_keys_are_declared_config_options():
    """Every remedy a finding names is a key the port's Configuration
    declares (checked on the source, so rules no snapshot fires count)."""
    from flink_tpu_torch.core.config import ConfigOption, CoreOptions
    declared = {v.key for v in vars(CoreOptions).values()
                if isinstance(v, ConfigOption)}
    keys = []
    for call in _finding_call_sites():
        rk = call.args[5]
        assert isinstance(rk, ast.Constant) and isinstance(rk.value, str)
        keys.append(rk.value)
    assert len(keys) == 9 and set(keys) <= declared, \
        sorted(set(keys) - declared)


def test_doctor_actions_name_port_actuators():
    """Every literal ``{"actuator": ...}`` of the doctor names one of the
    port controller's ``ACTUATOR_NAMES``, with an up or down direction."""
    from flink_tpu_torch.runtime.controller import ACTUATOR_NAMES
    tree = ast.parse(inspect.getsource(doctor_port))
    actions = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Dict):
            continue
        lit = {k.value: v for k, v in zip(node.keys, node.values)
               if isinstance(k, ast.Constant)}
        if "actuator" in lit:
            d = lit.get("direction")
            actions.append((lit["actuator"].value,
                            None if d is None else d.value))
    assert actions
    assert {a for a, _ in actions} <= set(ACTUATOR_NAMES)
    assert {d for _, d in actions} <= {None, "up", "down"}
