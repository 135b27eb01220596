"""Pipeline doctor: a ranked-findings diagnostics engine — a copy of
flink_tpu/metrics/doctor.py (stdlib only) with its CLI's name changed.

The runtime's telemetry planes (drain duty-cycle, ring-starved EWMAs,
occupancy series, latency percentiles, chained-stage rows, the
key-group heat series) each answer a narrow question; this module joins
them: a pure host-side rule engine over one consolidated snapshot dict,
producing ranked findings where every finding carries its evidence
values AND a concrete config remedy (the key to turn plus a
suggestion), so the diagnosis is actionable, never just descriptive.

The snapshot is plain JSON-shaped data the executor already serves:

  * ``pipeline``   — DrainTelemetry.report() (shards, stages, kg_heat)
  * ``metrics``    — JobMetrics counter fields (watchdog trips,
                     aborted/declined checkpoints, drops, restarts)
  * ``checkpoints``— the bounded checkpoint_stats history
  * ``compile``    — per-stage compile counts (the reference's
                     CompileEvents; the port's eager steps compile
                     nothing per shape and serve no such plane)
  * ``recovery``   — the reference's RecoveryTracker.report() (not
                     ported yet)
  * ``fire_latency_ms`` — JobMetrics fire-latency percentiles

Every rule degrades gracefully on a missing plane (no finding, never a
crash), so the doctor runs against partial snapshots — a job without
checkpointing simply cannot burn a checkpoint budget.

Served two ways (the same engine): ``python -m flink_tpu_torch.doctor``
(exit codes 0 clean / 1 findings / 2 error) and in-process via
``env._doctor_report()``.

Pure host arithmetic over already-fetched data: no device sync may
creep in.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

DOCTOR_SCHEMA_VERSION = 1

# severity order for ranking (lower = more severe = first)
_SEVERITY_RANK = {"critical": 0, "warning": 1, "info": 2}

# tunable trigger levels; the executor overrides these from the
# observability.doctor.* config keys
DEFAULT_THRESHOLDS: Dict[str, float] = {
    # ring-starved EWMA fraction above which the publish side is the
    # bottleneck (the drain keeps finding an empty ring)
    "starved": 0.5,
    # duty-cycle EWMA above which every drain retires a full ring
    "saturated": 0.9,
    # peak edge demand / exchange-lanes budget ratio that warns BEFORE
    # the edge drops
    "edge_utilization": 0.8,
    # kg-heat max/mean ratio that marks a shard re-slice candidate
    "kg_skew": 4.0,
    # steady-bucket XLA compiles beyond which something recompiles
    # per batch (steady state dispatches pre-compiled steps only)
    "recompile": 8,
    # tier swaps (demotes + promotes) per drain above which residency
    # churns faster than the working set justifies
    "tier_churn": 0.5,
    # prefetch-miss fraction above which the prefetcher promotes
    # groups that never get touched before re-demotion
    "tier_miss": 0.5,
}


def _finding(rule: str, severity: str, score: float, summary: str,
             evidence: Dict[str, Any], remedy_key: str,
             remedy_suggestion: str,
             action: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    out = {
        "rule": rule,
        "severity": severity,
        "score": round(float(score), 4),
        "summary": summary,
        "evidence": evidence,
        "remedy": {"key": remedy_key, "suggestion": remedy_suggestion},
    }
    if action is not None:
        # machine-actionable arm of the remedy: names a registered
        # RuntimeController actuator (runtime/controller.py
        # ACTUATOR_NAMES — the contract lint in tests/test_doctor.py
        # pins the two lists together) so the self-tuning loop can
        # apply the same advice the human-facing remedy describes
        out["action"] = action
    return out


# ---------------------------------------------------------------- rules

def _rule_ring_starved(snap, th):
    pipe = snap.get("pipeline") or {}
    shards = pipe.get("shards") or []
    starved = [(s.get("shard", i), float(s.get("ring_starved", 0.0)))
               for i, s in enumerate(shards)]
    hot = [(s, v) for s, v in starved if v >= th["starved"]]
    if not hot:
        return None
    worst = max(v for _, v in hot)
    return _finding(
        "ring-starved", "warning", worst,
        f"{len(hot)}/{max(1, len(starved))} shard ring(s) are starved "
        f"(worst EWMA {worst:.2f} >= {th['starved']}): the drain keeps "
        f"finding an empty ring, so the device idles between "
        f"dispatches while ingest catches up",
        {
            "threshold": th["starved"],
            "shards": [
                {"shard": s, "ring_starved": round(v, 4)}
                for s, v in hot
            ],
        },
        "pipeline.prefetch-depth",
        "raise pipeline.prefetch-depth (and check the source poll "
        "rate) so the publish side keeps the ring fed between drains",
        action={"actuator": "ring-fill-target", "direction": "down"},
    )


def _rule_device_saturated(snap, th):
    pipe = snap.get("pipeline") or {}
    shards = pipe.get("shards") or []
    duties = [(s.get("shard", i), float(s.get("duty_cycle", 0.0)))
              for i, s in enumerate(shards)]
    hot = [(s, v) for s, v in duties if v >= th["saturated"]]
    if not hot:
        return None
    worst = max(v for _, v in hot)
    return _finding(
        "device-saturated", "warning", worst,
        f"{len(hot)}/{max(1, len(duties))} shard(s) run at full drain "
        f"duty (worst EWMA {worst:.2f} >= {th['saturated']}): every "
        f"drain retires a full ring, so the device is the bottleneck "
        f"and publishes queue behind it",
        {
            "threshold": th["saturated"],
            "shards": [
                {"shard": s, "duty_cycle": round(v, 4)} for s, v in hot
            ],
        },
        "pipeline.ring-depth",
        "raise pipeline.ring-depth (more slots retire per dispatch) "
        "and/or pipeline.steps-per-dispatch to amortize the fixed "
        "dispatch cost over more work",
        action={"actuator": "ring-fill-target", "direction": "up"},
    )


def _rule_edge_lane_overflow(snap, th):
    pipe = snap.get("pipeline") or {}
    stages = pipe.get("stages") or []
    worst = None
    for row in stages:
        util = row.get("edge_utilization")
        dropped = int((row.get("totals") or {}).get("dropped_capacity", 0))
        if dropped > 0:
            cand = ("critical", 1.0 + dropped, row, util, dropped)
        elif util is not None and float(util) >= th["edge_utilization"]:
            cand = ("warning", float(util), row, util, dropped)
        else:
            continue
        if worst is None or cand[1] > worst[1]:
            worst = cand
    if worst is None:
        return None
    severity, score, row, util, dropped = worst
    stage = row.get("stage")
    budget = row.get("edge_lane_budget")
    demand = row.get("edge_peak_demand")
    if dropped > 0:
        summary = (
            f"stage {stage}'s inter-stage edge OVERFLOWED: {dropped} "
            f"fire lane(s) dropped against the "
            f"{budget}-lane exchange budget (peak demand {demand})"
        )
    else:
        summary = (
            f"stage {stage}'s inter-stage edge is near overflow: peak "
            f"demand {demand} of {budget} lanes "
            f"({float(util):.0%} >= {th['edge_utilization']:.0%})"
        )
    return _finding(
        "edge-lane-overflow", severity, score, summary,
        {
            "threshold": th["edge_utilization"],
            "stage": stage,
            "edge_lane_budget": budget,
            "edge_peak_demand": demand,
            "edge_utilization": util,
            "dropped_capacity": dropped,
        },
        "pipeline.stages.exchange-lanes",
        "raise pipeline.stages.exchange-lanes above the peak per-drain "
        "fire demand (distinct keys x panes closing per drain)",
    )


def _rule_kg_heat_skew(snap, th):
    pipe = snap.get("pipeline") or {}
    kg = pipe.get("kg_heat") or {}
    if not kg.get("available"):
        return None
    skew = float(kg.get("skew_ratio") or 0.0)
    if skew < th["kg_skew"]:
        return None
    top = (kg.get("top") or [])[:3]
    cold = kg.get("cold_tail") or {}
    return _finding(
        "kg-heat-skew", "warning", skew,
        f"key-group heat is skewed {skew:.1f}x over the mean "
        f"(>= {th['kg_skew']}x): a few hot groups dominate one "
        f"shard's drain while the cold tail "
        f"({cold.get('fraction', 0):.0%} of groups) stays idle — a "
        f"shard re-slice candidate",
        {
            "threshold": th["kg_skew"],
            "skew_ratio": skew,
            "hot_groups": top,
            "cold_tail": cold,
        },
        "pipeline.data-parallel",
        "re-slice the shard key-group ranges around the hot groups "
        "(the savepoint-cut rescale path), or raise parallelism so "
        "the hot groups spread over more shards",
        action={"actuator": "rebalance-key-groups"},
    )


def _rule_recompile_storm(snap, th):
    comp = snap.get("compile") or {}
    steady = ((comp.get("by_stage") or {}).get("steady") or {})
    count = int(steady.get("count", 0))
    if count <= th["recompile"]:
        return None
    # a storm recompiles roughly once per dispatch; a fixed handful of
    # one-time shapes (end-of-stream flush, stragglers) does not scale
    # with volume, so when the metrics plane is present require the
    # steady count to track dispatches before crying wolf
    m = snap.get("metrics") or {}
    dispatches = (int(m.get("steps", 0))
                  + int(m.get("fused_dispatches", 0))
                  + int(m.get("resident_drains", 0)))
    if dispatches > 0 and count < 0.5 * dispatches:
        return None
    return _finding(
        "recompile-storm", "critical", float(count),
        f"{count} XLA compiles landed in the steady bucket "
        f"(> {int(th['recompile'])}): steady state should dispatch "
        f"only pre-compiled steps, so something recompiles per batch "
        f"(usually a shape leak)",
        {
            "threshold": int(th["recompile"]),
            "steady_compiles": count,
            "steady_compile_time_ms": steady.get("time_ms"),
            "total_compiles": comp.get("compiles"),
            "dispatches": dispatches,
        },
        "pipeline.steps-per-dispatch",
        "find the shape leak (env._compile_report() names the stages); "
        "pin batch shapes or lower pipeline.steps-per-dispatch so one "
        "signature serves every dispatch",
        action={"actuator": "dispatch-group", "direction": "down"},
    )


def _rule_checkpoint_budget_burn(snap, th):
    m = snap.get("metrics") or {}
    aborted = int(m.get("checkpoints_aborted", 0))
    declined = int(m.get("checkpoints_declined", 0))
    if aborted <= 0:
        return None
    rows = [r for r in (snap.get("checkpoints") or [])
            if r.get("status") == "aborted"]
    return _finding(
        "checkpoint-budget-burn", "warning", float(aborted),
        f"{aborted} checkpoint(s) aborted-and-counted against the "
        f"failure budget ({declined} trigger(s) declined): the budget "
        f"is burning down toward escalation",
        {
            "checkpoints_aborted": aborted,
            "checkpoints_declined": declined,
            "recent_aborts": [
                {"id": r.get("id"),
                 "failure_reason": r.get("failure_reason")}
                for r in rows[-3:]
            ],
        },
        "checkpoint.tolerable-failures",
        "fix the abort cause (recent_aborts names it) or raise "
        "checkpoint.tolerable-failures / the checkpoint interval so "
        "transient faults stop burning the budget",
    )


def _rule_ring_refusals(snap, th):
    pipe = snap.get("pipeline") or {}
    shards = pipe.get("shards") or []
    rows = [(s.get("shard", i), int(s.get("publish_refusals", 0)))
            for i, s in enumerate(shards)]
    hot = [(s, v) for s, v in rows if v > 0]
    if not hot:
        return None
    total = sum(v for _, v in hot)
    return _finding(
        "ring-refusals", "info", float(total),
        f"{total} staged batch(es) were refused by a full ring lane "
        f"across {len(hot)} shard(s) — publishes fell back to fresh "
        f"buffers, costing an extra H2D copy each",
        {
            "total_refusals": total,
            "shards": [
                {"shard": s, "publish_refusals": v} for s, v in hot
            ],
        },
        "pipeline.ring-depth",
        "raise pipeline.ring-depth so the ring absorbs the publish "
        "burst, or lower pipeline.prefetch-depth to slow the producer",
    )


def _rule_watchdog_trips(snap, th):
    m = snap.get("metrics") or {}
    trips = int(m.get("watchdog_trips", 0))
    if trips <= 0:
        return None
    return _finding(
        "watchdog-trips", "warning", float(trips),
        f"{trips} watchdog deadline trip(s): a step-loop phase "
        f"exceeded its deadline (the trip names the phase) — a hang "
        f"was converted into an attributed failure",
        {"watchdog_trips": trips,
         "restarts": int(m.get("restarts", 0))},
        "watchdog.drain-timeout",
        "if the tripped phase is legitimately slow (cold compile, "
        "giant restore), raise its watchdog.*-timeout; otherwise "
        "treat the trip as the failure it contained",
    )


def _rule_tier_thrash(snap, th):
    pipe = snap.get("pipeline") or {}
    tiers = pipe.get("tiers")
    if not tiers:
        return None
    swaps = int(tiers.get("demotes", 0)) + int(tiers.get("promotes", 0))
    hits = int(tiers.get("prefetch_hits", 0))
    misses = int(tiers.get("prefetch_misses", 0))
    m = snap.get("metrics") or {}
    drains = (int(m.get("resident_drains", 0))
              + int(m.get("steps", 0))
              + int(m.get("fused_dispatches", 0)))
    churn = swaps / drains if drains > 0 else 0.0
    miss_frac = misses / (hits + misses) if (hits + misses) > 0 else 0.0
    churny = drains > 0 and churn >= th["tier_churn"]
    missy = (hits + misses) >= 4 and miss_frac >= th["tier_miss"]
    if not (churny or missy):
        return None
    if churny:
        summary = (
            f"tiered state is thrashing: {swaps} residency swap(s) over "
            f"{drains} dispatch(es) ({churn:.2f}/dispatch >= "
            f"{th['tier_churn']}) — demote/promote splices burn host-"
            f"device copies faster than the working set justifies"
        )
        score = churn
        action = None
    else:
        summary = (
            f"tier prefetch is mispredicting: {misses}/{hits + misses} "
            f"promoted group(s) were never touched before re-demotion "
            f"({miss_frac:.0%} >= {th['tier_miss']:.0%})"
        )
        score = miss_frac
        # only the miss arm is machine-actionable: backing off the
        # prefetch horizon is safe; the churn arm's remedy (grow the
        # resident budget) changes memory shape, which stays a human
        # decision
        action = {"actuator": "tier-prefetch-ahead", "direction": "down"}
    return _finding(
        "tier-thrash", "warning", score, summary,
        {
            "churn_threshold": th["tier_churn"],
            "miss_threshold": th["tier_miss"],
            "demotes": int(tiers.get("demotes", 0)),
            "promotes": int(tiers.get("promotes", 0)),
            "dispatches": drains,
            "prefetch_hits": hits,
            "prefetch_misses": misses,
            "tier_faults": int(tiers.get("faults", 0)),
            "budget_per_shard": tiers.get("budget_per_shard"),
            "resident_groups": tiers.get("resident_groups"),
            "cold_groups_pending": tiers.get("cold_groups_pending"),
        },
        "state.tiers.resident-key-groups",
        "raise state.tiers.resident-key-groups so the hot set fits, or "
        "raise state.tiers.min-dwell-cycles to damp the churn; if the "
        "misses dominate, lower state.tiers.prefetch-ahead-panes so "
        "promotion waits for firmer watermark evidence",
        action=action,
    )


_RULES: List[Callable] = [
    _rule_ring_starved,
    _rule_device_saturated,
    _rule_edge_lane_overflow,
    _rule_kg_heat_skew,
    _rule_recompile_storm,
    _rule_checkpoint_budget_burn,
    _rule_ring_refusals,
    _rule_watchdog_trips,
    _rule_tier_thrash,
]

RULE_NAMES = tuple(
    r.__name__.replace("_rule_", "").replace("_", "-") for r in _RULES
)


def run_rules(snapshot: Dict[str, Any],
              thresholds: Optional[Dict[str, float]] = None
              ) -> List[Dict[str, Any]]:
    """Evaluate every rule over ``snapshot``; returns findings ranked
    most-severe first (severity class, then score descending)."""
    th = dict(DEFAULT_THRESHOLDS)
    if thresholds:
        th.update({k: v for k, v in thresholds.items() if v is not None})
    findings = []
    for rule in _RULES:
        f = rule(snapshot, th)
        if f is not None:
            findings.append(f)
    findings.sort(
        key=lambda f: (_SEVERITY_RANK.get(f["severity"], 9), -f["score"])
    )
    return findings


def diagnose(snapshot: Dict[str, Any],
             thresholds: Optional[Dict[str, float]] = None
             ) -> Dict[str, Any]:
    """The full doctor payload: the stable ``--json`` / web schema."""
    findings = run_rules(snapshot, thresholds)
    return {
        "available": True,
        "version": DOCTOR_SCHEMA_VERSION,
        "clean": not findings,
        "findings": findings,
        "rules": list(RULE_NAMES),
    }
