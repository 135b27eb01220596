"""Self-tuning runtime: the closed loop over the telemetry planes — a
copy of flink_tpu/runtime/controller.py (numpy and stdlib only).

The flight recorder gives the runtime its eyes (duty-cycle,
ring-starved, occupancy, fire latency) and the pipeline doctor
(``metrics/doctor.py``) turns them into ranked findings with config
remedies; this module is the part that *acts*. A
:class:`RuntimeController` is serviced at the poll-cycle boundary and
applies remedies LIVE through two actuator classes:

* **config auto-tuning** — a bounded hill-climb over the declared hot
  knobs (drain fill target, megastep grouping, drain-stats cadence,
  tier prefetch horizon), keyed on the doctor's ranked findings with
  the raw device-saturated vs ring-starved regime as the fallback.
  Every move is ledgered with before/after evidence and put on
  probation: if the tracked metric (events/s) worsens past
  ``controller.revert-threshold`` within ``controller.probation-cycles``
  the move auto-reverts and that (knob, direction) sits out
  ``controller.cooldown-cycles``.
* **live hot-key-group rebalancing** — when the per-shard heat skew
  crosses ``controller.rebalance-threshold`` (or the doctor's
  kg-heat-skew finding asks for it), a heat-balanced contiguous
  re-slicing of the shard ranges (greedy prefix partition over the
  per-group EWMA heat series) is applied through the executor's
  rebalancer. Rate-limited by ``controller.min-rebalance-interval`` and
  gated off when the predicted imbalance gain is under
  ``controller.min-gain``. The arm needs two shards or more; the port
  runs one, so it never fires (its rescale is ROADMAP queue 1, item 10).

Everything here is host-side arithmetic over already-fetched telemetry:
the actuators are attribute writes — data the kernels already consume —
so a knob move adds no dispatch, and with ``controller.enabled: off``
(the default) nothing here is constructed at all.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# Every actuator name the controller may ever register. The doctor's
# machine-actionable `action` descriptors must name one of these — the
# doctor->controller contract test (tests/test_torch_doctor.py) pins it,
# so remedies can't drift from what the controller can apply.
ACTUATOR_NAMES = (
    "ring-fill-target",     # effective drain fill target (fused.k)
    "dispatch-group",       # megastep grouping (steps-per-dispatch)
    "drain-stats-cadence",  # observability.drain-stats-every holder
    "tier-prefetch-ahead",  # state.tiers.prefetch-ahead-panes
    "rebalance-key-groups",  # the live heat-balanced re-slice
)


@dataclass
class Actuator:
    """One live-settable knob: ``get``/``set`` are host closures over
    executor state (an attribute or one-element-list holder write — no
    recompile, no dispatch), bounded to [lo, hi]. ``step`` picks the
    hill-climb stride: geometric (halve/double — fill targets and
    cadences span orders of magnitude) or additive (+-1 — small
    horizons like prefetch-ahead-panes)."""

    name: str
    get: Callable[[], int]
    set: Callable[[int], None]
    lo: int
    hi: int
    step: str = "geometric"

    def move(self, direction: str) -> Tuple[int, int]:
        """(current, clamped next) for one step in ``direction``."""
        cur = int(self.get())
        if self.step == "additive":
            nxt = cur + 1 if direction == "up" else cur - 1
        else:
            nxt = cur * 2 if direction == "up" else cur // 2
        return cur, max(self.lo, min(self.hi, int(nxt)))


# ---------------------------------------------------------- partitioning


def plan_balanced_slices(heat, n_shards: int):
    """Greedy prefix partition of the per-group heat series into
    ``n_shards`` contiguous, non-empty slices covering every group.

    Returns ``(starts, ends)`` as int lists with INCLUSIVE ends,
    strictly increasing — the same contract ``MeshContext.kg_bounds``
    serves (ingest routing searchsorteds over the ends). Zero-heat
    tails get a uniform epsilon so idle groups still spread instead of
    all landing on the last shard."""
    w = np.maximum(np.multiply(heat, 1.0), 0.0)
    maxp = int(w.shape[0])
    if n_shards < 1 or maxp < n_shards:
        raise ValueError(
            f"cannot slice {maxp} key-groups into {n_shards} shards")
    total = float(w.sum())
    # epsilon floor: groups the heat plane has never seen still need an
    # owner, and a fully-cold plane should fall back to uniform slices
    eps = max(total, 1.0) / (1000.0 * maxp)
    w = w + eps
    total = float(w.sum())
    cum = np.cumsum(w)
    starts: List[int] = []
    ends: List[int] = []
    lo = 0
    for s in range(n_shards):
        if s == n_shards - 1:
            hi = maxp - 1
        else:
            target = total * (s + 1) / n_shards
            hi = int(np.searchsorted(cum, target, side="left"))
            # closest prefix boundary, not first-crossing: when the
            # previous boundary sits a hair under the target,
            # overshooting by a whole group is strictly worse for the
            # max-shard-heat objective (and float ties on uniform heat
            # would otherwise break rightward into uneven slices)
            if hi >= maxp:
                hi = maxp - 1
            elif hi > lo and (abs(float(cum[hi - 1]) - target)
                              <= abs(float(cum[hi]) - target)):
                hi -= 1
            # each remaining shard keeps at least one group
            hi = max(lo, min(hi, maxp - 1 - (n_shards - 1 - s)))
        starts.append(lo)
        ends.append(hi)
        lo = hi + 1
    return starts, ends


def shard_heats(heat, starts, ends) -> List[float]:
    """Per-shard heat totals under contiguous inclusive ranges."""
    w = np.maximum(np.multiply(heat, 1.0), 0.0)
    return [
        float(w[int(starts[s]):int(ends[s]) + 1].sum())
        for s in range(len(starts))
    ]


def predicted_gain(heat, cur_starts, cur_ends, new_starts,
                   new_ends) -> float:
    """Hottest-shard heat now / hottest-shard heat after the re-slice —
    the imbalance improvement a rebalance is predicted to buy (1.0 =
    no improvement)."""
    cur = shard_heats(heat, cur_starts, cur_ends)
    new = shard_heats(heat, new_starts, new_ends)
    hot_new = max(new) if new else 0.0
    if hot_new <= 0.0:
        return 1.0
    return (max(cur) if cur else 0.0) / hot_new


# ------------------------------------------------------------ controller


class RuntimeController:
    """Closed-loop policy for one windowed job.

    The executor services it once per poll cycle (``service``); every
    ``interval_cycles``-th cycle it makes at most ONE decision — a knob
    move (with probation) or a rebalance (rate-limited, gain-gated).
    Web threads read :meth:`report` (served at
    ``/jobs/<jid>/controller``), so the ledger and counters sit behind
    a lock like the elasticity controller's.

    ``sensor`` returns the raw planes as one host dict:
    ``records`` (cumulative events in), ``duty``/``starved`` (the
    regime EWMAs, or None), ``heat`` (the per-group EWMA series, or
    None), ``kg_starts``/``kg_ends`` (the current inclusive shard
    ranges). ``findings_fn`` returns the doctor's ranked findings
    (machine-actionable ``action`` descriptors are consumed here).
    ``rebalancer(starts, ends)`` applies the savepoint-cut re-slice
    LIVE and raises on failure — the failure is ledgered before it
    propagates (the executor re-latches the pre-rebalance plan)."""

    def __init__(self, actuators: Dict[str, Actuator],
                 sensor: Callable[[], dict],
                 findings_fn: Optional[Callable[[], list]] = None,
                 rebalancer: Optional[Callable] = None, *,
                 interval_cycles: int = 16,
                 revert_threshold: float = 0.05,
                 probation_cycles: int = 16,
                 cooldown_cycles: int = 64,
                 rebalance_threshold: float = 4.0,
                 min_rebalance_interval: float = 30.0,
                 min_gain: float = 1.2,
                 persist_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        unknown = [n for n in actuators if n not in ACTUATOR_NAMES]
        if unknown:
            raise ValueError(
                f"unregistered controller actuator(s): {unknown} "
                f"(known: {list(ACTUATOR_NAMES)})")
        self.actuators = dict(actuators)
        self.sensor = sensor
        self.findings_fn = findings_fn
        self.rebalancer = rebalancer
        self.interval_cycles = max(1, int(interval_cycles))
        self.revert_threshold = float(revert_threshold)
        self.probation_cycles = max(1, int(probation_cycles))
        self.cooldown_cycles = max(0, int(cooldown_cycles))
        self.rebalance_threshold = float(rebalance_threshold)
        self.min_rebalance_interval = float(min_rebalance_interval)
        self.min_gain = float(min_gain)
        self.clock = clock
        self._lock = threading.Lock()
        self._cycle = 0
        self._seq = 0
        # trailing decision-point sample: (records, t) — the "before"
        # rate of the next move is measured against it
        self._last_records: Optional[int] = None
        self._last_t: Optional[float] = None
        self._probation: Optional[dict] = None
        self._cooldowns: Dict[Tuple[str, str], int] = {}
        self._last_rebalance_t: Optional[float] = None
        self._last_skip_sig: Optional[tuple] = None
        self._ledger: List[dict] = []
        # counters surfaced as Prometheus gauges
        self.actions = 0
        self.reverts = 0
        self.rebalances = 0
        self.rebalance_skips = 0
        self.rebalance_failures = 0
        # durable decision ledger: every entry is
        # also appended to <persist_dir>/controller-ledger.jsonl, and a
        # restarted job reloads prior runs' tail so /jobs/<jid>/
        # controller serves the MERGED history — "why is the knob at
        # this value" survives the restart that applied it
        self._run = 1
        self._history: List[dict] = []
        self._ledger_path = None
        self.persist_errors = 0
        if persist_dir:
            self._ledger_path = os.path.join(
                persist_dir, "controller-ledger.jsonl")
            self._load_history()

    # -- ledger ----------------------------------------------------------

    def _load_history(self):
        try:
            with open(self._ledger_path) as f:
                lines = f.readlines()
        except OSError:
            return
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except ValueError:
                continue   # torn tail line from a crash mid-append
            if isinstance(e, dict):
                self._history.append(e)
        del self._history[:-400]
        if self._history:
            # continue the sequence across restarts: merged entries stay
            # totally ordered, and the run counter marks each restart
            self._seq = max(int(e.get("seq", 0)) for e in self._history)
            self._run = 1 + max(
                int(e.get("run", 1)) for e in self._history)

    @staticmethod
    def _jsonable(o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        return str(o)

    def _log(self, kind: str, **fields) -> dict:
        self._seq += 1
        entry = {"seq": self._seq, "run": self._run,
                 "cycle": self._cycle,
                 "t_wall": round(time.time(), 3), "kind": kind}
        entry.update(fields)
        with self._lock:
            self._ledger.append(entry)
            del self._ledger[:-100]
        if self._ledger_path:
            try:
                with open(self._ledger_path, "a") as f:
                    f.write(json.dumps(entry, default=self._jsonable)
                            + "\n")
            except OSError:
                # observability must not kill the job; the counter (a
                # Prometheus gauge via report()) keeps the loss visible
                self.persist_errors += 1
        return entry

    # -- the loop --------------------------------------------------------

    def service(self):
        """One poll cycle. Cheap no-op except every
        ``interval_cycles``-th call."""
        self._cycle += 1
        if self._cycle % self.interval_cycles:
            return
        s = self.sensor() or {}
        now = self.clock()
        records = s.get("records")
        records = None if records is None else int(records)

        if self._probation is not None:
            self._maybe_close_probation(records, now)
            # no new move while a probe is open: its metric window must
            # not be polluted by a second actuation
            if self._probation is not None:
                return
        did = self._maybe_rebalance(s, now)
        if not did:
            self._maybe_tune(s, records, now)
        self._last_records, self._last_t = records, now

    # -- probation -------------------------------------------------------

    def _rate(self, rec0, t0, rec1, t1) -> Optional[float]:
        if rec0 is None or rec1 is None or t1 is None or t0 is None:
            return None
        dt = t1 - t0
        if dt <= 0 or rec1 < rec0:
            return None
        return (rec1 - rec0) / dt

    def _maybe_close_probation(self, records, now):
        prob = self._probation
        if self._cycle - prob["cycle"] < self.probation_cycles:
            return
        act = self.actuators.get(prob["actuator"])
        rate_after = self._rate(prob["records"], prob["t"], records, now)
        before = prob.get("rate_before")
        worsened = (
            rate_after is not None and before is not None and before > 0
            and rate_after < before * (1.0 - self.revert_threshold)
        )
        if worsened and act is not None:
            act.set(prob["before"])
            self.reverts += 1
            self._cooldowns[(prob["actuator"], prob["direction"])] = \
                self._cycle
            self._log(
                "revert", actuator=prob["actuator"],
                direction=prob["direction"], value=prob["before"],
                reverted_value=prob["after"], evidence={
                    "rate_before": before, "rate_after": rate_after,
                    "revert_threshold": self.revert_threshold,
                    "probed_move_seq": prob["seq"],
                })
        else:
            self._log(
                "probation-pass", actuator=prob["actuator"],
                direction=prob["direction"], value=prob["after"],
                evidence={"rate_before": before,
                          "rate_after": rate_after,
                          "probed_move_seq": prob["seq"]})
        self._probation = None

    def _cooled_down(self, name: str, direction: str) -> bool:
        at = self._cooldowns.get((name, direction))
        return (at is not None
                and self._cycle - at < self.cooldown_cycles)

    # -- rebalance arm ---------------------------------------------------

    def _maybe_rebalance(self, s: dict, now: float) -> bool:
        heat = s.get("heat")
        cur_starts, cur_ends = s.get("kg_starts"), s.get("kg_ends")
        if (self.rebalancer is None or heat is None
                or cur_ends is None or len(cur_ends) < 2):
            return False
        cur_sh = shard_heats(heat, cur_starts, cur_ends)
        mean = sum(cur_sh) / len(cur_sh)
        skew = (max(cur_sh) / mean) if mean > 0 else 0.0
        asked = any(
            (f.get("action") or {}).get("actuator")
            == "rebalance-key-groups"
            for f in self._findings()
        )
        if not asked and skew < self.rebalance_threshold:
            return False
        if (self._last_rebalance_t is not None
                and now - self._last_rebalance_t
                < self.min_rebalance_interval):
            return False
        starts, ends = plan_balanced_slices(heat, len(cur_ends))
        same = (len(ends) == len(cur_ends) and all(
            int(ends[i]) == int(cur_ends[i]) for i in range(len(ends))))
        gain = predicted_gain(heat, cur_starts, cur_ends, starts, ends)
        if same or gain < self.min_gain:
            sig = ("skip", tuple(ends), round(gain, 3))
            if sig != self._last_skip_sig:
                self._last_skip_sig = sig
                self.rebalance_skips += 1
                self._log("rebalance-skip", evidence={
                    "shard_skew": round(skew, 3),
                    "predicted_gain": round(gain, 3),
                    "min_gain": self.min_gain,
                    "unchanged_slices": same,
                })
            return False
        self._last_skip_sig = None
        self._last_rebalance_t = now
        entry_ev = {
            "shard_skew": round(skew, 3),
            "predicted_gain": round(gain, 3),
            "shard_heats_before": [round(h, 3) for h in cur_sh],
            "shard_heats_after": [
                round(h, 3) for h in shard_heats(heat, starts, ends)],
            "ends_before": [int(e) for e in cur_ends],
            "ends_after": [int(e) for e in ends],
        }
        try:
            self.rebalancer(starts, ends)
        except BaseException:
            # ledger the failure BEFORE it propagates: the executor
            # re-latches the pre-rebalance plan and takes recovery
            self.rebalance_failures += 1
            self._log("rebalance-failed", evidence=entry_ev)
            raise
        self.rebalances += 1
        self._log("rebalance", evidence=entry_ev)
        return True

    # -- tuning arm ------------------------------------------------------

    def _findings(self) -> list:
        if self.findings_fn is None:
            return []
        try:
            return list(self.findings_fn() or [])
        except Exception:
            return []

    def _pick_move(self, s: dict):
        """(actuator-name, direction, why) of the top-ranked applicable
        action — doctor findings first, raw regime as the fallback."""
        for f in self._findings():
            a = f.get("action") or {}
            name, direction = a.get("actuator"), a.get("direction")
            if (name in self.actuators and direction in ("up", "down")
                    and not self._cooled_down(name, direction)):
                return name, direction, f.get("rule", "finding")
        starved, duty = s.get("starved"), s.get("duty")
        if (starved is not None and starved > 0.5
                and "ring-fill-target" in self.actuators
                and not self._cooled_down("ring-fill-target", "down")):
            return "ring-fill-target", "down", "regime:ring-starved"
        if (duty is not None and duty > 0.9
                and "ring-fill-target" in self.actuators
                and not self._cooled_down("ring-fill-target", "up")):
            return "ring-fill-target", "up", "regime:device-saturated"
        return None

    def _maybe_tune(self, s: dict, records, now):
        pick = self._pick_move(s)
        if pick is None:
            return
        name, direction, why = pick
        act = self.actuators[name]
        cur, nxt = act.move(direction)
        if nxt == cur:
            return                      # already at the bound
        rate_before = self._rate(
            self._last_records, self._last_t, records, now)
        act.set(nxt)
        self.actions += 1
        entry = self._log(
            "tune", actuator=name, direction=direction, before=cur,
            after=nxt, evidence={
                "why": why, "rate_before": rate_before,
                "duty": s.get("duty"), "starved": s.get("starved"),
            })
        self._probation = {
            "seq": entry["seq"], "cycle": self._cycle,
            "actuator": name, "direction": direction, "before": cur,
            "after": nxt, "records": records, "t": now,
            "rate_before": rate_before,
        }

    # -- observability ---------------------------------------------------

    def report(self) -> dict:
        with self._lock:
            # merged history: prior runs' persisted tail + this run's
            # live entries, one totally-ordered list (seq continues
            # across restarts, each entry stamped with its run)
            ledger = self._history + list(self._ledger)
        knobs = {
            n: {"value": int(a.get()), "lo": a.lo, "hi": a.hi,
                "step": a.step}
            for n, a in self.actuators.items()
        }
        prob = self._probation
        return {
            "available": True,
            "cycle": self._cycle,
            "run": self._run,
            "restored_entries": len(self._history),
            "persist_errors": self.persist_errors,
            "interval_cycles": self.interval_cycles,
            "actions": self.actions,
            "reverts": self.reverts,
            "rebalances": self.rebalances,
            "rebalance_skips": self.rebalance_skips,
            "rebalance_failures": self.rebalance_failures,
            "probation": (
                None if prob is None else {
                    k: prob[k] for k in (
                        "actuator", "direction", "before", "after",
                        "cycle")
                }),
            "cooldowns": [
                {"actuator": n, "direction": d, "cycle": c}
                for (n, d), c in self._cooldowns.items()
            ],
            "actuators": knobs,
            "ledger": ledger,
        }
