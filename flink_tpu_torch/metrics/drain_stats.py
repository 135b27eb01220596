"""Drain-interior flight recorder, host side — a copy of
flink_tpu/metrics/drain_stats.py (numpy only) with its import path
changed.

A resident ring drain retires up to ``ring-depth`` staged batches in one
dispatch, so a timer around the dispatch sees D slots of work as one
opaque interval. The device half (``runtime/step.py``'s per-slot
``DRAIN_STAT_FIELDS`` rows, written by G18 ``slot_stats`` when
``observability.drain-stats`` is on) records each live slot's counters
inside the drain; this module is the host half that turns the payload,
read with the drain's fires, plus the ring's publish-time stamps into:

  * per-shard ring occupancy / backpressure time series (fill sampled
    at publish and at drain, joined with the publish-refusal counters);
  * a drain duty-cycle estimator — device-busy vs ring-starved EWMA per
    shard;
  * event-time-to-fire and publish-seq-to-consume latency flowing into
    ``LatencySamples`` weighted percentiles;
  * counter tracks for a span tracer (``tracer.rec_counter``), when one
    is given.

The stage-aware half (``STAGE_STAT_FIELDS``, ``absorb_stage_payload``)
serves chained stages: the chained drain's per-stage rows, written by
G22 ``stage_record``.

Threading: the executor's step loop calls the ``ingest_publish`` /
``on_drain`` / ``note_fires`` mutators; readers call ``report()`` and the
gauge accessors. One lock guards the tiny mutable core (deque appends and
EWMA floats).

Everything here is pure host arithmetic over payloads the executor has
already read back: nothing in this module touches the device.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.metrics.latency import LatencySamples

# Per-slot counter layout written by the drain (G18 slot_stats) — the
# single source of truth; runtime/step.py and ops/cuda.py import it so
# the packer and this unpacker cannot drift.
DRAIN_STAT_FIELDS = (
    "events",          # records retired from the slot (valid lanes)
    "activity",        # table placements (insert) / probe misses (fast)
    "fire_lanes",      # fire lanes packed for the slot's pane crossings
    "fired_keys",      # sum of per-lane fired key counts
    "late_dropped",    # lanes dropped late (allowed-lateness breach)
    "nofit_dropped",   # lanes dropped for capacity (no fit after probe)
    "ovf_fill",        # overflow-ring fill after the slot retired
    "kg_fill_max",     # max per-key-group fill (skew summary)
    "panes_advanced",  # panes the slot's watermark advance crossed
)

# monotonically accumulating fields vs instantaneous levels: totals are
# summed for the former, the latest fetch's max-over-slots is reported
# for the latter (summing a fill level across slots is meaningless)
COUNTER_FIELDS = ("events", "activity", "fire_lanes", "fired_keys",
                  "late_dropped", "nofit_dropped", "panes_advanced")
LEVEL_FIELDS = ("ovf_fill", "kg_fill_max")

# Per-downstream-stage record emitted ONCE per drain by the chained
# stage tail — one row per stage j >= 1, stacked to
# ``[n_stages-1, n_shards, len(STAGE_STAT_FIELDS)]`` next to the
# stage-0 per-slot payload. Single source of truth: runtime/step.py
# packs by this order, this module unpacks by it.
STAGE_STAT_FIELDS = (
    "edge_demand",       # upstream fire lanes offered to the edge
                         # (pre-clamp: demand > exchange-lanes budget
                         # means the edge dropped)
    "edge_events",       # lanes actually inserted (min(demand, E))
    "fire_lanes",        # downstream fire lanes packed this drain
    "dropped_capacity",  # edge lanes dropped for lane-budget overflow
    "wm_lag_panes",      # coupled-watermark lag behind upstream, in
                         # downstream pane widths (level)
    "panes_advanced",    # downstream panes this drain's advance crossed
)
STAGE_COUNTER_FIELDS = ("edge_demand", "edge_events", "fire_lanes",
                        "dropped_capacity", "panes_advanced")
STAGE_LEVEL_FIELDS = ("wm_lag_panes",)


class DrainTelemetry:
    """Aggregates the drain flight-recorder payload into per-shard
    series, duty-cycle EWMAs, and latency percentiles."""

    def __init__(self, n_shards: int, ring_depth: int,
                 alpha: float = 0.1, max_series: int = 512,
                 tracer=None, n_stages: int = 1,
                 exchange_lanes: int = 0, key_groups: int = 0,
                 kg_alpha: float = 0.05):
        self.n_shards = max(1, int(n_shards))
        self.ring_depth = max(1, int(ring_depth))
        self.alpha = float(alpha)
        self.tracer = tracer
        self.t0 = time.perf_counter()
        n = self.n_shards
        nf = len(DRAIN_STAT_FIELDS)
        self._totals = np.zeros((n, nf), np.int64)
        self._last = np.zeros((n, nf), np.int64)
        # stage-aware half (chained drains): per-downstream-stage
        # counter totals / latest levels / per-drain peaks, summed
        # (resp. maxed) over shards at absorb time
        self.n_stages = max(1, int(n_stages))
        self.exchange_lanes = max(0, int(exchange_lanes))
        nsf = len(STAGE_STAT_FIELDS)
        self._stage_totals = np.zeros((self.n_stages - 1, nsf), np.int64)
        self._stage_last = np.zeros((self.n_stages - 1, nsf), np.int64)
        self._stage_peak = np.zeros((self.n_stages - 1, nsf), np.int64)
        # key-group heat: EWMA of sampled per-batch fill plus a
        # last-touched recency counter, per key group
        self.key_groups = max(0, int(key_groups))
        self.kg_alpha = float(kg_alpha)
        self._kg_heat = np.zeros(self.key_groups, np.float64)
        self._kg_last = np.full(self.key_groups, -1, np.int64)
        self._kg_seq = 0
        self._duty = [0.0] * n          # device-busy EWMA (count/depth)
        self._starved = [0.0] * n       # empty-ring drain EWMA
        self._fill = [0] * n            # last observed ring fill
        self._drains = 0                # drain dispatches seen
        self._fetches = 0               # payload fetches unpacked
        # per-shard occupancy series: (t_rel_s, fill, source)
        self._occ: List[deque] = [
            deque(maxlen=max(16, int(max_series))) for _ in range(n)
        ]
        # per-shard outstanding publishes awaiting release: (seq, t)
        self._pending: List[deque] = [
            deque(maxlen=4096) for _ in range(n)
        ]
        # event-tick -> publish-wall lookup for fire latency; ticks and
        # times both ascend so bisect over a parallel pair of lists
        self._tick: List[int] = []
        self._tick_t: List[float] = []
        self._fire_lat = LatencySamples()
        self._consume_lat = LatencySamples()
        self._lock = threading.Lock()

    # -- mutators (step loop) --------------------------------------------

    def ingest_publish(self, samples: Sequence[Tuple]):
        """Absorb publish-time stamps drained from a batch ring:
        ``(shard, seq_or_None, fill_after, max_tick_or_None, t_wall)``
        tuples appended inside the ring's locked commit section."""
        with self._lock:
            for shard, seq, fill, max_tick, t in samples:
                s = int(shard)
                if not 0 <= s < self.n_shards:
                    continue
                self._fill[s] = int(fill)
                self._occ[s].append((t - self.t0, int(fill), "publish"))
                if seq is not None:
                    self._pending[s].append((int(seq), t))
                if max_tick is not None and (
                        not self._tick or int(max_tick) > self._tick[-1]):
                    self._tick.append(int(max_tick))
                    self._tick_t.append(t)
                    if len(self._tick) > 8192:
                        del self._tick[:4096]
                        del self._tick_t[:4096]

    def on_drain(self, counts: Sequence[int],
                 fills: Sequence[int],
                 released: Sequence[Optional[int]],
                 t_wall: Optional[float] = None):
        """One drain dispatch retired: ``counts[s]`` slots drained from
        shard ``s``'s ring, ``fills[s]`` the lane fill after release,
        ``released[s]`` the released-through seq (None: nothing ringed).
        Updates the duty/starved EWMAs, occupancy series and publish-to-
        consume latency — called every drain regardless of the payload
        fetch cadence (``absorb_payload`` handles the sampled half)."""
        if t_wall is None:
            t_wall = time.perf_counter()
        a = self.alpha
        with self._lock:
            self._drains += 1
            tracks = []
            for s in range(self.n_shards):
                cnt = int(counts[s]) if s < len(counts) else 0
                fill = int(fills[s]) if s < len(fills) else 0
                duty = min(1.0, cnt / self.ring_depth)
                # a shallow drain that leaves the lane EMPTY means the
                # publish side cannot keep the ring fed (ring-starved);
                # full-depth drains are the device-saturated signature
                starved = (
                    1.0 if (fill == 0 and cnt < self.ring_depth) else 0.0
                )
                self._duty[s] += a * (duty - self._duty[s])
                self._starved[s] += a * (starved - self._starved[s])
                self._fill[s] = fill
                self._occ[s].append((t_wall - self.t0, fill, "drain"))
                rel = released[s] if s < len(released) else None
                if rel is not None:
                    q = self._pending[s]
                    while q and q[0][0] <= int(rel):
                        _seq, t_pub = q.popleft()
                        self._consume_lat.record(
                            1, (t_wall - t_pub) * 1e3
                        )
                tracks.append((f"drain/shard{s}", {
                    "fill": fill,
                    "duty_pct": round(self._duty[s] * 100.0, 1),
                }))
            tr = self.tracer
        if tr is not None and tr.active:
            for track, values in tracks:
                tr.rec_counter(track, t_wall, **values)

    def absorb_payload(self, ds: np.ndarray,
                       t_wall: Optional[float] = None):
        """Fold one fetched ``[n_shards, D, len(FIELDS)]`` flight-
        recorder payload (already host-resident — the lagged consume
        path fetched it batched with the fire payload) into the totals
        and level views, and emit per-shard counter-track samples."""
        if t_wall is None:
            t_wall = time.perf_counter()
        per_shard = ds.sum(axis=1, dtype=np.int64)
        last = ds.max(axis=1).astype(np.int64)
        if per_shard.shape[0] != self.n_shards:
            # global-ring resident mode on a multi-shard mesh: the
            # payload still carries one row per mesh shard, but the
            # ring (and so this aggregator) has a single lane — fold
            per_shard = per_shard.sum(axis=0, keepdims=True)
            last = last.max(axis=0, keepdims=True)
        with self._lock:
            self._fetches += 1
            self._totals += per_shard
            self._last = last
            tr = self.tracer
        if tr is not None and tr.active:
            for s in range(per_shard.shape[0]):
                tr.rec_counter(
                    f"drain_retired/shard{s}", t_wall,
                    events=int(per_shard[s][0]),
                    fire_lanes=int(per_shard[s][2]),
                )

    def absorb_stage_payload(self, ss: np.ndarray,
                             t_wall: Optional[float] = None):
        """Fold one fetched ``[n_stages-1, n_shards, len(STAGE_STAT_
        FIELDS)]`` per-downstream-stage record (the chained tail emits
        ONE row per stage per drain) into stage totals, latest levels
        and per-drain peaks, and emit per-stage counter tracks."""
        if t_wall is None:
            t_wall = time.perf_counter()
        ss = ss.astype(np.int64, copy=False)
        if ss.ndim == 2:            # single-shard payload without axis
            ss = ss[:, None, :]
        n_down = min(ss.shape[0], self.n_stages - 1)
        if n_down <= 0:
            return
        per_stage = ss[:n_down].sum(axis=1)          # counters: + shards
        lvl = ss[:n_down].max(axis=1)                # levels: max shard
        with self._lock:
            self._stage_totals[:n_down] += per_stage
            self._stage_last[:n_down] = lvl
            self._stage_peak[:n_down] = np.maximum(
                self._stage_peak[:n_down], lvl
            )
            tr = self.tracer
        if tr is not None and tr.active:
            fi = {f: i for i, f in enumerate(STAGE_STAT_FIELDS)}
            for j in range(n_down):
                tr.rec_counter(
                    f"drain_stage{j + 1}", t_wall,
                    edge_lanes=int(lvl[j][fi["edge_events"]]),
                    fire_lanes=int(lvl[j][fi["fire_lanes"]]),
                    wm_lag_panes=int(lvl[j][fi["wm_lag_panes"]]),
                )

    def absorb_kg_fill(self, counts: np.ndarray, n_batches: int = 1):
        """Fold one sampled per-key-group fill vector (the lagged
        monitoring fetch the executor already performs) into the heat
        EWMA + last-touched recency — the demote/prefetch and
        live-rebalance sensor. Pure host numpy on an already-fetched
        array."""
        counts = counts.astype(np.float64, copy=False).ravel()
        if counts.size == 0:
            return
        obs = counts / max(1, int(n_batches))
        a = self.kg_alpha
        with self._lock:
            if counts.size != self.key_groups:
                self.key_groups = counts.size
                heat = np.zeros(counts.size, np.float64)
                last = np.full(counts.size, -1, np.int64)
                n = min(self._kg_heat.size, counts.size)
                heat[:n] = self._kg_heat[:n]
                last[:n] = self._kg_last[:n]
                self._kg_heat, self._kg_last = heat, last
            self._kg_seq += 1
            self._kg_heat += a * (obs - self._kg_heat)
            self._kg_last[counts > 0] = self._kg_seq

    def note_fires(self, pairs: Sequence[Tuple[int, int]],
                   t_wall: Optional[float] = None):
        """Record event-time-to-fire latency for an emission:
        ``(window_end_tick, n_windows)`` pairs. The latency of a window
        is measured from the first publish whose max event tick crossed
        its end (the moment the fire became due on the device) to now —
        pure wall time, no tick-to-ms conversion needed."""
        if t_wall is None:
            t_wall = time.perf_counter()
        with self._lock:
            for wend, n in pairs:
                i = bisect_left(self._tick, int(wend))
                if i < len(self._tick_t) and n > 0:
                    self._fire_lat.record(
                        int(n), (t_wall - self._tick_t[i]) * 1e3
                    )

    # -- readers (web / reporter threads) --------------------------------

    def duty_cycle(self, s: int) -> float:
        with self._lock:
            return self._duty[s] if 0 <= s < self.n_shards else 0.0

    def slot_fill(self, s: int) -> int:
        with self._lock:
            return self._fill[s] if 0 <= s < self.n_shards else 0

    def fire_latency_ms(self, q: float) -> Optional[float]:
        with self._lock:
            return self._fire_lat.percentile(q)

    def consume_latency_ms(self, q: float) -> Optional[float]:
        with self._lock:
            return self._consume_lat.percentile(q)

    def stage_stat(self, stage: int, field: str) -> int:
        """Latest-level (LEVEL fields) or running-total (COUNTER
        fields) value for downstream stage ``stage`` (1-based)."""
        j = int(stage) - 1
        if not 0 <= j < self.n_stages - 1 or field not in STAGE_STAT_FIELDS:
            return 0
        i = STAGE_STAT_FIELDS.index(field)
        with self._lock:
            src = (self._stage_last if field in STAGE_LEVEL_FIELDS
                   else self._stage_totals)
            return int(src[j][i])

    def kg_heat_block(self, k: int = 8) -> Dict[str, Any]:
        """Top-k/cold-tail view of the key-group heat series."""
        with self._lock:
            heat = self._kg_heat.copy()
            last = self._kg_last.copy()
            seq = self._kg_seq
            alpha = self.kg_alpha
        if heat.size == 0 or seq == 0:
            return {"available": False, "samples": seq,
                    "hint": "needs observability.kg-stats and traffic"}
        order = np.argsort(heat)[::-1][:max(1, int(k))]
        touched = last >= 0
        mean_heat = float(heat[touched].mean()) if touched.any() else 0.0
        max_heat = float(heat.max())
        # cold tail: groups never touched, or whose heat decayed below
        # 10% of the mean over touched groups — the demote candidates
        cold = (~touched) | (heat < 0.1 * mean_heat)
        return {
            "available": True,
            "alpha": alpha,
            "samples": seq,
            "groups": int(heat.size),
            "skew_ratio": round(max_heat / mean_heat, 4)
            if mean_heat > 0 else 0.0,
            "top": [
                {
                    "group": int(g),
                    "heat": round(float(heat[g]), 4),
                    "last_touched_ago": (
                        int(seq - last[g]) if last[g] >= 0 else None
                    ),
                }
                for g in order if heat[g] > 0
            ],
            "cold_tail": {
                "count": int(cold.sum()),
                "fraction": round(float(cold.mean()), 4),
            },
        }

    def kg_heat_max(self) -> float:
        with self._lock:
            return float(self._kg_heat.max()) if self._kg_heat.size else 0.0

    def kg_heat_skew(self) -> float:
        with self._lock:
            heat = self._kg_heat
            touched = self._kg_last >= 0
            if not touched.any():
                return 0.0
            mean = float(heat[touched].mean())
            return float(heat.max()) / mean if mean > 0 else 0.0

    def regime(self) -> Tuple[float, float]:
        """(mean duty-cycle, mean ring-starved fraction) across shards —
        the resident-loop signal ``CycleAttribution`` classifies on."""
        with self._lock:
            n = self.n_shards
            return (sum(self._duty) / n, sum(self._starved) / n)

    def report(self, refusals: Optional[Sequence[int]] = None,
               occupancy_points: int = 64) -> Dict[str, Any]:
        """The /jobs/<jid>/pipeline payload body."""
        with self._lock:
            shards = []
            for s in range(self.n_shards):
                occ = list(self._occ[s])[-occupancy_points:]
                row: Dict[str, Any] = {
                    "shard": s,
                    "duty_cycle": round(self._duty[s], 4),
                    "ring_starved": round(self._starved[s], 4),
                    "slot_fill": self._fill[s],
                    "occupancy": [
                        [round(t, 4), fill, src] for t, fill, src in occ
                    ],
                    "totals": {
                        f: int(self._totals[s][i])
                        for i, f in enumerate(DRAIN_STAT_FIELDS)
                        if f in COUNTER_FIELDS
                    },
                    "levels": {
                        f: int(self._last[s][i])
                        for i, f in enumerate(DRAIN_STAT_FIELDS)
                        if f in LEVEL_FIELDS
                    },
                }
                if refusals is not None and s < len(refusals):
                    row["publish_refusals"] = int(refusals[s])
                shards.append(row)

            def pct(lat: LatencySamples) -> Dict[str, Any]:
                out: Dict[str, Any] = {"samples": len(lat)}
                for q in (50.0, 95.0, 99.0):
                    v = lat.percentile(q)
                    out[f"p{int(q)}"] = (
                        round(v, 3) if v is not None else None
                    )
                return out

            out: Dict[str, Any] = {
                "available": True,
                "n_shards": self.n_shards,
                "ring_depth": self.ring_depth,
                "drains": self._drains,
                "payload_fetches": self._fetches,
                "fields": list(DRAIN_STAT_FIELDS),
                "shards": shards,
                "latency_ms": {
                    "event_to_fire": pct(self._fire_lat),
                    "publish_to_consume": pct(self._consume_lat),
                },
            }
            if self.n_stages > 1:
                fi = {f: i for i, f in enumerate(STAGE_STAT_FIELDS)}
                budget = self.exchange_lanes
                stages = []
                for j in range(self.n_stages - 1):
                    peak_demand = int(
                        self._stage_peak[j][fi["edge_demand"]]
                    )
                    stages.append({
                        "stage": j + 1,
                        "totals": {
                            f: int(self._stage_totals[j][fi[f]])
                            for f in STAGE_COUNTER_FIELDS
                        },
                        "levels": {
                            f: int(self._stage_last[j][fi[f]])
                            for f in STAGE_LEVEL_FIELDS
                        },
                        "edge_lane_budget": budget,
                        "edge_peak_demand": peak_demand,
                        "edge_utilization": (
                            round(peak_demand / budget, 4)
                            if budget > 0 else None
                        ),
                    })
                out["stages"] = stages
                out["stage_fields"] = list(STAGE_STAT_FIELDS)
        if self.key_groups > 0:
            out["kg_heat"] = self.kg_heat_block()
        return out
