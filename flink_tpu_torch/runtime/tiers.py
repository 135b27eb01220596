"""Tiered key-group state: HBM-resident hot set over a host cold tier —
a copy of flink_tpu/runtime/tiers.py (numpy only), its imports pointed
at the port's modules.

Every key of a job used to live in HBM, capping key cardinality per chip
at device memory — the opposite of a millions-of-users profile (huge
cold tail, small hot working set). This module is the host half of the
tier: a ``TierManager`` owns the per-shard residency mask
(``state.tiers.resident-key-groups`` budgets how many key-groups sit in
HBM per shard), ranks groups by the flight recorder's EWMA heat +
recency series plus the watermark-derived next-fire pane,
and plans demote/promote swaps the executor applies at the
exactly-once cut between drains.

The device half is one extra operand, not a new kernel: tiered step
families take a replicated ``kg_res`` bool[max_parallelism] mask and
divert lanes of non-resident groups down the existing overflow ring
(``ops/window_kernels.update``), so a batch routing into a cold group
falls down the route ladder for that batch only — never lossy, counted
in the ``tier_faults`` gauge. Residency is *data*, not structure: the
compiled families stay shape-stable as the mask changes.

Correctness is invariant to residency: a group's pending contributions
live either in device slot rows or in the host pane ``SpillStore``s,
and both halves feed the same logical (key, pane, value) entry format
at fire, checkpoint, and restore. Demote/promote merely move entries
between the halves (see ``partition_entries`` / ``fold_entries`` /
``ring_window``), which is why a crash between a demote and its
checkpoint replays cleanly — the restored cut re-seeds both tiers from
the same logical snapshot. ``docs/state-tiers.md`` carries the full
argument.

Everything here is plain host numpy on already-fetched telemetry — the
manager never touches device buffers and adds zero dispatches to the
hot path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from flink_tpu_torch.core.keygroups import assign_to_key_group
from flink_tpu_torch.ops.cuda import PANE_NONE
from flink_tpu_torch.ops.hashing import route_hash
from flink_tpu_torch.testing import faults

# score bonus that puts a group with an imminent window fire ahead of
# any heat ranking: the prefetcher MUST have it resident before the
# fire so the emission comes off the device instead of a host merge
_FIRE_BOOST = 1e18


@dataclass(frozen=True)
class TierPlan:
    """One maintenance decision: groups to demote and promote, applied
    together at the next exactly-once cut. ``prefetch`` marks the
    subset of ``promote`` chosen predictively (watermark next-fire or
    heat ranking) rather than reactively (observed faults)."""

    demote: List[int] = field(default_factory=list)
    promote: List[int] = field(default_factory=list)
    prefetch: Set[int] = field(default_factory=set)

    def __bool__(self):
        return bool(self.demote or self.promote)


class TierManager:
    """Host-side residency policy + cold-tier index for one window stage.

    The executor consults it at poll-cycle boundaries (the same seam
    the elastic re-plan latch uses): feed it sampled kg-fill telemetry
    (``note_sample``), the ring->store merge stream (``note_cold``),
    and the flight recorder's heat/recency series (``plan``); apply the
    returned :class:`TierPlan` via the executor's demote/promote splice
    and confirm with :meth:`apply`.
    """

    def __init__(self, max_parallelism: int, starts: Sequence[int],
                 ends: Sequence[int], budget: int,
                 prefetch_ahead_panes: int = 2,
                 min_dwell_cycles: int = 4,
                 max_swaps_per_cycle: int = 0):
        if budget <= 0:
            raise ValueError("tier budget must be positive "
                             "(0 disables tiering upstream)")
        self.maxp = int(max_parallelism)
        self.budget = int(budget)
        self.prefetch_ahead_panes = int(prefetch_ahead_panes)
        self.min_dwell_cycles = int(min_dwell_cycles)
        # cap on promote+demote moves one plan may return
        # (state.tiers.max-swaps-per-cycle; 0 = unlimited): swap work
        # runs at the poll-cycle seam on the step loop, so a working-set
        # shift bigger than the cap carries forward instead of stalling
        # one cycle behind a giant splice burst
        self.max_swaps_per_cycle = int(max_swaps_per_cycle)
        self.resident = np.zeros(self.maxp, bool)
        self._shard_of = np.zeros(self.maxp, np.int32)
        self._cycle = 0
        self._last_flip = np.full(self.maxp, -(10 ** 9), np.int64)
        # cold-tier index: per-group earliest pane with pending spill
        # entries (the watermark prefetch signal) + approximate entry
        # count (ranking/evidence only — the stores stay authoritative)
        self._pending_pane: Dict[int, int] = {}
        self._cold_count: Dict[int, int] = {}
        # groups promoted predictively, awaiting their first observed
        # traffic (resolves to a prefetch hit) or eviction (a miss)
        self._prefetched: Set[int] = set()
        # counters surfaced as Prometheus gauges / pipeline block
        self.tier_faults = 0
        self.demotes = 0
        self.promotes = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.rescale(starts, ends)

    # ------------------------------------------------------------ setup

    def rescale(self, starts: Sequence[int], ends: Sequence[int],
                budget: Optional[int] = None):
        """(Re-)slice residency for new shard ranges — initial setup,
        elastic re-plan, and the live savepoint-cut rescale all land
        here. The first ``budget`` groups of each shard's range start
        resident (cold groups earn their way in via heat); counters
        survive, the per-range dwell clocks reset."""
        if budget is not None:
            self.budget = int(budget)
        starts = np.asarray(starts, np.int64)
        ends = np.asarray(ends, np.int64)
        self.starts, self.ends = starts, ends
        self.resident[:] = False
        for s in range(len(starts)):
            lo = int(starts[s])
            hi = min(int(ends[s]), lo + self.budget - 1)
            self.resident[lo:hi + 1] = True
            self._shard_of[lo:int(ends[s]) + 1] = s
        self._last_flip[:] = -(10 ** 9)
        self._prefetched.clear()

    # ------------------------------------------------------------ index

    def mask(self) -> np.ndarray:
        """The residency mask the executor stages as the kernels'
        ``kg_res`` operand (a copy — the manager keeps mutating its
        own)."""
        return self.resident.copy()

    def resident_groups(self) -> int:
        return int(self.resident.sum())

    def shard_of(self, kg: int) -> int:
        """Owning shard of a key-group under the current ranges."""
        return int(self._shard_of[int(kg)])

    def note_cold(self, kgs: np.ndarray, panes: np.ndarray):
        """Ring->store merge stream: lanes of these key-groups just
        landed in the host pane stores. Maintains the earliest-pending-
        pane index the watermark prefetcher ranks on. Resident groups
        appear here too (plain capacity overflow) — they index as well,
        so a promote of a formerly-cold group also reclaims any
        overflow residue."""
        kgs = np.asarray(kgs)
        panes = np.asarray(panes)
        for g in np.unique(kgs):
            sel = kgs == g
            p = int(panes[sel].min())
            g = int(g)
            cur = self._pending_pane.get(g)
            self._pending_pane[g] = p if cur is None else min(cur, p)
            self._cold_count[g] = self._cold_count.get(g, 0) + int(
                sel.sum()
            )

    def forget_cold(self, kg: int):
        """A promote (or store prune) moved this group's pending
        entries out of the cold tier."""
        self._pending_pane.pop(int(kg), None)
        self._cold_count.pop(int(kg), None)

    def prune_cold(self, cutoff_pane: int):
        """Pane stores at or below ``cutoff_pane`` were pruned (every
        containing window fired) — drop index entries that pointed only
        there."""
        for g in [g for g, p in self._pending_pane.items()
                  if p <= cutoff_pane]:
            self.forget_cold(g)

    def note_sample(self, kg_sum: np.ndarray):
        """One sampled per-group fill vector (the lagged overflow-
        pressure fetch): batches observed routing into non-resident
        groups are tier faults; first observed traffic on a
        predictively-promoted group resolves its prefetch to a hit.
        Sampled, so the gauges are rates-of-samples, not exact counts —
        documented in docs/state-tiers.md."""
        kg_sum = np.asarray(kg_sum)
        n = min(kg_sum.size, self.maxp)
        hot = np.nonzero(kg_sum[:n] > 0)[0]
        if not len(hot):
            return
        faulted = hot[~self.resident[hot]]
        self.tier_faults += int(len(faulted))
        for g in hot:
            if int(g) in self._prefetched:
                self._prefetched.discard(int(g))
                self.prefetch_hits += 1

    # ------------------------------------------------------------- plan

    def plan(self, heat: np.ndarray, last_seen: np.ndarray, seq: int,
             wm_pane: Optional[int] = None) -> TierPlan:
        """Rank every group and swap toward the per-shard budget.

        ``heat``/``last_seen``/``seq`` are the flight recorder's EWMA
        kg-heat plane, last-traffic sequence numbers, and current
        sequence (DrainTelemetry). ``wm_pane`` is the current
        watermark pane: any cold group with pending spill entries in a
        pane at or below ``wm_pane + prefetch-ahead-panes`` is about to
        fire and outranks everything (the timely-prefetch condition —
        watermark progression makes the next touch predictable).
        Hysteresis: a group that flipped within ``min_dwell_cycles``
        stays put, except for an imminent-fire promote."""
        self._cycle += 1
        heat = np.asarray(heat, np.float64)
        last_seen = np.asarray(last_seen, np.int64)
        score = np.zeros(self.maxp, np.float64)
        n = min(heat.size, self.maxp)
        score[:n] = heat[:n]
        # recency: groups seen recently get a decaying bonus scaled to
        # the heat plane, so a just-touched cold group outranks an
        # equally-warm long-idle one
        if n:
            seen = last_seen[:n] >= 0
            age = np.maximum(0, seq - last_seen[:n])
            scale = max(1.0, float(heat[:n].max(initial=0.0)))
            score[:n][seen] += scale / (1.0 + age[seen])
        urgent: Set[int] = set()
        if wm_pane is not None:
            horizon = wm_pane + self.prefetch_ahead_panes
            for g, p in self._pending_pane.items():
                if p <= horizon and not self.resident[g]:
                    score[g] += _FIRE_BOOST
                    urgent.add(g)

        demote: List[int] = []
        promote: List[int] = []
        prefetch: Set[int] = set()
        dwell_ok = (
            self._cycle - self._last_flip >= self.min_dwell_cycles
        )
        # swap budget across BOTH move kinds and all shards; a plan the
        # cap truncates leaves the residue un-flipped (no _last_flip
        # stamp), so the next cycle's ranking re-derives and carries it
        # forward
        swaps_left = (
            self.max_swaps_per_cycle if self.max_swaps_per_cycle > 0
            else 2 * self.maxp + 1
        )
        for s in range(len(self.starts)):
            lo, hi = int(self.starts[s]), int(self.ends[s])
            if lo > hi:
                continue
            rng = np.arange(lo, hi + 1)
            res = self.resident[rng]
            sc = score[rng]
            # desired residents: the budget top-scored groups of the
            # range; ties broken toward the incumbents (stability)
            order = np.argsort(-(sc + 1e-9 * res), kind="stable")
            want = np.zeros(len(rng), bool)
            want[order[: self.budget]] = True
            demoted_here = 0
            for i in np.nonzero(res & ~want)[0]:
                if swaps_left <= 0:
                    break
                g = int(rng[i])
                if dwell_ok[g]:
                    demote.append(g)
                    demoted_here += 1
                    swaps_left -= 1
            # promotions fill exactly the slots the demotes freed (plus
            # any initial slack), so residency never exceeds the budget
            # — a capped demote pass shrinks the room with it
            room = self.budget - (int(res.sum()) - demoted_here)
            for i in order:
                if room <= 0 or swaps_left <= 0:
                    break
                if want[i] and not res[i]:
                    g = int(rng[i])
                    if dwell_ok[g] or g in urgent:
                        promote.append(g)
                        room -= 1
                        swaps_left -= 1
                        if g in urgent or self._cold_count.get(g, 0) == 0:
                            prefetch.add(g)
        return TierPlan(demote=demote, promote=promote, prefetch=prefetch)

    def apply(self, plan: TierPlan):
        """The executor finished the device/store swap for ``plan`` —
        commit the mask flips, dwell clocks, and counters."""
        for g in plan.demote:
            self.resident[g] = False
            self._last_flip[g] = self._cycle
            if g in self._prefetched:
                # predicted, never touched, already evicted: a miss
                self._prefetched.discard(g)
                self.prefetch_misses += 1
        for g in plan.promote:
            self.resident[g] = True
            self._last_flip[g] = self._cycle
            if g in plan.prefetch:
                self._prefetched.add(g)
        self.demotes += len(plan.demote)
        self.promotes += len(plan.promote)

    # ------------------------------------------------------- reporting

    def report(self) -> dict:
        """The ``tiers`` block for ``/jobs/<jid>/pipeline`` and the
        doctor's snapshot."""
        pending = sorted(self._pending_pane.items())
        return {
            "budget_per_shard": self.budget,
            "resident_groups": self.resident_groups(),
            "cold_groups_pending": len(self._pending_pane),
            "cold_entries_approx": int(sum(self._cold_count.values())),
            "next_pending_pane": pending[0][1] if pending else None,
            "faults": self.tier_faults,
            "demotes": self.demotes,
            "promotes": self.promotes,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_misses": self.prefetch_misses,
        }


# ------------------------------------------------- entry-plane helpers
#
# Demote/promote move logical (key, pane, value) entries between the
# device rows and the host pane stores. These helpers are the pure host
# halves the executor composes with its stage/restore/splice machinery.


def entries_key_groups(entries: dict, max_parallelism: int) -> np.ndarray:
    """Key-group of every logical entry (the same route hash the device
    uses, run in host numpy)."""

    return assign_to_key_group(
        route_hash(entries["key_hi"], entries["key_lo"], np),
        max_parallelism, np,
    )


def split_entries(entries: dict, keep: np.ndarray):
    """Partition one entry dict by a boolean mask -> (kept, dropped)."""

    def take(m):
        return {k: np.asarray(v)[m] for k, v in entries.items()}

    keep = np.asarray(keep, bool)
    return take(keep), take(~keep)


def fold_entries(entries: dict, stores: dict, width: int, ufunc,
                 neutral, make_store, combine,
                 fault_point: Optional[str] = "tier.demote.write"):
    """Demote write: fold logical entries into the per-pane host
    stores, pre-combined per (key, pane) with the stage's reduce.
    ``make_store`` lazily creates a store for a new pane; ``combine``
    merges with an existing stored block. Runs behind the
    ``tier.demote.write`` fault seam — a crash here loses only host
    memory the next restore re-seeds from the last cut. Internal
    re-folds (the off-ring half of a promote going straight back)
    pass ``fault_point=None``: they are not a demote IO boundary."""
    n = len(entries["pane"])
    if fault_point is not None:
        faults.inject(fault_point, entries=n)
    if not n:
        return
    k64 = (
        entries["key_hi"].astype(np.uint64) << np.uint64(32)
    ) | entries["key_lo"].astype(np.uint64)
    panes = entries["pane"]
    vals = entries["value"].reshape(n, width).astype(np.float32)
    for p in np.unique(panes):
        sel = panes == p
        uk, inv = np.unique(k64[sel], return_inverse=True)
        agg = np.full((len(uk), width), neutral, np.float32)
        ufunc.at(agg, inv, vals[sel])
        store = stores.get(int(p))
        if store is None:
            store = stores[int(p)] = make_store()
        old, found = store.get(uk)
        merged = np.where(found[:, None], combine(old, agg), agg)
        store.put(uk, merged)


def fetch_group_entries(stores: dict, kg: int, max_parallelism: int,
                        width: int, value_tail, value_dtype):
    """Promote read: pull every pending entry of key-group ``kg`` out
    of the pane stores (get + delete — after this the device copy is
    authoritative). Returns an entry dict in the logical snapshot
    format. Runs behind the ``tier.promote.read`` fault seam."""

    faults.inject("tier.promote.read", kg=int(kg))
    khi_l, klo_l, pane_l, val_l = [], [], [], []
    for p, store in list(stores.items()):
        if len(store) == 0:
            continue
        ks, vs = store.dump()
        hi = (ks >> np.uint64(32)).astype(np.uint32)
        lo = (ks & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        mine = assign_to_key_group(
            route_hash(hi, lo, np), max_parallelism, np
        ) == kg
        if not mine.any():
            continue
        store.delete(ks[mine])
        khi_l.append(hi[mine])
        klo_l.append(lo[mine])
        pane_l.append(np.full(int(mine.sum()), int(p), np.int32))
        val_l.append(vs[mine])
    if not khi_l:
        return {
            "key_hi": np.zeros(0, np.uint32),
            "key_lo": np.zeros(0, np.uint32),
            "pane": np.zeros(0, np.int32),
            "value": np.zeros((0,) + tuple(value_tail), value_dtype),
            "fresh": np.zeros(0, bool),
        }
    value = np.concatenate(val_l).reshape(-1, width)
    if not value_tail:
        value = value[:, 0]
    return {
        "key_hi": np.concatenate(khi_l),
        "key_lo": np.concatenate(klo_l),
        "pane": np.concatenate(pane_l),
        "value": value.astype(value_dtype),
        # promoted entries re-enter the device as fresh pending state:
        # their windows have not fired yet (fired panes were pruned)
        "fresh": np.ones(sum(len(a) for a in khi_l), bool),
    }


def concat_entries(a: dict, b: dict) -> dict:
    """Union two entry dicts (the kept device half + the promoted store
    half). (key, pane) duplicates are legal — the caller pre-combines
    with the stage reduce before the last-write-wins restore scatter."""
    return {
        k: np.concatenate([np.asarray(a[k]), np.asarray(b[k])])
        for k in a
    }


def precombine_entries(entries: dict, width: int, ufunc, neutral) -> dict:
    """Collapse (key, pane) duplicates with the stage's reduce so the
    restore scatter (last-write-wins) sees each logical cell once. A
    key's pending state can split across device and store when the
    table filled mid-pane; the union re-joins it here."""
    n = len(entries["pane"])
    if not n:
        return entries
    k64 = (
        entries["key_hi"].astype(np.uint64) << np.uint64(32)
    ) | entries["key_lo"].astype(np.uint64)
    cell = (k64, entries["pane"].astype(np.int64))
    uniq, inv = np.unique(np.stack(
        [cell[0].astype(np.int64), cell[1]], axis=1
    ), axis=0, return_inverse=True)
    if len(uniq) == n:
        return entries
    vals = entries["value"].reshape(n, width).astype(np.float32)
    agg = np.full((len(uniq), width), neutral, np.float32)
    ufunc.at(agg, inv, vals)
    fresh = np.zeros(len(uniq), bool)
    np.logical_or.at(fresh, inv, entries["fresh"].astype(bool))
    tail = entries["value"].shape[1:]
    # the int64 view of the u64 key is bijective — cast back to recover
    uk = uniq[:, 0].astype(np.uint64)
    return {
        "key_hi": (uk >> np.uint64(32)).astype(np.uint32),
        "key_lo": (uk & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        "pane": uniq[:, 1].astype(np.int32),
        "value": agg.reshape((len(uniq),) + tuple(tail)).astype(
            entries["value"].dtype
        ),
        "fresh": fresh,
    }


def ring_window(entries: dict, max_pane: int, ring: int):
    """Split entries into (on-ring, off-ring) halves for a promote: only
    panes inside the live ring window can splice onto the device; the
    rest stay in the cold tier and merge at fire the normal way. A
    silent drop here would be data loss — the caller folds the off-ring
    half straight back into the stores."""
    pane = entries["pane"]
    if max_pane == int(PANE_NONE):
        # no pane has ever landed on the device ring: nothing can splice
        return split_entries(entries, np.zeros(len(pane), bool))
    fits = (pane > max_pane - ring) & (pane <= max_pane)
    return split_entries(entries, fits)
