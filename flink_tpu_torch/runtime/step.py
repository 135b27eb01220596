"""Stage steps on one device — the window, session, count-window and
rolling stages of flink_tpu/runtime/step.py.

The reference compiles a stage into one jitted SPMD function per dispatch
and donates the state to XLA. Here PyTorch runs eagerly: a step is a plain
function over a ``WindowShardState`` whose tensors it updates in place,
and the resident drain is a Python slot loop that enqueues the kernels of
``ops/cuda.py`` on one stream without reading anything back between slots.
(Capturing the slot loop as a CUDA graph is later work: ROADMAP queue 1,
item 5.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from flink_tpu_torch.metrics.drain_stats import DRAIN_STAT_FIELDS
from flink_tpu_torch.ops import count_windows as cw
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import rolling
from flink_tpu_torch.ops import session_windows as sw
from flink_tpu_torch.ops import window_kernels as wk


@dataclass
class WindowStageSpec:
    """Static config of one keyed-window pipeline stage: the reference's
    fields, with the reduce's planes (``wk.plane_of``: packed for sum,
    count, min, max and mean, split for a generic reduce or a sketch).
    ``layout`` is ``direct`` (key == slot) or ``hash`` (the open-addressing
    table, ``probe_len`` slots per chain).
    The port has one update path, whose state equals the reference's with
    pre-combine on and off, so there is no pre-combine field."""

    win: wk.WindowSpec
    red: wk.ReduceSpec
    capacity_per_shard: int = 1 << 16
    layout: str = "direct"
    probe_len: int = 16


def init_shard_state(spec: WindowStageSpec, max_parallelism: int,
                     device) -> wk.WindowShardState:
    """One shard's state, with changelog bits sized to the key-group space
    (the reference's ``init_sharded_state`` for a one-device mesh)."""
    return wk.init_state(spec.capacity_per_shard, spec.win, spec.red,
                         n_key_groups=max_parallelism, device=device,
                         layout=spec.layout, probe_len=spec.probe_len)


def mask_update_shard(state: wk.WindowShardState, spec: WindowStageSpec,
                      kg_start: int, kg_end: int, hi, lo, ts, values, valid,
                      wm, maxp: int, clear_rows=None, insert: bool = True,
                      kg_fill: bool = False, fill_out=None, lane_stats=None):
    """Per-shard body of the mask route: hash to key groups, mask to the
    owned groups, apply the window update (G1-G3; G5 or G8 in the hash
    layout; G7 with an overflow ring), then advance the shard watermark to
    ``wm`` (int32 0-d) — in place. ``kg_fill`` counts the batch's owned
    lanes per key group inside G1 (observability.kg-stats), into
    ``fill_out`` when given. Returns ``(state, activity, kgf)`` as
    ``update`` does (``kgf`` int32 [maxp], or [0] with the fill off);
    ``lane_stats`` receives G1's batch scalars (see ``update``)."""
    state, activity, kgf = wk.update(
        state, spec.win, spec.red, hi, lo, ts, values, valid, maxp=maxp,
        kg_start=kg_start, kg_end=kg_end, clear_rows=clear_rows,
        insert=insert, kg_fill=maxp if kg_fill else 0, fill_out=fill_out,
        lane_stats=lane_stats)
    torch.maximum(state.watermark, wm, out=state.watermark)      # in place
    return state, activity, kgf


Slot = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
             torch.Tensor]


def _stack_fires(fires, arena):
    """Stack per-slot fires to [D, F]: ReducedFires, or CompactFires whose
    row buffers are the drain's [D, F, C] arena (slot d wrote arena[d])."""
    small = [torch.stack([getattr(f, n) for f in fires])
             for n in ("counts", "window_end_ticks", "n_fires", "lane_valid",
                       "value_sums")]
    if arena is None:
        return wk.ReducedFires(*small)
    return wk.CompactFires(*arena, *small)


def _skip_fires(F: int, device, rows=None):
    """The reference's zero payload of a slot past ``count`` (a compact
    slot's rows are its arena views, never read: its counts are 0)."""
    zi = torch.zeros(F, dtype=torch.int32, device=device)
    small = (zi, zi, torch.zeros((), dtype=torch.int32, device=device),
             torch.zeros(F, dtype=torch.bool, device=device),
             torch.zeros(F, dtype=torch.float32, device=device))
    if rows is None:
        return wk.ReducedFires(*small)
    return wk.CompactFires(*rows, *small)


def build_window_resident_drain(spec: WindowStageSpec, depth: int,
                                max_parallelism: int, reduced: bool = True,
                                insert: bool = True, arena=None,
                                kg_fill: bool = False,
                                drain_stats: bool = False):
    """Device-resident ring drain for one device (the reference's
    ``build_window_resident_drain`` at one shard). ``insert=False`` builds
    the fast variant, whose hash-layout updates look keys up and place
    none (the reference's ``build_fast``, executor.py:2053-2072).

    ``drain(state, slots, wmv, count)``: ``slots`` is a sequence of
    ``depth`` staged batches ``(hi, lo, ticks, values, valid)`` (int32,
    int32, int32, float32 — ``[B, *value_shape]`` for a vector reduce, a
    sketch's int32 item hashes —, bool; [B] each), ``wmv`` an int32 [depth]
    device tensor of per-slot watermarks, ``count`` the number of live
    slots (a host int: the executor knows how many it staged). For each
    live slot it runs the update with the previous slot's deferred purge
    folded into the ring-reset sweep, advances the watermark and fires
    up to F window-ends; slots past ``count`` are skipped and yield zero
    fires. The last deferred purge is applied at the end. With allowed
    lateness each slot's fire is the reference's classic advance (its
    ``build_window_fire_step``, step.py:2303): F on-time lanes and F
    re-fire lanes, purged at once, no purge deferred. Returns
    ``(state, (ovf_n, activity, kg_fill), fires)``: ``ovf_n`` int32
    [depth], the overflow ring's fill after each slot's update (the last
    live slot's repeated past ``count``; its last entry is the fill after
    the drain), ``activity`` int32 0-d, the summed activity of the updates
    (see ``update``), ``kg_fill`` int32 [max_parallelism], the live slots'
    lanes per key group summed (G1's fill; [0] when ``kg_fill`` is off),
    all on the device, and ``fires`` stacked [depth, Ft] (Ft =
    ``win.fire_lanes``: F, or 2F with lateness); the state is updated in
    place. Nothing is read back to the host.

    ``drain_stats`` (observability.drain-stats) adds a fourth element,
    the flight recorder: int32 [depth, len(DRAIN_STAT_FIELDS)], one row a
    live slot written by G18 after the slot's fire (G18's companion saves
    the slot's watermark and drop counters before its update), zeros past
    ``count`` (the reference's contract, its step.py:896-905, at one
    shard).

    ``reduced=True``: ReducedFires, per-lane (count, value sum) reduced on
    the device (G4; G15 for a sketch; G6's fire_pack for a generic
    reduce). ``reduced=False``: CompactFires (G6; G15), whose rows land in
    one [depth, Ft, C] arena allocated at the drain's first call and reused
    by every later one, D·Ft·C·(8 + 4 W) bytes (values [depth, Ft, C,
    *out_shape]): a drain's rows must be read
    before the next drain (or ``fire_only`` with ``out=arena_rows(0)``)
    runs. ``arena`` shares another drain's (``drain.arena``) so that the
    insert and fast variants of one stage hold one."""
    D = int(depth)
    F = spec.win.fire_lanes
    kg_end = max_parallelism - 1
    # the compact drains' (key_hi, key_lo, values) arena, made at first use
    arena = [None] if arena is None else arena

    def drain(state: wk.WindowShardState, slots: Sequence[Slot], wmv,
              count: int):
        if len(slots) < count or count > D:
            raise ValueError(f"{count} live slots for a depth-{D} drain "
                             f"with {len(slots)} staged")
        if not reduced and arena[0] is None:
            arena[0] = wk.fire_row_buffers(D, F, state.capacity,
                                           state.device, red=spec.red)
        rows = None if reduced else arena[0]
        dev = state.device
        i32 = dict(dtype=torch.int32, device=dev)
        pend = None
        fires = []
        fills = []
        activity = torch.zeros((), **i32)
        kgf = torch.zeros((D, max_parallelism) if kg_fill else (0,), **i32)
        if drain_stats:
            ds = torch.zeros((D, len(DRAIN_STAT_FIELDS)), **i32)
            lane_stats = torch.empty((D, 4), **i32)
            snaps = torch.empty((D, 3), **i32)
        for i in range(D):
            slot_rows = None if rows is None else tuple(r[i] for r in rows)
            if i >= count:
                fires.append(_skip_fires(F, dev, slot_rows))
                continue
            hi, lo, ts, values, valid = slots[i]
            wm = wmv[i]
            if drain_stats:
                kernels.slot_stats_begin(state.watermark, state.dropped_late,
                                         state.dropped_capacity, snaps[i])
            _st, act, _kgf = mask_update_shard(
                state, spec, 0, kg_end, hi, lo, ts, values, valid, wm,
                max_parallelism, clear_rows=pend, insert=insert,
                kg_fill=kg_fill, fill_out=kgf[i] if kg_fill else None,
                lane_stats=lane_stats[i] if drain_stats else None)
            activity += act
            fills.append(state.ovf_n.clone())
            state, pend, fr = wk.advance_and_fire_resident(
                state, spec.win, spec.red, wm, reduced=reduced,
                out=slot_rows)
            fires.append(fr)
            if drain_stats:
                kernels.slot_stats(
                    ds[i], lane_stats[i], act, fr.lane_valid, fr.counts,
                    state.dropped_late, state.dropped_capacity, state.ovf_n,
                    kgf[i] if kg_fill else None, state.watermark, snaps[i],
                    slide=spec.win.slide_ticks)
        if pend is not None:
            wk.apply_pending_purge(state, spec.win, spec.red, pend)
        if not fills:
            fills.append(state.ovf_n.clone())
        fills += fills[-1:] * (D - len(fills))
        kg_sum = kgf.sum(0, dtype=torch.int32) if kg_fill else kgf
        out = (state, (torch.stack(fills), activity, kg_sum),
               _stack_fires(fires, rows))
        return out + (ds,) if drain_stats else out

    def arena_rows(d: int):
        """Slot ``d``'s [F, C] row views of the arena (compact drains)."""
        return None if arena[0] is None else tuple(r[d] for r in arena[0])

    drain.arena = arena
    drain.arena_rows = arena_rows
    return drain


def build_kg_occupancy_step(spec: WindowStageSpec, max_parallelism: int):
    """Per-key-group live-key occupancy of the stage's state (G17, the
    reference's ``build_kg_occupancy_step`` at one shard): ``step(state)``
    -> int32 [max_parallelism] on the device. It only reads the state;
    the executor runs it at fire boundaries, at most once an
    ``observability.kg-stats-interval-ms``."""
    def occupancy_step(state: wk.WindowShardState):
        return wk.kg_occupancy(state, max_parallelism, spec.red, spec.win)
    return occupancy_step


def fire_only(state: wk.WindowShardState, spec: WindowStageSpec, wm,
              reduced: bool = True, out=None):
    """Advance the watermark to ``wm`` with no batch: fire up to F due
    window-ends (and up to F re-fires with allowed lateness) and purge at
    once (the split fire step of the reference, ``advance_and_fire`` +
    ``reduce_fires`` or ``compact_fires``). ``out`` is the compact rows'
    buffers ([Ft, C]), as for ``advance_and_fire_resident``."""
    state, pend, fires = wk.advance_and_fire_resident(
        state, spec.win, spec.red, wm, reduced=reduced, out=out)
    wk.apply_pending_purge(state, spec.win, spec.red, pend)
    return state, fires


def compact_step(state: wk.WindowShardState,
                 spec: WindowStageSpec) -> wk.WindowShardState:
    """Whole-shard table compaction (``wk.compact_table``, G9), run by the
    executor after it drained the overflow ring (the reference's
    ``build_compact_step`` at one shard)."""
    return wk.compact_table(state, spec.win, spec.red)


def clear_overflow(state: wk.WindowShardState) -> wk.WindowShardState:
    """Zero the overflow ring's fill after the host drained it, in place
    (the ring's lanes may keep stale rows: only ``[:ovf_n]`` is read)."""
    state.ovf_n.zero_()
    return state


# ------------------------------------------- sessions, counts, rolling
#
# The reference's SessionStageSpec / CountStageSpec / RollingStageSpec and
# their build_*_step functions (step.py:2449-2656) at one shard. The
# reference masks each batch to the shard's key groups (step.py:2481-2484);
# one shard owns every key group here, so that mask is the batch's valid
# mask and the steps take it as it is. Each step updates its state in
# place and returns it. The stages keep the reference's fixed probe length
# (``hashtable.KEYED_PROBE_LEN``, 16; the reference's specs carry it as a
# field only for their audit) and have no spill tier (a key with no slot
# is a counted loss).

@dataclass
class SessionStageSpec:
    red: wk.ReduceSpec
    gap_ticks: int = 1000
    capacity_per_shard: int = 1 << 16


def init_session_state(spec: SessionStageSpec, device):
    return sw.init_state(spec.capacity_per_shard, device)


def build_session_step(spec: SessionStageSpec):
    """``step(state, hi, lo, ts, values, valid, wm)`` -> (state, rows,
    n_rows): G5, G10, G11 (``ops/session_windows.py``)."""
    def step(state, hi, lo, ts, values, valid, wm):
        return sw.update_and_fire(state, spec.gap_ticks, hi, lo, ts, values,
                                  valid, wm)
    return step


@dataclass
class CountStageSpec:
    red: wk.ReduceSpec
    n_per_window: int = 100
    capacity_per_shard: int = 1 << 16


def init_count_state(spec: CountStageSpec, device):
    return cw.init_state(spec.capacity_per_shard, device)


def build_count_step(spec: CountStageSpec):
    """``step(state, hi, lo, values, valid)`` -> (state, rows, n_rows):
    G5, G10, G12 (``ops/count_windows.py``)."""
    def step(state, hi, lo, values, valid):
        return cw.update(state, spec.n_per_window, hi, lo, values, valid)
    return step


@dataclass
class RollingStageSpec:
    red: wk.ReduceSpec
    capacity_per_shard: int = 1 << 16


def init_rolling_state(spec: RollingStageSpec, device):
    return rolling.init_state(spec.capacity_per_shard, device, red=spec.red)


def build_rolling_step(spec: RollingStageSpec):
    """``step(state, hi, lo, values, valid)`` -> (state, outputs,
    out_valid): G5, G10, G13 for a sum; G5, G10, G16 and the user's combine
    for a generic reduce (``ops/rolling.py``). With one shard every lane's
    output is its own; the reference's psum over shards has nothing to
    merge."""
    def step(state, hi, lo, values, valid):
        return rolling.update(state, hi, lo, values, valid, red=spec.red)
    return step
