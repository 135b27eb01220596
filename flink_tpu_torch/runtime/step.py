"""Stage steps on one device — the window stage (the split path's update
and fire steps, the K-step megasteps, the resident scan drain and
while-drain, and the chained drain of consecutive window stages), the
session, count-window and rolling stages of flink_tpu/runtime/step.py —
and the window stage and the rolling reduce over a shard mesh (the
sharded section below: the mask, exchange and sharded routes), and the
window stage over a mesh that spans processes (the DCN drain,
``build_window_dcn_resident_drain``).

The reference compiles a stage into one jitted SPMD function per dispatch
and donates the state to XLA. Here PyTorch runs eagerly: a step is a plain
function over a ``WindowShardState`` whose tensors it updates in place,
and a drain is a Python slot loop that enqueues the kernels of
``ops/cuda.py`` on one stream without reading anything back between slots
(the while-drain's bound is a host cursor, read under its ring's lock).
(Capturing the slot loops and the megasteps, whose K and B are fixed, as
CUDA graphs is later work: ROADMAP queue 1, item 5.)
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.metrics.drain_stats import (
    DRAIN_STAT_FIELDS, STAGE_STAT_FIELDS,
)
from flink_tpu_torch.ops import count_windows as cw
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import rolling
from flink_tpu_torch.ops import session_windows as sw
from flink_tpu_torch.ops import window_kernels as wk
from flink_tpu_torch.ops.cuda import PANE_NONE
from flink_tpu_torch.parallel.collectives import ProcessPlane, psum
from flink_tpu_torch.parallel.exchange import (
    bucket_capacity, exchange_across, exchange_records, owned_lanes,
    split_lanes,
)
from flink_tpu_torch.parallel.mesh import device_guard


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
                      kg_fill: bool = False, fill_out=None, lane_stats=None,
                      kg_res=None):
    """Per-shard body of the mask route: hash to key groups, mask to the
    owned groups, apply the window update (G1-G3; G5 or G8 in the hash
    layout; G7 with an overflow ring), then advance the shard watermark to
    ``wm`` (int32 0-d) — in place. ``kg_fill`` counts the batch's owned
    lanes per key group inside G1 (observability.kg-stats), into
    ``fill_out`` when given. Returns ``(state, activity, kgf)`` as
    ``update`` does (``kgf`` int32 [maxp], or [0] with the fill off);
    ``lane_stats`` receives G1's batch scalars (see ``update``).
    ``kg_res`` (bool [maxp], tiered state) diverts the lanes of
    non-resident key groups to the overflow ring (``update``)."""
    state, activity, kgf = wk.update(
        state, spec.win, spec.red, hi, lo, ts, values, valid, maxp=maxp,
        kg_start=kg_start, kg_end=kg_end, clear_rows=clear_rows,
        insert=insert, kg_fill=maxp if kg_fill else 0, fill_out=fill_out,
        lane_stats=lane_stats, kg_res=kg_res)
    torch.maximum(state.watermark, wm, out=state.watermark)      # in place
    return state, activity, kgf


Slot = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
             torch.Tensor]


def _kg_range(kg_range, max_parallelism: int) -> Tuple[int, int]:
    """A shard's inclusive key-group range; None is every key group."""
    if kg_range is None:
        return 0, max_parallelism - 1
    return int(kg_range[0]), int(kg_range[1])


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


def fire_slot(state: wk.WindowShardState, spec: WindowStageSpec, slot: Slot,
              wm, max_parallelism: int, pend, insert: bool = True,
              kg_fill: bool = False, fill_out=None, kg_res=None,
              reduced: bool = True, out=None, stats=None, kg_range=None,
              begin: bool = True):
    """One slot of the drains and one sub-step of the fused-fire megastep
    (the reference shares ``mask_update_shard`` and
    ``advance_and_fire_resident`` between them): the update with the
    previous slot's deferred purge ``pend`` folded into its ring-reset
    sweep (G1-G3; G5 or G8; G7), the watermark advanced to ``wm``, then
    the resident advance and fire (G4 reduced, else G6 into ``out``, the
    slot's [Ft, C] row buffers), its purge deferred. ``fill_out`` takes
    the slot's key-group fill (``kg_fill``). ``stats``, the flight
    recorder's ``(row, lane_stats, snap, defer)`` for this slot, brackets
    the slot with G18's companion and G18. ``kg_range`` (inclusive start,
    end) masks the update to a shard's key groups (all of them by
    default). ``begin=False`` leaves G18's companion to the caller, which
    ran it before its own changes to the counters (the DCN drain's bucket
    overflow). Returns ``(state, pend, fires, activity, fill)``: ``fill``
    the overflow ring's fill after the update, int32 0-d."""
    hi, lo, ts, values, valid = slot
    kg_start, kg_end = _kg_range(kg_range, max_parallelism)
    if stats is not None:
        row, lane_stats, snap, defer = stats
        if begin:
            kernels.slot_stats_begin(state.watermark, state.dropped_late,
                                     state.dropped_capacity, snap)
    _st, act, _kgf = mask_update_shard(
        state, spec, kg_start, kg_end, hi, lo, ts, values, valid, wm,
        max_parallelism, clear_rows=pend, insert=insert, kg_fill=kg_fill,
        fill_out=fill_out, lane_stats=None if stats is None else lane_stats,
        kg_res=kg_res)
    fill = state.ovf_n.clone()
    state, pend, fr = wk.advance_and_fire_resident(
        state, spec.win, spec.red, wm, reduced=reduced, out=out)
    if stats is not None:
        kernels.slot_stats(
            row, lane_stats, act, fr.lane_valid, fr.counts,
            state.dropped_late, state.dropped_capacity, state.ovf_n,
            fill_out if kg_fill else None, state.watermark, snap,
            slide=spec.win.slide_ticks, defer=defer)
    return state, pend, fr, act, fill


def build_window_resident_drain(spec: WindowStageSpec, depth: int,
                                max_parallelism: int, reduced: bool = True,
                                insert: bool = True, arena=None,
                                kg_fill: bool = False,
                                drain_stats: bool = False,
                                defer_fires: bool = False, kg_range=None):
    """Device-resident ring drain for one device (the reference's
    ``build_window_resident_drain`` at one shard). ``insert=False`` builds
    the fast variant, whose hash-layout updates look keys up and place
    none (the reference's ``build_fast``, executor.py:2053-2072).

    ``drain(state, slots, wmv, count[, kg_res])``: ``slots`` is a sequence of
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
    insert and fast variants of one stage hold one.

    ``kg_res`` (tiered key-group state, the reference's ``tiered``
    operand, step.py:861), when given, is a bool [max_parallelism] device
    tensor: every slot's update diverts the lanes of non-resident key
    groups to the overflow ring. The mask is data: a tier swap rewrites it
    between drains, and the drain is not rebuilt. ``kg_range`` masks every
    slot's update to a shard's key groups (``fire_slot``)."""
    D = int(depth)
    F = spec.win.fire_lanes
    # the compact drains' (key_hi, key_lo, values) arena, made at first use
    arena = [None] if arena is None else arena

    def drain(state: wk.WindowShardState, slots: Sequence[Slot], wmv,
              count: int, kg_res=None):
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
            state, pend, fr, act, fill = fire_slot(
                state, spec, slots[i], wmv[i], max_parallelism, pend,
                insert=insert, kg_fill=kg_fill,
                fill_out=kgf[i] if kg_fill else None, kg_res=kg_res,
                reduced=reduced, out=slot_rows,
                stats=((ds[i], lane_stats[i], snaps[i], defer_fires)
                       if drain_stats else None), kg_range=kg_range)
            activity += act
            fills.append(fill)
            fires.append(fr)
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
    drain.ring_depth = D
    return drain


def _zero_fires_stack(spec: WindowStageSpec, reduced: bool, depth: int,
                      device, rows=None):
    """The while-drain's [depth, Ft] fire stacks, zero (the reference's
    ``_zero_fires_stack``): slot i's payload is written into row i when it
    retires, and rows past ``consumed`` stay the skipped slot's zeros. A
    compact drain's rows are its [depth, Ft, C] arena (never read past a
    lane's count)."""
    Ft = spec.win.fire_lanes
    i32 = dict(dtype=torch.int32, device=device)
    small = (torch.zeros(depth, Ft, **i32), torch.zeros(depth, Ft, **i32),
             torch.zeros(depth, **i32),
             torch.zeros(depth, Ft, dtype=torch.bool, device=device),
             torch.zeros(depth, Ft, dtype=torch.float32, device=device))
    if rows is None:
        return wk.ReducedFires(*small)
    return wk.CompactFires(*rows, *small)


def _while_drain_limit(cursor: int, base: int, staged: int,
                       max_slots: int) -> int:
    """The live trip bound of one while-drain dispatch (the reference's
    ``_while_drain_limit``): slots the publish cursor has committed past
    the drain's base, clamped to what the host staged into this dispatch
    and to the per-dispatch bound. Re-evaluated before every iteration."""
    return min(min(max(cursor - base, 0), staged), max_slots)


def build_window_while_drain(spec: WindowStageSpec, max_slots: int,
                             max_parallelism: int, insert: bool = True,
                             kg_fill: bool = False, reduced: bool = False,
                             drain_stats: bool = False, arena=None,
                             kg_range=None):
    """Early-exit ring drain for one device (pipeline.resident-loop:
    while; the reference's ``build_window_while_drain`` at one shard):
    the resident drain's slot body (G1-G9, G18), run while ``i <
    clamp(cursor - base, 0, min(staged, max_slots))``, the bound
    re-evaluated before each iteration.

    ``drain(state, slots, wmv, cursor, base, staged[, kg_res])``:
    ``slots`` the staged batches (at least ``staged``), ``wmv`` int32
    [>= staged] device watermarks, ``cursor`` the publish cursor — an int,
    or a callable returning the live one. The reference re-reads an HBM
    cursor slot in its loop condition; PyTorch runs the loop on the host,
    so the port's cursor is the ring's host write cursor
    (``DeviceBatchRing.write_cursor``), read under the ring's lock before
    every iteration at no device read. ``base`` is the drain group's first
    ring sequence, ``staged`` how many slots the host handed this
    dispatch. Returns ``(state, (ovf_n, activity, kg_fill), fires,
    consumed)``: ``fires`` the [max_slots, Ft] stacks — slot i's payload
    in row i, zeros past ``consumed`` —, ``ovf_n`` int32 [max_slots] the
    overflow ring's fill after each slot (the last repeated past
    ``consumed``), ``consumed`` int32 [1] on the device, the slots
    retired. ``drain_stats`` adds a fifth element, the [max_slots, 9]
    flight recorder (zero rows past ``consumed``). Compact fires land in
    a [max_slots, Ft, C] arena made at the first call (``arena`` shares
    another drain's). Nothing is read back to the host."""
    D = int(max_slots)
    Ft = spec.win.fire_lanes
    arena = [None] if arena is None else arena

    def drain(state: wk.WindowShardState, slots: Sequence[Slot], wmv,
              cursor, base: int, staged: int, kg_res=None):
        if len(slots) < min(staged, D):
            raise ValueError(f"{staged} staged slots for a while drain "
                             f"handed {len(slots)}")
        if not reduced and arena[0] is None:
            arena[0] = wk.fire_row_buffers(D, Ft, state.capacity,
                                           state.device, red=spec.red)
        rows = None if reduced else arena[0]
        dev = state.device
        i32 = dict(dtype=torch.int32, device=dev)
        fires = _zero_fires_stack(spec, reduced, D, dev, rows)
        stacked = (fires.counts, fires.window_end_ticks, fires.n_fires,
                   fires.lane_valid, fires.value_sums)
        live = cursor if callable(cursor) else (lambda: int(cursor))
        activity = torch.zeros((), **i32)
        kgf = torch.zeros((D, max_parallelism) if kg_fill else (0,), **i32)
        fills = []
        if drain_stats:
            ds = torch.zeros((D, len(DRAIN_STAT_FIELDS)), **i32)
            lane_stats = torch.empty((D, 4), **i32)
            snaps = torch.empty((D, 3), **i32)
        pend = None
        i = 0
        while i < _while_drain_limit(live(), base, staged, D):
            state, pend, fr, act, fill = fire_slot(
                state, spec, slots[i], wmv[i], max_parallelism, pend,
                insert=insert, kg_fill=kg_fill,
                fill_out=kgf[i] if kg_fill else None, kg_res=kg_res,
                reduced=reduced,
                out=None if rows is None else tuple(r[i] for r in rows),
                stats=((ds[i], lane_stats[i], snaps[i], False)
                       if drain_stats else None), kg_range=kg_range)
            activity += act
            fills.append(fill)
            # row i of each small field (the reference's dynamic update)
            for buf, v in zip(stacked, (fr.counts, fr.window_end_ticks,
                                        fr.n_fires, fr.lane_valid,
                                        fr.value_sums)):
                buf[i].copy_(v)
            i += 1
        if pend is not None:
            wk.apply_pending_purge(state, spec.win, spec.red, pend)
        if not fills:
            fills.append(state.ovf_n.clone())
        fills += fills[-1:] * (D - len(fills))
        kg_sum = kgf.sum(0, dtype=torch.int32) if kg_fill else kgf
        consumed = torch.full((1,), i, **i32)
        out = (state, (torch.stack(fills), activity, kg_sum), fires,
               consumed)
        return out + (ds,) if drain_stats else out

    def arena_rows(d: int):
        """Slot ``d``'s [Ft, C] row views of the arena (compact drains)."""
        return None if arena[0] is None else tuple(r[d] for r in arena[0])

    drain.arena = arena
    drain.arena_rows = arena_rows
    drain.ring_depth = D
    drain.max_slots = D
    drain.while_drain = True
    return drain


def _check_megastep_call(K: int, slots, wmv, tiered: bool, kg_res) -> None:
    if len(slots) != K or wmv.numel() < K:
        raise ValueError(f"a K = {K} megastep handed {len(slots)} batches "
                         f"and {wmv.numel()} watermarks")
    if tiered != (kg_res is not None):
        raise ValueError("a tiered megastep takes the residency mask, an "
                         "untiered one none")


def build_window_megastep(spec: WindowStageSpec, k_steps: int,
                          max_parallelism: int, insert: bool = True,
                          kg_fill: bool = False, tiered: bool = False,
                          kg_range=None):
    """K-step dispatch fusion for one device (pipeline.steps-per-dispatch;
    the reference's ``build_window_megastep`` at one shard): K staged
    batches applied in one dispatch, each sub-step the single update
    step's body (``mask_update_shard``: late checks against the pre-batch
    watermark, the watermark advanced per batch), so the state equals K
    sequential single steps' bit for bit. ``insert=False`` is the
    lookup-only fast variant (G8).

    ``megastep(state, slots, wmv[, kg_res])``: ``slots`` a sequence of K
    staged batches ``(hi, lo, ticks, values, valid)`` (the drains' slots,
    never stacked into [K, B]: the reference stacks them only for its
    scan's operands), ``wmv`` an int32 [K] device tensor of per-batch
    watermarks, ``kg_res`` the residency mask of tiered state (``tiered``
    builds that variant). Returns ``(state, (ovf_n, activity,
    kg_fill))`` with the single step's shapes: ``ovf_n`` the overflow
    ring's fill after the last sub-step (the fill only grows within a
    dispatch), ``activity`` and ``kg_fill`` summed over the K sub-steps
    (int32 0-d and [max_parallelism], [0] with the fill off), all on the
    device; the state is updated in place. Nothing is read back."""
    K = int(k_steps)
    kg_start, kg_end = _kg_range(kg_range, max_parallelism)

    def megastep(state: wk.WindowShardState, slots: Sequence[Slot], wmv,
                 kg_res=None):
        _check_megastep_call(K, slots, wmv, tiered, kg_res)
        i32 = dict(dtype=torch.int32, device=state.device)
        activity = torch.zeros((), **i32)
        kgf = torch.zeros(max_parallelism if kg_fill else 0, **i32)
        for i in range(K):
            hi, lo, ts, values, valid = slots[i]
            _st, act, _kgf = mask_update_shard(
                state, spec, kg_start, kg_end, hi, lo, ts, values, valid,
                wmv[i],
                max_parallelism, insert=insert, kg_fill=kg_fill,
                fill_out=kgf if kg_fill else None, kg_res=kg_res)
            activity += act
        return state, (state.ovf_n.clone(), activity, kgf)

    megastep.fused_fire = False
    return megastep


def build_window_megastep_fired(spec: WindowStageSpec, k_steps: int,
                                max_parallelism: int, insert: bool = True,
                                kg_fill: bool = False, reduced: bool = False,
                                tiered: bool = False, arena=None,
                                kg_range=None):
    """The fused-fire megastep for one device (pipeline.fused-fire; the
    reference's ``build_window_megastep_fired`` at one shard): each of the
    K sub-steps is the drains' slot body (``fire_slot``: the update, then
    the resident advance and fire under the sub-step's own watermark, its
    purge deferred into the next sub-step's ring-reset sweep), and the
    last deferred purge is applied after the loop, so the state equals K
    sequential update-then-fire steps' bit for bit and a pane crossing
    inside the group fires within the dispatch. With allowed lateness
    each sub-step's fire is the classic advance (F on-time and F re-fire
    lanes, purged at once), as the reference's.

    ``megastep(state, slots, wmv[, kg_res])`` as for
    ``build_window_megastep``. Returns ``(state, (ovf_n, activity,
    kg_fill), fires)``: ``fires`` stacked [K, Ft], sub-step i's payload
    under sub-step i's watermark — ReducedFires (G4) with ``reduced``,
    else CompactFires (G6) whose rows land in one [K, Ft, C] arena made at
    the first call and reused by every later one, K·Ft·C·(8 + 4 W) bytes,
    so a dispatch's rows must be read before the next dispatch runs
    (``arena`` shares another megastep's). ``ovf_n`` is int32 [K], the
    overflow ring's fill after each sub-step's update: its last entry is
    the reference's post-scan fill, the others let the consumer fold each
    sub-step's share of the ring before that sub-step's fires, as it does
    for a drain. Nothing is read back to the host."""
    K = int(k_steps)
    Ft = spec.win.fire_lanes
    arena = [None] if arena is None else arena

    def megastep(state: wk.WindowShardState, slots: Sequence[Slot], wmv,
                 kg_res=None):
        _check_megastep_call(K, slots, wmv, tiered, kg_res)
        if not reduced and arena[0] is None:
            arena[0] = wk.fire_row_buffers(K, Ft, state.capacity,
                                           state.device, red=spec.red)
        rows = None if reduced else arena[0]
        i32 = dict(dtype=torch.int32, device=state.device)
        activity = torch.zeros((), **i32)
        kgf = torch.zeros(max_parallelism if kg_fill else 0, **i32)
        pend, fires, fills = None, [], []
        for i in range(K):
            state, pend, fr, act, fill = fire_slot(
                state, spec, slots[i], wmv[i], max_parallelism, pend,
                insert=insert, kg_fill=kg_fill,
                fill_out=kgf if kg_fill else None, kg_res=kg_res,
                reduced=reduced,
                out=None if rows is None else tuple(r[i] for r in rows),
                kg_range=kg_range)
            activity += act
            fills.append(fill)
            fires.append(fr)
        if pend is not None:
            wk.apply_pending_purge(state, spec.win, spec.red, pend)
        return (state, (torch.stack(fills), activity, kgf),
                _stack_fires(fires, rows))

    def arena_rows(d: int):
        """Sub-step ``d``'s [Ft, C] row views of the arena (compact)."""
        return None if arena[0] is None else tuple(r[d] for r in arena[0])

    megastep.fused_fire = True
    megastep.arena = arena
    megastep.arena_rows = arena_rows
    return megastep


# ------------------------------------------- chained keyed window stages
#
# The reference's chained resident drain (step.py:1789-2172) at one
# device: stage 0 runs the resident drain's slot loop with compact fires
# into its [D, F, C] arena; then, once a drain, each downstream stage j
# takes the whole stack of its upstream's fires as one edge (G21), one
# update, one advance and fire into its own [1, F, C] arena, and one purge.

def chain_fires_to_lanes(cf: wk.CompactFires, n_lanes: int):
    """The reference's ``_chain_fires_to_lanes`` (G21): a CompactFires of
    one slot ([F, C] planes) or a drain's stack ([D, F, C]) re-keyed into
    ``n_lanes`` edge lanes, every fired (key, window) row one record with
    the same key and ts = window_end - 1. Returns the reference's ``(hi,
    lo, ts, vals, ok, dropped, demand)``: int32 key halves and ticks [E],
    values [E, *out_shape], ok bool [E], and int32 0-d counts of the rows
    past E and of all live rows."""
    e = kernels.chain_pack(cf.key_hi, cf.key_lo, cf.values, cf.counts,
                           cf.lane_valid, cf.window_end_ticks,
                           n_lanes=n_lanes)
    return e.hi, e.lo, e.ts, e.vals, e.ok, e.dropped, e.demand


def chain_stage_watermark(up_wm, up_state: wk.WindowShardState,
                          up_spec: WindowStageSpec):
    """The reference's ``_chain_stage_watermark`` (G21 on an empty stack):
    the watermark of the stage fed by ``up_state``'s fires, ``min(up_wm,
    (fired_through + 2) * slide - 2)`` with fired_through clamped to [-1,
    (2^31 - 4) // slide - 2], so that no future upstream fire is late
    downstream and the end-of-stream jump cannot wrap. int32 0-d."""
    dev = up_state.device
    if not isinstance(up_wm, torch.Tensor):
        up_wm = torch.tensor(int(up_wm), dtype=torch.int32, device=dev)
    rows = torch.zeros((0, 1), dtype=torch.int32, device=dev)
    flags = torch.zeros(0, dtype=torch.int32, device=dev)
    return kernels.chain_pack(
        rows, rows, rows.float(), flags, flags.bool(), flags, n_lanes=0,
        up_wm=up_wm, fired_through=up_state.fired_through,
        slide=up_spec.win.slide_ticks).wm


def deferred_fire_columns(ds_stack, cf_stack):
    """The reference's ``_deferred_fire_columns`` (G22 ``fire_columns``):
    the fire_lanes and fired_keys columns of a drain's [D, 9] recorder
    stack filled from its stacked [D, F] fires, in place; returns the
    stack."""
    D = ds_stack.shape[0]
    kernels.fire_columns(ds_stack, cf_stack.lane_valid.reshape(D, -1),
                         cf_stack.counts.reshape(D, -1))
    return ds_stack


def _chained_stage_tail(down_states, specs, st0, cf_stack, wm_last,
                        max_parallelism: int, exchange_lanes: int, arenas,
                        drain_stats: bool = False, lanes_out=None,
                        kg_range=None):
    """Downstream stages of the chained drain, once a drain (the
    reference's ``_chained_stage_tail``): for each stage j >= 1, G21 packs
    its upstream's fires into ``exchange_lanes`` edge lanes and computes
    the coupled watermark; the lanes update the stage (inserting; an
    over-full edge's lanes count into its ``dropped_capacity``), which then
    advances and fires into its ``[1, F, C]`` arena (``arenas[j - 1]``,
    made at first use) and purges at once. Every insert precedes the
    stage's single advance, so no window closes before this drain's
    records for it. Returns ``(down_states, final fires stacked [1, F])``
    and, with ``drain_stats``, the per-stage int32 [S - 1, 6] record
    (G22 ``stage_record``, STAGE_STAT_FIELDS order). ``lanes_out``, a
    list, receives each stage's fire ``lane_valid``. ``kg_range`` masks the
    downstream updates to a shard's key groups: the identity re-key keeps
    every fired key on the shard that fired it, so the edge is a local
    pack and the mask drops nothing."""
    out, recs = [], []
    up_state, up_fires, wm_up = st0, cf_stack, wm_last
    kg_start, kg_end = _kg_range(kg_range, max_parallelism)
    E = int(exchange_lanes)
    for j in range(1, len(specs)):
        sp = specs[j]
        edge = kernels.chain_pack(
            up_fires.key_hi, up_fires.key_lo, up_fires.values,
            up_fires.counts, up_fires.lane_valid, up_fires.window_end_ticks,
            n_lanes=E, up_wm=wm_up, fired_through=up_state.fired_through,
            slide=specs[j - 1].win.slide_ticks)
        st_j = down_states[j - 1]
        wm_b = st_j.watermark.clone() if drain_stats else None
        # downstream stages always insert: their keys arrive by the edge
        mask_update_shard(st_j, sp, kg_start, kg_end, edge.hi, edge.lo,
                          edge.ts, edge.vals, edge.ok, edge.wm,
                          max_parallelism)
        st_j.dropped_capacity.add_(edge.dropped)                 # in place
        if arenas[j - 1] is None:
            arenas[j - 1] = wk.fire_row_buffers(
                1, sp.win.fire_lanes, st_j.capacity, st_j.device, red=sp.red)
        st_j, pend, cf = wk.advance_and_fire_resident(
            st_j, sp.win, sp.red, edge.wm, reduced=False,
            out=tuple(r[0] for r in arenas[j - 1]))
        wk.apply_pending_purge(st_j, sp.win, sp.red, pend)
        if lanes_out is not None:
            lanes_out.append(cf.lane_valid)
        if drain_stats:
            row = torch.empty(len(STAGE_STAT_FIELDS), dtype=torch.int32,
                              device=st_j.device)
            kernels.stage_record(row, edge.demand, E, cf.lane_valid,
                                 edge.dropped, wm_up, edge.wm, wm_b,
                                 st_j.watermark, slide=sp.win.slide_ticks)
            recs.append(row)
        out.append(st_j)
        up_state, wm_up = st_j, edge.wm
        up_fires = _stack_fires([cf], arenas[j - 1])
    if drain_stats:
        return tuple(out), up_fires, torch.stack(recs)
    return tuple(out), up_fires


def build_window_chained_drain(specs: Sequence[WindowStageSpec], depth: int,
                               max_parallelism: int, kg_fill: bool = False,
                               exchange_lanes: int = 1024,
                               drain_stats: bool = False, kg_range=None):
    """Multi-stage resident ring drain for one device (the reference's
    ``build_window_chained_drain`` over a one-shard mesh): stage 0 consumes
    up to ``depth`` staged slots as ``build_window_resident_drain`` does,
    with compact fires stacked in its [D, F, C] arena; then each downstream
    stage runs once over the whole stack (``_chained_stage_tail``) at the
    coupled watermark, the first from the drain's watermark — the maximum
    over the live slots' watermarks.

    ``drain(states, slots, wmv, count)``: ``states`` the tuple of every
    stage's ``WindowShardState`` (updated in place), the rest as for the
    resident drain. Returns ``(states, (ovf_n, activity, kg_fill),
    fires)``, ``fires`` the final stage's CompactFires stacked [1, F] in its
    own arena; with ``drain_stats`` a fourth element, the pair ``(ds0,
    ss)``: stage 0's [depth, 9] flight recorder (fire columns filled after
    the loop, G22) and the [S - 1, 6] per-stage records. A drain's stage-0
    rows are read by G21 within the drain; only the final fires reach the
    host, and they must be read before the next drain runs.
    ``exchange_lanes`` bounds each edge's lanes a drain. After each call
    ``drain.stage_lanes`` holds, bool [S * F] on the device, the fire
    lanes of each stage's last advance (stage 0's last live slot's, then
    each downstream stage's): where one stage filled all F, due windows
    may remain for a flush. ``kg_range`` makes it one shard's drain of a
    mesh: every stage's update masked to the shard's key groups."""
    specs = tuple(specs)
    D = int(depth)
    stage0 = build_window_resident_drain(
        specs[0], D, max_parallelism, reduced=False,
        kg_fill=kg_fill, drain_stats=drain_stats, defer_fires=True,
        kg_range=kg_range)
    arenas = [None] * (len(specs) - 1)

    def drain(states, slots: Sequence[Slot], wmv, count: int):
        st0 = states[0]
        out = stage0(st0, slots, wmv, count)
        st0, mon, cf_stack = out[:3]
        live = torch.arange(D, device=wmv.device) < count
        wm_last = torch.where(live, wmv, PANE_NONE).max()
        lanes = [cf_stack.lane_valid[max(count, 1) - 1]]
        tail = _chained_stage_tail(states[1:], specs, st0, cf_stack, wm_last,
                                   max_parallelism, exchange_lanes, arenas,
                                   drain_stats=drain_stats, lanes_out=lanes,
                                   kg_range=kg_range)
        drain.stage_lanes = torch.cat(lanes)
        res = ((st0,) + tail[0], mon, tail[1])
        if drain_stats:
            res += ((deferred_fire_columns(out[3], cf_stack), tail[2]),)
        return res

    drain.stage_lanes = None
    drain.n_stages = len(specs)
    drain.exchange_lanes = int(exchange_lanes)
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


def build_window_update_step(spec: WindowStageSpec, max_parallelism: int,
                             insert: bool = True, kg_fill: bool = False,
                             kg_range=None):
    """The split path's update-only step (the reference's
    ``build_window_update_step`` at one shard): apply one staged batch
    and advance the watermark, fire nothing. ``insert=False`` is the
    lookup-only fast variant (G8). ``step(state, hi, lo, ts, values,
    valid, wm[, kg_res])`` -> ``(state, (ovf_n, activity, kg_fill))``,
    all on the device: the overflow ring's fill after the update, the
    update's activity and the batch's lanes per key group ([0] with the
    fill off). ``kg_res`` (tiered state) diverts the cold groups' lanes.
    The state is updated in place; nothing is read back. ``kg_range``
    masks the update to a shard's key groups."""
    kg_start, kg_end = _kg_range(kg_range, max_parallelism)

    def update_step(state, hi, lo, ts, values, valid, wm, kg_res=None):
        state, activity, kgf = mask_update_shard(
            state, spec, kg_start, kg_end, hi, lo, ts, values, valid, wm,
            max_parallelism, insert=insert, kg_fill=kg_fill, kg_res=kg_res)
        return state, (state.ovf_n.clone(), activity, kgf)

    update_step.insert = insert
    return update_step


def build_window_step(spec: WindowStageSpec, max_parallelism: int):
    """Update and fire in one step (the reference's ``build_window_step``
    at one shard): ``step(state, hi, lo, ts, values, valid, wm)`` ->
    ``(state, fires)``, the classic advance's compact fires (G1-G3, G6;
    the purge at once)."""
    update_step = build_window_update_step(spec, max_parallelism)

    def step(state, hi, lo, ts, values, valid, wm):
        state, _mon = update_step(state, hi, lo, ts, values, valid, wm)
        return fire_only(state, spec, wm, reduced=False)

    return step


def build_window_fire_step(spec: WindowStageSpec, out=None):
    """The split path's fire step (the reference's
    ``build_window_fire_step``): ``fire_step(state, wm)`` advances to
    ``wm`` and returns ``(state, CompactFires)`` of up to F due window
    ends over every key (G6, G15 for a sketch, G6's ``fire_pack`` for a
    generic reduce), purged at once. ``out``: a callable giving the rows'
    [Ft, C] buffers (the drain arena's slot 0), else they are allocated
    per call."""
    def fire_step(state, wm):
        return fire_only(state, spec, wm, reduced=False,
                         out=None if out is None else out())
    return fire_step


def build_window_fire_reduced_step(spec: WindowStageSpec):
    """The split path's reduced fire step (the reference's
    ``build_window_fire_reduced_step``): ``fire_step(state, wm)`` ->
    ``(state, ReducedFires)``, each lane's (count, value sum) reduced on
    the device (G4), for device-reduce sinks with no spill to merge."""
    def fire_step(state, wm):
        return fire_only(state, spec, wm, reduced=True)
    return fire_step


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



# ------------------------------------------- a window stage over n shards
#
# The reference's shard_map'd steps (step.py:60, 241, 275, 461, 658, 1011,
# 1158, 1497) over the port's mesh (parallel/mesh.py): one state a shard,
# on its device, each shard's kernels run by the one-device step of this
# module masked to the shard's key groups (``kg_range``). How a batch
# reaches the shards is the route:
#
#   * "mask" (replicate-and-mask): every shard takes the whole batch and
#     G1 keeps the lanes of its key groups;
#   * "exchange": the batch splits into n lane slices, G26 buckets each
#     source's slice by owning shard, the all_to_all hands each target its
#     buckets (parallel/exchange.py), and the target's update masks them
#     (every valid lane is its own). Bucket overflow is added to the source
#     shard's dropped_capacity;
#   * "sharded" (pipeline.data-parallel): the ingest side partitioned the
#     batch by owning shard (ShardedDeviceBatchRing), so shard s drains its
#     own slots, gated on its own count.
#
# A sharded step takes the list of shard states and returns ``(states,
# (ovf_n, activity, kg_fill)[, fires])``: ``ovf_n`` the shards' ring fills
# stacked on the first shard's device ([n], or [n, D] a slot), activity and
# the key-group fill summed over the shards, ``fires`` a list of each
# shard's fires (the reference's leading shard axis). The states are
# updated in place.

def init_sharded_state(ctx, spec: WindowStageSpec):
    """One ``WindowShardState`` a shard, on its device (the reference's
    ``init_sharded_state``, a list where it stacks)."""
    return [init_shard_state(spec, ctx.max_parallelism, d)
            for d in ctx.devices]


def _to(t: torch.Tensor, device) -> torch.Tensor:
    device = torch.device(device)
    return t if t.device == device else t.to(device, non_blocking=True)


def _ranges(ctx):
    """The key-group ranges of this process's shards, paired with
    ``ctx.devices`` (over several processes, the local ones only)."""
    return [(r.start, r.end) for r in ctx.local_key_group_ranges]


def _merge_mon(ctx, mons, kg_fill: bool):
    """The shards' (ovf_n, activity, kg_fill) on the first shard's device:
    fills stacked, activity and key-group fill summed."""
    dev = ctx.devices[0]
    fills = torch.stack([_to(m[0], dev) for m in mons])
    act = sum(_to(m[1], dev) for m in mons)
    kgf = sum(_to(m[2], dev) for m in mons) if kg_fill else mons[0][2]
    return fills, act, kgf


def exchange_update_slots(ctx, states, slots, cap: int):
    """The exchange route of ``slots`` (a sequence of [B] batches): each
    batch's lane slices bucketed by G26 and exchanged, the overflow of
    source s added to ``states[s].dropped_capacity``. Returns the received
    batches of each target shard, [n][len(slots)]. One process's mesh only:
    across processes the exchange is ``parallel/exchange.py
    exchange_across`` over the plane."""
    if ctx.process_count > 1:
        raise ValueError("exchange_update_slots exchanges within one "
                         "process; a mesh over processes exchanges "
                         "through exchange_across")
    n, devs = ctx.n_shards, ctx.devices
    per = [[] for _ in range(n)]
    for slot in slots:
        received, over = exchange_records(split_lanes(slot, n, devs), n,
                                          ctx.max_parallelism, cap, devs)
        for st, o in zip(states, over):
            st.dropped_capacity.add_(_to(o, st.device).reshape(()))
        for t in range(n):
            per[t].append(received[t])
    return per


def _route(ctx, route: str, states, slots, cap: int):
    """Each shard's batches of ``slots`` under ``route`` ("mask" or
    "exchange"), on its device."""
    if route == "exchange":
        return exchange_update_slots(ctx, states, slots, cap)
    return [[tuple(_to(t, d) for t in slot) for slot in slots]
            for d in ctx.devices]


def build_sharded_update_step(ctx, spec: WindowStageSpec, route: str = "mask",
                              insert: bool = True, kg_fill: bool = False,
                              cap: int = 0):
    """The split path's update step over the mesh: the reference's
    ``build_window_update_step`` (the mask route) and
    ``build_window_update_step_exchange`` (``route="exchange"``, bucket
    capacity ``cap``). ``step(states, slot, wm[, kg_res])`` -> ``(states,
    (ovf_n [n], activity, kg_fill))``."""
    maxp = ctx.max_parallelism
    steps = [build_window_update_step(spec, maxp, insert=insert,
                                      kg_fill=kg_fill, kg_range=r)
             for r in _ranges(ctx)]

    def update_step(states, slot, wm, kg_res=None):
        per = _route(ctx, route, states, [slot], cap)
        mons = [steps[s](states[s], *per[s][0], _to(wm, states[s].device),
                         kg_res=kg_res)[1] for s in range(ctx.n_shards)]
        return states, _merge_mon(ctx, mons, kg_fill)

    update_step.insert = insert
    update_step.route = route
    update_step.bucket_cap = cap
    return update_step


def build_window_update_step_exchange(ctx, spec: WindowStageSpec,
                                      batch_per_device: int,
                                      capacity_factor: float = 2.0,
                                      insert: bool = True,
                                      kg_fill: bool = False):
    """The reference's exchange update step (G26, the all_to_all, G1-G3):
    ``build_sharded_update_step`` on the exchange route with the bucket
    capacity of ``batch_per_device`` lanes a shard."""
    cap = bucket_capacity(batch_per_device, ctx.n_shards, capacity_factor)
    step = build_sharded_update_step(ctx, spec, "exchange", insert=insert,
                                     kg_fill=kg_fill, cap=cap)
    step.recv_lanes = ctx.n_shards * cap
    return step


def build_sharded_megastep(ctx, spec: WindowStageSpec, k_steps: int,
                           route: str = "mask", insert: bool = True,
                           kg_fill: bool = False, fused_fire: bool = False,
                           reduced: bool = False, cap: int = 0, share=None,
                           tiered: bool = False):
    """The K-step megasteps over the mesh (the reference's
    ``build_window_megastep`` / ``_fired`` on the mask route,
    ``build_window_megastep_exchange`` / ``_fired_exchange`` on the
    exchange route): each shard's one-device megastep over its K routed
    batches. ``megastep(states, slots, wmv[, kg_res])`` -> ``(states,
    (ovf_n, activity, kg_fill)[, fires])``, ``ovf_n`` [n] (plain) or
    [n, K] (fused fire). ``share`` gives the fast variant the insert
    variant's arenas."""
    maxp = ctx.max_parallelism
    megas = []
    for s, r in enumerate(_ranges(ctx)):
        if fused_fire:
            arena = share.shards[s].arena if share is not None else None
            megas.append(build_window_megastep_fired(
                spec, k_steps, maxp, insert=insert, kg_fill=kg_fill,
                reduced=reduced, tiered=tiered, arena=arena, kg_range=r))
        else:
            megas.append(build_window_megastep(
                spec, k_steps, maxp, insert=insert, kg_fill=kg_fill,
                tiered=tiered, kg_range=r))

    def megastep(states, slots, wmv, kg_res=None):
        per = _route(ctx, route, states, slots, cap)
        outs = [megas[s](states[s], per[s], _to(wmv, states[s].device),
                         kg_res) for s in range(ctx.n_shards)]
        mon = _merge_mon(ctx, [o[1] for o in outs], kg_fill)
        if fused_fire:
            return states, mon, [o[2] for o in outs]
        return states, mon

    megastep.fused_fire = fused_fire
    megastep.route = route
    megastep.shards = megas
    megastep.bucket_cap = cap
    return megastep


def build_sharded_drain(ctx, spec: WindowStageSpec, depth: int,
                        route: str = "mask", insert: bool = True,
                        kg_fill: bool = False, reduced: bool = False,
                        while_drain: bool = False, cap: int = 0,
                        share=None, drain_stats: bool = False):
    """The ring drains over the mesh: on the mask route the reference's
    ``build_window_resident_drain`` (``while_drain``:
    ``build_window_while_drain``) over n shards, every shard draining the
    whole batches; on the exchange route
    ``build_window_resident_drain_exchange`` — each live slot exchanged,
    then each shard's scan drain over its received slots with the one
    count all shards share (the reference keeps the scan for this route
    under ``while`` too, sized to the while bound); on the sharded route
    ``build_window_sharded_drain`` (``while_drain``:
    ``build_window_while_drain_sharded``), shard s draining its own
    partitioned slots gated on its own count.

    ``drain(states, slots, wmv, counts[, cursors, bases])``: mask and
    exchange routes: ``slots`` the staged [B] batches, ``counts`` one int;
    sharded route: ``slots[s]`` shard s's batches and ``counts[s]`` its
    count. A while-drain takes each shard's cursor (callable or int) and
    base. Returns ``(states, (ovf_n [n, D], activity, kg_fill), fires)``
    and, for a while-drain, each shard's consumed count (int32 [1]) as a
    fourth element; ``drain_stats`` adds each shard's flight recorder
    last."""
    maxp = ctx.max_parallelism
    use_while = while_drain and route != "exchange"
    drains = []
    for s, r in enumerate(_ranges(ctx)):
        arena = share.shards[s].arena if share is not None else None
        if use_while:
            drains.append(build_window_while_drain(
                spec, depth, maxp, insert=insert, kg_fill=kg_fill,
                reduced=reduced, drain_stats=drain_stats, arena=arena,
                kg_range=r))
        else:
            drains.append(build_window_resident_drain(
                spec, depth, maxp, reduced=reduced, insert=insert,
                arena=arena, kg_fill=kg_fill, drain_stats=drain_stats,
                kg_range=r))
    n = ctx.n_shards

    def drain(states, slots, wmv, counts, cursors=None, bases=None,
              kg_res=None):
        if route == "sharded":
            per, cs = slots, list(counts)
        else:
            per = _route(ctx, route, states, slots[:counts], cap)
            cs = [counts] * n
        outs = []
        for s in range(n):
            w = _to(wmv, states[s].device)
            if use_while:
                outs.append(drains[s](states[s], per[s], w, cursors[s],
                                      bases[s], cs[s], kg_res))
            else:
                outs.append(drains[s](states[s], per[s], w, cs[s], kg_res))
        mon = _merge_mon(ctx, [o[1] for o in outs], kg_fill)
        res = (states, mon, [o[2] for o in outs])
        if use_while:
            res += ([o[3] for o in outs],)
        if drain_stats:
            res += ([o[-1] for o in outs],)
        return res

    drain.shards = drains
    drain.route = route
    drain.ring_depth = int(depth)
    drain.while_drain = use_while
    if use_while:
        drain.max_slots = int(depth)
    drain.bucket_cap = cap
    return drain


def build_window_sharded_drain(ctx, spec: WindowStageSpec, depth: int,
                               insert: bool = True, kg_fill: bool = False,
                               reduced: bool = False):
    """The reference's data-parallel drain: ``build_sharded_drain`` on the
    sharded route."""
    return build_sharded_drain(ctx, spec, depth, "sharded", insert=insert,
                               kg_fill=kg_fill, reduced=reduced)


def build_sharded_chained_drain(ctx, specs: Sequence[WindowStageSpec],
                                depth: int, route: str = "mask",
                                kg_fill: bool = False,
                                exchange_lanes: int = 1024,
                                drain_stats: bool = False):
    """The chained drains over the mesh: on the mask route the reference's
    ``build_window_chained_drain`` at n shards, every shard draining the
    whole staged batches masked to its key groups; on the sharded route
    ``build_window_chained_drain_sharded``, shard s draining its own
    partitioned slots up to its own count. Each shard runs the one-device
    chained drain over its key-group range (G1-G3, G5, G6, G21, G22; the
    edge a local pack: the identity re-key keeps a fired key on its
    owner, so there is no exchange between stages), under its device's
    guard, and its tail advances at the maximum watermark of its own live
    slots (a shard with none advances nothing downstream).

    ``drain(states, slots, wmv, counts)``: ``states[s]`` shard s's tuple of
    stage states (updated in place); mask route: ``slots`` the staged [B]
    batches and ``counts`` one int; sharded route: ``slots[s]`` shard s's
    batches and ``counts[s]`` its count; ``wmv`` the drain's int32 [depth]
    watermarks. Returns ``(states, (ovf_n [n, D], activity, kg_fill),
    fires)``, ``fires[s]`` shard s's final-stage fires stacked [1, F]; with
    ``drain_stats`` a fourth element, the pair ``(ds0, ss)``: the shards'
    stage-0 recorders int32 [n, depth, 9] and the downstream stages'
    records [S - 1, n, 6] (the reference's blocks). After each call
    ``drain.stage_lanes`` holds every shard's stage fire lanes, bool
    [n * S * F] on the first shard's device."""
    maxp = ctx.max_parallelism
    n = ctx.n_shards
    drains = [build_window_chained_drain(
        specs, depth, maxp, kg_fill=kg_fill, exchange_lanes=exchange_lanes,
        drain_stats=drain_stats, kg_range=r) for r in _ranges(ctx)]
    dev0 = ctx.devices[0]

    def drain(states, slots, wmv, counts):
        if route == "sharded":
            per, cs = slots, list(counts)
        else:
            per = _route(ctx, route, states, slots[:counts], 0)
            cs = [counts] * n
        outs, lanes = [], []
        for s in range(n):
            dev = ctx.devices[s]
            with device_guard(dev):
                outs.append(drains[s](tuple(states[s]), per[s],
                                      _to(wmv, dev), cs[s]))
            lanes.append(_to(drains[s].stage_lanes, dev0))
        drain.stage_lanes = torch.cat(lanes)
        mon = _merge_mon(ctx, [o[1] for o in outs], kg_fill)
        res = ([o[0] for o in outs], mon, [o[2] for o in outs])
        if drain_stats:
            ds0 = torch.stack([_to(o[3][0], dev0) for o in outs])
            ss = torch.stack([_to(o[3][1], dev0) for o in outs], dim=1)
            res += ((ds0, ss),)
        return res

    drain.stage_lanes = None
    drain.ring_depth = int(depth)
    return drain


def build_window_chained_drain_sharded(ctx, specs: Sequence[WindowStageSpec],
                                       depth: int, kg_fill: bool = False,
                                       exchange_lanes: int = 1024,
                                       drain_stats: bool = False):
    """The reference's data-parallel chained drain:
    ``build_sharded_chained_drain`` on the sharded route."""
    return build_sharded_chained_drain(
        ctx, specs, depth, "sharded", kg_fill=kg_fill,
        exchange_lanes=exchange_lanes, drain_stats=drain_stats)


def build_sharded_fire_step(ctx, spec: WindowStageSpec,
                            reduced: bool = False, out=None):
    """The split path's fire steps over the mesh: every shard advances to
    ``wm`` and fires up to F due window-ends (G4 reduced, else G6 into
    ``out(s)``, shard s's [Ft, C] row buffers). ``fire_step(states, wm)``
    -> ``(states, fires)``, a list of each shard's fires."""
    steps = []
    for s in range(ctx.n_shards):
        if reduced:
            steps.append(build_window_fire_reduced_step(spec))
        else:
            steps.append(build_window_fire_step(
                spec, out=None if out is None else
                functools.partial(out, s)))

    def fire_step(states, wm):
        return states, [steps[s](states[s], _to(wm, states[s].device))[1]
                        for s in range(ctx.n_shards)]

    return fire_step


def sharded_kg_occupancy(ctx, spec: WindowStageSpec, states):
    """Live keys per key group over every shard (G17 a shard, summed; the
    shards own disjoint key groups): int32 [max_parallelism] on the first
    shard's device."""
    step = build_kg_occupancy_step(spec, ctx.max_parallelism)
    return sum(_to(step(st), ctx.devices[0]) for st in states)


# ------------------------------------------- a window stage over processes

def _host_bits(a) -> np.ndarray:
    """A host array, uint32 key halves seen as the int32 the kernels take."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def build_window_dcn_resident_drain(ctx, spec: WindowStageSpec,
                                    batch_per_device: int, depth: int,
                                    capacity_factor: float = 2.0,
                                    insert: bool = True,
                                    drain_stats: bool = False, plane=None):
    """The per-host DCN drain (the reference's
    ``build_window_dcn_resident_drain``, K13 DCN): the lockstep window step
    of ``runtime/dcn.py``'s window runner run up to ``depth`` times a
    dispatch, over a mesh ``ctx`` whose shards span ``plane``'s processes
    (one process without a plane).

    ``drain(states, hi, lo, ts, values, valid, wm, done, fills)``: this
    process's local shard states (updated in place), its [depth, B] slot
    stacks (uint32 halves as int32, int32 ticks, float32, bool; B =
    ``batch_per_device`` x its shard count; numpy or tensors), its [depth]
    per-slot watermarks, its done flag and its fill. One all_reduce agrees
    before the loop on the slot count (the ``pmax`` of the fills, so every
    process enters the same number of exchanges, a shallower ring padding
    empty slots), done (``pmin``) and each slot's watermark (``pmin``). Each
    live slot splits into one lane slice a local shard, is exchanged over
    every shard of every process (G26 and the plane's all_to_all, bucket
    capacity ``bucket_capacity(batch_per_device, n, capacity_factor)``,
    overflow into the source shard's ``dropped_capacity``), and each local
    shard's received lanes run its update masked to its key groups (G1-G3;
    G5 or G8 in the hash layout), the advance to the slot's watermark and
    its fire (G6 into the shard's [depth, F, C] arena), its purge deferred
    to the next slot's sweep (G2). After the loop a second all_reduce
    agrees on the fire backlog (``pmax``: a slot with F fired lanes means
    more window ends may be due). Returns ``(states, fires, stop,
    drained)``: ``fires[s]`` local shard s's CompactFires stacked [depth,
    F] over its arena (zero past ``drained``), ``stop`` whether every
    process is done with no backlog, ``drained`` the agreed slot count.
    ``drain_stats`` adds each local shard's flight recorder, int32 [depth,
    9] by G18 (the reference's ``_slot_drain_stats`` per shard: its
    ``events`` the shard's own pre-exchange lanes)."""
    plane = plane or ProcessPlane()
    n, maxp = ctx.n_shards, ctx.max_parallelism
    devs = [torch.device(d) for d in ctx.devices]
    L = len(devs)
    if n != L * plane.nproc:
        raise ValueError(f"a {n}-shard mesh over {plane.nproc} processes of "
                         f"{L} shards")
    cap = bucket_capacity(batch_per_device, n, capacity_factor)
    D = int(depth)
    F = spec.win.fires_per_step
    if spec.win.lateness_ticks:
        raise ValueError("the DCN drain takes no allowed lateness")
    ranges = [(r.start, r.end) for r in ctx.local_key_group_ranges]
    arenas = [None] * L

    def drain(states, hi, lo, ts, values, valid, wm, done, fills):
        cols = [torch.as_tensor(_host_bits(c)) for c in
                (hi, lo, ts, values, valid)]
        wm = [int(w) for w in np.asarray(wm).reshape(D, -1)[:, 0]]
        g_min, g_max = plane.agree(mins=[int(done)] + wm,
                                   maxs=[int(fills)])
        gdone, gwm, count = g_min[0], g_min[1:], g_max[0]
        for s in range(L):
            if arenas[s] is None:
                arenas[s] = wk.fire_row_buffers(D, F, states[s].capacity,
                                                devs[s], red=spec.red)
        fires = [[] for _ in range(L)]
        pend = [None] * L
        backlog = []
        if drain_stats:
            i32 = [dict(dtype=torch.int32, device=d) for d in devs]
            ds = [torch.zeros((D, len(DRAIN_STAT_FIELDS)), **a) for a in i32]
            lane_stats = [torch.empty((D, 4), **a) for a in i32]
            snaps = [torch.empty((D, 3), **a) for a in i32]
        for i in range(D):
            rows = [tuple(r[i] for r in arenas[s]) for s in range(L)]
            if i >= count:
                for s in range(L):
                    fires[s].append(_skip_fires(F, devs[s], rows[s]))
                continue
            slices = split_lanes(tuple(c[i] for c in cols), L, devs)
            received, over = exchange_across(plane, slices, n, maxp, cap,
                                             devs)
            for s in range(L):
                st = states[s]
                with device_guard(devs[s]):
                    w = torch.tensor(gwm[i], dtype=torch.int32,
                                     device=devs[s])
                    stats = None
                    if drain_stats:
                        stats = (ds[s][i], lane_stats[s][i], snaps[s][i],
                                 False)
                        kernels.slot_stats_begin(
                            st.watermark, st.dropped_late,
                            st.dropped_capacity, snaps[s][i])
                    st.dropped_capacity.add_(_to(over[s], devs[s])
                                             .reshape(()))
                    _st, pend[s], fr, _act, _fill = fire_slot(
                        st, spec, received[s], w, maxp, pend[s],
                        insert=insert, reduced=False, out=rows[s],
                        stats=stats, kg_range=ranges[s], begin=False)
                    if drain_stats:
                        ds[s][i, 0] = slices[s][4].sum(dtype=torch.int32)
                fires[s].append(fr)
                backlog.append(_to(fr.lane_valid[:F].sum(dtype=torch.int32)
                                   >= F, devs[0]))
        for s in range(L):
            if pend[s] is not None:
                with device_guard(devs[s]):
                    wk.apply_pending_purge(states[s], spec.win, spec.red,
                                           pend[s])
        pending = int(torch.stack(backlog).any()) if backlog else 0
        _, (gpending,) = plane.agree(maxs=[pending])
        stop = bool(gdone) and not gpending
        out = (states, [_stack_fires(f, arenas[s])
                        for s, f in enumerate(fires)], stop, count)
        return out + (ds,) if drain_stats else out

    drain.ring_depth = D
    drain.dcn_resident = True
    drain.recv_lanes = n * cap
    drain.bucket_cap = cap
    drain.drain_stats = drain_stats
    drain.plane = plane
    return drain


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


def build_rolling_step_sharded(ctx, spec: RollingStageSpec):
    """The rolling reduce over the mesh (the reference's
    ``build_rolling_step`` at n shards): each shard masks the batch to its
    key groups with G1 (``route_lanes`` over its range), runs the one-shard
    update on its state (G5, G10, G13; G16 and the user's combine for a
    generic reduce), and G27 sums the shards' masked outputs and ORs their
    valid lanes (``parallel/collectives.py psum``: K18's cross-shard
    half). ``step(states, hi, lo, values, valid)`` -> ``(states, outputs,
    out_valid)`` on the first shard's device."""
    maxp = ctx.max_parallelism
    ranges = _ranges(ctx)

    def step(states, hi, lo, values, valid):
        outs, oks = [], []
        for s, (k0, k1) in enumerate(ranges):
            dev = ctx.devices[s]
            with device_guard(dev):
                h, l, v, ok = (_to(t, dev) for t in (hi, lo, values, valid))
                mine = owned_lanes(h, l, ok, k0, k1, maxp)
                _st, out, out_ok = rolling.update(states[s], h, l, v, mine,
                                                  red=spec.red)
            outs.append(out)
            oks.append(out_ok)
        out, ok = psum(outs, oks, ctx.devices[0])
        return states, out, ok

    return step


def build_session_step_sharded(ctx, spec: SessionStageSpec):
    """Session windows over the mesh (the reference's ``build_session_step``
    at n shards): each shard masks the replicated batch to its key groups
    with G1 (``owned_lanes``) and runs the one-shard step on its state (G5,
    G10, G11). No psum: the shards own disjoint keys. ``step(states, hi,
    lo, ts, values, valid, wm)`` -> ``(states, fires)``, ``fires[s]`` shard
    s's ``(rows, n_rows, marks)``: G11's row buffers, their count and the
    counts where its superseded batch sessions and its closes begin, so
    that the caller emits every shard's superseded open sessions, then
    every shard's batch sessions, then every shard's closes, as the
    reference's host loop does."""
    maxp = ctx.max_parallelism
    ranges = _ranges(ctx)

    def step(states, hi, lo, ts, values, valid, wm):
        fires = []
        for s, (k0, k1) in enumerate(ranges):
            dev = ctx.devices[s]
            with device_guard(dev):
                h, l, t, v, ok, w = (_to(x, dev) for x in
                                     (hi, lo, ts, values, valid, wm))
                mine = owned_lanes(h, l, ok, k0, k1, maxp)
                marks = torch.zeros(2, dtype=torch.int32, device=dev)
                _st, rows, n_rows = sw.update_and_fire(
                    states[s], spec.gap_ticks, h, l, t, v, mine, w,
                    marks=marks)
            fires.append((rows, n_rows, marks))
        return states, fires

    return step


def build_count_step_sharded(ctx, spec: CountStageSpec):
    """Count windows over the mesh (the reference's ``build_count_step`` at
    n shards): each shard masks the replicated batch to its key groups with
    G1 and runs the one-shard step (G5, G10, G12). ``step(states, hi, lo,
    values, valid)`` -> ``(states, fires)``, ``fires[s]`` shard s's
    ``(rows, n_rows)``, emitted shard after shard."""
    maxp = ctx.max_parallelism
    ranges = _ranges(ctx)

    def step(states, hi, lo, values, valid):
        fires = []
        for s, (k0, k1) in enumerate(ranges):
            dev = ctx.devices[s]
            with device_guard(dev):
                h, l, v, ok = (_to(x, dev) for x in (hi, lo, values, valid))
                mine = owned_lanes(h, l, ok, k0, k1, maxp)
                _st, rows, n_rows = cw.update(states[s], spec.n_per_window,
                                              h, l, v, mine)
            fires.append((rows, n_rows))
        return states, fires

    return step
