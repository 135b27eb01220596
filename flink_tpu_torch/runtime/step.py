"""Stage steps on one device — the window stage (the split path's update
and fire steps, the K-step megasteps, the resident scan drain and
while-drain, and the chained drain of consecutive window stages), the
session, count-window and rolling stages of flink_tpu/runtime/step.py.

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

from dataclasses import dataclass
from typing import Sequence, Tuple

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
              reduced: bool = True, out=None, stats=None):
    """One slot of the drains and one sub-step of the fused-fire megastep
    (the reference shares ``mask_update_shard`` and
    ``advance_and_fire_resident`` between them): the update with the
    previous slot's deferred purge ``pend`` folded into its ring-reset
    sweep (G1-G3; G5 or G8; G7), the watermark advanced to ``wm``, then
    the resident advance and fire (G4 reduced, else G6 into ``out``, the
    slot's [Ft, C] row buffers), its purge deferred. ``fill_out`` takes
    the slot's key-group fill (``kg_fill``). ``stats``, the flight
    recorder's ``(row, lane_stats, snap, defer)`` for this slot, brackets
    the slot with G18's companion and G18. Returns ``(state, pend, fires,
    activity, fill)``: ``fill`` the overflow ring's fill after the
    update, int32 0-d."""
    hi, lo, ts, values, valid = slot
    if stats is not None:
        row, lane_stats, snap, defer = stats
        kernels.slot_stats_begin(state.watermark, state.dropped_late,
                                 state.dropped_capacity, snap)
    _st, act, _kgf = mask_update_shard(
        state, spec, 0, max_parallelism - 1, hi, lo, ts, values, valid, wm,
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
                                defer_fires: bool = False):
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
    between drains, and the drain is not rebuilt."""
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
                       if drain_stats else None))
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
                             drain_stats: bool = False, arena=None):
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
                       if drain_stats else None))
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
                          kg_fill: bool = False, tiered: bool = False):
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
    kg_end = max_parallelism - 1

    def megastep(state: wk.WindowShardState, slots: Sequence[Slot], wmv,
                 kg_res=None):
        _check_megastep_call(K, slots, wmv, tiered, kg_res)
        i32 = dict(dtype=torch.int32, device=state.device)
        activity = torch.zeros((), **i32)
        kgf = torch.zeros(max_parallelism if kg_fill else 0, **i32)
        for i in range(K):
            hi, lo, ts, values, valid = slots[i]
            _st, act, _kgf = mask_update_shard(
                state, spec, 0, kg_end, hi, lo, ts, values, valid, wmv[i],
                max_parallelism, insert=insert, kg_fill=kg_fill,
                fill_out=kgf if kg_fill else None, kg_res=kg_res)
            activity += act
        return state, (state.ovf_n.clone(), activity, kgf)

    megastep.fused_fire = False
    return megastep


def build_window_megastep_fired(spec: WindowStageSpec, k_steps: int,
                                max_parallelism: int, insert: bool = True,
                                kg_fill: bool = False, reduced: bool = False,
                                tiered: bool = False, arena=None):
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
                out=None if rows is None else tuple(r[i] for r in rows))
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
                        drain_stats: bool = False, lanes_out=None):
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
    list, receives each stage's fire ``lane_valid``."""
    out, recs = [], []
    up_state, up_fires, wm_up = st0, cf_stack, wm_last
    kg_end = max_parallelism - 1
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
        mask_update_shard(st_j, sp, 0, kg_end, edge.hi, edge.lo, edge.ts,
                          edge.vals, edge.ok, edge.wm, max_parallelism)
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
                               drain_stats: bool = False):
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
    may remain for a flush."""
    specs = tuple(specs)
    D = int(depth)
    stage0 = build_window_resident_drain(
        specs[0], D, max_parallelism, reduced=False,
        kg_fill=kg_fill, drain_stats=drain_stats, defer_fires=True)
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
                                   drain_stats=drain_stats, lanes_out=lanes)
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
                             insert: bool = True, kg_fill: bool = False):
    """The split path's update-only step (the reference's
    ``build_window_update_step`` at one shard): apply one staged batch
    and advance the watermark, fire nothing. ``insert=False`` is the
    lookup-only fast variant (G8). ``step(state, hi, lo, ts, values,
    valid, wm[, kg_res])`` -> ``(state, (ovf_n, activity, kg_fill))``,
    all on the device: the overflow ring's fill after the update, the
    update's activity and the batch's lanes per key group ([0] with the
    fill off). ``kg_res`` (tiered state) diverts the cold groups' lanes.
    The state is updated in place; nothing is read back."""
    kg_end = max_parallelism - 1

    def update_step(state, hi, lo, ts, values, valid, wm, kg_res=None):
        state, activity, kgf = mask_update_shard(
            state, spec, 0, kg_end, hi, lo, ts, values, valid, wm,
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
