"""Window stage steps on one device — the main-path subset of
flink_tpu/runtime/step.py.

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

from flink_tpu_torch.ops import window_kernels as wk


@dataclass
class WindowStageSpec:
    """Static config of one keyed-window pipeline stage: the reference's
    fields for the direct-index layout with packed planes. The port has
    one update path, whose state equals the reference's with pre-combine
    on and off, so there is no pre-combine field."""

    win: wk.WindowSpec
    red: wk.ReduceSpec
    capacity_per_shard: int = 1 << 16


def init_shard_state(spec: WindowStageSpec, max_parallelism: int,
                     device) -> wk.WindowShardState:
    """One shard's state, with changelog bits sized to the key-group space
    (the reference's ``init_sharded_state`` for a one-device mesh)."""
    return wk.init_state(spec.capacity_per_shard, spec.win, spec.red,
                         n_key_groups=max_parallelism, device=device)


def mask_update_shard(state: wk.WindowShardState, spec: WindowStageSpec,
                      kg_start: int, kg_end: int, hi, lo, ts, values, valid,
                      wm, maxp: int, clear_rows=None) -> wk.WindowShardState:
    """Per-shard body of the mask route: hash to key groups, mask to the
    owned groups, apply the window update (all fused into G1-G3), then
    advance the shard watermark to ``wm`` (int32 0-d) — in place."""
    wk.update(state, spec.win, spec.red, hi, lo, ts, values, valid,
              maxp=maxp, kg_start=kg_start, kg_end=kg_end,
              clear_rows=clear_rows)
    torch.maximum(state.watermark, wm, out=state.watermark)      # in place
    return state


Slot = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
             torch.Tensor]


def _stack_fires(fires: Sequence[wk.ReducedFires]) -> wk.ReducedFires:
    return wk.ReducedFires(
        torch.stack([f.counts for f in fires]),
        torch.stack([f.window_end_ticks for f in fires]),
        torch.stack([f.n_fires for f in fires]),
        torch.stack([f.lane_valid for f in fires]),
        torch.stack([f.value_sums for f in fires]),
    )


def _skip_fires(F: int, device) -> wk.ReducedFires:
    """The reference's zero payload of a slot past ``count``."""
    zi = torch.zeros(F, dtype=torch.int32, device=device)
    return wk.ReducedFires(
        zi, zi, torch.zeros((), dtype=torch.int32, device=device),
        torch.zeros(F, dtype=torch.bool, device=device),
        torch.zeros(F, dtype=torch.float32, device=device),
    )


def build_window_resident_drain(spec: WindowStageSpec, depth: int,
                                max_parallelism: int):
    """Device-resident ring drain for one device (the reference's
    ``build_window_resident_drain`` at one shard, ``reduced=True``).

    ``drain(state, slots, wmv, count)``: ``slots`` is a sequence of
    ``depth`` staged batches ``(hi, lo, ticks, values, valid)`` (int32,
    int32, int32, float32, bool; [B] each), ``wmv`` an int32 [depth]
    device tensor of per-slot watermarks, ``count`` the number of live
    slots (a host int: the executor knows how many it staged). For each
    live slot it runs the update with the previous slot's deferred purge
    folded into the ring-reset sweep, advances the watermark and fires
    up to F window-ends reduced on the device; slots past ``count`` are
    skipped and yield zero fires. The last deferred purge is applied at
    the end. Returns ``(state, fires)`` with ``fires`` a ReducedFires
    stacked [depth, F]; the state is updated in place. Nothing is read
    back to the host."""
    D = int(depth)
    kg_end = max_parallelism - 1

    def drain(state: wk.WindowShardState, slots: Sequence[Slot], wmv,
              count: int):
        if len(slots) < count or count > D:
            raise ValueError(f"{count} live slots for a depth-{D} drain "
                             f"with {len(slots)} staged")
        pend = None
        fires = []
        for i in range(count):
            hi, lo, ts, values, valid = slots[i]
            wm = wmv[i]
            mask_update_shard(state, spec, 0, kg_end, hi, lo, ts, values,
                              valid, wm, max_parallelism, clear_rows=pend)
            state, pend, fr = wk.advance_and_fire_resident(
                state, spec.win, spec.red, wm)
            fires.append(fr)
        skip = _skip_fires(spec.win.fires_per_step, state.device)
        fires += [skip] * (D - count)
        if pend is not None:
            wk.apply_pending_purge(state, spec.win, spec.red, pend)
        return state, _stack_fires(fires)

    return drain


def fire_only(state: wk.WindowShardState, spec: WindowStageSpec, wm):
    """Advance the watermark to ``wm`` with no batch: fire up to F due
    window-ends and purge at once (the split fire step of the reference,
    ``advance_and_fire`` + ``reduce_fires``, at allowed lateness 0)."""
    state, pend, fires = wk.advance_and_fire_resident(
        state, spec.win, spec.red, wm)
    wk.apply_pending_purge(state, spec.win, spec.red, pend)
    return state, fires
