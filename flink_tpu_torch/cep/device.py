"""Device CEP: the NFA as a count vector advanced by a segmented scan — the
counterpart of flink_tpu/cep/device.py (kernel K20).

Each key keeps a float32 state vector ``v = [c_{0,0} .. c_{S-2,Q-1}, M,
1]``: ``c_{s,q}`` counts its live partial matches whose last matched stage
is s and whose first event fell in within() ring pane q, ``M`` the matches
completed in this batch, and the constant 1 lets "start a partial" be
linear. An event is the sparse linear map T(e) of the reference's
``event_matrices`` (reproduced as ``event_matrices_plain``), and a key's
events in arrival order are the product of their maps. ``advance`` runs a
micro-batch on the card as:

  1. the within() ring rotation: the batch's pane decides, on the host,
     which ring slots went stale since the last batch; G20 ``cep_expire``
     zeroes their bucket columns of every carry row, and is launched only
     when some slot went stale (the reference's ``jnp.where`` every batch
     gives the same carry). ``pane_ids`` therefore lives on the host;
  2. G5 ``hash_upsert``: each lane's key to its slot, on chains of 16 as
     the reference's ``upsert(max_rounds=8)`` (G5 places every key whose
     chain has room; a key with no slot is counted in
     ``dropped_capacity`` and its lanes are the identity);
  3. G10 ``segment_sort``: lanes stably by slot, dead lanes last;
  4. G19 ``cep_scan``: each key's transitions applied in lane order to its
     carried vector (no [B, D, D] tensor on the card), each lane's match
     delta in the original lane order, the new carry of each key with M
     reset to 0, and row C (the dead lanes' row) the neutral vector.

Counts are float32 as in the reference: deltas and carry equal the
reference's bit for bit while every count stays below 2^24, and saturate
at INT_MAX above it. ``advance_plain`` is the reference's own structure in
plain PyTorch — ``jnp.where`` rotation, upsert, ``argsort(stable=True)``,
T materialised as [B, D, D] and a log-step segmented matrix product
(``ops/cuda.py`` ``cep_scan_plain``); the tests hold both against the
reference, and on the card the main path never calls it. G19 and G20 take
D up to ``ops/cuda.py CEP_MAX_DIM`` (128) and raise above it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.cep.pattern import RELAXED, Pattern
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import hashtable, segment

INT_MAX = np.float32(kernels.CEP_INT_MAX)
PANE_NONE = np.int32(-(2**31) + 1)


@dataclass(frozen=True)
class DevicePatternSpec:
    """Static spec of a linear pattern for the device NFA (the reference's,
    field for field): ``relaxed[s]`` is stage s's contiguity; within()
    buckets each stage's counts by the start pane over a ring of ``Q`` =
    ``within_panes`` panes of ``pane_ms`` each (Q == 1 without within)."""

    n_stages: int
    relaxed: Tuple[bool, ...]
    within_panes: int = 1
    pane_ms: int = 0

    @staticmethod
    def from_pattern(p: Pattern,
                     within_buckets: int = 8) -> "DevicePatternSpec":
        S = len(p.stages)
        Q, pane_ms = 1, 0
        # a single stage completes on its first event: within() never
        # prunes it, so it keeps the flat representation
        if p.within_ms is not None and S > 1:
            pane_ms = max(1, -(-p.within_ms // max(1, within_buckets)))
            Q = p.within_ms // pane_ms + 1
        return DevicePatternSpec(
            n_stages=S,
            relaxed=tuple(s.contiguity == RELAXED for s in p.stages),
            within_panes=Q,
            pane_ms=pane_ms,
        )

    @property
    def dim(self) -> int:
        return (self.n_stages - 1) * self.within_panes + 2


@dataclass
class CepShardState:
    """The reference's ``CepShardState`` as a plain dataclass: ``table``
    one int64 key word per slot (``ops/hashtable.py``), ``carry`` float32
    [C+1, D] on the device (row C the dead lanes' neutral row),
    ``pane_ids`` int32 [Q] on the host (the absolute pane in each ring
    slot), ``dropped_capacity`` int32 0-d on the device. ``probe_len`` is
    the table's chain length."""

    table: torch.Tensor
    carry: torch.Tensor
    pane_ids: torch.Tensor
    dropped_capacity: torch.Tensor
    probe_len: int = hashtable.KEYED_PROBE_LEN

    @property
    def capacity(self) -> int:
        return self.table.shape[0]


def init_state(capacity: int, probe_len: int, spec: DevicePatternSpec,
               device="cuda") -> CepShardState:
    dev = torch.device(device)
    D = spec.dim
    carry = torch.zeros(capacity + 1, D, dtype=torch.float32, device=dev)
    carry[:, D - 1] = 1.0       # the homogeneous 1 of every key's vector
    return CepShardState(
        table=hashtable.create(capacity, dev),
        carry=carry,
        pane_ids=torch.full((spec.within_panes,), int(PANE_NONE),
                            dtype=torch.int32),
        dropped_capacity=torch.zeros((), dtype=torch.int32, device=dev),
        probe_len=probe_len,
    )


def _rotation(state: CepShardState, spec: DevicePatternSpec, pane: int):
    """The within() ring's new pane ids, stale slots and this batch's slot
    (the reference's int32 arithmetic, on host ints)."""
    Q = spec.within_panes
    p_r = [pane - (pane - r) % Q for r in range(Q)]
    stale = [a != b for a, b in zip(p_r, state.pane_ids.tolist())]
    return p_r, stale, pane % Q


def advance(state: CepShardState, spec: DevicePatternSpec, hi, lo, masks,
            valid, pane: int = 0):
    """Advance every key's NFA by one micro-batch, the state in place.
    hi/lo int32 [B] (the key identity's uint32 halves), masks bool [B, S],
    valid bool [B], ``pane`` this batch's pane (0 without within()).
    Returns (state, delta float32 [B] — the matches completed at each lane,
    in lane order — and their sum)."""
    C = state.capacity
    Q = spec.within_panes
    q_t = 0
    if Q > 1:
        p_r, stale, q_t = _rotation(state, spec, int(pane))
        if any(stale):
            kernels.cep_expire(state.carry, stale, S=spec.n_stages, Q=Q)
        state.pane_ids = torch.tensor(p_r, dtype=torch.int32)
    slot, ok, _ = hashtable.upsert_counted(state.table, hi, lo, valid,
                                           probe_len=state.probe_len)
    state.dropped_capacity += (valid & ~ok).sum(dtype=torch.int32)
    order, key_s, seg_start = segment.sort_slots(slot, valid & ok, C)
    delta = kernels.cep_scan(order, key_s, seg_start, masks, state.carry,
                             relaxed=spec.relaxed, Q=Q, q_t=q_t)
    return state, delta, delta.sum()


def event_matrices_plain(spec: DevicePatternSpec, masks,
                         q_t: int = 0) -> torch.Tensor:
    """The reference's ``event_matrices``: bool [B, S] -> float32 [B, D,
    D]."""
    live = torch.ones(masks.shape[0], dtype=torch.bool, device=masks.device)
    return kernels.cep_transitions_plain(masks, live, spec.relaxed,
                                         spec.within_panes, q_t)


def advance_plain(state: CepShardState, spec: DevicePatternSpec, hi, lo,
                  masks, valid, pane: int = 0):
    """``advance`` as the reference computes it, in plain PyTorch: the
    rotation as a ``where`` over every carry column, the upsert's plain
    version, a stable ``argsort`` of the slots, and G19's plain version
    (the [B, D, D] matrices and their log-step segmented product). Same
    arguments and results as ``advance``."""
    C = state.capacity
    Q = spec.within_panes
    q_t = 0
    if Q > 1:
        p_r, stale, q_t = _rotation(state, spec, int(pane))
        kernels.cep_expire_plain(state.carry, stale, S=spec.n_stages, Q=Q)
        state.pane_ids = torch.tensor(p_r, dtype=torch.int32)
    slot, ok, _ = kernels.hash_upsert_plain(state.table, hi, lo, valid,
                                            probe_len=state.probe_len)
    state.dropped_capacity += (valid & ~ok).sum(dtype=torch.int32)
    seg = torch.where(valid & ok, slot.to(torch.int64), C)
    order = torch.argsort(seg, stable=True)
    key_s = seg[order]
    seg_start = torch.ones_like(valid)
    seg_start[1:] = key_s[1:] != key_s[:-1]
    delta = kernels.cep_scan_plain(order.to(torch.int32), key_s, seg_start,
                                   masks, state.carry, relaxed=spec.relaxed,
                                   Q=Q, q_t=q_t)
    return state, delta, delta.sum()


def host_masks(pattern: Pattern, events: Sequence) -> np.ndarray:
    """Each stage's scalar predicate over a list of host events ->
    bool [B, S] (the reference's bridge for object-event tests)."""
    out = np.zeros((len(events), len(pattern.stages)), bool)
    for j, st in enumerate(pattern.stages):
        out[:, j] = [bool(st.matches(e)) for e in events]
    return out
