"""Device CEP behind ``CEP.pattern()`` — the counterpart of
flink_tpu/cep/accel.py (``DeviceCepOperator``), on one shard or over a
shard mesh.

Division of labour, as in the reference:

  * DEVICE (``cep/device.py``): per micro-batch, the count NFA of every
    key advances (G20's within() expiry, G5, G10, G19) and reports, per
    lane, how many matches completed there (``delta``) — exact detection,
    no per-key host work;
  * HOST (here): per key, only the compacted stream of stage-matching
    events (the SharedBuffer analog) and a one-bit gap marker per stored
    event (were there non-matching events of this key in between?). When
    the card reports completions for a key, the host replays that key's
    pending events through the exact host NFA (``cep/nfa.py``, a copy of
    the reference's) to build the {stage: event} match dicts, in the
    reference's order: keys in ``np.unique`` order of their 64-bit ids.

within() runs on the card as pane-bucketed counts; the host replay sees
the same pane-quantised timestamps, and the first batch's pane is the
origin of the card's int32 pane arithmetic. ``snapshot()`` /
``restore()`` carry the reference's layout both ways (the table as uint32
[C, 2] rows), so either package continues from the other's state; a
restore adopts the reference's host NFA partials into the port's classes.

With ``n_shards`` above 1 (the reference's ``_init_sharded``) the count
NFA's state shards by key group over a ``MeshContext``: each shard holds
its keys' table and carry on its device, masks the replicated batch to the
key groups it owns with G1 (``parallel/exchange.py owned_lanes``) and runs
the one-shard advance (G20, G5, G10, G19) under its device's guard; the
shards' per-lane match deltas are disjoint, so G27's shard-order sum
(``parallel/collectives.py psum``, each shard's owner mask its valid
plane) reassembles the batch's delta exactly. The host side (buffers,
partials, replay) stays one for all shards, as in the reference; a
snapshot stacks the shards' leaves on a leading axis, the reference's
layout. Not ported: ``peek_state`` (queryable ``cep-nfa-state``, ROADMAP
queue 1, item 15), which raises. ``batch_gaps`` is a copy of the
reference's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.cep.device import (
    CepShardState, DevicePatternSpec, advance, init_state,
)
from flink_tpu_torch.cep.nfa import NFA, Entry, Partial
from flink_tpu_torch.cep.pattern import Pattern, RELAXED
from flink_tpu_torch.core.types import KeyCodec
from flink_tpu_torch.ops import hashtable
from flink_tpu_torch.parallel.collectives import psum
from flink_tpu_torch.parallel.exchange import owned_lanes
from flink_tpu_torch.parallel.mesh import (
    MeshContext, device_guard, mesh_devices,
)
from flink_tpu_torch.runtime.job import key_words


def batch_gaps(inv: np.ndarray, hit: np.ndarray,
               trailing_in: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-hit-lane gap bits for one micro-batch, vectorized.

    inv[B]        factorized key id per lane (0..G-1)
    hit[B]        lane matched >=1 stage predicate
    trailing_in[G] per key-group: non-matching events of this key were
                  seen after its last stored event (carried across batches)

    Returns (gap[B] — True at hit lanes whose key saw >=1 non-hit event
    since its previous hit event; False elsewhere — and trailing_out[G]).
    """
    B = len(inv)
    if B == 0:
        return np.zeros(0, bool), trailing_in.copy()
    perm = np.argsort(inv, kind="stable")     # group by key, arrival order
    inv_s = inv[perm]
    hit_s = hit[perm]
    idx = np.arange(B)

    is_new = np.r_[True, inv_s[1:] != inv_s[:-1]]
    grp_id = np.cumsum(is_new) - 1            # dense group ids, sorted order
    grp_start = np.nonzero(is_new)[0]
    grp_key = inv_s[grp_start]                # group -> key factor id

    nh_before = np.cumsum(~hit_s) - (~hit_s)  # non-hits strictly before lane
    nhw = nh_before - nh_before[grp_start][grp_id]   # ...within the group

    ph = np.maximum.accumulate(np.where(hit_s, idx, -1))
    prev_hit = np.r_[-1, ph[:-1]]             # last hit at or before lane-1
    has_prev = prev_hit >= grp_start[grp_id]  # ...within the same group
    prev_nhw = np.where(has_prev, nhw[np.clip(prev_hit, 0, B - 1)], 0)

    tin_s = trailing_in[grp_key][grp_id]      # per-lane carried trailing bit
    gap_s = np.where(
        has_prev, (nhw - prev_nhw) > 0, (nhw > 0) | tin_s
    ) & hit_s

    # carry-out per key: non-hits after the key's last hit in this batch
    # (whole batch counts if the key had no hit — OR with the carried bit)
    grp_end = np.r_[grp_start[1:], B] - 1
    nh_total = nhw[grp_end] + (~hit_s[grp_end])
    last_hit = ph[grp_end]
    had_hit = last_hit >= grp_start
    nh_after = np.where(
        had_hit,
        nh_total - (nhw[np.clip(last_hit, 0, B - 1)]
                    + 0),                     # last_hit lane is a hit
        nh_total,
    )
    trailing_out = trailing_in.copy()
    trailing_out[grp_key] = np.where(
        had_hit, nh_after > 0, trailing_in[grp_key] | (nh_total > 0)
    )

    gap = np.zeros(B, bool)
    gap[perm] = gap_s
    return gap, trailing_out


def _unsupported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to flink_tpu_torch yet ({item})")


def _adopt_entry(e, memo: Dict[int, Entry]):
    """An Entry of another package's NFA (same fields) as this package's,
    shared entries staying shared."""
    if e is None or isinstance(e, Entry):
        return e
    got = memo.get(id(e))
    if got is None:
        got = memo[id(e)] = Entry(e.event)
        got.edges = [(_adopt_entry(pred, memo), v) for pred, v in e.edges]
    return got


def adopt_partials(partials: list, memo: Dict[int, Entry]) -> list:
    """A key's live partials from a snapshot of either package as this
    package's ``Partial`` objects (legacy event-tuple partials pass through:
    the NFA upgrades them itself)."""
    out = []
    for p in partials:
        if isinstance(p, Partial) or hasattr(p, "events"):
            out.append(p)
        else:
            out.append(Partial(p.stage_idx, _adopt_entry(p.ptr, memo),
                               p.version, p.start_ts))
    return out


def advance_shards(ctx: MeshContext, states: List[CepShardState],
                   spec: DevicePatternSpec, hi, lo, masks, valid,
                   pane: int = 0):
    """One replicated batch through each of this process's shards: G1's
    owner mask over the shard's key groups (``owned_lanes``), then the
    one-shard advance (G5, G10, G19; G20 with within()) on ``states[s]``,
    in place, under the shard's device guard. Returns each shard's
    (delta float32 [B], owned lanes bool [B]) on its device; the deltas
    are zero off the owned lanes."""
    out = []
    for s, (dev, r) in enumerate(zip(ctx.devices,
                                     ctx.local_key_group_ranges)):
        with device_guard(dev):
            h, l, m, ok = (t.to(dev, non_blocking=True)
                           for t in (hi, lo, masks, valid))
            mine = owned_lanes(h, l, ok, r.start, r.end,
                               ctx.max_parallelism)
            states[s], delta, _tot = advance(states[s], spec, h, l, m,
                                             mine, pane)
        out.append((delta, mine))
    return out


class DeviceCepOperator:
    """Keyed CEP over micro-batches: the card's count NFA detects, the host
    replays the flagged keys to extract. One instance per job; ``n_shards``
    count-NFA states, one a shard of ``mesh_devices(device)`` (``capacity``
    is per shard, as ``env.state_capacity_per_shard``)."""

    def __init__(self, pattern: Pattern, capacity: int = 1 << 16,
                 probe_len: int = hashtable.KEYED_PROBE_LEN,
                 within_buckets: int = 8, n_shards: int = 1,
                 max_parallelism: int = 128, device="cuda"):
        self.pattern = pattern
        self.spec = DevicePatternSpec.from_pattern(
            pattern, within_buckets=within_buckets)
        self.nfa = NFA(pattern)
        self.stages = pattern.stages
        self.codec = KeyCodec()
        self.capacity = 1 << max(1, int(capacity) - 1).bit_length()
        self.n_shards = int(n_shards)
        self.max_parallelism = max_parallelism
        self.device = torch.device(device)
        self.probe_len = probe_len
        self.ctx = MeshContext.create(self.n_shards, max_parallelism,
                                      devices=mesh_devices(self.device))
        self.states: List[CepShardState] = [
            init_state(self.capacity, probe_len, self.spec, d)
            for d in self.ctx.devices]
        # per-key host side, keyed by the 64-bit key identity; the events
        # themselves carry the original keys for extraction
        self.buffers: Dict[int, List[Tuple[Any, bool, int]]] = {}
        self.partials: Dict[int, list] = {}
        self.trailing: Dict[int, bool] = {}
        # the card's count and the host's extraction must agree
        self.matches_detected = 0
        self.matches_extracted = 0
        self.steps = 0
        # within(): panes rebase to the first batch's pane so epoch-ms
        # timestamps fit the card's int32 pane arithmetic
        self._pane_origin: Optional[int] = None

    @property
    def state(self) -> CepShardState:
        """The first shard's state (the only one with one shard)."""
        return self.states[0]

    @state.setter
    def state(self, st: CepShardState) -> None:
        self.states[0] = st

    @property
    def dropped_capacity(self) -> int:
        """Records that found no slot, summed over the shards."""
        return sum(int(st.dropped_capacity) for st in self.states)

    def _advance_sharded(self, hi, lo, masks, valid, pane: int):
        """One batch through every shard (the reference's sharded step):
        ``advance_shards``, then G27's sum of the shards' deltas, each
        masked to its owned lanes. Returns the delta float32 [B] on the
        first shard's device."""
        deltas, mines = zip(*advance_shards(self.ctx, self.states,
                                            self.spec, hi, lo, masks, valid,
                                            pane))
        delta, _ok = psum(list(deltas), list(mines), self.ctx.devices[0])
        return delta

    def _masks(self, elements: Sequence) -> np.ndarray:
        m = np.zeros((len(elements), len(self.stages)), bool)
        for j, st in enumerate(self.stages):
            # where_batch predicates run once per batch; scalar ones per
            # event
            m[:, j] = st.matches_batch(elements)
        return m

    def process_batch(self, elements: Sequence, keys: Sequence,
                      ts: int) -> List[dict]:
        """Advance by one micro-batch (arrival order) whose within() pane
        is the pane of ``ts``; returns the completed match dicts
        {stage_name: event}."""
        B = len(elements)
        if B == 0:
            return []
        # the host replay sees the card's pane-quantised timestamps, or its
        # exact within() check could disagree with the card's counts
        pane = 0
        if self.spec.pane_ms:
            pane = int(ts) // self.spec.pane_ms
            ts = pane * self.spec.pane_ms
            if self._pane_origin is None:
                self._pane_origin = pane
            pane -= self._pane_origin
        masks = self._masks(elements)
        hi, lo = self.codec.encode(list(keys), keep_reverse=False)
        k64 = key_words(hi, lo)
        dev = self.device
        lanes = [torch.from_numpy(np.ascontiguousarray(a)).to(
            dev, non_blocking=True)
            for a in (hi.view(np.int32), lo.view(np.int32), masks)]
        valid = torch.ones(B, dtype=torch.bool, device=dev)
        if self.n_shards == 1:
            self.state, delta, _total = advance(self.state, self.spec,
                                                *lanes, valid, pane)
        else:
            delta = self._advance_sharded(*lanes, valid, pane)
        delta = delta.cpu().numpy()
        self.steps += 1

        # host compaction: the hit events (and their gap bits) per key
        hit = masks.any(axis=1)
        uniq, inv = np.unique(k64, return_inverse=True)
        uniq_l = uniq.tolist()
        get = self.trailing.get
        tin = np.fromiter((get(u, False) for u in uniq_l), bool,
                          count=len(uniq_l))
        gap, tout = batch_gaps(inv, hit, tin)
        self.trailing.update(zip(uniq_l, tout.tolist()))
        hit_idx = np.nonzero(hit)[0]
        buffers = self.buffers
        for i, k, g in zip(hit_idx.tolist(), k64[hit_idx].tolist(),
                           gap[hit_idx].tolist()):
            buf = buffers.get(k)
            if buf is None:
                buf = buffers[k] = []
            buf.append((elements[i], g, ts))

        # extraction: replay only the keys the card flagged
        out: List[dict] = []
        done = np.nonzero(delta > 0)[0]
        if len(done):
            self.matches_detected += int(round(float(delta[done].sum())))
            for u in np.unique(k64[done]).tolist():
                out.extend(self._replay(u))
        self.matches_extracted += len(out)
        return out

    # -- state carry -----------------------------------------------------
    def snapshot(self) -> dict:
        """The reference's snapshot layout: the card's state as host arrays
        under the reference's leaf names (``table.keys`` uint32 [C, 2],
        ``carry`` float32 [C+1, D], ``pane_ids`` int32 [Q],
        ``dropped_capacity``; with n shards each stacked on a leading [n]
        axis, as the reference stacks its sharded state), the host dicts,
        the counters and the bucketing parameters. The barrier is the step
        boundary."""
        def leaves(st):
            return {
                "table.keys": hashtable.to_rows(st.table),
                # copies: on the CPU a tensor's numpy view is its memory
                "carry": np.array(st.carry.cpu()),
                "pane_ids": np.array(st.pane_ids),
                "dropped_capacity": np.asarray(int(st.dropped_capacity),
                                               np.int32),
            }

        per = [leaves(st) for st in self.states]
        device = per[0] if self.n_shards == 1 else {
            k: np.stack([p[k] for p in per]) for k in per[0]}
        return {
            "device": device,
            # the live buffers grow in place: the snapshot keeps copies
            "buffers": {k: list(v) for k, v in self.buffers.items()},
            "partials": dict(self.partials),
            "trailing": dict(self.trailing),
            "matches_detected": self.matches_detected,
            "matches_extracted": self.matches_extracted,
            "steps": self.steps,
            "capacity": self.capacity,
            "pane_origin": self._pane_origin,
            "pane_ms": self.spec.pane_ms,
            "within_panes": self.spec.within_panes,
            "n_shards": self.n_shards,
            "max_parallelism": self.max_parallelism,
        }

    def restore(self, snap: dict):
        """Continue from a snapshot of either package, validated as the
        reference validates it. ``snap["device"]`` is this package's dict
        of leaves or the reference's ``CepShardState`` of numpy leaves."""
        if snap["capacity"] != self.capacity:
            raise ValueError(
                f"device CEP capacity mismatch: snapshot {snap['capacity']} "
                f"vs configured {self.capacity}")
        if snap.get("n_shards", 1) != self.n_shards:
            raise ValueError(
                f"device CEP shard-count mismatch: snapshot has "
                f"{snap.get('n_shards', 1)} shard(s), job configured for "
                f"{self.n_shards} — restore with the same parallelism")
        snap_maxp = snap.get("max_parallelism", self.max_parallelism)
        if snap_maxp != self.max_parallelism:
            raise ValueError(
                f"device CEP max-parallelism mismatch: snapshot "
                f"{snap_maxp} vs configured {self.max_parallelism}")
        snap_pane = (snap.get("pane_ms", self.spec.pane_ms),
                     snap.get("within_panes", self.spec.within_panes))
        if snap_pane != (self.spec.pane_ms, self.spec.within_panes):
            raise ValueError(
                f"device CEP within() bucketing mismatch: snapshot used "
                f"pane_ms={snap_pane[0]}, ring={snap_pane[1]} but the job "
                f"is configured for pane_ms={self.spec.pane_ms}, ring="
                f"{self.spec.within_panes} — restore with the same "
                f"cep.device.within-buckets setting")
        d = snap["device"]
        if isinstance(d, dict):
            rows, carry = d["table.keys"], d["carry"]
            pane_ids, dropped = d["pane_ids"], d["dropped_capacity"]
        else:
            rows, carry = d.table.keys, d.carry
            pane_ids, dropped = d.pane_ids, d.dropped_capacity
        carry = np.array(carry, np.float32)
        want = (self.capacity + 1, self.spec.dim)
        n = self.n_shards
        if n > 1:
            want = (n,) + want
        if carry.shape != want:
            raise ValueError(f"device CEP carry of shape {carry.shape}, the "
                             f"job's is {want}")
        rows, pane_ids = np.asarray(rows), np.asarray(pane_ids, np.int32)
        dropped = np.asarray(dropped).reshape(n, -1)
        if n == 1:
            rows, carry, pane_ids = rows[None], carry[None], pane_ids[None]
        self.states = [CepShardState(
            table=hashtable.from_rows(rows[s], dev),
            carry=torch.from_numpy(carry[s]).to(dev),
            pane_ids=torch.from_numpy(np.array(pane_ids[s], np.int32)),
            dropped_capacity=torch.tensor(int(dropped[s].sum()),
                                          dtype=torch.int32, device=dev),
            probe_len=self.probe_len,
        ) for s, dev in enumerate(self.ctx.devices)]
        memo: Dict[int, Entry] = {}
        self.buffers = {k: list(v) for k, v in snap["buffers"].items()}
        self.partials = {k: adopt_partials(v, memo)
                         for k, v in snap["partials"].items()}
        self.trailing = dict(snap["trailing"])
        self.matches_detected = snap["matches_detected"]
        self.matches_extracted = snap["matches_extracted"]
        self.steps = snap["steps"]
        self._pane_origin = snap.get("pane_origin")

    def peek_state(self, key):
        raise _unsupported("queryable CEP state (cep-nfa-state)",
                           "ROADMAP queue 1, item 15")

    # -- replay ------------------------------------------------------------
    def _advance_partials(self, partials: list,
                          buf: Sequence) -> Tuple[list, List[dict]]:
        """The replay loop: gap bits kill partials waiting on a STRICT
        stage, then the exact host NFA advances."""
        matches: List[dict] = []
        for ev, gap_before, ts in buf:
            if gap_before and partials:
                partials = [
                    p for p in partials
                    if self.stages[p.stage_idx + 1].contiguity == RELAXED
                ]
            partials, ms = self.nfa.process(partials, ev, ts)
            matches.extend(ms)
        return partials, matches

    def _replay(self, k: int) -> List[dict]:
        partials, matches = self._advance_partials(
            self.partials.get(k, []), self.buffers.pop(k, []))
        self.partials[k] = partials
        return matches

    def prune_dead_keys(self) -> List[dict]:
        """Bound host memory to the live partials (the SharedBuffer pruning
        analog, as the reference's): pending buffers of unflagged keys hold
        no completion, so they drain into each key's partials; keys that
        never won a slot lose their state. Returns any matches found while
        draining (expected none; the runner emits them). One read of each
        shard's whole table from its card."""
        if not (self.buffers or self.partials or self.trailing):
            return []
        in_table = set()
        for st in self.states:
            tk = hashtable.to_rows(st.table)
            occ = ~np.all(tk == hashtable.EMPTY, axis=1)
            in_table.update(key_words(tk[occ, 0], tk[occ, 1]).tolist())

        unexpected: List[dict] = []
        for k in list(self.buffers):
            if k not in in_table:
                del self.buffers[k]
                continue
            partials, ms = self._advance_partials(
                self.partials.get(k, []), self.buffers.pop(k))
            unexpected.extend(ms)
            if partials:
                self.partials[k] = partials
            else:
                self.partials.pop(k, None)
        for k in [k for k in self.partials
                  if not self.partials[k] or k not in in_table]:
            del self.partials[k]
        for k in [k for k in self.trailing if k not in self.partials]:
            del self.trailing[k]
        self.matches_extracted += len(unexpected)
        return unexpected
