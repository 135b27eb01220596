"""Keyed window aggregation on one shard, in PyTorch — the main-path subset
of flink_tpu/ops/window_kernels.py.

The model is the reference's: time is cut into aligned panes of ``slide``
ticks, a window of ``size = k * slide`` is the combine of k consecutive
panes, and each shard keeps accumulators for ALL its keys across a ring of
R recent panes. Two state layouts, as in the reference: ``direct`` (key ==
slot, for bounded non-negative integer keys) and ``hash`` (an
open-addressing table, ``ops/hashtable.py``, for any 64-bit key identity).
The planes of a sum or count are packed: ``acc`` is one flat pane-major
float32 plane ``[C*R, 2]`` whose second column is the touch marker
(neutral 0 == untouched), exactly the reference's packed layout. A sketch
reduce (Count-Min, HyperLogLog: ``ops/sketches.py``) keeps the
reference's split planes: ``acc`` int32 ``[C*R, W]`` registers,
pane-major, beside a ``touched`` bool plane ``[C*R]`` (``packed = -1``).
Either carries across (``state_from_numpy`` / ``state_to_numpy``). The
table holds one int64 key word ``(hi << 32) | lo`` per slot; the
reference's uint32 ``[C, 2]`` rows appear only at carry-over.

Records whose key finds no slot (a key past capacity in the direct layout,
a full probe chain or an absent key in the hash layout's lookup-only fast
update) go to the overflow ring (``ovf_*``, ``WindowSpec.overflow`` lanes)
when the spec has one; the executor drains it into its host spill stores
and compacts the table (``compact_table``), as the reference does.

The O(B) and O(C) work runs in the kernels of ``ops/cuda.py``: G1-G9,
and for a sketch G14 (the register scatter) and G15 (the fire's pane
combine, finalize and compaction) in place of G3, G4 and G6. The
per-batch scalar bookkeeping — pane-ring registration, the fire plan,
the purge plan, watermark / fired_through / purged_through —
stays on the device as small torch ops on 0-d, [R] and [F] tensors, so a
drain never waits for the host between slots. State tensors are updated in
place where the reference donated its buffers to XLA; every such update is
marked "in place" below.

Not ported yet (ROADMAP queues 1-2): allowed lateness and its re-fires,
the key-group counts (K11), min/max and generic reduces, vector values
other than a sketch's, and the slot-major accumulator layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import hashtable
from flink_tpu_torch.ops.cuda import INT32_MAX, PANE_NONE

INT32_MIN = -(2**31)


@dataclass(frozen=True)
class ReduceSpec:
    """How window contents aggregate: the builtin ``sum`` and ``count``
    (ref ReduceFunction under ReducingStateDescriptor), or a ``sketch``
    (``ops/sketches.py``) whose int32 register vector of ``value_shape``
    is the accumulator: records expand into it and panes compose
    elementwise by the sketch's op. ``finalize`` turns a window's
    combined registers into its ``result_shape`` / ``result_dtype`` value
    at fire time (the reference's window-function result extraction).
    Every kind has the neutral 0, also the packed plane's untouched
    marker."""

    kind: str = "sum"
    dtype: Any = torch.float32
    value_shape: Tuple[int, ...] = ()
    sketch: Any = None
    finalize: Optional[Callable] = None
    result_shape: Optional[Tuple[int, ...]] = None
    result_dtype: Any = None

    def __post_init__(self):
        if self.kind == "sketch":
            if self.sketch is None or self.sketch.op not in ("add", "max"):
                raise ValueError("a sketch reduce needs an add or max sketch")
            if self.dtype != torch.int32 or \
                    tuple(self.value_shape) != tuple(self.sketch.value_shape):
                raise ValueError("a sketch reduce holds the sketch's int32 "
                                 "registers")
            return
        if self.kind not in ("sum", "count"):
            raise NotImplementedError(
                f"reduce kind {self.kind!r} is not ported yet: min/max and "
                f"generic reduces are ROADMAP queue 1, item 4"
            )
        if self.dtype != torch.float32 or self.value_shape \
                or self.finalize is not None:
            raise NotImplementedError(
                "only float32 scalar sums and counts are ported besides the "
                "sketches (ROADMAP queue 1, item 4)"
            )

    @property
    def out_shape(self) -> Tuple[int, ...]:
        return tuple(self.value_shape if self.finalize is None
                     else self.result_shape)

    @property
    def out_dtype(self):
        return self.dtype if self.result_dtype is None else self.result_dtype

    def neutral_value(self) -> float:
        return 0.0

    def combine_fn(self) -> Callable:
        if self.kind == "sketch":
            return {"add": torch.add, "max": torch.maximum}[self.sketch.op]
        return torch.add


@dataclass(frozen=True)
class WindowSpec:
    """Aligned time windows via pane composition (the reference's checks;
    its allowed lateness and slot-major layout are not ported). size_ticks
    must be a multiple of slide_ticks; panes_per_window = size // slide
    (1 = tumbling); ring = R panes of history; fires_per_step = F
    window-ends emitted per advance; overflow = O lanes of the overflow
    ring (0 = none: records that find no slot count as capacity loss)."""

    size_ticks: int
    slide_ticks: int
    ring: int = 8
    fires_per_step: int = 2
    overflow: int = 0

    def __post_init__(self):
        if self.size_ticks % self.slide_ticks:
            raise ValueError("window size must be a multiple of slide")
        if self.panes_per_window + 1 > self.ring:
            raise ValueError(
                f"ring={self.ring} too small for {self.panes_per_window} "
                f"panes/window"
            )

    @property
    def panes_per_window(self) -> int:
        return self.size_ticks // self.slide_ticks


@dataclass
class WindowShardState:
    """All device state of one key-group shard (the reference's pytree,
    field for field; ``table.keys`` becomes ``table_keys``, one int64 key
    word per slot). ``packed`` is the reference's plane descriptor: 0 for
    a sum or count's packed plane, -1 for a sketch's split planes.
    ``layout``, ``probe_len`` and ``packed`` are static, as the
    reference's table probe length and plane descriptor are."""

    table_keys: torch.Tensor        # int64 [C]: key word per slot
    acc: torch.Tensor               # float32 [C*R, 2] packed plane, or
                                    # int32 [C*R, W] split registers
    touched: torch.Tensor           # bool [0]: rides acc's touch column,
                                    # or bool [C*R] with split planes
    pane_ids: torch.Tensor          # int32 [R]: absolute pane per ring row
    max_pane: torch.Tensor          # int32 0-d: newest registered pane
    min_pane: torch.Tensor          # int32 0-d: oldest pane ever seen
    watermark: torch.Tensor         # int32 0-d
    fired_through: torch.Tensor     # int32 0-d: last window-end pane emitted
    purged_through: torch.Tensor    # int32 0-d: panes <= this are clean
    dropped_late: torch.Tensor      # int32 0-d counter
    dropped_capacity: torch.Tensor  # int32 0-d counter (records lost)
    fresh: torch.Tensor             # bool [C*R]: never set at lateness 0
    n_fresh: torch.Tensor           # int32 0-d
    ovf_hi: torch.Tensor            # int32 [O]: overflow ring, key hi bits
    ovf_lo: torch.Tensor            # int32 [O]: key lo bits
    ovf_pane: torch.Tensor          # int32 [O]
    ovf_val: torch.Tensor           # float32 [O]: the record's contribution
                                    # (int32 [0, W] with split planes)
    ovf_n: torch.Tensor             # int32 0-d: filled lanes
    kg_dirty: torch.Tensor          # bool [n_key_groups] changelog bits
    layout: str = "direct"          # "direct" (key == slot) | "hash"
    probe_len: int = 16             # hash layout: slots per probe chain
    packed: int = 0                 # 0 packed, -1 split planes

    @property
    def capacity(self) -> int:
        return self.table_keys.shape[0]

    @property
    def device(self) -> torch.device:
        return self.acc.device

    @property
    def ring(self):
        """The overflow ring in the argument order of G7 and G9."""
        return (self.ovf_hi, self.ovf_lo, self.ovf_pane, self.ovf_val,
                self.ovf_n)


# field order of the reference's WindowShardState.tree_flatten
STATE_FIELDS = (
    "table.keys", "acc", "touched", "pane_ids", "max_pane", "min_pane",
    "watermark", "fired_through", "purged_through", "dropped_late",
    "dropped_capacity", "fresh", "n_fresh", "ovf_hi", "ovf_lo", "ovf_pane",
    "ovf_val", "ovf_n", "kg_dirty",
)


@dataclass
class CompactFires:
    """Fire output compacted on the device (the reference's CompactFires):
    for lane f, rows j < counts[f] are (key_hi[f, j], key_lo[f, j],
    values[f, j]) in slot order, and the lane shares window_end_ticks[f].
    The host reads the small fields, then only the ``[:counts[f]]``
    prefixes. The row buffers are views of a caller-owned arena; what lies
    past a prefix is unspecified."""

    key_hi: torch.Tensor            # int32 [F, C] uint32 bits
    key_lo: torch.Tensor            # int32 [F, C] uint32 bits
    values: torch.Tensor            # float32 [F, C]
    counts: torch.Tensor            # int32 [F] emitted keys per lane
    window_end_ticks: torch.Tensor  # int32 [F] (PANE_NONE when unused)
    n_fires: torch.Tensor           # int32 0-d: valid lanes
    lane_valid: torch.Tensor        # bool [F]
    value_sums: torch.Tensor        # float32 [F]


@dataclass
class ReducedFires:
    """Fire output reduced on the device to per-lane scalars: the host
    reads these small fields once per drain and never anything O(C)."""

    counts: torch.Tensor            # int32 [F] fired keys per lane
    window_end_ticks: torch.Tensor  # int32 [F] (PANE_NONE when unused)
    n_fires: torch.Tensor           # int32 0-d: valid lanes
    lane_valid: torch.Tensor        # bool [F]
    value_sums: torch.Tensor        # float32 [F]


def overflow_supported(red: ReduceSpec) -> bool:
    """The overflow ring keeps raw record contributions that the host
    combines, so it needs a builtin reduce the host can compute (every
    reduce this port runs: sum and count)."""
    return red.kind in ("sum", "count")


def ring_append(ovf, mask, hi, lo, pane, vals, lost) -> None:
    """Append the masked lanes (key halves hi/lo, pane, contribution
    ``vals``, None for a count's 1.0) to the overflow ring ``ovf`` =
    (ovf_hi, ovf_lo, ovf_pane, ovf_val, ovf_n) in lane order, in place
    (G7; the reference's ``ring_append``). Lanes past the ring's end are
    lost and added to ``lost`` (int32 0-d)."""
    kernels.ring_append(ovf, lost, mask, hi, lo, pane, vals)


def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def init_state(capacity: int, win: WindowSpec, red: ReduceSpec,
               n_key_groups: int = 0, device="cuda", layout: str = "direct",
               probe_len: int = 16) -> WindowShardState:
    """Fresh state with packed planes for a sum or count (the reference's
    ``init_state(layout=..., packed=True)``), split planes for a sketch
    (``packed=False``: int32 registers ``[C*R, W]`` and a touched plane).
    ``direct``: the table holds the identity rows (0, slot) and the key is
    its slot. ``hash``: an empty open-addressing table (capacity a power of
    two) probed ``probe_len`` slots deep. Every plane starts at the
    neutral; the overflow ring has ``win.overflow`` empty lanes."""
    R = win.ring
    split = red.kind == "sketch"
    W = int(np.prod(red.value_shape, dtype=np.int64)) if split else 1
    if capacity * R * W > INT32_MAX:
        raise ValueError(
            f"accumulator of {capacity * R * W} elements overflows int32 "
            f"indices; lower capacity/ring or the sketch register count"
        )
    if win.overflow and not overflow_supported(red):
        raise ValueError(
            f"overflow ring requires a builtin scalar reduce, got "
            f"kind={red.kind!r}")
    O = win.overflow
    dev = torch.device(device)
    if layout == "direct":
        table = torch.arange(capacity, dtype=torch.int64, device=dev)
    elif layout == "hash":
        table = hashtable.create(capacity, device=dev)
    else:
        raise ValueError(f"unknown state layout {layout!r}")
    i32 = dict(dtype=torch.int32, device=dev)
    if split:
        acc = torch.zeros(capacity * R, W, dtype=torch.int32, device=dev)
    else:
        acc = torch.zeros(capacity * R, 2, dtype=torch.float32, device=dev)
    return WindowShardState(
        table_keys=table,
        acc=acc,
        touched=torch.zeros(capacity * R if split else 0, dtype=torch.bool,
                            device=dev),
        pane_ids=torch.full((R,), PANE_NONE, **i32),
        max_pane=_scalar(PANE_NONE, dev),
        min_pane=_scalar(INT32_MAX, dev),
        watermark=_scalar(INT32_MIN + 1, dev),
        fired_through=_scalar(PANE_NONE, dev),
        purged_through=_scalar(PANE_NONE, dev),
        dropped_late=_scalar(0, dev),
        dropped_capacity=_scalar(0, dev),
        fresh=torch.zeros(capacity * R, dtype=torch.bool, device=dev),
        n_fresh=_scalar(0, dev),
        ovf_hi=torch.zeros(O, **i32),
        ovf_lo=torch.zeros(O, **i32),
        ovf_pane=torch.full((O,), PANE_NONE, **i32),
        ovf_val=torch.zeros((O,) + tuple(red.value_shape), dtype=red.dtype,
                            device=dev),
        ovf_n=_scalar(0, dev),
        kg_dirty=torch.zeros(n_key_groups, dtype=torch.bool, device=dev),
        layout=layout,
        probe_len=probe_len,
        packed=-1 if split else 0,
    )


# ------------------------------------------------- packed state planes
# The pack/split helpers run at state carry-over only (the kernels read
# and write the packed plane directly).

def make_packed(acc: np.ndarray, touched: np.ndarray, red: ReduceSpec):
    """Pack split host planes (acc [N], touched bool [N]) into the [N, 2]
    plane: the touch column holds the marker 1.0 where touched, the
    neutral elsewhere."""
    col = np.where(touched, 1.0, red.neutral_value()).astype(acc.dtype)
    return np.stack([acc, col], axis=-1)


def split_packed(acc_packed, red: ReduceSpec):
    """Unpack a packed plane (numpy or torch) into logical (acc,
    touched)."""
    touched = acc_packed[..., -1] != red.neutral_value()
    return acc_packed[..., 0], touched


def state_from_numpy(fields: Dict[str, np.ndarray], packed: int,
                     device="cuda", layout: str = "direct",
                     probe_len: int = 16) -> WindowShardState:
    """Build a port state from host arrays named as the reference's
    ``WindowShardState.tree_flatten`` leaves (``STATE_FIELDS``). ``packed``
    is the source's plane descriptor: 0 for a packed scalar plane
    ``acc [C*R, 2]``; -1 for split planes, either a scalar's ``acc [C*R]``
    + ``touched [C*R]`` (packed here) or a sketch's int32 registers ``acc
    [C*R, W]`` + ``touched [C*R]`` (kept split). ``table.keys`` is the
    reference's uint32 [C, 2] (hi, lo) rows, for either ``layout``;
    ``probe_len`` is the source table's."""
    dev = torch.device(device)
    missing = [f for f in STATE_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"state fields missing: {missing}")
    raw = np.asarray(fields["acc"])
    split = packed < 0 and raw.ndim == 2
    touched = np.zeros(0, bool)
    if split:
        acc = raw.astype(np.int32)
        touched = np.asarray(fields["touched"], bool)
        if touched.shape != acc.shape[:1]:
            raise ValueError(f"touched {touched.shape} does not match acc "
                             f"{acc.shape}")
    elif packed < 0:
        acc = make_packed(raw.astype(np.float32),
                          np.asarray(fields["touched"], bool),
                          ReduceSpec("sum"))
    elif packed != 0:
        raise NotImplementedError("only scalar and sketch values are ported")
    else:
        acc = raw.astype(np.float32)
    if not split and (acc.ndim != 2 or acc.shape[1] != 2):
        raise ValueError(f"packed acc must be [C*R, 2], got {acc.shape}")

    def t(name, dtype):
        a = np.array(fields[name])          # a writable C-order copy
        if dtype == torch.int32 and a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    if layout not in ("direct", "hash"):
        raise ValueError(f"unknown state layout {layout!r}")
    i32 = torch.int32
    return WindowShardState(
        table_keys=hashtable.from_rows(fields["table.keys"], device=dev),
        acc=torch.from_numpy(np.array(acc)).to(dev),
        touched=torch.from_numpy(np.array(touched)).to(dev),
        pane_ids=t("pane_ids", i32),
        max_pane=t("max_pane", i32),
        min_pane=t("min_pane", i32),
        watermark=t("watermark", i32),
        fired_through=t("fired_through", i32),
        purged_through=t("purged_through", i32),
        dropped_late=t("dropped_late", i32),
        dropped_capacity=t("dropped_capacity", i32),
        fresh=t("fresh", torch.bool),
        n_fresh=t("n_fresh", i32),
        ovf_hi=t("ovf_hi", i32),
        ovf_lo=t("ovf_lo", i32),
        ovf_pane=t("ovf_pane", i32),
        ovf_val=t("ovf_val", torch.int32 if split else torch.float32),
        ovf_n=t("ovf_n", i32),
        kg_dirty=t("kg_dirty", torch.bool),
        layout=layout,
        probe_len=probe_len,
        packed=-1 if split else 0,
    )


def state_to_numpy(state: WindowShardState) -> Dict[str, np.ndarray]:
    """Host arrays of a port state under ``STATE_FIELDS`` names, in the
    state's layout: packed (``touched`` is the zero-length placeholder;
    use ``split_packed`` for the logical planes) or a sketch's split
    planes (``packed = -1``). ``table.keys`` and the
    overflow identities come back as uint32, as the reference holds them."""
    out = {}
    for name in STATE_FIELDS:
        attr = "table_keys" if name == "table.keys" else name
        out[name] = getattr(state, attr).detach().cpu().numpy()
    out["table.keys"] = hashtable.to_rows(state.table_keys)
    out["ovf_hi"] = out["ovf_hi"].view(np.uint32)
    out["ovf_lo"] = out["ovf_lo"].view(np.uint32)
    return out


# ------------------------------------------------------------ update

def _floor_div(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def update(state: WindowShardState, win: WindowSpec, red: ReduceSpec,
           hi, lo, ts, values, valid, *, maxp: int, kg_start: int = 0,
           kg_end: Optional[int] = None,
           clear_rows: Optional[torch.Tensor] = None, insert: bool = True):
    """Apply one micro-batch to the shard state, in place (the reference's
    ``update`` with packed planes, in the state's layout; the result equals
    its state with ``precombine`` on and off, up to which slot the hash
    table gives a key where several keys race for one).

    hi/lo: int32 [B] holding the uint32 halves of the key identity; ts
    int32 [B] ticks; values float32 [B], or for a sketch int32 [B], the
    uint32 bits of each record's item hash; valid bool [B]. Routing is fused
    in (G1): a lane counts only when valid AND its key group lies in
    ``[kg_start, kg_end]`` (the whole ``[0, maxp)`` by default — the
    reference's ``update`` receives ``valid`` already masked).
    ``clear_rows`` (bool [R]) folds a deferred purge into the ring-reset
    sweep, as the reference does.

    In the hash layout ``insert=True`` places absent keys (G5);
    ``insert=False`` is the reference's fast step, a lookup only (G8), for
    a key population that has stopped growing. A live lane whose key has
    no slot — a key past capacity in the direct layout, a full probe chain
    or (fast step) an absent key in the hash layout — goes to the overflow
    ring (G7) when ``win.overflow`` > 0, as (key, pane, contribution); it
    is lost, and counted in ``dropped_capacity``, only when the ring is
    full or absent.

    A sketch (split planes) has no overflow ring: G14 expands each lane
    into its registers, and a live lane with no slot counts as lost.

    Returns ``(state, activity)``, ``activity`` an int32 0-d tensor on the
    device: the lanes whose key the table did not hold before the batch
    and holds after it (insert step), or the live lanes whose key is
    missing (fast step); 0 in the direct layout, which has no insert
    phase to tier."""
    C = state.capacity
    R = win.ring
    k = win.panes_per_window
    if kg_end is None:
        kg_end = maxp - 1
    if state.kg_dirty.numel() not in (0, maxp):
        raise ValueError(
            f"changelog group count {state.kg_dirty.numel()} != max "
            f"parallelism {maxp}")
    if state.ovf_hi.numel() != win.overflow:
        raise ValueError(
            f"state has a {state.ovf_hi.numel()}-lane overflow ring, the "
            f"spec {win.overflow}")
    sketch = red.kind == "sketch"
    if sketch != (state.packed < 0):
        raise ValueError("a sketch reduce runs on split planes, a sum or "
                         "count on packed ones")
    # G1: routing mask, pane, late check, batch pane range
    pane, kg, live, stats = kernels.route_lanes(
        hi, lo, ts, valid, state.watermark, state.purged_through,
        slide=win.slide_ticks, k=k, maxp=maxp, kg_start=kg_start,
        kg_end=kg_end,
    )
    state.dropped_late.add_(stats[0])                       # in place
    # pane-ring registration (window_kernels.py:687-716), device scalars
    new_max = torch.maximum(state.max_pane, stats[1])
    new_min = torch.minimum(state.min_pane, stats[2])
    r_idx = torch.arange(R, dtype=torch.int32, device=state.device)
    p_r = new_max - torch.remainder(new_max - r_idx, R)
    p_r = torch.where(new_max != PANE_NONE, p_r, PANE_NONE)
    stale = p_r != state.pane_ids
    evicted = stale & (state.pane_ids != PANE_NONE) & (
        state.pane_ids + (k - 1) > state.fired_through
    )
    clear = stale if clear_rows is None else (stale | clear_rows)
    # G2: ring-reset sweep of the flagged rows (+ eviction count)
    kernels.clear_rows(state.acc, clear, evicted, state.dropped_capacity,
                       C=C, R=R, touched=state.touched if sketch else None)
    state.pane_ids.copy_(torch.where(stale, p_r, state.pane_ids))  # in place
    state.max_pane.copy_(new_max)                                  # in place
    state.min_pane.copy_(new_min)                                  # in place
    # the lanes that survive the ring horizon (the reference looks keys up
    # or places them, and spills them, after its too-old drop)
    inside = live & (pane >= state.max_pane - (R - 1))
    if state.layout == "direct":
        slot = torch.where((hi == 0) & (lo >= 0) & (lo < C), lo, C)
        activity = torch.zeros((), dtype=torch.int32, device=state.device)
    elif insert:
        # G5: place or find the keys
        slot, _ok, activity = hashtable.upsert_counted(
            state.table_keys, hi, lo, inside, probe_len=state.probe_len)
    else:
        # G8: find the keys, place none
        slot, _ok, activity = hashtable.lookup_counted(
            state.table_keys, hi, lo, inside, probe_len=state.probe_len)
    if sketch:
        # G14: too-old drop, kg_dirty, expand into the registers
        kernels.sketch_update(
            state.acc, state.touched,
            state.kg_dirty if state.kg_dirty.numel() else None,
            state.dropped_capacity, pane, kg, live, slot, values,
            state.max_pane, C=C, R=R, sketch=red.sketch)
        return state, activity
    count = red.kind == "count"
    if win.overflow:
        # G7: the lanes with no slot go to the overflow ring
        ring_append(state.ring, inside & (slot == C), hi, lo, pane,
                    None if count else values, state.dropped_capacity)
    # G3: too-old drop, scatter at the slot into the plane, kg_dirty
    kernels.scatter_update(
        state.acc, state.kg_dirty if state.kg_dirty.numel() else None,
        state.dropped_capacity, pane, kg, live, slot,
        None if count else values, state.max_pane, C=C, R=R,
        count_nofit=not win.overflow,
    )
    return state, activity


def compact_table(state: WindowShardState, win: WindowSpec,
                  red: ReduceSpec) -> WindowShardState:
    """Rebuild the hash layout's key table around the keys that still hold
    pane state (G9; the reference's ``compact_table``). A table never
    frees a slot, so a stream whose keys churn fills it with dead keys;
    the executor runs this after it drained the overflow ring. The alive
    keys go into a fresh table and their pane cells move with them; the
    touched cells of a key that finds no slot in the new arrangement go to
    the overflow ring, and count as lost only when the ring is full. The
    state's table and plane are replaced by the rebuilt ones."""
    if state.layout != "hash" or state.packed < 0:
        raise ValueError("compact_table rebuilds a hash-layout table of "
                         "packed planes; the direct layout's slot is its "
                         "key, and a sketch stage has no spill tier")
    state.acc, state.table_keys, _slot, _ok = kernels.compact_table(
        state.acc, state.table_keys, state.pane_ids, state.ring,
        state.dropped_capacity, R=win.ring, probe_len=state.probe_len)
    return state


# ------------------------------------------------------------ fire

def _fire_plan(state: WindowShardState, win: WindowSpec, new_watermark):
    """Scalar half of a watermark advance: which window-ends are due
    (window_kernels.py:1129), as device torch ops on 0-d / [F] tensors."""
    R = win.ring
    k = win.panes_per_window
    F = win.fires_per_step
    slide = win.slide_ticks
    if not isinstance(new_watermark, torch.Tensor):
        new_watermark = _scalar(int(new_watermark), state.device)
    wm = torch.maximum(state.watermark, new_watermark)
    # clamp before subtracting so the MIN sentinel cannot wrap int32
    wm_c = torch.clamp_min(wm, INT32_MIN + 1 + slide)
    wm_pane = _floor_div(wm_c + 1 - slide, slide)
    have = state.max_pane != PANE_NONE
    oldest = torch.maximum(state.max_pane - (R - 1), state.min_pane)
    start = torch.maximum(state.fired_through + 1, oldest)
    start = torch.where(state.fired_through == PANE_NONE, oldest, start)
    end = torch.where(
        have, torch.minimum(wm_pane, state.max_pane + (k - 1)), start - 1
    )
    n_due = torch.clamp_min(end - start + 1, 0)
    n_now = torch.clamp_max(n_due, F)
    f_idx = torch.arange(F, dtype=torch.int32, device=state.device)
    p_f = start + f_idx
    lane_ok = f_idx < n_now
    window_end = torch.where(lane_ok, (p_f + 1) * slide, PANE_NONE)
    new_fired = torch.where(
        n_due > F, start + n_now - 1, torch.maximum(wm_pane, state.fired_through)
    )
    new_fired = torch.where(
        have, new_fired, torch.maximum(state.fired_through, wm_pane)
    )
    return {"wm": wm, "n_now": n_now, "p_f": p_f, "lane_ok": lane_ok,
            "window_end": window_end, "new_fired_through": new_fired}


def _purge_plan(state: WindowShardState, win: WindowSpec, wm,
                new_fired_through):
    """Which ring rows purge at this advance, and the new purged_through
    (window_kernels.py:1245, allowed lateness 0)."""
    k = win.panes_per_window
    slide = win.slide_ticks
    base = torch.clamp_min(wm, INT32_MIN + 1 + slide)
    wm_pane_l = _floor_div(base + 1 - slide, slide)
    cutoff = torch.minimum(new_fired_through, wm_pane_l)
    purgeable = (
        (state.pane_ids != PANE_NONE)
        & (state.pane_ids + (k - 1) <= cutoff)
        & (state.pane_ids > state.purged_through)
    )
    new_purged = torch.where(
        cutoff == PANE_NONE,
        state.purged_through,
        torch.maximum(
            state.purged_through,
            torch.clamp_min(cutoff, PANE_NONE + k) - (k - 1),
        ),
    )
    return purgeable, new_purged


def advance_and_fire_resident(state: WindowShardState, win: WindowSpec,
                              red: ReduceSpec, new_watermark,
                              reduced: bool = False, out=None):
    """Fused-fire advance of the resident drain (the reference's
    ``advance_and_fire_resident``): plan the due window-ends, evaluate them
    for every key, advance watermark / fired_through / purged_through in
    place, and return the purge row mask for the next update's sweep (or
    ``apply_pending_purge``). ``new_watermark`` is an int32 0-d tensor (or
    an int, staged here).

    ``reduced=True`` reduces each lane to (count, value sum) on the device
    (G4) and returns ReducedFires. Otherwise G6 compacts the emitted rows
    into ``out`` — ``(key_hi, key_lo, values)``, int32 / int32 / float32
    ``[F, C]`` views of the caller's arena, allocated here when None — and
    returns CompactFires over them. A sketch's windows run on G15 in
    either mode: its values are the finalized ``red.out_shape`` of
    ``red.out_dtype`` (``[F, C, *out_shape]`` rows).

    Returns ``(state, purge_rows bool [R], fires)``."""
    plan = _fire_plan(state, win, new_watermark)
    purgeable, new_purged = _purge_plan(
        state, win, plan["wm"], plan["new_fired_through"]
    )
    C, R, k = state.capacity, win.ring, win.panes_per_window
    if red.kind == "sketch":
        if not reduced and out is None:
            out = fire_row_buffers(win.fires_per_step, C, state.device,
                                   red=red)
        counts, vsums = kernels.sketch_fire(
            state.acc, state.touched, state.pane_ids, plan["p_f"],
            plan["lane_ok"], state.table_keys, None if reduced else out,
            C=C, R=R, k=k, red=red)
        fires = (ReducedFires(counts, plan["window_end"], plan["n_now"],
                              plan["lane_ok"], vsums) if reduced else
                 CompactFires(*out, counts, plan["window_end"],
                              plan["n_now"], plan["lane_ok"], vsums))
    elif reduced:
        counts, vsums = kernels.fire_reduced(
            state.acc, state.pane_ids, plan["p_f"], plan["lane_ok"],
            C=C, R=R, k=k)
        fires = ReducedFires(counts, plan["window_end"], plan["n_now"],
                             plan["lane_ok"], vsums)
    else:
        if out is None:
            out = fire_row_buffers(win.fires_per_step, C, state.device)
        counts, vsums = kernels.fire_compact(
            state.acc, state.pane_ids, plan["p_f"], plan["lane_ok"],
            state.table_keys, *out, C=C, R=R, k=k)
        fires = CompactFires(*out, counts, plan["window_end"],
                             plan["n_now"], plan["lane_ok"], vsums)
    state.watermark.copy_(plan["wm"])                         # in place
    state.fired_through.copy_(plan["new_fired_through"])      # in place
    state.purged_through.copy_(new_purged)                    # in place
    return state, purgeable, fires


def fire_row_buffers(*shape_and_device, red: Optional[ReduceSpec] = None):
    """Row buffers ``(key_hi, key_lo, values)`` of shape ``[..., C]`` for
    compact fires (int32, int32, float32), uninitialised: G6 and G15 write
    only the prefixes they emit. ``fire_row_buffers(D, F, C, device)`` is
    one drain's arena (D·F·C·12 bytes). With a sketch ``red`` the values
    are ``[..., C, *red.out_shape]`` of ``red.out_dtype``."""
    *shape, device = shape_and_device
    v_shape, v_dtype = list(shape), torch.float32
    if red is not None:
        v_shape += list(red.out_shape)
        v_dtype = red.out_dtype
    return (torch.empty(shape, dtype=torch.int32, device=device),
            torch.empty(shape, dtype=torch.int32, device=device),
            torch.empty(v_shape, dtype=v_dtype, device=device))


def compact_fires(table_keys, mask, values, window_end_ticks, n_fires,
                  lane_valid) -> CompactFires:
    """Pack dense fire planes (mask bool [F, C], values float32 [F, C]) into
    CompactFires (the reference's ``compact_fires`` over a FireResult):
    per lane the emitted slots in slot order, keys read from the table,
    zeros past each prefix, and the lane's value sum."""
    khi, klo, v, counts, vsums = kernels.pack_fire_lanes(table_keys, mask,
                                                         values)
    return CompactFires(khi, klo, v, counts, window_end_ticks, n_fires,
                        lane_valid, vsums)


def apply_pending_purge(state: WindowShardState, win: WindowSpec,
                        red: ReduceSpec, rows) -> WindowShardState:
    """Clear the ring rows whose purge was deferred past the end of a
    drain (G2 without an eviction count), in place."""
    kernels.clear_rows(state.acc, rows, None, state.dropped_capacity,
                       C=state.capacity, R=win.ring,
                       touched=state.touched if state.packed < 0 else None)
    return state
