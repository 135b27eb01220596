"""Keyed window aggregation on one shard, in PyTorch — the counterpart of
flink_tpu/ops/window_kernels.py.

The model is the reference's: time is cut into aligned panes of ``slide``
ticks, a window of ``size = k * slide`` is the combine of k consecutive
panes, and each shard keeps accumulators for ALL its keys across a ring of
R recent panes. Two state layouts, as in the reference: ``direct`` (key ==
slot, for bounded non-negative integer keys) and ``hash`` (an
open-addressing table, ``ops/hashtable.py``, for any 64-bit key identity).
Three planes, by the reduce (``plane_of``):

  * ``packed``, the builtin sum, count, min and max (``packed_eligible``):
    ``acc`` is one flat pane-major float32 plane ``[C*R, W+1]``, W value
    columns (1 for a scalar, 2 for ``mean``'s [sum, count]) and the touch
    column, whose neutral (0 for sum and count, +FLT_MAX for min, -FLT_MAX
    for max) means untouched — exactly the reference's packed layout;
  * ``split``, a generic reduce (the user's combine, an explicit neutral):
    ``acc`` float32 ``[C*R, *value_shape]`` beside a ``touched`` bool plane
    ``[C*R]``;
  * ``sketch`` (Count-Min, HyperLogLog: ``ops/sketches.py``): ``acc`` int32
    ``[C*R, W]`` registers beside a ``touched`` plane.

A state's ``packed`` is the reference's plane descriptor: the value's
number of dimensions for a packed plane, -1 for split planes. Each carries
across (``state_from_numpy`` / ``state_to_numpy``). The table holds one
int64 key word ``(hi << 32) | lo`` per slot; the reference's uint32 ``[C,
2]`` rows appear only at carry-over.

Records whose key finds no slot (a key past capacity in the direct layout,
a full probe chain or an absent key in the hash layout's lookup-only fast
update) go to the overflow ring (``ovf_*``, ``WindowSpec.overflow`` lanes)
when the spec has one — the builtin reduces only (``overflow_supported``);
the executor drains it into its host spill stores and compacts the table
(``compact_table``), as the reference does.

Allowed lateness (``WindowSpec.lateness_ticks`` L > 0), as the reference
runs it: a record drops as late only when the newest window holding its
pane ended more than L ticks before the watermark; a record that lands in
a pane at or before ``fired_through`` sets its cell's ``fresh`` flag, and
the advance (``advance_and_fire``) re-fires, after up to F on-time lanes,
up to F windows with fresh panes, emitting the keys a late record reached
with their corrected full value. Panes purge only once the lateness
horizon has passed and no re-fire is pending on them.

The O(B) and O(C) work runs in the kernels of ``ops/cuda.py``: G1-G9 for
the packed planes (G1 also counts a batch's lanes per key group, the
``kg_fill`` skew telemetry; G17 counts live keys per key group,
``kg_occupancy``), G14 (the register scatter) and G15 (the fire) for a
sketch, and for a generic reduce G10 (the sort), G16 (the gather and the
set around the user's combine, which runs as torch ops over a log-step
segmented scan — ``ops/segment.py`` ``preaggregate``) and G6's
``fire_pack``. The per-batch scalar bookkeeping — pane-ring registration,
the fire plan, the late lanes' selection, the purge plan, watermark /
fired_through / purged_through — stays on the device as small torch ops on
0-d, [R], [R, k] and [F] tensors, so a drain never waits for the host
between slots. State tensors are updated in place where the reference
donated its buffers to XLA; every such update is marked "in place" below.

Tiered key-group state (``update(kg_res=)``): G1 marks the live lanes
whose key group the residency mask leaves cold, and they take the
overflow ring instead of a slot, as the reference diverts them.

Not ported yet (ROADMAP queues 1-2): value dtypes other than float32
(item 9), builtin reduces with an explicit neutral or a value of more than
one dimension (item 9), and the slot-major accumulator layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import hashtable, segment
from flink_tpu_torch.ops.cuda import INT32_MAX, PANE_NONE

INT32_MIN = -(2**31)
FLOAT32_MAX = float(np.finfo(np.float32).max)
BUILTIN = ("sum", "count", "min", "max")


@dataclass(frozen=True)
class ReduceSpec:
    """How window contents aggregate (the reference's ReduceSpec): the
    builtin ``sum``, ``count``, ``min`` and ``max`` (ref ReduceFunction
    under ReducingStateDescriptor), a ``generic`` reduce — ``combine`` an
    associative callable on torch tensors ``[..., *value_shape]`` with
    ``neutral`` its identity — or a ``sketch`` (``ops/sketches.py``) whose
    int32 register vector of ``value_shape`` is the accumulator: records
    expand into it and panes compose elementwise by the sketch's op.
    ``finalize`` (sketches) turns a window's combined registers into its
    ``result_shape`` / ``result_dtype`` value at fire time (the reference's
    window-function result extraction). Values are float32 but for a
    sketch's registers."""

    kind: str = "sum"
    dtype: Any = torch.float32
    value_shape: Tuple[int, ...] = ()
    combine: Optional[Callable] = None
    neutral: Any = None
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
        if self.kind not in BUILTIN + ("generic",):
            raise ValueError(f"unknown reduce kind {self.kind!r}")
        if self.dtype != torch.float32:
            raise NotImplementedError(
                f"a {self.kind} reduce of {self.dtype} is not ported yet: "
                f"values are float32 besides the sketches' int32 registers "
                f"(ROADMAP queue 1, item 9)")
        if self.finalize is not None:
            raise NotImplementedError(
                "a finalize is ported for the sketches only; project a "
                "window value with a result_fn (mean, aggregate)")
        if self.kind == "generic":
            if not callable(self.combine):
                raise ValueError("a generic reduce needs a combine function")
            if self.neutral is None:
                raise ValueError("generic reduce needs an explicit neutral")
        elif not packed_eligible(self):
            raise NotImplementedError(
                f"a {self.kind} reduce with an explicit neutral or a value "
                f"of more than one dimension (the reference's split planes "
                f"for a builtin reduce) is not ported yet (ROADMAP queue 1, "
                f"item 9)")

    @property
    def out_shape(self) -> Tuple[int, ...]:
        return tuple(self.value_shape if self.finalize is None
                     else self.result_shape)

    @property
    def out_dtype(self):
        return self.dtype if self.result_dtype is None else self.result_dtype

    @property
    def op(self) -> str:
        """The builtin combine of ``ops/cuda.py`` OPS (add, min, max)."""
        return {"min": "min", "max": "max"}.get(self.kind, "add")

    def neutral_value(self):
        """The identity: a float, or a ``value_shape`` float32 array for a
        generic reduce's vector neutral."""
        if self.kind == "sketch":
            return float(self.sketch.neutral)
        if self.kind == "generic":
            n = np.asarray(self.neutral, np.float32)
            return float(n) if n.ndim == 0 else np.broadcast_to(
                n, self.value_shape).copy()
        return {"min": FLOAT32_MAX, "max": -FLOAT32_MAX}.get(self.kind, 0.0)

    def combine_fn(self) -> Callable:
        if self.kind == "sketch":
            return {"add": torch.add, "max": torch.maximum}[self.sketch.op]
        if self.kind == "generic":
            return self.combine
        return kernels.COMBINE[self.op]


def packed_eligible(red: ReduceSpec) -> bool:
    """Packing needs a builtin combine whose default neutral the touch
    marker provably escapes (an explicit user neutral could collide with
    the marker), and an at-most-1-D value (the column rides axis -1) — the
    reference's rule."""
    return (red.kind in BUILTIN and red.neutral is None
            and red.sketch is None and len(red.value_shape) <= 1)


def _touch_marker(red: ReduceSpec) -> float:
    """Per-lane touch-column update: combines to something != neutral (add:
    a count of touches; min / max: 0 against the -/+FLT_MAX neutral)."""
    return 1.0 if red.kind in ("sum", "count") else 0.0


def plane_of(red: ReduceSpec) -> str:
    """``packed``, ``split`` (a generic reduce's float32 values) or
    ``sketch`` (int32 registers)."""
    if red.kind == "sketch":
        return "sketch"
    return "packed" if packed_eligible(red) else "split"


@dataclass(frozen=True)
class WindowSpec:
    """Aligned time windows via pane composition (the reference's checks;
    its slot-major layout is not ported). size_ticks must be a multiple of
    slide_ticks; panes_per_window = size // slide (1 = tumbling); ring = R
    panes of history; fires_per_step = F window-ends emitted per advance
    (and F more late re-fires with lateness); lateness_ticks = allowed
    lateness L (late records within it re-fire their windows); overflow =
    O lanes of the overflow ring (0 = none: records that find no slot
    count as capacity loss)."""

    size_ticks: int
    slide_ticks: int
    ring: int = 8
    fires_per_step: int = 2
    lateness_ticks: int = 0
    overflow: int = 0

    def __post_init__(self):
        if self.size_ticks % self.slide_ticks:
            raise ValueError("window size must be a multiple of slide")
        if self.panes_per_window + 1 > self.ring:
            raise ValueError(
                f"ring={self.ring} too small for {self.panes_per_window} "
                f"panes/window"
            )
        if self.lateness_ticks < 0:
            raise ValueError("allowed lateness must be >= 0")

    @property
    def panes_per_window(self) -> int:
        return self.size_ticks // self.slide_ticks

    @property
    def fire_lanes(self) -> int:
        """Lanes a fire returns: F, and F more re-fires with lateness."""
        return self.fires_per_step * (2 if self.lateness_ticks else 1)


@dataclass
class WindowShardState:
    """All device state of one key-group shard (the reference's pytree,
    field for field; ``table.keys`` becomes ``table_keys``, one int64 key
    word per slot). ``packed`` is the reference's plane descriptor: the
    value's dimensions (0 or 1) for a packed plane, -1 for split planes.
    ``layout``, ``probe_len`` and ``packed`` are static, as the
    reference's table probe length and plane descriptor are."""

    table_keys: torch.Tensor        # int64 [C]: key word per slot
    acc: torch.Tensor               # float32 [C*R, W+1] packed plane,
                                    # float32 [C*R, *value_shape] split
                                    # values, or int32 [C*R, W] registers
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
    fresh: torch.Tensor             # bool [C*R]: late-updated, pending
                                    # re-fire (set only with lateness)
    n_fresh: torch.Tensor           # int32 0-d
    ovf_hi: torch.Tensor            # int32 [O]: overflow ring, key hi bits
    ovf_lo: torch.Tensor            # int32 [O]: key lo bits
    ovf_pane: torch.Tensor          # int32 [O]
    ovf_val: torch.Tensor           # float32 [O, *value_shape]: the
                                    # record's contribution (int32 [0, W]
                                    # with a sketch's planes)
    ovf_n: torch.Tensor             # int32 0-d: filled lanes
    kg_dirty: torch.Tensor          # bool [n_key_groups] changelog bits
    layout: str = "direct"          # "direct" (key == slot) | "hash"
    probe_len: int = 16             # hash layout: slots per probe chain
    packed: int = 0                 # value dims packed, -1 split planes

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
    With allowed lateness the lanes are F on-time lanes, then F re-fire
    lanes. The host reads the small fields, then only the ``[:counts[f]]``
    prefixes. The row buffers are views of a caller-owned arena; what lies
    past a prefix is unspecified."""

    key_hi: torch.Tensor            # int32 [Ft, C] uint32 bits
    key_lo: torch.Tensor            # int32 [Ft, C] uint32 bits
    values: torch.Tensor            # [Ft, C, *out_shape]
    counts: torch.Tensor            # int32 [Ft] emitted keys per lane
    window_end_ticks: torch.Tensor  # int32 [Ft] (PANE_NONE when unused)
    n_fires: torch.Tensor           # int32 0-d: valid lanes
    lane_valid: torch.Tensor        # bool [Ft]
    value_sums: torch.Tensor        # float32 [Ft]


@dataclass
class ReducedFires:
    """Fire output reduced on the device to per-lane scalars: the host
    reads these small fields once per drain and never anything O(C)."""

    counts: torch.Tensor            # int32 [Ft] fired keys per lane
    window_end_ticks: torch.Tensor  # int32 [Ft] (PANE_NONE when unused)
    n_fires: torch.Tensor           # int32 0-d: valid lanes
    lane_valid: torch.Tensor        # bool [Ft]
    value_sums: torch.Tensor        # float32 [Ft]


def overflow_supported(red: ReduceSpec) -> bool:
    """The overflow tier stores raw record contributions and merges them
    host-side, so it needs a host-computable builtin combine over plain
    scalar blocks and no kernel-side finalize (the reference's rule)."""
    return red.kind in BUILTIN and red.finalize is None


def ring_append(ovf, mask, hi, lo, pane, vals, lost) -> None:
    """Append the masked lanes (key halves hi/lo, pane, contribution
    ``vals`` [B] or [B, W], None for a count's 1.0) to the overflow ring
    ``ovf`` = (ovf_hi, ovf_lo, ovf_pane, ovf_val, ovf_n) in lane order, in
    place (G7; the reference's ``ring_append``). Lanes past the ring's end
    are lost and added to ``lost`` (int32 0-d)."""
    kernels.ring_append(ovf, lost, mask, hi, lo, pane, vals)


def kg_batch_fill(kg, mask, n_key_groups: int) -> torch.Tensor:
    """Per-key-group lane counts of one micro-batch (the reference's
    ``kg_batch_fill``): int32 [n_key_groups], the ``mask``-selected lanes
    bincounted by their key group ``kg``. On the card ``update`` counts it
    inside G1 (``kg_fill``); this is the plain form, for the tests."""
    return kernels.kg_batch_fill_plain(kg, mask, n_key_groups)


def kg_occupancy(state: WindowShardState, n_key_groups: int,
                 red: ReduceSpec,
                 win: Optional[WindowSpec] = None) -> torch.Tensor:
    """Per-key-group live-key occupancy of one shard (the reference's
    ``kg_occupancy``): int32 [n_key_groups], how many table keys with at
    least one touched pane cell — or, with allowed lateness, a fresh one —
    hash into each key group (G17). The touch is the packed plane's marker
    column against the reduce's neutral, or the split planes' ``touched``.
    ``win`` None reads the fresh plane whatever the lateness. The state is
    only read."""
    R = state.pane_ids.shape[0]
    fresh = (state.fresh if win is None or win.lateness_ticks else None)
    if state.packed >= 0:
        return kernels.kg_occupancy(state.table_keys, R=R,
                                    maxp=n_key_groups, acc=state.acc,
                                    neutral=red.neutral_value(), fresh=fresh)
    return kernels.kg_occupancy(state.table_keys, R=R, maxp=n_key_groups,
                                touched=state.touched, fresh=fresh)


def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def _width(red: ReduceSpec) -> int:
    return int(np.prod(red.value_shape, dtype=np.int64)) \
        if red.value_shape else 1


def init_state(capacity: int, win: WindowSpec, red: ReduceSpec,
               n_key_groups: int = 0, device="cuda", layout: str = "direct",
               probe_len: int = 16) -> WindowShardState:
    """Fresh state (the reference's ``init_state``) with the reduce's plane
    (``plane_of``): packed for a builtin reduce (``packed=True``), split
    float32 values for a generic one, split int32 registers for a sketch
    (``packed=False``). ``direct``: the table holds the identity rows (0,
    slot) and the key is its slot. ``hash``: an empty open-addressing table
    (capacity a power of two) probed ``probe_len`` slots deep. Every plane
    starts at the neutral; the overflow ring has ``win.overflow`` empty
    lanes."""
    R = win.ring
    plane = plane_of(red)
    W = _width(red)
    if capacity * R * W > INT32_MAX:
        raise ValueError(
            f"accumulator of {capacity * R * W} elements overflows int32 "
            f"indices; lower capacity/ring or the sketch register count"
        )
    if win.overflow and not overflow_supported(red):
        raise ValueError(
            f"overflow ring requires a builtin scalar reduce without "
            f"finalize, got kind={red.kind!r}")
    O = win.overflow
    dev = torch.device(device)
    if layout == "direct":
        table = torch.arange(capacity, dtype=torch.int64, device=dev)
    elif layout == "hash":
        table = hashtable.create(capacity, device=dev)
    else:
        raise ValueError(f"unknown state layout {layout!r}")
    i32 = dict(dtype=torch.int32, device=dev)
    neutral = red.neutral_value()
    if plane == "sketch":
        acc = torch.zeros(capacity * R, W, **i32)
    elif plane == "packed":
        acc = torch.full((capacity * R, W + 1), neutral, dtype=torch.float32,
                         device=dev)
    else:
        acc = torch.as_tensor(neutral, dtype=torch.float32).to(dev).expand(
            (capacity * R,) + tuple(red.value_shape)).contiguous()
    return WindowShardState(
        table_keys=table,
        acc=acc,
        touched=torch.zeros(0 if plane == "packed" else capacity * R,
                            dtype=torch.bool, device=dev),
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
        packed=len(red.value_shape) if plane == "packed" else -1,
    )


# ------------------------------------------------- packed state planes
# The pack/split helpers run at state carry-over only (the kernels read
# and write the packed plane directly).

def make_packed(acc: np.ndarray, touched: np.ndarray, red: ReduceSpec):
    """Pack split host planes (acc [N] or [N, W], touched bool [N]) into
    the [N, W+1] plane: the touch column holds the reduce's marker where
    touched, its neutral elsewhere."""
    col = np.where(touched, _touch_marker(red),
                   red.neutral_value()).astype(acc.dtype)
    if acc.ndim == 1:
        return np.stack([acc, col], axis=-1)
    return np.concatenate([acc, col[..., None]], axis=-1)


def split_packed(acc_packed, red: ReduceSpec):
    """Unpack a packed plane (numpy or torch) into logical (acc,
    touched): acc [N] for a scalar reduce, [N, W] for a vector one."""
    touched = acc_packed[..., -1] != red.neutral_value()
    if len(red.value_shape) == 0:
        return acc_packed[..., 0], touched
    return acc_packed[..., :-1], touched


def state_from_numpy(fields: Dict[str, np.ndarray], packed: int,
                     device="cuda", layout: str = "direct",
                     probe_len: int = 16,
                     red: Optional[ReduceSpec] = None) -> WindowShardState:
    """Build a port state from host arrays named as the reference's
    ``WindowShardState.tree_flatten`` leaves (``STATE_FIELDS``). ``packed``
    is the source's plane descriptor (>= 0 packed, -1 split); ``red`` the
    stage's reduce, which picks the port's plane (``plane_of``): a builtin
    reduce's split source is packed here, a generic reduce's split values
    and a sketch's int32 registers stay split. Without ``red``, a split
    ``acc [C*R, W]`` is a sketch's and anything else a float32 sum's.
    ``table.keys`` is the reference's uint32 [C, 2] (hi, lo) rows, for
    either ``layout``; ``probe_len`` is the source table's."""
    dev = torch.device(device)
    missing = [f for f in STATE_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"state fields missing: {missing}")
    raw = np.asarray(fields["acc"])
    if red is None:
        sketch = packed < 0 and raw.ndim == 2
        plane = "sketch" if sketch else "packed"
        red = None if sketch else ReduceSpec("sum")
    else:
        plane = plane_of(red)
    touched = np.zeros(0, bool)
    if plane != "packed":
        if packed >= 0:
            raise ValueError("a packed source for a split-plane reduce")
        acc = raw.astype(np.int32 if plane == "sketch" else np.float32)
        touched = np.asarray(fields["touched"], bool)
        if touched.shape != acc.shape[:1]:
            raise ValueError(f"touched {touched.shape} does not match acc "
                             f"{acc.shape}")
    else:
        acc = raw.astype(np.float32)
        if packed < 0:
            acc = make_packed(acc, np.asarray(fields["touched"], bool), red)
        if acc.ndim != 2 or acc.shape[1] != _width(red) + 1:
            raise ValueError(f"packed acc must be [C*R, {_width(red) + 1}], "
                             f"got {acc.shape}")

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
        ovf_val=t("ovf_val", torch.int32 if plane == "sketch"
                  else torch.float32),
        ovf_n=t("ovf_n", i32),
        kg_dirty=t("kg_dirty", torch.bool),
        layout=layout,
        probe_len=probe_len,
        packed=len(red.value_shape) if plane == "packed" else -1,
    )


def state_to_numpy(state: WindowShardState) -> Dict[str, np.ndarray]:
    """Host arrays of a port state under ``STATE_FIELDS`` names, in the
    state's layout: packed (``touched`` is the zero-length placeholder;
    use ``split_packed`` for the logical planes) or split planes
    (``packed = -1``). ``table.keys`` and the overflow identities come back
    as uint32, as the reference holds them. On the CPU the arrays are views
    of the state's tensors and change with it: copy them to keep them."""
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


def _check_plane(state: WindowShardState, red: ReduceSpec) -> str:
    plane = plane_of(red)
    have = ("packed" if state.packed >= 0 else
            "sketch" if state.acc.dtype == torch.int32 else "split")
    if have != plane:
        raise ValueError(f"a {red.kind} reduce runs on {plane} planes, the "
                         f"state has {have} ones")
    return plane


def update(state: WindowShardState, win: WindowSpec, red: ReduceSpec,
           hi, lo, ts, values, valid, *, maxp: int, kg_start: int = 0,
           kg_end: Optional[int] = None,
           clear_rows: Optional[torch.Tensor] = None, insert: bool = True,
           kg_fill: int = 0, fill_out: Optional[torch.Tensor] = None,
           lane_stats: Optional[torch.Tensor] = None,
           kg_res: Optional[torch.Tensor] = None):
    """Apply one micro-batch to the shard state, in place (the reference's
    ``update``, in the state's layout and plane; the result equals its
    state with ``precombine`` on and off, up to which slot the hash table
    gives a key where several keys race for one).

    hi/lo: int32 [B] holding the uint32 halves of the key identity; ts
    int32 [B] ticks; values float32 [B] (or [B, *value_shape] for a vector
    reduce, e.g. mean's [B, 2]), or for a sketch int32 [B], the uint32 bits
    of each record's item hash; valid bool [B]. Routing is fused in (G1): a
    lane counts only when valid AND its key group lies in ``[kg_start,
    kg_end]`` (the whole ``[0, maxp)`` by default — the reference's
    ``update`` receives ``valid`` already masked), and is late by the
    allowed lateness ``win.lateness_ticks``. ``clear_rows`` (bool [R])
    folds a deferred purge into the ring-reset sweep, as the reference
    does.

    In the hash layout ``insert=True`` places absent keys (G5);
    ``insert=False`` is the reference's fast step, a lookup only (G8), for
    a key population that has stopped growing. A live lane whose key has
    no slot — a key past capacity in the direct layout, a full probe chain
    or (fast step) an absent key in the hash layout — goes to the overflow
    ring (G7) when ``win.overflow`` > 0, as (key, pane, contribution); it
    is lost, and counted in ``dropped_capacity``, only when the ring is
    full or absent.

    The builtin reduces scatter into the packed plane (G3: add, min or
    max). A generic reduce sorts the batch by cell (G10), gathers each
    lane's value and its cell's old value (G16), combines them with the
    user's function in torch and sets each cell once (G16). A sketch (G14)
    expands each lane into its registers. Split planes have no overflow
    ring: a live lane with no slot counts as lost. With allowed lateness a
    placed lane whose pane is at or before ``fired_through`` marks its
    cell fresh (G3, G16).

    ``kg_fill`` (0, or ``maxp``) turns on the skew telemetry's fill: the
    batch's owned valid lanes counted per key group, before the late check
    (late, too-old and no-fit lanes count), by G1 — the reference's
    ``kg_fill``, which its pre-combine and one-scatter branches give
    alike. The counts go into ``fill_out`` (int32 [maxp], added to in
    place) when given, else into a new zeroed vector. ``lane_stats`` (int32
    [4]), when given, receives G1's batch scalars (late lanes, max and min
    live pane, valid lanes) for the drain's flight recorder.

    ``kg_res`` (bool [maxp]), tiered key-group state's residency mask (the
    reference's ``kg_res``, window_kernels.py:770-820): G1 marks the live
    lanes of non-resident key groups cold. A cold lane claims no slot and
    adds nothing to ``activity`` (G5 / G8 and the direct layout's slot
    skip it); it goes to the overflow ring with the lanes that have no
    slot, and G3, which sees it as a lane with no slot, still marks its
    key group in ``kg_dirty`` and counts it when it is too old. Packed
    planes with an overflow ring only.

    Returns ``(state, activity, kgf)``, ``activity`` an int32 0-d tensor on
    the device: the lanes whose key the table did not hold before the batch
    and holds after it (insert step), or the live lanes whose key is
    missing (fast step); 0 in the direct layout, which has no insert
    phase to tier. ``kgf`` is the fill, int32 [kg_fill] (``[0]`` when
    ``kg_fill`` is 0)."""
    C = state.capacity
    R = win.ring
    k = win.panes_per_window
    L = win.lateness_ticks
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
    if kg_fill and kg_fill != maxp:
        raise ValueError(f"kg_fill group count {kg_fill} != max parallelism "
                         f"{maxp}")
    plane = _check_plane(state, red)
    if kg_res is not None and (plane != "packed" or not win.overflow):
        raise ValueError("kg_res diverts cold lanes to the overflow ring: it "
                         "needs packed planes and a ring")
    if L and plane == "sketch":
        raise NotImplementedError(
            "allowed lateness on sketch windows is not ported yet (ROADMAP "
            "queue 1, item 9)")
    kgf = fill_out
    if kgf is None:
        kgf = torch.zeros(kg_fill, dtype=torch.int32, device=state.device)
    # G1: routing mask, pane, late check, batch pane range (and the fill,
    # and the cold lanes of tiered state)
    routed = kernels.route_lanes(
        hi, lo, ts, valid, state.watermark, state.purged_through,
        slide=win.slide_ticks, k=k, maxp=maxp, kg_start=kg_start,
        kg_end=kg_end, L=L, fill=kgf if kg_fill else None, res=kg_res,
    )
    pane, kg, live, stats = routed[:4]
    cold = routed[4] if kg_res is not None else None
    if lane_stats is not None:
        lane_stats.copy_(stats)
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
    # G2: ring-reset sweep of the flagged rows (+ eviction count; the fresh
    # rows too with lateness)
    kernels.clear_rows(state.acc, clear, evicted, state.dropped_capacity,
                       C=C, R=R,
                       touched=None if plane == "packed" else state.touched,
                       neutral=red.neutral_value(),
                       fresh=state.fresh if L else None)
    state.pane_ids.copy_(torch.where(stale, p_r, state.pane_ids))  # in place
    state.max_pane.copy_(new_max)                                  # in place
    state.min_pane.copy_(new_min)                                  # in place
    # the lanes that survive the ring horizon (the reference looks keys up
    # or places them, and spills them, after its too-old drop)
    inside = live & (pane >= state.max_pane - (R - 1))
    # a cold lane takes no slot: it reaches G7 and G3 as a lane without one
    place = inside if cold is None else inside & ~cold
    if state.layout == "direct":
        fit = (hi == 0) & (lo >= 0) & (lo < C)
        slot = torch.where(fit if cold is None else fit & ~cold, lo, C)
        activity = torch.zeros((), dtype=torch.int32, device=state.device)
    elif insert:
        # G5: place or find the keys
        slot, _ok, activity = hashtable.upsert_counted(
            state.table_keys, hi, lo, place, probe_len=state.probe_len)
    else:
        # G8: find the keys, place none
        slot, _ok, activity = hashtable.lookup_counted(
            state.table_keys, hi, lo, place, probe_len=state.probe_len)
    kg_dirty = state.kg_dirty if state.kg_dirty.numel() else None
    late = ({} if not L else
            dict(fresh=state.fresh, fired_through=state.fired_through,
                 n_fresh=state.n_fresh))
    if plane == "sketch":
        # G14: too-old drop, kg_dirty, expand into the registers
        kernels.sketch_update(
            state.acc, state.touched, kg_dirty, state.dropped_capacity,
            pane, kg, live, slot, values, state.max_pane, C=C, R=R,
            sketch=red.sketch)
        return state, activity, kgf
    if plane == "split":
        _generic_update(state, red, pane, kg, live, slot, values, kg_dirty,
                        late, C=C, R=R)
        return state, activity, kgf
    count = red.kind == "count"
    if win.overflow:
        # G7: the lanes with no slot (cold lanes among them) go to the
        # overflow ring
        ring_append(state.ring, inside & (slot == C), hi, lo, pane,
                    None if count else values, state.dropped_capacity)
    # G3: too-old drop, scatter at the slot into the plane, kg_dirty, fresh
    kernels.scatter_update(
        state.acc, kg_dirty, state.dropped_capacity, pane, kg, live, slot,
        None if count else values, state.max_pane, C=C, R=R,
        count_nofit=not win.overflow, op=red.op, **late,
    )
    return state, activity, kgf


def _generic_update(state: WindowShardState, red: ReduceSpec, pane, kg,
                    live, slot, values, kg_dirty, late, *, C: int,
                    R: int) -> None:
    """The generic branch of the reference's update (window_kernels.py:916-
    927): each placed lane inside the ring's horizon goes to its cell
    (pane mod R) * C + slot; ``segment.preaggregate`` sorts the lanes by
    cell (G10), gathers their values and each cell's old value (G16) and
    combines them with the user's function (torch); G16's rep_set writes
    each cell's merged value once and does the lane-order bookkeeping
    (drops, kg_dirty, the fresh marking)."""
    N = C * R
    ok = live & (pane >= state.max_pane - (R - 1)) & (slot >= 0) & (slot < C)
    cell = torch.remainder(pane.to(torch.int64), R) * C + slot.to(torch.int64)
    key = torch.where(ok, cell, N)
    B = pane.shape[0]
    vals = values.reshape((B,) + tuple(red.value_shape))
    order, key_s, seg_start, merged = segment.preaggregate(
        key, vals, state.acc, state.touched, red.neutral_value(),
        red.combine_fn(), N)
    kernels.rep_set(
        state.acc, state.touched, order, key_s, seg_start, merged,
        lanes=kernels.WindowLanes(pane, kg, live, slot, state.max_pane,
                                  kg_dirty, state.dropped_capacity,
                                  late.get("fresh"),
                                  late.get("fired_through"),
                                  late.get("n_fresh")),
        C=C, R=R)


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
                         "key, and split planes have no spill tier")
    state.acc, state.table_keys, _slot, _ok = kernels.compact_table(
        state.acc, state.table_keys, state.pane_ids, state.ring,
        state.dropped_capacity, R=win.ring, probe_len=state.probe_len,
        neutral=red.neutral_value())
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
                new_fired_through, fresh_left=None):
    """Which ring rows purge at this advance, and the new purged_through
    (window_kernels.py:1245): a pane leaves state once every window holding
    it has fired AND the lateness horizon has passed, and (``fresh_left``,
    bool [R]) no re-fire is pending on it."""
    k = win.panes_per_window
    slide = win.slide_ticks
    L = win.lateness_ticks
    base = torch.clamp_min(wm, INT32_MIN + 1 + slide + L) - L
    wm_pane_l = _floor_div(base + 1 - slide, slide)
    cutoff = torch.minimum(new_fired_through, wm_pane_l)
    purgeable = (
        (state.pane_ids != PANE_NONE)
        & (state.pane_ids + (k - 1) <= cutoff)
        & (state.pane_ids > state.purged_through)
    )
    if fresh_left is not None:
        purgeable = purgeable & ~fresh_left
    new_purged = torch.where(
        cutoff == PANE_NONE,
        state.purged_through,
        torch.maximum(
            state.purged_through,
            torch.clamp_min(cutoff, PANE_NONE + k) - (k - 1),
        ),
    )
    return purgeable, new_purged


def _late_plan(state: WindowShardState, win: WindowSpec, new_fired_through):
    """The re-fire half of the reference's advance_and_fire (:1350-1390):
    which fired windows hold fresh panes, the first F of them (ascending
    window-end pane) as this advance's late lanes, and which fresh rows
    those lanes cover fully. The rows' fresh counts come from G2's
    fresh_rows; the rest are [R, k] and [F] torch ops. Returns sel int32
    [F] (window-end panes), sel_ok bool [F], pane_done bool [R] (fresh rows
    to clear), fresh_left bool [R] (rows still holding fresh flags) and
    n_fresh int32 0-d (the flags left)."""
    C, R = state.capacity, win.ring
    k = win.panes_per_window
    F = win.fires_per_step
    counts = kernels.fresh_rows(state.fresh, C=C, R=R)
    fresh_any = counts > 0
    j_idx = torch.arange(k, dtype=torch.int32, device=state.device)
    wc = state.pane_ids[:, None] + j_idx[None, :]               # [R, k]
    need = (fresh_any[:, None] & (state.pane_ids != PANE_NONE)[:, None]
            & (wc <= new_fired_through))
    wsort = torch.sort(torch.where(need, wc, INT32_MAX).reshape(-1)).values
    first = torch.ones_like(wsort, dtype=torch.bool)
    first[1:] = wsort[1:] != wsort[:-1]
    first = first & (wsort < INT32_MAX)
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    at = torch.where(first & (rank < F), rank, F)
    sel = torch.full((F + 1,), INT32_MAX, dtype=torch.int32,
                     device=state.device)
    sel.scatter_(0, at, wsort)
    sel = sel[:F]
    sel_ok = sel < INT32_MAX
    covered = (~need) | (wc[:, :, None] == sel[None, None, :]).any(-1)
    pane_done = covered.all(1) & fresh_any
    n_fresh = torch.where(pane_done, 0, counts).sum(dtype=torch.int32)
    return sel, sel_ok, pane_done, fresh_any & ~pane_done, n_fresh


def _generic_fire_lanes(state: WindowShardState, win: WindowSpec,
                        red: ReduceSpec, p_f, lane_ok, n_ontime=None):
    """The windows ending at panes ``p_f`` for every slot of a generic
    reduce's split planes (the reference's _eval_fire_lanes, :1203), as
    torch ops: its combine is the user's function. Returns (emit bool
    [Ft, C], values float32 [Ft, C, *value_shape]); lanes f >= ``n_ontime``
    emit by the fresh plane (re-fires)."""
    C, R, k = state.capacity, win.ring, win.panes_per_window
    vs = tuple(red.value_shape)
    a3 = state.acc.view((R, C) + vs)
    t2 = state.touched.view(R, C)
    Ft = p_f.shape[0]
    combine = red.combine_fn()
    vals = torch.as_tensor(red.neutral_value(), dtype=torch.float32).to(
        state.device).expand((Ft, C) + vs)
    emit = torch.zeros(Ft, C, dtype=torch.bool, device=state.device)
    late = torch.zeros(Ft, dtype=torch.bool, device=state.device)
    if n_ontime is not None:
        late[n_ontime:] = True
        f2 = state.fresh.view(R, C)
    for j in range(k):
        q = p_f - (k - 1) + j
        row = torch.remainder(q, R).long()
        present = lane_ok & (state.pane_ids[row] == q)
        cells = a3[row]                                   # [Ft, C, *vs]
        t = t2[row] & present[:, None]
        vals = torch.where(kernels._expand(t, cells), combine(vals, cells),
                           vals)
        emit = emit | (t if n_ontime is None else torch.where(
            late[:, None], f2[row] & present[:, None], t))
    return emit, vals.to(torch.float32).contiguous()


def _fire_lanes(state: WindowShardState, win: WindowSpec, red: ReduceSpec,
                p_f, lane_ok, out, n_ontime=None):
    """Evaluate fire lanes on the state's plane and reduce them (``out``
    None) or compact their rows into ``out``: G4 / G6 for a packed plane,
    G15 for a sketch, the user's combine in torch then G6's fire_pack for
    a generic reduce. Returns (counts int32 [Ft], value_sums float32
    [Ft])."""
    C, R, k = state.capacity, win.ring, win.panes_per_window
    plane = plane_of(red)
    if plane == "sketch":
        return kernels.sketch_fire(
            state.acc, state.touched, state.pane_ids, p_f, lane_ok,
            state.table_keys, out, C=C, R=R, k=k, red=red)
    if plane == "split":
        emit, vals = _generic_fire_lanes(state, win, red, p_f, lane_ok,
                                         n_ontime)
        return kernels.fire_pack(state.table_keys, emit, vals, lane_ok, out)
    kw = dict(C=C, R=R, k=k, op=red.op, neutral=red.neutral_value(),
              fresh=None if n_ontime is None else state.fresh,
              n_ontime=n_ontime)
    if out is None:
        return kernels.fire_reduced(state.acc, state.pane_ids, p_f, lane_ok,
                                    **kw)
    return kernels.fire_compact(state.acc, state.pane_ids, p_f, lane_ok,
                                state.table_keys, *out, **kw)


def advance_and_fire(state: WindowShardState, win: WindowSpec,
                     red: ReduceSpec, new_watermark, reduced: bool = False,
                     out=None):
    """The classic advance with allowed lateness (the reference's
    ``advance_and_fire``, :1309, followed by ``reduce_fires`` or
    ``compact_fires``): up to F due window-ends for every key, then up to F
    re-fires of fired windows that late records reached (``_late_plan``),
    each emitting only the keys whose panes are fresh, with the window's
    full value; the covered fresh rows clear, and the rows past the
    lateness horizon with no re-fire pending purge now (G2). Fires have 2F
    lanes, on-time first; compact rows go to ``out`` (``[2F, C]`` buffers,
    allocated here when None). Returns ``(state, fires)``."""
    F = win.fires_per_step
    C, R = state.capacity, win.ring
    plan = _fire_plan(state, win, new_watermark)
    sel, sel_ok, pane_done, fresh_left, n_fresh = _late_plan(
        state, win, plan["new_fired_through"])
    if not reduced and out is None:
        out = fire_row_buffers(2 * F, C, state.device, red=red)
    lane_ok = torch.cat([plan["lane_ok"], sel_ok])
    counts, vsums = _fire_lanes(
        state, win, red, torch.cat([plan["p_f"], sel]), lane_ok,
        None if reduced else out, n_ontime=F)
    window_end = torch.cat([
        plan["window_end"],
        torch.where(sel_ok, (sel + 1) * win.slide_ticks, PANE_NONE)])
    n_fires = plan["n_now"] + sel_ok.sum(dtype=torch.int32)
    purgeable, new_purged = _purge_plan(
        state, win, plan["wm"], plan["new_fired_through"], fresh_left)
    # G2: purge now, and clear the fresh rows the re-fires covered
    kernels.clear_rows(state.acc, purgeable, None, state.dropped_capacity,
                       C=C, R=R,
                       touched=state.touched if state.packed < 0 else None,
                       neutral=red.neutral_value(), fresh=state.fresh,
                       fresh_clear=pane_done)
    state.watermark.copy_(plan["wm"])                         # in place
    state.fired_through.copy_(plan["new_fired_through"])      # in place
    state.purged_through.copy_(new_purged)                    # in place
    state.n_fresh.copy_(n_fresh)                              # in place
    fires = (ReducedFires(counts, window_end, n_fires, lane_ok, vsums)
             if reduced else
             CompactFires(*out, counts, window_end, n_fires, lane_ok, vsums))
    return state, fires


def advance_and_fire_resident(state: WindowShardState, win: WindowSpec,
                              red: ReduceSpec, new_watermark,
                              reduced: bool = False, out=None):
    """Fused-fire advance of the resident drain (the reference's
    ``advance_and_fire_resident``): plan the due window-ends, evaluate them
    for every key, advance watermark / fired_through / purged_through in
    place, and return the purge row mask for the next update's sweep (or
    ``apply_pending_purge``). ``new_watermark`` is an int32 0-d tensor (or
    an int, staged here). With allowed lateness it is the classic
    ``advance_and_fire``, which purges at once: the purge mask is None.

    ``reduced=True`` reduces each lane to (count, value sum) on the device
    and returns ReducedFires. Otherwise the emitted rows are compacted into
    ``out`` — ``(key_hi, key_lo, values)``, int32 / int32 / ``[Ft, C,
    *red.out_shape]`` views of the caller's arena, allocated here when None
    — and CompactFires over them is returned. A sketch's values are the
    finalized ``red.out_shape`` of ``red.out_dtype``.

    Returns ``(state, purge_rows bool [R] or None, fires)``."""
    if win.lateness_ticks:
        state, fires = advance_and_fire(state, win, red, new_watermark,
                                        reduced=reduced, out=out)
        return state, None, fires
    plan = _fire_plan(state, win, new_watermark)
    purgeable, new_purged = _purge_plan(
        state, win, plan["wm"], plan["new_fired_through"]
    )
    if not reduced and out is None:
        out = fire_row_buffers(win.fires_per_step, state.capacity,
                               state.device, red=red)
    counts, vsums = _fire_lanes(state, win, red, plan["p_f"],
                                plan["lane_ok"], None if reduced else out)
    fires = (ReducedFires(counts, plan["window_end"], plan["n_now"],
                          plan["lane_ok"], vsums) if reduced else
             CompactFires(*out, counts, plan["window_end"], plan["n_now"],
                          plan["lane_ok"], vsums))
    state.watermark.copy_(plan["wm"])                         # in place
    state.fired_through.copy_(plan["new_fired_through"])      # in place
    state.purged_through.copy_(new_purged)                    # in place
    return state, purgeable, fires


def fire_row_buffers(*shape_and_device, red: Optional[ReduceSpec] = None):
    """Row buffers ``(key_hi, key_lo, values)`` of shape ``[..., C]`` for
    compact fires (int32, int32, and float32 values ``[..., C,
    *red.out_shape]`` of ``red.out_dtype``, ``[..., C]`` float32 without a
    ``red``), uninitialised: the kernels write only the prefixes they emit.
    ``fire_row_buffers(D, Ft, C, device, red=red)`` is one drain's arena."""
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
    """Pack dense fire planes (mask bool [F, C], values float32 [F, C, ...])
    into CompactFires (the reference's ``compact_fires`` over a
    FireResult): per lane the emitted slots in slot order, keys read from
    the table, zeros past each prefix, and the lane's value sum."""
    khi, klo, v, counts, vsums = kernels.pack_fire_lanes(table_keys, mask,
                                                         values)
    return CompactFires(khi, klo, v, counts, window_end_ticks, n_fires,
                        lane_valid, vsums)


def apply_pending_purge(state: WindowShardState, win: WindowSpec,
                        red: ReduceSpec, rows) -> WindowShardState:
    """Clear the ring rows whose purge was deferred past the end of a
    drain (G2 without an eviction count), in place; ``rows`` None (the
    lateness advance purged already) clears nothing."""
    if rows is None:
        return state
    kernels.clear_rows(state.acc, rows, None, state.dropped_capacity,
                       C=state.capacity, R=win.ring,
                       touched=state.touched if state.packed < 0 else None,
                       neutral=red.neutral_value())
    return state
