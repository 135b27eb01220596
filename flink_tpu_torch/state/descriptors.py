"""Keyed-state descriptors — the user-facing state API, a copy of
flink_tpu/state/descriptors.py on torch dtypes.

Mirrors the contracts of the reference's state API (SURVEY §2.1:
State.java:32, ValueState.java:40, ReducingState.java:38, FoldingState.java:40,
StateDescriptor.java:50): a descriptor names a state, fixes its type, and (for
reducing/aggregating kinds) carries the combine function. Types are dtypes +
trailing shapes (device columns), and combine functions must be associative
callables on torch tensors so a whole key-group shard can be updated at
once. FoldingState (deprecated in the reference line) is subsumed by
AggregatingState here. The reference's heap-only descriptors (map, list)
and its host combine are left out with its heap backend.

``WindowedStream.aggregate`` takes an ``AggregatingStateDescriptor`` (or any
object with ``to_reduce_spec()``, ``extractor`` and ``get_result``): the
accumulator lives per (key, pane) on the device as a generic reduce whose
combine is ``merge`` and whose neutral is ``acc_init``; ``get_result``
projects each fired window's accumulator on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from flink_tpu_torch.ops.window_kernels import ReduceSpec


@dataclass(frozen=True)
class StateDescriptor:
    name: str
    dtype: Any = torch.float32
    value_shape: Tuple[int, ...] = ()
    # optional per-state TypeSerializer pinning how this state's values are
    # written into snapshots (the reference's StateDescriptor.java:50)
    serializer: Any = None

    def to_reduce_spec(self) -> ReduceSpec:
        raise NotImplementedError


@dataclass(frozen=True)
class ValueStateDescriptor(StateDescriptor):
    """Single value per key; update semantics = last write wins."""

    default: Any = None

    def to_reduce_spec(self) -> ReduceSpec:
        # last-write-wins is associative: combine(a, b) = b
        return ReduceSpec(
            "generic", self.dtype, self.value_shape,
            combine=lambda a, b: b,
            neutral=self.default if self.default is not None else 0,
        )


@dataclass(frozen=True)
class ReducingStateDescriptor(StateDescriptor):
    """add(v) folds v into the accumulator with an associative reduce."""

    kind: str = "sum"  # 'sum' | 'min' | 'max' | 'count' | 'generic'
    reduce_fn: Optional[Callable] = None
    neutral: Any = None

    def to_reduce_spec(self) -> ReduceSpec:
        return ReduceSpec(
            self.kind, self.dtype, self.value_shape,
            combine=self.reduce_fn, neutral=self.neutral,
        )


@dataclass(frozen=True)
class AggregatingStateDescriptor(StateDescriptor):
    """Accumulator-style aggregation (ref AggregateFunction contract):

    add:       (acc, value) -> acc     — fold one input into the accumulator
    merge:     (acc, acc) -> acc       — associative accumulator merge
    get_result:(acc) -> out            — host-side projection

    The accumulator (not the input) is what lives per (key, pane) on device;
    value_shape/dtype describe the ACCUMULATOR columns.
    """

    add: Optional[Callable] = None
    merge: Optional[Callable] = None
    get_result: Optional[Callable] = None
    acc_init: Any = 0

    def to_reduce_spec(self) -> ReduceSpec:
        return ReduceSpec(
            "generic", self.dtype, self.value_shape,
            combine=self.merge, neutral=self.acc_init,
        )

    def create_accumulator(self):
        init = self.acc_init
        return init() if callable(init) else init


@dataclass(frozen=True)
class FoldingStateDescriptor(AggregatingStateDescriptor):
    """FoldingStateDescriptor.java:37 parity: fold(acc, value) -> acc.
    Deprecated in the reference line; an AggregatingState whose `add` is the
    fold function."""

    fold_fn: Optional[Callable] = None

    def __post_init__(self):
        if self.fold_fn is not None and self.add is None:
            object.__setattr__(self, "add", self.fold_fn)
