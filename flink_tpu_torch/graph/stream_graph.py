"""Transformation DAG recorded by the DataStream API.

Role of the reference's StreamTransformation / StreamGraph /
StreamingJobGraphGenerator chain (SURVEY §2.5): API calls record immutable
nodes; at execute() the graph is translated into pipeline *stages*. Where the
reference fuses chainable operators into JobVertex chains
(StreamingJobGraphGenerator.createChain:172), we fuse every stateless host op
between two keyed boundaries into one chain list, and each keyed window
aggregation into one compiled SPMD stage — the TPU analog of operator
chaining (fusion happens again, at the XLA level, inside the stage).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

_ids = itertools.count()


@dataclass
class Transformation:
    name: str
    parent: Optional["Transformation"] = None
    id: int = field(default_factory=lambda: next(_ids))


@dataclass
class SourceTransformation(Transformation):
    source: Any = None  # runtime.sources.Source


@dataclass
class OneInputTransformation(Transformation):
    kind: str = "map"  # map | filter | flat_map | process
    fn: Callable = None


@dataclass
class TimestampsWatermarksTransformation(Transformation):
    timestamp_fn: Callable = None   # element -> epoch ms
    strategy: Any = None            # runtime.watermarks.WatermarkStrategy


@dataclass
class KeyByTransformation(Transformation):
    key_selector: Callable = None


@dataclass
class WindowAggTransformation(Transformation):
    assigner: Any = None            # window.assigners.WindowAssigner
    extractor: Callable = None      # element -> numeric value (host)
    reduce_spec_factory: Callable = None  # () -> ReduceSpec
    result_fn: Optional[Callable] = None  # acc -> output value (host, vectorized)
    value_prep: Optional[Callable] = None  # raw values array -> device values
    allowed_lateness_ms: int = 0
    # custom trigger/evictor/raw-elements function route the stage to the
    # generic host window operator instead of the device kernels
    trigger: Any = None             # window.triggers.Trigger
    evictor: Any = None             # window.evictors.Evictor
    window_fn: Optional[Callable] = None  # (key, window, elements) -> iter


@dataclass
class KeyedProcessTransformation(Transformation):
    """Keyed rolling aggregation (StreamGroupedReduce analog)."""

    reduce_spec_factory: Callable = None
    extractor: Callable = None
    result_fn: Optional[Callable] = None


@dataclass
class ProcessTransformation(Transformation):
    """Keyed ProcessFunction stage (host generality path: arbitrary user
    logic over heap keyed state + timers; ref StreamTimelyFlatMap)."""

    fn: Any = None  # datastream.functions.ProcessFunction


@dataclass
class SinkTransformation(Transformation):
    sink: Any = None  # runtime.sinks.Sink


@dataclass
class UnionTransformation(Transformation):
    """N-input merge (ref DataStream.union / the TaggedUnion lowering the
    reference uses for ConnectedStreams and CoGroupedStreams —
    CoGroupedStreams.java WithWindow.apply builds union + WindowOperator).

    `parent` stays None; the executor recursively translates each branch in
    `parents` into (source, chain, ts) and merges them with a MergedSource.
    When `tagged`, elements are wrapped as Tagged(tag, value) so downstream
    co-operators can dispatch per input.
    """

    parents: List[Transformation] = field(default_factory=list)
    tagged: bool = False


@dataclass
class IterateTransformation(Transformation):
    """Streaming iteration head (ref IterativeStream / StreamIterationHead +
    StreamIterationTail connected by BlockingQueueBroker, SURVEY §2.5).
    `queue` is the in-process feedback channel: close_with attaches a hidden
    QueueSink branch writing into it, and the head source drains it after
    the upstream is exhausted. Terminates when the feedback drains (the
    finite-source adaptation of the reference's iteration-wait timeout)."""

    queue: Any = None  # collections.deque shared with the feedback QueueSink
    max_wait_ms: int = 0  # accepted for API parity; drain-based termination


@dataclass
class PartitionTransformation(Transformation):
    """Explicit exchange annotation (ref Rebalance/Rescale/Shuffle/Broadcast/
    Global/ForwardPartitioner, SURVEY §2.5). On this architecture the
    keyed all_to_all inside the compiled SPMD step is the main physical
    exchange. Single-host, non-keyed repartitioning of the host
    micro-batch stream is a no-op (one host loop feeds the whole mesh)
    and the annotation is recorded for graph fidelity. On the MULTI-HOST
    path (dcn.coordinator configured), rebalance/shuffle/global are
    PHYSICAL at the ingestion edge: rebalance borrows ring-neighbor
    backlog into spare lanes, shuffle routes every record to a uniformly
    random host via the targeted ring, global routes everything to host
    0 (runtime/dcn.py _RebalanceRing/_TargetRing; executor._run_dcn
    reads the annotation). rescale stays host-local by definition."""

    mode: str = "rebalance"  # rebalance|rescale|shuffle|broadcast|global|forward


def lineage(t: Transformation) -> List[Transformation]:
    """Walk parents to the source (or union head), returning [head, ..., t]."""
    chain = []
    cur = t
    while cur is not None:
        chain.append(cur)
        cur = cur.parent
    return list(reversed(chain))


def walk_dag(sinks) -> List[Transformation]:
    """Every transformation reachable from `sinks`, topologically ordered
    (all inputs precede their node). The ONE reachability walk shared by
    the web plan handler and the ExecutionGraph builder, so the two
    views cannot disagree on the node set (ref StreamGraph traversal)."""
    order: List[Transformation] = []
    seen = set()

    def walk(t):
        if t is None or t.id in seen:
            return
        seen.add(t.id)
        for p in parents_of(t):
            walk(p)
        order.append(t)

    for s in sinks:
        walk(s)
    return order


def parents_of(t: Transformation) -> List[Transformation]:
    """All upstream transformations (single parent + union parents)."""
    out = [t.parent] if getattr(t, "parent", None) is not None else []
    out += list(getattr(t, "parents", []) or [])
    return out
