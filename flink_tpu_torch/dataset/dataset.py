"""DataSet API — bounded (batch) processing: a copy of
flink_tpu/dataset/dataset.py on an explicit device.

Mirrors the reference's DataSet surface (SURVEY §2.6: flink-java
DataSet.java — map/filter/flatMap/mapPartition/reduce/groupBy/aggregate/
join/coGroup/cross/union/distinct/sortPartition/first/iterate), GPU-adapted:

- datasets are LAZY plans (the role of the common-api Plan the reference
  hands to the Optimizer); collect()/count()/output() trigger evaluation
  with per-node memoization (an operator consumed by several downstream
  nodes — e.g. both sides of a join — materializes once, the DAG-sharing
  the reference's optimizer handles via plan caching);
- grouped numeric aggregation is the device path: python keys are
  dictionary-encoded host-side (np.unique) and the values reduce on the
  card in one launch of G23 (``ops/segment.py grouped_reduce``) — the
  batch analog of the streaming window kernels, replacing the reference's
  sort-based ReduceCombineDriver, as the JAX package's one XLA
  scatter-reduce does;
- joins are hash joins (build right / probe left, ref MutableHashTable
  strategy) with inner/left/right/full variants; coGroup groups both
  sides; an inner join the cost model ships broadcast-hash with unique
  int64 build keys probes on the card (G24, ``parallel/broadcast.py``);
  everything structural stays host-side Python where the reference used
  JVM driver strategies, because the FLOPs live in the aggregations.

The device is the ExecutionEnvironment's (``None``: the CUDA card; a
machine without one raises). The broadcast probe has no host fallback on
failure: it declines (returns None) only for the three shapes the
reference declines (keys that are not genuine int64, duplicate build
keys, a build side of 2^24 rows or more), and anything G24 raises
propagates. The plan text keeps the reference's "(device mesh)" tag,
which its golden plan test reads.

Iterations: bulk (ref IterativeDataSet / BulkIterationBase) and delta
(ref DeltaIterationBase: solution set keyed by K, workset driving
updates) as host loops — the reference's superstep synchronization
(IterationSynchronizationSinkTask) is the loop boundary itself.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np


def _extract(pos):
    if pos is None:
        return lambda e: e
    if callable(pos):
        return pos
    return lambda e: e[pos]


#: per-operator output-size selectivity relative to the (max) input — the
#: optimizer's size-estimation heuristics (ref Optimizer.java cost model /
#: CompilerHints; filters halve, flat_maps can expand, joins ~max side)
_SELECTIVITY = {
    "filter": 0.5,
    "flat_map": 1.5,
    "distinct": 0.7,
    "reduce": 0.0,
    "group_reduce": 0.3,
    "inner_join": 1.0,
    "left_join": 1.0,
    "right_join": 1.0,
    "full_join": 1.2,
    "cogroup_join": 0.5,
    "grouped_reduce": 0.3,
}


#: ship-strategy planner knobs (ref flink-optimizer CostEstimator /
#: Optimizer.java:396 shipping-strategy choice; overridable per
#: ExecutionEnvironment attribute of the same name)
BROADCAST_THRESHOLD_ROWS = 10_000   # a side this small may be broadcast
BROADCAST_SKEW_FACTOR = 4           # ...if the other side is ≥4x larger
HASH_MAX_BUILD_ROWS = 1_000_000     # past this, hash gives way to merge


def _decide_join_strategies(n_left: float, n_right: float, hint: str,
                            env) -> tuple:
    """(ship, local, build_left) from side sizes — the optimizer's
    shipping/local strategy assignment (ref Optimizer.java:396,
    JoinOperatorBase.JoinHint). Used with ESTIMATES at plan time and
    with exact materialized counts at run time, so EXPLAIN shows the
    same decision procedure the execution applies.

    ship:  broadcast-hash-first/second — the small side replicated to
           every parallel instance (cost ~ small * parallelism);
           repartition-hash — both sides hashed over the mesh
           (cost ~ left + right network volume).
    local: hash build-left/right, or sort-merge when neither side's
           hash table is expected to fit the build budget (the
           reference's hybrid-hash-vs-merge memory rationale).
    """
    bthresh = getattr(env, "broadcast_threshold_rows",
                      BROADCAST_THRESHOLD_ROWS)
    hmax = getattr(env, "hash_max_build_rows", HASH_MAX_BUILD_ROWS)
    skew = getattr(env, "broadcast_skew_factor", BROADCAST_SKEW_FACTOR)
    if hint == "build-left":
        ship = ("broadcast-hash-first" if n_left <= bthresh
                else "repartition-hash")
        return ship, "hash build-left (hinted)", True
    if hint == "build-right":
        ship = ("broadcast-hash-second" if n_right <= bthresh
                else "repartition-hash")
        return ship, "hash build-right (hinted)", False
    small, large = min(n_left, n_right), max(n_left, n_right)
    build_left = n_left <= n_right
    side = "first" if build_left else "second"
    if small <= bthresh and large >= skew * small:
        return (f"broadcast-hash-{side}",
                f"hash build-{'left' if build_left else 'right'}",
                build_left)
    if small > hmax:
        return "repartition-hash", "sort-merge", build_left
    return ("repartition-hash",
            f"hash build-{'left' if build_left else 'right'}",
            build_left)


class DataSet:
    def __init__(self, env, compute: Callable[[], List[Any]], name="op",
                 parents: tuple = ()):
        self.env = env
        self._compute = compute
        self._cache: Optional[List[Any]] = None
        self.name = name
        self.parents = parents
        #: strategy notes recorded by cost-based choices (explain())
        self.strategy: Optional[str] = None
        #: set on join nodes so plan() can re-derive strategies from
        #: estimates without executing
        self.join_hint: Optional[str] = None

    # -- planner ---------------------------------------------------------
    def plan(self) -> str:
        """Assign ship/local strategies to every join in the DAG from
        the cost model's ESTIMATES — without executing anything — and
        return the annotated plan (the reference optimizer's pre-flight
        plan, Optimizer.java compile() -> OptimizedPlan)."""
        def annotate(node):
            for p in node.parents:
                annotate(p)
            if node.join_hint is not None and len(node.parents) == 2:
                ship, local, _bl = _decide_join_strategies(
                    node.parents[0].estimate_size(),
                    node.parents[1].estimate_size(),
                    node.join_hint, node.env,
                )
                node.strategy = f"ship={ship}, local={local}"
        annotate(self)
        return self.explain()

    # -- evaluation ------------------------------------------------------
    def _data(self) -> List[Any]:
        if self._cache is None:
            self._cache = list(self._compute())
        return self._cache

    # -- cost model (ref flink-optimizer Optimizer.java:396) -------------
    def estimate_size(self) -> float:
        """Estimated row count WITHOUT executing: materialized caches are
        exact, sources use their declared size hint (from_collection sets
        it; file sources stay unknown until read — never forced here),
        union sums its inputs, cross multiplies, everything else applies
        per-operator selectivities to parent estimates."""
        if self._cache is not None:
            return float(len(self._cache))
        if not self.parents:
            hint = getattr(self, "size_hint", None)
            return float(hint) if hint is not None else 1000.0
        sizes = [p.estimate_size() for p in self.parents]
        if self.name == "union":
            return float(sum(sizes))
        if self.name == "cross":
            out = 1.0
            for v in sizes:
                out *= v
            return out
        return max(sizes) * _SELECTIVITY.get(self.name, 1.0)

    def explain(self, _depth: int = 0) -> str:
        """Operator tree with size estimates and chosen physical
        strategies (the reference's plan JSON / explain analog)."""
        pad = "  " * _depth
        line = f"{pad}{self.name} (est. {self.estimate_size():.0f} rows"
        if self.strategy:
            line += f", {self.strategy}"
        line += ")"
        return "\n".join(
            [line] + [p.explain(_depth + 1) for p in self.parents]
        )

    def collect(self) -> List[Any]:
        return list(self._data())

    def count(self) -> int:
        return len(self._data())

    def print_(self):
        for e in self._data():
            print(e)

    def write_as_text(self, path: str):
        from flink_tpu_torch.core.filesystem import get_filesystem

        fs, p = get_filesystem(path)
        with fs.open(p, "w") as f:
            for e in self._data():
                f.write(str(e) + "\n")

    def write_as_csv(self, path: str, delimiter: str = ","):
        """ref CsvOutputFormat: tuples/lists become delimited rows."""
        import csv as _csv

        from flink_tpu_torch.core.filesystem import get_filesystem

        fs, p = get_filesystem(path)
        with fs.open(p, "w", newline="") as f:
            w = _csv.writer(f, delimiter=delimiter)
            for e in self._data():
                w.writerow(
                    e if isinstance(e, (tuple, list)) else (e,)
                )

    def output(self, fn: Callable[[Any], None]):
        for e in self._data():
            fn(e)

    # -- element-wise ----------------------------------------------------
    def _derive(self, fn, name, *extra_parents) -> "DataSet":
        return DataSet(self.env, fn, name, parents=(self, *extra_parents))

    def map(self, fn) -> "DataSet":
        return self._derive(lambda: [fn(e) for e in self._data()], "map")

    def filter(self, fn) -> "DataSet":
        return self._derive(
            lambda: [e for e in self._data() if fn(e)], "filter"
        )

    def flat_map(self, fn) -> "DataSet":
        def run():
            out = []
            for e in self._data():
                out.extend(fn(e))
            return out

        return self._derive(run, "flat_map")

    def map_partition(self, fn) -> "DataSet":
        """fn(iterable) -> iterable over the whole partition (single
        logical partition in the host plan; ref MapPartitionFunction)."""
        return self._derive(lambda: list(fn(iter(self._data()))), "map_partition")

    # -- full-set reductions ---------------------------------------------
    def reduce(self, fn) -> "DataSet":
        def run():
            it = iter(self._data())
            try:
                acc = next(it)
            except StopIteration:
                return []
            for e in it:
                acc = fn(acc, e)
            return [acc]

        return self._derive(run, "reduce")

    def sum(self, pos=None) -> "DataSet":
        ex = _extract(pos)
        return self._derive(
            lambda: [float(np.sum([ex(e) for e in self._data()]))]
            if self._data() else [], "sum",
        )

    def min_by(self, pos=None) -> "DataSet":
        ex = _extract(pos)
        return self._derive(
            lambda: [min(self._data(), key=ex)] if self._data() else [],
            "min_by",
        )

    def max_by(self, pos=None) -> "DataSet":
        ex = _extract(pos)
        return self._derive(
            lambda: [max(self._data(), key=ex)] if self._data() else [],
            "max_by",
        )

    # -- set ops ----------------------------------------------------------
    def union(self, *others: "DataSet") -> "DataSet":
        def run():
            out = list(self._data())
            for o in others:
                out.extend(o._data())
            return out

        return self._derive(run, "union", *others)

    def distinct(self, pos=None) -> "DataSet":
        ex = _extract(pos)

        def run():
            seen, out = set(), []
            for e in self._data():
                k = ex(e)
                if k not in seen:
                    seen.add(k)
                    out.append(e)
            return out

        return self._derive(run, "distinct")

    def first(self, n: int) -> "DataSet":
        return self._derive(lambda: self._data()[:n], "first")

    def sort_partition(self, pos=None, ascending: bool = True) -> "DataSet":
        ex = _extract(pos)
        return self._derive(
            lambda: sorted(self._data(), key=ex, reverse=not ascending),
            "sort_partition",
        )

    def zip_with_index(self) -> "DataSet":
        return self._derive(
            lambda: list(enumerate(self._data())), "zip_with_index"
        )

    # -- partitioning annotations (no-ops on the single host plan) -------
    def partition_by_hash(self, pos=None) -> "DataSet":
        return self

    def rebalance(self) -> "DataSet":
        return self

    # -- keyed ------------------------------------------------------------
    def group_by(self, pos=None) -> "GroupedDataSet":
        return GroupedDataSet(self, _extract(pos))

    # -- binary -----------------------------------------------------------
    def join(self, other: "DataSet") -> "JoinBuilder":
        return JoinBuilder(self, other, "inner")

    def left_outer_join(self, other: "DataSet") -> "JoinBuilder":
        return JoinBuilder(self, other, "left")

    def right_outer_join(self, other: "DataSet") -> "JoinBuilder":
        return JoinBuilder(self, other, "right")

    def full_outer_join(self, other: "DataSet") -> "JoinBuilder":
        return JoinBuilder(self, other, "full")

    def co_group(self, other: "DataSet") -> "JoinBuilder":
        return JoinBuilder(self, other, "cogroup")

    def cross(self, other: "DataSet") -> "DataSet":
        def run():
            return [
                (a, b) for a in self._data() for b in other._data()
            ]

        return self._derive(run, "cross", other)

    # -- iterations --------------------------------------------------------
    def iterate(self, max_iterations: int,
                step: Callable[["DataSet"], "DataSet"],
                convergence: Optional[Callable[[List, List], bool]] = None,
                ) -> "DataSet":
        """Bulk iteration (ref IterativeDataSet.closeWith): applies `step`
        up to max_iterations times; optional convergence(prev, cur) stops
        early (the aggregator-based convergence criterion)."""

        def run():
            cur = self._data()
            for _ in range(max_iterations):
                nxt = step(self.env.from_collection(cur))._data()
                if convergence is not None and convergence(cur, nxt):
                    cur = nxt
                    break
                cur = nxt
            return cur

        return self._derive(run, "bulk_iteration")

    def delta_iterate(
        self, workset: "DataSet", key, max_iterations: int,
        step: Callable[["DataSet", "DataSet"], Tuple["DataSet", "DataSet"]],
    ) -> "DataSet":
        """Delta iteration (ref DeltaIterationBase): self is the initial
        solution set (keyed by `key`); `step(solution, workset)` returns
        (delta, next_workset); deltas merge into the solution by key;
        terminates when the workset empties or max_iterations is hit."""
        key_fn = _extract(key)

        def run():
            solution = {key_fn(e): e for e in self._data()}
            ws = workset._data()
            for _ in range(max_iterations):
                if not ws:
                    break
                delta, nxt_ws = step(
                    self.env.from_collection(list(solution.values())),
                    self.env.from_collection(ws),
                )
                for e in delta._data():
                    solution[key_fn(e)] = e
                ws = nxt_ws._data()
            return list(solution.values())

        return self._derive(run, "delta_iteration")


class GroupedDataSet:
    def __init__(self, ds: DataSet, key_fn: Callable):
        self.ds = ds
        self.key_fn = key_fn
        self._sort = None  # (extractor, ascending) for sorted groups

    def sort_group(self, pos=None, ascending: bool = True) -> "GroupedDataSet":
        self._sort = (_extract(pos), ascending)
        return self

    def _groups(self) -> Dict[Any, List[Any]]:
        groups: Dict[Any, List[Any]] = {}
        for e in self.ds._data():
            groups.setdefault(self.key_fn(e), []).append(e)
        if self._sort is not None:
            ex, asc = self._sort
            for g in groups.values():
                g.sort(key=ex, reverse=not asc)
        return groups

    def reduce(self, fn) -> DataSet:
        def run():
            out = []
            for g in self._groups().values():
                acc = g[0]
                for e in g[1:]:
                    acc = fn(acc, e)
                out.append(acc)
            return out

        return self.ds._derive(run, "grouped_reduce")

    def reduce_group(self, fn) -> DataSet:
        """fn(elements) -> iterable of results per group (ref
        GroupReduceFunction)."""

        def run():
            out = []
            for g in self._groups().values():
                out.extend(fn(g))
            return out

        return self.ds._derive(run, "group_reduce")

    def first(self, n: int) -> DataSet:
        return self.ds._derive(
            lambda: [e for g in self._groups().values() for e in g[:n]],
            "grouped_first",
        )

    # -- device-accelerated numeric aggregation ---------------------------
    def _segment_agg(self, pos, kind: str) -> DataSet:
        """key dictionary-encode on host, segment-reduce on device —
        the batch analog of the streaming window kernels."""
        ex = _extract(pos)

        def run():
            from flink_tpu_torch.ops.segment import grouped_reduce

            data = self.ds._data()
            if not data:
                return []
            keys = [self.key_fn(e) for e in data]
            vals = (
                np.asarray([ex(e) for e in data], np.float32)
                if kind != "count" else np.zeros(len(data))
            )
            uniq, gid = np.unique(np.asarray(keys, dtype=object),
                                  return_inverse=True)
            agg = grouped_reduce(kind, gid, vals, len(uniq),
                                 self.ds.env.device)
            return [(k, float(v)) for k, v in zip(uniq.tolist(), agg)]

        return self.ds._derive(run, f"segment_{kind}")

    def sum(self, pos=None) -> DataSet:
        return self._segment_agg(pos, "sum")

    def min(self, pos=None) -> DataSet:
        return self._segment_agg(pos, "min")

    def max(self, pos=None) -> DataSet:
        return self._segment_agg(pos, "max")

    def count(self) -> DataSet:
        return self._segment_agg(lambda e: 1.0, "count")

    def mean(self, pos=None) -> DataSet:
        return self._segment_agg(pos, "mean")

    def aggregate(self, kind: str, pos=None) -> DataSet:
        return self._segment_agg(pos, kind)

    def min_by(self, pos=None) -> DataSet:
        ex = _extract(pos)
        return self.ds._derive(
            lambda: [min(g, key=ex) for g in self._groups().values()],
            "grouped_min_by",
        )

    def max_by(self, pos=None) -> DataSet:
        ex = _extract(pos)
        return self.ds._derive(
            lambda: [max(g, key=ex) for g in self._groups().values()],
            "grouped_max_by",
        )


def _sort_merge_join(lefts, rights, k1, k2, kind, f):
    """Sort-merge local strategy (ref the optimizer's MERGE driver,
    flink-runtime operators/sort/MergeIterator + SortMergeJoinDriver
    rationale: chosen when no side's hash table fits the build budget —
    sorting spills gracefully where a hash table cannot). Returns None
    when keys don't admit a total order (mixed types): the caller falls
    back to hash and records it."""
    try:
        ls = sorted(((k1(e), e) for e in lefts), key=lambda p: p[0])
        rs = sorted(((k2(e), e) for e in rights), key=lambda p: p[0])
    except TypeError:
        return None
    out = []
    i = j = 0
    nl, nr = len(ls), len(rs)
    while i < nl and j < nr:
        kl, kr = ls[i][0], rs[j][0]
        if kl < kr:
            if kind in ("left", "full"):
                out.append(f(ls[i][1], None))
            i += 1
        elif kr < kl:
            if kind in ("right", "full"):
                out.append(f(None, rs[j][1]))
            j += 1
        else:
            # equal-key group: emit the cross product of both runs
            i2 = i
            while i2 < nl and ls[i2][0] == kl:
                i2 += 1
            j2 = j
            while j2 < nr and rs[j2][0] == kr:
                j2 += 1
            for a in range(i, i2):
                for b in range(j, j2):
                    out.append(f(ls[a][1], rs[b][1]))
            i, j = i2, j2
    if kind in ("left", "full"):
        out.extend(f(ls[a][1], None) for a in range(i, nl))
    if kind in ("right", "full"):
        out.extend(f(None, rs[b][1]) for b in range(j, nr))
    return out


def _device_broadcast_join(lefts, rights, k1, k2, build_left, f, device):
    """Physical broadcast ship on the card for the common fast case:
    INNER join, unique integer build keys. On one device the build side
    is every shard's copy, and G24 probes the whole stream
    (parallel/broadcast.py — the accelerator form of
    BROADCAST_HASH_FIRST/SECOND's copy-to-every-subtask). The kernel
    returns per-probe build-row INDICES, so arbitrary Python payloads
    join host-side from the positions. Returns None when the shape
    doesn't qualify (caller keeps the host hash path): keys that are not
    genuine int64, duplicate build keys, or a build side of 2^24 rows or
    more. A failure of the probe itself raises."""
    build, probe = (lefts, rights) if build_left else (rights, lefts)
    bk, pk = (k1, k2) if build_left else (k2, k1)
    if len(build) == 0 or len(probe) == 0:
        return []
    try:
        bkeys = np.asarray([bk(e) for e in build])
        pkeys = np.asarray([pk(e) for e in probe])
    except (TypeError, ValueError, OverflowError):
        return None
    # GENUINE int64 keys only: float keys would silently truncate
    # (1.5 'matching' 1), big ints / mixed types land as object dtype
    if bkeys.dtype.kind != "i" or pkeys.dtype.kind != "i":
        return None
    bkeys = bkeys.astype(np.int64)
    pkeys = pkeys.astype(np.int64)
    if len(np.unique(bkeys)) != len(bkeys):
        return None                     # duplicate build keys: host path
    # payload = build-row index; float32 is exact through 2^24
    if len(build) >= (1 << 24):
        return None
    from flink_tpu_torch.parallel.broadcast import broadcast_join

    idx, hit = broadcast_join(
        pkeys, bkeys, np.arange(len(build), dtype=np.float32),
        device=device)
    out = []
    pos = idx.astype(np.int64)
    for i in np.nonzero(hit)[0]:
        b, p = build[int(pos[i])], probe[int(i)]
        out.append(f(b, p) if build_left else f(p, b))
    return out


class JoinBuilder:
    """a.join(b).where(k1).equal_to(k2).apply(fn) — hash-join execution
    with COST-BASED build-side selection (ref Optimizer.java:396 picking
    HASH_BUILD_FIRST vs HASH_BUILD_SECOND from size estimates, and the
    JoinHint the user may force): the hash table is built over the side
    estimated smaller, probed from the larger. Outer joins keep their
    side semantics regardless of the physical build side."""

    def __init__(self, left: DataSet, right: DataSet, kind: str):
        self.left, self.right, self.kind = left, right, kind
        self.k1 = self.k2 = None
        self.hint = "auto"   # auto | build-left | build-right

    def where(self, pos=None) -> "JoinBuilder":
        self.k1 = _extract(pos)
        return self

    def equal_to(self, pos=None) -> "JoinBuilder":
        self.k2 = _extract(pos)
        return self

    def with_hint(self, hint: str) -> "JoinBuilder":
        """ref JoinOperatorBase.JoinHint (BROADCAST_HASH_FIRST/SECOND):
        force the build side instead of the cost model's choice."""
        if hint not in ("auto", "build-left", "build-right"):
            raise ValueError(f"unknown join hint {hint!r}")
        self.hint = hint
        return self

    def apply(self, fn: Optional[Callable] = None) -> DataSet:
        if self.k1 is None or self.k2 is None:
            raise ValueError("join requires where(...).equal_to(...)")
        k1, k2, kind = self.k1, self.k2, self.kind
        node_holder = []

        def run():
            lefts, rights = self.left._data(), self.right._data()
            out = []
            if kind == "cogroup":
                build: Dict[Any, List[Any]] = {}
                for r in rights:
                    build.setdefault(k2(r), []).append(r)
                probe: Dict[Any, List[Any]] = {}
                for l in lefts:
                    probe.setdefault(k1(l), []).append(l)
                f = fn or (lambda ls, rs: [(ls, rs)])
                for k in {**build, **probe}:
                    out.extend(f(probe.get(k, []), build.get(k, [])))
                return out
            # strategy decision with EXACT sizes (both inputs are
            # materialized just above) through the same procedure the
            # plan-time estimate pass uses
            ship, local, build_left = _decide_join_strategies(
                len(lefts), len(rights), self.hint,
                self.left.env,
            )
            f = fn or (lambda l, r: (l, r))
            if local == "sort-merge":
                merged = _sort_merge_join(lefts, rights, k1, k2, kind, f)
                if merged is not None:
                    if node_holder:
                        node_holder[0].strategy = \
                            f"ship={ship}, local=sort-merge"
                    return merged
                local = (f"hash build-"
                         f"{'left' if build_left else 'right'} "
                         f"(keys unsortable)")
            if ship.startswith("broadcast-hash") and kind == "inner":
                dev = _device_broadcast_join(
                    lefts, rights, k1, k2, build_left, f,
                    self.left.env.device)
                if dev is not None:
                    if node_holder:
                        node_holder[0].strategy = (
                            f"ship={ship} (device mesh), local={local}")
                    return dev
            if node_holder:
                node_holder[0].strategy = f"ship={ship}, local={local}"
            if build_left:
                build = {}
                for l in lefts:
                    build.setdefault(k1(l), []).append(l)
                matched = set()
                for r in rights:
                    key = k2(r)
                    ls = build.get(key)
                    if ls:
                        matched.add(key)
                        out.extend(f(l, r) for l in ls)
                    elif kind in ("right", "full"):
                        out.append(f(None, r))
                if kind in ("left", "full"):
                    for key, ls in build.items():
                        if key not in matched:
                            out.extend(f(l, None) for l in ls)
            else:
                build = {}
                for r in rights:
                    build.setdefault(k2(r), []).append(r)
                matched = set()
                for l in lefts:
                    key = k1(l)
                    rs = build.get(key)
                    if rs:
                        matched.add(key)
                        out.extend(f(l, r) for r in rs)
                    elif kind in ("left", "full"):
                        out.append(f(l, None))
                if kind in ("right", "full"):
                    for key, rs in build.items():
                        if key not in matched:
                            out.extend(f(None, r) for r in rs)
            return out

        node = self.left._derive(run, f"{kind}_join", self.right)
        if kind != "cogroup":          # cogroup never consults ship/local
            node.join_hint = self.hint  # plan() re-derives from estimates
        node_holder.append(node)
        return node

    # joining without a function yields (left, right) pairs, matching the
    # reference's DefaultJoin
    def project(self) -> DataSet:
        return self.apply(None)
