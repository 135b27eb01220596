"""Table API + minimal SQL — a copy of flink_tpu/table/table.py (the
flink-table analog, SURVEY §2.7), columnar-native, on an explicit device.

A Table IS a dict of equal-length numpy columns (the Row batch), and every
relational operator is a vectorized array program: selections are boolean
masks, projections are column arithmetic, grouped aggregations
dictionary-encode keys on the host and reduce each aggregate on the card
in one launch of G23 (``ops/segment.py grouped_reduce``), as the
reference reduces it with one XLA scatter.

The port's difference: ``TableEnvironment.create(device=None)`` and every
``Table`` carry the device their aggregates run on. ``None`` means the
CUDA card, and a machine without one raises (``core/device.py``); pass
``device="cpu"`` to run G23's plain PyTorch version. Tables derived from
a table keep its device.

Expression DSL:    col("a") + 1, (col("a") > 5) & (col("b") == "x"),
                   col("a").sum.alias("total")
SQL subset:        SELECT ... FROM t [JOIN u ON t.k = u.k] [WHERE ...]
                   [GROUP BY ...] [ORDER BY ... [DESC]] [LIMIT n]
                   (JOIN: equi-joins, INNER/LEFT/RIGHT/FULL, lowered to the
                   columnar hash join; select columns post-join by their
                   bare names, right-side clashes as r_<name>)
The SQL front-end parses via Python's ast over translated operators —
deliberately small, covering the SELECT shape the reference's examples use.
Streaming GROUP BY over event-time windows lives in
table/streaming.py (StreamTableEnvironment: TUMBLE/HOP/SESSION).
"""

from __future__ import annotations

import ast
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

_AGGS = ("sum", "avg", "min", "max", "count")


class Expr:
    """Column expression tree evaluated against a column dict."""

    def __init__(self, fn: Callable[[Dict[str, np.ndarray], int], np.ndarray],
                 name: str, agg: Optional[Tuple[str, "Expr"]] = None):
        self._fn = fn
        self.name = name
        self.agg = agg          # ('sum', inner) for aggregate expressions

    def eval(self, cols: Dict[str, np.ndarray], n: int) -> np.ndarray:
        return self._fn(cols, n)

    def alias(self, name: str) -> "Expr":
        e = Expr(self._fn, name, self.agg)
        return e

    # -- operators -------------------------------------------------------
    def _bin(self, other, op, sym):
        o = other if isinstance(other, Expr) else lit(other)
        return Expr(
            lambda c, n: op(self.eval(c, n), o.eval(c, n)),
            f"({self.name}{sym}{o.name})",
        )

    def __add__(self, o):
        return self._bin(o, lambda a, b: a + b, "+")

    def __radd__(self, o):
        return lit(o)._bin(self, lambda a, b: a + b, "+")

    def __sub__(self, o):
        return self._bin(o, lambda a, b: a - b, "-")

    def __rsub__(self, o):
        return lit(o)._bin(self, lambda a, b: a - b, "-")

    def __mul__(self, o):
        return self._bin(o, lambda a, b: a * b, "*")

    def __rmul__(self, o):
        return lit(o)._bin(self, lambda a, b: a * b, "*")

    def __truediv__(self, o):
        return self._bin(o, lambda a, b: a / b, "/")

    def __mod__(self, o):
        return self._bin(o, lambda a, b: a % b, "%")

    def __gt__(self, o):
        return self._bin(o, lambda a, b: a > b, ">")

    def __ge__(self, o):
        return self._bin(o, lambda a, b: a >= b, ">=")

    def __lt__(self, o):
        return self._bin(o, lambda a, b: a < b, "<")

    def __le__(self, o):
        return self._bin(o, lambda a, b: a <= b, "<=")

    def __eq__(self, o):  # noqa: A003
        return self._bin(o, lambda a, b: a == b, "==")

    def __ne__(self, o):
        return self._bin(o, lambda a, b: a != b, "!=")

    def __and__(self, o):
        return self._bin(o, lambda a, b: a & b, "&")

    def __or__(self, o):
        return self._bin(o, lambda a, b: a | b, "|")

    def __invert__(self):
        return Expr(lambda c, n: ~self.eval(c, n), f"~{self.name}")

    def __hash__(self):
        return id(self)

    # -- aggregates ------------------------------------------------------
    def _mk_agg(self, kind: str) -> "Expr":
        return Expr(self._fn, f"{kind}_{self.name}", agg=(kind, self))

    @property
    def sum(self) -> "Expr":
        return self._mk_agg("sum")

    @property
    def avg(self) -> "Expr":
        return self._mk_agg("avg")

    @property
    def min(self) -> "Expr":  # noqa: A003
        return self._mk_agg("min")

    @property
    def max(self) -> "Expr":  # noqa: A003
        return self._mk_agg("max")

    @property
    def count(self) -> "Expr":
        return self._mk_agg("count")


def col(name: str) -> Expr:
    return Expr(lambda c, n, _k=name: c[_k], name)


def lit(v: Any) -> Expr:
    return Expr(lambda c, n, _v=v: np.full(n, _v), repr(v))


# -- scalar function catalog (the Calcite operator-table slice the
# reference's examples use; flink-table/.../codegen/calls/ScalarOperators.
# scala generates Janino for these — here each is one vectorized numpy op)
def _str_map(fn):
    ufn = np.frompyfunc(fn, 1, 1)

    def apply(a):
        return ufn(np.asarray(a, object))

    return apply


def _like_to_re(pat: str):
    out = []
    for ch in pat:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


_MS = {"second": 1000, "minute": 60_000, "hour": 3_600_000,
       "day": 86_400_000}


def _extract(unit: str, ms):
    """EXTRACT(unit FROM epoch_ms) — temporal field access in UTC (ref
    Calcite EXTRACT lowering in ScalarOperators.scala)."""
    import datetime as _dt

    unit = unit.lower()
    if unit not in ("year", "month", "day", "hour", "minute", "second"):
        raise ValueError(f"EXTRACT unit {unit!r} unsupported")
    arr = np.asarray(ms, np.int64)

    def one(v):
        d = _dt.datetime.fromtimestamp(v / 1000, _dt.timezone.utc)
        return getattr(d, unit)

    return np.frompyfunc(one, 1, 1)(arr).astype(np.int64)


def _fn1(name, f):
    def make(a: Expr) -> Expr:
        return Expr(lambda c, n: f(a.eval(c, n)), f"{name}({a.name})")

    return make


_SCALAR_FNS: Dict[str, Callable] = {
    # arithmetic
    "abs": _fn1("ABS", np.abs),
    "round": _fn1("ROUND", np.round),
    "floor": _fn1("FLOOR", np.floor),
    "ceil": _fn1("CEIL", np.ceil),
    "sqrt": _fn1("SQRT", np.sqrt),
    "exp": _fn1("EXP", np.exp),
    "ln": _fn1("LN", np.log),
    "log10": _fn1("LOG10", np.log10),
    # string
    "upper": _fn1("UPPER", _str_map(lambda s: s.upper())),
    "lower": _fn1("LOWER", _str_map(lambda s: s.lower())),
    "trim": _fn1("TRIM", _str_map(lambda s: s.strip())),
    "length": _fn1("LENGTH", lambda a: np.asarray(
        [len(s) for s in np.asarray(a, object)], np.int64
    )),
}


def power(a: Expr, b: Expr) -> Expr:
    return Expr(lambda c, n: np.power(a.eval(c, n), b.eval(c, n)),
                f"POWER({a.name},{b.name})")


def concat(*parts: Expr) -> Expr:
    def f(c, n):
        evs = [np.asarray(p.eval(c, n), object) for p in parts]
        out = evs[0]
        for e in evs[1:]:
            out = np.asarray(
                [str(x) + str(y) for x, y in zip(out, e)], object
            )
        return out

    return Expr(f, f"CONCAT({','.join(p.name for p in parts)})")


def substring(a: Expr, start: Expr, length: Optional[Expr] = None) -> Expr:
    def f(c, n):
        s0 = np.asarray(start.eval(c, n), np.int64)
        ln = (np.asarray(length.eval(c, n), np.int64)
              if length is not None else None)
        vals = np.asarray(a.eval(c, n), object)
        out = []
        for i, s in enumerate(vals):
            b = max(0, int(s0[i]) - 1)          # SQL: 1-based
            out.append(
                s[b:b + int(ln[i])] if ln is not None else s[b:]
            )
        return np.asarray(out, object)

    return Expr(f, f"SUBSTRING({a.name})")


def like(a: Expr, pattern: str) -> Expr:
    rx = _like_to_re(pattern)

    def f(c, n):
        return np.asarray(
            [bool(rx.match(str(s))) for s in np.asarray(a.eval(c, n), object)]
        )

    return Expr(f, f"({a.name} LIKE {pattern!r})")


def if_(cond: Expr, then: Expr, else_: Expr) -> Expr:
    return Expr(
        lambda c, n: np.where(cond.eval(c, n), then.eval(c, n),
                              else_.eval(c, n)),
        f"IF({cond.name},{then.name},{else_.name})",
    )


from flink_tpu_torch.core.device import resolve_device  # noqa: E402
from flink_tpu_torch.ops.segment import grouped_reduce as _segment  # noqa: E402
# (G23, the same kernel the DataSet group_by path uses)


def join_output_names(lschema, rschema, lks, rks) -> Dict[str, str]:
    """Right-column -> post-join name, shared by plan-time schema
    inference (TableEnvironment._build_logical) and the join executors
    so the two can never drift: merged key columns (same-named equi key)
    are absent (the left column carries them), clashing names get the
    ``r_`` prefix."""
    out_names = set(lschema)
    mapping: Dict[str, str] = {}
    for k in rschema:
        if k in rks and lks[rks.index(k)] == k:
            continue
        name = k if k not in out_names else f"r_{k}"
        mapping[k] = name
        out_names.add(name)
    return mapping


class Table:
    def __init__(self, cols: Dict[str, np.ndarray], device=None):
        self.device = resolve_device(device)
        self.cols = {k: np.asarray(v) for k, v in cols.items()}
        ns = {len(v) for v in self.cols.values()}
        if len(ns) > 1:
            raise ValueError("ragged columns")
        self.n = ns.pop() if ns else 0

    # -- info ------------------------------------------------------------
    @property
    def schema(self) -> List[str]:
        return list(self.cols)

    def count(self) -> int:
        return self.n

    def to_rows(self) -> List[tuple]:
        names = self.schema
        return list(zip(*[self.cols[c].tolist() for c in names]))

    def to_dicts(self) -> List[dict]:
        names = self.schema
        return [dict(zip(names, r)) for r in self.to_rows()]

    # -- relational ops --------------------------------------------------
    def select(self, *exprs) -> "Table":
        exprs = [col(e) if isinstance(e, str) else e for e in exprs]
        if any(e.agg for e in exprs):
            # global aggregation (no grouping): one group
            return self._aggregate(None, exprs)
        return Table({e.name: e.eval(self.cols, self.n) for e in exprs},
                     self.device)

    def where(self, pred: Expr) -> "Table":
        mask = np.asarray(pred.eval(self.cols, self.n), bool)
        return Table({k: v[mask] for k, v in self.cols.items()}, self.device)

    filter = where  # noqa: A003

    def group_by(self, *keys: str) -> "GroupedTable":
        return GroupedTable(self, [
            k.name if isinstance(k, Expr) else k for k in keys
        ])

    def _aggregate(self, keys: Optional[List[str]], exprs) -> "Table":
        if keys:
            key_arrays = [self.cols[k] for k in keys]
            rows = list(zip(*[a.tolist() for a in key_arrays]))
            # dict-based grouping (insertion order): np.unique cannot sort
            # object rows containing None (outer-join gaps) — SQL groups
            # NULL keys as their own group
            first: Dict[tuple, int] = {}
            gid = np.empty(self.n, np.int64)
            for i, r in enumerate(rows):
                g = first.setdefault(r, len(first))
                gid[i] = g
            uniq = list(first)
            G = len(uniq)
            out: Dict[str, np.ndarray] = {}
            for i, k in enumerate(keys):
                out[k] = np.asarray([u[i] for u in uniq])
        else:
            gid = np.zeros(self.n, np.int64)
            G = 1
            out = {}
        for e in exprs:
            if e.agg is None:
                if keys and e.name in keys:
                    continue
                raise ValueError(
                    f"non-aggregate column {e.name!r} outside GROUP BY keys"
                )
            kind, inner = e.agg
            vals = (
                inner.eval(self.cols, self.n) if kind != "count"
                else np.zeros(self.n)
            )
            out[e.name] = _segment(kind, gid, vals, G, self.device)
        return Table(out, self.device)

    def join(self, other: "Table", left_key,
             right_key=None, how: str = "inner",
             residual: Optional[Expr] = None,
             _plan: Optional[List[str]] = None) -> "Table":
        """Hash join, single or composite keys (pass lists for multi-key
        ON conjuncts). For INNER joins the hash table is BUILT over the
        smaller side (the reference's cost-based build-side choice,
        JoinOperatorBase.JoinHint OPTIMIZER_CHOOSES); outer joins keep
        the right side as build (their missing-row bookkeeping is
        side-specific). `residual` filters the joined rows — the
        non-equi remainder of a composite ON clause."""
        if how not in ("inner", "left", "right", "full"):
            raise ValueError(f"unsupported join type {how!r}")
        lks = [left_key] if isinstance(left_key, str) else list(left_key)
        rks = (
            [right_key] if isinstance(right_key, str)
            else list(right_key) if right_key is not None else list(lks)
        )
        if len(lks) != len(rks):
            raise ValueError("left/right join key counts differ")

        def keyrows(t: "Table", names):
            arrays = [t.cols[k].tolist() for k in names]
            return (
                list(zip(*arrays)) if len(arrays) > 1 else arrays[0]
            )

        lrows = keyrows(self, lks)
        rrows = keyrows(other, rks)
        # cost-based build side: probe the bigger input, hash the smaller
        build_left = how == "inner" and self.n < other.n
        if _plan is not None:
            _plan.append(
                f"HashJoin(how={how}, keys={list(zip(lks, rks))}, "
                f"build={'left' if build_left else 'right'}"
                f"[{self.n if build_left else other.n} rows], "
                f"probe={other.n if build_left else self.n} rows"
                + (f", residual={residual.name}" if residual is not None
                   else "") + ")"
            )
        li, ri = [], []
        if build_left:
            build: Dict[Any, List[int]] = {}
            for i, v in enumerate(lrows):
                build.setdefault(v, []).append(i)
            for j, v in enumerate(rrows):
                for i in build.get(v, ()):
                    li.append(i)
                    ri.append(j)
        else:
            build = {}
            for j, v in enumerate(rrows):
                build.setdefault(v, []).append(j)
            matched_right = set()
            for i, v in enumerate(lrows):
                rows = build.get(v)
                if rows:
                    matched_right.add(v)
                    for j in rows:
                        li.append(i)
                        ri.append(j)
                elif how in ("left", "full"):
                    li.append(i)
                    ri.append(-1)
            if how in ("right", "full"):
                for v, rows in build.items():
                    if v not in matched_right:
                        for j in rows:
                            li.append(-1)
                            ri.append(j)
        li = np.asarray(li, np.int64)
        ri = np.asarray(ri, np.int64)

        def take(v, idx):
            t = v[np.maximum(idx, 0)]
            return np.where(idx >= 0, t, None) if (idx < 0).any() else t

        out = {k: take(v, li) for k, v in self.cols.items()}
        names = join_output_names(list(self.cols), list(other.cols),
                                  lks, rks)
        for k, v in other.cols.items():
            if k not in names:
                # shared key column: fill left-side gaps from the right
                out[k] = np.where(li >= 0, out[k], take(v, ri))
                continue
            out[names[k]] = take(v, ri)
        joined = Table(out, self.device)
        if residual is not None:
            joined = joined.where(residual)
        return joined

    def cross_join(self, other: "Table",
                   residual: Optional[Expr] = None,
                   _plan: Optional[List[str]] = None) -> "Table":
        """Nested-loop product for joins with NO equi conjunct (pure
        theta joins, ref NestedLoopJoin); `residual` is the ON predicate."""
        li = np.repeat(np.arange(self.n, dtype=np.int64), other.n)
        ri = np.tile(np.arange(other.n, dtype=np.int64), self.n)
        if _plan is not None:
            _plan.append(
                f"NestedLoopJoin({self.n}x{other.n} rows"
                + (f", on={residual.name}" if residual is not None else "")
                + ")"
            )
        out = {k: v[li] for k, v in self.cols.items()}
        names = join_output_names(list(self.cols), list(other.cols),
                                  [], [])
        for k, v in other.cols.items():
            out[names[k]] = v[ri]
        joined = Table(out, self.device)
        if residual is not None:
            joined = joined.where(residual)
        return joined

    def order_by(self, key: str, ascending: bool = True) -> "Table":
        k = key.name if isinstance(key, Expr) else key
        vals = self.cols[k]
        if vals.dtype == object and any(v is None for v in vals.tolist()):
            # outer joins produce None gaps: sort non-null values, NULLS
            # LAST (the SQL default for ascending order)
            none_mask = np.asarray([v is None for v in vals.tolist()])
            idx_non = np.nonzero(~none_mask)[0]
            idx_non = idx_non[np.argsort(vals[idx_non], kind="stable")]
            if not ascending:
                idx_non = idx_non[::-1]
            idx = np.concatenate([idx_non, np.nonzero(none_mask)[0]])
        else:
            idx = np.argsort(vals, kind="stable")
            if not ascending:
                idx = idx[::-1]
        return Table({c: v[idx] for c, v in self.cols.items()}, self.device)

    def limit(self, n: int) -> "Table":
        return Table({c: v[:n] for c, v in self.cols.items()}, self.device)

    def union_all(self, other: "Table") -> "Table":
        return Table({
            c: np.concatenate([self.cols[c], other.cols[c]])
            for c in self.schema
        }, self.device)

    def distinct(self) -> "Table":
        rows = self.to_rows()
        seen, keep = set(), []
        for i, r in enumerate(rows):
            if r not in seen:
                seen.add(r)
                keep.append(i)
        idx = np.asarray(keep, np.int64)
        return Table({c: v[idx] for c, v in self.cols.items()}, self.device)


class GroupedTable:
    def __init__(self, table: Table, keys: List[str]):
        self.table = table
        self.keys = keys

    def select(self, *exprs) -> Table:
        exprs = [col(e) if isinstance(e, str) else e for e in exprs]
        return self.table._aggregate(self.keys, exprs)


class TableEnvironment:
    """ref BatchTableEnvironment: table registry + SQL entry point."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._tables: Dict[str, Table] = {}

    @staticmethod
    def create(device=None) -> "TableEnvironment":
        return TableEnvironment(device)

    def from_columns(self, cols: Dict[str, Sequence]) -> Table:
        return Table({k: np.asarray(v) for k, v in cols.items()},
                     self.device)

    def from_rows(self, rows: List[tuple], names: List[str]) -> Table:
        arrays = list(zip(*rows)) if rows else [[] for _ in names]
        return Table({n: np.asarray(a) for n, a in zip(names, arrays)},
                     self.device)

    def from_dataset(self, ds, names: List[str]) -> Table:
        return self.from_rows(ds.collect(), names)

    def register_table(self, name: str, table: Table):
        self._tables[name] = table

    def scan(self, name: str) -> Table:
        return self._tables[name]

    # -- SQL subset ------------------------------------------------------
    _SQL = re.compile(
        r"^\s*SELECT\s+(?P<select>.+?)\s+FROM\s+(?P<from>\w+)"
        r"(?:\s+(?P<jhow>INNER|LEFT(?:\s+OUTER)?|RIGHT(?:\s+OUTER)?"
        r"|FULL(?:\s+OUTER)?)?\s*JOIN\s+(?P<jtable>\w+)\s+ON\s+"
        r"(?P<on>.+?))?"
        r"(?:\s+WHERE\s+(?P<where>.+?))?"
        r"(?:\s+GROUP\s+BY\s+(?P<group>.+?))?"
        r"(?:\s+HAVING\s+(?P<having>.+?))?"
        r"(?:\s+ORDER\s+BY\s+(?P<order>.+?))?"
        r"(?:\s+LIMIT\s+(?P<limit>\d+))?\s*;?\s*$",
        re.IGNORECASE | re.DOTALL,
    )

    def _analyze_on(self, ft: str, jt: str, on_sql: str, how: str,
                    lschema: List[str], rschema: List[str]):
        """ON condition -> equi conjuncts (composite hash-join keys) +
        residual predicate (the non-equi remainder, filtered post-join,
        rewritten to post-join column names). No equi conjunct at all
        lowers to the nested-loop product (inner only) — ref
        FlinkPlannerImpl's join condition split between hash-join keys
        and the remaining filter. Returns (lks, rks, residual_sql,
        clash)."""

        def side_of(ref: str) -> Optional[str]:
            if "." in ref:
                qual = ref.split(".")[0]
                if qual not in (ft, jt):
                    raise ValueError(
                        f"ON qualifier {qual!r} names neither "
                        f"{ft!r} nor {jt!r}"
                    )
                return "left" if qual == ft else "right"
            return None

        conjuncts = re.split(r"\s+AND\s+", on_sql, flags=re.IGNORECASE)
        lks, rks, residual_parts = [], [], []
        for cj in conjuncts:
            m = re.fullmatch(
                r"\s*(\w+(?:\.\w+)?)\s*=\s*(\w+(?:\.\w+)?)\s*", cj
            )
            if m:
                refs = [m.group(1), m.group(2)]
                sides = [side_of(r) for r in refs]
                cols_ = [r.split(".")[-1] for r in refs]
                if sides[0] == sides[1] and sides[0] is not None:
                    residual_parts.append(cj)    # same-side equality
                    continue
                if "left" in sides:
                    i = sides.index("left")
                    lk, rk = cols_[i], cols_[1 - i]
                elif "right" in sides:
                    i = sides.index("right")
                    rk, lk = cols_[i], cols_[1 - i]
                else:
                    lk, rk = cols_
                    if lk not in lschema and rk in lschema:
                        lk, rk = rk, lk
                lks.append(lk)
                rks.append(rk)
            else:
                residual_parts.append(cj)

        clash = (set(lschema) & set(rschema)) - {
            rk for lk, rk in zip(lks, rks) if lk == rk
        }
        residual_sql = None
        if residual_parts:
            # rewrite qualified refs to post-join column names: left
            # names stay bare, clashing right names carry the r_ prefix

            def rw(s: str) -> str:
                def sub(m):
                    qual, name = m.group(1), m.group(2)
                    if qual == jt and name in clash:
                        return f"r_{name}"
                    return name

                # identifiers only: a decimal literal like 1.5 must NOT
                # match as qual=1, name=5
                return re.sub(
                    r"\b([A-Za-z_]\w*)\.([A-Za-z_]\w*)\b", sub, s
                )

            residual_sql = " AND ".join(rw(c) for c in residual_parts)
        if residual_sql is not None and how != "inner":
            # correct outer-join ON-residual semantics gate MATCHING (the
            # unmatched row stays, null-extended) — a post-join filter
            # would be silently wrong, so refuse instead
            raise ValueError(
                "non-equi ON conditions are supported for INNER joins "
                "only; move the predicate to WHERE for filter semantics"
            )
        if not lks and how != "inner":
            raise ValueError(
                "outer joins require at least one equi condition in ON"
            )
        return lks, rks, residual_sql, clash

    # -- logical planning (see table/planner.py) -------------------------
    def _build_logical(self, m):
        """Parsed query -> unoptimized logical tree (the AST the rule
        pipeline rewrites — ref FlinkPlannerImpl's rel() step)."""
        from flink_tpu_torch.table import planner as pl

        ft = m.group("from")
        t = self.scan(ft)
        node: object = pl.LScan(ft, t.n, list(t.schema))
        if m.group("jtable"):
            jt = m.group("jtable")
            right = self.scan(jt)
            how = (m.group("jhow") or "inner").split()[0].lower()
            lks, rks, residual_sql, clash = self._analyze_on(
                ft, jt, m.group("on"), how, list(t.schema),
                list(right.schema),
            )
            names = join_output_names(list(t.schema),
                                      list(right.schema), lks, rks)
            out = list(t.schema) + list(names.values())
            node = pl.LJoin(
                node, pl.LScan(jt, right.n, list(right.schema)),
                how, lks, rks, residual_sql, out, clash,
            )
        if m.group("where"):
            node = pl.LFilter(node, pl.split_conjuncts(m.group("where")))
        select_items = _split_commas(m.group("select"))
        star = select_items == ["*"]
        if m.group("group"):
            keys = [k.strip() for k in _split_commas(m.group("group"))]
            items = keys if star else select_items
            node = pl.LAggregate(node, keys, items, list(items))
        elif not star:
            node = pl.LProject(node, select_items, list(select_items))
        if m.group("having"):
            if not m.group("group"):
                raise ValueError("HAVING requires GROUP BY")
            hv = m.group("having")
            from flink_tpu_torch.table.planner import stash_literals
            hv_no_lit, _ = stash_literals(hv)
            if re.search(
                r"\b(" + "|".join(_AGGS) + r")\s*\(", hv_no_lit,
                re.IGNORECASE,
            ):
                raise ValueError(
                    "HAVING references SELECT aliases and group keys; "
                    "alias the aggregate in SELECT (e.g. SUM(x) AS "
                    "total) and write HAVING total > ..."
                )
            node = pl.LFilter(node, pl.split_conjuncts(hv))
        if m.group("order"):
            node = pl.LSort(node, m.group("order").strip())
        if m.group("limit"):
            node = pl.LLimit(node, int(m.group("limit")))
        return node

    def _execute_logical(self, node, plan: Optional[List[str]]) -> Table:
        """Lower the (optimized) logical tree onto the columnar Table
        operators, recording the measured physical plan."""
        from flink_tpu_torch.table import planner as pl

        if isinstance(node, pl.LScan):
            t = self.scan(node.name)
            if node.empty:
                t = t.limit(0)
            if node.keep is not None:
                t = Table({k: t.cols[k] for k in node.keep}, t.device)
            if plan is not None:
                extra = (
                    f", cols={node.keep}" if node.keep is not None else ""
                )
                plan.append(f"Scan({node.name}, {t.n} rows{extra})")
            return t
        if isinstance(node, pl.LFilter):
            t = self._execute_logical(node.input, plan)
            n_in = t.n
            sql = " AND ".join(f"({c})" for c in node.conjuncts)
            t = t.where(_parse_expr(sql))
            if plan is not None:
                plan.append(
                    f"Filter({' AND '.join(node.conjuncts)}, {n_in} -> "
                    f"{t.n} rows, selectivity "
                    f"{t.n / n_in if n_in else 0:.2f})"
                )
            return t
        if isinstance(node, pl.LJoin):
            left = self._execute_logical(node.left, plan)
            right = self._execute_logical(node.right, plan)
            residual = (
                _parse_expr(node.residual_sql)
                if node.residual_sql else None
            )
            if node.lks:
                return left.join(right, node.lks, node.rks, how=node.how,
                                 residual=residual, _plan=plan)
            return left.cross_join(right, residual=residual, _plan=plan)
        if isinstance(node, pl.LAggregate):
            t = self._execute_logical(node.input, plan)
            exprs = [_parse_select_item(s) for s in node.items]
            t = t.group_by(*node.keys).select(*exprs)
            if plan is not None:
                plan.append(
                    f"HashAggregate(keys={node.keys}, {t.n} groups)"
                )
            return t
        if isinstance(node, pl.LProject):
            t = self._execute_logical(node.input, plan)
            exprs = [_parse_select_item(s) for s in node.items]
            t = t.select(*exprs)
            if plan is not None:
                plan.append(f"Project({[e.name for e in exprs]})")
            return t
        if isinstance(node, pl.LSort):
            t = self._execute_logical(node.input, plan)
            spec = node.spec
            desc = bool(re.search(r"\s+DESC$", spec, re.IGNORECASE))
            key = re.sub(r"\s+(DESC|ASC)$", "", spec, flags=re.IGNORECASE)
            t = t.order_by(key.strip(), ascending=not desc)
            if plan is not None:
                plan.append(f"Sort({spec})")
            return t
        if isinstance(node, pl.LLimit):
            t = self._execute_logical(node.input, plan)
            t = t.limit(node.n)
            if plan is not None:
                plan.append(f"Limit({node.n})")
            return t
        raise TypeError(f"unknown logical node {type(node).__name__}")

    @staticmethod
    def _split_union(query: str):
        """Top-level UNION [ALL] split, literal-aware (a quoted string
        containing the word UNION never splits). Returns
        ([branch_sql...], [op...]) with ops[i] the combinator between
        branch i and i+1 ("all" | "distinct")."""
        masked, unstash = TableEnvironment._mask_literals(query)
        parts = re.split(r"\bUNION(\s+ALL)?\b", masked,
                         flags=re.IGNORECASE)
        branches = parts[0::2]
        ops = ["all" if a else "distinct" for a in parts[1::2]]
        return [unstash(b).strip() for b in branches], ops

    @staticmethod
    def _mask_literals(sql: str):
        """Stash string literals behind \\x00N\\x00 markers so clause
        regexes can never match keywords INSIDE a quoted value. ONE
        implementation — the planner's stash_literals — so the quoting
        rule can never drift between the layers. Returns
        (masked, unstash)."""
        from flink_tpu_torch.table.planner import stash_literals

        return stash_literals(sql)

    @staticmethod
    def _strip_trailing_masked(masked: str):
        """_strip_trailing's core on ALREADY-masked text (no literal can
        interfere); order_spec comes back still masked."""
        limit = None
        m = re.search(r"\s+LIMIT\s+(\d+)\s*;?\s*$", masked, re.IGNORECASE)
        if m:
            limit = int(m.group(1))
            masked = masked[:m.start()]
        order = None
        m = re.search(
            r"\s+ORDER\s+BY\s+"
            r"((?:(?!\b(?:WHERE|GROUP|HAVING|UNION|LIMIT)\b).)+?)\s*;?\s*$",
            masked, re.IGNORECASE | re.DOTALL,
        )
        if m:
            order = m.group(1).strip()
            masked = masked[:m.start()]
        return masked, order, limit

    @classmethod
    def _strip_trailing(cls, branch: str):
        """Pull a trailing ORDER BY / LIMIT off a query. Used where the
        clause must apply AFTER a set operation (DISTINCT dedupes before
        ORDER BY/LIMIT; a union's trailing clauses order/bound the WHOLE
        union, not its last branch). Returns (core, order_spec, limit).

        Literal-aware like _split_union: the clause regexes run on a
        MASKED copy, so a trailing string literal containing 'ORDER BY
        x' or 'LIMIT 5' (WHERE name = 'a ORDER BY b') is never stripped
        as a clause."""
        masked, unstash = cls._mask_literals(branch)
        masked, order, limit = cls._strip_trailing_masked(masked)
        return (
            unstash(masked),
            unstash(order) if order is not None else None,
            limit,
        )

    @staticmethod
    def _apply_trailing(t: Table, order: Optional[str],
                        limit: Optional[int],
                        plan: Optional[List[str]]) -> Table:
        if order is not None:
            desc = bool(re.search(r"\s+DESC$", order, re.IGNORECASE))
            key = re.sub(r"\s+(DESC|ASC)$", "", order, flags=re.IGNORECASE)
            t = t.order_by(key.strip(), ascending=not desc)
            if plan is not None:
                plan.append(f"Sort({order})")
        if limit is not None:
            t = t.limit(limit)
            if plan is not None:
                plan.append(f"Limit({limit})")
        return t

    def _sql_single(self, query: str, _plan: Optional[List[str]],
                    optimize: bool) -> Table:
        return self._exec_branch(query, _plan, optimize)[0]

    def _exec_branch(self, branch: str, plan: Optional[List[str]],
                     optimize: bool, want_render: bool = False):
        """ONE implementation of the per-branch pipeline (DISTINCT strip
        + clause reordering, parse, optimize, execute) shared by
        sql_query and explain, so the two can never accept different
        grammars. Returns (table, render) with render =
        (ast_txt, optimized_txt, rules) when requested."""
        from flink_tpu_torch.table import planner as pl

        # ONE literal mask for the whole branch pipeline: the DISTINCT
        # strip, the trailing-clause strip, AND the grammar regex run on
        # masked text — a quoted value containing ORDER BY/LIMIT/WHERE
        # can never be parsed as syntax. Clause texts unstash on access
        # (_UnstashingMatch), so the planner sees the real SQL.
        masked, unstash = self._mask_literals(branch)
        masked, n_distinct = re.subn(
            r"^(\s*SELECT)\s+DISTINCT\b", r"\1", masked, count=1,
            flags=re.IGNORECASE,
        )
        order = limit = None
        if n_distinct:
            # SQL evaluates DISTINCT before ORDER BY/LIMIT: dedupe the
            # full result, then sort and bound it
            masked, order, limit = self._strip_trailing_masked(masked)
            if order is not None:
                order = unstash(order)
        m = self._SQL.match(masked)
        if not m:
            raise ValueError(f"unsupported SQL shape: {branch!r}")
        root = self._build_logical(_UnstashingMatch(m, unstash))
        opt, rules = pl.optimize(root) if optimize else (root, [])
        render = (
            (pl.render(root), pl.render(opt), rules) if want_render
            else None
        )
        out = self._execute_logical(opt, plan)
        if n_distinct:
            out = out.distinct()
            if plan is not None:
                plan.append("Distinct(first occurrence)")
            out = self._apply_trailing(out, order, limit, plan)
        return out, render

    @staticmethod
    def _check_union_schemas(a: Table, b: Table):
        if list(a.cols) != list(b.cols):
            raise ValueError(
                f"UNION branches must have the same columns: "
                f"{list(a.cols)} vs {list(b.cols)}"
            )
        for k in a.cols:
            sa = a.cols[k].dtype.kind in "OUS"
            sb = b.cols[k].dtype.kind in "OUS"
            if sa != sb:
                raise ValueError(
                    f"UNION column {k!r} mixes string and numeric "
                    f"branches ({a.cols[k].dtype} vs {b.cols[k].dtype}); "
                    f"numpy promotion would silently stringify values"
                )

    def sql_query(self, query: str, _plan: Optional[List[str]] = None,
                  optimize: bool = True) -> Table:
        """Parse -> logical plan -> rule rewriting -> execute.
        ``optimize=False`` runs the unrewritten tree (the baseline for
        plan-diff tests and the planner benchmark). UNION [ALL] runs
        each branch through the same pipeline and concatenates
        (deduplicating for plain UNION, SQL set semantics); a trailing
        ORDER BY/LIMIT applies to the WHOLE union."""
        branches, ops = self._split_union(query)
        order = limit = None
        if ops:
            branches[-1], order, limit = self._strip_trailing(
                branches[-1]
            )
        out = self._sql_single(branches[0], _plan, optimize)
        for op, branch in zip(ops, branches[1:]):
            nxt = self._sql_single(branch, _plan, optimize)
            self._check_union_schemas(out, nxt)
            out = out.union_all(nxt)
            if op == "distinct":
                out = out.distinct()
            if _plan is not None:
                _plan.append(f"Union({op})")
        if ops:
            out = self._apply_trailing(out, order, limit, _plan)
        return out

    def explain(self, query: str) -> str:
        """AST + rewritten logical plan + measured physical plan (ref
        TableEnvironment.explain / FlinkPlannerImpl.scala:46 — a rule
        pipeline over a logical tree, not a Calcite port). UNION
        queries explain each branch with the combinator between; the
        same schema checks run, so explain never claims a plan for a
        query sql_query would reject."""
        branches, ops = self._split_union(query)
        g_order = g_limit = None
        if ops:
            branches[-1], g_order, g_limit = self._strip_trailing(
                branches[-1]
            )
        sections = []
        prev: Optional[Table] = None
        for i, branch in enumerate(branches):
            plan: List[str] = []
            t, render = self._exec_branch(branch, plan, optimize=True,
                                          want_render=True)
            ast_txt, opt_txt, rules = render
            if prev is not None:
                self._check_union_schemas(prev, t)
            prev = t
            sections.append(
                "== Abstract Syntax Tree ==\n" + ast_txt
                + "\n\n== Optimized Logical Plan ==\n" + opt_txt
                + "\napplied: "
                + (", ".join(rules) if rules else "(none)")
                + "\n\n== Physical Plan ==\n" + "\n".join(plan)
            )
            if i < len(ops):
                sections.append(f"== UNION {ops[i].upper()} ==")
        if ops and (g_order is not None or g_limit is not None):
            tail: List[str] = []
            self._apply_trailing(prev, g_order, g_limit, tail)
            sections.append("== Union Result ==\n" + "\n".join(tail))
        return "\n\n".join(sections)


class _UnstashingMatch:
    """re.Match proxy whose group() restores stashed string literals:
    the grammar regex runs on MASKED text (no quoted value can match a
    clause keyword), while the planner keeps seeing the real SQL."""

    def __init__(self, m, unstash):
        self._m = m
        self._unstash = unstash

    def group(self, *args):
        g = self._m.group(*args)
        if isinstance(g, str):
            return self._unstash(g)
        if isinstance(g, tuple):
            return tuple(
                self._unstash(x) if isinstance(x, str) else x for x in g
            )
        return g


def _split_commas(s: str) -> List[str]:
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return out


def _parse_select_item(s: str) -> Expr:
    m = re.match(r"^(.+?)\s+AS\s+(\w+)$", s.strip(), re.IGNORECASE)
    alias = None
    if m:
        s, alias = m.group(1), m.group(2)
    e = _parse_expr(s)
    return e.alias(alias) if alias else e


def _rewrite_case(py: str) -> str:
    """CASE expressions -> nested IF(cond, then, else) calls, both
    forms: searched (CASE WHEN c THEN v ... ELSE d END) and simple
    (CASE x WHEN v THEN r ... ELSE d END, each WHEN an equality on x).
    Innermost-first so nested CASEs resolve bottom-up. ELSE is required:
    the subset has no SQL NULL to default to, and a silent default
    would be a wrong answer, not a convenience."""
    pat = re.compile(
        r"\bCASE\b((?:(?!\bCASE\b)(?!\bEND\b).)*?)\bEND\b",
        re.IGNORECASE | re.DOTALL,
    )

    def one(m: "re.Match") -> str:
        body = m.group(1)
        pieces = re.split(r"\bWHEN\b", body, flags=re.IGNORECASE)
        subject = pieces[0].strip()
        if len(pieces) < 2:
            raise ValueError(f"CASE without WHEN in {body!r}")
        branches = []
        else_val = None
        for part in pieces[1:]:
            seg = re.split(r"\bTHEN\b", part, flags=re.IGNORECASE)
            if len(seg) != 2:
                raise ValueError(f"WHEN without THEN in CASE {body!r}")
            cond, rest = seg[0].strip(), seg[1]
            er = re.split(r"\bELSE\b", rest, flags=re.IGNORECASE)
            val = er[0].strip()
            if len(er) == 2:
                else_val = er[1].strip()
            if subject:
                cond = f"(({subject}) = ({cond}))"
            branches.append((cond, val))
        if else_val is None:
            raise ValueError(
                "CASE requires an ELSE branch (this SQL subset has no "
                "NULL to default to)"
            )
        out = f"({else_val})"
        for cond, val in reversed(branches):
            out = f"IF(({cond}), ({val}), {out})"
        return out

    while pat.search(py):
        py = pat.sub(one, py, count=1)
    return py


def _parse_expr(s: str) -> Expr:
    """SQL fragment -> Expr via the Python ast (SQL operators translated
    first: = -> ==, AND/OR/NOT -> and/or/not, aggregate calls -> .agg
    props). String literals are pulled out BEFORE keyword rewriting so
    values like 'AND' or 'a=b' survive untouched."""
    literals: List[str] = []

    def stash(m):
        literals.append(m.group(1).replace("''", "'"))
        return f"__lit{len(literals) - 1}__"

    py = re.sub(r"'((?:[^']|'')*)'", stash, s)
    # SQL-only syntactic forms -> plain calls the Python ast can parse
    py = _rewrite_case(py)
    py = re.sub(r"\bEXTRACT\s*\(\s*(\w+)\s+FROM\s+", r"extract_\1(",
                py, flags=re.IGNORECASE)
    py = re.sub(r"(\w+(?:\.\w+)?|__lit\d+__)\s+LIKE\s+(__lit\d+__)",
                r"like(\1, \2)", py, flags=re.IGNORECASE)
    # [NOT] BETWEEN: the left operand may be an arithmetic chain
    # (`a + b BETWEEN lo AND hi` bounds the SUM); the parenthesization
    # keeps the inner `and`/`or` below any surrounding OR. NOT BETWEEN
    # must rewrite FIRST or the plain rule would mis-bind it.
    _chain = (r"((?:-?[\w.]+|__lit\d+__)"
              r"(?:\s*[-+*/%]\s*(?:-?[\w.]+|__lit\d+__))*)")
    _operand = r"(-?[\w.]+|__lit\d+__)"
    py = re.sub(
        _chain + r"\s+NOT\s+BETWEEN\s+" + _operand + r"\s+AND\s+"
        + _operand,
        r"((\1 < \2) or (\1 > \3))", py, flags=re.IGNORECASE,
    )
    py = re.sub(
        _chain + r"\s+BETWEEN\s+" + _operand + r"\s+AND\s+" + _operand,
        r"((\1 >= \2) and (\1 <= \3))", py, flags=re.IGNORECASE,
    )
    if re.search(r"\bBETWEEN\b", py, re.IGNORECASE):
        raise ValueError(
            f"unsupported BETWEEN shape in {s!r}: operands must be "
            f"columns, literals, or arithmetic chains of them"
        )
    py = re.sub(r"(?<![<>=!])=(?!=)", "==", py)
    # python's `and`/`or`/`not` have SQL's precedence (below comparisons);
    # the builder turns BoolOp into elementwise &/|
    py = re.sub(r"\bAND\b", "and", py, flags=re.IGNORECASE)
    py = re.sub(r"\bOR\b", "or", py, flags=re.IGNORECASE)
    py = re.sub(r"\bNOT\b", "not", py, flags=re.IGNORECASE)
    py = re.sub(r"\bIN\b", "in", py, flags=re.IGNORECASE)
    py = re.sub(r"\bCOUNT\s*\(\s*\*\s*\)", "COUNT(__star__)", py,
                flags=re.IGNORECASE)
    tree = ast.parse(py, mode="eval")

    def build(node) -> Any:
        if isinstance(node, ast.Expression):
            return build(node.body)
        if isinstance(node, ast.Name):
            if node.id == "__star__":
                return lit(1.0)
            m = re.fullmatch(r"__lit(\d+)__", node.id)
            if m:
                return lit(literals[int(m.group(1))])
            return col(node.id)
        if isinstance(node, ast.Constant):
            return lit(node.value)
        if isinstance(node, ast.Compare):
            left = build(node.left)
            if isinstance(node.ops[0], (ast.In, ast.NotIn)):
                # X IN (a, b, c): membership as an OR of equalities.
                # `X IN (a)` parses as a parenthesized scalar, not a
                # tuple — standard SQL, so treat it as a one-element list
                members = node.comparators[0]
                elts = (
                    members.elts
                    if isinstance(members, (ast.Tuple, ast.List))
                    else [members]
                )
                acc = None
                for elt in elts:
                    eq = Expr.__eq__(left, build(elt))
                    acc = eq if acc is None else (acc | eq)
                if acc is None:
                    return lit(False)
                return ~acc if isinstance(node.ops[0], ast.NotIn) else acc
            right = build(node.comparators[0])
            opmap = {
                ast.Gt: Expr.__gt__, ast.GtE: Expr.__ge__,
                ast.Lt: Expr.__lt__, ast.LtE: Expr.__le__,
                ast.Eq: Expr.__eq__, ast.NotEq: Expr.__ne__,
            }
            return opmap[type(node.ops[0])](left, right)
        if isinstance(node, ast.BinOp):
            opmap = {
                ast.Add: Expr.__add__, ast.Sub: Expr.__sub__,
                ast.Mult: Expr.__mul__, ast.Div: Expr.__truediv__,
                ast.Mod: Expr.__mod__, ast.BitAnd: Expr.__and__,
                ast.BitOr: Expr.__or__,
            }
            return opmap[type(node.op)](build(node.left), build(node.right))
        if isinstance(node, ast.BoolOp):
            parts = [build(v) for v in node.values]
            acc = parts[0]
            for p in parts[1:]:
                acc = (acc & p) if isinstance(node.op, ast.And) else (acc | p)
            return acc
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, (ast.Invert, ast.Not)):
                return ~build(node.operand)
            if isinstance(node.op, ast.USub):
                return lit(0) - build(node.operand)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            fname = node.func.id.lower()
            if fname in _AGGS:
                inner = build(node.args[0])
                return inner._mk_agg(fname)
            if fname == "round" and len(node.args) == 2:
                a, d = build(node.args[0]), node.args[1]
                if not (isinstance(d, ast.Constant)
                        and isinstance(d.value, int)):
                    raise ValueError("ROUND precision must be an int literal")
                return Expr(
                    lambda c, n, _a=a, _d=d.value: np.round(
                        _a.eval(c, n), _d
                    ),
                    f"ROUND({a.name},{d.value})",
                )
            if fname in _SCALAR_FNS:
                if len(node.args) != 1:
                    raise ValueError(
                        f"{fname.upper()} takes exactly 1 argument, "
                        f"got {len(node.args)}"
                    )
                return _SCALAR_FNS[fname](build(node.args[0]))
            if fname == "power":
                return power(build(node.args[0]), build(node.args[1]))
            if fname == "concat":
                return concat(*[build(a) for a in node.args])
            if fname == "substring":
                return substring(*[build(a) for a in node.args])
            if fname == "if":
                return if_(*[build(a) for a in node.args])
            if fname == "like":
                pat_node = node.args[1]
                if isinstance(pat_node, ast.Name):
                    m2 = re.fullmatch(r"__lit(\d+)__", pat_node.id)
                    pat = literals[int(m2.group(1))]
                elif isinstance(pat_node, ast.Constant):
                    pat = str(pat_node.value)
                else:
                    raise ValueError("LIKE pattern must be a literal")
                return like(build(node.args[0]), pat)
            m2 = re.fullmatch(r"extract_(\w+)", fname)
            if m2:
                unit = m2.group(1)
                inner = build(node.args[0])
                return Expr(
                    lambda c, n, _u=unit, _i=inner: _extract(
                        _u, _i.eval(c, n)
                    ),
                    f"EXTRACT({unit.upper()} FROM {inner.name})",
                )
        raise ValueError(f"unsupported SQL expression: {s!r}")

    return build(tree)
