"""StreamTableEnvironment: SQL GROUP BY over event-time windows — a copy
of flink_tpu/table/streaming.py that lowers onto the port's DataStream
windows (the window kernels G1-G13 carry the job on the card).

The flink-table streaming capability (SURVEY §2.7,
flink-table/.../StreamTableEnvironment.scala): a SQL query with a window
function in GROUP BY runs as a streaming job through the SAME device
window kernels the DataStream API uses (ops/window_kernels.py) — the SQL
front-end is a thin planner that lowers to key_by + window + aggregate.

Supported query shape (one aggregate, any number of group keys):

    SELECT k1[, k2...], AGG(vcol) [AS name]
    FROM <stream>
    [WHERE <pred over columns>]
    GROUP BY k1[, k2...], TUMBLE(rowtime, INTERVAL '<n>' SECOND)
                        | HOP(rowtime, INTERVAL '<slide>' SECOND,
                              INTERVAL '<size>' SECOND)
                        | SESSION(rowtime, INTERVAL '<gap>' SECOND)

AGG in SUM/COUNT/MIN/MAX. The rowtime argument of the window function
names a COLUMN of the stream (epoch milliseconds); event time is
assigned from it after any WHERE filter, so filtering never misaligns
timestamps. The result table carries the group keys, a `window_end_ms`
column (TUMBLE_END analog; sessions also get `window_start_ms`), and the
aggregate. Bounded streams run to completion; the collected emissions
are returned as a Table.

In the port, WHERE lowers to ``DataStream.map`` as in the reference, and
the port's DataStream refuses ``map`` (ROADMAP queue 1, item 9), so a
streaming query with WHERE raises that error until item 9 lands. The
environment carries a device like the batch ``TableEnvironment``
(``None``: the CUDA card); each registered stream's environment must run
on it.

DOCUMENTED DIVERGENCE from the reference: one aggregate per query (the
device window state holds one reduce accumulator per key); run several
queries for several aggregates. The reference's retraction/dynamic-table
machinery is out of scope — append-only results, as its 1.x streaming SQL
examples produce.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import numpy as np

from flink_tpu_torch.core.device import resolve_device
from flink_tpu_torch.table.table import Table, _parse_expr, _split_commas

_WINFN = re.compile(
    r"^\s*(?P<kind>TUMBLE|HOP|SESSION)\s*\(\s*(?P<rowtime>\w+)\s*,\s*"
    r"INTERVAL\s+'(?P<a>\d+(?:\.\d+)?)'\s+(?P<ua>SECOND|MINUTE|HOUR)"
    r"(?:\s*,\s*INTERVAL\s+'(?P<b>\d+(?:\.\d+)?)'\s+"
    r"(?P<ub>SECOND|MINUTE|HOUR))?\s*\)\s*$",
    re.IGNORECASE,
)

_AGG = re.compile(
    r"^\s*(?P<fn>SUM|COUNT|MIN|MAX)\s*\(\s*(?P<col>\w+)\s*\)"
    r"(?:\s+AS\s+(?P<alias>\w+))?\s*$",
    re.IGNORECASE,
)

_SQL = re.compile(
    r"^\s*SELECT\s+(?P<select>.+?)\s+FROM\s+(?P<from>\w+)"
    r"(?:\s+WHERE\s+(?P<where>.+?))?"
    r"\s+GROUP\s+BY\s+(?P<group>.+?)\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)

_MS = {"SECOND": 1000, "MINUTE": 60_000, "HOUR": 3_600_000}


def _to_ms(val: str, unit: str) -> int:
    return int(float(val) * _MS[unit.upper()])


class StreamTableEnvironment:
    """SQL planner over registered columnar streams.

    register_stream(name, build) registers a factory returning
    (env, datastream) where the datastream's records are column dicts and
    `rowtime` timestamps ride the source (GeneratorSource-style); each
    sql_query() call builds and executes a fresh job from it.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._streams: Dict[str, Callable] = {}

    @staticmethod
    def create(device=None) -> "StreamTableEnvironment":
        return StreamTableEnvironment(device)

    def register_stream(self, name: str, build: Callable):
        """build() -> (StreamExecutionEnvironment, DataStream of column
        dicts — including the rowtime column window functions will name).
        A factory, not an instance: each query is its own job."""
        self._streams[name] = build

    # ------------------------------------------------------------------
    def sql_query(self, query: str) -> Table:
        m = _SQL.match(query)
        if not m:
            raise ValueError(f"unsupported streaming SQL shape: {query!r}")
        if m.group("from") not in self._streams:
            raise KeyError(f"unknown stream {m.group('from')!r}")

        # GROUP BY: plain keys + exactly one window function
        keys, winfn = [], None
        for item in _split_top(m.group("group")):
            wm = _WINFN.match(item)
            if wm:
                if winfn is not None:
                    raise ValueError("multiple window functions in GROUP BY")
                winfn = wm
            else:
                keys.append(item.strip())
        if winfn is None:
            raise ValueError(
                "streaming GROUP BY requires a TUMBLE/HOP/SESSION window "
                "(unbounded global aggregation has no append-only result)"
            )
        if not keys:
            raise ValueError("streaming GROUP BY needs at least one key")

        # SELECT: group keys (in any order) + one aggregate
        agg = None
        sel_keys = []
        for item in _split_top(m.group("select")):
            am = _AGG.match(item)
            if am:
                if agg is not None:
                    raise ValueError(
                        "one aggregate per streaming query (run another "
                        "query for another aggregate)"
                    )
                agg = am
            elif item.strip() in keys:
                sel_keys.append(item.strip())
            else:
                raise ValueError(
                    f"SELECT item {item.strip()!r} is neither a GROUP BY "
                    f"key nor an aggregate"
                )
        if agg is None:
            raise ValueError("streaming query needs an aggregate")
        fn = agg.group("fn").upper()
        vcol = agg.group("col")
        out_name = agg.group("alias") or f"{fn.lower()}_{vcol}"

        kind = winfn.group("kind").upper()
        where = m.group("where")
        return self._run(kind, winfn, keys, sel_keys, fn, vcol, out_name,
                         where, m.group("from"))

    # ------------------------------------------------------------------
    def _run(self, kind, winfn, keys, sel_keys, fn, vcol, out_name, where,
             stream_name) -> Table:
        from flink_tpu_torch.datastream.window.assigners import (
            EventTimeSessionWindows,
        )
        from flink_tpu_torch.runtime.sinks import CollectSink

        env, ds = self._streams[stream_name]()
        if env.device != self.device:
            raise ValueError(
                f"stream {stream_name!r} runs on {env.device}, the table "
                f"environment on {self.device}")
        if where is not None:
            pred = _parse_expr(where)
            ds = ds.map(_filter_cols(pred))
        # event time comes from the rowtime COLUMN the window function
        # names, assigned AFTER any WHERE filter — deriving it from the
        # column keeps timestamps aligned with filtered rows (a source-
        # side timestamp array would keep pre-filter length and pair
        # survivors with the wrong rows' times)
        rt = winfn.group("rowtime")
        ds = ds.assign_timestamps_and_watermarks(
            lambda c, _rt=rt: c[_rt]
        )
        if len(keys) == 1:
            key_of = lambda c, k=keys[0]: c[k]
        else:
            def key_of(c):
                # composite key: an OBJECT array of tuples so KeyCodec
                # takes the stable per-object hash (a 2-D numeric array
                # would corrupt the identity encoding); originals come
                # back through the reverse map at emission
                arrs = [np.asarray(c[k]).tolist() for k in keys]
                out = np.empty(len(arrs[0]), dtype=object)
                out[:] = list(zip(*arrs))
                return out

        keyed = ds.key_by(key_of)
        if kind == "TUMBLE":
            size = _to_ms(winfn.group("a"), winfn.group("ua"))
            win = keyed.time_window(size)
        elif kind == "HOP":
            slide = _to_ms(winfn.group("a"), winfn.group("ua"))
            size = _to_ms(winfn.group("b"), winfn.group("ub"))
            win = keyed.time_window(size, slide)
        else:  # SESSION
            gap = _to_ms(winfn.group("a"), winfn.group("ua"))
            win = keyed.window(EventTimeSessionWindows.with_gap(gap))

        ext = (lambda c: c[vcol])
        if fn == "SUM":
            agg_stream = win.sum(ext)
        elif fn == "COUNT":
            agg_stream = win.count()
        elif fn == "MIN":
            agg_stream = win.min(ext)
        else:
            agg_stream = win.max(ext)

        sink = CollectSink()
        agg_stream.add_sink(sink)
        env.execute(f"sql-{kind.lower()}-{stream_name}")

        # results -> Table: unpack composite keys back into key columns
        cols: Dict[str, list] = {k: [] for k in (sel_keys or keys)}
        cols["window_end_ms"] = []
        if kind == "SESSION":
            cols["window_start_ms"] = []
        cols[out_name] = []
        for r in sink.results:
            kv = r.key if len(keys) > 1 else (r.key,)
            for k, v in zip(keys, kv):
                if k in cols:
                    cols[k].append(v)
            cols["window_end_ms"].append(r.window_end_ms)
            if kind == "SESSION":
                cols["window_start_ms"].append(r.window_start_ms)
            cols[out_name].append(r.value)
        return Table({k: np.asarray(v) for k, v in cols.items()},
                     self.device)


def _filter_cols(pred):
    """Columnar WHERE: keep only rows matching the Expr predicate."""
    def f(cols):
        n = len(next(iter(cols.values())))
        mask = np.asarray(pred.eval(cols, n), bool)
        return {k: np.asarray(v)[mask] for k, v in cols.items()}

    return f


def _split_top(s: str):
    """table.py's paren-aware comma splitter, minus empty items."""
    return [x for x in (p.strip() for p in _split_commas(s)) if x]
