"""The Table API and SQL of flink_tpu_torch against the reference's.

Every case of ``tests/test_table.py``, ``tests/test_table_sql.py`` and
``tests/test_sql_planner.py`` runs unchanged against the port on the CPU
(``torch_library_parity``): its golden rows, plans and errors hold the
port's. Two streaming cases filter with WHERE, which lowers to
``DataStream.map``; the port refuses ``map`` (ROADMAP queue 1, item 9),
so those raise, and a test says so. Then the same programs through both
packages, rows compared: batch SQL (aggregates exact on integer data,
float aggregates at rtol 1e-6), ``explain`` text, and streaming TUMBLE,
HOP and SESSION windows.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest

from flink_tpu.table import StreamTableEnvironment as RefStreamTableEnv
from flink_tpu.table import TableEnvironment as RefTableEnv
from flink_tpu_torch.table import StreamTableEnvironment, TableEnvironment
from flink_tpu_torch.table.table import Table, col
from torch_library_parity import reference_cases, run_reference_case

WHERE_STREAMING = ("test_streaming_session_with_where",
                   "test_streaming_where_keeps_window_alignment")

CASES = (reference_cases("test_table.py")
         + reference_cases("test_table_sql.py", exclude=WHERE_STREAMING)
         + reference_cases("test_sql_planner.py"))


@pytest.mark.parametrize("test_file,name,params", CASES)
def test_reference_case_on_the_port(test_file, name, params, request,
                                    monkeypatch):
    run_reference_case(test_file, name, params, request, monkeypatch)


@pytest.mark.parametrize("name", WHERE_STREAMING)
def test_streaming_where_raises_the_item_9_error(name, request,
                                                 monkeypatch):
    with pytest.raises(NotImplementedError,
                       match=r"DataStream\.map .*ROADMAP queue 1, item 9"):
        run_reference_case("test_table_sql.py", name, {}, request,
                           monkeypatch)


# ------------------------------------------------------------ both packages

def _orders(rng, n=3000):
    return {
        "user": rng.choice(["ann", "bob", "cyd", "dan", None], n).tolist(),
        "region": rng.choice(["eu", "us", "ap"], n).tolist(),
        "qty": rng.integers(1, 51, n),
        "price": rng.integers(1, 1000, n).astype(np.float64),
        "disc": rng.uniform(0, 0.1, n),
        "ts": rng.integers(0, 90 * 86_400_000, n),
    }


def _envs():
    rng = np.random.default_rng(11)
    orders = _orders(rng)
    users = {"user": ["ann", "bob", "cyd", "eve"],
             "country": ["de", "us", "fr", "uk"],
             "credit": [500.0, 20.0, 900.0, 10.0]}
    out = []
    for env in (RefTableEnv.create(), TableEnvironment.create(device="cpu")):
        env.register_table("orders", env.from_columns(orders))
        env.register_table("users", env.from_columns(users))
        out.append(env)
    return out


QUERIES = (
    "SELECT region, SUM(qty) AS q, COUNT(*) AS n, MIN(price) AS lo, "
    "MAX(price) AS hi FROM orders GROUP BY region ORDER BY region",
    "SELECT user, region, SUM(price) AS s FROM orders GROUP BY user, region",
    "SELECT SUM(qty) AS q, COUNT(qty) AS n FROM orders WHERE qty > 25",
    "SELECT country, SUM(qty) AS q FROM orders JOIN users "
    "ON orders.user = users.user GROUP BY country ORDER BY q DESC",
    "SELECT country, COUNT(*) AS n FROM orders LEFT JOIN users "
    "ON orders.user = users.user GROUP BY country",
    "SELECT region, SUM(qty) AS q FROM orders GROUP BY region "
    "HAVING q > 10000 ORDER BY region",
    "SELECT DISTINCT region FROM orders ORDER BY region",
    "SELECT user, qty FROM orders WHERE price BETWEEN 100 AND 120 "
    "ORDER BY qty DESC LIMIT 7",
    "SELECT region, SUM(qty) AS q FROM orders WHERE region = 'eu' "
    "GROUP BY region UNION ALL SELECT region, SUM(qty) AS q FROM orders "
    "WHERE region = 'us' GROUP BY region",
    "SELECT UPPER(user) AS u, EXTRACT(DAY FROM ts) AS d, "
    "CASE WHEN qty > 40 THEN 'big' ELSE 'small' END AS size FROM orders "
    "WHERE user LIKE 'a%' ORDER BY d LIMIT 20",
)


def _rows(t):
    return [tuple(None if v is None else v for v in r) for r in t.to_rows()]


@pytest.mark.parametrize("query", QUERIES)
def test_sql_rows_equal_the_reference(query):
    """Integer-valued aggregates: equal rows, in the same order."""
    ref, port = _envs()
    assert _rows(port.sql_query(query)) == _rows(ref.sql_query(query))


def test_float_aggregates_within_rtol():
    """AVG and SUM over non-integer data: the port sums in another order,
    rtol 1e-6."""
    ref, port = _envs()
    q = ("SELECT region, AVG(price * (1 - disc)) AS a, "
         "SUM(price * (1 - disc)) AS s FROM orders GROUP BY region "
         "ORDER BY region")
    a, b = port.sql_query(q), ref.sql_query(q)
    assert a.cols["region"].tolist() == b.cols["region"].tolist()
    for c in ("a", "s"):
        np.testing.assert_allclose(a.cols[c], b.cols[c], rtol=1e-6)


@pytest.mark.parametrize("query", QUERIES[:6])
def test_explain_equals_the_reference(query):
    ref, port = _envs()
    assert port.explain(query) == ref.explain(query)


def test_table_api_rows_equal_the_reference():
    ref, port = _envs()
    out = []
    for env in (ref, port):
        t = env.scan("orders")
        out.append(_rows(
            t.where(col("qty") > 10).group_by("region", "user").select(
                "region", "user", col("qty").sum.alias("q"),
                col("price").max.alias("m"), col("qty").count.alias("n"))
            .order_by("q", ascending=False)))
    assert out[0] == out[1]


def _streams(total, n_keys):
    from flink_tpu import StreamExecutionEnvironment as RefEnv
    from flink_tpu.core.config import Configuration as RefConf
    from flink_tpu.core.time import TimeCharacteristic as RefTC
    from flink_tpu.runtime.sources import GeneratorSource as RefSource
    from flink_tpu_torch import StreamExecutionEnvironment
    from flink_tpu_torch.core.config import Configuration
    from flink_tpu_torch.core.time import TimeCharacteristic
    from flink_tpu_torch.runtime.sources import GeneratorSource

    def gen(offset, n):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        return ({"k": idx % n_keys, "j": (idx // 7) % 3,
                 "v": (idx % 7).astype(np.float32),
                 "rowtime": idx * 3 + (idx % 5) * 400}, None)

    def builder(Env, Conf, TC, Source, **kw):
        def build():
            env = Env(Conf(), **kw)
            env.set_parallelism(1)
            env.set_max_parallelism(8)
            env.set_stream_time_characteristic(TC.EventTime)
            env.set_state_capacity(256)
            env.batch_size = 128
            return env, env.add_source(Source(gen, total=total))
        return build

    ref = RefStreamTableEnv.create()
    ref.register_stream("ev", builder(RefEnv, RefConf, RefTC, RefSource))
    port = StreamTableEnvironment.create(device="cpu")
    port.register_stream("ev", builder(StreamExecutionEnvironment,
                                       Configuration, TimeCharacteristic,
                                       GeneratorSource, device="cpu"))
    return ref, port


def _window_rows(t):
    return sorted(zip(*[t.cols[c].tolist() for c in t.schema]))


@pytest.mark.parametrize("query", (
    "SELECT k, SUM(v) AS s FROM ev GROUP BY k, "
    "TUMBLE(rowtime, INTERVAL '1' SECOND)",
    "SELECT k, MAX(v) AS m FROM ev GROUP BY k, "
    "HOP(rowtime, INTERVAL '0.5' SECOND, INTERVAL '2' SECOND)",
    "SELECT k, COUNT(v) AS n FROM ev GROUP BY k, "
    "SESSION(rowtime, INTERVAL '1' SECOND)",
    "SELECT k, j, MIN(v) AS m FROM ev GROUP BY k, j, "
    "TUMBLE(rowtime, INTERVAL '2' SECOND)",
))
def test_streaming_windows_equal_the_reference(query):
    ref, port = _streams(total=1500, n_keys=5)
    a, b = port.sql_query(query), ref.sql_query(query)
    assert a.schema == b.schema
    assert _window_rows(a) == _window_rows(b)


def test_entry_points_take_the_card_unless_told(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (TableEnvironment.create, TableEnvironment,
                 StreamTableEnvironment.create,
                 lambda: Table({"a": [1]})):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    env = TableEnvironment.create(device="cpu")
    t = env.from_columns({"a": [1, 1, 2], "b": [1.0, 2.0, 3.0]})
    assert t.device.type == "cpu"
    g = t.group_by("a").select("a", col("b").sum.alias("s"))
    assert g.device.type == "cpu" and g.to_rows() == [(1, 3.0), (2, 3.0)]


def test_stream_on_another_device_raises():
    import torch

    from flink_tpu_torch import StreamExecutionEnvironment

    te = StreamTableEnvironment(device="cpu")
    env = StreamExecutionEnvironment(device="cpu")
    env.device = torch.device("meta")
    te.register_stream("ev", lambda: (env, None))
    with pytest.raises(ValueError, match="runs on meta"):
        te.sql_query("SELECT k, SUM(v) FROM ev GROUP BY k, "
                     "TUMBLE(rowtime, INTERVAL '1' SECOND)")
