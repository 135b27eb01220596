"""Session windows, count windows, allowed lateness and the drain flight
recorder over a shard mesh (parallelism above 1) against the reference,
on the CPU.

* the steps: ``runtime/step.py build_session_step_sharded`` and
  ``build_count_step_sharded`` (G1's owner mask, then G5, G10 and G11 or
  G12 a shard) against the reference's ``build_session_step`` and
  ``build_count_step`` over 2 and 4 of the conftest's XLA devices: each
  shard's fires, kind by kind for sessions (superseded open sessions,
  superseded batch sessions, watermark closes), and each shard's keyed
  state;
* whole jobs through the public API at parallelism 2, 4 and 8 (the
  port's mesh is ``force_device_count(8)`` copies of the CPU): sessions
  (nexmark q11's shape), count windows (WindowWordCount) and a tumbling
  sum with allowed lateness, their rows equal to the reference's at the
  same parallelism and to numpy's; a time-window job with
  ``observability.drain-stats`` on the sharded drain and the mask drain,
  its report a row a ring lane holding every event;
* the reference's own cases, run unchanged against the port
  (``tests/torch_library_parity.py run_reference_case``): five of
  ``tests/test_session_windows.py`` and every case of
  ``tests/test_count_windows.py`` and ``tests/test_lateness.py``, which
  run at parallelism 4 and 2. The session checkpoint cases stay with
  checkpoints of keyed stages (ROADMAP queue 1, item 6).

Integer-valued data: everything compares bit for bit.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_library_parity import reference_cases, run_reference_case
from torch_parity import (
    KC, assert_keyed_states_equal, jax_keyed_fields, keyed_batches,
    keyed_lanes_torch,
)
from test_torch_session_windows import rows_sorted, schedule
from test_torch_sharded import (  # noqa: F401 (eight_devices: the fixture)
    B, N_KEYS, TOTAL, WINDOW, eight_devices, expected, gen,
)

from flink_tpu.ops.window_kernels import ReduceSpec as ReduceSpecJ
from flink_tpu.parallel.mesh import MeshContext as MeshRef
from flink_tpu.runtime import step as step_ref
from flink_tpu_torch import StreamExecutionEnvironment as EnvT
from flink_tpu_torch.core.config import Configuration as ConfT
from flink_tpu_torch.core.time import TimeCharacteristic as TCT
from flink_tpu_torch.ops import count_windows as ct_mod
from flink_tpu_torch.ops import session_windows as st_mod
from flink_tpu_torch.ops import window_kernels as wkt
from flink_tpu_torch.ops.hashing import splitmix64
from flink_tpu_torch.parallel.mesh import MeshContext
from flink_tpu_torch.runtime import step as step_port
from flink_tpu_torch.runtime.sinks import CollectSink as SinkT
from flink_tpu_torch.runtime.sources import GeneratorSource as GenT

MAXP = 128
CPU = torch.device("cpu")


def _meshes(n):
    return (MeshRef.create(n, MAXP, devices=jax.devices()[:n]),
            MeshContext.create(n, MAXP, devices=[CPU] * n))


def _shard(tree, s):
    """Shard s's leaves of a reference state stacked over the mesh."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[s], tree)


# ------------------------------------------------------------ the steps

@pytest.mark.parametrize("n", [2, 4])
def test_session_step_sharded_matches_reference(n):
    gap = 25
    ctx_j, ctx = _meshes(n)
    spec_j = step_ref.SessionStageSpec(red=ReduceSpecJ("sum", jnp.float32),
                                       gap_ticks=gap, capacity_per_shard=KC)
    spec = step_port.SessionStageSpec(red=wkt.ReduceSpec("sum"),
                                      gap_ticks=gap, capacity_per_shard=KC)
    step_j = step_ref.build_session_step(ctx_j, spec_j)
    sj = step_ref.init_session_state(ctx_j, spec_j)
    step = step_port.build_session_step_sharded(ctx, spec)
    states = [step_port.init_session_state(spec, CPU) for _ in range(n)]
    kinds = np.zeros(3, np.int64)
    for hi, lo, ts, vals, valid, wm in schedule(6):
        sj, old_f, mid_f, wm_f = step_j(sj, hi, lo, ts, vals, valid,
                                        np.full(n, wm, np.int32))
        _s, fires = step(states, *keyed_lanes_torch(hi, lo, vals, valid,
                                                    ts=ts),
                         torch.tensor(wm, dtype=torch.int32))
        keys = np.asarray(sj.table.keys)
        for s, (rows, n_rows, marks) in enumerate(fires):
            m0, m1 = marks.tolist()
            cuts = [(0, m0), (m0, m1), (m1, int(n_rows))]
            for kind, (a, b) in enumerate(cuts):
                got = rows_sorted([r[a:b].numpy() for r in rows])
                if kind < 2:
                    f = (old_f, mid_f)[kind]
                    m = np.asarray(f[5])[s]
                    want = rows_sorted([np.asarray(x)[s][m] for x in f[:5]])
                else:
                    w_start, w_end, w_val, m = (np.asarray(x)[s]
                                                for x in wm_f)
                    want = rows_sorted([keys[s, :, 0][m], keys[s, :, 1][m],
                                        w_start[m], w_end[m], w_val[m]])
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
                kinds[kind] += b - a
    assert (kinds > 0).all()
    for s in range(n):
        assert_keyed_states_equal(
            jax_keyed_fields(_shard(sj, s), st_mod.STATE_FIELDS),
            st_mod.state_to_numpy(states[s]))
    assert sum(int(st.dropped_late) for st in states) > 0


@functools.lru_cache(maxsize=None)
def _count_ref(n, N):
    ctx_j, _ = _meshes(n)
    spec = step_ref.CountStageSpec(red=ReduceSpecJ("sum", jnp.float32),
                                   n_per_window=N, capacity_per_shard=KC)
    return spec, step_ref.build_count_step(ctx_j, spec), ctx_j


@pytest.mark.parametrize("n", [2, 4])
def test_count_step_sharded_matches_reference(n):
    N = 3
    spec_j, step_j, ctx_j = _count_ref(n, N)
    sj = step_ref.init_count_state(ctx_j, spec_j)
    _, ctx = _meshes(n)
    spec = step_port.CountStageSpec(red=wkt.ReduceSpec("sum"),
                                    n_per_window=N, capacity_per_shard=KC)
    step = step_port.build_count_step_sharded(ctx, spec)
    states = [step_port.init_count_state(spec, CPU) for _ in range(n)]
    n_fires = 0
    for hi, lo, _ts, vals, valid in keyed_batches(11, 5):
        sj, khi, klo, w, fv, mask = step_j(sj, hi, lo, vals, valid)
        _s, fires = step(states, *keyed_lanes_torch(hi, lo, vals, valid))
        for s, (rows, n_rows) in enumerate(fires):
            m = np.asarray(mask)[s]
            want = sorted(zip(np.asarray(khi)[s][m].view(np.uint32).tolist(),
                              np.asarray(klo)[s][m].view(np.uint32).tolist(),
                              np.asarray(w)[s][m].tolist(),
                              np.asarray(fv)[s][m].tolist()))
            k = int(n_rows)
            r = [x[:k].numpy() for x in rows]
            got = sorted(zip(r[0].view(np.uint32).tolist(),
                             r[1].view(np.uint32).tolist(), r[2].tolist(),
                             r[3].tolist()))
            assert got == want
            n_fires += k
    assert n_fires > 0
    for s in range(n):
        assert_keyed_states_equal(
            jax_keyed_fields(_shard(sj, s), ct_mod.STATE_FIELDS),
            ct_mod.state_to_numpy(states[s]))


# ------------------------------------------------------------ the jobs

GAP_MS, EV_PER_MS, N_BIDDERS = 500, 4, 400


def bid_gen(offset, n):
    """nexmark q11's shape: each bidder bids in bursts (as in
    tests/test_torch_session_windows.py)."""
    idx = np.arange(offset, offset + n, dtype=np.int64)
    t = idx // EV_PER_MS
    u = splitmix64(idx ^ 0x5EED).astype(np.uint64) % np.uint64(N_BIDDERS // 4)
    bidder = (t // 5 + u.astype(np.int64)) % N_BIDDERS
    return ({"bidder": splitmix64(bidder).view(np.int64),
             "value": np.ones(n, np.float32)}, t + 1_000_000)


def sessions_numpy(total):
    cols, ts = bid_gen(0, total)
    b = cols["bidder"]
    order = np.lexsort((ts, b))
    b, ts = b[order], ts[order]
    cut = np.ones(len(b), bool)
    cut[1:] = (b[1:] != b[:-1]) | (ts[1:] - ts[:-1] > GAP_MS)
    starts = np.nonzero(cut)[0]
    ends = np.append(starts[1:], len(b))
    return sorted((int(b[s]), int(ts[s]), int(ts[e - 1]) + GAP_MS,
                   float(e - s)) for s, e in zip(starts, ends))


def word_gen(offset, n):
    idx = np.arange(offset, offset + n, dtype=np.int64)
    rank = np.where(idx % 3 == 0, 0, (idx * 2654435761) % 61)
    return {"bidder": splitmix64(rank).view(np.int64),
            "value": (idx % 5).astype(np.float32)}, idx


def counts_numpy(total, N):
    cols, _ = word_gen(0, total)
    acc, out = {}, []
    for k, v in zip(cols["bidder"].tolist(), cols["value"].tolist()):
        s = acc.setdefault(k, [0, 0.0, 0])
        s[0] += 1
        s[1] += v
        if s[0] == N:
            out.append((k, s[2], s[1]))
            s[0], s[1], s[2] = 0, 0.0, s[2] + 1
    return sorted(out)


def _envs(parallelism, batch, cfg=None):
    from flink_tpu import StreamExecutionEnvironment as EnvJ
    from flink_tpu.core.config import Configuration as ConfJ
    from flink_tpu.core.time import TimeCharacteristic as TCJ
    out = []
    for env, tc in ((EnvJ(ConfJ(dict(cfg or {}))), TCJ),
                    (EnvT(ConfT(dict(cfg or {})), device="cpu"), TCT)):
        env.set_parallelism(parallelism).set_max_parallelism(MAXP)
        env.set_stream_time_characteristic(tc.EventTime)
        env.set_state_capacity(KC)
        env.batch_size = batch
        out.append(env)
    return out


def _sinks():
    from flink_tpu.runtime.sinks import CollectSink as SinkJ
    from flink_tpu.runtime.sources import GeneratorSource as GenJ
    return ((SinkJ(), GenJ), (SinkT(), GenT))


@pytest.mark.parametrize("parallelism", [2, 4, 8])
def test_session_job_at_parallelism(parallelism):
    from flink_tpu.datastream.window.assigners import (
        EventTimeSessionWindows as SessJ,
    )
    from flink_tpu_torch.datastream.window.assigners import (
        EventTimeSessionWindows as SessT,
    )
    total = 12_000
    rows, jobs = [], []
    for env, (sink, gen), sess in zip(_envs(parallelism, 1024), _sinks(),
                                      (SessJ, SessT)):
        (env.add_source(gen(bid_gen, total=total))
         .key_by(lambda c: c["bidder"])
         .window(sess.with_gap(GAP_MS)).sum(lambda c: c["value"])
         .add_sink(sink))
        jobs.append(env.execute("sessions"))
        rows.append(sorted((int(r.key), int(r.window_start_ms),
                            int(r.window_end_ms), float(r.value))
                           for r in sink.results))
    assert rows[1] == rows[0] == sessions_numpy(total)
    m = jobs[1].metrics
    assert m.dropped_late == m.dropped_capacity == 0
    assert m.fires == len(rows[1])
    assert len(jobs[1].state) == parallelism


@pytest.mark.parametrize("parallelism", [2, 4, 8])
def test_count_job_at_parallelism(parallelism):
    total, N = 3000, 10
    rows = []
    for env, (sink, gen) in zip(_envs(parallelism, 256), _sinks()):
        (env.add_source(gen(word_gen, total=total))
         .key_by(lambda c: c["bidder"]).count_window(N)
         .sum(lambda c: c["value"]).add_sink(sink))
        job = env.execute("window-word-count")
        rows.append(sorted((int(r.key), int(r.window_end_ms),
                            float(r.value)) for r in sink.results))
    assert rows[1] == rows[0] == counts_numpy(total, N)
    assert job.metrics.fires == len(rows[1])


def late_gen(offset, n):
    """A 100 ms tumbling sum's traffic with every 20th record 250 ms
    late: within the 300 ms lateness, so each re-fires its window."""
    idx = np.arange(offset, offset + n, dtype=np.int64)
    ts = idx // 8
    ts = np.where(idx % 20 == 7, np.maximum(ts - 250, 0), ts)
    return {"bidder": (idx * 48271) % 300,
            "value": ((idx % 3) + 1).astype(np.float32)}, ts


def late_numpy(total, window, lateness, batch):
    """Every fire and re-fire a batch-at-a-time evaluation makes: after
    each batch, the windows the watermark (the max ts seen, minus 1) has
    passed fire once, and a fired window fires again with its new value
    when a batch adds to it before its end + lateness passes."""
    cols, ts = late_gen(0, total)
    keys, vals = cols["bidder"], cols["value"]
    acc, fired, out = {}, set(), []
    wm = -1
    for off in range(0, total, batch):
        sl = slice(off, off + batch)
        touched = set()
        for k, t, v in zip(keys[sl].tolist(), ts[sl].tolist(),
                           vals[sl].tolist()):
            end = (t // window + 1) * window
            if end - 1 + lateness <= wm:
                continue                      # beyond lateness: dropped
            acc[(k, end)] = acc.get((k, end), 0.0) + v
            touched.add((k, end))
        wm = max(wm, int(ts[sl].max()) - 1)
        for kw in sorted(acc):
            if kw[1] - 1 <= wm and (kw not in fired or kw in touched):
                out.append((kw[0], kw[1], acc[kw]))
                fired.add(kw)
    for kw in sorted(acc):
        if kw not in fired:
            out.append((kw[0], kw[1], acc[kw]))
    return sorted(out)


@pytest.mark.parametrize("parallelism", [2, 4, 8])
def test_lateness_job_at_parallelism(parallelism):
    total, batch, window, lateness = 8192, 512, 100, 300
    rows, jobs = [], []
    for env, (sink, gen) in zip(_envs(parallelism, batch), _sinks()):
        (env.add_source(gen(late_gen, total=total))
         .key_by(lambda c: c["bidder"]).time_window(window)
         .allowed_lateness(lateness).sum(lambda c: c["value"])
         .add_sink(sink))
        jobs.append(env.execute("late"))
        rows.append(sorted((int(r.key), int(r.window_end_ms),
                            float(r.value)) for r in sink.results))
    assert rows[1] == rows[0]
    assert rows[1] == late_numpy(total, window, lateness, batch)
    m, r = jobs[1].metrics, jobs[0].metrics
    assert m.dropped_late == r.dropped_late
    assert len(rows[1]) > len({(k, e) for k, e, _v in rows[1]})  # re-fires


DS_CFG = {"pipeline.prefetch": "on", "pipeline.device-staging": "on",
          "pipeline.resident-loop": "on", "pipeline.ring-depth": 4,
          "observability.drain-stats": True,
          "observability.drain-stats-every": 1}


@pytest.mark.parametrize("dp", ["auto", "off"])
def test_drain_stats_at_parallelism_4(dp):
    """The flight recorder on every shard: with the sharded ring (dp auto)
    one report row a shard, with the mask ring one row for the ring's one
    lane; either way the rows' events sum to every record, and the
    windows equal numpy's."""
    env = EnvT(ConfT({**DS_CFG, "pipeline.data-parallel": dp}), device="cpu")
    env.set_parallelism(4).set_max_parallelism(MAXP)
    env.set_stream_time_characteristic(TCT.EventTime)
    env.set_state_capacity(N_KEYS)
    env.batch_size = B
    sink = SinkT()
    (env.add_source(GenT(gen, total=TOTAL)).key_by(lambda c: c["key"])
     .time_window(WINDOW).sum(lambda c: c["value"]).add_sink(sink))
    job = env.execute("drain-stats")
    got = {(int(r.key), int(r.window_end_ms)): float(r.value)
           for r in sink.results}
    assert got == expected(TOTAL)
    rep = env._pipeline_report()
    lanes = 4 if dp == "auto" else 1
    assert rep["available"] and rep["n_shards"] == lanes
    assert len(rep["shards"]) == lanes
    assert all("publish_refusals" in row for row in rep["shards"])
    assert sum(row["totals"]["events"] for row in rep["shards"]) == TOTAL
    if dp == "auto":
        assert job.metrics.steps_sharded > 0
        # every shard drained its own slice of the keys
        assert all(row["totals"]["events"] > 0 for row in rep["shards"])


# ------------------------------------------------- the reference's cases

CASES = (reference_cases("test_session_windows.py", names=(
    "test_basic_sessions_in_order", "test_sessions_random_stream",
    "test_session_merge_within_batch_and_across_batches",
    "test_session_out_of_order_within_gap",
    "test_sessions_survive_inter_poll_time_jump"))
    + reference_cases("test_count_windows.py")
    + reference_cases("test_lateness.py"))


@pytest.mark.parametrize("test_file, name, params", CASES)
def test_reference_keyed_cases_at_parallelism(test_file, name, params,
                                              request, monkeypatch):
    run_reference_case(test_file, name, params, request, monkeypatch)
