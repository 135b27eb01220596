"""The port's cross-process plane in one process, against the reference:

  * the window (tumbling, sliding, resident), session, rolling and CEP
    runners of ``flink_tpu_torch/runtime/dcn.py`` at ``num_processes=1``
    over 4 forced shards on the CPU, against the reference's runners at
    ``num_processes=1`` over the conftest's 8 CPU devices, on the same
    sources (``tests/torch_dcn_jobs.py`` / ``tests/dcn_jobs.py``): every
    row equal, bit for bit (integer-valued data), and the rolling sums'
    per-key order;
  * ``build_window_dcn_resident_drain`` (K13 DCN) against the reference's
    on the same slots over 4 shards (the reference's state in the port's
    packed plane): each shard's state cell by cell, its fires, the agreed
    slot count and the stop flag, with and without the flight recorder;
  * the sharded broadcast join (K21 sharded) against the reference's at 8
    shards;
  * the sharded session step over a mesh of two processes: each
    process's shards, as in the one-process mesh;
  * the rebalance ring's frame deadline and stall attribution (the
    reference's ``tests/test_dcn_resident.py`` cases, against the port);
  * ``dcn.coordinator`` never running a job on one host: each shape the
    reference refuses on that path raises its error, and each the port
    does not run there raises NotImplementedError naming its ROADMAP item.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import os
import socket
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import dcn_jobs as RJ  # noqa: E402
import torch_dcn_jobs as TJ  # noqa: E402
from torch_parity import fire_rows, jax_fields, logical_state  # noqa: E402

from flink_tpu.ops import window_kernels as wkj
from flink_tpu.parallel.broadcast import broadcast_join as ref_join
from flink_tpu.parallel.mesh import MeshContext as MeshRef
from flink_tpu.runtime import dcn as dcn_ref
from flink_tpu.runtime import step as step_ref
from flink_tpu_torch import StreamExecutionEnvironment
from flink_tpu_torch.core.config import Configuration
from flink_tpu_torch.core.time import TimeCharacteristic
from flink_tpu_torch.datastream.window.assigners import (
    EventTimeSessionWindows, TumblingEventTimeWindows,
)
from flink_tpu_torch.ops import window_kernels as wkt
from flink_tpu_torch.parallel.broadcast import broadcast_join
from flink_tpu_torch.parallel.mesh import MeshContext, forced_device_count
from flink_tpu_torch.runtime import dcn as dcn_port
from flink_tpu_torch.runtime import step as step_port
from flink_tpu_torch.runtime.sinks import CollectSink
from flink_tpu_torch.runtime.sources import GeneratorSource
from flink_tpu_torch.runtime.stages import StageGraphError

CPU = torch.device("cpu")
SHARDS = 4


def _rows(out) -> np.ndarray:
    """A runner's rows (key, start, end, value bits) in sorted order."""
    cols = np.stack([out["key_id"].astype(np.uint64).view(np.int64),
                     out["window_start_ms"].astype(np.int64),
                     out["window_end_ms"].astype(np.int64),
                     out["value"].astype(np.float32).view(np.int32)
                     .astype(np.int64)])
    return cols[:, np.lexsort(cols[::-1])]


def _per_key(out) -> dict:
    seqs = {}
    for k, v in zip(out["key_id"].tolist(), out["value"].tolist()):
        seqs.setdefault(k, []).append(v)
    return seqs


@pytest.mark.parametrize("job", ["two_host_window", "two_host_sliding",
                                 "two_host_window_resident",
                                 "two_host_session", "two_host_rolling",
                                 "two_host_cep"])
def test_runner_rows_equal_the_references(job):
    want = dcn_ref.runner_for_spec(getattr(RJ, job)(), 0, 1).run()
    with forced_device_count(SHARDS):
        got = dcn_port.runner_for_spec(getattr(TJ, job)(), 0, 1,
                                       device="cpu").run()
    assert len(got["key_id"]) > 0
    np.testing.assert_array_equal(_rows(got), _rows(want))
    assert got["dropped_capacity"] == want["dropped_capacity"] == 0
    assert got["ingested_local"] == want["ingested_local"]
    if job == "two_host_window_resident":
        assert got["cycles"] == want["cycles"]
    if job == "two_host_rolling":
        assert _per_key(got) == _per_key(want)


# ------------------------------------------------ K13 DCN, the drain

MAXP, C, F, D = 64, 1024, 2, 4
BPD = 64                        # lanes a shard
SIZE, SLIDE = 100, 50           # sliding: two panes a window
# (fill, per-slot watermark step, done) of each drain
SCHEDULE = ((4, 40, 0), (2, 60, 0), (3, 90, 0), (1, None, 1))


def _drain_inputs(seed):
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(2**40), 2**40, 400, dtype=np.int64)
    t, wm = 0, -(2**31) + 1
    for fill, step, done in SCHEDULE:
        B = SHARDS * BPD
        keys = pool[rng.integers(0, len(pool), (D, B))]
        w = keys.view(np.uint64)
        hi = (w >> np.uint64(32)).astype(np.uint32)
        lo = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        ts = (t + rng.integers(0, 120, (D, B))).astype(np.int32)
        vals = rng.integers(1, 9, (D, B)).astype(np.float32)
        valid = rng.random((D, B)) < 0.85
        valid[fill:] = False
        wms = np.empty(D, np.int32)
        for i in range(D):
            if done:
                wm = dcn_port.MAX_TICKS
            elif i < fill:
                wm = t + step * (i + 1)
            wms[i] = wm
        yield hi, lo, ts, vals, valid, wms, done, fill
        t += (step or 0) * fill


def _shard(tree, s):
    return jax.tree_util.tree_map(lambda x: x[s], tree)


@pytest.mark.parametrize("drain_stats", [False, True])
def test_dcn_drain_matches_the_reference(drain_stats):
    win_r = wkj.WindowSpec(SIZE, SLIDE, ring=8, fires_per_step=F)
    red_r = wkj.ReduceSpec("sum", jnp.float32)
    spec_r = step_ref.WindowStageSpec(win=win_r, red=red_r,
                                      capacity_per_shard=C, layout="hash",
                                      packed=True)
    ctx_r = MeshRef.create(SHARDS, MAXP, devices=jax.devices()[:SHARDS])
    drain_r = step_ref.build_window_dcn_resident_drain(
        ctx_r, spec_r, BPD, D, drain_stats=drain_stats)
    st0 = wkj.init_state(C, 16, win_r, red_r, layout="hash",
                         n_key_groups=MAXP, packed=True)
    state_r = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (SHARDS,) + x.shape), st0)

    spec_p = step_port.WindowStageSpec(
        win=wkt.WindowSpec(SIZE, SLIDE, ring=8, fires_per_step=F),
        red=wkt.ReduceSpec("sum"), capacity_per_shard=C, layout="hash")
    ctx_p = MeshContext.create(SHARDS, MAXP, devices=[CPU] * SHARDS)
    states = [step_port.init_shard_state(spec_p, MAXP, CPU)
              for _ in range(SHARDS)]
    drain_p = step_port.build_window_dcn_resident_drain(
        ctx_p, spec_p, BPD, D, drain_stats=drain_stats)
    assert drain_p.bucket_cap == drain_r.bucket_cap

    n_rows = 0
    for hi, lo, ts, vals, valid, wms, done, fill in _drain_inputs(3):
        out_r = drain_r(state_r, hi, lo, ts, vals, valid,
                        np.repeat(wms[:, None], SHARDS, 1),
                        np.full(SHARDS, done, np.int32),
                        np.full(SHARDS, fill, np.int32))
        state_r, cfs_r, stop_r, count_r = out_r[:4]
        out_p = drain_p(states, hi, lo, ts, vals, valid, wms, done, fill)
        states, cfs_p, stop_p, count_p = out_p[:4]
        assert count_p == int(count_r) == fill
        assert stop_p == bool(int(stop_r))
        for s in range(SHARDS):
            want = logical_state(jax_fields(_shard(state_r, s)), red_r)
            got = logical_state(wkt.state_to_numpy(states[s]), red_r)
            for name in want:
                np.testing.assert_array_equal(got[name], want[name],
                                              err_msg=f"shard {s} {name}")
            for i in range(fill):
                fr_r = _shard(_shard(cfs_r, s), i)
                fr_p = wkt.CompactFires(*(getattr(cfs_p[s], f)[i] for f in (
                    "key_hi", "key_lo", "values", "counts",
                    "window_end_ticks", "n_fires", "lane_valid",
                    "value_sums")))
                for name in ("counts", "window_end_ticks", "lane_valid"):
                    np.testing.assert_array_equal(
                        getattr(fr_p, name).numpy(),
                        np.asarray(getattr(fr_r, name)), err_msg=name)
                for f in range(F):
                    (kw, vw), _ = fire_rows(fr_r, f)
                    (kg, vg), _ = fire_rows(fr_p, f)
                    np.testing.assert_array_equal(kg, kw)
                    np.testing.assert_array_equal(vg, vw)
                    n_rows += len(kg)
            if drain_stats:
                np.testing.assert_array_equal(
                    out_p[4][s].numpy(), np.asarray(out_r[4])[s],
                    err_msg=f"shard {s} recorder")
    assert n_rows > 0


# ------------------------------------------------ K21 sharded

@pytest.mark.parametrize("seed", [3, 4])
def test_sharded_broadcast_join_matches_the_reference_at_8_shards(seed):
    rng = np.random.default_rng(seed)
    # the reference probes with int32 keys: stay within int32
    tkeys = rng.choice(np.arange(-5000, 5000, dtype=np.int64), 800,
                       replace=False)
    tvals = rng.integers(-100, 100, 800).astype(np.float32)
    keys = rng.integers(-6000, 6000, 10_003).astype(np.int64)
    want_j, want_h = ref_join(keys, tkeys, tvals, MeshRef.create(8))
    ctx = MeshContext.create(8, devices=[CPU] * 8)
    got_j, got_h = broadcast_join(keys, tkeys, tvals, ctx)
    np.testing.assert_array_equal(got_h, np.asarray(want_h))
    np.testing.assert_array_equal(got_j, np.asarray(want_j))
    assert got_h.any() and not got_h.all()


# ------------------------------- the sharded builders over processes

@pytest.mark.parametrize("pid", [0, 1])
def test_session_step_over_processes_runs_the_local_shards(pid):
    """Over a mesh of 2 processes x 2 shards, ``build_session_step_sharded``
    runs process ``pid``'s shards on its two devices: their fires and
    states equal shards 2 pid and 2 pid + 1 of the one-process mesh of
    4 shards on the same replicated lanes."""
    rng = np.random.default_rng(40 + pid)
    B, C = 4096, 1 << 12
    keys = rng.integers(0, 700, B, dtype=np.int64) * 2654435761
    hi = torch.from_numpy((keys >> 32).astype(np.int32))
    lo = torch.from_numpy(keys.astype(np.uint32).view(np.int32))
    ts = torch.from_numpy(np.sort(rng.integers(0, 20_000, B)).astype(
        np.int32))
    vals = torch.ones(B, dtype=torch.float32)
    valid = torch.from_numpy(rng.random(B) < 0.9)
    spec = step_port.SessionStageSpec(red=wkt.ReduceSpec(kind="count"),
                                      gap_ticks=1000, capacity_per_shard=C)
    outs = []
    for ctx in (MeshContext.create(4, devices=[CPU] * 2, process_count=2,
                                   process_index=pid),
                MeshContext.create(4, devices=[CPU] * 4)):
        states = [step_port.init_session_state(spec, d)
                  for d in ctx.devices]
        step = step_port.build_session_step_sharded(ctx, spec)
        fires = []
        for wm in (5_000, 12_000):
            _st, f = step(states, hi, lo, ts, vals, valid,
                          torch.tensor(wm, dtype=torch.int32))
            fires.append(f)
        outs.append((states, fires))
    (st_p, f_p), (st_1, f_1) = outs
    mine = [2 * pid, 2 * pid + 1]
    assert sum(int(s.active.sum()) for s in st_p) > 0
    for a, s in zip(st_p, mine):
        for name in ("table_keys", "start", "last", "acc", "active"):
            assert torch.equal(getattr(a, name), getattr(st_1[s], name))
    for fp, f1 in zip(f_p, f_1):
        for (rows, n, marks), s in zip(fp, mine):
            rows1, n1, marks1 = f1[s]
            assert int(n) == int(n1) and torch.equal(marks, marks1)
            for r, r1 in zip(rows, rows1):
                assert torch.equal(r[:int(n)], r1[:int(n)])


def test_exchange_update_slots_refuses_a_mesh_over_processes():
    ctx = MeshContext.create(4, devices=[CPU] * 2, process_count=2)
    with pytest.raises(ValueError, match="exchange_across"):
        step_port.exchange_update_slots(ctx, [], [], 16)


# ------------------------------------------------ the ring's deadlines

def _mk_ring_shell(recv_timeout_s, scale):
    """A _RebalanceRing with just the fields the deadline and stall paths
    touch — no sockets dialed, no peers needed."""
    import struct as struct_mod

    ch = dcn_port._RebalanceRing.__new__(dcn_port._RebalanceRing)
    ch.struct = struct_mod
    ch.socket = socket
    ch.pid = 0
    ch.recv_timeout_s = float(recv_timeout_s)
    ch.deadline_scale = float(scale)
    return ch


def test_frame_deadline_scales_with_drained_slots():
    """deadline = base x max(1, scale): the lockstep scale 1.0 keeps the
    base, a deep drain multiplies it, and a scale below 1 never shrinks
    it."""
    ch = _mk_ring_shell(2.0, 1.0)
    assert ch._frame_deadline_s() == 2.0
    ch.deadline_scale = 4.0
    assert ch._frame_deadline_s() == 8.0
    ch.deadline_scale = 0.25
    assert ch._frame_deadline_s() == 2.0


def test_stalled_peer_attributed_under_scaled_deadline():
    """A peer that sends nothing raises DCNPeerStalledError naming the
    peer, and the wait honors the scaled budget."""
    a, b = socket.socketpair()
    try:
        a.settimeout(0.05)
        ch = _mk_ring_shell(0.2, 1.0)
        t0 = time.monotonic()
        with pytest.raises(dcn_port.DCNPeerStalledError,
                           match="next stalled"):
            ch._recv_exact(a, 8, peer="next")
        base_wait = time.monotonic() - t0
        ch.deadline_scale = 3.0
        t0 = time.monotonic()
        with pytest.raises(dcn_port.DCNPeerStalledError,
                           match="next stalled"):
            ch._recv_exact(a, 8, peer="next")
        scaled_wait = time.monotonic() - t0
        assert scaled_wait >= 0.55
        assert scaled_wait > base_wait
    finally:
        a.close()
        b.close()


# ------------------------------------------------ never single-host

def _dcn_env(extra=None):
    conf = {"dcn.coordinator": "127.0.0.1:1", "dcn.num-processes": 2,
            "dcn.process-id": 0, **(extra or {})}
    env = StreamExecutionEnvironment(Configuration(conf), device="cpu")
    env.set_max_parallelism(64)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    return env


def _gen(offset, n):
    idx = np.arange(offset, offset + n, dtype=np.int64)
    return ({"key": idx % 50, "value": np.ones(n, np.float32)}, idx // 4)


def _source(env):
    return env.add_source(GeneratorSource(_gen, total=2000))


def _chained(env):
    return (_source(env).key_by(lambda c: c["key"]).time_window(100)
            .sum(lambda c: c["value"])
            .key_by(lambda r: r.key).time_window(500).sum(lambda r: r.value))


REFUSALS = {
    "chained": ({}, _chained, StageGraphError, "single-host"),
    "data_parallel": ({"pipeline.data-parallel": "on"},
                      lambda env: _source(env).key_by(lambda c: c["key"])
                      .time_window(100).sum(lambda c: c["value"]),
                      ValueError, "data-parallel"),
    "rolling": ({}, lambda env: _source(env).key_by(lambda c: c["key"])
                .sum(lambda c: c["value"]), NotImplementedError,
                "windowed keyed stages"),
    "lateness": ({}, lambda env: _source(env).key_by(lambda c: c["key"])
                 .time_window(100).allowed_lateness(50)
                 .sum(lambda c: c["value"]), NotImplementedError,
                 "allowed lateness"),
    "mean": ({}, lambda env: _source(env).key_by(lambda c: c["key"])
             .time_window(100).mean(lambda c: c["value"]),
             NotImplementedError, "scalar built-in reduces"),
    "session_max": ({}, lambda env: _source(env).key_by(lambda c: c["key"])
                    .window(EventTimeSessionWindows.with_gap(10))
                    .max(lambda c: c["value"]), NotImplementedError,
                    "item 9"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_dcn_coordinator_never_runs_single_host(case):
    """With ``dcn.coordinator`` set, a job the plane does not run raises
    before any record moves: nothing reaches the sink."""
    extra, build, exc, match = REFUSALS[case]
    env = _dcn_env(extra)
    sink = CollectSink()
    build(env).add_sink(sink)
    with pytest.raises(exc, match=match):
        env.execute("refused")
    assert sink.results == []


def test_dcn_coordinator_refuses_processing_time():
    env = _dcn_env()
    env.set_stream_time_characteristic(TimeCharacteristic.ProcessingTime)
    sink = CollectSink()
    (_source(env).key_by(lambda c: c["key"])
     .window(TumblingEventTimeWindows.of(100)).sum(lambda c: c["value"])
     .add_sink(sink))
    with pytest.raises(NotImplementedError, match="event time"):
        env.execute("refused")
    assert sink.results == []
