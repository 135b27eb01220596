"""Chained window stages and device CEP over a shard mesh (parallelism
above 1) against the reference, on the CPU.

* the chained drains over n shards (``runtime/step.py
  build_sharded_chained_drain``: each shard's one-device chained drain over
  its key groups — G1-G3, G5, G6, G21 and G22 a shard) against the
  reference's ``build_window_chained_drain`` at n shards (the mask route:
  the replicated batches) and ``build_window_chained_drain_sharded`` (the
  sharded route: each shard's own partitioned slices and count, two of
  them diverging) on the same slots: every shard's stage states, final
  fires and the drain-stats block ([n, D, 9] and [S - 1, n, 6]) equal;
* the sharded count NFA (``cep/accel.py DeviceCepOperator(n_shards=4)``:
  G1's owner mask, the one-shard advance, G27's sum of the deltas)
  against the reference's operator at 4 shards, with and without
  within(): the matches, the counters and each shard's table and carry;
* whole jobs through the public API at parallelism 2, 4 and 8 (the
  port's mesh is ``force_device_count(8)`` copies of the CPU): chained
  rollups on the mask drain and on the sharded chained drain
  (``pipeline.data-parallel: on``) against a numpy oracle, and CEP in
  processing and event time, with and without within(), against the
  exact host NFA run key by key (with within(), whose panes quantise
  the timestamps, against the job at parallelism 1);
* the reference's own cases, run unchanged against the port
  (``tests/torch_library_parity.py run_reference_case``):
  ``tests/test_cep_accel.py``'s three multi-shard cases and
  ``tests/test_stages.py``'s ``test_two_stage_chain_bit_exact_sharded``
  and ``test_chain_rejects_all_to_all_exchange``.
  ``test_chained_drain_stats_stage_telemetry_end_to_end`` stays with the
  MiniCluster and the WebMonitor (ROADMAP queue 1, item 15).

Integer-valued data: everything compares bit for bit.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import numpy as np
import pytest
import torch

from torch_library_parity import reference_cases, run_reference_case
from torch_parity import lanes_torch
from test_torch_sharded import eight_devices  # noqa: F401 (the fixture)
from test_torch_stages import (
    D, assert_fires_equal, assert_stage_equal, chain_specs, drains,
)

from flink_tpu.cep import Pattern as PJ
from flink_tpu.cep.accel import DeviceCepOperator as CepJ
from flink_tpu.parallel.mesh import MeshContext as MeshRef
from flink_tpu.runtime import step as step_ref
from flink_tpu_torch import StreamExecutionEnvironment as EnvT
from flink_tpu_torch.cep import CEP, NFA, Pattern
from flink_tpu_torch.cep.accel import DeviceCepOperator
from flink_tpu_torch.core.config import Configuration as ConfT
from flink_tpu_torch.core.keygroups import assign_to_key_group
from flink_tpu_torch.core.time import TimeCharacteristic as TCT
from flink_tpu_torch.ops.hashing import route_hash
from flink_tpu_torch.parallel.mesh import MeshContext
from flink_tpu_torch.runtime import step as step_port
from flink_tpu_torch.runtime.sinks import CollectSink
from flink_tpu_torch.runtime.sources import GeneratorSource

MAXP = 128
CPU = torch.device("cpu")


# ------------------------------------------------------- the drains

def _partition(slot, ends):
    """One staged batch split by owning shard, each shard's lanes packed
    in lane order into a batch of the same width (the sharded ring's
    layout): [n] of (hi, lo, ts, vals, valid)."""
    hi, lo, ts, vals, valid = slot
    kg = assign_to_key_group(route_hash(hi, lo, np), MAXP, np)
    owner = np.searchsorted(ends, kg)
    out = []
    for s in range(len(ends)):
        mine = np.nonzero(owner == s)[0]
        part = []
        for a in (hi, lo, ts, vals, valid):
            z = np.zeros_like(a)
            z[:len(mine)] = a[mine]
            part.append(z)
        out.append(tuple(part))
    return out


def _shard_rows(tree, s):
    """Shard s's slice of a reference state stacked over the mesh, its
    leading axis kept (a one-shard stacked state)."""
    return jax.tree_util.tree_map(lambda x: x[s:s + 1], tree)


@pytest.mark.parametrize("route, n", [("mask", 4), ("sharded", 2),
                                      ("sharded", 4)])
def test_sharded_chained_drain_matches_reference(route, n):
    specs_j, specs_t = chain_specs([(10, 10), (40, 40)], "direct")
    ctx_j = MeshRef.create(n, MAXP, devices=jax.devices()[:n])
    ctx = MeshContext.create(n, MAXP, devices=[CPU] * n)
    ends = ctx.kg_bounds()[1]
    if route == "mask":
        drain_j = step_ref.build_window_chained_drain(
            ctx_j, specs_j, D, drain_stats=True)
        drain_t = step_port.build_sharded_chained_drain(
            ctx, specs_t, D, route, drain_stats=True)
    else:
        drain_j = step_ref.build_window_chained_drain_sharded(
            ctx_j, specs_j, D, drain_stats=True)
        drain_t = step_port.build_window_chained_drain_sharded(
            ctx, specs_t, D, drain_stats=True)
    sj = tuple(step_ref.init_sharded_state(ctx_j, sp) for sp in specs_j)
    st = [tuple(step_port.init_shard_state(sp, MAXP, CPU) for sp in specs_t)
          for _ in range(n)]
    n_rows = 0
    for g, (group, count) in enumerate(drains(41, "direct")):
        wm = np.array([b[5] for b in group], np.int32)
        wmv = np.tile(wm, (n, 1))
        if route == "mask":
            flat = [a for b in group for a in b[:5]]
            sj, _m, fj, (ds_j, ss_j) = drain_j(sj, *flat, wmv,
                                               np.int32(count))
            out = drain_t(st, [lanes_torch(*b[:5]) for b in group],
                          torch.from_numpy(wm), count)
        else:
            parts = [_partition(b[:5], ends) for b in group]
            # shard 0 drains one slot fewer every other group: divergent
            # counts (its last slot's records wait in its ring)
            counts = [count - (s == 0 and g % 2 == 1 and count > 1)
                      for s in range(n)]
            flat = [np.stack([p[s][c] for s in range(n)])
                    for p in parts for c in range(5)]
            sj, _m, fj, (ds_j, ss_j) = drain_j(
                sj, *flat, wmv, np.asarray(counts, np.int32))
            out = drain_t(st, [[lanes_torch(*p[s]) for p in parts]
                               for s in range(n)],
                          torch.from_numpy(wm), counts)
        st, _mon, ft, (ds_t, ss_t) = out
        assert tuple(ds_t.shape) == (n, D, 9)
        np.testing.assert_array_equal(ds_t.numpy(), np.asarray(ds_j))
        np.testing.assert_array_equal(ss_t.numpy(), np.asarray(ss_j))
        for s in range(n):
            assert_fires_equal(_shard_rows(fj, s), ft[s])
            for i, (a, b) in enumerate(zip(sj, st[s])):
                assert_stage_equal(_shard_rows(a, s), b, ref_packed=i == 0,
                                   exact=True)
            n_rows += int(ft[s].counts.sum())
    assert n_rows > 0
    assert drain_t.stage_lanes.shape[0] == n * 2 * specs_t[0].win.fire_lanes


# ------------------------------------------------------------ the CEP

def _cep_events(n=600, keys=40, seed=9):
    rng = np.random.default_rng(seed)
    names = np.array(list("abx"))[rng.integers(0, 3, n)]
    return [(int(k), str(a), i) for i, (k, a) in enumerate(
        zip(rng.integers(0, keys, n).tolist(), names.tolist()))]


def _pattern(P, within=None):
    p = (P.begin("a").where(lambda e: e[1] == "a")
         .followed_by("b").where(lambda e: e[1] == "b"))
    return p.within(within) if within else p


@pytest.mark.parametrize("within", [None, 50])
def test_sharded_cep_operator_matches_reference(within):
    evs = _cep_events()
    op_j = CepJ(_pattern(PJ, within), capacity=64, n_shards=4,
                max_parallelism=MAXP)
    op_t = DeviceCepOperator(_pattern(Pattern, within), capacity=64,
                             n_shards=4, max_parallelism=MAXP, device="cpu")
    got, want = [], []
    for off in range(0, len(evs), 48):
        chunk = evs[off:off + 48]
        keys = [e[0] for e in chunk]
        want += op_j.process_batch(chunk, keys, ts=chunk[0][2])
        got += op_t.process_batch(chunk, keys, ts=chunk[0][2])
    pick = lambda ms: [(m["a"][2], m["b"][2]) for m in ms]  # noqa: E731
    assert pick(got) == pick(want) and got
    assert op_t.matches_detected == op_t.matches_extracted \
        == op_j.matches_detected
    assert op_t.dropped_capacity == op_j.dropped_capacity
    snap_j, snap_t = op_j.snapshot(), op_t.snapshot()
    d_j = snap_j["device"]
    carry_j = np.asarray(d_j.carry)
    rows_j = np.asarray(d_j.table.keys)
    for s in range(4):
        # each shard's keys and each key's carry row, slot order aside
        def by_key(rows, carry):
            occ = ~np.all(rows == 0xFFFFFFFF, axis=1)
            return {(int(h), int(lo)): c.tolist() for (h, lo), c in
                    zip(rows[occ], carry[:-1][occ])}
        assert by_key(snap_t["device"]["table.keys"][s],
                      snap_t["device"]["carry"][s]) == \
            by_key(rows_j[s], carry_j[s])
    # the snapshot restores into a fresh four-shard operator
    op_r = DeviceCepOperator(_pattern(Pattern, within), capacity=64,
                             n_shards=4, max_parallelism=MAXP, device="cpu")
    op_r.restore(snap_j)
    np.testing.assert_array_equal(op_r.snapshot()["device"]["carry"],
                                  carry_j)


def _host_matches(evs, pattern, within=None):
    """The exact host NFA (cep/nfa.py) over each key's events in arrival
    order: (a's index, b's index) of every match."""
    nfa, out = NFA(pattern), []
    for k in sorted({e[0] for e in evs}):
        partials = []
        for e in evs:
            if e[0] == k:
                partials, ms = nfa.process(partials, e, e[2])
                out += [(m["a"][2], m["b"][2]) for m in ms]
    return sorted(out)


@pytest.mark.parametrize("parallelism", [2, 4, 8])
@pytest.mark.parametrize("time", ["processing", "event", "event_within"])
def test_cep_job_at_parallelism(parallelism, time):
    evs = _cep_events(n=400)
    within = 40 if time == "event_within" else None
    env = EnvT(ConfT({}), device="cpu")
    env.set_parallelism(parallelism).set_max_parallelism(MAXP)
    env.batch_size = 64
    stream = env.from_collection(evs)
    if time == "processing":
        env.set_stream_time_characteristic(TCT.ProcessingTime)
    else:
        env.set_stream_time_characteristic(TCT.EventTime)
        stream = stream.assign_timestamps_and_watermarks(lambda e: e[2])
    sink = CollectSink()
    CEP.pattern(stream.key_by(lambda e: e[0]),
                _pattern(Pattern, within)).select(
        lambda m: (m["a"][2], m["b"][2])).add_sink(sink)
    job = env.execute("cep")
    m = job.metrics
    assert m.cep_matches_detected == m.cep_matches_extracted > 0
    assert len(job.state) == parallelism
    if within is None:
        assert sorted(sink.results) == _host_matches(
            evs, _pattern(Pattern))
    else:
        # within() expires by pane buckets (the host replay sees the
        # card's pane-quantised timestamps): the matches are those of one
        # shard, which tests/test_torch_cep.py holds against the reference
        env1 = EnvT(ConfT({}), device="cpu")
        env1.set_parallelism(1).set_max_parallelism(MAXP)
        env1.batch_size = 64
        env1.set_stream_time_characteristic(TCT.EventTime)
        one = CollectSink()
        CEP.pattern(env1.from_collection(evs).assign_timestamps_and_watermarks(
            lambda e: e[2]).key_by(lambda e: e[0]),
            _pattern(Pattern, within)).select(
            lambda m: (m["a"][2], m["b"][2])).add_sink(one)
        env1.execute("cep-1")
        assert sorted(sink.results) == sorted(one.results)


# ----------------------------------------------------- chained jobs

N_KEYS, W1, W2 = 64, 10_000, 20_000


def _gen(offset, n):
    idx = np.arange(offset, offset + n)
    return ({"key": (idx * 48271) % N_KEYS,
             "value": ((idx * 7) % 5).astype(np.float32)}, (idx // 50) * 1000)


def _oracle(total):
    idx = np.arange(total)
    s1 = {}
    for k, t, v in zip(((idx * 48271) % N_KEYS).tolist(),
                       ((idx // 50) * 1000).tolist(),
                       ((idx * 7) % 5).astype(float).tolist()):
        kw = (k, (t // W1 + 1) * W1)
        s1[kw] = s1.get(kw, 0.0) + v
    s2 = {}
    for (k, e1), v in s1.items():
        kw = (k, ((e1 - 1) // W2 + 1) * W2)
        s2[kw] = s2.get(kw, 0.0) + v
    return s2


CHAIN_CFG = {"pipeline.prefetch": "on", "pipeline.device-staging": "on",
             "pipeline.resident-loop": "on", "pipeline.ring-depth": 4}


@pytest.mark.parametrize("parallelism", [2, 4, 8])
@pytest.mark.parametrize("dp", ["off", "on"])
def test_chained_job_at_parallelism(parallelism, dp):
    total = 4096
    env = EnvT(ConfT({**CHAIN_CFG, "pipeline.data-parallel": dp}),
               device="cpu")
    env.set_parallelism(parallelism).set_max_parallelism(128)
    env.set_stream_time_characteristic(TCT.EventTime)
    env.set_state_capacity(256)
    env.batch_size = 256
    sink = CollectSink()
    (env.add_source(GeneratorSource(_gen, total=total))
     .key_by(lambda c: c["key"]).time_window(W1).sum(lambda c: c["value"])
     .key_by(lambda r: r.key).time_window(W2).sum(lambda r: r.value)
     .add_sink(sink))
    job = env.execute("chained")
    got = {(r.key, r.window_end_ms): r.value for r in sink.results}
    assert got == _oracle(total)
    m = job.metrics
    assert m.resident_drains > 0 and m.dropped_capacity == 0
    if dp == "on":
        assert m.steps_sharded > 0
    else:
        assert m.steps_sharded == 0


# ------------------------------------------------- the reference's cases

CASES = (reference_cases("test_cep_accel.py", names=(
    "test_multi_shard_matches_single_shard", "test_multi_shard_with_within",
    "test_shard_count_restore_mismatch_rejected"))
    + reference_cases("test_stages.py", names=(
        "test_two_stage_chain_bit_exact_sharded",
        "test_chain_rejects_all_to_all_exchange")))


@pytest.mark.parametrize("test_file, name, params", CASES)
def test_reference_chain_and_cep_cases_at_parallelism(test_file, name,
                                                       params, request,
                                                       monkeypatch):
    run_reference_case(test_file, name, params, request, monkeypatch)
