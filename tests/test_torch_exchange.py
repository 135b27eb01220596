"""The keyed record exchange (K12) and the cross-shard sum (K18's psum) of
the port against the reference, on the CPU: G26's plain version
(``ops/cuda.py exchange_pack``) with ``parallel/collectives.py
all_to_all`` against ``flink_tpu/parallel/exchange.py exchange_records``
under ``shard_map`` over 4 of the conftest's 8 CPU devices (received
lanes, their order, and the overflow counts), G27's plain version against
the reference's rolling psum, and the route planner's answers
(``bucket_capacity``, ``plan_route``, ``plan_route_and_shards``) against
the reference's on the same inputs.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flink_tpu.core.compat import shard_map
from flink_tpu.ops import window_kernels as wkj
from flink_tpu.parallel import exchange as ex_ref
from flink_tpu.parallel.mesh import SHARD_AXIS, MeshContext as MeshRef
from flink_tpu.runtime import ingest as ingest_ref
from flink_tpu.runtime import step as step_ref
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import window_kernels as wkt
from flink_tpu_torch.parallel import exchange as ex_port
from flink_tpu_torch.parallel.collectives import all_to_all, psum
from flink_tpu_torch.parallel.mesh import MeshContext
from flink_tpu_torch.runtime import ingest as ingest_port
from flink_tpu_torch.runtime import step as step_port

N = 4
MAXP = 128
CPU = torch.device("cpu")


def _mesh_ref(n=N):
    return MeshRef.create(n, MAXP, devices=jax.devices()[:n])


def _keys(rng, B, n_keys):
    k = rng.integers(0, n_keys, B).astype(np.uint64) * np.uint64(
        0x9E3779B97F4A7C15) + np.uint64(1)
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _batch(seed, B, n_keys=300, W=0, valid_frac=1.0):
    rng = np.random.default_rng(seed)
    hi, lo = _keys(rng, B, n_keys)
    ts = rng.integers(0, 5000, B).astype(np.int32)
    vals = rng.random((B, W) if W else B).astype(np.float32)
    valid = rng.random(B) < valid_frac
    return hi, lo, ts, vals, valid


def _reference(hi, lo, ts, vals, valid, cap, n=N):
    """exchange_records under shard_map: each device's received lanes
    ([n * cap] a device, concatenated) and its overflow count."""
    mesh = _mesh_ref(n).mesh

    def body(h, l, t, v, ok):
        cols, r_hi, r_lo, r_ok, n_over = ex_ref.exchange_records(
            {"ts": t, "values": v}, h, l, ok, n, MAXP, cap)
        return r_hi, r_lo, cols["ts"], cols["values"], r_ok, n_over[None]

    f = shard_map(body, mesh=mesh, in_specs=(P(SHARD_AXIS),) * 5,
                  out_specs=(P(SHARD_AXIS),) * 6, check_vma=False)
    out = jax.jit(f)(*(jnp.asarray(a) for a in (hi, lo, ts, vals, valid)))
    return [np.asarray(o) for o in out]


def _port(hi, lo, ts, vals, valid, cap, n=N):
    def t(a):
        a = np.asarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a)

    slot = tuple(t(a) for a in (hi, lo, ts, vals, valid))
    received, over = ex_port.exchange_records(
        ex_port.split_lanes(slot, n, [CPU] * n), n, MAXP, cap, [CPU] * n)
    cols = [np.concatenate([r[j].numpy() for r in received])
            for j in range(5)]
    cols[0] = cols[0].view(np.uint32)
    cols[1] = cols[1].view(np.uint32)
    return cols + [np.concatenate([o.numpy() for o in over])]


def _pad(arrays, B_step):
    """The executor's padding of a batch to a multiple of the shards."""
    out = []
    for a in arrays:
        pad = np.zeros((B_step - len(a),) + a.shape[1:], a.dtype)
        out.append(np.concatenate([a, pad]))
    return out


@pytest.mark.parametrize("case", ["balanced", "one_key", "all_invalid",
                                  "w2", "ragged", "one_lane"])
def test_exchange_matches_reference_exchange_records(case):
    B = 256
    if case == "balanced":
        arrays = _batch(1, B)
    elif case == "one_key":
        arrays = _batch(2, B, n_keys=1)           # every lane to one shard
    elif case == "all_invalid":
        arrays = _batch(3, B, valid_frac=0.0)
    elif case == "w2":
        arrays = _batch(4, B, W=2, valid_frac=0.8)
    elif case == "one_lane":
        arrays = _batch(7, N)                     # one lane a shard
    else:
        # B = 250 is no multiple of 4: the batch pads to 252 invalid lanes
        arrays = _pad(_batch(5, 250, valid_frac=0.9), 252)
        arrays[4][250:] = False
    B = len(arrays[0])
    cap = ex_port.bucket_capacity(B // N, N, 2.0)
    assert cap == ex_ref.bucket_capacity(B // N, N, 2.0)
    want = _reference(*arrays, cap)
    got = _port(*arrays, cap)
    for w, g, name in zip(want, got, ("hi", "lo", "ts", "values", "valid",
                                      "overflow")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    if case == "one_key":
        assert got[5].sum() > 0          # the hot bucket overflowed
    else:
        assert got[5].sum() == 0


def test_exchange_pack_is_stable_and_zero_past_fill():
    """Each target bucket holds its source's lanes in lane order, the
    slots past its fill are zero, and every valid lane is accounted for."""
    hi, lo, ts, vals, valid = _batch(6, 128, valid_frac=0.7)
    t = lambda a: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                   else a)
    cap = 40
    p = kernels.exchange_pack(t(hi), t(lo), t(ts), t(vals), t(valid), n=N,
                              maxp=MAXP, cap=cap)
    tgt = kernels.exchange_targets(t(hi), t(lo), N, MAXP).numpy()
    for b in range(N):
        lanes = np.nonzero(valid & (tgt == b))[0][:cap]
        got_ts = p.ts.numpy()[b * cap:b * cap + len(lanes)]
        np.testing.assert_array_equal(got_ts, ts[lanes])
        assert not p.valid.numpy()[b * cap + len(lanes):(b + 1) * cap].any()
        assert (p.hi.numpy()[b * cap + len(lanes):(b + 1) * cap] == 0).all()
    assert int(p.valid.sum()) + int(p.overflow) == int(valid.sum())


def test_all_to_all_hands_each_receiver_its_buckets():
    cap = 3
    bufs = [torch.arange(N * cap, dtype=torch.int32) + 100 * s
            for s in range(N)]
    recv = all_to_all(bufs, [CPU] * N)
    for t_ in range(N):
        want = torch.cat([bufs[s][t_ * cap:(t_ + 1) * cap]
                          for s in range(N)])
        assert torch.equal(recv[t_], want)


@pytest.mark.parametrize("W, floats", [(0, False), (0, True), (2, False)])
def test_shard_sum_matches_the_reference_rolling_psum(W, floats):
    """G27's plain version equals the reference's psum of the masked
    rolling outputs: build_rolling_step over 4 shards against the port's
    masked one-shard updates merged by ``psum``. Integer-valued data
    compares bit for bit; random floats at rtol 1e-6, as in
    tests/test_torch_rolling.py (the one-shard scans add in another
    order than the reference's)."""
    rng = np.random.default_rng(7 + W)
    B, C = 192, 256
    hi, lo = _keys(rng, B, 40)
    shape = (B, W) if W else B
    vals = (rng.random(shape) if floats
            else rng.integers(1, 9, shape)).astype(np.float32)
    valid = rng.random(B) < 0.9
    if W:
        red_j = wkj.ReduceSpec("generic", jnp.float32,
                               combine=lambda a, b: a + b, neutral=0.0,
                               value_shape=(W,))
        red_t = wkt.ReduceSpec("generic", torch.float32,
                               combine=lambda a, b: a + b, neutral=0.0,
                               value_shape=(W,))
    else:
        red_j = wkj.ReduceSpec("sum", jnp.float32)
        red_t = wkt.ReduceSpec("sum", torch.float32)
    ctx_j = _mesh_ref()
    spec_j = step_ref.RollingStageSpec(red=red_j, capacity_per_shard=C)
    st_j = step_ref.init_rolling_state(ctx_j, spec_j)
    _st, want_out, want_ok = step_ref.build_rolling_step(ctx_j, spec_j)(
        st_j, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vals),
        jnp.asarray(valid))
    ctx = MeshContext.create(N, MAXP, devices=[CPU] * N)
    spec = step_port.RollingStageSpec(red=red_t, capacity_per_shard=C)
    states = [step_port.init_rolling_state(spec, CPU) for _ in range(N)]
    step = step_port.build_rolling_step_sharded(ctx, spec)
    t = lambda a: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                   else a)
    _s, out, ok = step(states, t(hi), t(lo), t(vals), t(valid))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=1e-6 if floats else 0.0)
    # the merge itself: G27's contract on the shards' masked outputs
    outs = [torch.from_numpy(rng.random(B).astype(np.float32))
            for _ in range(N)]
    owner = torch.from_numpy(rng.integers(0, N + 1, B))
    oks = [owner == s for s in range(N)]
    got, got_ok = psum(outs, oks, CPU)
    want = sum(torch.where(o, x, torch.zeros(())) for x, o in zip(outs, oks))
    assert torch.equal(got, want) and torch.equal(got_ok, owner < N)


def _plans(routes, shard_cap=0, B=256, capf=2.0):
    ctx_j = _mesh_ref()
    ctx = MeshContext.create(N, MAXP, devices=[CPU] * N)
    cap = ex_port.bucket_capacity(B // N, N, capf)
    mask_sh, split_sh = ingest_ref.IngestPlan.shardings_for(ctx_j.mesh)
    ref = ingest_ref.IngestPlan(
        td=None, slide_ticks=1000, span_limit=8, B=B, B_step=B, n_shards=N,
        max_parallelism=MAXP, kg_ends=np.asarray(ctx_j.kg_bounds()[1]),
        exchange_cap=cap, routes=routes, staging=True,
        mask_sharding=mask_sh, split_sharding=split_sh, ring_depth=4,
        shard_cap=shard_cap)
    port = ingest_port.IngestPlan(
        td=None, slide_ticks=1000, span_limit=8, B=B, staging=True,
        B_step=B, n_shards=N, max_parallelism=MAXP,
        kg_ends=ctx.kg_bounds()[1], exchange_cap=cap, routes=routes,
        ring_depth=4, shard_cap=shard_cap)
    np.testing.assert_array_equal(ctx.kg_bounds()[0], ctx_j.kg_bounds()[0])
    return ref, port


@pytest.mark.parametrize("n_keys", [1, 7, 300, 10_000])
def test_route_planner_matches_reference(n_keys):
    rng = np.random.default_rng(n_keys)
    hi, lo = _keys(rng, 256, n_keys)
    for routes in (("mask",), ("exchange",), ("mask", "exchange")):
        ref, port = _plans(routes)
        assert ingest_port.plan_route(port, hi, lo) == \
            ingest_ref.plan_route(ref, hi, lo)
    for cap in (0, 40, 64, 256):
        ref, port = _plans(("mask", "exchange", "sharded"), shard_cap=cap)
        r_got, s_got = ingest_port.plan_route_and_shards(port, hi, lo)
        r_want, s_want = ingest_ref.plan_route_and_shards(ref, hi, lo)
        assert r_got == r_want
        if s_want is None:
            assert s_got is None
        else:
            np.testing.assert_array_equal(s_got, s_want)
    for b, n, f in ((12, 8, 4.0), (65_536, 4, 2.0), (3, 4, 2.0), (96, 8, 6.0)):
        assert ex_port.bucket_capacity(b, n, f) == \
            ex_ref.bucket_capacity(b, n, f)
