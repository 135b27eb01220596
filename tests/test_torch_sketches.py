"""flink_tpu_torch's sketch windows (Count-Min, HyperLogLog: BASELINE
config #3) against flink_tpu's, on the CPU.

The JAX reference runs as its own tests run it (``JAX_PLATFORMS=cpu``),
with split state planes, the only planes it gives a sketch; the port runs
its kernels' plain versions (G2's split variant, G14 ``sketch_update``,
G15 ``sketch_fire``). Inputs are made with numpy from fixed seeds: the
six-batch schedule of ``tests/torch_parity.py`` in the hash layout, its
lanes carrying item hashes made by ``hash32_host`` (so nearly all exceed
2^24, most 2^31), a hot item in a quarter of the lanes and the query
items among the rest.

Tolerances: registers, touched bits, counters, keys, Count-Min values and
counts are compared exactly (integers). HyperLogLog estimates get rtol
1e-5 and an absolute ``hll_atol(m)`` = 4 m ulp(log m) in float32: the
reference takes linear counting's ``m (log m - log zeros)`` in float32,
where the two logs cancel and their rounding is multiplied by m (up to
~2e-5 relative at m = 256, and far more at small counts with m = 4096);
the port takes it in float64. Value sums of HyperLogLog lanes add those
differences over the lane's rows.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    DEPTH, F, KINDS, MAXP, P, QUERY, R, WIDTH, assert_sketch_states_equal,
    assert_values_equal, hll_atol, jax_sketch_kernels, port_lanes,
    reduce_specs, set_watermark, sketch_batches, sketch_fire_rows,
    sketch_states,
)

from flink_tpu.ops import sketches as skj
from flink_tpu.ops import window_kernels as wkj
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import sketches as skt
from flink_tpu_torch.ops import window_kernels as wkt

# -- the hash words ------------------------------------------------------

def edge_hashes() -> np.ndarray:
    """Hashes at the edges: 0, 2^24 +- 1, 2^31, 2^32 - 1, random words, and
    words whose fmix32 has its low 32 - p bits zero (rho = 33 - p)."""
    cand = np.arange(1 << 22, dtype=np.uint32)
    mixed = skt._fmix32_np(cand)
    zero_w = cand[(mixed << np.uint32(P)) == 0][:4]
    assert len(zero_w) > 0
    rng = np.random.default_rng(3)
    return np.concatenate([
        np.array([0, (1 << 24) - 1, 1 << 24, (1 << 24) + 1, 1 << 31,
                  0xFFFFFFFF], np.uint32),
        zero_w, rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(
            np.uint32)])


def test_fmix_positions_and_rank_equal_jnp_bit_for_bit():
    h = edge_hashes()
    t = torch.from_numpy(h.view(np.int32).copy())
    np.testing.assert_array_equal(
        skt._fmix32(t.to(torch.int64) & 0xFFFFFFFF).numpy().astype(
            np.uint32), np.asarray(skj._fmix32(jnp.asarray(h))))
    flat = np.zeros(len(h), np.int32)
    live = np.ones(len(h), bool)
    cms_j = skj.CountMinSketch(DEPTH, WIDTH)
    cms_t = skt.CountMinSketch(DEPTH, WIDTH)
    eidx_j, _, _ = cms_j.expand(jnp.asarray(flat), jnp.asarray(h),
                                jnp.asarray(live))
    eidx_t, upd_t, _ = cms_t.expand(torch.from_numpy(flat), t,
                                    torch.from_numpy(live))
    np.testing.assert_array_equal(eidx_t.numpy(), np.asarray(eidx_j))
    assert (upd_t == 1).all()
    hll_j, hll_t = skj.HyperLogLog(P), skt.HyperLogLog(P)
    eidx_j, rho_j, _ = hll_j.expand(jnp.asarray(flat), jnp.asarray(h),
                                    jnp.asarray(live))
    eidx_t, rho_t, _ = hll_t.expand(torch.from_numpy(flat), t,
                                    torch.from_numpy(live))
    np.testing.assert_array_equal(eidx_t.numpy(), np.asarray(eidx_j))
    np.testing.assert_array_equal(rho_t.numpy(), np.asarray(rho_j))
    assert int(rho_t.max()) == 33 - P      # the h << p == 0 words


@pytest.mark.parametrize("p", [4, 12, 16])
def test_hll_finalize_matches_reference(p):
    """The exact integer register sum gives the reference's estimate, in
    both of its regimes (linear counting, raw)."""
    hj, ht = skj.HyperLogLog(p), skt.HyperLogLog(p)
    rng = np.random.default_rng(p)
    regs = np.zeros((5, hj.m), np.int32)
    for i, n in enumerate((1, 10, hj.m // 2, 3 * hj.m, 40 * hj.m)):
        items = rng.integers(0, 2**62, n)
        acc = hj.host_init()
        for it in items[:2000]:
            hj.host_add(acc, int(it))
        # bulk register values of n distinct items (the same law as expand)
        mixed = skt._fmix32_np(skt.hash32_host(items))
        bucket = mixed >> np.uint32(32 - p)
        w = (mixed.astype(np.uint64) << np.uint64(p)) & np.uint64(
            0xFFFFFFFF)
        rho = np.where(w == 0, 33 - p, 32 - np.floor(np.log2(
            np.maximum(w, 1).astype(np.float64))).astype(np.int64))
        np.maximum.at(regs[i], bucket.astype(np.int64), rho.astype(np.int32))
        if n <= 2000:
            np.testing.assert_array_equal(acc, regs[i])
    want = np.asarray(hj.finalize(jnp.asarray(regs)))
    got = ht.finalize(torch.from_numpy(regs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=hll_atol(hj.m))
    np.testing.assert_allclose(
        got, [ht.host_result(r) for r in regs], rtol=1e-6)


# -- the update and the fire ---------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_update_sequence_matches_reference(kind):
    """G1, G2 (split), G5 and G14 over the six batches: the registers,
    touched bits, kg_dirty, pane_ids, counters and activity."""
    _, _, win_t, red_t, sj, st = sketch_states(kind)
    upd, _, _ = jax_sketch_kernels(kind)
    for hi, lo, ts, h, valid, wm, clear in sketch_batches(7):
        sj, act_j = upd(sj, hi, lo, ts, h, valid, clear)
        st, act_t, _kgf = wkt.update(st, win_t, red_t,
                               *port_lanes(hi, lo, ts, h, valid), maxp=MAXP,
                               clear_rows=torch.from_numpy(clear))
        assert int(act_t) == int(act_j)
        assert_sketch_states_equal(sj, st)
        sj = set_watermark(sj, st, int(wm))
    assert int(st.dropped_late) > 0 and int(st.dropped_capacity) > 0
    assert st.kg_dirty.any() and st.touched.any()


@pytest.mark.parametrize("kind", KINDS)
def test_fire_and_purge_sequence_matches_reference(kind):
    """update -> watermark -> advance_and_fire_resident (rows, G15), purge
    rows deferred into the next update's sweep, the last applied with
    apply_pending_purge; each lane's rows equal the reference's."""
    win_j, red_j, win_t, red_t, sj, st = sketch_states(kind)
    upd, adv, _ = jax_sketch_kernels(kind)
    pend_j = np.zeros(R, bool)
    pend_t = torch.zeros(R, dtype=torch.bool)
    n_rows = 0
    for hi, lo, ts, h, valid, wm, _clear in sketch_batches(11):
        sj, _ = upd(sj, hi, lo, ts, h, valid, pend_j)
        wkt.update(st, win_t, red_t, *port_lanes(hi, lo, ts, h, valid),
                   maxp=MAXP, clear_rows=pend_t)
        sj = set_watermark(sj, st, int(wm))
        sj, pend_j, fr_j = adv(sj, np.int32(wm))
        st, pend_t, fr_t = wkt.advance_and_fire_resident(
            st, win_t, red_t, torch.tensor(int(wm), dtype=torch.int32))
        for name in ("counts", "window_end_ticks", "n_fires", "lane_valid"):
            np.testing.assert_array_equal(getattr(fr_t, name).numpy(),
                                          np.asarray(getattr(fr_j, name)),
                                          err_msg=name)
        np.testing.assert_array_equal(pend_t.numpy(), np.asarray(pend_j))
        for f in range(F):
            wj, vj = sketch_fire_rows(fr_j, f)
            wt, vt = sketch_fire_rows(fr_t, f)
            np.testing.assert_array_equal(wt, wj)
            assert vt.shape == vj.shape and vt.dtype == vj.dtype
            assert_values_equal(kind, vt, vj, err=f"lane {f}")
            n_rows += len(wt)
        assert_values_equal(kind, fr_t.value_sums.numpy(),
                            np.asarray(fr_j.value_sums),
                            n_rows=int(fr_t.counts.max()), err="value_sums")
        assert_sketch_states_equal(sj, st)
    sj = wkj.apply_pending_purge(sj, win_j, red_j, pend_j)
    wkt.apply_pending_purge(st, win_t, red_t, pend_t)
    assert_sketch_states_equal(sj, st)
    assert n_rows > 0 and np.asarray(pend_j).any()


@pytest.mark.parametrize("kind", KINDS)
def test_reduced_fires_match_reference(kind):
    """The device-reduce sinks' fire mode: per lane (count, value sum)."""
    _, _, win_t, red_t, sj, st = sketch_states(kind)
    upd, _, adv_reduced = jax_sketch_kernels(kind)
    pend_j = np.zeros(R, bool)
    pend_t = torch.zeros(R, dtype=torch.bool)
    fired = 0
    for hi, lo, ts, h, valid, wm, _clear in sketch_batches(13):
        sj, _ = upd(sj, hi, lo, ts, h, valid, pend_j)
        wkt.update(st, win_t, red_t, *port_lanes(hi, lo, ts, h, valid),
                   maxp=MAXP, clear_rows=pend_t)
        sj = set_watermark(sj, st, int(wm))
        sj, pend_j, fr_j = adv_reduced(sj, np.int32(wm))
        st, pend_t, fr_t = wkt.advance_and_fire_resident(
            st, win_t, red_t, int(wm), reduced=True)
        np.testing.assert_array_equal(fr_t.counts.numpy(),
                                      np.asarray(fr_j.counts))
        assert_values_equal(kind, fr_t.value_sums.numpy(),
                            np.asarray(fr_j.value_sums),
                            n_rows=int(fr_t.counts.max()))
        fired += int(fr_t.counts.sum())
    assert fired > 0


def test_sketch_plain_versions_take_the_edge_hashes():
    """G14's plain version on the edge hashes lands the reference's
    registers: one key, every lane on it, one pane."""
    h = edge_hashes()
    n = len(h)
    for kind in ("hll", "cms_raw"):
        red_j, red_t = reduce_specs(kind)
        W = red_t.value_shape[0]
        acc = torch.zeros(4 * R, W, dtype=torch.int32)
        touched = torch.zeros(4 * R, dtype=torch.bool)
        dropped = torch.zeros((), dtype=torch.int32)
        z = torch.zeros(n, dtype=torch.int32)
        kernels.sketch_update_plain(
            acc, touched, None, dropped, z, z, torch.ones(n, dtype=torch.bool),
            torch.full((n,), 2, dtype=torch.int32),
            torch.from_numpy(h.view(np.int32).copy()),
            torch.tensor(0, dtype=torch.int32), C=4, R=R,
            sketch=red_t.sketch)
        eidx, upd, mask = red_j.sketch.expand(
            jnp.full(n, 2, jnp.int32), jnp.asarray(h), jnp.ones(n, bool))
        want = np.zeros(4 * R * W, np.int64)
        if kind == "hll":
            np.maximum.at(want, np.asarray(eidx), np.asarray(upd))
        else:
            np.add.at(want, np.asarray(eidx), np.asarray(upd))
        np.testing.assert_array_equal(acc.reshape(-1).numpy(), want)
        assert touched.nonzero().reshape(-1).tolist() == [2]
        assert int(dropped) == 0


# -- whole jobs through both public APIs ---------------------------------

N_EVENTS, N_STREAM_KEYS, CAPACITY = 6000, 300, 1024


def _stream():
    rng = np.random.default_rng(21)
    keys = rng.integers(0, N_STREAM_KEYS, N_EVENTS)
    items = rng.integers(0, 5000, N_EVENTS) * 1000003   # ids past 2^24
    items[rng.random(N_EVENTS) < 0.3] = 1
    items[rng.random(N_EVENTS) < 0.05] = 2
    ts = np.sort(rng.integers(0, 20_000, N_EVENTS))
    return keys, items, ts


def run_sketch_job(pkg, kind, sink_kind="rows", config=None):
    if pkg == "jax":
        from flink_tpu import StreamExecutionEnvironment
        from flink_tpu.core.config import Configuration
        from flink_tpu.core.time import TimeCharacteristic
        from flink_tpu.runtime import sinks
        from flink_tpu.runtime.sources import GeneratorSource
        kw = {}
    else:
        from flink_tpu_torch import StreamExecutionEnvironment
        from flink_tpu_torch.core.config import Configuration
        from flink_tpu_torch.core.time import TimeCharacteristic
        from flink_tpu_torch.runtime import sinks
        from flink_tpu_torch.runtime.sources import GeneratorSource
        kw = {"device": "cpu"}
    keys, items, ts = _stream()

    def gen(o, m):
        s = slice(o, o + m)
        return {"key": keys[s], "item": items[s]}, ts[s]

    env = StreamExecutionEnvironment(Configuration(dict(
        {"state.packed-planes": "off", "pipeline.ring-depth": 4},
        **(config or {}))), **kw)
    env.set_parallelism(1)
    env.set_max_parallelism(128)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(CAPACITY)
    env.batch_size = 512
    sink = {"rows": sinks.CollectSink, "count": sinks.CountingSink,
            "columns": getattr(sinks, "ColumnarCollectSink", None)}[
        sink_kind]()
    w = (env.add_source(GeneratorSource(gen, total=N_EVENTS))
         .key_by(lambda c: c["key"]).time_window(4000, 2000))
    if kind == "hll":
        s = w.distinct_count(lambda c: c["item"], precision=P)
    else:
        s = w.count_min(lambda c: c["item"], depth=DEPTH, width=WIDTH,
                        query=QUERY if kind == "cms_query" else None)
    s.add_sink(sink)
    job = env.execute(f"sketch-{kind}")
    return sink, job


@pytest.mark.parametrize("kind", KINDS)
def test_sketch_job_rows_equal_reference(kind):
    sink_j, _ = run_sketch_job("jax", kind)
    sink_t, job_t = run_sketch_job("torch", kind)
    got = sorted((r.key, r.window_end_ms, r.value) for r in sink_t.results)
    want = sorted((r.key, r.window_end_ms, r.value) for r in sink_j.results)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert len(got) > N_STREAM_KEYS
    gv = np.array([g[2] for g in got])
    wv = np.array([w[2] for w in want])
    assert_values_equal(kind, gv, wv)
    assert job_t.state.layout == "hash" and job_t.state.packed == -1
    assert job_t.metrics.dropped_capacity == 0
    if kind == "cms_raw":
        # the raw registers answer host-side point queries
        cms = skt.CountMinSketch(DEPTH, WIDTH)
        assert (cms.estimate_np(np.asarray(got[0][2]), [1]) >= 0).all()


@pytest.mark.parametrize("kind", ["hll", "cms_query"])
def test_sketch_job_reduced_and_columnar_sinks(kind):
    """A device-reduce sink gets the reference's (count, value sum); a
    columnar sink a value column of [n] estimates or [n, Q] vectors, the
    rows of the row sink."""
    cnt_j, _ = run_sketch_job("jax", kind, "count")
    cnt_t, _ = run_sketch_job("torch", kind, "count")
    assert cnt_t.count == cnt_j.count > 0
    assert_values_equal(kind, np.float64(cnt_t.value_sum),
                        np.float64(cnt_j.value_sum), n_rows=cnt_t.count)
    cols_t, _ = run_sketch_job("torch", kind, "columns")
    rows_t, _ = run_sketch_job("torch", kind)
    cols = cols_t.columns()
    shape = (cnt_t.count,) + (() if kind == "hll" else (len(QUERY),))
    assert cols["value"].shape == shape
    got = sorted(zip(cols["key_id"].tolist(), cols["window_end_ms"].tolist(),
                     np.asarray(cols["value"]).tolist()))
    want = sorted((r.key, r.window_end_ms, r.value) for r in rows_t.results)
    assert got == want


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("config", [{"state.backend.overflow-ring": 4096},
                                    {"state.packed-planes": "on"}],
                         ids=["overflow_ring", "packed_planes"])
def test_sketch_stage_refuses_spill_and_packed_planes(pkg, config):
    with pytest.raises(ValueError):
        run_sketch_job(pkg, "hll", config=config)


def test_count_min_never_undercounts():
    """Each query estimate of the port's rows is at least the item's exact
    count in the (key, window)."""
    sink, _ = run_sketch_job("torch", "cms_query")
    keys, items, ts = _stream()
    for r in sink.results:
        inw = (keys == r.key) & (ts >= r.window_end_ms - 4000) \
            & (ts < r.window_end_ms)
        exact = [int(np.sum(inw & (items == q))) for q in QUERY]
        assert all(e >= x for e, x in zip(r.value, exact)), (r, exact)


def test_state_planes_and_guard():
    """init_state: split int32 registers and touched bits for a sketch,
    and the reference's int32-index guard on C*R*W."""
    _, red_t = reduce_specs("hll")
    win = wkt.WindowSpec(20, 10, ring=4)
    st = wkt.init_state(64, win, red_t, device="cpu", layout="hash")
    assert st.acc.shape == (256, 1 << P) and st.acc.dtype == torch.int32
    assert st.touched.shape == (256,) and st.packed == -1
    assert st.ovf_val.shape == (0, 1 << P)
    with pytest.raises(ValueError, match="int32"):
        wkt.init_state(1 << 20, dataclasses.replace(win, ring=16),
                       wkt.ReduceSpec("sketch", torch.int32, (1 << 12,),
                                      sketch=skt.HyperLogLog(12)),
                       device="meta", layout="hash")
    with pytest.raises(ValueError):
        wkt.init_state(64, dataclasses.replace(win, overflow=16), red_t,
                       device="cpu", layout="hash")
