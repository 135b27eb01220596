"""K-step dispatch fusion in the port (flink_tpu_torch/runtime/step.py
``build_window_megastep`` / ``build_window_megastep_fired``, and the
executor's ``pipeline.steps-per-dispatch`` / ``pipeline.fused-fire``)
against the reference on the CPU, mirroring tests/test_megastep.py:

* the megasteps against the reference's on one state carried from the
  reference (``wk.state_from_numpy``) and the same batches: direct and
  hash layouts, the reference's pre-combine on and off, K of 2 and 4,
  the fast tier, the key-group fill, tiered state's residency mask,
  reduced and compact fires over consecutive groups (one arena, read
  between dispatches); states equal field by field (the hash layout's
  logically: the tables may place new keys at other slots), fires
  sub-step by sub-step;
* the megasteps against K sequential single steps of the port, bit for
  bit;
* whole jobs at K = 4 with ``pipeline.resident-loop: off``: the rows of
  the reference and of K = 1, fused fire on and off, full groups really
  fused; K = 1 fuses nothing; the fused-fire error is the reference's;
  ``auto`` with K above 1 resolves as the reference's (the scan drain on
  CUDA with staging, megasteps otherwise); allowed lateness (the
  reference's fired megastep traces it: rows equal under fused fire);
  the spill tier's rows against numpy in a sliding window (a sub-step's
  ring share folds before its own fires); a device-reduce sink; a crash
  inside a group under sync-full checkpoints, restored exactly once;
* the fused slot's grouping contract.

Integer-valued data, so everything compares bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import fire_rows, jax_fields, key_halves, logical_state
from test_torch_ingest import build_env, run_job

from flink_tpu.ops import window_kernels as wkj
from flink_tpu.parallel.mesh import MeshContext
from flink_tpu.runtime import step as step_ref
from flink_tpu_torch.ops import window_kernels as wkt
from flink_tpu_torch.runtime import executor as ex
from flink_tpu_torch.runtime import ingest as ingest_mod
from flink_tpu_torch.runtime import step as step_port
from flink_tpu_torch.runtime.sinks import CountingSink
from flink_tpu_torch.runtime.sources import GeneratorSource
from flink_tpu_torch.testing import faults
from flink_tpu_torch.testing.faults import FaultInjector, FaultRule

C, B, RING, F, MAXP = 4096, 512, 9, 4, 128
SLIDE, SIZE = 10, 20
OVF = 4096                # the tiered cases' overflow ring
SMALL = ("counts", "window_end_ticks", "n_fires", "lane_valid",
         "value_sums")


def _specs(layout, precombine, overflow=0):
    win_j = wkj.WindowSpec(SIZE, SLIDE, ring=RING, fires_per_step=F,
                           overflow=overflow)
    red_j = wkj.ReduceSpec("sum", jnp.float32)
    spec_j = step_ref.WindowStageSpec(win=win_j, red=red_j,
                                      capacity_per_shard=C, layout=layout,
                                      precombine=precombine, packed=True)
    spec_t = step_port.WindowStageSpec(
        win=wkt.WindowSpec(SIZE, SLIDE, ring=RING, fires_per_step=F,
                           overflow=overflow),
        red=wkt.ReduceSpec("sum"), capacity_per_shard=C, layout=layout)
    return spec_j, spec_t


def _batches(seed, n, layout):
    """``n`` batches of B lanes, one warm batch first: a few invalid
    lanes, duplicate-heavy keys (direct: [0, C); hash: a pool of 600
    sparse ids), each batch one to two panes past the last, watermarks
    that cross a pane at nearly every batch and make more windows due
    than F lanes twice."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(2**62), 2**62, 600, dtype=np.int64)
    out = []
    p = 0
    for i in range(n + 1):
        if layout == "direct":
            hi = np.zeros(B, np.uint32)
            lo = rng.integers(0, C, B).astype(np.uint32)
            lo[:32] = rng.integers(0, 8, 32)
        else:
            keys = pool[rng.integers(0, len(pool), B)]
            keys[:32] = pool[:4].repeat(8)
            hi, lo = key_halves(keys)
        ts = rng.integers(p * SLIDE, (p + 3) * SLIDE, B).astype(np.int32)
        vals = rng.integers(1, 9, B).astype(np.float32)
        valid = rng.random(B) < 0.9
        jump = 6 if i in (2, 5) else 1 + i % 2
        out.append((hi, lo, ts, vals, valid,
                    np.int32((p + 1) * SLIDE - 1 + (jump - 1) * SLIDE)))
        p += jump
    return out


def _lanes(b):
    hi, lo, ts, vals, valid = b[:5]
    return (torch.from_numpy(hi.view(np.int32).copy()),
            torch.from_numpy(lo.view(np.int32).copy()),
            torch.from_numpy(ts.copy()), torch.from_numpy(vals.copy()),
            torch.from_numpy(valid.copy()))


def _one(sj):
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[0], sj)


def _carried(spec_j, spec_t, warm):
    """A reference state after one warm batch, and the port's state
    carried from it."""
    ctx = MeshContext.create(1, MAXP, devices=jax.devices()[:1])
    sj = step_ref.init_sharded_state(ctx, spec_j)
    upd = step_ref.build_window_update_step(ctx, spec_j)
    sj, _ = upd(sj, *warm[:5], np.full(1, warm[5], np.int32))
    st = wkt.state_from_numpy(jax_fields(_one(sj)), sj.packed, device="cpu",
                              layout=spec_t.layout, probe_len=16)
    return ctx, sj, st


def _assert_states(sj, st, red_j, red_t, layout):
    want, got = jax_fields(_one(sj)), wkt.state_to_numpy(st)
    if layout == "hash":
        want, got = logical_state(want, red_j), logical_state(got, red_t)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def _assert_fires(fr_j, fr_t, i, compact):
    """Sub-step ``i`` of the port's [K, Ft] stack against the reference's
    [1, K, Ft] one: the small fields, and each lane's rows by key."""
    sub_j = jax.tree_util.tree_map(lambda x: np.asarray(x)[0, i], fr_j)
    for name in SMALL:
        np.testing.assert_array_equal(getattr(fr_t, name)[i].numpy(),
                                      getattr(sub_j, name), err_msg=name)
    rows = 0
    if compact:
        sub_t = type(fr_t)(*(getattr(fr_t, f.name)[i]
                             for f in dataclasses.fields(fr_t)))
        for f in range(fr_t.counts.shape[1]):
            (kt, vt), _ = fire_rows(sub_t, f)
            (kj, vj), _ = fire_rows(sub_j, f)
            np.testing.assert_array_equal(kt, kj)
            np.testing.assert_array_equal(vt, vj)
            rows += len(kt)
    return int(fr_t.counts[i].sum()), rows


# (layout, reference pre-combine, K, fast tier, kg_fill, tiered)
MEGA_CASES = {
    "direct_pre_k4_fill": ("direct", True, 4, False, True, False),
    "hash_nopre_k2": ("hash", False, 2, False, False, False),
    "hash_pre_k4_fast": ("hash", True, 4, True, False, False),
    "direct_nopre_k2_tiered": ("direct", False, 2, False, True, True),
}


@pytest.mark.parametrize("case", sorted(MEGA_CASES))
def test_megastep_matches_reference(case):
    """Two consecutive K-batch megasteps from the carried state: the
    monitoring outputs (post-dispatch ring fill, summed activity and
    key-group fill) and the state after each equal the reference's."""
    layout, pre, K, fast, kg_fill, tiered = MEGA_CASES[case]
    spec_j, spec_t = _specs(layout, pre, OVF if tiered else 0)
    seq = _batches(7, 2 * K, layout)
    ctx, sj, st = _carried(spec_j, spec_t, seq[0])
    mega_j = step_ref.build_window_megastep(ctx, spec_j, K, insert=not fast,
                                            kg_fill=kg_fill, tiered=tiered)
    mega_t = step_port.build_window_megastep(spec_t, K, MAXP,
                                             insert=not fast,
                                             kg_fill=kg_fill, tiered=tiered)
    res = np.arange(MAXP) < MAXP // 2
    rest_j = (jnp.asarray(res),) if tiered else ()
    kg_res = torch.from_numpy(res) if tiered else None
    for g in range(2):
        grp = seq[1 + g * K:1 + (g + 1) * K]
        wmv = np.array([[b[5] for b in grp]], np.int32)
        sj, (ovf_j, act_j, kgf_j) = mega_j(
            sj, *[a for b in grp for a in b[:5]], wmv, *rest_j)
        st, (ovf_t, act_t, kgf_t) = mega_t(
            st, [_lanes(b) for b in grp], torch.from_numpy(wmv[0]), kg_res)
        assert int(ovf_t) == int(np.asarray(ovf_j)[0])
        assert int(act_t) == int(np.asarray(act_j)[0])
        np.testing.assert_array_equal(kgf_t.numpy(), np.asarray(kgf_j)[0])
        _assert_states(sj, st, spec_j.red, spec_t.red, layout)
    if tiered:
        assert int(st.ovf_n) > 0          # the cold groups' lanes diverted
    if kg_fill:
        assert int(kgf_t.sum()) > 0


# (layout, reference pre-combine, K, fast tier, reduced, kg_fill, tiered)
FIRED_CASES = {
    "direct_pre_k4_compact": ("direct", True, 4, False, False, False, False),
    "hash_nopre_k2_compact": ("hash", False, 2, False, False, False, False),
    "direct_nopre_k4_reduced_fill": ("direct", False, 4, False, True, True,
                                     False),
    "hash_pre_k2_fast_reduced": ("hash", True, 2, True, True, False, False),
    "direct_pre_k2_tiered_compact": ("direct", True, 2, False, False, False,
                                     True),
}


@pytest.mark.parametrize("case", sorted(FIRED_CASES))
def test_fired_megastep_matches_reference(case):
    """Three consecutive fused-fire megasteps from the carried state, the
    compact ones into one reused arena read between dispatches: each
    sub-step's fires, the ring fill after the dispatch and the state after
    each equal the reference's."""
    layout, pre, K, fast, reduced, kg_fill, tiered = FIRED_CASES[case]
    spec_j, spec_t = _specs(layout, pre, OVF if tiered else 0)
    seq = _batches(11, 3 * K, layout)
    ctx, sj, st = _carried(spec_j, spec_t, seq[0])
    mega_j = step_ref.build_window_megastep_fired(
        ctx, spec_j, K, insert=not fast, kg_fill=kg_fill, reduced=reduced,
        tiered=tiered)
    mega_t = step_port.build_window_megastep_fired(
        spec_t, K, MAXP, insert=not fast, kg_fill=kg_fill, reduced=reduced,
        tiered=tiered)
    res = np.arange(MAXP) % 3 != 0
    rest_j = (jnp.asarray(res),) if tiered else ()
    kg_res = torch.from_numpy(res) if tiered else None
    fired = rows = 0
    for g in range(3):
        grp = seq[1 + g * K:1 + (g + 1) * K]
        wmv = np.array([[b[5] for b in grp]], np.int32)
        sj, (ovf_j, act_j, kgf_j), fr_j = mega_j(
            sj, *[a for b in grp for a in b[:5]], wmv, *rest_j)
        st, (ovf_t, act_t, kgf_t), fr_t = mega_t(
            st, [_lanes(b) for b in grp], torch.from_numpy(wmv[0]), kg_res)
        assert tuple(ovf_t.shape) == (K,)
        assert int(ovf_t[-1]) == int(np.asarray(ovf_j)[0])
        assert int(act_t) == int(np.asarray(act_j)[0])
        np.testing.assert_array_equal(kgf_t.numpy(), np.asarray(kgf_j)[0])
        assert hasattr(fr_t, "key_hi") != reduced
        for i in range(K):
            n, r = _assert_fires(fr_j, fr_t, i, not reduced)
            fired += n
            rows += r
        _assert_states(sj, st, spec_j.red, spec_t.red, layout)
    assert fired > 0 and (reduced or rows == fired)


@pytest.mark.parametrize("fired", ["plain", "compact", "reduced"])
@pytest.mark.parametrize("layout", ["direct", "hash"])
def test_megastep_equals_sequential_single_steps(layout, fired):
    """The port's megastep against K = 4 of its own single steps (the
    update step, then with fused fire the resident advance at the same
    watermark, its purge applied at once): every state field and every
    sub-step's fires bit for bit."""
    K = 4
    _, spec = _specs(layout, True)
    seq = _batches(13, K, layout)[1:]
    st1 = step_port.init_shard_state(spec, MAXP, "cpu")
    st2 = step_port.init_shard_state(spec, MAXP, "cpu")
    upd = step_port.build_window_update_step(spec, MAXP)
    wmv = torch.tensor([int(b[5]) for b in seq], dtype=torch.int32)
    oracle = []
    for i, b in enumerate(seq):
        st1, _ = upd(st1, *_lanes(b), wmv[i])
        if fired != "plain":
            st1, fr = step_port.fire_only(st1, spec, wmv[i],
                                          reduced=fired == "reduced")
            oracle.append(fr)
    if fired == "plain":
        mega = step_port.build_window_megastep(spec, K, MAXP)
        st2, _mon = mega(st2, [_lanes(b) for b in seq], wmv)
    else:
        mega = step_port.build_window_megastep_fired(
            spec, K, MAXP, reduced=fired == "reduced")
        st2, _mon, fires = mega(st2, [_lanes(b) for b in seq], wmv)
        for i, fr in enumerate(oracle):
            for name in (f.name for f in dataclasses.fields(fr)):
                a, b2 = getattr(fr, name), getattr(fires, name)[i]
                if name in ("key_hi", "key_lo", "values"):
                    for f in range(fr.counts.shape[0]):
                        n = int(fr.counts[f])
                        assert torch.equal(a[f, :n], b2[f, :n]), (name, i)
                else:
                    assert torch.equal(a, b2), (name, i)
        assert sum(int(fr.counts.sum()) for fr in oracle) > 0
    a, b2 = wkt.state_to_numpy(st1), wkt.state_to_numpy(st2)
    for name in wkt.STATE_FIELDS:
        np.testing.assert_array_equal(b2[name], a[name], err_msg=name)


def test_megastep_refuses_a_partial_group():
    _, spec = _specs("direct", True)
    mega = step_port.build_window_megastep(spec, 4, MAXP)
    st = step_port.init_shard_state(spec, MAXP, "cpu")
    seq = _batches(3, 3, "direct")[1:]
    with pytest.raises(ValueError, match="K = 4 megastep"):
        mega(st, [_lanes(b) for b in seq], torch.zeros(3, dtype=torch.int32))


# ------------------------------------------------------------ jobs

N_KEYS = 200
WINDOW = 10_000
K = 4
OFF = {"pipeline.resident-loop": "off"}


def gen_slow(offset, n):
    """~8 batches of 256 a pane: K = 4 groups fill between crossings."""
    idx = np.arange(offset, offset + n)
    return ({"key": (idx * 48271) % N_KEYS,
             "value": np.ones(n, np.float32)}, (idx // 2000) * 1000)


def gen_fast(offset, n):
    """A pane every 2.5 batches: every K = 4 group holds a crossing."""
    idx = np.arange(offset, offset + n)
    return ({"key": (idx * 48271) % N_KEYS,
             "value": np.ones(n, np.float32)}, (idx // 640) * 1000)


def numpy_rows(fn, total, window=WINDOW, slide=None):
    cols, ts = fn(0, total)
    slide = slide or window
    out = {}
    for k, t in zip(cols["key"].tolist(), ts.tolist()):
        first = t // slide
        for p in range(first, first + window // slide):
            we = (p + 1) * slide
            out[(k, we)] = out.get((k, we), 0) + 1.0
    return out


@pytest.mark.parametrize("fused_fire", ["on", "off"])
def test_fused_job_matches_reference_and_k1(fused_fire):
    """K = 4 with the resident loop off, on both packages: the port's rows
    equal the reference's, its own at K = 1 and numpy's; full groups ran
    as megasteps, and with fused fire every one fired inside it."""
    total = 8192
    cfg = {**OFF, "pipeline.steps-per-dispatch": K,
           "pipeline.fused-fire": fused_fire}
    got, job = run_job(build_env(**cfg), total,
                       source=GeneratorSource(gen_fast, total=total))
    want, _ = run_job(build_env(pkg="jax", **cfg), total, pkg="jax",
                      source=_jax_source(gen_fast, total))
    k1, job1 = run_job(build_env(**OFF), total,
                       source=GeneratorSource(gen_fast, total=total))
    assert got == want == k1 == numpy_rows(gen_fast, total)
    m = job.metrics
    assert m.steps == job1.metrics.steps == total // 256
    if fused_fire == "on":
        assert m.fused_dispatches == m.fused_fire_dispatches > 0
    else:
        assert m.fused_fire_dispatches == 0
    assert job1.metrics.fused_dispatches == 0


def _jax_source(fn, total):
    from flink_tpu.runtime.sources import GeneratorSource as Gen
    return Gen(fn, total=total)


def test_plain_megasteps_fill_between_crossings():
    """Fused fire off on a slow stream: groups fill between crossings and
    run as plain megasteps (the fire steps follow each crossing), the
    rows exact; the pipeline report carries the last dispatch's K."""
    total = 8192
    env = build_env(**OFF, **{"pipeline.steps-per-dispatch": K,
                              "pipeline.fused-fire": "off"})
    got, job = run_job(env, total,
                       source=GeneratorSource(gen_slow, total=total))
    assert got == numpy_rows(gen_slow, total)
    m = job.metrics
    assert m.fused_dispatches > 0 and m.fused_fire_dispatches == 0
    assert m.fire_steps > 0
    assert env._pipeline_report()["steps_per_dispatch"] in (1, K)


def test_k1_has_no_fused_dispatches():
    got, job = run_job(build_env(**OFF), 4096,
                       source=GeneratorSource(gen_slow, total=4096))
    assert got == numpy_rows(gen_slow, 4096)
    assert job.metrics.fused_dispatches == 0


def test_invalid_fused_fire_raises_the_reference_error():
    cfg = {"pipeline.steps-per-dispatch": K,
           "pipeline.fused-fire": "sometimes"}
    with pytest.raises(ValueError) as got:
        run_job(build_env(**cfg), 1024)
    with pytest.raises(ValueError) as want:
        run_job(build_env(pkg="jax", **cfg), 1024, pkg="jax")
    assert str(got.value) == str(want.value)
    assert "fused-fire" in str(got.value)


def test_resolution_with_k():
    """``auto`` with K above 1 is the scan drain on CUDA with staging and
    the megastep path on the CPU or without staging; ``off`` keeps the
    megasteps; fused fire follows K and ``pipeline.fused-fire``."""
    from flink_tpu_torch.core.config import Configuration

    src = GeneratorSource(lambda o, n: ({}, None), total=1)

    def res(device="cpu", **cfg):
        d = ex._resolve_dispatch(Configuration(cfg), False, False, src,
                                 torch.device(device))
        return d.resident, d.k_fuse, d.fused_fire

    k4 = {"pipeline.steps-per-dispatch": 4}
    assert res() == (False, 1, False)
    assert res(**k4) == (False, 4, True)
    assert res(device="cuda", **k4) == (True, 4, True)
    assert res(device="cuda", **k4, **{"pipeline.device-staging": "off"}) \
        == (False, 4, True)
    assert res(device="cuda", **k4, **OFF) == (False, 4, True)
    assert res(device="cuda", **k4, **{"pipeline.fused-fire": "off"}) \
        == (False, 4, False)
    assert res(device="cuda", **{"pipeline.steps-per-dispatch": 1}) \
        == (False, 1, False)


def gen_late(offset, n):
    """~2.5 batches of 256 a 1 s pane, 10 % of the records up to 3 s late
    behind a 300 ms watermark bound: some re-fire a window within the 2 s
    lateness, some drop beyond it."""
    idx = np.arange(offset, offset + n)
    rng = np.random.default_rng(offset + 5)
    ts = (idx // 640) * 1000 + rng.integers(0, 1000, n)
    late = rng.random(n) < 0.1
    ts = np.where(late, np.maximum(ts - rng.integers(0, 3000, n), 0), ts)
    return {"key": (idx * 48271) % N_KEYS, "ts": ts,
            "value": np.ones(n, np.float32)}, None


def late_rows(pkg, cfg, total):
    """The lateness job (5 s windows, 2 s allowed lateness) on either
    package: its rows in emission order and its late drops."""
    if pkg == "jax":
        from flink_tpu.runtime.sinks import CollectSink as Sink
        from flink_tpu.runtime.sources import GeneratorSource as Gen
        from flink_tpu.runtime.watermarks import WatermarkStrategy as WM
    else:
        from flink_tpu_torch.runtime.sinks import CollectSink as Sink
        from flink_tpu_torch.runtime.watermarks import WatermarkStrategy as WM
        Gen = GeneratorSource
    env = build_env(pkg=pkg, **cfg)
    sink = Sink()
    (env.add_source(Gen(gen_late, total=total))
     .assign_timestamps_and_watermarks(lambda c: c["ts"],
                                       WM.for_bounded_out_of_orderness(300))
     .key_by(lambda c: c["key"]).time_window(5000).allowed_lateness(2000)
     .sum(lambda c: c["value"]).add_sink(sink))
    job = env.execute("late")
    rows = [(int(r.key), int(r.window_end_ms), r.value)
            for r in sink.results]
    return rows, job


def test_fused_fire_with_lateness_matches_reference():
    """Allowed lateness under fused fire: the reference's fired megastep
    traces it (each sub-step's advance is the classic one, F on-time and
    F re-fire lanes) and its flush fires eagerly after every group; the
    port's rows — re-fires included, in emission order — and late drops
    equal the reference's. With fused fire off every batch breaks its
    group at the eager fire, so the rows are those of K = 1."""
    total, cfg = 6144, {**OFF, "pipeline.steps-per-dispatch": K}
    got, job = late_rows("torch", cfg, total)
    want, job_j = late_rows("jax", cfg, total)
    # the hash tables may place keys at other slots, which orders a
    # window's rows differently; a re-fire only adds, so the sorted rows
    # keep each (key, window)'s fires in order
    assert sorted(got) == sorted(want)
    m = job.metrics
    assert m.fused_fire_dispatches > 0
    assert m.dropped_late == job_j.metrics.dropped_late > 0
    assert len(got) > len({r[:2] for r in got})        # re-fires emitted
    off, _ = late_rows("torch", {**cfg, "pipeline.fused-fire": "off"},
                       total)
    k1, _ = late_rows("torch", OFF, total)
    assert off == k1


def test_spill_tier_rows_in_sliding_windows_match_numpy():
    """Keys past the capacity spill through the overflow ring while
    sliding windows fire inside fused groups: every row equals numpy's,
    the reference's and those of K = 1. Each sub-step's share of the ring
    folds before that sub-step's fires, and a ring drain the lagged fill
    sample calls for emits the unread fires first (their fills index the
    ring as it stands); the reference drains the whole ring before it
    emits a megastep's fires."""
    n_keys, total = 1500, 8192

    def gen_spill(offset, n):
        idx = np.arange(offset, offset + n)
        return ({"key": (idx * 48271) % n_keys,
                 "value": np.ones(n, np.float32)}, (idx // 640) * 1000)

    def run(k, pkg="torch"):
        env = build_env(pkg=pkg, **OFF, **{"pipeline.steps-per-dispatch": k})
        env.set_state_capacity(256)
        if pkg == "jax":
            from flink_tpu.runtime.sinks import CollectSink
            src = _jax_source(gen_spill, total)
        else:
            from flink_tpu_torch.runtime.sinks import CollectSink
            src = GeneratorSource(gen_spill, total=total)
        sink = CollectSink()
        (env.add_source(src).key_by(lambda c: c["key"])
         .time_window(WINDOW, 5000).sum(lambda c: c["value"])
         .add_sink(sink))
        job = env.execute("spill")
        return {(r.key, r.window_end_ms): r.value
                for r in sink.results}, job

    got, job = run(K)
    k1, _ = run(1)
    want, _ = run(K, "jax")
    assert got == k1 == want == numpy_rows(gen_spill, total, slide=5000)
    m = job.metrics
    assert m.fused_fire_dispatches > 0 and m.spilled_records > 0
    assert m.ring_drains > 0 and m.dropped_capacity == 0


def gen_sparse(offset, n):
    """700 sparse ids past the table's 1,024 slots' load: hash layout."""
    idx = np.arange(offset, offset + n)
    return ({"key": ((idx * 48271) % 700) * 1000003 + 12345678901,
             "value": np.ones(n, np.float32)}, (idx // 640) * 1000)


def gen_tiered(offset, n):
    idx = np.arange(offset, offset + n)
    return ({"key": (idx * 48271) % 300,
             "value": np.ones(n, np.float32)}, (idx // 640) * 1000)


LAYOUT_JOBS = {
    # the hash layout's step tiering (insert, then the fast tier), the
    # key-group fill sampled K batches a megastep
    "hash_fast": (gen_sparse, {"observability.kg-stats": True}),
    # tiered state: the megasteps take the residency mask, the cycle's
    # swaps run between groups
    "tiered": (gen_tiered, {"state.tiers.resident-key-groups": 8,
                            "state.tiers.min-dwell-cycles": 1}),
}


@pytest.mark.parametrize("job", sorted(LAYOUT_JOBS))
def test_fused_jobs_in_the_hash_layout_and_tiered_state(job):
    """Sliding windows at K = 4 with fused fire: the rows of K = 1 and of
    numpy, through the fast tier's megasteps or tiered state's swaps."""
    from flink_tpu_torch.runtime.sinks import CollectSink

    gen, extra = LAYOUT_JOBS[job]
    total = 8192

    def run(k):
        env = build_env(**OFF, **extra, **{"pipeline.steps-per-dispatch": k})
        sink = CollectSink()
        (env.add_source(GeneratorSource(gen, total=total))
         .key_by(lambda c: c["key"]).time_window(WINDOW, 5000)
         .sum(lambda c: c["value"]).add_sink(sink))
        job = env.execute("layouts")
        return {(r.key, r.window_end_ms): r.value
                for r in sink.results}, job.metrics, env

    got, m, env = run(K)
    k1, _, _ = run(1)
    assert got == k1 == numpy_rows(gen, total, slide=5000)
    assert m.fused_fire_dispatches > 0
    if job == "hash_fast":
        assert m.steps_fast > 0 and m.spilled_records > 0
        # a sampled megastep's fill covers its K batches
        assert env._kg_report()["fill_sampled_batches"] % K == 0
    else:
        tiers = env._pipeline_report()["tiers"]
        assert tiers["demotes"] > 0 and tiers["promotes"] > 0


def test_device_reduce_sink_takes_reduced_fired_megasteps(monkeypatch):
    """A CountingSink with no overflow ring: the fired megasteps reduce
    on the device (no row arena), and the count and sum are numpy's."""
    made = []
    real = step_port.build_window_megastep_fired

    def spy(*a, **kw):
        made.append(kw.get("reduced"))
        return real(*a, **kw)

    monkeypatch.setattr(ex, "build_window_megastep_fired", spy)
    total = 8192
    env = build_env(**OFF, **{"pipeline.steps-per-dispatch": K,
                              "state.backend.overflow-ring": 0})
    sink = CountingSink()
    (env.add_source(GeneratorSource(gen_fast, total=total))
     .key_by(lambda c: c["key"]).time_window(WINDOW)
     .sum(lambda c: c["value"]).add_sink(sink))
    job = env.execute("reduced")
    want = numpy_rows(gen_fast, total)
    assert made and all(made)
    assert job.metrics.fused_fire_dispatches > 0
    assert sink.count == len(want) and sink.value_sum == float(total)


@pytest.mark.parametrize("fused_fire", ["on", "off"])
def test_crash_inside_a_group_restores_exactly_once(tmp_path, fused_fire):
    """A crash at a megastep's dispatch (the ``step.dispatch`` seam) with
    sync-full checkpoints every 3 batches (mid-group) and the producer
    ahead: the restart restores the last cut — the offsets of the last
    batch of a flushed group — and every window comes out once, with its
    value."""
    total = 8192
    env = build_env(tmp_path / "chk", interval=3, restart=2, **OFF,
                    **{"pipeline.steps-per-dispatch": K,
                       "pipeline.fused-fire": fused_fire,
                       "pipeline.prefetch": "on"})
    inj = FaultInjector([FaultRule("step.dispatch", at=3,
                                   exc=RuntimeError("injected"))])
    with faults.active(inj):
        got, job = run_job(env, total,
                           source=GeneratorSource(gen_slow, total=total))
    m = job.metrics
    assert len(inj.fired_at("step.dispatch")) == 1
    assert m.restarts == 1 and m.fused_dispatches > 0
    assert m.checkpoint_stats
    assert got == numpy_rows(gen_slow, total)


def test_fused_accumulator_grouping():
    acc = ingest_mod.FusedBatchAccumulator(3)
    assert len(acc) == 0 and not acc.full() and not acc.hold_fires
    assert acc.compatible("mask", True)
    acc.push(("a",), 1, "pb1", "mask", True)
    assert acc.compatible("mask", True)
    assert not acc.compatible("exchange", True)   # route change -> flush
    assert not acc.compatible("mask", False)      # staging change -> flush
    acc.push(("b",), 2, "pb2", "mask", True)
    assert not acc.full()
    acc.push(("c",), 3, "pb3", "mask", True)
    assert acc.full()
    route, staged, items = acc.drain()
    assert route == "mask" and staged is True and len(items) == 3
    assert items[-1][2] == "pb3"                  # last pb = applied cut
    assert len(acc) == 0 and acc.compatible("exchange", False)
    acc.push(("d",), 4, "pb4", "exchange", False)
    acc.clear()                                   # restore path discards
    assert len(acc) == 0 and acc.compatible("mask", True)
    assert ingest_mod.FusedBatchAccumulator(2, hold_fires=True).hold_fires
