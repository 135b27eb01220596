"""Window min, max, mean, generic reduce and aggregate, and
KeyedStream.reduce: flink_tpu_torch against flink_tpu on the same inputs.

State level: the six batches of tests/torch_parity.py (late, too-old,
invalid and out-of-range lanes, a ring rotation that evicts unfired panes,
a folded deferred purge, negative ticks, multi-window watermark jumps) go
through the reference's update and resident advance (direct layout;
packed planes with pre-combine for min, max and mean, split planes for a
generic reduce, as the reference's own gates set them) and through the
port's on the CPU. Every fire's rows and the state after the run must be
equal; the port's reduced fires (G4, G6's fire_pack) must give the
reference's per-lane counts and value sums. The generic reduces are a
scalar sum, a scalar max and a (sum, max) pair over ``value_shape=(2,)``,
each package with its own combine function.

End to end: the same jobs through both public APIs with ``device="cpu"``,
and min, max and mean through the spill tier.

Tolerances: min and max pick an input, so they are exact, signed zeros
included. The signed zeros follow the reference's scatter-min and -max
(``.at[].min`` / ``.at[].max``: -0.0 is the smaller zero), which its
update runs with pre-combine off; with pre-combine on its segmented scan
(``lax.associative_scan`` as XLA lowers it on the CPU) keeps +0.0 for a
segment that holds both zeros, so against that path min and max are held
equal as values, a zero's sign aside. Sums of random floats (mean's, the
generic sums) hold at rtol 1e-6 on the values and 1e-5 on a lane's value
sum: the reference's pre-combine adds a key's lanes in sorted segments,
the port in lane order (and on the card with atomics, in any order).
Integer-valued data is bit-exact.
"""

import dataclasses
import functools
from typing import Any

import jax
import numpy as np
import pytest
import torch

from torch_parity import (
    C, F, MAXP, R, REDUCE_KINDS, SLIDE, WINDOWS, batches, fire_rows,
    jax_fields, lanes_torch, logical_planes, reduce_pair, reduce_values,
    set_watermark, sparse_batches,
)

from flink_tpu.ops import window_kernels as wkj
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import window_kernels as wkt

EXACT = ("min", "max", "gmax")


@functools.lru_cache(maxsize=None)
def _jax_steps(kind: str, window: str, layout: str = "direct",
               precombine: bool = True):
    red_j, _, packed = reduce_pair(kind)
    win = wkj.WindowSpec(WINDOWS[window], SLIDE, ring=R, fires_per_step=F)

    def upd(st, hi, lo, ts, vals, valid, clear):
        return wkj.update(st, win, red_j, hi, lo, ts, vals, valid,
                          direct=layout == "direct",
                          precombine=packed and precombine,
                          clear_rows=clear)[0]

    def adv(st, wm):
        return wkj.advance_and_fire_resident(st, win, red_j, wm)

    return win, jax.jit(upd), jax.jit(adv)


def _states(kind, window, layout="direct"):
    red_j, red_t, packed = reduce_pair(kind)
    win_t = wkt.WindowSpec(WINDOWS[window], SLIDE, ring=R, fires_per_step=F)
    win_j = _jax_steps(kind, window, layout)[0]
    sj = wkj.init_state(C, 16, win_j, red_j, layout=layout,
                        n_key_groups=MAXP, packed=packed)
    mk = functools.partial(wkt.init_state, C, win_t, red_t,
                           n_key_groups=MAXP, device="cpu", layout=layout)
    return red_t, win_t, sj, mk(), mk()


def _assert_rows_equal(frj, frt, f, exact, signs=True):
    (wj, vj), _ = fire_rows(frj, f)
    (wt, vt), _ = fire_rows(frt, f)
    np.testing.assert_array_equal(wt, wj)
    if exact:
        np.testing.assert_array_equal(vt, vj)
        if signs:
            np.testing.assert_array_equal(np.signbit(vt), np.signbit(vj))
    else:
        np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=0)


def _assert_lanes_equal(frj, fr, exact):
    for name in ("counts", "window_end_ticks", "n_fires", "lane_valid"):
        np.testing.assert_array_equal(getattr(fr, name).numpy(),
                                      np.asarray(getattr(frj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(fr.value_sums.numpy(),
                               np.asarray(frj.value_sums),
                               rtol=0 if exact else 1e-5, atol=0)


def _assert_fields_equal(want, got, exact, signs=True):
    assert want.keys() == got.keys()
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if name in ("acc", "cells") and not exact:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
            if name in ("acc", "cells") and signs:
                np.testing.assert_array_equal(np.signbit(g), np.signbit(w))


# (kind, window, the reference's pre-combine): min and max against its
# scatter path (signed zeros held) and its pre-combine path (values held)
UPDATE_CASES = [
    pytest.param(kind, window, pre, id=f"{kind}-{window}" + (
        "" if kind not in ("min", "max") else
        "-precombine_" + ("on" if pre else "off")))
    for kind in REDUCE_KINDS for window in ("tumbling", "sliding")
    for pre in ((True, False) if kind in ("min", "max") else (True,))
]


@pytest.mark.parametrize("kind,window,precombine", UPDATE_CASES)
def test_update_and_fire_match_reference(kind, window, precombine):
    """Six batches, each followed by a resident advance: the port's compact
    and reduced fires against the reference's, then the whole state."""
    _, upd, adv = _jax_steps(kind, window, precombine=precombine)
    red_t, win_t, sj, st, st_r = _states(kind, window)
    exact = kind in EXACT
    signs = kind not in ("min", "max") or not precombine
    pend_j, pend_t, pend_r = np.zeros(R, bool), None, None
    n_rows = 0
    for i, (hi, lo, ts, vals, valid, wm, clear) in enumerate(
            batches(11, floats=kind not in EXACT)):
        v = reduce_values(kind, vals, i)
        sj = upd(sj, hi, lo, ts, v, valid, pend_j | clear)
        lanes = lanes_torch(hi, lo, ts, vals, valid)
        for s, pend in ((st, pend_t), (st_r, pend_r)):
            c = torch.from_numpy(clear)
            wkt.update(s, win_t, red_t, *lanes[:3], torch.from_numpy(v),
                       lanes[4], maxp=MAXP,
                       clear_rows=c if pend is None else (pend | c))
        sj = set_watermark(sj, st, int(wm))
        set_watermark(sj, st_r, int(wm))
        sj, pend_j, frj = adv(sj, np.int32(wm))
        st, pend_t, frt = wkt.advance_and_fire_resident(st, win_t, red_t,
                                                        int(wm))
        st_r, pend_r, frr = wkt.advance_and_fire_resident(
            st_r, win_t, red_t, int(wm), reduced=True)
        _assert_lanes_equal(frj, frt, exact)
        _assert_lanes_equal(frj, frr, exact)
        for f in range(F):
            _assert_rows_equal(frj, frt, f, exact, signs)
        n_rows += int(frt.counts.sum())
    want = jax_fields(sj)
    _assert_fields_equal(want, wkt.state_to_numpy(st), exact, signs)
    _assert_fields_equal(want, wkt.state_to_numpy(st_r), exact, signs)
    assert n_rows > 0 and int(st.dropped_late) > 0
    assert int(st.dropped_capacity) > 0


@pytest.mark.parametrize("kind", ["max", "mean", "gvec"])
def test_hash_layout_reduces_match_reference(kind):
    """Sparse 64-bit keys in the hash layout (insert path; the reference's
    scatter path for max): the same fires and, slot order taken out, the
    same keys with the same cells."""
    _, upd, adv = _jax_steps(kind, "sliding", "hash", kind != "max")
    red_t, win_t, sj, st, _ = _states(kind, "sliding", "hash")
    exact = kind in EXACT
    pend_j, pend_t = np.zeros(R, bool), None
    for i, (hi, lo, ts, vals, valid, wm, _c) in enumerate(
            sparse_batches(13, floats=not exact)):
        v = reduce_values(kind, vals, i)
        sj = upd(sj, hi, lo, ts, v, valid, pend_j)
        lanes = lanes_torch(hi, lo, ts, vals, valid)
        wkt.update(st, win_t, red_t, *lanes[:3], torch.from_numpy(v),
                   lanes[4], maxp=MAXP, clear_rows=pend_t)
        sj = set_watermark(sj, st, int(wm))
        sj, pend_j, frj = adv(sj, np.int32(wm))
        st, pend_t, frt = wkt.advance_and_fire_resident(st, win_t, red_t,
                                                        int(wm))
        _assert_lanes_equal(frj, frt, exact)
        for f in range(F):
            _assert_rows_equal(frj, frt, f, exact)
    _assert_fields_equal(logical_planes(jax_fields(sj)),
                         logical_planes(wkt.state_to_numpy(st)), exact)


EDGE = np.array([0.0, -0.0, np.nan, 1.5, -1.5, np.inf, -np.inf,
                 np.finfo(np.float32).max], np.float32)


@pytest.mark.parametrize("op", ["min", "max"])
def test_min_max_order_signed_zeros_and_nan_as_jnp(op):
    """The float min and max combines (G3's CAS loop, G4 / G6's pane
    combine and their plain versions) follow jnp.minimum / jnp.maximum and
    XLA's scatter-min / -max: NaN wins, -0.0 orders below +0.0 whatever
    the argument order (torch.minimum keeps the first of two zeros)."""
    import jax.numpy as jnp

    a, b = np.meshgrid(EDGE, EDGE)
    jfn = {"min": jnp.minimum, "max": jnp.maximum}[op]
    want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
    got = kernels.COMBINE[op](torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.signbit(got.numpy()), np.signbit(want))
    # duplicates into one cell, in both lane orders
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 6, 400)
    upd = EDGE[rng.integers(0, len(EDGE), 400)]
    neutral = np.float32(np.finfo(np.float32).max if op == "min"
                         else -np.finfo(np.float32).max)
    for perm in (np.arange(400), np.arange(400)[::-1]):
        tgt = jnp.full(6, neutral)
        want = np.asarray(getattr(tgt.at[idx[perm]], op)(upd[perm]))
        t = torch.full((6, 1), float(neutral))
        kernels._scatter_combine_rows(t, torch.from_numpy(idx[perm]),
                                      torch.from_numpy(upd[perm])[:, None],
                                      kernels.COMBINE[op])
        np.testing.assert_array_equal(t[:, 0].numpy(), want)
        np.testing.assert_array_equal(np.signbit(t[:, 0].numpy()),
                                      np.signbit(want))


def test_refused_specs_raise():
    """What this port leaves out raises where the reference would run:
    builtin reduces with an explicit neutral (split planes) and non-float32
    values; a generic reduce needs its neutral."""
    with pytest.raises(NotImplementedError, match="item 9"):
        wkt.ReduceSpec("min", neutral=0.0)
    with pytest.raises(NotImplementedError, match="item 9"):
        wkt.ReduceSpec("max", torch.int32)
    with pytest.raises(ValueError, match="neutral"):
        wkt.ReduceSpec("generic", combine=torch.add)
    assert wkt.plane_of(wkt.ReduceSpec("sum", value_shape=(2,))) == "packed"
    assert wkt.plane_of(reduce_pair("gsum")[1]) == "split"


# ------------------------------------------------------------ end to end

CONFIG = {
    "keys.reverse-map": False,
    "window.fires-per-step": 2,
    "pipeline.update-precombine": "on",
    "state.packed-planes": "on",
    "pipeline.resident-loop": "on",
    "pipeline.ring-depth": 4,
}
N_KEYS, TOTAL, BATCH = 500, 24_000, 1024
SIZE_MS, SLIDE_MS, OOO_MS = 1000, 500, 300


def _gen(offset, n):
    """Integer keys in [0, 500), integer values in [-50, 50) (exact sums),
    ~5 events a ms, 10 % of them up to 250 ms out of order (inside the
    watermark's 300 ms bound: nothing is late)."""
    idx = np.arange(offset, offset + n, dtype=np.int64)
    rng = np.random.default_rng(offset)
    keys = (idx * 2862933555777941757) % N_KEYS
    v = rng.integers(-50, 50, n).astype(np.float32)
    lag = np.where(rng.random(n) < 0.1, rng.integers(0, 250, n), 0)
    return {"key": keys, "v": v, "ts": np.maximum(idx // 5 - lag, 0)}, None


def _pkg(pkg):
    if pkg == "jax":
        import jax.numpy as xp
        from flink_tpu import StreamExecutionEnvironment
        from flink_tpu.core.config import Configuration
        from flink_tpu.core.time import TimeCharacteristic
        from flink_tpu.runtime import sinks, sources
        from flink_tpu.runtime.watermarks import WatermarkStrategy
        from flink_tpu.state import descriptors
        from flink_tpu.ops.window_kernels import ReduceSpec
        kw = {}
    else:
        xp = torch
        from flink_tpu_torch import StreamExecutionEnvironment
        from flink_tpu_torch.core.config import Configuration
        from flink_tpu_torch.core.time import TimeCharacteristic
        from flink_tpu_torch.runtime import sinks, sources
        from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
        from flink_tpu_torch.state import descriptors
        from flink_tpu_torch.ops.window_kernels import ReduceSpec
        kw = {"device": "cpu"}
    return dict(xp=xp, Env=StreamExecutionEnvironment, Conf=Configuration,
                TC=TimeCharacteristic, sinks=sinks, sources=sources,
                WM=WatermarkStrategy, desc=descriptors, ReduceSpec=ReduceSpec,
                kw=kw)


def _env(p, config, capacity, batch=BATCH):
    env = p["Env"](p["Conf"](config), **p["kw"])
    env.set_parallelism(1)
    env.set_max_parallelism(128)
    env.set_stream_time_characteristic(p["TC"].EventTime)
    env.set_state_capacity(capacity)
    env.batch_size = batch
    return env


def _rows_sink(p):
    class Rows(p["sinks"].Sink):
        columnar = True

        def __init__(self):
            self.parts = []

        def invoke_columnar(self, cols):
            self.parts.append({k: np.asarray(v) for k, v in cols.items()})

        def rows(self):
            cols = {k: np.concatenate([q[k] for q in self.parts])
                    for k in self.parts[0]}
            vals = np.asarray(cols["value"], np.float64).reshape(
                len(cols["key_id"]), -1)
            return sorted(zip(cols["key_id"].astype(np.int64).tolist(),
                              cols["window_end_ms"].tolist(),
                              map(tuple, vals.tolist())))
    return Rows()


def _avg_descriptor(p):
    """An AggregatingStateDescriptor of a (sum, count) accumulator whose
    get_result divides, with the extractor the stage needs."""
    @dataclasses.dataclass(frozen=True)
    class Avg(p["desc"].AggregatingStateDescriptor):
        extractor: Any = None

    return Avg("avg", value_shape=(2,), merge=lambda a, b: a + b,
               get_result=lambda acc: acc[..., 0] / acc[..., 1],
               acc_init=np.zeros(2, np.float32),
               extractor=lambda c: np.stack(
                   [c["v"], np.ones_like(c["v"])], -1))


def _window_job(pkg, how, gen=_gen, total=TOTAL, capacity=2048, config=None,
                lateness=0, size_ms=SIZE_MS, slide_ms=SLIDE_MS, ooo=OOO_MS):
    """source -> timestamps -> key_by(key) -> window(size, slide) ->
    ``how`` -> a columnar row sink, on either package; (job, sorted rows
    (key, window end ms, value tuple))."""
    p = _pkg(pkg)
    xp = p["xp"]
    cfg = dict(CONFIG, **(config or {}))
    generic = how in ("reduce", "reduce_vec", "aggregate")
    if generic:
        # the reference's packed planes refuse a generic reduce
        cfg["state.packed-planes"] = "off"
    if lateness and pkg == "jax":
        # the reference's resident drain cannot run allowed lateness (its
        # skip branch returns F fire lanes where the live one returns 2F);
        # off, which its auto knob picks on the CPU, runs the split path
        cfg["pipeline.resident-loop"] = "off"
    env = _env(p, cfg, capacity)
    sink = _rows_sink(p)
    w = (env.add_source(p["sources"].GeneratorSource(gen, total=total))
         .assign_timestamps_and_watermarks(
             lambda c: c["ts"], p["WM"].for_bounded_out_of_orderness(ooo))
         .key_by(lambda c: c["key"]).time_window(size_ms, slide_ms))
    if lateness:
        w = w.allowed_lateness(lateness)
    v = (lambda c: c["v"])
    if how in ("min", "max", "sum"):
        out = getattr(w, how)(v)
    elif how == "mean" and pkg == "jax":
        # the reference's public mean builds each [v, 1] pair per element
        # (np.asarray([v, 1.0]) cannot take a column), so its columnar
        # stage is built as mean builds it, with a column-stacking
        # extractor: the same reduce, extractor and projection
        out = w._agg("window_mean",
                     lambda: p["ReduceSpec"]("sum", xp.float32,
                                             value_shape=(2,)),
                     lambda c: np.stack([c["v"], np.ones_like(c["v"])], -1),
                     result_fn=lambda acc: acc[..., 0]
                     / np.maximum(acc[..., 1], 1.0))
    elif how == "mean":
        out = w.mean(v)
    elif how == "reduce":
        out = w.reduce(lambda a, b: xp.maximum(a, b), extractor=v,
                       neutral=-1e9)
    elif how == "reduce_vec":
        out = w.reduce(lambda a, b: a + b, extractor=lambda c: np.stack(
            [c["v"], c["v"] * c["v"]], -1), neutral=0.0, value_shape=(2,))
    else:
        out = w.aggregate(_avg_descriptor(p))
    out.add_sink(sink)
    job = env.execute("reduces")
    return job, sink.rows()


def _gen_all(gen, total, batch=BATCH):
    """The columns the source polls, batch by batch (the generator draws
    from an rng seeded by the batch's offset), concatenated."""
    parts = [gen(off, min(batch, total - off))[0]
             for off in range(0, total, batch)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _numpy_windows(gen, total, size_ms, slide_ms, fn):
    """(key, window end) -> fn(values) over every record of the window."""
    cols = _gen_all(gen, total)
    ts = cols["ts"]
    groups = {}
    for j in range(size_ms // slide_ms):
        end = (ts // slide_ms + 1 + j) * slide_ms
        for k, e, v in zip(cols["key"].tolist(), end.tolist(),
                           cols["v"].tolist()):
            groups.setdefault((k, e), []).append(v)
    return sorted((k, e, fn(np.asarray(vs, np.float64)))
                  for (k, e), vs in groups.items())


NUMPY_FN = {
    "min": lambda v: (v.min(),), "max": lambda v: (v.max(),),
    "reduce": lambda v: (v.max(),), "mean": lambda v: (v.mean(),),
    "aggregate": lambda v: (v.mean(),),
    "reduce_vec": lambda v: (v.sum(), (v * v).sum()),
}


@pytest.mark.parametrize("how", sorted(NUMPY_FN))
def test_window_reduce_jobs_match_reference_and_numpy(how):
    """Sliding 1 s / 0.5 s windows over out-of-order integer values: the
    same rows from both public APIs, and numpy's group-by (exact: every
    value is an integer, so min, max, the sums and mean's sum and count
    are exact; mean and aggregate divide in float32 on the host, held to
    rtol 1e-6 against numpy's float64 mean). min, max and mean run on the
    packed planes in the direct layout; reduce and aggregate are generic
    (split planes, no spill tier), so the auto layout takes the hash
    table, as the reference's does."""
    job_j, want = _window_job("jax", how)
    job_t, got = _window_job("torch", how)
    assert got == want
    ref = _numpy_windows(_gen, TOTAL, SIZE_MS, SLIDE_MS, NUMPY_FN[how])
    assert [r[:2] for r in got] == [r[:2] for r in ref]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in ref],
                               rtol=1e-6 if how in ("mean", "aggregate")
                               else 0, atol=0)
    assert job_t.state.layout == ("hash" if how in ("reduce", "reduce_vec",
                                                    "aggregate") else
                                  "direct")
    assert job_t.metrics.dropped_late == job_j.metrics.dropped_late == 0
    assert job_t.metrics.dropped_capacity == 0


ROLLING = {
    # name: (combine on either package's tensors, numpy fold step)
    "last": (lambda xp: (lambda a, b: b), lambda a, v: v),
    "max": (lambda xp: xp.maximum, max),
}


def _rolling_job(pkg, gen, total, fn):
    p = _pkg(pkg)
    env = _env(p, {"keys.reverse-map": False}, 2048, batch=700)
    sink = p["sinks"].CollectSink()
    (env.add_source(p["sources"].GeneratorSource(gen, total=total))
     .key_by(lambda c: c["key"])
     .reduce(ROLLING[fn][0](p["xp"]), extractor=lambda c: c["v"],
             neutral=0.0)
     .add_sink(sink))
    job = env.execute("rolling-reduce")
    return job, [(int(k), float(v)) for k, v in sink.results]


@pytest.mark.parametrize("fn", sorted(ROLLING))
def test_keyed_stream_reduce_matches_reference_and_numpy(fn):
    """KeyedStream.reduce with a user combine — last-write-wins (the
    ValueState combine: associative, not commutative, so the scan must
    keep lane order) and max: every record emits its key's running value,
    in input order, equal on both packages and to a numpy fold in record
    order."""
    def gen(offset, n):
        cols, _ = _gen(offset, n)
        cols["key"] = cols["key"] % 97
        return cols, None

    total = 9_000
    _, want = _rolling_job("jax", gen, total, fn)
    job, got = _rolling_job("torch", gen, total, fn)
    assert got == want
    cols = _gen_all(gen, total, batch=700)
    acc, fold, step = {}, [], ROLLING[fn][1]
    for k, v in zip(cols["key"].tolist(), cols["v"].tolist()):
        acc[k] = step(acc[k], v) if k in acc else v
        fold.append((k, acc[k]))
    assert got == fold
    assert job.metrics.dropped_capacity == 0


@pytest.mark.parametrize("layout", ["direct", "hash"])
@pytest.mark.parametrize("how", ["min", "max", "mean"])
def test_min_max_mean_through_the_spill_tier(how, layout):
    """Keys at 4x the state capacity with the ring unset (keys past
    capacity in the direct layout, full chains in the hash layout):
    records that find no slot go to the overflow ring (G7, W value
    columns for mean),
    the host stores combine them by the reduce's ufunc (np.minimum,
    np.maximum, np.add per column) and a hash table compacts (G9, its
    alive test against the reduce's neutral). The rows equal the
    reference's and numpy's; nothing drops."""
    cfg = {"state.backend.layout": layout, "pipeline.ring-depth": 2}
    job_j, want = _window_job("jax", how, capacity=128, config=cfg)
    job, got = _window_job("torch", how, capacity=128, config=cfg)
    assert got == want
    ref = _numpy_windows(_gen, TOTAL, SIZE_MS, SLIDE_MS, NUMPY_FN[how])
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in ref],
                               rtol=1e-6 if how == "mean" else 0, atol=0)
    m = job.metrics
    assert m.spilled_records > 0 and m.ring_drains > 1
    assert m.dropped_capacity == 0
    assert job.state.layout == layout
    assert (m.compactions > 0) == (layout == "hash")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("knob,match", [
    ({"state.packed-planes": "on"}, "packed-planes"),
    ({"state.packed-planes": "off", "state.backend.overflow-ring": 4096},
     "overflow-ring"),
])
def test_generic_reduce_refuses_packed_planes_and_the_spill_ring(pkg, knob,
                                                                 match):
    """As the reference: state.packed-planes=on and an explicit overflow
    ring are refused for a generic reduce (split planes, no spill tier)."""
    p = _pkg(pkg)
    env = _env(p, dict(CONFIG, **knob), 512)
    (env.add_source(p["sources"].GeneratorSource(_gen, total=2000))
     .assign_timestamps_and_watermarks(lambda c: c["ts"])
     .key_by(lambda c: c["key"]).time_window(SIZE_MS)
     .reduce(lambda a, b: a + b, extractor=lambda c: c["v"])
     .add_sink(p["sinks"].CollectSink()))
    with pytest.raises(ValueError, match=match):
        env.execute("refused")
