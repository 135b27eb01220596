"""Allowed lateness: late records within it re-fire their windows with the
corrected value, records beyond it drop — flink_tpu_torch against
flink_tpu on the same inputs.

State level: six batches of out-of-order records (tests/torch_parity.py
``late_batches``: a third of each batch's lanes behind the watermark, some
within the lateness L = 25 ticks, some beyond it, more fresh windows than
F lanes at a time) go through the reference's update and advance (its
resident advance hands lateness to the classic ``advance_and_fire``) and
the port's. Every fire — F on-time lanes, then F re-fire lanes — and the
state after the run, ``fresh`` and ``n_fresh`` included, must be equal.

End to end: the cases of tests/test_lateness.py and the lateness cases of
tests/test_generic_windows.py through both public APIs, on a columnar
source (the port has no element-mode source yet) with parallelism 1, and a
random out-of-order stream with sum, min, mean and a generic reduce,
against the reference's rows and numpy's count of records beyond the
lateness. The reference runs lateness with ``pipeline.resident-loop: off``
(what its auto knob picks on the CPU): its resident drain refuses a
lateness stage (ROADMAP queue 3).

Tolerances: as tests/test_torch_reduces.py — integer-valued data and min
exact, random float sums at rtol 1e-6 (values) and 1e-5 (lane sums).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_reduces import (
    _assert_fields_equal, _assert_lanes_equal, _assert_rows_equal, _gen,
    _gen_all, _pkg, _env, _window_job,
)
from torch_parity import (
    C, F, LATENESS, MAXP, R, SLIDE, WINDOWS, jax_fields, lanes_torch,
    late_batches, reduce_pair, reduce_values, set_watermark,
)

from flink_tpu.ops import window_kernels as wkj
from flink_tpu_torch.ops import window_kernels as wkt

KINDS = ("sum", "count", "min", "mean", "gsum", "gvec")


@functools.lru_cache(maxsize=None)
def _jax_steps(kind: str, window: str):
    red_j, _, packed = reduce_pair(kind)
    win = wkj.WindowSpec(WINDOWS[window], SLIDE, ring=R, fires_per_step=F,
                         lateness_ticks=LATENESS)

    def upd(st, hi, lo, ts, vals, valid):
        # min on the reference's scatter path: its signed zeros (see
        # tests/test_torch_reduces.py)
        return wkj.update(st, win, red_j, hi, lo, ts, vals, valid,
                          direct=True, precombine=packed and kind != "min")[0]

    def adv(st, wm):
        return wkj.advance_and_fire_resident(st, win, red_j, wm)

    return win, jax.jit(upd), jax.jit(adv)


@pytest.mark.parametrize("window", ["tumbling", "sliding"])
@pytest.mark.parametrize("kind", KINDS)
def test_lateness_update_and_fire_match_reference(kind, window):
    win_j, upd, adv = _jax_steps(kind, window)
    red_j, red_t, packed = reduce_pair(kind)
    win_t = wkt.WindowSpec(WINDOWS[window], SLIDE, ring=R, fires_per_step=F,
                           lateness_ticks=LATENESS)
    sj = wkj.init_state(C, 16, win_j, red_j, layout="direct",
                        n_key_groups=MAXP, packed=packed)
    st = wkt.init_state(C, win_t, red_t, n_key_groups=MAXP, device="cpu")
    st_r = wkt.init_state(C, win_t, red_t, n_key_groups=MAXP, device="cpu")
    exact = kind in ("min", "count")
    refires = late_rows = 0
    for i, (hi, lo, ts, vals, valid, wm, _c) in enumerate(
            late_batches(3, floats=kind not in ("min", "count"))):
        v = reduce_values(kind, vals, i) if kind != "count" else vals
        sj = upd(sj, hi, lo, ts, v, valid)
        lanes = lanes_torch(hi, lo, ts, vals, valid)
        for s in (st, st_r):
            wkt.update(s, win_t, red_t, *lanes[:3], torch.from_numpy(v),
                       lanes[4], maxp=MAXP)
        sj = set_watermark(sj, st, int(wm))
        set_watermark(sj, st_r, int(wm))
        sj, _p, frj = adv(sj, np.int32(wm))
        st, pend, frt = wkt.advance_and_fire_resident(st, win_t, red_t,
                                                      int(wm))
        st_r, _, frr = wkt.advance_and_fire_resident(st_r, win_t, red_t,
                                                     int(wm), reduced=True)
        assert pend is None and frt.counts.shape == (2 * F,)
        _assert_lanes_equal(frj, frt, exact)
        _assert_lanes_equal(frj, frr, exact)
        for f in range(2 * F):
            _assert_rows_equal(frj, frt, f, exact)
        refires += int(frt.lane_valid[F:].sum())
        late_rows += int(frt.counts[F:].sum())
    want = jax_fields(sj)
    _assert_fields_equal(want, wkt.state_to_numpy(st), exact)
    _assert_fields_equal(want, wkt.state_to_numpy(st_r), exact)
    # the schedule reached what it exists for: re-fires (more than F at a
    # time), late drops, and fresh flags still pending at its end (sliding)
    assert refires > F and late_rows > 0 and int(st.dropped_late) > 0
    assert window == "tumbling" or int(st.n_fresh) > 0


def test_purge_waits_for_the_lateness_horizon():
    """A pane purges once every window holding it fired AND the watermark
    passed its end - 1 + L, not before; with L = 0 at once. One record at
    tick 3 (pane 0 of slide 10); the watermark 19 fires panes 0 and 1; the
    lateness horizon reaches pane 0 only at watermark 9 + L + 1."""
    for L, kept, purged in ((0, 0, 1), (LATENESS, 1, -2)):
        win = wkt.WindowSpec(10, SLIDE, ring=R, fires_per_step=F,
                             lateness_ticks=L)
        red = wkt.ReduceSpec("sum")
        st = wkt.init_state(64, win, red, n_key_groups=MAXP, device="cpu")
        one = torch.ones(1)
        wkt.update(st, win, red, torch.zeros(1, dtype=torch.int32),
                   torch.ones(1, dtype=torch.int32),
                   torch.tensor([3], dtype=torch.int32), one,
                   torch.ones(1, dtype=torch.bool), maxp=MAXP)
        st, pend, fr = wkt.advance_and_fire_resident(st, win, red, 19)
        if pend is not None:
            wkt.apply_pending_purge(st, win, red, pend)
        assert int(fr.counts[0]) == 1
        assert int(st.purged_through) == purged
        assert int((st.acc[:, 1] != 0).sum()) == kept
        st, pend, _ = wkt.advance_and_fire_resident(st, win, red, 9 + L + 1)
        if pend is not None:
            wkt.apply_pending_purge(st, win, red, pend)
        assert int(st.purged_through) >= 0
        assert int((st.acc[:, 1] != 0).sum()) == 0


# -------------------------------------- tests/test_lateness.py, mirrored

def _event_job(pkg, batches, window, lateness, value_sum=True):
    """Events (ts, key, v), each inner list one micro-batch (batch_size is
    the list's length), through key_by(key).time_window(window)
    .allowed_lateness(lateness).sum(v) into a CollectSink, on either
    package; (results, job)."""
    p = _pkg(pkg)
    cfg = {"keys.reverse-map": True, "pipeline.update-precombine": "on",
           "state.packed-planes": "on",
           "pipeline.resident-loop": "off" if pkg == "jax" else "on"}
    size = len(batches[0])
    assert all(len(b) == size for b in batches)
    flat = [e for b in batches for e in b]

    def gen(offset, n):
        ev = flat[offset:offset + n]
        return {"ts": np.asarray([e[0] for e in ev], np.int64),
                "key": np.asarray([e[1] for e in ev]),
                "v": np.asarray([e[2] for e in ev], np.float32)}, None

    env = _env(p, cfg, 256, batch=size)
    sink = p["sinks"].CollectSink()
    w = (env.add_source(p["sources"].GeneratorSource(gen, total=len(flat)))
         .assign_timestamps_and_watermarks(lambda c: c["ts"])
         .key_by(lambda c: c["key"]).time_window(window))
    if lateness:
        w = w.allowed_lateness(lateness)
    w.sum(lambda c: c["v"]).add_sink(sink)
    job = env.execute("lateness")
    return sink.results, job


def _both(batches, window=10_000, lateness=5_000):
    """Run on both packages; the rows must be equal, in emission order."""
    out = {}
    for pkg in ("jax", "torch"):
        res, job = _event_job(pkg, batches, window, lateness)
        out[pkg] = ([(r.key, r.window_end_ms, r.value) for r in res],
                    job.metrics.dropped_late)
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_late_refire_within_lateness():
    rows, dropped = _both([
        [(0, "k", 1.0), (9_000, "k", 2.0)],        # window [0,10k): sum 3
        [(12_000, "k", 10.0), (12_500, "k", 1.0)],  # wm -> 12499, fires
        [(5_000, "k", 5.0), (13_000, "k", 1.0)],    # late, within 5 s
    ])
    assert [v for _k, e, v in rows if e == 10_000] == [3.0, 8.0]
    assert [v for _k, e, v in rows if e == 20_000] == [12.0]
    assert dropped == 0


def test_beyond_lateness_drops():
    rows, dropped = _both([
        [(0, "k", 1.0), (9_000, "k", 2.0)],
        [(30_000, "k", 1.0), (30_500, "k", 1.0)],   # wm >> 10k + 5k
        [(5_000, "k", 100.0), (31_000, "k", 1.0)],  # beyond lateness
    ])
    assert [v for _k, e, v in rows if e == 10_000] == [3.0]
    assert dropped == 1


def test_multiple_late_refires_accumulate():
    rows, _ = _both([
        [(0, "a", 1.0), (0, "b", 1.0)],
        [(12_000, "a", 0.5), (12_500, "b", 0.5)],   # fires a=1, b=1
        [(1_000, "a", 1.0), (13_000, "x", 0.0)],    # late a -> a=2
        [(2_000, "a", 1.0), (2_500, "b", 1.0)],     # late both -> a=3, b=2
    ])
    assert [v for k, e, v in rows if k == "a" and e == 10_000] == [1.0, 2.0,
                                                                   3.0]
    assert [v for k, e, v in rows if k == "b" and e == 10_000] == [1.0, 2.0]


# ------------------------- tests/test_generic_windows.py's lateness cases

def test_late_data_dropped_beyond_lateness():
    """Window [0, 100) closes at watermark 499 with no lateness: the late
    record at ts 50 drops (the reference's case runs it through an apply
    window function; the sum here carries the same rows)."""
    rows, dropped = _both([[(10, "k", 1.0)], [(500, "k", 2.0)],
                           [(50, "k", 100.0)], [(600, "k", 3.0)]],
                          window=100, lateness=0)
    assert ("k", 100, 1.0) in rows and dropped >= 1


def test_allowed_lateness_refires():
    """Lateness 1,000: the late record at ts 50 re-fires [0, 100) with the
    corrected sum (the reference's case forces its host operator with an
    EventTimeTrigger; the device path gives the same rows)."""
    rows, _ = _both([[(10, "k", 1.0)], [(500, "k", 2.0)],
                     [(50, "k", 100.0)]], window=100, lateness=1000)
    vals = [v for _k, e, v in rows if e == 100]
    assert vals[0] == 1.0 and vals[-1] == 101.0


# ------------------------------------------- an out-of-order stream

L_MS, LATE_OOO = 1_500, 300


def _late_gen(offset, n):
    """``tests/test_torch_reduces.py``'s stream with 10 % of the records
    up to 3 s late: behind a 300 ms watermark bound, some within 1.5 s of
    their windows' ends (re-fires), some beyond (drops)."""
    cols, _ = _gen(offset, n)
    rng = np.random.default_rng(offset + 99)
    late = rng.random(n) < 0.1
    cols["ts"] = np.where(late, np.maximum(cols["ts"] - rng.integers(
        0, 3000, n), 0), cols["ts"])
    return cols, None


def _numpy_late(total, size_ms, slide_ms, batch=1024):
    """numpy's count of records beyond the lateness: a record drops when
    the newest window holding it ended more than L before the watermark
    in force when its batch arrived (the previous batches' newest time
    minus the bound, minus 1)."""
    cols = _gen_all(_late_gen, total, batch)
    k = size_ms // slide_ms
    dropped, newest = 0, None
    for off in range(0, total, batch):
        ts = cols["ts"][off:off + batch]
        if newest is not None:
            wm = newest - LATE_OOO - 1
            wm_pane_l = (wm - L_MS + 1 - slide_ms) // slide_ms
            dropped += int((ts // slide_ms + k - 1 <= wm_pane_l).sum())
        newest = int(ts.max()) if newest is None else max(newest,
                                                          int(ts.max()))
    return dropped


@pytest.mark.parametrize("how", ["sum", "min", "mean", "reduce"])
def test_out_of_order_stream_with_lateness_matches_reference(how):
    """Sliding 1 s / 0.5 s windows with allowed lateness 1.5 s: the same
    rows (on-time fires and re-fires) and the same late drops as the
    reference, the drops equal to numpy's count."""
    kw = dict(gen=_late_gen, lateness=L_MS, ooo=LATE_OOO)
    job_j, want = _window_job("jax", how, **kw)
    job, got = _window_job("torch", how, **kw)
    assert got == want
    m = job.metrics
    assert m.dropped_late == job_j.metrics.dropped_late
    assert m.dropped_late == _numpy_late(24_000, 1000, 500) > 0
    assert m.dropped_capacity == 0 and job.state.layout == "hash"
    n_windows = len({r[:2] for r in got})
    assert len(got) > n_windows       # re-fires emitted
