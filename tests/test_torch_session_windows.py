"""Event-time session windows: flink_tpu_torch's ``ops/session_windows.py``
(G5 + G10 + G11's plain versions on the CPU) against flink_tpu's
``ops/session_windows.py`` on the same seeded batches and watermarks —
fires as sorted rows, state key by key — then both packages' public APIs
on nexmark q11's shape (sessions of bids per bidder).

The batches reach: several sessions of one key in one batch (a hot key
over a span wider than the gap), out-of-order ticks within the gap, late
lanes against the pre-batch watermark, supersession of open sessions by a
jump in time, the key -1 (never placed), and a final watermark of 2^31 - 4
ticks that closes every open session. Integer-valued data compares bit for
bit; positive random floats at rtol 1e-6."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    KB, KC, assert_keyed_states_equal, jax_keyed_fields, key_halves,
    keyed_batches, keyed_lanes_torch,
)

from flink_tpu.ops import session_windows as sj_mod
from flink_tpu.ops.window_kernels import ReduceSpec as ReduceSpecJ
from flink_tpu_torch.ops import session_windows as st_mod
from flink_tpu_torch.ops.hashing import splitmix64

FINAL_WM = 2**31 - 4


@functools.lru_cache(maxsize=None)
def jax_update(gap: int):
    red = ReduceSpecJ("sum", jnp.float32)
    return jax.jit(lambda st, hi, lo, ts, v, valid, wm: sj_mod.update_and_fire(
        st, red, gap, hi, lo, ts, v, valid, wm))


def rows_sorted(cols):
    """(hi, lo, start, end, value) columns -> rows sorted by all five."""
    hi, lo, s, e, v = (np.asarray(c) for c in cols)
    order = np.lexsort((v, e, s, lo.view(np.uint32), hi.view(np.uint32)))
    return [hi.view(np.uint32)[order], lo.view(np.uint32)[order],
            s[order], e[order], v[order]]


def jax_rows(sj, fires):
    old_f, mid_f, (ws, we, wv, wmask) = fires
    cols = [[] for _ in range(5)]
    for f in (old_f, mid_f):
        m = np.asarray(f[5])
        for c, a in zip(cols, f[:5]):
            c.append(np.asarray(a)[m])
    m = np.asarray(wmask)
    keys = np.asarray(sj.table.keys)
    for c, a in zip(cols, (keys[:, 0], keys[:, 1], ws, we, wv)):
        c.append(np.asarray(a)[m])
    return [np.concatenate(c) for c in cols]


def schedule(seed, floats=False):
    """Five batches and their watermarks, then the final flush."""
    bs = keyed_batches(seed, 5, ts_step=40, ts_span=60, floats=floats)
    out = []
    for i, (hi, lo, ts, vals, valid) in enumerate(bs):
        ts = ts.copy()
        if i == 3:
            ts[-40:] = 1                         # late against the watermark
        if i == 4:
            ts = ts + 500                        # supersedes open sessions
        out.append((hi, lo, ts, vals, valid, int(ts.max()) - 30))
    z = np.zeros(KB, np.uint32)
    out.append((z, z, np.zeros(KB, np.int32), np.zeros(KB, np.float32),
                np.zeros(KB, bool), FINAL_WM))
    return out


def run_both(steps, gap, rtol=0.0):
    upd = jax_update(gap)
    sj = sj_mod.init_state(KC, 16, ReduceSpecJ("sum", jnp.float32))
    st = st_mod.init_state(KC, device="cpu")
    n_rows = 0
    for hi, lo, ts, vals, valid, wm in steps:
        sj, *fires = upd(sj, hi, lo, ts, vals, valid, np.int32(wm))
        want = rows_sorted(jax_rows(sj, fires))
        st, rows, n = st_mod.update_and_fire(
            st, gap, *keyed_lanes_torch(hi, lo, vals, valid, ts=ts),
            torch.tensor(wm, dtype=torch.int32))
        got = rows_sorted([r[:int(n)].numpy() for r in rows])
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(got[4], want[4], rtol=rtol, atol=0)
        n_rows += int(n)
    return sj, st, n_rows


@pytest.mark.parametrize("gap,floats", [(5, False), (25, False),
                                        (25, True)])
def test_sessions_fire_and_state_match_reference(gap, floats):
    rtol = 1e-6 if floats else 0.0
    sj, st, n_rows = run_both(schedule(6, floats), gap, rtol)
    assert n_rows > 0
    assert int(st.dropped_late) > 0 and int(st.dropped_capacity) > 0
    assert not bool(st.active.any())         # the flush closed every one
    assert_keyed_states_equal(jax_keyed_fields(sj, st_mod.STATE_FIELDS),
                              st_mod.state_to_numpy(st), rtol=rtol)


def test_sessions_one_key_in_every_lane():
    rng = np.random.default_rng(9)
    hi, lo = key_halves(np.full(KB, 4242, np.int64))
    steps = []
    for i in range(3):
        ts = (i * 300 + rng.integers(0, 400, KB)).astype(np.int32)
        steps.append((hi, lo, ts, rng.integers(1, 9, KB).astype(np.float32),
                      np.ones(KB, bool), int(ts.max()) - 100))
    sj, st, n_rows = run_both(steps, 3)
    assert n_rows > 3
    assert_keyed_states_equal(jax_keyed_fields(sj, st_mod.STATE_FIELDS),
                              st_mod.state_to_numpy(st))


# -- the public API: nexmark q11 (sessions of bids per bidder) ----------

GAP_MS, EV_PER_MS, N_BIDDERS = 500, 4, 400


def bid_gen(offset, n):
    """Each bidder bids in a burst every 2 s, 0.5 s long (bursts shifted
    per bidder), at EV_PER_MS events a millisecond."""
    idx = np.arange(offset, offset + n, dtype=np.int64)
    t = idx // EV_PER_MS
    u = splitmix64(idx ^ 0x5EED).astype(np.uint64) % np.uint64(N_BIDDERS // 4)
    bidder = (t // 5 + u.astype(np.int64)) % N_BIDDERS
    return {"bidder": splitmix64(bidder).view(np.int64)}, t + 1_000_000


def sessions_numpy(total):
    cols, ts = bid_gen(0, total)
    out = []
    b = cols["bidder"]
    order = np.lexsort((ts, b))
    b, ts = b[order], ts[order]
    cut = np.ones(len(b), bool)
    cut[1:] = (b[1:] != b[:-1]) | (ts[1:] - ts[:-1] > GAP_MS)
    starts = np.nonzero(cut)[0]
    ends = np.append(starts[1:], len(b))
    for s, e in zip(starts, ends):
        out.append((int(b[s]), int(ts[s]), int(ts[e - 1]) + GAP_MS,
                    float(e - s)))
    return sorted(out)


def session_job(pkg, total, batch, columnar):
    if pkg == "jax":
        from flink_tpu import StreamExecutionEnvironment
        from flink_tpu.core.time import TimeCharacteristic
        from flink_tpu.datastream.window.assigners import (
            EventTimeSessionWindows,
        )
        from flink_tpu.runtime.sinks import CollectSink
        from flink_tpu.runtime.sources import GeneratorSource
        env = StreamExecutionEnvironment()
        sink = CollectSink()
    else:
        from flink_tpu_torch import StreamExecutionEnvironment
        from flink_tpu_torch.core.time import TimeCharacteristic
        from flink_tpu_torch.datastream.window.assigners import (
            EventTimeSessionWindows,
        )
        from flink_tpu_torch.runtime.sinks import (
            CollectSink, ColumnarCollectSink,
        )
        from flink_tpu_torch.runtime.sources import GeneratorSource
        env = StreamExecutionEnvironment(device="cpu")
        sink = ColumnarCollectSink() if columnar else CollectSink()
    env.set_parallelism(1)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(KC)
    env.batch_size = batch
    (env.add_source(GeneratorSource(bid_gen, total=total))
     .key_by(lambda c: c["bidder"])
     .window(EventTimeSessionWindows.with_gap(GAP_MS))
     .count()
     .add_sink(sink))
    job = env.execute("sessions")
    return sink, job


@pytest.mark.parametrize("columnar", [True, False])
def test_session_job_matches_reference_and_numpy(columnar):
    total, batch = 24_000, 2048
    want = sessions_numpy(total)
    ref_sink, _ = session_job("jax", total, batch, False)
    sink, job = session_job("torch", total, batch, columnar)
    ref = sorted((int(r.key), int(r.window_start_ms), int(r.window_end_ms),
                  float(r.value)) for r in ref_sink.results)
    if columnar:
        c = sink.columns()
        got = sorted(zip(c["key_id"].view(np.int64).tolist(),
                         c["window_start_ms"].tolist(),
                         c["window_end_ms"].tolist(), c["value"].tolist()))
    else:
        got = sorted((int(r.key), int(r.window_start_ms),
                      int(r.window_end_ms), float(r.value))
                     for r in sink.results)
        assert type(sink.results[0]).__name__ == "SessionResult"
    assert got == ref
    assert got == want
    m = job.metrics
    assert m.dropped_late == 0 and m.dropped_capacity == 0
    assert m.fires == len(got)


def test_processing_time_sessions_are_not_ported():
    from flink_tpu_torch import StreamExecutionEnvironment
    from flink_tpu_torch.datastream.window.assigners import (
        ProcessingTimeSessionWindows,
    )
    from flink_tpu_torch.runtime.sinks import ColumnarCollectSink
    from flink_tpu_torch.runtime.sources import GeneratorSource
    env = StreamExecutionEnvironment(device="cpu")
    (env.add_source(GeneratorSource(bid_gen, total=10))
     .key_by(lambda c: c["bidder"])
     .window(ProcessingTimeSessionWindows.with_gap(GAP_MS)).count()
     .add_sink(ColumnarCollectSink()))
    with pytest.raises(NotImplementedError, match="processing-time session"):
        env.execute("pt-sessions")
