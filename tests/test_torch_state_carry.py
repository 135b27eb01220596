"""A mid-stream window state carries from flink_tpu into flink_tpu_torch
(``state_from_numpy`` / ``state_to_numpy``): three batches in the JAX
reference, then three more on both sides, must end equal — in the direct
layout field for field, in the hash layout key by key (the carried table
is probed on the reference's chains; keys placed after the carry may take
other slots). The session, count-window and rolling states carry the
same way and continue to the same outputs. Integer-valued data compares
bit for bit; the min, max, mean and generic planes with fresh flags
carry both ways, random float sums at rtol 1e-6 (1e-5 on a lane's value
sum), as in tests/test_torch_reduces.py. A sketch window's split planes (int32
registers and touched bits, the reference's ``packed = -1``) carry too,
and continue through the port's staging ring and resident drain, whose
int32 values column keeps item hashes above 2^24 that a float32 one
would round; HyperLogLog estimates are held to the tolerance of
``tests/test_torch_sketches.py``."""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    KC, C, F, MAXP, R, SLIDE, assert_fires_equal, assert_keyed_states_equal,
    assert_sketch_states_equal, assert_values_equal, jax_sketch_kernels,
    port_lanes, sketch_batches, sketch_fire_rows, sketch_states,
    assert_states_equal, batches, jax_keyed_fields, keyed_batches,
    keyed_lanes_torch,
    fire_rows, jax_fields, jax_hash_kernels, jax_kernels, jax_set_watermark,
    lanes_torch, logical_state, set_watermark, sparse_batches, specs,
)

from flink_tpu.ops import window_kernels as wkj
from flink_tpu.ops.window_kernels import ReduceSpec as ReduceSpecJ
from flink_tpu_torch.ops import window_kernels as wkt


def _step_both(upd, adv, sj, st, win_t, red_t, batch, pend_j, pend_t):
    hi, lo, ts, vals, valid, wm, _ = batch
    sj = upd(sj, hi, lo, ts, vals, valid, pend_j)
    wkt.update(st, win_t, red_t, *lanes_torch(hi, lo, ts, vals, valid),
               maxp=MAXP, clear_rows=pend_t)
    sj = set_watermark(sj, st, int(wm))
    sj, pend_j, fr_j = adv(sj, np.int32(wm))
    st, pend_t, fr_t = wkt.advance_and_fire_resident(st, win_t, red_t,
                                                     int(wm), reduced=True)
    assert_fires_equal(fr_j, fr_t)
    return sj, st, pend_j, pend_t


def test_state_round_trips_through_numpy():
    win_j, red_j, _, _ = specs("tumbling")
    upd, _ = jax_kernels("tumbling", True)
    sj = wkj.init_state(C, 16, win_j, red_j, layout="direct",
                        n_key_groups=MAXP, packed=True)
    for hi, lo, ts, vals, valid, _wm, clear in batches(5)[:3]:
        sj = upd(sj, hi, lo, ts, vals, valid, clear)
    fields = jax_fields(sj)
    back = wkt.state_to_numpy(wkt.state_from_numpy(fields, 0, device="cpu"))
    assert back.keys() == fields.keys()
    for name, want in fields.items():
        assert back[name].dtype == want.dtype, name
        np.testing.assert_array_equal(back[name], want, err_msg=name)


@pytest.mark.parametrize("planes", ["packed", "split"])
def test_state_carried_mid_stream_continues_equal(planes):
    win_j, red_j, win_t, red_t = specs("tumbling")
    packed = planes == "packed"
    upd, adv = jax_kernels("tumbling", True)
    sj = wkj.init_state(C, 16, win_j, red_j, layout="direct",
                        n_key_groups=MAXP, packed=packed)
    seq = batches(9)
    pend_j = np.zeros(R, bool)
    for hi, lo, ts, vals, valid, wm, _ in seq[:3]:
        sj = upd(sj, hi, lo, ts, vals, valid, pend_j)
        sj = jax_set_watermark(sj, int(wm))
        sj, pend_j, _ = adv(sj, np.int32(wm))
    st = wkt.state_from_numpy(jax_fields(sj), sj.packed, device="cpu")
    pend_t = torch.from_numpy(np.asarray(pend_j).copy())
    for b in seq[3:]:
        sj, st, pend_j, pend_t = _step_both(upd, adv, sj, st, win_t, red_t,
                                            b, pend_j, pend_t)
    if packed:
        assert_states_equal(sj, st)
        return
    # split planes: compare the logical (value, touched) planes and the rest
    acc, touched = wkt.split_packed(st.acc, red_t)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(sj.acc))
    np.testing.assert_array_equal(touched.numpy(), np.asarray(sj.touched))
    want, got = jax_fields(sj), wkt.state_to_numpy(st)
    for name in wkt.STATE_FIELDS:
        if name not in ("acc", "touched"):
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)


def test_hash_state_carried_mid_stream_continues_equal():
    win_j, red_j, win_t, red_t = specs("sliding")
    upd, adv = jax_hash_kernels("sliding")
    sj = wkj.init_state(C, 16, win_j, red_j, layout="hash",
                        n_key_groups=MAXP, packed=True)
    seq = sparse_batches(23)
    pend_j = np.zeros(R, bool)
    for hi, lo, ts, vals, valid, wm, _ in seq[:3]:
        sj, _act = upd(sj, hi, lo, ts, vals, valid, pend_j)
        sj = jax_set_watermark(sj, int(wm))
        sj, pend_j, _ = adv(sj, np.int32(wm))
    fields = jax_fields(sj)
    st = wkt.state_from_numpy(fields, sj.packed, device="cpu",
                              layout="hash", probe_len=16)
    back = wkt.state_to_numpy(st)
    for name, want in fields.items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    pend_t = torch.from_numpy(np.asarray(pend_j).copy())
    n_rows = 0
    for hi, lo, ts, vals, valid, wm, _ in seq[3:]:
        sj, act_j = upd(sj, hi, lo, ts, vals, valid, pend_j)
        st, act_t, _kgf = wkt.update(st, win_t, red_t,
                               *lanes_torch(hi, lo, ts, vals, valid),
                               maxp=MAXP, clear_rows=pend_t)
        assert int(act_t) == int(act_j)
        sj = set_watermark(sj, st, int(wm))
        sj, pend_j, fr_j = adv(sj, np.int32(wm))
        st, pend_t, fr_t = wkt.advance_and_fire_resident(
            st, win_t, red_t, int(wm), reduced=False)
        assert_fires_equal(fr_j, fr_t)
        for f in range(F):
            (wj, vj), _ = fire_rows(fr_j, f)
            (wt, vt), _ = fire_rows(fr_t, f)
            np.testing.assert_array_equal(wt, wj)
            np.testing.assert_array_equal(vt, vj)
            n_rows += len(wt)
    want = logical_state(jax_fields(sj), red_j)
    got = logical_state(wkt.state_to_numpy(st), red_t)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert n_rows > 0


# -- session, count-window and rolling states ----------------------------

def _keyed_carry(ref_mod, port_mod, init_j, step_j, step_t, steps, cmp):
    """Run the first half of ``steps`` in the reference, carry its state
    into the port (``state_from_numpy``; back out equal), run the second
    half on both and hand each step's outputs to ``cmp``; end with the
    states equal key by key."""
    half = len(steps) // 2
    sj = init_j()
    for s in steps[:half]:
        sj, _ = step_j(sj, s)
    fields = jax_keyed_fields(sj, port_mod.STATE_FIELDS)
    st = port_mod.state_from_numpy(fields, device="cpu")
    back = port_mod.state_to_numpy(st)
    for name, want in fields.items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    for s in steps[half:]:
        sj, out_j = step_j(sj, s)
        st, out_t = step_t(st, s)
        cmp(out_j, out_t)
    assert_keyed_states_equal(jax_keyed_fields(sj, port_mod.STATE_FIELDS),
                              port_mod.state_to_numpy(st))


def test_rolling_state_carried_mid_stream_continues_equal():
    from flink_tpu.ops import rolling as rj
    from flink_tpu_torch.ops import rolling as rt
    red = ReduceSpecJ("sum", jnp.float32)
    upd = jax.jit(lambda s, hi, lo, v, ok: rj.update(s, red, hi, lo, v, ok))

    def step_j(s, b):
        hi, lo, _ts, v, ok = b
        s, out, good = upd(s, hi, lo, v, ok)
        return s, np.where(np.asarray(good), np.asarray(out), np.nan)

    def step_t(s, b):
        hi, lo, _ts, v, ok = b
        s, out, good = rt.update(s, *keyed_lanes_torch(hi, lo, v, ok))
        return s, np.where(good.numpy(), out.numpy(), np.nan)

    _keyed_carry(rj, rt, lambda: rj.init_state(KC, 16, red), step_j, step_t,
                 keyed_batches(31, 4), np.testing.assert_array_equal)


def _rows(cols):
    a = np.stack([np.asarray(c).astype(np.float64) for c in cols], 1)
    return a[np.lexsort(a.T[::-1])]


def test_count_state_carried_mid_stream_continues_equal():
    from flink_tpu.ops import count_windows as cj
    from flink_tpu_torch.ops import count_windows as ct
    red = ReduceSpecJ("sum", jnp.float32)
    upd = jax.jit(lambda s, hi, lo, v, ok: cj.update(s, red, 7, hi, lo, v,
                                                     ok))

    def step_j(s, b):
        hi, lo, _ts, v, ok = b
        s, khi, klo, w, fv, m = upd(s, hi, lo, v, ok)
        m = np.asarray(m)
        return s, _rows([np.asarray(x)[m].view(np.uint32)
                         if x is not w and x is not fv else np.asarray(x)[m]
                         for x in (khi, klo, w, fv)])

    def step_t(s, b):
        hi, lo, _ts, v, ok = b
        s, rows, n = ct.update(s, 7, *keyed_lanes_torch(hi, lo, v, ok))
        r = [x[:int(n)].numpy() for x in rows]
        return s, _rows([r[0].view(np.uint32), r[1].view(np.uint32), r[2],
                         r[3]])

    _keyed_carry(cj, ct, lambda: cj.init_state(KC, 16, red), step_j, step_t,
                 keyed_batches(32, 4), np.testing.assert_array_equal)


def test_session_state_carried_mid_stream_continues_equal():
    from flink_tpu.ops import session_windows as swj
    from flink_tpu_torch.ops import session_windows as swt
    red = ReduceSpecJ("sum", jnp.float32)
    gap = 20
    upd = jax.jit(lambda s, hi, lo, ts, v, ok, wm: swj.update_and_fire(
        s, red, gap, hi, lo, ts, v, ok, wm))
    steps = [(hi, lo, ts, v, ok, int(ts.max()) - 25)
             for hi, lo, ts, v, ok in keyed_batches(33, 6)]

    def step_j(s, b):
        hi, lo, ts, v, ok, wm = b
        s, old_f, mid_f, (ws, we, wv, wm_mask) = upd(s, hi, lo, ts, v, ok,
                                                     np.int32(wm))
        cols = [[] for _ in range(5)]
        for f in (old_f, mid_f):
            m = np.asarray(f[5])
            for c, a in zip(cols, f[:5]):
                c.append(np.asarray(a)[m])
        m = np.asarray(wm_mask)
        keys = np.asarray(s.table.keys)
        for c, a in zip(cols, (keys[:, 0], keys[:, 1], ws, we, wv)):
            c.append(np.asarray(a)[m])
        cols = [np.concatenate(c) for c in cols]
        cols[0], cols[1] = cols[0].view(np.uint32), cols[1].view(np.uint32)
        return s, _rows(cols)

    def step_t(s, b):
        hi, lo, ts, v, ok, wm = b
        s, rows, n = swt.update_and_fire(
            s, gap, *keyed_lanes_torch(hi, lo, v, ok, ts=ts),
            torch.tensor(wm, dtype=torch.int32))
        r = [x[:int(n)].numpy() for x in rows]
        r[0], r[1] = r[0].view(np.uint32), r[1].view(np.uint32)
        return s, _rows(r)

    _keyed_carry(swj, swt, lambda: swj.init_state(KC, 16, red), step_j,
                 step_t, steps, np.testing.assert_array_equal)


# -- sketch windows (split planes) ----------------------------------------

def _sketch_carry(kind, seed):
    """Three batches of the sketch schedule in the reference, then its
    state carried into the port (and back out equal)."""
    _, _, win_t, red_t, sj, _ = sketch_states(kind)
    upd, adv, _ = jax_sketch_kernels(kind)
    seq = sketch_batches(seed)
    pend_j = np.zeros(R, bool)
    for hi, lo, ts, h, valid, wm, _ in seq[:3]:
        sj, _ = upd(sj, hi, lo, ts, h, valid, pend_j)
        sj = jax_set_watermark(sj, int(wm))
        sj, pend_j, _ = adv(sj, np.int32(wm))
    assert sj.packed == -1
    fields = jax_fields(sj)
    st = wkt.state_from_numpy(fields, sj.packed, device="cpu",
                              layout="hash", probe_len=16)
    back = wkt.state_to_numpy(st)
    assert back.keys() == fields.keys()
    for name, want in fields.items():
        assert back[name].dtype == want.dtype, name
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    assert st.packed == -1 and st.touched.any()
    return win_t, red_t, upd, adv, sj, st, seq[3:], pend_j


def _assert_sketch_fires_equal(kind, fr_j, fr_t):
    np.testing.assert_array_equal(np.asarray(fr_t.counts),
                                  np.asarray(fr_j.counts))
    n = 0
    for f in range(F):
        wj, vj = sketch_fire_rows(fr_j, f)
        wt, vt = sketch_fire_rows(fr_t, f)
        np.testing.assert_array_equal(wt, wj)
        assert_values_equal(kind, vt, vj)
        n += len(wt)
    return n


@pytest.mark.parametrize("kind", ["hll", "cms_query"])
def test_sketch_state_carried_mid_stream_continues_equal(kind):
    win_t, red_t, upd, adv, sj, st, rest, pend_j = _sketch_carry(kind, 41)
    pend_t = torch.from_numpy(np.asarray(pend_j).copy())
    n_rows = 0
    for hi, lo, ts, h, valid, wm, _ in rest:
        sj, _ = upd(sj, hi, lo, ts, h, valid, pend_j)
        wkt.update(st, win_t, red_t, *port_lanes(hi, lo, ts, h, valid),
                   maxp=MAXP, clear_rows=pend_t)
        sj = set_watermark(sj, st, int(wm))
        sj, pend_j, fr_j = adv(sj, np.int32(wm))
        st, pend_t, fr_t = wkt.advance_and_fire_resident(st, win_t, red_t,
                                                         int(wm))
        n_rows += _assert_sketch_fires_equal(kind, fr_j, fr_t)
        assert_sketch_states_equal(sj, st)
    assert n_rows > 0


@pytest.mark.parametrize("kind", ["hll", "cms_query"])
def test_sketch_state_carried_into_the_drain_keeps_hashes_above_2_24(kind):
    """The carried state goes on through DeviceBatchRing and the resident
    drain (the executor's path): the staged item hashes, nearly all above
    2^24, must reach the registers unrounded."""
    from flink_tpu_torch.runtime.ingest import DeviceBatchRing, IngestPlan
    from flink_tpu_torch.runtime.step import (
        WindowStageSpec,
        build_window_resident_drain,
    )
    win_t, red_t, upd, adv, sj, st, rest, pend_j = _sketch_carry(kind, 43)
    # a purge the reference deferred before the carry folds into its next
    # update's sweep; the port's drain starts with none pending
    wkt.apply_pending_purge(st, win_t, red_t,
                            torch.from_numpy(np.asarray(pend_j).copy()))
    hashes = np.concatenate([b[3] for b in rest])
    assert (hashes >= 1 << 24).mean() > 0.9
    spec = WindowStageSpec(win=win_t, red=red_t, capacity_per_shard=C,
                           layout="hash")
    drain = build_window_resident_drain(spec, len(rest), MAXP,
                                        reduced=False)
    plan = IngestPlan(td=None, slide_ticks=SLIDE, span_limit=R,
                      B=len(rest[0][0]), staging=True, device="cpu",
                      value_dtype=np.uint32)
    ring = DeviceBatchRing(plan, len(rest))
    fires_j, seqs, wms = [], [], []
    for i, (hi, lo, ts, h, valid, wm, _) in enumerate(rest):
        n = int(valid.sum())
        sel = np.nonzero(valid)[0]
        seqs.append(ring.try_publish(plan, hi[sel], lo[sel], ts[sel],
                                     h[sel], n, "mask", 0)[0])
        wms.append(int(wm))
        sj, _ = upd(sj, hi[sel], lo[sel], ts[sel], h[sel],
                    np.ones(n, bool), pend_j)
        sj = jax_set_watermark(sj, int(wm))
        sj, pend_j, fr = adv(sj, np.int32(wm))
        fires_j.append(fr)
    # the reference's last deferred purge lands at the drain's end
    win_j = wkj.WindowSpec(2 * SLIDE, SLIDE, ring=R, fires_per_step=F)
    sj = wkj.apply_pending_purge(sj, win_j, sketch_states(kind)[1], pend_j)
    st, _mon, fires = drain(st, [ring.slot(q) for q in seqs],
                            torch.tensor(wms, dtype=torch.int32), len(rest))
    n_rows = 0
    for d, fr_j in enumerate(fires_j):
        fr_t = wkt.CompactFires(*(getattr(fires, n)[d] for n in (
            "key_hi", "key_lo", "values", "counts", "window_end_ticks",
            "n_fires", "lane_valid", "value_sums")))
        n_rows += _assert_sketch_fires_equal(kind, fr_j, fr_t)
    assert_sketch_states_equal(sj, st)
    assert n_rows > 0


# -- min, max, mean and generic planes, with fresh flags ------------------

def _jax_state(fields: dict, packed: int):
    """A reference WindowShardState from host fields named as its leaves
    (a port state's ``state_to_numpy``, carried back)."""
    import jax.numpy as jnp
    from flink_tpu.ops.hashtable import SlotTable

    return wkj.WindowShardState(
        SlotTable(jnp.asarray(fields["table.keys"]), 16),
        *(jnp.asarray(fields[n]) for n in wkt.STATE_FIELDS[1:]),
        packed=packed)


@pytest.mark.parametrize("kind", ["min", "max", "mean", "gvec"])
def test_reduce_planes_with_fresh_flags_carry_both_ways(kind):
    """Allowed lateness L = 25 ticks, sliding windows: three batches in the
    reference; its state (min / max packed planes with the -/+FLT_MAX
    neutral, mean's [C*R, 3] plane, a generic reduce's split planes, and
    fresh flags of pending re-fires) carries into the port and back out
    equal; two batches on both; the port's state carries back into the
    reference; one more batch on both. Every fire (re-fires included) and
    the final states are equal."""
    from torch_parity import (
        LATENESS, WINDOWS, late_batches, reduce_pair, reduce_values,
    )
    red_j, red_t, packed = reduce_pair(kind)
    exact = kind in ("min", "max")     # random floats elsewhere: rtol
    kw = dict(ring=R, fires_per_step=F, lateness_ticks=LATENESS)
    win_j = wkj.WindowSpec(WINDOWS["sliding"], SLIDE, **kw)
    win_t = wkt.WindowSpec(WINDOWS["sliding"], SLIDE, **kw)
    upd = jax.jit(lambda s, hi, lo, ts, v, valid: wkj.update(
        s, win_j, red_j, hi, lo, ts, v, valid, direct=True,
        precombine=packed and kind not in ("min", "max"))[0])
    adv = jax.jit(lambda s, wm: wkj.advance_and_fire_resident(
        s, win_j, red_j, wm))
    sj = wkj.init_state(C, 16, win_j, red_j, layout="direct",
                        n_key_groups=MAXP, packed=packed)
    seq = [(b, reduce_values(kind, b[3], i))
           for i, b in enumerate(late_batches(17, floats=kind == "mean"))]

    def step_jax(sj, b, v):
        hi, lo, ts, _vals, valid, wm, _ = b
        sj = upd(sj, hi, lo, ts, v, valid)
        return adv(jax_set_watermark(sj, int(wm)), np.int32(wm))

    for b, v in seq[:3]:
        sj, _, _ = step_jax(sj, b, v)
    fields = jax_fields(sj)
    assert fields["fresh"].any() and int(fields["n_fresh"]) > 0
    st = wkt.state_from_numpy(fields, sj.packed, device="cpu", red=red_t)
    back = wkt.state_to_numpy(st)
    for name, want in fields.items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    n_rows = 0
    for i, (b, v) in enumerate(seq[3:]):
        if i == 2:
            sj = _jax_state(wkt.state_to_numpy(st), st.packed)
        hi, lo, ts, vals, valid, wm, _ = b
        sj, _, fr_j = step_jax(sj, b, v)
        lanes = lanes_torch(hi, lo, ts, vals, valid)
        wkt.update(st, win_t, red_t, *lanes[:3], torch.from_numpy(v),
                   lanes[4], maxp=MAXP)
        set_watermark(sj, st, int(wm))
        st, _, fr_t = wkt.advance_and_fire_resident(st, win_t, red_t,
                                                    int(wm))
        assert_fires_equal(fr_j, fr_t, rtol=0 if exact else 1e-5)
        for f in range(2 * F):
            (wj, vj), _ = fire_rows(fr_j, f)
            (wt, vt), _ = fire_rows(fr_t, f)
            np.testing.assert_array_equal(wt, wj)
            np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=0)
            n_rows += len(wt)
    assert_states_equal(sj, st, rtol=0.0 if exact else 1e-6)
    assert n_rows > 0


# ------------------------------------------------------------ device CEP

def _cep_pattern(P):
    """a, then b strictly next, then c followedBy, within 60 ms: every kind
    of partial, bucketed on the ring, lives across the carry."""
    return (P.begin("a").where(lambda e: e[1] == "a")
            .next("b").where(lambda e: e[1] == "b")
            .followed_by("c").where(lambda e: e[1] == "c").within(60))


def _cep_batches(seed=9, n_batches=8, B=96, n_keys=12):
    """(events, keys, ts) micro-batches, ts advancing across panes; an
    event is (key, name, seq)."""
    rng = np.random.default_rng(seed)
    out, seq, ts = [], 0, 1_000
    for _ in range(n_batches):
        keys = rng.integers(0, n_keys, B).tolist()
        names = rng.choice(list("abcx"), B, p=[0.3, 0.3, 0.2, 0.2]).tolist()
        out.append(([(k, a, seq + i) for i, (k, a) in
                     enumerate(zip(keys, names))], keys, ts))
        seq += B
        ts += int(rng.integers(0, 25))
    return out


def _ref_snapshot_from_port(snap):
    """The port's snapshot in the reference's own classes (its device leaves
    as a reference CepShardState, its NFA partials as reference Partial /
    Entry objects): the reference restores only those."""
    from flink_tpu.cep import nfa as nfa_j
    from flink_tpu.cep.device import CepShardState
    from flink_tpu.ops.hashtable import SlotTable

    memo = {}

    def entry(e):
        if e is None:
            return None
        if id(e) not in memo:
            memo[id(e)] = nfa_j.Entry(e.event)
            memo[id(e)].edges = [(entry(p), v) for p, v in e.edges]
        return memo[id(e)]

    d = snap["device"]
    out = dict(snap)
    out["device"] = CepShardState(
        table=SlotTable(jnp.asarray(d["table.keys"]), 16),
        carry=jnp.asarray(d["carry"]), pane_ids=jnp.asarray(d["pane_ids"]),
        dropped_capacity=jnp.asarray(d["dropped_capacity"]))
    out["partials"] = {
        k: [nfa_j.Partial(p.stage_idx, entry(p.ptr), p.version, p.start_ts)
            for p in v] for k, v in snap["partials"].items()}
    return out


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_cep_operator_carried_mid_stream_continues_equal(direction):
    """Four batches on one package, its ``snapshot()`` restored into a fresh
    operator of the other, four more batches on both continuations: the
    same match rows (in order), deltas' totals, counters and carry."""
    from flink_tpu.cep import Pattern as PJ
    from flink_tpu.cep.accel import DeviceCepOperator as OpJ
    from flink_tpu_torch.cep import Pattern as PT
    from flink_tpu_torch.cep.accel import DeviceCepOperator as OpT

    batches = _cep_batches()
    first, src_cls, dst_cls = ((OpJ, PJ), (OpJ, PJ), (OpT, PT)) \
        if direction == "reference_to_port" else ((OpT, PT), (OpT, PT),
                                                  (OpJ, PJ))

    def make(cls_p):
        cls, P = cls_p
        kw = {"device": "cpu"} if cls is OpT else {}
        return cls(_cep_pattern(P), capacity=64, **kw)

    src = make(src_cls)
    for ev, keys, ts in batches[:4]:
        src.process_batch(ev, keys, ts)
    snap = src.snapshot()
    if direction == "port_to_reference":
        snap = _ref_snapshot_from_port(snap)
    dst = make(dst_cls)
    dst.restore(snap)
    got_src, got_dst = [], []
    for ev, keys, ts in batches[4:]:
        got_src += src.process_batch(ev, keys, ts)
        got_dst += dst.process_batch(ev, keys, ts)
    assert got_src and got_dst == got_src
    for name in ("matches_detected", "matches_extracted", "steps",
                 "dropped_capacity"):
        assert getattr(dst, name) == getattr(src, name)
    assert dst.buffers == src.buffers and dst.trailing == src.trailing
    a, b = src.snapshot()["device"], dst.snapshot()["device"]
    rows = (a["table.keys"], np.asarray(a["carry"])) if isinstance(a, dict) \
        else (np.asarray(a.table.keys), np.asarray(a.carry))
    rows_b = (b["table.keys"], np.asarray(b["carry"])) if isinstance(b, dict) \
        else (np.asarray(b.table.keys), np.asarray(b.carry))
    np.testing.assert_array_equal(rows_b[0], rows[0])
    np.testing.assert_array_equal(rows_b[1], rows[1])


def test_cep_restore_validates_as_the_reference():
    from flink_tpu_torch.cep import Pattern as PT
    from flink_tpu_torch.cep.accel import DeviceCepOperator as OpT

    op = OpT(_cep_pattern(PT), capacity=64, device="cpu")
    snap = op.snapshot()
    for key, bad in (("capacity", 128), ("pane_ms", 3), ("n_shards", 2),
                     ("max_parallelism", 64)):
        with pytest.raises(ValueError):
            OpT(_cep_pattern(PT), capacity=64, device="cpu").restore(
                dict(snap, **{key: bad}))
