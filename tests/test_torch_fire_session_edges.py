"""G4's reduced fire and G11's session update at the shapes their card
kernels treat apart: the port's wrappers (``flink_tpu_torch.ops.cuda
fire_reduced`` / ``session_update``), which on the CPU run their plain
twins, against flink_tpu's on the same numpy-seeded inputs.

G4 on the card walks (due lane, tile) items with 16-byte loads: two W = 1
cells a float4 (a cell a load for an odd C), four W = 2 cells three
float4, other widths through shared memory, re-fire lanes' fresh bytes
four a word; it writes every lane (0 for a lane not due) and folds its
blocks' sums in block order. So the cases here: F above 1 with due and
quiet lanes mixed, every lane quiet, k = 5 with missing panes, W = 1, 2
and 3, add, min and max, re-fire lanes past n_ontime, C off every tile
(2,048 for W = 1, 1,024 for W = 2, 256 for W = 3) and odd, random floats.
The reference is ``_eval_fire_lanes`` (:1203) over the packed plane's
views (the fresh plane for the re-fire lanes, as ``advance_and_fire``
passes it) followed by ``reduce_fires`` (:1068).

G11 on the card scans 1,024 sorted lanes a tile with decoupled look-back
and sweeps 4,096 slots a tile. So: one key whose session spans many scan
tiles, sessions cut exactly at tile edges (the key with the lowest slot
holds the first 3,072 sorted lanes), int32-wrapping ticks, a watermark
that closes nothing and one that closes every slot, the rows' order by
kind through ``marks``, and a batch of no lanes (B = 0: the closes alone,
against the reference's step over a batch of invalid lanes, which it
runs instead: its scan takes no empty batch). Each session case runs
three batches and a flush through both packages' ``update_and_fire``.

Integer-valued data compares exactly; random floats at rtol 1e-6 (the
port sums in another order). No job runs here, so no pipeline knob is
involved.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    assert_keyed_states_equal, jax_keyed_fields, key_halves,
    keyed_lanes_torch,
)

from flink_tpu.ops import session_windows as sj_mod
from flink_tpu.ops import window_kernels as wkj
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import session_windows as st_mod
from flink_tpu_torch.ops.cuda import PANE_NONE
from flink_tpu_torch.ops.hashing import probe_hash, splitmix64

# ------------------------------------------------------------------- G4

REF_OP = {"add": "sum", "min": "min", "max": "max"}


def g4_inputs(C, W, lanes, *, op="add", k=1, missing=(), fresh_from=None,
              floats=False, seed=0):
    """A fire over F = len(lanes) lanes (``T`` due, ``F`` quiet) of k-pane
    windows on an R = k + F ring: a packed plane [R, C, W + 1] with values
    in 30 % of the cells and the last three slots of every row (the
    neutral elsewhere), pane ids with the panes ``missing`` absent, the
    window ends, the due lanes, and from lane ``fresh_from`` on re-fire
    lanes over a fresh plane."""
    F = len(lanes)
    R = k + F
    rng = np.random.default_rng(seed)
    red = wkj.ReduceSpec(REF_OP[op], jnp.float32,
                         value_shape=() if W == 1 else (W,))
    neutral = np.float32(red.neutral_value())
    pane_ids = np.arange(40, 40 + R, dtype=np.int32)
    pane_ids = pane_ids[np.argsort(pane_ids % R)]     # row q % R holds q
    for m in missing:
        pane_ids[(40 + m) % R] = PANE_NONE
    ends = np.array([39 + R - f for f in range(F)], np.int32)
    touch = rng.random((R, C)) < 0.3
    touch[:, -3:] = True
    acc = np.full((R, C, W + 1), neutral, np.float32)
    n = int(touch.sum())
    acc[touch, :W] = (rng.uniform(0.5, 40.0, (n, W)) if floats
                      else rng.integers(-40, 41, (n, W))).astype(np.float32)
    acc[touch, W] = 1.0 if op == "add" else 0.0
    fresh = None
    if fresh_from is not None:
        fresh = (rng.random((R, C)) < 0.05) & touch
    lane_ok = np.array([c == "T" for c in lanes])
    return acc, pane_ids, ends, lane_ok, fresh, red, neutral


def ref_reduced(acc, pane_ids, ends, lane_ok, fresh, red, k, n_ontime):
    """The reference's (counts, value sums) of the lanes: on-time lanes by
    the touch column, re-fire lanes by the fresh plane."""
    R, C, Wc = acc.shape
    W = Wc - 1
    win = wkj.WindowSpec(k * 10, 10, ring=R, fires_per_step=len(ends))
    touched2 = acc[..., W] != np.float32(red.neutral_value())
    acc3 = acc[..., 0] if W == 1 else acc[..., :W]

    def lanes(sel, mask2):
        ok = jnp.asarray(lane_ok[sel])
        mask, vals = wkj._eval_fire_lanes(
            jnp.asarray(acc3), jnp.asarray(touched2), jnp.asarray(pane_ids),
            win, red, jnp.asarray(ends[sel]), ok, jnp.asarray(mask2))
        r = wkj.reduce_fires(wkj.FireResult(
            mask, vals, jnp.zeros(ok.shape[0], jnp.int32), jnp.int32(0), ok))
        return np.asarray(r.counts), np.asarray(r.value_sums)

    n_on = len(ends) if fresh is None else n_ontime
    counts, sums = lanes(slice(0, n_on), touched2)
    if fresh is not None:
        c2, s2 = lanes(slice(n_on, None), fresh)
        counts, sums = np.concatenate([counts, c2]), np.concatenate([sums, s2])
    return counts, sums


G4_CASES = {
    "W1 C=2047 (odd, a cell a load)": dict(C=2047, W=1),
    "W1 C=2050": dict(C=2050, W=1),
    "W1 F=5 due and quiet mixed": dict(C=2050, W=1, lanes="TFTFT"),
    "W1 every lane quiet": dict(C=2048, W=1, lanes="FFF"),
    "W1 k=5 missing panes": dict(C=4100, W=1, k=5, missing=(3, 5)),
    "W1 max k=5 missing": dict(C=4098, W=1, k=5, op="max", missing=(4,)),
    "W1 min": dict(C=2052, W=1, op="min"),
    "W1 re-fire lanes": dict(C=4096, W=1, lanes="TTTT", fresh_from=2),
    "W1 re-fire lanes, C=2 mod 4": dict(C=4098, W=1, lanes="TFTT",
                                        fresh_from=1),
    "W2 C=1025": dict(C=1025, W=2),
    "W2 min k=3 missing": dict(C=2048, W=2, k=3, op="min", missing=(1,)),
    "W2 re-fire lanes": dict(C=2048, W=2, lanes="TTFT", fresh_from=2),
    "W3 C=257 max F=5": dict(C=257, W=3, op="max", lanes="FTFTT"),
    "W1 random floats": dict(C=4096, W=1, floats=True),
    "W2 random floats": dict(C=2048, W=2, floats=True),
}


@pytest.mark.parametrize("case", list(G4_CASES))
def test_fire_reduced_edges_match_reference(case):
    kw = dict(G4_CASES[case])
    lanes = kw.pop("lanes", "TTF")
    k = kw.get("k", 1)
    acc, pane_ids, ends, lane_ok, fresh, red, neutral = g4_inputs(
        lanes=lanes, seed=len(case), **kw)
    R, C, Wc = acc.shape
    n_ontime = kw.get("fresh_from")
    want_c, want_s = ref_reduced(acc, pane_ids, ends, lane_ok, fresh, red,
                                 k, n_ontime)
    got_c, got_s = kernels.fire_reduced(
        torch.from_numpy(acc.reshape(R * C, Wc)), torch.from_numpy(pane_ids),
        torch.from_numpy(ends), torch.from_numpy(lane_ok), C=C, R=R, k=k,
        op=kw.get("op", "add"), neutral=float(neutral),
        fresh=None if fresh is None else torch.from_numpy(fresh.reshape(-1)),
        n_ontime=n_ontime)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    if kw.get("floats"):
        np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got_s.numpy(), want_s)
    quiet = ~lane_ok
    assert (got_c.numpy()[quiet] == 0).all()
    assert (got_s.numpy()[quiet] == 0).all()
    if "quiet" not in case:
        assert int(got_c.sum()) > 0


# ------------------------------------------------------------------ G11

SC, SB, GAP = 1 << 13, 4096, 50
WM_LOW = -(2**31) + 2


@functools.lru_cache(maxsize=None)
def jax_update():
    red = wkj.ReduceSpec("sum", jnp.float32)
    return jax.jit(lambda st, hi, lo, ts, v, valid, wm: sj_mod.update_and_fire(
        st, red, GAP, hi, lo, ts, v, valid, wm))


def _sorted_rows(cols):
    hi, lo, s, e, v = (np.asarray(c) for c in cols)
    order = np.lexsort((v, e, s, lo.view(np.uint32), hi.view(np.uint32)))
    return [a[order] for a in (hi.view(np.uint32), lo.view(np.uint32), s, e,
                               v)]


def _ref_groups(sj, fires):
    """The reference's rows by kind: old, mid, closes."""
    old_f, mid_f, (ws, we, wv, wmask) = fires
    groups = []
    for f in (old_f, mid_f):
        m = np.asarray(f[5])
        groups.append([np.asarray(a)[m] for a in f[:5]])
    m = np.asarray(wmask)
    keys = np.asarray(sj.table.keys)
    groups.append([np.asarray(a)[m] for a in
                   (keys[:, 0], keys[:, 1], ws, we, wv)])
    return groups


def _pool(n, seed):
    """n sparse 64-bit keys whose home slots lie below SC - 64 (so no
    probe wraps to a low slot), ordered by home slot."""
    ids = splitmix64(np.arange(seed * 100_000, seed * 100_000 + 4 * n,
                               dtype=np.int64)).view(np.int64)
    hi, lo = key_halves(ids)
    home = (probe_hash(torch.from_numpy(hi.view(np.int32)),
                       torch.from_numpy(lo.view(np.int32)))
            & (SC - 1)).numpy()
    keep = np.flatnonzero(home < SC - 64)
    keep = keep[np.argsort(home[keep], kind="stable")]
    _, first = np.unique(home[keep], return_index=True)
    return ids[keep[first]][:n]


def _batch(keys, ts, rng):
    hi, lo = key_halves(keys)
    return (hi, lo, ts.astype(np.int64).astype(np.int32),
            rng.integers(1, 9, keys.shape[0]).astype(np.float32),
            np.ones(keys.shape[0], bool))


def session_schedule(case, seed=0):
    """Three batches of SB lanes and a flush: (hi, lo, ts, vals, valid, wm)."""
    rng = np.random.default_rng(seed)
    pool = _pool(300, seed + 1)
    steps = []
    t0 = 1000
    for b in range(3):
        keys = rng.choice(pool[1:], SB)
        ts = t0 + b * 400 + rng.integers(0, 300, SB)
        if case == "one key over many tiles":
            keys[:3000] = pool[5]                # one session of 3,000 lanes
            ts[:3000] = t0 + b * 400 + rng.integers(0, 40, 3000)
        elif case == "cuts at tile edges":
            # the lowest slot's key holds the first 3,072 sorted lanes,
            # its sessions cut at lanes 1,024 and 2,048
            keys[:3072] = pool[0]
            i = np.arange(3072)
            ts[:3072] = t0 + b * 10_000 + (i // 1024) * (1024 + 3 * GAP) \
                + i % 1024
        elif case == "wrapping ticks":
            ts = 2**31 - 600 + b * 300 + rng.integers(0, 300, SB)
        wm = int(ts.astype(np.int64).astype(np.int32).max()) - 120
        if case == "closes nothing":
            wm = WM_LOW
        steps.append((*_batch(keys, ts, rng), wm))
    z = np.zeros(SB, np.uint32)
    final = {"closes nothing": WM_LOW, "closes every slot": 2**31 - 1}.get(
        case, 2**31 - 4)
    steps.append((z, z, np.zeros(SB, np.int32), np.zeros(SB, np.float32),
                  np.zeros(SB, bool), final))
    return steps


@pytest.mark.parametrize("case", ["random", "one key over many tiles",
                                  "cuts at tile edges", "wrapping ticks",
                                  "closes nothing", "closes every slot"])
def test_session_update_edges_match_reference(case):
    upd = jax_update()
    sj = sj_mod.init_state(SC, 16, wkj.ReduceSpec("sum", jnp.float32))
    st = st_mod.init_state(SC, device="cpu")
    n_rows = 0
    for hi, lo, ts, vals, valid, wm in session_schedule(case):
        sj, *fires = upd(sj, hi, lo, ts, vals, valid, np.int32(wm))
        marks = torch.full((2,), -7, dtype=torch.int32)
        st, rows, n = st_mod.update_and_fire(
            st, GAP, *keyed_lanes_torch(hi, lo, vals, valid, ts=ts),
            torch.tensor(wm, dtype=torch.int32), marks=marks)
        want = _ref_groups(sj, fires)
        m0, m1, n = int(marks[0]), int(marks[1]), int(n)
        assert (m0, m1 - m0, n - m1) == tuple(g[0].shape[0] for g in want)
        for (a, b), group in zip(((0, m0), (m0, m1), (m1, n)), want):
            got = _sorted_rows([r[a:b].numpy() for r in rows])
            for g, w in zip(got, _sorted_rows(group)):
                np.testing.assert_array_equal(g, w)
        n_rows += n
    assert n_rows > 0
    assert_keyed_states_equal(jax_keyed_fields(sj, st_mod.STATE_FIELDS),
                              st_mod.state_to_numpy(st))
    if case == "closes every slot":
        assert not bool(st.active.any())
    if case == "closes nothing":
        assert bool(st.active.any())


def test_session_update_empty_batch_closes_as_reference():
    """B = 0: the port's G11 with no lanes, against the reference's step
    over a batch of invalid lanes (its scan takes no empty batch); the
    open sessions of two batches close at the watermark, marks (0, 0)."""
    upd = jax_update()
    sj = sj_mod.init_state(SC, 16, wkj.ReduceSpec("sum", jnp.float32))
    st = st_mod.init_state(SC, device="cpu")
    for hi, lo, ts, vals, valid, wm in session_schedule("random", 3)[:2]:
        sj, *_ = upd(sj, hi, lo, ts, vals, valid, np.int32(wm))
        st, _, _ = st_mod.update_and_fire(
            st, GAP, *keyed_lanes_torch(hi, lo, vals, valid, ts=ts),
            torch.tensor(wm, dtype=torch.int32))
    wm = 1900
    z = np.zeros(SB, np.uint32)
    sj, *fires = upd(sj, z, z, np.zeros(SB, np.int32),
                     np.zeros(SB, np.float32), np.zeros(SB, bool),
                     np.int32(wm))
    st.watermark.fill_(wm)
    empty = torch.empty(0, dtype=torch.int32)
    marks = torch.full((2,), -7, dtype=torch.int32)
    rows, n = kernels.session_update(
        st.start, st.last, st.acc, st.active, st.table_keys, st.watermark,
        empty, torch.empty(0, dtype=torch.int64), empty, empty,
        torch.empty(0, dtype=torch.float32), G=GAP, marks=marks)
    want = _ref_groups(sj, fires)
    assert marks.tolist() == [0, 0] and want[0][0].shape[0] == 0
    assert int(n) == want[2][0].shape[0] > 0
    for g, w in zip(_sorted_rows([r[:int(n)].numpy() for r in rows]),
                    _sorted_rows(want[2])):
        np.testing.assert_array_equal(g, w)
    assert_keyed_states_equal(jax_keyed_fields(sj, st_mod.STATE_FIELDS),
                              st_mod.state_to_numpy(st))
