"""Per-row window fires (kernel G6 ``fire_compact``, the port's
CompactFires) and the hash-layout update (G5 + G3) against flink_tpu on
the CPU, at C = 4096 slots, B = 1024 lanes, P = 16.

* ``compact_fires`` over the same dense fire planes equals the
  reference's ``compact_fires`` row for row.
* Direct layout: update, then ``advance_and_fire_resident(reduced=False)``
  — the rows equal the reference's in order (both compact in slot order).
* Hash layout: the same sequence over sparse 64-bit keys. The two tables
  may place a key at different slots, so rows compare after sorting by
  key within each window end, and states compare key by key
  (``torch_parity.logical_state``); activity (newly placed keys) is equal.

* G6's plain version (evaluation, then the pack) at the slot counts where
  the kernel's tiles end (C = 512 and 2,048 slots, each +-1), W = 1 and
  W = 3, against the reference's ``_eval_fire_lanes`` and
  ``_pack_fire_lanes``: a lane emitting one slot in the last tile, a lane
  emitting every slot, a lane that is not due.

Integer-valued data is exact; random floats hold at rtol 1e-6 (the sums
add in another order, tests/test_torch_window_kernels.py says why).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    C, F, MAXP, R, batches, fire_rows, jax_fields, jax_hash_kernels,
    jax_kernels, lanes_torch, logical_state, set_watermark, sparse_batches,
    specs,
)

from flink_tpu.ops import hashtable as ht_ref
from flink_tpu.ops import window_kernels as wkj
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import hashtable as ht_port
from flink_tpu_torch.ops import window_kernels as wkt


def _assert_small_fields_equal(fr_j, fr_t, rtol):
    for name in ("counts", "window_end_ticks", "n_fires", "lane_valid"):
        np.testing.assert_array_equal(
            getattr(fr_t, name).numpy(), np.asarray(getattr(fr_j, name)),
            err_msg=name)
    np.testing.assert_allclose(fr_t.value_sums.numpy(),
                               np.asarray(fr_j.value_sums), rtol=rtol,
                               atol=0)


def _assert_rows_equal(fr_j, fr_t, rtol, in_order):
    for f in range(F):
        (wj, vj), (wj_o, vj_o) = fire_rows(fr_j, f)
        (wt, vt), (wt_o, vt_o) = fire_rows(fr_t, f)
        if in_order:
            wj, vj, wt, vt = wj_o, vj_o, wt_o, vt_o
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_allclose(vt, vj, rtol=rtol, atol=0)


@pytest.mark.parametrize("table", ["direct", "hash"])
@pytest.mark.parametrize("floats", [False, True])
def test_compact_fires_matches_reference(table, floats):
    rng = np.random.default_rng(5)
    if table == "direct":
        iota = np.arange(C, dtype=np.uint32)
        rows = np.stack([np.zeros_like(iota), iota], axis=1)
    else:
        rows = rng.integers(0, 2**32, (C, 2), dtype=np.uint64).astype(
            np.uint32)
        rows[rng.random(C) < 0.5] = ht_ref.EMPTY
    mask = rng.random((F, C)) < 0.3
    mask[1] = False                            # a lane with nothing to emit
    vals = (rng.uniform(0.5, 8.0, (F, C)) if floats
            else rng.integers(1, 9, (F, C))).astype(np.float32)
    ends = np.array([40, wkt.PANE_NONE], np.int32)
    lanes = np.array([True, False])
    fr_j = wkj.compact_fires(
        ht_ref.SlotTable(jnp.asarray(rows), 16),
        wkj.FireResult(jnp.asarray(mask), jnp.asarray(vals),
                       jnp.asarray(ends), jnp.int32(1), jnp.asarray(lanes)))
    fr_t = wkt.compact_fires(
        ht_port.from_rows(rows, device="cpu"), torch.from_numpy(mask),
        torch.from_numpy(vals), torch.from_numpy(ends),
        torch.tensor(1, dtype=torch.int32), torch.from_numpy(lanes))
    rtol = 1e-6 if floats else 0.0
    _assert_small_fields_equal(fr_j, fr_t, rtol)
    # whole buffers, zeros past each prefix included, as the reference's
    for name in ("key_hi", "key_lo", "values"):
        np.testing.assert_array_equal(
            getattr(fr_t, name).numpy().view(np.asarray(
                getattr(fr_j, name)).dtype),
            np.asarray(getattr(fr_j, name)), err_msg=name)


def _fire_sequence(layout, window, floats):
    """update -> watermark -> compact advance per batch on both packages,
    the purge rows deferred into the next update, as the resident drain
    orders them; yields (reference state, port state, both fires,
    both activities)."""
    win_j, red_j, win_t, red_t = specs(window)
    if layout == "direct":
        upd, adv = jax_kernels(window, True)
        upd_j = lambda *a: (upd(*a), np.int32(0))  # noqa: E731
        adv_j = lambda st, wm: wkj.advance_and_fire_resident(  # noqa: E731
            st, win_j, red_j, wm)
        seq = batches(21, floats)
    else:
        upd_j, adv_j = jax_hash_kernels(window)
        seq = sparse_batches(21, floats)
    sj = wkj.init_state(C, 16, win_j, red_j, layout=layout,
                        n_key_groups=MAXP, packed=True)
    st = wkt.init_state(C, win_t, red_t, n_key_groups=MAXP, device="cpu",
                        layout=layout, probe_len=16)
    pend_j = np.zeros(R, bool)
    pend_t = torch.zeros(R, dtype=torch.bool)
    for hi, lo, ts, vals, valid, wm, _clear in seq:
        sj, act_j = upd_j(sj, hi, lo, ts, vals, valid, pend_j)
        st, act_t, _kgf = wkt.update(st, win_t, red_t,
                               *lanes_torch(hi, lo, ts, vals, valid),
                               maxp=MAXP, clear_rows=pend_t)
        if layout == "direct":
            # no insert phase: a device zero, as the reference's
            assert act_t.dtype == torch.int32 and act_t.dim() == 0
        sj = set_watermark(sj, st, int(wm))
        sj, pend_j, fr_j = adv_j(sj, np.int32(wm))
        st, pend_t, fr_t = wkt.advance_and_fire_resident(
            st, win_t, red_t, int(wm), reduced=False)
        np.testing.assert_array_equal(pend_t.numpy(), np.asarray(pend_j))
        yield sj, st, fr_j, fr_t, int(act_j), int(act_t)


@pytest.mark.parametrize("window", ["tumbling", "sliding"])
def test_direct_layout_rows_match_reference_in_order(window):
    n_rows = 0
    for sj, st, fr_j, fr_t, _, _ in _fire_sequence("direct", window, False):
        _assert_small_fields_equal(fr_j, fr_t, 0.0)
        _assert_rows_equal(fr_j, fr_t, 0.0, in_order=True)
        want, got = jax_fields(sj), wkt.state_to_numpy(st)
        for name in wkt.STATE_FIELDS:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
        n_rows += int(fr_t.counts.sum())
    assert n_rows > 0


@pytest.mark.parametrize("window,floats", [("tumbling", False),
                                           ("sliding", False),
                                           ("tumbling", True)])
def test_hash_layout_rows_match_reference(window, floats):
    rtol = 1e-6 if floats else 0.0
    _, red_j, _, red_t = specs(window)
    n_rows = n_new = 0
    for sj, st, fr_j, fr_t, act_j, act_t in _fire_sequence("hash", window,
                                                           floats):
        assert act_t == act_j
        n_new += act_t
        _assert_small_fields_equal(fr_j, fr_t, rtol)
        _assert_rows_equal(fr_j, fr_t, rtol, in_order=False)
        want = logical_state(jax_fields(sj), red_j)
        got = logical_state(wkt.state_to_numpy(st), red_t)
        for name, w in want.items():
            if name == "planes" and rtol:
                np.testing.assert_allclose(got[name], w, rtol=rtol, atol=0)
            else:
                np.testing.assert_array_equal(got[name], w, err_msg=name)
        n_rows += int(fr_t.counts.sum())
    assert n_rows > 0 and n_new > 0
    # the key -1 lanes and the too-old lanes dropped on both sides
    assert int(st.dropped_capacity) > 0


@pytest.mark.parametrize("C", [511, 513, 2047, 2049])
@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("pattern", ["last_slot", "everything"])
def test_fire_compact_plain_at_tile_edges(C, W, pattern):
    """fire_compact_plain on a packed sum plane [C * R, W + 1] against the
    reference's evaluation and pack on the same panes, k = 2 of R = 4
    ring rows, three lanes: lane 0 due over random touches plus the last
    three slots (one of its panes absent from the ring for ``last_slot``),
    lane 1 due over a pane touched at slot C - 1 alone (``last_slot``) or
    at every slot (``everything``), lane 2 not due."""
    rng = np.random.default_rng(C + 10 * W)
    Rr, k, n_f = 4, 2, 3
    vs = () if W == 1 else (W,)
    touched = rng.random((Rr, C)) < 0.3
    touched[:, -3:] = True
    pane_ids = np.array([8, 5, 6, 7], np.int32)        # pane q in row q % 4
    if pattern == "last_slot":
        touched[1] = False                              # pane 5: lane 1's
        touched[1, C - 1] = True
        pane_ids[2] = 2                                 # pane 6 is absent
    else:
        touched[1] = touched[0] = True
    vals = rng.integers(-9, 10, (Rr, C) + vs).astype(np.float32)
    vals = np.where(touched.reshape(touched.shape + (1,) * len(vs)), vals,
                    np.float32(0))
    p_f = np.array([7, 5, 9], np.int32)
    lane_ok = np.array([True, True, False])
    rows = rng.integers(0, 2**32, (C, 2), dtype=np.uint64).astype(np.uint32)

    win = wkj.WindowSpec(2 * 10, 10, ring=Rr, fires_per_step=n_f)
    red = wkj.ReduceSpec("sum", jnp.float32, value_shape=vs)
    emit_j, vals_j = wkj._eval_fire_lanes(
        jnp.asarray(vals), jnp.asarray(touched), jnp.asarray(pane_ids), win,
        red, jnp.asarray(p_f), jnp.asarray(lane_ok), jnp.asarray(touched))
    want = wkj._pack_fire_lanes(ht_ref.SlotTable(jnp.asarray(rows), 16),
                                emit_j, vals_j)

    acc = np.concatenate([vals.reshape(Rr * C, W),
                          touched.reshape(Rr * C, 1).astype(np.float32)], 1)
    out = (torch.empty(n_f, C, dtype=torch.int32),
           torch.empty(n_f, C, dtype=torch.int32),
           torch.empty((n_f, C) + vs, dtype=torch.float32))
    counts, vsums = kernels.fire_compact_plain(
        torch.from_numpy(acc), torch.from_numpy(pane_ids),
        torch.from_numpy(p_f), torch.from_numpy(lane_ok),
        ht_port.from_rows(rows, device="cpu"), *out, C=C, R=Rr, k=k)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(vsums.numpy(), np.asarray(want[4]))
    if pattern == "last_slot":
        assert counts.tolist()[1:] == [1, 0]
    else:
        assert counts.tolist()[1] == C
    for f in range(n_f):
        n = int(counts[f])
        for got, ref in zip(out, want[:3]):
            ref = np.asarray(ref)[f, :n]
            np.testing.assert_array_equal(
                got[f, :n].numpy().view(ref.dtype), ref)
