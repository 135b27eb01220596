"""A mid-stream window state carries from flink_tpu into flink_tpu_torch
(``state_from_numpy`` / ``state_to_numpy``): three batches in the JAX
reference, then three more on both sides, must end equal — in the direct
layout field for field, in the hash layout key by key (the carried table
is probed on the reference's chains; keys placed after the carry may take
other slots). Integer-valued data, so everything compares bit for bit."""

import numpy as np
import pytest
import torch

from torch_parity import (
    C, F, MAXP, R, assert_fires_equal, assert_states_equal, batches,
    fire_rows, jax_fields, jax_hash_kernels, jax_kernels, jax_set_watermark,
    lanes_torch, logical_state, set_watermark, sparse_batches, specs,
)

from flink_tpu.ops import window_kernels as wkj
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
        st, act_t = wkt.update(st, win_t, red_t,
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
