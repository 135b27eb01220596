"""flink_tpu_torch.ops.window_kernels against flink_tpu.ops.window_kernels.

The same six batches (tests/torch_parity.py: late, too-old, invalid and
out-of-range lanes, a ring rotation that evicts unfired panes, a folded
deferred purge, negative ticks, multi-window watermark jumps) go through
the JAX reference on the CPU — direct layout, packed planes, pre-combine
on and off — and through the port on the CPU (its kernels' plain
versions).

Tolerances: integer-valued float data must match bit for bit. Random
float values get rtol=1e-6 on the accumulator and the fire value sums:
the reference's pre-combine adds a key's lanes in sorted segments, the
port adds them in lane order (and on the card with atomics, in any
order), so the float sums round differently.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import (
    C, MAXP, R, assert_fires_equal, assert_states_equal, batches,
    jax_kernels, lanes_torch, set_watermark, specs,
)

from flink_tpu.ops import window_kernels as wkj
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import window_kernels as wkt

# (window, reference pre-combine, random float values)
CASES = [
    pytest.param(window, precombine, False,
                 id=f"{window}-precombine_{'on' if precombine else 'off'}")
    for window in ("tumbling", "sliding") for precombine in (True, False)
] + [pytest.param("tumbling", True, True, id="tumbling-precombine_on-floats")]


def _fresh(window):
    win_j, red_j, win_t, red_t = specs(window)
    sj = wkj.init_state(C, 16, win_j, red_j, layout="direct",
                        n_key_groups=MAXP, packed=True)
    st = wkt.init_state(C, win_t, red_t, n_key_groups=MAXP,
                        device="cpu")
    return win_j, red_j, win_t, red_t, sj, st


@pytest.mark.parametrize("window,precombine,floats", CASES)
def test_update_sequence_matches_reference(window, precombine, floats):
    win_j, red_j, win_t, red_t, sj, st = _fresh(window)
    upd, _ = jax_kernels(window, precombine)
    rtol = 1e-6 if floats else 0.0
    for hi, lo, ts, vals, valid, wm, clear in batches(7, floats):
        sj = upd(sj, hi, lo, ts, vals, valid, clear)
        wkt.update(st, win_t, red_t, *lanes_torch(hi, lo, ts, vals, valid),
                   maxp=MAXP, clear_rows=torch.from_numpy(clear))
        assert_states_equal(sj, st, rtol)
        sj = set_watermark(sj, st, int(wm))
    # the sequence reached the branches it exists for
    assert int(st.dropped_late) > 0
    assert int(st.dropped_capacity) > 0


@pytest.mark.parametrize("window,precombine,floats", CASES)
def test_fire_and_purge_sequence_matches_reference(window, precombine,
                                                   floats):
    """update -> watermark -> advance_and_fire_resident(reduced=True), the
    purge rows deferred into the next update's sweep, and the last ones
    applied with apply_pending_purge — the resident drain's slot order."""
    win_j, red_j, win_t, red_t, sj, st = _fresh(window)
    upd, adv = jax_kernels(window, precombine)
    rtol = 1e-6 if floats else 0.0
    pend_j = np.zeros(R, bool)
    pend_t = torch.zeros(R, dtype=torch.bool)
    n_fired = 0
    for hi, lo, ts, vals, valid, wm, _clear in batches(11, floats):
        sj = upd(sj, hi, lo, ts, vals, valid, pend_j)
        wkt.update(st, win_t, red_t, *lanes_torch(hi, lo, ts, vals, valid),
                   maxp=MAXP, clear_rows=pend_t)
        sj = set_watermark(sj, st, int(wm))
        sj, pend_j, fr_j = adv(sj, np.int32(wm))
        st, pend_t, fr_t = wkt.advance_and_fire_resident(
            st, win_t, red_t, torch.tensor(int(wm), dtype=torch.int32),
            reduced=True)
        assert_fires_equal(fr_j, fr_t, rtol)
        np.testing.assert_array_equal(pend_t.numpy(), np.asarray(pend_j))
        assert_states_equal(sj, st, rtol)
        n_fired += int(fr_t.n_fires)
    sj = wkj.apply_pending_purge(sj, win_j, red_j, pend_j)
    wkt.apply_pending_purge(st, win_t, red_t, pend_t)
    assert_states_equal(sj, st, rtol)
    assert n_fired > 0 and np.asarray(pend_j).any()


def test_cpu_tensors_never_launch_a_kernel():
    """On CPU tensors every wrapper runs its plain version: no counter
    moves and nothing is compiled (G1-G20)."""
    kernels.reset_launch_counts()
    _, _, win_t, red_t, _, st = _fresh("tumbling")
    hi, lo, ts, vals, valid, wm, clear = batches(3)[0]
    wkt.update(st, win_t, red_t, *lanes_torch(hi, lo, ts, vals, valid),
               maxp=MAXP)
    wkt.advance_and_fire_resident(st, win_t, red_t, int(wm), reduced=True)
    wkt.advance_and_fire_resident(st, win_t, red_t, int(wm) + 100)
    win_o = dataclasses.replace(win_t, overflow=256)
    st_h = wkt.init_state(C, win_o, red_t, n_key_groups=MAXP, device="cpu",
                          layout="hash")
    for insert, lanes in zip((True, False), batches(3)):
        wkt.update(st_h, win_o, red_t, *lanes_torch(*lanes[:5]), maxp=MAXP,
                   insert=insert)
    assert int(st_h.ovf_n) > 0          # the fast update spilled new keys
    wkt.compact_table(st_h, win_o, red_t)
    # the session, count-window and rolling stages (G10-G13)
    from flink_tpu_torch.ops import count_windows, rolling, session_windows
    lanes = lanes_torch(*batches(4)[0][:5])
    rolling.update(rolling.init_state(C, device="cpu"), lanes[0], lanes[1],
                   lanes[3], lanes[4])
    count_windows.update(count_windows.init_state(C, device="cpu"), 3,
                         lanes[0], lanes[1], lanes[3], lanes[4])
    session_windows.update_and_fire(
        session_windows.init_state(C, device="cpu"), 5, *lanes,
        torch.tensor(20, dtype=torch.int32))
    # the sketch windows (G2's split planes, G14, G15)
    from torch_parity import port_lanes, sketch_batches, sketch_states
    for kind in ("hll", "cms_query"):
        _, _, win_s, red_s, _, st_s = sketch_states(kind)
        hi, lo, ts, h, valid, wm, clear = sketch_batches(5)[0]
        wkt.update(st_s, win_s, red_s, *port_lanes(hi, lo, ts, h, valid),
                   maxp=MAXP, clear_rows=torch.from_numpy(clear))
        wkt.advance_and_fire_resident(st_s, win_s, red_s, int(wm) + 100,
                                      reduced=True)
        _, pend, _ = wkt.advance_and_fire_resident(st_s, win_s, red_s,
                                                   int(wm) + 200)
        wkt.apply_pending_purge(st_s, win_s, red_s, pend)
    # min, mean, a generic reduce (G16, G6's fire_pack) and allowed
    # lateness (G2's fresh_rows, the re-fire lanes), and a generic rolling
    # reduce
    from torch_parity import LATENESS, late_batches, reduce_pair, \
        reduce_values
    for kind in ("min", "mean", "gvec"):
        red_k = reduce_pair(kind)[1]
        win_l = dataclasses.replace(win_t, lateness_ticks=LATENESS)
        st_k = wkt.init_state(C, win_l, red_k, n_key_groups=MAXP,
                              device="cpu")
        for i, (hi, lo, ts, vals, valid, wm, _c) in enumerate(
                late_batches(3)[:3]):
            lanes = lanes_torch(hi, lo, ts, vals, valid)
            wkt.update(st_k, win_l, red_k, *lanes[:3],
                       torch.from_numpy(reduce_values(kind, vals, i)),
                       lanes[4], maxp=MAXP)
            wkt.advance_and_fire_resident(st_k, win_l, red_k, int(wm),
                                          reduced=i == 1)
    red_g = reduce_pair("gmax")[1]
    rolling.update(rolling.init_state(C, device="cpu", red=red_g),
                   lanes[0], lanes[1], lanes[3], lanes[4], red=red_g)
    # the telemetry: G1's fill, G17, G18 and its companion in a drain
    from flink_tpu_torch.runtime import step as step_port
    spec = step_port.WindowStageSpec(win=win_t, red=red_t,
                                     capacity_per_shard=C)
    drain = step_port.build_window_resident_drain(
        spec, 2, MAXP, kg_fill=True, drain_stats=True)
    st_d = step_port.init_shard_state(spec, MAXP, "cpu")
    b = batches(6)[:2]
    drain(st_d, [lanes_torch(*x[:5]) for x in b],
          torch.tensor([x[5] for x in b], dtype=torch.int32), 2)
    step_port.build_kg_occupancy_step(spec, MAXP)(st_d)
    # device CEP's count NFA (G19) with within()'s expiry (G20)
    from flink_tpu_torch.cep import device as cep_device
    spec_c = cep_device.DevicePatternSpec(3, (True, False, True), 9, 10)
    st_c = cep_device.init_state(C, 16, spec_c, device="cpu")
    for pane in (0, 1, 12):
        cep_device.advance(st_c, spec_c, lanes[0], lanes[1],
                           lanes[4][:, None].expand(-1, 3).contiguous(),
                           lanes[4], pane)
    # a chained drain with its recorder (G21, G22 and G18's deferred mode)
    spec_1 = step_port.WindowStageSpec(
        win=wkt.WindowSpec(40, 40, ring=8, fires_per_step=2), red=red_t,
        capacity_per_shard=C)
    chained = step_port.build_window_chained_drain(
        (spec, spec_1), 2, MAXP, drain_stats=True)
    sts = tuple(step_port.init_shard_state(sp, MAXP, "cpu")
                for sp in (spec, spec_1))
    chained(sts, [lanes_torch(*x[:5]) for x in b],
            torch.tensor([x[5] for x in b], dtype=torch.int32), 2)
    assert len(kernels.KERNELS) == 27
    assert [fn.launches for fn in kernels.KERNELS] == [0] * 27
