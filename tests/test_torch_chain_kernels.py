"""The chained stages' edge kernels against the reference's functions:
G21 ``chain_pack`` (through ``runtime/step.py chain_fires_to_lanes`` and
``chain_stage_watermark``) against ``flink_tpu.runtime.step``'s
``_chain_fires_to_lanes`` and ``_chain_stage_watermark``, and G22
``fire_columns`` (``deferred_fire_columns``) against
``_deferred_fire_columns``, on the same seeded numpy stacks. On the CPU
the port runs the kernels' plain versions. Every case is bit-exact: the
edge only moves bits.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import window_kernels as wkj
from flink_tpu.runtime import step as step_ref
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import window_kernels as wkt
from flink_tpu_torch.runtime import step as step_port

C = 64


def stack(seed, D, F, W=None, count_hi=C, valid_p=0.7, lead=True):
    """A seeded [D, F, C] fire stack (``lead=False``: one slot's [F, C])
    as numpy fields: uint32 key halves, float32 values [.., C] or [.., C,
    W], counts in [0, count_hi], lane_valid, window ends."""
    rng = np.random.default_rng(seed)
    shape = (D, F) if lead else (F,)
    vshape = shape + (C,) + (() if W is None else (W,))
    f = {
        "key_hi": rng.integers(0, 2**32, shape + (C,), dtype=np.uint64)
        .astype(np.uint32),
        "key_lo": rng.integers(0, 2**32, shape + (C,), dtype=np.uint64)
        .astype(np.uint32),
        "values": rng.standard_normal(vshape).astype(np.float32),
        "counts": rng.integers(0, count_hi + 1, shape).astype(np.int32),
        "lane_valid": rng.random(shape) < valid_p,
        "window_end_ticks": rng.integers(-50, 10_000, shape)
        .astype(np.int32),
    }
    return f


def ref_fires(f):
    lead = f["counts"].shape
    return wkj.CompactFires(
        jnp.asarray(f["key_hi"]), jnp.asarray(f["key_lo"]),
        jnp.asarray(f["values"]), jnp.asarray(f["counts"]),
        jnp.asarray(f["window_end_ticks"]),
        jnp.asarray(np.int32(f["lane_valid"].sum())),
        jnp.asarray(f["lane_valid"]), jnp.zeros(lead, jnp.float32))


def port_fires(f):
    lead = f["counts"].shape
    t = torch.from_numpy
    return wkt.CompactFires(
        t(f["key_hi"].view(np.int32).copy()),
        t(f["key_lo"].view(np.int32).copy()), t(f["values"].copy()),
        t(f["counts"].copy()), t(f["window_end_ticks"].copy()),
        torch.tensor(int(f["lane_valid"].sum()), dtype=torch.int32),
        t(f["lane_valid"].copy()), torch.zeros(lead))


def assert_lanes_equal(want, got):
    names = ("hi", "lo", "ts", "vals", "ok", "dropped", "demand")
    for name, w, g in zip(names, want, got):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        assert w.shape == g.shape, (name, w.shape, g.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)


CASES = {
    # (seed, D, F, W, count_hi, valid_p, E, lead)
    "drain": (1, 4, 2, None, C, 0.7, 512, True),
    "over_full": (2, 4, 2, None, C, 1.0, 100, True),
    "invalid_lanes": (3, 6, 2, None, C, 0.3, 512, True),
    "counts_above_c": (4, 3, 2, None, 3 * C, 0.8, 1024, True),
    "w2": (5, 4, 2, 2, C, 0.7, 512, True),
    "one_slot": (6, 1, 4, None, C, 0.8, 300, False),
    "all_invalid": (7, 4, 2, None, C, 0.0, 128, True),
    "all_empty": (8, 4, 2, None, 0, 1.0, 128, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_fires_to_lanes_matches_reference(case):
    seed, D, F, W, count_hi, valid_p, E, lead = CASES[case]
    f = stack(seed, D, F, W, count_hi, valid_p, lead)
    want = step_ref._chain_fires_to_lanes(ref_fires(f), E)
    got = step_port.chain_fires_to_lanes(port_fires(f), E)
    assert_lanes_equal(want, got)
    live = np.where(f["lane_valid"], np.minimum(f["counts"], C), 0).sum()
    assert int(got[6]) == live and int(got[5]) == max(live - E, 0)
    if case == "over_full":
        assert int(got[5]) > 0
    if case in ("all_invalid", "all_empty"):
        assert int(got[6]) == 0 and not got[4].any()


def test_chain_pack_refuses_more_planes_than_its_plan_scans():
    f = stack(9, kernels.CHAIN_MAX_PLANES + 1, 1, lead=True)
    with pytest.raises(ValueError, match="fire planes"):
        step_port.chain_fires_to_lanes(port_fires(f), 16)


SLIDE = 1000
FT_CAP = (2**31 - 4) // SLIDE - 2


@pytest.mark.parametrize("up_wm, fired_through", [
    (-(2**31) + 1, -(2**31) + 1),    # a fresh job: both sentinels
    (5_000, -(2**31) + 1),           # fired_through at its sentinel
    (5_000, -1),                     # fired_through at -1
    (12_345, 4),                     # mid-range: the horizon binds
    (3_000, 40),                     # mid-range: the watermark binds
    (-7_001, -9),                    # negative watermarks
    (2**31 - 4, 2**31 // SLIDE),     # the end-of-stream jump: clamped
    (2**31 - 4, FT_CAP),
    (2**31 - 4, FT_CAP - 1),
])
def test_chain_stage_watermark_matches_reference(up_wm, fired_through):
    spec_j = types.SimpleNamespace(
        win=types.SimpleNamespace(slide_ticks=SLIDE))
    st_j = types.SimpleNamespace(fired_through=jnp.int32(fired_through))
    want = int(step_ref._chain_stage_watermark(jnp.int32(up_wm), st_j,
                                               spec_j))
    win = wkt.WindowSpec(2 * SLIDE, SLIDE, ring=8, fires_per_step=2)
    st = wkt.init_state(16, win, wkt.ReduceSpec("sum"), device="cpu")
    st.fired_through.fill_(fired_through)
    spec = step_port.WindowStageSpec(win, wkt.ReduceSpec("sum"),
                                     capacity_per_shard=16)
    got = step_port.chain_stage_watermark(
        torch.tensor(up_wm, dtype=torch.int32), st, spec)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == want
    # the same watermark comes out of a pack with lanes (the tail's call)
    f = port_fires(stack(10, 2, 2))
    e = kernels.chain_pack(f.key_hi, f.key_lo, f.values, f.counts,
                           f.lane_valid, f.window_end_ticks, n_lanes=64,
                           up_wm=torch.tensor(up_wm, dtype=torch.int32),
                           fired_through=st.fired_through, slide=SLIDE)
    assert int(e.wm) == want


@pytest.mark.parametrize("seed, D, F, skipped", [
    (11, 4, 2, 0), (12, 16, 2, 5), (13, 3, 4, 3)])
def test_deferred_fire_columns_matches_reference(seed, D, F, skipped):
    rng = np.random.default_rng(seed)
    f = stack(seed, D, F)
    # slots past ``count`` stack zero fires
    if skipped:
        f["counts"][D - skipped:] = 0
        f["lane_valid"][D - skipped:] = False
    ds = rng.integers(0, 1000, (D, 9)).astype(np.int32)
    ds[:, 2:4] = 0                     # defer_fires wrote zeros there
    want = np.asarray(step_ref._deferred_fire_columns(
        jnp.asarray(ds), ref_fires(f)))
    got = step_port.deferred_fire_columns(torch.from_numpy(ds.copy()),
                                          port_fires(f))
    np.testing.assert_array_equal(got.numpy(), want)
    if skipped:
        assert not got.numpy()[D - skipped:, 2:4].any()


def test_stage_record_plain_clamps_like_the_slot_recorder():
    """G22's stage_record: the first advance from the MIN sentinel counts
    no panes; a jump past 2^20 ticks counts 2^20 of them; the lag is in
    the stage's panes and never negative; edge events are the demand
    clamped to E."""
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    row = torch.empty(6, dtype=torch.int32)
    lanes = torch.tensor([True, False])
    kernels.stage_record(row, i32(900), 512, lanes, i32(388), i32(30_000),
                         i32(9_998), i32(-(2**31) + 1), i32(9_998),
                         slide=5_000)
    assert row.tolist() == [900, 512, 1, 388, 4, 0]
    kernels.stage_record(row, i32(10), 512, lanes, i32(0), i32(2**31 - 4),
                         i32(2**31 - 4), i32(9_998), i32(2**31 - 4),
                         slide=5_000)
    want_panes = (2**31 - 4) // 5000 - (2**31 - 4 - (1 << 20)) // 5000
    assert row.tolist() == [10, 10, 1, 0, 0, want_panes]
