"""The window update at the lane shapes the card's G1 / G3 kernels treat
apart: flink_tpu_torch's ``update`` (its plain kernels, on the CPU)
against flink_tpu's on the same batches.

G1 and G3 take lanes four at a time with 16-byte loads and fall back to a
lane at a time for a tail or a view off that alignment; G1 folds the
batch's four stats in its last block (an empty batch writes the
sentinels); G3 adds a cell's values and marker in one vector reduction
(W = 1, 3; W = 2 split by the cell's 8-byte phase) and reads a min or max
cell once, storing its marker only where it is not yet set. The CPU runs
the plain versions, so these cases pin the contract that the chip script
(``chip_smoke.py route_edge_checks`` / ``update_edge_checks``) holds the
kernels to: B not a multiple of 4 (1,001, 3, 1), lanes given as views
one lane in, an empty batch (which the reference's update does not take:
the port's must leave the state as it was), a batch of invalid lanes
only, a batch of late lanes only, one owned key group, W = 2 and W = 3
sums, and a hot key taking a fifth of the lanes under min and max with
signed zeros.

Each case runs a few batches through both packages' update (the direct
layout, packed planes), advancing both watermarks after each, and compares
every state field. Integer-valued data is bit-exact; random floats (the
W = 2 float case) hold at rtol 1e-6, since the reference's pre-combine
adds a key's lanes in sorted segments and the port in lane order. Min and
max run against the reference's scatter path (pre-combine off), which
orders -0.0 below +0.0 as the port does.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    C, F, MAXP, R, SLIDE, WINDOWS, assert_states_equal, set_watermark,
)

from flink_tpu.core.keygroups import assign_to_key_group
from flink_tpu.ops import window_kernels as wkj
from flink_tpu.ops.hashing import route_hash
from flink_tpu_torch.ops import window_kernels as wkt

WIDTH = {"sum": 1, "w2": 2, "w3": 3, "min": 1, "max": 1}


def _specs(kind: str, window: str):
    W = WIDTH[kind]
    op = kind if kind in ("min", "max") else "sum"
    shape = () if W == 1 else (W,)
    return (wkj.WindowSpec(WINDOWS[window], SLIDE, ring=R, fires_per_step=F),
            wkj.ReduceSpec(op, jnp.float32, value_shape=shape),
            wkt.WindowSpec(WINDOWS[window], SLIDE, ring=R, fires_per_step=F),
            wkt.ReduceSpec(op, value_shape=shape))


@functools.lru_cache(maxsize=None)
def _jax_update(kind: str, window: str):
    """The reference's update, jitted once per process for each kind and
    window (pre-combine on for sums, off for min and max)."""
    win, red, _, _ = _specs(kind, window)

    def upd(st, hi, lo, ts, vals, valid):
        return wkj.update(st, win, red, hi, lo, ts, vals, valid,
                          direct=True,
                          precombine=kind not in ("min", "max"))[0]

    return jax.jit(upd)


def _lanes(rng, B: int, kind: str, panes=(2, 6), hot: float = 0.0,
           invalid: bool = False, floats: bool = False):
    """One batch: keys over [0, C + 64) (past capacity too), 2 % with a
    nonzero high word, ticks over ``panes``, 10 % invalid (all with
    ``invalid``), a ``hot`` share on key 7; values small integers (min and
    max: both signs and a tenth +-0.0), or uniform floats."""
    hi = np.where(rng.random(B) < 0.02, 1, 0).astype(np.uint32)
    lo = rng.integers(0, C + 64, B).astype(np.uint32)
    hot_lane = rng.random(B) < hot
    hi[hot_lane], lo[hot_lane] = 0, 7
    ts = rng.integers(panes[0] * SLIDE, panes[1] * SLIDE, B).astype(np.int32)
    W = WIDTH[kind]
    if floats:
        vals = rng.uniform(0.5, 8.0, (B, W)).astype(np.float32)
    elif kind in ("min", "max"):
        vals = rng.integers(-4, 5, (B, W)).astype(np.float32)
        zero = rng.random((B, W)) < 0.1
        vals[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
    else:
        vals = rng.integers(1, 9, (B, W)).astype(np.float32)
    if W == 1:
        vals = vals[:, 0]
    valid = np.zeros(B, bool) if invalid else rng.random(B) < 0.9
    return hi, lo, ts, vals, valid


def _port_lanes(hi, lo, ts, vals, valid, offset: int):
    """The port's tensors, as views ``offset`` lanes into larger ones."""
    def view(a, dtype):
        pad = np.zeros((offset,) + a.shape[1:], a.dtype)
        t = torch.from_numpy(np.concatenate([pad, a]).view(dtype))
        return t[offset:]
    return (view(hi, np.int32), view(lo, np.int32), view(ts, np.int32),
            view(vals, np.float32), view(valid, np.bool_))


def _owned(hi, lo, valid, kg_range):
    """The reference's caller masks lanes to the shard's key groups
    (runtime/step.py mask_update_shard)."""
    if kg_range is None:
        return valid
    kg = np.asarray(assign_to_key_group(route_hash(hi, lo, np), MAXP, np))
    return valid & (kg >= kg_range[0]) & (kg <= kg_range[1])


# (case, kind, window, [(B, options, watermark after)], offset, key groups)
CASES = [
    ("b_not_multiple_of_4", "sum", "sliding",
     [(1001, {}, 25), (3, {}, 35), (1, {}, 40)], 0, None),
    ("views_one_lane_in", "sum", "tumbling",
     [(1024, {}, 25), (1001, dict(panes=(3, 7)), 45)], 1, None),
    ("empty_batch", "sum", "sliding",
     [(512, {}, 25), (0, {}, 35), (512, dict(panes=(3, 7)), 45)], 0, None),
    ("all_invalid", "sum", "tumbling",
     [(512, {}, 25), (1024, dict(invalid=True), 35)], 0, None),
    ("all_late", "sum", "tumbling",
     [(512, {}, 200), (1024, {}, 205)], 0, None),
    ("one_key_group", "sum", "sliding",
     [(1024, {}, 25), (1024, dict(panes=(3, 7)), 45)], 0, (37, 37)),
    ("w2_integers", "w2", "sliding",
     [(1001, {}, 25), (1024, dict(hot=0.2, panes=(3, 7)), 45)], 1, None),
    ("w2_floats", "w2", "tumbling",
     [(1024, dict(floats=True), 25), (1003, dict(floats=True), 45)], 0,
     None),
    ("w3", "w3", "sliding",
     [(1024, {}, 25), (1002, dict(hot=0.2, panes=(3, 7)), 45)], 1,
     (10, 100)),
    ("hot_key_min", "min", "sliding",
     [(1024, dict(hot=0.2), 25), (1001, dict(hot=0.2, panes=(3, 7)), 45)],
     1, None),
    ("hot_key_max", "max", "tumbling",
     [(1024, dict(hot=0.2), 25), (1003, dict(hot=0.2, panes=(3, 7)), 45)],
     0, None),
]


@pytest.mark.parametrize("case,kind,window,schedule,offset,kg_range",
                         CASES, ids=[c[0] for c in CASES])
def test_update_edges_match_reference(case, kind, window, schedule, offset,
                                      kg_range):
    upd = _jax_update(kind, window)
    win_j, red_j, win_t, red_t = _specs(kind, window)
    sj = wkj.init_state(C, 16, win_j, red_j, layout="direct",
                        n_key_groups=MAXP, packed=True)
    st = wkt.init_state(C, win_t, red_t, n_key_groups=MAXP, device="cpu",
                        layout="direct")
    rng = np.random.default_rng(sum(map(ord, case)))
    floats = False
    kg = {} if kg_range is None else dict(kg_start=kg_range[0],
                                          kg_end=kg_range[1])
    for B, opts, wm in schedule:
        hi, lo, ts, vals, valid = _lanes(rng, B, kind, **opts)
        floats |= opts.get("floats", False)
        wkt.update(st, win_t, red_t, *_port_lanes(hi, lo, ts, vals, valid,
                                                  offset), maxp=MAXP, **kg)
        if B:
            sj = upd(sj, hi, lo, ts, vals, _owned(hi, lo, valid, kg_range))
        else:
            # the reference's update takes no empty batch (its pane max
            # has no identity): an empty batch must leave the state as is
            assert_states_equal(sj, st)
        sj = set_watermark(sj, st, wm)
    assert_states_equal(sj, st, rtol=1e-6 if floats else 0.0)
    if case == "all_late":
        assert int(st.dropped_late) > 0
    if case in ("hot_key_min", "hot_key_max"):
        # the hot key's cell holds a value and its marker in both packages
        acc = st.acc.numpy()
        assert (acc[7::C][:, 1] == 0.0).any()
