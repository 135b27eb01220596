"""The port's resident ring drain (flink_tpu_torch.runtime.step) against
flink_tpu's ``build_window_resident_drain`` on a one-shard CPU mesh:
depth D = 4 with count = 3 live slots. The per-slot ReducedFires, the
skipped fourth slot (zero fires, no state change), the final deferred
purge and the final state must all be equal. The compact drain
(``reduced=False``, CompactFires in a reused [D, F, C] arena) must give
the same rows: in order in the direct layout, sorted by key in the hash
layout, where the tables may place keys at other slots. Integer-valued
data, so everything compares bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    C, F, MAXP, batches, fire_rows, jax_fields, lanes_torch, logical_state,
    sparse_batches, specs,
)

from flink_tpu.ops import window_kernels as wkj
from flink_tpu.parallel.mesh import MeshContext
from flink_tpu.runtime import step as step_ref
from flink_tpu_torch.ops import window_kernels as wkt
from flink_tpu_torch.runtime import step as step_port

D, COUNT = 4, 3


@pytest.mark.parametrize("window", ["tumbling", "sliding"])
def test_resident_drain_matches_reference(window):
    win_j, red_j, win_t, red_t = specs(window)
    spec_j = step_ref.WindowStageSpec(win=win_j, red=red_j,
                                      capacity_per_shard=C, layout="direct",
                                      precombine=True, packed=True)
    spec_t = step_port.WindowStageSpec(win=win_t, red=red_t,
                                       capacity_per_shard=C)
    ctx = MeshContext.create(1, MAXP, devices=jax.devices()[:1])
    drain_j = step_ref.build_window_resident_drain(ctx, spec_j, D,
                                                   reduced=True)
    drain_t = step_port.build_window_resident_drain(spec_t, D, MAXP)

    sj = step_ref.init_sharded_state(ctx, spec_j)
    st = step_port.init_shard_state(spec_t, MAXP, "cpu")
    seq = batches(13)
    for first in (0, COUNT):                 # two drains, state carried
        group = seq[first:first + D]
        group += [group[-1]] * (D - len(group))   # past count: never read
        flat = [a for b in group for a in b[:5]]
        wmv = np.array([[b[5] for b in group]], np.int32)
        sj, _mon, fr_j = drain_j(sj, *flat, wmv, np.int32(COUNT))
        slots = [lanes_torch(*b[:5]) for b in group]
        st, _mon, fr_t = drain_t(st, slots, torch.from_numpy(wmv[0]),
                                  COUNT)
        for name in ("counts", "window_end_ticks", "n_fires", "lane_valid",
                     "value_sums"):
            np.testing.assert_array_equal(
                getattr(fr_t, name).numpy(),
                np.asarray(getattr(fr_j, name))[0], err_msg=name)
        assert not fr_t.lane_valid[COUNT:].any()
        want = jax.tree_util.tree_map(lambda x: np.asarray(x)[0], sj)
        got = wkt.state_to_numpy(st)
        np.testing.assert_array_equal(got["table.keys"],
                                      np.asarray(want.table.keys))
        for name in wkt.STATE_FIELDS[1:]:
            np.testing.assert_array_equal(
                got[name], np.asarray(getattr(want, name)), err_msg=name)
    assert int(st.fired_through) > int(wkt.PANE_NONE)


def test_drain_rejects_more_live_slots_than_depth():
    _, _, win_t, red_t = specs("tumbling")
    spec_t = step_port.WindowStageSpec(win=win_t, red=red_t,
                                       capacity_per_shard=C)
    drain_t = step_port.build_window_resident_drain(spec_t, 2, MAXP)
    st = step_port.init_shard_state(spec_t, MAXP, "cpu")
    slots = [lanes_torch(*b[:5]) for b in batches(1)[:3]]
    with pytest.raises(ValueError):
        drain_t(st, slots, torch.zeros(3, dtype=torch.int32), 3)


@pytest.mark.parametrize("layout", ["direct", "hash"])
def test_compact_drain_matches_reference(layout):
    win_j, red_j, win_t, red_t = specs("sliding")
    spec_j = step_ref.WindowStageSpec(win=win_j, red=red_j,
                                      capacity_per_shard=C, layout=layout,
                                      precombine=True, packed=True)
    spec_t = step_port.WindowStageSpec(win=win_t, red=red_t,
                                       capacity_per_shard=C, layout=layout)
    ctx = MeshContext.create(1, MAXP, devices=jax.devices()[:1])
    drain_j = step_ref.build_window_resident_drain(ctx, spec_j, D)
    drain_t = step_port.build_window_resident_drain(spec_t, D, MAXP,
                                                    reduced=False)
    sj = step_ref.init_sharded_state(ctx, spec_j)
    st = step_port.init_shard_state(spec_t, MAXP, "cpu")
    seq = batches(17) if layout == "direct" else sparse_batches(17)
    arenas = set()
    n_rows = 0
    for first in (0, COUNT):
        group = seq[first:first + D]
        group += [group[-1]] * (D - len(group))
        flat = [a for b in group for a in b[:5]]
        wmv = np.array([[b[5] for b in group]], np.int32)
        sj, _mon, fr_j = drain_j(sj, *flat, wmv, np.int32(COUNT))
        slots = [lanes_torch(*b[:5]) for b in group]
        st, _mon, fr_t = drain_t(st, slots, torch.from_numpy(wmv[0]),
                                  COUNT)
        arenas.add(fr_t.key_hi.data_ptr())
        assert tuple(fr_t.key_hi.shape) == (D, F, C)
        for name in ("counts", "window_end_ticks", "n_fires", "lane_valid",
                     "value_sums"):
            np.testing.assert_array_equal(
                getattr(fr_t, name).numpy(),
                np.asarray(getattr(fr_j, name))[0], err_msg=name)
        for d in range(D):
            sub_j = jax.tree_util.tree_map(lambda x: np.asarray(x)[0, d],
                                           fr_j)
            sub_t = wkt.CompactFires(*(getattr(fr_t, n)[d] for n in (
                "key_hi", "key_lo", "values", "counts", "window_end_ticks",
                "n_fires", "lane_valid", "value_sums")))
            for f in range(F):
                sorted_j, order_j = fire_rows(sub_j, f)
                sorted_t, order_t = fire_rows(sub_t, f)
                for a, b in zip(*((order_t, order_j) if layout == "direct"
                                  else (sorted_t, sorted_j))):
                    np.testing.assert_array_equal(a, b)
                n_rows += len(sorted_t[0])
        want = jax_fields(jax.tree_util.tree_map(lambda x: np.asarray(x)[0],
                                                 sj))
        want_l = logical_state(want, red_j)
        got_l = logical_state(wkt.state_to_numpy(st), red_t)
        for name, w in want_l.items():
            np.testing.assert_array_equal(got_l[name], w, err_msg=name)
    assert n_rows > 0
    assert len(arenas) == 1           # one arena, reused by every drain
