"""G7's ring append and G26's exchange pack at the shapes their one-launch
card kernels treat apart: the port's ``ops/cuda.py ring_append`` and
``parallel/exchange.py exchange_records`` (G26 then the all_to_all), which
on the CPU run their plain twins, against flink_tpu's
``ops/window_kernels.py ring_append`` and ``parallel/exchange.py
exchange_records`` (under ``shard_map`` over n of the conftest's 8 CPU
devices) on the same numpy-seeded inputs.

G7 on the card is one pass over 2,048-lane tiles whose offsets come from a
decoupled look-back, tile 0 folding in the ring's fill; so here a ring
full on entry (every lane lost and counted, the fill unchanged), one that
fills in the middle of a tile, every lane masked over several tiles, and
W = 2 value columns (mean's [sum, count]). G26 is one cooperative launch
whose blocks read each other's counts a target; so here n = 1, 2 and 8
shards and the smallest bucket (cap = 8, most lanes past it). The cases
that fit the existing parametrisations (a ring that fills exactly, no lane
masked, one lane; one lane a shard) are in ``test_torch_spill.py`` and
``test_torch_exchange.py``.

Every value is an integer, so every comparison is exact.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flink_tpu.core.compat import shard_map
from flink_tpu.ops import window_kernels as wkj
from flink_tpu.parallel import exchange as ex_ref
from flink_tpu.parallel.mesh import SHARD_AXIS, MeshContext as MeshRef
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.parallel import exchange as ex_port

TILE = 2048       # G7's tile on the card (ops/cuda.py RING_TILE)
MAXP = 128
CPU = torch.device("cpu")


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch; uint32 halves travel as int32 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


# ------------------------------------------------------------------- G7

def _ring_case(case):
    """(ring O, fill, B, mask share, W) of each G7 case."""
    return {
        "full_on_entry": (3000, 3000, 2 * TILE + 5, 0.6, 1),
        "fills_mid_tile": (2500, 1500, 3 * TILE, 0.5, 1),
        "every_lane_masked": (4 * TILE, 77, 3 * TILE + 1, 1.0, 1),
        "w2": (4 * TILE, 200, 2 * TILE + 1, 0.4, 2),
        "w2_fills": (TILE, 200, 2 * TILE + 1, 0.4, 2),
    }[case]


@pytest.mark.parametrize("case", ["full_on_entry", "fills_mid_tile",
                                  "every_lane_masked", "w2", "w2_fills"])
def test_ring_append_edges_match_reference(case):
    """The ring's four columns, its fill and the lost count equal the
    reference's; the lanes land in lane order from the fill on."""
    O, n0, B, share, W = _ring_case(case)
    rng = np.random.default_rng(23)
    vshape = (O, W) if W > 1 else (O,)
    ring0 = (rng.integers(0, 2**32, O, dtype=np.uint32),
             rng.integers(0, 2**32, O, dtype=np.uint32),
             rng.integers(-50, 50, O).astype(np.int32),
             rng.integers(1, 9, vshape).astype(np.float32))
    hi = rng.integers(0, 2**32, B, dtype=np.uint32)
    lo = rng.integers(0, 2**32, B, dtype=np.uint32)
    pane = rng.integers(-3, 20, B).astype(np.int32)
    vals = rng.integers(1, 99, (B, W) if W > 1 else B).astype(np.float32)
    mask = rng.random(B) < share
    (jh, jl, jp, jv, jn), j_lost = wkj.ring_append(
        tuple(jnp.asarray(a) for a in ring0) + (jnp.int32(n0),),
        jnp.asarray(mask), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(pane), jnp.asarray(vals), O)
    ring = tuple(_t(a) for a in ring0) + (torch.tensor(n0, dtype=torch.int32),)
    lost = torch.zeros((), dtype=torch.int32)
    kernels.ring_append(ring, lost, _t(mask), _t(hi), _t(lo), _t(pane),
                        _t(vals))
    for got, want in zip(ring[:2], (jh, jl)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
    np.testing.assert_array_equal(ring[2].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ring[3].numpy(), np.asarray(jv))
    assert int(ring[4]) == int(jn) and int(lost) == int(j_lost)
    n = int(mask.sum())
    assert int(lost) == max(0, n0 + n - O)
    if case == "full_on_entry":
        assert int(lost) == n > 0
        for got, want in zip(ring[:4], ring0):
            np.testing.assert_array_equal(got.numpy(), _t(want).numpy())


# ------------------------------------------------------------------ G26

def _lanes(seed, B):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 500, B).astype(np.uint64) * np.uint64(
        0x9E3779B97F4A7C15) + np.uint64(3)
    hi = (k >> np.uint64(32)).astype(np.uint32)
    lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    ts = rng.integers(0, 5000, B).astype(np.int32)
    vals = rng.integers(1, 99, B).astype(np.float32)
    return hi, lo, ts, vals, rng.random(B) < 0.9


def _exchange_reference(arrays, n, cap):
    """exchange_records under shard_map over n devices: each device's
    received lanes ([n * cap] a device, concatenated) and its overflow."""
    mesh = MeshRef.create(n, MAXP, devices=jax.devices()[:n]).mesh

    def body(h, l, t, v, ok):
        cols, r_hi, r_lo, r_ok, n_over = ex_ref.exchange_records(
            {"ts": t, "values": v}, h, l, ok, n, MAXP, cap)
        return r_hi, r_lo, cols["ts"], cols["values"], r_ok, n_over[None]

    f = shard_map(body, mesh=mesh, in_specs=(P(SHARD_AXIS),) * 5,
                  out_specs=(P(SHARD_AXIS),) * 6, check_vma=False)
    out = jax.jit(f)(*(jnp.asarray(a) for a in arrays))
    return [np.asarray(o) for o in out]


def _exchange_port(arrays, n, cap):
    slot = tuple(_t(a) for a in arrays)
    received, over = ex_port.exchange_records(
        ex_port.split_lanes(slot, n, [CPU] * n), n, MAXP, cap, [CPU] * n)
    cols = [np.concatenate([r[j].numpy() for r in received])
            for j in range(5)]
    cols[0] = cols[0].view(np.uint32)
    cols[1] = cols[1].view(np.uint32)
    return cols + [np.concatenate([o.numpy() for o in over])]


@pytest.mark.parametrize("n,cap", [(1, None), (2, None), (8, None),
                                   (4, 8)])
def test_exchange_edges_match_reference(n, cap):
    """Every received column, its lane order and each source's overflow
    equal the reference's, at n shards (cap None: the exchange's default
    capacity, bucket_capacity(B / n, n, 2.0))."""
    B = 96 * n
    arrays = _lanes(40 + n, B)
    if cap is None:
        cap = ex_port.bucket_capacity(B // n, n, 2.0)
        assert cap == ex_ref.bucket_capacity(B // n, n, 2.0)
    want = _exchange_reference(arrays, n, cap)
    got = _exchange_port(arrays, n, cap)
    for w, g, name in zip(want, got, ("hi", "lo", "ts", "values", "valid",
                                      "overflow")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    if cap == 8:
        assert got[5].sum() > 0          # most lanes past the small buckets
