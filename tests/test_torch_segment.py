"""The segment sort and scan: flink_tpu_torch's ``ops/segment.py`` (G10's
plain version on the CPU, a stable one-bit-a-pass radix sort) against
flink_tpu's ``ops/segment.py`` on the same seeded ids. The permutation
must equal the reference's exactly: stability is semantics (rolling
outputs and the assignment of records to count windows follow lane order
within a key). The segmented scan holds integer-valued data bit for bit
and positive random floats at rtol 1e-6 (another combine order)."""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import segment as sgj
from flink_tpu.ops import session_windows as swj
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import segment as sgt

B = 2048
BIG = 2**31 - 1


def ids_of(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(-(2**31), 2**31 - 1, B).astype(np.int32)
    if kind == "few":
        return rng.integers(0, 7, B).astype(np.int32)
    if kind == "hot":                      # one id in most lanes
        ids = rng.integers(0, 5000, B).astype(np.int32)
        ids[rng.random(B) < 0.8] = 42
        return ids
    return np.full(B, 3, np.int32)         # "one": a single segment


@pytest.mark.parametrize("kind", ["random", "few", "hot", "one"])
def test_argsort_ids_equals_reference_permutation(kind):
    ids = ids_of(kind, 1)
    want = np.asarray(sgj.argsort_ids(jnp.asarray(ids), stable=True))
    got = sgt.argsort_ids(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["random", "hot"])
def test_segment_sort_equals_reference(kind):
    ids = ids_of(kind, 2)
    valid = np.random.default_rng(3).random(B) < 0.9
    want = sgj.segment_sort(jnp.asarray(ids), jnp.asarray(valid))
    got = sgt.segment_sort(torch.from_numpy(ids), torch.from_numpy(valid))
    for name, w, g in zip(("order", "ids_s", "valid_s", "seg_start",
                           "rep_mask"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("capacity,n", [
    (1024, B), (1 << 22, B),
    # lane counts around G10's tile (kernels.SORT_TILE lanes)
    (1 << 20, kernels.SORT_TILE - 1), (1 << 20, kernels.SORT_TILE + 1),
    (1 << 16, 3 * kernels.SORT_TILE + 5)])
def test_slot_sort_equals_reference(capacity, n):
    rng = np.random.default_rng(4)
    slot = rng.integers(0, capacity, n).astype(np.int32)
    slot[: n // 4] = 9
    live = rng.random(n) < 0.9
    want = np.asarray(sgj.argsort_ids(jnp.where(live, slot, BIG)))
    order, key_s, seg_start = sgt.sort_slots(torch.from_numpy(slot),
                                             torch.from_numpy(live),
                                             capacity)
    np.testing.assert_array_equal(order.numpy(), want)
    ids_s = np.where(live, slot, capacity)[want]
    np.testing.assert_array_equal(key_s.numpy(), ids_s)
    np.testing.assert_array_equal(
        seg_start.numpy(), np.r_[True, ids_s[1:] != ids_s[:-1]])


@pytest.mark.parametrize("ts_kind,C,n", [
    ("narrow", 4096, B), ("wide", 4096, B),
    # the DCN sessions' 51-bit key (C = 2^18): ticks in a 40,000-tick
    # batch, so the tick's two high digits are constant and the slot's
    # low digit lies between live ones; lane counts off G10's tile
    ("batch", 1 << 18, kernels.SORT_TILE + 3),
    ("batch", 1 << 18, 2 * kernels.SORT_TILE - 7)])
def test_slot_tick_sort_equals_reference_lexsort(ts_kind, C, n):
    rng = np.random.default_rng(5)
    slot = rng.integers(0, min(C, 300), n).astype(np.int32)
    slot[: n // 3] = 17
    if ts_kind == "narrow":
        ts = rng.integers(1000, 1200, n).astype(np.int32)
    elif ts_kind == "batch":
        slot = rng.integers(0, C, n).astype(np.int32)
        ts = rng.integers(5_000_000, 5_040_000, n).astype(np.int32)
        # the key's two middle digits (bits 16-31) are one value
        assert len(np.unique((ts.astype(np.int64) + 2**31) >> 16)) == 1
    else:
        ts = rng.integers(-(2**31) + 1, 2**31 - 5, n).astype(np.int32)
    ts[:50] = ts[50]                          # equal (slot, tick) pairs
    live = rng.random(n) < 0.9
    want = np.asarray(swj._lexsort_slot_ts(
        jnp.where(live, slot, BIG), jnp.where(live, ts, BIG)))
    order, key_s, seg_start = sgt.sort_slot_ts(
        torch.from_numpy(slot), torch.from_numpy(ts),
        torch.from_numpy(live), C)
    np.testing.assert_array_equal(order.numpy(), want)
    ids_s, ts_s = kernels.session_key_ts(key_s)
    live_s = live[want]
    np.testing.assert_array_equal(ids_s.numpy()[live_s], slot[want][live_s])
    np.testing.assert_array_equal(ts_s.numpy()[live_s], ts[want][live_s])
    np.testing.assert_array_equal(seg_start.numpy(),
                                  np.r_[True, ids_s[1:].numpy()
                                        != ids_s[:-1].numpy()])


@pytest.mark.parametrize("n,tiles", [
    (0, 1), (1, 1), (kernels.SORT_TILE, 1), (kernels.SORT_TILE + 1, 2),
    (1 << 19, (1 << 19) // kernels.SORT_TILE)])
def test_sort_tiles(n, tiles):
    assert kernels.sort_tiles(n) == tiles


def test_sort_scratch_grows_and_flips_its_parity():
    """G10's scratch (allocated once a device and stream): the status
    halves grow to the largest n's tiles; each take gives the next
    parity; a reset (after a refused launch) zeroes the state and starts
    the parities again."""
    sc = kernels._SortScratch(torch.device("cpu"))
    assert sc.state.shape == (kernels.SORT_STATE_WORDS,)
    assert not sc.state.any()
    status, parity = sc.take(5 * kernels.SORT_TILE)
    assert status.shape == (2, 5, kernels.SORT_BINS) and parity == 0
    assert status.dtype == torch.int32 and not status.any()
    status2, parity = sc.take(kernels.SORT_TILE)
    assert status2 is status and parity == 1
    status3, parity = sc.take(9 * kernels.SORT_TILE + 1)
    assert status3.shape == (2, 10, kernels.SORT_BINS) and parity == 0
    sc.take(1)
    sc.state.fill_(7)
    sc.reset()
    assert not sc.state.any() and sc.take(1)[1] == 0


def test_invert_permutation_equals_reference():
    order = np.random.default_rng(6).permutation(B).astype(np.int32)
    want = np.asarray(sgj.invert_permutation(jnp.asarray(order)))
    got = sgt.invert_permutation(torch.from_numpy(order)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,floats,op", [
    ("hot", False, "add"), ("few", True, "add"), ("random", False, "max"),
    ("one", False, "add")])
def test_segmented_reduce_sorted_equals_reference(kind, floats, op):
    rng = np.random.default_rng(7)
    ids = np.sort(ids_of(kind, 8))
    seg_start = np.r_[True, ids[1:] != ids[:-1]]
    vals = (rng.uniform(0.5, 8.0, B) if floats
            else rng.integers(-9, 9, B)).astype(np.float32)
    fj = jnp.add if op == "add" else jnp.maximum
    ft = torch.add if op == "add" else torch.maximum
    want = np.asarray(sgj.segmented_reduce_sorted(
        jnp.asarray(vals), jnp.asarray(seg_start), fj))
    got = sgt.segmented_reduce_sorted(torch.from_numpy(vals),
                                      torch.from_numpy(seg_start), ft)
    np.testing.assert_allclose(got.numpy(), want,
                               rtol=1e-6 if floats else 0, atol=0)


def test_reduce_sorted_equals_reference():
    ids = ids_of("hot", 9)
    valid = np.random.default_rng(10).random(B) < 0.8
    vals = np.random.default_rng(11).integers(1, 9, B).astype(np.float32)
    order, _, valid_s, seg_start, rep = sgj.segment_sort(jnp.asarray(ids),
                                                         jnp.asarray(valid))
    want = sgj.reduce_sorted(order, valid_s, seg_start, jnp.asarray(vals),
                             jnp.add, 0.0)
    o, _, vs, ss, rp = sgt.segment_sort(torch.from_numpy(ids),
                                        torch.from_numpy(valid))
    got = sgt.reduce_sorted(o, vs, ss, torch.from_numpy(vals), torch.add,
                            0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
