"""The hash state layout's key table (flink_tpu_torch.ops.hashtable, the
plain version of kernel G5) against flink_tpu.ops.hashtable on the CPU, at
C = 4096 slots, B = 1024 lanes, P = 16.

``probe_hash`` must match numpy and jnp bit for bit, or a table carried
over from the reference would be probed on other chains. Which of several
keys racing for one free slot wins differs between XLA's scatter and the
port, so tables compare as sets: the same keys, each once, each within P
slots of its chain's start, at the slot ``lookup`` returns. ``ok`` and
``n_new`` must be equal. Below capacity the reference's four claim rounds
and the port's walk place the same keys; the overload case checks the
port's own contract instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.ops import hashing as hash_ref
from flink_tpu.ops import hashtable as ht_ref
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import hashing as hash_port
from flink_tpu_torch.ops import hashtable as ht_port

C, B, P = 4096, 1024, 16
EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)


def _halves(keys: np.ndarray):
    w = np.asarray(keys, np.int64).view(np.uint64)
    return ((w >> np.uint64(32)).astype(np.uint32),
            (w & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _wrapping_keys(rng, n):
    """Keys whose probe chain starts within P - 1 slots of the end, so it
    wraps at C."""
    out = []
    while len(out) < n:
        cand = rng.integers(-(2**62), 2**62, 4096, dtype=np.int64)
        hi, lo = _halves(cand)
        base = hash_ref.probe_hash(hi, lo, np) & np.uint32(C - 1)
        out.extend(cand[base > C - P].tolist())
    return np.array(out[:n], np.int64)


def _batch(seed: int, case: str):
    """Sparse 64-bit keys from a pool (duplicate lanes), invalid lanes, and
    per case: the key -1 (== EMPTY), or chains that wrap at C."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(2**63), 2**63 - 1, 600, dtype=np.int64)
    if case == "wrap":
        # four a batch: keys whose chains run into one occupied cluster
        # all claim its first free slot, one winner a round, and the
        # reference settles four claim rounds (ROADMAP queue 3)
        pool[:4] = _wrapping_keys(rng, 4)
    keys = pool[rng.integers(0, len(pool), B)]
    keys[:32] = pool[:4].repeat(8)              # duplicate-heavy lanes
    if case == "key_minus_one":
        keys[rng.random(B) < 0.05] = -1
    valid = rng.random(B) < 0.9
    return keys, valid


def _ref_upsert(table_rows, keys, valid):
    hi, lo = _halves(keys)
    tab = ht_ref.SlotTable(jnp.asarray(table_rows), P)
    tab, slot, ok, n_new = ht_ref.upsert_counted(
        tab, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    return (np.asarray(tab.keys), np.asarray(slot), np.asarray(ok),
            int(n_new))


def _port_upsert(table_rows, keys, valid):
    hi, lo = _halves(keys)
    table = ht_port.from_rows(table_rows, device="cpu")
    slot, ok, n_new = ht_port.upsert_counted(
        table, _t(hi), _t(lo), torch.from_numpy(valid.copy()), probe_len=P)
    return table, slot.numpy(), ok.numpy(), int(n_new)


def _assert_table_invariants(table: torch.Tensor):
    """Each key once, within P of its chain start, found by lookup there."""
    w = table.numpy()
    used = w != kernels.EMPTY_WORD
    words = w[used]
    assert len(np.unique(words)) == len(words)
    hi, lo = kernels.split_words(torch.from_numpy(words))
    slot, found = ht_port.lookup(table, hi, lo, probe_len=P)
    assert found.all()
    np.testing.assert_array_equal(slot.numpy(), np.nonzero(used)[0])
    base = hash_port.probe_hash(hi, lo).numpy() & (C - 1)
    assert (((slot.numpy() - base) % C) < P).all()


def test_probe_hash_matches_reference():
    rng = np.random.default_rng(1)
    hi = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64)
                         .astype(np.uint32), EDGES, EDGES[::-1]])
    lo = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64)
                         .astype(np.uint32), EDGES, EDGES])
    want_np = hash_ref.probe_hash(hi, lo, np)
    want_jnp = np.asarray(hash_ref.probe_hash(jnp.asarray(hi),
                                              jnp.asarray(lo), jnp))
    got = hash_port.probe_hash(_t(hi), _t(lo)).numpy()
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF
    np.testing.assert_array_equal(got.astype(np.uint32), want_np)
    np.testing.assert_array_equal(got.astype(np.uint32), want_jnp)
    np.testing.assert_array_equal(hash_port.probe_hash(hi, lo), want_np)


@pytest.mark.parametrize("case", ["sparse", "key_minus_one", "wrap"])
def test_upsert_counted_matches_reference(case):
    empty = np.full((C, 2), ht_ref.EMPTY, np.uint32)
    tab_j, tab_t = empty, ht_port.from_rows(empty, device="cpu")
    for step in range(2):                     # an empty, then a used table
        keys, valid = _batch(10 * step + len(case), case)
        start = ht_port.to_rows(tab_t)
        tab_j, slot_j, ok_j, n_j = _ref_upsert(tab_j, keys, valid)
        tab_t, slot_t, ok_t, n_t = _port_upsert(start, keys, valid)
        np.testing.assert_array_equal(ok_t, ok_j)
        assert n_t == n_j
        assert n_t > 0 if step == 0 else True
        got = ht_port.to_rows(tab_t)
        assert sorted(map(tuple, got.tolist())) == \
            sorted(map(tuple, tab_j.tolist()))
        _assert_table_invariants(tab_t)
        hi, lo = _halves(keys)
        w = kernels.key_words(_t(hi), _t(lo)).numpy()
        np.testing.assert_array_equal(tab_t.numpy()[slot_t[ok_t]],
                                      w[ok_t])
        assert (slot_t[~ok_t] == C).all() and (slot_j[~ok_j] == C).all()
        tab_j = got            # carry the port's table on both sides
    if case == "key_minus_one":
        assert not ok_t[keys == -1].any()
    if case == "wrap":
        used = np.nonzero(tab_t.numpy() != kernels.EMPTY_WORD)[0]
        assert used.min() < P and used.max() > C - P


def test_lookup_matches_reference_on_a_carried_table():
    """A table the reference built, carried over, is probed identically:
    the same slot and found flag for resident, absent and -1 keys."""
    empty = np.full((C, 2), ht_ref.EMPTY, np.uint32)
    keys, valid = _batch(7, "wrap")
    tab_j, *_ = _ref_upsert(empty, keys, valid)
    probe = np.concatenate([keys, _batch(8, "sparse")[0][:256],
                            np.array([-1], np.int64)])
    hi, lo = _halves(probe)
    slot_j, found_j = ht_ref.lookup(ht_ref.SlotTable(jnp.asarray(tab_j), P),
                                    jnp.asarray(hi), jnp.asarray(lo))
    slot_t, found_t = ht_port.lookup(ht_port.from_rows(tab_j, device="cpu"),
                                     _t(hi), _t(lo), probe_len=P)
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    assert not found_t[-1]


def test_overloaded_table_fails_only_full_chains():
    """Past capacity a lane fails only when every slot of its chain holds
    another key (the kernel's CAS walk; the reference's four claim rounds
    may fail more), and no placed key is lost or duplicated."""
    c, p = 64, 4
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**62, 200, dtype=np.int64)
    hi, lo = _halves(keys)
    table = ht_port.create(c, device="cpu")
    slot, ok, n_new = ht_port.upsert_counted(
        table, _t(hi), _t(lo), torch.ones(200, dtype=torch.bool),
        probe_len=p)
    assert 0 < int(n_new) == int(ok.sum()) < 200
    w = table.numpy()
    assert (w != kernels.EMPTY_WORD).all()
    chains = kernels.probe_chain(_t(hi), _t(lo), C=c, probe_len=p).numpy()
    kw = kernels.key_words(_t(hi), _t(lo)).numpy()
    for i in np.nonzero(~ok.numpy())[0]:
        assert (w[chains[i]] != kw[i]).all()
    assert len(np.unique(w)) == c


def test_table_rows_round_trip_and_capacity_check():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 2**32, (C, 2), dtype=np.uint64).astype(np.uint32)
    rows[::3] = ht_ref.EMPTY
    np.testing.assert_array_equal(
        ht_port.to_rows(ht_port.from_rows(rows, device="cpu")), rows)
    with pytest.raises(ValueError, match="power of two"):
        ht_port.create(3000, device="cpu")
