"""The hash table's probe walks and its compaction at their edge shapes:
the port's plain ``upsert_counted`` / ``lookup_counted`` (G5 and G8 on the
card) and ``window_kernels.compact_table`` (G9) against flink_tpu on the
CPU.

The tables are built by hand: keys 0, 15, 16, 17, 31, 32, 33 and 63 deep
in their chains at every sector phase of the chain's start, behind other
keys, each chain's second key absent (at depth 63 with P = 64 a full chain,
where an insert fails), chains that wrap at C at each of 16 phases, P = 1,
2, 16 and 64, duplicate lanes, the key -1 and invalid lanes; and the same
after the reference's ``remove_slots`` cleared a slot in front of each deep
key, which every walk must see past (a key is absent only when its whole
chain lacks it). Every insert here has one claimer a free slot, so ``ok``,
``n_new``, the slots and the table rows equal the reference's exactly.

Compaction is held to the logical state, the (key, pane, values) cells of
the plane and the ring as a multiset, since the two packages may place
contested keys apart: a table probed 64 deep at a load near 0.9 with 30 %
of its keys dead (sum, min, max and mean planes), every key dead, and keys
that fail a rebuild probed 2 deep, into a ring with room and into a ring
that fills (there each package must conserve its cells: those kept plus
those counted lost).
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import MAXP, SLIDE, jax_fields, key_halves

from flink_tpu.ops import hashing as hash_ref
from flink_tpu.ops import hashtable as ht_ref
from flink_tpu.ops import window_kernels as wkj
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import hashtable as ht_port
from flink_tpu_torch.ops import window_kernels as wkt

C = 4096
DEPTHS = (0, 15, 16, 17, 31, 32, 33, 63)
# 32 chains 128 slots apart: every depth at every phase of a 4-word sector,
# and the starts at 16 phases of a 16-word line
REGIONS = [(128 * k + (5 * k) % 16, DEPTHS[k // 4]) for k in range(32)]


def _bits(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _starts(ids: np.ndarray) -> np.ndarray:
    hi, lo = key_halves(ids)
    return hash_ref.probe_hash(hi, lo, np) & np.uint32(C - 1)


def _ids_at(bases, seed):
    """Two distinct ids whose chains start at each of ``bases``."""
    rng = np.random.default_rng(seed)
    out = {int(b): [] for b in bases}
    while any(len(v) < 2 for v in out.values()):
        ids = rng.integers(-(2**62), 2**62, 1 << 18, dtype=np.int64)
        starts = _starts(ids)
        for b, v in out.items():
            if len(v) < 2:
                v.extend(ids[starts == b][:2 - len(v)].tolist())
    return out


def _chains(regions, seed):
    """Rows [C, 2] holding, for each (start, depth), a key of that start
    ``depth`` deep behind filler keys; the present and the absent keys."""
    rng = np.random.default_rng(seed)
    found = _ids_at([b for b, _ in regions], seed)
    words = np.full(C, -1, np.int64)
    fillers = rng.integers(1, 2**62, C, dtype=np.int64)
    for b, d in regions:
        for j in range(d):
            words[(b + j) % C] = fillers[(b + j) % C]
        words[(b + d) % C] = found[b][0]
    hi, lo = key_halves(words)
    rows = np.stack([hi, lo], 1)
    return (rows, np.array([found[b][0] for b, _ in regions]),
            np.array([found[b][1] for b, _ in regions]))


def _lanes(present, absent, seed):
    """Present keys, absent keys twice, the key -1, 8 % invalid."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([present, absent, absent, np.full(5, -1, np.int64)])
    ids = ids[rng.permutation(len(ids))]
    return ids, rng.random(len(ids)) >= 0.08


def _holes(rows, regions):
    """The reference's remove_slots on a slot in front of each key 15 or
    more deep, halfway down its chain."""
    slots = np.array([(b + d // 2) % C for b, d in regions if d >= 15],
                     np.int32)
    tab = ht_ref.remove_slots(ht_ref.SlotTable(jnp.asarray(rows), 64),
                              jnp.asarray(slots),
                              jnp.ones(len(slots), bool))
    return np.asarray(tab.keys)


def _lookup_both(rows, ids, valid, P):
    hi, lo = key_halves(ids)
    slot_r, found_r = ht_ref.lookup(ht_ref.SlotTable(jnp.asarray(rows), P),
                                    jnp.asarray(hi), jnp.asarray(lo))
    slot_p, found_p, n_missing = ht_port.lookup_counted(
        ht_port.from_rows(rows, device="cpu"), _bits(hi), _bits(lo),
        torch.from_numpy(valid.copy()), probe_len=P)
    return (np.asarray(slot_r), np.asarray(found_r), slot_p.numpy(),
            found_p.numpy(), int(n_missing))


def _upsert_both(rows, ids, valid, P):
    hi, lo = key_halves(ids)
    tab_r, slot_r, ok_r, n_r = ht_ref.upsert_counted(
        ht_ref.SlotTable(jnp.asarray(rows), P), jnp.asarray(hi),
        jnp.asarray(lo), jnp.asarray(valid))
    table = ht_port.from_rows(rows, device="cpu")
    slot_p, ok_p, n_p = ht_port.upsert_counted(
        table, _bits(hi), _bits(lo), torch.from_numpy(valid.copy()),
        probe_len=P)
    return ((np.asarray(tab_r.keys), np.asarray(slot_r), np.asarray(ok_r),
             int(n_r)),
            (ht_port.to_rows(table), slot_p.numpy(), ok_p.numpy(), int(n_p)))


def _assert_upserts_equal(ref, port):
    (rows_r, slot_r, ok_r, n_r), (rows_p, slot_p, ok_p, n_p) = ref, port
    np.testing.assert_array_equal(ok_p, ok_r)
    assert n_p == n_r
    np.testing.assert_array_equal(slot_p, slot_r)
    np.testing.assert_array_equal(rows_p, rows_r)


@pytest.mark.parametrize("P", [1, 2, 16, 64])
@pytest.mark.parametrize("holes", [False, True], ids=["chains", "holes"])
def test_lookup_matches_reference_at_depths(P, holes):
    """The slot and found flag of keys 0-63 deep, of absent keys whose
    chains run full or end in free slots, of the key -1; behind a cleared
    slot (``holes``) the deep keys are still found within P."""
    rows, present, absent = _chains(REGIONS, 1)
    if holes:
        rows = _holes(rows, REGIONS)
    ids, valid = _lanes(present, absent, 2)
    slot_r, found_r, slot_p, found_p, n_missing = _lookup_both(rows, ids,
                                                               valid, P)
    np.testing.assert_array_equal(found_p[valid], found_r[valid])
    np.testing.assert_array_equal(slot_p[valid],
                                  slot_r[valid].astype(np.int32))
    assert not found_p[~valid].any() and (slot_p[~valid] == C).all()
    assert n_missing == int((valid & ~found_p).sum())
    depth = dict(zip(present.tolist(), [d for _, d in REGIONS]))
    want = np.array([depth.get(i, P) < P for i in ids.tolist()])
    np.testing.assert_array_equal(found_p, want & valid)
    assert not found_p[ids == -1].any()


@pytest.mark.parametrize("P", [1, 2, 16, 64])
def test_upsert_matches_reference_at_depths(P):
    """Present keys are found where they sit (however deep within P),
    absent keys take the first free slot of their chain or fail when the
    chain is full (depth 63 at P = 64, any deep chain at P <= 16),
    duplicates share their slot, the key -1 is never placed."""
    rows, present, absent = _chains(REGIONS, 3)
    ids, valid = _lanes(present, absent, 4)
    ref, port = _upsert_both(rows, ids, valid, P)
    _assert_upserts_equal(ref, port)
    _rows, _slot, ok, n_new = port
    assert not ok[ids == -1].any()
    if P == 64:
        full = absent[[d == 63 for _, d in REGIONS]]
        assert not ok[np.isin(ids, full)].any()
        assert ok[valid & np.isin(ids, absent) & ~np.isin(ids, full)].all()
        assert n_new == int((valid & np.isin(ids, absent)
                             & ~np.isin(ids, full)).sum())


@pytest.mark.parametrize("P", [16, 64])
def test_upsert_after_remove_slots_finds_keys_behind_holes(P):
    """After the reference's remove_slots cleared a slot halfway down each
    deep chain: a key behind the hole within P is found at its slot and
    not placed again; the chain's absent key takes the hole. Tables, slots,
    ok and n_new equal the reference's."""
    rows, present, absent = _chains(REGIONS, 5)
    rows = _holes(rows, REGIONS)
    deep = [d for _, d in REGIONS]
    keep = [d < 16 or d < P for d in deep] if P == 16 else [True] * 32
    ids, valid = _lanes(present, absent[keep], 6)
    ref, port = _upsert_both(rows, ids, valid, P)
    _assert_upserts_equal(ref, port)
    rows_p, _slot, ok, _ = port
    behind = present[[15 <= d < P for d in deep]]
    lanes = valid & np.isin(ids, behind)
    assert lanes.any() and ok[lanes].all()
    words = ht_port.from_rows(rows_p, device="cpu").numpy()
    for key in behind.tolist():
        assert int((words == key).sum()) == 1
    holes = [(b + d // 2) % C for b, d in REGIONS if d >= 15]
    taken = absent[[d >= 15 for d in deep]] if P == 64 else []
    for key, hole in zip(list(taken), holes):
        assert words[hole] == key


@pytest.mark.parametrize("P", [16, 64])
def test_wrapping_chains_match_reference(P):
    """A chain that starts at each of the last 16 slots (every phase of a
    line) and runs past C with its key 20 deep: lookups and inserts equal
    the reference's."""
    for p in range(16):
        rows, present, absent = _chains([(C - 1 - p, 20)], 20 + p)
        ids, valid = _lanes(present, absent, 40 + p)
        slot_r, found_r, slot_p, found_p, _ = _lookup_both(rows, ids, valid,
                                                           P)
        np.testing.assert_array_equal(found_p[valid], found_r[valid])
        np.testing.assert_array_equal(slot_p[valid],
                                      slot_r[valid].astype(np.int32))
        assert found_r[ids == present[0]].all() == (P > 20)
        _assert_upserts_equal(*_upsert_both(rows, ids, valid, P))


# ------------------------------------------------------------ compaction

R = 6
NEUTRAL = {"sum": 0.0, "max": -np.finfo(np.float32).max,
           "min": np.finfo(np.float32).max, "mean": 0.0}


def _compact_state(kind, probe, alive_share, fill, O, seed):
    """Both packages' states over one table: 3,700 sparse ids placed 64
    deep (a load of 0.9), ``alive_share`` of them with touched cells in
    some of R panes, the ring of O lanes holding ``fill``; the table's
    chains ``probe`` long for the rebuild."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-(2**62), 2**62, 3700, dtype=np.int64)
    table = ht_port.create(C, device="cpu")
    hi, lo = key_halves(ids)
    ht_port.upsert_counted(table, _bits(hi), _bits(lo),
                           torch.ones(len(ids), dtype=torch.bool),
                           probe_len=64)
    used = table.numpy() != kernels.EMPTY_WORD
    alive = used & (rng.random(C) < alive_share)
    touch = (rng.random((R, C)) < 0.4) & alive[None, :]
    touch[rng.integers(0, R, C), np.arange(C)] |= alive
    W = 2 if kind == "mean" else 1
    neutral = np.float32(NEUTRAL[kind])
    acc = np.full((R, C, W + 1), neutral, np.float32)
    vals = rng.integers(-9, 9, (R, C, W)).astype(np.float32)
    acc[touch, :W] = vals[touch]
    acc[touch, W] = 1.0 if neutral == 0 else 0.0
    red_j = (wkj.ReduceSpec("sum", jnp.float32, value_shape=(2,))
             if kind == "mean" else wkj.ReduceSpec(kind, jnp.float32))
    red_t = (wkt.ReduceSpec("sum", value_shape=(2,)) if kind == "mean"
             else wkt.ReduceSpec(kind))
    win_j = wkj.WindowSpec(SLIDE, SLIDE, ring=R, fires_per_step=2,
                           overflow=O)
    win_t = wkt.WindowSpec(SLIDE, SLIDE, ring=R, fires_per_step=2,
                           overflow=O)
    sj = wkj.init_state(C, probe, win_j, red_j, layout="hash",
                        n_key_groups=MAXP, packed=True)
    ring_keys = rng.integers(-(2**62), 2**62, O, dtype=np.int64)
    r_hi, r_lo = key_halves(ring_keys)
    ovf_val = rng.integers(1, 9, (O, W)).astype(np.float32)
    sj = dataclasses.replace(
        sj, table=ht_ref.SlotTable(jnp.asarray(ht_port.to_rows(table)),
                                   probe),
        acc=jnp.asarray(acc.reshape(R * C, W + 1)),
        pane_ids=jnp.arange(40, 40 + R, dtype=jnp.int32),
        ovf_hi=jnp.asarray(r_hi), ovf_lo=jnp.asarray(r_lo),
        ovf_pane=jnp.asarray(rng.integers(0, 20, O).astype(np.int32)),
        ovf_val=jnp.asarray(ovf_val if W > 1 else ovf_val[:, 0]),
        ovf_n=jnp.int32(fill))
    fields = {k: np.array(v) for k, v in jax_fields(sj).items()}
    st = wkt.state_from_numpy(fields, 0, device="cpu", layout="hash",
                              probe_len=probe, red=red_t)
    return sj, st, (win_j, red_j, win_t, red_t), W, neutral


def _cells(fields, W, neutral):
    """The plane's touched cells and the ring's filled lanes as a sorted
    multiset of (key word, pane, values)."""
    rows = fields["table.keys"].astype(np.uint64)
    words = (rows[:, 0] << np.uint64(32)) | rows[:, 1]
    planes = np.asarray(fields["acc"]).reshape(R, C, W + 1)
    out = []
    for r, c in zip(*np.nonzero(planes[:, :, W] != neutral)):
        out.append((int(words[c]), int(fields["pane_ids"][r]),
                    tuple(planes[r, c, :W].tolist())))
    n = int(fields["ovf_n"])
    k = (fields["ovf_hi"][:n].astype(np.uint64) << np.uint64(32)) | \
        fields["ovf_lo"][:n].astype(np.uint64)
    vals = np.asarray(fields["ovf_val"][:n]).reshape(n, W)
    out += [(int(a), int(b), tuple(v.tolist()))
            for a, b, v in zip(k, fields["ovf_pane"][:n], vals)]
    return sorted(out)


def _assert_port_table(st, probe):
    """The port's new table: each placed key once, within its chain, where
    lookup finds it."""
    table = st.table_keys
    used = table != kernels.EMPTY_WORD
    words = table[used]
    assert torch.unique(words).numel() == words.numel()
    hi, lo = kernels.split_words(words)
    slot, found = ht_port.lookup(table, hi, lo, probe_len=probe)
    assert found.all()
    assert (slot.long() == torch.nonzero(used).reshape(-1)).all()


@pytest.mark.parametrize("case", [
    "sum", "max", "min", "mean", "all_dead", "fail_room", "fail_full"])
def test_compact_table_matches_reference_as_logical_state(case):
    """Compaction keeps exactly the cells of keys with touched panes: the
    (key, pane, values) cells on the card and in the ring are the same
    multiset before and after, in both packages (``fail_full``: a ring
    with room for 40 more lanes; each package keeps its cells but those it
    counts lost)."""
    kind = case if case in NEUTRAL else "sum"
    probe = 2 if case.startswith("fail") else 64
    share = 0.0 if case == "all_dead" else 0.7
    O, fill = (4096, 4056) if case == "fail_full" else (1 << 14, 100)
    sj, st, (win_j, red_j, win_t, red_t), W, neutral = _compact_state(
        kind, probe, share, fill, O, 7 + len(case))
    before = _cells(jax_fields(sj), W, neutral)
    sj2 = wkj.compact_table(sj, win_j, red_j)
    wkt.compact_table(st, win_t, red_t)
    after_j = _cells(jax_fields(sj2), W, neutral)
    after_p = _cells(wkt.state_to_numpy(st), W, neutral)
    lost_j, lost_p = int(sj2.dropped_capacity), int(st.dropped_capacity)
    _assert_port_table(st, probe)
    if case == "fail_full":
        assert lost_p > 0 and lost_j > 0
        assert int(st.ovf_n) == int(sj2.ovf_n) == O
        for got, lost in ((after_j, lost_j), (after_p, lost_p)):
            assert len(got) + lost == len(before)
            kept = {}
            for cell in before:
                kept[cell] = kept.get(cell, 0) + 1
            for cell in got:
                kept[cell] -= 1
            assert min(kept.values()) >= 0
        return
    assert lost_j == lost_p == 0
    assert after_p == before and after_j == before
    if case == "all_dead":
        assert not (st.table_keys != kernels.EMPTY_WORD).any()
        assert int(st.ovf_n) == fill
    if case == "fail_room":
        assert int(st.ovf_n) > fill
