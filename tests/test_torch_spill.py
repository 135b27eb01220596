"""The spill tier of flink_tpu_torch against flink_tpu and numpy, on the CPU.

Records whose key finds no state slot go to the device overflow ring
(kernel G7 ``ring_append``); the lookup-only fast update (G8
``hash_lookup``) sends absent keys there too; the host drains the ring into
per-pane ``SpillStore``s, compacts the hash table (G9 ``compact_table``)
and merges the stores into every window it emits. Inputs are made with
numpy from fixed seeds and fed to both packages; the port runs its
kernels' plain versions (``device="cpu"``), the reference its own CPU
path with the gated knobs forced on. Every value is an integer, so every
comparison is exact.

Which keys a hash table places when several race for one slot differs
between the packages (G5's CAS walk against the reference's claim rounds),
so a compaction's result is held to the logical state: the (key, pane,
value) cells on the card and in the ring, as a multiset, plus the table's
set invariants. End to end, sink rows must equal the reference's and
numpy's, whichever keys each package kept on the card.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    C, F, MAXP, R, SLIDE, assert_states_equal, jax_fields, key_halves,
    lanes_torch, set_watermark,
)

from flink_tpu.native import SpillStore as RefSpillStore
from flink_tpu.ops import hashtable as ht_ref
from flink_tpu.ops import window_kernels as wkj
from flink_tpu_torch.native import SpillStore
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops import hashtable as ht_port
from flink_tpu_torch.ops import window_kernels as wkt

B = 1024
O = 4096          # overflow ring lanes of the kernel-level tests


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch; uint32 halves travel as int32 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


# ------------------------------------------------------------ kernels

@pytest.mark.parametrize("case", ["room", "fills", "count", "fills_exactly",
                                  "none_masked", "one_lane"])
def test_ring_append_matches_reference(case):
    """G7's plain version: the masked lanes land in lane order from the
    ring's fill on; a ring that fills loses the rest and counts them. A
    ring that the batch fills to its last lane loses none; a batch with no
    lane masked, or one, moves the fill by that much."""
    rng = np.random.default_rng(11)
    size = 700 if case == "fills" else O
    n0 = 300 if case == "fills" else 100
    ring0 = (rng.integers(0, 2**32, size, dtype=np.uint32),
             rng.integers(0, 2**32, size, dtype=np.uint32),
             rng.integers(-50, 50, size).astype(np.int32),
             rng.integers(1, 9, size).astype(np.float32))
    hi = rng.integers(0, 2**32, B, dtype=np.uint32)
    lo = rng.integers(0, 2**32, B, dtype=np.uint32)
    pane = rng.integers(-3, 20, B).astype(np.int32)
    vals = rng.integers(1, 9, B).astype(np.float32)
    mask = rng.random(B) < 0.6
    if case == "fills_exactly":
        n0 = size - int(mask.sum())
    elif case == "none_masked":
        mask[:] = False
    elif case == "one_lane":
        mask[:] = False
        mask[-1] = True
    contrib = np.ones_like(vals) if case == "count" else vals
    (jh, jl, jp, jv, jn), j_lost = wkj.ring_append(
        tuple(jnp.asarray(a) for a in ring0) + (jnp.int32(n0),),
        jnp.asarray(mask), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(pane), jnp.asarray(contrib), size)
    ring = tuple(_t(a) for a in ring0) + (torch.tensor(n0, dtype=torch.int32),)
    lost = torch.zeros((), dtype=torch.int32)
    kernels.ring_append(ring, lost, _t(mask), _t(hi), _t(lo), _t(pane),
                        None if case == "count" else _t(vals))
    for got, want in zip(ring[:2], (jh, jl)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
    np.testing.assert_array_equal(ring[2].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ring[3].numpy(), np.asarray(jv))
    assert int(ring[4]) == int(jn) and int(lost) == int(j_lost)
    assert (int(lost) > 0) == (case == "fills")


def test_lookup_counted_matches_reference():
    """G8's plain version on a table the reference built: slot and found
    equal the reference's ``lookup`` on the valid lanes; the key -1 and
    invalid lanes are never found; ``n_missing`` counts valid misses."""
    rng = np.random.default_rng(5)
    pool = rng.integers(-(2**63), 2**63 - 1, 3000, dtype=np.int64)
    table = ht_ref.create(C, 16)
    for i in range(0, 2000, 500):
        hi, lo = key_halves(pool[i:i + 500])
        table, _slot, _ok = ht_ref.upsert(table, jnp.asarray(hi),
                                          jnp.asarray(lo),
                                          jnp.ones(500, bool))
    keys = pool[rng.integers(0, 3000, B)]      # a third absent
    keys[:16] = -1
    hi, lo = key_halves(keys)
    valid = rng.random(B) < 0.9
    slot_j, found_j = ht_ref.lookup(table, jnp.asarray(hi), jnp.asarray(lo))
    tab = ht_port.from_rows(np.asarray(table.keys), device="cpu")
    slot, found, n_missing = ht_port.lookup_counted(
        tab, _t(hi), _t(lo), torch.from_numpy(valid), probe_len=16)
    want_found = np.asarray(found_j) & valid
    np.testing.assert_array_equal(found.numpy(), want_found)
    np.testing.assert_array_equal(
        slot.numpy(), np.where(want_found, np.asarray(slot_j), C))
    assert int(n_missing) == int((valid & ~want_found).sum()) > 0
    assert not found[:16].any()


def test_spill_store_matches_reference():
    """The copied store: the same puts, gets, deletes and dumps."""
    rng = np.random.default_rng(2)
    ref, port = RefSpillStore(width=1, initial_capacity=16), SpillStore(
        width=1, initial_capacity=16)
    keys = rng.integers(0, 2**63, 5000, dtype=np.int64).view(np.uint64)
    for store in (ref, port):
        store.put(keys, np.arange(5000, dtype=np.float32))
        store.put(keys[:100], np.full(100, -1.0, np.float32))
        assert store.delete(keys[4000:]) == 1000
    probe = np.concatenate([keys[::7], rng.integers(0, 2**63, 50).astype(
        np.uint64)])
    for a, b in zip(ref.get(probe), port.get(probe)):
        np.testing.assert_array_equal(a, b)
    (rk, rv), (pk, pv) = ref.dump(), port.dump()
    assert len(port) == len(ref) == 4000
    np.testing.assert_array_equal(np.sort(pk), np.sort(rk))
    np.testing.assert_array_equal(pv[np.argsort(pk)], rv[np.argsort(rk)])
    port.close()
    ref.close()


# ------------------------------------------------------------ update

def _specs(window: str, overflow: int = O):
    size = {"tumbling": SLIDE, "sliding": 2 * SLIDE}[window]
    return (wkj.WindowSpec(size, SLIDE, ring=R, fires_per_step=F,
                           overflow=overflow),
            wkj.ReduceSpec("sum", jnp.float32),
            wkt.WindowSpec(size, SLIDE, ring=R, fires_per_step=F,
                           overflow=overflow),
            wkt.ReduceSpec("sum"))


@functools.lru_cache(maxsize=None)
def _jax_update(window: str, layout: str, insert: bool):
    win, red, _, _ = _specs(window)

    def upd(st, hi, lo, ts, vals, valid):
        st, act, _ = wkj.update(st, win, red, hi, lo, ts, vals, valid,
                                insert=insert, direct=layout == "direct",
                                precombine=True)
        return st, act

    return jax.jit(upd)


def _lanes(rng, keys, panes):
    hi, lo = key_halves(keys)
    ts = (panes * SLIDE + rng.integers(0, SLIDE, len(keys))).astype(np.int32)
    vals = rng.integers(1, 9, len(keys)).astype(np.float32)
    valid = rng.random(len(keys)) < 0.95
    return hi, lo, ts, vals, valid


def _step_both(sj, st, window, layout, insert, lanes, wm):
    """One update on each package, then the watermark; returns the two
    activities."""
    win_j, red_j, win_t, red_t = _specs(window)
    sj, act_j = _jax_update(window, layout, insert)(sj, *lanes)
    st, act_t, _kgf = wkt.update(st, win_t, red_t, *lanes_torch(*lanes),
                           maxp=MAXP, insert=insert)
    sj = set_watermark(sj, st, wm)
    return sj, int(act_j), int(act_t)


@pytest.mark.parametrize("window", ["tumbling", "sliding"])
def test_fast_update_matches_reference_on_a_carried_table(window):
    """The reference's insert steps build a table; the port takes the
    state over, then both run lookup-only (fast) updates whose batches
    hold resident keys, new keys and the key -1. The tables are the same
    and the fast step changes none, so the slots, the planes, the ring's
    contents and fill, and the activity (missing lanes) are all equal."""
    win_j, red_j, win_t, red_t = _specs(window)
    rng = np.random.default_rng(9)
    pool = rng.integers(-(2**63), 2**63 - 1, 1500, dtype=np.int64)
    sj = wkj.init_state(C, 16, win_j, red_j, layout="hash",
                        n_key_groups=MAXP, packed=True)
    for i in range(2):
        lanes = _lanes(rng, pool[rng.integers(0, 1000, B)],
                       rng.integers(i, i + 2, B))
        sj, _ = _jax_update(window, "hash", True)(sj, *lanes)
        sj = dataclasses.replace(sj, watermark=jnp.int32(i * SLIDE))
    st = wkt.state_from_numpy(jax_fields(sj), 0, device="cpu", layout="hash",
                              probe_len=16)
    assert_states_equal(sj, st)
    total_missing = 0
    for i in range(2, 5):
        keys = pool[rng.integers(0, 1500, B)]
        keys[:8] = -1
        lanes = _lanes(rng, keys, rng.integers(i, i + 2, B))
        sj, act_j, act_t = _step_both(sj, st, window, "hash", False, lanes,
                                      i * SLIDE)
        assert act_t == act_j
        assert_states_equal(sj, st)
        total_missing += act_t
    assert total_missing > 0 and int(st.ovf_n) == total_missing


def _full_table(rng, cap):
    """A table with every slot taken by a distinct key, probed the whole
    table deep, so that every key placed is found and every new key
    fails: rows (uint32 [cap, 2]) and the keys."""
    keys = rng.integers(-(2**62), 2**62, cap, dtype=np.int64)
    hi, lo = key_halves(keys)
    return np.stack([hi, lo], axis=1), keys


@pytest.mark.parametrize("layout", ["direct", "hash"])
def test_update_sends_nofit_lanes_to_the_ring(layout):
    """Insert-step updates whose lanes find no slot: keys past capacity
    (or with a nonzero high word) in the direct layout; new keys against
    a full table in the hash layout (where the key -1 never fits either).
    Those lanes go to the ring in lane order, count, not value, for a
    count — exactly as in the reference; nothing counts as dropped."""
    rng = np.random.default_rng(4)
    cap = 256
    win_j, red_j, win_t, red_t = _specs("sliding")
    sj = wkj.init_state(cap, 16, win_j, red_j, layout=layout,
                        n_key_groups=MAXP, packed=True)
    if layout == "hash":
        rows, resident = _full_table(rng, cap)
        sj = dataclasses.replace(
            sj, table=ht_ref.SlotTable(jnp.asarray(rows), cap))
    st = wkt.state_from_numpy(jax_fields(sj), 0, device="cpu", layout=layout,
                              probe_len=cap)
    for i in range(3):
        if layout == "direct":
            keys = rng.integers(0, cap + 40, B)
            keys[rng.random(B) < 0.02] += 1 << 32
        else:
            keys = np.where(rng.random(B) < 0.5,
                            resident[rng.integers(0, cap, B)],
                            rng.integers(-(2**62), 2**62, B))
            keys[:4] = -1
        lanes = _lanes(rng, keys, rng.integers(i, i + 2, B))
        sj, _, _ = _step_both(sj, st, "sliding", layout, True, lanes,
                              i * SLIDE)
        assert_states_equal(sj, st)
    assert int(st.ovf_n) > 0 and int(st.dropped_capacity) == 0


# ------------------------------------------------------------ compaction

def _cells(fields: dict, cap: int) -> list:
    """The logical state as a sorted multiset of (key word, pane, value):
    every touched cell of the plane and every filled lane of the ring."""
    rows = fields["table.keys"].astype(np.uint64)
    words = (rows[:, 0] << np.uint64(32)) | rows[:, 1]
    planes = np.asarray(fields["acc"]).reshape(R, cap, 2)
    out = []
    for r, c in zip(*np.nonzero(planes[:, :, 1])):
        out.append((int(words[c]), int(fields["pane_ids"][r]),
                    float(planes[r, c, 0])))
    n = int(fields["ovf_n"])
    k = (fields["ovf_hi"][:n].astype(np.uint64) << np.uint64(32)) | \
        fields["ovf_lo"][:n].astype(np.uint64)
    out += [(int(a), int(b), float(v)) for a, b, v in zip(
        k, fields["ovf_pane"][:n], fields["ovf_val"][:n])]
    return sorted(out)


def test_compact_table_matches_reference_as_logical_state():
    """A 256-slot table probed 2 deep fills with keys (those that find no
    slot spill), then the windows of the two oldest panes fire and purge,
    leaving ~60 dead keys beside ~170 live ones. Compaction keeps
    exactly the keys with touched cells: the (key, pane, value) cells on
    the card plus those the ring took are the same multiset before and
    after, in both packages. The port's new table holds each placed key
    once, within its chain, where lookup finds it; the alive keys it could
    not place are exactly those whose cells went to the ring."""
    rng = np.random.default_rng(1)
    cap, probe = 256, 2
    win_j, red_j, win_t, red_t = _specs("tumbling", overflow=4096)
    sj = wkj.init_state(cap, probe, win_j, red_j, layout="hash",
                        n_key_groups=MAXP, packed=True)
    pool = rng.integers(-(2**63), 2**63 - 1, 600, dtype=np.int64)
    upd = jax.jit(lambda st, *a: wkj.update(st, win_j, red_j, *a,
                                            precombine=True)[0])
    for i, (k0, k1) in enumerate(((0, 30), (30, 60), (60, 600), (60, 600))):
        keys = pool[rng.integers(k0, k1, 256)]
        sj = upd(sj, *_lanes(rng, keys, np.full(256, i)))
        sj = dataclasses.replace(sj, watermark=jnp.int32(i * SLIDE))
    # fire and purge panes 0 and 1: their keys die
    sj = dataclasses.replace(sj, watermark=jnp.int32(2 * SLIDE - 1))
    sj, pend, _ = wkj.advance_and_fire_resident(sj, win_j, red_j,
                                                jnp.int32(2 * SLIDE - 1))
    sj = wkj.apply_pending_purge(sj, win_j, red_j, pend)
    before = jax_fields(sj)
    st = wkt.state_from_numpy(before, 0, device="cpu", layout="hash",
                              probe_len=probe)
    n0 = int(st.ovf_n)
    want = _cells(before, cap)
    sj2 = wkj.compact_table(sj, win_j, red_j)
    assert _cells(jax_fields(sj2), cap) == want
    wkt.compact_table(st, win_t, red_t)
    got = wkt.state_to_numpy(st)
    assert _cells(got, cap) == want
    assert int(st.dropped_capacity) == int(sj2.dropped_capacity) == 0
    # the port's table: placed keys once each, in their chains, found
    table = st.table_keys
    used = table != kernels.EMPTY_WORD
    words = table[used]
    assert torch.unique(words).numel() == words.numel()
    hi, lo = kernels.split_words(words)
    slot, found = ht_port.lookup(table, hi, lo, probe_len=probe)
    assert found.all()
    assert (slot.long() == torch.nonzero(used).reshape(-1)).all()
    # alive keys = placed keys + keys exported to the ring
    planes = before["acc"].reshape(R, cap, 2)
    rows = before["table.keys"].astype(np.uint64)
    old = (rows[:, 0] << np.uint64(32)) | rows[:, 1]
    alive = set(old[planes[:, :, 1].any(axis=0)].tolist())
    placed = set(words.numpy().view(np.uint64).tolist())
    n = int(st.ovf_n)
    exported = set(((got["ovf_hi"][n0:n].astype(np.uint64) << np.uint64(32))
                    | got["ovf_lo"][n0:n]).tolist())
    assert placed | exported == alive and not placed & exported
    assert len(alive) < len(old[old != np.uint64(2**64 - 1)])  # dead keys
    assert exported                    # a live key found no chain: kept


# ------------------------------------------------------------ end to end

def _env(pkg, config, capacity, batch):
    if pkg == "jax":
        from flink_tpu import StreamExecutionEnvironment
        from flink_tpu.core.config import Configuration
        from flink_tpu.core.time import TimeCharacteristic
        kw = {}
        # the reference's gated knobs as an accelerator sets them
        config = dict({"pipeline.update-precombine": "on",
                       "state.packed-planes": "on",
                       "pipeline.resident-loop": "on"}, **config)
    else:
        from flink_tpu_torch import StreamExecutionEnvironment
        from flink_tpu_torch.core.config import Configuration
        from flink_tpu_torch.core.time import TimeCharacteristic
        kw = {"device": "cpu"}
    env = StreamExecutionEnvironment(Configuration(config), **kw)
    env.set_parallelism(1)
    env.set_max_parallelism(8)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(capacity)
    env.batch_size = batch
    return env


def _sources(pkg):
    if pkg == "jax":
        from flink_tpu.runtime import sinks, sources
    else:
        from flink_tpu_torch.runtime import sinks, sources
    return sinks, sources


def _window_sum(pkg, gen, total, capacity, config, batch=128, sink="collect"):
    """source -> key_by -> 1 s tumbling sum -> a sink, as the reference's
    tests/test_spill_overflow.py builds it; returns (job, sink)."""
    sinks, sources = _sources(pkg)
    env = _env(pkg, dict({"keys.reverse-map": True}, **config), capacity,
               batch)
    out = sinks.CollectSink() if sink == "collect" else sinks.CountingSink()
    (env.add_source(sources.GeneratorSource(gen, total=total))
     .key_by(lambda c: c["key"]).time_window(1000)
     .sum(lambda c: c["value"]).add_sink(out))
    return env.execute("spill"), out


def _overflow_gen(n_keys, total):
    """The reference test's stream: key = offset mod n_keys, all events of
    one 1 s window first, then the next."""
    def gen(offset, n):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        ts = (idx * 2 * 1000) // total
        return {"key": idx % n_keys, "value": np.ones(n, np.float32)}, ts
    return gen


def _churn_gen(capacity, windows=4):
    """Each 1 s window a new population of exactly ``capacity`` keys (the
    reference's key-churn test)."""
    def gen(offset, n):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        w = idx // capacity
        keys = w * capacity + idx % capacity
        ts = w * 1000 + (idx % capacity) % 999
        return {"key": keys, "value": np.ones(n, np.float32)}, ts
    return gen, windows * capacity


def _numpy_rows(gen, total):
    cols, ts = gen(0, total)
    out = {}
    for k, e in zip(cols["key"].tolist(), ((ts // 1000 + 1) * 1000).tolist()):
        out[(k, e)] = out.get((k, e), 0.0) + 1.0
    return sorted((k, e, v) for (k, e), v in out.items())


SCENARIOS = {
    # name: (generator, total, capacity) — tests/test_spill_overflow.py
    "2x_capacity": (_overflow_gen(512, 2048), 2048, 256),
    "4x_capacity": (_overflow_gen(1024, 3072), 3072, 256),
    "key_churn": _churn_gen(256) + (256,),
}


@pytest.mark.parametrize("layout", ["auto", "hash"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_keys_past_capacity_stream_exactly(name, layout):
    """Keys at 2x and 4x the state capacity, and a population that churns
    every window, with the ring unset: the same rows as the reference and
    numpy, nothing dropped. ``auto`` resolves to the direct layout here
    (the first batch's keys fit), where keys >= capacity spill and nothing
    compacts; ``hash`` compacts the table when the ring shows pressure. A
    ring depth of 2 makes several drains, so the spill tier runs often."""
    gen, total, capacity = SCENARIOS[name]
    config = {"state.backend.layout": layout, "pipeline.ring-depth": 2}
    rows = {}
    for pkg in ("jax", "torch"):
        job, sink = _window_sum(pkg, gen, total, capacity, config)
        assert job.metrics.dropped_capacity == 0, pkg
        rows[pkg] = sorted((int(r.key), int(r.window_end_ms), float(r.value))
                           for r in sink.results)
    assert rows["torch"] == rows["jax"] == _numpy_rows(gen, total)
    m = job.metrics
    assert m.spilled_records > 0 and m.ring_drains > 1
    assert job.state.layout == ("direct" if layout == "auto" else "hash")
    assert (m.compactions > 1) == (layout == "hash")


def test_exhausted_ring_raises_over_capacity_on_both():
    """An explicit ring too small for the overflow between drains: records
    are lost, and both packages say so at the end."""
    gen = _overflow_gen(2048, 4096)
    for pkg in ("jax", "torch"):
        with pytest.raises(RuntimeError, match="state backend over capacity"):
            _window_sum(pkg, gen, 4096, 64,
                        {"state.backend.overflow-ring": 16}, batch=256)


@pytest.mark.parametrize("ring,reduced", [(None, False), (0, True)])
def test_counting_sink_fire_mode_follows_the_ring(monkeypatch, ring, reduced):
    """The reference's fire mode rule: a device-reduce sink gets drains
    reduced on the card (G4) only when the stage has no overflow ring
    (``overflow-ring: 0``); under the default ring the drains compact rows
    (G6) so that a spill merge has keys to work on. Keys past capacity
    make the default ring spill. Both modes give the reference's count and
    sum."""
    calls = {"fire_reduced": 0, "fire_compact": 0}
    for name in calls:
        plain = getattr(kernels, f"{name}_plain")

        def counted(*a, _plain=plain, _name=name, **kw):
            calls[_name] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(kernels, f"{name}_plain", counted)
    gen = _overflow_gen(300, 2048)
    config = {"pipeline.ring-depth": 2}
    if ring is not None:
        config["state.backend.overflow-ring"] = ring
    capacity = 512 if reduced else 256
    results = []
    for pkg in ("jax", "torch"):
        job, sink = _window_sum(pkg, gen, 2048, capacity, config,
                                sink="counting")
        results.append((sink.count, sink.value_sum))
    assert results[0] == results[1] == (600, 2048.0)
    if reduced:
        assert calls["fire_compact"] == 0 and calls["fire_reduced"] > 0
    else:
        assert calls["fire_compact"] > 0
        assert job.metrics.spilled_records > 0


# ----------------------------------------------- sparse ids, HOP windows

def _sparse_hop(pkg, gen, total, capacity, config, out_of_order_ms=None):
    """HOP(2 s, 10 s) count per 64-bit id into a columnar row sink (the
    generator's timestamps, or a ``ts`` column with a watermark that far
    behind the newest): returns (job, rows sorted)."""
    sinks, sources = _sources(pkg)
    env = _env(pkg, dict({"keys.reverse-map": False,
                          "window.fires-per-step": 2,
                          "pipeline.ring-depth": 4}, **config), capacity, 1024)

    class Rows(sinks.Sink):
        columnar = True

        def __init__(self):
            self.parts = []

        def invoke_columnar(self, cols):
            self.parts.append({k: np.asarray(v) for k, v in cols.items()})

    sink = Rows()
    stream = env.add_source(sources.GeneratorSource(gen, total=total))
    if out_of_order_ms is not None:
        from flink_tpu_torch.runtime.watermarks import WatermarkStrategy
        stream = stream.assign_timestamps_and_watermarks(
            lambda c: c["ts"],
            WatermarkStrategy.for_bounded_out_of_orderness(out_of_order_ms))
    (stream.key_by(lambda c: c["id"]).time_window(10_000, 2_000).count()
     .add_sink(sink))
    job = env.execute("hop")
    cols = {k: np.concatenate([p[k] for p in sink.parts])
            for k in sink.parts[0]}
    return job, sorted(zip(cols["key_id"].astype(np.uint64).tolist(),
                           cols["window_end_ms"].tolist(),
                           cols["value"].tolist()))


def _hop_numpy(gen, total, batch=1024):
    out = {}
    for off in range(0, total, batch):
        cols, ts = gen(off, min(batch, total - off))
        ids = cols["id"].view(np.uint64).tolist()
        for j in range(5):
            for pair in zip(ids, ((ts // 2000 + 1 + j) * 2000).tolist()):
                out[pair] = out.get(pair, 0.0) + 1.0
    return sorted((k, e, v) for (k, e), v in out.items())


def _id_gen(ids_per_ms: float, live: int, events_per_ms: int = 2):
    """Bids on recent auctions: at event time t ms the id is
    splitmix64(floor(t * ids_per_ms) + u), u uniform in [0, live), u drawn
    from a generator seeded by the batch's offset."""
    from flink_tpu_torch.ops.hashing import splitmix64

    def gen(offset, n):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        t = idx // events_per_ms
        u = np.random.default_rng(offset).integers(0, live, n)
        base = (t * int(ids_per_ms * 1000)) // 1000
        return {"id": splitmix64(base + u).view(np.int64)}, t
    return gen


def test_churning_ids_in_sliding_windows_match_numpy():
    """The card's churn job at a small size: ids that churn (200 new ones
    a second over a window of 500 recent ones, 6,400 distinct over 30 s
    against 4,096 slots), HOP(2 s, 10 s) counts, the ring unset. The table
    fills with dead ids and compacts at every drain that spilled; ids past
    the 16-slot chains stay in the stores. Every (id, window, count) row
    equals numpy's. (The reference merges the cells that a compaction
    moves to the ring into the windows the same drain already fired, and
    double-counts them here: ROADMAP queue 3.)"""
    gen, total = _id_gen(0.2, 500), 60_000
    job, rows = _sparse_hop("torch", gen, total, 4096, {})
    assert rows == _hop_numpy(gen, total)
    m = job.metrics
    assert m.compactions >= 2 and m.spilled_records > 0
    assert m.dropped_capacity == 0 and job.state.layout == "hash"


def test_fast_step_tiers_with_the_key_population():
    """A fixed population of ids: after two drains that place no key the
    executor runs the lookup-only fast step (G8). Then 2,000 new ids
    arrive: the fast step's misses go to the ring and send it back to the
    insert step, which places them. Rows equal the reference's and
    numpy's."""
    fixed = _id_gen(0.0, 1500)

    def gen(offset, n):
        cols, t = fixed(offset, n)
        late = offset >= 40_000
        if late:
            cols["id"] = cols["id"] ^ np.int64(0x5555)   # new ids
        return cols, t

    total = 60_000
    rows = {}
    for pkg in ("jax", "torch"):
        job, rows[pkg] = _sparse_hop(pkg, gen, total, 8192, {})
    assert rows["torch"] == rows["jax"] == _hop_numpy(gen, total)
    m = job.metrics
    assert 0 < m.steps_fast < m.steps
    assert m.spilled_records > 0 and m.dropped_capacity == 0


def test_spill_tier_is_invisible_to_out_of_order_records():
    """Bids up to 1.5 s out of order (1 % up to 12 s) under a watermark
    1 s behind the newest, in HOP(2 s, 10 s) windows: some records are
    late and drop, others reach a pane after a window that holds it has
    fired and count only for the later windows. Run with a table too small for the ids
    (spilling and compacting) and with room for all of them (nothing
    spills, no ring), the job gives the same rows and the same late drops:
    each slot's ring lanes reach the stores before that slot's fires, and
    none that came after them."""
    base = _id_gen(0.2, 500)

    def gen(offset, n):
        cols, t = base(offset, n)
        rng = np.random.default_rng(offset + 7)
        lag = np.where(rng.random(n) < 0.01, rng.integers(0, 12_000, n),
                       rng.integers(0, 1500, n))
        cols["ts"] = np.maximum(t - lag, 0)
        return cols, None

    total = 60_000
    job_s, rows_s = _sparse_hop("torch", gen, total, 1024, {},
                                out_of_order_ms=1000)
    job_r, rows_r = _sparse_hop("torch", gen, total, 1 << 16,
                                {"state.backend.overflow-ring": 0},
                                out_of_order_ms=1000)
    assert rows_s == rows_r
    assert job_s.metrics.dropped_late == job_r.metrics.dropped_late > 0
    assert job_s.metrics.compactions >= 2 and job_s.metrics.spilled_records
    assert job_r.metrics.spilled_records == 0
    assert job_s.metrics.dropped_capacity == job_r.metrics.dropped_capacity == 0


def _post_fire_gen(offset, n):
    """Keys 0..599 against 512 slots of the direct layout (keys past the
    capacity always spill), 2 events a ms, 20 % of the records up to 1.5 s
    out of order under a 1 s watermark bound: a record may reach a pane
    after a HOP window holding it fired, while the pane is still open to
    the later windows."""
    idx = np.arange(offset, offset + n, dtype=np.int64)
    rng = np.random.default_rng(offset + 7)
    lag = np.where(rng.random(n) < 0.2, rng.integers(0, 1500, n), 0)
    return {"id": (idx * 2862933555777941757) % 600,
            "ts": np.maximum(idx // 2 - lag, 0)}, None


def _post_fire_numpy(total, batch=1024, ooo=1000, slide=2000, k=5):
    """numpy's rows: a record counts in the windows that had not fired
    when its batch arrived (each batch's fire runs after its update; the
    watermark before it is the earlier batches' newest time - ooo - 1)."""
    out, newest = {}, None
    for off in range(0, total, batch):
        cols, _ = _post_fire_gen(off, min(batch, total - off))
        ts, ids = cols["ts"], cols["id"]
        fired = (-(2**62) if newest is None
                 else (newest - ooo - 1 + 1 - slide) // slide)
        for j in range(k):
            e = ts // slide + j
            sel = e > fired
            ends = ((e[sel] + 1) * slide).tolist()
            for pair in zip(ids[sel].tolist(), ends):
                out[pair] = out.get(pair, 0.0) + 1.0
        newest = int(ts.max()) if newest is None else max(newest,
                                                          int(ts.max()))
    return sorted((key, e, v) for (key, e), v in out.items())


def test_reference_merges_post_fire_ring_lanes_into_fired_windows():
    """The queued reference-fault check (ROADMAP queue 3). HOP(2 s, 10 s)
    counts in the direct layout, where keys past the capacity spill and
    nothing compacts (so the reference's compaction double count cannot
    enter), records out of order into panes still open to later windows,
    and ring drains between fires (ring depth 4, drains of several slots).
    The port's rows equal numpy's: a slot's ring lanes reach the stores
    before that slot's fires, and none that came after them. The
    reference's rows for the spilled keys come out larger: it drains the
    ring of the whole drain before emitting the drain's fires, so a record
    that reached the card after a window fired is merged into that window.
    Only spilled keys differ, and only upward."""
    total = 40_000
    want = _post_fire_numpy(total)
    cfg = {"state.backend.layout": "direct"}
    job, got = _sparse_hop("torch", _post_fire_gen, total, 512, cfg,
                           out_of_order_ms=1000)
    assert got == want
    assert job.metrics.spilled_records > 0 and job.metrics.dropped_late == 0
    _, ref = _sparse_hop("jax", _post_fire_gen, total, 512, cfg,
                         out_of_order_ms=1000)
    assert [r[:2] for r in ref] == [r[:2] for r in want]
    extra = [(k, e, r - w) for (k, e, r), (_, _, w) in zip(ref, want)
             if r != w]
    assert extra, "the reference no longer merges post-fire ring lanes"
    assert all(key >= 512 and d > 0 for key, _e, d in extra)
