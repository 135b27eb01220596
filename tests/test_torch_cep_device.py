"""The count NFA of device CEP (kernel K20): flink_tpu_torch's
``cep/device.py advance`` (G20, G5, G10 and G19 through their plain
versions on the CPU) and its ``advance_plain`` (the reference's own
structure: [B, D, D] matrices, a log-step segmented product) against
flink_tpu's ``cep/device.py advance`` on the same seeded batches.

Every case of ``tests/test_cep_device.py`` runs on both packages, then a
hypothesis fuzz over up to four stages, within() on and off, many keys,
one hot key and one segment. Deltas compare bit for bit, lane by lane,
and the carry row by row per key (a key may sit in another slot in each
package), as long as every count stays below 2^24 — where float32 is
exact in both packages; the cases here stay far below it."""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import functools
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from flink_tpu.cep import NFA as NFAJ
from flink_tpu.cep import Pattern as PJ
from flink_tpu.cep import device as dj
from flink_tpu_torch.cep import Pattern as PT
from flink_tpu_torch.cep import device as dt
from flink_tpu_torch.ops import hashtable
from flink_tpu_torch.ops import cuda as kernels

Event = namedtuple("Event", ["ts", "name", "value"])


def halves(keys):
    keys = np.asarray(keys, np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32) | np.uint32(0x80000000)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def carry_by_key_ref(state):
    rows = np.asarray(state.table.keys)
    carry = np.asarray(state.carry)
    used = ~np.all(rows == hashtable.EMPTY, axis=1)
    k = (rows[:, 0].astype(np.uint64) << np.uint64(32)) | rows[:, 1]
    return {int(w): carry[s].tolist() for s, w in zip(np.nonzero(used)[0],
                                                      k[used])}


def carry_by_key_port(state):
    rows = hashtable.to_rows(state.table)
    carry = state.carry.numpy()
    used = ~np.all(rows == hashtable.EMPTY, axis=1)
    k = (rows[:, 0].astype(np.uint64) << np.uint64(32)) | rows[:, 1]
    return {int(w): carry[s].tolist() for s, w in zip(np.nonzero(used)[0],
                                                      k[used])}


LANES = 64     # every batch is padded to this many lanes (invalid ones)


@functools.lru_cache(maxsize=None)
def ref_advance(spec):
    return jax.jit(functools.partial(dj.advance, spec=spec))


def padded(keys, masks, valid):
    """A batch padded with invalid lanes to LANES (one compiled shape for
    the reference; the padding is the identity in both packages)."""
    n = len(keys)
    assert n <= LANES
    keys = np.r_[np.asarray(keys, np.uint64), np.zeros(LANES - n, np.uint64)]
    masks = np.r_[np.asarray(masks, bool),
                  np.zeros((LANES - n, masks.shape[1]), bool)]
    valid = np.r_[np.asarray(valid, bool), np.zeros(LANES - n, bool)]
    return keys, masks, valid


def run_both(make, batches, capacity=64, buckets=8):
    """``make(Pattern)`` builds the pattern in either package; ``batches``
    is a list of (keys, masks bool [B, S], valid bool [B], pane). Feeds
    each batch, padded to LANES, to the reference's advance, the port's
    advance and its advance_plain; asserts equal deltas after each batch
    and equal carry (by key), pane ids and losses at the end. Returns the
    deltas of the batches' own lanes."""
    spec_j = dj.DevicePatternSpec.from_pattern(make(PJ),
                                               within_buckets=buckets)
    spec_t = dt.DevicePatternSpec.from_pattern(make(PT),
                                               within_buckets=buckets)
    assert (spec_t.n_stages, spec_t.relaxed, spec_t.within_panes,
            spec_t.pane_ms) == (spec_j.n_stages, spec_j.relaxed,
                                spec_j.within_panes, spec_j.pane_ms)
    assert spec_t.dim == spec_j.dim
    sj = dj.init_state(capacity, 8, spec_j)
    st_k = dt.init_state(capacity, 8, spec_t, device="cpu")
    st_p = dt.init_state(capacity, 8, spec_t, device="cpu")
    out = []
    for keys, masks, valid, pane in batches:
        n = len(keys)
        keys, masks, valid = padded(keys, masks, valid)
        hi, lo = halves(keys)
        sj, d_j, tot_j = ref_advance(spec_j)(
            sj, hi=jnp.asarray(hi), lo=jnp.asarray(lo),
            masks=jnp.asarray(masks), valid=jnp.asarray(valid),
            pane=np.int32(pane))
        lanes = (torch.from_numpy(hi.view(np.int32).copy()),
                 torch.from_numpy(lo.view(np.int32).copy()),
                 torch.from_numpy(np.asarray(masks, bool).copy()),
                 torch.from_numpy(np.asarray(valid, bool).copy()))
        st_k, d_k, tot_k = dt.advance(st_k, spec_t, *lanes, pane)
        st_p, d_p, _ = dt.advance_plain(st_p, spec_t, *lanes, pane)
        d_j = np.asarray(d_j)
        np.testing.assert_array_equal(d_k.numpy(), d_j)
        np.testing.assert_array_equal(d_p.numpy(), d_j)
        assert float(tot_k) == float(tot_j)
        assert not d_j[n:].any()
        out.extend(d_j[:n].astype(int).tolist())
    want = carry_by_key_ref(sj)
    assert carry_by_key_port(st_k) == want
    assert carry_by_key_port(st_p) == want
    np.testing.assert_array_equal(np.asarray(st_k.carry[-1]),
                                  np.asarray(sj.carry)[-1])
    np.testing.assert_array_equal(st_k.pane_ids.numpy(),
                                  np.asarray(sj.pane_ids))
    assert int(st_k.dropped_capacity) == int(sj.dropped_capacity) == 0
    return out


def event_batches(make, key_events, spans=None):
    """(key, event) pairs -> run_both batches (pane 0)."""
    p = make(PJ)
    keys = [k for k, _ in key_events]
    masks = dj.host_masks(p, [e for _, e in key_events])
    out = []
    for a, b in spans or [(0, len(keys))]:
        out.append((keys[a:b], masks[a:b], np.ones(b - a, bool), 0))
    return out


def host_deltas(make, events, pane_ms=0):
    nfa = NFAJ(make(PJ))
    partials, out = nfa.initial_state(), []
    for e in events:
        ts = (e.ts // pane_ms) * pane_ms if pane_ms else e.ts
        partials, ms = nfa.process(partials, e, ts)
        out.append(len(ms))
    return out


def _ab(P, strict=False):
    p = P.begin("a").where(lambda e: e.name == "a")
    p = p.next("b") if strict else p.followed_by("b")
    return p.where(lambda e: e.name == "b")


def test_strict_contiguity():
    events = [Event(0, "a", 1), Event(1, "b", 2), Event(2, "a", 3),
              Event(3, "x", 0), Event(4, "b", 4)]
    make = lambda P: _ab(P, strict=True)  # noqa: E731
    got = run_both(make, event_batches(make, [(7, e) for e in events]))
    assert got == host_deltas(make, events) == [0, 1, 0, 0, 0]


def test_relaxed_branching():
    events = [Event(0, "a", 1), Event(1, "x", 0), Event(2, "b", 2),
              Event(3, "b", 3), Event(4, "a", 5), Event(5, "b", 6)]
    got = run_both(_ab, event_batches(_ab, [(9, e) for e in events]))
    assert got == host_deltas(_ab, events) and got[-1] == 2


def test_three_stage_conjunction():
    def make(P):
        return (P.begin("first").where(lambda e: e.name == "a")
                .followed_by("mid").where(lambda e: e.name == "b")
                .where(lambda e: e.value > 10)
                .followed_by("last").where(lambda e: e.name == "c"))
    events = [Event(0, "a", 1), Event(1, "b", 5), Event(2, "b", 20),
              Event(3, "c", 7), Event(4, "c", 8)]
    got = run_both(make, event_batches(make, [(3, e) for e in events]))
    assert got == host_deltas(make, events) and sum(got) == 2


def test_single_stage_or_predicate():
    def make(P):
        return P.begin("x").where(lambda e: e.name == "a").or_(
            lambda e: e.value > 100)
    events = [Event(0, "a", 1), Event(1, "z", 500), Event(2, "z", 3)]
    got = run_both(make, event_batches(make, [(1, e) for e in events]))
    assert got == host_deltas(make, events) == [1, 1, 0]


def test_cross_batch_carry():
    events = [Event(0, "a", 1), Event(1, "x", 0), Event(2, "b", 2),
              Event(3, "b", 3)]
    got = run_both(_ab, event_batches(_ab, [(5, e) for e in events],
                                      spans=[(0, 2), (2, 4)]))
    assert got == host_deltas(_ab, events) == [0, 0, 1, 1]


def test_interleaved_keys_independent():
    make = lambda P: _ab(P, strict=True)  # noqa: E731
    ke = [(1, Event(0, "a", 1)), (2, Event(1, "a", 9)),
          (2, Event(2, "x", 0)), (1, Event(3, "b", 2)),
          (2, Event(4, "b", 8))]
    assert run_both(make, event_batches(make, ke)) == [0, 0, 0, 1, 0]


def test_within_spec_buckets():
    make = lambda P: _ab(P).within(10)  # noqa: E731
    spec = dt.DevicePatternSpec.from_pattern(make(PT), within_buckets=8)
    assert spec == dt.DevicePatternSpec(2, (True, True), 6, 2)
    assert spec.dim == (2 - 1) * 6 + 2
    flat = dt.DevicePatternSpec.from_pattern(
        PT.begin("a").where(lambda e: e.name == "a"))
    assert flat.within_panes == 1 and flat.dim == 2


def within_batches(make, seq, buckets=8):
    """(key, event, batch_ts) triples; consecutive equal batch_ts form one
    batch, whose pane is batch_ts // pane_ms (tests/test_cep_device.py's
    device_run_within)."""
    p = make(PJ)
    spec = dj.DevicePatternSpec.from_pattern(p, within_buckets=buckets)
    out, i = [], 0
    while i < len(seq):
        j = i
        while j < len(seq) and seq[j][2] == seq[i][2]:
            j += 1
        chunk = seq[i:j]
        masks = dj.host_masks(p, [e for _k, e, _t in chunk])
        pane = chunk[0][2] // spec.pane_ms if spec.pane_ms else 0
        out.append(([k for k, _e, _t in chunk], masks,
                    np.ones(len(chunk), bool), pane))
        i = j
    return out, spec


def test_within_kills_expired_partials():
    make = lambda P: _ab(P).within(100)  # noqa: E731
    seq = [(5, Event(0, "a", 1), 0), (5, Event(200, "b", 1), 200)]
    assert run_both(make, within_batches(make, seq, 4)[0], buckets=4) == \
        [0, 0]
    seq = [(5, Event(0, "a", 1), 0), (5, Event(100, "b", 1), 100)]
    assert run_both(make, within_batches(make, seq, 4)[0], buckets=4) == \
        [0, 1]


def test_within_equals_host_on_quantized_ts():
    make = lambda P: _ab(P).within(40)  # noqa: E731
    events = [("a", 0), ("x", 10), ("b", 20), ("a", 30), ("b", 45),
              ("b", 80), ("a", 90), ("x", 100), ("b", 120), ("b", 131)]
    seq = [(3, Event(t, n, 1), t) for n, t in events]
    batches, spec = within_batches(make, seq)
    got = run_both(make, batches)
    assert got == host_deltas(make, [e for _k, e, _t in seq], spec.pane_ms)


def test_within_strict_stage_and_multikey_fuzz():
    rng = np.random.default_rng(11)

    def make(P):
        return (P.begin("a").where(lambda e: e.name == "a")
                .next("b").where(lambda e: e.name == "b")
                .followed_by("c").where(lambda e: e.name == "c")
                .within(64))
    names = np.array(["a", "b", "c", "x"])
    ts = np.cumsum(rng.integers(0, 24, 160))
    seq = [(int(rng.integers(0, 5)),
            Event(int(ts[i]), str(rng.choice(names)), 0), int(ts[i]))
           for i in range(160)]
    batches, spec = within_batches(make, seq)
    got = run_both(make, batches)
    for k in range(5):
        evs = [e for kk, e, _t in seq if kk == k]
        want = host_deltas(make, evs, spec.pane_ms)
        assert sum(d for (kk, _e, _t), d in zip(seq, got) if kk == k) == \
            sum(want)


def test_branching_explosion_exactness():
    events = [Event(i, "a", i) for i in range(20)] + [Event(99, "b", 0)]
    got = run_both(_ab, event_batches(_ab, [(4, e) for e in events]))
    assert got == host_deltas(_ab, events) and got[-1] == 20


def test_dead_lanes_are_the_identity():
    """Invalid lanes and keys with no slot (a full table of 2 slots):
    delta 0, no state change, dropped_capacity counted as the reference
    counts it."""
    spec_j = dj.DevicePatternSpec.from_pattern(_ab(PJ))
    spec_t = dt.DevicePatternSpec.from_pattern(_ab(PT))
    sj = dj.init_state(2, 2, spec_j)
    st_k = dt.init_state(2, 2, spec_t, device="cpu")
    rng = np.random.default_rng(4)
    for n_keys in (2, 3, 3):
        # keys 0 and 1 fill both slots first; key 2 never finds one
        keys = rng.integers(0, n_keys, 24)
        masks = rng.random((24, 2)) < 0.5
        valid = rng.random(24) < 0.8
        hi, lo = halves(keys)
        sj, d_j, _ = dj.advance(sj, spec_j, jnp.asarray(hi), jnp.asarray(lo),
                                jnp.asarray(masks), jnp.asarray(valid))
        st_k, d_k, _ = dt.advance(
            st_k, spec_t, torch.from_numpy(hi.view(np.int32).copy()),
            torch.from_numpy(lo.view(np.int32).copy()),
            torch.from_numpy(masks), torch.from_numpy(valid))
        np.testing.assert_array_equal(d_k.numpy(), np.asarray(d_j))
    assert int(st_k.dropped_capacity) == int(sj.dropped_capacity) > 0
    assert carry_by_key_port(st_k) == carry_by_key_ref(sj)


def test_state_dimension_above_the_kernel_limit_raises():
    make = lambda P: _ab(P).within(127)  # noqa: E731
    spec = dt.DevicePatternSpec.from_pattern(make(PT), within_buckets=127)
    assert spec.dim == 130 > kernels.CEP_MAX_DIM
    st_k = dt.init_state(16, 8, spec, device="cpu")
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match=str(kernels.CEP_MAX_DIM)):
        dt.advance(st_k, spec, z, z, torch.zeros(1, 2, dtype=torch.bool),
                   torch.ones(1, dtype=torch.bool), 0)


@settings(max_examples=12, deadline=None, derandomize=True)
@given(
    n_stages=st.integers(1, 4),
    relaxed=st.lists(st.booleans(), min_size=4, max_size=4),
    within=st.booleans(),
    keys=st.sampled_from(["many", "hot", "one"]),
    seed=st.integers(0, 2**31 - 1),
)
def test_fuzz_against_reference(n_stages, relaxed, within, keys, seed):
    """Random stage bits and contiguities over up to four stages, within()
    on and off (panes advancing, sometimes by more than the ring), many
    keys, one hot key or one segment, three batches of up to LANES lanes
    with a tenth invalid."""
    rng = np.random.default_rng(seed)

    def make(P):
        p = P.begin("s0")
        for s in range(1, n_stages):
            p = p.followed_by(f"s{s}") if relaxed[s] else p.next(f"s{s}")
        return p.within(20) if within else p

    batches, pane = [], 0
    for _ in range(3):
        B = int(rng.integers(1, LANES + 1))
        if keys == "many":
            k = rng.integers(0, 12, B)
        elif keys == "hot":
            k = np.where(rng.random(B) < 0.7, 5, rng.integers(0, 12, B))
        else:
            k = np.zeros(B, np.int64)
        masks = rng.random((B, n_stages)) < rng.uniform(0.1, 0.6)
        batches.append((k.tolist(), masks, rng.random(B) < 0.9, pane))
        pane += int(rng.integers(0, 9))
    run_both(make, batches, capacity=32, buckets=4)


@pytest.mark.parametrize("strict, within, q_t", [
    (False, None, 0), (True, None, 0), (False, 40, 3), (True, 40, 8),
])
def test_event_matrices_and_host_masks_match_reference(strict, within, q_t):
    """The plain per-lane matrices T(e) and the host masks, element for
    element, for three stages (S = 1 included below), with and without
    the within() ring."""
    def make(P):
        p = _ab(P, strict)
        p = p.followed_by("c").where(lambda e: e.value > 5)
        return p.within(within) if within else p
    rng = np.random.default_rng(7)
    evs = [Event(i, str(n), int(v)) for i, (n, v) in enumerate(
        zip(rng.choice(list("abx"), 64), rng.integers(0, 10, 64)))]
    masks_j = dj.host_masks(make(PJ), evs)
    masks_t = dt.host_masks(make(PT), evs)
    np.testing.assert_array_equal(masks_t, masks_j)
    spec_j = dj.DevicePatternSpec.from_pattern(make(PJ))
    spec_t = dt.DevicePatternSpec.from_pattern(make(PT))
    T_j = dj.event_matrices(spec_j, jnp.asarray(masks_j),
                            jnp.int32(q_t) if within else None)
    T_t = dt.event_matrices_plain(spec_t, torch.from_numpy(masks_t), q_t)
    np.testing.assert_array_equal(T_t.numpy(), np.asarray(T_j))
    one = PT.begin("x").where(lambda e: e.name == "a")
    T1 = dt.event_matrices_plain(dt.DevicePatternSpec.from_pattern(one),
                                 torch.from_numpy(masks_t[:, :1]))
    np.testing.assert_array_equal(
        T1.numpy(), np.asarray(dj.event_matrices(
            dj.DevicePatternSpec.from_pattern(
                PJ.begin("x").where(lambda e: e.name == "a")),
            jnp.asarray(masks_j[:, :1]))))
    assert float(dt.INT_MAX) == float(dj.INT_MAX) == kernels.CEP_INT_MAX
