"""Count windows and device CEP at the shapes that G12's single pass and
G20's store lists make risky: flink_tpu_torch's ``ops/count_windows.py
update`` and ``cep/device.py advance`` (G12 and G20 through their plain
versions on the CPU, with G5, G10 and G19) against flink_tpu's on the
same seeded batches.

Count windows, three batches each: a window longer than a batch (N = 257
over 256 lanes), one key in every lane with windows across batches, old
counts that are no multiple of N with ``touched`` cleared, and a batch
whose lanes are all invalid between two with 30 % invalid. Fires compare
as sorted rows, state key by key, bit for bit (integer-valued data).
CEP: a within() pattern at cep-within's width (S = 3, Q = 9) whose panes
skip so that one bucket, then several, then all go stale between batches,
and one with Q = 100 buckets, so that the stale flags reach past bit 64.
Deltas and carry compare bit for bit, as in
``tests/test_torch_cep_device.py``."""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_cep_device import (
    Event, _ab, host_deltas, run_both as cep_run_both, within_batches,
)
from test_torch_count_windows import run_both as count_run_both
from torch_parity import (
    KB, assert_keyed_states_equal, jax_keyed_fields, key_halves,
    keyed_batches,
)

from flink_tpu.ops import count_windows as cj
from flink_tpu_torch.ops import count_windows as ct


def _one_key_batches(seed):
    rng = np.random.default_rng(seed)
    hi, lo = key_halves(np.full(KB, 4321, np.int64))
    return [(hi, lo, None, rng.integers(1, 9, KB).astype(np.float32),
             np.ones(KB, bool)) for _ in range(3)]


def _dead_batches(seed):
    out = []
    for i, (hi, lo, ts, vals, valid) in enumerate(keyed_batches(seed, 3)):
        rng = np.random.default_rng(seed + i)
        valid = valid & (rng.random(KB) >= 0.3)
        out.append((hi, lo, ts, vals, valid if i != 1 else valid & False))
    return out


COUNT_CASES = {
    # (batches, N): each case's three batches in a row
    "window_longer_than_a_batch": (lambda: keyed_batches(31, 3, pool=5),
                                   257),
    "one_key_windows_across_batches": (lambda: _one_key_batches(32), 600),
    "dead_lanes_and_a_dead_batch": (lambda: _dead_batches(33), 5),
}


@pytest.mark.parametrize("case", sorted(COUNT_CASES))
def test_count_windows_edges_match_reference(case):
    make, n = COUNT_CASES[case]
    sj, st, n_fires = count_run_both(make(), n)
    assert n_fires > 0
    assert_keyed_states_equal(jax_keyed_fields(sj, ct.STATE_FIELDS),
                              ct.state_to_numpy(st))


def test_count_windows_untouched_partial_matches_reference():
    """Old counts that are no multiple of N with ``touched`` cleared (a
    restored state may hold them): the partial is not folded in, on both
    sides, over two more batches."""
    n = 7
    b1, b2, b3 = keyed_batches(34, 3, pool=40)
    sj, st, _ = count_run_both([b1], n)
    fields = jax_keyed_fields(sj, ct.STATE_FIELDS)
    count = np.asarray(fields["count"])
    touched = np.array(fields["touched"])
    part = np.nonzero((count % n != 0) & touched)[0]
    assert part.size >= 4
    touched[part[::2]] = False
    fields["touched"] = touched
    sj = cj.CountShardState(table=sj.table, count=sj.count, acc=sj.acc,
                            touched=jnp.asarray(touched),
                            dropped_capacity=sj.dropped_capacity)
    st = ct.state_from_numpy(fields, device="cpu")
    sj, st, n_fires = count_run_both([b2, b3], n, sj=sj, st=st)
    assert n_fires > 0
    assert_keyed_states_equal(jax_keyed_fields(sj, ct.STATE_FIELDS),
                              ct.state_to_numpy(st))


def _abc(P):
    return (P.begin("a").where(lambda e: e.name == "a")
            .followed_by("b").where(lambda e: e.name == "b")
            .followed_by("c").where(lambda e: e.name == "c"))


def _skipping_seq(rng, keys, batch_ts, names="abcx"):
    """(key, event, batch ts) triples: each batch ts a batch of events of
    random keys and names, their ticks inside the batch's pane."""
    seq = []
    for t in batch_ts:
        for _ in range(int(rng.integers(12, 40))):
            seq.append((int(rng.integers(0, keys)),
                        Event(t, str(rng.choice(list(names))), 0), t))
    return seq


def _check_per_key(make, seq, got, pane_ms, keys):
    for k in range(keys):
        evs = [e for kk, e, _t in seq if kk == k]
        assert sum(d for (kk, _e, _t), d in zip(seq, got) if kk == k) == \
            sum(host_deltas(make, evs, pane_ms))


def test_within_panes_skip_so_buckets_go_stale():
    """S = 3, Q = 9 (cep-within's D = 20): panes 0, 1, 2 (one bucket stale
    a batch), then 6 (four), 9, then 40 and 90 (all nine), then 91."""
    make = lambda P: _abc(P).within(64)  # noqa: E731
    rng = np.random.default_rng(40)
    seq = _skipping_seq(rng, 6, [0, 8, 16, 48, 72, 320, 720, 728])
    batches, spec = within_batches(make, seq)
    assert (spec.n_stages, spec.within_panes, spec.dim) == (3, 9, 20)
    got = cep_run_both(make, batches)
    assert sum(got) > 0
    _check_per_key(make, seq, got, spec.pane_ms, 6)


def test_within_hundred_buckets_stale_past_bit_64():
    """Q = 100 buckets (D = 102): skips of 1, 69, 40 and 500 panes stale
    ring slots above 64, then all of them."""
    make = lambda P: _ab(P).within(99)  # noqa: E731
    rng = np.random.default_rng(41)
    seq = _skipping_seq(rng, 5, [0, 1, 70, 110, 610, 611], names="abx")
    batches, spec = within_batches(make, seq, buckets=99)
    assert spec.within_panes == 100 and spec.dim == 102
    got = cep_run_both(make, batches, buckets=99)
    assert sum(got) > 0
    _check_per_key(make, seq, got, spec.pane_ms, 5)

