"""Count windows (``count_window(n)``): flink_tpu_torch's
``ops/count_windows.py`` (G5 + G10 + G12's plain versions on the CPU)
against flink_tpu's ``ops/count_windows.py`` on the same seeded batches —
fires as sorted rows, state key by key — then both packages' public APIs
on Flink's WindowWordCount shape. Integer-valued data compares bit for
bit; positive random floats at rtol 1e-6."""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import (
    KB, KC, assert_keyed_states_equal, jax_keyed_fields, key_halves,
    keyed_batches, keyed_lanes_torch, sorted_rows,
)

from flink_tpu.ops import count_windows as cj
from flink_tpu.ops.window_kernels import ReduceSpec as ReduceSpecJ
from flink_tpu_torch.ops import count_windows as ct
from flink_tpu_torch.ops.hashing import splitmix64


@functools.lru_cache(maxsize=None)
def jax_update(n: int):
    red = ReduceSpecJ("sum", jnp.float32)
    return jax.jit(lambda st, hi, lo, v, valid: cj.update(st, red, n, hi, lo,
                                                          v, valid))


def run_both(batches, n, sj=None, st=None, rtol=0.0):
    upd = jax_update(n)
    if sj is None:
        sj = cj.init_state(KC, 16, ReduceSpecJ("sum", jnp.float32))
    if st is None:
        st = ct.init_state(KC, device="cpu")
    n_fires = 0
    for hi, lo, _ts, vals, valid in batches:
        sj, khi, klo, w, fv, mask = upd(sj, hi, lo, vals, valid)
        m = np.asarray(mask)
        want = sorted_rows([np.asarray(khi)[m].view(np.uint32),
                            np.asarray(klo)[m].view(np.uint32),
                            np.asarray(w)[m]])
        want_v = np.asarray(fv)[m][np.lexsort((np.asarray(w)[m],
                                               np.asarray(klo)[m].view(
                                                   np.uint32),
                                               np.asarray(khi)[m].view(
                                                   np.uint32)))]
        st, rows, n_rows = ct.update(st, n, *keyed_lanes_torch(hi, lo, vals,
                                                               valid))
        k = int(n_rows)
        r = [x[:k].numpy() for x in rows]
        got = sorted_rows([r[0].view(np.uint32), r[1].view(np.uint32),
                           r[2]])
        got_v = r[3][np.lexsort((r[2], r[1].view(np.uint32),
                                 r[0].view(np.uint32)))]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got_v, want_v, rtol=rtol, atol=0)
        n_fires += k
    return sj, st, n_fires


@pytest.mark.parametrize("n,floats", [(3, False), (10, False), (10, True)])
def test_count_windows_fire_and_state_match_reference(n, floats):
    rtol = 1e-6 if floats else 0.0
    sj, st, n_fires = run_both(keyed_batches(4, 4, floats=floats), n,
                               rtol=rtol)
    assert n_fires > 0
    assert_keyed_states_equal(jax_keyed_fields(sj, ct.STATE_FIELDS),
                              ct.state_to_numpy(st), rtol=rtol)


def test_count_windows_one_key_in_every_lane():
    rng = np.random.default_rng(8)
    hi, lo = key_halves(np.full(KB, -77, np.int64))
    batches = [(hi, lo, None, rng.integers(1, 9, KB).astype(np.float32),
                rng.random(KB) < 0.97) for _ in range(3)]
    sj, st, n_fires = run_both(batches, 10)
    assert n_fires >= 3 * 24
    assert_keyed_states_equal(jax_keyed_fields(sj, ct.STATE_FIELDS),
                              ct.state_to_numpy(st))


# -- the public API: WindowWordCount (countWindow(10).sum(count)) -------

def word_gen(offset, n):
    idx = np.arange(offset, offset + n, dtype=np.int64)
    rank = np.where(idx % 3 == 0, 0, (idx * 2654435761) % 61)
    return {"word": splitmix64(rank).view(np.int64),
            "value": np.ones(n, np.float32)}, None


def window_count_job(pkg, total, batch, n, columnar):
    if pkg == "jax":
        from flink_tpu import StreamExecutionEnvironment
        from flink_tpu.runtime.sinks import CollectSink
        from flink_tpu.runtime.sources import GeneratorSource
        env = StreamExecutionEnvironment()
        sink = CollectSink()
    else:
        from flink_tpu_torch import StreamExecutionEnvironment
        from flink_tpu_torch.runtime.sinks import (
            CollectSink, ColumnarCollectSink,
        )
        from flink_tpu_torch.runtime.sources import GeneratorSource
        env = StreamExecutionEnvironment(device="cpu")
        sink = ColumnarCollectSink() if columnar else CollectSink()
    env.set_parallelism(1)
    env.set_state_capacity(KC)
    env.batch_size = batch
    (env.add_source(GeneratorSource(word_gen, total=total))
     .key_by(lambda c: c["word"])
     .count_window(n)
     .sum(lambda c: c["value"])
     .add_sink(sink))
    job = env.execute("window-word-count")
    return sink, job


@pytest.mark.parametrize("columnar", [True, False])
def test_window_word_count_matches_reference_and_numpy(columnar):
    total, batch, n = 2000, 256, 10
    ref_sink, _ = window_count_job("jax", total, batch, n, False)
    sink, job = window_count_job("torch", total, batch, n, columnar)
    want = sorted((int(r.key), int(r.window_end_ms), float(r.value))
                  for r in ref_sink.results)
    if columnar:
        cols = sink.columns()
        got = sorted(zip(cols["key_id"].view(np.int64).tolist(),
                         cols["window_end_ms"].tolist(),
                         cols["value"].tolist()))
    else:
        got = sorted((int(r.key), int(r.window_end_ms), float(r.value))
                     for r in sink.results)
        assert type(sink.results[0]).__name__ == "WindowResult"
    assert got == want
    words = word_gen(0, total)[0]["word"]
    uniq, cnt = np.unique(words, return_counts=True)
    assert got == sorted((int(k), w, float(n)) for k, c in zip(uniq, cnt)
                         for w in range(c // n))
    assert job.metrics.fires == len(got)
