"""The rolling keyed reduce (``KeyedStream.sum``): flink_tpu_torch's
``ops/rolling.py`` (G5 + G10 + G13's plain versions on the CPU) against
flink_tpu's ``ops/rolling.py`` on the same seeded batches, lane by lane,
then both packages' public APIs on the streaming WordCount's shape.

Integer-valued data compares bit for bit; positive random floats at
rtol 1e-6 (the port scans in another order than the reference's
associative-scan tree). Tables compare as sets: a key may take another
slot in each package."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import (
    KB, KC, assert_keyed_states_equal, jax_keyed_fields, key_halves,
    keyed_batches, keyed_lanes_torch,
)

from flink_tpu.ops import rolling as rj
from flink_tpu.ops.window_kernels import ReduceSpec as ReduceSpecJ
from flink_tpu_torch.ops import rolling as rt
from flink_tpu_torch.ops.hashing import splitmix64


@functools.lru_cache(maxsize=None)
def jax_update():
    red = ReduceSpecJ("sum", jnp.float32)
    return jax.jit(lambda st, hi, lo, v, valid: rj.update(st, red, hi, lo, v,
                                                          valid))


def jax_init():
    return rj.init_state(KC, 16, ReduceSpecJ("sum", jnp.float32))


def run_both(batches, sj=None, st=None, rtol=0.0):
    """Feed every batch to both; compare each lane's output; return the
    two states."""
    upd = jax_update()
    sj = jax_init() if sj is None else sj
    st = rt.init_state(KC, device="cpu") if st is None else st
    for hi, lo, _ts, vals, valid in batches:
        sj, out_j, ok_j = upd(sj, hi, lo, vals, valid)
        st, out_t, ok_t = rt.update(st, *keyed_lanes_torch(hi, lo, vals,
                                                           valid))
        ok_j = np.asarray(ok_j)
        np.testing.assert_array_equal(ok_t.numpy(), ok_j)
        np.testing.assert_allclose(out_t.numpy()[ok_j],
                                   np.asarray(out_j)[ok_j], rtol=rtol,
                                   atol=0)
    return sj, st


@pytest.mark.parametrize("floats", [False, True])
def test_rolling_outputs_and_state_match_reference(floats):
    rtol = 1e-6 if floats else 0.0
    sj, st = run_both(keyed_batches(3, 4, floats=floats), rtol=rtol)
    assert_keyed_states_equal(jax_keyed_fields(sj, rt.STATE_FIELDS),
                              rt.state_to_numpy(st), rtol=rtol)
    assert int(st.dropped_capacity) > 0      # the key -1 lanes


def test_rolling_one_key_in_every_lane():
    rng = np.random.default_rng(5)
    hi, lo = key_halves(np.full(KB, 12345, np.int64))
    batches = [(hi, lo, None, rng.integers(1, 9, KB).astype(np.float32),
                np.ones(KB, bool)) for _ in range(2)]
    sj, st = run_both(batches)
    assert_keyed_states_equal(jax_keyed_fields(sj, rt.STATE_FIELDS),
                              rt.state_to_numpy(st))


# -- the public API: streaming WordCount (keyBy(word).sum(count)) -------

def word_gen(total_words=300, seed=11):
    """Zipf-ranked words as sparse ids, every value 1 but a few 2s."""
    def gen(offset, n):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        rank = (idx * 2654435761) % 97
        rank = np.where(idx % 3 == 0, 0, rank)      # a hot word
        word = splitmix64(rank + seed).view(np.int64)
        val = np.where(idx % 17 == 0, 2.0, 1.0).astype(np.float32)
        return {"word": word, "value": val}, None
    return gen


def wordcount_job(pkg, total, batch, sink_kind="columnar"):
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
        sink = ColumnarCollectSink() if sink_kind == "columnar" \
            else CollectSink()
    env.set_parallelism(1)
    env.set_state_capacity(KC)
    env.batch_size = batch
    (env.add_source(GeneratorSource(word_gen(), total=total))
     .key_by(lambda c: c["word"])
     .sum(lambda c: c["value"])
     .add_sink(sink))
    job = env.execute("wordcount")
    return sink, job


def numpy_running_sums(total):
    cols, _ = word_gen()(0, total)
    words, vals = cols["word"], cols["value"].astype(np.float64)
    out = np.zeros(total)
    acc = {}
    for i, (w, v) in enumerate(zip(words.tolist(), vals.tolist())):
        acc[w] = acc.get(w, 0.0) + v
        out[i] = acc[w]
    return words, out


def test_wordcount_job_matches_reference_and_numpy():
    total, batch = 1500, 256
    words, want = numpy_running_sums(total)
    ref_sink, _ = wordcount_job("jax", total, batch)
    sink, job = wordcount_job("torch", total, batch)
    cols = sink.columns()
    np.testing.assert_array_equal(cols["key_id"],
                                  words.astype(np.uint64))
    np.testing.assert_array_equal(cols["value"], want.astype(np.float32))
    ref = ref_sink.results
    assert [k for k, _ in ref] == words.tolist()
    np.testing.assert_array_equal(np.array([v for _, v in ref]), want)
    assert job.metrics.records_in == total
    assert job.metrics.dropped_capacity == 0


def test_wordcount_rows_to_a_collect_sink_are_the_references():
    total, batch = 600, 128
    ref_sink, _ = wordcount_job("jax", total, batch)
    sink, _ = wordcount_job("torch", total, batch, sink_kind="rows")
    assert sink.results == ref_sink.results


def test_rolling_over_capacity_raises_on_both():
    from flink_tpu_torch import StreamExecutionEnvironment
    from flink_tpu_torch.runtime.sinks import ColumnarCollectSink
    from flink_tpu_torch.runtime.sources import GeneratorSource
    env = StreamExecutionEnvironment(device="cpu")
    env.set_state_capacity(64)
    env.batch_size = 256

    def gen(offset, n):
        return {"k": np.arange(offset, offset + n, dtype=np.int64) * 7919}, \
            None
    (env.add_source(GeneratorSource(gen, total=512))
     .key_by(lambda c: c["k"]).sum(lambda c: np.ones(len(c["k"]),
                                                     np.float32))
     .add_sink(ColumnarCollectSink()))
    with pytest.raises(RuntimeError, match="state backend over capacity"):
        env.execute("over")
