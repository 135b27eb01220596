"""Jobs over a shard mesh against the reference and numpy, on the CPU
(``force_device_count(8)``, as in tests/test_torch_sharded.py): the
exchange's bucket overflow counted as the reference counts it; a
sparse-key job in the hash layout whose keys outgrow each shard's
capacity (the spill tier per shard); the rolling sum and
``KeyedStream.reduce(fn)`` at parallelism 4 (G1's owner mask, G27's
merge); checkpoints written at parallelism 4 restored at 4 and at 2 by
either package, and a crash at a sharded drain restarted exactly.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest

from test_torch_sharded import B, EVENTS_PER_MS, MODES, TOTAL, WINDOW, \
    eight_devices, expected, gen, run  # noqa: F401 (the fixture)

from flink_tpu import StreamExecutionEnvironment as EnvJ
from flink_tpu.runtime.sinks import CollectSink as SinkJ
from flink_tpu.runtime.sources import GeneratorSource as GenJ
from flink_tpu_torch import StreamExecutionEnvironment as EnvT
from flink_tpu_torch.runtime.sinks import CollectSink as SinkT
from flink_tpu_torch.runtime.sources import GeneratorSource as GenT
from flink_tpu_torch.testing import faults
from flink_tpu_torch.testing.faults import FaultInjector, FaultRule


def test_all_to_all_overflow_counts_like_the_reference():
    """One hot key over a small bucket factor: every batch overflows its
    exchange buckets; both packages count the same lanes lost (strict
    capacity off) and emit the same rows."""
    def hot(offset, n):
        cols, ts = gen(offset, n)
        cols["key"] = np.where(np.arange(n) % 3 == 0, 7, cols["key"])
        return cols, ts

    cfg = {"exchange.mode": "all_to_all", "exchange.capacity-factor": 1.0,
           "state.backend.strict-capacity": False}
    got, m = run("torch", cfg, 4, total=8 * B, source=hot)
    want, r = run("jax", cfg, 4, total=8 * B, source=hot)
    assert got == want
    assert m.dropped_capacity == r.dropped_capacity > 0
    assert m.steps_exchanged == r.steps_exchanged == 8


def sparse(offset, n):
    """3,000 sparse 64-bit ids: past each of 4 shards' 256 slots."""
    idx = np.arange(offset, offset + n, dtype=np.int64)
    ids = ((idx * 7919) % 3000).astype(np.uint64) * np.uint64(
        0x9E3779B97F4A7C15)
    return ({"key": ids.view(np.int64), "value": np.ones(n, np.float32)},
            idx // EVENTS_PER_MS)


@pytest.mark.parametrize("mode", ["auto", "sharded_drain"])
def test_hash_layout_spills_per_shard_exactly(mode):
    """The split path's against the reference's rows and numpy's, the
    sharded drain's against numpy's (it spills through each shard's ring
    the same way)."""
    total = 12 * B
    got, m = run("torch", MODES[mode], 4, total=total, source=sparse,
                 capacity=256)
    cols, ts = sparse(0, total)
    exp = {}
    for k, t in zip(cols["key"].tolist(), ts.tolist()):
        key = (k, (t // WINDOW + 1) * WINDOW)
        exp[key] = exp.get(key, 0.0) + 1.0
    assert got == exp
    assert m.spilled_records > 0 and m.dropped_capacity == 0
    if mode == "auto":
        want, _r = run("jax", MODES[mode], 4, total=total, source=sparse,
                       capacity=256)
        assert want == exp


def rolling(pkg, parallelism, fn=None, total=3000):
    torch_side = pkg == "torch"
    Env, Sink, Gen = ((EnvT, SinkT, GenT) if torch_side
                      else (EnvJ, SinkJ, GenJ))
    env = Env(**({"device": "cpu"} if torch_side else {}))
    env.set_parallelism(parallelism)
    env.set_state_capacity(1024)
    env.batch_size = 256

    def words(offset, n):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        return ({"word": (idx * 37) % 500,
                 "value": (idx % 5).astype(np.float32)}, idx)

    sink = Sink()
    keyed = env.add_source(Gen(words, total=total)).key_by(
        lambda c: c["word"])
    (keyed.sum(lambda c: c["value"]) if fn is None
     else keyed.reduce(fn, lambda c: c["value"])).add_sink(sink)
    env.execute("rolling")
    cols, _ = words(0, total)
    acc, want = {}, []
    for w, v in zip(cols["word"].tolist(), cols["value"].tolist()):
        acc[w] = v if w not in acc else (acc[w] + v if fn is None
                                         else max(acc[w], v))
        want.append((w, acc[w]))
    return [(int(k), float(v)) for k, v in sink.results], want


@pytest.mark.parametrize("generic", [False, True])
def test_rolling_reduce_over_four_shards(generic):
    fn_t = fn_j = None
    if generic:
        import jax.numpy as jnp
        import torch
        fn_t = torch.maximum
        fn_j = jnp.maximum
    got, want = rolling("torch", 4, fn_t)
    ref, _ = rolling("jax", 4, fn_j)
    assert got == [(k, float(v)) for k, v in want]
    assert ref == got




def _rows_of(pkg, parallelism, total, ckpt_dir=None, restore_from=None,
             cfg=None, source=None):
    ckpt = (1, str(ckpt_dir)) if ckpt_dir is not None else None
    return run(pkg, cfg or {}, parallelism, total=total, ckpt=ckpt,
               restore_from=restore_from, source=source or gen)[0]


@pytest.mark.parametrize("writer, reader, p_read", [
    ("torch", "torch", 4), ("torch", "torch", 2), ("jax", "torch", 2),
    ("torch", "jax", 2)])
def test_checkpoint_at_4_restores_at_4_and_2(tmp_path, writer, reader,
                                             p_read):
    """The first half of the stream at parallelism 4, a cut every batch;
    the rest restored from the newest cut at ``p_read`` shards — the
    entries re-bucketed by key group. The open windows come out of the
    second phase whole, and the merged rows are numpy's."""
    half = TOTAL // 2
    rows1 = _rows_of(writer, 4, half, ckpt_dir=tmp_path / "chk")
    rows2 = _rows_of(reader, p_read, TOTAL,
                     restore_from=str(tmp_path / "chk"))
    assert {**rows1, **rows2} == expected(TOTAL)
    assert any(rows1.get(k) != v for k, v in rows2.items())


def test_crash_at_a_sharded_drain_restarts_exactly(tmp_path):
    """A crash at the second sharded drain's dispatch (the ``step.drain``
    seam), the fixed-delay restart from the newest cut: every window once,
    with numpy's value."""
    cfg = {**MODES["sharded_drain"], "restart-strategy": "fixed-delay",
           "restart-strategy.fixed-delay.attempts": 2,
           "restart-strategy.fixed-delay.delay": 0}
    inj = FaultInjector([FaultRule(
        "step.drain", exc=RuntimeError("injected mid-drain crash"), at=2)])
    with faults.active(inj):
        got, m = run("torch", cfg, 4, ckpt=(2, str(tmp_path / "chk")))
    assert m.restarts == 1 and m.steps_sharded > 0
    assert got == expected(TOTAL)
