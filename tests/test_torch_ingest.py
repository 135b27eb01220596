"""The port's ingest pipeline (flink_tpu_torch/runtime/ingest.py), the
mirror of the reference's tests/test_ingest_pipeline.py on the CPU:

* exactly-once across a crash with ``pipeline.prefetch: on``: the cut is
  the last applied batch's offsets, so the batches the producer polled
  ahead of it replay after the restore (in-process, and across two
  processes' worth of environments), in the split path and the drain;
* a crash at the producer's own seam (``ingest.producer``), which kills
  the thread, surfaces as ``IngestThreadDied`` and restarts exactly-once;
* producer and encode errors reach the driver, and the loop does not
  hang;
* the reference's resolution errors: staging needs prefetch, and a
  non-replayable source with checkpoints polls inline under ``auto`` and
  raises under ``on``;
* staging on and off give the same windows;
* the epoch / pause / resume protocol, a hard death after a resume, and
  an error followed by a resume, at the unit level; the staging ring's
  fresh tensors and the device ring's slots carry the padded batch.

Every job's rows are held against numpy and, where it runs the same
configuration, the reference's.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import threading
import time

import numpy as np
import pytest
import torch

from flink_tpu_torch import StreamExecutionEnvironment
from flink_tpu_torch.core.config import Configuration
from flink_tpu_torch.core.time import TimeCharacteristic
from flink_tpu_torch.runtime import ingest as ingest_mod
from flink_tpu_torch.runtime.sinks import CollectSink, CountingSink
from flink_tpu_torch.runtime.sources import GeneratorSource
from flink_tpu_torch.testing import faults
from flink_tpu_torch.testing.faults import FaultInjector, FaultRule

N_KEYS = 200
WINDOW = 10_000


def gen(offset, n):
    idx = np.arange(offset, offset + n)
    cols = {"key": (idx * 48271) % N_KEYS, "value": np.ones(n, np.float32)}
    return cols, (idx // 50) * 1000


def expected(total):
    idx = np.arange(total)
    keys = (idx * 48271) % N_KEYS
    ts = (idx // 50) * 1000
    out = {}
    for k, t in zip(keys.tolist(), ts.tolist()):
        we = (t // WINDOW + 1) * WINDOW
        out[(k, we)] = out.get((k, we), 0) + 1.0
    return out


def build_env(ckpt_dir=None, interval=0, restart=None, pkg="torch", **cfg):
    """The reference test's environment (capacity 1,024, batches of 256,
    max parallelism 128) on either package."""
    if pkg == "jax":
        from flink_tpu import StreamExecutionEnvironment as Env
        from flink_tpu.core.config import Configuration as Conf
        from flink_tpu.core.time import TimeCharacteristic as TC
        kw = {}
    else:
        Env, Conf, TC = (StreamExecutionEnvironment, Configuration,
                         TimeCharacteristic)
        kw = {"device": "cpu"}
    conf = Conf(cfg)
    if restart:
        conf.set("restart-strategy", "fixed-delay")
        conf.set("restart-strategy.fixed-delay.attempts", restart)
    env = Env(conf, **kw)
    env.set_parallelism(1).set_max_parallelism(128)
    env.set_stream_time_characteristic(TC.EventTime)
    env.set_state_capacity(1024)
    env.batch_size = 256
    if ckpt_dir:
        env.enable_checkpointing(interval, str(ckpt_dir))
    return env


def run_job(env, total, source=None, restore_from=None, pkg="torch"):
    if pkg == "jax":
        from flink_tpu.runtime.sinks import CollectSink as Sink
        from flink_tpu.runtime.sources import GeneratorSource as Gen
    else:
        Sink, Gen = CollectSink, GeneratorSource
    sink = Sink()
    (env.add_source(source or Gen(gen, total=total))
     .key_by(lambda c: c["key"]).time_window(WINDOW)
     .sum(lambda c: c["value"]).add_sink(sink))
    job = env.execute("ingest-job", restore_from=restore_from)
    rows = {}
    for r in sink.results:
        k = (int(r.key), int(r.window_end_ms))
        # a window re-emitted after a restore carries its first value
        assert rows.get(k, r.value) == r.value, (k, rows[k], r.value)
        rows[k] = r.value
    return rows, job


class FailingSource(GeneratorSource):
    """Raises once on crossing ``fail_at`` — on the producer thread when
    pipeline.prefetch is on (the poll runs there)."""

    def __init__(self, fn, total, fail_at):
        super().__init__(fn, total)
        self.fail_at = fail_at
        self.failed = False
        self.poll_thread_names = set()

    def poll(self, max_records):
        self.poll_thread_names.add(threading.current_thread().name)
        out = super().poll(max_records)
        if not self.failed and self.offset >= self.fail_at:
            self.failed = True
            raise RuntimeError("injected failure")
        return out


# the split path (auto) and the scan drain, both fed by the producer
MODES = {"split": {}, "drain": {"pipeline.resident-loop": "on",
                                "pipeline.ring-depth": 4}}


# ------------------------------------------------- exactly-once restore

@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefetch_crash_restores_at_the_applied_cut(tmp_path, mode):
    """A source failure on the producer thread mid-stream, with the
    producer polled ahead of the last checkpoint: the restart restores the
    applied-offset cut and replays what was queued past it — every window
    exact, one restart, and the poll really ran off the step loop."""
    total = 4096
    env = build_env(tmp_path / "chk", interval=2, restart=3,
                    **{"pipeline.prefetch": "on", **MODES[mode]})
    src = FailingSource(gen, total, fail_at=total // 2)
    got, job = run_job(env, total, source=src)
    assert job.metrics.restarts == 1
    assert got == expected(total)
    assert any("ingest" in n for n in src.poll_thread_names), \
        src.poll_thread_names


def test_checkpoint_cut_is_applied_offsets_across_processes(tmp_path):
    """Phase 1 runs half the stream with the producer ahead of every
    checkpoint; a fresh environment restores the newest cut and runs the
    whole stream. The merged rows equal the single run's: a cut at the
    live source position would skip the batches queued past it."""
    total, half = 8192, 4096
    got1, job1 = run_job(build_env(tmp_path / "chk", interval=1,
                                   **{"pipeline.prefetch": "on"}), half)
    assert job1.metrics.checkpoint_stats
    got2, _ = run_job(build_env(**{"pipeline.prefetch": "on"}), total,
                      restore_from=str(tmp_path / "chk"))
    assert {**got1, **got2} == expected(total)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_producer_seam_crash_restarts_exactly_once(tmp_path, mode):
    """A raise at ``ingest.producer`` kills the producer without handing
    the step loop an error; the loop surfaces IngestThreadDied, the
    restart restores the cut, the epoch bump lets a fresh producer start,
    and every window is exact."""
    total = 4096
    env = build_env(tmp_path / "chk", interval=2, restart=3,
                    **{"pipeline.prefetch": "on", **MODES[mode]})
    inj = FaultInjector([FaultRule("ingest.producer",
                                   exc=RuntimeError("producer died"),
                                   at=6)])
    with faults.active(inj):
        got, job = run_job(env, total)
    assert inj.fired_at("ingest.producer")
    assert job.metrics.restarts == 1
    assert got == expected(total)


# --------------------------------------------------- error delivery

def test_prefetch_thread_error_reaches_driver():
    """A source error on the producer thread is the job's failure when
    nothing can restart it, and the loop does not hang."""
    env = build_env(**{"pipeline.prefetch": "on"})
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="injected failure"):
        run_job(env, 2048, source=FailingSource(gen, 2048, fail_at=512))
    assert time.monotonic() - t0 < 60.0


def test_prep_encode_error_reaches_driver():
    """An error in the encode half of the prep (a key selector raising)
    also reaches the driver from the producer thread."""
    env = build_env(**{"pipeline.prefetch": "on"})

    def bad_selector(c):
        raise TypeError("bad key selector")

    (env.add_source(GeneratorSource(gen, total=1024))
     .key_by(bad_selector).time_window(WINDOW)
     .sum(lambda c: c["value"]).add_sink(CountingSink()))
    with pytest.raises(TypeError, match="bad key selector"):
        env.execute("bad-selector")


# ------------------------------------------------------ resolution

@pytest.mark.parametrize("staging", ["on", "off"])
def test_device_staging_parity(staging, tmp_path):
    """Staging on the producer is semantics-free: the same windows with
    it on and off, checkpoints taken."""
    env = build_env(tmp_path / f"chk-{staging}", interval=4,
                    **{"pipeline.prefetch": "on",
                       "pipeline.device-staging": staging})
    assert run_job(env, 4096)[0] == expected(4096)


def _error_text(pkg, cfg, tmp_path=None, source=None):
    env = build_env(tmp_path, 4 if tmp_path else 0, pkg=pkg, **cfg)
    with pytest.raises(ValueError) as err:
        run_job(env, 512, source=source, pkg=pkg)
    return str(err.value)


def test_staging_requires_prefetch():
    cfg = {"pipeline.prefetch": "off", "pipeline.device-staging": "on"}
    got = _error_text("torch", cfg)
    assert "device-staging" in got
    assert got == _error_text("jax", cfg)


class _NonReplayableSource(GeneratorSource):
    """A source that cannot rewind: a restore could not replay batches
    polled past the cut."""

    def snapshot_offsets(self):
        return None

    def restore_offsets(self, state):
        pass


def test_non_replayable_source_with_checkpointing(tmp_path):
    """``auto`` polls inline (the job completes, exact); an explicit
    ``on`` is the reference's error, not a silent downgrade."""
    total = 1024
    got, job = run_job(build_env(tmp_path / "chk", interval=4), total,
                       source=_NonReplayableSource(gen, total))
    assert got == expected(total)
    from flink_tpu.runtime.sources import GeneratorSource as RefGen

    class RefNonReplayable(RefGen):
        def snapshot_offsets(self):
            return None

        def restore_offsets(self, state):
            pass

    cfg = {"pipeline.prefetch": "on"}
    text = _error_text("torch", cfg, tmp_path / "t",
                       _NonReplayableSource(gen, total))
    assert "replayable" in text
    assert text == _error_text("jax", cfg, tmp_path / "j",
                               RefNonReplayable(gen, total))


# ------------------------------------------------------------- units

def _batch(j, n, B):
    rng = np.random.default_rng(j)
    hi = rng.integers(0, 4, n).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    ticks = rng.integers(-50, 50, n).astype(np.int32)
    vals = rng.uniform(-4, 4, n).astype(np.float32)
    return hi, lo, ticks, vals


def _plan(B=8, depth=4, value_dtype=np.float32):
    return ingest_mod.IngestPlan(td=None, slide_ticks=10, span_limit=8, B=B,
                                 staging=True, device="cpu",
                                 value_dtype=value_dtype, ring_depth=depth)


def _assert_staged(staged, hi, lo, ticks, vals, n, B):
    t_hi, t_lo, t_ts, t_v, t_ok = (t.numpy() for t in staged)
    np.testing.assert_array_equal(t_hi[:n].view(np.uint32), hi)
    np.testing.assert_array_equal(t_lo[:n].view(np.uint32), lo)
    np.testing.assert_array_equal(t_ts[:n], ticks)
    np.testing.assert_array_equal(t_v[:n], vals)
    assert t_ok[:n].all() and not t_ok[n:].any()
    assert not t_hi[n:].any() and not t_v[n:].any()


def test_rings_pad_and_carry_each_batch():
    """The staging ring's fresh tensors and the device ring's slots hold
    each batch padded to B lanes, the halves as int32 bits, the mask
    valid on the batch's prefix; a slot refilled with a shorter batch
    leaves nothing of the longer one valid."""
    B = 8
    plan = _plan(B)
    sr = ingest_mod.StagingRing(plan, 2)
    ring = ingest_mod.DeviceBatchRing(plan, 2)
    for j, n in enumerate((8, 5, 3, 7, 0)):
        hi, lo, ticks, vals = _batch(j, n, B)
        staged, ev = sr.stage(plan, hi, lo, ticks, vals, n)
        assert ev is None
        _assert_staged(staged, hi, lo, ticks, vals, n, B)
        seq, staged, ev = ring.try_publish(plan, hi, lo, ticks, vals, n,
                                           "mask", 0)
        assert seq == j and ev is None
        _assert_staged(staged, hi, lo, ticks, vals, n, B)
        assert ring.release_through(seq) == 1
    assert ring.occupancy() == 0 and ring.write_cursor() == 5


def test_ring_refuses_when_full_and_clears_on_restore():
    plan = _plan(4, depth=2)
    ring = ingest_mod.DeviceBatchRing(plan, 2)
    b = _batch(0, 4, 4)
    assert ring.try_publish(plan, *b, 4, "mask", 0)[0] == 0
    assert ring.try_publish(plan, *b, 4, "mask", 0)[0] == 1
    assert ring.try_publish(plan, *b, 4, "mask", 0) is None
    assert ring.refusals() == [1] and ring.occupancy() == 2
    assert ring.clear() == 2 and ring.occupancy() == 0
    assert ring.release_through(1) == 0          # already retired
    assert ring.try_publish(plan, *b, 4, "mask", 1)[0] == 2


def test_pipeline_epoch_reset_discards_stale_batches():
    """pause / resume bumps the epoch: the batches prepped before the
    pause are dropped, and the applied cut re-arms to the restored
    offsets."""
    polled = []

    def prep():
        polled.append(len(polled))
        return ingest_mod.PreppedBatch(end=False, n=1, offsets=len(polled))

    p = ingest_mod.IngestPipeline(prep, prefetch=True, initial_offsets=0,
                                  depth=2)
    try:
        first = p.next()
        assert first.offsets == 1
        p.mark_applied(first)
        assert p.applied_offsets() == 1
        deadline = time.monotonic() + 5
        while len(polled) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        p.pause()
        stale_epoch = first.epoch
        p.resume(applied_offsets=1)
        assert p.applied_offsets() == 1
        assert p.next().epoch == stale_epoch + 1
    finally:
        p.close()


def test_hard_death_after_resume_still_surfaces():
    """A producer that survives a pause / resume serves the new epoch; a
    later hard death (a BaseException out of the prep) surfaces as
    IngestThreadDied instead of passing for a restore respawn."""
    from flink_tpu_torch.testing.faults import ThreadKilled

    state = {"kill": False, "i": 0}

    def prep():
        if state["kill"]:
            state["kill"] = False
            raise ThreadKilled("boom")
        state["i"] += 1
        return ingest_mod.PreppedBatch(end=False, n=1, offsets=state["i"])

    p = ingest_mod.IngestPipeline(prep, prefetch=True, initial_offsets=0,
                                  depth=2)
    try:
        p.next()
        p.pause()
        assert p._thread.is_alive()
        state["kill"] = True
        p.resume(applied_offsets=0)
        deadline = time.monotonic() + 5
        while p._thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not p._thread.is_alive()
        with pytest.raises(ingest_mod.IngestThreadDied):
            for _ in range(20):
                p.next()
    finally:
        p.close()


def test_pipeline_error_then_resume_continues():
    """After delivering an error the producer parks; resume continues it
    on the same thread (the restart path)."""
    state = {"fail": True, "i": 0}

    def prep():
        state["i"] += 1
        if state["fail"]:
            state["fail"] = False
            raise RuntimeError("boom")
        return ingest_mod.PreppedBatch(end=False, n=1, offsets=state["i"])

    p = ingest_mod.IngestPipeline(prep, prefetch=True, initial_offsets=0,
                                  depth=2)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            p.next()
        thread = p._thread
        p.pause()
        p.resume(applied_offsets=0)
        pb = p.next()
        assert pb.n == 1 and pb.epoch == 1 and p._thread is thread
    finally:
        p.close()


def test_inline_pipeline_polls_on_the_caller():
    """prefetch off: ``next`` runs the prep on the caller's thread, and
    ``try_next`` never polls."""
    names = []

    def prep():
        names.append(threading.current_thread().name)
        return ingest_mod.PreppedBatch(end=False, n=0)

    p = ingest_mod.IngestPipeline(prep, prefetch=False)
    assert p.try_next() is None and not names
    p.next()
    assert names == [threading.current_thread().name]
    assert p._thread is None
    p.close()


def test_adopt_returns_the_staged_tensors_on_the_cpu():
    staged = tuple(torch.zeros(4) for _ in range(5))
    pb = ingest_mod.PreppedBatch(end=False, n=4, staged=staged)
    assert ingest_mod.adopt(pb) is staged
