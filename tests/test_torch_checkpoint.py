"""Checkpoints, restore and restarts of flink_tpu_torch against flink_tpu
and numpy, on the CPU.

* state level: the logical entries ``stage_window_state`` /
  ``extract_entries`` give for one state carried from the reference
  (direct and hash; packed and split planes; sum, max, mean, a generic
  reduce and HyperLogLog) equal the reference's snapshot of it, and
  ``restore_window_state`` rebuilds from them what the reference's
  restore rebuilds;
* job level: the cuts a spilling job writes (every step, keys past
  capacity, so the spill stores ride the entries) equal the reference's
  cuts of the same job; a ``flink_tpu`` checkpoint restores into the port
  and continues to the same output, and the reverse;
* restarts: a job crashed at ``step.drain`` (and at the checkpoint write)
  and restarted by each restart strategy ends with the uncrashed run's
  (key, window) -> value map and numpy's, for every window reduce the
  port runs; the refusals name their ROADMAP items.

The reference runs with its gated knobs forced on (``torch_parity``), and
every value is an integer, so every comparison is exact.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import (
    C, MAXP, R, SLIDE, F, batches, jax_fields, key_halves, reduce_pair,
    reduce_specs, reduce_values, sketch_batches, sparse_batches,
)

from flink_tpu.parallel.mesh import MeshContext
from flink_tpu.runtime import checkpoint as ckpt_ref
from flink_tpu.runtime import step as step_ref
from flink_tpu.ops import window_kernels as wkj
from flink_tpu_torch.runtime import checkpoint as ckpt
from flink_tpu_torch.runtime import step as step_port
from flink_tpu_torch.ops import window_kernels as wkt
from flink_tpu_torch.testing import faults
from flink_tpu_torch.testing.faults import FaultInjector, FaultRule

# ------------------------------------------------------------ state level

# (layout, reduce kind, packed planes on the reference side)
STATE_CASES = {
    "direct-sum-packed": ("direct", "sum", True),
    "hash-sum-split": ("hash", "sum", False),
    "hash-max-packed": ("hash", "max", True),
    "direct-mean-packed": ("direct", "mean", True),
    "hash-generic-split": ("hash", "gsum", False),
    "hash-hll-split": ("hash", "hll", False),
}


def _reduces(kind):
    if kind == "hll":
        red_j, red_t = reduce_specs("hll")
        return red_j, red_t
    red_j, red_t, _ = reduce_pair(kind)
    return red_j, red_t


def _sorted_entries(e: dict) -> dict:
    words = (np.asarray(e["key_hi"]).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(e["key_lo"]).astype(np.uint64)
    order = np.lexsort((np.asarray(e["pane"]), words))
    return {k: np.asarray(v)[order] for k, v in e.items()}


def assert_entries_equal(got: dict, want: dict) -> None:
    g, w = _sorted_entries(got), _sorted_entries(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].shape == w[k].shape, (k, g[k].shape, w[k].shape)
        np.testing.assert_array_equal(g[k], w[k].astype(g[k].dtype),
                                      err_msg=k)


def _reference_state(case):
    """The reference's state after the six-batch schedule (updates only,
    watermark advanced after each), its specs and the port's."""
    layout, kind, packed = STATE_CASES[case]
    red_j, red_t = _reduces(kind)
    win_j = wkj.WindowSpec(2 * SLIDE, SLIDE, ring=R, fires_per_step=F)
    win_t = wkt.WindowSpec(2 * SLIDE, SLIDE, ring=R, fires_per_step=F)
    sj = wkj.init_state(C, 16, win_j, red_j, layout=layout,
                        n_key_groups=MAXP, packed=packed)
    sketch = kind == "hll"
    sched = (sketch_batches(3) if sketch else
             sparse_batches(3) if layout == "hash" else batches(3))

    @jax.jit
    def upd(st, hi, lo, ts, vals, valid):
        return wkj.update(st, win_j, red_j, hi, lo, ts, vals, valid,
                          insert=True, direct=layout == "direct",
                          precombine=not sketch)[0]

    for i, (hi, lo, ts, vals, valid, wm, _clear) in enumerate(sched):
        if not sketch:
            vals = reduce_values(kind, vals, i)
        sj = upd(sj, hi, lo, ts, vals, valid)
        sj = dataclasses.replace(sj, watermark=jnp.int32(wm))
    spec_j = step_ref.WindowStageSpec(win=win_j, red=red_j,
                                      capacity_per_shard=C, layout=layout,
                                      packed=packed)
    spec_t = step_port.WindowStageSpec(win=win_t, red=red_t,
                                       capacity_per_shard=C, layout=layout)
    return sj, spec_j, spec_t


def _stacked(sj):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None], sj)


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_snapshot_and_restore_match_reference(case):
    """The port's snapshot of a state carried from the reference equals
    the reference's snapshot, entry for entry and scalar for scalar; the
    port restores the reference's entries, and the reference the port's,
    into states whose snapshots give the same entries back (the direct
    layout's restored states equal field for field)."""
    sj, spec_j, spec_t = _reference_state(case)
    st = wkt.state_from_numpy(jax_fields(sj), sj.packed, device="cpu",
                              layout=spec_t.layout, probe_len=16,
                              red=spec_t.red)
    e_ref, s_ref = ckpt_ref.snapshot_window_state(_stacked(sj), spec_j.win,
                                                  red=spec_j.red)
    e_port, s_port = ckpt.snapshot_window_state(st, spec_t.win, spec_t.red)
    assert len(e_ref["pane"]) > 0
    assert_entries_equal(e_port, e_ref)
    assert s_port == s_ref
    # restore on both sides from the other's entries
    ctx = MeshContext.create(1, MAXP)
    # the reference's four claim rounds may leave a key out of its table
    # (ROADMAP queue 3); what it leaves out comes back as leftover
    left = []
    rj = ckpt_ref.restore_window_state(e_port, s_port, ctx, spec_j,
                                       leftover=left)
    rt = ckpt.restore_window_state(e_ref, s_ref, spec_t, MAXP, "cpu")
    e_rj, s_rj = ckpt_ref.snapshot_window_state(rj, spec_j.win,
                                                red=spec_j.red)
    e_rt, s_rt = ckpt.snapshot_window_state(rt, spec_t.win, spec_t.red)
    assert_entries_equal(e_rt, e_ref)
    for l_hi, l_lo, l_pane, l_val in left:
        e_rj = {"key_hi": np.concatenate([e_rj["key_hi"], l_hi]),
                "key_lo": np.concatenate([e_rj["key_lo"], l_lo]),
                "pane": np.concatenate([e_rj["pane"], l_pane]),
                "value": np.concatenate([e_rj["value"], l_val]),
                "fresh": np.concatenate([e_rj["fresh"],
                                         np.zeros(len(l_pane), bool)])}
    assert_entries_equal(e_rj, e_ref)
    assert s_rt == s_rj == s_ref
    if spec_t.layout == "direct":
        want = jax_fields(jax.tree_util.tree_map(lambda a: a[0], rj))
        got = wkt.state_from_numpy(want, rj.packed, device="cpu",
                                   layout="direct", red=spec_t.red)
        for name, w in wkt.state_to_numpy(got).items():
            np.testing.assert_array_equal(wkt.state_to_numpy(rt)[name], w,
                                          err_msg=name)


def test_restore_spills_what_the_table_cannot_hold():
    """Entries of keys past a direct table's capacity go to ``leftover``
    for the spill tier, and without a list the restore raises."""
    _sj, _spec_j, spec_t = _reference_state("direct-sum-packed")
    keys = np.array([3, 7, C + 5, C + 9], np.int64)
    hi, lo = key_halves(keys)
    entries = {"key_hi": hi, "key_lo": lo,
               "pane": np.array([2, 2, 3, 2], np.int32),
               "value": np.array([1.0, 2.0, 4.0, 8.0], np.float32),
               "fresh": np.zeros(4, bool)}
    scalars = {"watermark": 25, "fired_through": 1, "max_pane": 3,
               "min_pane": 2, "dropped_late": 0, "dropped_capacity": 0}
    leftover = []
    st = ckpt.restore_window_state(entries, scalars, spec_t, MAXP, "cpu",
                                   leftover=leftover)
    (l_hi, l_lo, l_pane, l_val), = leftover
    assert l_lo.tolist() == [C + 5, C + 9] and l_val.tolist() == [4.0, 8.0]
    e, s = ckpt.snapshot_window_state(st, spec_t.win, spec_t.red)
    assert sorted(e["key_lo"].tolist()) == [3, 7] and s == scalars
    with pytest.raises(RuntimeError, match="does not fit"):
        ckpt.restore_window_state(entries, scalars, spec_t, MAXP, "cpu")


# ------------------------------------------------------------ job level

N_KEYS = 512
WINDOW_MS = 1000
TOTAL = 4096


def gen(offset, n):
    """Keys past the job's capacity (512 keys, 256 slots) so the spill
    tier holds state at every cut; four 1 s windows."""
    idx = np.arange(offset, offset + n, dtype=np.int64)
    keys = (idx * 48271) % N_KEYS
    return {"key": keys, "value": ((idx % 7) + 1).astype(np.float32)}, \
        (idx * 4 * WINDOW_MS) // TOTAL


def expected(total=TOTAL):
    cols, ts = gen(0, total)
    out = {}
    for k, t, v in zip(cols["key"].tolist(), ts.tolist(),
                       cols["value"].tolist()):
        we = (t // WINDOW_MS + 1) * WINDOW_MS
        out[(k, we)] = out.get((k, we), 0.0) + v
    return out


def _env(pkg, layout, ckpt_dir=None, interval=1, config=None,
         capacity=256):
    opts = {"keys.reverse-map": True, "pipeline.ring-depth": 2,
            "state.backend.layout": layout, **(config or {})}
    if pkg == "jax":
        from flink_tpu import StreamExecutionEnvironment
        from flink_tpu.core.config import Configuration
        from flink_tpu.core.time import TimeCharacteristic
        kw = {}
        opts.update({"pipeline.update-precombine": "on",
                     "state.packed-planes": "on",
                     "pipeline.resident-loop": "on"})
    else:
        from flink_tpu_torch import StreamExecutionEnvironment
        from flink_tpu_torch.core.config import Configuration
        from flink_tpu_torch.core.time import TimeCharacteristic
        # the resident drain, whose step.drain seam the crashes take
        opts.setdefault("pipeline.resident-loop", "on")
        kw = {"device": "cpu"}
    env = StreamExecutionEnvironment(Configuration(opts), **kw)
    env.set_parallelism(1)
    env.set_max_parallelism(8)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(capacity)
    env.batch_size = 256
    if ckpt_dir is not None:
        env.enable_checkpointing(interval, str(ckpt_dir))
    return env


def _run(env, pkg, total=TOTAL, restore_from=None, source=None,
         build=None):
    if pkg == "jax":
        from flink_tpu.runtime.sinks import CollectSink
        from flink_tpu.runtime.sources import GeneratorSource
    else:
        from flink_tpu_torch.runtime.sinks import CollectSink
        from flink_tpu_torch.runtime.sources import GeneratorSource
    sink = CollectSink()
    stream = (env.add_source(source or GeneratorSource(gen, total=total))
              .key_by(lambda c: c["key"]).time_window(WINDOW_MS))
    (build(stream) if build else stream.sum(lambda c: c["value"])) \
        .add_sink(sink)
    job = env.execute("ckpt-job", restore_from=restore_from)
    rows = {}
    for r in sink.results:
        k = (int(r.key), int(r.window_end_ms))
        v = np.asarray(r.value, np.float64).tolist()
        # a window re-emitted after a restore carries the same value
        assert rows.get(k, v) == v, (k, rows[k], v)
        rows[k] = v
    return job, rows


def _cuts(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.startswith("chk-"):
            p = os.path.join(directory, name)
            with np.load(os.path.join(p, "entries.npz")) as z:
                entries = {k: z[k] for k in z.files}
            with open(os.path.join(p, "meta.json")) as f:
                meta = json.load(f)
            with open(os.path.join(p, "aux.pkl"), "rb") as f:
                aux = pickle.load(f)
            out[int(name[4:])] = (entries, meta, aux)
    return out


def numpy_cut(offset: int, fired_through: int) -> dict:
    """The entries a cut after ``offset`` events must hold: numpy's sum
    of each (key, pane) of those events whose 1 s pane has not fired."""
    cols, ts = gen(0, offset)
    pane = ts // WINDOW_MS
    keep = pane > fired_through
    cells = {}
    for k, p, v in zip(cols["key"][keep].tolist(), pane[keep].tolist(),
                       cols["value"][keep].tolist()):
        cells[(k, p)] = cells.get((k, p), 0.0) + v
    keys = np.array([k for k, _ in cells], np.int64)
    hi, lo = key_halves(keys)
    return {"key_hi": hi, "key_lo": lo,
            "pane": np.array([p for _, p in cells], np.int32),
            "value": np.array(list(cells.values()), np.float32),
            "fresh": np.zeros(len(cells), bool)}


@pytest.mark.parametrize("layout", ["direct", "hash"])
def test_checkpoint_cuts_match_reference(tmp_path, layout):
    """A spilling job checkpointing every batch on both packages. Every
    cut of the port holds numpy's entries for the events before its source
    offset — device rows and spill stores folded together — and every cut
    of the reference (it counts a batch at its drain, so it cuts every
    other batch here) has a port cut at the same offset with the same
    entries, scalars and aux payload. The rows equal numpy's; the port's
    history records each checkpoint's bytes and sync time."""
    retain = {"checkpoint.retain": 100}
    _job_j, rows_j = _run(_env("jax", layout, tmp_path / "j", config=retain),
                          "jax")
    # the port polls inline on its split path, so it cuts at every batch
    # and its key map holds exactly the keys before each cut
    job_t, rows_t = _run(_env("torch", layout, tmp_path / "t",
                              config={**retain, "pipeline.prefetch": "off",
                                      "pipeline.resident-loop": "off"}),
                         "torch")
    assert rows_t == rows_j == expected()
    assert job_t.metrics.spilled_records > 0
    cuts_j, cuts_t = _cuts(tmp_path / "j"), _cuts(tmp_path / "t")
    assert len(cuts_t) == TOTAL // 256
    by_offset = {}
    spilled = 0
    for cid, (et, mt, at) in cuts_t.items():
        assert mt["checkpoint_id"] == cid
        assert_entries_equal(et, numpy_cut(at["source_offsets"],
                                           mt["fired_through"]))
        by_offset[at["source_offsets"]] = (et, mt, at)
        spilled += int((et["key_lo"] >= 256).sum())
    assert spilled > 0              # the spill stores rode the entries
    assert len(cuts_j) >= 8
    for ej, mj, aj in cuts_j.values():
        et, mt, at = by_offset[aj["source_offsets"]]
        assert_entries_equal(et, ej)
        for k in ckpt.SCALARS + ("format_version",):
            assert mt[k] == mj[k], k
        # the reference's prefetch encodes keys ahead of its cut, so its
        # key map may count more; the port's counts the keys seen
        assert {k: v for k, v in at["aux"].items() if k != "codec_rev_count"} \
            == {k: v for k, v in aj["aux"].items() if k != "codec_rev_count"}
        seen = len(np.unique(gen(0, at["source_offsets"])[0]["key"]))
        assert at["aux"]["codec_rev_count"] == seen \
            <= aj["aux"]["codec_rev_count"]
    stats = job_t.metrics.checkpoint_stats
    assert [r["id"] for r in stats] == sorted(cuts_t)
    assert all(r["bytes"] > 0 and r["sync_ms"] > 0 for r in stats)


@pytest.mark.parametrize("layout", ["direct", "hash"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_across_packages(tmp_path, layout, writer):
    """One package runs the first half of the stream, checkpointing every
    batch; the other restores its newest cut and runs the rest (the
    reference's rescale test, at one shard). The windows the first phase
    left open come out of the second corrected, and the merged view equals
    numpy's; a window the restore re-emits carries its final value."""
    reader = "torch" if writer == "jax" else "jax"
    _, rows1 = _run(_env(writer, layout, tmp_path / "chk"), writer,
                    total=TOTAL // 2)
    job2, rows2 = _run(_env(reader, layout), reader,
                       restore_from=str(tmp_path / "chk"))
    assert {**rows1, **rows2} == expected()
    assert any(rows1.get(k) != v for k, v in rows2.items())
    if reader == "torch":
        assert job2.state.layout == layout


def test_restore_reads_a_reference_pickle_without_the_reference(tmp_path):
    """``aux.pkl`` is read by an unpickler that maps a ``flink_tpu.*``
    class to the port's module of the same path."""
    storage = ckpt.CheckpointStorage(str(tmp_path))
    empty = {"key_hi": np.zeros(0, np.uint32),
             "key_lo": np.zeros(0, np.uint32),
             "pane": np.zeros(0, np.int32),
             "value": np.zeros(0, np.float32), "fresh": np.zeros(0, bool)}
    scalars = dict.fromkeys(ckpt.SCALARS, 0)
    storage.write(1, empty, scalars, 5, {"x": 1})
    from flink_tpu.runtime.sources import GeneratorSource as RefSource
    with open(os.path.join(storage.path(1), "aux.pkl"), "wb") as f:
        pickle.dump({"source_offsets": 5, "aux": {"cls": RefSource}}, f)
    _e, s, off, aux = storage.read(1)
    from flink_tpu_torch.runtime.sources import GeneratorSource
    assert aux["cls"] is GeneratorSource and off == 5 and s == scalars
    assert storage.latest() == 1 and storage.list_checkpoints() == [1]


class _FailingSource:
    """A GeneratorSource (of either package's port) that raises once when
    its offset crosses ``fail_at`` (the reference's FailingSource)."""

    def __new__(cls, fail_at, total=TOTAL):
        from flink_tpu_torch.runtime.sources import GeneratorSource

        class Failing(GeneratorSource):
            failed = False

            def poll(self, max_records):
                out = super().poll(max_records)
                if not self.failed and self.offset >= fail_at:
                    self.failed = True
                    raise RuntimeError("injected failure")
                return out

        return Failing(gen, total=total)


RESTARTS = {
    "fixed-delay": {"restart-strategy": "fixed-delay",
                    "restart-strategy.fixed-delay.attempts": 2,
                    "restart-strategy.fixed-delay.delay": 0},
    "failure-rate": {"restart-strategy": "failure-rate",
                     "restart-strategy.failure-rate.max-failures": 2},
    "exponential-backoff": {
        "restart-strategy": "exponential-backoff",
        "restart-strategy.exponential-backoff.initial-delay": 0.0},
}


@pytest.mark.parametrize("point", ["step.drain", "ckpt.entries.write",
                                   "ckpt.publish", "source"])
@pytest.mark.parametrize("strategy", sorted(RESTARTS))
def test_crash_restarts_exactly_once(tmp_path, strategy, point):
    """A job checkpointing every 2 batches crashes once — in a drain
    dispatch, in the checkpoint write (before any file, before the
    publish) or in the source — and the restart strategy restores the
    newest cut in-process: the (key, window) -> value map equals the
    uncrashed run's and numpy's, one restart is counted, and its recovery
    time is recorded."""
    for layout in ("direct", "hash"):
        env = _env("torch", layout, tmp_path / f"{layout}-chk", interval=2,
                   config=RESTARTS[strategy])
        if point == "source":
            job, rows = _run(env, "torch", source=_FailingSource(TOTAL // 2))
        else:
            inj = FaultInjector([FaultRule(point, exc=OSError("injected"),
                                           at=4)])
            with faults.active(inj):
                job, rows = _run(env, "torch")
            assert inj.fired_at(point)
        assert rows == expected()
        assert job.metrics.restarts == 1
        assert len(job.metrics.recovery_ms) == 1


# every single-stage window job the port runs: the reduce, its extractor
# and its stage knobs
JOB_KINDS = {
    "count": (lambda s: s.count(), {}),
    "min": (lambda s: s.min(lambda c: c["value"]), {}),
    "max": (lambda s: s.max(lambda c: c["value"]), {}),
    "mean": (lambda s: s.mean(lambda c: c["value"]), {}),
    "reduce": (lambda s: s.reduce(lambda a, b: a + b,
                                  lambda c: c["value"]), {}),
    "distinct": (lambda s: s.distinct_count(lambda c: c["value"],
                                            precision=6),
                 {"state.probe-len": 64}),
    "lateness": (lambda s: s.allowed_lateness(500).sum(
        lambda c: c["value"]), {}),
}


@pytest.mark.parametrize("kind", sorted(JOB_KINDS))
def test_every_window_reduce_restarts_exactly_once(tmp_path, kind):
    """Count, min, max, mean, a generic reduce, HyperLogLog and a lateness
    sum, crashed at the 5th drain and restarted: the same (key, window) ->
    value map as the uncrashed run (the spilling ones in the direct
    layout, the rest at a capacity that holds every key)."""
    build, config = JOB_KINDS[kind]
    spill = kind in ("count", "min", "max", "mean")
    capacity = 256 if spill else 1024
    layout = "direct" if spill else "hash"
    cfg = dict(config, **RESTARTS["fixed-delay"])
    _, want = _run(_env("torch", layout, config=cfg, capacity=capacity),
                   "torch", build=build)
    inj = FaultInjector([FaultRule("step.drain", exc=OSError("injected"),
                                   at=4)])
    with faults.active(inj):
        job, got = _run(_env("torch", layout, tmp_path / "chk", config=cfg,
                             capacity=capacity), "torch", build=build)
    assert got == want and job.metrics.restarts == 1
    assert job.metrics.checkpoint_stats


def test_failure_without_checkpoint_raises(tmp_path):
    """No checkpoint to restart from: the failure escapes, whatever the
    strategy; a restore from an empty directory raises."""
    env = _env("torch", "direct", config=RESTARTS["fixed-delay"])
    with pytest.raises(RuntimeError, match="injected failure"):
        _run(env, "torch", source=_FailingSource(1024))
    env = _env("torch", "direct")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _run(env, "torch", restore_from=str(tmp_path))


def test_restart_budget_runs_out():
    """A fixed-delay strategy of one attempt takes one failure and
    declines the second (the reference's RestartStrategy, copied)."""
    rs = ckpt.RestartStrategy.fixed_delay(1)
    assert rs.should_restart() and not rs.should_restart()
    rs = ckpt.RestartStrategy.failure_rate(2, 60.0)
    assert rs.should_restart() and rs.should_restart()
    assert not rs.should_restart()
    rs = ckpt.RestartStrategy.exponential_backoff(0.0, jitter=0.0)
    assert all(rs.should_restart() for _ in range(5))
    assert rs.delays == [0.0] * 5
    assert not ckpt.RestartStrategy.none().should_restart()


@pytest.mark.parametrize("config, item", [
    ({"checkpoint.mode": "incremental"}, "item 13"),
    ({"checkpoint.async": True}, "item 13"),
    ({"checkpoint.local.enabled": True}, "item 13"),
])
def test_unported_checkpoint_modes_raise(tmp_path, config, item):
    env = _env("torch", "direct", tmp_path, config=config)
    with pytest.raises(NotImplementedError, match=item):
        _run(env, "torch")


def test_keyed_stage_checkpoints_still_raise(tmp_path):
    """Session, count-window and rolling stages keep refusing checkpoints
    (ROADMAP queue 1, item 6)."""
    from flink_tpu_torch.runtime.sinks import CollectSink
    from flink_tpu_torch.runtime.sources import GeneratorSource
    env = _env("torch", "hash", tmp_path)
    (env.add_source(GeneratorSource(gen, total=512))
     .key_by(lambda c: c["key"]).count_window(4).sum(lambda c: c["value"])
     .add_sink(CollectSink()))
    with pytest.raises(NotImplementedError, match="item 6"):
        env.execute("count-window")
