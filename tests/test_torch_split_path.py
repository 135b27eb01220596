"""The split path and the dispatch modes of the port's window runner
(flink_tpu_torch/runtime/step.py, runtime/executor.py) against the
reference's on the CPU:

* the steps: the update step (insert, with the key-group fill; the
  lookup-only fast step in the hash layout), the reduced fire step (G4),
  the compact fire step (G6) and the fused update-and-fire step against
  the reference's ``build_window_update_step``,
  ``build_window_fire_reduced_step``, ``build_window_fire_step`` and
  ``build_window_step`` on a one-shard mesh, over the six-batch schedule
  of ``torch_parity`` (late and invalid lanes, keys past capacity, a ring
  rotation, negative ticks, a watermark jump with more windows due than
  F lanes);
* whole jobs in each mode — ``auto`` (the split path), ``off``, ``on``
  (the scan drain) and ``while`` with the cpu-override — with prefetch
  on and off where the mode allows it, every row equal to the
  reference's under the same configuration and to numpy's;
* the resolution: ``auto`` at ``steps-per-dispatch`` 1 runs the split
  steps (no drain), ``off`` too, and the modes' errors are the
  reference's.

Integer-valued data, so everything compares bit for bit.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import numpy as np
import pytest
import torch

from torch_parity import (
    C, F, MAXP, batches, fire_rows, jax_fields, lanes_torch, logical_state,
    sparse_batches, specs,
)
from test_torch_ingest import build_env, expected, run_job

from flink_tpu.parallel.mesh import MeshContext
from flink_tpu.runtime import step as step_ref
from flink_tpu_torch.ops import window_kernels as wkt
from flink_tpu_torch.runtime import executor as ex
from flink_tpu_torch.runtime import step as step_port

SMALL = ("counts", "window_end_ticks", "n_fires", "lane_valid",
         "value_sums")


def _stage_specs(layout):
    win_j, red_j, win_t, red_t = specs("sliding")
    spec_j = step_ref.WindowStageSpec(win=win_j, red=red_j,
                                      capacity_per_shard=C, layout=layout,
                                      precombine=True, packed=True)
    spec_t = step_port.WindowStageSpec(win=win_t, red=red_t,
                                       capacity_per_shard=C, layout=layout)
    return spec_j, spec_t, red_j, red_t


def _assert_small(fr_t, fr_j):
    for name in SMALL:
        np.testing.assert_array_equal(
            getattr(fr_t, name).numpy(), np.asarray(getattr(fr_j, name))[0],
            err_msg=name)


def test_update_and_reduced_fire_steps_match_reference():
    """The update step (with the key-group fill) then the reduced fire
    step at each batch's watermark, in the direct layout: the monitoring
    outputs, the fires and the state after every step equal the
    reference's."""
    spec_j, spec_t, _, _ = _stage_specs("direct")
    ctx = MeshContext.create(1, MAXP, devices=jax.devices()[:1])
    upd_j = step_ref.build_window_update_step(ctx, spec_j, kg_fill=True)
    fire_j = step_ref.build_window_fire_reduced_step(ctx, spec_j)
    upd_t = step_port.build_window_update_step(spec_t, MAXP, kg_fill=True)
    fire_t = step_port.build_window_fire_reduced_step(spec_t)
    sj = step_ref.init_sharded_state(ctx, spec_j)
    st = step_port.init_shard_state(spec_t, MAXP, "cpu")
    fired = 0
    for hi, lo, ts, vals, valid, wm, _clear in batches(21):
        wmv = np.full(1, wm, np.int32)
        sj, (ovf_j, act_j, kgf_j) = upd_j(sj, hi, lo, ts, vals, valid, wmv)
        st, (ovf_t, act_t, kgf_t) = upd_t(
            st, *lanes_torch(hi, lo, ts, vals, valid),
            torch.tensor(int(wm), dtype=torch.int32))
        assert int(ovf_t) == int(np.asarray(ovf_j)[0])
        assert int(act_t) == int(np.asarray(act_j)[0])
        np.testing.assert_array_equal(kgf_t.numpy(), np.asarray(kgf_j)[0])
        sj, fr_j = fire_j(sj, wmv)
        st, fr_t = fire_t(st, torch.tensor(int(wm), dtype=torch.int32))
        _assert_small(fr_t, fr_j)
        fired += int(fr_t.counts.sum())
        want = jax_fields(jax.tree_util.tree_map(
            lambda x: np.asarray(x)[0], sj))
        got = wkt.state_to_numpy(st)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert fired > 0


def test_fast_step_and_compact_fire_match_reference():
    """In the hash layout: the insert step on the first two batches, the
    lookup-only fast step on the rest (its misses counted, as the
    reference's), and the compact fire step's rows — sorted by key, the
    two tables may place keys at other slots — against the reference's,
    with the logical state after each step."""
    spec_j, spec_t, red_j, red_t = _stage_specs("hash")
    ctx = MeshContext.create(1, MAXP, devices=jax.devices()[:1])
    steps_j = [step_ref.build_window_update_step(ctx, spec_j, insert=i)
               for i in (True, False)]
    steps_t = [step_port.build_window_update_step(spec_t, MAXP, insert=i)
               for i in (True, False)]
    fire_j = step_ref.build_window_fire_step(ctx, spec_j)
    fire_t = step_port.build_window_fire_step(spec_t)
    sj = step_ref.init_sharded_state(ctx, spec_j)
    st = step_port.init_shard_state(spec_t, MAXP, "cpu")
    n_rows = 0
    for i, (hi, lo, ts, vals, valid, wm, _c) in enumerate(
            sparse_batches(23)):
        fast = int(i >= 2)
        wmv = np.full(1, wm, np.int32)
        sj, (_o, act_j, _k) = steps_j[fast](sj, hi, lo, ts, vals, valid,
                                             wmv)
        st, (_o, act_t, _k) = steps_t[fast](
            st, *lanes_torch(hi, lo, ts, vals, valid),
            torch.tensor(int(wm), dtype=torch.int32))
        assert int(act_t) == int(np.asarray(act_j)[0])
        sj, cf_j = fire_j(sj, wmv)
        st, cf_t = fire_t(st, torch.tensor(int(wm), dtype=torch.int32))
        _assert_small(cf_t, cf_j)
        sub_j = jax.tree_util.tree_map(lambda x: np.asarray(x)[0], cf_j)
        for f in range(cf_t.counts.shape[0]):
            (kt, vt), _ = fire_rows(cf_t, f)
            (kj, vj), _ = fire_rows(sub_j, f)
            np.testing.assert_array_equal(kt, kj)
            np.testing.assert_array_equal(vt, vj)
            n_rows += len(kt)
        want = logical_state(jax_fields(jax.tree_util.tree_map(
            lambda x: np.asarray(x)[0], sj)), red_j)
        got = logical_state(wkt.state_to_numpy(st), red_t)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert n_rows > 0


def test_window_step_matches_reference():
    """``build_window_step``: one update and one advance a call, its
    compact fires in slot order, the state after each call."""
    spec_j, spec_t, _, _ = _stage_specs("direct")
    ctx = MeshContext.create(1, MAXP, devices=jax.devices()[:1])
    step_j = step_ref.build_window_step(ctx, spec_j)
    step_t = step_port.build_window_step(spec_t, MAXP)
    sj = step_ref.init_sharded_state(ctx, spec_j)
    st = step_port.init_shard_state(spec_t, MAXP, "cpu")
    n_rows = 0
    for hi, lo, ts, vals, valid, wm, _c in batches(29):
        sj, fr_j = step_j(sj, hi, lo, ts, vals, valid,
                          np.full(1, wm, np.int32))
        st, cf_t = step_t(st, *lanes_torch(hi, lo, ts, vals, valid),
                          torch.tensor(int(wm), dtype=torch.int32))
        # the reference's step returns the dense FireResult: rows are
        # its emitted slots in slot order
        fr_j = jax.tree_util.tree_map(lambda x: np.asarray(x)[0], fr_j)
        np.testing.assert_array_equal(cf_t.lane_valid.numpy(),
                                      fr_j.lane_valid)
        np.testing.assert_array_equal(cf_t.window_end_ticks.numpy(),
                                      fr_j.window_end_ticks)
        for f in range(F):
            slots = np.nonzero(fr_j.mask[f])[0]
            n = int(cf_t.counts[f])
            assert n == len(slots)
            np.testing.assert_array_equal(
                cf_t.key_lo[f, :n].numpy().view(np.uint32),
                np.asarray(sj.table.keys)[0, slots, 1])
            np.testing.assert_array_equal(
                cf_t.values[f, :n].numpy(),
                np.asarray(fr_j.values)[f, slots].reshape(n))
            n_rows += n
        want = jax_fields(jax.tree_util.tree_map(
            lambda x: np.asarray(x)[0], sj))
        got = wkt.state_to_numpy(st)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert n_rows > 0


# ------------------------------------------------------------ jobs

JOB_MODES = {
    "auto": {},
    "off": {"pipeline.resident-loop": "off"},
    "on": {"pipeline.resident-loop": "on", "pipeline.ring-depth": 4},
    "while": {"pipeline.resident-loop": "while", "pipeline.ring-depth": 4,
              "pipeline.while-drain.cpu-override": "on"},
}


@pytest.mark.parametrize("prefetch", ["on", "off"])
@pytest.mark.parametrize("mode", sorted(JOB_MODES))
def test_every_mode_gives_the_reference_rows(mode, prefetch, monkeypatch):
    """Each mode and prefetch setting on both packages: the port's rows
    equal the reference's and numpy's; the split modes dispatch no drain,
    the drain modes every steady batch through a drain. ``on`` and
    ``while`` need prefetch, and raise the reference's error without."""
    cfg = {**JOB_MODES[mode], "pipeline.prefetch": prefetch}
    total = 4096
    if prefetch == "off" and mode in ("on", "while"):
        with pytest.raises(ValueError) as got:
            run_job(build_env(**cfg), total)
        with pytest.raises(ValueError) as want:
            run_job(build_env(pkg="jax", **cfg), total, pkg="jax")
        assert str(got.value) == str(want.value)
        return
    updates = []
    run_update = ex._WindowJob.run_update

    def spy(job, staged, wm_ms, pb):
        updates.append(wm_ms)
        run_update(job, staged, wm_ms, pb)

    monkeypatch.setattr(ex._WindowJob, "run_update", spy)
    got, job = run_job(build_env(**cfg), total)
    want, _ = run_job(build_env(pkg="jax", **cfg), total, pkg="jax")
    assert got == want == expected(total)
    m = job.metrics
    if mode in ("auto", "off"):
        assert m.resident_drains == 0 and len(updates) == m.steps == 16
        assert m.fire_steps > 0
    else:
        assert m.resident_drains > 0 and not updates


def test_modes_resolve_with_the_reference_errors():
    """Invalid knob values: the port raises the reference's texts, and
    ``pipeline.data-parallel: on`` without the resident loop too; with it
    the sharded drain runs (here over one shard), with the reference's
    rows and route counts. ``steps-per-dispatch`` 2 runs (its megasteps:
    tests/test_torch_megastep.py)."""
    for cfg in ({"pipeline.prefetch": "sometimes"},
                {"pipeline.device-staging": "sometimes"},
                {"pipeline.resident-loop": "always"},
                {"pipeline.fused-fire": "sometimes"},
                {"pipeline.device-staging": "off",
                 "pipeline.resident-loop": "on"},
                {"pipeline.data-parallel": "on"},
                {"pipeline.data-parallel": "sometimes"},
                {"pipeline.shard-capacity-factor": 0.5}):
        with pytest.raises(ValueError) as got:
            run_job(build_env(**cfg), 512)
        with pytest.raises(ValueError) as want:
            run_job(build_env(pkg="jax", **cfg), 512, pkg="jax")
        assert str(got.value) == str(want.value), cfg
    dp = {"pipeline.data-parallel": "on", "pipeline.resident-loop": "on"}
    got, job = run_job(build_env(**dp), 4096)
    want, ref = run_job(build_env(pkg="jax", **dp), 4096, pkg="jax")
    assert got == want == expected(4096)
    # which batches the producer planned before the stage's setup is a
    # race on both sides: each drained some through the sharded route
    assert job.metrics.steps_sharded > 0 and ref.metrics.steps_sharded > 0
    got, _job = run_job(build_env(**{"pipeline.steps-per-dispatch": 2}), 512)
    assert got == expected(512)


def test_resolution_table():
    """``_resolve_dispatch`` as the reference resolves the three knobs:
    auto and off the split path, on the scan drain, while the
    while-drain on CUDA and on the CPU only with the override, a chained
    job's auto its drain whenever staging exists; max-slots 0 is twice
    the ring depth, never below it."""
    from flink_tpu_torch.core.config import Configuration
    from flink_tpu_torch.runtime.sources import GeneratorSource

    src = GeneratorSource(lambda o, n: ({}, None), total=1)

    def res(chained=False, device="cpu", **cfg):
        d = ex._resolve_dispatch(Configuration(cfg), chained, False, src,
                                 torch.device(device))
        return (d.prefetch, d.staging, d.resident, d.while_drain,
                d.max_slots)

    assert res() == (True, True, False, False, 32)
    assert res(**{"pipeline.resident-loop": "off"})[2] is False
    assert res(**{"pipeline.resident-loop": "on"})[2:4] == (True, False)
    w = {"pipeline.resident-loop": "while"}
    assert res(**w)[2:4] == (True, False)
    assert res(device="cuda", **w)[2:4] == (True, True)
    assert res(**w, **{"pipeline.while-drain.cpu-override": "on"})[2:4] \
        == (True, True)
    assert res(chained=True)[2] is True
    assert res(chained=True, **{"pipeline.prefetch": "off"})[2] is False
    assert res(chained=True, device="cuda", **w)[2:4] == (True, False)
    assert res(**{"pipeline.ring-depth": 8,
                  "pipeline.while-drain.max-slots": 3})[4] == 8
    assert res(**{"pipeline.while-drain.max-slots": 40})[4] == 40
