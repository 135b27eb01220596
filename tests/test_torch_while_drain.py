"""The port's while-drain (flink_tpu_torch/runtime/step.py
``build_window_while_drain``, ``pipeline.resident-loop: while``) against
the reference's ``build_window_while_drain`` on a one-shard CPU mesh, and
the mirror of the reference's tests/test_while_drain.py:

* the drain itself at ``run_while_drain``'s spec cut small (C = 4,096,
  B = 512, ring 9, 4 fires a step, max_slots 8) under three cursors —
  frozen below ``staged``, equal to it, past ``max_slots`` —: the state
  planes, the [max_slots, Ft] fire stacks (zero past ``consumed``),
  ``consumed`` and the [max_slots, 9] flight recorder are equal, and a
  cursor that moves while the drain runs (a publish mid-drain) extends
  the dispatch in flight;
* whole jobs: exact, with no more dispatches than the scan drain; the
  CPU gate (``while`` is the scan drain on the CPU unless
  ``pipeline.while-drain.cpu-override: on``); ``max-slots`` bounds each
  dispatch, not the results; ``while`` needs staging; a mid-drain crash
  restores exactly-once;
* the cursor race: a thread publishes into the device ring while the
  consumer retires slots from write-cursor snapshots (while) or from the
  published sequences (scan): every slot retired once, the snapshots
  monotone.

Integer-valued data, so everything compares bit for bit.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import threading
import time

import jax
import numpy as np
import pytest
import torch

from torch_parity import jax_fields
from test_torch_ingest import build_env, expected, run_job

from flink_tpu.ops import window_kernels as wkj
from flink_tpu.parallel.mesh import MeshContext
from flink_tpu.runtime import step as step_ref
from flink_tpu_torch.ops import window_kernels as wkt
from flink_tpu_torch.runtime import executor as ex
from flink_tpu_torch.runtime import ingest as ingest_mod
from flink_tpu_torch.runtime import step as step_port
from flink_tpu_torch.testing import faults
from flink_tpu_torch.testing.faults import FaultInjector, FaultRule

C, B, RING, F, MAX_SLOTS, MAXP = 4096, 512, 9, 4, 8, 128
SLIDE, SIZE = 10, 20
BASE = 100


def _specs(layout="direct"):
    win_j = wkj.WindowSpec(SIZE, SLIDE, ring=RING, fires_per_step=F)
    red_j = wkj.ReduceSpec("sum", jax.numpy.float32)
    spec_j = step_ref.WindowStageSpec(win=win_j, red=red_j,
                                      capacity_per_shard=C, layout=layout,
                                      precombine=True, packed=True)
    spec_t = step_port.WindowStageSpec(
        win=wkt.WindowSpec(SIZE, SLIDE, ring=RING, fires_per_step=F),
        red=wkt.ReduceSpec("sum"), capacity_per_shard=C, layout=layout)
    return spec_j, spec_t


def _slots(seed):
    """MAX_SLOTS batches of B lanes: keys in [0, C), a few invalid lanes,
    each batch two to four panes past the last, watermarks that make
    several windows due a slot."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(MAX_SLOTS):
        hi = np.zeros(B, np.uint32)
        lo = rng.integers(0, C, B).astype(np.uint32)
        lo[:32] = rng.integers(0, 8, 32)              # duplicate-heavy
        p0 = 3 * i
        ts = rng.integers(p0 * SLIDE, (p0 + 3) * SLIDE, B).astype(np.int32)
        vals = rng.integers(1, 9, B).astype(np.float32)
        valid = rng.random(B) < 0.9
        out.append((hi, lo, ts, vals, valid, np.int32((p0 + 2) * SLIDE)))
    return out


def _lanes(b):
    hi, lo, ts, vals, valid = b[:5]
    return (torch.from_numpy(hi.view(np.int32).copy()),
            torch.from_numpy(lo.view(np.int32).copy()),
            torch.from_numpy(ts.copy()), torch.from_numpy(vals.copy()),
            torch.from_numpy(valid.copy()))


FIRE_FIELDS = ("counts", "window_end_ticks", "n_fires", "lane_valid",
               "value_sums")


@pytest.mark.parametrize("case", ["frozen_below", "equal", "past_max"])
def test_while_drain_matches_reference(case):
    cursor, staged = {"frozen_below": (BASE + 3, 6),
                      "equal": (BASE + 6, 6),
                      "past_max": (BASE + 20, MAX_SLOTS)}[case]
    spec_j, spec_t = _specs()
    ctx = MeshContext.create(1, MAXP, devices=jax.devices()[:1])
    drain_j = step_ref.build_window_while_drain(
        ctx, spec_j, MAX_SLOTS, reduced=True, drain_stats=True)
    drain_t = step_port.build_window_while_drain(
        spec_t, MAX_SLOTS, MAXP, reduced=True, drain_stats=True)
    sj = step_ref.init_sharded_state(ctx, spec_j)
    st = step_port.init_shard_state(spec_t, MAXP, "cpu")
    seq = _slots(5)
    flat = [a for b in seq for a in b[:5]]
    wmv = np.array([[b[5] for b in seq]], np.int32)
    sj, _mon, fr_j, cons_j, ds_j = drain_j(
        sj, *flat, wmv, np.full(1, cursor, np.int32), np.int32(BASE),
        np.int32(staged))
    st, _mon_t, fr_t, cons_t, ds_t = drain_t(
        st, [_lanes(b) for b in seq], torch.from_numpy(wmv[0]), cursor,
        BASE, staged)
    n = min(cursor - BASE, staged, MAX_SLOTS)
    assert int(np.asarray(cons_j)[0]) == int(cons_t[0]) == n
    for name in FIRE_FIELDS:
        got = getattr(fr_t, name).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(getattr(fr_j, name))[0], err_msg=name)
        assert not got[n:].any(), name                  # zero past consumed
    assert fr_t.lane_valid[:n].any()
    np.testing.assert_array_equal(ds_t.numpy(), np.asarray(ds_j)[0])
    assert not ds_t[n:].any() and ds_t[:n].any()
    want = jax_fields(jax.tree_util.tree_map(lambda x: np.asarray(x)[0],
                                             sj))
    got = wkt.state_to_numpy(st)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_compact_while_drain_matches_reference():
    """The compact drain (rows into the [max_slots, Ft, C] arena) gives
    the reference's rows, slot by slot, in slot order."""
    spec_j, spec_t = _specs()
    ctx = MeshContext.create(1, MAXP, devices=jax.devices()[:1])
    drain_j = step_ref.build_window_while_drain(ctx, spec_j, MAX_SLOTS)
    drain_t = step_port.build_window_while_drain(spec_t, MAX_SLOTS, MAXP)
    sj = step_ref.init_sharded_state(ctx, spec_j)
    st = step_port.init_shard_state(spec_t, MAXP, "cpu")
    seq = _slots(9)
    flat = [a for b in seq for a in b[:5]]
    wmv = np.array([[b[5] for b in seq]], np.int32)
    sj, _m, fr_j, _c = drain_j(sj, *flat, wmv, np.full(1, BASE + 7,
                                                       np.int32),
                               np.int32(BASE), np.int32(7))
    st, _m, fr_t, cons = drain_t(st, [_lanes(b) for b in seq],
                                 torch.from_numpy(wmv[0]), BASE + 7, BASE, 7)
    assert int(cons[0]) == 7
    assert tuple(fr_t.key_hi.shape) == (MAX_SLOTS, F, C)
    n_rows = 0
    for d in range(MAX_SLOTS):
        for f in range(F):
            cnt = int(fr_t.counts[d, f])
            assert cnt == int(np.asarray(fr_j.counts)[0, d, f])
            for name in ("key_hi", "key_lo", "values"):
                np.testing.assert_array_equal(
                    getattr(fr_t, name)[d, f, :cnt].numpy()
                    .view(np.asarray(getattr(fr_j, name)).dtype),
                    np.asarray(getattr(fr_j, name))[0, d, f, :cnt],
                    err_msg=name)
            n_rows += cnt
    assert n_rows > 0


def test_a_cursor_moving_mid_drain_joins_the_dispatch():
    """The bound is re-read before every iteration: a cursor that moves
    by one slot a read (a batch published while the drain runs) retires
    every staged slot, where its dispatch-time value allowed two — the
    same state as a drain handed all of them at once."""
    spec_j, spec_t = _specs()
    seq = _slots(11)
    reads = []

    def live():
        reads.append(None)
        return BASE + 1 + len(reads)

    out = {}
    for name, cursor in (("live", live), ("all", BASE + MAX_SLOTS)):
        drain = step_port.build_window_while_drain(spec_t, MAX_SLOTS, MAXP,
                                                   reduced=True)
        st = step_port.init_shard_state(spec_t, MAXP, "cpu")
        st, _m, fr, cons = drain(
            st, [_lanes(b) for b in seq],
            torch.tensor([b[5] for b in seq], dtype=torch.int32), cursor,
            BASE, MAX_SLOTS)
        out[name] = (wkt.state_to_numpy(st), fr, int(cons[0]))
    assert out["live"][2] == out["all"][2] == MAX_SLOTS
    assert len(reads) == MAX_SLOTS + 1      # before each slot, and the exit
    for name in wkt.STATE_FIELDS:
        np.testing.assert_array_equal(out["live"][0][name],
                                      out["all"][0][name], err_msg=name)
    for name in FIRE_FIELDS:
        np.testing.assert_array_equal(getattr(out["live"][1], name),
                                      getattr(out["all"][1], name))


# ------------------------------------------------------------ jobs

WHILE_CFG = {"pipeline.prefetch": "on", "pipeline.device-staging": "on",
             "pipeline.resident-loop": "while", "pipeline.ring-depth": 4,
             "pipeline.while-drain.cpu-override": "on"}
SCAN_CFG = {k: v for k, v in WHILE_CFG.items()
            if k != "pipeline.while-drain.cpu-override"}
SCAN_CFG["pipeline.resident-loop"] = "on"


class _Spy:
    """Records each dispatched drain and its slot count."""

    def __init__(self, monkeypatch):
        self.drains = []
        dispatch = ex._WindowJob.dispatch
        spy = self

        def wrapped(job):
            if len(job.group):
                spy.drains.append((job.drain, len(job.group)))
            dispatch(job)

        monkeypatch.setattr(ex._WindowJob, "dispatch", wrapped)


def _plan_first(monkeypatch):
    """A fault-seam rule that holds the producer's second prep until the
    step loop has installed the ingest plan. Without it, how many batches
    the producer preps before the plan exists (each a 1-slot drain on the
    general path) is a race that differs between two runs; with it every
    run has exactly one unplanned batch, so two runs' dispatch counts
    compare. Returns the injector to install around a run."""
    planned = threading.Event()
    set_plan = ingest_mod.IngestPipeline.set_plan

    def wrapped(pipe, plan):
        set_plan(pipe, plan)
        planned.set()

    monkeypatch.setattr(ingest_mod.IngestPipeline, "set_plan", wrapped)

    def injector():
        planned.clear()
        return FaultInjector([FaultRule(
            "ingest.producer", action="call", at=1,
            fn=lambda _ctx: planned.wait(30.0))])

    return injector


def test_while_drain_exact_with_no_more_dispatches_than_scan(monkeypatch):
    spy = _Spy(monkeypatch)
    plan_first = _plan_first(monkeypatch)
    total = 4096
    with faults.active(plan_first()):
        got, job = run_job(build_env(**WHILE_CFG), total)
    assert got == expected(total)
    m = job.metrics
    assert m.resident_drains > 0
    assert spy.drains and all(getattr(d, "while_drain", False)
                              for d, _n in spy.drains)
    with faults.active(plan_first()):
        _, scan_job = run_job(build_env(**SCAN_CFG), total)
    assert scan_job.metrics.resident_drains > 0
    assert m.resident_drains <= scan_job.metrics.resident_drains


def test_while_gated_on_cpu_runs_the_scan_drain(monkeypatch):
    """Without the cpu-override the reference's platform gate keeps the
    scan drain on the CPU: same rows, drains dispatched, none a
    while-drain."""
    spy = _Spy(monkeypatch)
    cfg = {**SCAN_CFG, "pipeline.resident-loop": "while"}
    got, job = run_job(build_env(**cfg), 2048)
    assert got == expected(2048)
    assert job.metrics.resident_drains > 0
    assert spy.drains and not any(getattr(d, "while_drain", False)
                                  for d, _n in spy.drains)


@pytest.mark.parametrize("max_slots", [2, 6, 12])
def test_while_max_slots_bounds_dispatch_not_results(monkeypatch,
                                                     max_slots):
    """``pipeline.while-drain.max-slots`` bounds one dispatch's slots
    (never below the ring depth, 4): the windows are the same, and no
    dispatch holds more than the bound."""
    spy = _Spy(monkeypatch)
    cfg = {**WHILE_CFG, "pipeline.while-drain.max-slots": max_slots}
    got, _job = run_job(build_env(**cfg), 4096)
    assert got == expected(4096)
    bound = max(4, max_slots)
    assert spy.drains and max(n for _d, n in spy.drains) <= bound
    assert all(d.max_slots == bound for d, _n in spy.drains)


def test_while_requires_staging_substrate():
    for cfg in ({"pipeline.prefetch": "off",
                 "pipeline.resident-loop": "while"},
                {"pipeline.device-staging": "off",
                 "pipeline.resident-loop": "while"}):
        with pytest.raises(ValueError, match="resident-loop") as got:
            run_job(build_env(**cfg), 512)
        with pytest.raises(ValueError) as want:
            run_job(build_env(pkg="jax", **cfg), 512, pkg="jax")
        assert str(got.value) == str(want.value)


def test_while_mid_drain_crash_restore_exactly_once(tmp_path):
    """A crash at a while-drain's dispatch (``step.drain``), with batches
    grouped and the producer ahead: the restore replays the unretired
    group from the applied cut — no slot skipped or drained twice. The
    first batches (prepped before the stage's plan) drain alone on the
    general path, so the fifth drain is a group of the steady state."""
    total = 8192
    env = build_env(tmp_path / "chk", interval=2, restart=3, **WHILE_CFG)
    inj = FaultInjector([FaultRule(
        "step.drain", exc=RuntimeError("injected mid-while-drain crash"),
        at=4)])
    with faults.active(inj):
        got, job = run_job(env, total)
    assert inj.fired_at("step.drain")
    assert job.metrics.restarts == 1
    assert job.metrics.resident_drains > 0
    assert got == expected(total)


# --------------------------------------- cursor race, {scan, while}

@pytest.mark.parametrize("mode", ["scan", "while"])
def test_cursor_race_every_slot_retired_exactly_once(mode):
    """A producer thread publishes into a depth-4 ring (waiting while it
    is full) while the consumer retires: in ``while`` mode only from
    ``write_cursor()`` snapshots, in ``scan`` mode from the published
    sequences. Every slot is retired once, the snapshots never move
    back, and the payload of each retired slot is the batch published
    into it."""
    depth, Bl, M = 4, 8, 120
    plan = ingest_mod.IngestPlan(td=None, slide_ticks=10, span_limit=8,
                                 B=Bl, staging=True, device="cpu",
                                 ring_depth=depth)
    ring = ingest_mod.DeviceBatchRing(plan, depth)
    published, errs = [], []
    done = threading.Event()

    def producer():
        try:
            for j in range(M):
                ticks = np.full(Bl, j, np.int32)
                args = (np.zeros(Bl, np.uint32), np.zeros(Bl, np.uint32),
                        ticks, np.ones(Bl, np.float32))
                while True:
                    pub = ring.try_publish(plan, *args, Bl, "mask", 0)
                    if pub is not None:
                        break
                    time.sleep(0.0002)
                published.append(pub[0])
        except Exception as e:  # noqa: BLE001 - surfaced by the assert
            errs.append(e)
        finally:
            done.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    freed, last, retired = 0, None, 0
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if mode == "while":
            snap = ring.write_cursor()
            assert last is None or snap >= last
            last = snap
            upto = snap - 1
        else:
            upto = published[-1] if published else -1
        for s in range(retired, upto + 1):
            # the slot still holds the batch of its sequence
            assert int(ring.slot(s)[2][0]) == s
        if upto >= retired:
            freed += ring.release_through(upto)
            retired = upto + 1
        if done.is_set() and freed == M:
            break
        time.sleep(0.0005)
    t.join(timeout=10)
    assert not t.is_alive()
    assert not errs, errs
    assert published == list(range(M))
    assert freed == M and ring.occupancy() == 0
    assert ring.write_cursor() == M
