"""Smoke run of flink_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits nonzero):

  1. device   — requires CUDA; prints the card's name and power limit as
                nvidia-smi reports them.
  2. build    — compiles the window kernels G1-G4 from flink_tpu_torch/csrc.
  3. kernels  — runs each kernel at the north-star job's shapes (C = 1M keys,
                R = 8 ring panes, B = 262,144 lanes, F = 2 fire lanes,
                max parallelism 128) and holds it against its plain PyTorch
                version on the same inputs, exactly (the data is integer-
                valued); times kernel, plain version and, where one PyTorch
                call computes the same function, that call, with CUDA events,
                beside the bound the card's 3.35 TB/s sets on the bytes moved.
  4. e2e      — the north-star job (1M integer keys, 2,000 events/ms, 5 s
                tumbling-window sum, batches of 262,144, ring depth 16,
                2 fires per step, 30M events = 3 windows) through the port's
                public API; the sink's count and value sum must equal a numpy
                reference, and every kernel's launch counter must be > 0.

Then one line {"kernels": [...]} (launch counts from the e2e run, numbers
from phase 3), and last {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

adds, before those two lines, a profile of the e2e run: the generator's
host time alone, the host's top functions, and the card's busy time and
idle share from torch.profiler.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from flink_tpu_torch import StreamExecutionEnvironment
from flink_tpu_torch.core.config import Configuration
from flink_tpu_torch.core.time import TimeCharacteristic
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops.cuda import PANE_NONE
from flink_tpu_torch.runtime.sinks import CountingSink
from flink_tpu_torch.runtime.sources import GeneratorSource

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate

# the north-star job (bench.py, BASELINE.json)
N_KEYS = 1_000_000
WINDOW_MS = 5_000
EVENTS_PER_MS = 2_000
BATCH = 262_144
RING_DEPTH = 16
FIRES_PER_STEP = 2
MAX_PARALLELISM = 128
TOTAL_EVENTS = 30_000_000
RING_PANES = 8                # the executor's auto-sized ring at k = 1
SPIN_CYCLES = 50_000_000      # ~25 ms of spinning at the H100's boost clock


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def gen_batch(offset, n, n_keys=N_KEYS, events_per_ms=EVENTS_PER_MS):
    """bench.py's generator: keys by a multiplicative hash of the offset,
    event time = offset / rate, every value 1."""
    idx = np.arange(offset, offset + n, dtype=np.int64)
    keys = (idx * 2862933555777941757) % n_keys
    return keys, idx // events_per_ms, np.ones(n, np.float32)


def time_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call. A spin kernel holds the card while the
    host enqueues all ``reps`` calls, so the events bracket device work
    only, not the host's launch overhead (a call that synchronises inside,
    as some plain versions do, still counts its host time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(a, b) -> float:
    pairs = zip(a, b) if isinstance(a, (tuple, list)) else [(a, b)]
    err = 0.0
    for x, y in pairs:
        d = (x.double() - y.double()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------------ phase 3

def _t(a, dev, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


def lane_inputs(dev, C, B, slide, kind, seed=0):
    """G1/G3 lane inputs at the main path's shapes. ``main``: one batch of
    the north-star generator that crosses a window boundary, with the
    watermark and purge cursor the executor holds there. ``edge``: data
    that reaches every branch — invalid lanes, late lanes (watermark and
    purge cursor), too-old lanes behind a far-ahead pane, keys past
    capacity or with a nonzero high word, negative ticks."""
    rng = np.random.default_rng(seed)
    if kind == "main":
        offset = WINDOW_MS * EVENTS_PER_MS - B // 2
        keys, ts, vals = gen_batch(offset, B, C)
        hi = np.zeros(B, np.uint32)
        lo = keys.astype(np.uint32)
        valid = np.ones(B, bool)
        wm = int(ts[0]) - 1
        purged = -1
    else:
        hi = np.where(rng.random(B) < 0.01, 1, 0).astype(np.uint32)
        lo = rng.integers(0, C + C // 20, B).astype(np.uint32)
        pane = rng.integers(-2, 3, B)
        pane[rng.random(B) < 0.01] = 7          # drives max_pane ahead
        ts = pane * slide + rng.integers(0, slide, B)
        vals = rng.integers(1, 9, B).astype(np.float32)
        valid = rng.random(B) < 0.95
        wm = slide // 2 - 1 - 2 * slide          # panes <= -2 are late
        purged = -2
    return {
        "hi": _t(hi.view(np.int32), dev, torch.int32),
        "lo": _t(lo.view(np.int32), dev, torch.int32),
        "ts": _t(ts.astype(np.int32), dev, torch.int32),
        "values": _t(vals.astype(np.float32), dev, torch.float32),
        "valid": _t(valid, dev, torch.bool),
        "watermark": torch.tensor(wm, dtype=torch.int32, device=dev),
        "purged_through": torch.tensor(purged, dtype=torch.int32,
                                       device=dev),
    }


def packed_plane(dev, C, R, density, seed=1):
    """A pane plane with integer values and touch counts in a ``density``
    share of the (row, key) cells."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    touch = (torch.rand(R * C, generator=g) < density).float()
    val = torch.randint(1, 9, (R * C,), generator=g).float() * touch
    cnt = touch * torch.randint(1, 4, (R * C,), generator=g)
    return torch.stack([val, cnt], 1).to(dev)


def _zero_i32(dev):
    return torch.zeros((), dtype=torch.int32, device=dev)


def case_route_lanes(inp, C, R, maxp, slide):
    args = (inp["hi"], inp["lo"], inp["ts"], inp["valid"], inp["watermark"],
            inp["purged_through"])
    kw = dict(slide=slide, k=1, maxp=maxp, kg_start=0, kg_end=maxp - 1)
    B = inp["hi"].shape[0]
    return {
        "got": kernels.route_lanes(*args, **kw),
        "want": kernels.route_lanes_plain(*args, **kw),
        "run": lambda: kernels.route_lanes(*args, **kw),
        "plain": lambda: kernels.route_lanes_plain(*args, **kw),
        "library": None,
        # hi, lo, ts, valid in; pane, kg, live out
        "bytes": B * (4 + 4 + 4 + 1 + 4 + 4 + 1),
    }


def case_scatter_update(inp, C, R, maxp, slide):
    pane, kg, live, stats = kernels.route_lanes_plain(
        inp["hi"], inp["lo"], inp["ts"], inp["valid"], inp["watermark"],
        inp["purged_through"], slide=slide, k=1, maxp=maxp, kg_start=0,
        kg_end=maxp - 1)
    dev = pane.device
    max_pane = torch.maximum(torch.tensor(PANE_NONE, dtype=torch.int32,
                                          device=dev), stats[1])
    acc0 = packed_plane(dev, C, R, 0.5)
    a1, a2 = acc0.clone(), acc0.clone()
    dirty1 = torch.zeros(maxp, dtype=torch.bool, device=dev)
    dirty2 = dirty1.clone()
    d1, d2 = _zero_i32(dev), _zero_i32(dev)
    lanes = (pane, kg, live, inp["hi"], inp["lo"], inp["values"], max_pane)
    kernels.scatter_update(a1, dirty1, d1, *lanes, C=C, R=R)
    kernels.scatter_update_plain(a2, dirty2, d2, *lanes, C=C, R=R)
    lo64 = inp["lo"].long() & 0xFFFFFFFF
    ok = live & (pane >= max_pane - (R - 1)) & (inp["hi"] == 0) & (lo64 < C)
    idx = 2 * (torch.remainder(pane.long(), R) * C + lo64)[ok]
    lib_idx = torch.cat([idx, idx + 1])
    lib_val = torch.cat([inp["values"][ok], torch.ones_like(
        inp["values"][ok])])
    B = pane.shape[0]
    return {
        "got": (a1, dirty1, d1), "want": (a2, dirty2, d2),
        "run": lambda: kernels.scatter_update(a1, dirty1, d1, *lanes, C=C,
                                              R=R),
        "plain": lambda: kernels.scatter_update_plain(a2, dirty2, d2,
                                                      *lanes, C=C, R=R),
        # the same value + marker scatter in one call (no drop counting)
        "library": lambda: a2.view(-1).index_add_(0, lib_idx, lib_val),
        # pane, kg, live, hi, lo, values in; each touched (value, marker)
        # cell read and written once
        "bytes": B * (4 + 4 + 1 + 4 + 4 + 4)
        + int(torch.unique(idx).numel()) * 8 * 2,
    }


def case_clear_rows(dev, C, R, kind):
    """``main``: a pane crossing registers one new ring row (stale, not
    evicted). ``edge``: two rows, one of them evicted with unfired data."""
    acc0 = packed_plane(dev, C, R, 0.9)
    clear = torch.zeros(R, dtype=torch.bool, device=dev)
    evicted = torch.zeros(R, dtype=torch.bool, device=dev)
    clear[1] = True
    if kind == "edge":
        clear[5] = evicted[5] = True
    rows = clear.nonzero().reshape(-1)
    a1, a2 = acc0.clone(), acc0.clone()
    d1, d2 = _zero_i32(dev), _zero_i32(dev)
    kernels.clear_rows(a1, clear, evicted, d1, C=C, R=R)
    kernels.clear_rows_plain(a2, clear, evicted, d2, C=C, R=R)
    return {
        "got": (a1, d1), "want": (a2, d2),
        "run": lambda: kernels.clear_rows(a1, clear, evicted, d1, C=C, R=R),
        "plain": lambda: kernels.clear_rows_plain(a2, clear, evicted, d2,
                                                  C=C, R=R),
        # the same row clear in one call (no eviction count)
        "library": lambda: a2.view(R, C * 2).index_fill_(0, rows, 0.0),
        # flagged rows written, evicted rows' touch column read, masks read
        "bytes": int(clear.sum()) * C * 8 + int(evicted.sum()) * C * 4
        + 2 * R,
    }


def case_fire_reduced(dev, C, R, F, kind):
    """``main``: a tumbling boundary, one due lane of F. ``edge``: a
    sliding window (k = 2), two due lanes, one of them missing a pane."""
    acc0 = packed_plane(dev, C, R, 0.99)
    k = 1 if kind == "main" else 2
    pane_ids = torch.full((R,), PANE_NONE, dtype=torch.int32, device=dev)
    for q in (40, 41, 42):
        pane_ids[q % R] = q
    ends = [41, 42] if kind == "main" else [42, 44]
    p_f = torch.tensor((ends * F)[:F], dtype=torch.int32, device=dev)
    lane_ok = torch.zeros(F, dtype=torch.bool, device=dev)
    lane_ok[: 1 if kind == "main" else 2] = True
    args = (acc0, pane_ids, p_f, lane_ok)
    n_rows = int(sum(
        int(pane_ids[(int(p) - j) % R]) == int(p) - j
        for p, ok in zip(p_f.tolist(), lane_ok.tolist()) if ok
        for j in range(k)))
    return {
        "got": kernels.fire_reduced(*args, C=C, R=R, k=k),
        "want": kernels.fire_reduced_plain(*args, C=C, R=R, k=k),
        "run": lambda: kernels.fire_reduced(*args, C=C, R=R, k=k),
        "plain": lambda: kernels.fire_reduced_plain(*args, C=C, R=R, k=k),
        "library": None,
        # each present row of each due lane read once, pane_ids, lane outs
        "bytes": n_rows * C * 8 + R * 4 + F * (4 + 1 + 4 + 4),
    }


def kernel_phase(dev, C, R, B, F, maxp, slide, timing=True):
    """Hold G1-G4 against their plain versions on both input sets, and time
    the main-path set. Returns one record per kernel."""
    lanes = {kind: lane_inputs(dev, C, B, slide, kind)
             for kind in ("main", "edge")}
    out = {}
    for name in ("route_lanes", "clear_rows", "scatter_update",
                 "fire_reduced"):
        cases, errs = {}, []
        for kind in ("main", "edge"):
            if name == "route_lanes":
                c = case_route_lanes(lanes[kind], C, R, maxp, slide)
            elif name == "scatter_update":
                c = case_scatter_update(lanes[kind], C, R, maxp, slide)
            elif name == "clear_rows":
                c = case_clear_rows(dev, C, R, kind)
            else:
                c = case_fire_reduced(dev, C, R, F, kind)
            err = max_abs_err(c["got"], c["want"])
            check(err == 0.0, f"{name} ({kind} inputs) disagrees with its "
                              f"plain version: max abs err {err}")
            cases[kind] = c
            errs.append(err)
        main = cases["main"]
        rec = {"max_abs_err": max(errs), "bound_ms": bound_ms(main["bytes"])}
        if timing:
            rec["ms"] = time_ms(main["run"])
            rec["plain_ms"] = time_ms(main["plain"], reps=5)
            rec["library_ms"] = (time_ms(main["library"])
                                 if main["library"] is not None else None)
        out[name] = rec
    return out


# ------------------------------------------------------------ phase 4

def numpy_reference(total, n_keys, events_per_ms, window_ms, chunk=1 << 22):
    """(key, window) pairs of the generator: the windows a tumbling sum
    emits. Each event is 1.0, so the value sum is the event count."""
    n_windows = -(-total // (events_per_ms * window_ms))
    seen = np.zeros((n_windows, n_keys), bool)
    for off in range(0, total, chunk):
        keys, ts, _ = gen_batch(off, min(chunk, total - off), n_keys,
                                events_per_ms)
        seen[ts // window_ms, keys] = True
    return int(seen.sum())


def north_star_job(device, n_keys, events_per_ms, total, batch, depth):
    """The north-star job through the public API; returns (sink, job, s)."""
    def gen(offset, n):
        keys, ts, vals = gen_batch(offset, n, n_keys, events_per_ms)
        return {"key": keys, "value": vals}, ts

    cfg = Configuration({
        "keys.reverse-map": False,
        "window.fires-per-step": FIRES_PER_STEP,
        "pipeline.ring-depth": depth,
    })
    env = StreamExecutionEnvironment(cfg, device=device)
    env.set_parallelism(1)
    env.set_max_parallelism(MAX_PARALLELISM)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(n_keys)
    env.batch_size = batch
    sink = CountingSink()
    (
        env.add_source(GeneratorSource(gen, total=total))
        .key_by(lambda c: c["key"])
        .time_window(WINDOW_MS)
        .sum(lambda c: c["value"])
        .add_sink(sink)
    )
    t0 = time.perf_counter()
    job = env.execute("chip-smoke-north-star")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return sink, job, time.perf_counter() - t0


# ------------------------------------------------------------ profile

def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms."""
    busy, last_end = 0.0, None
    for a, b in sorted(intervals):
        if last_end is None or a > last_end:
            busy += b - a
            last_end = b
        elif b > last_end:
            busy += b - last_end
            last_end = b
    return busy / 1e3


def profile_phase(dev) -> dict:
    """Where the end-to-end time goes (``--profile`` only): the generator
    alone on the host, the job's host profile (cProfile, top entries by
    own time), and its device timeline (torch.profiler): busy time as the
    union of kernel and copy intervals, and the share of wall time the
    card sat idle."""
    import cProfile
    import pstats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for off in range(0, TOTAL_EVENTS, BATCH):
        gen_batch(off, min(BATCH, TOTAL_EVENTS - off))
    gen_s = time.perf_counter() - t0

    prof_c = cProfile.Profile()
    prof_c.enable()
    north_star_job(dev, N_KEYS, EVENTS_PER_MS, TOTAL_EVENTS, BATCH,
                   RING_DEPTH)
    prof_c.disable()
    st = pstats.Stats(prof_c)
    host_top = sorted(
        ((v[2], f"{k[0].rsplit('/', 2)[-1]}:{k[1]}:{k[2]}")
         for k, v in st.stats.items()), reverse=True)[:12]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sink, job, wall_s = north_star_job(dev, N_KEYS, EVENTS_PER_MS,
                                            TOTAL_EVENTS, BATCH, RING_DEPTH)
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        ms, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + (b - a) / 1e3, n + 1)
    busy = _busy_ms(spans)
    return {
        "phase": "profile", "generator_s": gen_s,
        "host_top_own_s": host_top, "profiled_wall_s": wall_s,
        "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / (wall_s * 1e3),
        "device_top_ms": sorted(
            ((round(ms, 3), n, name) for name, (ms, n) in by_name.items()),
            reverse=True)[:15],
        "drains": job.metrics.resident_drains,
    }


# ------------------------------------------------------------ main

KERNEL_SOURCES = {
    "route_lanes": ("flink_tpu_torch/csrc/route_lanes.cu",
                    "flink_tpu/runtime/step.py:129"),
    "clear_rows": ("flink_tpu_torch/csrc/clear_rows.cu",
                   "flink_tpu/ops/window_kernels.py:1278"),
    "scatter_update": ("flink_tpu_torch/csrc/scatter_update.cu",
                       "flink_tpu/ops/window_kernels.py:582"),
    "fire_reduced": ("flink_tpu_torch/csrc/fire_reduced.cu",
                     "flink_tpu/ops/window_kernels.py:1203"),
}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    recs = kernel_phase(dev, N_KEYS, RING_PANES, BATCH, FIRES_PER_STEP,
                        MAX_PARALLELISM, WINDOW_MS)
    emit({"phase": "kernels", "checks": {
        n: {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                              "bound_ms")} for n, r in recs.items()}})

    kernels.reset_launch_counts()
    sink, job, secs = north_star_job(dev, N_KEYS, EVENTS_PER_MS,
                                     TOTAL_EVENTS, BATCH, RING_DEPTH)
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    want_count = numpy_reference(TOTAL_EVENTS, N_KEYS, EVENTS_PER_MS,
                                 WINDOW_MS)
    m = job.metrics
    emit({"phase": "e2e", "events": TOTAL_EVENTS, "seconds": secs,
          "events_per_s": TOTAL_EVENTS / secs, "drains": m.resident_drains,
          "fire_steps": m.fire_steps, "batches": m.steps,
          "count": sink.count, "count_ref": want_count,
          "value_sum": sink.value_sum, "launches": launches,
          "device": kind, "nvidia_smi": smi})
    check(sink.value_sum == float(TOTAL_EVENTS),
          f"value_sum {sink.value_sum} != {TOTAL_EVENTS}")
    check(sink.count == want_count,
          f"count {sink.count} != numpy reference {want_count}")
    check(m.dropped_late == 0 and m.dropped_capacity == 0,
          f"dropped records: late {m.dropped_late}, capacity "
          f"{m.dropped_capacity}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")

    if "--profile" in argv:
        emit(profile_phase(dev))
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
        "replaces": KERNEL_SOURCES[name][1], "launches": launches[name],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes", "library_ms": r["library_ms"],
    } for name, r in recs.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
