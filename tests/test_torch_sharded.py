"""Keyed windows over a shard mesh (parallelism above 1) against the
reference, on the CPU.

The port's mesh is ``force_device_count(8)`` copies of the CPU — the
counterpart of the conftest's 8 virtual XLA devices — set for each test
and reset after it (xdist puts several files in one worker). A small
north star (4,096 integer keys, B = 1,024, a 100 ms tumbling sum,
parallelism 4 and 8) runs in every dispatch mode of the slice: the
adaptive exchange (``exchange.mode: auto``), ``all_to_all``, ``mask``, the
sharded drain (``resident-loop: on``, data-parallel auto), the sharded
while-drain (``while`` with the CPU override), the exchange drain
(``on`` with ``data-parallel: off``), and K = 4 megasteps with fused fire
on and off. The rows equal the reference's and numpy's, and so do
``dropped_capacity`` and the batches the exchange and the sharded drains
took. Which batches the producer thread prepped before the stage's plan
existed is a race on both sides (they take the general path: the exchange
or mask route, never the sharded one), so in the data-parallel modes the
sum of the two route counts is compared, elsewhere each. At parallelism
8 every mode's rows equal numpy's.

``run`` and ``gen`` serve the other ``test_torch_sharded_*.py`` files.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest

from flink_tpu import StreamExecutionEnvironment as EnvJ
from flink_tpu.core.config import Configuration as ConfJ
from flink_tpu.core.time import TimeCharacteristic as TCJ
from flink_tpu.runtime.sinks import CollectSink as SinkJ
from flink_tpu.runtime.sources import GeneratorSource as GenJ
from flink_tpu_torch import StreamExecutionEnvironment as EnvT
from flink_tpu_torch.core.config import Configuration as ConfT
from flink_tpu_torch.core.time import TimeCharacteristic as TCT
from flink_tpu_torch.parallel.mesh import force_device_count
from flink_tpu_torch.runtime.sinks import CollectSink as SinkT
from flink_tpu_torch.runtime.sources import GeneratorSource as GenT

N_KEYS = 4096
B = 1024
EVENTS_PER_MS = 40
WINDOW = 100
TOTAL = 16 * B


@pytest.fixture(autouse=True)
def eight_devices():
    force_device_count(8)
    yield
    force_device_count(None)


def gen(offset, n):
    idx = np.arange(offset, offset + n, dtype=np.int64)
    return ({"key": (idx * 48271) % N_KEYS,
             "value": np.ones(n, np.float32)}, idx // EVENTS_PER_MS)


def expected(total):
    cols, ts = gen(0, total)
    out = {}
    for k, t in zip(cols["key"].tolist(), ts.tolist()):
        we = (t // WINDOW + 1) * WINDOW
        out[(k, we)] = out.get((k, we), 0.0) + 1.0
    return out


def run(pkg, cfg, parallelism, total=TOTAL, source=gen, capacity=N_KEYS,
        window=WINDOW, restore_from=None, ckpt=None):
    torch_side = pkg == "torch"
    Env, Conf, TC, Sink, Gen = ((EnvT, ConfT, TCT, SinkT, GenT) if torch_side
                                else (EnvJ, ConfJ, TCJ, SinkJ, GenJ))
    env = Env(Conf(dict(cfg)), **({"device": "cpu"} if torch_side else {}))
    env.set_parallelism(parallelism).set_max_parallelism(128)
    env.set_stream_time_characteristic(TC.EventTime)
    env.set_state_capacity(capacity)
    env.batch_size = B
    if ckpt is not None:
        env.enable_checkpointing(*ckpt)
    sink = Sink()
    (env.add_source(Gen(source, total=total)).key_by(lambda c: c["key"])
     .time_window(window).sum(lambda c: c["value"]).add_sink(sink))
    job = env.execute("sharded", restore_from=restore_from)
    rows = {}
    for r in sink.results:
        k = (int(r.key), int(r.window_end_ms))
        # a window re-emitted after a restore carries the same value
        assert rows.get(k, r.value) == r.value, (k, rows[k], r.value)
        rows[k] = r.value
    return rows, job.metrics


RING = {"pipeline.ring-depth": 4}
MODES = {
    "auto": {},
    "all_to_all": {"exchange.mode": "all_to_all"},
    "mask": {"exchange.mode": "mask"},
    "sharded_drain": {"pipeline.resident-loop": "on", **RING},
    "sharded_while": {"pipeline.resident-loop": "while", **RING,
                      "pipeline.while-drain.cpu-override": "on"},
    "exchange_drain": {"pipeline.resident-loop": "on", **RING,
                       "pipeline.data-parallel": "off"},
    "megastep": {"pipeline.resident-loop": "off",
                 "pipeline.steps-per-dispatch": 4},
    "megastep_no_fire": {"pipeline.resident-loop": "off",
                         "pipeline.steps-per-dispatch": 4,
                         "pipeline.fused-fire": "off"},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_mode_matches_reference_and_numpy(mode):
    cfg = MODES[mode]
    got, m = run("torch", cfg, 4)
    want, r = run("jax", cfg, 4)
    assert got == want == expected(TOTAL)
    assert m.exchange_mode == r.exchange_mode
    assert m.dropped_capacity == r.dropped_capacity == 0
    assert m.steps == r.steps
    if "pipeline.data-parallel" not in cfg and cfg.get(
            "pipeline.resident-loop") in ("on", "while"):
        assert m.steps_sharded > 0
        assert m.steps_exchanged + m.steps_sharded == \
            r.steps_exchanged + r.steps_sharded
    else:
        assert m.steps_sharded == r.steps_sharded == 0
        assert m.steps_exchanged == r.steps_exchanged
    if mode != "mask":
        assert m.steps_exchanged + m.steps_sharded > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_mode_at_parallelism_8_matches_numpy(mode):
    """Eight shards, one a virtual device: numpy's rows (the reference's
    are numpy's, as the test above shows at 4), every record routed."""
    got, m = run("torch", MODES[mode], 8)
    assert got == expected(TOTAL)
    assert m.dropped_capacity == 0 and m.steps == TOTAL // B
    if mode != "mask":
        assert m.steps_exchanged + m.steps_sharded > 0
