"""Worker program for the port's env.execute()-over-DCN tests: every
process runs THIS SAME program (the reference's same-jar-on-every-
TaskManager deployment, TaskManager.scala:296); the dcn.* config keys
route the standard pipeline through the cross-process plane of
``flink_tpu_torch``. The counterpart of ``tests/dcn_env_job.py``; it
imports nothing of ``flink_tpu``, so it loads no JAX.

Usage: python tests/torch_dcn_env_job.py --coordinator H:P
           --num-processes N --process-id K --out OUT.npz [--session]
           [--shuffle] [--local-devices L] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np  # noqa: E402

import torch_dcn_jobs as J  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--session", action="store_true")
    ap.add_argument("--shuffle", action="store_true",
                    help="apply .shuffle() before key_by over the "
                         "skewed source (physical ingest shuffle)")
    ap.add_argument("--local-devices", type=int, default=4,
                    help="local shards forced on the device")
    ap.add_argument("--device", default=None)
    a = ap.parse_args()

    from flink_tpu_torch import StreamExecutionEnvironment
    from flink_tpu_torch.core.config import Configuration
    from flink_tpu_torch.core.time import TimeCharacteristic
    from flink_tpu_torch.datastream.window.assigners import (
        EventTimeSessionWindows, SlidingEventTimeWindows,
    )
    from flink_tpu_torch.parallel.mesh import force_device_count
    from flink_tpu_torch.runtime.sinks import CollectSink
    from flink_tpu_torch.runtime.sources import GeneratorSource

    force_device_count(a.local_devices)

    conf = {
        "dcn.coordinator": a.coordinator,
        "dcn.num-processes": a.num_processes,
        "dcn.process-id": a.process_id,
    }
    if a.shuffle:
        conf["dcn.rebalance-addrs"] = \
            os.environ["FLINK_TPU_TEST_REBALANCE_ADDRS"]
    env = StreamExecutionEnvironment(Configuration(conf), device=a.device)
    env.set_max_parallelism(64)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    env.set_state_capacity(2048)
    env.batch_size = 2048 if not a.session else 1024

    # THIS process's partition: the dcn_jobs source sliced by process id
    # (the raw deterministic fetch fn, so offset replay stays exact)
    src_fn = (J._session_source if a.session
              else J._skewed_source if a.shuffle else J._source)
    part = src_fn(a.process_id, a.num_processes)

    def gen(offset, n):
        keys, ts, vals = part.fn(offset, n)
        return (
            {"key": np.asarray(keys, np.int64),
             "value": np.asarray(vals, np.float32)},
            np.asarray(ts, np.int64),
        )

    total = (J.SESSION_TOTAL if a.session
             else part.total if a.shuffle else J.TOTAL_PER_HOST)
    sink = CollectSink()
    assigner = (
        EventTimeSessionWindows.with_gap(J.GAP_MS) if a.session
        else SlidingEventTimeWindows.of(
            J.WIN_MS, J.WIN_MS if a.shuffle else J.SLIDE_MS)
    )
    stream = env.add_source(GeneratorSource(gen, total=total))
    if a.shuffle:
        stream = stream.shuffle()      # the API annotation under test
    (
        stream
        .key_by(lambda c: c["key"])
        .window(assigner)
        .sum(lambda c: c["value"])
        .add_sink(sink)
    )
    job = env.execute("dcn-env-job")

    if a.session:
        key = np.asarray([r.key for r in sink.results], np.int64)
        start = np.asarray(
            [r.window_start_ms for r in sink.results], np.int64
        )
        end = np.asarray([r.window_end_ms for r in sink.results], np.int64)
    else:
        key = np.asarray([r.key for r in sink.results], np.int64)
        start = np.zeros(len(key), np.int64)
        end = np.asarray([r.window_end_ms for r in sink.results], np.int64)
    val = np.asarray([r.value for r in sink.results], np.float32)
    tmp = a.out + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, key_id=key, window_start_ms=start, window_end_ms=end,
                 value=val)
    os.replace(tmp, a.out)
    print(f"rows={len(key)} pid={a.process_id} "
          f"ingested={job.metrics.dcn_ingested_local}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
