"""The port's cross-process plane (``flink_tpu_torch/runtime/dcn.py``) for
the window job: two worker PROCESSES of ``python -m
flink_tpu_torch.runtime.dcn --device cpu --local-devices 4``, each with
its own source partition and 4 forced shards, form one 8-shard mesh over
a Gloo group; the keyed exchange moves records between processes. The
counterpart of the reference's ``tests/test_dcn.py`` and the two-process
cases of ``tests/test_dcn_resident.py``, with the same jobs
(``tests/torch_dcn_jobs.py``, the numpy generators of
``tests/dcn_jobs.py``) and the same oracles (``dcn_jobs.expected*``):

  * records that ENTER on host A fire from host B's shards (disjoint
    per-host key slices), and the merged sums are exact;
  * kill-and-restart of the whole ensemble resumes from the latest
    complete lockstep checkpoint with exactly-once rows;
  * the resident drain (two processes, and with the rebalance ring) is
    exact in fewer rounds than the lockstep steps;
  * ``DCNJobSpec.resident`` on a session job raises.

Every worker runs with one torch thread and a wall limit; the Gloo group
times out a collective after 60 s, so a lockstep fault fails in bounded
time.
"""

import torch_threads  # first: caps torch's threads

import json
import os
import random
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import dcn_jobs as J  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(REPO, "tests", "torch_dcn_jobs.py")
NPROC = 2
WALL_S = 240          # a worker's wall limit


def free_port():
    """A free port below the kernel's ephemeral range: an outgoing
    connection (another test's Gloo or ring sockets) cannot take it
    between this pick and the worker's bind, as it can an ephemeral
    port that ``bind(0)`` hands out."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.SystemRandom()
    while True:
        port = rng.randrange(max(1024, low - 12000), low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


def worker_env(extra=None):
    env = torch_threads.worker_env()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def spawn(pid, coord, out, builder, extra=(), env=None):
    """One port worker on the CPU with 4 forced local shards."""
    return subprocess.Popen(
        [sys.executable, "-m", "flink_tpu_torch.runtime.dcn",
         "--coordinator", coord, "--num-processes", str(NPROC),
         "--process-id", str(pid), "--builder", f"{JOBS}:{builder}",
         "--out", out, "--device", "cpu", "--local-devices", "4",
         "--timeout-s", "60", *extra],
        env=worker_env(env), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def wait_all(procs, timeout=WALL_S):
    deadline = time.time() + timeout
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def result_lines(logs):
    """Each worker's JSON result line, by process id."""
    rows = {}
    for log in logs:
        for line in log.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                rows[row["pid"]] = row
    return rows


def run_ensemble(tmp_path, tag, builder, extra=(), env=None):
    coord = f"127.0.0.1:{free_port()}"
    outs = [str(tmp_path / f"{tag}-{p}.npz") for p in range(NPROC)]
    procs = [spawn(p, coord, outs[p], builder, extra, env)
             for p in range(NPROC)]
    return outs, result_lines(wait_all(procs))


def merge(paths, with_start=False):
    """The workers' rows as {(key, [start,] end): value}, each once, and
    which host emitted each."""
    got, by_host = {}, {}
    for host, path in enumerate(paths):
        data = np.load(path)
        for k64, s, e, v in zip(data["key_id"], data["window_start_ms"],
                                data["window_end_ms"], data["value"]):
            key = ((int(k64), int(s), int(e)) if with_start
                   else (int(k64), int(e)))
            assert key not in got, f"duplicate emission {key}"
            got[key] = float(v)
            by_host[key] = host
    return got, by_host


def crossed(by_host) -> int:
    """Rows fired on another host than the one that ingested the key (key
    k enters only on host k % NPROC)."""
    return sum(1 for key, host in by_host.items() if host != key[0] % NPROC)


def kill_after_first_cut(procs, ckpt, timeout=120):
    """Wait for a checkpoint that every process completed, then SIGKILL the
    whole ensemble mid-run (a dead process wedges the collectives, so the
    failure unit is the job)."""
    deadline = time.time() + timeout
    complete = []
    while time.time() < deadline:
        complete = [
            d for d in os.listdir(ckpt) if d.startswith("chk-")
            and all(os.path.exists(os.path.join(ckpt, d,
                                                f"proc-{p}.meta.json"))
                    for p in range(NPROC))]
        if complete or any(p.poll() is not None for p in procs):
            break
        time.sleep(0.05)
    alive = [p for p in procs if p.poll() is None]
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGKILL)
    for p in procs:
        p.wait(timeout=60)
    assert complete, "no complete checkpoint appeared before the kill"
    assert alive, "workers finished before the kill"


def kill_recover(tmp_path, builder, every):
    """Run ``builder`` with checkpoints every ``every`` rounds, kill the
    ensemble after its first complete cut, and rerun it with --restore:
    returns the restarted workers' row files."""
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    outs = [str(tmp_path / f"out-{p}.npz") for p in range(NPROC)]
    extra = ["--checkpoint-dir", ckpt, "--ckpt-every", str(every)]
    coord = f"127.0.0.1:{free_port()}"
    kill_after_first_cut(
        [spawn(p, coord, outs[p], builder, extra) for p in range(NPROC)],
        ckpt)
    coord = f"127.0.0.1:{free_port()}"
    wait_all([spawn(p, coord, outs[p], builder, extra + ["--restore"])
              for p in range(NPROC)])
    return outs


def test_records_cross_hosts_and_sums_exact(tmp_path):
    outs, stats = run_ensemble(tmp_path, "w", "two_host_window")
    got, by_host = merge(outs)
    assert got == J.expected(NPROC)
    # the keys provably crossed the process boundary in the exchange
    assert crossed(by_host) > len(got) // 4, (crossed(by_host), len(got))
    assert len(set(by_host.values())) == NPROC
    for p in range(NPROC):
        assert stats[p]["dropped_capacity"] == 0
        assert stats[p]["ingested_local"] == J.TOTAL_PER_HOST
        assert stats[p]["gloo_bytes_sent"] > 0


def test_kill_recover_round_trip(tmp_path):
    outs = kill_recover(tmp_path, "two_host_window_paced", every=3)
    got, _ = merge(outs)
    assert got == J.expected(NPROC)


def test_resident_two_process_exact_in_fewer_rounds(tmp_path):
    """The resident ensemble's merged rows equal the oracle, records cross
    the process boundary inside the drain's exchange, and its drains are
    fewer than the lockstep ensemble's rounds."""
    outs, stats = run_ensemble(tmp_path, "res", "two_host_window_resident")
    got, by_host = merge(outs)
    assert got == J.expected(NPROC)
    assert crossed(by_host) > len(got) // 4
    assert len(set(by_host.values())) == NPROC
    _outs, lock = run_ensemble(tmp_path, "lock", "two_host_window")
    assert stats[0]["cycles"] < lock[0]["cycles"], (stats, lock)


def test_resident_with_rebalance_exchanges_at_drain_boundaries(tmp_path):
    """Resident drains with the host-level rebalance ring over the 90/10
    skewed partitions: the ring runs at drain boundaries under the
    drain-scaled frame deadline, and the skewed stream sums exactly."""
    addrs = f"127.0.0.1:{free_port()},127.0.0.1:{free_port()}"
    outs, stats = run_ensemble(
        tmp_path, "resreb", "skewed_window_rebalanced_resident",
        env={"FLINK_TPU_TEST_REBALANCE_ADDRS": addrs})
    got, _ = merge(outs)
    assert got == J.expected_skewed()
    assert stats[0]["cycles"] > 0


def test_resident_requires_time_window_job():
    """``resident=True`` on a runner without a resident drain (sessions)
    is a config error, never a silent fallback to lockstep."""
    import torch_dcn_jobs as TJ
    from flink_tpu_torch.parallel.mesh import forced_device_count
    from flink_tpu_torch.runtime.dcn import runner_for_spec

    spec = TJ.two_host_session()
    spec.resident = True
    spec.resident_ring_depth = TJ.RESIDENT_DEPTH
    with forced_device_count(4), pytest.raises(ValueError, match="resident"):
        runner_for_spec(spec, 0, 1, device="cpu")
