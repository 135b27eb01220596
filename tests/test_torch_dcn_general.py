"""The port's cross-process plane beyond the tumbling window: two-host
sessions (exact, and killed and restored), the standard
``env.execute()`` selecting the plane under ``dcn.*`` config (sliding
windows, and the ``.shuffle()`` annotation), the ``global`` ingest
partitioner, the rolling reduce and CEP — the counterparts of the
reference's ``tests/test_dcn_general.py`` cases, each checked against the
oracle that case uses (``dcn_jobs.expected*``). The workers are the
port's (``python -m flink_tpu_torch.runtime.dcn`` and
``tests/torch_dcn_env_job.py``, on the CPU with 4 forced shards each);
the helpers are ``tests/test_torch_dcn.py``'s.
"""

import torch_threads  # first: caps torch's threads

import os
import subprocess
import sys

import numpy as np

from test_torch_dcn import (
    NPROC, REPO, crossed, free_port, kill_recover, merge, run_ensemble,
    wait_all, worker_env,
)

import dcn_jobs as J


def _env_job(tmp_path, flags=(), env=None):
    """Both processes of ``tests/torch_dcn_env_job.py``: rows files and
    each process's records ingested."""
    coord = f"127.0.0.1:{free_port()}"
    outs = [str(tmp_path / f"env-{p}.npz") for p in range(NPROC)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_dcn_env_job.py"),
         "--coordinator", coord, "--num-processes", str(NPROC),
         "--process-id", str(p), "--out", outs[p], "--device", "cpu",
         *flags],
        env=worker_env(env), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for p in range(NPROC)]
    ingested = {}
    for log in wait_all(procs):
        for line in log.splitlines():
            if line.startswith("rows="):
                parts = dict(kv.split("=") for kv in line.split())
                ingested[int(parts["pid"])] = int(parts["ingested"])
    return outs, ingested


def _addrs():
    return {"FLINK_TPU_TEST_REBALANCE_ADDRS":
            f"127.0.0.1:{free_port()},127.0.0.1:{free_port()}"}


def test_two_host_sessions_exact_and_cross(tmp_path):
    outs, stats = run_ensemble(tmp_path, "s", "two_host_session")
    got, by_host = merge(outs, with_start=True)
    assert got == J.expected_sessions(NPROC)
    assert crossed(by_host) > len(got) // 4, (crossed(by_host), len(got))
    assert len(set(by_host.values())) == NPROC
    assert all(stats[p]["dropped_capacity"] == 0 for p in range(NPROC))


def test_two_host_session_kill_recover(tmp_path):
    outs = kill_recover(tmp_path, "two_host_session_paced", every=2)
    got, _ = merge(outs, with_start=True)
    assert got == J.expected_sessions(NPROC)


def test_env_execute_selects_dcn_sliding(tmp_path):
    """``env.execute()`` runs over the plane when ``dcn.coordinator`` is
    set — with SLIDING windows."""
    outs, ingested = _env_job(tmp_path)
    got, by_host = merge(outs)
    assert got == J.expected_sliding(NPROC)
    assert crossed(by_host) > len(got) // 4
    assert ingested == {p: J.TOTAL_PER_HOST for p in range(NPROC)}


def test_env_execute_shuffle_annotation_is_physical(tmp_path):
    """``.shuffle()`` before key_by engages the targeted ring: the
    90/10-skewed ingest lands near-uniformly on both hosts' lanes, and the
    rows are exact."""
    outs, ingested = _env_job(tmp_path, ["--shuffle"], _addrs())
    got, _ = merge(outs)
    assert got == J.expected_skewed()
    assert sum(ingested.values()) == J.SKEW_TOTAL
    share = [ingested[p] / J.SKEW_TOTAL for p in range(NPROC)]
    assert all(abs(f - 1 / NPROC) < 0.05 for f in share), share


def test_global_partitioner_routes_everything_to_host0(tmp_path):
    outs, stats = run_ensemble(tmp_path, "g", "skewed_window_global",
                               env=_addrs())
    got, _ = merge(outs)
    assert got == J.expected_skewed()
    assert stats[0]["ingested_local"] == J.SKEW_TOTAL
    assert stats[1]["ingested_local"] == 0


def test_two_host_rolling_reduce(tmp_path):
    """Every record emits its key's updated running sum from the key's
    owner shard: the final values and the emission counts are exact, each
    key's values are 1..count in order, and keys cross hosts."""
    outs, _stats = run_ensemble(tmp_path, "r", "two_host_rolling")
    per_key, by_host = {}, {}
    for host, path in enumerate(outs):
        data = np.load(path)
        for k64, v in zip(data["key_id"], data["value"]):
            k = int(np.int64(np.uint64(k64)))
            per_key.setdefault(k, []).append(float(v))
            assert by_host.setdefault(k, host) == host
    exp = J.expected_rolling(NPROC)
    assert {k: max(v) for k, v in per_key.items()} == exp
    for k, vals in per_key.items():
        assert vals == [float(i) for i in range(1, len(vals) + 1)], k
    assert sum(1 for k, h in by_host.items() if h != k % NPROC) \
        > len(by_host) // 4


def test_two_host_cep(tmp_path):
    """Per-key match totals equal the numpy count-NFA oracle, each key's
    matches come from one owner host, and keys cross hosts."""
    outs, _stats = run_ensemble(tmp_path, "c", "two_host_cep")
    totals, by_host = {}, {}
    for host, path in enumerate(outs):
        data = np.load(path)
        assert int(data["dropped_capacity"]) == 0
        for k64, v in zip(data["key_id"], data["value"]):
            k = int(np.int64(np.uint64(k64)))
            totals[k] = totals.get(k, 0.0) + float(v)
            assert by_host.setdefault(k, host) == host
    exp = {k: v for k, v in J.expected_cep(NPROC).items() if v > 0}
    assert totals == exp
    assert sum(1 for k, h in by_host.items() if h != k % NPROC) \
        > len(by_host) // 4
    assert len(set(by_host.values())) == NPROC
