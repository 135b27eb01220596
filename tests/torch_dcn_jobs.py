"""Builder functions for the port's cross-process plane tests (imported by
the ``flink_tpu_torch.runtime.dcn`` worker subprocesses via --builder
tests/torch_dcn_jobs.py:NAME).

The same constants, numpy generators and job specs as
``tests/dcn_jobs.py``, built on ``flink_tpu_torch.runtime.dcn`` — this
module imports nothing of ``flink_tpu``, so the port's workers never load
JAX. The tests take their oracles (``expected*``) from ``dcn_jobs``."""

import numpy as np

from flink_tpu_torch.runtime.dcn import DCNJobSpec, GeneratorPartitionSource

N_KEYS = 977           # prime: keys spread over all key groups
TOTAL_PER_HOST = 40_000
WIN_MS = 1_000
TS_DIV = 16            # ts advances 1ms per TS_DIV records


def _source(pid, nproc, total=TOTAL_PER_HOST):
    # host p ingests ONLY keys congruent to p mod nproc — a genuinely
    # DISJOINT key slice per host (key % nproc identifies the ingesting
    # host), so any key firing on the other host provably crossed the
    # process boundary through the all_to_all
    per_host = N_KEYS // nproc

    def gen(offset, n):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        keys = pid + nproc * (idx % per_host)
        ts = idx // TS_DIV
        return keys, ts, np.ones(n, np.float32)

    return GeneratorPartitionSource(gen, total)


def two_host_window():
    return DCNJobSpec(
        source_factory=_source,
        size_ms=WIN_MS,
        capacity_per_shard=2048,
        max_parallelism=64,
        batch_per_host=2048,
        fires_per_step=4,
    )


# -- per-host resident mode ------------------------------------------------

RESIDENT_DEPTH = 4


def two_host_window_paced():
    """``two_host_window`` whose checkpoint writes each take 0.5 s more
    (the ``dcn.ckpt.write`` seam): the port's workers run the job in well
    under a second, and the kill-recover tests need a window between the
    first complete cut and the end of the run to kill the ensemble in."""
    _pace_checkpoints()
    return two_host_window()


def _pace_checkpoints(delay_s=0.5):
    from flink_tpu_torch.testing import faults

    faults.install(faults.FaultInjector([faults.FaultRule(
        "dcn.ckpt.write", action="sleep", delay_s=delay_s, every=1,
        times=10**6)]))


def two_host_window_resident():
    spec = two_host_window()
    spec.resident = True
    spec.resident_ring_depth = RESIDENT_DEPTH
    return spec


def skewed_window_rebalanced_resident():
    """Rebalance side channel + resident drains: the peer exchange runs
    only at drain boundaries with the frame deadline scaled by the
    previous drain's slot count."""
    spec = skewed_window_rebalanced()
    spec.resident = True
    spec.resident_ring_depth = RESIDENT_DEPTH
    return spec


# -- sliding windows, sessions --------------------------------------------

SLIDE_MS = 500
GAP_MS = 40
SESSION_TOTAL = 12_000
SESSION_KEYS = 61        # small key set: sessions interleave heavily
BURST = 5                # events per session burst
IDLE = 120               # ms between a key's bursts (> GAP_MS: new session)


def two_host_sliding():
    """size=1000/slide=500: every record lands in 2 windows."""
    return DCNJobSpec(
        source_factory=_source,
        size_ms=WIN_MS,
        slide_ms=SLIDE_MS,
        capacity_per_shard=2048,
        max_parallelism=64,
        batch_per_host=2048,
        fires_per_step=4,
    )


def _session_source(pid, nproc):
    """Host p ingests keys ≡ p (mod nproc); each key emits bursts of
    BURST events 1ms apart, separated by IDLE ms (> gap: session break).
    ts is globally nondecreasing per host so the monotonic watermark is
    valid."""
    per_host = SESSION_KEYS // nproc

    def gen(offset, n):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        keys = pid + nproc * (idx % per_host)
        burst = idx // (per_host * BURST)       # which burst round
        within = (idx // per_host) % BURST      # position inside burst
        ts = burst * IDLE + within
        return keys, ts, np.ones(n, np.float32)

    return GeneratorPartitionSource(gen, SESSION_TOTAL)


def two_host_session():
    return DCNJobSpec(
        source_factory=_session_source,
        window_kind="session",
        gap_ms=GAP_MS,
        capacity_per_shard=1024,
        max_parallelism=64,
        batch_per_host=1024,
    )


def two_host_session_paced():
    """``two_host_session`` with paced checkpoint writes (see
    ``two_host_window_paced``)."""
    _pace_checkpoints()
    return two_host_session()


# -- physical rebalance (90/10 skewed hosts) -------------------------------

SKEW_TOTAL = 60_000      # records across BOTH hosts
SKEW_FRAC = 0.9          # host 0 ingests 90%


def _skewed_source(pid, nproc):
    """Host 0 holds 90% of the stream, host 1 the rest (the skewed
    partition assignment RebalancePartitioner exists for). Keys/ts are a
    GLOBAL schedule indexed by each host's slice so expectations don't
    depend on which host processes a record."""
    assert nproc == 2
    n0 = int(SKEW_TOTAL * SKEW_FRAC)
    base = 0 if pid == 0 else n0
    total = n0 if pid == 0 else SKEW_TOTAL - n0

    def gen(offset, n):
        idx = np.arange(base + offset, base + offset + n, dtype=np.int64)
        keys = idx % N_KEYS
        ts = idx // TS_DIV     # monotonic in idx: per-host watermarks valid
        return keys, ts, np.ones(n, np.float32)

    return GeneratorPartitionSource(gen, total)


def skewed_window(rebalance_addrs=None):
    return DCNJobSpec(
        source_factory=_skewed_source,
        size_ms=WIN_MS,
        capacity_per_shard=2048,
        max_parallelism=64,
        batch_per_host=2048,
        fires_per_step=4,
        rebalance=rebalance_addrs is not None,
        rebalance_addrs=rebalance_addrs,
    )


def skewed_window_plain():
    return skewed_window(None)


def skewed_window_rebalanced():
    import os

    addrs = os.environ["FLINK_TPU_TEST_REBALANCE_ADDRS"].split(",")
    return skewed_window(addrs)


def skewed_window_shuffled():
    """shuffle ingest partitioner over the same 90/10 skew: the targeted
    ring routes every record to a uniformly random host, restoring lane
    utilization like rebalance does (ref ShufflePartitioner.java)."""
    import os

    spec = skewed_window(None)
    spec.ingest_partitioner = "shuffle"
    spec.rebalance_addrs = \
        os.environ["FLINK_TPU_TEST_REBALANCE_ADDRS"].split(",")
    return spec


def skewed_window_global():
    """global ingest partitioner: every record routed to host 0 (ref
    GlobalPartitioner.java) — results stay exact, host 1's lanes idle."""
    import os

    spec = skewed_window(None)
    spec.ingest_partitioner = "global"
    spec.rebalance_addrs = \
        os.environ["FLINK_TPU_TEST_REBALANCE_ADDRS"].split(",")
    return spec


# -- rolling keyed reduce over the DCN plane -------------------------------

ROLL_TOTAL = 20_000


def _rolling_source(pid, nproc):
    return _source(pid, nproc, total=ROLL_TOTAL)


def two_host_rolling():
    """Rolling per-key count (sum of ones): every record emits its key's
    updated running aggregate from the owner shard."""
    return DCNJobSpec(
        source_factory=_rolling_source,
        window_kind="rolling",
        capacity_per_shard=2048,
        max_parallelism=64,
        batch_per_host=2048,
    )


# -- CEP pattern matching over the DCN plane -------------------------------

CEP_TOTAL = 12_000
CEP_KEYS = 101
CEP_STAGES = 3     # a -> followedBy b -> followedBy c


def _cep_pattern():
    from flink_tpu_torch.cep.pattern import Pattern

    return (Pattern.begin("a").where(lambda e: e == 0)
            .followed_by("b").where(lambda e: e == 1)
            .followed_by("c").where(lambda e: e == 2))


def _cep_event_code(pid, idx):
    """Deterministic per-record event code in {0,1,2,3} (3 = matches no
    stage); mixes by key and position so keys see genuinely different
    sequences."""
    return (idx * 7 + idx // 13 + pid) % 4


def _cep_source(pid, nproc):
    per_host = CEP_KEYS // nproc

    def gen(offset, n):
        idx = np.arange(offset, offset + n, dtype=np.int64)
        keys = pid + nproc * (idx % per_host)
        ts = idx // TS_DIV
        code = _cep_event_code(pid, idx)   # array-compatible helper
        # stage-match bits packed into the value lane (bit s = stage s)
        vals = np.zeros(n, np.float32)
        for s in range(CEP_STAGES):
            vals += (code == s).astype(np.float32) * (1 << s)
        return keys, ts, vals

    return GeneratorPartitionSource(gen, CEP_TOTAL)


def two_host_cep():
    return DCNJobSpec(
        source_factory=_cep_source,
        window_kind="cep",
        cep_pattern_factory=_cep_pattern,
        capacity_per_shard=1024,
        max_parallelism=64,
        batch_per_host=1024,
    )


