"""The cross-process data plane — the port of flink_tpu/runtime/dcn.py:
keyed windows, sessions, rolling reduces and CEP over ONE mesh whose
shards span worker processes (kernel families K22, and K13 DCN in
``runtime/step.py build_window_dcn_resident_drain``).

The reference's design, kept:

  * each host (worker process) ingests whatever its source partition
    holds and feeds only its local shards — records cross the slow
    network once, as ingestion bytes;
  * one collective over the global mesh routes every record to the shard
    that owns its key group: the all_to_all for the pane-ring time
    windows and the rolling reduce, an all_gather and G1's owner mask for
    the replicate-and-mask session and CEP stages;
  * the control decisions ride the same collectives: the global
    watermark is the ``pmin`` of the hosts' watermarks, done the ``pmin``
    of their exhausted flags and the fire backlog a ``pmax``, so every
    process runs the same lockstep sequence of steps and no process skips
    a collective (an exhausted host keeps stepping with invalid lanes).

The mesh is ``parallel/mesh.py``'s ``MeshContext`` over this process's
local shards (``mesh_devices``: its cards, or ``force_device_count(L)``
copies of one device), ``L x num_processes`` shards in all, and the
collectives between processes ride a ``torch.distributed`` Gloo group
(``parallel/collectives.py ProcessPlane``), the counterpart of
``jax.distributed``: the buckets that cross processes are staged through
host buffers, since NCCL refuses two ranks on one card. Every kernel of a
step is one the port already has, run under its shard's device guard:
G26 ``exchange_pack`` and G1-G3, G5, G6 and G8 for the windows, G1, G5,
G10 and G11 for sessions, G26, G1, G5, G10 and G13 for the rolling sum,
G1, G5, G10 and G19 for CEP.

Checkpoints are per-process shard snapshots written at a lockstep
cadence, so a killed ensemble restarts from the latest cut that EVERY
process completed (``chk-NNNNNN/proc-P.npz`` and its
``proc-P.meta.json``, the meta written last: a cut is complete when every
process's meta exists).

Run one worker:
  python -m flink_tpu_torch.runtime.dcn --coordinator H:P
      --num-processes N --process-id K --builder pkg.mod:fn --out result.npz
      [--builder-kwargs JSON] [--checkpoint-dir D --ckpt-every C --restore]
      [--local-devices L] [--device cpu]

``builder(**kwargs)`` returns a DCNJobSpec. The worker runs on the CUDA card
unless ``--device cpu`` is passed; ``--local-devices L`` forces L local
shards on that device (the counterpart of the reference tests'
``--xla_force_host_platform_device_count``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from flink_tpu_torch.core.device import resolve_device
from flink_tpu_torch.ops.hashing import key_identity64
from flink_tpu_torch.runtime import elastic
from flink_tpu_torch.testing import faults

MAX_TICKS = 2**31 - 4


class DCNPeerError(RuntimeError):
    """Attributed data-plane peer failure: the message names WHICH peer
    and WHAT it was doing, so one sick process surfaces as a clean job
    failure instead of an anonymous ensemble hang (the failure-
    containment contract, docs/fault-tolerance.md)."""


class DCNPeerStalledError(DCNPeerError):
    """A live peer stopped sending: the bounded recv deadline expired
    mid-frame. The connect path always had a deadline; this closes the
    steady-state hole where one stalled host wedged every reader."""


class DCNPeerLostError(DCNPeerError, elastic.DeviceLostError):
    """A peer connection reset and bounded reconnect-with-backoff could
    not re-establish the ring — the peer is declared dead.

    Also a :class:`~flink_tpu_torch.runtime.elastic.DeviceLostError`: the
    dead peer's mesh segment (its device) is gone with it, so the
    failure classifies as DEVICE LOSS at the restart boundary. The DCN
    lockstep plane itself cannot re-plan in place (every process bakes
    the global mesh into its collectives), so recovery there is the
    ordinary job-level restart at full parallelism — but the
    classification, metrics, and any supervising controller see the
    loss for what it is."""

    def __init__(self, message: str, lost_shards=(), lost_devices=()):
        elastic.DeviceLostError.__init__(
            self, message, lost_shards=lost_shards,
            lost_devices=lost_devices,
        )


@dataclass
class DCNJobSpec:
    """One keyed windowed aggregation fed from per-host partitions.

    source_factory(process_id, num_processes) -> object with
        poll(max_records) -> (keys int64[n], ts_ms int64[n],
                              values float32[n], exhausted bool)
        snapshot() -> json-able offset state
        restore(state)
    (the per-host slice of the partitioned-consumer contract,
    connectors/partitioned.py / FlinkKafkaConsumerBase.java:65).

    window_kind "time" covers tumbling (slide_ms None/== size_ms) and
    sliding windows; "session" uses gap_ms-merged session windows.
    """

    source_factory: Callable
    size_ms: int = 0
    capacity_per_shard: int = 1 << 16
    max_parallelism: int = 128
    batch_per_host: int = 4096
    fires_per_step: int = 4
    out_of_orderness_ms: int = 0
    reduce_kind: str = "sum"
    slide_ms: Optional[int] = None
    window_kind: str = "time"      # "time" | "session" | "rolling" | "cep"
    # window_kind "cep": a zero-arg factory returning the cep Pattern
    # (factory, not instance: every lockstep process builds its own).
    # The source's VALUE lane carries the per-event stage-match bits
    # packed as a float32 integer (bit s = stage s's predicate; exact
    # for <= 24 stages) — predicates evaluate at the ingesting host, the
    # NFA advances on the device, and the base ingest loop stays untouched.
    cep_pattern_factory: Optional[Callable[[], object]] = None
    gap_ms: int = 0                # session gap
    # epoch-ms timestamps exceed int32 ticks: the runner rebases every
    # ts to this origin. A SPEC field (not derived from data) so all
    # lockstep processes agree without coordination; set it to e.g. the
    # job's start-of-day epoch ms for wall-clock sources.
    origin_ms: int = 0
    # physical rebalance (ref RebalancePartitioner.java:30): underfull
    # hosts borrow ingest lanes from their ring neighbor's backlog over a
    # host-to-host TCP side channel, so a skewed partition assignment
    # keeps every host's lane budget busy (see _RebalanceRing). Device-
    # side lane spreading cannot do this — per-host lane counts are fixed
    # by the sharding, so extra ingest capacity must arrive as records
    # over the network, exactly like the reference's rebalance edge.
    rebalance: bool = False
    rebalance_addrs: Optional[list] = None   # "host:port" per process-id
    # host-level ingest partitioner (ref StreamPartitioner catalog,
    # SURVEY §2.11): "forward" (records process on the host whose
    # partition holds them), "rebalance" (deficit-driven neighbor
    # borrowing, equivalent to rebalance=True), "shuffle" (every record
    # routed to a uniformly random host via the targeted ring — the
    # ShufflePartitioner, with per-cycle balanced assignment so no
    # host's lane budget overflows), "global" (every record routed to
    # host 0 — the GlobalPartitioner, whose single-subtask bottleneck
    # cost becomes visible as host-0-bound cycle counts). "rescale" is
    # accepted as an alias of "forward": the reference's rescale keeps
    # records within the local TaskManager group, which is exactly what
    # forward ingestion does here. shuffle/global use the same
    # rebalance_addrs side channel.
    ingest_partitioner: str = "forward"
    # failure containment (docs/fault-tolerance.md): a ring peer that
    # stops sending mid-frame fails ATTRIBUTED after this deadline
    # (DCNPeerStalledError names the peer) instead of wedging the
    # ensemble; a transient peer reset gets this many reconnect
    # attempts (exponential backoff) before DCNPeerLostError.
    peer_recv_timeout_s: float = 120.0
    peer_reconnect_attempts: int = 3
    peer_reconnect_backoff_s: float = 0.25
    # pipeline.steps-per-dispatch plumb-through: the lockstep DCN plane
    # runs ONE poll → route → exchange → update round per collective
    # cycle (every host must dispatch the same step in the same round,
    # and the rebalance/shuffle side channels synchronize per cycle), so
    # K-fused dispatch does not compose with it. Values > 1 take the
    # EXPLICIT single-step fallback: noted loudly at startup, never
    # silently absorbed.
    steps_per_dispatch: int = 1
    # per-host resident mode (pipeline.resident-loop on/while under a
    # dcn.coordinator): between DCN boundaries each host
    # polls up to resident_ring_depth local chunks and retires them in
    # ONE multi-slot drain dispatch (runtime/step.py
    # build_window_dcn_resident_drain — the trip count is the pmax of the
    # hosts' fills, agreed in the drain's first all_reduce). The
    # rebalance/shuffle/global side channels run ONCE per drain cycle, at
    # the boundary,
    # with their frame deadlines scaled by the slots the previous drain
    # retired (deadline_scale — DCNPeerStalledError attribution keeps
    # its base semantics at scale 1). Time-window jobs only.
    resident: bool = False
    resident_ring_depth: int = 4


class GeneratorPartitionSource:
    """fn(offset, n) -> (keys, ts_ms, values) up to ``total`` records —
    the replayable test/bench partition (deterministic fetch, so offset
    restore gives exactly-once replay)."""

    def __init__(self, fn, total: int):
        self.fn = fn
        self.total = total
        self.offset = 0

    def poll(self, max_records):
        n = min(max_records, self.total - self.offset)
        if n <= 0:
            e = np.zeros(0, np.int64)
            return e, e, np.zeros(0, np.float32), True
        keys, ts, vals = self.fn(self.offset, n)
        self.offset += n
        return (np.asarray(keys, np.int64), np.asarray(ts, np.int64),
                np.asarray(vals, np.float32), self.offset >= self.total)

    def snapshot(self):
        return {"offset": self.offset}

    def restore(self, state):
        self.offset = int(state["offset"])


class _RebalanceRing:
    """Host-level physical rebalance (ref RebalancePartitioner.java:30,
    RecordWriter round-robin edges): each cycle, process p asks its ring
    neighbor (p+1) % nproc to fill p's spare ingest lanes from the
    neighbor's source backlog; records cross hosts as length-prefixed
    numpy frames over TCP — the reference's records-over-the-network
    rebalance, applied at the ingestion edge where this architecture's
    skew cost actually lives (a skewed host needs proportionally more
    lockstep cycles; the keyed all_to_all already balances compute).

    Protocol per cycle:
      1. send REQUEST(my spare lanes) on the next-link,
      2. serve the prev-link: read its spare, poll up to that many extra
         records from MY source, send them (+ my exhausted flag),
      3. read the donation from the next-link into my spare lanes.
    Lockstep safety: every process runs all three phases every cycle.
    Deadlock safety: phase-2 sends happen before anyone's phase-3 read,
    so a donation frame must never need the peer to drain it — frames
    are capped at DONATE_CAP records (≤64 KiB) and both socket buffers
    are raised to hold a full frame, so sendall always completes into
    kernel buffers even when every ring link donates at once (sources
    that trickle below max_records can leave every host with both spare
    lanes AND backlog).

    Failure containment (docs/fault-tolerance.md): steady-state reads
    run in short socket-timeout slices under a ``recv_timeout_s``
    deadline, so a stalled peer raises an attributed
    :class:`DCNPeerStalledError` instead of wedging the reader forever.
    A transient peer RESET triggers a bounded reconnect: both links are
    closed and re-established (the same deterministic dial-next /
    accept-prev dance as startup — a neighbor losing one link resyncs
    its own links too, so the repair cascades around the ring) and the
    ROUND retries from the top. Retry is lossless even when the abort
    is ASYMMETRIC (the donor's round completed while the recipient's
    recv failed): every request frame carries the requester's round
    counter, and the serve side caches its last (round, donation) — a
    re-request for an already-served round re-donates the cached
    records instead of re-polling, so an aborted round's poll is never
    lost and never double-consumed, and nothing is applied to device
    state until the round returns. Reconnect exhaustion raises
    :class:`DCNPeerLostError` naming the peer.
    """

    _REQ = "<IQ"     # spare lane count, requester round counter
    _HDR = "<IB"     # donated record count, donor-exhausted flag
    DONATE_CAP = 3200             # 3200 * 20 B = 62.5 KiB per frame
    _SOCKBUF = 1 << 18            # 256 KiB send/recv buffers
    _SLICE_S = 2.0                # per-I/O socket-timeout slice

    def __init__(self, pid: int, nproc: int, addrs,
                 recv_timeout_s: float = 120.0,
                 reconnect_attempts: int = 3,
                 reconnect_backoff_s: float = 0.25,
                 resync_window_s: float = 30.0):
        import socket
        import struct

        self.struct = struct
        self.socket = socket
        self.pid = pid
        self.nproc = nproc
        self.recv_timeout_s = float(recv_timeout_s)
        # drain-boundary deadline scaling (per-host resident mode): the
        # runner sets this to the slot count the PREVIOUS
        # drain retired, so a peer legitimately busy draining a deep
        # ring gets proportionally more frame time before
        # DCNPeerStalledError attributes it — same contract as
        # Watchdog.arm(scale=), never below the configured base deadline
        self.deadline_scale = 1.0
        self.reconnect_attempts = max(0, int(reconnect_attempts))
        self.reconnect_backoff_s = float(reconnect_backoff_s)
        # how long a resync waits for the lost peer to come back up
        # (redial + re-accept window); bounded so a peer that is gone
        # for good attributes instead of redialing forever
        self.resync_window_s = float(resync_window_s)
        if not addrs or len(addrs) != nproc:
            raise ValueError(
                "rebalance requires rebalance_addrs with one host:port "
                "per process"
            )
        self.addrs = list(addrs)
        # asymmetric-retry protection (see class docstring): my round
        # counter stamps every request; the serve side remembers the
        # last round it donated for so a RE-request re-donates
        self._round = 0
        self._served_round = None
        self._served_cache = None
        host, port = addrs[pid].rsplit(":", 1)
        # the listen socket stays open for the ring's lifetime: a reset
        # link re-ACCEPTS through it (reconnect support), exactly like
        # the initial handshake
        self._srv = socket.create_server((host, int(port)))
        self.next_sock = None
        self.prev_sock = None
        self._dial_next(120.0)
        self._accept_prev(120.0)

    # -- link plumbing --------------------------------------------------
    def _peer(self, which: str) -> int:
        return (self.pid + (1 if which == "next" else -1)) % self.nproc

    def _sock_opts(self, s):
        # short slices so the recv loop can enforce the overall deadline
        # (and deliver async cancellation) without OS-level blocking
        s.settimeout(min(self._SLICE_S, max(0.05, self.recv_timeout_s)))
        s.setsockopt(self.socket.SOL_SOCKET, self.socket.SO_SNDBUF,
                     self._SOCKBUF)
        s.setsockopt(self.socket.SOL_SOCKET, self.socket.SO_RCVBUF,
                     self._SOCKBUF)

    def _dial_next(self, window_s: float):
        nhost, nport = self.addrs[self._peer("next")].rsplit(":", 1)
        deadline = time.monotonic() + window_s
        self.next_sock = None
        while self.next_sock is None:
            try:
                self.next_sock = self.socket.create_connection(
                    (nhost, int(nport)), timeout=5
                )
            except OSError:
                if time.monotonic() > deadline:
                    raise DCNPeerLostError(
                        f"process {self.pid}: peer {self._peer('next')} "
                        f"({nhost}:{nport}) unreachable for "
                        f"{window_s:.0f}s"
                    )
                time.sleep(0.1)
        self._sock_opts(self.next_sock)

    def _accept_prev(self, window_s: float):
        self._srv.settimeout(window_s)
        try:
            self.prev_sock, _ = self._srv.accept()
        except self.socket.timeout:
            raise DCNPeerLostError(
                f"process {self.pid}: peer {self._peer('prev')} did not "
                f"redial within {window_s:.0f}s"
            ) from None
        self._sock_opts(self.prev_sock)

    def _resync(self):
        """Close and re-establish BOTH links. A neighbor that lost only
        one link observes OUR close on the other and resyncs too, so the
        repair cascades around the ring; fresh sockets also discard any
        half-frame bytes of the aborted round."""
        for s in (self.next_sock, self.prev_sock):
            try:
                s.close()
            except OSError:
                pass
        self._dial_next(self.resync_window_s)
        self._accept_prev(self.resync_window_s)

    def _run_round(self, fn, attempts: Optional[int] = None):
        """Run one ring round; on a transient connection failure, resync
        links (bounded, backed off) and retry the whole round. Lossless
        by construction: the serve side re-donates its cached records on
        a round re-request (see exchange) and callers apply nothing
        until the round returns. Stall deadlines do NOT retry — a
        stalled-but-connected peer is attributed, not waited out
        twice."""
        attempts = self.reconnect_attempts if attempts is None else attempts
        for attempt in range(attempts + 1):
            try:
                return fn()
            except DCNPeerError:
                raise
            except (ConnectionError, OSError) as e:
                if isinstance(e, self.socket.timeout):
                    raise      # sends/recvs convert slices to deadlines
                if attempt >= attempts:
                    raise DCNPeerLostError(
                        f"process {self.pid}: ring peer lost and "
                        f"{attempts} reconnect attempt(s) failed: {e}"
                    ) from e
                time.sleep(self.reconnect_backoff_s * (2 ** attempt))
                self._resync()
        raise AssertionError("unreachable")

    def _frame_deadline_s(self) -> float:
        """The live frame deadline: base recv timeout scaled by the
        slot count the previous resident drain retired (1.0 in lockstep
        single-step mode, so behavior there is byte-identical)."""
        return self.recv_timeout_s * max(1.0, float(self.deadline_scale))

    def _send_all(self, sock, data: bytes, peer: str = "peer") -> None:
        """sendall in socket-timeout slices under the SAME deadline the
        reads get: a peer that merely pauses (checkpoint sync, GC) while
        our frame overruns the kernel buffers is waited out up to
        ``recv_timeout_s`` (drain-scaled), then attributed — never
        killed on one 2-second slice."""
        frame_s = self._frame_deadline_s()
        deadline = time.monotonic() + frame_s
        view = memoryview(data)
        sent = 0
        while sent < len(view):
            try:
                sent += sock.send(view[sent:])
            except self.socket.timeout:
                if time.monotonic() >= deadline:
                    raise DCNPeerStalledError(
                        f"process {self.pid}: peer {peer} stalled — "
                        f"send stuck at {sent}/{len(view)} frame bytes "
                        f"after {frame_s:.1f}s"
                    ) from None
                continue

    def _recv_exact(self, sock, n: int, peer: str = "peer") -> bytes:
        # ONE injection hit per FRAME read (outside the slice loop):
        # occurrence-indexed rules stay deterministic regardless of how
        # many empty timeout slices the scheduler happens to produce
        faults.inject("dcn.recv", pid=self.pid, peer=peer, sock=sock)
        buf = b""
        frame_s = self._frame_deadline_s()
        deadline = time.monotonic() + frame_s
        while len(buf) < n:
            try:
                chunk = sock.recv(n - len(buf))
            except self.socket.timeout:
                if time.monotonic() >= deadline:
                    raise DCNPeerStalledError(
                        f"process {self.pid}: peer {peer} stalled — "
                        f"{len(buf)}/{n} frame bytes after "
                        f"{frame_s:.1f}s"
                    ) from None
                continue
            if not chunk:
                raise ConnectionResetError(
                    f"rebalance peer {peer} closed the link"
                )
            buf += chunk
        return buf

    def _serve_donation(self, want: int, req_round: int, poll_extra):
        """Serve one request, re-donating from the cache when the peer
        RE-requests a round we already served (its recv of our donation
        failed): the polled records went into a dead socket, not into
        the peer — re-donating them is what makes asymmetric-abort
        retry lossless; a NEW round always polls fresh."""
        if req_round == self._served_round and self._served_cache is not None:
            return self._served_cache
        donation = poll_extra(want) if want else (
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.float32), False,
        )
        self._served_round = req_round
        self._served_cache = donation
        return donation

    def exchange(self, spare: int, poll_extra):
        """One rebalance round. ``poll_extra(n)`` polls up to n records
        from this host's source, returning (keys, ts_ms, vals,
        exhausted). Returns (keys, ts_ms, vals, donor_done) received into
        this host's spare lanes."""
        st = self.struct

        def round_once():
            faults.inject("dcn.send", pid=self.pid, link="next",
                          sock=self.next_sock)
            self._send_all(
                self.next_sock, st.pack(self._REQ, int(spare), self._round),
                peer=f"next/{self._peer('next')}",
            )
            # serve the prev neighbor
            want, req_round = st.unpack(
                self._REQ,
                self._recv_exact(self.prev_sock, st.calcsize(self._REQ),
                                 peer=f"prev/{self._peer('prev')}"),
            )
            want = min(int(want), self.DONATE_CAP)
            keys, ts, vals, done = self._serve_donation(
                want, req_round, poll_extra
            )
            n = len(keys)
            self._send_all(
                self.prev_sock,
                st.pack(self._HDR, n, 1 if done else 0)
                + np.asarray(keys, np.int64).tobytes()
                + np.asarray(ts, np.int64).tobytes()
                + np.asarray(vals, np.float32).tobytes(),
                peer=f"prev/{self._peer('prev')}",
            )
            # collect my donation
            hdr = self._recv_exact(
                self.next_sock, st.calcsize(self._HDR),
                peer=f"next/{self._peer('next')}",
            )
            m, ddone = st.unpack(self._HDR, hdr)
            payload = self._recv_exact(
                self.next_sock, m * (8 + 8 + 4),
                peer=f"next/{self._peer('next')}",
            )
            rk = np.frombuffer(payload[: 8 * m], np.int64)
            rt = np.frombuffer(payload[8 * m: 16 * m], np.int64)
            rv = np.frombuffer(payload[16 * m:], np.float32)
            return rk, rt, rv, bool(ddone)

        out = self._run_round(round_once)
        self._round += 1
        return out

    def close(self):
        for s in (self.next_sock, self.prev_sock, self._srv):
            try:
                if s is not None:
                    s.close()
            except OSError:
                pass


class _TargetRing(_RebalanceRing):
    """Targeted ring router for the shuffle/global ingest partitioners
    (ref ShufflePartitioner.java / GlobalPartitioner.java): each cycle,
    every host stamps its polled records with a destination host and the
    ring relays frames ``nproc - 1`` hops (records flow p+1 -> p, the
    donation direction the sockets already run), so every record sits at
    its destination before the cycle's device step. Routing completes
    WITHIN the cycle — no cross-cycle in-flight records — so the
    cycle-boundary checkpoint cut stays a consistent exactly-once
    barrier without any new snapshot state.

    Termination: every frame carries the sender's accumulated
    all-sources-exhausted flag; after ``nproc - 1`` hops the AND covers
    the whole ring, and a host is done once that holds and it ingested
    nothing this cycle (the device-side stop conjunction still gates the
    ensemble, as for forward ingestion).

    Frames are (count, done, targets u8[n], keys i64[n], ts i64[n],
    vals f32[n]); the caller bounds per-cycle polls so the merged inflow
    never exceeds the lane budget (see _DCNRunnerBase._poll_budget).
    """

    def route(self, keys, ts_ms, vals, targets, exhausted: bool):
        """Returns (keys, ts_ms, vals, all_done) of the records whose
        destination is this host. The multi-hop relay is NOT retried on
        a reset: unlike the pairwise exchange (whose re-donation cache
        makes retry lossless), a host whose relay round COMPLETED while
        a neighbor's failed would see the neighbor's re-relayed records
        as next-round traffic and deliver duplicates — so a targeted-
        ring reset fails attributed (DCNPeerLostError) and recovery is
        the job-level restart-from-checkpoint path. Reads and sends
        still run under the stall deadline."""
        st = self.struct

        def round_once():
            mine_k, mine_t, mine_v = [], [], []

            def split(k, t, v, tgt):
                here = tgt == self.pid
                if here.any():
                    mine_k.append(k[here])
                    mine_t.append(t[here])
                    mine_v.append(v[here])
                away = ~here
                return k[away], t[away], v[away], tgt[away]

            pk, pt, pv, ptgt = split(
                np.asarray(keys, np.int64), np.asarray(ts_ms, np.int64),
                np.asarray(vals, np.float32), np.asarray(targets, np.uint8),
            )
            all_done = bool(exhausted)
            for _hop in range(self.nproc - 1):
                n = len(pk)
                faults.inject("dcn.send", pid=self.pid, link="prev",
                              sock=self.prev_sock)
                self._send_all(
                    self.prev_sock,
                    st.pack(self._HDR, n, 1 if all_done else 0)
                    + ptgt.tobytes() + pk.tobytes() + pt.tobytes()
                    + pv.tobytes(),
                    peer=f"prev/{self._peer('prev')}",
                )
                hdr = self._recv_exact(
                    self.next_sock, st.calcsize(self._HDR),
                    peer=f"next/{self._peer('next')}",
                )
                m, done_flag = st.unpack(self._HDR, hdr)
                payload = self._recv_exact(
                    self.next_sock, m * (1 + 8 + 8 + 4),
                    peer=f"next/{self._peer('next')}",
                )
                rtgt = np.frombuffer(payload[:m], np.uint8)
                rk = np.frombuffer(payload[m: m + 8 * m], np.int64)
                rt = np.frombuffer(payload[m + 8 * m: m + 16 * m],
                                   np.int64)
                rv = np.frombuffer(payload[m + 16 * m:], np.float32)
                all_done = all_done and bool(done_flag)
                pk, pt, pv, ptgt = split(rk, rt, rv, rtgt)
            if len(pk):
                raise RuntimeError(
                    f"{len(pk)} record(s) undeliverable after "
                    f"{self.nproc - 1} ring hops (bad target?)"
                )
            if mine_k:
                return (np.concatenate(mine_k), np.concatenate(mine_t),
                        np.concatenate(mine_v), all_done)
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.float32), all_done)

        return self._run_round(round_once, attempts=0)


def _tensor_fields(state):
    """The tensor fields of a shard state dataclass, by name."""
    return [f.name for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)]


class _DCNRunnerBase:
    """One process's half of a lockstep multi-host keyed job: the mesh,
    the ingest / step / emit loop, and checkpoint / restore. Subclasses
    set up their stage (``_build_step``: the local shard states in
    ``self.states`` and ``self._step``) and decode their fires
    (``_emit_local``). The step contract: ``step(hi, lo, ts, values,
    valid, wm, done) -> (aux, stop)`` over this host's padded lanes (numpy
    [B_local]; hi / lo the key identity's uint32 halves), its watermark
    and done flag, with ``stop`` the same bool on every process."""

    def __init__(self, spec: DCNJobSpec, process_id: int,
                 num_processes: int,
                 checkpoint_dir: Optional[str] = None,
                 ckpt_every: int = 0, restore: bool = False,
                 device=None, plane=None):
        from flink_tpu_torch.parallel.collectives import ProcessPlane
        from flink_tpu_torch.parallel.mesh import MeshContext, mesh_devices

        self.spec = spec
        self.pid = process_id
        self.nproc = num_processes
        self.ckpt_dir = checkpoint_dir
        self.ckpt_every = ckpt_every
        self.want_restore = restore
        self.source = spec.source_factory(process_id, num_processes)
        # emitted (key_id, window_start_ms, window_end_ms, value)
        self.rows_key = []
        self.rows_start = []
        self.rows_end = []
        self.rows_val = []
        self._persisted_chunks = 0   # rows chunks already in a checkpoint
        self.cycle = 0
        self._next_cid = 1

        self.device = resolve_device(device)
        self.plane = plane if plane is not None else \
            ProcessPlane(num_processes, process_id)
        if self.plane.nproc != num_processes or \
                self.plane.pid != process_id:
            raise RuntimeError(
                f"the plane is process {self.plane.pid} of "
                f"{self.plane.nproc}, the runner {process_id} of "
                f"{num_processes}")
        local = mesh_devices(self.device)
        self.L = len(local)
        self.n = self.L * num_processes
        self.ctx = MeshContext.create(self.n, spec.max_parallelism,
                                      devices=local,
                                      process_count=num_processes,
                                      process_index=process_id)
        self.devices = self.ctx.devices
        # per-host lane budget, one equal slice per local shard
        self.B_local = max(self.L, (spec.batch_per_host // self.L) * self.L)
        mode = spec.ingest_partitioner
        if spec.rebalance:
            mode = "rebalance"
        ring_kw = dict(
            recv_timeout_s=spec.peer_recv_timeout_s,
            reconnect_attempts=spec.peer_reconnect_attempts,
            reconnect_backoff_s=spec.peer_reconnect_backoff_s,
        )
        if mode in ("forward", "rescale") or num_processes == 1:
            self._ring, self._router = None, None
        elif mode == "rebalance":
            self._ring = _RebalanceRing(process_id, num_processes,
                                        spec.rebalance_addrs, **ring_kw)
            self._router = None
        elif mode in ("shuffle", "global"):
            self._ring = None
            self._router = _TargetRing(process_id, num_processes,
                                       spec.rebalance_addrs, **ring_kw)
        else:
            raise ValueError(
                f"unknown ingest_partitioner {mode!r} (forward | rescale "
                f"| rebalance | shuffle | global)")
        self._mode = mode
        if spec.steps_per_dispatch > 1:
            # explicit single-step fallback (never silent): fused
            # dispatch would hold batches across collective rounds, but
            # every host must enter the same all_to_all in the same
            # round
            print(
                f"[dcn] pipeline.steps-per-dispatch="
                f"{spec.steps_per_dispatch} does not apply to the "
                f"lockstep DCN plane; running single-step dispatch",
                file=sys.stderr,
            )
        self.ingested_local = 0   # records this host's lanes carried
        # per-host resident mode: the window runner sets self._drain and
        # self._resident_depth in _build_step
        self._drain = None
        self._resident_depth = 0
        self._build_step()
        if getattr(spec, "resident", False) and self._drain is None:
            raise ValueError(
                "DCNJobSpec.resident requires a time-window job "
                "(window_kind='time'); session/rolling/cep runners keep "
                "single-step lockstep dispatch"
            )
        self.local_wm_ticks = -(2**31) + 1
        if self.want_restore and self.ckpt_dir:
            self._restore_latest()

    # -- ingest partitioning ----------------------------------------------
    def _poll_budget(self) -> int:
        """Per-cycle source poll bound. Routed modes bound the MERGED
        inflow by the lane budget: global concentrates every host's poll
        on host 0 (sum of polls <= B), shuffle's balanced per-donor split
        hands each receiver at most ceil(poll/nproc) per donor (sum <= B
        after the nproc safety margin). A frame must also fit the ring
        sockets' buffers so sendall can't deadlock the lockstep."""
        B = self.B_local
        if self._router is None:
            return B
        frame_cap = _RebalanceRing._SOCKBUF // 32   # ~21 B/record + slack
        if self._mode == "global":
            return max(1, min(B // self.nproc, frame_cap))
        return max(1, min(B - self.nproc, frame_cap))

    def _targets(self, n: int) -> np.ndarray:
        """Destination host per polled record. shuffle: a balanced random
        assignment (each record's destination uniform, each cycle's
        per-donor counts equal to within one, so lane budgets hold).
        global: everything to host 0."""
        if self._mode == "global":
            return np.zeros(n, np.uint8)
        base = (np.arange(n, dtype=np.int64) % self.nproc).astype(np.uint8)
        rng = np.random.default_rng((self.pid, self.cycle))
        return rng.permutation(base)

    # -- host loop ---------------------------------------------------------
    def _poll_chunk(self, exhausted: bool, exchange: bool = True):
        """One padded ingest chunk: poll the source, run the ring /
        router side channels when ``exchange`` (the DCN boundary —
        resident mode's follow-up chunks stay host-local), pad to the
        lane budget and advance the local watermark. Returns ``(hi, lo,
        ts, values, valid, m, done_now, exhausted)``: hi / lo uint32, ts
        int32 ticks from ``origin_ms``, values float32, valid bool, all
        [B_local] numpy."""
        spec = self.spec
        B = self.B_local
        poll_budget = self._poll_budget()
        if not exhausted:
            keys, ts_ms, vals, exhausted = self.source.poll(poll_budget)
        else:
            keys = np.zeros(0, np.int64)
            ts_ms = np.zeros(0, np.int64)
            vals = np.zeros(0, np.float32)
        done_now = exhausted
        if self._router is not None:
            # targeted routing (shuffle/global): the per-host watermark
            # advances from the SOURCE's (pre-route) timestamps, so the
            # global pmin stays the true low mark
            if len(ts_ms):
                rel_max = int(np.asarray(ts_ms, np.int64).max()) \
                    - spec.origin_ms
                self.local_wm_ticks = min(max(
                    self.local_wm_ticks,
                    rel_max - spec.out_of_orderness_ms - 1,
                ), MAX_TICKS)
            if exchange:
                keys, ts_ms, vals, all_done = self._router.route(
                    keys, ts_ms, vals,
                    self._targets(len(keys)), exhausted,
                )
                done_now = all_done and len(keys) == 0
            else:
                # resident follow-up chunk: records stay on the polling
                # host's lanes (the exchange still delivers each to its
                # owning shard); peer done flags are learned at boundaries
                done_now = False
        if self._ring is not None:
            if exchange:
                rk, rt, rv, donor_done = self._ring.exchange(
                    B - len(keys), self.source.poll
                )
                if len(rk):
                    keys = np.concatenate([keys, rk])
                    ts_ms = np.concatenate([ts_ms, rt])
                    vals = np.concatenate([vals, rv])
                # keep cycling while the donor neighbor has records
                done_now = exhausted and donor_done and not len(rk)
            else:
                done_now = False
        m = len(keys)
        self.ingested_local += m
        h = key_identity64(keys) if m else np.zeros(0, np.uint64)
        hi = np.zeros(B, np.uint32)
        lo = np.zeros(B, np.uint32)
        hi[:m] = (h >> np.uint64(32)).astype(np.uint32)
        lo[:m] = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        ts = np.zeros(B, np.int32)
        if m:
            rts = np.asarray(ts_ms, np.int64) - spec.origin_ms
            if int(rts.max()) > MAX_TICKS or int(rts.min()) < 0:
                # refuse rather than silently clamp (clamped records
                # would all collapse into the MAX_TICKS window)
                bad = (int(rts.min()) if int(rts.min()) < 0
                       else int(rts.max()))
                raise ValueError(
                    f"timestamp {bad + spec.origin_ms} out of int32 "
                    f"tick range relative to origin_ms="
                    f"{spec.origin_ms}; set DCNJobSpec.origin_ms to "
                    f"(at most) the stream's first timestamp"
                )
            ts[:m] = rts.astype(np.int32)
        values = np.zeros(B, np.float32)
        values[:m] = vals
        valid = np.zeros(B, bool)
        valid[:m] = True
        if m and self._router is None:
            # routed modes advanced the watermark pre-route (above)
            self.local_wm_ticks = min(max(
                self.local_wm_ticks,
                int(rts.max()) - spec.out_of_orderness_ms - 1,
            ), MAX_TICKS)
        return hi, lo, ts, values, valid, m, done_now, exhausted

    def run(self) -> dict:
        if getattr(self.spec, "resident", False):
            return self._run_resident()
        exhausted = False
        while True:
            (hi, lo, ts, values, valid, _m, done_now,
             exhausted) = self._poll_chunk(exhausted)
            wm_now = MAX_TICKS if done_now else self.local_wm_ticks
            aux, stop = self._step(hi, lo, ts, values, valid, wm_now,
                                   done_now)
            self._emit_local(aux)
            self.cycle += 1
            # NO exhausted gate: with unequal partitions one host drains
            # early, and gating on the local flag would leave the ensemble
            # unable to ever complete another checkpoint (a drained
            # source's offset snapshot is simply its final offset)
            if self.ckpt_dir and self.ckpt_every and \
                    self.cycle % self.ckpt_every == 0:
                self._write_checkpoint()
            if stop:
                break
        return self._finish()

    def _run_resident(self) -> dict:
        """Per-host resident mode: each cycle polls up to
        ``resident_ring_depth`` chunks — the FIRST runs the DCN
        side-channel exchange (the drain boundary); follow-ups stay
        host-local — and retires them all in ONE drain dispatch. Stop,
        watermark and fill agreement ride the drain's collectives, and
        the side channels' frame deadlines scale with the slots the
        previous drain retired (a host deep in a long drain is making
        progress, not stalled)."""
        drain = self._drain   # __init__ guarantees this for resident specs
        B = self.B_local
        D = self._resident_depth
        exhausted = False
        drained_prev = 1
        while True:
            for ch in (self._ring, self._router):
                if ch is not None:
                    ch.deadline_scale = max(1.0, float(drained_prev))
            hi_s = np.zeros((D, B), np.uint32)
            lo_s = np.zeros((D, B), np.uint32)
            ts_s = np.zeros((D, B), np.int32)
            val_s = np.zeros((D, B), np.float32)
            ok_s = np.zeros((D, B), bool)
            wm_s = np.empty(D, np.int32)
            fill = 0
            done_now = False
            for ci in range(D):
                (hi, lo, ts, values, valid, m, done_now,
                 exhausted) = self._poll_chunk(exhausted, exchange=ci == 0)
                hi_s[fill], lo_s[fill], ts_s[fill] = hi, lo, ts
                val_s[fill], ok_s[fill] = values, valid
                wm_s[fill] = np.int32(
                    MAX_TICKS if done_now else self.local_wm_ticks)
                fill += 1
                if done_now or m == 0:
                    # a dry local poll ends the cycle early: padding the
                    # drain with empty slots buys nothing, and the next
                    # boundary may land records from peers
                    break
            wm_s[fill:] = wm_s[fill - 1]  # pad slots hold the frontier
            _states, cfs, stop, drained = drain(
                self.states, hi_s, lo_s, ts_s, val_s, ok_s, wm_s,
                1 if done_now else 0, fill)
            drained_prev = int(drained)
            self._emit_local(cfs, drained_prev)
            self.cycle += 1
            if self.ckpt_dir and self.ckpt_every and \
                    self.cycle % self.ckpt_every == 0:
                self._write_checkpoint()
            if stop:
                break
        return self._finish()

    def _finish(self) -> dict:
        if self._ring is not None:
            self._ring.close()
        if self._router is not None:
            self._router.close()
        return {
            "key_id": (np.concatenate(self.rows_key)
                       if self.rows_key else np.zeros(0, np.uint64)),
            "window_start_ms": (np.concatenate(self.rows_start)
                                if self.rows_start
                                else np.zeros(0, np.int64)),
            "window_end_ms": (np.concatenate(self.rows_end)
                              if self.rows_end else np.zeros(0, np.int64)),
            "value": (np.concatenate(self.rows_val)
                      if self.rows_val else np.zeros(0, np.float32)),
            "cycles": self.cycle,
            "ingested_local": self.ingested_local,
            "dropped_capacity": self._state_dropped(),
        }

    def _state_dropped(self) -> int:
        """The drop counter of THIS process's shard states. It lives in the
        checkpointed state (exchange overflow and table-full drops fold
        into it inside the step), so it survives kill-recover — a run
        that lost records can never report an affirmative zero."""
        return int(sum(int(st.dropped_capacity) for st in self.states))

    def _push_rows(self, k64, starts, ends, vals):
        self.rows_key.append(k64)
        self.rows_start.append(starts)
        self.rows_end.append(ends)
        self.rows_val.append(vals)

    # -- checkpoint / restore ---------------------------------------------
    # Deterministic lockstep cadence: every process reaches cycle k
    # together, so "all P proc files for cid exist" is a consistent global
    # cut (the step boundary IS the barrier).
    def _write_checkpoint(self):
        cid = self._next_cid
        # fault seam: a raising rule models a process crashing mid-cut;
        # the lockstep cadence means the ensemble's OTHER procs publish
        # their halves and restore skips the globally-incomplete cid
        faults.inject("dcn.ckpt.write", pid=self.pid, cid=cid)
        d = os.path.join(self.ckpt_dir, f"chk-{cid:06d}")
        os.makedirs(d, exist_ok=True)
        arrs = {}
        for name in _tensor_fields(self.states[0]):
            arrs[f"state.{name}"] = np.stack(
                [getattr(st, name).cpu().numpy() for st in self.states])
        # emission DELTA since the previous checkpoint: each checkpoint is
        # O(new rows), and restore replays the deltas in cid order
        for key, rows, empty in (
                ("rows_key", self.rows_key, np.uint64),
                ("rows_start", self.rows_start, np.int64),
                ("rows_end", self.rows_end, np.int64),
                ("rows_val", self.rows_val, np.float32)):
            delta = rows[self._persisted_chunks:]
            arrs[key] = (np.concatenate(delta) if delta
                         else np.zeros(0, empty))
        tmpf = tempfile.NamedTemporaryFile(
            dir=d, prefix=f"proc-{self.pid}.", suffix=".tmp", delete=False
        )
        np.savez(tmpf, **arrs)
        tmpf.close()
        os.replace(tmpf.name, os.path.join(d, f"proc-{self.pid}.npz"))
        meta = {
            "cycle": self.cycle,
            "wm_ticks": self.local_wm_ticks,
            "source": self.source.snapshot(),
            "next_cid": cid + 1,
        }
        tmp = os.path.join(d, f"proc-{self.pid}.meta.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(d, f"proc-{self.pid}.meta.json"))
        self._next_cid = cid + 1
        self._persisted_chunks = len(self.rows_key)

    def _latest_complete(self) -> Optional[str]:
        if not os.path.isdir(self.ckpt_dir):
            return None
        best = None
        for name in sorted(os.listdir(self.ckpt_dir)):
            if not name.startswith("chk-"):
                continue
            d = os.path.join(self.ckpt_dir, name)
            if all(
                os.path.exists(os.path.join(d, f"proc-{p}.meta.json"))
                for p in range(self.nproc)
            ):
                best = d
        return best

    def _restore_latest(self):
        d = self._latest_complete()
        if d is None:
            return
        # fault seam: restore-time read of this process's half of the cut
        faults.inject("dcn.ckpt.read", pid=self.pid)
        with open(os.path.join(d, f"proc-{self.pid}.meta.json")) as f:
            meta = json.load(f)
        data = np.load(os.path.join(d, f"proc-{self.pid}.npz"))
        for name in _tensor_fields(self.states[0]):
            arr = data[f"state.{name}"]
            for s, st in enumerate(self.states):
                old = getattr(st, name)
                setattr(st, name, torch.as_tensor(arr[s]).to(old.device))
        # emissions = concatenation of every delta up to (and including)
        # the restored cut; deltas past it belong to a globally
        # incomplete checkpoint and will be re-emitted by replay
        self.rows_key, self.rows_start = [], []
        self.rows_end, self.rows_val = [], []
        chosen = os.path.basename(d)
        for name in sorted(os.listdir(self.ckpt_dir)):
            if not name.startswith("chk-") or name > chosen:
                continue
            delta = np.load(os.path.join(
                self.ckpt_dir, name, f"proc-{self.pid}.npz"
            ))
            if len(delta["rows_key"]):
                self._push_rows(delta["rows_key"], delta["rows_start"],
                                delta["rows_end"], delta["rows_val"])
        self._persisted_chunks = len(self.rows_key)
        self.cycle = int(meta["cycle"])
        self._next_cid = int(meta["next_cid"])
        self.local_wm_ticks = int(meta["wm_ticks"])
        self.source.restore(meta["source"])

    # -- the replicate side of replicate-and-mask --------------------------
    def _gather(self, hi, lo, ts, values, valid):
        """Every host's lanes, in host order (the reference's tiled
        ``all_gather`` of the lane-sharded batch): one all_gather of this
        host's five columns packed as int32 [5, B_local]. Returns the
        global columns as CPU tensors: hi, lo (int32 bits), ts, values
        (float32), valid (bool), [nproc x B_local] each."""
        cols = torch.from_numpy(np.stack([
            hi.view(np.int32), lo.view(np.int32), ts,
            values.view(np.int32), valid.astype(np.int32)]))
        g = self.plane.all_gather(cols).transpose(0, 1).reshape(5, -1)
        return (g[0], g[1], g[2], g[3].view(torch.float32), g[4] != 0)


def _key64(khi: np.ndarray, klo: np.ndarray) -> np.ndarray:
    return (khi.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | klo.view(np.uint32).astype(np.uint64)


class DCNWindowRunner(_DCNRunnerBase):
    """Aligned time windows (tumbling AND sliding via the pane ring) over
    the global mesh; the keyed shuffle is ONE all_to_all a step. The
    lockstep step is the DCN drain at depth 1 (``runtime/step.py
    build_window_dcn_resident_drain``); resident mode runs it at
    ``resident_ring_depth``."""

    def _build_step(self):
        from flink_tpu_torch.ops import window_kernels as wk
        from flink_tpu_torch.runtime import step as step_mod

        spec = self.spec
        if spec.size_ms <= 0:
            raise ValueError(
                "time-window DCN job requires size_ms > 0 "
                "(set DCNJobSpec.size_ms)"
            )
        slide = spec.slide_ms or spec.size_ms
        if spec.size_ms % slide:
            raise ValueError(
                f"size_ms {spec.size_ms} must be a multiple of slide_ms "
                f"{slide}"
            )
        ppw = spec.size_ms // slide
        # ring covers in-flight windows + out-of-orderness backlog (the
        # executor's sizing)
        ring = max(8, 2 * ppw + spec.out_of_orderness_ms // slide + 4)
        self.win = wk.WindowSpec(
            size_ticks=spec.size_ms, slide_ticks=slide,
            ring=ring, fires_per_step=spec.fires_per_step,
        )
        self.red = wk.ReduceSpec(kind=spec.reduce_kind)
        self.stage = step_mod.WindowStageSpec(
            win=self.win, red=self.red,
            capacity_per_shard=spec.capacity_per_shard, layout="hash",
            probe_len=16)
        bpd = self.B_local // self.L    # lanes per local shard
        self.states = [step_mod.init_shard_state(
            self.stage, spec.max_parallelism, d) for d in self.devices]
        depth = max(1, int(spec.resident_ring_depth)) if spec.resident \
            else 1
        drain = step_mod.build_window_dcn_resident_drain(
            self.ctx, self.stage, bpd, depth, capacity_factor=2.0,
            plane=self.plane)
        self.bucket_cap = drain.bucket_cap
        if spec.resident:
            # the drain IS the lockstep body run up to
            # resident_ring_depth times per dispatch
            self._drain = drain
            self._resident_depth = depth
            return

        def step(hi, lo, ts, values, valid, wm, done):
            _st, cfs, stop, drained = drain(
                self.states, hi[None], lo[None], ts[None], values[None],
                valid[None], [wm], 1 if done else 0, 1)
            return (cfs, drained), stop

        self._step = step

    def _emit_local(self, cfs, drained: Optional[int] = None):
        """Each process emits fires from ITS shards only — "records enter
        on host A, fire from host B" is literal: the keys in these rows
        arrived through the all_to_all from whichever host ingested them.
        ``cfs`` is each local shard's CompactFires stacked [depth, F];
        the first ``drained`` slots fired. Reads the lanes' counts, then
        only the fired prefixes."""
        if drained is None:
            cfs, drained = cfs
        size = self.spec.size_ms
        origin = self.spec.origin_ms
        for cf in cfs:
            counts = cf.counts[:drained].cpu().numpy()
            lanes = cf.lane_valid[:drained].cpu().numpy()
            ends = cf.window_end_ticks[:drained].cpu().numpy()
            live = [(i, f, int(counts[i, f])) for i, f in
                    zip(*np.nonzero(lanes & (counts > 0)))]
            if not live:
                continue
            khi = torch.cat([cf.key_hi[i, f, :c] for i, f, c in live])
            klo = torch.cat([cf.key_lo[i, f, :c] for i, f, c in live])
            vals = torch.cat([cf.values[i, f, :c] for i, f, c in live])
            k64 = _key64(khi.cpu().numpy(), klo.cpu().numpy())
            end_ms = np.concatenate([
                np.full(c, int(ends[i, f]) + origin, np.int64)
                for i, f, c in live])
            self._push_rows(k64, end_ms - size, end_ms,
                            vals.cpu().numpy().astype(np.float32))


class DCNSessionRunner(_DCNRunnerBase):
    """Gap-merged session windows over the global mesh. The session stage
    is replicate-and-mask, so the DCN hop is ONE all_gather of every
    host's lanes onto every shard, and G1's owner mask keeps each shard's
    key groups; watermark and termination ride pmin exactly like the
    time-window runner. Sessions merging records from DIFFERENT hosts is
    the point: the gap merge happens in the owning shard's state wherever
    the records entered."""

    def _build_step(self):
        from flink_tpu_torch.ops import window_kernels as wk
        from flink_tpu_torch.runtime import step as step_mod

        spec = self.spec
        if spec.gap_ms <= 0:
            raise ValueError("session DCN job requires gap_ms > 0")
        if spec.reduce_kind not in ("sum", "count"):
            raise NotImplementedError(
                f"{spec.reduce_kind} reduces over session windows are not "
                f"ported to flink_tpu_torch yet (ROADMAP queue 1, item 9)")
        stage = step_mod.SessionStageSpec(
            red=wk.ReduceSpec(kind=spec.reduce_kind), gap_ticks=spec.gap_ms,
            capacity_per_shard=spec.capacity_per_shard)
        self.states = [step_mod.init_session_state(stage, d)
                       for d in self.devices]
        # the mesh's session step over this process's shards: G1's owner
        # mask, then G5, G10 and G11 a shard
        sharded = step_mod.build_session_step_sharded(self.ctx, stage)
        count = spec.reduce_kind == "count"

        def step(hi, lo, ts, values, valid, wm, done):
            (gwm, gdone), _ = self.plane.agree(mins=[wm, int(done)])
            h, l, t, v, ok = self._gather(hi, lo, ts, values, valid)
            if count:
                v = torch.ones_like(v)
            _st, fires = sharded(self.states, h, l, t, v, ok,
                                 torch.tensor(gwm, dtype=torch.int32))
            # sessions opened by the final batch need ONE empty follow-up
            # step at wm=MAX to flush, so stop only on a globally
            # record-free exhausted step
            return fires, bool(gdone) and not bool(ok.any())

        self._step = step

    def _emit_local(self, fires):
        """Session fires from this process's shards: each shard's rows
        (key hi, key lo, start, end = last + gap, value) in the prefix
        ``[:n_rows]`` — superseded open sessions, superseded batch
        sessions, watermark closes."""
        origin = self.spec.origin_ms
        for rows, n_rows, _marks in fires:
            n = int(n_rows)
            if not n:
                continue
            khi, klo, start, end = (r[:n].cpu().numpy() for r in rows[:4])
            self._push_rows(_key64(khi, klo),
                            start.astype(np.int64) + origin,
                            end.astype(np.int64) + origin,
                            rows[4][:n].cpu().numpy().astype(np.float32))


class DCNRollingRunner(_DCNRunnerBase):
    """Rolling keyed sum (the reference's StreamGroupedReduce on
    ValueState) over the global mesh: records route to their owner shard
    through the SAME one-collective keyed shuffle as the window runner
    (G26 and the plane's all_to_all), the owner masks them to its key
    groups (G1) and applies the running sum (G5, G10, G13), and the
    per-record UPDATED aggregate emits from the owner shard. Per-key
    emission order equals per-key arrival order on the owning channel;
    there is no cross-key global order, exactly as in the reference.
    Bucket overflow folds into the state's ``dropped_capacity``."""

    def _build_step(self):
        from flink_tpu_torch.ops import rolling
        from flink_tpu_torch.parallel.exchange import (
            bucket_capacity, exchange_across, owned_lanes, split_lanes,
        )
        from flink_tpu_torch.parallel.mesh import device_guard

        spec = self.spec
        if spec.reduce_kind != "sum":
            raise NotImplementedError(
                f"rolling {spec.reduce_kind} reduces are not ported to "
                f"flink_tpu_torch yet (ROADMAP queue 1, item 9)")
        n = self.n
        maxp = spec.max_parallelism
        bpd = self.B_local // self.L
        cap = bucket_capacity(bpd, n, 2.0)
        self.bucket_cap = cap
        ranges = [(r.start, r.end) for r in self.ctx.local_key_group_ranges]
        self.states = [rolling.init_state(spec.capacity_per_shard, d)
                       for d in self.devices]

        def step(hi, lo, ts, values, valid, wm, done):
            (gdone,), _ = self.plane.agree(mins=[int(done)])
            slot = tuple(torch.from_numpy(c) for c in (
                hi.view(np.int32), lo.view(np.int32), ts, values, valid))
            received, over = exchange_across(
                self.plane, split_lanes(slot, self.L, self.devices), n,
                maxp, cap, self.devices)
            aux = []
            for s, dev in enumerate(self.devices):
                st = self.states[s]
                with device_guard(dev):
                    r_hi, r_lo, _ts, r_v, r_ok = received[s]
                    mine = owned_lanes(r_hi, r_lo, r_ok, *ranges[s], maxp)
                    _st, out, out_ok = rolling.update(st, r_hi, r_lo, r_v,
                                                      mine)
                    st.dropped_capacity.add_(over[s].to(dev).reshape(()))
                aux.append((r_hi, r_lo, out, out_ok))
            # rolling has no fire backlog: the ensemble stops when every
            # source is drained
            return aux, bool(gdone)

        self._step = step

    def _emit_local(self, aux):
        """Emit (key, updated aggregate) per exchanged record from THIS
        process's shards. window_start/end are 0: rolling emissions are
        continuous per-record updates, not window results."""
        for r_hi, r_lo, out, ok in aux:
            idx = torch.nonzero(ok).reshape(-1)
            if not idx.numel():
                continue
            k64 = _key64(r_hi[idx].cpu().numpy(), r_lo[idx].cpu().numpy())
            z = np.zeros(len(k64), np.int64)
            self._push_rows(k64, z, z.copy(),
                            out[idx].cpu().numpy().astype(np.float32))


class DCNCEPRunner(_DCNRunnerBase):
    """Device count-NFA pattern matching over the global mesh.
    Replicate-and-mask like the session runner: ONE all_gather puts every
    host's lanes on every shard, G1's owner mask keeps each shard's key
    groups, each shard advances the NFA for them (G5, G10, G19), and
    match completions emit from the OWNER shard. Cross-host event order
    is the deterministic lockstep lane order (cycle-major, host-major).
    Stage predicates evaluate at the INGESTING host (bits packed in the
    value lane, see DCNJobSpec); the device carries only the bit masks.
    within() is not carried here: its pane ring needs pane-quantized
    batches, which the lockstep loop does not cut — a pattern with
    within_ms raises rather than silently ignoring the bound. Rows are
    (key, completion ts, completions-at-event), the match-count stream."""

    def _build_step(self):
        from flink_tpu_torch.cep import device as cdev
        from flink_tpu_torch.cep.accel import advance_shards

        spec = self.spec
        if spec.cep_pattern_factory is None:
            raise ValueError(
                "cep DCN job requires DCNJobSpec.cep_pattern_factory"
            )
        pattern = spec.cep_pattern_factory()
        if getattr(pattern, "within_ms", None):
            raise ValueError(
                "within() is not supported on the DCN CEP runner yet "
                "(needs pane-quantized batches); run single-host or drop "
                "the within bound"
            )
        dspec = cdev.DevicePatternSpec.from_pattern(pattern)
        S = dspec.n_stages
        if S > 24:
            raise ValueError(
                f"{S} stages exceed the 24 mask bits a float32 value "
                f"lane carries exactly"
            )
        self.states = [cdev.init_state(spec.capacity_per_shard, 16, dspec,
                                       d) for d in self.devices]

        def step(hi, lo, ts, values, valid, wm, done):
            (gdone,), _ = self.plane.agree(mins=[int(done)])
            h, l, t, v, ok = self._gather(hi, lo, ts, values, valid)
            bits = v.to(torch.int32)
            masks = ((bits[:, None] >> torch.arange(S, dtype=torch.int32))
                     & 1).bool()
            shards = advance_shards(self.ctx, self.states, dspec, h, l,
                                    masks, ok)
            aux = [(h, l, t, delta) for delta, _mine in shards]
            # count-NFA matches complete on arrival: nothing flushes at
            # end of stream, so stop when every source is drained
            return aux, bool(gdone)

        self._step = step

    def _emit_local(self, aux):
        """Emit (key, completion ts, matches-completed-at-event) from THIS
        process's shards — deltas are nonzero only on lanes whose key the
        shard owns."""
        origin = self.spec.origin_ms
        for h, l, t, delta in aux:
            delta = delta.cpu()
            idx = torch.nonzero(delta).reshape(-1)
            if not idx.numel():
                continue
            k64 = _key64(h[idx].numpy(), l[idx].numpy())
            self._push_rows(k64, np.zeros(len(k64), np.int64),
                            t[idx].numpy().astype(np.int64) + origin,
                            delta[idx].numpy().astype(np.float32))


def runner_for_spec(spec: DCNJobSpec, process_id: int, num_processes: int,
                    **kw) -> _DCNRunnerBase:
    if spec.window_kind == "session":
        return DCNSessionRunner(spec, process_id, num_processes, **kw)
    if spec.window_kind == "time":
        return DCNWindowRunner(spec, process_id, num_processes, **kw)
    if spec.window_kind == "rolling":
        return DCNRollingRunner(spec, process_id, num_processes, **kw)
    if spec.window_kind == "cep":
        return DCNCEPRunner(spec, process_id, num_processes, **kw)
    raise ValueError(f"unknown window_kind {spec.window_kind!r}")


def _timed(run, device, profile: bool):
    """``run()`` timed to the end of its device work: (what it returned,
    its seconds, the card's (start, end) activity intervals in us when
    ``profile``, the seconds the profiler took to start and to stop, and
    the run's start and end on the wall clock).
    The profiler records the card alone, and its trace is read after the
    clock stops."""
    import contextlib

    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as profiler
        prof = profiler(activities=[ProfilerActivity.CUDA])
    t_in = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        t0, wall0 = time.perf_counter(), time.time()
        out = run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1, wall1 = time.perf_counter(), time.time()
    spans = []
    if prof is not None:
        from torch.autograd import DeviceType
        spans = [(ev.start_ns() / 1e3,
                  (ev.start_ns() + ev.duration_ns()) / 1e3)
                 for ev in prof.profiler.kineto_results.events()
                 if ev.device_type() == DeviceType.CUDA]
    return out, t1 - t0, spans, {"profiler_start_s": t0 - t_in,
                                 "profiler_stop_s": time.perf_counter() - t1,
                                 "run_epoch_s": [wall0, wall1]}


def main(argv=None) -> int:
    import argparse

    from flink_tpu_torch.ops import cuda as kernels
    from flink_tpu_torch.parallel.collectives import ProcessPlane
    from flink_tpu_torch.parallel.mesh import force_device_count
    from flink_tpu_torch.runtime.worker import load_builder

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True, help="HOST:PORT")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--builder", required=True,
                    help="module:function returning a DCNJobSpec")
    ap.add_argument("--builder-kwargs", default="{}",
                    help="a JSON object of the builder's keyword arguments")
    ap.add_argument("--out", required=True, help="result .npz path")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--local-devices", type=int, default=0,
                    help="force this many local shards on the device "
                         "(0: one a visible card)")
    ap.add_argument("--device", default=None,
                    help="cpu runs the kernels' plain versions; the "
                         "default is the CUDA card")
    ap.add_argument("--timeout-s", type=float, default=300.0,
                    help="the Gloo group's timeout for one collective")
    ap.add_argument("--profile", action="store_true",
                    help="record the card's activity under torch.profiler "
                         "and save its intervals with the result")
    a = ap.parse_args(argv)

    t_main = time.perf_counter()
    device = resolve_device(a.device)
    if a.local_devices:
        force_device_count(a.local_devices)
    plane = ProcessPlane(a.num_processes, a.process_id, a.coordinator,
                         timeout_s=a.timeout_s)
    try:
        spec = load_builder(a.builder)(**json.loads(a.builder_kwargs))
        runner = runner_for_spec(
            spec, a.process_id, a.num_processes,
            checkpoint_dir=a.checkpoint_dir or None,
            ckpt_every=a.ckpt_every, restore=a.restore, device=device,
            plane=plane,
        )
        setup_s = time.perf_counter() - t_main
        out, seconds, spans, prof_s = _timed(runner.run, device, a.profile)
    finally:
        plane.close()
    tmp = a.out + ".tmp"
    with open(tmp, "wb") as f:    # file object: savez appends no suffix
        np.savez(f, key_id=out["key_id"],
                 window_start_ms=out["window_start_ms"],
                 window_end_ms=out["window_end_ms"], value=out["value"],
                 dropped_capacity=out["dropped_capacity"],
                 busy_spans_us=np.asarray(spans, np.float64).reshape(-1, 2))
    os.replace(tmp, a.out)
    print(json.dumps({"rows": int(len(out["key_id"])),
                      "cycles": out["cycles"], "pid": a.process_id,
                      "dropped_capacity": out["dropped_capacity"],
                      "ingested_local": int(out["ingested_local"]),
                      "seconds": seconds, "setup_s": setup_s, **prof_s,
                      "gloo_bytes_sent": plane.bytes_sent,
                      "gloo_rounds": plane.rounds,
                      "launches": {fn.__name__: fn.launches
                                   for fn in kernels.KERNELS}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
