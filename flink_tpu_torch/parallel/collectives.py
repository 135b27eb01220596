"""Collectives over the shard mesh — the counterparts of ``lax.all_to_all``,
``lax.all_gather``, ``lax.psum``, ``lax.pmin`` and ``lax.pmax`` over the
reference's ``shards`` axis.

Within one process (``parallel/mesh.py``) a collective is device copies:
between shards on one device a copy within it, between cards a
peer-to-peer copy. Each shard's part runs under its device's guard, on
that device's current stream. The path for shards on several cards is
written but has run on none: the machines the port is tested on hold one
card (ROADMAP queue 1, item 10).

Between processes (a mesh over several worker processes, the DCN plane of
``runtime/dcn.py``) the collectives ride a ``torch.distributed`` Gloo
group (``ProcessPlane``), the counterpart of the reference's
``jax.distributed`` mesh. NCCL refuses two ranks on one card, and the
plane's tests and its card run put two worker processes on one device,
so the plane stages what crosses processes through host buffers (pinned
on a card): each shard's buckets for other processes are copied off the
device on its stream, the stream is synchronised, Gloo moves them, and
the received buckets are copied back before anything reads them. The
buckets that stay in the process stay device copies. The control values
(watermarks, done flags, fills, the fire backlog) are int64 host values
agreed by one ``all_reduce(MIN)`` a round, a maximum as a negated
minimum.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import torch

from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.parallel.mesh import device_guard


def _same_device(ts: Sequence[torch.Tensor]) -> bool:
    return all(t.device == ts[0].device for t in ts)


def all_to_all(bufs: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    """``bufs[s]`` is sender s's ``[n * cap, ...]`` send buffer (bucket t at
    ``[t * cap, (t + 1) * cap)``); returns, for each receiver t on
    ``devices[t]``, the ``[n * cap, ...]`` buffer whose slice s is sender
    s's bucket t (``lax.all_to_all`` with split and concat axis 0, tiled).
    Shards on one device: one stack and one transposing copy there."""
    n = len(bufs)
    cap = bufs[0].shape[0] // n
    tail = tuple(bufs[0].shape[1:])
    if _same_device(bufs) and all(torch.device(d) == bufs[0].device
                                  for d in devices):
        send = torch.stack(list(bufs)).reshape((n, n, cap) + tail)
        recv = send.transpose(0, 1).reshape((n, n * cap) + tail)
        return list(recv.unbind(0))
    out = []
    for t, dev in enumerate(devices):
        dev = torch.device(dev)
        with device_guard(dev):
            r = torch.empty((n * cap,) + tail, dtype=bufs[0].dtype,
                            device=dev)
            for s in range(n):
                r[s * cap:(s + 1) * cap].copy_(
                    bufs[s][t * cap:(t + 1) * cap], non_blocking=True)
        out.append(r)
    return out


def psum(outs: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
         device) -> tuple:
    """The rolling reduce's merge across shards: each shard's masked
    outputs ``outs[s]`` (float32 [B, ...]) and lanes ``valids[s]`` (bool
    [B]) staged on ``device``, then summed by G27 in shard order with the
    valid lanes OR-ed. Returns (out, valid) on ``device``."""
    device = torch.device(device)
    outs = [o.to(device, non_blocking=True) for o in outs]
    valids = [v.to(device, non_blocking=True) for v in valids]
    return kernels.shard_sum(outs, valids)



class ProcessPlane:
    """The collectives between the processes of a mesh: a Gloo group of
    ``num_processes`` ranks, this process rank ``process_id``. One process
    needs no group: every collective is then local. ``bytes_sent`` counts
    the payload bytes this process handed Gloo for other processes and
    ``rounds`` the collectives it entered (the plane's traffic, for the
    card run's per-round figure)."""

    def __init__(self, num_processes: int = 1, process_id: int = 0,
                 coordinator: Optional[str] = None,
                 timeout_s: float = 300.0):
        self.nproc = int(num_processes)
        self.pid = int(process_id)
        self.bytes_sent = 0
        self.rounds = 0
        self._pinned = {}
        if self.nproc == 1:
            self._dist = None
            return
        import torch.distributed as dist

        if not dist.is_initialized():
            if not coordinator:
                raise ValueError("a plane over several processes needs the "
                                 "coordinator's HOST:PORT")
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coordinator}",
                rank=self.pid, world_size=self.nproc,
                timeout=datetime.timedelta(seconds=timeout_s))
        if dist.get_world_size() != self.nproc or \
                dist.get_rank() != self.pid:
            raise RuntimeError(
                f"the process group is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, the plane wants {self.pid} of "
                f"{self.nproc}")
        self._dist = dist

    def close(self) -> None:
        if self._dist is not None and self._dist.is_initialized():
            self._dist.destroy_process_group()
        self._dist = None

    def _host(self, key, shape, dtype, device) -> torch.Tensor:
        """A reusable host buffer, pinned when ``device`` is a card."""
        k = (key, tuple(shape), dtype)
        buf = self._pinned.get(k)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype,
                              pin_memory=torch.device(device).type == "cuda")
            self._pinned[k] = buf
        return buf

    def agree(self, mins: Sequence[int] = (), maxs: Sequence[int] = ()):
        """``pmin`` of each of ``mins`` and ``pmax`` of each of ``maxs``
        over every process, in one all_reduce. Returns (mins, maxs) as
        lists of ints."""
        mins, maxs = [int(v) for v in mins], [int(v) for v in maxs]
        if self._dist is None:
            return mins, maxs
        t = torch.tensor(mins + [-v for v in maxs], dtype=torch.int64)
        self._dist.all_reduce(t, op=self._dist.ReduceOp.MIN)
        self.rounds += 1
        vals = t.tolist()
        return vals[:len(mins)], [-v for v in vals[len(mins):]]

    def all_gather(self, local: torch.Tensor) -> torch.Tensor:
        """Every process's host tensor ``local`` stacked in process order:
        ``[nproc, *local.shape]`` (``lax.all_gather`` of each host's lanes,
        which start on the host)."""
        if self._dist is None:
            return local[None]
        local = local.contiguous()
        parts = [torch.empty_like(local) for _ in range(self.nproc)]
        self._dist.all_gather(parts, local)
        self.rounds += 1
        self.bytes_sent += local.numel() * local.element_size() * (
            self.nproc - 1)
        return torch.stack(parts)

    def all_to_all(self, sends: Sequence[torch.Tensor],
                   devices) -> List[torch.Tensor]:
        """The all_to_all over every shard of every process. ``sends[i]``
        is this process's shard i's ``[n, *cell]`` send buffer on
        ``devices[i]`` (bucket t for global shard t, n = nproc x L); returns
        for each local shard j, on ``devices[j]``, the ``[n, *cell]`` buffer
        whose row s is global shard s's bucket for shard ``pid * L + j``
        (the reference's tiled ``all_to_all`` over the global mesh). Rows
        from this process are device copies; the others cross Gloo through
        host buffers."""
        L, P, me = len(sends), self.nproc, self.pid
        cell = tuple(sends[0].shape[1:])
        views = [s.reshape((P, L) + cell) for s in sends]
        recv = []
        for j, dev in enumerate(devices):
            dev = torch.device(dev)
            with device_guard(dev):
                r = torch.empty((P, L) + cell, dtype=sends[0].dtype,
                                device=dev)
                for i in range(L):
                    r[me, i].copy_(views[i][me, j], non_blocking=True)
            recv.append(r)
        if P > 1:
            # host rows: one a remote process, in rank order
            others = [q for q in range(P) if q != me]
            dt = sends[0].dtype
            shape = (P - 1, L, L) + cell
            h_in = self._host("a2a_in", shape, dt, devices[0])
            h_out = self._host("a2a_out", shape, dt, devices[0])
            for i, dev in enumerate(devices):
                with device_guard(dev):
                    for r, q in enumerate(others):
                        h_in[r, i].copy_(views[i][q], non_blocking=True)
            for dev in {torch.device(d) for d in devices}:
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
            splits = [0 if q == me else 1 for q in range(P)]
            self._dist.all_to_all_single(h_out, h_in, splits, splits)
            self.rounds += 1
            self.bytes_sent += h_in.numel() * h_in.element_size()
            for j, dev in enumerate(devices):
                with device_guard(dev):
                    for r, q in enumerate(others):
                        recv[j][q].copy_(h_out[r, :, j], non_blocking=True)
        return [r.reshape((P * L,) + cell) for r in recv]
