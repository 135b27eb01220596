"""Collectives over the shard mesh — the counterparts of ``lax.all_to_all``
and ``lax.psum`` over the reference's ``shards`` axis.

The port runs its shards in one process (``parallel/mesh.py``), so a
collective is device copies: between shards on one device a copy within
it, between cards a peer-to-peer copy. Each shard's part runs under its
device's guard, on that device's current stream. The path for shards on
several cards is written but has run on none: the machines the port is
tested on hold one card (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

from typing import List, Sequence

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

