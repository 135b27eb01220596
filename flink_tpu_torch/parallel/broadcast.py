"""Broadcast join on one shard — the port of flink_tpu/parallel/broadcast.py
(kernel K21) for one device.

The reference replicates a small sorted build side to every shard of its
mesh and lets each shard probe its slice of the record stream
(``build_broadcast_join_step``, a shard_map over ``searchsorted``). The port
runs on one card, so the whole stream is one shard's slice: the build side
is sorted on the host with ``np.argsort(kind="stable")`` as there, and the
probe is one launch of G24 (``ops/cuda.py sorted_probe``). The step over a
mesh raises: the sharded broadcast is ROADMAP queue 1, item 12.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_tpu_torch.core.device import resolve_device
from flink_tpu_torch.ops import cuda as kernels


def build_broadcast_join_step(ctx=None):
    """The reference's broadcast join over a device mesh: not ported."""
    raise NotImplementedError(
        "build_broadcast_join_step over a device mesh is not ported to "
        "flink_tpu_torch yet (ROADMAP queue 1, item 12); broadcast_join "
        "probes on one device")


def broadcast_join(keys, tkeys, tvals, device=None):
    """One-shot broadcast join of host arrays on one device.

    keys: record stream keys ([B] int64); tkeys / tvals: build side
    (unsorted ok, [K]; the keys unique, as the reference's contract has
    them). Returns (joined [B] float32, matched [B] bool) as numpy arrays:
    joined[i] = tvals[j] for the build key j equal to keys[i], 0 where
    none is."""
    dev = resolve_device(device)
    keys = np.asarray(keys)
    order = np.argsort(tkeys, kind="stable")
    tkeys_s = np.asarray(tkeys)[order]
    tvals_s = np.asarray(tvals, np.float32)[order]
    _pos, hit, joined = kernels.sorted_probe(
        torch.as_tensor(keys.astype(np.int64, copy=False), device=dev),
        torch.as_tensor(tkeys_s.astype(np.int64, copy=False), device=dev),
        torch.as_tensor(tvals_s, device=dev))
    return joined.cpu().numpy(), hit.cpu().numpy()
