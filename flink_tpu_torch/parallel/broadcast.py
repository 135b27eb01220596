"""Broadcast join over the shard mesh — the port of
flink_tpu/parallel/broadcast.py (kernel K21).

The reference replicates a small sorted build side to every shard of its
mesh and lets each shard probe its slice of the record stream
(``build_broadcast_join_step``, a shard_map over ``searchsorted``). The
port keeps the build side once on each distinct device of its mesh
(``parallel/mesh.py``), and each shard probes its ``B / n`` slice of the
lanes with one launch of G24 (``ops/cuda.py sorted_probe``) under its
device's guard; the slices' results are put back in lane order on the
first shard's device. Without a mesh the whole stream is one shard's
slice: ``broadcast_join`` sorts the build side on the host with
``np.argsort(kind="stable")`` as the reference does and probes once.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_tpu_torch.core.device import resolve_device
from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.parallel.mesh import MeshContext, device_guard

_STEP_CACHE: dict = {}


def build_broadcast_join_step(ctx: MeshContext):
    """The broadcast-join step over ``ctx``'s shards, memoised per mesh.

    ``step(keys, valid, tkeys, tvals)``: keys int64 [B] and valid bool [B]
    record lanes (B a multiple of the shard count; shard s probes lanes
    ``[s * B / n, (s + 1) * B / n)``), tkeys int64 [K] sorted unique build
    keys and tvals float32 [K] their payload, copied once to each distinct
    device of the mesh. Returns (joined float32 [B], matched bool [B]) in
    lane order on the first shard's device: joined[i] = tvals[j] for the
    build key j equal to keys[i] where lane i is valid, 0 otherwise."""
    key = (tuple(ctx.devices), ctx.n_shards)
    cached = _STEP_CACHE.get(key)
    if cached is not None:
        return cached
    devices = [torch.device(d) for d in ctx.devices]
    n = len(devices)

    def step(keys, valid, tkeys, tvals):
        keys = torch.as_tensor(keys, dtype=torch.int64)
        valid = torch.as_tensor(valid, dtype=torch.bool)
        B = keys.shape[0]
        if B % n:
            raise ValueError(f"{B} lanes do not split over {n} shards")
        b = B // n
        build = {}
        for dev in devices:
            if dev not in build:
                build[dev] = (torch.as_tensor(tkeys, dtype=torch.int64,
                                              device=dev),
                              torch.as_tensor(tvals, dtype=torch.float32,
                                              device=dev))
        joined, hit = [], []
        for s, dev in enumerate(devices):
            with device_guard(dev):
                k = keys[s * b:(s + 1) * b].to(dev, non_blocking=True)
                ok = valid[s * b:(s + 1) * b].to(dev, non_blocking=True)
                _pos, h, j = kernels.sorted_probe(k, *build[dev])
                h = h & ok
                joined.append(torch.where(h, j, torch.zeros_like(j)))
                hit.append(h)
        dev0 = devices[0]
        return (torch.cat([j.to(dev0, non_blocking=True) for j in joined]),
                torch.cat([h.to(dev0, non_blocking=True) for h in hit]))

    _STEP_CACHE[key] = step
    return step


def broadcast_join(keys, tkeys, tvals, ctx: MeshContext = None, device=None):
    """One-shot broadcast join of host arrays.

    keys: record stream keys ([B] int64); tkeys / tvals: build side
    (unsorted ok, [K]; the keys unique, as the reference's contract has
    them). Returns (joined [B] float32, matched [B] bool) as numpy arrays:
    joined[i] = tvals[j] for the build key j equal to keys[i], 0 where
    none is. With ``ctx`` the probe runs over its shards
    (``build_broadcast_join_step``, B padded up to a multiple of the shard
    count with invalid lanes); without, on one shard of ``device``."""
    keys = np.asarray(keys)
    order = np.argsort(tkeys, kind="stable")
    tkeys_s = np.asarray(tkeys)[order].astype(np.int64, copy=False)
    tvals_s = np.asarray(tvals, np.float32)[order]
    if ctx is not None:
        n = ctx.n_shards
        B = len(keys)
        pad = -B % n
        kp = np.concatenate([keys.astype(np.int64, copy=False),
                             np.zeros(pad, np.int64)])
        valid = np.concatenate([np.ones(B, bool), np.zeros(pad, bool)])
        joined, hit = build_broadcast_join_step(ctx)(kp, valid, tkeys_s,
                                                     tvals_s)
        return joined.cpu().numpy()[:B], hit.cpu().numpy()[:B]
    dev = resolve_device(device)
    _pos, hit, joined = kernels.sorted_probe(
        torch.as_tensor(keys.astype(np.int64, copy=False), device=dev),
        torch.as_tensor(tkeys_s, device=dev),
        torch.as_tensor(tvals_s, device=dev))
    return joined.cpu().numpy(), hit.cpu().numpy()
