"""Staging of host micro-batches onto the device — the ring half of
flink_tpu/runtime/ingest.py.

``DeviceBatchRing`` holds ``depth`` slots. On a CUDA device each slot is a
set of pinned host buffers plus the device tensors of one padded batch
(hi, lo, ticks, values, valid) and the slot's watermark. The values column
has the stage's value dtype and shape: float32 ``[B]`` for a scalar
reduce, ``[B, *value_shape]`` for a vector one (``mean``'s [sum, count]
pairs are ``[B, 2]``), int32 ``[B]`` for a sketch, whose values are
uint32 item hashes carried as int32 bits (a float32 would round every hash
above 2^24). Staging fills the
pinned buffers and copies them with ``non_blocking`` copies on a side
stream, recording an event after each copy. The drain's stream waits on
those events (a device-side wait: the host never blocks on a copy), and
records a "consumed" event that the next copy into the same slot waits on,
so a slot is never overwritten while a drain still reads it.

On the CPU (the tests) the slots are plain tensors filled in place.

The reference's prefetch thread (``IngestPipeline``), which polls and
encodes the next batches while the step loop dispatches, is not ported
yet: the executor polls inline (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


class DeviceBatchRing:
    def __init__(self, depth: int, batch: int, device,
                 value_dtype=torch.float32, value_shape=()):
        self.depth = max(1, int(depth))
        self.batch = int(batch)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        B, D = self.batch, self.depth
        pin = self.cuda

        def host(dtype, tail=()):
            return torch.zeros((D, B) + tuple(tail), dtype=dtype,
                               pin_memory=pin)

        # [D, B] host staging (pinned on CUDA) and [D, B] device slots
        self._host = {
            "hi": host(torch.int32), "lo": host(torch.int32),
            "ts": host(torch.int32),
            "values": host(value_dtype, value_shape),
            "valid": host(torch.bool),
        }
        self._host_wm = torch.zeros(D, dtype=torch.int32, pin_memory=pin)
        # numpy views of the host buffers, which staging fills
        self._np = {k: v.numpy() for k, v in self._host.items()}
        if self.cuda:
            self._dev = {k: torch.zeros_like(v, device=self.device)
                         for k, v in self._host.items()}
            self.wmv = torch.zeros(D, dtype=torch.int32, device=self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
            self._copied = [torch.cuda.Event() for _ in range(D)]
            self._consumed = [torch.cuda.Event() for _ in range(D)]
            self._pending = [False] * D
        else:
            self._dev = self._host
            self.wmv = self._host_wm

    def stage(self, i: int, hi: np.ndarray, lo: np.ndarray, ticks: np.ndarray,
              values: np.ndarray, wm_ticks: int) -> None:
        """Fill slot ``i`` with one batch of ``n <= batch`` lanes (hi / lo,
        and an int32 values column, as uint32 or int32 bits) and its
        watermark, and start its copy."""
        n = len(ticks)
        if n > self.batch:
            raise ValueError(f"{n} records exceed the ring's batch "
                             f"{self.batch}")
        if self.cuda and self._pending[i]:
            # the pinned buffers of slot i may still feed its last copy
            self._copied[i].synchronize()
        h = self._np
        h["hi"][i, :n] = np.asarray(hi).view(np.int32)
        h["lo"][i, :n] = np.asarray(lo).view(np.int32)
        h["ts"][i, :n] = ticks
        if h["values"].dtype == np.int32:
            values = np.asarray(values).view(np.int32)
        h["values"][i, :n] = values
        h["valid"][i, :n] = True
        h["valid"][i, n:] = False
        self._host_wm[i] = int(wm_ticks)
        if not self.cuda:
            return
        with torch.cuda.stream(self._copy_stream):
            # never overwrite a slot a queued drain still reads
            self._copy_stream.wait_event(self._consumed[i])
            for k, dev in self._dev.items():
                dev[i].copy_(self._host[k][i], non_blocking=True)
            self.wmv[i:i + 1].copy_(self._host_wm[i:i + 1], non_blocking=True)
            self._copied[i].record(self._copy_stream)
        self._pending[i] = True

    def slots(self, count: int) -> List[Tuple[torch.Tensor, ...]]:
        """The first ``count`` staged slots as device tensors; the current
        stream waits for their copies."""
        if self.cuda:
            cur = torch.cuda.current_stream(self.device)
            for i in range(count):
                cur.wait_event(self._copied[i])
        d = self._dev
        return [(d["hi"][i], d["lo"][i], d["ts"][i], d["values"][i],
                 d["valid"][i]) for i in range(count)]

    def release(self, count: int) -> None:
        """Mark the first ``count`` slots consumed by the work just queued
        on the current stream."""
        if self.cuda:
            cur = torch.cuda.current_stream(self.device)
            for i in range(count):
                self._consumed[i].record(cur)
