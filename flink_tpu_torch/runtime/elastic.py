"""Device-loss classification — the part of flink_tpu/runtime/elastic.py
that the cross-process plane needs: ``DeviceLostError``, which
``runtime/dcn.py``'s ``DCNPeerLostError`` subclasses (a dead peer's mesh
segment is gone with it, so its loss classifies as device loss at the
restart boundary). Survivor planning and the degraded-state ledger are
ROADMAP queue 1, item 13.
"""

from __future__ import annotations

from typing import Sequence


class DeviceLostError(RuntimeError):
    """A mesh shard's device is gone (chip failure, host segment loss).

    ``lost_shards``: indices into the CURRENT mesh's shard axis;
    ``lost_devices``: device objects, for callers that identify the
    casualty directly. Either may be empty — a loss without an
    attributable shard still classifies as device loss, and recovery
    falls back to a full restore at the current parallelism.
    """

    def __init__(self, message: str, lost_shards: Sequence[int] = (),
                 lost_devices: Sequence = ()):
        super().__init__(message)
        self.lost_shards = tuple(int(s) for s in lost_shards)
        self.lost_devices = tuple(lost_devices)
