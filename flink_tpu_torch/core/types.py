"""Typed record batches — the unit of data flow.

The reference moves one serialized record at a time through Netty buffers
(SpanningRecordSerializer; StreamRecord wrappers, SURVEY §2.3/§3.2). The
TPU-native unit is instead a fixed-width **struct-of-arrays micro-batch**: a
dict of equally-sized columns plus a validity mask and optional timestamps.
Fixed shapes keep XLA compilation stable; invalid lanes are padding.

RecordBatch is a plain dataclass of arrays or tensors (the reference
package registers it as a JAX pytree; PyTorch needs no registration).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.ops.hashing import hash64_host, key_identity64  # noqa: F401


@dataclass(frozen=True)
class Field:
    name: str
    dtype: Any  # numpy dtype-like
    shape: Tuple[int, ...] = ()  # per-record trailing shape


@dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    @staticmethod
    def of(**kwargs) -> "Schema":
        return Schema(tuple(Field(k, v) for k, v in kwargs.items()))

    def names(self):
        return [f.name for f in self.fields]


@dataclass
class RecordBatch:
    """Fixed-size columnar micro-batch.

    columns:    name -> array [B, ...]
    valid:      bool [B] — lanes carrying real records
    timestamps: int32 [B] event-time ticks (or None)
    key_hi/key_lo: uint32 [B] — 64-bit key identity, set after `keyBy`
    """

    columns: Dict[str, Any]
    valid: Any
    timestamps: Optional[Any] = None
    key_hi: Optional[Any] = None
    key_lo: Optional[Any] = None

    @property
    def size(self) -> int:
        return int(self.valid.shape[0])

    def with_columns(self, **cols) -> "RecordBatch":
        new = dict(self.columns)
        new.update(cols)
        return RecordBatch(new, self.valid, self.timestamps, self.key_hi, self.key_lo)

    def col(self, name: str):
        return self.columns[name]


def make_batch(
    columns: Dict[str, np.ndarray],
    batch_size: int,
    timestamps: Optional[np.ndarray] = None,
) -> RecordBatch:
    """Pad host columns up to batch_size and build the validity mask."""
    n = len(next(iter(columns.values())))
    if n > batch_size:
        raise ValueError(f"{n} records exceed batch size {batch_size}")
    out = {}
    for name, arr in columns.items():
        arr = np.asarray(arr)
        pad = np.zeros((batch_size - n,) + arr.shape[1:], dtype=arr.dtype)
        out[name] = np.concatenate([arr, pad], axis=0)
    valid = np.zeros(batch_size, dtype=bool)
    valid[:n] = True
    ts = None
    if timestamps is not None:
        ts = np.zeros(batch_size, dtype=np.int32)
        ts[:n] = np.asarray(timestamps, dtype=np.int32)
    return RecordBatch(out, valid, ts)


class KeyCodec:
    """Maps arbitrary host keys <-> 64-bit device key identities.

    Numeric keys map to their raw 64-bit bits (collision-free identity;
    device-side probe/route hashes do the mixing — see
    hashing.key_identity64); other keys via a cached per-object stable
    hash. Keeps the reverse map so fired windows can be reported with
    original keys (the device only ever sees the 64-bit id).
    """

    def __init__(self):
        self._rev: dict[int, Any] = {}
        # encode may run on the ingest prefetch thread while a checkpoint
        # lists newly-seen keys on the step-loop thread (runtime/ingest):
        # the lock makes the per-batch insert burst and the keymap-log
        # slice atomic against each other (one acquisition per BATCH, not
        # per key — negligible against the encode itself)
        self._lock = threading.Lock()

    def encode(self, keys, keep_reverse: bool = True):
        """keys: numeric array (vectorized) or sequence of objects."""
        h = key_identity64(keys)
        if keep_reverse:
            klist = keys.tolist() if isinstance(keys, np.ndarray) else keys
            with self._lock:
                for k, hv in zip(klist, h.tolist()):
                    self._rev.setdefault(hv, k)
        hi = (h >> np.uint64(32)).astype(np.uint32)
        lo = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return hi, lo

    def rev_slice(self, start: int):
        """Atomic snapshot of the reverse map's append-only tail:
        ``(items[start:], len_at_snapshot)``. The checkpoint keymap log
        appends `items` and records the returned count — under the same
        lock encode inserts hold, so a concurrent prefetch-thread encode
        can never tear the iteration (dicts preserve insertion order, so
        the slice IS the keys seen since the last checkpoint)."""
        import itertools

        with self._lock:
            return (
                list(itertools.islice(self._rev.items(), start, None)),
                len(self._rev),
            )

    # kept as an alias for the columnar fast path's call sites
    encode_numeric = encode

    def restore(self, rev: dict) -> None:
        """Replace the reverse map with a checkpoint's keymap log (key id
        -> original key, in the order the keys were first seen)."""
        with self._lock:
            self._rev = dict(rev)

    def size(self) -> int:
        """Keys in the reverse map."""
        return len(self._rev)

    def decode(self, hi: np.ndarray, lo: np.ndarray):
        h = (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
            lo, dtype=np.uint64
        )
        # under the lock encode inserts hold: the producer thread encodes
        # the next batches while the step loop decodes fired rows
        with self._lock:
            rev = self._rev
            return [rev.get(int(v), int(v)) for v in h.tolist()]
