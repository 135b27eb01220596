"""The hash state layout's open-addressing key table, in PyTorch — the
counterpart of flink_tpu/ops/hashtable.py.

Each key-group shard owns a fixed-capacity table on the device. The
reference keeps it as uint32 ``[C, 2]`` (hi, lo) rows with the all-ones row
as EMPTY; the port keeps one int64 word ``(hi << 32) | lo`` per slot with
the all-ones word as EMPTY, so that one 64-bit atomicCAS claims a slot
(kernel G5, ``ops/cuda.py``). ``to_rows`` / ``from_rows`` convert to and
from the reference's rows at state carry-over only.

A key's probe chain is the P slots ``(probe_hash(hi, lo) + j) & (C - 1)``,
j < P, wrapping at C; the key sits in the first slot of its chain that was
free when it arrived. ``lookup`` / ``lookup_counted`` find keys (G8 on the
card); ``upsert_counted`` inserts or finds them (G5). The key word equal to
EMPTY — integer key -1 — is never found nor placed: the window update
takes its lanes to the overflow ring, or counts them as capacity loss
without one, as the reference does. The paths free slots only by
rebuilding the whole table (``window_kernels.compact_table``, G9).
``remove_slots`` is the reference's point removal (G28), which neither
package calls on a path. A key is absent only when its whole chain lacks
it, as in the reference, so a key behind a slot that ``remove_slots``
cleared is still found, and ``upsert_counted`` does not place it twice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from flink_tpu_torch.ops import cuda as kernels
from flink_tpu_torch.ops.cuda import EMPTY_WORD

EMPTY = np.uint32(0xFFFFFFFF)   # the reference's EMPTY row half
# the chains of the session, count-window and rolling stages: the
# reference's fixed 16 (runtime/step.py:2454, 2515, 2576), whatever
# state.probe-len says
KEYED_PROBE_LEN = 16


def create(capacity: int, device="cuda") -> torch.Tensor:
    """An empty table of ``capacity`` slots (a power of two)."""
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    return torch.full((capacity,), EMPTY_WORD, dtype=torch.int64,
                      device=torch.device(device))


def lookup(table: torch.Tensor, hi, lo, *,
           probe_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find the slots of a batch of keys (hi/lo int32 [B], uint32 bits).
    Returns (slot int32 [B], found bool [B]); unfound lanes get slot C."""
    valid = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    slot, found, _ = lookup_counted(table, hi, lo, valid, probe_len=probe_len)
    return slot, found


def lookup_counted(table: torch.Tensor, hi, lo, valid, *, probe_len: int):
    """Find the keys of the valid lanes without inserting any (G8).
    Returns (slot int32 [B], C where not found; found bool [B]; n_missing
    int32 0-d on the device: valid lanes whose key is absent)."""
    return kernels.hash_lookup(table, hi, lo, valid, probe_len=probe_len)


def upsert_counted(table: torch.Tensor, hi, lo, valid, *, probe_len: int):
    """Insert-or-find a batch of keys, the table updated in place (G5).
    Returns (slot int32 [B], C where not ok; ok bool [B]; n_new int32 0-d
    on the device: valid lanes whose key was absent before and present
    after). A lane is not ok when every slot of its chain holds another
    key."""
    return kernels.hash_upsert(table, hi, lo, valid, probe_len=probe_len)


def upsert(table: torch.Tensor, hi, lo,
           valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert-or-find as the session, count-window and rolling stages call
    the reference's ``upsert(..., max_rounds=8)``, on chains of
    ``KEYED_PROBE_LEN``: (slot int32 [B], C where not ok; ok bool [B]),
    the table updated in place (G5). G5's CAS walk places every key whose
    chain has room, where the reference's eight claim rounds can leave out
    a key that lost eight races (ROADMAP queue 3)."""
    slot, ok, _ = upsert_counted(table, hi, lo, valid,
                                 probe_len=KEYED_PROBE_LEN)
    return slot, ok


def remove_slots(table: torch.Tensor, slots, mask) -> torch.Tensor:
    """Mark the slots of the masked lanes empty, the table updated in place
    and returned (G28): the reference's ``remove_slots``. slots int32 or
    int64 [B]; a slot in [-C, 0) counts from the end, as the reference's
    indexing wraps it, and other slots outside [0, C) are dropped."""
    return kernels.remove_slots(table, slots, mask)


def to_rows(table: torch.Tensor) -> np.ndarray:
    """Key words -> the reference's uint32 [C, 2] (hi, lo) rows."""
    w = table.detach().cpu().numpy().view(np.uint64)
    return np.stack([(w >> np.uint64(32)).astype(np.uint32),
                     (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)], axis=1)


def from_rows(rows: np.ndarray, device="cuda") -> torch.Tensor:
    """The reference's uint32 [C, 2] (hi, lo) rows -> int64 key words."""
    r = np.asarray(rows).astype(np.uint64)
    if r.ndim != 2 or r.shape[1] != 2:
        raise ValueError(f"table rows must be [C, 2], got {r.shape}")
    w = (r[:, 0] << np.uint64(32)) | r[:, 1]
    return torch.from_numpy(w.view(np.int64)).to(torch.device(device))


def keyed_state_from_numpy(cls, fields: Dict[str, np.ndarray],
                           dtypes: Dict[str, torch.dtype], device):
    """A session, count-window or rolling state ``cls`` from host arrays
    named as the reference's leaves: ``table.keys`` as (hi, lo) rows and
    the fields of ``dtypes`` (uint32 leaves keep their bits in int32)."""
    dev = torch.device(device)
    out = {"table_keys": from_rows(fields["table.keys"], device=dev)}
    for name, dtype in dtypes.items():
        a = np.array(fields[name])           # a writable C-order copy
        if dtype == torch.int32 and a.dtype == np.uint32:
            a = a.view(np.int32)
        out[name] = torch.from_numpy(a).to(device=dev, dtype=dtype)
    return cls(**out)


def keyed_state_to_numpy(state, names) -> Dict[str, np.ndarray]:
    """The inverse of ``keyed_state_from_numpy`` for the fields ``names``."""
    out = {"table.keys": to_rows(state.table_keys)}
    for name in names:
        out[name] = getattr(state, name).cpu().numpy()
    return out
