"""Checkpoints of a window stage: consistent snapshots, restore, restarts —
the sync-full half of flink_tpu/runtime/checkpoint.py for one device.

In the micro-batch design the barrier is structural: BETWEEN two drains,
with every fire of the last drain read, the device state plus the source
offsets form a consistent cut, so a checkpoint is

    device state  --D2H-->  host  -->  logical entry format  -->  files

**Logical snapshot format** (the reference's, unchanged): state is stored
as (key, pane, value, fresh) entries plus scalars, independent of the
physical slot layout and plane layout, in ``<dir>/chk-<id>/{meta.json,
entries.npz, aux.pkl}``. A checkpoint written by ``flink_tpu`` restores
here and one written here restores there: ``entries.npz`` holds the same
arrays, ``meta.json`` the same scalars and format version, and
``aux.pkl`` pickles only builtins (``read`` maps any ``flink_tpu`` class
a reference pickle names to the port's module of the same path).

Exactly-once applies to STATE: sources snapshot offsets at the same cut,
so replay after restore reproduces identical micro-batches and state
converges to the no-failure result. Sinks see at-least-once on recovery
(fires between the checkpoint and the failure are re-emitted with the
same values).

The host halves (``extract_entries``, ``CheckpointStorage``,
``RestartStrategy``) are copies of the reference's JAX-free code; the
device halves read the state with ``state_to_numpy``'s fields and rebuild
it with ``state_from_numpy``, placing a hash layout's keys with G5
``hash_upsert`` as the reference places them with ``hashtable.upsert``.
Incremental and asynchronous checkpoints and the task-local snapshot
cache (``checkpoint.mode: incremental``, ``checkpoint.async``,
``checkpoint.local.enabled``) are not ported (ROADMAP queue 1, item 13).
"""

from __future__ import annotations

import json
import os
import pickle
import random
import shutil
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from flink_tpu_torch.core.config import CoreOptions as CO
from flink_tpu_torch.core.keygroups import assign_to_key_group
from flink_tpu_torch.ops import hashtable
from flink_tpu_torch.ops.hashing import route_hash
from flink_tpu_torch.ops import window_kernels as wk
from flink_tpu_torch.ops.cuda import PANE_NONE
from flink_tpu_torch.testing import faults

# the reference's format version (numeric key identities are raw 64-bit
# key bits, hashing.key_identity64)
FORMAT_VERSION = 2
SCALARS = ("watermark", "fired_through", "max_pane", "min_pane",
           "dropped_late", "dropped_capacity")


def stage_window_state(state: wk.WindowShardState,
                       red: wk.ReduceSpec) -> dict:
    """The SYNC phase of a snapshot: the shard's state read to host numpy
    copies, in the reference's staging form (one shard, ``rows == [0]``).
    A packed plane unpacks into the split (acc, touched) form here, so the
    logical format does not depend on the live plane layout."""
    keys = hashtable.to_rows(state.table_keys)
    acc = state.acc.detach().cpu().numpy()
    if state.packed >= 0:
        acc, touched = wk.split_packed(acc, red)
        acc = np.ascontiguousarray(acc)
        touched = np.asarray(touched)
    else:
        touched = state.touched.cpu().numpy()
    small = torch.stack([getattr(state, n) for n in SCALARS]).cpu().numpy()
    shard = {"keys": keys, "acc": acc, "touched": touched,
             "pane_ids": state.pane_ids.cpu().numpy(),
             "fresh": state.fresh.cpu().numpy()}
    return {"n_shards": 1, "rows": [0], "shards": {0: shard},
            "scalars": {n: int(v) for n, v in zip(SCALARS, small)},
            "value_tail": tuple(acc.shape[1:]),
            "value_dtype": np.dtype(acc.dtype)}


def stage_sharded_state(states, red: wk.ReduceSpec) -> dict:
    """The shards' states staged as the reference stages its [n_shards]
    state (its ``{"n_shards": S, "rows", "shards"}`` form): shard s's
    host copies under ``shards[s]``, the scalars combined across shards
    (watermark, fired_through and min_pane their minimum, max_pane the
    maximum, the drop counters summed)."""
    parts = [stage_window_state(st, red) for st in states]
    shards = {s: p["shards"][0] for s, p in enumerate(parts)}
    sc = [p["scalars"] for p in parts]
    scalars = {
        "watermark": min(x["watermark"] for x in sc),
        "fired_through": min(x["fired_through"] for x in sc),
        "max_pane": max(x["max_pane"] for x in sc),
        "min_pane": min(x["min_pane"] for x in sc),
        "dropped_late": sum(x["dropped_late"] for x in sc),
        "dropped_capacity": sum(x["dropped_capacity"] for x in sc),
    }
    return {"n_shards": len(states), "rows": list(range(len(states))),
            "shards": shards, "scalars": scalars,
            "value_tail": parts[0]["value_tail"],
            "value_dtype": parts[0]["value_dtype"]}


def restore_sharded_state(entries, scalars, ctx, spec,
                          leftover=None) -> list:
    """Logical entries -> one device state a shard of ``ctx`` (the
    reference's ``restore_window_state`` onto a possibly different mesh):
    every entry re-bucketed by its key group through
    ``ctx.shard_of_key_groups``, each shard rebuilt from its own entries
    on its device. The drop counters restore on shard 0 (their sum is what
    a job reports). ``leftover`` as for ``restore_window_rows``."""
    khi = np.asarray(entries["key_hi"], np.uint32)
    klo = np.asarray(entries["key_lo"], np.uint32)
    kg = assign_to_key_group(route_hash(khi, klo, np), ctx.max_parallelism,
                             np)
    shard = ctx.shard_of_key_groups(kg)
    zero = dict(scalars, dropped_late=0, dropped_capacity=0)
    out = []
    for i, (s, dev) in enumerate(zip(ctx.local_shards, ctx.devices)):
        sel = shard == s
        part = {k: np.asarray(v)[sel] for k, v in entries.items()}
        out.append(restore_window_state(
            part, scalars if i == 0 else zero, spec, ctx.max_parallelism,
            dev, leftover=leftover))
    return out


def extract_entries(staged: dict, win: wk.WindowSpec):
    """Staging buffer -> logical (key, pane, value) entries (the reference's
    host numpy). Returns (entries, scalars)."""
    R = win.ring
    khi_l, klo_l, pane_l, val_l, fresh_l = [], [], [], [], []
    for s in staged["rows"]:
        sh = staged["shards"][s]
        keys = sh["keys"]                       # [C, 2]
        acc = sh["acc"]                         # [C*R, ...]
        C = keys.shape[0]
        t2 = sh["touched"].reshape(R, C)   # ring-major device layout
        rings, slots = np.nonzero(t2)
        if slots.size == 0:
            continue
        khi_l.append(keys[slots, 0])
        klo_l.append(keys[slots, 1])
        pane_l.append(sh["pane_ids"][rings])
        val_l.append(acc.reshape((R, C) + acc.shape[1:])[rings, slots])
        fresh_l.append(sh["fresh"].reshape(R, C)[rings, slots])
    if khi_l:
        entries = {
            "key_hi": np.concatenate(khi_l),
            "key_lo": np.concatenate(klo_l),
            "pane": np.concatenate(pane_l).astype(np.int32),
            "value": np.concatenate(val_l),
            "fresh": np.concatenate(fresh_l),
        }
    else:
        entries = {
            "key_hi": np.zeros(0, np.uint32),
            "key_lo": np.zeros(0, np.uint32),
            "pane": np.zeros(0, np.int32),
            "value": np.zeros(
                (0,) + tuple(staged["value_tail"]), staged["value_dtype"]
            ),
            "fresh": np.zeros(0, bool),
        }
    return entries, dict(staged["scalars"])


def snapshot_window_state(state: wk.WindowShardState, win: wk.WindowSpec,
                          red: wk.ReduceSpec):
    """Device -> logical entries: ``stage_window_state`` then
    ``extract_entries``. Returns (entries, scalars)."""
    return extract_entries(stage_window_state(state, red), win)


def _np_dtype(red: wk.ReduceSpec):
    return np.int32 if red.dtype == torch.int32 else np.float32


def restore_window_rows(entries, scalars, spec, max_parallelism: int,
                        device, leftover=None) -> dict:
    """Logical entries -> the shard's host arrays ``{"keys" (uint32 [C,
    2] rows), "acc", "touched", "fresh", "pane_ids", "n_fresh"}`` (the
    reference's ``restore_window_rows`` for one shard, which owns every
    key group). Entries that fell off the ring's horizon drop; in the hash
    layout the distinct keys are placed in a fresh table by G5 on
    ``device``, so a key's slot may differ from the one it had when the
    snapshot was taken. Entries whose key finds no slot (past capacity in
    the direct layout, a full chain in the hash layout) are appended to
    ``leftover`` as (key_hi, key_lo, pane, value) arrays for the caller's
    spill tier; without a list they raise."""
    R = spec.win.ring
    C = spec.capacity_per_shard
    red = spec.red
    khi = np.asarray(entries["key_hi"], np.uint32)
    klo = np.asarray(entries["key_lo"], np.uint32)
    pane = np.asarray(entries["pane"], np.int32)
    value = np.asarray(entries["value"])
    e_fresh = np.asarray(entries.get("fresh", np.zeros(len(pane), bool)),
                         bool)
    max_pane = int(scalars["max_pane"])
    have = max_pane != int(PANE_NONE)
    # drop entries that fell off the (possibly smaller) ring horizon
    if have and len(pane):
        keep = pane > max_pane - R
        khi, klo, pane, value, e_fresh = (
            khi[keep], klo[keep], pane[keep], value[keep], e_fresh[keep])
    # one shard owns every key group: the reference's per-shard selection
    # by key-group range keeps every entry

    def _spill(lost):
        if leftover is None:
            raise RuntimeError(
                "restore: state does not fit the configured capacity")
        leftover.append((khi[lost], klo[lost], pane[lost], value[lost]))

    if spec.layout == "direct":
        fit = (khi == 0) & (klo < C)
        if not bool(fit.all()):
            _spill(~fit)
            klo, pane, value, e_fresh = (klo[fit], pane[fit], value[fit],
                                         e_fresh[fit])
        entry_slots = klo.astype(np.int64)
        iota = np.arange(C, dtype=np.uint32)
        table_keys = np.stack([np.zeros_like(iota), iota], axis=1)
    elif len(khi):
        # unique keys (entries repeat per pane), placed by G5
        u_keys, inv = np.unique(
            (khi.astype(np.uint64) << np.uint64(32)) | klo,
            return_inverse=True)
        u_hi = (u_keys >> np.uint64(32)).astype(np.uint32)
        u_lo = (u_keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        table = hashtable.create(C, device=device)

        def dev(a):
            return torch.from_numpy(a.view(np.int32)).to(table.device)

        slot, ok, _n = hashtable.upsert_counted(
            table, dev(u_hi), dev(u_lo),
            torch.ones(len(u_hi), dtype=torch.bool, device=table.device),
            probe_len=spec.probe_len)
        ok = ok.cpu().numpy()
        slot = slot.cpu().numpy()
        if not bool(ok.all()):
            _spill(~ok[inv])             # per-entry mask of unfitted keys
            keep_e = ok[inv]
            pane, value, e_fresh = pane[keep_e], value[keep_e], \
                e_fresh[keep_e]
            inv = inv[keep_e]
        entry_slots = slot[inv].astype(np.int64)
        table_keys = hashtable.to_rows(table)
    else:
        entry_slots = np.zeros(0, np.int64)
        table_keys = hashtable.to_rows(hashtable.create(C, device="cpu"))
    # shared half: scatter the entries into the ring-major pane arrays
    acc_s = np.empty((C * R,) + tuple(red.value_shape), _np_dtype(red))
    acc_s[...] = red.neutral_value()
    touched_s = np.zeros(C * R, bool)
    fresh_s = np.zeros(C * R, bool)
    if len(entry_slots):
        flat = (pane.astype(np.int64) % R) * C + entry_slots
        acc_s[flat] = value
        touched_s[flat] = True
        fresh_s[flat] = e_fresh
    if have:
        r_idx = np.arange(R)
        pane_ids = (max_pane - ((max_pane - r_idx) % R)).astype(np.int32)
    else:
        pane_ids = np.full(R, int(PANE_NONE), np.int32)
    return {"keys": table_keys, "acc": acc_s, "touched": touched_s,
            "fresh": fresh_s, "pane_ids": pane_ids,
            "n_fresh": np.int32(fresh_s.sum())}


def restore_window_state(entries, scalars, spec, max_parallelism: int,
                         device, leftover=None) -> wk.WindowShardState:
    """Logical entries -> a device state in the stage's layout and plane
    (``restore_window_rows``, then ``state_from_numpy``). The pane ring is
    re-registered from the snapshot's max_pane; the overflow ring restores
    empty (a checkpoint is taken where the ring was drained into the spill
    tier, whose contents ride the snapshot as entries) and the changelog
    bits clean. ``leftover`` as for ``restore_window_rows``."""
    built = restore_window_rows(entries, scalars, spec, max_parallelism,
                                device, leftover=leftover)
    win, red = spec.win, spec.red
    O = win.overflow
    ft = int(scalars["fired_through"])
    purged = (ft - (win.panes_per_window - 1) if ft != int(PANE_NONE)
              else int(PANE_NONE))
    i32 = np.int32
    fields = {
        "table.keys": built["keys"],
        "acc": built["acc"],
        "touched": built["touched"],
        "pane_ids": built["pane_ids"],
        "max_pane": i32(scalars["max_pane"]),
        "min_pane": i32(scalars["min_pane"]),
        "watermark": i32(scalars["watermark"]),
        "fired_through": i32(ft),
        "purged_through": i32(purged),
        "dropped_late": i32(scalars["dropped_late"]),
        "dropped_capacity": i32(scalars["dropped_capacity"]),
        "fresh": built["fresh"],
        "n_fresh": i32(built["n_fresh"]),
        "ovf_hi": np.zeros(O, np.uint32),
        "ovf_lo": np.zeros(O, np.uint32),
        "ovf_pane": np.full(O, int(PANE_NONE), i32),
        "ovf_val": np.zeros((O,) + tuple(red.value_shape), _np_dtype(red)),
        "ovf_n": i32(0),
        "kg_dirty": np.zeros(max_parallelism, bool),
    }
    return wk.state_from_numpy(fields, -1, device=device, layout=spec.layout,
                               probe_len=spec.probe_len, red=red)


class _PortUnpickler(pickle.Unpickler):
    """Reads an ``aux.pkl``: a class the reference pickled under
    ``flink_tpu.*`` resolves to the port's module of the same path, so
    reading a reference checkpoint never imports the reference."""

    def find_class(self, module, name):
        if module == "flink_tpu" or module.startswith("flink_tpu."):
            module = "flink_tpu_torch" + module[len("flink_tpu"):]
        return super().find_class(module, name)


class CheckpointStorage:
    """Directory layout: ``<dir>/chk-<id>/{meta.json, entries.npz,
    aux.pkl}`` (the reference's, sync-full): each checkpoint is written
    into ``chk-<id>.tmp`` and renamed into place, the ``retain`` newest are
    kept, and the codec's reverse key map is appended to one shared
    ``keymap.log``. A directory holding an incremental (delta) checkpoint
    of the reference cannot be read here (item 13); the reference's
    ``.storage-id`` token serves its task-local cache, not ported."""

    def __init__(self, directory: str, retain: int = 2):
        self.dir = str(directory)
        self.retain = retain
        os.makedirs(self.dir, exist_ok=True)

    def path(self, cid: int) -> str:
        return os.path.join(self.dir, f"chk-{cid}")

    def write(self, cid: int, entries, scalars, source_offsets=None,
              aux: dict = None) -> str:
        faults.inject("ckpt.entries.write", cid=cid)
        tmp = self.path(cid) + ".tmp"
        # a stale staging dir of an aborted attempt must not leak files in
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "entries.npz"), **entries)
        with open(os.path.join(tmp, "aux.pkl"), "wb") as f:
            pickle.dump({"source_offsets": source_offsets, "aux": aux}, f)
        meta = {"format_version": FORMAT_VERSION, "checkpoint_id": cid,
                "timestamp": time.time(), **scalars}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        faults.inject("ckpt.publish", cid=cid)
        final = self.path(cid)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc(keep_latest=cid)
        return final

    def _gc(self, keep_latest: int) -> None:
        cids = self.list_checkpoints()
        retained = {keep_latest}
        if self.retain > 1:
            retained.update([c for c in cids if c != keep_latest]
                            [-(self.retain - 1):])
        for cid in cids:
            if cid not in retained:
                shutil.rmtree(self.path(cid), ignore_errors=True)
        # an aborted attempt's staging debris is an orphan by construction
        for name in os.listdir(self.dir):
            if name.startswith("chk-") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    def list_checkpoints(self):
        out = []
        if not os.path.isdir(self.dir):
            return out
        for name in os.listdir(self.dir):
            if name.startswith("chk-") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[4:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest(self) -> Optional[int]:
        cids = self.list_checkpoints()
        return cids[-1] if cids else None

    def read(self, cid: int):
        """The logical snapshot at checkpoint ``cid``: (entries, scalars,
        source_offsets, aux)."""
        p = self.path(cid)
        mf = os.path.join(p, "manifest.json")
        if os.path.exists(mf):
            with open(mf) as f:
                kind = json.load(f).get("kind")
            if kind == "delta":
                raise NotImplementedError(
                    f"checkpoint {cid} is an incremental delta; incremental "
                    f"checkpoints are not ported to flink_tpu_torch yet "
                    f"(ROADMAP queue 1, item 13)")
        faults.inject("ckpt.read.primary", cid=cid)
        try:
            with open(os.path.join(p, "meta.json")) as f:
                meta = json.load(f)
        except OSError as e:
            raise FileNotFoundError(f"checkpoint {cid} unreadable: {e}") \
                from e
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint format: {meta}")
        if meta.get("kind") == "generic":
            raise ValueError(f"checkpoint {cid} is a generic (non-window) "
                             f"snapshot")
        with np.load(os.path.join(p, "entries.npz")) as z:
            entries = {k: z[k] for k in z.files}
        with open(os.path.join(p, "aux.pkl"), "rb") as f:
            auxd = _PortUnpickler(f).load()
        scalars = {k: meta[k] for k in SCALARS}
        return entries, scalars, auxd["source_offsets"], auxd["aux"]

    # -- the codec's key map log: checkpoints record only a count; new
    # entries append to one shared log
    def _keymap_path(self) -> str:
        return os.path.join(self.dir, "keymap.log")

    def append_keymap(self, items) -> None:
        if not items:
            return
        with open(self._keymap_path(), "ab") as f:
            pickle.dump(items, f)

    def read_keymap(self, count: int) -> dict:
        out = {}
        path = self._keymap_path()
        if count and os.path.exists(path):
            with open(path, "rb") as f:
                while len(out) < count:
                    try:
                        for kid, key in _PortUnpickler(f).load():
                            out.setdefault(kid, key)
                    except EOFError:
                        break
        return out


# ----------------------------------------------------------------- restart

@dataclass
class RestartStrategy:
    """ref RestartStrategies (fixed-delay / failure-rate /
    exponential-delay / no-restart); the reference's, copied."""

    # none | fixed-delay | failure-rate | exponential-backoff
    kind: str = "none"
    attempts: int = 3
    delay_s: float = 0.0
    failure_rate: int = 3       # max failures...
    failure_interval_s: float = 60.0  # ...per interval
    # exponential-backoff knobs: the delay grows by `multiplier` per
    # consecutive failure up to `max_delay_s`; a failure-free quiet period
    # of `reset_after_s` resets it to `initial_delay_s`; `jitter` is a
    # +-fraction drawn uniformly. Attempts are UNBOUNDED — the growing
    # delay is the budget.
    initial_delay_s: float = 1.0
    max_delay_s: float = 60.0
    multiplier: float = 2.0
    jitter: float = 0.1
    reset_after_s: float = 3600.0

    _failures: list = None
    _last_failure_t: float = None
    _consecutive: int = 0
    # delays actually slept, newest last (bounded)
    delays: list = None

    @staticmethod
    def none() -> "RestartStrategy":
        return RestartStrategy("none")

    @staticmethod
    def fixed_delay(attempts: int, delay_s: float = 0.0) -> "RestartStrategy":
        return RestartStrategy("fixed-delay", attempts=attempts,
                               delay_s=delay_s)

    @staticmethod
    def failure_rate(max_per_interval: int, interval_s: float,
                     delay_s: float = 0.0) -> "RestartStrategy":
        return RestartStrategy(
            "failure-rate", failure_rate=max_per_interval,
            failure_interval_s=interval_s, delay_s=delay_s,
        )

    @staticmethod
    def exponential_backoff(initial_delay_s: float = 1.0,
                            max_delay_s: float = 60.0,
                            multiplier: float = 2.0,
                            jitter: float = 0.1,
                            reset_after_s: float = 3600.0
                            ) -> "RestartStrategy":
        return RestartStrategy(
            "exponential-backoff", initial_delay_s=initial_delay_s,
            max_delay_s=max_delay_s, multiplier=multiplier, jitter=jitter,
            reset_after_s=reset_after_s,
        )

    def next_backoff_delay(self, now: float = None) -> float:
        """The delay the NEXT exponential-backoff restart would sleep
        (also advances the consecutive-failure bookkeeping)."""
        now = time.time() if now is None else now
        if (
            self._last_failure_t is not None
            and self.reset_after_s > 0
            and now - self._last_failure_t >= self.reset_after_s
        ):
            self._consecutive = 0       # quiet period: back to initial
        self._last_failure_t = now
        self._consecutive += 1
        delay = min(
            float(self.max_delay_s),
            float(self.initial_delay_s)
            * float(self.multiplier) ** (self._consecutive - 1),
        )
        if self.jitter > 0:
            delay *= 1.0 + random.uniform(-self.jitter, self.jitter)
        return max(0.0, min(delay, float(self.max_delay_s)
                            * (1.0 + self.jitter)))

    def should_restart(self) -> bool:
        now = time.time()
        if self.kind == "none":
            return False
        if self.kind == "exponential-backoff":
            delay = self.next_backoff_delay(now)
            if self.delays is None:
                self.delays = []
            self.delays.append(delay)
            del self.delays[:-50]
            if delay:
                time.sleep(delay)
            return True
        if self._failures is None:
            self._failures = []
        self._failures.append(now)
        if self.kind == "fixed-delay":
            ok = len(self._failures) <= self.attempts
        else:
            window = [t for t in self._failures
                      if t > now - self.failure_interval_s]
            self._failures = window
            ok = len(window) <= self.failure_rate
        if ok and self.delay_s:
            time.sleep(self.delay_s)
        return ok


def restart_strategy(cfg) -> RestartStrategy:
    """The job's ``restart-strategy`` (the reference's
    ``LocalExecutor._restart_strategy``), read through the declared
    options."""
    kind = cfg.get(CO.RESTART_STRATEGY)
    if kind == "fixed-delay":
        return RestartStrategy.fixed_delay(cfg.get(CO.RESTART_ATTEMPTS),
                                           cfg.get(CO.RESTART_DELAY_S))
    if kind == "failure-rate":
        return RestartStrategy.failure_rate(
            cfg.get(CO.RESTART_FAILURE_RATE_MAX),
            cfg.get(CO.RESTART_FAILURE_RATE_INTERVAL),
            cfg.get(CO.RESTART_FAILURE_RATE_DELAY))
    if kind == "exponential-backoff":
        return RestartStrategy.exponential_backoff(
            cfg.get(CO.RESTART_EXP_INITIAL_DELAY),
            cfg.get(CO.RESTART_EXP_MAX_DELAY),
            cfg.get(CO.RESTART_EXP_MULTIPLIER),
            cfg.get(CO.RESTART_EXP_JITTER),
            cfg.get(CO.RESTART_EXP_RESET_AFTER))
    if kind != "none":
        raise ValueError(
            f"restart-strategy must be none|fixed-delay|failure-rate|"
            f"exponential-backoff, got {kind!r}")
    return RestartStrategy.none()
