"""The hand-written Hopper kernels and their plain versions.

Twenty-eight CUDA C++ kernels (``flink_tpu_torch/csrc/*.cu``, built for
``sm_90a``) carry the device work of the window stage (G1-G9, G14, G15
for its sketch reduces, G16 for its generic reduce, G17 and G18 for its
telemetry), of chained window stages (G21, G22), of the session,
count-window and rolling stages (G10-G13, G16), of device CEP (G19,
G20, with G5 and G10) and of the batch libraries (G23-G25: Table/SQL,
DataSet, Gelly, FlinkML) and of jobs over a shard mesh (G26, G27), and
the hash table's point removal (G28, which no path calls, as in the
reference); each source opens
with the reference function it replaces, what bounds it on the card and
what its design does about that:

  G1 ``route_lanes``     key-group routing + the update's lane prologue,
                         and optionally the batch's key-group fill and
                         the residency divert's cold lanes (tiered state)
  G2 ``clear_rows``      ring-row resets, eviction count, deferred purge
                         (packed planes, or split planes), fresh rows;
     ``fresh_rows``      each ring row's count of fresh flags
  G3 ``scatter_update``  the update's accumulate phase (atomic add, min,
                         max), the lateness fresh marking
  G4 ``fire_reduced``    window evaluation reduced to per-lane scalars
  G5 ``hash_upsert``     probe_hash + insert-or-find in the hash layout
  G6 ``fire_compact``    window evaluation compacted to (key, value) rows;
     ``fire_pack``       the same compaction of a dense fire result
  G7 ``ring_append``     nofit lanes appended to the overflow ring
  G8 ``hash_lookup``     the fast step's find-only probe + missing count
  G9 ``compact_table``   table rebuild around the live keys, state moved
  G10 ``segment_sort``   stable radix sort of lanes by slot (or slot, tick):
                         one cooperative launch, onesweep passes over the
                         digits that vary, decoupled look-back
  G11 ``session_update`` session cuts, merges, fires and watermark close
  G12 ``count_update``   count windows: positions, window reduce, fires
  G13 ``rolling_update`` rolling reduce: segmented scan, lane-order outputs
  G14 ``sketch_update``  Count-Min / HyperLogLog register scatter (add, max)
  G15 ``sketch_fire``    sketch windows: pane combine, finalize, compaction
  G16 ``rep_gather``     a generic reduce's sorted values and old rows;
      ``rep_set``        its merged rows set, with the lane bookkeeping
  G17 ``kg_occupancy``   live keys per key group of a window state
  G18 ``slot_stats``     a drain slot's flight-recorder row;
      ``slot_stats_begin`` the slot's counters saved before its update
  G19 ``cep_scan``       CEP's count NFA: each key's events applied in lane
                         order to its carried count vector, match deltas
  G20 ``cep_expire``     CEP's within() expiry: stale ring buckets zeroed
  G21 ``chain_pack``     a drain's stacked fires packed into the next
                         chained stage's edge lanes; its coupled watermark
  G22 ``fire_columns``   the chained drain's deferred recorder columns;
      ``stage_record``   a downstream stage's recorder row (G18's source)
  G23 ``scatter_ids``    lanes combined into rows by group id (add, min,
                         max; counts, touched rows): the libraries'
                         grouped reduce and scatters
  G24 ``sorted_probe``   a broadcast join's probe: binary search of the
                         sorted build keys
  G25 ``row_argmin``     a row's nearest center (KMeans), a warp a row;
      ``row_argmax``     a row's adopted label (community detection), a
                         block a row at K >= 1,024 (float4 loads, four
                         candidates a thread), in one source
                         ``row_argbest.cu``
  G26 ``exchange_pack``  the keyed exchange's bucket step: a source shard's
                         lanes packed by owning shard at stable ranks
  G27 ``shard_sum``      the cross-shard sum of masked per-lane outputs
                         (the rolling reduce's psum)
  G28 ``remove_slots``   table slots marked empty (the hash layout's point
                         removal)

The builtin reduces combine by ``OPS``: add (sum, count), min, max, with
jnp's NaN and signed-zero order (``fmin`` / ``fmax``). A generic reduce's
combine is the user's torch function; it runs as torch ops between G16's
two launches and in the fire before G6's ``fire_pack``: the one path with
no hand kernel for its combine.

G11-G13 share one segmented scan (``csrc/segscan.cuh``), and G7, G9, G11
and G12 one stable row compaction (``csrc/ring.cuh``).

Build: ``nvcc`` compiles each source to an object (all started together)
and links one shared library with a plain C interface under
``flink_tpu_torch/_build/``, on first use, keyed by a hash of the sources
and flags. ``ctypes`` loads it; every pointer and the stream go in as
``c_void_p``.

Wrappers: each takes tensors on one device. On a CPU tensor it runs its
plain PyTorch version (below, same arguments, same results); on a CUDA
tensor it launches the kernel on the current stream or raises — there is
no fallback. Outputs and scratch are allocated here with ``torch.empty`` /
``torch.zeros``; the kernels allocate nothing. Each wrapper counts its
launches in ``<wrapper>.launches`` (a plain int), and nowhere else; G1
counts its launches with the key-group fill in ``fill_launches`` too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from flink_tpu_torch.core.keygroups import assign_to_key_group
from flink_tpu_torch.metrics.drain_stats import (
    DRAIN_STAT_FIELDS, STAGE_STAT_FIELDS,
)
from flink_tpu_torch.ops.hashing import probe_hash, route_hash

PANE_NONE = -(2**31) + 1
INT32_MAX = 2**31 - 1
# the hash layout's empty slot: the all-ones 64-bit key word (the
# reference's uint32 [C, 2] row of EMPTY = 0xFFFFFFFF halves)
EMPTY_WORD = -1

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("route_lanes.cu", "clear_rows.cu", "scatter_update.cu",
           "fire_reduced.cu", "hash_upsert.cu", "fire_compact.cu",
           "ring_append.cu", "hash_lookup.cu", "compact_table.cu",
           "segment_sort.cu", "session_update.cu", "count_update.cu",
           "rolling_update.cu", "sketch_update.cu", "sketch_fire.cu",
           "rep_update.cu", "kg_occupancy.cu", "slot_stats.cu",
           "cep_scan.cu", "chain_pack.cu", "scatter_ids.cu",
           "sorted_probe.cu", "row_argbest.cu", "exchange_pack.cu",
           "shard_sum.cu", "remove_slots.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_F = ctypes.c_float
_L = ctypes.c_longlong
_U = ctypes.c_ulonglong
_UI = ctypes.c_uint
_SIGNATURES = {
    "route_lanes": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                    _P, _P, _P, _P, _P, _P, _P],
    "clear_rows": [_P, _I, _F, _P, _P, _P, _I, _I, _P, _P, _P],
    "clear_rows_split": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P,
                         _P],
    "fresh_rows": [_P, _I, _I, _P, _P],
    "scatter_update": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       _I, _I, _P, _P, _P, _P],
    "fire_reduced": [_P, _I, _I, _F, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P,
                     _P, _P],
    "hash_upsert": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "fire_compact": [_P, _I, _I, _F, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                     _P, _P, _I, _UI, _P, _P, _P, _P, _P, _P],
    "fire_pack": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _I, _UI, _P, _P, _P,
                  _P, _P, _P],
    "fire_compact_tiles": [_I],
    "ring_append": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                    _P, _P, _P],
    "hash_lookup": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "compact_alive": [_P, _I, _F, _I, _I, _P, _P],
    "compact_move": [_P, _I, _F, _P, _P, _I, _I, _P, _P, _P],
    "compact_export": [_P, _I, _F, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                       _P, _P, _P, _P, _P, _P],
    "segment_sort": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _UI,
                     _P],
    "segment_sort_tile": [],
    "segment_sort_state_words": [],
    "session_update": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                       _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P, _P, _P, _P, _P],
    "count_update": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P,
                     _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "rolling_update": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    "sketch_update": [_P] * 11 + [_I] * 8 + [_P],
    "sketch_fire": [_P] * 6 + [_I] * 7 + [_P, _I, _I, _I, _D, _D, _I]
    + [_P] * 10,
    "rep_gather": [_P, _P, _P, _P, _P, _P, _I, _I, _L, _P, _P, _P, _P],
    "rep_set": [_P, _P, _I, _L, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                _I, _I, _P, _P, _P, _P, _P, _P],
    "kg_occupancy": [_P, _I, _I, _P, _I, _F, _P, _P, _I, _P, _P],
    "slot_stats_begin": [_P, _P, _P, _P, _P],
    "slot_stats": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I,
                   _P, _P],
    "fire_columns": [_P, _I, _I, _P, _P, _I, _P],
    "stage_record": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P],
    "chain_pack": [_P] * 6 + [_I] * 4 + [_P, _P, _I] + [_P] * 8,
    "cep_scan": [_P] * 4 + [_U] * 2 + [_I] * 6 + [_P] * 7,
    "cep_expire": [_P, _L, _I, _I, _I, _U, _U, _P],
    "scatter_ids": [_P, _I, _L, _P, _I, _L, _I, _F, _P, _P, _P, _P, _P],
    "scatter_ids_scratch": [_L, _P, _I, _L],
    "sorted_probe": [_P, _I, _P, _I, _P, _P, _P, _P, _P],
    "row_argmin": [_P, _I, _I, _P, _P, _P, _P],
    "row_argmax": [_P, _I, _I, _P, _P, _F, _P, _P, _P],
    "exchange_pack": [_P] * 5 + [_I] * 5 + [_P] * 8,
    "shard_sum": [_P, _P, _I, _I, _I, _P, _P, _P],
    "remove_slots": [_P, _L, _P, _I, _P, _I, _P],
}
# the entry points that return something other than a CUDA error code
_RESTYPES = {"scatter_ids_scratch": ctypes.c_longlong}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    toolkit = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if nvcc is None and os.path.exists(toolkit):
        nvcc = toolkit
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the window kernels are built from "
            "flink_tpu_torch/csrc on first use and need the CUDA toolkit"
        )
    return nvcc


def library_path() -> Path:
    """Where the shared library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libflink_tpu_torch_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, _obj, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{src}:\n{log.decode(errors='replace')}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = os.path.join(tmp, out.name)
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp_so] + [o for _s, o, _p in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        if link.returncode:
            raise RuntimeError(
                "nvcc link failed:\n" + link.stdout.decode(errors="replace"))
        os.replace(tmp_so, out)


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernels' shared library. The
    compile runs under a file lock in the build directory, so processes
    that start together (the workers of the cross-process plane) build it
    once: the first takes the lock and builds, the others wait and load."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                import fcntl

                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with open(BUILD_DIR / "build.lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not path.exists():
                        _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = lib
        return _lib


# ------------------------------------------------------------ checks

def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"unsupported device {t.device}")
    return False


def _check(t: Optional[torch.Tensor], name: str, dtype, shape,
           device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this dtype on this
    device, with this shape (any shape when ``shape`` is None)."""
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error {rc}")


def _floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


# ------------------------------------------------------------ the combines

OPS = {"add": 0, "min": 1, "max": 2}


def fmin(a, b):
    """jnp.minimum (and XLA's scatter-min): NaN wins, -0.0 < +0.0, in
    either argument order (torch.minimum keeps the first of two zeros)."""
    r = torch.where((a < b) | ((a == b) & torch.signbit(a)), a, b)
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, r))


def fmax(a, b):
    """jnp.maximum: NaN wins, +0.0 > -0.0, in either argument order."""
    r = torch.where((a > b) | ((a == b) & ~torch.signbit(a)), a, b)
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, r))


COMBINE = {"add": torch.add, "min": fmin, "max": fmax}


def _expand(flag, like):
    """``flag`` [n] reshaped to broadcast against ``like`` [n, ...]."""
    return flag.reshape(flag.shape + (1,) * (like.dim() - flag.dim()))


# ------------------------------------------------------------ G1

def kg_batch_fill_plain(kg, mask, n_key_groups: int) -> torch.Tensor:
    """Per-key-group lane counts (the reference's ``kg_batch_fill``): int32
    [n_key_groups], the ``mask``-selected lanes bincounted by their key
    group ``kg`` (int32 [B])."""
    idx = torch.where(mask, kg.long(), n_key_groups)
    out = torch.zeros(n_key_groups + 1, dtype=torch.int32, device=kg.device)
    out.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return out[:n_key_groups]


def route_lanes_plain(hi, lo, ts, valid, watermark, purged_through, *,
                      slide: int, k: int, maxp: int, kg_start: int,
                      kg_end: int, L: int = 0, fill=None, res=None):
    """Plain version of G1. hi/lo: int32 [B] holding uint32 bits; ts int32
    [B] ticks; valid bool [B]; watermark / purged_through int32 0-d; L the
    allowed lateness in ticks. Returns (pane int32 [B], kg int32 [B], live
    bool [B], stats int32 [4]) with stats = (late lanes, max live pane, min
    live pane, valid lanes). A lane is late when the newest window holding
    its pane ended more than L ticks before the watermark, or its pane is
    purged. ``fill`` (int32 [maxp]), when given, gets the key groups of the
    owned valid lanes added to it, in place, late lanes included (the
    reference's kg_fill, counted before the late check). ``res`` (bool
    [maxp]), when given, is tiered state's residency mask: a fifth output,
    cold bool [B], marks the live lanes whose key group is not resident
    (the reference's ``tier_nonres``, window_kernels.py:784)."""
    kg = assign_to_key_group(route_hash(hi, lo), maxp).to(torch.int32)
    pane = _floor_div(ts, slide).to(torch.int32)
    mine = valid & (kg >= kg_start) & (kg <= kg_end)
    base = torch.clamp_min(watermark, -(2**31) + 1 + slide + L) - L
    wm_pane_l = _floor_div(base + 1 - slide, slide)
    late = mine & ((pane + (k - 1) <= wm_pane_l) | (pane <= purged_through))
    live = mine & ~late
    # the sentinels head each extreme, so an empty batch reads them (G1's
    # initial stats)
    none, top = (torch.full((1,), v, dtype=torch.int32, device=hi.device)
                 for v in (PANE_NONE, INT32_MAX))
    stats = torch.stack([
        late.sum(dtype=torch.int32),
        torch.cat([none, torch.where(live, pane, PANE_NONE)]).max(),
        torch.cat([top, torch.where(live, pane, INT32_MAX)]).min(),
        valid.sum(dtype=torch.int32),
    ]).to(torch.int32)
    if fill is not None:
        fill += kg_batch_fill_plain(kg, mine, maxp)
    if res is not None:
        return pane, kg, live, stats, live & ~res[kg.long()]
    return pane, kg, live, stats


def route_lanes(hi, lo, ts, valid, watermark, purged_through, *, slide: int,
                k: int, maxp: int, kg_start: int, kg_end: int, L: int = 0,
                fill=None, res=None):
    """G1: see route_lanes_plain for the contract."""
    if _on_cpu(hi):
        return route_lanes_plain(
            hi, lo, ts, valid, watermark, purged_through, slide=slide, k=k,
            maxp=maxp, kg_start=kg_start, kg_end=kg_end, L=L, fill=fill,
            res=res)
    dev = hi.device
    (B,) = hi.shape
    for t, n, dt in ((hi, "hi", torch.int32), (lo, "lo", torch.int32),
                     (ts, "ts", torch.int32), (valid, "valid", torch.bool)):
        _check(t, n, dt, (B,), dev)
    _check(watermark, "watermark", torch.int32, (), dev)
    _check(purged_through, "purged_through", torch.int32, (), dev)
    if fill is not None:
        _check(fill, "fill", torch.int32, (maxp,), dev)
    cold = None
    if res is not None:
        _check(res, "res", torch.bool, (maxp,), dev)
        cold = torch.empty(B, dtype=torch.bool, device=dev)
    if L < 0 or slide + L > INT32_MAX // 2:
        raise ValueError(f"allowed lateness {L} out of range")
    pane = torch.empty(B, dtype=torch.int32, device=dev)
    kg = torch.empty(B, dtype=torch.int32, device=dev)
    live = torch.empty(B, dtype=torch.bool, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    rc = build().route_lanes(
        _ptr(hi), _ptr(lo), _ptr(ts), _ptr(valid), B, _ptr(watermark),
        _ptr(purged_through), slide, k, L, maxp, kg_start, kg_end,
        _ptr(pane), _ptr(kg), _ptr(live), _ptr(stats), _ptr(fill),
        _ptr(res), _ptr(cold), _stream())
    _raise_on(rc, "route_lanes")
    route_lanes.launches += 1
    if fill is not None:
        route_lanes.fill_launches += 1
    if res is not None:
        route_lanes.res_launches += 1
        return pane, kg, live, stats, cold
    return pane, kg, live, stats


route_lanes.launches = 0
route_lanes.fill_launches = 0      # of those, the launches with the fill
route_lanes.res_launches = 0       # and those with the residency mask


# ------------------------------------------------------------ G2

_PATTERNS = {}


def _pattern(neutral, W: int, dev) -> torch.Tensor:
    """The 32-bit words of a split plane's neutral: one word when every
    component is equal, else the W words of a row; cached per device."""
    words = torch.as_tensor(neutral, dtype=torch.float32).reshape(-1)
    words = words.expand(W) if words.numel() == 1 else words
    if bool((words == words[0]).all()):
        words = words[:1]
    key = (tuple(words.view(torch.int32).tolist()), str(dev))
    if key not in _PATTERNS:
        _PATTERNS[key] = words.view(torch.int32).to(dev)
    return _PATTERNS[key]


def clear_rows_plain(acc, clear, evicted, dropped_capacity, *, C: int,
                     R: int, touched=None, neutral=0.0, fresh=None,
                     fresh_clear=None) -> None:
    """Plain version of G2, in place. acc float32 [C*R, Wc] packed plane
    (Wc - 1 value columns and the touch column), or with ``touched`` (bool
    [C*R]) split planes: a sketch's int32 registers [C*R, W] or a generic
    reduce's float32 values [C*R, *value_shape]; clear bool [R]; evicted
    bool [R] or None; dropped_capacity int32 0-d (gains the touched keys of
    evicted rows, counted before the clear). Flagged rows take the
    ``neutral`` (a float, or a value_shape array for split float planes)
    and lose their touch marks. ``fresh`` (bool [C*R]) clears its rows
    flagged in ``fresh_clear`` (``clear`` when None)."""
    a3 = acc.view(R, C, -1)
    if touched is not None:
        t2 = touched.view(R, C)
        if evicted is not None:
            n = (t2 & evicted[:, None]).sum()
            dropped_capacity.add_(n.to(torch.int32))
        fill = torch.as_tensor(neutral, dtype=acc.dtype,
                               device=acc.device).reshape(-1)
        a3.copy_(torch.where(clear[:, None, None], fill.view(1, 1, -1), a3))
        t2.masked_fill_(clear[:, None], False)
    else:
        if evicted is not None:
            n = torch.where(evicted[:, None], a3[:, :, -1] != neutral,
                            False).sum()
            dropped_capacity.add_(n.to(torch.int32))
        a3.masked_fill_(clear[:, None, None], float(neutral))
    if fresh is not None:
        rows = clear if fresh_clear is None else fresh_clear
        fresh.view(R, C).masked_fill_(rows[:, None], False)


def clear_rows(acc, clear, evicted, dropped_capacity, *, C: int, R: int,
               touched=None, neutral=0.0, fresh=None,
               fresh_clear=None) -> None:
    """G2: see clear_rows_plain for the contract."""
    if _on_cpu(acc):
        return clear_rows_plain(acc, clear, evicted, dropped_capacity, C=C,
                                R=R, touched=touched, neutral=neutral,
                                fresh=fresh, fresh_clear=fresh_clear)
    dev = acc.device
    _check(clear, "clear", torch.bool, (R,), dev)
    if evicted is not None:
        _check(evicted, "evicted", torch.bool, (R,), dev)
    _check(dropped_capacity, "dropped_capacity", torch.int32, (), dev)
    if fresh is not None:
        _check(fresh, "fresh", torch.bool, (C * R,), dev)
        fresh_clear = clear if fresh_clear is None else fresh_clear
        _check(fresh_clear, "fresh_clear", torch.bool, (R,), dev)
    W = acc[0].numel() if acc.shape[0] else 1
    if touched is not None:
        if acc.dtype not in (torch.int32, torch.float32):
            raise TypeError(f"split plane of {acc.dtype}")
        _check(acc, "acc", acc.dtype, (C * R,) + tuple(acc.shape[1:]), dev)
        _check(touched, "touched", torch.bool, (C * R,), dev)
        pat = _pattern(0.0 if acc.dtype == torch.int32 else neutral, W, dev)
        rc = build().clear_rows_split(
            _ptr(acc), _ptr(touched), _ptr(pat), pat.numel(), _ptr(clear),
            _ptr(evicted), _ptr(dropped_capacity), C, R, W, _ptr(fresh),
            _ptr(fresh_clear), _stream())
    else:
        _check(acc, "acc", torch.float32, (C * R, W), dev)
        rc = build().clear_rows(_ptr(acc), W, float(neutral), _ptr(clear),
                                _ptr(evicted), _ptr(dropped_capacity), C, R,
                                _ptr(fresh), _ptr(fresh_clear), _stream())
    _raise_on(rc, "clear_rows")
    clear_rows.launches += 1


clear_rows.launches = 0


def fresh_rows_plain(fresh, *, C: int, R: int) -> torch.Tensor:
    """Plain version of G2's fresh_rows: int32 [R], the set flags of each
    ring row of the fresh plane (bool [C*R])."""
    return fresh.view(R, C).sum(dim=1, dtype=torch.int32)


def fresh_rows(fresh, *, C: int, R: int) -> torch.Tensor:
    """G2 fresh_rows: see fresh_rows_plain for the contract."""
    if _on_cpu(fresh):
        return fresh_rows_plain(fresh, C=C, R=R)
    dev = fresh.device
    _check(fresh, "fresh", torch.bool, (C * R,), dev)
    counts = torch.zeros(R, dtype=torch.int32, device=dev)
    rc = build().fresh_rows(_ptr(fresh), C, R, _ptr(counts), _stream())
    _raise_on(rc, "fresh_rows")
    fresh_rows.launches += 1
    return counts


fresh_rows.launches = 0


# ------------------------------------------------------------ G3

def _scatter_combine_rows(target, idx, upd, op) -> None:
    """target[idx[i]] = op(target[idx[i]], upd[i]) for every i, duplicates
    combined (in place): a stable sort by index, a segmented scan of each
    index's rows, one combine with the target at each index."""
    if idx.numel() == 0:
        return
    order = torch.sort(idx, stable=True).indices
    ids, u = idx[order], upd[order]
    start = torch.ones_like(ids, dtype=torch.bool)
    start[1:] = ids[1:] != ids[:-1]
    red = seg_scan_plain(start, u, op)
    end = _seg_end(start)
    t = ids[end]
    target[t] = op(target[t], red[end])


def scatter_update_plain(acc, kg_dirty, dropped_capacity, pane, kg, live,
                         slot, values, max_pane, *, C: int, R: int,
                         count_nofit: bool = True, op: str = "add",
                         fresh=None, fired_through=None,
                         n_fresh=None) -> None:
    """Plain version of G3, in place. acc float32 [C*R, W+1] packed plane;
    kg_dirty bool [G] or None; dropped_capacity int32 0-d; pane/kg int32
    [B]; live bool [B]; slot int32 [B], the lane's state slot or C for none
    (the direct layout's key past capacity, the hash layout's key that
    found no slot); values float32 [B] or [B, W], or None (count: every
    lane adds 1.0); max_pane int32 0-d, already advanced; ``op`` the
    reduce's combine (OPS): each lane combines its values into its cell
    and its touch marker (1.0 for add, 0.0 for min and max) into the touch
    column. Too-old lanes count into dropped_capacity, and so do live lanes
    with no slot unless ``count_nofit`` is False (the overflow ring took
    them). With ``fresh`` (bool [C*R]), a placed lane whose pane is at or
    before ``fired_through`` (int32 0-d) sets its cell's flag and adds one
    to ``n_fresh`` (int32 0-d)."""
    too_old = live & (pane < max_pane - (R - 1))
    live = live & ~too_old
    if kg_dirty is not None:
        kg_dirty[kg[live].long()] = True
    ok = live & (slot >= 0) & (slot < C)
    nofit = live & ~ok
    n_nofit = nofit.sum() if count_nofit else 0
    dropped_capacity.add_((too_old.sum() + n_nofit).to(torch.int32))
    flat = torch.remainder(pane.to(torch.int64), R) * C + slot.to(torch.int64)
    idx = flat[ok]
    W = acc.shape[1] - 1
    n = idx.shape[0]
    v = (values[ok].reshape(n, W) if values is not None else
         torch.ones(n, W, dtype=acc.dtype, device=acc.device))
    marker = torch.full((n, 1), 1.0 if op == "add" else 0.0,
                        dtype=acc.dtype, device=acc.device)
    upd = torch.cat([v, marker], 1)
    if op == "add":
        acc.index_add_(0, idx, upd)
    else:
        _scatter_combine_rows(acc, idx, upd, COMBINE[op])
    if fresh is not None:
        late = ok & (pane <= fired_through)
        fresh[flat[late]] = True
        n_fresh.add_(late.sum().to(torch.int32))


def scatter_update(acc, kg_dirty, dropped_capacity, pane, kg, live, slot,
                   values, max_pane, *, C: int, R: int,
                   count_nofit: bool = True, op: str = "add", fresh=None,
                   fired_through=None, n_fresh=None) -> None:
    """G3: see scatter_update_plain for the contract."""
    if _on_cpu(acc):
        return scatter_update_plain(acc, kg_dirty, dropped_capacity, pane,
                                    kg, live, slot, values, max_pane, C=C,
                                    R=R, count_nofit=count_nofit, op=op,
                                    fresh=fresh, fired_through=fired_through,
                                    n_fresh=n_fresh)
    dev = acc.device
    (B,) = pane.shape
    W = acc.shape[1] - 1
    _check(acc, "acc", torch.float32, (C * R, W + 1), dev)
    if kg_dirty is not None:
        _check(kg_dirty, "kg_dirty", torch.bool, None, dev)
    _check(dropped_capacity, "dropped_capacity", torch.int32, (), dev)
    for t, n, dt in ((pane, "pane", torch.int32), (kg, "kg", torch.int32),
                     (live, "live", torch.bool), (slot, "slot", torch.int32)):
        _check(t, n, dt, (B,), dev)
    if values is not None:
        _check(values, "values", torch.float32,
               (B,) if values.dim() == 1 else (B, W), dev)
        if values.dim() == 1 and W != 1:
            raise ValueError(f"{W} value columns, scalar values given")
    _check(max_pane, "max_pane", torch.int32, (), dev)
    if fresh is not None:
        _check(fresh, "fresh", torch.bool, (C * R,), dev)
        _check(fired_through, "fired_through", torch.int32, (), dev)
        _check(n_fresh, "n_fresh", torch.int32, (), dev)
    rc = build().scatter_update(
        _ptr(acc), W, OPS[op], _ptr(kg_dirty), _ptr(dropped_capacity),
        _ptr(pane), _ptr(kg), _ptr(live), _ptr(slot), _ptr(values),
        _ptr(max_pane), B, C, R, int(count_nofit), _ptr(fresh),
        _ptr(fired_through), _ptr(n_fresh), _stream())
    _raise_on(rc, "scatter_update")
    scatter_update.launches += 1


scatter_update.launches = 0


# ------------------------------------------------------------ G4

MAX_PLANE_W = 16      # value columns a packed plane may have (fire_eval.cuh)


def _eval_fire_lanes_plain(acc, pane_ids, p_f, lane_ok, *, C: int, R: int,
                           k: int, op: str = "add", neutral=0.0, fresh=None,
                           n_ontime=None):
    """The windows ending at panes ``p_f`` for every slot of a packed plane
    acc [C*R, W+1]: (emit bool [F, C], value float32 [F, C, W]). Pane q
    lives in ring row q mod R and counts where pane_ids[row] == q and the
    row's touch column differs from ``neutral``; a slot's value combines
    its counting panes from the neutral, in pane order, by ``op``. A slot
    is emitted when any of its k panes counts — or, for a lane f >=
    ``n_ontime`` with a ``fresh`` plane (bool [C*R]), any of its present
    panes is fresh (an allowed-lateness re-fire)."""
    Wc = acc.shape[1]
    a3 = acc.view(R, C, Wc)
    F = p_f.shape[0]
    combine = COMBINE[op]
    vals = torch.full((F, C, Wc - 1), float(neutral), dtype=acc.dtype,
                      device=acc.device)
    emit = torch.zeros(F, C, dtype=torch.bool, device=acc.device)
    late = torch.zeros(F, dtype=torch.bool, device=acc.device)
    if fresh is not None:
        late[n_ontime:] = True
        f2 = fresh.view(R, C)
    for j in range(k):
        q = p_f - (k - 1) + j
        row = torch.remainder(q, R).long()
        present = lane_ok & (pane_ids[row] == q)
        cells = a3[row]                                   # [F, C, Wc]
        t = (cells[:, :, -1] != neutral) & present[:, None]
        vals = torch.where(t[:, :, None], combine(vals, cells[:, :, :-1]),
                           vals)
        m = t if fresh is None else torch.where(
            late[:, None], f2[row] & present[:, None], t)
        emit = emit | m
    return emit, vals


def fire_reduced_plain(acc, pane_ids, p_f, lane_ok, *, C: int, R: int,
                       k: int, op: str = "add", neutral=0.0, fresh=None,
                       n_ontime=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of G4. acc float32 [C*R, W+1]; pane_ids int32 [R];
    p_f int32 [F] window-end pane per lane; lane_ok bool [F]; ``op``,
    ``neutral``, ``fresh`` and ``n_ontime`` as for _eval_fire_lanes_plain.
    Returns (counts int32 [F], value_sums float32 [F]: every value column
    of every emitted slot)."""
    emit, vals = _eval_fire_lanes_plain(
        acc, pane_ids, p_f, lane_ok, C=C, R=R, k=k, op=op, neutral=neutral,
        fresh=fresh, n_ontime=n_ontime)
    counts = emit.sum(dim=1, dtype=torch.int32)
    vsums = torch.where(emit[:, :, None], vals, 0.0).sum(dim=(1, 2)).to(
        torch.float32)
    return counts, vsums


def _check_fire(acc, pane_ids, p_f, lane_ok, fresh, n_ontime, *, C, R, k):
    dev = acc.device
    (F,) = p_f.shape
    Wc = acc.shape[1]
    if not 2 <= Wc <= MAX_PLANE_W + 1:
        raise NotImplementedError(f"a packed plane of {Wc - 1} value "
                                  f"columns (at most {MAX_PLANE_W})")
    if not 1 <= k < R or k > 64:
        raise ValueError(f"{k} panes a window in a ring of {R}")
    _check(acc, "acc", torch.float32, (C * R, Wc), dev)
    _check(pane_ids, "pane_ids", torch.int32, (R,), dev)
    _check(p_f, "p_f", torch.int32, (F,), dev)
    _check(lane_ok, "lane_ok", torch.bool, (F,), dev)
    if fresh is not None:
        _check(fresh, "fresh", torch.bool, (C * R,), dev)
        if not 0 <= n_ontime <= F:
            raise ValueError(f"n_ontime {n_ontime} of {F} lanes")
    return F, Wc - 1


def fire_reduced(acc, pane_ids, p_f, lane_ok, *, C: int, R: int, k: int,
                 op: str = "add", neutral=0.0, fresh=None,
                 n_ontime=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """G4: see fire_reduced_plain for the contract."""
    if _on_cpu(acc):
        return fire_reduced_plain(acc, pane_ids, p_f, lane_ok, C=C, R=R, k=k,
                                  op=op, neutral=neutral, fresh=fresh,
                                  n_ontime=n_ontime)
    dev = acc.device
    F, W = _check_fire(acc, pane_ids, p_f, lane_ok, fresh, n_ontime, C=C,
                       R=R, k=k)
    counts = torch.zeros(F, dtype=torch.int32, device=dev)
    vsums = torch.zeros(F, dtype=torch.float32, device=dev)
    rc = build().fire_reduced(
        _ptr(acc), W, OPS[op], float(neutral), _ptr(fresh),
        F if fresh is None else n_ontime, _ptr(pane_ids), _ptr(p_f),
        _ptr(lane_ok), C, R, k, F, _ptr(counts), _ptr(vsums), _stream())
    _raise_on(rc, "fire_reduced")
    fire_reduced.launches += 1
    return counts, vsums


fire_reduced.launches = 0

# ------------------------------------------------------------ G5

def split_words(words: torch.Tensor):
    """int64 key words -> (hi, lo) int32 tensors holding the uint32 bits."""
    return (words >> 32).to(torch.int32), words.to(torch.int32)


def key_words(hi, lo) -> torch.Tensor:
    """(hi, lo) int32 [B] holding uint32 bits -> int64 key words
    ``(hi << 32) | lo`` (the all-ones word is EMPTY_WORD)."""
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) & 0xFFFFFFFF)


def probe_chain(hi, lo, *, C: int, probe_len: int) -> torch.Tensor:
    """[B, P] int64 candidate slots of each key's probe chain: P slots from
    ``probe_hash & (C - 1)``, wrapping at C."""
    base = probe_hash(hi, lo) & (C - 1)
    offs = torch.arange(probe_len, dtype=torch.int64, device=hi.device)
    return (base[:, None] + offs[None, :]) & (C - 1)


def hash_upsert_plain(table, hi, lo, valid, *, probe_len: int):
    """Plain version of G5: insert-or-find a batch of keys, table updated
    in place. table int64 [C] key words (EMPTY_WORD = free); hi/lo int32
    [B] (uint32 bits); valid bool [B]. Returns (slot int32 [B], C where
    not ok; ok bool [B]; n_new int32 0-d).

    A lane is ok when its key ends up in its P-slot chain. Its key goes to
    the first slot of the chain that holds it or is free; claims of one
    free slot by several keys go to the lowest lane, and the losers walk
    on, round after round, until no lane can claim — so a lane fails only
    when every slot of its chain holds another key (the kernel's CAS walk).
    The key EMPTY_WORD (integer key -1) is never placed nor found.
    ``n_new`` counts valid lanes whose key was absent before the call and
    present after, duplicates of a key placed in this call included (the
    reference's ``valid & ~found0 & found``)."""
    C = table.shape[0]
    B = hi.shape[0]
    key = key_words(hi, lo)
    cand = probe_chain(hi, lo, C=C, probe_len=probe_len)
    lanes = valid & (key != EMPTY_WORD)
    found0 = lanes & (table[cand] == key[:, None]).any(dim=1)
    lane_idx = torch.arange(B, dtype=torch.int64, device=table.device)
    while True:
        rows = table[cand]
        match = rows == key[:, None]
        found = match.any(dim=1)
        free = rows == EMPTY_WORD
        first = torch.argmax(free.to(torch.int8), dim=1)
        claim = lanes & ~found & free.any(dim=1)
        if not bool(claim.any()):
            break
        who = lane_idx[claim]
        target = cand[who, first[claim]]
        winner = torch.full((C,), B, dtype=torch.int64, device=table.device)
        winner.scatter_reduce_(0, target, who, reduce="amin")
        won = winner[target] == who
        table[target[won]] = key[who[won]]
    ok = lanes & found
    at = torch.argmax(match.to(torch.int8), dim=1)
    slot = torch.where(ok, cand[lane_idx, at], C).to(torch.int32)
    n_new = (ok & ~found0).sum().to(torch.int32)
    return slot, ok, n_new


def hash_upsert(table, hi, lo, valid, *, probe_len: int):
    """G5: see hash_upsert_plain for the contract."""
    if _on_cpu(table):
        return hash_upsert_plain(table, hi, lo, valid, probe_len=probe_len)
    dev = table.device
    (C,) = table.shape
    (B,) = hi.shape
    if C & (C - 1) or C == 0:
        raise ValueError(f"table capacity must be a power of two, got {C}")
    if probe_len < 1:
        raise ValueError(f"probe_len must be >= 1, got {probe_len}")
    _check(table, "table", torch.int64, (C,), dev)
    for t, n, dt in ((hi, "hi", torch.int32), (lo, "lo", torch.int32),
                     (valid, "valid", torch.bool)):
        _check(t, n, dt, (B,), dev)
    slot = torch.empty(B, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    n_new = torch.zeros((), dtype=torch.int32, device=dev)
    rc = build().hash_upsert(_ptr(table), _ptr(hi), _ptr(lo), _ptr(valid), B,
                             C, probe_len, _ptr(slot), _ptr(ok), _ptr(n_new),
                             _stream())
    _raise_on(rc, "hash_upsert")
    hash_upsert.launches += 1
    return slot, ok, n_new


hash_upsert.launches = 0


# ------------------------------------------------------------ G6

def pack_fire_lanes(table, mask, values):
    """The pack of the reference's ``_pack_fire_lanes``: per fire lane,
    compact dense (mask bool [F, C], values float32 [F, C, *v]) planes into
    prefix rows in slot order, keys read from ``table`` (int64 [C] key
    words) and zeros past each prefix. Returns (key_hi int32 [F, C],
    key_lo int32 [F, C], values float32 [F, C, *v], counts int32 [F],
    value_sums float32 [F]: every value element of every emitted row)."""
    F, C = mask.shape
    dev = mask.device
    khi = torch.zeros(F, C, dtype=torch.int32, device=dev)
    klo = torch.zeros(F, C, dtype=torch.int32, device=dev)
    v = torch.zeros_like(values)
    for f in range(F):
        idx = torch.nonzero(mask[f]).reshape(-1)
        n = idx.shape[0]
        khi[f, :n], klo[f, :n] = split_words(table[idx])
        v[f, :n] = values[f, idx]
    counts = mask.sum(dim=1, dtype=torch.int32)
    vsums = torch.where(_expand(mask, values), values, 0.0).reshape(
        F, -1).sum(dim=1).to(torch.float32)
    return khi, klo, v, counts, vsums


def fire_compact_plain(acc, pane_ids, p_f, lane_ok, table, key_hi, key_lo,
                       values, *, C: int, R: int, k: int, op: str = "add",
                       neutral=0.0, fresh=None,
                       n_ontime=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of G6. acc float32 [C*R, W+1]; pane_ids int32 [R]; p_f
    int32 [F]; lane_ok bool [F]; table int64 [C] key words of the slots;
    ``op``, ``neutral``, ``fresh`` and ``n_ontime`` as for
    _eval_fire_lanes_plain. For each lane f the emitted slots, in slot
    order, go to the prefix ``[:counts[f]]`` of key_hi / key_lo (int32
    [F, C], the uint32 halves of the slot's key word) and values (float32
    [F, C] for a scalar, [F, C, W] for a vector), written in place; only
    the prefixes are meaningful. Returns (counts int32 [F], value_sums
    float32 [F])."""
    emit, vals = _eval_fire_lanes_plain(
        acc, pane_ids, p_f, lane_ok, C=C, R=R, k=k, op=op, neutral=neutral,
        fresh=fresh, n_ontime=n_ontime)
    khi, klo, v, counts, vsums = pack_fire_lanes(table, emit, vals)
    key_hi.copy_(khi)
    key_lo.copy_(klo)
    values.copy_(v.reshape(values.shape))
    return counts, vsums


class _LookBack:
    """G6's look-back scratch for F lanes of ``stride`` tiles on one device
    and stream: the tiles' status words and partial sums, each tagged with
    the call's epoch. Allocated once and never cleared: each call takes the
    next epoch, so a word of an earlier call reads as not yet published;
    when the 32-bit epoch wraps, the words are zeroed (0 is never an
    epoch)."""

    def __init__(self, F: int, stride: int, dev):
        self.stride = stride
        self.status = torch.zeros(F, stride, dtype=torch.int64, device=dev)
        self.sums = torch.zeros(F, stride, dtype=torch.int64, device=dev)
        self.epoch = 0

    def next_epoch(self) -> int:
        self.epoch += 1
        if self.epoch >= 1 << 32:
            self.status.zero_()
            self.sums.zero_()
            self.epoch = 1
        return self.epoch


_LOOK_BACK = {}
_look_back_lock = threading.Lock()


def _compact_scratch(F: int, C: int, dev):
    """(scratch, epoch, counts, value_sums) for one G6 call: the cached
    look-back scratch of this device, stream and shape, the call's epoch,
    and fresh outputs."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    stride = build().fire_compact_tiles(C)
    with _look_back_lock:
        key = (dev, stream, F, stride)
        lb = _LOOK_BACK.get(key)
        if lb is None:
            lb = _LOOK_BACK[key] = _LookBack(F, stride, dev)
        epoch = lb.next_epoch()
    return (lb, epoch, torch.empty(F, dtype=torch.int32, device=dev),
            torch.empty(F, dtype=torch.float32, device=dev))


def _check_rows(table, key_hi, key_lo, values, F, C, W, dev):
    _check(table, "table", torch.int64, (C,), dev)
    _check(key_hi, "key_hi", torch.int32, (F, C), dev)
    _check(key_lo, "key_lo", torch.int32, (F, C), dev)
    _check(values, "values", torch.float32,
           (F, C) if values.dim() == 2 else (F, C, W), dev)
    if values.dim() == 2 and W != 1:
        raise ValueError(f"{W} value columns into scalar rows")


def fire_compact(acc, pane_ids, p_f, lane_ok, table, key_hi, key_lo, values,
                 *, C: int, R: int, k: int, op: str = "add", neutral=0.0,
                 fresh=None,
                 n_ontime=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """G6: see fire_compact_plain for the contract."""
    if _on_cpu(acc):
        return fire_compact_plain(acc, pane_ids, p_f, lane_ok, table, key_hi,
                                  key_lo, values, C=C, R=R, k=k, op=op,
                                  neutral=neutral, fresh=fresh,
                                  n_ontime=n_ontime)
    dev = acc.device
    F, W = _check_fire(acc, pane_ids, p_f, lane_ok, fresh, n_ontime, C=C,
                       R=R, k=k)
    _check_rows(table, key_hi, key_lo, values, F, C, W, dev)
    lb, epoch, counts, vsums = _compact_scratch(F, C, dev)
    rc = build().fire_compact(
        _ptr(acc), W, OPS[op], float(neutral), _ptr(fresh),
        F if fresh is None else n_ontime, _ptr(pane_ids), _ptr(p_f),
        _ptr(lane_ok), _ptr(table), C, R, k, F, _ptr(lb.status),
        _ptr(lb.sums), lb.stride, epoch, _ptr(key_hi), _ptr(key_lo),
        _ptr(values), _ptr(counts), _ptr(vsums), _stream())
    _raise_on(rc, "fire_compact")
    fire_compact.launches += 1
    return counts, vsums


fire_compact.launches = 0


def fire_pack_plain(table, mask, values, lane_ok, out=None):
    """Plain version of G6's fire_pack: compact a dense fire result (mask
    bool [F, C], values float32 [F, C, *v]; lanes not ``lane_ok`` emit
    nothing) into ``out`` = (key_hi, key_lo, values) rows as fire_compact
    writes them, or, with ``out`` None, count it only. Returns (counts
    int32 [F], value_sums float32 [F])."""
    mask = mask & lane_ok[:, None]
    khi, klo, v, counts, vsums = pack_fire_lanes(table, mask, values)
    if out is not None:
        out[0].copy_(khi)
        out[1].copy_(klo)
        out[2].copy_(v.reshape(out[2].shape))
    return counts, vsums


def fire_pack(table, mask, values, lane_ok, out=None):
    """G6 fire_pack: see fire_pack_plain for the contract."""
    if _on_cpu(mask):
        return fire_pack_plain(table, mask, values, lane_ok, out)
    dev = mask.device
    F, C = mask.shape
    W = values[0, 0].numel() if F and C else 1
    if W > MAX_PLANE_W:
        raise NotImplementedError(f"{W} value elements a row (at most "
                                  f"{MAX_PLANE_W})")
    _check(mask, "mask", torch.bool, (F, C), dev)
    _check(values, "values", torch.float32, (F, C) + values.shape[2:], dev)
    _check(lane_ok, "lane_ok", torch.bool, (F,), dev)
    key_hi = key_lo = rows = None
    if out is not None:
        key_hi, key_lo, rows = out
        _check_rows(table, key_hi, key_lo, rows.view(F, C, W) if W > 1
                    else rows, F, C, W, dev)
    lb, epoch, counts, vsums = _compact_scratch(F, C, dev)
    rc = build().fire_pack(
        _ptr(mask), _ptr(values), W, _ptr(lane_ok), _ptr(table), C, F,
        _ptr(lb.status), _ptr(lb.sums), lb.stride, epoch, _ptr(key_hi),
        _ptr(key_lo), _ptr(rows), _ptr(counts), _ptr(vsums), _stream())
    _raise_on(rc, "fire_pack")
    fire_pack.launches += 1
    return counts, vsums


fire_pack.launches = 0

# ------------------------------------------------------------ G7

RING_CHUNK = 1024   # lanes per block of G7's and G9's ring scan (ring.cuh)


def ring_append_plain(ring, lost, mask, hi, lo, pane, values) -> None:
    """Plain version of G7, in place. ring = (ovf_hi int32 [O], ovf_lo int32
    [O], ovf_pane int32 [O], ovf_val float32 [O] or [O, W], ovf_n int32
    0-d); lost int32 0-d, gains the lanes that find the ring full; mask
    bool [B]; hi/lo int32 [B] (uint32 bits); pane int32 [B]; values float32
    [B] or [B, W] (W value columns), or None (a count: every lane
    contributes 1.0). The masked lanes go, in lane order, to positions
    ovf_n, ovf_n + 1, ...; those at O or beyond are lost; ovf_n =
    min(ovf_n + masked lanes, O)."""
    ovf_hi, ovf_lo, ovf_pane, ovf_val, ovf_n = ring
    O = ovf_hi.shape[0]
    pos = ovf_n.to(torch.int64) + torch.cumsum(mask.to(torch.int64), 0) - 1
    fits = mask & (pos < O)
    idx = pos[fits]
    ovf_hi[idx] = hi[fits]
    ovf_lo[idx] = lo[fits]
    ovf_pane[idx] = pane[fits]
    ovf_val[idx] = values[fits] if values is not None else 1.0
    n = mask.sum()
    lost.add_((n - fits.sum()).to(torch.int32))
    ovf_n.copy_(torch.clamp_max(ovf_n + n, O))


def _check_ring(ring, dev) -> Tuple[int, int]:
    """(O, W): the ring's lanes and value columns."""
    ovf_hi, ovf_lo, ovf_pane, ovf_val, ovf_n = ring
    (O,) = ovf_hi.shape
    for t, n, dt in ((ovf_hi, "ovf_hi", torch.int32),
                     (ovf_lo, "ovf_lo", torch.int32),
                     (ovf_pane, "ovf_pane", torch.int32)):
        _check(t, n, dt, (O,), dev)
    _check(ovf_val, "ovf_val", torch.float32, (O,) + ovf_val.shape[1:], dev)
    if ovf_val.dim() > 2:
        raise ValueError(f"ring values of shape {tuple(ovf_val.shape)}")
    _check(ovf_n, "ovf_n", torch.int32, (), dev)
    return O, (ovf_val.shape[1] if ovf_val.dim() == 2 else 1)


def _ring_scratch(n: int, dev):
    n_blk = max(1, -(-n // RING_CHUNK))
    return (torch.empty(n_blk, dtype=torch.int32, device=dev),
            torch.empty(n_blk, dtype=torch.int32, device=dev))


def _ring_ptrs(ring, lost):
    return [_ptr(t) for t in ring] + [_ptr(lost)]


def ring_append(ring, lost, mask, hi, lo, pane, values) -> None:
    """G7: see ring_append_plain for the contract."""
    if _on_cpu(mask):
        return ring_append_plain(ring, lost, mask, hi, lo, pane, values)
    dev = mask.device
    (B,) = mask.shape
    O, W = _check_ring(ring, dev)
    _check(lost, "lost", torch.int32, (), dev)
    for t, n, dt in ((mask, "mask", torch.bool), (hi, "hi", torch.int32),
                     (lo, "lo", torch.int32), (pane, "pane", torch.int32)):
        _check(t, n, dt, (B,), dev)
    if values is not None:
        _check(values, "values", torch.float32,
               (B,) + tuple(ring[3].shape[1:]), dev)
    if O + B > INT32_MAX:
        raise ValueError(f"ring of {O} lanes + {B} lanes overflows int32")
    blk_count, blk_off = _ring_scratch(B, dev)
    rc = build().ring_append(
        _ptr(mask), _ptr(hi), _ptr(lo), _ptr(pane), _ptr(values), W, B, O,
        *_ring_ptrs(ring, lost), _ptr(blk_count), _ptr(blk_off), _stream())
    _raise_on(rc, "ring_append")
    ring_append.launches += 1


ring_append.launches = 0


# ------------------------------------------------------------ G8

def hash_lookup_plain(table, hi, lo, valid, *, probe_len: int):
    """Plain version of G8: find a batch of keys without inserting. table
    int64 [C] key words; hi/lo int32 [B] (uint32 bits); valid bool [B].
    Returns (slot int32 [B], C where not found; found bool [B], False for
    invalid lanes and the key EMPTY_WORD; n_missing int32 0-d, the valid
    lanes not found)."""
    C = table.shape[0]
    key = key_words(hi, lo)
    cand = probe_chain(hi, lo, C=C, probe_len=probe_len)
    match = (table[cand] == key[:, None]) & (
        valid & (key != EMPTY_WORD))[:, None]
    found = match.any(dim=1)
    at = torch.argmax(match.to(torch.int8), dim=1)
    slot = torch.where(found, cand.gather(1, at[:, None])[:, 0], C)
    n_missing = (valid & ~found).sum().to(torch.int32)
    return slot.to(torch.int32), found, n_missing


def hash_lookup(table, hi, lo, valid, *, probe_len: int):
    """G8: see hash_lookup_plain for the contract."""
    if _on_cpu(table):
        return hash_lookup_plain(table, hi, lo, valid, probe_len=probe_len)
    dev = table.device
    (C,) = table.shape
    (B,) = hi.shape
    if C & (C - 1) or C == 0:
        raise ValueError(f"table capacity must be a power of two, got {C}")
    if probe_len < 1:
        raise ValueError(f"probe_len must be >= 1, got {probe_len}")
    _check(table, "table", torch.int64, (C,), dev)
    for t, n, dt in ((hi, "hi", torch.int32), (lo, "lo", torch.int32),
                     (valid, "valid", torch.bool)):
        _check(t, n, dt, (B,), dev)
    slot = torch.empty(B, dtype=torch.int32, device=dev)
    found = torch.empty(B, dtype=torch.bool, device=dev)
    n_missing = torch.zeros((), dtype=torch.int32, device=dev)
    rc = build().hash_lookup(_ptr(table), _ptr(hi), _ptr(lo), _ptr(valid), B,
                             C, probe_len, _ptr(slot), _ptr(found),
                             _ptr(n_missing), _stream())
    _raise_on(rc, "hash_lookup")
    hash_lookup.launches += 1
    return slot, found, n_missing


hash_lookup.launches = 0


# ------------------------------------------------------------ G9

def compact_alive_plain(acc, *, C: int, R: int, neutral=0.0) -> torch.Tensor:
    """bool [C]: slots with a touched cell (touch column != ``neutral``) in
    any of the R ring rows of the packed plane acc [C*R, Wc]."""
    return (acc.view(R, C, -1)[:, :, -1] != neutral).any(dim=0)


def compact_move_plain(acc, slot, ok, *, C: int, R: int,
                       neutral=0.0) -> torch.Tensor:
    """A new packed plane [C*R, Wc]: each ok slot c's R cells moved to
    slot[c], the ``neutral`` everywhere else."""
    Wc = acc.shape[1]
    out = torch.full((R, C, Wc), float(neutral), dtype=acc.dtype,
                     device=acc.device)
    out[:, slot[ok].long()] = acc.view(R, C, Wc)[:, ok]
    return out.view(C * R, Wc)


def compact_export_plain(acc, table, pane_ids, alive, ok, ring, lost, *,
                         C: int, R: int, neutral=0.0) -> None:
    """The touched cells of alive slots that are not ok, appended to the
    ring as (key, pane, W values) lanes in (row, slot) order (G7's
    contract; lost lanes count into ``lost``)."""
    Wc = acc.shape[1]
    a3 = acc.view(R, C, Wc)
    mask = ((a3[:, :, -1] != neutral) & (alive & ~ok)[None, :]).reshape(-1)
    hi, lo = split_words(table)
    vals = a3[:, :, :-1].reshape(C * R, Wc - 1)
    if ring[3].dim() == 1:
        vals = vals[:, 0]
    ring_append_plain(ring, lost, mask, hi.repeat(R), lo.repeat(R),
                      pane_ids.repeat_interleave(C), vals)


def compact_table_plain(acc, table, pane_ids, ring, lost, *, R: int,
                        probe_len: int, neutral=0.0):
    """Plain version of G9. acc float32 [C*R, Wc] packed plane (touch
    column ``neutral`` where untouched); table int64 [C] key words;
    pane_ids int32 [R]; ring the overflow ring (see ring_append_plain;
    its values [O] or [O, Wc - 1]) and lost int32 0-d, both updated in
    place. The alive slots' keys go into a fresh table (G5's contract);
    each placed key's cells move to its new slot; the touched cells of keys
    that find no slot go to the ring. Returns (new acc, new table, slot
    int32 [C], ok bool [C]): the old -> new slot map, slot C where not
    ok."""
    C = table.shape[0]
    alive = compact_alive_plain(acc, C=C, R=R, neutral=neutral)
    new_table = torch.full_like(table, EMPTY_WORD)
    hi, lo = split_words(table)
    slot, ok, _ = hash_upsert_plain(new_table, hi, lo, alive,
                                    probe_len=probe_len)
    new_acc = compact_move_plain(acc, slot, ok, C=C, R=R, neutral=neutral)
    compact_export_plain(acc, table, pane_ids, alive, ok, ring, lost, C=C,
                         R=R, neutral=neutral)
    return new_acc, new_table, slot, ok


def compact_table(acc, table, pane_ids, ring, lost, *, R: int,
                  probe_len: int, neutral=0.0):
    """G9: see compact_table_plain for the contract. The re-insert is a G5
    ``hash_upsert`` launch; a contested slot may go to another key than in
    the plain version, so the two agree as sets (see hash_upsert_plain)."""
    if _on_cpu(acc):
        return compact_table_plain(acc, table, pane_ids, ring, lost, R=R,
                                   probe_len=probe_len, neutral=neutral)
    dev = acc.device
    (C,) = table.shape
    Wc = acc.shape[1]
    _check(acc, "acc", torch.float32, (C * R, Wc), dev)
    _check(table, "table", torch.int64, (C,), dev)
    _check(pane_ids, "pane_ids", torch.int32, (R,), dev)
    O, W = _check_ring(ring, dev)
    if W != Wc - 1:
        raise ValueError(f"ring of {W} value columns, plane of {Wc - 1}")
    _check(lost, "lost", torch.int32, (), dev)
    if O + C * R > INT32_MAX:
        raise ValueError(f"ring of {O} lanes + {C * R} cells overflows int32")
    lib = build()
    alive = torch.empty(C, dtype=torch.bool, device=dev)
    nt = float(neutral)
    _raise_on(lib.compact_alive(_ptr(acc), Wc, nt, C, R, _ptr(alive),
                                _stream()), "compact_table (alive)")
    new_table = torch.full_like(table, EMPTY_WORD)
    hi, lo = split_words(table)
    slot, ok, _ = hash_upsert(new_table, hi, lo, alive, probe_len=probe_len)
    inv = torch.full((C,), -1, dtype=torch.int32, device=dev)
    new_acc = torch.empty_like(acc)
    _raise_on(lib.compact_move(_ptr(acc), Wc, nt, _ptr(slot), _ptr(ok), C, R,
                               _ptr(inv), _ptr(new_acc), _stream()),
              "compact_table (move)")
    blk_count, blk_off = _ring_scratch(C * R, dev)
    _raise_on(lib.compact_export(
        _ptr(acc), Wc, nt, _ptr(alive), _ptr(ok), _ptr(table),
        _ptr(pane_ids), C, R, O, *_ring_ptrs(ring, lost), _ptr(blk_count),
        _ptr(blk_off), _stream()), "compact_table (export)")
    compact_table.launches += 1
    return new_acc, new_table, slot, ok


compact_table.launches = 0

# ------------------------------------------------------------ G10

SORT_TILE = 2048       # lanes a tile of G10 (csrc/segment_sort.cu kTile)
SORT_BINS = 256        # G10's digit bins: status words a tile
# G10's state words (csrc/segment_sort.cu kStateWords): two histogram
# halves of 8 digits, then three lines of 32 words: the tile counters, the
# grid barrier's count and its generation
SORT_STATE_WORDS = 2 * 8 * SORT_BINS + 3 * 32
SCAN_CHUNK = 1024      # lanes per block of the segmented scan (segscan.cuh)
SCAN_PAIR_BYTES = 16   # the largest (flag, value) pair G11-G13 scan


def segment_sort_plain(key, *, bits: int, seg_shift: int):
    """Plain version of G10: a stable LSD radix sort, one bit a pass (a
    stable partition by cumsum). key int64 [B], each in [0, 2^bits).
    Returns (order int32 [B], the gather permutation; key_s int64 [B], the
    sorted keys; seg_start bool [B], lane 0 and every lane whose
    ``key_s >> seg_shift`` differs from the lane before)."""
    n = key.shape[0]
    k = key
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    for b in range(bits):
        one = ((k >> b) & 1).bool()
        zero = ~one
        pos = torch.where(zero, torch.cumsum(zero, 0) - 1,
                          zero.sum() + torch.cumsum(one, 0) - 1)
        k2, i2 = torch.empty_like(k), torch.empty_like(idx)
        k2[pos] = k
        i2[pos] = idx
        k, idx = k2, i2
    seg = k >> seg_shift
    seg_start = torch.ones(n, dtype=torch.bool, device=key.device)
    seg_start[1:] = seg[1:] != seg[:-1]
    return idx, k, seg_start


def sort_tiles(n: int) -> int:
    """G10's tiles for n lanes (at least one): the rows of each half of
    its look-back status."""
    return max(1, -(-n // SORT_TILE))


class _SortScratch:
    """G10's scratch on one device and stream, allocated zeroed: ``status``
    int32 [2, tiles, SORT_BINS], each tile's digit counts (the live passes
    take the halves in turn, each zeroing the other for the next);
    ``state`` int32 [SORT_STATE_WORDS], the histogram halves (a call adds
    into the half of its parity and zeroes the other), the tile counters
    and the grid barrier. So the launches must take the parities in turn:
    ``take(n)`` grows the status to n's tiles and gives it with the next
    parity, under the lock that also holds the launch; after a launch the
    card refused (which zeroed nothing), ``reset`` zeroes the state."""

    def __init__(self, dev):
        self.status = torch.zeros(2, 0, SORT_BINS, dtype=torch.int32,
                                  device=dev)
        self.state = torch.zeros(SORT_STATE_WORDS, dtype=torch.int32,
                                 device=dev)
        self.parity = 0

    def take(self, n: int) -> Tuple[torch.Tensor, int]:
        tiles = sort_tiles(n)
        if self.status.shape[1] < tiles:
            self.status = torch.zeros(2, tiles, SORT_BINS, dtype=torch.int32,
                                      device=self.state.device)
        parity, self.parity = self.parity, self.parity ^ 1
        return self.status, parity

    def reset(self) -> None:
        self.state.zero_()
        self.parity = 0


_SORT_SCRATCH = {}
_sort_lock = threading.Lock()


def segment_sort(key, *, bits: int, seg_shift: int):
    """G10: see segment_sort_plain for the contract. One launch a call
    (none for no lanes)."""
    if not 1 <= bits <= 63 or not 0 <= seg_shift <= 63:
        raise ValueError(f"bits {bits} / seg_shift {seg_shift} out of range")
    if _on_cpu(key):
        return segment_sort_plain(key, bits=bits, seg_shift=seg_shift)
    dev = key.device
    (n,) = key.shape
    _check(key, "key", torch.int64, (n,), dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    key_s = torch.empty(n, dtype=torch.int64, device=dev)
    seg_start = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return order, key_s, seg_start
    kalt = torch.empty_like(key_s)
    ialt = torch.empty_like(order)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _sort_lock:
        sc = _SORT_SCRATCH.get((dev, stream))
        if sc is None:
            sc = _SORT_SCRATCH[(dev, stream)] = _SortScratch(dev)
        status, parity = sc.take(n)
        rc = build().segment_sort(_ptr(key), n, bits, seg_shift, _ptr(order),
                                  _ptr(key_s), _ptr(seg_start), _ptr(kalt),
                                  _ptr(ialt), _ptr(status), status.shape[1],
                                  _ptr(sc.state), parity, _stream())
        if rc:
            sc.reset()
    _raise_on(rc, "segment_sort")
    segment_sort.launches += 1
    return order, key_s, seg_start


segment_sort.launches = 0


# -------------------------------------------- the shared scan, plain

def seg_scan_plain(flags, values, op):
    """Inclusive segmented scan of ``values`` under ``op`` with segments
    starting where ``flags`` is set (the reference's flagged operator,
    ops/segment.py segmented_reduce_sorted): Hillis-Steele, log2(B)
    rounds of whole-array ops."""
    f, v = flags, values
    n = v.shape[0]
    off = 1
    while off < n:
        nv = torch.where(_expand(f[off:], v), v[off:], op(v[:-off], v[off:]))
        f = torch.cat([f[:off], f[off:] | f[:-off]])
        v = torch.cat([v[:off], nv])
        off *= 2
    return v


def _keep_first(a, b):
    return a


def _seg_end(seg_start):
    """The last lane of each segment: the lane before a start, and the
    last lane."""
    end = torch.ones_like(seg_start)
    end[:-1] = seg_start[1:]
    return end


def _wrap32(x):
    """int64 -> int32 with the reference's int32 wrap-around."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _append_rows_plain(rows, n_rows, mask, cols) -> None:
    """The masked lanes' ``cols``, in lane order, to row positions n_rows,
    n_rows + 1, ... of ``rows`` (ring.cuh's contract, here with room for
    all of them)."""
    cap = rows[0].shape[0]
    pos = n_rows.to(torch.int64) + torch.cumsum(mask.to(torch.int64), 0) - 1
    fits = mask & (pos < cap)
    idx = pos[fits]
    for r, c in zip(rows, cols):
        r[idx] = c[fits].to(r.dtype)
    n_rows.copy_(torch.clamp_max(n_rows + mask.sum(), cap))


def _scan_scratch(n: int, dev):
    return torch.empty(max(1, -(-n // SCAN_CHUNK)) * SCAN_PAIR_BYTES,
                       dtype=torch.uint8, device=dev)


# ------------------------------------------------------------ G13

def rolling_update_plain(acc, touched, order, key_s, seg_start, values):
    """Plain version of G13. acc float32 [C] and touched bool [C], updated
    in place; order int32 [B], key_s int64 [B] (the slot, C for a lane
    with no slot) and seg_start bool [B] from G10 on the slot key; values
    float32 [B] in lane order. Returns out float32 [B] in lane order: each
    live lane's key accumulator just after the lane, 0 for a lane with no
    slot."""
    C = acc.shape[0]
    o = order.long()
    live = key_s < C
    safe = torch.where(live, key_s, 0)
    vals = torch.where(live, values[o], 0.0)
    prefix = seg_scan_plain(seg_start, vals, torch.add)
    rolled = torch.where(live & touched[safe], acc[safe] + prefix, prefix)
    out = torch.empty_like(values)
    out[o] = rolled
    rep = _seg_end(seg_start) & live
    acc[key_s[rep]] = rolled[rep]
    touched[key_s[rep]] = True
    return out


def rolling_update(acc, touched, order, key_s, seg_start, values):
    """G13: see rolling_update_plain for the contract."""
    if _on_cpu(acc):
        return rolling_update_plain(acc, touched, order, key_s, seg_start,
                                    values)
    dev = acc.device
    (C,) = acc.shape
    (B,) = order.shape
    _check(acc, "acc", torch.float32, (C,), dev)
    _check(touched, "touched", torch.bool, (C,), dev)
    for t, n, dt in ((order, "order", torch.int32),
                     (key_s, "key_s", torch.int64),
                     (seg_start, "seg_start", torch.bool),
                     (values, "values", torch.float32)):
        _check(t, n, dt, (B,), dev)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    rc = build().rolling_update(
        _ptr(key_s), _ptr(seg_start), _ptr(order), _ptr(values), B, C,
        _ptr(acc), _ptr(touched), _ptr(out), _ptr(_scan_scratch(B, dev)),
        _stream())
    _raise_on(rc, "rolling_update")
    rolling_update.launches += 1
    return out


rolling_update.launches = 0


# ------------------------------------------------------------ G12

def count_rows(cap: int, dev):
    """Fire row buffers of a count-window step: (key hi, key lo, window
    ordinal, value) [cap] each, only their ``[:n_rows]`` prefix written,
    and the row count int32 0-d, 0."""
    i32 = dict(dtype=torch.int32, device=dev)
    return ((torch.empty(cap, **i32), torch.empty(cap, **i32),
             torch.empty(cap, **i32),
             torch.empty(cap, dtype=torch.float32, device=dev)),
            torch.zeros((), **i32))


def count_update_plain(count, acc, touched, order, key_s, seg_start, hi, lo,
                       values, *, N: int):
    """Plain version of G12. count int32 [C], acc float32 [C], touched bool
    [C]: updated in place; order, key_s, seg_start from G10 on the slot key
    (C for a lane with no slot); hi, lo int32 [B] (uint32 bits) and values
    float32 [B] in lane order. Returns (rows, n_rows): the complete windows
    (key hi, key lo, window ordinal w, value) in sorted-lane order in the
    prefix ``[:n_rows]`` of B rows."""
    C = count.shape[0]
    B = order.shape[0]
    o = order.long()
    live = key_s < C
    safe = torch.where(live, key_s, 0)
    pos = seg_scan_plain(seg_start, torch.ones(B, dtype=torch.int32,
                                               device=count.device),
                         torch.add)
    old = torch.where(live, count[safe], 0)
    a = old + pos
    w = torch.div(a - 1, N, rounding_mode="floor")
    vals = torch.where(live, values[o], 0.0)
    rolled = seg_scan_plain(seg_start | ((a - 1) % N == 0), vals, torch.add)
    fold = live & (w == torch.div(old, N, rounding_mode="floor")) \
        & touched[safe] & (old % N != 0)
    rolled = torch.where(fold, acc[safe] + rolled, rolled)
    rows, n_rows = count_rows(B, count.device)
    _append_rows_plain(rows, n_rows, live & (a % N == 0),
                       (hi[o], lo[o], w, rolled))
    end = _seg_end(seg_start) & live
    s = key_s[end]
    tail = a[end] % N != 0
    count[s] = a[end].to(torch.int32)
    acc[s] = torch.where(tail, rolled[end], 0.0)
    touched[s] = tail
    return rows, n_rows


def count_update(count, acc, touched, order, key_s, seg_start, hi, lo,
                 values, *, N: int):
    """G12: see count_update_plain for the contract."""
    if N < 1:
        raise ValueError(f"count windows need N >= 1, got {N}")
    if _on_cpu(count):
        return count_update_plain(count, acc, touched, order, key_s,
                                  seg_start, hi, lo, values, N=N)
    dev = count.device
    (C,) = count.shape
    (B,) = order.shape
    _check(count, "count", torch.int32, (C,), dev)
    _check(acc, "acc", torch.float32, (C,), dev)
    _check(touched, "touched", torch.bool, (C,), dev)
    for t, n, dt in ((order, "order", torch.int32),
                     (key_s, "key_s", torch.int64),
                     (seg_start, "seg_start", torch.bool),
                     (hi, "hi", torch.int32), (lo, "lo", torch.int32),
                     (values, "values", torch.float32)):
        _check(t, n, dt, (B,), dev)
    rows, n_rows = count_rows(B, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    pos, a, w = (torch.empty(B, **i32) for _ in range(3))
    v = torch.empty(B, dtype=torch.float32, device=dev)
    fire = torch.empty(B, dtype=torch.bool, device=dev)
    blk_count, blk_off = _ring_scratch(B, dev)
    rc = build().count_update(
        _ptr(key_s), _ptr(seg_start), _ptr(order), _ptr(hi), _ptr(lo),
        _ptr(values), B, C, N, _ptr(count), _ptr(acc), _ptr(touched), B,
        *(_ptr(r) for r in rows), _ptr(n_rows), _ptr(pos), _ptr(a), _ptr(w),
        _ptr(v), _ptr(fire), _ptr(_scan_scratch(B, dev)), _ptr(blk_count),
        _ptr(blk_off), _ptr(torch.zeros((), **i32)), _stream())
    _raise_on(rc, "count_update")
    count_update.launches += 1
    return rows, n_rows


count_update.launches = 0


# ------------------------------------------------------------ G11

def session_rows(cap: int, dev):
    """Fire row buffers of a session step: (key hi, key lo, start tick,
    end tick, value) [cap] each, only their ``[:n_rows]`` prefix written,
    and the row count int32 0-d, 0."""
    i32 = dict(dtype=torch.int32, device=dev)
    return ((torch.empty(cap, **i32), torch.empty(cap, **i32),
             torch.empty(cap, **i32), torch.empty(cap, **i32),
             torch.empty(cap, dtype=torch.float32, device=dev)),
            torch.zeros((), **i32))


def session_key_ts(key_s):
    """The slot and tick of (slot << 32) | (ts ^ 0x80000000) sort keys."""
    return key_s >> 32, ((key_s & 0xFFFFFFFF) - 2**31).to(torch.int32)


def session_update_plain(start, last, acc, active, table, wm, order, key_s,
                         hi, lo, values, *, G: int, marks=None):
    """Plain version of G11. State start, last int32 [C], acc float32 [C],
    active bool [C] (updated in place) and table int64 [C] key words; wm
    int32 0-d, the watermark after the batch; order, key_s from G10 on the
    (slot, tick) key ((slot << 32) | (ts ^ 0x80000000), C << 32 for a lane
    with no slot); hi, lo int32 [B] and values float32 [B] in lane order.
    Returns (rows, n_rows): (key hi, key lo, start, end = last + G, value)
    rows in the prefix ``[:n_rows]`` of 2B + C — the superseded open
    sessions, then the superseded batch sessions (both in sorted-lane
    order), then the watermark closes in slot order. ``marks`` (int32 [2]),
    when given, gets the row count after the superseded open sessions and
    after the superseded batch sessions."""
    C = start.shape[0]
    B = order.shape[0]
    dev = start.device
    rows, n_rows = session_rows(2 * B + C, dev)
    if marks is not None:
        marks.zero_()
    if B:
        o = order.long()
        ids, ts = session_key_ts(key_s)
        live = ids < C
        slot_change = torch.ones(B, dtype=torch.bool, device=dev)
        slot_change[1:] = ids[1:] != ids[:-1]
        gap = torch.zeros(B, dtype=torch.bool, device=dev)
        gap[1:] = _wrap32(ts[1:].long() - ts[:-1].long()) > G
        flag = slot_change | gap
        agg = seg_scan_plain(flag, torch.where(live, values[o], 0.0),
                             torch.add)
        smin = seg_scan_plain(flag, ts, _keep_first)
        fos = seg_scan_plain(flag, slot_change, _keep_first)
        rep = _seg_end(flag) & live
        last_of_slot = rep & _seg_end(slot_change)
        safe = torch.where(live, ids, 0)
        o_active = active[safe] & rep & fos
        o_start, o_last, o_acc = start[safe], last[safe], acc[safe]
        merges = o_active & (smin <= _wrap32(o_last.long() + G)) \
            & (_wrap32(ts.long() + G) >= o_start)
        m_acc = torch.where(merges, o_acc + agg, agg)
        m_start = torch.where(merges, torch.minimum(o_start, smin), smin)
        m_last = torch.where(merges, torch.maximum(o_last, ts), ts)
        _append_rows_plain(rows, n_rows, o_active & ~merges,
                           (hi[o], lo[o], o_start,
                            _wrap32(o_last.long() + G), o_acc))
        if marks is not None:
            marks[0] = n_rows
        _append_rows_plain(rows, n_rows, rep & ~last_of_slot,
                           (hi[o], lo[o], m_start,
                            _wrap32(m_last.long() + G), m_acc))
        s = ids[last_of_slot]
        start[s] = m_start[last_of_slot]
        last[s] = m_last[last_of_slot]
        acc[s] = m_acc[last_of_slot]
        active[s] = True
    if marks is not None:
        marks[1] = n_rows
    close = active & (_wrap32(last.long() + G) <= wm)
    khi, klo = split_words(table)
    _append_rows_plain(rows, n_rows, close,
                       (khi, klo, start, _wrap32(last.long() + G), acc))
    acc.masked_fill_(close, 0.0)
    active.masked_fill_(close, False)
    return rows, n_rows


def session_update(start, last, acc, active, table, wm, order, key_s, hi,
                   lo, values, *, G: int, marks=None):
    """G11: see session_update_plain for the contract."""
    if G < 0:
        raise ValueError(f"session gap must be >= 0, got {G}")
    if _on_cpu(start):
        return session_update_plain(start, last, acc, active, table, wm,
                                    order, key_s, hi, lo, values, G=G,
                                    marks=marks)
    dev = start.device
    (C,) = start.shape
    (B,) = order.shape
    _check(start, "start", torch.int32, (C,), dev)
    _check(last, "last", torch.int32, (C,), dev)
    _check(acc, "acc", torch.float32, (C,), dev)
    _check(active, "active", torch.bool, (C,), dev)
    _check(table, "table", torch.int64, (C,), dev)
    _check(wm, "wm", torch.int32, (), dev)
    for t, n, dt in ((order, "order", torch.int32),
                     (key_s, "key_s", torch.int64),
                     (hi, "hi", torch.int32), (lo, "lo", torch.int32),
                     (values, "values", torch.float32)):
        _check(t, n, dt, (B,), dev)
    if marks is not None:
        _check(marks, "marks", torch.int32, (2,), dev)
    O = 2 * B + C
    if O > INT32_MAX:
        raise ValueError(f"{O} session rows overflow int32")
    rows, n_rows = session_rows(O, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    fl = torch.empty(B, dtype=torch.uint8, device=dev)
    m_start, m_last = torch.empty(B, **i32), torch.empty(B, **i32)
    m_acc = torch.empty(B, dtype=torch.float32, device=dev)
    blk_count, blk_off = _ring_scratch(max(B, C), dev)
    rc = build().session_update(
        _ptr(key_s), _ptr(order), _ptr(hi), _ptr(lo), _ptr(values), B, C, G,
        _ptr(start), _ptr(last), _ptr(acc), _ptr(active), _ptr(table),
        _ptr(wm), O, *(_ptr(r) for r in rows), _ptr(n_rows), _ptr(fl),
        _ptr(m_start), _ptr(m_last), _ptr(m_acc),
        _ptr(_scan_scratch(B, dev)), _ptr(blk_count), _ptr(blk_off),
        _ptr(torch.zeros((), **i32)), _ptr(marks), _stream())
    _raise_on(rc, "session_update")
    session_update.launches += 1
    return rows, n_rows


session_update.launches = 0

# ------------------------------------------------------------ G14

def sketch_update_plain(acc, touched, kg_dirty, dropped_capacity, pane, kg,
                        live, slot, hashes, max_pane, *, C: int, R: int,
                        sketch) -> None:
    """Plain version of G14, in place. acc int32 [C*R, W] split register
    plane, pane-major; touched bool [C*R]; kg_dirty bool [G] or None;
    dropped_capacity int32 0-d; pane/kg int32 [B]; live bool [B]; slot
    int32 [B], the lane's state slot or C for none; hashes int32 [B], the
    item hashes' uint32 bits; max_pane int32 0-d, already advanced;
    ``sketch`` an ``ops/sketches.py`` spec (``expand`` gives the register
    updates, ``op`` how they land). Too-old lanes and live lanes with no
    slot count into dropped_capacity (a sketch stage has no overflow
    ring)."""
    too_old = live & (pane < max_pane - (R - 1))
    live = live & ~too_old
    if kg_dirty is not None:
        kg_dirty[kg[live].long()] = True
    ok = live & (slot >= 0) & (slot < C)
    dropped_capacity.add_((too_old.sum() + (live & ~ok).sum()).to(
        torch.int32))
    flat = (torch.remainder(pane.to(torch.int64), R) * C
            + slot.to(torch.int64))[ok]
    touched[flat] = True
    eidx, upd, _mask = sketch.expand(flat, hashes[ok], ok[ok])
    regs = acc.view(-1)
    if sketch.op == "add":
        regs.index_add_(0, eidx, upd)
    else:
        regs.scatter_reduce_(0, eidx, upd, reduce="amax")


def _sketch_kernel_args(sketch, dev):
    """G14's (mode, depth, row width, p, seeds tensor) for a spec."""
    if sketch.op == "add":
        seeds, _qcols = sketch.device_arrays(dev)
        return 0, sketch.depth, sketch.width, 0, seeds
    if sketch.op == "max":
        return 1, 0, 0, sketch.p, None
    raise NotImplementedError(f"sketch op {sketch.op!r} has no kernel")


def sketch_update(acc, touched, kg_dirty, dropped_capacity, pane, kg, live,
                  slot, hashes, max_pane, *, C: int, R: int,
                  sketch) -> None:
    """G14: see sketch_update_plain for the contract."""
    if _on_cpu(acc):
        return sketch_update_plain(acc, touched, kg_dirty, dropped_capacity,
                                   pane, kg, live, slot, hashes, max_pane,
                                   C=C, R=R, sketch=sketch)
    dev = acc.device
    (B,) = pane.shape
    (W,) = sketch.value_shape
    if C * R * W > INT32_MAX:
        raise ValueError(f"{C * R * W} registers overflow int32 indices")
    _check(acc, "acc", torch.int32, (C * R, W), dev)
    _check(touched, "touched", torch.bool, (C * R,), dev)
    if kg_dirty is not None:
        _check(kg_dirty, "kg_dirty", torch.bool, None, dev)
    _check(dropped_capacity, "dropped_capacity", torch.int32, (), dev)
    for t, n, dt in ((pane, "pane", torch.int32), (kg, "kg", torch.int32),
                     (live, "live", torch.bool), (slot, "slot", torch.int32),
                     (hashes, "hashes", torch.int32)):
        _check(t, n, dt, (B,), dev)
    _check(max_pane, "max_pane", torch.int32, (), dev)
    mode, depth, width, p, seeds = _sketch_kernel_args(sketch, dev)
    rc = build().sketch_update(
        _ptr(acc), _ptr(touched), _ptr(kg_dirty), _ptr(dropped_capacity),
        _ptr(pane), _ptr(kg), _ptr(live), _ptr(slot), _ptr(hashes),
        _ptr(max_pane), _ptr(seeds), B, C, R, W, mode, depth, width, p,
        _stream())
    _raise_on(rc, "sketch_update")
    sketch_update.launches += 1


sketch_update.launches = 0


# ------------------------------------------------------------ G15

def _sketch_fire_lane_plain(a3, t2, pane_ids, p, ok, *, R: int, k: int,
                            red):
    """One fire lane of a sketch stage: the window ending at pane ``p`` (0-d
    int32) for every slot: (emit bool [C], finalized values [C,
    *out_shape], value-sum terms float64 [C]). Pane q counts for a slot
    where pane_ids[q mod R] == q and its touched bit is set; the present
    panes' registers combine from the neutral in pane order."""
    C, W = a3.shape[1], a3.shape[2]
    combine = red.combine_fn()
    vals = torch.zeros(C, W, dtype=a3.dtype, device=a3.device)
    emit = torch.zeros(C, dtype=torch.bool, device=a3.device)
    for j in range(k):
        q = p - (k - 1) + j
        row = torch.remainder(q, R).long()
        col_t = t2[row] & ok & (pane_ids[row] == q)
        vals = torch.where(col_t[:, None], combine(vals, a3[row]), vals)
        emit = emit | col_t
    out = vals if red.finalize is None else red.finalize(vals)
    if out.dtype == torch.float32:
        terms = out.to(torch.float64)
    else:
        terms = out.to(torch.int64).reshape(C, -1).sum(dim=1).to(
            torch.float64)
    return emit, out, terms


def sketch_fire_plain(acc, touched, pane_ids, p_f, lane_ok, table, out, *,
                      C: int, R: int, k: int, red):
    """Plain version of G15. acc int32 [C*R, W] split register plane;
    touched bool [C*R]; pane_ids int32 [R]; p_f int32 [F] window-end pane
    per lane; lane_ok bool [F]; ``red`` the stage's sketch ReduceSpec
    (combine, finalize, out_shape, out_dtype). With ``out`` = (key_hi,
    key_lo, values), int32 [F, C], int32 [F, C] and [F, C, *out_shape] of
    out_dtype, each lane's emitted slots go, in slot order, to the prefix
    ``[:counts[f]]`` (keys read from ``table``, int64 [C] key words),
    written in place; ``out`` None reduces each lane for a device-reduce
    sink. Returns (counts int32 [F], value_sums float32 [F]): the emitted
    slots and the sum of their values' elements, added in float64."""
    W = acc.shape[1]
    F = p_f.shape[0]
    a3 = acc.view(R, C, W)
    t2 = touched.view(R, C)
    counts = torch.zeros(F, dtype=torch.int32, device=acc.device)
    vsums = torch.zeros(F, dtype=torch.float32, device=acc.device)
    for f in range(F):
        emit, vals, terms = _sketch_fire_lane_plain(
            a3, t2, pane_ids, p_f[f], lane_ok[f], R=R, k=k, red=red)
        counts[f] = emit.sum()
        vsums[f] = torch.where(emit, terms, 0.0).sum().to(torch.float32)
        if out is not None:
            idx = torch.nonzero(emit).reshape(-1)
            n = idx.shape[0]
            out[0][f, :n], out[1][f, :n] = split_words(table[idx])
            out[2][f, :n] = vals[idx]
    return counts, vsums


def _fire_mode(red) -> Tuple[int, int]:
    """G15's (op, final mode) for a sketch ReduceSpec: op 0 add, 1 max;
    final 0 raw registers, 1 Count-Min query, 2 HyperLogLog estimate."""
    sk = red.sketch
    op = {"add": 0, "max": 1}[sk.op]
    if red.finalize is None:
        return op, 0
    if red.finalize != sk.finalize:
        raise NotImplementedError("G15 runs the sketches' own finalize only")
    return op, 2 if hasattr(sk, "base") else 1


SKETCH_CHUNK = 256   # slots per block of G15's count and rank passes


def sketch_fire(acc, touched, pane_ids, p_f, lane_ok, table, out, *, C: int,
                R: int, k: int, red):
    """G15: see sketch_fire_plain for the contract."""
    if _on_cpu(acc):
        return sketch_fire_plain(acc, touched, pane_ids, p_f, lane_ok, table,
                                 out, C=C, R=R, k=k, red=red)
    dev = acc.device
    (F,) = p_f.shape
    W = acc.shape[-1]
    _check(acc, "acc", torch.int32, (C * R, W), dev)
    _check(touched, "touched", torch.bool, (C * R,), dev)
    _check(pane_ids, "pane_ids", torch.int32, (R,), dev)
    _check(p_f, "p_f", torch.int32, (F,), dev)
    _check(lane_ok, "lane_ok", torch.bool, (F,), dev)
    op, final = _fire_mode(red)
    sk = red.sketch
    qcol, D, Q = None, 0, 0
    if final == 1:
        _seeds, qcol = sk.device_arrays(dev)
        D, Q = sk.qpos.shape
    base, scale, log_m, m = (
        (sk.base, sk.scale, sk.log_m, sk.m) if final == 2 else (0, 0., 0., 0))
    i32 = dict(dtype=torch.int32, device=dev)
    n_blk = -(-C // SKETCH_CHUNK)
    blk_count = torch.empty(F, n_blk, **i32)
    blk_off = torch.empty(F, n_blk, **i32)
    contrib = torch.empty(F, C, dtype=torch.float64, device=dev)
    counts = torch.empty(F, **i32)
    vsums = torch.empty(F, dtype=torch.float32, device=dev)
    pos = None
    if out is not None:
        key_hi, key_lo, values = out
        _check(table, "table", torch.int64, (C,), dev)
        _check(key_hi, "key_hi", torch.int32, (F, C), dev)
        _check(key_lo, "key_lo", torch.int32, (F, C), dev)
        _check(values, "values", red.out_dtype, (F, C) + red.out_shape, dev)
        pos = torch.empty(F, C, **i32)
    else:
        key_hi = key_lo = values = None
    rc = build().sketch_fire(
        _ptr(acc), _ptr(touched), _ptr(pane_ids), _ptr(p_f), _ptr(lane_ok),
        _ptr(table), C, R, k, F, W, op, final, _ptr(qcol), D, Q, base, scale,
        log_m, m, _ptr(blk_count), _ptr(blk_off), _ptr(pos), _ptr(contrib),
        _ptr(key_hi), _ptr(key_lo), _ptr(values), _ptr(counts), _ptr(vsums),
        _stream())
    _raise_on(rc, "sketch_fire")
    sketch_fire.launches += 1
    return counts, vsums


sketch_fire.launches = 0

# ------------------------------------------------------------ G16

class WindowLanes(NamedTuple):
    """The lane-order half of a generic window update that G16's rep_set
    does beside its set: the lanes' pane, key group, liveness and slot (C
    for none), the ring horizon (max_pane, already advanced), and the
    state it updates in place — kg_dirty (bool [G] or None), the drop
    counter, and with allowed lateness the fresh plane, fired_through and
    n_fresh (else None)."""

    pane: torch.Tensor
    kg: torch.Tensor
    live: torch.Tensor
    slot: torch.Tensor
    max_pane: torch.Tensor
    kg_dirty: Optional[torch.Tensor]
    dropped_capacity: torch.Tensor
    fresh: Optional[torch.Tensor] = None
    fired_through: Optional[torch.Tensor] = None
    n_fresh: Optional[torch.Tensor] = None


def rep_gather_plain(order, key_s, values, acc, touched, neutral):
    """Plain version of G16's rep_gather. order int32 [B] and key_s int64
    [B] from G10 (key_s the lane's row of acc, N = acc rows for a dead
    lane); values float32 [B, *v] in lane order; acc float32 [N, *v] rows
    and touched bool [N]; ``neutral`` a float or a [*v] array. Returns, in
    sorted order, (v_s [B, *v]: each lane's value, the neutral in dead
    lanes; old [B, *v]: its row of acc, the neutral in dead lanes; old_t
    bool [B]: its row's touched bit, False in dead lanes)."""
    N = acc.shape[0]
    o = order.long()
    live = key_s < N
    safe = torch.where(live, key_s, 0)
    fill = torch.as_tensor(neutral, dtype=acc.dtype, device=acc.device)
    v = values[o]
    v_s = torch.where(_expand(live, v), v, fill)
    old = torch.where(_expand(live, v), acc[safe], fill)
    return v_s, old, live & touched[safe]


def rep_gather(order, key_s, values, acc, touched, neutral):
    """G16 rep_gather: see rep_gather_plain for the contract."""
    if _on_cpu(acc):
        return rep_gather_plain(order, key_s, values, acc, touched, neutral)
    dev = acc.device
    (B,) = order.shape
    N = acc.shape[0]
    W = acc[0].numel() if N else 1
    _check(order, "order", torch.int32, (B,), dev)
    _check(key_s, "key_s", torch.int64, (B,), dev)
    _check(values, "values", torch.float32, (B,) + acc.shape[1:], dev)
    _check(acc, "acc", torch.float32, None, dev)
    _check(touched, "touched", torch.bool, (N,), dev)
    fill = _pattern(neutral, W, dev)
    if fill.numel() != W:
        fill = fill.expand(W).contiguous()
    v_s = torch.empty_like(values)
    old = torch.empty_like(values)
    old_t = torch.empty(B, dtype=torch.bool, device=dev)
    rc = build().rep_gather(
        _ptr(order), _ptr(key_s), _ptr(values), _ptr(acc), _ptr(touched),
        _ptr(fill), B, W, N, _ptr(v_s), _ptr(old), _ptr(old_t), _stream())
    _raise_on(rc, "rep_gather")
    rep_gather.launches += 1
    return v_s, old, old_t


rep_gather.launches = 0


def rep_set_plain(acc, touched, order, key_s, seg_start, merged, *,
                  out=None, lanes: Optional[WindowLanes] = None,
                  C: int = 0, R: int = 0) -> None:
    """Plain version of G16's rep_set, in place. acc float32 [N, *v] rows,
    touched bool [N]; order, key_s, seg_start from G10 (key_s N for a dead
    lane); merged float32 [B, *v] in sorted order. Each live segment's last
    lane writes its merged value to its row and sets the row's touched bit.
    ``out`` (float32 [B, *v]) receives every sorted lane's merged value at
    its lane-order position. ``lanes`` (WindowLanes, in lane order, with the
    plane's C and R) adds a window update's bookkeeping: too-old lanes and
    live lanes with no slot count into dropped_capacity, the surviving
    lanes mark kg_dirty, and with a fresh plane a placed lane whose pane is
    at or before fired_through sets its cell's flag and adds one to
    n_fresh."""
    N = acc.shape[0]
    rep = _seg_end(seg_start) & (key_s < N)
    acc[key_s[rep]] = merged[rep]
    touched[key_s[rep]] = True
    if out is not None:
        out[order.long()] = merged
    if lanes is None:
        return
    pane, kg, live, slot, max_pane, kg_dirty, dropped, fresh, fired, n_fr = \
        lanes
    too_old = live & (pane < max_pane - (R - 1))
    live = live & ~too_old
    if kg_dirty is not None:
        kg_dirty[kg[live].long()] = True
    ok = live & (slot >= 0) & (slot < C)
    dropped.add_((too_old.sum() + (live & ~ok).sum()).to(torch.int32))
    if fresh is not None:
        late = ok & (pane <= fired)
        flat = torch.remainder(pane.long(), R) * C + slot.long()
        fresh[flat[late]] = True
        n_fr.add_(late.sum().to(torch.int32))


def rep_set(acc, touched, order, key_s, seg_start, merged, *, out=None,
            lanes: Optional[WindowLanes] = None, C: int = 0,
            R: int = 0) -> None:
    """G16 rep_set: see rep_set_plain for the contract."""
    if _on_cpu(acc):
        return rep_set_plain(acc, touched, order, key_s, seg_start, merged,
                             out=out, lanes=lanes, C=C, R=R)
    dev = acc.device
    (B,) = order.shape
    N = acc.shape[0]
    W = acc[0].numel() if N else 1
    _check(acc, "acc", torch.float32, None, dev)
    _check(touched, "touched", torch.bool, (N,), dev)
    _check(order, "order", torch.int32, (B,), dev)
    _check(key_s, "key_s", torch.int64, (B,), dev)
    _check(seg_start, "seg_start", torch.bool, (B,), dev)
    _check(merged, "merged", torch.float32, (B,) + acc.shape[1:], dev)
    if out is not None:
        _check(out, "out", torch.float32, (B,) + acc.shape[1:], dev)
    ln = [None] * 10
    if lanes is not None:
        if C * R != N:
            raise ValueError(f"plane of {N} rows for C = {C}, R = {R}")
        for t, n, dt in ((lanes.pane, "pane", torch.int32),
                         (lanes.kg, "kg", torch.int32),
                         (lanes.live, "live", torch.bool),
                         (lanes.slot, "slot", torch.int32)):
            _check(t, n, dt, (B,), dev)
        _check(lanes.max_pane, "max_pane", torch.int32, (), dev)
        _check(lanes.dropped_capacity, "dropped_capacity", torch.int32, (),
               dev)
        if lanes.fresh is not None:
            _check(lanes.fresh, "fresh", torch.bool, (N,), dev)
            _check(lanes.fired_through, "fired_through", torch.int32, (),
                   dev)
            _check(lanes.n_fresh, "n_fresh", torch.int32, (), dev)
        ln = list(lanes)
    pane, kg, live, slot, max_pane, kg_dirty, dropped, fresh, fired, n_fr = ln
    rc = build().rep_set(
        _ptr(acc), _ptr(touched), W, N, _ptr(order), _ptr(key_s),
        _ptr(seg_start), _ptr(merged), B, _ptr(out), _ptr(pane), _ptr(kg),
        _ptr(live), _ptr(slot), _ptr(max_pane), C, R, _ptr(kg_dirty),
        _ptr(dropped), _ptr(fresh), _ptr(fired), _ptr(n_fr), _stream())
    _raise_on(rc, "rep_set")
    rep_set.launches += 1


rep_set.launches = 0

# ------------------------------------------------------------ G17

def kg_occupancy_plain(table_keys, *, R: int, maxp: int, acc=None,
                       neutral=0.0, touched=None, fresh=None) -> torch.Tensor:
    """Plain version of G17 (the reference's ``kg_occupancy``): int32
    [maxp], the key groups of the slots alive in any of the R pane rows —
    a packed plane ``acc`` float32 [C*R, Wc] whose touch column differs
    from ``neutral``, or split planes' ``touched`` bool [C*R], or a
    ``fresh`` bool [C*R] cell — bincounted. ``table_keys`` int64 [C]: one
    key word (hi << 32 | lo) a slot, identity rows in the direct layout."""
    C = table_keys.shape[0]
    alive = (compact_alive_plain(acc, C=C, R=R, neutral=neutral)
             if acc is not None else touched.view(R, C).any(dim=0))
    if fresh is not None:
        alive = alive | fresh.view(R, C).any(dim=0)
    hi, lo = split_words(table_keys)
    kg = assign_to_key_group(route_hash(hi, lo), maxp).to(torch.int32)
    return kg_batch_fill_plain(kg, alive, maxp)


def kg_occupancy(table_keys, *, R: int, maxp: int, acc=None, neutral=0.0,
                 touched=None, fresh=None) -> torch.Tensor:
    """G17: see kg_occupancy_plain for the contract. Exactly one of
    ``acc`` and ``touched`` is given."""
    if (acc is None) == (touched is None):
        raise ValueError("kg_occupancy reads a packed plane or a touched "
                         "plane, exactly one")
    if _on_cpu(table_keys):
        return kg_occupancy_plain(table_keys, R=R, maxp=maxp, acc=acc,
                                  neutral=neutral, touched=touched,
                                  fresh=fresh)
    dev = table_keys.device
    (C,) = table_keys.shape
    _check(table_keys, "table_keys", torch.int64, (C,), dev)
    Wc = 0
    if acc is not None:
        Wc = acc.shape[1]
        _check(acc, "acc", torch.float32, (C * R, Wc), dev)
    else:
        _check(touched, "touched", torch.bool, (C * R,), dev)
    if fresh is not None:
        _check(fresh, "fresh", torch.bool, (C * R,), dev)
    if not 0 < maxp <= 1 << 15:
        raise ValueError(f"{maxp} key groups: G17 bins up to 32,768")
    out = torch.zeros(maxp, dtype=torch.int32, device=dev)
    rc = build().kg_occupancy(_ptr(table_keys), C, R, _ptr(acc), Wc,
                              float(neutral), _ptr(touched), _ptr(fresh),
                              maxp, _ptr(out), _stream())
    _raise_on(rc, "kg_occupancy")
    kg_occupancy.launches += 1
    return out


kg_occupancy.launches = 0

# ------------------------------------------------------------ G18

# panes_advanced counts a watermark jump of at most 2^20 ticks, and 0 for
# an advance from a fresh job's MIN sentinel (below -2^30)
PANE_JUMP_CLAMP = 1 << 20
WM_FRESH = -(1 << 30)


def _panes_plain(wm_before, wm_after, slide: int):
    """Panes a watermark advance crossed, as the recorder counts them: at
    most a 2^20-tick jump, none from a fresh job's MIN sentinel (int64
    0-d)."""
    wa, wbf = wm_after.long(), wm_before.long()
    wb = torch.maximum(wbf, wa - PANE_JUMP_CLAMP)
    panes = torch.clamp_min(_floor_div(wa, slide) - _floor_div(wb, slide), 0)
    return torch.where(wbf < WM_FRESH, 0, panes)


def slot_stats_begin_plain(watermark, dropped_late, dropped_capacity,
                           snap) -> None:
    """Plain version of G18's companion: the slot's watermark, dropped_late
    and dropped_capacity (int32 0-d each) before its update, into ``snap``
    (int32 [3]), in place."""
    snap.copy_(torch.stack([watermark, dropped_late, dropped_capacity]))


def slot_stats_begin(watermark, dropped_late, dropped_capacity,
                     snap) -> None:
    """G18's companion: see slot_stats_begin_plain."""
    if _on_cpu(snap):
        return slot_stats_begin_plain(watermark, dropped_late,
                                      dropped_capacity, snap)
    dev = snap.device
    for t, n in ((watermark, "watermark"), (dropped_late, "dropped_late"),
                 (dropped_capacity, "dropped_capacity")):
        _check(t, n, torch.int32, (), dev)
    _check(snap, "snap", torch.int32, (3,), dev)
    _raise_on(build().slot_stats_begin(
        _ptr(watermark), _ptr(dropped_late), _ptr(dropped_capacity),
        _ptr(snap), _stream()), "slot_stats_begin")
    slot_stats_begin.launches += 1


slot_stats_begin.launches = 0


def slot_stats_plain(row, lane_stats, activity, lane_valid, counts,
                     dropped_late, dropped_capacity, ovf_n, fill, watermark,
                     snap, *, slide: int, defer: bool = False) -> None:
    """Plain version of G18 (the reference's ``_slot_drain_stats``): one
    live slot's ``DRAIN_STAT_FIELDS`` row into ``row`` (int32 [9]), in
    place, after the slot's update and fire. ``lane_stats`` is G1's int32
    [4] (its last entry the valid lanes), ``activity`` the update's int32
    0-d, ``lane_valid`` bool [Ft] and ``counts`` int32 [Ft] the slot's
    fires, ``dropped_late`` / ``dropped_capacity`` / ``ovf_n`` /
    ``watermark`` the state's counters after the fire, ``fill`` the slot's
    int32 [maxp] key-group fill (None: kg-fill off), ``snap`` the int32
    [3] that slot_stats_begin saved before the update. ``defer`` (the
    reference's ``defer_fires``, the chained drain's stage 0) writes 0 into
    fire_lanes and fired_keys, which ``fire_columns`` fills after the slot
    loop."""
    zero = torch.zeros((), dtype=torch.int32, device=row.device)
    row.copy_(torch.stack([
        lane_stats[3], activity.reshape(()),
        zero if defer else lane_valid.sum(dtype=torch.int32),
        zero if defer else counts.sum(dtype=torch.int32),
        dropped_late - snap[1], dropped_capacity - snap[2], ovf_n,
        fill.max() if fill is not None and fill.numel() else zero,
        _panes_plain(snap[0], watermark, slide).to(torch.int32),
    ]).to(torch.int32))


def slot_stats(row, lane_stats, activity, lane_valid, counts, dropped_late,
               dropped_capacity, ovf_n, fill, watermark, snap, *,
               slide: int, defer: bool = False) -> None:
    """G18: see slot_stats_plain for the contract."""
    if _on_cpu(row):
        return slot_stats_plain(row, lane_stats, activity, lane_valid,
                                counts, dropped_late, dropped_capacity,
                                ovf_n, fill, watermark, snap, slide=slide,
                                defer=defer)
    dev = row.device
    (Ft,) = lane_valid.shape
    _check(row, "row", torch.int32, (len(DRAIN_STAT_FIELDS),), dev)
    _check(lane_stats, "lane_stats", torch.int32, (4,), dev)
    _check(activity, "activity", torch.int32, (), dev)
    _check(lane_valid, "lane_valid", torch.bool, (Ft,), dev)
    _check(counts, "counts", torch.int32, (Ft,), dev)
    for t, n in ((dropped_late, "dropped_late"),
                 (dropped_capacity, "dropped_capacity"), (ovf_n, "ovf_n"),
                 (watermark, "watermark")):
        _check(t, n, torch.int32, (), dev)
    _check(snap, "snap", torch.int32, (3,), dev)
    maxp = 0
    if fill is not None:
        maxp = fill.shape[0]
        _check(fill, "fill", torch.int32, (maxp,), dev)
    _raise_on(build().slot_stats(
        _ptr(lane_stats), _ptr(activity), _ptr(lane_valid), _ptr(counts), Ft,
        _ptr(dropped_late), _ptr(dropped_capacity), _ptr(ovf_n), _ptr(fill),
        maxp, _ptr(watermark), _ptr(snap), slide, int(defer), _ptr(row),
        _stream()), "slot_stats")
    slot_stats.launches += 1


slot_stats.launches = 0


# ------------------------------------------------------------ G22

def fire_columns_plain(ds, lane_valid, counts) -> None:
    """Plain version of G22's ``fire_columns`` (the reference's
    ``_deferred_fire_columns``): columns 2 and 3 (fire_lanes, fired_keys)
    of a drain's int32 [D, 9] recorder stack ``ds``, in place, from its
    stacked fires' ``lane_valid`` (bool [D, F]) and ``counts`` (int32 [D,
    F]) summed per slot."""
    ds[:, 2] = lane_valid.sum(1, dtype=torch.int32)
    ds[:, 3] = counts.sum(1, dtype=torch.int32)


def fire_columns(ds, lane_valid, counts) -> None:
    """G22 ``fire_columns``: see fire_columns_plain."""
    if _on_cpu(ds):
        return fire_columns_plain(ds, lane_valid, counts)
    dev = ds.device
    D, F = lane_valid.shape
    _check(ds, "ds", torch.int32, (D, len(DRAIN_STAT_FIELDS)), dev)
    _check(lane_valid, "lane_valid", torch.bool, (D, F), dev)
    _check(counts, "counts", torch.int32, (D, F), dev)
    _raise_on(build().fire_columns(
        _ptr(ds), D, len(DRAIN_STAT_FIELDS), _ptr(lane_valid), _ptr(counts),
        F, _stream()), "fire_columns")
    fire_columns.launches += 1


fire_columns.launches = 0


def stage_record_plain(row, demand, n_lanes: int, lane_valid, dropped,
                       wm_up, wm_j, wm_before, wm_after, *,
                       slide: int) -> None:
    """Plain version of G22's ``stage_record``: one downstream stage's
    ``STAGE_STAT_FIELDS`` row for one drain (the reference's
    ``_chained_stage_tail`` record), into ``row`` (int32 [6]), in place:
    the edge's ``demand`` (int32 0-d), the lanes inserted (``min(demand,
    n_lanes)``), the stage's valid fire lanes (``lane_valid`` bool [F]),
    the edge's ``dropped`` lanes, the coupled watermark's lag behind the
    upstream one in the stage's panes (``max(wm_up - wm_j, 0) // slide``)
    and the panes the stage's advance from ``wm_before`` to ``wm_after``
    crossed, with G18's sentinel clamps."""
    lag = torch.clamp_min(wm_up.long() - wm_j.long(), 0) // slide
    row.copy_(torch.stack([
        demand.long(), torch.clamp_max(demand.long(), n_lanes),
        lane_valid.sum().long(), dropped.long(), lag,
        _panes_plain(wm_before, wm_after, slide),
    ]).to(torch.int32))


def stage_record(row, demand, n_lanes: int, lane_valid, dropped, wm_up,
                 wm_j, wm_before, wm_after, *, slide: int) -> None:
    """G22 ``stage_record``: see stage_record_plain."""
    if _on_cpu(row):
        return stage_record_plain(row, demand, n_lanes, lane_valid, dropped,
                                  wm_up, wm_j, wm_before, wm_after,
                                  slide=slide)
    dev = row.device
    (F,) = lane_valid.shape
    _check(row, "row", torch.int32, (len(STAGE_STAT_FIELDS),), dev)
    _check(lane_valid, "lane_valid", torch.bool, (F,), dev)
    for t, n in ((demand, "demand"), (dropped, "dropped"), (wm_up, "wm_up"),
                 (wm_j, "wm_j"), (wm_before, "wm_before"),
                 (wm_after, "wm_after")):
        _check(t, n, torch.int32, (), dev)
    _raise_on(build().stage_record(
        _ptr(demand), int(n_lanes), _ptr(lane_valid), F, _ptr(dropped),
        _ptr(wm_up), _ptr(wm_j), _ptr(wm_before), _ptr(wm_after), slide,
        _ptr(row), _stream()), "stage_record")
    stage_record.launches += 1


stage_record.launches = 0


# ------------------------------------------------------------ G21

CHAIN_MAX_PLANES = 1024   # fire planes (D * F) G21's one-block plan scans


class EdgeLanes(NamedTuple):
    """G21's output: the edge lanes of one chained stage (int32 key halves
    and ticks [E], values [E, *out_shape], ok bool [E]) and its int32 0-d
    scalars: the lanes dropped past E, the demand (the live rows offered),
    and the coupled watermark (None when no upstream watermark was
    given)."""

    hi: torch.Tensor
    lo: torch.Tensor
    ts: torch.Tensor
    vals: torch.Tensor
    ok: torch.Tensor
    dropped: torch.Tensor
    demand: torch.Tensor
    wm: Optional[torch.Tensor]


def _chain_shapes(key_hi, values, counts):
    """(Pn, C, the value's trailing shape) of a stack of fire planes whose
    row buffers are [..., C] and values [..., C, *out]; refuses stacks the
    plan cannot scan or whose offsets could wrap int32."""
    Pn = counts.numel()
    C = key_hi.shape[-1]
    out_shape = tuple(values.shape[counts.dim() + 1:])
    if Pn > CHAIN_MAX_PLANES:
        raise ValueError(
            f"chain_pack takes at most {CHAIN_MAX_PLANES} fire planes "
            f"(ring depth x fire lanes), got {Pn}")
    if Pn * C > INT32_MAX:
        raise ValueError(f"{Pn} fire planes of {C} rows overflow the "
                         f"edge's int32 offsets")
    return Pn, C, out_shape


def chain_watermark_plain(up_wm, fired_through, slide: int):
    """The reference's ``_chain_stage_watermark``: ``min(up_wm,
    (clip(fired_through, -1, ft_cap) + 2) * slide - 2)`` with ``ft_cap =
    (2^31 - 4) // slide - 2``, int32 0-d."""
    ft_cap = (2**31 - 4) // slide - 2
    ft = torch.clamp(fired_through.long(), -1, ft_cap)
    return torch.minimum(up_wm.long(), (ft + 2) * slide - 2).to(torch.int32)


def chain_pack_plain(key_hi, key_lo, values, counts, lane_valid, ends, *,
                     n_lanes: int, up_wm=None, fired_through=None,
                     slide: int = 0) -> EdgeLanes:
    """Plain version of G21 (the reference's ``_chain_fires_to_lanes``
    over a stack of CompactFires planes, and ``_chain_stage_watermark``
    when ``up_wm`` is given): ``key_hi`` / ``key_lo`` int32 [..., C],
    ``values`` [..., C, *out], ``counts`` int32, ``lane_valid`` bool and
    ``ends`` int32 of the stack's leading shape. Every live row of a valid
    plane (its first min(count, C) rows) becomes one of ``n_lanes`` edge
    lanes, in plane order: the row's key halves, ``ts = end - 1`` and its
    value, ok = True; lanes past the live total are zero. See EdgeLanes."""
    Pn, C, out_shape = _chain_shapes(key_hi, values, counts)
    dev = key_hi.device
    i32 = dict(dtype=torch.int32, device=dev)
    E = int(n_lanes)
    counts = counts.reshape(Pn)
    live = torch.where(lane_valid.reshape(Pn), torch.clamp_max(counts, C),
                       0).to(torch.int32)
    offs = torch.cumsum(live, 0, dtype=torch.int32)
    total = offs[-1] if Pn else torch.zeros((), **i32)
    ar = torch.arange(E, **i32)
    ok = ar < total
    hi = torch.zeros(E, **i32)
    lo = torch.zeros(E, **i32)
    ts = torch.zeros(E, **i32)
    vals = torch.zeros((E,) + out_shape, dtype=values.dtype, device=dev)
    if Pn:
        f_sel = torch.clamp(torch.searchsorted(offs, ar + 1), 0, Pn - 1)
        idx = torch.clamp(ar - (offs - live)[f_sel], 0, C - 1).long()
        f_sel = f_sel.long()
        hi = torch.where(ok, key_hi.reshape(Pn, C)[f_sel, idx], hi)
        lo = torch.where(ok, key_lo.reshape(Pn, C)[f_sel, idx], lo)
        ts = torch.where(ok, ends.reshape(Pn)[f_sel] - 1, ts)
        rows = values.reshape((Pn, C) + out_shape)[f_sel, idx]
        vals = torch.where(_expand(ok, rows), rows, vals)
    dropped = torch.clamp_min(total - E, 0).to(torch.int32)
    wm = (None if up_wm is None else
          chain_watermark_plain(up_wm, fired_through, slide))
    return EdgeLanes(hi, lo, ts, vals, ok, dropped, total.to(torch.int32),
                     wm)


def chain_pack(key_hi, key_lo, values, counts, lane_valid, ends, *,
               n_lanes: int, up_wm=None, fired_through=None,
               slide: int = 0) -> EdgeLanes:
    """G21: see chain_pack_plain. Above CHAIN_MAX_PLANES planes it raises,
    on every device."""
    if _on_cpu(key_hi):
        return chain_pack_plain(key_hi, key_lo, values, counts, lane_valid,
                                ends, n_lanes=n_lanes, up_wm=up_wm,
                                fired_through=fired_through, slide=slide)
    Pn, C, out_shape = _chain_shapes(key_hi, values, counts)
    dev = key_hi.device
    lead = tuple(counts.shape)
    _check(key_hi, "key_hi", torch.int32, lead + (C,), dev)
    _check(key_lo, "key_lo", torch.int32, lead + (C,), dev)
    if values.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"values of {values.dtype}: G21 moves 32-bit words")
    _check(values, "values", values.dtype, lead + (C,) + out_shape, dev)
    _check(counts, "counts", torch.int32, lead, dev)
    _check(lane_valid, "lane_valid", torch.bool, lead, dev)
    _check(ends, "ends", torch.int32, lead, dev)
    if up_wm is not None:
        _check(up_wm, "up_wm", torch.int32, (), dev)
        _check(fired_through, "fired_through", torch.int32, (), dev)
        if slide <= 0:
            raise ValueError(f"slide must be positive, got {slide}")
    E = int(n_lanes)
    W = 1
    for d in out_shape:
        W *= int(d)
    i32 = dict(dtype=torch.int32, device=dev)
    offs = torch.empty(max(Pn, 1), **i32)
    scalars = torch.empty(3, **i32)
    hi = torch.empty(E, **i32)
    lo = torch.empty(E, **i32)
    ts = torch.empty(E, **i32)
    vals = torch.empty((E,) + out_shape, dtype=values.dtype, device=dev)
    ok = torch.empty(E, dtype=torch.bool, device=dev)
    _raise_on(build().chain_pack(
        _ptr(key_hi), _ptr(key_lo), _ptr(values), _ptr(counts),
        _ptr(lane_valid), _ptr(ends), Pn, C, W, E, _ptr(up_wm),
        _ptr(fired_through), int(slide), _ptr(offs), _ptr(scalars), _ptr(hi),
        _ptr(lo), _ptr(ts), _ptr(vals), _ptr(ok), _stream()), "chain_pack")
    chain_pack.launches += 1
    return EdgeLanes(hi, lo, ts, vals, ok, scalars[1], scalars[0],
                     None if up_wm is None else scalars[2])


chain_pack.launches = 0


# ------------------------------------------------------------ G19, G20

CEP_TILE = 256        # lanes per tile of G19 (csrc/cep_scan.cu)
CEP_MAX_DIM = 128     # the largest state dimension D G19 and G20 take
CEP_INT_MAX = float(2**31)   # the reference's float32(2^31 - 1)


def _mask_bits(flags) -> int:
    """Host flags as one integer, bit i for flag i: G19 and G20 take it
    as two 64-bit words (at most 127 flags, since D <= CEP_MAX_DIM)."""
    return sum(1 << i for i, f in enumerate(flags) if f)


def _check_cep_dim(D: int) -> None:
    if D > CEP_MAX_DIM:
        raise ValueError(
            f"the CEP state dimension D = (S - 1) * Q + 2 = {D} exceeds "
            f"{CEP_MAX_DIM}, the largest cep_scan and cep_expire take: use "
            f"fewer stages or fewer cep.device.within-buckets")


def cep_transitions_plain(masks, live, relaxed, Q: int, q_t: int):
    """The reference's ``event_matrices`` (cep/device.py:109): per-lane
    float32 [B, D, D] transitions from the stage bits ``masks`` (bool
    [B, S]), the identity where ``live`` (bool [B]) is False. ``relaxed``
    is each stage's contiguity, ``Q`` the within() ring, ``q_t`` this
    batch's ring slot."""
    B, S = masks.shape
    D = (S - 1) * Q + 2
    dev = masks.device
    m = (masks & live[:, None]).to(torch.float32)
    T = torch.zeros(B, D, D, dtype=torch.float32, device=dev)
    T[:, D - 1, D - 1] = 1.0
    T[:, D - 2, D - 2] = 1.0
    if S == 1:
        T[:, D - 2, D - 1] += m[:, 0]
    else:
        for q in range(Q):
            T[:, D - 2, (S - 2) * Q + q] += m[:, S - 1]
            if q == q_t:
                T[:, q, D - 1] += m[:, 0]
            for s in range(S - 1):
                if relaxed[s + 1]:
                    T[:, s * Q + q, s * Q + q] += 1.0
                if s > 0:
                    T[:, s * Q + q, (s - 1) * Q + q] += m[:, s]
    eye = torch.eye(D, dtype=torch.float32, device=dev)
    return torch.where(live[:, None, None], T, eye)


def seg_matmul_scan_plain(seg_start, T):
    """The reference's ``associative_scan(_seg_matmul)`` (cep/device.py
    :156): P_i = T_i @ ... @ T_first over each segment of lanes, segments
    starting where ``seg_start`` is set; Hillis-Steele, log2(B) rounds of
    batched float32 matrix products."""
    f, P = seg_start, T
    n = P.shape[0]
    off = 1
    while off < n:
        comb = torch.bmm(P[off:], P[:-off])
        nP = torch.where(f[off:, None, None], P[off:], comb)
        f = torch.cat([f[:off], f[off:] | f[:-off]])
        P = torch.cat([P[:off], nP])
        off *= 2
    return P


def cep_scan_plain(order, key_s, seg_start, masks, carry, *, relaxed,
                   Q: int, q_t: int) -> torch.Tensor:
    """Plain version of G19, as the reference's ``advance`` computes it
    after its sort (cep/device.py:251-288): the per-lane matrices T(e),
    their segmented product P, v = min(P @ carry[key], INT_MAX), each
    lane's completed matches M_i - M_{i-1}, and the carry row of each
    segment's last lane with M = 0, then row C := the neutral vector.

    order int32 [B], key_s int64 [B] (the slot, C for a lane with no slot)
    and seg_start bool [B] from G10 on the slot key; masks bool [B, S] in
    lane order; carry float32 [C+1, D], updated in place; ``relaxed`` the
    S stages' contiguity; ``Q`` the within() ring (1 without within);
    ``q_t`` this batch's ring slot. Returns delta float32 [B] in lane
    order."""
    C = carry.shape[0] - 1
    D = carry.shape[1]
    o = order.long()
    live_s = key_s < C
    T = cep_transitions_plain(masks[o], live_s, relaxed, Q, q_t)
    P = seg_matmul_scan_plain(seg_start, T)
    v0 = carry[key_s]
    v = torch.clamp_max(torch.bmm(P, v0[:, :, None])[:, :, 0], CEP_INT_MAX)
    M = v[:, D - 2]
    M_prev = torch.cat([M.new_zeros(1), M[:-1]])
    delta_s = M - torch.where(seg_start, v0[:, D - 2], M_prev)
    is_last = _seg_end(seg_start)
    v_out = v.clone()
    v_out[:, D - 2] = 0.0
    carry[key_s[is_last]] = v_out[is_last]
    carry[C] = 0.0
    carry[C, D - 1] = 1.0
    delta = torch.empty_like(delta_s)
    delta[o] = delta_s
    return delta


def cep_scan(order, key_s, seg_start, masks, carry, *, relaxed, Q: int,
             q_t: int) -> torch.Tensor:
    """G19: see cep_scan_plain for the contract. Raises for D above
    CEP_MAX_DIM."""
    C1, D = carry.shape
    S = masks.shape[1]
    if D != (S - 1) * Q + 2 or len(relaxed) != S or not 0 <= q_t < Q:
        raise ValueError(f"carry width {D} does not fit S = {S}, Q = {Q}, "
                         f"q_t = {q_t}")
    _check_cep_dim(D)
    if _on_cpu(carry):
        return cep_scan_plain(order, key_s, seg_start, masks, carry,
                              relaxed=relaxed, Q=Q, q_t=q_t)
    dev = carry.device
    (B,) = order.shape
    _check(carry, "carry", torch.float32, (C1, D), dev)
    _check(order, "order", torch.int32, (B,), dev)
    _check(key_s, "key_s", torch.int64, (B,), dev)
    _check(seg_start, "seg_start", torch.bool, (B,), dev)
    _check(masks, "masks", torch.bool, (B, S), dev)
    n_tiles = -(-B // CEP_TILE)
    delta = torch.empty(B, dtype=torch.float32, device=dev)
    reset = torch.empty(max(1, n_tiles), dtype=torch.int32, device=dev)
    W = torch.empty(max(1, n_tiles) * D, dtype=torch.float32, device=dev)
    Sv = torch.empty_like(W)
    A = torch.empty(max(1, n_tiles) * D * D, dtype=torch.float32,
                    device=dev)
    bits = _mask_bits(relaxed)
    rc = build().cep_scan(
        _ptr(order), _ptr(key_s), _ptr(seg_start), _ptr(masks),
        bits & 0xFFFFFFFFFFFFFFFF, bits >> 64, B, C1 - 1, S, Q, D, q_t,
        _ptr(carry), _ptr(delta), _ptr(reset), _ptr(W), _ptr(Sv), _ptr(A),
        _stream())
    _raise_on(rc, "cep_scan")
    cep_scan.launches += 1
    return delta


cep_scan.launches = 0


def cep_expire_plain(carry, stale, *, S: int, Q: int) -> None:
    """Plain version of G20, the reference's within() rotation
    (cep/device.py:228-243): zero the columns s * Q + q (s < S - 1) of
    every carry row for each ring slot q with ``stale[q]``, in place."""
    col = torch.zeros(carry.shape[1], dtype=torch.bool, device=carry.device)
    st = torch.as_tensor(list(stale), dtype=torch.bool, device=carry.device)
    for s in range(S - 1):
        col[s * Q:(s + 1) * Q] = st
    carry.copy_(torch.where(col[None, :], 0.0, carry))


def cep_expire(carry, stale, *, S: int, Q: int) -> None:
    """G20: see cep_expire_plain for the contract. ``stale`` is a host
    sequence of Q flags."""
    C1, D = carry.shape
    if D != (S - 1) * Q + 2 or len(stale) != Q:
        raise ValueError(f"carry width {D} does not fit S = {S}, Q = {Q}")
    _check_cep_dim(D)
    if _on_cpu(carry):
        return cep_expire_plain(carry, stale, S=S, Q=Q)
    _check(carry, "carry", torch.float32, (C1, D), carry.device)
    bits = _mask_bits(stale)
    rc = build().cep_expire(_ptr(carry), C1, D, S, Q,
                            bits & 0xFFFFFFFFFFFFFFFF, bits >> 64, _stream())
    _raise_on(rc, "cep_expire")
    cep_expire.launches += 1


cep_expire.launches = 0

# ------------------------------------------------------------ G23

NEUTRAL = {"add": 0.0, "min": float("inf"), "max": float("-inf")}
# the most 4-byte cells, G (W + 1), that G23's shared path holds in a
# warp's copy of the target (csrc/scatter_ids.cu kSharedCells); larger
# targets take its global path
SCATTER_SHARED_CELLS = 3072


def _scatter_ids_args(idx, vals, n_groups: int, op: str):
    if op not in OPS:
        raise ValueError(f"unknown scatter op {op!r}")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64 [N], got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if vals is not None and (vals.dim() not in (1, 2)
                             or vals.shape[0] != idx.shape[0]):
        raise ValueError(f"vals of shape {tuple(vals.shape)} for "
                         f"{idx.shape[0]} ids")
    if n_groups < 0:
        raise ValueError(f"n_groups {n_groups} < 0")


def scatter_ids_plain(idx, vals, n_groups: int, *, op: str = "add",
                      counts: bool = False, has: bool = False):
    """Plain version of G23. idx int32 or int64 [N] group ids; vals float32
    [N] or [N, W], or None; ``op`` add, min or max (OPS). Returns (target,
    counts, has): target float32 [G] or [G, W] (the shape of vals past its
    first axis) starting at the neutral of ``op`` (NEUTRAL) with every
    lane's values combined into row idx[i] (jnp's NaN and signed-zero
    order for min and max), or None without vals; counts int32 [G], each
    row's lanes, when ``counts``; has bool [G], the rows some lane reached,
    when ``has``. Lanes whose id lies outside [0, G) are dropped (the
    reference's mode="drop")."""
    _scatter_ids_args(idx, vals, n_groups, op)
    dev = idx.device
    ok = (idx >= 0) & (idx < n_groups)
    i = idx[ok].long()
    target = None
    if vals is not None:
        target = torch.full((n_groups,) + tuple(vals.shape[1:]),
                            NEUTRAL[op], dtype=torch.float32, device=dev)
        v = vals[ok].to(torch.float32)
        if op == "add":
            target.index_add_(0, i, v)
        else:
            _scatter_combine_rows(target, i, v, COMBINE[op])
    cnt = (torch.bincount(i, minlength=n_groups).to(torch.int32)
           if counts else None)
    touched = None
    if has:
        touched = torch.zeros(n_groups, dtype=torch.bool, device=dev)
        touched[i] = True
    return target, cnt, touched


def scatter_ids(idx, vals, n_groups: int, *, op: str = "add",
                counts: bool = False, has: bool = False):
    """G23: see scatter_ids_plain for the contract."""
    if _on_cpu(idx):
        return scatter_ids_plain(idx, vals, n_groups, op=op, counts=counts,
                                 has=has)
    _scatter_ids_args(idx, vals, n_groups, op)
    dev = idx.device
    (N,) = idx.shape
    _check(idx, "idx", idx.dtype, (N,), dev)
    target = None
    W = 1
    if vals is not None:
        _check(vals, "vals", torch.float32, None, dev)
        W = 1 if vals.dim() == 1 else vals.shape[1]
        target = torch.full((n_groups,) + tuple(vals.shape[1:]),
                            NEUTRAL[op], dtype=torch.float32, device=dev)
    cnt = (torch.zeros(n_groups, dtype=torch.int32, device=dev)
           if counts else None)
    touched = (torch.zeros(n_groups, dtype=torch.bool, device=dev)
               if has else None)
    lib = build()
    words = lib.scatter_ids_scratch(N, _ptr(vals), W, n_groups)
    # the block paths' scratch: their blocks' partial copies
    part = (torch.empty(words, dtype=torch.float32, device=dev) if words
            else None)
    rc = lib.scatter_ids(
        _ptr(idx), idx.element_size(), N, _ptr(vals), W, n_groups, OPS[op],
        NEUTRAL[op], _ptr(target), _ptr(cnt), _ptr(touched), _ptr(part),
        _stream())
    _raise_on(rc, "scatter_ids")
    scatter_ids.launches += 1
    return target, cnt, touched


scatter_ids.launches = 0


# ------------------------------------------------------------ G24

def sorted_probe_plain(keys, tkeys, tvals):
    """Plain version of G24, one shard of the reference's broadcast join
    (parallel/broadcast.py:55-61). keys int64 [B] probe keys; tkeys int64
    [K] sorted unique build keys; tvals float32 [K]. Returns (pos int32
    [B], hit bool [B], joined float32 [B]): pos the searchsorted position
    (side left) clamped to K - 1 (0 when K is 0), hit where tkeys[pos]
    equals the key, joined tvals[pos] where hit, else 0."""
    K = tkeys.shape[0]
    if K == 0:
        z = torch.zeros(keys.shape[0], dtype=torch.int32, device=keys.device)
        return (z, torch.zeros_like(z, dtype=torch.bool),
                torch.zeros_like(z, dtype=torch.float32))
    pos = torch.clamp_max(torch.searchsorted(tkeys, keys), K - 1)
    hit = tkeys[pos] == keys
    joined = torch.where(hit, tvals[pos], torch.zeros((), dtype=tvals.dtype,
                                                      device=keys.device))
    return pos.to(torch.int32), hit, joined


def sorted_probe(keys, tkeys, tvals):
    """G24: see sorted_probe_plain for the contract."""
    if _on_cpu(keys):
        return sorted_probe_plain(keys, tkeys, tvals)
    dev = keys.device
    (B,) = keys.shape
    (K,) = tkeys.shape
    _check(keys, "keys", torch.int64, (B,), dev)
    _check(tkeys, "tkeys", torch.int64, (K,), dev)
    _check(tvals, "tvals", torch.float32, (K,), dev)
    if B > INT32_MAX or K > INT32_MAX:
        raise ValueError(f"{B} probes or {K} build keys past int32")
    pos = torch.empty(B, dtype=torch.int32, device=dev)
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    joined = torch.empty(B, dtype=torch.float32, device=dev)
    rc = build().sorted_probe(_ptr(keys), B, _ptr(tkeys), K, _ptr(tvals),
                              _ptr(pos), _ptr(hit), _ptr(joined), _stream())
    _raise_on(rc, "sorted_probe")
    sorted_probe.launches += 1
    return pos, hit, joined


sorted_probe.launches = 0


# ------------------------------------------------------------ G25

def _first_best(v, largest: bool):
    """jnp.argmin / jnp.argmax along rows of ``v`` [N, K]: the first
    column of the best value, a NaN beating every number (the first NaN
    wins). Returns (column int64 [N], value float32 [N])."""
    nan = torch.isnan(v)
    key = torch.where(nan, float("-inf") if largest else float("inf"), v)
    best = key.amax(1) if largest else key.amin(1)
    hit = (key == best[:, None]) & ~nan
    any_nan = nan.any(1)
    pick = torch.where(any_nan[:, None], nan, hit)
    col = pick.to(torch.int8).argmax(1)
    val = torch.where(any_nan, float("nan"), best)
    return col, val


def row_argmin_plain(P, xx, cc) -> torch.Tensor:
    """Plain version of G25's arg-min mode (KMeans' assignment,
    ml/pipeline.py:230-237): for each row i of P float32 [N, K] the first
    column j minimising (xx[i] - 2 P[i, j]) + cc[j], in that order of
    float32 operations, with jnp.argmin's NaN rule. Returns int64 [N]."""
    d = (xx[:, None] - 2.0 * P) + cc[None, :]
    return _first_best(d, largest=False)[0]


def row_argmin(P, xx, cc) -> torch.Tensor:
    """G25 (arg-min mode): see row_argmin_plain for the contract."""
    if _on_cpu(P):
        return row_argmin_plain(P, xx, cc)
    dev = P.device
    N, K = P.shape
    _check(P, "P", torch.float32, (N, K), dev)
    _check(xx, "xx", torch.float32, (N,), dev)
    _check(cc, "cc", torch.float32, (K,), dev)
    if K == 0:
        raise ValueError("arg-min of rows with no column")
    out = torch.empty(N, dtype=torch.int64, device=dev)
    rc = build().row_argmin(_ptr(P), N, K, _ptr(xx), _ptr(cc), _ptr(out),
                            _stream())
    _raise_on(rc, "row_argmin")
    row_argmin.launches += 1
    return out


row_argmin.launches = 0


def row_argmax_plain(m, labels, scores, delta: float):
    """Plain version of G25's arg-max mode (community detection's
    superstep, gelly/graph.py:293-300). m float32 [N, K] the score mass
    per (vertex, label); labels / scores float32 [N]. best = the first
    column of each row's max (jnp.argmax's NaN rule), best_mass = the max;
    where best_mass > 0 the vertex adopts best as its label and
    max(best_mass * delta, 1e-6) as its score, else keeps both. Returns
    (new_labels, new_scores), float32 [N] each."""
    best, mass = _first_best(m, largest=True)
    has = mass > 0
    d = torch.tensor(delta, dtype=torch.float32, device=m.device)
    return (torch.where(has, best.to(torch.float32), labels),
            torch.where(has, fmax(mass * d, torch.full_like(mass, 1e-6)),
                        scores))


def row_argmax(m, labels, scores, delta: float):
    """G25 (arg-max mode): see row_argmax_plain for the contract."""
    if _on_cpu(m):
        return row_argmax_plain(m, labels, scores, delta)
    dev = m.device
    N, K = m.shape
    _check(m, "m", torch.float32, (N, K), dev)
    _check(labels, "labels", torch.float32, (N,), dev)
    _check(scores, "scores", torch.float32, (N,), dev)
    if K == 0:
        raise ValueError("arg-max of rows with no column")
    new_labels = torch.empty(N, dtype=torch.float32, device=dev)
    new_scores = torch.empty(N, dtype=torch.float32, device=dev)
    rc = build().row_argmax(_ptr(m), N, K, _ptr(labels), _ptr(scores),
                            float(delta), _ptr(new_labels), _ptr(new_scores),
                            _stream())
    _raise_on(rc, "row_argmax")
    row_argmax.launches += 1
    return new_labels, new_scores


row_argmax.launches = 0

# ------------------------------------------------------------ G26

EXCHANGE_LANES = 1024        # lanes (and threads) a block of G26
EXCHANGE_MAX_SHARDS = 256    # targets G26's shared counts hold


class PackedLanes(NamedTuple):
    """One source shard's send buffers (G26): ``[n * cap]`` lanes, bucket
    t at ``[t * cap, (t + 1) * cap)``, every lane past a bucket's fill
    zero; ``overflow`` int32 [1], the valid lanes that found no room."""
    hi: torch.Tensor
    lo: torch.Tensor
    ts: torch.Tensor
    values: torch.Tensor
    valid: torch.Tensor
    overflow: torch.Tensor


def exchange_targets(hi, lo, n: int, maxp: int) -> torch.Tensor:
    """Each lane's owning shard, ``kg * n // maxp`` (int64 [B])."""
    kg = assign_to_key_group(route_hash(hi, lo), maxp)
    return kg * n // maxp


def exchange_pack_plain(hi, lo, ts, values, valid, *, n: int, maxp: int,
                        cap: int) -> PackedLanes:
    """Plain version of G26 (the reference's exchange_records up to its
    all_to_all): hi / lo int32 [B] holding uint32 bits, ts int32 [B],
    values [B, *tail] of a 32-bit dtype, valid bool [B]. Each valid lane's
    rank among the valid lanes of its target (stable), the lanes with rank
    < cap written to ``[target * cap + rank]`` of zero-filled buffers."""
    B = hi.shape[0]
    dev = hi.device
    tgt = exchange_targets(hi, lo, n, maxp)
    pos = torch.zeros(B, dtype=torch.int64, device=dev)
    for t in range(n):
        m = valid & (tgt == t)
        pos = torch.where(m, torch.cumsum(m.to(torch.int64), 0) - 1, pos)
    fits = valid & (pos < cap)
    idx = torch.where(fits, tgt * cap + pos, n * cap)

    def scatter(col):
        buf = torch.zeros((n * cap + 1,) + tuple(col.shape[1:]),
                          dtype=col.dtype, device=dev)
        buf[idx] = col
        return buf[:n * cap]

    return PackedLanes(scatter(hi), scatter(lo), scatter(ts),
                       scatter(values), scatter(fits),
                       (valid & ~fits).sum(dtype=torch.int32).reshape(1))


def exchange_pack(hi, lo, ts, values, valid, *, n: int, maxp: int,
                  cap: int) -> PackedLanes:
    """G26: see exchange_pack_plain for the contract."""
    if _on_cpu(hi):
        return exchange_pack_plain(hi, lo, ts, values, valid, n=n,
                                   maxp=maxp, cap=cap)
    dev = hi.device
    (B,) = hi.shape
    for t, name, dt in ((hi, "hi", torch.int32), (lo, "lo", torch.int32),
                        (ts, "ts", torch.int32),
                        (valid, "valid", torch.bool)):
        _check(t, name, dt, (B,), dev)
    if values.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"values has dtype {values.dtype}, expected a "
                        f"32-bit float or int")
    _check(values, "values", values.dtype, None, dev)
    if values.shape[0] != B:
        raise ValueError(f"values has {values.shape[0]} lanes, expected {B}")
    if not 1 <= n <= EXCHANGE_MAX_SHARDS or n > maxp or cap < 1:
        raise ValueError(f"exchange over {n} shards of {maxp} key groups "
                         f"with bucket capacity {cap}")
    tail = tuple(values.shape[1:])
    W = 1
    for d in tail:
        W *= d
    i32 = dict(dtype=torch.int32, device=dev)
    blocks = max(1, -(-B // EXCHANGE_LANES))
    counts = torch.empty(blocks * n, **i32)
    out = PackedLanes(torch.empty(n * cap, **i32), torch.empty(n * cap, **i32),
                      torch.empty(n * cap, **i32),
                      torch.empty((n * cap,) + tail, dtype=values.dtype,
                                  device=dev),
                      torch.empty(n * cap, dtype=torch.bool, device=dev),
                      torch.empty(1, **i32))
    rc = build().exchange_pack(
        _ptr(hi), _ptr(lo), _ptr(ts), _ptr(values), _ptr(valid), B, W, n,
        maxp, cap, _ptr(counts), _ptr(out.hi), _ptr(out.lo), _ptr(out.ts),
        _ptr(out.values), _ptr(out.valid), _ptr(out.overflow), _stream())
    _raise_on(rc, "exchange_pack")
    exchange_pack.launches += 1
    return out


exchange_pack.launches = 0


# ------------------------------------------------------------ G27

SHARD_SUM_MAX_SHARDS = 64    # shard pointers G27's launch parameters hold


def shard_sum_plain(outs, valids):
    """Plain version of G27: ``outs`` n float32 [B, *tail] tensors and
    ``valids`` n bool [B] on one device. Returns (sum over shards in index
    order of where(valid_s, out_s, 0), OR over shards of valid_s)."""
    acc = ok = None
    for o, v in zip(outs, valids):
        x = torch.where(_expand(v, o), o, torch.zeros((), dtype=o.dtype))
        acc = x if acc is None else acc + x
        ok = v if ok is None else ok | v
    return acc, ok


def shard_sum(outs, valids):
    """G27: see shard_sum_plain for the contract."""
    if _on_cpu(outs[0]):
        return shard_sum_plain(outs, valids)
    n = len(outs)
    if not 1 <= n <= SHARD_SUM_MAX_SHARDS or len(valids) != n:
        raise ValueError(f"a shard sum over {n} outputs and {len(valids)} "
                         f"valid masks")
    dev = outs[0].device
    shape = tuple(outs[0].shape)
    B = shape[0]
    for o, v in zip(outs, valids):
        _check(o, "out", torch.float32, shape, dev)
        _check(v, "valid", torch.bool, (B,), dev)
    W = 1
    for d in shape[1:]:
        W *= d
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    ptrs = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs))
    vptrs = (ctypes.c_void_p * n)(*(v.data_ptr() for v in valids))
    rc = build().shard_sum(ctypes.cast(ptrs, _P), ctypes.cast(vptrs, _P), n,
                           B, W, _ptr(out), _ptr(ok), _stream())
    _raise_on(rc, "shard_sum")
    shard_sum.launches += 1
    return out, ok


shard_sum.launches = 0

# ------------------------------------------------------------ G28

def remove_slots_plain(table, slots, mask) -> torch.Tensor:
    """Plain version of G28: mark table slots empty, in place. table int64
    [C] key words; slots int32 or int64 [B]; mask bool [B]. Each lane with
    ``mask`` sets its slot's word to EMPTY_WORD. A slot in [-C, 0) counts
    from the end (the reference's ``.at[]`` wraps a negative index before
    its mode="drop" scatter); other slots outside [0, C) and masked-off
    lanes are dropped. Returns the table."""
    C = table.shape[0]
    s = slots.long()
    s = torch.where(s < 0, s + C, s)
    table[s[mask & (s >= 0) & (s < C)]] = EMPTY_WORD
    return table


def remove_slots(table, slots, mask) -> torch.Tensor:
    """G28: see remove_slots_plain for the contract."""
    if _on_cpu(table):
        return remove_slots_plain(table, slots, mask)
    dev = table.device
    (C,) = table.shape
    (B,) = slots.shape
    if slots.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"slots must be int32 or int64, got {slots.dtype}")
    _check(table, "table", torch.int64, (C,), dev)
    _check(slots, "slots", slots.dtype, (B,), dev)
    _check(mask, "mask", torch.bool, (B,), dev)
    rc = build().remove_slots(_ptr(table), C, _ptr(slots),
                              slots.element_size(), _ptr(mask), B, _stream())
    _raise_on(rc, "remove_slots")
    remove_slots.launches += 1
    return table


remove_slots.launches = 0

KERNELS = (route_lanes, clear_rows, fresh_rows, scatter_update,
           fire_reduced, hash_upsert, fire_compact, fire_pack, ring_append,
           hash_lookup, compact_table, segment_sort, session_update,
           count_update, rolling_update, sketch_update, sketch_fire,
           rep_gather, rep_set, kg_occupancy, slot_stats_begin, slot_stats,
           cep_scan, cep_expire, chain_pack, fire_columns, stage_record,
           scatter_ids, sorted_probe, row_argmin, row_argmax,
           exchange_pack, shard_sum, remove_slots)


# wrappers whose kernel lives in another wrapper's source
_SHARED_SOURCE = {"fresh_rows": "clear_rows.cu",
                  "fire_pack": "fire_compact.cu",
                  "rep_gather": "rep_update.cu", "rep_set": "rep_update.cu",
                  "slot_stats_begin": "slot_stats.cu",
                  "fire_columns": "slot_stats.cu",
                  "stage_record": "slot_stats.cu",
                  "cep_expire": "cep_scan.cu",
                  "row_argmin": "row_argbest.cu",
                  "row_argmax": "row_argbest.cu"}


def source_of(fn) -> str:
    """The file under csrc/ that holds a wrapper's kernel."""
    return _SHARED_SOURCE.get(fn.__name__, f"{fn.__name__}.cu")


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    route_lanes.fill_launches = 0
    route_lanes.res_launches = 0
