"""The host spill store, bound via ctypes (a copy of flink_tpu's
``native.SpillStore`` and ``native/src/spillstore.cpp``; the ring buffer,
the record codec and the text parser of that package are not carried).

``spillstore.cpp`` is host C++, not a kernel: ``g++ -O2 -shared -fPIC``
compiles it on first use into ``flink_tpu_torch/_build/``, keyed by a hash
of the source and flags, so the tests on the CPU and the card's runs use
the same store.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "spillstore.cpp"
BUILD_DIR = SRC.parent.parent / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_U64 = ctypes.c_uint64
_VP = ctypes.c_void_p
_SIGNATURES = {
    "spill_create": ([_U64, _U64], _VP),
    "spill_destroy": ([_VP], None),
    "spill_count": ([_VP], _U64),
    "spill_width": ([_VP], _U64),
    "spill_put_batch": ([_VP, _VP, _VP, _U64], None),
    "spill_get_batch": ([_VP, _VP, _VP, _VP, _U64], None),
    "spill_delete_batch": ([_VP, _VP, _U64], _U64),
    "spill_dump": ([_VP, _VP, _VP, _U64], _U64),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libspillstore_{h.hexdigest()[:16]}.so"


def get_lib() -> ctypes.CDLL:
    """Compile (if needed) and load the store's shared library."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                    out = os.path.join(tmp, path.name)
                    run = subprocess.run(
                        ["g++", *GXX_FLAGS, "-o", out, str(SRC)],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                    if run.returncode:
                        raise RuntimeError(
                            "g++ failed on spillstore.cpp:\n"
                            + run.stdout.decode(errors="replace"))
                    os.replace(out, path)
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class SpillStore:
    """Host overflow tier for keyed state: batch put/get/delete of
    (u64 key -> float32[width] block)."""

    def __init__(self, width: int = 1, initial_capacity: int = 1024):
        self._lib = get_lib()
        self._h = self._lib.spill_create(initial_capacity, width)
        self.width = int(self._lib.spill_width(self._h))

    def close(self):
        if self._h:
            self._lib.spill_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        return int(self._lib.spill_count(self._h))

    def put(self, keys, values):
        keys = np.ascontiguousarray(keys, np.uint64)
        values = np.ascontiguousarray(values, np.float32).reshape(
            len(keys), self.width)
        self._lib.spill_put_batch(self._h, _p(keys), _p(values), len(keys))

    def get(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        keys = np.ascontiguousarray(keys, np.uint64)
        n = len(keys)
        vals = np.empty((n, self.width), np.float32)
        found = np.empty(n, np.uint8)
        self._lib.spill_get_batch(self._h, _p(keys), _p(vals), _p(found), n)
        return vals, found.astype(bool)

    def delete(self, keys) -> int:
        keys = np.ascontiguousarray(keys, np.uint64)
        return int(self._lib.spill_delete_batch(self._h, _p(keys), len(keys)))

    def dump(self) -> Tuple[np.ndarray, np.ndarray]:
        n = len(self)
        keys = np.empty(n, np.uint64)
        vals = np.empty((n, self.width), np.float32)
        got = self._lib.spill_dump(self._h, _p(keys), _p(vals), n)
        return keys[:got], vals[:got]
