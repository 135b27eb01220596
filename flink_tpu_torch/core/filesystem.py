"""FileSystem abstraction — a copy of flink_tpu/core/filesystem.py (the
flink-core FileSystem SPI, SURVEY §2.1,
ref org.apache.flink.core.fs.FileSystem: scheme-dispatched get(), local +
pluggable remote implementations).

Paths carry a scheme (``file:///tmp/x``, ``mem://bucket/x``; bare paths
default to ``file``). `get_filesystem(path)` dispatches on the scheme;
implementations cover the operations the framework's file connectors and
storage need. A process-local in-memory filesystem ships for tests and
as the template for remote implementations (the image has no HDFS/S3
client — the SPI is the extension seam, like the reference's
HadoopFileSystem wrapper).
"""

from __future__ import annotations

import io
import os
import threading
from typing import Dict, List, Tuple

from flink_tpu_torch.testing import faults


def split_scheme(path: str) -> Tuple[str, str]:
    if "://" in path:
        scheme, rest = path.split("://", 1)
        return scheme, rest
    return "file", path


class FileSystem:
    """SPI: the operation set the framework's connectors/storage use."""

    def open(self, path: str, mode: str = "rb", newline=None):
        """newline follows builtins.open semantics (pass "" for csv);
        in-memory implementations that do no newline translation may
        ignore it."""
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def list_dir(self, path: str) -> List[str]:
        raise NotImplementedError

    def mkdirs(self, path: str):
        raise NotImplementedError

    def delete(self, path: str, recursive: bool = False):
        raise NotImplementedError

    def rename(self, src: str, dst: str):
        raise NotImplementedError

    def size(self, path: str) -> int:
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    def open(self, path: str, mode: str = "rb", newline=None):
        if "w" in mode or "a" in mode:
            # chaos seam: transient filesystem write failures inject at
            # the SPI boundary every connector/storage write crosses
            faults.inject("fs.open", path=path, mode=mode)
        if "b" in mode:
            return open(path, mode)
        return open(path, mode, newline=newline)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def list_dir(self, path: str) -> List[str]:
        return sorted(os.listdir(path))

    def mkdirs(self, path: str):
        os.makedirs(path, exist_ok=True)

    def delete(self, path: str, recursive: bool = False):
        if os.path.isdir(path):
            if recursive:
                import shutil

                shutil.rmtree(path)
            else:
                os.rmdir(path)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src: str, dst: str):
        os.replace(src, dst)

    def size(self, path: str) -> int:
        return os.path.getsize(path)


class MemoryFileSystem(FileSystem):
    """Process-local FS (the reference's testing filesystems' role, and
    the remote-implementation template: every op goes through the same
    SPI a real object store would)."""

    def __init__(self):
        self._files: Dict[str, bytes] = {}
        self._dirs = {""}
        self._lock = threading.Lock()

    class _Writer(io.BytesIO):
        def __init__(self, fs, path, text):
            super().__init__()
            self._fs, self._path, self._text = fs, path, text

        def write(self, data):  # type: ignore[override]
            if self._text and isinstance(data, str):
                data = data.encode()
            return super().write(data)

        def close(self):
            if self.closed:        # IOBase contract: close() repeatable
                return
            with self._fs._lock:
                self._fs._files[self._path] = self.getvalue()
            super().close()

    def open(self, path: str, mode: str = "rb", newline=None):
        # StringIO below performs no newline translation, so the csv
        # module's newline="" requirement is inherently satisfied
        text = "b" not in mode
        if "w" in mode or "a" in mode:
            faults.inject("fs.open", path=path, mode=mode)
            w = MemoryFileSystem._Writer(self, path, text)
            if "a" in mode:
                with self._lock:
                    existing = self._files.get(path)
                if existing is not None:
                    io.BytesIO.write(w, existing)
            return w
        with self._lock:
            if path not in self._files:
                raise FileNotFoundError(path)
            data = self._files[path]
        if text:
            return io.StringIO(data.decode(), newline=newline)
        return io.BytesIO(data)

    def exists(self, path: str) -> bool:
        with self._lock:
            return (
                path in self._files
                or path in self._dirs
                or any(f.startswith(path.rstrip("/") + "/")
                       for f in self._files)
            )

    def list_dir(self, path: str) -> List[str]:
        prefix = path.rstrip("/") + "/" if path else ""
        out = set()
        with self._lock:
            for f in self._files:
                if f.startswith(prefix):
                    out.add(f[len(prefix):].split("/")[0])
        return sorted(out)

    def mkdirs(self, path: str):
        with self._lock:
            parts = path.rstrip("/").split("/")
            for i in range(1, len(parts) + 1):   # parents too (os.makedirs)
                self._dirs.add("/".join(parts[:i]))

    def delete(self, path: str, recursive: bool = False):
        with self._lock:
            prefix = path.rstrip("/") + "/"
            children = [f for f in self._files if f.startswith(prefix)]
            if children and not recursive:
                # match LocalFileSystem: os.rmdir refuses non-empty dirs
                raise OSError(f"directory not empty: {path!r}")
            self._files.pop(path, None)
            self._dirs.discard(path.rstrip("/"))
            if recursive:
                for f in children:
                    del self._files[f]

    def rename(self, src: str, dst: str):
        with self._lock:
            if src in self._files:
                self._files[dst] = self._files.pop(src)
                return
            # directory rename: move every child under the prefix
            prefix = src.rstrip("/") + "/"
            children = [f for f in self._files if f.startswith(prefix)]
            if not children and src.rstrip("/") not in self._dirs:
                raise FileNotFoundError(src)   # match os.replace
            for f in children:
                self._files[dst.rstrip("/") + "/" + f[len(prefix):]] =                     self._files.pop(f)
            self._dirs.discard(src.rstrip("/"))
            self._dirs.add(dst.rstrip("/"))

    def size(self, path: str) -> int:
        with self._lock:
            return len(self._files[path])


_REGISTRY: Dict[str, FileSystem] = {
    "file": LocalFileSystem(),
    "mem": MemoryFileSystem(),
}


def register_filesystem(scheme: str, fs: FileSystem):
    """ref FileSystem factory registration (pluggable schemes)."""
    _REGISTRY[scheme] = fs


def get_filesystem(path: str) -> Tuple[FileSystem, str]:
    """path -> (filesystem, scheme-stripped path)."""
    scheme, rest = split_scheme(path)
    try:
        return _REGISTRY[scheme], rest
    except KeyError:
        raise ValueError(
            f"no filesystem registered for scheme {scheme!r} "
            f"(have: {sorted(_REGISTRY)})"
        ) from None
