"""The job-builder seam of flink_tpu/runtime/worker.py: ``load_builder``
resolves the ``--builder`` reference of a worker process (the port's DCN
worker, ``python -m flink_tpu_torch.runtime.dcn``). The worker protocol
around it (registration, heartbeats, the controller) is ROADMAP queue 1,
item 15.
"""

from __future__ import annotations

import importlib
import importlib.util
import os


def load_builder(ref: str):
    """Resolve "module:function" or "/path/file.py:function"."""
    modpart, _, fnname = ref.rpartition(":")
    if not modpart:
        raise ValueError(f"builder ref {ref!r} must be 'module:function'")
    if modpart.endswith(".py") or os.path.sep in modpart:
        spec = importlib.util.spec_from_file_location("_job_builder", modpart)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(modpart)
    return getattr(mod, fnname)
