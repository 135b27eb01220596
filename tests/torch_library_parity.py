"""Run the reference's batch-library test cases and example programs
against flink_tpu_torch on the CPU.

A reference test file (``tests/test_table.py`` and the rest) imports its
API from ``flink_tpu.*``. ``run_reference_case`` executes the file's own
source with those module names bound, in ``sys.modules``, to the port's
modules (``PORT_OF``), so every import in it — at the top or inside a
test — reaches ``flink_tpu_torch``, and then calls one of its tests: the
reference's assertions, unchanged, hold the port's results. The port's
entry points default to the CUDA card; the bound modules give each entry
point that takes a ``device`` the default ``"cpu"`` instead, and nothing
else changes.

``reference_cases`` lists a file's tests (one per parameter set of a
parametrized test) for ``pytest.mark.parametrize``; it reads the
reference module, which imports JAX on the CPU like the rest of the
suite, and decides nothing about the machine.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: caps torch's threads)

import contextlib
import importlib
import inspect
import io
import itertools
import sys
import types
from pathlib import Path
from typing import Dict, List, Tuple

import pytest

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

# reference module -> port module
PORT_OF = {
    "flink_tpu": "flink_tpu_torch",
    "flink_tpu.core.config": "flink_tpu_torch.core.config",
    "flink_tpu.core.time": "flink_tpu_torch.core.time",
    "flink_tpu.runtime.sources": "flink_tpu_torch.runtime.sources",
    "flink_tpu.table": "flink_tpu_torch.table",
    "flink_tpu.table.table": "flink_tpu_torch.table.table",
    "flink_tpu.table.planner": "flink_tpu_torch.table.planner",
    "flink_tpu.table.streaming": "flink_tpu_torch.table.streaming",
    "flink_tpu.dataset": "flink_tpu_torch.dataset",
    "flink_tpu.gelly": "flink_tpu_torch.gelly",
    "flink_tpu.gelly.graph": "flink_tpu_torch.gelly.graph",
    "flink_tpu.ml": "flink_tpu_torch.ml",
    "flink_tpu.ml.metrics": "flink_tpu_torch.ml.metrics",
    "flink_tpu.ml.optimization": "flink_tpu_torch.ml.optimization",
    "flink_tpu.ml.utils": "flink_tpu_torch.ml.utils",
    # the window runtime's modules that the reference's mesh test files
    # import (tests/test_data_parallel.py, tests/test_exchange.py)
    "flink_tpu.core": "flink_tpu_torch.core",
    "flink_tpu.core.keygroups": "flink_tpu_torch.core.keygroups",
    "flink_tpu.ops": "flink_tpu_torch.ops",
    "flink_tpu.ops.window_kernels": "flink_tpu_torch.ops.window_kernels",
    "flink_tpu.ops.hashing": "flink_tpu_torch.ops.hashing",
    "flink_tpu.parallel": "flink_tpu_torch.parallel",
    "flink_tpu.parallel.mesh": "flink_tpu_torch.parallel.mesh",
    "flink_tpu.runtime": "flink_tpu_torch.runtime",
    "flink_tpu.runtime.checkpoint": "flink_tpu_torch.runtime.checkpoint",
    "flink_tpu.runtime.ingest": "flink_tpu_torch.runtime.ingest",
    "flink_tpu.runtime.sinks": "flink_tpu_torch.runtime.sinks",
    "flink_tpu.runtime.step": "flink_tpu_torch.runtime.step",
    # the keyed runners', CEP's and the stage graph's test files
    # (tests/test_session_windows.py, test_cep_accel.py, test_stages.py)
    "flink_tpu.cep": "flink_tpu_torch.cep",
    "flink_tpu.cep.accel": "flink_tpu_torch.cep.accel",
    "flink_tpu.datastream": "flink_tpu_torch.datastream",
    "flink_tpu.datastream.window": "flink_tpu_torch.datastream.window",
    "flink_tpu.datastream.window.assigners":
        "flink_tpu_torch.datastream.window.assigners",
    "flink_tpu.runtime.stages": "flink_tpu_torch.runtime.stages",
    "flink_tpu.runtime.watermarks": "flink_tpu_torch.runtime.watermarks",
    "flink_tpu.testing": "flink_tpu_torch.testing",
    "flink_tpu.testing.faults": "flink_tpu_torch.testing.faults",
}

# the static factories of the entry classes
_FACTORIES = ("create", "get_execution_environment", "from_edge_list")


def _takes_device(fn) -> bool:
    try:
        return "device" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _on_cpu(fn):
    def call(*args, **kwargs):
        kwargs.setdefault("device", "cpu")
        return fn(*args, **kwargs)

    call.__name__ = fn.__name__
    call.__doc__ = fn.__doc__
    return call


def _cpu_default(obj):
    """``obj`` with ``device="cpu"`` as the default wherever it takes a
    device: a function, a class's constructor or its static factories."""
    if inspect.isclass(obj):
        attrs = {}
        if _takes_device(obj.__init__):
            attrs["__init__"] = _on_cpu(obj.__init__)
        for name in _FACTORIES:
            f = obj.__dict__.get(name)
            if isinstance(f, staticmethod) and _takes_device(f.__func__):
                attrs[name] = staticmethod(_on_cpu(f.__func__))
        return type(obj.__name__, (obj,), attrs) if attrs else obj
    if inspect.isfunction(obj) and _takes_device(obj):
        return _on_cpu(obj)
    return obj


def port_modules() -> Dict[str, types.ModuleType]:
    """Each reference module name of PORT_OF -> a module holding the port
    module's names, its entry points defaulting to the CPU."""
    out = {}
    for ref, port in PORT_OF.items():
        mod = importlib.import_module(port)
        shim = types.ModuleType(ref, mod.__doc__)
        for name, value in vars(mod).items():
            if not name.startswith("__"):
                setattr(shim, name, _cpu_default(value))
        shim.__path__ = []          # a package, for submodule imports
        out[ref] = shim
    # a package's submodule attributes point at the submodules' shims
    for ref, shim in out.items():
        for name, value in vars(shim).items():
            if isinstance(value, types.ModuleType) and \
                    f"{ref}.{name}" in out:
                setattr(shim, name, out[f"{ref}.{name}"])
    return out


@contextlib.contextmanager
def bound_to_port(monkeypatch, keep=()):
    """Bind the reference's module names to the port's for the block;
    the modules named in ``keep`` (and their packages) stay the
    reference's own — a test file may import a helper the port has no
    counterpart of (the fault injector's device-loss rule) for a case
    that never calls it."""
    kept = {}
    for name in keep:
        mod = importlib.import_module(name)
        while name:
            kept[name] = sys.modules[name]
            name = name.rpartition(".")[0]
    for name, shim in port_modules().items():
        monkeypatch.setitem(sys.modules, name, shim)
    for name, mod in kept.items():
        if name != "flink_tpu":
            monkeypatch.setitem(sys.modules, name, mod)
    yield


def reference_cases(test_file: str, names=None, exclude=()) -> List:
    """``pytest.param``s, one per reference test of ``tests/<test_file>``
    (and per parameter set of a parametrized one), in file order: only
    ``names`` when given, never those in ``exclude``."""
    mod = importlib.import_module(Path(test_file).stem)
    out = []
    for name, fn in vars(mod).items():
        if not name.startswith("test_") or not inspect.isfunction(fn):
            continue
        if (names is not None and name not in names) or name in exclude:
            continue
        for params, pid in _param_sets(fn):
            out.append(pytest.param(test_file, name, params,
                                    id=f"{name}[{pid}]" if pid else name))
    return out


def _param_sets(fn) -> List[Tuple[dict, str]]:
    marks = [m for m in getattr(fn, "pytestmark", ())
             if m.name == "parametrize"]
    if not marks:
        return [({}, "")]
    axes = []
    for m in marks:
        argnames, values = m.args[0], m.args[1]
        if isinstance(argnames, str):
            argnames = [a.strip() for a in argnames.split(",")]
        rows = [v if len(argnames) > 1 else (v,) for v in values]
        axes.append([dict(zip(argnames, r)) for r in rows])
    out = []
    for combo in itertools.product(*axes):
        params = {k: v for d in combo for k, v in d.items()}
        out.append((params, "-".join(str(v) for v in params.values())))
    return out


def run_reference_case(test_file: str, name: str, params: dict, request,
                       monkeypatch, keep=()) -> None:
    """Execute ``tests/<test_file>``'s source with its ``flink_tpu``
    imports bound to the port (but the modules in ``keep``, see
    ``bound_to_port``), then call its test ``name`` with ``params`` and
    the fixtures it asks for."""
    path = TESTS / test_file
    with bound_to_port(monkeypatch, keep):
        ns = {"__name__": f"port_{path.stem}", "__file__": str(path)}
        exec(compile(path.read_text(), str(path), "exec"), ns)
        fn = ns[name]
        kwargs = dict(params)
        for p in inspect.signature(fn).parameters:
            if p not in kwargs:
                kwargs[p] = request.getfixturevalue(p)
        fn(**kwargs)


def run_example(name: str, monkeypatch=None) -> str:
    """Run ``examples/<name>.py``'s main() and return what it printed:
    against the reference, or with ``monkeypatch`` given against the port
    (its ``flink_tpu`` imports bound as in run_reference_case)."""
    path = REPO / "examples" / f"{name}.py"
    out = io.StringIO()
    ctx = (bound_to_port(monkeypatch) if monkeypatch is not None
           else contextlib.nullcontext())
    with ctx, contextlib.redirect_stdout(out):
        ns = {"__name__": f"example_{name}", "__file__": str(path)}
        exec(compile(path.read_text(), str(path), "exec"), ns)
        ns["main"]()
    return out.getvalue()
