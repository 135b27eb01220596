"""flink_tpu_torch stands alone: it imports neither jax nor flink_tpu, and
its entry points run on the CUDA card or raise — never silently on the
CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import flink_tpu_torch
from flink_tpu_torch import StreamExecutionEnvironment
from flink_tpu_torch.ops import cuda as kernels

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    p for p in (REPO / "flink_tpu_torch").rglob("*.py")
    if "_build" not in p.relative_to(REPO).parts
) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flink_tpu")


def test_port_imports_without_jax_or_the_reference():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT_FILES if p.name != "chip_smoke.py")
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flink_tpu'] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None]\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_file_imports_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_environment_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamExecutionEnvironment()
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamExecutionEnvironment(device="cuda")
    assert StreamExecutionEnvironment(device="cpu").device.type == "cpu"


def test_every_kernel_has_a_source_counter_and_plain_version():
    for fn in kernels.KERNELS:
        assert (kernels.CSRC_DIR / kernels.source_of(fn)).is_file()
        assert kernels.source_of(fn) in kernels.SOURCES
        assert isinstance(fn.launches, int)
        assert callable(getattr(kernels, f"{fn.__name__}_plain"))
    assert flink_tpu_torch.__version__


def test_cep_package_and_its_kernels():
    """The cep/ package's public names, and G19 / G20 in the kernel table:
    one source, a counter each, and a plain version that the CPU runs
    without counting a launch."""
    from flink_tpu_torch import cep
    from flink_tpu_torch.cep import accel, device, nfa, operator, pattern

    assert set(cep.__all__) == {"CEP", "PatternStream", "NFA", "Pattern"}
    assert cep.Pattern is pattern.Pattern and cep.NFA is nfa.NFA
    assert issubclass(accel.DeviceCepOperator, object)
    assert operator.CEPProcessFunction.__mro__[1].__name__ == \
        "ProcessFunction"
    for fn in (kernels.cep_scan, kernels.cep_expire):
        assert fn in kernels.KERNELS
        assert kernels.source_of(fn) == "cep_scan.cu"
    before = (kernels.cep_scan.launches, kernels.cep_expire.launches)
    spec = device.DevicePatternSpec(2, (True, True))
    st = device.init_state(8, 8, spec, device="cpu")
    z = torch.zeros(2, dtype=torch.int32)
    device.advance(st, spec, z, z, torch.ones(2, 2, dtype=torch.bool),
                   torch.ones(2, dtype=torch.bool))
    kernels.cep_expire(st.carry, [True], S=2, Q=1)
    assert (kernels.cep_scan.launches, kernels.cep_expire.launches) == before


def test_chained_stages_run_with_jax_and_the_reference_blocked():
    """The chained-stage modules (the copied runtime/stages.py, the chained
    drain, G21 and G22's plain versions) import and run a two-stage drain
    on the CPU with ``jax`` and ``flink_tpu`` unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flink_tpu'] = None\n"
        "import torch\n"
        "from flink_tpu_torch.runtime import stages, step\n"
        "from flink_tpu_torch.ops import window_kernels as wk\n"
        "specs = [step.WindowStageSpec(wk.WindowSpec(s, s, ring=8), "
        "wk.ReduceSpec('sum'), capacity_per_shard=64) for s in (10, 40)]\n"
        "drain = step.build_window_chained_drain(specs, 2, 128, "
        "drain_stats=True)\n"
        "sts = tuple(step.init_shard_state(sp, 128, 'cpu') for sp in specs)\n"
        "B = 32\n"
        "lane = (torch.zeros(B, dtype=torch.int32), "
        "torch.arange(B, dtype=torch.int32), "
        "torch.arange(B, dtype=torch.int32), torch.ones(B), "
        "torch.ones(B, dtype=torch.bool))\n"
        "out = drain(sts, [lane, lane], torch.tensor([100, 100], "
        "dtype=torch.int32), 2)\n"
        "assert len(out) == 4 and out[3][1].shape == (1, 6)\n"
        "assert issubclass(stages.StageGraphError, ValueError)\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None]\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_checkpoints_and_tiers_run_with_jax_and_the_reference_blocked(
        tmp_path):
    """The checkpoint, tier and fault-injection modules (copies of the
    reference's ``testing/faults.py`` and ``runtime/tiers.py``, the port's
    ``runtime/checkpoint.py``) import and run a tiered window job that
    checkpoints every batch, crashes at a drain and restarts, with
    ``jax`` and ``flink_tpu`` unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flink_tpu'] = None\n"
        "import numpy as np\n"
        "from flink_tpu_torch import StreamExecutionEnvironment\n"
        "from flink_tpu_torch.core.config import Configuration\n"
        "from flink_tpu_torch.core.time import TimeCharacteristic\n"
        "from flink_tpu_torch.runtime import checkpoint, tiers\n"
        "from flink_tpu_torch.runtime.sinks import CollectSink\n"
        "from flink_tpu_torch.runtime.sources import GeneratorSource\n"
        "from flink_tpu_torch.testing import faults\n"
        "env = StreamExecutionEnvironment(Configuration({\n"
        "    'pipeline.ring-depth': 2,\n"
        "    'pipeline.resident-loop': 'on',\n"
        "    'state.tiers.resident-key-groups': 2,\n"
        "    'state.tiers.min-dwell-cycles': 1,\n"
        "    'restart-strategy': 'fixed-delay'}), device='cpu')\n"
        "env.set_max_parallelism(8)\n"
        "env.set_stream_time_characteristic(TimeCharacteristic.EventTime)\n"
        "env.set_state_capacity(1024)\n"
        "env.batch_size = 256\n"
        f"env.enable_checkpointing(1, {str(tmp_path)!r})\n"
        "def gen(o, n):\n"
        "    i = np.arange(o, o + n)\n"
        "    return {'key': i % 512, 'value': np.ones(n, np.float32)}, "
        "i * 4000 // 3072\n"
        "sink = CollectSink()\n"
        "(env.add_source(GeneratorSource(gen, total=3072))\n"
        " .key_by(lambda c: c['key']).time_window(1000)\n"
        " .sum(lambda c: c['value']).add_sink(sink))\n"
        "rule = faults.FaultRule('step.drain', exc=OSError('x'), at=3)\n"
        "with faults.active(faults.FaultInjector([rule])):\n"
        "    job = env.execute('tiered')\n"
        "rows = {(r.key, r.window_end_ms): r.value for r in sink.results}\n"
        "cols, ts = gen(0, 3072)\n"
        "want = {}\n"
        "for k, t in zip(cols['key'].tolist(), ts.tolist()):\n"
        "    e = (t // 1000 + 1) * 1000\n"
        "    want[(k, e)] = want.get((k, e), 0.0) + 1.0\n"
        "assert rows == want\n"
        "assert job.metrics.restarts == 1 and job.metrics.checkpoint_stats\n"
        "assert env._pipeline_report()['tiers']['demotes'] > 0\n"
        f"assert checkpoint.CheckpointStorage({str(tmp_path)!r}).latest()\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None]\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_ingest_thread_and_dispatch_modes_run_with_jax_and_the_reference_blocked():
    """The ingest pipeline (its producer thread), the split steps and the
    while-drain import and run a job in each mode — the split path fed by
    the producer, the scan drain, the while-drain with the CPU override —
    with ``jax`` and ``flink_tpu`` unimportable, every row exact."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flink_tpu'] = None\n"
        "import numpy as np\n"
        "from flink_tpu_torch import StreamExecutionEnvironment\n"
        "from flink_tpu_torch.core.config import Configuration\n"
        "from flink_tpu_torch.core.time import TimeCharacteristic\n"
        "from flink_tpu_torch.runtime import ingest, step\n"
        "from flink_tpu_torch.runtime.sinks import CollectSink\n"
        "from flink_tpu_torch.runtime.sources import GeneratorSource\n"
        "def gen(o, n):\n"
        "    i = np.arange(o, o + n)\n"
        "    return {'key': i % 300, 'value': np.ones(n, np.float32)}, "
        "i // 2\n"
        "cols, ts = gen(0, 4096)\n"
        "want = {}\n"
        "for k, t in zip(cols['key'].tolist(), ts.tolist()):\n"
        "    e = (t // 500 + 1) * 500\n"
        "    want[(k, e)] = want.get((k, e), 0.0) + 1.0\n"
        "for cfg in ({}, {'pipeline.resident-loop': 'on'},\n"
        "            {'pipeline.resident-loop': 'while',\n"
        "             'pipeline.while-drain.cpu-override': 'on'}):\n"
        "    env = StreamExecutionEnvironment(Configuration(\n"
        "        {'pipeline.ring-depth': 2, **cfg}), device='cpu')\n"
        "    env.set_max_parallelism(8)\n"
        "    env.set_stream_time_characteristic("
        "TimeCharacteristic.EventTime)\n"
        "    env.set_state_capacity(1024)\n"
        "    env.batch_size = 256\n"
        "    sink = CollectSink()\n"
        "    (env.add_source(GeneratorSource(gen, total=4096))\n"
        "     .key_by(lambda c: c['key']).time_window(500)\n"
        "     .sum(lambda c: c['value']).add_sink(sink))\n"
        "    job = env.execute('modes')\n"
        "    rows = {(r.key, r.window_end_ms): r.value "
        "for r in sink.results}\n"
        "    assert rows == want, cfg\n"
        "    assert (job.metrics.resident_drains > 0) == bool(cfg), cfg\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None]\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
