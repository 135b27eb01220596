"""flink_tpu_torch — the PyTorch/CUDA port of flink_tpu for one NVIDIA H100.

The same DataStream API, config keys and window semantics as ``flink_tpu``
(the JAX reference, which stays beside it), with the device work in
hand-written Hopper kernels (``csrc/``, bound in ``ops/cuda.py``). It
imports ``torch`` and ``numpy`` and never ``jax`` or ``flink_tpu``.

Layer map (mirrors flink_tpu/):
  core/       — config, time, key groups, types
  ops/        — hashing, the hash table, the window, session, count-window
                and rolling operators, the segment sort, and the kernels
  cep/        — CEP: the pattern API, the host NFA, the device count NFA
  datastream/ — user-facing DataStream API
  graph/      — transformation graph
  runtime/    — executor, device ring, steps, sources, sinks, watermarks

The port runs one keyed stage a job: an event-time tumbling or sliding
window, an event-time session window, a count window, a rolling reduce,
or a CEP pattern (``flink_tpu_torch.cep``), into any of its sinks
(ROADMAP.md lists what comes next).
"""

__version__ = "0.1.0"

from flink_tpu_torch.datastream.environment import StreamExecutionEnvironment  # noqa: F401,E402
