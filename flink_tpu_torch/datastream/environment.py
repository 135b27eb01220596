"""StreamExecutionEnvironment — job configuration + execution entry (the
main-path subset of flink_tpu/datastream/environment.py).

Same fluent surface as the reference; ``execute()`` runs the recorded job
with the port's executor on one device. The device is an explicit
argument: ``None`` means the CUDA card, and a machine without one raises
instead of running somewhere else. Tests pass ``device="cpu"``, which runs
every kernel's plain PyTorch version.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from flink_tpu_torch.core.config import (
    Configuration,
    CoreOptions,
    load_global_configuration,
)
from flink_tpu_torch.core.time import TimeCharacteristic
from flink_tpu_torch.datastream.datastream import DataStream, _later
from flink_tpu_torch.graph import stream_graph as sg
from flink_tpu_torch.runtime import sources as src_mod
from flink_tpu_torch.runtime.executor import LocalExecutor


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flink_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch versions "
            "of the kernels"
        )
    return dev


class StreamExecutionEnvironment:
    def __init__(self, config: Optional[Configuration] = None, device=None):
        self.device = resolve_device(device)
        # global defaults (conf/flink-tpu-conf.yaml via $FLINK_TPU_CONF_DIR)
        # under the program's explicit configuration
        self.config = load_global_configuration().merge(
            config or Configuration()
        )
        self.parallelism = self.config.get(CoreOptions.DEFAULT_PARALLELISM)
        self.max_parallelism = self.config.get(CoreOptions.MAX_PARALLELISM)
        self.batch_size = self.config.get(CoreOptions.BATCH_SIZE)
        self.time_characteristic = TimeCharacteristic.ProcessingTime
        self.checkpoint_interval_steps = self.config.get(
            CoreOptions.CHECKPOINT_INTERVAL_STEPS
        )
        self.checkpoint_dir = self.config.get(CoreOptions.CHECKPOINT_DIR)
        self.state_capacity_per_shard = self.config.get(
            CoreOptions.STATE_SLOTS_PER_SHARD
        )
        self._sinks: List[sg.SinkTransformation] = []
        self.last_job = None  # JobHandle of the last execute()

    # -- configuration (fluent, reference-shaped) ------------------------
    @staticmethod
    def get_execution_environment(config=None, device=None
                                  ) -> "StreamExecutionEnvironment":
        return StreamExecutionEnvironment(config, device)

    def set_parallelism(self, p: int) -> "StreamExecutionEnvironment":
        self.parallelism = p
        return self

    def set_max_parallelism(self, p: int) -> "StreamExecutionEnvironment":
        self.max_parallelism = p
        return self

    def set_stream_time_characteristic(self, tc: TimeCharacteristic):
        self.time_characteristic = tc
        return self

    def set_buffer_timeout(self, _ms: int):
        return self  # batching cadence is the executor's; accepted for parity

    def enable_checkpointing(self, interval_steps: int, directory=None):
        self.checkpoint_interval_steps = interval_steps
        if directory:
            self.checkpoint_dir = directory
        return self

    def set_state_capacity(self, slots_per_shard: int):
        self.state_capacity_per_shard = slots_per_shard
        return self

    # -- sources ---------------------------------------------------------
    def add_source(self, source: src_mod.Source, name="source") -> DataStream:
        t = sg.SourceTransformation(name, None, source=source)
        return DataStream(self, t)

    def from_collection(self, elements) -> DataStream:
        """An element-mode stream over a finite collection. The port runs
        element streams into CEP patterns; a window or rolling stage over
        one raises (ROADMAP queue 1, item 9)."""
        return self.add_source(src_mod.CollectionSource(list(elements)))

    def from_elements(self, *elements) -> DataStream:
        return self.from_collection(list(elements))

    socket_text_stream = _later("StreamExecutionEnvironment",
                                "socket_text_stream",
                                "ROADMAP queue 1, item 15")
    read_text_file = _later("StreamExecutionEnvironment", "read_text_file",
                            "ROADMAP queue 1, item 15")
    generate_sequence = _later("StreamExecutionEnvironment",
                               "generate_sequence", "ROADMAP queue 1, item 6")
    query_state = _later("StreamExecutionEnvironment", "query_state",
                         "ROADMAP queue 1, item 15")

    # -- execution -------------------------------------------------------
    def execute(self, job_name: str = "flink-tpu-torch-job",
                restore_from: Optional[str] = None):
        executor = LocalExecutor(self)
        self.last_job = executor.run(job_name, self._sinks, restore_from)
        return self.last_job
