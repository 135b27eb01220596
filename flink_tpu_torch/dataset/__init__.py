"""Batch DataSet API (ref flink-java / DataSet, SURVEY §2.6) — the port
of flink_tpu/dataset/, with the reference's exports."""

from flink_tpu_torch.dataset.dataset import (
    DataSet,
    GroupedDataSet,
    JoinBuilder,
)
from flink_tpu_torch.dataset.environment import ExecutionEnvironment

__all__ = ["DataSet", "GroupedDataSet", "JoinBuilder", "ExecutionEnvironment"]
