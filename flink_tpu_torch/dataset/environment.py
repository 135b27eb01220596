"""Batch ExecutionEnvironment (ref flink-java ExecutionEnvironment,
SURVEY §2.6) — a copy of flink_tpu/dataset/environment.py on an explicit
device: ``None`` means the CUDA card, and a machine without one raises.
The Avro and JDBC sources raise: the connectors are not ported (ROADMAP
queue 1, item 15)."""

from __future__ import annotations

import csv as _csv
from typing import Any, Iterable, List

import numpy as np

from flink_tpu_torch.core.device import resolve_device
from flink_tpu_torch.dataset.dataset import DataSet


class ExecutionEnvironment:
    def __init__(self, device=None):
        self.device = resolve_device(device)

    @staticmethod
    def get_execution_environment(device=None) -> "ExecutionEnvironment":
        return ExecutionEnvironment(device)

    def from_collection(self, data: Iterable[Any]) -> DataSet:
        data = list(data)
        ds = DataSet(self, lambda: data, "source")
        ds.size_hint = len(data)   # exact, free: feeds the cost model
        return ds

    def from_elements(self, *elements: Any) -> DataSet:
        return self.from_collection(list(elements))

    def generate_sequence(self, start: int, end: int) -> DataSet:
        return DataSet(
            self, lambda: list(range(start, end + 1)), "sequence"
        )

    def read_text_file(self, path: str) -> DataSet:
        def run():
            from flink_tpu_torch.core.filesystem import get_filesystem

            fs, p = get_filesystem(path)
            with fs.open(p, "r") as f:
                return [line.rstrip("\n") for line in f]

        return DataSet(self, run, "text_file")

    def read_avro_file(self, path: str) -> DataSet:
        """Avro object-container file -> records as dicts (ref
        AvroInputFormat): not ported (the connectors are ROADMAP queue 1,
        item 15)."""
        raise NotImplementedError(
            "read_avro_file is not ported to flink_tpu_torch yet (ROADMAP "
            "queue 1, item 15)")

    def read_jdbc(self, connection_factory, query: str,
                  parameters=None) -> DataSet:
        """Database query (splits per parameter tuple) -> row tuples
        (ref JDBCInputFormat over DB-API): not ported (the connectors are
        ROADMAP queue 1, item 15)."""
        raise NotImplementedError(
            "read_jdbc is not ported to flink_tpu_torch yet (ROADMAP queue "
            "1, item 15)")

    def read_csv_file(self, path: str, types=None, delimiter=",") -> DataSet:
        def run():
            from flink_tpu_torch.core.filesystem import get_filesystem

            fs, p = get_filesystem(path)
            out = []
            with fs.open(p, "r", newline="") as f:
                for row in _csv.reader(f, delimiter=delimiter):
                    if types:
                        row = [t(v) for t, v in zip(types, row)]
                    out.append(tuple(row))
            return out

        return DataSet(self, run, "csv_file")
