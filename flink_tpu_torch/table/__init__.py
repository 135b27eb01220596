"""Table API + SQL subset (ref flink-table, SURVEY §2.7) — the port of
flink_tpu/table/, with the reference's exports."""

from flink_tpu_torch.table.streaming import StreamTableEnvironment
from flink_tpu_torch.table.table import (
    Expr,
    Table,
    TableEnvironment,
    col,
    lit,
)

__all__ = ["Table", "TableEnvironment", "StreamTableEnvironment", "Expr",
           "col", "lit"]
