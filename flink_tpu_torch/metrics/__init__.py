"""Host-side metrics of the port: weighted fire-latency samples
(``latency``) and the drain flight recorder's host half
(``drain_stats``), both copies of the reference's numpy-only modules."""

from flink_tpu_torch.metrics.drain_stats import (
    DRAIN_STAT_FIELDS,
    DrainTelemetry,
)
from flink_tpu_torch.metrics.latency import LatencySamples

__all__ = ["DRAIN_STAT_FIELDS", "DrainTelemetry", "LatencySamples"]
