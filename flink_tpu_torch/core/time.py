"""Event time, processing time, watermarks.

Mirrors the contracts of the reference's TimeCharacteristic
(flink-streaming-java/.../api/TimeCharacteristic.java) and Watermark
(.../api/watermark/Watermark.java), TPU-adapted: timestamps on device are
int32 *ticks* relative to a per-job origin so everything stays in 32-bit
integer registers (TPU has no fast int64/f64 path). The host-side API speaks
int milliseconds; `TimeDomain` converts.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

# Sentinels (int32-representable; mirror Long.MIN_VALUE/MAX_VALUE roles)
MIN_TS = -(2**31) + 1
MAX_TS = 2**31 - 2
MAX_WATERMARK = MAX_TS  # end-of-stream watermark (ref Watermark.MAX_WATERMARK)


class TimeCharacteristic(enum.Enum):
    ProcessingTime = "processing-time"
    IngestionTime = "ingestion-time"
    EventTime = "event-time"


@dataclass(frozen=True)
class Watermark:
    """Event-time watermark: no elements with ts <= timestamp will follow."""

    timestamp: int

    def __le__(self, other):
        return self.timestamp <= other.timestamp


@dataclass(frozen=True)
class TimeDomain:
    """Mapping between host milliseconds and device int32 ticks.

    origin_ms: host epoch-ms mapped to tick 0.
    ms_per_tick: granularity (1 = millisecond ticks; covers ±24.8 days of
    event-time span per job at 1ms; raise for longer horizons).
    """

    origin_ms: int = 0
    ms_per_tick: int = 1

    def to_ticks(self, ms):
        t = (np.asarray(ms, dtype=np.int64) - self.origin_ms) // self.ms_per_tick
        return np.clip(t, MIN_TS, MAX_TS).astype(np.int32)

    def to_ms(self, ticks):
        return np.asarray(ticks, dtype=np.int64) * self.ms_per_tick + self.origin_ms


class Time:
    """Duration helpers (ref flink-streaming-java Time.java surface)."""

    @staticmethod
    def milliseconds(n: int) -> int:
        return int(n)

    @staticmethod
    def seconds(n: float) -> int:
        return int(n * 1000)

    @staticmethod
    def minutes(n: float) -> int:
        return int(n * 60_000)

    @staticmethod
    def hours(n: float) -> int:
        return int(n * 3_600_000)

    @staticmethod
    def days(n: float) -> int:
        return int(n * 86_400_000)
