"""Watermark generation strategies.

Role of the reference's AssignerWithPeriodicWatermarks /
BoundedOutOfOrdernessTimestampExtractor / AscendingTimestampExtractor
(SURVEY §2.5 "Event time / watermarks"), batch-adapted: the executor calls
`on_batch(max_ts_ms)` once per micro-batch (the batch boundary IS the
periodic emission point) and gets the current watermark in epoch ms.
"""

from __future__ import annotations

from dataclasses import dataclass

MIN_WATERMARK_MS = -(2**62)


@dataclass
class WatermarkStrategy:
    out_of_orderness_ms: int = 0
    idle_timeout_ms: int = 0  # reserved (multi-source idleness, later rounds)

    _current: int = MIN_WATERMARK_MS
    # newest event timestamp observed (telemetry: the event-time lag
    # gauge is max_seen - watermark, i.e. how far the watermark trails
    # the data it has already admitted — steady-state it equals the
    # out-of-orderness bound; growth means the watermark is stuck)
    _max_ts: int = MIN_WATERMARK_MS

    @staticmethod
    def for_monotonous_timestamps() -> "WatermarkStrategy":
        return WatermarkStrategy(0)

    @staticmethod
    def for_bounded_out_of_orderness(ms: int) -> "WatermarkStrategy":
        return WatermarkStrategy(ms)

    def on_batch(self, max_ts_ms) -> int:
        if max_ts_ms is not None:
            self._max_ts = max(self._max_ts, int(max_ts_ms))
            self._current = max(self._current, int(max_ts_ms) - self.out_of_orderness_ms - 1)
        return self._current

    def current(self) -> int:
        return self._current

    def restore(self, current_ms: int) -> None:
        """Set the watermark to a checkpoint's ``wm_current``."""
        self._current = int(current_ms)

    def max_event_ts(self) -> int:
        return self._max_ts

    def event_time_lag_ms(self):
        """max seen event time - watermark; None before any batch."""
        if self._max_ts == MIN_WATERMARK_MS or self._current == MIN_WATERMARK_MS:
            return None
        return self._max_ts - self._current

    def watermark_lag_ms(self, now_ms: int):
        """Wall clock - watermark (how far event time trails real time;
        only meaningful when event timestamps are epoch ms). None before
        the first watermark."""
        if self._current == MIN_WATERMARK_MS:
            return None
        return int(now_ms) - self._current
