"""Window assigners — the catalog of the reference's
api/windowing/assigners (SURVEY §2.5), TPU-adapted.

In the reference an assigner maps each element to window objects
(TumblingEventTimeWindows etc.). Here aligned time windows compile to a
pane-ring `WindowSpec` (ops/window_kernels.py): panes of `slide` ticks,
windows of `size` ticks. Processing-time variants use the same machinery
with host-clock watermarks (the executor drives them). Session windows are
handled by a dedicated merging path (cep/session rounds); Global windows +
count triggers by the count-window path.
"""

from __future__ import annotations

from dataclasses import dataclass

from flink_tpu_torch.core.time import TimeCharacteristic
from flink_tpu_torch.datastream.window.windows import GlobalWindow, TimeWindow


@dataclass(frozen=True)
class WindowAssigner:
    size_ms: int
    slide_ms: int
    is_event_time: bool = True

    @property
    def is_session(self) -> bool:
        return False

    # -- host semantics (generic window operator path) -------------------
    # Device stages compile the same arithmetic into the pane ring; these
    # mirror TumblingEventTimeWindows.assignWindows / SlidingEventTime-
    # Windows.assignWindows for the host operator.
    def assign_windows(self, ts: int):
        if self.size_ms == self.slide_ms:
            start = ts - (ts % self.size_ms)
            return [TimeWindow(start, start + self.size_ms)]
        last_start = ts - (ts % self.slide_ms)
        out = []
        start = last_start
        while start > ts - self.size_ms:
            out.append(TimeWindow(start, start + self.size_ms))
            start -= self.slide_ms
        return out

    def default_trigger(self):
        raise NotImplementedError(
            "window triggers are not ported yet (ROADMAP queue 1, item 9)"
        )

    @property
    def is_merging(self) -> bool:
        return False


class TumblingEventTimeWindows(WindowAssigner):
    @staticmethod
    def of(size_ms: int) -> "WindowAssigner":
        return WindowAssigner(size_ms, size_ms, True)


class SlidingEventTimeWindows(WindowAssigner):
    @staticmethod
    def of(size_ms: int, slide_ms: int) -> "WindowAssigner":
        return WindowAssigner(size_ms, slide_ms, True)


class TumblingProcessingTimeWindows(WindowAssigner):
    @staticmethod
    def of(size_ms: int) -> "WindowAssigner":
        return WindowAssigner(size_ms, size_ms, False)


class SlidingProcessingTimeWindows(WindowAssigner):
    @staticmethod
    def of(size_ms: int, slide_ms: int) -> "WindowAssigner":
        return WindowAssigner(size_ms, slide_ms, False)


@dataclass(frozen=True)
class CountWindowAssigner:
    """countWindow(N): tumbling windows of N elements per key (ref
    KeyedStream.countWindow = GlobalWindows + CountTrigger + purge)."""

    size_n: int
    is_event_time: bool = False

    @property
    def is_session(self) -> bool:
        return False


@dataclass(frozen=True)
class GlobalWindows:
    """All elements into one global window; fires only via a custom
    trigger (ref GlobalWindows.java, default NeverTrigger)."""

    is_event_time: bool = False
    size_ms: int = 0
    slide_ms: int = 0

    @staticmethod
    def create() -> "GlobalWindows":
        return GlobalWindows()

    @property
    def is_session(self) -> bool:
        return False

    @property
    def is_merging(self) -> bool:
        return False

    def assign_windows(self, ts: int):
        return [GlobalWindow.get()]

    def default_trigger(self):
        raise NotImplementedError(
            "window triggers are not ported yet (ROADMAP queue 1, item 9)"
        )


@dataclass(frozen=True)
class SessionWindowAssigner:
    """Session windows (gap-merged); executed by the session-merge path."""

    gap_ms: int
    is_event_time: bool = True

    @property
    def is_session(self) -> bool:
        return True

    @property
    def is_merging(self) -> bool:
        return True

    def assign_windows(self, ts: int):
        return [TimeWindow(ts, ts + self.gap_ms)]

    def default_trigger(self):
        raise NotImplementedError(
            "window triggers are not ported yet (ROADMAP queue 1, item 9)"
        )


class EventTimeSessionWindows:
    @staticmethod
    def with_gap(gap_ms: int) -> SessionWindowAssigner:
        return SessionWindowAssigner(gap_ms, True)


class ProcessingTimeSessionWindows:
    @staticmethod
    def with_gap(gap_ms: int) -> SessionWindowAssigner:
        return SessionWindowAssigner(gap_ms, False)
