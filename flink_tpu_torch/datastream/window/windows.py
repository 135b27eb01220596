"""Window types — TimeWindow / GlobalWindow.

Mirrors the reference's api/windowing/windows (TimeWindow.java,
GlobalWindow.java): a window is a hashable value object usable as a state
namespace; TimeWindow spans [start, end) and fires at max_timestamp() =
end - 1.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class TimeWindow:
    start: int
    end: int  # exclusive

    def max_timestamp(self) -> int:
        return self.end - 1

    def intersects(self, other: "TimeWindow") -> bool:
        return self.start <= other.end and other.start <= self.end

    def cover(self, other: "TimeWindow") -> "TimeWindow":
        return TimeWindow(min(self.start, other.start),
                          max(self.end, other.end))


@dataclass(frozen=True)
class GlobalWindow:
    """The single window of GlobalWindows (ref GlobalWindow.java)."""

    def max_timestamp(self) -> int:
        return 2**62  # never reached by watermarks

    _INSTANCE = None

    @staticmethod
    def get() -> "GlobalWindow":
        if GlobalWindow._INSTANCE is None:
            GlobalWindow._INSTANCE = GlobalWindow()
        return GlobalWindow._INSTANCE
