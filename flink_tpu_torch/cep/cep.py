"""CEP entry points (ref flink-cep CEP.java + PatternStream.java) — the
counterpart of flink_tpu/cep/cep.py."""

from __future__ import annotations

from typing import Callable

from flink_tpu_torch.cep.operator import CEPProcessFunction
from flink_tpu_torch.cep.pattern import Pattern
from flink_tpu_torch.core.time import TimeCharacteristic
from flink_tpu_torch.datastream.datastream import DataStream, KeyedStream


class PatternStream:
    """ref PatternStream: select/flatSelect over detected matches. A match
    is a dict {stage_name: event}."""

    def __init__(self, stream: DataStream, pattern: Pattern):
        self.stream = stream
        self.pattern = pattern

    def _keyed(self) -> KeyedStream:
        if isinstance(self.stream, KeyedStream):
            return self.stream
        # non-keyed pattern stream: single logical partition
        # (ref CEPOperatorUtils applying a NullByteKeySelector)
        return self.stream.key_by(lambda e: 0)

    def _run(self, fn: Callable, flat: bool) -> DataStream:
        keyed = self._keyed()
        event_time = (
            keyed.env.time_characteristic == TimeCharacteristic.EventTime
        )
        return keyed.process(CEPProcessFunction(
            self.pattern, fn, flat=flat, event_time=event_time,
        ))

    def select(self, fn: Callable) -> DataStream:
        """fn(match_dict) -> one result per match."""
        return self._run(fn, flat=False)

    def flat_select(self, fn: Callable) -> DataStream:
        """fn(match_dict) -> iterable of results per match."""
        return self._run(fn, flat=True)


class CEP:
    @staticmethod
    def pattern(stream: DataStream, pattern: Pattern) -> PatternStream:
        return PatternStream(stream, pattern)
