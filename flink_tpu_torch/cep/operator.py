"""The keyed CEP operator's routing holder — the counterpart of
flink_tpu/cep/operator.py.

``PatternStream.select`` / ``flat_select`` hand ``KeyedStream.process`` a
``CEPProcessFunction``: the pattern, the select function, whether it is a
flat select, and the time mode. The executor runs it on the device CEP
path (``runtime/cep_job.py``, ``cep/accel.py``). The reference's host
path — ``process_element`` and ``on_timer`` over keyed state and timers,
taken with ``cep.device.enabled: false`` — belongs to
``KeyedStream.process`` for arbitrary functions and is not ported
(ROADMAP queue 1, item 9): those methods raise.
"""

from __future__ import annotations

from typing import Callable

from flink_tpu_torch.cep.nfa import NFA
from flink_tpu_torch.datastream.functions import ProcessFunction

_HOST_PATH = "ROADMAP queue 1, item 9"


class CEPProcessFunction(ProcessFunction):
    def __init__(self, pattern, select_fn: Callable, flat: bool,
                 event_time: bool):
        self.pattern = pattern
        self.nfa = NFA(pattern)
        self.select_fn = select_fn
        self.flat = flat
        self.event_time = event_time

    def process_element(self, value, ctx, out):
        raise NotImplementedError(
            f"the host CEP operator (CEPProcessFunction.process_element) "
            f"is not ported to flink_tpu_torch yet ({_HOST_PATH})")

    def on_timer(self, timestamp, ctx, out):
        raise NotImplementedError(
            f"the host CEP operator (CEPProcessFunction.on_timer) is not "
            f"ported to flink_tpu_torch yet ({_HOST_PATH})")
