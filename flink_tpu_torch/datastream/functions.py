"""User function contracts — the part of flink_tpu/datastream/functions.py
that the port runs: the ``RichFunction`` lifecycle and the
``ProcessFunction`` base that ``cep/operator.py CEPProcessFunction``
subclasses (a copy). The rest (Collector, RuntimeContext, TimerService,
the process contexts, the co- and broadcast functions) comes with
``KeyedStream.process`` for arbitrary functions (ROADMAP queue 1, item 9).
"""

from __future__ import annotations


class RichFunction:
    """RichFunction.java lifecycle + runtime context."""

    def open(self, runtime_context: "RuntimeContext"):
        pass

    def close(self):
        pass


class ProcessFunction(RichFunction):
    """ProcessFunction contract: per-element hook + timer callback.

    Subclass and override; or use KeyedStream.process(fn) with plain
    callables for the stateless case.
    """

    def process_element(self, value, ctx: "ProcessContext",
                        out: "Collector"):
        raise NotImplementedError

    def on_timer(self, timestamp: int, ctx: "OnTimerContext",
                 out: "Collector"):
        pass
