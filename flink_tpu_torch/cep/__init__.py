"""CEP — complex event processing over keyed streams (ref flink-cep,
SURVEY §2.7: Pattern API compiled to an NFA advanced per key), the
counterpart of flink_tpu/cep/: the count NFA runs on the card (G19, G20),
match extraction replays the copied host NFA (``nfa.py``)."""

from flink_tpu_torch.cep.cep import CEP, PatternStream
from flink_tpu_torch.cep.nfa import NFA
from flink_tpu_torch.cep.pattern import Pattern

__all__ = ["CEP", "PatternStream", "NFA", "Pattern"]
