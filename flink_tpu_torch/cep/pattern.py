"""CEP Pattern API (ref flink-cep pattern/Pattern.java, SURVEY §2.7) — a
copy of flink_tpu/cep/pattern.py.

A pattern is a linear sequence of named stages, each with a predicate and a
contiguity mode relative to its predecessor:

    Pattern.begin("start").where(p1).next("mid").where(p2) \
           .followed_by("end").where(p3).within(10_000)

- next       = strict contiguity (the very next event must match, else the
               partial match dies) — ref Pattern.next
- followed_by = relaxed contiguity (non-matching events are skipped; an
               "ignore" self-transition keeps the partial alive) —
               ref Pattern.followedBy
- where      adds a predicate (ANDed with any existing one — ref
               Pattern.where's FilterFunction conjunction); or_ ORs one
- subtype    restricts the stage to an isinstance check — ref Pattern.subtype
- within     bounds first-to-last event time — ref Pattern.within
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

STRICT = "strict"      # next()
RELAXED = "relaxed"    # followedBy()


@dataclass
class Stage:
    name: str
    contiguity: str            # STRICT for next(), RELAXED for followedBy()
    predicates: List[Callable] = field(default_factory=list)  # ANDed
    or_predicates: List[Callable] = field(default_factory=list)
    # vectorized predicate: fn(Sequence[event]) -> bool array. ANDed with
    # the scalar predicates like any other where() clause; the device
    # engine evaluates it ONCE per micro-batch instead of per event
    # (per-event Python predicate calls are the host-side cost of the
    # CEP hot path — see cep/accel._masks)
    batch_predicates: List[Callable] = field(default_factory=list)

    def matches(self, event) -> bool:
        base = all(p(event) for p in self.predicates)
        if base and self.batch_predicates:
            base = all(bool(p([event])[0]) for p in self.batch_predicates)
        if self.or_predicates:
            return base or any(p(event) for p in self.or_predicates)
        return base

    def matches_batch(self, events) -> "object":
        """bool array over ``events`` — the vectorized form of
        ``matches``, exact by construction: scalar predicates evaluate
        per event, batch predicates once per batch, combined with the
        same AND/OR structure."""
        import numpy as np

        n = len(events)
        base = np.ones(n, bool)
        for p in self.predicates:
            base &= np.fromiter((bool(p(e)) for e in events), bool,
                                count=n)
        for p in self.batch_predicates:
            base &= np.asarray(p(events), bool)
        if self.or_predicates:
            alt = np.zeros(n, bool)
            for p in self.or_predicates:
                alt |= np.fromiter((bool(p(e)) for e in events), bool,
                                   count=n)
            return base | alt
        return base


class Pattern:
    def __init__(self):
        self.stages: List[Stage] = []
        self.within_ms: Optional[int] = None

    @staticmethod
    def begin(name: str) -> "Pattern":
        p = Pattern()
        p.stages.append(Stage(name, RELAXED))
        return p

    def _add(self, name: str, contiguity: str) -> "Pattern":
        if any(s.name == name for s in self.stages):
            raise ValueError(f"duplicate stage name {name!r}")
        self.stages.append(Stage(name, contiguity))
        return self

    def next(self, name: str) -> "Pattern":
        return self._add(name, STRICT)

    def followed_by(self, name: str) -> "Pattern":
        return self._add(name, RELAXED)

    def where(self, predicate: Callable) -> "Pattern":
        self.stages[-1].predicates.append(predicate)
        return self

    def where_batch(self, predicate: Callable) -> "Pattern":
        """Vectorized ``where``: ``predicate(events) -> bool array``
        evaluated once per micro-batch by the device engine (and exactly
        equivalent per event everywhere else). Worthwhile when the
        per-event predicate itself is expensive; note the host match-
        EXTRACTION replay evaluates conditions per event, where a batch
        predicate degenerates to a singleton call — on match-dense
        streams with cheap predicates the scalar ``where`` measures
        faster end to end."""
        self.stages[-1].batch_predicates.append(predicate)
        return self

    def or_(self, predicate: Callable) -> "Pattern":
        self.stages[-1].or_predicates.append(predicate)
        return self

    def subtype(self, cls) -> "Pattern":
        self.stages[-1].predicates.append(lambda e, _c=cls: isinstance(e, _c))
        return self

    def within(self, ms: int) -> "Pattern":
        self.within_ms = int(ms)
        return self
