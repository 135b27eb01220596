"""Deterministic fault injection — a copy of flink_tpu/testing/faults.py
(numpy/stdlib only), the chaos-testing seam of the port's checkpoint,
drain and tier code.

Production modules call ``faults.inject("<point>", **ctx)`` at named
injection points. With no injector installed — the production default —
``inject`` is one module-global ``None`` check, so the hooks cost
nothing measurable and nothing test-only leaks into the hot path.
Tests install a :class:`FaultInjector` built from :class:`FaultRule`\\ s
whose triggers are **occurrence-indexed** (fire on the k-th hit of a
point, or every k-th hit, bounded by ``times``) or seeded-random
(``prob`` drawn from one ``random.Random(seed)``), so every run of a
chaos test injects the identical fault schedule.

Injected failures are REAL exception types (``OSError``,
``ConnectionResetError``, ...) so the containment code under test
exercises exactly the branch a production fault would take.

Injection points wired in the port (the reference wires more, at the
subsystems the port has not taken yet):

    ckpt.entries.write      runtime/checkpoint CheckpointStorage.write,
                            before any file IO
    ckpt.publish            CheckpointStorage.write, before the atomic
                            rename (a crash mid-write)
    ckpt.read.primary       CheckpointStorage.read, before the read of one
                            checkpoint directory
    step.drain              runtime/executor, before every resident ring
                            drain dispatch — the mid-drain crash seam of
                            the exactly-once tests
    step.dispatch           runtime/executor, before every K-step megastep
                            dispatch — a crash inside a fused group (the
                            reference also hits it before each single step
                            and drain)
    ingest.producer         runtime/ingest IngestPipeline._producer,
                            before each prep on the prefetch thread and
                            outside its error delivery: a raise there
                            kills the producer, which the step loop
                            surfaces as IngestThreadDied
    tier.demote.write       runtime/tiers.fold_entries, before a demoted
                            key-group's entries fold into the host pane
                            stores — a crash between a demote and its
                            checkpoint loses only process-local host
                            memory the next restore re-seeds from the
                            last cut
    tier.promote.read       runtime/tiers.fetch_group_entries, before a
                            promote pulls a key-group's pending entries
                            out of the pane stores (the read half of the
                            tier swap)

Actions:

    raise   raise ``exc`` (an exception instance; re-raised by value)
    sleep   time.sleep(delay_s) — stalls/slow I/O
    torn    raise :class:`TornWrite`; the site writes a truncated
            payload first, then fails the operation
    call    invoke ``fn(ctx)`` — e.g. close a socket handed in ctx
    kill    raise :class:`ThreadKilled` (a BaseException): unlike
            ``raise`` it sails through every ``except Exception``
            containment layer between the point and the thread's top
            frame — HARD thread/producer death, the "process segment
            just vanished" failure mode
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class TornWrite(Exception):
    """Raised by ``inject`` for ``action="torn"``: the site must write a
    truncated payload before failing the operation (a torn write leaves
    PARTIAL bytes on disk, unlike a clean error)."""


class ThreadKilled(BaseException):
    """Raised by ``inject`` for ``action="kill"``. Deliberately a
    BaseException: the containment layers under test catch ``Exception``,
    so a kill rule dies HARD through all of them — the closest userspace
    analog of a thread that simply ceases to run. The survivors (the
    consumer detecting a dead producer, the watchdog detecting the
    resulting stall) are what the rule exercises."""


@dataclass
class FaultRule:
    """One scheduled fault. Trigger precedence: ``at`` (0-based hit
    index) > ``every`` (every k-th hit) > ``prob`` (per-hit coin flip on
    the injector's seeded RNG). ``times`` bounds total firings."""

    point: str
    action: str = "raise"            # raise | sleep | torn | call | kill
    exc: Optional[BaseException] = None
    delay_s: float = 0.0
    fn: Optional[Callable[[dict], Any]] = None
    at: Optional[int] = None
    every: Optional[int] = None
    prob: float = 0.0
    times: int = 1
    fired: int = field(default=0, compare=False)

    def wants(self, hit_index: int, rng: random.Random) -> bool:
        if self.times and self.fired >= self.times:
            return False
        if self.at is not None:
            return hit_index == self.at
        if self.every is not None:
            return self.every > 0 and hit_index % self.every == 0
        if self.prob:
            return rng.random() < self.prob
        return True                   # unconditional (bounded by times)


class FaultInjector:
    """Seeded, occurrence-indexed fault scheduler. Thread-safe: hit
    counters and the RNG are guarded (injection points fire from the
    step loop, the materializer thread, the prefetch thread, and DCN
    ring peers); the ACTION runs outside the lock so an injected sleep
    never serializes unrelated points."""

    def __init__(self, rules, seed: int = 0):
        self.rules: List[FaultRule] = list(rules)
        self.seed = seed
        self._rng = random.Random(seed)
        self._hits: Dict[str, int] = {}
        self.fired: List[dict] = []   # audit log for test assertions
        self._lock = threading.Lock()

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def fired_at(self, point: str) -> List[dict]:
        with self._lock:
            return [f for f in self.fired if f["point"] == point]

    def hit(self, point: str, ctx: dict) -> None:
        due: List[FaultRule] = []
        with self._lock:
            idx = self._hits.get(point, 0)
            self._hits[point] = idx + 1
            for rule in self.rules:
                if rule.point == point and rule.wants(idx, self._rng):
                    rule.fired += 1
                    self.fired.append({
                        "point": point, "hit": idx, "action": rule.action,
                    })
                    due.append(rule)
        for rule in due:
            if rule.action == "sleep":
                time.sleep(rule.delay_s)
            elif rule.action == "call":
                if rule.fn is not None:
                    rule.fn(ctx)
            elif rule.action == "torn":
                raise TornWrite(f"injected torn write at {point}")
            elif rule.action == "kill":
                raise ThreadKilled(f"injected thread kill at {point}")
            else:
                raise rule.exc if rule.exc is not None else RuntimeError(
                    f"injected fault at {point}"
                )


# -- installation ------------------------------------------------------
# ONE process-global active injector: the hooks live in hot-adjacent
# modules, and per-job plumbing would thread a handle through a dozen
# constructors for a facility that is off outside tests.

_ACTIVE: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> None:
    global _ACTIVE
    _ACTIVE = injector


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def get() -> Optional[FaultInjector]:
    return _ACTIVE


@contextlib.contextmanager
def active(injector: FaultInjector):
    """Scoped installation for tests; always uninstalls."""
    install(injector)
    try:
        yield injector
    finally:
        uninstall()


def inject(point: str, **ctx) -> None:
    """The production-side hook: a no-op unless an injector is
    installed. May raise whatever the matching rule schedules."""
    inj = _ACTIVE
    if inj is not None:
        inj.hit(point, ctx)
