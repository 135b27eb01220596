"""NFA for CEP pattern matching over a versioned shared buffer — a copy of
flink_tpu/cep/nfa.py (ref
flink-cep nfa/NFA.java:132, computeNextStates:229, SharedBuffer.java:76,
DeweyNumber.java, SURVEY §2.7).

Semantics reproduced from the reference:
- every event can START a new partial match (the start state is always
  active — NFA.java keeps a start ComputationState alive);
- STRICT stages (next) have only a "take" transition: a non-matching event
  kills the partial;
- RELAXED stages (followedBy) also have an "ignore" self-transition: the
  partial survives non-matching events, AND survives a matching event (so
  [a, b1, b2] against `a followedBy b` yields (a,b1) and (a,b2), as the
  reference's shared-buffer branching does);
- `within` prunes partials whose first event is older than the horizon
  (NFA.java's window pruning on processing each event).

Match storage is a SHARED BUFFER, redesigned from the reference's
SharedBuffer + DeweyNumber mechanics for this runtime:

- Matched events live in ``Entry`` nodes; a partial match holds only a
  POINTER to its last entry, and entries reached by several runs (two
  'a'-partials taking the same 'b' event) are ONE node with one back
  **edge per predecessor** — prefix storage is shared exactly like the
  reference's per-(state, event) pages (SharedBuffer.java:76). Sharing
  is structural (one Python object), and pickling a key's partial list
  preserves it (pickle memoizes shared references), so checkpoints carry
  the compressed form.
- Each run (each started partial) is stamped with a **version**; every
  back edge records the version of the run that laid it. Extraction
  walks back from the completing entry following only version-matched
  edges. This is the role of the reference's Dewey numbers: when an
  expired run and a live run share a buffered prefix event, the stale
  run's edges are invisible to the live run's extraction (the
  prefix-compatibility half of Dewey numbering serves looping states —
  oneOrMore — which this Pattern grammar doesn't have, so plain version
  equality is the whole requirement; see test_cep_shared_buffer.py's
  expired-prefix case).
- Runs that CONVERGE to identical computation states — same stage, same
  entry, same version, e.g. two two-path prefixes meeting at one shared
  mid event — are deduplicated into one partial whose extraction later
  enumerates every version-matched back path, emitting each distinct
  matched sequence exactly once (the reference's one-ComputationState-
  many-paths extraction, SharedBuffer.extractPatterns).
- Pruning is reachability: a dropped partial releases its pointer and
  unshared entries die with ordinary garbage collection (the reference
  counts locks per entry — SharedBuffer.release — to the same effect).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.cep.pattern import Pattern, RELAXED


class Entry:
    """One buffered (stage, event) occurrence. ``edges`` are back
    pointers: (predecessor Entry or None for a start, run version).
    Event timestamps live on the events themselves (every CEP input
    carries one); the entry adds no copy."""

    __slots__ = ("event", "edges")

    def __init__(self, event):
        self.event = event
        self.edges: List[Tuple[Optional["Entry"], int]] = []


@dataclass(frozen=True)
class Partial:
    stage_idx: int            # index of the last MATCHED stage
    ptr: Entry                # last entry of this run's chain
    version: int              # run stamp; edges laid by this run carry it
    start_ts: int


def _paths(entry: Entry, version: int) -> List[Tuple[Any, ...]]:
    """All event sequences ending at ``entry`` along version-matched
    edges (SharedBuffer.extractPatterns analog), oldest event first."""
    out: List[Tuple[Any, ...]] = []
    for pred, v in entry.edges:
        if v != version:
            continue
        if pred is None:
            out.append((entry.event,))
        else:
            out.extend(p + (entry.event,) for p in _paths(pred, version))
    return out


class NFA:
    """One NFA instance per job (stateless); per-key state is the list of
    live partials, whose pointers root the shared buffer."""

    def __init__(self, pattern: Pattern):
        self.pattern = pattern
        self.stages = pattern.stages
        self.within_ms = pattern.within_ms

    def initial_state(self) -> List[Partial]:
        return []

    def process(
        self, partials: List[Partial], event, ts: int
    ) -> Tuple[List[Partial], List[Dict[str, Any]]]:
        """Advance the NFA by one event; returns (new_partials, matches).
        A match is {stage_name: event} (ref Map<String, IN> from
        NFA.process)."""
        partials = self._upgrade_all(partials)
        nxt: List[Partial] = []
        seen = set()       # converged-run dedup: (stage, entry, version)
        matches: List[Dict[str, Any]] = []
        last = len(self.stages) - 1
        # one shared Entry per stage this event is taken into: several
        # runs taking the same event converge on one node (the shared
        # buffer's per-(state, event) page)
        taken: Dict[int, Entry] = {}

        def take(p: Optional[Partial], stage_idx: int, start_ts: int,
                 version: int):
            entry = taken.get(stage_idx)
            if entry is None:
                entry = taken[stage_idx] = Entry(event)
            entry.edges.append((p.ptr if p else None, version))
            if stage_idx == last:
                # enumerate only the paths through the edge just laid:
                # a sibling completion sharing this entry re-walks its
                # OWN edge on its own take, so nothing double-emits
                matches.extend(
                    {s.name: ev for s, ev in zip(self.stages, seq)}
                    for seq in _walk_edge(entry, p.ptr if p else None,
                                          version)
                )
            else:
                key = (stage_idx, id(entry), version)
                if key not in seen:    # converged runs dedupe here
                    seen.add(key)
                    nxt.append(Partial(stage_idx, entry, version,
                                       start_ts))

        def _walk_edge(entry: Entry, pred: Optional[Entry],
                       version: int) -> List[Tuple[Any, ...]]:
            """Paths through ONE specific just-laid edge of ``entry``."""
            if pred is None:
                return [(entry.event,)]
            return [p + (entry.event,) for p in _paths(pred, version)]

        live_versions = []
        for p in partials:
            live_versions.append(p.version)
            if self.within_ms is not None and \
                    ts - p.start_ts > self.within_ms:
                continue  # window pruning: partial expired
            stage = self.stages[p.stage_idx + 1]
            if stage.matches(event):
                take(p, p.stage_idx + 1, p.start_ts, p.version)
                if stage.contiguity == RELAXED:
                    nxt.append(p)  # branch: also wait for later matches
            elif stage.contiguity == RELAXED:
                nxt.append(p)      # ignore transition
            # STRICT + no match: partial dies

        if self.stages[0].matches(event):
            # fresh run number: distinct from every LIVE run (a dead
            # run's number may recur — its edges live only on entries
            # created before this run existed, which this run's chain
            # can never reach)
            take(None, 0, ts, max(live_versions, default=-1) + 1)

        return nxt, matches

    def prune(self, partials: List[Partial],
              watermark_ts: int) -> List[Partial]:
        """Drop partials that can no longer complete within the window;
        entries only they referenced are garbage-collected (the
        SharedBuffer.release analog)."""
        if self.within_ms is None:
            return partials
        return [
            p for p in self._upgrade_all(partials)
            if watermark_ts - p.start_ts <= self.within_ms
        ]

    # -- legacy state ----------------------------------------------------
    @staticmethod
    def _upgrade_all(partials: List) -> List[Partial]:
        """Accept pre-shared-buffer checkpointed partials, which stored
        the full event tuple (attribute ``events``) instead of a buffer
        pointer: rebuild unshared chains (correct, just uncompressed).
        Each restored run gets a DISTINCT negative version — stamping
        them all alike would let the convergence dedup conflate
        different runs (different start_ts) into one, dropping or
        resurrecting matches under within(); negatives can't collide
        with live non-negative run numbers."""
        if all(isinstance(p, Partial) and not hasattr(p, "events")
               for p in partials):
            return list(partials)
        out: List[Partial] = []
        for i, p in enumerate(partials):
            if isinstance(p, Partial) and not hasattr(p, "events"):
                out.append(p)
                continue
            entry = None
            version = -1 - i
            for ev in p.events:
                e = Entry(ev)
                e.edges.append((entry, version))
                entry = e
            out.append(Partial(p.stage_idx, entry, version, p.start_ts))
        return out
