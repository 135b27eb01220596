"""Stage-graph planner: chained keyed windowed stages — a copy of
flink_tpu/runtime/stages.py with its imports pointed at the port's own
modules, for one device.

  * ``StageGraph.from_pipeline`` collects the ordered
    (KeyByTransformation, WindowAggTransformation) pairs off the
    translated pipeline and validates the chain's SHAPE at setup time —
    every unsupported form raises :class:`StageGraphError` naming the
    exact edge, before any state is allocated.
  * ``plan_reduces`` / ``plan_specs`` own the per-stage ``ReduceSpec``s
    and downstream ``WindowStageSpec``s (ring sizing, shared key
    layout). Interior stages inherit the upstream key codec unchanged:
    the on-device edge re-keys fires by IDENTITY (the fired 64-bit key
    ids flow straight into the next stage's table), so one host-side
    codec decodes every stage's emissions and a stage-0 ``direct``
    layout remains valid downstream.
  * ``snapshot_chain`` / ``restore_chain``, the checkpoint cut for stages
    1..N-1, raise: checkpoints are not ported yet (ROADMAP queue 1, item
    6).

The execution half lives in ``runtime/step.py``
(``build_window_chained_drain``): a drain's stage-0 fires are packed on
the card (G21 ``chain_pack``: a scan of the per-plane counts, a binary
search a lane, gathers) and applied to stage 1's update once per drain,
so an N-stage pipeline still costs one host dispatch per ring drain.
The chained watermark coupling (``chain_stage_watermark``) holds stage
N+1's watermark below ``(fired_through_N + 2) * slide_N - 2``, so every
future stage-N fire lands strictly before stage N+1's lateness horizon.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from flink_tpu_torch.graph import stream_graph as sg


class StageGraphError(ValueError):
    """A multi-keyed-stage pipeline shape the chained drain cannot run.

    Raised at SETUP time by StageGraph validation with the offending
    edge named — replacing the deep, late NotImplementedError the
    single-stage executor used to throw after silently collapsing the
    extra stages."""


def _dtype_name(dtype) -> str:
    """A torch dtype's name as numpy spells it (``float32``)."""
    return str(dtype).removeprefix("torch.")


class _Probe:
    """Stand-in WindowResult for probing downstream selectors/extractors."""

    __slots__ = ("key", "window_end_ms", "value")

    def __init__(self, key, value):
        self.key = key
        self.window_end_ms = 0
        self.value = value


@dataclasses.dataclass
class Stage:
    """One keyed windowed stage of the chain (stage 0 = ingest stage)."""

    index: int
    key_by: Optional[sg.KeyByTransformation]
    wagg: sg.WindowAggTransformation

    @property
    def name(self) -> str:
        return f"stage[{self.index}]"

    @property
    def size_ms(self) -> int:
        return self.wagg.assigner.size_ms

    @property
    def slide_ms(self) -> int:
        return self.wagg.assigner.slide_ms


class StageGraph:
    """Validated, topologically ordered chain of keyed windowed stages.

    The spine translation already linearizes the DAG (divergence is
    only legal in trailing stateless chains), so topological order is
    list order; ``edges()`` yields consecutive pairs."""

    def __init__(self, stages: List[Stage]):
        if len(stages) < 2:
            raise StageGraphError(
                "a StageGraph needs at least 2 keyed stages; single-stage "
                "jobs take the direct windowed path"
            )
        self.stages = stages
        self._reduces: Optional[List[Any]] = None

    # ------------------------------------------------------------------
    @classmethod
    def from_pipeline(cls, pipe) -> "StageGraph":
        """Build + shape-validate the graph off a translated pipeline.

        ``pipe.window_agg``/``pipe.key_by`` is stage 0; ``pipe.stages``
        carries the downstream (key_by, wagg) pairs in spine order."""
        if pipe.window_agg is None:
            raise StageGraphError(
                "multi-stage chain has no stage[0] window aggregation "
                "(a downstream keyBy→window pair needs an upstream "
                "windowed stage to consume)"
            )
        stages = [Stage(0, pipe.key_by, pipe.window_agg)]
        for i, (kb, wagg) in enumerate(pipe.stages, start=1):
            if wagg is None:
                raise StageGraphError(
                    f"stage[{i}] has a keyBy with no window aggregation — "
                    f"a downstream keyed stream must end in a window agg "
                    f"(rolling reduces / process functions cannot chain "
                    f"after a windowed stage yet)"
                )
            stages.append(Stage(i, kb, wagg))
        g = cls(stages)
        g.validate()
        return g

    # ------------------------------------------------------------------
    @property
    def depth(self) -> int:
        return len(self.stages)

    def edges(self):
        for up, down in zip(self.stages, self.stages[1:]):
            yield up, down

    def _edge(self, up: Stage, down: Stage) -> str:
        return f"edge {up.name}->{down.name}"

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Shape validation: every unsupported form names its edge."""
        from flink_tpu_torch.datastream.window.assigners import (
            CountWindowAssigner, GlobalWindows,
        )

        for st in self.stages:
            a = st.wagg.assigner
            where = (st.name if st.index == 0
                     else self._edge(self.stages[st.index - 1], st))
            if isinstance(a, GlobalWindows):
                raise StageGraphError(
                    f"{where}: GlobalWindows cannot participate in a "
                    f"chained stage graph (the generic host window "
                    f"operator runs single-stage only)"
                )
            if isinstance(a, CountWindowAssigner):
                raise StageGraphError(
                    f"{where}: count windows cannot participate in a "
                    f"chained stage graph (count stages run on the host "
                    f"path, single-stage only)"
                )
            if getattr(a, "is_session", False):
                raise StageGraphError(
                    f"{where}: session windows cannot participate in a "
                    f"chained stage graph (sessions run on the host "
                    f"merge path, single-stage only)"
                )
            if not getattr(a, "is_event_time", False):
                raise StageGraphError(
                    f"{where}: chained stages require event-time "
                    f"tumbling/sliding windows"
                )
            if (st.wagg.trigger is not None or st.wagg.evictor is not None
                    or st.wagg.window_fn is not None):
                raise StageGraphError(
                    f"{where}: custom trigger/evictor/window function "
                    f"routes to the generic host operator, which is "
                    f"single-stage only"
                )
            if st.wagg.allowed_lateness_ms:
                raise StageGraphError(
                    f"{where}: allowed lateness is unsupported in a "
                    f"chained stage graph — a late re-fire would re-emit "
                    f"the corrected window into the downstream stage and "
                    f"double-count it"
                )

        for up, down in self.edges():
            e = self._edge(up, down)
            if up.wagg.result_fn is not None:
                raise StageGraphError(
                    f"{e}: {up.name} has a result_fn — host-side result "
                    f"extraction cannot run on an interior edge (fires "
                    f"feed the next stage on device); only the final "
                    f"stage may declare one"
                )
            if down.wagg.value_prep is not None:
                raise StageGraphError(
                    f"{e}: {down.name} has a value_prep — host-side "
                    f"value prep cannot run on an interior edge (the "
                    f"edge carries device fire values directly)"
                )
            self._probe_edge(up, down)

        reduces = self.plan_reduces()
        for up, down in self.edges():
            e = self._edge(up, down)
            r_up, r_down = reduces[up.index], reduces[down.index]
            if r_up.kind == "sketch" or r_down.kind == "sketch":
                raise StageGraphError(
                    f"{e}: sketch reduces cannot sit on a chained edge — "
                    f"register planes are not rollup-able values"
                )
            if tuple(r_down.value_shape) != tuple(r_up.out_shape):
                raise StageGraphError(
                    f"{e}: {down.name} consumes values of shape "
                    f"{tuple(r_down.value_shape)} but {up.name} fires "
                    f"shape {tuple(r_up.out_shape)}"
                )
            if r_down.dtype != r_up.out_dtype:
                raise StageGraphError(
                    f"{e}: {down.name} consumes dtype "
                    f"{_dtype_name(r_down.dtype)} but {up.name} fires "
                    f"{_dtype_name(r_up.out_dtype)}"
                )

    def _probe_edge(self, up: Stage, down: Stage) -> None:
        """The device edge re-keys by identity and forwards the fire
        value verbatim — the downstream selector/extractor must agree
        (``lambda r: r.key`` / ``lambda r: r.value`` shapes). Probed
        with sentinel objects so a non-conforming lambda fails loudly
        at setup instead of silently computing something else than the
        host-chained semantics."""
        e = self._edge(up, down)
        k_mark, v_mark = object(), object()
        probe = _Probe(k_mark, v_mark)
        try:
            sel = down.key_by.key_selector(probe)
        except Exception as exc:
            raise StageGraphError(
                f"{e}: {down.name}'s key selector failed on a "
                f"WindowResult probe ({exc!r}) — the chained edge "
                f"re-keys by the upstream window key, so the selector "
                f"must be key-preserving (r.key)"
            ) from exc
        if sel is not k_mark:
            raise StageGraphError(
                f"{e}: {down.name}'s key selector does not preserve the "
                f"upstream key — the device edge re-keys fires by "
                f"identity, so only `r.key` selectors are supported"
            )
        if down.wagg.extractor is not None:
            try:
                val = down.wagg.extractor(probe)
            except Exception as exc:
                raise StageGraphError(
                    f"{e}: {down.name}'s value extractor failed on a "
                    f"WindowResult probe ({exc!r}) — the edge carries "
                    f"the fire value verbatim, so the extractor must be "
                    f"`r.value`"
                ) from exc
            if val is not v_mark:
                raise StageGraphError(
                    f"{e}: {down.name}'s value extractor does not pass "
                    f"the upstream fire value through — the device edge "
                    f"forwards it verbatim, so only `r.value` "
                    f"extractors are supported"
                )

    # ------------------------------------------------------------------
    def check_runtime(self, *, use_resident: bool, overflow_lanes: int,
                      drain_stats: bool, reduced_fires: bool,
                      max_stages: int) -> None:
        """Config-dependent validation, called from the executor's
        setup once the pipeline knobs are resolved."""
        if self.depth > max_stages:
            raise StageGraphError(
                f"stage chain depth {self.depth} exceeds "
                f"pipeline.stages.max-stages={max_stages}"
            )
        if not use_resident:
            raise StageGraphError(
                "a chained stage graph requires the resident drain loop "
                "(pipeline.resident-loop must not resolve to off, and "
                "prefetch/device staging must be available) — the edge "
                "exists only inside the drain scan"
            )
        if overflow_lanes:
            raise StageGraphError(
                "the overflow/spill ring is unsupported in a chained "
                "stage graph (spill merges host-side at emission; "
                "interior stages never emit host-side) — set "
                "state.overflow-ring-lanes=0"
            )
        # drain_stats: accepted — the chained drain carries the
        # stage-aware flight recorder; the param stays so the executor's
        # call site reads as the full runtime-knob contract
        del drain_stats
        if reduced_fires:
            raise StageGraphError(
                "device-reduced fire emission (device_reduce sinks) is "
                "unsupported in a chained stage graph — the final "
                "stage's fires emit on the standard compact path"
            )

    # ------------------------------------------------------------------
    def plan_reduces(self) -> List[Any]:
        """Per-stage ReduceSpecs, built once (factories may close over
        mutable user state; calling them once mirrors single-stage
        setup)."""
        if self._reduces is None:
            self._reduces = [s.wagg.reduce_spec_factory()
                             for s in self.stages]
        return self._reduces

    def plan_specs(self, base_spec, drain_depth: int = 1) -> List[Any]:
        """Downstream WindowStageSpecs (stages 1..N-1), derived from the
        resolved stage-0 spec: same capacity/probe/layout (identity
        re-key => same key population and the same direct-index
        contract). The reference turns pre-combine and packed planes off
        downstream; the port has one update path (its state equals the
        reference's with pre-combine on and off) and keeps a builtin
        reduce's packed plane, whose logical cells equal the reference's
        split ones.

        Ring sizing: a downstream stage advances ONCE per drain (the
        chained drain's stage tail), so between advances it must hold
        every pane between its purge horizon and the newest pane a
        just-fired upstream window can land in. A whole drain's worth
        of stage-0 slots fires at most ``drain_depth * F`` upstream
        pane-ends spanning ``drain_depth * F * slide_up`` ticks beyond
        the coupled watermark (the catch-up worst case), on top of the
        usual 2*panes_per_window live span."""
        from flink_tpu_torch.ops import window_kernels as wk
        from flink_tpu_torch.runtime.step import WindowStageSpec

        reduces = self.plan_reduces()
        specs = []
        for up, down in self.edges():
            size_t, slide_t = down.size_ms, down.slide_ms
            ppw = size_t // slide_t
            f_up = base_spec.win.fires_per_step
            depth = max(1, int(drain_depth))
            slack = (depth * f_up * up.slide_ms) // slide_t + 2
            ring = max(8, 2 * ppw + slack, ppw + 3)
            win = wk.WindowSpec(
                size_ticks=size_t, slide_ticks=slide_t, ring=ring,
                fires_per_step=base_spec.win.fires_per_step,
                lateness_ticks=0, overflow=0,
            )
            specs.append(WindowStageSpec(
                win, reduces[down.index],
                capacity_per_shard=base_spec.capacity_per_shard,
                probe_len=base_spec.probe_len,
                layout=base_spec.layout,
            ))
        return specs

    # ------------------------------------------------------------------
    # the checkpoint cut for stages 1..N-1: not ported with checkpoints
    def snapshot_chain(self, states, specs) -> List[dict]:
        raise NotImplementedError(
            "checkpoint snapshots of a chained stage graph are not ported "
            "to flink_tpu_torch yet (ROADMAP queue 1, item 6)")

    def restore_chain(self, payload, ctx, specs) -> List[Any]:
        raise NotImplementedError(
            "restoring a chained stage graph from a checkpoint is not "
            "ported to flink_tpu_torch yet (ROADMAP queue 1, item 6)")
