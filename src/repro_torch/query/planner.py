"""Physical planning — pick the execution backend and the pushdowns.

The cost model is deliberately small (the paper's point is that the *store*
picks the strategy, not the analyst):

========================  =====================================================
situation                 physical operator
========================  =====================================================
memmap log > budget       ``streaming`` scan (O(A²+chunk) memory), window
                          pushed to a **row range** via the chunk time index
memmap log ≤ budget       materialize once, then the device path below
tiny input (≤ tiny_pairs) ``numpy`` scatter-add on the host — beats a device
                          round trip at this size
engine on the CPU         ``scatter`` (torch ``index_put_``)
engine on a CUDA card     ``kernel`` — the hand-written CUDA count; a time
                          window fuses into the kernel's WHERE clause
                          (``dfg_count_diced``)
========================  =====================================================

The thresholds are the static constants below.  The reference package's
calibration records were measured on other hardware, so the port reads none
of them; a port benchmark will measure its own crossovers.

Pushdown decisions recorded on the :class:`PhysicalPlan`:

* ``row_range`` — the memmap chunk-time-index dice (paper Experiment 2);
* ``fused_dicing`` — window evaluated inside the CUDA kernel, on float64
  timestamps (exact, so every windowed kernel-backend count fuses);
* ``view_pushdown`` — when the projection shrinks the activity set, relabel
  pair columns to group ids *before* counting so the count runs at G×G
  instead of A×A;
* ``activities_as_output_mask`` — an activity filter commutes past
  counting: Ψ restricted to keep×keep equals counting masked pairs, so the
  filter becomes a free O(A²) mask on the result instead of an O(E) pair
  predicate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.repository import EventRepository
from repro_torch.core.streaming import MemmapLog

from .ast import (
    Activities,
    ApplyView,
    DFGSink,
    LogicalPlan,
    QueryPlanError,
    Window,
    not_ported,
)

__all__ = [
    "SourceInfo",
    "PhysicalPlan",
    "source_info",
    "plan_physical",
    "TINY_PAIRS",
    "MEMORY_BUDGET_EVENTS",
]

#: below this many pairs, numpy on the host beats a device round trip
TINY_PAIRS = 2048
#: above this many events a memmap log is mined out-of-core
MEMORY_BUDGET_EVENTS = 1 << 22

_DFG_BACKENDS = {"auto", "numpy", "scatter", "onehot", "kernel", "streaming"}
#: reference backends that later slices port (ROADMAP Queue A item)
_LATER_BACKENDS = {"distributed": 6, "graph": 7, "sharded-graph": 8}


@dataclasses.dataclass(frozen=True)
class SourceInfo:
    kind: str  # "repository" | "memmap"
    num_events: int
    num_pairs: int
    num_activities: int
    activity_names: Optional[Tuple[str, ...]]


def source_info(source) -> SourceInfo:
    if isinstance(source, EventRepository):
        return SourceInfo(
            kind="repository",
            num_events=source.num_events,
            num_pairs=max(source.num_events - 1, 0),
            num_activities=source.num_activities,
            activity_names=tuple(source.activity_names),
        )
    if isinstance(source, MemmapLog):
        return SourceInfo(
            kind="memmap",
            num_events=source.num_events,
            num_pairs=max(source.num_events - 1, 0),
            num_activities=source.num_activities,
            activity_names=None,
        )
    raise QueryPlanError(f"unsupported source {type(source).__name__}")


@dataclasses.dataclass(frozen=True)
class PhysicalPlan:
    backend: str  # numpy | scatter | onehot | kernel | streaming
    materialize: bool = False  # memmap source loaded into memory first
    row_range_window: Optional[Tuple[float, float]] = None
    fused_dicing: bool = False
    view_pushdown: bool = False
    activities_as_output_mask: bool = False
    notes: Tuple[str, ...] = ()

    def describe(self) -> str:
        parts = [f"backend={self.backend}"]
        if self.materialize:
            parts.append("materialize=memmap→memory")
        if self.row_range_window is not None:
            parts.append("pushdown=row_range(chunk time index)")
        if self.fused_dicing:
            parts.append("pushdown=fused_kernel_dicing")
        if self.view_pushdown:
            parts.append("pushdown=view_below_count")
        if self.activities_as_output_mask:
            parts.append("rewrite=activity_filter→output_mask")
        parts.extend(self.notes)
        return ", ".join(parts)


def _plan_features(plan: LogicalPlan):
    window = next((o for o in plan.ops if isinstance(o, Window)), None)
    acts = next((o for o in plan.ops if isinstance(o, Activities)), None)
    view = next((o for o in plan.ops if isinstance(o, ApplyView)), None)
    return window, acts, view


def _device_backend(
    num_pairs: int, *, device_type: str, tiny_pairs: int, requested: str
) -> str:
    if requested != "auto":
        return requested
    if num_pairs <= tiny_pairs:
        return "numpy"
    if device_type == "cpu":
        return "scatter"
    return "kernel"


def plan_physical(
    plan: LogicalPlan,
    info: SourceInfo,
    *,
    device_type: str = "cuda",
    tiny_pairs: int = TINY_PAIRS,
    memory_budget_events: int = MEMORY_BUDGET_EVENTS,
) -> PhysicalPlan:
    """Map a canonical logical plan to a physical one.  ``plan`` must be the
    output of :func:`repro_torch.query.optimize.canonicalize`;
    ``device_type`` is the engine's device (``"cuda"`` or ``"cpu"``)."""
    if not isinstance(plan.sink, DFGSink):
        raise QueryPlanError(f"unknown sink {plan.sink!r}")
    requested = plan.sink.backend
    if requested in _LATER_BACKENDS:
        raise not_ported(f"backend {requested!r}", _LATER_BACKENDS[requested])
    if requested not in _DFG_BACKENDS:
        hint = " (the port calls it 'kernel')" if requested == "pallas" else ""
        raise QueryPlanError(f"unknown DFG backend {requested!r}{hint}")
    window, acts, view = _plan_features(plan)
    notes = []
    if window is not None and window.empty:
        # the engine short-circuits to zeros before touching the backend
        notes.append("empty_window=zeros")

    if info.kind == "memmap":
        if (
            info.num_events > memory_budget_events
            and requested not in ("auto", "streaming")
        ):
            raise QueryPlanError(
                f"backend {requested!r} would materialize an out-of-core "
                "log into memory; use streaming/auto or raise "
                "memory_budget_events"
            )
        if requested == "streaming" or (
            requested == "auto" and info.num_events > memory_budget_events
        ):
            return PhysicalPlan(
                backend="streaming",
                row_range_window=(window.t0, window.t1) if window else None,
                # streaming always post-masks the raw Ψ (before any view)
                activities_as_output_mask=acts is not None,
                notes=("streaming=O(A²+chunk) memory",),
            )
        materialize = True
    else:
        if requested == "streaming":
            raise QueryPlanError(
                "streaming backend requires a MemmapLog source"
            )
        materialize = False
    backend = _device_backend(
        info.num_pairs, device_type=device_type, tiny_pairs=tiny_pairs,
        requested=requested,
    )

    view_pushdown = False
    if view is not None and info.activity_names is not None:
        labels = view.to_view().visible_labels(info.activity_names)
        if len(labels) < info.num_activities:
            view_pushdown = True
            notes.append(f"count_space=G×G ({len(labels)}<{info.num_activities})")

    fuse = backend == "kernel" and window is not None and not window.empty
    return PhysicalPlan(
        backend=backend,
        materialize=materialize,
        fused_dicing=fuse,
        view_pushdown=view_pushdown,
        # with a view pushdown the filter must stay a pair predicate (the
        # result matrix is in group space, so raw-activity rows are gone);
        # without it the mask applies to the raw Ψ before any projection
        activities_as_output_mask=acts is not None and not view_pushdown,
        notes=tuple(notes),
    )
