"""Physical planning — pick the execution backend and the pushdowns.

The cost model is deliberately small (the paper's point is that the *store*
picks the strategy, not the analyst):

========================  =====================================================
situation                 physical operator
========================  =====================================================
graph built / amortized   ``graph`` — un-windowed topology sinks (DFG,
                          process map, neighborhood) answered from the CSR
                          event-knowledge graph store (repro_torch.graph)
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

A union source (``Q.logs``) is costed branch by branch (one union may mix
an out-of-core memmap with in-memory repositories): ``union`` merges the
branches' own sub-plans on the aligned vocabulary, ``compare`` keeps them
apart, and ``concat`` materializes the canonical concatenation for what
does not distribute (the variants sink, materializing ops).  The notes
record each branch's backend as ``branch[<name>]=<backend>``.

One physical operator is chosen by the *engine*, not here: ``delta``.  When
a memmap source is proven to be an append-only extension of a cached scan
(prefix-preserving fingerprint), the engine resumes the cached streaming
state over just the appended suffix — ``delta_rows`` records the suffix row
range it scanned.

Histograms count on the host: ``numpy`` over a repository, a chunked
``streaming`` bincount over a memmap log, or the graph store's ``:OF_TYPE``
degrees when pinned to ``graph``.  The variants sink builds its table on
the host (``numpy``; a memmap log is materialized first).

Materializing ops (``top_variants`` / ``activities(relink=True)``, the
plan's barriers) need a repository: they never stream or read the graph
store, and an out-of-core memmap log refuses them.  Behind a barrier a DFG
counts on the same device path as any other, on the repository the
barrier made.

Conformance sinks (fitness / alignments) plan apart
(:func:`_plan_conformance`): ``numpy`` replays or aligns the columns (a
memmap log is materialized first), ``streaming`` replays a memmap log in
one scan, ``graph`` replays or aligns the graph store's event tables.
Alignments need the variant table, so they never stream; their DP runs on
the engine's device either way (the ``align_dp`` CUDA kernel on a card).

The thresholds are the static constants below, except the memory budget,
which a CUDA engine takes from the card and the host
(:func:`device_memory_budget`).  The reference package's calibration
records were measured on other hardware, so the port reads none of them; a
port benchmark will measure its own crossovers.

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
from repro_torch.kernels.dfg_count.ops import MAX_ACTIVITIES, MAX_PAIRS

from .ast import (
    CONFORMANCE_SINKS,
    Activities,
    AlignmentsSink,
    ApplyView,
    CompareSink,
    DFGSink,
    HistogramSink,
    LogicalPlan,
    NeighborhoodSink,
    ProcessMapSink,
    QueryPlanError,
    UnionSource,
    VariantsSink,
    Window,
    is_barrier,
    not_ported,
    source_kind,
    union_activity_names,
)

__all__ = [
    "SourceInfo",
    "PhysicalPlan",
    "source_info",
    "plan_physical",
    "TINY_PAIRS",
    "MEMORY_BUDGET_EVENTS",
    "GRAPH_REPEAT_CROSSOVER",
    "REPLAY_STREAMING_CROSSOVER",
    "device_memory_budget",
]

#: below this many pairs, numpy on the host beats a device round trip
TINY_PAIRS = 2048
#: above this many events a memmap log is mined out-of-core (a CPU engine's
#: budget, and the least a CUDA engine's measured budget can be)
MEMORY_BUDGET_EVENTS = 1 << 22
#: repeated topology-query misses on one source after which building the
#: event-knowledge graph amortizes (the reference's static default)
GRAPH_REPEAT_CROSSOVER = 3
#: memmap events above which ``auto`` replays a memmap log in one streaming
#: scan instead of materializing it.  The reference ties its static default
#: to the memory budget constant and reads a measured value from its
#: calibration record; the port reads no calibration, so it keeps the static
#: value (a CUDA engine's measured budget is larger, and the crossover is
#: then what sends large logs to the streaming replayer)
REPLAY_STREAMING_CROSSOVER = MEMORY_BUDGET_EVENTS

#: device bytes per event that ``QueryEngine._count`` uploads: the int32
#: activity column (4 B), the bool valid column (1 B) and, for a fused
#: dice, the f64 time column (8 B)
DEVICE_BYTES_PER_EVENT = 13
#: device bytes held apart for the int64 Ψ output, 8·A², at the widest
#: vocabulary the count kernel takes
DEVICE_RESERVED_BYTES = 8 * MAX_ACTIVITIES * MAX_ACTIVITIES
#: host bytes per event an in-budget memmap log holds at the peak of its
#: columnar queries and graph build, counted from the code:
#:  * resident once built, 76 B: the engine's materialized repository
#:    (int32 activity + int32 trace + f64 time, 16 B); the graph's own
#:    ``_event_tables`` (its copy of those columns, 16 B, + the int64
#:    ``act_events``, 8 B); the graph's ``WindowIndex`` (f64 etimes,
#:    pt_src, pt_dst + int32 eacts, psrc, pdst: 36 B);
#:  * transient, the largest step, 68 B: ``build_window_index`` (two int64
#:    sort orders, 16 B, and their sort scratch, 16 B; the int64 pair index
#:    and its shift, 16 B; the f64 t_src / t_dst gathers, 16 B; int32
#:    gathers, 4 B).  ``repository_from_memmap`` peaks higher (72 B: chunk
#:    copies 16, concatenated and permuted columns 32, int64 arange and
#:    lexsort order 16, sort scratch 8) but runs before the index exists;
#: 76 + 68 = 144 B, rounded up to 160 B for the bool masks beside them
HOST_BYTES_PER_EVENT = 160


def device_memory_budget(device_free_bytes: int, host_free_bytes: int) -> int:
    """The memory budget (events) of a CUDA engine: the largest event count
    whose device columns (:data:`DEVICE_BYTES_PER_EVENT`, plus
    :data:`DEVICE_RESERVED_BYTES`) fit half the card's free bytes, whose host
    materialization (:data:`HOST_BYTES_PER_EVENT`) fits half the host's
    free bytes, and whose pairs the count kernel takes in one launch —
    never less than :data:`MEMORY_BUDGET_EVENTS`."""
    device = (
        (int(device_free_bytes) // 2 - DEVICE_RESERVED_BYTES)
        // DEVICE_BYTES_PER_EVENT
    )
    host = (int(host_free_bytes) // 2) // HOST_BYTES_PER_EVENT
    return max(MEMORY_BUDGET_EVENTS, min(device, host, MAX_PAIRS + 1))


_DFG_BACKENDS = {
    "auto", "numpy", "scatter", "onehot", "kernel", "streaming", "graph",
}
#: reference backends that later slices port (ROADMAP Queue A item)
_LATER_BACKENDS = {"distributed": 6, "sharded-graph": 8}
#: sinks the planner maps (the reference's other sinks are later items)
_SINKS = (DFGSink, HistogramSink, VariantsSink, CompareSink, ProcessMapSink,
          NeighborhoodSink)
#: conformance sinks replay/align sequences — device counting backends do
#: not apply; "numpy" is the columnar replay, "streaming" the one-pass
#: replayer, "graph" the stored-event-table walk
_CONFORMANCE_BACKENDS = {"auto", "numpy", "streaming", "graph"}


@dataclasses.dataclass(frozen=True)
class SourceInfo:
    kind: str  # "repository" | "memmap" | "union(...)"
    num_events: int
    num_pairs: int
    num_activities: int
    activity_names: Optional[Tuple[str, ...]]
    # union sources only: per-branch shapes (costed individually — one
    # union may mix an out-of-core memmap branch with in-memory ones)
    branches: Optional[Tuple["SourceInfo", ...]] = None
    branch_names: Optional[Tuple[str, ...]] = None


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
    if isinstance(source, UnionSource):
        infos = tuple(source_info(b.resolve()) for b in source.branches)
        names = tuple(union_activity_names(source))
        return SourceInfo(
            kind=source_kind(source),
            num_events=sum(i.num_events for i in infos),
            num_pairs=sum(i.num_pairs for i in infos),
            num_activities=len(names),
            activity_names=names,
            branches=infos,
            branch_names=source.branch_names,
        )
    raise QueryPlanError(f"unsupported source {type(source).__name__}")


@dataclasses.dataclass(frozen=True)
class PhysicalPlan:
    # numpy | scatter | onehot | kernel | streaming | graph | delta
    #   | union | compare | concat
    # ("delta" is engine-chosen only: it resumes cached streaming state over
    # a proven append-only suffix and is never requestable by the analyst;
    # "union"/"compare" merge per-branch sub-plans — the notes record each
    # branch's own backend — and "concat" materializes the concatenated
    # repository for ops that do not distribute)
    backend: str
    materialize: bool = False  # memmap source loaded into memory first
    row_range_window: Optional[Tuple[float, float]] = None
    fused_dicing: bool = False
    view_pushdown: bool = False
    activities_as_output_mask: bool = False
    delta_rows: Optional[Tuple[int, int]] = None  # suffix row range scanned
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
        if self.delta_rows is not None:
            parts.append(
                f"delta=scan_rows[{self.delta_rows[0]}:{self.delta_rows[1]})"
            )
        parts.extend(self.notes)
        return ", ".join(parts)


def _segment_features(plan: LogicalPlan):
    """Ops of the final (post-barrier) segment + whether barriers exist."""
    has_barrier = any(is_barrier(op) for op in plan.ops)
    tail = []
    for op in plan.ops:
        if is_barrier(op):
            tail = []
        else:
            tail.append(op)
    window = next((o for o in tail if isinstance(o, Window)), None)
    acts = next(
        (o for o in tail if isinstance(o, Activities) and not o.relink), None
    )
    view = next((o for o in tail if isinstance(o, ApplyView)), None)
    return has_barrier, window, acts, view


_BARRIER_ON_GRAPH = (
    "graph backend cannot evaluate materializing ops (top_variants / "
    "relink); drop them or use another backend"
)


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


def _plan_conformance(
    plan: LogicalPlan,
    info: SourceInfo,
    *,
    memory_budget_events: int,
    replay_crossover: int,
    graph_available: bool,
) -> PhysicalPlan:
    """Physical plan for fitness/alignments on a single source.

    Replay (fitness) has all three evaluation paths; alignments need the
    variant table, so out-of-core sources are budget-gated.  The
    streaming↔materialize crossover for replay is ``replay_crossover``, the
    budget is the hard rail.
    """
    requested = plan.sink.backend
    if requested not in _CONFORMANCE_BACKENDS:
        raise QueryPlanError(
            f"backend {requested!r} is not a conformance backend; pick one "
            f"of {sorted(_CONFORMANCE_BACKENDS)}"
        )
    has_barrier, window, _acts, _view = _segment_features(plan)
    notes = []
    if window is not None and window.empty:
        notes.append("empty_window=zeros")
    is_align = isinstance(plan.sink, AlignmentsSink)
    out_of_core = (
        info.kind == "memmap" and info.num_events > memory_budget_events
    )

    if requested == "graph" or (
        requested == "auto" and graph_available and not has_barrier
    ):
        if has_barrier:
            raise QueryPlanError(_BARRIER_ON_GRAPH)
        if out_of_core:
            raise QueryPlanError(
                "graph conformance replays the stored event tables; this "
                "out-of-core log builds a topology-only graph — use "
                "streaming/auto"
            )
        return PhysicalPlan(
            backend="graph",
            notes=("graph=event_table_replay",) + tuple(notes),
        )

    if info.kind == "memmap":
        if requested == "streaming" and (has_barrier or is_align):
            raise QueryPlanError(
                "streaming replay cannot evaluate "
                + ("materializing ops" if has_barrier else "alignments")
                + "; they need a materialized repository"
            )
        if has_barrier or is_align:
            if out_of_core:
                raise QueryPlanError(
                    "alignments / materializing ops on an out-of-core log "
                    "exceed the memory budget; raise memory_budget_events "
                    "or pre-dice the log"
                )
            return PhysicalPlan(
                backend="numpy", materialize=True, notes=tuple(notes)
            )
        if out_of_core and requested == "numpy":
            raise QueryPlanError(
                "backend 'numpy' would materialize an out-of-core log into "
                "memory; use streaming/auto or raise memory_budget_events"
            )
        if requested == "streaming" or (
            requested == "auto"
            and info.num_events > min(memory_budget_events, replay_crossover)
        ):
            return PhysicalPlan(
                backend="streaming",
                row_range_window=(
                    (window.t0, window.t1)
                    if window is not None and not window.empty
                    else None
                ),
                notes=("replay=O(A²+chunk) scan",) + tuple(notes),
            )
        return PhysicalPlan(
            backend="numpy", materialize=True, notes=tuple(notes)
        )
    if requested == "streaming":
        raise QueryPlanError("streaming backend requires a MemmapLog source")
    return PhysicalPlan(backend="numpy", notes=tuple(notes))


def _plan_union(
    plan: LogicalPlan,
    info: SourceInfo,
    *,
    device_type: str,
    tiny_pairs: int,
    memory_budget_events: int,
    replay_crossover: int,
) -> PhysicalPlan:
    """Union costing: every branch is costed on its own shape (one union may
    mix an out-of-core memmap with tiny in-memory repositories), and the
    chosen per-branch backends are recorded in the notes."""
    has_barrier, window, acts, _view = _segment_features(plan)
    notes = []
    if window is not None and window.empty:
        notes.append("empty_window=zeros")

    if isinstance(plan.sink, CompareSink):
        if len(info.branches) < 2:
            raise QueryPlanError(
                "compare() needs at least two logs; got "
                f"{len(info.branches)}"
            )
        if has_barrier:
            raise QueryPlanError(
                "materializing ops (top_variants / relink) are not "
                "supported under compare(): they do not distribute over "
                "the union"
            )
        backend = "compare"
    elif has_barrier or isinstance(plan.sink, VariantsSink):
        # non-distributive: materialize the canonical concatenation
        if info.num_events > memory_budget_events:
            raise QueryPlanError(
                "variants / materializing ops on a union concatenate the "
                "branches in memory; the union exceeds the memory budget"
            )
        return PhysicalPlan(
            backend="concat",
            materialize=True,
            notes=("union=materialize_concatenation",) + tuple(notes),
        )
    else:
        backend = "union"

    # per-branch sub-plans: the window distributes into each branch, the
    # rest (activity mask / view) runs once at the merge.  Conformance
    # sinks distribute *every* op (sequence predicates transform each
    # branch's traces — traces never span branches) and keep their own
    # sink so each branch is costed as a replay, not a count.
    if isinstance(plan.sink, CONFORMANCE_SINKS):
        branch_ops = plan.ops
        branch_sink = plan.sink
    else:
        branch_ops = (window,) if window is not None else ()
        branch_sink = (
            HistogramSink()
            if isinstance(plan.sink, HistogramSink)
            else DFGSink(backend=plan.sink.backend)
        )
    for name, binfo in zip(info.branch_names, info.branches):
        bplan = LogicalPlan(binfo.kind, branch_ops, branch_sink)
        bphys = plan_physical(
            bplan, binfo,
            device_type=device_type, tiny_pairs=tiny_pairs,
            memory_budget_events=memory_budget_events,
            replay_crossover=replay_crossover,
        )
        notes.append(f"branch[{name}]={bphys.backend}")
    return PhysicalPlan(
        backend=backend,
        row_range_window=(
            (window.t0, window.t1)
            if window is not None and not window.empty
            else None
        ),
        activities_as_output_mask=acts is not None,
        notes=tuple(notes),
    )


def plan_physical(
    plan: LogicalPlan,
    info: SourceInfo,
    *,
    device_type: str = "cuda",
    tiny_pairs: int = TINY_PAIRS,
    memory_budget_events: int = MEMORY_BUDGET_EVENTS,
    graph_available: bool = False,
    replay_crossover: int = REPLAY_STREAMING_CROSSOVER,
) -> PhysicalPlan:
    """Map a canonical logical plan to a physical one.  ``plan`` must be the
    output of :func:`repro_torch.query.optimize.canonicalize`;
    ``device_type`` is the engine's device (``"cuda"`` or ``"cpu"``).

    ``graph_available`` is the engine's amortization signal: True when the
    event-knowledge graph of this source is already built (or provably
    extendable / past the repeat-query crossover, so building it now pays).
    With it, un-windowed topology sinks route to the ``graph`` backend —
    CSR lookups instead of an O(E) recount — and conformance sinks replay
    the graph's stored event tables.  ``replay_crossover`` is the memmap
    size above which ``auto`` replays in one streaming scan.  A union source
    (``info.branches``) plans each branch on its own shape
    (:func:`_plan_union`)."""
    if not isinstance(plan.sink, CONFORMANCE_SINKS):
        if not isinstance(plan.sink, _SINKS):
            raise QueryPlanError(f"unknown sink {plan.sink!r}")
        requested = getattr(plan.sink, "backend", "auto")
        if requested in _LATER_BACKENDS:
            raise not_ported(
                f"backend {requested!r}", _LATER_BACKENDS[requested]
            )
        if requested not in _DFG_BACKENDS:
            hint = (
                " (the port calls it 'kernel')" if requested == "pallas"
                else ""
            )
            raise QueryPlanError(f"unknown DFG backend {requested!r}{hint}")
    if info.branches is not None:
        return _plan_union(
            plan, info,
            device_type=device_type, tiny_pairs=tiny_pairs,
            memory_budget_events=memory_budget_events,
            replay_crossover=replay_crossover,
        )
    if isinstance(plan.sink, CompareSink):
        raise QueryPlanError(
            "compare() requires a multi-log source — build one with "
            "Q.logs(a, b, ...)"
        )
    if isinstance(plan.sink, CONFORMANCE_SINKS):
        return _plan_conformance(
            plan, info,
            memory_budget_events=memory_budget_events,
            replay_crossover=replay_crossover,
            graph_available=graph_available,
        )
    has_barrier, window, acts, view = _segment_features(plan)
    windowed = window is not None and not window.empty
    out_of_core = (
        info.kind == "memmap" and info.num_events > memory_budget_events
    )
    notes = []
    if window is not None and window.empty:
        # the engine short-circuits to zeros before touching the backend
        notes.append("empty_window=zeros")

    if isinstance(plan.sink, (HistogramSink, VariantsSink)):
        # the variant table and any barrier need a repository
        needs_repo = isinstance(plan.sink, VariantsSink) or has_barrier
        # graph histograms: the stored :OF_TYPE in-degrees answer the
        # un-windowed counts as a lookup; a window reads the graph's time
        # index (event tables required, so out-of-core logs whose graphs
        # are topology-only can't serve windowed counts)
        if requested == "graph" and needs_repo and info.kind == "memmap":
            raise QueryPlanError(
                "graph histograms cannot evaluate materializing ops or "
                "windows over out-of-core logs (topology-only graph) — use "
                "streaming/auto"
            )
        if requested == "graph" and not needs_repo:
            if windowed and out_of_core:
                raise QueryPlanError(
                    "graph histograms cannot evaluate windows over "
                    "out-of-core logs (topology-only graph) — use "
                    "streaming/auto"
                )
            return PhysicalPlan(
                backend="graph",
                activities_as_output_mask=acts is not None,
                notes=("graph=of_type_counts",) + tuple(notes),
            )
        if info.kind == "memmap":
            if not needs_repo:  # chunked bincount, window → row range
                return PhysicalPlan(
                    backend="streaming",
                    row_range_window=(window.t0, window.t1) if window else None,
                )
            if out_of_core:
                raise QueryPlanError(
                    "variants / materializing ops on an out-of-core log "
                    "exceed the memory budget; raise memory_budget_events "
                    "or pre-dice the log"
                )
            return PhysicalPlan(backend="numpy", materialize=True)
        return PhysicalPlan(backend="numpy")

    # -- topology sinks (DFG / process map / neighborhood) -------------------
    # graph backend: the aggregated :DF CSR answers un-windowed topology
    # queries as lookups.  A window needs the event-level tables
    # (out-of-core graphs are topology-only), and barriers change the
    # source itself.
    if requested == "graph" or (
        requested == "auto" and graph_available and not windowed
        and not has_barrier
    ):
        if has_barrier:
            raise QueryPlanError(_BARRIER_ON_GRAPH)
        if windowed and out_of_core:
            raise QueryPlanError(
                "windowed graph queries need event tables; this out-of-core "
                "log builds a topology-only graph — use streaming/auto"
            )
        notes.append(
            "graph=event_tables_window" if windowed else "graph=csr_lookup"
        )
        return PhysicalPlan(
            backend="graph",
            activities_as_output_mask=acts is not None,
            notes=tuple(notes),
        )

    if info.kind == "memmap":
        if has_barrier:
            if requested == "streaming":
                raise QueryPlanError(
                    "streaming cannot evaluate materializing ops "
                    "(top_variants / relink)"
                )
            if out_of_core:
                raise QueryPlanError(
                    "materializing ops (top_variants / relink) on an "
                    "out-of-core log exceed the memory budget"
                )
        if out_of_core and requested not in ("auto", "streaming"):
            raise QueryPlanError(
                f"backend {requested!r} would materialize an out-of-core "
                "log into memory; use streaming/auto or raise "
                "memory_budget_events"
            )
        if requested == "streaming" or (requested == "auto" and out_of_core):
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
