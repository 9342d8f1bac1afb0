"""Logical query algebra + the fluent ``Q`` builder.

The paper's headline interface is a *single declarative query* (Cypher with
WHERE-clause dicing) executed where the data lives.  This module is the
repo's equivalent of that Cypher surface: an analyst writes

    Q.log(repo).window(t0, t1).activities(["a", "b"]).view(view).dfg()

and the chain compiles to a :class:`LogicalPlan` — ``source → ops → sink`` —
that the optimizer rewrites and the engine executes on the backend the cost
model picks.  Nothing here touches data; plans are frozen, hashable, and
serialize to a stable key for the plan/result cache.

Grammar (this slice of the port)::

    plan   := source  op*  sink
    source := EventRepository | MemmapLog
    op     := Window(t0, t1)            -- WHERE t0 <= time < t1, paper
                                           semantics (both pair endpoints)
            | Activities(keep, relink)  -- keep only these activities;
                                           relink=False: pair predicate
                                           (paper semantics), relink=True:
                                           pm4py re-linking (materializes)
            | TopVariants(k)            -- keep traces of the top-k variants
                                           (materializes)
            | ApplyView(mapping)        -- access-control projection (§2.2)
    sink   := DFGSink(backend)          -- Ψ (Algorithm 1)
            | HistogramSink(backend)    -- per-activity event counts
            | VariantsSink(k)           -- the trace-variant table
            | ProcessMapSink(top, edge_top, backend)
            | NeighborhoodSink(activity, k, direction, backend)
            | FitnessSink(model, backend)     -- token-replay conformance
            | AlignmentsSink(model, backend)  -- optimal DFG alignments

Materializing ops (:func:`is_barrier`: ``TopVariants`` and
``Activities(relink=True)``) make an intermediate repository in order;
the predicates after a barrier apply to it.

Conformance sinks apply the chain's ops with **sequence semantics**: a
filtered-out or hidden event is dropped and its neighbours re-link, a
window keeps the events inside it, and each surviving trace is scored.
The variants sink does the same with a window or activity filter.

The reference package's other operators, sinks and sources raise
:class:`QueryPlanError` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.core.conformance import ModelSpec
from repro_torch.core.repository import EventRepository
from repro_torch.core.streaming import MemmapLog
from repro_torch.core.views import HIDDEN, ActivityView

__all__ = [
    "Window",
    "EMPTY_WINDOW",
    "Activities",
    "TopVariants",
    "BARRIER_OPS",
    "is_barrier",
    "ApplyView",
    "DFGSink",
    "HistogramSink",
    "VariantsSink",
    "ProcessMapSink",
    "NeighborhoodSink",
    "TOPOLOGY_SINKS",
    "FitnessSink",
    "AlignmentsSink",
    "CONFORMANCE_SINKS",
    "LogicalPlan",
    "Query",
    "Q",
    "QueryPlanError",
    "source_kind",
]


class QueryPlanError(ValueError):
    """Raised for queries outside the supported algebra (bad op/sink combo,
    unsupported source, unknown activity names)."""


def not_ported(what: str, item: int) -> QueryPlanError:
    """The error for a reference query feature this slice does not carry."""
    return QueryPlanError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue A item "
        f"{item})"
    )


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Window:
    """Time dice ``t0 <= time < t1``; a pair counts iff both endpoints fall
    inside (the paper's WHERE clause — the E×E relation stays fixed)."""

    t0: float
    t1: float

    @property
    def empty(self) -> bool:
        return self.t0 >= self.t1

    def normalized(self) -> "Window":
        """Every empty window collapses to the one canonical
        :data:`EMPTY_WINDOW`, so equivalent-but-differently-phrased empty
        queries share a plan key (and backends can short-circuit on it)."""
        return EMPTY_WINDOW if self.empty else self

    def intersect(self, other: "Window") -> "Window":
        """Exact pair-mask intersection (masks AND together), normalized."""
        return Window(max(self.t0, other.t0), min(self.t1, other.t1)).normalized()


#: the canonical empty time dice — selects no event, so DFG sinks
#: short-circuit to zeros without scanning
EMPTY_WINDOW = Window(0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Activities:
    """Activity filter.  ``relink=False``: a pair counts iff both endpoints
    execute a kept activity (pure predicate — commutes past counting).
    ``relink=True``: pm4py semantics — drop events, re-link survivors
    (materializes a diced repository; a plan barrier)."""

    keep: Tuple[str, ...]
    relink: bool = False


@dataclasses.dataclass(frozen=True)
class TopVariants:
    """Keep only traces of the ``k`` most frequent variants (materializes)."""

    k: int


@dataclasses.dataclass(frozen=True)
class ApplyView:
    """Access-control projection: raw activity → group label (or HIDDEN).
    Canonical, hashable mirror of
    :class:`repro_torch.core.views.ActivityView`."""

    mapping: Tuple[Tuple[str, str], ...]
    default: str = HIDDEN

    @staticmethod
    def from_view(view: Union[ActivityView, "ApplyView", Dict[str, str]]) -> "ApplyView":
        if isinstance(view, ApplyView):
            return view
        if isinstance(view, ActivityView):
            return ApplyView(
                mapping=tuple(sorted(view.mapping.items())), default=view.default
            )
        return ApplyView(mapping=tuple(sorted(view.items())))

    def to_view(self) -> ActivityView:
        return ActivityView(mapping=dict(self.mapping), default=self.default)


Op = Union[Window, Activities, TopVariants, ApplyView]

#: ops that force materializing an intermediate repository — predicates
#: cannot be pushed across them
BARRIER_OPS = (TopVariants,)


def is_barrier(op: Op) -> bool:
    return isinstance(op, BARRIER_OPS) or (
        isinstance(op, Activities) and op.relink
    )


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DFGSink:
    """Ψ count matrix — Algorithm 1.  ``backend="auto"`` defers to the cost
    model; anything else pins the physical operator."""

    backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class HistogramSink:
    """Per-activity event counts (the aggregate-only histogram endpoint).
    ``backend`` pins the physical operator like :class:`DFGSink`:
    ``"graph"`` serves the counts from the stored ``:OF_TYPE`` in-degrees
    (windowed: from the graph's time index) instead of rescanning."""

    backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class VariantsSink:
    """Trace-variant table, optionally truncated to the top ``k``."""

    k: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ProcessMapSink:
    """ProFIT-style significance-filtered process map: the top ``top``
    fraction of Activity nodes by event frequency, then the top
    ``edge_top`` (default ``top``) fraction of ``:DF`` edges among them —
    the sink the graph tier makes a store lookup.  ``backend`` pins the
    physical operator like :class:`DFGSink` (``"graph"`` forces the CSR
    store)."""

    top: float = 0.2
    edge_top: Optional[float] = None
    backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class NeighborhoodSink:
    """k-hop ``:DF`` neighborhood of one activity (``direction`` ∈
    out | in | both): reached activities with hop distances plus the
    induced edge subgraph.  Under a view, ``activity`` names a visible
    group label."""

    activity: str
    k: int = 1
    direction: str = "out"
    backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class FitnessSink:
    """Token-replay conformance: per-trace replay fitness of the selected
    traces against ``model`` (a canonical :class:`ModelSpec`).

    ``model=None`` replays against the source's **own** discovered
    dependency graph (whole log, the plan's view/filter applied, windows
    ignored — the "does this slice conform to the overall process" drift
    question; the engine memoizes the discovery per source fingerprint).
    ``backend`` ∈ auto | numpy | streaming | graph."""

    model: Optional[ModelSpec] = None
    backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class AlignmentsSink:
    """Optimal DFG alignments (skip / insert / move-on-model edit distance
    over the model's edge relation), batched per trace variant through the
    ``align_dp`` CUDA kernel.  ``model`` defaults like
    :class:`FitnessSink`.  Needs the variant table, so a memmap source is
    materialized (budget-gated out-of-core)."""

    model: Optional[ModelSpec] = None
    backend: str = "auto"


Sink = Union[
    DFGSink, HistogramSink, VariantsSink, ProcessMapSink, NeighborhoodSink,
    FitnessSink, AlignmentsSink,
]

#: sinks answered from the aggregated :DF topology — the graph backend's
#: domain (and the planner's amortization candidates)
TOPOLOGY_SINKS = (DFGSink, ProcessMapSink, NeighborhoodSink)

#: sinks that replay/align trace sequences — ops apply with re-linking
#: (sequence) semantics, and the graph backend serves them from the stored
#: event tables rather than the aggregated CSR
CONFORMANCE_SINKS = (FitnessSink, AlignmentsSink)


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


def source_kind(source) -> str:
    if isinstance(source, EventRepository):
        return "repository"
    if isinstance(source, MemmapLog):
        return "memmap"
    raise QueryPlanError(
        f"unsupported query source {type(source).__name__}; expected "
        "EventRepository or MemmapLog (sharded logs: ROADMAP Queue A item 8; "
        "multi-log sources: item 5)"
    )


@dataclasses.dataclass(frozen=True)
class LogicalPlan:
    source: str  # "repository" | "memmap"
    ops: Tuple[Op, ...]
    sink: Sink

    def _payload(self) -> list:
        def enc(x) -> list:
            return [type(x).__name__, dataclasses.asdict(x)]

        return [self.source, [enc(o) for o in self.ops], enc(self.sink)]

    def key(self) -> str:
        """Stable content hash — the cache key half owned by the plan."""
        blob = json.dumps(self._payload(), sort_keys=True, default=repr)
        return hashlib.sha256(blob.encode()).hexdigest()[:32]

    def has_barrier(self) -> bool:
        """True when any op materializes an intermediate repository."""
        return any(is_barrier(op) for op in self.ops)


# ---------------------------------------------------------------------------
# Fluent builder
# ---------------------------------------------------------------------------


class Query:
    """Immutable fluent chain.  Non-terminal methods return a new Query;
    terminal methods (:meth:`dfg`, :meth:`histogram`, :meth:`variants`,
    :meth:`process_map`, :meth:`neighborhood`, :meth:`fitness`,
    :meth:`alignments`) hand the plan to a
    :class:`repro_torch.query.execute.QueryEngine`."""

    def __init__(self, source, ops: Tuple[Op, ...] = (), engine=None):
        self._kind = source_kind(source)
        self.source = source
        self.ops = tuple(ops)
        self._engine = engine

    def _with(self, op: Op) -> "Query":
        return Query(self.source, self.ops + (op,), self._engine)

    # -- non-terminals -------------------------------------------------------
    def window(self, t0: float, t1: float) -> "Query":
        return self._with(Window(float(t0), float(t1)))

    def activities(self, keep: Sequence[str], relink: bool = False) -> "Query":
        return self._with(Activities(tuple(str(a) for a in keep), relink))

    def top_variants(self, k: int) -> "Query":
        return self._with(TopVariants(int(k)))

    def view(self, view) -> "Query":
        return self._with(ApplyView.from_view(view))

    def using(self, engine) -> "Query":
        """Pin a specific :class:`QueryEngine` (default: the module-level
        shared engine with the shared cache)."""
        return Query(self.source, self.ops, engine)

    # -- terminals -----------------------------------------------------------
    def _run(self, sink: Sink):
        from .execute import default_engine

        engine = self._engine or default_engine()
        return engine.run(self, sink)

    def dfg(self, backend: str = "auto"):
        return self._run(DFGSink(backend=backend))

    def histogram(self, backend: str = "auto"):
        return self._run(HistogramSink(backend=backend))

    def variants(self, k: Optional[int] = None):
        return self._run(VariantsSink(k=k))

    def process_map(
        self,
        top: float = 0.2,
        edge_top: Optional[float] = None,
        backend: str = "auto",
    ):
        """Significance-filtered process map (top-fraction nodes/edges) —
        served from the CSR graph store once one is built."""
        return self._run(ProcessMapSink(
            top=float(top),
            edge_top=float(edge_top) if edge_top is not None else None,
            backend=backend,
        ))

    def neighborhood(
        self,
        activity: str,
        k: int = 1,
        direction: str = "out",
        backend: str = "auto",
    ):
        """k-hop ``:DF`` successor/predecessor neighborhood of
        ``activity``."""
        if direction not in ("out", "in", "both"):
            raise QueryPlanError(
                f"direction must be out|in|both, got {direction!r}"
            )
        return self._run(NeighborhoodSink(
            activity=str(activity), k=int(k), direction=direction,
            backend=backend,
        ))

    def fitness(self, model=None, backend: str = "auto"):
        """Token-replay conformance of the selected traces.

        ``model`` is a :class:`~repro_torch.core.discovery.DiscoveredModel`
        (or canonical :class:`ModelSpec`); ``None`` replays against the
        source's own whole-log discovered model (see :class:`FitnessSink`).
        """
        return self._run(FitnessSink(
            model=ModelSpec.from_model(model) if model is not None else None,
            backend=backend,
        ))

    def alignments(self, model=None, backend: str = "auto"):
        """Optimal DFG alignments (per-trace cost + normalized fitness),
        batched per variant.  ``model`` as in :meth:`fitness`."""
        return self._run(AlignmentsSink(
            model=ModelSpec.from_model(model) if model is not None else None,
            backend=backend,
        ))

    def compare(self, backend: str = "auto"):
        raise not_ported("compare() (it needs multi-log sources)", 5)

    # -- introspection -------------------------------------------------------
    def logical_plan(self, sink: Sink) -> LogicalPlan:
        return LogicalPlan(self._kind, self.ops, sink)


class Q:
    """Entry point: ``Q.log(repo_or_memmap)``."""

    @staticmethod
    def log(source) -> Query:
        return Query(source)

    @staticmethod
    def logs(*sources, names: Optional[Sequence[str]] = None) -> Query:
        raise not_ported("Q.logs() (multi-log union sources)", 5)
