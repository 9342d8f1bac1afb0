"""Logical query algebra + the fluent ``Q`` builder.

The paper's headline interface is a *single declarative query* (Cypher with
WHERE-clause dicing) executed where the data lives.  This module is the
repo's equivalent of that Cypher surface: an analyst writes

    Q.log(repo).window(t0, t1).activities(["a", "b"]).view(view).dfg()

and the chain compiles to a :class:`LogicalPlan` — ``source → ops → sink`` —
that the optimizer rewrites and the engine executes on the backend the cost
model picks.  Nothing here touches data; plans are frozen, hashable, and
serialize to a stable key for the plan/result cache.

Grammar::

    plan   := source  op*  sink
    source := leaf                      -- EventRepository | MemmapLog
                                           | ShardedLog
            | LogRef(leaf, name)        -- a *named* single log
            | FromLogs(repo, names)     -- the L×T dice: the named logs of a
                                           multi-log repository
            | Union(source, ...)        -- multi-source (class UnionSource),
                                           built via Q.logs(a, b, ...)
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
            | CompareSink(backend)      -- union only: per-log Ψ + drift
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

The source algebra makes "which logs" a plan property instead of a
pre-filter: predicates distribute into every branch, union sinks merge
branch results on an aligned activity axis, and :class:`CompareSink` keeps
branches separate for cross-deployment conformance drift.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.conformance import ModelSpec
from repro_torch.core.repository import EventRepository
from repro_torch.core.streaming import MemmapLog, memmap_log_name
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
    "CompareSink",
    "ProcessMapSink",
    "NeighborhoodSink",
    "TOPOLOGY_SINKS",
    "FitnessSink",
    "AlignmentsSink",
    "CONFORMANCE_SINKS",
    "ModelSpec",
    "LogRef",
    "FromLogs",
    "UnionSource",
    "union_activity_names",
    "LogicalPlan",
    "Query",
    "Q",
    "QueryPlanError",
    "source_kind",
]


class QueryPlanError(ValueError):
    """Raised for queries outside the supported algebra (bad op/sink combo,
    unsupported source, unknown activity names)."""


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
class CompareSink:
    """Cross-log comparison (union sources only): per-log Ψ matrices on the
    aligned union vocabulary, Ψ-difference matrices against the first
    (reference) branch, and replay-fitness drift
    (:func:`repro_torch.core.conformance.replay_fitness` of every branch
    against the dependency graph discovered from the reference branch).
    ``backend`` pins the per-branch counting operator, like
    :class:`DFGSink`."""

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
    Under :meth:`Query.compare` the default is the *reference branch's*
    model.  ``backend`` ∈ auto | numpy | streaming | graph."""

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
    DFGSink, HistogramSink, VariantsSink, CompareSink, ProcessMapSink,
    NeighborhoodSink, FitnessSink, AlignmentsSink,
]

#: sinks answered from the aggregated :DF topology — the graph backend's
#: domain (and the planner's amortization candidates)
TOPOLOGY_SINKS = (DFGSink, ProcessMapSink, NeighborhoodSink)

#: sinks that replay/align trace sequences — ops apply with re-linking
#: (sequence) semantics, and the graph backend serves them from the stored
#: event tables rather than the aggregated CSR
CONFORMANCE_SINKS = (FitnessSink, AlignmentsSink)


# ---------------------------------------------------------------------------
# Source algebra
# ---------------------------------------------------------------------------


class LogRef:
    """A *named* single-log source — the leaf of the source algebra.

    ``name`` is the branch label used for provenance (result ``log_names``,
    per-branch physical-plan notes, compare axes); ``resolve()`` yields the
    underlying store the engine executes on."""

    def __init__(self, source, name: str):
        from repro_torch.graph.shard import ShardedLog

        if not isinstance(source, (EventRepository, MemmapLog, ShardedLog)):
            raise QueryPlanError(
                f"LogRef wraps a leaf source, got {type(source).__name__}"
            )
        self.source = source
        self.name = str(name)

    def resolve(self):
        return self.source

    @property
    def kind(self) -> str:
        return source_kind(self.source)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"LogRef({self.kind}, name={self.name!r})"


class FromLogs:
    """The L×T dice as a plan node: the traces of the named logs of one
    multi-log repository (``trace_log`` / ``log_names`` are already
    materialized — Definition 1).  Resolution (one
    :meth:`EventRepository.select_logs` call) is lazy and memoized; sibling
    branches expanded from the same repository by :meth:`Q.logs` share one
    :meth:`EventRepository.split_logs` pass instead of re-dicing per
    branch."""

    def __init__(
        self,
        repo: EventRepository,
        names: Sequence[str],
        name=None,
        _sibling_split: Optional[Dict[str, EventRepository]] = None,
        _siblings: Optional[Tuple[str, ...]] = None,
    ):
        if not isinstance(repo, EventRepository):
            raise QueryPlanError("FromLogs requires an EventRepository")
        self.repo = repo
        self.names = tuple(str(n) for n in names)
        if not self.names:
            raise QueryPlanError("FromLogs needs at least one log name")
        for n in self.names:
            if n not in repo.log_names:
                raise QueryPlanError(
                    f"unknown log {n!r}; repository has {repo.log_names}"
                )
        self.name = str(name) if name is not None else "+".join(self.names)
        self._resolved: Optional[EventRepository] = None
        # Q.logs fills this shared dict with one split_logs pass covering
        # every sibling branch the first time any of them resolves
        self._sibling_split = _sibling_split
        self._siblings = _siblings

    def resolve(self) -> EventRepository:
        if self._resolved is None:
            if (
                self._sibling_split is not None
                and self._siblings is not None
                and len(self.names) == 1
            ):
                if not self._sibling_split:
                    self._sibling_split.update(
                        self.repo.split_logs(self._siblings)
                    )
                self._resolved = self._sibling_split[self.names[0]]
            else:
                self._resolved = self.repo.select_logs(self.names)
        return self._resolved

    @property
    def kind(self) -> str:
        return "repository"

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"FromLogs({self.names!r}, name={self.name!r})"


class UnionSource:
    """An ordered union of named branches (:class:`LogRef` /
    :class:`FromLogs`).  Branch names are unique; nesting is flattened by
    the :meth:`Q.logs` builder, so the algebra stays one level deep."""

    def __init__(self, branches: Sequence[object]):
        branches = tuple(branches)
        if not branches:
            raise QueryPlanError("union of zero sources")
        for b in branches:
            if isinstance(b, UnionSource):
                raise QueryPlanError(
                    "nested unions are not supported; flatten the branches"
                )
            if not isinstance(b, (LogRef, FromLogs)):
                raise QueryPlanError(
                    f"union branches must be LogRef/FromLogs, got "
                    f"{type(b).__name__}"
                )
        names = [b.name for b in branches]
        if len(set(names)) != len(names):
            raise QueryPlanError(f"duplicate branch names in union: {names}")
        self.branches = branches

    @property
    def branch_names(self) -> Tuple[str, ...]:
        return tuple(b.name for b in self.branches)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"UnionSource({', '.join(map(repr, self.branches))})"


def union_activity_names(union: UnionSource) -> List[str]:
    """The aligned union vocabulary — the sorted name union over the
    branches, derived from *unresolved* branch metadata (``select_logs``
    preserves its parent's vocabulary, so a FromLogs branch contributes
    exactly the parent's names).  The engine (cache-hit canonicalization,
    merge axes) and the planner (:func:`~repro_torch.query.planner.
    source_info`) both use it, and it equals the vocabulary of the
    canonical concatenated repository."""
    names = set()
    for b in union.branches:
        if isinstance(b, FromLogs):
            names |= set(b.repo.activity_names)
        elif isinstance(b.source, EventRepository):
            names |= set(b.source.activity_names)
        else:
            names |= set(b.source.activity_labels())
    return sorted(names)


def _default_branch_name(source, index: int) -> str:
    from repro_torch.graph.shard import ShardedLog, sharded_log_name

    if isinstance(source, MemmapLog):
        # same rule as repository_from_memmap provenance (core.streaming)
        return memmap_log_name(source)
    if isinstance(source, ShardedLog):
        return sharded_log_name(source)
    if isinstance(source, EventRepository):
        if len(source.log_names) == 1:
            return source.log_names[0]
        return "+".join(source.log_names)
    return f"log{index}"


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


def source_kind(source) -> str:
    # local import: graph.shard depends on core + sharding only — no cycle
    from repro_torch.graph.shard import ShardedLog

    if isinstance(source, EventRepository):
        return "repository"
    if isinstance(source, MemmapLog):
        return "memmap"
    if isinstance(source, ShardedLog):
        return "sharded"
    if isinstance(source, UnionSource):
        return "union(" + ",".join(b.kind for b in source.branches) + ")"
    if isinstance(source, (LogRef, FromLogs)):
        return source.kind
    raise QueryPlanError(
        f"unsupported query source {type(source).__name__}; "
        "expected EventRepository, MemmapLog, ShardedLog, or a "
        "source-algebra node"
    )


@dataclasses.dataclass(frozen=True)
class LogicalPlan:
    source: str  # "repository" | "memmap" | "sharded" | "union(...)"
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

    def describe(self) -> str:
        ops = " → ".join(
            f"{type(o).__name__}{dataclasses.astuple(o) if not isinstance(o, ApplyView) else (len(o.mapping),)}"
            for o in self.ops
        ) or "(no ops)"
        return f"{self.source} → {ops} → {type(self.sink).__name__}"


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
        if isinstance(source, (LogRef, FromLogs)):
            # a single named/selected source executes as its resolution —
            # the wrapper only matters inside a UnionSource
            source = source.resolve()
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
        """Cross-log comparison (requires a ``Q.logs(...)`` source): per-log
        Ψ + difference matrices + replay-fitness drift vs the first log."""
        return self._run(CompareSink(backend=backend))

    # -- introspection -------------------------------------------------------
    def logical_plan(self, sink: Sink) -> LogicalPlan:
        return LogicalPlan(self._kind, self.ops, sink)

    def explain(self, sink: Optional[Sink] = None, after=None) -> str:
        """Planner-side explanation; pass ``after=`` a prior
        :class:`QueryResult` (or its trace) to diff prediction vs. what
        actually ran."""
        from .execute import default_engine

        engine = self._engine or default_engine()
        return engine.explain(self, sink or DFGSink(), after=after)


class Q:
    """Entry point: ``Q.log(repo_or_memmap)`` or ``Q.logs(a, b, ...)``."""

    @staticmethod
    def log(source) -> Query:
        return Query(source)

    @staticmethod
    def logs(*sources, names: Optional[Sequence[str]] = None) -> Query:
        """Multi-source entry point — builds a :class:`UnionSource`.

        Accepted shapes:

        * ``Q.logs(a, b, ...)`` — each argument an ``EventRepository`` /
          ``MemmapLog`` (auto-named), a ``(source, name)`` pair, or a
          prebuilt ``LogRef`` / ``FromLogs`` / ``UnionSource`` (flattened);
        * ``Q.logs(repo)`` with a *multi-log* repository — one branch per
          entry of ``repo.log_names`` (cross-deployment compare without
          pre-splitting);
        * ``Q.logs(repo, names=["prod", "canary"])`` — ``FromLogs``
          selection of the named logs, one branch each.
        """
        if not sources:
            raise QueryPlanError("Q.logs() needs at least one source")
        # (branch, explicitly_named) — explicit duplicates are an error (a
        # tenant naming the same log twice would silently double-count);
        # only auto-derived collisions (two memmaps sharing a basename) are
        # uniquified with a suffix
        branches: List[Tuple[object, bool]] = []
        if names is not None or (
            len(sources) == 1
            and isinstance(sources[0], EventRepository)
            and len(sources[0].log_names) > 1
        ):
            if names is not None and (
                len(sources) != 1 or not isinstance(sources[0], EventRepository)
            ):
                raise QueryPlanError(
                    "Q.logs(..., names=...) takes exactly one multi-log "
                    "repository"
                )
            siblings = tuple(
                str(n) for n in (
                    names if names is not None else sources[0].log_names
                )
            )
            shared: Dict[str, EventRepository] = {}
            branches = [
                (FromLogs(sources[0], (n,), _sibling_split=shared,
                          _siblings=siblings), True)
                for n in siblings
            ]
        else:
            for i, s in enumerate(sources):
                if isinstance(s, UnionSource):
                    branches.extend((b, True) for b in s.branches)
                elif isinstance(s, (LogRef, FromLogs)):
                    branches.append((s, True))
                elif isinstance(s, tuple) and len(s) == 2:
                    branches.append((LogRef(s[0], str(s[1])), True))
                else:
                    branches.append(
                        (LogRef(s, _default_branch_name(s, i)), False)
                    )
        seen: Dict[str, int] = {}
        named: List[object] = []
        for b, explicit in branches:
            n = seen.get(b.name)
            if n is None:
                seen[b.name] = 1
                named.append(b)
                continue
            if explicit:
                raise QueryPlanError(
                    f"duplicate branch name {b.name!r}; name each log "
                    "uniquely (or drop the duplicate)"
                )
            fresh = f"{b.name}#{n}"
            while fresh in seen:  # '#n' may itself be a taken basename
                n += 1
                fresh = f"{b.name}#{n}"
            seen[b.name] = n + 1
            seen[fresh] = 1
            # only bare leaves are auto-named, so b is always a LogRef here
            named.append(LogRef(b.source, fresh))
        return Query(UnionSource(named))
