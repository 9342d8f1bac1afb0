"""Query execution: one engine, every physical backend of the port.

``QueryEngine.run`` takes a fluent :class:`~repro_torch.query.ast.Query`
plus a sink, canonicalizes the logical plan
(:mod:`repro_torch.query.optimize`), consults the plan/result cache
(:mod:`repro_torch.query.cache`), picks a physical plan
(:mod:`repro_torch.query.planner`), and dispatches to the execution
primitives:

* ``dfg_numpy`` on the host, or scatter | onehot | the ``dfg_count`` CUDA
  kernel on the engine's device,
* the fused ``dfg_count_diced`` CUDA kernel when the window pushes into the
  kernel's WHERE clause,
* a :class:`StreamingDFGMiner` scan over a :class:`MemmapLog` with the time
  window pushed to a row range via the chunk time index,
* the event-knowledge graph store (:mod:`repro_torch.graph`), built once
  per source on the engine's device and then answering topology and
  histogram sinks as CSR lookups,
* materialization barriers (``top_variants`` / ``activities(relink=True)``)
  applied in order on the host, after which the sink runs on the
  repository they made — a DFG on the same device path as any other — and
  the variant table (``variants()``) built on the host,
* conformance (:mod:`repro_torch.conformance`): token replay on the host
  over the columns, a streaming scan or the graph's event tables, and
  alignments whose per-variant DP runs on the engine's device (the
  ``align_dp`` CUDA kernel on a card),
* union sources (``Q.logs``): one sub-query per branch through
  :meth:`QueryEngine.run` itself (so each branch keeps its own cache entry,
  backend and delta path), merged on the aligned union vocabulary — or,
  for what does not distribute, the canonical concatenation,
* the **delta** path: when a memmap source is *proven* (prefix-preserving
  fingerprint) to be an append-only extension of a cached streaming scan,
  the cached state resumes over just the appended suffix — or, when the
  plan's window lies inside the old range, the cached result is served
  with no scan at all (free rewrite).

Every path produces values bit-identical to the reference package's engine
on the same source and chain.  The engine runs on ``cuda`` unless it is
built with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.lockdep import make_lock
from repro_torch.conformance.align import AlignmentResult, align_arrays
from repro_torch.conformance.replay import (
    StreamingModelDiscoverer,
    StreamingReplayer,
    replay_fitness_arrays,
)
from repro_torch.core.conformance import ModelSpec, ReplayResult
from repro_torch.core.dfg import dfg_numpy, dfg_onehot, dfg_scatter
from repro_torch.core.dicing import dice_repository, pair_mask_for_window
from repro_torch.core.discovery import DiscoveredModel, discover_dependency_graph
from repro_torch.core.repository import EventRepository, concat_repositories
from repro_torch.core.streaming import MemmapLog, StreamingDFGMiner, memmap_log_name
from repro_torch.core.variants import trace_variants, variant_filtered_repository
from repro_torch.core.views import HIDDEN
from repro_torch.device import resolve_device
from repro_torch.graph.build import EventGraph, csr_from_dense
from repro_torch.graph.store import GraphStore
from repro_torch.graph.traverse import derive_neighborhood, derive_process_map
from repro_torch.kernels.dfg_count import ops as _ops
from repro_torch.obs import MetricsRegistry, QueryTrace
from repro_torch.obs.context import mint_context

from .ast import (
    CONFORMANCE_SINKS,
    TOPOLOGY_SINKS,
    Activities,
    ApplyView,
    CompareSink,
    DFGSink,
    FitnessSink,
    HistogramSink,
    LogicalPlan,
    NeighborhoodSink,
    ProcessMapSink,
    Query,
    QueryPlanError,
    Sink,
    TopVariants,
    UnionSource,
    VariantsSink,
    Window,
    is_barrier,
    union_activity_names,
)
from .cache import (
    QueryCache,
    ResumableState,
    fingerprint,
    parse_memmap_fingerprint,
    prefix_digest,
    realpath_of,
)
from .optimize import canonicalize, compose_views, distribute_over_union
from .planner import (
    GRAPH_REPEAT_CROSSOVER,
    MEMORY_BUDGET_EVENTS,
    REPLAY_STREAMING_CROSSOVER,
    TINY_PAIRS,
    PhysicalPlan,
    SourceInfo,
    device_memory_budget,
    plan_physical,
    source_info,
)

__all__ = [
    "QueryResult",
    "CompareResult",
    "EngineStats",
    "QueryEngine",
    "default_engine",
    "set_default_engine",
    "repository_from_memmap",
]


@dataclasses.dataclass
class QueryResult:
    """What a terminal query call returns.

    ``value`` is the sink's payload, on the host: the int64 Ψ matrix, the
    int64 per-activity histogram, a :class:`~repro_torch.graph.ProcessMap`,
    a :class:`~repro_torch.graph.Neighborhood`, a
    :class:`~repro_torch.conformance.ReplayResult` or an
    :class:`~repro_torch.conformance.AlignmentResult`; ``names`` labels its
    activity axis.
    """

    value: object
    names: Optional[List[str]]
    logical: LogicalPlan
    physical: PhysicalPlan
    from_cache: bool
    wall_s: float
    rewrites: Tuple[str, ...] = ()
    # per-query execution trace (repro_torch.obs), always attached
    trace: Optional[QueryTrace] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # trace id of the execution that produced this value (kept by cached
    # copies, so a hit links back to the run that populated the cache)
    source_trace_id: Optional[str] = dataclasses.field(
        default=None, compare=False
    )


@dataclasses.dataclass
class EngineStats:
    """Point-in-time snapshot of the engine's counters (the live values sit
    in the engine's lock-protected :class:`MetricsRegistry`)."""

    queries: int = 0
    executions: int = 0  # backend runs (cache misses, incl. delta scans)
    cache_hits: int = 0
    delta_hits: int = 0  # append-only: resumed cached state over the suffix
    delta_free_hits: int = 0  # append-only + window inside old range: no scan
    rows_scanned: int = 0  # source rows fed to scans and graph builds
    union_queries: int = 0  # multi-source (Q.logs) queries, incl. compare
    graph_queries: int = 0  # answered from the CSR event-knowledge graph
    conformance_queries: int = 0  # fitness / alignments sinks


@dataclasses.dataclass
class CompareResult:
    """What :meth:`Query.compare` returns (as ``QueryResult.value``).

    All matrices share one aligned (visible) activity axis ``names``.
    ``diffs[i] = psis[i] - psis[0]`` — the Ψ-drift of log ``i`` against the
    first (reference) log; ``fitness[i]`` is the replay fitness of log
    ``i``'s traces on the dependency graph discovered from the reference
    log (out-of-budget memmap branches replay in one streaming scan, so no
    branch reports None).  Windows/filters/views shape the Ψ matrices;
    fitness is a whole-log conformance signal.
    """

    log_names: Tuple[str, ...]
    names: List[str]
    psis: Tuple[np.ndarray, ...]
    diffs: Tuple[np.ndarray, ...]
    fitness: Tuple[float, ...]

    @property
    def diff(self) -> np.ndarray:
        """The two-log drift matrix (``psis[1] - psis[0]``)."""
        if len(self.psis) != 2:
            raise ValueError(
                f"diff is defined for exactly two logs (got "
                f"{len(self.psis)}); index diffs[] instead"
            )
        return self.diffs[1]

    def drift(self, i: int = 0, j: int = 1) -> np.ndarray:
        return self.psis[j] - self.psis[i]


def repository_from_memmap(
    log: MemmapLog, log_name: Optional[str] = None
) -> EventRepository:
    """Materialize an in-budget memmap log as a canonical EventRepository.

    Stays numeric end to end (no per-event Python strings): the columns are
    already int32/float64, so canonicalization is one lexsort + one unique,
    both on the host.  The planner's budget gate keeps this
    O(memory_budget_events).

    ``log_name`` (default: derived from the memmap path) becomes the
    repository's single ``log_names`` entry.
    """
    acts, cases, times = [], [], []
    for a, c, t in log.iter_chunks():
        acts.append(a)
        cases.append(c)
        times.append(t)
    a = np.concatenate(acts) if acts else np.zeros((0,), np.int32)
    c = np.concatenate(cases) if cases else np.zeros((0,), np.int32)
    t = np.concatenate(times) if times else np.zeros((0,), np.float64)
    n = a.shape[0]
    # canonical order: trace-contiguous, time-sorted within trace, stable
    order = np.lexsort((np.arange(n), t, c))
    a, c, t = a[order], c[order], t[order]
    uniq_cases, trace_col = np.unique(c, return_inverse=True)
    return EventRepository(
        event_activity=a.astype(np.int32),
        event_trace=trace_col.astype(np.int32),
        event_time=t,
        trace_log=np.zeros(uniq_cases.shape[0], dtype=np.int32),
        activity_names=list(log.activity_labels()),
        trace_names=[f"case_{int(x)}" for x in uniq_cases],
        log_names=[log_name or memmap_log_name(log)],
    )


#: materialized memmap repositories an engine keeps (tenants alternating
#: over a few in-budget logs each keep their load)
_REPO_MEMO_SIZE = 4
#: default conformance models an engine keeps (one per source and
#: transform; a sliding-window dashboard reuses one)
_MODEL_MEMO_SIZE = 16
#: compare() fitness tuples an engine keeps (one per union fingerprint)
_FITNESS_MEMO_SIZE = 16


# ---------------------------------------------------------------------------
# Collected per-plan execution state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Collected:
    repo: Optional[EventRepository]
    window: Optional[Window] = None
    keep: Optional[Tuple[str, ...]] = None
    view: Optional[ApplyView] = None


def _validate_keep(keep, names) -> None:
    unknown = set(keep) - set(names)
    if unknown:
        raise QueryPlanError(f"unknown activities in filter: {sorted(unknown)}")


def _collect(repo: Optional[EventRepository], logical: LogicalPlan) -> _Collected:
    """Apply materializing ops in order; fold pure predicates.

    Pure predicates (Window / paper-semantics Activities) are WHERE clauses
    evaluated at the sink; materializing ops (TopVariants, relink dicing)
    transform the store they are chained on — ``repo`` (``None`` for the
    paths the planner keeps barrier-free: streaming and the graph store).

    The folding here is not redundant with :func:`canonicalize`: the
    optimizer fuses predicates only *within* a barrier-free segment, while
    at execution time predicates from every segment land on the same sink
    and are intersected — ``window(a,b) → top_variants(k) → window(c,d)``
    reaches here as two Window ops.
    """
    st = _Collected(repo=repo)
    for op in logical.ops:
        if is_barrier(op) and st.view is not None:
            # naive left-to-right semantics would materialize the
            # *projected* store; repositories are not relabeled, so ranking
            # or filtering raw activities instead would change the answer
            raise QueryPlanError(
                "view() before a materializing op (top_variants / "
                "relink) is not supported: apply the view last"
            )
        if isinstance(op, TopVariants):
            st.repo = variant_filtered_repository(st.repo, op.k)
        elif isinstance(op, Activities) and op.relink:
            _validate_keep(op.keep, st.repo.activity_names)
            st.repo = dice_repository(st.repo, activities=list(op.keep))
        elif isinstance(op, Window):
            st.window = op if st.window is None else st.window.intersect(op)
        elif isinstance(op, Activities):
            if st.view is not None:
                raise QueryPlanError(
                    "activities() after view() is not supported: filters "
                    "name raw activities; apply them before the view"
                )
            st.keep = (
                op.keep if st.keep is None
                else tuple(sorted(set(st.keep) & set(op.keep)))
            )
        elif isinstance(op, ApplyView):
            st.view = op if st.view is None else compose_views(st.view, op)
        else:
            raise QueryPlanError(f"unknown op {op!r}")
    return st


def _zero_outside(psi: np.ndarray, keep_ids: np.ndarray) -> np.ndarray:
    mask = np.zeros(psi.shape[0], dtype=bool)
    mask[keep_ids] = True
    out = psi.copy()
    out[~mask, :] = 0
    out[:, ~mask] = 0
    return out


def _finish_dfg(psi: np.ndarray, names: List[str], st: _Collected):
    """Post-mask + project a raw Ψ (shared by streaming, the graph store and
    the empty-window short-circuit)."""
    if st.keep is not None:
        keep_ids = np.asarray([names.index(a) for a in st.keep], np.int64)
        psi = _zero_outside(psi, keep_ids)
    if st.view is not None:
        view = st.view.to_view()
        return view.apply_to_dfg(psi, names), view.visible_names(names)
    return psi, names


def _finish_hist(counts: np.ndarray, names: List[str], st: _Collected):
    """Post-mask + project raw per-activity counts."""
    if st.keep is not None:
        keep_ids = np.asarray([names.index(a) for a in st.keep], np.int64)
        km = np.zeros(len(names), dtype=bool)
        km[keep_ids] = True
        counts = np.where(km, counts, 0)
    if st.view is not None:
        g, labels = st.view.to_view().group_matrix(names)
        counts = counts @ g
        vis = [i for i, l in enumerate(labels) if l != HIDDEN]
        return counts[vis], [labels[i] for i in vis]
    return counts, names


def _check_center(sink: NeighborhoodSink, names: List[str]) -> None:
    if sink.activity not in names:
        raise QueryPlanError(
            f"unknown activity {sink.activity!r} for neighborhood(); "
            "under a view, name a visible group label"
        )


def _finish_topology(
    psi_raw: np.ndarray,
    counts_raw: np.ndarray,
    names: List[str],
    st: _Collected,
    sink: Sink,
):
    """Mask/project a raw Ψ (+ raw node counts) and derive the topology
    sink's value.  Every execution path (graph, columnar, streaming)
    funnels through this + the same derive functions, so backend
    equivalence reduces to Ψ equivalence."""
    psi_v, names_v = _finish_dfg(psi_raw, names, st)
    if isinstance(sink, ProcessMapSink):
        counts_v, _ = _finish_hist(counts_raw, names, st)
        value = derive_process_map(
            csr_from_dense(psi_v), counts_v, names_v, sink.top, sink.edge_top,
        )
        return value, names_v
    _check_center(sink, names_v)
    adj = csr_from_dense(psi_v)
    value = derive_neighborhood(
        adj, adj.transpose(), names_v, sink.activity, sink.k, sink.direction,
    )
    return value, names_v


def _activities_in(repo: EventRepository, window: Optional[Window]):
    """The activity ids of the repository's events inside ``window`` (of
    every event without one)."""
    if window is None:
        return repo.event_activity
    ts = repo.event_time
    return repo.event_activity[(ts >= window.t0) & (ts < window.t1)]


def _host_free_bytes() -> int:
    """The host's free memory (``os.sysconf``), for the engine's budget."""
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class QueryEngine:
    """Plans, caches, and executes logical query plans in-store.

    ``device`` is where counting runs (``"cuda"`` by default; ``"cpu"`` runs
    the same plans with the kernels' plain versions).  A CUDA device on a
    host without a card raises ``RuntimeError``.

    ``memory_budget_events`` (the events above which a memmap log is mined
    out-of-core and its graph is topology-only) defaults, on a card, to
    :func:`~repro_torch.query.planner.device_memory_budget` of the card's
    and the host's free memory as they stand when the engine is built, and
    on the CPU to :data:`~repro_torch.query.planner.MEMORY_BUDGET_EVENTS`;
    an explicit integer always wins.  ``engine.memory_budget_events`` holds
    the value chosen.  ``graph_crossover`` is the number of topology-query
    misses on one source after which ``auto`` builds and serves its
    event-knowledge graph; ``max_graphs`` and ``graph_spill_dir`` size the
    engine's :class:`~repro_torch.graph.GraphStore`.  ``replay_crossover``
    (default :data:`~repro_torch.query.planner.REPLAY_STREAMING_CROSSOVER`)
    is the memmap size above which ``auto`` fitness replays in one
    streaming scan instead of materializing."""

    def __init__(
        self,
        *,
        device="cuda",
        tiny_pairs: int = TINY_PAIRS,
        memory_budget_events: Optional[int] = None,
        graph_crossover: int = GRAPH_REPEAT_CROSSOVER,
        max_graphs: int = 8,
        graph_spill_dir: Optional[str] = None,
        replay_crossover: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        self.tiny_pairs = tiny_pairs
        if memory_budget_events is None:
            if self.device.type == "cuda":
                free, _ = torch.cuda.mem_get_info(self.device)
                memory_budget_events = device_memory_budget(
                    free, _host_free_bytes()
                )
            else:
                memory_budget_events = MEMORY_BUDGET_EVENTS
        self.memory_budget_events = int(memory_budget_events)
        self.graph_crossover = graph_crossover
        self.replay_crossover = (
            REPLAY_STREAMING_CROSSOVER
            if replay_crossover is None
            else int(replay_crossover)
        )
        self.metrics = MetricsRegistry()
        m = self.metrics
        self._c_queries = m.counter(
            "engine_queries_total", "Queries run (also the query-id sequence)"
        )
        self._c_executions = m.counter(
            "engine_executions_total", "Backend executions (cache misses)"
        )
        self._c_cache_hits = m.counter(
            "engine_cache_hits_total", "Queries served from the result cache"
        )
        self._c_delta_hits = m.counter(
            "engine_delta_hits_total",
            "Append-only queries resumed over just the suffix",
        )
        self._c_delta_free_hits = m.counter(
            "engine_delta_free_hits_total",
            "Append-only queries answered without any scan (window predates "
            "the append)",
        )
        self._c_rows = m.counter(
            "engine_rows_scanned_total",
            "Source rows fed to scans and graph builds",
        )
        self._c_union = m.counter(
            "engine_union_queries_total",
            "Multi-source (Q.logs) queries, incl. compare",
        )
        self._c_graph = m.counter(
            "engine_graph_queries_total",
            "Queries answered from the CSR event-knowledge graph",
        )
        self._c_conformance = m.counter(
            "engine_conformance_queries_total",
            "Conformance (fitness / alignments) queries",
        )
        self._h_replay_chunk = m.histogram(
            "replay_chunk_seconds", "Streaming-replay chunk wall time"
        )
        self._h_delta_fraction = m.histogram(
            "delta_suffix_fraction",
            "Fraction of the log rescanned by a delta resume",
        )
        # hot-path memo of query_latency_seconds{sink,backend} histograms
        self._lat_hists: Dict[Tuple[str, str], object] = {}  # guarded by _lock
        self._tls = threading.local()
        self.cache = QueryCache()
        # built graphs keyed by source fingerprint, built on the engine's
        # device; appends extend the CSR over the proven suffix
        self.graphs = GraphStore(
            max_graphs=max_graphs,
            memory_budget_events=self.memory_budget_events,
            metrics=self.metrics,
            spill_dir=graph_spill_dir,
            device=self.device,
        )
        # per-source topology-query (miss) counter feeding the crossover
        self._topo_seen: "OrderedDict[str, int]" = OrderedDict()  # guarded by _lock
        self._max_topo_seen = 512
        # physical plans depend only on (canonical plan, source shape, graph
        # availability), not on data bytes; LRU-bounded like the cache
        self._plans: "OrderedDict[Tuple[str, SourceInfo, bool], PhysicalPlan]" = (
            OrderedDict()
        )  # guarded by _lock
        self._max_plans = 512
        # materialized memmap repos keyed by source fingerprint
        self._repo_memo: "OrderedDict[str, EventRepository]" = OrderedDict()  # guarded by _lock
        # default conformance models keyed by (source fingerprint, transform)
        self._model_memo: "OrderedDict[Tuple, ModelSpec]" = OrderedDict()  # guarded by _lock
        # compare() fitness per composite union fingerprint (a whole-log
        # signal: one entry serves every window/filter/view over the union)
        self._fitness_memo: "OrderedDict[str, Tuple]" = OrderedDict()  # guarded by _lock
        self._lock = make_lock("QueryEngine")

    @property
    def stats(self) -> EngineStats:
        return EngineStats(
            queries=self._c_queries.value,
            executions=self._c_executions.value,
            cache_hits=self._c_cache_hits.value,
            delta_hits=self._c_delta_hits.value,
            delta_free_hits=self._c_delta_free_hits.value,
            rows_scanned=self._c_rows.value,
            union_queries=self._c_union.value,
            graph_queries=self._c_graph.value,
            conformance_queries=self._c_conformance.value,
        )

    # -- tracing ---------------------------------------------------------------
    def _trace_begin(self, qid: int, sink: Sink, source) -> QueryTrace:
        """Open a query's trace on this thread's trace *stack*: a union's
        branch sub-queries run through :meth:`run` while the union's own
        trace stays open beneath them, so each level attributes its rows
        and device phases to itself and branches chain under the union."""
        if isinstance(source, UnionSource):
            kind = "union"
        elif isinstance(source, MemmapLog):
            kind = "memmap"
        else:
            kind = "repository"
        label = type(sink).__name__.lower()
        tr = QueryTrace(qid, label[:-4] if label.endswith("sink") else label, kind)
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        if stack and stack[-1].trace_id is not None:
            tr.bind_child_of(stack[-1].context)
        else:
            tr.bind_root(mint_context())
        stack.append(tr)
        return tr

    def _current_trace(self) -> Optional[QueryTrace]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def _trace_abort(self, tr: QueryTrace) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] is tr:
            stack.pop()

    def _trace_error(self, tr: QueryTrace) -> None:
        """Error path: pop the trace and close its open spans."""
        self._trace_abort(tr)
        tr.finish()

    def _note_rows(self, n: int) -> None:
        """Row-scan accounting: the global counter plus attribution to the
        query currently executing on this thread (union branches attribute
        to their own trace; helper scans to the enclosing query)."""
        if n <= 0:
            return
        self._c_rows.inc(n)
        tr = self._current_trace()
        if tr is not None:
            tr.rows_scanned += n

    def _note_seconds(self, phase: str, seconds: float) -> None:
        """Device-path phase time (materialize, h2d, kernel, d2h), summed
        into the current trace's ``notes`` as ``<phase>_s``."""
        tr = self._current_trace()
        if tr is not None:
            key = f"{phase}_s"
            tr.notes[key] = tr.notes.get(key, 0.0) + seconds

    def _observe_replay_chunk(self, seconds: float, rows: int) -> None:
        self._h_replay_chunk.observe(seconds)

    def _trace_finish(self, tr: QueryTrace, result: QueryResult) -> None:
        self._trace_abort(tr)
        tr.finish()
        result.trace = tr
        key = (tr.sink, tr.executed_backend or "unknown")
        hist = self._lat_hists.get(key)
        if hist is None:
            with self._lock:
                hist = self._lat_hists.get(key)
                if hist is None:
                    hist = self._lat_hists[key] = self.metrics.histogram(
                        "query_latency_seconds",
                        "Per-query wall time by sink and executed backend",
                        sink=key[0], backend=key[1],
                    )
        hist.observe(tr.total_s, trace_id=tr.trace_id)

    # -- public --------------------------------------------------------------
    def run(self, query: Query, sink: Sink) -> QueryResult:
        if isinstance(query.source, UnionSource):
            return self._run_union(query, sink)
        qid = self._c_queries.inc()
        if isinstance(sink, CONFORMANCE_SINKS):
            self._c_conformance.inc()
        tr = self._trace_begin(qid, sink, query.source)
        try:
            s = tr.begin("parse")
            info = source_info(query.source)
            logical, rewrites = canonicalize(
                query.logical_plan(sink), info.activity_names
            )
            key = (fingerprint(query.source), logical.key())
            tr.end(s)
            s = tr.begin("cache_probe")
            cached = self.cache.get(key)
            tr.end(s)
            if cached is not None:
                cached.from_cache = True
                self._c_cache_hits.inc()
                tr.from_cache = True
                tr.planned_backend = cached.physical.backend
                tr.executed_backend = "cache"
                if cached.source_trace_id:
                    tr.links["produced_by"] = cached.source_trace_id
                self._trace_finish(tr, cached)
                # report this hit's own latency, not the original execution's
                cached.wall_s = tr.total_s
                return cached

            if logical.source == "memmap":
                delta = self._try_delta(
                    query.source, logical, key, tuple(rewrites), tr
                )
                if delta is not None:
                    self._trace_finish(tr, delta)
                    if delta.from_cache:  # free rewrite: hit-style latency
                        delta.wall_s = tr.total_s
                    return delta

            s = tr.begin("plan")
            graph_available = self._graph_available(
                query.source, key[0], logical
            )
            physical = self._plan_cached(logical, info, graph_available)
            tr.end(s)
            tr.planned_backend = physical.backend

            s = tr.begin("scan")
            t0 = time.perf_counter()
            value, names, resume = self._execute(
                query.source, logical, physical, source_fp=key[0]
            )
            wall = time.perf_counter() - t0
            tr.end(s)
            self._c_executions.inc()
            tr.executed_backend = physical.backend
            tr.actual_cost_s = wall
            result = QueryResult(
                value=value, names=names, logical=logical, physical=physical,
                from_cache=False, wall_s=wall, rewrites=tuple(rewrites),
                source_trace_id=tr.trace_id,
            )
            s = tr.begin("sink")
            self.cache.put(
                key, result, resume=resume,
                source_hint=self._source_hint(query.source),
            )
            tr.end(s)
            self._trace_finish(tr, result)
            return result
        except BaseException:
            self._trace_error(tr)
            raise

    def _conformance_graph_ok(self, source) -> bool:
        """Conformance can use the graph tier only when the graph carries
        event tables — out-of-core sources build topology-only graphs."""
        return not (
            isinstance(source, MemmapLog)
            and source.num_events > self.memory_budget_events
        )

    def _graph_available(self, source, fp: str, logical: LogicalPlan) -> bool:
        """The planner's amortization signal: is the event-knowledge graph
        of this source built (or provably extendable over an append), or has
        this source crossed the repeat-query count where building one pays?
        Counts only topology/conformance cache *misses* — every hit is
        already O(1), so repeats that matter are the ones that would
        rescan."""
        if logical.has_barrier() or isinstance(source, UnionSource):
            # union branches make their own per-source decision
            return False
        if isinstance(logical.sink, CONFORMANCE_SINKS):
            if not self._conformance_graph_ok(source):
                return False
        elif not isinstance(logical.sink, TOPOLOGY_SINKS):
            return False
        if self.graphs.peek(fp) or self.graphs.has_extendable(source):
            return True
        with self._lock:
            n = self._topo_seen.get(fp, 0) + 1
            self._topo_seen[fp] = n
            self._topo_seen.move_to_end(fp)
            while len(self._topo_seen) > self._max_topo_seen:
                self._topo_seen.popitem(last=False)
        return n >= self.graph_crossover

    def _plan_cached(
        self, logical: LogicalPlan, info: SourceInfo, graph_available: bool
    ) -> PhysicalPlan:
        """LRU-memoized physical planning (plans depend only on the canonical
        plan + source shape + graph availability, never on data bytes)."""
        plan_key = (logical.key(), info, graph_available)
        with self._lock:
            physical = self._plans.get(plan_key)
            if physical is not None:
                self._plans.move_to_end(plan_key)
                return physical
        physical = plan_physical(
            logical, info,
            device_type=self.device.type,
            tiny_pairs=self.tiny_pairs,
            memory_budget_events=self.memory_budget_events,
            graph_available=graph_available,
            replay_crossover=self.replay_crossover,
        )
        with self._lock:
            self._plans[plan_key] = physical
            while len(self._plans) > self._max_plans:
                self._plans.popitem(last=False)
        return physical

    # -- union / compare (multi-source) --------------------------------------
    @staticmethod
    def _branch_names_of(source) -> List[str]:
        if isinstance(source, EventRepository):
            return list(source.activity_names)
        return source.activity_labels()

    @staticmethod
    def _align_ids(branch_names: List[str], union_names: List[str]) -> np.ndarray:
        uidx = {n: i for i, n in enumerate(union_names)}
        return np.asarray([uidx[n] for n in branch_names], dtype=np.int64)

    def _run_union(self, query: Query, sink: Sink) -> QueryResult:
        """Execute a :class:`UnionSource` plan.

        Distributive sinks (DFG / histogram / topology / compare /
        conformance) run one sub-query per branch through :meth:`run`
        itself — so every branch gets its own cache entry, its own
        cost-model choice (the card's kernels where it plans them), and its
        own append-aware delta path (an append to one log rescans only that
        log's suffix; the other branches are plain cache hits).  Branch
        results are then aligned onto the union activity vocabulary and
        merged; activity masks and views run once at the merge
        (:func:`~repro_torch.query.optimize.distribute_over_union`).

        Non-distributive plans (variants sink, materializing ops) run on the
        canonical concatenated repository instead (budget-gated by the
        planner).
        """
        union: UnionSource = query.source
        qid = self._c_queries.inc()
        self._c_union.inc()
        if isinstance(sink, CONFORMANCE_SINKS):
            self._c_conformance.inc()
        tr = self._trace_begin(qid, sink, union)
        try:
            s = tr.begin("parse")
            # derived from unresolved branch metadata: a cache hit must not
            # pay an O(E) FromLogs materialization
            union_names = union_activity_names(union)
            logical, rewrites = canonicalize(
                query.logical_plan(sink), union_names
            )
            fp = fingerprint(union)
            key = (fp, logical.key())
            tr.end(s)
            s = tr.begin("cache_probe")
            cached = self.cache.get(key)
            tr.end(s)
            if cached is not None:
                cached.from_cache = True
                self._c_cache_hits.inc()
                tr.from_cache = True
                tr.planned_backend = cached.physical.backend
                tr.executed_backend = "cache"
                if cached.source_trace_id:
                    tr.links["produced_by"] = cached.source_trace_id
                self._trace_finish(tr, cached)
                cached.wall_s = tr.total_s
                return cached

            # miss: resolve the branches (FromLogs memoizes its L×T dice)
            s = tr.begin("plan")
            info = source_info(union)
            physical = self._plan_cached(logical, info, False)
            tr.end(s)
            tr.planned_backend = physical.backend

            s = tr.begin("merge")
            t0 = time.perf_counter()
            if physical.backend == "concat":
                value, names = self._execute_concat(union, info, logical, fp)
            else:
                st = _collect(None, logical)  # planner-guaranteed barrier-free
                if st.keep is not None:
                    _validate_keep(st.keep, union_names)
                empty = st.window is not None and st.window.empty
                if isinstance(logical.sink, CompareSink):
                    value, names = self._execute_compare(
                        union, logical, st, union_names, empty=empty,
                        union_fp=fp,
                    )
                elif isinstance(logical.sink, CONFORMANCE_SINKS):
                    value, names = self._execute_conformance_union(
                        union, logical, st, union_names
                    )
                else:
                    value, names = self._execute_union_merge(
                        union, logical, st, union_names, empty=empty
                    )
            wall = time.perf_counter() - t0
            tr.end(s)
            self._c_executions.inc()
            tr.executed_backend = physical.backend
            tr.actual_cost_s = wall
            result = QueryResult(
                value=value, names=names, logical=logical, physical=physical,
                from_cache=False, wall_s=wall, rewrites=tuple(rewrites),
                source_trace_id=tr.trace_id,
            )
            s = tr.begin("sink")
            self.cache.put(key, result)
            tr.end(s)
            self._trace_finish(tr, result)
            return result
        except BaseException:
            self._trace_error(tr)
            raise

    def _run_branch(self, branch, src, ops: Tuple, sink: Sink) -> QueryResult:
        """One branch's sub-query through :meth:`run`, its trace attached to
        the enclosing (union) trace."""
        cur = self._current_trace()
        sub = self.run(Query(src, ops, self), sink)
        if cur is not None and sub.trace is not None:
            cur.add_branch(branch.name, sub.trace)
        return sub

    def _branch_raw(
        self,
        union: UnionSource,
        logical: LogicalPlan,
        branch_sink: Optional[Sink] = None,
    ):
        """Per-branch *raw* sink values (window pushed down, no mask/view),
        each via a full :meth:`run` so caching + delta apply per branch."""
        branch_ops, _merge = distribute_over_union(logical)
        if branch_sink is None:
            if isinstance(logical.sink, HistogramSink):
                branch_sink = HistogramSink()
            else:  # DFG, compare, and topology sinks all count per-branch Ψ
                branch_sink = DFGSink(backend=logical.sink.backend)
        out = []
        for branch in union.branches:
            src = branch.resolve()
            sub = self._run_branch(branch, src, branch_ops, branch_sink)
            out.append((branch, src, sub.value))
        return out

    def _merged_psi(
        self, union: UnionSource, logical: LogicalPlan,
        union_names: List[str], *, empty: bool,
    ) -> np.ndarray:
        u = len(union_names)
        psi = np.zeros((u, u), dtype=np.int64)
        if not empty:
            for _branch, src, value in self._branch_raw(union, logical):
                t0 = time.perf_counter()
                ids = self._align_ids(self._branch_names_of(src), union_names)
                psi[np.ix_(ids, ids)] += value
                self._note_seconds("merge", time.perf_counter() - t0)
        return psi

    def _merged_counts(
        self, union: UnionSource, logical: LogicalPlan,
        union_names: List[str], *, empty: bool,
    ) -> np.ndarray:
        counts = np.zeros(len(union_names), dtype=np.int64)
        if not empty:
            for _branch, src, value in self._branch_raw(
                union, logical, HistogramSink()
            ):
                ids = self._align_ids(self._branch_names_of(src), union_names)
                counts[ids] += value
        return counts

    def _execute_union_merge(
        self,
        union: UnionSource,
        logical: LogicalPlan,
        st: _Collected,
        union_names: List[str],
        *,
        empty: bool,
    ):
        if isinstance(logical.sink, DFGSink):
            psi = self._merged_psi(union, logical, union_names, empty=empty)
            return _finish_dfg(psi, union_names, st)
        if isinstance(logical.sink, (ProcessMapSink, NeighborhoodSink)):
            # branch Ψ (and, for process maps, branch histograms) merge on
            # the union vocabulary; the derivation runs once at the merge.
            # A process map issues two sub-queries per branch (DFG +
            # histogram): both are plain single-log entries the cache and
            # the delta path reuse across every sink type
            psi = self._merged_psi(union, logical, union_names, empty=empty)
            counts = (
                self._merged_counts(union, logical, union_names, empty=empty)
                if isinstance(logical.sink, ProcessMapSink)
                else np.zeros(len(union_names), dtype=np.int64)
            )
            return _finish_topology(psi, counts, union_names, st, logical.sink)
        counts = self._merged_counts(union, logical, union_names, empty=empty)
        return _finish_hist(counts, union_names, st)

    @staticmethod
    def _branch_conformance_ops(
        ops: Tuple, branch_names: List[str]
    ) -> Tuple:
        """Distribute conformance (sequence-semantics) ops into one branch:
        every op applies per event, but an activity filter may name
        union-level activities a branch has never seen — intersect it with
        the branch vocabulary so branch validation passes (the missing
        names could not have matched any of the branch's events anyway)."""
        out = []
        for op in ops:
            if isinstance(op, Activities):
                out.append(Activities(
                    tuple(sorted(set(op.keep) & set(branch_names))),
                    op.relink,
                ))
            else:
                out.append(op)
        return tuple(out)

    def _model_for_source(
        self, sink, ops: Tuple, src, st: _Collected
    ) -> ModelSpec:
        """Resolve the (default) model for one concrete source — the union
        and compare paths' entry into the per-fingerprint model memo.  The
        memo key carries ``st``'s folded keep/view, so a view-governed
        resolution never aliases a raw one on the same source."""
        fp = fingerprint(src)

        def build():
            if isinstance(src, EventRepository):
                repo = src
            elif src.num_events <= self.memory_budget_events:
                repo = self._materialize(src, fp)
            else:
                names = src.activity_labels()
                dest, out_names = self._transform_tables(st, names)
                return self._streaming_default_model(src, dest, out_names)
            names = list(repo.activity_names)
            dest, out_names = self._transform_tables(st, names)
            acts = repo.event_activity.astype(np.int64)
            traces = repo.event_trace
            if dest is not None:
                tacts = dest[acts]
                m = tacts >= 0
                acts, traces = tacts[m], traces[m]
            return self._model_from_arrays(acts, traces, out_names)

        return self._resolve_model(sink, self._model_key(ops, st), fp, build)

    def _execute_conformance_union(
        self,
        union: UnionSource,
        logical: LogicalPlan,
        st: _Collected,
        union_names: List[str],
    ):
        """Fitness/alignments over a union: one shared model (explicit, or
        the reference branch's discovered model — compare() semantics),
        then one sub-query per branch through :meth:`run` so each branch
        keeps its own cache entry and append-aware delta path (an
        alignment's DP runs per branch, on the card).  Traces never span
        branches, so the merge concatenates the per-trace arrays in branch
        order and sums the censuses."""
        sink = logical.sink
        spec = (
            sink.model
            if sink.model is not None
            else self._model_for_source(
                sink, logical.ops, union.branches[0].resolve(), st
            )
        )
        pinned = dataclasses.replace(sink, model=spec)
        results = []
        for branch in union.branches:
            src = branch.resolve()
            ops = self._branch_conformance_ops(
                logical.ops, self._branch_names_of(src)
            )
            results.append(self._run_branch(branch, src, ops, pinned).value)
        t0 = time.perf_counter()
        _dest_u, out_names = self._transform_tables(st, union_names)

        def cat(arrays, dtype):
            arrays = [a for a in arrays if a.shape[0]]
            return (
                np.concatenate(arrays) if arrays
                else np.zeros((0,), dtype=dtype)
            )

        census: Dict = {}
        for r in results:
            for edge, c in r.deviating_edges.items():
                census[edge] = census.get(edge, 0) + c
        if isinstance(sink, FitnessSink):
            tf = cat([r.trace_fitness for r in results], np.float64)
            value = ReplayResult(
                fitness=float(tf.mean()) if tf.shape[0] else 1.0,
                trace_fitness=tf,
                perfectly_fitting=sum(r.perfectly_fitting for r in results),
                deviating_edges=census,
            )
        else:
            fit = cat([r.trace_fitness for r in results], np.float64)
            value = AlignmentResult(
                fitness=float(fit.mean()) if fit.shape[0] else 1.0,
                trace_cost=cat([r.trace_cost for r in results], np.int64),
                trace_fitness=fit,
                variant_costs=cat(
                    [r.variant_costs for r in results], np.int64
                ),
                perfectly_fitting=sum(r.perfectly_fitting for r in results),
                empty_cost=results[0].empty_cost,
                deviating_edges=census,
            )
        self._note_seconds("merge", time.perf_counter() - t0)
        return value, out_names

    def _execute_compare(
        self,
        union: UnionSource,
        logical: LogicalPlan,
        st: _Collected,
        union_names: List[str],
        *,
        empty: bool,
        union_fp: str,
    ):
        u = len(union_names)
        aligned = []
        if empty:
            aligned = [np.zeros((u, u), np.int64) for _ in union.branches]
        else:
            for _branch, src, value in self._branch_raw(union, logical):
                t0 = time.perf_counter()
                psi = np.zeros((u, u), dtype=np.int64)
                ids = self._align_ids(self._branch_names_of(src), union_names)
                psi[np.ix_(ids, ids)] += value
                aligned.append(psi)
                self._note_seconds("merge", time.perf_counter() - t0)

        vis_names: Optional[List[str]] = None
        psis = []
        for psi in aligned:
            v, names = _finish_dfg(psi, union_names, st)
            psis.append(v)
            vis_names = names  # identical per branch: same union axis + view
        value = CompareResult(
            log_names=union.branch_names,
            names=list(vis_names),
            psis=tuple(psis),
            diffs=tuple(p - psis[0] for p in psis),
            # whole-log signal, independent of window/filter/view — served
            # from the per-fingerprint memo when the data hasn't changed
            fitness=self._compare_fitness(union, union_fp),
        )
        return value, list(vis_names)

    def _compare_fitness(
        self, union: UnionSource, union_fp: str
    ) -> Tuple[float, ...]:
        """Replay-fitness drift: every branch replayed against the dependency
        graph discovered from the first (reference) branch.

        The value depends only on the union's data (never on the plan's
        window/filter/view), so it is memoized per composite fingerprint —
        a dashboard sliding its window re-uses the same tuple."""
        with self._lock:
            hit = self._fitness_memo.get(union_fp)
            if hit is not None:
                self._fitness_memo.move_to_end(union_fp)
                return hit
        fitness = self._compute_compare_fitness(union)
        with self._lock:
            self._fitness_memo[union_fp] = fitness
            while len(self._fitness_memo) > _FITNESS_MEMO_SIZE:
                self._fitness_memo.popitem(last=False)
        return fitness

    def _compute_compare_fitness(
        self, union: UnionSource
    ) -> Tuple[float, ...]:
        """Whole-log replay fitness of every branch against the reference
        branch's discovered model.  The model comes from the per-fingerprint
        model memo (discovery runs once per data generation), and each
        branch replays through :meth:`run` — in-budget branches
        materialize, out-of-budget memmap branches replay in one streaming
        scan, so no branch ever reports ``None``."""
        raw = _Collected(repo=None)  # whole-log, untransformed signal
        spec = self._model_for_source(
            FitnessSink(), (), union.branches[0].resolve(), raw
        )
        pinned = FitnessSink(model=spec)
        out = []
        for branch in union.branches:
            src = branch.resolve()
            sub = self._run_branch(branch, src, (), pinned)
            out.append(float(sub.value.fitness))
        return tuple(out)

    def _execute_concat(
        self,
        union: UnionSource,
        info: SourceInfo,
        logical: LogicalPlan,
        fp: str,
    ):
        """Non-distributive union plans run on the materialized canonical
        concatenation (memoized per composite fingerprint ``fp``)."""
        with self._lock:
            repo_u = self._repo_memo.get(fp)
            if repo_u is not None:
                self._repo_memo.move_to_end(fp)
        if repo_u is None:
            named = []
            for branch in union.branches:
                src = branch.resolve()
                if isinstance(src, MemmapLog):
                    t0 = time.perf_counter()
                    src = self._materialize(
                        src, fingerprint(src), branch.name
                    )
                    self._note_seconds(
                        "materialize", time.perf_counter() - t0
                    )
                named.append((branch.name, src))
            t0 = time.perf_counter()
            repo_u = concat_repositories(
                named, activity_vocab=list(info.activity_names)
            )
            self._note_seconds("concat", time.perf_counter() - t0)
            with self._lock:
                self._repo_memo[fp] = repo_u
                while len(self._repo_memo) > _REPO_MEMO_SIZE:
                    self._repo_memo.popitem(last=False)
        # single-source execution on the concatenation, planned on its shape
        inner = LogicalPlan("repository", logical.ops, logical.sink)
        physical = self._plan_cached(inner, source_info(repo_u), False)
        value, names, _resume = self._execute(
            repo_u, inner, physical, source_fp=fp
        )
        return value, names

    # -- delta (append-aware) ------------------------------------------------
    @staticmethod
    def _source_hint(source) -> Optional[str]:
        """Stable identity for delta-candidate lookup.  Only a hint: a path
        reused for unrelated data fails the prefix-digest proof and falls
        back to a full execution."""
        if isinstance(source, MemmapLog):
            return realpath_of(source)
        return None

    def _try_delta(
        self,
        log: MemmapLog,
        logical: LogicalPlan,
        key: Tuple[str, str],
        rewrites: Tuple[str, ...],
        tr: QueryTrace,
    ) -> Optional[QueryResult]:
        """Append-aware path for a cache miss on a memmap source.

        If the cache holds this plan's result for a *prefix* of ``log`` —
        proven by recomputing the prefix digest on the current bytes, never
        assumed from the path hint — then either:

        * the plan's row range lies entirely inside the proven prefix
          (window over old data): the cached result is the recompute, serve
          it without any scan; or
        * resume the cached streaming state (Ψ + per-case tails, histogram
          counts, or the replayer's per-case state) over just the appended
          suffix — the carried tails link the pairs that straddle the append
          boundary, so the result is bit-identical to a full rescan.
        """
        fp_new, plan_key = key
        if logical.has_barrier() or not isinstance(
            logical.sink, (DFGSink, HistogramSink, FitnessSink)
        ):
            return None
        if (
            isinstance(logical.sink, FitnessSink)
            and logical.sink.model is None
        ):
            # the default model is re-discovered from the *grown* log; the
            # cached state replayed against the old model would not be
            # bit-identical to a recompute — full replay instead
            return None
        hint = self._source_hint(log)
        cand = self.cache.delta_candidate(hint, plan_key)
        if cand is None:
            return None
        s = tr.begin("delta")
        try:
            old_fp, old_result, resume = cand
            old = parse_memmap_fingerprint(old_fp)
            if old is None or not 0 < old.num_events < log.num_events:
                return None
            if old.num_activities > log.num_activities:
                return None  # vocabulary shrank: not an append-only change
            if prefix_digest(log, old.num_events) != old.prefix:
                # rewritten / truncated-and-regrown: stop consulting this
                # hint
                self.cache.drop_hint(hint, plan_key)
                return None

            st = _collect(None, logical)  # barrier-free: no repo needed
            names = log.activity_labels()
            if st.keep is not None:
                _validate_keep(st.keep, names)
            if st.window is not None and st.window.empty:
                return None  # the zero-result short-circuit is cheaper
            lo, hi = (
                log.rows_for_window(st.window.t0, st.window.t1)
                if st.window is not None
                else (0, log.num_events)
            )

            if (
                hi <= old.num_events
                and old.num_activities == log.num_activities
            ):
                # free rewrite: every row the plan can touch lies in the
                # proven prefix, so the cached result *is* the recompute,
                # bit for bit
                old_result.from_cache = True
                self._c_delta_free_hits.inc()
                tr.from_cache = True
                tr.planned_backend = "delta"
                tr.executed_backend = "delta_free"
                tr.delta_rows = (old.num_events, old.num_events)
                if old_result.source_trace_id:
                    tr.links["produced_by"] = old_result.source_trace_id
                # republish under the new fingerprint: the next run is a
                # plain hit
                self.cache.put(
                    key, old_result, resume=resume, source_hint=hint
                )
                return old_result

            if resume is None or resume.rows_end > old.num_events:
                return None
            if (
                isinstance(logical.sink, FitnessSink)
                and resume.replay is None
            ):
                return None
            start = max(resume.rows_end, lo)
            tr.planned_backend = "delta"
            tr.delta_rows = (start, hi)
            if log.num_events:
                self._h_delta_fraction.observe(
                    max(hi - start, 0) / log.num_events
                )
            t0 = time.perf_counter()
            value, out_names, new_resume = self._execute_delta(
                log, logical, st, resume, start, hi
            )
            wall = time.perf_counter() - t0
            tr.executed_backend = "delta"
            tr.actual_cost_s = wall
            physical = PhysicalPlan(
                backend="delta",
                row_range_window=(
                    (st.window.t0, st.window.t1)
                    if st.window is not None
                    else None
                ),
                activities_as_output_mask=st.keep is not None,
                delta_rows=(start, hi),
                notes=(f"resume@{start}", f"suffix_rows={hi - start}"),
            )
            self._c_executions.inc()
            self._c_delta_hits.inc()
            result = QueryResult(
                value=value, names=out_names, logical=logical,
                physical=physical, from_cache=False, wall_s=wall,
                rewrites=rewrites, source_trace_id=tr.trace_id,
            )
            self.cache.put(key, result, resume=new_resume, source_hint=hint)
            return result
        finally:
            tr.end(s)

    def _execute_delta(
        self,
        log: MemmapLog,
        logical: LogicalPlan,
        st: _Collected,
        resume: ResumableState,
        start: int,
        hi: int,
    ):
        """Resume ``resume`` over rows ``[start, hi)``: ``(value, names,
        new resume)`` — the new state only when the scan reached the log's
        last row."""
        names = log.activity_labels()
        self._note_rows(max(hi - start, 0))
        a = log.num_activities
        to_end = hi == log.num_events
        if isinstance(logical.sink, FitnessSink):
            dest, out_names = self._transform_tables(st, names)
            rep = StreamingReplayer.restore(
                resume.replay, out_names, logical.sink.model,
                observer=self._observe_replay_chunk,
            )
            for c_a, c_c, c_t in log.iter_chunks(row_range=(start, hi)):
                rep.update(*self._apply_stream_transform(dest, c_a, c_c, c_t))
            new_resume = (
                ResumableState(rows_end=hi, num_activities=a,
                               replay=rep.snapshot())
                if to_end else None
            )
            return rep.finalize(), out_names, new_resume
        if isinstance(logical.sink, DFGSink):
            miner = StreamingDFGMiner.restore(resume.miner, num_activities=a)
            for c_a, c_c, c_t in log.iter_chunks(row_range=(start, hi)):
                miner.update(c_a, c_c, c_t)
            new_resume = (
                ResumableState(rows_end=hi, num_activities=a,
                               miner=miner.snapshot())
                if to_end else None
            )
            value, out_names = _finish_dfg(miner.finalize(), names, st)
            return value, out_names, new_resume
        counts = np.zeros(a, dtype=np.int64)
        counts[: resume.num_activities] = resume.counts
        for c_a, _, _ in log.iter_chunks(row_range=(start, hi)):
            counts += np.bincount(c_a, minlength=a)
        new_resume = (
            ResumableState(rows_end=hi, num_activities=a,
                           counts=counts.copy())
            if to_end else None
        )
        value, out_names = _finish_hist(counts, names, st)
        return value, out_names, new_resume

    # -- execution -----------------------------------------------------------
    def _execute(
        self, source, logical: LogicalPlan, physical: PhysicalPlan,
        source_fp: Optional[str] = None,
    ):
        """``(value, names, resume)``: ``resume`` is the
        :class:`ResumableState` a streaming scan leaves when it consumed the
        log through its last row (None on every other path)."""
        if not logical.has_barrier():
            # the planner sends barrier plans to neither the graph store
            # nor a streaming scan
            st = _collect(None, logical)
            if (
                st.window is not None and st.window.empty
                and isinstance(logical.sink, (HistogramSink,) + TOPOLOGY_SINKS)
            ):
                # an empty window can select no pair or event: zeros of
                # the right shape, without materializing or scanning
                # anything.  Conformance and variants score an empty
                # selection on their backend.
                value, names = self._empty_result(source, logical, st)
                return value, names, None
            if physical.backend == "graph":
                value, names = self._execute_graph(
                    source, logical, st, source_fp
                )
                return value, names, None
            if physical.backend == "streaming":
                return self._execute_streaming(
                    source, logical, physical, st, source_fp
                )
        value, names = self._execute_on_repo(
            source, logical, physical, source_fp
        )
        return value, names, None

    def _execute_on_repo(
        self, source, logical: LogicalPlan, physical: PhysicalPlan,
        source_fp: Optional[str],
    ):
        """The columnar backends: on the repository (a memmap source
        materialized first), after any barriers."""
        if logical.source == "memmap":
            t0 = time.perf_counter()
            repo = self._materialize(source, source_fp)
            self._note_seconds("materialize", time.perf_counter() - t0)
        else:
            repo = source
        t0 = time.perf_counter()
        st = _collect(repo, logical)
        if logical.has_barrier():
            self._note_seconds("barrier", time.perf_counter() - t0)
        # full-scan backends read every event of the materialized repo
        self._note_rows(repo.num_events)
        if st.keep is not None:
            _validate_keep(st.keep, st.repo.activity_names)
        sink = logical.sink
        if isinstance(sink, DFGSink):
            return self._dfg_on_repo(st, physical)
        if isinstance(sink, HistogramSink):
            return self._histogram_on_repo(st)
        if isinstance(sink, VariantsSink):
            return self._variants_on_repo(st, sink)
        if isinstance(sink, CONFORMANCE_SINKS):
            repo = st.repo
            return self._conformance_from_columns(
                logical, st, source_fp,
                repo.event_activity, repo.event_trace, repo.event_time,
                repo.num_traces, list(repo.activity_names),
            )
        return self._topology_on_repo(st, sink, physical)

    def _empty_result(self, source, logical: LogicalPlan, st: _Collected):
        names = (
            list(source.activity_labels())
            if logical.source == "memmap"
            else list(source.activity_names)
        )
        if st.keep is not None:
            _validate_keep(st.keep, names)
        a = len(names)
        zeros_psi = np.zeros((a, a), dtype=np.int64)
        if isinstance(logical.sink, (ProcessMapSink, NeighborhoodSink)):
            return _finish_topology(
                zeros_psi, np.zeros(a, dtype=np.int64), names, st,
                logical.sink,
            )
        if isinstance(logical.sink, HistogramSink):
            return _finish_hist(np.zeros(a, dtype=np.int64), names, st)
        return _finish_dfg(zeros_psi, names, st)

    def _materialize(
        self,
        log: MemmapLog,
        fp: Optional[str],
        log_name: Optional[str] = None,
    ) -> EventRepository:
        if fp is not None:
            with self._lock:
                repo = self._repo_memo.get(fp)
                if repo is not None:
                    self._repo_memo.move_to_end(fp)
                    if log_name is not None and repo.log_names != [log_name]:
                        # same bytes, different branch name: share the
                        # columns, fix the provenance
                        repo = dataclasses.replace(repo, log_names=[log_name])
                    return repo
        repo = repository_from_memmap(log, log_name)
        if fp is not None:
            with self._lock:
                self._repo_memo[fp] = repo
                while len(self._repo_memo) > _REPO_MEMO_SIZE:
                    self._repo_memo.popitem(last=False)
        return repo

    def _dfg_on_repo(self, st: _Collected, physical: PhysicalPlan):
        repo = st.repo
        names = list(repo.activity_names)
        # pairs are (act[i], act[i+1]): the count takes the one activity
        # column and reads src and dst as shifted views of it
        act = repo.event_activity
        _, _, valid = repo.df_pairs()
        window_fused = physical.fused_dicing and st.window is not None

        if st.window is not None and not window_fused:
            valid = valid & pair_mask_for_window(repo, (st.window.t0, st.window.t1))
        keep_ids = None
        if st.keep is not None:
            keep_ids = np.asarray(
                [names.index(a) for a in st.keep], dtype=np.int64
            )
            if not physical.activities_as_output_mask:
                m = np.isin(repo.event_activity, keep_ids)
                if m.shape[0] >= 2:
                    valid = valid & m[:-1] & m[1:]

        if physical.view_pushdown:
            g, labels = st.view.to_view().group_matrix(names)
            gmap = np.argmax(g, axis=1).astype(np.int32)
            act = gmap[act]
            a_count = len(labels)
        else:
            a_count = repo.num_activities

        psi = self._count(act, valid, a_count, st, physical, repo)

        if physical.view_pushdown:
            vis = [i for i, l in enumerate(labels) if l != HIDDEN]
            return psi[np.ix_(vis, vis)], [labels[i] for i in vis]
        if keep_ids is not None and physical.activities_as_output_mask:
            psi = _zero_outside(psi, keep_ids)
        if st.view is not None:
            view = st.view.to_view()
            return view.apply_to_dfg(psi, names), view.visible_names(names)
        return psi, names

    def _count(
        self, act, valid, a_count, st: _Collected,
        physical: PhysicalPlan, repo: EventRepository,
    ) -> np.ndarray:
        """Ψ over the pairs ``(act[i], act[i+1])`` with ``valid[i]``."""
        backend = physical.backend
        if backend == "numpy":
            act = np.asarray(act)
            return dfg_numpy(act[:-1], act[1:], np.asarray(valid), a_count)
        dev = self.device
        t0 = time.perf_counter()
        act_d = torch.from_numpy(np.ascontiguousarray(act, np.int32)).to(dev)
        src_d, dst_d = act_d[:-1], act_d[1:]
        valid_d = torch.from_numpy(np.ascontiguousarray(valid, bool)).to(dev)
        fused = (
            backend == "kernel" and physical.fused_dicing
            and st.window is not None
        )
        if fused:
            ts_d = torch.from_numpy(repo.event_time).to(dev)
        _sync(dev)
        t1 = time.perf_counter()
        self._note_seconds("h2d", t1 - t0)
        if fused:
            out = _ops.dfg_count_diced(
                src_d, dst_d, valid_d, ts_d[:-1], ts_d[1:],
                (st.window.t0, st.window.t1),
                num_activities=a_count,
            )
        elif backend == "kernel":
            out = _ops.dfg_count(src_d, dst_d, valid_d, num_activities=a_count)
        elif backend == "scatter":
            out = dfg_scatter(src_d, dst_d, valid_d, num_activities=a_count)
        elif backend == "onehot":
            out = dfg_onehot(src_d, dst_d, valid_d, num_activities=a_count)
        else:
            raise QueryPlanError(f"unknown backend {backend!r}")
        _sync(dev)
        t2 = time.perf_counter()
        psi = out.cpu().numpy()
        self._note_seconds("kernel", t2 - t1)
        self._note_seconds("d2h", time.perf_counter() - t2)
        return psi

    def _histogram_on_repo(self, st: _Collected):
        repo = st.repo
        counts = np.bincount(
            _activities_in(repo, st.window), minlength=repo.num_activities
        )
        return _finish_hist(
            counts.astype(np.int64), list(repo.activity_names), st
        )

    def _variants_on_repo(self, st: _Collected, sink: VariantsSink):
        """The variant table of the (barrier-made) repository.  For a
        variant table pure predicates must change the *sequences*, so a
        window or activity filter runs with re-linking semantics here.
        ``k`` truncates the variants (counts and sequences), never
        ``trace_variant``."""
        if st.view is not None:
            raise QueryPlanError("view() is not supported for variants()")
        repo = st.repo
        if st.window is not None or st.keep is not None:
            repo = dice_repository(
                repo,
                time_window=(
                    (st.window.t0, st.window.t1) if st.window else None
                ),
                activities=list(st.keep) if st.keep else None,
            )
        tv = trace_variants(repo)
        if sink.k is not None:
            n = len(range(tv.num_variants)[: sink.k])
            off = tv.variant_offsets[: n + 1]
            tv = dataclasses.replace(
                tv,
                counts=tv.counts[:n],
                variant_offsets=off,
                variant_activity=tv.variant_activity[: off[-1]],
            )
        return tv, None

    def _topology_on_repo(
        self, st: _Collected, sink: Sink, physical: PhysicalPlan
    ):
        """Columnar path for process map / neighborhood: count Ψ on the
        planned backend (window as pair predicate or fused into the
        kernel), raw node counts alongside, then the shared derivation."""
        repo = st.repo
        _, _, valid = repo.df_pairs()
        if st.window is not None and not physical.fused_dicing:
            valid = valid & pair_mask_for_window(
                repo, (st.window.t0, st.window.t1)
            )
        psi = self._count(
            repo.event_activity, valid, repo.num_activities, st, physical,
            repo,
        )
        counts = np.bincount(
            _activities_in(repo, st.window), minlength=repo.num_activities
        )
        return _finish_topology(
            psi, counts.astype(np.int64), list(repo.activity_names), st, sink
        )

    # -- graph (event-knowledge-graph store) ---------------------------------
    def _execute_graph(
        self, source, logical: LogicalPlan, st: _Collected,
        source_fp: Optional[str],
    ):
        """Topology and histogram sinks answered from the CSR graph store.

        The graph is built once per source fingerprint on the engine's
        device (appends extend it over the proven suffix) and then:

        * un-windowed, un-filtered plans are pure lookups — DFG densifies
          the CSR, neighborhood/process map walk it directly, a histogram
          reads the ``:OF_TYPE`` degrees;
        * filters/views post-process the densified Ψ exactly like the
          streaming finishers (count-preserving, pinned bit-identical);
        * a window needs the event-level tables (full graphs only), served
          by the graph's :class:`~repro_torch.graph.build.WindowIndex`.
        """
        fp = source_fp if source_fp is not None else fingerprint(source)
        g = self.graphs.graph_for(source, fp, on_rows=self._note_rows)
        self._c_graph.inc()
        names = list(g.activity_names)
        if st.keep is not None:
            _validate_keep(st.keep, names)
        if isinstance(logical.sink, CONFORMANCE_SINKS):
            # replay/align over the stored event tables — the canonical
            # :BELONGS_TO order makes each case a contiguous segment whose
            # :DF steps are adjacent rows; no source re-materialization
            if not g.has_event_tables:
                raise QueryPlanError(
                    "conformance needs event tables; this graph is "
                    "topology-only (built out-of-core) — use streaming/auto"
                )
            return self._conformance_from_columns(
                logical, st, fp,
                g.event_activity, g.event_trace, g.event_time,
                g.num_traces, names,
            )
        windowed = st.window is not None
        if windowed and not g.has_event_tables:
            raise QueryPlanError(
                "windowed graph queries need event tables; this graph is "
                "topology-only (built out-of-core) — use streaming/auto"
            )
        sink = logical.sink
        if isinstance(sink, HistogramSink):
            counts = (
                self._windowed_from_tables(g, st.window, need_psi=False)[1]
                if windowed else np.asarray(g.node_counts)
            )
            return _finish_hist(counts, names, st)
        plain = not windowed and st.keep is None and st.view is None
        if plain and isinstance(sink, NeighborhoodSink):
            _check_center(sink, names)
            value = derive_neighborhood(
                g.adj, g.radj, names, sink.activity, sink.k, sink.direction,
            )
            return value, names
        if plain and isinstance(sink, ProcessMapSink):
            value = derive_process_map(
                g.adj, g.node_counts, names, sink.top, sink.edge_top,
            )
            return value, names
        if windowed:
            psi, counts = self._windowed_from_tables(
                g, st.window, need_counts=not isinstance(sink, DFGSink),
            )
        else:
            psi, counts = g.psi(), np.asarray(g.node_counts)
        if isinstance(sink, DFGSink):
            return _finish_dfg(psi, names, st)
        return _finish_topology(psi, counts, names, st, sink)

    @staticmethod
    def _windowed_from_tables(
        g: EventGraph, window: Window, need_psi: bool = True,
        need_counts: bool = True,
    ):
        """(Ψ, node counts) under a time window, from the graph's canonical
        event tables — identical to the columnar pair-endpoint mask.  Either
        half may be skipped (``None``).

        The graph answers through its lazily built
        :class:`~repro_torch.graph.build.WindowIndex` (two binary searches +
        O(window rows)); the masked O(E) path below is the fallback for
        tables the index can't represent."""
        a = g.num_activities
        idx = g.window_index()
        if idx is not None:
            return (
                idx.psi(window.t0, window.t1, a) if need_psi else None,
                idx.counts(window.t0, window.t1, a) if need_counts else None,
            )
        acts = np.asarray(g.event_activity)
        traces = np.asarray(g.event_trace)
        times = np.asarray(g.event_time)
        m = (times >= window.t0) & (times < window.t1)
        counts = (
            np.bincount(acts[m], minlength=a).astype(np.int64)
            if need_counts else None
        )
        if not need_psi:
            return None, counts
        if acts.shape[0] < 2:
            return np.zeros((a, a), dtype=np.int64), counts
        valid = (traces[:-1] == traces[1:]) & m[:-1] & m[1:]
        return dfg_numpy(acts[:-1], acts[1:], valid, a), counts

    # -- streaming (out-of-core) ---------------------------------------------
    def _execute_streaming(
        self, log: MemmapLog, logical: LogicalPlan, physical: PhysicalPlan,
        st: _Collected, source_fp: Optional[str] = None,
    ):
        names = log.activity_labels()
        if st.keep is not None:
            _validate_keep(st.keep, names)
        if isinstance(logical.sink, FitnessSink):
            return self._streaming_conformance(
                log, logical, physical, st, names, source_fp
            )
        # the planner owns the row-range pushdown decision; consume it here
        # so describe() always reflects what actually runs
        window = physical.row_range_window
        rng = log.rows_for_window(*window) if window else (0, log.num_events)
        self._note_rows(max(rng[1] - rng[0], 0))
        a = log.num_activities
        sink = logical.sink
        # a DFG or histogram scan that consumed the log through its last row
        # is resumable across future appends (the miner's per-case tails
        # link pairs straddling the append boundary)
        to_end = rng[1] == log.num_events
        if isinstance(sink, HistogramSink):
            counts = np.zeros(a, dtype=np.int64)
            for acts, _, _ in log.iter_chunks(row_range=rng):
                counts += np.bincount(acts, minlength=a)
            resume = (
                ResumableState(rows_end=rng[1], num_activities=a,
                               counts=counts.copy())
                if to_end else None
            )
            value, out_names = _finish_hist(counts, names, st)
            return value, out_names, resume
        # one scan accumulates Ψ (and the node counts a topology sink needs)
        topology = not isinstance(sink, DFGSink)
        miner = StreamingDFGMiner(a)
        counts = np.zeros(a, dtype=np.int64)
        for acts, c, t in log.iter_chunks(row_range=rng):
            miner.update(acts, c, t)
            if topology:
                counts += np.bincount(acts, minlength=a)
        if topology:
            value, out_names = _finish_topology(
                miner.finalize(), counts, names, st, sink
            )
            return value, out_names, None
        resume = (
            ResumableState(rows_end=rng[1], num_activities=a,
                           miner=miner.snapshot())
            if to_end else None
        )
        value, out_names = _finish_dfg(miner.finalize(), names, st)
        return value, out_names, resume


    # -- conformance (fitness / alignments) ----------------------------------
    @staticmethod
    def _transform_tables(st: _Collected, names: List[str]):
        """(dest, out_names) for conformance's sequence semantics: ``dest``
        maps each raw activity id to its transformed id, ``-1`` meaning the
        event is dropped (filtered out / hidden) and its neighbors re-link.
        ``dest=None`` is the identity (no keep / no view)."""
        if st.keep is None and st.view is None:
            return None, list(names)
        a = len(names)
        dest = np.arange(a, dtype=np.int64)
        out_names = list(names)
        if st.keep is not None:
            kept = set(st.keep)
            for i, n in enumerate(names):
                if n not in kept:
                    dest[i] = -1
        if st.view is not None:
            view = st.view.to_view()
            out_names = view.visible_names(names)
            gidx = {g: i for i, g in enumerate(out_names)}
            mapped = np.full(a, -1, dtype=np.int64)
            for i, n in enumerate(names):
                if dest[i] < 0:
                    continue
                g = view.mapping.get(n, view.default)
                mapped[i] = gidx.get(g, -1)  # HIDDEN drops the event
            dest = mapped
        return dest, out_names

    @staticmethod
    def _model_key(ops: Tuple, st: _Collected) -> Tuple:
        """What the default model depends on besides the data: any barrier
        ops (they change the source the model is discovered from) plus the
        *folded* keep/view transform (a view-protected model must not alias
        the raw one).  Windows are left out on purpose: see
        :meth:`_resolve_model`."""
        return (
            tuple(op for op in ops if is_barrier(op)),
            st.keep,
            st.view,
        )

    def _resolve_model(
        self, sink, key_tail: Tuple, fp: Optional[str], build
    ) -> ModelSpec:
        """The sink's model, or the memoized default (discovered from the
        whole source under the plan's transform — windows are a drift
        *question* against the overall process, so a sliding dashboard
        keeps one model per data generation)."""
        if sink.model is not None:
            return sink.model
        key = (fp,) + key_tail
        if fp is not None:
            with self._lock:
                hit = self._model_memo.get(key)
                if hit is not None:
                    self._model_memo.move_to_end(key)
                    return hit
        spec = ModelSpec.from_model(build())
        if fp is not None:
            with self._lock:
                self._model_memo[key] = spec
                while len(self._model_memo) > _MODEL_MEMO_SIZE:
                    self._model_memo.popitem(last=False)
        return spec

    @staticmethod
    def _model_from_arrays(
        acts: np.ndarray, traces: np.ndarray, out_names: List[str]
    ) -> DiscoveredModel:
        """Dependency-graph discovery from (already transformed) canonical
        columns — Ψ plus trace-boundary counts, all vectorized on the
        host."""
        a = len(out_names)
        n = acts.shape[0]
        starts = np.zeros(a, dtype=np.int64)
        ends = np.zeros(a, dtype=np.int64)
        if n == 0:
            psi = np.zeros((a, a), dtype=np.int64)
        else:
            if n >= 2:
                valid = traces[:-1] == traces[1:]
                psi = dfg_numpy(acts[:-1], acts[1:], valid, a)
            else:
                psi = np.zeros((a, a), dtype=np.int64)
            is_start = np.ones(n, dtype=bool)
            is_start[1:] = traces[1:] != traces[:-1]
            is_end = np.ones(n, dtype=bool)
            is_end[:-1] = traces[:-1] != traces[1:]
            np.add.at(starts, acts[is_start], 1)
            np.add.at(ends, acts[is_end], 1)
        return discover_dependency_graph(psi, out_names, starts, ends)

    def _conformance_value(
        self, sink, acts, traces, out_names: List[str], model: ModelSpec,
        num_traces: Optional[int],
    ):
        if isinstance(sink, FitnessSink):
            return replay_fitness_arrays(
                acts, traces, out_names, model, num_traces=num_traces
            )
        # the alignment DP runs on the engine's device: the align_dp CUDA
        # kernel on a card, its plain version on the CPU
        return align_arrays(
            acts, traces, out_names, model, num_traces=num_traces,
            backend="auto", device=self.device,
        )

    def _conformance_from_columns(
        self,
        logical: LogicalPlan,
        st: _Collected,
        source_fp: Optional[str],
        acts: np.ndarray,
        traces: np.ndarray,
        times: np.ndarray,
        num_traces: int,
        names: List[str],
    ):
        """Shared columnar/graph conformance: transform the event columns
        (sequence semantics), resolve the model from the whole selection,
        replay/align the windowed selection."""
        dest, out_names = self._transform_tables(st, names)
        acts = np.asarray(acts).astype(np.int64)
        traces = np.asarray(traces)
        keep_mask = np.ones(acts.shape[0], dtype=bool)
        tacts = acts
        if dest is not None:
            tacts = dest[acts]
            keep_mask &= tacts >= 0
        model = self._resolve_model(
            logical.sink, self._model_key(logical.ops, st), source_fp,
            lambda: self._model_from_arrays(
                tacts[keep_mask], traces[keep_mask], out_names
            ),
        )
        windowed = st.window is not None
        if windowed:
            ts = np.asarray(times)
            keep_mask &= (ts >= st.window.t0) & (ts < st.window.t1)
        transformed = dest is not None or windowed
        value = self._conformance_value(
            logical.sink,
            tacts[keep_mask] if transformed else tacts,
            traces[keep_mask] if transformed else traces,
            out_names, model,
            num_traces=None if transformed else num_traces,
        )
        return value, out_names

    @staticmethod
    def _apply_stream_transform(dest, a, c, t):
        """Sequence-semantics transform of one chunk: drop masked events,
        relabel survivors (re-linking is implicit — the replayer only ever
        sees the surviving stream)."""
        if dest is None:
            return a, c, t
        ta = dest[np.asarray(a).astype(np.int64)]
        m = ta >= 0
        return ta[m], np.asarray(c)[m], np.asarray(t)[m]

    def _streaming_default_model(
        self, log: MemmapLog, dest, out_names: List[str]
    ) -> DiscoveredModel:
        """Whole-log discovery in one O(A² + chunk) scan (memoized by the
        caller per source fingerprint)."""
        disc = StreamingModelDiscoverer(len(out_names))
        rows = 0
        for a, c, t in log.iter_chunks():
            rows += a.shape[0]
            disc.update(*self._apply_stream_transform(dest, a, c, t))
        self._note_rows(rows)
        return disc.finalize(out_names)

    def _streaming_conformance(
        self,
        log: MemmapLog,
        logical: LogicalPlan,
        physical: PhysicalPlan,
        st: _Collected,
        names: List[str],
        source_fp: Optional[str],
    ):
        """One-pass streaming replay (FitnessSink only — alignments need
        the variant table and are budget-gated by the planner)."""
        dest, out_names = self._transform_tables(st, names)
        model = self._resolve_model(
            logical.sink, self._model_key(logical.ops, st), source_fp,
            lambda: self._streaming_default_model(log, dest, out_names),
        )
        if st.window is not None and st.window.empty:
            rng = (0, 0)
        else:
            window = physical.row_range_window
            rng = (
                log.rows_for_window(*window) if window
                else (0, log.num_events)
            )
        self._note_rows(max(rng[1] - rng[0], 0))
        rep = StreamingReplayer(
            out_names, model, observer=self._observe_replay_chunk
        )
        for a, c, t in log.iter_chunks(row_range=rng):
            rep.update(*self._apply_stream_transform(dest, a, c, t))
        resume = None
        if rng[1] == log.num_events and logical.sink.model is not None:
            # resumable only under a pinned model: a default model is
            # re-discovered from the grown log, invalidating old state
            resume = ResumableState(
                rows_end=rng[1], num_activities=log.num_activities,
                replay=rep.snapshot(),
            )
        return rep.finalize(), out_names, resume


# ---------------------------------------------------------------------------
# Shared default engine
# ---------------------------------------------------------------------------

_DEFAULT: Optional[QueryEngine] = None


def default_engine() -> QueryEngine:
    """Process-wide engine (and cache) used by ``Q`` terminals unless a
    query pins its own via :meth:`Query.using`.  It runs on the card."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = QueryEngine()
    return _DEFAULT


def set_default_engine(engine: Optional[QueryEngine]) -> None:
    global _DEFAULT
    _DEFAULT = engine
