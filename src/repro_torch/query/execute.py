"""Query execution: one engine, the single-log backends.

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
  histogram sinks as CSR lookups.

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
from repro_torch.core.dfg import dfg_numpy, dfg_onehot, dfg_scatter
from repro_torch.core.dicing import pair_mask_for_window
from repro_torch.core.repository import EventRepository
from repro_torch.core.streaming import MemmapLog, StreamingDFGMiner, memmap_log_name
from repro_torch.core.views import HIDDEN
from repro_torch.device import resolve_device
from repro_torch.graph.build import EventGraph, csr_from_dense
from repro_torch.graph.store import GraphStore
from repro_torch.graph.traverse import derive_neighborhood, derive_process_map
from repro_torch.kernels.dfg_count import ops as _ops
from repro_torch.obs import MetricsRegistry, QueryTrace
from repro_torch.obs.context import mint_context

from .ast import (
    TOPOLOGY_SINKS,
    Activities,
    ApplyView,
    DFGSink,
    HistogramSink,
    LogicalPlan,
    NeighborhoodSink,
    ProcessMapSink,
    Query,
    QueryPlanError,
    Sink,
    Window,
)
from .cache import QueryCache, fingerprint
from .optimize import canonicalize, compose_views
from .planner import (
    GRAPH_REPEAT_CROSSOVER,
    MEMORY_BUDGET_EVENTS,
    TINY_PAIRS,
    PhysicalPlan,
    SourceInfo,
    device_memory_budget,
    plan_physical,
    source_info,
)

__all__ = [
    "QueryResult",
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
    int64 per-activity histogram, a :class:`~repro_torch.graph.ProcessMap`
    or a :class:`~repro_torch.graph.Neighborhood`; ``names`` labels its
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
    executions: int = 0  # backend runs (cache misses)
    cache_hits: int = 0
    rows_scanned: int = 0  # source rows fed to scans and graph builds
    graph_queries: int = 0  # answered from the CSR event-knowledge graph


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


# ---------------------------------------------------------------------------
# Collected per-plan execution state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Collected:
    window: Optional[Window] = None
    keep: Optional[Tuple[str, ...]] = None
    view: Optional[ApplyView] = None


def _validate_keep(keep, names) -> None:
    unknown = set(keep) - set(names)
    if unknown:
        raise QueryPlanError(f"unknown activities in filter: {sorted(unknown)}")


def _collect(logical: LogicalPlan) -> _Collected:
    """Fold the plan's pure predicates (WHERE clauses evaluated at the
    sink)."""
    st = _Collected()
    for op in logical.ops:
        if isinstance(op, Window):
            st.window = op if st.window is None else st.window.intersect(op)
        elif isinstance(op, Activities):
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
    engine's :class:`~repro_torch.graph.GraphStore`."""

    def __init__(
        self,
        *,
        device="cuda",
        tiny_pairs: int = TINY_PAIRS,
        memory_budget_events: Optional[int] = None,
        graph_crossover: int = GRAPH_REPEAT_CROSSOVER,
        max_graphs: int = 8,
        graph_spill_dir: Optional[str] = None,
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
        self._c_rows = m.counter(
            "engine_rows_scanned_total",
            "Source rows fed to scans and graph builds",
        )
        self._c_graph = m.counter(
            "engine_graph_queries_total",
            "Queries answered from the CSR event-knowledge graph",
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
        self._lock = make_lock("QueryEngine")

    @property
    def stats(self) -> EngineStats:
        return EngineStats(
            queries=self._c_queries.value,
            executions=self._c_executions.value,
            cache_hits=self._c_cache_hits.value,
            rows_scanned=self._c_rows.value,
            graph_queries=self._c_graph.value,
        )

    # -- tracing ---------------------------------------------------------------
    def _trace_begin(self, qid: int, sink: Sink, source) -> QueryTrace:
        kind = "memmap" if isinstance(source, MemmapLog) else "repository"
        label = type(sink).__name__.lower()
        tr = QueryTrace(qid, label[:-4] if label.endswith("sink") else label, kind)
        tr.bind_root(mint_context())
        self._tls.trace = tr
        return tr

    def _current_trace(self) -> Optional[QueryTrace]:
        return getattr(self._tls, "trace", None)

    def _note_rows(self, n: int) -> None:
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

    def _trace_finish(self, tr: QueryTrace, result: QueryResult) -> None:
        self._tls.trace = None
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
        qid = self._c_queries.inc()
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

            s = tr.begin("plan")
            graph_available = self._graph_available(
                query.source, key[0], logical
            )
            physical = self._plan_cached(logical, info, graph_available)
            tr.end(s)
            tr.planned_backend = physical.backend

            s = tr.begin("scan")
            t0 = time.perf_counter()
            value, names = self._execute(
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
            self.cache.put(key, result)
            tr.end(s)
            self._trace_finish(tr, result)
            return result
        finally:
            self._tls.trace = None

    def _graph_available(self, source, fp: str, logical: LogicalPlan) -> bool:
        """The planner's amortization signal: is the event-knowledge graph
        of this source built (or provably extendable over an append), or has
        this source crossed the repeat-query count where building one pays?
        Counts only topology cache *misses* — every hit is already O(1), so
        repeats that matter are the ones that would rescan."""
        if not isinstance(logical.sink, TOPOLOGY_SINKS):
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
        )
        with self._lock:
            self._plans[plan_key] = physical
            while len(self._plans) > self._max_plans:
                self._plans.popitem(last=False)
        return physical

    # -- execution -----------------------------------------------------------
    def _execute(
        self, source, logical: LogicalPlan, physical: PhysicalPlan,
        source_fp: Optional[str] = None,
    ):
        st = _collect(logical)
        if st.window is not None and st.window.empty:
            # an empty window can select no pair or event: zeros of the
            # right shape, without materializing or scanning anything
            return self._empty_result(source, logical, st)
        if physical.backend == "graph":
            return self._execute_graph(source, logical, st, source_fp)
        if physical.backend == "streaming":
            return self._execute_streaming(source, logical, physical, st)
        if logical.source == "memmap":
            t0 = time.perf_counter()
            repo = self._materialize(source, source_fp)
            self._note_seconds("materialize", time.perf_counter() - t0)
        else:
            repo = source
        # full-scan backends read every event of the materialized repo
        self._note_rows(repo.num_events)
        if st.keep is not None:
            _validate_keep(st.keep, repo.activity_names)
        if isinstance(logical.sink, DFGSink):
            return self._dfg_on_repo(repo, st, physical)
        if isinstance(logical.sink, HistogramSink):
            return self._histogram_on_repo(repo, st)
        return self._topology_on_repo(repo, st, logical.sink, physical)

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

    def _materialize(self, log: MemmapLog, fp: Optional[str]) -> EventRepository:
        if fp is not None:
            with self._lock:
                repo = self._repo_memo.get(fp)
                if repo is not None:
                    self._repo_memo.move_to_end(fp)
                    return repo
        repo = repository_from_memmap(log)
        if fp is not None:
            with self._lock:
                self._repo_memo[fp] = repo
                while len(self._repo_memo) > _REPO_MEMO_SIZE:
                    self._repo_memo.popitem(last=False)
        return repo

    def _dfg_on_repo(
        self, repo: EventRepository, st: _Collected, physical: PhysicalPlan
    ):
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

    def _histogram_on_repo(self, repo: EventRepository, st: _Collected):
        counts = np.bincount(
            _activities_in(repo, st.window), minlength=repo.num_activities
        )
        return _finish_hist(
            counts.astype(np.int64), list(repo.activity_names), st
        )

    def _topology_on_repo(
        self, repo: EventRepository, st: _Collected, sink: Sink,
        physical: PhysicalPlan,
    ):
        """Columnar path for process map / neighborhood: count Ψ on the
        planned backend (window as pair predicate or fused into the
        kernel), raw node counts alongside, then the shared derivation."""
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
        st: _Collected,
    ):
        names = log.activity_labels()
        if st.keep is not None:
            _validate_keep(st.keep, names)
        # the planner owns the row-range pushdown decision; consume it here
        # so describe() always reflects what actually runs
        window = physical.row_range_window
        rng = log.rows_for_window(*window) if window else (0, log.num_events)
        self._note_rows(max(rng[1] - rng[0], 0))
        a = log.num_activities
        sink = logical.sink
        if isinstance(sink, HistogramSink):
            counts = np.zeros(a, dtype=np.int64)
            for acts, _, _ in log.iter_chunks(row_range=rng):
                counts += np.bincount(acts, minlength=a)
            return _finish_hist(counts, names, st)
        # one scan accumulates Ψ (and the node counts a topology sink needs)
        topology = not isinstance(sink, DFGSink)
        miner = StreamingDFGMiner(a)
        counts = np.zeros(a, dtype=np.int64)
        for acts, c, t in log.iter_chunks(row_range=rng):
            miner.update(acts, c, t)
            if topology:
                counts += np.bincount(acts, minlength=a)
        if topology:
            return _finish_topology(miner.finalize(), counts, names, st, sink)
        return _finish_dfg(miner.finalize(), names, st)


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
