"""Query execution: one engine, the single-log DFG backends.

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
  window pushed to a row range via the chunk time index.

Every path produces counts bit-identical to the reference package's engine
on the same source and chain.  The engine runs on ``cuda`` unless it is
built with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.kernels.dfg_count import ops as _ops
from repro_torch.obs import MetricsRegistry, QueryTrace
from repro_torch.obs.context import mint_context

from .ast import (
    Activities,
    ApplyView,
    LogicalPlan,
    Query,
    QueryPlanError,
    Sink,
    Window,
)
from .cache import QueryCache, fingerprint
from .optimize import canonicalize, compose_views
from .planner import (
    MEMORY_BUDGET_EVENTS,
    TINY_PAIRS,
    PhysicalPlan,
    SourceInfo,
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

    ``value`` is the sink's payload (the int64 Ψ matrix, on the host);
    ``names`` labels its activity axis.
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
    rows_scanned: int = 0  # memmap rows fed to streaming scans


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
    """Post-mask + project a raw Ψ (shared by streaming and the empty-window
    short-circuit)."""
    if st.keep is not None:
        keep_ids = np.asarray([names.index(a) for a in st.keep], np.int64)
        psi = _zero_outside(psi, keep_ids)
    if st.view is not None:
        view = st.view.to_view()
        return view.apply_to_dfg(psi, names), view.visible_names(names)
    return psi, names


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
    host without a card raises ``RuntimeError``."""

    def __init__(
        self,
        *,
        device="cuda",
        tiny_pairs: int = TINY_PAIRS,
        memory_budget_events: int = MEMORY_BUDGET_EVENTS,
    ):
        self.device = resolve_device(device)
        self.tiny_pairs = tiny_pairs
        self.memory_budget_events = memory_budget_events
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
            "engine_rows_scanned_total", "Memmap rows fed to streaming scans"
        )
        # hot-path memo of query_latency_seconds{sink,backend} histograms
        self._lat_hists: Dict[Tuple[str, str], object] = {}  # guarded by _lock
        self._tls = threading.local()
        self.cache = QueryCache()
        # physical plans depend only on (canonical plan, source shape), not
        # on data bytes; LRU-bounded like the cache
        self._plans: "OrderedDict[Tuple[str, SourceInfo], PhysicalPlan]" = (
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
        )

    # -- tracing ---------------------------------------------------------------
    def _trace_begin(self, qid: int, source) -> QueryTrace:
        kind = "memmap" if isinstance(source, MemmapLog) else "repository"
        tr = QueryTrace(qid, "dfg", kind)
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
        tr = self._trace_begin(qid, query.source)
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
            physical = self._plan_cached(logical, info)
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

    def _plan_cached(
        self, logical: LogicalPlan, info: SourceInfo
    ) -> PhysicalPlan:
        """LRU-memoized physical planning (plans depend only on the canonical
        plan + source shape, never on data bytes)."""
        plan_key = (logical.key(), info)
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
            # an empty window can select no pair: zeros of the right shape,
            # without materializing or scanning anything
            return self._empty_result(source, logical, st)
        if physical.backend == "streaming":
            return self._execute_streaming(source, physical, st)
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
        return self._dfg_on_repo(repo, st, physical)

    def _empty_result(self, source, logical: LogicalPlan, st: _Collected):
        names = (
            list(source.activity_labels())
            if logical.source == "memmap"
            else list(source.activity_names)
        )
        if st.keep is not None:
            _validate_keep(st.keep, names)
        a = len(names)
        return _finish_dfg(np.zeros((a, a), dtype=np.int64), names, st)

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

    # -- streaming (out-of-core) ---------------------------------------------
    def _execute_streaming(
        self, log: MemmapLog, physical: PhysicalPlan, st: _Collected
    ):
        names = log.activity_labels()
        if st.keep is not None:
            _validate_keep(st.keep, names)
        # the planner owns the row-range pushdown decision; consume it here
        # so describe() always reflects what actually runs
        window = physical.row_range_window
        rng = log.rows_for_window(*window) if window else (0, log.num_events)
        self._note_rows(max(rng[1] - rng[0], 0))
        miner = StreamingDFGMiner(log.num_activities)
        for a, c, t in log.iter_chunks(row_range=rng):
            miner.update(a, c, t)
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
