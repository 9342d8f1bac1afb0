"""``repro_torch.query`` — the declarative process-query engine.

One entry point::

    from repro_torch.query import Q, QueryEngine

    engine = QueryEngine()          # device="cuda"; "cpu" for the host
    result = Q.log(repo).using(engine).window(t0, t1).view(v).dfg()
    result.value        # the int64 Ψ count matrix
    result.names        # its activity (or group) labels
    result.from_cache   # True when served from the plan/result cache

    Q.log(repo).using(engine).histogram()          # events per activity
    Q.log(repo).using(engine).process_map(top=0.2) # significance-filtered map
    Q.log(repo).using(engine).neighborhood("a", k=2, direction="both")

Topology sinks route to the event-knowledge graph store
(:mod:`repro_torch.graph`) once a source has been queried often enough, or
when pinned with ``backend="graph"``.

The chain compiles to a logical plan (:mod:`repro_torch.query.ast`), is
rewritten by count-preserving rules (:mod:`repro_torch.query.optimize`),
mapped to a physical backend by a small cost model
(:mod:`repro_torch.query.planner`), and executed by
:mod:`repro_torch.query.execute` with an LRU plan/result cache
(:mod:`repro_torch.query.cache`).
"""

from .ast import (
    EMPTY_WINDOW,
    Activities,
    ApplyView,
    DFGSink,
    HistogramSink,
    LogicalPlan,
    NeighborhoodSink,
    ProcessMapSink,
    Q,
    Query,
    QueryPlanError,
    TOPOLOGY_SINKS,
    Window,
)
from .cache import (
    MemmapFingerprint,
    QueryCache,
    fingerprint,
    fingerprint_memmap,
    fingerprint_repository,
    parse_memmap_fingerprint,
)
from .execute import (
    EngineStats,
    QueryEngine,
    QueryResult,
    default_engine,
    repository_from_memmap,
    set_default_engine,
)
from .optimize import canonicalize
from .planner import (
    GRAPH_REPEAT_CROSSOVER,
    PhysicalPlan,
    SourceInfo,
    device_memory_budget,
    plan_physical,
    source_info,
)

__all__ = [
    "Q", "Query", "QueryPlanError",
    "Window", "EMPTY_WINDOW", "Activities", "ApplyView", "DFGSink",
    "HistogramSink", "ProcessMapSink", "NeighborhoodSink", "TOPOLOGY_SINKS",
    "LogicalPlan",
    "QueryCache", "fingerprint", "fingerprint_memmap",
    "fingerprint_repository", "MemmapFingerprint", "parse_memmap_fingerprint",
    "QueryEngine", "QueryResult", "EngineStats",
    "default_engine", "set_default_engine", "repository_from_memmap",
    "canonicalize",
    "plan_physical", "PhysicalPlan", "SourceInfo", "source_info",
    "device_memory_budget", "GRAPH_REPEAT_CROSSOVER",
]
