"""``repro_torch.query`` — the declarative process-query engine.

One entry point::

    from repro_torch.query import Q, QueryEngine

    engine = QueryEngine()          # device="cuda"; "cpu" for the host
    result = Q.log(repo).using(engine).window(t0, t1).view(v).dfg()
    result.value        # the int64 Ψ count matrix
    result.names        # its activity (or group) labels
    result.from_cache   # True when served from the plan/result cache

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
    LogicalPlan,
    Q,
    Query,
    QueryPlanError,
    Window,
)
from .cache import QueryCache, fingerprint, fingerprint_memmap, fingerprint_repository
from .execute import (
    EngineStats,
    QueryEngine,
    QueryResult,
    default_engine,
    repository_from_memmap,
    set_default_engine,
)
from .optimize import canonicalize
from .planner import PhysicalPlan, SourceInfo, plan_physical, source_info

__all__ = [
    "Q", "Query", "QueryPlanError",
    "Window", "EMPTY_WINDOW", "Activities", "ApplyView", "DFGSink",
    "LogicalPlan",
    "QueryCache", "fingerprint", "fingerprint_memmap",
    "fingerprint_repository",
    "QueryEngine", "QueryResult", "EngineStats",
    "default_engine", "set_default_engine", "repository_from_memmap",
    "canonicalize",
    "plan_physical", "PhysicalPlan", "SourceInfo", "source_info",
]
