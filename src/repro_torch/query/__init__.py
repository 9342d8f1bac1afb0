"""``repro_torch.query`` — the declarative process-query engine.

One entry point::

    from repro_torch.query import Q, QueryEngine

    engine = QueryEngine()          # device="cuda"; "cpu" for the host
    result = Q.log(repo).using(engine).window(t0, t1).view(v).dfg()
    result.value        # the int64 Ψ count matrix
    result.names        # its activity (or group) labels
    result.from_cache   # True when served from the plan/result cache

    Q.log(repo).using(engine).histogram()          # events per activity
    Q.log(repo).using(engine).variants(10)         # the trace-variant table
    Q.log(repo).using(engine).top_variants(10).dfg()             # mainstream Ψ
    Q.log(repo).using(engine).activities(keep, relink=True).dfg()  # pm4py filter
    Q.log(repo).using(engine).process_map(top=0.2) # significance-filtered map
    Q.log(repo).using(engine).neighborhood("a", k=2, direction="both")
    Q.log(repo).using(engine).fitness(model)       # token-replay fitness
    Q.log(repo).using(engine).alignments()         # optimal DFG alignments
    Q.logs((prod, "prod"), (canary, "canary")).using(engine).dfg()  # union Ψ
    Q.logs((prod, "prod"), (canary, "canary")).using(engine).compare()

``fitness()`` / ``alignments()`` default to the source's own discovered
model; the alignment DP runs on the engine's device (the ``align_dp`` CUDA
kernel on a card).

``Q.logs`` unions several logs (memmaps, repositories, or the named logs
of one multi-log repository): each branch runs as its own query (its own
cache entry and backend, the card's kernels where it plans them) and the
results merge on the sorted union vocabulary; ``compare()`` keeps the
branches apart (per-log Ψ, differences against the first log, replay
fitness against its model).  Re-querying a memmap log after
``MemmapLog.append`` resumes a cached streaming scan over the appended
suffix only (the ``delta`` backend) when the cache holds one.

``top_variants(k)`` and ``activities(keep, relink=True)`` are
materialization barriers: the engine makes the filtered repository on the
host, in chain order, and the sink behind them runs on it (a DFG on the
card, as any other).

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
    CONFORMANCE_SINKS,
    EMPTY_WINDOW,
    Activities,
    AlignmentsSink,
    ApplyView,
    CompareSink,
    DFGSink,
    FitnessSink,
    FromLogs,
    HistogramSink,
    LogicalPlan,
    LogRef,
    ModelSpec,
    NeighborhoodSink,
    ProcessMapSink,
    Q,
    Query,
    QueryPlanError,
    TOPOLOGY_SINKS,
    TopVariants,
    UnionSource,
    VariantsSink,
    Window,
    union_activity_names,
)
from .cache import (
    MemmapFingerprint,
    QueryCache,
    ResumableState,
    fingerprint,
    fingerprint_memmap,
    fingerprint_repository,
    fingerprint_union,
    parse_memmap_fingerprint,
    prefix_digest,
    split_union_fingerprint,
)
from .execute import (
    CompareResult,
    EngineStats,
    PlanProbe,
    QueryEngine,
    QueryResult,
    default_engine,
    memmap_activity_names,
    memmap_log_name,
    repository_from_memmap,
    set_default_engine,
)
from repro_torch.obs import MetricsRegistry, QueryTrace

from .optimize import canonicalize, distribute_over_union
from .planner import (
    GRAPH_REPEAT_CROSSOVER,
    REPLAY_STREAMING_CROSSOVER,
    SHARDED_SINGLE_CROSSOVER,
    PhysicalPlan,
    SourceInfo,
    device_memory_budget,
    load_calibration,
    plan_physical,
    source_info,
)

__all__ = [
    "Q", "Query", "QueryPlanError",
    "Window", "EMPTY_WINDOW", "Activities", "TopVariants", "ApplyView",
    "DFGSink", "HistogramSink", "VariantsSink", "CompareSink",
    "ProcessMapSink", "NeighborhoodSink", "TOPOLOGY_SINKS",
    "FitnessSink", "AlignmentsSink", "CONFORMANCE_SINKS", "ModelSpec",
    "LogicalPlan", "LogRef", "FromLogs", "UnionSource",
    "union_activity_names",
    "QueryCache", "fingerprint", "fingerprint_memmap",
    "fingerprint_repository", "fingerprint_union", "split_union_fingerprint",
    "prefix_digest", "MemmapFingerprint", "parse_memmap_fingerprint",
    "ResumableState",
    "QueryEngine", "QueryResult", "CompareResult", "EngineStats",
    "PlanProbe",
    "MetricsRegistry", "QueryTrace",
    "default_engine", "set_default_engine", "repository_from_memmap",
    "memmap_activity_names", "memmap_log_name",
    "canonicalize", "distribute_over_union",
    "plan_physical", "PhysicalPlan", "SourceInfo", "source_info",
    "load_calibration",
    "device_memory_budget", "GRAPH_REPEAT_CROSSOVER",
    "REPLAY_STREAMING_CROSSOVER", "SHARDED_SINGLE_CROSSOVER",
]
