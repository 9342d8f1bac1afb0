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
engine with a mesh        ``distributed`` — each mesh position counts its
                          shard of the pairs, the (A, A) partials are summed
                          over the mesh's axes
engine on the CPU         ``scatter`` (torch ``index_put_``)
engine on a CUDA card     ``kernel`` — the hand-written CUDA count; a time
                          window fuses into the kernel's WHERE clause
                          (``dfg_count_diced``)
sharded log               ``sharded-graph`` — per-shard CSR snapshots merged
                          by an aligned pure sum (:func:`_plan_sharded`)
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

The thresholds are the static constants below unless a calibration record
of the port's own (``BENCH_torch_*.json``, :func:`load_calibration`)
measures them; the memory budget is an explicit argument, then a record,
then what a CUDA engine takes from the card and the host
(:func:`device_memory_budget`).  The reference package's calibration
records (``BENCH_*.json``) were measured on other hardware, so the port
never reads them.

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
import json
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.repository import EventRepository
from repro_torch.core.streaming import MemmapLog
from repro_torch.graph.shard import ShardedLog
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
    "SHARDED_SINGLE_CROSSOVER",
    "device_memory_budget",
    "CrossoverCurve",
    "load_calibration",
    "resolve_threshold",
    "estimate_cost_s",
    "SLO_HOT_CUTOFF_S",
]

_LOG = logging.getLogger(__name__)

#: below this many pairs, numpy on the host beats a device round trip
TINY_PAIRS = 2048
#: above this many events a memmap log is mined out-of-core (a CPU engine's
#: budget, and the least a CUDA engine's measured budget can be)
MEMORY_BUDGET_EVENTS = 1 << 22
#: repeated topology-query misses on one source after which building the
#: event-knowledge graph amortizes (the reference's static default)
GRAPH_REPEAT_CROSSOVER = 3
#: memmap events above which ``auto`` replays a memmap log in one streaming
#: scan instead of materializing it.  The static default ties it to the
#: memory budget constant (a CUDA engine's budget is larger, and the
#: crossover is then what sends large logs to the streaming replayer); a
#: measured value comes from ``BENCH_torch_conformance.json`` (none exists
#: yet, so every engine keeps this constant)
REPLAY_STREAMING_CROSSOVER = MEMORY_BUDGET_EVENTS
#: sharded-log events above which the sharded-graph backend (per-shard CSR
#: snapshots + aligned merge) beats concatenate-and-materialize on a single
#: host.  The reference's static default; a measured value comes from
#: ``BENCH_torch_shard.json`` (none exists yet, so an engine takes this
#: constant unless ``sharded_crossover`` is set)
SHARDED_SINGLE_CROSSOVER = 1 << 18
#: predicted execution cost (seconds) below which a serving tier classifies
#: a request *hot* (a cache, delta or graph serve) rather than a cold scan.
#: The reference's static default, between a cache hit and a cold streaming
#: scan; a measured boundary comes from ``BENCH_torch_serve.json`` (none
#: exists yet)
SLO_HOT_CUTOFF_S = 0.05

# Order-of-magnitude cost priors for the observability drift check: fixed
# per-backend dispatch overhead plus an events-per-second throughput.  They
# let a recorded trace (repro_torch.obs.QueryTrace) be contrasted with the
# planner's choice and never influence planning itself.  Keyed by the
# port's backend names.  Each card number was measured by ``chip_smoke.py``
# at PAPER_EVAL width on an NVIDIA H100 80GB HBM3 with a 700.00 W power
# limit, and PERF.md gives the run it comes from (§5 for walls, §6 for the
# kernel's time).
_COST_DISPATCH_S = {
    "numpy": 5e-5,          # host prior kept from the reference, not measured on the card
    "scatter": 3e-4,        # host prior kept from the reference, not measured on the card
    "onehot": 3e-4,         # host prior kept from the reference, not measured on the card
    # one dfg_count call on the card, the host's call included: 0.0523 ms
    # (PERF.md §6, B1 ms)
    "kernel": 5.23e-5,
    # distributed_dfg on a mesh of the card (one position): 0.0633 s of the
    # mesh engine's 1.4355 s cold DFG (PERF.md §5, sharded tier)
    "distributed": 6.33e-2,
    "graph": 5e-5,          # host prior kept from the reference, not measured on the card
    # the merge of 4 shard Ψ in a cold sharded DFG: 0.0134 s (PERF.md §5,
    # sharded tier)
    "sharded-graph": 1.34e-2,
}
# Events per second, cold-path inclusive: a cold scan on a memmap source
# pays materialization on top of the count, and the drift band (±16x by
# default) absorbs part of the warm-path speedup.  On the card a warm dice
# is faster than the band allows, so it counts as drift (PERF.md §5).
_COST_RATE_EVENTS_S = {
    "numpy": 2e7,           # host prior kept from the reference, not measured on the card
    "scatter": 2e6,         # host prior kept from the reference, not measured on the card
    "onehot": 1e6,          # host prior kept from the reference, not measured on the card
    # a cold whole-log DFG: 7,200,010 events in 1.4136 s (PERF.md §5,
    # main path)
    "kernel": 5.1e6,
    # the mesh engine's cold DFG: 7,200,010 events in 1.4355 s (PERF.md
    # §5, sharded tier)
    "distributed": 5.0e6,
    "streaming": 5e6,       # host prior kept from the reference, not measured on the card
    "delta": 5e6,           # host prior kept from the reference, not measured on the card
    "graph": 4e8,           # host prior kept from the reference, not measured on the card
    "concat": 5e6,          # host prior kept from the reference, not measured on the card
    # a cold sharded DFG, 4 shard graph builds: 7,200,010 events in 2.7803 s
    # (PERF.md §5, sharded tier)
    "sharded-graph": 2.6e6,
}


def estimate_cost_s(backend: str, num_events: int) -> float:
    """Prior execution cost (seconds) of ``backend`` over ``num_events``
    events — the prediction a trace records so ``explain(after=...)`` and
    the ``planner_drift_total`` counter can contrast it with the measured
    span."""
    rate = _COST_RATE_EVENTS_S.get(backend, 5e6)
    return _COST_DISPATCH_S.get(backend, 1e-4) + num_events / rate


# ---------------------------------------------------------------------------
# Measured calibration: the port's own records only
# ---------------------------------------------------------------------------

#: sanity rails: a stray or corrupt record must not be able to flip plans
#: far outside the regime its benchmark measured (the reference's rails)
_CALIBRATION_CLAMPS = {
    "tiny_pairs": (256, 4096),
    "memory_budget_events": (1 << 20, 1 << 26),
}
_GRAPH_CLAMPS = {
    "graph_repeat_crossover": (1, 64),
}
_CONFORMANCE_CLAMPS = {
    "replay_streaming_crossover": (1 << 18, 1 << 26),
}
_SHARD_CLAMPS = {
    "sharded_single_crossover": (1 << 14, 1 << 24),
}
#: float clamp bounds mark float-valued calibration keys (the serve
#: boundary is seconds, not a count)
_SERVE_CLAMPS = {
    "slo_hot_cutoff_s": (1e-4, 2.0),
}
_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..")
)

#: calibration basenames already warned about this process — a planner that
#: runs on static fallbacks should say so exactly once, not on every query
_warned_missing: set = set()


@dataclasses.dataclass(frozen=True)
class CrossoverCurve:
    """A crossover threshold as a *function of problem size* instead of one
    scalar.  A record's ``calibration.curves.<key>`` holds measured
    ``[work, threshold]`` points where ``work = events × activities``; the
    curve interpolates them piecewise-linearly (clamped to the endpoint
    thresholds outside the measured range), so the same mechanism serves
    every backend crossover — tiny_pairs, replay, graph repeats, and the
    sharded-vs-single-host decision."""

    key: str
    xs: Tuple[float, ...]  # sorted work coordinates (events × activities)
    ys: Tuple[float, ...]  # measured thresholds at those sizes

    def value_at(self, work: float) -> int:
        return int(round(float(np.interp(float(work), self.xs, self.ys))))


def _parse_curves(
    cal: dict, clamps: Dict[str, Tuple[int, int]], out: Dict
) -> None:
    """Fit clamp-railed :class:`CrossoverCurve` objects from a record's
    ``curves`` section.  Only keys this record is allowed to calibrate (its
    scalar clamp keys) are accepted, and every threshold passes the same
    sanity rails as the scalar — one corrupt record still cannot flip plans
    outside the measured regime."""
    curves = cal.get("curves")
    if not isinstance(curves, dict):
        return
    for key, (lo, hi) in clamps.items():
        pts = curves.get(key)
        if not isinstance(pts, list) or not pts:
            continue
        try:
            parsed = sorted(
                (float(x), float(min(max(float(y), lo), hi)))
                for x, y in pts
                if float(x) >= 0 and float(y) > 0
            )
        except (TypeError, ValueError):
            continue
        if parsed:
            out.setdefault("curves", {})[key] = CrossoverCurve(
                key=key,
                xs=tuple(x for x, _ in parsed),
                ys=tuple(y for _, y in parsed),
            )


def _read_calibration(
    explicit: Optional[str],
    basename: str,
    clamps: Dict[str, Tuple[int, int]],
    out: Dict,
) -> Tuple[str, ...]:
    """Merge one record's ``calibration`` section into ``out``, clamped, and
    return the scalar keys it set.  An explicitly named record is
    authoritative: if it is missing or corrupt the static constants stay,
    never whatever record happens to sit in the cwd / repo root."""
    candidates = [explicit] if explicit else [
        basename,
        os.path.join(_REPO_ROOT, basename),
    ]
    for cand in candidates:
        if not cand or not os.path.isfile(cand):
            continue
        try:
            with open(cand) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue  # unreadable / corrupt: static fallback
        cal = data.get("calibration")
        if not isinstance(cal, dict):
            continue
        measured = []
        for key, (lo, hi) in clamps.items():
            v = cal.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool) and v > 0:
                # float clamp bounds mark float-valued keys (the serve-tier
                # SLO boundary in seconds); everything else stays an
                # integer threshold
                if isinstance(lo, float) or isinstance(hi, float):
                    out[key] = float(min(max(float(v), lo), hi))
                else:
                    out[key] = int(min(max(int(v), lo), hi))
                measured.append(key)
        _parse_curves(cal, clamps, out)
        return tuple(measured)
    if basename not in _warned_missing:
        _warned_missing.add(basename)
        _LOG.warning(
            "calibration record %s not found (searched explicit path, cwd, "
            "repo root); the planner falls back to static thresholds for %s",
            basename, sorted(clamps),
        )
    return ()


def _load_calibration(
    path: Optional[str] = None,
    graph_path: Optional[str] = None,
    conformance_path: Optional[str] = None,
    shard_path: Optional[str] = None,
    serve_path: Optional[str] = None,
) -> Tuple[Dict, Tuple[str, ...]]:
    """:func:`load_calibration` and the scalar keys that records set."""
    out: Dict = {
        "tiny_pairs": TINY_PAIRS,
        "memory_budget_events": MEMORY_BUDGET_EVENTS,
        "graph_repeat_crossover": GRAPH_REPEAT_CROSSOVER,
        "replay_streaming_crossover": REPLAY_STREAMING_CROSSOVER,
        "sharded_single_crossover": SHARDED_SINGLE_CROSSOVER,
        "slo_hot_cutoff_s": SLO_HOT_CUTOFF_S,
        "curves": {},
    }
    env = os.environ.get
    measured = (
        _read_calibration(
            path or env("GRAPHPM_TORCH_BENCH_QUERY"),
            "BENCH_torch_query.json", _CALIBRATION_CLAMPS, out,
        )
        + _read_calibration(
            graph_path or env("GRAPHPM_TORCH_BENCH_GRAPH"),
            "BENCH_torch_graph.json", _GRAPH_CLAMPS, out,
        )
        + _read_calibration(
            conformance_path or env("GRAPHPM_TORCH_BENCH_CONFORMANCE"),
            "BENCH_torch_conformance.json", _CONFORMANCE_CLAMPS, out,
        )
        + _read_calibration(
            shard_path or env("GRAPHPM_TORCH_BENCH_SHARD"),
            "BENCH_torch_shard.json", _SHARD_CLAMPS, out,
        )
        + _read_calibration(
            serve_path or env("GRAPHPM_TORCH_BENCH_SERVE"),
            "BENCH_torch_serve.json", _SERVE_CLAMPS, out,
        )
    )
    return out, measured


def load_calibration(
    path: Optional[str] = None,
    graph_path: Optional[str] = None,
    conformance_path: Optional[str] = None,
    shard_path: Optional[str] = None,
    serve_path: Optional[str] = None,
) -> Dict:
    """Cost-model thresholds, measured on the card when the port has a record.

    A record is a JSON file with a ``calibration`` section, as the
    reference's benchmarks write them: ``BENCH_torch_query.json``
    (``tiny_pairs``, ``memory_budget_events``), ``BENCH_torch_graph.json``
    (``graph_repeat_crossover``), ``BENCH_torch_conformance.json``
    (``replay_streaming_crossover``), ``BENCH_torch_shard.json``
    (``sharded_single_crossover``) and ``BENCH_torch_serve.json``
    (``slo_hot_cutoff_s``).  Each is searched as: the explicit path
    argument, ``$GRAPHPM_TORCH_BENCH_QUERY`` / ``_GRAPH`` /
    ``_CONFORMANCE`` / ``_SHARD`` / ``_SERVE``, ``./BENCH_torch_*.json``,
    ``<repo root>/BENCH_torch_*.json``.  A record's values replace the static
    constants, clamped to the reference's sanity rails, and any ``curves``
    section becomes a :class:`CrossoverCurve` under ``out["curves"]``
    (threshold as a function of events × activities — used in preference
    to the scalar when present).  The constants are always the fallback; a
    missing record logs a one-time warning.  The reference package's own
    records (``BENCH_*.json``, measured on other hardware) are never read.
    """
    return _load_calibration(
        path, graph_path, conformance_path, shard_path, serve_path
    )[0]


def resolve_threshold(calibration: Dict, key: str, work: float) -> int:
    """The effective crossover for ``key`` at problem size ``work``
    (events × activities): the fitted curve when the calibration carries
    one, else the (possibly measured) scalar."""
    curve = calibration.get("curves", {}).get(key)
    if curve is not None:
        return curve.value_at(work)
    return int(calibration[key])

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
    "auto", "numpy", "scatter", "onehot", "kernel", "streaming",
    "distributed", "graph", "sharded-graph",
}
#: sinks the planner maps (the reference's other sinks are later items)
_SINKS = (DFGSink, HistogramSink, VariantsSink, CompareSink, ProcessMapSink,
          NeighborhoodSink)
#: conformance sinks replay/align sequences — device counting backends do
#: not apply; "numpy" is the columnar replay, "streaming" the one-pass
#: replayer, "graph" the stored-event-table walk
_CONFORMANCE_BACKENDS = {"auto", "numpy", "streaming", "graph"}


@dataclasses.dataclass(frozen=True)
class SourceInfo:
    kind: str  # "repository" | "memmap" | "sharded" | "union(...)"
    num_events: int
    num_pairs: int
    num_activities: int
    activity_names: Optional[Tuple[str, ...]]
    # union sources only: per-branch shapes (costed individually — one
    # union may mix an out-of-core memmap branch with in-memory ones)
    branches: Optional[Tuple["SourceInfo", ...]] = None
    branch_names: Optional[Tuple[str, ...]] = None
    # sharded sources only: per-shard shapes (each shard is costed as an
    # independent memmap — windowed serves need every shard in budget)
    shards: Optional[Tuple["SourceInfo", ...]] = None
    shard_names: Optional[Tuple[str, ...]] = None


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
    if isinstance(source, ShardedLog):
        present = source.present_shards()
        infos = tuple(source_info(s) for _, s in present)
        return SourceInfo(
            kind="sharded",
            num_events=sum(i.num_events for i in infos),
            num_pairs=sum(i.num_pairs for i in infos),
            num_activities=source.num_activities,
            activity_names=tuple(source.activity_labels()),
            shards=infos,
            shard_names=tuple(f"shard{k}" for k, _ in present),
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
    # numpy | scatter | onehot | kernel | streaming | distributed | graph
    #   | delta | union | compare | concat | sharded-graph
    # ("delta" is engine-chosen only: it resumes cached streaming state over
    # a proven append-only suffix and is never requestable by the analyst;
    # "union"/"compare" merge per-branch sub-plans — the notes record each
    # branch's own backend — "concat" materializes the concatenated
    # repository for ops that do not distribute, and "sharded-graph" merges
    # per-shard graph serves)
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
    num_pairs: int, *, mesh, device_type: str, tiny_pairs: int,
    requested: str,
) -> str:
    if requested != "auto":
        return requested
    if mesh is not None and num_pairs > tiny_pairs:
        return "distributed"
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
    mesh,
    device_type: str,
    tiny_pairs: int,
    memory_budget_events: int,
    fused_dicing: bool,
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
            mesh=mesh, device_type=device_type, tiny_pairs=tiny_pairs,
            memory_budget_events=memory_budget_events,
            fused_dicing=fused_dicing,
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


def _plan_sharded(
    plan: LogicalPlan,
    info: SourceInfo,
    *,
    mesh,
    device_type: str,
    tiny_pairs: int,
    memory_budget_events: int,
    fused_dicing: bool,
    graph_available: bool,
    sharded_crossover: int,
) -> PhysicalPlan:
    """Physical plan for a case-partitioned :class:`ShardedLog`.

    The ``sharded-graph`` backend serves topology/histogram sinks from K
    per-shard CSR snapshots merged by an aligned pure sum (cases never span
    shards).  Below the sharded-vs-single-host crossover — and when the
    shard graphs are not already warm — a one-host concatenate-and-
    materialize count wins (the K-way merge constant dominates tiny logs),
    so ``auto`` falls back to it.
    """
    has_barrier, window, acts, view = _segment_features(plan)
    windowed = window is not None and not window.empty
    notes = []
    if window is not None and window.empty:
        notes.append("empty_window=zeros")

    if isinstance(plan.sink, CompareSink):
        raise QueryPlanError(
            "compare() requires a multi-log source — build one with "
            "Q.logs(a, b, ...)"
        )
    if isinstance(plan.sink, CONFORMANCE_SINKS):
        raise QueryPlanError(
            "conformance sinks are not implemented for sharded logs; "
            "query one shard directly or materialize a dicing first"
        )
    requested = getattr(plan.sink, "backend", "auto")
    if requested not in ("auto", "sharded-graph"):
        raise QueryPlanError(
            f"backend {requested!r} is not available on a sharded log; "
            "use 'sharded-graph' or 'auto'"
        )

    if has_barrier or isinstance(plan.sink, VariantsSink):
        if requested == "sharded-graph":
            raise QueryPlanError(
                "sharded-graph cannot evaluate variants / materializing ops "
                "(top_variants / relink): they need the global trace table; "
                "drop them or use auto"
            )
        if info.num_events > memory_budget_events:
            raise QueryPlanError(
                "variants / materializing ops on a sharded log concatenate "
                "the shards in memory; the log exceeds the memory budget"
            )
        return PhysicalPlan(
            backend="numpy",
            materialize=True,
            notes=("sharded=materialize_concatenation",) + tuple(notes),
        )

    single_host = (
        requested == "auto"
        and not graph_available
        and info.num_events <= min(sharded_crossover, memory_budget_events)
    )
    if single_host:
        notes.append(
            f"sharded=single_host_below_crossover"
            f"({info.num_events}≤{sharded_crossover})"
        )
        if isinstance(plan.sink, HistogramSink):
            return PhysicalPlan(
                backend="numpy", materialize=True, notes=tuple(notes)
            )
        backend = _device_backend(
            info.num_pairs, mesh=mesh, device_type=device_type,
            tiny_pairs=tiny_pairs, requested="auto",
        )
        view_pushdown = False
        if view is not None and info.activity_names is not None:
            labels = view.to_view().visible_labels(info.activity_names)
            if len(labels) < info.num_activities:
                view_pushdown = True
                notes.append(
                    f"count_space=G×G ({len(labels)}<{info.num_activities})"
                )
        return PhysicalPlan(
            backend=backend,
            materialize=True,
            fused_dicing=fused_dicing and backend == "kernel" and windowed,
            view_pushdown=view_pushdown,
            activities_as_output_mask=acts is not None and not view_pushdown,
            notes=tuple(notes),
        )

    if windowed:
        for name, sinfo in zip(info.shard_names, info.shards):
            if sinfo.num_events > memory_budget_events:
                raise QueryPlanError(
                    "windowed sharded-graph queries serve from per-shard "
                    f"event tables; {name} exceeds the memory budget — "
                    "repartition into more shards"
                )
    notes.append(
        "sharded=tables_window_merge" if windowed
        else "sharded=csr_psum_merge"
    )
    # per-shard cost estimates: each shard is an independent graph serve
    for name, sinfo in zip(info.shard_names, info.shards):
        notes.append(
            f"shard[{name}]=graph "
            f"cost≈{estimate_cost_s('graph', sinfo.num_events):.1e}s"
        )
    return PhysicalPlan(
        backend="sharded-graph",
        row_range_window=(window.t0, window.t1) if windowed else None,
        activities_as_output_mask=acts is not None,
        notes=tuple(notes),
    )


def plan_physical(
    plan: LogicalPlan,
    info: SourceInfo,
    *,
    mesh=None,
    device_type: str = "cuda",
    tiny_pairs: int = TINY_PAIRS,
    memory_budget_events: int = MEMORY_BUDGET_EVENTS,
    fused_dicing: bool = True,
    graph_available: bool = False,
    replay_crossover: int = REPLAY_STREAMING_CROSSOVER,
    sharded_crossover: int = SHARDED_SINGLE_CROSSOVER,
    curves: Optional[Dict[str, CrossoverCurve]] = None,
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
    (:func:`_plan_union`); a sharded source (``info.shards``) plans the
    shard merge or, below ``sharded_crossover`` events, one host
    (:func:`_plan_sharded`).  With a ``mesh`` (a
    :class:`~repro_torch.core.compat.Mesh`), ``auto`` counts above
    ``tiny_pairs`` on the ``distributed`` backend.  ``fused_dicing=False``
    keeps a window out of the kernel: the engine masks ``valid`` and
    launches the plain count.

    ``curves`` (from ``load_calibration()["curves"]``) upgrades the scalar
    crossovers to fitted curves evaluated at this source's problem size
    (events × activities)."""
    if curves:
        work = float(info.num_events) * float(max(info.num_activities, 1))
        for key, cur in (
            ("tiny_pairs", "tiny_pairs"),
            ("replay_streaming_crossover", "replay"),
            ("sharded_single_crossover", "sharded"),
        ):
            curve = curves.get(key)
            if curve is None:
                continue
            v = curve.value_at(work)
            if cur == "tiny_pairs":
                tiny_pairs = v
            elif cur == "replay":
                replay_crossover = v
            else:
                sharded_crossover = v
    if not isinstance(plan.sink, CONFORMANCE_SINKS):
        if not isinstance(plan.sink, _SINKS):
            raise QueryPlanError(f"unknown sink {plan.sink!r}")
        requested = getattr(plan.sink, "backend", "auto")
        if requested not in _DFG_BACKENDS:
            hint = (
                " (the port calls it 'kernel')" if requested == "pallas"
                else ""
            )
            raise QueryPlanError(f"unknown DFG backend {requested!r}{hint}")
        if requested == "sharded-graph" and info.shards is None:
            raise QueryPlanError(
                "backend 'sharded-graph' requires a ShardedLog source — "
                "partition one with repro_torch.graph.partition_memmap_log"
            )
    if info.branches is not None:
        return _plan_union(
            plan, info,
            mesh=mesh, device_type=device_type, tiny_pairs=tiny_pairs,
            memory_budget_events=memory_budget_events,
            fused_dicing=fused_dicing,
            replay_crossover=replay_crossover,
        )
    if info.shards is not None:
        return _plan_sharded(
            plan, info,
            mesh=mesh, device_type=device_type, tiny_pairs=tiny_pairs,
            memory_budget_events=memory_budget_events,
            fused_dicing=fused_dicing,
            graph_available=graph_available,
            sharded_crossover=sharded_crossover,
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
        info.num_pairs, mesh=mesh, device_type=device_type,
        tiny_pairs=tiny_pairs, requested=requested,
    )
    if backend == "distributed" and mesh is None:
        raise QueryPlanError("distributed backend requires a mesh")

    view_pushdown = False
    if view is not None and info.activity_names is not None:
        labels = view.to_view().visible_labels(info.activity_names)
        if len(labels) < info.num_activities:
            view_pushdown = True
            notes.append(f"count_space=G×G ({len(labels)}<{info.num_activities})")

    fuse = (
        fused_dicing
        and backend == "kernel"
        and window is not None
        and not window.empty
    )
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
