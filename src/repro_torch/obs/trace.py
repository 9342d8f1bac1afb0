"""Per-query execution traces.

A :class:`QueryTrace` is its own recorder: three preallocated parallel
slabs (name / start / duration) grown by doubling, written with nothing
but ``perf_counter`` reads and list stores.  The engine opens spans with
``begin`` (returns a slot index) and closes them with ``end`` — no
context-manager allocation, no string formatting, no dict churn on the
hot path.  Everything derived (span objects, coverage, dicts, pretty
text) is computed lazily at read time.

Span vocabulary used by the engine (a query's trace is a chain, so the
engine's own process mines as a DFG — see ``QueryEngine.own_telemetry``):

``parse`` → ``cache_probe`` → [``delta``] → ``plan`` → ``scan`` |
``merge`` → ``sink``

The device path also records its phases (materialize, host→device copy,
kernel, device→host copy; a union's merge, concatenation and barriers) as
seconds in ``notes``.  A union query's branch sub-queries are traces of
their own, chained under the union's (``branches``).
"""

from __future__ import annotations

from time import perf_counter
from typing import Dict, List, NamedTuple, Optional, Tuple

from .context import TraceContext, new_span_id

__all__ = ["Span", "QueryTrace", "NullTrace"]

_SLAB = 8


class Span(NamedTuple):
    name: str
    start_s: float      # offset from trace start
    duration_s: float


class QueryTrace:
    """Timed spans plus planner/cache/graph disposition for one query."""

    #: class-level flag: NullTrace instances report False, letting the
    #: engine skip publishing (metrics / forensics) without isinstance
    enabled = True

    __slots__ = (
        "query_id", "sink", "source", "planned_backend",
        "executed_backend", "from_cache", "predicted_cost_s",
        "actual_cost_s", "rows_scanned", "delta_rows", "total_s",
        "branches", "drift", "notes",
        "trace_id", "span_id", "parent_span_id", "sampled", "links",
        "_t_start", "_names", "_t0", "_dur", "_n",
    )

    def __init__(self, query_id: int, sink: str, source: str):
        self.query_id = query_id
        self.sink = sink
        self.source = source
        self.planned_backend: Optional[str] = None
        self.executed_backend: Optional[str] = None
        self.from_cache = False
        self.predicted_cost_s: Optional[float] = None
        self.actual_cost_s: Optional[float] = None
        self.rows_scanned = 0
        self.delta_rows: Optional[Tuple[int, int]] = None
        self.total_s = 0.0
        self.branches: List[Tuple[str, "QueryTrace"]] = []
        self.drift: Optional[float] = None
        self.notes: Dict[str, object] = {}
        # distributed-trace identity: None until the engine/transport binds
        # a TraceContext (bind_root / bind_child_of); links are causal
        # references to *other* traces (coalesced_into, produced_by)
        self.trace_id: Optional[str] = None
        self.span_id: Optional[str] = None
        self.parent_span_id: Optional[str] = None
        self.sampled = True
        self.links: Dict[str, str] = {}
        self._names: List[Optional[str]] = [None] * _SLAB
        self._t0 = [0.0] * _SLAB
        self._dur = [0.0] * _SLAB
        self._n = 0
        self._t_start = perf_counter()

    # -- distributed identity ---------------------------------------------

    def bind_root(self, ctx: TraceContext) -> None:
        """Adopt ``ctx`` as this trace's own identity (the request root:
        this node *is* the context's span)."""
        self.trace_id = ctx.trace_id
        self.span_id = ctx.span_id
        self.parent_span_id = None
        self.sampled = ctx.sampled

    def bind_child_of(self, ctx: TraceContext) -> None:
        """Become a child of ``ctx``: same trace id, fresh span id,
        ``ctx``'s span recorded as parent."""
        self.trace_id = ctx.trace_id
        self.span_id = new_span_id()
        self.parent_span_id = ctx.span_id
        self.sampled = ctx.sampled

    @property
    def context(self) -> Optional[TraceContext]:
        """This trace's node as a propagatable context (None if unbound)."""
        if self.trace_id is None or self.span_id is None:
            return None
        return TraceContext(self.trace_id, self.span_id, self.sampled)

    # -- hot path ---------------------------------------------------------

    def begin(self, name: str) -> int:
        i = self._n
        if i == len(self._names):
            self._names.extend([None] * i)
            self._t0.extend([0.0] * i)
            self._dur.extend([0.0] * i)
        self._names[i] = name
        self._dur[i] = -1.0
        self._n = i + 1
        self._t0[i] = perf_counter()
        return i

    def end(self, idx: int) -> None:
        self._dur[idx] = perf_counter() - self._t0[idx]

    def add_span(self, name: str, t0: float, duration_s: float) -> int:
        """Record an externally-timed span (absolute ``perf_counter``
        start).  Used for intervals measured outside the trace's own
        begin/end pairing — e.g. the scheduler's queue wait, whose start
        stamp is taken on the event loop and whose end is observed on the
        worker thread that finally picks the request up."""
        i = self.begin(name)
        self._t0[i] = t0
        self._dur[i] = max(duration_s, 0.0)
        return i

    def finish(self) -> "QueryTrace":
        t = perf_counter()
        self.total_s = t - self._t_start
        for i in range(self._n):        # close spans orphaned by errors
            if self._dur[i] < 0.0:
                self._dur[i] = t - self._t0[i]
        return self

    # -- read side --------------------------------------------------------

    def raw_spans(self):
        """``(names, start_stamps, durations)`` slab slices for batch
        forensics recording — the stamps are absolute ``perf_counter``
        values, so cross-query ordering survives in the collector."""
        n = self._n
        return self._names[:n], self._t0[:n], self._dur[:n]

    @property
    def spans(self) -> List[Span]:
        t0 = self._t_start
        return [
            Span(self._names[i], self._t0[i] - t0, max(self._dur[i], 0.0))
            for i in range(self._n)
        ]

    def span_seconds(self, name: str) -> float:
        total = 0.0
        for i in range(self._n):
            if self._names[i] == name and self._dur[i] > 0.0:
                total += self._dur[i]
        return total

    def coverage(self) -> float:
        """Fraction of wall time covered by recorded spans (spans are
        sequential and non-overlapping, so a plain sum is exact)."""
        if self.total_s <= 0.0:
            return 1.0
        covered = sum(max(self._dur[i], 0.0) for i in range(self._n))
        return min(covered / self.total_s, 1.0)

    def add_branch(self, name: str, trace: "QueryTrace") -> None:
        self.branches.append((name, trace))

    def to_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {
            "query_id": self.query_id,
            "sink": self.sink,
            "source": self.source,
            "planned_backend": self.planned_backend,
            "executed_backend": self.executed_backend,
            "from_cache": self.from_cache,
            "predicted_cost_s": self.predicted_cost_s,
            "actual_cost_s": self.actual_cost_s,
            "rows_scanned": self.rows_scanned,
            "total_s": self.total_s,
            "coverage": self.coverage(),
            "spans": [
                {"name": s.name, "start_s": s.start_s,
                 "duration_s": s.duration_s}
                for s in self.spans
            ],
        }
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
            d["span_id"] = self.span_id
            d["sampled"] = self.sampled
            if self.parent_span_id is not None:
                d["parent_span_id"] = self.parent_span_id
        if self.links:
            d["links"] = dict(self.links)
        if self.delta_rows is not None:
            d["delta_rows"] = list(self.delta_rows)
        if self.drift is not None:
            d["drift"] = self.drift
        if self.notes:
            d["notes"] = dict(self.notes)
        if self.branches:
            d["branches"] = [
                {"name": n, "trace": t.to_dict()} for n, t in self.branches
            ]
        return d

    def describe(self, *, max_depth: int = 2) -> str:
        """Pretty text.  Branch sub-traces (union branches, sharded-graph
        ``shard<k>`` sub-queries) recurse up to ``max_depth`` levels with
        indentation; deeper levels collapse to one summary line each."""
        return "\n".join(self._describe_lines("", max_depth))

    def _describe_lines(self, indent: str, depth: int) -> List[str]:
        head = (
            f"{indent}trace q{self.query_id} sink={self.sink} "
            f"backend={self.executed_backend}"
        )
        if self.planned_backend and self.planned_backend != self.executed_backend:
            head += f" (planned={self.planned_backend})"
        lines = [
            head,
            f"{indent}  total={self.total_s * 1e3:.3f}ms "
            f"coverage={self.coverage() * 100.0:.1f}% "
            f"rows={self.rows_scanned}",
        ]
        for s in self.spans:
            lines.append(
                f"{indent}  {s.name:<12s} +{s.start_s * 1e3:8.3f}ms  "
                f"{s.duration_s * 1e3:8.3f}ms"
            )
        for name, sub in self.branches:
            lines.append(
                f"{indent}  branch {name}: backend={sub.executed_backend} "
                f"cache={sub.from_cache} rows={sub.rows_scanned} "
                f"total={sub.total_s * 1e3:.3f}ms"
            )
            if depth > 1:
                lines.extend(sub._describe_lines(indent + "    ", depth - 1))
        return lines

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"QueryTrace(q{self.query_id}, sink={self.sink!r}, "
            f"backend={self.executed_backend!r}, spans={self._n}, "
            f"total={self.total_s:.6f}s)"
        )


class NullTrace(QueryTrace):
    """Recorder used when the engine runs with ``trace=False`` (e.g. the
    baseline of a tracing-overhead measurement): span begin/end are no-ops
    and the engine publishes nothing.  Disposition attributes still accept writes,
    so the execution paths stay branch-free."""

    enabled = False

    def begin(self, name: str) -> int:
        return 0

    def end(self, idx: int) -> None:
        return None

    def add_span(self, name: str, t0: float, duration_s: float) -> int:
        return 0
