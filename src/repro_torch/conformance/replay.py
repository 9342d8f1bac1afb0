"""Graph-native + streaming token replay — conformance where the data lives.

Three evaluation paths, pinned bit-identical on shared inputs:

* **columnar** — :func:`repro_torch.core.conformance.replay_fitness`, the oracle:
  one vectorized pass over the repository's pair columns;
* **graph** — :func:`replay_fitness_graph`: the same arithmetic as segment
  walks over the event-knowledge graph's stored tables (canonical
  ``:BELONGS_TO`` order makes each case a contiguous segment whose ``:DF``
  steps are adjacent rows), so a built graph replays with **zero
  re-materialization** of the source;
* **streaming** — :class:`StreamingReplayer`: one O(A² + chunk + cases)
  scan over a memmap log, with ``snapshot()/restore()`` state (per-case
  tails + fitness accumulators), so a scan can resume over an appended
  suffix and match a full rescan bit for bit, like the streaming DFG
  miner.

:class:`StreamingModelDiscoverer` is the out-of-core companion for the
"model defaults to the log's own discovered dependency graph" case: it
accumulates Ψ plus per-case first/last activities in the same single scan,
so discovery never needs to materialize the log either.
"""

from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.conformance import (
    ModelSpec,
    ReplayResult,
    deviation_census,
    model_tables,
    replay_core,
)
from repro_torch.core.discovery import DiscoveredModel, discover_dependency_graph
from repro_torch.core.streaming import MemmapLog, StreamingDFGMiner

__all__ = [
    "ReplayState",
    "StreamingReplayer",
    "StreamingModelDiscoverer",
    "replay_fitness_arrays",
    "replay_fitness_graph",
    "replay_fitness_streaming",
]


# ---------------------------------------------------------------------------
# Shared array-level replay (graph + transformed columnar paths)
# ---------------------------------------------------------------------------


def replay_fitness_arrays(
    activity: np.ndarray,
    trace: np.ndarray,
    names: Sequence[str],
    model: Union[DiscoveredModel, ModelSpec],
    num_traces: Optional[int] = None,
) -> ReplayResult:
    """Token replay over canonical (trace-contiguous, time-sorted) columns.

    ``num_traces=None`` scores exactly the traces that own events,
    renumbered by ascending trace id — the semantics of a diced/transformed
    selection (and of a streaming scan, which can only see cases with
    rows).  Passing an explicit ``num_traces`` scores every trace,
    including empty ones (the whole-repository oracle semantics).
    """
    activity = np.asarray(activity)
    trace = np.asarray(trace)
    if num_traces is None:
        _uniq, t = np.unique(trace, return_inverse=True)
        T = int(_uniq.shape[0])
    else:
        t, T = trace, int(num_traces)
    allowed, start_ok, end_ok = model_tables(model, names)
    trace_fit, bad_src, bad_dst = replay_core(
        activity, t, T, allowed, start_ok, end_ok
    )
    return ReplayResult(
        fitness=float(trace_fit.mean()) if trace_fit.shape[0] else 1.0,
        trace_fitness=trace_fit,
        perfectly_fitting=int((trace_fit >= 1.0 - 1e-12).sum()),
        deviating_edges=deviation_census(bad_src, bad_dst, names),
    )


def replay_fitness_graph(
    graph, model: Union[DiscoveredModel, ModelSpec]
) -> ReplayResult:
    """Replay straight off an :class:`~repro_torch.graph.build.EventGraph`'s
    stored event tables — the ``:BELONGS_TO`` CSR guarantees each case is a
    contiguous segment, so the ``:DF`` walk is the adjacent-row gather the
    oracle vectorizes.  Topology-only graphs (built out-of-core) carry no
    tables and cannot replay."""
    if not graph.has_event_tables:
        raise ValueError(
            "topology-only graph has no event tables; replay needs a full "
            "graph (in-budget build) or the streaming path"
        )
    return replay_fitness_arrays(
        np.asarray(graph.event_activity),
        np.asarray(graph.event_trace),
        graph.activity_names,
        model,
        num_traces=graph.num_traces,
    )


# ---------------------------------------------------------------------------
# Streaming replay (out-of-core, resumable)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReplayState:
    """Resumable snapshot of a :class:`StreamingReplayer`: the per-case
    tails (last activity) plus fitness accumulators (allowed-move counts,
    lengths, start scores) and the disallowed-move census matrix.  Resuming
    over an appended suffix reproduces a full rescan bit for bit — end
    scores are derived from the tails only at :meth:`StreamingReplayer.
    finalize`, so an open case's end contribution is never baked in."""

    num_activities: int
    last_act: np.ndarray  # (C,) int32, -1 = case unseen
    ok_moves: np.ndarray  # (C,) int64 allowed directly-follows moves
    lengths: np.ndarray  # (C,) int64 events per case
    start_fit: np.ndarray  # (C,) int64 ∈ {0, 1}
    bad_pairs: np.ndarray  # (A, A) int64 disallowed-move census
    events_seen: int

    def copy(self) -> "ReplayState":
        return ReplayState(
            self.num_activities,
            self.last_act.copy(), self.ok_moves.copy(),
            self.lengths.copy(), self.start_fit.copy(),
            self.bad_pairs.copy(), self.events_seen,
        )


class StreamingReplayer:
    """One-pass token replay over a time-ordered event stream with
    interleaved cases — the conformance twin of
    :class:`~repro_torch.core.streaming.StreamingDFGMiner`.

    State is O(A² + cases): per-case tails/accumulators are dense arrays
    indexed by raw case id (grown on demand), and every chunk update is
    fully vectorized (one lexsort + boolean gathers; no Python loop over
    case runs).  ``snapshot()/restore()`` make the scan resumable across
    appends; a grown activity vocabulary pads the model tables with
    all-False rows (new activities are never allowed by the old model).
    """

    def __init__(
        self,
        names: Sequence[str],
        model: Union[DiscoveredModel, ModelSpec],
        state: Optional[ReplayState] = None,
        observer: Optional[Callable[[float, int], None]] = None,
    ):
        self.names = list(names)
        # per-chunk timing hook, called as ``observer(seconds, rows)``
        # after every non-empty update — the engine wires this to its
        # ``replay_chunk_seconds`` histogram
        self.observer = observer
        a = len(self.names)
        self.allowed, self.start_ok, self.end_ok = model_tables(
            model, self.names
        )
        if state is None:
            self.last_act = np.full((0,), -1, dtype=np.int32)
            self.ok_moves = np.zeros((0,), dtype=np.int64)
            self.lengths = np.zeros((0,), dtype=np.int64)
            self.start_fit = np.zeros((0,), dtype=np.int64)
            self.bad_pairs = np.zeros((a, a), dtype=np.int64)
            self.events_seen = 0
        else:
            if state.num_activities > a:
                raise ValueError(
                    "cannot shrink the vocabulary on resume "
                    f"({state.num_activities} -> {a})"
                )
            self.last_act = state.last_act.copy()
            self.ok_moves = state.ok_moves.copy()
            self.lengths = state.lengths.copy()
            self.start_fit = state.start_fit.copy()
            self.bad_pairs = np.zeros((a, a), dtype=np.int64)
            old = state.num_activities
            self.bad_pairs[:old, :old] = state.bad_pairs
            self.events_seen = int(state.events_seen)

    def snapshot(self) -> ReplayState:
        return ReplayState(
            len(self.names),
            self.last_act.copy(), self.ok_moves.copy(),
            self.lengths.copy(), self.start_fit.copy(),
            self.bad_pairs.copy(), self.events_seen,
        )

    @classmethod
    def restore(
        cls,
        state: ReplayState,
        names: Sequence[str],
        model: Union[DiscoveredModel, ModelSpec],
        observer: Optional[Callable[[float, int], None]] = None,
    ) -> "StreamingReplayer":
        return cls(names, model, state=state, observer=observer)

    def _grow(self, max_case: int) -> None:
        c = self.last_act.shape[0]
        if max_case < c:
            return
        n = max_case + 1
        la = np.full((n,), -1, dtype=np.int32)
        la[:c] = self.last_act
        self.last_act = la
        for attr in ("ok_moves", "lengths", "start_fit"):
            arr = np.zeros((n,), dtype=np.int64)
            arr[:c] = getattr(self, attr)
            setattr(self, attr, arr)

    def update(
        self, activity: np.ndarray, case: np.ndarray, time: np.ndarray
    ) -> None:
        """Consume one chunk (time-ordered rows; cases may interleave)."""
        n = activity.shape[0]
        if n == 0:
            return
        obs = self.observer
        t0 = perf_counter() if obs is not None else 0.0
        self.events_seen += int(n)
        order = np.lexsort((np.arange(n), time, case))
        a = np.asarray(activity)[order].astype(np.int64)
        c = np.asarray(case)[order].astype(np.int64)
        self._grow(int(c.max()))

        np.add.at(self.lengths, c, 1)

        # in-chunk pairs (cases are contiguous after the sort)
        if n >= 2:
            same = c[:-1] == c[1:]
            edge_ok = self.allowed[a[:-1], a[1:]]
            np.add.at(
                self.ok_moves, c[:-1][same],
                (edge_ok & same)[same].astype(np.int64),
            )
            bad = same & ~edge_ok
            np.add.at(self.bad_pairs, (a[:-1][bad], a[1:][bad]), 1)

        # cross-chunk boundary pairs + first-ever events, at case-run starts
        rs = np.ones(n, dtype=bool)
        rs[1:] = c[1:] != c[:-1]
        rs_idx = np.nonzero(rs)[0]
        cs = c[rs_idx]
        first_a = a[rs_idx]
        prev = self.last_act[cs]
        seen = prev >= 0
        if seen.any():
            pa = prev[seen].astype(np.int64)
            fa = first_a[seen]
            edge_ok = self.allowed[pa, fa]
            np.add.at(
                self.ok_moves, cs[seen][edge_ok], 1
            )
            np.add.at(self.bad_pairs, (pa[~edge_ok], fa[~edge_ok]), 1)
        fresh = ~seen
        if fresh.any():
            self.start_fit[cs[fresh]] = self.start_ok[
                first_a[fresh]
            ].astype(np.int64)

        # carry the tail of each case-run (one run per case after the sort)
        re_ = np.ones(n, dtype=bool)
        re_[:-1] = c[:-1] != c[1:]
        re_idx = np.nonzero(re_)[0]
        self.last_act[c[re_idx]] = a[re_idx].astype(np.int32)

        if obs is not None:
            obs(perf_counter() - t0, int(n))

    def finalize(self) -> ReplayResult:
        """Score the scanned stream (non-destructive: end contributions come
        from the tails, so the replayer can keep consuming afterwards)."""
        seen = np.nonzero(self.last_act >= 0)[0]  # ascending raw case id
        ends_fit = self.end_ok[self.last_act[seen]].astype(np.int64)
        denom = np.maximum(self.lengths[seen] + 1, 1)
        trace_fit = (
            self.ok_moves[seen] + self.start_fit[seen] + ends_fit
        ) / denom
        bs, bd = np.nonzero(self.bad_pairs)
        census: Dict[tuple, int] = {
            (self.names[int(s)], self.names[int(d)]): int(
                self.bad_pairs[s, d]
            )
            for s, d in zip(bs, bd)
        }
        return ReplayResult(
            fitness=float(trace_fit.mean()) if trace_fit.shape[0] else 1.0,
            trace_fitness=trace_fit,
            perfectly_fitting=int((trace_fit >= 1.0 - 1e-12).sum()),
            deviating_edges=census,
        )


def replay_fitness_streaming(
    log: MemmapLog,
    model: Union[DiscoveredModel, ModelSpec],
    row_range: Optional[Tuple[int, int]] = None,
) -> ReplayResult:
    """End-to-end out-of-core replay of a memmap log (O(chunk) memory)."""
    rep = StreamingReplayer(log.activity_labels(), model)
    for a, c, t in log.iter_chunks(row_range=row_range):
        rep.update(a, c, t)
    return rep.finalize()


# ---------------------------------------------------------------------------
# Streaming model discovery (for the default-model case, out-of-core)
# ---------------------------------------------------------------------------


class StreamingModelDiscoverer:
    """Dependency-graph discovery in one streaming scan: Ψ via the streaming
    DFG miner plus per-case first/last activities (the trace boundaries
    discovery needs), O(A² + cases) memory."""

    def __init__(self, num_activities: int):
        self.miner = StreamingDFGMiner(num_activities)
        self.first_act = np.full((0,), -1, dtype=np.int32)
        self.last_act = np.full((0,), -1, dtype=np.int32)

    def _grow(self, max_case: int) -> None:
        c = self.first_act.shape[0]
        if max_case < c:
            return
        n = max_case + 1
        for attr in ("first_act", "last_act"):
            arr = np.full((n,), -1, dtype=np.int32)
            arr[:c] = getattr(self, attr)
            setattr(self, attr, arr)

    def update(
        self, activity: np.ndarray, case: np.ndarray, time: np.ndarray
    ) -> None:
        n = activity.shape[0]
        if n == 0:
            return
        order = np.lexsort((np.arange(n), time, case))
        a = np.asarray(activity)[order]
        c = np.asarray(case)[order].astype(np.int64)
        t = np.asarray(time)[order]
        self._grow(int(c.max()))
        rs = np.ones(n, dtype=bool)
        rs[1:] = c[1:] != c[:-1]
        rs_idx = np.nonzero(rs)[0]
        fresh = rs_idx[self.first_act[c[rs_idx]] < 0]
        self.first_act[c[fresh]] = a[fresh]
        re_ = np.ones(n, dtype=bool)
        re_[:-1] = c[:-1] != c[1:]
        re_idx = np.nonzero(re_)[0]
        self.last_act[c[re_idx]] = a[re_idx]
        # feed the (already sorted) chunk to the miner for Ψ
        self.miner.update(a, c.astype(np.int32), t)

    def finalize(
        self, names: Sequence[str], *, min_count: int = 1,
        min_dependency: float = 0.5,
    ) -> DiscoveredModel:
        a = len(names)
        starts = np.bincount(
            self.first_act[self.first_act >= 0], minlength=a
        ).astype(np.int64)
        ends = np.bincount(
            self.last_act[self.last_act >= 0], minlength=a
        ).astype(np.int64)
        return discover_dependency_graph(
            self.miner.finalize(), list(names), starts, ends,
            min_count=min_count, min_dependency=min_dependency,
        )
