"""Conformance checking: token replay on a discovered dependency graph.

The paper positions DFG computation as the backbone for "discovery,
conformance, and enhancement" (§2.1).  This module adds **trace-level
replay fitness**: each trace is replayed over the model's edge set and
scored by the fraction of its moves the model allows — vectorized over all
traces at once (edge lookups become one boolean gather over the pair
columns), so it runs on million-event logs.

fitness(trace) = (allowed directly-follows moves + allowed start + allowed
end) / (len(trace) + 1), matching the DFG abstraction's replay semantics.

This module is the *columnar oracle* of :mod:`repro_torch.conformance`:
the streaming and graph-native replay paths there are held bit-identical
to :func:`replay_fitness`.  Shared pieces live here so every path uses the
same arithmetic:

* :class:`ModelSpec` — the canonical, hashable form of a
  :class:`~repro_torch.core.discovery.DiscoveredModel` (edge set +
  start/end sets), usable as a frozen query-plan field;
* :func:`model_tables` — (allowed, start_ok, end_ok) boolean tables over a
  given activity axis;
* :func:`deviation_census` — the disallowed-move census, vectorized via
  ``np.unique`` over encoded pair ids (no host loop over deviating pairs).

Replay is integer gathers and counts; it runs on the host in numpy, as the
reference package runs it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple, Union

import numpy as np

from .discovery import DiscoveredModel
from .repository import EventRepository

__all__ = [
    "ModelSpec",
    "ReplayResult",
    "model_tables",
    "deviation_census",
    "replay_core",
    "replay_fitness",
]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Canonical, hashable mirror of :class:`DiscoveredModel` — exactly the
    information replay/alignment consumes (the edge relation plus start/end
    sets), sorted so two equivalent models share one plan-cache key."""

    activities: Tuple[str, ...]
    edges: Tuple[Tuple[str, str], ...]
    starts: Tuple[str, ...]
    ends: Tuple[str, ...]

    @staticmethod
    def from_model(
        model: Union[DiscoveredModel, "ModelSpec"]
    ) -> "ModelSpec":
        if isinstance(model, ModelSpec):
            return model
        return ModelSpec(
            activities=tuple(model.activities),
            edges=tuple(sorted(model.edge_set)),
            starts=tuple(sorted(model.start_activities)),
            ends=tuple(sorted(model.end_activities)),
        )


def model_tables(
    model: Union[DiscoveredModel, ModelSpec], names: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(allowed (A,A), start_ok (A,), end_ok (A,)) boolean tables of the
    model over the activity axis ``names``.  Model activities absent from
    ``names`` are simply not representable (their edges drop); activities in
    ``names`` unknown to the model get all-False rows — both directions of
    vocabulary mismatch degrade to "move not allowed", never an error."""
    spec = ModelSpec.from_model(model)
    idx = {n: i for i, n in enumerate(names)}
    a = len(names)
    allowed = np.zeros((a, a), dtype=bool)
    for s, d in spec.edges:
        si, di = idx.get(s), idx.get(d)
        if si is not None and di is not None:
            allowed[si, di] = True
    start_ok = np.zeros(a, dtype=bool)
    for s in spec.starts:
        si = idx.get(s)
        if si is not None:
            start_ok[si] = True
    end_ok = np.zeros(a, dtype=bool)
    for e in spec.ends:
        ei = idx.get(e)
        if ei is not None:
            end_ok[ei] = True
    return allowed, start_ok, end_ok


def deviation_census(
    bad_src: np.ndarray, bad_dst: np.ndarray, names: Sequence[str]
) -> Dict[tuple, int]:
    """``(src_name, dst_name) → count`` over disallowed moves, vectorized:
    pairs are encoded as ``src·A + dst`` ids and counted with one
    ``np.unique``."""
    if bad_src.shape[0] == 0:
        return {}
    a = len(names)
    keys = bad_src.astype(np.int64) * a + bad_dst.astype(np.int64)
    uniq, counts = np.unique(keys, return_counts=True)
    return {
        (names[int(k // a)], names[int(k % a)]): int(c)
        for k, c in zip(uniq, counts)
    }


@dataclasses.dataclass
class ReplayResult:
    fitness: float  # mean trace fitness in [0, 1]
    trace_fitness: np.ndarray  # (T,)
    perfectly_fitting: int  # traces with fitness == 1
    deviating_edges: Dict[tuple, int]  # (src, dst) → count of disallowed moves

    def summary(self) -> Dict:
        worst = sorted(
            self.deviating_edges.items(), key=lambda kv: -kv[1]
        )[:5]
        return {
            "fitness": round(self.fitness, 4),
            "perfect_traces": self.perfectly_fitting,
            "total_traces": int(self.trace_fitness.shape[0]),
            "top_deviations": [
                {"edge": list(e), "count": c} for e, c in worst
            ],
        }


def replay_core(
    a: np.ndarray,
    t: np.ndarray,
    num_traces: int,
    allowed: np.ndarray,
    start_ok: np.ndarray,
    end_ok: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Token replay over canonical (trace-contiguous) event columns.

    Returns ``(trace_fitness (T,), bad_src, bad_dst)`` — the per-trace
    scores plus the disallowed directly-follows pairs for the census.  This
    is the one arithmetic every replay path (columnar, streaming, graph)
    must reproduce bit for bit.
    """
    T = int(num_traces)
    lens = np.bincount(t, minlength=T)

    ok_moves = np.zeros(T, dtype=np.int64)
    bad_src = np.zeros((0,), dtype=np.int64)
    bad_dst = np.zeros((0,), dtype=np.int64)
    if a.shape[0] >= 2:
        same = t[:-1] == t[1:]
        edge_ok = allowed[a[:-1], a[1:]]
        move_ok = edge_ok & same
        np.add.at(ok_moves, t[:-1][same], move_ok[same].astype(np.int64))
        bad = same & ~edge_ok
        bad_src = a[:-1][bad].astype(np.int64)
        bad_dst = a[1:][bad].astype(np.int64)

    starts_fit = np.zeros(T, dtype=np.int64)
    ends_fit = np.zeros(T, dtype=np.int64)
    if a.shape[0]:
        is_start = np.ones(a.shape[0], dtype=bool)
        is_start[1:] = t[1:] != t[:-1]
        is_end = np.ones(a.shape[0], dtype=bool)
        is_end[:-1] = t[:-1] != t[1:]
        np.add.at(
            starts_fit, t[is_start], start_ok[a[is_start]].astype(np.int64)
        )
        np.add.at(ends_fit, t[is_end], end_ok[a[is_end]].astype(np.int64))

    denom = np.maximum(lens + 1, 1)  # (len-1) moves + start + end
    trace_fit = (ok_moves + starts_fit + ends_fit) / denom
    return trace_fit, bad_src, bad_dst


def replay_fitness(
    repo: EventRepository, model: Union[DiscoveredModel, ModelSpec]
) -> ReplayResult:
    names = repo.activity_names
    allowed, start_ok, end_ok = model_tables(model, names)
    trace_fit, bad_src, bad_dst = replay_core(
        repo.event_activity, repo.event_trace, repo.num_traces,
        allowed, start_ok, end_ok,
    )
    return ReplayResult(
        fitness=float(trace_fit.mean()) if trace_fit.shape[0] else 1.0,
        trace_fitness=trace_fit,
        perfectly_fitting=int((trace_fit >= 1.0 - 1e-12).sum()),
        deviating_edges=deviation_census(bad_src, bad_dst, names),
    )
