"""DFG-based trace alignments — optimal skip/insert edit distance over the
model's edge relation.

Token replay (:mod:`repro_torch.conformance.replay`) scores how many
observed moves the model allows; alignments answer the stronger question
"what is the *cheapest explanation* of each trace as a walk through the
model":

* **synchronous move** (cost 0) — the model executes the observed event;
* **move on log** (cost 1) — the event is skipped (observed but not
  explainable);
* **move on model** (cost 1) — the model executes an activity the trace
  does not contain (required but unobserved).

On the DFG abstraction the model is the edge relation plus virtual
START/END, so the optimal alignment is a shortest path whose layered DP has
one state per model activity.  Two closures make each DP layer O(S) instead
of a per-layer graph search:

* ``D`` — all-pairs model-move distances (min-plus APSP over the edge
  relation, START-augmented);
* ``M[s, a] = min_{s'→a allowed} D[s, s']`` — "any number of model moves,
  then sync on ``a``", one f32 table reused by every trace.

The closures are small (S² for S model states) and stay numpy on the host.
The DP is **batched across the variant table** (cost is per *variant*, not
per trace) and runs through :mod:`repro_torch.kernels.align_dp`: the CUDA
kernel on a card, its plain PyTorch version on the CPU, bit-identical.

``fitness(trace) = 1 − cost / (len(trace) + empty_cost)`` with
``empty_cost`` the cheapest START→END model walk — the standard
worst-case-normalized alignment fitness.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.conformance import ModelSpec, deviation_census, model_tables
from repro_torch.core.discovery import DiscoveredModel
from repro_torch.core.repository import EventRepository
from repro_torch.core.variants import TraceVariants, variant_table
from repro_torch.kernels.align_dp import BIG_COST, align_dp_ragged

__all__ = [
    "AlignmentResult",
    "alignment_cost_tables",
    "variant_ids",
    "variant_matrix",
    "align_variants",
    "finish_variant_costs",
    "finish_alignment",
    "align_repository",
    "align_arrays",
]


@dataclasses.dataclass
class AlignmentResult:
    """Optimal-alignment conformance of a log against a DFG model.

    ``trace_cost`` / ``trace_fitness`` are per trace (aligned with the
    source's trace order); ``variant_costs`` the per-variant DP output the
    trace arrays were broadcast from.  ``deviating_edges`` is the same
    disallowed-move census replay reports (the *where* of the cost)."""

    fitness: float  # mean normalized trace fitness in [0, 1]
    trace_cost: np.ndarray  # (T,) int64 optimal alignment cost
    trace_fitness: np.ndarray  # (T,) float64
    variant_costs: np.ndarray  # (V,) int64
    perfectly_fitting: int  # traces with cost == 0
    empty_cost: int  # cheapest START→END model walk (∞ → -1)
    deviating_edges: Dict[tuple, int]

    def summary(self) -> Dict:
        worst = sorted(
            self.deviating_edges.items(), key=lambda kv: -kv[1]
        )[:5]
        return {
            "fitness": round(self.fitness, 4),
            "perfect_traces": self.perfectly_fitting,
            "total_traces": int(self.trace_cost.shape[0]),
            "mean_cost": (
                round(float(self.trace_cost.mean()), 4)
                if self.trace_cost.shape[0] else 0.0
            ),
            "top_deviations": [
                {"edge": list(e), "count": c} for e, c in worst
            ],
        }


def alignment_cost_tables(
    model: Union[DiscoveredModel, ModelSpec], names: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(M (S, A), d0 (S,), endcost (S,)) for the layered DP, f32.

    State ``s`` ranges over the **model ∪ log universe** plus a virtual
    START: model moves may route through activities the log never executes,
    so activities the model knows and ``names`` lacks are appended as extra
    states.  Sync columns exist only for the observable ``names``.
    ``M[s, a]`` folds any number of model moves followed by a sync on
    ``a``; ``endcost[s]`` the model moves to reach an end-allowed activity.
    Unreachable entries carry :data:`BIG_COST`.
    """
    spec = ModelSpec.from_model(model)
    universe = list(names) + [
        m for m in spec.activities if m not in set(names)
    ]
    allowed, start_ok, end_ok = model_tables(spec, universe)
    a = len(names)  # observable sync columns
    s = len(universe) + 1  # + virtual START
    u = len(universe)
    big = np.float32(BIG_COST)

    # hop cost matrix over the augmented edge relation (hop x→y executes y)
    w = np.full((s, s), big, dtype=np.float32)
    w[:u, :u][allowed] = 1.0
    w[u, :u][start_ok] = 1.0
    d = w.copy()
    np.fill_diagonal(d, 0.0)
    for k in range(s):  # Floyd–Warshall, vectorized per pivot
        np.minimum(d, d[:, k, None] + d[None, k, :], out=d)
    d = np.minimum(d, big)

    # sync closure: M[x, t] = min over x' with x'→t allowed of D[x, x']
    sync_in = np.full((s, a), big, dtype=np.float32)
    sync_in[:u, :][allowed[:, :a]] = 0.0
    sync_in[u, :][start_ok[:a]] = 0.0
    m = np.full((s, a), big, dtype=np.float32)
    for t in range(a):  # O(S·A) per column, states on the fast axis
        col = sync_in[:, t]
        reach = col < big
        if reach.any():
            m[:, t] = d[:, reach].min(axis=1)
    m = np.minimum(m, big)

    d0 = np.full((s,), big, dtype=np.float32)
    d0[u] = 0.0
    end_states = np.nonzero(end_ok)[0]
    endcost = (
        d[:, end_states].min(axis=1)
        if end_states.shape[0]
        else np.full((s,), big, dtype=np.float32)
    )
    return m, d0, np.minimum(endcost, big).astype(np.float32)


def variant_ids(tv: TraceVariants, names: Sequence[str]) -> np.ndarray:
    """The variant table's ids, back to back (``tv.variant_activity``,
    sliced by ``tv.variant_offsets``), as ids over ``names``: taken
    straight from the table, renumbered only where ``names`` orders the
    labels differently."""
    ids = tv.variant_activity
    idx = {n: i for i, n in enumerate(names)}
    remap = np.asarray([idx[n] for n in tv.activity_names], dtype=np.int64)
    if not np.array_equal(remap, np.arange(remap.shape[0])):
        ids = remap[ids]
    return ids


def variant_matrix(
    tv: TraceVariants, names: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray]:
    """(seqs (V, max(L, 1)) int32, lens (V,) int32): each variant's
    representative sequence as ids over ``names`` (:func:`variant_ids`),
    zero-padded to the longest.  The engine's DP takes the ragged ids
    instead; this is the reference's padded layout."""
    v = tv.num_variants
    lens = tv.lengths.astype(np.int32)
    lp = int(lens.max()) if v else 0
    seqs = np.zeros((v, max(lp, 1)), dtype=np.int32)
    ids = variant_ids(tv, names)
    rows = np.repeat(np.arange(v), lens)
    cols = np.arange(ids.shape[0]) - np.repeat(tv.variant_offsets[:-1], lens)
    seqs[rows, cols] = ids
    return seqs, lens


def align_variants(
    tv: TraceVariants,
    names: Sequence[str],
    model: Union[DiscoveredModel, ModelSpec],
    *,
    backend: str = "auto",
    device="cuda",
) -> Tuple[np.ndarray, int]:
    """(per-variant optimal costs (V,) int64, empty_cost) via the batched
    DP.  The variant table's ragged ids and offsets go to the DP as they
    are (no padded matrix); ``backend`` routes it (auto | numpy | kernel,
    see :func:`repro_torch.kernels.align_dp.align_dp_ragged`) on
    ``device``."""
    m, d0, endcost = alignment_cost_tables(model, names)
    empty = float((d0 + endcost).min())
    empty_cost = -1 if empty >= BIG_COST / 2 else int(empty)

    if tv.num_variants == 0:
        return np.zeros((0,), dtype=np.int64), empty_cost
    raw = align_dp_ragged(
        variant_ids(tv, names), tv.variant_offsets, m, d0, endcost,
        backend=backend, device=device,
    )
    return finish_variant_costs(raw, tv.lengths), empty_cost


def finish_variant_costs(raw: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The DP's raw f32 costs as int64 variant costs: an unalignable variant
    (the model has no START→END walk) degrades to all-log-moves against the
    empty walk, so its cost is its length."""
    costs = np.asarray(raw, dtype=np.float64)
    unreachable = costs >= BIG_COST / 2
    costs = np.where(unreachable, lens.astype(np.float64), costs)
    return np.round(costs).astype(np.int64)


def align_arrays(
    activity: np.ndarray,
    trace: np.ndarray,
    names: Sequence[str],
    model: Union[DiscoveredModel, ModelSpec],
    num_traces: Optional[int] = None,
    *,
    backend: str = "auto",
    device="cuda",
) -> AlignmentResult:
    """Alignments over canonical (trace-contiguous) event columns — the
    array-level core every path (repository, graph tables, transformed
    selections) shares; nothing is materialized beyond the variant table.
    The DP runs on ``device`` (the CUDA kernel on a card)."""
    names = list(names)
    a_col = np.asarray(activity)
    if num_traces is None:
        uniq, t_col = np.unique(np.asarray(trace), return_inverse=True)
        T = int(uniq.shape[0])
    else:
        t_col, T = np.asarray(trace), int(num_traces)
    tv = variant_table(a_col, t_col, T, names)
    variant_costs, empty_cost = align_variants(
        tv, names, model, backend=backend, device=device
    )
    return finish_alignment(
        a_col, t_col, T, names, model, tv, variant_costs, empty_cost
    )


def finish_alignment(
    a_col: np.ndarray,
    t_col: np.ndarray,
    T: int,
    names: Sequence[str],
    model: Union[DiscoveredModel, ModelSpec],
    tv: TraceVariants,
    variant_costs: np.ndarray,
    empty_cost: int,
) -> AlignmentResult:
    """Broadcast the variant costs to traces, normalize, and take the census
    of disallowed observed moves."""
    trace_cost = (
        variant_costs[tv.trace_variant]
        if T and variant_costs.shape[0]
        else np.zeros((T,), dtype=np.int64)
    )
    lens = np.bincount(t_col, minlength=T).astype(np.int64)
    if empty_cost < 0:
        # no complete model walk exists: nothing aligns, fitness is 0 for
        # any non-empty trace
        fit = np.where(lens > 0, 0.0, 1.0).astype(np.float64)
    else:
        worst = np.maximum(lens + empty_cost, 1)
        fit = 1.0 - trace_cost / worst

    # the census of disallowed observed moves (same helper as replay)
    allowed, _s, _e = model_tables(model, names)
    census: Dict[tuple, int] = {}
    if a_col.shape[0] >= 2:
        same = t_col[:-1] == t_col[1:]
        bad = same & ~allowed[a_col[:-1], a_col[1:]]
        census = deviation_census(
            a_col[:-1][bad].astype(np.int64),
            a_col[1:][bad].astype(np.int64),
            names,
        )
    return AlignmentResult(
        fitness=float(fit.mean()) if T else 1.0,
        trace_cost=trace_cost,
        trace_fitness=fit,
        variant_costs=variant_costs,
        perfectly_fitting=int((trace_cost == 0).sum()) if T else 0,
        empty_cost=empty_cost,
        deviating_edges=census,
    )


def align_repository(
    repo: EventRepository,
    model: Union[DiscoveredModel, ModelSpec],
    *,
    backend: str = "auto",
    device="cuda",
) -> AlignmentResult:
    """Optimal DFG alignments of every trace, batched per variant."""
    return align_arrays(
        repo.event_activity, repo.event_trace, repo.activity_names, model,
        num_traces=repo.num_traces, backend=backend, device=device,
    )
