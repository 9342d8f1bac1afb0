"""Graph-native sinks: topology queries answered from the CSR store.

Everything here consumes the aggregated ``:DF`` CSR (plus node degrees) —
never the event stream — which is exactly what makes the second-and-later
topology query cheap: once :func:`repro_torch.graph.build.build_graph` has
materialized the relation, a k-hop neighborhood is a few ``indptr`` lookups
and a process map is an O(nnz) sort, independent of E.

The columnar execution paths produce **the same results bit for bit** by
routing through the same derivation functions: they count their dense Ψ,
sparsify it with :func:`~repro_torch.graph.build.csr_from_dense`, and call
:func:`derive_neighborhood` / :func:`derive_process_map` — CSR is uniquely
determined by Ψ, so graph-vs-columnar equivalence reduces to the DFG
equivalence the engine already pins against Algorithm 1.

* :func:`dfg_from_graph` — Algorithm 1 as a store lookup (densify CSR);
* :func:`neighborhood` — k-hop successor/predecessor BFS with the induced
  edge subgraph;
* :func:`path_frequencies` — frequency-weighted walk counts ``(Ψ^ℓ)[a, b]``
  via repeated CSR matvec (never densifying powers);
* :func:`process_map` — ProFIT-style significance filter: top-fraction
  nodes by event frequency, then top-fraction edges among the kept nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .build import CSR, EventGraph

__all__ = [
    "Neighborhood",
    "ProcessMap",
    "dfg_from_graph",
    "neighborhood",
    "derive_neighborhood",
    "path_frequencies",
    "process_map",
    "derive_process_map",
]


# ---------------------------------------------------------------------------
# DFG — Algorithm 1 as a lookup
# ---------------------------------------------------------------------------


def dfg_from_graph(g: EventGraph) -> np.ndarray:
    """The Ψ count matrix from the materialized ``:DF`` relation —
    bit-identical to Algorithm 1 on the source (pinned by tests)."""
    return g.psi()


# ---------------------------------------------------------------------------
# k-hop neighborhoods
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Neighborhood:
    """The k-hop ``:DF`` neighborhood of one activity.

    ``activities`` lists the reached nodes in (hop, id) order — the center
    first at hop 0; ``hops`` maps each to its minimal distance; ``edges``
    is the induced subgraph among reached nodes as ``(src, dst, count)``
    triples (deterministic (src, dst) order).
    """

    center: str
    k: int
    direction: str
    activities: List[str]
    hops: Dict[str, int]
    edges: List[Tuple[str, str, int]]


def _frontier_expand(csr: CSR, frontier: np.ndarray) -> np.ndarray:
    """All CSR neighbors of the frontier ids (deduplicated, ascending)."""
    if frontier.shape[0] == 0:
        return frontier
    parts = [
        csr.indices[csr.indptr[a] : csr.indptr[a + 1]] for a in frontier
    ]
    if not parts:
        return np.zeros((0,), dtype=np.int64)
    return np.unique(np.concatenate(parts)).astype(np.int64)


def derive_neighborhood(
    adj: CSR,
    radj: CSR,
    names: Sequence[str],
    center: str,
    k: int = 1,
    direction: str = "out",
) -> Neighborhood:
    if direction not in ("out", "in", "both"):
        raise ValueError(f"direction must be out|in|both, got {direction!r}")
    if center not in names:
        raise ValueError(
            f"unknown activity {center!r}; graph has {len(names)} activities"
        )
    c = list(names).index(center)
    hop_of = {c: 0}
    frontier = np.asarray([c], dtype=np.int64)
    for hop in range(1, int(k) + 1):
        nxt = []
        if direction in ("out", "both"):
            nxt.append(_frontier_expand(adj, frontier))
        if direction in ("in", "both"):
            nxt.append(_frontier_expand(radj, frontier))
        reached = (
            np.unique(np.concatenate(nxt)) if nxt else
            np.zeros((0,), dtype=np.int64)
        )
        fresh = [int(a) for a in reached if int(a) not in hop_of]
        for a in fresh:
            hop_of[a] = hop
        frontier = np.asarray(fresh, dtype=np.int64)
        if frontier.shape[0] == 0:
            break
    # (hop, id) order keeps the result deterministic and center-first
    ordered = sorted(hop_of, key=lambda a: (hop_of[a], a))
    kept = set(ordered)
    edges: List[Tuple[str, str, int]] = []
    for a in ordered:
        cols, cnts = adj.row(a)
        for b, n in zip(cols, cnts):
            if int(b) in kept:
                edges.append((names[a], names[int(b)], int(n)))
    edges.sort(key=lambda e: (e[0], e[1]))
    return Neighborhood(
        center=center,
        k=int(k),
        direction=direction,
        activities=[names[a] for a in ordered],
        hops={names[a]: hop_of[a] for a in ordered},
        edges=edges,
    )


def neighborhood(
    g: EventGraph, center: str, k: int = 1, direction: str = "out"
) -> Neighborhood:
    """k-hop neighborhood straight off the stored CSR — the repeated-query
    fast path (no Ψ recompute, no event scan)."""
    return derive_neighborhood(
        g.adj, g.radj, g.activity_names, center, k, direction
    )


# ---------------------------------------------------------------------------
# Path frequencies
# ---------------------------------------------------------------------------


def path_frequencies(
    g: EventGraph, src: str, dst: str, max_hops: int = 4
) -> np.ndarray:
    """Frequency-weighted walk counts: entry ``ℓ-1`` is ``(Ψ^ℓ)[src, dst]``
    for ℓ = 1..max_hops — "how much flow reaches ``dst`` from ``src`` in
    exactly ℓ directly-follows steps".  Computed as repeated CSR matvecs
    (O(max_hops · nnz)); float64 because walk weights compound."""
    names = g.activity_names
    for x in (src, dst):
        if x not in names:
            raise ValueError(f"unknown activity {x!r}")
    s, d = names.index(src), names.index(dst)
    a = g.num_activities
    rows = np.repeat(
        np.arange(a, dtype=np.int64), np.diff(g.adj.indptr).astype(np.int64)
    )
    v = np.zeros(a, dtype=np.float64)
    v[s] = 1.0
    out = np.zeros(int(max_hops), dtype=np.float64)
    for hop in range(int(max_hops)):
        # v ← v @ Ψ  via the CSR triplets
        v = np.bincount(
            g.adj.indices.astype(np.int64),
            weights=v[rows] * g.adj.counts,
            minlength=a,
        )
        out[hop] = v[d]
    return out


# ---------------------------------------------------------------------------
# Significance-filtered process map (ProFIT-style)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ProcessMap:
    """A significance-filtered process map.

    ``activities`` / ``node_counts`` are the kept nodes (original axis
    order) with their event frequencies; ``edges`` the kept ``:DF`` edges
    as ``(src, dst, count)``, most frequent first.  ``dropped_*`` record
    what the filter removed, so a dashboard can say "showing top 20%".
    """

    top: float
    edge_top: float
    activities: List[str]
    node_counts: np.ndarray
    edges: List[Tuple[str, str, int]]
    dropped_activities: int
    dropped_edges: int


def _top_fraction(order: np.ndarray, frac: float) -> np.ndarray:
    """First ``ceil(frac · n)`` entries of a significance-sorted id list."""
    n = order.shape[0]
    if n == 0:
        return order
    keep = min(n, max(1, int(np.ceil(float(frac) * n))))
    return order[:keep]


def derive_process_map(
    adj: CSR,
    node_counts: np.ndarray,
    names: Sequence[str],
    top: float = 0.2,
    edge_top: Optional[float] = None,
) -> ProcessMap:
    """ProFIT-style filter: rank Activity nodes by event frequency and keep
    the top ``top`` fraction (of the *observed* nodes); then rank the
    ``:DF`` edges among kept nodes by count and keep the top ``edge_top``
    (default ``top``) fraction.  Ties break by id, so the map is
    deterministic and identical across execution backends."""
    if not 0.0 < float(top) <= 1.0:
        raise ValueError(f"top must be in (0, 1], got {top}")
    edge_top = float(top if edge_top is None else edge_top)
    if not 0.0 < edge_top <= 1.0:
        raise ValueError(f"edge_top must be in (0, 1], got {edge_top}")
    names = list(names)
    node_counts = np.asarray(node_counts, dtype=np.int64)
    active = np.nonzero(node_counts > 0)[0]
    order = active[np.lexsort((active, -node_counts[active]))]
    kept_ids = np.sort(_top_fraction(order, float(top)))
    kept = set(int(a) for a in kept_ids)

    a = adj.num_nodes
    rows = np.repeat(
        np.arange(a, dtype=np.int64), np.diff(adj.indptr).astype(np.int64)
    )
    in_kept = np.isin(rows, kept_ids) & np.isin(
        adj.indices.astype(np.int64), kept_ids
    )
    esrc = rows[in_kept]
    edst = adj.indices[in_kept].astype(np.int64)
    ecnt = adj.counts[in_kept]
    eorder = np.lexsort((edst, esrc, -ecnt))
    ekeep = _top_fraction(eorder, edge_top)
    edges = [
        (names[int(esrc[i])], names[int(edst[i])], int(ecnt[i]))
        for i in ekeep
    ]
    return ProcessMap(
        top=float(top),
        edge_top=edge_top,
        activities=[names[int(i)] for i in kept_ids],
        node_counts=node_counts[kept_ids],
        edges=edges,
        dropped_activities=int(active.shape[0] - kept_ids.shape[0]),
        dropped_edges=int(esrc.shape[0] - len(edges)),
    )


def process_map(
    g: EventGraph, top: float = 0.2, edge_top: Optional[float] = None
) -> ProcessMap:
    """Significance-filtered map straight off the stored CSR + node degrees
    — only the graph representation makes this a sub-millisecond call."""
    return derive_process_map(
        g.adj, g.node_counts, g.activity_names, top, edge_top
    )
