"""Process discovery on top of the DFG (paper Fig. 1, step 3).

The paper deliberately separates DFG computation (heavy, in-store) from model
inference (light, on the analyst side) — "this step usually does not take
much time since the computation is performed on top of DFG".  We implement
the standard DFG-based discovery stack so the framework is end-to-end:

* frequency filtering (spaghetti-model control, §5.2),
* heuristics-miner dependency measures and dependency-graph discovery,
* DOT export for visualization.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = [
    "filter_dfg",
    "dependency_matrix",
    "DiscoveredModel",
    "discover_dependency_graph",
    "to_dot",
]

START = "<start>"
END = "<end>"


def filter_dfg(psi: np.ndarray, min_count: int = 1) -> np.ndarray:
    """Drop edges below a frequency threshold (keeps the 'big picture')."""
    out = psi.copy()
    out[out < min_count] = 0
    return out


def dependency_matrix(psi: np.ndarray) -> np.ndarray:
    """Heuristics-miner dependency measure
    ``dep(a,b) = (|a>b| - |b>a|) / (|a>b| + |b>a| + 1)`` (a≠b) and
    ``dep(a,a) = |a>a| / (|a>a| + 1)`` for self-loops."""
    f = psi.astype(np.float64)
    ft = f.T
    dep = (f - ft) / (f + ft + 1.0)
    self_loops = np.diag(f) / (np.diag(f) + 1.0)
    np.fill_diagonal(dep, self_loops)
    return dep


@dataclasses.dataclass
class DiscoveredModel:
    activities: List[str]
    edges: List[Tuple[str, str, int, float]]  # (src, dst, count, dependency)
    start_activities: Dict[str, int]
    end_activities: Dict[str, int]

    @property
    def edge_set(self) -> set:
        return {(s, d) for (s, d, _, _) in self.edges}


def discover_dependency_graph(
    psi: np.ndarray,
    activity_names: Sequence[str],
    start_counts: np.ndarray,
    end_counts: np.ndarray,
    *,
    min_count: int = 1,
    min_dependency: float = 0.5,
) -> DiscoveredModel:
    """Heuristics-style dependency-graph discovery from the DFG."""
    dep = dependency_matrix(psi)
    edges: List[Tuple[str, str, int, float]] = []
    a_n = list(activity_names)
    for i in range(psi.shape[0]):
        for j in range(psi.shape[1]):
            c = int(psi[i, j])
            if c >= min_count and dep[i, j] >= min_dependency:
                edges.append((a_n[i], a_n[j], c, float(dep[i, j])))
    starts = {a_n[i]: int(c) for i, c in enumerate(start_counts) if c > 0}
    ends = {a_n[i]: int(c) for i, c in enumerate(end_counts) if c > 0}
    return DiscoveredModel(
        activities=a_n, edges=edges, start_activities=starts, end_activities=ends
    )


def to_dot(model: DiscoveredModel) -> str:
    lines = ["digraph dfg {", "  rankdir=LR;", '  node [shape=box];']
    lines.append(f'  "{START}" [shape=circle,label="▶"];')
    lines.append(f'  "{END}" [shape=doublecircle,label="■"];')
    for a, c in model.start_activities.items():
        lines.append(f'  "{START}" -> "{a}" [label="{c}"];')
    for s, d, c, dep in model.edges:
        lines.append(f'  "{s}" -> "{d}" [label="{c} ({dep:.2f})"];')
    for a, c in model.end_activities.items():
        lines.append(f'  "{a}" -> "{END}" [label="{c}"];')
    lines.append("}")
    return "\n".join(lines)
