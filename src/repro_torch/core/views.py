"""Access-control views — the privacy mechanism of the paper (§2.2, §6.2).

In Neo4j the paper relies on fine-grained / sub-graph access control so that
analysts can compute the DFG without ever reading events or resources.  Here
the same guarantee is enforced structurally by :class:`ActivityView`, a
projection/coarsening of the attribute set: map each activity to a group
label (the "postal-code level" example) or hide it.  Applied to a DFG matrix
it aggregates rows/columns; applied before computation it relabels in-store.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["ActivityView", "HIDDEN"]

HIDDEN = "<hidden>"


@dataclasses.dataclass
class ActivityView:
    """Maps raw activity names to visible group labels (or HIDDEN)."""

    mapping: Dict[str, str]
    default: str = HIDDEN  # unmapped activities collapse here

    def visible_labels(self, activity_names: Sequence[str]) -> List[str]:
        labels = []
        for a in activity_names:
            g = self.mapping.get(a, self.default)
            if g not in labels:
                labels.append(g)
        return labels

    def group_matrix(self, activity_names: Sequence[str]) -> Tuple[np.ndarray, List[str]]:
        """One-hot (A, G) grouping matrix and the group label list."""
        labels = self.visible_labels(activity_names)
        gidx = {g: i for i, g in enumerate(labels)}
        m = np.zeros((len(activity_names), len(labels)), dtype=np.int64)
        for i, a in enumerate(activity_names):
            m[i, gidx[self.mapping.get(a, self.default)]] = 1
        return m, labels

    def apply_to_dfg(
        self, psi: np.ndarray, activity_names: Sequence[str]
    ) -> np.ndarray:
        """Ψ_view = Gᵀ Ψ G — aggregate counts at the group level.

        HIDDEN groups are removed from the result entirely (their flows are
        not exposed, matching sub-graph access control)."""
        g, labels = self.group_matrix(activity_names)
        out = g.T @ psi @ g
        keep = [i for i, l in enumerate(labels) if l != HIDDEN]
        return out[np.ix_(keep, keep)]

    def visible_names(self, activity_names: Sequence[str]) -> List[str]:
        return [l for l in self.visible_labels(activity_names) if l != HIDDEN]
