"""Access-control views — the privacy mechanism of the paper (§2.2, §6.2).

In Neo4j the paper relies on fine-grained / sub-graph access control so that
analysts can compute the DFG without ever reading events or resources.  Here
the same guarantees are enforced structurally:

* :class:`ActivityView` — projection/coarsening of the attribute set: map
  each activity to a group label (the "postal-code level" example) or hide
  it.  Applied to a DFG matrix it aggregates rows/columns; applied before
  computation it relabels in-store.

* :class:`AccessPolicy` + :class:`AnalystSession` — capability wrapper: an
  analyst session holds the repository *opaque* and only exposes aggregate
  endpoints (DFG, activity histogram, trace-length stats).  Raw columns are
  unreachable through the session object, mirroring "grant access to traverse
  relations but not see node properties".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .repository import EventRepository

__all__ = ["ActivityView", "AccessPolicy", "AccessDenied", "AnalystSession",
           "HIDDEN"]

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


@dataclasses.dataclass
class AccessPolicy:
    """What an analyst may see.  ``aggregate_only=True`` is the paper's
    headline guarantee: DFG out, raw events never."""

    aggregate_only: bool = True
    view: Optional[ActivityView] = None
    time_windows_allowed: bool = True  # may the analyst dice by time?
    min_group_count: int = 0  # optional k-anonymity floor on reported counts


class AccessDenied(PermissionError):
    pass


class AnalystSession:
    """Capability-style handle: all queries run *in-store* and only
    aggregates cross the boundary.

    Aggregate endpoints compile to :mod:`repro_torch.query` plans, so analyst
    traffic gets the engine's predicate pushdown and the shared plan/result
    cache (repeated dashboard queries are O(1)).  Without ``engine`` they run
    on the shared default engine, which counts on the card (the
    ``dfg_count`` CUDA kernel, a time window fused into it)."""

    def __init__(self, repo: EventRepository, policy: AccessPolicy, engine=None):
        self.__repo = repo  # name-mangled: not reachable as a public attr
        self.policy = policy
        self.__engine = engine

    def __query(self):
        from repro_torch.query import Q

        q = Q.log(self.__repo)
        if self.__engine is not None:
            q = q.using(self.__engine)
        if self.policy.view is not None:
            q = q.view(self.policy.view)
        return q

    # -- aggregate endpoints -------------------------------------------------
    def dfg(
        self,
        time_window: Optional[Tuple[float, float]] = None,
        backend: str = "auto",
    ) -> Tuple[np.ndarray, List[str]]:
        if time_window is not None and not self.policy.time_windows_allowed:
            raise AccessDenied("time dicing not permitted by policy")
        q = self.__query()
        if time_window is not None:
            q = q.window(*time_window)  # commutes with the view in the plan
        res = q.dfg(backend=backend)
        psi, names = res.value, list(res.names)
        if self.policy.min_group_count:
            psi = np.where(psi >= self.policy.min_group_count, psi, 0)
        return psi, names

    def activity_histogram(self) -> Tuple[np.ndarray, List[str]]:
        res = self.__query().histogram()
        return res.value, list(res.names)

    def trace_length_stats(self) -> Dict[str, float]:
        lens = np.bincount(self.__repo.event_trace, minlength=self.__repo.num_traces)
        return {
            "num_traces": float(self.__repo.num_traces),
            "num_events": float(self.__repo.num_events),
            "mean": float(lens.mean()) if lens.size else 0.0,
            "max": float(lens.max()) if lens.size else 0.0,
        }

    # -- raw access is denied --------------------------------------------------
    def events(self):
        if self.policy.aggregate_only:
            raise AccessDenied("policy is aggregate-only: raw events are not exposed")
        return (
            self.__repo.event_activity.copy(),
            self.__repo.event_trace.copy(),
            self.__repo.event_time.copy(),
        )
