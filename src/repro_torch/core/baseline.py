"""pm4py-style in-memory baseline — the approach the paper compares against.

Mirrors the algorithmic shape of ``pm4py.algo.discovery.dfg``: parse the
*entire* log into per-case event lists in memory, sort each case by
timestamp, then count adjacent pairs with a dict.  Deliberately
load-everything-first (that is the point of the comparison: it fails when
the log exceeds memory, and it wins on full-log in-memory scans).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

__all__ = ["InMemoryDFGBaseline", "dfg_from_rows"]


class LogTooLargeError(MemoryError):
    """Raised when the configured memory budget would be exceeded while
    loading (models the pm4py container OOM in the paper's Experiment 1)."""


class InMemoryDFGBaseline:
    def __init__(self, memory_budget_bytes: Optional[int] = None):
        self.memory_budget_bytes = memory_budget_bytes

    def load(
        self, rows: Iterable[Tuple[int, int, float]]
    ) -> Dict[int, list]:
        """rows: iterable of (case_id, activity_id, timestamp).

        Loads everything into a per-case dict of event lists — the
        in-memory representation whose size is what the paper's Fig. 4
        varies RAM against."""
        cases: Dict[int, list] = defaultdict(list)
        approx = 0
        for case, act, ts in rows:
            cases[case].append((ts, act))
            approx += 64  # tuple + list slot, ballpark python overhead
            if (
                self.memory_budget_bytes is not None
                and approx > self.memory_budget_bytes
            ):
                raise LogTooLargeError(
                    f"in-memory load exceeded budget "
                    f"({approx} > {self.memory_budget_bytes} bytes)"
                )
        return cases

    def dfg(
        self,
        rows: Iterable[Tuple[int, int, float]],
        num_activities: int,
        time_window: Optional[Tuple[float, float]] = None,
    ) -> np.ndarray:
        """Load-then-count.  ``time_window`` filters events *after* the full
        load (pm4py loads the XES first, filters second) — this asymmetry is
        exactly what Experiment 2 measures."""
        cases = self.load(rows)
        psi = np.zeros((num_activities, num_activities), dtype=np.int64)
        for evs in cases.values():
            evs.sort()
            if time_window is not None:
                t0, t1 = time_window
                evs = [e for e in evs if t0 <= e[0] < t1]
            for (t_a, a), (t_b, b) in zip(evs, evs[1:]):
                psi[a, b] += 1
        return psi


def dfg_from_rows(
    rows: Iterable[Tuple[int, int, float]], num_activities: int
) -> np.ndarray:
    return InMemoryDFGBaseline().dfg(rows, num_activities)
