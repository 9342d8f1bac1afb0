"""Dicing — the paper's WHERE-clause filtering (Experiment 2).

Two semantics are provided:

* **Paper semantics** (:func:`pair_mask_for_window`): the E×E relation is
  fixed; a directly-follows pair is counted iff *both* endpoint events fall
  in the window.  This matches the Cypher query with an added WHERE clause
  and is the semantics used by the benchmarks.

* **pm4py semantics** (:func:`dice_repository`): filter events, then
  re-link survivors within each trace (events that become adjacent after
  removal *do* count).  Provided for apples-to-apples baseline comparison.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .repository import EventRepository

__all__ = [
    "event_mask_for_window",
    "pair_mask_for_window",
    "event_mask_for_activities",
    "dice_repository",
]


def event_mask_for_window(
    repo: EventRepository, window: Tuple[float, float]
) -> np.ndarray:
    """Boolean per-event mask for ``t0 <= time < t1``."""
    t0, t1 = window
    ts = repo.event_time
    return (ts >= t0) & (ts < t1)


def pair_mask_for_window(
    repo: EventRepository, window: Tuple[float, float]
) -> np.ndarray:
    """Per-pair mask (length E-1): both endpoints inside the window."""
    m = event_mask_for_window(repo, window)
    if m.shape[0] < 2:
        return np.zeros((0,), dtype=bool)
    return m[:-1] & m[1:]


def event_mask_for_activities(
    repo: EventRepository, keep: Sequence[str]
) -> np.ndarray:
    keep_ids = np.asarray(
        [repo.activity_names.index(a) for a in keep], dtype=np.int32
    )
    return np.isin(repo.event_activity, keep_ids)


def dice_repository(
    repo: EventRepository,
    *,
    time_window: Optional[Tuple[float, float]] = None,
    activities: Optional[Sequence[str]] = None,
) -> EventRepository:
    """pm4py-style dicing: materialize the filtered repository with events
    re-linked within traces.  O(E) array work on the host, no
    per-event Python; used for baseline comparisons, for analysts who
    explicitly request re-linking semantics and for the query engine's
    relink barrier."""
    mask = np.ones(repo.num_events, dtype=bool)
    if time_window is not None:
        mask &= event_mask_for_window(repo, time_window)
    if activities is not None:
        mask &= event_mask_for_activities(repo, activities)
    idx = np.nonzero(mask)[0]
    # the surviving traces, renumbered in their old order through one index
    # array (old trace id → new)
    kept_trace = repo.event_trace[idx]
    present = np.zeros(repo.num_traces, dtype=bool)
    present[kept_trace] = True
    kept_traces = np.nonzero(present)[0]
    old_to_new = np.cumsum(present) - 1
    names = repo.trace_names
    return EventRepository(
        event_activity=repo.event_activity[idx].copy(),
        event_trace=old_to_new[kept_trace].astype(np.int32),
        event_time=repo.event_time[idx].copy(),
        trace_log=repo.trace_log[kept_traces].copy(),
        activity_names=list(repo.activity_names),
        trace_names=[names[t] for t in kept_traces.tolist()],
        log_names=list(repo.log_names),
    )
