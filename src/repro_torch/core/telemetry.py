"""Runtime telemetry as event logs — the framework mines itself.

Every training/serving step emits process events (``load_batch → forward →
backward → grad_sync → optimizer → [checkpoint]``) into an in-memory
collector that converts to a standard :class:`EventRepository`.  Graph-based
process mining over these traces is the framework's fault/straggler
forensics: a healthy run's DFG is a clean chain; retries, restarts, and
stragglers appear as deviating variants and timing outliers.
"""

from __future__ import annotations

import contextlib
import threading
import time as _time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .repository import EventRepository
from ..analysis.lockdep import make_lock

__all__ = ["EventCollector", "StepTimer"]


class EventCollector:
    """Thread-safe append-only event collector.

    ``case`` is typically ``step-<n>`` (each training step is one trace),
    ``activity`` a phase name.  ``record`` is O(1); conversion to a
    repository is deferred.

    ``max_events`` turns the collector into a ring buffer: the oldest
    events are evicted once the bound is reached and counted in
    :attr:`dropped` (surfaced as a gauge in the engine's metrics
    registry).  Default is unbounded — long-lived serving processes
    should bound it (``ServeEngine`` and ``QueryEngine`` do)."""

    def __init__(self, log_name: str = "runtime",
                 max_events: Optional[int] = None):
        self.log_name = log_name
        self.max_events = max_events
        self._lock = make_lock("EventCollector")
        self._cases: deque = deque(maxlen=max_events)
        self._activities: deque = deque(maxlen=max_events)
        self._times: deque = deque(maxlen=max_events)
        self._durations: deque = deque(maxlen=max_events)
        self._recorded = 0

    def record(
        self,
        case: str,
        activity: str,
        timestamp: Optional[float] = None,
        duration: float = 0.0,
    ) -> None:
        with self._lock:
            self._cases.append(case)
            self._activities.append(activity)
            self._times.append(
                timestamp if timestamp is not None else _time.perf_counter()
            )
            self._durations.append(duration)
            self._recorded += 1

    def record_many(
        self,
        cases: Union[str, Sequence[str]],
        activities: Sequence[str],
        timestamps: Sequence[float],
        durations: Optional[Sequence[float]] = None,
    ) -> None:
        """Batch append taking the lock once — the engine's forensics
        hook records a whole query trace per call.  ``cases`` may be a
        single case id broadcast over every event."""
        n = len(activities)
        if isinstance(cases, str):
            cases = [cases] * n
        if durations is None:
            durations = [0.0] * n
        with self._lock:
            self._cases.extend(cases)
            self._activities.extend(activities)
            self._times.extend(timestamps)
            self._durations.extend(durations)
            self._recorded += n

    @property
    def dropped(self) -> int:
        """Events evicted by the ring buffer since construction."""
        with self._lock:
            return self._recorded - len(self._cases)

    @contextlib.contextmanager
    def span(self, case: str, activity: str):
        t0 = _time.perf_counter()
        try:
            yield
        finally:
            self.record(case, activity, timestamp=t0,
                        duration=_time.perf_counter() - t0)

    def __len__(self) -> int:
        return len(self._cases)

    def to_repository(self) -> EventRepository:
        with self._lock:
            return EventRepository.from_event_table(
                list(self._cases),
                list(self._activities),
                list(self._times),
            )

    def durations_by_activity(self) -> Dict[str, np.ndarray]:
        out: Dict[str, List[float]] = {}
        with self._lock:
            for a, d in zip(self._activities, self._durations):
                out.setdefault(a, []).append(d)
        return {k: np.asarray(v) for k, v in out.items()}

    def straggler_report(self, threshold: float = 3.0) -> Dict[str, Dict]:
        """Flag activities whose max duration exceeds ``threshold`` × median —
        the straggler-mitigation signal consumed by the trainer."""
        rep = {}
        for act, ds in self.durations_by_activity().items():
            if ds.size < 3:
                continue
            med = float(np.median(ds))
            mx = float(ds.max())
            if med > 0 and mx > threshold * med:
                rep[act] = {
                    "median_s": med,
                    "max_s": mx,
                    "ratio": mx / med,
                    "count": int(ds.size),
                }
        return rep


class StepTimer:
    """Duration tracker keyed by phase, independent of the collector."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = _time.perf_counter()
        try:
            yield
        finally:
            dt = _time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Tuple[float, int]]:
        return {k: (self.totals[k], self.counts[k]) for k in self.totals}
