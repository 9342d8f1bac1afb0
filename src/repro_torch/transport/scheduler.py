"""SLO-aware two-lane scheduling — cold scans never block warm traffic.

The engine's latency distribution is sharply bimodal: a cache, delta, or
graph serve answers in microseconds-to-milliseconds, while a cold
streaming scan of a large memmap log takes hundreds of milliseconds.  A
single work queue head-of-line-blocks the former behind the latter the
moment a few cold scans arrive together.  The scheduler therefore runs two
thread pools — requests classified *hot* by the planner probe
(:meth:`repro_torch.query.QueryEngine.probe`) go to a wide hot pool, predicted
cold scans to a narrow cold pool — and bounds each lane's depth, shedding
with a computed Retry-After instead of queueing unboundedly.

Lock discipline: ``_depth`` is guarded by ``make_lock("TransportScheduler")``
because the ``transport_queue_depth`` gauges read it from the metrics
thread.  That read creates a MetricsRegistry → TransportScheduler ordering
edge, so code here must never touch a counter or histogram while holding
the scheduler lock (the reverse edge would deadlock under
``REPRO_LOCKDEP=1``).
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from time import perf_counter
from typing import Callable, Optional, Tuple

from repro_torch.analysis.lockdep import make_lock
from repro_torch.obs import MetricsRegistry

__all__ = ["TwoLaneScheduler"]

LANES = ("hot", "cold")


class TwoLaneScheduler:
    def __init__(
        self,
        metrics: MetricsRegistry,
        hot_workers: int = 4,
        cold_workers: int = 2,
        max_depth_hot: int = 256,
        max_depth_cold: int = 32,
    ):
        self._pools = {
            "hot": ThreadPoolExecutor(
                max_workers=hot_workers, thread_name_prefix="transport-hot"
            ),
            "cold": ThreadPoolExecutor(
                max_workers=cold_workers, thread_name_prefix="transport-cold"
            ),
        }
        self._workers = {"hot": hot_workers, "cold": cold_workers}
        self._max_depth = {"hot": max_depth_hot, "cold": max_depth_cold}
        self._depth = {"hot": 0, "cold": 0}  # guarded by _lock
        self._lock = make_lock("TransportScheduler")
        self._h_wait = {
            lane: metrics.histogram(
                "transport_queue_wait_seconds",
                "Lane queue wait: submission to worker pickup",
                lane=lane,
            )
            for lane in LANES
        }
        for lane in LANES:
            metrics.gauge(
                "transport_queue_depth",
                lambda lane=lane: float(self.depth(lane)),
                "Queued plus running work per lane",
                lane=lane,
            )

    def depth(self, lane: str) -> int:
        with self._lock:
            return self._depth[lane]

    def try_submit(
        self, lane: str, est_cost_s: float, fn: Callable, *args, trace=None
    ) -> Tuple[Optional[asyncio.Future], Optional[float]]:
        """Run ``fn(*args)`` on ``lane``'s pool, bounded by the lane depth.

        Returns ``(future, None)`` when admitted — the asyncio future
        resolves with ``fn``'s result — or ``(None, retry_after_s)`` when
        the lane is full and the request must be shed.  Depth counts
        queued *plus* running work, so the Retry-After estimate
        ``depth × est_cost / workers`` approximates the lane's drain time.

        ``trace`` (a :class:`~repro_torch.obs.QueryTrace`) receives a
        ``queue_wait:<lane>`` span — submit-to-pickup — and an ``execute``
        span, both recorded *on the worker thread* so the submitting
        coroutine (which is suspended awaiting the future until after the
        worker finishes) never races the span slab.  The wait also feeds
        the ``transport_queue_wait_seconds`` histogram with the trace id
        as exemplar.
        """
        with self._lock:
            depth = self._depth[lane]
            if depth >= self._max_depth[lane]:
                admitted = False
            else:
                admitted = True
                self._depth[lane] = depth + 1
        if not admitted:
            per_req = max(est_cost_s, 1e-3)
            return None, depth * per_req / max(self._workers[lane], 1)

        t_submit = perf_counter()
        h_wait = self._h_wait[lane]

        def _run():
            t_start = perf_counter()
            if trace is not None:
                trace.add_span(f"queue_wait:{lane}", t_submit,
                               t_start - t_submit)
            h_wait.observe(
                t_start - t_submit,
                trace_id=None if trace is None else trace.trace_id,
            )
            try:
                return fn(*args)
            finally:
                if trace is not None:
                    trace.add_span("execute", t_start,
                                   perf_counter() - t_start)

        loop = asyncio.get_running_loop()
        fut = loop.run_in_executor(self._pools[lane], _run)
        fut.add_done_callback(lambda _f: self._done(lane))
        return fut, None

    def _done(self, lane: str) -> None:
        with self._lock:
            self._depth[lane] -= 1

    def close(self) -> None:
        for pool in self._pools.values():
            pool.shutdown(wait=True)
