"""The transport application: probe → admit → classify → coalesce → execute.

:class:`TransportApp` is the protocol-independent core of the serving
tier.  :class:`~repro_torch.transport.server.TransportServer` parses HTTP and
hands request dicts here; tests drive this class directly so every
admission/coalescing/laning behaviour is assertable without sockets.

One request's life:

1. **Probe** — :meth:`QueryService.probe` resolves policy and canonical
   plan *without executing*; invalid requests map to 4xx before they cost
   a queue slot.
2. **Admit** — the tenant's token bucket; over-quota requests shed with
   429 + Retry-After.
3. **Classify** — hot iff the probe predicts a cache/delta serve or the
   planner's cost estimate is under the measured ``slo_hot_cutoff_s``
   boundary; otherwise cold.
4. **Coalesce** — an identical in-flight request (same policy, plan, and
   fingerprint-at-enqueue) means we await its future instead of executing.
5. **Execute** — the leader runs :meth:`QueryService.query` on its lane's
   thread pool (the engine is synchronous: host numpy and CUDA launches
   on the card, which now start off the main thread) and fans the result
   out.

Everything reports through the engine's own :class:`MetricsRegistry` —
queue-depth gauges, shed/coalesce counters, per-lane latency histograms —
so ``{"sink": "metrics"}`` already covers the transport tier.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, Optional, Tuple

from repro_torch.core.views import AccessDenied
from repro_torch.obs import QueryTrace, TraceStore
from repro_torch.obs.context import mint_context, parse_traceparent
from repro_torch.query import QueryPlanError
from repro_torch.query.planner import load_calibration
from repro_torch.serve import QueryService

from .admission import AdmissionController
from .coalesce import Coalescer
from .scheduler import TwoLaneScheduler

__all__ = [
    "TransportApp",
    "TransportConfig",
    "TransportResponse",
    "canonical_payload",
]

#: response fields that legitimately differ between a direct
#: ``QueryService.query`` call and a transport-served (possibly cached or
#: coalesced) execution of the same request
VOLATILE_FIELDS = ("wall_s", "from_cache", "backend", "trace", "trace_id")


def canonical_payload(payload: Dict) -> Dict:
    """The bit-identity view of a response: the payload minus execution
    provenance.  Transport guarantee: ``canonical_payload(transport) ==
    canonical_payload(service.query(request))`` for every request."""
    return {k: v for k, v in payload.items() if k not in VOLATILE_FIELDS}


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    rate: float = 200.0  # default per-tenant tokens/s
    burst: float = 400.0
    hot_workers: int = 4
    cold_workers: int = 2
    max_depth_hot: int = 256
    max_depth_cold: int = 32
    #: hot/cold boundary in seconds; None loads it with load_calibration
    #: (BENCH_torch_serve.json when measured, else SLO_HOT_CUTOFF_S)
    hot_cutoff_s: Optional[float] = None
    max_body_bytes: int = 8 * 1024 * 1024
    #: directory for the persisted trace ring (None = no trace store);
    #: the app shares the store with the engine so request traces and the
    #: engine executions under them land in the same ring
    trace_dir: Optional[str] = None
    trace_max_bytes: int = 16 * 1024 * 1024
    #: head-sample every Nth unremarkable trace; errors / sheds / over-SLO
    #: traces are always kept (tail-based sampling)
    trace_sample_every: int = 1
    #: latency above which a trace is always persisted; None loads the
    #: measured hot cutoff (a hot request slower than a cold scan is the
    #: one worth keeping)
    trace_slo_latency_s: Optional[float] = None


@dataclasses.dataclass
class TransportResponse:
    status: int
    payload: Dict
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return 200 <= self.status < 300


class TransportApp:
    def __init__(
        self,
        service: Optional[QueryService] = None,
        config: Optional[TransportConfig] = None,
    ):
        # the default service's engine runs on the card (and raises
        # without one); a CPU app passes its own service
        self.service = service if service is not None else QueryService()
        self.config = config or TransportConfig()
        self.hot_cutoff_s = (
            float(self.config.hot_cutoff_s)
            if self.config.hot_cutoff_s is not None
            else float(load_calibration()["slo_hot_cutoff_s"])
        )
        metrics = self.service.engine.metrics
        self.metrics = metrics
        self.admission = AdmissionController(
            rate=self.config.rate, burst=self.config.burst
        )
        self.coalescer = Coalescer(metrics)
        self.scheduler = TwoLaneScheduler(
            metrics,
            hot_workers=self.config.hot_workers,
            cold_workers=self.config.cold_workers,
            max_depth_hot=self.config.max_depth_hot,
            max_depth_cold=self.config.max_depth_cold,
        )
        self._c_requests = {
            lane: metrics.counter(
                "transport_requests_total",
                "Requests served to completion, by lane",
                lane=lane,
            )
            for lane in ("hot", "cold")
        }
        self._c_shed = {
            reason: metrics.counter(
                "transport_shed_total",
                "Requests shed with 429, by cause",
                reason=reason,
            )
            for reason in ("quota", "queue")
        }
        self._h_latency = {
            lane: metrics.histogram(
                "request_latency_seconds",
                "End-to-end transport latency, by lane",
                lane=lane,
            )
            for lane in ("hot", "cold")
        }
        #: request-trace query-id sequence (separate from the engine's)
        self._rid = itertools.count(1).__next__
        self.trace_store: Optional[TraceStore] = None
        if self.config.trace_dir is not None:
            slo_s = (
                self.config.trace_slo_latency_s
                if self.config.trace_slo_latency_s is not None
                else self.hot_cutoff_s
            )
            self.trace_store = TraceStore(
                self.config.trace_dir,
                max_bytes=self.config.trace_max_bytes,
                sample_every=self.config.trace_sample_every,
                slo_latency_s=slo_s,
                metrics=metrics,
            )
            # one shared ring: engine roots (direct Q/engine use) and
            # transport request traces mine together
            self.service.engine.trace_store = self.trace_store

    # -- classification -------------------------------------------------------
    def classify(self, probe) -> str:
        """hot = predicted cache/delta/graph serve or a scan the planner
        prices under the measured boundary; cold = everything else."""
        if probe.cached or probe.delta_hint:
            return "hot"
        return "hot" if probe.estimated_cost_s <= self.hot_cutoff_s else "cold"

    # -- error mapping --------------------------------------------------------
    @staticmethod
    def _error_status(exc: BaseException) -> Optional[int]:
        if isinstance(exc, KeyError):
            return 404
        if isinstance(exc, AccessDenied):
            return 403
        if isinstance(exc, (QueryPlanError, ValueError, TypeError)):
            return 400
        return None

    @classmethod
    def _error_response(cls, exc: BaseException) -> TransportResponse:
        status = cls._error_status(exc)
        if status is None:
            raise exc
        detail = exc.args[0] if exc.args else str(exc)
        return TransportResponse(
            status, {"error": type(exc).__name__, "detail": str(detail)}
        )

    @staticmethod
    def _shed(retry_after_s: float) -> TransportResponse:
        retry = max(retry_after_s, 0.001)
        return TransportResponse(
            429,
            {"error": "Shed", "retry_after_s": retry},
            headers={"Retry-After": f"{retry:.3f}"},
        )

    # -- request traces -------------------------------------------------------
    def _begin_request_trace(
        self, request: Dict, traceparent: Optional[str]
    ) -> QueryTrace:
        """Mint this request's trace node.  A well-formed inbound
        ``traceparent`` makes the request a child of the caller's trace; a
        malformed or absent one mints a fresh root — never an error."""
        rtr = QueryTrace(
            self._rid(), str(request.get("sink", "?")), "transport"
        )
        ctx = parse_traceparent(traceparent) if traceparent else None
        if ctx is not None:
            rtr.bind_child_of(ctx)
        else:
            rtr.bind_root(mint_context())
        return rtr

    def _trace_headers(self, rtr: QueryTrace, headers: Dict[str, str]) -> None:
        ctx = rtr.context
        if ctx is not None:
            headers["X-Trace-Id"] = rtr.trace_id
            headers["traceparent"] = ctx.to_traceparent()

    def _close_trace(self, rtr: QueryTrace, error: bool = False) -> None:
        rtr.finish()
        if self.trace_store is not None:
            self.trace_store.offer(rtr, error=error)

    def _fail(self, rtr: QueryTrace, exc: BaseException) -> TransportResponse:
        self._close_trace(rtr, error=True)
        resp = self._error_response(exc)
        self._trace_headers(rtr, resp.headers)
        return resp

    # -- the serving endpoint -------------------------------------------------
    async def handle(
        self,
        request: Dict,
        tenant: str = "default",
        traceparent: Optional[str] = None,
    ) -> TransportResponse:
        """Serve one query request dict for ``tenant``.

        ``traceparent`` (the W3C header value, when the caller sent one)
        roots this request's trace under the caller's; the response echoes
        the request's own context back via ``traceparent`` / ``X-Trace-Id``
        headers, and the payload's ``trace_id`` names the producing engine
        execution (the leader's, for coalesced followers)."""
        t0 = time.perf_counter()
        rtr = self._begin_request_trace(request, traceparent)
        i_span = rtr.begin("probe")
        try:
            probe = self.service.probe(request)
        except (KeyError, AccessDenied, QueryPlanError, ValueError,
                TypeError) as exc:
            rtr.end(i_span)
            return self._fail(rtr, exc)
        rtr.end(i_span)

        i_span = rtr.begin("admit")
        wait = self.admission.admit(tenant)
        rtr.end(i_span)
        if wait is not None:
            self._c_shed["quota"].inc()
            rtr.notes["shed"] = "quota"
            self._close_trace(rtr, error=True)
            resp = self._shed(wait)
            self._trace_headers(rtr, resp.headers)
            return resp

        lane = self.classify(probe)
        rtr.notes["lane"] = lane
        headers = {"X-Lane": lane, "X-Coalesced": "0"}

        group_fut = None
        if probe.coalescable:
            existing = self.coalescer.join(probe.group_key)
            if existing is not None:
                # read the leader's id *now*: the group may settle and
                # vanish across the await below
                leader_tid = self.coalescer.leader_of(probe.group_key)
                if leader_tid is not None:
                    rtr.links["coalesced_into"] = leader_tid
                headers["X-Coalesced"] = "1"
                i_span = rtr.begin("await_leader")
                kind, value = await existing
                rtr.end(i_span)
                if kind == "err":  # the leader's failure fans out too
                    return self._fail(rtr, value)
                return self._finish(value, lane, headers, t0, rtr)
            # no await between join-miss, open, and submit: the loop cannot
            # interleave another handler here, so the group is never raced
            group_fut = self.coalescer.open(probe.group_key, rtr.trace_id)

        # the engine executes as a child span of this request: queue_wait
        # and execute spans land in rtr from the worker thread, and the
        # engine's own QueryTrace binds child-of rtr.context
        exec_fut, retry = self.scheduler.try_submit(
            lane, probe.estimated_cost_s,
            self.service.query, request, rtr.context,
            trace=rtr,
        )
        if exec_fut is None:
            if group_fut is not None:
                # nothing can have joined: no await ran since open()
                self.coalescer.settle(
                    probe.group_key, ("err", RuntimeError("leader shed"))
                )
            self._c_shed["queue"].inc()
            rtr.notes["shed"] = "queue"
            self._close_trace(rtr, error=True)
            resp = self._shed(retry)
            self._trace_headers(rtr, resp.headers)
            return resp

        try:
            payload = await exec_fut
        except BaseException as exc:
            if group_fut is not None:
                self.coalescer.settle(probe.group_key, ("err", exc))
            return self._fail(rtr, exc)
        if group_fut is not None:
            self.coalescer.settle(probe.group_key, ("ok", payload))
        return self._finish(payload, lane, headers, t0, rtr)

    def _finish(
        self,
        payload: Dict,
        lane: str,
        headers: Dict[str, str],
        t0: float,
        rtr: Optional[QueryTrace] = None,
    ) -> TransportResponse:
        self._c_requests[lane].inc()
        self._h_latency[lane].observe(
            time.perf_counter() - t0,
            trace_id=None if rtr is None else rtr.trace_id,
        )
        if rtr is not None:
            self._trace_headers(rtr, headers)
            self._close_trace(rtr)
        return TransportResponse(200, payload, headers=headers)

    # -- the append endpoint --------------------------------------------------
    async def append(
        self, request: Dict, tenant: str = "default"
    ) -> TransportResponse:
        """Live-append a batch of events.  Runs on the cold lane (it writes
        column files); never coalesced.  The fingerprint move it causes
        splits any concurrent coalescing groups automatically — that is the
        point of keying groups on fingerprint-at-enqueue."""
        wait = self.admission.admit(tenant)
        if wait is not None:
            self._c_shed["quota"].inc()
            return self._shed(wait)
        exec_fut, retry = self.scheduler.try_submit(
            "cold", 0.05, self.service.append, request
        )
        if exec_fut is None:
            self._c_shed["queue"].inc()
            return self._shed(retry)
        t0 = time.perf_counter()
        try:
            payload = await exec_fut
        except BaseException as exc:
            return self._error_response(exc)
        self._c_requests["cold"].inc()
        self._h_latency["cold"].observe(time.perf_counter() - t0)
        return TransportResponse(200, payload, headers={"X-Lane": "cold"})

    # -- readiness ------------------------------------------------------------
    def readiness(self) -> Tuple[bool, Dict]:
        """Probe the serving path's load-bearing pieces; ``(ready,
        report)``.  Degraded pieces land in ``report["reasons"]`` so the
        503 body says *why* — a saturated lane, an unreachable registry, a
        broken log registration."""
        checks: Dict[str, object] = {}
        reasons = []
        try:
            self.service.engine.metrics.to_dict()
            checks["engine_metrics"] = "ok"
        except Exception as exc:  # registry gauge callbacks may raise
            checks["engine_metrics"] = f"{type(exc).__name__}: {exc}"
            reasons.append("engine_metrics")
        try:
            names = self.service.logs()
            checks["logs"] = {"registered": len(names)}
        except Exception as exc:
            checks["logs"] = f"{type(exc).__name__}: {exc}"
            reasons.append("logs")
        try:
            graphs = self.service.engine.graphs
            checks["graph_store"] = {"resident": len(graphs)}
        except Exception as exc:
            checks["graph_store"] = f"{type(exc).__name__}: {exc}"
            reasons.append("graph_store")
        for lane in ("hot", "cold"):
            depth = self.scheduler.depth(lane)
            cap = self.config.max_depth_hot if lane == "hot" \
                else self.config.max_depth_cold
            saturated = depth >= cap
            checks[f"lane_{lane}"] = {"depth": depth, "max_depth": cap}
            if saturated:
                reasons.append(f"lane_{lane}_saturated")
        report = {"ready": not reasons, "checks": checks}
        if reasons:
            report["reasons"] = reasons
        return not reasons, report

    def close(self) -> None:
        self.scheduler.close()
        if self.trace_store is not None:
            self.trace_store.close()
