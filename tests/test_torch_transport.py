"""``repro_torch.transport`` against ``repro.transport`` on the CPU.

Every case of the reference's ``tests/test_transport.py`` and the five
transport cases of ``tests/test_distributed_obs.py`` run here on the port,
over ``QueryService(QueryEngine(device="cpu"))``: token-bucket math and 429
+ Retry-After shedding, exactly one engine execution per coalesced group,
the stale-fanout regression (an append splits coalescing groups), lane
classification and warm-lane isolation, bit-identity with the direct
``QueryService.query`` dict, error mapping, transport metrics in the
engine's registry, NDJSON round trips, the HTTP endpoints, trace
propagation, the SLO endpoint and readiness.

Cross-package cases hold the wire to the reference's: the same request list
through both packages' ``TransportApp`` (the reference on the port's static
thresholds, ``torch_parity.ref_engine``) gives the same statuses, lane and
coalesce headers and ``canonical_payload``; ``iter_ndjson`` gives the same
bytes and each package reassembles the other's; raw HTTP requests get the
same answers from both servers; and a trace ring the reference's transport
writes mines the same Ψ when the port's ``TraceStore`` reads it back.

Isolation: every app and server is closed in a ``finally``, servers bind
``127.0.0.1`` on port 0, each event loop runs under ``asyncio.run`` and
every client thread is joined with a timeout.  An autouse fixture fails a
test that leaves a thread, a socket or an ``os.environ`` change behind; the
one ``REPRO_LOCKDEP=1`` case runs in a child process with its own
environment.
"""

import asyncio
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref_core
import repro.obs as ref_obs
import repro.serve as ref_serve
import repro.transport as ref_transport
import repro_torch.core as port_core
import repro_torch.obs as port_obs
import repro_torch.transport as port_transport
from repro_torch.core.views import AccessPolicy, ActivityView
from repro_torch.data import ProcessSpec, generate_memmap_log, generate_repository
from repro_torch.graph import partition_memmap_log
from repro_torch.obs import mint_context, parse_traceparent
from repro_torch.query import QueryEngine
from repro_torch.query.planner import SLO_HOT_CUTOFF_S, load_calibration
from repro_torch.serve import QueryService, RequestProbe
from repro_torch.transport import (
    AdmissionController,
    TokenBucket,
    TransportApp,
    TransportConfig,
    TransportServer,
    canonical_payload,
    iter_ndjson,
    reassemble_ndjson,
)
from torch_parity import ref_engine, ref_repository

EVENTS = 6_000
ROOT = Path(__file__).resolve().parent.parent
#: seconds any client thread may take before a test fails on it
JOIN_TIMEOUT_S = 60


def run(coro):
    return asyncio.run(coro)


def _sockets():
    fd_dir = "/proc/self/fd"
    if not os.path.isdir(fd_dir):
        return set()
    out = set()
    for fd in os.listdir(fd_dir):
        try:
            if os.readlink(os.path.join(fd_dir, fd)).startswith("socket:"):
                out.add(fd)
        except OSError:
            pass
    return out


def _environ():
    return {k: v for k, v in os.environ.items()
            if k != "PYTEST_CURRENT_TEST"}  # pytest's own bookkeeping


@pytest.fixture(autouse=True)
def _leaves_nothing_behind():
    env = _environ()
    threads = set(threading.enumerate())
    sockets = _sockets()
    yield
    deadline = time.monotonic() + 5.0
    while True:
        left = [t for t in threading.enumerate()
                if t not in threads and t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    assert not left, f"threads left running: {[t.name for t in left]}"
    assert _sockets() <= sockets, "a socket was left open"
    assert _environ() == env, "os.environ was changed"


class GatedService(QueryService):
    """QueryService whose ``query`` can be held at a barrier — before or
    after the engine executes — so tests can freeze requests mid-flight
    deterministically."""

    def __init__(self, engine=None):
        super().__init__(engine if engine is not None else cpu_engine())
        self.gate = threading.Event()
        self.gate.set()
        self.calls = []
        self._calls_lock = threading.Lock()
        self.gate_pred = lambda request: False
        self.gate_after_execute = False
        self.gate_first_call_only = False

    def query(self, request, trace_context=None):
        with self._calls_lock:
            self.calls.append(dict(request))
            nth = len(self.calls)
        gated = self.gate_pred(request) and not (
            self.gate_first_call_only and nth > 1
        )
        if gated and not self.gate_after_execute:
            assert self.gate.wait(timeout=30), "gate timeout"
        out = super().query(request, trace_context)
        if gated and self.gate_after_execute:
            assert self.gate.wait(timeout=30), "gate timeout"
        return out


def cpu_engine(**kw):
    return QueryEngine(device="cpu", **kw)


def cpu_service(*logs, engine=None):
    svc = QueryService(engine if engine is not None else cpu_engine())
    for name, log, *policy in logs:
        svc.register(name, log, *policy)
    return svc


@pytest.fixture()
def repo():
    return generate_repository(300, ProcessSpec(seed=11), seed=11)


@pytest.fixture()
def memmap_log(tmp_path):
    return generate_memmap_log(
        str(tmp_path / "log"), EVENTS,
        ProcessSpec(num_activities=10, seed=5, horizon_days=30), seed=5,
    )


@pytest.fixture()
def sharded(memmap_log, tmp_path):
    return partition_memmap_log(memmap_log, 3, str(tmp_path / "k3"))


def make_app(service, tmp_path=None, **cfg):
    cfg.setdefault("hot_cutoff_s", SLO_HOT_CUTOFF_S)
    if tmp_path is not None:
        cfg.setdefault("trace_dir", str(tmp_path / "traces"))
    return TransportApp(service, TransportConfig(**cfg))


def served(app, coro_fn):
    """Run ``coro_fn(app)`` on a fresh event loop and close ``app`` after,
    whatever happens."""
    try:
        return run(coro_fn(app))
    finally:
        app.close()


def _http(method, url, body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method, headers=headers or {}
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as f:
            return f.status, dict(f.headers), f.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, dict(e.headers), e.read()


def over_http(app, exercise, server_cls=TransportServer):
    """Start a server for ``app`` on 127.0.0.1:0, run ``exercise(srv)`` on a
    client thread and stop the server (which closes ``app``) in a
    ``finally``; returns what ``exercise`` returned."""

    async def go():
        srv = server_cls(app)
        await srv.start()
        try:
            loop = asyncio.get_running_loop()
            return await asyncio.wait_for(
                loop.run_in_executor(None, exercise, srv), JOIN_TIMEOUT_S
            )
        finally:
            await srv.stop()

    try:
        return run(go())
    finally:
        app.close()


# -- admission control --------------------------------------------------------

def test_token_bucket_math():
    b = TokenBucket(rate=10.0, burst=5.0, now=0.0)
    assert b.take(0.0, 5.0) == 0.0  # full burst admitted
    assert b.take(0.0, 1.0) == pytest.approx(0.1)  # empty: 1 token at 10/s
    # refill is continuous: at t=0.05 the bucket holds 0.5 tokens
    assert b.take(0.05, 1.0) == pytest.approx(0.05)
    assert b.take(1.0, 1.0) == 0.0  # refilled well past 1 token
    assert b.tokens < b.burst  # and capped at burst, never beyond
    assert TokenBucket(rate=0.0, burst=0.0, now=0.0).take(1.0) == float("inf")


def test_token_bucket_matches_the_reference():
    steps = [(0.0, 5.0), (0.0, 1.0), (0.05, 1.0), (0.3, 2.0), (1.0, 1.0),
             (1.0, 7.0), (9.0, 0.5)]
    port = TokenBucket(rate=10.0, burst=5.0, now=0.0)
    ref = ref_transport.TokenBucket(rate=10.0, burst=5.0, now=0.0)
    for now, n in steps:
        assert port.take(now, n) == ref.take(now, n)
        assert (port.tokens, port.stamp) == (ref.tokens, ref.stamp)


def test_admission_controller_per_tenant():
    ac = AdmissionController(rate=1.0, burst=2.0)
    assert ac.admit("a") is None
    assert ac.admit("a") is None
    wait = ac.admit("a")  # burst spent
    assert wait is not None and 0 < wait <= 1.0
    assert ac.admit("b") is None  # tenants are isolated
    ac.set_quota("paid", rate=1000.0, burst=1000.0)
    assert all(ac.admit("paid") is None for _ in range(100))
    assert ac.tenants() == 3


def test_quota_shed_maps_to_429_with_retry_after(repo):
    app = make_app(cpu_service(("bpi", repo)), rate=1.0, burst=2.0)

    async def go(app):
        req = {"log": "bpi", "sink": "dfg"}
        return [await app.handle(req, tenant="t") for _ in range(3)]

    r1, r2, r3 = served(app, go)
    assert r1.status == 200 and r2.status == 200
    assert r3.status == 429
    assert float(r3.headers["Retry-After"]) > 0
    assert r3.payload["retry_after_s"] > 0


# -- SLO classification -------------------------------------------------------

def _probe(cached=False, delta=False, cost=1.0):
    return RequestProbe(
        sink="dfg", names=("x",), fingerprint="f", policy_token="p",
        plan_token="k", backend="stream", cached=cached, delta_hint=delta,
        estimated_cost_s=cost, coalescable=True,
    )


def test_lane_classification(repo):
    app = make_app(cpu_service(("bpi", repo)), hot_cutoff_s=0.01)
    try:
        assert app.classify(_probe(cached=True, cost=9.0)) == "hot"
        assert app.classify(_probe(delta=True, cost=9.0)) == "hot"
        assert app.classify(_probe(cost=0.005)) == "hot"
        assert app.classify(_probe(cost=0.01)) == "hot"  # the boundary
        assert app.classify(_probe(cost=0.5)) == "cold"
    finally:
        app.close()


@pytest.mark.parametrize("cutoff", [0.123, None])
def test_explicit_cutoff_wins_over_calibration(repo, cutoff):
    """An explicit cutoff wins; without one the app takes the port's
    calibration, which never reads the reference's ``BENCH_serve.json``
    (none of the port's records is committed, so it is the static
    boundary)."""
    app = TransportApp(cpu_service(("bpi", repo)),
                       TransportConfig(hot_cutoff_s=cutoff))
    try:
        want = 0.123 if cutoff is not None else SLO_HOT_CUTOFF_S
        assert app.hot_cutoff_s == want
        if cutoff is None:
            assert want == load_calibration()["slo_hot_cutoff_s"]
    finally:
        app.close()


def test_slo_cutoff_calibration(tmp_path):
    p = tmp_path / "BENCH_torch_serve.json"
    p.write_text(json.dumps({"calibration": {"slo_hot_cutoff_s": 0.02}}))
    assert load_calibration(serve_path=str(p))["slo_hot_cutoff_s"] == 0.02
    # out-of-range measurements are clamped to the rails, not trusted
    p.write_text(json.dumps({"calibration": {"slo_hot_cutoff_s": 99.0}}))
    assert load_calibration(serve_path=str(p))["slo_hot_cutoff_s"] == 2.0
    # no artifact -> static fallback
    missing = str(tmp_path / "nope" / "BENCH_torch_serve.json")
    assert (
        load_calibration(serve_path=missing)["slo_hot_cutoff_s"]
        == SLO_HOT_CUTOFF_S
    )


# -- coalescing ---------------------------------------------------------------

def test_coalesced_group_executes_exactly_once(memmap_log):
    engine = cpu_engine(memory_budget_events=1_000)  # force real scans
    svc = GatedService(engine)
    svc.register("live", memmap_log)
    svc.gate_pred = lambda r: r.get("sink") == "dfg"
    svc.gate.clear()
    app = make_app(svc)
    req = {"log": "live", "sink": "dfg"}
    before = engine.stats

    async def go(app):
        tasks = [asyncio.create_task(app.handle(req)) for _ in range(16)]
        try:
            # let the leader reach the gate and every follower join its group
            while len(svc.calls) < 1 or len(app.coalescer) < 1:
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.05)
        finally:
            svc.gate.set()
        return await asyncio.gather(*tasks)

    resps = served(app, go)
    after = engine.stats
    assert all(r.status == 200 for r in resps)
    # exactly one engine execution, one full scan, for 16 identical requests
    assert len(svc.calls) == 1
    assert after.executions - before.executions == 1
    assert after.rows_scanned - before.rows_scanned == memmap_log.num_events
    coalesced = [r for r in resps if r.headers["X-Coalesced"] == "1"]
    assert len(coalesced) == 15
    payloads = [canonical_payload(r.payload) for r in resps]
    assert all(p == payloads[0] for p in payloads)


def test_distinct_plans_do_not_coalesce(repo):
    svc = GatedService()
    svc.register("bpi", repo)
    app = make_app(svc)

    async def go(app):
        r1 = await app.handle({"log": "bpi", "sink": "dfg"})
        r2 = await app.handle({"log": "bpi", "sink": "histogram"})
        return r1, r2

    r1, r2 = served(app, go)
    assert r1.status == r2.status == 200
    assert len(svc.calls) == 2


def test_append_splits_coalescing_groups(memmap_log):
    """The stale-fanout regression: a leader whose result was computed
    from fingerprint F must not fan out to a waiter that enqueued after an
    append moved the log to F'."""
    svc = GatedService()
    svc.register("live", memmap_log)
    svc.gate_pred = lambda r: r.get("sink") == "histogram"
    svc.gate_after_execute = True  # freeze AFTER executing, BEFORE fanout
    svc.gate_first_call_only = True
    svc.gate.clear()
    app = make_app(svc)
    req = {"log": "live", "sink": "histogram"}
    old_events = memmap_log.num_events
    t_last = 10.0 * 365 * 24 * 3600.0  # far past the generated horizon

    fp_before = svc.probe(req).fingerprint

    async def go(app):
        t1 = asyncio.create_task(app.handle(req))
        try:
            while len(svc.calls) < 1:  # leader has computed, holding at gate
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.05)
            # live append while the leader's group is still open
            svc.append({
                "log": "live",
                "activity": [0, 1, 2],
                "case": [0, 0, 0],
                "time": [t_last, t_last + 1, t_last + 2],
            })
            # post-append request: new fingerprint, must NOT join the group
            r2 = await app.handle(req)
        finally:
            svc.gate.set()
        r1 = await t1
        return r1, r2

    r1, r2 = served(app, go)
    fp_after = svc.probe(req).fingerprint
    assert fp_before != fp_after  # append moved the fingerprint
    assert r1.status == r2.status == 200
    assert len(svc.calls) == 2  # two groups, two executions
    assert r2.headers["X-Coalesced"] == "0"
    # the leader's payload is the pre-append data; the post-append waiter
    # sees the appended rows
    assert sum(r1.payload["counts"]) == old_events
    assert sum(r2.payload["counts"]) == old_events + 3


# -- two-lane scheduling ------------------------------------------------------

def test_queue_bound_sheds_with_retry_after(repo):
    svc = GatedService()
    svc.register("bpi", repo)
    svc.gate_pred = lambda r: True
    svc.gate.clear()
    app = make_app(
        svc, hot_cutoff_s=1e-9, cold_workers=1, max_depth_cold=1
    )

    async def go(app):
        t1 = asyncio.create_task(app.handle({"log": "bpi", "sink": "dfg"}))
        try:
            while app.scheduler.depth("cold") < 1:
                await asyncio.sleep(0.01)
            # lane full: a distinct cold request is shed, not queued
            r2 = await app.handle({"log": "bpi", "sink": "histogram"})
        finally:
            svc.gate.set()
        r1 = await t1
        return r1, r2

    r1, r2 = served(app, go)
    assert r1.status == 200
    assert r2.status == 429
    assert float(r2.headers["Retry-After"]) > 0
    snap = svc.engine.metrics_snapshot()
    assert snap['transport_shed_total{reason=queue}'] >= 1


def test_warm_lane_isolated_from_saturated_cold_lane(repo):
    svc = GatedService()
    svc.register("bpi", repo)
    app = make_app(
        svc, hot_cutoff_s=1e-9, cold_workers=1, max_depth_cold=4
    )
    warm_req = {"log": "bpi", "sink": "dfg"}

    async def go(app):
        warm0 = await app.handle(warm_req)  # populate the cache
        assert warm0.headers["X-Lane"] == "cold"  # uncached -> cold
        svc.gate_pred = lambda r: r.get("sink") == "histogram"
        svc.gate.clear()
        cold = asyncio.create_task(
            app.handle({"log": "bpi", "sink": "histogram"})
        )
        try:
            while app.scheduler.depth("cold") < 1:
                await asyncio.sleep(0.01)
            t0 = time.perf_counter()
            warm = await app.handle(warm_req)  # cached -> hot lane
            warm_latency = time.perf_counter() - t0
            assert not cold.done()  # cold lane still saturated
        finally:
            svc.gate.set()
        await cold
        return warm, warm_latency

    warm, warm_latency = served(app, go)
    assert warm.status == 200
    assert warm.headers["X-Lane"] == "hot"
    assert warm.payload["from_cache"] is True
    assert warm_latency < 1.0  # never queued behind the blocked cold scan


# -- bit-identity with the direct path ----------------------------------------

def _requests(svc):
    center = svc.query({"log": "bpi", "sink": "dfg"})["names"][0]
    return [
        {"log": "bpi", "sink": "dfg"},
        {"log": "bpi", "sink": "histogram"},
        {"log": "bpi", "sink": "variants", "k": 5},
        {"log": "bpi", "sink": "process_map", "top": 1.0},
        {"log": "bpi", "sink": "neighborhood", "activity": center, "k": 2},
        {"log": "bpi", "sink": "fitness"},
        {"log": "bpi", "sink": "alignments"},
        {"logs": ["bpi", "other"], "sink": "compare"},
    ]


def test_transport_responses_bit_identical_to_direct_path(repo):
    other = generate_repository(200, ProcessSpec(seed=12), seed=12)
    svc = cpu_service(("bpi", repo), ("other", other))
    app = make_app(svc)
    requests = _requests(svc)

    async def go(app):
        return [await app.handle(r) for r in requests]

    resps = served(app, go)
    for req, resp in zip(requests, resps):
        assert resp.status == 200, req
        assert canonical_payload(resp.payload) == canonical_payload(
            svc.query(req)
        ), req


def test_concurrent_requests_equal_serial_ones(repo, memmap_log):
    """Many distinct requests at once on one engine (four hot and two cold
    workers executing together) answer what the same requests answer one
    at a time on a fresh engine."""
    other = generate_repository(200, ProcessSpec(seed=12), seed=12)
    svc = cpu_service(("bpi", repo), ("other", other), ("disk", memmap_log))
    serial = cpu_service(("bpi", repo), ("other", other),
                         ("disk", memmap_log))
    requests = _requests(serial) + [
        {"log": "disk", "sink": "dfg", "window": [0.0, d * 86400.0]}
        for d in range(1, 9)
    ] + [{"log": "disk", "sink": "histogram"},
         {"log": "disk", "sink": "dfg", "backend": "streaming"}]
    want = [canonical_payload(serial.query(dict(r))) for r in requests]
    # numpy plans (priced 2.6e-4 s) ride the hot lane, scatter and
    # streaming scans (1e-3 s and up) the cold one
    app = make_app(svc, hot_cutoff_s=1e-3)

    async def go(app):
        return await asyncio.gather(*(app.handle(dict(r)) for r in requests))

    resps = served(app, go)
    lanes = {r.headers["X-Lane"] for r in resps}
    assert lanes == {"hot", "cold"}
    assert [r.status for r in resps] == [200] * len(requests)
    assert [canonical_payload(r.payload) for r in resps] == want


# -- error mapping ------------------------------------------------------------

def test_error_mapping(repo):
    view = ActivityView(mapping={})
    svc = cpu_service(("bpi", repo),
                      ("sealed", repo, AccessPolicy(view=view)))
    app = make_app(svc)

    async def go(app):
        return (
            await app.handle({"log": "nope", "sink": "dfg"}),
            await app.handle({"log": "sealed", "sink": "variants"}),
            await app.handle({"log": "bpi", "sink": "wat"}),
            await app.handle({"sink": "dfg"}),
        )

    unknown, denied, bad_sink, no_log = served(app, go)
    assert unknown.status == 404
    assert denied.status == 403
    assert bad_sink.status == 400
    assert no_log.status == 404
    assert "error" in unknown.payload and "detail" in unknown.payload


# -- transport health in the engine registry ----------------------------------

def test_transport_metrics_in_engine_registry(repo):
    app = make_app(cpu_service(("bpi", repo)), rate=1.0, burst=1.0)

    async def go(app):
        await app.handle({"log": "bpi", "sink": "dfg"}, tenant="t")
        await app.handle({"log": "bpi", "sink": "dfg"}, tenant="t")  # shed
        return await app.handle({"sink": "metrics"})

    resp = served(app, go)
    assert resp.status == 200
    snap = resp.payload["metrics"]
    assert snap['transport_requests_total{lane=hot}'] >= 1
    assert snap['transport_shed_total{reason=quota}'] >= 1
    assert snap['transport_coalesce_groups_total'] >= 1
    assert 'transport_queue_depth{lane=cold}' in snap
    assert snap['request_latency_seconds{lane=hot}']["count"] >= 1


# -- NDJSON streaming ---------------------------------------------------------

NDJSON_PAYLOADS = [
    {
        "sink": "alignments", "fitness": 0.93, "log": "bpi",
        "deviations": [{"edge": ["a", "b"], "count": 3}] * 4,
        "names": ["a", "b"], "nested": {"k": [1, 2]},  # inner lists stay put
    },
    {"sink": "dfg", "psi": [[0, 1], [2, 0]], "names": ["é", "b\n"],
     "empty": [], "wall_s": 1e-7, "none": None, "flag": True},
    {"only": "scalars", "n": -3, "x": float("1.5e300")},
]


def test_ndjson_round_trip_exact():
    payload = NDJSON_PAYLOADS[0]
    lines = list(iter_ndjson(payload))
    assert json.loads(lines[-1]) == {"end": True}
    assert reassemble_ndjson(lines) == payload
    with pytest.raises(ValueError):
        reassemble_ndjson(lines[:-1])  # truncated stream is detected
    with pytest.raises(ValueError):
        reassemble_ndjson([])


@pytest.mark.parametrize("payload", NDJSON_PAYLOADS,
                         ids=["alignments", "dfg", "scalars"])
def test_ndjson_lines_match_the_reference(payload):
    """Byte-identical lines, and each package reassembles the other's."""
    port_lines = list(iter_ndjson(payload))
    ref_lines = list(ref_transport.iter_ndjson(payload))
    assert port_lines == ref_lines
    assert reassemble_ndjson(ref_lines) == payload
    assert ref_transport.reassemble_ndjson(port_lines) == payload
    for bad in (port_lines[:-1], ["{}\n"], []):
        with pytest.raises(ValueError) as pe:
            reassemble_ndjson(bad)
        with pytest.raises(ValueError) as re_:
            ref_transport.reassemble_ndjson(bad)
        assert str(pe.value) == str(re_.value)


# -- HTTP end to end ----------------------------------------------------------

def test_http_server_end_to_end(repo):
    svc = cpu_service(("bpi", repo))
    app = make_app(svc)
    app.admission.set_quota("starved", rate=0.001, burst=1.0)
    direct = svc.query({"log": "bpi", "sink": "dfg"})

    def exercise(srv):
        out = {}
        out["query"] = _http(
            "POST", srv.address + "/query", {"log": "bpi", "sink": "dfg"},
        )
        out["stream"] = _http(
            "POST", srv.address + "/query/stream",
            {"log": "bpi", "sink": "dfg"},
        )
        out["metrics"] = _http("GET", srv.address + "/metrics")
        out["live"] = _http(
            "GET", srv.address + "/stream/metrics?interval=0.01&count=2",
        )
        out["healthz"] = _http("GET", srv.address + "/healthz")
        out["missing"] = _http("GET", srv.address + "/nope")
        out["bad_json"] = _http(
            "POST", srv.address + "/query", {"log": "nope"},
        )
        _http("POST", srv.address + "/query", {"log": "bpi", "sink": "dfg"},
              headers={"X-Tenant": "starved"})
        out["shed"] = _http(
            "POST", srv.address + "/query", {"log": "bpi", "sink": "dfg"},
            headers={"X-Tenant": "starved"},
        )
        return out

    out = over_http(app, exercise)
    status, headers, body = out["query"]
    assert status == 200
    assert headers["X-Lane"] in ("hot", "cold")
    assert canonical_payload(json.loads(body)) == canonical_payload(direct)

    status, headers, body = out["stream"]
    assert status == 200
    assert headers["Content-Type"] == "application/x-ndjson"
    reassembled = reassemble_ndjson(body.decode().splitlines())
    assert canonical_payload(reassembled) == canonical_payload(direct)

    status, _, body = out["metrics"]
    assert status == 200
    assert b"transport_requests_total" in body
    assert b"transport_queue_depth" in body
    assert b"request_latency_seconds_bucket" in body

    status, _, body = out["live"]
    lines = body.decode().splitlines()
    assert status == 200
    assert json.loads(lines[0])["body"]["sink"] == "metrics"
    assert json.loads(lines[-1]) == {"end": True}

    assert out["healthz"][0] == 200
    assert out["missing"][0] == 404
    assert out["bad_json"][0] == 404  # unknown log through HTTP

    status, headers, body = out["shed"]
    assert status == 429
    assert float(headers["Retry-After"]) > 0


def test_http_append_round_trip(memmap_log):
    svc = cpu_service(("live", memmap_log))
    old = memmap_log.num_events
    t_last = 10.0 * 365 * 24 * 3600.0

    def exercise(srv):
        appended = _http(
            "POST", srv.address + "/append",
            {"log": "live", "activity": [0, 1], "case": [0, 0],
             "time": [t_last, t_last + 1]},
        )
        after = _http(
            "POST", srv.address + "/query",
            {"log": "live", "sink": "histogram"},
        )
        return appended, after

    appended, after = over_http(make_app(svc), exercise)
    status, _, body = appended
    assert status == 200
    assert json.loads(body)["num_events"] == old + 2
    status, _, body = after
    assert status == 200
    assert sum(json.loads(body)["counts"]) == old + 2


def test_default_server_binds_loopback_on_an_ephemeral_port(repo):
    app = make_app(cpu_service(("bpi", repo)))

    def exercise(srv):
        return srv.host, srv.port, _http("GET", srv.address + "/healthz")

    host, port, (status, _, body) = over_http(app, exercise)
    assert host == "127.0.0.1" and port > 0
    assert status == 200 and json.loads(body) == {"ok": True}


# -- trace propagation (tests/test_distributed_obs.py) -------------------------

def test_malformed_traceparent_never_fails_the_request(repo, tmp_path):
    app = make_app(cpu_service(("bpi", repo)), tmp_path)

    async def go(app):
        return await app.handle(
            {"log": "bpi", "sink": "dfg"}, traceparent="not-a-traceparent"
        )

    resp = served(app, go)
    assert resp.status == 200
    assert len(resp.headers["X-Trace-Id"]) == 32  # fresh root, not an error


def test_one_trace_id_across_transport_engine_and_shards(sharded, tmp_path):
    """The acceptance path: one HTTP request with an inbound traceparent
    over a sharded log — the response echoes the trace id, the engine
    trace and every shard sub-trace carry it, and the persisted store
    holds the stitched request tree."""
    app = make_app(cpu_service(("sharded", sharded)), tmp_path)
    inbound = mint_context()
    req = {
        "log": "sharded", "sink": "dfg",
        "backend": "sharded-graph", "trace": True,
    }

    def exercise(srv):
        return {
            path: _http("POST", srv.address + path, req,
                        headers={"traceparent": inbound.to_traceparent()})
            for path in ("/query", "/query/stream")
        }

    out = over_http(app, exercise)
    status, headers, body = out["/query"]
    assert status == 200
    tid = inbound.trace_id
    # the transport adopted the caller's trace and echoed it back
    assert headers["X-Trace-Id"] == tid
    echoed = parse_traceparent(headers["traceparent"])
    assert echoed.trace_id == tid and echoed.span_id != inbound.span_id
    payload = json.loads(body)
    assert payload["trace_id"] == tid
    # the engine trace and every per-shard sub-trace share the id
    tr = payload["trace"]
    assert tr["trace_id"] == tid
    branches = tr["branches"]
    assert len(branches) == 3
    for b in branches:
        assert b["trace"]["trace_id"] == tid
        assert b["trace"]["parent_span_id"] == tr["span_id"]

    # NDJSON streaming carries the same id on the meta line
    status, headers, body = out["/query/stream"]
    assert status == 200
    assert headers["X-Trace-Id"] == tid
    streamed = reassemble_ndjson(body.decode().splitlines())
    assert streamed["trace_id"] == tid

    # the persisted store holds the stitched tree: the transport record
    # parents the engine record, shard spans nested under it
    recs = app.trace_store.find(tid)
    t_recs = [r for r in recs if r["source"] == "transport"]
    eng_recs = [r for r in recs if r["source"] != "transport"]
    assert len(t_recs) == 2 and eng_recs  # /query and /query/stream
    t_spans = {r["span_id"] for r in t_recs}
    assert all(r["parent_span_id"] in t_spans for r in eng_recs)
    span_names = [s["name"] for s in t_recs[0]["spans"]]
    assert "probe" in span_names and "admit" in span_names
    assert any(n.startswith("queue_wait:") for n in span_names)
    assert "execute" in span_names


def test_coalesced_follower_links_leader(sharded, tmp_path):
    svc = GatedService(cpu_engine(memory_budget_events=1_000))
    svc.register("live", sharded)
    svc.gate_pred = lambda r: r.get("sink") == "dfg"
    svc.gate.clear()
    app = make_app(svc, tmp_path)
    req = {"log": "live", "sink": "dfg"}

    async def go(app):
        t1 = asyncio.create_task(app.handle(req))
        try:
            await asyncio.sleep(0.05)          # leader held at the gate
            t2 = asyncio.create_task(app.handle(req))
            await asyncio.sleep(0.05)
        finally:
            svc.gate.set()
        return await asyncio.gather(t1, t2)

    r1, r2 = served(app, go)
    leader = r1 if r1.headers["X-Coalesced"] == "0" else r2
    follower = r2 if leader is r1 else r1
    assert follower.headers["X-Coalesced"] == "1"
    ltid = leader.headers["X-Trace-Id"]
    ftid = follower.headers["X-Trace-Id"]
    assert ltid != ftid
    # the shared payload names the producing (leader) execution
    assert follower.payload["trace_id"] == ltid
    f_rec = next(
        r for r in app.trace_store.find(ftid) if r["source"] == "transport"
    )
    assert f_rec["links"]["coalesced_into"] == ltid
    assert "await_leader" in [s["name"] for s in f_rec["spans"]]


def test_slo_sink_and_http_endpoint(repo, tmp_path):
    """The SLO sink and ``GET /slo``: the default objectives, with the
    three requests the warm-latency objective counts.  The engine answers
    the DFG once before them, so they are warm (cache hits on the hot
    lane): a cold first query pays the process's first use of its path,
    which a loaded host can stretch past the objective's 25 ms."""
    svc = cpu_service(("bpi", repo))
    svc.query({"log": "bpi", "sink": "dfg"})
    app = make_app(svc, tmp_path)

    async def warm(app):
        for _ in range(3):
            await app.handle({"log": "bpi", "sink": "dfg"})
        return await app.handle({"sink": "slo"})

    sink = run(warm(app))
    status, _, body = over_http(
        app, lambda srv: _http("GET", srv.address + "/slo")
    )
    assert sink.status == 200
    names = {o["name"] for o in sink.payload["objectives"]}
    assert names == {"warm_latency", "availability"}
    warm_o = next(
        o for o in sink.payload["objectives"] if o["name"] == "warm_latency"
    )
    assert warm_o["total"] >= 3 and warm_o["ok"] is True
    assert warm_o["good"] == warm_o["total"]
    assert status == 200
    assert {o["name"] for o in json.loads(body)["objectives"]} == names


def test_readyz_ok_and_degraded(repo, tmp_path):
    def readyz(srv):
        return _http("GET", srv.address + "/readyz")

    status, _, body = over_http(
        make_app(cpu_service(("bpi", repo)), tmp_path), readyz
    )
    report = json.loads(body)
    assert status == 200 and report["ready"] is True
    assert report["checks"]["lane_hot"]["depth"] == 0

    # a zero-capacity hot lane is permanently saturated: degraded
    status, _, body = over_http(
        make_app(cpu_service(("bpi", repo)), None, max_depth_hot=0), readyz
    )
    report = json.loads(body)
    assert status == 503 and report["ready"] is False
    assert "lane_hot_saturated" in report["reasons"]


# -- the package --------------------------------------------------------------

def test_the_package_exports_the_references_names():
    assert sorted(port_transport.__all__) == sorted(ref_transport.__all__)
    assert port_transport.app.VOLATILE_FIELDS == \
        ref_transport.app.VOLATILE_FIELDS


# -- parity with the reference's transport ------------------------------------

def _ref_app(svc, **cfg):
    cfg.setdefault("hot_cutoff_s", SLO_HOT_CUTOFF_S)
    return ref_transport.TransportApp(svc, ref_transport.TransportConfig(**cfg))


def _both(sources, **cfg):
    """A port app over a CPU engine and a reference app over an engine on
    the port's static thresholds, each serving ``sources`` (name →
    {"port": log, "ref": log})."""
    port_svc = cpu_service()
    ref_svc = ref_serve.QueryService(ref_engine())
    for name, pair in sources.items():
        port_svc.register(name, pair["port"])
        ref_svc.register(name, pair["ref"])
    return make_app(port_svc, **cfg), _ref_app(ref_svc, **cfg)


def _wire(resp):
    return (resp.status, resp.headers.get("X-Lane"),
            resp.headers.get("X-Coalesced"),
            sorted(k for k in resp.headers if k not in
                   ("X-Trace-Id", "traceparent")),
            canonical_payload(resp.payload))


def _log_copies(log, tmp_path):
    """One on-disk copy of ``log`` per package: appends write the files."""
    out = {}
    for which, core in (("port", port_core), ("ref", ref_core)):
        path = str(tmp_path / f"copy_{which}")
        shutil.copytree(log.path, path)
        out[which] = core.MemmapLog.open(path)
    return out


def _close_both(apps):
    for a in apps:
        a.close()


@pytest.mark.parametrize("cutoff", [SLO_HOT_CUTOFF_S, 1e-9],
                         ids=["static-cutoff", "all-cold"])
def test_request_list_matches_the_reference(repo, memmap_log, cutoff,
                                            tmp_path):
    """The same request list, in order, through both packages' apps: equal
    statuses, lanes, coalesce headers and canonical payloads — cold
    misses, cache hits, errors, quota sheds and an append included."""
    other = generate_repository(200, ProcessSpec(seed=12), seed=12)
    sources = {
        "bpi": {"port": repo, "ref": ref_repository(repo)},
        "other": {"port": other, "ref": ref_repository(other)},
        "disk": _log_copies(memmap_log, tmp_path),
    }
    port_app, ref_app = _both(sources, hot_cutoff_s=cutoff, rate=1.0,
                              burst=1_000.0)
    apps = (port_app, ref_app)
    port_app.admission.set_quota("starved", rate=0.001, burst=2.0)
    ref_app.admission.set_quota("starved", rate=0.001, burst=2.0)
    center = port_app.service.query({"log": "bpi", "sink": "dfg"})["names"][0]
    ref_app.service.query({"log": "bpi", "sink": "dfg"})
    t_last = 10.0 * 365 * 24 * 3600.0
    requests = [
        ("default", {"log": "bpi", "sink": "dfg"}),
        ("default", {"log": "bpi", "sink": "histogram"}),
        ("default", {"log": "bpi", "sink": "histogram"}),
        ("default", {"log": "bpi", "sink": "variants", "k": 5}),
        ("default", {"log": "bpi", "sink": "process_map", "top": 0.5}),
        ("default", {"log": "bpi", "sink": "neighborhood",
                     "activity": center, "k": 2}),
        ("default", {"log": "bpi", "sink": "fitness"}),
        ("default", {"log": "bpi", "sink": "alignments"}),
        ("default", {"logs": ["bpi", "other"], "sink": "dfg"}),
        ("default", {"logs": ["bpi", "other"], "sink": "compare"}),
        ("default", {"log": "disk", "sink": "dfg",
                     "window": [0.0, 10 * 86400.0]}),
        ("default", {"log": "disk", "sink": "dfg", "backend": "streaming"}),
        ("append", {"log": "disk", "activity": [0, 1, 2], "case": [0, 0, 0],
                    "time": [t_last, t_last + 1, t_last + 2]}),
        ("default", {"log": "disk", "sink": "dfg", "backend": "streaming"}),
        ("default", {"log": "nope", "sink": "dfg"}),
        ("default", {"log": "bpi", "sink": "wat"}),
        ("default", {"sink": "dfg"}),
        ("starved", {"log": "bpi", "sink": "dfg"}),
        ("starved", {"log": "bpi", "sink": "dfg"}),
        ("starved", {"log": "bpi", "sink": "dfg"}),
    ]

    async def go(app):
        out = []
        for tenant, req in requests:
            if tenant == "append":
                out.append(await app.append(dict(req)))
            else:
                out.append(await app.handle(dict(req), tenant=tenant))
        return out

    try:
        got = {w: run(go(a)) for w, a in zip(("port", "ref"), apps)}
    finally:
        _close_both(apps)
    for (tenant, req), p, r in zip(requests, got["port"], got["ref"]):
        wp, wr = _wire(p), _wire(r)
        assert wp[:4] == wr[:4], req
        if p.status == 429:  # the wait depends on the clock
            assert p.payload.keys() == r.payload.keys()
        else:
            assert wp[4] == wr[4], req
    # cache hits ride the hot lane under either cutoff
    assert {p.headers.get("X-Lane") for p in got["port"] if p.ok} == {
        "hot", "cold"}
    assert [p.status for p in got["port"]][-3:] == [200, 200, 429]


def test_coalesced_burst_matches_the_reference(memmap_log):
    """A burst of identical cold requests on each package: one execution,
    one leader and eleven followers, equal payloads.  (A follower's lane
    is cold, or hot when its probe ran after the leader's result reached
    the cache but before the group settled on the loop, in either
    package.)"""
    sources = {"live": {"port": memmap_log,
                        "ref": ref_core.MemmapLog.open(memmap_log.path)}}
    apps = _both(sources, hot_cutoff_s=1e-9)
    req = {"log": "live", "sink": "dfg", "backend": "streaming"}

    async def go(app):
        return await asyncio.gather(*(app.handle(dict(req))
                                      for _ in range(12)))

    try:
        got = [run(go(a)) for a in apps]
        execs = [a.service.engine.stats.executions for a in apps]
    finally:
        _close_both(apps)
    assert execs == [1, 1]
    for resps in got:
        assert [r.status for r in resps] == [200] * 12
        assert sorted(r.headers["X-Coalesced"] for r in resps) == \
            ["0"] + ["1"] * 11
        assert [r.headers["X-Lane"] for r in resps
                if r.headers["X-Coalesced"] == "0"] == ["cold"]
    assert {json.dumps(canonical_payload(r.payload), sort_keys=True)
            for r in got[0] + got[1]} == {
        json.dumps(canonical_payload(got[1][0].payload), sort_keys=True)}


def _raw_http(address, request_bytes):
    """Send raw request bytes to ``address`` (a reference client's exact
    request) and return (status line, headers, body bytes)."""
    host, port = address[len("http://"):].split(":")
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(request_bytes)
        chunks = []
        while True:
            data = s.recv(65536)
            if not data:
                break
            chunks.append(data)
    raw = b"".join(chunks)
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = dict(line.split(": ", 1) for line in lines[1:])
    if headers.get("Transfer-Encoding") == "chunked":
        out, rest = [], body
        while True:
            size, _, rest = rest.partition(b"\r\n")
            n = int(size, 16)
            if n == 0:
                break
            out.append(rest[:n])
            rest = rest[n + 2:]
        body = b"".join(out)
    return lines[0], headers, body


def _request_bytes(method, path, body=None, headers=()):
    data = json.dumps(body).encode() if body is not None else b""
    head = [f"{method} {path} HTTP/1.1", "Host: 127.0.0.1",
            "Accept-Encoding: identity", "Connection: close"]
    if body is not None:
        head += ["Content-Type: application/json",
                 f"Content-Length: {len(data)}"]
    head += list(headers)
    return ("\r\n".join(head) + "\r\n\r\n").encode() + data


RAW_REQUESTS = [
    ("POST", "/query", {"log": "bpi", "sink": "dfg"}, ()),
    ("POST", "/query", {"log": "bpi", "sink": "dfg"}, ("X-Tenant: t1",)),
    ("POST", "/query/stream", {"log": "bpi", "sink": "alignments"}, ()),
    ("POST", "/query", {"log": "nope", "sink": "dfg"}, ()),
    ("POST", "/query", {"log": "bpi", "sink": "wat"}, ()),
    ("POST", "/query", None, ()),
    ("GET", "/query", None, ()),
    ("GET", "/nope", None, ()),
    ("GET", "/healthz", None, ()),
    ("GET", "/readyz", None, ()),
    ("POST", "/append", {"log": "bpi", "activity": [0], "case": [0],
                         "time": [0.0]}, ()),
]


def test_reference_client_requests_answered_the_same():
    """Raw HTTP requests, byte for byte what a reference client sends, get
    the same status line, header names, lane and coalesce headers and
    canonical bodies from the port's server as from the reference's."""
    repo = generate_repository(150, ProcessSpec(seed=3), seed=3)
    apps = _both({"bpi": {"port": repo, "ref": ref_repository(repo)}})
    servers = {"port": TransportServer, "ref": ref_transport.TransportServer}

    def exercise(srv):
        return [_raw_http(srv.address, _request_bytes(m, p, b, h))
                for m, p, b, h in RAW_REQUESTS]

    got = {}
    try:
        for which, app in zip(("port", "ref"), apps):
            got[which] = over_http(app, exercise, servers[which])
    finally:
        _close_both(apps)
    for req, p, r in zip(RAW_REQUESTS, got["port"], got["ref"]):
        assert p[0] == r[0], req
        drop = ("X-Trace-Id", "traceparent")
        assert sorted(k for k in p[1] if k not in drop) == sorted(
            k for k in r[1] if k not in drop), req
        for k in ("Content-Type", "X-Lane", "X-Coalesced",
                  "Transfer-Encoding"):
            assert p[1].get(k) == r[1].get(k), (req, k)
        if req[1] == "/query/stream":
            pb = reassemble_ndjson(p[2].decode().splitlines())
            rb = reassemble_ndjson(r[2].decode().splitlines())
        else:
            pb, rb = json.loads(p[2]), json.loads(r[2])
        assert canonical_payload(pb) == canonical_payload(rb), req


def test_reference_trace_ring_mines_the_same_psi_in_the_port(repo, tmp_path):
    """A trace ring the reference's transport writes reads back through the
    port's ``TraceStore`` and mines the same Ψ over the same span names."""
    ring = tmp_path / "ring"
    svc = ref_serve.QueryService(ref_engine())
    svc.register("bpi", ref_repository(repo))
    app = _ref_app(svc, trace_dir=str(ring))

    async def go(app):
        for req in ({"log": "bpi", "sink": "dfg"},
                    {"log": "bpi", "sink": "dfg"},
                    {"log": "bpi", "sink": "histogram"},
                    {"log": "nope", "sink": "dfg"},
                    {"log": "bpi", "sink": "fitness"}):
            await app.handle(req, traceparent=mint_context().to_traceparent())

    try:
        run(go(app))
    finally:
        app.close()
    ref_repo = ref_obs.TraceStore(str(ring)).to_repository()
    port_store = port_obs.TraceStore(str(ring))
    try:
        port_repo = port_store.to_repository()
    finally:
        port_store.close()
    assert port_repo.activity_names == ref_repo.activity_names
    assert "transport" in {r["source"] for r in
                           ref_obs.TraceStore(str(ring)).read_records()}
    src, dst, valid = port_repo.df_pairs()
    r_src, r_dst, r_valid = ref_repo.df_pairs()
    psi = port_core.dfg_numpy(src, dst, valid, port_repo.num_activities)
    ref_psi = ref_core.dfg_numpy(r_src, r_dst, r_valid,
                                 ref_repo.num_activities)
    assert psi.sum() > 0
    np.testing.assert_array_equal(psi, np.asarray(ref_psi))


# -- lockdep ------------------------------------------------------------------

LOCKDEP_RUN = r"""
import asyncio, sys
from repro_torch.analysis import lockdep
from repro_torch.data import ProcessSpec, generate_repository
from repro_torch.query import QueryEngine
from repro_torch.serve import QueryService
from repro_torch.transport import TransportApp, TransportConfig

assert lockdep.lockdep_enabled()
svc = QueryService(QueryEngine(device="cpu"))
svc.register("bpi", generate_repository(120, ProcessSpec(seed=4), seed=4))
app = TransportApp(svc, TransportConfig(hot_cutoff_s=1e-4, rate=5.0,
                                        burst=20.0, trace_dir=sys.argv[1]))

async def go():
    reqs = [{"log": "bpi", "sink": s} for s in
            ("dfg", "histogram", "variants", "dfg", "fitness")] * 4
    out = await asyncio.gather(*(app.handle(r) for r in reqs))
    out.append(await app.handle({"sink": "metrics"}))
    out.append(await app.handle({"sink": "slo"}))
    return [r.status for r in out], app.readiness()[0]

try:
    statuses, ready = asyncio.run(go())
finally:
    app.close()
print(sorted(set(statuses)), ready)
"""


def test_transport_under_lockdep(tmp_path):
    """The whole request path under ``REPRO_LOCKDEP=1`` (in a child process
    given its own environment): no lock-order inversion between the
    scheduler, admission, metrics, trace store and engine locks."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_LOCKDEP="1")
    out = subprocess.run(
        [sys.executable, "-c", LOCKDEP_RUN, str(tmp_path / "traces")],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[200, 429] True"
