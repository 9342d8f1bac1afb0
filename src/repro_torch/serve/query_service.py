"""Multi-tenant process-query serving — the ROADMAP's "mining queries for
millions of users" front door.

A :class:`QueryService` owns a registry of named event stores (in-memory
repositories, out-of-core memmap logs and case-sharded logs) and one shared
:class:`~repro_torch.query.execute.QueryEngine`, so every tenant's
dashboard queries share the plan/result cache: the first analyst to ask
for a diced DFG pays the scan, everyone after is O(1).  The default engine
runs on the card (``QueryEngine()``); pass
``QueryService(QueryEngine(device="cpu"))`` to serve from the host.

The request surface is deliberately wire-friendly (dict in, dict out) so an
HTTP/RPC layer can wrap it without touching engine internals::

    svc = QueryService()             # QueryEngine() on the card
    svc.register("bpi", repo)
    out = svc.query({
        "log": "bpi", "sink": "dfg",
        "window": [t0, t1], "activities": ["a", "b"],
    })
    out["psi"], out["names"], out["from_cache"]

Topology sinks ride the engine's graph tier: ``{"sink": "process_map"}``
(significance-filtered map, k-anonymity floor applied to nodes *and*
edges) and ``{"sink": "neighborhood", "activity": a, "k": 2}`` are served
from the CSR event-knowledge graph once the engine's repeat-query
crossover builds it — repeated dashboard topology queries stop rescanning
the log entirely.

Conformance sinks (``{"sink": "fitness"}`` / ``{"sink": "alignments"}``)
expose aggregate replay/alignment conformance.  The model defaults to the
log's own whole-log discovered dependency graph; ``"model_of": other_log``
replays against another registered log's model (cross-deployment
conformance) — the other log's policy joins the request's policy
combination, so a tenant cannot route around a view through a model.  Only
aggregates and the deviation census leave the service, and the census
obeys the k-anonymity floor: deviating flows below the floor are not
reported.

Multi-log requests name several registered logs at once and compile to the
engine's union source algebra::

    svc.query({"logs": ["prod", "canary"], "sink": "compare",
               "window": [t0, t1]})
    # → per-log Ψ on the aligned vocabulary, drift matrices, replay fitness

Per-tenant access control reuses
:class:`repro_torch.core.views.AccessPolicy`:
a policy registered with the log is enforced on every request (view
projection applied in-plan, time dicing gated).  Across a union the
*combination* of the named logs' policies applies — the k-anonymity floor
is the maximum of the per-log floors, time dicing must be allowed by every
log, and logs under different (or partially missing) views cannot be
combined at all: a compare must not leak a log the tenant cannot see at
full resolution through the diff against a log they can.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.lockdep import make_lock
from repro_torch.core.streaming import MemmapLog, MemmapLogWriter
from repro_torch.core.views import AccessDenied, AccessPolicy, ActivityView
from repro_torch.graph.shard import ShardedLog
from repro_torch.obs import SLOEngine, kernel_registry, prometheus_text
from repro_torch.query import (
    AlignmentsSink,
    ApplyView,
    CompareSink,
    DFGSink,
    FitnessSink,
    HistogramSink,
    NeighborhoodSink,
    ProcessMapSink,
    Q,
    Query,
    QueryEngine,
    QueryPlanError,
    VariantsSink,
)
from repro_torch.query.execute import _Collected

__all__ = ["QueryService", "RequestProbe"]


@dataclasses.dataclass
class _Grant:
    """The effective policy for one request (single log or union)."""

    floor: int = 0
    view: Optional[ActivityView] = None
    time_windows_allowed: bool = True

    @property
    def has_view(self) -> bool:
        return self.view is not None


def _combine_policies(
    names: List[str], policies: List[Optional[AccessPolicy]]
) -> _Grant:
    """Cross-union policy combination (strictest-wins).

    Views are special: applying one view to a union only makes sense when
    every member is governed by the *same* view — otherwise the union (or a
    compare diff) would expose a log at a resolution its own policy forbids.
    """
    floor = max(
        (p.min_group_count for p in policies if p is not None), default=0
    )
    allowed = all(
        p.time_windows_allowed for p in policies if p is not None
    )
    views = [(n, p.view) for n, p in zip(names, policies)
             if p is not None and p.view is not None]
    if not views:
        return _Grant(floor=floor, view=None, time_windows_allowed=allowed)
    if len(views) != len(names):
        bare = [n for n, p in zip(names, policies)
                if p is None or p.view is None]
        raise AccessDenied(
            f"logs {sorted(n for n, _ in views)} are view-protected but "
            f"{bare} are not; a union would expose them side by side"
        )
    canon = ApplyView.from_view(views[0][1])
    for n, v in views[1:]:
        if ApplyView.from_view(v) != canon:
            raise AccessDenied(
                f"logs {names} are governed by different views and cannot "
                "be combined in one union/compare"
            )
    return _Grant(
        floor=floor, view=views[0][1], time_windows_allowed=allowed
    )


@dataclasses.dataclass(frozen=True)
class RequestProbe:
    """Everything a transport tier needs to admit, coalesce, and lane one
    request — computed at *enqueue time*, before anything queues.

    ``group_key`` is the in-flight coalescing identity: requests are
    dedup'd by (effective tenant policy, canonical plan, source
    fingerprint).  The fingerprint is the one observed when this probe ran,
    so an append that moves a log's fingerprint splits pre-append and
    post-append waiters into different groups — a coalesced execution that
    started against the old bytes is never fanned out to a waiter that
    enqueued after the data changed.

    ``cached`` / ``delta_hint`` / ``estimated_cost_s`` are the SLO
    classifier's inputs: a predicted cache/delta/graph serve is *hot*
    (~µs–ms), a predicted cold scan is *cold* (~100s of ms) and must not
    head-of-line-block the warm lane."""

    sink: str
    names: Tuple[str, ...]
    fingerprint: str
    policy_token: str
    plan_token: str
    backend: str
    cached: bool
    delta_hint: bool
    estimated_cost_s: float
    coalescable: bool

    @property
    def group_key(self) -> Tuple[str, str, str]:
        return (self.policy_token, self.plan_token, self.fingerprint)


def _policy_token(grant: _Grant) -> str:
    """Canonical string identity of an effective request policy: two
    tenants under byte-identical effective policies may share a coalesced
    execution; any difference (floor, view, dicing rights) must not."""
    view = (
        repr(ApplyView.from_view(grant.view)) if grant.has_view else "-"
    )
    return (
        f"floor={grant.floor};dicing={int(grant.time_windows_allowed)};"
        f"view={view}"
    )


class QueryService:
    def __init__(
        self,
        engine: Optional[QueryEngine] = None,
        *,
        forensics_floor: int = 0,
        slo_objectives=None,
    ):
        # the default engine runs on the card; a CPU service passes its own
        self.engine = engine if engine is not None else QueryEngine()
        # k-anonymity floor for the engine-introspection sinks ("forensics",
        # "metrics", and "slo") when the request names no logs; when it
        # does, the strictest of this and the named logs' combined floor
        # applies
        self.forensics_floor = int(forensics_floor)
        # declarative SLOs over the shared engine registry (a transport
        # tier's series live there too), served via {"sink": "slo"}
        self.slo = SLOEngine(self.engine.metrics, objectives=slo_objectives)
        self._logs: Dict[str, object] = {}
        self._policies: Dict[str, Optional[AccessPolicy]] = {}
        self._lock = make_lock("QueryService")
        # one lock per registered name: appends write three column files +
        # meta.json and must never interleave on the same log
        self._append_locks: Dict[str, threading.Lock] = {}

    # -- registry ------------------------------------------------------------
    def register(
        self, name: str, source, policy: Optional[AccessPolicy] = None
    ) -> None:
        """Attach a repository or memmap log under a tenant-visible name."""
        with self._lock:
            self._logs[name] = source
            self._policies[name] = policy

    def unregister(self, name: str) -> None:
        with self._lock:
            self._logs.pop(name, None)
            self._policies.pop(name, None)
            self._append_locks.pop(name, None)

    def logs(self):
        with self._lock:
            return sorted(self._logs)

    # -- the live-append endpoint ---------------------------------------------
    def append(self, request: Dict) -> Dict:
        """Append a time-ordered batch of events to a registered memmap log.

        Request: ``{"log": name, "activity": [...], "case": [...],
        "time": [...]}`` (aligned arrays).  The grown log replaces the
        registered handle, and because the engine's fingerprints are
        prefix-preserving, tenants' cached dashboard queries stay warm: the
        next query per plan runs a ``delta`` scan over just this suffix (or
        is served unchanged when its window predates the append) instead of
        a full rescan.  Union dashboards over several logs stay warm the
        same way — only the appended branch is rescanned.

        A registered :class:`ShardedLog` routes the batch to its owning
        shards (``case % K``): only those shards' fingerprints change, so
        the next sharded-graph query rescans just the owning shards'
        suffixes and serves every other shard from cache.
        """
        name = request.get("log")
        with self._lock:
            if name not in self._logs:
                raise KeyError(f"unknown log {name!r}")
            source = self._logs[name]
            append_lock = self._append_locks.setdefault(
                name, make_lock("QueryService.append")
            )
        if not isinstance(source, (MemmapLog, ShardedLog)):
            raise QueryPlanError(
                f"log {name!r} is an in-memory repository; only memmap and "
                "sharded logs support live appends"
            )
        activity = np.asarray(request["activity"], dtype=np.int32)
        case = np.asarray(request["case"], dtype=np.int32)
        time = np.asarray(request["time"], dtype=np.float64)
        if not (activity.shape == case.shape == time.shape):
            raise ValueError("activity/case/time must be aligned 1-D arrays")
        with append_lock:  # serialize writers: column files must not interleave
            with self._lock:
                source = self._logs.get(name, source)  # newest handle
            if isinstance(source, ShardedLog):
                grown = source.append(activity, case, time)
            else:
                writer = MemmapLogWriter.open_append(source.path)
                writer.append(activity, case, time)
                grown = writer.close()
            with self._lock:
                if name in self._logs:  # unless unregistered mid-append
                    self._logs[name] = grown
        return {
            "log": name,
            "appended": int(activity.shape[0]),
            "num_events": grown.num_events,
            "num_activities": grown.num_activities,
        }

    # -- the serving endpoint -------------------------------------------------
    def _resolve(self, names: List[str]) -> Tuple[List[object], _Grant]:
        with self._lock:
            for n in names:
                if n not in self._logs:
                    raise KeyError(f"unknown log {n!r}")
            sources = [self._logs[n] for n in names]
            policies = [self._policies[n] for n in names]
        return sources, _combine_policies(names, policies)

    def _build_query(
        self, request: Dict, sources: List[object], names: List[str],
        grant: _Grant,
    ) -> Query:
        if len(names) == 1:
            q = Q.log(sources[0]).using(self.engine)
        else:
            q = Q.logs(*zip(sources, names)).using(self.engine)
        if request.get("window") is not None:
            if not grant.time_windows_allowed:
                raise AccessDenied("time dicing not permitted by policy")
            t0, t1 = request["window"]
            q = q.window(float(t0), float(t1))
        if request.get("activities") is not None:
            if grant.has_view:
                # a raw-activity filter under a coarsening view would expose
                # per-activity counts inside a group (and probe raw names)
                raise AccessDenied(
                    "activity filters name raw activities and are not "
                    "permitted under a view policy"
                )
            q = q.activities(
                request["activities"], relink=bool(request.get("relink", False))
            )
        if request.get("top_variants") is not None:
            q = q.top_variants(int(request["top_variants"]))
        if grant.has_view:
            q = q.view(grant.view)
        return q

    @staticmethod
    def _floor_process_map(pm, floor: int) -> Dict:
        """k-anonymity on a process map: nodes below the floor disappear,
        and so does every edge below the floor or touching a dropped node —
        a sub-floor activity must not be reconstructible from its flows."""
        keep = {
            a for a, c in zip(pm.activities, pm.node_counts)
            if not floor or int(c) >= floor
        }
        edges = [
            (s, d, int(c)) for s, d, c in pm.edges
            if s in keep and d in keep and (not floor or int(c) >= floor)
        ]
        return {
            "activities": [a for a in pm.activities if a in keep],
            "node_counts": [
                int(c) for a, c in zip(pm.activities, pm.node_counts)
                if a in keep
            ],
            "edges": [list(e) for e in edges],
            "top": pm.top,
            "edge_top": pm.edge_top,
            "dropped_activities": (
                pm.dropped_activities + len(pm.activities) - len(keep)
            ),
            "dropped_edges": pm.dropped_edges + len(pm.edges) - len(edges),
        }

    @staticmethod
    def _floor_census(res, floor: int) -> List[Dict]:
        """k-anonymity on a deviation census: a deviating flow observed
        fewer than ``floor`` times is not reported (it could identify a
        handful of cases); survivors are sorted most-frequent first."""
        kept = [
            {"edge": [s, d], "count": int(c)}
            for (s, d), c in res.deviating_edges.items()
            if not floor or int(c) >= floor
        ]
        kept.sort(key=lambda e: (-e["count"], e["edge"]))
        return kept

    @staticmethod
    def _floor_neighborhood(nb, floor: int) -> Dict:
        """k-anonymity on a neighborhood: sub-floor edges are dropped, and
        with them any reached activity left without a surviving edge (the
        center always remains)."""
        edges = [
            (s, d, int(c)) for s, d, c in nb.edges
            if not floor or int(c) >= floor
        ]
        touched = {nb.center}
        for s, d, _ in edges:
            touched.add(s)
            touched.add(d)
        acts = [a for a in nb.activities if a in touched]
        return {
            "center": nb.center,
            "k": nb.k,
            "direction": nb.direction,
            "activities": acts,
            "hops": {a: nb.hops[a] for a in acts},
            "edges": [list(e) for e in edges],
        }

    # -- engine introspection -------------------------------------------------
    def _introspection_floor(self, request: Dict) -> int:
        """Floor for introspection sinks: named logs' combined grant (if
        any) joined with the service-level ``forensics_floor`` — whichever
        is strictest.  Engine spans aggregate *every* tenant's activity, so
        a tenant must not see below any floor they are subject to."""
        multi = request.get("logs")
        names = [str(n) for n in multi] if multi else (
            [request["log"]] if request.get("log") is not None else []
        )
        floor = self.forensics_floor
        if names:
            _, grant = self._resolve(names)
            floor = max(floor, grant.floor)
        return floor

    def _introspect(self, request: Dict, sink: str) -> Dict:
        floor = self._introspection_floor(request)
        if sink == "slo":
            payload = self.slo.evaluate(floor=floor)
            payload["floor"] = floor
            return payload
        if sink == "metrics":
            payload = {
                "sink": "metrics",
                "floor": floor,
                "metrics": self.engine.metrics_snapshot(floor=floor),
            }
            if request.get("format") == "prometheus":
                payload["prometheus"] = prometheus_text(
                    self.engine.metrics, kernel_registry()
                )
            return payload
        # forensics: mine the engine's own span telemetry through the
        # engine itself (the forensics query then shows up in the next one)
        telemetry = self.engine.telemetry
        events = len(telemetry)
        if events == 0:
            return {
                "sink": "forensics", "floor": floor, "events": 0,
                "dropped_events": telemetry.dropped,
                "psi": [], "names": [],
            }
        res = Q.log(self.engine.own_telemetry()).using(self.engine).dfg()
        psi = res.value
        if floor:
            psi = np.where(psi >= floor, psi, 0)
        return {
            "sink": "forensics",
            "floor": floor,
            "events": events,
            "dropped_events": telemetry.dropped,
            "psi": psi.tolist(),
            "names": res.names,
            "from_cache": res.from_cache,
            "backend": res.physical.backend,
            "wall_s": res.wall_s,
        }

    @staticmethod
    def _sink_object(request: Dict, grant: _Grant):
        """The sink instance ``query()`` would run for this request —
        fully parameterized, so its canonical plan key covers every
        response-shaping argument (top/edge_top/k/direction/backend).
        Conformance sinks are built *without* the resolved model (resolving
        may run discovery — far too heavy for an admission-time probe);
        ``model_of`` joins the plan token instead."""
        sink = request.get("sink", "dfg")
        backend = request.get("backend", "auto")
        if sink == "dfg":
            return DFGSink(backend=backend)
        if sink == "histogram":
            return HistogramSink()
        if sink == "variants":
            if grant.has_view:
                raise AccessDenied(
                    "variants expose raw sequences and are not permitted "
                    "under a view policy"
                )
            k = request.get("k")
            return VariantsSink(int(k) if k is not None else None)
        if sink == "process_map":
            return ProcessMapSink(
                top=float(request.get("top", 0.2)),
                edge_top=(
                    float(request["edge_top"])
                    if request.get("edge_top") is not None
                    else None
                ),
                backend=backend,
            )
        if sink == "neighborhood":
            if request.get("activity") is None:
                raise KeyError('"neighborhood" requests need an "activity"')
            return NeighborhoodSink(
                str(request["activity"]),
                k=int(request.get("k", 1)),
                direction=str(request.get("direction", "out")),
                backend=backend,
            )
        if sink == "fitness":
            return FitnessSink(backend=backend)
        if sink == "alignments":
            return AlignmentsSink(backend=backend)
        if sink == "compare":
            return CompareSink(backend=backend)
        raise QueryPlanError(f"unknown sink {sink!r}")

    def probe(self, request: Dict) -> RequestProbe:
        """Admission-time probe for a transport tier (read-only).

        Resolves the request exactly as :meth:`query` would — same policy
        combination, same canonical plan — but executes nothing and mutates
        no engine state, and returns the :class:`RequestProbe` the serving
        layer coalesces and lanes on.  Raises the same ``KeyError`` /
        ``AccessDenied`` / ``QueryPlanError`` a real execution would, so
        invalid requests are rejected before they queue."""
        sink = request.get("sink", "dfg")
        if sink in ("forensics", "metrics", "slo"):
            floor = self._introspection_floor(request)
            # introspection responses are point-in-time snapshots of the
            # live engine — there is no stable source fingerprint to
            # coalesce on, and they are ~µs serves anyway
            return RequestProbe(
                sink=sink,
                names=(),
                fingerprint="live",
                policy_token=f"floor={floor}",
                plan_token=(
                    f"{sink};format={request.get('format')};"
                    f"trace={int(bool(request.get('trace')))}"
                ),
                backend="introspect",
                cached=False,
                delta_hint=False,
                estimated_cost_s=1e-4,
                coalescable=False,
            )
        multi = request.get("logs")
        if multi is not None:
            names = [str(n) for n in multi]
            if not names:
                raise QueryPlanError('"logs" must name at least one log')
        else:
            names = [request.get("log")]
            if names[0] is None:
                raise KeyError("request names no log")
        model_of = (
            str(request["model_of"])
            if sink in ("fitness", "alignments")
            and request.get("model_of") is not None
            else None
        )
        if model_of is not None:
            combined = list(dict.fromkeys(names + [model_of]))
            sources_c, grant = self._resolve(combined)
            sources = [sources_c[combined.index(n)] for n in names]
        else:
            sources, grant = self._resolve(names)
        q = self._build_query(request, sources, names, grant)
        plan = self.engine.probe(q, self._sink_object(request, grant))
        plan_token = (
            f"{plan.plan_key};trace={int(bool(request.get('trace')))}"
        )
        if model_of is not None:
            plan_token += f";model_of={model_of}"
        return RequestProbe(
            sink=sink,
            names=tuple(names),
            fingerprint=plan.fingerprint,
            policy_token=_policy_token(grant),
            plan_token=plan_token,
            backend=plan.backend,
            cached=plan.cached,
            delta_hint=plan.delta_hint,
            estimated_cost_s=plan.estimated_cost_s,
            coalescable=True,
        )

    def query(self, request: Dict, trace_context=None) -> Dict:
        """Execute one request dict; returns a JSON-shaped response dict.

        ``{"log": name}`` targets a single registered log; ``{"logs":
        [name, ...]}`` targets their union (sinks ``dfg`` / ``histogram`` /
        ``variants`` merge; sink ``compare`` keeps the logs apart and
        reports drift).

        Three introspection sinks need no log at all: ``{"sink":
        "forensics"}`` mines the engine's own execution spans into a DFG of
        the serving process, ``{"sink": "metrics"}`` snapshots the
        engine's counters/histograms (``"format": "prometheus"`` adds the
        text exposition), and ``{"sink": "slo"}`` evaluates the declarative
        objectives (verdicts, error budgets, burn rates).  Any request may
        set ``"trace": true`` to attach the per-query execution trace to
        the response; every non-introspection response carries the
        execution's ``trace_id``.

        ``trace_context`` (a :class:`repro_torch.obs.TraceContext`) scopes
        the engine execution under the caller's distributed trace — a
        transport tier passes its request span here so the engine trace
        (and every shard/union sub-trace under it) shares the request's
        trace id."""
        if trace_context is not None:
            with self.engine.trace_scope(trace_context):
                return self._query(request)
        return self._query(request)

    def _query(self, request: Dict) -> Dict:
        if request.get("sink") in ("forensics", "metrics", "slo"):
            return self._introspect(request, request["sink"])
        multi = request.get("logs")
        if multi is not None:
            names = [str(n) for n in multi]
            if not names:
                raise QueryPlanError('"logs" must name at least one log')
        else:
            names = [request.get("log")]
            if names[0] is None:
                raise KeyError("request names no log")
        sink = request.get("sink", "dfg")
        model_src = None
        if (
            sink in ("fitness", "alignments")
            and request.get("model_of") is not None
        ):
            # cross-log conformance: the reference log's policy joins the
            # combination (strictest wins) before anything runs — a tenant
            # cannot route around a log's view through its model
            other = str(request["model_of"])
            combined = list(dict.fromkeys(names + [other]))
            sources_c, grant = self._resolve(combined)
            sources = [sources_c[combined.index(n)] for n in names]
            model_src = sources_c[combined.index(other)]
        else:
            sources, grant = self._resolve(names)
        q = self._build_query(request, sources, names, grant)
        floor = grant.floor
        if sink == "dfg":
            res = q.dfg(backend=request.get("backend", "auto"))
            psi = res.value
            if floor:
                psi = np.where(psi >= floor, psi, 0)
            payload = {"psi": psi.tolist(), "names": res.names}
        elif sink == "histogram":
            res = q.histogram()
            counts = res.value
            if floor:
                counts = np.where(counts >= floor, counts, 0)
            payload = {"counts": counts.tolist(), "names": res.names}
        elif sink == "variants":
            if grant.has_view:
                # variant sequences spell out raw activity names
                raise AccessDenied(
                    "variants expose raw sequences and are not permitted "
                    "under a view policy"
                )
            k = request.get("k")
            res = q.variants(int(k) if k is not None else None)
            tv = res.value
            keep = (
                tv.counts >= floor if floor
                else np.ones(len(tv.counts), dtype=bool)
            )
            payload = {
                "counts": tv.counts[keep].tolist(),
                "sequences": [s for s, ok in zip(tv.sequences, keep) if ok],
            }
        elif sink == "process_map":
            res = q.process_map(
                top=float(request.get("top", 0.2)),
                edge_top=(
                    float(request["edge_top"])
                    if request.get("edge_top") is not None
                    else None
                ),
                backend=request.get("backend", "auto"),
            )
            payload = self._floor_process_map(res.value, floor)
        elif sink == "neighborhood":
            if request.get("activity") is None:
                raise KeyError('"neighborhood" requests need an "activity"')
            res = q.neighborhood(
                str(request["activity"]),
                k=int(request.get("k", 1)),
                direction=str(request.get("direction", "out")),
                backend=request.get("backend", "auto"),
            )
            payload = self._floor_neighborhood(res.value, floor)
        elif sink in ("fitness", "alignments"):
            model = None
            if model_src is not None:
                st = _Collected(repo=None)
                if grant.has_view:
                    st.view = ApplyView.from_view(grant.view)
                model = self.engine._model_for_source(
                    FitnessSink(), (), model_src, st
                )
            backend = request.get("backend", "auto")
            if sink == "fitness":
                res = q.fitness(model, backend=backend)
                rr = res.value
                payload = {
                    "fitness": rr.fitness,
                    "perfect_traces": rr.perfectly_fitting,
                    "total_traces": int(rr.trace_fitness.shape[0]),
                    "deviations": self._floor_census(rr, floor),
                }
            else:
                res = q.alignments(model, backend=backend)
                ar = res.value
                payload = {
                    "fitness": ar.fitness,
                    "perfect_traces": ar.perfectly_fitting,
                    "total_traces": int(ar.trace_cost.shape[0]),
                    "mean_cost": (
                        float(ar.trace_cost.mean())
                        if ar.trace_cost.shape[0] else 0.0
                    ),
                    "empty_cost": ar.empty_cost,
                    "deviations": self._floor_census(ar, floor),
                }
        elif sink == "compare":
            res = q.compare(backend=request.get("backend", "auto"))
            cr = res.value
            # the k-anonymity floor applies to every exposed matrix; drift
            # is recomputed from the floored Ψs so sub-floor counts cannot
            # be reconstructed from a (raw) difference
            psis = [
                np.where(p >= floor, p, 0) if floor else p for p in cr.psis
            ]
            payload = {
                "names": cr.names,
                "psi": {n: p.tolist() for n, p in zip(cr.log_names, psis)},
                "diff": {
                    n: (p - psis[0]).tolist()
                    for n, p in zip(cr.log_names, psis)
                },
                "fitness": {
                    n: f for n, f in zip(cr.log_names, cr.fitness)
                },
            }
        else:
            raise QueryPlanError(f"unknown sink {sink!r}")

        payload.update({
            "log": names[0] if multi is None else None,
            "logs": names if multi is not None else None,
            "sink": sink,
            "from_cache": res.from_cache,
            "backend": res.physical.backend,
            "wall_s": res.wall_s,
            # the execution's distributed-trace id (a cache hit reports the
            # hit's own trace; its links name the populating run)
            "trace_id": (
                res.trace.trace_id if res.trace is not None else None
            ),
        })
        if request.get("trace"):
            payload["trace"] = (
                res.trace.to_dict() if res.trace is not None else None
            )
        return payload
