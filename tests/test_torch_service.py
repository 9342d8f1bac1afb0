"""``repro_torch.serve.QueryService`` against the reference's
``repro.serve.QueryService`` on the CPU, and the port's calibration.

Both services answer the same request dicts over the same seeded logs (a
port CPU engine against a reference engine on the port's static
thresholds, ``torch_parity.ref_engine``): every payload must be equal key
for key, tolerance 0, except the measured ``wall_s``, the minted
``trace_id`` and the ``backend`` name, which maps ``pallas`` → ``kernel``.
Errors must be the same exception types.  The cases are the service cases
of the reference suites (``test_query_engine``, ``test_conformance_
subsystem``, ``test_delta_query``, ``test_graph_store``,
``test_multilog_query``), plus a sharded append, ``probe`` /
``RequestProbe``, the policy guards and ``explain``.

The calibration cases write their records under ``tmp_path`` and pass
explicit paths; the one that reads ``$GRAPHPM_TORCH_BENCH_*`` does so in a
child process given its own environment.  No test writes ``os.environ``,
changes directory or leaves a thread running.
"""

import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.graph as ref_graph
import repro.obs as ref_obs
import repro.query as ref_query
import repro.query.planner as ref_planner
import repro.serve.query_service as ref_serve
import repro_torch.core as port_core
import repro_torch.data as port_data
import repro_torch.graph as port_graph
import repro_torch.obs as port_obs
import repro_torch.query as port_query
import repro_torch.query.planner as port_planner
import repro_torch.serve as port_serve
from torch_parity import (
    assert_no_collision,
    port_backend,
    ref_engine,
    ref_repository,
)

PACKAGES = ("port", "ref")
#: payload keys a run measures or mints for itself
VOLATILE = ("wall_s", "trace_id", "trace")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAY = 86400.0


def _core(which):
    return port_core if which == "port" else ref_core


def _services(**engine_kw):
    """A port service on a CPU engine and a reference service on an engine
    with the same thresholds."""
    return {
        "port": port_serve.QueryService(
            port_query.QueryEngine(device="cpu", **engine_kw)
        ),
        "ref": ref_serve.QueryService(ref_engine(**engine_kw)),
    }


def _register(svcs, name, sources, policy=None):
    """Register ``sources[which]`` under ``name``; ``policy`` builds each
    package's ``AccessPolicy`` from its core module."""
    for which, svc in svcs.items():
        pol = policy(_core(which)) if policy is not None else None
        svc.register(name, sources[which], pol)


def _same(port_out, ref_out):
    p = {k: v for k, v in port_out.items() if k not in VOLATILE}
    r = {k: v for k, v in ref_out.items() if k not in VOLATILE}
    if r.get("backend") is not None:
        r["backend"] = port_backend(r["backend"])
    assert p == r


def _query(svcs, request):
    """The request on both services; the payloads must agree."""
    out = {w: svc.query(dict(request)) for w, svc in svcs.items()}
    _same(out["port"], out["ref"])
    return out["port"]


def _raises(svcs, request, port_exc, ref_exc, method="query"):
    with pytest.raises(port_exc) as pe:
        getattr(svcs["port"], method)(dict(request))
    with pytest.raises(ref_exc) as re_:
        getattr(svcs["ref"], method)(dict(request))
    assert type(pe.value).__name__ == type(re_.value).__name__
    return str(pe.value), str(re_.value)


def _denied(svcs, request):
    _raises(svcs, request, port_core.views.AccessDenied,
            ref_core.views.AccessDenied)


def _pair(port_repo):
    """The port's repository and the reference's of the same columns; the
    port splits variant-hash collisions the reference merges, so every
    seeded repository that reaches a variant table holds none."""
    assert_no_collision(port_repo)
    return {"port": port_repo, "ref": ref_repository(port_repo)}


def _from_traces(traces, **kw):
    return {
        "port": port_core.EventRepository.from_traces(traces, **kw),
        "ref": ref_core.EventRepository.from_traces(traces, **kw),
    }


def _oracle_dfg(repo):
    src, dst, valid = repo.df_pairs()
    return port_core.dfg_numpy(src, dst, valid, repo.num_activities)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def repo():
    return _pair(port_data.generate_repository(
        400, port_data.ProcessSpec(num_activities=11, seed=9)
    ))


@pytest.fixture(scope="module")
def repo_a():
    return _pair(port_data.generate_repository(
        120, port_data.ProcessSpec(num_activities=7, seed=101)
    ))


@pytest.fixture(scope="module")
def repo_b():
    # overlapping-but-different vocabulary (act_000..009 vs 000..006)
    return _pair(port_data.generate_repository(
        90, port_data.ProcessSpec(num_activities=10, seed=202)
    ))


@pytest.fixture(scope="module")
def mmlog(tmp_path_factory):
    path = tmp_path_factory.mktemp("svc_mm") / "mm"
    log = port_data.generate_memmap_log(
        str(path), 25_000, port_data.ProcessSpec(num_activities=13, seed=31),
        seed=31, batch_traces=400,
    )
    return {"port": log, "ref": ref_core.MemmapLog.open(log.path)}


@pytest.fixture(scope="module")
def base_log(tmp_path_factory):
    path = tmp_path_factory.mktemp("svc_delta") / "base"
    return port_data.generate_memmap_log(
        str(path), 20_000, port_data.ProcessSpec(num_activities=9, seed=41),
        seed=41, batch_traces=300,
    )


@pytest.fixture()
def log_copies(base_log, tmp_path):
    """One fresh on-disk copy per package — appends mutate the files."""
    out = {}
    for which in PACKAGES:
        path = str(tmp_path / f"log_{which}")
        shutil.copytree(base_log.path, path)
        out[which] = _core(which).MemmapLog.open(path)
    return out


# ---------------------------------------------------------------------------
# serving integration (test_query_engine.py)
# ---------------------------------------------------------------------------


def test_query_service_end_to_end(repo, mmlog):
    svcs = _services()
    _register(svcs, "main", repo)
    _register(svcs, "disk", mmlog)
    _register(svcs, "locked", repo,
              lambda c: c.AccessPolicy(time_windows_allowed=False))
    out = _query(svcs, {"log": "main", "sink": "dfg"})
    np.testing.assert_array_equal(np.asarray(out["psi"]),
                                  _oracle_dfg(repo["port"]))
    assert not out["from_cache"]
    assert _query(svcs, {"log": "main", "sink": "dfg"})["from_cache"]

    hist = _query(svcs, {"log": "disk", "sink": "histogram"})
    assert sum(hist["counts"]) == mmlog["port"].num_events

    var = _query(svcs, {"log": "main", "sink": "variants", "k": 2})
    assert len(var["sequences"]) <= 2
    # wire-friendly: JSON/query-param values arrive as strings
    var_s = _query(svcs, {"log": "main", "sink": "variants", "k": "2"})
    assert var_s["counts"] == var["counts"]

    _denied(svcs, {"log": "locked", "sink": "dfg", "window": [0.0, 1.0]})
    _query(svcs, {"log": "disk", "sink": "dfg",
                  "window": [0.0, 40 * DAY], "activities": ["act_001",
                                                            "act_004"]})
    _query(svcs, {"log": "disk", "sink": "dfg", "top_variants": 3})


def test_query_service_view_policy_guards(repo):
    """A coarsening view must not be bypassable via raw-activity filters or
    raw variant sequences, and min_group_count suppresses all sinks."""
    names = repo["port"].activity_names
    svcs = _services()
    _register(svcs, "v", repo, lambda c: c.AccessPolicy(
        view=c.ActivityView({a: "g" for a in names[:4]})))
    _register(svcs, "k", repo, lambda c: c.AccessPolicy(
        min_group_count=10**9))
    _denied(svcs, {"log": "v", "sink": "dfg", "activities": [names[0]]})
    _denied(svcs, {"log": "v", "sink": "variants"})
    out = _query(svcs, {"log": "v", "sink": "dfg"})
    assert out["names"][0] == "g"

    assert sum(_query(svcs, {"log": "k", "sink": "histogram"})["counts"]) == 0
    assert not np.asarray(_query(svcs, {"log": "k", "sink": "dfg"})["psi"]).any()
    assert _query(svcs, {"log": "k", "sink": "variants"})["sequences"] == []


def test_service_unknown_log_and_sink(repo):
    svcs = _services()
    _register(svcs, "main", repo)
    _raises(svcs, {"log": "ghost", "sink": "dfg"}, KeyError, KeyError)
    _raises(svcs, {"sink": "dfg"}, KeyError, KeyError)
    _raises(svcs, {"log": "main", "sink": "nope"},
            port_query.QueryPlanError, ref_query.QueryPlanError)
    _raises(svcs, {"logs": [], "sink": "dfg"},
            port_query.QueryPlanError, ref_query.QueryPlanError)
    assert svcs["port"].logs() == ["main"]
    svcs["port"].unregister("main")
    assert svcs["port"].logs() == []


# ---------------------------------------------------------------------------
# conformance sinks (test_conformance_subsystem.py)
# ---------------------------------------------------------------------------


def test_service_fitness_census_floor():
    svcs = _services()
    repo = _from_traces([["a", "b", "c"]] * 40 + [["a", "c", "b"]] * 2)
    _register(svcs, "bpi", repo, lambda c: c.AccessPolicy(min_group_count=5))
    _register(svcs, "open", repo)
    out = _query(svcs, {"log": "bpi", "sink": "fitness"})
    assert out["deviations"] == []  # counts of 2 fall below the floor of 5
    assert out["total_traces"] == 42
    raw = _query(svcs, {"log": "open", "sink": "fitness"})
    # the self-discovered model admits a→c (dependency 2/3 ≥ 0.5); the
    # reversed c→b flow is the deviation the census reports un-floored
    assert {tuple(d["edge"]) for d in raw["deviations"]} == {("c", "b")}
    ali = _query(svcs, {"log": "open", "sink": "alignments"})
    assert ali["total_traces"] == 42


def test_service_cross_log_model_and_policy_combination():
    svcs = _services()
    _register(svcs, "main", _from_traces([["a", "b"], ["b", "a"]]))
    ref = _from_traces([["a", "b"]] * 5)
    _register(svcs, "ref", ref)
    out = _query(svcs, {"log": "main", "sink": "fitness", "model_of": "ref"})
    assert 0.0 < out["fitness"] < 1.0
    ali = _query(svcs, {"log": "main", "sink": "alignments",
                        "model_of": "ref"})
    assert ali["empty_cost"] == 2  # START→a→b→END executes two activities

    # a view-protected reference cannot be combined with a bare log
    _register(svcs, "guarded", ref, lambda c: c.AccessPolicy(
        view=c.ActivityView(mapping={"a": "g", "b": "g"})))
    _denied(svcs, {"log": "main", "sink": "fitness", "model_of": "guarded"})


def test_model_memo_never_aliases_viewed_and_raw_models():
    """A raw resolution (compare's whole-log signal) and a view-governed
    resolution (``model_of`` under a view policy) on the same source occupy
    distinct memo entries."""
    ref = _from_traces([["a", "b"]] * 5)
    main = _from_traces([["a", "b"], ["b", "a"]])
    svcs = _services()
    _register(svcs, "ref", ref)
    _register(svcs, "main", main)
    raw = _query(svcs, {"logs": ["main", "ref"], "sink": "compare"})
    view = lambda c: c.AccessPolicy(  # noqa: E731
        view=c.ActivityView(mapping={"a": "g", "b": "g"}))
    _register(svcs, "guardedmain", main, view)
    _register(svcs, "guardedref", ref, view)
    out = _query(svcs, {"log": "guardedmain", "sink": "fitness",
                        "model_of": "guardedref"})
    assert out["fitness"] == 1.0
    assert raw["fitness"]["main"] < 1.0
    assert len(svcs["port"].engine._model_memo) == 2
    assert len(svcs["ref"].engine._model_memo) == 2


# ---------------------------------------------------------------------------
# the live append endpoint (test_delta_query.py)
# ---------------------------------------------------------------------------


def _append_request(log, n, seed):
    rng = np.random.default_rng(seed)
    t_last = float(log.time[-1])
    return {
        "log": "live",
        "activity": rng.integers(0, log.num_activities, n).tolist(),
        "case": rng.integers(0, log.num_traces, n).tolist(),
        "time": np.sort(t_last + rng.uniform(0, 10, n)).tolist(),
    }


def test_service_append_endpoint(log_copies):
    svcs = _services(memory_budget_events=0)
    _register(svcs, "live", log_copies)
    out1 = _query(svcs, {"log": "live", "sink": "dfg"})
    assert not out1["from_cache"]
    req = _append_request(log_copies["port"], 40, 11)
    acks = {w: svc.append(dict(req)) for w, svc in svcs.items()}
    assert acks["port"] == acks["ref"]
    assert acks["port"]["appended"] == 40
    assert acks["port"]["num_events"] == log_copies["port"].num_events + 40

    engines = {w: svc.engine for w, svc in svcs.items()}
    base = {w: e.stats.rows_scanned for w, e in engines.items()}
    out2 = _query(svcs, {"log": "live", "sink": "dfg"})
    for w, e in engines.items():
        assert e.stats.delta_hits == 1  # warm: suffix-only scan
        assert e.stats.rows_scanned - base[w] == 40
    grown = port_core.MemmapLog.open(log_copies["port"].path)
    np.testing.assert_array_equal(
        np.asarray(out2["psi"]), port_core.streaming_dfg(grown)
    )
    assert out2["backend"] == "delta"
    out3 = svcs["port"].query({"log": "live", "sink": "dfg"})
    assert out3["from_cache"] and 0.0 < out3["wall_s"]


def test_service_append_rejects_repository():
    repo = _pair(port_data.generate_repository(
        50, port_data.ProcessSpec(num_activities=4, seed=12)
    ))
    svcs = _services()
    _register(svcs, "mem", repo)
    _raises(svcs, {"log": "mem", "activity": [0], "case": [0], "time": [0.0]},
            port_query.QueryPlanError, ref_query.QueryPlanError,
            method="append")
    _raises(svcs, {"log": "ghost", "activity": [0], "case": [0],
                   "time": [0.0]}, KeyError, KeyError, method="append")


def test_service_append_rejects_misaligned_columns(log_copies):
    svcs = _services(memory_budget_events=0)
    _register(svcs, "live", log_copies)
    _raises(svcs, {"log": "live", "activity": [0, 1], "case": [0],
                   "time": [0.0]}, ValueError, ValueError, method="append")


def test_service_concurrent_appends_are_serialized(log_copies):
    """Parallel appends to one registered log must not interleave column
    writes or lose batches (every thread joins inside the test)."""
    log = log_copies["port"]
    svc = port_serve.QueryService(
        port_query.QueryEngine(device="cpu", memory_budget_events=0)
    )
    svc.register("live", log)
    t_const = float(log.time[-1]) + 100.0  # equal times: any order valid
    errors = []

    def worker(i):
        try:
            svc.append({
                "log": "live",
                "activity": [i % log.num_activities] * 50,
                "case": [i % log.num_traces] * 50,
                "time": [t_const] * 50,
            })
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    final = port_core.MemmapLog.open(log.path)
    assert final.num_events == log.num_events + 8 * 50  # nothing lost
    hist = svc.query({"log": "live", "sink": "histogram"})
    assert sum(hist["counts"]) == final.num_events  # columns stayed aligned


def test_service_sharded_append_rescans_only_the_owning_shard(tmp_path):
    """A registered ShardedLog routes an appended batch to its owning shard:
    the next sharded-graph DFG rescans that shard's suffix only, serves the
    other shards from the cache, and equals the reference's answer."""
    log = port_data.generate_memmap_log(
        str(tmp_path / "log"), 8_000,
        port_data.ProcessSpec(num_activities=10, seed=13, horizon_days=60),
        seed=13,
    )
    sharded = {
        "port": port_graph.partition_memmap_log(log, 4,
                                                str(tmp_path / "port_k4")),
        "ref": ref_graph.partition_memmap_log(
            ref_core.MemmapLog.open(log.path), 4, str(tmp_path / "ref_k4")
        ),
    }
    svcs = _services(sharded_crossover=1)
    _register(svcs, "live", sharded)
    cold = _query(svcs, {"log": "live", "sink": "dfg"})
    assert cold["backend"] == "sharded-graph" and not cold["from_cache"]
    t_max = float(log.time[-1])
    batch = 5
    req = {
        "log": "live",
        "activity": (np.arange(batch) % 10).tolist(),
        "case": [6] * batch,  # one owning shard: 6 % 4 == 2
        "time": (t_max + 1.0 + np.arange(batch)).tolist(),
    }
    acks = {w: svc.append(dict(req)) for w, svc in svcs.items()}
    assert acks["port"] == acks["ref"]
    assert acks["port"]["num_events"] == log.num_events + batch
    eng = svcs["port"].engine
    before = eng.stats.rows_scanned
    warm = _query(svcs, {"log": "live", "sink": "dfg", "trace": True})
    assert not warm["from_cache"]
    assert eng.stats.rows_scanned - before == batch
    grown = svcs["port"]._logs["live"]
    oracle = port_query.Q.log(grown).using(
        port_query.QueryEngine(device="cpu")
    ).dfg()
    np.testing.assert_array_equal(np.asarray(warm["psi"]), oracle.value)
    res = port_query.Q.log(grown).using(eng).dfg()
    assert res.from_cache
    hits = {n: t.from_cache for n, t in
            port_query.Q.log(grown).using(port_query.QueryEngine(
                device="cpu", sharded_crossover=1)).dfg().trace.branches}
    assert set(hits) == {f"shard{k}" for k in range(4)}


# ---------------------------------------------------------------------------
# topology sinks and the floor (test_graph_store.py)
# ---------------------------------------------------------------------------


def test_service_process_map_floor():
    repo = _from_traces(
        [["a", "b"]] * 5 + [["a", "c"]],  # a→b ×5, a→c ×1
        activity_vocab=["a", "b", "c"],
    )
    svcs = _services()
    _register(svcs, "bpi", repo, lambda c: c.AccessPolicy(min_group_count=3))
    out = _query(svcs, {"log": "bpi", "sink": "process_map", "top": 1.0})
    assert ["a", "b", 5] in out["edges"]
    assert all(e[2] >= 3 for e in out["edges"])
    assert "c" not in out["activities"]
    assert out["dropped_edges"] >= 1
    assert out["sink"] == "process_map" and out["log"] == "bpi"
    nb = _query(svcs, {"log": "bpi", "sink": "neighborhood", "activity": "a",
                       "k": 1})
    assert nb["edges"] == [["a", "b", 5]]
    assert nb["activities"] == ["a", "b"]  # c dropped with its only edge
    # the third topology miss crosses the repeat crossover: the graph tier
    third = _query(svcs, {"log": "bpi", "sink": "neighborhood",
                          "activity": "b", "k": 2, "direction": "both"})
    assert third["backend"] == "graph"


def test_service_neighborhood_requires_activity():
    svcs = _services()
    _register(svcs, "bpi", {"port": port_core.paper_example_repo(),
                            "ref": ref_core.paper_example_repo()})
    _raises(svcs, {"log": "bpi", "sink": "neighborhood"}, KeyError, KeyError)


# ---------------------------------------------------------------------------
# multi-log requests and the cross-union policy guards
# (test_multilog_query.py)
# ---------------------------------------------------------------------------


def test_service_union_and_compare(repo_a, repo_b):
    svcs = _services()
    _register(svcs, "prod", repo_a)
    _register(svcs, "canary", repo_b)
    oracle = port_core.concat_repositories(
        [("canary", repo_b["port"]), ("prod", repo_a["port"])]
    )
    out = _query(svcs, {"logs": ["canary", "prod"], "sink": "dfg"})
    np.testing.assert_array_equal(np.asarray(out["psi"]), _oracle_dfg(oracle))
    assert out["logs"] == ["canary", "prod"] and out["backend"] == "union"
    assert _query(svcs, {"logs": ["canary", "prod"], "sink": "dfg"})[
        "from_cache"]

    cmp_out = _query(svcs, {"logs": ["prod", "canary"], "sink": "compare"})
    assert set(cmp_out["psi"]) == {"prod", "canary"}
    np.testing.assert_array_equal(
        np.asarray(cmp_out["diff"]["canary"]),
        np.asarray(cmp_out["psi"]["canary"])
        - np.asarray(cmp_out["psi"]["prod"]),
    )
    assert set(cmp_out["fitness"]) == {"prod", "canary"}
    _query(svcs, {"logs": ["prod", "canary"], "sink": "histogram",
                  "window": [0.0, 20 * DAY]})
    _query(svcs, {"logs": ["prod", "canary"], "sink": "variants", "k": 3})
    _query(svcs, {"logs": ["prod", "canary"], "sink": "alignments"})

    _raises(svcs, {"logs": ["prod", "ghost"], "sink": "dfg"},
            KeyError, KeyError)
    # naming the same log twice would double-count its events
    _raises(svcs, {"logs": ["prod", "prod"], "sink": "dfg"},
            port_query.QueryPlanError, ref_query.QueryPlanError)


def test_service_union_policy_guards(repo_a, repo_b):
    names = repo_a["port"].activity_names
    view = lambda c: c.AccessPolicy(  # noqa: E731
        view=c.ActivityView({n: "g" for n in names[:4]}))
    svcs = _services()
    _register(svcs, "open", repo_a)
    _register(svcs, "veiled", repo_b, view)
    _register(svcs, "veiled2", repo_a, view)
    _register(svcs, "other_view", repo_a, lambda c: c.AccessPolicy(
        view=c.ActivityView({"act_000": "x"})))
    _register(svcs, "nodice", repo_a,
              lambda c: c.AccessPolicy(time_windows_allowed=False))
    _register(svcs, "floored", repo_a,
              lambda c: c.AccessPolicy(min_group_count=10**9))

    # a view-protected log cannot be unioned with an unprotected one ...
    _denied(svcs, {"logs": ["open", "veiled"], "sink": "compare"})
    # ... nor with a log under a different view
    _denied(svcs, {"logs": ["veiled", "other_view"], "sink": "compare"})
    # identical views combine, and the result lives in group space
    out = _query(svcs, {"logs": ["veiled", "veiled2"], "sink": "compare"})
    assert out["names"] == ["g"]
    # time dicing must be allowed by every member
    _denied(svcs, {"logs": ["open", "nodice"], "sink": "dfg",
                   "window": [0.0, 1.0]})
    # the k-anonymity floor is the max across the union
    out = _query(svcs, {"logs": ["open", "floored"], "sink": "dfg"})
    assert not np.asarray(out["psi"]).any()
    out = _query(svcs, {"logs": ["open", "floored"], "sink": "compare"})
    assert not any(np.asarray(p).any() for p in out["psi"].values())
    # raw-activity filters stay denied under a view, union or not
    _denied(svcs, {"logs": ["veiled", "veiled2"], "sink": "dfg",
                   "activities": [repo_b["port"].activity_names[0]]})
    # the introspection floor joins the named logs' combined floor
    slo = _query(svcs, {"logs": ["open", "floored"], "sink": "slo"})
    assert slo["floor"] == 10**9


# ---------------------------------------------------------------------------
# probe / RequestProbe
# ---------------------------------------------------------------------------


PROBES = [
    {"log": "main", "sink": "dfg"},
    {"log": "main", "sink": "dfg", "window": [0.0, 30 * DAY]},
    {"log": "main", "sink": "histogram", "trace": True},
    {"log": "main", "sink": "variants", "k": 3},
    {"log": "main", "sink": "process_map", "top": 0.5},
    {"log": "main", "sink": "neighborhood", "activity": "act_002", "k": 2},
    {"log": "main", "sink": "fitness", "model_of": "disk"},
    {"log": "main", "sink": "alignments"},
    {"log": "disk", "sink": "dfg", "activities": ["act_001", "act_003"]},
    {"logs": ["main", "disk"], "sink": "compare"},
    {"sink": "metrics", "format": "prometheus"},
    {"sink": "forensics", "log": "main"},
]


def _probe_fields(p):
    d = {k: getattr(p, k) for k in (
        "sink", "names", "fingerprint", "policy_token", "plan_token",
        "backend", "cached", "delta_hint", "estimated_cost_s",
        "coalescable",
    )}
    return d


@pytest.mark.parametrize("request_", PROBES, ids=lambda r: json.dumps(r))
def test_probe_matches_the_reference_and_predicts_the_run(repo, mmlog,
                                                          request_):
    """``probe`` resolves the request as ``query`` would — same tokens,
    fingerprint, backend and cache prediction as the reference's — and
    mutates nothing: the request that follows runs on the predicted backend
    and hits the cache exactly when predicted."""
    svcs = _services()
    _register(svcs, "main", repo, lambda c: c.AccessPolicy(min_group_count=2))
    _register(svcs, "disk", mmlog)
    for _ in range(2):  # cold, then warm
        probes = {w: svc.probe(dict(request_)) for w, svc in svcs.items()}
        p, r = _probe_fields(probes["port"]), _probe_fields(probes["ref"])
        r["backend"] = port_backend(r["backend"])
        assert p == r
        assert probes["port"].group_key == (
            p["policy_token"], p["plan_token"], p["fingerprint"])
        stats0 = svcs["port"].engine.stats
        assert svcs["port"].probe(dict(request_)) == probes["port"]
        assert svcs["port"].engine.stats == stats0  # a probe runs nothing
        if p["backend"] == "introspect":
            # point-in-time snapshots: latency histograms differ run to run
            for svc in svcs.values():
                svc.query(dict(request_))
            continue
        out = _query(svcs, request_)
        if "model_of" not in request_:
            # a probe keys a model_of request without the resolved model
            # (its plan token names the other log), so only the plain
            # requests' cache prediction is the query's
            assert out["from_cache"] == p["cached"]
        if not out["from_cache"]:
            assert out["backend"] == p["backend"]


def test_probe_sees_an_append_as_a_delta_hint(log_copies):
    svcs = _services(memory_budget_events=0)
    _register(svcs, "live", log_copies)
    _query(svcs, {"log": "live", "sink": "dfg"})
    before = svcs["port"].probe({"log": "live", "sink": "dfg"})
    assert before.cached and before.backend == "streaming"
    req = _append_request(log_copies["port"], 30, 5)
    for svc in svcs.values():
        svc.append(dict(req))
    after = {w: svc.probe({"log": "live", "sink": "dfg"})
             for w, svc in svcs.items()}
    assert _probe_fields(after["port"]) == _probe_fields(after["ref"])
    assert not after["port"].cached and after["port"].delta_hint
    assert after["port"].fingerprint != before.fingerprint
    assert after["port"].group_key != before.group_key


def test_probe_raises_what_query_raises(repo):
    svcs = _services()
    _register(svcs, "locked", repo,
              lambda c: c.AccessPolicy(time_windows_allowed=False))
    _raises(svcs, {"log": "locked", "sink": "dfg", "window": [0.0, 1.0]},
            port_core.views.AccessDenied, ref_core.views.AccessDenied,
            method="probe")
    _raises(svcs, {"log": "ghost"}, KeyError, KeyError, method="probe")
    _raises(svcs, {"log": "locked", "sink": "nope"},
            port_query.QueryPlanError, ref_query.QueryPlanError,
            method="probe")


def test_engine_probe_and_plan_probe(repo):
    eng = port_query.QueryEngine(device="cpu")
    q = port_query.Q.log(repo["port"]).using(eng)
    cold = eng.probe(q, port_query.DFGSink())
    assert isinstance(cold, port_query.PlanProbe)
    assert not cold.cached and not cold.delta_hint
    res = q.dfg()
    warm = eng.probe(q)
    assert warm.cached and warm.plan_key == res.logical.key()
    assert warm.fingerprint == port_query.fingerprint(repo["port"])
    assert eng.stats.queries == 1


# ---------------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------------


def _non_numeric(text):
    return [line for line in text.splitlines()
            if not line.startswith(("cost    :", "spans   :"))]


def test_explain_lines_match_the_reference(repo, repo_b, mmlog):
    """explain()'s non-numeric lines — the logical plan, rewrites, physical
    plan, plan key and the recorded-trace verdict — for a memmap dice, a
    union and a conformance sink, before and after the run."""
    engines = {"port": port_query.QueryEngine(device="cpu"),
               "ref": ref_engine()}
    chains = [
        lambda Q, w: Q.log(mmlog[w]).window(0.0, 30 * DAY),
        lambda Q, w: Q.logs((repo[w], "a"), (repo_b[w], "b"))
        .activities(["act_001", "act_002", "act_003"]),
        lambda Q, w: Q.log(repo[w]).top_variants(4),
    ]
    sinks = ("dfg", "dfg", "fitness")
    for chain, sink in zip(chains, sinks):
        lines = {}
        for w, eng in engines.items():
            Q = port_query.Q if w == "port" else ref_query.Q
            q = chain(Q, w).using(eng)
            before = q.explain()
            res = getattr(q, sink)()
            sink_obj = res.logical.sink
            after = q.explain(sink_obj, after=res)
            lines[w] = (_non_numeric(before), _non_numeric(after))
        ref_lines = tuple(
            [line.replace("pallas", "kernel") for line in part]
            for part in lines["ref"]
        )
        assert lines["port"] == ref_lines
        assert "matched prediction" in "\n".join(lines["port"][1]) or \
            "executed: cache" in "\n".join(lines["port"][1])


# ---------------------------------------------------------------------------
# calibration: the port's own records only
# ---------------------------------------------------------------------------


def _static():
    return {
        "tiny_pairs": port_planner.TINY_PAIRS,
        "memory_budget_events": port_planner.MEMORY_BUDGET_EVENTS,
        "graph_repeat_crossover": port_planner.GRAPH_REPEAT_CROSSOVER,
        "replay_streaming_crossover": port_planner.REPLAY_STREAMING_CROSSOVER,
        "sharded_single_crossover": port_planner.SHARDED_SINGLE_CROSSOVER,
        "slo_hot_cutoff_s": port_planner.SLO_HOT_CUTOFF_S,
        "curves": {},
    }


def test_static_constants_are_the_references():
    for key in ("TINY_PAIRS", "MEMORY_BUDGET_EVENTS", "GRAPH_REPEAT_CROSSOVER",
                "REPLAY_STREAMING_CROSSOVER", "SHARDED_SINGLE_CROSSOVER",
                "SLO_HOT_CUTOFF_S"):
        assert getattr(port_planner, key) == getattr(ref_planner, key), key


def test_default_calibration_ignores_the_reference_records():
    """The repository root holds the reference's ``BENCH_*.json`` records
    (measured on other hardware): the reference reads them, the port does
    not — ``load_calibration()`` and a default CPU engine keep the static
    constants."""
    assert os.path.isfile(os.path.join(ROOT, "BENCH_graph.json"))
    ref = ref_planner.load_calibration()
    assert ref != {**_static(), "curves": ref["curves"]} or ref["curves"]
    assert port_query.load_calibration() == _static()
    eng = port_query.QueryEngine(device="cpu")
    assert (eng.tiny_pairs, eng.memory_budget_events, eng.graph_crossover,
            eng.replay_crossover, eng.sharded_crossover,
            eng.calibration_curves) == (
        port_planner.TINY_PAIRS, port_planner.MEMORY_BUDGET_EVENTS,
        port_planner.GRAPH_REPEAT_CROSSOVER,
        port_planner.REPLAY_STREAMING_CROSSOVER,
        port_planner.SHARDED_SINGLE_CROSSOVER, {},
    )


def test_calibration_loaded_and_clamped(tmp_path):
    """Query record: read, clamped to the reference's rails, corrupt →
    static (test_multilog_query.py's case), on both packages."""
    missing = str(tmp_path / "nope.json")
    others = dict(graph_path=missing, conformance_path=missing,
                  shard_path=missing, serve_path=missing)
    for which, load in (("port", port_query.load_calibration),
                        ("ref", ref_planner.load_calibration)):
        assert load(missing, **others) == _static(), which
    bench = tmp_path / "BENCH_torch_query.json"
    cases = [
        ('{"calibration": {"tiny_pairs": 512, '
         '"memory_budget_events": 2097152}}', (512, 2097152)),
        ('{"calibration": {"tiny_pairs": 1000000000, '
         '"memory_budget_events": 1}}', (4096, 1 << 20)),
        ("{not json", (port_planner.TINY_PAIRS,
                       port_planner.MEMORY_BUDGET_EVENTS)),
    ]
    for text, want in cases:
        bench.write_text(text)
        got = {which: load(str(bench), **others) for which, load in (
            ("port", port_query.load_calibration),
            ("ref", ref_planner.load_calibration))}
        assert got["port"] == got["ref"]
        assert (got["port"]["tiny_pairs"],
                got["port"]["memory_budget_events"]) == want


def test_graph_calibration_loaded_and_clamped(tmp_path):
    missing = str(tmp_path / "nope.json")
    bench = tmp_path / "BENCH_torch_graph.json"
    for text, want in (
        ('{"calibration": {"graph_repeat_crossover": 7}}', 7),
        ('{"calibration": {"graph_repeat_crossover": 100000}}', 64),
        ("{not json", port_planner.GRAPH_REPEAT_CROSSOVER),
    ):
        bench.write_text(text)
        port = port_query.load_calibration(missing, graph_path=str(bench))
        ref = ref_planner.load_calibration(missing, graph_path=str(bench))
        assert port["graph_repeat_crossover"] == \
            ref["graph_repeat_crossover"] == want


def test_replay_and_sharded_and_serve_calibration(tmp_path):
    bench = tmp_path / "rec.json"
    for key, arg, value, want in (
        ("replay_streaming_crossover", "conformance_path", 999, 1 << 18),
        ("replay_streaming_crossover", "conformance_path", 1048576, 1 << 20),
        ("sharded_single_crossover", "shard_path", 3, 1 << 14),
        ("sharded_single_crossover", "shard_path", 70000, 70000),
        ("slo_hot_cutoff_s", "serve_path", 0.02, 0.02),
        ("slo_hot_cutoff_s", "serve_path", 99.0, 2.0),
    ):
        bench.write_text(json.dumps({"calibration": {key: value}}))
        port = port_query.load_calibration(**{arg: str(bench)})[key]
        ref = ref_planner.load_calibration(**{arg: str(bench)})[key]
        assert port == ref == want, (key, value)
    missing = str(tmp_path / "nope" / "BENCH_torch_serve.json")
    assert port_query.load_calibration(serve_path=missing)[
        "slo_hot_cutoff_s"] == port_planner.SLO_HOT_CUTOFF_S


def test_crossover_curves_and_resolve_threshold(tmp_path):
    """A record's curve for its own key becomes a clamp-railed
    ``CrossoverCurve`` (a malformed list is dropped whole, another record's
    key is ignored), and ``resolve_threshold`` reads it as the reference's
    does."""
    bench = tmp_path / "BENCH_torch_shard.json"
    bench.write_text(json.dumps({"calibration": {"curves": {
        "sharded_single_crossover": [[1e6, 20000], ["x", 1]],
        "tiny_pairs": [[1, 300]],
    }}}))
    port = port_query.load_calibration(shard_path=str(bench))
    ref = ref_planner.load_calibration(shard_path=str(bench))
    assert port["curves"] == {}
    assert "sharded_single_crossover" not in ref["curves"]
    bench.write_text(json.dumps({"calibration": {
        "sharded_single_crossover": 50000,
        "curves": {"sharded_single_crossover": [[1e6, 20000], [1e8, 3e7],
                                                [5e7, 90000]]},
    }}))
    port = port_query.load_calibration(shard_path=str(bench))
    ref = ref_planner.load_calibration(shard_path=str(bench))
    pc = port["curves"]["sharded_single_crossover"]
    rc = ref["curves"]["sharded_single_crossover"]
    assert isinstance(pc, port_planner.CrossoverCurve)
    assert (pc.key, pc.xs, pc.ys) == (rc.key, rc.xs, rc.ys)
    assert pc.ys[-1] == 1 << 24  # clamped like the scalar
    for work in (0.0, 1e6, 3e6, 5e7, 7.5e7, 1e9):
        assert pc.value_at(work) == rc.value_at(work)
        assert port_planner.resolve_threshold(
            port, "sharded_single_crossover", work
        ) == ref_planner.resolve_threshold(
            ref, "sharded_single_crossover", work
        )
    assert port_planner.resolve_threshold(port, "tiny_pairs", 1.0) == \
        port_planner.TINY_PAIRS


def test_engine_picks_up_a_record(tmp_path):
    bench = tmp_path / "BENCH_torch_query.json"
    bench.write_text('{"calibration": {"tiny_pairs": 777, '
                     '"memory_budget_events": 3000000}}')
    eng = port_query.QueryEngine(device="cpu", calibration_path=str(bench))
    assert eng.tiny_pairs == 777
    assert eng.memory_budget_events == 3000000  # a record before the host's
    # explicit arguments always win over the calibration record
    eng = port_query.QueryEngine(device="cpu", calibration_path=str(bench),
                                 tiny_pairs=9, memory_budget_events=5)
    assert (eng.tiny_pairs, eng.memory_budget_events) == (9, 5)
    eng = port_query.QueryEngine(device="cpu", replay_crossover=123)
    assert eng.replay_crossover == 123


def test_engine_plans_with_a_records_curve(tmp_path):
    """A ``tiny_pairs`` curve in the query record moves the plan the way
    the reference's does: 3,232 pairs count on the device backend under
    the static 2,048 and on numpy under the curve's 4,096."""
    repo = _pair(port_data.generate_repository(
        250, port_data.ProcessSpec(num_activities=11, seed=9)
    ))
    assert 2048 < repo["port"].df_pairs()[0].shape[0] <= 4096
    plain = port_query.Q.log(repo["port"]).using(
        port_query.QueryEngine(device="cpu")).dfg()
    assert plain.physical.backend == "scatter"
    bench = tmp_path / "BENCH_torch_query.json"
    n = repo["port"].num_events * repo["port"].num_activities
    bench.write_text(json.dumps({"calibration": {"curves": {
        "tiny_pairs": [[0, 4096], [10 * n, 4096]]}}}))
    port = port_query.QueryEngine(device="cpu", calibration_path=str(bench))
    ref = ref_query.QueryEngine(calibration_path=str(bench),
                                graph_crossover=3)
    assert port.tiny_pairs == port_planner.TINY_PAIRS  # the scalar stays
    pr = port_query.Q.log(repo["port"]).using(port).dfg()
    rr = ref_query.Q.log(repo["ref"]).using(ref).dfg()
    assert pr.physical.backend == port_backend(rr.physical.backend) == "numpy"
    np.testing.assert_array_equal(pr.value, rr.value)


ENV_RUN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import repro.query.planner as ref_planner
import repro_torch.query as port_query
eng = port_query.QueryEngine(device="cpu")
print(json.dumps({
    "port": port_query.load_calibration()["graph_repeat_crossover"],
    "engine": eng.graph_crossover,
    "ref": ref_planner.load_calibration()["graph_repeat_crossover"],
}))
"""


def test_calibration_env_vars_name_the_port_records(tmp_path):
    """``$GRAPHPM_TORCH_BENCH_GRAPH`` moves the port's crossover; the
    reference's ``$GRAPHPM_BENCH_GRAPH`` does not.  Run in a child process
    with its own environment, so this process's stays untouched."""
    port_rec = tmp_path / "port.json"
    port_rec.write_text('{"calibration": {"graph_repeat_crossover": 9}}')
    ref_rec = tmp_path / "ref.json"
    ref_rec.write_text('{"calibration": {"graph_repeat_crossover": 11}}')
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("GRAPHPM_")}
    env.update(GRAPHPM_TORCH_BENCH_GRAPH=str(port_rec),
               GRAPHPM_BENCH_GRAPH=str(ref_rec), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", ENV_RUN, os.path.join(ROOT, "src")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"port": 9, "engine": 9, "ref": 11}


def test_cost_priors(repo):
    """Host backends keep the reference's priors; the card's backends carry
    the port's own (a kernel prior the reference's ``pallas`` has not)."""
    for backend in ("numpy", "scatter", "onehot", "streaming", "delta",
                    "graph", "concat", "no-such-backend"):
        for n in (0, 1000, 7_200_010):
            assert port_planner.estimate_cost_s(backend, n) == \
                ref_planner.estimate_cost_s(backend, n)
    for backend in ("kernel", "distributed", "sharded-graph"):
        assert port_planner.estimate_cost_s(backend, 7_200_010) > 1.0
    assert port_planner.estimate_cost_s("kernel", 7_200_010) == \
        pytest.approx(1.4118, abs=1e-3)


# ---------------------------------------------------------------------------
# the default engine is the card's
# ---------------------------------------------------------------------------


def test_default_service_engine_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.QueryService()
    eng = port_query.QueryEngine(device="cpu")
    assert port_serve.QueryService(eng).engine is eng


# ---------------------------------------------------------------------------
# the engine options the service relies on, against the reference's
# ---------------------------------------------------------------------------


def test_fused_dicing_option(repo):
    """``fused_dicing=False`` keeps the window out of the count kernel: the
    plan says so, the plain count runs on the masked pairs, and Ψ is the
    reference's with the same option."""
    w = (0.0, 30 * DAY)
    for fused in (True, False):
        port = port_query.QueryEngine(device="cpu", fused_dicing=fused)
        ref = ref_engine(fused_dicing=fused)
        pr = port_query.Q.log(repo["port"]).using(port).window(*w).dfg(
            backend="kernel")
        rr = ref_query.Q.log(repo["ref"]).using(ref).window(*w).dfg(
            backend="pallas")
        assert pr.physical.fused_dicing == rr.physical.fused_dicing == fused
        assert pr.physical.describe() == rr.physical.describe().replace(
            "pallas", "kernel")
        np.testing.assert_array_equal(pr.value, rr.value)


def test_cache_and_metrics_options_share_state(repo):
    """Two engines handed one ``cache`` and one ``metrics`` registry serve
    each other's results and count into one registry, as the reference's
    do."""
    counts = {}
    for which in PACKAGES:
        q_mod = port_query if which == "port" else ref_query
        obs = port_obs if which == "port" else ref_obs
        cache, reg = q_mod.QueryCache(), obs.MetricsRegistry()
        kw = dict(cache=cache, metrics=reg)
        a = (port_query.QueryEngine(device="cpu", **kw) if which == "port"
             else ref_engine(**kw))
        b = (port_query.QueryEngine(device="cpu", **kw) if which == "port"
             else ref_engine(**kw))
        first = q_mod.Q.log(repo[which]).using(a).dfg()
        again = q_mod.Q.log(repo[which]).using(b).dfg()
        assert not first.from_cache and again.from_cache
        counts[which] = {k: v for k, v in reg.to_dict().items()
                         if k.startswith("engine_")}
    assert counts["port"] == counts["ref"]
    assert counts["port"]["engine_cache_hits_total"] == 1


def test_repo_memo_size_option(mmlog, tmp_path):
    """``repo_memo_size`` bounds the materialized repositories an engine
    keeps: with 1, two memmap logs queried in turn each materialize again,
    as in the reference."""
    other = port_data.generate_memmap_log(
        str(tmp_path / "other"), 5_000,
        port_data.ProcessSpec(num_activities=13, seed=32), seed=32,
    )
    logs = {"port": (mmlog["port"], other),
            "ref": (mmlog["ref"], ref_core.MemmapLog.open(other.path))}
    memo = {}
    for which in PACKAGES:
        q_mod = port_query if which == "port" else ref_query
        eng = (port_query.QueryEngine(device="cpu", repo_memo_size=1)
               if which == "port" else ref_engine(repo_memo_size=1))
        for log in logs[which] + logs[which][:1]:
            q_mod.Q.log(log).using(eng).dfg()
        memo[which] = (len(eng._repo_memo), eng.repo_memo_size,
                       eng.stats.rows_scanned)
    assert memo["port"] == memo["ref"]
    assert memo["port"][:2] == (1, 1)
