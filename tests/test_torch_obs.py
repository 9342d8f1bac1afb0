"""``repro_torch.obs`` against the reference's ``repro.obs`` on the CPU: the
metrics registry, per-query traces and ``NullTrace``, the engine's
observability options (``trace=``, ``telemetry_max_events=``,
``drift_ratio=``, ``metrics=``, ``trace_store=``), planner drift, explain,
self-mining forensics, the service's introspection sinks, the SLO engine
and the persisted trace store.

Every case of ``tests/test_obs.py`` is here, run on both packages with the
same seeded inputs; integer results, span vocabularies, plan text,
counters and SLO verdicts must agree with tolerance 0.  The drift cases
feed ``_check_drift`` fixed predicted and actual costs, so no verdict
depends on the wall clock.  The SLO and trace-store cases are those of
``tests/test_distributed_obs.py`` that need no transport tier.  Every file
a test writes lies under its ``tmp_path``; no test touches ``os.environ``
or leaves a thread running.
"""

import dataclasses
import json
import logging
import shutil
import threading

import numpy as np
import pytest

import repro.core as ref_core
import repro.data as ref_data
import repro.obs as ref_obs
import repro.obs.trace  # noqa: F401  (ref_obs.trace)
import repro.query as ref_query
import repro.serve.query_service as ref_serve
import repro_torch.core as port_core
import repro_torch.data as port_data
import repro_torch.obs as port_obs
import repro_torch.obs.context as port_context
import repro_torch.obs.trace  # noqa: F401  (port_obs.trace)
import repro_torch.query as port_query
import repro_torch.serve as port_serve
from repro.obs.metrics import BUCKET_BOUNDS as REF_BOUNDS
from repro_torch.obs.metrics import BUCKET_BOUNDS as PORT_BOUNDS
from torch_parity import port_backend, ref_engine

PACKAGES = ("port", "ref")


def _port_engine(**kw):
    return port_query.QueryEngine(device="cpu", **kw)


def _engine(which, **kw):
    return _port_engine(**kw) if which == "port" else ref_engine(**kw)


def _obs(which):
    return port_obs if which == "port" else ref_obs


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture()
def repos():
    """The same seeded repository from each package's generator."""
    port = port_data.generate_repository(
        300, port_data.ProcessSpec(num_activities=7, seed=3), seed=3
    )
    ref = ref_data.generate_repository(
        300, ref_data.ProcessSpec(num_activities=7, seed=3), seed=3
    )
    np.testing.assert_array_equal(port.event_activity, ref.event_activity)
    return {"port": port, "ref": ref}


@pytest.fixture()
def other_repos():
    port = port_data.generate_repository(
        200, port_data.ProcessSpec(num_activities=7, seed=4), seed=4
    )
    ref = ref_data.generate_repository(
        200, ref_data.ProcessSpec(num_activities=7, seed=4), seed=4
    )
    return {"port": port, "ref": ref}


@pytest.fixture(scope="module")
def base_log(tmp_path_factory):
    path = tmp_path_factory.mktemp("obs") / "base"
    return port_data.generate_memmap_log(
        str(path), 20_000, port_data.ProcessSpec(num_activities=8, seed=11),
        seed=11, batch_traces=300,
    )


@pytest.fixture()
def log_copies(base_log, tmp_path):
    """One on-disk copy of the seeded log per package."""
    out = {}
    for which, core in (("port", port_core), ("ref", ref_core)):
        path = str(tmp_path / f"log_{which}")
        shutil.copytree(base_log.path, path)
        out[which] = core.MemmapLog.open(path)
    return out


# ---------------------------------------------------------------------------
# metrics primitives
# ---------------------------------------------------------------------------


def test_histogram_percentiles_log_uniform():
    rng = np.random.default_rng(0)
    xs = 10.0 ** rng.uniform(-4, 0, 5000)  # 100 µs … 1 s, log-uniform
    snaps, ests = {}, {}
    for which in PACKAGES:
        h = _obs(which).MetricsRegistry().histogram("lat")
        for x in xs:
            h.observe(float(x))
        ests[which] = [h.percentile(q) for q in (50.0, 95.0, 99.0)]
        snaps[which] = h.snapshot()
    assert ests["port"] == ests["ref"] and snaps["port"] == snaps["ref"]
    for q, est in zip((50.0, 95.0, 99.0), ests["port"]):
        true = float(np.percentile(xs, q))
        # log-scale buckets: the estimate lands within one decade/4 step
        assert true / 2.5 <= est <= true * 2.5
    snap = snaps["port"]
    assert snap["count"] == 5000
    assert snap["min"] == pytest.approx(xs.min())
    assert snap["max"] == pytest.approx(xs.max())
    assert snap["sum"] == pytest.approx(xs.sum())
    assert snap["p50"] <= snap["p95"] <= snap["p99"] <= snap["max"]


def test_histogram_percentile_clamps_to_envelope():
    reg = port_obs.MetricsRegistry()
    h = reg.histogram("x")
    h.observe(0.013)
    h.observe(0.013)
    # everything in one bucket: interpolation must not escape [min, max]
    assert h.percentile(50.0) == pytest.approx(0.013)
    assert h.percentile(99.0) == pytest.approx(0.013)
    assert reg.histogram("empty").percentile(95.0) == 0.0


def test_counter_and_histogram_thread_safety():
    reg = port_obs.MetricsRegistry()
    c = reg.counter("hits")
    h = reg.histogram("lat")
    n, m = 8, 2000

    def work():
        for _ in range(m):
            c.inc()
            h.observe(1e-3)

    threads = [threading.Thread(target=work) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == n * m
    assert h.count == n * m
    assert h.sum == pytest.approx(n * m * 1e-3)


def test_counter_inc_returns_sequence():
    for which in PACKAGES:
        c = _obs(which).MetricsRegistry().counter("seq")
        assert [c.inc(), c.inc(), c.inc(5)] == [1, 2, 7]


def test_registry_get_or_create_and_labels():
    dicts = {}
    for which in PACKAGES:
        reg = _obs(which).MetricsRegistry()
        a = reg.counter("n", sink="dfg")
        b = reg.counter("n", sink="dfg")
        other = reg.counter("n", sink="histogram")
        assert a is b and a is not other
        a.inc(3)
        dicts[which] = reg.to_dict()
    assert dicts["port"] == dicts["ref"]
    assert dicts["port"]["n{sink=dfg}"] == 3
    assert dicts["port"]["n{sink=histogram}"] == 0


def test_to_dict_floor_zeroes_small_counts():
    dicts = {}
    for which in PACKAGES:
        reg = _obs(which).MetricsRegistry()
        reg.counter("small").inc(2)
        reg.counter("big").inc(100)
        reg.histogram("few").observe(0.5)
        dicts[which] = reg.to_dict(floor=5)
    d = dicts["port"]
    assert d == dicts["ref"]
    assert d["small"] == 0 and d["big"] == 100
    assert d["few"]["count"] == 0 and d["few"]["sum"] == 0.0


def test_prometheus_exposition_format():
    texts, regs = {}, {}
    for which in PACKAGES:
        reg = regs[which] = _obs(which).MetricsRegistry()
        reg.counter("engine_queries_total").inc(4)
        h = reg.histogram("query_latency_seconds", sink="dfg")
        h.observe(0.002)
        h.observe(0.004)
        reg.gauge("cache_ratio", lambda: 0.5)
        texts[which] = reg.to_prometheus()
    text = texts["port"]
    assert text == texts["ref"]
    assert "# TYPE engine_queries_total counter" in text
    assert "engine_queries_total 4" in text
    assert "# TYPE query_latency_seconds histogram" in text
    assert 'le="+Inf"} 2' in text
    assert 'query_latency_seconds_count{sink="dfg"} 2' in text
    assert 'query_latency_seconds_sum{sink="dfg"} 0.006' in text
    assert "# TYPE cache_ratio gauge" in text
    # cumulative bucket counts are monotone and end at the total
    cums = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith("query_latency_seconds_bucket")]
    assert cums == sorted(cums) and cums[-1] == 2
    both = port_obs.prometheus_text(regs["port"], port_obs.MetricsRegistry())
    assert both.startswith("# TYPE")
    assert both == ref_obs.prometheus_text(
        regs["ref"], ref_obs.MetricsRegistry()
    )


def test_json_lines_parse():
    lines = {}
    for which in PACKAGES:
        reg = _obs(which).MetricsRegistry()
        reg.counter("a", x="1").inc()
        reg.histogram("b").observe(0.1)
        lines[which] = reg.to_json_lines()
    assert lines["port"] == lines["ref"]
    recs = [json.loads(line) for line in lines["port"].splitlines()]
    by_name = {r["name"]: r for r in recs}
    assert by_name["a"]["type"] == "counter" and by_name["a"]["value"] == 1
    assert by_name["b"]["type"] == "histogram" and by_name["b"]["count"] == 1
    assert by_name["a"]["labels"] == {"x": "1"}


def test_bucket_bounds_cover_engine_range():
    assert PORT_BOUNDS == REF_BOUNDS
    assert PORT_BOUNDS[0] == pytest.approx(1e-6)
    assert PORT_BOUNDS[-1] == pytest.approx(100.0)
    assert all(b < c for b, c in zip(PORT_BOUNDS, PORT_BOUNDS[1:]))


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


def test_trace_slab_growth_and_spans():
    tr = port_obs.QueryTrace(1, "dfg", "repository")
    for i in range(40):  # forces several slab doublings
        s = tr.begin(f"s{i}")
        tr.end(s)
    tr.finish()
    assert [s.name for s in tr.spans] == [f"s{i}" for i in range(40)]
    assert all(s.duration_s >= 0.0 for s in tr.spans)
    assert 0.0 < tr.coverage() <= 1.0


def test_trace_finish_closes_orphaned_spans():
    tr = port_obs.QueryTrace(1, "dfg", "repository")
    tr.begin("never_ended")
    tr.finish()
    assert tr.spans[0].duration_s >= 0.0
    assert tr.to_dict()["spans"][0]["name"] == "never_ended"


@pytest.mark.parametrize("which", PACKAGES)
def test_null_trace_is_inert(which):
    trace_mod = port_obs.trace if which == "port" else ref_obs.trace
    tr = trace_mod.NullTrace(0, "dfg", "repository")
    assert tr.enabled is False
    assert trace_mod.QueryTrace.enabled is True
    assert tr.begin("x") == 0
    tr.end(0)
    assert tr.add_span("y", 0.0, 1.0) == 0
    tr.finish()
    assert tr.spans == []


def test_every_result_carries_a_trace(repos):
    trs = {}
    for which in PACKAGES:
        repo = repos[which]
        res = ref_query.Q.log(repo) if which == "ref" else \
            port_query.Q.log(repo)
        res = res.using(_engine(which)).dfg()
        tr = res.trace
        assert tr is not None and tr.enabled
        assert tr.executed_backend == tr.planned_backend
        assert tr.predicted_cost_s is not None
        assert tr.actual_cost_s is not None
        assert tr.rows_scanned == repo.num_events
        assert tr.total_s > 0 and res.wall_s > 0
        trs[which] = tr
    names = [s.name for s in trs["port"].spans]
    assert names == ["parse", "cache_probe", "plan", "scan", "sink"]
    assert names == [s.name for s in trs["ref"].spans]
    assert trs["port"].executed_backend == port_backend(
        trs["ref"].executed_backend
    )
    # the same backend on the same events gets the same cost prior
    assert trs["port"].predicted_cost_s == trs["ref"].predicted_cost_s
    assert trs["port"].sink == trs["ref"].sink == "dfg"
    assert trs["port"].source == trs["ref"].source == "repository"


def test_cache_hit_gets_its_own_trace(repos):
    engine = _port_engine()
    first = port_query.Q.log(repos["port"]).using(engine).dfg()
    hit = port_query.Q.log(repos["port"]).using(engine).dfg()
    assert hit.from_cache
    assert hit.trace is not first.trace
    assert hit.trace.executed_backend == "cache"
    assert hit.trace.from_cache
    assert hit.trace.planned_backend == first.physical.backend
    assert hit.trace.links["produced_by"] == first.trace.trace_id
    # hit latency is the hit's own (probe) time, not the original scan
    assert hit.wall_s == pytest.approx(hit.trace.total_s)
    assert [s.name for s in hit.trace.spans] == ["parse", "cache_probe"]


def test_trace_disabled_engine(repos):
    stats = {}
    for which in PACKAGES:
        engine = _engine(which, trace=False)
        q = ref_query.Q if which == "ref" else port_query.Q
        res = q.log(repos[which]).using(engine).dfg()
        assert res.trace is None
        assert len(engine.telemetry) == 0
        # counters still work without tracing
        stats[which] = (engine.stats.queries, engine.stats.executions)
        assert "query_latency_seconds" not in " ".join(
            engine.metrics_snapshot()
        )
    assert stats["port"] == stats["ref"] == (1, 1)


def test_delta_trace_and_metrics(log_copies):
    out = {}
    for which in PACKAGES:
        log = log_copies[which]
        engine = _engine(which, memory_budget_events=0)  # streaming-first
        q = ref_query.Q if which == "ref" else port_query.Q
        q.log(log).using(engine).dfg()
        rng = np.random.default_rng(7)
        n = 200
        act = rng.integers(0, log.num_activities, n).astype(np.int32)
        case = rng.integers(0, log.num_traces, n).astype(np.int32)
        times = float(log.time[-1]) + np.sort(rng.uniform(0.0, 50.0, n))
        grown = log.append(act, case, times)
        res = q.log(grown).using(engine).dfg()
        tr = res.trace
        assert tr.executed_backend == tr.planned_backend == "delta"
        start, hi = tr.delta_rows
        assert hi - start == n and tr.rows_scanned == n
        assert "delta" in [s.name for s in tr.spans]
        snap = engine.metrics_snapshot()
        frac = snap["delta_suffix_fraction"]
        assert snap["engine_delta_hits_total"] == 1 and frac["count"] == 1
        assert 0.0 < frac["max"] < 0.5
        out[which] = (tr.delta_rows, tr.predicted_cost_s,
                      [s.name for s in tr.spans], frac["max"],
                      res.value.tolist())
    assert out["port"] == out["ref"]


def test_union_trace_has_branches(repos, other_repos):
    got = {}
    for which in PACKAGES:
        engine = _engine(which)
        q = ref_query.Q if which == "ref" else port_query.Q
        res = q.logs((repos[which], "a"), (other_repos[which], "b")) \
            .using(engine).dfg()
        tr = res.trace
        assert tr is not None
        for _, sub in tr.branches:
            assert sub.executed_backend is not None
            assert sub.trace_id == tr.trace_id
        got[which] = (
            [n for n, _ in tr.branches],
            [s.name for s in tr.spans],
            engine.stats.union_queries,
            [port_backend(sub.executed_backend) for _, sub in tr.branches],
        )
    assert got["port"] == got["ref"]
    assert got["port"][0] == ["a", "b"] and "merge" in got["port"][1]
    assert got["port"][2] == 1


def test_engine_stats_is_a_consistent_snapshot(repos):
    engine = _port_engine()
    n = 6

    def work():
        for _ in range(20):
            port_query.Q.log(repos["port"]).using(engine).dfg()

    threads = [threading.Thread(target=work) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = engine.stats
    assert st.queries == n * 20
    assert st.executions + st.cache_hits == st.queries
    assert st.executions >= 1


def _non_numeric(text):
    """explain()'s lines that hold no measured number (cost and span times
    are the wall clock's; the backend names map ``pallas`` → ``kernel``)."""
    return [
        line for line in text.splitlines()
        if not line.startswith(("cost    :", "spans   :"))
    ]


def test_explain_after_diffs_prediction(repos):
    texts = {}
    for which in PACKAGES:
        engine = _engine(which)
        q = ref_query.Q if which == "ref" else port_query.Q
        res = q.log(repos[which]).using(engine).dfg()
        txt = q.log(repos[which]).using(engine).explain(after=res)
        assert "-- after: recorded trace --" in txt
        assert "executed: " in txt and "matched prediction" in txt
        assert "coverage" in txt and "scanned" in txt
        off = _engine(which, trace=False)
        res_off = q.log(repos[which]).using(off).dfg()
        no_trace = q.log(repos[which]).using(off).explain(after=res_off)
        assert "none recorded" in no_trace
        texts[which] = (_non_numeric(txt), no_trace)
    assert texts["port"] == texts["ref"]


def test_explain_names_a_windowed_plan(repos):
    """A windowed, filtered, viewed chain: the same logical description,
    rewrites, physical plan and plan key as the reference's."""
    texts = {}
    for which in PACKAGES:
        repo = repos[which]
        names = list(repo.activity_names)
        core = port_core if which == "port" else ref_core
        q = (ref_query.Q if which == "ref" else port_query.Q).log(repo)
        q = q.using(_engine(which, tiny_pairs=8)).window(0.0, 20 * 86400.0)
        q = q.window(-1.0, 10 * 86400.0).activities(names[:5])
        q = q.view(core.ActivityView({a: "g" for a in names[:3]}))
        texts[which] = q.explain()
    assert texts["port"] == texts["ref"]
    assert "logical : repository → Window" in texts["port"]


def _fixed_trace(obs, predicted, actual):
    tr = obs.QueryTrace(7, "dfg", "repository")
    tr.planned_backend = tr.executed_backend = "numpy"
    tr.predicted_cost_s = predicted
    tr.actual_cost_s = actual
    tr.rows_scanned = 123
    return tr


@pytest.mark.parametrize(
    "predicted,actual",
    [(0.01, 0.5), (0.4, 0.01), (1.0, 16.0), (2.0, 0.125)],
    ids=["slow", "fast", "at_upper_band", "at_lower_band"],
)
def test_drift_detection_fires_counter_and_warning(predicted, actual, caplog):
    """Fixed costs outside (or on the edge of) the default 16× band count
    as drift with the reference's ratio, counter and warning payload."""
    out = {}
    for which, logger in (("port", "repro_torch.obs"), ("ref", "repro.obs")):
        engine = _engine(which)
        tr = _fixed_trace(_obs(which), predicted, actual)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            engine._check_drift(tr)
        msgs = [r.message for r in caplog.records
                if "planner_cost_drift" in r.message]
        assert len(msgs) == 1
        snap = engine.metrics_snapshot()
        out[which] = (tr.drift, snap["planner_drift_total{backend=numpy}"],
                      json.loads(msgs[0].split(" ", 1)[1]))
    assert out["port"] == out["ref"]
    assert out["port"][0] == actual / predicted and out["port"][1] == 1


def test_drift_ratio_option_narrows_the_band():
    for which in PACKAGES:
        engine = _engine(which, drift_ratio=1.5)
        tr = _fixed_trace(_obs(which), 0.1, 0.2)
        engine._check_drift(tr)
        assert tr.drift == 2.0


@pytest.mark.parametrize(
    "predicted,actual",
    [(0.01, 0.15), (0.2, 0.02), (None, 0.5), (0.0, 0.5), (1e-4, 1e-3)],
    ids=["inside_up", "inside_down", "no_prior", "zero_prior",
         "below_floor"],
)
def test_no_drift_at_default_tolerance(predicted, actual):
    """The 16x band with a 5 ms floor flags none of these fixed costs."""
    for which in PACKAGES:
        engine = _engine(which)
        tr = _fixed_trace(_obs(which), predicted, actual)
        engine._check_drift(tr)
        assert tr.drift is None
        assert not any(
            k.startswith("planner_drift_total")
            for k in engine.metrics_snapshot()
        )


def test_query_records_the_planner_prior_not_a_verdict(repos):
    """A real query stamps the cost prior of the backend it ran and runs
    the drift check on it; conformance queries record no prior."""
    engine = _port_engine()
    res = port_query.Q.log(repos["port"]).using(engine).dfg()
    assert res.trace.predicted_cost_s == port_query.planner.estimate_cost_s(
        res.physical.backend, repos["port"].num_events
    )
    fit = port_query.Q.log(repos["port"]).using(engine).fitness()
    assert fit.trace.predicted_cost_s is None and fit.trace.drift is None


# ---------------------------------------------------------------------------
# self-mining forensics
# ---------------------------------------------------------------------------


def test_forensics_dfg_matches_algorithm1_oracle(repos):
    engine = _port_engine()
    q = port_query.Q.log(repos["port"]).using(engine)
    q.dfg()
    q.dfg()          # cache hit: shorter chain
    q.histogram()
    own = engine.own_telemetry()
    res = port_query.Q.log(own).using(engine).dfg()
    # oracle: numpy DFG over the same repository's consecutive pairs
    src, dst, valid = own.df_pairs()
    expect = port_core.dfg_numpy(src, dst, valid, own.num_activities)
    assert res.names == own.activity_names
    np.testing.assert_array_equal(np.asarray(res.value), expect)
    # the mined process contains the full-scan chain parse → cache_probe
    i = res.names.index("parse")
    j = res.names.index("cache_probe")
    assert np.asarray(res.value)[i, j] >= 1
    # the reference's Algorithm 1 on the same event table agrees
    ref_own = ref_core.EventRepository(
        event_activity=own.event_activity.copy(),
        event_trace=own.event_trace.copy(),
        event_time=own.event_time.copy(),
        trace_log=own.trace_log.copy(),
        activity_names=list(own.activity_names),
        trace_names=list(own.trace_names),
        log_names=list(own.log_names),
    )
    s2, d2, v2 = ref_own.df_pairs()
    np.testing.assert_array_equal(
        np.asarray(res.value),
        ref_core.dfg_numpy(s2, d2, v2, ref_own.num_activities),
    )


def test_forensics_ring_buffer_bounds_memory(repos):
    out = {}
    for which in PACKAGES:
        engine = _engine(which, telemetry_max_events=10)
        q = ref_query.Q if which == "ref" else port_query.Q
        for _ in range(8):
            q.log(repos[which]).using(engine).dfg()
        assert len(engine.telemetry) == 10
        assert engine.telemetry.dropped > 0
        snap = engine.metrics_snapshot()
        assert snap["telemetry_events"] == 10
        assert snap["telemetry_dropped_events"] == engine.telemetry.dropped
        out[which] = engine.telemetry.dropped
    assert out["port"] == out["ref"]


def test_engine_shares_a_metrics_registry(repos):
    reg = port_obs.MetricsRegistry()
    a = _port_engine(metrics=reg)
    b = _port_engine(metrics=reg)
    port_query.Q.log(repos["port"]).using(a).dfg()
    port_query.Q.log(repos["port"]).using(b).histogram()
    assert a.metrics is reg and b.metrics is reg
    assert reg.to_dict()["engine_queries_total"] == 2
    assert a.metrics_snapshot()["engine_cache_hit_ratio"] == 0.0


# ---------------------------------------------------------------------------
# kernel timing hook
# ---------------------------------------------------------------------------


def test_kernel_timings_land_in_global_registry():
    import torch

    from repro_torch.kernels.dfg_count import dfg_count

    hist = port_obs.kernel_registry().histogram(
        "kernel_seconds", kernel="dfg_count"
    )
    before = hist.count
    out = dfg_count(
        torch.tensor([0, 1, 2], dtype=torch.int32),
        torch.tensor([1, 2, 0], dtype=torch.int32),
        torch.tensor([True, True, True]), num_activities=3,
    )
    assert int(out.sum()) == 3
    assert hist.count == before + 1
    assert "kernel_seconds{kernel=dfg_count}" in \
        _port_engine().metrics_snapshot()


# ---------------------------------------------------------------------------
# serving-layer introspection
# ---------------------------------------------------------------------------


def _services(repos, **kw):
    return {
        "port": port_serve.QueryService(_port_engine(), **kw),
        "ref": ref_serve.QueryService(ref_engine(), **kw),
    }


def test_service_trace_option(repos):
    for which, svc in _services(repos).items():
        svc.register("main", repos[which])
        out = svc.query({"log": "main", "sink": "dfg", "trace": True})
        assert out["trace"]["executed_backend"] == out["backend"]
        assert [s["name"] for s in out["trace"]["spans"]][:2] == [
            "parse", "cache_probe",
        ]
        assert out["trace"]["trace_id"] == out["trace_id"]
        plain = svc.query({"log": "main", "sink": "histogram"})
        assert "trace" not in plain


def test_service_forensics_sink(repos):
    outs = {}
    for which, svc in _services(repos).items():
        empty = (port_serve.QueryService(_port_engine()) if which == "port"
                 else ref_serve.QueryService(ref_engine()))
        e = empty.query({"sink": "forensics"})
        assert e["events"] == 0 and e["psi"] == []
        svc.register("main", repos[which])
        svc.query({"log": "main", "sink": "dfg"})
        out = svc.query({"sink": "forensics"})
        assert out["events"] >= 5
        assert "scan" in out["names"]
        assert np.asarray(out["psi"]).sum() >= 1
        outs[which] = {k: out[k] for k in
                       ("events", "dropped_events", "psi", "names", "floor")}
    assert outs["port"] == outs["ref"]


def test_service_forensics_floor(repos):
    for which, svc in _services(repos, forensics_floor=1000).items():
        svc.register("main", repos[which])
        svc.query({"log": "main", "sink": "dfg"})
        out = svc.query({"sink": "forensics"})
        assert out["floor"] == 1000
        assert np.asarray(out["psi"]).sum() == 0  # toy volume is all sub-floor


def test_service_forensics_floor_joins_log_policy(repos):
    for which, svc in _services(repos).items():
        core = port_core if which == "port" else ref_core
        svc.register("main", repos[which],
                     policy=core.AccessPolicy(min_group_count=7))
        svc.query({"log": "main", "sink": "dfg"})
        out = svc.query({"log": "main", "sink": "forensics"})
        assert out["floor"] == 7


def test_service_metrics_sink(repos):
    counters = {}
    for which, svc in _services(repos, forensics_floor=2).items():
        svc.register("main", repos[which])
        svc.query({"log": "main", "sink": "dfg"})
        out = svc.query({"sink": "metrics"})
        assert out["metrics"]["engine_queries_total"] == 0  # 1 query, floor 2
        prom = svc.query({"sink": "metrics", "format": "prometheus"})
        assert "engine_queries_total" in prom["prometheus"]
        assert "kernel_seconds" in prom["prometheus"]
        counters[which] = {
            k: v for k, v in prom["metrics"].items()
            if k.startswith("engine_") and isinstance(v, (int, float))
        }
    assert counters["port"] == counters["ref"]


def test_service_slo_sink(repos):
    outs = {}
    for which, svc in _services(repos).items():
        svc.register("main", repos[which])
        svc.query({"log": "main", "sink": "dfg"})
        out = svc.query({"sink": "slo"})
        assert {o["name"] for o in out["objectives"]} == {
            "warm_latency", "availability",
        }
        outs[which] = out
    assert outs["port"] == outs["ref"]
    assert outs["port"]["floor"] == 0 and outs["port"]["ok"] is True


# ---------------------------------------------------------------------------
# SLO engine (the transport-free cases of test_distributed_obs.py)
# ---------------------------------------------------------------------------


def _slo_setup(obs, observations, threshold_s=0.025, target=0.99):
    m = obs.MetricsRegistry()
    h = m.histogram("request_latency_seconds", lane="hot")
    for x in observations:
        h.observe(x)
    clock = {"t": 1000.0}
    eng = obs.SLOEngine(
        m,
        objectives=[obs.Objective(
            name="warm_latency", kind="latency", target=target,
            metric="request_latency_seconds", labels=(("lane", "hot"),),
            threshold_s=threshold_s,
        )],
        windows_s=(60.0, 300.0),
        now=lambda: clock["t"],
    )
    return m, h, eng, clock


def test_slo_latency_verdict_and_budget():
    outs = {}
    for which in PACKAGES:
        _, _, eng, _ = _slo_setup(_obs(which), [0.001] * 99 + [0.5])
        out = eng.evaluate()
        obj = out["objectives"][0]
        assert obj["ok"] is True and out["ok"] is True
        assert obj["total"] == 100
        assert obj["error_budget_remaining"] == pytest.approx(0.0, abs=0.05)
        _, _, eng2, _ = _slo_setup(_obs(which), [0.1] * 100)
        obj2 = eng2.evaluate()["objectives"][0]
        assert obj2["ok"] is False and obj2["measured"] > 0.025
        outs[which] = (out, obj2)
    assert outs["port"] == outs["ref"]


def test_slo_burn_rate_alert_needs_every_window():
    outs = {}
    for which in PACKAGES:
        _, h, eng, clock = _slo_setup(_obs(which), [0.001] * 1000)
        eng.tick()                      # healthy baseline at t=1000
        clock["t"] += 300.0
        eng.tick()                      # still healthy at t=1300
        out = eng.evaluate(tick=False)
        assert out["objectives"][0]["alert"] is False
        assert out["alerts"] == []
        # sustained burn: every subsequent event is bad, across both windows
        for _ in range(400):
            h.observe(0.2)
        clock["t"] += 60.0
        eng.tick()
        clock["t"] += 300.0
        for _ in range(400):
            h.observe(0.2)
        eng.tick()
        out2 = eng.evaluate(tick=False)
        obj = out2["objectives"][0]
        burns = [b for b in obj["burn_rates"].values() if b is not None]
        assert burns and all(b > 14.4 for b in burns)
        assert obj["alert"] is True and out2["alerts"] == ["warm_latency"]
        outs[which] = (out, out2)
    assert outs["port"] == outs["ref"]


def test_slo_availability_objective():
    outs = {}
    for which in PACKAGES:
        obs = _obs(which)
        m = obs.MetricsRegistry()
        good = m.counter("transport_requests_total", lane="hot")
        bad = m.counter("transport_shed_total", reason="queue")
        eng = obs.SLOEngine(m, objectives=[obs.Objective(
            name="availability", kind="availability", target=0.999,
            metric="transport_requests_total",
            bad_metric="transport_shed_total",
        )], now=lambda: 5.0)
        good.inc(2000)
        first = eng.evaluate()["objectives"][0]
        assert first["ok"] is True and first["good_ratio"] == 1.0
        bad.inc(100)
        second = eng.evaluate()["objectives"][0]
        assert second["ok"] is False
        assert second["error_budget_remaining"] < 0  # budget overdrawn
        outs[which] = (first, second)
    assert outs["port"] == outs["ref"]


def test_slo_floor_hides_counts():
    for which in PACKAGES:
        _, _, eng, _ = _slo_setup(_obs(which), [0.001] * 3)
        obj = eng.evaluate(floor=10)["objectives"][0]
        assert obj["ok"] is None and obj["total"] == 0 and obj["good"] == 0


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(name="x", kind="quantile", target=0.9, metric="m"),
         "unknown objective kind"),
        (dict(name="x", kind="latency", target=0.9, metric="m"),
         "needs threshold_s"),
        (dict(name="x", kind="availability", target=0.9, metric="m"),
         "needs bad_metric"),
        (dict(name="x", kind="latency", target=1.0, metric="m",
              threshold_s=0.1), "target must be in"),
    ],
    ids=["kind", "threshold", "bad_metric", "target"],
)
def test_objective_validation(kwargs, match):
    for which in PACKAGES:
        with pytest.raises(ValueError, match=match):
            _obs(which).Objective(**kwargs)


def test_default_service_objectives_are_the_references():
    assert [dataclasses.astuple(o)
            for o in port_obs.default_service_objectives()] == [
        dataclasses.astuple(o) for o in ref_obs.default_service_objectives()
    ]
    with pytest.raises(ValueError, match="at least one"):
        port_obs.SLOEngine()
    dup = port_obs.default_service_objectives() * 2
    with pytest.raises(ValueError, match="duplicate"):
        port_obs.SLOEngine(port_obs.MetricsRegistry(), objectives=dup)


# ---------------------------------------------------------------------------
# persisted trace store (the transport-free cases of test_distributed_obs.py)
# ---------------------------------------------------------------------------


def _run_traces(store, n, repo, **engine_kw):
    engine = _port_engine(trace_store=store, **engine_kw)
    q = port_query.Q.log(repo).using(engine)
    for _ in range(n):
        q.dfg()
    return engine


def test_trace_store_ring_is_bounded(repos, tmp_path):
    store = port_obs.TraceStore(
        str(tmp_path / "tr"), max_bytes=64 * 1024, segments=3
    )
    try:
        _run_traces(store, 200, repos["port"])
        files = [f for f in (tmp_path / "tr").iterdir()
                 if f.name.endswith(".jsonl")]
        assert len(files) <= 3
        total = sum(f.stat().st_size for f in files)
        assert total <= 64 * 1024 + 8 * 1024  # ring bound (+1 in-flight line)
        assert len(store) == 200              # everything offered and kept
    finally:
        store.close()


def test_trace_store_tail_sampling(repos, tmp_path):
    store = port_obs.TraceStore(
        str(tmp_path / "tr"), sample_every=10, slo_latency_s=0.5,
        metrics=port_obs.MetricsRegistry(),
    )
    try:
        engine = _port_engine(trace_store=store)
        q = port_query.Q.log(repos["port"]).using(engine)
        for _ in range(20):
            q.dfg()                         # fast, healthy: 1-in-10
        assert len(store) == 2
        with pytest.raises(port_query.QueryPlanError):
            q.neighborhood("no-such-activity")  # errors are always kept
        assert len(store) == 3
        recs = list(store.read_records())
        assert sum(1 for r in recs if r["error"]) == 1
    finally:
        store.close()


def test_unsampled_context_kept_only_by_tail_rules(repos, tmp_path):
    store = port_obs.TraceStore(str(tmp_path / "tr"), sample_every=1)
    try:
        engine = _port_engine(trace_store=store)
        ctx = port_context.TraceContext(
            port_context.mint_context().trace_id, "ab" * 8, sampled=False
        )
        with engine.trace_scope(ctx):
            res = port_query.Q.log(repos["port"]).using(engine).dfg()
        assert res.trace.trace_id == ctx.trace_id  # bound under the scope
        assert res.trace.parent_span_id == ctx.span_id
        assert len(store) == 0              # healthy + unsampled: dropped
        with engine.trace_scope(ctx):
            with pytest.raises(port_query.QueryPlanError):
                port_query.Q.log(repos["port"]).using(engine) \
                    .neighborhood("nope")
        assert len(store) == 1              # the error overrides the flag
    finally:
        store.close()


def test_trace_store_mines_bit_identical_to_algorithm1(repos, tmp_path):
    """``Q.log(store.to_repository()).dfg()`` == the numpy Algorithm 1
    oracle over the same read-back event table."""
    store = port_obs.TraceStore(str(tmp_path / "tr"))
    try:
        engine = _run_traces(store, 3, repos["port"])
        port_query.Q.log(repos["port"]).using(engine).histogram()
        own = store.to_repository()
        assert own.num_events > 0
        res = port_query.Q.log(own).using(_port_engine()).dfg()
        src, dst, valid = own.df_pairs()
        expect = port_core.dfg_numpy(src, dst, valid, own.num_activities)
        assert res.names == own.activity_names
        np.testing.assert_array_equal(np.asarray(res.value), expect)
        assert "parse" in res.names
    finally:
        store.close()


def test_trace_store_find_resumes_across_instances(repos, tmp_path):
    store = port_obs.TraceStore(str(tmp_path / "tr"))
    engine = _run_traces(store, 2, repos["port"])
    tid = port_query.Q.log(repos["port"]).using(engine).dfg().trace.trace_id
    store.close()
    reopened = port_obs.TraceStore(str(tmp_path / "tr"))
    try:
        assert [r["trace_id"] for r in reopened.find(tid)]
    finally:
        reopened.close()


def test_reference_written_store_reads_back_in_the_port(
    repos, other_repos, tmp_path
):
    """The state this slice carries across: a ring written by the
    reference's ``TraceStore`` reads back in the port record for record, as
    the same event table, and mines the same Ψ (tolerance 0)."""
    ref_eng = ref_engine()
    store = ref_obs.TraceStore(str(tmp_path / "ring"))
    ref_eng.trace_store = store
    try:
        q = ref_query.Q.log(repos["ref"]).using(ref_eng)
        q.dfg()
        q.dfg()
        q.window(0.0, 30 * 86400.0).histogram()
        ref_query.Q.logs((repos["ref"], "a"), (other_repos["ref"], "b")) \
            .using(ref_eng).dfg()
    finally:
        store.close()
    ref_read = ref_obs.TraceStore(str(tmp_path / "ring"))
    port_read = port_obs.TraceStore(str(tmp_path / "ring"))
    try:
        recs = list(port_read.read_records())
        assert recs == list(ref_read.read_records())
        assert any(r.get("branches") for r in recs)  # the union's branches
        ref_repo = ref_read.to_repository()
        port_repo = port_read.to_repository()
    finally:
        ref_read.close()
        port_read.close()
    for col in ("event_activity", "event_trace", "event_time", "trace_log"):
        np.testing.assert_array_equal(
            getattr(port_repo, col), getattr(ref_repo, col)
        )
    assert port_repo.activity_names == ref_repo.activity_names
    assert port_repo.trace_names == ref_repo.trace_names
    res = port_query.Q.log(port_repo).using(_port_engine()).dfg()
    s, d, v = ref_repo.df_pairs()
    np.testing.assert_array_equal(
        res.value, ref_core.dfg_numpy(s, d, v, ref_repo.num_activities)
    )


def test_port_written_store_matches_the_references_shape(repos, tmp_path):
    """Both packages persist the same record keys and span vocabulary for
    the same query sequence (ids and times are each run's own)."""
    recs = {}
    for which in PACKAGES:
        obs = _obs(which)
        q = port_query.Q if which == "port" else ref_query.Q
        store = obs.TraceStore(str(tmp_path / which))
        engine = _engine(which, trace_store=store)
        try:
            qq = q.log(repos[which]).using(engine)
            qq.dfg()
            qq.dfg()
            qq.histogram()
        finally:
            store.close()
        reread = obs.TraceStore(str(tmp_path / which))
        try:
            # the port's records also carry its device-phase notes
            # (h2d / kernel / d2h seconds), which the reference has not
            recs[which] = [
                (sorted(set(r) - {"notes"}), r["sink"], r["source"],
                 port_backend(r["backend"]), r["from_cache"], r["error"],
                 [s["name"] for s in r["spans"]])
                for r in reread.read_records()
            ]
        finally:
            reread.close()
    assert recs["port"] == recs["ref"] and len(recs["port"]) == 3
