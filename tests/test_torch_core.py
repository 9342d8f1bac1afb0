"""The rest of the numpy core in the port against the reference on the CPU:
the repository's extras (``events_of_activity``, ``trace_of``,
``padded_pairs``, ``save`` / ``load``), soundness, the in-memory baseline,
telemetry, XES / CSV, footprints, dicing semantics, the access-control
session, and the paper's end-to-end pipelines.

The same seeded numpy inputs go through ``repro`` and ``repro_torch``, and
every tolerance is 0: arrays, names, orders, messages and written bytes
must be equal.  Whatever counts on a device runs with ``device="cpu"``.
"""

import io
import os
import threading

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core as ref_core
import repro.core.baseline as ref_baseline
import repro.core.telemetry as ref_telemetry
import repro.data.synthetic_log as ref_synth
import repro.data.xes as ref_xes
import repro.query as ref_query
import repro_torch.core as port_core
import repro_torch.core.baseline as port_baseline
import repro_torch.core.telemetry as port_telemetry
import repro_torch.data.synthetic_log as port_synth
import repro_torch.data.xes as port_xes
import repro_torch.query as port_query
from repro.core.views import AccessDenied as RefAccessDenied
from repro_torch.core.views import AccessDenied

DAY = 86400.0


def _repos(n, **spec):
    seed = spec.get("seed", 0)
    port = port_synth.generate_repository(
        n, port_synth.ProcessSpec(**spec), seed=seed
    )
    ref = ref_synth.generate_repository(
        n, ref_synth.ProcessSpec(**spec), seed=seed
    )
    _same_repo(port, ref)
    return port, ref


def _same_repo(port, ref):
    for f in ("event_activity", "event_trace", "event_time", "trace_log"):
        got, want = getattr(port, f), getattr(ref, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("activity_names", "trace_names", "log_names", "event_names"):
        assert getattr(port, f) == getattr(ref, f), f


def _both_dfg(port, ref, **kw):
    got = port_core.dfg_from_repository(port, device="cpu", **kw)
    want = ref_core.dfg_from_repository(ref, **kw)
    np.testing.assert_array_equal(got, want)
    return got


# ---------------------------------------------------------------------------
# repository extras
# ---------------------------------------------------------------------------


def test_events_of_activity_and_trace_of_match_reference():
    port, ref = _repos(60, num_activities=7, seed=3)
    for a in port.activity_names:
        got, want = port.events_of_activity(a), ref.events_of_activity(a)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for i in range(0, port.num_events, 7):
        assert port.trace_of(i) == ref.trace_of(i)
    # •a2 = {e2, e4} → indices 1 and 3 of the paper's example
    paper = port_core.paper_example_repo()
    assert paper.events_of_activity("a2").tolist() == [1, 3]
    assert paper.trace_of(0) == ref_core.paper_example_repo().trace_of(0)


@pytest.mark.parametrize("multiple", [1, 8, 128, 1000])
@pytest.mark.parametrize("traces", [0, 1, 40])
def test_padded_pairs_match_reference(multiple, traces):
    if traces:
        port, ref = _repos(traces, num_activities=6, seed=traces)
    else:
        port = port_core.EventRepository.from_traces([])
        ref = ref_core.EventRepository.from_traces([])
    got, want = port.padded_pairs(multiple), ref.padded_pairs(multiple)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.shape[0] % multiple == 0 and g.shape[0] >= multiple
        np.testing.assert_array_equal(g, w)


def test_save_load_round_trips_across_packages(tmp_path):
    """Either package loads what the other saved, column for column."""
    port, ref = _repos(50, num_activities=6, seed=2)
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "ref"))
    for name in ("event_activity.npy", "event_trace.npy", "event_time.npy",
                 "trace_log.npy", "meta.json"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "ref" / name
        ).read_bytes(), name
    _same_repo(port_core.EventRepository.load(str(tmp_path / "ref")), ref)
    _same_repo(port_core.EventRepository.load(str(tmp_path / "port")), ref)
    back = ref_core.EventRepository.load(str(tmp_path / "port"))
    _same_repo(port, back)


def test_canonicalization_and_boundaries_match_reference():
    cases = ["c2", "c1", "c1", "c2", "c1"]
    acts = ["x", "a", "b", "y", "c"]
    times = [10.0, 1.0, 2.0, 11.0, 3.0]
    port = port_core.EventRepository.from_event_table(cases, acts, times)
    ref = ref_core.EventRepository.from_event_table(cases, acts, times)
    _same_repo(port, ref)
    for g, w in zip(port.trace_boundaries(), ref.trace_boundaries()):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        port_core.EventRepository.from_event_table(
            ["c1"], ["zzz"], [0.0], activity_vocab=["a", "b"]
        )


# ---------------------------------------------------------------------------
# soundness (Definition 2)
# ---------------------------------------------------------------------------


def _mutations():
    """name → mutation of the paper example's graph form (a violation of
    each soundness condition, and none)."""
    return {
        "sound": lambda g: None,
        "s1_two_logs": lambda g: (
            g.logs.add("log:l2"), g.relations.add(("log:l2", "trace:t1"))
        ),
        "s2_two_traces": lambda g: g.relations.add(("trace:t2", "e1")),
        "s3_s4_two_flows": lambda g: g.relations.add(("e1", "e3")),
        "s5_no_activity": lambda g: g.relations.discard(("e1", "act:a1")),
        "s5_two_activities": lambda g: g.relations.add(("e1", "act:a2")),
        "stray_relation": lambda g: g.relations.add(("act:a1", "e1")),
    }


@pytest.mark.parametrize("case", sorted(_mutations()))
def test_check_graph_matches_reference(case):
    mutate = _mutations()[case]
    port_g = port_core.paper_example_repo().to_graph()
    ref_g = ref_core.paper_example_repo().to_graph()
    mutate(port_g)
    mutate(ref_g)
    got, want = port_core.check_graph(port_g), ref_core.check_graph(ref_g)
    assert (got.ok, got.violations) == (want.ok, want.violations)
    assert got.ok == (case == "sound")
    assert port_core.is_sound(port_g) == got.ok


def _columnar_cases():
    base = dict(
        trace_log=np.zeros(2, dtype=np.int32), activity_names=["a", "b"],
        trace_names=["t1", "t2"], log_names=["l1"],
    )
    return {
        "non_contiguous": dict(
            base, event_activity=[0, 1, 0], event_trace=[0, 1, 0],
            event_time=[0.0, 1.0, 2.0],
        ),
        "time_order": dict(
            base, event_activity=[0, 1], event_trace=[0, 0],
            event_time=[2.0, 1.0],
        ),
        "activity_range": dict(
            base, event_activity=[0, 5], event_trace=[0, 1],
            event_time=[0.0, 1.0],
        ),
        "trace_range": dict(
            base, event_activity=[0, 1], event_trace=[0, 3],
            event_time=[0.0, 1.0],
        ),
        "log_range": dict(
            base, trace_log=np.asarray([0, 2], np.int32), event_activity=[0, 1],
            event_trace=[0, 1], event_time=[0.0, 1.0],
        ),
        "length_mismatch": dict(
            base, event_activity=[0, 1], event_trace=[0],
            event_time=[0.0, 1.0],
        ),
        "sound": dict(
            base, event_activity=[0, 1, 1], event_trace=[0, 0, 1],
            event_time=[0.0, 1.0, 0.5],
        ),
    }


@pytest.mark.parametrize("case", sorted(_columnar_cases()))
def test_check_columnar_matches_reference(case):
    fields = _columnar_cases()[case]

    def repo(cls):
        return cls(
            event_activity=np.asarray(fields["event_activity"], np.int32),
            event_trace=np.asarray(fields["event_trace"], np.int32),
            event_time=np.asarray(fields["event_time"], np.float64),
            trace_log=fields["trace_log"],
            activity_names=fields["activity_names"],
            trace_names=fields["trace_names"],
            log_names=fields["log_names"],
        )

    got = port_core.check_columnar(repo(port_core.EventRepository))
    want = ref_core.check_columnar(repo(ref_core.EventRepository))
    assert (got.ok, got.violations) == (want.ok, want.violations)
    assert got.ok == (case == "sound")


def test_is_sound_rejects_other_types():
    with pytest.raises(TypeError):
        port_core.is_sound([1, 2])


@settings(max_examples=60, deadline=None)
@given(
    traces=st.lists(
        st.lists(st.sampled_from(["a", "b", "c", "d", "e"]), min_size=1,
                 max_size=12),
        min_size=0, max_size=12,
    )
)
def test_from_traces_always_sound(traces):
    port = port_core.EventRepository.from_traces(traces)
    assert port_core.check_columnar(port).ok
    g = port.to_graph()
    assert port_core.check_graph(g).ok
    np.testing.assert_array_equal(
        port_core.dfg_from_repository(port, device="cpu"),
        port_core.dfg_from_repository(g.to_columnar(), device="cpu"),
    )
    _same_repo(port, ref_core.EventRepository.from_traces(traces))


@settings(max_examples=40, deadline=None)
@given(
    n=st.integers(min_value=2, max_value=40),
    k=st.integers(min_value=1, max_value=5),
    seed=st.integers(min_value=0, max_value=10_000),
)
def test_from_event_table_sound_for_random_tables(n, k, seed):
    rng = np.random.default_rng(seed)
    cases = [f"c{int(x)}" for x in rng.integers(0, k, size=n)]
    acts = [f"a{int(x)}" for x in rng.integers(0, 4, size=n)]
    times = rng.uniform(0, 100, size=n)
    port = port_core.EventRepository.from_event_table(cases, acts, times)
    assert port_core.check_columnar(port).ok
    _same_repo(port, ref_core.EventRepository.from_event_table(cases, acts, times))


# ---------------------------------------------------------------------------
# the in-memory baseline
# ---------------------------------------------------------------------------


def _rows(repo):
    return list(zip(repo.event_trace.tolist(), repo.event_activity.tolist(),
                    repo.event_time.tolist()))


@pytest.mark.parametrize("window", [None, (10 * DAY, 60 * DAY), (5.0, 5.0)])
def test_baseline_dfg_matches_reference_and_the_port(window):
    port, _ = _repos(120, num_activities=8, seed=4)
    rows = _rows(port)[::-1]  # the baseline sorts each case itself
    a = port.num_activities
    got = port_baseline.InMemoryDFGBaseline().dfg(rows, a, time_window=window)
    want = ref_baseline.InMemoryDFGBaseline().dfg(rows, a, time_window=window)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if window is None:
        np.testing.assert_array_equal(
            got, port_core.dfg_from_repository(port, device="cpu")
        )
        np.testing.assert_array_equal(
            port_core.dfg_from_rows(rows, a), ref_core.dfg_from_rows(rows, a)
        )
    else:  # re-linking after the load, as pm4py filters
        np.testing.assert_array_equal(
            got,
            port_core.dfg_from_repository(
                port_core.dice_repository(port, time_window=window),
                device="cpu",
            ),
        )


def test_baseline_budget_matches_reference():
    port, _ = _repos(30, num_activities=5, seed=1)
    rows = _rows(port)
    budget = 64 * (len(rows) // 2)
    with pytest.raises(port_baseline.LogTooLargeError) as got:
        port_baseline.InMemoryDFGBaseline(budget).load(rows)
    with pytest.raises(ref_baseline.LogTooLargeError) as want:
        ref_baseline.InMemoryDFGBaseline(budget).load(rows)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, MemoryError)
    cases = port_baseline.InMemoryDFGBaseline(64 * len(rows)).load(rows)
    assert cases == ref_baseline.InMemoryDFGBaseline(64 * len(rows)).load(rows)


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def _record_both(fn):
    """Run ``fn(collector)`` against a port and a reference collector and
    return both."""
    port, ref = port_telemetry.EventCollector("t"), ref_telemetry.EventCollector("t")
    fn(port)
    fn(ref)
    return port, ref


def test_collector_orders_by_case_then_time_as_the_reference():
    def fill(c):
        c.record("b", "x", timestamp=2.0)
        c.record("a", "q", timestamp=5.0)
        c.record("a", "p", timestamp=1.0)
        c.record("b", "y", timestamp=3.0)

    port, ref = _record_both(fill)
    _same_repo(port.to_repository(), ref.to_repository())
    repo = port.to_repository()
    assert [repo.activity_names[i] for i in repo.event_activity] == [
        "p", "q", "x", "y"
    ]


def test_collector_ring_buffer_and_batches_match_reference():
    port = port_telemetry.EventCollector("t", max_events=10)
    ref = ref_telemetry.EventCollector("t", max_events=10)
    for c in (port, ref):
        for i in range(25):
            c.record("case", f"a{i}", timestamp=float(i))
        c.record_many("q1", ["b", "c"], [30.0, 31.0])
        c.record_many(["q2", "q3"], ["d", "e"], [32.0, 33.0],
                      durations=[0.1, 0.2])
    assert (len(port), port.dropped) == (len(ref), ref.dropped) == (10, 19)
    _same_repo(port.to_repository(), ref.to_repository())


def test_collector_is_thread_safe():
    c = port_telemetry.EventCollector("t")
    n, m = 8, 500

    def work(tid):
        for i in range(m):
            with c.span(f"case-{tid}", "phase"):
                pass
            c.record(f"case-{tid}", "done", timestamp=float(i))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(c) == n * m * 2 and c.dropped == 0
    assert c.to_repository().num_events == n * m * 2


def test_straggler_report_and_step_timer_match_reference():
    def fill(c):
        for i in range(10):
            c.record(f"s{i}", "grad_sync", timestamp=float(i), duration=1.0)
        c.record("s10", "grad_sync", timestamp=10.0, duration=30.0)
        for i in range(2):
            c.record("s", "rare", timestamp=float(i), duration=9.0)

    port, ref = _record_both(fill)
    assert port.straggler_report(3.0) == ref.straggler_report(3.0)
    assert "grad_sync" in port.straggler_report(3.0)
    got, want = port.durations_by_activity(), ref.durations_by_activity()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    t = port_telemetry.StepTimer()
    for _ in range(3):
        with t.phase("load"):
            pass
    with t.phase("fwd"):
        pass
    s = t.summary()
    assert s["load"][1] == 3 and s["fwd"][1] == 1 and s["load"][0] >= 0.0


def test_mining_runtime_telemetry_matches_reference():
    """The framework mines its own execution: a healthy loop's DFG is a
    chain; an injected retry shows up as a deviation."""
    phases = ["load", "forward", "backward", "optim"]

    def fill(c):
        for step in range(5):
            for p in phases:
                c.record(f"step-{step}", p, timestamp=float(step * 10 + phases.index(p)))
        c.record("step-3", "retry", timestamp=35.5)

    port, ref = _record_both(fill)
    repo = port.to_repository()
    psi = _both_dfg(repo, ref.to_repository())
    names = repo.activity_names
    assert psi[names.index("load"), names.index("forward")] == 5
    assert psi[names.index("optim"), names.index("retry")] == 1


# ---------------------------------------------------------------------------
# XES / CSV
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["xes", "csv"])
@pytest.mark.parametrize("traces", [0, 1, 30])
def test_writers_write_the_reference_bytes_and_readers_read_them(fmt, traces):
    if traces:
        port, ref = _repos(traces, num_activities=5, seed=9)
    else:
        port = port_core.EventRepository.from_traces([])
        ref = ref_core.EventRepository.from_traces([])
    write = {"xes": (port_xes.write_xes, ref_xes.write_xes),
             "csv": (port_xes.write_csv, ref_xes.write_csv)}[fmt]
    read = {"xes": (port_xes.read_xes, ref_xes.read_xes),
            "csv": (port_xes.read_csv, ref_xes.read_csv)}[fmt]
    got, want = io.StringIO(), io.StringIO()
    write[0](port, got)
    write[1](ref, want)
    assert got.getvalue() == want.getvalue()
    back = read[0](io.StringIO(got.getvalue()))
    _same_repo(back, read[1](io.StringIO(want.getvalue())))
    assert back.num_events == port.num_events
    if traces:
        _both_dfg(back, read[1](io.StringIO(want.getvalue())))


def test_xes_of_an_unsorted_repository_matches_reference():
    """A repository whose trace ids are not sorted: each trace's events are
    written in row order, as the reference writes them."""
    fields = dict(
        event_activity=np.asarray([1, 0, 2, 1, 0], np.int32),
        event_trace=np.asarray([1, 1, 0, 2, 0], np.int32),
        event_time=np.asarray([3.0, 1.0, 2.0, 0.5, 4.0]),
        trace_log=np.zeros(3, np.int32), activity_names=["a", "b", "c"],
        trace_names=["x", "y", "z"], log_names=["l"],
    )
    got, want = io.StringIO(), io.StringIO()
    port_xes.write_xes(port_core.EventRepository(**fields), got)
    ref_xes.write_xes(ref_core.EventRepository(**fields), want)
    assert got.getvalue() == want.getvalue()


def test_xes_reader_defaults_match_reference():
    text = (
        '<log><trace><string key="concept:name" value="c1"/>'
        '<event><string key="concept:name" value="a"/></event>'
        '<event><float key="time:timestamp" value="3.0"/></event>'
        '<event><string key="concept:name" value="b"/>'
        '<float key="time:timestamp" value="0.5"/></event></trace>'
        '<trace><event><string key="concept:name" value="c"/></event></trace>'
        "</log>"
    )
    _same_repo(port_xes.read_xes(io.StringIO(text)),
               ref_xes.read_xes(io.StringIO(text)))


@settings(max_examples=20, deadline=None)
@given(n=st.integers(5, 80), seed=st.integers(0, 1000))
def test_csv_round_trip_property(n, seed):
    port, ref = _repos(n, num_activities=7, seed=seed)
    buf = io.StringIO()
    port_xes.write_csv(port, buf)
    back = port_xes.read_csv(io.StringIO(buf.getvalue()))
    want = ref_xes.read_csv(io.StringIO(buf.getvalue()))
    _same_repo(back, want)
    psi = port_core.dfg_from_repository(back, device="cpu")
    full = port_core.dfg_from_repository(port, device="cpu")
    idx = [port.activity_names.index(a) for a in back.activity_names]
    np.testing.assert_array_equal(psi, full[np.ix_(idx, idx)])


# ---------------------------------------------------------------------------
# footprints and discovery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_footprints_match_reference(seed):
    port, ref = _repos(200, num_activities=9, seed=seed)
    psi = _both_dfg(port, ref)
    t0, t1 = float(port.event_time.min()), float(port.event_time.max()) + 1.0
    mid = (t0 + t1) / 2
    f1 = port_core.footprint(psi)
    assert f1.dtype == ref_core.footprint(psi).dtype
    np.testing.assert_array_equal(f1, ref_core.footprint(psi))
    half = _both_dfg(port, ref, time_window=(t0, mid))
    f2 = port_core.footprint(half)
    assert port_core.footprint_conformance(f1, f2) == ref_core.footprint_conformance(
        ref_core.footprint(psi), ref_core.footprint(half)
    )
    assert port_core.footprint_conformance(f1, f1) == 1.0
    assert port_core.footprint_conformance(f1[:0, :0], f2[:0, :0]) == 1.0
    with pytest.raises(ValueError):
        port_core.footprint_conformance(f1, f1[:-1])


def test_footprint_relations():
    repo = port_core.EventRepository.from_traces([["a", "b", "c"], ["a", "c", "b"]])
    fp = port_core.footprint(port_core.dfg_from_repository(repo, device="cpu"))
    n = repo.activity_names
    ai, bi, ci = n.index("a"), n.index("b"), n.index("c")
    assert (fp[ai, bi], fp[bi, ai], fp[bi, ci], fp[ai, ai]) == (1, 2, 3, 0)


# ---------------------------------------------------------------------------
# dicing semantics
# ---------------------------------------------------------------------------


def test_paper_and_pm4py_semantics_agree_for_contiguous_windows():
    port, ref = _repos(300, num_activities=12, seed=5)
    t0 = float(np.quantile(port.event_time, 0.2))
    t1 = float(np.quantile(port.event_time, 0.6))
    paper = _both_dfg(port, ref, time_window=(t0, t1))
    diced = port_core.dice_repository(port, time_window=(t0, t1))
    _same_repo(diced, ref_core.dice_repository(ref, time_window=(t0, t1)))
    assert port_core.check_columnar(diced).ok
    np.testing.assert_array_equal(
        paper, port_core.dfg_from_repository(diced, device="cpu")
    )


def test_activity_dice_relinks():
    repo = port_core.EventRepository.from_traces([["a", "b", "c", "a"]])
    diced = port_core.dice_repository(repo, activities=["a", "c"])
    psi = port_core.dfg_from_repository(diced, device="cpu")
    names = diced.activity_names
    assert psi[names.index("a"), names.index("c")] == 1
    assert psi[names.index("c"), names.index("a")] == 1


# ---------------------------------------------------------------------------
# the access-control session
# ---------------------------------------------------------------------------


def _sessions(port, ref, **policy):
    view = policy.pop("view", None)
    port_pol = port_core.AccessPolicy(
        view=port_core.ActivityView(dict(view)) if view else None, **policy
    )
    ref_pol = ref_core.AccessPolicy(
        view=ref_core.ActivityView(dict(view)) if view else None, **policy
    )
    port_eng = port_query.QueryEngine(device="cpu", tiny_pairs=64)
    ref_eng = ref_query.QueryEngine(
        calibration_path=os.devnull, tiny_pairs=64, graph_crossover=10**9
    )
    return (
        port_core.AnalystSession(port, port_pol, engine=port_eng),
        ref_core.AnalystSession(ref, ref_pol, engine=ref_eng),
    )


POLICIES = {
    "aggregate": dict(),
    "k_anonymity": dict(min_group_count=5),
    "view": dict(view={f"act_{i:03d}": f"dept_{i % 3}" for i in range(11)}),
    "view_k": dict(
        view={f"act_{i:03d}": f"dept_{i % 4}" for i in range(12)},
        min_group_count=20,
    ),
}


@pytest.mark.parametrize("window", [None, (10 * DAY, 70 * DAY)])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_analyst_session_matches_reference(policy, window):
    port, ref = _repos(300, num_activities=12, seed=7)
    ps, rs = _sessions(port, ref, **POLICIES[policy])
    got, got_names = ps.dfg(time_window=window, backend="kernel")
    want, want_names = rs.dfg(time_window=window, backend="pallas")
    assert got_names == want_names
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    floor = POLICIES[policy].get("min_group_count", 0)
    assert not ((got > 0) & (got < floor)).any()
    h, hn = ps.activity_histogram()
    rh, rhn = rs.activity_histogram()
    assert hn == rhn
    np.testing.assert_array_equal(h, rh)
    assert ps.trace_length_stats() == rs.trace_length_stats()
    with pytest.raises(AccessDenied):
        ps.events()
    with pytest.raises(RefAccessDenied):
        rs.events()


def test_analyst_session_exposes_no_raw_columns():
    port, ref = _repos(50, num_activities=6, seed=9)
    sess, _ = _sessions(port, ref)
    psi, names = sess.dfg()
    assert psi.shape == (6, 6) and names == port.activity_names
    assert not hasattr(sess, "repo")
    assert not any(
        isinstance(getattr(sess, n, None), type(port))
        for n in dir(sess) if not n.startswith("_")
    )
    blocked, _ = _sessions(port, ref, time_windows_allowed=False)
    with pytest.raises(AccessDenied, match="time dicing"):
        blocked.dfg(time_window=(0.0, 1.0))
    assert isinstance(AccessDenied("x"), PermissionError)
    open_sess, _ = _sessions(port, ref, aggregate_only=False)
    a, t, ts = open_sess.events()
    np.testing.assert_array_equal(a, port.event_activity)
    a[0] += 1  # a copy: the session's repository is untouched
    assert port.event_activity[0] != a[0]


def test_k_anonymity_floor_and_session_view():
    repo = port_core.EventRepository.from_traces([["a", "b"]] * 3 + [["a", "c"]])
    sess = port_core.AnalystSession(
        repo, port_core.AccessPolicy(min_group_count=2),
        engine=port_query.QueryEngine(device="cpu"),
    )
    psi, names = sess.dfg()
    assert psi[names.index("a"), names.index("c")] == 0
    assert psi[names.index("a"), names.index("b")] == 3
    repo = port_core.EventRepository.from_traces([["a1", "a2"], ["a1", "a3"]])
    view = port_core.ActivityView(mapping={"a1": "g1", "a2": "g2", "a3": "g2"})
    sess = port_core.AnalystSession(
        repo, port_core.AccessPolicy(view=view),
        engine=port_query.QueryEngine(device="cpu"),
    )
    psi, names = sess.dfg()
    assert names == ["g1", "g2"] and psi[0, 1] == 2
    hist, hnames = sess.activity_histogram()
    assert hnames == ["g1", "g2"] and hist.tolist() == [2, 2]


# ---------------------------------------------------------------------------
# the paper's pipelines end to end
# ---------------------------------------------------------------------------


def test_end_to_end_discovery_pipeline_matches_reference():
    port, ref = _repos(1000, num_activities=20, seed=42)
    assert port_core.check_columnar(port).ok
    psi = port_core.dfg_from_repository(port, backend="scatter", device="cpu")
    np.testing.assert_array_equal(
        psi, port_core.dfg_from_repository(port, backend="kernel", device="cpu")
    )
    np.testing.assert_array_equal(
        psi, ref_core.dfg_from_repository(ref, backend="scatter")
    )
    starts, ends = port.trace_boundaries()
    kw = dict(min_count=3, min_dependency=0.3)
    model = port_core.discover_dependency_graph(
        port_core.filter_dfg(psi, min_count=3), port.activity_names, starts,
        ends, **kw,
    )
    want = ref_core.discover_dependency_graph(
        ref_core.filter_dfg(psi, min_count=3), ref.activity_names, starts,
        ends, **kw,
    )
    assert model.edges and model.start_activities and model.end_activities
    assert port_core.to_dot(model) == ref_core.to_dot(want)


def test_dicing_consistency_and_slice_conformance_match_reference():
    port, ref = _repos(2000, num_activities=10, seed=3)
    full = _both_dfg(port, ref)
    t0, t1 = port.event_time.min(), port.event_time.max() + 1.0
    mid = (t0 + t1) / 2
    w1 = _both_dfg(port, ref, time_window=(t0, mid))
    w2 = _both_dfg(port, ref, time_window=(mid, t1))
    assert ((w1 + w2) <= full).all()
    c = port_core.footprint_conformance(
        port_core.footprint(w1), port_core.footprint(w2)
    )
    assert c == ref_core.footprint_conformance(
        ref_core.footprint(w1), ref_core.footprint(w2)
    )
    assert c > 0.8
