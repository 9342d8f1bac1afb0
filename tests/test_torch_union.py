"""Multi-log sources in the port against the reference on the CPU:
``Q.logs`` unions (DFG, histogram, topology, variants and barriers on the
concatenation, conformance), ``compare()``, ``FromLogs`` / ``select_logs``
/ ``split_logs`` / ``concat_repositories``, union fingerprints, and the
engine's trace stack under a union.

The same seeded numpy inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``) and every tolerance is 0: Ψ, counts, names,
``CompareResult`` fields and fitness floats, fingerprints and plan keys,
backends (through ``tests/torch_parity.py``) and branch notes,
``EngineStats`` counters and ``rows_scanned``, and planner error messages.
Independently of the reference, union results are also held against
Algorithm 1 on the concatenation.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.conformance.align as ref_align
import repro.core as ref_core
import repro.core.conformance as ref_core_conf
import repro.core.variants as ref_variants
import repro.query as ref_query
import repro_torch.core as port_core
import repro_torch.core.variants as port_variants
import repro_torch.data.synthetic_log as port_synth
import repro_torch.query as port_query
from repro.core.streaming import MemmapLog as RefMemmapLog
from repro_torch.core.streaming import MemmapLog as PortMemmapLog
from torch_parity import (
    assert_no_collision,
    port_backend,
    port_notes,
    ref_repository,
)

#: the stats counters both engines keep
STATS = (
    "queries", "executions", "cache_hits", "delta_hits", "delta_free_hits",
    "rows_scanned", "union_queries", "graph_queries", "conformance_queries",
)
#: an explicit replay crossover for both engines (the reference would read
#: another from its committed calibration record)
REPLAY = 1 << 22


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's entry points; ``side[pair]`` picks its half of a
    ``(port, ref)`` pair of inputs."""

    i: int
    query: object
    core: object

    def __getitem__(self, pair):
        return pair[self.i]

    @property
    def Q(self):
        return self.query.Q

    def backend(self, port_name: str) -> str:
        return "pallas" if self.i and port_name == "kernel" else port_name

    def view(self, mapping):
        return self.core.ActivityView(dict(mapping))


PORT = Side(0, port_query, port_core)
REF = Side(1, ref_query, ref_core)


def _engines(**kw):
    kw.setdefault("graph_crossover", 10**9)
    kw.setdefault("replay_crossover", REPLAY)
    ref = ref_query.QueryEngine(calibration_path=os.devnull, **kw)
    port = port_query.QueryEngine(device="cpu", **kw)
    return port, ref


def _catch(fn):
    try:
        return fn()
    except (ref_query.QueryPlanError, port_query.QueryPlanError) as e:
        return e


def _same(p, r, what="value"):
    """Recursive exact equality of a port value and a reference value."""
    if isinstance(r, np.ndarray):
        assert isinstance(p, np.ndarray), what
        np.testing.assert_array_equal(p, r, err_msg=what)
        if r.dtype.kind == "f":
            assert p.dtype == r.dtype, what
    elif isinstance(r, ref_variants.TraceVariants):
        for f in ("counts", "trace_variant"):
            _same(getattr(p, f), getattr(r, f), f"{what}.{f}")
        assert p.sequences == r.sequences, what
    elif dataclasses.is_dataclass(r):
        for f in dataclasses.fields(r):
            _same(getattr(p, f.name), getattr(r, f.name), f"{what}.{f.name}")
    elif isinstance(r, (tuple, list)) and any(
        isinstance(x, np.ndarray) for x in r
    ):
        assert len(p) == len(r), what
        for i, (x, y) in enumerate(zip(p, r)):
            _same(x, y, f"{what}[{i}]")
    else:
        assert p == r, what


def _same_trace(p, r):
    assert p.rows_scanned == r.rows_scanned
    assert p.executed_backend == port_backend(r.executed_backend or "")
    assert p.from_cache == r.from_cache
    assert p.delta_rows == r.delta_rows
    assert [n for n, _ in p.branches] == [n for n, _ in r.branches]
    for (_, pb), (_, rb) in zip(p.branches, r.branches):
        _same_trace(pb, rb)


def _same_result(p, r):
    if isinstance(r, Exception) or isinstance(p, Exception):
        assert isinstance(r, ref_query.QueryPlanError), r
        assert isinstance(p, port_query.QueryPlanError), p
        assert str(p) == str(r)
        return
    assert p.names == r.names
    _same(p.value, r.value)
    assert p.from_cache == r.from_cache
    pp, rp = p.physical, r.physical
    assert pp.backend == port_backend(rp.backend)
    assert pp.notes == port_notes(rp.notes)
    for f in ("materialize", "row_range_window", "view_pushdown",
              "activities_as_output_mask", "delta_rows", "fused_dicing"):
        assert getattr(pp, f) == getattr(rp, f), f
    assert p.rewrites == r.rewrites
    if getattr(p.logical.sink, "backend", None) == getattr(
        r.logical.sink, "backend", None
    ):
        assert p.logical.key() == r.logical.key()
    _same_trace(p.trace, r.trace)


def _same_stats(port_eng, ref_eng):
    for f in STATS:
        assert getattr(port_eng.stats, f) == getattr(ref_eng.stats, f), f


def _both(fn, port_eng=None, ref_eng=None, **engine_kw):
    """``fn(side, engine)`` through both packages; results (or planner
    errors) and engine counters must agree.  Returns the port's result."""
    if port_eng is None:
        port_eng, ref_eng = _engines(**engine_kw)
    r = _catch(lambda: fn(REF, ref_eng))
    p = _catch(lambda: fn(PORT, port_eng))
    _same_result(p, r)
    _same_stats(port_eng, ref_eng)
    return p


# ---------------------------------------------------------------------------
# oracles (the port's own core, independent of its engine)
# ---------------------------------------------------------------------------


def _concat_oracle(named_repos):
    """Engine-independent concatenation: the flat string event table through
    the port's ``from_event_table``, with log provenance."""
    cases, acts, times, logs = [], [], [], []
    for name, r in named_repos:
        for i in range(r.num_events):
            cases.append(f"{name}/{r.trace_names[int(r.event_trace[i])]}")
            acts.append(r.activity_names[int(r.event_activity[i])])
            times.append(float(r.event_time[i]))
            logs.append(name)
    return port_core.EventRepository.from_event_table(
        cases, acts, times, log_ids=logs
    )


def _oracle_dfg(repo, window=None, keep=None, view=None):
    src, dst, valid = repo.df_pairs()
    if window is not None:
        valid = valid & port_core.pair_mask_for_window(repo, window)
    if keep is not None:
        ids = np.asarray([repo.activity_names.index(a) for a in keep])
        m = np.isin(repo.event_activity, ids)
        valid = valid & m[:-1] & m[1:]
    psi = port_core.dfg_numpy(src, dst, valid, repo.num_activities)
    if view is not None:
        psi = view.apply_to_dfg(psi, repo.activity_names)
    return psi


def _embed(psi, names, union_names):
    out = np.zeros((len(union_names),) * 2, dtype=np.int64)
    ids = np.asarray([union_names.index(n) for n in names])
    out[np.ix_(ids, ids)] = psi
    return out


def _discover(repo, **kw):
    s, d, v = repo.df_pairs()
    return port_core.discover_dependency_graph(
        port_core.dfg_numpy(s, d, v, repo.num_activities),
        repo.activity_names, *repo.trace_boundaries(), **kw,
    )


def _same_repo(port, ref):
    for f in ("event_activity", "event_trace", "event_time", "trace_log"):
        got, want = getattr(port, f), getattr(ref, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("activity_names", "trace_names", "log_names", "event_names"):
        assert getattr(port, f) == getattr(ref, f), f


# ---------------------------------------------------------------------------
# fixtures: every input as a (port, reference) pair of the same bytes
# ---------------------------------------------------------------------------


def _pair_repo(num_traces, **spec):
    port = port_synth.generate_repository(
        num_traces, port_synth.ProcessSpec(**spec), seed=spec["seed"]
    )
    return port, ref_repository(port)


def _renamed(pair, rename):
    """The pair with activities renamed (the columns unchanged), so a
    union's vocabulary alignment is not the identity."""
    port, _ = pair
    names = [rename.get(n, n) for n in port.activity_names]
    port = dataclasses.replace(port, activity_names=names)
    return port, ref_repository(port)


@pytest.fixture(scope="module")
def repo_a():
    return _pair_repo(120, num_activities=7, seed=101)


@pytest.fixture(scope="module")
def repo_b():
    # overlapping-but-different vocabulary (act_000..009 vs 000..006)
    return _pair_repo(90, num_activities=10, seed=202)


@pytest.fixture(scope="module")
def renamed_b(repo_b):
    # act_001 → new_a, act_004 → zz_b: the union vocabulary interleaves
    return _renamed(repo_b, {"act_001": "new_a", "act_004": "zz_b"})


@pytest.fixture(scope="module")
def multilog_repo():
    """One repository holding two deployments via the L×T relation."""
    rng = np.random.default_rng(7)
    cases, acts, times, logs = [], [], [], []
    for li, log in enumerate(["canary", "prod"]):
        for c in range(40):
            n = int(rng.integers(2, 7))
            for k in range(n):
                cases.append(f"{log}_c{c}")
                acts.append(f"act_{int(rng.integers(0, 6)):03d}")
                times.append(float(li * 1000 + c * 10 + k))
                logs.append(log)
    port = port_core.EventRepository.from_event_table(
        cases, acts, times, log_ids=logs
    )
    ref = ref_core.EventRepository.from_event_table(
        cases, acts, times, log_ids=logs
    )
    _same_repo(port, ref)
    return port, ref


def _open_pair(path):
    return PortMemmapLog.open(path), RefMemmapLog.open(path)


@pytest.fixture()
def two_mmlogs(tmp_path):
    out = []
    for i in range(2):
        path = str(tmp_path / f"mm{i}")
        port_synth.generate_memmap_log(
            path, 4_000,
            port_synth.ProcessSpec(num_activities=8 + 3 * i, seed=60 + i),
            seed=60 + i, batch_traces=120,
        )
        out.append(_open_pair(path))
    return out


def _copies(pairs, tmp_path, tag):
    """Separate on-disk copies per package (appends mutate the files)."""
    out = []
    for i, (port, _) in enumerate(pairs):
        pp = str(tmp_path / f"{tag}{i}_port")
        rp = str(tmp_path / f"{tag}{i}_ref")
        shutil.copytree(port.path, pp)
        shutil.copytree(port.path, rp)
        out.append((PortMemmapLog.open(pp), RefMemmapLog.open(rp)))
    return out


def _append_both(pair, n, seed, new_activity=False):
    """The same time-ordered suffix appended to each package's copy, cases
    reused so pairs straddle the append boundary."""
    port, ref = pair
    rng = np.random.default_rng(seed)
    a_hi = port.num_activities + (1 if new_activity else 0)
    act = rng.integers(0, a_hi, n).astype(np.int32)
    if new_activity:
        act[0] = port.num_activities
    case = rng.integers(0, port.num_traces, n).astype(np.int32)
    times = float(port.time[-1]) + np.sort(rng.uniform(0.0, 50.0, n))
    return port.append(act, case, times), ref.append(act, case, times)


# ---------------------------------------------------------------------------
# union sinks vs the reference and Algorithm 1 on the concatenation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "numpy", "scatter", "onehot",
                                     "kernel"])
def test_union_dfg_matches_algorithm1_all_backends(backend):
    a = port_core.paper_example_repo()
    b = port_core.EventRepository.from_traces(
        [["a2", "a5", "a3"], ["a1", "a5"]],
        activity_vocab=["a1", "a2", "a3", "a5"],
    )
    pairs = [(a, ref_repository(a)), (b, ref_repository(b))]
    oracle = _concat_oracle([("prod", a), ("canary", b)])
    want, _ = port_core.dfg_algorithm1(oracle.to_graph())
    res = _both(lambda s, e: s.Q.logs(
        (s[pairs[0]], "prod"), (s[pairs[1]], "canary")
    ).using(e).dfg(backend=s.backend(backend)))
    assert res.physical.backend == "union"
    assert res.names == oracle.activity_names  # sorted union vocabulary
    assert res.value.dtype == np.int64
    np.testing.assert_array_equal(res.value, want)
    assert res.physical.notes == (
        f"branch[prod]={res.physical.notes[0].split('=')[1]}",
        res.physical.notes[1],
    )


def test_union_window_filter_view_equals_oracle(repo_a, renamed_b):
    oracle = _concat_oracle([("a", repo_a[0]), ("b", renamed_b[0])])
    ts = oracle.event_time
    t0, t1 = float(np.quantile(ts, 0.2)), float(np.quantile(ts, 0.85))
    keep = oracle.activity_names[2:9]  # includes names absent from repo_a
    mapping = {n: f"g{i % 3}" for i, n in enumerate(oracle.activity_names[:8])}
    port_eng, ref_eng = _engines()

    def q(s, e):
        return s.Q.logs((s[repo_a], "a"), (s[renamed_b], "b")).using(e)

    cases = [
        (lambda s, e: q(s, e).window(t0, t1).dfg(), dict(window=(t0, t1))),
        (lambda s, e: q(s, e).activities(keep).dfg(), dict(keep=keep)),
        (lambda s, e: q(s, e).window(t0, t1).activities(keep)
         .view(s.view(mapping)).dfg(),
         dict(window=(t0, t1), keep=keep,
              view=port_core.ActivityView(mapping))),
    ]
    for fn, oracle_kw in cases:
        res = _both(fn, port_eng, ref_eng)
        np.testing.assert_array_equal(
            res.value, _oracle_dfg(oracle, **oracle_kw)
        )
    view = port_core.ActivityView(mapping)
    assert res.names == view.visible_names(oracle.activity_names)


def test_union_histogram_equals_oracle(repo_a, renamed_b):
    oracle = _concat_oracle([("a", repo_a[0]), ("b", renamed_b[0])])
    res = _both(lambda s, e: s.Q.logs(
        (s[repo_a], "a"), (s[renamed_b], "b")
    ).using(e).histogram())
    want = np.bincount(oracle.event_activity, minlength=oracle.num_activities)
    np.testing.assert_array_equal(res.value, want)
    assert res.names == oracle.activity_names


def test_union_variants_and_concat_repositories(repo_a, repo_b):
    """``concat_repositories`` equals the reference's and the flat-table
    oracle column for column; the union variants sink runs on exactly that
    concatenation."""
    named = [("a", repo_a[0]), ("b", repo_b[0])]
    cc = port_core.concat_repositories(named)
    _same_repo(cc, ref_core.concat_repositories(
        [("a", repo_a[1]), ("b", repo_b[1])]
    ))
    _same_repo(cc, _concat_oracle(named))
    assert_no_collision(cc)
    res = _both(lambda s, e: s.Q.logs(
        (s[repo_a], "a"), (s[repo_b], "b")
    ).using(e).variants(5))
    assert res.physical.backend == "concat"
    tv = port_core.trace_variants(cc)
    np.testing.assert_array_equal(res.value.counts, tv.counts[:5])
    assert res.value.sequences == tv.sequences[:5]


def test_union_top_variants_materializes_concat(repo_a, renamed_b):
    oracle = _concat_oracle([("a", repo_a[0]), ("b", renamed_b[0])])
    assert_no_collision(oracle)
    res = _both(lambda s, e: s.Q.logs(
        (s[repo_a], "a"), (s[renamed_b], "b")
    ).using(e).top_variants(3).dfg())
    assert res.physical.backend == "concat"
    want = _oracle_dfg(port_core.variant_filtered_repository(oracle, 3))
    np.testing.assert_array_equal(res.value, want)


def test_union_duplicated_source_counts_twice(repo_a):
    """Q.logs(x, x): branch names are uniquified and the union counts every
    branch — the oracle is the doubled count."""
    res = _both(lambda s, e: s.Q.logs(s[repo_a], s[repo_a]).using(e).dfg())
    np.testing.assert_array_equal(res.value, 2 * _oracle_dfg(repo_a[0]))
    assert [n for n, _ in res.trace.branches] == ["l1", "l1#1"]


def test_union_with_empty_branch(repo_a):
    port = port_core.EventRepository(
        event_activity=np.zeros((0,), np.int32),
        event_trace=np.zeros((0,), np.int32),
        event_time=np.zeros((0,), np.float64),
        trace_log=np.zeros((0,), np.int32),
        activity_names=list(repo_a[0].activity_names),
        trace_names=[],
        log_names=["empty"],
    )
    empty = (port, ref_repository(port))
    res = _both(lambda s, e: s.Q.logs(
        (s[repo_a], "a"), (s[empty], "e")
    ).using(e).dfg())
    np.testing.assert_array_equal(res.value, _oracle_dfg(repo_a[0]))


def test_union_process_map_and_neighborhood(repo_a, renamed_b):
    """Topology sinks merge branch Ψ (and histograms) on the union axis and
    derive once at the merge."""
    port_eng, ref_eng = _engines()

    def q(s, e):
        return s.Q.logs((s[repo_a], "a"), (s[renamed_b], "b")).using(e)

    _both(lambda s, e: q(s, e).process_map(top=0.5), port_eng, ref_eng)
    _both(lambda s, e: q(s, e).neighborhood("act_002", k=2,
                                             direction="both"),
          port_eng, ref_eng)
    _both(lambda s, e: q(s, e).neighborhood("nope"), port_eng, ref_eng)


# ---------------------------------------------------------------------------
# memmap branches: mixed physical backends, per-branch delta
# ---------------------------------------------------------------------------


def test_union_mixed_memmap_and_repo(repo_a, two_mmlogs):
    log = two_mmlogs[0]
    res = _both(lambda s, e: s.Q.logs(
        (s[log], "disk"), (s[repo_a], "mem")
    ).using(e).dfg(), memory_budget_events=100)  # the memmap branch streams
    assert "branch[disk]=streaming" in res.physical.notes
    oracle = _concat_oracle([
        ("disk", port_query.repository_from_memmap(log[0], "disk")),
        ("mem", repo_a[0]),
    ])
    np.testing.assert_array_equal(res.value, _oracle_dfg(oracle))


def test_union_delta_rescans_only_the_appended_branch(two_mmlogs, tmp_path):
    """Append to one branch ⇒ the other branch's cached state is untouched;
    only the appended suffix is scanned — in both packages alike."""
    la, lb = _copies(two_mmlogs, tmp_path, "copy")
    port_eng, ref_eng = _engines(memory_budget_events=0)  # streaming-first

    def q(x, y):
        return lambda s, e: s.Q.logs((s[x], "a"), (s[y], "b")).using(e).dfg()

    _both(q(la, lb), port_eng, ref_eng)
    assert port_eng.stats.rows_scanned == la[0].num_events + lb[0].num_events
    assert _both(q(la, lb), port_eng, ref_eng).from_cache

    grown_a = _append_both(la, 150, seed=3)
    base = port_eng.stats.rows_scanned
    res = _both(q(grown_a, lb), port_eng, ref_eng)
    assert not res.from_cache
    assert port_eng.stats.delta_hits == 1
    assert port_eng.stats.rows_scanned - base == 150
    branch_a = dict(res.trace.branches)["a"]
    assert branch_a.executed_backend == "delta"
    assert branch_a.delta_rows == (la[0].num_events, grown_a[0].num_events)
    oracle = _concat_oracle([
        ("a", port_query.repository_from_memmap(grown_a[0], "a")),
        ("b", port_query.repository_from_memmap(lb[0], "b")),
    ])
    np.testing.assert_array_equal(res.value, _oracle_dfg(oracle))

    grown_b = _append_both(lb, 150, seed=4, new_activity=True)
    base = port_eng.stats.rows_scanned
    res2 = _both(q(grown_a, grown_b), port_eng, ref_eng)
    assert port_eng.stats.delta_hits == 2
    assert port_eng.stats.rows_scanned - base == 150
    oracle2 = _concat_oracle([
        ("a", port_query.repository_from_memmap(grown_a[0], "a")),
        ("b", port_query.repository_from_memmap(grown_b[0], "b")),
    ])
    np.testing.assert_array_equal(res2.value, _oracle_dfg(oracle2))


def test_union_empty_window_short_circuits(two_mmlogs):
    """EMPTY_WINDOW under a union: canonical shared plan, zeros, no scan;
    compare's whole-log fitness pays its streaming scans once."""
    la, lb = two_mmlogs
    port_eng, ref_eng = _engines(memory_budget_events=0)

    def q(s, e, w):
        return s.Q.logs((s[la], "a"), (s[lb], "b")).using(e).window(*w)

    for side in (PORT, REF):
        p1, _ = side.query.canonicalize(
            q(side, None, (5.0, 3.0)).logical_plan(side.query.DFGSink())
        )
        p2, _ = side.query.canonicalize(
            q(side, None, (99.0, 7.0)).logical_plan(side.query.DFGSink())
        )
        assert p1.key() == p2.key()
    r1 = _both(lambda s, e: q(s, e, (5.0, 3.0)).dfg(), port_eng, ref_eng)
    assert not r1.value.any() and r1.value.shape[0] == len(r1.names)
    assert port_eng.stats.rows_scanned == 0
    assert _both(lambda s, e: q(s, e, (99.0, 7.0)).dfg(), port_eng,
                 ref_eng).from_cache
    r3 = _both(lambda s, e: q(s, e, (5.0, 3.0)).histogram(), port_eng,
               ref_eng)
    assert not r3.value.any() and port_eng.stats.rows_scanned == 0
    rc = _both(lambda s, e: q(s, e, (5.0, 3.0)).compare(), port_eng, ref_eng)
    assert not any(p.any() for p in rc.value.psis)
    after = port_eng.stats.rows_scanned
    assert after > 0  # real fitness even with budget 0 (streaming)
    rc2 = _both(lambda s, e: q(s, e, (9.0, 2.0)).compare(), port_eng, ref_eng)
    assert rc2.value.fitness == rc.value.fitness
    assert port_eng.stats.rows_scanned == after  # memo: no rescan


def test_union_fingerprint_is_composite_and_prefix_preserving(two_mmlogs):
    got = port_query.fingerprint(
        PORT.Q.logs((two_mmlogs[0][0], "a"), (two_mmlogs[1][0], "b")).source
    )
    want = ref_query.fingerprint(
        REF.Q.logs((two_mmlogs[0][1], "a"), (two_mmlogs[1][1], "b")).source
    )
    assert got == want  # byte-identical keys across the packages
    parts = port_query.split_union_fingerprint(got)
    assert parts == ref_query.split_union_fingerprint(want)
    assert [n for n, _ in parts] == ["a", "b"]
    for (_, bfp), (log, _) in zip(parts, two_mmlogs):
        assert bfp == port_query.fingerprint(log)
        assert bfp.startswith("memmap:")
    assert port_query.split_union_fingerprint("memmap:x:1:2") is None


def test_union_fingerprint_escapes_separator_injection(repo_a, repo_b):
    """A branch name containing '='/'|' cannot forge another union's key."""
    two = port_query.fingerprint(
        PORT.Q.logs((repo_a[0], "a"), (repo_b[0], "b")).source
    )
    forged = f"a={port_query.split_union_fingerprint(two)[0][1]}|b"
    one = port_query.fingerprint(PORT.Q.logs((repo_a[0], forged)).source)
    assert one != two
    assert port_query.split_union_fingerprint(one)[0][0] == forged
    assert one == ref_query.fingerprint(
        REF.Q.logs((repo_a[1], forged)).source
    )


# ---------------------------------------------------------------------------
# FromLogs + compare
# ---------------------------------------------------------------------------


def test_select_logs_is_the_lxt_dice(multilog_repo):
    port, ref = multilog_repo
    sub = port.select_logs(["prod"])
    _same_repo(sub, ref.select_logs(["prod"]))
    assert sub.log_names == ["prod"]
    assert sub.activity_names == port.activity_names
    keep = port.trace_log == port.log_names.index("prod")
    assert sub.num_traces == int(keep.sum())
    _same_repo(port.select_logs(["prod", "canary"]),
               ref.select_logs(["prod", "canary"]))
    with pytest.raises(ValueError, match="unknown log 'nope'"):
        port.select_logs(["nope"])


def test_qlogs_expands_multilog_repository(multilog_repo):
    q = PORT.Q.logs(multilog_repo[0])
    assert isinstance(q.source, port_query.UnionSource)
    assert q.source.branch_names == tuple(multilog_repo[0].log_names)
    res = _both(lambda s, e: s.Q.logs(s[multilog_repo]).using(e).dfg())
    np.testing.assert_array_equal(res.value, _oracle_dfg(multilog_repo[0]))


def test_compare_per_log_oracle_and_drift(multilog_repo):
    res = _both(lambda s, e: s.Q.logs(s[multilog_repo]).using(e).compare())
    assert res.physical.backend == "compare"
    cr = res.value
    assert isinstance(cr, port_query.CompareResult)
    assert cr.log_names == ("canary", "prod")
    port = multilog_repo[0]
    for name, psi in zip(cr.log_names, cr.psis):
        sub = port.select_logs([name])
        np.testing.assert_array_equal(
            psi, _embed(_oracle_dfg(sub), sub.activity_names,
                        port.activity_names)
        )
    np.testing.assert_array_equal(cr.diff, cr.psis[1] - cr.psis[0])
    np.testing.assert_array_equal(cr.drift(1, 0), -cr.diff)
    np.testing.assert_array_equal(cr.diffs[0], np.zeros_like(cr.psis[0]))
    model = _discover(port.select_logs(["canary"]))
    for name, f in zip(cr.log_names, cr.fitness):
        assert f == port_core.replay_fitness(
            port.select_logs([name]), model
        ).fitness
    three = dataclasses.replace(cr, psis=cr.psis + (cr.psis[0],))
    with pytest.raises(ValueError, match="exactly two logs"):
        three.diff


def test_compare_windowed_matches_per_log_reference(multilog_repo):
    ts = multilog_repo[0].event_time
    t0, t1 = float(np.quantile(ts, 0.1)), float(np.quantile(ts, 0.9))
    res = _both(lambda s, e: s.Q.logs(s[multilog_repo]).using(e)
                .window(t0, t1).compare())
    port = multilog_repo[0]
    for name, psi in zip(res.value.log_names, res.value.psis):
        sub = port.select_logs([name])
        np.testing.assert_array_equal(psi, _embed(
            _oracle_dfg(sub, window=(t0, t1)), sub.activity_names,
            port.activity_names,
        ))


def test_compare_fitness_is_whole_log_and_memoized(multilog_repo):
    """fitness is window-independent: an empty or sliding window reports the
    same tuple, served from the per-fingerprint memo."""
    port_eng, ref_eng = _engines()
    base = _both(lambda s, e: s.Q.logs(s[multilog_repo]).using(e).compare(),
                 port_eng, ref_eng).value
    empty = _both(lambda s, e: s.Q.logs(s[multilog_repo]).using(e)
                  .window(5.0, 5.0).compare(), port_eng, ref_eng).value
    assert empty.fitness == base.fitness
    assert not any(p.any() for p in empty.psis)
    calls = []
    real = port_eng._compute_compare_fitness
    port_eng._compute_compare_fitness = lambda u: calls.append(1) or real(u)
    ts = multilog_repo[0].event_time
    for qt in (0.3, 0.6, 0.9):  # a dashboard sliding its window
        t1 = float(np.quantile(ts, qt))
        res = _both(lambda s, e: s.Q.logs(s[multilog_repo]).using(e)
                    .window(0.0, t1).compare(), port_eng, ref_eng)
        assert res.value.fitness == base.fitness
    assert calls == []


def test_concat_rejects_colliding_trace_namespaces():
    for core in (port_core, ref_core):
        r1 = core.EventRepository.from_traces([["p", "q"]],
                                              activity_vocab=["p", "q"])
        r2 = core.EventRepository.from_traces([["p"]],
                                              activity_vocab=["p", "q"])
        r1 = dataclasses.replace(r1, trace_names=["x/t1"])
        with pytest.raises(ValueError, match="collide"):
            core.concat_repositories([("a", r1), ("a/x", r2)])
        with pytest.raises(ValueError, match="duplicate branch names"):
            core.concat_repositories([("a", r1), ("a", r2)])
        with pytest.raises(ValueError, match="not in provided vocabulary"):
            core.concat_repositories([("a", r1)], activity_vocab=["p"])


def test_compare_fitness_streams_beyond_budget(two_mmlogs):
    """Out-of-budget branches report fitness too: discovery and replay run
    as one-pass streaming scans."""
    res = _both(lambda s, e: s.Q.logs(
        (s[two_mmlogs[0]], "a"), (s[two_mmlogs[1]], "b")
    ).using(e).compare(), memory_budget_events=0)
    cr = res.value
    ref = two_mmlogs[0][0]
    from repro_torch.conformance import (
        StreamingModelDiscoverer,
        replay_fitness_streaming,
    )

    d = StreamingModelDiscoverer(ref.num_activities)
    for a, c, t in ref.iter_chunks():
        d.update(a, c, t)
    model = d.finalize(ref.activity_labels())
    assert cr.fitness == tuple(
        replay_fitness_streaming(log, model).fitness for log, _ in two_mmlogs
    )
    np.testing.assert_array_equal(cr.psis[0], _embed(
        port_core.streaming_dfg(ref), ref.activity_labels(), cr.names,
    ))


# ---------------------------------------------------------------------------
# errors + builder edges
# ---------------------------------------------------------------------------


def test_union_and_compare_errors(repo_a, repo_b, two_mmlogs):
    port_eng, ref_eng = _engines()

    def ab(s, e):
        return s.Q.logs((s[repo_a], "a"), (s[repo_b], "b")).using(e)

    cases = [
        lambda s, e: s.Q.logs(),
        lambda s, e: s.Q.log(s[repo_a]).using(e).compare(),
        lambda s, e: s.Q.logs((s[repo_a], "only")).using(e).compare(),
        lambda s, e: ab(s, e).top_variants(2).compare(),
        lambda s, e: ab(s, e).dfg(backend="streaming"),
        lambda s, e: ab(s, e).activities(["nope"]).dfg(),
        lambda s, e: s.query.UnionSource([]),
        lambda s, e: s.query.FromLogs(s[repo_a], ["not-a-log"]),
        lambda s, e: s.Q.logs((s[repo_a], "same"), (s[repo_b], "same")),
        lambda s, e: s.Q.logs(s[repo_a], s[repo_b], names=["l1"]),
        lambda s, e: s.query.LogRef(object(), "x"),
        lambda s, e: s.Q.logs(
            (s[two_mmlogs[0]], "a"), (s[two_mmlogs[1]], "b")
        ).using(s.query.QueryEngine(
            memory_budget_events=100,
            **({"device": "cpu"} if s is PORT
               else {"calibration_path": os.devnull}),
        )).variants(),
    ]
    for fn in cases:
        r = _catch(lambda: fn(REF, ref_eng))
        p = _catch(lambda: fn(PORT, port_eng))
        assert isinstance(r, ref_query.QueryPlanError), r
        assert isinstance(p, port_query.QueryPlanError), p
        assert str(p) == str(r)


def test_qlogs_flattens_and_uniquifies(repo_a, two_mmlogs):
    for side in (PORT, REF):
        inner = side.Q.logs((side[repo_a], "x"), (side[two_mmlogs[0]], "y"))
        outer = side.Q.logs(inner.source, side.query.LogRef(side[repo_a], "z"))
        assert outer.source.branch_names == ("x", "y", "z")
        dup = side.Q.logs(side[repo_a], side[repo_a]).source
        assert dup.branch_names == ("l1", "l1#1")

        def named(n):
            return dataclasses.replace(side[repo_a], log_names=[n])

        tricky = side.Q.logs(named("x#1"), named("x"), named("x")).source
        assert tricky.branch_names == ("x#1", "x", "x#2")
        mm = side.Q.logs(side[two_mmlogs[0]], side[two_mmlogs[1]]).source
        assert mm.branch_names == ("mm0", "mm1")
        assert port_query.source_info  # the planner sees the union below
    info = port_query.source_info(
        PORT.Q.logs((repo_a[0], "x"), (two_mmlogs[0][0], "y")).source
    )
    assert info.kind == "union(repository,memmap)"
    assert info.branch_names == ("x", "y")
    assert info.num_events == repo_a[0].num_events + two_mmlogs[0][0].num_events


def test_single_logref_and_fromlogs_resolve_in_q_log(repo_a, multilog_repo):
    """LogRef/FromLogs are grammar sources: Q.log accepts them too."""
    res = _both(lambda s, e: s.Q.log(s.query.LogRef(s[repo_a], "a"))
                .using(e).dfg())
    np.testing.assert_array_equal(res.value, _oracle_dfg(repo_a[0]))
    res2 = _both(lambda s, e: s.Q.log(s.query.FromLogs(
        s[multilog_repo], ("prod",))).using(e).dfg())
    np.testing.assert_array_equal(
        res2.value, _oracle_dfg(multilog_repo[0].select_logs(["prod"]))
    )


def test_split_logs_equals_select_logs(multilog_repo, monkeypatch):
    port, ref = multilog_repo
    split = port.split_logs(port.log_names)
    want = ref.split_logs(ref.log_names)
    assert list(split) == list(want)
    for name, sub in split.items():
        _same_repo(sub, want[name])
        _same_repo(sub, port.select_logs([name]))
    # Q.logs expansion shares one split pass across sibling branches
    calls = []
    real = port_core.EventRepository.select_logs

    def counting(self, names):
        calls.append(tuple(names))
        return real(self, names)

    monkeypatch.setattr(port_core.EventRepository, "select_logs", counting)
    res = PORT.Q.logs(port).using(_engines()[0]).dfg()
    assert calls == []  # resolved through split_logs, not per-branch dices
    np.testing.assert_array_equal(res.value, _oracle_dfg(port))


def test_union_cache_content_addressed_per_branch(repo_a, repo_b):
    port_eng, ref_eng = _engines()
    clone = dataclasses.replace(
        repo_a[0], event_activity=repo_a[0].event_activity.copy()
    )
    clone = (clone, ref_repository(clone))
    _both(lambda s, e: s.Q.logs((s[repo_a], "a"), (s[repo_b], "b"))
          .using(e).dfg(), port_eng, ref_eng)
    # equal bytes, same branch names → union-level cache hit
    assert _both(lambda s, e: s.Q.logs((s[clone], "a"), (s[repo_b], "b"))
                 .using(e).dfg(), port_eng, ref_eng).from_cache
    # same bytes under a *different* branch name → different provenance,
    # but every branch is a cache hit
    res = _both(lambda s, e: s.Q.logs((s[clone], "a2"), (s[repo_b], "b"))
                .using(e).dfg(), port_eng, ref_eng)
    assert not res.from_cache
    assert all(t.from_cache for _, t in res.trace.branches)


def test_repository_from_memmap_derives_log_name(two_mmlogs):
    port, ref = two_mmlogs[0]
    got = port_query.repository_from_memmap(port)
    assert got.log_names == [port_core.memmap_log_name(port)] == ["mm0"]
    assert port_query.repository_from_memmap(port, "prod").log_names == [
        "prod"
    ]
    from repro.query.execute import repository_from_memmap as ref_from

    _same_repo(port_query.repository_from_memmap(port, "prod"),
               ref_from(ref, "prod"))


def test_port_reads_no_calibration_record(tmp_path, monkeypatch, repo_a,
                                          two_mmlogs):
    """The reference reads its crossovers from calibration records; the
    port plans unions on its static thresholds whatever such a record
    says — equal to a reference engine pointed at no record."""
    bench = tmp_path / "BENCH_query.json"
    bench.write_text('{"calibration": {"tiny_pairs": 777, '
                     '"memory_budget_events": 1048576}}')
    monkeypatch.setenv("GRAPHPM_BENCH_QUERY", str(bench))
    eng = port_query.QueryEngine(device="cpu")
    assert eng.tiny_pairs == port_query.planner.TINY_PAIRS
    assert eng.memory_budget_events == port_query.planner.MEMORY_BUDGET_EVENTS
    _both(lambda s, e: s.Q.logs((s[repo_a], "a"), (s[two_mmlogs[0]], "m"))
          .using(e).dfg(),
          eng, ref_query.QueryEngine(
              calibration_path=os.devnull, graph_crossover=10**9,
              replay_crossover=REPLAY))


def test_explicit_thresholds_steer_union_branches(repo_a, two_mmlogs):
    """Explicit engine thresholds cost each branch alike in both packages:
    a tiny-pairs bound moves the repository branch to numpy, a budget the
    memmap branch to streaming."""
    for kw, want in (
        (dict(tiny_pairs=10**6), ("branch[a]=numpy", "branch[m]=numpy")),
        (dict(tiny_pairs=0, memory_budget_events=10),
         ("branch[a]=scatter", "branch[m]=streaming")),
    ):
        res = _both(lambda s, e: s.Q.logs(
            (s[repo_a], "a"), (s[two_mmlogs[0]], "m")
        ).using(e).dfg(), **kw)
        assert res.physical.notes == want


def test_union_and_compare_match_reference_service_payloads(repo_a, repo_b):
    """The reference serves multi-log requests through ``QueryService``
    (ROADMAP item 10 for the port); the port's ``Q.logs`` answers the same
    union and compare as the service's payloads."""
    from repro.serve import QueryService

    svc = QueryService()
    svc.register("prod", repo_a[1])
    svc.register("canary", repo_b[1])
    eng = _engines()[0]
    out = svc.query({"logs": ["canary", "prod"], "sink": "dfg"})
    got = PORT.Q.logs((repo_b[0], "canary"), (repo_a[0], "prod")).using(
        eng).dfg()
    np.testing.assert_array_equal(got.value, np.asarray(out["psi"]))
    assert got.names == out["names"] and got.physical.backend == "union"
    cmp_out = svc.query({"logs": ["prod", "canary"], "sink": "compare"})
    cr = PORT.Q.logs((repo_a[0], "prod"), (repo_b[0], "canary")).using(
        eng).compare().value
    for name, psi in zip(cr.log_names, cr.psis):
        np.testing.assert_array_equal(psi, np.asarray(cmp_out["psi"][name]))
        assert cr.fitness[cr.log_names.index(name)] == cmp_out["fitness"][name]
    np.testing.assert_array_equal(
        cr.diff, np.asarray(cmp_out["diff"]["canary"])
    )


def test_union_compare_under_a_shared_view_matches_reference_service(
    repo_a,
):
    """Two logs under one view combine in group space (the reference
    service's policy for view-protected unions): the port's compare under
    that view equals the service's payload."""
    from repro.core.views import AccessPolicy
    from repro.serve import QueryService

    mapping = {n: "g" for n in repo_a[0].activity_names[:4]}
    svc = QueryService()
    view = ref_core.ActivityView(mapping)
    svc.register("veiled", repo_a[1], policy=AccessPolicy(view=view))
    svc.register("veiled2", repo_a[1], policy=AccessPolicy(view=view))
    out = svc.query({"logs": ["veiled", "veiled2"], "sink": "compare"})
    cr = PORT.Q.logs((repo_a[0], "veiled"), (repo_a[0], "veiled2")).using(
        _engines()[0]).view(PORT.view(mapping)).compare().value
    assert cr.names == out["names"] == ["g"]
    for name, psi in zip(cr.log_names, cr.psis):
        np.testing.assert_array_equal(psi, np.asarray(out["psi"][name]))


# ---------------------------------------------------------------------------
# union conformance (fitness / alignments)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def conf_logs(tmp_path_factory):
    out = []
    for i, (n, a, seed) in enumerate(((6_000, 12, 11), (3_000, 9, 21))):
        path = str(tmp_path_factory.mktemp("union_conf") / f"mm{i}")
        port_synth.generate_memmap_log(
            path, n, port_synth.ProcessSpec(num_activities=a, seed=seed),
            seed=seed, batch_traces=300,
        )
        out.append(_open_pair(path))
    return out


def _model_pair(repo, **kw):
    port = _discover(repo, **kw)
    spec = port_core.ModelSpec.from_model(port)
    return spec, ref_core_conf.ModelSpec(
        activities=spec.activities, edges=spec.edges,
        starts=spec.starts, ends=spec.ends,
    )


def test_union_fitness_concatenates_branches(conf_logs):
    la, lb = conf_logs
    repo_a = port_query.repository_from_memmap(la[0])
    repo_b = port_query.repository_from_memmap(lb[0])
    model = _model_pair(repo_a, min_count=40, min_dependency=0.3)
    res = _both(lambda s, e: s.Q.logs((s[la], "a"), (s[lb], "b")).using(e)
                .fitness(s[model]))
    fa = port_core.replay_fitness(repo_a, model[0])
    fb = port_core.replay_fitness(repo_b, model[0])
    np.testing.assert_array_equal(
        res.value.trace_fitness,
        np.concatenate([fa.trace_fitness, fb.trace_fitness]),
    )
    want = dict(fa.deviating_edges)
    for k, v in fb.deviating_edges.items():
        want[k] = want.get(k, 0) + v
    assert res.value.deviating_edges == want


def test_union_default_model_is_reference_branch(conf_logs):
    la, lb = conf_logs
    res = _both(lambda s, e: s.Q.logs((s[la], "a"), (s[lb], "b")).using(e)
                .fitness())
    repo_a = port_query.repository_from_memmap(la[0])
    model = _discover(repo_a, min_dependency=0.5)
    np.testing.assert_array_equal(res.value.trace_fitness, np.concatenate([
        port_core.replay_fitness(repo_a, model).trace_fitness,
        port_core.replay_fitness(
            port_query.repository_from_memmap(lb[0]), model
        ).trace_fitness,
    ]))


def test_union_fitness_append_is_suffix_only(conf_logs, tmp_path):
    la, lb = conf_logs
    (lb,) = _copies([lb], tmp_path, "grow")
    model = _model_pair(port_query.repository_from_memmap(la[0]),
                        min_count=40)
    port_eng, ref_eng = _engines(memory_budget_events=1_000,
                                 replay_crossover=1_000)

    def q(x, y):
        return lambda s, e: s.Q.logs((s[x], "a"), (s[y], "b")).using(e) \
            .fitness(s[model])

    _both(q(la, lb), port_eng, ref_eng)
    rows = port_eng.stats.rows_scanned
    grown = _append_both(lb, 300, seed=25)
    res = _both(q(la, grown), port_eng, ref_eng)
    assert port_eng.stats.rows_scanned - rows == 300  # a: hit, b: suffix
    assert port_eng.stats.delta_hits == 1
    branches = dict(res.trace.branches)
    assert branches["a"].from_cache and branches["b"].executed_backend == "delta"
    np.testing.assert_array_equal(res.value.trace_fitness, np.concatenate([
        port_core.replay_fitness(port_query.repository_from_memmap(la[0]),
                                 model[0]).trace_fitness,
        port_core.replay_fitness(port_query.repository_from_memmap(grown[0]),
                                 model[0]).trace_fitness,
    ]))


@pytest.fixture()
def exact_ref_variants(monkeypatch):
    """The reference's alignments read the port's exact variant table (its
    own rolling hash may merge colliding sequences; see
    ``tests/test_torch_conformance.py``)."""

    def exact(event_activity, event_trace, num_traces, activity_names):
        tv = port_variants.variant_table(
            event_activity, event_trace, num_traces, activity_names
        )
        return ref_variants.TraceVariants(
            counts=tv.counts, sequences=tv.sequences,
            trace_variant=tv.trace_variant,
        )

    monkeypatch.setattr(ref_align, "variant_table", exact)


def test_union_alignments_concatenate_branches(exact_ref_variants, repo_a,
                                               renamed_b):
    """Alignments over a union: one DP per branch (the port's kernel path),
    per-trace costs concatenated in branch order, censuses summed; the
    default model is the first branch's.  A renamed vocabulary and a view
    distribute into each branch."""
    port_eng, ref_eng = _engines()

    def q(s, e):
        return s.Q.logs((s[repo_a], "a"), (s[renamed_b], "b")).using(e)

    res = _both(lambda s, e: q(s, e).alignments(), port_eng, ref_eng)
    single_eng = _engines()[0]
    singles = [
        PORT.Q.log(r[0]).using(single_eng).alignments(
            _discover(repo_a[0], min_dependency=0.5)
        ).value
        for r in (repo_a, renamed_b)
    ]
    np.testing.assert_array_equal(
        res.value.trace_cost,
        np.concatenate([v.trace_cost for v in singles]),
    )
    keep = ["act_000", "act_002", "act_003", "new_a"]
    _both(lambda s, e: q(s, e).activities(keep).alignments(), port_eng,
          ref_eng)
    _both(lambda s, e: q(s, e).window(0.0, 30 * 86400.0).alignments(),
          port_eng, ref_eng)


def test_fromlogs_compare_equals_the_branch_compare(repo_a, renamed_b):
    """``Q.logs(u, names=[...])`` over the concatenated multi-log repository
    answers the same Ψ and diffs as the union of the two branches, with
    ``names=`` keeping the first-named log as the reference branch."""
    port_eng, ref_eng = _engines()
    named = [("prod", repo_a), ("canary", renamed_b)]
    u = (port_core.concat_repositories([(n, p[0]) for n, p in named]),
         ref_core.concat_repositories([(n, p[1]) for n, p in named]))
    assert u[0].log_names == ["canary", "prod"]
    direct = _both(lambda s, e: s.Q.logs(
        (s[repo_a], "prod"), (s[renamed_b], "canary")
    ).using(e).compare(), port_eng, ref_eng).value
    via = _both(lambda s, e: s.Q.logs(s[u], names=["prod", "canary"])
                .using(e).compare(), port_eng, ref_eng).value
    assert via.log_names == ("prod", "canary")
    assert via.names == direct.names
    for got, want in zip(via.psis + via.diffs, direct.psis + direct.diffs):
        np.testing.assert_array_equal(got, want)
    model = _discover(u[0].select_logs(["prod"]))
    for name, f in zip(via.log_names, via.fitness):
        assert f == port_core.replay_fitness(
            u[0].select_logs([name]), model
        ).fitness


# ---------------------------------------------------------------------------
# the trace stack
# ---------------------------------------------------------------------------


def test_union_trace_stack_attributes_rows_and_device_phases(
    repo_a, two_mmlogs
):
    """A union's branches run through ``run()`` while the union's trace
    stays open: each branch trace holds its own rows and device phases,
    the union's trace its merge and the branches, and nothing leaks to
    the next query."""
    port_eng, ref_eng = _engines(tiny_pairs=0)  # every branch on a device
    res = _both(lambda s, e: s.Q.logs(
        (s[two_mmlogs[0]], "disk"), (s[repo_a], "mem")
    ).using(e).dfg(), port_eng, ref_eng)
    tr = res.trace
    assert tr.source == "union" and tr.rows_scanned == 0
    disk, mem = (t for _, t in tr.branches)
    assert disk.rows_scanned == two_mmlogs[0][0].num_events
    assert mem.rows_scanned == repo_a[0].num_events
    assert set(disk.notes) >= {"materialize_s", "h2d_s", "kernel_s", "d2h_s"}
    assert set(mem.notes) >= {"h2d_s", "kernel_s", "d2h_s"}
    assert "materialize_s" not in mem.notes
    assert "merge_s" in tr.notes and "h2d_s" not in tr.notes
    for sub in (disk, mem):
        assert sub.trace_id == tr.trace_id  # chained under the union
        assert sub.parent_span_id == tr.span_id
    d = tr.to_dict()
    assert [b["name"] for b in d["branches"]] == ["disk", "mem"]
    assert port_eng._current_trace() is None  # the stack unwound
    # the concatenation path attributes its rows to the union's own trace
    cat = _both(lambda s, e: s.Q.logs(
        (s[two_mmlogs[0]], "disk"), (s[repo_a], "mem")
    ).using(e).top_variants(2).dfg(), port_eng, ref_eng)
    assert cat.trace.rows_scanned == (
        two_mmlogs[0][0].num_events + repo_a[0].num_events
    )
    assert {"concat_s", "barrier_s"} <= set(cat.trace.notes)
    # a failing branch pops every level
    with pytest.raises(port_query.QueryPlanError):
        PORT.Q.logs((repo_a[0], "a"), (two_mmlogs[0][0], "m")).using(
            port_eng).neighborhood("nope")
    assert port_eng._current_trace() is None
    nxt = PORT.Q.log(repo_a[0]).using(port_eng).histogram()
    assert nxt.trace.parent_span_id is None and not nxt.trace.branches


# ---------------------------------------------------------------------------
# property: random splits into branches
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(
    seed=st.integers(0, 2**16),
    n_branches=st.integers(1, 4),
    rename=st.booleans(),
    windowed=st.booleans(),
    filtered=st.booleans(),
    viewed=st.booleans(),
)
def test_random_splits_union_equals_algorithm1_on_the_concatenation(
    seed, n_branches, rename, windowed, filtered, viewed
):
    """A random log split into branches (some with renamed vocabularies),
    queried as a union with a random window, filter and view: Ψ equals
    Algorithm 1 on ``concat_repositories`` of the branches, and the
    reference's union."""
    rng = np.random.default_rng(seed)
    base = port_synth.generate_repository(
        int(rng.integers(5, 40)),
        port_synth.ProcessSpec(num_activities=int(rng.integers(3, 9)),
                               seed=seed % 97),
        seed=seed % 97,
    )
    cut = np.sort(rng.choice(np.arange(1, max(base.num_traces, 2)),
                             min(n_branches - 1, base.num_traces - 1),
                             replace=False))
    groups = np.split(np.arange(base.num_traces), cut)
    pairs = []
    for i, g in enumerate(groups):
        lids = np.zeros(base.num_traces, dtype=np.int32)
        lids[g] = 1
        tagged = dataclasses.replace(base, trace_log=lids,
                                     log_names=["rest", "me"])
        sub = tagged.select_logs(["me"])
        if rename and i % 2:
            sub = dataclasses.replace(sub, activity_names=[
                f"r{i}_{n}" if j % 2 else n
                for j, n in enumerate(sub.activity_names)
            ])
        pairs.append((f"b{i}", (sub, ref_repository(sub))))
    oracle = port_core.concat_repositories([(n, p[0]) for n, p in pairs])
    names = oracle.activity_names
    ts = oracle.event_time
    window = (float(np.quantile(ts, 0.2)), float(np.quantile(ts, 0.8))) \
        if windowed and ts.size else None
    keep = sorted(rng.choice(names, max(1, len(names) // 2),
                             replace=False).tolist()) if filtered else None
    mapping = {n: f"g{j % 3}" for j, n in enumerate(names) if j % 4} \
        if viewed else None

    def fn(s, e):
        q = s.Q.logs(*[(s[p], n) for n, p in pairs]).using(e)
        if window:
            q = q.window(*window)
        if keep:
            q = q.activities(keep)
        if mapping:
            q = q.view(s.view(mapping))
        return q.dfg()

    res = _both(fn)
    want = _oracle_dfg(
        oracle, window=window, keep=keep,
        view=port_core.ActivityView(mapping) if mapping else None,
    )
    np.testing.assert_array_equal(res.value, want)
