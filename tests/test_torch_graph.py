"""The graph tier of the port (``repro_torch.graph`` + the engine's graph,
histogram and topology paths) against the reference (``repro.graph``,
``repro.query``) on the CPU.

The same seeded sources — a 500-trace repository with 13 activities and a
20,000-event memmap log with 14 activities, the sizes of
``tests/test_graph_store.py`` — go through both packages.  Every tolerance
is 0: counts are integers, so graphs, snapshots, histograms, process maps
and neighborhoods must agree exactly.  The reference's Pallas kernels run
in interpret mode; the port's kernels run their plain versions on CPU
tensors.
"""

import dataclasses
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.synthetic_log as ref_synth
import repro.graph as ref_graph
import repro.graph.build as ref_build
import repro.graph.store as ref_store
import repro.query as ref_query
import repro_torch.data.synthetic_log as port_synth
import repro_torch.graph as port_graph
import repro_torch.graph.build as port_build
import repro_torch.graph.store as port_store
import repro_torch.query as port_query
import repro_torch.query.execute as port_execute
from repro.core.streaming import MemmapLog as RefMemmapLog
from repro.kernels.segment_count import segment_count as ref_segment_count
from repro.query.cache import fingerprint_memmap as ref_fingerprint_memmap
from repro_torch.core.dfg import dfg_numpy
from repro_torch.core.streaming import MemmapLog as PortMemmapLog
from repro_torch.core.views import ActivityView
from repro_torch.kernels.segment_count import ops as seg_ops
from repro_torch.query.cache import fingerprint_memmap, fingerprint_repository
from repro_torch.query.planner import (
    DEVICE_BYTES_PER_EVENT,
    DEVICE_RESERVED_BYTES,
    HOST_BYTES_PER_EVENT,
    MEMORY_BUDGET_EVENTS,
    device_memory_budget,
)
from torch_parity import port_backend, ref_backend

DAY = 86400.0
#: the windows of tests/test_torch_query.py's chains
WINDOWS = [
    (10 * DAY, 80 * DAY), (50 * DAY, 20 * DAY), (0.0, 90 * DAY),
    (30 * DAY, 1e9), (5 * DAY, 60 * DAY), (0.0, 100 * DAY),
]
CENTER = "act_002"
#: name → list of (method, args) applied to Q.log(source); the repository
#: and the memmap log both label their activities ``act_NNN``
CHAINS = {
    "plain": [],
    "window": [("window", (10 * DAY, 80 * DAY))],
    "empty_window": [("window", (50 * DAY, 20 * DAY))],
    "activities": [
        ("activities", ([f"act_{i:03d}" for i in (0, 2, 3, 5, 8, 12)],)),
    ],
    # act_000 hidden, act_002 keeps its own label, the rest in two groups
    "view": [("view", ({
        f"act_{i:03d}": (CENTER if i == 2 else f"g{i % 2}")
        for i in range(1, 13)
    },))],
}
SINKS = {
    "dfg": lambda q, b: q.dfg(backend=b),
    "histogram": lambda q, b: q.histogram(backend=b),
    "process_map": lambda q, b: q.process_map(top=0.5, backend=b),
    "neighborhood": lambda q, b: q.neighborhood(
        CENTER, k=2, direction="both", backend=b
    ),
}


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def repos():
    spec = dict(num_activities=13, seed=17)
    ref = ref_synth.generate_repository(500, ref_synth.ProcessSpec(**spec))
    port = port_synth.generate_repository(500, port_synth.ProcessSpec(**spec))
    np.testing.assert_array_equal(port.event_activity, ref.event_activity)
    np.testing.assert_array_equal(port.event_time, ref.event_time)
    assert port.activity_names == ref.activity_names
    return ref, port


def _make_log(path):
    log = port_synth.generate_memmap_log(
        str(path), 20_000, port_synth.ProcessSpec(num_activities=14, seed=21),
        seed=21,
    )
    _check_f32_exact(np.asarray(log.time))
    return log


@pytest.fixture(scope="module")
def mm_path(tmp_path_factory):
    """A memmap log no test modifies."""
    return _make_log(tmp_path_factory.mktemp("torch_graph") / "log").path


@pytest.fixture()
def fresh_log(tmp_path):
    """A memmap log a test may append to or rewrite."""
    return _make_log(tmp_path / "log")


def _check_f32_exact(ts):
    """The reference's fused kernel compares f32 timestamps; every test
    window selects the same events in f32 and f64 on this log."""
    t32 = ts.astype(np.float32)
    for t0, t1 in WINDOWS:
        w32 = np.float32(t0), np.float32(min(t1, 3e38))
        np.testing.assert_array_equal(
            (ts >= t0) & (ts < t1), (t32 >= w32[0]) & (t32 < w32[1])
        )


def _append_batch(log, n, seed=1, new_activity=False):
    rng = np.random.default_rng(seed)
    hi = log.num_activities + (1 if new_activity else 0)
    act = rng.integers(0, hi, n).astype(np.int32)
    if new_activity:
        act[0] = hi - 1  # make sure the new id actually occurs
    case = rng.integers(0, log.num_traces, n).astype(np.int32)
    times = float(log.time[-1]) + np.sort(rng.uniform(0.0, 100.0, n))
    return log.append(act, case, times)


def _rewrite_first_activity(log):
    arr = np.memmap(
        os.path.join(log.path, "activity.i32"), dtype=np.int32, mode="r+",
        shape=(log.num_events,),
    )
    arr[0] = (int(arr[0]) + 1) % log.num_activities
    arr.flush()
    del arr


# ---------------------------------------------------------------------------
# Comparison helpers
# ---------------------------------------------------------------------------

_TABLES = (
    "event_activity", "event_trace", "event_time",
    "act_indptr", "act_events", "case_indptr",
)


def _same_array(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _same_csr(got, want):
    for f in ("indptr", "indices", "counts"):
        _same_array(getattr(got, f), getattr(want, f))


def _same_graph(got, want):
    assert got.activity_names == want.activity_names
    assert (got.num_events, got.num_traces, got.rows_end, got.source_fp) == (
        want.num_events, want.num_traces, want.rows_end, want.source_fp
    )
    _same_array(got.node_counts, want.node_counts)
    _same_csr(got.adj, want.adj)
    _same_csr(got.radj, want.radj)
    assert got.has_event_tables == want.has_event_tables
    for f in _TABLES:
        if want.has_event_tables:
            _same_array(getattr(got, f), getattr(want, f))
        else:
            assert getattr(got, f) is None
    assert (got.miner is None) == (want.miner is None)
    if want.miner is not None:
        _same_array(got.miner.psi, want.miner.psi)
        assert got.miner.last_by_case == want.miner.last_by_case
        assert got.miner.events_seen == want.miner.events_seen


def _same_value(got, want):
    if isinstance(want, np.ndarray):
        _same_array(got, want)
        return
    assert type(got).__name__ == type(want).__name__
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys()
    for k in w:
        if isinstance(w[k], np.ndarray):
            _same_array(g[k], w[k])
        else:
            assert g[k] == w[k], k


# ---------------------------------------------------------------------------
# B3: segment_count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,n,with_reference", [
    (1, 0, True), (1, 1, True), (13, 1000, True), (600, 20_000, True),
    (600, 7, True), (70_000, 20_000, False),
])
def test_segment_count_plain_matches_reference_and_bincount(s, n, with_reference):
    rng = np.random.default_rng(s + n)
    ids = rng.integers(-3, s + 4, n).astype(np.int32)  # some out of range
    valid = rng.random(n) < 0.7
    keep = valid & (ids >= 0) & (ids < s)
    want = np.bincount(ids[keep], minlength=s).astype(np.int64)
    got = seg_ops.segment_count_plain(
        torch.from_numpy(ids), torch.from_numpy(valid), num_segments=s
    )
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if with_reference:
        ref = ref_segment_count(
            jnp.asarray(ids), jnp.asarray(valid), num_segments=s
        )
        np.testing.assert_array_equal(np.asarray(ref), want)


def test_segment_count_on_cpu_tensors_runs_the_plain_version():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 600, 10_000)
    valid = rng.random(10_000) < 0.6
    wide = ids.copy()
    wide[::7] += 1 << 32  # beyond int32: dropped, never wrapped
    before = dict(seg_ops.launch_counts)
    cases = [
        (torch.from_numpy(ids.astype(np.int16)), None, ids, None),
        (torch.from_numpy(wide), torch.from_numpy(valid), wide, valid),
        (torch.from_numpy(ids), torch.from_numpy(valid.astype(np.int32)),
         ids, valid),
        (torch.from_numpy(ids), torch.from_numpy(valid.astype(np.float32)),
         ids, valid),
    ]
    for t_ids, t_valid, np_ids, np_valid in cases:
        keep = (np_ids >= 0) & (np_ids < 600)
        if np_valid is not None:
            keep &= np_valid
        got = seg_ops.segment_count(t_ids, t_valid, num_segments=600)
        assert got.device.type == "cpu" and got.dtype == torch.int64
        np.testing.assert_array_equal(
            got.numpy(), np.bincount(np_ids[keep], minlength=600)
        )
    assert seg_ops.launch_counts == before  # nothing launched on the host


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "numpy", "scatter", "onehot", "kernel"])
def test_repository_build_matches_reference(repos, backend):
    ref_repo, port_repo = repos
    want = ref_graph.build_graph(ref_repo, backend=ref_backend(backend))
    got = port_graph.build_graph(port_repo, backend=backend, device="cpu")
    _same_graph(got, want)


@pytest.mark.parametrize("backend", ["auto", "kernel"])
@pytest.mark.parametrize("tier", ["full", "topology_only"])
def test_memmap_build_matches_reference(mm_path, tier, backend):
    budget = None if tier == "full" else 100
    ref_log, port_log = RefMemmapLog.open(mm_path), PortMemmapLog.open(mm_path)
    fp = fingerprint_memmap(port_log)
    assert fp == ref_fingerprint_memmap(ref_log)
    want = ref_graph.build_graph(
        ref_log, backend=ref_backend(backend), memory_budget_events=budget,
        source_fp=fp,
    )
    got = port_graph.build_graph(
        port_log, backend=backend, memory_budget_events=budget,
        source_fp=fp, device="cpu",
    )
    assert got.has_event_tables == (tier == "full")
    _same_graph(got, want)


def test_build_rejects_the_reference_backend_name(repos):
    with pytest.raises(ValueError, match="kernel"):
        port_graph.build_graph(repos[1], backend="pallas", device="cpu")


def test_sparse_aggregation_matches_dense_and_reference(repos):
    ref_repo, port_repo = repos
    src, dst, valid = port_repo.df_pairs()
    a = port_repo.num_activities
    got = port_build._aggregate_pairs_sparse(src, dst, valid, a)
    _same_csr(got, port_graph.csr_from_dense(dfg_numpy(src, dst, valid, a)))
    _same_csr(got, ref_build._aggregate_pairs_sparse(*ref_repo.df_pairs(), a))
    np.testing.assert_array_equal(
        port_graph.dense_from_csr(got), dfg_numpy(src, dst, valid, a)
    )


@pytest.mark.parametrize("window", WINDOWS)
def test_window_index_matches_reference(mm_path, window):
    want_g = ref_graph.build_graph(RefMemmapLog.open(mm_path))
    got_g = port_graph.build_graph(PortMemmapLog.open(mm_path), device="cpu")
    want, got = want_g.window_index(), got_g.window_index()
    assert got is not None and got is got_g.window_index()  # built once
    for f in ("etimes", "eacts", "pt_src", "pt_dst", "psrc", "pdst"):
        _same_array(getattr(got, f), getattr(want, f))
    a = got_g.num_activities
    for g_part, w_part in zip(got.query(*window, a), want.query(*window, a)):
        _same_array(g_part, w_part)


# ---------------------------------------------------------------------------
# Persistence: snapshots across packages, append → extend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["repository", "memmap"])
def test_snapshots_load_across_packages(repos, mm_path, tmp_path, source):
    if source == "repository":
        ref_src, port_src = repos
        fp = fingerprint_repository(port_src)
    else:
        ref_src, port_src = RefMemmapLog.open(mm_path), PortMemmapLog.open(mm_path)
        fp = fingerprint_memmap(port_src)
    ref_g = ref_graph.build_graph(ref_src, source_fp=fp)
    port_g = port_graph.build_graph(port_src, source_fp=fp, device="cpu")
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_graph.save_graph(ref_g, ref_dir)
    port_graph.save_graph(port_g, port_dir)
    assert sorted(os.listdir(ref_dir)) == sorted(os.listdir(port_dir))
    for name in os.listdir(ref_dir):
        if name.endswith(".npy"):
            _same_array(np.load(os.path.join(port_dir, name)),
                        np.load(os.path.join(ref_dir, name)))
    with open(os.path.join(ref_dir, "meta.json")) as f:
        ref_meta = f.read()
    with open(os.path.join(port_dir, "meta.json")) as f:
        port_meta = f.read()
    assert json.loads(port_meta) == json.loads(ref_meta)
    # each package opens the other's snapshot
    _same_graph(port_graph.load_graph(ref_dir), ref_g)
    _same_graph(ref_graph.load_graph(port_dir), port_g)


@pytest.mark.parametrize("new_activity", [False, True])
def test_append_extend_equals_fresh_build_in_both_packages(
    fresh_log, tmp_path, new_activity
):
    fp0 = fingerprint_memmap(fresh_log)
    port_graph.save_graph(
        port_graph.build_graph(fresh_log, source_fp=fp0, device="cpu"),
        str(tmp_path / "snap"),
    )
    grown = _append_batch(fresh_log, 700, new_activity=new_activity)
    fp1 = fingerprint_memmap(grown)
    ref_grown = RefMemmapLog.open(grown.path)
    fresh = port_graph.build_graph(grown, source_fp=fp1, device="cpu")
    for pkg, store, log in (
        (port_graph, port_store, grown), (ref_graph, ref_store, ref_grown),
    ):
        loaded = pkg.load_graph(str(tmp_path / "snap"))
        assert store._proves_append_only(loaded, log)
        ext = pkg.extend_graph(loaded, log)
        assert ext.source_fp == fp1
        _same_graph(ext, fresh)


def test_rewritten_log_fails_the_proof_in_both_packages(fresh_log):
    fp0 = fingerprint_memmap(fresh_log)
    port_g = port_graph.build_graph(fresh_log, source_fp=fp0, device="cpu")
    ref_g = ref_graph.build_graph(
        RefMemmapLog.open(fresh_log.path), source_fp=fp0
    )
    _rewrite_first_activity(fresh_log)
    grown = _append_batch(fresh_log, 100)
    assert not port_store._proves_append_only(port_g, grown)
    assert not ref_store._proves_append_only(
        ref_g, RefMemmapLog.open(grown.path)
    )


# ---------------------------------------------------------------------------
# GraphStore
# ---------------------------------------------------------------------------


def test_graph_store_hit_extend_rebuild_spill_pagein(repos, fresh_log, tmp_path):
    """The same request sequence through both packages' stores gives the
    same stats, rows and graphs."""
    ref_repo, port_repo = repos
    stores = (
        port_store.GraphStore(
            max_graphs=1, spill_dir=str(tmp_path / "port"), device="cpu"
        ),
        ref_store.GraphStore(max_graphs=1, spill_dir=str(tmp_path / "ref")),
    )
    results = ([], [])

    def request(port_src, ref_src, fp):
        for store, src, out in zip(stores, (port_src, ref_src), results):
            rows = []
            out.append((store.graph_for(src, fp, on_rows=rows.append), rows))

    def request_log(log):
        request(log, RefMemmapLog.open(log.path), fingerprint_memmap(log))

    log0 = fresh_log
    request_log(log0)                                         # build
    request_log(log0)                                         # hit
    request(port_repo, ref_repo, fingerprint_repository(port_repo))  # spill
    request_log(log0)                                         # page in
    grown = _append_batch(log0, 500)
    request_log(grown)                                        # extend
    _rewrite_first_activity(grown)
    grown2 = _append_batch(PortMemmapLog.open(grown.path), 50, seed=2)
    request_log(grown2)                                       # rebuild
    want = {"builds": 3, "extends": 1, "hits": 1, "spills": 3, "pageins": 1}
    for store in stores:
        assert dataclasses.asdict(store.stats) == want
    for (pg, prows), (rg, rrows) in zip(*results):
        assert prows == rrows
        _same_graph(pg, rg)
    assert [rows for _, rows in results[0]] == [
        [log0.num_events], [], [port_repo.num_events], [], [500],
        [grown2.num_events],
    ]


def test_graph_store_concurrent_requests_build_once(repos):
    store = port_store.GraphStore(device="cpu")
    repo = repos[1]
    fp = fingerprint_repository(repo)
    out, errors = [], []

    def worker():
        try:
            out.append(store.graph_for(repo, fp))
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(out) == 8
    assert store.stats.builds == 1 and store.stats.hits == 7
    assert all(g is out[0] for g in out)


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------


def test_traverse_functions_match_reference(repos):
    ref_repo, port_repo = repos
    ref_g = ref_graph.build_graph(ref_repo)
    port_g = port_graph.build_graph(port_repo, device="cpu")
    names = port_g.activity_names
    _same_array(port_graph.dfg_from_graph(port_g), ref_graph.dfg_from_graph(ref_g))
    for center in names[:4]:
        for k in (1, 2, 3):
            for direction in ("out", "in", "both"):
                _same_value(
                    port_graph.neighborhood(port_g, center, k, direction),
                    ref_graph.neighborhood(ref_g, center, k, direction),
                )
    for top, edge_top in ((0.2, None), (0.5, 0.3), (1.0, None)):
        _same_value(
            port_graph.process_map(port_g, top, edge_top),
            ref_graph.process_map(ref_g, top, edge_top),
        )
    for s, d in ((names[0], names[3]), (names[2], names[2])):
        _same_array(
            port_graph.path_frequencies(port_g, s, d, max_hops=4),
            ref_graph.path_frequencies(ref_g, s, d, max_hops=4),
        )
    with pytest.raises(ValueError):
        port_graph.process_map(port_g, top=0.0)
    with pytest.raises(ValueError):
        port_graph.neighborhood(port_g, "nope")


# ---------------------------------------------------------------------------
# Engine: the new sinks on every backend ≡ the reference engine
# ---------------------------------------------------------------------------


def _engines(**kw):
    # the reference reads calibration records unless pointed at none
    ref = ref_query.QueryEngine(
        calibration_path=os.devnull, tiny_pairs=64, **kw
    )
    port = port_query.QueryEngine(device="cpu", tiny_pairs=64, **kw)
    return ref, port


def _build(q, chain):
    for method, args in chain:
        if method == "view" and isinstance(q, port_query.Query):
            args = (ActivityView(dict(args[0])),)
        q = getattr(q, method)(*args)
    return q


def _run_both(ref_q, port_q, sink, backend):
    """Run one sink on both engines: both raise QueryPlanError, or both
    answer.  Returns the two results (None when both raised)."""
    try:
        ref_res = SINKS[sink](ref_q, ref_backend(backend))
    except ref_query.QueryPlanError:
        with pytest.raises(port_query.QueryPlanError):
            SINKS[sink](port_q, backend)
        return None, None
    return ref_res, SINKS[sink](port_q, backend)


def _assert_same_result(ref_res, port_res):
    assert port_res.names == ref_res.names
    _same_value(port_res.value, ref_res.value)
    rp, pp = ref_res.physical, port_res.physical
    assert pp.backend == port_backend(rp.backend)
    for f in ("materialize", "row_range_window", "fused_dicing",
              "view_pushdown", "activities_as_output_mask"):
        assert getattr(pp, f) == getattr(rp, f), f
    assert port_res.logical._payload()[1] == ref_res.logical._payload()[1]
    if port_res.logical.sink.backend == ref_res.logical.sink.backend:
        assert port_res.logical.key() == ref_res.logical.key()


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("backend", ["auto", "numpy", "kernel", "graph", "streaming"])
@pytest.mark.parametrize("sink", sorted(SINKS))
@pytest.mark.parametrize("source", ["repository", "memmap"])
def test_engine_sinks_match_reference(repos, mm_path, source, sink, backend, chain):
    ref_eng, port_eng = _engines(graph_crossover=3)
    if source == "repository":
        ref_src, port_src = repos
    else:
        ref_src, port_src = RefMemmapLog.open(mm_path), PortMemmapLog.open(mm_path)
    ref_q = _build(ref_query.Q.log(ref_src).using(ref_eng), CHAINS[chain])
    port_q = _build(port_query.Q.log(port_src).using(port_eng), CHAINS[chain])
    ref_res, port_res = _run_both(ref_q, port_q, sink, backend)
    if ref_res is None:
        return
    _assert_same_result(ref_res, port_res)
    assert port_eng.stats.rows_scanned == ref_eng.stats.rows_scanned
    assert port_eng.stats.graph_queries == ref_eng.stats.graph_queries
    assert dataclasses.asdict(port_eng.graphs.stats) == dataclasses.asdict(
        ref_eng.graphs.stats
    )


def test_auto_reaches_graph_on_the_third_miss(repos):
    ref_eng, port_eng = _engines(graph_crossover=3)
    for eng, repo, Q in (
        (port_eng, repos[1], port_query.Q),
        (ref_eng, repos[0], ref_query.Q),
    ):
        names = repo.activity_names
        backends = [
            Q.log(repo).using(eng).neighborhood(names[i]).physical.backend
            for i in range(3)
        ]
        assert "graph" not in backends[:2] and backends[2] == "graph"
        # every later topology query is a store lookup
        assert Q.log(repo).using(eng).process_map(top=0.5).physical.backend == "graph"
        assert Q.log(repo).using(eng).dfg().physical.backend == "graph"
        assert eng.graphs.stats.builds == 1
        assert eng.stats.graph_queries == 3
    assert port_eng.stats.rows_scanned == ref_eng.stats.rows_scanned


def test_cache_hits_do_not_advance_the_crossover(repos):
    _, port_eng = _engines(graph_crossover=3)
    repo = repos[1]
    for _ in range(5):  # one miss + four hits
        res = port_query.Q.log(repo).using(port_eng).process_map(top=0.5)
    assert res.from_cache and res.physical.backend != "graph"
    assert port_eng.graphs.stats.builds == 0
    assert port_eng.stats.cache_hits == 4


def test_windowed_graph_queries_on_a_topology_only_graph_raise(mm_path):
    log = PortMemmapLog.open(mm_path)
    eng = port_query.QueryEngine(device="cpu", memory_budget_events=0)
    q = port_query.Q.log(log).using(eng)
    for call in (
        lambda: q.window(0.0, 1e12).dfg(backend="graph"),
        lambda: q.window(0.0, 1e12).histogram(backend="graph"),
        lambda: q.window(0.0, 1e12).process_map(backend="graph"),
    ):
        with pytest.raises(port_query.QueryPlanError, match="topology-only"):
            call()
    # un-windowed graph queries on the same log build a topology-only graph
    res = q.process_map(top=0.5, backend="graph")
    assert res.physical.backend == "graph"
    assert not eng.graphs.get(fingerprint_memmap(log)).has_event_tables


def test_engine_extends_its_graph_over_an_append(fresh_log):
    eng = port_query.QueryEngine(device="cpu", graph_crossover=3)
    port_query.Q.log(fresh_log).using(eng).dfg(backend="graph")
    assert eng.stats.rows_scanned == fresh_log.num_events
    grown = _append_batch(fresh_log, 200)
    again = port_query.Q.log(grown).using(eng).neighborhood(
        CENTER, k=2, backend="graph"
    )
    assert eng.stats.rows_scanned == grown.num_events  # + the suffix only
    assert eng.graphs.stats.extends == 1 and eng.graphs.stats.builds == 1
    ref_q = ref_query.Q.log(RefMemmapLog.open(grown.path)).using(
        ref_query.QueryEngine(calibration_path=os.devnull)
    )
    _same_value(
        again.value, ref_q.neighborhood(CENTER, k=2, backend="numpy").value
    )
    _same_value(
        port_query.Q.log(grown).using(eng).dfg(backend="graph").value,
        ref_q.dfg(backend="numpy").value,
    )


# ---------------------------------------------------------------------------
# The memory budget
# ---------------------------------------------------------------------------


def test_device_memory_budget_is_pinned():
    gib = 1 << 30
    # an 80 GB card beside a 96 GiB host: the host bounds it
    assert device_memory_budget(80 * 10**9, 96 * gib) == 322_122_547
    assert 322_122_547 == (96 * gib // 2) // HOST_BYTES_PER_EVENT
    # a small card beside a large host: the card bounds it
    dev = 2 * (DEVICE_RESERVED_BYTES + DEVICE_BYTES_PER_EVENT * 50_000_000)
    assert device_memory_budget(dev, 1 << 50) == 50_000_000
    # never below the static floor
    assert device_memory_budget(0, 0) == MEMORY_BUDGET_EVENTS == 1 << 22
    # never above what the count kernel takes in one launch
    assert device_memory_budget(1 << 50, 1 << 50) == 1 << 31


def test_engine_budget_comes_from_the_card(monkeypatch):
    assert port_query.QueryEngine(device="cpu").memory_budget_events == 1 << 22
    assert port_query.QueryEngine(
        device="cpu", memory_budget_events=123
    ).memory_budget_events == 123
    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(
        torch.cuda, "mem_get_info", lambda device=None: (79 * gib, 80 * gib)
    )
    monkeypatch.setattr(port_execute, "_host_free_bytes", lambda: 90 * gib)
    eng = port_query.QueryEngine()
    want = device_memory_budget(79 * gib, 90 * gib)
    assert eng.memory_budget_events == want == (45 * gib) // HOST_BYTES_PER_EVENT
    assert eng.graphs.memory_budget_events == want
    assert port_query.QueryEngine(
        memory_budget_events=5
    ).memory_budget_events == 5
