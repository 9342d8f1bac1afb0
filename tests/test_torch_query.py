"""The slice as a whole: the same seeded sources go through the reference
engine (``repro.query``) and the port's engine (``repro_torch.query``,
``device="cpu"``) with the same chains, and Ψ, names and physical plans
must agree — Ψ bit for bit (tolerance 0), backends through the
``pallas ↔ kernel`` helper."""

import json
import os
import sys

import numpy as np
import pytest

import repro.data.synthetic_log as ref_synth
import repro.launch.mine as ref_mine
import repro.query as ref_query
import repro_torch.data.synthetic_log as port_synth
import repro_torch.query as port_query
from repro.core.streaming import MemmapLog as RefMemmapLog
from repro_torch.core.streaming import MemmapLog as PortMemmapLog
from repro_torch.core.views import ActivityView
from repro_torch.launch import mine as port_mine
from torch_parity import port_backend, ref_backend

DAY = 86400.0
A = 14
TINY = 64

#: name → list of (method, args) applied to Q.log(source)
CHAINS = {
    "plain": [],
    "window": [("window", (10 * DAY, 80 * DAY))],
    "empty_window": [("window", (50 * DAY, 20 * DAY))],
    "fused_windows": [("window", (0.0, 90 * DAY)), ("window", (30 * DAY, 1e9))],
    "activities": [("activities", ([f"act_{i:03d}" for i in (0, 2, 3, 5, 8, 13)],))],
    "window_activities": [
        ("window", (5 * DAY, 60 * DAY)),
        ("activities", ([f"act_{i:03d}" for i in range(0, A, 2)],)),
    ],
    # one hidden activity, the rest visible as themselves: A labels, no
    # pushdown
    "view": [("view", ({f"act_{i:03d}": f"act_{i:03d}" for i in range(1, A)},))],
    # three groups: counted at G×G below the projection
    "view_pushdown": [
        ("window", (0.0, 100 * DAY)),
        ("view", ({f"act_{i:03d}": f"g{i % 3}" for i in range(A - 2)},)),
    ],
    "activities_view_pushdown": [
        ("activities", ([f"act_{i:03d}" for i in range(1, A)],)),
        ("view", ({f"act_{i:03d}": f"g{i % 4}" for i in range(A)},)),
    ],
}
WINDOWS = [
    args for chain in CHAINS.values() for m, args in chain if m == "window"
]


def _build(q, chain):
    for method, args in chain:
        if method == "view" and isinstance(q, port_query.Query):
            args = (ActivityView(dict(args[0])),)
        q = getattr(q, method)(*args)
    return q


@pytest.fixture(scope="module")
def repos():
    spec = dict(num_activities=A, seed=6)
    ref = ref_synth.generate_repository(
        250, ref_synth.ProcessSpec(**spec), seed=6
    )
    port = port_synth.generate_repository(
        250, port_synth.ProcessSpec(**spec), seed=6
    )
    _check_f32_exact(ref.event_time)
    return ref, port


@pytest.fixture(scope="module")
def memmap_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_query") / "log")
    log = port_synth.generate_memmap_log(
        path, 3000, port_synth.ProcessSpec(num_activities=A, seed=9), seed=9,
        batch_traces=60,
    )
    _check_f32_exact(np.asarray(log.time))
    return path


def _check_f32_exact(ts):
    """The reference's fused kernel compares f32 timestamps; on these
    sources every test window selects the same events in f32 and f64, so
    the comparison with the port's f64 compare is meaningful."""
    t32 = ts.astype(np.float32)
    for t0, t1 in WINDOWS:
        w32 = np.float32(t0), np.float32(min(t1, 3e38))
        np.testing.assert_array_equal(
            (ts >= t0) & (ts < t1), (t32 >= w32[0]) & (t32 < w32[1])
        )


def _engines(**kw):
    # the reference reads crossover curves from its committed calibration
    # records unless it is pointed at none; the port reads none at all.
    # Both keep repeated queries off their graph tiers.
    ref = ref_query.QueryEngine(
        graph_crossover=10**9, calibration_path=os.devnull, **kw
    )
    port = port_query.QueryEngine(device="cpu", graph_crossover=10**9, **kw)
    return ref, port


def _assert_same(ref_res, port_res):
    assert port_res.names == ref_res.names
    assert port_res.value.dtype == np.int64
    np.testing.assert_array_equal(port_res.value, ref_res.value)
    rp, pp = ref_res.physical, port_res.physical
    assert pp.backend == port_backend(rp.backend)
    assert pp.fused_dicing == rp.fused_dicing
    assert pp.view_pushdown == rp.view_pushdown
    assert pp.activities_as_output_mask == rp.activities_as_output_mask
    assert pp.materialize == rp.materialize
    assert pp.row_range_window == rp.row_range_window
    # the canonical plans agree op for op; with a shared backend name the
    # plan keys (the cache key half owned by the plan) agree too
    assert port_res.logical._payload()[1] == ref_res.logical._payload()[1]
    assert port_res.rewrites == ref_res.rewrites
    if port_res.logical.sink.backend == ref_res.logical.sink.backend:
        assert port_res.logical.key() == ref_res.logical.key()


@pytest.mark.parametrize("backend", ["auto", "numpy", "scatter", "onehot", "kernel"])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_repository_chain_matches_reference(repos, chain, backend):
    ref_repo, port_repo = repos
    ref_eng, port_eng = _engines(tiny_pairs=TINY, memory_budget_events=1 << 20)
    ref_res = _build(ref_query.Q.log(ref_repo).using(ref_eng), CHAINS[chain]).dfg(
        backend=ref_backend(backend)
    )
    port_res = _build(
        port_query.Q.log(port_repo).using(port_eng), CHAINS[chain]
    ).dfg(backend=backend)
    _assert_same(ref_res, port_res)


@pytest.mark.parametrize("backend", ["auto", "kernel"])
@pytest.mark.parametrize(
    "chain", ["plain", "window", "empty_window", "window_activities", "view_pushdown"]
)
def test_materialized_memmap_chain_matches_reference(memmap_path, chain, backend):
    ref_eng, port_eng = _engines(tiny_pairs=TINY, memory_budget_events=1 << 20)
    ref_res = _build(
        ref_query.Q.log(RefMemmapLog.open(memmap_path)).using(ref_eng),
        CHAINS[chain],
    ).dfg(backend=ref_backend(backend))
    port_res = _build(
        port_query.Q.log(PortMemmapLog.open(memmap_path)).using(port_eng),
        CHAINS[chain],
    ).dfg(backend=backend)
    assert port_res.physical.materialize
    _assert_same(ref_res, port_res)


@pytest.mark.parametrize("backend", ["auto", "streaming"])
@pytest.mark.parametrize(
    "chain", ["plain", "window", "empty_window", "activities", "view_pushdown"]
)
def test_streaming_memmap_chain_matches_reference(memmap_path, chain, backend):
    # budget below the log's size: auto streams out-of-core
    ref_eng, port_eng = _engines(tiny_pairs=TINY, memory_budget_events=1000)
    ref_res = _build(
        ref_query.Q.log(RefMemmapLog.open(memmap_path)).using(ref_eng),
        CHAINS[chain],
    ).dfg(backend=backend)
    port_res = _build(
        port_query.Q.log(PortMemmapLog.open(memmap_path)).using(port_eng),
        CHAINS[chain],
    ).dfg(backend=backend)
    assert port_res.physical.backend == "streaming"
    _assert_same(ref_res, port_res)
    assert port_eng.stats.rows_scanned == ref_eng.stats.rows_scanned


def test_repeated_query_is_served_from_the_cache(repos):
    _, port_repo = repos
    eng = port_query.QueryEngine(device="cpu", tiny_pairs=TINY)
    first = port_query.Q.log(port_repo).using(eng).window(0, 50 * DAY).dfg()
    # the same query chained differently: one canonical plan, one entry
    again = (
        port_query.Q.log(port_repo).using(eng)
        .window(-1e9, 1e9).window(0, 50 * DAY).dfg()
    )
    assert not first.from_cache and again.from_cache
    np.testing.assert_array_equal(first.value, again.value)
    again.value[0, 0] += 1  # a served copy cannot corrupt the cache
    third = port_query.Q.log(port_repo).using(eng).window(0, 50 * DAY).dfg()
    np.testing.assert_array_equal(first.value, third.value)
    assert eng.stats.cache_hits == 2 and eng.stats.executions == 1
    assert third.trace.executed_backend == "cache"
    assert third.trace.links["produced_by"] == first.trace.trace_id


def test_unported_features_name_their_roadmap_item(repos):
    _, port_repo = repos
    q = port_query.Q.log(port_repo).using(
        port_query.QueryEngine(device="cpu")
    )
    calls = [
        lambda: q.dfg(backend="distributed"),
        lambda: q.dfg(backend="sharded-graph"),
    ]
    for call in calls:
        with pytest.raises(port_query.QueryPlanError, match="ROADMAP"):
            call()
    with pytest.raises(port_query.QueryPlanError, match="kernel"):
        q.dfg(backend="pallas")


def test_mine_cli_on_cpu_matches_reference(monkeypatch, capsys):
    args = ["--events", "6000", "--activities", "12", "--dice-days", "20"]
    summary = port_mine.main(args + ["--device", "cpu"])
    port_out = json.loads(capsys.readouterr().out)
    assert port_out == summary
    assert summary["device"] == "cpu" and summary["diced"]
    monkeypatch.setattr(sys, "argv", ["mine"] + args)
    ref_mine.main()
    ref_out = json.loads(capsys.readouterr().out)
    for key in ("events", "total_pairs", "edges_discovered"):
        assert summary[key] == ref_out[key], key
    kernel = port_mine.main(args + ["--device", "cpu", "--backend", "kernel"])
    assert kernel["mode"] == "kernel"
    assert "fused_kernel_dicing" in kernel["plan"]
    assert kernel["total_pairs"] == summary["total_pairs"]
