"""The case-sharded graph tier of the port (``repro_torch.graph.shard``,
``repro_torch.sharding``, the ``sharded-graph`` backend) against the
reference (``repro.graph.shard``, ``repro.query``) on the CPU.

One seeded memmap log (12,000 events, 12 activities — the size of
``tests/test_sharded_graph.py``) is partitioned by both packages; shard
files, fingerprints, plans (backend, notes), errors, cache behaviour,
``EngineStats`` and every sink's value must agree, tolerance 0 (counts are
integers).  Independently of the reference, every sharded answer is also
held against the port's single-log engine and Algorithm 1 on the stream.

The reference engine reads its crossovers from the committed bench
records, and a ``curves`` entry of ``BENCH_shard.json`` overrides an
explicit ``sharded_crossover`` at plan time; the parity engines therefore
pass every crossover to both packages and clear the reference's curves.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

import repro.graph as ref_graph
import repro.query as ref_query
import repro.query.cache as ref_cache
import repro.sharding.spec as ref_spec
import repro_torch.data.synthetic_log as port_synth
import repro_torch.graph as port_graph
import repro_torch.query as port_query
import repro_torch.query.cache as port_cache
import repro_torch.sharding as port_sharding
from repro.core.streaming import MemmapLog as RefMemmapLog
from repro.core.views import ActivityView as RefActivityView
from repro_torch.core.compat import make_mesh
from repro_torch.core.streaming import MemmapLog as PortMemmapLog
from repro_torch.core.streaming import streaming_dfg
from repro_torch.core.views import ActivityView
from torch_parity import assert_no_collision, port_backend, port_notes

EVENTS = 12_000
STATS = (
    "queries", "executions", "cache_hits", "delta_hits", "rows_scanned",
    "union_queries", "graph_queries", "conformance_queries", "shard_queries",
)
#: the reference's error texts name its own package where the port names
#: ``repro_torch``; every other byte is the same
_REF_MODULE = "repro.graph.partition_memmap_log"
_PORT_MODULE = "repro_torch.graph.partition_memmap_log"


# ---------------------------------------------------------------------------
# sources and engines
# ---------------------------------------------------------------------------


def _make_log(path, events=EVENTS, activities=12, seed=31, days=90):
    return port_synth.generate_memmap_log(
        str(path), events,
        port_synth.ProcessSpec(num_activities=activities, seed=seed,
                               horizon_days=days),
        seed=seed,
    )


def _partition_both(log, k, root):
    """The port's and the reference's partition of one log, each in its own
    directory."""
    port = port_graph.partition_memmap_log(log, k, str(root / f"port_k{k}"))
    ref = ref_graph.partition_memmap_log(
        RefMemmapLog.open(log.path), k, str(root / f"ref_k{k}")
    )
    return port, ref


@pytest.fixture(scope="module")
def base_log(tmp_path_factory):
    return _make_log(tmp_path_factory.mktemp("torch_shard_base") / "log")


@pytest.fixture(scope="module")
def sharded_by_k(base_log, tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_shard_parts")
    return {k: _partition_both(base_log, k, root) for k in (1, 2, 4, 8)}


def _engines(**kw):
    kw.setdefault("graph_crossover", 3)
    kw.setdefault("replay_crossover", 1 << 22)
    kw.setdefault("sharded_crossover", 1 << 18)
    port = port_query.QueryEngine(device="cpu", **kw)
    ref = ref_query.QueryEngine(calibration_path=os.devnull, **kw)
    ref.calibration_curves = {}
    return port, ref


def _span(log):
    t = np.asarray(log.time)
    return float(t[0]), float(t[-1])


def _ops_cases(names, t_lo, t_hi):
    span = t_hi - t_lo
    w = (t_lo + 0.2 * span, t_lo + 0.7 * span)
    keep = names[2:9]
    view = {n: f"g{i % 3}" for i, n in enumerate(names[:8])}
    return {
        "plain": {},
        "window": {"window": w},
        "keep": {"keep": keep},
        "view": {"view": view},
        "window_keep": {"window": w, "keep": keep},
        "window_keep_view": {"window": w, "keep": keep, "view": view},
        "empty_window": {"window": (t_hi, t_lo)},
    }


def _apply(q, ops, ref=False):
    if "window" in ops:
        q = q.window(*ops["window"])
    if "keep" in ops:
        q = q.activities(ops["keep"])
    if "view" in ops:
        view = RefActivityView if ref else ActivityView
        q = q.view(view(ops["view"]))
    return q


def _catch(fn):
    try:
        return fn()
    except (ref_query.QueryPlanError, port_query.QueryPlanError) as e:
        return e


def _same_value(p, r):
    if isinstance(r, np.ndarray):
        assert p.dtype == r.dtype
        np.testing.assert_array_equal(p, r)
        return
    assert type(p).__name__ == type(r).__name__
    if type(r).__name__ == "TraceVariants":  # the port keeps ragged ids
        np.testing.assert_array_equal(p.counts, r.counts)
        assert p.sequences == r.sequences
        np.testing.assert_array_equal(p.trace_variant, r.trace_variant)
        return
    g, w = dataclasses.asdict(p), dataclasses.asdict(r)
    assert g.keys() == w.keys()
    for k in w:
        if isinstance(w[k], np.ndarray):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            assert g[k] == w[k], k


def _same_result(p, r):
    if isinstance(r, Exception) or isinstance(p, Exception):
        assert isinstance(r, ref_query.QueryPlanError), r
        assert isinstance(p, port_query.QueryPlanError), p
        assert str(p) == str(r).replace(_REF_MODULE, _PORT_MODULE)
        return
    assert p.names == r.names
    _same_value(p.value, r.value)
    assert p.from_cache == r.from_cache
    pp, rp = p.physical, r.physical
    assert pp.backend == port_backend(rp.backend)
    assert pp.notes == port_notes(rp.notes)
    for f in ("materialize", "row_range_window", "activities_as_output_mask",
              "view_pushdown", "delta_rows"):
        assert getattr(pp, f) == getattr(rp, f), f
    assert p.rewrites == r.rewrites
    assert p.logical.key() == r.logical.key()
    for f in ("rows_scanned", "from_cache", "planned_backend", "source"):
        assert getattr(p.trace, f) == getattr(r.trace, f), f
    assert [n for n, _ in p.trace.branches] == [
        n for n, _ in r.trace.branches
    ]
    assert ("shard_merge" in [s.name for s in p.trace.spans]) == (
        "shard_merge" in [s.name for s in r.trace.spans]
    )


def _same_stats(port_eng, ref_eng):
    for f in STATS:
        assert getattr(port_eng.stats, f) == getattr(ref_eng.stats, f), f


def _both(port_eng, ref_eng, port_src, ref_src, fn):
    """``fn(query, ref)`` on both packages' engines and sources."""
    p = _catch(lambda: fn(port_query.Q.log(port_src).using(port_eng), False))
    r = _catch(lambda: fn(ref_query.Q.log(ref_src).using(ref_eng), True))
    _same_result(p, r)
    return p


# ---------------------------------------------------------------------------
# partition, shard assignment and fingerprints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_partition_writes_the_reference_shard_files(sharded_by_k, k):
    port, ref = sharded_by_k[k]
    cmp = filecmp.dircmp(port.path, ref.path)
    assert cmp.left_only == cmp.right_only == []
    for sub in [""] + sorted(cmp.common_dirs):
        names = sorted(os.listdir(os.path.join(port.path, sub)))
        assert names == sorted(os.listdir(os.path.join(ref.path, sub)))
        for n in names:
            a = os.path.join(port.path, sub, n)
            if os.path.isfile(a):
                assert filecmp.cmp(a, os.path.join(ref.path, sub, n),
                                   shallow=False), (sub, n)
    assert port.num_shards == ref.num_shards == k
    assert [i for i, _ in port.present_shards()] == [
        i for i, _ in ref.present_shards()
    ]
    assert (port.num_events, port.num_activities, port.num_traces) == (
        ref.num_events, ref.num_activities, ref.num_traces
    )
    assert port.activity_labels() == ref.activity_labels()
    assert port_graph.sharded_log_name(port) == f"port_k{k}"


@pytest.mark.parametrize("k", [1, 3, 4, 7])
def test_shard_of_cases_and_spec_match_the_reference(k):
    ids = np.random.default_rng(k).integers(-50, 10_000, 2_000)
    got = port_sharding.shard_of_cases(ids, k)
    np.testing.assert_array_equal(got, ref_spec.shard_of_cases(ids, k))
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < k
    spec = port_sharding.GraphShardSpec(k)
    np.testing.assert_array_equal(spec.shard_of(ids), got)
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        ref_spec.GraphShardSpec(k)
    )


def test_shard_spec_rejects_what_the_reference_rejects():
    for bad in (dict(num_shards=0), dict(num_shards=2, assignment="hash")):
        with pytest.raises(ValueError) as pe:
            port_sharding.GraphShardSpec(**bad)
        with pytest.raises(ValueError) as re_:
            ref_spec.GraphShardSpec(**bad)
        assert str(pe.value) == str(re_.value)
    with pytest.raises(ValueError, match="num_shards"):
        port_sharding.shard_of_cases([1, 2], 0)


def test_graph_mesh_needs_two_cards():
    # a host without cards (or with one) merges on the host
    assert port_sharding.graph_mesh(4) is None


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_fingerprint_sharded_strings_equal_the_reference(sharded_by_k, k):
    port, ref = sharded_by_k[k]
    fp = port_cache.fingerprint(port)
    assert fp == ref_cache.fingerprint(ref)
    assert fp == port_cache.fingerprint_sharded(port)
    slots = port_cache.split_sharded_fingerprint(fp)
    assert slots == ref_cache.split_sharded_fingerprint(fp)
    assert len(slots) == k
    for (i, shard), slot in zip(port.present_shards(), slots):
        assert slot == port_cache.fingerprint_memmap(shard)
    assert port_cache.split_sharded_fingerprint("memmap:x:1:2") is None


def test_partition_refuses_to_overwrite_and_reopens(base_log, tmp_path):
    sh = port_graph.partition_memmap_log(base_log, 3, str(tmp_path / "s"))
    with pytest.raises(FileExistsError):
        port_graph.partition_memmap_log(base_log, 3, str(tmp_path / "s"))
    again = port_graph.open_sharded_log(sh.path)
    assert port_cache.fingerprint(again) == port_cache.fingerprint(sh)
    assert again.spec == sh.spec
    np.testing.assert_array_equal(again.owning_shards([5, 8, 11, 4]), [1, 2])


def test_absent_residues_have_no_shard_and_appear_on_append(tmp_path):
    """Cases only of residues 0 and 2 of K = 4: residues 1 and 3 have no
    shard ('-' slots) until an append routes a case to residue 3."""
    log = _make_log(tmp_path / "log", events=3_000, activities=6, seed=4)
    a, c, t = (np.asarray(x) for x in (log.activity, log.case, log.time))
    m = c % 2 == 0  # only the even cases
    w = PortMemmapLog.create(str(tmp_path / "even"), int(m.sum()),
                             log.num_activities, log.num_traces)
    w.append(a[m], c[m], t[m])
    port_sh, ref_sh = _partition_both(w.close(), 4, tmp_path)
    fp = port_cache.fingerprint(port_sh)
    assert fp == ref_cache.fingerprint(ref_sh)
    assert port_cache.split_sharded_fingerprint(fp)[1::2] == [None, None]
    batch = (np.asarray([1, 2], np.int32), np.asarray([7, 7], np.int32),
             np.asarray([t[-1] + 1.0, t[-1] + 2.0]))
    port_g = port_sh.append(*batch)
    ref_g = ref_sh.append(*batch)
    assert [k for k, _ in port_g.present_shards()] == [0, 2, 3]
    assert port_cache.fingerprint(port_g) == ref_cache.fingerprint(ref_g)
    reopened = port_graph.open_sharded_log(port_g.path)
    assert port_cache.fingerprint(reopened) == port_cache.fingerprint(port_g)


# ---------------------------------------------------------------------------
# the merge equivalence sweep (test_sharded_graph.py's, K ∈ {1, 2, 4})
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sharded_dfg_equals_reference_single_host_and_oracle(
    base_log, sharded_by_k, k
):
    port_sh, ref_sh = sharded_by_k[k]
    names = port_sh.activity_labels()
    t_lo, t_hi = _span(base_log)
    port_eng, ref_eng = _engines()
    single = port_query.QueryEngine(device="cpu", graph_crossover=10**9)
    for label, ops in _ops_cases(names, t_lo, t_hi).items():
        rs = _both(port_eng, ref_eng, port_sh, ref_sh,
                   lambda q, ref: _apply(q, ops, ref).dfg(
                       backend="sharded-graph"))
        assert rs.physical.backend == "sharded-graph", label
        rr = _apply(port_query.Q.log(base_log).using(single), ops).dfg()
        np.testing.assert_array_equal(rs.value, rr.value, err_msg=label)
        assert rs.names == rr.names
        if label == "plain":
            np.testing.assert_array_equal(rs.value, streaming_dfg(base_log))
        elif label == "window":
            np.testing.assert_array_equal(
                rs.value, streaming_dfg(base_log, time_window=ops["window"])
            )
    _same_stats(port_eng, ref_eng)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("windowed", [False, True])
def test_sharded_histogram_and_topology_sinks(
    base_log, sharded_by_k, k, windowed
):
    port_sh, ref_sh = sharded_by_k[k]
    t_lo, t_hi = _span(base_log)
    w = (t_lo + 0.25 * (t_hi - t_lo), t_lo + 0.8 * (t_hi - t_lo))
    center = port_sh.activity_labels()[3]
    port_eng, ref_eng = _engines()
    single = port_query.QueryEngine(device="cpu", graph_crossover=10**9)

    def win(q):
        return q.window(*w) if windowed else q

    sinks = {
        "histogram": lambda q: q.histogram(backend="sharded-graph"),
        "process_map": lambda q: q.process_map(backend="sharded-graph"),
        "neighborhood": lambda q: q.neighborhood(
            center, k=2, backend="sharded-graph"),
    }
    for name, sink in sinks.items():
        got = _both(port_eng, ref_eng, port_sh, ref_sh,
                    lambda q, ref: sink(win(q)))
        plain = win(port_query.Q.log(base_log).using(single))
        want = {
            "histogram": lambda: plain.histogram(),
            "process_map": lambda: plain.process_map(),
            "neighborhood": lambda: plain.neighborhood(center, k=2),
        }[name]()
        _same_value(got.value, want.value)
    _same_stats(port_eng, ref_eng)


def test_sharded_union_branch_equals_plain_union(base_log, sharded_by_k,
                                                 tmp_path):
    other = _make_log(tmp_path / "other", events=4_000, seed=7)
    port_sh, ref_sh = sharded_by_k[2]
    port_eng, ref_eng = _engines()
    pu = port_query.Q.logs((port_sh, "s"), (other, "m")).using(port_eng).dfg()
    ru = ref_query.Q.logs(
        (ref_sh, "s"), (RefMemmapLog.open(other.path), "m")
    ).using(ref_eng).dfg()
    _same_result(pu, ru)
    assert pu.physical.backend == "union"
    plain = port_query.Q.logs((base_log, "s"), (other, "m")).using(
        port_query.QueryEngine(device="cpu")
    ).dfg()
    np.testing.assert_array_equal(pu.value, plain.value)
    assert pu.names == plain.names
    # a union that does not distribute materializes the sharded branch too
    cat = port_query.Q.logs((port_sh, "s"), (other, "m")).using(
        port_eng).top_variants(5).dfg()
    want = port_query.Q.logs((base_log, "s"), (other, "m")).using(
        port_query.QueryEngine(device="cpu")).top_variants(5).dfg()
    assert cat.physical.backend == "concat"
    np.testing.assert_array_equal(cat.value, want.value)


# ---------------------------------------------------------------------------
# the crossover and the planner
# ---------------------------------------------------------------------------


def test_auto_below_the_crossover_counts_on_one_host(base_log, sharded_by_k):
    """``auto`` on a cold sharded log at or below the crossover counts the
    concatenation on one host; above it (or once every shard's graph is
    warm) it merges per-shard graphs."""
    port_sh, ref_sh = sharded_by_k[4]
    t_lo, t_hi = _span(base_log)
    names = port_sh.activity_labels()
    view = {n: f"g{i % 2}" for i, n in enumerate(names[:6])}
    n = port_sh.num_events
    for crossover in (n, n - 1):
        port_eng, ref_eng = _engines(sharded_crossover=crossover)
        chains = [
            lambda q, ref: q.dfg(),
            lambda q, ref: q.window(t_lo, (t_lo + t_hi) / 2).dfg(),
            lambda q, ref: _apply(q, {"view": view}, ref).dfg(),
            lambda q, ref: q.activities(names[:5]).dfg(),
            lambda q, ref: q.histogram(),
            lambda q, ref: q.process_map(),
            lambda q, ref: q.neighborhood(names[1], k=1),
        ]
        backends = [
            _both(port_eng, ref_eng, port_sh, ref_sh, fn).physical.backend
            for fn in chains
        ]
        if crossover < n:
            assert set(backends) == {"sharded-graph"}
        else:  # until the repeat-query crossover makes building pay
            assert backends[:2] == ["scatter", "scatter"]
            assert "numpy" in backends and "sharded-graph" in backends
        # warm shards keep even a below-crossover log on sharded-graph
        _both(port_eng, ref_eng, port_sh, ref_sh,
              lambda q, ref: q.dfg(backend="sharded-graph"))
        r = _both(port_eng, ref_eng, port_sh, ref_sh,
                  lambda q, ref: q.window(t_lo, t_hi).dfg())
        assert r.physical.backend == "sharded-graph"
        _same_stats(port_eng, ref_eng)


def test_variants_and_barriers_on_a_sharded_log(tmp_path):
    # 24 activities: a log whose traces hold no reference hash collision
    log = _make_log(tmp_path / "log", events=6_000, activities=24, seed=13)
    port_sh, ref_sh = _partition_both(log, 4, tmp_path)
    port_eng, ref_eng = _engines()
    assert_no_collision(port_query.repository_from_memmap(port_sh))
    for fn in (
        lambda q, ref: q.variants(),
        lambda q, ref: q.variants(4),
        lambda q, ref: q.top_variants(3).dfg(),
        lambda q, ref: q.top_variants(3).dfg(backend="sharded-graph"),
        lambda q, ref: q.activities(
            port_sh.activity_labels()[:6], relink=True).dfg(),
    ):
        r = _both(port_eng, ref_eng, port_sh, ref_sh, fn)
        if not isinstance(r, Exception) and r.physical.backend == "numpy":
            assert r.physical.notes[0] == "sharded=materialize_concatenation"
    _same_stats(port_eng, ref_eng)


def test_planner_rejections_match_the_reference(base_log, sharded_by_k):
    port_sh, ref_sh = sharded_by_k[4]
    t_lo, t_hi = _span(base_log)
    small = dict(memory_budget_events=2_000)
    cases = [
        ({}, lambda q, ref: q.dfg(backend="graph")),
        ({}, lambda q, ref: q.dfg(backend="onehot")),
        ({}, lambda q, ref: q.histogram(backend="streaming")),
        ({}, lambda q, ref: q.fitness()),
        ({}, lambda q, ref: q.alignments()),
        ({}, lambda q, ref: q.compare()),
        ({}, lambda q, ref: q.top_variants(3).dfg(backend="sharded-graph")),
        ({}, lambda q, ref: q.activities(["act_001"], relink=True).histogram(
            backend="sharded-graph")),
        (small, lambda q, ref: q.window(t_lo, t_hi).dfg(
            backend="sharded-graph")),
        (small, lambda q, ref: q.variants()),
        (small, lambda q, ref: q.dfg(backend="sharded-graph")),
    ]
    for kw, fn in cases:
        port_eng, ref_eng = _engines(**kw)
        _both(port_eng, ref_eng, port_sh, ref_sh, fn)


def test_sharded_backend_needs_a_sharded_source(base_log):
    port_eng, ref_eng = _engines()
    ref_log = RefMemmapLog.open(base_log.path)
    for fn in (lambda q, ref: q.dfg(backend="sharded-graph"),
               lambda q, ref: q.histogram(backend="sharded-graph"),
               lambda q, ref: q.process_map(backend="sharded-graph")):
        p = _both(port_eng, ref_eng, base_log, ref_log, fn)
        assert isinstance(p, port_query.QueryPlanError)
        assert _PORT_MODULE in str(p)


# ---------------------------------------------------------------------------
# per-shard delta resume and caching
# ---------------------------------------------------------------------------


def _fresh_shards(tmp_path, k=4, events=6_000):
    log = _make_log(tmp_path / "log", events=events, activities=10, seed=13,
                    days=60)
    port, ref = _partition_both(log, k, tmp_path)
    return log, port, ref


def test_append_rescans_only_the_owning_shard(tmp_path):
    log, port_sh, ref_sh = _fresh_shards(tmp_path)
    port_eng, ref_eng = _engines()
    cold = _both(port_eng, ref_eng, port_sh, ref_sh,
                 lambda q, ref: q.dfg(backend="sharded-graph"))
    assert not cold.from_cache
    assert port_eng.stats.rows_scanned == port_sh.num_events
    slots0 = port_cache.split_sharded_fingerprint(port_cache.fingerprint(port_sh))

    _, t_max = _span(log)
    batch = 5
    rows = (np.arange(batch, dtype=np.int32) % port_sh.num_activities,
            np.full(batch, 6, dtype=np.int32),  # one owning shard: 6 % 4
            t_max + 1.0 + np.arange(batch, dtype=np.float64))
    port_g = port_sh.append(*rows)
    ref_g = ref_sh.append(*rows)
    slots1 = port_cache.split_sharded_fingerprint(port_cache.fingerprint(port_g))
    assert port_cache.fingerprint(port_g) == ref_cache.fingerprint(ref_g)
    assert slots0[2] != slots1[2]
    assert [slots0[i] for i in (0, 1, 3)] == [slots1[i] for i in (0, 1, 3)]

    before = port_eng.stats.rows_scanned
    warm = _both(port_eng, ref_eng, port_g, ref_g,
                 lambda q, ref: q.dfg(backend="sharded-graph"))
    assert not warm.from_cache
    # only the owning shard's graph extends, and only over the suffix
    assert port_eng.stats.rows_scanned - before == batch
    branches = dict(warm.trace.branches)
    assert [branches[f"shard{i}"].from_cache for i in range(4)] == [
        True, True, False, True
    ]
    oracle = port_query.Q.log(port_g).using(
        port_query.QueryEngine(device="cpu")
    ).dfg()
    np.testing.assert_array_equal(warm.value, oracle.value)
    assert port_g.num_events == port_sh.num_events + batch

    again = _both(port_eng, ref_eng, port_g, ref_g,
                  lambda q, ref: q.dfg(backend="sharded-graph"))
    assert again.from_cache
    assert port_eng.stats.rows_scanned - before == batch
    _same_stats(port_eng, ref_eng)


def test_two_tier_store_spills_and_pages_in(tmp_path):
    log, port_sh, ref_sh = _fresh_shards(tmp_path)
    kw = dict(max_graphs=2)
    port_eng, ref_eng = _engines(
        graph_spill_dir=str(tmp_path / "spill_p"), **kw
    )
    ref_eng = ref_query.QueryEngine(
        calibration_path=os.devnull, graph_crossover=3,
        replay_crossover=1 << 22, sharded_crossover=1 << 18,
        graph_spill_dir=str(tmp_path / "spill_r"), **kw,
    )
    ref_eng.calibration_curves = {}
    t_lo, t_hi = _span(log)
    w = (t_lo + 0.3 * (t_hi - t_lo), t_lo + 0.9 * (t_hi - t_lo))
    r1 = _both(port_eng, ref_eng, port_sh, ref_sh,
               lambda q, ref: q.dfg(backend="sharded-graph"))
    assert port_eng.graphs.stats.spills == ref_eng.graphs.stats.spills > 0
    r2 = _both(port_eng, ref_eng, port_sh, ref_sh,
               lambda q, ref: q.window(*w).dfg(backend="sharded-graph"))
    assert port_eng.graphs.stats.pageins == ref_eng.graphs.stats.pageins > 0
    single = port_query.QueryEngine(device="cpu")
    np.testing.assert_array_equal(
        r1.value, port_query.Q.log(log).using(single).dfg().value
    )
    np.testing.assert_array_equal(
        r2.value, port_query.Q.log(log).using(single).window(*w).dfg().value
    )


def test_reopened_sharded_log_hits_the_same_cache_keys(tmp_path):
    _, port_sh, ref_sh = _fresh_shards(tmp_path)
    port_eng, ref_eng = _engines()
    r1 = _both(port_eng, ref_eng, port_sh, ref_sh,
               lambda q, ref: q.dfg(backend="sharded-graph"))
    r2 = _both(port_eng, ref_eng,
               port_graph.open_sharded_log(port_sh.path),
               ref_graph.open_sharded_log(ref_sh.path),
               lambda q, ref: q.dfg(backend="sharded-graph"))
    assert not r1.from_cache and r2.from_cache
    np.testing.assert_array_equal(r1.value, r2.value)
    _same_stats(port_eng, ref_eng)


# ---------------------------------------------------------------------------
# the merge on a mesh
# ---------------------------------------------------------------------------


def test_shard_merge_on_a_mesh_equals_the_host_merge(base_log, sharded_by_k):
    """An engine with a mesh of several positions sums the aligned shard Ψ
    on the mesh's devices (here three CPU positions, one shard padded)."""
    port_sh, _ = sharded_by_k[8]
    mesh = make_mesh((3,), ("shard",), devices=["cpu"] * 3)
    on_mesh = port_query.QueryEngine(device="cpu", mesh=mesh)
    host = port_query.QueryEngine(device="cpu")
    for fn in (lambda q: q.dfg(backend="sharded-graph"),
               lambda q: q.process_map(backend="sharded-graph")):
        a = fn(port_query.Q.log(port_sh).using(on_mesh))
        b = fn(port_query.Q.log(port_sh).using(host))
        _same_value(a.value, b.value)
    np.testing.assert_array_equal(
        port_query.Q.log(port_sh).using(on_mesh).dfg(
            backend="sharded-graph").value,
        streaming_dfg(base_log),
    )
