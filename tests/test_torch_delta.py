"""The append-aware delta path of the port against the reference on the CPU:
prefix-preserving fingerprints, the ``delta`` physical path (a cached
streaming scan resumed over just the appended suffix, DFG, histogram and
pinned-model fitness), the free rewrite (a window inside the old range
served with no scan), the fall-backs (a rewritten prefix, a shrunk
vocabulary, a default model), the hint-carrying cache, and the satellite
cache fixes.

Each package appends the same rows to its own on-disk copy of one seeded
log; results, plans (``delta_rows``, the notes ``resume@…`` /
``suffix_rows=…``), traces and ``EngineStats`` counters must agree, tolerance
0.  Independently of the reference, every delta result is also held
against a full recompute by a fresh engine and against Algorithm 1 on the
grown stream.
"""

import dataclasses
import os
import shutil
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.conformance as ref_core_conf
import repro.query as ref_query
import repro.query.cache as ref_cache
import repro_torch.core as port_core
import repro_torch.data.synthetic_log as port_synth
import repro_torch.query as port_query
import repro_torch.query.cache as port_cache
import repro_torch.query.execute as port_execute
from repro.core.streaming import MemmapLog as RefMemmapLog
from repro.core.views import ActivityView as RefActivityView
from repro_torch.conformance import replay_fitness_streaming
from repro_torch.core.streaming import MemmapLog as PortMemmapLog
from torch_parity import port_backend, port_notes, ref_repository

STATS = (
    "queries", "executions", "cache_hits", "delta_hits", "delta_free_hits",
    "rows_scanned", "union_queries", "graph_queries", "conformance_queries",
)
REPLAY = 1 << 22


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


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


def _same_value(p, r):
    if isinstance(r, np.ndarray):
        np.testing.assert_array_equal(p, r)
        return
    for f in dataclasses.fields(r):
        got, want = getattr(p, f.name), getattr(r, f.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            assert got == want, f.name


def _same_result(p, r):
    if isinstance(r, Exception) or isinstance(p, Exception):
        assert isinstance(r, ref_query.QueryPlanError), r
        assert isinstance(p, port_query.QueryPlanError), p
        assert str(p) == str(r)
        return
    assert p.names == r.names
    _same_value(p.value, r.value)
    assert p.from_cache == r.from_cache
    pp, rp = p.physical, r.physical
    assert pp.backend == port_backend(rp.backend)
    assert pp.notes == port_notes(rp.notes)
    for f in ("materialize", "row_range_window", "activities_as_output_mask",
              "delta_rows"):
        assert getattr(pp, f) == getattr(rp, f), f
    assert p.rewrites == r.rewrites
    assert p.logical.key() == r.logical.key()
    for f in ("rows_scanned", "from_cache", "delta_rows", "planned_backend"):
        assert getattr(p.trace, f) == getattr(r.trace, f), f
    assert p.trace.executed_backend == port_backend(r.trace.executed_backend)
    assert ("delta" in [s.name for s in p.trace.spans]) == (
        "delta" in [s.name for s in r.trace.spans]
    )


def _same_stats(port_eng, ref_eng):
    for f in STATS:
        assert getattr(port_eng.stats, f) == getattr(ref_eng.stats, f), f


class Pair:
    """One seeded log, one on-disk copy per package, the same engines and
    the same appends on both."""

    def __init__(self, port_log, ref_log, **engine_kw):
        self.logs = (port_log, ref_log)
        self.engines = _engines(**engine_kw)

    @classmethod
    def copy_of(cls, path, tmp_path, tag="log", **engine_kw):
        pp, rp = str(tmp_path / f"{tag}_port"), str(tmp_path / f"{tag}_ref")
        shutil.copytree(path, pp)
        shutil.copytree(path, rp)
        return cls(PortMemmapLog.open(pp), RefMemmapLog.open(rp), **engine_kw)

    @property
    def port(self):
        return self.logs[0]

    def run(self, fn):
        """``fn(Q, log, engine)`` on both; returns the port's result."""
        pe, re_ = self.engines
        r = _catch(lambda: fn(ref_query.Q, self.logs[1], re_))
        p = _catch(lambda: fn(port_query.Q, self.logs[0], pe))
        _same_result(p, r)
        _same_stats(pe, re_)
        return p

    @property
    def stats(self):
        return self.engines[0].stats

    def append(self, act, case, times):
        self.logs = tuple(
            log.append(np.asarray(act, np.int32), np.asarray(case, np.int32),
                       np.asarray(times, np.float64))
            for log in self.logs
        )
        assert port_query.fingerprint(self.logs[0]) == ref_query.fingerprint(
            self.logs[1]
        )
        return self.logs[0]

    def append_tail(self, n, seed=0, reuse_cases=True, new_activity=False):
        """A time-ordered suffix reusing existing case ids (so pairs
        straddle the append boundary)."""
        log = self.port
        rng = np.random.default_rng(seed)
        a_hi = log.num_activities + (1 if new_activity else 0)
        act = rng.integers(0, a_hi, n).astype(np.int32)
        if new_activity:
            act[0] = log.num_activities  # the vocabulary grows
        pool = log.num_traces if reuse_cases else log.num_traces + n
        case = rng.integers(0, pool, n).astype(np.int32)
        times = float(log.time[-1]) + np.sort(rng.uniform(0.0, 500.0, n))
        return self.append(act, case, times)


def _write_log(path, act, case, times, num_activities):
    act = np.asarray(act, np.int32)
    case = np.asarray(case, np.int32)
    times = np.asarray(times, np.float64)
    w = PortMemmapLog.create(
        str(path), act.shape[0], num_activities,
        int(case.max()) + 1 if case.size else 1, chunk_rows=64,
    )
    w.append(act, case, times)
    return w.close()


def _oracle_psi(act, case, times, num_activities):
    """Algorithm 1 on the flat stream: stable (case, time) sort, count
    consecutive same-case pairs."""
    act, case, times = map(np.asarray, (act, case, times))
    n = act.shape[0]
    order = np.lexsort((np.arange(n), times, case))
    a, c = act[order], case[order]
    psi = np.zeros((num_activities, num_activities), np.int64)
    for i in range(1, n):
        if c[i] == c[i - 1]:
            psi[a[i - 1], a[i]] += 1
    return psi


def _interleaved_stream(rng, n_events, n_cases, n_acts, t0=0.0):
    act = rng.integers(0, n_acts, n_events).astype(np.int32)
    case = rng.integers(0, n_cases, n_events).astype(np.int32)
    times = t0 + np.sort(rng.uniform(0.0, 1000.0, n_events))
    return act, case, times


def _fresh_dfg(log, **kw):
    """A full recompute by a fresh streaming engine."""
    eng = port_query.QueryEngine(device="cpu", memory_budget_events=0)
    q = port_query.Q.log(log).using(eng)
    if "window" in kw:
        q = q.window(*kw["window"])
    return q.dfg().value


def _algorithm1(log):
    repo = port_query.repository_from_memmap(log)
    src, dst, valid = repo.df_pairs()
    return port_core.dfg_numpy(src, dst, valid, repo.num_activities)


@pytest.fixture(scope="module")
def base_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("delta") / "base")
    port_synth.generate_memmap_log(
        path, 20_000, port_synth.ProcessSpec(num_activities=9, seed=41),
        seed=41, batch_traces=300,
    )
    return path


@pytest.fixture()
def pair(base_path, tmp_path):
    """Fresh copies per test — appends mutate the files; streaming-first
    engines (budget 0) so scans leave resumable state."""
    return Pair.copy_of(base_path, tmp_path, memory_budget_events=0)


# ---------------------------------------------------------------------------
# prefix-preserving fingerprints
# ---------------------------------------------------------------------------


def test_fingerprint_is_prefix_preserving(pair):
    log = pair.port
    fp_old = port_query.fingerprint(log)
    assert fp_old == ref_query.fingerprint(pair.logs[1])
    old = port_query.parse_memmap_fingerprint(fp_old)
    assert old.num_events == log.num_events
    assert old.prefix == port_query.prefix_digest(log)
    grown = pair.append_tail(123, seed=1)
    fp_new = port_query.fingerprint(grown)
    assert fp_new != fp_old
    # the proof: the old prefix digest is recomputable on the grown log
    assert port_query.prefix_digest(grown, old.num_events) == old.prefix
    assert port_query.prefix_digest(grown, 100) == ref_cache.prefix_digest(
        pair.logs[1], 100
    )
    with pytest.raises(ValueError):
        port_query.prefix_digest(grown, grown.num_events + 1)


def test_prefix_digest_detects_rewrite(pair):
    old = port_query.parse_memmap_fingerprint(port_query.fingerprint(pair.port))
    for log in pair.logs:
        with open(os.path.join(log.path, "activity.i32"), "r+b") as f:
            raw = np.frombuffer(f.read(4), np.int32)
            f.seek(0)  # head rows are always in the sample
            f.write(((raw + 1) % log.num_activities).astype(np.int32).tobytes())
    edited = PortMemmapLog.open(pair.port.path)
    got = port_query.prefix_digest(edited, old.num_events)
    assert got != old.prefix
    assert got == ref_cache.prefix_digest(
        RefMemmapLog.open(pair.logs[1].path), old.num_events
    )


def test_fingerprint_repository_hashes_trace_names():
    repo = port_synth.generate_repository(
        50, port_synth.ProcessSpec(num_activities=5, seed=3), seed=3
    )
    renamed = dataclasses.replace(
        repo, trace_names=[f"other_{n}" for n in repo.trace_names]
    )
    got = port_query.fingerprint_repository(renamed)
    assert port_query.fingerprint_repository(repo) != got
    assert got == ref_query.fingerprint_repository(ref_repository(renamed))


# ---------------------------------------------------------------------------
# the delta physical path
# ---------------------------------------------------------------------------


def test_delta_scans_only_the_suffix_bit_identical(pair):
    first = pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    assert first.physical.backend == "streaming"
    n0 = pair.port.num_events
    assert pair.stats.rows_scanned == n0
    grown = pair.append_tail(250, seed=2)
    res = pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    assert res.physical.backend == "delta"
    assert res.physical.delta_rows == (n0, grown.num_events)
    assert res.physical.notes == (f"resume@{n0}", "suffix_rows=250")
    assert pair.stats.rows_scanned - n0 == 250
    assert pair.stats.delta_hits == 1 and not res.from_cache
    assert res.trace.executed_backend == "delta"
    np.testing.assert_array_equal(res.value, _fresh_dfg(grown))
    np.testing.assert_array_equal(res.value, _algorithm1(grown))
    # the delta result was re-cached: the next run is a plain hit
    again = pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    assert again.from_cache and pair.stats.delta_hits == 1


def test_delta_links_pairs_straddling_the_boundary(tmp_path):
    """Interleaved cases whose last prefix event pairs with their first
    suffix event — the carried per-case tails are what count them."""
    # case 0: 0 .. 2 | 1   case 1: 1 .. 0 | 2   (| = append boundary)
    log = _write_log(tmp_path / "log", act=[0, 1, 2, 0], case=[0, 1, 0, 1],
                     times=[0.0, 1.0, 2.0, 3.0], num_activities=3)
    pair = Pair.copy_of(log.path, tmp_path, memory_budget_events=0)
    pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    pair.append([1, 2], [0, 1], [4.0, 5.0])
    res = pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    assert res.physical.backend == "delta"
    want = np.zeros((3, 3), np.int64)
    want[0, 2] = 1  # case 0 prefix
    want[1, 0] = 1  # case 1 prefix
    want[2, 1] = 1  # case 0 boundary pair
    want[0, 2] += 1  # case 1 boundary pair
    np.testing.assert_array_equal(res.value, want)


def test_delta_histogram(pair):
    pair.run(lambda Q, log, e: Q.log(log).using(e).histogram())
    grown = pair.append_tail(100, seed=3)
    base = pair.stats.rows_scanned
    res = pair.run(lambda Q, log, e: Q.log(log).using(e).histogram())
    assert res.physical.backend == "delta"
    assert pair.stats.rows_scanned - base == 100
    want = np.zeros(grown.num_activities, np.int64)
    for a, _, _ in grown.iter_chunks():
        want += np.bincount(a, minlength=grown.num_activities)
    np.testing.assert_array_equal(res.value, want)


def test_delta_windowed_open_to_the_right(pair):
    """A window whose right edge lies beyond the old data resumes the cached
    state and scans only the in-window part of the suffix."""
    t0 = float(np.asarray(pair.port.time)[5000])
    t1 = float(pair.port.time[-1]) + 1e9
    pair.run(lambda Q, log, e: Q.log(log).using(e).window(t0, t1).dfg())
    grown = pair.append_tail(200, seed=4)
    base = pair.stats.rows_scanned
    res = pair.run(lambda Q, log, e: Q.log(log).using(e).window(t0, t1).dfg())
    assert res.physical.backend == "delta"
    assert res.physical.row_range_window == (t0, t1)
    assert pair.stats.rows_scanned - base == 200
    np.testing.assert_array_equal(res.value, _fresh_dfg(grown, window=(t0, t1)))


def test_free_rewrite_window_inside_old_range(pair):
    """Append-only change + a window inside the old time range ⇒ the cached
    result is served without any scan, and republished."""
    ts = np.asarray(pair.port.time)
    t0, t1 = float(ts[2000]), float(ts[15000])
    first = pair.run(lambda Q, log, e: Q.log(log).using(e).window(t0, t1).dfg())
    grown = pair.append_tail(150, seed=5)
    base = pair.stats.rows_scanned
    res = pair.run(lambda Q, log, e: Q.log(log).using(e).window(t0, t1).dfg())
    assert res.from_cache and pair.stats.delta_free_hits == 1
    assert res.trace.executed_backend == "delta_free"
    assert pair.stats.rows_scanned == base
    np.testing.assert_array_equal(res.value, first.value)
    np.testing.assert_array_equal(res.value, _fresh_dfg(grown, window=(t0, t1)))
    hits = pair.stats.cache_hits
    again = pair.run(lambda Q, log, e: Q.log(log).using(e).window(t0, t1).dfg())
    assert again.from_cache and pair.stats.cache_hits == hits + 1


def test_delta_with_grown_activity_vocabulary(pair):
    pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    pair.run(lambda Q, log, e: Q.log(log).using(e).histogram())
    a0 = pair.port.num_activities
    grown = pair.append_tail(80, seed=6, new_activity=True)
    assert grown.num_activities == a0 + 1
    res = pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    assert res.physical.backend == "delta"
    assert res.value.shape == (a0 + 1,) * 2
    np.testing.assert_array_equal(res.value, _fresh_dfg(grown))
    hist = pair.run(lambda Q, log, e: Q.log(log).using(e).histogram())
    assert hist.physical.backend == "delta" and hist.value.shape == (a0 + 1,)
    assert hist.names == grown.activity_labels()


def test_rewritten_prefix_falls_back_to_full_recompute(pair):
    pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    for log in pair.logs:  # edit a sampled head row, then grow
        with open(os.path.join(log.path, "activity.i32"), "r+b") as f:
            raw = int(np.frombuffer(f.read(4), np.int32)[0])
            f.seek(0)
            f.write(np.asarray([(raw + 1) % log.num_activities],
                               np.int32).tobytes())
    pair.logs = (PortMemmapLog.open(pair.logs[0].path),
                 RefMemmapLog.open(pair.logs[1].path))
    edited = pair.append_tail(50, seed=7)
    res = pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    assert res.physical.backend == "streaming"  # no stale reuse
    assert pair.stats.delta_hits == 0 and pair.stats.delta_free_hits == 0
    np.testing.assert_array_equal(res.value, _fresh_dfg(edited))
    plan_key = res.logical.key()
    # the full scan re-published a hint on the new (rewritten) data
    hint = port_cache.realpath_of(edited)
    assert pair.engines[0].cache.has_delta_hint(hint, plan_key)


def test_shrunk_vocabulary_is_not_an_append(tmp_path):
    """A log rewritten with the same prefix rows but fewer activities is not
    an append-only change: a full scan, no delta."""
    rng = np.random.default_rng(3)
    act, case, times = _interleaved_stream(rng, 300, 6, 4)
    log = _write_log(tmp_path / "src", act, case, times, 6)
    pair = Pair.copy_of(log.path, tmp_path, memory_budget_events=0)
    pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    a2, c2, t2 = _interleaved_stream(rng, 40, 6, 4, t0=float(times[-1]))
    logs = []
    for old in pair.logs:
        shutil.rmtree(old.path)
        _write_log(old.path, np.concatenate([act, a2]),
                   np.concatenate([case, c2]), np.concatenate([times, t2]), 4)
        logs.append(type(old).open(old.path))
    pair.logs = tuple(logs)
    res = pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    assert res.physical.backend == "streaming"
    assert pair.stats.delta_hits == 0
    np.testing.assert_array_equal(res.value, _oracle_psi(
        np.concatenate([act, a2]), np.concatenate([case, c2]),
        np.concatenate([times, t2]), 4,
    ))


def test_repeated_appends_chain_deltas(pair):
    pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    for i in range(3):
        log = pair.append_tail(60, seed=10 + i)
        res = pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
        assert res.physical.backend == "delta"
        assert res.physical.delta_rows == (log.num_events - 60,
                                           log.num_events)
    assert pair.stats.delta_hits == 3
    np.testing.assert_array_equal(res.value, _fresh_dfg(log))


def test_delta_trace_records_the_resume(pair):
    pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    n0 = pair.port.num_events
    pair.append_tail(70, seed=8)
    res = pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    tr = res.trace
    assert tr.planned_backend == tr.executed_backend == "delta"
    assert tr.delta_rows == (n0, n0 + 70) and tr.rows_scanned == 70
    assert [s.name for s in tr.spans] == ["parse", "cache_probe", "delta"]
    assert tr.to_dict()["delta_rows"] == [n0, n0 + 70]
    assert "delta=scan_rows" in res.physical.describe()
    assert pair.engines[0].metrics.histogram(
        "delta_suffix_fraction",
        "Fraction of the log rescanned by a delta resume",
    ).count == 1


# ---------------------------------------------------------------------------
# pinned-model fitness: delta resume of the streaming replayer
# ---------------------------------------------------------------------------


def _model(log, **kw):
    repo = port_query.repository_from_memmap(log)
    s, d, v = repo.df_pairs()
    m = port_core.discover_dependency_graph(
        port_core.dfg_numpy(s, d, v, repo.num_activities),
        repo.activity_names, *repo.trace_boundaries(), **kw,
    )
    spec = port_core.ModelSpec.from_model(m)
    return spec, ref_core_conf.ModelSpec(
        activities=spec.activities, edges=spec.edges, starts=spec.starts,
        ends=spec.ends,
    )


def _models_by_side(model):
    def fitness(q, Q, **kw):
        return q.fitness(model[0] if Q is port_query.Q else model[1], **kw)
    return fitness


def _noise(pair, n, seed, new_activity=False):
    return pair.append_tail(n, seed=seed, new_activity=new_activity)


@pytest.mark.parametrize("seed", [2, 13, 29])
def test_property_sweep_append_and_delta_resume(tmp_path, seed):
    """Seeded sweep: a pinned-model streaming replay resumed over an append
    equals the reference's, a fresh replay and the columnar oracle."""
    path = str(tmp_path / "s")
    port_synth.generate_memmap_log(
        path, 6_000, port_synth.ProcessSpec(num_activities=8, seed=seed),
        seed=seed, batch_traces=200,
    )
    pair = Pair.copy_of(path, tmp_path, memory_budget_events=1_000,
                        replay_crossover=1_000)
    model = _model(pair.port, min_count=25, min_dependency=0.2)
    fit = _models_by_side(model)
    r1 = pair.run(lambda Q, log, e: fit(Q.log(log).using(e), Q))
    assert r1.physical.backend == "streaming"
    base = pair.stats.rows_scanned
    grown = _noise(pair, 400, seed, new_activity=seed == 13)
    r2 = pair.run(lambda Q, log, e: fit(Q.log(log).using(e), Q))
    assert r2.physical.backend == "delta" and pair.stats.delta_hits == 1
    assert pair.stats.rows_scanned - base == 400
    oracle = port_core.replay_fitness(
        port_query.repository_from_memmap(grown), model[0]
    )
    np.testing.assert_array_equal(r2.value.trace_fitness, oracle.trace_fitness)
    assert r2.value.deviating_edges == oracle.deviating_edges
    stream = replay_fitness_streaming(grown, model[0])
    np.testing.assert_array_equal(stream.trace_fitness, oracle.trace_fitness)


def test_default_model_not_delta_resumed(pair):
    """model=None re-discovers from the grown log: a full replay, no
    delta (the resumed state would score against a stale model)."""
    eng_kw = dict(memory_budget_events=2_000, replay_crossover=2_000)
    pair.engines = _engines(**eng_kw)
    r1 = pair.run(lambda Q, log, e: Q.log(log).using(e).fitness())
    assert r1.physical.backend == "streaming"
    grown = _noise(pair, 500, 7)
    r2 = pair.run(lambda Q, log, e: Q.log(log).using(e).fitness())
    assert r2.physical.backend == "streaming" and pair.stats.delta_hits == 0
    fresh = port_query.Q.log(grown).using(
        port_query.QueryEngine(device="cpu", **eng_kw)
    ).fitness()
    np.testing.assert_array_equal(r2.value.trace_fitness,
                                  fresh.value.trace_fitness)


def test_free_rewrite_for_windowed_fitness(pair):
    """A pinned-model windowed fitness whose window predates the append is
    served from cache with zero additional scan."""
    pair.engines = _engines(memory_budget_events=2_000,
                            replay_crossover=2_000)
    fit = _models_by_side(_model(pair.port, min_count=40))
    ts = np.asarray(pair.port.time)
    t0, t1 = float(np.quantile(ts, 0.1)), float(np.quantile(ts, 0.5))
    r1 = pair.run(lambda Q, log, e: fit(Q.log(log).using(e).window(t0, t1), Q))
    rows = pair.stats.rows_scanned
    _noise(pair, 400, 7)
    r2 = pair.run(lambda Q, log, e: fit(Q.log(log).using(e).window(t0, t1), Q))
    assert r2.from_cache and pair.stats.delta_free_hits == 1
    assert pair.stats.rows_scanned == rows
    np.testing.assert_array_equal(r1.value.trace_fitness,
                                  r2.value.trace_fitness)


def test_fitness_delta_under_filter_and_view(pair):
    """The replayer's resume carries the sequence transform: a filtered,
    viewed pinned-model fitness resumes like a plain one."""
    pair.engines = _engines(memory_budget_events=2_000,
                            replay_crossover=2_000)
    fit = _models_by_side(_model(pair.port, min_count=40))
    names = pair.port.activity_labels()
    keep = names[:7]
    mapping = {n: f"g{i % 3}" for i, n in enumerate(names[:6])}

    def q(Q, log, e):
        view = (port_core.ActivityView if Q is port_query.Q
                else RefActivityView)(mapping)
        return fit(Q.log(log).using(e).activities(keep).view(view), Q)

    pair.run(q)
    grown = _noise(pair, 300, 9)
    res = pair.run(q)
    assert res.physical.backend == "delta"
    fresh = fit(port_query.Q.log(grown).using(port_query.QueryEngine(
        device="cpu", memory_budget_events=2_000, replay_crossover=2_000,
    )).activities(keep).view(port_core.ActivityView(mapping)), port_query.Q)
    np.testing.assert_array_equal(res.value.trace_fitness,
                                  fresh.value.trace_fitness)
    assert res.value.deviating_edges == fresh.value.deviating_edges


# ---------------------------------------------------------------------------
# append → run ≡ full recompute (property)
# ---------------------------------------------------------------------------


def _check_append_equals_recompute(tmp_path, seed, n_base, n_app, n_cases,
                                   n_acts, grow=False):
    rng = np.random.default_rng(seed)
    act, case, times = _interleaved_stream(rng, n_base, n_cases, n_acts)
    log = _write_log(tmp_path / f"src{seed}", act, case, times, n_acts)
    pair = Pair.copy_of(log.path, tmp_path, tag=f"log{seed}",
                        memory_budget_events=0)
    pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    pair.run(lambda Q, log, e: Q.log(log).using(e).histogram())
    a_hi = n_acts + (2 if grow else 0)
    a2, c2, t2 = _interleaved_stream(rng, n_app, n_cases + 2, a_hi,
                                     t0=float(times[-1]))
    grown = pair.append(a2, c2, t2)
    res = pair.run(lambda Q, log, e: Q.log(log).using(e).dfg())
    assert res.physical.backend == "delta"
    hist = pair.run(lambda Q, log, e: Q.log(log).using(e).histogram())
    assert hist.physical.backend == "delta"
    a_all = np.concatenate([act, a2])
    want = _oracle_psi(a_all, np.concatenate([case, c2]),
                       np.concatenate([times, t2]), grown.num_activities)
    np.testing.assert_array_equal(res.value, want)
    np.testing.assert_array_equal(res.value, _fresh_dfg(grown))
    np.testing.assert_array_equal(
        hist.value, np.bincount(a_all, minlength=grown.num_activities)
    )


@pytest.mark.parametrize("seed", range(8))
def test_append_then_run_equals_recompute_seeded(tmp_path, seed):
    rng = np.random.default_rng(1000 + seed)
    _check_append_equals_recompute(
        tmp_path, seed,
        n_base=int(rng.integers(2, 400)),
        n_app=int(rng.integers(1, 200)),
        n_cases=int(rng.integers(1, 12)),
        n_acts=int(rng.integers(2, 9)),
        grow=seed % 3 == 0,
    )


@settings(max_examples=20, deadline=None)
@given(
    seed=st.integers(0, 2**16),
    n_base=st.integers(2, 150),
    n_app=st.integers(1, 80),
    n_cases=st.integers(1, 8),
    n_acts=st.integers(2, 6),
    grow=st.booleans(),
)
def test_append_then_run_equals_recompute_hypothesis(
    tmp_path_factory, seed, n_base, n_app, n_cases, n_acts, grow
):
    """Random streams, random appends (some growing the vocabulary): the
    delta equals a full recompute, the oracle and the reference."""
    _check_append_equals_recompute(
        tmp_path_factory.mktemp("hyp"), seed, n_base=n_base, n_app=n_app,
        n_cases=n_cases, n_acts=n_acts, grow=grow,
    )


# ---------------------------------------------------------------------------
# the hint-carrying cache
# ---------------------------------------------------------------------------


def test_cache_hints_match_reference_bookkeeping():
    """The same put / candidate / drop / evict / invalidate sequence on both
    packages' caches gives the same answers and the same stats."""

    @dataclasses.dataclass
    class R:
        value: object
        names: object = None

    caches = (port_cache.QueryCache(max_entries=3),
              ref_cache.QueryCache(max_entries=3))
    states = [
        port_cache.ResumableState(5, 2, counts=np.arange(2)),
        ref_cache.ResumableState(5, 2, counts=np.arange(2)),
    ]
    answers = []
    for c, rs in zip(caches, states):
        out = []
        c.put(("fp1", "k"), R(np.ones(2)), resume=rs, source_hint="/a")
        out.append(c.has_delta_hint("/a", "k"))
        out.append(c.probe(("fp1", "k")) and not c.probe(("fp1", "x")))
        fp, res, resume = c.delta_candidate("/a", "k")
        resume.counts[0] = 99  # a copy: the cached state stays intact
        out.append((fp, res.value.tolist(),
                    c.delta_candidate("/a", "k")[2].counts.tolist()))
        c.put(("fp2", "k"), R(np.zeros(2)), source_hint="/a")
        out.append(c.delta_candidate("/a", "k")[0])
        c.drop_hint("/a", "k")
        out.append(c.delta_candidate("/a", "k"))
        c.put(("fp3", "k"), R(1), source_hint="/b")
        for i in range(3):  # evicts fp1, fp2, fp3 and fp3's hint
            c.put((f"e{i}", "k"), R(i))
        out.append((c.has_delta_hint("/b", "k"), len(c)))
        out.append(c.invalidate_source("e0"))
        out.append(dataclasses.asdict(c.stats))
        c.clear()
        out.append((len(c), c.delta_candidate("/b", "k"),
                    c.has_delta_hint(None, "k")))
        answers.append(out)
    assert answers[0] == answers[1]
    assert answers[0][-2] == dict(hits=0, misses=0, evictions=3,
                                  invalidations=1)


def test_resumable_state_copies_are_independent():
    st_ = port_cache.ResumableState(
        10, 3,
        miner=port_core.MinerState(np.ones((3, 3), np.int64), {1: 2}, 10),
        counts=np.arange(3),
    )
    cp = st_.copy()
    cp.miner.psi[0, 0] = 7
    cp.miner.last_by_case[1] = 0
    cp.counts[0] = 7
    assert st_.miner.psi[0, 0] == 1 and st_.miner.last_by_case == {1: 2}
    assert st_.counts[0] == 0 and cp.replay is None


def test_delta_never_applies_to_repository_sources():
    """Only a memmap path carries a delta hint: a changed repository is a
    plain miss and a full recount (the reference refuses appends to
    registered repositories in its service)."""
    repo = port_synth.generate_repository(
        80, port_synth.ProcessSpec(num_activities=5, seed=12), seed=12
    )
    eng = port_query.QueryEngine(device="cpu")
    port_query.Q.log(repo).using(eng).dfg()
    assert port_execute.QueryEngine._source_hint(repo) is None
    grown = dataclasses.replace(
        repo, event_activity=repo.event_activity.copy()
    )
    grown.event_activity[0] = (grown.event_activity[0] + 1) % 5
    res = port_query.Q.log(grown).using(eng).dfg()
    assert not res.from_cache and res.physical.backend != "delta"
    assert eng.stats.delta_hits == 0


# ---------------------------------------------------------------------------
# satellite fixes
# ---------------------------------------------------------------------------


def test_cache_hit_reports_its_own_latency(monkeypatch):
    repo = port_synth.generate_repository(
        100, port_synth.ProcessSpec(num_activities=6, seed=8), seed=8
    )
    eng = port_query.QueryEngine(device="cpu")
    real = eng._execute

    def slow(*args, **kwargs):
        time.sleep(0.05)
        return real(*args, **kwargs)

    monkeypatch.setattr(eng, "_execute", slow)
    first = port_query.Q.log(repo).using(eng).dfg()
    assert not first.from_cache and first.wall_s >= 0.05
    second = port_query.Q.log(repo).using(eng).dfg()
    assert second.from_cache
    assert 0.0 < second.wall_s < first.wall_s


def test_repo_memo_is_an_lru_over_multiple_logs(tmp_path, monkeypatch):
    """Alternating over two in-budget memmap logs materializes each once."""
    logs = []
    for i in range(2):
        path = str(tmp_path / f"l{i}")
        port_synth.generate_memmap_log(
            path, 2_000, port_synth.ProcessSpec(num_activities=7, seed=50 + i),
            seed=50 + i, batch_traces=100,
        )
        logs.append(PortMemmapLog.open(path))
    calls = []
    real = port_execute.repository_from_memmap

    def counting(log, log_name=None):
        calls.append(log.path)
        return real(log, log_name)

    monkeypatch.setattr(port_execute, "repository_from_memmap", counting)
    eng = port_query.QueryEngine(device="cpu")
    for t in (1e5, 2e5, 3e5):
        for log in logs:
            res = port_query.Q.log(log).using(eng).window(0.0, t).dfg()
            assert res.physical.materialize
    assert len(calls) == 2


def test_empty_windows_share_one_canonical_plan(pair):
    for Q, side_query in ((port_query.Q, port_query), (ref_query.Q, ref_query)):
        log = pair.logs[0 if Q is port_query.Q else 1]
        plans = [
            side_query.canonicalize(q.logical_plan(side_query.DFGSink()))
            for q in (Q.log(log).window(5.0, 3.0),
                      Q.log(log).window(100.0, 90.0),
                      Q.log(log).window(0.0, 10.0).window(20.0, 30.0))
        ]
        assert "normalize_empty_window" in plans[0][1]
        assert len({p.key() for p, _ in plans}) == 1
        assert [op for op in plans[0][0].ops
                if isinstance(op, side_query.Window)] == [
                    side_query.EMPTY_WINDOW]
    r1 = pair.run(lambda Q, log, e: Q.log(log).using(e).window(5.0, 3.0).dfg())
    assert not r1.value.any() and pair.stats.rows_scanned == 0
    assert pair.run(lambda Q, log, e: Q.log(log).using(e)
                    .window(100.0, 90.0).dfg()).from_cache
    r3 = pair.run(lambda Q, log, e: Q.log(log).using(e)
                  .window(0.0, 10.0).window(20.0, 30.0).histogram())
    assert not r3.value.any() and pair.stats.rows_scanned == 0


def test_empty_window_zeros_on_repository():
    port = port_synth.generate_repository(
        200, port_synth.ProcessSpec(num_activities=6, seed=9), seed=9
    )
    ref = ref_repository(port)
    pe, re_ = _engines()
    for fn in (
        lambda Q, r, e: Q.log(r).using(e).window(9.0, 1.0).dfg(),
        lambda Q, r, e: Q.log(r).using(e).window(9.0, 1.0)
        .activities(["nope"]).dfg(),
    ):
        p = _catch(lambda: fn(port_query.Q, port, pe))
        r = _catch(lambda: fn(ref_query.Q, ref, re_))
        if isinstance(r, Exception):
            assert str(p) == str(r)
        else:
            assert not p.value.any()
            assert p.value.shape == (port.num_activities,) * 2
            np.testing.assert_array_equal(p.value, r.value)


def test_append_then_requery_matches_the_reference_service(pair):
    """The reference's live endpoint (``QueryService.append``, ROADMAP item
    10 for the port) and the port's ``MemmapLog.append`` + re-query give
    the same Ψ, and the port's re-query scans only the suffix."""
    from repro.serve import QueryService

    svc = QueryService(engine=pair.engines[1])
    svc.register("live", pair.logs[1])
    out1 = svc.query({"log": "live", "sink": "dfg"})
    port_eng = pair.engines[0]
    port_query.Q.log(pair.port).using(port_eng).dfg()
    rng = np.random.default_rng(11)
    t_last = float(pair.port.time[-1])
    act = rng.integers(0, pair.port.num_activities, 40)
    case = rng.integers(0, pair.port.num_traces, 40)
    times = np.sort(t_last + rng.uniform(0, 10, 40))
    ack = svc.append({"log": "live", "activity": act.tolist(),
                      "case": case.tolist(), "time": times.tolist()})
    grown = pair.port.append(act.astype(np.int32), case.astype(np.int32),
                             times)
    assert ack["num_events"] == grown.num_events
    base = port_eng.stats.rows_scanned
    res = port_query.Q.log(grown).using(port_eng).dfg()
    out2 = svc.query({"log": "live", "sink": "dfg"})
    assert res.physical.backend == "delta"
    assert port_eng.stats.rows_scanned - base == 40
    np.testing.assert_array_equal(res.value, np.asarray(out2["psi"]))
    assert not out1["from_cache"]


def test_concurrent_delta_requeries_agree(pair):
    """Tenants re-querying one grown log from several threads on one engine
    all get the recompute's Ψ; at most one full scan of the prefix ever
    ran, and the hint bookkeeping stays consistent."""
    port_eng = pair.engines[0]
    port_query.Q.log(pair.port).using(port_eng).dfg()
    n0 = port_eng.stats.rows_scanned
    grown = pair.append_tail(90, seed=21)
    results, errors = [], []

    def worker():
        try:
            results.append(port_query.Q.log(grown).using(port_eng).dfg())
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    want = _fresh_dfg(grown)
    for r in results:
        np.testing.assert_array_equal(r.value, want)
        assert r.physical.backend in ("delta", "streaming")
    s = port_eng.stats
    assert s.delta_hits >= 1 and s.queries == 7
    assert s.delta_hits + s.cache_hits == 6
    assert s.rows_scanned - n0 == 90 * s.delta_hits
