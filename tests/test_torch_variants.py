"""Variant analysis in the port against the reference on the CPU: the
variants sink, the ``top_variants`` / ``activities(relink=True)``
materialization barriers (their canonical plans, planner branches, errors
and every sink behind them, ``alignments()`` included), and the vectorized
remaps of ``variant_filtered_repository`` and ``dice_repository``.

The same seeded numpy inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``), and every tolerance is 0: counts, names, orders, plan
keys and f32 alignment costs must be equal.

The reference groups traces by a rolling hash and merges sequences whose
hash collides; the port splits them.  So the parity tests run on seeded
logs that assert they hold no collision, and one test hands both packages
a real colliding pair of the paper-scale log (``PAPER_EVAL``, seed 0) and
shows the reference's merge beside the port's split.  Variants of equal
count are ordered by hash in both packages, and the logs below put a tie
at the boundary of ``top_variants(k)``.
"""

import collections
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.dicing as ref_dicing
import repro.core.variants as ref_variants
import repro.data.synthetic_log as ref_synth
import repro.query as ref_query
import repro_torch.core.dicing as port_dicing
import repro_torch.core.variants as port_variants
import repro_torch.data.synthetic_log as port_synth
import repro_torch.query as port_query
from repro.conformance import AlignmentResult as RefAlignmentResult
from repro.core.repository import EventRepository as RefRepository
from repro.core.streaming import MemmapLog as RefMemmapLog
from repro_torch.core.dfg import dfg_numpy
from repro_torch.core.repository import EventRepository as PortRepository
from repro_torch.core.streaming import MemmapLog as PortMemmapLog
from repro_torch.core.views import ActivityView
from torch_parity import port_backend, ref_backend

DAY = 86400.0
A = 10
#: a log whose variants repeat (short traces) with no hash collision; its
#: two most frequent variants tie, so top_variants(1) keeps one of a tie
SPEC = dict(num_activities=A, mean_trace_len=5.0, seed=0)
NAMES = [f"act_{i:03d}" for i in range(A)]
KEEP = NAMES[:6]
VIEW = {f"act_{i:03d}": f"g{i % 3}" for i in range(A - 1)}

#: two activity sequences of the PAPER_EVAL log (seed 0) whose rolling
#: hashes are equal in the reference's variant table
PAPER_EVAL_COLLISION = (
    [289, 109, 150, 523, 36, 504, 380, 502, 446, 266, 189],
    [61, 472, 551, 14, 88, 251, 492, 412, 585, 131, 337],
)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _ref_of(repo: PortRepository) -> RefRepository:
    """The reference's repository of the same columns and names."""
    return RefRepository(
        event_activity=repo.event_activity.copy(),
        event_trace=repo.event_trace.copy(),
        event_time=repo.event_time.copy(),
        trace_log=repo.trace_log.copy(),
        activity_names=list(repo.activity_names),
        trace_names=list(repo.trace_names),
        log_names=list(repo.log_names),
    )


def _exact_variants(repo) -> collections.Counter:
    """Traces grouped by the tuple of their activity ids, with no hash."""
    seqs = collections.defaultdict(list)
    for t, a in zip(repo.event_trace.tolist(), repo.event_activity.tolist()):
        seqs[t].append(a)
    return collections.Counter(tuple(s) for s in seqs.values())


def _collides(repo) -> bool:
    """True when the reference's hash merges two distinct sequences."""
    ref = ref_variants.trace_variants(_ref_of(repo))
    return ref.num_variants != len(_exact_variants(repo))


def _assert_no_collision(repo):
    """Neither the log nor the selections the tests below align (the
    relinked keep-set, a window's events) holds a hash collision."""
    for r in (
        repo,
        port_dicing.dice_repository(repo, activities=KEEP),
        port_dicing.dice_repository(repo, time_window=(5 * DAY, 60 * DAY)),
    ):
        assert not _collides(r)


def _same_repo(port, ref):
    for f in ("event_activity", "event_trace", "event_time", "trace_log"):
        got, want = getattr(port, f), getattr(ref, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("activity_names", "trace_names", "log_names", "event_names"):
        assert getattr(port, f) == getattr(ref, f), f


def _same_variants(port, ref):
    assert port.counts.dtype == ref.counts.dtype == np.int64
    np.testing.assert_array_equal(port.counts, ref.counts)
    assert port.num_variants == ref.num_variants
    assert port.sequences == ref.sequences
    assert port.trace_variant.dtype == ref.trace_variant.dtype
    np.testing.assert_array_equal(port.trace_variant, ref.trace_variant)


def _same_alignment(port, ref):
    for f in ("trace_cost", "trace_fitness", "variant_costs"):
        got, want = getattr(port, f), getattr(ref, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert port.summary() == ref.summary()
    assert port.deviating_edges == ref.deviating_edges


def _same_value(port, ref):
    if isinstance(ref, np.ndarray):
        assert port.dtype == np.int64
        np.testing.assert_array_equal(port, ref)
    elif isinstance(ref, ref_variants.TraceVariants):
        _same_variants(port, ref)
    elif isinstance(ref, RefAlignmentResult):
        _same_alignment(port, ref)
    elif hasattr(ref, "trace_fitness"):  # replay
        np.testing.assert_array_equal(port.trace_fitness, ref.trace_fitness)
        assert port.summary() == ref.summary()
    else:  # process map / neighborhood: plain dataclasses of lists
        assert port.__dict__.keys() == ref.__dict__.keys()
        for k, v in ref.__dict__.items():
            got = port.__dict__[k]
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got, v, err_msg=k)
            else:
                assert got == v, k


def _run(q, sink, *args, **kw):
    try:
        return getattr(q, sink)(*args, **kw)
    except (ref_query.QueryPlanError, port_query.QueryPlanError) as e:
        return e


def _assert_same_result(port_res, ref_res):
    if isinstance(ref_res, Exception) or isinstance(port_res, Exception):
        assert isinstance(ref_res, ref_query.QueryPlanError), ref_res
        assert isinstance(port_res, port_query.QueryPlanError), port_res
        assert str(port_res) == str(ref_res)
        return
    assert port_res.names == ref_res.names
    _same_value(port_res.value, ref_res.value)
    rp, pp = ref_res.physical, port_res.physical
    assert pp.backend == port_backend(rp.backend)
    assert pp.materialize == rp.materialize
    assert pp.fused_dicing == rp.fused_dicing
    assert pp.view_pushdown == rp.view_pushdown
    assert pp.activities_as_output_mask == rp.activities_as_output_mask
    assert pp.row_range_window == rp.row_range_window
    assert pp.notes == rp.notes
    assert port_res.rewrites == ref_res.rewrites
    # the canonical plans agree op for op; with a shared backend name the
    # plan keys (the cache key half owned by the plan) agree too
    assert port_res.logical._payload()[1] == ref_res.logical._payload()[1]
    if getattr(port_res.logical.sink, "backend", None) == getattr(
        ref_res.logical.sink, "backend", None
    ):
        assert port_res.logical.key() == ref_res.logical.key()


def _engines(**kw):
    # the reference reads crossovers from its committed calibration records
    # unless pointed at none (and the replay crossover is passed, since
    # calibration_path does not cover it); both keep repeated queries off
    # their graph tiers unless a test says otherwise
    kw.setdefault("graph_crossover", 10**9)
    kw.setdefault("replay_crossover", 1 << 20)
    ref = ref_query.QueryEngine(calibration_path=os.devnull, **kw)
    port = port_query.QueryEngine(device="cpu", **kw)
    return ref, port


def _build(q, chain):
    for method, args in chain:
        if method == "view" and isinstance(q, port_query.Query):
            args = (ActivityView(dict(args[0])),)
        q = getattr(q, method)(*args)
    return q


def _both(sources, chain, sink, *args, engine_kw=None, **kw):
    port_src, ref_src = sources
    ref_eng, port_eng = _engines(**(engine_kw or {}))
    ref_kw = dict(kw)
    if "backend" in ref_kw:
        ref_kw["backend"] = ref_backend(ref_kw["backend"])
    ref_res = _run(
        _build(ref_query.Q.log(ref_src).using(ref_eng), chain), sink,
        *args, **ref_kw,
    )
    port_res = _run(
        _build(port_query.Q.log(port_src).using(port_eng), chain), sink,
        *args, **kw,
    )
    return port_res, ref_res, port_eng, ref_eng


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def repos():
    port = port_synth.generate_repository(
        400, port_synth.ProcessSpec(**SPEC), seed=0
    )
    ref = ref_synth.generate_repository(
        400, ref_synth.ProcessSpec(**SPEC), seed=0
    )
    _same_repo(port, ref)
    _assert_no_collision(port)
    counts = port_variants.trace_variants(port).counts
    assert counts[0] == counts[1], "the log should open on a tie"
    return port, ref


@pytest.fixture(scope="module")
def memmap(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_variants") / "log")
    port_synth.generate_memmap_log(
        path, 3000, port_synth.ProcessSpec(**SPEC), seed=6, batch_traces=60,
    )
    port, ref = PortMemmapLog.open(path), RefMemmapLog.open(path)
    _assert_no_collision(port_query.repository_from_memmap(port))
    return port, ref


def _tie_k(repo) -> int:
    """The least k > 1 whose boundary splits a run of equal counts."""
    c = port_variants.trace_variants(repo).counts
    return next(k for k in range(2, c.shape[0]) if c[k - 1] == c[k])


# ---------------------------------------------------------------------------
# the real collision
# ---------------------------------------------------------------------------


def test_paper_eval_collision_reference_merges_port_splits():
    """Three traces of one PAPER_EVAL sequence and two of another whose
    hash collides: the reference counts one variant of 5, the port two of
    3 and 2, and ``top_variants(1).dfg()`` differs accordingly — the
    port's equals the exact oracle."""
    names = [f"act_{i:03d}" for i in range(600)]
    s1, s2 = PAPER_EVAL_COLLISION
    traces = [[names[i] for i in s] for s in (s1, s1, s1, s2, s2)]
    port = PortRepository.from_traces(traces, activity_vocab=names)
    ref = RefRepository.from_traces(traces, activity_vocab=names)

    rv = ref_variants.trace_variants(ref)
    pv = port_variants.trace_variants(port)
    assert rv.counts.tolist() == [5]
    assert rv.trace_variant.tolist() == [0] * 5
    assert pv.counts.tolist() == [3, 2]
    assert pv.trace_variant.tolist() == [0, 0, 0, 1, 1]
    assert pv.sequences == [[names[i] for i in s1], [names[i] for i in s2]]

    ref_eng, port_eng = _engines()
    want_ref = ref_query.Q.log(ref).using(ref_eng).top_variants(1).dfg().value
    got = port_query.Q.log(port).using(port_eng).top_variants(1).dfg().value
    # the exact oracle: the pairs of the three traces of the first sequence
    s1 = np.asarray(s1)
    oracle = 3 * dfg_numpy(s1[:-1], s1[1:], np.ones(s1.shape[0] - 1, bool), 600)
    np.testing.assert_array_equal(got, oracle)
    # the reference keeps all five traces, so its Ψ holds the second
    # sequence's pairs as well
    assert int(want_ref.sum()) == 5 * 10 and int(got.sum()) == 3 * 10
    assert not np.array_equal(got, want_ref)
    # the variants sink and the filtered repository split the same way
    res = port_query.Q.log(port).using(port_eng).variants()
    assert res.value.counts.tolist() == [3, 2]
    filt = port_variants.variant_filtered_repository(port, 1)
    assert filt.trace_names == ["t1", "t2", "t3"]
    assert ref_variants.variant_filtered_repository(ref, 1).num_traces == 5


# ---------------------------------------------------------------------------
# the variants sink
# ---------------------------------------------------------------------------


VARIANT_KS = [None, 0, 1, 3, "tie", 10**6, -2]
VARIANT_CHAINS = {
    "plain": [],
    "window": [("window", (10 * DAY, 80 * DAY))],
    "activities": [("activities", (KEEP,))],
    "window_activities": [
        ("window", (5 * DAY, 60 * DAY)), ("activities", (NAMES[1:8],)),
    ],
    "empty_window": [("window", (50 * DAY, 20 * DAY))],
    "top_variants": [("top_variants", (5,))],
    "relink": [("activities", (KEEP, True))],
    "relink_window": [("activities", (KEEP, True)), ("window", (0.0, 90 * DAY))],
}


@pytest.mark.parametrize("k", VARIANT_KS, ids=str)
@pytest.mark.parametrize("chain", sorted(VARIANT_CHAINS))
def test_variants_sink_matches_reference(repos, chain, k):
    if k == "tie":
        k = _tie_k(repos[0])
    port_res, ref_res, port_eng, ref_eng = _both(
        repos, VARIANT_CHAINS[chain], "variants", k
    )
    assert port_res.names is None
    assert port_res.physical.backend == "numpy"
    _assert_same_result(port_res, ref_res)
    assert port_eng.stats.rows_scanned == ref_eng.stats.rows_scanned
    # k truncates the variants, never the trace → variant map
    full = port_query.Q.log(repos[0]).using(port_eng)
    full = _build(full, VARIANT_CHAINS[chain]).variants().value
    np.testing.assert_array_equal(
        port_res.value.trace_variant, full.trace_variant
    )


def test_variants_sink_on_memmap_matches_reference(memmap):
    for k in (None, 4):
        port_res, ref_res, _, _ = _both(memmap, [], "variants", k)
        assert port_res.physical.materialize
        _assert_same_result(port_res, ref_res)


def test_variants_property_counts_on_the_tie(repos):
    """The tie at the boundary keeps the reference's hash order: the kept
    variant of a tie run is the same one in both packages."""
    port, ref = repos
    for k in (1, _tie_k(port)):
        tv_r = ref_variants.trace_variants(ref)
        tv_p = port_variants.trace_variants(port)
        assert tv_p.counts[k - 1] == tv_p.counts[k]
        assert tv_p.sequences[:k] == tv_r.sequences[:k]
        _same_repo(
            port_variants.variant_filtered_repository(port, k),
            ref_variants.variant_filtered_repository(ref, k),
        )


# ---------------------------------------------------------------------------
# barriers in front of every sink
# ---------------------------------------------------------------------------


BARRIER_CHAINS = {
    "top1": [("top_variants", (1,))],
    "top_tie": [("top_variants", ("tie",))],
    "top0": [("top_variants", (0,))],
    "relink": [("activities", (KEEP, True))],
    "relink_window": [
        ("activities", (KEEP, True)), ("window", (10 * DAY, 80 * DAY)),
    ],
    "top_window": [("top_variants", (6,)), ("window", (5 * DAY, 60 * DAY))],
    # a window before the barrier applies at the sink, after it
    "window_top": [("window", (0.0, 40 * DAY)), ("top_variants", (6,))],
    "windows_across_top": [
        ("window", (0.0, 90 * DAY)), ("top_variants", (8,)),
        ("window", (30 * DAY, 1e9)),
    ],
    "top_activities_view": [
        ("top_variants", (9,)), ("activities", (NAMES[1:9],)),
        ("view", (VIEW,)),
    ],
    "relink_top": [("activities", (KEEP, True)), ("top_variants", (3,))],
    "empty_window_top": [
        ("window", (50 * DAY, 20 * DAY)), ("top_variants", (3,)),
    ],
}


def _chain(name, repo):
    return [
        (m, (_tie_k(repo),) if args == ("tie",) else args)
        for m, args in BARRIER_CHAINS[name]
    ]


@pytest.mark.parametrize("backend", ["auto", "numpy", "scatter", "onehot", "kernel"])
@pytest.mark.parametrize("chain", sorted(BARRIER_CHAINS))
def test_barrier_dfg_matches_reference(repos, chain, backend):
    port_res, ref_res, port_eng, ref_eng = _both(
        repos, _chain(chain, repos[0]), "dfg", backend=backend,
        engine_kw=dict(tiny_pairs=64),
    )
    assert isinstance(port_res.value, np.ndarray), port_res
    assert port_res.logical.has_barrier()
    _assert_same_result(port_res, ref_res)
    assert port_eng.stats.rows_scanned == ref_eng.stats.rows_scanned


@pytest.mark.parametrize("sink", ["histogram", "process_map", "neighborhood"])
@pytest.mark.parametrize("chain", ["top1", "relink_window", "top_activities_view"])
def test_barrier_other_sinks_match_reference(repos, chain, sink):
    args = ("g1",) if chain == "top_activities_view" else (NAMES[2],)
    args = args if sink == "neighborhood" else ()
    kw = dict(direction="both", k=2) if sink == "neighborhood" else {}
    port_res, ref_res, _, _ = _both(
        repos, _chain(chain, repos[0]), sink, *args, **kw,
        engine_kw=dict(tiny_pairs=64),
    )
    _assert_same_result(port_res, ref_res)


@pytest.mark.parametrize("backend", ["auto", "kernel"])
@pytest.mark.parametrize("chain", ["top1", "top_tie", "relink_window", "window_top"])
def test_barrier_on_materialized_memmap_matches_reference(memmap, chain, backend):
    port_res, ref_res, port_eng, ref_eng = _both(
        memmap, _chain(chain, port_query.repository_from_memmap(memmap[0])),
        "dfg", backend=backend, engine_kw=dict(tiny_pairs=64),
    )
    assert port_res.physical.materialize
    _assert_same_result(port_res, ref_res)
    assert port_eng.stats.rows_scanned == ref_eng.stats.rows_scanned


def test_barrier_plan_keys_and_rewrites_match_reference(repos):
    """Canonicalization runs per segment: predicates fuse inside one and
    never cross a barrier, in both packages, with the same keys."""
    port, ref = repos
    chain = [
        ("window", (0.0, 90 * DAY)), ("window", (10 * DAY, 1e9)),
        ("activities", (KEEP,)), ("activities", (NAMES[:4],)),
        ("top_variants", (4,)),
        ("window", (-np.inf, np.inf)), ("activities", (NAMES,)),
        ("activities", (NAMES[2:], True)),
        ("view", (VIEW,)), ("view", ({"g0": "x", "g1": "x"},)),
    ]
    ref_eng, port_eng = _engines(tiny_pairs=64)
    qr = _build(ref_query.Q.log(ref).using(ref_eng), chain)
    qp = _build(port_query.Q.log(port).using(port_eng), chain)
    rl, rn = ref_query.canonicalize(
        qr.logical_plan(ref_query.DFGSink()), ref.activity_names
    )
    pl, pn = port_query.canonicalize(
        qp.logical_plan(port_query.DFGSink()), port.activity_names
    )
    assert pn == rn
    assert "fuse_windows" in pn and "drop_infinite_window" in pn
    assert pl._payload() == rl._payload()
    assert pl.key() == rl.key()
    assert pl.has_barrier() and [type(o).__name__ for o in pl.ops] == [
        "Window", "Activities", "TopVariants", "Activities", "ApplyView"
    ]
    _assert_same_result(qp.dfg(), qr.dfg())


# ---------------------------------------------------------------------------
# planner branches and errors
# ---------------------------------------------------------------------------


def _guard_cases():
    top = [("top_variants", (2,))]
    relink = [("activities", (KEEP, True))]
    view = [("view", (VIEW,))]
    small, big = dict(memory_budget_events=100), dict()
    return {
        # out of core: every materializing op and the variants sink refuse
        "ooc_top_dfg": ("memmap", small, top, "dfg", (), {}),
        "ooc_relink_dfg": ("memmap", small, relink, "dfg", (), {}),
        "ooc_top_streaming": ("memmap", small, top, "dfg", (), dict(backend="streaming")),
        "ooc_top_histogram": ("memmap", small, top, "histogram", (), {}),
        "ooc_variants": ("memmap", small, [], "variants", (), {}),
        "ooc_top_fitness": ("memmap", small, top, "fitness", (), {}),
        "ooc_top_alignments": ("memmap", small, top, "alignments", (), {}),
        # in budget: no streaming, no graph behind a barrier
        "top_streaming": ("memmap", big, top, "dfg", (), dict(backend="streaming")),
        "top_fitness_streaming": (
            "memmap", big, top, "fitness", (), dict(backend="streaming")),
        "top_histogram_graph_memmap": (
            "memmap", big, top, "histogram", (), dict(backend="graph")),
        "top_graph": ("repository", big, top, "dfg", (), dict(backend="graph")),
        "top_process_map_graph": (
            "repository", big, top, "process_map", (), dict(backend="graph")),
        "relink_fitness_graph": (
            "repository", big, relink, "fitness", (), dict(backend="graph")),
        "top_alignments_graph": (
            "repository", big, top, "alignments", (), dict(backend="graph")),
        # a pinned graph histogram behind a barrier counts on the host
        "top_histogram_graph_repo": (
            "repository", big, top, "histogram", (), dict(backend="graph")),
        # the memmap's materialized path behind a barrier
        "top_histogram_memmap": ("memmap", big, top, "histogram", (), {}),
        # views cannot be hoisted across a barrier, nor feed a variant table
        "view_top": ("repository", big, view + top, "dfg", (), {}),
        "view_relink": ("repository", big, view + relink, "dfg", (), {}),
        "view_variants": ("repository", big, view, "variants", (), {}),
        "unknown_relink": (
            "repository", big, [("activities", (["nope"], True))], "dfg", (), {}),
        "relink_after_view_top": (
            "repository", big, top + view + relink, "dfg", (), {}),
    }


GUARDS = _guard_cases()


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_barrier_planner_branches_match_reference(repos, memmap, case):
    src, engine_kw, chain, sink, args, kw = GUARDS[case]
    sources = repos if src == "repository" else memmap
    port_res, ref_res, _, _ = _both(
        sources, chain, sink, *args, engine_kw=engine_kw, **kw
    )
    _assert_same_result(port_res, ref_res)
    should_raise = not case.startswith(("top_histogram_graph_repo",
                                        "top_histogram_memmap"))
    assert isinstance(port_res, port_query.QueryPlanError) == should_raise


def test_barrier_queries_never_count_toward_the_graph_crossover(repos):
    """Barrier plans neither build nor count toward the source's graph: the
    third plain topology miss routes to the graph in both engines, however
    many barrier queries came before."""
    port, ref = repos
    ref_eng, port_eng = _engines(graph_crossover=3, tiny_pairs=64)
    backends = []
    for eng, q in ((ref_eng, ref_query.Q.log(ref)), (port_eng, port_query.Q.log(port))):
        q = q.using(eng)
        seen = [q.top_variants(k).dfg().physical.backend for k in (1, 2, 3, 4)]
        seen += [q.window(0.0, d * DAY).dfg().physical.backend for d in (40, 50)]
        seen += [q.dfg().physical.backend, q.top_variants(5).dfg().physical.backend]
        backends.append([port_backend(b) for b in seen])
    assert backends[0] == backends[1]
    assert backends[1][-2:] == ["graph", "scatter"]


# ---------------------------------------------------------------------------
# conformance behind a barrier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sink", ["alignments", "fitness"])
@pytest.mark.parametrize("src", ["repository", "memmap"])
@pytest.mark.parametrize(
    "chain", ["top1", "top_tie", "relink", "top_window", "windows_across_top"]
)
def test_conformance_behind_a_barrier_matches_reference(
    repos, memmap, src, chain, sink
):
    sources = repos if src == "repository" else memmap
    repo = (
        repos[0] if src == "repository"
        else port_query.repository_from_memmap(memmap[0])
    )
    port_res, ref_res, port_eng, ref_eng = _both(
        sources, _chain(chain, repo), sink
    )
    assert not isinstance(port_res, Exception), port_res
    _assert_same_result(port_res, ref_res)
    assert port_eng.stats.rows_scanned == ref_eng.stats.rows_scanned
    if sink == "alignments":
        assert port_res.physical.backend == "numpy"
        assert port_res.physical.materialize == (src == "memmap")


def test_default_model_is_discovered_on_the_filtered_log(repos):
    """``top_variants(k).alignments()`` keys its default model on the
    barrier: after a plain ``alignments()`` on one engine it discovers a
    new model on the filtered log, as the reference does, and a pinned
    model of that discovery gives the same costs."""
    port, ref = repos
    ref_eng, port_eng = _engines()
    pq, rq = port_query.Q.log(port).using(port_eng), ref_query.Q.log(ref).using(ref_eng)
    for build in (lambda q: q.alignments(), lambda q: q.top_variants(3).alignments(),
                  lambda q: q.top_variants(3).window(0.0, 60 * DAY).alignments(),
                  lambda q: q.activities(KEEP, relink=True).fitness()):
        _assert_same_result(build(pq), build(rq))
    assert len(port_eng._model_memo) == len(ref_eng._model_memo) == 3
    filt = port_variants.variant_filtered_repository(port, 3)
    plain = port_query.Q.log(filt).using(_engines()[1]).alignments().value
    np.testing.assert_array_equal(
        pq.top_variants(3).alignments().value.trace_cost, plain.trace_cost
    )


# ---------------------------------------------------------------------------
# the vectorized remaps, pinned
# ---------------------------------------------------------------------------


@st.composite
def _logs(draw):
    """(port, reference) repositories of one random event table: up to 12
    cases of up to 60 events over five activities, random times."""
    seed = draw(st.integers(0, 2**31 - 1))
    n = draw(st.integers(0, 60))
    cases = draw(st.integers(1, 12))
    rng = np.random.default_rng(seed)
    c = [f"c{int(x)}" for x in rng.integers(0, cases, n)]
    a = [f"a{int(x)}" for x in rng.integers(0, 5, n)]
    t = np.round(rng.uniform(0.0, 100.0, n), 1).tolist()
    port = PortRepository.from_event_table(c, a, t)
    ref = RefRepository.from_event_table(c, a, t)
    _same_repo(port, ref)
    return port, ref


@settings(max_examples=60, deadline=None)
@given(
    logs=_logs(),
    window=st.one_of(
        st.none(),
        st.tuples(st.floats(-10.0, 110.0), st.floats(-10.0, 110.0)),
    ),
    keep=st.one_of(
        st.none(),
        st.lists(st.sampled_from([f"a{i}" for i in range(5)]), max_size=5),
    ),
)
def test_dice_repository_matches_reference(logs, window, keep):
    """Time, activities, both and neither; empty results included."""
    port, ref = logs
    if keep is not None:
        keep = [k for k in keep if k in port.activity_names]
    got = port_dicing.dice_repository(port, time_window=window, activities=keep)
    want = ref_dicing.dice_repository(ref, time_window=window, activities=keep)
    _same_repo(got, want)


def _filtered_by_loop(repo, tv, k):
    """The reference's per-event remap (a dict, one lookup per kept event),
    driven by the port's own variant table."""
    keep_tr = np.nonzero(tv.trace_variant < k)[0]
    idx = np.nonzero(np.isin(repo.event_trace, keep_tr))[0]
    old_to_new = {int(o): n for n, o in enumerate(keep_tr.tolist())}
    return PortRepository(
        event_activity=repo.event_activity[idx].copy(),
        event_trace=np.asarray(
            [old_to_new[int(x)] for x in repo.event_trace[idx]], np.int32
        ),
        event_time=repo.event_time[idx].copy(),
        trace_log=repo.trace_log[keep_tr].copy(),
        activity_names=list(repo.activity_names),
        trace_names=[repo.trace_names[int(x)] for x in keep_tr],
        log_names=list(repo.log_names),
    )


@settings(max_examples=60, deadline=None)
@given(logs=_logs(), k=st.integers(-1, 14))
def test_variant_filtered_repository_matches_reference(logs, k):
    """Column for column and name for name equal to the reference's where
    its hash is exact (k = 0 and empty logs included); where the
    reference's hash merges two sequences, equal to the reference's
    per-event remap driven by the port's exact table."""
    port, ref = logs
    got = port_variants.variant_filtered_repository(port, k)
    _same_repo(got, _filtered_by_loop(port, port_variants.trace_variants(port), k))
    if not _collides(port):
        _same_repo(got, ref_variants.variant_filtered_repository(ref, k))
    if k <= 0:
        assert got.num_events == 0 and got.num_traces == 0


@settings(max_examples=40, deadline=None)
@given(
    traces=st.lists(
        st.lists(st.sampled_from(["a", "b", "c", "d"]), min_size=1, max_size=8),
        min_size=0, max_size=30,
    )
)
def test_variants_property_counts(traces):
    """The port's counts are the exact dict-of-tuples counts; the
    reference's equal them wherever its hash does not merge."""
    port = PortRepository.from_traces(traces)
    tv = port_variants.trace_variants(port)
    exact = collections.Counter(tuple(t) for t in traces)
    assert tv.num_variants == len(exact)
    assert sorted(tv.counts.tolist(), reverse=True) == sorted(
        exact.values(), reverse=True
    )
    assert int(tv.counts.sum()) == len(traces)
    assert sorted(map(tuple, tv.sequences)) == sorted(exact)
    if not _collides(port):
        _same_variants(tv, ref_variants.trace_variants(_ref_of(port)))
