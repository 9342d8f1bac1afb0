"""The conformance slice of the port (``repro_torch.conformance``, the
``align_dp`` kernel's plain version and the engine's ``fitness()`` /
``alignments()`` paths) against the reference (``repro.conformance``,
``repro.kernels.align_dp``, ``repro.query``) on the CPU.

The same inputs, made from numpy seeds, go through both packages.  Every
tolerance is 0: replay fitness is a ratio of the same integers in the same
float64 arithmetic, and the alignment DP is f32 adds and mins in the same
order, so costs must agree bit for bit.  The reference's ``align_dp`` runs
both its numpy oracle and its Pallas kernel in interpret mode; the port's
runs its plain PyTorch version on CPU tensors and its numpy copy.
"""

import dataclasses
import itertools
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.conformance as ref_conf
import repro.conformance.align as ref_align
import repro.core.conformance as ref_core_conf
import repro.core.variants as ref_variants
import repro.data.synthetic_log as ref_synth
import repro.graph as ref_graph
import repro.query as ref_query
import repro_torch.conformance as port_conf
import repro_torch.core.conformance as port_core_conf
import repro_torch.core.variants as port_variants
import repro_torch.data.synthetic_log as port_synth
import repro_torch.graph as port_graph
import repro_torch.query as port_query
from repro.core.discovery import discover_dependency_graph as ref_discover
from repro.core.repository import EventRepository as RefRepository
from repro.core.streaming import MemmapLog as RefMemmapLog
from repro.kernels.align_dp import align_dp as ref_align_dp
from repro.query.execute import repository_from_memmap as ref_from_memmap
from repro_torch.core.dfg import dfg_numpy
from repro_torch.core.discovery import discover_dependency_graph as port_discover
from repro_torch.core.repository import EventRepository as PortRepository
from repro_torch.core.streaming import MemmapLog as PortMemmapLog
from repro_torch.kernels import build
from repro_torch.kernels.align_dp import ops as dp_ops

DAY = 86400.0
A = 10


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _random_spec(rng, names, extra=(), p_edge=0.3, starts=2, ends=2):
    """(port ModelSpec, reference ModelSpec) of one random model over
    ``names`` plus model-only activities ``extra``."""
    acts = list(names) + list(extra)
    edges = tuple(
        (x, y) for x in acts for y in acts if rng.random() < p_edge
    )
    fields = dict(
        activities=tuple(acts), edges=edges,
        starts=tuple(str(x) for x in rng.choice(acts, starts)) if starts else (),
        ends=tuple(str(x) for x in rng.choice(acts, ends)) if ends else (),
    )
    return port_conf.ModelSpec(**fields), ref_conf.ModelSpec(**fields)


def _columns(rng, num_traces, num_acts, max_len=9, sorted_traces=True):
    lens = rng.integers(1, max_len + 1, num_traces)
    t = np.repeat(np.arange(num_traces), lens).astype(np.int32)
    if not sorted_traces:  # trace-contiguous, trace ids in shuffled order
        perm = rng.permutation(num_traces).astype(np.int32)
        t = perm[t]
    a = rng.integers(0, num_acts, t.shape[0]).astype(np.int32)
    return a, t


def _same_replay(port, ref):
    np.testing.assert_array_equal(port.trace_fitness, ref.trace_fitness)
    assert port.trace_fitness.dtype == ref.trace_fitness.dtype
    assert port.fitness == ref.fitness
    assert port.perfectly_fitting == ref.perfectly_fitting
    assert port.deviating_edges == ref.deviating_edges


def _same_alignment(port, ref):
    for f in ("trace_cost", "trace_fitness", "variant_costs"):
        got, want = getattr(port, f), getattr(ref, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert port.fitness == ref.fitness
    assert port.perfectly_fitting == ref.perfectly_fitting
    assert port.empty_cost == ref.empty_cost
    assert port.deviating_edges == ref.deviating_edges
    assert port.summary() == ref.summary()


def _same_value(port, ref):
    if isinstance(ref, ref_conf.AlignmentResult):
        assert isinstance(port, port_conf.AlignmentResult)
        _same_alignment(port, ref)
    else:
        assert isinstance(port, port_conf.ReplayResult)
        _same_replay(port, ref)
        assert port.summary() == ref.summary()


# ---------------------------------------------------------------------------
# core: model tables, census, replay, variants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_model_tables_and_census_match_reference(seed):
    rng = np.random.default_rng(seed)
    names = [f"a{i}" for i in range(int(rng.integers(2, 12)))]
    # the model knows activities the log lacks, and misses some it has
    known = names[: len(names) - 1]
    port_spec, ref_spec = _random_spec(rng, known, extra=("ghost", "m2"))
    for got, want in zip(
        port_conf.model_tables(port_spec, names),
        ref_conf.model_tables(ref_spec, names),
    ):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    src = rng.integers(0, len(names), 3000)
    dst = rng.integers(0, len(names), 3000)
    assert port_conf.deviation_census(src, dst, names) == (
        ref_conf.deviation_census(src, dst, names)
    )
    empty = np.zeros(0, np.int64)
    assert port_conf.deviation_census(empty, empty, names) == {}


def test_model_spec_matches_reference_from_a_discovered_model():
    repo = port_synth.generate_repository(80, port_synth.ProcessSpec(6, seed=3), seed=3)
    s, d, v = repo.df_pairs()
    psi = dfg_numpy(s, d, v, repo.num_activities)
    starts, ends = repo.trace_boundaries()
    port_model = port_discover(psi, repo.activity_names, starts, ends, min_dependency=0.2)
    ref_model = ref_discover(psi, repo.activity_names, starts, ends, min_dependency=0.2)
    got = port_conf.ModelSpec.from_model(port_model)
    want = ref_conf.ModelSpec.from_model(ref_model)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port_conf.ModelSpec.from_model(got) is got


@pytest.mark.parametrize(
    "case", ["random", "unsorted_traces", "empty_traces", "one_event", "empty"]
)
def test_replay_core_matches_reference(case):
    rng = np.random.default_rng(7)
    a, t = _columns(rng, 60, 8, sorted_traces=case != "unsorted_traces")
    T = 60
    if case == "empty_traces":
        T = 75  # 15 traces own no event
    elif case == "one_event":
        a, t = a[:1], t[:1]
    elif case == "empty":
        a, t = a[:0], t[:0]
    names = [f"a{i}" for i in range(8)]
    port_spec, ref_spec = _random_spec(rng, names, p_edge=0.4)
    tables = port_conf.model_tables(port_spec, names)
    got = port_core_conf.replay_core(a, t, T, *tables)
    want = ref_core_conf.replay_core(a, t, T, *tables)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _port_repo_of(traces, vocab=None):
    return PortRepository.from_traces(traces, activity_vocab=vocab)


def _ref_repo_of(traces, vocab=None):
    return RefRepository.from_traces(traces, activity_vocab=vocab)


def _exact_groups(a, t, T):
    """trace → its activity-id sequence (tuple), by a Python loop: the
    oracle of exact variant grouping."""
    seqs = [[] for _ in range(T)]
    for x, r in zip(a.tolist(), t.tolist()):
        seqs[r].append(x)
    return [tuple(x) for x in seqs]


def _groups_are_exact(tv, a, t, T):
    """Every variant of ``tv`` holds traces of one sequence, distinct
    variants hold distinct sequences, and the counts are the group sizes."""
    if tv.num_variants == 0:  # no events: every trace maps to variant 0
        return a.shape[0] == 0
    seqs = _exact_groups(a, t, T)
    by_variant = {}
    for r, v in enumerate(np.asarray(tv.trace_variant).tolist()):
        by_variant.setdefault(v, set()).add(seqs[r])
    return (
        all(len(x) == 1 for x in by_variant.values())
        and len({next(iter(x)) for x in by_variant.values()}) == len(by_variant)
        and sorted(np.bincount(tv.trace_variant).tolist()) == sorted(tv.counts.tolist())
    )


@pytest.fixture()
def exact_ref_variants(monkeypatch):
    """Point the reference's alignments at an exact variant table.

    The reference's rolling hash maps different sequences to one value
    often (two sequences with equal Σ(a+1) and Σ(a+1)(i+1) nearly always
    collide), and its ``variant_table`` then merges them, so a trace is
    charged the cost of another sequence.  The port groups exactly (see
    ``test_variant_table_matches_reference`` and
    ``test_variant_table_splits_hash_collisions``).  To compare everything
    else — cost tables, the DP, broadcast, normalization, census, planning
    — the reference's alignments here read the port's exact table, as the
    reference's own ``TraceVariants``."""

    def exact(event_activity, event_trace, num_traces, activity_names):
        tv = port_variants.variant_table(
            event_activity, event_trace, num_traces, activity_names
        )
        return ref_variants.TraceVariants(
            counts=tv.counts, sequences=tv.sequences,
            trace_variant=tv.trace_variant,
        )

    monkeypatch.setattr(ref_align, "variant_table", exact)


def _same_variants(got, want):
    assert got.num_variants == want.num_variants
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.counts.dtype == want.counts.dtype
    np.testing.assert_array_equal(got.trace_variant, want.trace_variant)
    assert got.sequences == want.sequences
    assert got.coverage(2) == want.coverage(2)
    np.testing.assert_array_equal(
        got.lengths, [len(s) for s in want.sequences]
    )


@pytest.mark.parametrize(
    "case",
    ["random", "unsorted_traces", "empty_traces", "single_events", "empty",
     "collisions"],
)
def test_variant_table_matches_reference(case):
    """Where the reference's hash groups exactly, the tables agree variant
    for variant; on short sequences over few activities (``collisions``)
    the reference merges different sequences, and the port's exact
    variants refine the reference's."""
    rng = np.random.default_rng(11)
    names = [f"a{i}" for i in range(12)]
    if case == "collisions":
        a, t = _columns(rng, 300, 5, max_len=4)
    else:
        a, t = _columns(rng, 60, 12, sorted_traces=case != "unsorted_traces")
    T = int(t.max()) + 1
    if case == "empty_traces":
        T += 15
    elif case == "single_events":
        t = np.arange(a.shape[0], dtype=np.int32)
        T = a.shape[0]
    elif case == "empty":
        a, t, T = a[:0], t[:0], 7
    got = port_variants.variant_table(a, t, T, names)
    want = ref_variants.variant_table(a, t, T, names)
    assert _groups_are_exact(got, a, t, T)
    if case != "collisions":
        assert _groups_are_exact(want, a, t, T)
        _same_variants(got, want)
        return
    assert not _groups_are_exact(want, a, t, T)
    assert got.num_variants > want.num_variants
    refine = {}
    for p, r in zip(got.trace_variant.tolist(), want.trace_variant.tolist()):
        assert refine.setdefault(p, r) == r
    assert got.counts.sum() == want.counts.sum()


def test_trace_variants_of_a_repository_match_reference():
    traces = [["a", "b"], ["a"], ["a", "b"], ["b", "a", "a"], ["a"], ["a", "b"]]
    _same_variants(
        port_variants.trace_variants(_port_repo_of(traces)),
        ref_variants.trace_variants(_ref_repo_of(traces)),
    )
    _same_variants(
        port_variants.trace_variants(_port_repo_of([])),
        ref_variants.trace_variants(_ref_repo_of([])),
    )


#: two 8-event sequences over 40 activities whose rolling hashes collide
#: (found in a 60,000-event synthetic log)
COLLIDING = (
    [19, 20, 26, 19, 35, 6, 26, 12],
    [19, 20, 26, 12, 32, 24, 27, 3],
)


@pytest.mark.parametrize("extra", [0, 1])
def test_variant_table_splits_hash_collisions(extra):
    """The reference merges two different sequences that share a hash into
    one variant; the port's grouping is exact and keeps them apart, and
    their alignment costs are each trace's own."""
    names = [f"a{i}" for i in range(40)]
    traces = list(COLLIDING) + [[1, 2]] * extra + [COLLIDING[1]]
    a = np.concatenate([np.asarray(x, np.int32) for x in traces])
    t = np.repeat(np.arange(len(traces)), [len(x) for x in traces]).astype(np.int32)
    want = ref_variants.variant_table(a, t, len(traces), names)
    assert want.counts[0] == 3  # the reference: one variant for both
    got = port_variants.variant_table(a, t, len(traces), names)
    assert _groups_are_exact(got, a, t, len(traces))
    tv = got.trace_variant
    assert got.num_variants == 2 + extra
    assert tv[1] == tv[-1] == 0 and got.counts[0] == 2
    assert got.sequences[0] == [names[i] for i in COLLIDING[1]]
    assert got.sequences[tv[0]] == [names[i] for i in COLLIDING[0]]
    # alignments: each trace costs what it costs alone
    spec = port_conf.ModelSpec(
        activities=tuple(names),
        edges=tuple((names[x], names[y]) for x, y in zip(COLLIDING[0], COLLIDING[0][1:])),
        starts=(names[19],), ends=(names[12],),
    )
    res = port_conf.align_arrays(a, t, names, spec, len(traces), device="cpu")
    alone = [
        port_conf.align_arrays(
            np.asarray(x, np.int32), np.zeros(len(x), np.int32), names, spec,
            1, device="cpu",
        ).trace_cost[0]
        for x in traces
    ]
    np.testing.assert_array_equal(res.trace_cost, alone)
    assert alone[0] == 0 and alone[1] > 0


# ---------------------------------------------------------------------------
# alignments: cost tables and the DP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "case", ["random0", "random1", "model_only", "no_start", "no_end", "no_edges"]
)
def test_alignment_cost_tables_match_reference(case):
    rng = np.random.default_rng({"random0": 0, "random1": 1}.get(case, 5))
    names = [f"a{i}" for i in range(9)]
    kw = {}
    if case == "model_only":
        kw["extra"] = ("m0", "m1", "m2")
    elif case == "no_start":
        kw["starts"] = 0
    elif case == "no_end":
        kw["ends"] = 0
    elif case == "no_edges":
        kw["p_edge"] = 0.0
    port_spec, ref_spec = _random_spec(rng, names, **kw)
    got = port_conf.alignment_cost_tables(port_spec, names)
    want = ref_conf.alignment_cost_tables(ref_spec, names)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))


def _dp_inputs(case: str):
    """(seqs, lens, m, d0, endcost) of one DP case, from a numpy seed."""
    seed, _, rest = case.partition(":")
    rng = np.random.default_rng(int(seed))
    a = int(rng.integers(3, 14))
    if rest == "lane_plus_one":
        a = 128  # S = 129 states: one above the reference's lane multiple
    names = [f"a{i}" for i in range(a)]
    kw = dict(starts=0) if rest == "unalignable" else {}
    port_spec, _ = _random_spec(rng, names, **kw)
    m, d0, endc = port_conf.alignment_cost_tables(port_spec, names)
    v, l = int(rng.integers(1, 50)), int(rng.integers(1, 40))
    if rest == "v0":
        v = 0
    elif rest == "l1":
        l = 1
    seqs = rng.integers(0, a, (v, l)).astype(np.int32)
    lens = rng.integers(1, l + 1, v).astype(np.int32)
    if rest == "lens0":
        lens[::2] = 0
    return seqs, lens, m, d0, endc


def _ragged(seqs, lens):
    """(ids, offsets) of a padded (seqs, lens): the active positions row
    after row and the rows' bounds."""
    lens = np.clip(np.asarray(lens, np.int64), 0, seqs.shape[1])
    active = np.arange(seqs.shape[1])[None, :] < lens[:, None]
    return seqs[active], np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


#: the sweep of tests/test_conformance_subsystem.py plus the edge cases
DP_CASES = [f"{s}:" for s in (17, 18, 19, 20)] + [
    "21:v0", "22:l1", "23:lens0", "24:unalignable", "25:lane_plus_one",
]


@pytest.mark.parametrize("case", DP_CASES)
def test_align_dp_matches_reference_numpy_and_pallas_interpret(case):
    seqs, lens, m, d0, endc = _dp_inputs(case)
    want = ref_align_dp(seqs, lens, m, d0, endc, backend="numpy")
    outs = {
        "numpy": dp_ops.align_dp(seqs, lens, m, d0, endc, backend="numpy"),
        "kernel": dp_ops.align_dp(
            seqs, lens, m, d0, endc, backend="kernel", device="cpu"
        ),
        "auto": dp_ops.align_dp(seqs, lens, m, d0, endc, device="cpu"),
        "plain": dp_ops.align_dp_plain(
            *dp_ops.prepare(seqs, lens, m, d0, endc, "cpu")
        ).numpy(),
    }
    ids, offsets = _ragged(seqs, lens)
    for backend in ("auto", "kernel", "numpy"):
        outs[f"ragged {backend}"] = dp_ops.align_dp_ragged(
            ids, offsets, m, d0, endc, backend=backend, device="cpu"
        )
    outs["ragged plain"] = dp_ops.align_dp_plain(
        *dp_ops.prepare_ragged(ids, offsets, m, d0, endc, "cpu")
    ).numpy()
    if seqs.shape[0]:
        outs["pallas"] = ref_align_dp(
            seqs, lens, m, d0, endc, backend="pallas", interpret=True
        )
        np.testing.assert_array_equal(outs["pallas"], want)
    for name, got in outs.items():
        assert got.dtype == np.float32 and got.shape == want.shape, name
        # bit for bit: compare the f32 bit patterns
        np.testing.assert_array_equal(
            got.view(np.uint32), want.view(np.uint32), err_msg=name
        )


def test_padded_states_never_win_on_unreachable_inputs():
    """The reference pads the state axis with BIG_COST states; the port does
    not.  On inputs where nothing is reachable (every cost BIG_COST) or only
    some states are, both give the same bits."""
    big = np.float32(dp_ops.BIG_COST)
    rng = np.random.default_rng(3)
    seqs = rng.integers(0, 5, (12, 7)).astype(np.int32)
    lens = rng.integers(0, 8, 12).astype(np.int32)
    cases = {
        "all_big": (np.full((6, 5), big), np.full(6, big), np.full(6, big)),
        "no_end": (
            rng.integers(0, 4, (6, 5)).astype(np.float32),
            np.where(np.arange(6) == 5, 0.0, big).astype(np.float32),
            np.full(6, big),
        ),
        "no_start": (
            rng.integers(0, 4, (6, 5)).astype(np.float32),
            np.full(6, big),
            rng.integers(0, 3, 6).astype(np.float32),
        ),
    }
    for name, (m, d0, endc) in cases.items():
        want = ref_align_dp(seqs, lens, m, d0, endc, backend="numpy")
        got = dp_ops.align_dp(seqs, lens, m, d0, endc, device="cpu")
        np.testing.assert_array_equal(
            got.view(np.uint32), want.view(np.uint32), err_msg=name
        )
        assert (got >= dp_ops.BIG_COST / 2).any(), name


def test_align_dp_rejects_what_the_kernel_cannot_take():
    seqs, lens, m, d0, endc = _dp_inputs("30:")
    a = m.shape[1]
    bad = seqs.copy()
    bad[0, 0] = a  # an id past the sync columns at an active position
    for backend in ("auto", "kernel", "numpy"):
        with pytest.raises(ValueError, match="activity ids"):
            dp_ops.align_dp(bad, lens, m, d0, endc, backend=backend, device="cpu")
    neg = seqs.copy()
    neg[0, 0] = -1
    with pytest.raises(ValueError, match="activity ids"):
        dp_ops.align_dp(neg, lens, m, d0, endc, device="cpu")
    # ids past a row's length are never read
    tail = seqs.copy()
    short = np.minimum(lens, seqs.shape[1] - 1)
    tail[np.arange(seqs.shape[0]), short] = 10**6
    np.testing.assert_array_equal(
        dp_ops.align_dp(tail, short, m, d0, endc, device="cpu"),
        ref_align_dp(seqs, short, m, d0, endc, backend="numpy"),
    )
    nan = m.copy()
    nan[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        dp_ops.align_dp(seqs, lens, nan, d0, endc, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        dp_ops.align_dp(seqs, lens, m, d0, endc, backend="pallas", device="cpu")


def test_align_dp_on_cpu_tensors_counts_no_launch():
    seqs, lens, m, d0, endc = _dp_inputs("31:")
    before = dict(dp_ops.launch_counts)
    inputs = dp_ops.prepare(seqs, lens, m, d0, endc, "cpu")
    out = dp_ops.align_dp_device(*inputs)
    assert out.device.type == "cpu" and out.dtype == torch.float32
    assert dp_ops.launch_counts == before


def test_lengths_past_the_matrix_are_clamped_like_the_reference():
    seqs, lens, m, d0, endc = _dp_inputs("32:")
    long = lens + 5
    long[0] = -3
    np.testing.assert_array_equal(
        dp_ops.align_dp(seqs, long, m, d0, endc, device="cpu"),
        ref_align_dp(seqs, long, m, d0, endc, backend="numpy"),
    )


RAGGED_CASES = ["some_empty", "all_empty", "no_variants", "one_long", "wide_ids"]


def _ragged_case(case):
    """(seqs, lens, m, d0, endcost) of one ragged-input case."""
    seqs, lens, m, d0, endc = _dp_inputs("40:")
    if case == "some_empty":
        lens[1::3] = 0
    elif case == "all_empty":
        lens[:] = 0
    elif case == "no_variants":
        seqs, lens = seqs[:0], lens[:0]
    elif case == "one_long":
        seqs = np.random.default_rng(41).integers(0, m.shape[1], (1, 200))
        lens = np.array([200])
    elif case == "wide_ids":  # int64 ids in range
        seqs = seqs.astype(np.int64)
    return seqs, lens, m, d0, endc


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ragged_prepare_and_plain_match_reference(case):
    """The ragged input (ids back to back + offsets) through prepare_ragged,
    align_dp_plain and align_dp_ragged equals the reference's padded
    align_dp bit for bit, the Pallas kernel in interpret mode included;
    prepare of the padded input gives the very same tensors."""
    seqs, lens, m, d0, endc = _ragged_case(case)
    ids, offsets = _ragged(seqs, lens)
    want = ref_align_dp(seqs, lens, m, d0, endc, backend="numpy")
    inputs = dp_ops.prepare_ragged(ids, offsets, m, d0, endc, "cpu")
    assert inputs[0].dtype == torch.int32 and inputs[1].dtype == torch.int64
    assert inputs[0].shape == (int(lens.sum()),)
    for x, y in zip(dp_ops.prepare(seqs, lens, m, d0, endc, "cpu"), inputs):
        assert x.dtype == y.dtype and torch.equal(x, y)
    outs = {
        "plain": dp_ops.align_dp_plain(*inputs).numpy(),
        **{b: dp_ops.align_dp_ragged(ids, offsets, m, d0, endc, backend=b,
                                     device="cpu")
           for b in ("auto", "kernel", "numpy")},
    }
    if seqs.shape[0] and case != "one_long":
        outs["pallas"] = ref_align_dp(
            seqs, lens, m, d0, endc, backend="pallas", interpret=True
        )
    for name, got in outs.items():
        assert got.dtype == np.float32 and got.shape == want.shape, name
        np.testing.assert_array_equal(
            got.view(np.uint32), want.view(np.uint32), err_msg=name
        )


def test_ragged_input_is_checked():
    seqs, lens, m, d0, endc = _dp_inputs("42:")
    ids, offsets = _ragged(seqs, lens)
    a = m.shape[1]
    bad_offsets = {
        "not from 0": offsets + 1,
        "falling": np.concatenate([[0], offsets[2:], offsets[1:2]]),
        "short of the ids": offsets[:-1],
    }
    for what, off in bad_offsets.items():
        for backend in ("auto", "numpy"):
            with pytest.raises(ValueError, match="offsets"):
                dp_ops.align_dp_ragged(ids, off, m, d0, endc, backend=backend,
                                       device="cpu")
    for bad in (a, -1, (1 << 32) + 1):
        wrong = ids.astype(np.int64)
        wrong[len(wrong) // 2] = bad
        for backend in ("auto", "numpy"):
            with pytest.raises(ValueError, match="activity ids"):
                dp_ops.align_dp_ragged(wrong, offsets, m, d0, endc,
                                       backend=backend, device="cpu")


def test_align_dp_device_refuses_more_sync_columns_than_states():
    """An Mᵀ of more rows than states would let an id name a state past the
    front; align_dp_device refuses it (and wrong shapes) on any device,
    while prepare_ragged's padded tables pass."""
    seqs, lens, m, d0, endc = _dp_inputs("43:")
    ids, offsets, mt, d0p, endp = dp_ops.prepare(seqs, lens, m, d0, endc, "cpu")
    assert mt.shape[0] <= mt.shape[1]
    tall = mt.new_zeros((mt.shape[1] + 1, mt.shape[1]))
    with pytest.raises(ValueError, match="rows"):
        dp_ops.align_dp_device(ids, offsets, tall, d0p, endp)
    with pytest.raises(ValueError, match="shape"):
        dp_ops.align_dp_device(ids, offsets, mt, d0p[:-1], endp)


def test_register_instances_match_the_kernel_source():
    """ops.REGISTER_INSTANCES lists the register tier's instances as the
    CUDA source declares them: (K, KLO), each serving 32·KLO < S ≤ 32·K,
    the ranges following one another without a gap, so that only slots
    k ≥ KLO bounds-test (at most twelve)."""
    src = (Path(dp_ops.__file__).parent / "csrc" / "align_dp.cu").read_text()
    body = src.split("#define ALIGN_DP_REGISTER_INSTANCES(X)")[1].split("#define")[0]
    pairs = [tuple(map(int, p)) for p in re.findall(r"X\((\d+), (\d+)\)", body)]
    assert tuple(pairs) == dp_ops.REGISTER_INSTANCES
    assert [lo for _, lo in pairs[1:]] == [k for k, _ in pairs[:-1]]
    assert all(0 < k - lo <= 12 for k, lo in pairs)
    assert pairs[-1][0] == 32


def test_ptxas_report_parses_registers_and_spills():
    report = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooILi20EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z3fooILi20EEvv
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 86 registers, used 0 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 380 bytes cmem[0]
"""
    assert build.ptxas_resources(report) == {
        "_Z3fooILi20EEvv": {"registers": 86, "spill_stores": 4,
                            "spill_loads": 12, "smem": 0, "cmem": 416},
        "_Z3barv": {"registers": 32, "spill_stores": 0, "spill_loads": 0,
                    "smem": 0, "cmem": 380},
    }


# ---------------------------------------------------------------------------
# alignments end to end
# ---------------------------------------------------------------------------


HAND_CASES = {
    "hand": (
        dict(activities=("a", "b", "c"), edges=(("a", "b"), ("b", "c")),
             starts=("a",), ends=("c",)),
        [["a", "b", "c"], ["a", "c"], ["a", "x", "c"], ["b"]],
        ["a", "b", "c", "x"],
        [0, 1, 2, 2],
    ),
    "unobserved_model_path": (
        dict(activities=("a", "m", "z"), edges=(("a", "m"), ("m", "z")),
             starts=("a",), ends=("z",)),
        [["a", "z"]], ["a", "z"], [1],
    ),
    "unalignable": (
        dict(activities=("a",), edges=(), starts=(), ends=()),
        [["a", "a"]], None, [2],
    ),
}


@pytest.mark.parametrize("case", sorted(HAND_CASES))
@pytest.mark.parametrize("backend", ["auto", "kernel", "numpy"])
def test_align_repository_hand_cases_match_reference(
    exact_ref_variants, case, backend
):
    spec, traces, vocab, costs = HAND_CASES[case]
    got = port_conf.align_repository(
        _port_repo_of(traces, vocab), port_conf.ModelSpec(**spec),
        backend=backend, device="cpu",
    )
    want = ref_conf.align_repository(
        _ref_repo_of(traces, vocab), ref_conf.ModelSpec(**spec)
    )
    np.testing.assert_array_equal(got.trace_cost, costs)
    _same_alignment(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_align_repository_random_logs_match_reference(exact_ref_variants, seed):
    rng = np.random.default_rng(seed)
    spec = dict(num_activities=7, seed=seed)
    port_repo = port_synth.generate_repository(
        120, port_synth.ProcessSpec(**spec), seed=seed
    )
    ref_repo = ref_synth.generate_repository(
        120, ref_synth.ProcessSpec(**spec), seed=seed
    )
    names = port_repo.activity_names
    port_spec, ref_spec = _random_spec(rng, names[:-1], extra=("ghost",))
    got = port_conf.align_repository(port_repo, port_spec, device="cpu")
    want = ref_conf.align_repository(ref_repo, ref_spec)
    _same_alignment(got, want)
    # the variant costs broadcast to traces; perfect traces fit replay too
    replay = port_conf.replay_fitness(port_repo, port_spec)
    assert ((got.trace_cost == 0) <= (replay.trace_fitness >= 1.0 - 1e-12)).all()


@pytest.mark.parametrize("names_order", ["table", "reversed"])
@pytest.mark.parametrize("backend", ["auto", "kernel", "numpy"])
@pytest.mark.parametrize("seed", [0, 1])
def test_align_variants_ragged_matches_reference(
    exact_ref_variants, seed, backend, names_order
):
    """align_variants hands the variant table's ragged ids (remapped where
    ``names`` orders the labels differently) straight to the DP; its costs
    equal the reference's align_variants on the same exact table, and
    align_arrays equals the reference's end to end; tolerance 0."""
    rng = np.random.default_rng(seed)
    vocab = [f"a{i}" for i in range(8)]
    a, t = _columns(rng, 60, len(vocab), max_len=40)
    a[t == 3] = 0  # a one-activity variant
    port_tv = port_variants.variant_table(a, t, 60, vocab)
    ref_tv = ref_variants.TraceVariants(
        counts=port_tv.counts, sequences=port_tv.sequences,
        trace_variant=port_tv.trace_variant,
    )
    names = vocab[::-1] if names_order == "reversed" else vocab
    port_spec, ref_spec = _random_spec(rng, names, extra=("ghost",))
    got, got_empty = port_conf.align_variants(
        port_tv, names, port_spec, backend=backend, device="cpu"
    )
    want, want_empty = ref_align.align_variants(ref_tv, names, ref_spec)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert got_empty == want_empty
    ids = port_conf.align.variant_ids(port_tv, names)
    assert [[names[i] for i in ids[o:e]] for o, e in zip(
        port_tv.variant_offsets[:-1], port_tv.variant_offsets[1:])] \
        == port_tv.sequences
    # end to end over the columns, the activity ids renumbered by names
    remap = np.asarray([names.index(x) for x in vocab], np.int32)
    _same_alignment(
        port_conf.align_arrays(remap[a], t, names, port_spec, 60,
                               backend=backend, device="cpu"),
        ref_conf.align_arrays(remap[a], t, names, ref_spec, 60),
    )


def test_engine_alignments_build_no_padded_matrix(monkeypatch):
    """The engine's DP input is the variant table's ragged ids: neither the
    padded (V, L) matrix nor a padded copy of it is built on the way."""

    def refuse(*_a, **_k):
        raise AssertionError("a padded (V, L) matrix was built")

    rng = np.random.default_rng(4)
    names = [f"a{i}" for i in range(6)]
    a, t = _columns(rng, 40, len(names), max_len=12)
    port_spec, _ = _random_spec(rng, names)
    want = port_conf.align_arrays(a, t, names, port_spec, 40, device="cpu")
    monkeypatch.setattr(port_conf.align, "variant_matrix", refuse)
    monkeypatch.setattr(dp_ops, "_padded_of_ragged", refuse)
    monkeypatch.setattr(dp_ops, "_ragged_of_padded", refuse)
    for backend in ("auto", "kernel"):
        got = port_conf.align_arrays(a, t, names, port_spec, 40,
                                     backend=backend, device="cpu")
        _same_alignment(got, want)


# ---------------------------------------------------------------------------
# the three replay paths
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mm_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_conf") / "log")
    port_synth.generate_memmap_log(
        path, 4000, port_synth.ProcessSpec(num_activities=A, seed=11),
        seed=11, batch_traces=80,
    )
    return path


def _models(repo_port, repo_ref, **kw):
    """(port DiscoveredModel, reference DiscoveredModel) of one repository."""
    out = []
    for repo, disc in ((repo_port, port_discover), (repo_ref, ref_discover)):
        s, d, v = repo.df_pairs()
        psi = dfg_numpy(s, d, v, repo.num_activities)
        starts, ends = repo.trace_boundaries()
        out.append(disc(psi, repo.activity_names, starts, ends, **kw))
    return out


def test_replay_paths_match_reference(mm_path):
    port_log, ref_log = PortMemmapLog.open(mm_path), RefMemmapLog.open(mm_path)
    port_repo = port_query.repository_from_memmap(port_log)
    ref_repo = ref_from_memmap(ref_log)
    pm, rm = _models(port_repo, ref_repo, min_count=20, min_dependency=0.3)
    want = ref_conf.replay_fitness(ref_repo, rm)
    got = {
        "columnar": port_conf.replay_fitness(port_repo, pm),
        "streaming": port_conf.replay_fitness_streaming(port_log, pm),
        "graph": port_conf.replay_fitness_graph(
            port_graph.build_graph(port_log, device="cpu"), pm
        ),
    }
    for name, res in got.items():
        _same_replay(res, want)
    _same_replay(
        got["graph"],
        ref_conf.replay_fitness_graph(ref_graph.build_graph(ref_log), rm),
    )
    _same_replay(
        port_conf.replay_fitness_streaming(port_log, pm, row_range=(500, 3100)),
        ref_conf.replay_fitness_streaming(ref_log, rm, row_range=(500, 3100)),
    )
    # the selection semantics (num_traces=None) of the arrays entry
    sel = port_repo.event_time < np.quantile(port_repo.event_time, 0.6)
    _same_replay(
        port_conf.replay_fitness_arrays(
            port_repo.event_activity[sel], port_repo.event_trace[sel],
            port_repo.activity_names, pm,
        ),
        ref_conf.replay_fitness_arrays(
            ref_repo.event_activity[sel], ref_repo.event_trace[sel],
            ref_repo.activity_names, rm,
        ),
    )
    topo = port_graph.build_graph(port_log, memory_budget_events=100, device="cpu")
    with pytest.raises(ValueError, match="topology-only"):
        port_conf.replay_fitness_graph(topo, pm)


def _pieces(log, lo, hi, step=700):
    """The rows [lo, hi) of ``log`` as time-ordered chunks of ``step`` rows,
    so cases straddle chunk boundaries."""
    for a, c, t in log.iter_chunks(row_range=(lo, hi)):
        for i in range(0, a.shape[0], step):
            yield a[i:i + step], c[i:i + step], t[i:i + step]


@pytest.mark.parametrize("split", [1, 1500, -1])
def test_streaming_replayer_snapshot_restore_equals_full_scan(mm_path, split):
    port_log, ref_log = PortMemmapLog.open(mm_path), RefMemmapLog.open(mm_path)
    split %= port_log.num_events
    pm, rm = _models(
        port_query.repository_from_memmap(port_log),
        ref_from_memmap(ref_log),
        min_count=20, min_dependency=0.3,
    )
    names = port_log.activity_labels()
    first = port_conf.StreamingReplayer(names, pm)
    for a, c, t in _pieces(port_log, 0, split):
        first.update(a, c, t)
    state = first.snapshot()
    mid = first.finalize()  # non-destructive
    resumed = port_conf.StreamingReplayer.restore(state.copy(), names, pm)
    for a, c, t in _pieces(port_log, split, port_log.num_events):
        resumed.update(a, c, t)
    full = port_conf.replay_fitness_streaming(port_log, pm)
    _same_replay(resumed.finalize(), full)
    _same_replay(full, ref_conf.replay_fitness_streaming(ref_log, rm))
    ref_first = ref_conf.StreamingReplayer(names, rm)
    for a, c, t in _pieces(ref_log, 0, split):
        ref_first.update(a, c, t)
    _same_replay(mid, ref_first.finalize())
    assert resumed.events_seen == port_log.num_events
    with pytest.raises(ValueError, match="shrink"):
        port_conf.StreamingReplayer(names[:-1], pm, state=state)


def test_streaming_model_discoverer_matches_reference(mm_path):
    port_log, ref_log = PortMemmapLog.open(mm_path), RefMemmapLog.open(mm_path)
    port_d = port_conf.StreamingModelDiscoverer(port_log.num_activities)
    ref_d = ref_conf.StreamingModelDiscoverer(ref_log.num_activities)
    for a, c, t in _pieces(port_log, 0, port_log.num_events):
        port_d.update(a, c, t)
    for a, c, t in _pieces(ref_log, 0, ref_log.num_events, step=1100):
        ref_d.update(a, c, t)
    names = port_log.activity_labels()
    for kw in ({}, dict(min_count=30, min_dependency=0.2)):
        got = port_conf.ModelSpec.from_model(port_d.finalize(names, **kw))
        want = ref_conf.ModelSpec.from_model(ref_d.finalize(names, **kw))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    np.testing.assert_array_equal(port_d.first_act, ref_d.first_act)
    np.testing.assert_array_equal(port_d.last_act, ref_d.last_act)


# ---------------------------------------------------------------------------
# the engine: fitness() / alignments() against the reference engine
# ---------------------------------------------------------------------------

VIEW = {f"act_{i:03d}": f"g{i % 3}" for i in range(A - 2)}  # two hidden

#: name → list of (method, args) applied to Q.log(source)
CHAINS = {
    "plain": [],
    "window": [("window", (10 * DAY, 80 * DAY))],
    "empty_window": [("window", (50 * DAY, 20 * DAY))],
    "activities": [("activities", ([f"act_{i:03d}" for i in (0, 2, 3, 5, 8)],))],
    "view": [("view", (VIEW,))],
    "window_activities_view": [
        ("window", (5 * DAY, 60 * DAY)),
        ("activities", ([f"act_{i:03d}" for i in range(0, A, 2)],)),
        ("view", (VIEW,)),
    ],
}

#: source → (engine keyword arguments shared by both engines)
SOURCES = {
    "repository": dict(memory_budget_events=1 << 20, replay_crossover=1 << 20),
    # in budget, below the replay crossover: materialize
    "memmap": dict(memory_budget_events=1 << 20, replay_crossover=1 << 20),
    # in budget, above the replay crossover: auto fitness streams
    "memmap_streaming": dict(memory_budget_events=1 << 20, replay_crossover=1000),
}


@pytest.fixture(scope="module")
def sources(mm_path):
    spec = dict(num_activities=A, seed=6)
    port_repo = port_synth.generate_repository(
        250, port_synth.ProcessSpec(**spec), seed=6
    )
    ref_repo = ref_synth.generate_repository(
        250, ref_synth.ProcessSpec(**spec), seed=6
    )
    pm, rm = _models(port_repo, ref_repo, min_count=5, min_dependency=0.3)
    return {
        "repository": (port_repo, ref_repo),
        "memmap": (PortMemmapLog.open(mm_path), RefMemmapLog.open(mm_path)),
        "models": (pm, rm),
    }


def _build(q, chain):
    for method, args in chain:
        q = getattr(q, method)(*args)
    return q


def _engines(**kw):
    # The reference reads crossovers from its committed calibration records
    # unless pointed at none — and calibration_path covers only
    # BENCH_query.json, so the replay crossover is passed explicitly (it
    # would otherwise come from BENCH_conformance.json).  Both keep repeated
    # queries off their graph tiers.
    ref = ref_query.QueryEngine(
        graph_crossover=10**9, calibration_path=os.devnull, **kw
    )
    port = port_query.QueryEngine(device="cpu", graph_crossover=10**9, **kw)
    return ref, port


def _run(q, sink, model, backend):
    try:
        return getattr(q, sink)(model, backend=backend)
    except ref_query.QueryPlanError as e:
        return e
    except port_query.QueryPlanError as e:
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
    assert pp.backend == rp.backend
    assert pp.materialize == rp.materialize
    assert pp.row_range_window == rp.row_range_window
    assert pp.notes == rp.notes
    assert pp.describe() == rp.describe()
    assert port_res.rewrites == ref_res.rewrites
    assert port_res.logical._payload() == ref_res.logical._payload()
    assert port_res.logical.key() == ref_res.logical.key()


ENGINE_CASES = [
    (src, sink, backend, chain, model)
    for src, sink, backend, chain, model in itertools.product(
        SOURCES, ("fitness", "alignments"),
        ("auto", "numpy", "streaming", "graph"), CHAINS, ("default", "pinned"),
    )
    # repository sources reject streaming in both engines (one chain shows
    # it), and the replay crossover moves only fitness
    if not (src == "repository" and backend == "streaming" and chain != "plain")
    and not (src == "memmap_streaming" and sink == "alignments")
]


@pytest.mark.parametrize(
    "src,sink,backend,chain,model", ENGINE_CASES,
    ids=["-".join(c) for c in ENGINE_CASES],
)
def test_engine_conformance_matches_reference(
    exact_ref_variants, sources, src, sink, backend, chain, model
):
    port_src, ref_src = sources["repository" if src == "repository" else "memmap"]
    pm, rm = sources["models"] if model == "pinned" else (None, None)
    ref_eng, port_eng = _engines(**SOURCES[src])
    ref_res = _run(
        _build(ref_query.Q.log(ref_src).using(ref_eng), CHAINS[chain]),
        sink, rm, backend,
    )
    port_res = _run(
        _build(port_query.Q.log(port_src).using(port_eng), CHAINS[chain]),
        sink, pm, backend,
    )
    _assert_same_result(port_res, ref_res)
    if not isinstance(port_res, Exception):
        assert port_eng.stats.rows_scanned == ref_eng.stats.rows_scanned
        assert port_eng.stats.conformance_queries == 1
        assert port_eng.stats.graph_queries == ref_eng.stats.graph_queries
        if chain == "empty_window":
            assert port_res.value.trace_fitness.shape == (0,)
            assert port_res.value.fitness == 1.0


def test_engine_guards_match_reference(exact_ref_variants, sources):
    """Out-of-core alignments, streaming alignments, materializing or graph
    conformance of an out-of-core log, and the device-counting backend
    names are refused by both engines with the same message."""
    port_log, ref_log = sources["memmap"]
    pm, rm = sources["models"]
    calls = [
        ("alignments", "auto"), ("alignments", "numpy"),
        ("alignments", "streaming"), ("alignments", "graph"),
        ("fitness", "numpy"), ("fitness", "graph"),
        ("fitness", "pallas"), ("fitness", "kernel"), ("alignments", "pallas"),
        ("alignments", "kernel"), ("fitness", "scatter"),
    ]
    for sink, backend in calls:
        ref_eng, port_eng = _engines(memory_budget_events=100)
        ref_res = _run(ref_query.Q.log(ref_log).using(ref_eng), sink, rm, backend)
        port_res = _run(port_query.Q.log(port_log).using(port_eng), sink, pm, backend)
        assert isinstance(port_res, port_query.QueryPlanError), (sink, backend)
        _assert_same_result(port_res, ref_res)
    # out of core, fitness streams in both
    ref_eng, port_eng = _engines(memory_budget_events=100)
    ref_res = ref_query.Q.log(ref_log).using(ref_eng).fitness(rm)
    port_res = port_query.Q.log(port_log).using(port_eng).fitness(pm)
    assert port_res.physical.backend == "streaming"
    _assert_same_result(port_res, ref_res)


def test_graph_routing_after_the_crossover_matches_reference(
    exact_ref_variants, sources
):
    """Conformance misses count toward the graph crossover, as in the
    reference: the second windowed fitness query replays the graph's
    event tables."""
    port_log, ref_log = sources["memmap"]
    pm, rm = sources["models"]
    ref_eng = ref_query.QueryEngine(
        graph_crossover=2, calibration_path=os.devnull, replay_crossover=1 << 20
    )
    port_eng = port_query.QueryEngine(
        device="cpu", graph_crossover=2, replay_crossover=1 << 20
    )
    ts = np.asarray(port_log.time)
    backends = []
    for q in (0.2, 0.4, 0.6):
        w = (0.0, float(np.quantile(ts, q)))
        ref_res = ref_query.Q.log(ref_log).using(ref_eng).window(*w).fitness(rm)
        port_res = port_query.Q.log(port_log).using(port_eng).window(*w).fitness(pm)
        _assert_same_result(port_res, ref_res)
        backends.append(port_res.physical.backend)
    assert backends == ["numpy", "graph", "graph"]
    # alignments ride the built graph too
    ref_res = ref_query.Q.log(ref_log).using(ref_eng).alignments(rm)
    port_res = port_query.Q.log(port_log).using(port_eng).alignments(pm)
    assert port_res.physical.backend == "graph"
    _assert_same_result(port_res, ref_res)
    assert port_eng.stats.graph_queries == ref_eng.stats.graph_queries == 3


def test_cache_model_memo_and_stats(sources):
    port_log, _ = sources["memmap"]
    eng = port_query.QueryEngine(device="cpu", replay_crossover=1 << 20)
    q = port_query.Q.log(port_log).using(eng)
    r1 = q.fitness()
    r2 = q.fitness()
    assert not r1.from_cache and r2.from_cache
    # sliding windows share the memoized default model (one discovery)
    ts = np.asarray(port_log.time)
    for x in (0.3, 0.6):
        q.window(0.0, float(np.quantile(ts, x))).fitness()
    assert len(eng._model_memo) == 1
    q.alignments()
    assert len(eng._model_memo) == 1
    # a view is another transform: another model
    q.view(VIEW).fitness()
    assert len(eng._model_memo) == 2
    assert eng.stats.conformance_queries == 6
    assert eng.stats.cache_hits == 1
    assert eng.replay_crossover == 1 << 20
    assert port_query.QueryEngine(device="cpu").replay_crossover == (
        port_query.REPLAY_STREAMING_CROSSOVER
    )
    chunks = eng.metrics.histogram(
        "replay_chunk_seconds", "Streaming-replay chunk wall time"
    )
    before = chunks.count
    port_query.Q.log(port_log).using(eng).fitness(backend="streaming")
    assert chunks.count > before


def test_empty_repository_everywhere(exact_ref_variants):
    model = port_conf.ModelSpec(activities=("a",), edges=(), starts=("a",), ends=("a",))
    ref_model = ref_conf.ModelSpec(activities=("a",), edges=(), starts=("a",), ends=("a",))
    eng = port_query.QueryEngine(device="cpu")
    ref_eng = ref_query.QueryEngine(calibration_path=os.devnull)
    for sink in ("fitness", "alignments"):
        got = getattr(port_query.Q.log(_port_repo_of([])).using(eng), sink)(model)
        want = getattr(ref_query.Q.log(_ref_repo_of([])).using(ref_eng), sink)(ref_model)
        _same_value(got.value, want.value)
        assert got.value.fitness == 1.0
