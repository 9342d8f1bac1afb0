"""The port's data substrate against the reference package: the same seeds
give identical columns, memmap logs are byte-compatible in both directions,
and fingerprints agree.  All comparisons are exact."""

import json
import os

import numpy as np
import pytest

import repro.core.dicing as ref_dicing
import repro.core.discovery as ref_discovery
import repro.core.repository as ref_repository
import repro.core.streaming as ref_streaming
import repro.core.views as ref_views
import repro.data.synthetic_log as ref_synth
import repro.query.cache as ref_cache
import repro_torch.core.dicing as port_dicing
import repro_torch.core.discovery as port_discovery
import repro_torch.core.repository as port_repository
import repro_torch.core.streaming as port_streaming
import repro_torch.core.views as port_views
import repro_torch.data.synthetic_log as port_synth
import repro_torch.query.cache as port_cache

COLUMNS = ("event_activity", "event_trace", "event_time", "trace_log")
MEMMAP_FILES = ("activity.i32", "case.i32", "time.f64", "meta.json")


def assert_same_repository(ref, port):
    for col in COLUMNS:
        a, b = getattr(ref, col), getattr(port, col)
        assert a.dtype == b.dtype, col
        np.testing.assert_array_equal(a, b, err_msg=col)
    assert ref.activity_names == port.activity_names
    assert ref.trace_names == port.trace_names
    assert ref.log_names == port.log_names
    assert ref_cache.fingerprint_repository(ref) == (
        port_cache.fingerprint_repository(port)
    )


@pytest.mark.parametrize(
    "num_traces,activities,seed", [(40, 5, 0), (300, 26, 3), (150, 64, 11)]
)
def test_generate_repository_identical(num_traces, activities, seed):
    ref = ref_synth.generate_repository(
        num_traces, ref_synth.ProcessSpec(num_activities=activities, seed=seed),
        seed=seed,
    )
    port = port_synth.generate_repository(
        num_traces, port_synth.ProcessSpec(num_activities=activities, seed=seed),
        seed=seed,
    )
    assert_same_repository(ref, port)


@pytest.mark.parametrize(
    "events,activities,batch_traces", [(4000, 8, 150), (20000, 26, 600)]
)
def test_generate_memmap_log_identical(tmp_path, events, activities, batch_traces):
    kw = dict(seed=5, batch_traces=batch_traces)
    ref = ref_synth.generate_memmap_log(
        str(tmp_path / "ref"), events,
        ref_synth.ProcessSpec(num_activities=activities, seed=5), **kw,
    )
    port = port_synth.generate_memmap_log(
        str(tmp_path / "port"), events,
        port_synth.ProcessSpec(num_activities=activities, seed=5), **kw,
    )
    for name in MEMMAP_FILES:
        a = (tmp_path / "ref" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        assert a == b, name
    # the same bytes at two paths: one fingerprint
    assert ref_cache.fingerprint_memmap(ref) == port_cache.fingerprint_memmap(port)
    assert port.num_events == ref.num_events and port.num_traces == ref.num_traces


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_memmap_log_opens_in_the_other_package(tmp_path, writer):
    mods = {"ref": (ref_synth, ref_streaming), "port": (port_synth, port_streaming)}
    synth, _ = mods[writer]
    path = str(tmp_path / "log")
    synth.generate_memmap_log(
        path, 6000, synth.ProcessSpec(num_activities=12, seed=2), seed=2,
        batch_traces=200,
    )
    ref = ref_streaming.MemmapLog.open(path)
    port = port_streaming.MemmapLog.open(path)
    for col in ("activity", "case", "time"):
        np.testing.assert_array_equal(getattr(ref, col), getattr(port, col))
    assert ref_cache.fingerprint_memmap(ref) == port_cache.fingerprint_memmap(port)
    assert ref.rows_for_window(1e5, 5e6) == port.rows_for_window(1e5, 5e6)
    assert ref.activity_labels() == port.activity_labels()
    assert ref_streaming.memmap_log_name(ref) == port_streaming.memmap_log_name(port)


def test_open_append_is_byte_compatible(tmp_path):
    """A log written by the reference and grown by the port's writer reads
    back identically in both, and its fingerprint equals the one of a log
    grown the same way by the reference."""
    spec = dict(num_activities=10, seed=4)
    paths = {}
    for who, streaming in (("ref", ref_streaming), ("port", port_streaming)):
        path = str(tmp_path / who)
        ref_synth.generate_memmap_log(
            path, 3000, ref_synth.ProcessSpec(**spec), seed=4, batch_traces=100
        )
        log = ref_streaming.MemmapLog.open(path)
        t_end = float(log.time[-1])
        rng = np.random.default_rng(9)
        act = rng.integers(0, 12, 500).astype(np.int32)
        case = rng.integers(0, log.num_traces + 20, 500).astype(np.int32)
        time = np.sort(t_end + rng.random(500) * 1e4)
        w = streaming.MemmapLogWriter.open_append(path)
        w.append(act, case, time)
        w.close()
        paths[who] = path
    for name in MEMMAP_FILES:
        a = open(os.path.join(paths["ref"], name), "rb").read()
        b = open(os.path.join(paths["port"], name), "rb").read()
        assert a == b, name
    grown = port_streaming.MemmapLog.open(paths["port"])
    assert json.load(open(os.path.join(paths["port"], "meta.json")))[
        "num_activities"
    ] == 12
    assert port_cache.fingerprint_memmap(grown) == ref_cache.fingerprint_memmap(
        ref_streaming.MemmapLog.open(paths["ref"])
    )


def test_streaming_miner_and_snapshot_parity(tmp_path):
    path = str(tmp_path / "log")
    log = port_synth.generate_memmap_log(
        path, 8000, port_synth.ProcessSpec(num_activities=9, seed=1), seed=1,
        batch_traces=300,
    )
    ref_m = ref_streaming.StreamingDFGMiner(9)
    port_m = port_streaming.StreamingDFGMiner(9)
    for i, (a, c, t) in enumerate(log.iter_chunks(chunk_rows=1500)):
        ref_m.update(a, c, t)
        port_m.update(a, c, t)
        if i == 2:  # resume half-way through from a snapshot
            port_m = port_streaming.StreamingDFGMiner.restore(
                port_m.snapshot(), num_activities=9
            )
    np.testing.assert_array_equal(ref_m.finalize(), port_m.finalize())
    np.testing.assert_array_equal(
        ref_streaming.streaming_dfg(
            ref_streaming.MemmapLog.open(path), time_window=(2e5, 6e6)
        ),
        port_streaming.streaming_dfg(log, time_window=(2e5, 6e6)),
    )


def test_event_table_pairs_and_boundaries():
    rng = np.random.default_rng(17)
    n = 700
    cases = [f"c{int(x)}" for x in rng.integers(0, 60, n)]
    acts = [f"a{int(x)}" for x in rng.integers(0, 11, n)]
    ts = rng.integers(0, 200, n).astype(float)  # many ties: stable order
    ref = ref_repository.EventRepository.from_event_table(cases, acts, ts)
    port = port_repository.EventRepository.from_event_table(cases, acts, ts)
    assert_same_repository(ref, port)
    for a, b in zip(ref.df_pairs(), port.df_pairs()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ref.trace_boundaries(), port.trace_boundaries()):
        np.testing.assert_array_equal(a, b)


def test_paper_example_and_graph_form():
    ref = ref_repository.paper_example_repo()
    port = port_repository.paper_example_repo()
    assert_same_repository(ref, port)
    g_ref, g_port = ref.to_graph(), port.to_graph()
    assert g_ref.relations == g_port.relations
    assert g_port.well_formed()
    assert_same_repository(g_ref.to_columnar(), g_port.to_columnar())


def test_dicing_views_and_discovery_parity():
    ref = ref_synth.generate_repository(
        120, ref_synth.ProcessSpec(num_activities=12, seed=8), seed=8
    )
    port = port_synth.generate_repository(
        120, port_synth.ProcessSpec(num_activities=12, seed=8), seed=8
    )
    w = (86400.0 * 10, 86400.0 * 70)
    np.testing.assert_array_equal(
        ref_dicing.pair_mask_for_window(ref, w),
        port_dicing.pair_mask_for_window(port, w),
    )
    keep = ref.activity_names[:5]
    assert_same_repository(
        ref_dicing.dice_repository(ref, time_window=w, activities=keep),
        port_dicing.dice_repository(port, time_window=w, activities=keep),
    )
    mapping = {a: f"g{i % 3}" for i, a in enumerate(ref.activity_names[:9])}
    src, dst, valid = port.df_pairs()
    psi = np.zeros((12, 12), np.int64)
    np.add.at(psi, (src[valid], dst[valid]), 1)
    np.testing.assert_array_equal(
        ref_views.ActivityView(mapping).apply_to_dfg(psi, ref.activity_names),
        port_views.ActivityView(mapping).apply_to_dfg(psi, port.activity_names),
    )
    starts, ends = port.trace_boundaries()
    m_ref = ref_discovery.discover_dependency_graph(
        ref_discovery.filter_dfg(psi, 2), ref.activity_names, starts, ends
    )
    m_port = port_discovery.discover_dependency_graph(
        port_discovery.filter_dfg(psi, 2), port.activity_names, starts, ends
    )
    assert m_ref.edges == m_port.edges
    assert ref_discovery.to_dot(m_ref) == port_discovery.to_dot(m_port)
