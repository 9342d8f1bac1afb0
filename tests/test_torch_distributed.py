"""The distributed DFG of the port (``repro_torch.core.distributed``, the
``Mesh`` of ``repro_torch.core.compat``, ``QueryEngine(mesh=...)`` and
``mine --distributed``) against the reference's shard_map version on the
CPU.

The reference runs on a one-device JAX mesh here; the port on one-position
meshes of the CPU for the parity cases, and on meshes of several CPU
positions (one process) for what one device cannot show: padding split over
positions, the axis-by-axis reduction order and the merge.  Counts are
integers, so every tolerance is 0.

Ranks: two tests start gloo ranks (2 on a 1-D mesh, 4 on a 2×2 mesh), each
through ``tests/torch_ranks.py`` in a child process under a time limit, so
this process keeps no process group, start method or environment change.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core.distributed as ref_dist
import repro.query as ref_query
import repro_torch.core.distributed as port_dist
import repro_torch.query as port_query
import torch_ranks
from repro.core.compat import make_mesh as ref_make_mesh
from repro.data import ProcessSpec as RefProcessSpec
from repro.data import generate_repository as ref_generate_repository
from repro_torch.core.compat import Mesh, make_mesh
from repro_torch.core.dfg import dfg_numpy
from repro_torch.data import ProcessSpec, generate_repository
from repro_torch.kernels.dfg_count import ops as dfg_ops
from repro_torch.launch import mine as port_mine
from torch_parity import port_backend, ref_repository

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _ref_mesh():
    return ref_make_mesh((1,), ("data",), devices=jax.devices()[:1])


def _port_mesh(shape=(1,), names=("data",)):
    n = int(np.prod(shape))
    return make_mesh(shape, names, devices=["cpu"] * n)


def _pairs(n_traces=400, a=13, seed=5):
    spec = dict(num_activities=a, seed=seed)
    port = generate_repository(n_traces, ProcessSpec(**spec))
    ref = ref_generate_repository(n_traces, RefProcessSpec(**spec))
    np.testing.assert_array_equal(port.event_activity, ref.event_activity)
    src, dst, valid = port.df_pairs()
    return src, dst, valid, a


def _random_pairs(n, a, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, a, n).astype(np.int32)
    dst = rng.integers(0, a, n).astype(np.int32)
    return src, dst, rng.random(n) < 0.7


# ---------------------------------------------------------------------------
# shard_pairs, the one-device mesh and the per-shard backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(0, 1), (0, 4), (1, 4), (10, 8), (16, 8),
                                 (63, 5), (4096, 3)])
def test_shard_pairs_pads_like_the_reference(n, k):
    src, dst, valid = _random_pairs(n, 9, n + k)
    got = port_dist.shard_pairs(src, dst, valid, k)
    want = ref_dist.shard_pairs(src, dst, valid, k)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[0] % k == 0 and got[0].shape[0] >= max(n, k)
    assert not got[2][n:].any()  # padding is never a valid pair


@pytest.mark.parametrize("hierarchical", [True, False])
@pytest.mark.parametrize("seed", [5, 8, 11])
def test_distributed_dfg_matches_the_reference_on_one_device(
    seed, hierarchical
):
    src, dst, valid, a = _pairs(seed=seed)
    want = ref_dist.distributed_dfg(
        _ref_mesh(), src, dst, valid, a, hierarchical=hierarchical
    )
    got = port_dist.distributed_dfg(
        _port_mesh(), src, dst, valid, a, hierarchical=hierarchical
    )
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, dfg_numpy(src, dst, valid, a))


@pytest.mark.parametrize("hierarchical", [True, False])
@pytest.mark.parametrize("n_pairs", [1, 63, 4096])
def test_distributed_odd_sizes(n_pairs, hierarchical):
    src, dst, valid = _random_pairs(n_pairs, 9, n_pairs)
    want = ref_dist.distributed_dfg(
        _ref_mesh(), src, dst, valid, 9, hierarchical=hierarchical
    )
    for shape, names in (((1,), ("data",)), ((2, 3), ("pod", "data"))):
        got = port_dist.distributed_dfg(
            _port_mesh(shape, names), src, dst, valid, 9,
            hierarchical=hierarchical,
        )
        np.testing.assert_array_equal(got, want)


def test_per_shard_backends_agree_with_the_reference_kernel():
    src, dst, valid, a = _pairs(seed=8)
    want = ref_dist.distributed_dfg(
        _ref_mesh(), src, dst, valid, a, backend="pallas"
    )
    before = dict(dfg_ops.launch_counts)
    for backend in ("kernel", "onehot", "scatter"):
        got = port_dist.distributed_dfg(
            _port_mesh((2,), ("data",)), src, dst, valid, a, backend=backend
        )
        np.testing.assert_array_equal(got, want)
    assert dfg_ops.launch_counts == before  # CPU tensors: the plain version
    with pytest.raises(ValueError, match="per-shard backend"):
        port_dist.local_dfg_fn(a, backend="pallas")


# ---------------------------------------------------------------------------
# meshes of several positions: padding, reduction order, records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,names", [
    ((3,), ("data",)),
    ((2, 2), ("pod", "data")),
    ((2, 3, 2), ("pod", "data", "model")),
])
def test_positions_reduce_axis_by_axis(shape, names):
    src, dst, valid = _random_pairs(1_001, 7, 3)
    want = dfg_numpy(src, dst, valid, 7)
    mesh = _port_mesh(shape, names)
    got = port_dist.distributed_dfg(mesh, src, dst, valid, 7)
    np.testing.assert_array_equal(got, want)
    # one (A, A) int64 all-reduce per axis, fastest axis first
    assert [c.axes for c in port_dist.last_reductions] == [
        (n,) for n in reversed(names)
    ]
    assert [c.group_size for c in port_dist.last_reductions] == list(
        reversed(shape)
    )
    for c in port_dist.last_reductions:
        assert (c.op, c.shape, c.dtype, c.bytes) == (
            "all_reduce", (7, 7), "int64", 7 * 7 * 8
        )
    flat = port_dist.distributed_dfg(mesh, src, dst, valid, 7,
                                     hierarchical=False)
    np.testing.assert_array_equal(flat, want)
    assert [c.axes for c in port_dist.last_reductions] == [tuple(names)]
    assert port_dist.last_reductions[0].group_size == mesh.size


def test_mesh_shape_and_validation():
    mesh = _port_mesh((2, 3), ("pod", "data"))
    assert mesh.shape == {"pod": 2, "data": 3}
    assert mesh.size == 6 and mesh.devices.shape == (2, 3)
    assert all(d == torch.device("cpu") for d in mesh.flat_devices())
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.asarray(["cpu", "cpu"], dtype=object), ("a", "b"))
    with pytest.raises(ValueError, match="repeat"):
        make_mesh((1, 1), ("a", "a"), devices=["cpu"])
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("a", "b"), devices=["cpu"] * 3)


def test_a_mesh_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1,), ("data",))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1,), ("data",), devices=["cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mine.main(["--events", "2000", "--distributed"])


def test_merge_shard_psis_and_counts_match_the_reference():
    rng = np.random.default_rng(2)
    u = 9
    psis, counts, maps = [], [], []
    for k in range(5):
        ids = np.sort(rng.choice(u, u - k, replace=False))
        psis.append(rng.integers(0, 100, (ids.size, ids.size)))
        counts.append(rng.integers(0, 100, ids.size))
        maps.append(ids)
    want = ref_dist.merge_shard_psis(psis, maps, u)
    got = port_dist.merge_shard_psis(psis, maps, u)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port_dist.merge_shard_psis(psis, maps, u, mesh=_port_mesh()), want
    )
    np.testing.assert_array_equal(
        ref_dist.merge_shard_psis(psis, maps, u, mesh=_ref_mesh()), want
    )
    # five shards over two and three positions (padded with zero shards)
    for shape, names in (((2,), ("shard",)), ((3,), ("shard",)),
                         ((2, 2), ("pod", "shard"))):
        np.testing.assert_array_equal(
            port_dist.merge_shard_psis(psis, maps, u,
                                       mesh=_port_mesh(shape, names)),
            want,
        )
    np.testing.assert_array_equal(
        port_dist.merge_shard_counts(counts, maps, u),
        ref_dist.merge_shard_counts(counts, maps, u),
    )
    for fn in (port_dist.merge_shard_psis, ref_dist.merge_shard_psis):
        np.testing.assert_array_equal(fn([], [], u), np.zeros((u, u)))


@pytest.mark.parametrize("shape,names", [
    ((1,), ("data",)), ((4,), ("data",)), ((2, 2), ("pod", "data")),
])
def test_lower_distributed_dfg_records_one_reduction_per_axis(shape, names):
    mesh = _port_mesh(shape, names)
    before = dict(dfg_ops.launch_counts)
    low = port_dist.lower_distributed_dfg(mesh, 10_000, 64)
    assert dfg_ops.launch_counts == before  # a dry run launches nothing
    padded = port_dist.shard_pairs(
        np.zeros(10_000, np.int32), np.zeros(10_000, np.int32),
        np.zeros(10_000, bool), mesh.size,
    )[0].shape[0]
    assert low.padded_pairs == padded
    assert all(t.device.type == "meta" for t in low.shard_inputs)
    assert [t.shape[0] for t in low.shard_inputs] == [padded // mesh.size] * 3
    assert [t.dtype for t in low.shard_inputs] == [
        torch.int32, torch.int32, torch.bool
    ]
    assert low.output.device.type == "meta"
    assert tuple(low.output.shape) == (64, 64)
    assert [c.axes for c in low.collectives] == [
        (n,) for n in reversed(names)
    ]
    assert all(c.shape == (64, 64) and c.dtype == "int64"
               for c in low.collectives)
    assert "all_reduce" in low.as_text()
    # the reference lowers the same program: its inputs are the padded
    # columns, sharded over the mesh
    if mesh.size == 1:
        ref_low = ref_dist.lower_distributed_dfg(_ref_mesh(), 10_000, 64)
        assert f"{padded}" in ref_low.as_text()


# ---------------------------------------------------------------------------
# the engine's distributed backend and the CLI
# ---------------------------------------------------------------------------


def _engines(**kw):
    port = port_query.QueryEngine(device="cpu", graph_crossover=10**9, **kw)
    ref = ref_query.QueryEngine(
        calibration_path=os.devnull, graph_crossover=10**9,
        replay_crossover=1 << 22, **{k: v for k, v in kw.items()
                                    if k != "mesh"},
        mesh=_ref_mesh() if kw.get("mesh") is not None else None,
    )
    return port, ref


def _catch(fn):
    try:
        return fn()
    except (ref_query.QueryPlanError, port_query.QueryPlanError) as e:
        return e


def test_engine_with_a_mesh_plans_and_counts_like_the_reference():
    port_repo = generate_repository(300, ProcessSpec(num_activities=10,
                                                     seed=3))
    ref_repo = ref_repository(port_repo)
    tiny = generate_repository(3, ProcessSpec(num_activities=10, seed=3))
    t = port_repo.event_time
    w = (float(t.min()) + 5 * 86400.0, float(t.min()) + 40 * 86400.0)
    names = port_repo.activity_names
    chains = [
        lambda q: q.dfg(),
        lambda q: q.window(*w).dfg(),
        lambda q: q.activities(names[:6]).dfg(),
        lambda q: q.window(*w).activities(names[2:8]).dfg(),
        lambda q: q.process_map(),
        lambda q: q.neighborhood(names[1], k=2),
        lambda q: q.dfg(backend="distributed"),
        lambda q: q.histogram(),
    ]
    port, ref = _engines(mesh=_port_mesh())
    for fn in chains:
        p = fn(port_query.Q.log(port_repo).using(port))
        r = fn(ref_query.Q.log(ref_repo).using(ref))
        assert p.physical.backend == port_backend(r.physical.backend)
        assert p.physical.notes == r.physical.notes
        assert p.physical.fused_dicing == r.physical.fused_dicing is False
        assert p.names == r.names
        if isinstance(r.value, np.ndarray):
            np.testing.assert_array_equal(p.value, r.value)
    assert port.stats.executions == ref.stats.executions
    # a DFG with a mesh runs distributed; a tiny one stays on the host
    assert port_query.Q.log(port_repo).using(port).dfg(
    ).physical.backend == "distributed"
    small = port_query.Q.log(tiny).using(port).dfg()
    assert small.physical.backend == port_backend(
        ref_query.Q.log(ref_repository(tiny)).using(ref).dfg().physical.backend
    ) == "numpy"
    # without a mesh the backend is refused, with the reference's message
    port, ref = _engines()
    p = _catch(lambda: port_query.Q.log(port_repo).using(port).dfg(
        backend="distributed"))
    r = _catch(lambda: ref_query.Q.log(ref_repo).using(ref).dfg(
        backend="distributed"))
    assert isinstance(p, port_query.QueryPlanError)
    assert str(p) == str(r) == "distributed backend requires a mesh"


def test_engine_distributed_trace_records_the_phase():
    repo = generate_repository(200, ProcessSpec(num_activities=8, seed=9))
    eng = port_query.QueryEngine(device="cpu",
                                 mesh=_port_mesh((2,), ("data",)))
    res = port_query.Q.log(repo).using(eng).dfg()
    assert res.physical.backend == "distributed"
    assert res.trace.notes["distributed_s"] > 0
    src, dst, valid = repo.df_pairs()
    np.testing.assert_array_equal(res.value, dfg_numpy(src, dst, valid, 8))
    assert [c.axes for c in port_dist.last_reductions] == [("data",)]


def test_mine_distributed_on_the_cpu(capsys):
    args = ["--events", "6000", "--activities", "12", "--device", "cpu"]
    dist_run = port_mine.main(args + ["--distributed"])
    assert json.loads(capsys.readouterr().out) == dist_run
    plain = port_mine.main(args)
    capsys.readouterr()
    assert dist_run["mode"] == "distributed(1)"
    assert dist_run["plan"].startswith("backend=distributed")
    assert dist_run["total_pairs"] == plain["total_pairs"]
    assert dist_run["edges_discovered"] == plain["edges_discovered"]
    diced = port_mine.main(args + ["--distributed", "--dice-days", "20"])
    capsys.readouterr()
    assert diced["mode"] == "distributed(1)" and diced["diced"]
    assert diced["total_pairs"] == port_mine.main(
        args + ["--dice-days", "20"])["total_pairs"]


# ---------------------------------------------------------------------------
# ranks (child processes, gloo on the CPU)
# ---------------------------------------------------------------------------


def _run_ranks(tmp_path, world, shape, names):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_ranks.py"),
         str(tmp_path), str(world), ",".join(map(str, shape)),
         ",".join(names)],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    ranks = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        with open(tmp_path / f"rank{r}.json") as f:
            ranks.append((arrays, json.load(f)))
    return ranks


def _want():
    src, dst, valid, psis, maps = torch_ranks.inputs()
    a = torch_ranks.ACTIVITIES
    ones = np.ones(src.shape[0] - 1, bool)
    return (
        dfg_numpy(src, dst, valid, a),
        ref_dist.merge_shard_psis(psis, maps, a),
        dfg_numpy(src[:-1], src[1:], ones, a),
    )


@pytest.mark.parametrize("world,shape,names", [
    (2, (2,), ("data",)),
    (4, (2, 2), ("pod", "data")),
])
def test_gloo_ranks_count_their_shards_and_reduce(tmp_path, world, shape,
                                                  names):
    """Each rank counts 1/world of the pairs; the sums over the ranks equal
    Algorithm 1, the reference's host merge and the engine's answer, and the
    only traffic is one (A, A) int64 all-reduce per mesh axis (or one over
    every rank when flat)."""
    want_psi, want_merged, want_engine = _want()
    a = torch_ranks.ACTIVITIES
    for arrays, records in _run_ranks(tmp_path, world, shape, names):
        np.testing.assert_array_equal(arrays["hierarchical"], want_psi)
        np.testing.assert_array_equal(arrays["flat"], want_psi)
        np.testing.assert_array_equal(arrays["merged"], want_merged)
        np.testing.assert_array_equal(arrays["engine"], want_engine)
        assert records["engine_backend"] == "distributed"
        assert records["hierarchical"] == [
            ["all_reduce", [n], s, [a, a], "int64"]
            for n, s in zip(reversed(names), reversed(shape))
        ]
        assert records["flat"] == [
            ["all_reduce", list(names), world, [a, a], "int64"]
        ]
        assert records["merged"] == [[n] for n in reversed(names)]
    assert not torch.distributed.is_initialized()
