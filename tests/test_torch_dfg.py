"""The port's DFG count against the reference package, on the CPU.

The port's kernel wrappers on CPU tensors run their plain versions; they are
held against the reference's Pallas kernels in interpret mode (a small subset
of ``test_kernels_dfg.py``'s sweeps — interpret mode is slow).  Counts are
integers, so every comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from repro.core.dfg import dfg as ref_dfg
from repro.core.dfg import dfg_algorithm1 as ref_algorithm1
from repro.core.dfg import dfg_numpy as ref_dfg_numpy
from repro.core.dicing import pair_mask_for_window as ref_pair_mask
from repro.core.repository import EventRepository as RefRepository
from repro.core.repository import paper_example_repo as ref_paper_repo
from repro.kernels.dfg_count import dfg_count as ref_count
from repro.kernels.dfg_count import dfg_count_diced as ref_count_diced
from repro_torch.core.dfg import dfg, dfg_algorithm1, dfg_from_repository
from repro_torch.core.repository import paper_example_repo
from repro_torch.kernels.dfg_count import ops
from torch_parity import ref_backend


def _pairs(rng, n, a):
    src = rng.integers(0, a, size=n).astype(np.int32)
    dst = rng.integers(0, a, size=n).astype(np.int32)
    valid = rng.random(n) < 0.8
    return src, dst, valid


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize(
    "n_pairs,num_acts", [(0, 1), (7, 3), (1000, 26), (1000, 130), (1000, 257)]
)
def test_wrapper_matches_reference_kernel(n_pairs, num_acts):
    rng = np.random.default_rng(n_pairs * 1000 + num_acts)
    src, dst, valid = _pairs(rng, n_pairs, num_acts)
    before = dict(ops.launch_counts)
    got = ops.dfg_count(_t(src), _t(dst), _t(valid), num_activities=num_acts)
    want = ref_count(src, dst, valid, num_activities=num_acts, interpret=True)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a CPU tensor takes the plain version: no kernel launch
    assert ops.launch_counts == before


@pytest.mark.parametrize(
    "id_dtype,valid_dtype", [(np.int16, np.float32), (np.int64, np.int32)]
)
def test_wrapper_input_dtypes(id_dtype, valid_dtype):
    rng = np.random.default_rng(7)
    src = rng.integers(0, 50, size=900).astype(id_dtype)
    dst = rng.integers(0, 50, size=900).astype(id_dtype)
    valid = (rng.random(900) < 0.5).astype(valid_dtype)
    got = ops.dfg_count(_t(src), _t(dst), _t(valid), num_activities=50)
    want = ref_count(src, dst, valid, num_activities=50, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_out_of_range_ids_are_dropped():
    rng = np.random.default_rng(5)
    src, dst, valid = _pairs(rng, 800, 20)
    src[::17] = -1
    dst[::13] = 20
    dst[::29] = 700
    got = ops.dfg_count(_t(src), _t(dst), _t(valid), num_activities=20)
    want = ref_count(src, dst, valid, num_activities=20, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("id_dtype", [torch.int64, torch.int16, torch.int32])
def test_kernel_ids_are_narrowed_without_wrapping(id_dtype):
    """The CUDA path casts ids to int32; an int64 id of 2**32 + 5 must be
    dropped there as the plain version drops it, not wrap to 5."""
    rng = np.random.default_rng(6)
    src, dst, valid = _pairs(rng, 500, 20)
    src, dst = src.astype(np.int64), dst.astype(np.int64)
    if id_dtype == torch.int64:
        src[::7] += 1 << 32
        dst[::11] -= 1 << 32
        dst[::13] = (1 << 31) + 3
    src[::17] = -1
    dst[::19] = 20
    s, d = torch.from_numpy(src).to(id_dtype), torch.from_numpy(dst).to(id_dtype)
    s32, d32 = ops._narrow_ids(s, 20), ops._narrow_ids(d, 20)
    assert s32.dtype == d32.dtype == torch.int32
    assert s32.is_contiguous() and d32.is_contiguous()
    assert bool(((s32 >= -1) & (s32 < 20)).all())
    got = ops.dfg_count_plain(s32, d32, _t(valid), num_activities=20)
    # the reference oracle's drop rule (kernels/dfg_count/ref.py), in int64
    in_range = (src >= 0) & (src < 20) & (dst >= 0) & (dst < 20)
    want = ref_dfg_numpy(
        np.clip(src, 0, 19), np.clip(dst, 0, 19), valid & in_range, 20
    )
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(),
        ops.dfg_count_plain(s, d, _t(valid), num_activities=20).numpy(),
    )


@pytest.mark.parametrize("window", [(0.0, 1.0), (0.25, 0.75), (2.0, 3.0)])
def test_diced_wrapper_matches_reference_kernel(window):
    """f32-exact timestamps and bounds: the reference kernel's f32 compare
    and the port's f64 compare agree."""
    rng = np.random.default_rng(11)
    n, a = 2500, 40
    src, dst, valid = _pairs(rng, n, a)
    ts_src = rng.random(n).astype(np.float32)
    ts_dst = rng.random(n).astype(np.float32)
    win = np.asarray(window, dtype=np.float32)
    got = ops.dfg_count_diced(
        _t(src), _t(dst), _t(valid), _t(ts_src), _t(ts_dst), window,
        num_activities=a,
    )
    want = ref_count_diced(
        src, dst, valid, ts_src, ts_dst, win, num_activities=a, interpret=True
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _epoch_repo(rng, n_events=3000, n_acts=30):
    """A repository with epoch-scale timestamps (seconds since 1970, 2024)."""
    cases = rng.integers(0, 200, n_events)
    acts = rng.integers(0, n_acts, n_events)
    ts = 1.7e9 + np.sort(rng.random(n_events)) * 90 * 86400.0
    vocab = [f"a{i:02d}" for i in range(n_acts)]
    return RefRepository.from_event_table(
        cases.tolist(), [vocab[i] for i in acts], ts, activity_vocab=vocab
    )


def test_diced_plain_matches_f64_oracle_on_epoch_timestamps():
    repo = _epoch_repo(np.random.default_rng(3))
    src, dst, valid = repo.df_pairs()
    ts = repo.event_time
    for w in [(1.7e9, 1.7e9 + 86400.0), (ts[100], ts[2000]), (ts[5], ts[5])]:
        want = ref_dfg_numpy(
            src, dst, valid & ref_pair_mask(repo, w), repo.num_activities
        )
        got = ops.dfg_count_diced(
            _t(src), _t(dst), _t(valid), _t(ts[:-1]), _t(ts[1:]), w,
            num_activities=repo.num_activities,
        )
        np.testing.assert_array_equal(got.numpy(), want)


def test_reference_f32_kernel_differs_where_port_follows_the_oracle():
    """Documents the one known disagreement (ROADMAP Queue C): at epoch
    scale f32 steps are 128 s, so the reference kernel's f32 compare puts
    an event 10 s before the window inside it.  The port compares in f64
    and agrees with the reference's own numpy oracle."""
    t0 = 1.7e9  # f32-exact
    src = np.asarray([0, 1], np.int32)
    dst = np.asarray([1, 0], np.int32)
    valid = np.asarray([True, True])
    ts_src = np.asarray([t0 - 10.0, t0 + 20.0])
    ts_dst = np.asarray([t0 + 20.0, t0 + 30.0])
    window = (t0, t0 + 100.0)
    got = ops.dfg_count_diced(
        _t(src), _t(dst), _t(valid), _t(ts_src), _t(ts_dst), window,
        num_activities=2,
    ).numpy()
    inside = (ts_src >= window[0]) & (ts_src < window[1]) & (
        ts_dst >= window[0]) & (ts_dst < window[1])
    np.testing.assert_array_equal(
        got, ref_dfg_numpy(src, dst, valid & inside, 2)
    )
    np.testing.assert_array_equal(got, [[0, 0], [1, 0]])
    ref = np.asarray(ref_count_diced(
        src, dst, valid, ts_src, ts_dst, np.asarray(window),
        num_activities=2, interpret=True,
    ))
    np.testing.assert_array_equal(ref, [[0, 1], [1, 0]])


@pytest.mark.parametrize("backend", ["scatter", "onehot", "kernel"])
def test_dfg_backends_match_reference(backend):
    rng = np.random.default_rng(21)
    src, dst, valid = _pairs(rng, 3000, 37)
    got = dfg(src, dst, valid, 37, backend=backend, device="cpu")
    want = ref_dfg(src, dst, valid, 37, backend=ref_backend(backend))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_algorithm1_on_the_paper_example():
    ref_psi, ref_names = ref_algorithm1(ref_paper_repo().to_graph())
    repo = paper_example_repo()
    psi, names = dfg_algorithm1(repo.to_graph())
    assert names == ref_names
    np.testing.assert_array_equal(psi, ref_psi)
    names = [n.removeprefix("act:") for n in names]
    assert names == repo.activity_names
    for backend in ("auto", "scatter", "onehot", "kernel"):
        np.testing.assert_array_equal(
            dfg_from_repository(repo, backend=backend, device="cpu"), psi
        )


def test_kernel_limits_are_checked():
    ops.check_limits(ops.MAX_PAIRS, ops.MAX_ACTIVITIES)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ops.check_limits(1 << 31, 8)
    with pytest.raises(ValueError, match="num_activities"):
        ops.check_limits(10, ops.MAX_ACTIVITIES + 1)


def test_successor_views_are_recognised():
    """The wrapper passes one column to the kernel when ``dst`` is ``src``'s
    successor view of one storage, and two columns otherwise."""
    x = torch.arange(20, dtype=torch.int32)
    col = ops._successor_column(x[:-1], x[1:])
    assert col is not None and col.data_ptr() == x.data_ptr()
    assert torch.equal(col, x)
    # at an offset, and one pair
    col = ops._successor_column(x[3:9], x[4:10])
    assert col is not None and torch.equal(col, x[3:10])
    assert torch.equal(ops._successor_column(x[5:6], x[6:7]), x[5:7])
    ts = torch.linspace(0, 1, 11, dtype=torch.float64)
    assert torch.equal(ops._successor_column(ts[:-1], ts[1:]), ts)
    not_successors = [
        (x[:-1].clone(), x[1:].clone()),          # separate buffers
        (x[:-1], x[1:].clone()),                  # different storages
        (x[0:-2:2], x[1:-1:2]),                   # non-unit strides
        (x[:-2], x[2:]),                          # dst is src + 2
        (x[1:], x[:-1]),                          # dst is src - 1
        (x[:-1], x[:-1]),                         # the same view
        (x[:-2], x[1:]),                          # lengths differ
        (x[:0], x[1:1]),                          # no pairs
        (x[:-1], x.view(torch.float32)[1:]),      # dtypes differ
        (x.view(2, 10)[:, :-1], x.view(2, 10)[:, 1:]),  # not 1-D
    ]
    for a, b in not_successors:
        assert ops._successor_column(a, b) is None, (a.shape, b.shape)


def test_device_columns_keep_successor_views():
    """Ids of another dtype convert once, as one column, so the kernel
    still reads one column; separate columns stay separate."""
    x = torch.tensor([0, 5, 2, 70, -1, 3, 3], dtype=torch.int64)
    valid = torch.ones(6, dtype=torch.bool)
    src, dst, v = ops._device_columns(x[:-1], x[1:], valid, 6)
    assert src.dtype == dst.dtype == torch.int32 and v.dtype == torch.uint8
    assert ops._successor_column(src, dst) is not None
    assert src.tolist() == [0, 5, 2, -1, -1, 3] and dst.tolist()[-1] == 3
    src, dst, _ = ops._device_columns(x[:-1].clone(), x[1:].clone(), valid, 6)
    assert ops._successor_column(src, dst) is None
    ts = torch.arange(7, dtype=torch.float32)
    t_src, t_dst = ops._device_timestamps(ts[:-1], ts[1:])
    assert t_src.dtype == torch.float64
    assert ops._successor_column(t_src, t_dst) is not None
    t_src, t_dst = ops._device_timestamps(ts[:-1].clone(), ts[1:])
    assert ops._successor_column(t_src, t_dst) is None


def test_table_constants_match_the_kernel_source():
    """ops reports the kernel's run length, hash-table size, probe limit
    and branch names as ``csrc/dfg_count.cu`` declares them."""
    import re
    from pathlib import Path

    src = (Path(ops.__file__).parent / "csrc" / "dfg_count.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kRun")) == ops.RUN
    assert int(const("kMaxProbes")) == ops.MAX_PROBES
    assert const("kHashSlots").startswith("1 << kHashBits")
    assert 1 << int(const("kHashBits")) == ops.HASH_SLOTS
    names = re.search(r"kBranchNames\[\] = \{([^}]*)\}", src).group(1)
    assert tuple(re.findall(r'"(\w+)"', names)) == ops.BRANCHES
    assert int(const("kBranchShared")) == ops.BRANCHES.index("shared")
    assert int(const("kBranchHash")) == ops.BRANCHES.index("hash")
