"""The DFG count kernel's CUDA source, run on the CPU.

``csrc/dfg_count.cu`` is compiled with g++ against a CPU stand-in for the
CUDA runtime (``tests/cuda_emulation/cuda_runtime.h``: a block's threads
are racing ``std::thread``s over one shared-memory buffer, atomics are
GCC's) and launched through the wrapper's own ctypes call,
``ops._call``, on CPU tensors.  Each case is held against
``dfg_count_plain`` with ``torch.equal`` (tolerance 0: counts are
integers).  The cases reach both branches, the hash table with no, partial
and full overflow, shifted and separate columns, views at odd offsets and
ragged tails.  This checks the kernel's logic; only a card checks that nvcc
builds it and that it runs there (``tests/test_torch_kernels_gpu.py``).

Skips where g++ with C++20 is not on the path."""

from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_emulation import compile_emulated
from repro_torch.data import ProcessSpec
from repro_torch.data.synthetic_log import generate_repository
from repro_torch.kernels.dfg_count import ops

SOURCE = Path(ops.__file__).parent / "csrc" / "dfg_count.cu"
#: the emulated card's SMs and dense blocks per SM (cudaOccupancy... answer)
SMS, PER_SM = 3, 2


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = ops._bind(compile_emulated(SOURCE, tmp_path_factory.mktemp("dfg_emu")))
    lib.emu_configure(SMS, PER_SM)
    return lib


def run(lib, src, dst, valid, a, ts_src=None, ts_dst=None, window=None):
    """(out, [overflowed pairs, flush atomics], last_launch) of one
    emulated launch; ``valid`` is passed as the uint8 bytes of a bool
    tensor, as the wrappers pass it."""
    out = torch.zeros((a, a), dtype=torch.int64)
    stats = torch.zeros(2, dtype=torch.int64)
    ops._call(lib, src, dst, valid.view(torch.uint8), out, a, ts_src, ts_dst,
              window, stats, None)
    return out, stats.tolist(), dict(ops.last_launch)


def plain(src, dst, valid, a, ts_src=None, ts_dst=None, window=None):
    if window is None:
        return ops.dfg_count_plain(src, dst, valid, num_activities=a)
    return ops.dfg_count_diced_plain(src, dst, valid, ts_src, ts_dst, window,
                                     num_activities=a)


def uniform_pairs(rng, n, a):
    """n + 1 ids (about 1% outside [0, A) on either side), n valid flags,
    n + 1 integer-second timestamps with ties."""
    act = rng.integers(0, a, n + 1).astype(np.int32)
    act[rng.random(n + 1) < 0.01] = -3
    act[rng.random(n + 1) < 0.01] = a + 5
    valid = rng.random(n) < 0.8
    ts = rng.integers(0, 1000, n + 1).astype(np.float64)
    return torch.from_numpy(act), torch.from_numpy(valid), torch.from_numpy(ts)


def check_both_layouts(lib, act, valid, ts, a, window):
    """The shifted views act[:-1] / act[1:] and separate copies of them;
    returns the runs' stats and launches."""
    got = []
    for columns in ("shifted", "separate"):
        src, dst = act[:-1], act[1:]
        ts_src, ts_dst = ts[:-1], ts[1:]
        if columns == "separate":
            src, dst = src.clone(), dst.clone()
            ts_src, ts_dst = ts_src.clone(), ts_dst.clone()
        for w in (None, window):
            args = (ts_src, ts_dst, w) if w is not None else ()
            out, stats, launch = run(lib, src, dst, valid, a, *args)
            want = plain(src, dst, valid, a, *args)
            assert torch.equal(out, want), (columns, w)
            assert launch["columns"] == columns
            got.append((stats, launch))
    return got


@pytest.mark.parametrize("a", [1, 3, 26, 241])
@pytest.mark.parametrize("n", [1, 7, 1000, 20_003])
def test_shared_branch(lib, a, n):
    act, valid, ts = uniform_pairs(np.random.default_rng(a * 7 + n), n, a)
    for stats, launch in check_both_layouts(lib, act, valid, ts, a, (100.0, 700.0)):
        assert launch["branch"] == "shared" and stats[0] == 0
        assert launch["table_slots"] == a * a and launch["threads"] == 256
        # a flush adds each nonzero cell once per block
        assert stats[1] <= launch["grid"] * min(a * a, n)


def test_shared_branch_ends_at_the_block_limit(lib):
    """16 B of stats + 4·A² B of counters fit 232,448 B up to A = 241."""
    act, valid, ts = uniform_pairs(np.random.default_rng(0), 5000, 242)
    for _, launch in check_both_layouts(lib, act, valid, ts, 242, (0.0, 500.0)):
        assert launch["branch"] == "hash"


def test_hash_branch_without_overflow_on_a_process_log(lib):
    """A generated process at A = 600 (the main path's width): its DFG has
    a few thousand cells, which the table holds with no pair overflowing."""
    repo = generate_repository(4000, ProcessSpec(num_activities=600, seed=3),
                               seed=3)
    act = torch.from_numpy(repo.event_activity.astype(np.int32))
    ts = torch.from_numpy(repo.event_time)
    src, dst, valid = repo.df_pairs()
    valid = torch.from_numpy(valid)
    t = np.sort(repo.event_time)
    window = (float(t[len(t) // 4]), float(t[3 * len(t) // 4]))
    cells = int((plain(act[:-1], act[1:], valid, 600) > 0).sum())
    for stats, launch in check_both_layouts(lib, act, valid, ts, 600, window):
        assert launch["branch"] == "hash"
        assert launch["table_slots"] == ops.HASH_SLOTS
        assert stats[0] == 0
        assert 0 < stats[1] <= launch["grid"] * cells


def test_hash_branch_with_partial_overflow(lib):
    """1.5 times as many distinct keys as the table has slots: some pairs
    overflow into global atomics and most count in the table."""
    rng = np.random.default_rng(4)
    a = 600
    keys = rng.choice(a * a, 3 * ops.HASH_SLOTS // 2, replace=False)
    n = 3 * SMS * keys.shape[0]
    key = keys[rng.integers(0, keys.shape[0], n)]
    src = torch.from_numpy((key // a).astype(np.int32))
    dst = torch.from_numpy((key % a).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    out, stats, launch = run(lib, src, dst, valid, a)
    assert torch.equal(out, plain(src, dst, valid, a))
    assert launch["branch"] == "hash" and launch["columns"] == "separate"
    assert 0 < stats[0] < int(valid.sum()) // 2
    assert stats[1] <= launch["grid"] * ops.HASH_SLOTS


@pytest.mark.parametrize("a", [257, 600])
def test_hash_branch_with_full_overflow(lib, a):
    """Uniform keys over A² cells fill every block's table (up to a few
    slots no key's probes reached while they were empty)."""
    act, valid, ts = uniform_pairs(np.random.default_rng(a), 200_005, a)
    for stats, launch in check_both_layouts(lib, act, valid, ts, a, (100.0, 900.0)):
        assert launch["branch"] == "hash"
        full = launch["grid"] * ops.HASH_SLOTS
        assert 0.99 * full <= stats[1] <= full
        assert stats[0] > 0


@pytest.mark.parametrize("a", [26, 600])
@pytest.mark.parametrize("head", [1, 2, 3])
def test_views_at_odd_offsets(lib, a, head):
    """Columns that start off the vectors' alignment (act[head:-1] /
    act[head+1:], valid[head:]) load element by element, with the same
    result; n takes every remainder modulo the run of 8 pairs."""
    rng = np.random.default_rng(head * 100 + a)
    act, valid, ts = uniform_pairs(rng, 4000 + head, a)
    valid = torch.from_numpy(rng.random(4000 + 2 * head) < 0.8)
    for tail in range(8):
        n = 3000 + tail
        src, dst = act[head:head + n], act[head + 1:head + 1 + n]
        ts_src, ts_dst = ts[head:head + n], ts[head + 1:head + 1 + n]
        v = valid[head:head + n]
        for w in (None, (200.0, 800.0)):
            args = (ts_src, ts_dst, w) if w is not None else ()
            out, _, launch = run(lib, src, dst, v, a, *args)
            assert torch.equal(out, plain(src, dst, v, a, *args)), (n, w)
            assert launch["columns"] == "shifted"


def test_nan_timestamps_never_count(lib):
    rng = np.random.default_rng(9)
    act, valid, ts = uniform_pairs(rng, 9_999, 600)
    ts[rng.random(10_000) < 0.1] = float("nan")
    for w in ((-1.0, 2000.0), (100.0, 600.0)):
        for a in (40, 600):
            src, dst = act[:-1] % a, act[1:] % a
            out, _, _ = run(lib, src, dst, valid, a, ts[:-1], ts[1:], w)
            want = plain(src, dst, valid, a, ts[:-1], ts[1:], w)
            assert torch.equal(out, want) and int(want.sum()) > 0


def test_hash_grid_is_one_block_per_sm(lib):
    """The hash branch runs one persistent block per SM, and no block
    without a run of pairs to count."""
    act, valid, _ = uniform_pairs(np.random.default_rng(5), 100_000, 600)
    _, _, launch = run(lib, act[:-1], act[1:], valid, 600)
    assert launch["branch"] == "hash" and launch["grid"] == SMS
    assert launch["threads"] == 1024
    n = 1024 * ops.RUN + 1  # two runs' worth of blocks at most
    _, _, launch = run(lib, act[:n], act[1:n + 1], valid[:n], 600)
    assert launch["grid"] == 2
