"""The segment count kernel's CUDA source, run on the CPU.

``csrc/segment_count.cu`` is compiled with g++ against a CPU stand-in for
the CUDA runtime (``tests/cuda_emulation``: a block's threads are racing
``std::thread``s over one shared-memory buffer filled with garbage, atomics
are GCC's) and launched through the wrapper's own ctypes call,
``ops._call``, on CPU tensors.  Each case is held against
``segment_count_plain`` with ``torch.equal`` (tolerance 0: counts are
integers).  The cases reach both branches and the segment counts on either
side of their boundary, id columns whose base lies at every 4-byte offset
from the kernel's 16-byte vectors, every remainder of the vectors, with and
without a valid column, ids out of range on both sides, one hot bin and a
generated log's own skewed ids.  This checks the kernel's logic; only a
card checks that nvcc builds it and that it runs there
(``tests/test_torch_kernels_gpu.py``).

Skips where g++ with C++20 is not on the path."""

from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_emulation import compile_emulated
from repro_torch.data import ProcessSpec
from repro_torch.data.synthetic_log import generate_repository
from repro_torch.kernels.segment_count import ops

SOURCE = Path(ops.__file__).parent / "csrc" / "segment_count.cu"
#: the emulated card's SMs and blocks per SM (cudaOccupancy... answer)
SMS, PER_SM = 3, 2
#: the emulated card's shared memory per block is an H100's, 232,448 B:
#: int32 bins for up to 58,112 segments
LAST_SHARED = 232448 // 4
THREADS = 1024


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = ops._bind(compile_emulated(SOURCE, tmp_path_factory.mktemp("seg_emu")))
    lib.emu_configure(SMS, PER_SM)
    return lib


#: int64 guard entries on either side of the output
GUARD = 16


def run(lib, ids, valid, s):
    """(out, last_launch) of one emulated launch; ``valid`` is passed as the
    uint8 bytes of a bool tensor, as the wrapper passes it.  The output
    lies between zeroed guard entries that no atomic may touch."""
    ops.last_launch.clear()
    padded = torch.zeros((s + 2 * GUARD,), dtype=torch.int64)
    out = padded[GUARD:GUARD + s]
    ops._call(lib, ids, None if valid is None else valid.view(torch.uint8),
              out, s, None)
    assert not padded[:GUARD].any() and not padded[GUARD + s:].any()
    return out, dict(ops.last_launch)


def check(lib, ids, valid, s):
    """One launch against the plain version, and its launch configuration:
    the branch the segment count asks for, a grid of at most SMs × blocks
    per SM with a thread's vector for each of its threads, at most N / S
    blocks on the shared branch, and a flush of at most grid × S atomics."""
    out, launch = run(lib, ids, valid, s)
    want = ops.segment_count_plain(ids, valid, num_segments=s)
    assert torch.equal(out, want), (s, ids.shape[0], valid is None)
    n = ids.shape[0]
    if not n:
        assert launch == {}
        return launch
    assert launch["branch"] == ("shared" if s <= LAST_SHARED else "global")
    assert launch["threads"] == THREADS and launch["blocks_per_sm"] == PER_SM
    assert 1 <= launch["grid"] <= SMS * PER_SM
    assert launch["grid"] <= max(1, -(-(n // 4) // THREADS))
    if launch["branch"] == "shared":
        assert launch["grid"] <= max(1, n // s)
        assert launch["smem_bytes"] == 4 * s
        assert launch["flush_bound"] == launch["grid"] * s
    else:
        assert launch["smem_bytes"] == 0 and launch["flush_bound"] == 0
    return launch


def ids_column(rng, n, s, head):
    """An int32 view of n ids starting ``head`` elements into its storage
    (so 4·head bytes past a 16-byte boundary), about 2% of them outside
    [0, S) on either side, and a bool valid view at the same offset."""
    base = rng.integers(0, s, n + head).astype(np.int32)
    base[rng.random(n + head) < 0.01] = -7
    base[rng.random(n + head) < 0.01] = s + 3
    ids = torch.from_numpy(base)[head:]
    valid = torch.from_numpy(rng.random(n + head) < 0.7)[head:]
    return ids, valid


#: every id count n of the sweep: 0, 1, and each remainder of the 4-id
#: vectors around one and four vectors
COUNTS = (0, 1, 3, 4, 5, 15, 16, 17, 1000)


@pytest.mark.parametrize("s", [1, 3, 600, 4096, LAST_SHARED, LAST_SHARED + 1])
def test_every_alignment_and_remainder(lib, s):
    """The column starts at each of the four 4-byte offsets from the
    16-byte vectors, the valid column with it, one byte further (its words
    for the vectors then straddle 4-byte boundaries and load byte by byte)
    or none.  At the graph build's S = 600 and on the global branch every
    id count of :data:`COUNTS` meets every offset; at the other segment
    counts a few of them do."""
    rng = np.random.default_rng(s)
    full = s in (600, LAST_SHARED + 1)
    branches = set()
    for n in COUNTS if full else (0, 1, 5, 17, 1000):
        for head in (0, 1, 2, 3) if full else (0, 3):
            ids, valid = ids_column(rng, n, s, head)
            assert n == 0 or ids.data_ptr() % 16 == 4 * head
            shifted = torch.from_numpy(rng.random(n + 1) < 0.7)[1:]
            for v in (None, valid, shifted):
                launch = check(lib, ids, v, s)
                if n:
                    branches.add(launch["branch"])
    assert branches == {"shared" if s <= LAST_SHARED else "global"}


@pytest.mark.parametrize("head", [0, 3])
@pytest.mark.parametrize("s", [600, LAST_SHARED, LAST_SHARED + 1])
def test_many_blocks(lib, s, head):
    """~100,003 ids: every block of the persistent grid counts its share,
    each byte of the valid column read with its vector's lane.  The grid is
    the emulated card's SMs × blocks per SM, cut on the shared branch to
    N / S blocks (one at S = 58,112), so that each block counts at least S
    ids."""
    rng = np.random.default_rng(head + 10 * s)
    n = 100_003
    ids, valid = ids_column(rng, n, s, head)
    for v in (None, valid):
        launch = check(lib, ids, v, s)
        want = SMS * PER_SM
        if s <= LAST_SHARED:
            want = min(want, n // s)
        assert launch["grid"] == want


def test_valid_selects_each_lane(lib):
    """Each of a vector's four ids is counted by its own valid byte: id i
    is segment i mod 4 and only lane i mod 4 == k is valid, for each k."""
    n = 4 * THREADS * 2 + 3
    ids = torch.arange(n, dtype=torch.int32) % 4
    for k in range(4):
        valid = (torch.arange(n) % 4) == k
        for head in (0, 1, 2, 3):
            check(lib, ids[head:], valid[head:], 4)


def test_one_hot_bin(lib):
    """Every id the same segment, all valid: the worst case for
    same-address atomics, in shared memory and in the output."""
    for s in (600, LAST_SHARED + 1):
        for n in (17, 50_001):
            ids = torch.full((n,), s - 1, dtype=torch.int32)
            out, _ = run(lib, ids, None, s)
            assert int(out[s - 1]) == n and int(out.sum()) == n
            check(lib, ids[1:], torch.ones(n, dtype=torch.bool)[1:], s)


def test_ids_out_of_range_are_dropped(lib):
    """Negative ids, ids equal to S and int32's extremes never count."""
    s = 600
    bad = torch.tensor([-1, s, s + 1, -(1 << 31), (1 << 31) - 1],
                       dtype=torch.int32)
    ids = bad.repeat(2000)
    out, _ = run(lib, ids, None, s)
    assert int(out.sum()) == 0
    ids[::3] = 5
    check(lib, ids, None, s)


def test_bins_start_cleared(lib):
    """The shared bins hold garbage until the kernel clears them: counts
    from one id per segment come out exactly one each."""
    for s in (600, LAST_SHARED):
        ids = torch.arange(s, dtype=torch.int32)
        out, launch = run(lib, ids, None, s)
        assert launch["branch"] == "shared"
        assert torch.equal(out, torch.ones(s, dtype=torch.int64))


def test_process_log_ids(lib):
    """A generated log's activity ids at A = 600, as the graph build counts
    them, and with a valid column."""
    repo = generate_repository(6000, ProcessSpec(num_activities=600, seed=5),
                               seed=5)
    act = torch.from_numpy(repo.event_activity.astype(np.int32))
    assert act.shape[0] > 50_000
    valid = torch.from_numpy(np.random.default_rng(5).random(act.shape[0]) < 0.9)
    for head in (0, 3):
        for v in (None, valid[head:]):
            check(lib, act[head:], v, 600)


def test_launch_configs_pass_the_hopper_checker(lib):
    """The configurations the launcher writes back on both branches, with
    and without a valid column, held by the Hopper launch checker against
    the H100 ptxas report: no hard finding and no spill, and a warning that
    the emulated card's two blocks per SM are more than an H100 holds of
    1,024 threads at 38 to 44 registers (one block per SM, set by the
    registers)."""
    from repro_torch.analysis import kernels_check as kc
    from repro_torch.kernels.build import ptxas_resources
    from torch_ptxas import REPORTS

    resources = ptxas_resources(REPORTS["segment_count"])
    rng = np.random.default_rng(9)
    seen = set()
    for s in (600, LAST_SHARED + 1):
        ids = torch.from_numpy(rng.integers(0, s, 50_000).astype(np.int32))
        for valid in (None, torch.from_numpy(rng.random(50_000) < 0.5)):
            _, launch = run(lib, ids, valid, s)
            config = kc.launch_config("segment_count", launch)
            _, res = kc.entry_resources(config, resources)
            found = kc.validate_launch(config, res)
            occ = kc.occupancy(config, res)
            assert (occ.blocks_per_sm, occ.limit) == (1, "registers")
            assert [f.check for f in found] == ["occupancy"]
            assert kc.check_launch(dict(config, blocks_per_sm=1), res) == []
            seen.add((launch["branch"], launch["valid"],
                      kc.ported_kernel(config).key))
    assert seen == {(b, v, "B3") for b in ("shared", "global")
                    for v in (True, False)}
