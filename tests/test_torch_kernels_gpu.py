"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: on a host without a card the test skips (it decides inside
the test, so every worker collects the same tests).  On the card run it with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

This file imports torch and the port only, so it also runs where JAX is
absent.  Counts are integers: kernel and plain version must agree bit for
bit."""

import pytest
import torch

from repro_torch.kernels.dfg_count import ops
from repro_torch.kernels.segment_count import ops as seg_ops


@pytest.mark.gpu
def test_dfg_count_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    branches = set()
    for a in (1, 3, 26, 130, 238, 257, 600):
        for n in (0, 1, 7, 1000, 100_000):
            src = torch.randint(-2, a + 2, (n,), generator=gen, device=dev)
            dst = torch.randint(-2, a + 2, (n,), generator=gen, device=dev)
            valid = torch.rand(n, generator=gen, device=dev) < 0.7
            ts = torch.randint(0, 1000, (n + 1,), generator=gen, device=dev)
            ts = ts.to(torch.float64)
            before = dict(ops.launch_counts)
            got = ops.dfg_count(src, dst, valid, num_activities=a)
            want = ops.dfg_count_plain(src, dst, valid, num_activities=a)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (a, n)
            if n:
                branches.add(ops.last_launch["branch"])
                assert ops.launch_counts["dfg_count"] == before["dfg_count"] + 1
            for w in ((500.0, 500.0), (-1.0, 1001.0), (100.0, 700.0)):
                args = (src, dst, valid, ts[:-1], ts[1:], w)
                got = ops.dfg_count_diced(*args, num_activities=a)
                want = ops.dfg_count_diced_plain(*args, num_activities=a)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (a, n, w)
        # int64 ids beyond int32's range are dropped, never wrapped
        src = torch.randint(0, a, (10_000,), generator=gen, device=dev)
        dst = torch.randint(0, a, (10_000,), generator=gen, device=dev)
        src[::7] += 1 << 32
        dst[::11] -= 1 << 32
        dst[::13] = (1 << 31) + 3
        valid = torch.ones(10_000, dtype=torch.bool, device=dev)
        got = ops.dfg_count(src, dst, valid, num_activities=a)
        want = ops.dfg_count_plain(src, dst, valid, num_activities=a)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (a, "int64 ids beyond 2**31")
    assert branches == {"shared", "global"}


@pytest.mark.gpu
def test_segment_count_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    branches = set()
    # S up to 58,112 fits a block's shared memory; 100,000 takes the
    # global branch
    for s in (1, 3, 600, 4096, 58_000, 100_000):
        for n in (0, 1, 7, 1000, 100_000):
            ids = torch.randint(-2, s + 2, (n,), generator=gen, device=dev)
            valid = torch.rand(n, generator=gen, device=dev) < 0.7
            for v in (valid, None, valid.to(torch.int32), valid.float()):
                before = seg_ops.launch_counts["segment_count"]
                got = seg_ops.segment_count(ids, v, num_segments=s)
                want = seg_ops.segment_count_plain(ids, v, num_segments=s)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (s, n, v is None)
                if n:
                    branches.add(seg_ops.last_launch["branch"])
                    assert seg_ops.launch_counts["segment_count"] == before + 1
        # int16 ids, and int64 ids beyond int32's range (dropped, never
        # wrapped into [0, S))
        ids = torch.randint(0, s, (10_000,), generator=gen, device=dev)
        wide = ids.clone()
        wide[::7] += 1 << 32
        wide[::11] = (1 << 31) + 3
        for x in (wide, ids.to(torch.int16) if s < (1 << 15) else ids):
            got = seg_ops.segment_count(x, num_segments=s)
            want = seg_ops.segment_count_plain(x, num_segments=s)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (s, x.dtype)
    assert branches == {"shared", "global"}
