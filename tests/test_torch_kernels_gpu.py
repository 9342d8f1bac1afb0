"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: on a host without a card the test skips (it decides inside
the test, so every worker collects the same tests).  On the card run it with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

This file imports torch and the port only, so it also runs where JAX is
absent.  Counts are integers, and the alignment DP is f32 adds and mins in
one fixed order: kernel and plain version must agree bit for bit."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.align_dp import ops as dp_ops
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


def _dp_tables(rng, s, a, kind=0):
    """Random (m (S, A), d0 (S,), endcost (S,)) f32 costs of three kinds:
    0 sparse (small integers, about a third of them BIG_COST, one start
    state), 1 cheap syncs (the answer hinges on every id), 2 dear syncs (a
    log move often beats the sync on state a)."""
    big = np.float32(dp_ops.BIG_COST)
    if kind == 1:
        m = rng.integers(0, 3, (s, a)).astype(np.float32)
        m[rng.random((s, a)) < 0.1] = big
    elif kind == 2:
        m = rng.integers(2, 9, (s, a)).astype(np.float32)
    if kind:
        d0 = rng.integers(0, 3, s).astype(np.float32)
        return m, d0, rng.integers(0, 2, s).astype(np.float32)
    m = rng.integers(0, 6, (s, a)).astype(np.float32)
    m[rng.random((s, a)) < 0.3] = big
    d0 = np.full(s, big, dtype=np.float32)
    d0[rng.integers(0, s)] = 0.0
    end = rng.integers(0, 4, s).astype(np.float32)
    end[rng.random(s) < 0.5] = big
    return m, d0, end


@pytest.mark.gpu
def test_align_dp_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    tiers, ks = set(), set()
    # each register instance (K, KLO) at both ends of 32 KLO < S <= 32 K and
    # one state past each; 8 warps x S x 4 B of fronts fit a block's shared
    # memory up to S = 7,264; 7,265 and 9,000 states take the global tier.
    # Up to 1,025 states the ids cover every state but the last, so the
    # sync lands on every slot k of the register front
    sizes = sorted({x for k, lo in dp_ops.REGISTER_INSTANCES
                    for x in (32 * lo, 32 * lo + 1, 32 * k, 32 * k + 1)}
                   | {1, 3, 33, 129, 601, 7264, 7265, 9000})
    for n, s in enumerate(sizes):
        a = max(s - 1, 1) if s <= 1025 else (300 if s > 7265 else 40)
        m, d0, end = _dp_tables(rng, s, a, kind=n % 3)
        for v, l in ((0, 1), (1, 1), (7, 5), (300, 40), (3000, 168)):
            seqs = rng.integers(0, a, (v, l))  # int64 ids
            lens = rng.integers(0, l + 1, v)
            inputs = dp_ops.prepare(seqs, lens, m, d0, end, dev)
            before = dp_ops.launch_counts["align_dp"]
            got = dp_ops.align_dp_device(*inputs)
            want = dp_ops.align_dp_plain(*inputs)
            torch.cuda.synchronize()
            assert got.dtype == torch.float32 and got.shape == (v,)
            assert torch.equal(got, want), (s, a, v, l)
            if v:
                tiers.add(dp_ops.last_launch["branch"])
                if dp_ops.last_launch["branch"] == "registers":
                    k = dp_ops.last_launch["k"]
                    ks.add(k)
                    assert 32 * dict(dp_ops.REGISTER_INSTANCES)[k] < s <= 32 * k
                assert dp_ops.launch_counts["align_dp"] == before + 1
            if v * l * s <= 2_000_000:
                host = dp_ops.align_dp(seqs, lens, m, d0, end, backend="numpy")
                np.testing.assert_array_equal(got.cpu().numpy(), host)
        # the public entries on the card: ids past the sync columns, or
        # beyond int32's range, at an active position are refused
        seqs = rng.integers(0, a, (4, 3))
        lens = np.full(4, 3)
        for bad in (a, -1, (1 << 32) + 1):
            wrong = seqs.copy()
            wrong[2, 1] = bad
            with pytest.raises(ValueError, match="activity ids"):
                dp_ops.align_dp(wrong, lens, m, d0, end, device=dev)
            with pytest.raises(ValueError, match="activity ids"):
                dp_ops.align_dp_ragged(wrong.ravel(), [0, 3, 6, 9, 12], m, d0,
                                       end, device=dev)
        got = dp_ops.align_dp(seqs, lens, m, d0, end, backend="kernel", device=dev)
        np.testing.assert_array_equal(
            got, dp_ops.align_dp(seqs, lens, m, d0, end, backend="numpy")
        )
        np.testing.assert_array_equal(
            dp_ops.align_dp_ragged(seqs.ravel(), [0, 3, 6, 9, 12], m, d0, end,
                                   device=dev), got)
    assert tiers == {"registers", "shared", "global"}
    assert ks == {k for k, _ in dp_ops.REGISTER_INSTANCES}
