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


def _stats_launch(src, dst, valid, a, ts_src=None, ts_dst=None, window=None):
    """One launch through the wrappers' conversions with the kernel's
    counters: (out, [overflowed pairs, flush atomics], last_launch)."""
    s, d, v = ops._device_columns(src, dst, valid, a)
    if window is not None:
        ts_src, ts_dst = ops._device_timestamps(ts_src, ts_dst)
    out = torch.zeros((a, a), dtype=torch.int64, device=src.device)
    stats = torch.zeros(2, dtype=torch.int64, device=src.device)
    ops.launch(s, d, v, out, a, ts_src, ts_dst, window, stats)
    return out, stats.tolist(), dict(ops.last_launch)


def _plain(src, dst, valid, a, ts_src=None, ts_dst=None, window=None):
    if window is None:
        return ops.dfg_count_plain(src, dst, valid, num_activities=a)
    return ops.dfg_count_diced_plain(src, dst, valid, ts_src, ts_dst, window,
                                     num_activities=a)


@pytest.mark.gpu
def test_dfg_count_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    branches, columns, overflow = set(), set(), set()
    # 16 B + 4·A² B of dense counters fit a block's 227 KB up to A = 241
    # ("shared"); above, the hash table ("hash")
    for a in (1, 3, 26, 130, 238, 241, 242, 257, 600):
        for n in (0, 1, 7, 1000, 100_000, 100_003):
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
                columns.add(ops.last_launch["columns"])
                assert ops.launch_counts["dfg_count"] == before["dfg_count"] + 1
            for w in ((500.0, 500.0), (-1.0, 1001.0), (100.0, 700.0)):
                args = (src, dst, valid, ts[:-1], ts[1:], w)
                got = ops.dfg_count_diced(*args, num_activities=a)
                want = ops.dfg_count_diced_plain(*args, num_activities=a)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (a, n, w)
            # shifted views of one column, from the column's start and at
            # odd offsets (ids, valid and timestamps off the vectors'
            # alignment); n + head - 1 pairs takes every remainder mod 8
            act = torch.randint(-2, a + 2, (n + 4,), generator=gen, device=dev,
                                dtype=torch.int32)
            tcol = torch.randint(0, 1000, (n + 4,), generator=gen, device=dev)
            tcol = tcol.to(torch.float64)
            vcol = torch.rand(n + 4, generator=gen, device=dev) < 0.7
            for head in (0, 1, 2, 3):
                m = max(n + head - 3, 0)
                s_, d_ = act[head:head + m], act[head + 1:head + 1 + m]
                v_ = vcol[head:head + m]
                for w in (None, (100.0, 700.0)):
                    t_ = (tcol[head:head + m], tcol[head + 1:head + 1 + m], w)
                    args = t_ if w is not None else ()
                    got, stats, launch = _stats_launch(s_, d_, v_, a, *args)
                    torch.cuda.synchronize()
                    assert torch.equal(got, _plain(s_, d_, v_, a, *args)), (
                        a, m, head, w)
                    if m:
                        assert launch["columns"] == "shifted"
                        columns.add("shifted")
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
    assert branches == {"shared", "hash"}
    assert columns == {"shifted", "separate"}

    # the hash table with no, partial and full overflow
    from repro_torch.data import ProcessSpec
    from repro_torch.data.synthetic_log import generate_repository

    repo = generate_repository(20_000, ProcessSpec(num_activities=600, seed=5),
                               seed=5)
    act = torch.from_numpy(repo.event_activity.astype("int32")).to(dev)
    ts = torch.from_numpy(repo.event_time).to(dev)
    valid = torch.from_numpy(repo.df_pairs()[2]).to(dev)
    t = ts.sort().values
    w = (float(t[t.shape[0] // 4]), float(t[3 * t.shape[0] // 4]))
    for args in ((), (ts[:-1], ts[1:], w)):
        got, stats, launch = _stats_launch(act[:-1], act[1:], valid, 600, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, _plain(act[:-1], act[1:], valid, 600, *args))
        assert launch["branch"] == "hash" and launch["columns"] == "shifted"
        assert stats[0] == 0, "a process log overflowed the table"
        overflow.add("none")
    # 1.5 times as many distinct keys as the table has slots
    k = 3 * ops.HASH_SLOTS // 2
    keys = torch.randperm(360_000, generator=gen, device=dev)[:k]
    key = keys[torch.randint(0, k, (1 << 23,), generator=gen, device=dev)]
    src, dst = key // 600, key % 600
    valid = torch.rand(1 << 23, generator=gen, device=dev) < 0.9
    got, stats, launch = _stats_launch(src, dst, valid, 600)
    torch.cuda.synchronize()
    assert torch.equal(got, _plain(src, dst, valid, 600))
    assert launch["branch"] == "hash"
    assert 0 < stats[0] < int(valid.sum()), stats
    overflow.add("partial")
    # uniform keys over A² cells fill every block's table (~43,000 valid
    # pairs a block)
    for a in (257, 600):
        src = torch.randint(0, a, (7_200_003,), generator=gen, device=dev)
        dst = torch.randint(0, a, (7_200_003,), generator=gen, device=dev)
        valid = torch.rand(7_200_003, generator=gen, device=dev) < 0.8
        got, stats, launch = _stats_launch(src, dst, valid, a)
        torch.cuda.synchronize()
        assert torch.equal(got, _plain(src, dst, valid, a))
        assert stats[0] > 0
        assert stats[1] >= 0.99 * launch["grid"] * ops.HASH_SLOTS, stats
        overflow.add("full")
    assert overflow == {"none", "partial", "full"}


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
    # either side of the branch boundary (S int32 bins in the card's opt-in
    # shared memory): int32 views 1-3 elements off the kernel's 16-byte
    # vectors, valid views beside them, every remainder of N mod 16, and
    # one hot bin
    props = torch.cuda.get_device_properties(dev)
    last_shared = props.shared_memory_per_block_optin // 4
    for s in (last_shared, last_shared + 1):
        col = torch.randint(-2, s + 2, (70_000,), generator=gen, device=dev,
                            dtype=torch.int32)
        vcol = torch.rand(70_000, generator=gen, device=dev) < 0.7
        for head in (0, 1, 2, 3):
            for n in [50_000 + r for r in range(16)] + [5]:
                ids, valid = col[head:head + n], vcol[head:head + n]
                for v in (valid, None):
                    got = seg_ops.segment_count(ids, v, num_segments=s)
                    want = seg_ops.segment_count_plain(ids, v, num_segments=s)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (s, head, n, v is None)
                    ll = seg_ops.last_launch
                    assert ll["branch"] == ("shared" if s <= last_shared
                                            else "global"), (s, ll)
                    assert 1 <= ll["blocks_per_sm"] <= (
                        props.max_threads_per_multi_processor // ll["threads"])
                    assert 1 <= ll["grid"] <= (
                        props.multi_processor_count * ll["blocks_per_sm"]), ll
                    assert ll["flush_bound"] == (
                        ll["grid"] * s if ll["branch"] == "shared" else 0)
        hot = torch.full((100_001,), s - 1, dtype=torch.int32, device=dev)
        for ids in (hot, hot[1:]):
            got = seg_ops.segment_count(ids, num_segments=s)
            torch.cuda.synchronize()
            assert torch.equal(
                got, seg_ops.segment_count_plain(ids, num_segments=s))
            assert int(got[s - 1]) == ids.shape[0]
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
