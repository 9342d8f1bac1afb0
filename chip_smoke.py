#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. environment — card name and power limit, torch / CUDA / nvcc versions,
   each kernel library's build time (one ``nvcc`` per source, all started
   together) and ``-Xptxas -v`` report; every ``align_dp`` and
   ``segment_count`` instance's registers, none of the register tier's and
   none of ``segment_count``'s spilling;
2. every CUDA kernel against its plain PyTorch version on the card, bit for
   bit, over a sweep of activity / segment / state counts, pair / id /
   variant counts, dtypes and windows that reaches every branch of each
   kernel (``dfg_count``: its shared and hash branches, the hash table with
   no, partial and full overflow, shifted and separate columns, views at
   odd offsets; ``segment_count``: its shared and global branches on either
   side of their boundary, id views at offsets 1-3, every N mod 16, one
   hot bin, each launch's grid and flush bound; ``align_dp``: its
   registers, shared and global tiers, and each register instance);
3. the main path at the paper's evaluation width (PAPER_EVAL: 7.2 M events,
   600 activities, 120 days) on a default ``QueryEngine()`` (its memory
   budget taken from the card): ``Q.log(log).using(engine).dfg()`` plus
   accumulating-day dices, on the kernel backend with fused dicing, every Ψ
   held against the host oracle, then discovery on top;
3b. the graph tier at the same width on a default ``QueryEngine()``: the
   event-knowledge graph built on the card (Ψ through ``dfg_count``, node
   degrees through ``segment_count``), graph-served process map, histogram,
   DFG, neighborhood and windowed DFGs, the repeat-query crossover, a fused
   columnar process map, a snapshot round trip and an append extension,
   each held against the host oracles, with the build's split;
3c. conformance at the same width on a default ``QueryEngine()``:
   ``fitness()`` on the numpy, streaming and graph backends (all equal, no
   ``align_dp`` launch), ``alignments()`` with the default model, with
   phase 3's discovered model, over a 30-day window and on the graph
   backend (one ``align_dp`` launch each, the default-model one on the
   registers tier, its input the variant table's ragged ids); the DP's full
   output against its plain version on the card, a 4,096-variant sample
   against the host oracle, alignments' perfect traces against replay's,
   and the cost bounds; with the split of an alignment query, the padded
   (V, L) route timed beside it;
3d. variant analysis at the same width on a default ``QueryEngine()``:
   ``variants()`` and ``variants(10)`` against a host oracle that groups
   traces by their activity-id tuples (no hash); ``top_variants(k).dfg()``
   (``dfg_count``) for k = 10 and the k of 50% coverage, each moved to the
   end of its tie run, and the latter over a 30-day window
   (``dfg_count_diced``); ``activities(keep, relink=True).dfg()`` with the
   300 most frequent activities, plain and over a 7-day window;
   ``top_variants(k).alignments()`` (one ``align_dp`` launch, its default
   model discovered on the filtered log, a 4,096-variant sample against
   the host DP); an ``AnalystSession`` on the shared default engine whose
   floored 30-day Ψ equals phase 3's; and the barriers' split on the host
   clock;
4. the mining CLI in-process (``repro_torch.launch.mine``);
5. kernel, plain-version and library times at the main paths' shapes beside
   the bytes or operations bound (``ms``: CUDA events around the host's
   call and the launch; ``device_ms``: the same launch enqueued behind a
   spin, so the host's call is off the clock; ``dfg_count`` also on the
   graph build's separate columns and the CLI's A = 32 shared branch, as 50
   back-to-back launches, with the hash table's overflow and flush counts
   on the main path's inputs, on uniform keys and on the 99% cells;
   ``segment_count`` also with a valid column, on uniform ids, with every
   id one activity, with the L2 flushed by a read, right after a
   host-to-device copy of its ids, beside two PyTorch reads of the same
   column;
   ``align_dp`` also beside its issue bounds, with its work orders
   compared), and the end-to-end split of the main-path queries.

The line before the last is a JSON ``kernels`` report (``launches`` from
the first path that runs the kernel: phase 3, 3b or 3c;
``launches_by_phase`` each phase's own); the last line
is ``{"ok": true, "device": {...}}``.  Counts are exact integers and the
alignment DP is f32 adds and mins in one fixed order, so every comparison
has tolerance 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

DAY = 86400.0
#: H100 SXM device-memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet; it
#: counts an FMA as two operations), for the operations bound
FP32_OPS_PER_S = 67e12
#: the H100 SXM's SMs and FP32 lanes per SM, for the issue-rate bound of a
#: kernel whose f32 operations are adds and mins (one per lane per clock)
H100_SMS, FP32_LANES_PER_SM = 132, 128
#: results a clock per SM of f32 min, if it issues at half the add rate
#: (the CUDA C++ Programming Guide's throughput table, compute capability
#: 9.0: 64 for "compare, minimum, maximum", 128 for f32 add)
MIN_LANES_PER_SM = 64
#: clock cycles of the spin that keeps the stream busy while the host
#: enqueues a launch timed for ``device_ms`` (~0.5 ms at 1,980 MHz; a
#: launch's host call takes tens of µs)
SPIN_CYCLES = 1_000_000
#: the source of each kernel
SOURCES = {
    "dfg_count": "src/repro_torch/kernels/dfg_count/csrc/dfg_count.cu",
    "dfg_count_diced": "src/repro_torch/kernels/dfg_count/csrc/dfg_count.cu",
    "segment_count":
        "src/repro_torch/kernels/segment_count/csrc/segment_count.cu",
    "align_dp": "src/repro_torch/kernels/align_dp/csrc/align_dp.cu",
}
#: the TPU kernels this port replaces (file:line of the Pallas kernel body)
REPLACES = {
    "dfg_count": "src/repro/kernels/dfg_count/kernel.py:34",
    "dfg_count_diced": "src/repro/kernels/dfg_count/kernel.py:61",
    "segment_count": "src/repro/kernels/segment_count/kernel.py:31",
    "align_dp": "src/repro/kernels/align_dp/kernel.py:39",
}
#: what bounds each kernel at the main paths' shapes
BOUND_BY = {
    "dfg_count": "bytes",
    "dfg_count_diced": "bytes",
    "segment_count": "bytes",
    "align_dp": "operations",
}
KERNELS = ("dfg_count", "dfg_count_diced", "segment_count", "align_dp")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def run_cmd(cmd) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"{' '.join(cmd)} failed: {out.stderr.strip()}")
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Phase 1 — environment and build
# ---------------------------------------------------------------------------


def phase_environment(torch, build):
    card = run_cmd([
        "nvidia-smi", "--query-gpu=name,power.limit",
        "--format=csv,noheader", "-i", "0",
    ])
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"nvcc: {run_cmd([build.find_nvcc(), '--version']).splitlines()[-1]}")
    t0 = time.perf_counter()
    recs = build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall for "
        f"{len(recs)} librar{'y' if len(recs) == 1 else 'ies'}, one nvcc "
        "each, started together")
    for rec in recs:
        log(f"  {rec.name}: nvcc {rec.seconds:.2f} s -> {rec.path.name}")
        for line in rec.ptxas.splitlines():
            log(f"    {line}")
    return card


# ---------------------------------------------------------------------------
# Phase 2 — kernel ≡ plain version on the card
# ---------------------------------------------------------------------------


def _pairs(torch, gen, n, a, dev):
    src = torch.randint(0, a, (n,), generator=gen, device=dev, dtype=torch.int32)
    dst = torch.randint(0, a, (n,), generator=gen, device=dev, dtype=torch.int32)
    # ~1% ids out of range on either side: the kernel must drop them
    bad = torch.rand(n, generator=gen, device=dev) < 0.01
    src = torch.where(bad, torch.full_like(src, -3), src)
    bad = torch.rand(n, generator=gen, device=dev) < 0.01
    dst = torch.where(bad, torch.full_like(dst, a + 5), dst)
    valid = torch.rand(n, generator=gen, device=dev) < 0.8
    # integer seconds over ~4 months, many ties: bounds can equal timestamps
    ts = torch.randint(
        0, 10_368_000, (n + 1,), generator=gen, device=dev
    ).to(torch.float64)
    return src, dst, valid, ts


def _stats_launch(torch, ops, src, dst, valid, a, ts_src=None, ts_dst=None,
                  window=None):
    """One dfg_count launch through the wrappers' conversions, with the
    kernel's counters: (out, [overflowed pairs, flush atomics],
    last_launch)."""
    s, d, v = ops._device_columns(src, dst, valid, a)
    if window is not None:
        ts_src, ts_dst = ops._device_timestamps(ts_src, ts_dst)
    out = torch.zeros((a, a), dtype=torch.int64, device=src.device)
    stats = torch.zeros(2, dtype=torch.int64, device=src.device)
    ops.launch(s, d, v, out, a, ts_src, ts_dst, window, stats)
    return out, stats.tolist(), dict(ops.last_launch)


def phase_sweep(torch, ops):
    """dfg_count / dfg_count_diced ≡ their plain versions with torch.equal:
    16 B + 4·A² B of dense counters fit a block's 227 KB up to A = 241
    ("shared"); 242 and above take the hash table ("hash"), reached with no
    overflow (a generated process log at A = 600), partial overflow (1.5
    distinct keys per slot) and full overflow (uniform keys); separate
    columns and shifted views of one column, at the column's start and at
    odd offsets; n from 0 to 7.2 M, every remainder mod the run of 8
    pairs."""
    from repro_torch.data import ProcessSpec
    from repro_torch.data.synthetic_log import generate_repository

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = {"dfg_count": 0, "dfg_count_diced": 0}
    branches, columns, overflow = set(), set(), {}
    cases = 0

    def compare(name, got, want, what):
        nonlocal cases
        torch.cuda.synchronize()
        check(got.dtype == torch.int64 and got.shape == want.shape,
              f"{name} {what}: dtype/shape {got.dtype}{tuple(got.shape)}")
        err = int((got - want).abs().max()) if got.numel() else 0
        worst[name] = max(worst[name], err)
        check(torch.equal(got, want), f"{name} {what}: max |err| {err}")
        cases += 1

    def compare_stats(src, dst, valid, a, what, ts_src=None, ts_dst=None,
                      window=None):
        name = "dfg_count" if window is None else "dfg_count_diced"
        got, stats, launch = _stats_launch(torch, ops, src, dst, valid, a,
                                           ts_src, ts_dst, window)
        if window is None:
            want = ops.dfg_count_plain(src, dst, valid, num_activities=a)
        else:
            want = ops.dfg_count_diced_plain(src, dst, valid, ts_src, ts_dst,
                                             window, num_activities=a)
        compare(name, got, want, what)
        return stats, launch

    for a in (1, 3, 26, 130, 241, 242, 257, 600):
        for n in (0, 1, 7, 1000, 1 << 20, 7_200_000):
            src, dst, valid, ts = _pairs(torch, gen, n, a, dev)
            what = f"A={a} E={n}"
            compare("dfg_count",
                    ops.dfg_count(src, dst, valid, num_activities=a),
                    ops.dfg_count_plain(src, dst, valid, num_activities=a),
                    what)
            if n:
                branches.add(ops.last_launch["branch"])
                columns.add(ops.last_launch["columns"])
            k = torch.randint(0, n + 1, (2,), generator=gen, device=dev)
            lo, hi = sorted(ts[k].tolist())
            windows = {
                "empty": (5e6, 5e6),
                "all": (-1.0, 2e7),
                "bounds=timestamps": (lo, hi),
            }
            for wname, w in windows.items():
                args = (src, dst, valid, ts[:-1], ts[1:], w)
                compare("dfg_count_diced",
                        ops.dfg_count_diced(*args, num_activities=a),
                        ops.dfg_count_diced_plain(*args, num_activities=a),
                        f"{what} window={wname}")
            # shifted views of one column: the column's start and odd
            # offsets (ids, valid and timestamps off the vectors'
            # alignment); n + head - 3 pairs, so every remainder mod 8
            act = src if n < 8 else torch.cat([src[:4], dst])
            vcol = torch.cat([valid, valid[:4]])
            tcol = torch.cat([ts, ts[:4]])
            for head in (0, 1, 3):
                m = max(min(n + head - 3, act.shape[0] - head - 1), 0)
                s_, d_ = act[head:head + m], act[head + 1:head + 1 + m]
                v_, t_ = vcol[head:head + m], tcol[head:head + m + 1]
                for wname, w in (("none", None), ("bounds=timestamps", (lo, hi))):
                    args = (t_[:-1], t_[1:], w) if w is not None else ()
                    stats, launch = compare_stats(
                        s_, d_, v_, a,
                        f"A={a} shifted E={m} head={head} window={wname}", *args)
                    if m:
                        check(launch["columns"] == "shifted",
                              f"A={a} E={m} head={head}: {launch['columns']}")
                        columns.add("shifted")
            # uniform keys fill every block's hash table
            if a > 241 and n == 7_200_000:
                stats, launch = compare_stats(src, dst, valid, a,
                                              f"A={a} E={n} stats")
                check(launch["branch"] == "hash" and stats[0] > 0
                      and stats[1] >= 0.99 * launch["grid"] * ops.HASH_SLOTS,
                      f"A={a} uniform keys: stats {stats}, {launch}")
                overflow[f"full A={a}"] = stats
    # input dtypes the wrapper converts on the card
    for n in (1000, 1 << 20):
        src, dst, valid, ts = _pairs(torch, gen, n, 130, dev)
        for id_dtype in (torch.int16, torch.int64):
            for vname, v in (("float", valid.to(torch.float32)),
                             ("int", valid.to(torch.int32))):
                s2, d2 = src.to(id_dtype), dst.to(id_dtype)
                what = f"E={n} ids={id_dtype} valid={vname}"
                compare("dfg_count",
                        ops.dfg_count(s2, d2, v, num_activities=130),
                        ops.dfg_count_plain(s2, d2, v, num_activities=130),
                        what)
                w = (float(ts[n // 3]), float(ts[n // 2]) + 1.0)
                args = (s2, d2, v, ts[:-1], ts[1:], w)
                compare("dfg_count_diced",
                        ops.dfg_count_diced(*args, num_activities=130),
                        ops.dfg_count_diced_plain(*args, num_activities=130),
                        what)
    # int64 ids beyond int32's range: dropped, never wrapped into [0, A)
    for a in (130, 600):
        src, dst, valid, ts = _pairs(torch, gen, 1 << 20, a, dev)
        s2, d2 = src.to(torch.int64), dst.to(torch.int64)
        s2[::7] += 1 << 32
        d2[::11] -= 1 << 32
        d2[::13] = (1 << 31) + 3
        what = f"A={a} E={1 << 20} int64 ids beyond 2**31"
        compare("dfg_count",
                ops.dfg_count(s2, d2, valid, num_activities=a),
                ops.dfg_count_plain(s2, d2, valid, num_activities=a), what)
        args = (s2, d2, valid, ts[:-1], ts[1:], (-1.0, 2e7))
        compare("dfg_count_diced",
                ops.dfg_count_diced(*args, num_activities=a),
                ops.dfg_count_diced_plain(*args, num_activities=a), what)
        # the same int64 ids as successor views of one column
        col = torch.cat([s2[:1], d2])
        compare_stats(col[:-1], col[1:], valid, a, what + ", shifted")
    # the hash table with no overflow: a generated process log at the main
    # path's width, its columns as the engine passes them
    repo = generate_repository(50_000, ProcessSpec(num_activities=600, seed=5),
                               seed=5)
    act = torch.from_numpy(repo.event_activity.astype("int32")).to(dev)
    ts = torch.from_numpy(repo.event_time).to(dev)
    valid = torch.from_numpy(repo.df_pairs()[2]).to(dev)
    t = ts.sort().values
    w = (float(t[t.shape[0] // 4]), float(t[3 * t.shape[0] // 4]))
    for wname, args in (("none", ()), ("middle half", (ts[:-1], ts[1:], w))):
        stats, launch = compare_stats(act[:-1], act[1:], valid, 600,
                                      f"process log window={wname}", *args)
        check(launch["branch"] == "hash" and launch["columns"] == "shifted"
              and stats[0] == 0,
              f"process log window={wname}: stats {stats}, {launch}")
        overflow[f"none window={wname}"] = stats
    # partial overflow: 1.5 times as many distinct keys as slots
    k = 3 * ops.HASH_SLOTS // 2
    keys = torch.randperm(360_000, generator=gen, device=dev)[:k]
    key = keys[torch.randint(0, k, (1 << 23,), generator=gen, device=dev)]
    valid = torch.rand(1 << 23, generator=gen, device=dev) < 0.9
    stats, launch = compare_stats(key // 600, key % 600, valid, 600,
                                  f"{k} distinct keys")
    check(launch["branch"] == "hash" and 0 < stats[0] < int(valid.sum()),
          f"{k} distinct keys: stats {stats}, {launch}")
    overflow["partial"] = stats
    check(branches == {"shared", "hash"},
          f"sweep reached branches {branches}, expected shared and hash")
    check(columns == {"shifted", "separate"},
          f"sweep reached column layouts {columns}")
    log(f"sweep: {cases} kernel-vs-plain comparisons bit-identical "
        f"(tolerance 0) over both branches {sorted(branches)} and both "
        f"column layouts {sorted(columns)}; hash table [overflowed pairs, "
        f"flush atomics]: {overflow}")
    return worst


def _segment_launch_ok(torch, ll) -> bool:
    """A segment_count launch's grid is at most the card's SMs times the
    blocks per SM its occupancy allows (at most as many as fit an SM by
    threads), and its flush at most grid x S atomics (none on the global
    branch)."""
    props = torch.cuda.get_device_properties(0)
    per_sm = ll["blocks_per_sm"]
    return (1 <= per_sm <= props.max_threads_per_multi_processor // ll["threads"]
            and 1 <= ll["grid"] <= props.multi_processor_count * per_sm
            and ll["flush_bound"] == (ll["grid"] * ll["num_segments"]
                                      if ll["branch"] == "shared" else 0))


def phase_segment_sweep(torch, seg_ops):
    """segment_count ≡ segment_count_plain with torch.equal.  S up to the
    card's opt-in shared memory / 4 (58,112 on an H100) takes the shared
    branch, larger S the global one, both checked on either side of that
    boundary; id views at offsets 1-3 from the 16-byte vectors, every
    remainder of N mod 16 and one hot bin on both branches.  Every launch's
    grid is at most SMs x blocks per SM, and its flush at most grid x S."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    worst, cases, branches = 0, 0, set()
    last_shared = torch.cuda.get_device_properties(0).shared_memory_per_block_optin // 4

    def compare(ids, valid, s, what):
        nonlocal worst, cases
        got = seg_ops.segment_count(ids, valid, num_segments=s)
        want = seg_ops.segment_count_plain(ids, valid, num_segments=s)
        torch.cuda.synchronize()
        check(got.dtype == torch.int64 and got.shape == want.shape,
              f"segment_count {what}: dtype/shape {got.dtype}{tuple(got.shape)}")
        err = int((got - want).abs().max()) if got.numel() else 0
        worst = max(worst, err)
        check(torch.equal(got, want), f"segment_count {what}: max |err| {err}")
        if ids.numel():
            ll = seg_ops.last_launch
            branches.add(ll["branch"])
            check(ll["branch"] == ("shared" if s <= last_shared else "global"),
                  f"segment_count {what}: {ll['branch']} branch at S={s}")
            check(_segment_launch_ok(torch, ll),
                  f"segment_count {what}: launch {ll}")
        cases += 1

    def ids_of(n, s, head):
        """n ids (about 1% out of range on either side) as an int32 view
        ``head`` elements into its storage, and a bool valid view beside."""
        ids = torch.randint(0, s, (n + head,), generator=gen, device=dev,
                            dtype=torch.int32)
        bad = torch.rand(n + head, generator=gen, device=dev)
        ids = torch.where(bad < 0.01, torch.full_like(ids, -3), ids)
        ids = torch.where(bad > 0.99, torch.full_like(ids, s + 5), ids)
        valid = torch.rand(n + head, generator=gen, device=dev) < 0.8
        return ids[head:], valid[head:]

    for s in (600, last_shared, last_shared + 1):
        for head in (0, 1, 2, 3):
            for n in [65_536 + r for r in range(16)] + [3, 1 << 20]:
                ids, valid = ids_of(n, s, head)
                what = f"S={s} N={n} offset={head}"
                compare(ids, valid, s, what + " valid=bool")
                compare(ids, None, s, what + " valid=None")
        for n in (17, 1 << 20, 7_200_010):
            hot = torch.full((n + 1,), s - 1, dtype=torch.int32, device=dev)
            compare(hot, None, s, f"S={s} N={n + 1} one hot bin")
            compare(hot[1:], torch.ones(n, dtype=torch.bool, device=dev), s,
                    f"S={s} N={n} one hot bin at offset 1, valid all ones")
    for s in (1, 3, 600, 4096, 58_000, 100_000, 1_000_000):
        for n in (0, 1, 7, 1000, 1 << 20, 7_200_000):
            ids = torch.randint(0, s, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
            # ~1% ids out of range on either side: the kernel must drop them
            bad = torch.rand(n, generator=gen, device=dev)
            ids = torch.where(bad < 0.01, torch.full_like(ids, -3), ids)
            ids = torch.where(bad > 0.99, torch.full_like(ids, s + 5), ids)
            valid = torch.rand(n, generator=gen, device=dev) < 0.8
            what = f"S={s} N={n}"
            compare(ids, valid, s, what + " valid=bool")
            compare(ids, None, s, what + " valid=None")
            if n in (1000, 1 << 20):
                compare(ids, valid.to(torch.int32), s, what + " valid=int")
                compare(ids, valid.to(torch.float32), s, what + " valid=float")
                if s < (1 << 15):
                    compare(ids.to(torch.int16), valid, s, what + " ids=int16")
                # int64 ids beyond int32's range: dropped, never wrapped
                wide = ids.to(torch.int64)
                wide[::7] += 1 << 32
                wide[::11] = (1 << 31) + 3
                wide[::13] -= 1 << 32
                compare(wide, valid, s, what + " int64 ids beyond 2**31")
                compare(wide, None, s, what + " int64 ids, valid=None")
    check(branches == {"shared", "global"},
          f"segment_count reached branches {branches}, expected both")
    log(f"segment_count sweep: {cases} kernel-vs-plain comparisons "
        f"bit-identical (tolerance 0) over both branches {sorted(branches)}")
    return worst


def _dp_tables(np, rng, s, a, big, kind=0):
    """Random (m (S, A), d0 (S,), endcost (S,)) f32 costs of three kinds:
    0 sparse (small integers, about a third of them ``big``, one start
    state), 1 cheap syncs (the answer hinges on every id), 2 dear syncs (a
    log move often beats the sync on state a)."""
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


def _align_dp_resources(build, dp_ops):
    """Registers and spill bytes of each align_dp kernel instance, from
    nvcc's -Xptxas -v report: {"registers K=20": (regs, spill stores,
    spill loads), "shared": ..., "global": ...}.  Fails unless every
    register instance is there and none spills."""
    import re

    rows = {}
    for entry, r in build.ptxas_resources(build.build("align_dp").ptxas).items():
        k = re.search(r"align_dp_registersILi(\d+)E", entry)
        tier = re.search(r"align_dp_memoryILb([01])E", entry)
        if k:
            label = f"registers K={k.group(1)}"
        elif tier:
            label = "shared" if tier.group(1) == "1" else "global"
        else:
            continue
        rows[label] = (r.get("registers"), r.get("spill_stores"),
                       r.get("spill_loads"))
    want = ([f"registers K={k}" for k, _ in dp_ops.REGISTER_INSTANCES]
            + ["shared", "global"])
    check(sorted(rows) == sorted(want),
          f"align_dp's ptxas report lists {sorted(rows)}, not {sorted(want)}")
    spills = {k: v for k, v in rows.items()
              if k.startswith("registers") and (v[1] or v[2])}
    check(not spills, f"align_dp register instances spill: {spills}")
    return {k: rows[k] for k in want}


def _segment_count_resources(build):
    """Registers and spill bytes of each segment_count kernel instance, from
    nvcc's -Xptxas -v report: {"shared, valid": (regs, spill stores, spill
    loads), ...}.  Fails unless all four instances are there and none
    spills: a thread keeps its 16 ids in registers."""
    import re

    rows = {}
    for entry, r in build.ptxas_resources(
            build.build("segment_count").ptxas).items():
        m = re.search(r"segment_count_kernelILb([01])ELb([01])E", entry)
        if m:
            label = (("shared" if m.group(2) == "1" else "global")
                     + (", valid" if m.group(1) == "1" else ", no valid"))
            rows[label] = (r.get("registers"), r.get("spill_stores"),
                           r.get("spill_loads"))
    check(len(rows) == 4, f"segment_count's ptxas report lists {sorted(rows)}")
    spills = {k: v for k, v in rows.items() if v[1] or v[2]}
    check(not spills, f"segment_count instances spill: {spills}")
    return rows


def phase_align_sweep(torch, dp_ops):
    """align_dp ≡ align_dp_plain with torch.equal on all three tiers: each
    register instance (K, KLO) at both ends of 32 KLO < S <= 32 K and one
    state past each, with ids over every state but the last (so the sync
    lands on every slot of the register front); 8 warps' fronts of S f32
    states fit a block's shared memory up to S = 7,264; 7,265 and 20,000
    states take the global tier.  Two cases run
    at the main path's scale (294,838 variants of up to 168 events over 601
    states), one on cost tables of a random model."""
    import numpy as np

    from repro_torch.conformance import ModelSpec, alignment_cost_tables

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2)
    big = np.float32(dp_ops.BIG_COST)
    worst, cases, tiers, ks = 0.0, 0, set(), set()

    def compare(seqs, lens, tables, what):
        nonlocal worst, cases
        inputs = dp_ops.prepare(seqs, lens, *tables, dev)
        v = int(inputs[1].shape[0]) - 1
        got = dp_ops.align_dp_device(*inputs)
        if v:
            tiers.add(dp_ops.last_launch["branch"])
            if dp_ops.last_launch["branch"] == "registers":
                k = dp_ops.last_launch["k"]
                ks.add(k)
                s = int(inputs[2].shape[1])
                check(32 * dict(dp_ops.REGISTER_INSTANCES)[k] < s <= 32 * k,
                      f"align_dp {what}: S={s} launched the K={k} instance")
        want = dp_ops.align_dp_plain(*inputs)
        torch.cuda.synchronize()
        check(got.dtype == torch.float32 and got.shape == want.shape,
              f"align_dp {what}: dtype/shape {got.dtype}{tuple(got.shape)}")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        worst = max(worst, err)
        check(torch.equal(got, want), f"align_dp {what}: max |err| {err}")
        cases += 1

    sizes = sorted({x for k, lo in dp_ops.REGISTER_INSTANCES
                    for x in (32 * lo, 32 * lo + 1, 32 * k, 32 * k + 1)}
                   | {1, 3, 601, 7264, 7265, 20_000})
    for n, s in enumerate(sizes):
        a = max(s - 1, 1) if s <= 1025 else (300 if s > 7265 else 40)
        tables = _dp_tables(np, rng, s, a, big, kind=n % 3)
        shapes = [(0, 1), (1, 1), (7, 5), (1000, 40)]
        shapes.append((2000, 168) if s > 7264 else (20_000, 168))
        for v, l in shapes:
            seqs = rng.integers(0, a, (v, l)).astype(np.int32)
            lens = rng.integers(0, l + 1, v)
            compare(seqs, lens, tables, f"S={s} A={a} V={v} L={l}")
        # int64 ids: converted; ids outside [0, A) at an active position, or
        # beyond int32's range, are refused, padded or ragged
        seqs = rng.integers(0, a, (64, 9))
        lens = rng.integers(0, 10, 64)
        compare(seqs, lens, tables, f"S={s} A={a} int64 ids")
        for bad in (a, -1, (1 << 32) + 1):
            wrong = seqs.copy()
            wrong[3, 0] = bad
            lens_w = lens.copy()
            lens_w[3] = 9
            offsets = np.concatenate([[0], np.cumsum(lens_w)])
            ragged = wrong[np.arange(9)[None, :] < lens_w[:, None]]
            for call in (
                lambda: dp_ops.align_dp(wrong, lens_w, *tables, device=dev),
                lambda: dp_ops.align_dp_ragged(ragged, offsets, *tables,
                                               device=dev),
            ):
                try:
                    call()
                except ValueError:
                    continue
                raise SmokeFailure(f"align_dp took activity id {bad} at S={s}")
    # the main path's scale, and a random model's cost tables
    names = [f"a{i}" for i in range(600)]
    edges = tuple((x, y) for x in names[:200] for y in names[:200]
                  if rng.random() < 0.02)
    spec = ModelSpec(activities=tuple(names), edges=edges,
                     starts=tuple(names[:5]), ends=tuple(names[100:110]))
    tables = alignment_cost_tables(spec, names)
    seqs = rng.integers(0, 600, (294_838, 168)).astype(np.int32)
    lens = np.minimum(rng.geometric(1 / 13, 294_838), 168)
    compare(seqs, lens, tables, "V=294838 L=168 S=601, random model")
    compare(seqs, lens, _dp_tables(np, rng, 601, 600, big, kind=1),
            "V=294838 L=168 S=601, random costs")
    check(tiers == {"registers", "shared", "global"},
          f"align_dp reached tiers {tiers}, expected all three")
    want_ks = {k for k, _ in dp_ops.REGISTER_INSTANCES}
    check(ks == want_ks,
          f"align_dp reached register instances {sorted(ks)}, expected "
          f"{sorted(want_ks)}")
    log(f"align_dp sweep: {cases} kernel-vs-plain comparisons bit-identical "
        f"(tolerance 0) over the tiers "
        f"{sorted(tiers)} and register instances K = {sorted(ks)}")
    return worst


# ---------------------------------------------------------------------------
# Phase 3 — the main path at PAPER_EVAL width
# ---------------------------------------------------------------------------


def phase_main_path(torch, tmp):
    import numpy as np

    from repro_torch.configs import PAPER_EVAL
    from repro_torch.core import (
        dfg_numpy,
        discover_dependency_graph,
        filter_dfg,
        pair_mask_for_window,
    )
    from repro_torch.data import ProcessSpec, generate_memmap_log
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.query import Q, QueryEngine, repository_from_memmap

    cfg = PAPER_EVAL
    spec = ProcessSpec(
        num_activities=cfg.num_activities,
        mean_trace_len=cfg.mean_trace_len,
        horizon_days=cfg.horizon_days,
        seed=0,
    )
    t0 = time.perf_counter()
    mlog = generate_memmap_log(os.path.join(tmp, "paper_eval"),
                               cfg.num_events, spec, seed=0)
    log(f"main path: generated {mlog.num_events} events, "
        f"{mlog.num_activities} activities, {mlog.num_traces} traces in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    engine = QueryEngine()
    log(f"main path: default QueryEngine() on {engine.device}, memory "
        f"budget {engine.memory_budget_events} events (from the card's and "
        "the host's free memory)")
    check(engine.memory_budget_events >= mlog.num_events,
          f"budget {engine.memory_budget_events} < {mlog.num_events} events: "
          "the default engine would stream on the host")
    t_min = float(mlog.time[0])
    dices = (1, 7, 30, 120)

    ops.reset_launch_counts()
    results = [("all", None, Q.log(mlog).using(engine).dfg())]
    for d in dices:
        w = (t_min, t_min + d * DAY)
        results.append((f"{d}d", w, Q.log(mlog).using(engine).window(*w).dfg()))
    counts = dict(ops.launch_counts)

    for name, w, res in results:
        check(res.physical.backend == "kernel",
              f"query {name} ran on {res.physical.backend}, not the kernel")
        check(res.physical.fused_dicing == (w is not None),
              f"query {name}: fused_dicing={res.physical.fused_dicing}")
        check(not res.from_cache, f"query {name} came from the cache")
    check(counts["dfg_count"] >= 1 and counts["dfg_count_diced"] >= 1,
          f"main path launch counts {counts}: a kernel never launched")
    log(f"main path launches: {counts}")

    t0 = time.perf_counter()
    repo = repository_from_memmap(mlog)
    src, dst, valid = repo.df_pairs()
    log(f"oracle: materialized {repo.num_events} events in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    names = [f"act_{i:03d}" for i in range(cfg.num_activities)]
    for name, w, res in results:
        v = valid if w is None else valid & pair_mask_for_window(repo, w)
        want = dfg_numpy(src, dst, v, cfg.num_activities)
        psi = res.value
        check(isinstance(psi, np.ndarray) and psi.dtype == np.int64
              and psi.shape == want.shape, f"query {name}: bad result array")
        check(res.names == names, f"query {name}: activity names differ")
        check(np.array_equal(psi, want),
              f"query {name}: Ψ differs from the host oracle in "
              f"{int((psi != want).sum())} cells")
        log(f"  {name:>4}: Ψ total {int(psi.sum())} == host oracle; "
            f"{res.physical.describe()}")
    check(np.array_equal(results[-1][2].value, results[0][2].value),
          "the 120-day dice should cover the whole log")

    starts, ends = repo.trace_boundaries()
    psi = results[0][2].value
    model = discover_dependency_graph(
        filter_dfg(psi, min_count=10), names, starts, ends, min_count=10,
    )
    check(len(model.edges) > 0, "discovery found no edges")
    log(f"discovery: {len(model.edges)} dependency edges, "
        f"{len(model.start_activities)} start activities")
    return counts, results, repo, mlog, model


# ---------------------------------------------------------------------------
# Phase 3b — the graph tier at PAPER_EVAL width
# ---------------------------------------------------------------------------


def _same_graph_arrays(np, got, want, what):
    fields = ["node_counts", "event_activity", "event_trace", "event_time",
              "act_indptr", "act_events", "case_indptr"]
    for f in fields:
        check(np.array_equal(np.asarray(getattr(got, f)),
                             np.asarray(getattr(want, f))), f"{what}: {f} differs")
    for side in ("adj", "radj"):
        for f in ("indptr", "indices", "counts"):
            check(np.array_equal(np.asarray(getattr(getattr(got, side), f)),
                                 np.asarray(getattr(getattr(want, side), f))),
                  f"{what}: {side}.{f} differs")
    check(got.activity_names == want.activity_names
          and (got.num_events, got.num_traces) == (want.num_events, want.num_traces),
          f"{what}: shapes differ")


def _same_process_map(np, got, want) -> bool:
    return (got.activities == want.activities and got.edges == want.edges
            and np.array_equal(got.node_counts, want.node_counts)
            and (got.dropped_activities, got.dropped_edges)
            == (want.dropped_activities, want.dropped_edges))


def _build_split(torch, mlog):
    """One in-budget build of ``mlog``'s graph on the card, step by step as
    ``build_graph`` runs it, each step on the host clock with the card
    synchronized.  Returns (graph, {step: seconds})."""
    import numpy as np

    from repro_torch.graph import build as gb
    from repro_torch.query import repository_from_memmap

    dev = torch.device("cuda", 0)
    split = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[name] = time.perf_counter() - t0
        return out

    a = mlog.num_activities
    repo = step("materialize", lambda: repository_from_memmap(mlog))
    src, dst, valid = repo.df_pairs()
    adj, psi = step("aggregate (h2d + dfg_count + d2h + sparsify)",
                    lambda: gb._aggregate_pairs(src, dst, valid, a, "kernel", dev))

    def miner():
        raw_case = np.asarray(mlog.case)
        order = np.lexsort(
            (np.arange(raw_case.shape[0]), np.asarray(mlog.time), raw_case))
        return gb._miner_state_from_columns(
            psi, np.asarray(mlog.activity)[order], raw_case[order],
            mlog.num_events)

    state = step("miner state", miner)
    counts = step("node counts (h2d + segment_count + d2h)",
                  lambda: gb._node_counts(repo.event_activity, a, "kernel", dev))
    tables = step("event tables", lambda: gb._event_tables(
        repo.event_activity, repo.event_trace, repo.event_time, a,
        repo.num_traces))
    radj = step("transpose", adj.transpose)
    g = gb.EventGraph(
        activity_names=list(repo.activity_names), num_events=mlog.num_events,
        num_traces=repo.num_traces, node_counts=counts, adj=adj, radj=radj,
        rows_end=mlog.num_events, miner=state, **tables,
    )
    step("window index (first windowed query)", g.window_index)
    return g, split


def phase_graph(torch, mlog, repo, results, tmp):
    import numpy as np

    from repro_torch.core import dfg_numpy, pair_mask_for_window
    from repro_torch.graph import (
        build_graph,
        csr_from_dense,
        derive_neighborhood,
        derive_process_map,
        load_graph,
        save_graph,
    )
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops
    from repro_torch.query import Q, QueryEngine, fingerprint

    a = mlog.num_activities
    names = [f"act_{i:03d}" for i in range(a)]
    t_min = float(mlog.time[0])
    psi_all = results[0][2].value  # == the host oracle (phase 3)
    hist_all = np.bincount(repo.event_activity, minlength=a).astype(np.int64)

    engine = QueryEngine()
    ops.reset_launch_counts()
    seg_ops.reset_launch_counts()
    q = Q.log(mlog).using(engine)
    cold = q.process_map(backend="graph")
    warm = {
        "histogram": q.histogram(backend="graph"),
        "dfg": q.dfg(backend="graph"),
        "neighborhood": q.neighborhood("act_000", k=2, direction="both",
                                       backend="graph"),
        "process_map top=0.5": q.process_map(top=0.5, backend="graph"),
    }
    windowed = {}
    for d in (1, 7, 30):
        w = (t_min, t_min + d * DAY)
        windowed[d] = (w, q.window(*w).dfg(backend="graph"))
    counts = {**ops.launch_counts, **seg_ops.launch_counts}
    log(f"graph path launches: {counts} (one graph build)")
    check(counts["dfg_count"] == 1 and counts["segment_count"] == 1,
          f"graph build launch counts {counts}: expected dfg_count and "
          "segment_count once each")
    check(engine.graphs.stats.builds == 1, "the graph was built more than once")
    for res in [cold, *warm.values(), *(r for _, r in windowed.values())]:
        check(res.physical.backend == "graph",
              f"graph query ran on {res.physical.backend}")

    # every answer against the host oracles
    adj_all = csr_from_dense(psi_all)
    check(np.array_equal(warm["dfg"].value, psi_all),
          "graph DFG differs from the host oracle")
    check(np.array_equal(warm["histogram"].value, hist_all),
          "graph histogram differs from np.bincount")
    want_pm = derive_process_map(adj_all, hist_all, names)
    check(_same_process_map(np, cold.value, want_pm),
          "graph process map differs from the oracle derivation")
    want_nb = derive_neighborhood(adj_all, adj_all.transpose(), names,
                                  "act_000", 2, "both")
    check(warm["neighborhood"].value == want_nb,
          "graph neighborhood differs from the oracle derivation")
    src, dst, valid = repo.df_pairs()
    for d, (w, res) in windowed.items():
        want = dfg_numpy(src, dst, valid & pair_mask_for_window(repo, w), a)
        check(np.array_equal(res.value, want),
              f"{d}-day graph DFG differs from the host oracle")
        log(f"  graph {d:>3}d dice: Ψ total {int(want.sum())} == host oracle; "
            f"{res.physical.describe()}")
    log(f"graph answers == host oracles: process map ({len(cold.value.edges)} "
        f"edges), histogram, DFG (Ψ total {int(psi_all.sum())}), neighborhood "
        f"({len(warm['neighborhood'].value.activities)} activities)")
    log("graph query wall times (s; host clock, card synchronized):")
    log(f"  cold process_map (builds the graph): {cold.wall_s:.4f}")
    for name, res in warm.items():
        log(f"  warm {name}: {res.wall_s:.4f}")
    for d, (_, res) in windowed.items():
        log(f"  warm {d}-day dice: {res.wall_s:.4f}")

    # the build's split, step by step as build_graph runs it
    g_split, split = _build_split(torch, mlog)
    g = engine.graphs.get(fingerprint(mlog))
    _same_graph_arrays(np, g_split, g, "step-by-step build")
    log(f"graph build split [{mlog.num_events} events] (s; host clock, card "
        f"synchronized): " + "  ".join(f"{k} {v:.4f}" for k, v in split.items()))

    # auto reaches the graph on the third topology miss of a fresh engine
    fresh = QueryEngine()
    backends = [
        Q.log(mlog).using(fresh).neighborhood(names[i]).physical.backend
        for i in range(3)
    ]
    check(backends[:2] == ["kernel", "kernel"] and backends[2] == "graph",
          f"crossover: the three misses ran on {backends}")
    log(f"crossover: a fresh engine ran three topology misses on {backends}")

    # a windowed columnar process map fuses the dice into dfg_count_diced
    w30 = windowed[30][0]
    diced = ops.launch_counts["dfg_count_diced"]
    col = Q.log(mlog).using(fresh).window(*w30).process_map(backend="kernel")
    gpm = q.window(*w30).process_map(backend="graph")
    check(col.physical.backend == "kernel" and col.physical.fused_dicing,
          f"columnar 30-day process map: {col.physical.describe()}")
    check(ops.launch_counts["dfg_count_diced"] == diced + 1,
          "the columnar process map did not launch dfg_count_diced")
    check(_same_process_map(np, col.value, gpm.value),
          "columnar (fused) and graph 30-day process maps differ")
    log(f"30-day process map: columnar ({col.physical.describe()}) == graph")

    # snapshot round trip
    snap = os.path.join(tmp, "graph_snapshot")
    t0 = time.perf_counter()
    save_graph(g, snap)
    t1 = time.perf_counter()
    loaded = load_graph(snap)
    _same_graph_arrays(np, loaded, g, "save_graph → load_graph")
    log(f"snapshot: save {t1 - t0:.4f} s, load + compare "
        f"{time.perf_counter() - t1:.4f} s, arrays equal")

    # an append of ~1% of the rows extends the graph over the suffix only
    rng = np.random.default_rng(0)
    n_new = mlog.num_events // 100
    grown = mlog.append(
        rng.integers(0, a, n_new).astype(np.int32),
        rng.integers(0, mlog.num_traces, n_new).astype(np.int32),
        float(mlog.time[-1]) + np.sort(rng.uniform(0.0, DAY, n_new)),
    )
    rows0 = engine.stats.rows_scanned
    ext = Q.log(grown).using(engine).process_map(backend="graph")
    check(engine.graphs.stats.extends == 1 and engine.graphs.stats.builds == 1,
          f"append: graph store stats {engine.graphs.stats}")
    check(engine.stats.rows_scanned - rows0 == n_new,
          f"append: scanned {engine.stats.rows_scanned - rows0} rows, "
          f"expected the {n_new}-row suffix")
    g_ext = engine.graphs.get(fingerprint(grown))
    g_fresh = build_graph(grown, source_fp=fingerprint(grown))
    _same_graph_arrays(np, g_ext, g_fresh, "extended vs fresh build")
    want_ext = derive_process_map(g_fresh.adj, g_fresh.node_counts, names)
    check(_same_process_map(np, ext.value, want_ext),
          "extended process map differs from the fresh build's")
    log(f"append: {n_new} rows; extended over the suffix only (rows scanned "
        f"+{n_new}, wall {ext.wall_s:.4f} s) == fresh build")
    return counts


# ---------------------------------------------------------------------------
# Phase 3c — conformance at PAPER_EVAL width
# ---------------------------------------------------------------------------


def _same_replay(np, got, want, what):
    check(np.array_equal(got.trace_fitness, want.trace_fitness)
          and got.fitness == want.fitness
          and got.perfectly_fitting == want.perfectly_fitting
          and got.deviating_edges == want.deviating_edges,
          f"{what}: replay results differ")


def _same_alignment(np, got, want, what):
    for f in ("trace_cost", "trace_fitness", "variant_costs"):
        check(np.array_equal(getattr(got, f), getattr(want, f)),
              f"{what}: {f} differs")
    check((got.fitness, got.perfectly_fitting, got.empty_cost)
          == (want.fitness, want.perfectly_fitting, want.empty_cost)
          and got.deviating_edges == want.deviating_edges,
          f"{what}: alignment summaries differ")


def _alignment_split(torch, mlog, dp_ops):
    """One default-model alignment of ``mlog``, step by step as the engine
    runs it (materialize, model discovery, variant table, cost tables, the
    ragged ids' checks and h2d, the kernel, d2h, broadcast + census), each
    step on the host clock with the card synchronized; then, off the sum,
    the padded route (the (V, L) seqs matrix, its checks and h2d), whose
    tensors must equal the ragged ones.  Returns ({step: seconds}, {padded step: seconds},
    AlignmentResult, DP inputs on the card, the kernel's raw output, the
    host seqs / lens / tables)."""
    import numpy as np

    from repro_torch.conformance import alignment_cost_tables
    from repro_torch.conformance.align import (
        finish_alignment,
        finish_variant_costs,
        variant_ids,
        variant_matrix,
    )
    from repro_torch.core import (
        dfg_numpy,
        discover_dependency_graph,
        variant_table,
    )
    from repro_torch.query import repository_from_memmap

    dev = torch.device("cuda", 0)
    split, padded = {}, {}

    def step(name, fn, into=split):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        into[name] = time.perf_counter() - t0
        return out

    repo = step("materialize", lambda: repository_from_memmap(mlog))
    names = list(repo.activity_names)
    act, trace = repo.event_activity, repo.event_trace

    def discover():
        src, dst, valid = repo.df_pairs()
        starts, ends = repo.trace_boundaries()
        return discover_dependency_graph(
            dfg_numpy(src, dst, valid, len(names)), names, starts, ends)

    model = step("default model", discover)
    tv = step("variant table",
              lambda: variant_table(act, trace, repo.num_traces, names))
    m, d0, end = step("cost tables", lambda: alignment_cost_tables(model, names))
    inputs = step("checks + h2d", lambda: dp_ops.prepare_ragged(
        variant_ids(tv, names), tv.variant_offsets, m, d0, end, dev))
    raw_d = step("kernel", lambda: dp_ops.align_dp_device(*inputs))
    raw = step("d2h", lambda: raw_d.cpu().numpy())

    def finish():
        empty = float((d0 + end).min())
        empty_cost = -1 if empty >= dp_ops.BIG_COST / 2 else int(empty)
        costs = finish_variant_costs(raw, tv.lengths)
        return finish_alignment(act, trace, repo.num_traces, names, model,
                                tv, costs, empty_cost)

    res = step("broadcast + census", finish)
    seqs, lens = step("seqs", lambda: variant_matrix(tv, names), padded)
    from_padded = step("checks + h2d", lambda: dp_ops.prepare(
        seqs, lens, m, d0, end, dev), padded)
    check(all(torch.equal(x, y) for x, y in zip(from_padded, inputs)),
          "prepare of the padded matrix differs from prepare_ragged of the "
          "variant table")
    check(np.array_equal(lens, tv.lengths), "variant_matrix's lens differ")
    return split, padded, res, inputs, raw_d, (seqs, lens, m, d0, end)


def phase_conformance(torch, mlog, repo, model):
    import numpy as np

    from repro_torch.kernels.align_dp import ops as dp_ops
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops
    from repro_torch.query import Q, QueryEngine

    t_min = float(mlog.time[0])
    w30 = (t_min, t_min + 30 * DAY)
    engine = QueryEngine()
    q = Q.log(mlog).using(engine)
    # the first two conformance misses on a source run on auto's columnar
    # path; from the third, auto would serve them from the source's graph
    # (the repeat-query crossover), so the rest name their backend
    queries = {
        "alignments": lambda: q.alignments(),
        "alignments model": lambda: q.alignments(model),
        "alignments 30d": lambda: q.window(*w30).alignments(backend="numpy"),
        "fitness numpy": lambda: q.fitness(backend="numpy"),
        "fitness streaming": lambda: q.fitness(backend="streaming"),
        "fitness graph": lambda: q.fitness(backend="graph"),
        "alignments graph": lambda: q.alignments(backend="graph"),
    }
    ops.reset_launch_counts()
    seg_ops.reset_launch_counts()
    dp_ops.reset_launch_counts()
    res, launched, tiers = {}, {}, {}
    for name, fn in queries.items():
        before = dp_ops.launch_counts["align_dp"]
        res[name] = fn()
        launched[name] = dp_ops.launch_counts["align_dp"] - before
        if launched[name]:
            tiers[name] = dp_ops.last_launch["branch"]
    counts = {**ops.launch_counts, **seg_ops.launch_counts,
              **dp_ops.launch_counts}
    log(f"conformance path launches: {counts}")
    for name, r in res.items():
        want = 1 if name.startswith("alignments") else 0
        check(launched[name] == want,
              f"{name}: align_dp launched {launched[name]} times, not {want}")
        check(not r.from_cache, f"{name} came from the cache")
        log(f"  {name}: wall {r.wall_s:.4f} s, align_dp launches "
            f"{launched[name]} ({tiers.get(name, 'none')} tier); "
            f"{r.physical.describe()}")
    check(tiers["alignments"] == "registers",
          f"the default-model alignments() ran on the {tiers['alignments']} "
          "tier")
    for b in ("numpy", "streaming", "graph"):
        check(res[f"fitness {b}"].physical.backend == b,
              f"fitness {b} ran on {res[f'fitness {b}'].physical.backend}")
    for name in ("alignments", "alignments model", "alignments 30d"):
        check(res[name].physical.backend == "numpy"
              and res[name].physical.materialize,
              f"{name}: {res[name].physical.describe()}")
    check(res["alignments graph"].physical.backend == "graph",
          "alignments(backend='graph') did not run on the graph")

    # fitness: the three backends agree
    base = res["fitness numpy"].value
    for b in ("streaming", "graph"):
        _same_replay(np, res[f"fitness {b}"].value, base, f"fitness {b}")
    log(f"fitness: numpy == streaming == graph (fitness {base.fitness:.6f}, "
        f"{base.perfectly_fitting} of {base.trace_fitness.shape[0]} traces "
        f"fit, {len(base.deviating_edges)} deviating edges)")
    _same_alignment(np, res["alignments graph"].value,
                    res["alignments"].value, "graph vs columnar alignments")

    # alignments' perfect traces are replay's (cost 0 ⇔ a sync-only walk ⇔
    # replay fitness 1), for the same model and selection
    before = dp_ops.launch_counts["align_dp"]
    replays = {
        "alignments": base,
        "alignments model": q.fitness(model, backend="numpy").value,
        "alignments 30d": q.window(*w30).fitness(backend="numpy").value,
    }
    check(dp_ops.launch_counts["align_dp"] == before,
          "a fitness() query launched align_dp")
    ts = repo.event_time
    in30 = (ts >= w30[0]) & (ts < w30[1])
    trace_lens = {
        "alignments": np.bincount(repo.event_trace, minlength=repo.num_traces),
        "alignments model": np.bincount(repo.event_trace,
                                        minlength=repo.num_traces),
        "alignments 30d": np.unique(repo.event_trace[in30],
                                    return_counts=True)[1],
    }
    for name, rep in replays.items():
        ali = res[name].value
        cost = ali.trace_cost
        check(cost.shape == rep.trace_fitness.shape,
              f"{name}: {cost.shape} traces vs replay's "
              f"{rep.trace_fitness.shape}")
        check(np.array_equal(cost == 0, rep.trace_fitness >= 1.0 - 1e-12)
              and ali.perfectly_fitting == rep.perfectly_fitting,
              f"{name}: perfect traces differ from replay's")
        lens = trace_lens[name]
        top = lens + max(ali.empty_cost, 0)
        check(bool((cost >= 0).all() and (cost <= top).all()),
              f"{name}: a cost outside [0, len + empty_cost]")
        check(np.isfinite(ali.trace_fitness).all()
              and ((ali.trace_fitness >= 0) & (ali.trace_fitness <= 1)).all(),
              f"{name}: fitness outside [0, 1]")
        log(f"  {name}: {cost.shape[0]} traces, {ali.variant_costs.shape[0]} "
            f"variants, fitness {ali.fitness:.6f}, {ali.perfectly_fitting} "
            f"perfect == replay's, empty_cost {ali.empty_cost}, costs in "
            f"[0, len + empty_cost] (max {int(cost.max())})")

    # the DP of the default-model query, step by step: it equals the query,
    # its full output equals the plain version on the card, and a sample
    # equals the host oracle
    split, padded, again, inputs, raw_d, host = _alignment_split(
        torch, mlog, dp_ops)
    _same_alignment(np, again, res["alignments"].value,
                    "step-by-step vs query alignments")
    check(dp_ops.last_launch["branch"] == "registers"
          and dp_ops.last_launch["events"] == int(inputs[0].shape[0]),
          f"the default-model DP ran as {dp_ops.last_launch}")
    plain = dp_ops.align_dp_plain(*inputs)
    torch.cuda.synchronize()
    err = float((raw_d - plain).abs().max())
    check(torch.equal(raw_d, plain),
          f"align_dp differs from its plain version on the main path's "
          f"{raw_d.shape[0]} variants: max |err| {err}")
    seqs, lens, m, d0, end = host
    rng = np.random.default_rng(0)
    ends = {int(np.argmax(lens)), int(np.argmin(lens))}
    rest = np.setdiff1d(np.arange(lens.shape[0]), list(ends))
    k = min(4096, lens.shape[0]) - len(ends)
    pick = np.sort(np.concatenate([
        list(ends), rng.choice(rest, k, replace=False)]).astype(np.int64))
    want = dp_ops.align_dp(seqs[pick], lens[pick], m, d0, end, backend="numpy")
    got = raw_d.cpu().numpy()[pick]
    check(np.array_equal(got.view(np.uint32), want.view(np.uint32)),
          f"align_dp differs from the host oracle on the sample in "
          f"{int((got != want).sum())} variants")
    v, l = seqs.shape
    ll = dp_ops.last_launch
    log(f"align_dp on the main path's inputs: V={v} L={l} S={m.shape[0]} "
        f"A={m.shape[1]}, sum(len)={int(lens.sum())}, ragged ({ll['events']} "
        f"ids + {v + 1} offsets, no (V, L) matrix on the card; {ll['branch']} "
        f"tier, K={ll['k']}, grid {ll['grid']}x{ll['threads']}); all {v} "
        f"variants == align_dp_plain on the card (max |err| {err}); "
        f"{pick.shape[0]} sampled variants (longest {int(lens.max())}, "
        f"shortest {int(lens.min())}) == host align_dp_numpy, bit for bit")
    return counts, {
        "inputs": inputs, "lens": lens, "split": split,
        "padded": padded, "results": res, "err": err, "tiers": tiers,
    }


# ---------------------------------------------------------------------------
# Phase 3d — variant analysis at PAPER_EVAL width
# ---------------------------------------------------------------------------


def _oracle_variants(np, repo):
    """Each trace's activity-id tuple and the count of each tuple, grouped
    on the host with no hash (the repository is canonical:
    trace-contiguous, trace ids in order)."""
    import collections

    act = repo.event_activity.tolist()
    lens = np.bincount(repo.event_trace, minlength=repo.num_traces)
    b = np.zeros(lens.shape[0] + 1, dtype=np.int64)
    np.cumsum(lens, out=b[1:])
    b = b.tolist()
    seqs = [tuple(act[b[t]:b[t + 1]]) for t in range(repo.num_traces)]
    return seqs, collections.Counter(seqs)


def _check_variant_table(np, tv, seqs, counts, what):
    """The port's table against the host oracle: the same variants with
    the same counts, in non-increasing count order (ties in any order),
    and every trace mapped to its own sequence's variant."""
    v = tv.num_variants
    ids = tv.variant_activity.tolist()
    off = tv.variant_offsets.tolist()
    got = [tuple(ids[off[i]:off[i + 1]]) for i in range(v)]
    c = tv.counts.tolist()
    check(v == len(counts) and len(set(got)) == v,
          f"{what}: {v} variants, the oracle {len(counts)}")
    check(all(counts[q] == n for q, n in zip(got, c)),
          f"{what}: a variant's count differs from the oracle's")
    check(bool((np.diff(tv.counts) <= 0).all()),
          f"{what}: counts are not in non-increasing order")
    index = {q: i for i, q in enumerate(got)}
    check(np.array_equal(tv.trace_variant,
                         np.asarray([index[q] for q in seqs])),
          f"{what}: trace_variant maps a trace off its sequence")


def _end_of_tie_run(np, desc, k):
    """The k that keeps every variant counted at least ``desc[k - 1]``, so
    the kept set needs no tie order."""
    return int(np.count_nonzero(desc >= desc[k - 1]))


def phase_variants(torch, mlog, repo, results, card):
    """Variants, ``top_variants(k)`` and relink barriers through a default
    engine on the memmap log, each answer against a host oracle written
    here (tolerance 0), then the split of the barriers on the host clock.
    Returns {kernel: launches}."""
    import numpy as np

    from repro_torch.conformance import alignment_cost_tables
    from repro_torch.conformance.align import (
        finish_variant_costs,
        variant_matrix,
    )
    from repro_torch.core import (
        AccessPolicy,
        AnalystSession,
        dfg_numpy,
        dice_repository,
        discover_dependency_graph,
        trace_variants,
        variant_filtered_repository,
        variant_table,
    )
    from repro_torch.core.views import AccessDenied
    from repro_torch.kernels.align_dp import ops as dp_ops
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops
    from repro_torch.query import Q, QueryEngine

    a = repo.num_activities
    names = list(repo.activity_names)
    t_min = float(mlog.time[0])
    w7, w30 = (t_min, t_min + 7 * DAY), (t_min, t_min + 30 * DAY)
    act, trace, ts = repo.event_activity, repo.event_trace, repo.event_time
    src, dst, valid = repo.df_pairs()

    t0 = time.perf_counter()
    seqs, counts = _oracle_variants(np, repo)
    desc = np.sort(np.asarray(list(counts.values()), dtype=np.int64))[::-1]
    log(f"variants oracle: {len(counts)} distinct activity sequences over "
        f"{repo.num_traces} traces, grouped by tuple in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    k10 = _end_of_tie_run(np, desc, 10)
    cum = np.cumsum(desc)
    least50 = int(np.searchsorted(cum, 0.5 * cum[-1])) + 1
    k50 = _end_of_tie_run(np, desc, least50)
    check(k50 < desc.shape[0], "top_variants(k50) would keep every variant")
    log(f"k = 10 → {k10} and k50 = {least50} → {k50} (ends of tie runs; "
        f"counts {int(desc[k10 - 1])} and {int(desc[k50 - 1])}, coverage "
        f"{cum[k10 - 1] / cum[-1]:.4f} and {cum[k50 - 1] / cum[-1]:.4f})")
    freq = np.bincount(act, minlength=a)
    keep_ids = np.sort(np.argsort(-freq, kind="stable")[:a // 2])
    keep = [names[i] for i in keep_ids]

    engine = QueryEngine()
    q = Q.log(mlog).using(engine)
    queries = {
        "variants": lambda: q.variants(),
        "variants 10": lambda: q.variants(10),
        f"top_variants({k10}).dfg": lambda: q.top_variants(k10).dfg(),
        f"top_variants({k50}).dfg": lambda: q.top_variants(k50).dfg(),
        f"top_variants({k50}).window(30d).dfg":
            lambda: q.top_variants(k50).window(*w30).dfg(),
        "relink.dfg": lambda: q.activities(keep, relink=True).dfg(),
        "relink.window(7d).dfg":
            lambda: q.activities(keep, relink=True).window(*w7).dfg(),
        f"top_variants({k50}).alignments":
            lambda: q.top_variants(k50).alignments(),
    }
    ops.reset_launch_counts()
    seg_ops.reset_launch_counts()
    dp_ops.reset_launch_counts()
    res, launched, last = {}, {}, {}
    for name, fn in queries.items():
        before = {**ops.launch_counts, **dp_ops.launch_counts}
        res[name] = fn()
        after = {**ops.launch_counts, **dp_ops.launch_counts}
        launched[name] = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}
        last[name] = dict(dp_ops.last_launch if "align_dp" in launched[name]
                          else ops.last_launch)
    counts_3d = {**ops.launch_counts, **seg_ops.launch_counts,
                 **dp_ops.launch_counts}
    log(f"variant analysis launches: {counts_3d}")
    check(counts_3d["dfg_count"] >= 1 and counts_3d["dfg_count_diced"] >= 1
          and counts_3d["align_dp"] == 1 and counts_3d["segment_count"] == 0,
          f"phase 3d launch counts {counts_3d}")
    for name, r in res.items():
        check(not r.from_cache, f"{name} came from the cache")
        log(f"  {name}: wall {r.wall_s:.4f} s, launches {launched[name]}, "
            f"{r.physical.describe()}")

    # 1. the variant table, and its top 10
    tv = res["variants"].value
    _check_variant_table(np, tv, seqs, counts, "variants()")
    top = res["variants 10"].value
    check(np.array_equal(top.counts, tv.counts[:10])
          and top.sequences == tv.sequences[:10]
          and np.array_equal(top.trace_variant, tv.trace_variant),
          "variants(10) is not the head of variants() with the whole "
          "trace_variant")
    check(not launched["variants"] and not launched["variants 10"],
          "the variants sink launched a kernel")
    log(f"variants(): {tv.num_variants} variants == the host oracle's "
        f"(exact grouping; counts, sequences and trace_variant equal up to "
        f"the order of ties), top count {int(tv.counts[0])}, coverage of "
        f"the top 10 {tv.coverage(10):.4f}; variants(10) is its head")

    # 2-3. top_variants(k).dfg() and its 30-day window
    for k in (k10, k50):
        kept_trace = np.asarray([counts[s] >= desc[k - 1] for s in seqs])
        kept = kept_trace[trace]
        for win in (None, w30) if k == k50 else (None,):
            name = (f"top_variants({k}).dfg" if win is None
                    else f"top_variants({k}).window(30d).dfg")
            r = res[name]
            v = valid & kept[:-1]
            if win is not None:
                inw = (ts >= win[0]) & (ts < win[1])
                v = v & inw[:-1] & inw[1:]
            want = dfg_numpy(src, dst, v, a)
            kernel = "dfg_count" if win is None else "dfg_count_diced"
            ll = last[name]
            check(launched[name] == {kernel: 1}
                  and r.physical.backend == "kernel"
                  and r.physical.fused_dicing == (win is not None)
                  and ll["pairs"] == int(kept.sum()) - 1,
                  f"{name}: launches {launched[name]}, "
                  f"{r.physical.describe()}")
            check(r.value.dtype == np.int64 and r.names == names
                  and np.array_equal(r.value, want),
                  f"{name}: Ψ differs from the host oracle in "
                  f"{int((r.value != want).sum())} cells")
            log(f"  {name}: {int(kept_trace.sum())} traces of {k} variants "
                f"(coverage {tv.coverage(k):.4f}), Ψ total "
                f"{int(want.sum())} == host oracle ({kernel} on the card, "
                f"{ll['pairs']} pairs, {ll['branch']} branch)")

    # 4. relink: drop the other half of the vocabulary, re-link, count
    m = np.isin(act, keep_ids)
    ak, tk, tsk = act[m], trace[m], ts[m]
    for win, name in ((None, "relink.dfg"), (w7, "relink.window(7d).dfg")):
        v = tk[:-1] == tk[1:]
        if win is not None:
            inw = (tsk >= win[0]) & (tsk < win[1])
            v = v & inw[:-1] & inw[1:]
        want = dfg_numpy(ak[:-1], ak[1:], v, a)
        r = res[name]
        kernel = "dfg_count" if win is None else "dfg_count_diced"
        ll = last[name]
        check(launched[name] == {kernel: 1}
              and r.physical.backend == "kernel"
              and ll["pairs"] == int(m.sum()) - 1,
              f"{name}: launches {launched[name]}, {r.physical.describe()}")
        check(np.array_equal(r.value, want),
              f"{name}: Ψ differs from the host oracle in "
              f"{int((r.value != want).sum())} cells")
        log(f"  {name}: {len(keep)} of {a} activities kept, "
            f"{int(m.sum())} events relinked, Ψ total {int(want.sum())} == "
            f"host oracle ({kernel} on the card, {ll['pairs']} pairs, "
            f"{ll['branch']} branch)")

    # 5. top_variants(k50).alignments(): one align_dp launch, its default
    # model discovered on the filtered log
    name = f"top_variants({k50}).alignments"
    r = res[name]
    ali = r.value
    ll = last[name]
    check(launched[name] == {"align_dp": 1}
          and r.physical.backend == "numpy",
          f"{name}: launches {launched[name]}, {r.physical.describe()}")
    filt = variant_filtered_repository(repo, k50)
    ftv = variant_table(filt.event_activity, filt.event_trace,
                        filt.num_traces, names)
    check(ftv.num_variants == k50 and ali.variant_costs.shape == (k50,)
          and ali.trace_cost.shape == (filt.num_traces,),
          f"{name}: {ali.variant_costs.shape} variant costs, "
          f"{ali.trace_cost.shape} traces")
    fsrc, fdst, fvalid = filt.df_pairs()
    starts, ends = filt.trace_boundaries()
    model = discover_dependency_graph(
        dfg_numpy(fsrc, fdst, fvalid, a), names, starts, ends)
    mm, d0, end = alignment_cost_tables(model, names)
    seqs_v, lens = variant_matrix(ftv, names)
    rng = np.random.default_rng(0)
    pick = np.sort(rng.choice(k50, min(4096, k50), replace=False))
    want = finish_variant_costs(
        dp_ops.align_dp(seqs_v[pick], lens[pick], mm, d0, end,
                        backend="numpy"), lens[pick])
    check(np.array_equal(ali.variant_costs[pick], want),
          f"{name}: align_dp differs from the host oracle on the sample in "
          f"{int((ali.variant_costs[pick] != want).sum())} variants")
    fit = q.top_variants(k50).fitness().value
    tlen = np.bincount(filt.event_trace, minlength=filt.num_traces)
    cost = ali.trace_cost
    check(bool((cost >= 0).all()
               and (cost <= tlen + max(ali.empty_cost, 0)).all())
          and np.isfinite(ali.trace_fitness).all()
          and bool(((ali.trace_fitness >= 0)
                    & (ali.trace_fitness <= 1)).all()),
          f"{name}: a cost outside [0, len + empty_cost] or a fitness "
          "outside [0, 1]")
    check(np.array_equal(cost == 0, fit.trace_fitness >= 1.0 - 1e-12),
          f"{name}: perfect traces differ from replay's")
    log(f"  {name}: {cost.shape[0]} traces, {k50} variants ({ll['branch']} "
        f"tier, {ll['events']} ids), fitness {ali.fitness:.6f}, "
        f"{ali.perfectly_fitting} perfect == replay's, costs in "
        f"[0, len + empty_cost]; {pick.shape[0]} sampled variants == host "
        f"align_dp_numpy on a model discovered here, bit for bit")

    # 6. the access-control session, on the shared default engine (the card)
    floor = 50
    sess = AnalystSession(repo, AccessPolicy(min_group_count=floor))
    before = ops.launch_counts["dfg_count_diced"]
    psi, snames = sess.dfg(time_window=w30)
    engine30 = next(r for n, w, r in results if n == "30d").value
    want = np.where(engine30 >= floor, engine30, 0)
    check(ops.launch_counts["dfg_count_diced"] == before + 1,
          "AnalystSession.dfg(time_window) did not launch dfg_count_diced")
    check(snames == names and np.array_equal(psi, want),
          "AnalystSession.dfg differs from the engine's 30-day Ψ after the "
          "floor")
    try:
        sess.events()
        check(False, "AnalystSession.events() returned raw events")
    except AccessDenied:
        pass
    log(f"  AnalystSession(min_group_count={floor}).dfg(30 days): == the "
        f"engine's dfg_count_diced Ψ after the floor "
        f"({int((engine30 > 0).sum())} cells, {int((want > 0).sum())} at or "
        f"above it); events() raises AccessDenied")

    # 7. the host-clock split of the barrier queries
    dev = torch.device("cuda", 0)
    split = {}

    def step(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[key] = time.perf_counter() - t0
        return out

    step("variant table", lambda: trace_variants(repo))
    step("top-k filter (variant table + remap)",
         lambda: variant_filtered_repository(repo, k50))
    step("relink dice", lambda: dice_repository(repo, activities=keep))
    log(f"variant analysis split [{card}] (s; host clock, card "
        "synchronized): " + "  ".join(f"{k} {v:.4f}" for k, v in split.items()))
    for name, r in res.items():
        notes = r.trace.notes
        log(f"  {name}: wall {r.wall_s:.4f}  materialize "
            f"{notes.get('materialize_s', 0.0):.4f}  barrier "
            f"{notes.get('barrier_s', 0.0):.4f}  h2d "
            f"{notes.get('h2d_s', 0.0):.4f}  kernel "
            f"{notes.get('kernel_s', 0.0):.4f}  d2h "
            f"{notes.get('d2h_s', 0.0):.4f}")
    return counts_3d


# ---------------------------------------------------------------------------
# Phase 3e — unions, cross-log compare and delta resume at PAPER_EVAL width
# ---------------------------------------------------------------------------

#: phase 3e's launches, predicted from the code before its first run on the
#: card (PERF.md §6, PR 18): one B1 and one B2 per union branch (queries 1
#: and 2); the repeat-query crossover (GRAPH_REPEAT_CROSSOVER = 3: the DFG,
#: the 30-day DFG, then compare's fitness replay on each branch) builds each
#: branch's graph inside query 4, one B1 + one B3 each; one B4 per branch
#: (query 5, on the graph's event tables); one B1 on the 14.4 M-event
#: concatenation (query 6); one B1 per FromLogs branch (query 7, new
#: fingerprints); the delta queries scan on the host
PREDICTED_3E = {"dfg_count": 7, "dfg_count_diced": 2, "segment_count": 2,
                "align_dp": 2}
PREDICTED_3E_QUERIES = {
    "1 union.dfg": {"dfg_count": 2},
    "2 union.window(30d).dfg": {"dfg_count_diced": 2},
    "3 union.activities.view.dfg": {},
    "4 union.compare": {"dfg_count": 2, "segment_count": 2},
    "5 union.alignments(model)": {"align_dp": 2},
    "6 union.top_variants(k).dfg": {"dfg_count": 1},
    "7 fromlogs.compare": {"dfg_count": 2},
}
#: the split of a query's time that its traces record (branch traces
#: included), in print order
SPLIT_NOTES = ("materialize", "h2d", "kernel", "d2h", "merge", "concat",
               "barrier")


def _trace_split(tr) -> dict:
    """A union's phase seconds: its own trace notes plus its branches'."""
    out = {k: tr.notes.get(f"{k}_s", 0.0) for k in SPLIT_NOTES}
    for _, sub in tr.branches:
        for k, v in _trace_split(sub).items():
            out[k] += v
    return out


def _embed(np, psi, ids, u):
    out = np.zeros((u, u), dtype=np.int64)
    out[np.ix_(ids, ids)] = psi
    return out


def phase_union(torch, mlog, repo, results, model, card, tmp):
    """Unions, compare and the delta path through default engines, at
    PAPER_EVAL width over two deployments — ``prod`` (phase 3's memmap) and
    ``canary`` (a second log from seed 1, materialized, 1 activity in 10
    renamed so the union vocabulary is not the identity) — each answer
    against host oracles written here (tolerance 0).  Returns
    {kernel: launches}."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import PAPER_EVAL
    from repro_torch.conformance import alignment_cost_tables
    from repro_torch.conformance.align import (
        finish_variant_costs,
        variant_matrix,
    )
    from repro_torch.core import (
        ActivityView,
        MemmapLog,
        concat_repositories,
        dfg_numpy,
        discover_dependency_graph,
        pair_mask_for_window,
        replay_fitness,
        variant_table,
    )
    from repro_torch.data import ProcessSpec, generate_memmap_log
    from repro_torch.kernels.align_dp import ops as dp_ops
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops
    from repro_torch.query import (
        Q,
        QueryEngine,
        fingerprint,
        repository_from_memmap,
    )

    t_phase = time.perf_counter()
    cfg = PAPER_EVAL
    a = mlog.num_activities
    t_min = float(mlog.time[0])
    w30 = (t_min, t_min + 30 * DAY)
    kernel_ops = (ops, seg_ops, dp_ops)

    def counts_now():
        out = {}
        for m in kernel_ops:
            out.update(m.launch_counts)
        return out

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- the canary deployment ----------------------------------------------
    t0 = time.perf_counter()
    spec = ProcessSpec(num_activities=a, mean_trace_len=cfg.mean_trace_len,
                       horizon_days=cfg.horizon_days, seed=1)
    clog = generate_memmap_log(os.path.join(tmp, "canary"),
                               mlog.num_events, spec, seed=1)
    canary = repository_from_memmap(clog, "canary")
    renamed = {i: f"new_{i // 10:03d}" for i in range(0, a, 10)}
    canary = dataclasses.replace(canary, activity_names=[
        renamed.get(i, n) for i, n in enumerate(canary.activity_names)
    ])
    names_p, names_c = list(repo.activity_names), list(canary.activity_names)
    union_names = sorted(set(names_p) | set(names_c))
    u = len(union_names)
    uidx = {n: i for i, n in enumerate(union_names)}
    ids_p = np.asarray([uidx[n] for n in names_p])
    ids_c = np.asarray([uidx[n] for n in names_c])
    check(u == a + len(renamed) and not np.array_equal(
        ids_c, np.arange(a)), f"union vocabulary of {u} names")
    log(f"canary: {canary.num_events} events, {canary.num_traces} traces "
        f"(seed 1), {len(renamed)} activities renamed new_000..; union "
        f"vocabulary {u} names; made in {time.perf_counter() - t0:.2f} s "
        "(host)")

    # -- host oracles: per-branch Ψ embedded on the union axis ---------------
    def branch_psi(r, w=None):
        s_, d_, v_ = r.df_pairs()
        if w is not None:
            v_ = v_ & pair_mask_for_window(r, w)
        return dfg_numpy(s_, d_, v_, r.num_activities)

    t0 = time.perf_counter()
    psi_p = results[0][2].value  # == the host oracle (phase 3)
    psi_c = branch_psi(canary)
    want_all = (_embed(np, psi_p, ids_p, u), _embed(np, psi_c, ids_c, u))
    want_30 = (_embed(np, branch_psi(repo, w30), ids_p, u),
               _embed(np, branch_psi(canary, w30), ids_c, u))
    keep = union_names[::2]
    keep_ids = np.asarray([uidx[n] for n in keep])
    mapping = {n: f"g{i % 7}" for i, n in enumerate(union_names) if i % 11}
    view = ActivityView(mapping)
    masked = want_all[0] + want_all[1]
    off = np.ones(u, dtype=bool)
    off[keep_ids] = False
    masked[off, :] = 0
    masked[:, off] = 0
    want_view = view.apply_to_dfg(masked, union_names)
    # the concatenation (the union's canonical repository) and its variants
    ucat = concat_repositories([("prod", repo), ("canary", canary)],
                               activity_vocab=union_names)
    check(ucat.log_names == ["canary", "prod"], "concatenation log names")
    seqs, vcounts = _oracle_variants(np, ucat)
    desc = np.sort(np.asarray(list(vcounts.values()), dtype=np.int64))[::-1]
    cum = np.cumsum(desc)
    least50 = int(np.searchsorted(cum, 0.5 * cum[-1])) + 1
    k50 = _end_of_tie_run(np, desc, least50)
    kept = np.asarray([vcounts[q] >= desc[k50 - 1] for q in seqs])[
        ucat.event_trace]
    s_u, d_u, v_u = ucat.df_pairs()
    want_top = dfg_numpy(s_u, d_u, v_u & kept[:-1] & kept[1:], u)
    log(f"union oracles: Ψ on the {u}-name axis, the {ucat.num_events}-event "
        f"concatenation, {len(vcounts)} exact variants, k50 = {least50} → "
        f"{k50} (end of its tie run, count {int(desc[k50 - 1])}), in "
        f"{time.perf_counter() - t0:.2f} s (host)")

    # -- queries 1-7 on one fresh default engine ------------------------------
    engine = QueryEngine()
    qu = Q.logs((mlog, "prod"), (canary, "canary")).using(engine)
    queries = {
        "1 union.dfg": lambda: qu.dfg(),
        "2 union.window(30d).dfg": lambda: qu.window(*w30).dfg(),
        "3 union.activities.view.dfg":
            lambda: qu.activities(keep).view(view).dfg(),
        "4 union.compare": lambda: qu.compare(),
        "5 union.alignments(model)": lambda: qu.alignments(model),
        f"6 union.top_variants(k).dfg":
            lambda: qu.top_variants(k50).dfg(),
        "7 fromlogs.compare": lambda: Q.logs(
            ucat, names=["prod", "canary"]).using(engine).compare(),
    }
    for m in kernel_ops:
        m.reset_launch_counts()
    res, walls, launched, last = {}, {}, {}, {}
    for name, fn in queries.items():
        before = counts_now()
        res[name], walls[name] = timed(fn)
        after = counts_now()
        launched[name] = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}
        last[name] = dict(ops.last_launch)
    counts_3e = counts_now()
    log(f"union launches: {counts_3e} (predicted {PREDICTED_3E})")
    for name, r in res.items():
        log(f"  {name}: wall {walls[name]:.4f} s, launches {launched[name]}, "
            f"{r.physical.describe()}")
        check(not r.from_cache, f"{name} came from the cache")
    check(launched == PREDICTED_3E_QUERIES,
          f"phase 3e per-query launches {launched} differ from the "
          f"prediction {PREDICTED_3E_QUERIES}")
    check(counts_3e == PREDICTED_3E,
          f"phase 3e launches {counts_3e} differ from the prediction "
          f"{PREDICTED_3E}")

    # 1-3. union Ψ, its 30-day dice, and the merge-side masks
    r1 = res["1 union.dfg"]
    check(r1.physical.backend == "union" and r1.physical.notes == (
        "branch[prod]=kernel", "branch[canary]=kernel"),
        f"union.dfg: {r1.physical.describe()}")
    for name, want in (("1 union.dfg", want_all[0] + want_all[1]),
                       ("2 union.window(30d).dfg", want_30[0] + want_30[1]),
                       ("3 union.activities.view.dfg", want_view)):
        r = res[name]
        check(r.value.dtype == np.int64 and np.array_equal(r.value, want),
              f"{name}: Ψ differs from the host oracle in "
              f"{int((r.value != want).sum()) if r.value.shape == want.shape else -1} cells")
        log(f"  {name}: Ψ total {int(want.sum())} == host oracle "
            f"({len(r.names)} names)")
    check(res["1 union.dfg"].names == union_names
          and res["3 union.activities.view.dfg"].names
          == view.visible_names(union_names), "union names")
    for _, sub in res["3 union.activities.view.dfg"].trace.branches:
        check(sub.from_cache, "a merge-side mask re-ran a branch")

    # 4. compare: per-branch Ψ on the union axis, diffs, replay drift
    cr = res["4 union.compare"].value
    s_p, d_p, v_p = repo.df_pairs()
    m_prod = discover_dependency_graph(
        dfg_numpy(s_p, d_p, v_p, a), names_p, *repo.trace_boundaries())
    fit_p = replay_fitness(repo, m_prod)
    fit_c = replay_fitness(canary, m_prod)
    check(cr.log_names == ("prod", "canary") and cr.names == union_names
          and np.array_equal(cr.psis[0], want_all[0])
          and np.array_equal(cr.psis[1], want_all[1])
          and np.array_equal(cr.diff, want_all[1] - want_all[0])
          and not cr.diffs[0].any(), "compare: Ψ or diffs differ")
    check(cr.fitness == (fit_p.fitness, fit_c.fitness),
          f"compare: fitness {cr.fitness} != host replay "
          f"{(fit_p.fitness, fit_c.fitness)}")
    log(f"  4 union.compare: per-branch Ψ and diff == host oracles; fitness "
        f"against prod's model: prod {cr.fitness[0]:.6f}, canary "
        f"{cr.fitness[1]:.6f} == host replay")

    # 5. alignments(model): one align_dp per branch, concatenated
    ali = res["5 union.alignments(model)"].value
    rng = np.random.default_rng(0)
    v_off, t_off, census = 0, 0, {}
    for bname, r in (("prod", repo), ("canary", canary)):
        bnames = list(r.activity_names)
        tv = variant_table(r.event_activity, r.event_trace, r.num_traces,
                           bnames)
        vc = ali.variant_costs[v_off:v_off + tv.num_variants]
        check(np.array_equal(ali.trace_cost[t_off:t_off + r.num_traces],
                             vc[tv.trace_variant]),
              f"alignments: {bname}'s trace costs are not its variants'")
        mm, d0, end = alignment_cost_tables(model, bnames)
        sv, lens = variant_matrix(tv, bnames)
        pick = np.sort(rng.choice(tv.num_variants,
                                  min(4096, tv.num_variants), replace=False))
        want = finish_variant_costs(
            dp_ops.align_dp(sv[pick], lens[pick], mm, d0, end,
                            backend="numpy"), lens[pick])
        check(np.array_equal(vc[pick], want),
              f"alignments: {bname} differs from the host DP on the sample "
              f"in {int((vc[pick] != want).sum())} variants")
        single = Q.log(mlog if bname == "prod" else canary).using(
            engine).alignments(model)
        check(single.from_cache, f"{bname}'s branch alignment is not cached")
        for e, c in single.value.deviating_edges.items():
            census[e] = census.get(e, 0) + c
        log(f"  5 alignments {bname}: {tv.num_variants} variants, "
            f"{pick.shape[0]} sampled == host align_dp_numpy")
        v_off += tv.num_variants
        t_off += r.num_traces
    check(v_off == ali.variant_costs.shape[0]
          and t_off == ali.trace_cost.shape[0]
          and ali.deviating_edges == census,
          "alignments: the union is not the branches' concatenation / "
          "census sum")
    log(f"  5 union.alignments(model): {t_off} traces, fitness "
        f"{ali.fitness:.6f}, census of {len(census)} edges == the branches' "
        "summed")

    # 6. top_variants(k50) on the concatenation
    r6 = res["6 union.top_variants(k).dfg"]
    check(r6.physical.backend == "concat"
          and last["6 union.top_variants(k).dfg"]["pairs"]
          == int(kept.sum()) - 1
          and r6.names == union_names and np.array_equal(r6.value, want_top),
          f"top_variants({k50}) on the union: {r6.physical.describe()}")
    log(f"  6 union.top_variants({k50}).dfg: {int(kept.sum())} events kept "
        f"of {ucat.num_events}, Ψ total {int(want_top.sum())} == host oracle")

    # 7. FromLogs over the concatenation: the same Ψ and diffs as query 4
    c7 = res["7 fromlogs.compare"].value
    split = ucat.split_logs(["prod", "canary"])
    sp = split["prod"]
    s_s, d_s, v_s = sp.df_pairs()
    m_split = discover_dependency_graph(
        dfg_numpy(s_s, d_s, v_s, u), union_names, *sp.trace_boundaries())
    check(c7.log_names == ("prod", "canary") and c7.names == cr.names
          and all(np.array_equal(x, y) for x, y in
                  zip(c7.psis + c7.diffs, cr.psis + cr.diffs)),
          "FromLogs compare: Ψ or diffs differ from query 4's")
    want7 = tuple(replay_fitness(split[n], m_split).fitness
                  for n in ("prod", "canary"))
    check(c7.fitness == want7,
          f"FromLogs compare: fitness {c7.fitness} != host {want7}")
    log(f"  7 fromlogs.compare: Ψ and diffs == query 4's; fitness "
        f"{c7.fitness} == host replay")
    for name, r in res.items():
        sp_ = _trace_split(r.trace)
        log(f"  split {name}: wall {walls[name]:.4f}  "
            + "  ".join(f"{k} {v:.4f}" for k, v in sp_.items()))

    # -- delta resume on a copy of prod, on a second fresh engine ------------
    # the copy holds prod's rows (phase 3b appended to prod's files after
    # the ``mlog`` view was opened, so the files hold more)
    t0 = time.perf_counter()
    w = MemmapLog.create(os.path.join(tmp, "prod_copy"), mlog.num_events,
                         a, mlog.num_traces, chunk_rows=mlog.chunk_rows)
    w.append(np.asarray(mlog.activity), np.asarray(mlog.case),
             np.asarray(mlog.time))
    cp = w.close()
    check(fingerprint(cp) == fingerprint(mlog),
          "the copy's fingerprint differs from prod's")
    log(f"delta: copied prod's {cp.num_events} rows in "
        f"{time.perf_counter() - t0:.2f} s (host), same fingerprint")
    eng = QueryEngine()
    rows0 = mlog.num_events
    dq = {
        "D1 union.fitness(model)": lambda: Q.logs(
            (cp, "prod"), (canary, "canary")).using(eng).fitness(model),
        "D2 dfg(streaming)": lambda: Q.log(cp).using(eng).dfg(
            backend="streaming"),
        "D3 fitness(model, streaming)": lambda: Q.log(cp).using(eng).fitness(
            model, backend="streaming"),
        "D4 window(30d).dfg(streaming)": lambda: Q.log(cp).using(eng).window(
            *w30).dfg(backend="streaming"),
    }
    dres, dwalls = {}, {}
    before = counts_now()
    for name, fn in dq.items():
        dres[name], dwalls[name] = timed(fn)
    n_app = mlog.num_events // 100
    rng = np.random.default_rng(18)
    last_case = int(np.asarray(mlog.case[-1]))
    open_cases = np.unique(np.asarray(mlog.case[-n_app:]))
    n_new = n_app // 4
    case = np.concatenate([
        rng.choice(open_cases, n_app - n_new),
        mlog.num_traces + rng.integers(0, n_new // 4 + 1, n_new),
    ]).astype(np.int32)
    rng.shuffle(case)
    act = rng.integers(0, a, n_app).astype(np.int32)
    t_last = float(np.asarray(mlog.time[-1]))
    times = t_last + np.sort(rng.uniform(0.0, DAY, n_app))
    t0 = time.perf_counter()
    grown = cp.append(act, case, times)
    log(f"delta: appended {n_app} rows to a copy of prod "
        f"({n_app - n_new} continue {open_cases.shape[0]} open cases, last "
        f"case {last_case}; {n_new} open new ones) in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    stats0 = eng.stats
    dq2 = {
        "D5 dfg(streaming)": lambda: Q.log(grown).using(eng).dfg(
            backend="streaming"),
        "D6 fitness(model, streaming)": lambda: Q.log(grown).using(
            eng).fitness(model, backend="streaming"),
        "D7 window(30d).dfg(streaming)": lambda: Q.log(grown).using(
            eng).window(*w30).dfg(backend="streaming"),
        "D8 union.fitness(model)": lambda: Q.logs(
            (grown, "prod"), (canary, "canary")).using(eng).fitness(model),
    }
    steps = {}
    for name, fn in dq2.items():
        s_before = eng.stats
        dres[name], dwalls[name] = timed(fn)
        s_after = eng.stats
        steps[name] = (s_after.rows_scanned - s_before.rows_scanned,
                       s_after.delta_hits - s_before.delta_hits,
                       s_after.delta_free_hits - s_before.delta_free_hits)
    check(counts_now() == before, "the delta queries launched a kernel")
    for name in ("D5 dfg(streaming)", "D6 fitness(model, streaming)"):
        check(dres[name].physical.backend == "delta"
              and dres[name].physical.delta_rows == (rows0, rows0 + n_app)
              and steps[name] == (n_app, 1, 0),
              f"{name}: {dres[name].physical.describe()}, rows / delta / "
              f"free {steps[name]}")
    check(dres["D7 window(30d).dfg(streaming)"].from_cache
          and steps["D7 window(30d).dfg(streaming)"] == (0, 0, 1),
          f"D7: {steps['D7 window(30d).dfg(streaming)']}")
    d8 = dres["D8 union.fitness(model)"]
    b8 = dict(d8.trace.branches)
    check(steps["D8 union.fitness(model)"] == (n_app, 1, 0)
          and b8["canary"].from_cache
          and b8["prod"].executed_backend == "delta",
          f"D8: {steps['D8 union.fitness(model)']}, branches "
          f"{[(n, t.executed_backend) for n, t in d8.trace.branches]}")
    check(eng.stats.delta_hits - stats0.delta_hits == 3
          and eng.stats.delta_free_hits - stats0.delta_free_hits == 1,
          f"delta counters {eng.stats}")
    # a fresh engine's full scans and the host oracle
    fresh = QueryEngine()
    full_dfg, full_dfg_s = timed(
        lambda: Q.log(grown).using(fresh).dfg(backend="streaming"))
    full_fit, full_fit_s = timed(lambda: Q.log(grown).using(fresh).fitness(
        model, backend="streaming"))
    grepo = repository_from_memmap(grown)
    want_g = branch_psi(grepo)
    fit_g = replay_fitness(grepo, model)
    check(np.array_equal(dres["D5 dfg(streaming)"].value, full_dfg.value)
          and np.array_equal(full_dfg.value, want_g),
          "delta Ψ differs from the fresh full scan or the host oracle")
    f6 = dres["D6 fitness(model, streaming)"].value
    check(np.array_equal(f6.trace_fitness, full_fit.value.trace_fitness)
          and np.array_equal(f6.trace_fitness, fit_g.trace_fitness)
          and f6.fitness == fit_g.fitness
          and f6.deviating_edges == fit_g.deviating_edges,
          "delta fitness differs from the fresh full replay or the host's")
    fit_cm = replay_fitness(canary, model)
    check(np.array_equal(d8.value.trace_fitness, np.concatenate(
        [fit_g.trace_fitness, fit_cm.trace_fitness])),
        "D8: union fitness differs from the host replay of each branch")
    log(f"delta: Ψ total {int(want_g.sum())} and fitness {f6.fitness:.6f} "
        f"== a fresh engine's full scans ({full_dfg_s:.4f} s / "
        f"{full_fit_s:.4f} s) == host oracle")
    for name, r in dres.items():
        log(f"  {name}: wall {dwalls[name]:.4f} s, "
            f"{r.physical.describe()}"
            + (f", rows / delta / free {steps[name]}" if name in steps
               else ""))
    log(f"phase 3e walls [{card}] (s; host clock, card synchronized): "
        + "  ".join(f"{k.split()[0]} {v:.4f}"
                    for k, v in {**walls, **dwalls}.items()))
    total = time.perf_counter() - t_phase
    queried = sum(walls.values()) + sum(dwalls.values()) + full_dfg_s \
        + full_fit_s
    log(f"phase 3e: {total:.1f} s, of which queries {queried:.1f} s and "
        f"inputs + host oracles + checks {total - queried:.1f} s")
    return counts_3e


# ---------------------------------------------------------------------------
# Phase 4 — the CLI
# ---------------------------------------------------------------------------


def phase_cli():
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.launch import mine

    summary = mine.main(
        ["--events", "4000000", "--activities", "32", "--dice-days", "30"]
    )
    check(summary["mode"] == "kernel", f"mine ran on {summary['mode']}")
    check("fused_kernel_dicing" in summary["plan"], "mine did not fuse the dice")
    check(ops.last_launch.get("branch") == "shared",
          f"mine's count took the {ops.last_launch.get('branch')} branch")
    log(f"cli: mode={summary['mode']} branch={ops.last_launch['branch']} "
        f"grid={ops.last_launch['grid']}")


# ---------------------------------------------------------------------------
# Phase 5 — times
# ---------------------------------------------------------------------------


def _launch_ms(torch, fn, reset, flush, iters, warmup, clean=False,
               spin=False, upload=None):
    """Ms of each of ``iters`` launches of ``fn`` between two CUDA events,
    each preceded off the clock by ``reset`` and an L2 flush: the inputs
    come fresh from a host copy, so the caller finds the 50 MB L2 cold.  The
    flush writes 64 MiB, which leaves the L2 full of dirty lines that the
    launch then writes back; ``clean`` flushes by reading them instead.
    The stream is idle when the start event is recorded, so the span holds
    the host's Python and ctypes call as well as the device's work; with
    ``spin`` a ~0.5 ms spin keeps the stream busy while the host records
    the start event and enqueues ``fn``, so the span is the device's work
    alone.  ``upload``, when given, runs after the flush: a host-to-device
    copy of the inputs, as the caller makes right before its launch."""
    out = []
    for i in range(warmup + iters):
        if reset is not None:
            reset()
        if clean:
            flush.view(torch.int64).sum()
        else:
            flush.zero_()
        if upload is not None:
            upload()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            out.append(start.elapsed_time(end))
    return out


def _measure(torch, cases, rounds=5, iters=10, clean=False, spin=False,
             upload=None):
    """Per-launch ms of every case, in ``rounds`` interleaved rounds so a
    drift of the card's clocks spreads over all cases alike.  Returns
    name → (median, first quartile, third quartile, launches)."""
    import numpy as np

    flush = torch.zeros(64 << 20, dtype=torch.int8, device="cuda")
    samples = {name: [] for name in cases}
    for r in range(rounds):
        for name, (fn, reset) in cases.items():
            samples[name] += _launch_ms(
                torch, fn, reset, flush, iters, warmup=3 if r == 0 else 1,
                clean=clean, spin=spin, upload=upload,
            )
    return {
        name: (*np.percentile(v, [50, 25, 75]).tolist(), len(v))
        for name, v in samples.items()
    }


def _back_to_back(torch, cases, launches=50, rounds=5):
    """Device ms per launch of ``launches`` launches of each case issued
    back to back between two CUDA events (the host's Python and ctypes
    call included; no L2 flush between them), and host µs per launch call
    to enqueue them, over ``rounds`` interleaved rounds.  Returns name →
    (median, first quartile, third quartile, rounds, host µs median)."""
    import numpy as np

    samples = {name: ([], []) for name in cases}
    for r in range(rounds + 1):
        for name, (fn, reset) in cases.items():
            reset()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for _ in range(launches):
                fn()
            host = time.perf_counter() - t0
            end.record()
            end.synchronize()
            if r:  # the first round warms up
                samples[name][0].append(start.elapsed_time(end) / launches)
                samples[name][1].append(host / launches * 1e6)
    return {
        name: (*np.percentile(dev, [50, 25, 75]).tolist(), len(dev),
               float(np.median(host)))
        for name, (dev, host) in samples.items()
    }


def _distinct_bytes(*tensors) -> int:
    """Bytes of memory the tensors span, each byte counted once.  On the
    main path src and dst are shifted views of one activity column, and
    ts_src and ts_dst of one timestamp column, so a kernel that reads both
    views needs their shared bytes from memory only once."""
    spans = sorted(
        (t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
        for t in tensors
    )
    total, end = 0, 0
    for lo, hi in spans:
        lo = max(lo, end)
        if hi > lo:
            total += hi - lo
            end = hi
    return total


def phase_times(torch, repo, results, card, graph_counts, conf, resources):
    import numpy as np

    from repro_torch.kernels.align_dp import ops as dp_ops
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops

    a = repo.num_activities
    dev = torch.device("cuda", 0)
    # the columns as the engine uploads them: one activity column and one
    # timestamp column, each read through two shifted views
    _, _, valid = repo.df_pairs()
    act_d = torch.from_numpy(
        np.ascontiguousarray(repo.event_activity, np.int32)).to(dev)
    src_d, dst_d = act_d[:-1], act_d[1:]
    n = int(src_d.shape[0])
    valid_d = torch.from_numpy(valid).to(dev).view(torch.uint8)
    ts_d = torch.from_numpy(repo.event_time).to(dev)
    ts_src, ts_dst = ts_d[:-1], ts_d[1:]
    w = next(w for name, w, _ in results if name == "30d")
    out = torch.zeros((a, a), dtype=torch.int64, device=dev)
    key = src_d.long() * a + dst_d.long()
    in_win = (ts_src >= w[0]) & (ts_src < w[1]) & (ts_dst >= w[0]) & (ts_dst < w[1])
    key_plain = key[valid_d.bool()]
    key_diced = key[valid_d.bool() & in_win]
    # sparse control: the same pairs, valid only in the cells that hold 99%
    # of them (the hash table's occupancy without the long tail)
    psi_all = torch.from_numpy(results[0][2].value).to(dev).reshape(-1)
    by_count = torch.sort(psi_all, descending=True).values
    top = int(torch.searchsorted(torch.cumsum(by_count, 0),
                                 0.99 * float(by_count.sum()))) + 1
    kept = torch.zeros(a * a, dtype=torch.bool, device=dev)
    kept[torch.argsort(psi_all, descending=True)[:top]] = True
    valid_sparse = (valid_d.bool() & kept[key]).view(torch.uint8)
    # contention control: the same E, A and valid, with activities drawn
    # uniformly, so the adds spread over all A² cells instead of the
    # process's few hot ones
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    uni = torch.randint(0, a, (n + 1,), generator=gen, device=dev,
                        dtype=torch.int32)
    # segment_count as the graph build calls it: the E canonical activity
    # ids, S = A segments, no valid column (the reference passes all-ones;
    # timed as well, as the with-valid variant)
    out_s = torch.zeros((a,), dtype=torch.int64, device=dev)
    ones_d = torch.ones(n + 1, dtype=torch.uint8, device=dev)
    ids_masked = act_d[(act_d >= 0) & (act_d < a)].long()
    # hot control: every id the log's most frequent activity, the worst case
    # for same-address shared-memory atomics
    hot_ids = torch.full_like(
        act_d, int(np.argmax(np.bincount(repo.event_activity, minlength=a))))
    # the graph build's call (core/dfg.py:dfg): src, dst and valid uploaded
    # as separate buffers, so 9 B per pair
    src_np, dst_np, _ = repo.df_pairs()
    src_sep = torch.from_numpy(np.ascontiguousarray(src_np, np.int32)).to(dev)
    dst_sep = torch.from_numpy(np.ascontiguousarray(dst_np, np.int32)).to(dev)
    valid_sep = torch.from_numpy(valid).to(dev)
    # the CLI's count (phase 4): its A = 32 log, counted on the dense
    # "shared" branch, plain and with its 30-day window
    from repro_torch.data import ProcessSpec, generate_memmap_log
    from repro_torch.query.execute import repository_from_memmap

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        cli_log = generate_memmap_log(
            os.path.join(tmp, "cli"), 4_000_000,
            ProcessSpec(num_activities=32, seed=7), seed=7)
        cli_repo = repository_from_memmap(cli_log)
        a_cli = cli_repo.num_activities
        t_min = float(cli_log.time[0])
        w_cli = (t_min, t_min + 30 * DAY)
        act_cli = torch.from_numpy(
            np.ascontiguousarray(cli_repo.event_activity, np.int32)).to(dev)
        valid_cli = torch.from_numpy(cli_repo.df_pairs()[2]).to(dev)
        ts_cli = torch.from_numpy(cli_repo.event_time).to(dev)
    out_cli = torch.zeros((a_cli, a_cli), dtype=torch.int64, device=dev)
    cli_args = (act_cli[:-1], act_cli[1:], valid_cli.view(torch.uint8))
    cli_diced = (ts_cli[:-1], ts_cli[1:], w_cli)

    # the kernels against their plain versions on the main path's own
    # inputs, then once more with the hash table's counters
    table_stats = {}
    for name, w_, _ in results:
        if w_ is None:
            got = ops.dfg_count(src_d, dst_d, valid_d, num_activities=a)
            want = ops.dfg_count_plain(src_d, dst_d, valid_d, num_activities=a)
        else:
            args = (src_d, dst_d, valid_d, ts_src, ts_dst, w_)
            got = ops.dfg_count_diced(*args, num_activities=a)
            want = ops.dfg_count_diced_plain(*args, num_activities=a)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"main-path inputs, query {name}: kernel differs from plain")
        check(ops.last_launch["branch"] == "hash"
              and ops.last_launch["columns"] == "shifted",
              f"main-path inputs, query {name}: {ops.last_launch}")
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        out.zero_()
        if w_ is None:
            ops.launch(src_d, dst_d, valid_d, out, a, stats=stats)
        else:
            ops.launch(src_d, dst_d, valid_d, out, a, ts_src, ts_dst, w_, stats)
        torch.cuda.synchronize()
        check(torch.equal(out, want) and stats[0] == 0,
              f"main-path inputs, query {name}: {int(stats[0])} pairs "
              "overflowed the hash table")
        table_stats[name] = stats.tolist()
    log(f"main-path inputs: kernel == plain on all {len(results)} queries, "
        f"hash branch ({ops.HASH_SLOTS} slots, grid "
        f"{ops.last_launch['grid']}x{ops.last_launch['threads']}, shifted "
        f"columns); [overflowed pairs, flush atomics] per query: {table_stats}")
    control_stats = {}
    for cname, args in (("uniform", (uni[:-1], uni[1:], valid_d)),
                        ("sparse", (src_d, dst_d, valid_sparse))):
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        out.zero_()
        ops.launch(*args, out, a, stats=stats)
        torch.cuda.synchronize()
        check(torch.equal(out, ops.dfg_count_plain(*args, num_activities=a)),
              f"{cname} control: kernel differs from plain")
        control_stats[cname] = stats.tolist()
    got = seg_ops.segment_count(act_d, num_segments=a)
    want = seg_ops.segment_count_plain(act_d, num_segments=a)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          "graph-path inputs: segment_count differs from plain")
    seg_launch = dict(seg_ops.last_launch)
    got = ops.dfg_count(src_sep, dst_sep, valid_sep, num_activities=a)
    want = ops.dfg_count_plain(src_sep, dst_sep, valid_sep, num_activities=a)
    torch.cuda.synchronize()
    check(torch.equal(got, want)
          and ops.last_launch["branch"] == "hash"
          and ops.last_launch["columns"] == "separate",
          f"graph-path inputs: dfg_count differs from plain or ran as "
          f"{ops.last_launch}")
    sep_launch = dict(ops.last_launch)
    log("graph-path inputs: segment_count == plain; dfg_count on separate "
        "columns (hash branch) == plain")
    cli_launch = {}
    for name, args in (("dfg_count", cli_args),
                       ("dfg_count_diced", cli_args + cli_diced)):
        if name == "dfg_count":
            got = ops.dfg_count(*args, num_activities=a_cli)
            want = ops.dfg_count_plain(*args, num_activities=a_cli)
        else:
            got = ops.dfg_count_diced(*args, num_activities=a_cli)
            want = ops.dfg_count_diced_plain(*args, num_activities=a_cli)
        torch.cuda.synchronize()
        check(torch.equal(got, want)
              and ops.last_launch["branch"] == "shared"
              and ops.last_launch["columns"] == "shifted",
              f"CLI inputs: {name} differs from plain or ran as "
              f"{ops.last_launch}")
        cli_launch[name] = dict(ops.last_launch)
    log(f"CLI inputs (A={a_cli}, E={int(act_cli.shape[0])}): dfg_count and "
        "dfg_count_diced (shared branch, shifted columns) == plain")

    cases = {
        ("dfg_count", "ms"): (
            lambda: ops.launch(src_d, dst_d, valid_d, out, a), out.zero_),
        ("dfg_count", "plain_ms"): (lambda: ops.dfg_count_plain(
            src_d, dst_d, valid_d, num_activities=a), None),
        ("dfg_count", "library_ms"): (lambda: torch.bincount(
            key_plain, minlength=a * a), None),
        ("dfg_count", "uniform_ms"): (
            lambda: ops.launch(uni[:-1], uni[1:], valid_d, out, a), out.zero_),
        ("dfg_count", "sparse_ms"): (
            lambda: ops.launch(src_d, dst_d, valid_sparse, out, a), out.zero_),
        ("dfg_count", "separate_ms"): (lambda: ops.launch(
            src_sep, dst_sep, valid_sep.view(torch.uint8), out, a), out.zero_),
        ("dfg_count", "cli_ms"): (
            lambda: ops.launch(*cli_args, out_cli, a_cli), out_cli.zero_),
        ("dfg_count_diced", "cli_ms"): (lambda: ops.launch(
            *cli_args, out_cli, a_cli, *cli_diced), out_cli.zero_),
        ("dfg_count_diced", "ms"): (lambda: ops.launch(
            src_d, dst_d, valid_d, out, a, ts_src, ts_dst, w), out.zero_),
        ("dfg_count_diced", "plain_ms"): (lambda: ops.dfg_count_diced_plain(
            src_d, dst_d, valid_d, ts_src, ts_dst, w, num_activities=a), None),
        ("dfg_count_diced", "library_ms"): (lambda: torch.bincount(
            key_diced, minlength=a * a), None),
        ("segment_count", "ms"): (
            lambda: seg_ops.launch(act_d, None, out_s, a), out_s.zero_),
        ("segment_count", "plain_ms"): (lambda: seg_ops.segment_count_plain(
            act_d, num_segments=a), None),
        ("segment_count", "library_ms"): (lambda: torch.bincount(
            ids_masked, minlength=a), None),
        ("segment_count", "valid_ms"): (
            lambda: seg_ops.launch(act_d, ones_d, out_s, a), out_s.zero_),
        ("segment_count", "uniform_ms"): (
            lambda: seg_ops.launch(uni, None, out_s, a), out_s.zero_),
        ("segment_count", "hot_ms"): (
            lambda: seg_ops.launch(hot_ids, None, out_s, a), out_s.zero_),
    }
    measured = _measure(torch, cases)
    measured.update(_measure(torch, {
        ("dfg_count", "clean_ms"): cases[("dfg_count", "ms")],
        ("dfg_count_diced", "clean_ms"): cases[("dfg_count_diced", "ms")],
    }, clean=True))
    # the same launches with the host's call off the clock
    spun = {
        (name, "device_ms"): cases[(name, "ms")]
        for name in ("dfg_count", "dfg_count_diced", "segment_count")
    }
    spun.update({
        ("segment_count", f"{k}_device_ms"): cases[("segment_count", f"{k}_ms")]
        for k in ("valid", "uniform", "hot")
    })
    spun.update({
        # the yardstick of one read of the same 28.8 MB in one launch; the
        # port never calls it
        ("segment_count", "read_device_ms"): (
            lambda: torch.sum(act_d, dtype=torch.int64), None),
        ("segment_count", "read_max_device_ms"): (
            lambda: torch.amax(act_d), None),
        ("dfg_count", "separate_device_ms"): cases[("dfg_count", "separate_ms")],
        ("dfg_count", "cli_device_ms"): cases[("dfg_count", "cli_ms")],
        ("dfg_count_diced", "cli_device_ms"):
            cases[("dfg_count_diced", "cli_ms")],
    })
    measured.update(_measure(torch, spun, spin=True))
    # the graph build's order (graph/build.py:_node_counts): the ids copied
    # from the host, then the count
    act_up = torch.empty_like(act_d)
    act_pinned = act_d.cpu().pin_memory()
    measured.update(_measure(torch, {
        ("segment_count", "h2d_device_ms"): (
            lambda: seg_ops.launch(act_up, None, out_s, a), out_s.zero_),
    }, spin=True, upload=lambda: act_up.copy_(act_pinned)))
    # the same with the L2 flushed by a read, so the launch writes back no
    # dirty line of the flush
    measured.update(_measure(torch, {
        ("segment_count", "clean_device_ms"): cases[("segment_count", "ms")],
        ("segment_count", "read_max_clean_device_ms"):
            spun[("segment_count", "read_max_device_ms")],
    }, clean=True, spin=True))
    back = _back_to_back(torch, {
        "dfg_count": (lambda: ops.launch(src_d, dst_d, valid_d, out, a),
                      out.zero_),
        "dfg_count_diced": (lambda: ops.launch(
            src_d, dst_d, valid_d, out, a, ts_src, ts_dst, w), out.zero_),
    })
    # align_dp on the default-model alignment query's own ragged inputs; the
    # longest-first work order measured beside it: the lengths sorted on the
    # card (timed), then the kernel on a copy of the ragged input stored
    # longest first, whose costs are the same variants' in that order; its
    # plain version takes ~10^5 times longer, so fewer rounds
    dp_in = conf["inputs"]
    v_n = int(dp_in[1].shape[0]) - 1
    dp_out = torch.empty((v_n,), dtype=torch.float32, device=dev)
    lens_d = dp_in[1][1:] - dp_in[1][:-1]

    def longest_first():
        return torch.argsort(lens_d, descending=True, stable=True)

    perm = longest_first()
    off_p = torch.zeros_like(dp_in[1])
    torch.cumsum(lens_d[perm], 0, out=off_p[1:])
    at = (torch.repeat_interleave(dp_in[1][:-1][perm] - off_p[:-1],
                                  lens_d[perm])
          + torch.arange(int(off_p[-1]), device=dev))
    by_len = (dp_in[0][at].contiguous(), off_p, *dp_in[2:])
    got = dp_ops.align_dp_device(*by_len)
    check(torch.equal(got, dp_ops.align_dp_device(*dp_in)[perm]),
          "align_dp on the longest-first input differs")
    # locality control: the same offsets and tables with every id one
    # activity (one Mt row, resident in L1) and with ids drawn uniformly
    # (the least reuse), so the row reads' share of the time shows
    one_row = (torch.zeros_like(dp_in[0]), *dp_in[1:])
    uniform = (torch.randint(0, int(dp_in[2].shape[0]), dp_in[0].shape,
                             generator=gen, device=dev, dtype=torch.int32),
               *dp_in[1:])
    measured.update(_measure(torch, {
        ("align_dp", "ms"): (lambda: dp_ops.launch(*dp_in, dp_out), None),
        ("align_dp", "longest_first_ms"): (
            lambda: dp_ops.launch(*by_len, dp_out), None),
        ("align_dp", "sort_ms"): (longest_first, None),
        ("align_dp", "one_row_ms"): (
            lambda: dp_ops.launch(*one_row, dp_out), None),
        ("align_dp", "uniform_ms"): (
            lambda: dp_ops.launch(*uniform, dp_out), None),
    }))
    measured.update(_measure(torch, {
        ("align_dp", "device_ms"): (lambda: dp_ops.launch(*dp_in, dp_out), None),
    }, spin=True))
    measured.update(_measure(torch, {
        ("align_dp", "plain_ms"): (lambda: dp_ops.align_dp_plain(*dp_in), None),
    }, rounds=2, iters=3))
    dp_ops.launch(*dp_in, dp_out)
    check(dp_ops.last_launch["branch"] == "registers",
          f"align_dp took the {dp_ops.last_launch['branch']} tier")
    dp_launch = dict(dp_ops.last_launch)
    clocks = run_cmd([
        "nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
        "temperature.gpu", "--format=csv,noheader", "-i", "0",
    ])
    check(ops.last_launch["branch"] == "hash",
          f"A={a} took the {ops.last_launch['branch']} branch")
    check(seg_ops.last_launch["branch"] == "shared",
          f"S={a} took the {seg_ops.last_launch['branch']} branch")
    read = {
        "dfg_count": _distinct_bytes(src_d, dst_d, valid_d),
        "dfg_count_diced": _distinct_bytes(src_d, dst_d, valid_d, ts_src, ts_dst),
    }
    bound = {
        name: (b + 8 * a * a) / HBM_BYTES_PER_S * 1e3 for name, b in read.items()
    }
    sep_bound = ((_distinct_bytes(src_sep, dst_sep, valid_sep) + 8 * a * a)
                 / HBM_BYTES_PER_S * 1e3)
    cli_bound = {
        "dfg_count": _distinct_bytes(*cli_args),
        "dfg_count_diced": _distinct_bytes(*cli_args, *cli_diced[:2]),
    }
    cli_bound = {
        name: (b + 8 * a_cli * a_cli) / HBM_BYTES_PER_S * 1e3
        for name, b in cli_bound.items()
    }
    e = int(act_d.shape[0])
    seg_read = _distinct_bytes(act_d)
    bound["segment_count"] = (seg_read + 8 * a) / HBM_BYTES_PER_S * 1e3
    seg_valid_bound = (
        (_distinct_bytes(act_d, ones_d) + 8 * a) / HBM_BYTES_PER_S * 1e3
    )
    log(f"bytes bound: inputs read once, {read['dfg_count'] / n:.4f} B/pair "
        f"plain and {read['dfg_count_diced'] / n:.4f} B/pair diced, "
        f"+ {8 * a * a} B of int64 output; segment_count "
        f"{seg_read / e:.4f} B/id (+1 with valid) + {8 * a} B of int64 "
        f"output; at {HBM_BYTES_PER_S:.3g} B/s")
    # align_dp: per active (variant, layer, state) two f32 adds and one min
    # (d + Mt and its min into the sync, d + 1), then one add and one min
    # per (variant, state) for the end; the select form's count (two mins
    # per state, the bound's earlier definition) is printed beside it; the
    # bytes: ids, offsets, Mt, d0 and end read once, out written once
    ids_d, off_d, mt_d, d0_d, end_d = dp_in
    s_n = int(mt_d.shape[1])
    sum_len = int(ids_d.shape[0])
    check(sum_len == int(conf["lens"].sum()), "sum(len) differs")
    dp_adds = 2 * s_n * sum_len + s_n * v_n
    dp_mins = s_n * sum_len + s_n * v_n
    dp_ops_n = dp_adds + dp_mins
    dp_select_ms = 2 * dp_adds / FP32_OPS_PER_S * 1e3
    dp_bytes = (4 * sum_len + 8 * (v_n + 1) + mt_d.numel() * 4 + 8 * s_n
                + 4 * v_n)
    dp_ops_ms = dp_ops_n / FP32_OPS_PER_S * 1e3
    dp_bytes_ms = dp_bytes / HBM_BYTES_PER_S * 1e3
    bound["align_dp"] = max(dp_ops_ms, dp_bytes_ms)
    check(dp_ops_ms >= dp_bytes_ms, "align_dp is bound by bytes, not operations")
    try:
        sm_mhz = float(clocks.split(",")[0].split()[0])
    except ValueError:
        raise SmokeFailure(f"cannot read the SM clock from {clocks!r}")
    # an add or a min is one instruction, 128 a clock per SM (the 67e12
    # peak counts an FMA as two), and the same with mins at half the add
    # rate (64 a clock per SM)
    dp_issue_ms = dp_ops_n / (H100_SMS * FP32_LANES_PER_SM * sm_mhz * 1e6) * 1e3
    dp_half_ms = ((dp_adds / FP32_LANES_PER_SM + dp_mins / MIN_LANES_PER_SM)
                  / (H100_SMS * sm_mhz * 1e6) * 1e3)
    times = {name: {"bound_ms": b} for name, b in bound.items()}
    for (name, key), (med, q1, q3, count) in measured.items():
        times[name][key] = med
        times[name][key + "_iqr"] = (q1, q3, count)
    times["align_dp"]["library_ms"] = None

    def fmt_ms(t, key):
        q1, q3, count = t[key + "_iqr"]
        return f"{t[key]:.4f} ms ({q1:.4f}-{q3:.4f}, {count})"

    log(f"times [{card}] (median ms of per-launch CUDA-event times, "
        f"interquartile range, launches; clocks right after: {clocks}); "
        "'kernel' spans the host's call and the launch, 'device' the launch "
        "alone, enqueued behind a spin")
    for name in ("dfg_count", "dfg_count_diced"):
        t = times[name]
        med, q1, q3, rounds, host_us = back[name]
        log(f"  {name} E={n} A={a} ({ops.last_launch['branch']} branch, "
            f"{ops.last_launch['table_slots']} slots, "
            f"{ops.last_launch['columns']} columns, grid "
            f"{ops.last_launch['grid']}x{ops.last_launch['threads']}): kernel "
            f"{fmt_ms(t, 'ms')}, device {fmt_ms(t, 'device_ms')} "
            f"({t['bound_ms'] / t['device_ms'] * 100:.1f}% of the bound), "
            f"plain {fmt_ms(t, 'plain_ms')}, torch.bincount on pre-masked "
            f"keys {fmt_ms(t, 'library_ms')} (leaves out the mask and the key build), "
            f"bytes bound {t['bound_ms']:.4f} ms "
            f"({t['bound_ms'] / t['ms'] * 100:.1f}% of the bound); with "
            f"the L2 flushed by a read, so no dirty line is left to write "
            f"back, {fmt_ms(t, 'clean_ms')} "
            f"({t['bound_ms'] / t['clean_ms'] * 100:.1f}%); 50 "
            f"back-to-back ops.launch calls {med:.4f} ms per launch "
            f"({q1:.4f}-{q3:.4f}, {rounds} rounds; no L2 flush), the host "
            f"enqueueing each in {host_us:.1f} us")
        cl = cli_launch[name]
        log(f"  {name} on the CLI's inputs E={int(act_cli.shape[0]) - 1} "
            f"A={a_cli} ({cl['branch']} branch, {cl['columns']} columns, grid "
            f"{cl['grid']}x{cl['threads']}): kernel {fmt_ms(t, 'cli_ms')}, "
            f"device {fmt_ms(t, 'cli_device_ms')}, bytes bound "
            f"{cli_bound[name]:.4f} ms "
            f"({cli_bound[name] / t['cli_device_ms'] * 100:.1f}% of the "
            "bound, device)")
    t = times["dfg_count"]
    log(f"  dfg_count on the graph build's separate columns E={n} A={a} "
        f"({sep_launch['branch']} branch, {sep_launch['columns']} columns, "
        f"grid {sep_launch['grid']}x{sep_launch['threads']}; src, dst, valid "
        f"9 B/pair): kernel {fmt_ms(t, 'separate_ms')}, device "
        f"{fmt_ms(t, 'separate_device_ms')}, bytes bound {sep_bound:.4f} ms "
        f"({sep_bound / t['separate_device_ms'] * 100:.1f}% of the bound, "
        "device)")
    t = times["segment_count"]
    sl = seg_launch
    flush_bound = t["flush_bound"] = sl["flush_bound"]
    check(sl["branch"] == "shared" and _segment_launch_ok(torch, sl),
          f"segment_count on the graph build's ids: launch {sl}")
    log(f"  segment_count E={e} S={a} ({sl['branch']} branch, grid "
        f"{sl['grid']}x{sl['threads']}, {sl['blocks_per_sm']} per SM, "
        f"{sl['smem_bytes']} B smem, flush <= grid x S = {flush_bound} "
        f"global atomics; "
        f"{graph_counts['segment_count']} launch per graph build): kernel "
        f"{fmt_ms(t, 'ms')} without valid (device {fmt_ms(t, 'device_ms')}), "
        f"{fmt_ms(t, 'valid_ms')} with an all-ones valid (device "
        f"{fmt_ms(t, 'valid_device_ms')}); plain {fmt_ms(t, 'plain_ms')}, "
        f"torch.bincount on pre-masked ids {fmt_ms(t, 'library_ms')}; bytes "
        f"bound {t['bound_ms']:.4f} ms without valid "
        f"({t['bound_ms'] / t['ms'] * 100:.1f}% of the bound, device "
        f"{t['bound_ms'] / t['device_ms'] * 100:.1f}%), {seg_valid_bound:.4f} "
        f"ms with valid ({seg_valid_bound / t['valid_ms'] * 100:.1f}%, device "
        f"{seg_valid_bound / t['valid_device_ms'] * 100:.1f}%)")
    hot = np.sort(np.bincount(repo.event_activity, minlength=a))[::-1]
    log(f"load and contention controls [{card}] (device): segment_count on "
        f"the graph's ids {fmt_ms(t, 'device_ms')}; torch.sum of the same "
        f"{seg_read} B in one launch {fmt_ms(t, 'read_device_ms')} "
        f"({seg_read / t['read_device_ms'] / 1e9:.3f} TB/s), torch.amax of "
        f"them {fmt_ms(t, 'read_max_device_ms')} "
        f"({seg_read / t['read_max_device_ms'] / 1e9:.3f} TB/s; the kernel "
        f"{seg_read / t['device_ms'] / 1e9:.3f} TB/s); with the L2 flushed "
        f"by a read (no dirty line to write back) the kernel "
        f"{fmt_ms(t, 'clean_device_ms')} "
        f"({t['bound_ms'] / t['clean_device_ms'] * 100:.1f}% of the bound), "
        f"torch.amax {fmt_ms(t, 'read_max_clean_device_ms')}; right after "
        f"a host-to-device copy of the ids, as the graph build calls it, "
        f"{fmt_ms(t, 'h2d_device_ms')} "
        f"({t['bound_ms'] / t['h2d_device_ms'] * 100:.1f}%); uniform ids (same E, "
        f"S) {fmt_ms(t, 'uniform_device_ms')}; every id activity "
        f"{int(hot_ids[0])} {fmt_ms(t, 'hot_device_ms')}. By 'kernel' "
        f"(host's call included): uniform {fmt_ms(t, 'uniform_ms')}, hot "
        f"{fmt_ms(t, 'hot_ms')}. The 10 most frequent of the {a} activities "
        f"hold {hot[:10].sum() / hot.sum() * 100:.1f}% of the events, the "
        f"most frequent {hot[0] / hot.sum() * 100:.1f}%.")
    psi = results[0][2].value
    hot = np.cumsum(np.sort(psi.ravel())[::-1])
    top90 = int(np.searchsorted(hot, 0.9 * hot[-1]) + 1)
    log(f"contention control [{card}]: dfg_count on the main path's pairs "
        f"{fmt_ms(times['dfg_count'], 'ms')} (hash table [overflowed pairs, "
        f"flush atomics] {table_stats['all']}); on uniform activities (same "
        f"E, A, valid) {fmt_ms(times['dfg_count'], 'uniform_ms')} "
        f"({control_stats['uniform']}: the tables fill and the rest "
        f"overflows into global atomics); sparse, valid only in the {top} "
        f"cells that hold 99% of the pairs, "
        f"{fmt_ms(times['dfg_count'], 'sparse_ms')} "
        f"({control_stats['sparse']}). The main path's Ψ has "
        f"{int((psi > 0).sum())} nonzero cells of {a * a}; {top90} of them "
        f"hold 90% of the pairs, a block's table of {ops.HASH_SLOTS} slots "
        f"holds at most {int((psi > 0).sum()) / ops.HASH_SLOTS * 100:.1f}% "
        f"load.")
    t = times["align_dp"]
    ll = dp_launch
    lens = conf["lens"]
    log(f"  align_dp V={v_n} L={int(lens.max())} S={s_n} "
        f"A={int(mt_d.shape[0])} sum(len)={sum_len}, ragged ({ll['branch']} "
        f"tier, K={ll['k']}, grid {ll['grid']}x{ll['threads']}, "
        f"{ll['smem_bytes']} B smem; one launch per alignments() query): "
        f"kernel {fmt_ms(t, 'ms')} (device {fmt_ms(t, 'device_ms')}), plain "
        f"{fmt_ms(t, 'plain_ms')}, no single PyTorch call computes this DP "
        f"(library_ms null); operations bound {dp_ops_n:.4g} f32 ops (two "
        f"adds and one min per state) at {FP32_OPS_PER_S:.3g}/s = "
        f"{dp_ops_ms:.4f} ms ({dp_ops_ms / t['ms'] * 100:.1f}% of the bound; "
        f"the select form's count, two mins per state, {2 * dp_adds:.4g} ops = "
        f"{dp_select_ms:.4f} ms, {dp_select_ms / t['ms'] * 100:.1f}%), "
        f"issue bound at the "
        f"sampled {sm_mhz:.0f} MHz SM clock (add and min one per lane per "
        f"clock) {dp_issue_ms:.4f} ms ({dp_issue_ms / t['ms'] * 100:.1f}%), "
        f"with mins at half rate {dp_half_ms:.4f} ms "
        f"({dp_half_ms / t['ms'] * 100:.1f}%), bytes bound "
        f"{dp_bytes / 1e6:.2f} MB = {dp_bytes_ms:.4f} ms")
    log(f"  align_dp work order [{card}]: input order (the kernel's) "
        f"{fmt_ms(t, 'ms')}; longest first: kernel on the input stored "
        f"longest first {fmt_ms(t, 'longest_first_ms')} + torch.argsort of "
        f"the lengths {fmt_ms(t, 'sort_ms')} = "
        f"{t['longest_first_ms'] + t['sort_ms']:.4f} ms")
    log(f"locality control [{card}]: align_dp on the main path's ids "
        f"{fmt_ms(t, 'ms')}; every id one activity (one Mt row, L1-resident) "
        f"{fmt_ms(t, 'one_row_ms')}; uniform ids (same offsets) "
        f"{fmt_ms(t, 'uniform_ms')}. Each variant-layer reads a "
        f"{4 * s_n} B Mt row; {sum_len} of them read "
        f"{4 * s_n * sum_len / 1e9:.2f} GB from L1 / L2.")
    log("  align_dp instances (nvcc -Xptxas -v: registers, spill stores / "
        "loads in bytes): " + "; ".join(
            f"{k} {r} regs {st}/{ld}" for k, (r, st, ld) in resources.items()))
    log(f"end-to-end split [{card}] (s; host clock, card synchronized):")
    for name, _, res in results:
        notes = res.trace.notes
        log(f"  {name:>4}: wall {res.wall_s:.4f}  materialize "
            f"{notes.get('materialize_s', 0.0):.4f}  h2d "
            f"{notes.get('h2d_s', 0.0):.4f}  kernel "
            f"{notes.get('kernel_s', 0.0):.4f}  d2h "
            f"{notes.get('d2h_s', 0.0):.4f}")
    split = conf["split"]
    log(f"  default-model alignments(), step by step: "
        + "  ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"  (sum {sum(split.values()):.4f}; the query's own wall "
        f"{conf['results']['alignments'].wall_s:.4f}); the padded route "
        "instead of checks + h2d: "
        + "  ".join(f"{k} {v:.4f}" for k, v in conf["padded"].items())
        + f" (sum {sum(conf['padded'].values()):.4f})")
    for name, r in conf["results"].items():
        log(f"  {name}: wall {r.wall_s:.4f}")
    return times


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    src_dir = os.path.join(root, "src")
    if not os.path.isdir(os.path.join(src_dir, "repro_torch")):
        print(f"chip_smoke: {src_dir}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, src_dir)
    from repro_torch.kernels import build
    from repro_torch.kernels.align_dp import ops as dp_ops
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops

    t_start = time.perf_counter()
    try:
        log("== phase 1: environment")
        card = phase_environment(torch, build)
        resources = _align_dp_resources(build, dp_ops)
        log("align_dp instances (registers, spill stores / loads): "
            + "; ".join(f"{k} {r} {st}/{ld}" for k, (r, st, ld)
                        in resources.items()))
        log("segment_count instances (registers, spill stores / loads): "
            + "; ".join(f"{k} {r} {st}/{ld}" for k, (r, st, ld)
                        in _segment_count_resources(build).items()))
        log("== phase 2: kernels against their plain versions")
        worst = phase_sweep(torch, ops)
        worst["segment_count"] = phase_segment_sweep(torch, seg_ops)
        worst["align_dp"] = phase_align_sweep(torch, dp_ops)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            log("== phase 3: main path at PAPER_EVAL width")
            counts, results, repo, mlog, model = phase_main_path(torch, tmp)
            log("== phase 3b: graph tier at PAPER_EVAL width")
            graph_counts = phase_graph(torch, mlog, repo, results, tmp)
            log("== phase 3c: conformance at PAPER_EVAL width")
            conf_counts, conf = phase_conformance(torch, mlog, repo, model)
            log("== phase 3d: variant analysis at PAPER_EVAL width")
            var_counts = phase_variants(torch, mlog, repo, results, card)
            log("== phase 3e: unions, compare and delta resume at "
                "PAPER_EVAL width")
            union_counts = phase_union(torch, mlog, repo, results, model,
                                       card, tmp)
        by_phase = {"3": dict(counts), "3b": graph_counts, "3c": conf_counts,
                    "3d": var_counts, "3e": union_counts}
        counts["segment_count"] = graph_counts["segment_count"]
        counts["align_dp"] = conf_counts["align_dp"]
        log("== phase 4: mining CLI")
        phase_cli()
        log("== phase 5: times")
        times = phase_times(torch, repo, results, card, graph_counts, conf,
                            resources)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": counts[name],
            "launches_by_phase": {p: c.get(name, 0)
                                  for p, c in by_phase.items()},
            "max_abs_err": worst[name],
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound_ms"],
            "bound_by": BOUND_BY[name],
            "library_ms": times[name]["library_ms"],
            "device_ms": times[name]["device_ms"],
            **({"read_device_ms": times[name]["read_device_ms"],
                "hot_ms": times[name]["hot_ms"],
                "hot_device_ms": times[name]["hot_device_ms"],
                "flush_bound": times[name]["flush_bound"]}
               if name == "segment_count" else {}),
        }
        for name in KERNELS
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
