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
   registers, shared and global tiers, and each register instance); every
   one of those launches' configurations (``last_launch``) with its
   build's ptxas resources through the Hopper launch checker
   (``repro_torch.analysis.kernels_check``; a hard finding is fatal), and
   its launch report at the main path's shapes (resident blocks per SM
   and the limit that sets them);
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
3e. unions, cross-log compare and delta resume at the same width (two
   deployments), each answer against host oracles, launch counts against
   ``PREDICTED_3E``;
3f. the case-sharded graph tier and the distributed DFG at the same width:
   phase 3's log partitioned into 4 case shards (``case % 4``); on a fresh
   default engine the sharded DFG (one ``dfg_count`` + one
   ``segment_count`` per shard graph build), histogram, 30-day DFG, process
   map and neighborhood against the single log's host oracles; an append of
   72,000 rows on the cases of one residue that rescans only the owning
   shard; an engine with a mesh of the card (``distributed``: one
   ``dfg_count`` per mesh position) and ``distributed_dfg`` with
   hierarchical and flat reductions; two gloo ranks spawned on the card,
   each counting half of the pairs with ``dfg_count``, one (A, A) int64
   all-reduce per mesh axis, and the mesh merge of the 4 shard Ψ; launch
   counts against ``PREDICTED_3F``;
3g. the query service at the same width: one ``QueryService`` on a default
   engine of the card with a ``TraceStore``, serving ``prod`` (phase 3's
   log under a k-anonymity floor of 5), ``canary`` (phase 3e) and phase
   3f's sharded log: DFGs, a 30-day dice, process maps, a neighborhood,
   fitness, alignments, a union DFG and compare, the metrics, forensics
   and SLO sinks, and appends of 72,000 rows to a copy of ``prod`` and to
   the sharded log, each payload against the host oracle (floored) and the
   direct engine result, each probe against what ran, launches against
   ``PREDICTED_3G``; the trace store mined back, ``planner_drift_total``
   and the tracing overhead (warm dices on a trace-on and a trace-off
   engine);
3h. the HTTP transport at the same width: a ``TransportServer`` on
   127.0.0.1:0 (its event loop in a thread of this process) over one
   ``QueryService`` on a fresh default engine of the card with a trace
   store, ``prod`` under a floor of 5 and a copy of it for appends; a
   client in this process sends a burst of 32 identical cold DFGs (one
   execution), a cache hit, a 30-day dice, three process maps (the graph
   build), streamed alignments (NDJSON), an append of 72,000 rows and the
   DFG that resumes over them, a tenant over its quota, four concurrent
   dices, a cold lane of depth 1 held busy (a second cold request shed)
   while the hot lane serves cache hits, the metrics / SLO / health /
   readiness endpoints and an inbound traceparent; each payload against
   the host oracle (floored) and the direct service answer, launches and
   lanes against ``PREDICTED_3H``; with the wire's walls, the Ψ body's
   JSON cost, the stream's lines and the hot lane's p50 / p99;
3i. the LM serving path: gemma2-9b at its published width and depth (42
   layers, d_model 3,584, vocab 256,000; 9,241,705,984 parameters) built on
   the card from a seeded generator and served by ``ServeEngine``
   (``max_batch`` 4, ``max_cache`` 1,024, ``q_chunk`` 64; its matrices
   cast to bf16 once): 8 greedy requests of 16-512 prompt tokens
   (``numpy.random.default_rng(0)``), 32 new tokens each, in two waves,
   served twice with identical tokens; decode logits against the last
   position of a prefill over prompt + token with the full-width weights
   computed in f32 (the reference's rtol = atol = 2e-2) and in the served
   bf16 (the same argmax; its difference printed beside bf16's own
   distance from f32); four decode steps under ``torch.profiler`` (the
   device's busy share, kernels per step); every other arch
   ``.reduced()`` in f32 on the card against the same weights on the host
   (atol = rtol = 1e-4, the CPU tests'); the
   engine's telemetry mined on the default engine as it is and on one with
   ``tiny_pairs=0`` (one ``dfg_count`` for ``mine_telemetry()``, one
   ``dfg_count_diced`` for ``mine_telemetry(time_window=...)``), each Ψ
   against a count of the collector's events; ``repro_torch.launch.serve
   --arch gemma2-9b --requests 6``; with init seconds, weight bytes, peak
   device memory, each wave's prefill seconds, the median decode step
   beside its bytes bound, tokens/s, and the logits product both ways;
3j. the LM training path: ``repro_torch.launch.train`` in-process on
   starcoder2-3b at its published width and depth (30 layers, d_model
   3,072, vocab 49,152; 3,029,523,456 parameters), ``--preset full
   --steps 8 --batch 2 --seq 4096 --lr 3e-4 --mine`` (``train_4k``'s
   sequence length, one card's batch of 2; f32 master weights, bf16
   compute, ``remat`` full, no checkpoint: one would write 36.4 GB): every
   loss finite, the first within 0.5 of ln V + d_model · 0.02² / 2, the
   last below the first; the median step beside its FLOP bound (bf16 peak)
   and AdamW's bytes, the peak device memory; step 0's loss and gradients
   of a fresh init in bf16 and f32 compute (within 2e-2 relative, the grad
   norms printed) and the bf16 one under ``torch.profiler`` (busy share,
   device time by class of kernel, top kernels); ``matmul_f32``'s hand-written gradient on the card
   against the host's products; every arch ``.reduced()`` in f32, loss,
   gradients and 3 ``Trainer`` steps on the card against the host (atol =
   rtol = 1e-4); ``remat`` none, full and dots bit for bit on the card
   (bf16); the golden restart on the card (crash at 7, restore 5, bit for
   bit); the trainer's telemetry mined: ``--mine`` (one
   ``dfg_count``) and a windowed DFG on a ``tiny_pairs=0`` engine (one
   ``dfg_count_diced``), each Ψ against a count of the collector's events,
   launches against ``PREDICTED_3J``;
3k. the sharded LM path (``repro_torch.launch.steps``) on a 1 × 1
   ``DeviceMesh`` of a world-1 NCCL process group: olmoe-1b-7b at its
   published width (d_model 2,048, 64 experts top-8, vocab 50,304), its
   depth cut to 4 of 16 layers for training (1,884,310,528 parameters: the
   step's f32 parameters, μ, ν and gradient sum need ~138 GB at 16), 3
   ``make_train_step`` steps of ``train_4k``'s 4,096 tokens × one card's
   batch of 2 in the config's 2 microbatches with ``DistCtx`` on
   (``_moe_sharded``); every loss finite, the first within 0.5 of
   ln V + d_model · 0.02² / 2; step 0 against ``train_loss`` per
   microbatch, their mean and ``adamw_update`` composed by hand, bit for
   bit under ``torch.use_deterministic_algorithms(True)``; the median step
   beside ``model_flops`` over the bf16 peak and AdamW's bytes, the peak
   device memory; at full depth (6,919,100,416 parameters, f32)
   ``make_prefill_step`` of 32,760 tokens into a 32,768-position cache and
   8 ``make_decode_step`` steps, the prefill logits and the first decode
   logits equal ``prefill`` / ``decode_step`` with ``dist=None`` bit for
   bit; the dry run (``python -m repro_torch.launch.dryrun``) of olmoe ×
   ``train_4k`` × 16x16, whisper-tiny × ``decode_32k`` × 2x16x16 and ×
   ``train_4k`` × 16x16 in child processes on the host side by side (fake
   process groups), each artifact's
   per-device bytes, ``fits_hbm``, dominant term and roofline fraction;
   launches against ``PREDICTED_3K`` (none);
3l. one rank of olmoe-1b-7b × ``train_4k`` × 16x16, tensor-parallel: in a
   child process (this script with ``--rank-of-16x16``, under
   ``TP_TIMEOUT_S``) a fake process group of 256 ranks, the production
   16 × 16 ``DeviceMesh`` on the card, the local state of the rank the dry
   run counts (``counted_rank``: rank 0 here) of the published config at
   all 16 layers from a seed, 3 ``make_train_step`` steps of the rank's
   batch shard (16 × 4,096 tokens, 2 microbatches; each step's batch made
   before its timer starts); the peak device memory within 80 GB and
   within ``PEAK_BAND`` of 3k's dry-run ``per_device_bytes``, the median
   step, the collectives of step 0 equal kind by kind to the dry run's,
   launches against ``PREDICTED_3L`` (none); the losses printed, not gated
   (the fake collectives fill nothing); then the same child for
   whisper-tiny × ``train_4k`` × 16x16 (``TP_WHISPER``, dry-run in 3k): 6
   heads over 16 ranks, so the attention splits over query positions, and
   the rank is the heaviest, rank 15; 3 steps at full width and depth;
3m. one rank of each serving cell of ``SERVE_CELLS`` × 16x16, prefill and
   decode tensor-parallel with the caches split as they rest: the four
   cells' dry runs on ``meta``, side by side in child processes on the
   host; then each cell in a child process (this script with
   ``--serve-rank-of-16x16``, under ``SERVE_TIMEOUT_S``) that starts a
   fake process group of 256 ranks and the production 16 × 16
   ``DeviceMesh`` on the card, makes the local parameters and caches (or
   batch shard) of the rank the dry run counts, of the published config
   at full depth from a seed, and runs gemma2-27b × ``decode_32k`` (8 sequences, 1 KV head a rank, caches
   filled to position 32,000, 8 decode steps), gemma2-9b × ``prefill_32k``
   (2 sequences of 32,768 tokens, the caches' slots split over ``model``,
   3 prefills) and gemma2-9b × ``long_500k`` (1 sequence, 524,288 slots
   split 256 ways, 8 decode steps), whisper-tiny × ``prefill_32k`` (2
   sequences of 32,768 tokens, the attention split over query positions,
   the self caches' slots split over ``model``, the cross caches whole, 3
   prefills, as rank 15), and one more decode step under
   ``torch.profiler``; each peak device memory within 80 GB and within
   ``PEAK_BAND`` of the dry run's ``per_device_bytes``, the median step,
   the first step's
   collectives equal kind by kind (count and bytes) to the dry run's,
   launches against ``PREDICTED_3M`` (none); the logits printed, not
   gated;
4. the mining CLI in-process (``repro_torch.launch.mine``), diced, plain
   and ``--distributed`` (the same ``total_pairs`` as the plain run);
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
``launches_by_phase`` each phase's own, 3 to 3m); the last line
is ``{"ok": true, "device": {...}}``.  Counts are exact integers and the
alignment DP is f32 adds and mins in one fixed order, so every comparison
of phases 2-3h has tolerance 0; phases 3i, 3j and 3k state their model
tolerances.
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

DAY = 86400.0
#: the H100's data-sheet rates (``repro_torch.roofline.hw``, bound in
#: ``main`` once the port is importable): ``HBM_BW`` for the bytes bound,
#: ``PEAK_FLOPS_FP32`` (float32 outside the tensor cores, an FMA counted as
#: two operations) for the operations bound, ``PEAK_FLOPS_BF16`` (dense
#: tensor cores) for the LM steps' FLOP bound
hw = None
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


@contextlib.contextmanager
def _recording_launches(mods):
    """Within the context, every launch through each wrapper module's
    ``launch`` is recorded as a launch configuration (its ``last_launch``
    named by its library) for the Hopper launch checker; a call that
    launched nothing (no work) leaves ``last_launch`` empty and is not
    recorded.  The modules' ``launch`` is restored after."""
    from repro_torch.analysis.kernels_check import launch_config

    configs, saved = [], []
    for library, mod in mods:
        def recorded(*args, _fn=mod.launch, _mod=mod, _lib=library,
                     **kwargs):
            _mod.last_launch.clear()
            out = _fn(*args, **kwargs)
            if _mod.last_launch:
                configs.append(launch_config(_lib, _mod.last_launch))
            return out

        saved.append((mod, mod.launch))
        mod.launch = recorded
    try:
        yield configs
    finally:
        for mod, fn in saved:
            mod.launch = fn


def phase_launch_check(build, configs):
    """Every phase-2 launch's configuration, with its build's ptxas
    resources, through ``kernels_check.validate_launch`` (a hard finding is
    fatal), then ``kernels_check.build_report()``: each kernel launched at
    the main path's PAPER_EVAL shapes and its resident blocks per SM."""
    from repro_torch.analysis import kernels_check as kc

    records = {r.name: build.ptxas_resources(r.ptxas)
               for r in build.build_all()}
    distinct = list({json.dumps(c, sort_keys=True): c
                     for c in configs}.values())
    warnings, occ = [], {}
    for c in distinct:
        _, res = kc.entry_resources(c, records[c["library"]])
        try:
            warnings += kc.validate_launch(c, res)
        except kc.KernelLaunchError as e:
            raise SmokeFailure(f"launch checker: {e}")
        o = kc.occupancy(c, res)
        occ.setdefault((c["library"], c["branch"]), set()).add(
            (o.blocks_per_sm, o.limit))
    check(configs and {(c["library"], c["branch"]) for c in configs}
          == set(kc.KERNEL_TABLE),
          f"phase 2 launched the tiers {sorted(occ)}, not every entry of "
          "the launch checker's table")
    log(f"launch checker: {len(configs)} phase-2 launches, {len(distinct)} "
        "distinct configurations, checked against the H100's limits: 0 hard "
        f"findings, {len(warnings)} warning(s)")
    for w in warnings:
        log(f"  warning: {w.format()}")
    for (lib, tier), got in sorted(occ.items()):
        log(f"  {lib} {tier}: resident blocks per SM "
            + ", ".join(f"{b} (limit: {lim})" for b, lim in sorted(got)))
    t0 = time.perf_counter()
    report = kc.build_report()
    check(report["hard"] == 0, f"launch report: {report['hard']} hard "
          "finding(s)")
    log(f"launch report at PAPER_EVAL shapes ({report['configurations']} "
        f"launches, {report['warnings']} warning(s), "
        f"{time.perf_counter() - t0:.1f} s):")
    for line in kc.format_report(report):
        log(f"  {line}")


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
    return counts_3e, canary


# ---------------------------------------------------------------------------
# Phase 3f — the case-sharded graph tier and the distributed DFG
# ---------------------------------------------------------------------------

#: phase 3f's launches, predicted from the code before its first run on the
#: card (PERF.md §6): the sharded DFG builds each shard's graph on the
#: card (one B1 + one B3 per shard); the histogram, 30-day DFG, process map
#: and neighborhood are served by those graphs (their sub-queries are graph
#: lookups, window indexes and cache hits), and the append extends shard 2's
#: graph on the host; the mesh engine counts on its one position (one B1 per
#: DFG, the window masked before the count), ``distributed_dfg`` launches one
#: B1 per call, and each of the two ranks one B1 (counted in the ranks)
PREDICTED_3F = {"dfg_count": 10, "dfg_count_diced": 0, "segment_count": 4,
                "align_dp": 0}
PREDICTED_3F_QUERIES = {
    "S1 sharded.dfg": {"dfg_count": 4, "segment_count": 4},
    "S2 sharded.histogram": {},
    "S3 sharded.window(30d).dfg": {},
    "S4 sharded.process_map": {},
    "S5 sharded.neighborhood": {},
    "S6 grown.dfg": {},
    "D1 mesh.dfg": {"dfg_count": 1},
    "D2 mesh.window(30d).dfg": {"dfg_count": 1},
    "D3 distributed_dfg(hierarchical)": {"dfg_count": 1},
    "D4 distributed_dfg(flat)": {"dfg_count": 1},
    "R two ranks": {"dfg_count": 2},
}
#: case shards of the sharded deployment and ranks of the rank check
SHARDS, RANKS = 4, 2
#: seconds the rank check may take, spawn and rendezvous included
RANK_TIMEOUT_S = 180
#: the device both ranks count on (gloo: NCCL refuses two ranks on one card)
RANK_DEVICE = "cuda:0"


def _rank_worker(rank, world, tmp, a, device):
    """One gloo rank on ``device`` (spawned): counts its half of phase 3's
    pairs with ``distributed_dfg`` (one B1), sums over the ranks, then
    merges the shard Ψ on the two-position mesh; saves its answers,
    reductions and launches under ``tmp``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.core.compat import make_mesh
    from repro_torch.kernels.dfg_count import ops

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
    )
    try:
        mesh = make_mesh((world,), ("data",), devices=[device] * world)
        act = np.load(os.path.join(tmp, "act.npy"))
        valid = np.load(os.path.join(tmp, "valid.npy"))
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psi = D.distributed_dfg(mesh, act[:-1], act[1:], valid, a)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        reductions = [[c.op, list(c.axes), list(c.shape), c.dtype]
                      for c in D.last_reductions]
        launches = {k: v for k, v in ops.launch_counts.items() if v}
        with np.load(os.path.join(tmp, "shard_psis.npz")) as z:
            psis = [z[f"psi{k}"] for k in range(SHARDS)]
            maps = [z[f"ids{k}"] for k in range(SHARDS)]
        merged = D.merge_shard_psis(psis, maps, a, mesh=mesh)
        merge_reductions = [list(c.axes) for c in D.last_reductions]
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), psi=psi,
                 merged=merged)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump({"seconds": seconds, "reductions": reductions,
                       "merge_reductions": merge_reductions,
                       "launches": launches}, f)
    finally:
        dist.destroy_process_group()


def _run_ranks(tmp, a):
    """Spawn the ranks, wait for them under the time limit, kill any that
    outlives it; fails unless every rank exits 0."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_worker,
                         args=(r, RANKS, tmp, a, RANK_DEVICE))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    codes = []
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
        if p.is_alive():
            p.kill()
            p.join()
        codes.append(p.exitcode)
    check(codes == [0] * RANKS, f"rank exit codes {codes}")


def phase_sharded(torch, mlog, repo, results, card, tmp):
    """The case-sharded graph tier and the distributed DFG through default
    engines at PAPER_EVAL width, each answer against host oracles written
    here (tolerance 0).  Returns {kernel: launches}."""
    import numpy as np

    from repro_torch.core import dfg_numpy, pair_mask_for_window
    from repro_torch.core import distributed as D
    from repro_torch.core.compat import make_mesh
    from repro_torch.graph import (
        csr_from_dense,
        derive_neighborhood,
        derive_process_map,
        partition_memmap_log,
    )
    from repro_torch.kernels.align_dp import ops as dp_ops
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops
    from repro_torch.query import (
        NeighborhoodSink,
        ProcessMapSink,
        Q,
        QueryEngine,
        fingerprint,
    )
    from repro_torch.query.cache import split_sharded_fingerprint

    t_phase = time.perf_counter()
    a = mlog.num_activities
    names = list(repo.activity_names)
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

    # -- the sharded deployment -----------------------------------------------
    t0 = time.perf_counter()
    sh = partition_memmap_log(mlog, SHARDS, os.path.join(tmp, "prod_sharded"))
    sizes = [s.num_events for _, s in sh.present_shards()]
    check(len(sizes) == SHARDS and sum(sizes) == mlog.num_events,
          f"shard sizes {sizes}")
    log(f"sharded: partitioned prod's {mlog.num_events} events into {SHARDS} "
        f"case shards {sizes} in {time.perf_counter() - t0:.2f} s (host)")

    # -- host oracles on the single log ---------------------------------------
    src, dst, valid = repo.df_pairs()
    psi_all = results[0][2].value  # == the host oracle (phase 3)
    psi_30 = dfg_numpy(src, dst, valid & pair_mask_for_window(repo, w30), a)
    hist = np.bincount(repo.event_activity, minlength=a).astype(np.int64)
    center = names[int(np.argmax(hist))]
    pm_sink, nb_sink = ProcessMapSink(), NeighborhoodSink(center, k=2)
    adj = csr_from_dense(psi_all)
    want_pm = derive_process_map(adj, hist, names, pm_sink.top,
                                 pm_sink.edge_top)
    want_nb = derive_neighborhood(adj, adj.transpose(), names, center,
                                  nb_sink.k, nb_sink.direction)

    engine = QueryEngine()
    qs = Q.log(sh).using(engine)
    queries = {
        "S1 sharded.dfg": lambda: qs.dfg(),
        "S2 sharded.histogram": lambda: qs.histogram(),
        "S3 sharded.window(30d).dfg": lambda: qs.window(*w30).dfg(),
        "S4 sharded.process_map": lambda: qs.process_map(),
        "S5 sharded.neighborhood": lambda: qs.neighborhood(center, k=2),
    }
    for m in kernel_ops:
        m.reset_launch_counts()
    res, walls, launched = {}, {}, {}

    def run(name, fn):
        before = counts_now()
        res[name], walls[name] = timed(fn)
        after = counts_now()
        launched[name] = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}

    for name, fn in queries.items():
        run(name, fn)
    for name in queries:
        r = res[name]
        check(r.physical.backend == "sharded-graph" and not r.from_cache,
              f"{name}: {r.physical.describe()}")
        check({n for n, _ in r.trace.branches}
              == {f"shard{k}" for k in range(SHARDS)},
              f"{name}: shard sub-queries {r.trace.branches}")
    for name, got, want in (("S1 sharded.dfg", res["S1 sharded.dfg"].value,
                             psi_all),
                            ("S2 sharded.histogram",
                             res["S2 sharded.histogram"].value, hist),
                            ("S3 sharded.window(30d).dfg",
                             res["S3 sharded.window(30d).dfg"].value, psi_30)):
        check(got.dtype == np.int64 and np.array_equal(got, want),
              f"{name} differs from the single log's host oracle")
    check(_same_process_map(np, res["S4 sharded.process_map"].value, want_pm),
          "S4: the process map differs from the host oracle's")
    nb = res["S5 sharded.neighborhood"].value
    check(nb == want_nb, "S5: the neighborhood differs from the host oracle's")
    log(f"  S1-S5: Ψ total {int(psi_all.sum())}, histogram, 30-day Ψ total "
        f"{int(psi_30.sum())}, process map ({len(want_pm.activities)} "
        f"activities) and neighborhood of {center} == the single log's "
        "host oracles")

    # -- S6: an append on the cases of one residue -----------------------------
    n_app = mlog.num_events // 100
    rng = np.random.default_rng(20)
    owner = 2
    shard = sh.shards[owner]
    open_cases = np.unique(np.asarray(shard.case[-n_app:]))
    n_new = n_app // 4
    first_new = (mlog.num_traces // SHARDS + 1) * SHARDS + owner
    case = np.concatenate([
        rng.choice(open_cases, n_app - n_new),
        first_new + SHARDS * rng.integers(0, n_new // 4 + 1, n_new),
    ]).astype(np.int32)
    rng.shuffle(case)
    act = rng.integers(0, a, n_app).astype(np.int32)
    times = float(mlog.time[-1]) + np.sort(rng.uniform(0.0, DAY, n_app))
    t0 = time.perf_counter()
    grown = sh.append(act, case, times)
    append_s = time.perf_counter() - t0
    slots0 = split_sharded_fingerprint(fingerprint(sh))
    slots1 = split_sharded_fingerprint(fingerprint(grown))
    check([i for i in range(SHARDS) if slots0[i] != slots1[i]] == [owner],
          "the append moved another shard's fingerprint slot")
    rows0 = engine.stats.rows_scanned
    run("S6 grown.dfg", lambda: Q.log(grown).using(engine).dfg())
    r6 = res["S6 grown.dfg"]
    rescanned = engine.stats.rows_scanned - rows0
    hits = {n: t.from_cache for n, t in r6.trace.branches}
    check(rescanned == n_app, f"S6 rescanned {rescanned} rows, not {n_app}")
    check(hits == {f"shard{k}": k != owner for k in range(SHARDS)},
          f"S6 shard sub-queries from the cache: {hits}")
    t0 = time.perf_counter()
    ga = np.concatenate([np.asarray(mlog.activity), act])
    gc = np.concatenate([np.asarray(mlog.case), case])
    gt = np.concatenate([np.asarray(mlog.time), times])
    order = np.lexsort((np.arange(ga.shape[0]), gt, gc))
    ga, gc = ga[order], gc[order]
    want_grown = dfg_numpy(ga[:-1], ga[1:], gc[:-1] == gc[1:], a)
    oracle_s = time.perf_counter() - t0
    check(np.array_equal(r6.value, want_grown),
          "S6: Ψ of the grown log differs from the host oracle")
    log(f"  S6: appended {n_app} rows on {np.unique(case).shape[0]} cases of "
        f"residue {owner} in {append_s:.2f} s; only shard{owner} rescanned "
        f"({rescanned} rows, its graph extended), the others cache hits; Ψ "
        f"total {int(want_grown.sum())} == host oracle ({oracle_s:.2f} s)")

    # -- D1-D4: an engine with a mesh of the card, distributed_dfg ---------------
    mesh = make_mesh((1,), ("data",))
    meng = QueryEngine(mesh=mesh)
    run("D1 mesh.dfg", lambda: Q.log(mlog).using(meng).dfg())
    run("D2 mesh.window(30d).dfg",
        lambda: Q.log(mlog).using(meng).window(*w30).dfg())
    reductions = {}
    for name, hier in (("D3 distributed_dfg(hierarchical)", True),
                       ("D4 distributed_dfg(flat)", False)):
        run(name, lambda: D.distributed_dfg(mesh, src, dst, valid, a,
                                            hierarchical=hier))
        reductions[name] = [(c.axes, c.shape, c.dtype)
                            for c in D.last_reductions]
    for name, want in (("D1 mesh.dfg", psi_all),
                       ("D2 mesh.window(30d).dfg", psi_30)):
        r = res[name]
        check(r.physical.backend == "distributed"
              and np.array_equal(r.value, want),
              f"{name}: {r.physical.describe()}, Ψ == oracle "
              f"{np.array_equal(r.value, want)}")
    for name in reductions:
        check(np.array_equal(res[name], psi_all), f"{name}: Ψ differs")
        check(reductions[name] == [(("data",), (a, a), "int64")],
              f"{name}: reductions {reductions[name]}")
    log("  D1-D4: the mesh engine planned distributed; Ψ and 30-day Ψ == "
        "phase 3's; hierarchical and flat reductions agree")

    # -- R: two gloo ranks on the card ----------------------------------------
    rtmp = os.path.join(tmp, "ranks")
    os.makedirs(rtmp)
    np.save(os.path.join(rtmp, "act.npy"), repo.event_activity)
    np.save(os.path.join(rtmp, "valid.npy"), valid)
    shard_psis, shard_ids = {}, {}
    for k, s in sh.present_shards():
        sub = Q.log(s).using(engine).dfg(backend="graph")
        check(sub.from_cache, f"shard{k}'s Ψ is not cached")
        shard_psis[f"psi{k}"] = sub.value
        shard_ids[f"ids{k}"] = np.arange(s.num_activities)
    np.savez(os.path.join(rtmp, "shard_psis.npz"), **shard_psis, **shard_ids)
    want_merged = np.sum(list(shard_psis.values()), axis=0, dtype=np.int64)
    _, walls["R two ranks"] = timed(lambda: _run_ranks(rtmp, a))
    rank_launches, rank_s = {}, []
    for r in range(RANKS):
        with np.load(os.path.join(rtmp, f"rank{r}.npz")) as z:
            psi_r, merged_r = z["psi"], z["merged"]
        with open(os.path.join(rtmp, f"rank{r}.json")) as f:
            rec = json.load(f)
        check(np.array_equal(psi_r, psi_all),
              f"rank {r}: Ψ differs from the host oracle")
        check(rec["reductions"] == [["all_reduce", ["data"], [a, a], "int64"]],
              f"rank {r}: reductions {rec['reductions']}")
        check(np.array_equal(merged_r, want_merged)
              and rec["merge_reductions"] == [["data"]],
              f"rank {r}: the mesh merge of the shard Ψ differs")
        for k, v in rec["launches"].items():
            rank_launches[k] = rank_launches.get(k, 0) + v
        rank_s.append(rec["seconds"])
    launched["R two ranks"] = rank_launches
    check(np.array_equal(want_merged, psi_all),
          "the numpy sum of the shard Ψ differs from the single log's")
    log(f"  R: {RANKS} gloo ranks on {RANK_DEVICE}, each counted half of the "
        f"{src.shape[0]} pairs with dfg_count ("
        + " / ".join(f"{x:.4f}" for x in rank_s)
        + " s incl. the all_reduce); every Ψ == host oracle; one "
        f"({a}, {a}) int64 all_reduce per mesh axis crossed ranks; the mesh "
        f"merge of the {SHARDS} shard Ψ == the numpy sum; "
        f"{walls['R two ranks']:.1f} s with the spawn")

    counts_3f = counts_now()
    for k, v in rank_launches.items():
        counts_3f[k] = counts_3f.get(k, 0) + v
    log(f"sharded / distributed launches: {counts_3f} (predicted "
        f"{PREDICTED_3F})")
    for name in res:
        r = res[name]
        desc = spans = ""
        if hasattr(r, "physical"):  # a QueryResult, not distributed_dfg's Ψ
            desc = f", {r.physical.describe()}"
            notes = r.trace.notes
            spans = "  " + "  ".join(
                f"{k} {notes.get(f'{k}_s', 0.0):.4f}"
                for k in ("materialize", "h2d", "kernel", "d2h",
                          "distributed")
            ) + f"  shard_merge {r.trace.span_seconds('shard_merge'):.4f}"
        log(f"  {name}: wall {walls[name]:.4f} s, launches "
            f"{launched[name]}{desc}{spans}")
    log(f"  R two ranks: wall {walls['R two ranks']:.4f} s, launches "
        f"{launched['R two ranks']}")
    check(launched == PREDICTED_3F_QUERIES,
          f"phase 3f per-query launches {launched} differ from the "
          f"prediction {PREDICTED_3F_QUERIES}")
    check(counts_3f == PREDICTED_3F,
          f"phase 3f launches {counts_3f} differ from the prediction "
          f"{PREDICTED_3F}")
    log(f"phase 3f walls [{card}] (s; host clock, card synchronized): "
        + "  ".join(f"{k.split()[0]} {v:.4f}" for k, v in walls.items()))
    total = time.perf_counter() - t_phase
    log(f"phase 3f: {total:.1f} s, of which queries "
        f"{sum(walls.values()):.1f} s")
    return counts_3f, grown


# ---------------------------------------------------------------------------
# Phase 3g — the query service at PAPER_EVAL width
# ---------------------------------------------------------------------------

#: phase 3g's launches per request, predicted from the code before its first
#: run on the card (PERF.md §6): the cold DFG counts prod with one B1 and
#: its repeat is a cache hit; the 30-day DFG fuses its window into one B2;
#: the first process map is prod's third topology miss (after the two DFG
#: misses), so it crosses GRAPH_REPEAT_CROSSOVER and builds prod's graph
#: (one B1 + one B3), and every later topology and conformance request on
#: prod reads that graph; alignments runs one B4 on the graph's event
#: tables; the union DFG counts canary with one B1 (prod's branch is the
#: cache hit of G1); compare's per-branch Ψ are cache hits and its replays
#: run on the host (prod's graph, canary's columns: canary's second miss);
#: the introspection sinks mine a few hundred span events on the host; the
#: streaming DFG, the append and its delta resume scan on the host; the
#: sharded DFG builds each of the 4 shard graphs (one B1 + one B3 each) and
#: after the append extends the owning shard's graph on the host; each warm
#: 30-day dice of the tracing-overhead measurement is one B2, on either
#: engine
PREDICTED_3G_QUERIES = {
    "G1 prod.dfg": {"dfg_count": 1},
    "G1b prod.dfg (again)": {},
    "G2 prod.window(30d).dfg": {"dfg_count_diced": 1},
    "G3 prod.process_map(0.2)": {"dfg_count": 1, "segment_count": 1},
    "G3b prod.process_map(0.5)": {},
    "G3c prod.process_map(0.1)": {},
    "G4 prod.neighborhood": {},
    "G5 prod.fitness": {},
    "G5b prod.alignments": {"align_dp": 1},
    "G6 union.dfg": {"dfg_count": 1},
    "G6b union.compare": {},
    "G7 metrics(prometheus)": {},
    "G7b forensics": {},
    "G7c slo": {},
    "G8 live.dfg(streaming)": {},
    "G8a live append": {},
    "G8b live.dfg(streaming) (delta)": {},
    "G9 sharded.dfg": {"dfg_count": 4, "segment_count": 4},
    "G9a sharded append": {},
    "G9b sharded.dfg (after append)": {},
    "O trace-on dices": {"dfg_count_diced": 50},
    "O trace-off dices": {"dfg_count_diced": 50},
}
PREDICTED_3G = {"dfg_count": 7, "dfg_count_diced": 101, "segment_count": 5,
                "align_dp": 1}
#: the k-anonymity floor of prod's access policy
PROD_FLOOR = 5
#: warm dices per engine in the tracing-overhead measurement
OVERHEAD_DICES = 50
#: payload keys a run measures or mints for itself
VOLATILE = ("wall_s", "trace_id", "trace")


def _floor(np, a, floor):
    return np.where(a >= floor, a, 0)


def _pm_payload(pm, floor):
    """A process map as the service must expose it under ``floor``: nodes
    below it vanish, with every edge below it or touching a vanished
    node."""
    keep = {a for a, c in zip(pm.activities, pm.node_counts) if int(c) >= floor}
    edges = [[s, d, int(c)] for s, d, c in pm.edges
             if s in keep and d in keep and int(c) >= floor]
    return {
        "activities": [a for a in pm.activities if a in keep],
        "node_counts": [int(c) for a, c in zip(pm.activities, pm.node_counts)
                        if a in keep],
        "edges": edges, "top": pm.top, "edge_top": pm.edge_top,
        "dropped_activities": pm.dropped_activities + len(pm.activities)
        - len(keep),
        "dropped_edges": pm.dropped_edges + len(pm.edges) - len(edges),
    }


def _nb_payload(nb, floor):
    edges = [[s, d, int(c)] for s, d, c in nb.edges if int(c) >= floor]
    touched = {nb.center} | {e[0] for e in edges} | {e[1] for e in edges}
    acts = [a for a in nb.activities if a in touched]
    return {"center": nb.center, "k": nb.k, "direction": nb.direction,
            "activities": acts, "hops": {a: nb.hops[a] for a in acts},
            "edges": edges}


def _census(deviating_edges, floor):
    out = [{"edge": [s, d], "count": int(c)}
           for (s, d), c in deviating_edges.items() if int(c) >= floor]
    out.sort(key=lambda e: (-e["count"], e["edge"]))
    return out


def _conf_payload(value, floor, alignments):
    if not alignments:
        return {"fitness": value.fitness,
                "perfect_traces": value.perfectly_fitting,
                "total_traces": int(value.trace_fitness.shape[0]),
                "deviations": _census(value.deviating_edges, floor)}
    n = int(value.trace_cost.shape[0])
    return {"fitness": value.fitness,
            "perfect_traces": value.perfectly_fitting, "total_traces": n,
            "mean_cost": float(value.trace_cost.mean()) if n else 0.0,
            "empty_cost": value.empty_cost,
            "deviations": _census(value.deviating_edges, floor)}


def _compare_payload(np, names, log_names, psis, fitness, floor):
    fl = [_floor(np, p, floor) for p in psis]
    return {"names": names,
            "psi": {n: p.tolist() for n, p in zip(log_names, fl)},
            "diff": {n: (p - fl[0]).tolist() for n, p in zip(log_names, fl)},
            "fitness": dict(zip(log_names, fitness))}


def _value_part(out):
    """A service payload without its envelope (the request's names, the
    disposition and what the run measured)."""
    skip = set(VOLATILE) | {"log", "logs", "sink", "from_cache", "backend"}
    return {k: v for k, v in out.items() if k not in skip}


def _canonical_psi(np, parts, a):
    """Ψ of event columns in the canonical order (trace-contiguous,
    time-sorted, stable), from the (activity, case, time) chunks given."""
    ga = np.concatenate([p[0] for p in parts])
    gc = np.concatenate([p[1] for p in parts])
    gt = np.concatenate([p[2] for p in parts])
    order = np.lexsort((np.arange(ga.shape[0]), gt, gc))
    ga, gc = ga[order], gc[order]
    from repro_torch.core import dfg_numpy

    return dfg_numpy(ga[:-1], ga[1:], gc[:-1] == gc[1:], a)


def phase_service(torch, mlog, repo, results, canary, sharded, conf, card,
                  tmp):
    """The query service through one ``QueryService`` on a default engine of
    the card with a trace store, at PAPER_EVAL width: each request's
    payload against the host oracle (floored as prod's policy says) and the
    direct engine result, the probe's prediction against what ran, launch
    counts against ``PREDICTED_3G``, the trace store mined back, the
    planner's drift counter and the tracing overhead.  Returns {kernel:
    launches}."""
    import numpy as np

    from repro_torch.core import (
        AccessPolicy,
        MemmapLog,
        dfg_numpy,
        discover_dependency_graph,
        pair_mask_for_window,
        replay_fitness,
    )
    from repro_torch.graph import (
        csr_from_dense,
        derive_neighborhood,
        derive_process_map,
        open_sharded_log,
    )
    from repro_torch.kernels.align_dp import ops as dp_ops
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops
    from repro_torch.obs import TraceStore
    from repro_torch.query import Q, QueryEngine, fingerprint
    from repro_torch.serve import QueryService

    t_phase = time.perf_counter()
    a = mlog.num_activities
    names = list(repo.activity_names)
    t_min = float(mlog.time[0])
    w30 = (t_min, t_min + 30 * DAY)
    kernel_ops = (ops, seg_ops, dp_ops)

    def counts_now():
        out = {}
        for m in kernel_ops:
            out.update(m.launch_counts)
        return out

    # -- host oracles -----------------------------------------------------
    t0 = time.perf_counter()
    src, dst, valid = repo.df_pairs()
    psi_all = results[0][2].value  # == the host oracle (phase 3)
    psi_30 = dfg_numpy(src, dst, valid & pair_mask_for_window(repo, w30), a)
    hist = np.bincount(repo.event_activity, minlength=a).astype(np.int64)
    center = names[int(np.argmax(hist))]
    adj = csr_from_dense(psi_all)
    tops = (0.2, 0.5, 0.1)
    want_pm = {t: derive_process_map(adj, hist, names, t, None) for t in tops}
    want_nb = derive_neighborhood(adj, adj.transpose(), names, center, 2,
                                  "out")
    m_prod = discover_dependency_graph(psi_all, names,
                                       *repo.trace_boundaries())
    fit_p = replay_fitness(repo, m_prod)
    fit_c = replay_fitness(canary, m_prod)
    names_c = list(canary.activity_names)
    union_names = sorted(set(names) | set(names_c))
    u = len(union_names)
    uidx = {n: i for i, n in enumerate(union_names)}
    s_c, d_c, v_c = canary.df_pairs()
    psis_u = (_embed(np, psi_all, [uidx[n] for n in names], u),
              _embed(np, dfg_numpy(s_c, d_c, v_c, len(names_c)),
                     [uidx[n] for n in names_c], u))
    ali_3c = conf["results"]["alignments"].value
    fl = PROD_FLOOR
    oracle = {
        "G1 prod.dfg": {"psi": _floor(np, psi_all, fl).tolist(),
                        "names": names},
        "G2 prod.window(30d).dfg": {"psi": _floor(np, psi_30, fl).tolist(),
                                    "names": names},
        "G4 prod.neighborhood": _nb_payload(want_nb, fl),
        "G5 prod.fitness": _conf_payload(fit_p, fl, False),
        "G5b prod.alignments": _conf_payload(ali_3c, fl, True),
        "G6 union.dfg": {"psi": _floor(np, psis_u[0] + psis_u[1], fl)
                         .tolist(), "names": union_names},
        "G6b union.compare": _compare_payload(
            np, union_names, ("prod", "canary"), psis_u,
            (fit_p.fitness, fit_c.fitness), fl),
    }
    oracle["G1b prod.dfg (again)"] = oracle["G1 prod.dfg"]
    for t, name in zip(tops, ("G3 prod.process_map(0.2)",
                              "G3b prod.process_map(0.5)",
                              "G3c prod.process_map(0.1)")):
        oracle[name] = _pm_payload(want_pm[t], fl)
    check(_conf_payload(conf["results"]["fitness numpy"].value, fl, False)
          == oracle["G5 prod.fitness"],
          "prod's default model is not the discovered dependency graph")
    log(f"service oracles: Ψ, 30-day Ψ, 3 process maps, the neighborhood of "
        f"{center}, replay of prod and canary against prod's model, the "
        f"{u}-name union axis, in {time.perf_counter() - t0:.2f} s (host)")

    # -- a copy of prod for the live append ------------------------------
    t0 = time.perf_counter()
    w = MemmapLog.create(os.path.join(tmp, "prod_live"), mlog.num_events,
                         a, mlog.num_traces, chunk_rows=mlog.chunk_rows)
    w.append(np.asarray(mlog.activity), np.asarray(mlog.case),
             np.asarray(mlog.time))
    live = w.close()
    check(fingerprint(live) == fingerprint(mlog),
          "the live copy's fingerprint differs from prod's")
    log(f"service: copied prod's {live.num_events} rows for the live log in "
        f"{time.perf_counter() - t0:.2f} s (host)")

    # -- the service --------------------------------------------------------
    store = TraceStore(os.path.join(tmp, "traces"))
    engine = QueryEngine(trace_store=store)
    svc = QueryService(engine)
    policy = AccessPolicy(min_group_count=PROD_FLOOR)
    svc.register("prod", mlog, policy)
    svc.register("canary", canary)
    svc.register("live", live, policy)
    svc.register("sharded", sharded)

    n_app = mlog.num_events // 100
    rng = np.random.default_rng(21)
    open_cases = np.unique(np.asarray(mlog.case[-n_app:]))
    n_new = n_app // 4
    live_rows = (
        rng.integers(0, a, n_app).astype(np.int32),
        rng.permutation(np.concatenate([
            rng.choice(open_cases, n_app - n_new),
            mlog.num_traces + rng.integers(0, n_new // 4 + 1, n_new),
        ])).astype(np.int32),
        float(np.asarray(mlog.time[-1])) + np.sort(
            rng.uniform(0.0, DAY, n_app)),
    )
    owner = 1
    shard = sharded.shards[owner]
    s_open = np.unique(np.asarray(shard.case[-n_app:]))
    first_new = (int(max(np.asarray(s.case).max() for _, s in
                         sharded.present_shards())) // SHARDS + 1) * SHARDS \
        + owner
    t_shard = max(float(np.asarray(s.time[-1]))
                  for _, s in sharded.present_shards())
    shard_rows = (
        rng.integers(0, a, n_app).astype(np.int32),
        rng.permutation(np.concatenate([
            rng.choice(s_open, n_app - n_new),
            first_new + SHARDS * rng.integers(0, n_new // 4 + 1, n_new),
        ])).astype(np.int32),
        t_shard + np.sort(rng.uniform(0.0, DAY, n_app)),
    )

    def append_req(log_name, rows):
        return {"log": log_name, "activity": rows[0].tolist(),
                "case": rows[1].tolist(), "time": rows[2].tolist()}

    requests = [
        ("G1 prod.dfg", {"log": "prod", "sink": "dfg", "trace": True}),
        ("G1b prod.dfg (again)", {"log": "prod", "sink": "dfg"}),
        ("G2 prod.window(30d).dfg",
         {"log": "prod", "sink": "dfg", "window": list(w30)}),
        ("G3 prod.process_map(0.2)",
         {"log": "prod", "sink": "process_map", "top": 0.2}),
        ("G3b prod.process_map(0.5)",
         {"log": "prod", "sink": "process_map", "top": 0.5}),
        ("G3c prod.process_map(0.1)",
         {"log": "prod", "sink": "process_map", "top": 0.1}),
        ("G4 prod.neighborhood", {"log": "prod", "sink": "neighborhood",
                                  "activity": center, "k": 2}),
        ("G5 prod.fitness", {"log": "prod", "sink": "fitness"}),
        ("G5b prod.alignments", {"log": "prod", "sink": "alignments"}),
        ("G6 union.dfg", {"logs": ["prod", "canary"], "sink": "dfg"}),
        ("G6b union.compare", {"logs": ["prod", "canary"],
                               "sink": "compare"}),
        ("G7 metrics(prometheus)", {"sink": "metrics",
                                    "format": "prometheus"}),
        ("G7b forensics", {"sink": "forensics"}),
        ("G7c slo", {"sink": "slo"}),
        ("G8 live.dfg(streaming)",
         {"log": "live", "sink": "dfg", "backend": "streaming"}),
        ("G8a live append", append_req("live", live_rows)),
        ("G8b live.dfg(streaming) (delta)",
         {"log": "live", "sink": "dfg", "backend": "streaming"}),
        ("G9 sharded.dfg", {"log": "sharded", "sink": "dfg"}),
        ("G9a sharded append", append_req("sharded", shard_rows)),
        ("G9b sharded.dfg (after append)",
         {"log": "sharded", "sink": "dfg", "trace": True}),
    ]
    for m in kernel_ops:
        m.reset_launch_counts()
    out, walls, launched, probes, stats, snaps = {}, {}, {}, {}, {}, {}
    for name, req in requests:
        appending = name.endswith("append")
        if not appending and req.get("sink") not in (
                "metrics", "forensics", "slo"):
            probes[name] = svc.probe(dict(req))
        if name == "G7b forensics":
            snaps[name] = engine.own_telemetry()
        before, s0 = counts_now(), engine.stats
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = (svc.append if appending else svc.query)(dict(req))
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        after, s1 = counts_now(), engine.stats
        launched[name] = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}
        stats[name] = (s1.rows_scanned - s0.rows_scanned,
                       s1.delta_hits - s0.delta_hits)
    served = time.perf_counter()

    # -- each payload: probe, host oracle, direct engine result ---------------
    grown_live = MemmapLog.open(live.path)
    grown_sharded = open_sharded_log(sharded.path)
    ql = Q.log(mlog).using(engine)
    qu = Q.logs((mlog, "prod"), (canary, "canary")).using(engine)
    direct = {
        "G1 prod.dfg": lambda: ql.dfg(),
        "G2 prod.window(30d).dfg": lambda: ql.window(*w30).dfg(),
        "G3 prod.process_map(0.2)": lambda: ql.process_map(top=0.2),
        "G3b prod.process_map(0.5)": lambda: ql.process_map(top=0.5),
        "G3c prod.process_map(0.1)": lambda: ql.process_map(top=0.1),
        "G4 prod.neighborhood": lambda: ql.neighborhood(center, k=2),
        "G5 prod.fitness": lambda: ql.fitness(),
        "G5b prod.alignments": lambda: ql.alignments(),
        "G6 union.dfg": lambda: qu.dfg(),
        "G6b union.compare": lambda: qu.compare(),
        "G8b live.dfg(streaming) (delta)": lambda: Q.log(grown_live).using(
            engine).dfg(backend="streaming"),
        "G9b sharded.dfg (after append)": lambda: Q.log(grown_sharded).using(
            engine).dfg(),
    }

    def payload_of(name, res, floor):
        v = res.value
        if name.startswith(("G3", "G4")):
            return (_pm_payload(v, floor) if name.startswith("G3")
                    else _nb_payload(v, floor))
        if name.startswith("G5"):
            return _conf_payload(v, floor, name.startswith("G5b"))
        if name.startswith("G6b"):
            return _compare_payload(np, v.names, v.log_names, v.psis,
                                    v.fitness, floor)
        return {"psi": _floor(np, v, floor).tolist(), "names": res.names}

    before = counts_now()
    t0 = time.perf_counter()
    for name, fn in direct.items():
        res = fn()
        check(res.from_cache, f"{name}: the direct query missed the cache")
        floor = 0 if name.startswith("G9") else fl
        check(payload_of(name, res, floor) == _value_part(out[name]),
              f"{name}: the service's payload differs from the direct "
              "engine result")
        if name in oracle:
            check(_value_part(out[name]) == oracle[name],
                  f"{name}: the service's payload differs from the host "
                  "oracle")
    check(_value_part(out["G1b prod.dfg (again)"]) == oracle["G1 prod.dfg"],
          "G1b: the repeat's payload differs")
    check(counts_now() == before, "a direct (cached) query launched a kernel")
    direct_s = time.perf_counter() - t0

    for name, p in probes.items():
        o = out[name]
        # a delta hint on a memmap log predicts a resume; on a sharded log
        # the shard merge reuses the shards the append left alone
        want = ("delta" if p.delta_hint and p.backend == "streaming"
                else p.backend)
        ok = o["from_cache"] if p.cached else (
            not o["from_cache"] and o["backend"] == want)
        check(ok, f"{name}: probe predicted backend {p.backend} cached "
              f"{p.cached} delta {p.delta_hint}; the request ran "
              f"{o['backend']} from_cache {o['from_cache']}")
    want_cached = {"G1b prod.dfg (again)"}
    got_cached = {n for n, o in out.items() if o.get("from_cache")}
    check(got_cached == want_cached, f"requests served from the cache: "
          f"{sorted(got_cached)}")
    backends = {n: o.get("backend") for n, o in out.items()}
    for name, want in (("G1 prod.dfg", "kernel"),
                       ("G2 prod.window(30d).dfg", "kernel"),
                       ("G3 prod.process_map(0.2)", "graph"),
                       ("G5b prod.alignments", "graph"),
                       ("G6 union.dfg", "union"),
                       ("G6b union.compare", "compare"),
                       ("G8 live.dfg(streaming)", "streaming"),
                       ("G8b live.dfg(streaming) (delta)", "delta"),
                       ("G9 sharded.dfg", "sharded-graph"),
                       ("G9b sharded.dfg (after append)", "sharded-graph")):
        check(backends[name] == want, f"{name} ran on {backends[name]}")

    # -- introspection --------------------------------------------------------
    prom = out["G7 metrics(prometheus)"]
    check('kernel_seconds_count{kernel="dfg_count"}' in prom["prometheus"]
          and "engine_queries_total" in prom["prometheus"]
          and prom["metrics"]["engine_queries_total"] > 0
          and prom["floor"] == 0, "metrics: the exposition is incomplete")
    own = snaps["G7b forensics"]
    fo = out["G7b forensics"]
    so, do, vo = own.df_pairs()
    check(fo["events"] == own.num_events and fo["names"] == own.activity_names
          and fo["psi"] == dfg_numpy(so, do, vo, own.num_activities).tolist()
          and "scan" in fo["names"],
          "forensics: Ψ of the engine's spans differs from numpy's")
    slo = out["G7c slo"]
    check({o["name"] for o in slo["objectives"]}
          == {"warm_latency", "availability"} and slo["ok"] is True,
          f"slo: {slo}")

    # -- the appends ----------------------------------------------------------
    check(out["G8a live append"]["appended"] == n_app
          and out["G8a live append"]["num_events"] == mlog.num_events + n_app,
          f"live append: {out['G8a live append']}")
    check(stats["G8 live.dfg(streaming)"][0] == mlog.num_events
          and stats["G8b live.dfg(streaming) (delta)"] == (n_app, 1),
          f"live: rows / delta hits {stats['G8 live.dfg(streaming)']} then "
          f"{stats['G8b live.dfg(streaming) (delta)']}")
    t0 = time.perf_counter()
    want_live = _canonical_psi(np, [
        (np.asarray(mlog.activity), np.asarray(mlog.case),
         np.asarray(mlog.time)), live_rows], a)
    live_after = {"psi": _floor(np, want_live, fl).tolist(), "names": names}
    check(_value_part(out["G8b live.dfg(streaming) (delta)"]) == live_after,
          "G8b: the delta Ψ differs from the host oracle")
    want_sh = _canonical_psi(np, [c for _, s in grown_sharded.present_shards()
                                  for c in s.iter_chunks()], a)
    oracle_s = time.perf_counter() - t0
    check(_value_part(out["G9b sharded.dfg (after append)"])
          == {"psi": want_sh.tolist(), "names": names},
          "G9b: Ψ of the grown sharded log differs from the host oracle")
    check(grown_sharded.num_events == sharded.num_events + n_app,
          "the sharded append lost rows")
    hits = {b["name"]: b["trace"]["from_cache"] for b in
            out["G9b sharded.dfg (after append)"]["trace"]["branches"]}
    check(stats["G9b sharded.dfg (after append)"][0] == n_app
          and hits == {f"shard{k}": k != owner for k in range(SHARDS)},
          f"G9b rescanned {stats['G9b sharded.dfg (after append)'][0]} rows; "
          f"shard hits {hits}")
    log(f"  appends: {n_app} rows on the live copy, resumed over exactly "
        f"{n_app} rows (delta); {n_app} rows on residue {owner} of the "
        f"sharded log, only shard{owner} rescanned ({n_app} rows); both Ψ "
        f"== host oracles ({oracle_s:.2f} s)")

    log(f"service requests' launches: {counts_now()}")
    for name, _ in requests:
        o = out[name]
        p = probes.get(name)
        engine_s = (f" (engine {o['wall_s']:.4f} s)" if "wall_s" in o
                    else "")
        log(f"  {name}: wall {walls[name]:.4f} s{engine_s}, launches "
            f"{launched[name]}, backend {o.get('backend')}, from_cache "
            f"{o.get('from_cache')}, rows {stats[name][0]}"
            + (f"; probe {p.backend} cached={p.cached} delta={p.delta_hint} "
               f"est {p.estimated_cost_s:.4f} s" if p else ""))

    # -- tracing overhead: warm dices, trace on (the service's engine) and
    # off, interleaved; the trace-off engine attaches no trace
    off = QueryEngine(trace=False)
    qc_on, qc_off = Q.log(canary).using(engine), Q.log(canary).using(off)
    t_c = float(canary.event_time.min())
    on_s, off_s = [], []
    first_on = first_off = None
    for name in ("O trace-on dices", "O trace-off dices"):
        launched[name] = {}
    for i in range(OVERHEAD_DICES):
        w = (t_c, t_c + 30 * DAY + i)
        for q, acc, name in ((qc_on, on_s, "O trace-on dices"),
                             (qc_off, off_s, "O trace-off dices")):
            before = counts_now()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = q.window(*w).dfg()
            torch.cuda.synchronize()
            acc.append(time.perf_counter() - t0)
            after = counts_now()
            for k in after:
                if after[k] != before[k]:
                    launched[name][k] = launched[name].get(k, 0) \
                        + after[k] - before[k]
            check(not r.from_cache and r.physical.backend == "kernel"
                  and r.physical.fused_dicing, f"dice {i}: "
                  f"{r.physical.describe()}")
            if q is qc_on and first_on is None:
                first_on = r
            if q is qc_off and first_off is None:
                first_off = r
    check(first_off.trace is None and first_on.trace is not None
          and np.array_equal(first_on.value, first_off.value),
          "trace=False: a trace was attached or the Ψ differs")
    check("matched prediction" in qc_on.window(
        t_c, t_c + 30 * DAY).explain(after=first_on)
        and "none recorded" in qc_off.window(t_c, t_c + 30 * DAY).explain(
            after=first_off), "explain(after=) of the dices")
    text = ql.window(*w30).explain()
    check(text.splitlines()[0].startswith("logical : memmap → Window"),
          f"explain: {text}")
    med_on, med_off = float(np.median(on_s)), float(np.median(off_s))
    counts_3g = counts_now()
    log(f"service launches: {counts_3g} (predicted {PREDICTED_3G})")
    check(launched == PREDICTED_3G_QUERIES,
          f"phase 3g per-request launches {launched} differ from the "
          f"prediction {PREDICTED_3G_QUERIES}")
    check(counts_3g == PREDICTED_3G,
          f"phase 3g launches {counts_3g} differ from the prediction "
          f"{PREDICTED_3G}")

    # -- the trace store, read back as an event log -------------------------
    t0 = time.perf_counter()
    store_repo = store.to_repository()
    mined = Q.log(store_repo).using(engine).dfg()
    ss, ds, vs = store_repo.df_pairs()
    check(store_repo.num_events > 0 and np.array_equal(
        mined.value, dfg_numpy(ss, ds, vs, store_repo.num_activities))
        and mined.names == store_repo.activity_names,
        "the trace store's Ψ differs from numpy's DFG of its spans")
    store.close()
    log(f"  trace store: {len(store)} traces kept, read back as "
        f"{store_repo.num_events} span events of {store_repo.num_traces} "
        f"trace nodes; mined on {mined.physical.backend}, Ψ == numpy "
        f"({time.perf_counter() - t0:.3f} s)")

    snap = engine.metrics_snapshot()
    drift = {k[len("planner_drift_total{backend="):-1]: v
             for k, v in snap.items() if k.startswith("planner_drift_total")}
    log(f"  planner_drift_total by backend: {drift} (drift band "
        f"{engine.drift_ratio}x, floor {engine.drift_min_s} s)")
    log(f"  tracing overhead [{card}]: warm 30-day dice on canary "
        f"({canary.num_events} events), {OVERHEAD_DICES} each, interleaved: "
        f"median trace on {med_on:.6f} s (service engine, trace store on), "
        f"off {med_off:.6f} s, ratio {med_on / med_off:.4f}; min "
        f"{min(on_s):.6f} / {min(off_s):.6f}")
    log(f"phase 3g walls [{card}] (s; host clock, card synchronized): "
        + "  ".join(f"{k.split()[0]} {v:.4f}" for k, v in walls.items()))
    total = time.perf_counter() - t_phase
    log(f"phase 3g: {total:.1f} s, of which requests "
        f"{sum(walls.values()):.1f} s, direct checks {direct_s:.1f} s, "
        f"overhead dices {sum(on_s) + sum(off_s):.1f} s")
    # the host oracles phase 3h serves the same requests against
    oracles = {
        "dfg": oracle["G1 prod.dfg"], "w30": w30,
        "dice30": oracle["G2 prod.window(30d).dfg"],
        "pm": {t: oracle[n] for t, n in zip(tops, (
            "G3 prod.process_map(0.2)", "G3b prod.process_map(0.5)",
            "G3c prod.process_map(0.1)"))},
        "alignments": oracle["G5b prod.alignments"],
        "live_rows": live_rows, "live_after": live_after,
    }
    return counts_3g, oracles


# ---------------------------------------------------------------------------
# Phase 3h — the HTTP transport at PAPER_EVAL width
# ---------------------------------------------------------------------------

#: phase 3h's launches and lanes per request, predicted from the code before
#: its first run on the card (PERF.md §6).  The card's cost priors
#: (query/planner.py) price a kernel scan at 5.23e-5 s + events / 5.1e6 /s
#: and a graph serve at 5e-5 s + events / 4e8 /s against the static hot
#: cutoff SLO_HOT_CUTOFF_S = 0.05 s (no BENCH_torch_serve.json exists).  H1
#: is the fresh engine's first request: the burst's leader prices prod's
#: cold DFG at 1.41 s (cold lane) and runs one B1; its 31 twins coalesce
#: onto it or hit the cache it filled.  H2 is a cache hit (hot).  A probe
#: prices a plan by its backend and the whole log's events, window or not,
#: so the 30-day dice is priced at 1.41 s too (cold) and fuses the window
#: into one B2.  The first process map is prod's third topology
#: miss, so it builds the graph (one B1 + one B3), yet it is priced as a
#: graph serve (0.018 s, hot lane); the next two read the graph.  The
#: streamed alignments run one B4 on the graph's event tables (graph prior,
#: hot).  The live copy's streaming scan (1.44 s, cold), the append (always
#: cold) and the delta resume (a delta hint, hot) run on the host.  The
#: quota and queue sheds execute nothing; the held 60-day dice on the
#: narrow app (one cold slot) runs one B2 once released; cache hits, the SLO
#: sink and the traced cache hit are hot and launch nothing; the four
#: concurrent dices run one B2 each on the cold lane's two workers.
PREDICTED_3H_QUERIES = {
    "H1 burst of 32 prod.dfg": ({"dfg_count": 1}, "cold"),
    "H2 prod.dfg (again)": ({}, "hot"),
    "H3 prod.window(30d).dfg": ({"dfg_count_diced": 1}, "cold"),
    "H4 prod.process_map(0.2)": ({"dfg_count": 1, "segment_count": 1},
                                 "hot"),
    "H4b prod.process_map(0.5)": ({}, "hot"),
    "H4c prod.process_map(0.1)": ({}, "hot"),
    "H5 stream prod.alignments": ({"align_dp": 1}, "hot"),
    "H6 live.dfg(streaming)": ({}, "cold"),
    "H6a live append": ({}, "cold"),
    "H6b live.dfg(streaming) (delta)": ({}, "hot"),
    "H7 starved tenant": ({}, "hot"),
    "H7b starved tenant (over quota)": ({}, None),
    "H9 slo": ({}, "hot"),
    "H10 traceparent prod.dfg": ({}, "hot"),
    "C four concurrent dices": ({"dfg_count_diced": 4}, "cold"),
    "H8 held prod.window(60d).dfg": ({"dfg_count_diced": 1}, "cold"),
    "H8b prod.window(90d).dfg (shed)": ({}, None),
    "H8c 100 cache hits": ({}, "hot"),
}
PREDICTED_3H = {"dfg_count": 2, "dfg_count_diced": 6, "segment_count": 1,
                "align_dp": 1}
#: identical cold-DFG requests sent at once as the engine's first request
BURST = 32
#: cache hits timed per state of the cold lane (idle, then busy)
HOT_HITS = 50
#: client-side timeout of one HTTP request
HTTP_TIMEOUT_S = 300


def _http(method, url, body=None, headers=None):
    """(status, headers, body bytes, seconds) of one HTTP request."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as f:
            out = (f.status, dict(f.headers), f.read())
    except urllib.error.HTTPError as e:
        with e:
            out = (e.code, dict(e.headers), e.read())
    return (*out, time.perf_counter() - t0)


class _ServedApp:
    """One ``TransportServer`` on 127.0.0.1:0 with its event loop in a thread
    of this process; :meth:`stop` stops the server (closing the app), the
    loop and the thread."""

    def __init__(self, server):
        import asyncio
        import threading

        self.asyncio = asyncio
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="transport-loop", daemon=True)

    def start(self):
        self.thread.start()
        self.asyncio.run_coroutine_threadsafe(self.server.start(),
                                              self.loop).result(60)
        return self

    @property
    def address(self):
        return self.server.address

    def stop(self):
        try:
            if self.thread.is_alive():
                self.asyncio.run_coroutine_threadsafe(
                    self.server.stop(), self.loop).result(120)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(60)
            if not self.thread.is_alive():
                self.loop.close()


def phase_transport(torch, mlog, repo, oracles, card, tmp):
    """The HTTP transport through ``TransportServer`` on 127.0.0.1:0 over one
    ``QueryService`` on a fresh default engine of the card with a trace
    store, at PAPER_EVAL width: the requests H1–H10 and a concurrent burst
    of dices, each payload against phase 3g's host oracles (floored as
    prod's policy says) and the direct ``service.query`` answer, launches
    and lanes against ``PREDICTED_3H``, sheds with Retry-After, the
    Prometheus, SLO, health and readiness endpoints, an inbound traceparent
    found in the store; with the wire's walls, the Ψ body's JSON cost, the
    NDJSON stream's lines and seconds, and the hot lane's p50 / p99 with
    the cold lane idle and busy.  Returns {kernel: launches}."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from repro_torch.core import (
        AccessPolicy,
        MemmapLog,
        dfg_numpy,
        pair_mask_for_window,
    )
    from repro_torch.kernels.align_dp import ops as dp_ops
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops
    from repro_torch.obs import mint_context, parse_traceparent
    from repro_torch.query import QueryEngine, fingerprint
    from repro_torch.query.planner import SLO_HOT_CUTOFF_S
    from repro_torch.serve import QueryService
    from repro_torch.transport import (
        TransportApp,
        TransportConfig,
        TransportServer,
        canonical_payload,
        reassemble_ndjson,
    )

    t_phase = time.perf_counter()
    kernel_ops = (ops, seg_ops, dp_ops)

    def counts_now():
        out = {}
        for m in kernel_ops:
            out.update(m.launch_counts)
        return out

    def delta(before):
        after = counts_now()
        return {k: after[k] - before[k] for k in after
                if after[k] != before[k]}

    class HeldService(QueryService):
        """A QueryService whose ``query`` waits at ``gate`` for the requests
        ``hold`` selects, so a cold request can saturate a lane on cue."""

        def __init__(self, engine):
            super().__init__(engine)
            self.gate = threading.Event()
            self.gate.set()
            self.hold = lambda request: False
            self.held = threading.Event()

        def query(self, request, trace_context=None):
            if self.hold(request):
                self.held.set()
                check(self.gate.wait(timeout=HTTP_TIMEOUT_S),
                      "the held request was never released")
            return super().query(request, trace_context)

    # -- inputs: a fresh copy of prod for the appends --------------------------
    a = mlog.num_activities
    t_min = float(mlog.time[0])
    w30 = oracles["w30"]
    t0 = time.perf_counter()
    w = MemmapLog.create(os.path.join(tmp, "prod_http_live"),
                         mlog.num_events, a, mlog.num_traces,
                         chunk_rows=mlog.chunk_rows)
    w.append(np.asarray(mlog.activity), np.asarray(mlog.case),
             np.asarray(mlog.time))
    live = w.close()
    check(fingerprint(live) == fingerprint(mlog),
          "the live copy's fingerprint differs from prod's")
    live_rows = oracles["live_rows"]
    n_app = int(live_rows[0].shape[0])
    log(f"transport: copied prod's {live.num_events} rows for the live log "
        f"in {time.perf_counter() - t0:.2f} s (host)")

    engine = QueryEngine()
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    svc = HeldService(engine)
    policy = AccessPolicy(min_group_count=PROD_FLOOR)
    svc.register("prod", mlog, policy)
    svc.register("live", live, policy)
    app = TransportApp(svc, TransportConfig(
        trace_dir=os.path.join(tmp, "http_traces")))
    check(app.hot_cutoff_s == SLO_HOT_CUTOFF_S,
          f"hot cutoff {app.hot_cutoff_s}: a calibration record was read")
    app.admission.set_quota("starved", rate=0.001, burst=1.0)
    served = [_ServedApp(TransportServer(app)).start()]
    main = served[0]
    check(main.server.host == "127.0.0.1" and main.server.port > 0,
          f"server bound {main.address}")
    log(f"transport: server on {main.address} (default lanes: "
        f"{app.config.hot_workers} hot / {app.config.cold_workers} cold "
        f"workers); hot cutoff {app.hot_cutoff_s} s (static), trace store "
        f"{app.trace_store.path}")

    w60 = (t_min, t_min + 60 * DAY)
    w90 = (t_min, t_min + 90 * DAY)
    dices = [(t_min, t_min + d * DAY) for d in (7, 14, 21, 45)]
    req = {
        "dfg": {"log": "prod", "sink": "dfg"},
        "dice30": {"log": "prod", "sink": "dfg", "window": list(w30)},
        "pm": {t: {"log": "prod", "sink": "process_map", "top": t}
               for t in (0.2, 0.5, 0.1)},
        "alignments": {"log": "prod", "sink": "alignments"},
        "live": {"log": "live", "sink": "dfg", "backend": "streaming"},
        "append": {"log": "live", "activity": live_rows[0].tolist(),
                   "case": live_rows[1].tolist(),
                   "time": live_rows[2].tolist()},
        "traced": {"log": "prod", "sink": "dfg", "trace": True},
    }
    out, launched, lanes, walls, stats = {}, {}, {}, {}, {}
    t_first = None
    try:
        for m in kernel_ops:
            m.reset_launch_counts()

        def send(name, path, body=None, headers=None, base=None):
            before, s0 = counts_now(), engine.stats
            status, hdrs, raw, secs = _http(
                "POST" if body is not None else "GET",
                (base or main.address) + path, body, headers)
            torch.cuda.synchronize()
            launched[name] = delta(before)
            s1 = engine.stats
            stats[name] = (s1.rows_scanned - s0.rows_scanned,
                           s1.delta_hits - s0.delta_hits,
                           s1.executions - s0.executions)
            lanes[name] = hdrs.get("X-Lane")
            walls[name] = secs
            out[name] = (status, hdrs, raw)
            return status, hdrs, raw

        # the client's first use (urllib's opener, imports) off the burst's
        # clock: a liveness probe touches no engine
        warm_s = max(pool_r[3] for pool_r in ThreadPoolExecutor(
            BURST, thread_name_prefix="warm").map(
            lambda _: _http("GET", main.address + "/healthz"), range(BURST)))

        # H1: the engine's first request, 32 identical cold DFGs at once
        name = "H1 burst of 32 prod.dfg"
        before, s0 = counts_now(), engine.stats
        barrier = threading.Barrier(BURST)

        def one(_):
            barrier.wait(timeout=60)
            return _http("POST", main.address + "/query", req["dfg"])

        t0 = time.perf_counter()
        with ThreadPoolExecutor(BURST, thread_name_prefix="h1") as pool:
            burst = list(pool.map(one, range(BURST),
                                  timeout=HTTP_TIMEOUT_S))
        walls[name] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launched[name] = delta(before)
        s1 = engine.stats
        stats[name] = (s1.rows_scanned - s0.rows_scanned,
                       s1.delta_hits - s0.delta_hits,
                       s1.executions - s0.executions)
        check(all(r[0] == 200 for r in burst),
              f"H1 statuses {sorted({r[0] for r in burst})}")
        bodies = [json.loads(r[2]) for r in burst]
        kinds = []
        for (_, hdrs, _, _), body in zip(burst, bodies):
            if hdrs["X-Coalesced"] == "1":
                kinds.append(f"follower/{hdrs['X-Lane']}")
            elif body["from_cache"]:
                kinds.append(f"hit/{hdrs['X-Lane']}")
            else:
                kinds.append(f"leader/{hdrs['X-Lane']}")
        leaders = [k for k in kinds if k.startswith("leader")]
        check(leaders == ["leader/cold"] and stats[name][2] == 1
              and all(k in ("follower/cold", "follower/hot", "hit/hot")
                      for k in kinds if not k.startswith("leader")),
              f"H1: {sorted(kinds)}, executions {stats[name][2]}")
        lanes[name] = "cold"
        first = canonical_payload(bodies[0])
        check(all(canonical_payload(b) == first for b in bodies),
              "H1: the burst's payloads differ")
        out[name] = (200, burst[0][1], burst[0][2])
        h1_kinds = {k: kinds.count(k) for k in sorted(set(kinds))}
        h1_leader = next(r[1]["X-Trace-Id"] for r, k in zip(burst, kinds)
                         if k.startswith("leader"))
        h1_walls = sorted(r[3] for r in burst)
        h1_engine_s = max(b["wall_s"] for b in bodies)

        send("H2 prod.dfg (again)", "/query", req["dfg"])
        send("H3 prod.window(30d).dfg", "/query", req["dice30"])
        for t, n in zip((0.2, 0.5, 0.1), ("H4 prod.process_map(0.2)",
                                          "H4b prod.process_map(0.5)",
                                          "H4c prod.process_map(0.1)")):
            send(n, "/query", req["pm"][t])
        send("H5 stream prod.alignments", "/query/stream", req["alignments"])
        send("H6 live.dfg(streaming)", "/query", req["live"])
        send("H6a live append", "/append", req["append"])
        send("H6b live.dfg(streaming) (delta)", "/query", req["live"])
        send("H7 starved tenant", "/query", req["dfg"],
             {"X-Tenant": "starved"})
        send("H7b starved tenant (over quota)", "/query", req["dfg"],
             {"X-Tenant": "starved"})
        send("H9 slo", "/slo")
        for path in ("/metrics", "/healthz", "/readyz"):
            send(f"H9 {path}", path)
        inbound = mint_context()
        send("H10 traceparent prod.dfg", "/query", req["traced"],
             {"traceparent": inbound.to_traceparent()})

        # C: four distinct dices at once on the cold lane's two workers
        name = "C four concurrent dices"
        before = counts_now()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(dices), thread_name_prefix="c") as pool:
            conc = list(pool.map(
                lambda w: _http("POST", main.address + "/query",
                                {"log": "prod", "sink": "dfg",
                                 "window": list(w)}),
                dices, timeout=HTTP_TIMEOUT_S))
        walls[name] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launched[name] = delta(before)
        lanes[name] = "/".join(sorted({r[1].get("X-Lane") for r in conc}))

        # H8: a second app over the same service with one cold slot (its
        # queue-depth gauges replace the first app's in the shared registry;
        # the counters are shared); the slot is held by a cold request, a
        # second cold request is shed, and the hot lane serves cache hits
        # meanwhile
        narrow = TransportApp(svc, TransportConfig(cold_workers=1,
                                                   max_depth_cold=1))
        served.append(_ServedApp(TransportServer(narrow)).start())
        slim = served[1]
        hits, hit_launches = {}, {}
        for state in ("idle", "busy"):
            if state == "busy":
                before = counts_now()
                svc.hold = lambda r: r.get("window") == list(w60)
                svc.gate.clear()
                holder = ThreadPoolExecutor(1, thread_name_prefix="h8")
                held = holder.submit(
                    _http, "POST", slim.address + "/query",
                    {"log": "prod", "sink": "dfg", "window": list(w60)})
                check(svc.held.wait(timeout=60),
                      "the held request never reached the service")
                check(narrow.scheduler.depth("cold") == 1,
                      f"cold depth {narrow.scheduler.depth('cold')}")
                shed_b = counts_now()
                shed = _http("POST", slim.address + "/query",
                             {"log": "prod", "sink": "dfg",
                              "window": list(w90)})
                launched["H8b prod.window(90d).dfg (shed)"] = delta(shed_b)
                lanes["H8b prod.window(90d).dfg (shed)"] = shed[1].get(
                    "X-Lane")
                out["H8b prod.window(90d).dfg (shed)"] = shed[:3]
                walls["H8b prod.window(90d).dfg (shed)"] = shed[3]
            hb = counts_now()
            rows = [_http("POST", slim.address + "/query", req["dfg"])
                    for _ in range(HOT_HITS)]
            hit_launches[state] = delta(hb)
            check(all(r[0] == 200 and r[1]["X-Lane"] == "hot"
                      and json.loads(r[2])["from_cache"] for r in rows),
                  f"H8c ({state}): a cache hit missed the hot lane")
            if state == "busy":
                check(not held.done()
                      and narrow.scheduler.depth("cold") == 1,
                      "the cold lane drained while the hits ran")
            hits[state] = sorted(r[3] for r in rows)
        lanes["H8c 100 cache hits"] = "hot"
        walls["H8c 100 cache hits"] = sum(map(sum, hits.values()))
        launched["H8c 100 cache hits"] = {
            k: hit_launches["idle"].get(k, 0) + hit_launches["busy"].get(k, 0)
            for k in set(hit_launches["idle"]) | set(hit_launches["busy"])}
        svc.gate.set()
        held_r = held.result(timeout=HTTP_TIMEOUT_S)
        holder.shutdown(wait=True)
        svc.hold = lambda r: False
        torch.cuda.synchronize()
        # the held dice's launches: all since it was sent, less the shed
        # request's and the busy lane's cache hits'
        held_l = delta(before)
        for other in (launched["H8b prod.window(90d).dfg (shed)"],
                      hit_launches["busy"]):
            for k, v in other.items():
                held_l[k] = held_l.get(k, 0) - v
        launched["H8 held prod.window(60d).dfg"] = {
            k: v for k, v in held_l.items() if v}
        lanes["H8 held prod.window(60d).dfg"] = held_r[1].get("X-Lane")
        out["H8 held prod.window(60d).dfg"] = held_r[:3]
        walls["H8 held prod.window(60d).dfg"] = held_r[3]
        counts_3h = counts_now()
        snap_narrow = engine.metrics_snapshot()
    finally:
        svc.gate.set()
        for s_ in reversed(served):
            s_.stop()
    # stopping the main server closed its app and the trace store it shares
    # with the engine: the direct calls below trace nowhere
    engine.trace_store = None
    served_s = time.perf_counter() - t_phase

    # -- statuses, sheds, lanes and launches against the prediction ----------
    status = {n: o[0] for n, o in out.items()}
    want_status = {n: 200 for n in out}
    want_status["H7b starved tenant (over quota)"] = 429
    want_status["H8b prod.window(90d).dfg (shed)"] = 429
    check(status == want_status, f"statuses {status}")
    for n, reason in (("H7b starved tenant (over quota)", "quota"),
                      ("H8b prod.window(90d).dfg (shed)", "queue")):
        _, hdrs, raw = out[n]
        check(float(hdrs["Retry-After"]) > 0
              and json.loads(raw)["retry_after_s"] > 0,
              f"{n}: no Retry-After ({hdrs})")
        check(snap_narrow[f"transport_shed_total{{reason={reason}}}"] >= 1,
              f"transport_shed_total{{reason={reason}}} did not count {n}")
    got = {n: (launched[n], lanes[n]) for n in PREDICTED_3H_QUERIES}
    check(got == PREDICTED_3H_QUERIES,
          f"phase 3h per-request launches and lanes {got} differ from the "
          f"prediction {PREDICTED_3H_QUERIES}")
    check(counts_3h == PREDICTED_3H, f"phase 3h launches {counts_3h} differ "
          f"from the prediction {PREDICTED_3H}")

    # -- each payload: host oracle (floored) and the direct service answer ---
    def body(n):
        raw = out[n][2]
        if n.startswith("H5"):
            return reassemble_ndjson(raw.decode().splitlines())
        return json.loads(raw)

    def value(payload):
        return _value_part(canonical_payload(payload))

    served_reqs = {
        "H1 burst of 32 prod.dfg": (req["dfg"], oracles["dfg"]),
        "H2 prod.dfg (again)": (req["dfg"], oracles["dfg"]),
        "H3 prod.window(30d).dfg": (req["dice30"], oracles["dice30"]),
        "H4 prod.process_map(0.2)": (req["pm"][0.2], oracles["pm"][0.2]),
        "H4b prod.process_map(0.5)": (req["pm"][0.5], oracles["pm"][0.5]),
        "H4c prod.process_map(0.1)": (req["pm"][0.1], oracles["pm"][0.1]),
        "H5 stream prod.alignments": (req["alignments"],
                                      oracles["alignments"]),
        "H6b live.dfg(streaming) (delta)": (req["live"],
                                            oracles["live_after"]),
        "H7 starved tenant": (req["dfg"], oracles["dfg"]),
        "H10 traceparent prod.dfg": (req["traced"], oracles["dfg"]),
    }
    src, dst, valid = repo.df_pairs()
    win_oracle = {}
    for w_ in dices + [w60]:
        psi_w = dfg_numpy(src, dst, valid & pair_mask_for_window(repo, w_), a)
        win_oracle[w_] = {"psi": _floor(np, psi_w, PROD_FLOOR).tolist(),
                          "names": oracles["dfg"]["names"]}
    before = counts_now()
    t0 = time.perf_counter()
    for n, (r, want) in served_reqs.items():
        got_p = body(n)
        direct = svc.query(dict(r))
        check(direct["from_cache"], f"{n}: the direct call missed the cache")
        check(canonical_payload(got_p) == canonical_payload(direct),
              f"{n}: the HTTP payload differs from the direct service answer")
        check(value(got_p) == want,
              f"{n}: the HTTP payload differs from the host oracle")
    for (status_, _, raw, _), w_ in zip(conc, dices):
        direct = svc.query({"log": "prod", "sink": "dfg", "window": list(w_)})
        check(canonical_payload(json.loads(raw)) == canonical_payload(direct)
              and value(json.loads(raw)) == win_oracle[w_],
              f"C: the concurrent {w_[1] - w_[0]:.0f}-s dice differs from "
              "its serial oracle")
    direct = svc.query({"log": "prod", "sink": "dfg", "window": list(w60)})
    check(canonical_payload(json.loads(out["H8 held prod.window(60d).dfg"][2]))
          == canonical_payload(direct)
          and value(direct) == win_oracle[w60],
          "H8: the held dice differs from its oracle")
    check(counts_now() == before, "a direct (cached) call launched a kernel")
    check_s = time.perf_counter() - t0

    # -- the append, the endpoints, the trace --------------------------------
    appended = json.loads(out["H6a live append"][2])
    check(appended["appended"] == n_app
          and appended["num_events"] == mlog.num_events + n_app,
          f"append: {appended}")
    check(stats["H6 live.dfg(streaming)"][0] == mlog.num_events
          and stats["H6b live.dfg(streaming) (delta)"][:2] == (n_app, 1),
          f"live: rows / delta hits {stats['H6 live.dfg(streaming)']} then "
          f"{stats['H6b live.dfg(streaming) (delta)']}")
    prom = out["H9 /metrics"][2].decode()
    check(all(s_ in prom for s_ in (
        "transport_requests_total", "transport_queue_depth",
        "transport_coalesce_groups_total", "request_latency_seconds_bucket",
        'kernel_seconds_count{kernel="dfg_count"}')),
        "/metrics: the exposition lacks the transport or kernel series")
    slo = json.loads(out["H9 slo"][2])
    check({o["name"] for o in slo["objectives"]} == {"warm_latency",
                                                     "availability"},
          f"/slo: {slo}")
    check(json.loads(out["H9 /healthz"][2]) == {"ok": True}
          and json.loads(out["H9 /readyz"][2])["ready"] is True,
          "/healthz or /readyz")
    _, hdrs, raw = out["H10 traceparent prod.dfg"]
    tid = inbound.trace_id
    echoed = parse_traceparent(hdrs["traceparent"])
    traced = json.loads(raw)
    store = app.trace_store
    recs = store.find(tid)
    check(hdrs["X-Trace-Id"] == tid and echoed.trace_id == tid
          and echoed.span_id != inbound.span_id
          and traced["trace_id"] == tid and traced["trace"]["trace_id"] == tid
          and any(r["source"] == "transport" for r in recs)
          and any(r["source"] != "transport" for r in recs),
          f"H10: trace id {tid} not carried through ({hdrs}, "
          f"{len(recs)} records)")
    transport_snap = {
        k: (v if not isinstance(v, dict) else
            {q: v[q] for q in ("count", "p50", "p99")})
        for k, v in sorted(snap_narrow.items())
        if k.startswith(("transport_", "request_latency_seconds"))}

    # -- for the record --------------------------------------------------------
    psi_raw = out["H2 prod.dfg (again)"][2]
    t0 = time.perf_counter()
    decoded = json.loads(psi_raw)
    dec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    json.dumps(decoded)
    enc_s = time.perf_counter() - t0
    cells = len(decoded["psi"]) * len(decoded["psi"][0])
    stream_lines = out["H5 stream prod.alignments"][2].decode().splitlines()
    direct_s = {}
    for n, (r, _) in served_reqs.items():
        t0 = time.perf_counter()
        svc.query(dict(r))
        direct_s[n] = time.perf_counter() - t0
    log(f"transport launches: {counts_3h} (predicted {PREDICTED_3H})")
    log(f"  H1: {BURST} identical requests -> one execution "
        f"(executions +{stats['H1 burst of 32 prod.dfg'][2]}), responses "
        f"{h1_kinds}; the leader's engine query {h1_engine_s:.4f} s; "
        f"responses on the wire after {h1_walls[0]:.4f} (first), "
        f"{h1_walls[BURST // 2]:.4f} (median), {h1_walls[-1]:.4f} s (last); "
        f"{BURST} concurrent /healthz before it (the client's first use) "
        f"{warm_s:.4f} s")
    for n in walls:
        p_lane = lanes.get(n)
        extra = (f", direct service.query {direct_s[n]:.6f} s"
                 if n in direct_s else "")
        if n in out and out[n][0] == 200 and not n.startswith(("H5", "H9")):
            engine_s = json.loads(out[n][2]).get("wall_s")
            if engine_s is not None:
                extra += f", engine {engine_s:.6f} s"
        log(f"  {n}: wire {walls[n]:.6f} s, status "
            f"{out[n][0] if n in out else 200}, lane {p_lane}, launches "
            f"{launched.get(n)}{extra}")
    log(f"  Ψ body [{card}]: {len(psi_raw)} bytes for {cells} cells; "
        f"json.loads {dec_s:.4f} s, json.dumps {enc_s:.4f} s (host)")
    log(f"  NDJSON alignments: {len(stream_lines)} lines "
        f"({len(out['H5 stream prod.alignments'][2])} bytes) in "
        f"{walls['H5 stream prod.alignments']:.4f} s on the wire")
    for state, xs in hits.items():
        log(f"  hot lane, cold lane {state} [{card}]: {HOT_HITS} cache hits "
            f"p50 {xs[len(xs) // 2]:.6f} s, p99 "
            f"{xs[min(len(xs) - 1, int(0.99 * len(xs)))]:.6f} s, max "
            f"{xs[-1]:.6f} s (host clock, on the wire)")
    log(f"  C: {len(dices)} concurrent dices on the "
        f"{sorted({r[1]['X-Lane'] for r in conc})} lane(s) == their host "
        "oracles and the direct answers")
    log(f"  transport series: {transport_snap}")
    log(f"  trace store: {len(store)} traces kept; H10's id {tid} in "
        f"{len(recs)} records")
    # where a request's wire time goes: the transport record's spans (on
    # the loop: probe, admit; on the lane's worker: queue wait, execute =
    # service.query) and the engine record's own time, against the wire
    for n, rid in (("H1 leader", h1_leader),
                   ("H2", out["H2 prod.dfg (again)"][1]["X-Trace-Id"])):
        by_src = {}
        for r in store.find(rid):
            by_src.setdefault(r["source"] == "transport", r)
        t_rec, e_rec = by_src.get(True), by_src.get(False)
        spans = {sp["name"]: sp["duration_s"]
                 for sp in (t_rec or {}).get("spans", [])}
        notes = {k: v for k, v in (e_rec or {}).get("notes", {}).items()
                 if k.endswith("_s")}
        log(f"  {n} split [{card}] (s): transport spans "
            + ", ".join(f"{k} {v:.6f}" for k, v in spans.items())
            + (f"; engine total {e_rec['total_s']:.6f} {notes}"
               if e_rec else ""))
    total = time.perf_counter() - t_phase
    log(f"phase 3h: {total:.1f} s, of which serving {served_s:.1f} s, direct "
        f"checks {check_s:.1f} s")
    return counts_3h


# ---------------------------------------------------------------------------
# Phase 3i — the LM serving path
# ---------------------------------------------------------------------------

#: phase 3i's full-width run (the published gemma2-9b config, nothing cut)
LM_ARCH = "gemma2-9b"
LM_REQUESTS, LM_MAX_NEW = 8, 32
LM_MAX_BATCH, LM_MAX_CACHE, LM_Q_CHUNK = 4, 1024, 64
LM_PROMPT_LENS = (16, 512)  # uniform, numpy.random.default_rng(0)
#: the reference's decode-matches-forward tolerance
#: (``tests/test_models_smoke.py``: rtol 2e-2, atol 2e-2)
LM_DECODE_TOL = 2e-2
#: the CPU tests' f32 tolerance (``tests/test_torch_models.py``)
LM_F32_TOL = 1e-4
#: launches of phase 3i: one B1 for ``mine_telemetry()`` and one B2 for
#: ``mine_telemetry(time_window=...)`` on the ``tiny_pairs=0`` engine
PREDICTED_3I = {"dfg_count": 1, "dfg_count_diced": 1, "segment_count": 0,
                "align_dp": 0}


def _events_psi(np, collector, names, window=None):
    """Directly-follows counts of the collector's own events (per case,
    stably by time; with a window both endpoints in [t0, t1))."""
    events = sorted(zip(collector._cases, collector._times,
                        range(len(collector)), collector._activities))
    psi = np.zeros((len(names), len(names)), np.int64)
    for (c0, t0, _, a), (c1, t1, _, b) in zip(events, events[1:]):
        if c0 != c1:
            continue
        if window is None or (window[0] <= t0 < window[1]
                              and window[0] <= t1 < window[1]):
            psi[names.index(a), names.index(b)] += 1
    return psi


def _reduced_on_card(torch, np, arch):
    """``arch``'s ``.reduced()`` config in f32: prefill (ragged) and four
    vector-position decode steps on the card and, with the same weights on
    the host, on the CPU.  Returns the largest |card − host| over logits and
    caches, and the largest |host| logit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.model import DecoderLM

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    gpu = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    cpu = DecoderLM(cfg, None, "meta").to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(0)
    b, s = 3, 13
    lens = np.array([13, 7, 10])
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s))}
    prefix = 0
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
        prefix = cfg.n_patches
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    steps = rng.integers(0, cfg.vocab_size, size=(4, b, 1))
    outs = {}
    for where, dev, model in (("card", "cuda", gpu), ("host", "cpu", cpu)):
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        caches, logits = prefill(
            cfg, model, tb, 32, q_chunk=4, cache_dtype=torch.float32,
            last_index=torch.as_tensor(prefix + lens - 1, device=dev))
        seq = [logits]
        for i, t in enumerate(steps):
            logits, caches = decode_step(
                cfg, model, torch.as_tensor(t, device=dev), caches,
                torch.as_tensor(prefix + lens + i, device=dev))
            seq.append(logits)
        flat = list(seq)
        for unit in caches:
            for entry in unit.values():
                for v in entry.values():
                    flat.extend(v.values() if isinstance(v, dict) else [v])
        outs[where] = [x.float().cpu().numpy() for x in flat]
    worst = 0.0
    for g, c in zip(outs["card"], outs["host"]):
        check(g.shape == c.shape and bool(np.isfinite(g).all()),
              f"{arch}: card output {g.shape} vs host {c.shape}")
        excess = np.abs(g - c) - (LM_F32_TOL + LM_F32_TOL * np.abs(c))
        check(float(excess.max()) <= 0.0,
              f"{arch}: card and host differ by {np.abs(g - c).max():.3g} "
              f"(tolerance atol = rtol = {LM_F32_TOL})")
        worst = max(worst, float(np.abs(g - c).max()))
    return worst, float(np.abs(outs["host"][0]).max())


def _logits_product_ms(torch, h, w):
    """The f32 logits product at the tied embedding's shape both ways: the
    bf16-in / f32-out GEMM the port uses, and an f32 GEMM of upcast
    operands (TF32 off), CUDA events over 20 calls each."""
    out = {}
    w = w.detach()  # the model's parameters take gradients
    cases = {
        "bf16_in_f32_out": lambda: torch.mm(h, w.t(), out_dtype=torch.float32),
        "upcast_f32": lambda: h.float() @ w.float().t(),
    }
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / 20
    diff = float((cases["bf16_in_f32_out"]() - cases["upcast_f32"]())
                 .abs().max())
    return out, diff


def _decode_and_prefill(torch, cfg, params, prompt, tok):
    """Logits of ``tok`` decoded after a prefill of ``prompt`` (f32 caches),
    and the last-position logits of a prefill of ``prompt + [tok]``."""
    from repro_torch.models import decode_step, prefill

    s = len(prompt)
    caches, _ = prefill(cfg, params,
                        {"tokens": torch.tensor([prompt], device="cuda")},
                        s + 1, q_chunk=LM_Q_CHUNK, cache_dtype=torch.float32)
    dec, _ = decode_step(cfg, params, torch.tensor([[tok]], device="cuda"),
                         caches, s)
    _, par = prefill(cfg, params,
                     {"tokens": torch.tensor([prompt + [tok]], device="cuda")},
                     s + 2, q_chunk=LM_Q_CHUNK, cache_dtype=torch.float32)
    return dec.float().cpu().numpy(), par.float().cpu().numpy()


def _decode_profile(torch, cfg, params, prompts, steps=4):
    """Four decode steps of one wave under ``torch.profiler``: ms per step
    (profiled), the device's busy share of that wall (the kernels' summed
    device time over it; None when the profiler records no device time),
    and the kernels launched."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, prefill

    lens = np.array([len(p) for p in prompts])
    toks = np.zeros((len(prompts), int(lens.max())), np.int64)
    for r, p in enumerate(prompts):
        toks[r, :len(p)] = p
    caches, logits = prefill(
        cfg, params, {"tokens": torch.as_tensor(toks, device="cuda")},
        LM_MAX_CACHE, q_chunk=LM_Q_CHUNK,
        last_index=torch.as_tensor(lens - 1, device="cuda"))
    pos = torch.as_tensor(lens, device="cuda")
    nxt = logits.argmax(-1)[:, None]
    logits, caches = decode_step(cfg, params, nxt, caches, pos)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            nxt = logits.argmax(-1)[:, None]
            logits, caches = decode_step(cfg, params, nxt, caches,
                                         pos + 1 + i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us, kernels = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            device_us += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
            kernels += e.count
    busy = device_us / 1e6 / wall if device_us else None
    return 1e3 * wall / steps, busy, kernels


def phase_lm_serving(torch, card):
    """The LM serving path: gemma2-9b at its published width and depth
    served by ``ServeEngine`` on the card (8 greedy requests in two waves,
    twice), decode against prefill, every other arch ``.reduced()`` on the
    card against the host, the engine's telemetry mined with B1 and B2, and
    the serving CLI.  Returns {kernel: launches}."""
    import dataclasses
    import statistics

    import numpy as np

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.kernels.align_dp import ops as dp_ops
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import count_params, init_params
    from repro_torch.query import QueryEngine, default_engine, set_default_engine
    from repro_torch.query import execute
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    kernel_ops = (ops, seg_ops, dp_ops)
    for m in kernel_ops:
        m.reset_launch_counts()
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on")
    log(f"f32 matmul precision: {torch.get_float32_matmul_precision()}, "
        f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}; device memory "
        f"held before the phase {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()

    # ---- full width: the published config, nothing cut ---------------------
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == (42, 3584, 256_000),
          f"{LM_ARCH} config is not the published one")
    n_params = count_params(cfg)
    check(n_params == 9_241_705_984, f"{LM_ARCH} counts {n_params} params")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base_alloc
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, params, max_batch=LM_MAX_BATCH,
                         max_cache=LM_MAX_CACHE, q_chunk=LM_Q_CHUNK)
    torch.cuda.synchronize()
    cast_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in engine.params.parameters())
    check(all(p.device.type == "cuda" for p in engine.params.parameters()),
          "a weight is off the card")
    log(f"{LM_ARCH} [{card}]: {n_params:,} parameters, init {init_s:.2f} s "
        f"(f32, peak {init_peak / 1e9:.2f} GB), cast once {cast_s:.2f} s, "
        f"weights on the card {weight_bytes / 1e9:.2f} GB")

    rng = np.random.default_rng(0)
    lens = rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1,
                        size=LM_REQUESTS)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    log(f"prompts: lengths {sorted(int(n) for n in lens)} "
        f"({int(lens.sum())} tokens), max_new_tokens {LM_MAX_NEW}, "
        f"max_batch {LM_MAX_BATCH}, max_cache {LM_MAX_CACHE}, q_chunk "
        f"{LM_Q_CHUNK}")
    t0 = time.perf_counter()
    first = engine.generate(prompts, max_new_tokens=LM_MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    col = engine.collector
    spans = list(zip(col._cases, col._activities, col._durations))
    waves = sorted({c for c, _, _ in spans})
    check(len(waves) == -(-LM_REQUESTS // LM_MAX_BATCH),
          f"served {len(waves)} waves")
    second_engine = ServeEngine(cfg, engine.params, max_batch=LM_MAX_BATCH,
                                max_cache=LM_MAX_CACHE, q_chunk=LM_Q_CHUNK)
    second = second_engine.generate(prompts, max_new_tokens=LM_MAX_NEW)
    check([r.tokens for r in first] == [r.tokens for r in second],
          "the same requests served twice gave other tokens")
    for r in first:
        check(len(r.tokens) == LM_MAX_NEW or r.finished == "stop",
              f"a request ended with {len(r.tokens)} tokens ({r.finished})")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              "a token id out of the vocabulary")
    generated = sum(len(r.tokens) for r in first)
    prefill_s = [d for _, a, d in spans if a == "prefill"]
    decode_ms = [1e3 * d for _, a, d in spans if a == "decode"]
    decode_med = statistics.median(decode_ms)
    cache_bytes = sum(
        2 * LM_MAX_BATCH * LM_MAX_CACHE * cfg.n_kv_heads * cfg.head_dim * 2
        for _ in range(cfg.n_layers))
    bound_ms = 1e3 * (weight_bytes + cache_bytes) / hw.HBM_BW
    log(f"served [{card}]: {len(first)} requests in {len(waves)} waves, "
        f"{generated} tokens in {wall:.3f} s = {generated / wall:.1f} "
        f"tokens/s; prefill per wave {', '.join(f'{s:.4f}' for s in prefill_s)}"
        f" s; decode steps {len(decode_ms)}, median {decode_med:.3f} ms "
        f"(min {min(decode_ms):.3f}, max {max(decode_ms):.3f}) against a "
        f"bytes bound of {bound_ms:.3f} ms (weights {weight_bytes / 1e9:.2f} "
        f"GB + cache {cache_bytes / 1e9:.2f} GB at "
        f"{hw.HBM_BW / 1e12:.2f} TB/s), "
        f"{bound_ms / decode_med * 100:.1f}% of it; served twice, identical "
        f"tokens")

    # decode logits against the last position of a prefill over prompt +
    # token, the full-width weights computed in f32 (the property) and in
    # the served bf16 (where the two paths round differently)
    i = int(np.argmin(lens))
    p, tok = prompts[i], first[i].tokens[0]
    out = {dt: _decode_and_prefill(torch, dataclasses.replace(cfg, dtype=dt),
                                   engine.params, p, tok)
           for dt in ("float32", "bfloat16")}
    (dec32, par32), (dec16, par16) = out["float32"], out["bfloat16"]
    err32, err16 = (float(np.abs(d - q).max()) for d, q in out.values())
    noise16 = float(np.abs(par16 - par32).max())
    check(bool(np.isfinite(dec32).all())
          and bool((np.abs(dec32 - par32)
                    <= LM_DECODE_TOL + LM_DECODE_TOL * np.abs(par32)).all()),
          f"f32 decode logits differ from prefill's by {err32:.3g}")
    check(int(dec16.argmax()) == int(par16.argmax()) == int(par32.argmax()),
          "bf16 decode, bf16 prefill and f32 prefill pick other tokens")
    log(f"decode vs prefill over prompt + token ({len(p)} + 1 tokens, "
        f"{dec32.size} logits, |logit| ≤ {float(np.abs(par32).max()):.3g}): "
        f"f32 compute max |diff| {err32:.4g} (rtol = atol = "
        f"{LM_DECODE_TOL}); bf16 compute {err16:.4g}, where bf16 prefill is "
        f"{noise16:.4g} from f32 prefill; the same argmax in all four")

    step_ms, busy, kernels = _decode_profile(torch, cfg, engine.params,
                                             prompts[:LM_MAX_BATCH])
    log(f"decode profile [{card}] (wave 1's 4 prompts, 4 steps under "
        f"torch.profiler): {step_ms:.3f} ms per step, "
        + (f"device busy {busy * 100:.1f}% (idle {100 - busy * 100:.1f}%), "
           f"{kernels / 4:.0f} kernels per step" if busy is not None
           else "device time not measured (the profiler saw no CUDA "
                "kernel)"))

    h = torch.randn((LM_MAX_BATCH, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1)
                    ).to(torch.bfloat16)
    prod_ms, prod_diff = _logits_product_ms(torch, h, engine.params.embed)
    log(f"logits product (4, {cfg.d_model}) x ({cfg.d_model}, "
        f"{cfg.vocab_size}) [{card}]: bf16-in / f32-out GEMM (the port's) "
        f"{prod_ms['bf16_in_f32_out']:.4f} ms, f32 GEMM of upcast operands "
        f"{prod_ms['upcast_f32']:.4f} ms; max |diff| {prod_diff:.3g}")
    peak = torch.cuda.max_memory_allocated() - base_alloc

    # ---- every other arch, reduced, card against host ------------------------
    t0 = time.perf_counter()
    for arch in sorted(ARCHS):
        if arch == LM_ARCH:
            continue
        worst, scale = _reduced_on_card(torch, np, arch)
        log(f"  {arch}.reduced() f32: card vs host max |diff| {worst:.3g} "
            f"(|logit| ≤ {scale:.3g})")
    log(f"reduced archs on the card: {time.perf_counter() - t0:.1f} s")

    # ---- the engine's telemetry, mined with B1 and B2 ----------------------
    repo = col.to_repository()
    check(repo.num_traces == len(waves),
          f"{repo.num_traces} traces for {len(waves)} waves")
    as_is = engine.mine_telemetry()
    log(f"mine_telemetry() on the default engine as it is: backend "
        f"{as_is.physical.backend} ({len(col)} spans, tiny_pairs "
        f"{default_engine().tiny_pairs})")
    previous = execute._DEFAULT
    mining = QueryEngine(tiny_pairs=0)
    check(mining.tiny_pairs == 0, f"tiny_pairs=0 became {mining.tiny_pairs}")
    set_default_engine(mining)
    try:
        plain = engine.mine_telemetry()
        times = sorted(col._times)
        window = (times[5], times[-5])
        diced = engine.mine_telemetry(time_window=window)
    finally:
        set_default_engine(previous)
    check(plain.physical.backend == "kernel"
          and diced.physical.backend == "kernel"
          and diced.physical.fused_dicing,
          f"telemetry plans {plain.physical.describe()} / "
          f"{diced.physical.describe()}")
    names = list(plain.names)
    for res, tw in ((as_is, None), (plain, None), (diced, window)):
        want = _events_psi(np, col, names, tw)
        check(list(res.names) == names
              and np.array_equal(np.asarray(res.value), want),
              f"telemetry Ψ (window {tw}) differs from the collector's count")
    pi, di = names.index("prefill"), names.index("decode")
    psi = np.asarray(plain.value)
    check(psi[pi, di] == len(waves) and psi[di, di] >= 1,
          f"telemetry Ψ prefill→decode {psi[pi, di]}, decode→decode "
          f"{psi[di, di]}")
    counts = {}
    for m in kernel_ops:
        counts.update(m.launch_counts)
    check(counts == PREDICTED_3I,
          f"phase 3i launches {counts} differ from {PREDICTED_3I}")
    log(f"telemetry: {repo.num_traces} traces, Ψ prefill→decode "
        f"{psi[pi, di]}, decode→decode {psi[di, di]}; windowed Ψ sum "
        f"{int(np.asarray(diced.value).sum())} of {int(psi.sum())}; "
        f"launches {counts}")
    del engine, second_engine, params
    torch.cuda.empty_cache()

    # ---- the CLI, in-process -------------------------------------------------
    summary = serve_cli.main(["--arch", LM_ARCH, "--requests", "6"])
    check(summary["requests"] == 6 and summary["generated_tokens"] > 0,
          f"serve CLI: {summary}")
    log(f"phase 3i [{card}]: {time.perf_counter() - t_phase:.1f} s; peak "
        f"device memory of the full-width run "
        f"{peak / 1e9:.2f} GB above the {base_alloc / 1e9:.2f} GB held "
        f"before (torch.cuda.max_memory_allocated)")
    return counts


# ---------------------------------------------------------------------------
# Phase 3j — the LM training path
# ---------------------------------------------------------------------------

#: phase 3j's full-width run: starcoder2-3b at its published width and depth
#: (``configs/starcoder2_3b.py``), ``train_4k``'s sequence length, one card's
#: batch of 2 (``train_4k``'s global batch of 256 cut), 8 steps
TRAIN_ARCH = "starcoder2-3b"
TRAIN_PARAMS = 3_029_523_456
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 2, 4096
#: ``TrainHParams``' default peak learning rate; the CLI's default 3e-3 is
#: the tiny preset's
TRAIN_LR = 3e-4
#: the first loss sits within this of ln V + d_model · 0.02² / 2: random
#: N(0, 0.02²) tied embeddings against a unit-RMS final state give logits
#: of variance d_model · 0.02², whose log-sum-exp adds half of it to ln V
TRAIN_FIRST_LOSS_TOL = 0.5
#: step 0's loss in f32 and in bf16 compute, relative
TRAIN_DTYPE_RTOL = 2e-2
#: the CPU tests' f32 tolerance, card against host
TRAIN_F32_TOL = 1e-4
#: launches of phase 3j: one B1 for the CLI's ``--mine`` and one B2 for a
#: windowed DFG of the trainer's log on a ``tiny_pairs=0`` engine
PREDICTED_3J = {"dfg_count": 1, "dfg_count_diced": 1, "segment_count": 0,
                "align_dp": 0}


def _train_flops(cfg, batch, seq):
    """FLOPs of one training step of ``cfg`` under ``remat="full"``: the
    matrix products (every matrix but the embedding gather, plus the tied
    vocabulary product) and the causal attention's two products, each run
    forward, again in the backward's recompute (units and loss chunks), and
    twice in the backward."""
    from repro_torch.models.model import DecoderLM

    model = DecoderLM(cfg, None, "meta")
    tokens = batch * seq
    mats = sum(p.numel() for n, p in model.named_parameters()
               if p.dim() >= 2 and n != "embed")
    vocab = cfg.vocab_size * cfg.d_model
    window = min(cfg.window or seq, seq)
    pairs = sum(min(i + 1, window) for i in range(seq))  # causal (q, k)
    attn = 2 * 2 * batch * cfg.n_heads * cfg.head_dim * pairs * cfg.n_layers
    forward = 2 * tokens * (mats + vocab) + attn
    return 4 * forward, mats + vocab


#: kernel-name fragments (lower case) of the step profile's classes, the
#: first match wins; the rest is "other"
KERNEL_CLASSES = (
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "wgmma")),
    ("softmax", ("softmax", "cunn_soft")),
    ("copy", ("memcpy", "copy")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def _train_step_profile(torch, cfg, params, batch):
    """One bf16 loss + backward of step 0 under ``torch.profiler``
    (:func:`_device_profile`)."""
    from repro_torch.models import train_loss

    out = _device_profile(
        torch, lambda: train_loss(cfg, params, batch, q_chunk=1024).backward())
    params.zero_grad(set_to_none=True)
    return out


def _device_profile(torch, run):
    """``run()`` once under ``torch.profiler``: the wall (profiled), the
    device's busy share (the kernels' summed device time over the wall;
    None when the profiler records no device time), the kernel count, the
    device time by class of kernel (``KERNEL_CLASSES``, ms) and the five
    kernels with the most device time (name, ms, launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            rows.append((e.key, us / 1e3, e.count))
    total_ms = sum(ms for _, ms, _ in rows)
    if not total_ms:
        return wall, None, 0, {}, []
    classes = {}
    for key, ms, _ in rows:
        name = next((c for c, frags in KERNEL_CLASSES
                     if any(f in key.lower() for f in frags)), "other")
        classes[name] = classes.get(name, 0.0) + ms
    top = sorted(rows, key=lambda r: -r[1])[:5]
    return (wall, total_ms / 1e3 / wall, sum(n for _, _, n in rows),
            classes, top)


def _reduced_training_on_card(torch, np, arch, tmp):
    """``arch``'s ``.reduced()`` config in f32 with the same weights on the
    card and on the host: the loss and every gradient of one batch, then 3
    ``Trainer`` steps.  Returns the largest |card − host| over the loss,
    gradients and the 3 losses."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainHParams
    from repro_torch.data.lm_data import TokenPipeline
    from repro_torch.models import init_params, train_loss
    from repro_torch.models.model import DecoderLM
    from repro_torch.train import Trainer, init_opt_state

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = TokenPipeline(vocab_size=cfg.vocab_size, batch=2, seq_len=16,
                           seed=3, branching=4)
    rng = np.random.default_rng(0)
    extra = {}
    if cfg.family == "vlm":
        extra["vision_embeds"] = rng.normal(
            size=(2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(
            size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32)

    def data(step):
        return {**tokens(step), **extra}

    def on(dev):
        model = DecoderLM(cfg, None, "meta").to_empty(device=dev)
        model.load_state_dict(host.state_dict())
        return model

    out = {}
    for where, dev in (("card", "cuda"), ("host", "cpu")):
        model = on(dev)
        loss = train_loss(cfg, model, {k: torch.from_numpy(v).to(dev)
                                       for k, v in data(0).items()},
                          q_chunk=8)
        loss.backward()
        flat = [loss.detach()] + [p.grad for p in model.parameters()]
        trainer = Trainer(
            cfg, TrainHParams(learning_rate=3e-3, warmup_steps=2,
                              total_steps=200),
            data, os.path.join(tmp, f"{arch}-{where}"), ckpt_every=50,
            q_chunk=8, device=dev)
        trainer.init_state = lambda m=on(dev): (m, init_opt_state(m))
        hist = trainer.run(3)["history"]
        out[where] = [x.float().cpu().numpy() for x in flat] + [
            np.asarray(hist)]
    worst = 0.0
    for g, c in zip(out["card"], out["host"]):
        check(g.shape == c.shape and bool(np.isfinite(g).all()),
              f"{arch}: card training output {g.shape} vs host {c.shape}")
        excess = np.abs(g - c) - (TRAIN_F32_TOL + TRAIN_F32_TOL * np.abs(c))
        check(float(excess.max()) <= 0.0,
              f"{arch}: card and host training differ by "
              f"{np.abs(g - c).max():.3g} (atol = rtol = {TRAIN_F32_TOL})")
        worst = max(worst, float(np.abs(g - c).max()))
    return worst


def _remat_modes_on_card(torch, np):
    """starcoder2 and jamba ``.reduced()`` in bf16 on the card (the f32
    logits and scores through ``matmul_f32``'s hand-written gradient):
    the loss and every gradient under ``remat`` none, full and dots.
    Returns the number of gradient leaves compared."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import TokenPipeline
    from repro_torch.models import init_params, train_loss

    leaves = 0
    for arch in (TRAIN_ARCH, "jamba-v0.1-52b"):
        base = get_config(arch).reduced()
        params = init_params(base, torch.Generator(device="cuda")
                             .manual_seed(0))
        batch = {k: torch.from_numpy(v).cuda() for k, v in TokenPipeline(
            vocab_size=base.vocab_size, batch=2, seq_len=40, seed=1)(0)
            .items()}
        out = {}
        for remat in ("none", "full", "dots"):
            loss = train_loss(dataclasses.replace(base, remat=remat), params,
                              batch, q_chunk=16)
            loss.backward()
            out[remat] = [loss.detach()] + [p.grad for p in params.parameters()]
            params.zero_grad(set_to_none=True)
        for remat in ("full", "dots"):
            for a, b in zip(out["none"], out[remat]):
                check(torch.equal(a, b), f"{arch} bf16 remat {remat} "
                      "differs from none on the card")
        leaves += len(out["none"]) - 1
    return leaves


def _golden_restart_on_card(torch, tmp):
    """The golden restart on the card: the reduced starcoder2 of
    ``tests/test_trainer_ft.py`` (vocab 64) crashes at step 7, restores
    the step-5 checkpoint and replays; its last 3 losses against an
    uninterrupted run's.  Returns (uninterrupted, restarted) histories."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainHParams
    from repro_torch.data.lm_data import TokenPipeline
    from repro_torch.train import Trainer

    cfg = dataclasses.replace(get_config(TRAIN_ARCH).reduced(),
                              vocab_size=64, loss_chunk=8)
    hp = TrainHParams(learning_rate=3e-3, warmup_steps=2, total_steps=200,
                      grad_clip=1.0)
    data = TokenPipeline(vocab_size=64, batch=2, seq_len=16, seed=3,
                         branching=4)
    crashed = []

    def injector(step):
        if step == 7 and not crashed:
            crashed.append(step)
            raise RuntimeError("injected node failure")

    plain = Trainer(cfg, hp, data, os.path.join(tmp, "golden-plain"),
                    ckpt_every=5, q_chunk=16).run(10)["history"]
    restarted = Trainer(cfg, hp, data, os.path.join(tmp, "golden-ft"),
                        ckpt_every=5, q_chunk=16,
                        failure_injector=injector).run(10)["history"]
    check(crashed == [7] and len(restarted) == 12,
          f"golden restart: crashed {crashed}, {len(restarted)} losses")
    return plain, restarted


def _matmul_f32_grad_on_card(torch):
    """The hand-written gradient of ``matmul_f32`` (bf16-in / f32-out
    GEMMs) on the card against the same products on the host: ``a`` (256,
    3,072), ``b`` (3,072, 4,096), both bf16, a seeded f32 cotangent.
    Returns max |card − host| over both gradients, in bf16 ulps (2⁻⁷) of
    the gradient's largest element (the two sum in other orders, so a
    rounding may land one ulp apart), and the same distance from the
    reference's rule (the f32 cotangent multiplied)."""
    from repro_torch.models.common import matmul_f32

    gen = torch.Generator().manual_seed(5)
    a = torch.randn((256, 3072), generator=gen).to(torch.bfloat16)
    b = (0.02 * torch.randn((3072, 4096), generator=gen)).to(torch.bfloat16)
    g = torch.randn((256, 4096), generator=gen)
    ta = a.cuda().requires_grad_()
    tb = b.cuda().requires_grad_()
    y = matmul_f32(ta, tb)
    check(y.dtype == torch.float32, f"matmul_f32 gave {y.dtype}")
    y.backward(g.cuda())
    gb = g.to(torch.bfloat16).float()
    want = ((gb @ b.float().t()).to(torch.bfloat16),
            (a.float().t() @ gb).to(torch.bfloat16))
    rule = ((g @ b.float().t()).to(torch.bfloat16),
            (a.float().t() @ g).to(torch.bfloat16))
    dist, far = 0.0, 0.0
    for got, w, r in zip((ta.grad, tb.grad), want, rule):
        check(got.dtype == torch.bfloat16, f"gradient dtype {got.dtype}")
        got = got.float().cpu()
        unit = float(w.float().abs().max()) * 2 ** -7
        dist = max(dist, float((got - w.float()).abs().max()) / unit)
        far = max(far, float((got - r.float()).abs().max()) / unit)
    check(dist <= 1.0, f"matmul_f32's card gradient is {dist:.2f} bf16 "
          "ulps from the host's")
    return dist, far


def phase_lm_training(torch, card, tmp):
    """The LM training path: the training CLI on starcoder2-3b at its
    published width and depth (8 steps, S = 4,096, ``--mine``), step 0's
    loss in f32 and bf16 compute, every arch ``.reduced()`` trained on the
    card against the host, the golden restart on the card, ``matmul_f32``'s
    hand-written gradient, and the trainer's telemetry mined with B1 and
    B2.  Returns {kernel: launches}."""
    import dataclasses
    import math
    import statistics

    import numpy as np

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.core.telemetry import EventCollector
    from repro_torch.data.lm_data import TokenPipeline
    from repro_torch.kernels.align_dp import ops as dp_ops
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import count_params, init_params, train_loss
    from repro_torch.query import Q, QueryEngine
    from repro_torch.train import global_norm

    t_phase = time.perf_counter()
    kernel_ops = (ops, seg_ops, dp_ops)
    for m in kernel_ops:
        m.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    log(f"device memory held before the phase {base_alloc / 1e9:.2f} GB")

    # ---- the CLI at full width -----------------------------------------------
    cfg = get_config(TRAIN_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size, cfg.window, cfg.tie_embeddings)
          == (30, 3072, 24, 2, 12288, 49152, 4096, True)
          and cfg.remat == "full" and cfg.loss_chunk == 512,
          f"{TRAIN_ARCH} config is not the published one")
    n_params = count_params(cfg)
    check(n_params == TRAIN_PARAMS, f"{TRAIN_ARCH} counts {n_params} params")
    collector = EventCollector("trainer")
    ckpt_dir = os.path.join(tmp, "train-full")
    argv = ["--arch", TRAIN_ARCH, "--preset", "full",
            "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--mine",
            "--ckpt-dir", ckpt_dir]
    log(f"repro_torch.launch.train {' '.join(argv)} (q_chunk 1024, "
        f"loss_chunk {cfg.loss_chunk}, remat {cfg.remat}, f32 master "
        f"weights, {cfg.dtype} compute; ckpt_every 50 > {TRAIN_STEPS} steps: "
        f"a checkpoint of params + mu + nu would write "
        f"{3 * 4 * n_params / 1e9:.1f} GB)")
    t0 = time.perf_counter()
    summary = train_cli.main(argv, collector=collector)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_alloc
    check(summary["params"] == TRAIN_PARAMS and summary["device"] == "cuda",
          f"train CLI summary {summary['params']} on {summary['device']}")
    check(not os.path.exists(ckpt_dir) or not os.listdir(ckpt_dir),
          "the full-width run wrote a checkpoint")
    hist = summary["history"]
    expect = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    check(summary["steps"] == TRAIN_STEPS and len(hist) == TRAIN_STEPS
          and all(math.isfinite(x) for x in hist),
          f"train CLI losses {hist}")
    check(abs(hist[0] - expect) <= TRAIN_FIRST_LOSS_TOL,
          f"first loss {hist[0]:.4f}, expected {expect:.4f} ± "
          f"{TRAIN_FIRST_LOSS_TOL}")
    check(hist[-1] < hist[0], f"the loss did not fall: {hist}")
    after_cli = {}
    for m in kernel_ops:
        after_cli.update(m.launch_counts)
    check(after_cli.get("dfg_count") == 1,
          f"--mine launched {after_cli} (one dfg_count expected)")
    step_s = [d for a, d in zip(collector._activities, collector._durations)
              if a == "train_step"]
    med = statistics.median(step_s)
    flops, _ = _train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    bound_s = flops / hw.PEAK_FLOPS_BF16
    adam_bytes = 28 * n_params  # read p, g, mu, nu; write p, mu, nu (f32)
    log(f"{TRAIN_ARCH} [{card}]: {n_params:,} parameters; CLI "
        f"{cli_s:.2f} s for {TRAIN_STEPS} steps of {TRAIN_BATCH} × "
        f"{TRAIN_SEQ} tokens; losses {', '.join(f'{x:.4f}' for x in hist)} "
        f"(ln V = {math.log(cfg.vocab_size):.4f}, expected first "
        f"{expect:.4f}, bigram floor {summary['bigram_entropy_floor']:.4f})")
    log(f"train_step [{card}]: first {step_s[0]:.4f} s, median {med:.4f} s "
        f"(min {min(step_s):.4f}, max {max(step_s):.4f}); FLOP bound "
        f"{flops:.4g} FLOP / {hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16 = "
        f"{bound_s:.4f} s, {bound_s / med * 100:.1f}% of the median "
        f"({flops / med / 1e12:.1f} TFLOP/s); AdamW's bytes "
        f"{adam_bytes / 1e9:.1f} GB / {hw.HBM_BW / 1e12:.2f} TB/s = "
        f"{adam_bytes / hw.HBM_BW:.4f} s; peak device memory "
        f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated)")

    # ---- step 0's loss in f32 and bf16 compute --------------------------------
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenPipeline(
        vocab_size=cfg.vocab_size, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        seed=17)(0).items()}
    first = {}
    for dt in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        loss = train_loss(dataclasses.replace(cfg, dtype=dt), params, batch,
                          q_chunk=1024)
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in params.named_parameters()}
        norms = {n: float(g.float().norm()) for n, g in grads.items()}
        top = max(norms, key=norms.get)
        first[dt] = (float(loss.detach()), float(global_norm(grads)), top,
                     norms[top],
                     time.perf_counter() - t0)
        params.zero_grad(set_to_none=True)
        del loss, grads
    (l16, n16, top16, v16, s16), (l32, n32, top32, v32, s32) = (
        first["bfloat16"], first["float32"])
    check(abs(l32 - l16) <= TRAIN_DTYPE_RTOL * abs(l32),
          f"step 0 loss f32 {l32:.5f} vs bf16 {l16:.5f}")
    log(f"step 0 [{card}]: init {init_s:.2f} s (seed 0, f32 on the card); "
        f"loss bf16 {l16:.5f} (the CLI's {hist[0]:.5f}, |diff| "
        f"{abs(l16 - hist[0]):.3g}), f32 {l32:.5f}, relative "
        f"{abs(l32 - l16) / abs(l32):.3g} (≤ {TRAIN_DTYPE_RTOL}); grad norm "
        f"bf16 {n16:.4f}, f32 {n32:.4f}; largest leaf {top16} {v16:.4f} "
        f"(f32: {top32} {v32:.4f}); loss + backward {s16:.2f} s bf16, "
        f"{s32:.2f} s f32")
    wall, busy, n_kernels, classes, top = _train_step_profile(
        torch, cfg, params, batch)
    if busy is None:
        log(f"step 0 profile [{card}]: device time not measured (the "
            "profiler saw no CUDA kernel)")
    else:
        log(f"step 0 profile [{card}] (bf16 loss + backward under "
            f"torch.profiler): {wall:.3f} s, device busy {busy * 100:.1f}% "
            f"(idle {100 - busy * 100:.1f}%), {n_kernels} kernels; device "
            "ms by class: " + ", ".join(
                f"{c} {ms:.1f}" for c, ms in sorted(
                    classes.items(), key=lambda kv: -kv[1]))
            + "; top: " + "; ".join(f"{k[:48]} {ms:.1f} ms × {n}"
                                    for k, ms, n in top))
    del params, batch
    torch.cuda.empty_cache()

    # ---- matmul_f32's gradient, reduced archs, the golden restart -------------
    dist, far = _matmul_f32_grad_on_card(torch)
    log(f"matmul_f32 gradient [{card}] (256 × 3,072 · 3,072 × 4,096 bf16): "
        f"max |diff| {dist:.3g} bf16 ulps of the largest element from the "
        f"host's products, {far:.3g} from the reference's rule (the f32 "
        f"cotangent multiplied)")
    t0 = time.perf_counter()
    for arch in sorted(ARCHS):
        worst = _reduced_training_on_card(torch, np, arch, tmp)
        log(f"  {arch}.reduced() f32 training: card vs host max |diff| "
            f"{worst:.3g}")
    log(f"reduced archs trained on the card: {time.perf_counter() - t0:.1f} s")
    leaves = _remat_modes_on_card(torch, np)
    log(f"remat none / full / dots on the card (starcoder2, jamba "
        f".reduced(), bf16): the same loss and {leaves} gradient leaves, "
        f"bit for bit")
    plain, restarted = _golden_restart_on_card(torch, tmp)
    check(restarted[-3:] == plain[-3:],
          f"golden restart on the card: {restarted[-3:]} vs {plain[-3:]}")
    log(f"golden restart [{card}]: crash at 7, restore 5, last 3 losses "
        f"equal bit for bit ({', '.join(f'{x:.6f}' for x in plain[-3:])})")

    # ---- the trainer's telemetry, mined with B1 and B2 ------------------------
    repo = collector.to_repository()
    names = list(summary["mined"]["activities"])
    psi = np.asarray(summary["mined"]["psi"])
    check(names == list(repo.activity_names)
          and np.array_equal(psi, _events_psi(np, collector, names)),
          "--mine's Ψ differs from the collector's count")
    li, ti, gi = (names.index(a) for a in ("load_batch", "train_step", "log"))
    check(psi[li, ti] == TRAIN_STEPS and psi[ti, gi] == TRAIN_STEPS
          and repo.num_traces == TRAIN_STEPS,
          f"telemetry Ψ load→train {psi[li, ti]}, train→log {psi[ti, gi]}")
    times = sorted(collector._times)
    window = (times[2], times[-2])
    diced = (Q.log(repo).using(QueryEngine(tiny_pairs=0))
             .window(*window).dfg())
    check(diced.physical.backend == "kernel" and diced.physical.fused_dicing,
          f"windowed telemetry plan {diced.physical.describe()}")
    want = _events_psi(np, collector, list(diced.names), window)
    check(np.array_equal(np.asarray(diced.value), want),
          "windowed telemetry Ψ differs from the collector's count")
    counts = {}
    for m in kernel_ops:
        counts.update(m.launch_counts)
    check(counts == PREDICTED_3J,
          f"phase 3j launches {counts} differ from {PREDICTED_3J}")
    log(f"telemetry: {repo.num_traces} traces, {len(collector)} spans, Ψ "
        f"load→train {psi[li, ti]}, train→log {psi[ti, gi]}; windowed Ψ sum "
        f"{int(want.sum())} of {int(psi.sum())}; launches {counts}")
    log(f"phase 3j [{card}]: {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 3k — the sharded LM path, the dry run and the H100 roofline
# ---------------------------------------------------------------------------

#: phase 3k's model: olmoe-1b-7b at its published width (d_model 2,048, 16
#: × 128 heads, 64 experts top-8 of d_ff 1,024, vocab 50,304, QK-norm,
#: untied), 16 layers for prefill and decode; the train steps cut the
#: depth to 4 layers: the step keeps f32 parameters, μ, ν and a gradient
#: sum (16 B a parameter) beside one microbatch's gradients, which at 16
#: layers (6.92 B parameters) is ~138 GB against the card's 80 GB
SHARD_ARCH = "olmoe-1b-7b"
SHARD_LAYERS = 4
SHARD_PARAMS = {16: 6_919_100_416, 4: 1_884_310_528}
#: ``train_4k``'s sequence of 4,096, one card's batch of 2 (``train_4k``'s
#: global batch of 256 cut), the config's 2 microbatches, 3 steps
SHARD_STEPS, SHARD_BATCH, SHARD_SEQ = 3, 2, 4096
#: ``prefill_32k`` / ``decode_32k``'s cache of 32,768 positions: a prompt
#: of 32,760 tokens and 8 decode steps fill it (batch 1)
SERVE_CACHE, SERVE_DECODE = 32_768, 8
#: the dry run's cells, each in a child process under this time limit (the
#: first and the last phase 3l's: ``TP_CELL``, ``TP_WHISPER``)
DRYRUN_CELLS = (("olmoe-1b-7b", "train_4k", "single"),
                ("whisper-tiny", "decode_32k", "multi"),
                ("whisper-tiny", "train_4k", "single"))
DRYRUN_TIMEOUT_S = 300
#: relative tolerance of step 0 against its hand composition if an
#: operator of the step has no deterministic CUDA implementation (named
#: then); bit for bit otherwise
STEP_RTOL = 1e-6
#: launches of phase 3k: the LM path runs none of the four kernels
PREDICTED_3K = {"dfg_count": 0, "dfg_count_diced": 0, "segment_count": 0,
                "align_dp": 0}


def _cast_once(torch, cfg, name, t):
    """The step's ``cast_params_once`` rule, written out: a matrix (stacked
    rank ≥ 2: a unit's every leaf, a top-level matrix) outside the MoE
    experts, in bf16."""
    unit = name.startswith(("units.", "enc_units."))
    if (cfg.cast_params_once and "moe" not in name.split(".")
            and t.dim() + unit >= 2):
        return t.to(torch.bfloat16)
    return t


def _hand_train_step(torch, cfg, hp, params, batch, k, dist_ctx):
    """Step 0 composed by hand from the port's parts: ``train_loss`` of
    each of the ``k`` microbatches on a module of the cast leaves, the
    mean of the losses and of the f32 gradients, then ``adamw_update`` on
    the f32 parameters.  Returns (loss, grad norm, {name: (param, mu, nu)}
    on the host)."""
    from repro_torch.models import train_loss
    from repro_torch.models.model import DecoderLM
    from repro_torch.train.optimizer import adamw_update, init_opt_state

    named = dict(params.named_parameters())
    model = DecoderLM(cfg, None, "meta")
    model.load_state_dict({n: _cast_once(torch, cfg, n, p.detach())
                           for n, p in named.items()}, assign=True)
    lsum = torch.zeros((), dtype=torch.float32, device="cuda")
    gsum = {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in named.items()}
    for i in range(k):
        mb = {key: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))[i]
              for key, v in batch.items()}
        model.zero_grad(set_to_none=True)
        loss = train_loss(cfg, model, mb, q_chunk=1024, dist=dist_ctx)
        loss.backward()
        lsum = lsum + loss.detach()
        for n, p in model.named_parameters():
            gsum[n].add_(p.grad.float())
    model.zero_grad(set_to_none=True)
    del model
    loss = lsum / k
    for g in gsum.values():
        g.div_(k)
    opt = init_opt_state(params)
    _, opt, metrics = adamw_update(hp, params, gsum, opt)
    del gsum
    host = {n: (p.detach().cpu(), opt.mu[n].cpu(), opt.nu[n].cpu())
            for n, p in params.named_parameters()}
    return loss.cpu(), metrics["grad_norm"].cpu(), host


def _dryrun_start(arch, shape, mesh, out_dir):
    """``python -m repro_torch.launch.dryrun`` for one cell, started in a
    child process on the host (read with :func:`_dryrun_read`)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--tag", "chip_smoke", "--out",
         out_dir], env=env, cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _dryrun_read(proc, arch, shape, mesh, out_dir, t0):
    """The artifact of a dry run that :func:`_dryrun_start` started, with
    its wall from ``t0``."""
    _, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    check(proc.returncode == 0, f"dry run {arch} × {shape} × {mesh}: {err[-2000:]}")
    tag = "16x16" if mesh == "single" else "2x16x16"
    with open(os.path.join(out_dir, f"{arch}__{shape}__{tag}__chip_smoke.json")) as f:
        art = json.load(f)
    art["wall_s"] = time.perf_counter() - t0
    return art


def _dryrun_cells(cells, out_dir):
    """The dry runs of ``cells`` (arch, shape, mesh), in child processes
    on the host side by side; returns {cell: its artifact}, each with its
    wall from their common start."""
    t0 = time.perf_counter()
    procs = {cell: _dryrun_start(*cell, out_dir) for cell in cells}
    try:
        return {cell: _dryrun_read(proc, *cell, out_dir, t0)
                for cell, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def phase_sharded_lm(torch, card, tmp):
    """The sharded LM path on a 1 × 1 ``DeviceMesh`` of a world-1 process
    group: olmoe-1b-7b at full width cut to 4 layers, 3 steps of
    ``make_train_step`` (``DistCtx`` on, so ``_moe_sharded`` runs), step 0
    against its hand composition; at full depth ``make_prefill_step`` and
    8 ``make_decode_step`` steps against ``prefill`` / ``decode_step`` with
    ``dist=None``; the dry run of two cells in child processes.  Returns
    ({kernel: launches}, {(arch, shape, mesh): dry-run artifact})."""
    import dataclasses
    import math
    import statistics
    import warnings

    import numpy as np
    import torch.distributed as dist
    import torch.utils.deterministic

    from repro_torch.configs import get_config, get_shape
    from repro_torch.configs.base import ShapeConfig, TrainHParams
    from repro_torch.data.lm_data import TokenPipeline
    from repro_torch.kernels.align_dp import ops as dp_ops
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import (
        make_decode_step, make_prefill_step, make_train_step,
        train_microbatches,
    )
    from repro_torch.models import count_params, decode_step, init_params, prefill
    from repro_torch.models.moe import DistCtx
    from repro_torch.roofline import model_flops
    from repro_torch.train.optimizer import init_opt_state

    t_phase = time.perf_counter()
    kernel_ops = (ops, seg_ops, dp_ops)
    for m in kernel_ops:
        m.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    log(f"device memory held before the phase {base_alloc / 1e9:.2f} GB")

    full = get_config(SHARD_ARCH)
    check((full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
           full.head_dim, full.n_experts, full.top_k, full.d_ff_expert,
           full.vocab_size, full.qk_norm, full.tie_embeddings,
           full.microbatches)
          == (16, 2048, 16, 16, 128, 64, 8, 1024, 50304, True, False, 2),
          f"{SHARD_ARCH} config is not the published one")
    cfg = dataclasses.replace(full, n_layers=SHARD_LAYERS)
    n_full, n_cut = count_params(full), count_params(cfg)
    check({16: n_full, SHARD_LAYERS: n_cut} == SHARD_PARAMS,
          f"{SHARD_ARCH} counts {n_full} / {n_cut} parameters")
    k = train_microbatches(cfg)
    check(k == 2, f"{k} microbatches")
    hp = TrainHParams()
    shape = ShapeConfig("train_4k", SHARD_SEQ, SHARD_BATCH, "train")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=SHARD_BATCH,
                         seq_len=SHARD_SEQ, seed=17)
    batches = [{key: torch.from_numpy(v).cuda() for key, v in pipe(s).items()}
               for s in range(SHARD_STEPS)]

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    was_filling = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    # every output is written before it is read: no NaN fill of new memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(tmp, "pg-3k"),
        world_size=1, rank=0)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"), device_type="cuda")
        check(type(mesh).__name__ == "DeviceMesh"
              and tuple(mesh.mesh_dim_names) == ("data", "model"),
              f"the 1 × 1 mesh is {mesh!r}")
        dist_ctx = DistCtx(mesh, ("data",), sp_axes=("model",))

        # ---- step 0 by hand, then the step builder's 3 steps --------------
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
            t0 = time.perf_counter()
            h_loss, h_norm, hand = _hand_train_step(
                torch, cfg, hp, params, batches[0], k, dist_ctx)
            hand_s = time.perf_counter() - t0
            del params
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
            opt = init_opt_state(params)
            fn, in_sh, out_sh, _, donate = make_train_step(cfg, shape, mesh, hp)
            check(donate == (0, 1), f"train step donates {donate}")
            losses, step_s, norms = [], [], []
            for step in range(SHARD_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, loss, metrics = fn(params, opt, batches[step])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(loss))
                norms.append(float(metrics["grad_norm"]))
                if step == 0:
                    s_loss, s_norm = loss.cpu(), metrics["grad_norm"].cpu()
                    worst, unequal = 0.0, 0
                    for n, p in params.named_parameters():
                        for got, want in zip((p.detach(), opt.mu[n], opt.nu[n]),
                                             hand[n]):
                            w = want.cuda()
                            if not torch.equal(got, w):
                                unequal += 1
                                worst = max(worst, float(
                                    ((got - w).abs() / w.abs().clamp_min(1e-30)).max()))
                    del hand
        peak = torch.cuda.max_memory_allocated() - base_alloc
        nondet = sorted({str(w.message).split(" does not have")[0]
                         for w in caught
                         if "deterministic" in str(w.message)})
        if nondet:
            check(unequal == 0 or worst <= STEP_RTOL,
                  f"step 0 vs hand: {unequal} tensors differ, worst relative "
                  f"{worst:.3g} (non-deterministic: {nondet})")
        else:
            check(unequal == 0 and torch.equal(s_loss, h_loss)
                  and torch.equal(s_norm, h_norm),
                  f"step 0 vs hand: {unequal} tensors differ (worst relative "
                  f"{worst:.3g}), loss "
                  f"{float(s_loss)!r} vs {float(h_loss)!r}")
        expect = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
        check(all(math.isfinite(x) for x in losses),
              f"train losses {losses}")
        check(abs(losses[0] - expect) <= TRAIN_FIRST_LOSS_TOL,
              f"first loss {losses[0]:.4f}, expected {expect:.4f} ± "
              f"{TRAIN_FIRST_LOSS_TOL}")
        med = statistics.median(step_s)
        flops = model_flops(cfg, shape)
        bound_s = flops / hw.PEAK_FLOPS_BF16
        adam_bytes = 28 * n_cut  # read p, g, mu, nu; write p, mu, nu (f32)
        log(f"{SHARD_ARCH} at {SHARD_LAYERS} of 16 layers [{card}]: "
            f"{n_cut:,} parameters (16 layers: {n_full:,}); make_train_step "
            f"on the 1 × 1 DeviceMesh (world-1 NCCL group, DistCtx on: "
            f"_moe_sharded, aux all-reduced over a group of 1), {k} "
            f"microbatches of {SHARD_BATCH // k} × {SHARD_SEQ}; losses "
            f"{', '.join(f'{x:.4f}' for x in losses)} (expected first "
            f"{expect:.4f}); grad norms {', '.join(f'{x:.4f}' for x in norms)}")
        log(f"step 0 vs hand [{card}]: "
            + ("bit for bit (loss, grad norm and every parameter, μ and ν; "
               "torch.use_deterministic_algorithms(True))" if not nondet else
               f"{unequal} tensors differ, worst relative {worst:.3g} ≤ "
               f"{STEP_RTOL} (operators without a deterministic CUDA "
               f"implementation: {nondet})")
            + f"; hand step {hand_s:.2f} s")
        log(f"train step [{card}]: first {step_s[0]:.4f} s, median {med:.4f} s "
            f"(all {', '.join(f'{x:.4f}' for x in step_s)}); model_flops "
            f"{flops:.4g} FLOP / {hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16 = "
            f"{bound_s:.4f} s, {bound_s / med * 100:.2f}% of the median; AdamW's "
            f"bytes {adam_bytes / 1e9:.1f} GB / {hw.HBM_BW / 1e12:.2f} TB/s = "
            f"{adam_bytes / hw.HBM_BW:.4f} s; peak device memory "
            f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated)")
        del params, opt, batches
        torch.cuda.empty_cache()

        # ---- prefill and decode at full depth ----------------------------
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(full, torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        pshape = ShapeConfig("prefill_32k", SERVE_CACHE, 1, "prefill")
        dshape = ShapeConfig("decode_32k", SERVE_CACHE, 1, "decode")
        pfn, _, _, _, _ = make_prefill_step(full, pshape, mesh)
        dfn, _, _, _, ddonate = make_decode_step(full, dshape, mesh)
        check(ddonate == (2,), f"decode step donates {ddonate}")
        n_prompt = SERVE_CACHE - SERVE_DECODE
        prompt = torch.from_numpy(np.random.default_rng(23).integers(
            0, full.vocab_size, (1, n_prompt)).astype(np.int32)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches, last = pfn(params, {"tokens": prompt})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        first_tok = tok.clone()
        step_logits, dec_s = [], []
        for i in range(SERVE_DECODE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = dfn(params, tok, caches, n_prompt + i)
            torch.cuda.synchronize()
            dec_s.append(time.perf_counter() - t0)
            step_logits.append(logits)
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        check(all(bool(torch.isfinite(x).all()) for x in step_logits),
              "decode logits are not finite")
        del caches
        d_caches, d_last = prefill(full, params, {"tokens": prompt},
                                   SERVE_CACHE, q_chunk=512)
        d_logits, _ = decode_step(full, params, first_tok, d_caches, n_prompt)
        check(torch.equal(d_last, last),
              "prefill step's logits differ from prefill(dist=None)")
        check(torch.equal(d_logits, step_logits[0]),
              "first decode step's logits differ from decode_step(dist=None): "
              f"max |diff| {float((d_logits - step_logits[0]).abs().max()):.3g}")
        serve_peak = torch.cuda.max_memory_allocated() - base_alloc
        weight_bytes = 4 * n_full
        log(f"{SHARD_ARCH} full depth [{card}]: {n_full:,} parameters, init "
            f"{init_s:.2f} s (f32, {weight_bytes / 1e9:.1f} GB); "
            f"make_prefill_step of {n_prompt:,} tokens into a "
            f"{SERVE_CACHE:,}-position cache {prefill_s:.3f} s; "
            f"make_decode_step × {SERVE_DECODE}: median "
            f"{statistics.median(dec_s) * 1e3:.2f} ms (first "
            f"{dec_s[0] * 1e3:.2f} ms); the prefill logits and the first "
            f"decode logits equal prefill / decode_step with dist=None bit "
            f"for bit; peak device memory {serve_peak / 1e9:.2f} GB")
        del params, d_caches, step_logits
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(was_deterministic)
        torch.utils.deterministic.fill_uninitialized_memory = was_filling

    # ---- the dry run, on the host ---------------------------------------------
    out_dir = os.path.join(tmp, "dryrun")
    os.makedirs(out_dir, exist_ok=True)
    arts = _dryrun_cells(DRYRUN_CELLS, out_dir)
    for (arch, shape_name, mesh_name), art in arts.items():
        check(art["chips"] == (256 if mesh_name == "single" else 512)
              and art["dominant_term"] in ("compute", "memory", "collective")
              and art["model_flops_global"] == model_flops(
                  get_config(arch), get_shape(shape_name)),
              f"dry run artifact {arch} × {shape_name}: {art}")
        log(f"dry run {arch} × {shape_name} × {art['mesh']} ({art['wall_s']:.1f} "
            f"s in a child process, side by side): per_device_bytes "
            f"{art['per_device_bytes']:,} ({art['per_device_bytes'] / 1e9:.2f} "
            f"GB), fits_hbm {art['fits_hbm']}, dominant_term "
            f"{art['dominant_term']}, roofline_fraction "
            f"{art['roofline_fraction']:.4g} (compute {art['compute_s']} s, "
            f"memory {art['memory_s']} s, collective {art['collective_s']} s; "
            f"{art['collectives']['num_collectives']} collectives)")

    counts = {}
    for m in kernel_ops:
        counts.update(m.launch_counts)
    counts = {name: counts.get(name, 0) for name in KERNELS}
    check(counts == PREDICTED_3K,
          f"phase 3k launches {counts} differ from {PREDICTED_3K}")
    log(f"phase 3k [{card}]: launches {counts}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts, arts


# ---------------------------------------------------------------------------
# Phase 3l — one rank of olmoe-1b-7b × train_4k × 16x16
# ---------------------------------------------------------------------------

#: phase 3l's cell: one rank of the 16 × 16 ``("data", "model")`` mesh, the
#: published olmoe-1b-7b at all 16 layers, ``train_4k``'s batch shard of
#: 16 sequences of 4,096 tokens in the config's 2 microbatches, 3 steps
TP_CELL = ("olmoe-1b-7b", "train_4k", "single")
TP_STEPS, TP_WORLD = 3, 256
#: the child process's time limit (its steps, its group and its imports)
TP_TIMEOUT_S = 600
#: launches of phase 3l: the LM path runs none of the four kernels
PREDICTED_3L = {"dfg_count": 0, "dfg_count_diced": 0, "segment_count": 0,
                "align_dp": 0}
#: the child's argument (``python3 chip_smoke.py`` itself takes none), then
#: optionally an arch (olmoe's cell by default), then the output path
TP_CHILD_FLAG = "--rank-of-16x16"
#: phase 3l's second cell: whisper-tiny's 6 heads do not split over the 16
#: ranks of ``model``, so its attention splits over query positions
TP_WHISPER = ("whisper-tiny", "train_4k", "single")
#: how far a cell's peak device memory may lie from its dry run's
#: ``per_device_bytes`` (a fraction, either way)
PEAK_BAND = 0.2


def _on_rank(device, cfg, run):
    """``run(mesh)`` as the rank of ``cfg``'s cells that the dry run
    counts (:func:`repro_torch.launch.dryrun.counted_rank`) in a fake
    process group of ``TP_WORLD`` ranks (its collectives move nothing and
    leave what they would receive unfilled), ``mesh`` the production
    16 × 16 ``DeviceMesh`` on ``device``, the four kernels' counts set to 0
    before it; returns ``run``'s dict of results with the ``rank`` and the
    kernels' ``launches`` added."""
    import torch.distributed as dist

    from repro_torch.kernels.align_dp import ops as dp_ops
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops
    from repro_torch.launch.dryrun import _fake_process_group, counted_rank
    from repro_torch.launch.mesh import make_production_mesh

    kernel_ops = (ops, seg_ops, dp_ops)
    for m in kernel_ops:
        m.reset_launch_counts()
    rank = counted_rank(cfg)
    _fake_process_group(TP_WORLD, rank)
    try:
        result = run(make_production_mesh(device_type=device))
    finally:
        dist.destroy_process_group()
    counts = {}
    for m in kernel_ops:
        counts.update(m.launch_counts)
    result["rank"] = rank
    result["launches"] = {name: counts.get(name, 0) for name in KERNELS}
    return result


def _timed_steps(torch, device, steps, step, after, profile, prepare=None):
    """``out = step(i)`` for each ``i < steps``, timed to the device's end
    (the first under the dry run's collective counter), after
    ``prepare(i)`` and followed by ``after(i, out)``, both untimed; on the
    card, ``profile()`` once under
    ``torch.profiler``.  Returns the results that the children of phases
    3l and 3m share: the step times and their median, the peak device
    memory from the first step on (None on the host), the first step's
    collectives kind by kind (count and result bytes) and the profile."""
    import statistics

    from repro_torch.roofline.analyze import _collective_log_mode, _inventory

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(steps):
        if prepare is not None:
            prepare(i)
        counter = _collective_log_mode() if i == 0 else contextlib.nullcontext()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counter:
            out = step(i)
        if device == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            coll = _inventory(counter.ops)["ops"]
        after(i, out)
        del out
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    profiled = None
    if device == "cuda" and profile is not None:
        wall, busy, n_kernels, classes, top = _device_profile(torch, profile)
        profiled = {"wall_s": wall, "busy": busy, "kernels": n_kernels,
                    "classes_ms": classes, "top": top}
    return {"step_s": step_s, "median_s": statistics.median(step_s),
            "peak_bytes": peak,
            "collectives": {k: v["count"] for k, v in coll.items()},
            "collective_bytes": {k: v["bytes"] for k, v in coll.items()},
            "profile": profiled}


def tp_rank(out_path, device="cuda", cfg=None, steps=TP_STEPS):
    """The child of phase 3l: one rank of a fake group (:func:`_on_rank`),
    its local parameters of ``cfg`` (the published olmoe by default) made
    from a seed (:func:`_random_fill`), and ``steps`` steps of
    ``make_train_step`` on the rank's batch shard (its tokens from the
    token pipeline, an encoder's frames from the seed; each step's batch
    made before its timer starts, one alive at a time, as in the dry run;
    :func:`_timed_steps`; on the card one more step under
    ``torch.profiler``).  Writes what it measured to ``out_path`` (JSON)."""
    import torch

    from repro_torch.configs import get_config, get_shape
    from repro_torch.data.lm_data import TokenPipeline
    from repro_torch.launch.steps import local_abstract_args, make_train_step
    from repro_torch.train.optimizer import init_opt_state

    arch, shape_name, _ = TP_CELL
    cfg = cfg or get_config(arch)
    shape = get_shape(shape_name)

    def run(mesh):
        fn, in_sh, _, args, _ = make_train_step(cfg, shape, mesh)
        params, _, batch_meta = local_abstract_args(args, in_sh)
        gen = torch.Generator(device=device).manual_seed(0)
        params = _random_fill(torch, params, gen, device, cfg.vocab_size)
        state = {"params": params, "opt": init_opt_state(params)}
        del params
        rows, seq = batch_meta["tokens"].shape
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=rows,
                             seq_len=seq, seed=31)

        def prepare(i):
            state["batch"] = None  # the previous step's, dropped first
            b = {k: torch.from_numpy(v).to(device) for k, v in pipe(i).items()}
            b.update(_random_fill(torch, {k: v for k, v in batch_meta.items()
                                          if k not in b}, gen, device,
                                  cfg.vocab_size))  # an encoder's frames
            state["batch"] = b

        losses, norms = [], []

        def after(i, out):
            state["params"], state["opt"], loss, metrics = out
            losses.append(float(loss))
            norms.append(float(metrics["grad_norm"]))

        def step(i):
            return fn(state["params"], state["opt"], state["batch"])

        res = _timed_steps(torch, device, steps, step, after,
                           lambda: step(steps), prepare)
        return {"params_local": sum(p.numel()
                                    for p in state["params"].parameters()),
                "batch": [rows, seq], "losses": losses, "grad_norms": norms,
                **res}

    result = _on_rank(device, cfg, run)
    with open(out_path, "w") as f:
        json.dump(result, f)


def _rank_child(args, out, timeout, what):
    """``python3 chip_smoke.py *args out`` (a child mode of this script)
    under ``timeout``; returns the JSON it wrote to ``out``."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    run = subprocess.run(
        [sys.executable, os.path.abspath(__file__), *args, out],
        env=env, capture_output=True, text=True, cwd=root, timeout=timeout)
    check(run.returncode == 0,
          f"{what} child: {run.stdout[-1000:]} {run.stderr[-3000:]}")
    with open(out) as f:
        return json.load(f)


def _check_rank(res, art, predicted, cell, what, card):
    """What phases 3l and 3m hold a child's results ``res`` to: its
    profile and its first step's collectives logged; its peak device
    memory within the card's 80 GB and within ``PEAK_BAND`` of the dry
    run's ``per_device_bytes`` either way, its collectives those of its
    cell's dry run (``art``) kind by kind, in count and result bytes, and
    its launches ``predicted``."""
    who = f"rank {res['rank']}"
    prof = res["profile"]
    if prof is not None and prof["busy"] is not None:
        log(f"{who} {what} under torch.profiler [{card}]: "
            f"{prof['wall_s']:.4f} s, {prof['kernels']:,} kernels, the "
            f"card {prof['busy'] * 100:.1f}% busy; device ms by class: "
            + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
                prof["classes_ms"].items(), key=lambda kv: -kv[1]))
            + "; top: " + "; ".join(f"{n[:60]} {ms:.1f} ms × {c}"
                                    for n, ms, c in prof["top"]))
    ops = art["collectives"]["ops"]
    want = {k: v["count"] for k, v in ops.items()}
    want_bytes = {k: v["bytes"] for k, v in ops.items()}
    log(f"{who} collectives in the first {what} [{card}]: "
        f"{res['collectives']} (result bytes {res['collective_bytes']}); "
        f"the dry run's {want} (bytes {want_bytes})")
    peak, dry = res["peak_bytes"], art["per_device_bytes"]
    off = (peak / dry - 1) * 100
    log(f"{cell}: {who}'s peak {peak:,} B is {off:+.1f}% from the dry run's "
        f"per_device_bytes {dry:,} B (allowed ±{PEAK_BAND * 100:.0f}%)")
    check(peak <= hw.HBM_BYTES,
          f"{cell}: {who}'s peak {peak / 1e9:.2f} GB exceeds the card's "
          f"{hw.HBM_BYTES / 1e9:.0f} GB")
    check(abs(off) <= PEAK_BAND * 100,
          f"{cell}: {who}'s peak {peak:,} B is {off:+.1f}% from the dry "
          f"run's {dry:,} B, outside ±{PEAK_BAND * 100:.0f}%")
    check(res["collectives"] == want and res["collective_bytes"] == want_bytes,
          f"{cell}: {who}'s collectives {res['collectives']} (bytes "
          f"{res['collective_bytes']}) differ from the dry run's {want} "
          f"(bytes {want_bytes})")
    check(res["launches"] == predicted,
          f"{cell}: launches {res['launches']} differ from {predicted}")


def phase_tp_lm(torch, card, dry_arts, tmp):
    """Phase 3l: :func:`tp_rank` in a child process under
    ``TP_TIMEOUT_S``, for ``TP_CELL`` and then ``TP_WHISPER`` (their dry
    runs ``dry_arts``, phase 3k's artifacts); each peak device memory
    against the card's 80 GB and the dry run's ``per_device_bytes``, its
    collectives against the dry run's, kind by kind; no kernel launched
    (:func:`_check_rank`).  Returns {kernel: launches}."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.steps import train_microbatches
    from repro_torch.roofline import model_flops

    t_phase = time.perf_counter()
    total = {name: 0 for name in KERNELS}
    for cell in (TP_CELL, TP_WHISPER):
        t_cell = time.perf_counter()
        arch, shape_name, _ = cell
        dry_art = dry_arts[cell]
        args = [TP_CHILD_FLAG] + ([arch] if cell != TP_CELL else [])
        res = _rank_child(args, os.path.join(tmp, f"rank_{arch}.json"),
                          TP_TIMEOUT_S, f"phase 3l {arch}")
        cfg, shape = get_config(arch), get_shape(shape_name)
        peak = res["peak_bytes"]
        bound_s = model_flops(cfg, shape) / TP_WORLD / hw.PEAK_FLOPS_BF16
        log(f"{arch} × {shape_name} × 16x16, rank {res['rank']} of a fake "
            f"group of {TP_WORLD} [{card}]: all {cfg.n_layers} layers, "
            f"{res['params_local']:,} parameters on the rank, batch shard "
            f"{res['batch'][0]} × {res['batch'][1]} in "
            f"{train_microbatches(cfg)} microbatches; losses "
            f"{', '.join(f'{x:.4f}' for x in res['losses'])} and grad norms "
            f"{', '.join(f'{x:.4g}' for x in res['grad_norms'])} (not gated: "
            "the fake collectives leave what they gather unfilled)")
        log(f"rank {res['rank']} step [{card}]: median {res['median_s']:.4f} s (all "
            f"{', '.join(f'{x:.4f}' for x in res['step_s'])}; collectives take "
            f"no time); model_flops per rank {bound_s:.4f} s at "
            f"{hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16 "
            f"({bound_s / res['median_s'] * 100:.2f}% of the median); peak "
            f"device memory {peak:,} B ({peak / 1e9:.2f} GB; "
            "torch.cuda.max_memory_allocated) beside the dry run's "
            f"per_device_bytes {dry_art['per_device_bytes']:,} "
            f"({dry_art['per_device_bytes'] / 1e9:.2f} GB), useful_flops_ratio "
            f"{dry_art['useful_flops_ratio']:.4f}")
        _check_rank(res, dry_art, PREDICTED_3L, f"{arch} × {shape_name}",
                    "train step", card)
        for name in KERNELS:
            total[name] += res["launches"][name]
        log(f"{arch} × {shape_name} [{card}]: "
            f"{time.perf_counter() - t_cell:.1f} s")
    log(f"phase 3l [{card}]: launches {total}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Phase 3m — one rank of the serving cells, tensor-parallel, caches split
# ---------------------------------------------------------------------------

#: phase 3m's cells, each one rank of the 16 × 16 ``("data", "model")`` mesh
#: at the published width and depth: gemma2-27b's decode (8 sequences a
#: rank, 1 KV head: the KV heads split), gemma2-9b's prefill (2 sequences
#: of 32,768 tokens: 8 KV heads, the caches' slots split over ``model``)
#: and its long-context decode (1 sequence, 524,288 slots split 256 ways
#: over ``data`` and ``model`` folded)
SERVE_CELLS = (("gemma2-27b", "decode_32k"), ("gemma2-9b", "prefill_32k"),
               ("gemma2-9b", "long_500k"), ("whisper-tiny", "prefill_32k"))
#: decode steps (from the position the caches are filled to) or prefills
SERVE_STEPS = {"decode_32k": 8, "prefill_32k": 3, "long_500k": 8}
SERVE_FILLED = {"decode_32k": 32_000, "long_500k": 524_000}
#: each cell's child process's time limit (its dry run, its group, its
#: steps and its imports)
SERVE_TIMEOUT_S = 600
#: launches of phase 3m: the LM path runs none of the four kernels
PREDICTED_3M = {"dfg_count": 0, "dfg_count_diced": 0, "segment_count": 0,
                "align_dp": 0}
#: the child's argument, then the cell's arch and shape and the output path
SERVE_CHILD_FLAG = "--serve-rank-of-16x16"


def _random_fill(torch, tree, gen, device, vocab):
    """``tree``'s ``meta`` tensors (a module's parameters, mappings, lists
    and tuples, which come back as lists)
    made on ``device`` from ``gen``: N(0, 0.02²) matrices and zero vectors
    for parameters, token ids below ``vocab``, N(0, 1) for the rest (the
    caches and embeddings)."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.to_empty(device=device)
        with torch.no_grad():
            for p in tree.parameters():
                if p.dim() >= 2:
                    p.copy_(torch.randn(p.shape, generator=gen, device=device)
                            * 0.02)
                else:
                    p.zero_()
        return tree
    if isinstance(tree, dict):
        return {k: _random_fill(torch, v, gen, device, vocab)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_random_fill(torch, v, gen, device, vocab) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.device.type == "meta":
        if not tree.dtype.is_floating_point:
            return torch.randint(0, vocab, tree.shape, generator=gen,
                                 device=device, dtype=tree.dtype)
        return torch.randn(tree.shape, generator=gen, device=device).to(tree.dtype)
    return tree


def serve_rank(out_path, arch, shape_name, device="cuda", opts=None,
               steps=None):
    """The child of phase 3m for one cell: one rank of a fake group
    (:func:`_on_rank`), its local parameters and caches (or batch shard)
    of the published config (``opts`` overrides it) made from a seed
    (:func:`_random_fill`), and ``steps`` prefill or decode steps
    (:func:`_timed_steps`; on the card one more decode step under
    ``torch.profiler``: a prefill's 54,000 kernels would take the profiler
    most of a minute).  Writes what it measured to ``out_path`` (JSON)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.steps import (
        local_abstract_args, make_decode_step, make_prefill_step,
    )
    from repro_torch.roofline.analyze import _leaves, _storage_bytes, _tensors

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, **opts) if opts else cfg
    shape = get_shape(shape_name)
    steps = steps or SERVE_STEPS[shape_name]
    decode = shape.kind == "decode"

    def run(mesh):
        build = make_decode_step if decode else make_prefill_step
        fn, in_sh, _, args, _ = build(cfg, shape, mesh)
        gen = torch.Generator(device=device).manual_seed(0)
        local = list(_random_fill(torch, local_abstract_args(args, in_sh), gen,
                                  device, cfg.vocab_size))
        if decode:  # each step's tokens, and its position past the filled
            toks = [torch.randint(0, cfg.vocab_size, local[1].shape,
                                  generator=gen, device=device,
                                  dtype=local[1].dtype) for _ in range(steps)]
        seen = {"firsts": []}

        def step(i):
            if decode:
                local[1], local[3] = toks[i], SERVE_FILLED[shape_name] + i
            return fn(*local)

        def after(i, out):
            caches, logits = (out[1], out[0]) if decode else out
            seen["firsts"].append(float(logits.flatten()[0]))
            if i == 0:
                seen["logits_local"] = list(logits.shape)
                seen["cache_bytes"] = _storage_bytes(_tensors(_leaves(caches)))
            if decode:
                local[2] = caches  # updated in place

        def profile():  # one more decode step
            local[3] = SERVE_FILLED[shape_name] + steps
            return fn(*local)

        res = _timed_steps(torch, device, steps, step, after,
                           profile if decode else None)
        tokens = local[1] if decode else local[1]["tokens"]
        return {"arch": arch, "shape": shape_name, "kind": shape.kind,
                "params_local": sum(p.numel() for p in local[0].parameters()),
                "tokens_local": list(tokens.shape),
                "cache_bytes": seen["cache_bytes"],
                "logits_local": seen["logits_local"],
                "logits_first": seen["firsts"], **res}

    result = _on_rank(device, cfg, run)
    with open(out_path, "w") as f:
        json.dump(result, f)


def phase_serve_lm(torch, card, tmp):
    """Phase 3m: the dry runs of ``SERVE_CELLS`` (:func:`_dryrun_cells`),
    then :func:`serve_rank` for each cell in a child process under
    ``SERVE_TIMEOUT_S``, one after the other, with nothing else running on
    the host; each cell's peak device memory against the card's 80 GB and
    beside its dry run's ``per_device_bytes``, its first step's
    collectives against the dry run's, kind by kind (count and bytes); no
    kernel launched (:func:`_check_rank`).  Returns {kernel: launches}."""
    t_phase = time.perf_counter()
    total = {name: 0 for name in KERNELS}
    dry_dir = os.path.join(tmp, "dryrun")
    os.makedirs(dry_dir, exist_ok=True)
    arts = _dryrun_cells([(*cell, "single") for cell in SERVE_CELLS], dry_dir)
    log(f"dry runs of {len(SERVE_CELLS)} cells side by side on the host: "
        f"{time.perf_counter() - t_phase:.1f} s")
    for arch, shape_name in SERVE_CELLS:
        t_cell = time.perf_counter()
        cell = f"{arch} × {shape_name}"
        art = arts[arch, shape_name, "single"]
        res = _rank_child(
            [SERVE_CHILD_FLAG, arch, shape_name],
            os.path.join(tmp, f"serve_{arch}_{shape_name}.json"),
            SERVE_TIMEOUT_S, f"phase 3m {cell}")
        peak = res["peak_bytes"]
        what = "prefill" if res["kind"] == "prefill" else "decode step"
        mem = art["memory_analysis"]
        bound_s = art["model_flops_per_chip"] / hw.PEAK_FLOPS_BF16
        log(f"{cell} × 16x16, rank {res['rank']} of a fake group of {TP_WORLD} "
            f"[{card}]: {res['params_local']:,} parameters on the rank "
            f"(f32), tokens {res['tokens_local']}, caches "
            f"{res['cache_bytes']:,} B on the rank, logits "
            f"{res['logits_local']} (the rank's vocabulary rows); first "
            f"logits {', '.join(f'{x:.4g}' for x in res['logits_first'])} "
            "(not gated: the fake collectives leave what they gather "
            "unfilled)")
        log(f"rank {res['rank']} {what} [{card}]: median {res['median_s']:.4f} s (all "
            f"{', '.join(f'{x:.4f}' for x in res['step_s'])}; collectives "
            f"take no time); model_flops per rank {bound_s:.4g} s at "
            f"{hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16; peak device "
            f"memory {peak:,} B ({peak / 1e9:.2f} GB; "
            "torch.cuda.max_memory_allocated) beside the dry run's "
            f"per_device_bytes {art['per_device_bytes']:,} "
            f"({art['per_device_bytes'] / 1e9:.2f} GB; arguments "
            f"{mem['argument_bytes']:,} B, temporaries "
            f"{mem['temp_bytes']:,} B), useful_flops_ratio "
            f"{art['useful_flops_ratio']:.4f} (the dry run in a child "
            f"process on the host, {art['wall_s']:.1f} s)")
        _check_rank(res, art, PREDICTED_3M, cell, what, card)
        for name in KERNELS:
            total[name] += res["launches"][name]
        log(f"{cell} [{card}]: {time.perf_counter() - t_cell:.1f} s")
    log(f"phase 3m [{card}]: launches {total}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Phase 4 — the CLI
# ---------------------------------------------------------------------------


def phase_cli():
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.launch import mine

    args = ["--events", "4000000", "--activities", "32"]
    summary = mine.main(args + ["--dice-days", "30"])
    check(summary["mode"] == "kernel", f"mine ran on {summary['mode']}")
    check("fused_kernel_dicing" in summary["plan"], "mine did not fuse the dice")
    check(ops.last_launch.get("branch") == "shared",
          f"mine's count took the {ops.last_launch.get('branch')} branch")
    log(f"cli: mode={summary['mode']} branch={ops.last_launch['branch']} "
        f"grid={ops.last_launch['grid']}")
    plain = mine.main(args)
    dist = mine.main(args + ["--distributed"])
    check(plain["mode"] == "kernel" and dist["mode"] == "distributed(1)",
          f"mine modes {plain['mode']} / {dist['mode']}")
    check(dist["total_pairs"] == plain["total_pairs"],
          f"mine --distributed total_pairs {dist['total_pairs']} != "
          f"{plain['total_pairs']}")
    log(f"cli --distributed: mode={dist['mode']}, total_pairs "
        f"{dist['total_pairs']} == plain run ({plain['mode']}), dfg "
        f"{dist['dfg_s']} s / {plain['dfg_s']} s")


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
        name: (b + 8 * a * a) / hw.HBM_BW * 1e3 for name, b in read.items()
    }
    sep_bound = ((_distinct_bytes(src_sep, dst_sep, valid_sep) + 8 * a * a)
                 / hw.HBM_BW * 1e3)
    cli_bound = {
        "dfg_count": _distinct_bytes(*cli_args),
        "dfg_count_diced": _distinct_bytes(*cli_args, *cli_diced[:2]),
    }
    cli_bound = {
        name: (b + 8 * a_cli * a_cli) / hw.HBM_BW * 1e3
        for name, b in cli_bound.items()
    }
    e = int(act_d.shape[0])
    seg_read = _distinct_bytes(act_d)
    bound["segment_count"] = (seg_read + 8 * a) / hw.HBM_BW * 1e3
    seg_valid_bound = (
        (_distinct_bytes(act_d, ones_d) + 8 * a) / hw.HBM_BW * 1e3
    )
    log(f"bytes bound: inputs read once, {read['dfg_count'] / n:.4f} B/pair "
        f"plain and {read['dfg_count_diced'] / n:.4f} B/pair diced, "
        f"+ {8 * a * a} B of int64 output; segment_count "
        f"{seg_read / e:.4f} B/id (+1 with valid) + {8 * a} B of int64 "
        f"output; at {hw.HBM_BW:.3g} B/s")
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
    dp_select_ms = 2 * dp_adds / hw.PEAK_FLOPS_FP32 * 1e3
    dp_bytes = (4 * sum_len + 8 * (v_n + 1) + mt_d.numel() * 4 + 8 * s_n
                + 4 * v_n)
    dp_ops_ms = dp_ops_n / hw.PEAK_FLOPS_FP32 * 1e3
    dp_bytes_ms = dp_bytes / hw.HBM_BW * 1e3
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
        f"adds and one min per state) at {hw.PEAK_FLOPS_FP32:.3g}/s = "
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
    if sys.argv[1:2] == [TP_CHILD_FLAG]:  # a child of phase 3l
        *arch, out = sys.argv[2:]
        if arch:
            from repro_torch.configs import get_config

            tp_rank(out, cfg=get_config(arch[0]))
        else:
            tp_rank(out)
        return 0
    if sys.argv[1:2] == [SERVE_CHILD_FLAG]:  # a child of phase 3m
        serve_rank(sys.argv[4], sys.argv[2], sys.argv[3])
        return 0
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
    global hw
    from repro_torch.kernels import build
    from repro_torch.roofline import hw
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
        with _recording_launches((("dfg_count", ops),
                                  ("segment_count", seg_ops),
                                  ("align_dp", dp_ops))) as configs:
            worst = phase_sweep(torch, ops)
            worst["segment_count"] = phase_segment_sweep(torch, seg_ops)
            worst["align_dp"] = phase_align_sweep(torch, dp_ops)
        phase_launch_check(build, configs)
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
            union_counts, canary = phase_union(torch, mlog, repo, results,
                                               model, card, tmp)
            log("== phase 3f: sharded graph tier and distributed DFG at "
                "PAPER_EVAL width")
            shard_counts, sharded = phase_sharded(torch, mlog, repo, results,
                                                  card, tmp)
            log("== phase 3g: the query service at PAPER_EVAL width")
            service_counts, oracles = phase_service(
                torch, mlog, repo, results, canary, sharded, conf, card, tmp)
            log("== phase 3h: the HTTP transport at PAPER_EVAL width")
            transport_counts = phase_transport(torch, mlog, repo, oracles,
                                               card, tmp)
        log("== phase 3i: the LM serving path, gemma2-9b at full width")
        lm_counts = phase_lm_serving(torch, card)
        log("== phase 3j: the LM training path, starcoder2-3b at full width")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            train_counts = phase_lm_training(torch, card, tmp)
        log("== phase 3k: the sharded LM path and the dry run, olmoe-1b-7b "
            "at full width")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            sharded_lm_counts, dry_arts = phase_sharded_lm(torch, card, tmp)
        log("== phase 3l: one rank of olmoe-1b-7b and of whisper-tiny × "
            "train_4k × 16x16, tensor-parallel")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            tp_counts = phase_tp_lm(torch, card, dry_arts, tmp)
        log("== phase 3m: one rank of the serving cells × 16x16, "
            "tensor-parallel with split caches")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serve_counts = phase_serve_lm(torch, card, tmp)
        by_phase = {"3": dict(counts), "3b": graph_counts, "3c": conf_counts,
                    "3d": var_counts, "3e": union_counts, "3f": shard_counts,
                    "3g": service_counts, "3h": transport_counts,
                    "3i": lm_counts, "3j": train_counts,
                    "3k": sharded_lm_counts, "3l": tp_counts,
                    "3m": serve_counts}
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
