#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. environment — card name and power limit, torch / CUDA / nvcc versions,
   each kernel library's build time (one ``nvcc`` per source, all started
   together) and ``-Xptxas -v`` report;
2. every CUDA kernel against its plain PyTorch version on the card, bit for
   bit, over a sweep of activity / segment counts, pair / id counts, dtypes
   and windows that reaches both branches of each kernel;
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
4. the mining CLI in-process (``repro_torch.launch.mine``);
5. kernel, plain-version and library times at the main paths' shapes beside
   the bytes bound, and the end-to-end split of the main-path queries.

The line before the last is a JSON ``kernels`` report; the last line is
``{"ok": true, "device": {...}}``.  Counts are exact integers, so every
comparison has tolerance 0.
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
#: the source of each kernel
SOURCES = {
    "dfg_count": "src/repro_torch/kernels/dfg_count/csrc/dfg_count.cu",
    "dfg_count_diced": "src/repro_torch/kernels/dfg_count/csrc/dfg_count.cu",
    "segment_count":
        "src/repro_torch/kernels/segment_count/csrc/segment_count.cu",
}
#: the TPU kernels this port replaces (file:line of the Pallas kernel body)
REPLACES = {
    "dfg_count": "src/repro/kernels/dfg_count/kernel.py:34",
    "dfg_count_diced": "src/repro/kernels/dfg_count/kernel.py:61",
    "segment_count": "src/repro/kernels/segment_count/kernel.py:31",
}


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


def phase_sweep(torch, ops):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = {"dfg_count": 0, "dfg_count_diced": 0}
    branches = set()
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

    for a in (1, 3, 26, 130, 257, 600):
        for n in (0, 1, 7, 1000, 1 << 20, 7_200_000):
            src, dst, valid, ts = _pairs(torch, gen, n, a, dev)
            what = f"A={a} E={n}"
            compare("dfg_count",
                    ops.dfg_count(src, dst, valid, num_activities=a),
                    ops.dfg_count_plain(src, dst, valid, num_activities=a),
                    what)
            if n:
                branches.add(ops.last_launch["branch"])
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
    check(branches == {"shared", "global"},
          f"sweep reached branches {branches}, expected shared and global")
    log(f"sweep: {cases} kernel-vs-plain comparisons bit-identical "
        f"(tolerance 0) over both branches {sorted(branches)}")
    return worst


def phase_segment_sweep(torch, seg_ops):
    """segment_count ≡ segment_count_plain with torch.equal.  S ≤ 58,112
    fits a block's shared memory (227 KB of int32 bins); 100,000 and
    1,000,000 take the global branch."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    worst, cases, branches = 0, 0, set()

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
            branches.add(seg_ops.last_launch["branch"])
        cases += 1

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
    return counts, results, repo, mlog


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


def _launch_ms(torch, fn, reset, flush, iters, warmup):
    """Device ms of each of ``iters`` launches of ``fn`` (CUDA events), each
    preceded off the clock by ``reset`` and an L2 flush: the inputs come
    fresh from a host copy, so the caller finds the 50 MB L2 cold."""
    out = []
    for i in range(warmup + iters):
        if reset is not None:
            reset()
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            out.append(start.elapsed_time(end))
    return out


def _measure(torch, cases, rounds=5, iters=10):
    """Per-launch ms of every case, in ``rounds`` interleaved rounds so a
    drift of the card's clocks spreads over all cases alike.  Returns
    name → (median, first quartile, third quartile, launches)."""
    import numpy as np

    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    samples = {name: [] for name in cases}
    for r in range(rounds):
        for name, (fn, reset) in cases.items():
            samples[name] += _launch_ms(
                torch, fn, reset, flush, iters, warmup=3 if r == 0 else 1
            )
    return {
        name: (*np.percentile(v, [50, 25, 75]).tolist(), len(v))
        for name, v in samples.items()
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


def phase_times(torch, repo, results, card, graph_counts):
    import numpy as np

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

    # the kernels against their plain versions on the main path's own inputs
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
    log(f"main-path inputs: kernel == plain on all {len(results)} queries")
    got = seg_ops.segment_count(act_d, num_segments=a)
    want = seg_ops.segment_count_plain(act_d, num_segments=a)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          "graph-path inputs: segment_count differs from plain")
    log("graph-path inputs: segment_count == plain")

    cases = {
        ("dfg_count", "ms"): (
            lambda: ops.launch(src_d, dst_d, valid_d, out, a), out.zero_),
        ("dfg_count", "plain_ms"): (lambda: ops.dfg_count_plain(
            src_d, dst_d, valid_d, num_activities=a), None),
        ("dfg_count", "library_ms"): (lambda: torch.bincount(
            key_plain, minlength=a * a), None),
        ("dfg_count", "uniform_ms"): (
            lambda: ops.launch(uni[:-1], uni[1:], valid_d, out, a), out.zero_),
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
    }
    measured = _measure(torch, cases)
    clocks = run_cmd([
        "nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
        "temperature.gpu", "--format=csv,noheader", "-i", "0",
    ])
    check(ops.last_launch["branch"] == "global",
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
    times = {name: {"bound_ms": b} for name, b in bound.items()}
    for (name, key), (med, q1, q3, count) in measured.items():
        times[name][key] = med
        times[name][key + "_iqr"] = (q1, q3, count)

    def fmt_ms(t, key):
        q1, q3, count = t[key + "_iqr"]
        return f"{t[key]:.4f} ms ({q1:.4f}-{q3:.4f}, {count})"

    log(f"times [{card}] (median ms of per-launch CUDA-event times, "
        f"interquartile range, launches; clocks right after: {clocks})")
    for name in ("dfg_count", "dfg_count_diced"):
        t = times[name]
        log(f"  {name} E={n} A={a} ({ops.last_launch['branch']} branch, "
            f"grid {ops.last_launch['grid']}x256): kernel {fmt_ms(t, 'ms')}, "
            f"plain {fmt_ms(t, 'plain_ms')}, torch.bincount on pre-masked "
            f"keys {fmt_ms(t, 'library_ms')} (leaves out the mask and the key build), "
            f"bytes bound {t['bound_ms']:.4f} ms "
            f"({t['bound_ms'] / t['ms'] * 100:.1f}% of the bound)")
    t = times["segment_count"]
    log(f"  segment_count E={e} S={a} ({seg_ops.last_launch['branch']} branch, "
        f"grid {seg_ops.last_launch['grid']}x256, "
        f"{seg_ops.last_launch['smem_bytes']} B smem; "
        f"{graph_counts['segment_count']} launch per graph build): kernel "
        f"{fmt_ms(t, 'ms')} without valid, "
        f"{fmt_ms(t, 'valid_ms')} with an all-ones valid; plain "
        f"{fmt_ms(t, 'plain_ms')}, torch.bincount on pre-masked ids "
        f"{fmt_ms(t, 'library_ms')}; bytes bound {t['bound_ms']:.4f} ms "
        f"without valid ({t['bound_ms'] / t['ms'] * 100:.1f}% of the bound), "
        f"{seg_valid_bound:.4f} ms with valid "
        f"({seg_valid_bound / t['valid_ms'] * 100:.1f}%)")
    hot = np.sort(np.bincount(repo.event_activity, minlength=a))[::-1]
    log(f"contention control [{card}]: segment_count on the graph's ids "
        f"{fmt_ms(t, 'ms')}; on uniform ids (same E, S) "
        f"{fmt_ms(t, 'uniform_ms')}. The 10 most frequent of the {a} "
        f"activities hold {hot[:10].sum() / hot.sum() * 100:.1f}% of the "
        "events.")
    psi = results[0][2].value
    hot = np.cumsum(np.sort(psi.ravel())[::-1])
    top = int(np.searchsorted(hot, 0.9 * hot[-1]) + 1)
    log(f"contention control [{card}]: dfg_count on the main path's pairs "
        f"{fmt_ms(times['dfg_count'], 'ms')}; on uniform activities (same E, "
        f"A, valid) {fmt_ms(times['dfg_count'], 'uniform_ms')}. The main "
        f"path's Ψ has {int((psi > 0).sum())} nonzero cells of {a * a}; "
        f"{top} of them hold 90% of the pairs.")
    log(f"end-to-end split [{card}] (s; host clock, card synchronized):")
    for name, _, res in results:
        notes = res.trace.notes
        log(f"  {name:>4}: wall {res.wall_s:.4f}  materialize "
            f"{notes.get('materialize_s', 0.0):.4f}  h2d "
            f"{notes.get('h2d_s', 0.0):.4f}  kernel "
            f"{notes.get('kernel_s', 0.0):.4f}  d2h "
            f"{notes.get('d2h_s', 0.0):.4f}")
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
    from repro_torch.kernels.dfg_count import ops
    from repro_torch.kernels.segment_count import ops as seg_ops

    t_start = time.perf_counter()
    try:
        log("== phase 1: environment")
        card = phase_environment(torch, build)
        log("== phase 2: kernels against their plain versions")
        worst = phase_sweep(torch, ops)
        worst["segment_count"] = phase_segment_sweep(torch, seg_ops)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            log("== phase 3: main path at PAPER_EVAL width")
            counts, results, repo, mlog = phase_main_path(torch, tmp)
            log("== phase 3b: graph tier at PAPER_EVAL width")
            graph_counts = phase_graph(torch, mlog, repo, results, tmp)
        counts["segment_count"] = graph_counts["segment_count"]
        log("== phase 4: mining CLI")
        phase_cli()
        log("== phase 5: times")
        times = phase_times(torch, repo, results, card, graph_counts)
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
            "max_abs_err": worst[name],
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": times[name]["library_ms"],
        }
        for name in ("dfg_count", "dfg_count_diced", "segment_count")
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
