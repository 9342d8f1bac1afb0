#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. environment — card name and power limit, torch / CUDA / nvcc versions,
   the kernels' build time and ``-Xptxas -v`` report;
2. every CUDA kernel against its plain PyTorch version on the card, bit for
   bit, over a sweep of activity counts, pair counts, dtypes and windows;
3. the main path at the paper's evaluation width (PAPER_EVAL: 7.2 M events,
   600 activities, 120 days): ``Q.log(log).using(engine).dfg()`` plus
   accumulating-day dices, on the kernel backend with fused dicing, every Ψ
   held against the host oracle, then discovery on top;
4. the mining CLI in-process (``repro_torch.launch.mine``);
5. kernel, plain-version and library times at the main path's shapes beside
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
KERNEL_SOURCE = "src/repro_torch/kernels/dfg_count/csrc/dfg_count.cu"
#: the TPU kernels this port replaces (file:line of the Pallas kernel body)
REPLACES = {
    "dfg_count": "src/repro/kernels/dfg_count/kernel.py:34",
    "dfg_count_diced": "src/repro/kernels/dfg_count/kernel.py:61",
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
    recs = [build.build(name) for name in build.SOURCES]
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall for "
        f"{len(recs)} librar{'y' if len(recs) == 1 else 'ies'}")
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
    engine = QueryEngine(device="cuda", memory_budget_events=1 << 23)
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
    return counts, results, repo


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


def phase_times(torch, repo, results, card):
    import numpy as np

    from repro_torch.kernels.dfg_count import ops

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
    }
    measured = _measure(torch, cases)
    clocks = run_cmd([
        "nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
        "temperature.gpu", "--format=csv,noheader", "-i", "0",
    ])
    check(ops.last_launch["branch"] == "global",
          f"A={a} took the {ops.last_launch['branch']} branch")
    read = {
        "dfg_count": _distinct_bytes(src_d, dst_d, valid_d),
        "dfg_count_diced": _distinct_bytes(src_d, dst_d, valid_d, ts_src, ts_dst),
    }
    bound = {
        name: (b + 8 * a * a) / HBM_BYTES_PER_S * 1e3 for name, b in read.items()
    }
    log(f"bytes bound: inputs read once, {read['dfg_count'] / n:.4f} B/pair "
        f"plain and {read['dfg_count_diced'] / n:.4f} B/pair diced, "
        f"+ {8 * a * a} B of int64 output, at {HBM_BYTES_PER_S:.3g} B/s")
    times = {name: {"bound_ms": b} for name, b in bound.items()}
    for (name, key), (med, q1, q3, count) in measured.items():
        times[name][key] = med
        times[name][key + "_iqr"] = (q1, q3, count)

    def fmt_ms(t, key):
        q1, q3, count = t[key + "_iqr"]
        return f"{t[key]:.4f} ms ({q1:.4f}-{q3:.4f}, {count})"

    log(f"times [{card}] (median ms of per-launch CUDA-event times, "
        f"interquartile range, launches; clocks right after: {clocks})")
    for name, t in times.items():
        log(f"  {name} E={n} A={a} ({ops.last_launch['branch']} branch, "
            f"grid {ops.last_launch['grid']}x256): kernel {fmt_ms(t, 'ms')}, "
            f"plain {fmt_ms(t, 'plain_ms')}, torch.bincount on pre-masked "
            f"keys {fmt_ms(t, 'library_ms')} (leaves out the mask and the key build), "
            f"bytes bound {t['bound_ms']:.4f} ms "
            f"({t['bound_ms'] / t['ms'] * 100:.1f}% of the bound)")
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

    t_start = time.perf_counter()
    try:
        log("== phase 1: environment")
        card = phase_environment(torch, build)
        log("== phase 2: kernels against their plain versions")
        worst = phase_sweep(torch, ops)
        log("== phase 3: main path at PAPER_EVAL width")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            counts, results, repo = phase_main_path(torch, tmp)
        log("== phase 4: mining CLI")
        phase_cli()
        log("== phase 5: times")
        times = phase_times(torch, repo, results, card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": counts[name],
            "max_abs_err": worst[name],
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": times[name]["library_ms"],
        }
        for name in ("dfg_count", "dfg_count_diced")
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
