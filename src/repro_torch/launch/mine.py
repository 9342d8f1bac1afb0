"""Process-mining CLI — the paper's pipeline end to end, through the
declarative query engine (``repro_torch.query``): the CLI states *what* to
mine (log, dice, sink) and the engine's cost model picks the physical path
(streaming scan or the CUDA kernel).

    # generate a synthetic BPI-like log and mine it on the card
    PYTHONPATH=src python -m repro_torch.launch.mine --events 500000 --dice-days 30

    # the same on the host
    PYTHONPATH=src python -m repro_torch.launch.mine --events 20000 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--events", type=int, default=200_000)
    ap.add_argument("--activities", type=int, default=32)
    ap.add_argument("--dice-days", type=float, default=None)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "scatter", "onehot", "kernel",
                             "streaming"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where counting runs (default: the CUDA card)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-card DFG (not ported yet: ROADMAP Queue A "
                         "item 6)")
    ap.add_argument("--min-count", type=int, default=10)
    ap.add_argument("--dot-out", default=None)
    args = ap.parse_args(argv)

    if args.distributed:
        raise SystemExit(
            "--distributed is not ported to repro_torch yet (ROADMAP Queue A "
            "item 6)"
        )

    from repro_torch.core import to_dot
    from repro_torch.query import QueryEngine

    # fail on a missing card before spending time on the log
    engine = QueryEngine(device=args.device, memory_budget_events=1 << 22)
    with tempfile.TemporaryDirectory(prefix="graphpm_mine_") as tmp:
        summary, model = _mine(engine, args, os.path.join(tmp, "log"))
    print(json.dumps(summary, indent=1))
    if args.dot_out:
        with open(args.dot_out, "w") as f:
            f.write(to_dot(model))
        print(f"wrote {args.dot_out}")
    return summary


def _mine(engine, args, path: str):
    import numpy as np

    from repro_torch.core import discover_dependency_graph, filter_dfg
    from repro_torch.data import ProcessSpec, generate_memmap_log
    from repro_torch.query import Q

    spec = ProcessSpec(num_activities=args.activities, seed=7)
    t0 = time.perf_counter()
    log = generate_memmap_log(path, args.events, spec, seed=7)
    gen_s = time.perf_counter() - t0

    window = None
    if args.dice_days is not None:
        t_min = float(log.time[0])
        window = (t_min, t_min + args.dice_days * 86400.0)

    q = Q.log(log).using(engine)
    if window is not None:
        q = q.window(*window)

    t0 = time.perf_counter()
    res = q.dfg(backend=args.backend)
    psi = res.value
    dfg_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    filtered = filter_dfg(psi, min_count=args.min_count)
    starts = np.zeros(log.num_activities, np.int64)
    ends = np.zeros(log.num_activities, np.int64)
    model = discover_dependency_graph(
        filtered, [f"act_{i:03d}" for i in range(log.num_activities)],
        starts, ends, min_count=args.min_count, min_dependency=0.3,
    )
    disc_s = time.perf_counter() - t0

    summary = {
        "events": log.num_events,
        "mode": res.physical.backend,
        "device": str(engine.device),
        "plan": res.physical.describe(),
        "diced": window is not None,
        "gen_s": round(gen_s, 2),
        "dfg_s": round(dfg_s, 3),
        "discover_s": round(disc_s, 3),
        "total_pairs": int(psi.sum()),
        "edges_discovered": len(model.edges),
    }
    return summary, model


if __name__ == "__main__":
    main()
