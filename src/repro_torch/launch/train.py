"""Training CLI: the reference's presets (``tiny``, ``small``, ``full``) on
the card by default; ``--device cpu`` runs on the host.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --preset tiny --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --preset full --steps 8 --batch 2 --seq 4096 --lr 3e-4 --mine

``--mine`` mines the trainer's own telemetry at the end with
``dfg_from_repository`` on the trainer's device (on the card: one
``dfg_count`` launch) and prints the discovered process as DOT.
The default checkpoint directory is ``graphpm_torch_ckpt`` under the
system's temporary directory (``$TMPDIR``); the reference's is
``/tmp/graphpm_ckpt``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None, collector=None) -> dict:
    """Run the CLI; returns the printed summary.  ``collector`` (an
    ``EventCollector``) receives the trainer's spans when given, so an
    in-process caller can query them afterwards."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "small", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "graphpm_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mine", action="store_true",
                    help="process-mine the run's telemetry at the end")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainHParams
    from repro_torch.core.telemetry import EventCollector
    from repro_torch.data.lm_data import TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.models import count_params
    from repro_torch.train import Trainer

    # fail on a missing card before building anything
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, vocab_size=256, loss_chunk=32)
    elif args.preset == "small":
        # ~100M-class model of the same family
        cfg = dataclasses.replace(
            cfg.reduced(), d_model=512, n_heads=8, head_dim=64, d_ff=2048,
            n_layers=len(cfg.layer_pattern) * 4, vocab_size=8192,
            loss_chunk=128,
        )
    hp = TrainHParams(
        learning_rate=args.lr, warmup_steps=max(10, args.steps // 20),
        total_steps=args.steps,
    )
    data = TokenPipeline(
        vocab_size=cfg.vocab_size, batch=args.batch, seq_len=args.seq, seed=17
    )
    trainer = Trainer(
        cfg, hp, data, args.ckpt_dir, ckpt_every=args.ckpt_every,
        q_chunk=min(1024, args.seq), device=device,
        collector=collector if collector is not None
        else EventCollector("trainer"),
    )
    t0 = time.perf_counter()
    out = trainer.run(args.steps)
    wall = time.perf_counter() - t0
    summary = {
        "arch": cfg.name,
        "params": count_params(cfg),
        "device": str(device),
        "steps": out["final_step"],
        "first_loss": out["history"][0],
        "last_loss": out["history"][-1],
        "history": out["history"],
        "bigram_entropy_floor": data.bigram_entropy(),
        "stragglers": out["stragglers"],
        "wall_s": round(wall, 3),
    }
    print(json.dumps(summary, indent=1))

    if args.mine:
        from repro_torch.core import (
            dfg_from_repository, discover_dependency_graph, to_dot,
        )

        repo = trainer.collector.to_repository()
        psi = dfg_from_repository(repo, device=device)
        starts, ends = repo.trace_boundaries()
        model = discover_dependency_graph(
            psi, repo.activity_names, starts, ends, min_dependency=0.0
        )
        print("\n== mined training process (GraphPM on the trainer's own log) ==")
        print(to_dot(model))
        summary["mined"] = {"activities": list(repo.activity_names),
                            "psi": psi.tolist()}
    return summary


if __name__ == "__main__":
    main()
