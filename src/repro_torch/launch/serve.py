"""Serving CLI: batched generation with the wave engine, on a reduced config
(the reference's CLI sizes), on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b --requests 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    # fail on a missing card before building the model
    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    cfg = dataclasses.replace(cfg, vocab_size=512, loss_chunk=32)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(
        cfg, params, max_batch=args.max_batch, max_cache=256,
        temperature=args.temperature, device=device,
    )
    rng = np.random.default_rng(1)
    prompts = [
        rng.integers(1, cfg.vocab_size, size=rng.integers(2, 24)).tolist()
        for _ in range(args.requests)
    ]
    t0 = time.perf_counter()
    results = engine.generate(prompts, max_new_tokens=args.max_new)
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in results)
    summary = {
        "arch": cfg.name,
        "requests": len(results),
        "generated_tokens": toks,
        "wall_s": round(dt, 3),
        "tok_per_s": round(toks / dt, 1),
        "sample": results[0].tokens[:8],
    }
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
