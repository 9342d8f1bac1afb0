"""Batched serving on the PyTorch port: ragged prompts, waves,
per-sequence positions — the program of ``examples/serve_lm.py`` on
``repro_torch``, printing the same lines in the same order.

The model's weights come from a ``torch.Generator`` seeded with 0 and the
engine samples from its own generator (``seed=0``), so the tokens are the
port's own, not the reference's.  The engine runs on ``--device`` (the
card by default, with no fallback to the host).

    PYTHONPATH=src python examples/torch_serve_lm.py
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = resolve_device(ap.parse_args().device)

cfg = dataclasses.replace(
    get_config("gemma2-9b").reduced(), vocab_size=512, loss_chunk=32
)
params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
engine = ServeEngine(cfg, params, max_batch=4, max_cache=128, temperature=0.7,
                     seed=0, device=device)

rng = np.random.default_rng(0)
prompts = [
    rng.integers(1, cfg.vocab_size, size=n).tolist()
    for n in (3, 7, 12, 5, 9, 2, 20, 6)
]
t0 = time.perf_counter()
results = engine.generate(prompts, max_new_tokens=24)
dt = time.perf_counter() - t0

total = sum(len(r.tokens) for r in results)
where = (torch.cuda.get_device_name(device) if device.type == "cuda"
         else f"the CPU, {torch.get_num_threads()} threads")
print(f"{len(results)} requests, {total} tokens in {dt:.2f}s "
      f"({total / dt:.1f} tok/s on {where})")
for r in results[:3]:
    print(f"  prompt[{len(r.prompt):2d} toks] → {r.tokens[:10]}… ({r.finished})")

# the engine records its own process events — minable like everything else
repo = engine.collector.to_repository()
print(f"\nserver telemetry: {repo.num_events} events "
      f"({', '.join(repo.activity_names)})")
