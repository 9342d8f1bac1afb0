"""The framework mines ITSELF, on the PyTorch port: the program of
``examples/mine_training_run.py`` on ``repro_torch``, printing the same
lines in the same order.  Train with an injected straggler + crash, then
apply graph-based process mining (the paper's technique) to the trainer's
own event log — the deviation shows up as a process variant.

The model's weights come from the trainer's ``torch.Generator`` (seed 0)
and the batches from the seeded token pipeline, so its losses are the
port's own, not the reference's.  Training and the mining run on
``--device`` (the card by default, with no fallback to the host).

    PYTHONPATH=src python examples/torch_mine_training_run.py
    PYTHONPATH=src python examples/torch_mine_training_run.py --device cpu
"""

import argparse
import dataclasses
import tempfile
import time

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainHParams
from repro_torch.core import (
    dfg_from_repository,
    discover_dependency_graph,
    filter_dfg,
    to_dot,
)
from repro_torch.data.lm_data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.train import Trainer

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
device = resolve_device(ap.parse_args().device)

cfg = dataclasses.replace(
    get_config("starcoder2-3b").reduced(), vocab_size=64, loss_chunk=8
)
data = TokenPipeline(vocab_size=cfg.vocab_size, batch=2, seq_len=16, seed=3,
                     branching=4)
hp = TrainHParams(learning_rate=3e-3, warmup_steps=2, total_steps=100)

crashed = {"done": False}


def chaos(step):
    if step == 7:
        time.sleep(1.0)  # straggler
    if step == 11 and not crashed["done"]:
        crashed["done"] = True
        raise RuntimeError("injected node failure")


tr = Trainer(cfg, hp, data, tempfile.mkdtemp(), ckpt_every=5, q_chunk=16,
             failure_injector=chaos, straggler_threshold=3.0, device=device)
out = tr.run(16)
print(f"trained to step {out['final_step']} "
      f"(crash at 11 → restored from checkpoint 10 and replayed)")
print("straggler report:", out["stragglers"])

# --- mine the run --------------------------------------------------------
repo = tr.collector.to_repository()
psi = dfg_from_repository(repo, device=device)
names = repo.activity_names
print(f"\nevent log: {repo.num_events} events over {repo.num_traces} steps; "
      f"activities: {names}")

starts, ends = repo.trace_boundaries()
model = discover_dependency_graph(
    filter_dfg(psi, 1), names, starts, ends, min_count=1, min_dependency=0.0
)
print("\nDFG of the training process (note the failure/restart variant):")
print(to_dot(model))
