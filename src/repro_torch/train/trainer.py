"""Fault-tolerant trainer.

Production behaviours exercised here (and covered by tests):

* **checkpoint/restart** — periodic async checkpoints; on a step failure the
  trainer restores the latest checkpoint and replays.  Because the data
  pipeline is a pure function of the step index, a crashed-and-restarted run
  is *bitwise identical* to an uninterrupted one (golden test).
* **failure injection** — deterministic fault hook for tests/chaos drills.
* **straggler detection** — per-phase telemetry; a step slower than
  ``straggler_threshold ×`` running median flags a straggler event.
* **telemetry mining** — every phase is recorded into an
  :class:`repro_torch.core.telemetry.EventCollector`, so the trainer's own
  execution process is an event log the query engine mines.

One step is eager: ``train_loss`` → ``backward`` → :func:`adamw_update`
(in place).  The trainer runs on the card unless it is given
``device="cpu"``.  Checkpoints hold ``(params, OptState(step, mu, nu))`` in
the reference's stacked layout (:mod:`repro_torch.models.convert`), so the
reference's trainer resumes from the port's checkpoints and the other way
round.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint.checkpointer import CheckpointManager
from ..configs.base import ModelConfig, TrainHParams
from ..core.telemetry import EventCollector
from ..device import resolve_device
from ..models import init_params, train_loss
from ..models.convert import (
    opt_state_from_reference, opt_state_to_reference, params_from_reference,
    params_to_reference, tree_from_named,
)
from ..models.model import DecoderLM
from .optimizer import OptState, adamw_update, init_opt_state

__all__ = ["Trainer", "TrainerError"]


class TrainerError(RuntimeError):
    pass


@dataclasses.dataclass
class Trainer:
    cfg: ModelConfig
    hp: TrainHParams
    data: Callable[[int], Dict[str, np.ndarray]]
    ckpt_dir: str
    ckpt_every: int = 50
    max_retries: int = 3
    straggler_threshold: float = 3.0
    q_chunk: int = 1024
    seed: int = 0
    failure_injector: Optional[Callable[[int], None]] = None
    collector: EventCollector = dataclasses.field(
        default_factory=lambda: EventCollector("trainer")
    )
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.ckpt = CheckpointManager(self.ckpt_dir, keep=3, async_writes=True)
        self._step_times: List[float] = []
        self.history: List[float] = []

    # -- state ------------------------------------------------------------
    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = init_params(self.cfg, gen, self.device)
        return params, init_opt_state(params)

    def restore_or_init(self):
        latest = self.ckpt.latest_step()
        if latest is None:
            params, opt = self.init_state()
            return params, opt, 0
        named = dict(DecoderLM(self.cfg, None, "meta").named_parameters())
        skeleton = tree_from_named(self.cfg, named)
        template = (skeleton, OptState(0, skeleton, skeleton))
        (params, opt), meta = self.ckpt.restore(latest, template=template)
        params = params_from_reference(self.cfg, params, self.device)
        opt = opt_state_from_reference(self.cfg, opt, self.device)
        return params, opt, int(meta["next_step"])

    def _step(self, params: DecoderLM, opt: OptState, batch):
        batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                 for k, v in batch.items()}
        loss = train_loss(self.cfg, params, batch, q_chunk=self.q_chunk)
        loss.backward()
        grads = {n: p.grad for n, p in params.named_parameters()}
        params, opt, metrics = adamw_update(self.hp, params, grads, opt)
        params.zero_grad(set_to_none=True)
        return params, opt, loss.detach(), metrics

    # -- main loop -----------------------------------------------------------
    def run(self, num_steps: int) -> Dict:
        params, opt, start = self.restore_or_init()
        step = start
        retries = 0
        while step < num_steps:
            case = f"step-{step}"
            t0 = time.perf_counter()
            try:
                if self.failure_injector is not None:
                    self.failure_injector(step)
                with self.collector.span(case, "load_batch"):
                    batch = self.data(step)
                with self.collector.span(case, "train_step"):
                    params, opt, loss, metrics = self._step(params, opt, batch)
                    loss = float(loss)
                with self.collector.span(case, "log"):
                    self.history.append(loss)
                if (step + 1) % self.ckpt_every == 0:
                    with self.collector.span(case, "checkpoint"):
                        self.ckpt.save(
                            step + 1,
                            (params_to_reference(self.cfg, params),
                             opt_state_to_reference(self.cfg, opt)),
                            metadata={"next_step": step + 1, "loss": loss},
                        )
                dt = time.perf_counter() - t0
                self._check_straggler(case, dt)
                step += 1
                retries = 0
            except TrainerError:
                raise
            except Exception as e:  # noqa: BLE001 — node failure path
                retries += 1
                self.collector.record(case, "failure", duration=0.0)
                if retries > self.max_retries:
                    self.ckpt.wait()
                    raise TrainerError(
                        f"step {step} failed {retries} times"
                    ) from e
                self.ckpt.wait()
                params = opt = None  # free the device state before restoring
                params, opt, step = self.restore_or_init()
                self.collector.record(f"step-{step}", "restart", duration=0.0)
        self.ckpt.wait()
        return {
            "final_step": step,
            "history": list(self.history),
            "stragglers": self.collector.straggler_report(
                self.straggler_threshold
            ),
        }

    def _check_straggler(self, case: str, dt: float) -> None:
        self._step_times.append(dt)
        if len(self._step_times) >= 5:
            med = float(np.median(self._step_times))
            if med > 0 and dt > self.straggler_threshold * med:
                # mitigation hook: on a cluster this triggers re-slicing /
                # hot-spare swap; here it is recorded for mining
                self.collector.record(case, "straggler_detected", duration=dt)
