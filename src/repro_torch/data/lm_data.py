"""Deterministic, resumable LM token pipeline.

``batch(step)`` is a pure function of ``(seed, step)`` — restart-safe by
construction: a trainer resuming from step k sees exactly the batches an
uninterrupted run would have seen (the fault-tolerance golden test relies
on this).

A copy of the reference's numpy code: the same ``(seed, step)`` gives the
same batch, bit for bit, in both packages.

Modes:
  * ``uniform`` — i.i.d. tokens (shape/throughput testing)
  * ``markov``  — a seeded bigram language; learnable structure so example
    training runs show loss ↓ below ln(V)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = ["TokenPipeline"]


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    mode: str = "markov"  # uniform | markov
    branching: int = 16  # markov out-degree (lower = easier to learn)

    def __post_init__(self):
        if self.mode == "markov":
            rng = np.random.default_rng(self.seed)
            V = self.vocab_size
            self._succ = rng.integers(
                0, V, size=(V, self.branching), dtype=np.int32
            )
            logits = rng.normal(size=(V, self.branching)) * 1.5
            p = np.exp(logits)
            self._p = (p / p.sum(axis=1, keepdims=True)).cumsum(axis=1)

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(step)])
        )
        B, S, V = self.batch, self.seq_len, self.vocab_size
        if self.mode == "uniform":
            toks = rng.integers(0, V, size=(B, S + 1), dtype=np.int32)
        else:
            toks = np.zeros((B, S + 1), dtype=np.int32)
            toks[:, 0] = rng.integers(0, V, size=B)
            u = rng.random(size=(B, S))
            for t in range(S):
                prev = toks[:, t]
                choice = (u[:, t, None] > self._p[prev]).sum(axis=1)
                toks[:, t + 1] = self._succ[
                    prev, np.minimum(choice, self.branching - 1)
                ]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def bigram_entropy(self) -> float:
        """Achievable NLL floor for the markov language (nats/token)."""
        if self.mode != "markov":
            return float(np.log(self.vocab_size))
        p = np.diff(np.concatenate(
            [np.zeros((self.vocab_size, 1)), self._p], axis=1
        ), axis=1)
        ent = -(p * np.log(np.maximum(p, 1e-12))).sum(axis=1)
        return float(ent.mean())
