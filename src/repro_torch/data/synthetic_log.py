"""Synthetic BPI-like event log generator (BPI-2016 substitute, see DESIGN §7).

Simulates a business process as a Markov chain over activities with
designated entry/exit distributions, heavy-tailed trace lengths, and Poisson
case arrivals over a configurable horizon (~4 months by default, matching
the paper's Experiment 2 dicing range).  Deterministic per seed.

Two emission paths:
  * :func:`generate_repository` — in-memory `EventRepository` (small/medium)
  * :func:`generate_memmap_log` — streams straight to the disk tier without
    ever materializing the log (used to build ≫-RAM logs for Claim C1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.repository import EventRepository
from repro_torch.core.streaming import MemmapLog

__all__ = ["ProcessSpec", "generate_repository", "generate_memmap_log"]

DAY = 86400.0


@dataclasses.dataclass
class ProcessSpec:
    """A random-but-structured process model."""

    num_activities: int = 26
    mean_trace_len: float = 12.0  # geometric-ish tail
    max_trace_len: int = 200
    branching: int = 4  # out-degree of the underlying process graph
    horizon_days: float = 120.0
    seed: int = 0

    def build(self) -> "_ProcessModel":
        rng = np.random.default_rng(self.seed)
        A = self.num_activities
        br = min(self.branching, A)  # out-degree can't exceed |A|
        # sparse transition structure: each activity can go to `br`
        # successors (weights Dirichlet), giving a non-trivial DFG shape
        succ = np.zeros((A, br), dtype=np.int64)
        w = np.zeros((A, br))
        for a in range(A):
            succ[a] = rng.choice(A, size=br, replace=False)
            w[a] = rng.dirichlet(np.ones(br))
        entry_acts = rng.choice(A, size=min(5, A), replace=False)
        entry = rng.dirichlet(np.ones(entry_acts.shape[0]))
        p_stop = 1.0 / self.mean_trace_len
        return _ProcessModel(self, succ, w, entry_acts, entry, p_stop)


@dataclasses.dataclass
class _ProcessModel:
    spec: ProcessSpec
    succ: np.ndarray
    w: np.ndarray
    entry_acts: np.ndarray
    entry_w: np.ndarray
    p_stop: float

    def sample_lens(self, num_traces: int, rng: np.random.Generator) -> np.ndarray:
        return np.minimum(
            rng.geometric(self.p_stop, size=num_traces) + 1,
            self.spec.max_trace_len,
        )

    def sample_traces(
        self,
        lens: np.ndarray,
        rng: np.random.Generator,
        horizon_s: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized trace sampling for given per-trace lengths.

        Returns flat (case, activity, time) arrays sorted by time
        (a time-ordered stream with interleaved cases)."""
        spec = self.spec
        num_traces = lens.shape[0]
        horizon = horizon_s if horizon_s is not None else spec.horizon_days * DAY
        total = int(lens.sum())
        case = np.repeat(np.arange(num_traces, dtype=np.int64), lens).astype(np.int32)
        arrivals = rng.uniform(0, horizon * 0.8, size=num_traces)
        offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
        pos_in_case = np.arange(total, dtype=np.int64) - np.repeat(offsets, lens)
        gaps = rng.exponential(600.0, size=total)  # ~10 min between steps
        cum = np.cumsum(gaps)
        base = np.repeat(
            np.concatenate([[0.0], cum[np.cumsum(lens)[:-1] - 1]]), lens
        )
        within = cum - base
        time = np.repeat(arrivals, lens) + within * (pos_in_case > 0)
        # keep every event inside the horizon (monotone clamp; ties are
        # resolved by stable sorts downstream, preserving case order)
        time = np.minimum(time, horizon - 1e-3)

        act = np.zeros(total, dtype=np.int32)
        starts = offsets
        act[starts] = rng.choice(
            self.entry_acts, size=num_traces, p=self.entry_w
        ).astype(np.int32)
        max_len = int(lens.max()) if total else 0
        for step in range(1, max_len):
            mask = lens > step
            idx = starts[mask] + step
            prev = act[idx - 1]
            u = rng.random(idx.shape[0])
            cdf = np.cumsum(self.w[prev], axis=1)
            choice = (u[:, None] > cdf).sum(axis=1)
            act[idx] = self.succ[prev, np.minimum(choice, self.succ.shape[1] - 1)]
        order = np.argsort(time, kind="stable")
        return case[order], act[order], time[order]


def generate_repository(
    num_traces: int,
    spec: Optional[ProcessSpec] = None,
    seed: int = 0,
) -> EventRepository:
    spec = spec or ProcessSpec(seed=seed)
    model = spec.build()
    rng = np.random.default_rng(seed + 1)
    lens = model.sample_lens(num_traces, rng)
    case, act, time = model.sample_traces(lens, rng)
    vocab = [f"act_{i:03d}" for i in range(spec.num_activities)]
    width = len(str(max(num_traces, 1)))
    return EventRepository.from_event_table(
        [f"case_{c:0{width}d}" for c in case],
        [vocab[a] for a in act],
        time,
        activity_vocab=vocab,
    )


def generate_memmap_log(
    path: str,
    num_events_target: int,
    spec: Optional[ProcessSpec] = None,
    seed: int = 0,
    batch_traces: int = 50_000,
) -> MemmapLog:
    """Stream a large log straight to disk; O(batch) memory.

    Batch ``k`` owns the disjoint time slab ``[k·slab, (k+1)·slab)`` so the
    resulting stream is globally time-ordered without a global sort."""
    spec = spec or ProcessSpec(seed=seed)
    model = spec.build()

    # Pass 1: per-batch trace counts/lengths (deterministic, O(batch) each).
    batch_lens = []
    remaining = num_events_target
    bi = 0
    while remaining > 0:
        sub = np.random.default_rng((seed + 1) * 1_000_003 + 2 * bi)
        lens = model.sample_lens(batch_traces, sub)
        csum = np.cumsum(lens)
        if csum[-1] > remaining:
            k = int(np.searchsorted(csum, remaining)) + 1
            lens = lens[:k]
        batch_lens.append(lens)
        remaining -= int(lens.sum())
        bi += 1

    total_events = int(sum(int(l.sum()) for l in batch_lens))
    total_traces = int(sum(l.shape[0] for l in batch_lens))
    writer = MemmapLog.create(path, total_events, spec.num_activities, total_traces)
    slab = spec.horizon_days * DAY / len(batch_lens)
    case_base = 0
    for bi, lens in enumerate(batch_lens):
        sub = np.random.default_rng((seed + 1) * 1_000_003 + 2 * bi + 1)
        case, act, time = model.sample_traces(lens, sub, horizon_s=slab)
        writer.append(act, case + case_base, time + bi * slab)
        case_base += lens.shape[0]
    return writer.close()
