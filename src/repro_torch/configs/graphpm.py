"""The paper's own workload as a config (the GraphPM analytic job).

Mirrors the evaluation setup of the paper: BPI-2016-scale click log
(~7.2M events), ~4-month horizon, accumulating-day dices.  Consumed by
``chip_smoke.py``, which drives the port's main path at this size.
"""

from __future__ import annotations

import dataclasses

__all__ = ["GraphPMConfig", "PAPER_EVAL"]


@dataclasses.dataclass(frozen=True)
class GraphPMConfig:
    name: str
    num_events: int
    num_activities: int
    horizon_days: float
    mean_trace_len: float
    # execution
    backend: str = "auto"  # scatter | onehot | kernel | auto
    chunk_events: int = 1 << 20  # streaming-tier chunk
    dice_step_days: float = 1.0  # Experiment-2 accumulation step


# the paper's evaluation scale (BPI-2016 clicks: ~7.2M events; the paper
# dices "for almost four months" in 1-day accumulating windows)
PAPER_EVAL = GraphPMConfig(
    name="bpi2016-scale",
    num_events=7_200_000,
    num_activities=600,  # click-log page granularity, coarsened
    horizon_days=120.0,
    mean_trace_len=12.0,
)
