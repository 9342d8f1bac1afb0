from . import ops
from .ops import (
    BIG_COST,
    align_dp,
    align_dp_device,
    align_dp_numpy,
    align_dp_plain,
    launch_counts,
    prepare,
    reset_launch_counts,
)

__all__ = [
    "ops", "BIG_COST",
    "align_dp", "align_dp_device", "align_dp_plain", "align_dp_numpy",
    "prepare", "launch_counts", "reset_launch_counts",
]
