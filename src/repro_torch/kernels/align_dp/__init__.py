from . import ops
from .ops import (
    BIG_COST,
    align_dp,
    align_dp_device,
    align_dp_numpy,
    align_dp_plain,
    align_dp_ragged,
    launch_counts,
    prepare,
    prepare_ragged,
    reset_launch_counts,
)

__all__ = [
    "ops", "BIG_COST",
    "align_dp", "align_dp_ragged", "align_dp_device", "align_dp_plain",
    "align_dp_numpy", "prepare", "prepare_ragged",
    "launch_counts", "reset_launch_counts",
]
