from . import ops
from .ops import (
    dfg_count,
    dfg_count_diced,
    dfg_count_diced_plain,
    dfg_count_plain,
    launch_counts,
    reset_launch_counts,
)

__all__ = [
    "ops",
    "dfg_count", "dfg_count_diced",
    "dfg_count_plain", "dfg_count_diced_plain",
    "launch_counts", "reset_launch_counts",
]
