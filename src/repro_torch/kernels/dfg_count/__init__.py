from . import ops, ref
from .ops import (
    dfg_count,
    dfg_count_diced,
    dfg_count_diced_plain,
    dfg_count_plain,
    launch_counts,
    reset_launch_counts,
)
from .ref import dfg_count_diced_ref, dfg_count_ref

__all__ = [
    "ops", "ref",
    "dfg_count", "dfg_count_diced",
    "dfg_count_plain", "dfg_count_diced_plain",
    "launch_counts", "reset_launch_counts",
    "dfg_count_ref", "dfg_count_diced_ref",
]
