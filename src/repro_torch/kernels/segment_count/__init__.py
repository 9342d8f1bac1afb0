from . import ops
from .ops import (
    launch_counts,
    reset_launch_counts,
    segment_count,
    segment_count_plain,
)

__all__ = [
    "ops",
    "segment_count", "segment_count_plain",
    "launch_counts", "reset_launch_counts",
]
