"""GraphPM core — the paper's primary contribution on PyTorch.

Event repositories (Definition 1), Algorithm 1 (DFG) in scatter / one-hot /
CUDA-kernel formulations, dicing, access-control views, streaming
(out-of-core) execution, and DFG-based discovery.
"""

from .repository import EventRepository, GraphRepo, paper_example_repo
from .dfg import (
    dfg,
    dfg_algorithm1,
    dfg_from_repository,
    dfg_numpy,
    dfg_onehot,
    dfg_scatter,
)
from .dicing import (
    dice_repository,
    event_mask_for_activities,
    event_mask_for_window,
    pair_mask_for_window,
)
from .views import HIDDEN, ActivityView
from .discovery import (
    DiscoveredModel,
    dependency_matrix,
    discover_dependency_graph,
    filter_dfg,
    to_dot,
)
from .streaming import (
    MemmapLog,
    MemmapLogWriter,
    MinerState,
    StreamingDFGMiner,
    memmap_log_name,
    streaming_dfg,
)

__all__ = [
    "EventRepository", "GraphRepo", "paper_example_repo",
    "dfg", "dfg_algorithm1", "dfg_from_repository", "dfg_numpy",
    "dfg_onehot", "dfg_scatter",
    "dice_repository", "event_mask_for_activities", "event_mask_for_window",
    "pair_mask_for_window",
    "HIDDEN", "ActivityView",
    "DiscoveredModel", "dependency_matrix", "discover_dependency_graph",
    "filter_dfg", "to_dot",
    "MemmapLog", "MemmapLogWriter", "MinerState", "StreamingDFGMiner",
    "memmap_log_name", "streaming_dfg",
]
