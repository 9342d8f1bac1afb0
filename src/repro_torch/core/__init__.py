"""GraphPM core — the paper's primary contribution on PyTorch.

Event repositories (Definition 1), soundness (Definition 2), Algorithm 1
(DFG) in scatter / one-hot / CUDA-kernel formulations, dicing,
access-control views and analyst sessions, distributed (mesh) and
streaming (out-of-core) execution, DFG-based discovery and footprints, the
in-memory baseline, runtime telemetry mining, token-replay conformance and
trace variants.
"""

from .repository import (
    EventRepository,
    GraphRepo,
    concat_repositories,
    paper_example_repo,
)
from .soundness import SoundnessReport, check_columnar, check_graph, is_sound
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
from .views import HIDDEN, AccessPolicy, ActivityView, AnalystSession
from .distributed import distributed_dfg, lower_distributed_dfg, shard_pairs
from .discovery import (
    DiscoveredModel,
    dependency_matrix,
    discover_dependency_graph,
    filter_dfg,
    footprint,
    footprint_conformance,
    to_dot,
)
from .baseline import InMemoryDFGBaseline, dfg_from_rows
from .conformance import (
    ModelSpec,
    ReplayResult,
    deviation_census,
    model_tables,
    replay_core,
    replay_fitness,
)
from .telemetry import EventCollector, StepTimer
from .variants import (
    TraceVariants,
    trace_variants,
    variant_filtered_repository,
    variant_table,
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
    "EventRepository", "GraphRepo", "concat_repositories",
    "paper_example_repo",
    "SoundnessReport", "check_columnar", "check_graph", "is_sound",
    "dfg", "dfg_algorithm1", "dfg_from_repository", "dfg_numpy",
    "dfg_onehot", "dfg_scatter",
    "dice_repository", "event_mask_for_activities", "event_mask_for_window",
    "pair_mask_for_window",
    "HIDDEN", "AccessPolicy", "ActivityView", "AnalystSession",
    "distributed_dfg", "lower_distributed_dfg", "shard_pairs",
    "DiscoveredModel", "dependency_matrix", "discover_dependency_graph",
    "filter_dfg", "footprint", "footprint_conformance", "to_dot",
    "InMemoryDFGBaseline", "dfg_from_rows",
    "MemmapLog", "MemmapLogWriter", "MinerState", "StreamingDFGMiner",
    "memmap_log_name", "streaming_dfg",
    "ModelSpec", "ReplayResult", "deviation_census", "model_tables",
    "replay_core", "replay_fitness",
    "EventCollector", "StepTimer",
    "TraceVariants", "trace_variants", "variant_filtered_repository",
    "variant_table",
]
