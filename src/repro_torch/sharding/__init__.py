"""``repro_torch.sharding`` — the LM's logical-axis sharding rules (specs,
and their DTensor placements on a ``DeviceMesh``) and how case-partitioned
event logs map onto shards and cards."""

from .spec import (
    GraphShardSpec,
    ShardingRules,
    batch_shardings,
    cache_shardings,
    graph_mesh,
    make_rules,
    param_shardings,
    shard_of_cases,
)

__all__ = [
    "ShardingRules", "batch_shardings", "cache_shardings", "make_rules",
    "param_shardings", "GraphShardSpec", "graph_mesh", "shard_of_cases",
]
