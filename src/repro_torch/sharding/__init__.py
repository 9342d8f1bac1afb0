"""``repro_torch.sharding`` — how case-partitioned event logs map onto
shards and cards (the graph half of the reference's ``repro.sharding``;
the model-parallel rules come with the LM model zoo)."""

from .spec import GraphShardSpec, graph_mesh, shard_of_cases

__all__ = ["GraphShardSpec", "graph_mesh", "shard_of_cases"]
