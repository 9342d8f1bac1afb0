"""Graph-tier shard assignment (case-partitioned event-log shards).

The graph half of the reference's ``repro/sharding/spec.py``: the static
description of a case partition, the stable ``case % K`` rule, and a 1-D
mesh over the visible cards for running the shard merge on them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.compat import Mesh, make_mesh, visible_cards

__all__ = ["GraphShardSpec", "shard_of_cases", "graph_mesh"]


@dataclasses.dataclass(frozen=True)
class GraphShardSpec:
    """Static description of a case-partitioned log sharding.

    Cases are assigned whole to shards (``assignment="case_mod"`` maps case
    ``c`` to shard ``c % num_shards``), so every directly-follows pair is
    shard-local and the global Ψ is a pure sum of per-shard (A, A) counts on
    the aligned union vocabulary — the contract of
    :func:`repro_torch.core.distributed.distributed_dfg`.
    """

    num_shards: int
    assignment: str = "case_mod"

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if self.assignment != "case_mod":
            raise ValueError(f"unknown shard assignment {self.assignment!r}")

    def shard_of(self, case_ids: np.ndarray) -> np.ndarray:
        return shard_of_cases(case_ids, self.num_shards)


def shard_of_cases(case_ids, num_shards: int) -> np.ndarray:
    """Owning shard per case id under the stable ``case % K`` rule.

    Stability across appends is the load-bearing property: new events for an
    existing case always land on the shard that already holds that case, so
    an append touches only the owning shards and every other shard's
    prefix-preserving fingerprint (and therefore its cached graph) survives.
    """
    ids = np.asarray(case_ids, dtype=np.int64)
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    return ids % np.int64(num_shards)


def graph_mesh(num_shards: int) -> Optional[Mesh]:
    """1-D ``("shard",)`` mesh over up to ``num_shards`` visible cards, for
    running the shard merge on the cards; ``None`` when at most one card is
    visible (the host's aligned-sum merge needs no mesh)."""
    cards = visible_cards()
    n = min(num_shards, len(cards))
    if n <= 1:
        return None
    return make_mesh((n,), ("shard",), devices=cards[:n])
