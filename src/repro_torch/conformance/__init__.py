"""``repro_torch.conformance`` — graph-native conformance checking.

The paper positions the in-store DFG as the backbone for "discovery,
conformance, and enhancement" (§2.1); this subsystem makes conformance run
*where the data lives*:

* :mod:`repro_torch.conformance.replay` — token replay as segment walks over
  the event-knowledge graph's stored tables, plus a resumable
  :class:`StreamingReplayer` for out-of-core memmap logs (one O(chunk)
  scan);
* :mod:`repro_torch.conformance.align` — optimal DFG alignments (skip /
  insert / move-on-model edit distance over the model's edge relation),
  batched per variant through the :mod:`repro_torch.kernels.align_dp` CUDA
  kernel.

All replay paths are held bit-identical to the columnar oracle
:func:`repro_torch.core.conformance.replay_fitness`; the query engine plans
them via ``Q....fitness()`` / ``Q....alignments()`` (see
:mod:`repro_torch.query`).
"""

from repro_torch.core.conformance import (
    ModelSpec,
    ReplayResult,
    deviation_census,
    model_tables,
    replay_fitness,
)

from .align import (
    AlignmentResult,
    align_arrays,
    align_repository,
    align_variants,
    alignment_cost_tables,
)
from .replay import (
    ReplayState,
    StreamingModelDiscoverer,
    StreamingReplayer,
    replay_fitness_arrays,
    replay_fitness_graph,
    replay_fitness_streaming,
)

__all__ = [
    "ModelSpec", "ReplayResult", "replay_fitness", "model_tables",
    "deviation_census",
    "ReplayState", "StreamingReplayer", "StreamingModelDiscoverer",
    "replay_fitness_arrays", "replay_fitness_graph",
    "replay_fitness_streaming",
    "AlignmentResult", "align_repository", "align_variants", "align_arrays",
    "alignment_cost_tables",
]
