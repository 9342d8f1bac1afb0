"""Hand-written CUDA kernels for the compute hot-spots the paper optimizes.

The paper's single hot loop is the in-store DFG computation (its Cypher
MATCH); :mod:`repro_torch.kernels.dfg_count` is its Hopper version (an
integer histogram on the pair key, with the WHERE-clause window fused in).
:mod:`repro_torch.kernels.segment_count` counts the graph store's
``:OF_TYPE`` node degrees.  Sources live under each kernel's ``csrc/`` and
are built at first use by :mod:`repro_torch.kernels.build`.
"""

from . import dfg_count, segment_count

__all__ = ["dfg_count", "segment_count"]
