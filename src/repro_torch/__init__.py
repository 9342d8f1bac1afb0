"""Graph-based process mining (Jalali 2020) on PyTorch and CUDA.

A port of the ``repro`` package to one NVIDIA Hopper card.  It imports
torch, numpy and the standard library only.  This slice carries the paper's
main pipeline:

  core     — event repositories, Algorithm 1 DFG, dicing, views, streaming
             (out-of-core) mining, discovery
  data     — the synthetic BPI-like log generator
  graph    — the event-knowledge graph store (CSR), its snapshots and
             topology sinks
  kernels  — hand-written CUDA kernels (dfg_count, segment_count)
  query    — the declarative query engine, ``Q.log(...).dfg()``,
             ``.histogram()``, ``.process_map()``, ``.neighborhood()``
  obs      — per-query traces and metrics
  launch   — the mining CLI (``python -m repro_torch.launch.mine``)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
