"""``repro_torch.graph`` — the event-knowledge-graph tier.

The paper's storage thesis made concrete: the event log *lives as a graph*
(Event / Case / Activity nodes; ``:DF``, ``:BELONGS_TO``, ``:OF_TYPE``
edges) held as CSR adjacency in arrays, so DFG / neighborhood /
process-map queries are store lookups instead of per-query scans.

    from repro_torch.graph import build_graph, neighborhood, process_map

    g = build_graph(repo)               # or a MemmapLog; device="cuda"
    g.psi()                             # Algorithm 1, as a lookup
    neighborhood(g, "a3", k=2)          # k-hop :DF successors
    process_map(g, top=0.2)             # ProFIT-style significance filter

A build on the card counts Ψ with the ``dfg_count`` kernel and the node
degrees with the ``segment_count`` kernel.  The query engine exposes the
same store as the ``graph`` physical backend (``Q.log(...).process_map()``,
``.neighborhood(act, k)``, ``.histogram()`` or ``.dfg(backend="graph")``);
:class:`~repro_torch.graph.store.GraphStore` keeps built graphs keyed by
source fingerprint and extends them in place over proven append-only
suffixes.
"""

from .build import (
    CSR,
    EventGraph,
    WindowIndex,
    build_graph,
    build_window_index,
    csr_from_dense,
    dense_from_csr,
)
from .store import (
    GraphStore,
    GraphStoreStats,
    extend_graph,
    load_graph,
    save_graph,
)
from .traverse import (
    Neighborhood,
    ProcessMap,
    derive_neighborhood,
    derive_process_map,
    dfg_from_graph,
    neighborhood,
    path_frequencies,
    process_map,
)

__all__ = [
    "CSR", "EventGraph", "build_graph", "csr_from_dense", "dense_from_csr",
    "WindowIndex", "build_window_index",
    "GraphStore", "GraphStoreStats", "save_graph", "load_graph",
    "extend_graph",
    "Neighborhood", "ProcessMap", "dfg_from_graph", "neighborhood",
    "derive_neighborhood", "path_frequencies", "process_map",
    "derive_process_map",
]
