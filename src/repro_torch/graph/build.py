"""Event-knowledge-graph construction — the paper's store, materialized.

The paper's central claim is that the event log should *live as a graph*
(Event / Case / Activity nodes with ``:DF``, ``:BELONGS_TO``, ``:OF_TYPE``
edges) so topology queries run inside the store instead of being re-derived
from flat arrays on every request.  :class:`EventGraph` is that store: a
property graph held as **CSR adjacency in host numpy arrays**, built once
per source and then answering DFG / neighborhood / process-map queries as
index lookups.

Two tiers, mirroring the columnar store:

* **full graph** — the three Event-node property columns in canonical
  (case-contiguous, time-sorted) order plus the ``:OF_TYPE`` (activity →
  events) and ``:BELONGS_TO`` (case → events) CSR indexes.  Event-level
  ``:DF`` edges stay implicit in the canonical order (event ``i`` →
  ``i+1`` within a case), exactly like :class:`EventRepository`;
* **topology-only graph** — for out-of-core memmap sources the event tables
  are skipped and only the aggregated activity-level ``:DF`` CSR (forward +
  reverse) plus node degrees are kept: O(A² + nnz) memory independent of E.

The two counting steps of a build run on the build's device: the dense Ψ
aggregation counts through :func:`repro_torch.core.dfg.dfg` (the
``dfg_count`` CUDA kernel on a card) and is then sparsified, and the
``:OF_TYPE`` node degrees count through the ``segment_count`` CUDA kernel.
On a CPU device ``auto`` counts both with numpy, as the reference does.
CSR assembly, the event tables and the :class:`WindowIndex` are host numpy.
Every count is an exact integer, so a build is bit-identical on every
device and backend.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.repository import EventRepository
from repro_torch.core.streaming import MemmapLog, MinerState, StreamingDFGMiner
from repro_torch.device import resolve_device

__all__ = [
    "EventGraph", "CSR", "WindowIndex", "build_graph", "build_window_index",
    "csr_from_dense", "dense_from_csr",
]


#: above this many dense Ψ cells, aggregation goes through the sorted-key
#: (segment-sort / segment-sum) path instead of densify-then-sparsify
_DENSE_PSI_CELLS = 1 << 24

#: dense-aggregation operators a build can be pinned to
BUILD_BACKENDS = ("auto", "numpy", "scatter", "onehot", "kernel")


@dataclasses.dataclass
class CSR:
    """One adjacency direction of the aggregated ``:DF`` multigraph:
    ``indices[indptr[a]:indptr[a+1]]`` are the neighbor activity ids of
    ``a`` (ascending), ``counts`` the multiplicity (Ψ entries)."""

    indptr: np.ndarray  # (A+1,) int64
    indices: np.ndarray  # (nnz,) int32
    counts: np.ndarray  # (nnz,) int64

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row(self, a: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.indptr[a]), int(self.indptr[a + 1])
        return self.indices[lo:hi], self.counts[lo:hi]

    def transpose(self) -> "CSR":
        """Reverse adjacency (CSC of the same matrix, as CSR)."""
        a = self.num_nodes
        rows = np.repeat(
            np.arange(a, dtype=np.int32), np.diff(self.indptr).astype(np.int64)
        )
        order = np.lexsort((rows, self.indices))
        indptr = np.zeros(a + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.indices, minlength=a), out=indptr[1:])
        return CSR(
            indptr=indptr,
            indices=rows[order].astype(np.int32),
            counts=self.counts[order].astype(np.int64),
        )


def csr_from_dense(psi: np.ndarray) -> CSR:
    """Sparsify a dense Ψ count matrix (row-major ⇒ ascending indices)."""
    rows, cols = np.nonzero(psi)
    indptr = np.zeros(psi.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=psi.shape[0]), out=indptr[1:])
    return CSR(
        indptr=indptr,
        indices=cols.astype(np.int32),
        counts=psi[rows, cols].astype(np.int64),
    )


def dense_from_csr(csr: CSR) -> np.ndarray:
    """Densify back to the (A, A) Ψ matrix — bit-identical to the matrix the
    CSR was aggregated from (counts are exact int64)."""
    a = csr.num_nodes
    psi = np.zeros((a, a), dtype=np.int64)
    rows = np.repeat(np.arange(a), np.diff(csr.indptr).astype(np.int64))
    psi[rows, csr.indices] = csr.counts
    return psi


@dataclasses.dataclass(frozen=True)
class WindowIndex:
    """Time-sorted index over a full graph's event tables.

    A windowed query against the canonical (trace-major) tables costs
    O(E) in masking passes however narrow the window.  This index sorts
    the *event* side by time and the *pair* side by source-endpoint time
    once, so a window [t0, t1) resolves to two binary searches plus work
    proportional to the rows actually inside the window.

    Correctness leans on canonical order being time-nondecreasing
    *within* each trace (so ``t_dst >= t_src`` for every :DF pair, making
    ``t_dst >= t0`` implied and ``t_src < t1`` part of the sorted range).
    :func:`build_window_index` verifies that invariant and returns None
    when it fails; callers then fall back to the masked path.
    """

    num_events: int  # staleness check: extends grow the tables
    etimes: np.ndarray  # (E,) float64, sorted
    eacts: np.ndarray  # (E,) int32, activity ids in time order
    pt_src: np.ndarray  # (P,) float64 source-endpoint times, sorted
    pt_dst: np.ndarray  # (P,) float64 dst-endpoint times, pair order
    psrc: np.ndarray  # (P,) int32
    pdst: np.ndarray  # (P,) int32

    def counts(self, t0: float, t1: float, a: int) -> np.ndarray:
        """Per-activity event counts under [t0, t1)."""
        lo, hi = np.searchsorted(self.etimes, (t0, t1))
        return np.bincount(self.eacts[lo:hi], minlength=a).astype(np.int64)

    def psi(self, t0: float, t1: float, a: int) -> np.ndarray:
        """Ψ under [t0, t1) — bit-identical to the pair-endpoint mask over
        the full tables."""
        from repro_torch.core.dfg import dfg_numpy

        plo, phi = np.searchsorted(self.pt_src, (t0, t1))
        valid = self.pt_dst[plo:phi] < t1
        return dfg_numpy(self.psrc[plo:phi], self.pdst[plo:phi], valid, a)

    def query(self, t0: float, t1: float, a: int):
        """(Ψ, node counts) under [t0, t1)."""
        return self.psi(t0, t1, a), self.counts(t0, t1, a)


def build_window_index(
    event_activity: np.ndarray,
    event_trace: np.ndarray,
    event_time: np.ndarray,
) -> Optional[WindowIndex]:
    """Build a :class:`WindowIndex`, or None when the tables violate the
    within-trace time order the O(window) query plan depends on."""
    acts = np.asarray(event_activity)
    traces = np.asarray(event_trace)
    times = np.asarray(event_time)
    n = acts.shape[0]
    eorder = np.argsort(times, kind="stable")
    if n < 2:
        empty_f = np.zeros((0,), dtype=np.float64)
        empty_i = np.zeros((0,), dtype=np.int32)
        return WindowIndex(
            num_events=n,
            etimes=np.ascontiguousarray(times[eorder]),
            eacts=np.ascontiguousarray(acts[eorder], dtype=np.int32),
            pt_src=empty_f, pt_dst=empty_f, psrc=empty_i, pdst=empty_i,
        )
    pair = np.flatnonzero(traces[:-1] == traces[1:])
    t_src, t_dst = times[pair], times[pair + 1]
    if not bool(np.all(t_dst >= t_src)):
        return None
    porder = np.argsort(t_src, kind="stable")
    return WindowIndex(
        num_events=n,
        etimes=np.ascontiguousarray(times[eorder]),
        eacts=np.ascontiguousarray(acts[eorder], dtype=np.int32),
        pt_src=np.ascontiguousarray(t_src[porder]),
        pt_dst=np.ascontiguousarray(t_dst[porder]),
        psrc=np.ascontiguousarray(acts[pair][porder], dtype=np.int32),
        pdst=np.ascontiguousarray(acts[pair + 1][porder], dtype=np.int32),
    )


@dataclasses.dataclass
class EventGraph:
    """In-process event-knowledge graph (see module docstring).

    ``adj`` / ``radj`` are the aggregated activity-level ``:DF`` relation
    (forward / reverse CSR) — the store's first-class topology.
    ``node_counts[a]`` is the ``:OF_TYPE`` in-degree of Activity node ``a``
    (events executing it), the process-map node significance.

    ``miner`` (memmap-sourced graphs) carries the resumable streaming state
    (Ψ + open-case tails) that lets :mod:`repro_torch.graph.store` extend
    the CSR over an appended suffix instead of rebuilding.
    """

    activity_names: List[str]
    num_events: int
    num_traces: int
    node_counts: np.ndarray  # (A,) int64
    adj: CSR
    radj: CSR
    # -- full-graph tier (None ⇒ topology-only) -----------------------------
    event_activity: Optional[np.ndarray] = None  # (E,) int32, canonical order
    event_trace: Optional[np.ndarray] = None  # (E,) int32
    event_time: Optional[np.ndarray] = None  # (E,) float64
    act_indptr: Optional[np.ndarray] = None  # (A+1,) :OF_TYPE CSR
    act_events: Optional[np.ndarray] = None  # (E,) event ids by activity
    case_indptr: Optional[np.ndarray] = None  # (T+1,) :BELONGS_TO CSR
    # -- provenance / append machinery --------------------------------------
    source_fp: Optional[str] = None  # fingerprint of the source at build time
    rows_end: int = 0  # memmap rows consumed (0 for repositories)
    miner: Optional[MinerState] = None  # memmap-sourced: resumable Ψ state
    # lazily built time index for O(window) windowed queries; a tuple marks
    # a graph whose tables can't support it (non-monotone trace times)
    _window_index: object = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def num_activities(self) -> int:
        return len(self.activity_names)

    @property
    def num_df_edges(self) -> int:
        """Total event-level ``:DF`` relations (Σ of the aggregated counts)."""
        return int(self.adj.counts.sum())

    @property
    def has_event_tables(self) -> bool:
        return self.event_activity is not None

    def psi(self) -> np.ndarray:
        """The dense Ψ count matrix — Algorithm 1's output, from the store."""
        return dense_from_csr(self.adj)

    def events_of_activity(self, a: int) -> np.ndarray:
        """``•a`` as a CSR lookup (full graphs only)."""
        if self.act_indptr is None:
            raise ValueError("topology-only graph has no event tables")
        lo, hi = int(self.act_indptr[a]), int(self.act_indptr[a + 1])
        return self.act_events[lo:hi]

    def events_of_case(self, t: int) -> Tuple[int, int]:
        """The ``:BELONGS_TO`` row of case ``t`` as a row range (events are
        case-contiguous in canonical order)."""
        if self.case_indptr is None:
            raise ValueError("topology-only graph has no event tables")
        return int(self.case_indptr[t]), int(self.case_indptr[t + 1])

    def window_index(self) -> Optional[WindowIndex]:
        """The lazily built :class:`WindowIndex` over this graph's event
        tables (None when unsupported: topology-only graphs, or tables
        whose within-trace times are not sorted).  Appends invalidate via
        the row count — an extend grows the tables, so the stale index is
        rebuilt on the next windowed query."""
        if self.event_time is None:
            return None
        idx = self._window_index
        if isinstance(idx, WindowIndex) and idx.num_events == self.num_events:
            return idx
        if idx == ("unsupported", self.num_events):
            return None
        idx = build_window_index(
            self.event_activity, self.event_trace, self.event_time
        )
        self._window_index = (
            idx if idx is not None else ("unsupported", self.num_events)
        )
        return idx


# ---------------------------------------------------------------------------
# Aggregation primitives (segment-sort / segment-sum)
# ---------------------------------------------------------------------------


def _aggregate_pairs_sparse(
    src: np.ndarray, dst: np.ndarray, valid: np.ndarray, a: int
) -> CSR:
    """Sort-based aggregation for graphs whose dense Ψ would not fit:
    segment-sort the pair keys, segment-sum the run lengths."""
    keys = src[valid].astype(np.int64) * a + dst[valid].astype(np.int64)
    keys.sort(kind="stable")
    if keys.shape[0] == 0:
        return CSR(
            indptr=np.zeros(a + 1, dtype=np.int64),
            indices=np.zeros((0,), dtype=np.int32),
            counts=np.zeros((0,), dtype=np.int64),
        )
    boundary = np.empty(keys.shape[0], dtype=bool)
    boundary[0] = True
    np.not_equal(keys[1:], keys[:-1], out=boundary[1:])
    uniq = keys[boundary]
    starts = np.nonzero(boundary)[0]
    counts = np.diff(np.append(starts, keys.shape[0])).astype(np.int64)
    rows = (uniq // a).astype(np.int64)
    indptr = np.zeros(a + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=a), out=indptr[1:])
    return CSR(
        indptr=indptr,
        indices=(uniq % a).astype(np.int32),
        counts=counts,
    )


def _resolve_backend(backend: str, device: torch.device) -> str:
    """``auto`` → the CUDA kernels on a card, numpy on the host."""
    if backend not in BUILD_BACKENDS:
        hint = " (the port calls it 'kernel')" if backend == "pallas" else ""
        raise ValueError(f"unknown graph build backend {backend!r}{hint}")
    if backend == "auto":
        return "numpy" if device.type == "cpu" else "kernel"
    return backend


def _aggregate_pairs(
    src: np.ndarray,
    dst: np.ndarray,
    valid: np.ndarray,
    a: int,
    backend: str = "auto",
    device="cuda",
) -> Tuple[CSR, Optional[np.ndarray]]:
    """(forward CSR, dense Ψ or None) from directly-follows pair columns.

    Dense regime counts through the DFG backends on ``device`` (numpy on the
    host; scatter, one-hot or the ``dfg_count`` kernel in torch) and
    sparsifies; the sparse regime segment-sorts the keys directly.
    """
    if a * a > _DENSE_PSI_CELLS:
        return _aggregate_pairs_sparse(src, dst, valid, a), None
    dev = resolve_device(device)
    backend = _resolve_backend(backend, dev)
    if backend == "numpy" or src.shape[0] == 0:
        from repro_torch.core.dfg import dfg_numpy

        psi = dfg_numpy(np.asarray(src), np.asarray(dst), np.asarray(valid), a)
    else:
        from repro_torch.core.dfg import dfg

        psi = dfg(src, dst, valid, a, backend=backend, device=dev)
    return csr_from_dense(psi), psi


def _node_counts(
    event_activity: np.ndarray, a: int, backend: str = "auto", device="cuda"
) -> np.ndarray:
    """``:OF_TYPE`` node degrees: the ``segment_count`` kernel on the
    ``kernel`` backend (``auto`` on a card), ``np.bincount`` otherwise."""
    dev = resolve_device(device)
    if _resolve_backend(backend, dev) == "kernel":
        from repro_torch.kernels.segment_count import segment_count

        ids = torch.from_numpy(np.ascontiguousarray(event_activity, np.int32))
        return segment_count(ids.to(dev), num_segments=a).cpu().numpy()
    return np.bincount(event_activity, minlength=a).astype(np.int64)


def _miner_state_from_columns(
    psi: np.ndarray,
    event_activity: np.ndarray,
    case_ids: np.ndarray,
    num_events: int,
) -> MinerState:
    """The :class:`MinerState` a streaming scan of the same rows would have
    left behind: Ψ plus the last (time-ordered) activity of every case —
    constructed vectorized from canonical columns, no second scan."""
    last_by_case: Dict[int, int] = {}
    if num_events:
        is_end = np.ones(case_ids.shape[0], dtype=bool)
        is_end[:-1] = case_ids[:-1] != case_ids[1:]
        last_by_case = dict(
            zip(case_ids[is_end].tolist(), event_activity[is_end].tolist())
        )
    return MinerState(
        psi=psi.astype(np.int64), last_by_case=last_by_case,
        events_seen=num_events,
    )


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def _event_tables(
    event_activity: np.ndarray,
    event_trace: np.ndarray,
    event_time: np.ndarray,
    a: int,
    t: int,
) -> dict:
    """The two node-expansion CSR indexes over canonical event columns."""
    order = np.argsort(event_activity, kind="stable")
    act_indptr = np.zeros(a + 1, dtype=np.int64)
    np.cumsum(np.bincount(event_activity, minlength=a), out=act_indptr[1:])
    case_indptr = np.zeros(t + 1, dtype=np.int64)
    np.cumsum(np.bincount(event_trace, minlength=t), out=case_indptr[1:])
    return dict(
        event_activity=np.ascontiguousarray(event_activity, dtype=np.int32),
        event_trace=np.ascontiguousarray(event_trace, dtype=np.int32),
        event_time=np.ascontiguousarray(event_time, dtype=np.float64),
        act_indptr=act_indptr,
        act_events=order.astype(np.int64),
        case_indptr=case_indptr,
    )


def _build_from_repository(
    repo: EventRepository, backend: str, source_fp: Optional[str], device
) -> EventGraph:
    a = repo.num_activities
    src, dst, valid = repo.df_pairs()
    adj, _ = _aggregate_pairs(src, dst, valid, a, backend, device)
    return EventGraph(
        activity_names=list(repo.activity_names),
        num_events=repo.num_events,
        num_traces=repo.num_traces,
        node_counts=_node_counts(repo.event_activity, a, backend, device),
        adj=adj,
        radj=adj.transpose(),
        source_fp=source_fp,
        **_event_tables(
            repo.event_activity, repo.event_trace, repo.event_time,
            a, repo.num_traces,
        ),
    )


def _build_from_memmap(
    log: MemmapLog,
    backend: str,
    source_fp: Optional[str],
    memory_budget_events: Optional[int],
    device,
) -> EventGraph:
    a = log.num_activities
    in_budget = (
        memory_budget_events is None
        or log.num_events <= memory_budget_events
    )
    if in_budget:
        # one materialization gives canonical event tables *and* the pair
        # columns; the miner state is reconstructed vectorized (no rescan)
        from repro_torch.query.execute import repository_from_memmap

        repo = repository_from_memmap(log)
        src, dst, valid = repo.df_pairs()
        adj, psi = _aggregate_pairs(src, dst, valid, a, backend, device)
        if psi is None:
            psi = dense_from_csr(adj)
        # miner keys are the log's raw case ids, not repo trace indices
        raw_case = np.asarray(log.case)
        order = np.lexsort(
            (np.arange(raw_case.shape[0]), np.asarray(log.time), raw_case)
        )
        miner = _miner_state_from_columns(
            psi, np.asarray(log.activity)[order], raw_case[order],
            log.num_events,
        )
        return EventGraph(
            activity_names=list(repo.activity_names),
            num_events=log.num_events,
            num_traces=repo.num_traces,
            node_counts=_node_counts(repo.event_activity, a, backend, device),
            adj=adj,
            radj=adj.transpose(),
            source_fp=source_fp,
            rows_end=log.num_events,
            miner=miner,
            **_event_tables(
                repo.event_activity, repo.event_trace, repo.event_time,
                a, repo.num_traces,
            ),
        )
    # out-of-core: one streaming scan on the host, topology-only
    # (O(A² + nnz) memory)
    miner = StreamingDFGMiner(a)
    node_counts = np.zeros(a, dtype=np.int64)
    for acts, cases, times in log.iter_chunks():
        miner.update(acts, cases, times)
        node_counts += np.bincount(acts, minlength=a)
    psi = miner.finalize()
    adj = csr_from_dense(psi)
    return EventGraph(
        activity_names=log.activity_labels(),
        num_events=log.num_events,
        num_traces=log.num_traces,
        node_counts=node_counts,
        adj=adj,
        radj=adj.transpose(),
        source_fp=source_fp,
        rows_end=log.num_events,
        miner=miner.snapshot(),
    )


def build_graph(
    source,
    *,
    backend: str = "auto",
    memory_budget_events: Optional[int] = None,
    source_fp: Optional[str] = None,
    device="cuda",
) -> EventGraph:
    """Construct the event-knowledge graph of a store.

    ``source`` is an :class:`EventRepository` or :class:`MemmapLog`;
    ``backend`` pins the dense-aggregation operator (``auto`` / ``numpy`` /
    ``scatter`` / ``onehot`` / ``kernel``) and ``device`` where it counts
    (``cuda`` unless the caller asks for ``cpu``; ``auto`` runs the CUDA
    kernels on a card and numpy on the host).  Memmap logs beyond
    ``memory_budget_events`` build a topology-only graph in one streaming
    scan.  ``source_fp`` (a :func:`repro_torch.query.cache.fingerprint`
    string) records provenance so snapshots can prove append-only
    extension.
    """
    dev = resolve_device(device)
    _resolve_backend(backend, dev)
    if isinstance(source, EventRepository):
        return _build_from_repository(source, backend, source_fp, dev)
    if isinstance(source, MemmapLog):
        return _build_from_memmap(
            source, backend, source_fp, memory_budget_events, dev
        )
    raise TypeError(
        f"build_graph expects EventRepository or MemmapLog, "
        f"got {type(source).__name__}"
    )
