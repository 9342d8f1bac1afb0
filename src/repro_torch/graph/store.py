"""Graph-snapshot persistence + the append-aware in-process graph registry.

A built :class:`~repro_torch.graph.build.EventGraph` is worth keeping: the
whole point of the graph tier is that construction cost is paid once and every
later topology query is a lookup.  Two layers:

* :func:`save_graph` / :func:`load_graph` — a memmap-backed on-disk format
  (one ``.npy`` per array + ``meta.json``); loading maps the CSR arrays
  read-only (``mmap_mode="r"``), so opening a snapshot is O(metadata) and
  pages in only what queries touch;
* :class:`GraphStore` — the in-process registry the query engine consults:
  graphs keyed by **source fingerprint**, extended over appends.  A memmap log that grew since the graph was built is
  *proven* append-only (``prefix_digest`` recomputed on the current bytes —
  never assumed from the path hint), and the stored miner state (Ψ +
  open-case tails) resumes over just the suffix: the CSR is extended in
  place of a rebuild, O(suffix + A² + nnz) instead of O(E).

Snapshots carry the same prefix-preserving source fingerprint
(``memmap:<prefix_digest>:<rows>:<A>``), so a snapshot saved before an
append still proves and extends after reload — the round-trip the tests
pin: build → save → load → append → extend ≡ fresh build, array for array.
The format is byte-compatible with the reference package's snapshots (same
``.npy`` arrays and ``meta.json``), so each package loads the other's.

With a ``spill_dir`` the registry becomes **two-tier**: a local LRU of
materialized graphs over a manifest of snapshots on disk.  Evicted graphs are spilled to fingerprint-addressed
snapshot directories recorded in ``spill_dir/manifest.json``; a later miss
on that fingerprint *pages the snapshot in* (O(metadata), arrays mmap'd
read-only) instead of rebuilding, and a proven append can extend a paged-in
snapshot — suffix-only, never O(E).  Snapshots are immutable once written
(a fingerprint names exact bytes), so spilling an already-manifested
fingerprint is a no-op and concurrent spills of the same graph are benign.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.lockdep import make_lock
from repro_torch.core.streaming import MemmapLog, MinerState, StreamingDFGMiner
from repro_torch.obs import MetricsRegistry

from .build import CSR, EventGraph, build_graph, csr_from_dense

__all__ = [
    "save_graph",
    "load_graph",
    "extend_graph",
    "GraphStore",
    "GraphStoreStats",
]

_FORMAT_VERSION = 1

_CSR_FIELDS = ("indptr", "indices", "counts")
_TABLE_FIELDS = (
    "event_activity", "event_trace", "event_time",
    "act_indptr", "act_events", "case_indptr",
)


# ---------------------------------------------------------------------------
# On-disk snapshots
# ---------------------------------------------------------------------------


def save_graph(g: EventGraph, path: str) -> None:
    """Persist a graph snapshot (overwrites an existing snapshot at
    ``path`` — e.g. re-saving after an extension)."""
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {"node_counts": g.node_counts}
    for prefix, csr in (("adj", g.adj), ("radj", g.radj)):
        for f in _CSR_FIELDS:
            arrays[f"{prefix}_{f}"] = getattr(csr, f)
    if g.has_event_tables:
        for f in _TABLE_FIELDS:
            arrays[f] = getattr(g, f)
    if g.miner is not None:
        arrays["miner_psi"] = g.miner.psi
        keys = np.asarray(sorted(g.miner.last_by_case), dtype=np.int64)
        arrays["miner_case"] = keys
        arrays["miner_last"] = np.asarray(
            [g.miner.last_by_case[int(k)] for k in keys], dtype=np.int64
        )
    for name, arr in arrays.items():
        np.save(os.path.join(path, f"{name}.npy"), np.asarray(arr))
    meta = {
        "format": _FORMAT_VERSION,
        "activity_names": g.activity_names,
        "num_events": g.num_events,
        "num_traces": g.num_traces,
        "rows_end": g.rows_end,
        "source_fp": g.source_fp,
        "has_event_tables": g.has_event_tables,
        "has_miner": g.miner is not None,
        "miner_events_seen": (
            g.miner.events_seen if g.miner is not None else None
        ),
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_graph(path: str, mmap: bool = True) -> EventGraph:
    """Open a snapshot; with ``mmap`` (default) the arrays stay on disk and
    page in on first touch."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != _FORMAT_VERSION:
        raise ValueError(
            f"unsupported graph snapshot format {meta.get('format')!r}"
        )
    mode = "r" if mmap else None

    def arr(name: str) -> np.ndarray:
        return np.load(os.path.join(path, f"{name}.npy"), mmap_mode=mode)

    def csr(prefix: str) -> CSR:
        return CSR(*(arr(f"{prefix}_{f}") for f in _CSR_FIELDS))

    tables = {}
    if meta["has_event_tables"]:
        tables = {f: arr(f) for f in _TABLE_FIELDS}
    miner = None
    if meta["has_miner"]:
        # the miner state is mutated on resume: load a private copy
        keys = np.load(os.path.join(path, "miner_case.npy"))
        last = np.load(os.path.join(path, "miner_last.npy"))
        miner = MinerState(
            psi=np.load(os.path.join(path, "miner_psi.npy")),
            last_by_case={int(k): int(v) for k, v in zip(keys, last)},
            events_seen=int(meta["miner_events_seen"]),
        )
    return EventGraph(
        activity_names=list(meta["activity_names"]),
        num_events=int(meta["num_events"]),
        num_traces=int(meta["num_traces"]),
        node_counts=arr("node_counts"),
        adj=csr("adj"),
        radj=csr("radj"),
        source_fp=meta["source_fp"],
        rows_end=int(meta["rows_end"]),
        miner=miner,
        **tables,
    )


# ---------------------------------------------------------------------------
# Append-aware extension (the delta machinery on the graph tier)
# ---------------------------------------------------------------------------


def _proves_append_only(g: EventGraph, log: MemmapLog) -> bool:
    """True iff ``log`` is a proven append-only extension of the rows the
    graph consumed — same proof the engine's delta plans use."""
    from repro_torch.query.cache import parse_memmap_fingerprint, prefix_digest

    if g.miner is None or g.source_fp is None:
        return False
    old = parse_memmap_fingerprint(g.source_fp)
    if old is None or not 0 < old.num_events < log.num_events:
        return False
    if old.num_activities > log.num_activities:
        return False  # vocabulary shrank: not an append
    return prefix_digest(log, old.num_events) == old.prefix


def extend_graph(
    g: EventGraph,
    log: MemmapLog,
    *,
    memory_budget_events: Optional[int] = None,
    source_fp: Optional[str] = None,
) -> EventGraph:
    """Extend a memmap-sourced graph over the log's appended suffix.

    The caller must have proven the append (see :func:`_proves_append_only`;
    :class:`GraphStore` does).  The stored miner state resumes over rows
    ``[rows_end, num_events)`` — boundary pairs are linked through the
    carried per-case tails — and the CSR / node degrees are updated from
    the new Ψ: O(suffix + A² + nnz), never O(E).  Event tables (when the
    old graph had them and the grown log still fits the budget) are
    re-materialized from the log, identical to a fresh build.
    """
    a = log.num_activities
    miner = StreamingDFGMiner.restore(g.miner, num_activities=a)
    node_counts = np.zeros(a, dtype=np.int64)
    node_counts[: g.node_counts.shape[0]] = g.node_counts
    for acts, cases, times in log.iter_chunks(
        row_range=(g.rows_end, log.num_events)
    ):
        miner.update(acts, cases, times)
        node_counts += np.bincount(acts, minlength=a)
    adj = csr_from_dense(miner.finalize())

    tables: dict = {}
    in_budget = (
        memory_budget_events is None
        or log.num_events <= memory_budget_events
    )
    if g.has_event_tables and in_budget:
        from repro_torch.query.execute import repository_from_memmap

        from .build import _event_tables

        repo = repository_from_memmap(log)
        tables = _event_tables(
            repo.event_activity, repo.event_trace, repo.event_time,
            a, repo.num_traces,
        )
    if source_fp is None:
        from repro_torch.query.cache import fingerprint_memmap

        source_fp = fingerprint_memmap(log)
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
        **tables,
    )


# ---------------------------------------------------------------------------
# In-process registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphStoreStats:
    """Point-in-time snapshot; the live counters sit in the store's
    :class:`repro_torch.obs.MetricsRegistry` (shared with the engine's when
    the engine constructed the store), so increments are lock-protected."""

    builds: int = 0
    extends: int = 0  # append-proven CSR extensions (suffix-only scans)
    hits: int = 0
    spills: int = 0  # LRU evictions persisted to the disk tier
    pageins: int = 0  # misses served from the disk tier instead of a build


class GraphStore:
    """LRU registry of built graphs keyed by source fingerprint.

    ``graph_for`` is the engine's single entry point: a fingerprint hit is
    O(1); a memmap source whose bytes grew since the last build is extended
    via the prefix-digest proof (suffix-only scan); anything else builds
    fresh.  Thread-safe; concurrent requests for one fingerprint wait for
    a single build.  Builds run on ``device`` (``cuda`` unless the caller
    asks for ``cpu``), so a full build counts Ψ and the node degrees with
    the CUDA kernels.

    With ``spill_dir`` the LRU sits over a disk tier: evictions spill to
    fingerprint-addressed snapshots listed in a manifest, and misses check
    the manifest before building (see module docstring).  ``max_graphs``
    then bounds *materialized* graphs only — the working set a host keeps
    hot — while the manifest can hold more graphs than one host's memory.
    """

    def __init__(
        self,
        *,
        max_graphs: int = 8,
        memory_budget_events: Optional[int] = None,
        backend: str = "auto",
        metrics: Optional[MetricsRegistry] = None,
        spill_dir: Optional[str] = None,
        device="cuda",
    ):
        self.max_graphs = max_graphs
        self.device = device
        self.memory_budget_events = memory_budget_events
        self.backend = backend
        self.spill_dir = spill_dir
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_builds = self.metrics.counter("graph_store_builds_total")
        self._c_extends = self.metrics.counter("graph_store_extends_total")
        self._c_hits = self.metrics.counter("graph_store_hits_total")
        self._c_spills = self.metrics.counter("graph_store_spills_total")
        self._c_pageins = self.metrics.counter("graph_store_pageins_total")
        self._graphs: "OrderedDict[str, EventGraph]" = OrderedDict()
        self._hints: Dict[str, str] = {}  # memmap realpath → newest fp
        self._disk: Dict[str, str] = {}  # fp → snapshot dir (guarded by _lock)
        self._lock = make_lock("GraphStore")
        # per-fingerprint build gates: concurrent requests for the same
        # graph wait for the first thread that builds it instead of
        # duplicating the O(E) work — and the registry lock is never held
        # across a build, so O(1) hits on other sources proceed during one
        self._building: Dict[str, threading.Event] = {}
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
            manifest = os.path.join(spill_dir, "manifest.json")
            if os.path.exists(manifest):
                with open(manifest) as f:
                    self._disk = dict(json.load(f).get("graphs", {}))

    @property
    def stats(self) -> GraphStoreStats:
        return GraphStoreStats(
            builds=self._c_builds.value,
            extends=self._c_extends.value,
            hits=self._c_hits.value,
            spills=self._c_spills.value,
            pageins=self._c_pageins.value,
        )

    def __len__(self) -> int:
        with self._lock:
            return len(self._graphs)

    def peek(self, fp: str) -> bool:
        """Availability probe (no LRU bump, no stats)."""
        with self._lock:
            return fp in self._graphs

    def has_extendable(self, source) -> bool:
        """True when a graph built from an earlier state of this memmap
        path is registered (either tier) — an append-proof candidate, so
        serving the grown log from the graph tier costs only a suffix scan
        (plus an O(metadata) page-in when the candidate was spilled)."""
        hint = self._hint(source)
        with self._lock:
            fp = self._hints.get(hint) if hint is not None else None
            return fp is not None and (fp in self._graphs or fp in self._disk)

    def get(self, fp: str) -> Optional[EventGraph]:
        with self._lock:
            g = self._graphs.get(fp)
            if g is not None:
                self._graphs.move_to_end(fp)
                self._c_hits.inc()
            return g

    def _register_locked(
        self,
        fp: str,
        g: EventGraph,
        hint: Optional[str],
        replaced_fp: Optional[str] = None,
    ) -> List[Tuple[str, EventGraph]]:
        """Insert + LRU-evict + hint bookkeeping; caller holds the lock.
        ``replaced_fp`` drops the superseded generation an extension grew
        out of — it can never be queried again (its fingerprint names the
        pre-append bytes) and would otherwise pin its event tables until
        LRU eviction.  Returns the LRU-evicted graphs so the caller can
        spill them to the disk tier *outside* the lock (an O(nnz) snapshot
        write must not block O(1) hits)."""
        if replaced_fp is not None and replaced_fp != fp:
            self._graphs.pop(replaced_fp, None)
            if self._disk.pop(replaced_fp, None) is not None:
                # the pre-append bytes no longer exist anywhere, so the
                # superseded snapshot can never satisfy a query; unmanifest
                # it (files stay — another handle may still mmap them)
                self._write_manifest_locked()
        self._graphs[fp] = g
        self._graphs.move_to_end(fp)
        if hint is not None:
            self._hints[hint] = fp
        evicted: List[Tuple[str, EventGraph]] = []
        while len(self._graphs) > self.max_graphs:
            dead_fp, dead_g = self._graphs.popitem(last=False)
            evicted.append((dead_fp, dead_g))
            if self.spill_dir is None:
                # no disk tier: the fingerprint becomes unreachable, so any
                # hint naming it is dead too.  With a disk tier the hint
                # stays — the spilled snapshot still extends after page-in.
                for h, hfp in list(self._hints.items()):
                    if hfp == dead_fp:
                        del self._hints[h]
        return evicted

    def put(self, fp: str, g: EventGraph, hint: Optional[str] = None) -> None:
        with self._lock:
            evicted = self._register_locked(fp, g, hint)
        self._spill(evicted)

    # -- disk tier ----------------------------------------------------------
    def _write_manifest_locked(self) -> None:
        tmp = os.path.join(self.spill_dir, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"format": _FORMAT_VERSION, "graphs": self._disk}, f)
        os.replace(tmp, os.path.join(self.spill_dir, "manifest.json"))

    def _spill(self, evicted: List[Tuple[str, EventGraph]]) -> None:
        """Persist evicted graphs to fingerprint-addressed snapshots.

        Runs outside the registry lock.  A fingerprint already manifested is
        skipped — it names exact source bytes, so the existing snapshot is
        already the right one (which also makes a concurrent double-spill of
        the same fingerprint an idempotent overwrite)."""
        if self.spill_dir is None or not evicted:
            return
        for fp, g in evicted:
            with self._lock:
                if fp in self._disk:
                    continue
            d = os.path.join(
                self.spill_dir, hashlib.sha256(fp.encode()).hexdigest()[:24]
            )
            save_graph(g, d)
            self._c_spills.inc()
            with self._lock:
                self._disk[fp] = d
                self._write_manifest_locked()

    def _page_in(self, fp: str) -> Optional[EventGraph]:
        """Load a manifested snapshot for ``fp`` (caller is the elected
        thread that builds this fingerprint, so nobody else is loading it)."""
        with self._lock:
            d = self._disk.get(fp)
        if d is None:
            return None
        try:
            g = load_graph(d)
        except (OSError, ValueError):
            # stale manifest entry (snapshot dir removed / unreadable):
            # drop it and fall through to a rebuild
            with self._lock:
                if self._disk.get(fp) == d:
                    del self._disk[fp]
                    self._write_manifest_locked()
            return None
        self._c_pageins.inc()
        return g

    @staticmethod
    def _hint(source) -> Optional[str]:
        if isinstance(source, MemmapLog):
            return os.path.realpath(source.path)
        return None

    def graph_for(self, source, fp: str, on_rows=None) -> EventGraph:
        """The graph of ``source`` (whose fingerprint is ``fp``): registry
        hit, disk-tier page-in, proven append extension, or fresh build —
        in that order.

        Construction runs *outside* the registry lock (an O(E) build must
        not block O(1) hits on other sources); a per-fingerprint gate makes
        concurrent requests for the same graph wait for the first to build it.

        ``on_rows`` (when given) is called with the number of source rows
        this call actually scanned: 0 for hits and page-ins, the appended
        suffix length for extensions, the full row count for builds — the
        engine's ``rows_scanned`` accounting, which is how the tests prove
        that an append rescans only its suffix.
        """
        while True:
            g = self.get(fp)
            if g is not None:
                return g
            hint = self._hint(source)
            with self._lock:
                g = self._graphs.get(fp)  # re-check: lost a build race
                if g is not None:
                    self._graphs.move_to_end(fp)
                    self._c_hits.inc()
                    return g
                gate = self._building.get(fp)
                if gate is None:
                    gate = threading.Event()
                    self._building[fp] = gate
                    old_fp_hint = (
                        self._hints.get(hint) if hint is not None else None
                    )
                    old = (
                        self._graphs.get(old_fp_hint)
                        if old_fp_hint is not None
                        else None
                    )
                    break  # this thread builds
            # someone else is building this fingerprint: wait and retry
            # (if that build fails the gate is set with nothing registered,
            # and the retry loop elects another thread to build)
            gate.wait()

        old_fp = None
        try:
            g = self._page_in(fp)
            if g is None:
                if old is None and old_fp_hint is not None \
                        and old_fp_hint != fp:
                    # the extension candidate was LRU-evicted to the disk
                    # tier: page it in — a suffix scan over a loaded
                    # snapshot still beats an O(E) rebuild
                    old = self._page_in(old_fp_hint)
                if old is not None and isinstance(source, MemmapLog):
                    if _proves_append_only(old, source):
                        suffix = source.num_events - old.rows_end
                        g = extend_graph(
                            old, source,
                            memory_budget_events=self.memory_budget_events,
                            source_fp=fp,
                        )
                        old_fp = old.source_fp
                        self._c_extends.inc()
                        if on_rows is not None:
                            on_rows(suffix)
                    else:
                        with self._lock:
                            self._hints.pop(hint, None)
                if g is None:
                    g = build_graph(
                        source,
                        backend=self.backend,
                        memory_budget_events=self.memory_budget_events,
                        source_fp=fp,
                        device=self.device,
                    )
                    self._c_builds.inc()
                    if on_rows is not None:
                        on_rows(int(source.num_events))
            with self._lock:
                evicted = self._register_locked(
                    fp, g, hint, replaced_fp=old_fp
                )
            self._spill(evicted)
            return g
        finally:
            with self._lock:
                self._building.pop(fp, None)
            gate.set()
