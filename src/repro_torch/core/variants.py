"""Trace-variant analysis — the paper's §5.2 motivation made first-class.

"Event logs usually contain different variations … discovering the process
based on the whole event log usually produces so-called spaghetti models"
— the standard remedy is variant analysis: group traces by their activity
sequence.  Vectorized via per-trace sequence hashing (no Python loop over
events), so it runs on million-event logs.

The representative sequence of each variant is kept as activity ids, one
contiguous slice per variant (``variant_activity[variant_offsets[v]:
variant_offsets[v + 1]]``), gathered from the trace's own events in one
vectorized pass.  On canonical (trace-sorted) columns a trace's events are
the slice ``[start, start + len)`` with ``start`` from the cumulative sum of
``bincount(trace)``, so rebuilding every representative costs O(E), not one
O(E) scan per variant.  :attr:`TraceVariants.sequences` spells the slices
out as activity names on first use.

Grouping is exact: traces that share a hash but not a sequence (a collision
of the rolling hash) are split into variants of their own, where the
reference package merges them.  Without a collision the table is the
reference's, variant for variant.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import numpy as np

from .repository import EventRepository

__all__ = [
    "TraceVariants",
    "trace_variants",
    "variant_table",
    "variant_filtered_repository",
]

_P1 = np.uint64(1_000_000_007)
_P2 = np.uint64(0x9E3779B97F4A7C15)


@dataclasses.dataclass
class TraceVariants:
    """Variants sorted by descending frequency."""

    counts: np.ndarray  # (V,) traces per variant
    trace_variant: np.ndarray  # (T,) variant index per trace
    #: representative activity ids, variant after variant
    variant_activity: np.ndarray  # (Σ len,)
    variant_offsets: np.ndarray  # (V + 1,) int64 slice bounds
    activity_names: List[str]  # labels of the ids

    @property
    def num_variants(self) -> int:
        return int(self.counts.shape[0])

    @property
    def lengths(self) -> np.ndarray:
        """(V,) int64 events per representative sequence."""
        return np.diff(self.variant_offsets)

    @functools.cached_property
    def sequences(self) -> List[List[str]]:
        """The activity-name sequence of each variant."""
        names = self.activity_names
        ids = self.variant_activity.tolist()
        off = self.variant_offsets.tolist()
        return [
            [names[i] for i in ids[off[v]:off[v + 1]]]
            for v in range(self.num_variants)
        ]

    def coverage(self, k: int) -> float:
        """Fraction of traces covered by the top-k variants."""
        total = self.counts.sum()
        return float(self.counts[:k].sum() / total) if total else 1.0


def variant_table(
    event_activity: np.ndarray,
    event_trace: np.ndarray,
    num_traces: int,
    activity_names: List[str],
) -> TraceVariants:
    """Variant analysis straight off canonical (trace-contiguous) columns —
    the array-level core :func:`trace_variants` wraps, usable by callers
    (graph tables, transformed selections) that have no repository."""
    t = np.asarray(event_trace).astype(np.int64)
    act = np.asarray(event_activity)
    a = act.astype(np.uint64)
    T = int(num_traces)
    n = t.shape[0]
    names = list(activity_names)
    if n == 0:
        return TraceVariants(
            counts=np.zeros((0,), np.int64),
            trace_variant=np.zeros((T,), np.int64),
            variant_activity=act[:0].copy(),
            variant_offsets=np.zeros((1,), np.int64),
            activity_names=names,
        )
    # polynomial rolling hash per trace (canonical order is trace-contiguous)
    pos = np.arange(n, dtype=np.int64)
    starts = np.zeros(n, dtype=bool)
    starts[0] = True
    starts[1:] = t[1:] != t[:-1]
    start_pos = np.maximum.accumulate(np.where(starts, pos, 0))
    offset = (pos - start_pos).astype(np.uint64)
    term = (a + np.uint64(1)) * ((offset + np.uint64(1)) * _P2 + np.uint64(1))
    h = np.zeros(T, dtype=np.uint64)
    np.add.at(h, t, term * _P1 + (term >> np.uint64(7)))
    trace_len = np.bincount(t, minlength=T)
    h = h ^ (trace_len.astype(np.uint64) * _P2)

    _uniq, first_idx, inv, counts = np.unique(
        h, return_index=True, return_inverse=True, return_counts=True
    )
    # trace r's events, in row order, are events[first[r]:first[r + 1]]:
    # canonical (trace-sorted) rows already are; any other order is first
    # made so by a stable sort of the rows by trace
    first = np.zeros(trace_len.shape[0] + 1, dtype=np.int64)
    np.cumsum(trace_len, out=first[1:])
    events = None
    if not bool((t[1:] >= t[:-1]).all()):
        events = np.argsort(t, kind="stable")
    by_trace = act if events is None else act[events]
    key = _split_collisions(by_trace, first, trace_len, first_idx, inv)
    if key is not None:
        _uniq, first_idx, inv, counts = np.unique(
            key, return_index=True, return_inverse=True, return_counts=True
        )
    order = np.argsort(-counts, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    trace_variant = rank[inv]

    # one representative sequence per variant: the events of the trace that
    # owns it
    rep = first_idx[order]
    rep_len = trace_len[rep].astype(np.int64)
    offsets = np.zeros(rep.shape[0] + 1, dtype=np.int64)
    np.cumsum(rep_len, out=offsets[1:])
    rows = np.repeat(first[rep] - offsets[:-1], rep_len)
    rows += np.arange(offsets[-1], dtype=np.int64)
    return TraceVariants(
        counts=counts[order].astype(np.int64),
        trace_variant=trace_variant,
        variant_activity=by_trace[rows],
        variant_offsets=offsets,
        activity_names=names,
    )


def _split_collisions(by_trace, first, trace_len, first_idx, inv):
    """Traces whose sequence differs from their hash group's first trace.

    The rolling hash can map two different sequences to one value (on a
    60,000-event synthetic log with 40 activities, two 8-event traces
    collide), and the reference then merges them into one variant.  Each
    trace is compared with its group's first trace, event by event.  When
    none differs, ``None`` keeps the hash groups as they are; otherwise the
    returned int64 key per trace is ``group · (n + 1) + sub``, where ``sub``
    numbers the distinct sequences of a group (0 for the first trace's), so
    the groups keep the hash order and a split-off sequence follows its
    group."""
    T = trace_len.shape[0]
    rep = first_idx[inv]
    same_len = trace_len == trace_len[rep]
    te = np.repeat(np.arange(T), trace_len)
    k = np.arange(te.shape[0], dtype=np.int64) - first[te]
    cand = same_len[te]
    eq = np.zeros(te.shape[0], dtype=bool)
    eq[cand] = by_trace[cand] == by_trace[first[rep[te[cand]]] + k[cand]]
    differs = ~same_len
    differs[te[~eq]] = True
    bad = np.nonzero(differs)[0]
    if bad.shape[0] == 0:
        return None
    sub = np.zeros(T, dtype=np.int64)
    seen = {}
    per_group = {}
    for r in bad.tolist():
        g = int(inv[r])
        seq = (g, by_trace[first[r]:first[r + 1]].tobytes())
        if seq not in seen:
            per_group[g] = per_group.get(g, 0) + 1
            seen[seq] = per_group[g]
        sub[r] = seen[seq]
    return inv.astype(np.int64) * (int(sub.max()) + 1) + sub


def trace_variants(repo: EventRepository) -> TraceVariants:
    return variant_table(
        repo.event_activity, repo.event_trace, repo.num_traces,
        repo.activity_names,
    )


def variant_filtered_repository(
    repo: EventRepository, keep_top: int
) -> EventRepository:
    """Keep only traces of the top-k variants (the spaghetti-model remedy:
    mine the mainstream behaviour, inspect the tail separately).

    Kept traces are renumbered in their old order through one index array
    (old trace id → new, -1 for a dropped trace), so the remap is O(E)
    array work with no per-event Python."""
    tv = trace_variants(repo)
    keep_tr = np.nonzero(tv.trace_variant < keep_top)[0]
    old_to_new = np.full(repo.num_traces, -1, dtype=np.int64)
    old_to_new[keep_tr] = np.arange(keep_tr.shape[0])
    new_trace = old_to_new[repo.event_trace]
    idx = np.nonzero(new_trace >= 0)[0]
    names = repo.trace_names
    return EventRepository(
        event_activity=repo.event_activity[idx].copy(),
        event_trace=new_trace[idx].astype(np.int32),
        event_time=repo.event_time[idx].copy(),
        trace_log=repo.trace_log[keep_tr].copy(),
        activity_names=list(repo.activity_names),
        trace_names=[names[x] for x in keep_tr.tolist()],
        log_names=list(repo.log_names),
    )
