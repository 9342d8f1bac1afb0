"""Plan + result cache keyed on (source fingerprint, canonical plan).

Dashboard-style workloads re-issue the same handful of queries against a
slowly changing store; the paper's in-store architecture makes those O(1)
once the store can recognize "same data, same query".  Both halves of the
key are content hashes:

* the **fingerprint** digests the source's actual bytes (columns + names
  for an :class:`EventRepository`; prefix digest + shape for a
  :class:`MemmapLog`), so any append or rewrite invalidates.  The digests
  are byte-for-byte those of the reference package, so one log keys the
  same in both;
* the **plan key** hashes the canonical logical plan, so two differently
  chained but equivalent queries share an entry.

The memmap fingerprint is **prefix-preserving**: it is the pair
``(prefix_digest(rows 0..n), n)`` rendered as a string, and
``prefix_digest`` is computable for any ``n`` on any log that still
contains those rows.  That lets the engine *prove* (up to the sampling the
fingerprint already accepts) that a changed log is an append-only extension
of a cached one — the basis of the delta query plans.  A union's
fingerprint is the list of its branches' own fingerprints, so the proof
still works per branch.

Entries may carry a :class:`ResumableState` (the streaming miner's Ψ +
open-case tails, a histogram's raw counts, or the streaming replayer's
per-case state) so a proven append scans only the new suffix.  A
per-(source path, plan) hint remembers the newest entry to resume from; the
hint is only a lookup accelerator — correctness always comes from the
prefix-digest proof.

Entries are LRU-evicted and returned as copies — a caller mutating a result
matrix can never corrupt the cache.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
from collections import OrderedDict
from typing import Optional, Tuple
from urllib.parse import quote, unquote

import numpy as np

from repro_torch.analysis.lockdep import make_lock
from repro_torch.core.repository import EventRepository
from repro_torch.core.streaming import MemmapLog, MinerState

__all__ = [
    "fingerprint",
    "fingerprint_repository",
    "fingerprint_memmap",
    "fingerprint_union",
    "split_union_fingerprint",
    "fingerprint_sharded",
    "split_sharded_fingerprint",
    "prefix_digest",
    "realpath_of",
    "MemmapFingerprint",
    "parse_memmap_fingerprint",
    "ResumableState",
    "QueryCache",
    "CacheStats",
]


# ---------------------------------------------------------------------------
# Source fingerprints
# ---------------------------------------------------------------------------


#: per-column sample size; columns up to 3× this hash in full
_SAMPLE_ROWS = 1 << 16


def _digest_column(h, col, sample_rows: int = _SAMPLE_ROWS) -> None:
    """Full hash for small columns; head + tail + strided sample for large
    ones, so fingerprinting stays O(sample) and a cache *hit* is cheap even
    on multi-GB repositories.  Appends/truncations always change the shape
    (hashed); an in-place edit of a large column is caught only if it lands
    in the sample — same tradeoff as the memmap fingerprint."""
    arr = np.ascontiguousarray(col)
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    n = arr.shape[0]
    if n <= 3 * sample_rows:
        h.update(arr.tobytes())
        return
    h.update(arr[:sample_rows].tobytes())
    h.update(arr[-sample_rows:].tobytes())
    stride = max(n // sample_rows, 1)
    h.update(np.ascontiguousarray(arr[::stride]).tobytes())


def _digest_names(h, names, sample: int = 1024) -> None:
    """Hash a name list the way columns are hashed: in full when small,
    head + tail + strided sample when large.  Two repositories differing
    only in (sampled) names must not collide."""
    h.update(str(len(names)).encode())
    if len(names) <= 3 * sample:
        picked = names
    else:
        stride = max(len(names) // sample, 1)
        picked = (*names[:sample], *names[-sample:], *names[::stride])
    for name in picked:
        h.update(name.encode())
        h.update(b"\x00")


def fingerprint_repository(repo: EventRepository) -> str:
    h = hashlib.sha256()
    for col in (repo.event_activity, repo.event_trace, repo.event_time,
                repo.trace_log):
        _digest_column(h, col)
    h.update(json.dumps([repo.activity_names, repo.log_names]).encode())
    _digest_names(h, repo.trace_names)
    return "repo:" + h.hexdigest()[:32]


def prefix_digest(
    log: MemmapLog, n: Optional[int] = None, sample_rows: int = 4096
) -> str:
    """O(sample) digest of the first ``n`` rows of the log.

    The sample positions depend only on ``n`` (head, tail-of-prefix, and a
    stride over ``[0, n)``), so the digest is recomputable on any log that
    still contains those rows: ``prefix_digest(grown_log, old_n) ==
    old_digest`` *proves* — to the same sampling confidence the fingerprint
    already accepts — that the change was append-only (the delta path and
    the graph store's extension rely on it)."""
    n = log.num_events if n is None else int(n)
    if not 0 <= n <= log.num_events:
        raise ValueError(f"prefix of {n} rows on a {log.num_events}-row log")
    h = hashlib.sha256()
    h.update(str(n).encode())
    k = min(sample_rows, n)
    stride = max(n // sample_rows, 1)
    for col in (log.activity, log.case, log.time):
        h.update(np.asarray(col[:k]).tobytes())
        h.update(np.asarray(col[n - k : n]).tobytes())
        if stride > 1:
            h.update(np.ascontiguousarray(col[:n:stride]).tobytes())
    return h.hexdigest()[:32]


@dataclasses.dataclass(frozen=True)
class MemmapFingerprint:
    """Structured form of a memmap fingerprint string."""

    prefix: str
    num_events: int
    num_activities: int


#: stat-validated fingerprint memo — every query fingerprints its source,
#: and a hit must stay cheap on multi-GB logs.  The memo key carries
#: (size, mtime_ns) of each column file, so an append (writer uses
#: append-mode file handles) or an in-place rewrite both recompute; a hit
#: costs three ``stat()`` calls instead of O(sample) hashing.
_FP_MEMO_MAX = 4096
_FP_COLUMNS = ("activity.i32", "case.i32", "time.f64")
_fp_memo: "OrderedDict[tuple, str]" = OrderedDict()
_fp_memo_lock = make_lock("FingerprintMemo")


def realpath_of(source) -> Optional[str]:
    """``os.path.realpath(source.path)``, cached on the source object —
    resolving symlinks costs one ``lstat`` per path component, and every
    query on a memmap log asks (fingerprint memo, delta hint)."""
    path = getattr(source, "path", None)
    if not path:
        return None
    cached = getattr(source, "_realpath_cache", None)
    if cached is not None and cached[0] == path:
        return cached[1]
    real = os.path.realpath(path)
    try:
        source._realpath_cache = (path, real)
    except AttributeError:  # __slots__ sources: resolve every time
        pass
    return real


def _memmap_stat_key(log: MemmapLog, sample_rows: int):
    """Validator key for the fingerprint memo, or None (no backing files →
    always hash)."""
    real = realpath_of(log)
    if real is None:
        return None
    stats = []
    try:
        for name in _FP_COLUMNS:
            st = os.stat(os.path.join(real, name))
            stats.append((st.st_size, st.st_mtime_ns))
    except OSError:
        return None
    return (real, tuple(stats), log.num_events, log.num_activities,
            sample_rows)


def fingerprint_memmap(log: MemmapLog, sample_rows: int = 4096) -> str:
    """Prefix-preserving fingerprint: ``memmap:<prefix_digest>:<rows>:<A>``.
    Appending rows changes the row count (and usually the digest); editing
    in place is caught for the sampled ranges (full-file hashing would
    defeat the out-of-core design)."""
    key = _memmap_stat_key(log, sample_rows)
    if key is not None:
        with _fp_memo_lock:
            hit = _fp_memo.get(key)
            if hit is not None:
                _fp_memo.move_to_end(key)
                return hit
    fp = "memmap:{}:{}:{}".format(
        prefix_digest(log, sample_rows=sample_rows),
        log.num_events,
        log.num_activities,
    )
    if key is not None:
        with _fp_memo_lock:
            _fp_memo[key] = fp
            _fp_memo.move_to_end(key)
            while len(_fp_memo) > _FP_MEMO_MAX:
                _fp_memo.popitem(last=False)
    return fp


def parse_memmap_fingerprint(fp: str) -> Optional[MemmapFingerprint]:
    """``memmap:<prefix_digest>:<rows>:<A>`` → its parts (None for any other
    string) — what the graph store's append-only proof compares against."""
    if not fp.startswith("memmap:"):
        return None
    try:
        _, prefix, n, a = fp.split(":")
        return MemmapFingerprint(prefix, int(n), int(a))
    except ValueError:
        return None


def fingerprint_union(union) -> str:
    """Composite fingerprint ``union(name=fp_a|name=fp_b|...)``.

    Each component is the branch's own fingerprint — memmap branches keep
    their **prefix-preserving** ``memmap:<digest>:<rows>:<A>`` form, so the
    append-only proof (and with it the delta path) still works *per branch*
    while any branch change invalidates every union-level entry.  Branch
    names are part of the key: the same bytes relabeled is a different
    result (compare axes, provenance).  Names are percent-escaped so a
    caller-supplied name containing ``=`` / ``|`` cannot forge another
    union's key."""
    return "union(" + "|".join(
        f"{quote(b.name, safe='')}={fingerprint(b)}" for b in union.branches
    ) + ")"


def split_union_fingerprint(fp: str):
    """``union(a=fp1|b=fp2)`` → ``[("a", fp1), ("b", fp2)]`` (None if not a
    union fingerprint)."""
    if not (fp.startswith("union(") and fp.endswith(")")):
        return None
    out = []
    for part in fp[len("union("):-1].split("|"):
        name, _, bfp = part.partition("=")
        out.append((unquote(name), bfp))
    return out


def fingerprint_sharded(sharded) -> str:
    """Composite fingerprint ``sharded(fp0|fp1|...)``, one slot per residue
    class in shard order (``-`` marks a residue with no shard yet, so the
    slot count pins K).  Each present slot is the shard's own
    **prefix-preserving** ``memmap:<digest>:<rows>:<A>`` fingerprint: an
    append changes only the owning shards' slots, which is exactly what lets
    the engine keep per-shard cache entries (and delta resume) alive for
    every untouched shard while any change still invalidates sharded-level
    entries."""
    return "sharded(" + "|".join(
        "-" if s is None else fingerprint_memmap(s) for s in sharded.shards
    ) + ")"


def split_sharded_fingerprint(fp: str):
    """``sharded(fp0|fp1|...)`` → ``[fp0_or_None, fp1_or_None, ...]`` (None
    for absent shards; returns None if not a sharded fingerprint)."""
    if not (fp.startswith("sharded(") and fp.endswith(")")):
        return None
    return [
        None if part == "-" else part
        for part in fp[len("sharded("):-1].split("|")
    ]


def fingerprint(source) -> str:
    # local imports: ast.py / graph.shard depend on core only, so no cycle
    from repro_torch.graph.shard import ShardedLog

    from .ast import FromLogs, LogRef, UnionSource

    if isinstance(source, EventRepository):
        return fingerprint_repository(source)
    if isinstance(source, MemmapLog):
        return fingerprint_memmap(source)
    if isinstance(source, ShardedLog):
        return fingerprint_sharded(source)
    if isinstance(source, UnionSource):
        return fingerprint_union(source)
    if isinstance(source, LogRef):
        return fingerprint(source.source)
    if isinstance(source, FromLogs):
        # derived from the parent's content + the selection — no need to
        # materialize the O(E) sub-repository just to key the cache
        h = hashlib.sha256("\x00".join(source.names).encode()).hexdigest()[:8]
        return f"fromlogs:{h}:{fingerprint_repository(source.repo)}"
    raise TypeError(f"cannot fingerprint {type(source).__name__}")


# ---------------------------------------------------------------------------
# Resumable execution state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResumableState:
    """State a streaming scan leaves behind when it consumed the log through
    its last row: resuming it over an appended suffix (including the pairs
    that straddle the boundary, via the miner's per-case tails) reproduces a
    full rescan bit for bit.  ``replay`` carries the streaming replayer's
    per-case tails + fitness accumulators for conformance sinks (only
    plans whose model is pinned in the sink are resumable — a default
    model is re-discovered from the grown log and would change under the
    resumed state's feet)."""

    rows_end: int  # rows [lo, rows_end) are accounted for
    num_activities: int
    miner: Optional[MinerState] = None  # DFG sinks
    counts: Optional[np.ndarray] = None  # histogram sinks (raw, pre-mask/view)
    replay: Optional[object] = None  # conformance sinks (ReplayState)

    def copy(self) -> "ResumableState":
        return ResumableState(
            self.rows_end,
            self.num_activities,
            self.miner.copy() if self.miner is not None else None,
            self.counts.copy() if self.counts is not None else None,
            self.replay.copy() if self.replay is not None else None,
        )


# ---------------------------------------------------------------------------
# LRU result cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0


@dataclasses.dataclass
class _Entry:
    result: object
    resume: Optional[ResumableState] = None


def _copy_result(result):
    """Deep-enough copy: fresh arrays, shared immutable plan objects."""
    out = copy.copy(result)
    value = result.value
    if isinstance(value, np.ndarray):
        out.value = value.copy()
    else:
        out.value = copy.deepcopy(value)
    if result.names is not None:
        out.names = list(result.names)
    # Traces describe one concrete execution; a stored entry must not leak
    # the producing run's spans into later hits (the engine attaches a fresh
    # cache-hit trace to each served copy).  The producing run's *trace id*
    # is retained so hit traces can link back to the execution that
    # populated the entry.
    if getattr(out, "trace", None) is not None:
        if getattr(out, "source_trace_id", None) is None:
            out.source_trace_id = out.trace.trace_id
        out.trace = None
    return out


class QueryCache:
    """LRU over (fingerprint, plan_key) → QueryResult [+ ResumableState].
    Thread-safe: the serving layer shares one cache across concurrent
    tenants."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._entries: "OrderedDict[Tuple[str, str], _Entry]" = OrderedDict()
        # (source hint, plan_key) -> fingerprint of the newest entry for it;
        # lets the engine find a resume candidate after the source changed
        self._hints: dict = {}
        self.stats = CacheStats()
        self._lock = make_lock("QueryCache")

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: Tuple[str, str]):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return _copy_result(entry.result)

    def probe(self, key: Tuple[str, str]) -> bool:
        """Non-mutating presence check: no stats, no LRU touch, no copy."""
        with self._lock:
            return key in self._entries

    def has_delta_hint(self, source_hint: Optional[str], plan_key: str) -> bool:
        """Non-mutating: is there a live resume candidate for this
        (source, plan)?  Like :meth:`probe`, a classification signal only —
        the engine still proves prefix preservation before trusting it."""
        if source_hint is None:
            return False
        with self._lock:
            fp = self._hints.get((source_hint, plan_key))
            return fp is not None and (fp, plan_key) in self._entries

    def put(
        self,
        key: Tuple[str, str],
        result,
        resume: Optional[ResumableState] = None,
        source_hint: Optional[str] = None,
    ) -> None:
        entry = _Entry(
            _copy_result(result),
            resume.copy() if resume is not None else None,
        )
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            if source_hint is not None:
                self._hints[(source_hint, key[1])] = key[0]
            while len(self._entries) > self.max_entries:
                dead_key, _ = self._entries.popitem(last=False)
                self.stats.evictions += 1
                self._drop_hints_locked(dead_key)

    # -- delta support -------------------------------------------------------
    def delta_candidate(self, source_hint: Optional[str], plan_key: str):
        """Newest (fingerprint, result copy, resume copy) put for this
        (source, plan) — a *candidate* only: the engine must prove prefix
        preservation before trusting it."""
        if source_hint is None:
            return None
        with self._lock:
            fp = self._hints.get((source_hint, plan_key))
            if fp is None:
                return None
            entry = self._entries.get((fp, plan_key))
            if entry is None:  # evicted since
                self._hints.pop((source_hint, plan_key), None)
                return None
            return (
                fp,
                _copy_result(entry.result),
                entry.resume.copy() if entry.resume is not None else None,
            )

    def drop_hint(self, source_hint: Optional[str], plan_key: str) -> None:
        with self._lock:
            self._hints.pop((source_hint, plan_key), None)

    def _drop_hints_locked(self, key: Tuple[str, str]) -> None:
        fp, plan_key = key
        dead = [
            hk for hk, hfp in self._hints.items()
            if hfp == fp and hk[1] == plan_key
        ]
        for hk in dead:
            del self._hints[hk]

    # -- maintenance ---------------------------------------------------------
    def invalidate_source(self, fp: str) -> int:
        """Drop every entry for one source fingerprint (explicit refresh)."""
        with self._lock:
            dead = [k for k in self._entries if k[0] == fp]
            for k in dead:
                del self._entries[k]
                self._drop_hints_locked(k)
            self.stats.invalidations += len(dead)
            return len(dead)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._hints.clear()
