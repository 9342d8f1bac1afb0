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

Entries are LRU-evicted and returned as copies — a caller mutating a result
matrix can never corrupt the cache.  (Append-aware delta resume over cached
streaming state is ROADMAP Queue A item 5.)
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from repro_torch.analysis.lockdep import make_lock
from repro_torch.core.repository import EventRepository
from repro_torch.core.streaming import MemmapLog

__all__ = [
    "fingerprint",
    "fingerprint_repository",
    "fingerprint_memmap",
    "prefix_digest",
    "MemmapFingerprint",
    "parse_memmap_fingerprint",
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
    still contains those rows — the basis of the append-only proof the
    graph store's extension uses (and the delta path will use)."""
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


def _memmap_stat_key(log: MemmapLog, sample_rows: int):
    """Validator key for the fingerprint memo, or None (no backing files →
    always hash)."""
    real = os.path.realpath(log.path)
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


def fingerprint(source) -> str:
    if isinstance(source, EventRepository):
        return fingerprint_repository(source)
    if isinstance(source, MemmapLog):
        return fingerprint_memmap(source)
    raise TypeError(f"cannot fingerprint {type(source).__name__}")


# ---------------------------------------------------------------------------
# LRU result cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0


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
    """LRU over (fingerprint, plan_key) → QueryResult.  Thread-safe: the
    serving layer shares one cache across concurrent tenants."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._entries: "OrderedDict[Tuple[str, str], object]" = OrderedDict()
        self.stats = CacheStats()
        self._lock = make_lock("QueryCache")

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: Tuple[str, str]):
        with self._lock:
            result = self._entries.get(key)
            if result is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return _copy_result(result)

    def put(self, key: Tuple[str, str], result) -> None:
        entry = _copy_result(result)
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
