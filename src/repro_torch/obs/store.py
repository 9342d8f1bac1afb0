"""Persisted trace store — a bounded on-disk JSONL ring of finished traces.

Completed, *sampled* traces are appended as one JSON line each to a ring
of rotating segment files (``trace-<n>.jsonl``), so the store is bounded
(``max_bytes`` across ``segments`` files) no matter how long the process
serves.  Sampling is **tail-based**: the keep/drop decision happens when
the trace is complete, so the store always keeps

* traces that errored,
* traces slower than the SLO latency bound (when one is configured),

and head-samples the rest (every ``sample_every``-th sampled trace) —
the boring fast majority is decimated, the traces worth debugging never
are.  A trace whose context carries ``sampled=False`` (inbound
traceparent flag) is only kept when the tail rules fire.

The persisted records carry the distributed-trace identity (trace id /
span id / parent) plus every span with its **absolute** monotonic start
stamp, so :meth:`to_repository` can read the whole ring back as a
canonical event log — each trace node one case, each span one event —
and ``Q.log(store.to_repository()).dfg()`` mines the serving tier's own
cross-process traces with the same Algorithm 1 the engine runs on user
logs.

Lock discipline: the store lock only
guards byte/sequence accounting and the file-handle swap — every
``open``/``os.remove``/write happens *outside* it.  Concurrent writers
share one buffered text handle; a single ``fh.write(line)`` of a whole
line is atomic under CPython's buffered-writer lock, so lines never
interleave.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, Iterator, List, Optional

from repro_torch.analysis.lockdep import make_lock

from .trace import QueryTrace

__all__ = ["TraceStore"]

_SEGMENT_FMT = "trace-{:06d}.jsonl"
_SEGMENT_GLOB = "trace-*.jsonl"


def _trace_record(tr: QueryTrace, error: bool) -> Dict[str, object]:
    """The persisted JSON shape of one finished trace (branches nested)."""
    names, t0s, durs = tr.raw_spans()
    rec: Dict[str, object] = {
        "trace_id": tr.trace_id,
        "span_id": tr.span_id,
        "parent_span_id": tr.parent_span_id,
        "sampled": tr.sampled,
        "query_id": tr.query_id,
        "sink": tr.sink,
        "source": tr.source,
        "backend": tr.executed_backend,
        "from_cache": tr.from_cache,
        "total_s": tr.total_s,
        "error": bool(error),
        "spans": [
            {"name": n, "t0": t, "duration_s": max(d, 0.0)}
            for n, t, d in zip(names, t0s, durs)
        ],
    }
    if tr.links:
        rec["links"] = dict(tr.links)
    if tr.notes:
        rec["notes"] = {
            k: v for k, v in tr.notes.items()
            if isinstance(v, (str, int, float, bool))
        }
    if tr.branches:
        rec["branches"] = [
            dict(_trace_record(sub, False), branch=name)
            for name, sub in tr.branches
        ]
    return rec


class TraceStore:
    """Bounded JSONL ring of completed traces with tail-based sampling."""

    def __init__(
        self,
        path: str,
        *,
        max_bytes: int = 16 * 1024 * 1024,
        segments: int = 4,
        sample_every: int = 1,
        slo_latency_s: Optional[float] = None,
        metrics=None,
        now=time.time,
    ):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self.segments = max(int(segments), 2)
        self.segment_bytes = max(int(max_bytes) // self.segments, 4096)
        self.sample_every = max(int(sample_every), 1)
        self.slo_latency_s = slo_latency_s
        self._now = now
        existing = sorted(glob.glob(os.path.join(self.path, _SEGMENT_GLOB)))
        seq = 0
        if existing:
            tail = os.path.basename(existing[-1])
            seq = int(tail[len("trace-"):-len(".jsonl")])
        fh = open(self._segment_path(seq), "a", encoding="utf-8")
        self._lock = make_lock("TraceStore")
        self._fh = fh                      # guarded by _lock (swap only)
        self._seq = seq                    # guarded by _lock
        self._bytes = fh.tell()            # guarded by _lock
        self._rotating = False             # guarded by _lock
        self._head_seen = 0                # guarded by _lock
        self._kept = 0                     # guarded by _lock
        if metrics is not None:
            self._c_offered = metrics.counter(
                "trace_store_offered_total",
                "Finished traces offered to the persisted trace store",
            )
            self._c_kept = {
                reason: metrics.counter(
                    "trace_store_kept_total",
                    "Traces persisted, by tail-sampling keep reason",
                    reason=reason,
                )
                for reason in ("error", "slow", "sampled")
            }
        else:
            self._c_offered = None
            self._c_kept = None

    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.path, _SEGMENT_FMT.format(seq))

    # -- write side -------------------------------------------------------

    def _keep_reason(self, tr: QueryTrace, error: bool) -> Optional[str]:
        """Tail-based sampling decision; None = drop."""
        if error:
            return "error"
        if (
            self.slo_latency_s is not None
            and tr.total_s >= self.slo_latency_s
        ):
            return "slow"
        if not tr.sampled:
            return None
        with self._lock:
            self._head_seen += 1
            nth = self._head_seen
        return "sampled" if nth % self.sample_every == 0 else None

    def offer(self, tr: QueryTrace, error: bool = False) -> bool:
        """Offer one finished trace; returns True when persisted."""
        if self._c_offered is not None:
            self._c_offered.inc()
        reason = self._keep_reason(tr, error)
        if reason is None:
            return False
        line = json.dumps(_trace_record(tr, error), sort_keys=True) + "\n"
        with self._lock:
            fh = self._fh
            self._bytes += len(line)
            self._kept += 1
            rotate = (
                self._bytes >= self.segment_bytes and not self._rotating
            )
            if rotate:
                self._rotating = True
        fh.write(line)
        if rotate:
            self._rotate()
        if self._c_kept is not None:
            self._c_kept[reason].inc()
        return True

    def _rotate(self) -> None:
        """Swap in the next segment and prune the ring; all file I/O runs
        with no lock held (the single in-flight rotation is serialized by
        the ``_rotating`` flag)."""
        with self._lock:
            seq = self._seq + 1
        new_fh = open(self._segment_path(seq), "a", encoding="utf-8")
        with self._lock:
            old = self._fh
            self._fh = new_fh
            self._seq = seq
            self._bytes = 0
            self._rotating = False
        old.close()
        paths = sorted(glob.glob(os.path.join(self.path, _SEGMENT_GLOB)))
        for p in paths[:-self.segments]:
            try:
                os.remove(p)
            except OSError:  # pragma: no cover - concurrent external prune
                pass

    def __len__(self) -> int:
        """Traces persisted over this store's lifetime (not just resident
        in the ring)."""
        with self._lock:
            return self._kept

    def close(self) -> None:
        with self._lock:
            fh = self._fh
        fh.close()

    # -- read side --------------------------------------------------------

    def read_records(self) -> Iterator[Dict[str, object]]:
        """Iterate every resident trace record, oldest segment first."""
        with self._lock:
            fh = self._fh
        try:
            fh.flush()
        except ValueError:  # store closed: the ring on disk stays readable
            pass
        for p in sorted(glob.glob(os.path.join(self.path, _SEGMENT_GLOB))):
            try:
                with open(p, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            yield json.loads(line)
                        except json.JSONDecodeError:
                            continue  # torn tail line of a live segment
            except OSError:  # pragma: no cover - segment pruned mid-read
                continue

    def find(self, trace_id: str) -> List[Dict[str, object]]:
        """Every resident record belonging to ``trace_id`` — across
        processes that share the ring directory this is the full stitched
        request tree."""
        return [
            rec for rec in self.read_records()
            if rec.get("trace_id") == trace_id
        ]

    def to_repository(self):
        """The resident ring as a canonical event log: one case per trace
        node (``trace_id:span_id``), one event per span, ordered by the
        spans' absolute monotonic stamps — ready for ``Q.log(...)``."""
        from repro_torch.core.repository import EventRepository

        cases: List[str] = []
        acts: List[str] = []
        times: List[float] = []

        def walk(rec: Dict[str, object]) -> None:
            tid = rec.get("trace_id")
            sid = rec.get("span_id")
            case = (
                f"{tid}:{sid}" if tid and sid else f"q{rec.get('query_id')}"
            )
            for span in rec.get("spans", ()):
                cases.append(case)
                acts.append(str(span["name"]))
                times.append(float(span["t0"]))
            for sub in rec.get("branches", ()):
                walk(sub)

        for rec in self.read_records():
            walk(rec)
        return EventRepository.from_event_table(cases, acts, times)
