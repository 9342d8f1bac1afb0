"""Lock-protected counters and streaming histograms for the engine.

Design constraints (mirrors the engine's always-on tracing budget):

* **One lock per registry.**  Counters and histograms share their
  registry's lock, so moving ``EngineStats`` increments behind it also
  fixes the bare-``int`` data races the old dataclass had under
  concurrent ``run()`` calls.
* **No sample retention.**  Histograms bin observations into fixed
  log-scale buckets (4 per decade, 1 µs … 100 s) and estimate
  p50/p95/p99 by interpolating the cumulative bucket counts — memory is
  O(buckets) forever, independent of query volume.
* **Three export formats.**  ``to_dict`` (programmatic snapshots,
  optionally floored for multi-tenant serving), ``to_json_lines`` (one
  JSON object per metric, log-shipper friendly), ``to_prometheus``
  (text exposition format, ``*_bucket``/``*_sum``/``*_count`` series).

A module-global :func:`kernel_registry` is kept separate from per-engine
registries: the hand-written CUDA kernels are process-wide entry points, so
their wall-times aggregate across every engine in the process.
"""

from __future__ import annotations

import json
import math
import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.lockdep import make_lock

__all__ = [
    "Counter",
    "Histogram",
    "MetricsRegistry",
    "kernel_registry",
    "prometheus_text",
]

# Fixed log-scale bucket upper bounds: 4 per decade from 1e-6 to 1e2
# (1 µs … 100 s), overflow bucket above.  Fractions (cache-hit ratio,
# delta suffix fraction) land in the same grid — it spans [0, 1] densely.
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    10.0 ** (k / 4.0) for k in range(-24, 9)
)

LabelItems = Tuple[Tuple[str, str], ...]


def _label_suffix(labels: LabelItems) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def _prom_labels(labels: LabelItems, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    """Monotonic counter; ``inc`` takes the owning registry's lock."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: LabelItems, lock: threading.Lock):
        self.name = name
        self.labels = labels
        self._lock = lock
        self._value = 0

    def inc(self, n: int = 1) -> int:
        """Increment and return the new value (the engine uses the
        ``engine_queries_total`` counter as its query-id sequence)."""
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


#: an exemplar older than this many subsequent observations is replaced
#: even by a smaller value — "worst recent", not "worst ever"
EXEMPLAR_REFRESH = 4096


class Histogram:
    """Streaming histogram over fixed log-scale buckets.

    ``observe`` is a bisect + three adds under the registry lock; no
    sample is retained.  Percentiles interpolate linearly inside the
    winning bucket and clamp to the observed ``[min, max]`` envelope.

    When an observation carries a ``trace_id``, the bucket keeps the
    (trace id, value) of its worst recent observation as an **exemplar**
    — a p99 spike in the exposition then links directly to the trace that
    caused it.  Memory stays O(buckets): one exemplar per bucket,
    refreshed after :data:`EXEMPLAR_REFRESH` further observations so a
    one-off ancient worst case cannot pin the slot forever.
    """

    __slots__ = (
        "name", "labels", "_lock", "_counts", "_count", "_sum",
        "_min", "_max", "_exemplars",
    )

    def __init__(self, name: str, labels: LabelItems, lock: threading.Lock):
        self.name = name
        self.labels = labels
        self._lock = lock
        self._counts = [0] * (len(BUCKET_BOUNDS) + 1)  # +1 overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        # bucket index -> (trace_id, value, total count at store time)
        self._exemplars: Dict[int, Tuple[str, float, int]] = {}

    def observe(self, x: float, trace_id: Optional[str] = None) -> None:
        i = bisect_left(BUCKET_BOUNDS, x)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += x
            if x < self._min:
                self._min = x
            if x > self._max:
                self._max = x
            if trace_id is not None:
                ex = self._exemplars.get(i)
                if (
                    ex is None or x >= ex[1]
                    or self._count - ex[2] > EXEMPLAR_REFRESH
                ):
                    self._exemplars[i] = (trace_id, x, self._count)

    def exemplars(self) -> Dict[int, Tuple[str, float]]:
        """``{bucket index: (trace id, value)}`` — worst recent observation
        per occupied bucket (only buckets that ever saw a trace id)."""
        with self._lock:
            return {i: (t, v) for i, (t, v, _) in self._exemplars.items()}

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-th percentile (0–100) from bucket counts."""
        with self._lock:
            if self._count == 0:
                return 0.0
            target = (q / 100.0) * self._count
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if cum + c >= target:
                    lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
                    hi = (
                        BUCKET_BOUNDS[i]
                        if i < len(BUCKET_BOUNDS)
                        else self._max
                    )
                    frac = (target - cum) / c
                    est = lo + (hi - lo) * frac
                    return min(max(est, self._min), self._max)
                cum += c
            return self._max

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            count, total = self._count, self._sum
            mn = self._min if count else 0.0
            mx = self._max if count else 0.0
        return {
            "count": count,
            "sum": total,
            "min": mn,
            "max": mx,
            "p50": self.percentile(50.0),
            "p95": self.percentile(95.0),
            "p99": self.percentile(99.0),
        }

    def bucket_counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)


class MetricsRegistry:
    """Get-or-create registry of counters, histograms, and gauges.

    All child metrics share the registry lock.  Gauges are callbacks
    evaluated at export time (e.g. telemetry ring-buffer drop counts),
    so they cost nothing between snapshots.
    """

    def __init__(self):
        self._lock = make_lock("MetricsRegistry")
        self._counters: Dict[Tuple[str, LabelItems], Counter] = {}
        self._histograms: Dict[Tuple[str, LabelItems], Histogram] = {}
        self._gauges: Dict[Tuple[str, LabelItems], Callable[[], float]] = {}
        self._help: Dict[str, str] = {}  # metric name -> # HELP text

    @staticmethod
    def _key(name: str, labels: Dict[str, str]) -> Tuple[str, LabelItems]:
        items = tuple(sorted((k, str(v)) for k, v in labels.items()))
        return (name, items)

    def counter(
        self, name: str, description: Optional[str] = None, **labels: str
    ) -> Counter:
        key = self._key(name, labels)
        with self._lock:
            if description:
                self._help.setdefault(name, description)
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter(name, key[1], self._lock)
        return c

    def histogram(
        self, name: str, description: Optional[str] = None, **labels: str
    ) -> Histogram:
        key = self._key(name, labels)
        with self._lock:
            if description:
                self._help.setdefault(name, description)
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(name, key[1], self._lock)
        return h

    def gauge(
        self,
        name: str,
        fn: Callable[[], float],
        description: Optional[str] = None,
        **labels: str,
    ) -> None:
        key = self._key(name, labels)
        with self._lock:
            if description:
                self._help.setdefault(name, description)
            self._gauges[key] = fn

    def describe(self, name: str, description: str) -> None:
        """Attach (or replace) the ``# HELP`` text of a metric name."""
        with self._lock:
            self._help[name] = description

    # -- matching (SLO objectives) ----------------------------------------

    @staticmethod
    def _matches(labels: LabelItems, want: Dict[str, str]) -> bool:
        have = dict(labels)
        return all(have.get(k) == str(v) for k, v in want.items())

    def find_histograms(self, name: str, **labels: str) -> List[Histogram]:
        """Every histogram series named ``name`` whose labels are a
        superset of ``labels`` (empty ``labels`` matches all series)."""
        with self._lock:
            items = list(self._histograms.items())
        return [
            h for (n, li), h in items
            if n == name and self._matches(li, labels)
        ]

    def find_counters(self, name: str, **labels: str) -> List[Counter]:
        """Every counter series named ``name`` whose labels are a superset
        of ``labels``."""
        with self._lock:
            items = list(self._counters.items())
        return [
            c for (n, li), c in items
            if n == name and self._matches(li, labels)
        ]

    # -- export -----------------------------------------------------------

    def _items(self):
        with self._lock:
            counters = list(self._counters.items())
            hists = list(self._histograms.items())
            gauges = list(self._gauges.items())
        return counters, hists, gauges

    def _help_snapshot(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._help)

    def to_dict(self, floor: int = 0) -> Dict[str, object]:
        """Flat snapshot ``{"name{k=v}": value-or-summary}``.

        ``floor`` is the k-anonymity floor applied to multi-tenant
        snapshots: counts below it are reported as 0 (histogram
        summaries are fully zeroed so sums can't leak small counts).
        """
        out: Dict[str, object] = {}
        counters, hists, gauges = self._items()
        for (name, labels), c in counters:
            v = c.value
            out[name + _label_suffix(labels)] = v if v >= floor else 0
        for (name, labels), h in hists:
            snap = h.snapshot()
            if snap["count"] < floor:
                snap = {k: 0 if k == "count" else 0.0 for k in snap}
            else:
                # exemplars name individual traces; a floored (multi-tenant)
                # snapshot must not carry them
                ex = h.exemplars() if floor == 0 else {}
                if ex:
                    snap = dict(snap)
                    snap["exemplars"] = [
                        {
                            "le": (
                                BUCKET_BOUNDS[i]
                                if i < len(BUCKET_BOUNDS) else math.inf
                            ),
                            "trace_id": t,
                            "value": v,
                        }
                        for i, (t, v) in sorted(ex.items())
                    ]
            out[name + _label_suffix(labels)] = snap
        for (name, labels), fn in gauges:
            v = fn()
            out[name + _label_suffix(labels)] = v if v >= floor else 0
        return out

    def to_json_lines(self) -> str:
        lines = []
        counters, hists, gauges = self._items()
        for (name, labels), c in counters:
            lines.append(json.dumps({
                "name": name, "labels": dict(labels),
                "type": "counter", "value": c.value,
            }, sort_keys=True))
        for (name, labels), h in hists:
            rec = {"name": name, "labels": dict(labels),
                   "type": "histogram"}
            rec.update(h.snapshot())
            lines.append(json.dumps(rec, sort_keys=True))
        for (name, labels), fn in gauges:
            lines.append(json.dumps({
                "name": name, "labels": dict(labels),
                "type": "gauge", "value": fn(),
            }, sort_keys=True))
        return "\n".join(lines)

    def to_prometheus(self) -> str:
        lines: List[str] = []
        counters, hists, gauges = self._items()
        help_text = self._help_snapshot()
        seen_type = set()

        def _head(name: str, kind: str) -> None:
            if name in seen_type:
                return
            seen_type.add(name)
            desc = help_text.get(name)
            if desc:
                desc = desc.replace("\\", "\\\\").replace("\n", "\\n")
                lines.append(f"# HELP {name} {desc}")
            lines.append(f"# TYPE {name} {kind}")

        for (name, labels), c in counters:
            _head(name, "counter")
            lines.append(f"{name}{_prom_labels(labels)} {c.value}")
        for (name, labels), h in hists:
            _head(name, "histogram")
            counts = h.bucket_counts()
            exemplars = h.exemplars()
            cum = 0
            for i, (bound, c) in enumerate(zip(BUCKET_BOUNDS, counts[:-1])):
                cum += c
                if c == 0:
                    continue  # sparse: emit only occupied buckets (+Inf)
                le = _prom_labels(labels, f'le="{bound:.6g}"')
                row = f"{name}_bucket{le} {cum}"
                ex = exemplars.get(i)
                if ex is not None:
                    # OpenMetrics exemplar syntax: links the bucket to the
                    # worst recent trace that landed in it
                    row += f' # {{trace_id="{ex[0]}"}} {ex[1]:.9g}'
                lines.append(row)
            cum += counts[-1]
            le = _prom_labels(labels, 'le="+Inf"')
            row = f"{name}_bucket{le} {cum}"
            ex = exemplars.get(len(BUCKET_BOUNDS))
            if ex is not None:
                row += f' # {{trace_id="{ex[0]}"}} {ex[1]:.9g}'
            lines.append(row)
            lines.append(f"{name}_sum{_prom_labels(labels)} {h.sum:.9g}")
            lines.append(f"{name}_count{_prom_labels(labels)} {h.count}")
        for (name, labels), fn in gauges:
            _head(name, "gauge")
            lines.append(f"{name}{_prom_labels(labels)} {fn()}")
        return "\n".join(lines) + "\n"


def prometheus_text(*registries: MetricsRegistry) -> str:
    """Concatenate the Prometheus exposition of several registries
    (e.g. an engine registry plus the process-wide kernel registry)."""
    return "".join(r.to_prometheus() for r in registries)


_KERNEL_REGISTRY = MetricsRegistry()


def kernel_registry() -> MetricsRegistry:
    """Process-global registry for CUDA kernel wall-times
    (``kernel_seconds{kernel=...}`` histograms, one per entry point)."""
    return _KERNEL_REGISTRY
