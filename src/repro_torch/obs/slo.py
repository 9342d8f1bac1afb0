"""Declarative SLOs with burn-rate alerting over the live metrics.

An :class:`Objective` states a promise in user terms — "99% of warm-lane
requests under 25 ms", "99.9% of requests served" — against metric series
already in a :class:`~repro_torch.obs.metrics.MetricsRegistry`; nothing new is
instrumented.  The :class:`SLOEngine` turns the registry's cumulative
counters/histogram buckets into:

* a **verdict** per objective (latency objectives also report the
  measured percentile, so a verdict is exactly a p99-under-threshold
  check),
* **error-budget accounting** — the fraction of the allowed bad events
  not yet spent,
* **multi-window burn rates** — the classic SRE construction: the rate
  at which the budget is being consumed, measured over a short and a
  long window simultaneously via snapshot deltas (:meth:`SLOEngine.tick`
  records the snapshots); an alert fires only when *every* window burns
  faster than the objective's threshold, which keeps one latency spike
  from paging while still catching sustained budget exhaustion fast.

Latency objectives count "good" events from the histogram's cumulative
log-scale buckets (linear interpolation inside the bucket straddling the
threshold — same estimator the percentiles use).  Availability objectives
count good/bad from two counter selections.  A selection is (metric name
+ label subset) and sums every matching series, so ``lane="hot"`` or an
unlabelled total both work.

Lock discipline: the engine's own lock only guards the snapshot ring;
registry metrics are always read *before* it is taken, so there is no
SLOEngine ↔ MetricsRegistry ordering cycle under ``REPRO_LOCKDEP=1``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.lockdep import make_lock

from .metrics import BUCKET_BOUNDS, MetricsRegistry

__all__ = ["Objective", "SLOEngine", "default_service_objectives"]


@dataclasses.dataclass(frozen=True)
class Objective:
    """One service-level objective over existing metric series."""

    name: str
    #: "latency" (histogram + per-event threshold) or "availability"
    #: (good/bad counter pair)
    kind: str
    #: promised fraction of good events, e.g. 0.99 / 0.999
    target: float
    #: histogram name (latency) or good-event counter name (availability)
    metric: str
    #: label subset selecting the series to sum (empty = all series)
    labels: Tuple[Tuple[str, str], ...] = ()
    #: latency objectives: an event is good iff it finished under this
    threshold_s: Optional[float] = None
    #: reported percentile for the latency verdict (p<percentile> must be
    #: under ``threshold_s``)
    percentile: float = 99.0
    #: availability objectives: counter of bad events
    bad_metric: Optional[str] = None
    bad_labels: Tuple[Tuple[str, str], ...] = ()
    #: alert when every window burns the budget faster than this multiple
    #: of the sustainable rate (14.4 ≈ "2% of a 30-day budget in 1 hour")
    burn_alert: float = 14.4

    def __post_init__(self):
        if self.kind not in ("latency", "availability"):
            raise ValueError(f"unknown objective kind {self.kind!r}")
        if self.kind == "latency" and self.threshold_s is None:
            raise ValueError(f"latency objective {self.name!r} needs threshold_s")
        if self.kind == "availability" and self.bad_metric is None:
            raise ValueError(
                f"availability objective {self.name!r} needs bad_metric"
            )
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target}")


def default_service_objectives() -> List[Objective]:
    """The serving tier's stock objectives: warm-lane p99 under 25 ms,
    and 99.9% of requests admitted (not shed).  They are targets (the
    reference package's), not measurements."""
    return [
        Objective(
            name="warm_latency",
            kind="latency",
            target=0.99,
            metric="request_latency_seconds",
            labels=(("lane", "hot"),),
            threshold_s=0.025,
            percentile=99.0,
        ),
        Objective(
            name="availability",
            kind="availability",
            target=0.999,
            metric="transport_requests_total",
            bad_metric="transport_shed_total",
        ),
    ]


def _sum_bucket_counts(hists) -> Tuple[List[int], int, float, float]:
    """Element-wise sum of several histograms' buckets plus the combined
    count and [min, max] envelope."""
    counts = [0] * (len(BUCKET_BOUNDS) + 1)
    total = 0
    mn, mx = math.inf, -math.inf
    for h in hists:
        for i, c in enumerate(h.bucket_counts()):
            counts[i] += c
        snap = h.snapshot()
        total += snap["count"]
        if snap["count"]:
            mn = min(mn, snap["min"])
            mx = max(mx, snap["max"])
    if total == 0:
        mn = mx = 0.0
    return counts, total, mn, mx


def _percentile(
    counts: List[int], total: int, mn: float, mx: float, q: float
) -> float:
    """Percentile estimate over summed log-scale buckets (same
    interpolation as :meth:`Histogram.percentile`)."""
    if total == 0:
        return 0.0
    target = (q / 100.0) * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
            hi = BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS) else mx
            est = lo + (hi - lo) * (target - cum) / c
            return min(max(est, mn), mx)
        cum += c
    return mx


def _good_below(counts: List[int], threshold: float) -> float:
    """Events at or under ``threshold`` from cumulative bucket counts,
    interpolating linearly inside the straddling bucket."""
    good = 0.0
    prev = 0.0
    for i, bound in enumerate(BUCKET_BOUNDS):
        c = counts[i]
        if bound <= threshold:
            good += c
            prev = bound
            continue
        if threshold > prev and bound > prev:
            good += c * (threshold - prev) / (bound - prev)
        break
    return good


class SLOEngine:
    """Evaluate :class:`Objective`s over one or more registries.

    :meth:`tick` records a (time, per-objective good/total) snapshot into
    a bounded ring; :meth:`evaluate` reports verdicts, budgets, and the
    per-window burn rates computed from snapshot deltas.  ``now`` is
    injectable for deterministic tests.
    """

    def __init__(
        self,
        *registries: MetricsRegistry,
        objectives: Optional[List[Objective]] = None,
        windows_s: Tuple[float, ...] = (300.0, 3600.0),
        now=time.monotonic,
        max_snapshots: int = 512,
    ):
        if not registries:
            raise ValueError("SLOEngine needs at least one MetricsRegistry")
        self.registries = registries
        self.objectives = (
            list(objectives)
            if objectives is not None
            else default_service_objectives()
        )
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.windows_s = tuple(float(w) for w in windows_s)
        self._now = now
        # ring of (t, {objective: (good, total)}) — guarded by _lock
        self._snaps = deque(maxlen=max_snapshots)
        self._lock = make_lock("SLOEngine")

    # -- measurement (registry reads happen with no SLO lock held) ---------

    def _series(self, kind: str, name: str, labels) -> list:
        out = []
        want = dict(labels)
        for reg in self.registries:
            if kind == "histogram":
                out.extend(reg.find_histograms(name, **want))
            else:
                out.extend(reg.find_counters(name, **want))
        return out

    def _measure(self, obj: Objective) -> Dict[str, float]:
        """Cumulative good/total (+ measured percentile for latency)."""
        if obj.kind == "latency":
            hists = self._series("histogram", obj.metric, obj.labels)
            counts, total, mn, mx = _sum_bucket_counts(hists)
            good = _good_below(counts, obj.threshold_s)
            measured = _percentile(counts, total, mn, mx, obj.percentile)
            return {"good": good, "total": float(total), "measured": measured}
        good = float(sum(
            c.value for c in self._series("counter", obj.metric, obj.labels)
        ))
        bad = float(sum(
            c.value
            for c in self._series("counter", obj.bad_metric, obj.bad_labels)
        ))
        return {"good": good, "total": good + bad, "measured": None}

    def tick(self, now: Optional[float] = None) -> None:
        """Record one burn-rate snapshot (call periodically, or rely on
        :meth:`evaluate`'s implicit tick)."""
        t = self._now() if now is None else now
        counts = {}
        for obj in self.objectives:
            m = self._measure(obj)
            counts[obj.name] = (m["good"], m["total"])
        with self._lock:
            self._snaps.append((t, counts))

    def _burn_rates(
        self, obj: Objective, t: float, good: float, total: float,
        snaps,
    ) -> Dict[str, Optional[float]]:
        """Budget burn per window from snapshot deltas: (bad fraction over
        the window) / (allowed bad fraction).  1.0 = exactly sustainable;
        None = no snapshot old enough to span the window yet."""
        budget = 1.0 - obj.target
        out: Dict[str, Optional[float]] = {}
        for w in self.windows_s:
            base = None
            for ts, counts in snaps:  # oldest-first: last one ≤ t-w wins
                if ts <= t - w and obj.name in counts:
                    base = counts[obj.name]
                elif ts > t - w:
                    break
            key = f"{w:g}s"
            if base is None:
                # not enough history: fall back to the oldest snapshot so a
                # young process still reports a (cumulative) burn signal
                base = next(
                    (c[obj.name] for _, c in snaps if obj.name in c), None
                )
            if base is None:
                out[key] = None
                continue
            d_good = good - base[0]
            d_total = total - base[1]
            if d_total <= 0:
                out[key] = 0.0
                continue
            bad_frac = max(d_total - d_good, 0.0) / d_total
            out[key] = bad_frac / budget
        return out

    def evaluate(
        self, now: Optional[float] = None, *, tick: bool = True,
        floor: int = 0,
    ) -> Dict[str, object]:
        """Verdicts + budgets + burn rates, JSON-shaped.

        ``floor`` is the serving tier's k-anonymity floor: objectives with
        fewer than ``floor`` total events report zeroed counts and a None
        verdict (event counts must not leak below the floor)."""
        if tick:
            self.tick(now)
        t = self._now() if now is None else now
        with self._lock:
            snaps = list(self._snaps)
        objectives = []
        alerts = []
        for obj in self.objectives:
            m = self._measure(obj)
            good, total = m["good"], m["total"]
            if total < floor:
                objectives.append({
                    "name": obj.name, "kind": obj.kind, "target": obj.target,
                    "threshold_s": obj.threshold_s, "ok": None,
                    "total": 0, "good": 0, "bad": 0, "good_ratio": None,
                    "measured": None, "error_budget_remaining": None,
                    "burn_rates": {f"{w:g}s": None for w in self.windows_s},
                    "alert": False,
                })
                continue
            bad = max(total - good, 0.0)
            ratio = good / total if total else None
            if total == 0:
                ok = None
            elif obj.kind == "latency":
                ok = bool(m["measured"] <= obj.threshold_s)
            else:
                ok = bool(ratio >= obj.target)
            budget = 1.0 - obj.target
            budget_left = (
                1.0 - (bad / total) / budget if total else None
            )
            burns = self._burn_rates(obj, t, good, total, snaps)
            rates = [b for b in burns.values() if b is not None]
            alert = bool(rates) and all(b > obj.burn_alert for b in rates)
            if alert:
                alerts.append(obj.name)
            objectives.append({
                "name": obj.name,
                "kind": obj.kind,
                "target": obj.target,
                "threshold_s": obj.threshold_s,
                "percentile": obj.percentile if obj.kind == "latency" else None,
                "measured": m["measured"],
                "ok": ok,
                "total": int(total),
                "good": round(good, 3),
                "bad": round(bad, 3),
                "good_ratio": ratio,
                "error_budget_remaining": budget_left,
                "burn_rates": burns,
                "alert": alert,
            })
        return {
            "sink": "slo",
            "windows_s": list(self.windows_s),
            "objectives": objectives,
            "alerts": alerts,
            "ok": all(o["ok"] is not False for o in objectives),
        }
