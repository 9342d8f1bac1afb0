"""Admission control — per-tenant token buckets with shed-don't-queue.

A tenant's dashboard refreshing at 1 Hz costs one token per request; a
runaway client paying no attention to Retry-After drains its bucket and is
shed with 429 before its requests consume a queue slot, an executor
thread, or an engine lock.  Buckets refill continuously at ``rate``
tokens/s up to ``burst``; the controller is shared-lock cheap (one
``make_lock`` guards the bucket map *and* every bucket's level — the same
one-lock-per-registry pattern as :class:`repro_torch.obs.MetricsRegistry`).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from repro_torch.analysis.lockdep import make_lock

__all__ = ["TokenBucket", "AdmissionController"]


class TokenBucket:
    """Continuous-refill token bucket.  Not thread-safe on its own: the
    owning :class:`AdmissionController` serializes access (its lock also
    covers bucket state)."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.stamp = float(now)

    def take(self, now: float, n: float = 1.0) -> float:
        """Take ``n`` tokens.  Returns 0.0 when admitted, else the seconds
        until the bucket will hold ``n`` tokens (the Retry-After value)."""
        elapsed = max(now - self.stamp, 0.0)
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        self.stamp = now
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        if self.rate <= 0.0:
            return float("inf")
        return (n - self.tokens) / self.rate


class AdmissionController:
    """Per-tenant buckets, created on first sight with the default rate.

    ``admit(tenant)`` returns ``None`` when the request may proceed, else
    the Retry-After seconds the 429 should carry.  ``set_quota`` pins a
    specific rate/burst for one tenant (e.g. a paid tier)."""

    def __init__(self, rate: float = 200.0, burst: float = 400.0):
        self.rate = float(rate)
        self.burst = float(burst)
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = make_lock("TransportAdmission")

    def set_quota(self, tenant: str, rate: float, burst: float) -> None:
        now = time.monotonic()
        with self._lock:
            self._buckets[tenant] = TokenBucket(rate, burst, now)

    def admit(self, tenant: str, cost: float = 1.0) -> Optional[float]:
        now = time.monotonic()
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = TokenBucket(
                    self.rate, self.burst, now
                )
            wait = bucket.take(now, cost)
        return None if wait == 0.0 else wait

    def tenants(self) -> int:
        with self._lock:
            return len(self._buckets)
