"""In-flight request coalescing — thousands of identical dashboards, one
engine execution.

Groups are keyed by :attr:`repro_torch.serve.RequestProbe.group_key` = (tenant
policy, canonical plan, **source fingerprint observed at enqueue time**).
The fingerprint in the key is the correctness linchpin against live
appends: a leader that started executing against fingerprint F keeps
collecting only waiters who also observed F.  The moment an append moves
the log to F′, new arrivals probe F′, miss the in-flight F group, and
start their own execution against the new bytes — a stale result is never
fanned out past the data it was computed from.

The table is **event-loop confined**: every mutation happens on the
transport's loop (handler coroutines and executor-completion callbacks),
so there is deliberately no lock here — one less ordering edge under
``REPRO_LOCKDEP=1``.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional, Tuple

from repro_torch.obs import MetricsRegistry

__all__ = ["Coalescer"]

GroupKey = Tuple[str, str, str]


class Coalescer:
    def __init__(self, metrics: MetricsRegistry):
        self._groups: Dict[GroupKey, asyncio.Future] = {}
        self._leaders: Dict[GroupKey, Optional[str]] = {}
        self._c_groups = metrics.counter(
            "transport_coalesce_groups_total",
            "Coalescing groups opened (one leader execution each)",
        )
        self._c_fanout = metrics.counter(
            "transport_coalesce_fanout_total",
            "Requests served by awaiting another request's execution",
        )

    def __len__(self) -> int:
        return len(self._groups)

    def join(self, key: GroupKey) -> Optional[asyncio.Future]:
        """The in-flight future for ``key``, counting this caller as a
        fanned-out waiter — or None when no group is open."""
        fut = self._groups.get(key)
        if fut is not None:
            self._c_fanout.inc()
        return fut

    def open(
        self, key: GroupKey, trace_id: Optional[str] = None
    ) -> asyncio.Future:
        """Open a new group led by the caller; the returned future fans the
        leader's result out to every subsequent :meth:`join`.  The leader's
        ``trace_id`` is retained so followers can link ``coalesced_into``
        in their own traces."""
        fut = asyncio.get_running_loop().create_future()
        self._groups[key] = fut
        self._leaders[key] = trace_id
        self._c_groups.inc()
        return fut

    def leader_of(self, key: GroupKey) -> Optional[str]:
        """The open group leader's trace id (None when unknown or no
        group).  Read it right after :meth:`join` — the group may settle
        and vanish across any ``await``."""
        return self._leaders.get(key)

    def settle(self, key: GroupKey, outcome) -> None:
        """Resolve and close ``key``'s group with ``outcome`` — an
        app-level ``("ok", payload)`` / ``("err", exc)`` pair, always
        delivered via ``set_result`` so a group nobody joined never logs an
        un-retrieved exception.  The group is removed *before* the future
        resolves: a request arriving after settlement opens a fresh group
        (and will find the result in the engine cache anyway)."""
        fut = self._groups.pop(key, None)
        self._leaders.pop(key, None)
        if fut is None or fut.done():
            return
        fut.set_result(outcome)
