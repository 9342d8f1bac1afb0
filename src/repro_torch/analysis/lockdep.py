"""Runtime lock-order sanitizer — "lockdep-lite" for the engine's locks.

The engine has a handful of independent locks (QueryEngine memos,
QueryCache, GraphStore registry, MetricsRegistry, EventCollector,
QueryService registry + per-log append locks).  Deadlocks between them
would only ever manifest under concurrency the unit tests may not hit, so
— like the kernel's lockdep — this module catches *ordering* violations on
any single-threaded pass through the code:

* every lock site constructs its lock via :func:`make_lock(name)`;
* with ``REPRO_LOCKDEP=1`` in the environment the factory returns a
  wrapping lock that records, per thread, the stack of held locks and
  grows a global acquired-before graph over lock *names*;
* acquiring ``B`` while holding ``A`` adds the edge ``A → B``; if ``B``
  can already reach ``A`` in the graph, some other code path acquires
  them in the opposite order and :class:`LockOrderError` is raised —
  whether or not the two paths ever ran concurrently;
* re-acquiring a lock instance already held by the current thread raises
  immediately (a plain ``threading.Lock`` would deadlock).

Same-*name* different-instance pairs (e.g. the per-log append locks) are
exempt from ordering edges: they form a family whose members are never
nested.  Without the env var, :func:`make_lock` returns a plain
``threading.Lock`` — zero overhead in production.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Set, Tuple

__all__ = [
    "LockOrderError",
    "LockdepLock",
    "make_lock",
    "lockdep_enabled",
    "reset",
    "order_edges",
    "held_locks",
]


class LockOrderError(RuntimeError):
    """Inconsistent lock acquisition order (potential deadlock)."""


def lockdep_enabled() -> bool:
    return os.environ.get("REPRO_LOCKDEP", "") == "1"


# acquired-before graph over lock names; guarded by its own plain lock
_graph_mu = threading.Lock()
_edges: Dict[str, Set[str]] = {}
_tls = threading.local()


def _stack() -> List["LockdepLock"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _reaches(src: str, dst: str) -> bool:
    """Is ``dst`` reachable from ``src`` in the acquired-before graph?
    Caller holds ``_graph_mu``."""
    seen = set()
    frontier = [src]
    while frontier:
        n = frontier.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        frontier.extend(_edges.get(n, ()))
    return False


class LockdepLock:
    """A ``threading.Lock`` recording per-thread hold stacks and global
    acquisition order; drop-in for the subset of the Lock API the engine
    uses (``with``, ``acquire``/``release``, ``locked``)."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.Lock()

    def _before_acquire(self) -> None:
        held = _stack()
        for h in held:
            if h is self:
                raise LockOrderError(
                    f"recursive acquisition of lock {self.name!r} "
                    "(non-reentrant; this would deadlock)"
                )
        with _graph_mu:
            for h in held:
                if h.name == self.name:
                    continue  # same-name family members are never ordered
                if _reaches(self.name, h.name):
                    raise LockOrderError(
                        f"lock order inversion: acquiring {self.name!r} "
                        f"while holding {h.name!r}, but "
                        f"{self.name!r} → … → {h.name!r} was recorded on "
                        "another code path"
                    )
                _edges.setdefault(h.name, set()).add(self.name)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._before_acquire()
        got = self._inner.acquire(blocking, timeout)
        if got:
            _stack().append(self)
        return got

    def release(self) -> None:
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is self:
                del st[i]
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"LockdepLock({self.name!r})"


def make_lock(name: str):
    """The engine's lock constructor: plain ``threading.Lock`` normally, a
    :class:`LockdepLock` under ``REPRO_LOCKDEP=1``."""
    if lockdep_enabled():
        return LockdepLock(name)
    return threading.Lock()


def reset() -> None:
    """Clear the global order graph (test isolation)."""
    with _graph_mu:
        _edges.clear()


def order_edges() -> Set[Tuple[str, str]]:
    """Snapshot of the recorded acquired-before edges."""
    with _graph_mu:
        return {(a, b) for a, bs in _edges.items() for b in bs}


def held_locks() -> List[str]:
    """Names of locks held by the current thread (innermost last)."""
    return [l.name for l in _stack()]
