"""W3C-traceparent-style trace context for cross-process propagation.

A :class:`TraceContext` is the wire identity of one node in a request
tree: a 128-bit trace id shared by every span of the request, a 64-bit
span id naming this node, and the sampling bit.  The query engine mints
one for every root query; the serving tier (not ported yet) propagates it
across processes so one id stitches the whole request tree.

Id generation is deliberately cheap: a per-process random prefix plus an
atomic counter (``itertools.count().__next__`` is a single C call under
the GIL), not a syscall per query — the engine mints a context for every
root query, and that sits inside the always-on tracing budget.

Header grammar (the W3C subset we speak)::

    traceparent: 00-<32 lowercase hex>-<16 lowercase hex>-<2 hex flags>

:func:`parse_traceparent` returns None for anything malformed — a bad
header must never fail the request; the transport just mints a fresh
context instead.
"""

from __future__ import annotations

import itertools
import os
from typing import NamedTuple, Optional

__all__ = [
    "TraceContext",
    "mint_context",
    "new_span_id",
    "parse_traceparent",
]

#: sampling flag bit of the traceparent trace-flags octet
FLAG_SAMPLED = 0x01

_HEX = set("0123456789abcdef")

# per-process random prefixes keep ids unique across serving replicas
# while the low 64 bits stay a cheap atomic counter
_TRACE_PREFIX = os.urandom(8).hex()
_SPAN_PREFIX = int.from_bytes(os.urandom(3), "big")
_SEQ = itertools.count(1).__next__


def new_span_id() -> str:
    """A fresh 16-hex-char span id (process prefix + atomic sequence)."""
    return f"{_SPAN_PREFIX:06x}{_SEQ() & 0xFFFFFFFFFF:010x}"


class TraceContext(NamedTuple):
    """One node of a distributed trace: (trace id, this node's span id,
    sampling decision).  Immutable — derive children, never mutate."""

    trace_id: str
    span_id: str
    sampled: bool = True

    def child(self) -> "TraceContext":
        """A child context: same trace, fresh span id, inherited sampling.
        The caller records ``self.span_id`` as the child's parent."""
        return TraceContext(self.trace_id, new_span_id(), self.sampled)

    def to_traceparent(self) -> str:
        flags = FLAG_SAMPLED if self.sampled else 0
        return f"00-{self.trace_id}-{self.span_id}-{flags:02x}"


def mint_context(sampled: bool = True) -> TraceContext:
    """A fresh root context (new trace id, new span id)."""
    trace_id = f"{_TRACE_PREFIX}{_SEQ() & 0xFFFFFFFFFFFFFFFF:016x}"
    return TraceContext(trace_id, new_span_id(), sampled)


def _is_hex(s: str) -> bool:
    return all(c in _HEX for c in s)


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """Parse an inbound ``traceparent`` header; None when malformed.

    Accepts the W3C shape ``version-traceid-spanid-flags`` with lowercase
    hex fields, rejects the all-zero ids and the invalid ``ff`` version.
    Unknown (non-``00``) versions parse leniently per spec as long as the
    four core fields are well-formed.
    """
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id):
        return None
    if len(span_id) != 16 or not _is_hex(span_id):
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(
        trace_id, span_id, bool(int(flags, 16) & FLAG_SAMPLED)
    )
