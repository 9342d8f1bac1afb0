"""NDJSON streaming for large query payloads.

Alignment and per-trace-fitness responses carry one entry per trace — for
a 10M-event log that is a payload a browser should not have to buffer.
:func:`iter_ndjson` flattens a query-result dict into newline-delimited
JSON: one ``meta`` line carrying every scalar field and naming the
streamed list fields, then one line per list element, then a terminal
``{"end": true}`` marker so a client can distinguish completion from a
dropped connection.  :func:`reassemble_ndjson` is the exact inverse —
``reassemble_ndjson(iter_ndjson(p)) == p`` — which is what the transport
tests lean on for the bit-identity guarantee.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Iterator, List

__all__ = ["iter_ndjson", "reassemble_ndjson"]


def iter_ndjson(payload: Dict[str, Any]) -> Iterator[str]:
    """Yield NDJSON lines (each ``\\n``-terminated) for ``payload``.

    Every top-level list field is streamed element-by-element; everything
    else rides the leading meta line.  Key order within each streamed
    field is preserved, so reassembly is exact."""
    streams: List[str] = [
        k for k, v in payload.items() if isinstance(v, list)
    ]
    meta = {k: v for k, v in payload.items() if k not in streams}
    yield json.dumps({"meta": meta, "streams": streams}) + "\n"
    for key in streams:
        for item in payload[key]:
            yield json.dumps({"key": key, "item": item}) + "\n"
    yield json.dumps({"end": True}) + "\n"


def reassemble_ndjson(lines: Iterable[str]) -> Dict[str, Any]:
    """Inverse of :func:`iter_ndjson`.  Raises ValueError on a truncated
    stream (missing ``{"end": true}``) or a malformed line."""
    it = iter(lines)
    try:
        head = json.loads(next(it))
    except StopIteration:
        raise ValueError("empty NDJSON stream")
    if "meta" not in head or "streams" not in head:
        raise ValueError("NDJSON stream missing meta header")
    payload: Dict[str, Any] = dict(head["meta"])
    for key in head["streams"]:
        payload[key] = []
    ended = False
    for line in it:
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line)
        if obj.get("end") is True:
            ended = True
            break
        if "key" not in obj:
            raise ValueError(f"malformed NDJSON line: {line[:80]}")
        payload[obj["key"]].append(obj["item"])
    if not ended:
        raise ValueError("truncated NDJSON stream (no end marker)")
    return payload
