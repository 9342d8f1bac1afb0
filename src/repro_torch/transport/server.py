"""Stdlib-only asyncio HTTP/1.1 front end for :class:`TransportApp`.

No web framework — ``asyncio.start_server`` plus a small request parser is
all the wire needs, which keeps the serving tier importable anywhere the
engine is.  Endpoints:

* ``POST /query`` — one request dict in, one JSON response out; headers
  carry ``X-Lane`` (hot/cold), ``X-Coalesced`` and, on 429,
  ``Retry-After``.
* ``POST /query/stream`` — same request, NDJSON chunked response (one meta
  line, one line per list element, ``{"end": true}``): alignment payloads
  with one entry per trace never buffer server-side.
* ``POST /append`` — live event append.
* ``GET /metrics`` — Prometheus text exposition (engine + kernel
  registries, transport series included).
* ``GET /stream/metrics`` / ``GET /stream/forensics`` — live NDJSON feeds
  of the introspection sinks (``?interval=0.5&count=10``).
* ``GET /slo`` — objective verdicts, error budgets, and burn-rate alerts
  (the ``{"sink": "slo"}`` introspection over HTTP).
* ``GET /healthz`` — liveness.
* ``GET /readyz`` — readiness: probes engine registry, log registry,
  graph store, and scheduler-lane saturation; 503 + JSON reasons when
  degraded.

The tenant identity is the ``X-Tenant`` header (default ``"default"``) —
admission quotas key on it.  An inbound ``traceparent`` header roots the
request's distributed trace under the caller's; responses echo the
request's own context back (``traceparent`` / ``X-Trace-Id``).
"""

from __future__ import annotations

import asyncio
import json
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from .app import TransportApp, TransportResponse
from .stream import iter_ndjson

__all__ = ["TransportServer"]

_MAX_HEADER_BYTES = 64 * 1024


class _BadRequest(Exception):
    pass


async def _read_request(
    reader: asyncio.StreamReader, max_body: int
) -> Optional[Tuple[str, str, Dict[str, str], bytes]]:
    """Parse one HTTP/1.1 request; None on a cleanly closed connection."""
    try:
        line = await reader.readline()
    except (ConnectionResetError, asyncio.IncompleteReadError):
        return None
    if not line:
        return None
    parts = line.decode("latin-1").rstrip("\r\n").split(" ")
    if len(parts) != 3:
        raise _BadRequest("malformed request line")
    method, target, _version = parts
    headers: Dict[str, str] = {}
    total = len(line)
    while True:
        line = await reader.readline()
        total += len(line)
        if total > _MAX_HEADER_BYTES:
            raise _BadRequest("headers too large")
        if line in (b"\r\n", b"\n", b""):
            break
        key, _, value = line.decode("latin-1").partition(":")
        headers[key.strip().lower()] = value.strip()
    length = int(headers.get("content-length", "0") or "0")
    if length > max_body:
        raise _BadRequest(f"body exceeds {max_body} bytes")
    body = await reader.readexactly(length) if length else b""
    return method, target, headers, body


def _write_response(
    writer: asyncio.StreamWriter, resp: TransportResponse
) -> None:
    body = json.dumps(resp.payload).encode()
    head = [f"HTTP/1.1 {resp.status} {_reason(resp.status)}"]
    head.append("Content-Type: application/json")
    head.append(f"Content-Length: {len(body)}")
    for k, v in resp.headers.items():
        head.append(f"{k}: {v}")
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)


def _reason(status: int) -> str:
    return {
        200: "OK", 400: "Bad Request", 403: "Forbidden", 404: "Not Found",
        405: "Method Not Allowed", 413: "Payload Too Large",
        429: "Too Many Requests", 500: "Internal Server Error",
        503: "Service Unavailable",
    }.get(status, "Unknown")


class TransportServer:
    def __init__(
        self,
        app: Optional[TransportApp] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.app = app or TransportApp()
        self.host = host
        self.port = port  # 0 = ephemeral; resolved after start()
        self._server: Optional[asyncio.AbstractServer] = None

    # -- lifecycle ------------------------------------------------------------
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._connection, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self.app.close()

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._server.serve_forever()

    # -- connection handling --------------------------------------------------
    async def _connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                try:
                    req = await _read_request(
                        reader, self.app.config.max_body_bytes
                    )
                except _BadRequest as exc:
                    _write_response(
                        writer,
                        TransportResponse(
                            400, {"error": "BadRequest", "detail": str(exc)}
                        ),
                    )
                    await writer.drain()
                    break
                if req is None:
                    break
                method, target, headers, body = req
                keep_alive = (
                    headers.get("connection", "keep-alive").lower()
                    != "close"
                )
                await self._dispatch(writer, method, target, headers, body)
                await writer.drain()
                if not keep_alive:
                    break
        except (ConnectionResetError, asyncio.IncompleteReadError,
                BrokenPipeError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _dispatch(
        self,
        writer: asyncio.StreamWriter,
        method: str,
        target: str,
        headers: Dict[str, str],
        body: bytes,
    ) -> None:
        url = urlsplit(target)
        path = url.path
        tenant = headers.get("x-tenant", "default")
        traceparent = headers.get("traceparent")
        try:
            if path == "/healthz" and method == "GET":
                _write_response(
                    writer, TransportResponse(200, {"ok": True})
                )
            elif path == "/readyz" and method == "GET":
                ready, report = self.app.readiness()
                _write_response(
                    writer, TransportResponse(200 if ready else 503, report)
                )
            elif path == "/metrics" and method == "GET":
                self._write_prometheus(writer)
            elif path == "/slo" and method == "GET":
                _write_response(
                    writer,
                    await self.app.handle(
                        {"sink": "slo"}, tenant, traceparent
                    ),
                )
            elif path == "/query" and method == "POST":
                request = self._body_json(body)
                _write_response(
                    writer, await self.app.handle(request, tenant, traceparent)
                )
            elif path == "/append" and method == "POST":
                request = self._body_json(body)
                _write_response(
                    writer, await self.app.append(request, tenant)
                )
            elif path == "/query/stream" and method == "POST":
                request = self._body_json(body)
                resp = await self.app.handle(request, tenant, traceparent)
                if not resp.ok:
                    _write_response(writer, resp)
                else:
                    await self._write_ndjson(
                        writer, iter_ndjson(resp.payload), resp.headers
                    )
            elif path in ("/stream/metrics", "/stream/forensics") and (
                method == "GET"
            ):
                await self._live_stream(
                    writer, path.rsplit("/", 1)[1], url.query, tenant
                )
            else:
                _write_response(
                    writer,
                    TransportResponse(
                        405 if path in (
                            "/query", "/append", "/query/stream",
                            "/metrics", "/healthz", "/readyz", "/slo",
                        ) else 404,
                        {"error": "NoSuchEndpoint", "detail": target},
                    ),
                )
        except _BadRequest as exc:
            _write_response(
                writer,
                TransportResponse(
                    400, {"error": "BadRequest", "detail": str(exc)}
                ),
            )

    @staticmethod
    def _body_json(body: bytes) -> Dict:
        try:
            request = json.loads(body.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            raise _BadRequest(f"invalid JSON body: {exc}")
        if not isinstance(request, dict):
            raise _BadRequest("request body must be a JSON object")
        return request

    def _write_prometheus(self, writer: asyncio.StreamWriter) -> None:
        from repro_torch.obs import kernel_registry, prometheus_text

        text = prometheus_text(
            self.app.service.engine.metrics, kernel_registry()
        ).encode()
        writer.write(
            (
                "HTTP/1.1 200 OK\r\n"
                "Content-Type: text/plain; version=0.0.4\r\n"
                f"Content-Length: {len(text)}\r\n\r\n"
            ).encode()
            + text
        )

    async def _write_ndjson(
        self,
        writer: asyncio.StreamWriter,
        lines,
        extra_headers: Dict[str, str],
    ) -> None:
        head = [
            "HTTP/1.1 200 OK",
            "Content-Type: application/x-ndjson",
            "Transfer-Encoding: chunked",
        ]
        for k, v in extra_headers.items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
        for line in lines:
            chunk = line.encode()
            writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
            await writer.drain()
        writer.write(b"0\r\n\r\n")

    async def _live_stream(
        self,
        writer: asyncio.StreamWriter,
        sink: str,
        query: str,
        tenant: str,
    ) -> None:
        """Poll the introspection sink every ``interval`` seconds, one JSON
        line per snapshot — a live dashboard feed off the engine's own
        metrics/telemetry."""
        params = parse_qs(query)
        try:
            interval = float(params.get("interval", ["0.5"])[0])
            count = int(params.get("count", ["10"])[0])
        except ValueError:
            raise _BadRequest("interval/count must be numeric")
        interval = min(max(interval, 0.01), 60.0)
        count = min(max(count, 1), 10_000)

        async def snapshots():
            for i in range(count):
                resp = await self.app.handle({"sink": sink}, tenant)
                yield json.dumps(
                    {"seq": i, "status": resp.status, "body": resp.payload}
                ) + "\n"
                if i + 1 < count:
                    await asyncio.sleep(interval)
            yield json.dumps({"end": True}) + "\n"

        head = (
            "HTTP/1.1 200 OK\r\n"
            "Content-Type: application/x-ndjson\r\n"
            "Transfer-Encoding: chunked\r\n\r\n"
        )
        writer.write(head.encode())
        async for line in snapshots():
            chunk = line.encode()
            writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
            await writer.drain()
        writer.write(b"0\r\n\r\n")
