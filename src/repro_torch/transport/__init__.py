"""``repro_torch.transport`` — the async serving tier over
:class:`~repro_torch.serve.QueryService`.

The paper's thesis is that the *store* does the mining; this package is
what makes the store a shared service: an asyncio HTTP/JSON layer that
keeps thousands of concurrent dashboards from melting the engine.

* **Admission control** (:mod:`.admission`) — per-tenant token-bucket rate
  limits; over-limit requests shed with 429 + Retry-After instead of
  queueing.
* **Request coalescing** (:mod:`.coalesce`) — in-flight requests dedup'd
  by (tenant policy, canonical plan, source fingerprint observed at
  enqueue): N identical concurrent queries execute once, everyone shares
  the result.
* **SLO-aware two-lane scheduling** (:mod:`.scheduler`) — predicted
  cache/delta/graph serves (~µs–ms) ride the hot lane, predicted cold
  scans (~100s of ms) the cold lane, so a burst of cold scans never
  head-of-line-blocks warm dashboard traffic.  The hot/cold boundary is
  ``slo_hot_cutoff_s`` from :func:`repro_torch.query.planner.
  load_calibration`: measured on the card when ``BENCH_torch_serve.json``
  exists, else the static ``SLO_HOT_CUTOFF_S``.
* **Streaming responses** (:mod:`.stream`, :mod:`.server`) — NDJSON
  chunked streaming for large payloads and the live ``metrics`` /
  ``forensics`` endpoints.

All of it reports through the engine's own :class:`MetricsRegistry`, so
``{"sink": "metrics"}`` and the Prometheus exposition cover the transport
tier with no second registry.

The default :class:`TransportApp` serves ``QueryService()``, whose engine
runs on the card; pass ``TransportApp(QueryService(QueryEngine(
device="cpu")))`` to serve from the host.
"""

from .admission import AdmissionController, TokenBucket
from .app import TransportApp, TransportConfig, TransportResponse, canonical_payload
from .coalesce import Coalescer
from .scheduler import TwoLaneScheduler
from .server import TransportServer
from .stream import iter_ndjson, reassemble_ndjson

__all__ = [
    "AdmissionController",
    "TokenBucket",
    "TransportApp",
    "TransportConfig",
    "TransportResponse",
    "TransportServer",
    "Coalescer",
    "TwoLaneScheduler",
    "canonical_payload",
    "iter_ndjson",
    "reassemble_ndjson",
]
