"""``repro_torch.obs`` — observability for the process-query engine.

Dependency-free (stdlib + numpy) so every engine tier can import it:

* :mod:`repro_torch.obs.trace` — :class:`QueryTrace`, a per-query execution
  trace of timed spans (parse → cache-probe → plan → scan → sink) attached
  to every query result as ``result.trace``.
* :mod:`repro_torch.obs.metrics` — a lock-protected :class:`MetricsRegistry`
  of counters and streaming histograms.  A module-global
  :func:`kernel_registry` collects the CUDA kernels' wall-times via
  :mod:`repro_torch.kernels.timing`.
* :mod:`repro_torch.obs.context` — W3C-traceparent-style
  :class:`TraceContext` identities for the traces.
"""

from .context import TraceContext, mint_context, new_span_id, parse_traceparent
from .metrics import (
    Counter,
    Histogram,
    MetricsRegistry,
    kernel_registry,
    prometheus_text,
)
from .trace import QueryTrace, Span

__all__ = [
    "Counter",
    "Histogram",
    "MetricsRegistry",
    "TraceContext",
    "kernel_registry",
    "mint_context",
    "new_span_id",
    "parse_traceparent",
    "prometheus_text",
    "Span",
    "QueryTrace",
]
