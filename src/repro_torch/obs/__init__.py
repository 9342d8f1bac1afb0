"""``repro_torch.obs`` — observability for the process-query engine.

Dependency-free (stdlib + numpy) so every engine tier can import it:

* :mod:`repro_torch.obs.trace` — :class:`QueryTrace`, a per-query execution
  trace of timed spans (parse → cache-probe → plan → scan → sink) attached
  to every query result as ``result.trace`` (:class:`NullTrace` on an
  engine built with ``trace=False``, which attaches none).
* :mod:`repro_torch.obs.metrics` — a lock-protected :class:`MetricsRegistry`
  of counters and streaming histograms.  A module-global
  :func:`kernel_registry` collects the CUDA kernels' wall-times via
  :mod:`repro_torch.kernels.timing`.
* Self-mining forensics — the engine batches every finished trace into a
  :class:`repro_torch.core.telemetry.EventCollector`, so
  ``Q.log(engine.own_telemetry())`` mines the engine's own process with the
  engine itself (the paper's Algorithm 1 over the engine's spans).
* :mod:`repro_torch.obs.context` — W3C-traceparent-style
  :class:`TraceContext` identities for the traces.
* :mod:`repro_torch.obs.slo` — declarative :class:`Objective`s evaluated
  over live registries by :class:`SLOEngine`: verdicts, error budgets, and
  multi-window burn-rate alerts (``{"sink": "slo"}``).
* :mod:`repro_torch.obs.store` — :class:`TraceStore`, a bounded on-disk
  JSONL ring of tail-sampled finished traces, readable back as an event log
  so the engine's traces mine bit-identically to Algorithm 1.
"""

from .context import TraceContext, mint_context, new_span_id, parse_traceparent
from .metrics import (
    Counter,
    Histogram,
    MetricsRegistry,
    kernel_registry,
    prometheus_text,
)
from .slo import Objective, SLOEngine, default_service_objectives
from .store import TraceStore
from .trace import NullTrace, QueryTrace, Span

__all__ = [
    "Counter",
    "Histogram",
    "MetricsRegistry",
    "NullTrace",
    "Objective",
    "SLOEngine",
    "TraceContext",
    "TraceStore",
    "default_service_objectives",
    "kernel_registry",
    "mint_context",
    "new_span_id",
    "parse_traceparent",
    "prometheus_text",
    "Span",
    "QueryTrace",
]
