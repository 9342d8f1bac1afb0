"""``repro_torch.serve`` — the LM serving engine and the multi-tenant
process-query service.

:class:`ServeEngine` serves a model of the zoo in waves and mines its own
telemetry; :class:`QueryService` answers wire-friendly request dicts through
one shared :class:`~repro_torch.query.QueryEngine` (on the card unless it is
given a CPU engine); :class:`RequestProbe` is its admission-time prediction.
"""

from .engine import GenerationResult, ServeEngine
from .query_service import QueryService, RequestProbe

__all__ = ["GenerationResult", "ServeEngine", "QueryService", "RequestProbe"]
