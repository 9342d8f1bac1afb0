"""``repro_torch.serve`` — the multi-tenant process-query service.

:class:`QueryService` answers wire-friendly request dicts through one shared
:class:`~repro_torch.query.QueryEngine` (on the card unless it is given a
CPU engine); :class:`RequestProbe` is its admission-time prediction.
"""

from .query_service import QueryService, RequestProbe

__all__ = ["QueryService", "RequestProbe"]
