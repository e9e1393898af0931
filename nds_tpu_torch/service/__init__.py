"""The concurrent query service of the port: admission-controlled async
execution over one shared Session on the card.

- :class:`QueryService` — bounded admission, planner threads overlapping
  parse and plan with the device lane, one device lane, and batching of
  compatible parameterized plans (one CUDA graph over stacked parameter
  slots per program and batch capacity).
- :class:`ServiceConfig` — admission limits, worker counts, per-tenant
  deadlines, batching and self-healing knobs (the reference's defaults).
- :class:`Ticket` — one submitted query's async handle (``result()``).
- typed failures: :class:`AdmissionRejected` (queue full),
  :class:`ServiceClosed` (not running), :class:`DeadlineExceeded` and
  :class:`CircuitOpen`.

The reference's front door (``service/frontdoor.py``) and result cache
(``engine/result_cache.py``) are not ported yet.
"""
from ..resilience import (AdmissionRejected, CircuitBreakerConfig,
                          CircuitOpen, DeadlineExceeded)
from .service import QueryService, ServiceClosed, ServiceConfig, Ticket

__all__ = ["QueryService", "ServiceConfig", "Ticket", "ServiceClosed",
           "AdmissionRejected", "CircuitBreakerConfig", "CircuitOpen",
           "DeadlineExceeded"]
