"""Observability of the port: copies of the reference's jax-free modules.

- :mod:`.trace`     — the lifecycle span tracer (the copied planner's
  rewrite passes and the query service's ticket spans);
- :mod:`.metrics`   — the process-wide counter/gauge/histogram registry;
- :mod:`.flight`    — the bounded ring of query-lifecycle events;
- :mod:`.stats`     — the typed ``ExecStats`` record;
- :mod:`.query_log` — the durable query log (one flat row a statement);
- :mod:`.profile`   — the device-memory watermark accountant
  (``DEVICE_MEM``) only; EXPLAIN ANALYZE is not ported yet;
- :mod:`.log`       — the ``logging``-based diagnostics channel.
"""
from .trace import TRACER, span                                  # noqa: F401
from .metrics import METRICS                                     # noqa: F401
from .flight import FLIGHT                                       # noqa: F401
from .query_log import QUERY_LOG                                 # noqa: F401
from .stats import ExecStats                                     # noqa: F401
from .profile import DEVICE_MEM                                  # noqa: F401
from .log import get_logger                                      # noqa: F401
