"""A no-op span tracer: the copied planner wraps each rewrite pass in
``TRACER.span(...)``; the port records no trace."""
from __future__ import annotations

import contextlib


class _NullTracer:
    def span(self, name: str, **attrs):
        return contextlib.nullcontext()


TRACER = _NullTracer()
