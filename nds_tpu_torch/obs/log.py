# Copied from nds_tpu/obs/log.py; one word of the docstring changed.
"""Engine diagnostics logging: one ``logging``-based channel with a
verbosity flag, replacing the raw ``sys.stderr`` writes the runners grew.

Levels map to a single integer verbosity so runners expose one knob
(``NDS_TPU_VERBOSITY`` / ``--quiet`` / ``-v``):

    0 -> WARNING  (silent except problems)
    1 -> INFO     (per-query diagnostic lines; the previous behavior)
    2 -> DEBUG    (span/metric chatter)

Everything goes to **stderr**: runner stdout is a machine contract (the
bench harness parses the single JSON line; power's CSV scrapes are files),
so diagnostics must never interleave with it.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_ROOT = "nds_tpu"
_LEVELS = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG}
_configured = False


def configure(verbosity: Optional[int] = None, stream=None, force: bool = False
              ) -> logging.Logger:
    """Idempotently install the stderr handler on the ``nds_tpu`` logger.

    verbosity None reads ``NDS_TPU_VERBOSITY`` (default 1: the per-query
    diagnostic lines the runners always printed keep appearing)."""
    global _configured
    root = logging.getLogger(_ROOT)
    if verbosity is None:
        try:
            verbosity = int(os.environ.get("NDS_TPU_VERBOSITY", "1"))
        except ValueError:
            verbosity = 1
    if force or not _configured:
        for h in list(root.handlers):
            root.removeHandler(h)
        handler = logging.StreamHandler(stream or sys.stderr)
        # message-only: these lines replace bare stderr writes, and scrapers
        # of old runner output must keep matching
        handler.setFormatter(logging.Formatter("%(message)s"))
        root.addHandler(handler)
        root.propagate = False
        _configured = True
    root.setLevel(_LEVELS.get(max(0, min(2, verbosity)), logging.INFO))
    return root


def get_logger(name: str = "") -> logging.Logger:
    """Child logger under the configured ``nds_tpu`` channel."""
    configure()
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
