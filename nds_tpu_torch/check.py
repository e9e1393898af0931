# Copied from nds_tpu/check.py; check_build and valid_range come from the
# port's own datagen.
"""Preflight checks for the benchmark CLIs.

Capability parity with the reference's check module (reference
nds/check.py): python-version gate (:38-44), built-artifact lookup
(check_build, :47-66), path/range validators (:69-123), directory sizing
(:126-134), non-empty json-summary-folder guard (:136-145) and query-subset
validation (:147-152).
"""
from __future__ import annotations

import os
import sys

from .datagen import check_build, valid_range  # noqa: F401  (re-exported)


def check_version(min_version: tuple[int, int] = (3, 9)) -> None:
    """Abort on unsupported interpreters (reference check.py:38-44)."""
    if sys.version_info < min_version:
        raise RuntimeError(
            f"python >= {'.'.join(map(str, min_version))} required, "
            f"found {sys.version.split()[0]}")


def get_abs_path(path: str) -> str:
    """Expand a user path to absolute (reference check.py:69-75)."""
    return os.path.abspath(os.path.expanduser(path))


def get_dir_size(path: str) -> int:
    """Total bytes under a directory tree (reference check.py:126-134)."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            fp = os.path.join(root, f)
            if not os.path.islink(fp):
                total += os.path.getsize(fp)
    return total


def check_json_summary_folder(path: str | None) -> None:
    """Refuse to overwrite an existing non-empty summary folder (reference
    check.py:136-145 — stale summaries would poison downstream reporting)."""
    if not path:
        return
    if os.path.exists(path) and os.listdir(path):
        raise RuntimeError(
            f"json summary folder {path!r} exists and is not empty; "
            "remove it or choose another location")


def check_query_subset_exists(query_dict, sub_queries) -> bool:
    """Every requested sub-query must exist in the stream (reference
    check.py:147-152)."""
    import re

    names = set(query_dict)
    bases = {re.sub(r"_part[12]$", "", k) for k in names}
    for q in sub_queries or []:
        if q not in names and q not in bases:
            raise RuntimeError(f"sub query {q!r} is not in the query stream")
    return True
