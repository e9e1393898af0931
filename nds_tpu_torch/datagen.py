"""NDS data for the port: drives the repository's native generator.

Counterpart of the local path of ``nds_tpu/datagen.py``
(``generate_data_local`` and its CLI's ``local`` mode, with ``--range``,
``--update`` and ``--overwrite``): one generator process per chunk, then
one directory per table. ``--update K`` generates refresh set K, Data
Maintenance's input: the staging tables and the delete-date tables
(``MAINTENANCE_TABLES``) in place of the source tables. Each chunk writes
the three delete-date tuples of the set, so a refresh set generated with
``--parallel 1`` holds three. The generator is the C++ program in
``native/datagen/``; it is compiled with the host C++ compiler into
``nds_tpu_torch/_build/`` at first use (a few seconds), so the port needs
no prebuilt binary. ``setup_tables`` registers the generated tables with a
port Session.

    python -m nds_tpu_torch.datagen local DATA_DIR --scale 1 [--parallel N]
        [--range FIRST,LAST] [--update K] [--overwrite]

Not ported yet: the ``hosts`` mode (ssh fan-out), ROADMAP A.6.5.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

from .schema import get_schemas

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "datagen", "gen.cpp")
_BUILD = os.path.join(_PKG, "_build")

SOURCE_TABLES = sorted(get_schemas()) + ["dbgen_version"]
#: a refresh set's tables, in the generator's order
MAINTENANCE_TABLES = [
    "s_purchase_lineitem", "s_purchase", "s_catalog_order", "s_web_order",
    "s_catalog_order_lineitem", "s_web_order_lineitem", "s_store_returns",
    "s_catalog_returns", "s_web_returns", "s_inventory", "delete",
    "inventory_delete",
]


def build_generator() -> str:
    """Path of the compiled generator, compiling it if it is missing or
    older than its source."""
    out = os.path.join(_BUILD, "ndsdgen")
    if os.path.exists(out) and \
            os.path.getmtime(out) >= os.path.getmtime(_SRC):
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found to build the generator")
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run([cxx, "-O2", "-std=c++17", "-o", tmp, _SRC], check=True,
                   capture_output=True)
    os.replace(tmp, out)
    return out


def check_build() -> str:
    """The native generator, built if needed (the reference's check_build
    looks for its prebuilt binary)."""
    return build_generator()


def valid_range(r: str, parallel: int) -> tuple[int, int]:
    """Parse --range 'first,last' (1-based chunk indexes, reference
    check.py:88-123)."""
    try:
        first, last = (int(x) for x in r.split(","))
    except ValueError:
        raise ValueError(f"bad range {r!r}: expected 'first,last'")
    if not (1 <= first <= last <= parallel):
        raise ValueError(f"range {r!r} outside 1..{parallel}")
    return first, last


def generate(data_dir: str, scale: float, parallel: int,
             chunk_range: tuple[int, int] | None = None,
             overwrite: bool = False, update: int = 0) -> None:
    """Generate every source table at `scale` into data_dir/<table>/, with
    one generator process per chunk (``update`` K > 0: refresh set K's
    tables instead). A whole run needs data_dir empty or missing
    (``overwrite`` replaces it); a ``chunk_range`` run (first, last) adds
    its chunks to a shared data_dir and never wipes it."""
    binary = build_generator()
    first, last = chunk_range if chunk_range else (1, parallel)
    if chunk_range is None:
        if os.path.exists(data_dir) and os.listdir(data_dir):
            if not overwrite:
                raise FileExistsError(
                    f"{data_dir} is not empty; pass overwrite to replace")
            shutil.rmtree(data_dir)
        work = os.path.join(data_dir, "_raw_")
    else:
        # a private work dir: range runs may share data_dir concurrently
        work = os.path.join(data_dir, f"_raw_{first}_{last}_")
    os.makedirs(work, exist_ok=True)
    cmd = [binary, "-scale", str(scale), "-dir", work, "-parallel",
           str(parallel)]
    if update:
        cmd += ["-update", str(update)]
    procs = [(child, subprocess.Popen(cmd + ["-child", str(child)]))
             for child in range(first, last + 1)]
    failed = [c for c, p in procs if p.wait() != 0]
    if failed:
        raise RuntimeError(f"generator chunks failed: {failed}")
    tables = MAINTENANCE_TABLES if update else SOURCE_TABLES
    for table in tables:
        tdir = os.path.join(data_dir, table)
        os.makedirs(tdir, exist_ok=True)
        for child in range(first, last + 1):
            name = f"{table}_{child}_{parallel}.dat" if parallel > 1 \
                else f"{table}.dat"
            src = os.path.join(work, name)
            if os.path.exists(src) and os.path.getsize(src) > 0:
                os.rename(src, os.path.join(tdir, name))
        # a range run legitimately leaves small tables to other ranges
        if chunk_range is None and not os.listdir(tdir):
            raise RuntimeError(f"no output produced for table {table}")
    shutil.rmtree(work, ignore_errors=True)
    if chunk_range is not None and not any(
            os.listdir(os.path.join(data_dir, t)) for t in tables):
        raise RuntimeError(
            f"range {first},{last} produced no output for any table")


def setup_tables(session, data_dir: str, use_decimal: bool = True) -> list:
    """Register every generated source table (pipe-delimited CSV) with a
    port Session; decimal columns load as exact decimals when use_decimal
    (then "decN" scaled int64 under decimal_physical="i64"). Returns the
    registered table names."""
    names = []
    for name, sch in get_schemas(use_decimal).items():
        path = os.path.join(data_dir, name)
        if os.path.exists(path):
            session.register_csv(name, path,
                                 sch.arrow_schema(use_decimal=use_decimal))
            names.append(name)
    return names


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="nds_tpu_torch.datagen",
        description="Generate NDS benchmark data with the native generator")
    p.add_argument("mode", choices=["local", "hosts"],
                   help="local: fork processes; hosts: ssh fan-out (not "
                   "ported)")
    p.add_argument("data_dir")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--parallel", type=int, default=os.cpu_count() or 1)
    p.add_argument("--range", dest="range_", default=None,
                   help="chunk subrange 'first,last' for incremental runs")
    p.add_argument("--update", type=int, default=0,
                   help="generate refresh (maintenance) set K instead")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--hosts", default="",
                   help="comma-separated host list for hosts mode")
    a = p.parse_args(argv)
    if a.mode == "hosts":
        raise NotImplementedError(
            "datagen's hosts mode (ssh fan-out) is not ported yet: "
            "ROADMAP A.6")
    rng = valid_range(a.range_, a.parallel) if a.range_ else None
    generate(a.data_dir, a.scale, a.parallel, rng, overwrite=a.overwrite,
             update=a.update)
    return 0


if __name__ == "__main__":
    sys.exit(main())
