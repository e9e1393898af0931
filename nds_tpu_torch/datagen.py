"""NDS data for the port: drives the repository's native generator.

Counterpart of the local path of ``nds_tpu/datagen.py``
(``generate_data_local``): one generator process per chunk, then one
directory per table. The generator is the C++ program in
``native/datagen/``; it is compiled with the host C++ compiler into
``nds_tpu_torch/_build/`` at first use (a few seconds), so the port needs
no prebuilt binary. ``setup_tables`` registers the generated tables with a
port Session, as ``nds_tpu/power.py``'s ``setup_tables`` does for CSV.
"""
from __future__ import annotations

import os
import shutil
import subprocess

from .schema import get_schemas

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "datagen", "gen.cpp")
_BUILD = os.path.join(_PKG, "_build")

SOURCE_TABLES = sorted(get_schemas()) + ["dbgen_version"]


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


def generate(data_dir: str, scale: float, parallel: int) -> None:
    """Generate every source table at `scale` into data_dir/<table>/, with
    `parallel` generator processes (data_dir must not exist or be empty)."""
    binary = build_generator()
    if os.path.exists(data_dir) and os.listdir(data_dir):
        raise FileExistsError(f"{data_dir} is not empty")
    work = os.path.join(data_dir, "_raw_")
    os.makedirs(work, exist_ok=True)
    procs = [subprocess.Popen([binary, "-scale", str(scale), "-dir", work,
                               "-parallel", str(parallel), "-child",
                               str(child)])
             for child in range(1, parallel + 1)]
    failed = [i + 1 for i, p in enumerate(procs) if p.wait() != 0]
    if failed:
        raise RuntimeError(f"generator chunks failed: {failed}")
    for table in SOURCE_TABLES:
        tdir = os.path.join(data_dir, table)
        os.makedirs(tdir, exist_ok=True)
        for child in range(1, parallel + 1):
            name = f"{table}_{child}_{parallel}.dat" if parallel > 1 \
                else f"{table}.dat"
            src = os.path.join(work, name)
            if os.path.exists(src) and os.path.getsize(src) > 0:
                os.rename(src, os.path.join(tdir, name))
        if not os.listdir(tdir):
            raise RuntimeError(f"no output produced for table {table}")
    shutil.rmtree(work, ignore_errors=True)


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
