# Ported from nds_tpu/transcode.py: the same CLI, per-table loop, layout and
# report, over the port's warehouse (nds_tpu_torch/warehouse.py).
"""Load Test: transcode raw pipe-delimited data into the Parquet warehouse.

    python -m nds_tpu_torch.transcode INPUT_PREFIX OUTPUT_PREFIX [REPORT_FILE]
        [--update] [--use_decimal] [--tables a,b] [--no_partition]

Capability parity with the reference transcoder (reference
nds/nds_transcode.py): per-table timed load->store loop (transcode
:184-202), explicit-schema CSV reads with '|' delimiter (load :56-65),
partitioned writes for the 7 fact tables and single-file writes for small
dimensions (store :68-151, TABLE_PARTITIONING :45-53), --update mode for
the maintenance staging tables, and a report file carrying the Load Test
Time, per-table times, and the ``RNGSEED used: <MMDDhhmmss f>``
end-timestamp the stream generator seeds from (:204-228).

Every data file's [min, max] and encoding stats land in its table's
manifest at write time (warehouse.py): a session that attaches the
warehouse plans the streamed path's lanes and encodings from them with no
data read. A fact table's files (one a date) are written by a few
processes (``warehouse.FileWriters``). ``--use_decimal`` stores decimals
as decimal128 (exact, the
power run's decimals then bit-identical to the oracle's); without it they
are doubles, as the reference's default.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from datetime import datetime

import pyarrow as pa
import pyarrow.csv as pa_csv

from .schema import get_maintenance_schemas, get_schemas
from .warehouse import FileWriters, Warehouse

# the delete-date tables are inputs to maintenance, not warehouse tables
# (reference nds_transcode.py's "derived" handling): one unpartitioned file
NON_WAREHOUSE = {"delete", "inventory_delete", "dbgen_version"}


def load_csv(path: str, schema: pa.Schema) -> pa.Table:
    files = ([os.path.join(path, f) for f in sorted(os.listdir(path))]
             if os.path.isdir(path) else [path])
    convert = pa_csv.ConvertOptions(
        column_types={f.name: f.type for f in schema},
        null_values=[""], strings_can_be_null=True)
    read = pa_csv.ReadOptions(column_names=[f.name for f in schema])
    parse = pa_csv.ParseOptions(delimiter="|")
    parts = [pa_csv.read_csv(f, read_options=read, parse_options=parse,
                             convert_options=convert)
             for f in files if os.path.getsize(f) > 0]
    return pa.concat_tables(parts)


def transcode(input_prefix: str, output_prefix: str,
              report_file: str | None = None,
              update: bool = False,
              use_decimal: bool = False,
              tables: list[str] | None = None,
              partition: bool = True,
              writers: FileWriters | None = None) -> dict[str, float]:
    """Transcode every table; returns per-table seconds. A large
    partitioned table's files are written by the processes of `writers`
    (a FileWriters of the caller's, or one of its own for this call)."""
    if writers is None:
        with FileWriters() as own:
            return transcode(input_prefix, output_prefix, report_file,
                             update, use_decimal, tables, partition, own)
    schemas = dict(get_maintenance_schemas(use_decimal) if update
                   else get_schemas(use_decimal))
    if tables:
        schemas = {t: schemas[t] for t in tables}
    wh = Warehouse(output_prefix)
    times: dict[str, float] = {}
    for name, sch in schemas.items():
        src = os.path.join(input_prefix, name)
        if not os.path.exists(src):
            continue
        t0 = time.perf_counter()
        table = load_csv(src, sch.arrow_schema(use_decimal=use_decimal))
        wh.table(name).create(
            table, partition=partition and name not in NON_WAREHOUSE,
            writers=writers)
        times[name] = time.perf_counter() - t0
        print(f"Time taken: {times[name]:.3f} s for table {name}",
              flush=True)

    total = sum(times.values())
    end = datetime.now()
    # reference RNGSEED format: strftime("%m%d%H%M%S%f")[:-5]
    rngseed = end.strftime("%m%d%H%M%S%f")[:-5]
    lines = [f"Load Test Time: {total:.3f} seconds"]
    lines += [f"Time taken: {t:.3f} s for table {n}"
              for n, t in times.items()]
    lines.append(f"RNGSEED used: {rngseed}")
    report = "\n".join(lines)
    print(report)
    if report_file:
        os.makedirs(os.path.dirname(report_file) or ".", exist_ok=True)
        with open(report_file, "w") as f:
            f.write(report + "\n")
    return times


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="nds_tpu_torch.transcode")
    p.add_argument("input_prefix")
    p.add_argument("output_prefix")
    p.add_argument("report_file", nargs="?", default=None)
    p.add_argument("--update", action="store_true",
                   help="transcode the maintenance staging tables instead")
    p.add_argument("--use_decimal", action="store_true")
    p.add_argument("--tables", default=None,
                   help="comma-separated subset")
    p.add_argument("--no_partition", action="store_true")
    a = p.parse_args(argv)
    transcode(a.input_prefix, a.output_prefix, a.report_file, a.update,
              a.use_decimal,
              a.tables.split(",") if a.tables else None,
              partition=not a.no_partition)
    return 0


if __name__ == "__main__":
    sys.exit(main())
