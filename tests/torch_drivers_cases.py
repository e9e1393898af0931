"""Shared inputs of the port's driver tests (tests/test_torch_drivers*.py).

SF0.001 NDS data from the port's generator, as pipe-delimited CSV
directories and as plain per-table Parquet directories (decimals as
decimal128), the query streams of the port's ``streams``, and a property
file that puts a session on the CPU. Imports neither jax nor nds_tpu, so
the card-only file may use it too.
"""
import os

import pyarrow as pa
import pyarrow.csv as pa_csv
import pyarrow.parquet as pq

from nds_tpu_torch import datagen, streams
from nds_tpu_torch.engine import arrow_bridge
from nds_tpu_torch.schema import get_schemas

#: tests/test_e2e_power.py's SUBSET and stream seed
SUBSET = ["query1", "query3", "query42", "query96"]
RNGSEED = 777


def make_data(root: str, scale: float = 0.001) -> dict:
    """Generate the data and three streams under `root`; returns the
    paths: csv, parquet, streams (the stream directory) and cpu (a
    property file with nds.tpu.device=cpu)."""
    csv_dir = os.path.join(root, "csv")
    datagen.generate(csv_dir, scale, parallel=2)
    pq_dir = os.path.join(root, "parquet")
    for name, sch in get_schemas().items():
        schema = sch.arrow_schema(use_decimal=True)
        tdir = os.path.join(csv_dir, name)
        parts = [pa_csv.read_csv(
            os.path.join(tdir, f),
            read_options=pa_csv.ReadOptions(column_names=schema.names),
            parse_options=pa_csv.ParseOptions(delimiter="|"),
            convert_options=pa_csv.ConvertOptions(
                column_types={f.name: f.type for f in schema},
                null_values=[""], strings_can_be_null=True))
            for f in sorted(os.listdir(tdir))
            if os.path.getsize(os.path.join(tdir, f)) > 0]
        os.makedirs(os.path.join(pq_dir, name))
        for i, part in enumerate(parts):
            pq.write_table(part, os.path.join(pq_dir, name,
                                              f"part-{i}.parquet"))
    stream_dir = os.path.join(root, "streams")
    streams.generate_query_streams(stream_dir, 3, RNGSEED)
    return {"csv": csv_dir, "parquet": pq_dir, "streams": stream_dir,
            "cpu": property_file(root, "cpu", device="cpu")}


def property_file(root: str, name: str, **props) -> str:
    """A property file of nds.tpu.<key>=<value> lines under `root`."""
    path = os.path.join(root, f"{name}.properties")
    with open(path, "w") as f:
        for k, v in props.items():
            f.write(f"nds.tpu.{k}={v}\n")
    return path


def stream(paths: dict, i: int = 0) -> str:
    return os.path.join(paths["streams"], f"query_{i}.sql")


def output_table(prefix: str, name: str):
    """A query's Parquet output as a port Table (decimals exact)."""
    return arrow_bridge.from_arrow(
        pq.read_table(os.path.join(prefix, name, "part-0.parquet")), True)


def log_rows(time_log: str) -> list:
    import csv
    with open(time_log) as f:
        return [r for r in csv.reader(f) if r]


def file_faults(got, want) -> list:
    """Differences between two Arrow tables (warehouse data files) as
    multisets of rows: the same schema, integers, decimals and strings
    equal, floats to rtol 1e-9 (both sorted by their non-float columns,
    then their floats)."""
    import numpy as np

    if got.schema != want.schema:
        return [f"schema {got.schema} != {want.schema}"]
    if got.num_rows != want.num_rows:
        return [f"rows {got.num_rows} != {want.num_rows}"]
    floats = [f.name for f in want.schema if pa.types.is_floating(f.type)]
    keys = [(n, "ascending") for n in want.column_names
            if n not in floats] + [(n, "ascending") for n in floats]
    a, b = got.sort_by(keys), want.sort_by(keys)
    out = []
    for name in want.column_names:
        x, y = a.column(name), b.column(name)
        if name not in floats:
            same = x.equals(y)
        else:
            valid = np.asarray(x.is_valid())
            xs = np.asarray(x.fill_null(0.0), dtype=np.float64)
            ys = np.asarray(y.fill_null(0.0), dtype=np.float64)
            same = np.array_equal(valid, np.asarray(y.is_valid())) and \
                bool(np.allclose(xs, ys, rtol=1e-9, atol=0.0,
                                 equal_nan=True))
        if not same:
            out.append(f"{name}: values differ")
    return out
