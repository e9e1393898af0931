# Copied from nds_tpu/streams.py: the template loader and its parameter DSL
# (load_template, instantiate and their helpers), available_templates, the
# stream writer (_permutation, generate_query_streams) and its CLI, and the
# two-statement templates' split (SPECIAL_TEMPLATES, split_special_query),
# verbatim; template_units is the port's own. nds_tpu_torch/templates/ is a
# verbatim copy of nds_tpu/templates/, all 99 templates.
"""Query-template instantiation: ``queryN.tpl`` + a seeded parameter DSL.

    python -m nds_tpu_torch.streams OUTPUT_DIR --rngseed SEED [--streams N]
        [--template K]

writes query_0.sql .. query_{N-1}.sql, the streams a power run
(``nds_tpu_torch.power``) and a throughput run read.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import re
import struct
import sys

TEMPLATE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "templates")

# the four templates whose body holds two independent statements
# (reference nds_gen_query_stream.py:91-103)
SPECIAL_TEMPLATES = (14, 23, 24, 39)

_DEFINE_RE = re.compile(r"^--\s*define\s+\[(\w+)\]\s*=\s*(.+?)\s*$")


def _rng(rngseed: int, template: int, param: str, stream: int) -> int:
    h = hashlib.sha256(
        f"{rngseed}/{template}/{param}/{stream}".encode()).digest()
    return struct.unpack("<Q", h[:8])[0]


def _eval_param(expr: str, r: int):
    """Evaluate a parameter expression with randomness r.

    Supported forms:
      uniform_int(lo, hi)        inclusive integer
      choice('a', 'b', ...)      uniform pick
      choice_n(k, 'a', ...)      k distinct picks, comma-joined as quoted list
      dist_month()               1..12
    """
    m = re.match(r"^uniform_int\((-?\d+),\s*(-?\d+)\)$", expr)
    if m:
        lo, hi = int(m.group(1)), int(m.group(2))
        return str(lo + r % (hi - lo + 1))
    m = re.match(r"^choice\((.+)\)$", expr)
    if m:
        opts = _split_args(m.group(1))
        return _unquote(opts[r % len(opts)])
    m = re.match(r"^choice_n\((\d+),\s*(.+)\)$", expr)
    if m:
        k = int(m.group(1))
        opts = _split_args(m.group(2))
        picked = []
        rr = r
        pool = list(opts)
        for _ in range(min(k, len(pool))):
            picked.append(pool.pop(rr % len(pool)))
            rr = (rr * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        return ", ".join(picked)
    m = re.match(r"^dist_month\(\)$", expr)
    if m:
        return str(1 + r % 12)
    m = re.match(r"^ziplist\((\d+)\)$", expr)
    if m:
        # k distinct 5-digit zips, quoted + comma-joined (q8-style IN list).
        # Uniform over 0..99999 deliberately: the native generator draws
        # *_zip as `r % 100000` over a mixed hash (native/datagen/gen.cpp,
        # `ends_with(n, "_zip")` branch), so uniform sampling here matches
        # the data's actual zip distribution (dsqgen samples from dsdgen's
        # skewed distribution for the same reason).
        k = int(m.group(1))
        rr, seen = r, []
        while len(seen) < k:
            z = f"'{rr % 100000:05d}'"
            if z not in seen:
                seen.append(z)
            rr = (rr * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        return ", ".join(seen)
    m = re.match(r"^rand_date\((\d+),\s*(\d+)\)$", expr)
    if m:
        # uniform date within [y_lo, y_hi], day 1..28 (dsqgen date params)
        y_lo, y_hi = int(m.group(1)), int(m.group(2))
        y = y_lo + r % (y_hi - y_lo + 1)
        mo = 1 + (r >> 8) % 12
        d = 1 + (r >> 16) % 28
        return f"{y:04d}-{mo:02d}-{d:02d}"
    raise ValueError(f"unsupported parameter expression: {expr!r}")


def _split_args(s: str) -> list[str]:
    out, depth, cur, in_q = [], 0, "", False
    for ch in s:
        if ch == "'" and depth == 0:
            in_q = not in_q
            cur += ch
        elif ch == "," and depth == 0 and not in_q:
            out.append(cur.strip())
            cur = ""
        else:
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


def _unquote(s: str) -> str:
    return s[1:-1] if len(s) >= 2 and s[0] == "'" and s[-1] == "'" else s


def load_template(number: int, template_dir: str = TEMPLATE_DIR
                  ) -> tuple[dict[str, str], str]:
    """Read queryN.tpl -> (param defs, body)."""
    path = os.path.join(template_dir, f"query{number}.tpl")
    defs: dict[str, str] = {}
    body_lines: list[str] = []
    with open(path) as f:
        for line in f:
            m = _DEFINE_RE.match(line.strip())
            if m:
                defs[m.group(1)] = m.group(2)
            else:
                body_lines.append(line.rstrip("\n"))
    return defs, "\n".join(body_lines).strip()


def instantiate(number: int, stream: int, rngseed: int,
                template_dir: str = TEMPLATE_DIR) -> str:
    defs, body = load_template(number, template_dir)
    for name, expr in defs.items():
        value = _eval_param(expr, _rng(rngseed, number, name, stream))
        body = body.replace(f"[{name}]", str(value))
    leftover = re.search(r"\[([A-Z_]+)\]", body)
    if leftover:
        raise ValueError(
            f"query{number}.tpl: unbound parameter [{leftover.group(1)}]")
    return body


def available_templates(template_dir: str = TEMPLATE_DIR) -> list[int]:
    out = []
    for f in os.listdir(template_dir):
        m = re.match(r"^query(\d+)\.tpl$", f)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _permutation(numbers: list[int], stream: int, rngseed: int) -> list[int]:
    """Deterministic per-stream ordering; stream 0 runs in template order
    (the reference gets permutations from dsqgen's internal tables)."""
    if stream == 0:
        return list(numbers)
    order = list(numbers)
    r = _rng(rngseed, 0, "permutation", stream)
    for i in range(len(order) - 1, 0, -1):
        r = (r * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        j = r % (i + 1)
        order[i], order[j] = order[j], order[i]
    return order


def generate_query_streams(output_dir: str, streams: int, rngseed: int,
                           template_dir: str = TEMPLATE_DIR,
                           template: int | None = None) -> list[str]:
    """Write query_0.sql .. query_{streams-1}.sql (or a single template's
    instantiations when ``template`` is given, mirroring dsqgen -template)."""
    os.makedirs(output_dir, exist_ok=True)
    numbers = [template] if template else available_templates(template_dir)
    paths = []
    for s in range(streams):
        path = os.path.join(output_dir, f"query_{s}.sql")
        with open(path, "w") as f:
            for n in _permutation(numbers, s, rngseed):
                sql = instantiate(n, s, rngseed, template_dir)
                f.write(f"-- start query {n} using template query{n}.tpl\n")
                f.write(sql.rstrip().rstrip(";") + ";\n\n")
        paths.append(path)
    return paths


def split_special_query(query_name: str, sql: str) -> list[tuple[str, str]]:
    """Split a two-statement special query into _part1/_part2 units."""
    stmts = [s.strip() for s in sql.split(";") if s.strip()]
    if len(stmts) <= 1:
        return [(query_name, sql)]
    return [(f"{query_name}_part{i + 1}", stmt)
            for i, stmt in enumerate(stmts)]


def template_units(stream: int, rngseed: int,
                   template_dir: str = TEMPLATE_DIR) -> list[tuple[str, str]]:
    """Every runnable unit of a stream's templates, in template order, as
    (name, sql): one per template, two for each of SPECIAL_TEMPLATES."""
    units = []
    for number in available_templates(template_dir):
        sql = instantiate(number, stream, rngseed, template_dir)
        units += split_special_query(f"query{number}", sql) \
            if number in SPECIAL_TEMPLATES else [(f"query{number}", sql)]
    return units


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="nds_tpu_torch.streams")
    p.add_argument("output_dir")
    p.add_argument("--streams", type=int, default=1)
    p.add_argument("--rngseed", type=int, required=True,
                   help="seed (the bench uses the load-test end timestamp)")
    p.add_argument("--template", type=int, default=None)
    p.add_argument("--template_dir", default=TEMPLATE_DIR)
    a = p.parse_args(argv)
    paths = generate_query_streams(a.output_dir, a.streams, a.rngseed,
                                   a.template_dir, a.template)
    print("\n".join(paths))
    return 0


if __name__ == "__main__":
    sys.exit(main())
