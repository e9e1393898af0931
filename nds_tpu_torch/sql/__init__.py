# Copied from nds_tpu/sql/__init__.py; only import paths changed.
"""SQL frontend: lexer, parser, AST, and logical planner for the NDS dialect.

The dialect is the Spark-SQL subset that TPC-DS query streams and the
LF_*/DF_* maintenance functions use (reference templates.patch rewrites the
stock templates into exactly this dialect: `interval N days` arithmetic and
backtick-quoted identifiers; see reference nds/README.md:246-250).
"""
from .parser import SqlParseError, parse_sql, parse_statements

__all__ = ["SqlParseError", "parse_sql", "parse_statements"]
