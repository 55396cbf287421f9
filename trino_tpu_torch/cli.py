"""Interactive SQL CLI.

Reference analog: ``client/trino-cli/.../Console.java:82`` — a REPL over
the statement protocol with aligned tabular output.  Two modes: connect
to a running server (``--server``) or embed a LocalQueryRunner over the
built-in catalogs (``--embedded``), which is also how the CLI is tested
without networking.

The JAX engine's ``trino_tpu/cli.py``, copied, with one flag more:
``--device`` (default ``cuda``) picks the embedded runner's torch
device. An embedded runner asked for ``cuda`` on a machine without a GPU
raises; it never runs on the CPU instead.

Usage:
    python -m trino_tpu_torch.cli --embedded --catalog tpch --schema tiny
    python -m trino_tpu_torch.cli --embedded --device cpu -e "select 1"
    python -m trino_tpu_torch.cli --server http://127.0.0.1:8080 \
        -e "select count(*) from tpch.tiny.orders"
"""

from __future__ import annotations

import argparse
import sys


def format_table(names, rows) -> str:
    cells = [[("" if v is None else str(v)) for v in row] for row in rows]
    widths = [len(n) for n in names]
    for row in cells:
        for i, c in enumerate(row):
            widths[i] = max(widths[i], len(c))
    sep = "-+-".join("-" * w for w in widths)
    out = [" | ".join(n.ljust(w) for n, w in zip(names, widths)), sep]
    for row in cells:
        out.append(" | ".join(c.ljust(w) for c, w in zip(row, widths)))
    out.append(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
    return "\n".join(out)


def _embedded_runner(catalog: str, schema: str, device: str = "cuda"):
    from .connectors.catalog import create_catalogs
    from .runner import LocalQueryRunner
    from .sql.analyzer import Session

    catalogs = {"tpch": {"connector": "tpch"},
                "memory": {"connector": "memory"},
                "blackhole": {"connector": "blackhole"}}
    return LocalQueryRunner(create_catalogs(catalogs),
                            Session(catalog=catalog, schema=schema),
                            device=device)


class _ServerBackend:
    def __init__(self, server: str):
        from .client import Client

        self.client = Client(server)

    def run(self, sql: str):
        res = self.client.execute(sql)
        return res.column_names, res.rows


class _EmbeddedBackend:
    def __init__(self, catalog: str, schema: str, device: str):
        self.runner = _embedded_runner(catalog, schema, device)

    def run(self, sql: str):
        res = self.runner.execute(sql)
        return res.column_names, res.rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trino-tpu-torch")
    ap.add_argument("--server", help="coordinator URI")
    ap.add_argument("--embedded", action="store_true",
                    help="in-process engine (no server)")
    ap.add_argument("--catalog", default="tpch")
    ap.add_argument("--schema", default="tiny")
    ap.add_argument("-e", "--execute", help="run one statement and exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the embedded runner")
    args = ap.parse_args(argv)

    if args.server:
        backend = _ServerBackend(args.server)
    else:
        backend = _EmbeddedBackend(args.catalog, args.schema, args.device)

    def run_one(sql: str) -> int:
        sql = sql.strip().rstrip(";")
        if not sql:
            return 0
        try:
            names, rows = backend.run(sql)
        except Exception as e:
            print(f"Query failed: {e}", file=sys.stderr)
            return 1
        print(format_table(names, rows))
        return 0

    if args.execute:
        return run_one(args.execute)

    print("trino-tpu> ", end="", flush=True)
    buf = []
    for line in sys.stdin:
        buf.append(line)
        if line.rstrip().endswith(";") or not line.strip():
            run_one(" ".join(buf))
            buf = []
            print("trino-tpu> ", end="", flush=True)
    if buf:
        run_one(" ".join(buf))
    return 0


if __name__ == "__main__":
    sys.exit(main())
