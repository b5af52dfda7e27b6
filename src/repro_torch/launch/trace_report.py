"""repro-torch-trace: critical-path summary of an exported span file.

Usage::

    repro-torch-trace TRACE.jsonl [--top N] [--chrome OUT.json]
    PYTHONPATH=src python -m repro_torch.launch.trace_report TRACE.jsonl

Reads spans exported by ``repro_torch.observability.export.export_jsonl``
(e.g. from ``Federation.export_trace`` or ``python -m
repro_torch.launch.distributed_demo --trace-out DIR``), prints the comm /
compute / host-idle breakdown, per-process totals, per-level fit costs,
and the slowest-span table.  ``--chrome`` additionally writes a Chrome
trace-event file for ``chrome://tracing`` / Perfetto.

Exits 1 if the span file is missing, unreadable, or empty, so CI can
gate on a trace actually being produced.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.observability.export import (format_report, read_jsonl,
                                              write_chrome_trace)

PROG = "repro-torch-trace"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog=PROG,
        description="Critical-path summary of an exported trace (JSONL spans)")
    ap.add_argument("spans", help="span file written by export_jsonl")
    ap.add_argument("--top", type=int, default=10,
                    help="rows in the slowest-span table (default 10)")
    ap.add_argument("--chrome", default=None, metavar="OUT.json",
                    help="also write a Chrome trace-event file")
    args = ap.parse_args(argv)

    try:
        spans = read_jsonl(args.spans)
    except OSError as e:
        print(f"{PROG}: cannot read {args.spans}: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"{PROG}: invalid span file {args.spans}: {e}",
              file=sys.stderr)
        return 1
    if not spans:
        print(f"{PROG}: no spans in {args.spans}", file=sys.stderr)
        return 1

    print(format_report(spans, top=args.top))
    if args.chrome:
        write_chrome_trace(spans, args.chrome)
        print(f"\nchrome trace written to {args.chrome} "
              "(open in chrome://tracing or https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
