"""Merge the ranks' run traces and print the phase breakdown.

Counterpart of the repo's ``tools/trace_report.py``, with its arguments,
output and exit codes, built on the port's own ``utils/telemetry.py``
(``merge_traces``, ``phase_breakdown``, ``format_report``,
``request_breakdown``, ``format_requests``, ``diff_breakdowns``,
``format_diff``), so a trace is read without JAX.  Every traced process
(``BIGDL_TORCH_TRACE=<dir>``) writes ``trace.<rank>.json``; a trace of
either package reads alike.

Usage::

    python -m bigdl_torch.tools.trace_report <trace-dir> [--out merged.json] [--json]
    python -m bigdl_torch.tools.trace_report <trace-dir> --requests [--slowest N]
    python -m bigdl_torch.tools.trace_report <trace-dir-A> --diff <trace-dir-B> [--json]

Exit status: 0 on a report; 2 when a directory holds no trace files; 3
when the breakdown holds no spans, or ``--requests`` finds no request
flows.  The message names the path.
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_breakdown(telemetry, trace_dir):
    """(breakdown, merged) of one trace directory, or (None, None) after
    naming the path when it holds no trace files."""
    try:
        merged = telemetry.merge_traces(trace_dir)
    except FileNotFoundError as e:
        print(f"trace_report: {e}", file=sys.stderr)
        return None, None
    return telemetry.phase_breakdown(merged), merged


def _write_merged(merged, out):
    with open(out, "w") as f:
        json.dump(merged, f)
    print(f"merged trace -> {out}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir",
                    help="dir holding trace.<rank>.json files (any file_io "
                         "scheme: local, memory://, ...)")
    ap.add_argument("--diff", default=None, metavar="TRACE_DIR_B",
                    help="compare TWO runs: trace_dir is the baseline (A), "
                         "this dir the new run (B); prints per-phase B/A "
                         "ratios and counter-track deltas")
    ap.add_argument("--out", default=None, metavar="MERGED_JSON",
                    help="also write the merged single-timeline trace here")
    ap.add_argument("--json", action="store_true",
                    help="print the breakdown as JSON instead of the table")
    ap.add_argument("--requests", action="store_true",
                    help="per-request critical paths from the flow events: "
                         "segment attribution (queue/device/transport/"
                         "failover) p50/p95/p99 + slowest-N hop timelines")
    ap.add_argument("--slowest", type=int, default=5,
                    help="with --requests: how many slowest requests get "
                         "a full hop timeline (default 5)")
    args = ap.parse_args(argv)

    from ..utils import telemetry

    breakdown, merged = _load_breakdown(telemetry, args.trace_dir)
    if breakdown is None:
        return 2

    if args.requests:
        rb = telemetry.request_breakdown(merged, slowest=args.slowest)
        if args.out:
            _write_merged(merged, args.out)
        print(json.dumps(rb) if args.json else telemetry.format_requests(rb))
        if not rb["requests"]:
            print(f"trace_report: {args.trace_dir}: trace holds no "
                  "request flows (run the serving tier with "
                  "BIGDL_TORCH_TRACE armed)", file=sys.stderr)
            return 3
        return 0

    if args.diff:
        breakdown_b, _ = _load_breakdown(telemetry, args.diff)
        if breakdown_b is None:
            return 2
        diff = telemetry.diff_breakdowns(breakdown, breakdown_b)
        if args.json:
            print(json.dumps(diff))
        else:
            print(f"A: {args.trace_dir}\nB: {args.diff}")
            print(telemetry.format_diff(diff))
        for path, which in ((args.trace_dir, breakdown),
                            (args.diff, breakdown_b)):
            if not which["phases"]:
                print(f"trace_report: {path}: trace holds no spans "
                      "(empty breakdown)", file=sys.stderr)
                return 3
        return 0

    if args.out:
        _write_merged(merged, args.out)
    if args.json:
        print(json.dumps(breakdown))
    else:
        print(telemetry.format_report(breakdown, merged))
    if not breakdown["phases"]:
        print(f"trace_report: {args.trace_dir}: trace holds no spans "
              "(empty breakdown)", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
