"""`python -m horovod_tpu_torch.trace` — merge / analyze rank timelines.

Counterpart of `horovod_tpu/trace/__main__.py`.

    # one Perfetto-compatible fleet trace with cross-rank flow events
    python -m horovod_tpu_torch.trace merge train.json train.rank1.json \
        -o fleet_trace.json

    # per-step critical path + straggler attribution (JSON report)
    python -m horovod_tpu_torch.trace analyze train.json train.rank*.json

    # per-REQUEST latency decomposition from serve lifecycle spans
    python -m horovod_tpu_torch.trace analyze --serve serve.json.rank*

    # render a crash/breach flight-recorder dump to Perfetto
    python -m horovod_tpu_torch.trace flightrec serve_flightrec.replica1.123.json

Inputs are the per-rank HOROVOD_TIMELINE files from a run with
HOROVOD_TIMELINE_ALL_RANKS=1 and HOROVOD_TIMELINE_MARK_CYCLES=1 (the
CYCLE_n barrier instants are what the ranks are clock-aligned on).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import core


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.trace",
        description="Cross-rank fleet trace merge + attribution.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    mp = sub.add_parser("merge",
                        help="join rank timelines into one Perfetto trace")
    mp.add_argument("files", nargs="+", metavar="RANK_TIMELINE")
    mp.add_argument("-o", "--out", default="fleet_trace.json")
    mp.add_argument("--align", choices=("cycle", "wall"), default=None,
                    help="clock alignment (default: HOROVOD_TRACE_ALIGN "
                         "or 'cycle')")
    mp.add_argument("--no-flow", action="store_true",
                    help="skip cross-rank flow events")

    anp = sub.add_parser("analyze",
                         help="per-step critical path + straggler "
                              "attribution")
    anp.add_argument("files", nargs="+", metavar="RANK_TIMELINE")
    anp.add_argument("-o", "--out", default=None,
                     help="also write the JSON report here")
    anp.add_argument("--align", choices=("cycle", "wall"), default=None)
    anp.add_argument("--serve", action="store_true",
                     help="per-REQUEST latency decomposition from the "
                          "serve lifecycle spans (queue/prefill/decode/"
                          "spec-verify) instead of per-step attribution")

    fp = sub.add_parser("flightrec",
                        help="render a flight-recorder dump "
                             "(serve_flightrec.*.json) to Perfetto")
    fp.add_argument("dump", metavar="FLIGHTREC_DUMP")
    fp.add_argument("-o", "--out", default="flightrec_trace.json")

    args = ap.parse_args(argv)
    if args.cmd == "merge":
        merged = core.merge(args.files, align=args.align,
                            flow=(False if args.no_flow else None))
        core.write_merged(merged, args.out)
        md = merged["metadata"]
        print(f"wrote {args.out}: {len(merged['traceEvents'])} events, "
              f"ranks {md['ranks']}, {md['flow_events']} flow events, "
              f"align={md['align']}")
        return 0
    if args.cmd == "flightrec":
        trace = core.flightrec_to_trace(args.dump)
        core.write_merged(trace, args.out)
        md = trace["metadata"]
        print(f"wrote {args.out}: {len(trace['traceEvents'])} events, "
              f"reason={md['reason']}, replica={md['replica']}, "
              f"dropped={md['dropped']}")
        return 0
    if args.serve:
        report = core.analyze_serve(args.files, align=args.align)
    else:
        report = core.analyze(args.files, align=args.align)
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
