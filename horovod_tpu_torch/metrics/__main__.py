"""`python -m horovod_tpu_torch.metrics` — merged fleet view.

Counterpart of `horovod_tpu/metrics/__main__.py`.  Reads every rank's
snapshot from the rendezvous KV (the default; uses the same
HOROVOD_RENDEZVOUS_{ADDR,PORT}/HOROVOD_SECRET_KEY env the launched
workers get) or scrapes worker HTTP endpoints directly, and prints one
merged cluster view: per-rank step skew, aggregate collective
throughput, the trace attribution gauges.

    python -m horovod_tpu_torch.metrics                 # env-configured KV
    python -m horovod_tpu_torch.metrics --kv host:port --secret s3cr3t
    python -m horovod_tpu_torch.metrics --scrape host1:9090 --scrape host2:9091
    python -m horovod_tpu_torch.metrics --raw           # JSON snapshots
    python -m horovod_tpu_torch.metrics top --scrape host1:9090
    python -m horovod_tpu_torch.metrics top --once --scrape host1:9090

A job started without the launcher publishes on its process group's
c10d store instead: `fleet.read_fleet(basics.kv_store())` reads it
inside the job.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.request

from .fleet import read_fleet, render_fleet


def _kv_client(addr_port: str, secret: str):
    from ..runner.rendezvous import RendezvousClient

    addr, _, port = addr_port.rpartition(":")
    return RendezvousClient(addr or "127.0.0.1", int(port), secret)


def _parse_prometheus(text: str, rank: int) -> dict:
    """Minimal exposition-format parser → snapshot dict (HTTP scrape
    path; only what aggregate()/render_fleet() consume)."""
    import re
    import time

    metrics: dict = {}
    types: dict = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind
            continue
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)$", line)
        if not m:
            continue
        name, labelstr, value = m.group(1), m.group(2) or "", m.group(3)
        labels = dict(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', labelstr))
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        kind = types.get(base) or types.get(name, "counter")
        if kind == "histogram":
            ent = metrics.setdefault(base, {
                "kind": "histogram",
                "labelnames": [k for k in labels if k != "le"],
                "_acc": {}})
            key = tuple(v for k, v in sorted(labels.items()) if k != "le")
            acc = ent["_acc"].setdefault(
                key, {"sum": 0.0, "count": 0, "buckets": [], "inf": 0})
            if name.endswith("_bucket"):
                le = labels.get("le", "+Inf")
                if le == "+Inf":
                    acc["inf"] = int(float(value))
                else:
                    acc["buckets"].append([float(le), int(float(value))])
            elif name.endswith("_sum"):
                acc["sum"] = float(value)
            elif name.endswith("_count"):
                acc["count"] = int(float(value))
        else:
            ent = metrics.setdefault(name, {
                "kind": kind, "labelnames": sorted(labels), "samples": []})
            ent["samples"].append(
                [[labels[k] for k in sorted(labels)], float(value)])
    for ent in metrics.values():
        if ent["kind"] == "histogram":
            ent["samples"] = [[list(k), v] for k, v in
                              ent.pop("_acc").items()]
    return {"rank": rank, "ts": time.time(), "metrics": metrics}


def _scrape(endpoints) -> list:
    snaps = []
    for i, ep in enumerate(endpoints):
        url = ep if ep.startswith("http") else f"http://{ep}/metrics"
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                snaps.append(_parse_prometheus(
                    resp.read().decode(), rank=i))
        except OSError as e:
            print(f"warning: cannot scrape {url}: {e}", file=sys.stderr)
    return snaps


def _add_source_args(ap) -> None:
    ap.add_argument("--kv", metavar="ADDR:PORT",
                    help="rendezvous KV address (default: "
                         "HOROVOD_RENDEZVOUS_ADDR/PORT env)")
    ap.add_argument("--secret",
                    help="rendezvous secret (default: HOROVOD_SECRET_KEY)")
    ap.add_argument("--scrape", action="append", default=[],
                    metavar="HOST:PORT",
                    help="scrape worker HTTP endpoints instead of the KV "
                         "(repeatable)")


def _make_fetch(ap, args):
    """Zero-arg snapshot poller from the parsed source options (shared
    by the one-shot view and the `top` console)."""
    if args.scrape:
        endpoints = list(args.scrape)
        return lambda: _scrape(endpoints)
    addr_port = args.kv
    if not addr_port:
        addr = os.environ.get("HOROVOD_RENDEZVOUS_ADDR")
        port = os.environ.get("HOROVOD_RENDEZVOUS_PORT")
        if not addr or not port:
            ap.error("no --kv/--scrape and no HOROVOD_RENDEZVOUS_ADDR/"
                     "PORT in the environment")
        addr_port = f"{addr}:{port}"
    secret = args.secret or os.environ.get("HOROVOD_SECRET_KEY")
    if not secret:
        ap.error("no --secret and no HOROVOD_SECRET_KEY in the "
                 "environment")
    client = _kv_client(addr_port, secret)
    return lambda: read_fleet(client)


def _main_top(argv) -> int:
    from .top import run_top

    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.metrics top",
        description="Live fleet console (KV or HTTP scrape).")
    _add_source_args(ap)
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh interval in seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="print a single frame and exit (tests/CI)")
    ap.add_argument("--color", action="store_true",
                    help="force ANSI colors even off a tty")
    args = ap.parse_args(argv)
    fetch = _make_fetch(ap, args)
    return run_top(fetch, interval=args.interval, once=args.once,
                   color=True if args.color else None)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "top":
        return _main_top(argv[1:])

    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.metrics",
        description="Merged cluster metrics view (KV or HTTP scrape).")
    _add_source_args(ap)
    ap.add_argument("--raw", action="store_true",
                    help="print raw JSON snapshots instead of the view")
    args = ap.parse_args(argv)
    snaps = _make_fetch(ap, args)()

    if args.raw:
        print(json.dumps(snaps, indent=2, sort_keys=True))
    else:
        print(render_fleet(snaps), end="")
    return 0 if snaps else 1


if __name__ == "__main__":
    sys.exit(main())
