"""Prometheus text-format rendering + the per-worker scrape endpoint.

Counterpart of `horovod_tpu/metrics/exposition.py`.  The endpoint is a
stdlib `http.server` on a daemon thread (started from `hvd.init()` when
HOROVOD_METRICS_PORT is set, alongside the timeline — common/basics.py),
serving:

    /metrics   Prometheus text format 0.0.4
    /healthz   liveness (set_liveness_probe overrides; a probe that
               fails or raises gives 503)

The default /healthz probe reads the worker's heartbeat lease
(`runner.elastic_worker.lease_ttl()` / `heartbeat_age()`), as the JAX
package's does: 200 "ok" while no heartbeat has landed or leases are
off, 200 "ok (heartbeat Xs ago)" within the TTL, 503 past it.

Multi-process launches offset the port by the process index so every
worker on a host gets a distinct endpoint; HOROVOD_METRICS_PORT=0 binds
an ephemeral port (the bound port is logged and returned by
`server_port()`).
"""

from __future__ import annotations

import atexit
import logging
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..common import util
from .registry import MetricsRegistry, get_registry

logger = logging.getLogger("horovod_tpu_torch.metrics")

__all__ = ["render", "start_server", "stop_server", "server_port",
           "init_from_env", "set_liveness_probe"]

#: Pluggable liveness probe behind /healthz: () -> (ok, detail).  None
#: selects the default (_default_liveness).
_liveness_probe = None


def set_liveness_probe(fn) -> None:
    """Override the /healthz probe (tests, embedders); None restores
    the heartbeat-lease default."""
    global _liveness_probe
    _liveness_probe = fn


def _default_liveness():
    """Healthy unless this worker runs heartbeat leases AND its last
    beat is older than the lease TTL — the exact staleness the elastic
    driver would declare the worker dead for, surfaced as 503 so an
    external probe agrees with the control plane without parsing
    Prometheus text."""
    try:
        from ..runner import elastic_worker as _ew
        ttl = _ew.lease_ttl()
        age = _ew.heartbeat_age()
    except Exception:  # noqa: BLE001 — liveness must not 500
        return True, "ok"
    if ttl <= 0 or age is None:
        return True, "ok"  # no lease regime: process up == alive
    if age <= ttl:
        return True, f"ok (heartbeat {age:.1f}s ago)"
    return False, (f"heartbeat stale: {age:.1f}s since last beat "
                   f"(lease ttl {ttl:.1f}s)")


def _liveness():
    probe = _liveness_probe
    if probe is None:
        return _default_liveness()
    # lint: allow-swallow(a broken probe must read as unhealthy, not 500)
    try:
        return probe()
    except Exception as e:  # noqa: BLE001
        return False, f"liveness probe failed: {type(e).__name__}"


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labelstr(names, values, extra=()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render(registry: Optional[MetricsRegistry] = None) -> str:
    """Prometheus exposition text for every metric in the registry."""
    registry = registry or get_registry()
    lines = []
    for m in registry.collect():
        lines.append(f"# HELP {m.name} {_escape(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for values, child in sorted(m.samples()):
            if m.kind == "histogram":
                for bound, cum in child.cumulative():
                    ls = _labelstr(m.labelnames, values,
                                   extra=[("le", _fmt(bound))])
                    lines.append(f"{m.name}_bucket{ls} {cum}")
                ls = _labelstr(m.labelnames, values)
                lines.append(f"{m.name}_sum{ls} {_fmt(child.sum)}")
                lines.append(f"{m.name}_count{ls} {child.count}")
            else:
                ls = _labelstr(m.labelnames, values)
                lines.append(f"{m.name}{ls} {_fmt(child.get())}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — http.server API
        if self.path.split("?")[0] in ("/", "/metrics"):
            body = render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/healthz":
            ok, detail = _liveness()
            body = (detail.rstrip("\n") + "\n").encode()
            self.send_response(200 if ok else 503)
            self.send_header("Content-Type", "text/plain")
        else:
            body = b"not found\n"
            self.send_response(404)
            self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes are not log-worthy
        logger.debug("metrics http: " + fmt, *args)


_server: Optional[ThreadingHTTPServer] = None
_thread: Optional[threading.Thread] = None
_lock = threading.Lock()


def start_server(port: int, addr: str = "0.0.0.0") -> int:
    """Start the scrape endpoint; returns the bound port (idempotent —
    an already-running server keeps its port)."""
    global _server, _thread
    with _lock:
        if _server is not None:
            return _server.server_address[1]
        srv = ThreadingHTTPServer((addr, port), _Handler)
        srv.daemon_threads = True
        t = threading.Thread(target=srv.serve_forever,
                             name="hvd-metrics-http", daemon=True)
        t.start()
        _server, _thread = srv, t
        logger.info("metrics endpoint on %s:%d/metrics",
                    addr, srv.server_address[1])
        return srv.server_address[1]


def stop_server() -> None:
    global _server, _thread
    with _lock:
        srv, t = _server, _thread
        _server = _thread = None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if t is not None:
        t.join(timeout=5)


def server_port() -> Optional[int]:
    with _lock:
        return _server.server_address[1] if _server is not None else None


def init_from_env(process_index: int = 0,
                  num_processes: int = 1) -> Optional[int]:
    """Called by `hvd.init()`: HOROVOD_METRICS_PORT=N starts the endpoint
    on N (+ process index when several workers share a host, so each gets
    its own port; 0 = ephemeral).  Bind failure degrades to a warning —
    telemetry must never take down training."""
    port = util.env_int("METRICS_PORT", -1)
    if port < 0:
        return None
    if port > 0 and num_processes > 1:
        port += process_index
    try:
        return start_server(port)
    except OSError as e:
        logger.warning("cannot bind metrics endpoint on port %d: %s",
                       port, e)
        return None


# The exporter port must be released even when users skip hvd.shutdown()
# (same contract as the timeline's atexit closing bracket).
atexit.register(stop_server)
