"""Fleet aggregation: per-rank snapshots over a key-value store.

Counterpart of `horovod_tpu/metrics/fleet.py`.  Channel: under the
launcher (HOROVOD_RENDEZVOUS_ADDR set), the rendezvous KV through
`runner.elastic_worker.client_from_env()`, as in the JAX package;
otherwise the c10d store `hvd.init` builds on the coordinator, under the
generation's prefix (the one `KvRankReporter` uses for the stall
heartbeats, utils/stall_inspector.py).  Each worker's watchdog publishes

    metrics/rank/{rank} = JSON snapshot()

and any reader (a rank, or `python -m horovod_tpu_torch.metrics --kv`)
reads them back (`read_fleet`) and merges them into one cluster view:
counters and histograms sum across ranks, gauges stay per-rank
(min/max/mean in the merged rendering).  `_Store` gives both stores one
face: a c10d store has no key listing and its `get` blocks on a missing
key, so there each rank's key is probed with `check` first.  The data
plane never touches the store — snapshots are small (one JSON object
per rank) and published at watchdog cadence, not step cadence.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Dict, List, Optional

from .registry import MetricsRegistry, get_registry

logger = logging.getLogger("horovod_tpu_torch.metrics")

KV_PREFIX = "metrics/rank/"

__all__ = ["snapshot", "publish", "read_fleet", "aggregate",
           "render_fleet", "fleet_store", "maybe_start_kv_publisher",
           "stop_kv_publisher", "KV_PREFIX"]


def snapshot(registry: Optional[MetricsRegistry] = None,
             rank: Optional[int] = None) -> dict:
    """JSON-able dump of every metric series in the registry."""
    registry = registry or get_registry()
    if rank is None:
        try:
            from ..common import basics
            rank = basics.rank() if basics.is_initialized() else 0
        except Exception:  # noqa: BLE001 — snapshots are best-effort
            rank = 0
    metrics: Dict[str, dict] = {}
    for m in registry.collect():
        samples = []
        for values, child in m.samples():
            if m.kind == "histogram":
                samples.append([list(values), {
                    "sum": child.sum, "count": child.count,
                    "buckets": [[b, c] for b, c in child.cumulative()
                                if b != float("inf")],
                    "inf": child.cumulative()[-1][1],
                }])
            else:
                samples.append([list(values), child.get()])
        metrics[m.name] = {"kind": m.kind, "labelnames": list(m.labelnames),
                           "samples": samples}
    return {"rank": rank, "ts": time.time(), "metrics": metrics}


class _Store:
    """One face over either store: the rendezvous client (`put`,
    `get` -> str or None, `keys`) or a c10d store (`set`, `check`,
    `get` -> bytes, no listing)."""

    def __init__(self, client):
        self._c = client
        self._c10d = not hasattr(client, "keys")

    def put(self, key: str, value: str) -> None:
        if self._c10d:
            self._c.set(key, value)
        else:
            self._c.put(key, value)

    def get(self, key: str) -> Optional[str]:
        if not self._c10d:
            return self._c.get(key)
        if not self._c.check([key]):
            return None
        return self._c.get(key).decode()

    def rank_keys(self, size: Optional[int]) -> List[str]:
        """The snapshot keys to read: the KV lists them; a c10d store is
        probed for ranks 0..size-1 (default: the world size)."""
        if not self._c10d and size is None:
            return self._c.keys(KV_PREFIX)
        if size is None:
            from ..common import basics
            size = basics.size()
        return [f"{KV_PREFIX}{r}" for r in range(size)]


def fleet_store(store=None):
    """Where this process's snapshots go: the rendezvous KV under the
    launcher (HOROVOD_RENDEZVOUS_ADDR set), else `store` (the process
    group's c10d store, or None for a one-rank job).  Best-effort, as
    in the JAX package: a launcher env without a usable port or secret
    gives None (nothing is published), never an error."""
    import os

    if "HOROVOD_RENDEZVOUS_ADDR" in os.environ:
        try:
            from ..runner.elastic_worker import client_from_env
            return client_from_env()
        except Exception:  # noqa: BLE001
            logger.debug("rendezvous KV unavailable for the fleet",
                         exc_info=True)
            return None
    return store


def publish(client, rank: Optional[int] = None) -> None:
    """Publish this process's snapshot to the store (called from the
    stall inspector's watchdog thread; never raises — the store may be
    gone at shutdown, the KV mid-restart)."""
    try:
        snap = snapshot(rank=rank)
        _Store(client).put(f"{KV_PREFIX}{snap['rank']}",
                           json.dumps(snap, separators=(",", ":")))
    except Exception:  # noqa: BLE001
        logger.debug("metrics KV publish failed", exc_info=True)


def read_fleet(client, size: Optional[int] = None) -> List[dict]:
    """Every rank's latest snapshot from the store, sorted by rank.  On
    a c10d store `size` (default: the world size) bounds the ranks
    probed; the rendezvous KV lists its keys.  A rank that has not
    published yet is left out."""
    store = _Store(client)
    snaps = []
    for key in store.rank_keys(size):
        raw = store.get(key)
        if raw is None:
            continue
        try:
            snaps.append(json.loads(raw))
        except (ValueError, TypeError):
            logger.warning("unparseable metrics snapshot at %s", key)
    return sorted(snaps, key=lambda s: s.get("rank", 0))


# ---------------------------------------------------------------------------
# Merging
# ---------------------------------------------------------------------------

def aggregate(snaps: List[dict]) -> dict:
    """Merge per-rank snapshots: counters/histograms sum, gauges keep
    per-rank values.  Returns {name: {kind, labelnames, samples}} where a
    counter/histogram sample is keyed by label values and a gauge sample
    carries {rank: value}."""
    out: Dict[str, dict] = {}
    for snap in snaps:
        rank = snap.get("rank", 0)
        for name, m in snap.get("metrics", {}).items():
            agg = out.setdefault(name, {
                "kind": m["kind"], "labelnames": m["labelnames"],
                "samples": {}})
            for values, val in m["samples"]:
                key = tuple(values)
                if m["kind"] == "counter":
                    agg["samples"][key] = agg["samples"].get(key, 0.0) + val
                elif m["kind"] == "gauge":
                    agg["samples"].setdefault(key, {})[rank] = val
                else:  # histogram
                    cur = agg["samples"].get(key)
                    if cur is None:
                        agg["samples"][key] = {
                            "sum": val["sum"], "count": val["count"],
                            "buckets": {b: c for b, c in val["buckets"]},
                            "inf": val.get("inf", val["count"])}
                    else:
                        cur["sum"] += val["sum"]
                        cur["count"] += val["count"]
                        cur["inf"] += val.get("inf", val["count"])
                        for b, c in val["buckets"]:
                            cur["buckets"][b] = cur["buckets"].get(b, 0) + c
    return out


def _counter_total(agg: dict, name: str) -> float:
    m = agg.get(name)
    return sum(m["samples"].values()) if m else 0.0


def _per_rank_counter(snaps: List[dict], name: str) -> Dict[int, float]:
    out: Dict[int, float] = {}
    for snap in snaps:
        m = snap.get("metrics", {}).get(name)
        if m:
            out[snap.get("rank", 0)] = sum(v for _, v in m["samples"])
    return out


def render_fleet(snaps: List[dict]) -> str:
    """Human-readable merged cluster view (the CLI's output)."""
    if not snaps:
        return "no metrics snapshots found (is any worker publishing?)\n"
    agg = aggregate(snaps)
    now = time.time()
    lines = [f"fleet view: {len(snaps)} rank(s)", ""]

    # Per-rank step progress + skew (the stall inspector's laggard story,
    # but continuous instead of event-driven).
    steps = _per_rank_counter(snaps, "hvd_steps_total")
    lines.append("rank  steps  snapshot_age_s")
    for snap in snaps:
        r = snap.get("rank", 0)
        age = now - float(snap.get("ts", now))
        lines.append(f"{r:>4}  {int(steps.get(r, 0)):>5}  {age:>13.1f}")
    if steps:
        lines.append(f"step skew (max-min): "
                     f"{int(max(steps.values()) - min(steps.values()))}")
    lines.append("")

    # Aggregate collective throughput.
    calls = _counter_total(agg, "hvd_collective_calls_total")
    nbytes = _counter_total(agg, "hvd_collective_bytes_total")
    lat = agg.get("hvd_collective_latency_seconds")
    lat_sum = (sum(s["sum"] for s in lat["samples"].values()) if lat else 0.0)
    lines.append(f"collective calls: {int(calls)}   "
                 f"bytes: {int(nbytes)}")
    if lat_sum > 0:
        lines.append(f"aggregate dispatch throughput: "
                     f"{nbytes / lat_sum / 1e6:.1f} MB/s "
                     f"(total dispatch time {lat_sum:.3f}s)")

    # Compile-cache hit rate (the response-cache fast-path analog).
    hits = _counter_total(agg, "hvd_compile_cache_hits_total")
    misses = _counter_total(agg, "hvd_compile_cache_misses_total")
    if hits + misses > 0:
        lines.append(f"compile cache: {int(hits)} hits / "
                     f"{int(misses)} misses "
                     f"({100.0 * hits / (hits + misses):.1f}% hit rate)")

    # Elastic / stall events, if any rank reported them.
    for name, label in (("hvd_elastic_restarts_total", "elastic restarts"),
                        ("hvd_stall_warnings_total", "stall warnings"),
                        ("hvd_stall_aborts_total", "stall aborts")):
        total = _counter_total(agg, name)
        if total:
            lines.append(f"{label}: {int(total)}")

    # Trace attribution (the fleet tracer, trace/): per-rank step
    # critical path is live; skew/straggler appear once trace analysis
    # has published them on any rank.
    def _gauge_by_rank(name, keep_zero=False):
        m = agg.get(name)
        if not m or m["kind"] != "gauge":
            return {}
        per = m["samples"].get((), {})
        return {r: v for r, v in per.items() if keep_zero or v}
    cp = _gauge_by_rank("hvd_critical_path_ms")
    skew = _gauge_by_rank("hvd_step_skew_ms")
    laggards = _gauge_by_rank("hvd_stall_laggards")
    if cp or skew:
        lines.append("")
        if cp:
            lines.append("step critical path (ms): " + "  ".join(
                f"rank{r}={v:.1f}" for r, v in sorted(cp.items())))
        if skew:
            lines.append("step barrier skew (ms): " + "  ".join(
                f"rank{r}={v:.1f}" for r, v in sorted(skew.items())))
            strag = _gauge_by_rank("hvd_straggler_rank", keep_zero=True)
            for r, v in sorted(strag.items()):
                # Only meaningful on ranks whose analysis set the skew
                # gauge too (the default 0 would read as "rank 0").
                if r in skew and v >= 0:
                    lines.append(f"blamed straggler (rank {r}'s "
                                 f"analysis): rank {int(v)}")
    if laggards:
        lines.append("stall laggards (last warning): " + "  ".join(
            f"rank{r}={int(v)}" for r, v in sorted(laggards.items())))
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Standalone publisher (workers whose stall inspector is disabled — the
# watchdog normally owns publishing; this thread is the fallback so the
# fleet view stays complete either way).
# ---------------------------------------------------------------------------

_publisher_stop: Optional[threading.Event] = None
_publisher_thread: Optional[threading.Thread] = None


def maybe_start_kv_publisher(interval_s: Optional[float] = None) -> bool:
    """Start the fallback publisher thread if (a) there is a store to
    publish to (`fleet_store`: the rendezvous KV under the launcher, else
    the process group's, which a one-rank job lacks), and (b) no
    stall-inspector watchdog is running (which would otherwise publish
    for us).  Returns True when started."""
    global _publisher_stop, _publisher_thread
    from ..common import basics, util
    from ..utils import stall_inspector as _stall

    if _publisher_thread is not None:
        return False
    if not basics.is_initialized():
        return False
    if _stall.get_inspector() is not None:
        return False  # the watchdog publishes snapshots itself
    client = fleet_store(basics.kv_store())
    if client is None:
        return False
    interval = (interval_s if interval_s is not None
                else util.env_float("METRICS_KV_INTERVAL", 5.0))
    rank = basics.rank()
    stop = threading.Event()

    def _run():
        while not stop.wait(interval):
            publish(client, rank=rank)

    t = threading.Thread(target=_run, name="hvd-metrics-kv", daemon=True)
    t.start()
    _publisher_stop, _publisher_thread = stop, t
    return True


def stop_kv_publisher() -> None:
    global _publisher_stop, _publisher_thread
    if _publisher_stop is not None:
        _publisher_stop.set()
    if _publisher_thread is not None:
        _publisher_thread.join(timeout=5)
    _publisher_stop = _publisher_thread = None
