"""Metrics history rings: bounded time series over the live registry.

Counterpart of `horovod_tpu/metrics/history.py` (copied: pure Python).
The registry (registry.py) is instantaneous: every scrape sees the
current value and nothing else.  This module keeps a small windowed past
IN PROCESS: a sampler walks `MetricsRegistry.collect()` at
`HOROVOD_METRICS_HISTORY_INTERVAL` cadence and appends every counter
and gauge sample (plus delta-quantile estimates for histograms) into
per-series ring buffers of depth `HOROVOD_METRICS_HISTORY_DEPTH`.

Memory is strictly bounded: series_count x depth x one (ts, value)
pair.  The sample pass is read-only over the registry (no locks held
across series) and costs O(series).

Derived series a histogram sample appends (bucket deltas between
consecutive samples, so the quantile reflects the WINDOW, not the
process lifetime):

    <name>:p50 / <name>:p99   delta-quantile estimate (linear
                              interpolation inside the bucket)
    <name>:count              cumulative observation count (rate()able)

Queries: `points`, `rate` (counter->per-second rate with counter-reset
/ respawn handling), `window_stats` (min/mean/max/p50/p99 over a time
window).  `SortedWindow` is the incremental sliding-window quantile
that backs `serve/slo.py` — one bisect per insert instead of a full
re-sort per query, numerically identical to `np.percentile`.

`dump()` writes the whole history as JSONL (tmp + fsync + os.replace,
the checkpoint publish pattern) and is registered as a flight-recorder
trigger sibling (`serve/flightrec.register_sibling`): crash /
SLO-breach / guard-escalation dumps carry the metric history next to
the event ring.  `hvd.init()` starts the sampler (`init_from_env`) and
`hvd.shutdown()` stops it.
"""

from __future__ import annotations

import bisect
import json
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..common import util
from .registry import MetricsRegistry, get_registry

logger = logging.getLogger("horovod_tpu_torch.metrics")

__all__ = [
    "Ring", "SortedWindow", "quantile", "MetricsHistory",
    "default_dump_path", "get_history", "start_history", "stop_history",
    "init_from_env",
]

#: (series_name, label_values) — the ring key.
SeriesKey = Tuple[str, Tuple[str, ...]]


def quantile(sorted_vals: Sequence[float], q: float) -> float:
    """q-th percentile (0..100) of an ascending sequence, linear
    interpolation between closest ranks — bitwise-compatible with
    `np.percentile(..., q)` so the SLO controller's ring-backed p99
    pins the exact values its deque+re-sort predecessor produced."""
    n = len(sorted_vals)
    if n == 0:
        raise ValueError("quantile of empty sequence")
    if n == 1:
        return float(sorted_vals[0])
    pos = (n - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_vals[lo]) + (
        float(sorted_vals[hi]) - float(sorted_vals[lo])) * frac


class SortedWindow:
    """Sliding window that stays sorted incrementally.

    `append` is one deque push plus two bisects (insert the new value,
    remove the evicted one) — O(log n + n) worst case on the list
    shift, but with no full re-sort and no numpy round trip per query,
    which is what `SloController.p99_ms()` paid on every step."""

    __slots__ = ("_fifo", "_sorted")

    def __init__(self, maxlen: int):
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self._fifo: deque = deque(maxlen=maxlen)
        self._sorted: List[float] = []

    def append(self, value: float) -> None:
        value = float(value)
        if len(self._fifo) == self._fifo.maxlen:
            evicted = self._fifo[0]
            del self._sorted[bisect.bisect_left(self._sorted, evicted)]
        self._fifo.append(value)
        bisect.insort(self._sorted, value)

    def quantile(self, q: float) -> float:
        if not self._sorted:
            return 0.0
        return quantile(self._sorted, q)

    def __len__(self) -> int:
        return len(self._fifo)

    def __iter__(self):
        return iter(self._fifo)


class Ring:
    """Bounded (ts, value) series — one deque, thread-safe appends."""

    __slots__ = ("_points", "_lock", "kind")

    def __init__(self, depth: int, kind: str = "gauge"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._points: deque = deque(maxlen=depth)
        self._lock = threading.Lock()
        self.kind = kind

    def append(self, ts: float, value: float) -> None:
        with self._lock:
            self._points.append((float(ts), float(value)))

    def points(self) -> List[Tuple[float, float]]:
        with self._lock:
            return list(self._points)

    def __len__(self) -> int:
        with self._lock:
            return len(self._points)


def _hist_delta_quantile(bounds: List[float], deltas: List[int],
                         q: float) -> Optional[float]:
    """Quantile estimate from per-bucket delta counts (histogram_quantile
    semantics: linear interpolation inside the crossing bucket; the
    +Inf bucket clamps to the highest finite bound)."""
    total = sum(deltas)
    if total <= 0:
        return None
    target = (q / 100.0) * total
    cum = 0
    lo = 0.0
    for bound, count in zip(bounds, deltas):
        if count > 0 and cum + count >= target:
            if bound == float("inf"):
                return lo  # +Inf bucket clamps to the last finite bound
            frac = (target - cum) / count
            return lo + (bound - lo) * frac
        cum += count
        if bound != float("inf"):
            lo = bound
    finite = [b for b in bounds if b != float("inf")]
    return finite[-1] if finite else None


class MetricsHistory:
    """Per-series ring buffers fed by `sample()` (see module doc)."""

    def __init__(self, depth: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.depth = (util.env_int("METRICS_HISTORY_DEPTH", 512)
                      if depth is None else int(depth))
        if self.depth < 1:
            raise ValueError(f"history depth must be >= 1, "
                             f"got {self.depth}")
        self._registry = registry or get_registry()
        self._rings: Dict[SeriesKey, Ring] = {}
        self._lock = threading.Lock()
        #: previous cumulative histogram buckets, for delta quantiles.
        self._hist_prev: Dict[SeriesKey, List[int]] = {}
        self.samples_taken = 0
        #: callbacks run after every sample() — the anomaly monitor's
        #: scan hook (metrics/anomaly.py `AnomalyMonitor.watch`).
        self.post_sample: List[Callable[["MetricsHistory", float], None]]
        self.post_sample = []

    # -- feed ------------------------------------------------------------

    def _ring(self, name: str, labels: Tuple[str, ...],
              kind: str) -> Ring:
        key = (name, labels)
        ring = self._rings.get(key)
        if ring is None:
            with self._lock:
                ring = self._rings.setdefault(key, Ring(self.depth, kind))
        return ring

    def record(self, name: str, value: float,
               labels: Tuple[str, ...] = (), kind: str = "gauge",
               ts: Optional[float] = None) -> None:
        """Append one synthetic point (series that have no registry
        metric behind them — e.g. the chaos soak's step wall time)."""
        self._ring(name, tuple(labels), kind).append(
            time.time() if ts is None else ts, value)

    def sample(self, now: Optional[float] = None) -> None:
        """One sampler tick: snapshot every registry series into its
        ring.  Read-only over the registry; never raises (telemetry
        must never take down training)."""
        ts = time.time() if now is None else float(now)
        try:
            metrics = self._registry.collect()
        except Exception:  # noqa: BLE001 — registry mid-reset
            logger.debug("history sample skipped", exc_info=True)
            return
        for m in metrics:
            for values, child in m.samples():
                labels = tuple(values)
                if m.kind == "histogram":
                    self._sample_histogram(m.name, labels, child, ts)
                else:
                    try:
                        v = float(child.get())
                    except Exception:  # noqa: BLE001
                        continue
                    self._ring(m.name, labels, m.kind).append(ts, v)
        self.samples_taken += 1
        for hook in list(self.post_sample):
            # lint: allow-swallow(post-sample hooks are best-effort)
            try:
                hook(self, ts)
            except Exception:  # noqa: BLE001
                logger.debug("history post-sample hook failed",
                             exc_info=True)

    def _sample_histogram(self, name: str, labels: Tuple[str, ...],
                          child, ts: float) -> None:
        cum = child.cumulative()
        bounds = [b for b, _ in cum]
        counts = [c for _, c in cum]
        key = (name, labels)
        prev = self._hist_prev.get(key)
        self._hist_prev[key] = counts
        self._ring(f"{name}:count", labels, "counter").append(
            ts, float(counts[-1]))
        if prev is None or len(prev) != len(counts):
            return
        # de-cumulate both snapshots, then delta between them.
        def _flat(cs):
            return [c - (cs[i - 1] if i else 0)
                    for i, c in enumerate(cs)]
        deltas = [max(0, c - p) for c, p in
                  zip(_flat(counts), _flat(prev))]
        for q, suffix in ((50.0, "p50"), (99.0, "p99")):
            est = _hist_delta_quantile(bounds, deltas, q)
            if est is not None:
                self._ring(f"{name}:{suffix}", labels, "gauge").append(
                    ts, est)

    # -- queries ---------------------------------------------------------

    def series(self) -> List[SeriesKey]:
        with self._lock:
            return sorted(self._rings)

    def points(self, name: str,
               labels: Tuple[str, ...] = ()) -> List[Tuple[float, float]]:
        ring = self._rings.get((name, tuple(labels)))
        return ring.points() if ring is not None else []

    def rate(self, name: str, labels: Tuple[str, ...] = (),
             window_s: Optional[float] = None,
             now: Optional[float] = None) -> Optional[float]:
        """Counter->per-second rate over the window (whole ring when
        None).  A sample lower than its predecessor is a counter reset
        (worker respawn): the increase restarts from the new value
        instead of going negative."""
        pts = self.points(name, labels)
        if window_s is not None:
            cutoff = (time.time() if now is None else now) - window_s
            pts = [p for p in pts if p[0] >= cutoff]
        if len(pts) < 2:
            return None
        increase = 0.0
        for (_, prev), (_, cur) in zip(pts, pts[1:]):
            increase += cur - prev if cur >= prev else cur
        dt = pts[-1][0] - pts[0][0]
        return increase / dt if dt > 0 else None

    def window_stats(self, name: str, labels: Tuple[str, ...] = (),
                     window_s: Optional[float] = None,
                     now: Optional[float] = None) -> Optional[dict]:
        """min/mean/max/p50/p99 of the series values in the window."""
        pts = self.points(name, labels)
        if window_s is not None:
            cutoff = (time.time() if now is None else now) - window_s
            pts = [p for p in pts if p[0] >= cutoff]
        if not pts:
            return None
        vals = sorted(v for _, v in pts)
        return {
            "n": len(vals),
            "min": vals[0],
            "mean": sum(vals) / len(vals),
            "max": vals[-1],
            "p50": quantile(vals, 50.0),
            "p99": quantile(vals, 99.0),
        }

    # -- dump ------------------------------------------------------------

    def dump(self, reason: str, path: Optional[str] = None) -> str:
        """Atomically write the whole history as JSONL: a header line,
        then one line per series.  Same tmp + fsync + os.replace
        publish as the flight recorder; repeated dumps overwrite."""
        final = path if path is not None else default_dump_path()
        os.makedirs(os.path.dirname(final), exist_ok=True)
        tmp = final + ".tmp"
        with self._lock:
            keys = sorted(self._rings)
        with open(tmp, "w") as f:
            f.write(json.dumps({
                "version": 1,
                "reason": reason,
                "pid": os.getpid(),
                "host": os.environ.get("HOROVOD_HOSTNAME") or "local",
                "depth": self.depth,
                "samples_taken": self.samples_taken,
                "dumped_unix": time.time(),
            }, sort_keys=True) + "\n")
            for name, labels in keys:
                ring = self._rings.get((name, labels))
                if ring is None:
                    continue
                f.write(json.dumps({
                    "series": name,
                    "labels": list(labels),
                    "kind": ring.kind,
                    "points": [[round(ts, 3), v]
                               for ts, v in ring.points()],
                }) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        logger.warning("metrics history dumped to %s (%s)", final, reason)
        return final


def default_dump_path() -> str:
    """HOROVOD_METRICS_HISTORY_DIR, defaulting under the system temp
    dir (the flight recorder's never-in-the-working-tree contract)."""
    d = util.getenv("METRICS_HISTORY_DIR")
    if not d:
        import tempfile
        d = os.path.join(tempfile.gettempdir(), "horovod_history")
    host = os.environ.get("HOROVOD_HOSTNAME") or "local"
    return os.path.join(
        d, f"metrics_history.{host}.{os.getpid()}.jsonl")


# ---------------------------------------------------------------------------
# The process-wide sampler (started from hvd.init(), like the timeline)
# ---------------------------------------------------------------------------

_history: Optional[MetricsHistory] = None
_sampler_stop: Optional[threading.Event] = None
_sampler_thread: Optional[threading.Thread] = None
_state_lock = threading.Lock()


def get_history() -> Optional[MetricsHistory]:
    return _history


def _dump_on_trigger(reason: str) -> None:
    """Flight-recorder sibling: every flightrec dump trigger (crash,
    pool exhaustion, SLO breach, guard escalation, fault exit) also
    dumps the metric history."""
    hist = _history
    if hist is not None:
        hist.dump(reason)


def start_history(interval: Optional[float] = None,
                  depth: Optional[int] = None) -> MetricsHistory:
    """Create the process history and start its sampler thread
    (idempotent — a running sampler keeps its history)."""
    global _history, _sampler_stop, _sampler_thread
    with _state_lock:
        if _history is not None:
            return _history
        interval = (util.env_float("METRICS_HISTORY_INTERVAL", 1.0)
                    if interval is None else float(interval))
        hist = MetricsHistory(depth=depth)
        stop = threading.Event()

        def _run():
            while not stop.wait(interval):
                hist.sample()

        t = threading.Thread(target=_run, name="hvd-metrics-history",
                             daemon=True)
        t.start()
        _history, _sampler_stop, _sampler_thread = hist, stop, t
    # Lazy import: serve.flightrec must stay importable without
    # metrics, and metrics without the serving package.
    # lint: allow-swallow(sibling registration is best-effort)
    try:
        from ..serve import flightrec as _fr
        _fr.register_sibling(_dump_on_trigger)
    except Exception:  # noqa: BLE001
        logger.debug("flightrec sibling registration failed",
                     exc_info=True)
    logger.info("metrics history sampler started (interval %.3gs, "
                "depth %d)", interval, hist.depth)
    return hist


def stop_history() -> None:
    global _history, _sampler_stop, _sampler_thread
    with _state_lock:
        stop, t = _sampler_stop, _sampler_thread
        _history = _sampler_stop = _sampler_thread = None
    if stop is not None:
        stop.set()
    if t is not None:
        t.join(timeout=5)


def init_from_env() -> Optional[MetricsHistory]:
    """Called by `hvd.init()`: HOROVOD_METRICS_HISTORY_INTERVAL > 0
    arms the sampler (0/unset keeps history off — same opt-in stance
    as the timeline)."""
    interval = util.env_float("METRICS_HISTORY_INTERVAL", 0.0)
    if interval <= 0:
        return None
    return start_history(interval=interval)
