"""`python -m horovod_tpu_torch.metrics top` — live fleet console.

Counterpart of `horovod_tpu/metrics/top.py` (copied: pure Python).  A
dependency-free ANSI terminal view over the same per-rank snapshots the
merged CLI reads (HTTP scrapes of the workers' endpoints, or
`fleet.read_fleet` in process): per rank step progress, derived rates
with sparklines, SLO error-budget status lines, and active-anomaly
highlights.

History for the sparklines is built CLIENT-SIDE: the console polls the
fleet and derives counter rates from consecutive snapshots, so it
needs nothing from the workers beyond what they already publish.
(Workers with `HOROVOD_METRICS_HISTORY_INTERVAL` armed keep their own
richer rings in process; the console's are just what a human watches.)

``--once`` renders a single frame to stdout (tests / CI); live mode
redraws every ``--interval`` seconds until Ctrl-C.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional

from .fleet import aggregate

__all__ = ["sparkline", "TopState", "render_frame", "run_top"]

_SPARK = "▁▂▃▄▅▆▇█"
_WIDTH = 32

_RED = "\x1b[31m"
_YELLOW = "\x1b[33m"
_GREEN = "\x1b[32m"
_BOLD = "\x1b[1m"
_RESET = "\x1b[0m"


def sparkline(values: List[float], width: int = _WIDTH) -> str:
    """Unicode block sparkline of the last `width` values (flat series
    render as all-low so a constant line reads as calm, not peak)."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK[0] * len(vals)
    return "".join(
        _SPARK[min(len(_SPARK) - 1,
                   int((v - lo) / span * (len(_SPARK) - 1) + 0.5))]
        for v in vals)


class TopState:
    """Client-side series rings derived from consecutive fleet polls."""

    def __init__(self, width: int = _WIDTH):
        self.width = int(width)
        self._rings: Dict[str, deque] = {}
        self._prev_counters: Dict[str, float] = {}
        self._prev_ts: Optional[float] = None
        #: Last autoscale verdict, derived client-side: whichever
        #: hvd_autoscale_events_total{verdict} series grew between
        #: polls fired most recently (None until one grows).
        self.last_verdict: Optional[str] = None
        self._prev_verdicts: Dict[str, float] = {}

    def _push(self, name: str, value: float) -> None:
        ring = self._rings.get(name)
        if ring is None:
            ring = self._rings[name] = deque(maxlen=self.width)
        ring.append(float(value))

    def series(self, name: str) -> List[float]:
        return list(self._rings.get(name, ()))

    @staticmethod
    def _counter_total(agg: dict, name: str) -> float:
        m = agg.get(name)
        return sum(m["samples"].values()) if m else 0.0

    @staticmethod
    def _gauge_stats(agg: dict, name: str,
                     key: tuple = ()) -> Optional[dict]:
        m = agg.get(name)
        if not m or m["kind"] != "gauge":
            return None
        per = m["samples"].get(key)
        if not per:
            return None
        vals = list(per.values())
        return {"min": min(vals), "max": max(vals),
                "mean": sum(vals) / len(vals)}

    def update(self, snaps: List[dict],
               now: Optional[float] = None) -> dict:
        """Fold one poll into the rings; returns the aggregate view."""
        agg = aggregate(snaps)
        ts = time.time() if now is None else float(now)
        dt = (ts - self._prev_ts) if self._prev_ts is not None else None
        for name, label in (("hvd_steps_total", "steps/s"),
                            ("hvd_collective_bytes_total", "coll MB/s")):
            total = self._counter_total(agg, name)
            prev = self._prev_counters.get(name)
            if dt is not None and dt > 0 and prev is not None:
                inc = total - prev if total >= prev else total
                rate = inc / dt
                self._push(label, rate / 1e6 if "MB" in label else rate)
            self._prev_counters[name] = total
        for name, key, stat in (
                ("hvd_serve_p99_ms", (), "mean"),
                ("hvd_serve_batch_occupancy", (), "mean"),
                ("hvd_serve_pool_pages_free", (), "min"),
                ("hvd_autoscale_fleet_size", (), "max"),
                ("hvd_critical_path_ms", (), "max")):
            st = self._gauge_stats(agg, name, key)
            if st is not None:
                self._push(name, st[stat])
        ev = agg.get("hvd_autoscale_events_total")
        if ev:
            for key, total in sorted(ev["samples"].items()):
                verdict = _label(ev, key, "verdict")
                if total > self._prev_verdicts.get(verdict, 0.0) \
                        and self._prev_ts is not None:
                    self.last_verdict = verdict
                self._prev_verdicts[verdict] = total
        self._prev_ts = ts
        return agg


def _c(text: str, code: str, color: bool) -> str:
    return f"{code}{text}{_RESET}" if color else text


def _label(m: dict, key: tuple, name: str) -> str:
    """Label value by NAME from an aggregated sample key — snapshot
    sources order label values differently (KV: declared order, scrape:
    alphabetical), so positional indexing would swap them."""
    try:
        return key[list(m["labelnames"]).index(name)]
    except (ValueError, IndexError):
        return "?"


def render_frame(snaps: List[dict], state: TopState,
                 color: bool = False) -> str:
    """One console frame from the latest poll + the state's rings."""
    if not snaps:
        return ("no metrics snapshots found "
                "(is any worker publishing?)\n")
    agg = aggregate(snaps)
    now = time.time()
    lines = [_c(f"hvd top — fleet of {len(snaps)} rank(s)   "
                + time.strftime("%H:%M:%S", time.localtime(now)),
                _BOLD, color)]

    # -- per-rank progress ----------------------------------------------
    lines.append("")
    lines.append("rank  steps  snapshot_age_s")
    for snap in snaps:
        r = snap.get("rank", 0)
        m = snap.get("metrics", {}).get("hvd_steps_total")
        steps = sum(v for _, v in m["samples"]) if m else 0
        age = now - float(snap.get("ts", now))
        mark = " (stale)" if age > 60 else ""
        lines.append(f"{r:>4}  {int(steps):>5}  {age:>13.1f}{mark}")

    # -- sparklines ------------------------------------------------------
    rows = [("steps/s", "steps/s", "{:.2f}"),
            ("coll MB/s", "collective MB/s", "{:.2f}"),
            ("hvd_critical_path_ms", "step critical path ms", "{:.1f}"),
            ("hvd_serve_p99_ms", "serve p99 ms", "{:.2f}"),
            ("hvd_serve_batch_occupancy", "batch occupancy", "{:.2f}"),
            ("hvd_serve_pool_pages_free", "KV pages free", "{:.0f}"),
            ("hvd_autoscale_fleet_size", "autoscale fleet", "{:.0f}")]
    spark_lines = []
    for key, label, fmt in rows:
        vals = state.series(key)
        if not vals:
            continue
        spark_lines.append(
            f"{label:>22}  {sparkline(vals):<{state.width}}  "
            + fmt.format(vals[-1]))
    if spark_lines:
        lines.append("")
        lines.extend(spark_lines)

    # -- SLO error budgets ----------------------------------------------
    budgets = agg.get("hvd_slo_budget_remaining")
    burn = agg.get("hvd_slo_burn_rate")
    if budgets and budgets["samples"]:
        lines.append("")
        for key, per in sorted(budgets["samples"].items()):
            slo = _label(budgets, key, "slo")
            remaining = min(per.values())
            rates = {}
            if burn:
                for bkey, bper in burn["samples"].items():
                    if _label(burn, bkey, "slo") == slo:
                        rates[_label(burn, bkey, "window")] = \
                            max(bper.values())
            fast = rates.get("fast", 0.0)
            slow = rates.get("slow", 0.0)
            code = (_RED if remaining <= 0 or (fast >= 1 and slow >= 1)
                    else _YELLOW if fast >= 1 else _GREEN)
            lines.append(_c(
                f"SLO {slo}: budget {remaining * 100:.1f}%  "
                f"burn fast {fast:.2f}x / slow {slow:.2f}x", code, color))

    # -- autoscale -------------------------------------------------------
    fleet_g = state._gauge_stats(agg, "hvd_autoscale_fleet_size")
    ev = agg.get("hvd_autoscale_events_total")
    if fleet_g is not None or (ev and ev["samples"]):
        lines.append("")
        parts = []
        if fleet_g is not None:
            parts.append(f"fleet {int(fleet_g['max'])}")
        if state.last_verdict is not None:
            parts.append(f"last verdict {state.last_verdict}")
        elif ev and ev["samples"]:
            # --once mode has no poll delta: show lifetime counts.
            counts = ", ".join(
                f"{_label(ev, key, 'verdict')}={int(total)}"
                for key, total in sorted(ev["samples"].items()))
            parts.append(f"events {counts}")
        shed = agg.get("hvd_autoscale_shed_total")
        if shed and shed["samples"]:
            n = int(sum(shed["samples"].values()))
            if n:
                parts.append(_c(f"shed {n}", _YELLOW, color))
        lines.append("autoscale: " + "  ".join(parts))

    # -- anomalies -------------------------------------------------------
    active = agg.get("hvd_anomaly_active")
    events = agg.get("hvd_anomaly_events_total")
    n_active = 0
    if active:
        n_active = int(sum(max(per.values())
                           for per in active["samples"].values()))
    if n_active or (events and events["samples"]):
        lines.append("")
        if n_active:
            lines.append(_c(f"ACTIVE ANOMALIES: {n_active}",
                            _RED + _BOLD, color))
        else:
            lines.append("anomalies: none active")
        if events:
            for key, count in sorted(events["samples"].items(),
                                     key=lambda kv: -kv[1])[:5]:
                series = _label(events, key, "series")
                kind = _label(events, key, "kind")
                lines.append(f"  {series} [{kind}]: "
                             f"{int(count)} trip(s)")
    return "\n".join(lines) + "\n"


def run_top(fetch: Callable[[], List[dict]], interval: float = 2.0,
            once: bool = False, color: Optional[bool] = None) -> int:
    """Console loop: poll `fetch`, fold into state, render.  `once`
    prints a single plain frame (tests/CI); live mode clears the screen
    each redraw and exits cleanly on Ctrl-C."""
    import sys
    state = TopState()
    if color is None:
        color = (not once) and sys.stdout.isatty()
    while True:
        snaps = fetch()
        state.update(snaps)
        frame = render_frame(snaps, state, color=color)
        if once:
            print(frame, end="")
            return 0 if snaps else 1
        print("\x1b[2J\x1b[H" + frame, end="", flush=True)
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
            print()
            return 0
