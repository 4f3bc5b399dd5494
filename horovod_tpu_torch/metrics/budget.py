"""SLO error budgets: multi-window burn-rate accounting (SRE style).

A raw p99-vs-threshold flip (serve/slo.py's original control signal)
is all-or-nothing: it says "over budget NOW" with no notion of how
much failure the service can still absorb.  An error budget inverts
that: an SLO of `target` good events implies an allowance of
`1 - target` bad events over the budget window, and the *burn rate*
is how fast the service is spending that allowance —

    burn = bad_fraction(window) / (1 - target)

burn 1.0 exactly exhausts the budget over the window; 14.4 exhausts a
30-day budget in 2 days (the Google SRE workbook's fast-page
threshold).  Two windows make the signal robust: the FAST window
(HOROVOD_SLO_BUDGET_FAST) reacts in seconds, the SLOW window
(HOROVOD_SLO_BUDGET_SLOW) refuses to page on a blip; a breach needs
BOTH burning over the threshold, and clears when both drop under
`threshold * hysteresis`.

`SloBudget` is event-stream based: `record(good)` per event (a served
token under its latency SLO), so unit tests drive it with
hand-computed fixtures.  `export()` publishes

    hvd_slo_budget_remaining{slo}       1.0 = untouched, 0 = exhausted
    hvd_slo_burn_rate{slo,window}       fast / slow burn rates

which `serve/slo.py` (burn_rate mode) consumes.  Counterpart of
`horovod_tpu/metrics/budget.py` (copied).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Tuple

from ..common import util

__all__ = ["SloBudget"]

#: Events kept per budget — bounds memory when the time windows are
#: long relative to the event rate (oldest events age out regardless).
_MAX_EVENTS = 65536


class SloBudget:
    """One named error budget over a good/bad event stream."""

    def __init__(self, name: str, target: Optional[float] = None,
                 budget_window_s: Optional[float] = None,
                 fast_window_s: Optional[float] = None,
                 slow_window_s: Optional[float] = None,
                 burn_threshold: float = 1.0,
                 hysteresis: float = 0.5):
        self.name = str(name)
        self.target = (util.env_float("SLO_BUDGET_TARGET", 0.99)
                       if target is None else float(target))
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"SLO target must be in (0, 1), got {self.target}")
        self.budget_window_s = (
            util.env_float("SLO_BUDGET_WINDOW", 3600.0)
            if budget_window_s is None else float(budget_window_s))
        self.fast_window_s = (
            util.env_float("SLO_BUDGET_FAST", 60.0)
            if fast_window_s is None else float(fast_window_s))
        self.slow_window_s = (
            util.env_float("SLO_BUDGET_SLOW", 600.0)
            if slow_window_s is None else float(slow_window_s))
        self.burn_threshold = float(burn_threshold)
        self.hysteresis = float(hysteresis)
        self._events: deque = deque(maxlen=_MAX_EVENTS)  # (ts, good)
        self._lock = threading.Lock()
        self._breaching = False

    # -- feed ------------------------------------------------------------

    def record(self, good: bool, now: Optional[float] = None) -> None:
        ts = time.time() if now is None else float(now)
        with self._lock:
            self._events.append((ts, bool(good)))
            # Age out beyond the budget window so the deque holds only
            # events any query can still see.
            cutoff = ts - self.budget_window_s
            while self._events and self._events[0][0] < cutoff:
                self._events.popleft()

    def record_latency(self, value_ms: float, threshold_ms: float,
                       now: Optional[float] = None) -> None:
        """Latency convenience: good iff under the threshold."""
        self.record(float(value_ms) <= float(threshold_ms), now=now)

    # -- queries ---------------------------------------------------------

    def _window(self, window_s: float,
                now: Optional[float]) -> Tuple[int, int]:
        ts = time.time() if now is None else float(now)
        cutoff = ts - window_s
        good = bad = 0
        with self._lock:
            for ets, egood in reversed(self._events):
                if ets < cutoff:
                    break
                if egood:
                    good += 1
                else:
                    bad += 1
        return good, bad

    def burn_rate(self, window_s: float,
                  now: Optional[float] = None) -> float:
        """bad_fraction(window) / error_budget_fraction; 0.0 with no
        events in the window (no traffic burns nothing)."""
        good, bad = self._window(window_s, now)
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / (1.0 - self.target)

    def budget_remaining(self, now: Optional[float] = None) -> float:
        """Fraction of the budget window's error allowance left: 1.0
        untouched, 0.0 exhausted, negative = overdrawn."""
        good, bad = self._window(self.budget_window_s, now)
        total = good + bad
        if total == 0:
            return 1.0
        allowed = (1.0 - self.target) * total
        return 1.0 - bad / allowed if allowed > 0 else 0.0

    def breaching(self, now: Optional[float] = None) -> bool:
        """Multi-window breach latch: trips when BOTH windows burn over
        the threshold, clears when both drop under threshold *
        hysteresis (no flapping on the boundary)."""
        fast = self.burn_rate(self.fast_window_s, now)
        slow = self.burn_rate(self.slow_window_s, now)
        if (not self._breaching and fast >= self.burn_threshold
                and slow >= self.burn_threshold):
            self._breaching = True
        elif (self._breaching
              and fast < self.burn_threshold * self.hysteresis
              and slow < self.burn_threshold * self.hysteresis):
            self._breaching = False
        return self._breaching

    # -- exposition ------------------------------------------------------

    def export(self, now: Optional[float] = None) -> None:
        """Publish the budget gauges (no-op when metrics are off)."""
        from . import catalog as _met
        if not _met.enabled():
            return
        _met.slo_budget_remaining.labels(self.name).set(
            self.budget_remaining(now))
        _met.slo_burn_rate.labels(self.name, "fast").set(
            self.burn_rate(self.fast_window_s, now))
        _met.slo_burn_rate.labels(self.name, "slow").set(
            self.burn_rate(self.slow_window_s, now))
