"""Anomaly detection over metric series: EWMA z-scores + counter stalls.

Counterpart of `horovod_tpu/metrics/anomaly.py` (copied: pure Python).
Detectors are deliberately tiny — constant state per series, one update
per observation — because they run inside the telemetry plane (the
history sampler's post-sample hook, a training loop's per-step feed)
where a heavyweight model would cost more than the outage it flags.

  ewma_z         exponentially-weighted mean/variance per series; an
                 observation whose z-score against the pre-update
                 baseline exceeds the threshold (HOROVOD_ANOMALY_Z,
                 default 4) trips.  One-sided by default (latency-style
                 series: only WORSE is anomalous — a straggler disarming
                 must not page).  The std is floored at
                 ``rel_floor * |mean|`` so a near-constant series does
                 not turn micro-jitter into pages.
  counter_stall  a monotonic counter that advanced before but has not
                 moved for ``stall_samples`` consecutive observations
                 (a wedged worker keeps publishing snapshots — its
                 hvd_steps_total just stops).

On a trip the monitor names the offending series everywhere a human
would look next: an ``anomaly`` timeline instant, a flight-recorder
note (serve/flightrec.py `record_all`), and the metric pair
``hvd_anomaly_events_total{series,kind}`` / ``hvd_anomaly_active``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..common import util

logger = logging.getLogger("horovod_tpu_torch.metrics")

__all__ = ["Anomaly", "EwmaDetector", "CounterStallDetector",
           "AnomalyMonitor"]


@dataclasses.dataclass
class Anomaly:
    """One detector trip: the offending series, detector kind, the
    observation that tripped it, and its score (z for ewma_z, stalled
    sample count for counter_stall)."""
    series: str
    kind: str
    value: float
    score: float
    ts: float
    step: Optional[int] = None


class EwmaDetector:
    kind = "ewma_z"

    def __init__(self, alpha: float = 0.3, z_thresh: float = 4.0,
                 warmup: int = 8, rel_floor: float = 0.25,
                 min_std: float = 1e-9, one_sided: bool = True):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.z_thresh = float(z_thresh)
        self.warmup = int(warmup)
        self.rel_floor = float(rel_floor)
        self.min_std = float(min_std)
        self.one_sided = bool(one_sided)
        self._mean = 0.0
        self._var = 0.0
        self._n = 0

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def std(self) -> float:
        return math.sqrt(max(self._var, 0.0))

    def update(self, value: float) -> Optional[float]:
        """Feed one observation; returns the z-score when it trips
        (past warmup, |z| over the threshold), else None.  The score
        is computed against the baseline BEFORE absorbing the value,
        so a spike cannot launder itself into its own baseline; it IS
        absorbed afterwards, so a sustained level shift trips once and
        then becomes the new normal."""
        value = float(value)
        z = None
        if self._n >= self.warmup:
            floor = max(self.min_std, self.rel_floor * abs(self._mean))
            std = max(self.std, floor)
            score = (value - self._mean) / std
            tripped = (score >= self.z_thresh if self.one_sided
                       else abs(score) >= self.z_thresh)
            if tripped:
                z = score
        diff = value - self._mean
        incr = self.alpha * diff
        self._mean += incr
        self._var = (1.0 - self.alpha) * (self._var + diff * incr)
        self._n += 1
        return z


class CounterStallDetector:
    kind = "counter_stall"

    def __init__(self, stall_samples: int = 5):
        if stall_samples < 1:
            raise ValueError(
                f"stall_samples must be >= 1, got {stall_samples}")
        self.stall_samples = int(stall_samples)
        self._last: Optional[float] = None
        self._stalled = 0
        self._moved = False

    def update(self, value: float) -> Optional[float]:
        """Feed one cumulative counter sample; returns the stalled
        sample count when the stall first crosses the threshold (one
        trip per stall — the stall stays `active` until movement)."""
        value = float(value)
        if self._last is None:
            self._last = value
            return None
        if value > self._last:
            self._moved = True
            self._stalled = 0
        else:
            self._stalled += 1
        self._last = value
        if self._moved and self._stalled == self.stall_samples:
            return float(self._stalled)
        return None

    @property
    def stalled(self) -> bool:
        return self._moved and self._stalled >= self.stall_samples


class AnomalyMonitor:
    """Per-series detector bank + the emit fan-out (see module doc).

    Feed it directly (`observe` / `observe_counter`) or attach it to a
    `MetricsHistory` sampler with `watch(...)` to scan named registry
    series on every sampler tick."""

    def __init__(self, z_thresh: Optional[float] = None,
                 alpha: float = 0.3, warmup: int = 8,
                 rel_floor: float = 0.25, stall_samples: int = 5,
                 one_sided: bool = True, emit: bool = True):
        self.z_thresh = (util.env_float("ANOMALY_Z", 4.0)
                         if z_thresh is None else float(z_thresh))
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.rel_floor = float(rel_floor)
        self.stall_samples = int(stall_samples)
        self.one_sided = bool(one_sided)
        self.emit = bool(emit)
        self._ewma: Dict[str, EwmaDetector] = {}
        self._stall: Dict[str, CounterStallDetector] = {}
        #: series -> the anomaly currently holding it unhealthy.
        self.active: Dict[str, Anomaly] = {}
        #: every trip, in order (the chaos soak's recall record).
        self.events: List[Anomaly] = []

    # -- feed ------------------------------------------------------------

    def observe(self, series: str, value: float,
                step: Optional[int] = None,
                ts: Optional[float] = None) -> Optional[Anomaly]:
        """One gauge/latency observation through the z-score detector."""
        det = self._ewma.get(series)
        if det is None:
            det = self._ewma[series] = EwmaDetector(
                alpha=self.alpha, z_thresh=self.z_thresh,
                warmup=self.warmup, rel_floor=self.rel_floor,
                one_sided=self.one_sided)
        z = det.update(value)
        if z is None:
            # Clear once the series is comfortably back inside the
            # envelope (half the trip threshold).
            if series in self.active:
                floor = max(det.min_std,
                            det.rel_floor * abs(det.mean))
                std = max(det.std, floor)
                if abs(value - det.mean) / std < self.z_thresh / 2.0:
                    del self.active[series]
                    self._set_active_gauge()
            return None
        return self._trip(series, det.kind, value, z, step, ts)

    def observe_counter(self, series: str, value: float,
                        step: Optional[int] = None,
                        ts: Optional[float] = None) -> Optional[Anomaly]:
        """One cumulative counter sample through the stall detector."""
        det = self._stall.get(series)
        if det is None:
            det = self._stall[series] = CounterStallDetector(
                stall_samples=self.stall_samples)
        score = det.update(value)
        if score is None:
            if series in self.active and not det.stalled:
                del self.active[series]
                self._set_active_gauge()
            return None
        return self._trip(series, det.kind, value, score, step, ts)

    # -- history integration --------------------------------------------

    def watch(self, history, gauges: Sequence[str] = (),
              counters: Sequence[str] = ()) -> None:
        """Attach to a `MetricsHistory`: after every sampler tick, run
        the latest point of each named series through its detector."""
        gauges = tuple(gauges)
        counters = tuple(counters)

        def _scan(hist, ts):
            for name in gauges:
                pts = hist.points(name)
                if pts:
                    self.observe(name, pts[-1][1], ts=pts[-1][0])
            for name in counters:
                pts = hist.points(name)
                if pts:
                    self.observe_counter(name, pts[-1][1],
                                         ts=pts[-1][0])

        history.post_sample.append(_scan)

    # -- emit ------------------------------------------------------------

    def _set_active_gauge(self) -> None:
        from . import catalog as _met
        if _met.enabled():
            _met.anomaly_active.set(len(self.active))

    def _trip(self, series: str, kind: str, value: float, score: float,
              step: Optional[int], ts: Optional[float]) -> Anomaly:
        anom = Anomaly(series=series, kind=kind, value=float(value),
                       score=round(float(score), 3),
                       ts=time.time() if ts is None else float(ts),
                       step=step)
        self.events.append(anom)
        self.active[series] = anom
        if not self.emit:
            return anom
        logger.warning("anomaly: %s on %s (value %.4g, score %.2f, "
                       "step %s)", kind, series, value, score, step)
        from . import catalog as _met
        if _met.enabled():
            _met.anomaly_events.labels(series, kind).inc()
        self._set_active_gauge()
        args = {"series": series, "detector": kind,
                "value": round(float(value), 4), "score": anom.score}
        # lint: allow-swallow(emit fan-out must never break the caller)
        try:
            from ..utils import timeline as _tl
            tl = _tl.get_timeline()
            if tl is not None:
                tl.instant("anomaly", category="anomaly", args=args)
        except Exception:  # noqa: BLE001
            logger.debug("anomaly timeline emit failed", exc_info=True)
        try:
            from ..serve import flightrec as _fr
            _fr.record_all("anomaly", args, step=step)
        except Exception:  # noqa: BLE001
            logger.debug("anomaly flightrec emit failed", exc_info=True)
        return anom
