"""TraceMeasurements — measured timings flowing back into the runtime.

Counterpart of `horovod_tpu/trace/measure.py`.  The analyzer
(core.analyze) answers "what happened"; this module closes the loop:
the same report becomes (a) the continuous metrics surface
(hvd_step_skew_ms / hvd_straggler_rank / hvd_critical_path_ms,
published through the fleet view like every other gauge) and (b) the
MEASURED objective of the autotuner (`ParameterManager.record_trace`):
the critical path, with per-bucket collective milliseconds for its log.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["TraceMeasurements"]


@dataclasses.dataclass
class TraceMeasurements:
    """Trace-derived per-step attribution, ready to feed the runtime.

    Build one with `from_report(core.analyze(...))`, then
    `apply_to_metrics()` to publish the gauges and/or `feed_autotune()`
    to hand the measured step time to the ParameterManager.
    """

    critical_path_ms: float = 0.0
    step_skew_ms: float = 0.0
    straggler_rank: int = -1
    skew_share: float = 0.0
    #: Mean straggler-wait milliseconds per analyzed step — the ABSOLUTE
    #: time lost to late arrivals.  `skew_share` is a ratio of the
    #: critical path, so a reaction that shrinks the whole step can
    #: RAISE it while shrinking this; reaction efficacy reads this one.
    wait_ms_per_step: float = 0.0
    wire_share: float = 0.0
    collective_share_measured: float = 0.0
    #: Median measured milliseconds per collective bucket, keyed by the
    #: bucket's (name, tid) rendered as "name/tid".
    bucket_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_report(cls, report: dict) -> "TraceMeasurements":
        s = report.get("summary", {})
        per_bucket: Dict[str, list] = {}
        step_waits: list = []
        for step in report.get("steps", ()):
            step_waits.append(float(step.get("wait_ms", 0.0)))
            for b in step.get("buckets", ()):
                key = f"{b['name']}/{b['tid']}"
                per_bucket.setdefault(key, []).append(
                    float(b["wait_ms"]) + float(b["wire_ms"]))
        import statistics
        return cls(
            critical_path_ms=float(s.get("critical_path_ms_median", 0.0)),
            step_skew_ms=float(s.get("step_skew_ms_median", 0.0)),
            straggler_rank=int(s.get("straggler_rank", -1)),
            skew_share=float(s.get("skew_share", 0.0)),
            wait_ms_per_step=(round(statistics.fmean(step_waits), 3)
                              if step_waits else 0.0),
            wire_share=float(s.get("wire_share", 0.0)),
            collective_share_measured=float(
                s.get("collective_share_measured", 0.0)),
            bucket_ms={k: round(statistics.median(v), 3)
                       for k, v in per_bucket.items()},
        )

    def apply_to_metrics(self) -> bool:
        """Publish the measured attribution through metrics/catalog.py
        (and so through the KV fleet view).  Returns False when metrics
        are disabled."""
        from ..metrics import catalog as _met
        if not _met.enabled():
            return False
        _met.critical_path_ms.set(self.critical_path_ms)
        _met.step_skew_ms.set(self.step_skew_ms)
        _met.straggler_rank.set(self.straggler_rank)
        return True

    def feed_autotune(self, pm=None, items_per_step: float = 1.0) -> bool:
        """Hand the measured critical path (and per-bucket timings) to
        the autotuner as its objective sample.  Returns False when no
        manager is active and none was passed."""
        if pm is None:
            from ..utils import autotune as _at
            pm = _at.get_manager()
        if pm is None or self.critical_path_ms <= 0:
            return False
        pm.record_trace(self.critical_path_ms,
                        items_per_step=items_per_step,
                        bucket_ms=self.bucket_ms)
        return True
