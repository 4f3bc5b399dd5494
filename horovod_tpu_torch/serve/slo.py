"""SLO-aware speculative-decode toggling (counterpart of
`horovod_tpu/serve/slo.py`, copied: pure Python).

The server's one latency lever at fixed batch is speculative decoding:
a round replaces ``n_acc + 1`` sequential target dispatches with one
draft chain plus one chunked verify, cutting per-TOKEN latency when
the target is dispatch- or memory-bound.  It costs draft compute and
(at batch) min-acceptance throughput, so it should engage only when
the latency SLO is actually at risk.

The controller watches the observed p99 of per-token step latency over
a sliding window and flips speculation per step against
``HOROVOD_SERVE_SLO_MS``:

  - p99 > slo_ms            -> ON  (latency over budget)
  - p99 < slo_ms * hysteresis -> OFF (comfortably under budget)
  - in between              -> hold (no flapping)

plus a minimum dwell between flips so one outlier step can't toggle
the compiled-program mix.  Decisions are appended to ``decisions`` —
``(step, "spec_on" | "spec_off", p99_ms)`` — so tests replay the
control trace deterministically from a recorded latency sequence.

The window is a `metrics.history.SortedWindow`: one bisect per insert
instead of the original deque + full ``np.percentile`` re-sort per
query, with bitwise-identical p99 output (pinned by test).

Every recorded latency also feeds an error budget
(`metrics.budget.SloBudget`, exported as ``hvd_slo_budget_remaining``
/ ``hvd_slo_burn_rate``); with ``burn_rate=True`` the controller flips
on the budget's multi-window breach latch instead of the raw p99
threshold — the burn-rate signal tolerates a lone outlier that a p99
crossing would act on.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ..common.exceptions import InvalidRequestError
from ..metrics.budget import SloBudget
from ..metrics.history import SortedWindow


class SloController:
    def __init__(self, slo_ms: Optional[float], window: int = 64,
                 hysteresis: float = 0.7, dwell_steps: int = 8,
                 budget: Optional[SloBudget] = None,
                 burn_rate: bool = False):
        """``slo_ms`` None or <= 0 disables the controller (speculation
        stays off unless the server forces it)."""
        if not 0.0 < hysteresis <= 1.0:
            raise InvalidRequestError(
                f"hysteresis must be in (0, 1], got {hysteresis}")
        if window < 1 or dwell_steps < 0:
            raise InvalidRequestError(
                f"window must be >= 1 and dwell_steps >= 0, got "
                f"{window}/{dwell_steps}")
        self.slo_ms = slo_ms if slo_ms and slo_ms > 0 else None
        self.hysteresis = hysteresis
        self.dwell_steps = dwell_steps
        self._lat = SortedWindow(window)
        self.budget = budget
        if self.budget is None and self.slo_ms is not None:
            self.budget = SloBudget("serve_latency")
        self.burn_rate = bool(burn_rate)
        self.spec_on = False
        self._last_flip = -(dwell_steps + 1)
        self.decisions: List[Tuple[int, str, float]] = []
        #: Optional mirror of `decisions` appends, called with the same
        #: (step, event, p99_ms) tuple the decision trace records — the
        #: server wires this to the timeline (`slo_toggle` instant) and
        #: the flight recorder (spec_on = the SLO-breach dump trigger).
        self.on_flip: Optional[
            Callable[[int, str, float], None]] = None

    def record(self, step_ms: float) -> None:
        step_ms = float(step_ms)
        self._lat.append(step_ms)
        if self.budget is not None and self.slo_ms is not None:
            self.budget.record_latency(step_ms, self.slo_ms)

    def p99_ms(self) -> float:
        if not len(self._lat):
            return 0.0
        return self._lat.quantile(99.0)

    def export_budget(self) -> None:
        """Publish the budget gauges (the server's gauge-flush cadence
        calls this alongside its own samples)."""
        if self.budget is not None:
            self.budget.export()

    def _over(self, p99: float) -> bool:
        if self.burn_rate and self.budget is not None:
            return self.budget.breaching()
        return p99 > self.slo_ms

    def _under(self, p99: float) -> bool:
        if self.burn_rate and self.budget is not None:
            return not self.budget.breaching()
        return p99 < self.slo_ms * self.hysteresis

    def update(self, step: int) -> bool:
        """One control decision; returns the (possibly new) spec state."""
        if self.slo_ms is None or not len(self._lat):
            return self.spec_on
        if step - self._last_flip <= self.dwell_steps:
            return self.spec_on
        p99 = self.p99_ms()
        if not self.spec_on and self._over(p99):
            self.spec_on = True
            self._last_flip = step
            self.decisions.append((step, "spec_on", p99))
            if self.on_flip is not None:
                self.on_flip(step, "spec_on", p99)
        elif self.spec_on and self._under(p99):
            self.spec_on = False
            self._last_flip = step
            self.decisions.append((step, "spec_off", p99))
            if self.on_flip is not None:
                self.on_flip(step, "spec_off", p99)
        return self.spec_on


__all__ = ["SloController"]
