"""HOROVOD_FAULT_SPEC grammar and the deterministic fault schedule.

Counterpart of `horovod_tpu/faults/spec.py` (own copy).  Grammar
(comma-separated entries)::

    spec    := entry ("," entry)*
    entry   := point ["@" N] ":" mode [":" arg]
    point   := registered fault-point name  (see faults.CATALOG)
    N       := 1-based call index; the entry fires from the Nth hit on
    mode    := "err" [":" prob]            raise FaultInjected
             | "delay" ":" dur [":" prob]  sleep dur, then continue
             | "hang" [":" dur]            sleep dur (default 3600s)
             | "exit" [":" code]           os._exit(code)  (default 1)
    dur     := float with optional unit: "50ms", "2s", "250us", "1.5"
    prob    := float in (0, 1]; decided by a per-point RNG seeded from
               HOROVOD_FAULT_SEED

Each point draws from its own `random.Random(f"{seed}:{point}")`, so a
decision depends only on (seed, point, hit index): the JAX package and
the port make the same decisions for the same spec, seed and hits, and
ranks that make the same calls fault at the same hit.
"""

from __future__ import annotations

import logging
import os
import random
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..common.exceptions import HorovodTpuError

logger = logging.getLogger("horovod_tpu_torch.faults")

_MODES = ("err", "delay", "hang", "exit")

_DUR_RE = re.compile(r"^([0-9]*\.?[0-9]+)(us|ms|s)?$")

DEFAULT_HANG_S = 3600.0


class FaultInjected(HorovodTpuError):
    """Raised by an `err`-mode fault point.  The collectives' bracket
    turns it into HorovodInternalError, the signal elastic recovery
    catches."""


def parse_duration(text: str) -> float:
    """"50ms" -> 0.05; bare floats are seconds."""
    m = _DUR_RE.match(text.strip())
    if not m:
        raise HorovodTpuError(f"bad fault duration {text!r}")
    val = float(m.group(1))
    unit = m.group(2) or "s"
    return val * {"us": 1e-6, "ms": 1e-3, "s": 1.0}[unit]


class FaultAction:
    """One parsed spec entry."""

    __slots__ = ("point", "mode", "duration", "prob", "exit_code",
                 "from_call")

    def __init__(self, point: str, mode: str, duration: float = 0.0,
                 prob: float = 1.0, exit_code: int = 1, from_call: int = 1):
        self.point = point
        self.mode = mode
        self.duration = duration
        self.prob = prob
        self.exit_code = exit_code
        self.from_call = from_call

    def __repr__(self):
        extra = f"@{self.from_call}" if self.from_call > 1 else ""
        return (f"<fault {self.point}{extra}:{self.mode}"
                f" dur={self.duration} p={self.prob}>")


def _parse_entry(entry: str) -> FaultAction:
    parts = entry.strip().split(":")
    if len(parts) < 2:
        raise HorovodTpuError(
            f"bad fault spec entry {entry!r} (want point[@N]:mode[:arg])")
    name = parts[0].strip()
    from_call = 1
    if "@" in name:
        name, _, n = name.partition("@")
        try:
            from_call = int(n)
        except ValueError:
            raise HorovodTpuError(f"bad @N trigger in {entry!r}") from None
        if from_call < 1:
            raise HorovodTpuError(f"@N trigger must be >= 1 in {entry!r}")
    mode = parts[1].strip().lower()
    if mode not in _MODES:
        raise HorovodTpuError(
            f"unknown fault mode {mode!r} in {entry!r} (one of {_MODES})")
    act = FaultAction(name, mode, from_call=from_call)
    args = [p.strip() for p in parts[2:]]
    if mode == "err":
        if args:
            act.prob = float(args[0])
    elif mode == "delay":
        if not args:
            raise HorovodTpuError(f"delay mode needs a duration: {entry!r}")
        act.duration = parse_duration(args[0])
        if len(args) > 1:
            act.prob = float(args[1])
    elif mode == "hang":
        act.duration = parse_duration(args[0]) if args else DEFAULT_HANG_S
    elif mode == "exit":
        act.exit_code = int(args[0]) if args else 1
    if not (0.0 < act.prob <= 1.0):
        raise HorovodTpuError(f"fault probability out of (0,1]: {entry!r}")
    return act


def parse_spec(text: str) -> List[FaultAction]:
    """Parse a HOROVOD_FAULT_SPEC string into actions (an empty list for
    a blank spec)."""
    return [_parse_entry(e) for e in text.split(",") if e.strip()]


class FaultSchedule:
    """The armed schedule: spec entries, per-point hit counters and
    per-point seeded RNGs.  `fire(name)` is the only hot entry point.
    `injections` counts what fired, by (point, mode), as does the
    metric `hvd_fault_injections_total`."""

    def __init__(self, actions: List[FaultAction], seed: int = 0):
        self._seed = seed
        self._lock = threading.Lock()
        self._by_point: Dict[str, List[FaultAction]] = {}
        for a in actions:
            self._by_point.setdefault(a.point, []).append(a)
        self._counts: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}
        self.injections: Dict[Tuple[str, str], int] = {}

    @property
    def points(self) -> List[str]:
        return sorted(self._by_point)

    def call_count(self, point: str) -> int:
        with self._lock:
            return self._counts.get(point, 0)

    def _decide(self, point: str) -> Optional[FaultAction]:
        """The action for this hit, or None.  Holds the lock only for the
        decision, never across a sleep or a raise."""
        with self._lock:
            actions = self._by_point.get(point)
            if not actions:
                return None
            n = self._counts.get(point, 0) + 1
            self._counts[point] = n
            rng = self._rngs.get(point)
            if rng is None:
                rng = self._rngs[point] = random.Random(
                    f"{self._seed}:{point}")
            for act in actions:
                if n < act.from_call:
                    continue
                # Draw even at prob 1.0, so that adding or removing a
                # probability does not shift later draws.
                if rng.random() < act.prob:
                    key = (point, act.mode)
                    self.injections[key] = self.injections.get(key, 0) + 1
                    return act
            return None

    def fire(self, point: str, _sleep=time.sleep) -> Optional[FaultAction]:
        """Execute the scheduled behaviour for one hit of `point`."""
        act = self._decide(point)
        if act is None:
            return None
        _record_injection(point, act.mode)
        logger.warning("fault injected: %r", act)
        if act.mode == "err":
            raise FaultInjected(f"injected fault at {point}")
        if act.mode in ("delay", "hang"):
            _sleep(act.duration)
        elif act.mode == "exit":
            # os._exit skips atexit, so what must flush on an injected
            # death (the serving flight recorder) hooks in here.
            _run_exit_hooks(f"fault_exit:{point}")
            os._exit(act.exit_code)
        return act


def _record_injection(point: str, mode: str) -> None:
    """`hvd_fault_injections_total{point,mode}` (JAX faults/spec.py:233).
    Imported here: faults stays importable before metrics."""
    from ..metrics import catalog as _met

    if _met.enabled():
        _met.fault_injections.labels(point, mode).inc()


# Pre-exit hooks: run (best effort) before an `exit`-mode fault's os._exit.
_exit_hooks: List[Callable[[str], None]] = []


def register_exit_hook(fn: Callable[[str], None]) -> None:
    """Register `fn(reason)` to run before an exit-mode fault point ends
    the process.  Idempotent per function object."""
    if fn not in _exit_hooks:
        _exit_hooks.append(fn)


def unregister_exit_hook(fn: Callable[[str], None]) -> None:
    if fn in _exit_hooks:
        _exit_hooks.remove(fn)


def _run_exit_hooks(reason: str) -> None:
    for fn in list(_exit_hooks):
        # The process is exiting: a failed hook must not mask the exit.
        try:
            fn(reason)
        except Exception:  # noqa: BLE001
            logger.exception("fault exit hook failed")
