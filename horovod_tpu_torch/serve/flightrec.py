"""Serving flight recorder: a bounded ring of recent control events.

The serving stack's failures are rarely reproducible — a pool
exhaustion, an SLO breach, or a replica death is the product of the
exact admission order, SLO toggle history, and page pressure of the
last few hundred steps.  The flight recorder keeps that history
ALWAYS-ON at near-zero cost: a fixed-depth in-memory ring (one deque
append per event, no IO) fed by the server's timeline mirror, the
scheduler's decision log, SLO flips, and pool alloc/free events.

On trouble the ring is dumped atomically (the tmp + fsync +
``os.replace`` pattern of utils/checkpoint.py — a crash mid-dump
leaves the previous dump or nothing, never a truncated file):

  - crash            any exception escaping ``InferenceServer.step()``
  - pool_exhausted   ``PoolExhaustedError`` specifically
  - slo_breach       the SLO controller flips speculation ON
  - guard_escalation a TrainingGuard rollback in the same process
                     (`guard/controller.py` calls `dump_all`)
  - fault_exit       an ``exit``-mode fault point (``os._exit`` skips
                     atexit, so faults.register_exit_hook runs us first)

Counterpart of `horovod_tpu/serve/flightrec.py` (copied: pure host-side
Python); a dump is the JAX package's version-1 format, so its trace
tools (`python -m horovod_tpu.trace flightrec`) read the port's dumps.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

from ..common import util

logger = logging.getLogger("horovod_tpu_torch.serve.flightrec")

#: Live recorders in this process — `dump_all` (the guard-escalation and
#: fault-exit triggers) walks these without owning them.
_RECORDERS: "weakref.WeakSet" = weakref.WeakSet()
_hook_lock = threading.Lock()
_exit_hook_installed = False

#: Trigger siblings: callables invoked with the dump reason whenever a
#: flight-recorder dump fires, so companion planes (the metrics history
#: rings — metrics/history.py) dump alongside the event ring and a
#: crash/SLO-breach/guard-escalation capture carries both.
_SIBLINGS: List = []


def register_sibling(fn) -> None:
    """Register a `fn(reason)` to run on every dump trigger (idempotent
    per callable)."""
    with _hook_lock:
        if fn not in _SIBLINGS:
            _SIBLINGS.append(fn)


def _run_siblings(reason: str) -> None:
    for fn in list(_SIBLINGS):
        # lint: allow-swallow(dump triggers run on failure paths)
        try:
            fn(reason)
        except Exception:  # noqa: BLE001
            logger.exception("flight-recorder sibling dump failed")


def default_out_dir() -> str:
    """HOROVOD_SERVE_FLIGHTREC_DIR, defaulting UNDER the system temp
    dir — never the working tree, so crash dumps cannot end up
    committed."""
    d = util.getenv("SERVE_FLIGHTREC_DIR")
    if d:
        return d
    import tempfile
    return os.path.join(tempfile.gettempdir(), "horovod_flightrec")


def _install_exit_hook() -> None:
    """Register the fault-exit dump trigger once per process.  The
    ``exit`` fault mode calls ``os._exit`` which skips atexit, so the
    recorder must ride the faults layer's pre-exit hooks instead."""
    global _exit_hook_installed
    with _hook_lock:
        if _exit_hook_installed:
            return
        from .. import faults as _faults
        _faults.register_exit_hook(dump_all)
        _exit_hook_installed = True


def dump_all(reason: str) -> List[str]:
    """Dump every live recorder in this process; returns the paths
    written.  Never raises — this runs on failure paths.  Siblings run
    exactly once per trigger, even with zero live recorders (a guard
    escalation in a training-only process still dumps the history)."""
    paths: List[str] = []
    for rec in list(_RECORDERS):
        # lint: allow-swallow(dump triggers run on failure paths)
        try:
            p = rec.dump(reason, _siblings=False)
            if p:
                paths.append(p)
        except Exception:  # noqa: BLE001
            logger.exception("flight-recorder dump failed")
    _run_siblings(reason)
    return paths


def record_all(kind: str, data: Optional[Dict] = None,
               step: Optional[int] = None) -> None:
    """Append one event to every live recorder (the anomaly monitor's
    note channel).  Never raises."""
    for rec in list(_RECORDERS):
        # lint: allow-swallow(notes are best-effort on failure paths)
        try:
            rec.record(kind, data, step=step)
        except Exception:  # noqa: BLE001
            logger.debug("flight-recorder note failed", exc_info=True)


class FlightRecorder:
    """Fixed-depth ring of ``(seq, ts_us, step, kind, data)`` events.

    ``depth`` bounds memory (a deque of small dicts); ``seq`` is a
    monotonic counter so a dump shows how many events the ring dropped.
    ``ts_us`` shares the timeline's clock model — microseconds since
    this recorder's construction (``time.perf_counter`` based), so the
    Perfetto conversion needs no clock juggling.
    """

    def __init__(self, depth: int, out_dir: Optional[str] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self.out_dir = out_dir if out_dir is not None else \
            default_out_dir()
        self._ring: "deque" = deque(maxlen=depth)
        self._lock = threading.Lock()
        self._seq = 0
        self._t0 = time.perf_counter()
        self.dumps: List[str] = []
        _RECORDERS.add(self)
        _install_exit_hook()

    # -- feed ----------------------------------------------------------

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def record(self, kind: str, data: Optional[Dict] = None,
               step: Optional[int] = None,
               ts_us: Optional[float] = None,
               dur_us: Optional[float] = None) -> None:
        """Append one event.  ``dur_us`` marks a span (rendered as a
        Perfetto ``X`` slice starting at ``ts_us``); without it the
        event is an instant."""
        ev: Dict = {"kind": kind,
                    "ts_us": round(self.now_us() if ts_us is None
                                   else ts_us, 1)}
        if step is not None:
            ev["step"] = step
        if dur_us is not None:
            ev["dur_us"] = round(dur_us, 1)
        if data:
            ev["data"] = data
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            self._ring.append(ev)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    # -- dump ----------------------------------------------------------

    def _path(self) -> str:
        host = os.environ.get("HOROVOD_HOSTNAME") or "local"
        return os.path.join(self.out_dir,
                            f"serve_flightrec.{host}.{os.getpid()}.json")

    def dump(self, reason: str, _siblings: bool = True) -> str:
        """Atomically write the ring to ``<dir>/serve_flightrec.
        <host>.<pid>.json`` (tmp + fsync + os.replace, the checkpoint
        publish pattern) and return the path.  Repeated dumps overwrite
        — the newest ring supersedes older, shorter histories.
        ``_siblings=False`` is `dump_all`'s dedupe: it runs them once
        itself after walking every recorder."""
        with self._lock:
            events = list(self._ring)
            total = self._seq
        replica = os.environ.get("HOROVOD_SERVE_REPLICA_ID")
        payload = {
            "version": 1,
            "reason": reason,
            "pid": os.getpid(),
            "replica": int(replica) if replica is not None else None,
            "host": os.environ.get("HOROVOD_HOSTNAME") or "local",
            "depth": self.depth,
            "recorded_total": total,
            "dropped": max(0, total - len(events)),
            "dumped_unix": time.time(),
            "events": events,
        }
        final = self._path()
        tmp = final + ".tmp"
        # The default directory need not exist yet (a fault exit's dump
        # is the post-mortem: it must not fail on that).
        os.makedirs(self.out_dir, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        self.dumps.append(final)
        logger.warning("flight recorder dumped %d events to %s (%s)",
                       len(events), final, reason)
        if _siblings:
            _run_siblings(reason)
        return final

    def close(self) -> None:
        _RECORDERS.discard(self)


def load_dump(path: str) -> Dict:
    """Read a dump back; raises on anything that isn't a version-1
    flight-recorder file (the trace CLI's input check)."""
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict) or "events" not in payload:
        raise ValueError(f"{path}: not a flight-recorder dump")
    return payload


__all__ = ["FlightRecorder", "dump_all", "record_all",
           "register_sibling", "load_dump"]
