"""Worker state registry and host blacklist (counterpart of
`horovod_tpu/runner/elastic/registration.py`).

Reference parity: horovod/runner/elastic/registration.py
(`WorkerStateRegistry`) — records per-worker outcomes, drives the host
blacklist the driver consults when computing the next generation's
assignments.

Fault-tolerance extensions over the reference: failures carry a reason
(process exit vs. heartbeat-lease expiry vs. spawn error), the strike
threshold is env-tunable (``HOROVOD_BLACKLIST_THRESHOLD``, default 1 —
the reference's one-strike behavior), and hosts can be blacklisted
directly (respawn-budget exhaustion).  Every blacklisting counts into
``hvd_hosts_blacklisted_total``.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Set, Tuple

from ...common import util as _util
from ...metrics import catalog as _met

logger = logging.getLogger("horovod_tpu_torch.runner.elastic")

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"

# Failure reasons (the 'why' behind a FAILURE state).
EXIT = "exit"            # process exited nonzero
LEASE_EXPIRED = "lease"  # heartbeat lease lapsed while process alive
SPAWN = "spawn"          # transport could not start the process

Slot = Tuple[str, int]  # (hostname, slot index)


class WorkerStateRegistry:
    def __init__(self, failure_threshold: Optional[int] = None):
        self._lock = threading.Lock()
        self._states: Dict[Slot, str] = {}
        self._host_failures: Dict[str, int] = {}
        self._failure_reasons: Dict[str, Dict[str, int]] = {}
        self._blacklist: Set[str] = set()
        if failure_threshold is None:
            failure_threshold = _util.env_int("BLACKLIST_THRESHOLD", 1)
        self._failure_threshold = max(1, failure_threshold)

    @property
    def failure_threshold(self) -> int:
        return self._failure_threshold

    def record_ready(self, host: str, slot: int) -> None:
        with self._lock:
            self._states[(host, slot)] = READY

    def record_success(self, host: str, slot: int) -> None:
        with self._lock:
            self._states[(host, slot)] = SUCCESS

    def record_failure(self, host: str, slot: int,
                       reason: str = EXIT) -> None:
        """Count the strike; blacklist the host at the threshold
        (reference default: one strike)."""
        with self._lock:
            self._states[(host, slot)] = FAILURE
            self._host_failures[host] = self._host_failures.get(host, 0) + 1
            by_reason = self._failure_reasons.setdefault(host, {})
            by_reason[reason] = by_reason.get(reason, 0) + 1
            if self._host_failures[host] >= self._failure_threshold:
                self._blacklist_locked(
                    host,
                    f"{self._host_failures[host]} failure strike(s), "
                    f"last: {reason}")

    def blacklist_host(self, host: str, why: str) -> None:
        """Direct blacklisting (respawn budget exhausted, operator
        action) — bypasses the strike counter."""
        with self._lock:
            self._blacklist_locked(host, why)

    def _blacklist_locked(self, host: str, why: str) -> None:
        if host not in self._blacklist:
            logger.warning("blacklisting host %s (%s)", host, why)
            self._blacklist.add(host)
            if _met.enabled():
                _met.hosts_blacklisted.inc()

    def failure_count(self, host: str) -> int:
        with self._lock:
            return self._host_failures.get(host, 0)

    def failure_reasons(self, host: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._failure_reasons.get(host, {}))

    def state(self, host: str, slot: int) -> str:
        with self._lock:
            return self._states.get((host, slot), "")

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            return host in self._blacklist

    def blacklist(self) -> Set[str]:
        with self._lock:
            return set(self._blacklist)

    def count(self, state: str) -> int:
        with self._lock:
            return sum(1 for s in self._states.values() if s == state)
