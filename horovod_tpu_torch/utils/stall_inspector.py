"""Stall / deadlock watchdog over the eager collectives.

Counterpart of `horovod_tpu/utils/stall_inspector.py` (reference:
horovod/common/stall_inspector.cc `CheckForStalledTensors`): every
eager collective registers on entry (`ops/collectives.py _traced`) and
deregisters on completion; a daemon watchdog thread warns about an
operation pending past HOROVOD_STALL_CHECK_TIME_SECONDS (once per
operation) and, past HOROVOD_STALL_SHUTDOWN_TIME_SECONDS when that is
above 0, aborts the process (`os._exit(57)`), the reference's two-tier
policy.  HOROVOD_STALL_CHECK_DISABLE=1 turns it off; `hvd.init()`
starts it (`init_from_env`) and `hvd.shutdown()` stops it before the
process group goes.

An async collective stays registered until its torch `Work` completes:
the bracket hands the in-flight handle over (`record_result`), and the
watchdog polls its `ready()` (which reads the handle's `Work`s).  The
inspector holds a weak reference only, so it never keeps a bucket's
buffers alive; a handle that is gone counts as done, and its `wait()`
closes the entry at once.

Rank attribution: `KvRankReporter` publishes this rank's operation
count on the process group's key-value store (the c10d store that
`hvd.init` builds on the coordinator, keys ``stall/rank/<r>``) and names
the ranks behind it.  A one-rank job has no store, so the warning names
this process and says that attribution is unavailable.  At the same
cadence the watchdog publishes this rank's metrics snapshot
(`metrics/fleet.py`, key ``metrics/rank/<r>``): on the rendezvous KV
under the launcher, as the JAX package's does, else on the same store;
`fleet.read_fleet` reads the fleet view back.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from ..common import util

logger = logging.getLogger("horovod_tpu_torch.stall_inspector")


def _metrics():
    # Deferred: utils.* stay importable before the metrics package.
    from ..metrics import catalog

    return catalog


class KvRankReporter:
    """Per-rank progress over a c10d store: every rank publishes (its
    eager-collective count, a timestamp) from its watchdog; a stalled
    rank names the peers whose count is lower (they have not entered the
    collective it waits in) or whose timestamp is stale (dead)."""

    _NS = "stall/rank/"

    def __init__(self, store, rank: int, size: int):
        self._store = store
        self._rank = rank
        self._size = size

    @classmethod
    def from_env(cls) -> Optional["KvRankReporter"]:
        """The reporter over the process group's store, or None for a
        one-rank job (which has no store)."""
        from ..common import basics

        if not basics.is_initialized() or basics.size() <= 1:
            return None
        store = basics.kv_store()
        if store is None:
            return None
        return cls(store, basics.rank(), basics.size())

    def publish(self, seq: int) -> None:
        try:
            self._store.set(f"{self._NS}{self._rank}",
                            json.dumps({"seq": seq, "ts": time.time()}))
        except RuntimeError:  # a store that is gone: reporting is best-effort
            logger.debug("stall publish failed", exc_info=True)

    def laggards(self, my_seq: int, stale_after: float) -> List[str]:
        """Ranks behind this rank's op count ('rank N (at op S, this rank
        at M)'), or with stale heartbeats ('rank N (no heartbeat for
        Xs)').  A c10d `get` blocks on a missing key, so each key is
        checked first."""
        out: List[str] = []
        try:
            now = time.time()
            for r in range(self._size):
                key = f"{self._NS}{r}"
                if r == self._rank or not self._store.check([key]):
                    continue
                info = json.loads(self._store.get(key))
                age = now - float(info.get("ts", 0))
                if age > stale_after:
                    out.append(f"rank {r} (no heartbeat for {age:.0f}s)")
                elif int(info.get("seq", 0)) < my_seq:
                    out.append(
                        f"rank {r} (at op {info.get('seq', 0)}, "
                        f"this rank at {my_seq})")
        except (RuntimeError, ValueError):
            logger.debug("stall laggard query failed", exc_info=True)
        return out


def _readiness(result) -> Callable[[], bool]:
    """A poll of `result.ready()` (the port's in-flight handle) that
    holds no strong reference to it: a result that has been collected
    counts as ready."""
    ref = weakref.ref(result)

    def poll() -> bool:
        obj = ref()
        return obj is None or bool(obj.ready())

    return poll


class StallInspector:
    """Watchdog over outstanding collective operations."""

    def __init__(
        self,
        warn_time_seconds: float = 60.0,
        shutdown_time_seconds: float = 0.0,
        check_interval_seconds: float = 1.0,
        warn_fn: Optional[Callable[[str], None]] = None,
        abort_fn: Optional[Callable[[str], None]] = None,
        reporter: Optional[KvRankReporter] = None,
    ):
        self.warn_time = warn_time_seconds
        self.shutdown_time = shutdown_time_seconds
        self.check_interval = check_interval_seconds
        self._warn_fn = warn_fn or (lambda msg: logger.warning(msg))
        self._abort_fn = abort_fn or self._default_abort
        self._reporter = reporter
        self._lock = threading.Lock()
        # op key -> (description, start wall time, readiness poll or
        # None).  None: closed by record_end; a poll: the watchdog clears
        # the entry once it reports ready.
        self._pending: Dict[int, Tuple[str, float, object]] = {}
        self._warned: set = set()
        self._next_key = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _default_abort(msg: str) -> None:
        # The reference's background thread shuts Horovod down, a fatal
        # error in every framework op; with no background runtime to
        # unwind, the process exits hard so that the launcher or the
        # elastic driver sees it (the same end state).
        logger.error(msg)
        os._exit(57)

    # -- registration (hot path) -----------------------------------------
    def record_start(self, description: str) -> int:
        with self._lock:
            key = self._next_key
            self._next_key += 1
            self._pending[key] = (description, time.time(), None)
        return key

    def record_end(self, key: int) -> None:
        with self._lock:
            self._pending.pop(key, None)
            self._warned.discard(key)

    def record_result(self, key: int, result: object) -> None:
        """Keep `key` open until `result.ready()` (see `_readiness`):
        the dispatch returned, but the collective may still be in
        flight, or hung."""
        poll = _readiness(result)
        with self._lock:
            entry = self._pending.get(key)
            if entry is not None:
                self._pending[key] = (entry[0], entry[1], poll)

    def pending_ops(self) -> List[str]:
        self._clear_ready()
        with self._lock:
            return [d for d, _, _ in self._pending.values()]

    def _clear_ready(self) -> None:
        with self._lock:
            tracked = [(k, p) for k, (_, _, p) in self._pending.items()
                       if p is not None]
        for key, poll in tracked:
            if poll():
                self.record_end(key)

    @staticmethod
    def _local_identity() -> str:
        """This process, for the warning when no store names the
        laggards."""
        from ..common import basics

        if basics.is_initialized():
            return (f"This process is rank {basics.rank()}/"
                    f"{basics.size()} (pid {os.getpid()})")
        return f"This process is pid {os.getpid()}"

    # -- the check (reference: CheckForStalledTensors) --------------------
    def check(self, now: Optional[float] = None) -> List[str]:
        """Warn about newly stalled ops; abort past shutdown_time.
        Returns the descriptions warned about on this check (the
        watchdog thread calls it periodically)."""
        self._clear_ready()
        now = time.time() if now is None else now
        warned_now: List[str] = []
        worst: Optional[Tuple[str, float]] = None
        with self._lock:
            items = list(self._pending.items())
        for key, (desc, start, _poll) in items:
            age = now - start
            if age >= self.warn_time and key not in self._warned:
                self._warned.add(key)
                warned_now.append(desc)
                lag = []
                if self._reporter is not None:
                    with self._lock:
                        my_seq = self._next_key
                    lag = self._reporter.laggards(
                        my_seq, stale_after=max(self.warn_time, 5.0))
                    blame = (f" Ranks behind: {', '.join(lag)}."
                             if lag else "")
                else:
                    # Degraded mode (the JAX package's words): name the
                    # blocked op and this process, and say that
                    # attribution is unavailable.
                    blame = (f" {self._local_identity()}; rank "
                             "attribution unavailable (no rendezvous KV "
                             "— launch via horovodrun_tpu or set "
                             "HOROVOD_RENDEZVOUS_ADDR to name lagging "
                             "ranks).")
                self._warn_fn(
                    f"One or more collectives stalled for {age:.0f}s: "
                    f"[{desc}]. A rank may be lagging, dead, or running a "
                    f"different program.{blame}"
                )
                _m = _metrics()
                if _m.enabled():
                    _m.stall_warnings.inc()
                    _m.stall_laggards.set(len(lag))
            if worst is None or age > worst[1]:
                worst = (desc, age)
        if (
            self.shutdown_time > 0
            and worst is not None
            and worst[1] >= self.shutdown_time
        ):
            _m = _metrics()
            if _m.enabled():
                _m.stall_aborts.inc()
            self._abort_fn(
                f"Collective [{worst[0]}] stalled for {worst[1]:.0f}s "
                f">= HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="
                f"{self.shutdown_time:.0f}; aborting."
            )
        return warned_now

    # -- watchdog thread ---------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="hvd-stall-inspector", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        # The watchdog doubles as the metrics fleet publisher, at the
        # same cadence: to the rendezvous KV under the launcher, else to
        # the reporter's store (metrics/fleet.py reads either back).
        from ..metrics import fleet as _fleet

        fleet_store = _fleet.fleet_store(
            self._reporter._store if self._reporter is not None else None)
        while not self._stop.wait(self.check_interval):
            if self._reporter is not None:
                with self._lock:
                    seq = self._next_key
                self._reporter.publish(seq)
            if fleet_store is not None:
                _fleet.publish(fleet_store)
            self.check()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


_inspector: Optional[StallInspector] = None


def get_inspector() -> Optional[StallInspector]:
    return _inspector


def init_from_env() -> Optional[StallInspector]:
    """Called by `hvd.init()`: the reference's env surface (on unless
    HOROVOD_STALL_CHECK_DISABLE=1)."""
    global _inspector
    shutdown_inspector()
    if util.env_bool("STALL_CHECK_DISABLE", False):
        return None
    warn = util.env_float("STALL_CHECK_TIME_SECONDS", 60.0)
    shutdown = util.env_float("STALL_SHUTDOWN_TIME_SECONDS", 0.0)
    _inspector = StallInspector(
        warn_time_seconds=warn, shutdown_time_seconds=shutdown,
        check_interval_seconds=min(1.0, max(0.1, warn / 4.0)),
        reporter=KvRankReporter.from_env(),
    )
    _inspector.start()
    return _inspector


def shutdown_inspector() -> None:
    global _inspector
    if _inspector is not None:
        _inspector.stop()
        _inspector = None
