"""Traffic-driven autoscaling: the serving control loop, closed
(counterpart of `horovod_tpu/serve/autoscale.py`).

Every sensor exists in the port: SLO error-budget burn rates
(`metrics/budget.py`), occupancy / queue-depth / pool-free gauges, the
flight recorder's drop counts; and every actuation path: the decode
fleet grows and shrinks through the replica lease plane
(`serve/replica.py` spawn / retire, never a stop-the-world checkpoint
restore), and chips are borrowed from a co-resident training job
through `serve/handoff.py` with a guaranteed hand-back.  This module is
the control logic between them.

Decision core (`AutoscaleController.observe`): a hysteresis/dwell
machine over `SignalSnapshot`s:

  pressure  = budget breach latched, occupancy over the high
              watermark with a backlog, or queue wait over target
  relief    = occupancy under the low watermark, empty queue, and a
              healthy (non-burning) error budget

Pressure must persist `dwell` consecutive observations to fire a grow;
relief must persist `dwell` to fire a shrink.  After any actuation a
`cooldown` suppresses further events, and an event in the opposite
direction of the last one waits `flap_mult` times the cooldown
(anti-flap).  The budget latch forbids shrinking while the SLO budget
is breaching.  Every decision, fired or held, is appended to a
replayable log: identical snapshot sequences give identical logs.

Degrade ladder when growing cannot relieve the pressure (the fleet at
`max_replicas`):

  1. shed      drop the lowest-priority tenant class's queued requests
               (the scheduler's priority shed)
  2. borrow    take chips from the co-resident training job
               (`BorrowLedger` over serve/handoff.py; relief returns
               borrowed chips before the fleet shrinks below its own
               floor, and `close()` returns whatever is still out)
  3. grow      the normal rung: a new replica joins

Scale events run a small state machine (`ScaleEvent`): planning ->
actuating -> committed | aborted.  A fault mid-event aborts it, dumps
the flight recorder (`scale_event_failed`), and leaves the fleet on the
lease plane's converged size; `run_scale_chaos` fires
`serve.replica_die` during grow events and checks convergence, digest
agreement across replicas and recovered tokens.

`simulate_autoscale` is the deterministic fleet model the bench's A/B
runs: the same decision core driven by a seeded shaped trace against a
queueing model of the fleet, scored on SLO-violation-minutes and
chip-hours against a static fleet of the same mean size.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Tuple

from ..common import util
from ..common.exceptions import InvalidRequestError
from ..metrics import catalog as _met

logger = logging.getLogger("horovod_tpu_torch.serve.autoscale")

__all__ = [
    "AutoscaleConfig", "AutoscaleController", "BorrowLedger",
    "Decision", "ReplicaFleetActuator", "ScaleEvent", "SignalSnapshot",
    "parse_tenant_classes", "run_scale_chaos", "simulate_autoscale",
    "snapshot_from_manager", "snapshot_from_server",
]

#: Decision verdicts, in degrade-ladder order for the docs.
VERDICTS = ("hold", "shed", "borrow", "grow", "handback", "shrink")


def parse_tenant_classes(spec: Optional[str] = None) -> Dict[str, int]:
    """``HOROVOD_AUTOSCALE_TENANT_CLASSES`` grammar: ``name:prio`` pairs
    joined by commas, lower prio = more important (served last into the
    shedder).  The default mirrors a real fleet's three tiers."""
    if spec is None:
        spec = util.getenv("AUTOSCALE_TENANT_CLASSES") or \
            "premium:0,standard:1,batch:2"
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise InvalidRequestError(
                f"tenant class {part!r} is not name:priority "
                "(HOROVOD_AUTOSCALE_TENANT_CLASSES)")
        name, prio = part.rsplit(":", 1)
        try:
            out[name.strip()] = int(prio)
        except ValueError:
            raise InvalidRequestError(
                f"tenant priority {prio!r} is not an integer "
                "(HOROVOD_AUTOSCALE_TENANT_CLASSES)") from None
    if not out:
        raise InvalidRequestError(
            "HOROVOD_AUTOSCALE_TENANT_CLASSES parsed to no classes")
    return out


@dataclasses.dataclass(frozen=True)
class SignalSnapshot:
    """One observation of every signal the decision core consumes.
    All fields are plain floats/ints so the decision log serializes and
    replays byte-identically."""

    step: int
    fleet_size: int
    occupancy: float            # active rows / capacity, 0..1
    queue_depth: int            # requests waiting for admission
    queue_wait_ms: float        # oldest queued request's wait
    pool_free_frac: float       # free KV pages / pool pages, 0..1
    burn_fast: float = 0.0      # SLO budget burn, fast window
    burn_slow: float = 0.0      # SLO budget burn, slow window
    breaching: bool = False     # SloBudget multi-window latch
    flightrec_drops: int = 0    # events the bounded ring has dropped
    borrowable: int = 0         # chips the training job could lend
    borrowed: int = 0           # chips currently on loan to us

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AutoscaleConfig:
    """Targets and guards; every field seeds from a
    ``HOROVOD_AUTOSCALE_*`` env knob, and cooldown/dwell from the
    tuner's host-only knobs while it runs (the controller is host-side
    control flow only)."""

    min_replicas: int = None
    max_replicas: int = None
    cooldown_steps: int = None
    dwell_steps: int = None
    occ_high: float = None
    occ_low: float = None
    queue_wait_high_ms: float = None
    flap_mult: int = 2
    grow_step: int = 1          # replicas added per grow event
    tenant_classes: Dict[str, int] = None

    def __post_init__(self):
        from ..utils import autotune as _at
        if self.min_replicas is None:
            self.min_replicas = util.env_int("AUTOSCALE_MIN_REPLICAS", 1)
        if self.max_replicas is None:
            self.max_replicas = util.env_int("AUTOSCALE_MAX_REPLICAS", 8)
        if self.cooldown_steps is None:
            self.cooldown_steps = _at.current_autoscale_cooldown()
        if self.dwell_steps is None:
            self.dwell_steps = _at.current_autoscale_dwell()
        if self.occ_high is None:
            self.occ_high = util.env_float("AUTOSCALE_OCC_HIGH", 0.85)
        if self.occ_low is None:
            self.occ_low = util.env_float("AUTOSCALE_OCC_LOW", 0.30)
        if self.queue_wait_high_ms is None:
            self.queue_wait_high_ms = util.env_float(
                "AUTOSCALE_QUEUE_MS", 1000.0)
        if self.tenant_classes is None:
            self.tenant_classes = parse_tenant_classes()
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise InvalidRequestError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}/{self.max_replicas}")
        if not 0.0 <= self.occ_low < self.occ_high <= 1.0:
            raise InvalidRequestError(
                f"need 0 <= occ_low < occ_high <= 1, got "
                f"{self.occ_low}/{self.occ_high}")
        if self.dwell_steps < 1 or self.cooldown_steps < 0:
            raise InvalidRequestError(
                f"dwell must be >= 1 and cooldown >= 0, got "
                f"{self.dwell_steps}/{self.cooldown_steps}")


@dataclasses.dataclass
class Decision:
    """One control decision; ``fired`` decisions carry a target."""

    step: int
    verdict: str                # one of VERDICTS
    reason: str
    from_size: int
    to_size: int
    snapshot: Dict

    @property
    def fired(self) -> bool:
        return self.verdict != "hold"


@dataclasses.dataclass
class ScaleEvent:
    """One actuation's state machine: planning -> actuating ->
    committed | aborted.  ``converged_size`` is the lease plane's
    answer, which on an aborted event may differ from ``to_size`` —
    the fleet converges, it just doesn't reach the plan."""

    verdict: str
    from_size: int
    to_size: int
    step: int
    state: str = "planning"     # planning|actuating|committed|aborted
    converged_size: int = -1
    detail: str = ""
    wall_ms: float = 0.0


class BorrowLedger:
    """Chip borrowing from a co-resident training job, with the
    hand-back GUARANTEE the train-by-night/serve-by-day story needs:
    every borrow is recorded, ``handback()`` returns loans newest-
    first, and ``close()`` returns everything still outstanding — the
    controller calls it at drain, so a dead autoscaler can never
    strand training chips.

    ``borrow_fn(n) -> int`` and ``handback_fn(n) -> None`` are the
    actuation edges; the real pair stashes/restores training state
    through `serve/handoff.py` (reshard-synced, digest-verified — see
    `handoff.stash_train_state` / `handoff.restore_train_state`).  A
    borrow_fn that raises (e.g. a reshard peer dying mid-stash) aborts
    the borrow with the ledger unchanged."""

    def __init__(self, borrow_fn: Callable[[int], int],
                 handback_fn: Callable[[int], None],
                 capacity: int):
        self.borrow_fn = borrow_fn
        self.handback_fn = handback_fn
        self.capacity = int(capacity)
        self.outstanding = 0
        self.history: List[Tuple[str, int]] = []

    def borrowable(self) -> int:
        return max(0, self.capacity - self.outstanding)

    def borrow(self, n: int) -> int:
        n = min(int(n), self.borrowable())
        if n <= 0:
            return 0
        got = int(self.borrow_fn(n))
        if got > 0:
            self.outstanding += got
            self.history.append(("borrow", got))
        return got

    def handback(self, n: Optional[int] = None) -> int:
        n = self.outstanding if n is None else min(int(n),
                                                   self.outstanding)
        if n <= 0:
            return 0
        self.handback_fn(n)
        self.outstanding -= n
        self.history.append(("handback", n))
        return n

    def close(self) -> int:
        """The guarantee: whatever is still on loan goes back."""
        return self.handback(None)


class AutoscaleController:
    """The closed serving control loop (module docstring).

    ``actuator`` implements the fleet edges (`ReplicaFleetActuator`
    for a real lease-plane fleet, `_SimFleet` for the bench model);
    ``ledger`` is the optional `BorrowLedger`.  ``observe()`` is the
    pure decision core — no side effects beyond the logs/metrics — and
    ``actuate()`` runs the scale-event state machine; ``step()`` does
    both."""

    def __init__(self, config: Optional[AutoscaleConfig] = None,
                 actuator=None, ledger: Optional[BorrowLedger] = None,
                 flightrec=None):
        self.config = config or AutoscaleConfig()
        self.actuator = actuator
        self.ledger = ledger
        self.flightrec = flightrec
        self.decisions: List[Decision] = []
        self.events: List[ScaleEvent] = []
        self.shed_total = 0
        self._pressure_streak = 0
        self._relief_streak = 0
        self._last_event_step: Optional[int] = None
        self._last_event_dir = 0        # +1 up, -1 down

    # -- decision core -------------------------------------------------

    def _pressure(self, s: SignalSnapshot) -> Optional[str]:
        if s.breaching:
            return "slo budget breaching (latched)"
        if s.occupancy >= self.config.occ_high and s.queue_depth > 0:
            return (f"occupancy {s.occupancy:.2f} >= "
                    f"{self.config.occ_high:.2f} with backlog "
                    f"{s.queue_depth}")
        if self.config.queue_wait_high_ms > 0 and \
                s.queue_wait_ms > self.config.queue_wait_high_ms:
            return (f"queue wait {s.queue_wait_ms:.0f}ms > "
                    f"{self.config.queue_wait_high_ms:.0f}ms")
        return None

    def _relief(self, s: SignalSnapshot) -> Optional[str]:
        if s.breaching or s.burn_fast >= 1.0:
            return None             # budget latch: never scale down
        if s.occupancy <= self.config.occ_low and s.queue_depth == 0:
            return (f"occupancy {s.occupancy:.2f} <= "
                    f"{self.config.occ_low:.2f}, queue empty, budget "
                    f"healthy (burn {s.burn_fast:.2f}x)")
        return None

    def _cooling(self, step: int, direction: int) -> bool:
        if self._last_event_step is None:
            return False
        cool = self.config.cooldown_steps
        if direction and self._last_event_dir and \
                direction != self._last_event_dir:
            cool *= self.config.flap_mult    # anti-flap: reversals wait
        return step - self._last_event_step <= cool

    def observe(self, s: SignalSnapshot) -> Decision:
        """One control decision.  Held decisions are logged too — the
        replay property covers the whole trace, not just the firings."""
        cfg = self.config
        pressure = self._pressure(s)
        relief = self._relief(s)
        self._pressure_streak = self._pressure_streak + 1 if pressure \
            else 0
        self._relief_streak = self._relief_streak + 1 if relief else 0

        verdict, reason, to_size = "hold", "signals in band", \
            s.fleet_size
        if pressure and self._pressure_streak >= cfg.dwell_steps:
            if self._cooling(s.step, +1):
                reason = f"cooldown ({pressure})"
            elif s.fleet_size < cfg.max_replicas:
                verdict = "grow"
                to_size = min(cfg.max_replicas,
                              s.fleet_size + cfg.grow_step)
                reason = pressure
            elif s.borrowable > 0 or (
                    self.ledger is not None
                    and self.ledger.borrowable() > 0):
                verdict = "borrow"
                to_size = s.fleet_size + 1
                reason = f"at max_replicas; {pressure}"
            elif s.queue_depth > 0:
                verdict = "shed"
                reason = (f"at max_replicas, nothing to borrow; "
                          f"{pressure}")
            else:
                reason = f"at max_replicas, no backlog to shed " \
                         f"({pressure})"
        elif relief and self._relief_streak >= cfg.dwell_steps:
            if self._cooling(s.step, -1):
                reason = f"cooldown ({relief})"
            elif s.borrowed > 0:
                # Hand borrowed chips back BEFORE shrinking our own
                # floor — the guarantee training relies on.
                verdict = "handback"
                to_size = s.fleet_size - 1
                reason = f"returning borrowed chips; {relief}"
            elif s.fleet_size > cfg.min_replicas:
                verdict = "shrink"
                to_size = s.fleet_size - 1
                reason = relief
            else:
                reason = f"at min_replicas ({relief})"

        d = Decision(step=s.step, verdict=verdict, reason=reason,
                     from_size=s.fleet_size, to_size=to_size,
                     snapshot=s.as_dict())
        self.decisions.append(d)
        if self.flightrec is not None:
            self.flightrec.record(
                "autoscale", {"verdict": verdict, "reason": reason,
                              "from": d.from_size, "to": d.to_size,
                              "signals": d.snapshot}, step=s.step)
        if _met.enabled():
            _met.autoscale_fleet_size.set(s.fleet_size)
        return d

    # -- actuation -----------------------------------------------------

    def actuate(self, d: Decision) -> Optional[ScaleEvent]:
        """Run one fired decision through the scale-event state
        machine.  A fault mid-event ABORTS: the event records the lease
        plane's converged size, the flight recorder dumps
        (``scale_event_failed``), and the exception does NOT propagate
        — the control loop must outlive its actuations."""
        import time as _time
        if not d.fired:
            return None
        ev = ScaleEvent(verdict=d.verdict, from_size=d.from_size,
                        to_size=d.to_size, step=d.step)
        self.events.append(ev)
        self._pressure_streak = self._relief_streak = 0
        self._last_event_step = d.step
        self._last_event_dir = +1 if d.verdict in ("grow", "borrow") \
            else (-1 if d.verdict in ("shrink", "handback") else
                  self._last_event_dir)
        t0 = _time.perf_counter()
        ev.state = "actuating"
        try:
            if d.verdict == "shed":
                n = self.actuator.shed(d.snapshot["queue_depth"]) \
                    if self.actuator is not None else 0
                self.shed_total += n
                ev.converged_size = d.from_size
                ev.detail = f"shed {n} request(s)"
                if _met.enabled() and n:
                    _met.autoscale_shed.inc(n)
            elif d.verdict == "borrow":
                got = self.ledger.borrow(1) if self.ledger is not None \
                    else 0
                if got and self.actuator is not None:
                    ev.converged_size = self.actuator.scale_to(
                        d.from_size + got)
                else:
                    ev.converged_size = d.from_size
                ev.detail = f"borrowed {got} chip(s)"
                if not got:
                    raise RuntimeError("borrow yielded no chips")
            elif d.verdict == "handback":
                if self.actuator is not None:
                    ev.converged_size = self.actuator.scale_to(d.to_size)
                else:
                    ev.converged_size = d.to_size
                n = self.ledger.handback(1) if self.ledger is not None \
                    else 0
                ev.detail = f"handed back {n} chip(s)"
            else:                       # grow | shrink
                ev.converged_size = self.actuator.scale_to(d.to_size) \
                    if self.actuator is not None else d.to_size
                ev.detail = f"fleet {d.from_size} -> {ev.converged_size}"
                if ev.converged_size != d.to_size:
                    raise RuntimeError(
                        f"fleet converged to {ev.converged_size}, "
                        f"planned {d.to_size}")
            ev.state = "committed"
        except Exception as e:  # noqa: BLE001 — control loop survives
            ev.state = "aborted"
            ev.detail = f"{type(e).__name__}: {e}"
            if ev.converged_size < 0 and self.actuator is not None:
                try:
                    ev.converged_size = self.actuator.fleet_size()
                except Exception:  # noqa: BLE001
                    ev.converged_size = d.from_size
            logger.warning("scale event ABORTED at step %d: %s",
                           d.step, ev.detail)
            if self.flightrec is not None:
                self.flightrec.record(
                    "autoscale_abort",
                    {"verdict": d.verdict, "detail": ev.detail},
                    step=d.step)
                # A bad scale event leaves a post-mortem like crashes do.
                self.flightrec.dump("scale_event_failed")
        ev.wall_ms = (_time.perf_counter() - t0) * 1e3
        from ..utils.timeline import get_timeline
        tl = get_timeline()
        if tl is not None:
            tl.instant("autoscale_event", category="serve",
                       args={"verdict": d.verdict, "state": ev.state,
                             "from": ev.from_size,
                             "to": ev.converged_size})
        if _met.enabled():
            _met.autoscale_events.labels(d.verdict).inc()
            if ev.state == "aborted":
                _met.autoscale_events.labels("aborted").inc()
            if ev.converged_size >= 0:
                _met.autoscale_fleet_size.set(ev.converged_size)
        if self.flightrec is not None:
            self.flightrec.record(
                "autoscale_result",
                {"verdict": d.verdict, "state": ev.state,
                 "converged": ev.converged_size, "detail": ev.detail},
                step=d.step)
        return ev

    def step(self, s: SignalSnapshot) -> Tuple[Decision,
                                               Optional[ScaleEvent]]:
        d = self.observe(s)
        return d, self.actuate(d)

    def close(self) -> None:
        """Drain: the hand-back guarantee (and a final gauge flush)."""
        if self.ledger is not None and self.ledger.outstanding:
            n = self.ledger.close()
            logger.info("autoscale drain: handed back %d borrowed "
                        "chip(s)", n)


# ---------------------------------------------------------------------------
# signal sources

def snapshot_from_server(server, step: Optional[int] = None,
                         fleet_size: int = 1, borrowable: int = 0,
                         borrowed: int = 0) -> SignalSnapshot:
    """Signals from one live `InferenceServer` (single-replica mode:
    the controller sheds through the same scheduler it observes)."""
    budget = server.slo.budget
    breaching = budget.breaching() if budget is not None else False
    drops = 0
    if server.flightrec is not None:
        drops = max(0, server.flightrec._seq - len(server.flightrec))
    return SignalSnapshot(
        step=server.step_no if step is None else int(step),
        fleet_size=int(fleet_size),
        occupancy=float(server.sched.occupancy()),
        queue_depth=int(server.sched.queue_depth()),
        queue_wait_ms=float(server.oldest_queue_wait_ms()),
        pool_free_frac=(server.pool.pages_free()
                        / max(1, server.pool.total_pages)),
        burn_fast=(budget.burn_rate(budget.fast_window_s)
                   if budget is not None else 0.0),
        burn_slow=(budget.burn_rate(budget.slow_window_s)
                   if budget is not None else 0.0),
        breaching=bool(breaching),
        flightrec_drops=int(drops),
        borrowable=int(borrowable), borrowed=int(borrowed))


def snapshot_from_manager(mgr, step: int, max_batch: int = 8,
                          borrowable: int = 0,
                          borrowed: int = 0) -> SignalSnapshot:
    """Signals from a `ReplicaManager` fleet: occupancy is outstanding
    work over fleet decode capacity, queue wait is the oldest
    unfinished request's age."""
    import time as _time
    outstanding = mgr.outstanding()
    size = mgr.fleet_size()
    cap = max(1, size * max_batch)
    oldest = mgr.oldest_unfinished_ts()
    wait_ms = (_time.time() - oldest) * 1e3 if oldest is not None \
        else 0.0
    return SignalSnapshot(
        step=int(step), fleet_size=size,
        occupancy=min(1.0, outstanding / cap),
        queue_depth=max(0, outstanding - size * max_batch),
        queue_wait_ms=wait_ms,
        pool_free_frac=1.0 - min(1.0, outstanding / cap),
        borrowable=int(borrowable), borrowed=int(borrowed))


class ReplicaFleetActuator:
    """Fleet edges over a `ReplicaManager`: scale through the lease
    plane (`scale_to` — joiners spawn and get roles assigned, retirees
    drain their in-flight work to survivors), shed through the cancel
    keys (tenant-priority order, lowest class first, newest first)."""

    def __init__(self, mgr,
                 tenant_classes: Optional[Dict[str, int]] = None):
        self.mgr = mgr
        self.tenant_classes = tenant_classes or parse_tenant_classes()

    def fleet_size(self) -> int:
        return self.mgr.fleet_size()

    def scale_to(self, n: int) -> int:
        return self.mgr.scale_to(n)

    def shed(self, n: int) -> int:
        return self.mgr.shed(n, self.tenant_classes)


# ---------------------------------------------------------------------------
# deterministic fleet model (the bench's A/B, unit-pinned)

@dataclasses.dataclass
class _SimReq:
    arrival: int
    tokens: int
    slo_class: str
    start: int = -1
    finish: int = -1
    shed: bool = False


class _SimFleet:
    """Queueing model of a decode fleet: each replica serves up to
    ``max_batch`` concurrent requests at ``tokens_per_step`` each.
    Scale events take ``lag_steps`` to land (the live reshard is fast,
    not instant).  Used only by `simulate_autoscale` — real serving
    runs the real machinery."""

    def __init__(self, size: int, max_batch: int, tokens_per_step: int,
                 lag_steps: int,
                 tenant_classes: Dict[str, int]):
        self.size = int(size)
        self.max_batch = int(max_batch)
        self.tokens_per_step = int(tokens_per_step)
        self.lag_steps = int(lag_steps)
        self.tenant_classes = tenant_classes
        self.queue: List[_SimReq] = []
        self.active: List[_SimReq] = []
        self._pending: Optional[Tuple[int, int]] = None  # (size, at)
        self.shed_reqs: List[_SimReq] = []
        self.chip_steps = 0

    def fleet_size(self) -> int:
        return self.size

    def scale_to(self, n: int) -> int:
        self._pending = (int(n), self.lag_steps)
        return int(n)

    def shed(self, n: int) -> int:
        """Tenant-priority shed: lowest class first, newest first —
        the exact order `ContinuousScheduler.shed` uses."""
        order = sorted(
            range(len(self.queue)),
            key=lambda i: (-self.tenant_classes.get(
                self.queue[i].slo_class, len(self.tenant_classes)),
                -self.queue[i].arrival, -i))
        out = 0
        for i in sorted(order[:n], reverse=True):
            r = self.queue.pop(i)
            r.shed = True
            self.shed_reqs.append(r)
            out += 1
        return out

    def tick(self, now: int, arrivals: List[_SimReq]) -> None:
        if self._pending is not None:
            size, lag = self._pending
            if lag <= 0:
                self.size = max(1, size)
                self._pending = None
            else:
                self._pending = (size, lag - 1)
        self.queue.extend(arrivals)
        cap = self.size * self.max_batch
        while self.queue and len(self.active) < cap:
            r = self.queue.pop(0)
            r.start = now
            self.active.append(r)
        for r in self.active:
            r.tokens -= self.tokens_per_step
            if r.tokens <= 0:
                r.finish = now
        self.active = [r for r in self.active if r.finish < 0]
        self.chip_steps += self.size


def simulate_autoscale(trace, config: Optional[AutoscaleConfig] = None,
                       *, static_size: Optional[int] = None,
                       max_batch: int = 8, tokens_per_step: int = 8,
                       lag_steps: int = 2, slo_wait_steps: int = 4,
                       step_s: float = 1.0,
                       extra_steps: int = 512) -> Dict:
    """Drive the REAL decision core against a queueing model of the
    fleet; score SLO-violation-minutes and chip-hours.

    ``static_size=None`` runs the autoscaled fleet; an integer pins the
    fleet (the A/B baseline: `bench.py --autoscale` passes the
    autoscaled run's mean size back in, so the comparison is at the
    same mean size).  ``trace``
    is a shaped loadgen trace (items carry a tenant class).  A step is
    in violation when any queued request has waited past
    ``slo_wait_steps``; violation-minutes = violating steps *
    ``step_s`` / 60."""
    cfg = config or AutoscaleConfig()
    classes = cfg.tenant_classes
    reqs = [_SimReq(arrival=int(it[0]),
                    tokens=(int(getattr(it[1], "size", it[1]))
                            + int(it[2])),
                    slo_class=(it[3] if len(it) > 3 else "standard"))
            for it in trace]
    reqs.sort(key=lambda r: r.arrival)
    fleet = _SimFleet(static_size or cfg.min_replicas, max_batch,
                      tokens_per_step, lag_steps, classes)
    ctrl = None
    if static_size is None:
        ctrl = AutoscaleController(cfg, actuator=fleet)
    horizon = reqs[-1].arrival + extra_steps if reqs else extra_steps
    i = 0
    violating_steps = 0
    sizes: List[int] = []
    for now in range(horizon):
        arrivals = []
        while i < len(reqs) and reqs[i].arrival <= now:
            arrivals.append(reqs[i])
            i += 1
        fleet.tick(now, arrivals)
        over = [r for r in fleet.queue
                if now - r.arrival > slo_wait_steps]
        if over:
            violating_steps += 1
        if ctrl is not None:
            cap = fleet.size * fleet.max_batch
            snap = SignalSnapshot(
                step=now, fleet_size=fleet.size,
                occupancy=len(fleet.active) / cap,
                queue_depth=len(fleet.queue),
                queue_wait_ms=(max(now - r.arrival for r in fleet.queue)
                               * step_s * 1e3 if fleet.queue else 0.0),
                pool_free_frac=1.0 - len(fleet.active) / cap,
                breaching=bool(over))
            ctrl.step(snap)
        sizes.append(fleet.size)
        if i >= len(reqs) and not fleet.queue and not fleet.active:
            break
    done = [r for r in reqs if r.finish >= 0]
    waits = [r.start - r.arrival for r in done]
    rec = {
        "mode": "autoscaled" if static_size is None else "static",
        "fleet_mean": round(sum(sizes) / max(1, len(sizes)), 3),
        "fleet_max": max(sizes) if sizes else 0,
        "requests": len(reqs),
        "completed": len(done),
        "shed": len(fleet.shed_reqs),
        "shed_by_class": {
            c: sum(1 for r in fleet.shed_reqs if r.slo_class == c)
            for c in sorted({r.slo_class for r in fleet.shed_reqs})},
        "slo_violation_minutes": round(violating_steps * step_s / 60.0,
                                       4),
        "chip_hours": round(fleet.chip_steps * step_s / 3600.0, 4),
        "queue_wait_p99_steps": (
            float(sorted(waits)[min(len(waits) - 1,
                                    int(0.99 * len(waits)))])
            if waits else 0.0),
    }
    if ctrl is not None:
        rec["events"] = {
            v: sum(1 for e in ctrl.events if e.verdict == v)
            for v in VERDICTS if any(e.verdict == v
                                     for e in ctrl.events)}
        rec["aborted_events"] = sum(1 for e in ctrl.events
                                    if e.state == "aborted")
        ctrl.close()
    return rec


# ---------------------------------------------------------------------------
# chaos-hardened scale events (the serving face of faults/chaos.py)

def run_scale_chaos(n_events: int = 4, seed: int = 0,
                    die_beat: int = 3,
                    lease_ttl: float = 10.0, device=None) -> Dict:
    """Fire grow/shrink events on a real replica fleet while
    `serve.replica_die` kills the joining replica during every grow,
    and check after each event: the fleet converges to the planned
    size, every live replica publishes the same parameter digest (no
    split brain), and every request's tokens match the fault-free
    baseline's (recovery is a lease-plane respawn and reassign, no
    stop-the-world restore).  `device` goes into the replicas'
    ``serve`` dict ("cpu"; None: the card).  Returns the record
    `bench.py --autoscale` prints."""
    import time as _time

    import numpy as np

    from .replica import ReplicaManager

    cfg = {
        "cfg": dict(vocab_size=64, d_model=32, n_heads=4, d_head=8,
                    d_ff=64, n_layers=2, compute_dtype="float32"),
        "seed": 0,
        "serve": dict(max_seq_tokens=24, max_batch=2, page_tokens=4,
                      **({} if device is None else {"device": str(device)})),
    }
    rng = np.random.RandomState(seed)
    prompts = [(rng.randint(0, 64, size=4).tolist(),
                int(rng.randint(2, 6))) for _ in range(8)]

    # Fault-free baseline: a static 1-replica fleet, the same requests.
    with ReplicaManager(1, cfg, lease_ttl=lease_ttl,
                        respawn_backoff=0.2) as mgr:
        for p, mn in prompts:
            mgr.submit(p, mn)
        baseline = mgr.wait_all(timeout=180)

    events: List[Dict] = []
    with ReplicaManager(1, cfg, lease_ttl=lease_ttl,
                        respawn_backoff=0.2) as mgr:
        size = 1
        for k in range(n_events):
            grow = (k % 2 == 0)
            target = size + 1 if grow else size - 1
            faulted = (k % 2 == 0)       # fault every grow event
            t0 = _time.perf_counter()
            if faulted:
                # The joining replica (grow) dies after a few beats: a
                # mid-scale-event fault on the new member.
                victim = f"replica{target - 1 if grow else size - 1}"
                mgr.child_env.update({
                    "HOROVOD_FAULT_SPEC":
                        f"serve.replica_die@{die_beat}:exit:1",
                    "HOROVOD_FAULT_HOSTS": victim,
                })
            converged = mgr.scale_to(max(1, target))
            for p, mn in prompts[k * 2:(k + 1) * 2]:
                mgr.submit(p, mn)
            results = mgr.wait_all(timeout=180)
            if faulted:
                mgr.child_env.pop("HOROVOD_FAULT_SPEC", None)
                mgr.child_env.pop("HOROVOD_FAULT_HOSTS", None)
            digests = mgr.digest_agreement(timeout=60.0)
            # Only prompts[: 2*(k+1)] are in flight yet; request ids
            # align with the baseline's: both fleets submit in order.
            ok_tokens = (len(results) == 2 * (k + 1)
                         and all(results[r] == baseline[r]
                                 for r in results))
            events.append({
                "event": "grow" if grow else "shrink",
                "faulted": faulted,
                "planned": max(1, target),
                "converged": converged,
                "fleet": mgr.fleet_size(),
                "digest_agreement": digests,
                "tokens_identical": bool(ok_tokens),
                "respawns": mgr._respawns,
                "wall_ms": round((_time.perf_counter() - t0) * 1e3, 1),
            })
            size = mgr.fleet_size()
        final_fleet = mgr.fleet_size()
        respawns = mgr._respawns

    return {
        "events": events,
        "final_fleet": final_fleet,
        "respawns": respawns,
        "all_recovered": all(
            e["converged"] == e["planned"] and e["digest_agreement"]
            and e["tokens_identical"] for e in events),
    }
