"""Continuous-batching request scheduler (counterpart of
`horovod_tpu/serve/scheduler.py`, copied: pure Python).

Static batching admits a wave, decodes until the LAST sequence in the
wave finishes, and only then admits again — every early finisher
leaves a dead row (and its KV pages) in the compiled step.  Continuous
batching admits and evicts PER DECODE STEP: a finished sequence's row
and pages are handed to the next queued request on the very next step,
so batch occupancy (and tokens/sec/chip) tracks the offered load, not
the slowest member of a wave.

The scheduler is deliberately dumb and DETERMINISTIC: admission order
is a pure function of (policy, seed, submit order, capacity checks),
and every decision is appended to ``decision_log`` as
``(step, event, req_id, row)`` tuples — two runs over the same seeded
trace produce byte-identical logs
(tests/test_serve.py::test_scheduler_deterministic; the port's log is
bitwise the JAX package's for the same submissions and seed).

Policies:
  - ``fifo``   admit the oldest queued request whenever a row AND its
               pages are available (head-of-line blocking on pages is
               intentional: deterministic, starvation-free).
  - ``random`` seeded-random choice among the queue — exercises
               admission-order invariance in tests.
  - ``static`` the baseline the bench compares against: admit only
               when the active set is EMPTY, then fill every row — a
               whole wave drains before the next one boards.

Tenant SLO classes: every request carries an ``slo_class`` tag
(default ``"standard"``).  ``shed`` is the autoscaler's degrade rung
below shrink (docs/AUTOSCALE.md): drop queued — never active —
requests, LOWEST-priority class first (highest numeric priority),
newest arrivals first within a class, so a premium request is the last
thing a saturated fleet gives up and a just-submitted batch job is the
first.  Shed order is deterministic and logged like every other
decision.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..common.exceptions import InvalidRequestError

POLICIES = ("fifo", "random", "static")

#: Default tenant-priority map (lower = more important).  The
#: autoscaler overrides this from HOROVOD_AUTOSCALE_TENANT_CLASSES
#: (autoscale.parse_tenant_classes); unknown classes shed FIRST.
DEFAULT_TENANT_PRIORITY = {"premium": 0, "standard": 1, "batch": 2}


@dataclass
class Request:
    """One generation request: prompt in, ``max_new_tokens`` out.
    ``slo_class`` is the tenant's SLO tier — it never changes decode
    math, only shed order under overload."""

    req_id: int
    prompt: np.ndarray                  # [T0] int32
    max_new_tokens: int
    arrival_step: int = 0
    eos_id: Optional[int] = None
    slo_class: str = "standard"

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise InvalidRequestError(
                f"request {self.req_id}: prompt must be non-empty")
        if self.max_new_tokens < 1:
            raise InvalidRequestError(
                f"request {self.req_id}: max_new_tokens must be >= 1, "
                f"got {self.max_new_tokens}")


@dataclass
class ActiveSeq:
    """A request occupying a batch row (admission to eviction)."""

    req: Request
    row: int
    pos: int                            # tokens absorbed into the cache
    admit_step: int
    generated: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.req.max_new_tokens:
            return True
        eos = self.req.eos_id
        return eos is not None and bool(self.generated) \
            and self.generated[-1] == eos


class ContinuousScheduler:
    def __init__(self, max_batch: int, policy: str = "fifo",
                 seed: int = 0):
        if max_batch < 1:
            raise InvalidRequestError(
                f"max_batch must be >= 1, got {max_batch}")
        if policy not in POLICIES:
            raise InvalidRequestError(
                f"policy must be one of {POLICIES}, got {policy!r}")
        self.max_batch = max_batch
        self.policy = policy
        self._rng = random.Random(seed)
        self.queue: List[Request] = []
        self.active: Dict[int, ActiveSeq] = {}       # row -> seq
        self._free_rows: List[int] = list(range(max_batch - 1, -1, -1))
        self.decision_log: List[Tuple[int, str, int, int]] = []
        #: Optional mirror of decision_log appends, called with the same
        #: (step, event, req_id, row) tuple — the server wires this to
        #: the flight recorder.  Purely observational: it must not (and
        #: cannot) change admission order.
        self.observer: Optional[
            Callable[[int, str, int, int], None]] = None

    def _log(self, step: int, event: str, req_id: int, row: int) -> None:
        self.decision_log.append((step, event, req_id, row))
        if self.observer is not None:
            self.observer(step, event, req_id, row)

    def submit(self, req: Request, step: int) -> None:
        self.queue.append(req)
        self._log(step, "submit", req.req_id, -1)

    def queue_depth(self) -> int:
        return len(self.queue)

    def occupancy(self) -> float:
        return len(self.active) / self.max_batch

    def admit(self, step: int,
              can_admit: Callable[[Request], bool]) -> List[ActiveSeq]:
        """Admit as many queued requests as policy + capacity allow.
        ``can_admit(req)`` is the pool's page-availability check; a
        False answer stops admission for this step (back-pressure)."""
        out: List[ActiveSeq] = []
        if self.policy == "static" and self.active:
            return out
        while self.queue and self._free_rows:
            i = (self._rng.randrange(len(self.queue))
                 if self.policy == "random" else 0)
            req = self.queue[i]
            if not can_admit(req):
                break
            self.queue.pop(i)
            row = self._free_rows.pop()
            seq = ActiveSeq(req=req, row=row, pos=0, admit_step=step)
            self.active[row] = seq
            self._log(step, "admit", req.req_id, row)
            out.append(seq)
        return out

    def shed(self, step: int, n: int,
             tenant_priority: Optional[Dict[str, int]] = None
             ) -> List[Request]:
        """Drop up to ``n`` QUEUED requests (never active ones —
        admitted work always finishes), lowest-priority tenant class
        first, newest arrival first within a class.  Returns the shed
        requests so the server can fail them back to callers; each is
        logged as a ``shed`` decision."""
        if n <= 0 or not self.queue:
            return []
        prio = tenant_priority if tenant_priority is not None \
            else DEFAULT_TENANT_PRIORITY
        # Unknown classes rank below every known one (shed first).
        worst = max(prio.values(), default=0) + 1
        order = sorted(
            range(len(self.queue)),
            key=lambda i: (-prio.get(self.queue[i].slo_class, worst),
                           -self.queue[i].arrival_step, -i))
        victims = order[:n]
        picked = {i: self.queue[i] for i in victims}
        for i in sorted(victims, reverse=True):
            self.queue.pop(i)
        out: List[Request] = []
        for i in victims:                 # preserve shed-priority order
            req = picked[i]
            self._log(step, "shed", req.req_id, -1)
            out.append(req)
        return out

    def evict(self, step: int, row: int) -> ActiveSeq:
        try:
            seq = self.active.pop(row)
        except KeyError:
            raise InvalidRequestError(f"row {row} is not active") \
                from None
        self._free_rows.append(row)
        # Keep row handout deterministic regardless of eviction order.
        self._free_rows.sort(reverse=True)
        self._log(step, "evict", seq.req.req_id, row)
        return seq

    def drained(self) -> bool:
        return not self.queue and not self.active


__all__ = ["ActiveSeq", "ContinuousScheduler",
           "DEFAULT_TENANT_PRIORITY", "POLICIES", "Request"]
