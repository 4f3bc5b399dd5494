"""Deterministic fault injection (counterpart of `horovod_tpu/faults/`).

A seeded schedule parsed from ``HOROVOD_FAULT_SPEC`` decides, per hit of
a named point, whether the point errors, delays, hangs or ends the
process, so a failure sequence replays exactly from (spec, seed):

    HOROVOD_FAULT_SPEC="collective.allreduce@40:err:0.01"
    HOROVOD_FAULT_SEED=7            # replay key (default 0)
    HOROVOD_FAULT_HOSTS=hostB       # arm only where HOROVOD_HOSTNAME is listed

The port fires the `collective.*` points and `chaos.straggler_delay` in
its eager collectives (`ops/collectives.py`), `state.commit` in
`elastic.State.commit`, `checkpoint.save` and `checkpoint.restore` in
`utils/checkpoint.py`, and `guard.nan_grad` and `guard.param_bitflip` in
`guard.TrainingGuard.maybe_inject` (which turns their `err` into a NaN
batch or a flipped parameter bit), the `rendezvous.*` points in the
rendezvous client (`runner/rendezvous.py`), `worker.heartbeat` in
`runner/elastic_worker.publish_heartbeat`, `worker.refresh` in
`runner/elastic_worker.refresh_from_control_plane`, and
`elastic.publish` and `elastic.spawn` in the elastic driver
(`runner/elastic/driver.py`), `reshard.chunk_corrupt` and
`reshard.peer_die` in the live reshard (`parallel/reshard.py`), and
`chaos.step` in the chaos soak (`faults/chaos.py`).  `CATALOG` is the
JAX package's whole catalog, so a spec valid there is valid here; only
`serve.replica_die` never fires (serving replicas are not ported yet).
An ``exit`` fault runs the hooks of
`register_exit_hook` first (the serving flight recorder's dump).  Every
injection is counted into `hvd_fault_injections_total{point,mode}`, as
in the JAX package, and `injections()` returns the armed schedule's
counts by (point, mode).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional, Tuple

from ..common import util
from ..common.exceptions import HorovodTpuError
from .retry import RetryPolicy  # noqa: F401  (re-export)
from .spec import (  # noqa: F401  (re-export)
    FaultAction,
    FaultInjected,
    FaultSchedule,
    parse_duration,
    parse_spec,
    register_exit_hook,
    unregister_exit_hook,
)

logger = logging.getLogger("horovod_tpu_torch.faults")

__all__ = [
    "CATALOG", "FaultInjected", "FaultSchedule", "RetryPolicy",
    "active", "clear", "injections", "install", "parse_spec", "point",
    "points_hit", "register_exit_hook", "unregister_exit_hook",
]

# The JAX package's catalog (horovod_tpu/faults/__init__.py), copied whole.
CATALOG = {
    # control plane (runner/rendezvous.py, client side)
    "rendezvous.connect":
        "Before a client TCP connect to the rendezvous server.",
    "rendezvous.put": "Before a client PUT request.",
    "rendezvous.get": "Before a client GET request.",
    "rendezvous.wait": "Before a client WAIT request.",
    "rendezvous.delete": "Before a client DEL request.",
    "rendezvous.keys": "Before a client KEYS request.",
    "rendezvous.barrier": "Before a client BARRIER request.",
    # collectives (ops/collectives.py `_traced.__enter__`); injected
    # errors surface as HorovodInternalError — the elastic recovery path.
    "collective.allreduce": "Eager allreduce dispatch.",
    "collective.allgather": "Eager allgather dispatch.",
    "collective.allgather_sizes": "Allgather size-exchange dispatch.",
    "collective.broadcast": "Eager broadcast dispatch.",
    "collective.alltoall": "Eager alltoall dispatch.",
    "collective.alltoall_splits": "Alltoall split-exchange dispatch.",
    "collective.reducescatter": "Eager reducescatter dispatch.",
    # elastic driver (runner/elastic/driver.py)
    "elastic.publish": "Before the driver publishes a new generation.",
    "elastic.spawn": "Before the driver spawns one worker process.",
    # elastic worker (runner/elastic_worker.py)
    "worker.heartbeat":
        "Before a worker publishes one heartbeat (err = dropped beat, "
        "hang = silent worker: alive but lease-expiring).",
    "worker.refresh":
        "Before a worker fetches the current generation info.",
    # state / checkpoint I/O (elastic/__init__.py, utils/checkpoint.py)
    "state.commit": "Inside State.commit, before the snapshot.",
    "checkpoint.save": "Before a durable checkpoint write.",
    "checkpoint.restore": "Before a durable checkpoint read.",
    # training-health guardian (guard/controller.py maybe_inject); err
    # mode is TRANSLATED into data corruption rather than raised: the
    # guard loop must detect and recover, not crash.
    "guard.nan_grad":
        "Before a training step: err poisons this rank's next batch "
        "with NaN, so backward produces non-finite gradients.",
    "guard.param_bitflip":
        "Before a training step: err flips one mantissa bit of this "
        "rank's first parameter (silent replica divergence for the "
        "digest check to catch).",
    "serve.replica_die":
        "Each serving-replica work-loop iteration: exit kills the "
        "replica process mid-stream (the manager's lease/respawn must "
        "recover its in-flight sequences), err raises in the loop.",
    # live resharding (parallel/reshard.py); see docs/RESHARD.md
    "reshard.peer_die":
        "Before a rank publishes one stream's reshard chunks: err "
        "abandons the reshard mid-publish (chunks already out), so "
        "peers must time out on the missing keys and every rank falls "
        "back to the checkpoint-restore path.",
    "reshard.chunk_corrupt":
        "Per published reshard chunk: err is TRANSLATED into payload "
        "corruption after the sha256 is computed (like the guard "
        "points) — the receiver must detect the mismatch and raise "
        "ReshardError, never assemble corrupt state.",
    # chaos soak (faults/chaos.py; see docs/CHAOS.md)
    "chaos.step":
        "Top of one chaos-soak training step, fired by the soak loop "
        "itself: delay = a worker stall the peers must ride out, err = "
        "an injected step failure routed into the recovery path.",
    "chaos.straggler_delay":
        "Per eager collective dispatch (ops/collectives.py bracket) "
        "while armed: delay injects a per-rank, per-bucket slowdown — "
        "the straggler signature the trace reaction policy must blame "
        "and rebalance away from; err raises HorovodInternalError like "
        "the collective.* points.",
}

_lock = threading.Lock()
_schedule: Optional[FaultSchedule] = None
_env_loaded = False


def _load_from_env() -> Optional[FaultSchedule]:
    spec = util.getenv("FAULT_SPEC")
    if not spec:
        return None
    hosts = util.getenv("FAULT_HOSTS")
    if hosts:
        me = os.environ.get("HOROVOD_HOSTNAME", "")
        if me not in [h.strip() for h in hosts.split(",") if h.strip()]:
            logger.debug("fault spec scoped to %s; %r not in scope",
                         hosts, me)
            return None
    seed = int(os.environ.get("HOROVOD_FAULT_SEED", "0"))
    actions = parse_spec(spec)
    for a in actions:
        if a.point not in CATALOG:
            raise HorovodTpuError(
                f"HOROVOD_FAULT_SPEC names unknown fault point "
                f"{a.point!r}; known points: {sorted(CATALOG)}")
    sched = FaultSchedule(actions, seed=seed)
    logger.warning("fault injection armed (seed=%d): %s", seed,
                   sched.points)
    return sched


def _current() -> Optional[FaultSchedule]:
    global _schedule, _env_loaded
    if not _env_loaded:
        with _lock:
            if not _env_loaded:
                _schedule = _load_from_env()
                _env_loaded = True
    return _schedule


def install(spec, seed: int = 0) -> FaultSchedule:
    """Arm a schedule in code (tests, harnesses): a spec string or a
    FaultSchedule."""
    global _schedule, _env_loaded
    sched = spec if isinstance(spec, FaultSchedule) else \
        FaultSchedule(parse_spec(spec), seed=seed)
    with _lock:
        _schedule = sched
        _env_loaded = True
    return sched


def clear() -> None:
    """Disarm fault injection (the env spec is not read again)."""
    global _schedule, _env_loaded
    with _lock:
        _schedule = None
        _env_loaded = True


def active() -> bool:
    """True when a schedule is armed: the guard of hot call sites."""
    return _current() is not None


def point(name: str) -> None:
    """Fire fault point `name`: nothing without a schedule; otherwise it
    may raise FaultInjected, sleep, or end the process."""
    sched = _current()
    if sched is None:
        return
    if name not in CATALOG:
        raise HorovodTpuError(
            f"fault point {name!r} is not registered in faults.CATALOG")
    sched.fire(name)


def points_hit(name: str) -> int:
    """How many times `name` was hit under the armed schedule (0 when
    disarmed; a point the spec does not name is not counted)."""
    sched = _current()
    return sched.call_count(name) if sched is not None else 0


def injections() -> Dict[Tuple[str, str], int]:
    """What fired so far under the armed schedule, by (point, mode)."""
    sched = _current()
    return dict(sched.injections) if sched is not None else {}
