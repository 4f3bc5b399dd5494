"""Continuous-batching inference serving over the decode stack
(counterpart of `horovod_tpu/serve/`):

  - pool.py      paged KV-cache pool (PagedKVPool, PoolExhaustedError)
  - scheduler.py per-step admit/evict scheduler (ContinuousScheduler)
  - slo.py       SLO-aware speculative-decode toggling (SloController)
  - server.py    the decode loop tying them together (InferenceServer)
  - loadgen.py   seeded load generator and run stats (make_trace, ...)
  - replica.py   elastic multi-replica serving (ReplicaManager)
  - flightrec.py always-on flight recorder (FlightRecorder)
  - handoff.py   train-to-serve reshard without a full gather
  - autoscale.py traffic-driven fleet autoscaling (AutoscaleController)
"""

from .autoscale import (
    AutoscaleConfig,
    AutoscaleController,
    BorrowLedger,
    ReplicaFleetActuator,
    SignalSnapshot,
    simulate_autoscale,
    snapshot_from_manager,
    snapshot_from_server,
)
from .flightrec import FlightRecorder, dump_all, load_dump
from .handoff import (
    fetch_decode_params,
    handoff_meta,
    publish_for_serve,
    restore_train_state,
    stash_train_state,
)
from .pool import PagedKVPool, PoolExhaustedError
from .scheduler import (
    ActiveSeq,
    ContinuousScheduler,
    DEFAULT_TENANT_PRIORITY,
    POLICIES,
    Request,
)
from .server import InferenceServer
from .slo import SloController

__all__ = [
    "ActiveSeq",
    "AutoscaleConfig",
    "AutoscaleController",
    "BorrowLedger",
    "ContinuousScheduler",
    "DEFAULT_TENANT_PRIORITY",
    "FlightRecorder",
    "InferenceServer",
    "fetch_decode_params",
    "handoff_meta",
    "publish_for_serve",
    "restore_train_state",
    "stash_train_state",
    "simulate_autoscale",
    "snapshot_from_manager",
    "snapshot_from_server",
    "POLICIES",
    "PagedKVPool",
    "PoolExhaustedError",
    "ReplicaFleetActuator",
    "Request",
    "SignalSnapshot",
    "SloController",
    "dump_all",
    "load_dump",
]
