"""Continuous-batching inference serving over the decode stack
(counterpart of `horovod_tpu/serve/`):

  - pool.py      paged KV-cache pool (PagedKVPool, PoolExhaustedError)
  - scheduler.py per-step admit/evict scheduler (ContinuousScheduler)
  - slo.py       SLO-aware speculative-decode toggling (SloController)
  - server.py    the decode loop tying them together (InferenceServer)
  - loadgen.py   seeded load generator and run stats (make_trace, ...)
  - flightrec.py always-on flight recorder (FlightRecorder)

The JAX package's replica.py (elastic multi-replica serving),
handoff.py (train-to-serve reshard) and autoscale.py wait for the port
of the runner, the elastic registration and parallel/reshard.py.
"""

from .flightrec import FlightRecorder, dump_all, load_dump
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
    "ContinuousScheduler",
    "DEFAULT_TENANT_PRIORITY",
    "FlightRecorder",
    "InferenceServer",
    "POLICIES",
    "PagedKVPool",
    "PoolExhaustedError",
    "Request",
    "SloController",
    "dump_all",
    "load_dump",
]
