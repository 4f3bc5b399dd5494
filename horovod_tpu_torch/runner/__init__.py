"""Launcher / CLI / cluster bootstrap (counterpart of
`horovod_tpu/runner/`; reference: horovod/runner/).

Reference parity map (SURVEY.md §2.5, §3.1):
  - horovod/runner/launch.py (`horovodrun`, `parse_args`, `run_commandline`)
      → `launch.py` (`horovodrun_tpu_torch`,
        `python -m horovod_tpu_torch.runner`)
  - horovod/runner/__init__.py `run()`         → `run()` below
  - horovod/runner/common/util/hosts.py        → `hosts.py`
  - horovod/runner/common/util/settings.py     → `settings.py`
  - horovod/runner/common/util/safe_shell_exec.py → `safe_exec.py`
  - horovod/runner/http/http_server.py (RendezvousServer KV)
      → `rendezvous.py` (TCP KV store, the JAX package's wire protocol)
  - horovod/runner/gloo_run.py                 → `exec_run.py`
  - horovod/ray/runner.py (RayExecutor, ElasticRayExecutor)
      → `executor.py` (`Executor`, `ElasticExecutor`)
  - horovod/runner/elastic/ (discovery, registration, driver)
      → `elastic/`; horovod/runner/elastic/worker.py → `elastic_worker.py`

One worker process per slot, one GPU per process: each worker's
`hvd.init()` bootstraps its process group over rank 0's c10d TCPStore
(HOROVOD_COORDINATOR_ADDR), and the KV rendezvous store carries the rest
of the control plane (results, commands, the consistency check, the
metrics fleet, heartbeats) and, in elastic jobs
(--host-discovery-script), the driver's numbered generations.
"""

from .api import run  # noqa: F401
from .hosts import (  # noqa: F401
    HostInfo,
    SlotInfo,
    parse_hosts,
    parse_hostfile,
    get_host_assignments,
)
from .settings import Settings  # noqa: F401
