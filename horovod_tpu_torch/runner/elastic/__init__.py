"""Elastic launcher: discovery, registration, the driver (counterpart of
`horovod_tpu/runner/elastic/`).

Reference parity map (SURVEY.md §2.5 elastic rows, §3.5):
  - horovod/runner/elastic/discovery.py    → `discovery.py`
  - horovod/runner/elastic/registration.py → `registration.py`
  - horovod/runner/elastic/driver.py       → `driver.py`
  - horovod/runner/elastic/worker.py       → `../elastic_worker.py`

As in the JAX package, the rendezvous KV store is the membership
authority in place of the reference's per-worker HTTP services: the
driver publishes numbered generations (`elastic/gen/{g}/info`), then
bumps `elastic/current_gen`; workers poll the counter, and at their next
commit tear their process group down and build the one the new
generation names (its own coordinator, size and ranks).  Hosts join and
leave in whole-worker units.
"""

from .discovery import FixedHosts, HostDiscovery, HostDiscoveryScript  # noqa: F401
from .registration import WorkerStateRegistry  # noqa: F401
