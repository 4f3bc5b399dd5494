"""Core runtime state: initialization, ranks, the device, the global
process set.

Counterpart of `horovod_tpu/common/basics.py`.  The JAX package builds
a device mesh and lets XLA compile the collectives into the program;
here one process drives one rank on one device, and the collectives run
through a `torch.distributed` process group:

- NCCL when every local rank has a card of its own;
- gloo when local ranks share a card (NCCL refuses two ranks on one
  device) or when the rank runs on the CPU (`init(device="cpu")`).

Multi-process bootstrap reads the env that `horovodrun_tpu` injects:
HOROVOD_COORDINATOR_ADDR (host:port of rank 0's store, or a full
`tcp://` / `file://` init URL), HOROVOD_NUM_PROCESSES, HOROVOD_PROCESS_ID,
and HOROVOD_LOCAL_RANK / HOROVOD_LOCAL_SIZE.  With no coordinator the
job is one rank and the collectives return their local result.

`shutdown()` then `init()` bootstraps again on the same coordinator, as
often as elastic recovery needs: the key-value store behind the
coordinator address is built once per process and outlives the process
groups, and each group gets a generation of its own in it
(`PrefixStore("gen<g>")`).  Building a store afresh each time would not
do: a `file://` store deletes its file when its last user closes it, so
a fast rank could join the old file or lose the new one, and at
`tcp://` rank 0 would bind the port again while clients may still reach
the old server.  Under the elastic driver each generation names a
coordinator of its own, and a worker that joins another generation
drops the cached store first (`forget_store`).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import threading
import urllib.parse
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from . import util
from .exceptions import HorovodTpuError, NotInitializedError

logger = logging.getLogger("horovod_tpu_torch")


@dataclasses.dataclass
class ProcessSet:
    """A set of ranks with its own process group (reference:
    horovod/common/process_set.cc).  The global set is id 0;
    `add_process_set` registers the others over `dist.new_group`.
    `group` is None when the job has no process group (one rank)."""

    ranks: List[int]
    process_set_id: int = 0
    group: Optional[object] = None
    # remove_process_set or shutdown ran: collectives refuse the set
    removed: bool = False

    def size(self) -> int:
        return len(self.ranks)

    @property
    def comm(self) -> Optional[object]:
        """The group the set's collectives run over, or None when there
        is nothing to exchange: one rank, or no process group.  A
        collective over one rank is the identity (the JAX package's
        compiled collectives over a one-device axis do no work)."""
        return self.group if len(self.ranks) > 1 else None

    def included(self) -> bool:
        return _state().rank in self.ranks

    def rank(self) -> int:
        r = _state().rank
        if r not in self.ranks:
            raise HorovodTpuError(
                f"process set {self.process_set_id} does not include "
                f"rank {r}")
        return self.ranks.index(r)

    def __repr__(self):
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


@dataclasses.dataclass
class _GlobalState:
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int
    device: torch.device
    backend: Optional[str]  # None: one rank, no process group
    global_set: ProcessSet
    process_sets: Dict[int, ProcessSet] = dataclasses.field(
        default_factory=dict)
    next_set_id: int = 1
    # The process group's store (this generation's prefix of the
    # coordinator's), None for one rank: the stall reporter's KV.
    kv: Optional[object] = None


_global_state: Optional[_GlobalState] = None
_init_lock = threading.Lock()

# The coordinator's store, kept across shutdown/init: (url, size) -> the
# store and the number of process groups built on it so far.
_store_key: Optional[Tuple[str, int]] = None
_store: Optional[object] = None
_generation = 0
# The stores of the coordinators this process left for another, kept for
# its return (a world of one between two of the job's): (url, size) ->
# (store, generation).
_parked: Dict[Tuple[str, int], Tuple[object, int]] = {}
# The arguments of the last init(), resolved (see init_arguments).
_init_args: Optional[dict] = None


def _state() -> _GlobalState:
    if _global_state is None:
        raise NotInitializedError()
    return _global_state


def is_initialized() -> bool:
    return _global_state is not None


def _resolve_device(device: Union[str, torch.device, None],
                    local_rank: int) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise HorovodTpuError(
                "no CUDA device is visible; pass init(device='cpu') to run "
                "the ranks on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise HorovodTpuError(f"device {device} requested, but no CUDA "
                                  "device is visible")
        if device.index is None:
            device = torch.device(
                "cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise HorovodTpuError(f"unsupported device {device}")
    return device


def _choose_backend(device: torch.device, local_size: int) -> str:
    if device.type == "cpu":
        return "gloo"
    if local_size <= torch.cuda.device_count():
        return "nccl"
    # Local ranks share a card: NCCL refuses two ranks on one device.
    return "gloo"


# Under the elastic driver: how long past the driver's deadline for a
# silent new worker a rank waits for the others of its generation at the
# bootstrap.
ELASTIC_BOOTSTRAP_MARGIN_S = 5.0


def _bootstrap_timeout() -> datetime.timedelta:
    """The timeout of the coordinator store and the process group.
    Outside the elastic driver torch's default (30 minutes).  Under it
    (HOROVOD_ELASTIC=1) the driver's deadline for a new worker that has
    not beaten yet, the larger of its start grace and lease TTL (both
    set in the worker's env), plus ELASTIC_BOOTSTRAP_MARGIN_S: a rank of
    the generation that dies or hangs before its bootstrap has been
    failed by then and a newer generation published, so the waiting
    ranks' bootstrap raises and the reset's retry joins the newer one.
    The timeout also bounds each collective's wait over gloo, as
    upstream's HOROVOD_GLOO_TIMEOUT_SECONDS does."""
    if util.getenv("ELASTIC") != "1":
        return dist.constants.default_pg_timeout
    silent = max(util.env_float("ELASTIC_START_GRACE", 60.0),
                 util.env_float("ELASTIC_LEASE_TTL", 15.0))
    return datetime.timedelta(seconds=silent + ELASTIC_BOOTSTRAP_MARGIN_S)


def _generation_store(url: str, rank: int, size: int):
    """The store of the next process group on `url`: a prefix of its own
    in the process's one store for that coordinator."""
    global _store_key, _store, _generation
    key = (url, size)
    if _store_key != key and _store_key is not None:
        _parked[_store_key] = (_store, _generation)
    if _store_key != key and key in _parked:
        _store_key = key
        _store, _generation = _parked.pop(key)
    elif _store_key != key:
        parsed = urllib.parse.urlparse(url)
        if parsed.scheme == "file":
            store = dist.FileStore(parsed.path, size)
        elif parsed.scheme == "tcp":
            store = dist.TCPStore(parsed.hostname, parsed.port, size,
                                  rank == 0, timeout=_bootstrap_timeout())
        else:
            raise HorovodTpuError(
                f"coordinator address {url!r}: want host:port, tcp:// or "
                "file://")
        _store_key, _store, _generation = key, store, 0
    return dist.PrefixStore(f"gen{_generation}", _store)


def forget_store() -> None:
    """Drop the cached coordinator store and those this process left
    (with their servers, where this rank bound them): the next `init()` builds the store of the
    coordinator it is given.  An elastic generation has a coordinator of
    its own, so the worker drops the store when it joins another
    generation (`runner/elastic_worker.refresh_from_control_plane`)."""
    global _store_key, _store, _generation
    _store_key, _store, _generation = None, None, 0
    _parked.clear()


def init(*, coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         device: Union[str, torch.device, None] = None) -> None:
    """Initialize the runtime (reference: operations.cc `horovod_init`).

    `device`: the counterpart of the JAX package's `devices=` argument.
    The default is `cuda:{local_rank % device_count}`; `"cpu"` runs the
    rank on the CPU over gloo.  With no argument and no CUDA device,
    `init` raises.

    A worker the elastic driver spawned (HOROVOD_ELASTIC=1) registers
    with it first, unless it has already: the driver spawns workers with
    no coordinator, and the registration sets the generation's rank,
    size and coordinator in the env read below.
    """
    global _global_state, _generation, _init_args
    if coordinator_address is None and _global_state is None:
        from ..runner import elastic_worker
        elastic_worker.register()
    with _init_lock:
        if _global_state is not None:
            logger.debug("horovod_tpu_torch.init() called twice; ignoring")
            return
        coordinator_address = (coordinator_address
                               or util.getenv("COORDINATOR_ADDR"))
        if coordinator_address:
            size = num_processes or util.env_int("NUM_PROCESSES", 1)
            rank = (process_id if process_id is not None
                    else util.env_int("PROCESS_ID", 0))
        else:
            size, rank = 1, 0
        local_rank = util.env_int("LOCAL_RANK", rank)
        local_size = util.env_int("LOCAL_SIZE", size)
        cross_rank = util.env_int("CROSS_RANK", rank // max(local_size, 1))
        cross_size = util.env_int("CROSS_SIZE",
                                  max(size // max(local_size, 1), 1))
        dev = _resolve_device(device, local_rank)
        backend = None
        group = kv = None
        if coordinator_address:
            backend = _choose_backend(dev, local_size)
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
            kv = _generation_store(url, rank, size)
            dist.init_process_group(backend, store=kv, world_size=size,
                                    rank=rank, timeout=_bootstrap_timeout())
            _generation += 1
            group = dist.group.WORLD
        _init_args = dict(coordinator_address=coordinator_address,
                          num_processes=size, process_id=rank, device=dev)
        global_set = ProcessSet(ranks=list(range(size)), group=group)
        _global_state = _GlobalState(
            rank=rank, size=size, local_rank=local_rank,
            local_size=local_size, cross_rank=cross_rank,
            cross_size=cross_size, device=dev, backend=backend,
            global_set=global_set, process_sets={0: global_set},
            kv=kv if size > 1 else None)
        logger.info(
            "horovod_tpu_torch initialized: rank=%d size=%d local=%d/%d "
            "device=%s backend=%s", rank, size, local_rank, local_size,
            dev, backend or "none (one rank)")
    # The runtime instruments, env-gated as in the JAX package
    # (horovod_tpu/common/basics.py:238-262): HOROVOD_TIMELINE, the stall
    # inspector (on unless HOROVOD_STALL_CHECK_DISABLE=1), the tuner; the
    # metrics endpoint (HOROVOD_METRICS_PORT), the fallback fleet
    # publisher (only where the watchdog, which publishes itself, is
    # off) and the history sampler (HOROVOD_METRICS_HISTORY_INTERVAL).
    from ..metrics import exposition, fleet, history
    from ..utils import autotune, stall_inspector, timeline

    timeline.init_from_env(rank)
    stall_inspector.init_from_env()
    autotune.init_from_env()
    exposition.init_from_env(rank, size)
    fleet.maybe_start_kv_publisher()
    history.init_from_env()


def kv_store() -> Optional[object]:
    """The process group's key-value store (a c10d store), or None for a
    one-rank job."""
    return _state().kv


def init_arguments() -> dict:
    """The last `init()`'s arguments as it resolved them (coordinator,
    world size, rank, device): what an elastic reset calls `init` with
    again."""
    if _init_args is None:
        raise NotInitializedError()
    return dict(_init_args)


def shutdown() -> None:
    """Tear down the runtime (reference: operations.cc
    `horovod_shutdown`): wait for the collectives still in flight (their
    results are dropped), release the process group so that a later
    `init()` can bootstrap afresh, and mark every process set removed,
    so that a set a caller still holds refuses to run rather than wait
    on a group that is gone.  The stall watchdog, the fleet publisher and
    the timeline stop first (the watchdog and the publisher read the
    group's store); the autotuner, the history sampler and the metrics
    endpoint go with them, as in the JAX package."""
    global _global_state
    from ..metrics import exposition, fleet, history
    from ..ops import collectives, join
    from ..utils import autotune, consistency, stall_inspector, timeline

    with _init_lock:
        if _global_state is None:
            return
        st = _global_state
        stall_inspector.shutdown_inspector()
        fleet.stop_kv_publisher()
        timeline.stop_timeline()
        collectives.HandleManager.global_instance().drain()
        if st.device.type == "cuda":
            torch.cuda.synchronize(st.device)
        if st.backend is not None and dist.is_initialized():
            dist.destroy_process_group()
        for ps in st.process_sets.values():
            ps.group, ps.removed = None, True
        _global_state = None
        join.reset()
        consistency.reset()
        autotune.shutdown_manager()
        history.stop_history()
        exposition.stop_server()


def autotune_record_step(items: float = 1.0) -> None:
    """Feed the autotuner one training step of `items` samples or tokens
    (nothing unless HOROVOD_AUTOTUNE=1; JAX `horovod_tpu/__init__.py`
    :177).  Every rank calls it once per step."""
    from ..utils import autotune

    mgr = autotune.get_manager()
    if mgr is not None:
        mgr.record_step(items)


# ---------------------------------------------------------------------------
# Rank / size queries
# ---------------------------------------------------------------------------

def size() -> int:
    return _state().size


def rank() -> int:
    return _state().rank


def local_size() -> int:
    return _state().local_size


def local_rank() -> int:
    return _state().local_rank


def cross_size() -> int:
    return _state().cross_size


def cross_rank() -> int:
    return _state().cross_rank


def process_index() -> int:
    """This process's index among the job's processes: its rank (one
    rank a process; JAX basics.process_index counts hosts' processes,
    each driving several chips)."""
    return _state().rank


def num_processes() -> int:
    """The job's process count: its size (one rank a process)."""
    return _state().size


def local_device_ranks() -> List[int]:
    """The global ranks of the devices this process drives: its own."""
    return [_state().rank]


def is_homogeneous() -> bool:
    """True when every host runs the same number of ranks."""
    st = _state()
    return st.size == st.local_size * st.cross_size


def device() -> torch.device:
    """The device this rank's tensors and collectives live on."""
    return _state().device


def backend() -> Optional[str]:
    """"nccl", "gloo", or None for a one-rank job."""
    return _state().backend


def global_process_set() -> ProcessSet:
    return _state().global_set


# ---------------------------------------------------------------------------
# Process sets (reference: horovod/common/process_sets.py; JAX package
# common/basics.py add_process_set :477, remove_process_set :495)
# ---------------------------------------------------------------------------

def add_process_set(ranks: Sequence[int]) -> ProcessSet:
    """Register a process set over `ranks` with a process group of its
    own.  `dist.new_group` is collective: every rank calls this, in the
    same order, members of the set or not.  Ids count up from 1 in the
    order of registration, as in the JAX package."""
    st = _state()
    ranks = sorted(int(r) for r in ranks)
    if len(set(ranks)) != len(ranks):
        dups = sorted({r for r in ranks if ranks.count(r) > 1})
        raise HorovodTpuError(
            f"process set ranks contain duplicates {dups}: each rank "
            "may appear at most once")
    if any(r < 0 or r >= st.size for r in ranks):
        raise HorovodTpuError(f"process set ranks {ranks} out of range")
    with _init_lock:
        for existing in st.process_sets.values():
            if existing.ranks == ranks:
                raise HorovodTpuError(
                    f"A process set with ranks {ranks} already exists "
                    f"(id={existing.process_set_id})")
        ps_id = st.next_set_id
        st.next_set_id += 1
    group = dist.new_group(ranks) if st.backend is not None else None
    ps = ProcessSet(ranks=ranks, process_set_id=ps_id, group=group)
    with _init_lock:
        st.process_sets[ps_id] = ps
    return ps


def remove_process_set(ps: ProcessSet) -> None:
    """Drop a process set: it leaves the table and its collectives raise
    from then on.  Its group is destroyed on the ranks that belong to
    it (a rank outside holds no group to destroy)."""
    st = _state()
    if ps.process_set_id == 0:
        raise HorovodTpuError("Cannot remove the global process set")
    with _init_lock:
        if st.process_sets.pop(ps.process_set_id, None) is None:
            raise HorovodTpuError(
                f"Unknown process set id {ps.process_set_id}")
    group, ps.group = ps.group, None
    ps.removed = True
    if group is not None and st.rank in ps.ranks:
        dist.destroy_process_group(group)


def get_process_set(ps_id: int) -> ProcessSet:
    try:
        return _state().process_sets[ps_id]
    except KeyError:
        raise HorovodTpuError(f"Unknown process set id {ps_id}") from None


# ---------------------------------------------------------------------------
# Build-info queries (reference: basics.py nccl_built/mpi_built/...)
# ---------------------------------------------------------------------------

def tpu_built() -> bool:
    return False


def xla_built() -> bool:
    return False


def mpi_built() -> bool:
    return dist.is_available() and dist.is_mpi_available()


def nccl_built() -> bool:
    return dist.is_available() and dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_available() and dist.is_gloo_available()


def ccl_built() -> bool:
    return False


def cuda_built() -> bool:
    return torch.backends.cuda.is_built()


def rocm_built() -> bool:
    return torch.version.hip is not None


def ddl_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def gloo_enabled() -> bool:
    return gloo_built()


def mpi_threads_supported() -> bool:
    return False
