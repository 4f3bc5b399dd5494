"""Elastic training: the commit / restore / sync protocol.

Counterpart of `horovod_tpu/elastic/__init__.py` (reference:
horovod/common/elastic.py `run_fn`, `State`, `ObjectState`;
horovod/torch/elastic/sampler.py `ElasticSampler`).  The training
function is decorated with `@hvd.elastic.run` and takes a `State`;
`state.commit()` snapshots on the host.  When a collective fails
(`HorovodInternalError`: an injected fault or a failure of the process
group) the wrapper restores the last commit, tears the runtime down and
builds it again (`_reset`: `shutdown()`, then `init()` on the rank's
device under the RESET retry policy), and `state.sync()` broadcasts
from rank 0.  On `HostsUpdatedInterrupt` (`notify_hosts_updated`, seen
at a commit) it resets without the rollback.

What the JAX package has and the port does not yet: the elastic driver
and its worker hooks (joining workers, refreshing the generation from
the control plane, the notification client) come with `runner/`, so a
reset here rejoins the same ranks on the same coordinator; `TpuState`
and `ShardedTpuState` hold JAX pytrees and row shards, and
`torch/elastic.py` `TorchState` takes their place.
"""

from __future__ import annotations

import copy
import functools
import logging
import queue
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .. import faults as _faults
from ..common import basics
from ..common.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from ..faults import RetryPolicy
from ..ops import functions as F
from ..ops import wire as _wire

logger = logging.getLogger("horovod_tpu_torch.elastic")

__all__ = ["State", "ObjectState", "ElasticSampler", "run",
           "notify_hosts_updated"]

# Membership-change notifications (from tests, or later from the driver).
_host_update_queue: "queue.Queue[bool]" = queue.Queue()


def notify_hosts_updated(skip_sync: bool = False) -> None:
    """Report a membership change: the next `commit()` raises
    HostsUpdatedInterrupt (reference: WorkerNotificationManager)."""
    _host_update_queue.put(skip_sync)


class State:
    """Base state with commit / restore / sync (reference:
    horovod/common/elastic.py `State`).  `reset_seconds` holds how long
    each reset of `run` took, from the teardown to the end of the
    sync."""

    def __init__(self, **kwargs):
        self._reset_callbacks: List[Callable[[], None]] = []
        self.reset_seconds: List[float] = []

    def register_reset_callbacks(self, callbacks) -> None:
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self) -> None:
        pass

    def commit(self) -> None:
        _faults.point("state.commit")
        self.save()
        self.check_host_updates()

    def check_host_updates(self) -> None:
        """Raise HostsUpdatedInterrupt if a change was reported."""
        updated = False
        skip_sync = False
        while True:
            try:
                skip = _host_update_queue.get_nowait()
            except queue.Empty:
                break
            updated = True
            skip_sync = skip_sync or skip
        if updated:
            self.on_hosts_updated()
            raise HostsUpdatedInterrupt(skip_sync)

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError


class ObjectState(State):
    """State of picklable attributes (reference: horovod/common/
    elastic.py `ObjectState`).  `save` builds the whole snapshot before
    it replaces the last one, and keeps the one before as a fallback: a
    snapshot that cannot be restored rolls back one more commit."""

    def __init__(self, **kwargs):
        super().__init__()
        self._saved: Dict[str, Any] = {}
        self._prev_saved: Optional[Dict[str, Any]] = None
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._known = list(kwargs.keys())
        self.save()

    def _snapshot(self) -> Dict[str, Any]:
        return {k: copy.deepcopy(getattr(self, k)) for k in self._known}

    def _restore_from(self, saved: Dict[str, Any]) -> None:
        for k in self._known:
            setattr(self, k, copy.deepcopy(saved[k]))

    def save(self) -> None:
        snap = self._snapshot()
        if self._saved:
            self._prev_saved = self._saved
        self._saved = snap

    def restore(self) -> None:
        try:
            self._restore_from(self._saved)
        except Exception:  # noqa: BLE001 — a damaged snapshot
            if not self._prev_saved:
                raise
            logger.warning(
                "last commit unusable — rolling back one more commit")
            self._saved = self._prev_saved
            self._restore_from(self._saved)

    def _sync_scalars(self, names) -> None:
        synced = F.broadcast_object({k: getattr(self, k) for k in names},
                                    root_rank=0)
        for k, v in synced.items():
            setattr(self, k, v)

    def sync(self) -> None:
        self._sync_scalars(self._known)
        self.save()


class ElasticSampler:
    """Shard an index space over the ranks, skipping the indices already
    processed after a reset (reference: horovod/torch/elastic/
    sampler.py)."""

    def __init__(self, num_samples: int, shuffle: bool = True, seed: int = 0):
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: List[int] = []
        self._reset_index_list()

    def _reset_index_list(self):
        idx = np.arange(self.num_samples)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        processed = set(self.processed_indices)
        remaining = [int(i) for i in idx if i not in processed]
        n, r = basics.size(), basics.rank()
        per = len(remaining) // n if n else 0
        self.local_indices = remaining[r * per:(r + 1) * per]

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.processed_indices = []
        self._reset_index_list()

    def record_batch(self, batch_idx: int, batch_size: int):
        start = batch_idx * batch_size
        self.processed_indices.extend(
            self.local_indices[start:start + batch_size])

    def reset(self):
        """After a reset: every rank takes the union of the processed
        indices (one allgather), and the rest are sharded again."""
        all_processed = F.allgather_object(self.processed_indices)
        self.processed_indices = sorted({i for sub in all_processed
                                         for i in sub})
        self._reset_index_list()

    def __iter__(self):
        return iter(self.local_indices)

    def __len__(self):
        return len(self.local_indices)


def _reset() -> None:
    """Tear the runtime down and build it again over the same ranks
    (reference: elastic reset = shutdown + init re-rendezvous): the same
    coordinator, world size, rank and device as the last `init`, under
    `RetryPolicy.from_env("RESET", ...)` (HOROVOD_RESET_RETRY_* tunes
    it).  `shutdown` waits for the collectives still in flight.  Every
    wire error-feedback residual is invalidated first
    (`wire.reset_error_feedback`): one encoded against the old membership
    must not reach the first step after the reset."""
    args = basics.init_arguments()
    _wire.reset_error_feedback()
    basics.shutdown()
    try:
        RetryPolicy.from_env(
            "RESET", max_attempts=15, base_delay=0.5, multiplier=2.0,
            max_delay=2.0, jitter=0.1).run(
            lambda: basics.init(**args), retry_on=(Exception,),
            give_up_on=(HorovodInternalError,), site="elastic.reset")
    except HorovodInternalError:
        raise
    except Exception as e:  # noqa: BLE001 — every attempt failed
        raise HorovodInternalError(
            f"cannot re-rendezvous after a reset: {e}") from e


def run(func: Callable) -> Callable:
    """Decorator for elastic training (reference: horovod/common/
    elastic.py `run_fn`):

        @hvd.elastic.run
        def train(state, ...): ...

    The runner's hooks of the JAX package (a joining worker's first
    sync, the notification client) are absent until `runner/` is
    ported."""

    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        reset_required = False
        skip_sync = False
        while True:
            if reset_required:
                t0 = time.perf_counter()
                _reset()
                state.on_reset()
                if not skip_sync:
                    state.sync()
                state.reset_seconds.append(time.perf_counter() - t0)
                reset_required = False
                skip_sync = False
            try:
                return func(state, *args, **kwargs)
            except HorovodInternalError as e:
                logger.warning("collective failure (%s) — restoring the "
                               "last commit", e)
                state.restore()
                reset_required = True
            except HostsUpdatedInterrupt as e:
                logger.info("hosts updated — re-initializing")
                reset_required = True
                skip_sync = e.skip_sync

    return wrapper
