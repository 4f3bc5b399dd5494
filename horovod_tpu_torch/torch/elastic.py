"""Torch elastic state and the `hvd.elastic` namespace (counterpart of
`horovod_tpu/torch/elastic.py`; reference: horovod/torch/elastic/
state.py `TorchState`).

    state = hvd.elastic.TorchState(model, optimizer, epoch=0,
                                   batch_idx=0, sampler=sampler)

    @hvd.elastic.run
    def train(state):
        ...
        state.commit()
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from ..elastic import (  # noqa: F401  (the hvd.elastic surface)
    ElasticSampler,
    ObjectState,
    State,
    _sync_root,
    notify_hosts_updated,
    run,
)
from . import broadcast_object  # noqa: F401
from . import broadcast_optimizer_state, broadcast_parameters


def _to_host(tree: Any) -> Any:
    """A copy of a state dict with every tensor in host memory, so that
    no later in-place step on the card can reach the snapshot (the JAX
    `TpuState._to_host`)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return type(tree)((k, _to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return copy.deepcopy(tree)


class TorchState(ObjectState):
    """Elastic state of a torch model, its optimizer and scalars.

    `save` copies `model.state_dict()` (buffers included: batch-norm
    statistics) and `optimizer.state_dict()` to host memory; `restore`
    loads them back in place; `sync` broadcasts them from rank 0, or
    under the driver from the lowest rank that holds the job's state
    (`elastic._sync_root`).  An `ElasticSampler` among the scalars is
    kept in place: its epoch and indices are saved and restored, and
    `sync` takes the root's epoch and length (a worker that joined a
    running job has neither), then the
    union of every rank's processed indices, and shards the rest again
    (`ElasticSampler.reset`), as upstream's sampler handler does.

    `on_reset` also drops the `DistributedOptimizer` wrapper's state of
    the failed step (`reset_step_state`): its open bucket, the handles
    of the buckets already in flight, the gradients marked as enqueued,
    and a partial accumulation of `backward_passes_per_step`.  That
    state belongs to the step the restore rolled back.  The JAX shim has
    no such state: its work in flight is XLA programs.  A ZeRO
    optimizer (`zero_stage` >= 1) has no `reset_step_state`: elastic
    ZeRO is the JAX package's `ShardedTpuState`, not ported yet.
    """

    def __init__(self, model: torch.nn.Module = None,
                 optimizer: torch.optim.Optimizer = None, **kwargs):
        self.model = model
        self.optimizer = optimizer
        self._samplers = [k for k, v in kwargs.items()
                          if isinstance(v, ElasticSampler)]
        super().__init__(**kwargs)

    def _scalars(self):
        return [k for k in self._known if k not in self._samplers]

    def _snapshot(self) -> Dict[str, Any]:
        snap = {k: copy.deepcopy(getattr(self, k)) for k in self._scalars()}
        for k in self._samplers:
            s = getattr(self, k)
            snap[k] = (s.epoch, list(s.processed_indices),
                       list(s.local_indices))
        if self.model is not None:
            snap["__model__"] = _to_host(self.model.state_dict())
        if self.optimizer is not None:
            snap["__optimizer__"] = _to_host(self.optimizer.state_dict())
        return snap

    def _restore_from(self, saved: Dict[str, Any]) -> None:
        if self.model is not None:
            self.model.load_state_dict(saved["__model__"])
        if self.optimizer is not None:
            # load_state_dict copies, so the snapshot stays as it is.
            self.optimizer.load_state_dict(saved["__optimizer__"])
        for k in self._samplers:
            s = getattr(self, k)
            s.epoch, processed, local = saved[k]
            s.processed_indices, s.local_indices = list(processed), \
                list(local)
        for k in self._scalars():
            setattr(self, k, copy.deepcopy(saved[k]))

    def on_reset(self) -> None:
        reset = getattr(self.optimizer, "reset_step_state", None)
        if reset is not None:
            reset()
        super().on_reset()

    def sync(self) -> None:
        root = _sync_root(self.holds_state)
        if self.model is not None:
            broadcast_parameters(self.model.state_dict(), root_rank=root)
        if self.optimizer is not None:
            broadcast_optimizer_state(self.optimizer, root_rank=root)
        if self._samplers:
            samplers = [getattr(self, k) for k in self._samplers]
            roots = broadcast_object([(s.epoch, s.num_samples)
                                      for s in samplers], root_rank=root)
            for s, (epoch, num_samples) in zip(samplers, roots):
                s.epoch, s.num_samples = epoch, num_samples
                s.reset()
        self._sync_scalars(self._scalars(), root)
        self.holds_state = True
        self.save()


__all__ = ["ElasticSampler", "ObjectState", "State", "TorchState",
           "broadcast_object", "notify_hosts_updated", "run"]
