"""Training-loop callbacks (counterpart of `horovod_tpu/callbacks.py`;
reference: horovod/_keras/callbacks.py).

The framework-neutral forms of the reference's four Keras callbacks, on
trees of torch tensors.  A loop drives them explicitly, state in and
state out:

    cbs = [hvd.callbacks.BroadcastGlobalVariablesCallback(0),
           hvd.callbacks.MetricAverageCallback(),
           hvd.callbacks.LearningRateWarmupCallback(5, 1e-3)]
    params = cbs[0].on_train_begin(params)

The Keras bindings are `horovod_tpu_torch.tensorflow.keras.callbacks`.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import torch

from .common import basics
from .ops import collectives as C
from .ops import functions as F

logger = logging.getLogger("horovod_tpu_torch.callbacks")


class BroadcastGlobalVariablesCallback:
    """Broadcast the initial state from `root_rank` once, before
    training, so that every rank starts from the same tree."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank
        self._done = False

    def on_train_begin(self, state: Any) -> Any:
        if self._done:
            return state
        self._done = True
        return F.broadcast_parameters(state, root_rank=self.root_rank)


class MetricAverageCallback:
    """Average each metric over the ranks at the end of an epoch."""

    def on_epoch_end(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        return {k: C.allreduce(torch.as_tensor(v).to(basics.device()),
                               op=C.Average, name=f"metric.{k}")
                for k, v in metrics.items()}


class LearningRateWarmupCallback:
    """Linear warmup from `initial_lr / size` to `initial_lr` over
    `warmup_epochs` (the reference's gradual warmup for large effective
    batches); `lr(epoch, batches_per_epoch, batch)` returns `initial_lr`
    after it."""

    def __init__(self, warmup_epochs: int, initial_lr: float,
                 verbose: bool = False):
        self.warmup_epochs = warmup_epochs
        self.initial_lr = initial_lr
        self.size = basics.size() if basics.is_initialized() else 1
        self.verbose = verbose

    def lr(self, epoch: int, batches_per_epoch: int = 1,
           batch: int = 0) -> float:
        if epoch >= self.warmup_epochs:
            return self.initial_lr
        progress = (epoch * batches_per_epoch + batch) / max(
            1, self.warmup_epochs * batches_per_epoch)
        start = self.initial_lr / self.size
        lr = start + (self.initial_lr - start) * progress
        if self.verbose and batch == 0:
            logger.info("warmup epoch %d: lr=%.6f", epoch, lr)
        return lr


class LearningRateScheduleCallback:
    """Piecewise LR multipliers by epoch range: `schedule` is a list of
    {"start_epoch": s, "end_epoch": e, "multiplier": m}; the first row
    that holds the epoch wins, and `m` may be a callable of the epoch."""

    def __init__(self, schedule, initial_lr: float):
        self.schedule = schedule
        self.initial_lr = initial_lr

    def lr(self, epoch: int) -> float:
        for row in self.schedule:
            if row["start_epoch"] <= epoch < row.get("end_epoch", 1 << 31):
                m = row["multiplier"]
                return self.initial_lr * (m(epoch) if callable(m) else m)
        return self.initial_lr
