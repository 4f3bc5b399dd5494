"""Keras callbacks (counterpart of `horovod_tpu/tensorflow/keras/
callbacks.py`; reference: horovod/_keras/callbacks.py, re-exported as
horovod.tensorflow.keras.callbacks).

Real `keras.callbacks.Callback` subclasses binding the logic of the
framework-neutral `horovod_tpu_torch.callbacks` to a live Keras model.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import tensorflow as tf
import torch

from ...common import basics
from ...ops import collectives as C

logger = logging.getLogger("horovod_tpu_torch.tensorflow.keras")


class BroadcastGlobalVariablesCallback(tf.keras.callbacks.Callback):
    """Broadcast all model/optimizer variables from `root_rank` at the
    start of training so every rank starts identical (reference:
    BroadcastGlobalVariablesCallbackImpl.on_batch_end after first batch).
    """

    def __init__(self, root_rank: int = 0):
        super().__init__()
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_batch_end(self, batch, logs=None):
        # After the first batch: optimizer slot variables now exist
        # (matches the reference's timing).
        if self.broadcast_done:
            return
        from . import broadcast_model
        broadcast_model(self.model, root_rank=self.root_rank)
        self.broadcast_done = True


class MetricAverageCallback(tf.keras.callbacks.Callback):
    """Average epoch metrics over ranks (reference:
    MetricAverageCallbackImpl — so rank-0's logged/checkpoint metrics
    reflect the whole job)."""

    def on_epoch_end(self, epoch, logs=None):
        if logs:
            for k, v in list(logs.items()):
                try:
                    logs[k] = float(C.allreduce(
                        torch.tensor(float(v), dtype=torch.float32,
                                     device=basics.device()),
                        op=C.Average, name=f"metric.{k}"))
                except (TypeError, ValueError):
                    continue  # non-numeric metric


class LearningRateWarmupCallback(tf.keras.callbacks.Callback):
    """Warm the LR from `initial_lr/size` to `initial_lr` over
    `warmup_epochs` (reference: LearningRateWarmupCallbackImpl — the
    gradual-warmup recipe for large effective batches, Goyal et al.).

    `initial_lr` is the POST-scaling target (base_lr * hvd.size()).
    """

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 steps_per_epoch: Optional[int] = None, verbose: int = 0):
        super().__init__()
        self.initial_lr = initial_lr
        self.warmup_epochs = warmup_epochs
        self.steps_per_epoch = steps_per_epoch
        self.verbose = verbose
        self.current_epoch = 0

    def _set_lr(self, lr: float):
        self.model.optimizer.learning_rate.assign(lr)

    def on_train_begin(self, logs=None):
        if self.steps_per_epoch is None:
            self.steps_per_epoch = self.params.get("steps") or 1

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch

    def on_batch_begin(self, batch, logs=None):
        if self.current_epoch >= self.warmup_epochs:
            return
        n = basics.size()
        progress = (self.current_epoch * self.steps_per_epoch + batch + 1) \
            / (self.warmup_epochs * self.steps_per_epoch)
        lr = self.initial_lr * (progress + (1.0 - progress) / n)
        self._set_lr(lr)

    def on_epoch_end(self, epoch, logs=None):
        if epoch == self.warmup_epochs - 1 and self.verbose:
            logger.info("warmup complete: lr=%s", self.initial_lr)


class LearningRateScheduleCallback(tf.keras.callbacks.Callback):
    """Multiply the LR by `multiplier(epoch)` within [start_epoch,
    end_epoch) (reference: LearningRateScheduleCallbackImpl)."""

    def __init__(self, initial_lr: float, multiplier,
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 staircase: bool = True,
                 steps_per_epoch: Optional[int] = None):
        super().__init__()
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        if callable(multiplier):
            self.multiplier: Callable[[float], float] = multiplier
        else:
            self.multiplier = lambda epoch: multiplier
        self.current_epoch = 0

    def _in_range(self, epoch) -> bool:
        return (epoch >= self.start_epoch
                and (self.end_epoch is None or epoch < self.end_epoch))

    def on_train_begin(self, logs=None):
        if self.steps_per_epoch is None:
            self.steps_per_epoch = self.params.get("steps") or 1

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch
        if self.staircase and self._in_range(epoch):
            self.model.optimizer.learning_rate.assign(
                self.initial_lr * self.multiplier(epoch))

    def on_batch_begin(self, batch, logs=None):
        if self.staircase or not self._in_range(self.current_epoch):
            return
        frac = self.current_epoch + batch / self.steps_per_epoch
        self.model.optimizer.learning_rate.assign(
            self.initial_lr * self.multiplier(frac))
