"""Elastic Keras integration (counterpart of `horovod_tpu/tensorflow/
keras/elastic.py`; reference: horovod/tensorflow/keras/elastic.py +
shared impl horovod/_keras/elastic.py).

`KerasState` snapshots model + optimizer weights host-side; the three
callbacks drive the commit/progress protocol from inside `model.fit`:

    state = hvd.elastic.KerasState(model, batch=0, epoch=0)

    @hvd.elastic.run
    def train(state):
        model.fit(dataset, initial_epoch=state.epoch, callbacks=[
            hvd.elastic.CommitStateCallback(state),
            hvd.elastic.UpdateBatchStateCallback(state),
            hvd.elastic.UpdateEpochStateCallback(state),
        ])
"""

from __future__ import annotations

import tensorflow as tf

from ..elastic import TensorFlowKerasState as KerasState  # noqa: F401


class CommitStateCallback(tf.keras.callbacks.Callback):
    """Commit the state every `batches_per_commit` batches (reference:
    _keras/elastic.py CommitStateCallbackImpl).  A commit snapshots
    host-side and raises HostsUpdatedInterrupt at the boundary when the
    driver has pushed a membership change."""

    def __init__(self, state, batches_per_commit: int = 1):
        super().__init__()
        if int(batches_per_commit) < 1:
            raise ValueError(
                f"batches_per_commit must be >= 1, got {batches_per_commit}")
        self.state = state
        self.batches_per_commit = int(batches_per_commit)
        self.batches_remaining = self.batches_per_commit

    def on_batch_end(self, batch, logs=None):
        self.batches_remaining -= 1
        if self.batches_remaining == 0:
            self.state.commit()
            self.batches_remaining = self.batches_per_commit


class UpdateBatchStateCallback(tf.keras.callbacks.Callback):
    """Track the in-epoch batch index in `state.batch`, resetting at
    epoch end (reference: UpdateBatchStateCallbackImpl).  On a restart
    into the same epoch, upstream shrinks the resumed epoch by the
    already-committed batches via the on_epoch_begin `params['steps']`
    adjustment; that is honored by the Keras-2 training loop and kept
    here for parity, but the Keras-3 loop ignores callback params — on
    Keras 3 feed fit a PERSISTENT dataset iterator with
    `steps_per_epoch` so a resumed epoch continues from where the
    iterator stopped (the JAX package's docs/ELASTIC.md), or treat the commit as
    epoch-granular with `batches_per_commit >= steps_per_epoch`."""

    def __init__(self, state):
        super().__init__()
        self.state = state

    def on_epoch_begin(self, epoch, logs=None):
        if (self.state.epoch == epoch and self.state.batch > 0
                and isinstance(self.params, dict)
                and self.params.get("steps")):
            self.params["steps"] -= self.state.batch

    def on_batch_end(self, batch, logs=None):
        self.state.batch = batch + 1

    def on_epoch_end(self, epoch, logs=None):
        self.state.batch = 0


class UpdateEpochStateCallback(tf.keras.callbacks.Callback):
    """Track the completed-epoch count in `state.epoch` (reference:
    UpdateEpochStateCallbackImpl); pass `initial_epoch=state.epoch` to
    fit so a restarted worker resumes at the right epoch."""

    def __init__(self, state):
        super().__init__()
        self.state = state

    def on_epoch_end(self, epoch, logs=None):
        self.state.epoch = epoch + 1


__all__ = ["KerasState", "CommitStateCallback",
           "UpdateBatchStateCallback", "UpdateEpochStateCallback"]
