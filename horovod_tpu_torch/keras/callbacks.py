"""`horovod_tpu_torch.keras.callbacks` — standalone-Keras callback namespace
(reference: horovod/keras/callbacks.py, delegating to horovod/_keras/
callbacks.py exactly as this delegates to the shared implementation in
horovod_tpu_torch/tensorflow/keras/callbacks.py)."""

from ..tensorflow.keras.callbacks import (  # noqa: F401
    BroadcastGlobalVariablesCallback,
    MetricAverageCallback,
    LearningRateWarmupCallback,
    LearningRateScheduleCallback,
)
