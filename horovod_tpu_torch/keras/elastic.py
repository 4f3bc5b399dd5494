"""`horovod_tpu_torch.keras.elastic` — standalone-Keras elastic namespace
(reference: horovod/keras/elastic.py delegating to horovod/_keras/
elastic.py, as this delegates to the shared tf.keras implementation)."""

from ..tensorflow.keras.elastic import (  # noqa: F401
    KerasState,
    CommitStateCallback,
    UpdateBatchStateCallback,
    UpdateEpochStateCallback,
)
