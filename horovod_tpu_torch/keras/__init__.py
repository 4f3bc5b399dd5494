"""`horovod_tpu_torch.keras` — standalone Keras namespace (reference:
horovod/keras/__init__.py, which mirrors horovod/tensorflow/keras for
standalone-Keras users; both share horovod/_keras/).

Keras ≥3 is multi-backend; this namespace is the entry point for users
importing `horovod.keras` directly.  The implementation is the shared
Keras frontend in `horovod_tpu_torch.tensorflow.keras`.

    import horovod_tpu_torch.keras as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(keras.optimizers.SGD(0.01))
    model.compile(optimizer=opt, ...)
    callbacks = [hvd.callbacks.BroadcastGlobalVariablesCallback(0)]
"""

from ..tensorflow.keras import *  # noqa: F401,F403
from ..tensorflow.keras import (  # noqa: F401
    DistributedOptimizer,
    PartialDistributedOptimizer,
    load_model,
)
from . import callbacks  # noqa: F401  — the local submodules, so
# `horovod_tpu_torch.keras.{callbacks,elastic}` are each one module object
# regardless of whether they are reached by attribute or by import.
from . import elastic  # noqa: F401
