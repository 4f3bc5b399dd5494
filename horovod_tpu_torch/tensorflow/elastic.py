"""TensorFlow/Keras elastic state (counterpart of
`horovod_tpu/tensorflow/elastic.py`; reference: horovod/tensorflow/
elastic.py `TensorFlowKerasState`): host-side weight snapshots and a
sync that broadcasts rank 0's, over the port's `elastic.ObjectState`
and `ops.functions.broadcast_object`.

    state = hvd.elastic.TensorFlowKerasState(model, optimizer, epoch=0)

The shared elastic surface is re-exported as the port's `elastic` has
it: the JAX package's `TpuState` has no counterpart (the torch
frontend's `TorchState` holds a torch model's state).
"""

from __future__ import annotations

from typing import Any, Optional

# Re-export the shared elastic surface so `hvd.elastic.*` works from the
# TF namespace exactly like the reference's horovod.tensorflow.elastic.
from ..elastic import (  # noqa: F401
    ElasticSampler,
    ObjectState,
    State,
    notify_hosts_updated,
    run,
)
from ..ops.functions import broadcast_object


class TensorFlowState(ObjectState):
    """Elastic state over raw tf.Variables (reference:
    tensorflow/elastic.py `TensorFlowState` — the non-Keras form used
    with custom training loops).

    Pass the variables to track (or none to track nothing but the
    ObjectState scalars); save/restore snapshot host-side numpy copies;
    sync broadcasts rank 0's values.
    """

    def __init__(self, variables=None, **kwargs):
        self.variables = list(variables) if variables is not None else []
        self._values = None
        super().__init__(**kwargs)

    def save(self) -> None:
        self._values = [v.numpy() for v in self.variables]
        super().save()

    def restore(self) -> None:
        if self._values is not None:
            for var, val in zip(self.variables, self._values):
                var.assign(val)
        super().restore()

    def sync(self) -> None:
        if self.variables:
            synced = broadcast_object(
                [v.numpy() for v in self.variables], root_rank=0)
            for var, val in zip(self.variables, synced):
                var.assign(val)
        super().sync()


class TensorFlowKerasState(ObjectState):
    """Elastic state for a Keras model (+ optimizer variables + scalars).

    save(): snapshots `model.get_weights()` (numpy, host memory);
    restore(): `set_weights`; sync(): broadcasts rank 0's weights to
    all (reference: TensorFlowKerasState's _broadcast_model).
    """

    def __init__(self, model=None, optimizer: Optional[Any] = None,
                 **kwargs):
        self.model = model
        # Reference default: a compiled model's own optimizer is part of
        # the state (slot variables must restore/sync with the weights).
        self.optimizer = optimizer or getattr(model, "optimizer", None)
        self._weights: Any = None
        self._opt_vars: Any = None
        super().__init__(**kwargs)

    def _opt_var_objs(self):
        """Keras 2 exposes `optimizer.variables()` (method); Keras 3
        makes it a property returning the list."""
        if self.optimizer is None:
            return []
        vs = getattr(self.optimizer, "variables", [])
        return vs() if callable(vs) else list(vs)

    def _opt_variables(self):
        if self.optimizer is None:
            return None
        return [v.numpy() for v in self._opt_var_objs()]

    def save(self) -> None:
        if self.model is not None:
            self._weights = self.model.get_weights()
        self._opt_vars = self._opt_variables()
        super().save()

    def restore(self) -> None:
        if self.model is not None and self._weights is not None:
            self.model.set_weights(self._weights)
        if self.optimizer is not None and self._opt_vars:
            for var, val in zip(self._opt_var_objs(), self._opt_vars):
                var.assign(val)
        super().restore()

    def sync(self) -> None:
        if self.model is not None:
            synced = broadcast_object(self.model.get_weights(), root_rank=0)
            self.model.set_weights(synced)
        if self.optimizer is not None:
            vs = self._opt_variables()
            if vs:
                synced = broadcast_object(vs, root_rank=0)
                for var, val in zip(self._opt_var_objs(), synced):
                    var.assign(val)
        super().sync()


__all__ = ["TensorFlowState",
    "TensorFlowKerasState", "broadcast_object"]
