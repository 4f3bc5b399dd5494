"""Keras Spark estimator (counterpart of
`horovod_tpu/spark/keras/__init__.py`).

Reference parity: `horovod/spark/keras/` (`KerasEstimator`,
`KerasModel`, `remote.py` ≈1.5k LoC) — `KerasEstimator.fit(df)` trains
a tf.keras model across workers and returns a `KerasModel` transformer.

Mechanism mapping:
  - reference `remote.py RemoteTrainer`: Petastorm reader feeding
    `model.fit`, `hvd.keras.DistributedOptimizer`, broadcast callback →
    here `_keras_remote_trainer` loads this rank's `.npy` shard and uses
    the same frontend pieces (`horovod_tpu_torch.tensorflow.keras`);
  - reference model codec (`keras/util.py` serialize/deserialize via h5)
    → architecture JSON + weight arrays, pickled (no h5py dependency);
  - rank-0 checkpointing into the store's run path (reference:
    `ModelCheckpoint` → `store.get_checkpoint_path`).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np

from ...common.exceptions import HorovodTpuError
from ..common.estimator import HorovodEstimator, HorovodModel
from ..common.store import save_checkpoint
from ..common.data_loader import ShardDataLoader
from ..common.util import load_val, resolve_compression


def _serialize_keras(model, optimizer, loss, metrics, custom_objects):
    import tensorflow as tf

    opt_cfg = (tf.keras.optimizers.serialize(optimizer)
               if optimizer is not None else None)
    return pickle.dumps({
        "arch_json": model.to_json(),
        "weights": model.get_weights(),
        "optimizer": opt_cfg,
        "loss": loss,
        "metrics": metrics,
        "custom_objects": custom_objects,
    })


def _deserialize_keras(blob: bytes):
    """Returns (model, optimizer, loss, metrics, raw_dict) — the raw
    dict is reused for arch_json to avoid a second full unpickle."""
    import tensorflow as tf

    d = pickle.loads(blob)
    model = tf.keras.models.model_from_json(
        d["arch_json"], custom_objects=d["custom_objects"])
    model.set_weights(d["weights"])
    opt = (tf.keras.optimizers.deserialize(d["optimizer"])
           if d["optimizer"] is not None else None)
    return model, opt, d["loss"], d["metrics"], d


def _keras_remote_trainer(spec: Dict[str, Any]):
    """Per-worker training fn (reference: keras/remote.py RemoteTrainer)."""
    import tensorflow as tf

    import horovod_tpu_torch.tensorflow.keras as hvd_k

    hvd_k.init(device=spec.get("device"))
    if spec["seed"] is not None:
        tf.keras.utils.set_random_seed(spec["seed"] + hvd_k.rank())

    model, opt, loss, metrics, raw = _deserialize_keras(
        spec["model_bytes"])
    if opt is None:
        raise HorovodTpuError("KerasEstimator: optimizer is required")
    comp = resolve_compression(hvd_k, spec.get("compression"))
    dist_opt = hvd_k.DistributedOptimizer(
        opt, compression=comp,
        backward_passes_per_step=spec.get("backward_passes_per_step", 1))
    model.compile(optimizer=dist_opt, loss=loss, metrics=metrics or None)

    # Memory-mapped minibatch feeding (reference: data_loaders/ over
    # Petastorm): a generator over the rank's shard with seeded
    # per-epoch shuffles; steps_per_epoch bounds each keras epoch.
    loader = ShardDataLoader(
        spec["train_dir"], hvd_k.rank(), spec["batch_size"],
        shuffle=spec["shuffle"], seed=spec["seed"], drop_last=False)

    def squeeze(yb):
        return yb[:, 0] if yb.shape[1] == 1 else yb

    def gen():
        epoch = 0
        while True:
            for xb, yb in loader.epoch(epoch):
                yield xb, squeeze(yb)
            epoch += 1

    val = None
    if spec["val_dir"]:
        xv, yv = load_val(spec["val_dir"])
        val = (xv, squeeze(yv))

    cbs = [hvd_k.callbacks.BroadcastGlobalVariablesCallback(0),
           hvd_k.callbacks.MetricAverageCallback()]
    cbs.extend(spec.get("callbacks") or [])
    history = model.fit(
        gen(), steps_per_epoch=len(loader), epochs=spec["epochs"],
        validation_data=val, validation_batch_size=spec["batch_size"],
        verbose=spec["verbose"] if hvd_k.rank() == 0 else 0,
        callbacks=cbs)

    # NOTE: the returned/checkpointed architecture is the PRE-compile
    # arch JSON from the spec — `model.to_json()` after compile embeds
    # the dynamic DistributedOptimizer subclass in compile_config, which
    # cannot be deserialized outside a worker.
    if hvd_k.rank() != 0:
        return None  # only rank 0 ships the trained model back
    arch_json = raw["arch_json"]
    weights = model.get_weights()
    save_checkpoint(spec["run_path"], {"arch_json": arch_json,
                                       "weights": weights})
    return {"weights": weights,
            "arch_json": arch_json,
            "history": {k: [float(v) for v in vs]
                        for k, vs in history.history.items()}}


class KerasModel(HorovodModel):
    """Fitted Keras transformer (reference: keras/estimator.py
    `KerasModel`)."""

    _params = dict(HorovodModel._params, custom_objects=None,
                   _arch_json=None, _weights=None)

    def _materialize(self):
        if self.model is None:
            import tensorflow as tf

            m = tf.keras.models.model_from_json(
                self._arch_json, custom_objects=self.custom_objects)
            m.set_weights(self._weights)
            self.model = m
        return self.model

    def getModel(self):  # noqa: N802
        return self._materialize()

    def _predict(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(self._materialize().predict(x, verbose=0))


class KerasEstimator(HorovodEstimator):
    """Distributed tf.keras estimator (reference: keras/estimator.py
    `KerasEstimator`).

        est = KerasEstimator(model=m, optimizer=opt, loss="mse",
                             feature_cols=["x"], label_cols=["y"],
                             batch_size=32, epochs=4, num_proc=2)
        keras_model = est.fit(df)
        out = keras_model.transform(df)
    """

    _params = dict(HorovodEstimator._params, output_cols=None)

    def _validate_params(self) -> None:
        if self.optimizer is None or self.loss is None:
            raise HorovodTpuError(
                "KerasEstimator: optimizer and loss are required")
        super()._validate_params()

    def _remote_trainer(self):
        return _keras_remote_trainer

    def _serialize_model(self) -> bytes:
        return _serialize_keras(self.model, self.optimizer, self.loss,
                                self.metrics, self.custom_objects)

    def _make_model(self, result, meta, store, run_id) -> KerasModel:
        return KerasModel(
            _arch_json=result["arch_json"], _weights=result["weights"],
            custom_objects=self.custom_objects,
            feature_cols=self.feature_cols,
            output_cols=self.output_cols or ["prediction"],
            history=result["history"], run_id=run_id)


__all__ = ["KerasEstimator", "KerasModel"]
