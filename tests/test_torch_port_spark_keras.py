"""Port parity: `horovod_tpu_torch.spark.keras` (`KerasEstimator`,
`KerasModel`) over the port's `tensorflow/keras/` frontend, on the CPU
(the card's host has no TensorFlow).

- The refusal is JAX's message.
- `KerasEstimator.fit` over `LocalBackend` at np=1 and np=2 with
  `device="cpu"`: the checks of `tests/test_spark_estimator.py`'s Keras
  fit (loss history, decreasing loss, predictions, the checkpoint), and
  at np=1 each epoch's loss within 1e-5 of `model.fit` of the same
  model on the same batches in this process (the one-rank allreduce is
  the identity).
"""

import os

import numpy as np
import pandas as pd
import pytest

from horovod_tpu.common.exceptions import HorovodTpuError as JErr
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.spark.common import LocalBackend, Store

from test_torch_port_collectives import (  # noqa: F401  (autouse)
    no_launcher_env,
)

tf = pytest.importorskip("tensorflow")


def make_df(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    y = 2.0 * x1 - 1.0 * x2 + 0.5
    return pd.DataFrame({"x1": x1, "x2": x2, "y": y.astype(np.float32)})


def _model():
    tf.keras.utils.set_random_seed(0)
    return tf.keras.Sequential([tf.keras.layers.Input((2,)),
                                tf.keras.layers.Dense(1)])


@pytest.mark.parametrize("missing", ["optimizer", "loss"])
def test_keras_refusal_is_jax(missing):
    import horovod_tpu.spark.common as JC
    import horovod_tpu.spark.keras as JK
    import horovod_tpu_torch.spark.common as PC
    import horovod_tpu_torch.spark.keras as PK

    msgs = {}
    for name, (K, C) in (("jax", (JK, JC)), ("port", (PK, PC))):
        kw = dict(model=_model(), optimizer=tf.keras.optimizers.SGD(0.1),
                  loss="mse", feature_cols=["x1"], label_cols=["y"],
                  backend=C.LocalBackend(1))
        kw[missing] = None
        with pytest.raises((JErr, HorovodTpuError)) as e:
            K.KerasEstimator(**kw).fit(make_df(8))
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["jax"]


def _reference_losses(df, epochs, batch_size, seed):
    """`model.fit` in this process over rank 0's shard of a one-rank fit,
    its batches in the loader's order."""
    import horovod_tpu_torch.spark.common.util as U
    from horovod_tpu_torch.spark.common.data_loader import ShardDataLoader

    s = Store.create(None)
    try:
        U.prepare_data(df, s, "ref", 1, ["x1", "x2"], ["y"], seed=seed)
        loader = ShardDataLoader(s.get_train_data_path("ref"), 0,
                                 batch_size, seed=seed, drop_last=False)

        def gen():
            for e in range(epochs):
                for xb, yb in loader.epoch(e):
                    yield xb, yb[:, 0]

        model = _model()
        model.compile(optimizer=tf.keras.optimizers.SGD(0.1), loss="mse")
        hist = model.fit(gen(), steps_per_epoch=len(loader), epochs=epochs,
                         verbose=0)
        return hist.history["loss"]
    finally:
        s.cleanup()


@pytest.mark.integration
@pytest.mark.parametrize("np_", [1, 2])
def test_keras_fit(tmp_path, np_):
    from horovod_tpu_torch.spark.keras import KerasEstimator

    df = make_df(64)
    est = KerasEstimator(
        model=_model(), optimizer=tf.keras.optimizers.SGD(0.1), loss="mse",
        feature_cols=["x1", "x2"], label_cols=["y"], batch_size=16,
        epochs=6, random_seed=0, device="cpu",
        store=Store.create(str(tmp_path)), run_id="kerasrun",
        backend=LocalBackend(np_), verbose=0)
    fitted = est.fit(df)
    hist = fitted.get_history()
    assert len(hist["loss"]) == 6
    assert hist["loss"][-1] < hist["loss"][0]
    out = fitted.transform(df)
    preds = np.asarray([float(np.ravel(v)[0]) for v in out["prediction"]])
    err = np.mean((preds - df["y"].to_numpy()) ** 2)
    assert err < 0.5, f"mse {err}"
    assert os.path.exists(est.store.get_checkpoint_path("kerasrun"))
    if np_ == 1:
        np.testing.assert_allclose(hist["loss"],
                                   _reference_losses(df, 6, 16, 0),
                                   rtol=1e-5)
