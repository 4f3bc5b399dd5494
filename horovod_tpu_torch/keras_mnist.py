"""TF2 Keras MNIST on the port: BASELINE config 3, the flow of
`examples/keras_mnist.py` (the reference's tensorflow2_keras_mnist.py)
through `horovod_tpu_torch.tensorflow.keras`.

    hvd.init() → the reference's conv net → Adam(lr × size) wrapped in
    DistributedOptimizer → model.fit with BroadcastGlobalVariablesCallback
    (0), MetricAverageCallback and LearningRateWarmupCallback

The model runs in TensorFlow on the host; the gradient allreduce inside
`model.fit`'s step (through `tf.py_function`) and the broadcasts run on
the port's collectives on the rank's device: the card unless `--device
cpu` is given.  Each rank draws its own `synthetic_mnist` (seed = rank),
as the JAX example does.  Prints, on rank 0, Keras's epoch lines and
the final loss; on every rank a SUMMARY line (each epoch's loss, the
weights' SHA-256).

Run:  python -m horovod_tpu_torch.keras_mnist --device cpu
      python -m horovod_tpu_torch.runner -np 2 python -m \
          horovod_tpu_torch.keras_mnist --device cpu
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.tensorflow.keras as hvd
from horovod_tpu_torch.torch_mnist import synthetic_mnist


def build_model():
    """The reference example's conv net (tensorflow2_keras_mnist.py)."""
    return tf.keras.Sequential([
        tf.keras.layers.Input(shape=(28, 28, 1)),
        tf.keras.layers.Conv2D(32, [3, 3], activation="relu"),
        tf.keras.layers.MaxPooling2D(pool_size=(2, 2)),
        tf.keras.layers.Conv2D(64, [3, 3], activation="relu"),
        tf.keras.layers.MaxPooling2D(pool_size=(2, 2)),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(128, activation="relu"),
        tf.keras.layers.Dropout(0.25),
        tf.keras.layers.Dense(10, activation="softmax"),
    ])


def weights_digest(model) -> str:
    h = hashlib.sha256()
    for w in model.get_weights():
        h.update(np.ascontiguousarray(w).tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--n", type=int, default=512, help="synthetic samples")
    p.add_argument("--base-lr", type=float, default=0.001)
    p.add_argument("--device", default=None,
                   help="default: the rank's card; 'cpu' runs the "
                   "collectives on the host")
    args = p.parse_args(argv)

    hvd.init(device=args.device)

    x, y = synthetic_mnist(args.n, seed=hvd.rank())
    x = x.reshape(-1, 28, 28, 1).astype(np.float32)
    y = y.astype(np.int32)

    model = build_model()
    # Reference recipe: scale LR by size, wrap the optimizer, broadcast
    # initial state, average logged metrics.
    scaled_lr = args.base_lr * hvd.size()
    opt = hvd.DistributedOptimizer(
        tf.keras.optimizers.Adam(learning_rate=scaled_lr))
    model.compile(
        optimizer=opt,
        loss=tf.keras.losses.SparseCategoricalCrossentropy(),
        metrics=["accuracy"],
    )
    callbacks = [
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
        hvd.callbacks.LearningRateWarmupCallback(
            initial_lr=scaled_lr, warmup_epochs=1),
    ]
    hist = model.fit(x, y, batch_size=args.batch_size, epochs=args.epochs,
                     callbacks=callbacks, verbose=2 if hvd.rank() == 0 else 0)
    losses = [float(v) for v in hist.history["loss"]]
    if hvd.rank() == 0:
        print(f"final loss: {losses[-1]:.4f}", flush=True)
    print("SUMMARY " + json.dumps({
        "rank": hvd.rank(), "size": hvd.size(), "model": "keras_mnist",
        "epoch_losses": losses, "last_loss": losses[-1],
        "digest": weights_digest(model)}), flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
