"""Port parity: the Keras frontend of `horovod_tpu_torch`
(`tensorflow.keras` and the standalone `keras` namespace) against the
JAX package's, and `keras_mnist` (BASELINE config 3) at np=2.

The cases are one source (CASES), run by each rank of one np=2 gloo
world on the CPU through the port and in this process through the JAX
package on its eight simulated ranks (a plain tensor: every rank
contributes it).  SAME lists the results of rank-identical inputs that
the port gives bitwise as JAX does; results of rank-distinct inputs
(keys ending in `_d`) are held to what two ranks must give.  A
`model.fit` step over rank-identical data and weights is held to JAX's
within FIT_RTOL: JAX's Average of eight equal f32 gradients is a sum of
eight in its order, then a division, which can round where the port's
sum of two cannot.  `keras_mnist` runs whole at np=2 under the port's
launcher, started when this module is, beside the world.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import horovod_tpu.tensorflow.keras as jk  # noqa: E402

from test_torch_port_collectives import (  # noqa: E402,F401 (autouse)
    LAUNCHER_ENV, REPO, no_launcher_env, run_world)

N = 2
JN = 8
# One SGD step's weights, port against JAX, relative to the largest.
FIT_RTOL = 1e-6

CASES = r'''
import numpy as np
import tensorflow as tf


def tiny_model():
    return tf.keras.Sequential([
        tf.keras.layers.Input(shape=(4,)),
        tf.keras.layers.Dense(8, activation="relu"),
        tf.keras.layers.Dense(2),
    ])


def digest(ws):
    return np.concatenate([np.asarray(w).ravel() for w in ws])


def case_optimizer(hk, r, n):
    out = {}
    opt = hk.DistributedOptimizer(tf.keras.optimizers.SGD(0.01))
    out["subclass"] = np.asarray([isinstance(opt, tf.keras.optimizers.SGD),
                                  float(opt.learning_rate.numpy()) == 0.01,
                                  type(opt).__name__ == "DistributedSGD"])
    v = tf.Variable([1.0, 1.0])
    opt = hk.DistributedOptimizer(tf.keras.optimizers.SGD(0.5))
    opt.apply_gradients([(tf.constant([2.0, 2.0]), v)])
    out["apply_gradients"] = v.numpy()
    v = tf.Variable([1.0, 1.0])
    opt = hk.DistributedOptimizer(tf.keras.optimizers.SGD(0.5))
    opt.apply([tf.constant([1.0, 3.0])], [v])
    out["apply"] = v.numpy()
    calls = []
    orig = hk._allreduce_grads

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    hk._allreduce_grads = spy
    try:
        tf.keras.utils.set_random_seed(0)
        m = tf.keras.Sequential([tf.keras.layers.Input((2,)),
                                 tf.keras.layers.Dense(1)])
        opt = hk.DistributedOptimizer(tf.keras.optimizers.SGD(0.1),
                                      backward_passes_per_step=2)
        m.compile(optimizer=opt, loss="mse")
        x = np.random.randn(8, 2).astype("float32")
        y = np.random.randn(8).astype("float32")
        ws = [m.get_weights()[0].copy()]
        for _ in range(4):
            m.train_on_batch(x, y)
            ws.append(m.get_weights()[0].copy())
    finally:
        hk._allreduce_grads = orig
    out["bpps_calls"] = np.asarray(len(calls))
    out["bpps_held"] = np.asarray([np.array_equal(ws[0], ws[1]),
                                   not np.allclose(ws[1], ws[2]),
                                   np.array_equal(ws[2], ws[3]),
                                   int(m.optimizer.iterations.numpy())])
    out["bpps_fit_weights"] = ws[4]
    # One fit step over rank-identical data and weights.
    tf.keras.utils.set_random_seed(0)
    model = tiny_model()
    model.compile(optimizer=hk.DistributedOptimizer(
        tf.keras.optimizers.SGD(learning_rate=0.1)),
        loss=tf.keras.losses.SparseCategoricalCrossentropy(
            from_logits=True))
    x = np.random.RandomState(0).randn(64, 4).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    model.fit(x[:16], y[:16], epochs=1, batch_size=16, verbose=0)
    out["fit_step_weights"] = digest(model.get_weights())
    # The compiled step stays out of XLA (the collective runs through
    # tf.py_function), as JAX's does at this Keras.
    out["fit_jit_compile"] = np.asarray(bool(model.jit_compile))
    h = model.fit(x, y, epochs=3, batch_size=16, verbose=0)
    out["fit_trains"] = np.asarray(h.history["loss"][-1] <
                                   h.history["loss"][0])
    # Rank-distinct batches: one step applies the average of the ranks'
    # gradients, so the weights agree across ranks.
    tf.keras.utils.set_random_seed(1)
    model = tiny_model()
    model.compile(optimizer=hk.DistributedOptimizer(
        tf.keras.optimizers.SGD(learning_rate=0.1)), loss="mse")
    xd = np.random.RandomState(40 + r).randn(8, 4).astype(np.float32)
    yd = np.random.RandomState(50 + r).randn(8, 2).astype(np.float32)
    model.fit(xd, yd, epochs=1, batch_size=8, verbose=0)
    out["fit_weights_d"] = digest(model.get_weights())
    return out


def case_load_model(hk, r, n, path):
    out = {}
    model = tiny_model()
    model.compile(optimizer=tf.keras.optimizers.Adam(1e-3), loss="mse")
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    y = np.random.RandomState(1).randn(8, 2).astype(np.float32)
    model.train_on_batch(x, y)
    model.save(path + "/plain.keras")
    loaded = hk.load_model(path + "/plain.keras")
    out["wrapped"] = np.asarray([
        isinstance(loaded.optimizer, tf.keras.optimizers.Adam),
        hasattr(loaded.optimizer, "_hvd_op"),
        int(loaded.optimizer.iterations.numpy())])
    loaded.train_on_batch(x, y)
    loaded = hk.load_model(path + "/plain.keras",
                           custom_objects={"Adam": tf.keras.optimizers.Adam})
    out["opt_out"] = np.asarray([
        isinstance(loaded.optimizer, tf.keras.optimizers.Adam),
        hasattr(loaded.optimizer, "_hvd_op")])
    model = tiny_model()
    model.compile(optimizer=hk.DistributedOptimizer(
        tf.keras.optimizers.SGD(0.1)), loss="mse")
    model.save(path + "/dist.keras")
    loaded = hk.load_model(path + "/dist.keras")
    out["roundtrip"] = np.asarray([
        isinstance(loaded.optimizer, tf.keras.optimizers.SGD),
        hasattr(loaded.optimizer, "_hvd_op")])
    # broadcast_model: rank-distinct weights and slots become rank 0's.
    tf.keras.utils.set_random_seed(10 + r)
    model = tiny_model()
    model.compile(optimizer=tf.keras.optimizers.Adam(1e-3), loss="mse")
    model.train_on_batch(x + r, y)
    hk.broadcast_model(model, root_rank=0)
    out["broadcast_model_d"] = digest(
        [v.numpy() for v in model.variables] +
        [v.numpy() for v in model.optimizer.variables])
    return out


def case_callbacks(hk, r, n):
    out = {}
    tf.keras.utils.set_random_seed(20 + r)
    model = tiny_model()
    model.compile(optimizer=hk.DistributedOptimizer(
        tf.keras.optimizers.SGD(0.05)), loss="mse")
    cb = hk.callbacks.BroadcastGlobalVariablesCallback(0)
    x = np.random.RandomState(60 + r).randn(8, 4).astype(np.float32)
    y = np.zeros((8, 2), np.float32)
    model.fit(x, y, epochs=1, batch_size=4, verbose=0, callbacks=[cb])
    out["broadcast_done"] = np.asarray(cb.broadcast_done)
    out["broadcast_fit_d"] = digest(model.get_weights())
    logs = {"loss": 2.0, "acc": 0.5, "name": "x"}
    hk.callbacks.MetricAverageCallback().on_epoch_end(0, logs)
    out["metric_same"] = np.asarray([logs["loss"], logs["acc"]])
    logs = {"loss": 0.5 + r, "acc": 0.25 * r}
    hk.callbacks.MetricAverageCallback().on_epoch_end(0, logs)
    out["metric_d"] = np.asarray([logs["loss"], logs["acc"]])
    lrs = []

    class Spy(tf.keras.callbacks.Callback):
        def on_batch_begin(self, batch, logs=None):
            lrs.append(float(self.model.optimizer.learning_rate.numpy()))

    model = tiny_model()
    model.compile(optimizer=hk.DistributedOptimizer(
        tf.keras.optimizers.SGD(0.8)), loss="mse")
    cb = hk.callbacks.LearningRateWarmupCallback(
        initial_lr=0.8, warmup_epochs=2, steps_per_epoch=2)
    model.fit(np.zeros((8, 4), np.float32), np.zeros((8, 2), np.float32),
              epochs=3, batch_size=4, verbose=0, callbacks=[cb, Spy()])
    out["warmup_lrs"] = np.asarray(lrs)
    model = tiny_model()
    model.compile(optimizer=hk.DistributedOptimizer(
        tf.keras.optimizers.SGD(0.4)), loss="mse")
    cb = hk.callbacks.LearningRateScheduleCallback(
        initial_lr=0.4, multiplier=lambda e: 0.1 ** e, start_epoch=0)
    model.fit(np.zeros((8, 4), np.float32), np.zeros((8, 2), np.float32),
              epochs=2, batch_size=8, verbose=0, callbacks=[cb])
    out["schedule_lr"] = np.asarray(
        float(model.optimizer.learning_rate.numpy()))
    return out


def case_elastic(hk, r, n):
    ke = hk.elastic
    out = {}

    def fit(callbacks, epochs, batches):
        tf.keras.utils.set_random_seed(0)
        model = tiny_model()
        model.compile(optimizer=tf.keras.optimizers.SGD(0.01), loss="mse")
        x = np.random.RandomState(0).randn(batches * 4, 4).astype(np.float32)
        y = np.random.RandomState(1).randn(batches * 4, 2).astype(np.float32)
        model.fit(x, y, epochs=epochs, batch_size=4, verbose=0,
                  callbacks=callbacks)
        return model

    commits = []

    class SpyState(ke.KerasState):
        def commit(self):
            commits.append(1)
            super().commit()

    state = SpyState(batch=0, epoch=0)
    fit([ke.CommitStateCallback(state, batches_per_commit=2)], 1, 4)
    out["commits"] = np.asarray(len(commits))
    try:
        ke.CommitStateCallback(state, batches_per_commit=0)
        out["commit_zero_refused"] = np.asarray(False)
    except ValueError:
        out["commit_zero_refused"] = np.asarray(True)
    state = ke.KerasState(batch=0, epoch=0)
    seen = []

    class Spy(tf.keras.callbacks.Callback):
        def on_batch_end(self, batch, logs=None):
            seen.append(state.batch)

    fit([ke.UpdateBatchStateCallback(state), Spy(),
         ke.UpdateEpochStateCallback(state)], 2, 3)
    out["batch_epoch"] = np.asarray([state.epoch, state.batch, max(seen)])
    model = tiny_model()
    model.compile(optimizer=tf.keras.optimizers.SGD(0.01), loss="mse")
    state = ke.KerasState(model, epoch=3)
    w0 = [w.copy() for w in model.get_weights()]
    state.save()
    model.set_weights([w * 0 for w in w0])
    state.epoch = 7
    state.restore()
    out["save_restore"] = np.asarray(
        all(np.array_equal(a, b) for a, b in zip(model.get_weights(), w0))
        and state.epoch == 3)
    model = tiny_model()
    model.compile(optimizer=tf.keras.optimizers.Adam(1e-3), loss="mse")
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    y = np.random.RandomState(1).randn(8, 2).astype(np.float32)
    model.train_on_batch(x, y)
    state = ke.KerasState(model)
    state.save()
    it0 = int(model.optimizer.iterations.numpy())
    model.train_on_batch(x, y)
    state.restore()
    out["default_optimizer"] = np.asarray([
        state.optimizer is model.optimizer,
        int(model.optimizer.iterations.numpy()) == it0])
    return out


def case_partial(hk, r, n):
    out = {}
    seen = []
    orig = hk._allreduce_grads

    def spy(grads, *a, **kw):
        seen.append([g is None for g in grads])
        return orig(grads, *a, **kw)

    hk._allreduce_grads = spy
    try:
        tf.keras.utils.set_random_seed(0)
        local = tf.keras.layers.Dense(2, name="local_head")
        model = tf.keras.Sequential([
            tf.keras.layers.Input((4,)),
            tf.keras.layers.Dense(8, activation="relu"), local])
        opt = hk.PartialDistributedOptimizer(tf.keras.optimizers.SGD(0.1),
                                             local_layers=[local])
        model.compile(optimizer=opt, loss="mse")
        x = np.random.RandomState(70 + r).randn(8, 4).astype(np.float32)
        y = np.random.RandomState(80 + r).randn(8, 2).astype(np.float32)
        before = [w.numpy().copy() for w in local.weights]
        model.train_on_batch(x, y)
        out["partial_flags"] = np.asarray(seen[-1])
        out["local_trained"] = np.asarray(any(
            not np.allclose(a.numpy(), b)
            for a, b in zip(local.weights, before)))
        out["synced_d"] = digest(model.layers[0].get_weights())
        out["local_d"] = digest(local.get_weights())
        opt = hk.PartialDistributedOptimizer(tf.keras.optimizers.SGD(0.1))
        v = tf.Variable([1.0, 1.0])
        opt.apply_gradients([(tf.constant([2.0, 2.0]), v)])
        out["no_local"] = v.numpy()
        v1, v2 = tf.Variable([1.0, 1.0]), tf.Variable([2.0, 2.0])
        opt = hk.PartialDistributedOptimizer(tf.keras.optimizers.SGD(0.1),
                                             local_layers=[v2])
        opt.apply_gradients([(tf.constant([1.0, 1.0]), v1),
                             (tf.constant([1.0, 1.0]), v2)])
        out["variables_flags"] = np.asarray(seen[-1])
    finally:
        hk._allreduce_grads = orig
    return out
'''
exec(CASES)

WORKER = CASES + r'''
import os
import sys
import torch
import horovod_tpu_torch.keras as hkeras
import horovod_tpu_torch.tensorflow.keras as hk
import horovod_tpu_torch.keras.callbacks as kcb
import horovod_tpu_torch.keras.elastic as kel

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hk.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
path = os.path.join(out_dir, f"models{r}")
os.makedirs(path)
res = {"case_optimizer": case_optimizer(hk, r, n),
       "case_load_model": case_load_model(hk, r, n, path),
       "case_callbacks": case_callbacks(hk, r, n),
       "case_elastic": case_elastic(hk, r, n),
       "case_partial": case_partial(hk, r, n)}
res["standalone"] = [
    hkeras.callbacks is kcb, hkeras.elastic is kel,
    kcb.BroadcastGlobalVariablesCallback is hk.callbacks.BroadcastGlobalVariablesCallback,
    kel.KerasState is hk.elastic.KerasState,
    kel.CommitStateCallback is hk.elastic.CommitStateCallback,
    hkeras.DistributedOptimizer is hk.DistributedOptimizer,
    hkeras.load_model is hk.load_model,
    hkeras.PartialDistributedOptimizer is hk.PartialDistributedOptimizer]
hk.barrier()
torch.save(res, f"{out_dir}/rank{r}.pt")
hk.shutdown()
'''


def _launch_env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    for k in LAUNCHER_ENV:
        env.pop(k, None)
    return env


@pytest.fixture(scope="module", autouse=True)
def keras_mnist_run(tmp_path_factory):
    """`keras_mnist` at np=2 under the port's launcher, started first so
    that it runs beside the world."""
    logs = tmp_path_factory.mktemp("keras_mnist")
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--output-filename", str(logs), sys.executable, "-m",
         "horovod_tpu_torch.keras_mnist", "--device", "cpu", "--epochs",
         "2", "--n", "256"], cwd=REPO, env=_launch_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield p, logs
    if p.poll() is None:
        p.kill()
        p.wait()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("keras"), N, WORKER,
                     timeout=300)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_models"))
    return {"case_optimizer": case_optimizer(jk, 0, JN),
            "case_load_model": case_load_model(jk, 0, JN, path),
            "case_callbacks": case_callbacks(jk, 0, JN),
            "case_elastic": case_elastic(jk, 0, JN),
            "case_partial": case_partial(jk, 0, JN)}


SAME = {
    "case_optimizer": ["subclass", "apply_gradients", "apply", "bpps_calls",
                       "bpps_held", "fit_trains", "fit_jit_compile"],
    "case_load_model": ["wrapped", "opt_out", "roundtrip"],
    "case_callbacks": ["broadcast_done", "metric_same", "schedule_lr"],
    "case_elastic": ["commits", "commit_zero_refused", "batch_epoch",
                     "save_restore", "default_optimizer"],
    "case_partial": ["partial_flags", "local_trained", "no_local",
                     "variables_flags"],
}


@pytest.mark.parametrize("case", sorted(SAME))
def test_rank_identical_results_are_jaxs_bitwise(world, jax_results, case):
    for d in world:
        for key in SAME[case]:
            np.testing.assert_array_equal(d[case][key],
                                          jax_results[case][key],
                                          err_msg=key)


@pytest.mark.parametrize("key", ["bpps_fit_weights", "fit_step_weights"])
def test_fit_steps_match_jax(world, jax_results, key):
    """`model.fit` (and `train_on_batch` under backward_passes_per_step,
    its tf.cond inside the compiled step) on rank-identical data and
    weights: the port's two ranks against JAX's eight, within
    FIT_RTOL of the largest weight."""
    want = jax_results["case_optimizer"][key]
    for d in world:
        got = d["case_optimizer"][key]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=FIT_RTOL * np.abs(want).max())
    np.testing.assert_array_equal(world[0]["case_optimizer"][key],
                                  world[1]["case_optimizer"][key])


def test_rank_distinct_results_agree_across_ranks(world):
    a, b = world
    for case, key in (("case_optimizer", "fit_weights_d"),
                      ("case_load_model", "broadcast_model_d"),
                      ("case_callbacks", "broadcast_fit_d"),
                      ("case_partial", "synced_d")):
        np.testing.assert_array_equal(a[case][key], b[case][key],
                                      err_msg=key)
    # The local layer trains on each rank's own gradient.
    assert not np.array_equal(a["case_partial"]["local_d"],
                              b["case_partial"]["local_d"])
    for d in world:
        np.testing.assert_array_equal(d["case_callbacks"]["metric_d"],
                                      [1.0, 0.125])


def test_warmup_lrs_are_jaxs_at_equal_size(world, monkeypatch):
    """JAX's warmup callback driven by hand at the port's size (its
    basics.size patched to 2) gives the port's rates exactly."""
    from horovod_tpu.common import basics as jbasics

    monkeypatch.setattr(jbasics, "size", lambda: N)

    class Opt:
        def __init__(self):
            self.learning_rate = tf.Variable(0.8)

    class Model:
        optimizer = Opt()

    cb = jk.callbacks.LearningRateWarmupCallback(
        initial_lr=0.8, warmup_epochs=2, steps_per_epoch=2)
    cb.set_model(Model())
    want = []
    for epoch in range(3):
        cb.on_epoch_begin(epoch)
        for batch in range(2):
            cb.on_batch_begin(batch)
            want.append(float(Model.optimizer.learning_rate.numpy()))
    for d in world:
        got = d["case_callbacks"]["warmup_lrs"]
        np.testing.assert_array_equal(got, want)
        assert got[-1] == pytest.approx(0.8, rel=1e-6)


def test_standalone_namespace_is_one_module_each(world):
    for d in world:
        assert d["standalone"] == [True] * 8


def test_keras_mnist_np2_under_the_launcher(keras_mnist_run):
    p, logs = keras_mnist_run
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0, out[-4000:]
    sums = []
    for rank in range(2):
        lines = (logs / f"rank.{rank}.log").read_text().splitlines()
        rec = [l.split("SUMMARY ", 1)[1] for l in lines if "SUMMARY " in l]
        sums.append(json.loads(rec[-1]))
    for s in sums:
        assert s["size"] == 2 and len(s["epoch_losses"]) == 2
        assert all(np.isfinite(s["epoch_losses"]))
    assert sums[0]["digest"] == sums[1]["digest"]
    # MetricAverageCallback: the logged losses are the ranks' average.
    assert sums[0]["epoch_losses"] == sums[1]["epoch_losses"]
