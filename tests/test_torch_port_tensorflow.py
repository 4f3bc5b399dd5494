"""Port parity: `horovod_tpu_torch.tensorflow` against
`horovod_tpu.tensorflow`, the classes of `tests/test_tensorflow_shim.py`
(the collectives and their gradients, graph mode, the sparse and fused
paths, predivide, the tape, the optimizer's accumulation,
`SyncBatchNormalization`, the elastic states) and the bridge.

The cases are one source (CASES), run twice: by each rank of one np=2
gloo world on the CPU through the port's frontend, and in this process
through the JAX package's on its eight simulated ranks, where a plain
tensor means "every rank contributes this".  Each case returns named
numpy results; SAME lists those of rank-identical inputs of few
significant bits, which the port must give bitwise as JAX does (an
Average of equal values is exact at 2 ranks and at 8), SCALED those
that grow with the world's size (a Sum, a gather's rows, a gradient
summed over the ranks), which the port must give bitwise as JAX's times
2/8.  Results of rank-distinct inputs (keys ending in `_d`) are held to
numpy's reduction of the two ranks' inputs, bitwise where the sums are
exact (small integers and halves), else within the stated tolerance.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import horovod_tpu.tensorflow as jtf  # noqa: E402

from test_torch_port_collectives import (  # noqa: E402,F401 (autouse)
    no_launcher_env, run_world)

N = 2
JN = 8

CASES = r'''
import threading
import numpy as np
import tensorflow as tf


def dist(r, shape, dtype=np.float32):
    """Rank r's input: small integers and halves (exact sums)."""
    k = int(np.prod(shape))
    return ((np.arange(k) % 5 - 2) * 0.5 * (r + 1) + r).reshape(
        shape).astype(dtype)


def case_gradients(hvd, r, n):
    out = {}
    x = tf.Variable(tf.ones((4,)))
    with tf.GradientTape() as t:
        y = tf.reduce_sum(hvd.allreduce(x * 2.0))
    out["allreduce_grad"] = t.gradient(y, x).numpy()
    x = tf.Variable(tf.ones((2, 3)))
    with tf.GradientTape() as t:
        y = tf.reduce_sum(hvd.allgather(x))
    out["allgather_grad"] = t.gradient(y, x).numpy()
    x = tf.Variable(tf.ones((3,)))
    with tf.GradientTape() as t:
        y = tf.reduce_sum(hvd.broadcast(x, root_rank=0))
    out["broadcast_grad"] = t.gradient(y, x).numpy()
    x = tf.Variable(tf.ones((2 * n, 3)))
    with tf.GradientTape() as t:
        y = tf.reduce_sum(hvd.reducescatter(x))
    # (A gradient whose shape follows the world's size: its values.)
    out["reducescatter_grad"] = np.unique(t.gradient(y, x).numpy() * n)
    x = tf.Variable(tf.ones((n, 2)))
    with tf.GradientTape() as t:
        y = tf.reduce_sum(hvd.alltoall(x) * 3.0)
    out["alltoall_grad"] = np.unique(t.gradient(y, x).numpy())
    splits = tf.constant([1] * n, dtype=tf.int32)
    with tf.GradientTape() as t:
        o, rs = hvd.alltoall(x * 4.0, splits=splits)
        y = tf.reduce_sum(o)
    out["alltoall_splits_grad"] = np.unique(t.gradient(y, x).numpy())
    out["alltoall_splits_recv"] = np.asarray(rs.shape.as_list()) // n
    v = tf.Variable(2.0)
    with tf.GradientTape() as t:
        y = tf.reduce_sum(hvd.allgather(v))
    out["scalar_allgather_grad"] = np.asarray(t.gradient(y, v).numpy())
    out["scalar_allgather_shape"] = np.asarray(
        hvd.allgather(tf.constant(3.0)).shape.as_list()) // n
    a = tf.Variable(tf.ones((3,)))
    b = tf.Variable(tf.ones((2, 2)))
    with tf.GradientTape() as t:
        o = hvd.grouped_allreduce([a * 2.0, b * 5.0])
        y = tf.reduce_sum(o[0]) + tf.reduce_sum(o[1])
    ga, gb = t.gradient(y, [a, b])
    out["grouped_grad_a"], out["grouped_grad_b"] = ga.numpy(), gb.numpy()
    # Rank-distinct: the Sum allreduce's gradient is the Sum of the
    # ranks' output gradients.
    x = tf.Variable(dist(r, (4,)))
    with tf.GradientTape() as t:
        y = tf.reduce_sum(hvd.allreduce(x, op=hvd.Sum) * (r + 1.0))
    out["allreduce_sum_grad_d"] = t.gradient(y, x).numpy()
    return out


def case_ops(hvd, r, n):
    out = {}
    t = tf.constant([[1.0, 2.0], [3.0, 4.0]])
    o = hvd.allreduce(t)
    assert isinstance(o, tf.Tensor)
    out["allreduce_avg"] = o.numpy()
    out["allreduce_sum"] = hvd.allreduce(tf.ones([5]), op=hvd.Sum).numpy()
    o = hvd.allreduce(tf.constant([1, 2, 3], tf.int32), op=hvd.Sum)
    assert o.dtype == tf.int32
    out["allreduce_i32"] = o.numpy()
    o = hvd.allreduce(tf.constant([1, 2, -3], tf.int64), op=hvd.Sum)
    assert o.dtype == tf.int64
    out["allreduce_i64"] = o.numpy()
    o = hvd.allreduce(tf.constant([0.5, 1.5, 2.5]),
                      compression=hvd.Compression.fp16)
    assert o.dtype == tf.float32
    out["allreduce_fp16_wire"] = o.numpy()
    for dt in (tf.bfloat16, tf.float16):
        o = hvd.allreduce(tf.cast(tf.constant([0.5, 1.5, -2.0]), dt))
        assert o.dtype == dt
        out["allreduce_" + dt.name] = tf.cast(o, tf.float32).numpy()
    o = hvd.grouped_allreduce([tf.ones([2]), tf.constant([2.0, 4.0, 6.0])])
    out["grouped_0"], out["grouped_1"] = o[0].numpy(), o[1].numpy()
    out["size_op"] = np.asarray([int(hvd.size_op().numpy()) // n,
                                 int(hvd.rank_op().numpy()) - r,
                                 int(hvd.local_size_op().numpy()) // n,
                                 int(hvd.local_rank_op().numpy()) - r])
    ps = hvd.add_process_set([0])
    try:
        out["ps_ops"] = np.asarray([
            int(hvd.size_op(ps).numpy()),
            int(hvd.process_set_included_op(ps).numpy()) == int(r == 0)])
    finally:
        hvd.remove_process_set(ps)
    o = hvd.grouped_allgather([tf.ones([2, 3]), tf.zeros([1, 3])])
    out["grouped_allgather_rows"] = np.asarray(
        [int(x.shape[0]) for x in o]) // n
    o = hvd.grouped_reducescatter([tf.ones([2 * n, 2]), tf.ones([n])])
    out["grouped_reducescatter_0"] = o[0].numpy()
    out["grouped_reducescatter_1"] = o[1].numpy()
    t = tf.reshape(tf.range(6, dtype=tf.float32), (2, 3))
    o = hvd.allgather(t)
    out["allgather_rows"] = np.asarray(o.shape.as_list()[0] // n)
    out["allgather_head"] = o.numpy()[:2]
    out["broadcast"] = hvd.broadcast(tf.constant([7.0, 8.0]), 0).numpy()
    v = tf.Variable([1.0, 2.0, 3.0])
    hvd.broadcast_variables([v], root_rank=0)
    out["broadcast_variables"] = v.numpy()
    h = hvd.allreduce_async(tf.ones([4]), op=hvd.Sum)
    assert hvd.poll(h)
    out["async_sum"] = np.asarray(hvd.synchronize(h))
    out["alltoall_rows"] = np.asarray(
        hvd.alltoall(tf.ones([n, 2])).shape.as_list()) // [n, 1]
    out["broadcast_object"] = np.asarray(hvd.broadcast_object(
        {"v": 3 + r}, root_rank=0)["v"])
    out["allgather_object"] = np.asarray(hvd.allgather_object(r)[:2])
    out["broadcast_object_fn"] = np.asarray(
        hvd.broadcast_object_fn(root_rank=0)(5 + r))
    # Rank-distinct.
    out["allreduce_avg_d"] = hvd.allreduce(tf.constant(dist(r, (3, 2)))).numpy()
    out["allreduce_i64_d"] = hvd.allreduce(
        tf.constant(dist(r, (5,), np.int64) * 4), op=hvd.Sum).numpy()
    out["allgather_d"] = hvd.allgather(tf.constant(dist(r, (r + 1, 2)))).numpy()
    out["broadcast_d"] = hvd.broadcast(tf.constant(dist(r, (3,))), 1).numpy()
    v = tf.Variable(dist(r, (2, 2)))
    hvd.broadcast_variables([v], root_rank=1)
    out["broadcast_variables_d"] = v.numpy()
    out["reducescatter_d"] = hvd.reducescatter(
        tf.constant(dist(r, (2 * n, 2))), op=hvd.Sum).numpy()
    if n == 2:  # splits for the port's two ranks
        o, rs = hvd.alltoall(tf.constant(dist(r, (3, 2))),
                             splits=[1, 2] if r == 0 else [2, 1])
        out["alltoall_splits_d"], out["alltoall_recv_splits_d"] = (
            o.numpy(), rs.numpy())
    out["bf16_d"] = tf.cast(hvd.allreduce(tf.cast(
        tf.constant(dist(r, (4,))), tf.bfloat16), op=hvd.Sum),
        tf.float32).numpy()
    return out


def case_graph_mode(hvd, r, n):
    seen = []

    @tf.function
    def fn(x):
        s = hvd.allreduce(x, op=hvd.Sum)
        g = hvd.allgather(x)
        # At trace time: graph mode, and the gather's dim 0 unknown.
        seen.append((tf.executing_eagerly(), g.shape.as_list()))
        return s, g

    s, g = fn(tf.ones([3]))
    out = {"graph_sum": s.numpy(), "graph_gather_rows": np.asarray(
        g.shape[0] // n), "graph_traced": np.asarray(seen == [(False,
                                                               [None])])}
    s, _ = fn(tf.constant(dist(r, (3,))))
    out["graph_sum_d"] = s.numpy()
    return out


def case_sparse_and_fused(hvd, r, n):
    mod = hvd
    out = {}
    values = tf.constant([[1.0, 1.0], [2.0, 2.0]])
    indices = tf.constant([0, 2], dtype=tf.int64)
    sl = tf.IndexedSlices(values, indices,
                          dense_shape=tf.constant([4, 2], dtype=tf.int64))
    o = hvd.allreduce(sl, op=hvd.Sum)
    assert isinstance(o, tf.IndexedSlices)
    out["sparse_rows"] = np.asarray(int(o.values.shape[0]) // n)
    out["sparse_sum_dense"] = tf.scatter_nd(
        tf.expand_dims(o.indices, 1), o.values, [4, 2]).numpy()
    sl = tf.IndexedSlices(tf.constant([[3.0], [5.0]]),
                          tf.constant([1, 3], dtype=tf.int64),
                          dense_shape=tf.constant([4, 1], dtype=tf.int64))
    o = hvd.allreduce(sl)
    out["sparse_avg_dense"] = tf.scatter_nd(
        tf.expand_dims(o.indices, 1), o.values, [4, 1]).numpy()
    ts = [tf.constant([[1.0, 2.0], [3.0, 4.0]]), tf.constant([5.0, 6.0, 7.0]),
          tf.constant([1, 2, 3], dtype=tf.int32), tf.constant(9.0)]
    fused = mod._fused_flat_allreduce(ts, hvd.Sum, hvd.Compression.none, None)
    single = [hvd.allreduce(t, op=hvd.Sum) for t in ts]
    for i, (f, s, t) in enumerate(zip(fused, single, ts)):
        assert f.dtype == t.dtype and f.shape == t.shape
        assert np.array_equal(np.asarray(f), np.asarray(s))
        out[f"fused_{i}"] = np.asarray(f)
    ps = hvd.add_process_set([r])
    try:
        g = tf.constant([1.0, 2.0])
        o = mod._allreduce_grads([g, None], hvd.Average,
                                 hvd.Compression.none, ps,
                                 sparse_as_dense=False)
        out["size1_short_circuit"] = np.asarray(o[0] is g and o[1] is None)
    finally:
        hvd.remove_process_set(ps)
    values = tf.constant([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    indices = tf.constant([0, 2, 2], dtype=tf.int64)

    def mk():
        return tf.IndexedSlices(values, indices,
                                dense_shape=tf.constant([5, 2], tf.int64))

    dense = tf.ones([3, 3])
    osp = mod._allreduce_grads([mk(), dense, None], hvd.Average,
                               hvd.Compression.none, None,
                               sparse_as_dense=False)
    ode = mod._allreduce_grads([mk(), dense, None], hvd.Average,
                               hvd.Compression.none, None,
                               sparse_as_dense=True)
    assert isinstance(osp[0], tf.IndexedSlices)
    assert not isinstance(ode[0], tf.IndexedSlices)
    assert osp[2] is None and ode[2] is None
    out["switch_sparse"] = tf.scatter_nd(
        tf.expand_dims(osp[0].indices, 1), osp[0].values, [5, 2]).numpy()
    out["switch_dense"] = ode[0].numpy()
    out["switch_other"] = osp[1].numpy()
    # Rank-distinct sparse Average: gathered rows over the ranks.
    sl = tf.IndexedSlices(tf.constant(dist(r, (2, 2))),
                          tf.constant([r, 3], dtype=tf.int64),
                          dense_shape=tf.constant([4, 2], dtype=tf.int64))
    o = hvd.allreduce(sl)
    out["sparse_avg_dense_d"] = tf.scatter_nd(
        tf.expand_dims(o.indices, 1), o.values, [4, 2]).numpy()
    o = mod._fused_flat_allreduce(
        [tf.constant(dist(r, (2, 3))), tf.constant(dist(r, (4,)))],
        hvd.Sum, hvd.Compression.none, None)
    out["fused_d_0"], out["fused_d_1"] = o[0].numpy(), o[1].numpy()
    return out


def case_tape(hvd, r, n):
    out = {}
    x = tf.Variable(2.0)
    with tf.GradientTape() as t:
        loss = x * x
    (g,) = hvd.DistributedGradientTape(t).gradient(loss, [x])
    out["tape_avg"] = np.asarray(g.numpy())
    x, unused = tf.Variable(1.0), tf.Variable(5.0)
    with tf.GradientTape() as t:
        loss = 3.0 * x
    gs = hvd.DistributedGradientTape(t).gradient(loss, [x, unused])
    out["tape_none"] = np.asarray([float(gs[0].numpy()), gs[1] is None])
    x = tf.Variable(3.0)
    with hvd.DistributedGradientTape(
            tf.GradientTape(persistent=True)) as t:
        y = x * x
        z = 2.0 * x
    out["tape_delegation"] = np.asarray([
        float(t.gradient(y, [x])[0]), float(t.gradient(z, [x])[0])])
    v = tf.Variable(tf.ones((4,)))
    with tf.GradientTape() as t0:
        y0 = tf.reduce_sum(v * 3.0)
    plain = hvd.DistributedGradientTape(t0).gradient(y0, [v])[0]
    with tf.GradientTape() as t1:
        y1 = tf.reduce_sum(v * 3.0)
    pre = hvd.DistributedGradientTape(
        t1, gradient_predivide_factor=2.0).gradient(y1, [v])[0]
    out["predivide"], out["predivide_plain"] = pre.numpy(), plain.numpy()
    with tf.GradientTape() as t:
        y = tf.reduce_sum(v * 3.0)
    try:
        hvd.DistributedGradientTape(
            t, op=hvd.Sum, gradient_predivide_factor=2.0).gradient(y, [v])
        out["predivide_sum_refused"] = np.asarray(False)
    except ValueError as e:
        out["predivide_sum_refused"] = np.asarray(
            "requires op=Average" in str(e))
    # Rank-distinct: the tape averages the ranks' gradients, with and
    # without the predivide split.
    w = tf.Variable(tf.ones((3,)))
    for key, f in (("tape_d", 1.0), ("tape_predivide_d", 4.0)):
        with tf.GradientTape() as t:
            y = tf.reduce_sum(w * tf.constant(dist(r, (3,))))
        out[key] = hvd.DistributedGradientTape(
            t, gradient_predivide_factor=f).gradient(y, [w])[0].numpy()
    return out


def case_optimizer(hvd, r, n):
    out = {}
    v = tf.Variable(tf.ones((2,)))
    opt = hvd.DistributedOptimizer(tf.keras.optimizers.SGD(1.0),
                                   backward_passes_per_step=2,
                                   name="dist", device_dense="/gpu:0",
                                   device_sparse="/cpu:0", num_groups=2,
                                   groups=None)
    first = opt.apply_gradients([(tf.constant(dist(r, (2,)) + 1.0), v)])
    out["accum_first_none"] = np.asarray(first is None)
    out["accum_after_first"] = v.numpy()
    opt.apply_gradients([(tf.constant(dist(r, (2,)) * 2.0), v)])
    out["accum_after_second_d"] = v.numpy()
    v = tf.Variable(tf.ones((2,)))
    opt = hvd.DistributedOptimizer(tf.keras.optimizers.SGD(0.5))
    opt.apply([tf.constant([1.0, 0.5])], [v])
    out["apply"] = v.numpy()
    return out


def case_sync_batch_norm(hvd, r, n):
    out = {}
    tf.random.set_seed(0)
    x = tf.random.normal((16, 4))
    sbn = hvd.SyncBatchNormalization(axis=-1)
    bn = tf.keras.layers.BatchNormalization(axis=-1)
    out["sbn_fwd"] = sbn(x, training=True).numpy()
    out["sbn_local_diff"] = np.asarray(
        np.abs(out["sbn_fwd"] - bn(x, training=True).numpy()).max() <= 1e-5)
    out["sbn_infer_finite"] = np.asarray(
        np.isfinite(sbn(x, training=False).numpy()).all())
    tf.random.set_seed(1)
    x = tf.random.normal((12, 3))
    sbn = hvd.SyncBatchNormalization(axis=-1)
    bn = tf.keras.layers.BatchNormalization(axis=-1)
    sbn(x, training=True), bn(x, training=True)
    bn.set_weights(sbn.get_weights())
    with tf.GradientTape() as t1:
        t1.watch(x)
        l1 = tf.reduce_sum(tf.square(sbn(x, training=True)))
    with tf.GradientTape() as t2:
        t2.watch(x)
        l2 = tf.reduce_sum(tf.square(bn(x, training=True)))
    out["sbn_grad"], out["sbn_grad_local"] = (t1.gradient(l1, x).numpy(),
                                              t2.gradient(l2, x).numpy())
    x = tf.fill((32, 4), 100.0) + tf.random.normal((32, 4)) * 1e-4
    out["sbn_no_nan"] = np.asarray(np.isfinite(
        hvd.SyncBatchNormalization(axis=-1)(x, training=True).numpy()).all())
    # Rank-distinct: each rank's rows of BatchNormalization over both
    # ranks' batches (equal per-rank batch sizes).
    xd = tf.constant(np.random.RandomState(30 + r).randn(8, 3).astype(
        np.float32) * (r + 1) + r)
    sbn = hvd.SyncBatchNormalization(axis=-1)
    with tf.GradientTape() as t:
        t.watch(xd)
        yd = sbn(xd, training=True)
        ld = tf.reduce_sum(yd * tf.constant(np.arange(24, dtype=np.float32)
                                            .reshape(8, 3)))
    out["sbn_fwd_d"] = yd.numpy()
    out["sbn_moving_mean_d"] = sbn.moving_mean.numpy()
    out["sbn_grad_finite_d"] = np.asarray(
        np.isfinite(t.gradient(ld, xd).numpy()).all())
    return out


def case_elastic(hvd, r, n):
    out = {}
    v1, v2 = tf.Variable([1.0, 2.0]), tf.Variable(3.0)
    state = hvd.elastic.TensorFlowState(variables=[v1, v2], step=5)
    v1.assign([9.0, 9.0])
    v2.assign(0.0)
    state.step = 11
    state.restore()
    out["tfstate_restore"] = np.asarray([*v1.numpy(), v2.numpy(),
                                         state.step])
    v1.assign(dist(r, (2,)))
    state.sync()
    out["tfstate_sync_d"] = v1.numpy()
    m = tf.keras.Sequential([tf.keras.layers.Dense(2)])
    m(tf.ones((1, 3)))
    m.set_weights([w * 0 + dist(r, w.shape) for w in m.get_weights()])
    state = hvd.elastic.TensorFlowKerasState(m, epoch=4)
    saved = [w.copy() for w in m.get_weights()]
    m.set_weights([w * 0 + 7 for w in m.get_weights()])
    state.epoch = 9
    state.restore()
    out["kstate_restore"] = np.asarray(
        all(np.array_equal(a, b) for a, b in zip(m.get_weights(), saved))
        and state.epoch == 4)
    state.sync()
    out["kstate_sync_d"] = np.concatenate(
        [w.ravel() for w in m.get_weights()])
    opt = tf.keras.optimizers.SGD(0.1, momentum=0.9)
    for _ in range(2):
        with tf.GradientTape() as t:
            loss = tf.reduce_sum(m(tf.ones((2, 3))) ** 2)
        opt.apply_gradients(zip(t.gradient(loss, m.trainable_variables),
                                m.trainable_variables))
        if _ == 0:
            state = hvd.elastic.TensorFlowKerasState(m, optimizer=opt,
                                                     epoch=1)
            snap = [x.copy() for x in state._opt_vars]
    state.restore()
    out["kstate_opt_restore"] = np.asarray(all(
        np.array_equal(a, b) for a, b in zip(state._opt_variables(), snap)))
    state.sync()
    return out
'''
exec(CASES)

WORKER = CASES + r'''
import sys
import torch
import horovod_tpu_torch.tensorflow as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.tensorflow import _bridge as B

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
handed = []
for k in ("allreduce", "grouped_allreduce", "allgather", "broadcast",
          "alltoall", "reducescatter", "grouped_allgather",
          "grouped_reducescatter"):
    def spy(x, *a, _fn=getattr(C, k), _k=k, **kw):
        xs = x if isinstance(x, list) else [x]
        handed.append((_k, [str(t.device) for t in xs],
                       threading.current_thread() is threading.main_thread()))
        return _fn(x, *a, **kw)
    setattr(C, k, spy)
res = {}
for name, fn in sorted(globals().items()):
    if name.startswith("case_"):
        res[name] = fn(hvd, r, n)
res["handed"] = handed
bridge = {}
for dt in (tf.float16, tf.bfloat16, tf.float32, tf.int32, tf.int64, tf.bool,
           tf.uint8):
    t = tf.cast(tf.constant([[1, 0], [3, 4]]), dt)
    a = B.tf_to_torch(t)
    back = B.torch_to_tf(a, like=t)
    bridge[dt.name] = (str(a.dtype), str(a.device), back.dtype.name,
                       np.array_equal(tf.cast(back, tf.float64).numpy(),
                                      tf.cast(t, tf.float64).numpy()))
f8 = tf.cast(tf.constant([1.0, -2.0, 0.5]), tf.dtypes.experimental.float8_e4m3fn)
a = B.tf_to_torch(f8)
bridge["float8"] = (str(a.dtype), a.float().tolist(),
                    tf.cast(B.torch_to_tf(a), tf.float32).numpy().tolist())
v = tf.Variable([1.0, 2.0])
sl = tf.IndexedSlices(values=tf.ones((1, 2)), indices=tf.constant([1]),
                      dense_shape=tf.constant([3, 2]))
bridge["densify"] = (tuple(B.tf_to_torch(v).shape), tuple(B.tf_to_torch(sl).shape))
bridge["like_i64"] = B.torch_to_tf(torch.arange(4, dtype=torch.int32),
                                   like=tf.constant([0], tf.int64)).dtype.name
bridge["like_slices"] = B.torch_to_tf(torch.ones(2), like=tf.IndexedSlices(
    tf.ones((1, 2), tf.float16), tf.constant([0]))).dtype.name
res["bridge"] = bridge
hvd.barrier()
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("tensorflow"), N, WORKER,
                     timeout=300)


@pytest.fixture(scope="module")
def jax_results():
    return {name: fn(jtf, 0, JN) for name, fn in sorted(globals().items())
            if name.startswith("case_")}


# Rank-identical results the port gives bitwise as JAX does.
SAME = {
    "case_gradients": ["allreduce_grad", "reducescatter_grad",
                       "alltoall_grad", "alltoall_splits_grad",
                       "alltoall_splits_recv", "scalar_allgather_shape",
                       "grouped_grad_a", "grouped_grad_b"],
    "case_ops": ["allreduce_avg", "allreduce_fp16_wire",
                 "allreduce_bfloat16", "allreduce_float16", "grouped_0",
                 "grouped_1", "size_op", "ps_ops", "grouped_allgather_rows",
                 "grouped_reducescatter_0", "grouped_reducescatter_1",
                 "allgather_rows", "allgather_head", "broadcast",
                 "alltoall_rows",
                 "broadcast_variables", "broadcast_object",
                 "broadcast_object_fn"],
    "case_graph_mode": ["graph_gather_rows", "graph_traced"],
    "case_sparse_and_fused": ["sparse_rows", "sparse_avg_dense",
                              "size1_short_circuit", "switch_sparse",
                              "switch_dense", "switch_other"],
    "case_tape": ["tape_avg", "tape_none", "tape_delegation", "predivide",
                  "predivide_plain", "predivide_sum_refused"],
    "case_optimizer": ["accum_first_none", "accum_after_first", "apply"],
    "case_sync_batch_norm": ["sbn_local_diff", "sbn_infer_finite",
                             "sbn_no_nan"],
    "case_elastic": ["tfstate_restore", "kstate_restore",
                     "kstate_opt_restore"],
}
# Rank-identical results that grow with the world: the port's are JAX's
# times N / JN, bitwise.
SCALED = {
    "case_gradients": ["allgather_grad", "broadcast_grad",
                       "scalar_allgather_grad"],
    "case_ops": ["allreduce_sum", "allreduce_i32", "allreduce_i64",
                 "async_sum"],
    "case_graph_mode": ["graph_sum"],
    "case_sparse_and_fused": ["sparse_sum_dense", "fused_0", "fused_1",
                              "fused_2", "fused_3"],
}


@pytest.mark.parametrize("case", sorted(SAME))
def test_rank_identical_results_are_jaxs_bitwise(world, jax_results, case):
    for d in world:
        for key in SAME[case]:
            got, want = d[case][key], jax_results[case][key]
            assert got.dtype == want.dtype or key.startswith("allreduce_"), \
                (key, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("case", sorted(SCALED))
def test_size_scaled_results_are_jaxs_times_n_over_8(world, jax_results,
                                                     case):
    for r, d in enumerate(world):
        for key in SCALED[case]:
            want = np.asarray(jax_results[case][key]) * N / JN
            if key == "broadcast_grad" and r != 0:
                want = np.zeros_like(want)  # a non-root input's gradient
            np.testing.assert_array_equal(d[case][key], want, err_msg=key)


def _stack(shape, dtype=np.float32):
    return np.stack([dist(r, shape, dtype) for r in range(N)])


def test_rank_distinct_collectives(world):
    for r, d in enumerate(world):
        o = d["case_ops"]
        np.testing.assert_array_equal(o["allreduce_avg_d"],
                                      _stack((3, 2)).sum(0) / N)
        assert o["allreduce_i64_d"].dtype == np.int64
        np.testing.assert_array_equal(o["allreduce_i64_d"],
                                      (_stack((5,), np.int64) * 4).sum(0))
        np.testing.assert_array_equal(o["allgather_d"], np.concatenate(
            [dist(s, (s + 1, 2)) for s in range(N)]))
        np.testing.assert_array_equal(o["broadcast_d"], dist(1, (3,)))
        np.testing.assert_array_equal(o["broadcast_variables_d"],
                                      dist(1, (2, 2)))
        np.testing.assert_array_equal(o["reducescatter_d"],
                                      _stack((2 * N, 2)).sum(0)[2 * r:2 * r + 2])
        sends = [dist(s, (3, 2)) for s in range(N)]
        splits = [[1, 2], [2, 1]]
        rows = [sends[s][sum(splits[s][:r]):sum(splits[s][:r + 1])]
                for s in range(N)]
        np.testing.assert_array_equal(o["alltoall_splits_d"],
                                      np.concatenate(rows))
        np.testing.assert_array_equal(o["alltoall_recv_splits_d"],
                                      [splits[s][r] for s in range(N)])
        np.testing.assert_array_equal(o["bf16_d"], _stack((4,)).sum(0))
        np.testing.assert_array_equal(o["allgather_object"], [0, 1])
        g = d["case_graph_mode"]
        np.testing.assert_array_equal(g["graph_sum_d"], _stack((3,)).sum(0))
        # The Sum allreduce's gradient: the sum of the ranks' (r + 1).
        np.testing.assert_array_equal(
            d["case_gradients"]["allreduce_sum_grad_d"],
            np.full(4, sum(s + 1.0 for s in range(N))))


def test_rank_distinct_sparse_fused_tape_and_optimizer(world):
    dense = np.zeros((N, 4, 2), np.float32)
    for s in range(N):
        dense[s, [s, 3]] += dist(s, (2, 2))
    for d in world:
        f = d["case_sparse_and_fused"]
        np.testing.assert_array_equal(f["sparse_avg_dense_d"],
                                      dense.sum(0) / N)
        np.testing.assert_array_equal(f["fused_d_0"], _stack((2, 3)).sum(0))
        np.testing.assert_array_equal(f["fused_d_1"], _stack((4,)).sum(0))
        t = d["case_tape"]
        np.testing.assert_array_equal(t["tape_d"], _stack((3,)).sum(0) / N)
        # The predivide split: 1/f before the Sum, f/N after.
        want = (_stack((3,)) * np.float32(0.25)).sum(0) * np.float32(4.0 / N)
        np.testing.assert_array_equal(t["tape_predivide_d"], want)
        o = d["case_optimizer"]
        acc = (_stack((2,)) + 1.0 + _stack((2,)) * 2.0) / 2
        np.testing.assert_allclose(o["accum_after_second_d"],
                                   1.0 - acc.sum(0) / N, rtol=0, atol=1e-6)


def test_sync_batch_norm_matches_jax_and_the_whole_batch(world, jax_results):
    """Rank-identical: forward and gradients within 1e-5 of JAX's (f32,
    E[x^2] - mean^2 in each package's order) and of local BN; distinct:
    each rank's rows of BatchNormalization over both ranks' batches,
    within 1e-4 of its largest value (the variance as E[x^2] - mean^2)."""
    j = jax_results["case_sync_batch_norm"]
    xs = np.concatenate([np.random.RandomState(30 + s).randn(8, 3).astype(
        np.float32) * (s + 1) + s for s in range(N)])
    mean, var = xs.mean(0), xs.var(0)
    full = (xs - mean) / np.sqrt(var + 1e-3)
    for r, d in enumerate(world):
        s = d["case_sync_batch_norm"]
        np.testing.assert_allclose(s["sbn_fwd"], j["sbn_fwd"], atol=1e-5)
        np.testing.assert_allclose(s["sbn_grad"], j["sbn_grad"], atol=1e-4)
        np.testing.assert_allclose(s["sbn_grad"], s["sbn_grad_local"],
                                   atol=1e-4)
        got = s["sbn_fwd_d"]
        np.testing.assert_allclose(got, full[8 * r:8 * r + 8], rtol=0,
                                   atol=1e-4 * np.abs(full).max())
        np.testing.assert_allclose(s["sbn_moving_mean_d"], 0.01 * mean,
                                   rtol=1e-5, atol=1e-6)
        assert s["sbn_grad_finite_d"]


def test_elastic_states_sync_rank0(world):
    for d in world:
        e = d["case_elastic"]
        np.testing.assert_array_equal(e["tfstate_sync_d"], dist(0, (2,)))
        want = np.concatenate([dist(0, (3, 2)).ravel(), dist(0, (2,))])
        np.testing.assert_array_equal(e["kstate_sync_d"], want)


def test_collectives_take_tensors_on_the_ranks_device(world):
    """Every tensor handed to the port's collective core is on
    `hvd.device()` (the CPU here: init(device="cpu")); the graph-mode
    cases hand theirs from TF's executor threads."""
    for d in world:
        handed = d["handed"]
        kinds = {k for k, _, _ in handed}
        assert {"allreduce", "grouped_allreduce", "allgather", "broadcast",
                "alltoall", "reducescatter"} <= kinds
        assert all(dev == "cpu" for _, devs, _ in handed for dev in devs)
        assert any(not main for _, _, main in handed)


def test_bridge_dtype_fidelity(world):
    for d in world:
        b = d["bridge"]
        for name, want in (("float16", "torch.float16"),
                           ("bfloat16", "torch.bfloat16"),
                           ("float32", "torch.float32"),
                           ("int32", "torch.int32"), ("int64", "torch.int64"),
                           ("bool", "torch.bool"), ("uint8", "torch.uint8")):
            dt, dev, back, equal = b[name]
            assert (dt, dev, back, equal) == (want, "cpu", name, True), name
        assert b["float8"] == ("torch.float8_e4m3fn", [1.0, -2.0, 0.5],
                               [1.0, -2.0, 0.5])
        assert b["densify"] == ((2,), (3, 2))
        assert b["like_i64"] == "int64"
        assert b["like_slices"] == "float16"


def test_bridge_moves_to_the_card_when_that_is_the_ranks_device(monkeypatch):
    """The collective never stays on the CPU because TF's tensor is
    there: `tf_to_torch` moves to `hvd.device()` (a meta device stands
    in for the card here)."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.tensorflow import _bridge as B

    monkeypatch.setattr(basics, "device", lambda: torch.device("meta"))
    t = B.tf_to_torch(tf.constant([1.0, 2.0], tf.bfloat16))
    assert t.device.type == "meta" and t.dtype == torch.bfloat16
