"""Port parity: `horovod_tpu_torch.mxnet` against `horovod_tpu.mxnet`,
on the duck-typed NDArray of `tests/test_mxnet_shim.py` (mxnet is not
installed; the frontend needs only `asnumpy()` and slice assignment).

One np=2 gloo world on the CPU runs the cases of `test_mxnet_shim.py`
and saves what each rank got.  The JAX frontend runs the same cases in
this process on its eight simulated ranks (a plain array: every rank
contributes it).  Inputs identical on every rank, of few significant
bits, make an Average exact at 2 ranks and at 8, so those results are
held to JAX's bitwise; rank-distinct inputs are held bitwise to the JAX
core's reduction of the stacked inputs (`_jax_reduce`) where the sums
are exact (small integers and halves), else within the stated f32
tolerance.  The port keeps int64 where the JAX core narrows it to
int32: values are compared.
"""

import numpy as np
import pytest
import torch

import horovod_tpu.mxnet as jmx

from test_torch_port_collectives import (  # noqa: F401 (autouse)
    _jax_reduce, no_launcher_env, run_world)

N = 2   # the port's ranks
JN = 8  # the JAX package's simulated ranks

FAKES = r'''
import types
import numpy as np


class FakeNDArray:
    """The NDArray surface the frontends rely on."""

    def __init__(self, data):
        self._data = np.array(data, copy=True)

    def asnumpy(self):
        return self._data.copy()

    def __setitem__(self, key, value):
        self._data[key] = value

    def __truediv__(self, other):
        return FakeNDArray(self._data / other)

    @property
    def shape(self):
        return self._data.shape


class FakeOptimizer:
    """The mx.optimizer.Optimizer surface DistributedOptimizer uses."""

    def __init__(self):
        self.updates = []
        self.learning_rate = 0.5

    def update(self, index, weight, grad, state):
        self.updates.append(("update", index))
        if isinstance(index, (list, tuple)):
            for w, g in zip(weight, grad):
                w[:] = w.asnumpy() - self.learning_rate * g.asnumpy()
            return
        weight[:] = weight.asnumpy() - self.learning_rate * grad.asnumpy()

    def update_multi_precision(self, index, weight, grad, state):
        self.updates.append(("ump", index))
        weight[:] = weight.asnumpy() - self.learning_rate * grad.asnumpy()

    def set_learning_rate(self, lr):
        self.learning_rate = lr


def fake_mx():
    class FakeTrainerBase:
        def __init__(self, params, optimizer, optimizer_params=None,
                     kvstore=None):
            self._params = params
            self._kvstore = kvstore
            self._update_on_kvstore = True

        def step(self, batch_size, ignore_stale_grad=False):
            self._allreduce_grads()
            self._stepped = batch_size

    return types.SimpleNamespace(
        gluon=types.SimpleNamespace(Trainer=FakeTrainerBase),
        nd=types.SimpleNamespace(
            array=lambda a, dtype=None: FakeNDArray(np.asarray(a))))


class FakeParam:
    def __init__(self, g):
        self.grad_req = "write"
        self._g = FakeNDArray(g)

    def list_ctx(self):
        return ["cpu(0)"]

    def grad(self, ctx):
        return self._g


def distinct(r, shape, dtype=np.float32):
    """Rank r's input: small integers and halves, so that sums are
    exact."""
    n = int(np.prod(shape))
    return ((np.arange(n) % 7 - 3) * 0.5 * (r + 1) + r).reshape(
        shape).astype(dtype)
'''
exec(FAKES)

WORKER = FAKES + r'''
import sys
import torch
import horovod_tpu_torch.mxnet as hvd_mx
from horovod_tpu_torch.ops import collectives as C

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd_mx.init(coordinator_address=url, num_processes=n, process_id=r,
            device="cpu")
F = FakeNDArray
res = {}
seen = []
real = {k: getattr(C, k) for k in ("allreduce", "grouped_allreduce",
                                   "allgather", "broadcast")}
for k, fn in real.items():
    def spy(x, *a, _fn=fn, _k=k, **kw):
        xs = x if isinstance(x, list) else [x]
        seen.append((_k, [str(t.device) for t in xs]))
        return _fn(x, *a, **kw)
    setattr(C, k, spy)

out = hvd_mx.allreduce(F(np.arange(6, dtype=np.float32) * 0.25))
res["allreduce_type"] = type(out).__name__
res["allreduce_same"] = out.asnumpy()
res["allreduce_distinct"] = hvd_mx.allreduce(F(distinct(r, (6,)))).asnumpy()
res["allreduce_i64"] = hvd_mx.allreduce(
    F(distinct(r, (5,), np.int64) * 2), average=False).asnumpy()
t = F(np.ones(4, np.float32))
res["allreduce_inplace_is_t"] = hvd_mx.allreduce_(t, average=False) is t
res["allreduce_inplace"] = t.asnumpy()
ts = [F(np.ones(2, np.float32)), F(np.full(3, 2.0, np.float32))]
hvd_mx.grouped_allreduce_(ts, average=True)
res["grouped_inplace_same"] = [x.asnumpy() for x in ts]
res["grouped_distinct"] = [x.asnumpy() for x in hvd_mx.grouped_allreduce(
    [F(distinct(r, (2, 2))), F(distinct(r, (3,)))], average=False)]
res["allgather_same"] = hvd_mx.allgather(F(np.ones((2, 3), np.float32))).asnumpy()
res["allgather_distinct"] = hvd_mx.allgather(F(distinct(r, (r + 1, 3)))).asnumpy()
res["broadcast_same"] = hvd_mx.broadcast(F(np.full(3, 7.0, np.float32))).asnumpy()
res["broadcast_distinct"] = hvd_mx.broadcast(F(distinct(r, (3,))), root_rank=1).asnumpy()
b = F(distinct(r, (2, 2)))
hvd_mx.broadcast_(b, root_rank=1)
res["broadcast_inplace"] = b.asnumpy()
res["reducescatter_same"] = hvd_mx.reducescatter(F(np.ones((2 * n, 3), np.float32))).asnumpy()
res["reducescatter_distinct"] = hvd_mx.reducescatter(F(distinct(r, (2 * n, 3))), op=C.Sum).asnumpy()
outs = hvd_mx.grouped_reducescatter([F(np.ones((n, 2), np.float32)),
                                     F(np.ones((2 * n,), np.float32))])
res["grouped_reducescatter"] = [o.asnumpy() for o in outs]
res["grouped_allgather"] = [o.asnumpy() for o in hvd_mx.grouped_allgather(
    [F(distinct(r, (1, 2)))])]
res["alltoall_even"] = hvd_mx.alltoall(F(np.arange(n, dtype=np.float32) + 10 * r)).asnumpy()
recv, rsplits = hvd_mx.alltoall(F(np.arange(3, dtype=np.float32) + 10 * r),
                                splits=F(np.array([1, 2]) if r == 0 else np.array([2, 1])))
res["alltoall_splits"] = (recv.asnumpy(), rsplits.asnumpy())
params = {"w": F(distinct(r, (3,))), "b": F(distinct(r, (2,)) + 1)}
hvd_mx.broadcast_parameters(params, root_rank=0)
res["bcast_params"] = {k: v.asnumpy() for k, v in params.items()}
gp = {"g": FakeParam(distinct(r, (2,)))}
gp["g"].list_data = lambda: [gp["g"]._g]
hvd_mx.broadcast_parameters(gp, root_rank=1)
res["bcast_gluon"] = gp["g"]._g.asnumpy()
try:
    hvd_mx.broadcast_parameters([1, 2, 3])
except ValueError as e:
    res["bcast_list"] = str(e)
res["bcast_object"] = hvd_mx.broadcast_object({"epoch": r}, root_rank=1)
res["devices"] = seen[:]

for tag, g0 in (("same", np.full(3, 2.0, np.float32)), ("distinct", distinct(r, (3,)))):
    inner = FakeOptimizer()
    opt = hvd_mx.DistributedOptimizer(inner)
    w, g = F(np.ones(3, np.float32)), F(g0)
    opt.update(0, w, g, None)
    res[f"opt_{tag}"] = (g.asnumpy(), w.asnumpy(), inner.updates)
inner = FakeOptimizer()
opt = hvd_mx.DistributedOptimizer(inner)
ws = [F(np.ones(2, np.float32)), F(np.ones(2, np.float32))]
gs = [F(distinct(r, (2,))), F(np.full(2, 3.0, np.float32))]
opt.update([0, 1], ws, gs, [None, None])
res["opt_grouped"] = ([x.asnumpy() for x in gs], [x.asnumpy() for x in ws], list(inner.updates))
w, g = F(np.zeros(2, np.float32)), F(distinct(r, (2,)))
opt.update_multi_precision(2, w, g, None)
res["opt_ump"] = (g.asnumpy(), inner.updates[-1])
for tag, g0 in (("same", np.full(2, 4.0, np.float32)), ("distinct", distinct(r, (2,)))):
    opt = hvd_mx.DistributedOptimizer(FakeOptimizer(), gradient_predivide_factor=2.0)
    g = F(g0)
    opt.update(0, F(np.zeros(2, np.float32)), g, None)
    res[f"predivide_{tag}"] = g.asnumpy()
inner = FakeOptimizer()
hvd_mx.DistributedOptimizer(inner).set_learning_rate(0.25)
res["passthrough"] = (inner.learning_rate, hvd_mx.DistributedOptimizer(inner).learning_rate)
try:
    hvd_mx.DistributedTrainer({}, "sgd")
except ImportError as e:
    res["trainer_no_mx"] = str(e)

hvd_mx.mx = fake_mx()
calls = []
real_grouped = C.grouped_allreduce
def spy2(tensors, **kw):
    calls.append((len(list(tensors)), kw.get("average")))
    return real_grouped(tensors, **kw)
C.grouped_allreduce = spy2
params = {"w": FakeParam(distinct(r, (3,))), "b": FakeParam(np.full(2, 2.0, np.float32))}
trainer = hvd_mx.DistributedTrainer(params, "sgd", {"learning_rate": 0.1})
res["trainer_kv"] = trainer._update_on_kvstore
trainer.step(4)
res["trainer"] = (trainer._stepped, calls[:], params["w"]._g.asnumpy(), params["b"]._g.asnumpy())
params["b"].grad_req = "null"
calls.clear()
hvd_mx.DistributedTrainer(params, "sgd", {}).step(1)
res["trainer_null"] = calls[:]
C.grouped_allreduce = real_grouped
hvd_mx.mx = None
hvd_mx.barrier()
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd_mx.shutdown()
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("mxnet"), N, WORKER)


def _stack(shape, dtype=np.float32):
    return np.stack([distinct(r, shape, dtype) for r in range(N)])


def test_allreduce_matches_jax(world):
    jout = jmx.allreduce(FakeNDArray(np.arange(6, dtype=np.float32) * 0.25))
    for d in world:
        assert d["allreduce_type"] == "FakeNDArray"
        np.testing.assert_array_equal(d["allreduce_same"], jout.asnumpy())
        np.testing.assert_array_equal(d["allreduce_distinct"],
                                      _jax_reduce(_stack((6,)), "Average", N))
        assert d["allreduce_i64"].dtype == np.int64
        np.testing.assert_array_equal(
            d["allreduce_i64"],
            _jax_reduce(_stack((5,), np.int64).astype(np.int32) * 2, "Sum",
                        N))


def test_allreduce_sum_inplace(world):
    t = FakeNDArray(np.ones(4, np.float32))
    assert jmx.allreduce_(t, average=False) is t
    np.testing.assert_array_equal(t.asnumpy(), np.full(4, float(JN)))
    for d in world:
        assert d["allreduce_inplace_is_t"]
        np.testing.assert_array_equal(d["allreduce_inplace"],
                                      np.full(4, float(N)))


def test_grouped_allreduce(world):
    ts = [FakeNDArray(np.ones(2, np.float32)),
          FakeNDArray(np.full(3, 2.0, np.float32))]
    jmx.grouped_allreduce_(ts, average=True)
    for d in world:
        for got, want in zip(d["grouped_inplace_same"], ts):
            np.testing.assert_array_equal(got, want.asnumpy())
        for got, shape in zip(d["grouped_distinct"], [(2, 2), (3,)]):
            np.testing.assert_array_equal(got, _jax_reduce(
                _stack(shape), "Sum", N))


def test_allgather(world):
    jout = jmx.allgather(FakeNDArray(np.ones((2, 3), np.float32)))
    assert jout.asnumpy().shape == (2 * JN, 3)
    for d in world:
        assert d["allgather_same"].shape == (2 * N, 3)
        np.testing.assert_array_equal(d["allgather_same"],
                                      jout.asnumpy()[:2 * N])
        np.testing.assert_array_equal(d["allgather_distinct"], np.concatenate(
            [distinct(r, (r + 1, 3)) for r in range(N)]))
        np.testing.assert_array_equal(d["grouped_allgather"][0],
                                      np.concatenate([distinct(r, (1, 2))
                                                      for r in range(N)]))


def test_broadcast(world):
    jout = jmx.broadcast(FakeNDArray(np.full(3, 7.0, np.float32)))
    for d in world:
        np.testing.assert_array_equal(d["broadcast_same"], jout.asnumpy())
        np.testing.assert_array_equal(d["broadcast_distinct"],
                                      distinct(1, (3,)))
        np.testing.assert_array_equal(d["broadcast_inplace"],
                                      distinct(1, (2, 2)))


def test_reducescatter(world):
    jout = jmx.reducescatter(FakeNDArray(np.ones((2 * JN, 3), np.float32)))
    jg = jmx.grouped_reducescatter(
        [FakeNDArray(np.ones((JN, 2), np.float32)),
         FakeNDArray(np.ones((2 * JN,), np.float32))])
    summed = _jax_reduce(_stack((2 * N, 3)), "Sum", N)
    for r, d in enumerate(world):
        np.testing.assert_array_equal(d["reducescatter_same"],
                                      jout.asnumpy())
        np.testing.assert_array_equal(d["reducescatter_distinct"],
                                      summed[2 * r:2 * r + 2])
        for got, want in zip(d["grouped_reducescatter"], jg):
            np.testing.assert_array_equal(got, want.asnumpy())


def test_alltoall(world):
    assert jmx.alltoall(FakeNDArray(np.arange(JN, dtype=np.float32))
                        ).asnumpy().shape == (JN,)
    for r, d in enumerate(world):
        np.testing.assert_array_equal(d["alltoall_even"],
                                      [r + 10 * s for s in range(N)])
        recv, rsplits = d["alltoall_splits"]
        sends = {0: [[0.0], [1.0, 2.0]], 1: [[10.0, 11.0], [12.0]]}
        want = sends[0][r] + sends[1][r]
        np.testing.assert_array_equal(recv, want)
        np.testing.assert_array_equal(rsplits, [len(sends[0][r]),
                                                len(sends[1][r])])


def test_broadcast_parameters_and_object(world):
    params = {"w": FakeNDArray(np.ones(3, np.float32)),
              "b": FakeNDArray(np.zeros(2, np.float32))}
    jmx.broadcast_parameters(params, root_rank=0)
    np.testing.assert_array_equal(params["w"].asnumpy(), 1.0)
    with pytest.raises(ValueError, match="invalid params"):
        jmx.broadcast_parameters([1, 2, 3])
    for d in world:
        np.testing.assert_array_equal(d["bcast_params"]["w"],
                                      distinct(0, (3,)))
        np.testing.assert_array_equal(d["bcast_params"]["b"],
                                      distinct(0, (2,)) + 1)
        np.testing.assert_array_equal(d["bcast_gluon"], distinct(1, (2,)))
        assert "invalid params" in d["bcast_list"]
        assert d["bcast_object"] == {"epoch": 1}


def test_collectives_take_tensors_on_the_ranks_device(world):
    for d in world:
        kinds = {k for k, _ in d["devices"]}
        assert kinds == {"allreduce", "grouped_allreduce", "allgather",
                         "broadcast"}
        assert all(dev == "cpu" for _, devs in d["devices"] for dev in devs)


def _jax_opt(g0, **kw):
    inner = FakeOptimizer()
    opt = jmx.DistributedOptimizer(inner, **kw)
    w, g = FakeNDArray(np.ones(len(g0), np.float32)), FakeNDArray(g0)
    opt.update(0, w, g, None)
    return g.asnumpy(), w.asnumpy(), inner.updates


def test_distributed_optimizer_matches_jax(world):
    jg, jw, jup = _jax_opt(np.full(3, 2.0, np.float32))
    for r, d in enumerate(world):
        g, w, up = d["opt_same"]
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(w, jw)
        assert up == jup == [("update", 0)]
        g, w, _ = d["opt_distinct"]
        want = _jax_reduce(_stack((3,)), "Average", N)
        np.testing.assert_array_equal(g, want)
        np.testing.assert_array_equal(
            w, np.float32(1.0) - np.float32(0.5) * want)
        gs, ws, up = d["opt_grouped"]
        np.testing.assert_array_equal(gs[0], _jax_reduce(_stack((2,)),
                                                         "Average", N))
        np.testing.assert_array_equal(gs[1], np.full(2, 3.0))
        assert up == [("update", [0, 1])]
        g, last = d["opt_ump"]
        np.testing.assert_array_equal(g, _jax_reduce(_stack((2,)),
                                                     "Average", N))
        assert last == ("ump", 2)


def test_predivide_is_scale_neutral(world):
    jg, _, _ = _jax_opt(np.full(2, 4.0, np.float32),
                        gradient_predivide_factor=2.0)
    for d in world:
        np.testing.assert_array_equal(d["predivide_same"], jg)
        np.testing.assert_array_equal(
            d["predivide_distinct"],
            _jax_reduce(_stack((2,)), "Average", N, pre=0.5, post=2.0))


def test_passthrough_and_trainer(world):
    inner = FakeOptimizer()
    jmx.DistributedOptimizer(inner).set_learning_rate(0.25)
    for d in world:
        assert d["passthrough"] == (inner.learning_rate, 0.25)
        assert "requires mxnet" in d["trainer_no_mx"]
        assert d["trainer_kv"] is False
        stepped, calls, w, b = d["trainer"]
        assert stepped == 4 and calls == [(2, True)]
        np.testing.assert_array_equal(w, _jax_reduce(_stack((3,)),
                                                     "Average", N))
        np.testing.assert_array_equal(b, np.full(2, 2.0))
        assert d["trainer_null"] == [(1, True)]


def test_trainer_requires_mxnet_in_both_packages():
    import horovod_tpu_torch.mxnet as pmx

    assert pmx.mx is None and jmx.mx is None
    for mod in (pmx, jmx):
        with pytest.raises(ImportError, match="requires mxnet"):
            mod.DistributedTrainer({}, "sgd")
