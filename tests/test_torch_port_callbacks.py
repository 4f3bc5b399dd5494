"""Port parity: the framework-neutral frontend of `horovod_tpu_torch`
(the tree `broadcast_parameters`, the four callbacks, `distributed_grad`
and `DistributedGradientTape`, `shard_batch` and `data_parallel`, and
`tape_mnist`) against the JAX package's.

One np=2 gloo world on the CPU runs every case and saves what each rank
got.  The JAX side runs in this process on its eight simulated ranks,
where a plain array means "every rank contributes this": with
rank-identical inputs of few significant bits an Average is exact at 2
ranks and at 8, and the port's results are held to JAX's bitwise where
the op does not depend on order; with rank-distinct inputs they are held to the JAX core's
reduction of the stacked inputs (`_jax_reduce`), each tolerance stated.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu import callbacks as JCB
from horovod_tpu.parallel import data_parallel as JDP

from test_torch_port_collectives import (  # noqa: F401 (autouse)
    REPO, LAUNCHER_ENV, _jax_reduce, no_launcher_env, run_world)

N = 2
# The gradients of the tape's loss: f32 in a different order of sums in
# torch and XLA, relative to the largest element.
GRAD_RTOL = 1e-5


# The inputs, made from seeds: this module and the world's ranks run the
# same source.
INPUTS = r'''
import numpy as np


def _params(r):
    rng = np.random.RandomState(10 + r)
    return {"w": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(3).astype(np.float32)}


def _batch(r):
    rng = np.random.RandomState(50 + r)
    return (rng.randn(6, 4).astype(np.float32),
            rng.randn(6, 3).astype(np.float32))


def _tree(r):
    rng = np.random.RandomState(70 + r)
    return {"a": rng.randn(3, 2).astype(np.float32),
            "n": [np.arange(4, dtype=np.int64) * (r + 3),
                  (rng.randn(5).astype(np.float32),)]}
'''
exec(INPUTS)


WORKER = INPUTS + r'''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import functions as F

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")

def t(a):
    return torch.from_numpy(np.asarray(a))

def tree_t(tr):
    return {"a": t(tr["a"]), "n": [t(tr["n"][0]), (t(tr["n"][1][0]).bfloat16(),)]}

res = {}
mine = tree_t(_tree(r))
res["bcast_tree"] = F.broadcast_parameters(mine, root_rank=1)
res["bcast_tree_input_untouched"] = torch.equal(mine["a"], t(_tree(r)["a"]))
res["bcast_opt_is_params"] = F.broadcast_optimizer_state is F.broadcast_parameters
cb = hvd.callbacks.BroadcastGlobalVariablesCallback(0)
first = cb.on_train_begin(tree_t(_tree(r)))
again_in = tree_t(_tree(r))
res["cb_first"] = first
res["cb_second_is_input"] = cb.on_train_begin(again_in) is again_in
avg = hvd.callbacks.MetricAverageCallback()
res["metric_same"] = avg.on_epoch_end({"loss": 0.375, "acc": torch.tensor(0.625)})
res["metric_distinct"] = avg.on_epoch_end({"loss": 0.25 + r, "acc": 1.0 / (r + 3)})
res["warmup_size"] = hvd.callbacks.LearningRateWarmupCallback(2, 0.1).size
res["process"] = (hvd.process_index(), hvd.num_processes(),
                  hvd.local_device_ranks(), hvd.joined_ranks())

def loss_fn(p, x, y):
    return ((x @ p["w"] + p["b"] - y) ** 2).mean()

def loss_aux(p, x, y):
    return loss_fn(p, x, y), {"pred": x @ p["w"]}

def loss_two(p, q, x, y):
    return loss_fn(p, x, y) + (q ** 2).sum()

P = {k: t(v) for k, v in _params(0).items()}
for tag, (x, y) in (("same", _batch(0)), ("distinct", _batch(r))):
    x, y = t(x), t(y)
    res[f"dg_{tag}"] = hvd.distributed_grad(loss_fn)(P, x, y)
    res[f"tape_{tag}"] = hvd.DistributedGradientTape().gradient(loss_fn, P, x, y)
    res[f"aux_{tag}"] = hvd.distributed_grad(loss_aux, has_aux=True)(P, x, y)
    res[f"two_{tag}"] = hvd.distributed_grad(loss_two, argnums=(0, 1))(
        P, torch.tensor([1.5, -2.0]), x, y)
    res[f"sum_{tag}"] = hvd.distributed_grad(loss_fn, op=hvd.Sum)(P, x, y)
res["P_untouched"] = all(torch.equal(P[k], t(v)) for k, v in _params(0).items())

bn = torch.nn.BatchNorm1d(3)
before = bn.running_mean.clone()
def bn_loss(p, x):
    return (bn(x @ p["w"]) ** 2).mean()
hvd.distributed_grad(bn_loss)(P, t(_batch(r)[0]))
res["bn_stats_moved"] = not torch.equal(bn.running_mean, before)
res["bn_tracked"] = int(bn.num_batches_tracked)
try:
    hvd.distributed_grad(lambda i: i.sum())(torch.arange(3))
    res["int_grad"] = "no error"
except TypeError as e:
    res["int_grad"] = str(e)

xb = _batch(r)[0]
sharded = hvd.shard_batch((xb, [np.arange(3)]))
res["shard_batch"] = sharded
seen = []
step = hvd.data_parallel(lambda p, s, batch: (seen.append(batch), p + 1)[1])
res["dp_out"] = step(torch.zeros(2), None, (xb,))
res["dp_batch_is_tensor"] = isinstance(seen[0][0], torch.Tensor)
hvd.barrier()
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("callbacks"), N, WORKER)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jtree(tr):
    return {"a": jnp.asarray(tr["a"]),
            "n": [jnp.asarray(tr["n"][0].astype(np.int32)),
                  (jnp.asarray(tr["n"][1][0], jnp.bfloat16),)]}


def test_tree_broadcast_parameters_is_root_bitwise(world):
    want = _tree(1)
    jwant = jax.tree_util.tree_leaves(
        jhvd.broadcast_parameters(_jtree(_tree(1))))
    for d in world:
        got = d["bcast_tree"]
        assert got["a"].dtype == torch.float32
        assert got["n"][0].dtype == torch.int64
        assert got["n"][1][0].dtype == torch.bfloat16
        assert isinstance(got["n"], list) and isinstance(got["n"][1], tuple)
        np.testing.assert_array_equal(got["a"].numpy(), want["a"])
        np.testing.assert_array_equal(got["n"][0].numpy(), want["n"][0])
        # The JAX broadcast of the root's tree (identical contributions):
        # the same values, bf16 leaf included.
        np.testing.assert_array_equal(_np(got["n"][1][0]),
                                      np.asarray(jwant[2], np.float32))
        np.testing.assert_array_equal(got["a"].numpy(), np.asarray(jwant[0]))
        assert d["bcast_tree_input_untouched"]
        assert d["bcast_opt_is_params"]
    assert jhvd.broadcast_optimizer_state is jhvd.broadcast_parameters


def test_broadcast_callback_fires_once(world):
    jcb = JCB.BroadcastGlobalVariablesCallback(0)
    jfirst = jcb.on_train_begin(_jtree(_tree(0)))
    again = _jtree(_tree(3))
    assert jcb.on_train_begin(again) is again
    for d in world:
        np.testing.assert_array_equal(d["cb_first"]["a"].numpy(),
                                      np.asarray(jfirst["a"]))
        np.testing.assert_array_equal(d["cb_first"]["n"][0].numpy(),
                                      _tree(0)["n"][0])
        assert d["cb_second_is_input"]


def test_metric_average_callback(world):
    # Values of few significant bits: JAX's sum of eight equal f32 values
    # is then exact, as the port's of two is.
    jout = JCB.MetricAverageCallback().on_epoch_end({"loss": 0.375,
                                                     "acc": 0.625})
    for d in world:
        got = d["metric_same"]
        assert got["loss"].dtype == torch.float32
        assert float(got["loss"]) == float(jout["loss"])
        assert float(got["acc"]) == float(jout["acc"])
        # Rank-distinct: the mean of the two ranks' f32 values, bitwise.
        for k, vals in (("loss", [0.25, 1.25]), ("acc", [1 / 3, 1 / 4])):
            want = _jax_reduce(np.asarray(vals, np.float32), "Average", N)
            assert float(d["metric_distinct"][k]) == float(want)


def test_process_queries_of_a_one_rank_a_process_port(world):
    """JAX's process_index / num_processes count processes driving
    several chips each; a port process is one rank."""
    for r, d in enumerate(world):
        assert d["process"] == (r, N, [r], [])


@pytest.mark.parametrize("warmup_epochs", [1, 3])
def test_warmup_lr_matches_jax_exactly(world, warmup_epochs):
    assert all(d["warmup_size"] == N for d in world)
    from horovod_tpu_torch import callbacks as PCB

    port = PCB.LearningRateWarmupCallback(warmup_epochs, 0.4)
    jax_cb = JCB.LearningRateWarmupCallback(warmup_epochs, 0.4)
    port.size = jax_cb.size = N
    for epoch in range(warmup_epochs + 2):
        for batches in (1, 7):
            for batch in range(batches):
                assert port.lr(epoch, batches, batch) == \
                    jax_cb.lr(epoch, batches, batch)
    assert port.lr(0) == 0.4 / N
    assert port.lr(warmup_epochs) == 0.4


def test_schedule_lr_matches_jax_exactly():
    from horovod_tpu_torch import callbacks as PCB

    sched = [{"start_epoch": 0, "end_epoch": 3, "multiplier": 1.0},
             {"start_epoch": 2, "end_epoch": 6, "multiplier": 0.1},
             {"start_epoch": 6, "multiplier": lambda e: 0.5 ** e}]
    port = PCB.LearningRateScheduleCallback(sched, 0.3)
    jax_cb = JCB.LearningRateScheduleCallback(sched, 0.3)
    for epoch in range(12):
        assert port.lr(epoch) == jax_cb.lr(epoch)
    assert port.lr(2) == 0.3  # the first matching row wins
    assert PCB.LearningRateScheduleCallback([], 0.2).lr(5) == 0.2


def _jloss(p, x, y):
    return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)


def _jparams():
    return {k: jnp.asarray(v) for k, v in _params(0).items()}


def _close(got, want, rtol=GRAD_RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _check_grads(got, want):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


def test_distributed_grad_matches_jax_on_identical_batches(world):
    """JAX's distributed_grad on its eight ranks (each contributing the
    same batch) against the port's on two."""
    x, y = (jnp.asarray(a) for a in _batch(0))
    jval, jgrads = JDP.distributed_grad(_jloss)(_jparams(), x, y)
    for d in world:
        for key in ("dg_same", "tape_same"):
            val, grads = d[key]
            _close(val, jval)
            _check_grads(grads, jgrads)
        (val, aux), grads = d["aux_same"]
        (jv, jaux), jg = JDP.distributed_grad(
            lambda p, x, y: (_jloss(p, x, y), {"pred": x @ p["w"]}),
            has_aux=True)(_jparams(), x, y)
        _close(val, jv)
        _close(aux["pred"], jaux["pred"])
        _check_grads(grads, jg)
    jtape = JDP.DistributedGradientTape().gradient(_jloss, _jparams(), x, y)
    _check_grads(world[0]["tape_same"][1], jtape[1])


def test_distributed_grad_argnums_matches_jax(world):
    def jtwo(p, q, x, y):
        return _jloss(p, x, y) + jnp.sum(q ** 2)

    x, y = (jnp.asarray(a) for a in _batch(0))
    q = jnp.asarray([1.5, -2.0])
    jval, (jg, jq) = JDP.distributed_grad(jtwo, argnums=(0, 1))(
        _jparams(), q, x, y)
    for d in world:
        val, (g, gq) = d["two_same"]
        _close(val, jval)
        _check_grads(g, jg)
        _close(gq, jq)


@pytest.mark.parametrize("op", ["Average", "Sum"])
def test_distributed_grad_on_distinct_batches_is_the_reduced_local_grads(
        world, op):
    """Each rank's local value_and_grad (JAX) reduced over the two ranks
    by the JAX core's math; the value stays the rank's own."""
    vg = jax.value_and_grad(_jloss)
    local = [vg(_jparams(), *(jnp.asarray(a) for a in _batch(r)))
             for r in range(N)]
    key = "dg_distinct" if op == "Average" else "sum_distinct"
    for r, d in enumerate(world):
        val, grads = d[key]
        _close(val, local[r][0])
        for k in ("w", "b"):
            stacked = np.stack([np.asarray(local[i][1][k]) for i in range(N)])
            _close(grads[k], _jax_reduce(stacked, op, N))
    # The ranks' reduced gradients agree bitwise.
    for k in ("w", "b"):
        assert torch.equal(world[0]["dg_distinct"][1][k],
                           world[1]["dg_distinct"][1][k])
        assert torch.equal(world[0]["tape_distinct"][1][k],
                           world[0]["dg_distinct"][1][k])


def test_distributed_grad_updates_module_state_and_refuses_integers(world):
    for d in world:
        assert d["P_untouched"]
        assert d["bn_stats_moved"] and d["bn_tracked"] == 1
        assert "floating-point" in d["int_grad"]


def test_shard_batch_and_data_parallel_run_the_ranks_own_batch(world):
    for r, d in enumerate(world):
        x, rest = d["shard_batch"]
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), _batch(r)[0])
        np.testing.assert_array_equal(rest[0].numpy(), np.arange(3))
        assert d["dp_batch_is_tensor"]
        np.testing.assert_array_equal(d["dp_out"].numpy(), [1.0, 1.0])


def test_tape_mnist_np2_under_the_launcher(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    for k in LAUNCHER_ENV:
        env.pop(k, None)
    logs = tmp_path / "logs"
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--output-filename", str(logs), sys.executable, "-m",
         "horovod_tpu_torch.tape_mnist", "--device", "cpu", "--epochs", "2",
         "--num-samples", "1024"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    sums = []
    for rank in range(2):
        lines = (logs / f"rank.{rank}.log").read_text().splitlines()
        rec = [l.split("SUMMARY ", 1)[1] for l in lines if "SUMMARY " in l]
        sums.append(json.loads(rec[-1]))
    for s in sums:
        assert s["size"] == 2 and s["steps"] == 2 * (1024 // 128)
        assert all(np.isfinite(s["step_losses"]))
        assert all(np.isfinite(s["epoch_losses"]))
    assert sums[0]["digest"] == sums[1]["digest"]
    # MetricAverageCallback: one averaged loss on both ranks.
    assert sums[0]["epoch_losses"] == sums[1]["epoch_losses"]
    # Different seeds, different batches: the ranks' own losses differ.
    assert sums[0]["step_losses"] != sums[1]["step_losses"]
