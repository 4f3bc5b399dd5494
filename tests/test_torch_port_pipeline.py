"""GPipe over a `pp` set and the transformer's pipeline step, against the
JAX package.

Four CPU ranks over gloo:

- `gpipe` (tanh layers, L = 4, D = 8) at pp = 2 (two sets, 2 and 4
  microbatches) and pp = 4 (4 microbatches): the output on every rank
  within 1e-5 of JAX's `gpipe` on the CPU devices (JAX's own test), and
  the gradient of sum(out²) counted once (each stage's objective is
  sum(out²) / pp) within 1e-4 of `jax.grad` of the sequential stack
  (`tests/test_parallel.py:161-190`), for every stage's layers and for
  the input (summed over the stages, which all read it);
- `make_train_step` at dp=2 x pp=2, pp=4, pp=2 x sp=2 and pp=2 x tp=2
  (the `TestTransformer` config, B = 4, T = 16): the loss within 1e-4 of
  JAX's `make_train_step` on the same mesh, and every gradient,
  reassembled from the ranks' shards and unstacked, within 1e-3 of its
  largest value of the port's dense model's.  GPipe's bubble ticks
  compute on zeros and every tick but the last hops, on every rank.

In one process: the shape check and the microbatch refusal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel import create_hybrid_mesh as j_mesh
from horovod_tpu.parallel import gpipe as j_gpipe
from horovod_tpu_torch.common.basics import ProcessSet
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.parallel import pipeline as TP
from test_torch_port_collectives import no_launcher_env, run_world  # noqa: F401
from test_torch_port_mesh import (SMALL, _jcfg, _np_tree, _tcfg, _data,
                                  assert_grads_close, dense_grads, jax_step)

N = 4
L, D = 4, 8
# name: (pp, microbatches)
PIPES = {"pp2_m2": (2, 2), "pp2_m4": (2, 4), "pp4_m4": (4, 4)}
STEPS = [("dp2_pp2", dict(dp=2, pp=2)), ("pp4", dict(pp=4)),
         ("pp2_sp2", dict(pp=2, sp=2)), ("pp2_tp2", dict(pp=2, tp=2))]

WORKER = r'''
import functools, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.parallel import pipeline as PL
from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
data = torch.load(f"{out_dir}/inputs.pt", weights_only=False)
res = {}


def stage_fn(ws, x):
    for j in range(ws.shape[0]):
        x = torch.tanh(x @ ws[j])
    return x


for name, (pp, m) in data["pipes"].items():
    mesh = create_hybrid_mesh(dp=n // pp, pp=pp)
    i = mesh.index("pp")
    ws = torch.from_numpy(data["ws"]).reshape(pp, -1, *data["ws"].shape[1:])
    w = ws[i].clone().requires_grad_()
    x = torch.from_numpy(data["x"]).requires_grad_()
    out = PL.gpipe(mesh, stage_fn, w, x, m)
    ((out ** 2).sum() / pp).backward()
    res[name] = (out.detach(), w.grad, x.grad)

for name, kw in data["steps"]:
    cfg = T.TransformerConfig(**data["cfg"], compute_dtype=torch.float32)
    mesh = create_hybrid_mesh(**kw)
    step, shard_state, shard_batch = T.make_train_step(
        mesh, cfg, functools.partial(torch.optim.SGD, lr=1.0))
    shards, opt = shard_state(data["params"])
    _, _, loss = step(shards, opt, shard_batch((data["tokens"],
                                                data["targets"])))
    grads = T.unshard(T.tree_map(lambda g: g.grad, shards), cfg, mesh)
    res[name] = {"loss": float(loss),
                 "grads": T.tree_map(lambda g: g.numpy(), grads)}
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


def _layers():
    ws = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (L, D, D))
                    * 0.3, np.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, D)),
                   np.float32)
    return ws, x


def _j_stage(stage_w, x):
    for j in range(stage_w.shape[0]):
        x = jnp.tanh(x @ stage_w[j])
    return x


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    ws, x = _layers()
    params = _np_tree(JT.transformer_init(jax.random.PRNGKey(0), _jcfg()))
    tokens, targets = _data(4)
    torch.save({"pipes": PIPES, "ws": ws, "x": x, "steps": STEPS,
                "cfg": SMALL, "params": params, "tokens": tokens,
                "targets": targets}, tmp / "inputs.pt")
    return params, run_world(tmp, N, WORKER, timeout=300)


@pytest.mark.parametrize("name", list(PIPES))
def test_gpipe_matches_jax_and_its_gradient_the_sequential_stack(world,
                                                                 name):
    _, res = world
    pp, m = PIPES[name]
    ws, x = _layers()
    mesh = j_mesh(dp=N // pp, pp=pp, devices=jax.devices()[:N])
    stacked = jnp.asarray(ws.reshape(pp, L // pp, D, D))
    want = np.asarray(jax.jit(lambda w, x: j_gpipe(mesh, _j_stage, w, x, m))(
        stacked, jnp.asarray(x)))

    def loss_seq(ws, x):
        for i in range(L):
            x = jnp.tanh(x @ ws[i])
        return jnp.sum(x ** 2)

    gw, gx = jax.grad(loss_seq, argnums=(0, 1))(jnp.asarray(ws),
                                                jnp.asarray(x))
    gw = np.asarray(gw).reshape(pp, L // pp, D, D)
    stage_of = [r % pp for r in range(N)]   # rank r = dp * pp + stage
    for r, d in enumerate(res):
        out, w_grad, x_grad = (t.numpy() for t in d[name])
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(w_grad, gw[stage_of[r]], rtol=1e-4,
                                   atol=1e-4)
    for group in range(N // pp):
        x_sum = sum(res[group * pp + s][name][2].numpy() for s in range(pp))
        np.testing.assert_allclose(x_sum, np.asarray(gx), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name,mesh_kw", STEPS, ids=[s[0] for s in STEPS])
def test_pipeline_train_step_matches_jax_and_the_dense_model(world, name,
                                                             mesh_kw):
    params, res = world
    tokens, targets = _data(4)
    want_loss, _ = jax_step(mesh_kw, params, _jcfg(), tokens, targets)
    _, dense = dense_grads(params, _tcfg(), tokens, targets)
    pp = mesh_kw["pp"]
    for d in res:
        assert abs(d[name]["loss"] - want_loss) < 1e-4, (
            d[name]["loss"], want_loss)
        grads = TT.unstack_pipeline(d[name]["grads"])
        assert grads["blocks"]["wq"].shape[0] == SMALL["n_layers"] and pp > 1
        assert_grads_close(grads, dense, what=name)


def test_gpipe_refusals():
    class OneStage:
        sets = {"pp": None}
    with pytest.raises(HorovodTpuError, match="not divisible"):
        TP.gpipe(OneStage(), lambda w, x: x, None, torch.zeros(5, 2), 2)
    ps = ProcessSet(ranks=[0])
    hvd.init(device="cpu")
    try:
        with pytest.raises(ValueError, match="preserve activation shape"):
            TP.gpipe_shard(lambda w, x: x[..., :1], None,
                           torch.zeros(2, 3, 4), ps)
        # One stage: the schedule is the stage applied to each microbatch.
        x = torch.randn(3, 2, 4)
        out = TP.gpipe_shard(lambda w, h: torch.tanh(h) * w, 2.0, x, ps)
        torch.testing.assert_close(out, torch.tanh(x) * 2.0, rtol=0, atol=0)
    finally:
        hvd.shutdown()
