"""The Switch MoE layer and the MoE transformer, against the JAX package.

In one process, f32:

- `top1_route` and `_gating` on the same logits: the routing (expert
  ids, dispatch, capacity drops included) bitwise JAX's; the softmax
  probabilities, the gate and combine weights within 1e-6 of theirs
  (XLA's softmax and torch's round the last bit apart: measured 1.2e-7
  relative);
- `moe_apply_dense`: the routing (expert ids from each side's own
  logits) equal to JAX's, the output and aux loss within 1e-5;
- the dense MoE transformer (`moe_every=2`): loss within 1e-4 of JAX's
  `transformer_ref_loss` and every gradient within 1e-3 of its largest
  value of `jax.grad`.

Four CPU ranks over gloo:

- `moe_apply_shard` at ep = 2 (two sets) and ep = 4, each rank's own
  tokens and experts: outputs within 1e-5 of JAX's `moe_apply_shard`
  under `shard_map` on the CPU devices, and the gradients of the ranks'
  summed objectives (sum(out · c) + aux) within 1e-4 of their largest
  value of JAX's, the replicated gate's summed over the ranks as
  shard_map's transpose sums it;
- `make_train_step` at dp=2 x ep=2 and at ep=4 (moe_every=2, 4 experts,
  B = 4, T = 16): the loss within 1e-4 and every reassembled gradient
  within 1e-3 of JAX's ep step (sgd(1.0): minus its update).  Not of
  the dense model: capacity is counted per shard from local tokens, so
  tokens drop differently than over the whole batch (ROADMAP,
  "Reference behaviours").
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel import moe as JM
from horovod_tpu_torch.parallel import moe as TM
from test_torch_port_collectives import run_world
from test_torch_port_mesh import (SMALL, _jcfg, _np_tree, _tcfg, _data,
                                  assert_grads_close, dense_grads, jax_step)

N = 4
D, F, E = 16, 32, 8
CF = 1.25
MOE = dict(moe_every=2, n_experts=4)
STEPS = [("dp2_ep2", dict(dp=2, ep=2)), ("ep4", dict(ep=4))]

WORKER = r'''
import functools, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.parallel import moe as M
from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
data = torch.load(f"{out_dir}/inputs.pt", weights_only=False)
res = {}
for ep in (2, 4):
    mesh = create_hybrid_mesh(dp=n // ep, ep=ep)
    ps = mesh.sets["ep"]
    i, el = ps.rank(), data["E"] // ep
    p = data["moe"]
    params = {"gate": {"kernel": torch.from_numpy(p["gate"]["kernel"])},
              "wi": torch.from_numpy(p["wi"][i * el:(i + 1) * el]),
              "wo": torch.from_numpy(p["wo"][i * el:(i + 1) * el])}
    leaves = [params["gate"]["kernel"], params["wi"], params["wo"]]
    for t in leaves:
        t.requires_grad_()
    x = torch.from_numpy(data["x"][i:i + 1]).requires_grad_()
    out, aux = M.moe_apply_shard(params, x, ps, capacity_factor=data["cf"])
    ((out * torch.from_numpy(data["c"][i:i + 1])).sum()
     + aux["aux_loss"]).backward()
    res[ep] = (out.detach(), float(aux["aux_loss"]), x.grad,
               *[t.grad for t in leaves])

for name, kw in data["steps"]:
    cfg = T.TransformerConfig(**data["cfg"], **data["moe_cfg"],
                              compute_dtype=torch.float32)
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


def _moe_params():
    return _np_tree(JM.moe_init(jax.random.PRNGKey(3), E, D, F))


def _x(B=4, T=12, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, D).astype(np.float32),
            rng.randn(B, T, D).astype(np.float32))


def _torch_tree(p):
    return {"gate": {"kernel": torch.tensor(p["gate"]["kernel"])},
            "wi": torch.tensor(p["wi"]), "wo": torch.tensor(p["wo"])}


@pytest.mark.parametrize("capacity", [1, 3, 100])
def test_gating_routes_as_jax(capacity):
    logits = np.random.RandomState(capacity).randn(40, E).astype(np.float32)
    jd, jc, ji, jp = JM._gating(jnp.asarray(logits), E, capacity)
    td, tc, ti, tp = TM._gating(torch.from_numpy(logits), E, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for g, w in ((tc, jc), (tp, jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
    _, ji, jg = JM.top1_route(jnp.asarray(logits))
    _, ti, tg = TM.top1_route(torch.from_numpy(logits))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=0)


def test_moe_apply_dense_matches_jax():
    p = _moe_params()
    x, _ = _x()
    want, waux = JM.moe_apply_dense(p, jnp.asarray(x), capacity_factor=CF)
    got, gaux = TM.moe_apply_dense(_torch_tree(p), torch.from_numpy(x),
                                   capacity_factor=CF)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(gaux["aux_loss"]) - float(waux["aux_loss"])) < 1e-5
    flat = x.reshape(-1, D)
    _, jidx, _ = JM.top1_route(jnp.asarray(flat) @ p["gate"]["kernel"])
    _, tidx, _ = TM.top1_route(torch.from_numpy(flat)
                               @ torch.from_numpy(p["gate"]["kernel"]))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_dense_moe_transformer_matches_jax():
    jcfg, tcfg = _jcfg(**MOE), _tcfg(**MOE)
    params = _np_tree(JT.transformer_init(jax.random.PRNGKey(0), jcfg))
    tokens, targets = _data(4)
    want, wgrads = jax.jit(jax.value_and_grad(JT.transformer_ref_loss),
                           static_argnums=3)(
        params, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    loss, grads = dense_grads(params, tcfg, tokens, targets)
    assert abs(loss - float(want)) < 1e-4
    assert_grads_close(grads, _np_tree(wgrads), what="dense moe")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    x, c = _x()
    params = _np_tree(JT.transformer_init(jax.random.PRNGKey(0),
                                          _jcfg(**MOE)))
    tokens, targets = _data(4)
    torch.save({"moe": _moe_params(), "x": x, "c": c, "cf": CF, "E": E,
                "steps": STEPS, "cfg": SMALL, "moe_cfg": MOE,
                "params": params, "tokens": tokens, "targets": targets},
               tmp / "inputs.pt")
    return params, run_world(tmp, N, WORKER, timeout=300)


def _jax_shard(ep, p, x, c):
    """JAX moe_apply_shard on ep devices: outputs, aux, and the gradient
    of the devices' summed sum(out * c) + aux."""
    mesh = JMesh(np.asarray(jax.devices()[:ep]), ("ep",))
    pspec = {"gate": {"kernel": P()}, "wi": P("ep"), "wo": P("ep")}

    def body(p, x):
        out, aux = JM.moe_apply_shard(p, x, "ep", capacity_factor=CF)
        return out, aux["aux_loss"][None]

    f = shard_map(body, mesh=mesh, in_specs=(pspec, P("ep")),
                  out_specs=(P("ep"), P("ep")), check_vma=False)

    @jax.jit
    def run(p, x, c):
        (out, aux), vjp = jax.vjp(f, p, x)
        gp, gx = vjp((c, jnp.ones_like(aux)))
        return out, aux, gx, gp

    return run(p, jnp.asarray(x), jnp.asarray(c))


@pytest.mark.parametrize("ep", [2, 4])
def test_moe_apply_shard_matches_jax_with_gradients(world, ep):
    _, res = world
    p = _moe_params()
    x, c = _x()
    x, c = x[:ep], c[:ep]
    out, aux, gx, gp = _jax_shard(ep, p, x, c)
    ranks = range(ep)       # the first ep set: ranks 0..ep-1
    got = np.concatenate([res[r][ep][0].numpy() for r in ranks])
    np.testing.assert_allclose(got, np.asarray(out), rtol=1e-5, atol=1e-5)
    for r in ranks:
        assert abs(res[r][ep][1] - float(aux[r])) < 1e-5
    el = E // ep
    grads = {
        "x": (np.concatenate([res[r][ep][2].numpy() for r in ranks]), gx),
        "gate": (sum(res[r][ep][3].numpy() for r in ranks),
                 gp["gate"]["kernel"]),
        "wi": (np.concatenate([res[r][ep][4].numpy() for r in ranks]),
               gp["wi"]),
        "wo": (np.concatenate([res[r][ep][5].numpy() for r in ranks]),
               gp["wo"]),
    }
    assert el * ep == E
    for name, (g, w) in grads.items():
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("name,mesh_kw", STEPS, ids=[s[0] for s in STEPS])
def test_ep_train_step_matches_the_jax_ep_step(world, name, mesh_kw):
    params, res = world
    tokens, targets = _data(4)
    want_loss, want_grads = jax_step(mesh_kw, params, _jcfg(**MOE), tokens,
                                     targets)
    for d in res:
        assert abs(d[name]["loss"] - want_loss) < 1e-4, (
            d[name]["loss"], want_loss)
        assert_grads_close(d[name]["grads"], _np_tree(want_grads),
                           what=name)
