"""The port's hybrid mesh, the mesh collectives with their gradients, and
the transformer's `make_train_step` over dp, tp and sp, against the JAX
package.

Four CPU ranks over gloo (`run_world`) run, in one world:

- `create_hybrid_mesh` for several shapes: each rank's coordinates and
  axis sets, against the device ids of JAX's mesh of the same shape
  (the same row-major reshape, so bitwise);
- `ppermute` (a partial permutation: a rank that receives nothing gets
  zeros) and the tiled all-to-all, forward and gradient, against
  `lax.ppermute` / `lax.all_to_all` under `shard_map` on four of the
  eight CPU devices and `jax.grad` of the ranks' summed objectives:
  pure data movement, so bitwise;
- `make_train_step` on the `TestTransformer` config of the JAX tests
  (vocab 64, d_model 32, 4 heads x 8, d_ff 64, 4 layers, f32) at B = 4,
  T = 16 for dp=4, dp=2 x tp=2, dp=2 x sp=2 (ring and Ulysses, and the
  ring with GQA and a window), tp=2 x sp=2 and dcn=2 x dp=2 (the dcn
  axis replicating the batch, as JAX's step does): the loss within 1e-4 of
  JAX's `make_train_step` on the same mesh, and every gradient,
  reassembled from the ranks' shards, within 1e-3 of its largest value
  of the port's dense model's gradient (the tolerance of the probe that
  found JAX's sharded gradients equal to `jax.grad` of the dense loss);
- ten AdamW steps at tp=2 x sp=2 (2 layers), whose loss must fall below
  0.8 of the first, as JAX's `test_training_reduces_loss`.

In one process: the mesh's refusals, the specs, and `shard_from_jax`
reassembled by the specs (bitwise the JAX tree, pipeline-stacked too).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel import mesh as JMESH
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.models import convert as TC
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.parallel import mesh as TMESH
from test_torch_port_collectives import no_launcher_env, run_world  # noqa: F401

N = 4
LOSS_ATOL = 1e-4
GRAD_RTOL = 1e-3
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, d_head=8, d_ff=64,
             n_layers=4)
MESHES = [dict(dp=4), dict(dp=2, tp=2), dict(dp=2, sp=2), dict(tp=2, sp=2),
          dict(dp=1, pp=2, ep=2), dict(sp=-1), dict(dp=2, pp=2)]
CONFIGS = [
    ("dp4", dict(dp=4), {}),
    ("dp2_tp2", dict(dp=2, tp=2), {}),
    ("dp2_sp2_ring", dict(dp=2, sp=2), {}),
    ("dp2_sp2_ulysses", dict(dp=2, sp=2), dict(attn_impl="ulysses")),
    ("dp2_sp2_ring_gqa_window", dict(dp=2, sp=2),
     dict(n_kv_heads=2, attn_window=5)),
    ("tp2_sp2", dict(tp=2, sp=2), {}),
    ("dcn2_dp2", dict(dcn=2, dp=2), {}),
]
PERM = [(0, 2), (2, 1), (1, 0)]   # rank 3 sends and receives nothing

WORKER = r'''
import functools, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.parallel import _collectives as pc
from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
data = torch.load(f"{out_dir}/inputs.pt", weights_only=False)
res = {"meshes": []}

for kw in data["meshes"]:
    m = create_hybrid_mesh(**kw)
    res["meshes"].append((dict(m.shape), dict(m.coords),
                          {a: list(ps.ranks) for a, ps in m.sets.items()}))

world = hvd.global_process_set()
x = torch.from_numpy(data["coll_x"][r]).requires_grad_()
c = torch.from_numpy(data["coll_c"][r])
out = pc.ppermute(x, data["perm"], world)
(out * c).sum().backward()
res["ppermute"], res["ppermute_grad"] = out.detach(), x.grad.clone()
x.grad = None
out = pc.all_to_all_tiled(x, 0, 2, world)
(out * torch.from_numpy(data["a2a_c"][r])).sum().backward()
res["a2a"], res["a2a_grad"] = out.detach(), x.grad.clone()

tokens, targets = data["tokens"], data["targets"]
for name, kw, extra in data["configs"]:
    cfg = T.TransformerConfig(**data["cfg"], **extra,
                              compute_dtype=torch.float32)
    mesh = create_hybrid_mesh(**kw)
    step, shard_state, shard_batch = T.make_train_step(
        mesh, cfg, functools.partial(torch.optim.SGD, lr=1.0))
    shards, opt = shard_state(data["params"][name])
    _, _, loss = step(shards, opt, shard_batch((tokens, targets)))
    grads = T.unshard(T.tree_map(lambda p: p.grad, shards), cfg, mesh)
    res[name] = {"loss": float(loss),
                 "grads": T.tree_map(lambda g: g.numpy(), grads),
                 "coords": dict(mesh.coords),
                 "shard_digest": T.tree_digest(shards)}

cfg = T.TransformerConfig(**dict(data["cfg"], n_layers=2),
                          compute_dtype=torch.float32)
mesh = create_hybrid_mesh(tp=2, sp=2)
step, shard_state, shard_batch = T.make_train_step(
    mesh, cfg, functools.partial(torch.optim.AdamW, lr=1e-2,
                                 weight_decay=0.0))
shards, opt = shard_state(data["params2"])
batch = shard_batch((data["tokens8"], data["targets8"]))
losses = []
for _ in range(10):
    _, _, loss = step(shards, opt, batch)
    losses.append(float(loss))
res["losses"] = losses
res["digest"] = T.tree_digest(T.unshard(shards, cfg, mesh))
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jcfg(**kw):
    return JT.TransformerConfig(**SMALL, compute_dtype=jnp.float32, **kw)


def _tcfg(**kw):
    return TT.TransformerConfig(**SMALL, compute_dtype=torch.float32, **kw)


def _data(B, T=16, vocab=64):
    tok = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (B, T + 1),
                                        0, vocab))
    return tok[:, :-1], tok[:, 1:]


def jax_step(mesh_kw, params, cfg, tokens, targets, n=N):
    """JAX make_train_step's loss and gradients (sgd(1.0): the update is
    minus the gradient) on `n` of the CPU devices."""
    mesh = JMESH.create_hybrid_mesh(**mesh_kw, devices=jax.devices()[:n])
    pp = mesh.shape.get("pp", 1)
    stacked = JT.stack_for_pipeline(params, pp, cfg)
    opt = optax.sgd(1.0)
    step, shard_state, shard_batch = JT.make_train_step(mesh, cfg, opt)
    sp, so = shard_state(stacked, opt.init(stacked))
    new, _, loss = step(sp, so, shard_batch((jnp.asarray(tokens),
                                             jnp.asarray(targets))))
    grads = jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), stacked, new)
    return float(loss), grads


def dense_grads(params, cfg, tokens, targets):
    """The port's dense model: its loss and gradient tree (JAX layout;
    zeros where a leaf has no gradient, e.g. an MoE layer's MLP)."""
    model = TC.transformer_from_jax(params, cfg)
    loss = model.loss(torch.from_numpy(tokens), torch.from_numpy(targets))
    loss.backward()
    loss = loss.detach()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    blocks = [b.tree() for b in model.blocks]

    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        return np.stack([t.grad.numpy() for t in ts])

    grads = {"embed": model.embed.grad.numpy(),
             "final_norm": {"scale": model.final_norm.grad.numpy()},
             "blocks": stack(blocks)}
    moes = [b.moe.tree() for b in model.blocks if b.moe is not None]
    if moes:
        grads["moe"] = stack(moes)
    return float(loss), grads


def assert_grads_close(got, want, rtol=GRAD_RTOL, what=""):
    assert sorted(p for p, _ in TT.tree_leaves(got)) == sorted(
        p for p, _ in TT.tree_leaves(want)), what
    for path, w in TT.tree_leaves(want):
        g, w = np.asarray(_get(got, path)), np.asarray(w)
        assert g.shape == w.shape, (what, path, g.shape, w.shape)
        err = np.abs(g - w).max()
        scale = np.abs(w).max()
        assert err <= rtol * scale, (what, path, err, scale)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    tokens, targets = _data(4)
    tok8, tgt8 = _data(8)
    rng = np.random.RandomState(3)
    params = {}
    for name, _, extra in CONFIGS:
        params[name] = _np_tree(JT.transformer_init(
            jax.random.PRNGKey(0), _jcfg(**extra)))
    torch.save({
        "meshes": MESHES, "perm": PERM, "configs": CONFIGS, "cfg": SMALL,
        "coll_x": rng.randn(N, 4, 6, 8).astype(np.float32),
        "coll_c": rng.randn(N, 4, 6, 8).astype(np.float32),
        "a2a_c": rng.randn(N, 1, 6, 32).astype(np.float32),
        "params": params, "tokens": tokens, "targets": targets,
        "params2": _np_tree(JT.transformer_init(
            jax.random.PRNGKey(0), JT.TransformerConfig(
                **dict(SMALL, n_layers=2), compute_dtype=jnp.float32))),
        "tokens8": tok8, "targets8": tgt8,
    }, tmp / "inputs.pt")
    res = run_world(tmp, N, WORKER, timeout=300)
    return torch.load(tmp / "inputs.pt", weights_only=False), res


@pytest.mark.parametrize("i", range(len(MESHES)))
def test_mesh_coordinates_and_sets_match_the_jax_mesh(world, i):
    """Rank r's coordinates are those of device r in JAX's mesh of the
    same shape, and each axis set holds the ranks along that axis."""
    _, res = world
    kw = MESHES[i]
    jm = JMESH.create_hybrid_mesh(**kw, devices=jax.devices()[:N])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r, d in enumerate(res):
        shape, coords, sets = d["meshes"][i]
        assert shape == {a: jm.shape[a] for a in JMESH.AXIS_ORDER}
        where = tuple(int(c[0]) for c in np.nonzero(ids == r))
        assert coords == dict(zip(JMESH.AXIS_ORDER, where))
        for ax, a in enumerate(JMESH.AXIS_ORDER):
            idx = list(where)
            idx[ax] = slice(None)
            assert sets[a] == sorted(ids[tuple(idx)].tolist()), (kw, r, a)


def test_ppermute_and_all_to_all_match_jax_with_their_gradients(world):
    data, res = world
    jm = JMesh(np.asarray(jax.devices()[:N]), ("i",))

    def per_rank(f, xs):
        return shard_map(lambda x: f(x[0])[None], mesh=jm,
                         in_specs=P("i"), out_specs=P("i"),
                         check_vma=False)(xs)

    xs = jnp.asarray(data["coll_x"])
    perm_f = functools.partial(lax.ppermute, axis_name="i", perm=PERM)
    a2a_f = functools.partial(lax.all_to_all, axis_name="i", split_axis=0,
                              concat_axis=2, tiled=True)
    for key, f, c in (("ppermute", perm_f, data["coll_c"]),
                      ("a2a", a2a_f, data["a2a_c"])):
        want = np.asarray(per_rank(f, xs))
        grad = np.asarray(jax.grad(lambda x: jnp.sum(
            per_rank(f, x) * jnp.asarray(c)))(xs))
        for r, d in enumerate(res):
            np.testing.assert_array_equal(d[key].numpy(), want[r])
            np.testing.assert_array_equal(d[key + "_grad"].numpy(),
                                          grad[r])
    # A rank outside the permutation receives zeros, and its input gets
    # no gradient.
    assert not res[3]["ppermute"].any() and not res[3]["ppermute_grad"].any()


@pytest.mark.parametrize("name,mesh_kw,extra", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_train_step_loss_matches_jax_and_grads_match_the_dense_model(
        world, name, mesh_kw, extra):
    data, res = world
    params = data["params"][name]
    tokens, targets = data["tokens"], data["targets"]
    want_loss, _ = jax_step(mesh_kw, params, _jcfg(**extra), tokens, targets)
    dense_loss, dense = dense_grads(params, _tcfg(**extra), tokens, targets)
    assert abs(dense_loss - want_loss) < LOSS_ATOL
    for d in res:
        assert abs(d[name]["loss"] - want_loss) < LOSS_ATOL, (
            d[name]["loss"], want_loss)
        assert_grads_close(d[name]["grads"], dense, what=name)


def test_dcn_axis_replicates_the_batch_as_jax(world):
    """dcn=2 x dp=2: JAX's make_train_step shards the batch over (dp, ep)
    alone, so the dcn axis replicates it and sums no gradient over it.
    The port's loss is JAX's, its sgd(1.0) update (minus the gradient)
    JAX's within 1e-3 of each leaf's largest element, and every rank
    holds the same shards after the step, the dcn replicas above all."""
    data, res = world
    name, mesh_kw, extra = CONFIGS[-1]
    assert name == "dcn2_dp2"
    want_loss, want = jax_step(mesh_kw, data["params"][name],
                               _jcfg(**extra), data["tokens"],
                               data["targets"])
    for d in res:
        assert abs(d[name]["loss"] - want_loss) < LOSS_ATOL
        assert_grads_close(d[name]["grads"], want, what=name)
    by_coords = {(d[name]["coords"]["dcn"], d[name]["coords"]["dp"]): d
                 for d in res}
    assert len(by_coords) == N
    for dp in range(2):
        assert (by_coords[0, dp][name]["shard_digest"]
                == by_coords[1, dp][name]["shard_digest"])
    assert len({d[name]["shard_digest"] for d in res}) == 1


def test_training_reduces_loss_and_ranks_agree(world):
    _, res = world
    losses = res[0]["losses"]
    assert all(d["losses"] == losses for d in res)
    assert losses[-1] < losses[0] * 0.8, losses
    assert len({d["digest"] for d in res}) == 1


def test_mesh_refusals():
    hvd.init(device="cpu")
    try:
        with pytest.raises(HorovodTpuError, match="at most one"):
            TMESH.create_hybrid_mesh(dp=-1, tp=-1)
        with pytest.raises(HorovodTpuError, match="needs 6"):
            TMESH.create_hybrid_mesh(dp=3, tp=2)
        with pytest.raises(HorovodTpuError, match="not divisible"):
            TMESH.create_hybrid_mesh(dp=-1, tp=2, ranks=range(3))
        m = TMESH.create_hybrid_mesh()
        assert m.shape == dict.fromkeys(TMESH.AXIS_ORDER, 1)
        assert TMESH.mesh_axis_size(m, "tp") == 1
        assert TMESH.batch_spec(m) == (None,)
        assert TMESH.MeshConfig(dp=2, tp=3).total() == 6
        assert TMESH.MeshConfig(dp=2, tp=3).sizes() == \
            JMESH.MeshConfig(dp=2, tp=3).sizes()
        # A dcn axis builds the step (it replicates the batch: the
        # four-rank case is test_dcn_axis_replicates_the_batch_as_jax).
        _, _, shard_batch = TT.make_train_step(TMESH.Mesh(
            shape=dict(m.shape, dcn=2), coords=m.coords, sets=m.sets,
            ranks=m.ranks), _tcfg(), torch.optim.SGD)
        tok = torch.arange(12).reshape(2, 6)
        assert all(torch.equal(b, tok) for b in shard_batch((tok, tok)))
    finally:
        hvd.shutdown()


def test_batch_spec_matches_jax():
    class FakeMesh:
        def __init__(self, **kw):
            self.shape = dict(dict.fromkeys(TMESH.AXIS_ORDER, 1), **kw)
    for kw in (dict(dp=2), dict(dp=2, ep=2), dict(dcn=2, dp=2), dict(tp=4)):
        jm = JMESH.create_hybrid_mesh(
            **kw, devices=jax.devices()[:int(np.prod(list(kw.values())))])
        assert P(*TMESH.batch_spec(FakeMesh(**kw))) == JMESH.batch_spec(jm)


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("mesh_kw", [dict(dp=2, tp=2), dict(pp=2, sp=2),
                                     dict(ep=2, tp=2), dict(dp=2, pp=2)])
def test_shard_from_jax_reassembles_the_jax_tree(mesh_kw, moe):
    """Every rank's `shard_from_jax` blocks, put back where the specs say,
    give the (pipeline-stacked) JAX tree bitwise; the specs are JAX's."""
    extra = dict(moe_every=2, n_experts=4) if moe else {}
    params = _np_tree(JT.transformer_init(jax.random.PRNGKey(0),
                                          _jcfg(**extra)))
    cfg = _tcfg(**extra)
    pp = mesh_kw.get("pp", 1)
    want = _np_tree(JT.stack_for_pipeline(params, pp, _jcfg(**extra)))
    specs = TT.transformer_pspecs(cfg, pp)
    jspecs = JT.transformer_pspecs(_jcfg(**extra), pp)
    for path, s in TT.tree_leaves(specs):
        js = tuple(_get(jspecs, path))
        assert s == js + (None,) * (len(s) - len(js)), path
    shape = {a: mesh_kw.get(a, 1) for a in TMESH.AXIS_ORDER}
    n = int(np.prod(list(shape.values())))
    strides = [int(np.prod([shape[b] for b in TMESH.AXIS_ORDER[i + 1:]]))
               for i in range(len(TMESH.AXIS_ORDER))]
    got = jax.tree_util.tree_map(np.zeros_like, want)
    for r in range(n):
        coords = {a: (r // strides[i]) % shape[a]
                  for i, a in enumerate(TMESH.AXIS_ORDER)}
        mesh = TMESH.Mesh(shape=shape, coords=coords, sets={}, ranks=())
        shards = TC.shard_from_jax(params, cfg, mesh)
        for path, block in TT.tree_leaves(shards):
            full = _get(got, path)
            idx = []
            for dim, axis in enumerate(_get(specs, path)):
                k = shape[axis] if axis else 1
                c = full.shape[dim] // k
                i = coords[axis] if axis else 0
                idx.append(slice(i * c, (i + 1) * c))
            full[tuple(idx)] = block
    for path, w in TT.tree_leaves(want):
        np.testing.assert_array_equal(_get(got, path), w,
                                      err_msg=str(path))
