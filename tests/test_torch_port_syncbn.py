"""Port parity: synchronized batch norm.  `models/layers.BatchNorm(
process_set=...)` and `ResNet(sync_bn=...)` against the JAX package's
`batchnorm_apply(axis_name=...)` / `resnet_apply(axis_name=...)` under
`shard_map` over two of the eight CPU devices, and `hvd.SyncBatchNorm`
against the JAX shim's `SyncBatchNorm` and against one `BatchNorm2d`
over the whole batch.  The port's ranks run in an np=2 gloo world.

Tolerances: one layer's outputs, statistics and gradients within 1e-5
of each one's largest value (f32 sums in other orders); the ResNet-18
step's logits within 2e-3 and its gradients within 5e-3 of their
largest value (convolutions summed in other orders by XLA and oneDNN,
through 20 batch norms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu.torch as jshim
from horovod_tpu.models import layers as JL
from horovod_tpu.models import resnet as JR
from horovod_tpu_torch.models.convert import resnet_from_jax

from test_torch_port_collectives import run_world

C, N, HW = 6, 3, 5          # channels, batch per rank, spatial size
RES_BATCH, RES_CLASSES = 4, 10


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(r):
    rng = np.random.RandomState(40 + r)
    return {"x": (rng.randn(N, C, HW, HW) * 2 + 0.5).astype(np.float32),
            "w": rng.randn(N, C, HW, HW).astype(np.float32),
            "res_x": rng.rand(RES_BATCH, 3, 32, 32).astype(np.float32),
            "res_y": rng.randint(0, RES_CLASSES, RES_BATCH)}


def _bn_params():
    rng = np.random.RandomState(5)
    return {"scale": (rng.rand(C) + 0.5).astype(np.float32),
            "bias": rng.randn(C).astype(np.float32),
            "mean": rng.randn(C).astype(np.float32),
            "var": (rng.rand(C) + 0.5).astype(np.float32)}


WORKER = r'''
import sys
import numpy as np
import torch
import torch.nn.functional as F
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import ResNet, layers as L

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
d = {k: torch.from_numpy(v) for k, v in np.load(f"{out_dir}/inputs{r}.npz").items()}
bnp = {k: torch.from_numpy(v) for k, v in np.load(f"{out_dir}/bn.npz").items()}
same = {k: torch.from_numpy(v) for k, v in np.load(f"{out_dir}/inputs0.npz").items()}
res = {}

def run_layer(layer, x, w, calls=1):
    x = x.clone().requires_grad_()
    for _ in range(calls):
        y = layer(x)
    (y * w).sum().backward()
    return {"y": y.detach(), "gx": x.grad, "gw": layer.weight.grad,
            "gb": layer.bias.grad, "mean": layer.running_mean.clone(),
            "var": layer.running_var.clone()}

# layers.BatchNorm over the global set: this rank's own batch.
bn = L.BatchNorm(bnp["scale"].numel(), process_set=True)
with torch.no_grad():
    bn.weight.copy_(bnp["scale"]); bn.bias.copy_(bnp["bias"])
    bn.running_mean.copy_(bnp["mean"]); bn.running_var.copy_(bnp["var"])
res["layer"] = run_layer(bn, d["x"], d["w"])
res["layer_eval"] = bn.eval()(d["x"]).detach()

# hvd.SyncBatchNorm: rank 0's batch on every rank, then each its own.
for key, x, w, kw, calls in (("shim", same["x"], same["w"], {}, 1),
                             ("shim_cma", same["x"], same["w"],
                              {"momentum": None}, 2),
                             ("full", d["x"], d["w"], {}, 1)):
    torch.manual_seed(0)
    sbn = hvd.SyncBatchNorm(bnp["scale"].numel(), **kw)
    with torch.no_grad():
        sbn.weight.copy_(bnp["scale"]); sbn.bias.copy_(bnp["bias"])
    res[key] = run_layer(sbn, x, w, calls)
    res[key]["tracked"] = int(sbn.num_batches_tracked)

# ResNet-18 with sync_bn, one forward and backward from the JAX weights.
model = ResNet(18, 10, compute_dtype=None, sync_bn=True)
model.load_state_dict(torch.load(f"{out_dir}/resnet.pt"))
model.train()
logits = model(d["res_x"])
loss = F.cross_entropy(logits, d["res_y"].long())
loss.backward()
res["res_logits"] = logits.detach()
res["res_grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
res["res_stats"] = {k: v.clone() for k, v in model.state_dict().items()
                    if "running" in k}
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def resnet_vars():
    v = JR.resnet_init(jax.random.PRNGKey(3), 18, num_classes=RES_CLASSES)
    host = jax.tree_util.tree_map(np.asarray, {
        "params": v["params"], "batch_stats": v["batch_stats"]})
    host["config"] = v["config"]
    return v, host


@pytest.fixture(scope="module")
def world(tmp_path_factory, resnet_vars):
    tmp = tmp_path_factory.mktemp("syncbn_np2")
    for r in range(2):
        np.savez(tmp / f"inputs{r}.npz", **_inputs(r))
    np.savez(tmp / "bn.npz", **_bn_params())
    model = resnet_from_jax(resnet_vars[1], compute_dtype=None, sync_bn=True)
    torch.save(model.state_dict(), tmp / "resnet.pt")
    return run_world(tmp, 2, WORKER, timeout=300)


def _mesh():
    return Mesh(np.array(jax.devices()[:2]), ("b",))


def _nhwc(a):
    return np.transpose(np.asarray(a), (0, 2, 3, 1))


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


@pytest.fixture(scope="module")
def jax_layer():
    """batchnorm_apply(axis_name="b") under shard_map over two devices,
    the loss sum(y * w) on each: y, the new statistics, and each rank's
    gradients with respect to x, scale and bias."""
    from jax import shard_map

    p = _bn_params()
    params = {"scale": jnp.asarray(p["scale"]), "bias": jnp.asarray(p["bias"])}
    stats = {"mean": jnp.asarray(p["mean"]), "var": jnp.asarray(p["var"])}
    xs = jnp.asarray(np.concatenate([_nhwc(_inputs(r)["x"]) for r in (0, 1)]))
    ws = jnp.asarray(np.concatenate([_nhwc(_inputs(r)["w"]) for r in (0, 1)]))

    def local(params, stats, x, w):
        def loss(prm, x):
            y, ns = JL.batchnorm_apply(prm, stats, x, train=True,
                                       axis_name="b")
            return jnp.sum(y * w), (y, ns)

        (_, (y, ns)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, x)
        return y, ns, jax.tree_util.tree_map(lambda g: g[None], gp), gx

    sm = shard_map(local, mesh=_mesh(), in_specs=(P(), P(), P("b"), P("b")),
                   out_specs=(P("b"), P(), P("b"), P("b")), check_vma=False)
    y, ns, gp, gx = jax.jit(sm)(params, stats, xs, ws)
    return {"y": np.asarray(y), "stats": ns, "gp": gp, "gx": np.asarray(gx)}


@pytest.mark.parametrize("what", ["y", "gx", "gw", "gb", "mean", "var"])
def test_layer_batchnorm_matches_jax_batchnorm_apply(world, jax_layer, what):
    for r, d in enumerate(world):
        got = d["layer"][what].numpy()
        sl = slice(r * N, (r + 1) * N)
        want = {"y": lambda: _nchw(jax_layer["y"][sl]),
                "gx": lambda: _nchw(jax_layer["gx"][sl]),
                "gw": lambda: jax_layer["gp"]["scale"][r],
                "gb": lambda: jax_layer["gp"]["bias"][r],
                "mean": lambda: jax_layer["stats"]["mean"],
                "var": lambda: jax_layer["stats"]["var"]}[what]()
        assert _rel(got, want) <= 1e-5, (what, r, _rel(got, want))


def test_layer_batchnorm_eval_is_local(world):
    """Eval mode reads the running statistics; no collective."""
    for r, d in enumerate(world):
        x = torch.from_numpy(_inputs(r)["x"])
        bn = __import__("horovod_tpu_torch.models.layers",
                        fromlist=["BatchNorm"]).BatchNorm(C)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(_bn_params()["scale"]))
            bn.bias.copy_(torch.from_numpy(_bn_params()["bias"]))
            bn.running_mean.copy_(d["layer"]["mean"])
            bn.running_var.copy_(d["layer"]["var"])
        assert torch.equal(bn.eval()(x), d["layer_eval"])


@pytest.mark.parametrize("key,calls,kw", [("shim", 1, {}),
                                          ("shim_cma", 2, {"momentum": None})])
def test_sync_batchnorm_matches_the_jax_shim_on_identical_inputs(
        world, monkeypatch, key, calls, kw):
    """Every rank holds rank 0's batch: the JAX shim (its size() patched
    to the port's 2, so that the unbiased running variance divides
    alike) and the port agree on the output, the running statistics and
    every gradient, within 1e-5 of the largest value."""
    monkeypatch.setattr(jshim, "size", lambda: 2)
    ins, p = _inputs(0), _bn_params()
    torch.manual_seed(0)
    sbn = jshim.SyncBatchNorm(C, **kw)
    with torch.no_grad():
        sbn.weight.copy_(torch.from_numpy(p["scale"]))
        sbn.bias.copy_(torch.from_numpy(p["bias"]))
    x = torch.from_numpy(ins["x"]).requires_grad_()
    for _ in range(calls):
        y = sbn(x)
    (y * torch.from_numpy(ins["w"])).sum().backward()
    want = {"y": y.detach(), "gx": x.grad, "gw": sbn.weight.grad,
            "gb": sbn.bias.grad, "mean": sbn.running_mean,
            "var": sbn.running_var}
    for d in world:
        assert d[key]["tracked"] == int(sbn.num_batches_tracked) == calls
        for k, w in want.items():
            assert _rel(d[key][k].numpy(), w.numpy()) <= 1e-5, (key, k)


def test_sync_batchnorm_is_batchnorm2d_over_the_whole_batch(world):
    """Each rank its own batch: the output, the running statistics, the
    input gradient and the sum of the ranks' weight and bias gradients
    are those of one BatchNorm2d over both batches, within 1e-5 of the
    largest value (the exact cross-rank gradient)."""
    p = _bn_params()
    ref = torch.nn.BatchNorm2d(C)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(p["scale"]))
        ref.bias.copy_(torch.from_numpy(p["bias"]))
    x = torch.from_numpy(np.concatenate([_inputs(r)["x"] for r in (0, 1)]))
    w = torch.from_numpy(np.concatenate([_inputs(r)["w"] for r in (0, 1)]))
    x.requires_grad_()
    y = ref(x)
    (y * w).sum().backward()
    for r, d in enumerate(world):
        sl = slice(r * N, (r + 1) * N)
        got = d["full"]
        assert _rel(got["y"].numpy(), y[sl].detach().numpy()) <= 1e-5
        assert _rel(got["gx"].numpy(), x.grad[sl].numpy()) <= 1e-5
        assert _rel(got["mean"].numpy(), ref.running_mean.numpy()) <= 1e-5
        assert _rel(got["var"].numpy(), ref.running_var.numpy()) <= 1e-5
    for k, want in (("gw", ref.weight.grad), ("gb", ref.bias.grad)):
        total = world[0]["full"][k] + world[1]["full"][k]
        assert _rel(total.numpy(), want.numpy()) <= 1e-5, k


def test_sync_batchnorm_one_rank_and_eval_are_the_plain_batchnorm():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        x = torch.randn(4, 3, 2, 2, generator=torch.Generator().manual_seed(1))
        torch.manual_seed(0)
        sbn, ref = hvd.SyncBatchNorm(3), torch.nn.BatchNorm2d(3)
        assert torch.equal(sbn(x), ref(x))
        assert torch.equal(sbn.running_var, ref.running_var)
        assert torch.equal(sbn.eval()(x), ref.eval()(x))
        with pytest.raises(ValueError, match="at least 2D"):
            hvd.SyncBatchNorm(3).train()._check_input_dim(torch.ones(3))
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def jax_resnet(resnet_vars):
    """resnet_apply(axis_name="b") under shard_map: each rank's logits
    and its gradients of its own mean cross-entropy."""
    from jax import shard_map

    v = resnet_vars[0]
    xs = jnp.asarray(np.concatenate([_nhwc(_inputs(r)["res_x"])
                                     for r in (0, 1)]))
    ys = jnp.asarray(np.concatenate([_inputs(r)["res_y"] for r in (0, 1)]))

    def local(params, stats, x, y):
        def loss(prm):
            logits, ns = JR.resnet_apply(
                {"params": prm, "batch_stats": stats, "config": v["config"]},
                x, train=True, compute_dtype=jnp.float32, axis_name="b")
            onehot = jax.nn.one_hot(y, RES_CLASSES)
            return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot,
                                     -1)), (logits, ns)

        (_, (logits, ns)), g = jax.value_and_grad(loss, has_aux=True)(params)
        return logits, ns, jax.tree_util.tree_map(lambda a: a[None], g)

    sm = shard_map(local, mesh=_mesh(), in_specs=(P(), P(), P("b"), P("b")),
                   out_specs=(P("b"), P(), P("b")), check_vma=False)
    logits, ns, g = jax.jit(sm)(v["params"], v["batch_stats"], xs, ys)
    return np.asarray(logits), ns, g


def _jax_grad(g, name, r):
    leaf = g
    parts = name.split(".")
    for k in parts[:-1]:
        leaf = leaf[k]
    kind = parts[-1]
    if "bn" in parts[-2]:
        a = np.asarray(leaf[{"weight": "scale", "bias": "bias"}[kind]][r])
    elif parts[-2] == "head":
        a = np.asarray(leaf["kernel" if kind == "weight" else "bias"][r])
        a = a.T if kind == "weight" else a
    else:
        a = np.transpose(np.asarray(leaf["kernel"][r]), (3, 2, 0, 1))
    return a


@pytest.mark.parametrize("name", ["stem.weight", "bn_stem.weight",
                                  "stage1_block0.proj.weight",
                                  "stage2_block1.bn2.bias",
                                  "stage3_block1.conv2.weight",
                                  "head.weight", "head.bias"])
def test_resnet18_sync_bn_step_matches_jax(world, jax_resnet, name):
    logits, ns, g = jax_resnet
    for r, d in enumerate(world):
        sl = slice(r * RES_BATCH, (r + 1) * RES_BATCH)
        assert _rel(d["res_logits"].numpy(), logits[sl]) <= 2e-3
        got = d["res_grads"][name].numpy()
        want = _jax_grad(g, name, r)
        assert got.shape == want.shape
        assert _rel(got, want) <= 5e-3, (name, r, _rel(got, want))


@pytest.mark.parametrize("layer", ["bn_stem", "stage0_block0.bn1",
                                   "stage3_block1.bn2"])
def test_resnet18_sync_bn_statistics_match_jax(world, jax_resnet, layer):
    """The running statistics are the global batch's: the same on both
    ranks and those of resnet_apply(axis_name=...)."""
    _, ns, _ = jax_resnet
    s = ns
    for k in layer.split("."):
        s = s[k]
    for stat, key in (("mean", "running_mean"), ("var", "running_var")):
        want = np.asarray(s[stat])
        for d in world:
            got = d["res_stats"][f"{layer}.{key}"].numpy()
            assert _rel(got, want) <= 1e-3
        assert torch.equal(world[0]["res_stats"][f"{layer}.{key}"],
                           world[1]["res_stats"][f"{layer}.{key}"])
