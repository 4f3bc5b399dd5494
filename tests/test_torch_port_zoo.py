"""Port parity: the rest of the model zoo of `horovod_tpu_torch.models`
(VGG-16, the MNIST net, `avg_pool`, `Conv2d` with VALID padding and
bias, the converters, `zoo_build`, the parameter counts) against the JAX
package's `models/` on the same weights and inputs (NHWC in JAX, NCHW in
the port); the whole `Compression` namespace; the hook path's buckets on
VGG-16's leaves against JAX's partition; and the synthetic benchmark's
`--model` and `--compression`.  Inception V3's forward is
tests/test_torch_port_inception.py.

Tolerances (f32 on the CPU; XLA and oneDNN sum convolutions in other
orders): single layers 1e-5; the VGG-16 and MNIST logits 1e-4 of their
largest value (no batch norm to magnify rounding) and their gradients
1e-4 of each gradient's largest value; converters, bf16 compression and
bucket memberships exactly.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu import models as JM
from horovod_tpu.models import layers as JL
from horovod_tpu.ops import compression as JC
from horovod_tpu.parallel import data_parallel as JD
import horovod_tpu_torch as hvd
from horovod_tpu_torch import models as TM
from horovod_tpu_torch import synthetic_benchmark
from horovod_tpu_torch.models import layers as TL
from horovod_tpu_torch.ops import compression as TC

from test_torch_port_collectives import no_launcher_env  # noqa: F401 (autouse)

ZOO_PARAMS = {"inception3": 23_834_568, "vgg16": 138_357_544}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _host(variables):
    out = jax.tree_util.tree_map(np.asarray, {
        "params": variables["params"],
        "batch_stats": variables["batch_stats"]})
    out["config"] = variables["config"]
    return out


def _assert_rel(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_avg_pool_matches_reduce_window(size, stride, padding):
    x = np.random.RandomState(size * 10 + stride).randn(
        2, size, size, 5).astype(np.float32)
    want = JL.avg_pool(jnp.asarray(x), 3, stride, padding=padding)
    got = TL.avg_pool(_nchw(x), 3, stride, padding=padding)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_same_avg_pool_leaves_the_padding_out():
    """At a corner the 3×3 SAME window covers 4 elements: their mean,
    not their sum over 9 (torch's default count_include_pad)."""
    x = torch.ones(1, 1, 4, 4)
    assert float(TL.avg_pool(x, 3, 1, padding="SAME")[0, 0, 0, 0]) == 1.0


@pytest.mark.parametrize("kernel,stride,padding", [
    (5, 1, "VALID"), (3, 2, "VALID"), (3, 1, "SAME"), ((1, 7), 1, "SAME"),
    ((7, 1), 1, "SAME"), ((1, 3), 1, "SAME"), (3, 2, "SAME")])
@pytest.mark.parametrize("bias", [False, True])
def test_conv_padding_and_bias_match_jax(kernel, stride, padding, bias):
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    rng = np.random.RandomState(kh * 10 + kw + stride)
    x = rng.randn(2, 9, 9, 3).astype(np.float32)
    p = {"kernel": jnp.asarray(rng.randn(kh, kw, 3, 4).astype(np.float32))}
    if bias:
        p["bias"] = jnp.asarray(rng.randn(4).astype(np.float32))
    want = JL.conv2d_apply(p, jnp.asarray(x), stride, padding=padding)
    conv = TL.Conv2d(3, 4, kernel, stride, padding=padding, bias=bias,
                     generator=torch.Generator())
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.transpose(
            np.asarray(p["kernel"]), (3, 2, 0, 1))))
        if bias:
            conv.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
    got = conv(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_conv_bias_starts_at_zero_and_padding_is_checked():
    g = torch.Generator()
    conv = TL.Conv2d(3, 4, 3, bias=True, generator=g)
    assert torch.equal(conv.bias, torch.zeros(4))
    assert TL.Conv2d(3, 4, 3, generator=g).bias is None
    with pytest.raises(ValueError, match="padding"):
        TL.Conv2d(3, 4, 3, padding="same")


# ---------------------------------------------------------------------------
# The zoo: names, parameter counts
# ---------------------------------------------------------------------------

def test_zoo_names_match_jax():
    assert TM.zoo_models() == JM.zoo_models()
    with pytest.raises(ValueError, match="inception3"):
        TM.zoo_build("alexnet")


@pytest.mark.parametrize("name", sorted(ZOO_PARAMS))
def test_param_count_matches_jax(name):
    kw = {"image_size": 224} if name == "vgg16" else {}
    params = jax.eval_shape(lambda: JM.zoo_init(
        name, jax.random.PRNGKey(0), num_classes=1000, **kw)["params"])
    want = sum(int(np.prod(l.shape))
               for l in jax.tree_util.tree_leaves(params))
    with torch.device("meta"):
        model = TM.zoo_build(name, 1000, image_size=224)
    assert TM.num_params(model) == want == ZOO_PARAMS[name]


def test_vgg_refuses_other_sizes():
    with pytest.raises(ValueError, match="% 32"):
        TM.VGG16(10, image_size=48)
    with pytest.raises(ValueError, match="64x64"):
        TM.VGG16(10, image_size=64, compute_dtype=None)(
            torch.zeros(1, 3, 32, 32))


def test_inception_refuses_small_inputs():
    with pytest.raises(ValueError, match="75x75"):
        TM.Inception3(10, compute_dtype=None)(torch.zeros(1, 3, 74, 74))


# ---------------------------------------------------------------------------
# VGG-16 at 64×64 (a 2×2 map before the flatten) and the MNIST net
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vgg_grads():
    """JAX's and the port's logits and loss gradients of VGG-16 at 64×64,
    10 classes, batch 2, f32."""
    v = JM.zoo_init("vgg16", jax.random.PRNGKey(0), num_classes=10,
                    image_size=64)
    rng = np.random.RandomState(3)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    y = np.array([3, 7])

    def loss_fn(params):
        logits, _ = JM.vgg16_apply({"params": params, "batch_stats": {},
                                    "config": v["config"]}, jnp.asarray(x),
                                   compute_dtype=jnp.float32)
        onehot = jax.nn.one_hot(y, 10)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1)), \
            logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    model = TM.vgg_from_jax(_host(v), compute_dtype=None)
    got = model(_nchw(x))
    F.cross_entropy(got, torch.from_numpy(y)).backward()
    want = TM.vgg_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                             grads),
                            "config": v["config"]}, compute_dtype=None)
    return model, got.detach(), np.asarray(logits), want


def test_vgg_logits_match_jax(vgg_grads):
    _, got, want, _ = vgg_grads
    _assert_rel(got.numpy(), want, 1e-4)


def test_vgg_gradients_match_jax(vgg_grads):
    """Every parameter's gradient; JAX's gradient tree goes through the
    converter, so fc1's rows are permuted as its weights are."""
    model, _, _, want = vgg_grads
    names = dict(want.named_parameters())
    assert len(names) == 32
    for name, p in model.named_parameters():
        _assert_rel(p.grad.numpy(), names[name].detach().numpy(), 1e-4)


def _mnist_case():
    params = JM.mnist_cnn_init(jax.random.PRNGKey(1))
    rng = np.random.RandomState(5)
    x = rng.rand(4, 28, 28, 1).astype(np.float32)
    y = np.array([1, 0, 9, 4])
    return params, x, y


def test_mnist_logits_and_gradients_match_jax():
    params, x, y = _mnist_case()

    def loss_fn(p):
        return JM.nll_loss(JM.mnist_cnn_apply(p, jnp.asarray(x)),
                           jnp.asarray(y))

    want_lp = JM.mnist_cnn_apply(params, jnp.asarray(x))
    grads = jax.grad(loss_fn)(params)
    host = jax.tree_util.tree_map(np.asarray, params)
    model = TM.mnist_from_jax(host)
    lp = model(_nchw(x))
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(want_lp),
                               rtol=1e-5, atol=1e-5)
    TM.nll_loss(lp, torch.from_numpy(y)).backward()
    want = TM.mnist_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    names = dict(want.named_parameters())
    for name, p in model.named_parameters():
        _assert_rel(p.grad.numpy(), names[name].detach().numpy(), 1e-4)


def test_mnist_dropout_drops_whole_channels_of_conv2():
    """With a generator, conv2's output loses whole channels with
    probability 0.5 and keeps the rest scaled by 2; without one, or in
    eval mode, nothing is dropped."""
    model = TM.MnistNet(seed=2)
    x = torch.rand(3, 1, 28, 28, generator=torch.Generator().manual_seed(3))
    seen = []
    model.conv2.register_forward_hook(lambda m, i, o: seen.append(
        o.detach()))
    with torch.no_grad():
        plain = model(x)
        model.eval()
        assert torch.equal(model(x, dropout=torch.Generator()), plain)
        model.train()
        got = model(x, dropout=torch.Generator().manual_seed(0))
        keep = torch.rand((3, 20, 1, 1),
                          generator=torch.Generator().manual_seed(0)) < 0.5
        y = torch.where(keep, seen[-1] / 0.5, 0.0)
        want = F.log_softmax(model.fc2(F.relu(model.fc1(F.relu(
            TL.max_pool(y, 2, 2)).flatten(1)))), -1)
    assert 0 < int(keep.sum()) < keep.numel()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Converters: every weight lands where the JAX tree has it
# ---------------------------------------------------------------------------

def _to_jax_kernel(w, nchw_map=None):
    """A port weight back in the JAX layout: conv OIHW → HWIO, dense
    (out, in) → (in, out), fc1's (c, h, w) rows back to (h, w, c)."""
    w = w.detach().numpy()
    if w.ndim == 4:
        return np.transpose(w, (2, 3, 1, 0))
    k = w.T
    if nchw_map is not None:
        c, h, ww = nchw_map
        k = k.reshape(c, h, ww, -1).transpose(1, 2, 0, 3).reshape(
            c * h * ww, -1)
    return k


def test_vgg_converter_round_trips_every_weight():
    v = JM.zoo_init("vgg16", jax.random.PRNGKey(2), num_classes=10,
                    image_size=64)
    model = TM.zoo_from_jax("vgg16", _host(v), compute_dtype=None)
    p = v["params"]
    for name, mod in model.named_children():
        nchw = (512, 2, 2) if name == "fc1" else None
        np.testing.assert_array_equal(_to_jax_kernel(mod.weight, nchw),
                                      np.asarray(p[name]["kernel"]))
        np.testing.assert_array_equal(mod.bias.detach().numpy(),
                                      np.asarray(p[name]["bias"]))
    assert len(list(model.named_children())) == len(p)


def test_mnist_converter_round_trips_every_weight():
    params, _, _ = _mnist_case()
    model = TM.mnist_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for name, mod in model.named_children():
        nchw = (20, 4, 4) if name == "fc1" else None
        np.testing.assert_array_equal(_to_jax_kernel(mod.weight, nchw),
                                      np.asarray(params[name]["kernel"]))
        np.testing.assert_array_equal(mod.bias.detach().numpy(),
                                      np.asarray(params[name]["bias"]))


# ---------------------------------------------------------------------------
# Compression: the whole namespace
# ---------------------------------------------------------------------------

def test_compression_namespace_matches_jax():
    names = [n for n in vars(JC.Compression) if not n.startswith("_")]
    assert sorted(names) == sorted(
        n for n in vars(TC.Compression) if not n.startswith("_"))
    for n in names:
        assert getattr(TC.Compression, n).wire == \
            getattr(JC.Compression, n).wire
    assert hvd.Compression.bf16 is TC.BF16Compressor


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.int32])
def test_bf16_compression_round_trips(dtype):
    x = (torch.randn(64, generator=torch.Generator().manual_seed(1))
         * 4).to(dtype)
    c, ctx = TC.Compression.bf16.compress(x)
    assert c.dtype == (torch.bfloat16 if dtype.is_floating_point else dtype)
    y = TC.Compression.bf16.decompress(c, ctx)
    assert y.dtype == dtype
    want = np.asarray(JC.Compression.bf16.decompress(
        *JC.Compression.bf16.compress(jnp.asarray(x.numpy()))))
    np.testing.assert_array_equal(y.numpy(), want)


@pytest.mark.parametrize("name", ["int8", "int4", "fp8_e4m3", "fp8_e5m2"])
def test_cooperative_compressors_raise_as_jax_eager(name):
    """A single tensor's compress raises, as the JAX package's does: the
    gradient paths route these wires to the quantized ring first.  The
    optimizer takes them, except with Adasum (which combines deltas)."""
    with pytest.raises(NotImplementedError):
        getattr(JC.Compression, name).compress(jnp.ones(4))
    with pytest.raises(NotImplementedError, match="quantized ring"):
        getattr(TC.Compression, name).compress(torch.ones(4))
    with pytest.raises(ValueError, match=name):
        hvd.DistributedOptimizer(
            torch.optim.SGD(torch.nn.Linear(2, 2).parameters(), lr=0.1),
            compression=getattr(hvd.Compression, name), op=hvd.Adasum)


# ---------------------------------------------------------------------------
# The hook path's buckets are the JAX partition (VGG-16's leaves)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threshold", [64 << 20, 16 << 20])
def test_vgg16_buckets_are_the_jax_partition(monkeypatch, threshold):
    """At 224×224: fc2's kernel is exactly 64 MiB and fc1's 411 MB is
    above it.  The buckets the optimizer flushes, in the order the
    backward makes the gradients final, hold the leaves JAX's
    `gradient_bucket_partition` gives for the same sizes in that order."""
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(threshold))
    hvd.init(device="cpu")
    try:
        model = TM.VGG16(10, 224, compute_dtype=None)
        order = []
        for p in model.parameters():
            p.register_post_accumulate_grad_hook(lambda p: order.append(p))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.0))
        flushed = []
        flush = opt._flush

        def record():
            if opt._bucket:
                flushed.append(list(opt._bucket))
            flush()

        opt._flush = record
        x = torch.rand(1, 3, 224, 224, generator=torch.Generator())
        F.cross_entropy(model(x), torch.tensor([1])).backward()
        opt.step()
    finally:
        hvd.shutdown()
    leaves = [jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
              for p in order]
    want = JD.gradient_bucket_partition(leaves,
                                        fusion_threshold_bytes=threshold,
                                        bucket_order="forward")
    index = {id(p): i for i, p in enumerate(order)}
    got = [[index[id(p)] for p in b] for b in flushed]
    assert got == want and opt.total_flushes == len(want)


# ---------------------------------------------------------------------------
# synthetic_benchmark --model and --compression
# ---------------------------------------------------------------------------

def _bench(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = synthetic_benchmark.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("name", JM.zoo_models())
def test_synthetic_benchmark_takes_a_step_of_each_model(name):
    size = {"inception3": "75", "vgg16": "64"}.get(name, "32")
    rc, out = _bench(["--device", "cpu", "--model", name, "--image-size",
                      size, "--num-classes", "10", "--batch-size", "2",
                      "--num-warmup-batches", "0", "--num-batches-per-iter",
                      "1", "--num-iters", "1", "--log-steps",
                      "--compression", "bf16"])
    assert rc == 0
    (summary,) = [json.loads(l[8:]) for l in out.splitlines()
                  if l.startswith("SUMMARY ")]
    (step,) = [json.loads(l[5:]) for l in out.splitlines()
               if l.startswith("STEP ")]
    assert summary["model"] == step["model"] == name
    assert summary["steps"] == 1 and np.isfinite(step["loss"])
    assert summary["flushes"] >= 1 and summary["peak_mem_gb"] is None


def test_synthetic_benchmark_refuses_int8_before_the_first_step(capsys):
    """int8 with --use-adasum is the JAX example's argument error: Adasum
    reduces deltas, the ring gradients."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        try:
            synthetic_benchmark.main(["--device", "cpu", "--model",
                                      "resnet18", "--image-size", "32",
                                      "--compression", "int8",
                                      "--use-adasum"])
        finally:
            hvd.shutdown()
    assert e.value.code == 2
    assert "1-byte ring compression" in capsys.readouterr().err
    assert "STEP" not in out.getvalue() and "Iter" not in out.getvalue()
