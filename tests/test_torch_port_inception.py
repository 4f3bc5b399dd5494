"""Port parity: Inception V3 (`horovod_tpu_torch.models.Inception3`)
against the JAX package's `inception3_apply` on the same weights and
inputs (NHWC in JAX, NCHW in the port), at 75×75 (its minimum), 10
classes, train and eval, and `inception_from_jax` weight by weight.

Tolerances (f32 on the CPU; XLA and oneDNN sum convolutions in other
orders): logits 2e-3 of their largest value and batch-norm statistics
1e-3, as ResNet-50's (tests/test_torch_port_resnet.py), after 94
convolutions with batch norm between them; the converter exactly.  The
train-mode forward runs at batch 8: at 75×75 the last blocks see 1×1
maps, and batch norm over 2 values per channel (var = E[x²] - mean² of
two numbers) magnifies each framework's last-bit differences past any
fixed tolerance (0.52 of the largest logit at batch 2, 1.7e-3 at batch
8); the eval forward runs at batch 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import models as JM
from horovod_tpu_torch import models as TM

from test_torch_port_collectives import no_launcher_env  # noqa: F401 (autouse)
from test_torch_port_zoo import _assert_rel, _host, _nchw, _to_jax_kernel


# ---------------------------------------------------------------------------
# Inception V3 at 75×75
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inception_pair():
    v = JM.zoo_init("inception3", jax.random.PRNGKey(0), num_classes=10)
    apply = jax.jit(lambda p, s, x, train: JM.inception3_apply(
        {"params": p, "batch_stats": s, "config": v["config"]}, x,
        train=train, compute_dtype=jnp.float32), static_argnames="train")
    rng = np.random.RandomState(7)
    out = {"v": v}
    for train, batch in ((True, 8), (False, 2)):
        x = rng.rand(batch, 75, 75, 3).astype(np.float32)
        logits, stats = apply(v["params"], v["batch_stats"], jnp.asarray(x),
                              train=train)
        model = TM.inception_from_jax(_host(v), compute_dtype=None)
        model.train(train)
        with torch.no_grad():
            got = model(_nchw(x))
        out[train] = (model, np.asarray(logits), stats, got)
    return out


@pytest.mark.parametrize("train", [True, False])
def test_inception_logits_match_jax(inception_pair, train):
    _, want, _, got = inception_pair[train]
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_rel(got.numpy(), want, 2e-3)


@pytest.mark.parametrize("unit", ["stem/conv1", "stem/conv5", "mixed0/pool",
                                  "mixed3/b3x3dbl_3", "mixed4/b7x7_2",
                                  "mixed8/b7x7x3_4", "mixed10/b3x3dbl_3b"])
def test_inception_batch_stats_match_jax(inception_pair, unit):
    model, _, stats, _ = inception_pair[True]
    bn = model.get_submodule(unit.replace("/", ".")).bn
    for ours, theirs in ((bn.running_mean, stats[unit]["mean"]),
                         (bn.running_var, stats[unit]["var"])):
        _assert_rel(ours.numpy(), theirs, 1e-3)


def test_inception_eval_keeps_the_statistics(inception_pair):
    model, _, stats, _ = inception_pair[False]
    v = inception_pair["v"]
    for unit in ("stem/conv1", "mixed10/pool"):
        bn = model.get_submodule(unit.replace("/", ".")).bn
        np.testing.assert_array_equal(
            bn.running_var.numpy(), np.asarray(v["batch_stats"][unit]["var"]))
        np.testing.assert_array_equal(
            np.asarray(stats[unit]["var"]),
            np.asarray(v["batch_stats"][unit]["var"]))


def test_inception_converter_round_trips_every_weight(inception_pair):
    v = inception_pair["v"]
    model = TM.zoo_from_jax("inception3", _host(v), compute_dtype=None)
    p, s = v["params"], v["batch_stats"]
    units = [(path, m) for path, m in model.named_modules()
             if isinstance(m, TM.inception.ConvBN)]
    assert len(units) == len(s) == len(p) - 1  # all but the head
    for path, m in units:
        key = path.replace(".", "/")
        np.testing.assert_array_equal(_to_jax_kernel(m.conv.weight),
                                      np.asarray(p[key]["conv"]["kernel"]))
        for ours, theirs in ((m.bn.weight, p[key]["bn"]["scale"]),
                             (m.bn.bias, p[key]["bn"]["bias"]),
                             (m.bn.running_mean, s[key]["mean"]),
                             (m.bn.running_var, s[key]["var"])):
            np.testing.assert_array_equal(ours.detach().numpy(),
                                          np.asarray(theirs))
    np.testing.assert_array_equal(_to_jax_kernel(model.head.weight),
                                  np.asarray(p["head"]["kernel"]))


def test_sync_bn_reaches_every_batch_norm():
    """`sync_bn` is ResNet's: every unit's batch norm takes the set's
    statistics (at one rank, the local ones)."""
    import horovod_tpu_torch as hvd

    plain = TM.Inception3(10, compute_dtype=None, seed=4)
    synced = TM.Inception3(10, compute_dtype=None, seed=4, sync_bn=True)
    bns = [m for m in synced.modules() if isinstance(m, TM.layers.BatchNorm)]
    assert len(bns) == 94 and all(b.process_set is True for b in bns)
    x = torch.rand(2, 3, 75, 75, generator=torch.Generator().manual_seed(1))
    hvd.init(device="cpu")
    try:
        with torch.no_grad():
            torch.testing.assert_close(synced(x), plain(x), rtol=0, atol=0)
    finally:
        hvd.shutdown()
