"""Port parity: the MNIST trainer `horovod_tpu_torch.torch_mnist`
(BASELINE config 1) against the JAX example's data and the JAX model's
gradients.

- `synthetic_mnist` is bitwise `examples/mnist.py`'s.
- Two SGD-momentum steps of the trainer's `train_step` at one rank (the
  optimizer wrapped in `DistributedOptimizer`) leave the parameters that
  `jax.grad` of `mnist_cnn_apply` / `nll_loss` and the momentum update
  in numpy give, within 1e-5 of each parameter's largest value (f32 on
  the CPU, two frameworks' convolution orders).
- `torch_mnist` at one rank on the CPU: the mean loss falls over 2
  small epochs.
- At two ranks over gloo: both ranks end on the same parameters, step by
  step.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.mnist import synthetic_mnist as jax_synthetic_mnist
from horovod_tpu import models as JM
import horovod_tpu_torch as hvd
from horovod_tpu_torch import models as TM
from horovod_tpu_torch import torch_mnist

from test_torch_port_collectives import no_launcher_env  # noqa: F401 (autouse)
from test_torch_port_trainer import run_world


@pytest.mark.parametrize("n,seed", [(8192, 0), (300, 5)])
def test_synthetic_mnist_is_the_jax_examples(n, seed):
    got, want = torch_mnist.synthetic_mnist(n, seed), \
        jax_synthetic_mnist(n, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_two_sgd_momentum_steps_match_jax_grad():
    lr, momentum = 0.05, 0.5
    params = JM.mnist_cnn_init(jax.random.PRNGKey(3))
    images, labels = torch_mnist.synthetic_mnist(16, seed=2)
    batches = [(images[:8], labels[:8]), (images[8:], labels[8:])]

    def loss_fn(p, x, y):
        return JM.nll_loss(JM.mnist_cnn_apply(p, x), y)

    want = jax.tree_util.tree_map(np.asarray, params)
    buf = None
    for x, y in batches:
        g = jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(
            want, jnp.asarray(x), jnp.asarray(y)))
        # torch.optim.SGD: buf = g at the first step, then
        # momentum * buf + g; p -= lr * buf.
        buf = g if buf is None else jax.tree_util.tree_map(
            lambda b, gg: momentum * b + gg, buf, g)
        want = jax.tree_util.tree_map(lambda p, b: p - lr * b, want, buf)

    hvd.init(device="cpu")
    try:
        model = TM.mnist_from_jax(jax.tree_util.tree_map(np.asarray, params))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum),
            named_parameters=model.named_parameters())
        for x, y in batches:
            loss = torch_mnist.train_step(
                model, opt, torch.from_numpy(np.ascontiguousarray(
                    x.transpose(0, 3, 1, 2))), torch.from_numpy(y))
            assert np.isfinite(float(loss))
    finally:
        hvd.shutdown()
    ref = dict(TM.mnist_from_jax(want).named_parameters())
    for name, p in model.named_parameters():
        w = ref[name].detach().numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def _summary(text):
    (s,) = [json.loads(line[8:]) for line in text.splitlines()
            if line.startswith("SUMMARY ")]
    return s


def test_one_rank_on_the_cpu_loss_falls():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert torch_mnist.main(["--device", "cpu", "--epochs", "2",
                                 "--num-samples", "2048"]) == 0
    s = _summary(out.getvalue())
    assert s["size"] == 1 and s["steps"] == 2 * (2048 - 256) // 64
    assert s["epoch_losses"][1] < s["epoch_losses"][0]
    assert all(np.isfinite(s["epoch_losses"])) and s["test_acc"][-1] > 0.1


WORKER = r'''
import contextlib, io, json, os, sys
import torch
out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
os.environ.update(HOROVOD_COORDINATOR_ADDR=url, HOROVOD_NUM_PROCESSES=str(n),
                  HOROVOD_PROCESS_ID=str(r))
from horovod_tpu_torch import torch_mnist
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    torch_mnist.main(["--device", "cpu", "--epochs", "2", "--num-samples",
                      "2048", "--log-steps"])
lines = buf.getvalue().splitlines()
torch.save({"steps": [json.loads(l[5:]) for l in lines if l.startswith("STEP ")],
            "summary": [json.loads(l[8:]) for l in lines
                        if l.startswith("SUMMARY ")][0]},
           f"{out_dir}/rank{r}.pt")
'''


def test_two_ranks_over_gloo_agree_on_every_step(tmp_path):
    world = run_world(tmp_path, 2, WORKER, timeout=240)
    s0, s1 = world[0]["summary"], world[1]["summary"]
    assert s0["size"] == s1["size"] == 2
    assert s0["steps"] == 2 * (2048 - 256) // 128 == len(world[0]["steps"])
    assert [r["digest"] for r in world[0]["steps"]] == \
        [r["digest"] for r in world[1]["steps"]]
    assert s0["digest"] == s1["digest"] and s0["test_acc"] == s1["test_acc"]
    # Each rank trains on its own half of every global batch.
    assert world[0]["steps"][0]["loss"] != world[1]["steps"][0]["loss"]
    assert s0["epoch_losses"][1] < s0["epoch_losses"][0]
