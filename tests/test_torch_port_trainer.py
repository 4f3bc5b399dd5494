"""Port parity: the horovod.torch training loop of `horovod_tpu_torch`
at np=2 on the CPU (gloo), on a small ResNet-18 (32×32 images, 10
classes, batch 2 per rank, f32).

- `DistributedOptimizer(op=Adasum)`, two steps: each step's new
  parameters must equal start + the JAX package's `adasum_tree_reduce`
  of the two ranks' stacked local deltas (each rank's delta is replayed
  on a copy of its model and optimizer), and be bitwise identical on
  both ranks.
- `DistributedOptimizer(op=Adasum, compression=Compression.fp16)`, one
  step: the deltas travel and combine as float16, so the new parameters
  are start + the JAX tree of the float16-cast local deltas.
- `DistributedOptimizer(op=Average)`, one step: the reduced gradient
  must equal the mean of the ranks' local gradients (the JAX eager
  Average), with `backward_passes_per_step`, `gradient_predivide_factor`
  and fp16 compression checked on a linear layer.

Tolerances are stated at each test; the Average of two f32 values is
exact.
"""

import hashlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import adasum as JA
from horovod_tpu.ops import collectives as JC

from test_torch_port_collectives import LAUNCHER_ENV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NP = 2

WORKER = r'''
import copy, hashlib, sys
import numpy as np
import torch
import torch.nn.functional as F
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import ResNet

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
torch.use_deterministic_algorithms(True)

def flat(ts):
    return torch.cat([t.detach().reshape(-1) for t in ts]).clone()

def batch(seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, 3, 32, 32, generator=g),
            torch.randint(0, 10, (2,), generator=g))

res = {}
# --- op=Adasum: two steps ----------------------------------------------
model = ResNet(18, 10, compute_dtype=None, seed=r)   # broadcast fixes it
opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
dopt = hvd.DistributedOptimizer(opt, named_parameters=model.named_parameters(),
                                op=hvd.Adasum)
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
hvd.broadcast_optimizer_state(opt, root_rank=0)
params = list(model.parameters())
for step in range(2):
    x, y = batch(10 * r + step)
    p0 = flat(params)
    shadow = copy.deepcopy(model)
    sopt = torch.optim.SGD(shadow.parameters(), lr=0.05, momentum=0.9)
    sopt.load_state_dict(copy.deepcopy(opt.state_dict()))
    F.cross_entropy(shadow(x), y).backward()
    sopt.step()
    res[f"adasum_delta{step}"] = (flat(shadow.parameters()) - p0).numpy()
    dopt.zero_grad()
    F.cross_entropy(model(x), y).backward()
    dopt.step()
    p1 = flat(params)
    res[f"adasum_digest{step}"] = hashlib.sha256(p1.numpy().tobytes()).hexdigest()
    if r == 0:
        res[f"adasum_p0_{step}"] = p0.numpy()
        res[f"adasum_p1_{step}"] = p1.numpy()
del model, opt, dopt, shadow, sopt

# --- op=Adasum, Compression.fp16: one step -------------------------------
model = ResNet(18, 10, compute_dtype=None, seed=r)
opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
dopt = hvd.DistributedOptimizer(opt, named_parameters=model.named_parameters(),
                                op=hvd.Adasum,
                                compression=hvd.Compression.fp16)
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
params = list(model.parameters())
x, y = batch(300 + r)
p0 = flat(params)
shadow = copy.deepcopy(model)
sopt = torch.optim.SGD(shadow.parameters(), lr=0.05, momentum=0.9)
F.cross_entropy(shadow(x), y).backward()
sopt.step()
res["fp16_delta"] = (flat(shadow.parameters()) - p0).numpy()
dopt.zero_grad()
F.cross_entropy(model(x), y).backward()
dopt.step()
p1 = flat(params)
res["fp16_digest"] = hashlib.sha256(p1.numpy().tobytes()).hexdigest()
if r == 0:
    res["fp16_p0"] = p0.numpy()
    res["fp16_p1"] = p1.numpy()
del model, opt, dopt, shadow, sopt

# --- op=Average: one step ------------------------------------------------
model = ResNet(18, 10, compute_dtype=None, seed=r)
opt = torch.optim.SGD(model.parameters(), lr=0.1)
dopt = hvd.DistributedOptimizer(opt, named_parameters=model.named_parameters())
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
x, y = batch(100 + r)
dopt.zero_grad()
F.cross_entropy(model(x), y).backward()
res["avg_local"] = flat(p.grad for p in model.parameters()).numpy()
dopt.step()
reduced = flat(p.grad for p in model.parameters())
res["avg_digest"] = hashlib.sha256(reduced.numpy().tobytes()).hexdigest()
res["avg_flushes"] = dopt.total_flushes
if r == 0:
    res["avg_reduced"] = reduced.numpy()

# --- options on a linear layer -------------------------------------------
for name, kw in (("bpps", dict(backward_passes_per_step=2)),
                 ("predivide", dict(gradient_predivide_factor=2.0)),
                 ("fp16", dict(compression=hvd.Compression.fp16))):
    lin = torch.nn.Linear(4, 3)
    dopt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1),
                                    named_parameters=lin.named_parameters(), **kw)
    hvd.broadcast_parameters(lin.state_dict(), root_rank=0)
    g = torch.Generator().manual_seed(200 + r)
    passes = kw.get("backward_passes_per_step", 1)
    for i in range(passes):
        lin(torch.randn(5, 4, generator=g)).square().sum().backward()
        if i < passes - 1:
            assert dopt.step() is None  # accumulation pass
    res[name + "_local"] = lin.weight.grad.clone().numpy()
    dopt.step()
    res[name + "_reduced"] = lin.weight.grad.clone().numpy()
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


def run_world(tmp_path, n: int, source: str, timeout: float = 300):
    """Run `source` as n CPU ranks over gloo (a `file://` rendezvous
    under tmp_path); return each rank's saved results."""
    url = f"file://{tmp_path}/rendezvous"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    for k in LAUNCHER_ENV + ("HOROVOD_FUSION_THRESHOLD",):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", source, str(tmp_path), str(n), str(r), url],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("trainer"), NP, WORKER)


def _stack(world, key):
    return np.stack([d[key] for d in world])


@pytest.mark.parametrize("step", [0, 1])
def test_adasum_step_is_start_plus_jax_tree_of_local_deltas(world, step):
    """Against the JAX package's tree.  XLA:CPU sums an f32 `vdot` of
    these 11.2M-element deltas with ~0.7% error in the norms (measured
    against f64: 6,701,239 vs 6,747,314), so the JAX tree itself is off
    by up to 4e-5 of the largest update; hence atol 2e-4 of it here and
    the tight f64 check below."""
    deltas = _stack(world, f"adasum_delta{step}")
    assert deltas.shape[0] == NP and np.abs(deltas).max() > 0
    want_delta = np.asarray(JA.adasum_tree_reduce(jnp.asarray(deltas)))
    p0 = world[0][f"adasum_p0_{step}"]
    np.testing.assert_allclose(world[0][f"adasum_p1_{step}"],
                               p0 + want_delta, rtol=0,
                               atol=2e-4 * np.abs(want_delta).max())


@pytest.mark.parametrize("step", [0, 1])
def test_adasum_step_matches_f64_reference(world, step):
    """Against the f64 model: within 1e-6 of the largest update (the
    port's f32 sums are pairwise; measured 8e-8)."""
    deltas = _stack(world, f"adasum_delta{step}")
    want = JA.adasum_reference(list(deltas))
    update = (world[0][f"adasum_p1_{step}"].astype(np.float64)
              - world[0][f"adasum_p0_{step}"])
    np.testing.assert_allclose(update, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("step", [0, 1])
def test_adasum_parameters_identical_on_every_rank(world, step):
    assert len({d[f"adasum_digest{step}"] for d in world}) == 1
    p1 = world[0][f"adasum_p1_{step}"]
    assert hashlib.sha256(p1.tobytes()).hexdigest() == \
        world[0][f"adasum_digest{step}"]


def test_adasum_step_differs_from_plain_average(world):
    """Adasum is not the mean: the check above would not pass for a
    wrongly averaged delta."""
    deltas = _stack(world, "adasum_delta0")
    update = world[0]["adasum_p1_0"] - world[0]["adasum_p0_0"]
    assert not np.allclose(update, deltas.mean(0), rtol=1e-3, atol=1e-5)


def _fp16_case(world):
    """The float16-cast local deltas (as FP16Compressor casts them) and
    the update rank 0 applied, with one f16 ulp of the largest update:
    the combined delta is rounded to f16 once."""
    deltas = _stack(world, "fp16_delta").astype(np.float16)
    update = world[0]["fp16_p1"] - world[0]["fp16_p0"]
    m = np.abs(deltas).max()
    return deltas, update, float(np.spacing(np.float16(m)))


def test_adasum_fp16_step_is_start_plus_jax_tree_of_f16_deltas(world):
    """Against the JAX tree on the same f16 deltas: 2e-4 of the largest
    update (XLA:CPU's f32 vdot, as above) plus one f16 ulp of it."""
    deltas, _, ulp = _fp16_case(world)
    want = np.asarray(JA.adasum_tree_reduce(jnp.asarray(deltas))
                      .astype(jnp.float32))
    p0 = world[0]["fp16_p0"]
    np.testing.assert_allclose(world[0]["fp16_p1"], p0 + want, rtol=0,
                               atol=2e-4 * np.abs(want).max() + ulp)


def test_adasum_fp16_step_matches_f64_reference(world):
    """Against the f64 model of the f16 deltas: within one f16 ulp of
    the largest update (the f16 rounding of the result, and f32 sums)."""
    deltas, update, ulp = _fp16_case(world)
    want = JA.adasum_reference(list(deltas))
    assert not np.allclose(update, deltas.astype(np.float32).mean(0),
                           rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(update, want, rtol=0, atol=ulp)


def test_adasum_fp16_parameters_identical_on_every_rank(world):
    assert len({d["fp16_digest"] for d in world}) == 1


def test_average_step_is_mean_of_local_gradients(world):
    local = _stack(world, "avg_local")
    want = np.asarray(JC._reduce_in_graph(jnp.asarray(local), JC.Average,
                                          NP))
    np.testing.assert_allclose(world[0]["avg_reduced"], want, rtol=1e-6,
                               atol=0)
    assert len({d["avg_digest"] for d in world}) == 1


def test_average_fuses_resnet18_grads_into_one_bucket(world):
    """47 MB of f32 gradients stay under the 64 MiB default
    HOROVOD_FUSION_THRESHOLD: one grouped allreduce per step."""
    assert all(d["avg_flushes"] == 1 for d in world)


@pytest.mark.parametrize("option", ["bpps", "predivide", "fp16"])
def test_optimizer_options_reduce_to_the_mean(world, option):
    local = _stack(world, option + "_local")
    if option == "fp16":
        wire = jnp.asarray(local, jnp.float16)
        want = np.asarray(JC._reduce_in_graph(wire, JC.Average, NP)
                          .astype(jnp.float32))
        tol = 1e-3
    else:
        want = local.mean(0) / (2 if option == "bpps" else 1)
        tol = 1e-6
    for d in world:
        np.testing.assert_allclose(d[option + "_reduced"], want, rtol=tol,
                                   atol=tol)
