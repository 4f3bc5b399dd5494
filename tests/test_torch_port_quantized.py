"""Port parity: the quantized ring of `horovod_tpu_torch/ops/quantized.py`
and the wires of the gradient and ZeRO paths, in np=2 and np=4 gloo
worlds on the CPU.

Each world is one set of worker processes that runs every case once and
saves what each rank got; the tests below hold it:

- bitwise to the port's single-process ring model (`allreduce_model`,
  `reducescatter_model`, `allgather_model`), which the tests run here
  over all ranks' inputs;
- to the JAX package's `quantized_allreduce`, `quantized_reducescatter_
  shard` and `quantized_allgather_shard` on a mesh of n of the eight CPU
  devices, within `JAX_ATOL` + one quantization step per lossy encode
  where a last-bit difference tipped a rounding: XLA fuses the ring's
  adds and divides inside one program and rounds differently from the
  eager ops (on N(0, 1) sums at n = 4 the two differed by at most 9.5e-7
  absolute before the quantization), so the JAX ring is a tolerance
  reference, and the model the bitwise one;
- to the exact sum, within the model's bound of every encode's error;
- to the error-feedback identity n·out_t = Σ g + Σ e_t − Σ e_{t+1}, at
  the JAX package's tolerance (tests/test_quantized.py:191).

The gradient paths (two ranks only where a ResNet step runs):
`allreduce_gradients` with error feedback and integer leaves, the hook
optimizer's buckets under `Compression.int8` and under
HOROVOD_WIRE_POLICY against the JAX partition and plan, a ResNet-18 step
under int8 against the exact one, "exact" against the unset policy, the
sharded optimizer's error-feedback rows and their reset, the allgather
wire's f32 masters, ZeRO-3's int8 gather (bitwise across ranks, fused
and not), and the refusals.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import quantized as JQ
from horovod_tpu.ops.compression import Compression as JComp
from horovod_tpu.parallel import data_parallel as JD
from horovod_tpu_torch.ops import quantized as TQ
from horovod_tpu_torch.ops import wire as TW
from horovod_tpu_torch.parallel import data_parallel as TD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIRES = ["int8", "int4", "fp8_e4m3", "fp8_e5m2"]
# The port's ring and the JAX package's agree to this absolute distance
# (relative to the largest exact value) wherever no rounding of a
# quantizer tipped; see the module docstring.
JAX_ATOL = 2e-6
L = 1000          # allreduce length (not a multiple of n·128: padding)
AG = 300          # allgather shard length (padded to 384)

WORKER = r'''
import os, sys
import numpy as np
import torch
import torch.nn.functional as F
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import quantized as Q
from horovod_tpu_torch.ops import fused_collectives as FC
from horovod_tpu_torch.ops import wire as W
from horovod_tpu_torch.parallel import data_parallel as DP

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
L, AG = 1000, 300
WIRES = ["int8", "int4", "fp8_e4m3", "fp8_e5m2"]


def x_of(rank, seed=200, size=L):
    rng = np.random.RandomState(seed + rank)
    scale = rng.choice([1e-3, 1.0, 30.0], size)
    return torch.from_numpy((rng.randn(size) * scale).astype(np.float32))


res = {}
x, e = x_of(r), x_of(r, 500) * 1e-2
for w in WIRES + ["bf16"]:
    res["ar_avg", w] = Q.quantized_allreduce_shard(x, average=True, wire=w)
    res["ar_sum_ef", w] = Q.quantized_allreduce_shard(x, wire=w,
                                                      error_feedback=e)
    seg = (L // n) * n
    res["rs", w] = Q.quantized_reducescatter_shard(
        x[:seg], average=True, wire=w, error_feedback=e[:seg])
    res["ag", w] = Q.quantized_allgather_shard(x[:AG], wire=w)
    big = x_of(r, 700, 5000)
    res["par", w] = (FC.pipelined_allreduce_shard(big, average=True, wire=w,
                                                  chunk_bytes=4096),
                     Q.quantized_allreduce_shard(big, average=True, wire=w))
    res["pag", w] = (FC.pipelined_allgather_shard(big, wire=w,
                                                  chunk_bytes=1024),
                     Q.quantized_allgather_shard(big, wire=w))
# Shapes and dtypes: a 2-D bf16 input comes back 2-D bf16.
x2 = x[:330].reshape(10, 33).bfloat16()
res["ar_2d"] = Q.quantized_allreduce_shard(x2, wire="int8")

# Error feedback across steps, through allreduce_gradients.
g = x_of(r, 900, 256)
state = DP.error_feedback_init([g])
steps = []
for _ in range(3):
    out, new = DP.allreduce_gradients([g], compression=hvd.Compression.int8,
                                      error_feedback_state=state)
    steps.append((out[0], state[0].clone(), new[0]))
    state = new
res["ef_steps"] = steps
# Integer leaves ride their own exact bucket.
leaves = {"a": x_of(r, 40, 700), "i": torch.arange(5) * (r + 1),
          "b": x_of(r, 41, 90).bfloat16()}
res["mixed"] = DP.allreduce_gradients(leaves, op=hvd.Sum,
                                      compression=hvd.Compression.int8)
res["mixed_parts"] = DP.gradient_bucket_partition(
    list(leaves.values()), compression=hvd.Compression.int8)

# A set of ranks 1..n-1: the hops' peers are global ranks.
tail = hvd.add_process_set(list(range(1, n)))
if r >= 1:
    res["tail_ring"] = Q.quantized_allreduce_shard(x, process_set=tail,
                                                   average=True)
# A one-rank set exchanges nothing.
one = hvd.add_process_set([0])
if r == 0:
    res["one_rank"] = Q.quantized_allreduce_shard(x, process_set=one,
                                                  error_feedback=e)
    res["one_rank_ag"] = Q.quantized_allgather_shard(x[:AG],
                                                     process_set=one)


# The hook optimizer's buckets: f32 and bf16 parameters, so that the
# cooperative rule (4 bytes an element) moves the partition.
def net():
    torch.manual_seed(3)
    m = torch.nn.Sequential(torch.nn.Linear(64, 48), torch.nn.ReLU(),
                            torch.nn.Linear(48, 40), torch.nn.ReLU(),
                            torch.nn.Linear(40, 8))
    m[2].to(torch.bfloat16)
    return m


def run_hook(compression, env=None, threshold=6000, steps=1):
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    os.environ["HOROVOD_FUSION_THRESHOLD"] = str(threshold)
    try:
        m = net()
        order = []
        for p in m.parameters():
            p.register_post_accumulate_grad_hook(
                lambda p: order.append((tuple(p.shape), str(p.dtype))))
        opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                       lr=0.0),
                                       compression=compression)
        rng = np.random.RandomState(10 + r)
        xin = torch.from_numpy(rng.randn(16, 64).astype(np.float32))
        for _ in range(steps):
            opt.zero_grad()
            h = m[1](m[0](xin)).bfloat16()
            h = m[3](m[2](h)).float()
            F.cross_entropy(m[4](h), torch.arange(16) % 8).backward()
            opt.step()
        return {"order": order, "buckets": opt.last_buckets,
                "ring": opt.ring_buckets, "flushes": opt.total_flushes,
                "grads": [p.grad.clone() for p in m.parameters()]}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        os.environ.pop("HOROVOD_FUSION_THRESHOLD", None)


res["hook_int8"] = run_hook(hvd.Compression.int8)
res["hook_int8_fused"] = run_hook(hvd.Compression.int8, {
    "HOROVOD_FUSED_COLLECTIVES": "1", "HOROVOD_FUSED_CHUNK_BYTES": "4096"})
res["hook_policy"] = run_hook(hvd.Compression.none, {
    "HOROVOD_WIRE_POLICY": "big=int4,small=bf16,threshold=5000"})
res["hook_unset"] = run_hook(hvd.Compression.none)
res["hook_exact"] = run_hook(hvd.Compression.none,
                             {"HOROVOD_WIRE_POLICY": "exact"})

# The sharded optimizer under the policy: record every reduce-scatter.
calls = []
rs = Q.quantized_reducescatter_shard


def recording(flat, *a, **kw):
    out = rs(flat, *a, **kw)
    calls.append((flat.clone(), kw["error_feedback"].clone(),
                  out[0].clone(), out[1].clone()))
    return out


Q.quantized_reducescatter_shard = recording
os.environ["HOROVOD_WIRE_POLICY"] = "big=int8,small=none,threshold=4096"
m = net().float()
opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.05),
                               zero_stage=1, fusion_threshold_bytes=1 << 20)
rng = np.random.RandomState(20 + r)
xin = torch.from_numpy(rng.randn(16, 64).astype(np.float32))
marks = []
for step in range(4):
    if step == 2:
        marks.append(len(calls))
        W.reset_error_feedback()
    opt.zero_grad()
    F.cross_entropy(m(xin), torch.arange(16) % 8).backward()
    opt.step()
Q.quantized_reducescatter_shard = rs
del os.environ["HOROVOD_WIRE_POLICY"]
res["zero_calls"], res["zero_reset_at"] = calls, marks[0]
res["zero_codecs"] = [c.name if c is not None else None
                      for c in opt._rs_codecs]

# The allgather wire: f32 masters kept, parameters equal across ranks.
m = net().float()
opt = hvd.DistributedOptimizer(torch.optim.Adam(m.parameters(), lr=1e-2),
                               zero_stage=1, allgather_wire="int8")
hvd.broadcast_parameters(m.state_dict(), root_rank=0)
ag_steps = []
for step in range(3):
    opt.zero_grad()
    F.cross_entropy(m(xin), torch.arange(16) % 8).backward()
    opt.step()
    ag_steps.append(([p.detach().clone() for p in m.parameters()],
                     [s.clone() for s in opt._shards],
                     float(opt.master_wire_diff)))
res["ag_wire"] = ag_steps

# ZeRO-3: the int8 gather, unfused and fused, and gather_matmul.
params = [x_of(0, 60, 256 * 64).reshape(256, 64),
          x_of(0, 61, 100), x_of(0, 62, 8 * 33).reshape(8, 33)]
pl = hvd.zero3_placement(params, fusion_threshold_bytes=1 << 20,
                         gather_wire="int8")
rows = pl.shard(params)
res["z3_rows"] = [t.clone() for t in rows]
res["z3_gather"] = pl.gather(rows)
os.environ["HOROVOD_FUSED_COLLECTIVES"] = "1"
os.environ["HOROVOD_FUSED_CHUNK_BYTES"] = "4096"
res["z3_gather_fused"] = pl.gather(rows)
head = [params[0]]
hp = hvd.zero3_placement(head, gather_wire="int8")
hrows = hp.shard(head)
xe = x_of(r, 80, 4 * 64).reshape(4, 64)
with torch.no_grad():
    res["z3_gm"] = hp.gather_matmul(xe, hrows, 0)
del os.environ["HOROVOD_FUSED_COLLECTIVES"]
del os.environ["HOROVOD_FUSED_CHUNK_BYTES"]
res["z3_head_rows"] = hrows[0].clone()


def refusal(fn):
    try:
        fn()
    except Exception as ex:  # noqa: BLE001
        return f"{type(ex).__name__}: {ex}"
    return None


sub = hvd.add_process_set(list(range(n - 1))) if n > 2 else None
sgd = lambda: torch.optim.SGD(net().float().parameters(), lr=0.1)  # noqa
if r < n - 1 and sub is not None:
    res["refuse_subset"] = refusal(lambda: hvd.DistributedOptimizer(
        sgd(), compression=hvd.Compression.int8, process_set=sub))
res["refuse_op"] = refusal(lambda: hvd.DistributedOptimizer(
    sgd(), compression=hvd.Compression.int8, op=hvd.Max))
res["refuse_predivide"] = refusal(lambda: hvd.DistributedOptimizer(
    sgd(), compression=hvd.Compression.int8, gradient_predivide_factor=2.0))
res["refuse_adasum"] = refusal(lambda: hvd.DistributedOptimizer(
    sgd(), compression=hvd.Compression.int8, op=hvd.Adasum))
res["refuse_sharded"] = refusal(lambda: hvd.DistributedOptimizer(
    sgd(), compression=hvd.Compression.int8, zero_stage=1))
res["refuse_ag_stage0"] = refusal(lambda: hvd.DistributedOptimizer(
    sgd(), allgather_wire="int8"))
res["refuse_ef_exact"] = refusal(lambda: DP.allreduce_gradients(
    [x], error_feedback_state=[e]))
res["refuse_rs_shape"] = refusal(lambda: Q.quantized_reducescatter_shard(
    x[:n * 10 + 1]))
os.environ["HOROVOD_WIRE_POLICY"] = "auto"
res["refuse_policy_op"] = refusal(lambda: hvd.DistributedOptimizer(
    sgd(), op=hvd.Min))
res["refuse_policy_predivide"] = refusal(lambda: hvd.DistributedOptimizer(
    sgd(), gradient_predivide_factor=2.0))
# A policy that picks no cooperative wire keeps the prescaled allreduce.
os.environ["HOROVOD_WIRE_POLICY"] = "big=bf16,small=none"
res["policy_cast_predivide"] = refusal(lambda: hvd.DistributedOptimizer(
    sgd(), gradient_predivide_factor=2.0))
del os.environ["HOROVOD_WIRE_POLICY"]

if n == 2:
    # One ResNet-18 step under int8 against the exact one: the reduced
    # gradients (the optimizer's lr is 0, so every step starts from the
    # same parameters).
    from horovod_tpu_torch.models import zoo_build
    rng = np.random.RandomState(30 + r)
    xr = torch.from_numpy(rng.rand(2, 3, 32, 32).astype(np.float32))
    yr = torch.from_numpy(rng.randint(0, 10, 2))
    got = {}
    for name, comp in (("exact", hvd.Compression.none),
                       ("int8", hvd.Compression.int8)):
        # A model of its own for each optimizer (same seed, same
        # weights): the hooks stay on the parameters.
        model = zoo_build("resnet18", 10, compute_dtype=None, seed=0)
        model.train()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.0), compression=comp)
        hooked = []
        for p in model.parameters():
            p.register_post_accumulate_grad_hook(
                lambda p: hooked.append((p, p.grad.clone())))
        F.cross_entropy(model(xr), yr).backward()
        # In the order the backward made them final: the bucket's order.
        local = torch.cat([g.reshape(-1) for _, g in hooked])
        opt.step()
        got[name] = torch.cat([p.grad.reshape(-1) for p, _ in hooked])
        got[name + "_ring"] = opt.ring_buckets
    res["resnet"] = got
    res["resnet_local"] = local
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


def run_world(tmp_path, n: int, timeout: float = 400):
    url = f"file://{tmp_path}/rendezvous"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    for k in list(env):
        if k.startswith("HOROVOD_"):
            env.pop(k)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(tmp_path), str(n), str(r), url],
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


@pytest.fixture(scope="module", params=[2, 4], ids=["np2", "np4"])
def world(request, tmp_path_factory):
    n = request.param
    return n, run_world(tmp_path_factory.mktemp(f"q{n}"), n)


def x_of(rank, seed=200, size=L):
    rng = np.random.RandomState(seed + rank)
    scale = rng.choice([1e-3, 1.0, 30.0], size)
    return torch.from_numpy((rng.randn(size) * scale).astype(np.float32))


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("q",))


def _close_to_jax(got: np.ndarray, want: np.ndarray, bound: np.ndarray,
                  scale: float) -> None:
    """Within JAX_ATOL of the largest value, or, where a last-bit
    difference tipped a quantizer's rounding, within one step of every
    encode the element went through (twice the model's `bound`, the sum
    of their half steps)."""
    d = np.abs(got.astype(np.float64) - want)
    tipped = d > JAX_ATOL * scale
    assert np.all(d <= JAX_ATOL * scale + 2 * bound), d.max()
    # A tipped rounding is rare: a last-bit difference at a boundary.
    assert tipped.mean() <= 0.02, tipped.mean()


# ---------------------------------------------------------------------------
# The ring collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", WIRES + ["bf16"])
def test_allreduce_is_bitwise_the_model_and_within_its_bound(world, wire):
    n, res = world
    xs = [x_of(r) for r in range(n)]
    es = [x_of(r, 500) * 1e-2 for r in range(n)]
    outs, _, bound = TQ.allreduce_model(xs, average=True, wire=wire)
    exact = torch.stack(xs).double().mean(0)
    for d in res:
        got = d["ar_avg", wire]
        assert torch.equal(got, outs[0])
        assert torch.all((got - exact).abs() <= bound + 1e-6 * exact.abs()
                         .max())
    outs, resid, _ = TQ.allreduce_model(xs, wire=wire, error_feedback=es)
    for r, d in enumerate(res):
        got, new = d["ar_sum_ef", wire]
        assert torch.equal(got, outs[r]) and torch.equal(new, resid[r])


@pytest.mark.parametrize("wire", WIRES)
def test_allreduce_within_tolerance_of_jax(world, wire):
    n, res = world
    xs = [x_of(r) for r in range(n)]
    stacked = jnp.asarray(np.stack([x.numpy() for x in xs]))
    want = np.asarray(JQ.quantized_allreduce(stacked, _mesh(n),
                                             average=True, wire=wire))
    _, _, bound = TQ.allreduce_model(xs, average=True, wire=wire)
    scale = float(torch.stack(xs).mean(0).abs().max())
    for r, d in enumerate(res):
        _close_to_jax(d["ar_avg", wire].numpy(), want[r].astype(np.float64),
                      bound.numpy(), scale)


@pytest.mark.parametrize("wire", WIRES + ["bf16"])
def test_error_feedback_identity_of_the_ring(world, wire):
    """Sender-side error feedback: n·out = Σ (g + e) − Σ e_new, the
    dropped bits all kept by their senders (at the JAX test's tolerance,
    tests/test_quantized.py:191)."""
    n, res = world
    xs = [x_of(r) for r in range(n)]
    es = [x_of(r, 500) * 1e-2 for r in range(n)]
    out = res[0]["ar_sum_ef", wire][0].double()
    rhs = sum(x.double() + e.double() for x, e in zip(xs, es)) - sum(
        d["ar_sum_ef", wire][1].double() for d in res)
    np.testing.assert_allclose(out.numpy(), rhs.numpy(), atol=2e-3,
                               rtol=1e-5)


@pytest.mark.parametrize("wire", WIRES + ["bf16"])
def test_reducescatter_is_bitwise_the_model(world, wire):
    n, res = world
    seg = (L // n) * n
    xs = [x_of(r)[:seg] for r in range(n)]
    es = [(x_of(r, 500) * 1e-2)[:seg] for r in range(n)]
    outs, resid, bound = TQ.reducescatter_model(
        xs, average=True, wire=wire, error_feedback=es)
    exact = (torch.stack(xs).double() + torch.stack(es).double()).mean(0)
    per = seg // n
    for r, d in enumerate(res):
        got, new = d["rs", wire]
        assert torch.equal(got, outs[r]) and torch.equal(new, resid[r])
        sl = slice(r * per, (r + 1) * per)
        assert torch.all((got - exact[sl]).abs() <= bound[sl] + 1e-6 *
                         exact.abs().max())
    # Sender-side EF over the scatter: Σ_r residual + n·segment = Σ input.
    total = sum(d["rs", wire][1].double() for d in res)
    lhs = torch.cat([d["rs", wire][0].double() * n for d in res]) + total
    rhs = sum(x.double() + e.double() for x, e in zip(xs, es))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=2e-3,
                               rtol=1e-5)


@pytest.mark.parametrize("wire", WIRES)
def test_reducescatter_within_tolerance_of_jax(world, wire):
    n, res = world
    seg = (L // n) * n
    xs = np.stack([x_of(r)[:seg].numpy() for r in range(n)])
    es = np.stack([(x_of(r, 500) * 1e-2)[:seg].numpy() for r in range(n)])
    fn = jax.jit(shard_map(
        lambda v, e: tuple(t[None] for t in JQ.quantized_reducescatter_shard(
            v[0], "q", average=True, wire=wire, error_feedback=e[0])),
        mesh=_mesh(n), in_specs=(P("q"), P("q")),
        out_specs=(P("q"), P("q")), check_vma=False))
    want, want_ef = (np.asarray(t) for t in fn(jnp.asarray(xs),
                                               jnp.asarray(es)))
    _, _, bound = TQ.reducescatter_model(
        [torch.from_numpy(x) for x in xs], average=True, wire=wire,
        error_feedback=[torch.from_numpy(e) for e in es])
    per = seg // n
    scale = float(np.abs((xs + es).mean(0)).max())
    for r, d in enumerate(res):
        sl = slice(r * per, (r + 1) * per)
        _close_to_jax(d["rs", wire][0].numpy(), want[r].astype(np.float64),
                      bound[sl].numpy(), scale)
        # Each residual is an encode error: within a step of the JAX one.
        assert np.all(np.abs(d["rs", wire][1].numpy() - want_ef[r]) <=
                      JAX_ATOL * scale + 2 * n * bound.max().item())


@pytest.mark.parametrize("wire", WIRES + ["bf16"])
def test_allgather_is_bitwise_the_model_and_jax(world, wire):
    n, res = world
    xs = [x_of(r)[:AG] for r in range(n)]
    want = TQ.allgather_model(xs, wire)
    fn = jax.jit(shard_map(
        lambda v: JQ.quantized_allgather_shard(v[0], "q", wire=wire)[None],
        mesh=_mesh(n), in_specs=P("q"), out_specs=P("q"), check_vma=False))
    jax_out = np.asarray(fn(jnp.asarray(np.stack([x.numpy() for x in xs]))))
    # One encode per element: within half a step of each value; XLA's
    # fused encode can round a scale or a quotient apart by an ulp.
    half = torch.cat([TQ._half_step(TW.get_codec(wire), torch.cat(
        [x, x.new_zeros((-AG) % 128)]))[:AG] for x in xs]).numpy()
    for r, d in enumerate(res):
        assert torch.equal(d["ag", wire], want)
        _close_to_jax(d["ag", wire].numpy(), jax_out[r].astype(np.float64),
                      half, float(torch.stack(xs).abs().max()))


@pytest.mark.parametrize("wire", WIRES + ["bf16"])
def test_pipelined_ring_and_gather(world, wire):
    """`pipelined_allreduce_shard` agrees with the unchunked ring to the
    wire's tolerance (one step per lossy encode: the chunks move the
    ring's block boundaries); `pipelined_allgather_shard(wire=)` is
    bitwise the unchunked gather (block-aligned chunks)."""
    n, res = world
    bigs = [x_of(r, 700, 5000) for r in range(n)]
    whole, _, bound = TQ.allreduce_model(bigs, average=True, wire=wire)
    pieces, bounds = [], []
    for off in range(0, 5000, 1024):  # 4096-byte chunks of f32
        o, _, b = TQ.allreduce_model([x[off:off + 1024] for x in bigs],
                                     average=True, wire=wire)
        pieces.append(o[0])
        bounds.append(b)
    chunked = torch.cat(pieces)
    slack = 1e-6 * float(torch.stack(bigs).abs().max())
    assert torch.all((chunked - whole[0]).abs()
                     <= torch.cat(bounds) + bound + 2 * slack)
    for d in res:
        got_chunked, got_whole = d["par", wire]
        assert torch.equal(got_chunked, chunked)
        assert torch.equal(got_whole, whole[0])
        a, b = d["pag", wire]
        if TW.get_codec(wire).cooperative:
            assert torch.equal(a, b)
        else:  # a cast wire's cast is the caller's: the bytes as given
            assert torch.equal(a, torch.cat(bigs))


def test_ring_keeps_shape_and_dtype(world):
    n, res = world
    xs = [x_of(r)[:330].reshape(10, 33).bfloat16() for r in range(n)]
    outs, _, _ = TQ.allreduce_model(xs, wire="int8")
    for d in res:
        assert d["ar_2d"].dtype == torch.bfloat16
        assert d["ar_2d"].shape == (10, 33)
        assert torch.equal(d["ar_2d"], outs[0])


def test_ring_over_a_subset(world):
    n, res = world
    outs, _, _ = TQ.allreduce_model([x_of(r) for r in range(1, n)],
                                    average=True)
    assert "tail_ring" not in res[0]
    for d in res[1:]:
        assert torch.equal(d["tail_ring"], outs[0])


def test_one_rank_set_exchanges_nothing(world):
    _, res = world
    x, e = x_of(0), x_of(0, 500) * 1e-2
    out, new = res[0]["one_rank"]
    assert torch.equal(out, x + e) and not new.any()
    assert torch.equal(res[0]["one_rank_ag"],
                       TW.local_roundtrip(x[:AG], "int8"))


# ---------------------------------------------------------------------------
# allreduce_gradients
# ---------------------------------------------------------------------------

def test_error_feedback_telescopes_across_steps(world):
    """The JAX test's identity (tests/test_quantized.py:191), step by
    step: n·out_t = Σ g + Σ e_t − Σ e_{t+1}."""
    n, res = world
    gs = [x_of(r, 900, 256) for r in range(n)]
    total = sum(g.double() for g in gs)
    for t in range(3):
        out = res[0]["ef_steps"][t][0].double()
        before = sum(d["ef_steps"][t][1].double() for d in res)
        after = sum(d["ef_steps"][t][2].double() for d in res)
        np.testing.assert_allclose((n * out).numpy(),
                                   (total + before - after).numpy(),
                                   atol=2e-3, rtol=1e-5)
    assert all(not d["ef_steps"][0][1].any() for d in res)


def test_integer_leaves_take_their_own_exact_bucket(world):
    n, res = world
    leaves = [jnp.zeros((700,)), jnp.zeros((5,), jnp.int32),
              jnp.zeros((90,), jnp.bfloat16)]
    want = JD.gradient_bucket_partition(leaves, compression=JComp.int8)
    for r, d in enumerate(res):
        # Integer leaf first, then the floats in the default (reverse)
        # order.
        assert d["mixed_parts"] == want == [[1], [2, 0]]
        assert torch.equal(d["mixed"]["i"],
                           sum(torch.arange(5) * (k + 1) for k in range(n)))
        assert d["mixed"]["b"].dtype == torch.bfloat16
        a = [x_of(k, 40, 700) for k in range(n)]
        b = [x_of(k, 41, 90).bfloat16() for k in range(n)]
        flat = [torch.cat([bi.float(), ai]) for ai, bi in zip(a, b)]
        outs, _, _ = TQ.allreduce_model(flat, wire="int8")
        assert torch.equal(d["mixed"]["b"], outs[0][:90].bfloat16())
        assert torch.equal(d["mixed"]["a"], outs[0][90:])


# ---------------------------------------------------------------------------
# The hook optimizer
# ---------------------------------------------------------------------------

def _order_leaves(order):
    return [jnp.zeros(s, getattr(jnp, d.split(".")[1])) for s, d in order]


@pytest.mark.parametrize("case", ["hook_int8", "hook_policy", "hook_unset"])
def test_hook_buckets_are_the_jax_partition_and_plan(world, monkeypatch,
                                                     case):
    n, res = world
    for d in res:
        h = d[case]
        leaves = _order_leaves(h["order"])
        raws = [j.size * j.dtype.itemsize for j in leaves]
        if case == "hook_policy":
            monkeypatch.setenv("HOROVOD_WIRE_POLICY",
                               "big=int4,small=bf16,threshold=5000")
            plan = JD.wire_policy_plan(leaves, fusion_threshold_bytes=6000,
                                       bucket_order="forward")
            want = [(w, raw, wb) for _, w, raw, wb in plan]
            assert h["ring"] == sum(w == "int4" for w, _, _ in want)
        else:
            comp = JComp.int8 if case == "hook_int8" else JComp.none
            parts = JD.gradient_bucket_partition(
                leaves, compression=comp, fusion_threshold_bytes=6000,
                bucket_order="forward")
            wire = "int8" if case == "hook_int8" else "none"
            want = [(wire, sum(raws[i] for i in b),
                     TW.get_codec(wire).wire_nbytes(
                         sum(leaves[i].size for i in b))
                     if wire == "int8" else sum(raws[i] for i in b))
                    for b in parts]
            assert h["ring"] == (len(parts) if wire == "int8" else 0)
        assert [tuple(b) for b in h["buckets"]] == want
        assert h["flushes"] == len(want)
    # The cooperative rule moves the partition here (bf16 leaves count 4
    # bytes an element), so the int8 case is not the exact one's.
    assert len(res[0]["hook_int8"]["buckets"]) != len(
        res[0]["hook_unset"]["buckets"])


def test_fused_pipeline_leaves_the_hook_ring_whole(world):
    """HOROVOD_FUSED_COLLECTIVES=1 does not chunk the hook optimizer's
    ring (the port's hops block, so chunks could not overlap): the
    reduced gradients are bitwise the unfused run's, bucket for bucket."""
    _, res = world
    for d in res:
        fused, whole = d["hook_int8_fused"], d["hook_int8"]
        assert fused["buckets"] == whole["buckets"]
        assert fused["ring"] == whole["ring"] == len(whole["buckets"])
        for a, b in zip(fused["grads"], whole["grads"]):
            assert torch.equal(a, b)


def test_policy_without_a_ring_wire_takes_predivide(world):
    _, res = world
    assert all(d["policy_cast_predivide"] is None for d in res)


def test_exact_policy_is_bitwise_the_unset_policy(world):
    _, res = world
    for d in res:
        for a, b in zip(d["hook_exact"]["grads"], d["hook_unset"]["grads"]):
            assert torch.equal(a, b)
        assert d["hook_exact"]["buckets"] == d["hook_unset"]["buckets"]
        assert d["hook_exact"]["ring"] == 0


def test_hook_gradients_equal_across_ranks(world):
    _, res = world
    for case in ("hook_int8", "hook_policy", "hook_unset"):
        for a, b in zip(res[0][case]["grads"], res[-1][case]["grads"]):
            assert torch.equal(a, b), case


def test_resnet_step_under_int8_is_the_ring_of_the_exact_step(world):
    n, res = world
    if n != 2:
        pytest.skip("the ResNet step runs in the two-rank world")
    locals_ = [d["resnet_local"] for d in res]
    outs, _, bound = TQ.allreduce_model(locals_, average=True, wire="int8")
    exact = torch.stack(locals_).double().mean(0)
    for d in res:
        got = d["resnet"]
        assert got["int8_ring"] >= 1 and got["exact_ring"] == 0
        np.testing.assert_allclose(got["exact"].numpy(), exact.numpy(),
                                   rtol=1e-6, atol=1e-7)
        # One bucket (46.8 MB < 64 MiB), in hook order: the ring model
        # bitwise, and within its bound of the exact mean.
        assert got["int8_ring"] == 1
        assert torch.equal(got["int8"], outs[0])
        diff = (got["int8"] - got["exact"]).abs()
        assert torch.all(diff <= bound + 1e-6 * exact.abs().max())
        assert float(diff.max()) > 0


# ---------------------------------------------------------------------------
# The ZeRO paths
# ---------------------------------------------------------------------------

def test_sharded_error_feedback_rows_telescope_and_reset(world):
    n, res = world
    assert res[0]["zero_codecs"].count("int8") >= 1
    calls = [d["zero_calls"] for d in res]
    k = len(calls[0])
    assert k >= 4 and all(len(c) == k for c in calls)
    for j in range(k):
        flats = [c[j][0].double() for c in calls]
        ef_in = [c[j][1].double() for c in calls]
        ef_out = [c[j][3].double() for c in calls]
        shards = torch.cat([c[j][2].double() for c in calls])
        # n·mean segment + Σ new residual = Σ (gradient + old residual).
        np.testing.assert_allclose(
            (n * shards + sum(ef_out)).numpy(),
            (sum(flats) + sum(ef_in)).numpy(), atol=2e-3, rtol=1e-5)
    per_step = k // 4
    reset = res[0]["zero_reset_at"]
    assert reset == 2 * per_step
    for c in calls:
        # Carried before the reset, zeroed by it, carried again after.
        assert c[per_step][1].abs().max() > 0
        assert not c[reset][1].any()
        assert c[reset + per_step][1].abs().max() > 0
        for j in range(per_step, reset):
            assert torch.equal(c[j][1], c[j - per_step][3])


def test_allgather_wire_keeps_the_f32_masters(world):
    n, res = world
    for t in range(3):
        params = [d["ag_wire"][t][0] for d in res]
        for p in params[1:]:
            assert all(torch.equal(a, b) for a, b in zip(params[0], p))
        for d in res:
            assert d["ag_wire"][t][2] > 0  # master != decoded parameter
            assert all(s.dtype == torch.float32 for s in d["ag_wire"][t][1])


def test_zero3_int8_gather_is_bitwise_across_ranks(world):
    n, res = world
    rows = [d["z3_rows"] for d in res]
    assert len(rows[0]) == 1  # one shard group
    want = TQ.allgather_model([r[0].reshape(-1) for r in rows], "int8")
    metas = [torch.empty(s, device="meta") for s in ((256, 64), (100,),
                                                     (8, 33))]
    (idxs,) = TD.shard_group_partition(metas, fusion_threshold_bytes=1 << 20)
    for d in res:
        got = torch.cat([d["z3_gather"][i].reshape(-1) for i in idxs])
        assert torch.equal(got, want[:got.numel()])
        for a, c in zip(d["z3_gather"], d["z3_gather_fused"]):
            assert torch.equal(a, c)
    # The gathered head is the decode of every rank's row, the owner's
    # included, and gather_matmul multiplies that decoded weight.
    hrows = [d["z3_head_rows"].reshape(-1) for d in res]
    w = TQ.allgather_model(hrows, "int8").reshape(256, 64)
    orig = x_of(0, 60, 256 * 64).reshape(256, 64)
    assert not torch.equal(w, orig)
    for r, d in enumerate(res):
        xe = x_of(r, 80, 4 * 64).reshape(4, 64)
        np.testing.assert_allclose(d["z3_gm"].numpy(), (xe @ w.t()).numpy(),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("key,match", [
    ("refuse_op", "supports op=Average or Sum"),
    ("refuse_predivide", "gradient_predivide_factor"),
    ("refuse_adasum", "no Adasum form"),
    ("refuse_sharded", "has no reduce-scatter form"),
    ("refuse_ag_stage0", "allgather_wire requires"),
    ("refuse_ef_exact", "error_feedback_state only applies"),
    ("refuse_rs_shape", "divisible by the set size"),
    ("refuse_policy_op", "HOROVOD_WIRE_POLICY supports op=Average or Sum"),
    ("refuse_policy_predivide",
     "HOROVOD_WIRE_POLICY takes no gradient_predivide_factor"),
    ("refuse_subset", "does not support process_set subsets")])
def test_refusals_match_jax(world, key, match):
    n, res = world
    if key == "refuse_subset" and n == 2:
        pytest.skip("a proper subset that holds a rank needs n > 2")
    seen = [d[key] for d in res if key in d]
    assert seen and all(s is not None and match in s for s in seen)


# ---------------------------------------------------------------------------
# The transformer trainer on the wires, two CPU ranks
# ---------------------------------------------------------------------------

def _run_trainer(tmp, name, stage, env):
    """The small trainer at `stage` on two CPU ranks under `env`; each
    rank's STEP, EVAL and SUMMARY records."""
    import json

    args = [sys.executable, "-m", "horovod_tpu_torch.transformer_benchmark",
            "--device", "cpu", "--vocab-size", "256", "--d-model", "64",
            "--n-heads", "2", "--d-head", "32", "--d-ff", "128",
            "--n-layers", "2", "--seq-len", "256", "--num-warmup-batches",
            "0", "--num-batches-per-iter", "1", "--num-iters", "3",
            "--log-steps", "--eval-every", "3", "--check-plain-step", "2",
            "--zero-stage", str(stage)]
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("HOROVOD_")}
    base.update(PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1", HOROVOD_NUM_PROCESSES="2",
        HOROVOD_FUSED_COLLECTIVES="1", HOROVOD_FUSED_PALLAS="1",
        HOROVOD_FUSION_THRESHOLD="65536", HOROVOD_FUSED_CHUNK_BYTES="8192",
        **env)
    procs = [subprocess.Popen(
        args, cwd=REPO, env=dict(base, HOROVOD_PROCESS_ID=str(r),
                                 HOROVOD_COORDINATOR_ADDR=f"file://{tmp}/{name}"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out = []
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
        out.append({tag: [json.loads(l[len(tag) + 1:])
                          for l in log.splitlines()
                          if l.startswith(tag + " ")]
                    for tag in ("STEP", "EVAL", "SUMMARY")})
    return out


WIRED = {"HOROVOD_ZERO_GATHER_WIRE": "int8", "HOROVOD_WIRE_POLICY": "auto",
         "HOROVOD_WIRE_THRESHOLD": "16384"}


@pytest.fixture(scope="module")
def trainer_wires(tmp_path_factory):
    """Stage 3 on the exact wires, stage 3 with the int8 gather and the
    auto policy (groups of 16 KiB and more on the int8 reduce-scatter),
    stage 1 with the int8 parameter allgather."""
    tmp = tmp_path_factory.mktemp("trainer_wires")
    return {"exact3": _run_trainer(tmp, "e3", 3, {}),
            "wired3": _run_trainer(tmp, "w3", 3, WIRED),
            "wired1": _run_trainer(tmp, "w1", 1, {
                "HOROVOD_SHARD_AG_WIRE": "int8",
                "HOROVOD_WIRE_POLICY": "auto",
                "HOROVOD_WIRE_THRESHOLD": "16384"})}


def test_trainer_stage3_on_the_int8_gather(trainer_wires):
    """One digest a step across the ranks; losses within WIRE_LOSS_TOL
    of the exact wires' (chip_smoke.py states why); the eval head on the
    decoded weights equal to the plain head on them (the CPU runs K3's
    plain version, 8 calls), and within WIRE_LOGITS_RTOL of the exactly
    gathered head's logits."""
    import chip_smoke

    wired, exact = trainer_wires["wired3"], trainer_wires["exact3"]
    for a, b in zip(wired[0]["STEP"], wired[1]["STEP"]):
        assert a["digest"] == b["digest"]
    for r in range(2):
        for a, b in zip(wired[r]["STEP"], exact[r]["STEP"]):
            assert abs(a["loss"] - b["loss"]) <= chip_smoke.WIRE_LOSS_TOL
        assert wired[r]["STEP"][0]["digest"] != exact[r]["STEP"][0]["digest"]
        (ev,) = wired[r]["EVAL"]
        assert ev["k3_plain_calls"] == 8 and ev["eval_logits_rel"] == 0.0
        assert 0 < ev["eval_exact_rel"] <= chip_smoke.WIRE_LOGITS_RTOL
        assert "eval_exact_rel" not in exact[r]["EVAL"][0]


def test_trainer_stage1_keeps_the_masters_behind_the_int8_allgather(
        trainer_wires):
    wired = trainer_wires["wired1"]
    for a, b in zip(wired[0]["STEP"], wired[1]["STEP"]):
        assert a["digest"] == b["digest"]
    for r in range(2):
        diffs = [s["master_wire_diff"] for s in wired[r]["STEP"]]
        assert len(diffs) == 3 and all(0 < d < 1e-2 for d in diffs)
