"""Port parity: the eager collectives of `horovod_tpu_torch` in np=2 and
np=3 gloo worlds on the CPU, against the JAX package's math on the same
per-rank inputs.

Each world is one set of worker processes (a `file://` rendezvous under
the test's tmp dir: fixed ports would collide between test workers)
that runs every collective once and saves what each rank got; the tests
below compare those results.  Reductions are held against the JAX eager
path's own reduction (`collectives._reduce_in_graph`, with its prescale
and postscale casts), Adasum against `adasum_tree_reduce` on the
stacked per-rank buffers, fused by dtype as the JAX eager
`grouped_allreduce` fuses them.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import adasum as JA
from horovod_tpu.ops import collectives as JC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# What a launcher puts in the environment.  Another test of the same
# process may have left it there (horovod_tpu.ray's worker actor sets it
# in os.environ): `hvd.init()` in this process would then wait for a
# coordinator that is gone, and a world's ranks would read another local
# rank.
LAUNCHER_ENV = ("HOROVOD_COORDINATOR_ADDR", "HOROVOD_NUM_PROCESSES",
                "HOROVOD_PROCESS_ID", "HOROVOD_LOCAL_RANK",
                "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
                "HOROVOD_CROSS_SIZE", "HOROVOD_RENDEZVOUS_ADDR",
                "HOROVOD_RENDEZVOUS_PORT", "HOROVOD_SECRET_KEY")


@pytest.fixture(autouse=True)
def no_launcher_env(monkeypatch):
    """Every test starts without LAUNCHER_ENV (the port's test modules
    that start ranks or call `hvd.init()` import this fixture)."""
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)

# Inputs per rank r: the worker and the tests both build them from seeds.
WORKER = r'''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops.functions import allgather_object

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")

def inputs(r):
    rng = np.random.RandomState(100 + r)
    return {"x": torch.from_numpy(rng.randn(5, 3).astype(np.float32)),
            "i": torch.arange(6, dtype=torch.int64) * (r + 1) - 2,
            "g1": torch.from_numpy(rng.randn(4, 5).astype(np.float32)),
            "g2": torch.from_numpy(rng.randn(7).astype(np.float32)),
            "g3": torch.from_numpy(rng.randn(3, 8).astype(np.float32)).bfloat16(),
            "g4": torch.from_numpy(rng.randn(2, 2, 2).astype(np.float32)),
            "g5": torch.from_numpy(rng.randn(300).astype(np.float32)).bfloat16()}

d = inputs(r)
res = {"rank": hvd.rank(), "size": hvd.size(), "local_rank": hvd.local_rank(),
       "local_size": hvd.local_size(), "cross_size": hvd.cross_size(),
       "homogeneous": hvd.is_homogeneous(), "backend": hvd.backend()}
x_before = d["x"].clone()
for op in ("Average", "Sum", "Min", "Max", "Product"):
    res["x_" + op] = hvd.allreduce(d["x"], op=getattr(hvd, op))
    res["i_" + op] = hvd.allreduce(d["i"], op=getattr(hvd, op))
res["input_untouched"] = torch.equal(d["x"], x_before)
res["x_Sum_scaled"] = hvd.allreduce(d["x"], op=hvd.Sum, prescale_factor=0.5,
                                    postscale_factor=3.0)
res["x_Average_scaled"] = hvd.allreduce(d["x"], op=hvd.Average,
                                        prescale_factor=2.0,
                                        postscale_factor=0.25)
res["x_Adasum"] = hvd.allreduce(d["x"], op=hvd.Adasum)
res["x_Adasum_scaled"] = hvd.allreduce(d["x"], op=hvd.Adasum,
                                       prescale_factor=0.5,
                                       postscale_factor=2.0)
res["x_Adasum_f16"] = hvd.allreduce(d["x"].half(), op=hvd.Adasum)
group = [d[k] for k in ("g1", "g2", "g3", "g4", "g5")]
res["grouped_Adasum"] = hvd.grouped_allreduce(group, op=hvd.Adasum)
res["grouped_Average"] = hvd.grouped_allreduce(group, op=hvd.Average)
res["allgather_x"] = hvd.allgather(d["x"])
res["allgather_bf16"] = hvd.allgather(d["g3"])
res["allgather_scalar"] = hvd.allgather(torch.tensor(float(r)))
res["broadcast_x"] = hvd.broadcast(d["x"], root_rank=n - 1)
ii = d["i"].clone()
hvd.broadcast_(ii, root_rank=1)
res["broadcast_i_inplace"] = ii
h1 = hvd.allreduce_async(d["x"], op=hvd.Sum)
h2 = hvd.grouped_allreduce_async(group, op=hvd.Sum)
h3 = hvd.allgather_async(d["x"])
xx = d["x"].clone()
h4 = hvd.broadcast_async_(xx, root_rank=0)
h5 = hvd.broadcast_async(d["x"], root_rank=n - 1)
while not all(hvd.poll(h) for h in (h1, h2, h3, h4, h5)):
    pass
res["async_Sum"] = hvd.synchronize(h1)
res["async_grouped_Sum"] = hvd.synchronize(h2)
res["async_allgather"] = hvd.synchronize(h3)
res["async_broadcast_inplace"] = hvd.synchronize(h4) is xx and torch.equal(
    xx, inputs(0)["x"])
res["async_broadcast"] = hvd.synchronize(h5)
res["broadcast_object"] = hvd.broadcast_object({"from": r, "l": [r] * 3},
                                               root_rank=n - 1)
res["allgather_object"] = allgather_object(("rank", r, "x" * r))
hvd.barrier()
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


def _inputs(r):
    rng = np.random.RandomState(100 + r)
    f32 = np.float32
    x = rng.randn(5, 3).astype(f32)
    i = np.arange(6, dtype=np.int64) * (r + 1) - 2
    g1 = rng.randn(4, 5).astype(f32)
    g2 = rng.randn(7).astype(f32)
    g3 = np.asarray(jnp.asarray(rng.randn(3, 8).astype(f32), jnp.bfloat16)
                    .astype(jnp.float32))
    g4 = rng.randn(2, 2, 2).astype(f32)
    g5 = np.asarray(jnp.asarray(rng.randn(300).astype(f32), jnp.bfloat16)
                    .astype(jnp.float32))
    return {"x": x, "i": i, "g1": g1, "g2": g2, "g3": g3, "g4": g4,
            "g5": g5}


def run_world(tmp_path, n: int, source: str, timeout: float = 240):
    """Run `source` as n CPU ranks over gloo; return each rank's saved
    results."""
    url = f"file://{tmp_path}/rendezvous"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    for k in LAUNCHER_ENV:
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


@pytest.fixture(scope="module", params=[2, 3], ids=["np2", "np3"])
def world(request, tmp_path_factory):
    n = request.param
    return n, run_world(tmp_path_factory.mktemp(f"np{n}"), n, WORKER)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jax_reduce(xs, op, n, pre=1.0, post=1.0):
    """The JAX eager allreduce program's math (`_allreduce_program`)."""
    xs = jnp.asarray(xs)
    x = xs * jnp.asarray(pre, jnp.float32).astype(xs.dtype)
    out = JC._reduce_in_graph(x, getattr(JC, op), n)
    return np.asarray(out * jnp.asarray(post, jnp.float32).astype(out.dtype))


def test_basics(world):
    n, res = world
    for r, d in enumerate(res):
        assert (d["rank"], d["size"], d["local_rank"], d["local_size"]) == \
            (r, n, r, n)
        assert d["cross_size"] == 1 and d["homogeneous"]
        assert d["backend"] == "gloo"
        assert d["input_untouched"]


@pytest.mark.parametrize("op", ["Average", "Sum", "Min", "Max", "Product"])
@pytest.mark.parametrize("kind", ["x", "i"])
def test_allreduce_ops_match_jax(world, op, kind):
    n, res = world
    xs = np.stack([_inputs(r)[kind] for r in range(n)])
    if kind == "i":
        xs = xs.astype(np.int32)  # JAX runs without x64
    want = _jax_reduce(xs, op, n)
    for d in res:
        got = d[f"{kind}_{op}"]
        assert got.dtype == (torch.float32 if kind == "x" else torch.int64)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op,pre,post", [("Sum", 0.5, 3.0),
                                         ("Average", 2.0, 0.25)])
def test_prescale_postscale_match_jax(world, op, pre, post):
    n, res = world
    xs = np.stack([_inputs(r)["x"] for r in range(n)])
    want = _jax_reduce(xs, op, n, pre, post)
    for d in res:
        np.testing.assert_allclose(d[f"x_{op}_scaled"].numpy(), want,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scaled", [False, True])
def test_adasum_allreduce_matches_jax_tree(world, scaled):
    n, res = world
    xs = np.stack([_inputs(r)["x"] for r in range(n)])
    want = np.asarray(JA.adasum_tree_reduce(jnp.asarray(
        xs * (0.5 if scaled else 1.0))))
    if scaled:
        want = want * 2.0
    key = "x_Adasum_scaled" if scaled else "x_Adasum"
    for d in res:
        np.testing.assert_allclose(d[key].numpy(), want, rtol=1e-5,
                                   atol=1e-6)
    assert all(torch.equal(d[key], res[0][key]) for d in res)


def test_adasum_allreduce_f16_matches_jax_tree(world):
    """float16 (Compression.fp16's wire dtype): both trees sum at f32 and
    round each level's result to f16, so within two f16 ulps of the
    largest value."""
    n, res = world
    xs = jnp.asarray(np.stack([_inputs(r)["x"] for r in range(n)]),
                     jnp.float16)
    want = np.asarray(JA.adasum_tree_reduce(xs).astype(jnp.float32))
    for d in res:
        assert d["x_Adasum_f16"].dtype == torch.float16
        np.testing.assert_allclose(d["x_Adasum_f16"].float().numpy(), want,
                                   rtol=0,
                                   atol=2 ** -9 * np.abs(want).max())
    assert all(torch.equal(d["x_Adasum_f16"], res[0]["x_Adasum_f16"])
               for d in res)


def test_grouped_adasum_combines_the_dtype_fused_buffers(world):
    """One Adasum tree over each dtype's fused buffer (JAX eager
    grouped_allreduce), not one tree per tensor."""
    n, res = world
    names = ["g1", "g2", "g3", "g4", "g5"]
    per_rank = [_inputs(r) for r in range(n)]
    f32 = ["g1", "g2", "g4"]
    bf16 = ["g3", "g5"]
    want = {}
    for keys, dt in ((f32, jnp.float32), (bf16, jnp.bfloat16)):
        stack = jnp.asarray(np.stack([
            np.concatenate([p[k].ravel() for k in keys]) for p in per_rank]),
            dt)
        fused = np.asarray(JA.adasum_tree_reduce(stack).astype(jnp.float32))
        off = 0
        for k in keys:
            sz = per_rank[0][k].size
            want[k] = fused[off: off + sz].reshape(per_rank[0][k].shape)
            off += sz
    per_tensor = np.asarray(JA.adasum_tree_reduce(jnp.asarray(
        np.stack([p["g1"] for p in per_rank]))))
    for d in res:
        for k, got in zip(names, d["grouped_Adasum"]):
            tol = 1e-5 if k in f32 else 1e-2
            assert got.dtype == (torch.float32 if k in f32
                                 else torch.bfloat16)
            np.testing.assert_allclose(_np(got), want[k], rtol=tol,
                                       atol=tol)
        assert not np.allclose(_np(d["grouped_Adasum"][0]), per_tensor,
                               rtol=1e-3, atol=1e-3)


def test_grouped_average_matches_jax(world):
    """bf16 sums round at each add, in gloo's order and in XLA's: within
    two bf16 ulps of the inputs' scale (~1)."""
    n, res = world
    per_rank = [_inputs(r) for r in range(n)]
    for i, k in enumerate(["g1", "g2", "g3", "g4", "g5"]):
        dt = jnp.bfloat16 if k in ("g3", "g5") else jnp.float32
        want = np.asarray(JC._reduce_in_graph(jnp.asarray(
            np.stack([p[k] for p in per_rank]), dt), JC.Average, n)
            .astype(jnp.float32))
        tol = 2 ** -6 if dt == jnp.bfloat16 else 1e-6
        for d in res:
            np.testing.assert_allclose(_np(d["grouped_Average"][i]), want,
                                       rtol=tol, atol=tol)


def test_allgather(world):
    n, res = world
    per_rank = [_inputs(r) for r in range(n)]
    for d in res:
        np.testing.assert_array_equal(
            d["allgather_x"].numpy(),
            np.concatenate([p["x"] for p in per_rank]))
        np.testing.assert_array_equal(
            _np(d["allgather_bf16"]),
            np.concatenate([p["g3"] for p in per_rank]))
        assert d["allgather_bf16"].dtype == torch.bfloat16
        np.testing.assert_array_equal(d["allgather_scalar"].numpy(),
                                      np.arange(n, dtype=np.float32))


def test_broadcast(world):
    n, res = world
    for d in res:
        np.testing.assert_array_equal(d["broadcast_x"].numpy(),
                                      _inputs(n - 1)["x"])
        np.testing.assert_array_equal(d["broadcast_i_inplace"].numpy(),
                                      _inputs(1)["i"])


def test_async_handles(world):
    n, res = world
    per_rank = [_inputs(r) for r in range(n)]
    xs = np.stack([p["x"] for p in per_rank])
    for d in res:
        np.testing.assert_allclose(d["async_Sum"].numpy(),
                                   _jax_reduce(xs, "Sum", n), rtol=1e-6)
        np.testing.assert_allclose(
            d["async_grouped_Sum"][1].numpy(),
            _jax_reduce(np.stack([p["g2"] for p in per_rank]), "Sum", n),
            rtol=1e-6)
        np.testing.assert_array_equal(d["async_allgather"].numpy(),
                                      np.concatenate(xs))
        assert d["async_broadcast_inplace"]
        np.testing.assert_array_equal(d["async_broadcast"].numpy(),
                                      _inputs(n - 1)["x"])


def test_object_collectives(world):
    n, res = world
    for d in res:
        assert d["broadcast_object"] == {"from": n - 1, "l": [n - 1] * 3}
        assert d["allgather_object"] == [("rank", r, "x" * r)
                                         for r in range(n)]
