"""Port parity: `horovod_tpu_torch.ops.adasum` against the JAX package's
`adasum_tree_reduce` (with HOROVOD_ADASUM_PALLAS=1 in interpret mode,
and without) and against the f64 `adasum_reference` model.

Tolerance: f32 rtol 1e-5 / atol 1e-6 against JAX (the dot and norm sums
are f32 in another order), 1e-4 relative against the f64 model.

The XOR ladder (`adasum_in_axis`, the route of `allreduce(op=Adasum)`)
runs at n = 2, 3, 4 and 5 gloo ranks on the CPU: on every rank it is
bitwise `adasum_tree_reduce` of the gathered stack (the same pairs in
the same order; K1's plain per-row sums do not depend on how many rows
a call holds), in f32, bf16 and f16 and with a zero-norm rank, and in
f32 within 1e-5 of the largest value of the f64 `adasum_reference`.
On one rank, Adasum's allreduce returns a new tensor equal to its input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.ops import adasum as JA
from horovod_tpu_torch.ops import adasum as TA
from test_torch_port_collectives import no_launcher_env, run_world  # noqa: F401

LADDER_WORKER = r'''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import adasum as A

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
xs = torch.load(f"{out_dir}/inputs.pt", weights_only=False)
res = {}
for key, stack in xs.items():
    x = torch.from_numpy(stack[r])
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        res[(key, str(dt), "ladder")] = A.adasum_in_axis(x.to(dt))
        res[(key, str(dt), "stack")] = hvd.allgather(x.to(dt)[None])
    res[(key, "allreduce")] = hvd.allreduce(x, op=hvd.Adasum)
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


def _stack(n, shape=(4, 64), seed=0, zero_rank=None):
    xs = np.random.RandomState(seed).randn(n, *shape).astype(np.float32)
    if zero_rank is not None:
        xs[zero_rank] = 0.0
    return xs


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("pallas", [True, False])
def test_tree_reduce_matches_jax(monkeypatch, n, pallas):
    if pallas:
        monkeypatch.setenv("HOROVOD_ADASUM_PALLAS", "1")
        monkeypatch.setenv("HOROVOD_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("HOROVOD_ADASUM_PALLAS", raising=False)
    xs = _stack(n, seed=n)
    want = np.asarray(JA.adasum_tree_reduce(jnp.asarray(xs)))
    got = TA.adasum_tree_reduce(torch.from_numpy(xs))
    assert got.shape == xs.shape[1:] and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_tree_reduce_matches_f64_reference(n):
    xs = _stack(n, shape=(300,), seed=10 + n)
    want = JA.adasum_reference(list(xs))
    np.testing.assert_allclose(TA.adasum_reference(list(xs)), want,
                               rtol=0, atol=0)
    got = TA.adasum_tree_reduce(torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,zero_rank", [(2, 0), (2, 1), (3, 2), (4, 1)])
def test_zero_norm_guard(n, zero_rank):
    """A zero gradient has no direction: its side's coefficient is 1, so
    the pair combines to the other side unchanged."""
    xs = _stack(n, shape=(128,), seed=20, zero_rank=zero_rank)
    want = JA.adasum_reference(list(xs))
    got = TA.adasum_tree_reduce(torch.from_numpy(xs)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(JA.adasum_tree_reduce(jnp.asarray(xs))),
        rtol=1e-5, atol=1e-6)


def test_all_zero_pair_stays_zero():
    xs = np.zeros((2, 50), np.float32)
    got = TA.adasum_tree_reduce(torch.from_numpy(xs))
    assert torch.equal(got, torch.zeros(50))


def test_pair_combine_is_symmetric_and_exact_for_orthogonal():
    """Orthogonal gradients add; identical ones average."""
    a = torch.tensor([1.0, 0.0, 0.0])
    b = torch.tensor([0.0, 2.0, 0.0])
    torch.testing.assert_close(TA._pair_combine(a, b), a + b)
    torch.testing.assert_close(TA._pair_combine(a, a), a)
    torch.testing.assert_close(TA._pair_combine(a, b), TA._pair_combine(b, a))


@pytest.mark.parametrize("n", [2, 4])
def test_bf16_tree_matches_jax(n):
    xs = jnp.asarray(_stack(n, seed=30 + n), jnp.bfloat16)
    want = np.asarray(JA.adasum_tree_reduce(xs).astype(jnp.float32))
    got = TA.adasum_tree_reduce(
        torch.from_numpy(np.array(xs.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("n", [2, 4])
def test_f16_tree_matches_jax(n):
    """float16 is what Compression.fp16 puts on the wire; both trees sum
    at f32 and round each level's result once to f16."""
    xs = jnp.asarray(_stack(n, seed=50 + n), jnp.float16)
    want = np.asarray(JA.adasum_tree_reduce(xs).astype(jnp.float32))
    got = TA.adasum_tree_reduce(
        torch.from_numpy(np.array(xs.astype(jnp.float32))).half())
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("n", [2, 3])
def test_plain_flag_matches_kernel_path_on_cpu(n):
    xs = torch.from_numpy(_stack(n, seed=40))
    assert torch.equal(TA.adasum_tree_reduce(xs),
                       TA.adasum_tree_reduce(xs, plain=True))


@pytest.fixture(scope="module", params=[2, 3, 4, 5], ids=lambda n: f"np{n}")
def ladder_world(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"ladder{n}")
    xs = {"dense": _stack(n, (3, 50), seed=n),
          "zero": _stack(n, (130,), seed=10 + n, zero_rank=n - 1)}
    torch.save(xs, tmp / "inputs.pt")
    return n, xs, run_world(tmp, n, LADDER_WORKER)


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16",
                                   "torch.float16"])
@pytest.mark.parametrize("key", ["dense", "zero"])
def test_ladder_is_bitwise_the_tree_on_the_gathered_stack(ladder_world, key,
                                                          dtype):
    n, _, res = ladder_world
    want = TA.adasum_tree_reduce(res[0][(key, dtype, "stack")])
    for d in res:
        assert torch.equal(d[(key, dtype, "stack")],
                           res[0][(key, dtype, "stack")])
        assert d[(key, dtype, "ladder")].dtype == want.dtype
        assert torch.equal(d[(key, dtype, "ladder")], want), n


@pytest.mark.parametrize("key", ["dense", "zero"])
def test_ladder_matches_f64_reference(ladder_world, key):
    n, xs, res = ladder_world
    want = TA.adasum_reference(list(xs[key]))
    for d in res:
        for got in (d[(key, "torch.float32", "ladder")],
                    d[(key, "allreduce")]):
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        assert torch.equal(d[(key, "allreduce")],
                           d[(key, "torch.float32", "ladder")])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_rank_allreduce_returns_a_new_tensor(dtype):
    """On a set of one rank the ladder has no level: Adasum's allreduce
    returns a copy equal to its input, not the input's storage."""
    hvd.init(device="cpu")
    try:
        x = torch.randn(4, 33, generator=torch.Generator().manual_seed(0)
                        ).to(dtype)
        out = hvd.allreduce(x, op=hvd.Adasum)
        assert torch.equal(out, x) and out.dtype == dtype
        assert out.data_ptr() != x.data_ptr()
        out.add_(1)
        assert not torch.equal(out, x)
    finally:
        hvd.shutdown()
