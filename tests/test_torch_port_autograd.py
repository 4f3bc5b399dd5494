"""Port parity: the differentiable collectives of the torch surface in
np=2 and np=3 gloo worlds on the CPU.

Rank r feeds its own input x_r through each collective and backpropagates
its own output weights w_r (loss_r = Σ w_r · y_r).  Each rank's gradient
is held against the JAX shim's rule (`horovod_tpu/torch/__init__.py`
`_AllreduceFn` ... `_GroupedAllreduceFn`), computed with the JAX
package's eager collectives on the same per-rank weights through a
process set of the same ranks: allreduce the gradient with the same op
(and, as upstream does, the same scale factors); allgather: sum, then
this rank's rows (ragged included); broadcast: the sum on the root, zero
elsewhere; reducescatter: allgather, divided by n for Average; alltoall:
back with the received splits; grouped allreduce: the grouped allreduce.
Bitwise where the rule moves bytes, within 1e-6 of the largest value
where it sums.

`gradcheck` in f64 at np=2: rank 0 checks each collective of its input;
rank 1 runs the same gradcheck in step over a fixed contribution
(x · 0 + c) whose output it zeroes, so that its perturbations and its
gradients leave rank 0's function alone.
"""

import numpy as np
import pytest

import horovod_tpu as jhvd
from horovod_tpu.ops import collectives as JC

from test_torch_port_collectives import run_world

F32 = np.float32


def _inputs(r, n):
    rng = np.random.RandomState(400 + r)
    splits = [(r + k) % 3 for k in range(n)]
    return {
        "x": rng.randn(4, 3).astype(F32), "wx": rng.randn(4, 3).astype(F32),
        "rag": rng.randn(r + 1, 2).astype(F32),
        "wrag": rng.randn(n * (n + 1) // 2, 2).astype(F32),
        "rs": rng.randn(2 * n + 1, 2).astype(F32),
        "a2a": rng.randn(sum(splits), 2).astype(F32),
        "splits": np.asarray(splits, np.int32),
        "g1": rng.randn(3).astype(F32), "g2": rng.randn(2, 2).astype(F32),
        "w1": rng.randn(3).astype(F32), "w2": rng.randn(2, 2).astype(F32),
    }


WORKER = r'''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
d = {k: torch.from_numpy(v) for k, v in np.load(f"{out_dir}/inputs{r}.npz").items()}
res = {}

def grad_of(fn, x, w):
    x = x.clone().requires_grad_()
    y = fn(x)
    y = y[0] if isinstance(y, tuple) else y
    (y * w).sum().backward()
    return x.grad

for op in ("Sum", "Average", "Max"):
    res["ar_" + op] = grad_of(lambda x: hvd.allreduce(x, op=getattr(hvd, op)),
                              d["x"], d["wx"])
res["ar_scaled"] = grad_of(lambda x: hvd.allreduce(
    x, op=hvd.Average, prescale_factor=0.5, postscale_factor=4.0),
    d["x"], d["wx"])
res["ag"] = grad_of(hvd.allgather, d["rag"], d["wrag"])
res["ag_scalar"] = grad_of(hvd.allgather, torch.tensor(float(r)),
                           torch.arange(n, dtype=torch.float32))
res["bc"] = grad_of(lambda x: hvd.broadcast(x, root_rank=n - 1), d["x"], d["wx"])
out = hvd.reducescatter(d["rs"])
for op in ("Sum", "Average"):
    w = torch.from_numpy(np.load(f"{out_dir}/rsw{r}.npz")["w"])
    res["rs_" + op] = grad_of(lambda x: hvd.reducescatter(x, op=getattr(hvd, op)),
                              d["rs"], w)
a2a_out, rsplits = hvd.alltoall(d["a2a"], splits=d["splits"])
res["a2a_rsplits"] = rsplits
wa = torch.from_numpy(np.load(f"{out_dir}/a2aw{r}.npz")["w"])
res["a2a"] = grad_of(lambda x: hvd.alltoall(x, splits=d["splits"]), d["a2a"], wa)
res["a2a_even"] = grad_of(hvd.alltoall, d["x"][:n], d["wx"][:n])
g1 = d["g1"].clone().requires_grad_()
g2 = d["g2"].clone().requires_grad_()
o1, o2 = hvd.grouped_allreduce([g1, g2], op=hvd.Average)
((o1 * d["w1"]).sum() + (o2 * d["w2"]).sum()).backward()
res["grouped"] = [g1.grad, g2.grad]
res["no_grad"] = hvd.allreduce(d["x"]).requires_grad

torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


GRADCHECK = r'''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
live = r == 0
checks = {
    "allreduce": lambda x: hvd.allreduce(x, op=hvd.Sum),
    "allreduce_average": lambda x: hvd.allreduce(x, op=hvd.Average),
    "allreduce_sum_scaled": lambda x: hvd.allreduce(
        x, op=hvd.Sum, prescale_factor=0.5, postscale_factor=3.0),
    "allgather": hvd.allgather,
    "broadcast": lambda x: hvd.broadcast(x, root_rank=0),
    "reducescatter": lambda x: hvd.reducescatter(x, op=hvd.Sum),
    "reducescatter_average": lambda x: hvd.reducescatter(x, op=hvd.Average),
    "alltoall": hvd.alltoall,
    # Rank 0 sends 3 rows to itself and 1 to rank 1; rank 1 the other
    # way round: 4 rows arrive on each.
    "alltoall_splits": lambda x: hvd.alltoall(
        x, splits=[3, 1] if live else [1, 3])[0],
    "grouped_allreduce": lambda x: hvd.grouped_allreduce(
        [x, x * 2], op=hvd.Sum)[1],
}
res = {}
for name, fn in checks.items():
    x = torch.from_numpy(np.random.RandomState(9).randn(4, 3)).requires_grad_()
    c = torch.from_numpy(np.random.RandomState(10).randn(4, 3))
    f = fn if live else (lambda x, fn=fn: fn(x * 0 + c) * 0)
    # Average divides at f32 (the JAX package's cast), so its forward
    # moves in steps of ~6e-8: a wider difference step and atol.
    coarse = name.endswith("average")
    res[name] = torch.autograd.gradcheck(
        f, (x,), eps=1e-3 if coarse else 1e-6,
        atol=1e-4 if coarse else 1e-7, rtol=1e-6)
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


def _rs_rows(n, r):
    d0 = 2 * n + 1
    c = -(-d0 // n)
    return max(0, min(d0 - r * c, c))


def _a2a_recv(n, r):
    return sum(_inputs(s, n)["splits"][r] for s in range(n))


@pytest.fixture(scope="module", params=[2, 3], ids=["np2", "np3"])
def world(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"autograd_np{n}")
    for r in range(n):
        np.savez(tmp / f"inputs{r}.npz", **_inputs(r, n))
        rng = np.random.RandomState(500 + r)
        np.savez(tmp / f"rsw{r}.npz",
                 w=rng.randn(_rs_rows(n, r), 2).astype(F32))
        np.savez(tmp / f"a2aw{r}.npz",
                 w=rng.randn(_a2a_recv(n, r), 2).astype(F32))
    return n, tmp, run_world(tmp, n, WORKER)


class _JaxSet:
    def __init__(self, n):
        self.n = n

    def __enter__(self):
        self.ps = jhvd.add_process_set(list(range(self.n)))
        return self.ps

    def __exit__(self, *exc):
        jhvd.remove_process_set(self.ps)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax(fn, *per_rank, n, **kw):
    """A JAX eager collective over a set of the first n ranks; its
    result per rank."""
    with _JaxSet(n) as ps:
        out = fn(*[jhvd.PerRank(v) for v in per_rank], process_set=ps,
                 **kw)
    if isinstance(out, tuple):
        out = out[0]
    vals = out.values if isinstance(out, jhvd.PerRank) else [out] * n
    return [np.asarray(v) for v in vals]


@pytest.mark.parametrize("op", ["Sum", "Average", "Max"])
def test_allreduce_gradient_is_the_allreduce(world, op):
    n, _, res = world
    want = _jax(JC.allreduce, [_inputs(r, n)["wx"] for r in range(n)],
                n=n, op=getattr(JC, op))
    for r, d in enumerate(res):
        assert _rel(d["ar_" + op].numpy(), want[r]) <= 1e-6
    assert not res[0]["no_grad"]


def test_allreduce_gradient_keeps_the_scale_factors(world):
    n, _, res = world
    want = _jax(JC.allreduce, [_inputs(r, n)["wx"] for r in range(n)],
                n=n, op=JC.Average, prescale_factor=0.5,
                postscale_factor=4.0)
    for r, d in enumerate(res):
        assert _rel(d["ar_scaled"].numpy(), want[r]) <= 1e-6


def test_ragged_allgather_gradient(world):
    """The summed gradient's rows of this rank, whose dim 0 is r + 1."""
    n, _, res = world
    summed = _jax(JC.allreduce, [_inputs(r, n)["wrag"] for r in range(n)],
                  n=n, op=JC.Sum)
    for r, d in enumerate(res):
        begin = r * (r + 1) // 2
        assert d["ag"].shape == (r + 1, 2)
        assert _rel(d["ag"].numpy(), summed[r][begin:begin + r + 1]) <= 1e-6
        assert float(d["ag_scalar"]) == n * r  # Σ_s w_s[r], w = arange(n)


def test_broadcast_gradient_sums_onto_the_root(world):
    n, _, res = world
    summed = _jax(JC.allreduce, [_inputs(r, n)["wx"] for r in range(n)],
                  n=n, op=JC.Sum)
    for r, d in enumerate(res):
        if r == n - 1:
            assert _rel(d["bc"].numpy(), summed[r]) <= 1e-6
        else:
            assert not d["bc"].any()


@pytest.mark.parametrize("op", ["Sum", "Average"])
def test_reducescatter_gradient_is_the_allgather(world, op):
    """dim 0 = 2n + 1: ceil rows per rank, the last rank short, so the
    gradient's allgather is ragged; Average divides by n."""
    n, tmp, res = world
    ws = [np.load(tmp / f"rsw{r}.npz")["w"] for r in range(n)]
    want = _jax(JC.allgather, ws, n=n)
    for r, d in enumerate(res):
        w = want[r] / n if op == "Average" else want[r]
        assert d["rs_" + op].shape == (2 * n + 1, 2)
        np.testing.assert_array_equal(d["rs_" + op].numpy(),
                                      w.astype(F32))


def test_alltoall_gradient_goes_back_with_the_received_splits(world):
    n, tmp, res = world
    ws = [np.load(tmp / f"a2aw{r}.npz")["w"] for r in range(n)]
    rsplits = [res[r]["a2a_rsplits"].numpy() for r in range(n)]
    want = _jax(JC.alltoall, ws, rsplits, n=n)
    for r, d in enumerate(res):
        assert d["a2a"].shape == _inputs(r, n)["a2a"].shape
        np.testing.assert_array_equal(d["a2a"].numpy(), want[r])


def test_grouped_allreduce_gradient(world):
    n, _, res = world
    with _JaxSet(n) as ps:
        want = JC.grouped_allreduce(
            [jhvd.PerRank([_inputs(r, n)[k] for r in range(n)])
             for k in ("w1", "w2")], op=JC.Average, process_set=ps)
    for d in res:
        for got, w in zip(d["grouped"], want):
            assert _rel(got.numpy(), np.asarray(w)) <= 1e-6


def test_even_alltoall_gradient(world):
    n, _, res = world
    want = _jax(JC.alltoall, [_inputs(r, n)["wx"][:n] for r in range(n)],
                n=n)
    for r, d in enumerate(res):
        np.testing.assert_array_equal(d["a2a_even"].numpy(), want[r])


@pytest.fixture(scope="module")
def gradchecks(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("gradcheck_np2"), 2, GRADCHECK)


@pytest.mark.parametrize("name", [
    "allreduce", "allreduce_average", "allreduce_sum_scaled", "allgather",
    "broadcast", "reducescatter", "reducescatter_average", "alltoall",
    "alltoall_splits", "grouped_allreduce"])
def test_gradcheck_f64(gradchecks, name):
    """`torch.autograd.gradcheck` passes on both ranks of an np=2 world:
    f64, eps 1e-6, atol 1e-7, rtol 1e-6; Average, which divides at f32,
    at eps 1e-3 and atol 1e-4."""
    assert all(d[name] is True for d in gradchecks)
