"""Port parity: `join` with uneven batches in np=2 and np=3 gloo worlds
on the CPU.

Rank r trains r + 2 steps and then joins, so rank n - 1 joins last.
Each step runs, on the ranks still active, an Average, Sum, Max and
Product allreduce, a grouped Average, a reducescatter, a ragged
allgather, a broadcast from the last rank, an alltoall with splits and
a barrier; the joined ranks mirror them from the signatures published
in the process group's store.  The results are held against the JAX
package's masked math (`horovod_tpu.ops.join.masked_reduce_in_graph`)
on the stacked per-rank inputs, the joined ranks' rows zero: bitwise
for gathers, alltoall and integer sums, within 1e-6 of the largest
value for float reductions (sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu.ops import collectives as JC
from horovod_tpu.ops.join import masked_reduce_in_graph

from test_torch_port_collectives import run_world

F32 = np.float32


def _step_inputs(r, s, n):
    rng = np.random.RandomState(1000 * r + s)
    return {"x": rng.randn(5).astype(F32),
            "i": (np.arange(4) * (r + 1) + s).astype(np.int32),
            "g": rng.randn(3, 2).astype(F32),
            "rs": rng.randn(2 * n + 1, 2).astype(F32),
            "ag": rng.randn(r + 1, 2).astype(F32),
            "a2a": rng.randn(n, 3).astype(F32)}


WORKER = r'''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import HorovodTpuError

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
sys.path.insert(0, out_dir)
from join_inputs import _step_inputs

hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
res = {"steps": []}
try:
    hvd.join()
except HorovodTpuError as e:
    res["unarmed"] = str(e)
hvd.join_mode()
for s in range(r + 2):
    d = {k: torch.from_numpy(v) for k, v in _step_inputs(r, s, n).items()}
    rec = {}
    for op in ("Average", "Sum", "Max", "Product"):
        rec["x_" + op] = hvd.allreduce(d["x"], op=getattr(hvd, op))
    rec["i_Sum"] = hvd.allreduce(d["i"], op=hvd.Sum)
    rec["grouped"] = hvd.grouped_allreduce([d["x"], d["g"]], op=hvd.Average)
    rec["rs"] = hvd.reducescatter(d["rs"], op=hvd.Average)
    rec["ag"] = hvd.allgather(d["ag"])
    rec["bc"] = hvd.broadcast(d["x"], root_rank=n - 1)
    rec["a2a"], rec["a2a_splits"] = hvd.alltoall(d["a2a"], splits=[1] * n)
    hvd.barrier()
    res["steps"].append(rec)
res["last"] = hvd.join()
res["after"] = hvd.allreduce(torch.ones(2), op=hvd.Average)
res["after_sum"] = hvd.allreduce(torch.ones(2), op=hvd.Sum)
res["last_again"] = hvd.join()
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module", params=[2, 3], ids=["np2", "np3"])
def world(request, tmp_path_factory):
    import inspect

    n = request.param
    tmp = tmp_path_factory.mktemp(f"join_np{n}")
    (tmp / "join_inputs.py").write_text(
        "import numpy as np\nF32 = np.float32\n\n"
        + inspect.getsource(_step_inputs))
    return n, run_world(tmp, n, WORKER)


def _active(n, s):
    return [r for r in range(n) if s < r + 2]


def _stack(n, s, key):
    """Every rank's input at step s, a joined rank's zeros; and the
    (n, 1) active mask."""
    ins = [_step_inputs(r, s, n)[key] for r in range(n)]
    act = _active(n, s)
    xs = np.stack([x if r in act else np.zeros_like(x)
                   for r, x in enumerate(ins)])
    mask = np.asarray([[1.0 if r in act else 0.0] for r in range(n)], F32)
    return jnp.asarray(xs), jnp.asarray(mask)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_join_returns_the_last_rank(world):
    n, res = world
    for d in res:
        assert d["last"] == n - 1
        assert len(d["steps"]) == res.index(d) + 2
        assert "requires join mode to be armed" in d["unarmed"]


def test_collectives_after_the_join_are_unmasked(world):
    """The round closes: every rank contributes again, and a second
    join with every rank joining at once returns the highest rank."""
    n, res = world
    for d in res:
        np.testing.assert_array_equal(d["after"].numpy(), np.ones(2))
        np.testing.assert_array_equal(d["after_sum"].numpy(),
                                      np.full(2, float(n)))
        assert d["last_again"] == n - 1


@pytest.mark.parametrize("op", ["Average", "Sum", "Max", "Product"])
def test_masked_allreduce_matches_jax(world, op):
    """Average divides by the active count, the others ignore the joined
    ranks (JAX masked math on the same stacked inputs)."""
    n, res = world
    for s in range(n + 1):
        xs, mask = _stack(n, s, "x")
        want = np.asarray(masked_reduce_in_graph(xs, mask, getattr(JC, op),
                                                 n))
        for r in _active(n, s):
            assert _rel(res[r]["steps"][s][f"x_{op}"].numpy(), want) <= 1e-6


def test_masked_integer_sum_bitwise(world):
    n, res = world
    for s in range(n + 1):
        xs, mask = _stack(n, s, "i")
        want = np.asarray(masked_reduce_in_graph(xs, mask, JC.Sum, n))
        for r in _active(n, s):
            np.testing.assert_array_equal(res[r]["steps"][s]["i_Sum"].numpy(),
                                          want)


def test_masked_grouped_and_reducescatter_match_jax(world):
    n, res = world
    for s in range(n + 1):
        act = _active(n, s)
        g = [masked_reduce_in_graph(*_stack(n, s, k), JC.Average, n)
             for k in ("x", "g")]
        xs, mask = _stack(n, s, "rs")
        red = np.asarray(masked_reduce_in_graph(xs, mask, JC.Average, n))
        c = -(-red.shape[0] // n)
        for r in act:
            rec = res[r]["steps"][s]
            for got, want in zip(rec["grouped"], g):
                assert _rel(got.numpy(), np.asarray(want)) <= 1e-6
            want = red[r * c:(r + 1) * c]
            assert rec["rs"].shape == want.shape
            assert _rel(rec["rs"].numpy(), want) <= 1e-6


def test_gathers_broadcast_and_alltoall_with_joined_ranks(world):
    """A joined rank sends no rows: the allgather holds the active
    ranks' rows, alltoall delivers nothing from it (a zero split); the
    broadcast comes from the last rank."""
    n, res = world
    for s in range(n + 1):
        act = _active(n, s)
        ins = [_step_inputs(r, s, n) for r in range(n)]
        gathered = np.concatenate([ins[r]["ag"] for r in act])
        for r in act:
            rec = res[r]["steps"][s]
            np.testing.assert_array_equal(rec["ag"].numpy(), gathered)
            np.testing.assert_array_equal(rec["bc"].numpy(), ins[n - 1]["x"])
            np.testing.assert_array_equal(
                rec["a2a_splits"].numpy(),
                [1 if q in act else 0 for q in range(n)])
            np.testing.assert_array_equal(
                rec["a2a"].numpy(), np.stack([ins[q]["a2a"][r] for q in act]))
