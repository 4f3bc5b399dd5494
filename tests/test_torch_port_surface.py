"""Port parity: process sets, ragged and grouped gathers, alltoall with
splits, uneven and grouped reducescatter, and their async handles, in
np=2 and np=3 gloo worlds on the CPU.

Each world (`run_world`, a `file://` rendezvous under tmp) runs the
worker below once; the tests hold what each rank got against the JAX
package's eager collectives on its 8-rank simulated CPU world, through
a process set of the same ranks (the first n, or the port's subset),
with the same per-rank inputs (`PerRank`), or against its helpers
(`allgather_sizes`, `_alltoall_exchange_splits`).  Gathers, alltoall
and integer sums are compared bitwise; float reductions within 1e-6 of
the largest value (sums in another order).
"""

import ast
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.ops import collectives as JC

from test_torch_port_collectives import REPO, run_world

F32, I32 = np.float32, np.int32


def _inputs(r, n):
    """Rank r's inputs in a world of n ranks (the worker rebuilds
    them from the same seed)."""
    rng = np.random.RandomState(700 + r)
    # Send splits for alltoall: r + 2 + k rows to rank k, none to the
    # last rank from rank 0.
    splits = [r + 2 + k for k in range(n)]
    if r == 0:
        splits[-1] = 0
    return {
        "rag": rng.randn(r + 1, 3).astype(F32),
        "rag0": rng.randn(r, 2).astype(F32),          # rank 0: no rows
        "gi": (np.arange(4 * 2) + 10 * r).astype(I32).reshape(4, 2),
        "gb": rng.randn(2 * r + 1).astype(F32),
        "a2a": rng.randn(2 * n, 3).astype(F32),
        "a2av": rng.randn(sum(splits), 2).astype(F32),
        "splits": np.asarray(splits, I32),
        "rs": rng.randn(2 * n + 1, 3).astype(F32),
        "rs1": rng.randn(1, 4).astype(F32),
        "rsi": (np.arange(2 * n + 1) * (r + 1) - 3).astype(I32),
        "gr": rng.randn(n, 2).astype(F32),
        "x": rng.randn(6).astype(F32),
    }


WORKER = r'''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.ops import collectives as C

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
d = {k: torch.from_numpy(v) for k, v in np.load(f"{out_dir}/inputs{r}.npz").items()}
ps0 = hvd.global_process_set()
res = {}

def refusal(fn):
    try:
        fn()
    except HorovodTpuError as e:
        return str(e)
    return None

# Ragged and grouped gathers over the global set.
res["rag"] = hvd.allgather(d["rag"])
res["rag0"] = hvd.allgather(d["rag0"])
res["sizes"] = C.allgather_sizes([d["rag"].shape[0]], ps0)
res["grouped"] = hvd.grouped_allgather([d["rag"], d["gi"], d["gb"].bfloat16()])
h = hvd.grouped_allgather_async([d["gb"], d["gi"]])
res["grouped_async"] = hvd.synchronize(h)
h = hvd.allgather_async(d["rag"])
res["rag_async"] = hvd.synchronize(h)
# Alltoall: equal chunks, then splits.
res["a2a"] = hvd.alltoall(d["a2a"])
res["a2av"], res["a2av_splits"] = hvd.alltoall(d["a2av"], splits=d["splits"])
res["a2av_list"] = hvd.alltoall(d["a2av"].bfloat16(),
                                splits=d["splits"].tolist())[0]
h = hvd.alltoall_async(d["a2av"], splits=d["splits"])
res["a2av_async"] = hvd.synchronize(h)
res["split_table"] = C._alltoall_exchange_splits(d["splits"].tolist(), ps0, "cpu")
res["refuse_splits_sum"] = refusal(lambda: hvd.alltoall(torch.ones(n + 5), splits=[1] * n))
res["refuse_splits_len"] = refusal(lambda: hvd.alltoall(d["a2av"], splits=[1]))
res["refuse_a2a_dim0"] = refusal(lambda: hvd.alltoall(torch.ones(n + 1)))
# Reduce-scatter on the JAX package's eager rule.
for op in ("Sum", "Average"):
    res["rs_" + op] = hvd.reducescatter(d["rs"], op=getattr(hvd, op))
    res["rs1_" + op] = hvd.reducescatter(d["rs1"], op=getattr(hvd, op))
    res["grs_" + op] = hvd.grouped_reducescatter(
        [d["rs"], d["gr"], d["rs1"], d["rsi"]], op=getattr(hvd, op))
res["rsi"] = hvd.reducescatter(d["rsi"], op=hvd.Sum)
h = hvd.reducescatter_async(d["rs"], op=hvd.Sum)
res["rs_async"] = hvd.synchronize(h)
res["refuse_rs_op"] = refusal(lambda: hvd.reducescatter(d["rs"], op=hvd.Max))

# Process sets: validation, ids, a set that leaves a rank out.
res["refuse_dup"] = refusal(lambda: hvd.add_process_set([0, 0]))
res["refuse_range"] = refusal(lambda: hvd.add_process_set([0, n]))
res["refuse_same"] = refusal(lambda: hvd.add_process_set(list(range(n))))
res["refuse_global"] = refusal(lambda: hvd.remove_process_set(ps0))
members = [1] if n == 2 else [0, 2]
sub = hvd.add_process_set(members)
res["sub_id"] = sub.process_set_id
res["sub_ranks"] = sub.ranks
res["sub_included"] = sub.included()
if sub.included():
    res["sub_allreduce"] = hvd.allreduce(d["x"], op=hvd.Sum, process_set=sub)
    res["sub_average"] = hvd.allreduce(d["x"], process_set=sub)
    res["sub_allgather"] = hvd.allgather(d["rag"], process_set=sub)
    res["sub_broadcast"] = hvd.broadcast(d["x"], root_rank=len(members) - 1,
                                         process_set=sub)
    res["sub_reducescatter"] = hvd.reducescatter(d["rs"], op=hvd.Sum,
                                                 process_set=sub)
    res["sub_grouped"] = hvd.grouped_allreduce([d["x"], d["gr"]], op=hvd.Sum,
                                               process_set=sub)
    res["sub_alltoall"] = hvd.alltoall(d["gr"][:len(members)], process_set=sub)
    res["sub_rank"] = sub.rank()
else:
    res["sub_outsider"] = refusal(lambda: hvd.allreduce(d["x"], process_set=sub))
hvd.barrier()
hvd.remove_process_set(sub)
res["sub_removed"] = refusal(lambda: hvd.allreduce(d["x"], process_set=sub))
res["sub_lookup"] = refusal(lambda: hvd.get_process_set(sub.process_set_id))
again = hvd.add_process_set(members)
res["again_id"] = again.process_set_id
hvd.barrier()
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module", params=[2, 3], ids=["np2", "np3"])
def world(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"surface_np{n}")
    for r in range(n):
        np.savez(tmp / f"inputs{r}.npz", **_inputs(r, n))
    return n, run_world(tmp, n, WORKER)


class _JaxSet:
    """A process set of the JAX package over `ranks`, removed on exit."""

    def __init__(self, ranks):
        self.ranks = list(ranks)

    def __enter__(self):
        self.ps = jhvd.add_process_set(self.ranks)
        return self.ps

    def __exit__(self, *exc):
        jhvd.remove_process_set(self.ps)


def _per_rank(n, key, ranks=None):
    return jhvd.PerRank([_inputs(r, n)[key] for r in (ranks or range(n))])


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _values(x, n=8):
    """The JAX result per rank: a PerRank's values, or a replicated
    result (allreduce, allgather) n times."""
    vals = x.values if isinstance(x, jhvd.PerRank) else [x] * n
    return [np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                       else v) for v in vals]


# ---------------------------------------------------------------------------
# Gathers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key,got_key", [("rag", "rag"), ("rag0", "rag0"),
                                         ("rag", "rag_async")])
def test_ragged_allgather_bitwise(world, key, got_key):
    """Rank r gives r + 1 rows (or r: rank 0 none); the result holds
    exactly those rows in rank order, no padding left, bitwise the JAX
    package's."""
    n, res = world
    with _JaxSet(range(n)) as ps:
        want = _values(JC.allgather(_per_rank(n, key), process_set=ps))
    rows = sum(_inputs(r, n)[key].shape[0] for r in range(n))
    for r, d in enumerate(res):
        assert d[got_key].shape[0] == rows
        np.testing.assert_array_equal(d[got_key].numpy(), want[r])


def test_allgather_sizes_match_jax(world):
    n, res = world
    with _JaxSet(range(n)) as ps:
        want = JC.allgather_sizes([r + 1 for r in range(n)], ps)
    for d in res:
        assert d["sizes"] == want == [r + 1 for r in range(n)]


@pytest.mark.parametrize("i,key", [(0, "rag"), (1, "gi"), (2, "gb")])
def test_grouped_allgather_bitwise(world, i, key):
    """Each tensor as the JAX package's exact grouped path gathers it
    (one allgather each), bf16 and int32 included."""
    n, res = world
    pr = _per_rank(n, key)
    if key == "gb":
        pr = jhvd.PerRank([v.astype(jnp.bfloat16) for v in pr.values])
    with _JaxSet(range(n)) as ps:
        (want,) = JC.grouped_allgather([pr], process_set=ps)
    want = _values(want)
    for r, d in enumerate(res):
        got = d["grouped"][i]
        assert got.dtype == {"rag": torch.float32, "gi": torch.int32,
                             "gb": torch.bfloat16}[key]
        np.testing.assert_array_equal(_np(got), want[r])


def test_grouped_allgather_async(world):
    n, res = world
    for d in res:
        gb, gi = d["grouped_async"]
        np.testing.assert_array_equal(gb.numpy(), np.concatenate(
            [_inputs(r, n)["gb"] for r in range(n)]))
        np.testing.assert_array_equal(gi.numpy(), np.concatenate(
            [_inputs(r, n)["gi"] for r in range(n)]))


# ---------------------------------------------------------------------------
# Alltoall
# ---------------------------------------------------------------------------

def test_alltoall_equal_chunks_bitwise(world):
    n, res = world
    with _JaxSet(range(n)) as ps:
        want = _values(JC.alltoall(_per_rank(n, "a2a"), process_set=ps))
    for r, d in enumerate(res):
        np.testing.assert_array_equal(d["a2a"].numpy(), want[r])


@pytest.mark.parametrize("got_key", ["a2av", "a2av_async", "a2av_list"])
def test_alltoall_splits_bitwise(world, got_key):
    """Uneven splits (rank 0 sends nothing to the last rank): the rows
    and the received splits are the JAX package's."""
    n, res = world
    with _JaxSet(range(n)) as ps:
        out, rsplits = JC.alltoall(_per_rank(n, "a2av"),
                                   splits=_per_rank(n, "splits"),
                                   process_set=ps)
    for r, d in enumerate(res):
        got = d[got_key]
        splits = d["a2av_splits"]
        if got_key == "a2av_async":
            got, splits = got
        assert splits.dtype == torch.int32
        np.testing.assert_array_equal(splits.numpy(),
                                      np.asarray(rsplits.values[r]))
        want = np.asarray(out.values[r])
        if got_key == "a2av_list":  # bf16 moves its bytes
            want = np.asarray(jnp.asarray(want, jnp.bfloat16)
                              .astype(jnp.float32))
        np.testing.assert_array_equal(_np(got), want)


def test_alltoall_split_table_matches_jax(world):
    n, res = world
    with _JaxSet(range(n)) as ps:
        want = JC._alltoall_exchange_splits(
            [_inputs(r, n)["splits"] for r in range(n)], ps)
    for d in res:
        assert d["split_table"] == [[int(v) for v in row] for row in want]


@pytest.mark.parametrize("key,match", [
    ("refuse_splits_sum", "sum to dim0"),
    ("refuse_splits_len", "one entry per rank"),
    ("refuse_a2a_dim0", "divisible by set size"),
    ("refuse_rs_op", "Sum and Average")])
def test_refusals(world, key, match):
    _, res = world
    for d in res:
        assert d[key] is not None and match in d[key]


# ---------------------------------------------------------------------------
# Reduce-scatter
# ---------------------------------------------------------------------------

def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30) if want.size else 1.0
    return np.abs(got - want).max() / scale if want.size else 0.0


@pytest.mark.parametrize("op", ["Sum", "Average"])
@pytest.mark.parametrize("key", ["rs", "rs1"])
def test_uneven_reducescatter_matches_jax(world, key, op):
    """dim0 = 2n + 1 (ceil rows, the last rank one short) and dim0 = 1
    (only rank 0 keeps a row): the JAX package's rows, within 1e-6 of
    the largest value."""
    n, res = world
    with _JaxSet(range(n)) as ps:
        want = _values(JC.reducescatter(_per_rank(n, key),
                                        op=getattr(JC, op), process_set=ps))
    for r, d in enumerate(res):
        got = d[f"{key}_{op}"]
        assert tuple(got.shape) == want[r].shape
        assert _rel(got.numpy(), want[r]) <= 1e-6
    if key == "rs1":
        assert [d[f"rs1_{op}"].shape[0] for d in res] == [1] + [0] * (n - 1)


def test_integer_reducescatter_bitwise(world):
    n, res = world
    with _JaxSet(range(n)) as ps:
        want = _values(JC.reducescatter(_per_rank(n, "rsi"), op=JC.Sum,
                                        process_set=ps))
    for r, d in enumerate(res):
        assert d["rsi"].dtype == torch.int32
        np.testing.assert_array_equal(d["rsi"].numpy(), want[r])


def test_reducescatter_async(world):
    _, res = world
    for d in res:
        assert torch.equal(d["rs_async"], d["rs_Sum"])


@pytest.mark.parametrize("op", ["Sum", "Average"])
def test_grouped_reducescatter_matches_jax(world, op):
    """One fused scatter per dtype, as the JAX eager path fuses it: each
    tensor's rows as the JAX package's (the int32 one bitwise under
    Sum)."""
    n, res = world
    keys = ["rs", "gr", "rs1", "rsi"]
    with _JaxSet(range(n)) as ps:
        want = JC.grouped_reducescatter([_per_rank(n, k) for k in keys],
                                        op=getattr(JC, op), process_set=ps)
    for r, d in enumerate(res):
        for k, got, w in zip(keys, d[f"grs_{op}"], want):
            w = np.asarray(w.values[r])
            assert tuple(got.shape) == w.shape, k
            if k == "rsi" and op == "Sum":
                np.testing.assert_array_equal(got.numpy(), w)
            else:
                assert _rel(got.numpy(), w) <= 1e-6, k


# ---------------------------------------------------------------------------
# Process sets
# ---------------------------------------------------------------------------

def test_process_set_table(world):
    """Validation as in the JAX package (tests/test_basics.py), ids in
    order of registration and never reused."""
    n, res = world
    members = [1] if n == 2 else [0, 2]
    for r, d in enumerate(res):
        assert "duplicates" in d["refuse_dup"]
        assert "out of range" in d["refuse_range"]
        assert "already exists" in d["refuse_same"]
        assert "global process set" in d["refuse_global"]
        assert d["sub_id"] == 1 and d["again_id"] == 2
        assert d["sub_ranks"] == members
        assert d["sub_included"] == (r in members)
        assert "removed" in d["sub_removed"]
        assert "Unknown process set id 1" in d["sub_lookup"]


def test_process_set_leaving_a_rank_out(world):
    """The set's collectives against the JAX package's over a process
    set of the same ranks; the rank outside is refused."""
    n, res = world
    members = [1] if n == 2 else [0, 2]
    with _JaxSet(members) as ps:
        sums = _values(JC.allreduce(_per_rank(n, "x", members), op=JC.Sum,
                                    process_set=ps))
        avgs = _values(JC.allreduce(_per_rank(n, "x", members),
                                    op=JC.Average, process_set=ps))
        gath = _values(JC.allgather(_per_rank(n, "rag", members),
                                    process_set=ps))
        rs = _values(JC.reducescatter(_per_rank(n, "rs", members),
                                      op=JC.Sum, process_set=ps))
        a2a = _values(JC.alltoall(jhvd.PerRank(
            [_inputs(r, n)["gr"][:len(members)] for r in members]),
            process_set=ps))
    for r, d in enumerate(res):
        if r not in members:
            assert "no ranks in process set 1" in d["sub_outsider"]
            continue
        i = members.index(r)
        assert d["sub_rank"] == i
        assert _rel(d["sub_allreduce"].numpy(), sums[i]) <= 1e-6
        assert _rel(d["sub_average"].numpy(), avgs[i]) <= 1e-6
        np.testing.assert_array_equal(d["sub_allgather"].numpy(), gath[i])
        np.testing.assert_array_equal(d["sub_broadcast"].numpy(),
                                      _inputs(members[-1], n)["x"])
        assert _rel(d["sub_reducescatter"].numpy(), rs[i]) <= 1e-6
        np.testing.assert_array_equal(d["sub_alltoall"].numpy(), a2a[i])
        assert _rel(d["sub_grouped"][1].numpy(), np.sum(
            [_inputs(m, n)["gr"] for m in members], axis=0)) <= 1e-6


# ---------------------------------------------------------------------------
# The surface and the env catalog
# ---------------------------------------------------------------------------

def _public_names(path):
    """Top-level names a module defines or imports, without the leading
    underscore ones and the modules it imports (numpy as np, typing)."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom) and node.level > 0:
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_port_surface_covers_the_jax_shim():
    """The horovod.torch names of the JAX shim that the port lacks are
    exactly the ones a later slice ports."""
    jax_names = _public_names("horovod_tpu/torch/__init__.py")
    port_names = _public_names("horovod_tpu_torch/torch/__init__.py")
    assert jax_names - port_names == {"SyncBatchNorm", "elastic",
                                      "sparse_allreduce_async"}
    import horovod_tpu_torch as hvd

    for name in ("add_process_set", "remove_process_set", "alltoall",
                 "alltoall_async", "grouped_allgather",
                 "grouped_allgather_async", "grouped_reducescatter", "join"):
        assert callable(getattr(hvd, name)) and name in hvd.__all__


_READ = re.compile(r"\b(?:getenv|env_bool|env_int)\(\s*\"([A-Z0-9_]+)\"")


def test_env_catalog_names_every_variable_the_port_reads():
    """Every `util.getenv` / `env_bool` / `env_int` name in the port's
    sources (read as HOROVOD_<NAME>), and every literal HOROVOD_*
    lookup in `os.environ`, is in the port's catalog, and the catalog
    names nothing else."""
    from horovod_tpu_torch.common.env_catalog import BY_NAME

    read = set()
    root = os.path.join(REPO, "horovod_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            src = open(os.path.join(dirpath, f)).read()
            read.update("HOROVOD_" + m for m in _READ.findall(src))
            read.update(re.findall(
                r"environ(?:\.get)?[\[(]\s*\"(HOROVOD_[A-Z0-9_]+)\"", src))
    assert read and read == set(BY_NAME)
