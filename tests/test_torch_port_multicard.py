"""The repairs that one rank a card over NCCL needs, held on four gloo
CPU ranks.

NCCL builds a group's communicator at the group's first collective, and
torch's `batch_isend_irecv` is one: every rank of the group must post
the group's first batch of point-to-point ops, where gloo lets any two
ranks exchange from the start.  `ops.collectives.sendrecv` therefore
runs each set's first exchange over every rank of it (`_p2p_ready`: one
element to the next set rank, one from the one before), and every rank
of a set calls `sendrecv` at the same points, passing None for a side it
does not take part in.  One world of four ranks, the wrapped
`dist.batch_isend_irecv` counting every call (the set's ranks, each op's
kind and peer), runs each case twice, in a generation of its own each
time: once as the port runs it, once with the first exchange left out
(`_p2p_ready` only setting the set's flag).

- In every case, each rank of each set that exchanges takes part in the
  set's first exchange, and it is the all-ranks ring: the sp ring's K/V
  hops (dp=2 x sp=2, ring attention), the GPipe hops (dp=2 x pp=2),
  the hops under MoE (ep=2 x sp=2, ring attention) and the Adasum XOR
  ladder at three ranks (a set of ranks 0-2 of the four), whose fold
  leaves rank 1 out: without the first exchange, rank 0's first batch
  on the set would be the fold's, without rank 1.
- The ladder's exchanges at three ranks, rank by rank, and nothing on
  rank 3, which is outside the set.
- Every result with the first exchange bitwise the one without it
  (losses, every reassembled gradient, the ladder's outputs).
- The ladder at three ranks bitwise the port's allgather-then-tree
  (`adasum_tree_reduce`, the reference semantics), within rtol 1e-5 /
  atol 1e-6 of JAX's `adasum_in_axis` under `shard_map` on three CPU
  devices (f32 sums in another order, test_torch_port_adasum.py's
  tolerance), and bitwise JAX's on inputs whose every f32 sum and
  product is exact (integers and dyadic Adasum coefficients).
- A synchronous collective's timeline span carries `dispatch: async`
  where waiting orders the stream rather than the host (NCCL;
  `collectives._stream_ordered` stands in for the backend here), and
  no mark over gloo.

dp=2 x tp=2, dp=2 x pp=2 and ep=2 x sp=2 are held to JAX's
`make_train_step` in test_torch_port_mesh.py, _pipeline.py and _moe.py.

`chip_smoke.py`'s phase 29 (`--phases multicard`) refuses a host with
fewer than four cards, naming what it found, and runs end to end on four
(and three) gloo CPU ranks at a small width with its checks but for the
launch counts, the cards and memory.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from horovod_tpu.ops import adasum as JA
from horovod_tpu_torch.ops import adasum as TA
from horovod_tpu_torch.trace import core as PCORE
from test_torch_port_collectives import no_launcher_env, run_world  # noqa: F401
from test_torch_port_mesh import SMALL, _data

N = 4
MOE = dict(moe_every=2, n_experts=4)
MESH_CASES = [("dp2_sp2_ring", dict(dp=2, sp=2), {}),
              ("dp2_pp2", dict(dp=2, pp=2), {}),
              ("ep2_sp2_ring", dict(ep=2, sp=2), MOE)]
CASES = ["ladder3"] + [c[0] for c in MESH_CASES]
LADDER_SET = (0, 1, 2)

WORKER = r'''
import functools, os, sys
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as T
from horovod_tpu_torch.ops import adasum as A
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
data = torch.load(f"{out_dir}/inputs.pt", weights_only=False)
calls = []
batch = dist.batch_isend_irecv


def counted(ops):
    calls.append((tuple(dist.get_process_group_ranks(ops[0].group)),
                  tuple(("send" if op.op is dist.isend else "recv", op.peer)
                        for op in ops)))
    return batch(ops)


dist.batch_isend_irecv = counted
ready = C._p2p_ready


def flag_only(ps):
    ps.p2p_ready = True


def generation(fn, first_exchange):
    """fn() in a generation of its own; (its result, the batches posted)."""
    C._p2p_ready = ready if first_exchange else flag_only
    del calls[:]
    hvd.init(coordinator_address=url, num_processes=n, process_id=r,
             device="cpu")
    try:
        return fn(), list(calls)
    finally:
        hvd.shutdown()


def ladder3():
    ps = hvd.add_process_set(data["ladder_set"])
    if r not in data["ladder_set"]:
        return {}
    return {k: A.adasum_in_axis(torch.from_numpy(xs[r]), ps)
            for k, xs in data["ladder"].items()}


def mesh_step(kw, extra):
    cfg = T.TransformerConfig(**data["cfg"], **extra,
                              compute_dtype=torch.float32)
    mesh = create_hybrid_mesh(**kw)
    step, shard_state, shard_batch = T.make_train_step(
        mesh, cfg, functools.partial(torch.optim.SGD, lr=1.0))
    shards, opt = shard_state(T.transformer_init(0, cfg))
    _, _, loss = step(shards, opt, shard_batch((data["tokens"],
                                                data["targets"])))
    grads = T.unshard(T.tree_map(lambda g: g.grad, shards), cfg, mesh)
    return {"loss": float(loss), "grads": grads}


res = {}
for first in (True, False):
    res[("ladder3", first)] = generation(ladder3, first)
    for name, kw, extra in data["mesh_cases"]:
        res[(name, first)] = generation(
            functools.partial(mesh_step, kw, extra), first)


def spans():
    x = torch.arange(6, dtype=torch.float32) + r
    C._stream_ordered = lambda: True
    hvd.allreduce(x, name="stream_ordered")
    hvd.allreduce(x, op=hvd.Adasum, name="stream_ordered_adasum")
    C._stream_ordered = stream_ordered
    hvd.allreduce(x, name="host_waits")


stream_ordered = C._stream_ordered
os.environ["HOROVOD_TIMELINE"] = f"{out_dir}/tl.json"
generation(spans, True)
torch.save(res, f"{out_dir}/rank{r}.pt")
'''


def _exact_ladder_inputs():
    """Three (4, 64) rank vectors whose every Adasum sum and product is
    exact in f32: the fold pairs ranks 0 and 2 at coefficients 3/4 and
    3/4 (|a|^2 = |c|^2 = 4, a.c = 2), and level 1 pairs that result with
    rank 1's vector at dot 0 (disjoint supports), coefficients 1."""
    xs = np.zeros((3, 4, 64), np.float32)
    xs[0, 0, 0] = 2.0
    xs[2, 0, :4] = 1.0
    xs[1, 1, :8] = np.arange(1, 9)
    return xs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multicard")
    tokens, targets = _data(4)
    ladder = {"normal": np.random.RandomState(0).randn(3, 4, 64)
              .astype(np.float32), "exact": _exact_ladder_inputs()}
    torch.save({"ladder": ladder, "ladder_set": list(LADDER_SET),
                "mesh_cases": MESH_CASES, "cfg": SMALL,
                "tokens": tokens, "targets": targets}, tmp / "inputs.pt")
    return tmp, ladder, run_world(tmp, N, WORKER, timeout=300)


def _ring(ranks, r):
    """The set's first exchange as rank r posts it."""
    i = ranks.index(r)
    return (("send", ranks[(i + 1) % len(ranks)]),
            ("recv", ranks[(i - 1) % len(ranks)]))


def _by_set(calls):
    out = {}
    for ranks, ops in calls:
        out.setdefault(ranks, []).append(ops)
    return out


@pytest.mark.parametrize("case", CASES)
def test_every_rank_of_a_set_takes_part_in_its_first_exchange(world, case):
    _, _, res = world
    per_rank = [_by_set(d[(case, True)][1]) for d in res]
    sets = set().union(*per_rank)
    assert sets, f"{case}: no point-to-point exchange"
    for ranks in sets:
        for r in ranks:
            got = per_rank[r].get(ranks)
            assert got, f"{case}: rank {r} never posted on set {ranks}"
            assert got[0] == _ring(ranks, r), (case, ranks, r, got[0])
        for r in set(range(N)) - set(ranks):
            assert ranks not in per_rank[r]
    if case == "ladder3":
        assert sets == {LADDER_SET}
    else:
        assert sets == {(0, 1), (2, 3)}


def test_the_ladder_at_three_ranks_exchanges_as_the_tree_pairs(world):
    """Two ladder calls (the normal and the exact inputs): the fold
    (rank 2 to rank 0), level 1 (ranks 0 and 1), the result back to rank
    2.  Rank 1 sits out the fold, so the first exchange is what makes
    its set ready; without it rank 0's first batch leaves rank 1 out."""
    _, _, res = world
    one = {0: [(("recv", 2),), (("send", 1), ("recv", 1)), (("send", 2),)],
           1: [(("send", 0), ("recv", 0))],
           2: [(("send", 0),), (("recv", 0),)]}
    for r, d in enumerate(res):
        got = [ops for ranks, ops in d[("ladder3", True)][1]]
        bare = [ops for ranks, ops in d[("ladder3", False)][1]]
        if r == 3:
            assert got == bare == []
            continue
        assert got == [_ring(list(LADDER_SET), r)] + one[r] * 2
        assert bare == one[r] * 2
    assert res[0][("ladder3", False)][1][0] == (LADDER_SET, (("recv", 2),))


@pytest.mark.parametrize("case", CASES)
def test_the_first_exchange_leaves_every_result_bitwise(world, case):
    _, _, res = world
    for d in res:
        with_first, without = d[(case, True)][0], d[(case, False)][0]
        if case == "ladder3":
            assert with_first.keys() == without.keys()
            for k in with_first:
                assert torch.equal(with_first[k], without[k])
            continue
        assert with_first["loss"] == without["loss"]
        a, b = dict(_leaves(with_first["grads"])), dict(
            _leaves(without["grads"]))
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_ladder(xs):
    mesh = JMesh(np.asarray(jax.devices()[:xs.shape[0]]), ("hvd",))
    f = shard_map(lambda x: JA.adasum_in_axis(x[0], "hvd")[None],
                  mesh=mesh, in_specs=P("hvd"), out_specs=P("hvd"),
                  check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(xs)))


@pytest.mark.parametrize("inputs", ["normal", "exact"])
def test_the_ladder_at_three_ranks_is_the_tree_and_jax_ladder(world, inputs):
    _, ladder, res = world
    xs = ladder[inputs]
    tree = TA.adasum_tree_reduce(torch.from_numpy(xs))
    want = _jax_ladder(xs)
    for r in LADDER_SET:
        got = res[r][("ladder3", True)][0][inputs]
        assert torch.equal(got, tree), r
        if inputs == "exact":
            np.testing.assert_array_equal(got.numpy(), want[r])
        else:
            np.testing.assert_allclose(got.numpy(), want[r], rtol=1e-5,
                                       atol=1e-6)
    if inputs == "exact":
        # The coefficients were 3/4 and 1, not the degenerate 1/2 pair.
        np.testing.assert_array_equal(
            tree.numpy()[0, :4], [2.25, 0.75, 0.75, 0.75])


def test_spans_end_at_dispatch_where_the_wait_orders_the_stream(world):
    tmp, _, _ = world
    spans = {e["tid"]: e for e in PCORE.load_events(str(tmp / "tl.json"))
             if e.get("ph") == "X" and e.get("cat") == "collective"}
    assert spans["ALLREDUCE:stream_ordered"]["dispatch"] == "async"
    assert spans["ALLREDUCE:stream_ordered_adasum"]["dispatch"] == "async"
    assert "dispatch" not in spans["ALLREDUCE:host_waits"]


# ---------------------------------------------------------------------------
# chip_smoke.py phase 29 (`--phases multicard`), rehearsed on the CPU
# ---------------------------------------------------------------------------

CPU_FOLD = "import sys\nimport chip_smoke\nsys.exit(chip_smoke.fold_rank())\n"
CPU_DECODE = '''import chip_smoke
from horovod_tpu_torch.models import transformer as T


def main():
    return chip_smoke.decode_mesh_rank(cfg=T.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, d_head=16, d_ff=128,
        n_layers=2), device="cpu", prompt_len=64)
'''
CPU_RESNET = ["--device", "cpu", "--model", "resnet18", "--image-size",
              "32", "--num-classes", "10", "--batch-size", "2"]
CPU_TRANSFORMER = ["--device", "cpu", "--vocab-size", "256", "--d-model",
                   "64", "--n-heads", "4", "--d-head", "16", "--d-ff",
                   "128", "--seq-len", "256"]


def test_chip_smoke_multicard_refuses_fewer_than_four_cards():
    import chip_smoke

    with pytest.raises(RuntimeError, match=r"needs 4 cards; found 0: \[\]"):
        chip_smoke.multicard_cards()


@pytest.mark.integration
def test_chip_smoke_multicard_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phase 29 end to end at a small width on four (and three) gloo CPU
    ranks: every run of it, its checks but for the launch counts, the
    cards and memory (`on_card=False`), in its process layout."""
    import chip_smoke as cs

    (tmp_path / "mc_cpu_fold.py").write_text(CPU_FOLD)
    (tmp_path / "mc_cpu_decode.py").write_text(CPU_DECODE)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    mark = f"multicard-test-{os.getpid()}"
    monkeypatch.setenv(cs.RUN_MARK, mark)
    monkeypatch.setattr(cs, "LOG_DIR", str(tmp_path / "out"))
    for name, extra in (("MULTICARD_RESNET", CPU_RESNET),
                        ("MULTICARD_ADASUM", CPU_RESNET),
                        ("MESH_ARGS", CPU_TRANSFORMER),
                        ("MULTICARD_STAGE0", CPU_TRANSFORMER
                         + ["--n-layers", "2"]),
                        ("ZERO3_ARGS", CPU_TRANSFORMER
                         + ["--n-layers", "2"])):
        monkeypatch.setattr(cs, name, getattr(cs, name) + extra)
    monkeypatch.setattr(cs, "ZERO3_ENV", dict(
        cs.ZERO3_ENV, HOROVOD_FUSION_THRESHOLD="65536"))
    monkeypatch.setattr(cs, "MULTICARD_DECODE_RUN", dict(
        cs.MULTICARD_DECODE_RUN, module="mc_cpu_decode", args=[]))
    run_ranks = cs.run_ranks
    monkeypatch.setattr(cs, "run_ranks", lambda phase, n, module, *a, **k:
                        run_ranks(phase, n, "mc_cpu_fold"
                                  if module == "chip_smoke" else module,
                                  *a, **k))
    try:
        out = cs.multicard_phase(["cpu"], on_card=False)
    finally:
        cs.stop_leftovers(mark)
    assert out["adasum_np3"] == [0, 0, 0]
    assert out["hier"]["hier_rel"] <= cs.HIER_RTOL
    assert sorted(out["mesh_launches"]) == sorted(
        name for name, *_ in cs.MULTICARD_MESHES)
    assert [d["rank"] for d in out["decode"]] == [0, 1, 2, 3]
    assert cs.adasum_levels(3, 0) == 2 and cs.adasum_levels(3, 2) == 0
    assert [cs.adasum_levels(4, r) for r in range(4)] == [2, 2, 2, 2]
    assert [cs.head_k3_launches(n) for n in (1, 2, 4)] == [63, 64, 64]
