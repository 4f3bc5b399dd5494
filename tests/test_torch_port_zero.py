"""Port parity: the ZeRO ladder and the fused collective pipeline on the
CPU, against the JAX package.

- `plan_chunks`, `gradient_bucket_partition` and `shard_group_partition`
  give the JAX package's index lists over a grid of shapes, dtypes,
  thresholds and orders, the default transformer's leaves among them.
- In np=2 and np=3 gloo worlds (a `file://` rendezvous under tmp):
  `reducescatter` against the JAX eager collective on the same per-rank
  inputs; the pipelined collectives bitwise equal to the unchunked ones
  and to JAX's under shard_map; `fused_matmul_reduce_scatter`,
  `fused_allgather_matmul` and `gather_matmul` with
  HOROVOD_FUSED_PALLAS=1 against the JAX package's, whose K3 runs in
  interpret mode (1e-6 of the largest value, f32); the refusals.
- The schedule of `tests/data/zero_main.py` at np=2 on both sides: the
  port's stage 1, 2 and 3 finals bitwise equal to each other, across
  ranks and to the JAX package's (run by its own worker, as
  tests/test_multiprocess.py runs it).
- The transformer trainer at stages 0, 1 and 3 on two CPU ranks.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.models.transformer import TransformerConfig as JCfg
from horovod_tpu.models.transformer import transformer_init
from horovod_tpu.ops import fused_collectives as JF
from horovod_tpu.parallel import data_parallel as JDP

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.ops import fused_collectives as F
from horovod_tpu_torch.ops import wire
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.parallel import data_parallel as DP
from horovod_tpu_torch.transformer_benchmark import embed_group

from test_torch_port_collectives import (  # noqa: F401
    REPO, no_launcher_env, run_world)

F32 = np.float32
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}


# ---------------------------------------------------------------------------
# Chunk plan and partitions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,itemsize,chunk,align", [
    (0, 4, 1024, 128), (1, 4, 1024, 128), (1000, 4, 1024, 128),
    (4096, 2, 1024, 128), (300, 4, 8, 128), (32000, 2048, 1 << 20, 1),
    (16000, 2048, 1 << 20, 1), (300, 64, 8192, 1), (7, 3, 5, 1)])
def test_plan_chunks_matches_jax(n, itemsize, chunk, align):
    assert F.plan_chunks(n, itemsize, chunk, align) == \
        JF.plan_chunks(n, itemsize, chunk, align)


def test_plan_chunks_reads_the_env(monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSED_CHUNK_BYTES", "2048")
    assert F.plan_chunks(5000, 4) == JF.plan_chunks(5000, 4)
    assert len(F.plan_chunks(5000, 4)) == 10


LEAF_SETS = {
    "mixed": [((6,), "float32"), ((4, 2), "float32"), ((3, 5), "bfloat16"),
              ((7,), "float16"), ((128, 3), "float32"), ((1,), "bfloat16")],
    "layers": [((64, 64), "float32"), ((64,), "float32")] * 4,
    "one": [((10, 10), "float32")],
}


def _jax_leaves(spec):
    return [np.broadcast_to(np.zeros((), jnp.dtype(dt)), shp)
            for shp, dt in spec]


def _port_leaves(spec):
    return [torch.empty(shp, dtype=TORCH_DT[dt], device="meta")
            for shp, dt in spec]


@pytest.mark.parametrize("leaf_set", sorted(LEAF_SETS))
@pytest.mark.parametrize("threshold", [1, 16, 64, 600, 1 << 20])
@pytest.mark.parametrize("order", ["forward", "reverse", "perm"])
@pytest.mark.parametrize("compression", ["none", "fp16"])
def test_partitions_match_jax(leaf_set, threshold, order, compression):
    spec = LEAF_SETS[leaf_set]
    if order == "perm":
        order = list(np.random.RandomState(len(spec)).permutation(len(spec)))
    kw = dict(fusion_threshold_bytes=threshold, bucket_order=order)
    jleaves, pleaves = _jax_leaves(spec), _port_leaves(spec)
    jc = getattr(jhvd.Compression, compression)
    pc = getattr(Compression, compression)
    assert DP.gradient_bucket_partition(pleaves, compression=pc, **kw) == \
        JDP.gradient_bucket_partition(jleaves, compression=jc, **kw)
    assert DP.shard_group_partition(pleaves, compression=pc, **kw) == \
        [list(g) for g in JDP.shard_group_partition(jleaves, compression=jc,
                                                    **kw)]


@pytest.mark.parametrize("env", [{}, {"HOROVOD_MIN_BUCKETS": "3"},
                                 {"HOROVOD_BUCKET_ORDER": "forward"},
                                 {"HOROVOD_FUSION_THRESHOLD": "200"}])
def test_partitions_read_the_same_env(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    spec = LEAF_SETS["layers"]
    assert DP.shard_group_partition(_port_leaves(spec)) == \
        [list(g) for g in JDP.shard_group_partition(_jax_leaves(spec))]


def _default_transformer_leaves():
    shapes = jax.eval_shape(lambda: transformer_init(jax.random.PRNGKey(0),
                                                     JCfg()))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    names = [jax.tree_util.keystr(p) for p, _ in flat]
    return names, [(tuple(l.shape), str(l.dtype)) for _, l in flat]


@pytest.mark.parametrize("threshold,embed_alone", [(64 << 20, False),
                                                   (32 << 20, True)])
def test_default_transformer_shard_groups_match_jax(threshold, embed_alone):
    """The JAX transformer's layer-stacked leaves: at 64 MiB the
    embedding shares a group with final_norm.scale, at 32 MiB it is
    alone; the port's partition of the same leaves is the same."""
    names, spec = _default_transformer_leaves()
    want = [list(g) for g in JDP.shard_group_partition(
        _jax_leaves(spec), fusion_threshold_bytes=threshold)]
    assert DP.shard_group_partition(
        _port_leaves(spec), fusion_threshold_bytes=threshold) == want
    e, fn = names.index("['embed']"), names.index("['final_norm']['scale']")
    (group,) = [g for g in want if e in g]
    assert group == [e] if embed_alone else sorted(group) == sorted([e, fn])


def test_port_transformer_embedding_is_a_group_of_its_own(one_rank):
    """The port's own per-block parameters of the default config at the
    ZeRO-3 threshold (32 MiB): six shard groups, the embedding alone in
    the last (PERF.md lists them)."""
    with torch.device("meta"):
        model = Transformer(TransformerConfig())
    pl = hvd.zero3_placement(model.parameters(),
                             fusion_threshold_bytes=32 << 20)
    assert len(pl.groups) == 6
    assert embed_group(pl, model) == 5 and pl.groups[5].idxs == (0,)


@pytest.mark.parametrize("name", ["int8", "int4", "fp8_e4m3", "fp8_e5m2",
                                  "bogus"])
def test_cooperative_or_unknown_wire_raises(name):
    """An unknown name raises wherever it is resolved; a cooperative one
    resolves, and the one consumer that refuses it, as in the JAX
    package, is the host codec of a reshard chunk."""
    if name == "bogus":
        with pytest.raises(HorovodTpuError, match="unknown"):
            wire.get_codec(name)
        return
    assert wire.get_codec(name).cooperative
    with pytest.raises(HorovodTpuError, match="cooperative"):
        wire.host_encode(np.ones(4, np.float32), name)


def test_cast_wires_resolve():
    assert wire.get_codec(None).exact and wire.get_codec("none").exact
    assert wire.get_codec("bf16").cast_dtype == torch.bfloat16
    assert wire.get_codec("fp16").cast_dtype == torch.float16
    assert wire.wire_names() == ("bf16", "fp16", "fp8_e4m3", "fp8_e5m2",
                                 "int4", "int8", "none")


# ---------------------------------------------------------------------------
# Collectives, fused matmuls and gather_matmul in gloo worlds
# ---------------------------------------------------------------------------

CHUNK = 8192  # bytes: several chunks per buffer below


def _inputs(r, n):
    rng = np.random.RandomState(300 + r)
    return {
        "rs": rng.randn(n * 40).astype(F32),
        "rs_int": np.round(rng.randn(n * 40) * 8).astype(F32),
        "flat": rng.randn(n * 3000).astype(F32),
        "shard": rng.randn(3000).astype(F32),
        "g1": rng.randn(5, 7).astype(F32),
        "g2": np.round(rng.randn(2100) * 4).astype(F32),
        "g3": rng.randn(3000).astype(F32),
        # fused_matmul_reduce_scatter: column chunks whose operands hold
        # >= 128² elements take K3 (at np=2 not the 44-column tail).
        "a": rng.randn(n * 8, 256).astype(F32),
        "b": rng.randn(256, 300).astype(F32),
        # fused_allgather_matmul: every 16-row chunk takes K3.
        "x": rng.randn(128, 128).astype(F32),
        "w_shard": rng.randn(70, 128).astype(F32),
    }


HEAD = (48, 128)  # gather_matmul's weight: rows divide by 8, 2 and 3


def _head_params():
    """Two leaves whose JAX tree order (sorted keys) is the port's list
    order [head, bias], so both partitions list the same groups."""
    rng = np.random.RandomState(7)
    return {"a_head": rng.randn(*HEAD).astype(F32),
            "b_bias": rng.randn(5).astype(F32)}


WORKER = r'''
import os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.models.convert import zero_rows_from_jax
from horovod_tpu_torch.ops import fused_collectives as F
from horovod_tpu_torch.ops import matmul_kernels as MK

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
d = {k: torch.from_numpy(v) for k, v in np.load(f"{out_dir}/inputs{r}.npz").items()}
C = 8192
res = {}
res["rs_Sum"] = hvd.reducescatter(d["rs"], op=hvd.Sum)
res["rs_Average"] = hvd.reducescatter(d["rs"], op=hvd.Average)
res["rs_bf16"] = hvd.reducescatter(d["rs_int"].bfloat16(), op=hvd.Average)
h = hvd.reducescatter_async(d["rs"], op=hvd.Sum)
res["rs_async"] = hvd.synchronize(h)
res["pss"] = F.pipelined_psum_scatter(d["flat"], chunk_bytes=C)
res["pss_whole"] = hvd.reducescatter(d["flat"], op=hvd.Sum)
res["pss_chunks"] = len(F.plan_chunks(d["flat"].numel() // n, 4, C))
res["pag"] = F.pipelined_allgather_shard(d["shard"], chunk_bytes=C)
res["pag_bf16"] = F.pipelined_allgather_shard(d["shard"].bfloat16(),
                                              wire="bf16", chunk_bytes=C)
res["pag_whole"] = hvd.allgather(d["shard"])
group = [d["g1"], d["g2"].bfloat16(), d["g3"]]
res["pgar"] = F.pipelined_grouped_allreduce(group, chunk_bytes=C)
res["pgar_whole"] = hvd.grouped_allreduce(group, op=hvd.Average)
os.environ["HOROVOD_FUSED_PALLAS"] = "1"
MK.reset_launch_counts()
res["fmrs"] = F.fused_matmul_reduce_scatter(d["a"], d["b"], chunk_bytes=C)
res["fmrs_avg"] = F.fused_matmul_reduce_scatter(d["a"], d["b"], average=True,
                                                chunk_bytes=C)
res["fmrs_k3"] = MK.tiled_matmul.plain_calls
MK.reset_launch_counts()
res["fagm"] = F.fused_allgather_matmul(d["x"], d["w_shard"], chunk_bytes=C)
res["fagm_k3"] = MK.tiled_matmul.plain_calls

# gather_matmul over the JAX placement's rows.
jp = np.load(f"{out_dir}/head.npz")
params = [torch.from_numpy(jp["a_head"]), torch.from_numpy(jp["b_bias"])]
pl = hvd.zero3_placement(params, fusion_threshold_bytes=1024)
rows = zero_rows_from_jax(pl, [jp[f"row{i}"] for i in range(len(pl.groups))])
res["rows_match_shard"] = all(torch.equal(a, b) for a, b in
                              zip(rows, pl.shard(params)))
gi = [g.idxs for g in pl.groups].index((0,))
MK.reset_launch_counts()
with torch.no_grad():
    res["gm"] = pl.gather_matmul(d["x"], rows, gi)
res["gm_k3"] = MK.tiled_matmul.plain_calls
res["gather"] = pl.gather(rows)
res["resident"], res["full"] = pl.resident_bytes(), pl.full_bytes

def refusal(fn):
    try:
        fn()
    except (HorovodTpuError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None

res["refuse_grad"] = refusal(lambda: pl.gather_matmul(
    d["x"].clone().requires_grad_(), rows, gi))
one = hvd.zero3_placement(params, fusion_threshold_bytes=1 << 20)
res["refuse_multi"] = refusal(lambda: one.gather_matmul(
    d["x"], one.shard(params), 0))
odd = [torch.ones(7, 5)]
pad = hvd.zero3_placement(odd)
res["refuse_pad"] = refusal(lambda: pad.gather_matmul(
    torch.ones(3, 5), pad.shard(odd), 0))
res["refuse_wire"] = refusal(lambda: hvd.zero3_placement(params,
                                                         gather_wire="int9"))
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


def _jax_head_rows():
    """The JAX placement (n=8, this process's world) of the head params
    and its gather_matmul of rank r's x under HOROVOD_FUSED_PALLAS=1,
    K3 in interpret mode."""
    params = {k: jnp.asarray(v) for k, v in _head_params().items()}
    pl = jhvd.zero3_placement(params, fusion_threshold_bytes=1024)
    return pl, pl.shard(params), [g.idxs for g in pl.groups].index((0,))


@pytest.fixture(scope="module", params=[2, 3], ids=["np2", "np3"])
def world(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"zero_np{n}")
    for r in range(n):
        np.savez(tmp / f"inputs{r}.npz", **_inputs(r, n))
    _, rows, _ = _jax_head_rows()
    np.savez(tmp / "head.npz", **_head_params(),
             **{f"row{i}": np.asarray(row) for i, row in enumerate(rows)})
    return n, run_world(tmp, n, WORKER)


def _sub_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), (jhvd.GLOBAL_AXIS,))


def _shard_map(fn, n, n_in, out_spec):
    from jax import shard_map

    return jax.jit(shard_map(fn, mesh=_sub_mesh(n),
                             in_specs=(P(jhvd.GLOBAL_AXIS),) * n_in,
                             out_specs=out_spec, check_vma=False))


def _stack(n, key):
    return jnp.asarray(np.stack([_inputs(r, n)[key] for r in range(n)]))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("key,op", [("rs", "Sum"), ("rs", "Average"),
                                    ("rs_int", "Average")])
def test_reducescatter_matches_jax_eager(world, key, op):
    """The JAX eager `reducescatter` over a process set of the same n
    ranks, on the same per-rank inputs (bf16 on integer values, where
    every rounding is exact)."""
    n, res = world
    ps = jhvd.add_process_set(list(range(n)))
    try:
        xs = [jnp.asarray(_inputs(r, n)[key]) for r in range(n)]
        if key == "rs_int":
            xs = [x.astype(jnp.bfloat16) for x in xs]
        want = jhvd.reducescatter(jhvd.PerRank(xs), op=getattr(jhvd, op),
                                  process_set=ps)
    finally:
        jhvd.remove_process_set(ps)
    got_key = "rs_bf16" if key == "rs_int" else f"rs_{op}"
    for r, d in enumerate(res):
        got, w = d[got_key], np.asarray(want.values[r].astype(jnp.float32))
        assert got.shape == (40,)
        np.testing.assert_allclose(got.float().numpy(), w, rtol=1e-6,
                                   atol=1e-6)
    for d in res:
        assert torch.equal(d["rs_async"], d["rs_Sum"])


def test_pipelined_psum_scatter_bitwise(world):
    """Bitwise equal to the unchunked scatter, and to the JAX package's
    where each sum has two terms; with three, the two sum in another
    order: within 1e-6 of the largest value."""
    n, res = world
    want = _shard_map(
        lambda x: JF.pipelined_psum_scatter(x[0], jhvd.GLOBAL_AXIS,
                                            chunk_bytes=CHUNK),
        n, 1, P(jhvd.GLOBAL_AXIS))(_stack(n, "flat"))
    want = np.asarray(want).reshape(n, -1)
    for r, d in enumerate(res):
        assert d["pss_chunks"] > 1
        assert torch.equal(d["pss"], d["pss_whole"])
        if n == 2:
            np.testing.assert_array_equal(d["pss"].numpy(), want[r])
        else:
            assert _rel(d["pss"].numpy(), want[r]) <= 1e-6


def test_pipelined_allgather_shard_bitwise(world):
    n, res = world
    want = _shard_map(
        lambda x: JF.pipelined_allgather_shard(x[0], jhvd.GLOBAL_AXIS,
                                               chunk_bytes=CHUNK),
        n, 1, P())(_stack(n, "shard"))
    for d in res:
        assert torch.equal(d["pag"], d["pag_whole"])
        np.testing.assert_array_equal(d["pag"].numpy(), np.asarray(want))
        assert d["pag_bf16"].dtype == torch.bfloat16
        assert torch.equal(d["pag_bf16"], d["pag_whole"].bfloat16())


def test_pipelined_grouped_allreduce_bitwise(world):
    """Bitwise equal to the unchunked grouped allreduce where each sum
    has two terms.  With three, gloo's ring orders an element's terms by
    its place in the buffer, which the chunking moves: within 1e-6 of
    the largest value then, and of the JAX package's."""
    n, res = world
    for d in res:
        for got, whole in zip(d["pgar"], d["pgar_whole"]):
            assert got.dtype == whole.dtype
            if n == 2:
                assert torch.equal(got, whole)
            else:
                assert _rel(got.float().numpy(), whole.float().numpy()) \
                    <= 1e-6
    keys = ("g1", "g2", "g3")

    def fn(*xs):
        ts = [x[0] for x in xs]
        ts[1] = ts[1].astype(jnp.bfloat16)
        return tuple(JF.pipelined_grouped_allreduce(
            ts, axis_name=jhvd.GLOBAL_AXIS, chunk_bytes=CHUNK))

    want = _shard_map(fn, n, 3, (P(),) * 3)(*[_stack(n, k) for k in keys])
    for got, w in zip(res[0]["pgar"], want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-6)


@pytest.fixture
def fused_pallas(monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSED_PALLAS", "1")


@pytest.mark.parametrize("average", [False, True])
def test_fused_matmul_reduce_scatter_matches_jax(world, fused_pallas,
                                                 average):
    """Against the JAX function with its K3 in interpret mode: within
    1e-6 of the largest value (f32 sums in another order).  The chunks
    whose operands hold 128² elements take K3, the others torch's
    matmul (at np=2 the 44-column tail)."""
    n, res = world
    want = _shard_map(
        lambda a, b: JF.fused_matmul_reduce_scatter(
            a[0], b[0], jhvd.GLOBAL_AXIS, average=average,
            chunk_bytes=CHUNK),
        n, 2, P(jhvd.GLOBAL_AXIS))(_stack(n, "a"), _stack(n, "b"))
    want = np.asarray(want).reshape(n, 8, 300)
    key = "fmrs_avg" if average else "fmrs"
    for r, d in enumerate(res):
        assert d[key].shape == (8, 300)
        assert _rel(d[key].numpy(), want[r]) <= 1e-6
    k3 = sum(1 for _, w in F.plan_chunks(300, n * 8 * 4, CHUNK, align=1)
             if n * 8 * 256 + 256 * w >= 128 * 128)
    assert k3 >= 1
    for d in res:
        assert d["fmrs_k3"] == 2 * k3  # two calls


def test_fused_allgather_matmul_matches_jax(world, fused_pallas):
    n, res = world
    want = _shard_map(
        lambda x, w: JF.fused_allgather_matmul(
            x[0], w[0], jhvd.GLOBAL_AXIS, chunk_bytes=CHUNK)[None],
        n, 2, P(jhvd.GLOBAL_AXIS))(_stack(n, "x"), _stack(n, "w_shard"))
    ws = np.concatenate([_inputs(r, n)["w_shard"] for r in range(n)])
    for r, d in enumerate(res):
        assert d["fagm"].shape == (128, n * 70)
        assert _rel(d["fagm"].numpy(), np.asarray(want)[r]) <= 1e-6
        assert _rel(d["fagm"].numpy(), _inputs(r, n)["x"] @ ws.T) <= 1e-6
        assert d["fagm_k3"] == 5 * n  # 5 row chunks, n bands each


def test_gather_matmul_matches_jax(world, fused_pallas):
    """The port's placement holds the JAX placement's shards (re-cut for
    its world size) and its gather_matmul agrees with the JAX one."""
    from jax import shard_map

    n, res = world
    pl, rows, gi = _jax_head_rows()
    head = _head_params()["a_head"]
    for r, d in enumerate(res):
        x = jnp.asarray(_inputs(r, n)["x"])
        want = jax.jit(shard_map(
            lambda rr: pl.gather_matmul(x, rr, gi), mesh=jhvd.global_mesh(),
            in_specs=(P(),), out_specs=P(), check_vma=False))(rows)
        assert d["rows_match_shard"]
        assert d["gm"].shape == (128, HEAD[0])
        assert _rel(d["gm"].numpy(), np.asarray(want)) <= 1e-6
        assert _rel(d["gm"].numpy(), np.asarray(x) @ head.T) <= 1e-6
        assert d["gm_k3"] == n  # one chunk, n bands
        np.testing.assert_array_equal(d["gather"][0].numpy(), head)
        np.testing.assert_array_equal(d["gather"][1].numpy(),
                                      _head_params()["b_bias"])
        assert d["resident"] <= d["full"] // n + 4 * 2


@pytest.mark.parametrize("key,match", [
    ("refuse_grad", "forward-only"), ("refuse_multi", "single-2D-leaf"),
    ("refuse_pad", "divide the rank count"),
    ("refuse_wire", "unknown wire format")])
def test_refusals(world, key, match):
    _, res = world
    for d in res:
        assert d[key] is not None and match in d[key]


def test_gather_matmul_refuses_without_a_process_group():
    hvd.init(device="cpu")
    try:
        w = [torch.ones(4, 3)]
        pl = hvd.zero3_placement(w)
        with pytest.raises(HorovodTpuError, match="torch.distributed"):
            pl.gather_matmul(torch.ones(2, 3), pl.shard(w), 0)
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# The ZeRO ladder: tests/data/zero_main.py's schedule on both sides
# ---------------------------------------------------------------------------

ZERO_WORKER = r'''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
K, WINDOWS, SHAPES, FUSION = 2, 2, [(6,), (4, 2)], 16
rng = np.random.RandomState(0)
data = [np.round(rng.randn(n, K * WINDOWS, *s) * 4).astype(np.float32)
        for s in SHAPES]
res = {}
for stage in (1, 2, 3):
    params = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=0.25, momentum=0.5), zero_stage=stage,
        backward_passes_per_step=K, fusion_threshold_bytes=FUSION)
    if stage == 3:
        pl = hvd.zero3_placement(params, fusion_threshold_bytes=FUSION)
        rows = pl.shard(params)
    for j in range(K * WINDOWS):
        for p, d in zip(params, data):   # what backward would accumulate
            g = torch.from_numpy(d[r, j].copy())
            p.grad = g if p.grad is None else p.grad + g
        updates = opt.step()
        if stage == 3 and updates is not None:
            rows = pl.apply_updates(rows, updates)
            with torch.no_grad():
                for p, full in zip(params, pl.gather(rows)):
                    p.copy_(full)
        if (j + 1) % K == 0:
            opt.zero_grad()
    res[f"z{stage}"] = [p.detach().clone() for p in params]
    res[f"z{stage}_state"] = hvd.optimizer_state_bytes(opt)
    res[f"z{stage}_accum"] = hvd.grad_accum_bytes(opt)
    if stage == 3:
        res["full"], res["resident"] = pl.full_bytes, pl.resident_bytes()
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def zero_worlds(tmp_path_factory):
    """The port's schedule at np=2, and the JAX package's own worker
    (`tests/data/zero_main.py` under `horovod_tpu.runner -np 2`)."""
    tmp = tmp_path_factory.mktemp("zero_main")
    env = dict(os.environ, HVD_TEST_OUT=str(tmp), JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    env.pop("XLA_FLAGS", None)
    jax_run = subprocess.run(
        [sys.executable, "-m", "horovod_tpu.runner", "-np", "2", "python",
         os.path.join(REPO, "tests", "data", "zero_main.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert jax_run.returncode == 0, (jax_run.stdout + jax_run.stderr)[-3000:]
    port = run_world(tmp_path_factory.mktemp("zero_port"), 2, ZERO_WORKER)
    jx = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    return port, jx


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_schedule_finals_bitwise_equal_to_jax(zero_worlds, stage):
    port, jx = zero_worlds
    for d, j in zip(port, jx):
        for got, z1, want in zip(d[f"z{stage}"], d["z1"], j[f"z{stage}"]):
            assert torch.equal(got, z1)                      # across stages
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want, np.float32))
    for a, b in zip(port[0][f"z{stage}"], port[1][f"z{stage}"]):
        assert torch.equal(a, b)                             # across ranks


def test_zero_schedule_bytes(zero_worlds):
    port, jx = zero_worlds
    for d, j in zip(port, jx):
        assert (d["full"], d["resident"]) == (j["param_full_bytes"],
                                              j["param_resident_bytes"])
        # SGD momentum: one buffer per shard element.  Stage 1 keeps the
        # parameter-shaped accumulator, stages 2/3 the local shards.
        assert d["z1_state"] == d["z2_state"] == d["z3_state"] == 28
        assert d["z1_accum"] == 56 and d["z2_accum"] == d["z3_accum"] == 28


BOUND_WORKER = r'''
import os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.parallel.zero3 import group_buffer

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
K, WINDOWS, SHAPES, FUSION = 2, 2, [(6,), (4, 2)], 16
rng = np.random.RandomState(0)
data = [np.round(rng.randn(n, K * WINDOWS, *s) * 4).astype(np.float32)
        for s in SHAPES]
res = {}
for fused in ("0", "1"):
    os.environ["HOROVOD_FUSED_COLLECTIVES"] = fused
    params = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=0.25, momentum=0.5), zero_stage=3,
        backward_passes_per_step=K, fusion_threshold_bytes=FUSION)
    pl = hvd.zero3_placement(params, fusion_threshold_bytes=FUSION)
    rows = pl.shard(params)
    pl.bind(params)
    released, shared, resident = [], [], []
    for j in range(K * WINDOWS):
        got = pl.gather(rows)
        shared.append(all(a is b for a, b in zip(got, params)) and all(
            group_buffer(params, g) is not None for g in pl.groups))
        for p, d in zip(params, data):
            p.grad = torch.from_numpy(d[r, j].copy())
        updates = opt.step()
        if updates is not None:
            rows = pl.apply_updates(rows, updates)
        pl.release()
        released.append([t.untyped_storage().nbytes()
                         for t in params + opt._shards])
        resident.append((pl.resident_bytes(), sum(
            row.untyped_storage().nbytes() for row in rows)))
    try:
        params[0].sum()
        res[f"read_{fused}"] = None
    except HorovodTpuError as e:
        res[f"read_{fused}"] = str(e)
    res[f"shape_{fused}"] = [tuple(p.shape) for p in params]
    res[f"released_{fused}"], res[f"shared_{fused}"] = released, shared
    res[f"resident_{fused}"] = resident
    res[f"final_{fused}"] = [p.detach().clone() for p in pl.gather(rows)]
    pl.release()
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def bound_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("zero_bound"), 2, BOUND_WORKER)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_bound_stage3_releases_and_stays_bitwise(zero_worlds, bound_world,
                                                 fused):
    """The schedule of zero_main.py at stage 3 with the parameters bound
    to the placement (views of one buffer per group), gathered into
    those buffers (unchunked, and chunked under
    HOROVOD_FUSED_COLLECTIVES=1) and released after every step: each
    parameter's storage, and each of the optimizer's shards, holds 0
    bytes between steps, a parameter raises if read,
    the gather hands back the parameters themselves as views of their
    group's buffer, the measured resident bytes are the rows' storage
    (the JAX package's param_resident_bytes), and the finals are bitwise
    the JAX package's."""
    _, jx = zero_worlds
    for d, j in zip(bound_world, jx):
        # Two parameters and the optimizer's shard of each group.
        assert all(len(sizes) >= 3 and not any(sizes)
                   for sizes in d[f"released_{fused}"])
        assert all(d[f"shared_{fused}"])
        assert d[f"shape_{fused}"] == [(6,), (4, 2)]
        assert "released between steps" in d[f"read_{fused}"]
        for measured, rows in d[f"resident_{fused}"]:
            assert measured == rows == j["param_resident_bytes"]
        for got, want in zip(d[f"final_{fused}"], j["z3"]):
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# Contracts, at one rank in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _sgd(params, **kw):
    return torch.optim.SGD(params, lr=0.1, momentum=0.9, **kw)


def test_zero_stage_contracts(one_rank, monkeypatch):
    params = [torch.nn.Parameter(torch.ones(4, 4)),
              torch.nn.Parameter(torch.ones(3))]
    with pytest.raises(ValueError, match="Average/Sum"):
        hvd.DistributedOptimizer(_sgd(params), zero_stage=1, op=hvd.Adasum)
    with pytest.raises(ValueError, match="0..3"):
        hvd.DistributedOptimizer(_sgd(params), zero_stage=4)
    with pytest.raises(ValueError, match="contradicts"):
        hvd.DistributedOptimizer(_sgd(params), zero_stage=2,
                                 shard_optimizer_states=False)
    sub = hvd.ProcessSet(ranks=[0], process_set_id=1)
    with pytest.raises(ValueError, match="global process set"):
        hvd.DistributedOptimizer(_sgd(params), zero_stage=1, process_set=sub)
    with pytest.raises(ValueError, match="global process set"):
        hvd.zero3_placement(params, process_set=sub)
    groups = [{"params": params[:1], "lr": 0.1}, {"params": params[1:],
                                                   "lr": 0.2}]
    with pytest.raises(ValueError, match="same hyperparameters"):
        hvd.DistributedOptimizer(torch.optim.SGD(groups), zero_stage=1)
    monkeypatch.setenv("HOROVOD_SHARD_OPTIMIZER", "1")
    assert hvd.DistributedOptimizer(_sgd(params)).zero_stage == 1
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "2")
    assert hvd.DistributedOptimizer(_sgd(params)).zero_stage == 2


def test_partition_drift_raises(one_rank, monkeypatch):
    params = [torch.nn.Parameter(torch.ones(64)) for _ in range(3)]
    opt = hvd.DistributedOptimizer(_sgd(params), zero_stage=1)
    pl = hvd.zero3_placement(params)
    rows = pl.shard(params)
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "300")
    for p in params:
        p.grad = torch.ones(64)
    with pytest.raises(ValueError, match="re-init"):
        opt.step()
    with pytest.raises(ValueError, match="re-init"):
        pl.gather(rows)
    monkeypatch.delenv("HOROVOD_FUSION_THRESHOLD")
    with pytest.raises(ValueError, match="re-init"):
        pl.gather(rows * 2)
    with pytest.raises(ValueError, match="re-init"):
        pl.gather((rows[0][:, :-1],))


@pytest.mark.parametrize("fn", ["psum_scatter", "allgather_shard"])
def test_one_rank_pipeline_moves_nothing(one_rank, fn):
    """At one rank the chunked collectives are one copy of the buffer,
    whatever the chunk plan (here 8 chunks): bitwise the input, not an
    alias of it."""
    x = torch.from_numpy(np.random.RandomState(3).randn(8 * 512)
                         .astype(F32))
    run = {"psum_scatter": F.pipelined_psum_scatter,
           "allgather_shard": F.pipelined_allgather_shard}[fn]
    got = run(x, chunk_bytes=2048)
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()


def test_released_parameters_keep_metadata_and_refuse_reads(one_rank):
    """Bound and released: shapes, dtype, `.grad` and the optimizer's
    param groups stay; reading values, `.data` or a state_dict raises;
    a gather restores the storage, shared with the group's buffer, and
    the values; `resident_bytes` follows the storages."""
    from horovod_tpu_torch.parallel.zero3 import group_buffer

    model = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.Linear(4, 2))
    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    opt = torch.optim.SGD(params, lr=0.1)
    pl = hvd.zero3_placement(params, fusion_threshold_bytes=64)
    rows = pl.shard(params)
    row_bytes = sum(r.untyped_storage().nbytes() for r in rows)
    pl.bind(params)
    assert [tuple(p.shape) for p in params] == [(4, 8), (4,), (2, 4), (2,)]
    assert all(p.untyped_storage().nbytes() == 0 for p in params)
    assert all(isinstance(p, torch.nn.Parameter) for p in params)
    assert opt.param_groups[0]["params"][0] is params[0]
    assert pl.resident_bytes() == row_bytes
    assert "ReleasedParameter(shape=(4, 8)" in repr(params[0])
    opt.zero_grad()
    for read in (lambda: params[0] * 2, lambda: params[1].data,
                 lambda: model(torch.ones(1, 8)), model.state_dict,
                 lambda: params[2].detach()):
        with pytest.raises(HorovodTpuError, match="released between steps"):
            read()
    got = pl.gather(rows)
    assert all(a is b for a, b in zip(got, params))
    for g in pl.groups:
        flat = group_buffer(params, g)
        assert flat is not None and all(
            params[i].untyped_storage().data_ptr() == flat.data_ptr()
            for i in g.idxs)
    for p, b in zip(params, before):
        assert torch.equal(p.detach(), b)
    assert pl.resident_bytes() == row_bytes + sum(
        g.padded * 4 for g in pl.groups)
    model(torch.ones(1, 8)).sum().backward()
    assert all(p.grad is not None for p in params)
    pl.release()
    assert pl.resident_bytes() == row_bytes
    with pytest.raises(HorovodTpuError, match="bind"):
        hvd.zero3_placement(params).release()


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_one_rank_stages_match_stage_zero(one_rank, stage, opt_name):
    """At one rank the scatter and the gather move nothing: stages 1 and
    2 step bitwise like stage 0 (the same elementwise update on a flat
    shard), stage 3 within one rounding of the update (its rows add
    new - old)."""
    rng = np.random.RandomState(5)
    base = [rng.randn(16, 8).astype(F32) * 0.05, rng.randn(9).astype(F32)]
    grads = [[rng.randn(*b.shape).astype(F32) for b in base]
             for _ in range(4)]
    make = {"sgd": _sgd,
            "adamw": lambda p: torch.optim.AdamW(p, lr=3e-4,
                                                 weight_decay=1e-4)}[opt_name]
    finals = {}
    for st in (0, stage):
        params = [torch.nn.Parameter(torch.from_numpy(b.copy()))
                  for b in base]
        opt = hvd.DistributedOptimizer(make(params), zero_stage=st,
                                       fusion_threshold_bytes=256)
        pl = hvd.zero3_placement(params, fusion_threshold_bytes=256)
        rows = pl.shard(params)
        for g in grads:
            for p, gg in zip(params, g):
                p.grad = torch.from_numpy(gg.copy())
            updates = opt.step()
            if st == 3:
                rows = pl.apply_updates(rows, updates)
                with torch.no_grad():
                    for p, full in zip(params, pl.gather(rows)):
                        p.copy_(full)
            opt.zero_grad()
        finals[st] = [p.detach().clone() for p in params]
        if st:
            assert hvd.optimizer_state_bytes(opt) >= 0
    for a, b in zip(finals[0], finals[stage]):
        if stage < 3:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(b, a, rtol=0,
                                       atol=1e-6 * float(a.abs().max()))


# ---------------------------------------------------------------------------
# The transformer trainer at stages 0, 1 and 3 on two CPU ranks
# ---------------------------------------------------------------------------

def _run_trainer(tmp, base, stage):
    """One stage of the trainer on two CPU ranks; each rank's STEP, EVAL
    and SUMMARY records."""
    args = [sys.executable, "-m", "horovod_tpu_torch.transformer_benchmark",
            "--device", "cpu", "--vocab-size", "256", "--d-model", "64",
            "--n-heads", "2", "--d-head", "32", "--d-ff", "128",
            "--n-layers", "2", "--seq-len", "256", "--num-warmup-batches",
            "0", "--num-batches-per-iter", "1", "--num-iters", "3",
            "--log-steps", "--eval-every", "3", "--check-plain-step", "2",
            "--zero-stage", str(stage)]
    procs = [subprocess.Popen(
        args, cwd=REPO, env=dict(
            base, HOROVOD_PROCESS_ID=str(r),
            HOROVOD_COORDINATOR_ADDR=f"file://{tmp}/rdv{stage}"),
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


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """Stages 0, 1 and 3, one after another.  HOROVOD_FUSION_THRESHOLD
    = 65536 makes the (256, 64) embedding a shard group of its own;
    8192-byte chunks cut its 128-row shard into 4 chunks of 32 rows,
    each (256, 64) @ (64, 32) product at 128² elements, so K3."""
    tmp = tmp_path_factory.mktemp("trainer")
    base = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1", HOROVOD_NUM_PROCESSES="2",
        HOROVOD_FUSED_COLLECTIVES="1", HOROVOD_FUSED_PALLAS="1",
        HOROVOD_FUSION_THRESHOLD="65536", HOROVOD_FUSED_CHUNK_BYTES="8192")
    for k in ("HOROVOD_LOCAL_RANK", "HOROVOD_LOCAL_SIZE"):
        base.pop(k, None)
    return {(stage, r): rec for stage in (0, 1, 3)
            for r, rec in enumerate(_run_trainer(tmp, base, stage))}


def test_trainer_stage1_is_bitwise_stage0(trainer_runs):
    """Each gradient sum has two terms and AdamW is elementwise, so the
    sharded step gives stage 0's parameters bit for bit."""
    for r in range(2):
        for a, b in zip(trainer_runs[0, r]["STEP"],
                        trainer_runs[1, r]["STEP"]):
            assert a["loss"] == b["loss"] and a["digest"] == b["digest"]


def test_trainer_stage3_holds_only_the_rows_between_steps(trainer_runs):
    """After the last step the stage-3 trainer's parameters hold 0
    bytes of storage, and its measured resident bytes are the rows:
    about half the parameters at two ranks, one pad element per group at
    most.  Stage 0 holds every parameter."""
    for r in range(2):
        (s0,) = trainer_runs[0, r]["SUMMARY"]
        (s3,) = trainer_runs[3, r]["SUMMARY"]
        assert s0["param_storage_bytes"] == s0["param_full_bytes"]
        assert s0["param_resident_bytes"] == s0["param_full_bytes"]
        assert s3["param_storage_bytes"] == 0
        assert s3["param_full_bytes"] // 2 <= s3["param_resident_bytes"] \
            <= s3["param_full_bytes"] // 2 + 4 * s3["shard_groups"]


def test_trainer_stage3_matches_stage0(trainer_runs):
    """Stage 3's rows add new - old, one rounding from stage 0's new:
    the losses within 1e-6 relative (at this size they come out equal),
    one digest per step across the ranks, and the eval forward's head
    through gather_matmul: 8 K3 calls (4 chunks, 2 bands), the plain
    version on the CPU, equal to the plain head."""
    for r in range(2):
        s0, s3 = trainer_runs[0, r], trainer_runs[3, r]
        for a, b in zip(s0["STEP"], s3["STEP"]):
            assert abs(a["loss"] - b["loss"]) <= 1e-6 * abs(a["loss"])
        (ev,) = s3["EVAL"]
        assert ev["k3_plain_calls"] == 8 and ev["k3_launches"] == 0
        assert ev["k3_strided_launches"] == 0
        assert ev["eval_logits_rel"] == 0.0
        assert np.isfinite(ev["eval_loss"])
        (ev0,) = s0["EVAL"]
        assert ev0["k3_plain_calls"] == 0
        (summ,) = s3["SUMMARY"]
        assert summ["zero_stage"] == 3
        assert summ["param_resident_bytes"] <= \
            summ["param_full_bytes"] // 2 + 4 * summ["shard_groups"]
    for a, b in zip(trainer_runs[3, 0]["STEP"], trainer_runs[3, 1]["STEP"]):
        assert a["digest"] == b["digest"]
