"""Port parity: the hierarchical (dcn x ici) data plane of
`horovod_tpu_torch/parallel/hierarchical.py` and `create_hierarchical_mesh`
against the JAX package's `parallel/hierarchical.py` on a
`create_hierarchical_mesh(2, 2)` of four CPU devices.

One world of four gloo ranks (dcn = 2 slices of ici = 2) runs every case
once and saves what each rank got; JAX's side runs the same inputs, made
from the same seeds, under `shard_map` with each device's output kept.
Every leg of the exact path sums two addends, which rounds the same in
any order, so the exact results are held bitwise, floats too.  The dcn
leg on a quantized wire (int8, fp8_e4m3) is the quantized ring of two
ranks, held to JAX's within JAX_ATOL of the largest value plus one
quantization step of the block (its largest |value| / 127 for int8, 2^-3
of it for fp8_e4m3), the tolerance of tests/test_torch_port_quantized.py:
XLA fuses the ring's decode into its add and rounds the last bit apart
from the eager ops (on these inputs at most one ulp, 7.6e-6 at values
near 64, and no quantization tipped).

The same world drives the optimizer over the pair: at stage 0 under
HOROVOD_HIERARCHICAL_ALLREDUCE (fused_apply and early_reduction too) and
at stages 1-3 (the two-tier reduce-scatter and allgather, with
HOROVOD_SHARD_AG_FUSION on at stage 3), each bitwise the flat replicated
path on integer-valued SGD trajectories (JAX tests/test_optimizer.py:
442-473), and a stage-3 placement over the pair bitwise the flat one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from horovod_tpu.parallel import hierarchical as JH
from horovod_tpu.parallel.mesh import create_hierarchical_mesh as jax_mesh
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.parallel import hierarchical as TH
from horovod_tpu_torch.parallel import mesh as TMESH
from test_torch_port_collectives import no_launcher_env, run_world  # noqa: F401

DCN, ICI = 2, 2
N = DCN * ICI
AX = ("dcn", "hvd")
JAX_ATOL = 2e-6
# One quantization step of a block, relative to the block's largest
# |value|: int8 rounds to 1/127 of it, fp8_e4m3 keeps 3 mantissa bits.
STEP = {"int8": 1 / 127, "fp8_e4m3": 2 ** -3}

# Per-rank inputs: the worker and the tests build them from the same seeds.
INPUTS = r'''
import numpy as np


def leaf(r, n=7, seed=0, scale=1.0):
    return (np.random.RandomState(seed + 10 * r).randn(n) * scale).astype(
        np.float32)


def ints(r, n=9, seed=3):
    return np.random.RandomState(seed + 10 * r).randint(-50, 50, n).astype(
        np.int32)


def tree(r):
    rng = np.random.RandomState(2 + 10 * r)
    return {"w": rng.randn(3, 3).astype(np.float32),
            "b": rng.randn(4).astype(np.float32),
            "step": np.full((2,), r + 1, np.int32)}


def integral(r, n):
    return np.round(np.random.RandomState(21 + 10 * r).randn(n) * 4).astype(
        np.float32)


SHAPES = [(6, 5), (5,), (3, 4, 2), (9,)]


def grads(r, t):
    """Integer-valued gradients of rank r at step t."""
    rng = np.random.RandomState(100 * t + r)
    return [np.round(rng.randn(*s) * 8).astype(np.float32) for s in SHAPES]
'''
_NS = {}
exec(INPUTS, _NS)  # noqa: S102 — the shared seeds, as the workers run them

WORKER = INPUTS + r'''
import os, sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import hierarchical as H
from horovod_tpu_torch.parallel.data_parallel import reduce_gradient_buckets
from horovod_tpu_torch.parallel.mesh import create_hierarchical_mesh

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
mesh = create_hierarchical_mesh(2, 2)
res = {"shape": dict(mesh.shape), "coords": dict(mesh.coords),
       "sets": {a: list(ps.ranks) for a, ps in mesh.sets.items()}}
T = torch.from_numpy

res["leaf_avg"] = H.hierarchical_reduce_leaf(T(leaf(r)), mesh, average=True)
res["leaf_sum5"] = H.hierarchical_reduce_leaf(
    torch.full((5,), float(r + 1)), mesh, average=False)
res["int_sum"] = H.hierarchical_reduce_leaf(T(ints(r)), mesh, average=False)
res["int_avg"] = H.hierarchical_reduce_leaf(T(ints(r)), mesh, average=True)
tr = {k: T(v) for k, v in tree(r).items()}
res["tree"] = H.hierarchical_allreduce(tr, mesh)
res["tree_sum"] = H.hierarchical_allreduce(tr, mesh, average=False,
                                           fusion_threshold_bytes=20,
                                           bucket_order="reverse")
big = T(integral(r, 2 * 2 * 6))
shard = H.hierarchical_reduce_scatter(big, mesh)
res["rs"] = shard
res["rs_ag"] = H.hierarchical_all_gather(shard, mesh)
fl = T(leaf(r, 2 * 2 * 8, seed=22))
for w in ("bf16", "fp16", "int8"):
    res["rs_ag", w] = H.hierarchical_all_gather(
        H.hierarchical_reduce_scatter(fl, mesh, dcn_wire=w), mesh)
for w in ("int8", "fp8_e4m3"):
    res["wire_leaf", w] = H.hierarchical_allreduce(
        {"g": T(leaf(r, 300, seed=3, scale=50.0))}, mesh, dcn_wire=w)["g"]

# Error feedback on the dcn leg: 8 steps, the leaf and the tree.
x = T(leaf(r, 300, seed=9, scale=50.0))
e = torch.zeros(H.dcn_shard_size(300, 2))
res["ef"] = []
for _ in range(8):
    o, e = H.hierarchical_reduce_leaf(x, mesh, average=True, dcn_wire="int8",
                                      error_feedback=e)
    res["ef"].append((o, e.clone()))
mixed = {"w": T(leaf(r, 200, seed=11, scale=20.0)),
         "b": T(leaf(r, 40, seed=12, scale=20.0)),
         "step": torch.zeros(2, dtype=torch.int32)}
ef = H.hierarchical_error_feedback_init(mixed, 2, dcn_wire="int8")
res["tree_ef_len"] = len(ef)
res["tree_ef"] = []
for _ in range(8):
    out, ef = H.hierarchical_allreduce(mixed, mesh, dcn_wire="int8",
                                       error_feedback_state=ef)
    res["tree_ef"].append(out["w"])

# The env's routes.
g = T(leaf(r, 256, seed=7, scale=30.0))
gi = T(np.full((64,), 1000, np.int32))
res["maybe_off"] = H.maybe_hierarchical(g, mesh, "Average")
os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
res["maybe_on"] = H.maybe_hierarchical(g, mesh, "Average")
res["maybe_max"] = H.maybe_hierarchical(g, mesh, "Max")
res["buckets_on"] = reduce_gradient_buckets(
    [g, gi], axis_name=mesh, fusion_threshold_bytes=512)[0]
os.environ["HOROVOD_HIERARCHICAL_DCN_WIRE"] = "int8"
res["env_wire"] = H.hierarchical_allreduce({"g": g}, mesh)["g"]
res["env_wire_sum"] = H.maybe_hierarchical(g, mesh, "Sum")
res["env_wire_int"] = H.hierarchical_allreduce({"c": gi}, mesh,
                                               average=False)["c"]
res["buckets_wire"] = reduce_gradient_buckets([g, gi], axis_name=mesh)[0]
os.environ.pop("HOROVOD_HIERARCHICAL_DCN_WIRE")
os.environ.pop("HOROVOD_HIERARCHICAL_ALLREDUCE")
res["buckets_off"] = reduce_gradient_buckets(
    [g, gi], axis_name=mesh, fusion_threshold_bytes=512)[0]

# The refusals (each before any collective, on every rank).
res["refused"] = {}
def refuse(name, fn):
    try:
        fn()
    except Exception as exc:
        res["refused"][name] = f"{type(exc).__name__}: {exc}"
refuse("ef_no_wire", lambda: H.hierarchical_reduce_leaf(
    torch.zeros(300), mesh, average=True, error_feedback=torch.zeros(150)))
refuse("ef_fewer", lambda: H.hierarchical_allreduce(
    {"w": torch.ones(300)}, mesh, dcn_wire="int8", error_feedback_state=[]))
refuse("ef_more", lambda: H.hierarchical_allreduce(
    {"w": torch.ones(300)}, mesh, dcn_wire="int8",
    error_feedback_state=[torch.zeros(150), torch.zeros(1)]))
refuse("unknown_wire", lambda: H.hierarchical_reduce_scatter(
    torch.zeros(4), mesh, dcn_wire="int9"))
refuse("non_divisible", lambda: H.hierarchical_reduce_scatter(
    torch.zeros(5), mesh))
ps = hvd.add_process_set([0, 3])
refuse("subset", lambda: reduce_gradient_buckets(
    [torch.ones(2)], process_set=ps, axis_name=mesh))
refuse("subset_opt", lambda: hvd.DistributedOptimizer(
    torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=1.0),
    process_set=ps, axis_name=mesh))
refuse("coop_ag", lambda: hvd.DistributedOptimizer(
    torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=1.0),
    zero_stage=1, allgather_wire="int8", axis_name=mesh))
refuse("coop_gather", lambda: hvd.zero3_placement(
    [torch.zeros(4)], gather_wire="int8", axis_name=mesh))
refuse("not_a_pair", lambda: reduce_gradient_buckets(
    [torch.ones(2)], axis_name=("dcn", "hvd")))
hvd.remove_process_set(ps)


# The optimizer over the pair, against the flat path.
def run(stage=0, axis=None, steps=3, bpps=1, env=None, **kw):
    for k, v in (env or {}).items():
        os.environ[k] = v
    params = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=1.0), zero_stage=stage, axis_name=axis,
        backward_passes_per_step=bpps, fusion_threshold_bytes=200, **kw)
    placement = rows = None
    if stage == 3:
        placement = hvd.zero3_placement(params, axis_name=axis,
                                        fusion_threshold_bytes=200)
        rows = placement.shard(params)
        placement.bind(params)
    out = []
    for t in range(steps * bpps):
        if placement is not None:
            with torch.no_grad():
                placement.gather(rows)
        for p, gv in zip(params, grads(r, t)):  # as autograd accumulates
            p.grad = T(gv) if p.grad is None else p.grad + T(gv)
        u = opt.step()
        if placement is not None:
            rows = placement.apply_updates(rows, u)
            with torch.no_grad():
                placement.gather(rows)
        if (t + 1) % bpps == 0:
            out.append([p.detach().clone() for p in params])
            opt.zero_grad(set_to_none=True)
        if placement is not None:
            placement.release()
    for k in (env or {}):
        os.environ.pop(k, None)
    return out


HIER = {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"}
res["opt"] = {
    "flat0": run(0),
    "hier0": run(0, mesh, env=HIER),
    "hier0_fused": run(0, mesh, env=HIER, fused_apply=True),
    "flat0_k2": run(0, bpps=2),
    "hier0_early_k2": run(0, mesh, bpps=2, env=HIER, early_reduction=True),
    "hier1_early_k2": run(1, mesh, bpps=2, env=HIER, early_reduction=True),
}
for s in (1, 2, 3):
    res["opt"]["flat%d" % s] = run(s)
    res["opt"]["hier%d" % s] = run(s, mesh)
res["opt"]["hier2_k2"] = run(2, mesh, bpps=2)
res["opt"]["hier3_agf"] = run(3, mesh, env={"HOROVOD_SHARD_AG_FUSION": "1"})
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("hier"), N, WORKER, timeout=300)


@pytest.fixture(scope="module")
def hmesh():
    return jax_mesh(DCN, ICI, devices=jax.devices()[:N])


def _per_rank(fn, hmesh, *stacks):
    """fn over the hierarchical mesh, each device's output kept (device
    r = rank r: the mesh reshapes the devices row-major)."""
    sm = shard_map(
        lambda *xs: jax.tree_util.tree_map(
            lambda o: o[None], fn(*[x[0] for x in xs])),
        mesh=hmesh, in_specs=tuple(P(AX) for _ in stacks),
        out_specs=P(AX), check_vma=False)
    return jax.tree_util.tree_map(np.asarray, jax.jit(sm)(
        *[jnp.asarray(np.stack(s)) for s in stacks]))


def _stack(f, *a):
    return [f(r, *a) for r in range(N)]


def _bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), np.abs(
        got.astype(np.float64) - want).max()


def test_mesh_matches_the_jax_mesh(world, hmesh):
    ids = np.vectorize(lambda d: d.id)(hmesh.devices)
    for r, d in enumerate(world):
        assert d["shape"] == dict(hmesh.shape) == {"dcn": 2, "hvd": 2}
        where = tuple(int(c[0]) for c in np.nonzero(ids == r))
        assert (d["coords"]["dcn"], d["coords"]["hvd"]) == where
        assert d["sets"]["hvd"] == sorted(ids[where[0], :].tolist())
        assert d["sets"]["dcn"] == sorted(ids[:, where[1]].tolist())


@pytest.mark.parametrize("key,make,average", [
    ("leaf_avg", lambda r: _NS["leaf"](r), True),
    ("leaf_sum5", lambda r: np.full((5,), r + 1, np.float32), False),
    ("int_sum", lambda r: _NS["ints"](r), False),
    ("int_avg", lambda r: _NS["ints"](r), True),
])
def test_leaf_is_bitwise_jax(world, hmesh, key, make, average):
    """Padding (7 and 5 over ici = 2), Sum and Average, integer leaves
    (Average divides at f32 and casts back)."""
    want = _per_rank(lambda x: JH.hierarchical_reduce_leaf(
        x, "dcn", "hvd", average), hmesh, _stack(make))
    for r, d in enumerate(world):
        _bitwise(d[key], want[r])
    if key == "leaf_sum5":
        assert float(world[0][key][0]) == sum(range(1, N + 1))


@pytest.mark.parametrize("average,kw", [
    (True, {}), (False, dict(fusion_threshold_bytes=20,
                             bucket_order="reverse"))],
    ids=["avg", "sum_buckets"])
def test_tree_is_bitwise_jax(world, hmesh, average, kw):
    trees = _stack(_NS["tree"])
    stacks = [[t[k] for t in trees] for k in ("w", "b", "step")]
    want = _per_rank(lambda w, b, s: JH.hierarchical_allreduce(
        {"w": w, "b": b, "step": s}, "dcn", "hvd", average=average, **kw),
        hmesh, *stacks)
    key = "tree" if average else "tree_sum"
    for r, d in enumerate(world):
        for k in ("w", "b", "step"):
            _bitwise(d[key][k], want[k][r])


def test_reduce_scatter_and_allgather_are_bitwise_jax(world, hmesh):
    """Dcn-major ownership: rank (d, i) holds segment d*2 + i of the sum,
    and the round trip gives every rank the whole sum."""
    xs = _stack(_NS["integral"], 24)

    def fn(x):
        s = JH.hierarchical_reduce_scatter(x, "dcn", "hvd")
        return s, JH.hierarchical_all_gather(s, "dcn", "hvd")

    shards, fulls = _per_rank(fn, hmesh, xs)
    total = np.sum(np.stack(xs), axis=0)
    for r, d in enumerate(world):
        _bitwise(d["rs"], shards[r])
        _bitwise(d["rs_ag"], fulls[r])
        np.testing.assert_array_equal(d["rs"].numpy(),
                                      total[r * 6:(r + 1) * 6])
        np.testing.assert_array_equal(d["rs_ag"].numpy(), total)


@pytest.mark.parametrize("wire", ["bf16", "fp16", "int8"])
def test_reduce_scatter_on_a_dcn_wire_matches_jax(world, hmesh, wire):
    """A cast dcn wire sums two cast addends (bitwise); the cooperative
    one rides the two-rank quantized reduce-scatter (each rank's own
    segment never encoded; one encode of the other's)."""
    xs = _stack(_NS["leaf"], 32, 22)
    want = _per_rank(lambda x: JH.hierarchical_all_gather(
        JH.hierarchical_reduce_scatter(x, "dcn", "hvd", dcn_wire=wire),
        "dcn", "hvd"), hmesh, xs)
    exact = np.sum(np.stack(xs), axis=0)
    for r, d in enumerate(world):
        got = d["rs_ag", wire].numpy()
        if wire != "int8":
            _bitwise(got, want[r])
            continue
        tol = JAX_ATOL * np.abs(exact).max() + STEP[wire] * np.abs(
            np.stack(xs)).max() * 2
        assert np.abs(got - want[r]).max() <= tol
        assert 0 < np.abs(got - exact).max() < np.abs(exact).max() / 10


@pytest.mark.parametrize("wire", ["int8", "fp8_e4m3"])
def test_quantized_dcn_wire_matches_jax(world, hmesh, wire):
    xs = _stack(_NS["leaf"], 300, 3, 50.0)
    want = _per_rank(lambda x: JH.hierarchical_allreduce(
        {"g": x}, "dcn", "hvd", average=True, dcn_wire=wire)["g"], hmesh, xs)
    exact = np.mean(np.stack(xs), axis=0)
    tol = JAX_ATOL * np.abs(exact).max() + STEP[wire] * np.abs(
        np.stack(xs)).max() * 2 / N
    for r, d in enumerate(world):
        got = d["wire_leaf", wire].numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - want[r]).max() <= tol
        # JAX's own bound (tests/test_hierarchical.py:159).
        assert np.abs(got - exact).max() < np.abs(np.stack(xs)).max() / 25
    assert all(torch.equal(d["wire_leaf", wire], world[0]["wire_leaf", wire])
               for d in world)


def test_error_feedback_telescopes_as_jax(world, hmesh):
    """Eight steps of the int8 dcn leg with the residual carried: each
    step's output and residual held to JAX's, and the running mean of
    the outputs converging on the exact mean (JAX's bound, 0.35 of one
    step's error)."""
    xs = _stack(_NS["leaf"], 300, 9, 50.0)
    shard = JH.dcn_shard_size(300, ICI)
    fn = jax.jit(shard_map(
        lambda x, e: tuple(o[None] for o in JH.hierarchical_reduce_leaf(
            x[0], "dcn", "hvd", average=True, dcn_wire="int8",
            error_feedback=e[0])),
        mesh=hmesh, in_specs=(P(AX), P(AX)), out_specs=(P(AX), P(AX)),
        check_vma=False))
    e = jnp.zeros((N, shard), jnp.float32)
    exact = np.mean(np.stack(xs), axis=0)
    outs = []
    scale = np.abs(np.stack(xs)).max()
    for t in range(8):
        o, e = fn(jnp.asarray(np.stack(xs)), e)
        o, en = np.asarray(o), np.asarray(e)
        for r, d in enumerate(world):
            got, resid = d["ef"][t]
            assert np.abs(got.numpy() - o[r]).max() <= \
                JAX_ATOL * scale + STEP["int8"] * scale * 2 / N
            assert np.abs(resid.numpy() - en[r]).max() <= \
                JAX_ATOL * scale + STEP["int8"] * scale * 2
        outs.append(world[0]["ef"][t][0].numpy())
    single = np.abs(outs[0] - exact).mean()
    assert np.abs(np.mean(outs, 0) - exact).mean() < single * 0.35


def test_tree_error_feedback_skips_integers_and_telescopes(world):
    assert all(d["tree_ef_len"] == 1 for d in world)  # one f32 buffer
    gs = _stack(_NS["leaf"], 200, 11, 20.0)
    exact = np.mean(np.stack(gs), axis=0)
    outs = [o.numpy() for o in world[0]["tree_ef"]]
    single = np.abs(outs[0] - exact).mean()
    assert np.abs(np.mean(outs, 0) - exact).mean() < single * 0.4


def test_env_routes_as_jax(world, hmesh):
    """HOROVOD_HIERARCHICAL_ALLREDUCE routes Average / Sum on the pair
    (Max stays flat: None); HOROVOD_HIERARCHICAL_DCN_WIRE engages on
    float leaves under Average only; integer leaves sum exactly."""
    xs = _stack(_NS["leaf"], 256, 7, 30.0)
    exact = _per_rank(lambda x: JH.hierarchical_reduce_leaf(
        x, "dcn", "hvd", True), hmesh, xs)
    wire = _per_rank(lambda x: JH.hierarchical_reduce_leaf(
        x, "dcn", "hvd", True, dcn_wire="int8"), hmesh, xs)
    total = _per_rank(lambda x: JH.hierarchical_reduce_leaf(
        x, "dcn", "hvd", False), hmesh, xs)
    for r, d in enumerate(world):
        assert d["maybe_off"] is None and d["maybe_max"] is None
        _bitwise(d["maybe_on"], exact[r])
        _bitwise(d["env_wire_sum"], total[r])
        got = d["env_wire"].numpy()
        assert 1e-6 < np.abs(got - exact[r]).max() < 1.0
        tol = JAX_ATOL * 30 + STEP["int8"] * np.abs(np.stack(xs)).max() / 2
        assert np.abs(got - wire[r]).max() <= tol
        np.testing.assert_array_equal(d["env_wire_int"].numpy(),
                                      np.full((64,), 1000 * N, np.int32))
        # The gradient reduction: hierarchical (bitwise the leaf) with
        # the flag, on the env's wire with both, flat without the flag.
        assert [len(i) for i, _ in d["buckets_on"]] == [1, 1]
        _bitwise(_leaf_out(d["buckets_on"], 0), exact[r])
        assert torch.equal(_leaf_out(d["buckets_on"], 1),
                           torch.full((64,), 1000, dtype=torch.int32))
        assert torch.equal(_leaf_out(d["buckets_wire"], 0), d["env_wire"])
        assert torch.equal(_leaf_out(d["buckets_wire"], 1),
                           torch.full((64,), 1000, dtype=torch.int32))
        np.testing.assert_allclose(_leaf_out(d["buckets_off"], 0).numpy(),
                                   exact[r], rtol=1e-6, atol=1e-6)


def _leaf_out(results, i):
    """Leaf i's reduced value in `reduce_gradient_buckets`' results."""
    for idxs, outs in results:
        if i in idxs:
            return outs[list(idxs).index(i)]
    raise KeyError(i)


@pytest.mark.parametrize("name,match", [
    ("ef_no_wire", "ValueError: error_feedback requires a quantized "
     "dcn_wire"),
    ("ef_fewer", "ValueError: error_feedback_state has fewer entries"),
    ("ef_more", "ValueError: error_feedback_state has more entries"),
    ("unknown_wire", "HorovodTpuError: unknown wire format 'int9'"),
    ("non_divisible", "HorovodTpuError: hierarchical_reduce_scatter needs "
     "a flat buffer divisible by n_ici*n_dcn (4)"),
    ("subset", "HorovodTpuError: process_set with a hierarchical "
     "axis_name requires the 'hvd' axis to span all 4 ranks"),
    ("subset_opt", "HorovodTpuError: process_set with a hierarchical"),
    ("coop_ag", "ValueError: allgather_wire='int8' rides the ring payload "
     "gather, which spans ONE named axis"),
    ("coop_gather", "ValueError: gather_wire='int8' rides the ring "
     "payload gather"),
    ("not_a_pair", "ValueError: axis_name takes a "
     "create_hierarchical_mesh"),
])
def test_refusals(world, name, match):
    for d in world:
        assert d["refused"][name].startswith(match), d["refused"][name]


def test_refusals_carry_jax_messages(hmesh):
    """The JAX package's own words for the same refusals."""
    with pytest.raises(ValueError, match="quantized dcn_wire"):
        _per_rank(lambda x: JH.hierarchical_reduce_leaf(
            x, "dcn", "hvd", True, error_feedback=jnp.zeros((150,)))[0],
            hmesh, [np.zeros(300, np.float32)] * N)
    with pytest.raises(Exception, match="divisible by n_ici"):
        _per_rank(lambda x: JH.hierarchical_reduce_scatter(
            x, "dcn", "hvd"), hmesh, [np.zeros(5, np.float32)] * N)


def test_mesh_refusals_in_one_process():
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        with pytest.raises(HorovodTpuError, match="not divisible into 3"):
            TMESH.create_hierarchical_mesh(3)
        with pytest.raises(HorovodTpuError, match="dcn=1 x ici=2 != 1"):
            TMESH.create_hierarchical_mesh(1, 2)
        m = TMESH.create_hierarchical_mesh(1)
        assert m.shape == {"dcn": 1, "hvd": 1} and TMESH.is_hierarchical(m)
        assert not TMESH.is_hierarchical(TMESH.create_hybrid_mesh())
        # A one-rank pair reduces nothing: the leaf comes back (Sum).
        x = torch.arange(5.0)
        assert torch.equal(TH.hierarchical_reduce_leaf(x, m, False), x)
        assert TH.dcn_shard_size(7, 2) == JH.dcn_shard_size(7, 2) == 4
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("got,want", [
    ("hier0", "flat0"), ("hier0_fused", "flat0"),
    ("hier0_early_k2", "flat0_k2"), ("hier1_early_k2", "flat0_k2"),
    ("hier1", "flat1"), ("hier2", "flat2"), ("hier3", "flat3"),
    ("hier2_k2", "flat0_k2"), ("hier3_agf", "flat3"), ("flat3", "flat0"),
])
def test_optimizer_over_the_pair_is_bitwise_the_flat_path(world, got, want):
    """Integer-valued SGD(lr=1) trajectories: the pair at stages 0-3
    (stage 0 under the flag, with fused_apply and early_reduction; the
    fused parameter allgather at stage 3) bitwise the flat replicated
    path, every step, on every rank."""
    for d in world:
        for a, b in zip(d["opt"][got], d["opt"][want]):
            assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(a, b)), (got, want)
    # Each step moved the parameters by minus the mean gradient.
    steps = world[0]["opt"]["flat0"]
    mean0 = [np.mean([_NS["grads"](r, 0)[k] for r in range(N)], axis=0)
             for k in range(len(_NS["SHAPES"]))]
    for p, m in zip(steps[0], mean0):
        np.testing.assert_array_equal(p.numpy(), -m)
