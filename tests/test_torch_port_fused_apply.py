"""Port parity: `DistributedOptimizer(fused_apply=, early_reduction=)` at
stage 0, the guard under both, and the sharded optimizer's fused
parameter allgather (HOROVOD_SHARD_AG_FUSION), against the JAX package's
`DistributedOptimizer` (parallel/optimizer.py `_fused_update` :873,
`update_fn` :1191, the `pending` gather :807-830).

One world of two gloo ranks runs every case once and saves each pass:

- fused_apply bitwise the unfused stage 0 on integer-valued SGD (with
  momentum) trajectories, with the guard at the static scale too (JAX
  tests/test_optimizer.py:227-266, :370-380);
- AdamW under fused_apply against JAX's fused_apply with optax.adamw on
  two CPU devices, the same gradients (floats), within ADAM_RTOL of each
  parameter's largest value: torch's AdamW divides by
  sqrt(v) / sqrt(1 - b2^t) + eps where optax divides by sqrt(v / (1 -
  b2^t)) + eps, and applies the weight decay as its own product, so the
  two round apart in the last bits of every step;
- early_reduction at K = 2 and 3 (fused and not) bitwise the
  accumulate-then-reduce path, on integer gradients that are multiples of
  n·K (every sum, mean and product by 1/K then exact);
- the guard: a NaN in one pass of a K = 2 step (early reduction, fused
  and not) skips that step's apply on every rank, the loss scale, the
  counters and `pending_flag` bitwise JAX's at every sync pass and the
  parameters within 1e-6 (JAX tests/test_guard.py:207, :290-330); a NaN
  in the last bucket under fused_apply with AdamW leaves bucket 0's
  parameters and state as they were;
- the fused parameter allgather at stages 1 and 3 (the exact wire and
  bf16) bitwise the per-group gathers.

In one process: the partition drift and the refusals, with JAX's
messages, and `regroup` against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu import guard as JG
import horovod_tpu_torch as hvd
from test_torch_port_collectives import no_launcher_env, run_world  # noqa: F401

N = 2
ADAM_RTOL = 1e-5
THRESHOLD = 200

INPUTS = r'''
import numpy as np

SHAPES = [(6, 5), (5,), (3, 4, 2), (9,), (16,)]
THRESHOLD = 200
ADAM = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, wd=1e-4)


def igrads(r, t, mult=1):
    """Integer-valued gradients of rank r at pass t, multiples of mult."""
    rng = np.random.RandomState(100 * t + r)
    return [(rng.randint(-20, 20, s) * mult).astype(np.float32)
            for s in SHAPES]


def fgrads(r, t):
    rng = np.random.RandomState(500 + 100 * t + r)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def params0():
    rng = np.random.RandomState(7)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]
'''
_NS = {}
exec(INPUTS, _NS)  # noqa: S102 — the shared seeds, as the workers run them

WORKER = INPUTS + r'''
import hashlib, os, sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import guard as G

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
T = torch.from_numpy


def sha(opt, params):
    h = hashlib.sha256()
    for p in params:
        for k, v in sorted(opt._opt.state.get(p, {}).items()):
            if isinstance(v, torch.Tensor):
                h.update(v.detach().float().numpy().tobytes())
    return h.hexdigest()


def run(kind="sgd", passes=4, bpps=1, grad=igrads, mult=1, nan=None,
        stage=0, env=None, **kw):
    """Per pass: the parameters, per-bucket state SHAs, the guard state.
    `nan`: (pass, rank, leaf) poisoned."""
    for k, v in (env or {}).items():
        os.environ[k] = v
    params = [torch.nn.Parameter(T(p)) for p in params0()]
    if kind == "sgd":
        inner = torch.optim.SGD(params, lr=1.0, momentum=0.5)
    elif kind == "sgd01":
        inner = torch.optim.SGD(params, lr=0.1)
    else:
        inner = torch.optim.AdamW(params, lr=ADAM["lr"],
                                  betas=(ADAM["b1"], ADAM["b2"]),
                                  eps=ADAM["eps"], weight_decay=ADAM["wd"])
    opt = hvd.DistributedOptimizer(inner, backward_passes_per_step=bpps,
                                   fusion_threshold_bytes=THRESHOLD,
                                   zero_stage=stage, **kw)
    parts = getattr(opt, "_parts", None)
    placement = rows = None
    if stage == 3:
        placement = hvd.zero3_placement(params,
                                        fusion_threshold_bytes=THRESHOLD)
        rows = placement.shard(params)
        placement.bind(params)
    out = {"parts": parts, "passes": []}
    for t in range(passes):
        if placement is not None:
            with torch.no_grad():
                placement.gather(rows)
        gs = grad(r, t, mult) if grad is igrads else grad(r, t)
        if nan is not None and nan[0] == t and nan[1] == r:
            gs[nan[2]].reshape(-1)[0] = np.nan
        for p, g in zip(params, gs):  # as autograd accumulates
            p.grad = T(g) if p.grad is None else p.grad + T(g)
        before = [p.detach().clone() for p in params]
        sha_before = [sha(opt, [params[i] for i in b]) for b in parts or []]
        u = opt.step()
        if placement is not None:
            rows = placement.apply_updates(rows, u)
            with torch.no_grad():
                placement.gather(rows)
        rec = {"params": [p.detach().clone() for p in params],
               "before": before, "sha_before": sha_before,
               "sha": [sha(opt, [params[i] for i in b]) for b in parts or []]}
        gst = getattr(opt, "guard_state", None)
        if gst is not None:
            rec["guard"] = [f.clone() for f in gst]
        out["passes"].append(rec)
        if (t + 1) % bpps == 0:
            opt.zero_grad(set_to_none=True)
        if placement is not None:
            placement.release()
    for k in (env or {}):
        os.environ.pop(k, None)
    return out


res = {}
static = G.DynamicLossScale(init_scale=1.0, dynamic=False)
res["sgd_flat"] = run()
res["sgd_fused"] = run(fused_apply=True)
res["sgd_fused_static"] = run(fused_apply=True, guard=static)
res["adam_flat"] = run("adam", grad=fgrads)
res["adam_fused"] = run("adam", grad=fgrads, fused_apply=True)
for k in (2, 3):
    res["acc", k] = run(passes=3 * k, bpps=k, mult=n * k)
    res["early", k] = run(passes=3 * k, bpps=k, mult=n * k,
                          early_reduction=True)
    res["early_fused", k] = run(passes=3 * k, bpps=k, mult=n * k,
                                early_reduction=True, fused_apply=True)
for fused in (False, True):
    scaler = G.DynamicLossScale(1024.0, growth_interval=2)
    res["early_guard", fused] = run(
        "sgd01", passes=6, bpps=2, nan=(2, 1, 1), guard=scaler,
        early_reduction=True, fused_apply=fused)
last = res["sgd_fused"]["parts"][-1][0]
res["nan_leaf"] = last
res["fused_guard_nan"] = run(
    "adam", grad=fgrads, nan=(2, 1, last), fused_apply=True,
    guard=G.DynamicLossScale(1024.0, growth_interval=2))
for stage in (1, 3):
    for wire in (None, "bf16"):
        for agf in ("0", "1"):
            res["agf", stage, wire, agf] = run(
                "adam", grad=fgrads, passes=3, stage=stage,
                allgather_wire=wire, env={"HOROVOD_SHARD_AG_FUSION": agf})
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("fused"), N, WORKER, timeout=300)


def _equal(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def _jax_run(opt, grads_fn, passes, nan=None):
    """JAX's DistributedOptimizer over two CPU devices (device r = rank
    r): the parameters and guard state after each pass."""
    mesh = Mesh(np.asarray(jax.devices()[:N]), (jhvd.GLOBAL_AXIS,))
    L = len(_NS["SHAPES"])

    def step(ps, st, *gs):
        u, st = opt.update([g[0] for g in gs], st, ps)
        return optax.apply_updates(ps, u), st

    sm = jax.jit(shard_map(
        step, mesh=mesh, in_specs=(P(), P()) + (P(jhvd.GLOBAL_AXIS),) * L,
        out_specs=(P(), P()), check_vma=False))
    ps = [jnp.asarray(p) for p in _NS["params0"]()]
    st = opt.init(ps)
    out = []
    for t in range(passes):
        per = [grads_fn(r, t) for r in range(N)]
        if nan is not None and nan[0] == t:
            per[nan[1]][nan[2]].reshape(-1)[0] = np.nan
        stacks = [jnp.asarray(np.stack([per[r][k] for r in range(N)]))
                  for k in range(L)]
        ps, st = sm(ps, st, *stacks)
        out.append(([np.asarray(p) for p in ps], st))
    return out


def test_fused_apply_is_bitwise_the_unfused_step(world):
    """SGD with momentum on integer gradients: every pass bitwise, with
    the guard at the static scale too; several buckets, each its own
    local optimizer."""
    for d in world:
        assert len(d["sgd_fused"]["parts"]) > 1
        for k in ("sgd_fused", "sgd_fused_static"):
            for a, b in zip(d[k]["passes"], d["sgd_flat"]["passes"]):
                assert _equal(a["params"], b["params"]), k
        for a, b in zip(d["adam_fused"]["passes"], d["adam_flat"]["passes"]):
            assert _equal(a["params"], b["params"])
    assert _equal(world[0]["adam_fused"]["passes"][-1]["params"],
                  world[1]["adam_fused"]["passes"][-1]["params"])


def test_fused_adamw_matches_jax(world):
    a = _NS["ADAM"]
    opt = jhvd.DistributedOptimizer(
        optax.adamw(a["lr"], b1=a["b1"], b2=a["b2"], eps=a["eps"],
                    weight_decay=a["wd"]),
        fused_apply=True, fusion_threshold_bytes=THRESHOLD)
    want = _jax_run(opt, _NS["fgrads"], 4)
    for d in world:
        for rec, (jps, _) in zip(d["adam_fused"]["passes"], want):
            for got, w in zip(rec["params"], jps):
                assert np.abs(got.numpy() - w).max() <= \
                    ADAM_RTOL * np.abs(w).max()


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("kind", ["early", "early_fused"])
def test_early_reduction_is_bitwise_accumulate_then_reduce(world, k, kind):
    for d in world:
        acc, got = d["acc", k]["passes"], d[kind, k]["passes"]
        for t in range(k - 1, 3 * k, k):  # the sync passes
            assert _equal(got[t]["params"], acc[t]["params"]), (kind, k, t)
        # The accumulation passes leave the parameters alone.
        assert _equal(got[0]["params"], got[0]["before"])


@pytest.mark.parametrize("fused", [False, True])
def test_nan_in_one_pass_skips_the_step_as_jax(world, fused):
    """K = 2, early reduction, rank 1's NaN in the first pass of the
    second step: that step's apply is skipped on both ranks, the scale
    halves and `pending_flag` is cleared, as JAX's guarded
    early-reduction step does."""
    scaler = JG.DynamicLossScale(1024.0, growth_interval=2)
    opt = jhvd.DistributedOptimizer(
        optax.sgd(0.1), guard=scaler, early_reduction=True,
        backward_passes_per_step=2, fused_apply=fused,
        fusion_threshold_bytes=THRESHOLD)
    want = _jax_run(opt, lambda r, t: _NS["igrads"](r, t), 6,
                    nan=(2, 1, 1))
    for d in world:
        tr = d["early_guard", fused]["passes"]
        for t in (1, 3, 5):  # the sync passes
            jps, jst = want[t]
            g = tr[t]["guard"]
            for name, i in (("loss_scale", 0), ("good_steps", 1),
                            ("nonfinite_steps", 2), ("pending_flag", 4)):
                assert g[i].numpy().tobytes() == np.asarray(
                    getattr(jst.guard, name)).tobytes(), (t, name)
            for got, w in zip(tr[t]["params"], jps):
                np.testing.assert_allclose(got.numpy(), w, rtol=1e-6,
                                           atol=1e-6)
        assert float(tr[3]["guard"][0]) == 512.0
        assert _equal(tr[3]["params"], tr[1]["params"])  # skipped
        assert not _equal(tr[5]["params"], tr[3]["params"])
        # The poisoned pass folded its flag into pending_flag.
        assert float(tr[2]["guard"][4]) == 1.0


def test_nan_in_the_last_bucket_leaves_bucket_0_untouched(world):
    """fused_apply + AdamW + the guard: rank 1's NaN in the last bucket
    at step 2 leaves every bucket's parameters and AdamW state (bucket 0
    included, which a bucket-by-bucket apply would already have stepped)
    as they were, on both ranks."""
    for d in world:
        tr = d["fused_guard_nan"]["passes"]
        parts = d["fused_guard_nan"]["parts"]
        assert d["nan_leaf"] in parts[-1] and d["nan_leaf"] not in parts[0]
        assert _equal(tr[2]["params"], tr[2]["before"])
        assert tr[2]["sha"] == tr[2]["sha_before"]
        assert float(tr[2]["guard"][0]) == float(tr[1]["guard"][0]) / 2
        assert int(tr[2]["guard"][2]) == 1
        assert not _equal(tr[3]["params"], tr[3]["before"])
        assert tr[3]["sha"][0] != tr[3]["sha_before"][0]


@pytest.mark.parametrize("stage", [1, 3])
@pytest.mark.parametrize("wire", [None, "bf16"])
def test_fused_allgather_is_bitwise_the_per_group_gathers(world, stage,
                                                          wire):
    for d in world:
        off, on = d["agf", stage, wire, "0"], d["agf", stage, wire, "1"]
        for a, b in zip(off["passes"], on["passes"]):
            assert _equal(a["params"], b["params"])
    assert _equal(world[0]["agf", stage, wire, "1"]["passes"][-1]["params"],
                  world[1]["agf", stage, wire, "1"]["passes"][-1]["params"])


def _refusal(make):
    try:
        make()
    except ValueError as e:
        return str(e)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("kw", [
    dict(op="Adasum", fused_apply=True),
    dict(op="Adasum", early_reduction=True),
    dict(zero_stage=1, fused_apply=True),
])
def test_refusals_carry_jax_messages(kw):
    def args(mod):
        a = dict(kw)
        if "op" in a:
            a["op"] = getattr(mod, a["op"])
        return a

    want = _refusal(lambda: jhvd.DistributedOptimizer(optax.sgd(0.1),
                                                      **args(jhvd)))
    hvd.init(device="cpu")
    try:
        w = torch.nn.Parameter(torch.zeros(3))
        got = _refusal(lambda: hvd.DistributedOptimizer(
            torch.optim.SGD([w], lr=0.1), **args(hvd)))
    finally:
        hvd.shutdown()
    assert got == want


def test_partition_drift_raises(monkeypatch):
    """The tuner (or the env) moving the threshold under a fused_apply
    optimizer: the next step raises with JAX's words."""
    hvd.init(device="cpu")
    try:
        ps = [torch.nn.Parameter(torch.zeros(s)) for s in _NS["SHAPES"]]
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1000000")
        opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=0.1),
                                       fused_apply=True)
        assert len(opt.bucket_optimizers) == 1
        for p in ps:
            p.grad = torch.ones_like(p)
        opt.step()
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "64")
        for p in ps:
            p.grad = torch.ones_like(p)
        with pytest.raises(ValueError, match="fused_apply bucket partition "
                           r"changed since init \(1 -> \d+ buckets\)"):
            opt.step()
    finally:
        hvd.shutdown()


def test_fused_apply_state_is_the_wrapped_optimizer_s():
    """Each bucket's optimizer writes the wrapped optimizer's `state`
    (so its state_dict covers every bucket) with each param group's own
    hyperparameters, read at every step."""
    hvd.init(device="cpu")
    try:
        a, b = torch.nn.Parameter(torch.zeros(4)), torch.nn.Parameter(
            torch.zeros(300))
        inner = torch.optim.AdamW([{"params": [a], "weight_decay": 0.0},
                                   {"params": [b]}], lr=0.1)
        opt = hvd.DistributedOptimizer(inner, fused_apply=True,
                                       fusion_threshold_bytes=64)
        assert len(opt.bucket_optimizers) == 2
        inner.param_groups[1]["lr"] = 0.5
        a.grad, b.grad = torch.ones(4), torch.ones(300)
        opt.step()
        sd = inner.state_dict()
        assert set(sd["state"]) == {0, 1}
        assert float(sd["state"][1]["step"]) == 1.0
        # AdamW's first step moves a parameter by about lr.
        assert abs(float(b.detach()[0]) + 0.5) < 1e-3
        assert abs(float(a.detach()[0]) + 0.1) < 1e-3
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("n_new", [1, 2, 3, 4, 8])
def test_regroup_is_jax(n_new):
    shapes = [(6, 5), (7,), (3, 4, 2), (9,), (33,)]
    hvd.init(device="cpu")
    try:
        pl = hvd.zero3_placement([torch.zeros(s) for s in shapes],
                                 fusion_threshold_bytes=100)
        got = pl.regroup(n_new)
    finally:
        hvd.shutdown()
    jpl = jhvd.zero3_placement([jnp.zeros(s) for s in shapes],
                               fusion_threshold_bytes=100).regroup(n_new)
    assert got.n == jpl.n == n_new
    assert [(g.idxs, g.sizes, g.padded, g.shard_sz) for g in got.groups] == \
        [(tuple(g.idxs), tuple(g.sizes), g.padded, g.shard_sz)
         for g in jpl.groups]
    assert pl.n == 1 and got.groups != pl.groups or n_new == 1
    with pytest.raises(ValueError, match="regroup needs n_new >= 1"):
        got.regroup(0)

