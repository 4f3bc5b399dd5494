"""Port parity: the training-health guard (`horovod_tpu_torch/guard/`,
`DistributedOptimizer(guard=)`, the eager reduction's sentinel) on the
CPU, against the JAX package (`horovod_tpu/guard/`).

Inputs come from numpy seeds on both sides.  One process: the loss-scale
schedule (dynamic, static and pending-flag sequences) bitwise JAX's, the
sentinel's flags, unscale, the digests (within 1e-12 of JAX's: the f64
sums run in another order), the fault translations' bits, the
controller's verdicts, rollback, the refusals' messages.  Gloo worlds of
2, 3 and 4 CPU ranks (a `file://` rendezvous under tmp): the sliced scan
and the cross-rank OR, and `reduce_gradient_buckets(sentinel=True)` on
the exact wire, on int8 and under a policy, bitwise JAX's flags over as
many CPU devices; at 2 ranks the guarded optimizer at stages 0-3 against
JAX's `DistributedOptimizer(optax.sgd, guard=...)` (scale, counters and
verdict bitwise; parameters within 1e-6: JAX averages over its 8 devices,
each holding one of the two ranks' rows), the static scale bitwise the
unguarded run, a flagged step leaving the parameters and the inner state
untouched, the ring's error-feedback rows zeroed, the divergence check,
and tests/data/guard_main.py's drill ending in the trace that
tests/test_guard.py's `TestGuardCrossProcess` asserts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu import faults as jfaults
from horovod_tpu import guard as JG
from horovod_tpu.parallel import data_parallel as JDP

import horovod_tpu_torch as hvd
from horovod_tpu_torch import faults
from horovod_tpu_torch import guard as G
from horovod_tpu_torch.ops import wire

from test_torch_port_collectives import (  # noqa: F401
    no_launcher_env, run_world)

# ---------------------------------------------------------------------------
# The loss-scale schedule
# ---------------------------------------------------------------------------

SCHEDULES = {
    "dynamic": dict(init_scale=1024.0, growth_interval=2),
    "dynamic_odd": dict(init_scale=1000.0, growth_factor=3.0,
                        backoff_factor=0.25, growth_interval=3),
    "static_one": dict(init_scale=1.0, dynamic=False),
    "static_scaled": dict(init_scale=128.0, dynamic=False),
}


def _bits(state):
    return [np.asarray(f).tobytes() for f in state]


def _tbits(state):
    return [f.numpy().tobytes() for f in state]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_loss_scale_schedule_is_bitwise_jax(name, seed):
    """40 updates over seeded flag vectors, with pending-flag passes
    folded in at random: every field bitwise JAX's after every call."""
    kw = SCHEDULES[name]
    js, ps = JG.DynamicLossScale(**kw), G.DynamicLossScale(**kw)
    jst, pst = js.init(3), ps.init(3)
    assert _tbits(pst) == _bits(jst)
    rng = np.random.RandomState(seed)
    for _ in range(40):
        if rng.rand() < 0.25:
            pf = (rng.rand(2) < 0.5).astype(np.float32)
            jst = js.accumulate(jst, jnp.asarray(pf))
            pst = ps.accumulate(pst, torch.from_numpy(pf))
            assert _tbits(pst) == _bits(jst)
        flags = (rng.rand(3) < 0.15).astype(np.float32)
        jst = js.update(jst, jnp.asarray(flags))
        pst = ps.update(pst, torch.from_numpy(flags))
        assert _tbits(pst) == _bits(jst)


def test_growth_interval_none_reads_the_env(monkeypatch):
    monkeypatch.setenv("HOROVOD_GUARD_GROWTH_INTERVAL", "2")
    js, ps = JG.DynamicLossScale(init_scale=8.0), G.DynamicLossScale(
        init_scale=8.0)
    jst, pst = js.init(1), ps.init(1)
    for _ in range(4):
        jst = js.update(jst, jnp.zeros(1))
        pst = ps.update(pst, torch.zeros(1))
    assert float(pst.loss_scale) == float(jst.loss_scale) == 32.0


@pytest.mark.parametrize("value", [None, "4096", "0.5"])
def test_from_env_is_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("HOROVOD_GUARD_LOSS_SCALE", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_GUARD_LOSS_SCALE", value)
    j, p = JG.DynamicLossScale.from_env(), G.DynamicLossScale.from_env()
    assert (p.init_scale, p.dynamic) == (j.init_scale, j.dynamic)


@pytest.mark.parametrize("scale", [1024.0, 1000.0, 3.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_unscale_and_scale_loss_are_bitwise_jax(dtype, scale):
    rng = np.random.RandomState(5)
    g = rng.randn(64).astype(np.float32) * 100
    jt = jnp.asarray(g).astype(dtype)
    pt = torch.from_numpy(g).to(getattr(torch, dtype))
    js, ps = JG.DynamicLossScale(scale), G.DynamicLossScale(scale)
    jst, pst = js.init(), ps.init()
    ju = js.unscale(jst, {"g": jt})["g"]
    pu = ps.unscale(pst, {"g": pt})["g"]
    assert pu.dtype == pt.dtype
    assert pu.float().numpy().tobytes() == \
        np.asarray(ju.astype(jnp.float32)).tobytes()
    jl = js.scale_loss(jst, jt[:3])
    pl = ps.scale_loss(pst, pt[:3])
    assert pl.float().numpy().tobytes() == \
        np.asarray(jl.astype(jnp.float32)).tobytes()


def test_select_on_flag_is_jax():
    clean = {"a": np.arange(3, dtype=np.float32), "b": np.ones(2, np.float32)}
    old = {"a": -np.arange(3, dtype=np.float32), "b": np.zeros(2, np.float32)}
    for f in (0.0, 1.0):
        want = JG.select_on_flag(jnp.asarray(f),
                                 {k: jnp.asarray(v) for k, v in clean.items()},
                                 {k: jnp.asarray(v) for k, v in old.items()})
        got = G.select_on_flag(torch.tensor(f),
                               {k: torch.from_numpy(v) for k, v in clean.items()},
                               {k: torch.from_numpy(v) for k, v in old.items()})
        for k in clean:
            assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes()


# ---------------------------------------------------------------------------
# The sentinel, one process
# ---------------------------------------------------------------------------

SENTINEL_CASES = [("float32", None), ("float32", np.nan), ("float32", np.inf),
                  ("float32", -np.inf), ("bfloat16", np.nan),
                  ("bfloat16", -np.inf), ("float16", np.inf),
                  ("float16", None), ("int32", None)]


def _leaf(dtype, bad, n=37, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * 10).astype(np.float32)
    if bad is not None:
        x[rng.randint(n)] = bad
    if dtype == "int32":
        return jnp.asarray(x.astype(np.int32)), torch.from_numpy(
            x.astype(np.int32))
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype,bad", SENTINEL_CASES)
def test_local_nonfinite_is_bitwise_jax(dtype, bad):
    j, p = _leaf(dtype, bad)
    got = G.local_nonfinite([p])
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.numpy().tobytes() == np.asarray(
        JG.local_nonfinite([j])).tobytes()
    # Without a set the sliced scan is the full local one.
    assert G.sliced_nonfinite([p]).numpy().tobytes() == \
        got.numpy().tobytes()


def test_bucket_flags_local_is_bitwise_jax():
    cases = [_leaf(dt, bad, seed=i) for i, (dt, bad) in
             enumerate(SENTINEL_CASES)]
    outs = [_leaf("float32", np.nan if i == 7 else None, seed=50 + i)
            for i in range(len(cases))]
    parts = [[0, 8], [1, 2], [3], [4, 5, 6], [7]]
    for with_out in (False, True):
        want = JG.bucket_flags_local(
            [c[0] for c in cases], parts,
            outputs=[o[0] for o in outs] if with_out else None)
        got = G.bucket_flags_local(
            [c[1] for c in cases], parts,
            outputs=[o[1] for o in outs] if with_out else None)
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert G.bucket_flags_local([], []).tolist() == [0.0]
    assert G.local_nonfinite([]).tolist() == 0.0


# ---------------------------------------------------------------------------
# Digests, one process
# ---------------------------------------------------------------------------

def _digest_leaves(seed=0):
    rng = np.random.RandomState(seed)
    spec = [((64, 64), "float32"), ((64,), "float32"), ((33, 7), "bfloat16"),
            ((5,), "int32"), ((128, 3), "float16"), ((1,), "float32")]
    out = []
    for shp, dt in spec:
        x = rng.randn(*shp).astype(np.float32) * 3
        if dt == "int32":
            out.append((jnp.asarray(x.astype(np.int32)),
                        torch.from_numpy(x.astype(np.int32))))
        else:
            out.append((jnp.asarray(x).astype(dt),
                        torch.from_numpy(x).to(getattr(torch, dt))))
    return out


@pytest.mark.parametrize("threshold", [None, 1, 20000])
def test_param_digests_match_jax(monkeypatch, threshold):
    if threshold is not None:
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(threshold))
    leaves = _digest_leaves()
    want = JG.param_digests([j for j, _ in leaves])
    got = G.param_digests([p for _, p in leaves])
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "float64"])
def test_param_digests_see_one_flipped_bit(dtype):
    x = torch.from_numpy(np.random.RandomState(1).randn(300)).to(
        getattr(torch, dtype))
    before = G.param_digests({"w": x})
    G.controller._flip_bit({"w": x})
    after = G.param_digests({"w": x})
    assert (before != after).any() and torch.isfinite(x).all()


def test_digest_check_without_ranks_is_none():
    d = G.param_digests([torch.ones(3)])
    assert G.check_replica_divergence(d) is None


# ---------------------------------------------------------------------------
# The controller, one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_maybe_inject_writes_the_bits_jax_writes(dtype):
    x = np.random.RandomState(2).randn(2, 3).astype(np.float32)
    w = np.random.RandomState(3).randn(5).astype(np.float32)
    jb, jp = {"x": jnp.asarray(x), "i": jnp.arange(3)}, \
        {"w": jnp.asarray(w).astype(dtype)}
    pb = {"x": torch.from_numpy(x), "i": torch.arange(3)}
    pp = {"w": torch.from_numpy(w).to(getattr(torch, dtype))}
    jg = JG.TrainingGuard(scaler=JG.DynamicLossScale(), digest_interval=0)
    pg = G.TrainingGuard(scaler=G.DynamicLossScale(), digest_interval=0)
    try:
        for spec in ("guard.nan_grad@1:err", "guard.param_bitflip@1:err"):
            jfaults.install(spec)
            faults.install(spec)
            jb2, jp2 = jg.maybe_inject(jb, jp)
            pb2, pp2 = pg.maybe_inject(pb, pp)
            assert pb2["x"].numpy().tobytes() == \
                np.asarray(jb2["x"]).tobytes()
            assert pp2["w"].float().numpy().tobytes() == \
                np.asarray(jp2["w"].astype(jnp.float32)).tobytes()
            jp = jp2
    finally:
        jfaults.clear()
        faults.clear()
    assert np.isnan(pb["x"].numpy()).sum() == 0  # the caller's batch
    b, p = pg.maybe_inject(pb, pp)
    assert b is pb and p is pp  # disarmed: nothing happens


def _states(scale, nonfinite, flags):
    return (JG.GuardState(
        loss_scale=jnp.asarray(scale, jnp.float32),
        good_steps=jnp.zeros((), jnp.int32),
        nonfinite_steps=jnp.asarray(nonfinite, jnp.int32),
        bucket_flags=jnp.asarray(flags, jnp.float32),
        pending_flag=jnp.zeros((), jnp.float32)),
        G.GuardState(
        loss_scale=torch.tensor(scale, dtype=torch.float32),
        good_steps=torch.zeros((), dtype=torch.int32),
        nonfinite_steps=torch.tensor(nonfinite, dtype=torch.int32),
        bucket_flags=torch.tensor(flags, dtype=torch.float32),
        pending_flag=torch.zeros((), dtype=torch.float32)))


def test_observe_decides_as_jax():
    jg = JG.TrainingGuard(scaler=JG.DynamicLossScale(), digest_interval=4,
                          max_nonfinite=2)
    pg = G.TrainingGuard(scaler=G.DynamicLossScale(), digest_interval=4,
                         max_nonfinite=2)
    for step, (scale, nf, flags) in enumerate(
            [(512.0, 0, (0.0,)), (256.0, 1, (1.0, 0.0)),
             (128.0, 2, (0.0, 1.0)), (128.0, 0, (0.0,)), (64.0, 3, (1.0,))]):
        js, ps = _states(scale, nf, flags)
        jv = jg.observe(js, {"w": np.ones(3)}, step)
        pv = pg.observe(ps, {"w": torch.ones(3)}, step)
        assert tuple(pv) == tuple(jv)
    assert pg.observe(None, None, 1) == jg.observe(None, None, 1)


def test_rollback_restores_resets_and_dumps(tmp_path):
    from horovod_tpu_torch.serve.flightrec import FlightRecorder

    pg = G.TrainingGuard(scaler=G.DynamicLossScale(),
                         checkpoint_dir=str(tmp_path / "ckpt"),
                         digest_interval=0)
    state = {"w": torch.arange(4, dtype=torch.float32),
             "n": torch.tensor(3)}
    assert pg.checkpoint(3, state) and pg.last_verified_step == 3
    (tmp_path / "fr").mkdir()
    rec = FlightRecorder(8, out_dir=str(tmp_path / "fr"))
    rec.record("step", {"i": 1})
    calls = []
    hook = lambda: calls.append(1)  # noqa: E731
    wire.register_error_feedback_reset(hook)
    try:
        gen0 = wire.error_feedback_generation()
        restored = pg.rollback(template={"w": torch.zeros(4),
                                         "n": torch.tensor(0)})
    finally:
        wire.unregister_error_feedback_reset(hook)
    assert torch.equal(restored["w"], state["w"]) and int(restored["n"]) == 3
    assert pg.generation == 1 and calls == [1]
    assert wire.error_feedback_generation() == gen0 + 1
    dumps = os.listdir(tmp_path / "fr")
    assert len(dumps) == 1 and dumps[0].startswith("serve_flightrec")
    assert G.TrainingGuard(digest_interval=0).rollback({"w": 1}) is None


def test_reset_guard_state_reseeds():
    scaler = G.DynamicLossScale(init_scale=1024.0, growth_interval=100)
    _, dirty = _states(2.0, 7, (1.0, 0.0, 1.0))
    fresh = G.TrainingGuard.reset_guard_state(dirty, scaler)
    assert float(fresh.loss_scale) == 1024.0 and int(
        fresh.nonfinite_steps) == 0 and fresh.bucket_flags.shape == (3,)

    class Holder:
        guard_state = dirty
    h = G.TrainingGuard.reset_guard_state(Holder(), scaler)
    assert float(h.guard_state.loss_scale) == 1024.0
    assert G.TrainingGuard.reset_guard_state({"x": 1}, scaler) == {"x": 1}


@pytest.mark.parametrize("kind", ["adasum", "bad_type", "int"])
def test_refusals_carry_jax_messages(kind):
    kw = {"adasum": dict(guard=True, op="Adasum"),
          "bad_type": dict(guard="yes"), "int": dict(guard=1)}[kind]

    def args(mod):
        out = dict(kw)
        if out.get("op"):
            out["op"] = getattr(mod, out["op"])
        return out
    with pytest.raises(ValueError) as jerr:
        jhvd.DistributedOptimizer(optax.sgd(0.1), **args(jhvd))
    w = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError) as perr:
        hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1), **args(hvd))
    assert str(perr.value) == str(jerr.value)


def test_guard_env_arms_the_optimizer(monkeypatch):
    monkeypatch.setenv("HOROVOD_GUARD", "1")
    monkeypatch.delenv("HOROVOD_GUARD_LOSS_SCALE", raising=False)
    hvd.init(device="cpu")
    try:
        w = torch.nn.Parameter(torch.zeros(3))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1))
        assert float(opt.guard_state.loss_scale) == 1.0
        monkeypatch.setenv("HOROVOD_GUARD", "0")
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1))
        assert opt.guard_state is None
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# Gloo worlds
# ---------------------------------------------------------------------------

# Per-rank inputs: the worker and the tests build them from the same seeds.
INPUTS = r'''
import numpy as np

DIM, LOCAL_B = 4, 4
SLICE_N = 33                      # not a multiple of 2, 3 or 4: a tail
BUCKET_SPEC = [(37,), (4, 5), (300,), (7, 3), (64,), (11,)]
REDUCE_CASES = {"clean": None, "leaf0": (1, 0, 3), "leaf2": (1, 2, 150),
                "leaf5": (0, 5, 10)}
NAN_STEP, STEPS = 3, 6


def bucket_inputs(r, case):
    """Rank r's gradient leaves: float32, NaN at (rank, leaf, pos)."""
    rng = np.random.RandomState(40 + r)
    leaves = [rng.randn(*s).astype(np.float32) for s in BUCKET_SPEC]
    bad = REDUCE_CASES[case]
    if bad is not None and bad[0] == r:
        leaves[bad[1]].reshape(-1)[bad[2]] = np.nan
    return leaves


def regression_data(r):
    """guard_main.py's rows: the same seed on every rank, each rank its
    own LOCAL_B rows."""
    rng = np.random.RandomState(0)
    true_w = rng.uniform(size=(DIM,)).astype(np.float32)
    xs = rng.uniform(size=(2 * LOCAL_B, DIM)).astype(np.float32)
    ys = (xs @ true_w).astype(np.float32)
    return xs[r * LOCAL_B:(r + 1) * LOCAL_B], ys[r * LOCAL_B:(r + 1) * LOCAL_B]
'''
_NS = {}
exec(INPUTS, _NS)  # noqa: S102 — the shared seeds, as the workers run them

WORKER = INPUTS + r'''
import hashlib, os, shutil, sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import faults
from horovod_tpu_torch import guard as G
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.parallel.data_parallel import reduce_gradient_buckets
from horovod_tpu_torch.utils.checkpoint import CheckpointManager

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
ps = hvd.global_process_set()
res = {"rank": r}

# The sliced scan + the cross-rank OR over a replicated buffer.
res["sliced"] = []
for i in range(-1, SLICE_N):
    buf = torch.arange(SLICE_N, dtype=torch.float32)
    if i >= 0:
        buf[i] = float("nan")
    f = G.sliced_nonfinite([buf, torch.arange(3)], ps)
    res["sliced"].append(G.crossrank_or(torch.stack([f]), ps).tolist())

# The eager reduction's sentinel: exact, int8, a policy; each case.
res["reduce"] = {}
for wire in ("exact", "int8", "policy"):
    if wire == "policy":
        os.environ["HOROVOD_WIRE_POLICY"] = "big=int8,small=none,threshold=1000"
    comp = Compression.int8 if wire == "int8" else Compression.none
    for case in REDUCE_CASES:
        leaves = [torch.from_numpy(x) for x in bucket_inputs(r, case)]
        results, _, flags = reduce_gradient_buckets(
            leaves, compression=comp, fusion_threshold_bytes=1200,
            sentinel=True)
        res["reduce"][wire, case] = {
            "flags": flags.tolist(),
            "parts": [list(i) for i, _ in results],
            "out_finite": all(bool(torch.isfinite(o).all())
                              for _, outs in results for o in outs)}
    os.environ.pop("HOROVOD_WIRE_POLICY", None)


def state_sha(opt):
    inner = getattr(opt, "_local", None) or opt._opt
    h = hashlib.sha256()
    for st in inner.state.values():
        for k in sorted(st):
            v = st[k]
            if isinstance(v, torch.Tensor):
                h.update(v.detach().float().numpy().tobytes())
    return h.hexdigest()


def run_opt(stage, guard, opt_name="sgd", bpps=1, nan_at=None, steps=STEPS,
            env=None, seed_rows=False):
    """guard_main.py's regression under DistributedOptimizer at `stage`;
    rank 1's row 0 poisoned at pass `nan_at`.  Per pass: the guard state,
    w, the inner state's SHA, the EF rows' largest magnitude."""
    for k, v in (env or {}).items():
        os.environ[k] = v
    x_np, y_np = regression_data(r)
    if seed_rows:  # other rows per step (the static-scale runs)
        rng = np.random.RandomState(7 + r)
    w = torch.nn.Parameter(torch.zeros(DIM))
    inner = (torch.optim.SGD([w], lr=0.1) if opt_name == "sgd" else
             torch.optim.AdamW([w], lr=0.05))
    opt = hvd.DistributedOptimizer(inner, named_parameters=[("w", w)],
                                   zero_stage=stage, guard=guard,
                                   backward_passes_per_step=bpps)
    placement = rows = None
    if stage == 3:
        placement = hvd.zero3_placement([w])
        rows = placement.shard([w])
        placement.bind([w])
    trace = []
    for t in range(steps):
        x, y = torch.from_numpy(x_np.copy()), torch.from_numpy(y_np)
        if seed_rows:
            x = torch.from_numpy(rng.uniform(size=x_np.shape).astype(
                np.float32))
        if r == 1 and t == nan_at:
            x[0, 0] = float("nan")
        if placement is not None:
            with torch.no_grad():
                placement.gather(rows)
        w_before = w.detach().clone()
        sha_before = state_sha(opt)
        loss = ((x @ w - y) ** 2).mean()
        if isinstance(guard, G.DynamicLossScale):
            loss = guard.scale_loss(opt.guard_state, loss)
        loss.backward()
        u = opt.step()
        if placement is not None:
            rows = placement.apply_updates(rows, u)
            with torch.no_grad():
                placement.gather(rows)
        rec = {"w": w.detach().clone(), "w_before": w_before,
               "sha": state_sha(opt), "sha_before": sha_before}
        if placement is not None:
            placement.release()
        if u is not None:
            rec["updates"] = [t_.clone() for t_ in u]
        gs = getattr(opt, "guard_state", None)
        if gs is not None:
            rec["guard"] = G.GuardState(*[f.clone() for f in gs])
        efs = [float(row.abs().max()) for row in getattr(opt, "_ef_rows", [])
               if row is not None]
        rec["ef"] = efs
        trace.append(rec)
        if (t + 1) % bpps == 0:  # the passes between accumulate
            opt.zero_grad(set_to_none=True)
    for k in (env or {}):
        os.environ.pop(k, None)
    return trace


if n == 2:
    scaler = G.DynamicLossScale(1024.0, growth_interval=2)
    res["opt"] = {s: run_opt(s, scaler, nan_at=NAN_STEP) for s in (0, 1, 2, 3)}
    res["adam"] = {s: run_opt(s, scaler, "adamw", nan_at=NAN_STEP)
                   for s in (0, 1, 2, 3)}
    static = G.DynamicLossScale(init_scale=1.0, dynamic=False)
    res["static"] = {s: (run_opt(s, static, "adamw", seed_rows=True),
                         run_opt(s, False, "adamw", seed_rows=True))
                     for s in (0, 1, 2, 3)}
    res["accum"] = {s: run_opt(s, scaler, bpps=2, nan_at=2, steps=6)
                    for s in (0, 2)}
    res["ef"] = run_opt(1, scaler, nan_at=NAN_STEP, env={
        "HOROVOD_WIRE_POLICY": "big=int8,small=int8,threshold=1"})

    # Divergence: rank 1's leaf 2 differs in one bit.
    leaves = [torch.from_numpy(np.random.RandomState(i).randn(50).astype(
        np.float32)) for i in range(3)]
    if r == 1:
        G.controller._flip_bit([leaves[2]])
    parts = [[0], [1], [2]]
    res["diverged"] = G.check_replica_divergence(
        G.param_digests(leaves, parts))
    res["agree"] = G.check_replica_divergence(
        G.param_digests(leaves[:2], parts[:2]))
    ckdir = os.path.join(out_dir, "refuse_ckpt")
    tg = G.TrainingGuard(checkpoint_dir=ckdir, digest_interval=0)
    res["refused"] = not tg.checkpoint(1, {"l": leaves})
    res["verify"] = tg.verify_state({"l": leaves})

    # The checkpoint manager on two ranks: rank 0 writes, both read.
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"), max_to_keep=2)
    state = {"w": torch.arange(6, dtype=torch.float32) + r,
             "opt": {"step": torch.tensor(4), "lr": 0.5}}
    res["saved"] = [mgr.save(s, dict(state, s=s)) for s in (1, 2, 3)]
    res["steps"] = (mgr.latest_step(), mgr.all_steps())
    res["restored"] = mgr.restore_latest(template=dict(state, s=0))
    res["restored2"] = mgr.restore(2)

    # guard_main.py's drill.
    from horovod_tpu_torch import faults
    scaler = G.DynamicLossScale(init_scale=1024.0, growth_interval=1000)
    w = torch.nn.Parameter(torch.zeros(DIM))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                   named_parameters=[("w", w)], guard=scaler)
    guard = G.TrainingGuard(scaler=scaler,
                            checkpoint_dir=os.path.join(out_dir, "drill"),
                            digest_interval=4, max_nonfinite=3)
    x_local, y_local = (torch.from_numpy(a) for a in regression_data(r))
    trace, rollback_at, bucket = [], None, None
    for t in range(1, 13):
        if r == 1 and t == 3:
            faults.install("guard.nan_grad@1:err")
        if r == 1 and t == 6:
            faults.install("guard.param_bitflip@1:err")
        batch, _ = guard.maybe_inject({"x": x_local, "y": y_local}, [w])
        faults.clear()
        opt.zero_grad(set_to_none=True)
        loss = ((batch["x"] @ w - batch["y"]) ** 2).mean()
        scaler.scale_loss(opt.guard_state, loss).backward()
        opt.step()
        v = guard.observe(opt, [w], t)
        trace.append({"step": t, "flagged": v.flagged, "scale": v.loss_scale,
                      "nonfinite": v.nonfinite_steps})
        if v.rollback:
            rollback_at, bucket = t, v.mismatch_bucket
            st = guard.rollback({"w": w.detach(), "opt": opt.state_dict()})
            with torch.no_grad():
                w.copy_(st["w"])
            opt.load_state_dict(st["opt"])
            guard.reset_guard_state(opt, scaler)
        elif t == 4:
            assert guard.checkpoint(t, {"w": w.detach(),
                                        "opt": opt.state_dict()})
    res["drill"] = {"trace": trace, "rollback_at": rollback_at,
                    "mismatch_bucket": bucket, "generation": guard.generation,
                    "last_verified_step": guard.last_verified_step,
                    "final_clean": guard.verify_state([w]) is None,
                    "final_w": w.detach().tolist()}

torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


_WORLDS = {}


def _world(n, tmp_path_factory):
    """The n-rank world's results, run once per module."""
    if n not in _WORLDS:
        _WORLDS[n] = run_world(tmp_path_factory.mktemp(f"guard{n}"), n,
                               WORKER)
    return n, _WORLDS[n]


@pytest.fixture(scope="module", params=[2, 3, 4], ids=["np2", "np3", "np4"])
def world(request, tmp_path_factory):
    return _world(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The two-rank world, where the optimizer scenarios run."""
    return _world(2, tmp_path_factory)[1]


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("x",))


def test_sliced_scan_and_or_are_bitwise_jax(world):
    """Each NaN position of a replicated 33-element buffer (and none):
    every rank's OR-ed flag is JAX's over as many devices."""
    n, res = world
    size = _NS["SLICE_N"]

    def body(x):
        f = JG.sliced_nonfinite([x, jnp.arange(3)], "x")
        return JG.crossrank_or(jnp.stack([f]), axis_name="x")

    sm = jax.jit(jax.shard_map(body, mesh=_mesh(n), in_specs=(P(),),
                               out_specs=P(), check_vma=False))
    for k, i in enumerate(range(-1, size)):
        buf = jnp.arange(size, dtype=jnp.float32)
        if i >= 0:
            buf = buf.at[i].set(jnp.nan)
        want = np.asarray(sm(buf)).tolist()
        assert want == [0.0 if i < 0 else 1.0]
        for d in res:
            assert d["sliced"][k] == want, (d["rank"], i)


def _jax_reduce(n, wire, case, monkeypatch):
    if wire == "policy":
        monkeypatch.setenv("HOROVOD_WIRE_POLICY",
                           "big=int8,small=none,threshold=1000")
    comp = jhvd.Compression.int8 if wire == "int8" else jhvd.Compression.none
    per_rank = [_NS["bucket_inputs"](r, case) for r in range(n)]
    stacked = [jnp.asarray(np.stack([p[i] for p in per_rank]))
               for i in range(len(per_rank[0]))]

    def body(*xs):
        leaves = [x[0] for x in xs]
        results, _, flags = JDP.reduce_gradient_buckets(
            leaves, compression=comp, axis_name="x",
            fusion_threshold_bytes=1200, sentinel=True)
        return flags

    sm = jax.jit(jax.shard_map(body, mesh=_mesh(n),
                               in_specs=tuple(P("x") for _ in stacked),
                               out_specs=P(), check_vma=False))
    flags = np.asarray(sm(*stacked))
    parts = JDP.gradient_bucket_partition(
        per_rank[0], compression=comp, fusion_threshold_bytes=1200)
    return flags.tolist(), [list(p) for p in parts]


@pytest.mark.parametrize("case", ["clean", "leaf0", "leaf2", "leaf5"])
@pytest.mark.parametrize("wire_name", ["exact", "int8", "policy"])
def test_reduction_sentinel_flags_are_bitwise_jax(world, monkeypatch,
                                                  wire_name, case):
    n, res = world
    want, parts = _jax_reduce(n, wire_name, case, monkeypatch)
    for d in res:
        got = d["reduce"][wire_name, case]
        assert got["parts"] == parts
        assert got["flags"] == want, (d["rank"], got, want)
    if case != "clean":
        assert max(want) == 1.0
    else:
        assert max(want) == 0.0


@pytest.mark.parametrize("case", ["leaf0", "leaf2"])
def test_int8_laundered_nan_is_caught(world, case):
    """The int8 cast turns the NaN into a finite value on the wire (the
    reduced output is finite on every rank), and the input check still
    flags the bucket."""
    n, res = world
    for d in res:
        got = d["reduce"]["int8", case]
        assert got["out_finite"] and max(got["flags"]) == 1.0
        assert not d["reduce"]["exact", case]["out_finite"]


def _jax_trace(nan_at=3, steps=6):
    """JAX's DistributedOptimizer(optax.sgd(0.1), guard=...) over its 8
    CPU devices, device d holding rank d % 2's rows."""
    scaler = JG.DynamicLossScale(1024.0, growth_interval=2)
    opt = jhvd.DistributedOptimizer(optax.sgd(0.1), guard=scaler)
    mesh = jhvd.global_mesh()
    ndev = mesh.devices.size

    def step(w, st, x, y):
        def loss_fn(w):
            return jnp.mean((x @ w - y) ** 2) * st.guard.loss_scale
        g = jax.grad(loss_fn)(w)
        u, st = opt.update(g, st, w)
        return optax.apply_updates(w, u), st

    sm = jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(P(), P(), P(jhvd.GLOBAL_AXIS),
                                   P(jhvd.GLOBAL_AXIS)),
        out_specs=(P(), P()), check_vma=False))
    w = jnp.zeros((4,), jnp.float32)
    st = opt.init(w)
    rows = [_NS["regression_data"](r) for r in range(2)]
    out = []
    for t in range(steps):
        xs = [rows[d % 2][0].copy() for d in range(ndev)]
        if t == nan_at:
            for d in range(1, ndev, 2):
                xs[d][0, 0] = np.nan
        w, st = sm(w, st, jnp.asarray(np.concatenate(xs)),
                   jnp.asarray(np.concatenate([rows[d % 2][1]
                                               for d in range(ndev)])))
        out.append((np.asarray(w), st.guard))
    return out


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_guarded_optimizer_tracks_jax(world2, stage):
    """Scale, counters and the flagged verdict bitwise JAX's at every
    step (the flag vector: one bucket on both sides); parameters within
    1e-6."""
    res = world2
    want = _jax_trace()
    for d in res:
        for t, (rec, (jw, jg)) in enumerate(zip(d["opt"][stage], want)):
            g = rec["guard"]
            assert [f.numpy().tobytes() for f in g[:4]] == \
                [np.asarray(f).tobytes() for f in jg[:4]], (d["rank"], t)
            np.testing.assert_allclose(rec["w"].numpy(), jw, rtol=1e-6,
                                       atol=1e-7)
        flagged = [t for t, rec in enumerate(d["opt"][stage])
                   if float(rec["guard"].bucket_flags.max()) > 0]
        assert flagged == [_NS["NAN_STEP"]]


@pytest.mark.parametrize("kind", ["opt", "adam"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_flagged_step_leaves_params_and_state_untouched(world2, stage, kind):
    res = world2
    k = _NS["NAN_STEP"]
    for d in res:
        rec = d[kind][stage][k]
        assert torch.equal(rec["w"].view(torch.int32),
                           rec["w_before"].view(torch.int32))
        assert rec["sha"] == rec["sha_before"]
        if stage == 3:
            assert all(float(u.abs().max()) == 0 for u in rec["updates"])
        # The clean steps move both.
        clean = d[kind][stage][k + 1]
        assert not torch.equal(clean["w"], clean["w_before"])
        assert clean["sha"] != clean["sha_before"] or kind == "opt"
    assert torch.equal(res[0][kind][stage][-1]["w"],
                       res[1][kind][stage][-1]["w"])


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_static_scale_is_bitwise_the_unguarded_run(world2, stage):
    res = world2
    for d in res:
        on, off = d["static"][stage]
        for a, b in zip(on, off):
            assert a["w"].numpy().tobytes() == b["w"].numpy().tobytes()
            assert a["sha"] == b["sha"]
        assert float(on[-1]["guard"].loss_scale) == 1.0


@pytest.mark.parametrize("stage", [0, 2])
def test_accumulation_pass_flag_skips_the_step(world2, stage):
    """backward_passes_per_step=2, rank 1's NaN in the first pass of the
    second step: that step is skipped on both ranks (stage 0 flags the
    accumulated gradient at the sync; stage 2 folds the pass's flags into
    pending_flag)."""
    res = world2
    for d in res:
        tr = d["accum"][stage]
        sync = tr[3]
        assert torch.equal(sync["w"], sync["w_before"])
        assert float(sync["guard"].loss_scale) == 512.0
        assert int(sync["guard"].nonfinite_steps) == 1
        assert float(sync["guard"].pending_flag) == 0.0
        assert not torch.equal(tr[1]["w"], tr[1]["w_before"])
        assert not torch.equal(tr[5]["w"], tr[5]["w_before"])


def test_ring_error_feedback_rows_zeroed_on_the_flagged_step(world2):
    res = world2
    k = _NS["NAN_STEP"]
    for d in res:
        ef = [rec["ef"] for rec in d["ef"]]
        assert ef[k - 1] and max(ef[k - 1]) > 0
        assert max(ef[k]) == 0.0
        assert max(ef[k + 1]) > 0
        assert torch.equal(d["ef"][k]["w"], d["ef"][k]["w_before"])


def test_divergence_names_the_bucket_and_refuses_the_checkpoint(world2):
    res = world2
    for d in res:
        assert d["diverged"] == 2 and d["agree"] is None
        # The default partition puts the three leaves in one bucket.
        assert d["refused"] and d["verify"] == 0


def test_checkpoint_rank0_writes_and_every_rank_restores(world2):
    res = world2
    assert res[0]["saved"] == [True] * 3 and res[1]["saved"] == [False] * 3
    for d in res:
        assert d["steps"] == (3, [2, 3])
        got = d["restored"]
        assert got["s"] == 3 and torch.equal(
            got["w"], torch.arange(6, dtype=torch.float32))  # rank 0's
        assert int(got["opt"]["step"]) == 4 and got["opt"]["lr"] == 0.5
        assert d["restored2"]["s"] == 2


def test_drill_ends_in_the_jax_packages_trace(world2):
    """tests/test_guard.py TestGuardCrossProcess's assertions."""
    res = world2
    dr = [d["drill"] for d in res]
    assert dr[0]["trace"] == dr[1]["trace"]
    by_step = {t["step"]: t for t in dr[0]["trace"]}
    assert [t["step"] for t in dr[0]["trace"] if t["flagged"]] == [3]
    assert by_step[2]["scale"] == 1024.0
    assert by_step[3]["scale"] == 512.0
    assert by_step[3]["nonfinite"] == 1
    assert by_step[4]["scale"] == 512.0
    assert by_step[4]["nonfinite"] == 0
    for d in dr:
        assert d["rollback_at"] == 8
        assert d["mismatch_bucket"] == 0
        assert d["generation"] == 1
        assert d["last_verified_step"] == 4
        assert d["final_clean"]
        assert np.isfinite(d["final_w"]).all()
    assert dr[0]["final_w"] == dr[1]["final_w"]
