"""Port parity: the runtime instruments on the collectives and the step
boundary, against the JAX package's, mirroring tests/test_aux.py.

- The timeline of one allreduce, allgather, broadcast and barrier holds
  JAX's (name, tid, ph) events, in order.
- After the same calls at two ranks (two gloo ranks; JAX's mesh of two
  CPU devices, `PerRank` inputs), the `collective_calls` and
  `collective_bytes` counters and their labels equal JAX's: the bytes
  are every rank's contribution, the set size times one rank's staged
  bytes.
- Two `DistributedOptimizer` steps record JAX's `data_parallel` steps:
  `steps`, `buckets_per_step` (the same bucket partition), the gradient
  bytes (JAX records its static per-step bytes at trace time, the
  port's eager steps count them) and the cycle marks and step spans.
- `hvd.init()` starts the timeline (HOROVOD_TIMELINE) and the stall
  inspector (on by default), and `hvd.shutdown()` stops both.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.metrics import catalog as JMET
from horovod_tpu.utils import timeline as JTL
import horovod_tpu_torch as hvd
from horovod_tpu_torch.metrics import catalog as MET
from horovod_tpu_torch.utils import stall_inspector as S
from horovod_tpu_torch.utils import timeline as TL

from test_torch_port_collectives import no_launcher_env, run_world  # noqa: F401


def _events(path):
    return [(e["name"], e["tid"], e["ph"]) for e in json.loads(path.read_text())]


def test_timeline_events_match_jax(tmp_path):
    jhvd.init()
    hvd.init(device="cpu")
    jpath, ppath = tmp_path / "jax.json", tmp_path / "port.json"
    JTL.start_timeline(str(jpath))
    try:
        jhvd.allreduce(jnp.ones((4,)), name="grad.w")
        jhvd.allgather(jnp.ones((2, 2)), name="gath")
        jhvd.broadcast(jnp.ones((3,)), root_rank=0, name="bc")
        jhvd.barrier()
    finally:
        JTL.stop_timeline()
    TL.start_timeline(str(ppath))
    try:
        hvd.allreduce(torch.ones(4), name="grad.w")
        hvd.allgather(torch.ones(2, 2), name="gath")
        hvd.broadcast(torch.ones(3), root_rank=0, name="bc")
        hvd.barrier()
    finally:
        TL.stop_timeline()
    want = _events(jpath)
    assert want == [("ALLREDUCE", "ALLREDUCE:grad.w", "X"),
                    ("ALLGATHER", "ALLGATHER:gath", "X"),
                    ("BROADCAST", "BROADCAST:bc", "X"),
                    ("ALLREDUCE", "ALLREDUCE", "X"),
                    ("BARRIER", "BARRIER", "X")]
    assert _events(ppath) == want
    for e in json.loads(ppath.read_text()):
        assert e["dur"] >= 0 and e["pid"] == 0


# ---------------------------------------------------------------------------
# Collective counters at two ranks
# ---------------------------------------------------------------------------

# The inputs and the call sequence, run by the port's ranks and by JAX.
COMMON = r'''
import numpy as np


def _inputs(r):
    rng = np.random.RandomState(40 + r)
    return {"x": rng.randn(5, 3).astype(np.float32),
            "i": (np.arange(6) * (r + 1)).astype(np.int32),
            "rag": rng.randn(2 + r, 4).astype(np.float32),
            "a2a": rng.randn(4, 2).astype(np.float32),
            "splits": np.array([1, 3] if r == 0 else [4, 0], np.int32),
            "rs": rng.randn(5, 3).astype(np.float32),
            "g1": rng.randn(7).astype(np.float32),
            "g2": rng.randn(2, 3).astype(np.float32),
            "g3": np.ones((9,), np.int32) * r}


def _counts(metric):
    return {lbl: child.get() for lbl, child in metric.samples()}


def _delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def calls(h, d):
    """The collectives both packages run (`d`: this rank's inputs, or
    JAX's `PerRank` of both ranks')."""
    h.allreduce(d["x"], name="x")
    h.allreduce(d["i"], op=h.Sum)
    h.allgather(d["rag"], name="rag")
    h.broadcast(d["x"], root_rank=1, name="bc")
    h.alltoall(d["a2a"])
    h.alltoall(d["a2a"], splits=d["splits"])
    h.reducescatter(d["rs"], op=h.Sum)
    h.grouped_allreduce([d["g1"], d["g2"], d["g3"]], op=h.Sum)
    h.synchronize(h.allreduce_async(d["x"], name="async"))
    h.barrier()
'''
exec(COMMON)

WORKER = COMMON + r'''
import sys, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.metrics import catalog as MET

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
d = {k: torch.from_numpy(v) for k, v in _inputs(r).items()}
b_calls, b_bytes = _counts(MET.collective_calls), _counts(MET.collective_bytes)
calls(hvd, d)
res = {"calls": _delta(b_calls, _counts(MET.collective_calls)),
       "bytes": _delta(b_bytes, _counts(MET.collective_bytes))}
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("obs"), 2, WORKER)


@pytest.fixture
def jax_two_ranks():
    """The JAX package over two CPU devices (rank r = device r)."""
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2])
    yield
    jhvd.shutdown()
    jhvd.init()


def test_collective_counters_match_jax_at_two_ranks(world, jax_two_ranks):
    per = [_inputs(r) for r in range(2)]
    d = {k: jhvd.PerRank([jnp.asarray(p[k]) for p in per]) for k in per[0]}
    b_calls, b_bytes = _counts(JMET.collective_calls), _counts(
        JMET.collective_bytes)
    calls(jhvd, d)
    want_calls = _delta(b_calls, _counts(JMET.collective_calls))
    want_bytes = _delta(b_bytes, _counts(JMET.collective_bytes))
    kinds = {k[0] for k in want_calls}
    assert {"ALLREDUCE", "ALLGATHER", "ALLGATHER_SIZES", "BROADCAST",
            "ALLTOALL", "ALLTOALL_SPLITS", "REDUCESCATTER",
            "BARRIER"} <= kinds
    for rec in world:
        assert rec["calls"] == want_calls
        assert rec["bytes"] == want_bytes


# ---------------------------------------------------------------------------
# The step boundary
# ---------------------------------------------------------------------------

SHAPES = [(1024,), (32, 32), (1024,), (16, 64)]  # 4 KiB each
THRESHOLD = 8192  # two leaves a bucket: 2 buckets


def _gauge(m):
    return m._solo().get()


def test_optimizer_steps_match_jax_data_parallel(tmp_path):
    jhvd.init()
    hvd.init(device="cpu")
    rng = np.random.RandomState(0)
    params0 = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    xb = rng.randn(8, 4).astype(np.float32)

    # JAX: data_parallel over its mesh, DistributedOptimizer inside.
    opt = jhvd.DistributedOptimizer(optax.sgd(0.1),
                                    fusion_threshold_bytes=THRESHOLD)

    def train_step(params, state, batch):
        def loss_fn(ps):
            return sum(jnp.sum(p) * jnp.mean(batch) for p in ps)

        grads = jax.grad(loss_fn)(params)
        upd, state = opt.update(grads, state, params)
        return optax.apply_updates(params, upd), state

    step = jhvd.data_parallel(train_step, batch_args=(2,))
    params = [jnp.asarray(p) for p in params0]
    state = opt.init(params)
    batch = jhvd.shard_batch(jnp.asarray(xb))
    j0 = _gauge(JMET.steps)
    jpath = tmp_path / "jax.json"
    JTL.start_timeline(str(jpath), mark_cycles=True)
    try:
        for _ in range(2):
            params, state = step(params, state, batch)
    finally:
        JTL.stop_timeline()
    j_steps = _gauge(JMET.steps) - j0
    j_buckets = _gauge(JMET.buckets_per_step)
    j_bytes = _gauge(JMET.grad_bytes_per_step) * j_steps

    # The port: the same leaves under DistributedOptimizer at one rank.
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params0]
    popt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=0.1),
                                    fusion_threshold_bytes=THRESHOLD)
    p0, g0 = _gauge(MET.steps), _gauge(MET.grad_bytes_reduced)
    s0 = _gauge(MET.optimizer_syncs)
    ppath = tmp_path / "port.json"
    TL.start_timeline(str(ppath), mark_cycles=True)
    try:
        for _ in range(2):
            popt.zero_grad(set_to_none=True)
            sum(p.sum() * torch.from_numpy(xb).mean() for p in ps).backward()
            popt.step()
    finally:
        TL.stop_timeline()
    assert _gauge(MET.steps) - p0 == j_steps == 2
    assert _gauge(MET.buckets_per_step) == j_buckets == 2
    assert len(popt.last_buckets) == 2
    assert _gauge(MET.grad_bytes_reduced) - g0 == j_bytes == 2 * 4 * 4096
    assert _gauge(MET.grad_bytes_per_step) == j_bytes / 2
    assert _gauge(MET.bucket_bytes) == _gauge(JMET.bucket_bytes) == 8192
    assert _gauge(MET.optimizer_syncs) - s0 == 2

    def marks(path):
        evs = json.loads(path.read_text())
        return ([e["name"] for e in evs if e["cat"] == "cycle"],
                [(e["name"], e["ph"], e["step"]) for e in evs
                 if e["cat"] == "step"])

    assert marks(ppath) == marks(jpath) == (
        ["CYCLE_1", "CYCLE_2"], [("step", "X", 1), ("step", "X", 2)])
    # No wire policy: neither package labels its buckets.
    for path in (jpath, ppath):
        assert not [e for e in json.loads(path.read_text())
                    if e["cat"] in ("wire", "fused")]


def test_allreduce_gradients_records_jax_eager_metrics():
    """The eager reduction outside the optimizer: grad_bytes_reduced and
    buckets_per_step / bucket_bytes, as JAX's eager allreduce_gradients
    records them."""
    from horovod_tpu.parallel.data_parallel import (
        allreduce_gradients as j_reduce)
    from horovod_tpu_torch.parallel.data_parallel import allreduce_gradients

    jhvd.init()
    hvd.init(device="cpu")
    leaves = [np.full(s, 1.0, np.float32) for s in SHAPES]
    jg, pg = _gauge(JMET.grad_bytes_reduced), _gauge(MET.grad_bytes_reduced)
    j_reduce([jnp.asarray(x) for x in leaves],
             fusion_threshold_bytes=THRESHOLD)
    allreduce_gradients([torch.from_numpy(x) for x in leaves],
                        fusion_threshold_bytes=THRESHOLD)
    assert (_gauge(MET.grad_bytes_reduced) - pg
            == _gauge(JMET.grad_bytes_reduced) - jg == 4 * 4096)
    assert _gauge(MET.buckets_per_step) == _gauge(JMET.buckets_per_step)
    assert _gauge(MET.bucket_bytes) == _gauge(JMET.bucket_bytes)


def test_init_and_shutdown_start_and_stop_both(tmp_path, monkeypatch):
    hvd.shutdown()
    path = tmp_path / "init.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    monkeypatch.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "1")
    monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "30")
    hvd.init(device="cpu")
    try:
        tl, si = TL.get_timeline(), S.get_inspector()
        assert tl is not None and tl._writer.filename == str(path)
        assert tl._mark_cycles
        assert si is not None and si.warn_time == 30.0
        assert si._thread is not None and si._thread.is_alive()
        hvd.allreduce(torch.ones(2), name="w")
    finally:
        hvd.shutdown()
    assert TL.get_timeline() is None and S.get_inspector() is None
    assert not si._thread
    assert _events(path) == [("ALLREDUCE", "ALLREDUCE:w", "X")]
    # Disabled by the env: no inspector, and no timeline without the path.
    monkeypatch.delenv("HOROVOD_TIMELINE")
    monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    hvd.init(device="cpu")
    try:
        assert TL.get_timeline() is None and S.get_inspector() is None
    finally:
        hvd.shutdown()


def test_sharded_optimizer_records_jax_zero_gauges():
    """ZeRO-1 at one rank: `rs_bytes` and `param_ag_bytes` equal JAX's
    for the same leaves and threshold (its mesh of one CPU device), and
    every sync counts one `optimizer_syncs` and one step."""
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:1])
    try:
        rng = np.random.RandomState(1)
        params0 = [rng.randn(*s).astype(np.float32) for s in SHAPES]
        opt = jhvd.DistributedOptimizer(optax.adam(0.1),
                                        shard_optimizer_states=True,
                                        fusion_threshold_bytes=THRESHOLD)

        def train_step(params, state, batch):
            grads = jax.grad(lambda ps: sum(jnp.sum(p) * jnp.mean(batch)
                                            for p in ps))(params)
            upd, state = opt.update(grads, state, params)
            return optax.apply_updates(params, upd), state

        state = opt.init([jnp.asarray(p) for p in params0])
        specs = jhvd.sharded_state_specs(state)
        step = jhvd.data_parallel(train_step, batch_args=(2,),
                                  arg_specs={1: specs},
                                  out_specs=(jax.sharding.PartitionSpec(),
                                             specs))
        step([jnp.asarray(p) for p in params0], state,
             jhvd.shard_batch(jnp.ones((4, 4), jnp.float32)))
        want = (_gauge(JMET.rs_bytes), _gauge(JMET.param_ag_bytes))
    finally:
        jhvd.shutdown()
        jhvd.init()

    hvd.init(device="cpu")
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params0]
    popt = hvd.DistributedOptimizer(torch.optim.Adam(ps, lr=0.1),
                                    zero_stage=1,
                                    fusion_threshold_bytes=THRESHOLD)
    s0, t0 = _gauge(MET.optimizer_syncs), _gauge(MET.steps)
    for _ in range(2):
        popt.zero_grad(set_to_none=True)
        sum(p.sum() for p in ps).backward()
        popt.step()
    assert (_gauge(MET.rs_bytes), _gauge(MET.param_ag_bytes)) == want
    assert want == (4 * 4096, 4 * 4096)
    assert _gauge(MET.optimizer_syncs) - s0 == 2
    assert _gauge(MET.steps) - t0 == 2
    assert _gauge(MET.opt_state_bytes) == hvd.optimizer_state_bytes(popt) > 0
