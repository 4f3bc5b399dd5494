"""Port parity: fault injection (`horovod_tpu_torch/faults/`) against
the JAX package's `horovod_tpu/faults/`, and the collectives' fault
bracket in np=2 gloo worlds on the CPU.

Every comparison is exact: parsed actions field by field, the
schedule's decisions hit by hit (the same points fire, at the same hits,
in the same modes), the retry delays as floats, and each point's hit
count after the same eager calls.
"""

import random

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu import faults as JF
from horovod_tpu.common.exceptions import HorovodTpuError as JErr
from horovod_tpu.ops import collectives as JC
from horovod_tpu_torch import faults as TF
from horovod_tpu_torch.common.exceptions import HorovodTpuError as TErr

from test_torch_port_collectives import run_world

SPECS = [
    "collective.allreduce:err",
    "collective.allreduce@4:err:0.25",
    "collective.allreduce:err:0.1,collective.allgather@2:delay:5ms:0.5",
    "collective.broadcast:delay:1.5,chaos.straggler_delay:err:0.3",
    "state.commit@3:hang:20us,collective.reducescatter:err:0.75",
    "rendezvous.put:err:0.1,collective.alltoall@7:delay:2s",
    "collective.allgather_sizes:err:0.05, collective.alltoall_splits@2:err",
    "worker.heartbeat@4:hang:600s,checkpoint.save:err",
    "serve.replica_die:exit:3,guard.nan_grad@2:err:0.5",
]
BAD = ["", "collective.allreduce", "collective.allreduce:boom",
       "collective.allreduce@0:err", "collective.allreduce@x:err",
       "collective.allreduce:err:0", "collective.allreduce:err:1.5",
       "collective.allreduce:delay", "collective.allreduce:delay:5parsecs"]


def _fields(actions):
    return [(a.point, a.mode, a.duration, a.prob, a.exit_code, a.from_call)
            for a in actions]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parses_as_jax(spec):
    assert _fields(TF.parse_spec(spec)) == _fields(JF.parse_spec(spec))
    assert repr(TF.parse_spec(spec)) == repr(JF.parse_spec(spec))


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_refused_as_jax(spec):
    """The same entries are refused (the empty spec parses to nothing
    in both)."""
    def outcome(parse, err):
        try:
            return ("ok", len(parse(spec)))
        except err as e:
            return ("refused", str(e))
    assert outcome(TF.parse_spec, TErr) == outcome(JF.parse_spec, JErr)


def test_catalog_is_the_jax_catalog():
    assert TF.CATALOG == JF.CATALOG


def _decisions(mod, spec, seed, hits):
    """Drive one schedule over `hits` (point names): each hit's outcome
    (None, the mode, or "raised"), without sleeping; exit-mode entries
    are only decided, never executed."""
    sched = mod.FaultSchedule(mod.parse_spec(spec), seed=seed)
    out = []
    for pt in hits:
        if any(a.mode == "exit" for a in sched._by_point.get(pt, [])):
            act = sched._decide(pt)
            out.append(None if act is None else act.mode)
            continue
        try:
            act = sched.fire(pt, _sleep=lambda d: None)
            out.append(None if act is None else act.mode)
        except mod.FaultInjected as e:
            out.append(("raised", str(e)))
    counts = {pt: sched.call_count(pt) for pt in set(hits)}
    return out, counts


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("spec", SPECS)
def test_schedule_decides_as_jax_bitwise(spec, seed):
    """300 hits over the spec's points and two it does not name,
    interleaved by a seeded shuffle: the same outcome at every hit."""
    points = sorted({a.point for a in JF.parse_spec(spec)})
    points += ["collective.barrier", "rendezvous.get"]
    rng = random.Random(seed)
    hits = [rng.choice(points) for _ in range(300)]
    got = _decisions(TF, spec, seed, hits)
    want = _decisions(JF, spec, seed, hits)
    assert got == want
    assert any(o is not None for o in got[0])


@pytest.mark.parametrize("site,env", [
    ("", {}),
    ("RESET", {"HOROVOD_RETRY_MAX_ATTEMPTS": "7",
               "HOROVOD_RESET_RETRY_BASE_DELAY": "0.25",
               "HOROVOD_RETRY_JITTER": "0.5",
               "HOROVOD_RESET_RETRY_DEADLINE": "12"}),
    ("RESET", {"HOROVOD_RESET_RETRY_MAX_ATTEMPTS": "x",
               "HOROVOD_RETRY_MAX_ATTEMPTS": "4",
               "HOROVOD_RETRY_MULTIPLIER": "3"}),
])
def test_retry_policy_from_env_and_delays_as_jax(monkeypatch, site, env):
    for k in list(__import__("os").environ):
        if "RETRY" in k:
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(max_attempts=15, base_delay=0.5, multiplier=2.0,
              max_delay=2.0, jitter=0.1, seed=11)
    got = TF.RetryPolicy.from_env(site, **kw)
    want = JF.RetryPolicy.from_env(site, **kw)
    assert got.__dict__ == want.__dict__
    assert list(got.delays()) == list(want.delays())
    assert [got.backoff(k) for k in range(6)] == \
        [want.backoff(k) for k in range(6)]


def test_retry_run_sleeps_and_gives_up_as_jax():
    def drive(mod, err):
        calls, sleeps = [], []

        def fn():
            calls.append(1)
            if len(calls) < 4:
                raise OSError("transient")
            return "done"

        pol = mod.RetryPolicy(max_attempts=6, base_delay=0.1, seed=3)
        res = pol.run(fn, sleep=sleeps.append)
        with pytest.raises(err):
            pol.run(lambda: (_ for _ in ()).throw(err("fatal")),
                    give_up_on=(err,), sleep=sleeps.append)
        with pytest.raises(ValueError):
            mod.RetryPolicy(max_attempts=3, seed=1).run(
                lambda: (_ for _ in ()).throw(ValueError("x")),
                sleep=sleeps.append)
        return res, len(calls), sleeps

    from horovod_tpu.common.exceptions import HorovodInternalError as JI
    from horovod_tpu_torch.common.exceptions import HorovodInternalError as TI
    assert drive(TF, TI) == drive(JF, JI)


@pytest.mark.parametrize("env,armed", [
    ({"HOROVOD_FAULT_SPEC": "collective.allreduce:err:0.5"}, True),
    ({"HOROVOD_FAULT_SPEC": "collective.allreduce:err",
      "HOROVOD_FAULT_HOSTS": "hostA,hostB", "HOROVOD_HOSTNAME": "hostB"},
     True),
    ({"HOROVOD_FAULT_SPEC": "collective.allreduce:err",
      "HOROVOD_FAULT_HOSTS": "hostA", "HOROVOD_HOSTNAME": "hostB"}, False),
    ({}, False),
])
def test_env_loading_as_jax(monkeypatch, env, armed):
    for k in ("HOROVOD_FAULT_SPEC", "HVD_TPU_FAULT_SPEC",
              "HOROVOD_FAULT_HOSTS", "HOROVOD_HOSTNAME",
              "HOROVOD_FAULT_SEED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("HOROVOD_FAULT_SEED", "5")
    got, want = TF._load_from_env(), JF._load_from_env()
    assert (got is not None) == (want is not None) == armed
    if armed:
        hits = ["collective.allreduce"] * 50
        assert _decisions(TF, env["HOROVOD_FAULT_SPEC"], 5, hits) == \
            _decisions(JF, env["HOROVOD_FAULT_SPEC"], 5, hits)


def test_unknown_point_refused(monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", "collective.nope:err")
    with pytest.raises(TErr, match="unknown fault point"):
        TF._load_from_env()
    TF.install("collective.allreduce:delay:1us")
    try:
        with pytest.raises(TErr, match="not registered"):
            TF.point("collective.nope")
        TF.point("collective.allreduce")
        assert TF.points_hit("collective.allreduce") == 1
        assert TF.injections() == {("collective.allreduce", "delay"): 1}
    finally:
        TF.clear()
    assert not TF.active() and TF.points_hit("collective.allreduce") == 0


# ---------------------------------------------------------------------------
# The collectives' bracket, np=2 gloo on the CPU
# ---------------------------------------------------------------------------

COUNTED = ["collective.allreduce", "collective.allgather",
           "collective.allgather_sizes", "collective.broadcast",
           "collective.alltoall", "collective.alltoall_splits",
           "collective.reducescatter", "chaos.straggler_delay"]
# A spec that names every point without acting: each hit is counted.
COUNT_SPEC = ",".join(f"{p}:delay:0s:0.000001" for p in COUNTED)

WORKER = r'''
import os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import faults
from horovod_tpu_torch.common.exceptions import HorovodInternalError

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
res = {}
x = torch.arange(6, dtype=torch.float32) + r

def calls():
    """The eager calls whose hits are counted (the test repeats them on
    the JAX package)."""
    hvd.allreduce(x)
    hvd.grouped_allreduce([x, x.half(), x[:2]])
    hvd.allgather(x[: r + 1])
    hvd.grouped_allgather([x, x[:2]])
    hvd.broadcast(x, root_rank=1)
    hvd.alltoall(x[:4])
    hvd.alltoall(x[:3], splits=[1, 2])
    hvd.reducescatter(x)
    hvd.grouped_reducescatter([x, x.half()])
    hvd.barrier()

faults.install(sys.argv[5])
calls()
res["hits"] = {p: faults.points_hit(p) for p in sys.argv[6].split(",")}

# An injected error: the 3rd allreduce from here raises on every rank,
# before it dispatches; the ones before it complete.
faults.install("collective.allreduce@3:err")
done = []
try:
    for k in range(5):
        done.append(hvd.allreduce(x, op=hvd.Sum))
except HorovodInternalError as e:
    res["raised"] = (len(done), type(e).__name__, str(e))

# ... and one raised inside backward: from the hook that dispatches a
# full bucket, and from SyncBatchNorm's backward allreduce.
faults.install("collective.allreduce@2:err")
lin = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Linear(4, 4))
opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1))
os.environ["HOROVOD_FUSION_THRESHOLD"] = "1"
try:
    lin(torch.ones(2, 4)).sum().backward()
except HorovodInternalError as e:
    res["hook"] = type(e).__name__
faults.install("collective.allreduce@2:err")
bn = hvd.SyncBatchNorm(3)
try:
    bn(torch.randn(4, 3, requires_grad=True)).sum().backward()
except HorovodInternalError as e:
    res["syncbn_backward"] = type(e).__name__
faults.clear()
hvd.barrier()
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def bracket_world(tmp_path_factory):
    src = (WORKER.replace("sys.argv[5]", repr(COUNT_SPEC))
           .replace("sys.argv[6]", repr(",".join(COUNTED))))
    return run_world(tmp_path_factory.mktemp("faults_np2"), 2, src)


def test_hit_counts_line_up_with_jax(bracket_world):
    """The same eager calls on the JAX package's 8-rank CPU world, over
    a process set of two ranks with per-rank inputs: every point counts
    the same hits, nested ones included (a grouped allreduce of two
    dtypes is two allreduces, a barrier's inner allreduce counts, a
    ragged allgather exchanges its sizes first)."""
    ps = jhvd.add_process_set([0, 1])
    pr = lambda f: jhvd.PerRank([f(r) for r in range(2)])  # noqa: E731
    x = lambda r: np.arange(6, dtype=np.float32) + r  # noqa: E731
    JF.install(COUNT_SPEC)
    try:
        JC.allreduce(pr(x), process_set=ps)
        JC.grouped_allreduce([pr(x), pr(lambda r: x(r).astype(np.float16)),
                              pr(lambda r: x(r)[:2])], process_set=ps)
        JC.allgather(jhvd.PerRank([x(0)[:1], x(1)[:2]]), process_set=ps)
        JC.grouped_allgather([pr(x), pr(lambda r: x(r)[:2])],
                             process_set=ps)
        JC.broadcast(pr(x), root_rank=1, process_set=ps)
        JC.alltoall(pr(lambda r: x(r)[:4]), process_set=ps)
        JC.alltoall(pr(lambda r: x(r)[:3]),
                    splits=jhvd.PerRank([np.asarray([1, 2], np.int32)] * 2),
                    process_set=ps)
        JC.reducescatter(pr(x), process_set=ps)
        JC.grouped_reducescatter(
            [pr(x), pr(lambda r: x(r).astype(np.float16))], process_set=ps)
        JC.barrier(process_set=ps)
        want = {p: JF.points_hit(p) for p in COUNTED}
    finally:
        JF.clear()
        jhvd.remove_process_set(ps)
    assert want["collective.allreduce"] == 4
    for d in bracket_world:
        assert d["hits"] == want


def test_injected_error_is_horovod_internal_error(bracket_world):
    for d in bracket_world:
        assert d["raised"] == (2, "HorovodInternalError",
                               "injected fault at collective.allreduce")


@pytest.mark.parametrize("key", ["hook", "syncbn_backward"])
def test_error_inside_backward_keeps_its_type(bracket_world, key):
    """The autograd engine re-raises the error of a post-accumulate-grad
    hook and of a Function's backward with its type, so elastic `run`
    catches it."""
    for d in bracket_world:
        assert d[key] == "HorovodInternalError"


PEER_DIES = r'''
import os, sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import HorovodInternalError

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
hvd.barrier()
if r == 1:
    os._exit(0)  # the peer dies: its sockets close under rank 0
res = {}
try:
    hvd.allreduce(torch.ones(1 << 16))
except HorovodInternalError as e:
    res["raised"] = type(e).__name__
    res["cause"] = type(e.__cause__).__name__
torch.save(res, f"{out_dir}/rank{r}.pt")
os._exit(0)
'''


def test_a_failed_process_group_raises_horovod_internal_error(tmp_path):
    """A real backend failure (the peer's process is gone) surfaces from
    the collective as HorovodInternalError, its torch error chained."""
    import os
    import subprocess
    import sys

    from test_torch_port_collectives import REPO
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    for k in [k for k in env if k.startswith("HOROVOD_")]:
        env.pop(k)
    url = f"file://{tmp_path}/rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-c", PEER_DIES, str(tmp_path), "2", str(r), url],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[0].returncode == 0, logs[0][-3000:]
    res = torch.load(tmp_path / "rank0.pt")
    assert res.get("raised") == "HorovodInternalError", (res, logs[0][-2000:])
    assert res["cause"] in ("DistBackendError", "RuntimeError")
