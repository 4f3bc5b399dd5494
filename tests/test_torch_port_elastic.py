"""Port parity: elastic training (`horovod_tpu_torch/elastic/`,
`torch/elastic.py`, `elastic_resnet.py`).

- `ObjectState`, `ElasticSampler` and `TorchState` against the JAX
  package's, in this process (the JAX sampler's `basics.size/rank` and
  both samplers' object allgather patched to the port rank's view);
- `elastic_resnet` at depth 18, 32x32, batch 2 per rank, np=2 on the
  CPU over gloo: under an injected collective fault, and with a
  membership change reported at a step, the final parameters are
  bitwise those of the fault-free run (CPU kernels and a two-rank gloo
  sum are deterministic, so a replayed step is the same step);
- three resets in one process, over a `file://` and a `tcp://`
  coordinator: the runtime comes back on the same ranks each time, the
  work in flight at the reset is waited for, and a process set held
  across a reset refuses to run.

Comparisons are exact (attributes, indices, parameters, digests).
"""

import copy
import importlib
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from horovod_tpu import elastic as JE
import horovod_tpu.torch.elastic as JTE
from horovod_tpu_torch.torch import elastic as TTE

# The package `horovod_tpu_torch.elastic`; the attribute of that name is
# the torch namespace's `hvd.elastic` (torch/elastic.py), as in
# `import horovod_tpu_torch as hvd; hvd.elastic.TorchState`.
TE = importlib.import_module("horovod_tpu_torch.elastic")

from test_torch_port_collectives import REPO, run_world


class _Fragile:
    """A value whose copies fail once `broken` is set: a snapshot that
    cannot be restored."""

    broken = False

    def __init__(self, v):
        self.v = v

    def __deepcopy__(self, memo):
        if _Fragile.broken:
            raise RuntimeError("damaged snapshot")
        return _Fragile(self.v)

    def __eq__(self, other):
        return isinstance(other, _Fragile) and self.v == other.v


def _drive_object_state(mod):
    st = mod.ObjectState(epoch=0, batch=0, hist=[1], obj=_Fragile(1))
    trace = []
    st.epoch, st.hist = 1, st.hist + [2]
    st.save()
    st.epoch, st.batch = 5, 9
    st.hist.append(3)
    st.restore()
    trace.append((st.epoch, st.batch, list(st.hist), st.obj.v))
    st.obj = _Fragile(2)
    st.save()
    st.epoch = 7
    _Fragile.broken = True
    try:
        st.restore()  # the last commit fails: one commit further back
    except RuntimeError as e:
        trace.append(str(e))
    finally:
        _Fragile.broken = False
    trace.append((st.epoch, st.batch, list(st.hist), st.obj.v))
    return trace


def test_object_state_as_jax():
    assert _drive_object_state(TE) == _drive_object_state(JE)


@pytest.mark.parametrize("n", [2, 3])
def test_elastic_sampler_as_jax(monkeypatch, n):
    """For each rank of an n-rank world: the shards of two epochs, the
    batches recorded, and the union and new shards after a reset."""
    for r in range(n):
        monkeypatch.setattr(JE.basics, "size", lambda: n)
        monkeypatch.setattr(JE.basics, "rank", lambda r=r: r)
        monkeypatch.setattr(TE.basics, "size", lambda: n)
        monkeypatch.setattr(TE.basics, "rank", lambda r=r: r)
        traces = []
        for mod in (TE, JE):
            s = mod.ElasticSampler(12 * n + 1, shuffle=True, seed=4)
            t = [list(s)]
            s.record_batch(0, 3)
            s.record_batch(1, 3)
            t.append(list(s.processed_indices))
            # The other ranks processed the indices one past this rank's.
            monkeypatch.setattr(mod.F, "allgather_object", lambda obj: [
                obj] + [[(i + 1) % (12 * n + 1) for i in obj]] * (n - 1))
            s.reset()
            t += [list(s.processed_indices), list(s), len(s)]
            s.set_epoch(1)
            t += [list(s), s.processed_indices]
            traces.append([[int(i) for i in x] if isinstance(x, list) else x
                           for x in t])
        assert traces[0] == traces[1]


def test_torch_state_save_restore_as_jax():
    """The same model, optimizer and scalars through save / step /
    restore / step: the parameters, the optimizer state and the scalars
    are the JAX TorchState's after each, and the port's snapshot lives
    in host memory apart from the live tensors."""
    def drive(mod):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.ReLU(),
                                    torch.nn.Linear(3, 2))
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        st = mod.TorchState(model=model, optimizer=opt, epoch=0)
        x = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))

        def step():
            opt.zero_grad()
            model(x).square().sum().backward()
            opt.step()

        step()
        st.epoch = 1
        st.commit()
        saved = [p.detach().clone() for p in model.parameters()]
        step()
        step()
        st.epoch = 3
        st.restore()
        after_restore = ([p.detach().clone() for p in model.parameters()],
                         st.epoch, copy.deepcopy(opt.state_dict()["state"]))
        step()
        return saved, after_restore, [p.detach() for p in
                                      model.parameters()]

    got, want = drive(TTE), drive(JTE)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1][0], got[0]):
        assert torch.equal(a, b)  # restored to the commit
    assert got[1][1] == want[1][1] == 1
    for k in want[1][2]:
        assert torch.equal(got[1][2][k]["momentum_buffer"],
                           want[1][2][k]["momentum_buffer"])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


def test_torch_state_snapshot_is_apart_from_the_live_tensors():
    model = torch.nn.Linear(3, 3)
    st = TTE.TorchState(model=model, epoch=0)
    before = model.weight.detach().clone()
    with torch.no_grad():
        model.weight.add_(1.0)
    assert torch.equal(st._saved["__model__"]["weight"], before)
    st.restore()
    assert torch.equal(model.weight, before)


# ---------------------------------------------------------------------------
# elastic_resnet at np=2 on the CPU
# ---------------------------------------------------------------------------

ARGS = ["--device", "cpu", "--depth", "18", "--image-size", "32",
        "--num-classes", "10", "--batch-size", "2", "--epochs", "2",
        "--batches-per-epoch", "4", "--commit-every", "2", "--log-steps"]
# With seed 216 this spec fires at the 159th allreduce and next past the
# run's end: exactly one reset.  At 41 allreduces a step (20 batch norms
# each way and one bucket) that is in the fourth step's backward, after
# the commit at batch 2, so the error leaves the autograd engine and a
# finished step is rolled back (chip_smoke.elastic_fault_spec(8, 41)).
FAULT_ENV = {"HOROVOD_FAULT_SPEC": "collective.allreduce@149:err:0.001",
             "HOROVOD_FAULT_SEED": "216"}


def _records(text, tag):
    return [json.loads(line[len(tag) + 1:]) for line in text.splitlines()
            if line.startswith(tag + " ")]


def _run_elastic(tmp, extra_env=None, extra_args=()):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    for k in [k for k in env if k.startswith(("HOROVOD_", "HVD_TPU_"))]:
        env.pop(k)
    env.update(extra_env or {}, HOROVOD_COORDINATOR_ADDR=f"file://{tmp}/rdv",
               HOROVOD_NUM_PROCESSES="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.elastic_resnet", *ARGS,
         *extra_args], cwd=REPO, env=dict(env, HOROVOD_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return logs


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    runs = {}
    for name, env, args in (("clean", None, ()), ("fault", FAULT_ENV, ()),
                            ("notify", None, ("--notify-at-step", "2"))):
        tmp = tmp_path_factory.mktemp(f"elastic_{name}")
        runs[name] = _run_elastic(tmp, env, args)
    return runs


def _check_protocol(logs):
    """The checks of every run: per rank, each reset's restored digest
    is the one of its last commit; after each sync the ranks' digests
    agree; each epoch covered its indices exactly once."""
    for log in logs:
        commits, resets = [], 0
        for line in log.splitlines():
            if line.startswith("COMMIT "):
                commits.append(json.loads(line[7:])["digest"])
            elif line.startswith("RESET "):
                resets += 1
                assert json.loads(line[6:])["digest"] == commits[-1]
        for ep in _records(log, "EPOCH"):
            assert ep["covered"] and ep["no_repeats"], ep
        assert len(_records(log, "EPOCH")) == 2
    enters = [[e["digest"] for e in _records(log, "ENTER")] for log in logs]
    assert enters[0] == enters[1]


def test_clean_run(elastic_runs):
    logs = elastic_runs["clean"]
    _check_protocol(logs)
    sums = [_records(log, "SUMMARY")[0] for log in logs]
    assert [s["resets"] for s in sums] == [0, 0]
    assert sums[0]["digest"] == sums[1]["digest"]
    assert sums[0]["steps_run"] == 8


@pytest.mark.parametrize("name", ["fault", "notify"])
def test_recovered_run_ends_bitwise_on_the_clean_run(elastic_runs, name):
    """Under the injected fault each rank resets once, restores its last
    commit and replays; after the reported membership change it resets
    without a rollback (8 steps run).  Either way the final parameters
    and every step's loss are the clean run's, bit for bit."""
    clean = [_records(log, "SUMMARY")[0] for log in elastic_runs["clean"]]
    logs = elastic_runs[name]
    _check_protocol(logs)
    sums = [_records(log, "SUMMARY")[0] for log in logs]
    assert sums[0]["resets"] == sums[1]["resets"] == 1
    for s, c in zip(sums, clean):
        assert s["digest"] == c["digest"]
        assert s["losses"] == c["losses"]
    if name == "notify":
        assert [s["steps_run"] for s in sums] == [8, 8]
    else:
        assert all(s["steps_run"] > 8 for s in sums)
        for log in logs:
            assert "injected fault at collective.allreduce" in log


RESETS = r'''
import importlib, sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import HorovodTpuError

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
elastic = importlib.import_module("horovod_tpu_torch.elastic")
res = {"sums": [], "refused": [], "generations": []}
for k in range(3):
    old_global = hvd.global_process_set()
    sub = hvd.add_process_set([1])
    x = torch.full((1 << 14,), float(r + k))
    res["sums"].append(float(hvd.allreduce(x, op=hvd.Sum)[0]))
    # Work in flight at the reset: a bucket dispatched, never waited on.
    hvd.allreduce_async(x, op=hvd.Sum)
    elastic._reset()
    res["generations"].append(basics._generation)
    for ps in (old_global, sub):
        try:
            hvd.allreduce(x, process_set=ps)
            res["refused"].append(None)
        except HorovodTpuError as e:
            res["refused"].append(str(e))
    res["rank_size"] = (hvd.rank(), hvd.size())
res["after"] = float(hvd.allreduce(torch.ones(3), op=hvd.Sum)[0])
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.mark.parametrize("scheme", ["file", "tcp"])
def test_three_resets_in_one_process(tmp_path, scheme):
    if scheme == "tcp":
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        # run_world passes a file:// url; the worker takes the one given.
        src = RESETS.replace("sys.argv[4]", f'"tcp://127.0.0.1:{port}"')
    else:
        src = RESETS
    res = run_world(tmp_path, 2, src, timeout=240)
    for r, d in enumerate(res):
        assert d["sums"] == [1.0, 3.0, 5.0]
        assert d["generations"] == [2, 3, 4]
        assert d["rank_size"] == (r, 2)
        assert d["after"] == 2.0
        assert len(d["refused"]) == 6
        for msg in d["refused"]:
            assert msg is not None and "was removed" in msg
