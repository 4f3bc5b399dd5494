"""Port: elastic jobs on the CPU under the port's elastic driver.

Each job is `python -m horovod_tpu_torch.runner --host-discovery-script
S ...` (or `run(host_discovery_script=)`, or `ElasticExecutor`) on a
fake cluster: S prints a hosts file the test rewrites, and the hosts
hostA, hostB, hostC are run locally (HVD_TPU_FAKE_LOCAL_HOSTS).  The
workers train a small model under `DistributedOptimizer(SGD(momentum))`
and `TorchState` on `device="cpu"` over gloo, allreduce once an epoch,
and record every ENTER (after the sync) and COMMIT with the SHA-256 of
their parameters and optimizer state, as the JAX package's
tests/test_elastic_integration.py does with its workers.  Cases: static
completion; scale-up (the joiner's first entry carries rank 0's
state, and the final states are equal); graceful scale-down; a
worker's failure, its host's blacklisting and the degraded completion
(the survivor's collective fails within seconds, and it does not rejoin
the failed generation); a failed collective with no death behind it (an
in-place reset); the min-np abort; a hang caught by lease expiry;
`run(host_discovery_script=)` and `ElasticExecutor`.  The joiners
whose host sorts first or who die before their bootstrap are in
tests/test_torch_port_elastic_joins.py.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from test_torch_port_collectives import REPO, no_launcher_env  # noqa: F401

FAKE_HOSTS = "hostA,hostB,hostC"

WORKER = r'''
import hashlib, json, os, sys, time
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.runner import elastic_worker as ew

host = os.environ.get("HOROVOD_HOSTNAME", "localhost")
LOG = os.path.join(os.environ["TEST_LOG_DIR"],
                   f"worker-{host}-{os.environ.get('HOROVOD_SLOT', '0')}.jsonl")
INJECT_AT = int(os.environ.get("INJECT_AT", "-1"))
injected = []


def digest():
    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().numpy().tobytes())
    for st in opt.state_dict()["state"].values():
        for v in st.values():
            h.update(v.detach().numpy().tobytes())
    return h.hexdigest()


def record(event):
    with open(LOG, "a") as f:
        f.write(json.dumps({
            "event": event, "epoch": state.epoch, "digest": digest(),
            "rank": hvd.rank(), "size": hvd.size(), "gen": ew._known_gen,
            "backend": hvd.backend(), "pid": os.getpid(),
            "joining": ew.is_joining_worker(), "t": time.time(),
            "resets": len(state.reset_seconds)}) + "\n")


def maybe_fail():
    marker = os.environ.get("FAIL_MARKER")
    if marker and os.path.exists(marker):
        if open(marker).read().strip() == host:
            os._exit(1)


if host in os.environ.get("EXIT_BEFORE_INIT", "").split(","):
    time.sleep(2.0)  # the others reach this generation's bootstrap first
    os._exit(1)

hvd.init(device="cpu")  # registers with the driver first
torch.manual_seed(100 + hvd.rank())
model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Tanh(),
                            torch.nn.Linear(3, 1))
opt = hvd.DistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
    named_parameters=model.named_parameters())
if not ew.is_joining_worker():
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
state = hvd.elastic.TorchState(model, opt, epoch=0)


@hvd.elastic.run
def train(state):
    record("enter")
    while state.epoch < int(os.environ["NUM_EPOCHS"]):
        maybe_fail()
        if state.epoch == INJECT_AT and not injected:
            injected.append(1)  # a failed collective, no death behind it
            raise hvd.HorovodInternalError("injected")
        opt.zero_grad()
        x = torch.linspace(-1, 1, 8).reshape(2, 4) * (hvd.rank() + 1)
        model(x).square().sum().backward()
        opt.step()
        hvd.allreduce(torch.ones(3), op=hvd.Sum)
        time.sleep(float(os.environ["EPOCH_TIME"]))
        state.epoch += 1
        record("commit")
        state.commit()
    record("done")


train(state)
record("exit")
hvd.shutdown()
'''


class ElasticJob:
    """One `python -m horovod_tpu_torch.runner --host-discovery-script`
    run against a hosts file the test rewrites (the reference's
    discovery-script fakery)."""

    def __init__(self, tmp: Path, hosts, min_np=1, max_np=None,
                 num_epochs=6, epoch_time=0.3, extra_env=None):
        self.tmp = tmp
        self.hosts_file = tmp / "hosts.txt"
        self.set_hosts(hosts)
        self.log_dir = tmp / "logs"
        self.log_dir.mkdir()
        worker = tmp / "worker.py"
        worker.write_text(WORKER)
        script = tmp / "discover.sh"
        script.write_text(f"#!/bin/sh\ncat {self.hosts_file}\n")
        script.chmod(0o755)
        self.out_path = tmp / "driver.out"
        env = job_env(extra_env)
        env.update({"TEST_LOG_DIR": str(self.log_dir),
                    "NUM_EPOCHS": str(num_epochs),
                    "EPOCH_TIME": str(epoch_time),
                    "FAIL_MARKER": str(tmp / "fail_marker")})
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
               "--host-discovery-script", str(script),
               "--min-np", str(min_np)]
        if max_np:
            cmd += ["--max-np", str(max_np)]
        cmd += [sys.executable, str(worker)]
        self._out = open(self.out_path, "w")
        self.proc = subprocess.Popen(cmd, env=env, cwd=REPO,
                                     stdout=self._out,
                                     stderr=subprocess.STDOUT)

    def set_hosts(self, hosts):
        # Atomically: discovery never reads a half-written file.
        tmp = self.hosts_file.with_suffix(".tmp")
        tmp.write_text("".join(f"{h}:{s}\n" for h, s in hosts))
        tmp.rename(self.hosts_file)

    def fail_host(self, host):
        (self.tmp / "fail_marker").write_text(host)

    def output(self):
        self._out.flush()
        return self.out_path.read_text()

    def wait(self, timeout=60):
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            # SIGTERM first: the driver's handler tears its workers down.
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            raise AssertionError(f"elastic job hung:\n{self.output()}")
        finally:
            self._out.close()
        return self.proc.returncode, self.out_path.read_text()

    def histories(self):
        return {f.stem.replace("worker-", ""): [
            json.loads(line) for line in f.read_text().splitlines()]
            for f in self.log_dir.glob("worker-*.jsonl")}

    def wait_for(self, worker, event, min_epoch=0, timeout=60):
        deadline = time.time() + timeout
        while time.time() < deadline:
            for rec in self.histories().get(worker, []):
                if rec["event"] == event and rec["epoch"] >= min_epoch:
                    return rec
            if self.proc.poll() is not None:
                break
            time.sleep(0.1)
        raise AssertionError(
            f"{worker} never reached {event} (epoch >= {min_epoch}); "
            f"histories {self.histories()}; driver:\n{self.output()}")


def job_env(extra=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    env.update({"HVD_TPU_FAKE_LOCAL_HOSTS": FAKE_HOSTS,
                "OMP_NUM_THREADS": "1", "HOROVOD_ELASTIC_LEASE_TTL": "15"})
    env.update(extra or {})
    return env


def _commits(hist):
    return [r for r in hist if r["event"] == "commit"]


def test_static_completion(tmp_path):
    job = ElasticJob(tmp_path, [("hostA", 2)], num_epochs=3, epoch_time=0.05)
    rc, out = job.wait()
    assert rc == 0, out
    hist = job.histories()
    assert sorted(hist) == ["hostA-0", "hostA-1"]
    for h in hist.values():
        assert [r["event"] for r in h][-2:] == ["done", "exit"]
        assert [r["epoch"] for r in _commits(h)] == [1, 2, 3]
        assert {r["size"] for r in h} == {2} and h[0]["gen"] == 0
        assert h[0]["backend"] == "gloo" and not h[0]["joining"]
    assert hist["hostA-0"][-1]["digest"] == hist["hostA-1"][-1]["digest"]


def test_scale_up_the_joiner_takes_rank0s_state(tmp_path):
    job = ElasticJob(tmp_path, [("hostA", 1)], num_epochs=14,
                     epoch_time=0.3, max_np=2)
    job.wait_for("hostA-0", "commit", min_epoch=1)
    job.set_hosts([("hostA", 1), ("hostB", 1)])
    rc, out = job.wait()
    assert rc == 0, out
    hist = job.histories()
    a, b = hist["hostA-0"], hist["hostB-0"]
    assert a[-1]["event"] == b[-1]["event"] == "exit"
    assert a[-1]["size"] == b[-1]["size"] == 2
    # The joiner entered a later generation as a joiner; its first entry
    # (after its sync) carries rank 0's last commit, and rank 0 entered
    # the same generation with the same state (a membership change does
    # not roll back).
    enter_b = b[0]
    assert enter_b["event"] == "enter" and enter_b["gen"] >= 1
    assert enter_b["joining"] and enter_b["rank"] == 1
    enter_a = [r for r in a if r["event"] == "enter" and r["gen"] ==
               enter_b["gen"]][0]
    last_commit_a = [r for r in a if r["event"] == "commit"
                     and r["t"] < enter_a["t"]][-1]
    assert enter_b["digest"] == enter_a["digest"] == \
        last_commit_a["digest"]
    assert enter_b["epoch"] == enter_a["epoch"] == last_commit_a["epoch"]
    # After every sync both ranks hold one state.
    by_epoch = {r["epoch"]: r["digest"] for r in _commits(b)}
    assert by_epoch and all(r["digest"] == by_epoch[r["epoch"]]
                            for r in _commits(a) if r["epoch"] in by_epoch)
    assert a[-1]["digest"] == b[-1]["digest"]
    assert "hvd_elastic" not in out  # the driver logs, never raises


def test_scale_down_graceful(tmp_path):
    job = ElasticJob(tmp_path, [("hostA", 1), ("hostB", 1)], num_epochs=12,
                     epoch_time=0.3)
    job.wait_for("hostA-0", "commit", min_epoch=2)
    job.set_hosts([("hostA", 1)])
    rc, out = job.wait()
    assert rc == 0, out
    hist = job.histories()
    a, b = hist["hostA-0"], hist["hostB-0"]
    assert a[-1]["event"] == "exit" and a[-1]["size"] == 1
    assert max(r["epoch"] for r in a) == 12
    assert all(r["event"] != "exit" for r in b)  # removed, never finished
    assert [r["epoch"] for r in _commits(a)] == sorted(
        r["epoch"] for r in _commits(a))


def test_failure_blacklist_and_degraded_completion(tmp_path):
    """hostB's worker dies: the survivor's gloo collective raises within
    seconds, it waits for the degraded generation (not the failed one),
    restores its last commit and finishes alone."""
    job = ElasticJob(tmp_path, [("hostA", 1), ("hostB", 1)], num_epochs=12,
                     epoch_time=0.3)
    job.wait_for("hostB-0", "commit", min_epoch=2)
    job.fail_host("hostB")
    rc, out = job.wait()
    assert rc == 0, out
    assert "blacklisting host hostB" in out and "DEGRADED" in out, out
    hist = job.histories()
    a, b = hist["hostA-0"], hist["hostB-0"]
    assert a[-1]["event"] == "exit" and a[-1]["size"] == 1
    assert max(r["epoch"] for r in a) == 12
    re_enter = [r for r in a if r["event"] == "enter" and r["resets"] == 1]
    assert len(re_enter) == 1 and re_enter[0]["gen"] == 1
    assert re_enter[0]["size"] == 1
    last = [r for r in _commits(a) if r["t"] < re_enter[0]["t"]][-1]
    assert re_enter[0]["digest"] == last["digest"]
    # From hostB's last record to the survivor's re-entry: the failed
    # collective and the new generation took seconds, not the store's
    # 30-minute timeout.
    assert re_enter[0]["t"] - b[-1]["t"] < 15


def test_a_failed_collective_with_no_death_resets_in_place(tmp_path):
    """Both ranks fail one collective at epoch 3 and no worker dies: no
    new generation comes, and after the bounded wait both rejoin the
    same generation and finish together."""
    job = ElasticJob(tmp_path, [("hostA", 1), ("hostB", 1)], num_epochs=5,
                     epoch_time=0.05, extra_env={"INJECT_AT": "3"})
    rc, out = job.wait(timeout=90)
    assert rc == 0, out
    hist = job.histories()
    for h in hist.values():
        enters = [r for r in h if r["event"] == "enter"]
        assert [(r["gen"], r["size"], r["resets"]) for r in enters] == \
            [(0, 2, 0), (0, 2, 1)]
        assert enters[1]["epoch"] == 3
        assert h[-1]["event"] == "exit" and h[-1]["epoch"] == 5
    assert hist["hostA-0"][-1]["digest"] == hist["hostB-0"][-1]["digest"]
    assert "generation 1" not in out


def test_min_np_abort(tmp_path):
    job = ElasticJob(tmp_path, [("hostA", 1), ("hostB", 1)], min_np=2,
                     num_epochs=40, epoch_time=0.2)
    job.wait_for("hostB-0", "commit", min_epoch=1)
    job.fail_host("hostB")
    rc, out = job.wait()
    assert rc != 0
    assert "< min_np=2" in out, out


def test_a_hang_is_caught_by_lease_expiry(tmp_path):
    """hostB's heartbeat thread hangs (its process trains on): the driver
    fails it by lease expiry, blacklists hostB, and the survivor
    finishes in the degraded generation."""
    job = ElasticJob(tmp_path, [("hostA", 1), ("hostB", 1)], num_epochs=24,
                     epoch_time=0.3, extra_env={
                         "HOROVOD_FAULT_SPEC": "worker.heartbeat@4:hang:600s",
                         "HOROVOD_FAULT_HOSTS": "hostB",
                         "HOROVOD_ELASTIC_LEASE_TTL": "2",
                         "HOROVOD_ELASTIC_START_GRACE": "30"})
    rc, out = job.wait(timeout=90)
    assert rc == 0, out
    assert "heartbeat lease EXPIRED" in out, out
    assert "blacklisting host hostB" in out and "DEGRADED" in out, out
    a = job.histories()["hostA-0"]
    assert a[-1]["event"] == "exit" and a[-1]["size"] == 1
    assert max(r["epoch"] for r in a) == 24


FUNCS = '''
import os


def allreduce_rank():
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runner import elastic_worker

    hvd.init(device="cpu")  # registers with the driver first
    total = hvd.allreduce(torch.tensor([float(hvd.rank() + 1)]),
                          op=hvd.Sum)
    out = (hvd.rank(), hvd.size(), float(total[0]), elastic_worker._known_gen,
           os.environ["HOROVOD_LOCAL_SIZE"])
    hvd.shutdown()
    return out


def slot_of_worker(scale):
    return (int(os.environ["HOROVOD_RANK"]) * scale,
            os.environ["HOROVOD_HOSTNAME"], os.environ["HOROVOD_SLOT"],
            os.environ["HOROVOD_ELASTIC"])
'''


@pytest.fixture
def job_funcs(tmp_path, monkeypatch):
    """The functions the workers run, in a module of their own (pickled
    by reference, imported in the workers from HVD_TPU_RUN_FUNC_PATH);
    the driver runs in this process, so its SIGTERM handler is put
    back after."""
    (tmp_path / "elastic_job_funcs.py").write_text(FUNCS)
    monkeypatch.syspath_prepend(str(tmp_path))
    for k, v in job_env().items():
        if k.startswith(("HVD_TPU_", "OMP_", "PYTHONPATH")):
            monkeypatch.setenv(k, v)
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\necho hostA:2\necho hostB:1\n")
    script.chmod(0o755)
    handler = signal.getsignal(signal.SIGTERM)
    import elastic_job_funcs
    yield elastic_job_funcs, str(script)
    signal.signal(signal.SIGTERM, handler)
    sys.modules.pop("elastic_job_funcs", None)


def test_run_with_a_discovery_script(job_funcs):
    from horovod_tpu_torch.runner import run

    funcs, script = job_funcs
    out = run(funcs.allreduce_rank, np=3, min_np=3,
              host_discovery_script=script, start_timeout=60)
    # hostA and hostB are this machine (the fake-cluster hook): three
    # local ranks
    assert out == [(r, 3, 6.0, 0, "3") for r in range(3)]


def test_elastic_executor_returns_the_ranks_results(job_funcs):
    from horovod_tpu_torch.runner.executor import ElasticExecutor

    funcs, script = job_funcs
    ex = ElasticExecutor(script, min_np=2, max_np=2, start_timeout=60)
    assert ex.run(funcs.slot_of_worker, args=(10,)) == [
        (0, "hostA", "0", "1"), (10, "hostA", "1", "1")]
