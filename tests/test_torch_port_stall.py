"""Port parity: the stall inspector (`horovod_tpu_torch/utils/
stall_inspector.py`) against the JAX package's
(`horovod_tpu/utils/stall_inspector.py`), mirroring
tests/test_stall_inspector.py and tests/test_aux.py's inspector tests.

The two-tier policy runs on a fake clock (`check(now=)`) in both
packages with the same thresholds, and the warnings and aborts must
read the same (the degraded-mode warning names each package's own
process).  The bracket's async entries stay open until their `Work`
completes.  Two gloo drills: rank 1 enters an allreduce late (rank 0
warns once and names rank 1 through the store reporter), and rank 1
never enters (rank 0 exits 57 past the shutdown threshold).
"""

import gc
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from horovod_tpu.utils import stall_inspector as J
from horovod_tpu_torch.metrics import catalog as MET
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.utils import stall_inspector as S

from test_torch_port_collectives import (LAUNCHER_ENV, REPO,  # noqa: F401
                                         no_launcher_env)

IDENTITY = re.compile(r"This process is [^;]*;")


def _pair(warn, shutdown):
    """A JAX and a port inspector with the same thresholds, each with its
    warnings and aborts collected."""
    out = []
    for mod in (J, S):
        warnings, aborts = [], []
        insp = mod.StallInspector(
            warn_time_seconds=warn, shutdown_time_seconds=shutdown,
            warn_fn=warnings.append, abort_fn=aborts.append)
        out.append((insp, warnings, aborts))
    return out


def test_two_tier_policy_fake_clock_matches_jax():
    pair = _pair(warn=10.0, shutdown=30.0)
    t0 = time.time()
    for insp, _, _ in pair:
        insp._pending[insp.record_start("ALLREDUCE:grad.w")] = (
            "ALLREDUCE:grad.w", t0, None)
    for dt, want in ((5, []), (15, ["ALLREDUCE:grad.w"]), (20, []),
                     (35, [])):
        got = [insp.check(now=t0 + dt) for insp, _, _ in pair]
        assert got == [want, want], dt
    (_, jw, ja), (_, pw, pa) = pair
    assert len(jw) == len(pw) == 1 and len(ja) == len(pa) == 1
    # The same words; each names its own process.
    assert IDENTITY.sub("", jw[0]) == IDENTITY.sub("", pw[0])
    assert "ALLREDUCE:grad.w" in pw[0]
    assert "rank attribution unavailable" in pw[0]
    assert "This process is" in pw[0]
    assert ja == pa
    assert "ALLREDUCE:grad.w" in pa[0]


def test_shutdown_tier_off_by_default_and_done_op_never_warns():
    for insp, warnings, aborts in _pair(warn=10.0, shutdown=0.0):
        t0 = time.time()
        insp.record_start("BARRIER")
        insp.record_end(insp.record_start("ALLGATHER:x"))
        insp.check(now=t0 + 1e6)
        assert len(warnings) == 1 and "BARRIER" in warnings[0]
        assert aborts == []
        assert insp.pending_ops() == ["BARRIER"]


def test_warn_once_on_the_real_clock():
    for insp, warnings, _ in _pair(warn=0.05, shutdown=0.0):
        key = insp.record_start("ALLREDUCE:grad.w")
        assert insp.check() == []
        time.sleep(0.06)
        assert insp.check() == ["ALLREDUCE:grad.w"]
        assert insp.check() == []
        insp.record_end(key)
        assert insp.pending_ops() == []
        assert len(warnings) == 1


def test_warning_and_abort_increment_metrics():
    w0 = MET.stall_warnings._solo().get()
    a0 = MET.stall_aborts._solo().get()
    (_, _, _), (insp, _, aborts) = _pair(warn=10.0, shutdown=30.0)
    t0 = time.time()
    insp.record_start("ALLREDUCE:g")
    insp.check(now=t0 + 15)
    assert MET.stall_warnings._solo().get() == w0 + 1
    assert MET.stall_aborts._solo().get() == a0
    assert MET.stall_laggards._solo().get() == 0
    insp.check(now=t0 + 40)
    assert MET.stall_aborts._solo().get() == a0 + 1 and len(aborts) == 1


def test_watchdog_thread():
    warnings = []
    insp = S.StallInspector(warn_time_seconds=0.02,
                            check_interval_seconds=0.01,
                            warn_fn=warnings.append)
    insp.start()
    try:
        insp.record_start("ALLGATHER:x")
        deadline = time.time() + 10
        while not warnings and time.time() < deadline:
            time.sleep(0.01)
    finally:
        insp.stop()
    assert warnings and "ALLGATHER:x" in warnings[0]
    assert insp._thread is None


class _Work:
    """A torch Work still in flight until `done`."""

    def __init__(self):
        self.done = False

    def is_completed(self):
        return self.done

    def wait(self):
        self.done = True


@pytest.fixture
def inspector():
    insp = S.StallInspector(warn_time_seconds=60.0)
    S._inspector = insp
    yield insp
    S._inspector = None


def test_async_entry_open_until_its_work_completes(inspector):
    work = _Work()
    with C._traced("ALLREDUCE", "hung") as tr:
        pending = tr.track(C._Pending([work], lambda: "out"))
    assert inspector.pending_ops() == ["ALLREDUCE:hung"]
    work.done = True
    assert inspector.pending_ops() == []  # the watchdog clears it itself


def test_wait_closes_the_entry_at_once_and_holds_no_reference(inspector):
    with C._traced("ALLGATHER", "w") as tr:
        pending = tr.track(C._Pending([_Work()], lambda: "out"))
    with inspector._lock:
        assert len(inspector._pending) == 1
    assert pending.wait() == "out"
    with inspector._lock:
        assert inspector._pending == {}
    # A handle dropped unwaited: the inspector kept no reference to it.
    with C._traced("BROADCAST", "dropped") as tr:
        tr.track(C._Pending([_Work()], lambda: None))
    gc.collect()
    assert inspector.pending_ops() == []


def test_sync_collectives_close_their_entries():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    insp = S.StallInspector(warn_time_seconds=60.0)
    orig, S._inspector = S.get_inspector(), insp
    try:
        out = hvd.allreduce(torch.ones(2), name="x")
        h = hvd.allreduce_async(torch.ones(2), name="y")
        hvd.synchronize(h)
        hvd.barrier()
        assert torch.equal(out, torch.ones(2))
        assert insp.pending_ops() == []
        assert insp._next_key == 4  # x, y, the barrier and its allreduce
    finally:
        S._inspector = orig
        hvd.shutdown()
    assert S.get_inspector() is None  # shutdown stopped init's inspector


def test_env(monkeypatch):
    monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    assert S.init_from_env() is None
    monkeypatch.delenv("HOROVOD_STALL_CHECK_DISABLE")
    monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "5")
    monkeypatch.setenv("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "9")
    si = S.init_from_env()
    try:
        assert si is S.get_inspector() and si.warn_time == 5.0
        assert si.shutdown_time == 9.0 and si.check_interval == 1.0
        assert si._reporter is None  # no process group: no store
        assert si._thread is not None
    finally:
        S.shutdown_inspector()
    assert S.get_inspector() is None


# ---------------------------------------------------------------------------
# Two-rank gloo drills
# ---------------------------------------------------------------------------

DRILL = r'''
import sys, time, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.metrics import catalog as MET
from horovod_tpu_torch.utils import stall_inspector as S

out_dir, n, r, url, mode = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
si = S.get_inspector()
warned = []
si._warn_fn = warned.append
hvd.barrier()
if r == 1:
    time.sleep(3.0 if mode == "late" else 60.0)
t0 = time.perf_counter()
out = hvd.allreduce(torch.full((4,), float(r + 1)), name="drill")
res = {"out": out, "wait_s": time.perf_counter() - t0, "warned": warned,
       "warnings": MET.stall_warnings._solo().get(),
       "laggards": MET.stall_laggards._solo().get(),
       "reporter": si._reporter is not None}
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


def _drill(tmp_path, mode, env, timeout):
    url = f"file://{tmp_path}/rendezvous"
    base = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1", **env)
    for k in LAUNCHER_ENV:
        base.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", DRILL, str(tmp_path), "2", str(r), url, mode],
        cwd=REPO, env=base, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    return procs


def test_late_rank_is_named_by_the_store_reporter(tmp_path):
    procs = _drill(tmp_path, "late",
                   {"HOROVOD_STALL_CHECK_TIME_SECONDS": "1"}, 120)
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    for x in res:
        assert torch.equal(x["out"], torch.full((4,), 1.5))
        assert x["reporter"]
    r0 = res[0]
    assert r0["wait_s"] >= 2.5
    assert len(r0["warned"]) == 1 and r0["warnings"] == 1
    msg = r0["warned"][0]
    assert "[ALLREDUCE:drill]" in msg
    assert "Ranks behind: rank 1 (at op" in msg, msg
    assert r0["laggards"] == 1
    assert res[1]["warned"] == [] and res[1]["warnings"] == 0


def test_missing_rank_aborts_past_the_shutdown_threshold(tmp_path):
    procs = _drill(tmp_path, "never",
                   {"HOROVOD_STALL_CHECK_TIME_SECONDS": "0.5",
                    "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "2"}, 60)
    try:
        log0 = procs[0].communicate(timeout=60)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    assert procs[0].returncode == 57, log0[-3000:]
    assert "Collective [ALLREDUCE:drill] stalled for" in log0
    assert "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS=2; aborting." in log0
    assert not (tmp_path / "rank0.pt").exists()
