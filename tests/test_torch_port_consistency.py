"""The port's collective consistency check (`utils/consistency.py`,
wired into `ops/collectives.py _joinable`) against the JAX package's:
the signature a call submits is JAX's, matching collectives pass,
mismatched ones (shape, op, a missing peer) fail fast with JAX's
messages and the per-rank dump, and a process set's check waits on its
members only.  Ranks are gloo processes on the CPU under the port's
launcher."""

import json
import os
import subprocess
import sys
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.common.basics import ProcessSet as JPS
from horovod_tpu.ops import collectives as JC
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.basics import ProcessSet as PPS
from horovod_tpu_torch.ops import collectives as PC
from horovod_tpu_torch.runner import rendezvous as PR
from horovod_tpu_torch.utils import consistency as PCC

from test_torch_port_collectives import REPO, no_launcher_env  # noqa: F401

NP_DT = {"float32": np.float32, "float16": np.float16, "int64": np.int64,
         "bfloat16": ml_dtypes.bfloat16}
T_DT = {"float32": torch.float32, "float16": torch.float16,
        "int64": torch.int64, "bfloat16": torch.bfloat16}

# (kind, [(shape, dtype)], keyword arguments by name)
CASES = [
    ("allreduce", [((2, 3), "float32")], {"op": "Sum"}),
    ("allreduce", [((4,), "bfloat16")], {"op": "Average", "prescale": 0.5,
                                         "postscale": 2.0}),
    ("grouped_allreduce", [((2,), "float32"), ((3, 1), "float16")],
     {"op": "Max"}),
    ("allgather", [((5, 2), "float32")], {}),
    ("grouped_allgather", [((3,), "int64"), ((1, 4), "float32")], {}),
    ("broadcast", [((3,), "int64")], {"root_rank": 1}),
    ("alltoall", [((4, 4), "float32")], {"process_set": [0, 1]}),
    ("barrier", [], {}),
    ("reducescatter", [((6,), "float32")], {"op": "Sum",
                                            "extra": {"splits": [1, 2]}}),
]


def _record(pkg_mod, ps_cls, monkeypatch, kind, specs, kw):
    seen = []
    monkeypatch.setattr(pkg_mod._cc, "enabled", lambda: True)
    monkeypatch.setattr(pkg_mod._cc, "check",
                        lambda sig, ranks=None: seen.append((sig, ranks)))
    jax_side = pkg_mod is JC
    tensors = [np.zeros(s, NP_DT[d]) if jax_side
               else torch.zeros(s, dtype=T_DT[d]) for s, d in specs]
    args = dict(kw)
    if "op" in args:
        args["op"] = getattr(pkg_mod, args["op"])
    if "process_set" in args:
        args["process_set"] = ps_cls(ranks=args["process_set"],
                                     process_set_id=2)
    with pkg_mod._joinable(kind, tensors, **args):
        with pkg_mod._joinable("allreduce", tensors[:1]):
            pass  # nested: submits nothing
    return seen


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_the_signature_is_jaxs(monkeypatch, case):
    kind, specs, kw = case
    got = _record(PC, PPS, monkeypatch, kind, specs, kw)
    want = _record(JC, JPS, monkeypatch, kind, specs, kw)
    assert got == want and len(got) == 1


def test_check_is_off_by_default_and_at_one_rank(monkeypatch):
    calls = []
    monkeypatch.setattr(PCC, "_client", lambda: calls.append(1))
    monkeypatch.delenv("HOROVOD_COLLECTIVE_CONSISTENCY_CHECK",
                       raising=False)
    assert not PCC.enabled()
    PCC.check({"kind": "allreduce"})
    monkeypatch.setenv("HOROVOD_COLLECTIVE_CONSISTENCY_CHECK", "1")
    monkeypatch.setattr(basics, "size", lambda: 1)
    PCC.check({"kind": "allreduce"})
    assert calls == []


def test_old_keys_are_reclaimed_and_reset_moves_the_namespace(monkeypatch):
    """A rank deletes its own key _GC_LAG checks back; a reset() starts
    a new round, so keys of before it satisfy nothing."""
    server = PR.RendezvousServer(prefer_native=False)
    port = server.start()
    try:
        monkeypatch.setenv("HOROVOD_COLLECTIVE_CONSISTENCY_CHECK", "1")
        monkeypatch.setenv("HOROVOD_CONSISTENCY_TIMEOUT", "0.5")
        monkeypatch.setenv("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1")
        monkeypatch.setenv("HOROVOD_RENDEZVOUS_PORT", str(port))
        monkeypatch.setenv("HOROVOD_SECRET_KEY", server.secret)
        monkeypatch.setattr(basics, "size", lambda: 2)
        monkeypatch.setattr(basics, "rank", lambda: 0)
        PCC.reset()
        sig = {"kind": "allreduce", "shapes": [[2]]}
        ns = PCC._ns()
        kv = server.kv()
        for s in range(6):  # rank 1's submissions, ahead of rank 0
            kv.put(f"{ns}/0-1/{s}/1", json.dumps(sig, sort_keys=True))
        for _ in range(6):
            PCC.check(sig)
        assert kv.keys(f"{ns}/0-1/") == sorted(
            [f"{ns}/0-1/{s}/1" for s in range(6)]
            + [f"{ns}/0-1/{s}/0" for s in (4, 5)]
            + [f"{ns}/0-1/{s}/0" for s in (2, 3)])
        PCC.reset()
        assert PCC._ns() != ns
        t0 = time.monotonic()
        with pytest.raises(Exception, match=r"processes \[1\] did not "
                           r"submit collective #0 within 0.5s"):
            PCC.check(sig)
        assert time.monotonic() - t0 < 5
    finally:
        PCC.reset()
        server.stop()


WORKER = r'''
import os, sys, time
import torch
import horovod_tpu_torch as hvd

case = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
# Longer than the check's timeout.
away = float(os.environ["HOROVOD_CONSISTENCY_TIMEOUT"]) + 2
if case == "ok":
    ps = hvd.add_process_set([0, 1])
    t0 = time.monotonic()
    if r in (0, 1):
        # Rank 2 is away for longer than the timeout: the set's checks
        # must not wait on it.
        for k in range(3):
            y = hvd.allreduce(torch.ones(2) * (r + 1), op=hvd.Sum,
                              process_set=ps)
            assert y.tolist() == [3.0, 3.0], y
        print("SET_DONE", r, time.monotonic() - t0 < away, flush=True)
    time.sleep(away)
    y = hvd.allreduce(torch.ones(1), op=hvd.Sum)
    hvd.barrier()
    print("ALL_DONE", r, y.item(), flush=True)
elif case == "shape":
    hvd.allreduce(torch.ones(2 + r), op=hvd.Sum)
elif case == "op":
    hvd.allreduce(torch.ones(2), op=hvd.Sum if r == 0 else hvd.Max)
elif case == "missing":
    if r == 0:
        hvd.allreduce(torch.ones(2), op=hvd.Sum)
    else:
        time.sleep(away + 3)
hvd.shutdown()
'''


def _launch(tmp_path, np_, case, timeout_s):
    worker = tmp_path / "cc_worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, HOROVOD_COLLECTIVE_CONSISTENCY_CHECK="1",
               HOROVOD_CONSISTENCY_TIMEOUT=str(timeout_s),
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(np_),
         sys.executable, str(worker), case],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    return r, time.monotonic() - t0


def test_a_process_set_check_does_not_wait_on_non_members(tmp_path):
    r, _ = _launch(tmp_path, 3, "ok", 3)
    assert r.returncode == 0, r.stdout + r.stderr
    for k in (0, 1):
        assert f"SET_DONE {k} True" in r.stdout
    for k in range(3):
        assert f"ALL_DONE {k} 3.0" in r.stdout


@pytest.mark.parametrize("case,lines", [
    ("shape", ['collective consistency check FAILED at collective #0',
               'process 0: {"dtypes": ["float32"], "kind": "allreduce", '
               '"op": "Sum", "shapes": [[2]]}',
               'process 1: {"dtypes": ["float32"], "kind": "allreduce", '
               '"op": "Sum", "shapes": [[3]]}']),
    ("op", ['collective consistency check FAILED at collective #0',
            '"op": "Sum"', '"op": "Max"']),
    ("missing", ['collective consistency check: processes [1] did not '
                 'submit collective #0 within 4.0s']),
])
def test_a_mismatch_fails_fast_with_the_dump(tmp_path, case, lines):
    r, took = _launch(tmp_path, 2, case, 4.0)
    out = r.stdout + r.stderr
    assert r.returncode != 0, out
    for line in lines:
        assert line in out, out
    assert took < 4.0 + 30
