"""Port parity: `horovod_tpu_torch.spark` (`run`, `run_elastic`,
`make_barrier_mapper`) against `horovod_tpu.spark`.

- The barrier mapper's env is JAX's for the same fake
  `BarrierTaskContext`, less HOROVOD_CONTROLLER and
  HOROVOD_CPU_OPERATIONS (each port rank picks NCCL or gloo in
  `hvd.init()`, as under the port's launcher).
- `run` and `run_elastic` under an in-process fake pyspark (the
  reference's fake-cluster pattern: no JVM).
- A real two-task barrier stage on the CPU: two processes each run the
  port's mapper under a fake `BarrierTaskContext` whose barrier is the
  port's rendezvous KV, and the mapped function allreduces over the
  process group the mapper's env bootstraps (the counterpart of
  `tests/test_spark.py::TestSparkBarrierCollectives`; the task script
  is `TASK` below).
- `chip_smoke.py`'s phase 28 (`cluster_prepare`, `cluster_rank`,
  `check_cluster`) at a small width on the CPU, its shards from
  `prepare_data` on a DataFrame and from the store's numpy writer.
"""

import base64
import os
import pickle
import subprocess
import sys
import types

import pytest

import horovod_tpu.spark as jax_spark
import horovod_tpu_torch.spark as port_spark
from horovod_tpu_torch.common.exceptions import HorovodTpuError

from test_torch_port_collectives import (  # noqa: F401  (autouse)
    REPO,
    no_launcher_env,
)

# Written by the JAX package's mapper only.
NOT_WRITTEN = ("HOROVOD_CONTROLLER", "HOROVOD_CPU_OPERATIONS")


@pytest.fixture(autouse=True)
def restore_environ():
    """The mapper writes `os.environ` (a barrier task's own process);
    put it back as it was."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


class _FakeTaskInfo:
    def __init__(self, address):
        self.address = address


class _FakeCtx:
    def __init__(self, rank, size, address="127.0.0.1:0"):
        self._rank, self._size, self._address = rank, size, address
        self.barriers = 0

    def partitionId(self):  # noqa: N802 — pyspark API name
        return self._rank

    def getTaskInfos(self):  # noqa: N802
        return [_FakeTaskInfo(self._address)] * self._size

    def barrier(self):
        self.barriers += 1  # sequential fake: nothing to synchronize


class _FakeRDD:
    def __init__(self, n):
        self._n = n

    def barrier(self):
        return self

    def mapPartitionsWithIndex(self, mapper):  # noqa: N802
        self._mapper = mapper
        return self

    def collect(self):
        rows = []
        saved = dict(os.environ)
        try:
            for r in range(self._n):
                rows.extend(self._mapper(r, iter([]),
                                         ctx=_FakeCtx(r, self._n)))
        finally:
            os.environ.clear()
            os.environ.update(saved)
        return rows


class _FakeConf:
    def get(self, key, default=None):
        return "127.0.0.1" if key == "spark.driver.host" else default


class _FakeSparkContext:
    defaultParallelism = 2

    def getConf(self):
        return _FakeConf()

    def parallelize(self, seq, n):
        return _FakeRDD(n)


@pytest.fixture()
def fake_pyspark(monkeypatch):
    mod = types.ModuleType("pyspark")
    mod.SparkContext = types.SimpleNamespace(
        _active_spark_context=_FakeSparkContext())
    monkeypatch.setitem(sys.modules, "pyspark", mod)
    return mod


def _fn_env_echo(tag):
    return (tag, os.environ["HOROVOD_RANK"], os.environ["HOROVOD_SIZE"])


def _fn_horovod_env():
    return {k: v for k, v in os.environ.items() if k.startswith("HOROVOD_")}


def _payload(fn, args=()):
    return base64.b64encode(pickle.dumps((fn, args, {}))).decode()


@pytest.mark.parametrize("rank,size,address,extra", [
    (0, 1, "127.0.0.1:0", None),
    (1, 3, "10.1.2.3:7077", None),
    (2, 4, "spark-exec-0:4040", {"HOROVOD_FUSION_THRESHOLD": 1024,
                                 "MY_FLAG": "x"}),
])
def test_mapper_env_is_jax_less_two_keys(rank, size, address, extra):
    got = {}
    for name, mod in (("jax", jax_spark), ("port", port_spark)):
        before = dict(os.environ)
        ctx = _FakeCtx(rank, size, address)
        mapper = mod.make_barrier_mapper(
            _payload(_fn_horovod_env), "10.0.0.9", 5555, "s3cr3t", extra)
        (out_rank, data), = list(mapper(rank, iter([]), ctx=ctx))
        assert out_rank == rank and ctx.barriers == 1
        got[name] = pickle.loads(base64.b64decode(data))
        if extra:
            assert os.environ["MY_FLAG"] == "x"
        os.environ.clear()
        os.environ.update(before)
    want = {k: v for k, v in got["jax"].items() if k not in NOT_WRITTEN}
    assert set(NOT_WRITTEN) <= set(got["jax"])
    assert got["port"] == want
    assert got["port"]["HOROVOD_COORDINATOR_ADDR"] == \
        f"{address.split(':')[0]}:{port_spark.COORDINATOR_PORT}"


def test_coordinator_port_is_jax():
    assert port_spark.COORDINATOR_PORT == jax_spark.COORDINATOR_PORT
    assert port_spark.__all__ == jax_spark.__all__


class TestSparkRun:
    def test_run_returns_results_by_rank(self, fake_pyspark):
        out = port_spark.run(_fn_env_echo, args=("t",), num_proc=3)
        assert out == [("t", "0", "3"), ("t", "1", "3"), ("t", "2", "3")]

    def test_run_results_are_jax(self, fake_pyspark):
        assert port_spark.run(_fn_env_echo, args=("j",), num_proc=2) == \
            jax_spark.run(_fn_env_echo, args=("j",), num_proc=2)

    def test_run_defaults_to_parallelism(self, fake_pyspark):
        assert len(port_spark.run(_fn_env_echo, args=("d",))) == 2

    def test_run_leaves_the_driver_env(self, fake_pyspark):
        before = dict(os.environ)
        port_spark.run(_fn_env_echo, args=("e",), num_proc=2,
                       extra_env={"MY_FLAG": "1"})
        assert dict(os.environ) == before

    def test_run_without_pyspark_raises_import_error(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "pyspark", None)
        with pytest.raises(ImportError, match="requires pyspark"):
            port_spark.run(_fn_env_echo)

    def test_run_without_context_raises(self, fake_pyspark):
        fake_pyspark.SparkContext._active_spark_context = None
        with pytest.raises(HorovodTpuError, match="No active SparkContext"):
            port_spark.run(_fn_env_echo)

    def test_run_missing_rank_raises(self, fake_pyspark, monkeypatch):
        monkeypatch.setattr(_FakeRDD, "collect", lambda self: [])
        with pytest.raises(HorovodTpuError, match=r"no result from ranks"):
            port_spark.run(_fn_env_echo, num_proc=2)

    @pytest.mark.parametrize("fail_above,min_np,want", [
        (2, 2, [4, 3, 2]), (0, 2, [4, 3, 2]), (3, None, [4, 3])])
    def test_run_elastic_shrinks_on_failure(self, fake_pyspark,
                                            monkeypatch, fail_above,
                                            min_np, want):
        calls = {}
        for name, mod in (("jax", jax_spark), ("port", port_spark)):
            calls[name] = []

            def flaky_run(fn, args=(), kwargs=None, num_proc=None,
                          _calls=calls[name], **kw):
                _calls.append(num_proc)
                if num_proc > fail_above:
                    raise RuntimeError("stage failed")
                return ["ok"] * num_proc

            monkeypatch.setattr(mod, "run", flaky_run)
            if fail_above < (min_np or 1):
                err = (HorovodTpuError if mod is port_spark
                       else jax_spark.HorovodTpuError)
                with pytest.raises(err, match="no successful run"):
                    mod.run_elastic(_fn_env_echo, num_proc=4,
                                    min_np=min_np)
            else:
                assert mod.run_elastic(_fn_env_echo, num_proc=4,
                                       min_np=min_np) == ["ok"] * fail_above
        assert calls["port"] == calls["jax"] == want


# ---------------------------------------------------------------------------
# A real two-task barrier stage: collectives through the mapper's env
# ---------------------------------------------------------------------------

TASK = r'''
import base64, os, pickle, sys

import horovod_tpu_torch.spark as hs
from horovod_tpu_torch.runner.rendezvous import RendezvousClient


class FakeTaskInfo:
    def __init__(self, address):
        self.address = address


class FakeBarrierTaskContext:
    def __init__(self, rank, size, client):
        self._rank, self._size, self._client = rank, size, client

    def partitionId(self):
        return self._rank

    def getTaskInfos(self):
        return [FakeTaskInfo("127.0.0.1:0") for _ in range(self._size)]

    def barrier(self):
        self._client.barrier("spark_stage", self._size, timeout=60)


def workload(scale):
    import torch
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    out = hvd.allreduce(torch.full((2,), float(hvd.rank() + 1) * scale),
                        op=hvd.Sum)
    res = ([float(v) for v in out], hvd.backend(), hvd.size())
    hvd.shutdown()
    return res


rank, size = int(sys.argv[1]), int(sys.argv[2])
addr, port = os.environ["TEST_RDV_ADDR"], int(os.environ["TEST_RDV_PORT"])
secret = os.environ["TEST_RDV_SECRET"]
client = RendezvousClient(addr, port, secret)
payload = base64.b64encode(pickle.dumps((workload, (10.0,), {}))).decode()
# A free port a test run: the default may be held by another test's
# socket in TIME_WAIT.
hs.COORDINATOR_PORT = int(os.environ["TEST_COORD_PORT"])
mapper = hs.make_barrier_mapper(payload, addr, port, secret)
(out_rank, data), = list(mapper(rank, iter([]),
                                ctx=FakeBarrierTaskContext(rank, size,
                                                           client)))
client.put(f"spark/result/{out_rank}", data)
'''


@pytest.mark.integration
def test_two_task_barrier_allreduce():
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer

    from test_torch_port_guard import _env

    server = RendezvousServer()
    port = server.start()
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord_port = s.getsockname()[1]
    env = _env()
    env.update({"TEST_RDV_ADDR": "127.0.0.1", "TEST_RDV_PORT": str(port),
                "TEST_RDV_SECRET": server.secret,
                "TEST_COORD_PORT": str(coord_port)})
    procs = [subprocess.Popen([sys.executable, "-c", TASK, str(r), "2"],
                              env=env, cwd=REPO) for r in range(2)]
    try:
        for p in procs:
            assert p.wait(timeout=240) == 0
        kv = server.kv()
        results = {}
        for r in range(2):
            raw = kv.get(f"spark/result/{r}")
            assert raw is not None, f"no result from task {r}"
            results[r] = pickle.loads(base64.b64decode(raw))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    # The sum over ranks of (rank + 1) * 10 on both tasks, over gloo.
    assert results[0] == results[1] == ([30.0, 30.0], "gloo", 2)


# ---------------------------------------------------------------------------
# chip_smoke's phase 28 (the barrier tasks running the torch estimator's
# worker loop), rehearsed on the CPU at a small width
# ---------------------------------------------------------------------------

@pytest.mark.integration
@pytest.mark.parametrize("branch", ["pandas", "numpy"])
def test_chip_smoke_cluster_phase_on_the_cpu(monkeypatch, branch):
    import chip_smoke

    from test_torch_port_guard import _env

    if branch == "numpy":  # the card's host may have no pandas
        monkeypatch.setitem(sys.modules, "pandas", None)
    prep = chip_smoke.cluster_setup()
    procs = []
    try:
        # The ranks start first and wait for the payload, as in the
        # whole run, where the driver's side runs beside their pair.
        for r in range(2):
            env = dict(_env(), **prep["env"], HOROVOD_PROCESS_ID=str(r),
                       HOROVOD_NUM_PROCESSES="2", OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "sys.exit(chip_smoke.cluster_rank())"], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        chip_smoke.cluster_prepare(prep, depth=18, image_size=32, batch=4,
                                   device="cpu")
        assert prep["branch"] == branch
        lines = []
        for p in procs:
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out[-4000:]
            lines.append(out.splitlines())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        chip_smoke.cluster_finish(prep)
    res = chip_smoke.check_cluster(lines, prep, "cpu", on_card=False)
    assert res["branch"] == branch
    assert not os.path.exists(prep["store"].prefix_path)


def test_chip_smoke_cluster_ranks_raise_the_drivers_failure(monkeypatch):
    """A failed driver side leaves its error beside the payload's path:
    the ranks, waiting for the payload, raise it at once."""
    import chip_smoke

    prep = chip_smoke.cluster_setup()
    try:
        with pytest.raises(HorovodTpuError, match="0 training rows"):
            chip_smoke.cluster_prepare(prep, batch=0)
        for k, v in dict(prep["env"], HOROVOD_PROCESS_ID="0",
                         HOROVOD_NUM_PROCESSES="2").items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="0 training rows"):
            chip_smoke.cluster_rank()
    finally:
        chip_smoke.cluster_finish(prep)
