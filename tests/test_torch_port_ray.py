"""Port parity: `horovod_tpu_torch.ray` against `horovod_tpu.ray`, both
over `tests/fake_ray.py`'s in-process fake cluster (the reference's own
test pattern), each package's `_ray` monkeypatched with a `FakeRay` of
its own.

- `assign_ranks` and `RayHostDiscovery`'s slots equal JAX's on the same
  hosts and nodes.
- The actor pool (start, run, failure, `run_remote`/`get`, not
  started): the envs `set_env` receives are JAX's for the same cluster,
  and `use_gpu=True` asks Ray for one GPU an actor (JAX's rejects it).
- Without ray, `RayExecutor` is the port's local `Executor` pool.
- The port's elastic driver through `RayTransport` and Ray discovery:
  a static run, a rescale up, a failing host blacklisted, the
  transport's termination.  The workers are real processes on the CPU.

The fake's actors run in this process, so `_WorkerImpl.set_env` writes
this process's `os.environ`, as JAX's does; every test here puts the
environment back as it found it (`restore_environ`).
"""

import os
import sys
import threading
import time

import pytest

import horovod_tpu.ray as jax_ray
import horovod_tpu_torch.ray as port_ray
from fake_ray import FakeRay
from horovod_tpu.common.exceptions import HorovodTpuError as JErr
from horovod_tpu_torch.common.exceptions import HorovodTpuError as PErr

from test_torch_port_collectives import (  # noqa: F401  (autouse)
    REPO,
    no_launcher_env,
)


@pytest.fixture(autouse=True)
def restore_environ():
    """Put `os.environ` back as it was: the fake's actors write it."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


class _RecordingRay(FakeRay):
    """FakeRay that also records the resources each `ray.remote` asks."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.remote_options = []

    def remote(self, *args, **kwargs):
        if kwargs:
            self.remote_options.append(dict(kwargs))
        return super().remote(*args, **kwargs)


@pytest.fixture()
def fake_ray(monkeypatch):
    fake = _RecordingRay()
    monkeypatch.setattr(port_ray, "_ray", fake)
    return fake


@pytest.fixture()
def both_rays(monkeypatch):
    """A fake cluster each for the JAX package and the port."""
    fakes = {"jax": _RecordingRay(), "port": _RecordingRay()}
    monkeypatch.setattr(jax_ray, "_ray", fakes["jax"])
    monkeypatch.setattr(port_ray, "_ray", fakes["port"])
    return fakes


def fn_const():
    return 42


def fn_boom():
    raise RuntimeError("boom from actor")


def fn_env(keys):
    return {k: os.environ.get(k) for k in keys}


HOSTS = [
    ["a"], ["a", "a", "a"], ["a", "b"], ["a", "b", "a", "b"],
    ["b", "a", "a", "c", "b", "a"], ["h1"] * 4 + ["h2"] * 4,
]


@pytest.mark.parametrize("hosts", HOSTS, ids=lambda h: ",".join(h))
def test_assign_ranks_is_jax(hosts):
    assert port_ray.assign_ranks(hosts) == jax_ray.assign_ranks(hosts)


NODES = {
    "cpus": ([
        {"Alive": True, "NodeManagerHostname": "a", "Resources": {"CPU": 4}},
        {"Alive": True, "NodeManagerHostname": "b", "Resources": {"CPU": 2}},
        {"Alive": False, "NodeManagerHostname": "dead",
         "Resources": {"CPU": 8}},
    ], 1, 1),
    "per_slot_and_min": ([
        {"Alive": True, "NodeManagerHostname": "a", "Resources": {"CPU": 5}},
        {"Alive": True, "NodeManagerHostname": "tiny", "Resources": {}},
    ], 2, 1),
    "small_cpu_zero_slots": ([
        {"Alive": True, "NodeManagerHostname": "small",
         "Resources": {"CPU": 1}},
        {"Alive": True, "NodeManagerHostname": "frac",
         "Resources": {"CPU": 0.5}},
        {"Alive": True, "NodeManagerHostname": "bare", "Resources": {}},
    ], 2, 1),
    "address_only_and_min_slots": ([
        {"Alive": True, "NodeManagerAddress": "10.0.0.2",
         "Resources": {"CPU": 8, "GPU": 1}},
        {"Alive": True, "NodeManagerHostname": "gpu-only",
         "Resources": {"GPU": 8}},
        {"Alive": True, "Resources": {"CPU": 4}},
    ], 3, 4),
}


@pytest.mark.parametrize("case", sorted(NODES))
def test_discovery_slots_are_jax(case):
    nodes, per_slot, min_slots = NODES[case]
    got = {}
    for name, mod in (("jax", jax_ray), ("port", port_ray)):
        fake = FakeRay(nodes)
        got[name] = mod.RayHostDiscovery(
            fake, cpus_per_slot=per_slot,
            min_slots=min_slots).find_available_hosts_and_slots()
    assert got["port"] == got["jax"]


def test_discovery_slots_of_the_jax_tests():
    fake = FakeRay(NODES["small_cpu_zero_slots"][0])
    assert port_ray.RayHostDiscovery(
        fake, cpus_per_slot=2).find_available_hosts_and_slots() == \
        {"small": 0, "frac": 0, "bare": 1}


def test_discovery_and_transport_need_ray(monkeypatch):
    monkeypatch.setattr(port_ray, "_ray", None)
    assert not port_ray.ray_available()
    for cls in (port_ray.RayHostDiscovery, port_ray.RayTransport):
        with pytest.raises(PErr, match="requires ray"):
            cls()


class TestRayExecutorActors:
    @pytest.mark.parametrize("n,extra", [(1, None), (3, None),
                                         (2, {"MY_FLAG": 7})])
    def test_start_envs_are_jax(self, both_rays, n, extra):
        envs = {}
        for name, mod in (("jax", jax_ray), ("port", port_ray)):
            ex = mod.RayExecutor(num_workers=n, extra_env=extra)
            ex.start()
            envs[name] = [c[2][0] for c in both_rays[name].calls
                          if c[1] == "set_env"]
            ex.shutdown()
        assert len(envs["port"]) == n
        assert envs["port"] == envs["jax"]

    def test_start_assigns_ranks_and_runs(self, fake_ray):
        ex = port_ray.RayExecutor(num_workers=3)
        ex.start()
        assert len(fake_ray.actors) == 3
        set_envs = [c for c in fake_ray.calls if c[1] == "set_env"]
        assert len(set_envs) == 3
        assert sorted(int(c[2][0]["HOROVOD_RANK"]) for c in set_envs) == \
            [0, 1, 2]
        coords = {c[2][0]["HOROVOD_COORDINATOR_ADDR"] for c in set_envs}
        from horovod_tpu_torch.runner.exec_run import DEFAULT_COORDINATOR_PORT
        assert len(coords) == 1
        assert coords.pop().endswith(f":{DEFAULT_COORDINATOR_PORT}")
        assert {int(c[2][0]["HOROVOD_SIZE"]) for c in set_envs} == {3}
        assert ex.run(fn_const) == [42, 42, 42]
        # The actors share this process: set_env wrote its environment,
        # as JAX's does (the last actor's values).
        assert ex.run(fn_env, args=(["HOROVOD_SIZE"],)) == \
            [{"HOROVOD_SIZE": "3"}] * 3
        ex.shutdown()
        assert all(not a._alive for a in fake_ray.actors)

    def test_failure_propagates(self, fake_ray):
        ex = port_ray.RayExecutor(num_workers=2)
        ex.start()
        with pytest.raises(RuntimeError, match="boom from actor"):
            ex.run(fn_boom)
        assert ex.run(fn_const) == [42, 42]
        ex.shutdown()

    def test_run_remote_then_get(self, fake_ray):
        ex = port_ray.RayExecutor(num_workers=2)
        ex.start()
        tokens = ex.run_remote(fn_const)
        assert ex.get(tokens) == [42, 42]
        assert ex.execute(fn_const) == [42, 42]
        ex.shutdown()

    def test_not_started_raises(self, fake_ray):
        with pytest.raises(PErr, match="not started"):
            port_ray.RayExecutor(num_workers=2).run(fn_const)

    def test_use_gpu_asks_one_gpu_an_actor(self, both_rays):
        # JAX's build rejects the flag; the port gives it upstream's
        # meaning (ROADMAP, reference behaviours).
        with pytest.raises(JErr, match="use_gpu"):
            jax_ray.RayExecutor(num_workers=1, use_gpu=True)
        for use_gpu, gpus in ((True, 1), (False, 0)):
            fake = both_rays["port"]
            fake.remote_options.clear()
            ex = port_ray.RayExecutor(num_workers=2, cpus_per_worker=3,
                                      use_gpu=use_gpu)
            ex.start()
            assert fake.remote_options == [{"num_cpus": 3, "num_gpus": gpus}]
            ex.shutdown()


def test_without_ray_the_local_pool_runs(monkeypatch):
    monkeypatch.setattr(port_ray, "_ray", None)
    ex = port_ray.RayExecutor(num_workers=2, extra_env={"MY_FLAG": "on"})
    ex.start()
    try:
        assert ex.run(fn_env, args=(["HOROVOD_RANK", "HOROVOD_SIZE",
                                     "MY_FLAG"],)) == [
            {"HOROVOD_RANK": str(r), "HOROVOD_SIZE": "2", "MY_FLAG": "on"}
            for r in range(2)]
        assert ex.get(ex.run_remote(fn_const)) == [42, 42]
    finally:
        ex.shutdown()


def test_elastic_without_ray_needs_a_script(monkeypatch):
    monkeypatch.setattr(port_ray, "_ray", None)
    with pytest.raises(PErr, match="discovery"):
        port_ray.ElasticRayExecutor(min_np=1)


# ---------------------------------------------------------------------------
# The elastic driver with Ray discovery and the Ray transport
# ---------------------------------------------------------------------------

FUNCS = '''
import os
import sys
import time


def elastic_size():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")  # registers with the driver first
    size = hvd.size()
    hvd.shutdown()
    return size, int(os.environ["HOROVOD_SIZE"])


def elastic_epochs():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    state = hvd.elastic.ObjectState(epoch=0)

    @hvd.elastic.run
    def train(state):
        num_epochs = int(os.environ.get("NUM_EPOCHS", "6"))
        marker = os.environ.get("FAIL_MARKER")
        while state.epoch < num_epochs:
            if marker and os.path.exists(marker):
                with open(marker) as f:
                    if f.read().strip() == os.environ.get(
                            "HOROVOD_HOSTNAME"):
                        sys.exit(1)
            time.sleep(float(os.environ.get("EPOCH_TIME", "0.4")))
            state.epoch += 1
            state.commit()
            if os.environ.get("EPOCH_MARKER"):
                open(os.environ["EPOCH_MARKER"], "a").close()
        return hvd.size()

    size = train(state)
    hvd.shutdown()
    return size
'''


@pytest.fixture
def funcs(tmp_path, monkeypatch):
    """The workers' functions in a module of their own (pickled by
    reference; the workers import it from HVD_TPU_RUN_FUNC_PATH)."""
    import signal

    (tmp_path / "ray_port_funcs.py").write_text(FUNCS)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    handler = signal.getsignal(signal.SIGTERM)
    import ray_port_funcs
    yield ray_port_funcs
    signal.signal(signal.SIGTERM, handler)
    sys.modules.pop("ray_port_funcs", None)


@pytest.mark.integration
class TestElasticRayNative:
    def test_static_run(self, fake_ray, funcs):
        ex = port_ray.ElasticRayExecutor(min_np=2, cpus_per_slot=1)
        assert ex.run(funcs.elastic_size) == [(2, 2), (2, 2)]
        # The workers went through the agent actor, not a local fork.
        assert len([c for c in fake_ray.calls if c[1] == "spawn"]) == 2
        assert all(not a._alive for a in fake_ray.actors)

    @pytest.mark.parametrize("when", ["after_2s", "after_a_commit"])
    def test_rescale_up_mid_run(self, fake_ray, funcs, monkeypatch,
                                tmp_path, when):
        """`after_2s` is JAX's timing: the first worker takes longer than
        that to start, so it registers into the grown generation (and
        syncs with the joiner at its start, `registered_late`);
        `after_a_commit` grows the cluster once it trains, so that it
        sees the generation bump at a commit and resets."""
        monkeypatch.setenv("NUM_EPOCHS", "8")
        monkeypatch.setenv("EPOCH_TIME", "0.4")
        marker = tmp_path / "committed"
        monkeypatch.setenv("EPOCH_MARKER", str(marker))
        node = {"Alive": True, "NodeManagerHostname": "127.0.0.1",
                "NodeManagerAddress": "127.0.0.1", "Resources": {"CPU": 1}}
        fake_ray.set_nodes([node])

        def grow():
            if when == "after_2s":
                time.sleep(2.0)
            else:
                deadline = time.time() + 60
                while not marker.exists() and time.time() < deadline:
                    time.sleep(0.05)
            fake_ray.set_nodes([dict(node, Resources={"CPU": 2})])

        t = threading.Thread(target=grow, daemon=True)
        t.start()
        results = port_ray.ElasticRayExecutor(
            min_np=1, cpus_per_slot=1).run(funcs.elastic_epochs)
        t.join()
        # Both final-generation workers finished at size 2.
        assert sorted(results) == [2, 2]

    def test_worker_failure_blacklists_host(self, fake_ray, funcs,
                                            monkeypatch, tmp_path):
        monkeypatch.setenv("NUM_EPOCHS", "6")
        monkeypatch.setenv("EPOCH_TIME", "0.4")
        monkeypatch.setenv("HVD_TPU_FAKE_LOCAL_HOSTS", "hostA,hostB")
        marker = tmp_path / "fail_marker"
        fake_ray.set_nodes([
            {"Alive": True, "NodeManagerHostname": h,
             "Resources": {"CPU": 1}} for h in ("hostA", "hostB")])

        def fail_b():
            time.sleep(1.5)
            marker.write_text("hostB")

        t = threading.Thread(target=fail_b, daemon=True)
        t.start()
        results = port_ray.ElasticRayExecutor(
            min_np=1, cpus_per_slot=1,
            extra_env={"FAIL_MARKER": str(marker)}).run(funcs.elastic_epochs)
        t.join()
        # hostB died and was blacklisted; hostA finished alone.
        assert results == [1]

    def test_ray_transport_terminates_removed_workers(self, fake_ray):
        tr = port_ray.RayTransport(fake_ray)
        h = tr.execute([sys.executable, "-c", "import time; time.sleep(60)"],
                       env={"HOROVOD_HOSTNAME": "127.0.0.1",
                            "PATH": os.environ.get("PATH", "")},
                       prefix="t")
        assert h.poll() is None
        # Pinned to the node the cluster advertises for the host.
        assert fake_ray.actors[0]._opts == {
            "resources": {"node:127.0.0.1": 0.001}}
        tr.terminate([h])
        deadline = time.time() + 10
        while h.poll() is None and time.time() < deadline:
            time.sleep(0.1)
        assert h.poll() is not None
        tr.shutdown()
        assert not fake_ray.actors[0]._alive

    def test_a_dead_agent_reads_as_a_failed_worker(self, fake_ray):
        tr = port_ray.RayTransport(fake_ray)
        agent = tr._agent_for("127.0.0.1")
        fake_ray.kill(agent)
        h = tr.execute(["true"], env={"HOROVOD_HOSTNAME": "127.0.0.1"},
                       prefix="t")
        assert h.poll() == -1 and h.agent is None
        # The dead agent was dropped: the next spawn makes a new one.
        assert "127.0.0.1" not in tr._agents
