"""`horovod_tpu_torch.ray` — Ray-cluster adapter (counterpart of
`horovod_tpu/ray/__init__.py`; reference: horovod/ray/runner.py
`RayExecutor`, elastic.py `ElasticRayExecutor` + `RayHostDiscovery`).

Two layers, both with real code paths whether the `ray` import is the
genuine package or an injected test fake (the reference's own tests run
against a local fake cluster):

- **RayExecutor**: reference-shaped actor pool.  `start()` creates one
  actor per worker, assigns Horovod ranks grouped by host
  (`assign_ranks`), and injects the collective-bootstrap env (the
  coordinator is rank 0's c10d TCPStore on the first actor's host);
  `run`/`execute`/`run_remote`/`get` dispatch callables.  Without ray
  installed it delegates to the local process-pool `Executor`.
  `use_gpu=True` asks Ray for one GPU an actor (each rank's
  `hvd.init()` then takes its card), as upstream does.
- **ElasticRayExecutor**: the port's elastic driver
  (`runner/elastic/driver.py`) with Ray as discovery (`RayHostDiscovery`
  polls `ray.nodes()`) and transport (`RayTransport`: per-host agent
  actors spawn the worker processes instead of local fork/ssh).

    from horovod_tpu_torch.ray import RayExecutor
    ex = RayExecutor(num_workers=4, use_gpu=True)
    ex.start()
    ex.run(train_fn)
    ex.shutdown()
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, Dict, List, Optional

from ..common.exceptions import HorovodTpuError
from ..runner.elastic.discovery import HostDiscovery
from ..runner.elastic.driver import ExecTransport
from ..runner.executor import ElasticExecutor, Executor

try:
    import ray as _ray
except ImportError:  # pragma: no cover — ray is not a dependency
    _ray = None


def _ray_mod():
    """The live ray module: the real import, or a test-injected fake
    (tests monkeypatch this module's `_ray`)."""
    return _ray


def ray_available() -> bool:
    return _ray_mod() is not None


def assign_ranks(worker_hostnames: List[str]) -> List[Dict[str, int]]:
    """Horovod env ranks for actors grouped by host (reference:
    horovod/ray/utils.py map_blocking + runner.py's rank bookkeeping).

    Actors on the same host get consecutive local ranks; hosts are
    ordered by first appearance so rank 0 lands on the first host.
    """
    size = len(worker_hostnames)
    host_order: List[str] = []
    for h in worker_hostnames:
        if h not in host_order:
            host_order.append(h)
    local_counts: Dict[str, int] = {h: 0 for h in host_order}
    out: List[Dict[str, int]] = []
    for rank, h in enumerate(worker_hostnames):
        out.append({
            "HOROVOD_RANK": rank,
            "HOROVOD_SIZE": size,
            "HOROVOD_LOCAL_RANK": local_counts[h],
            "HOROVOD_CROSS_RANK": host_order.index(h),
            "HOROVOD_CROSS_SIZE": len(host_order),
        })
        local_counts[h] += 1
    for env in out:
        env["HOROVOD_LOCAL_SIZE"] = local_counts[
            worker_hostnames[env["HOROVOD_RANK"]]]
    return out


# ---------------------------------------------------------------------------
# Actor implementations (decorated with ray.remote at call time so the
# same classes serve the real package and an injected fake)
# ---------------------------------------------------------------------------

class _WorkerImpl:
    """Per-rank worker actor (reference: runner.py BaseHorovodWorker)."""

    def hostname(self):
        return socket.gethostname()

    def set_env(self, env):
        os.environ.update({k: str(v) for k, v in env.items()})
        return True

    def env(self, keys):
        return {k: os.environ.get(k) for k in keys}

    def exec_fn(self, fn, args, kwargs):
        return fn(*args, **kwargs)


class _HostAgentImpl:
    """Per-host agent actor for elastic runs: spawns/polls/kills worker
    processes on its node (the ray analog of the ssh hop; workers stay
    real OS processes so a worker crash cannot take the agent down)."""

    def __init__(self):
        self._procs: Dict[int, Any] = {}

    def hostname(self):
        return socket.gethostname()

    def spawn(self, cmd, env, prefix, cwd):
        from ..runner import safe_exec
        prev = os.getcwd()
        os.chdir(cwd)
        try:
            handle = safe_exec.execute(cmd, env=env, prefix=prefix,
                                       background=True)
        finally:
            os.chdir(prev)
        self._procs[handle.pid] = handle
        return handle.pid

    def poll(self, pid):
        handle = self._procs.get(pid)
        # An unknown pid (agent restarted) reads as failed, which the
        # driver answers with a respawn — the safe direction.
        return -1 if handle is None else handle.poll()

    def terminate(self, pids):
        from ..runner import safe_exec
        live = [p for p in pids
                if p in self._procs and self._procs[p].poll() is None]
        if live:
            safe_exec.terminate_trees(live)
        return True


class RayHostDiscovery(HostDiscovery):
    """Cluster membership from `ray.nodes()` (reference:
    horovod/ray/elastic.py RayHostDiscovery): alive nodes map to
    {hostname: slots} with slots = floor(CPU / cpus_per_slot).  The
    `min_slots` floor applies only when the node advertises no CPU
    resource at all; a node advertising fractional/small CPU below
    `cpus_per_slot` gets 0 slots — advertised capacity is authoritative
    and is never oversubscribed."""

    def __init__(self, ray_mod=None, cpus_per_slot: int = 1,
                 min_slots: int = 1):
        self._ray = ray_mod or _ray_mod()
        if self._ray is None:
            raise HorovodTpuError("RayHostDiscovery requires ray")
        self._cpus_per_slot = max(1, int(cpus_per_slot))
        self._min_slots = min_slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        hosts: Dict[str, int] = {}
        for node in self._ray.nodes():
            if not node.get("Alive", False):
                continue
            host = (node.get("NodeManagerHostname")
                    or node.get("NodeManagerAddress"))
            if not host:
                continue
            resources = node.get("Resources", {})
            if "CPU" in resources:
                hosts[host] = int(resources["CPU"]) // self._cpus_per_slot
            else:
                # Accelerator-only nodes advertise no CPU resource.
                hosts[host] = self._min_slots
        return hosts


class RayTransport(ExecTransport):
    """Spawn elastic workers through per-host agent actors.

    `command_for` returns the bare worker command (no ssh wrapping —
    the agent already runs on the target node); `execute` routes the
    spawn to the host's agent and returns a handle whose `poll()`
    proxies through the actor."""

    class _Handle:
        def __init__(self, ray_mod, agent, pid):
            self._ray = ray_mod
            self.agent = agent
            self.pid = pid

        def poll(self):
            try:
                return self._ray.get(self.agent.poll.remote(self.pid))
            except Exception:  # noqa: BLE001 — RayActorError et al.
                # Agent death is the host-loss event the elastic path
                # exists to survive: report the worker failed so the
                # driver blacklists and rescales instead of crashing.
                return -1

    class _DeadHandle:
        """Spawn failed (agent/host died mid-spawn): polls as failed so
        the driver records it and moves on."""

        agent = None
        pid = -1

        def poll(self):
            return -1

    def __init__(self, ray_mod=None, cpus_per_agent: float = 0):
        self._ray = ray_mod or _ray_mod()
        if self._ray is None:
            raise HorovodTpuError("RayTransport requires ray")
        self._cpus = cpus_per_agent
        self._agents: Dict[str, Any] = {}

    def _agent_for(self, host: str):
        agent = self._agents.get(host)
        if agent is None:
            remote_cls = self._ray.remote(num_cpus=self._cpus)(
                _HostAgentImpl)
            # Pin to the node via ray's built-in node resource when the
            # cluster advertises it (real ray); a fake/local cluster
            # just places it locally.
            options = {}
            for node in self._ray.nodes():
                addr = node.get("NodeManagerAddress")
                name = node.get("NodeManagerHostname")
                if host in (addr, name) and addr:
                    options = {"resources": {f"node:{addr}": 0.001}}
                    break
            if options:
                remote_cls = remote_cls.options(**options)
            agent = remote_cls.remote()
            self._agents[host] = agent
        return agent

    def command_for(self, slot, settings, env):
        return list(settings.command)

    def execute(self, cmd, env, prefix):
        host = env.get("HOROVOD_HOSTNAME", "127.0.0.1")
        agent = self._agent_for(host)
        try:
            pid = self._ray.get(agent.spawn.remote(
                cmd, dict(env), prefix, os.getcwd()))
        except Exception:  # noqa: BLE001 — agent/host died mid-spawn
            # Drop the dead agent so a later generation re-creates one
            # if the host returns; the failed handle lets the driver's
            # monitor loop blacklist and rescale.
            self._agents.pop(host, None)
            return RayTransport._DeadHandle()
        return RayTransport._Handle(self._ray, agent, pid)

    def terminate(self, handles):
        by_agent: Dict[Any, List[int]] = {}
        for h in handles:
            if h.agent is not None:
                by_agent.setdefault(h.agent, []).append(h.pid)
        for agent, pids in by_agent.items():
            try:
                self._ray.get(agent.terminate.remote(pids))
            # lint: allow-swallow(dead agent: workers died with node)
            except Exception:  # noqa: BLE001
                pass

    def shutdown(self):
        for agent in self._agents.values():
            try:
                self._ray.kill(agent)
            # lint: allow-swallow(best-effort teardown of ray actors)
            except Exception:  # noqa: BLE001
                pass
        self._agents.clear()


class RayExecutor:
    """Reference-shaped executor: Ray actors when available, the local
    process pool otherwise.  `use_gpu=True` gives each worker actor one
    GPU (`num_gpus=1`), upstream's meaning of the flag."""

    def __init__(self, settings: Any = None, num_workers: int = 1,
                 cpus_per_worker: int = 1, use_gpu: bool = False,
                 extra_env: Optional[Dict[str, str]] = None):
        self._num_workers = num_workers
        self._cpus = cpus_per_worker
        self._gpus = 1 if use_gpu else 0
        self._extra_env = dict(extra_env or {})
        self._workers: List[Any] = []
        self._local: Optional[Executor] = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        ray = _ray_mod()
        if ray is None:
            self._local = Executor(np=self._num_workers,
                                   extra_env=self._extra_env)
            self._local.start()
            return
        if not ray.is_initialized():
            ray.init(ignore_reinit_error=True)

        worker_cls = ray.remote(num_cpus=self._cpus,
                                num_gpus=self._gpus)(_WorkerImpl)
        self._workers = [worker_cls.remote()
                         for _ in range(self._num_workers)]
        hostnames = ray.get([w.hostname.remote() for w in self._workers])
        envs = assign_ranks(hostnames)
        from ..runner.exec_run import DEFAULT_COORDINATOR_PORT
        coordinator = f"{hostnames[0]}:{DEFAULT_COORDINATOR_PORT}"
        for w, env in zip(self._workers, envs):
            env = {**env, **self._extra_env,
                   "HOROVOD_NUM_PROCESSES": env["HOROVOD_SIZE"],
                   "HOROVOD_PROCESS_ID": env["HOROVOD_RANK"],
                   "HOROVOD_COORDINATOR_ADDR": coordinator}
            ray.get(w.set_env.remote(env))

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[dict] = None) -> List[Any]:
        if self._local is not None:
            return self._local.run(fn, args, kwargs)
        if not self._workers:
            raise HorovodTpuError("RayExecutor not started")
        return _ray_mod().get([
            w.exec_fn.remote(fn, args, kwargs or {})
            for w in self._workers])

    # Reference aliases.
    def execute(self, fn: Callable) -> List[Any]:
        return self.run(fn)

    def run_remote(self, fn: Callable, args: tuple = (),
                   kwargs: Optional[dict] = None):
        if self._local is not None:
            return self._local.run_remote(fn, args, kwargs)
        return [w.exec_fn.remote(fn, args, kwargs or {})
                for w in self._workers]

    def get(self, token):
        if self._local is not None:
            return self._local.get(token)
        return _ray_mod().get(token)

    def shutdown(self) -> None:
        if self._local is not None:
            self._local.shutdown()
            self._local = None
            return
        ray = _ray_mod()
        for w in self._workers:
            ray.kill(w)
        self._workers = []


class ElasticRayExecutor:
    """Ray-native elastic executor (reference: horovod/ray/elastic.py).

    With ray present: membership from `RayHostDiscovery`, workers
    spawned through `RayTransport` agent actors, driven by the port's
    elastic driver.  Without ray: delegates to the discovery-script-
    driven `ElasticExecutor` (same semantics, local transport); a
    discovery script is then required.
    """

    def __init__(self, discovery_script: Optional[str] = None,
                 min_np: int = 1, max_np: Optional[int] = None,
                 slots: int = 1, cpus_per_slot: int = 1,
                 extra_env: Optional[dict] = None):
        ray = _ray_mod()
        self._transport: Optional[RayTransport] = None
        if ray is not None:
            if not ray.is_initialized():
                ray.init(ignore_reinit_error=True)
            discovery = RayHostDiscovery(ray, cpus_per_slot=cpus_per_slot,
                                         min_slots=slots)
            self._transport = RayTransport(ray)
            self._inner = ElasticExecutor(
                discovery, min_np=min_np, max_np=max_np, slots=slots,
                extra_env=extra_env, transport=self._transport)
            return
        if not discovery_script:
            raise HorovodTpuError(
                "without ray, ElasticRayExecutor needs a host discovery "
                "script")
        self._inner = ElasticExecutor(
            discovery_script, min_np=min_np, max_np=max_np, slots=slots,
            extra_env=extra_env)

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[dict] = None) -> List[Any]:
        try:
            return self._inner.run(fn, args, kwargs)
        finally:
            if self._transport is not None:
                self._transport.shutdown()


__all__ = ["RayExecutor", "ElasticRayExecutor", "RayHostDiscovery",
           "RayTransport", "assign_ranks", "ray_available"]
