"""Programmatic multi-worker executor (counterpart of
`horovod_tpu/runner/executor.py`; reference: horovod/ray/runner.py
`RayExecutor` — start a persistent worker pool, run functions on every
worker repeatedly, tear the pool down; `ElasticExecutor` for the
discovery-driven variant, reference ElasticRayExecutor).

The workers are ordinary launched processes (local fork or SSH — the
same exec plumbing as `horovodrun_tpu_torch`) running a small command
loop against the control-plane KV store: the driver publishes pickled
callables (`exec/cmd/<i>`), workers execute them and post pickled
results (`exec/result/<i>/<rank>`).

    ex = Executor(np=4)
    ex.start()
    results = ex.run(train_fn, args=(cfg,))   # runs on all 4 ranks
    more    = ex.run(eval_fn)                 # same pool, no relaunch
    ex.shutdown()
"""

from __future__ import annotations

import base64
import logging
import os
import pickle
import sys
import time
from typing import Any, Callable, List, Optional

from ..common.exceptions import HorovodTpuError
from . import hosts as hosts_mod
from . import safe_exec
from .exec_run import _free_port, _is_local, build_command, slot_env
from .rendezvous import RendezvousServer
from .settings import Settings

logger = logging.getLogger("horovod_tpu_torch.runner.executor")

_WORKER_LOOP = """\
import base64, importlib.util, os, pickle, sys, traceback
from horovod_tpu_torch.runner.rendezvous import RendezvousClient
client = RendezvousClient(
    os.environ["HOROVOD_RENDEZVOUS_ADDR"],
    int(os.environ["HOROVOD_RENDEZVOUS_PORT"]),
    os.environ["HOROVOD_SECRET_KEY"])
rank = os.environ["HOROVOD_RANK"]
client.put("exec/alive/" + rank, "1")
_main_mods = {}

def _load_main(path):
    # Functions defined in the driver's __main__ script cannot unpickle
    # by module reference; load the script as a module (its name is not
    # __main__, so the `if __name__ == "__main__"` guard stays false) —
    # the multiprocessing-spawn convention.  Registering it in
    # sys.modules under BOTH names lets (a) arguments pickled by the
    # driver as "__main__.X" resolve here and (b) results whose classes
    # were created under "_hvd_user_main" pickle by reference.
    if path not in _main_mods:
        spec = importlib.util.spec_from_file_location("_hvd_user_main", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["_hvd_user_main"] = mod
        spec.loader.exec_module(mod)
        sys.modules["__main__"] = mod
        _main_mods[path] = mod
    return _main_mods[path]

idx = 0
while True:
    if client.get("exec/stop") is not None and \
            client.get(f"exec/cmd/{idx}") is None:
        break
    raw = client.get(f"exec/cmd/{idx}")
    if raw is None:
        import time; time.sleep(0.05)
        continue
    payload = pickle.loads(base64.b64decode(raw))
    for p in payload.get("paths", []):
        if p not in sys.path:
            sys.path.insert(0, p)
    try:
        if "main_file" in payload:
            mod = _load_main(payload["main_file"])
            fn = mod
            for part in payload["qualname"].split("."):
                fn = getattr(fn, part)
            args, kwargs = pickle.loads(payload["argskw"])
        else:
            fn, args, kwargs = pickle.loads(payload["fn"])
        out = {"ok": True, "result": fn(*args, **kwargs)}
    except BaseException as e:  # post the failure, stay alive
        out = {"ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
    try:
        data = base64.b64encode(pickle.dumps(out)).decode()
    except BaseException as e:  # unpicklable result must not kill the loop
        data = base64.b64encode(pickle.dumps(
            {"ok": False, "error": f"result not picklable: {e}",
             "traceback": ""})).decode()
    client.put(f"exec/result/{idx}/{rank}", data)
    idx += 1
"""


class Executor:
    """Persistent worker pool with Horovod env plumbing.

    Mirrors `RayExecutor(settings, num_workers)` semantics
    (horovod/ray/runner.py): `start()` brings the pool up, `run()` /
    `execute()` dispatch callables to every worker and gather per-rank
    results, `run_remote()`/`get()` split dispatch from collection,
    `shutdown()` tears the pool down.
    """

    def __init__(
        self,
        np: int = 1,
        hosts: Optional[str] = None,
        verbose: int = 0,
        extra_env: Optional[dict] = None,
        start_timeout: float = 60.0,
    ):
        self._np = np
        self._hosts = hosts
        self._verbose = verbose
        self._extra_env = dict(extra_env or {})
        self._start_timeout = start_timeout
        self._server: Optional[RendezvousServer] = None
        self._procs: List[Any] = []
        self._cmd_idx = 0
        self._started = False

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        """Spawn the worker pool and wait until every rank is alive
        (reference: RayExecutor.start waits for actor creation)."""
        if self._started:
            raise HorovodTpuError("Executor already started")
        host_list = (hosts_mod.parse_hosts(self._hosts) if self._hosts
                     else [hosts_mod.HostInfo("localhost", self._np)])
        slots = hosts_mod.get_host_assignments(host_list, self._np)

        self._server = RendezvousServer(verbose=self._verbose)
        port = self._server.start()
        settings = Settings(
            num_proc=self._np, hosts=host_list, verbose=self._verbose,
            extra_env=self._extra_env,
            command=[sys.executable, "-c", _WORKER_LOOP],
        )
        settings.rendezvous_port = port
        all_local = all(_is_local(s.hostname) for s in slots)
        if all_local:
            settings.rendezvous_addr = "127.0.0.1"
            coord = f"127.0.0.1:{_free_port()}"
        else:
            from .exec_run import DEFAULT_COORDINATOR_PORT, _my_addr
            settings.rendezvous_addr = _my_addr(slots)
            coord = f"{slots[0].hostname}:{DEFAULT_COORDINATOR_PORT}"

        for slot in slots:
            env = slot_env(slot, settings, self._server.secret, coord)
            cmd = build_command(slot, settings, env)
            self._procs.append(safe_exec.execute(
                cmd, env=env, prefix=f"exec:{slot.rank}", background=True))
        self._started = True

        deadline = time.monotonic() + self._start_timeout
        while time.monotonic() < deadline:
            alive = self._server.kv().keys("exec/alive/")
            if len(alive) >= self._np:
                return
            self._check_workers()
            time.sleep(0.05)
        self.shutdown()
        raise HorovodTpuError(
            f"Executor: workers not ready within {self._start_timeout}s")

    def shutdown(self) -> None:
        """Stop the pool (reference: RayExecutor.shutdown)."""
        if self._server is not None:
            try:
                self._server.kv().put("exec/stop", "1")
            # lint: allow-swallow(stop signal; server may already be down)
            except Exception:  # noqa: BLE001
                pass
        deadline = time.monotonic() + 10
        for p in self._procs:
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                p.terminate()
        self._procs = []
        if self._server is not None:
            self._server.stop()
            self._server = None
        self._started = False

    def __enter__(self) -> "Executor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- dispatch --------------------------------------------------------
    def run_remote(self, fn: Callable, args: tuple = (),
                   kwargs: Optional[dict] = None) -> int:
        """Dispatch `fn` to every worker; return a token for `get()`
        (reference: RayExecutor.run_remote returns ObjectRefs)."""
        if not self._started:
            raise HorovodTpuError("Executor not started")
        paths = []
        fn_file = None
        try:
            import inspect
            fn_file = os.path.abspath(inspect.getfile(fn))
            paths.append(os.path.dirname(fn_file))
        except TypeError:
            pass
        if getattr(fn, "__module__", None) == "__main__" and fn_file \
                and "<locals>" not in getattr(fn, "__qualname__", ""):
            # Nested functions can't resolve by qualname on the worker;
            # let them fall through to pickle, which raises the clear
            # "Can't pickle local object" in the DRIVER.
            # __main__-defined functions can't unpickle by reference;
            # ship the script path + qualname (worker loads the file).
            payload = {
                "main_file": fn_file,
                "qualname": fn.__qualname__,
                "argskw": pickle.dumps((args, kwargs or {})),
                "paths": paths,
            }
        else:
            payload = {
                "fn": pickle.dumps((fn, args, kwargs or {})),
                "paths": paths,
            }
        token = self._cmd_idx
        self._server.kv().put(
            f"exec/cmd/{token}",
            base64.b64encode(pickle.dumps(payload)).decode())
        self._cmd_idx += 1
        return token

    def get(self, token: int, timeout: float = 600.0) -> List[Any]:
        """Collect per-rank results for a dispatched command."""
        # Worker-side classes from a __main__-shipped script pickle as
        # "_hvd_user_main.X"; that module IS this process's __main__.
        sys.modules.setdefault("_hvd_user_main", sys.modules["__main__"])
        kv = self._server.kv()
        results: List[Any] = [None] * self._np
        got = set()
        deadline = time.monotonic() + timeout
        while len(got) < self._np:
            if time.monotonic() > deadline:
                raise HorovodTpuError(
                    f"Executor.get: ranks {sorted(set(range(self._np)) - got)}"
                    f" produced no result within {timeout}s")
            self._check_workers()
            for r in range(self._np):
                if r in got:
                    continue
                raw = kv.get(f"exec/result/{token}/{r}")
                if raw is not None:
                    results[r] = pickle.loads(base64.b64decode(raw))
                    got.add(r)
            time.sleep(0.02)
        errors = [(r, res) for r, res in enumerate(results)
                  if not res["ok"]]
        if errors:
            r, res = errors[0]
            raise HorovodTpuError(
                f"Executor: rank {r} failed: {res['error']}\n"
                f"{res.get('traceback', '')}")
        return [res["result"] for res in results]

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[dict] = None,
            timeout: float = 600.0) -> List[Any]:
        """Run `fn(*args, **kwargs)` on every worker; results by rank
        (reference: RayExecutor.run)."""
        return self.get(self.run_remote(fn, args, kwargs), timeout=timeout)

    # Reference API alias: execute(fn) calls fn(worker); our workers are
    # plain processes, so the callable simply runs with no argument.
    def execute(self, fn: Callable, timeout: float = 600.0) -> List[Any]:
        return self.run(fn, timeout=timeout)

    def _check_workers(self) -> None:
        for i, p in enumerate(self._procs):
            rc = p.poll()
            if rc is not None and rc != 0:
                raise HorovodTpuError(
                    f"Executor worker {i} exited with code {rc}")


class ElasticExecutor:
    """Discovery-driven variant (reference: ElasticRayExecutor).

    Wraps the elastic driver (`runner/elastic/driver.py`): workers are
    (re)spawned per the discovery script within [min_np, max_np]; `run`
    ships a pickled function exactly like `horovod_tpu_torch.runner.api.run`
    and returns the surviving ranks' results.
    """

    def __init__(self, discovery_script, min_np: int = 1,
                 max_np: Optional[int] = None, slots: int = 1,
                 verbose: int = 0, extra_env: Optional[dict] = None,
                 start_timeout: float = 120.0,
                 ssh_port: Optional[int] = None,
                 ssh_identity_file: Optional[str] = None,
                 network_interfaces: Optional[str] = None,
                 output_filename: Optional[str] = None,
                 transport=None):
        # `discovery_script` is a path (reference CLI surface) or a
        # HostDiscovery instance (programmatic backends).
        from .elastic.discovery import HostDiscovery
        self._discovery = (discovery_script
                           if isinstance(discovery_script, HostDiscovery)
                           else None)
        self._script = None if self._discovery else discovery_script
        self._transport = transport
        self._min_np = min_np
        self._max_np = max_np
        self._slots = slots
        self._verbose = verbose
        self._extra_env = dict(extra_env or {})
        self._start_timeout = start_timeout
        self._ssh_port = ssh_port
        self._ssh_identity_file = ssh_identity_file
        self._nics = network_interfaces
        self._output_filename = output_filename

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[dict] = None) -> List[Any]:
        from .api import call_results, shipped_call
        from .elastic.driver import elastic_run

        got: dict = {}
        with shipped_call(fn, args, kwargs, self._extra_env) as (env,
                                                                  command):
            settings = Settings(
                num_proc=self._min_np,
                min_np=self._min_np, max_np=self._max_np,
                host_discovery_script=self._script,
                slots_per_host=self._slots,
                elastic=True, verbose=self._verbose, extra_env=env,
                start_timeout=self._start_timeout,
                ssh_port=self._ssh_port,
                ssh_identity_file=self._ssh_identity_file,
                nics=self._nics, output_filename=self._output_filename,
                command=command,
            )
            rc = elastic_run(settings,
                             result_hook=lambda server: got.update(
                                 call_results(server.kv())),
                             discovery=self._discovery,
                             transport=self._transport)
        if rc != 0:
            raise HorovodTpuError(
                f"ElasticExecutor run failed with exit code {rc}")
        # In rank order: the ranks of the last generation that put one.
        return [got[r] for r in sorted(got)]


__all__ = ["Executor", "ElasticExecutor"]
