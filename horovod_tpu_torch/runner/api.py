"""Python launch API (counterpart of `horovod_tpu/runner/api.py`;
reference: horovod/runner/__init__.py `run()`).

`run(func, args=(), np=2, ...)` executes `func` on every worker process
and returns the per-rank results in rank order, like the reference's
in-process API (which pickles the function to workers over the task
service).  Here the function ships via a pickle file and results return
through the rendezvous KV store before the server shuts down.
"""

from __future__ import annotations

import base64
import contextlib
import inspect
import logging
import os
import pickle
import sys
import tempfile
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("horovod_tpu_torch.runner")

from ..common.exceptions import HorovodTpuError
from . import hosts as hosts_mod
from .exec_run import exec_run
from .settings import Settings

_WORKER_SNIPPET = """\
import base64, os, pickle, sys
extra_path = os.environ.get("HVD_TPU_RUN_FUNC_PATH")
if extra_path:
    sys.path.insert(0, extra_path)
with open(os.environ["HVD_TPU_RUN_FUNC_FILE"], "rb") as f:
    func, args, kwargs = pickle.load(f)
result = func(*args, **kwargs)
from horovod_tpu_torch.runner.rendezvous import RendezvousClient
client = RendezvousClient(
    os.environ["HOROVOD_RENDEZVOUS_ADDR"],
    int(os.environ["HOROVOD_RENDEZVOUS_PORT"]),
    os.environ["HOROVOD_SECRET_KEY"])
client.put("runfunc/result/" + os.environ["HOROVOD_RANK"],
           base64.b64encode(pickle.dumps(result)).decode())
"""


@contextlib.contextmanager
def shipped_call(func: Callable, args: tuple, kwargs: Optional[dict],
                 extra_env: Optional[dict] = None):
    """The call the workers run, shipped as `run()` and the
    `ElasticExecutor` ship it: `(func, args, kwargs)` pickled into a
    file.  Yields the workers' env (`extra_env`, the file as
    HVD_TPU_RUN_FUNC_FILE and the directory of `func`'s module as
    HVD_TPU_RUN_FUNC_PATH: pickle names `func` by its module) and their
    command (`_WORKER_SNIPPET`, which puts the result on the KV); the
    file is removed on exit."""
    with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as f:
        pickle.dump((func, args, kwargs or {}), f)
        func_file = f.name
    env = dict(extra_env or {})
    env["HVD_TPU_RUN_FUNC_FILE"] = func_file
    try:
        env["HVD_TPU_RUN_FUNC_PATH"] = os.path.dirname(
            os.path.abspath(inspect.getfile(func)))
    except TypeError:
        pass
    try:
        yield env, [sys.executable, "-c", _WORKER_SNIPPET]
    finally:
        try:
            os.unlink(func_file)
        except OSError:
            pass


def call_results(kv) -> Dict[int, Any]:
    """The results the workers of a shipped call put on the KV
    (`runfunc/result/{rank}`), by rank."""
    out = {}
    for key in kv.keys("runfunc/result/"):
        raw = kv.get(key)
        if raw is not None:
            out[int(key.rsplit("/", 1)[1])] = pickle.loads(
                base64.b64decode(raw))
    return out


def run(
    func: Callable,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    np: int = 1,
    hosts: Optional[str] = None,
    hostfile: Optional[str] = None,
    min_np: Optional[int] = None,
    max_np: Optional[int] = None,
    slots: Optional[int] = None,
    host_discovery_script: Optional[str] = None,
    ssh_port: Optional[int] = None,
    ssh_identity_file: Optional[str] = None,
    network_interfaces: Optional[str] = None,
    output_filename: Optional[str] = None,
    use_gloo: Optional[bool] = None,
    use_mpi: Optional[bool] = None,
    verbose: int = 0,
    extra_env: Optional[dict] = None,
    start_timeout: float = 120.0,
) -> List[Any]:
    """Run `func(*args, **kwargs)` on `np` workers; return results by rank
    (reference: horovod.run — the full flag surface is accepted;
    `use_gloo`/`use_mpi` are drop-in no-ops since each worker's
    `hvd.init()` picks NCCL or gloo itself).

    `host_discovery_script` (+ min_np/max_np/slots) routes through the
    elastic driver (`ElasticExecutor`), mirroring the reference's elastic
    run() path; the result list then holds the surviving ranks'.

    `start_timeout` bounds elastic host discovery; static worker startup is
    bounded by the process group's own bootstrap timeout.  With remote
    `hosts`, the pickled function file must be visible on every host
    (shared filesystem), as must the repo itself.
    """
    if use_mpi:
        logger.warning("use_mpi ignored: hvd.init() runs NCCL or gloo "
                       "(see README)")
    if host_discovery_script and (hosts or hostfile):
        raise ValueError(
            "hosts/hostfile conflict with host_discovery_script: elastic "
            "membership comes from the discovery script (reference: "
            "horovodrun rejects the combination)")
    if hosts and hostfile:
        raise ValueError("pass either hosts or hostfile, not both")
    if host_discovery_script:
        from .executor import ElasticExecutor

        ex = ElasticExecutor(
            host_discovery_script, min_np=min_np or np, max_np=max_np,
            slots=slots or 1, verbose=verbose, extra_env=extra_env,
            start_timeout=start_timeout, ssh_port=ssh_port,
            ssh_identity_file=ssh_identity_file,
            network_interfaces=network_interfaces,
            output_filename=output_filename)
        return ex.run(func, args, kwargs)
    if slots is not None:
        logger.warning("run(): `slots` only applies with "
                       "host_discovery_script; ignored for static hosts")

    if hosts:
        host_list = hosts_mod.parse_hosts(hosts)
    elif hostfile:
        host_list = hosts_mod.parse_hostfile(hostfile)
    else:
        host_list = [hosts_mod.HostInfo("localhost", np)]
    from .exec_run import _is_local
    if any(not _is_local(h.hostname) for h in host_list):
        logger.warning(
            "run() with remote hosts requires the function pickle (tempfile)"
            " and repo to be on a shared filesystem visible to all hosts")
    assignments = hosts_mod.get_host_assignments(host_list, np)

    got: Dict[int, Any] = {}
    with shipped_call(func, args, kwargs, extra_env) as (env, command):
        settings = Settings(
            num_proc=np, hosts=host_list, verbose=verbose, extra_env=env,
            start_timeout=start_timeout,
            ssh_port=ssh_port, ssh_identity_file=ssh_identity_file,
            nics=network_interfaces, output_filename=output_filename,
            command=command,
        )
        rc = exec_run(settings, assignments,
                      result_hook=lambda server: got.update(
                          call_results(server.kv())))
    if rc != 0:
        raise HorovodTpuError(f"run() workers failed with exit code {rc}")
    missing = [r for r in range(np) if r not in got]
    if missing:
        raise HorovodTpuError(f"run(): no result from ranks {missing}")
    return [got[r] for r in range(np)]
