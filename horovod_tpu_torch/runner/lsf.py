"""LSF / jsrun launch path (counterpart of `horovod_tpu/runner/lsf.py`).

Reference parity: horovod/runner/js_run.py (`js_run`) +
horovod/runner/common/util/lsf.py (LSF env detection, host parsing) —
the Summit-style path where the scheduler, not SSH, places processes.

Detection: an LSF batch job exports LSB_JOBID plus LSB_MCPU_HOSTS
("host1 n1 host2 n2 ...") or LSB_HOSTS ("host1 host1 host2 ...").
`horovodrun_tpu_torch` without -H/--hostfile inside such a job derives its
host list from them; when the `jsrun` binary exists the job is launched
through it (jsrun assigns ranks via its OMPI/PMIX env, translated to
the HOROVOD_* contract by `lsf_bootstrap`), otherwise the regular SSH
exec path runs over the LSF-provided hosts.
"""

from __future__ import annotations

import logging
import os
import shutil
import sys
from typing import Dict, List, Optional

from ..common.exceptions import HorovodTpuError
from .hosts import HostInfo
from .settings import Settings

logger = logging.getLogger("horovod_tpu_torch.runner.lsf")

# Batch hosts LSF lists but that run no tasks (reference: lsf.py filters
# the launch node the same way).
_EXCLUDED = ("batch", "launch")


def in_lsf_job(env: Optional[Dict[str, str]] = None) -> bool:
    env = os.environ if env is None else env
    return "LSB_JOBID" in env and (
        "LSB_MCPU_HOSTS" in env or "LSB_HOSTS" in env)


def lsf_hosts(env: Optional[Dict[str, str]] = None) -> List[HostInfo]:
    """Host list from the LSF job env (reference: lsf.py parse of
    LSB_MCPU_HOSTS / LSB_HOSTS)."""
    env = os.environ if env is None else env
    counts: Dict[str, int] = {}
    order: List[str] = []

    def add(host: str, n: int) -> None:
        if any(host.startswith(x) for x in _EXCLUDED):
            return
        if host not in counts:
            order.append(host)
            counts[host] = 0
        counts[host] += n

    if env.get("LSB_MCPU_HOSTS"):
        toks = env["LSB_MCPU_HOSTS"].split()
        if len(toks) % 2:
            raise HorovodTpuError(
                f"malformed LSB_MCPU_HOSTS: {env['LSB_MCPU_HOSTS']!r}")
        for host, n in zip(toks[::2], toks[1::2]):
            add(host, int(n))
    elif env.get("LSB_HOSTS"):
        for host in env["LSB_HOSTS"].split():
            add(host, 1)
    else:
        raise HorovodTpuError("not inside an LSF job (no LSB_*HOSTS)")
    if not counts:
        raise HorovodTpuError("LSF host list contains only batch nodes")
    return [HostInfo(h, counts[h]) for h in order]


def jsrun_available() -> bool:
    return shutil.which("jsrun") is not None


def build_jsrun_command(settings: Settings, np: int) -> List[str]:
    """The jsrun invocation (reference: js_run.py's command assembly —
    one task per resource set, `np` resource sets, worker command
    wrapped by the env-translating bootstrap)."""
    if not settings.command:
        raise HorovodTpuError("no command to launch")
    cmd = [
        "jsrun",
        "--nrs", str(np),
        "--tasks_per_rs", "1",
        "--cpu_per_rs", "ALL_CPUS",
        "--gpu_per_rs", "ALL_GPUS",
    ]
    if settings.output_filename:
        cmd += ["--stdio_stderr", settings.output_filename,
                "--stdio_stdout", settings.output_filename]
    cmd += [sys.executable, "-m", "horovod_tpu_torch.runner.lsf_bootstrap"]
    cmd += list(settings.command)
    return cmd


def js_run(settings: Settings, runner=None) -> int:
    """Launch through jsrun: the rendezvous server runs on the launch
    node; jsrun places one task per rank and its PMIX/OMPI env is
    translated by lsf_bootstrap (reference: js_run)."""
    import subprocess

    from .network import resolve_advertise_address
    from .rendezvous import RendezvousServer

    np = settings.num_proc
    server = RendezvousServer(verbose=settings.verbose)
    port = server.start()
    # Route-probe toward the first compute host so the advertised address
    # is reachable from the tasks (gethostbyname alone returns loopback on
    # nodes with a "127.0.1.1 <hostname>" /etc/hosts entry).
    remote = settings.hosts[0].hostname if settings.hosts else None
    env = dict(os.environ)
    env.update({
        "HOROVOD_SIZE": str(np),
        "HOROVOD_NUM_PROCESSES": str(np),
        "HOROVOD_RENDEZVOUS_ADDR": resolve_advertise_address(
            settings.nics, remote),
        "HOROVOD_RENDEZVOUS_PORT": str(port),
        "HOROVOD_SECRET_KEY": server.secret,
    })
    cmd = build_jsrun_command(settings, np)
    logger.info("launching via jsrun: %s", " ".join(cmd))
    try:
        run = runner or subprocess.run
        return run(cmd, env=env).returncode
    finally:
        server.stop()


__all__ = ["build_jsrun_command", "in_lsf_job", "js_run",
           "jsrun_available", "lsf_hosts"]
