"""Static launch path: spawn one worker per slot with derived env
(counterpart of `horovod_tpu/runner/exec_run.py`).

Reference parity: horovod/runner/gloo_run.py (`gloo_run`) — compute host
assignments, start the rendezvous server, exec each slot's command (local
fork or SSH), stream prefixed output, tear the tree down on failure.

Workers bootstrap their process group over rank 0's c10d `TCPStore`, so
the env contract is HOROVOD_COORDINATOR_ADDR (host:port of that store)
/ NUM_PROCESSES / PROCESS_ID plus the classic HOROVOD_RANK / SIZE /
LOCAL_RANK / ... set, which `hvd.init()` reads (`common/basics.py`), and
the rendezvous KV serves the rest of the control plane.
"""

from __future__ import annotations

import logging
import os
import shlex
import socket
import time
from typing import Dict, List, Optional

from ..common.exceptions import HorovodTpuError
from . import safe_exec
from .safe_exec import GRACEFUL_TERMINATION_TIME_S
from .hosts import SlotInfo
from .rendezvous import RendezvousServer
from .settings import Settings

logger = logging.getLogger("horovod_tpu_torch.runner")

LOCAL_HOSTNAMES = ("localhost", "127.0.0.1", socket.gethostname())

# Port the rank-0 worker binds its c10d TCPStore to when it runs on a
# remote host (free-port probing is only possible locally).
DEFAULT_COORDINATOR_PORT = 46327


def _is_local(hostname: str) -> bool:
    if hostname in LOCAL_HOSTNAMES:
        return True
    # Fake-cluster hook (the reference's localhost pattern, SURVEY.md §4,
    # and the JAX package's): hostnames listed here exec locally instead
    # of over ssh, so elastic jobs can add, fail and blacklist "hosts" on
    # one machine.
    fake = os.environ.get("HVD_TPU_FAKE_LOCAL_HOSTS")
    return bool(fake) and hostname in fake.split(",")


def slot_env(
    slot: SlotInfo,
    settings: Settings,
    secret: str,
    coordinator_addr: str,
) -> Dict[str, str]:
    """Derive the worker env for one slot (reference:
    runner/common/util/env.py + gloo_run's slot env injection).

    HOROVOD_CONTROLLER and HOROVOD_CPU_OPERATIONS are not written: the
    JAX package writes "xla" there, and the port chooses its process
    group's backend in `hvd.init()` from the device and the number of
    local ranks per card (NCCL, or gloo where ranks share a card or run
    on the CPU), which the launcher does not know.  No module of the
    port reads either variable."""
    env = dict(os.environ)
    if settings.extra_env:
        env.update({k: str(v) for k, v in settings.extra_env.items()})
    env.update({
        "HOROVOD_RANK": str(slot.rank),
        "HOROVOD_SIZE": str(slot.size),
        "HOROVOD_LOCAL_RANK": str(slot.local_rank),
        "HOROVOD_LOCAL_SIZE": str(slot.local_size),
        "HOROVOD_CROSS_RANK": str(slot.cross_rank),
        "HOROVOD_CROSS_SIZE": str(slot.cross_size),
        # Process-group bootstrap (consumed by horovod_tpu_torch.init()).
        "HOROVOD_COORDINATOR_ADDR": coordinator_addr,
        "HOROVOD_NUM_PROCESSES": str(slot.size),
        "HOROVOD_PROCESS_ID": str(slot.rank),
        # Control-plane rendezvous.
        "HOROVOD_RENDEZVOUS_ADDR": settings.rendezvous_addr or "127.0.0.1",
        "HOROVOD_RENDEZVOUS_PORT": str(settings.rendezvous_port or 0),
        "HOROVOD_SECRET_KEY": secret,
    })
    if settings.timeline_filename:
        # Workers handle per-rank suffixing themselves (timeline.py
        # init_from_env): rank 0 writes the base file; other ranks only
        # write when HOROVOD_TIMELINE_ALL_RANKS is set in the environment.
        env["HOROVOD_TIMELINE"] = settings.timeline_filename
        if settings.timeline_mark_cycles:
            env["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
    if settings.fusion_threshold_mb is not None:
        env["HOROVOD_FUSION_THRESHOLD"] = str(
            settings.fusion_threshold_mb * 1024 * 1024)
    if settings.cycle_time_ms is not None:
        env["HOROVOD_CYCLE_TIME"] = str(settings.cycle_time_ms)
    if settings.cache_capacity is not None:
        env["HOROVOD_CACHE_CAPACITY"] = str(settings.cache_capacity)
    if settings.autotune:
        env["HOROVOD_AUTOTUNE"] = "1"
        if settings.autotune_log_file:
            env["HOROVOD_AUTOTUNE_LOG"] = settings.autotune_log_file
    if settings.stall_check_time_seconds is not None:
        env["HOROVOD_STALL_CHECK_TIME_SECONDS"] = str(
            settings.stall_check_time_seconds)
    if settings.stall_shutdown_time_seconds is not None:
        env["HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"] = str(
            settings.stall_shutdown_time_seconds)
    if settings.log_level:
        env["HOROVOD_LOG_LEVEL"] = settings.log_level
    return env


def build_command(slot: SlotInfo, settings: Settings,
                  env: Dict[str, str]) -> List[str]:
    """Local slots exec directly; remote slots go through ssh with the env
    serialized onto the remote command line (reference: gloo_run's
    get_remote_command)."""
    if not settings.command:
        raise HorovodTpuError("no command to launch: settings.command "
                              "is empty")
    if _is_local(slot.hostname):
        return list(settings.command)
    ssh = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if settings.ssh_port:
        ssh += ["-p", str(settings.ssh_port)]
    if settings.ssh_identity_file:
        ssh += ["-i", settings.ssh_identity_file]
    exported = " ".join(
        f"{k}={shlex.quote(v)}" for k, v in env.items()
        if k.startswith(("HOROVOD_", "HVD_TPU_", "CUDA_", "NCCL_", "TORCH_",
                         "PYTHONPATH", "PATH")))
    remote_cmd = f"cd {shlex.quote(os.getcwd())} && env {exported} " + \
        " ".join(shlex.quote(c) for c in settings.command)
    return ssh + [slot.hostname, remote_cmd]


def exec_run(settings: Settings, slots: List[SlotInfo],
             result_hook=None) -> int:
    """Launch all slots, wait, propagate the first failure (reference:
    gloo_run → launch_gloo).

    `result_hook(server)`, if given, runs after all workers exit but
    before the rendezvous server stops — the `run()` API uses it to pull
    worker results out of the KV store."""
    server = RendezvousServer(verbose=settings.verbose)
    port = server.start()
    settings.rendezvous_addr = settings.rendezvous_addr or _my_addr(
        slots, settings.nics)
    settings.rendezvous_port = port

    # The c10d TCPStore is bound by the rank-0 *worker*, so
    # the address must be reachable from every other worker's host.  For a
    # remote rank-0 host we cannot probe a free port there; use a fixed
    # well-known port (overridable via --coordinator-port / Settings).
    all_local = all(_is_local(s.hostname) for s in slots)
    if _is_local(slots[0].hostname):
        coord_host = ("127.0.0.1" if all_local and not settings.nics
                      else _my_addr(slots, settings.nics))
        coord_port = settings.coordinator_port or _free_port()
    else:
        coord_host = slots[0].hostname
        coord_port = settings.coordinator_port or DEFAULT_COORDINATOR_PORT
    coordinator_addr = f"{coord_host}:{coord_port}"

    procs = []
    out_files = []
    try:
        for slot in slots:
            env = slot_env(slot, settings, server.secret, coordinator_addr)
            cmd = build_command(slot, settings, env)
            stdout = stderr = None
            if settings.output_filename:
                os.makedirs(settings.output_filename, exist_ok=True)
                f = open(os.path.join(
                    settings.output_filename, f"rank.{slot.rank}.log"), "w")
                out_files.append(f)
                stdout = stderr = f
            procs.append(safe_exec.execute(
                cmd, env=env, prefix=str(slot.rank),
                stdout=stdout, stderr=stderr, background=True))
            logger.debug("launched rank %d on %s (pid %d)",
                         slot.rank, slot.hostname, procs[-1].pid)

        # Wait for all; on any nonzero exit, terminate the rest.
        exit_code = 0
        pending = {p.pid: (s, p) for s, p in zip(slots, procs)}
        while pending:
            for pid in list(pending):
                slot, proc = pending[pid]
                rc = proc.poll()
                if rc is None:
                    continue
                del pending[pid]
                if rc != 0:
                    logger.error("rank %d (pid %d) exited with code %d",
                                 slot.rank, pid, rc)
                    exit_code = exit_code or rc
                    for _, other in pending.values():
                        other.terminate()
            time.sleep(0.1)
        if result_hook is not None and exit_code == 0:
            result_hook(server)
        return exit_code
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        # Drain the output-forwarder threads before closing the log files,
        # or the tail of a failing rank's traceback is lost.
        for p in procs:
            try:
                p.wait(timeout=GRACEFUL_TERMINATION_TIME_S)
            except Exception as e:  # noqa: BLE001 — kill follows anyway
                logger.debug("pid %d did not exit in %ss (%s)",
                             p.pid, GRACEFUL_TERMINATION_TIME_S, e)
        for f in out_files:
            f.close()
        server.stop()


def _my_addr(slots: List[SlotInfo], nics: Optional[str] = None) -> str:
    """Address workers use to reach the launcher's rendezvous server.

    `nics` (--network-interfaces) pins the advertised interface; see
    runner/network.py (reference: driver_service NIC selection).
    """
    from . import network

    if nics:
        return network.resolve_advertise_address(nics)
    if all(_is_local(s.hostname) for s in slots):
        return "127.0.0.1"
    # Multi-host: pick the interface routing toward the first remote host.
    remote = next(s.hostname for s in slots if not _is_local(s.hostname))
    return network.resolve_advertise_address(None, remote)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]
