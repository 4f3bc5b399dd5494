"""Safe subprocess execution with output capture and process-tree cleanup
(counterpart of `horovod_tpu/runner/safe_exec.py`).

Reference parity: horovod/runner/common/util/safe_shell_exec.py — pty-style
line capture with per-rank prefixes, SIGTERM-then-SIGKILL of the whole
process tree on termination, and an exit-code contract used by every launch
path (exec_run, the Executor).
"""

from __future__ import annotations

import datetime
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

GRACEFUL_TERMINATION_TIME_S = 5


def _forward_stream(stream, sink, prefix: str, index_prefix: bool) -> None:
    """Pump `stream` line-by-line into `sink`, prefixing `[prefix]<ts>`
    like the reference's MultiFile/prefix_connection machinery."""
    for raw in iter(stream.readline, b""):
        line = raw.decode("utf-8", errors="replace")
        if index_prefix:
            ts = datetime.datetime.now().strftime("%H:%M:%S")
            sink.write(f"[{prefix}]<{ts}> {line}")
        else:
            sink.write(line)
        sink.flush()
    stream.close()


def terminate_tree(pid: int, timeout: float = GRACEFUL_TERMINATION_TIME_S,
                   reap: Optional[Callable[[], object]] = None):
    """SIGTERM the process group, then SIGKILL survivors (reference:
    safe_shell_exec's _exec_middleman cleanup).  `reap`: see
    terminate_trees."""
    terminate_trees([pid], timeout, reap={pid: reap} if reap else None)


def terminate_trees(pids: List[int],
                    timeout: float = GRACEFUL_TERMINATION_TIME_S,
                    reap: Optional[Dict[int, Callable[[], object]]] = None):
    """Terminate many process groups under ONE shared grace deadline:
    SIGTERM every group first, then sweep until all are gone or the
    deadline passes, then SIGKILL survivors.  Keeps teardown of N workers
    O(timeout) instead of O(N*timeout).

    `reap[pid]()` reaps a group leader that is this process's child
    (`Popen.poll`): an exited leader left unreaped stays a zombie member
    of its group, so the group would read as alive until the deadline."""
    pgids = {}
    for pid in pids:
        try:
            pgid = os.getpgid(pid)
        except ProcessLookupError:
            continue
        try:
            os.killpg(pgid, signal.SIGTERM)
            pgids[pgid] = pid
        except ProcessLookupError:
            continue
    deadline = time.monotonic() + timeout
    while pgids and time.monotonic() < deadline:
        alive = {}
        for pgid, pid in pgids.items():
            if reap and pid in reap:
                reap[pid]()
            try:
                os.killpg(pgid, 0)
                alive[pgid] = pid
            except ProcessLookupError:
                pass
        pgids = alive
        if pgids:
            time.sleep(0.1)
    for pgid in pgids:
        try:
            os.killpg(pgid, signal.SIGKILL)
        except ProcessLookupError:
            pass


class ExecutedProcess:
    """Handle on a launched worker (used by the elastic driver to observe
    exits and inject failures in tests)."""

    def __init__(self, proc: subprocess.Popen, threads: List[threading.Thread]):
        self.proc = proc
        self._threads = threads

    @property
    def pid(self) -> int:
        return self.proc.pid

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def wait(self, timeout: Optional[float] = None) -> int:
        rc = self.proc.wait(timeout)
        for t in self._threads:
            t.join(timeout=5)
        return rc

    def terminate(self) -> None:
        terminate_tree(self.proc.pid, reap=self.proc.poll)


def execute(
    command: List[str],
    env: Optional[Dict[str, str]] = None,
    prefix: Optional[str] = None,
    stdout=None,
    stderr=None,
    background: bool = False,
    events: Optional[List[Callable]] = None,
):
    """Run `command` in its own process group with captured, prefixed
    output.

    background=False → block and return the exit code (reference:
    safe_shell_exec.execute). background=True → return an
    `ExecutedProcess` immediately (used by launch paths that manage many
    workers).
    """
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr
    proc = subprocess.Popen(
        command,
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        preexec_fn=os.setsid,  # own process group → killable as a tree
    )
    threads = []
    for stream, sink in ((proc.stdout, stdout), (proc.stderr, stderr)):
        t = threading.Thread(
            target=_forward_stream,
            args=(stream, sink, prefix or "", prefix is not None),
            daemon=True,
        )
        t.start()
        threads.append(t)
    handle = ExecutedProcess(proc, threads)
    if background:
        return handle
    try:
        return handle.wait()
    except KeyboardInterrupt:
        handle.terminate()
        raise
