"""Launcher settings (counterpart of `horovod_tpu/runner/settings.py`;
reference: horovod/runner/common/util/settings.py).

A plain dataclass carrying everything `parse_args` produced to the launch
paths; workers never see it — they see only the env vars derived from it
(reference: runner/common/util/env.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from .hosts import HostInfo


@dataclasses.dataclass
class Settings:
    num_proc: int = 1
    hosts: Optional[List[HostInfo]] = None
    command: Optional[List[str]] = None
    verbose: int = 0
    ssh_port: Optional[int] = None
    ssh_identity_file: Optional[str] = None
    extra_env: Optional[dict] = None
    start_timeout: float = 30.0
    output_filename: Optional[str] = None
    run_func_mode: bool = False
    nics: Optional[str] = None

    # Tunables forwarded as HOROVOD_* env (reference: launch.py flags).
    timeline_filename: Optional[str] = None
    timeline_mark_cycles: bool = False
    fusion_threshold_mb: Optional[int] = None
    cycle_time_ms: Optional[float] = None
    cache_capacity: Optional[int] = None
    autotune: bool = False
    autotune_log_file: Optional[str] = None
    stall_check_time_seconds: Optional[float] = None
    stall_shutdown_time_seconds: Optional[float] = None
    log_level: Optional[str] = None

    # Elastic (reference: --min-np/--max-np/--host-discovery-script/--slots)
    elastic: bool = False
    min_np: Optional[int] = None
    max_np: Optional[int] = None
    host_discovery_script: Optional[str] = None
    slots_per_host: Optional[int] = None
    reset_limit: Optional[int] = None

    # Fault tolerance (None = resolve from HOROVOD_* env; read by the
    # elastic driver).
    lease_ttl: Optional[float] = None          # heartbeat lease TTL (s)
    lease_start_grace: Optional[float] = None  # silence allowed post-spawn
    blacklist_threshold: Optional[int] = None  # strikes before blacklist
    max_respawns: Optional[int] = None         # per-host respawn budget

    # Rendezvous / coordination (filled by the launch path).
    rendezvous_addr: Optional[str] = None
    rendezvous_port: Optional[int] = None
    coordinator_port: Optional[int] = None
