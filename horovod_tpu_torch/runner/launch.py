"""`horovodrun_tpu_torch` CLI (counterpart of
`horovod_tpu/runner/launch.py`; reference: horovod/runner/launch.py).

Flag surface mirrors the reference's `parse_args` (SURVEY.md §2.5): -np,
-H/--hosts, --hostfile, --start-timeout, --timeline-filename, --autotune*,
--fusion-threshold-mb, --cycle-time-ms, --cache-capacity, elastic
--min-np/--max-np/--host-discovery-script/--slots, --check-build,
--log-level, --verbose, --output-filename.  The --gloo/--mpi backend
selectors are accepted-and-ignored for drop-in compatibility: each
worker's `hvd.init()` picks NCCL or gloo itself.  --host-discovery-script
routes through the elastic driver (`runner/elastic/driver.py`).

Usage:  horovodrun_tpu_torch -np 4 -H a:2,b:2 python train.py
        python -m horovod_tpu_torch.runner -np 2 python train.py
        horovodrun_tpu_torch --host-discovery-script ./hosts.sh \
            --min-np 1 --max-np 4 python train.py
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from ..common.exceptions import HorovodTpuError
from ..version import __version__
from . import hosts as hosts_mod
from .settings import Settings

logger = logging.getLogger("horovod_tpu_torch.runner")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="horovodrun_tpu_torch",
        description="Launch a horovod_tpu_torch distributed training job.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-v", "--version", action="version",
                        version=__version__)
    parser.add_argument("-np", "--num-proc", type=int, dest="np",
                        help="Total number of worker processes.")
    parser.add_argument("--check-build", action="store_true",
                        help="Print built-in backend support and exit.")

    group_hosts = parser.add_mutually_exclusive_group()
    group_hosts.add_argument("-H", "--hosts", dest="hosts",
                             help="Comma-separated host:slots list.")
    group_hosts.add_argument("--hostfile", dest="hostfile",
                             help="Hostfile with 'hostname slots=N' lines.")

    parser.add_argument("--ssh-port", type=int, dest="ssh_port")
    parser.add_argument("--ssh-identity-file", dest="ssh_identity_file")
    parser.add_argument("--network-interfaces", dest="nics",
                        help="Restrict control-plane traffic to these NICs.")
    parser.add_argument("--start-timeout", type=int, default=30,
                        dest="start_timeout")
    parser.add_argument("--output-filename", dest="output_filename",
                        help="Directory for per-rank rank.N.log files.")
    parser.add_argument("--verbose", action="count", default=0)
    parser.add_argument("--log-level", dest="log_level",
                        choices=["TRACE", "DEBUG", "INFO", "WARNING",
                                 "ERROR", "FATAL"])

    # Tunables (reference names kept).
    parser.add_argument("--timeline-filename", dest="timeline_filename")
    parser.add_argument("--timeline-mark-cycles", action="store_true",
                        dest="timeline_mark_cycles")
    parser.add_argument("--fusion-threshold-mb", type=int,
                        dest="fusion_threshold_mb")
    parser.add_argument("--cycle-time-ms", type=float, dest="cycle_time_ms")
    parser.add_argument("--cache-capacity", type=int, dest="cache_capacity")
    parser.add_argument("--autotune", action="store_true")
    parser.add_argument("--autotune-log-file", dest="autotune_log_file")
    parser.add_argument("--stall-check-time", type=float,
                        dest="stall_check_time_seconds")
    parser.add_argument("--stall-shutdown-time", type=float,
                        dest="stall_shutdown_time_seconds")

    # Backend selectors: accepted for compatibility; hvd.init() chooses.
    parser.add_argument("--gloo", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--mpi", action="store_true",
                        help=argparse.SUPPRESS)

    # Elastic.
    parser.add_argument("--min-np", type=int, dest="min_np")
    parser.add_argument("--max-np", type=int, dest="max_np")
    parser.add_argument("--host-discovery-script",
                        dest="host_discovery_script")
    parser.add_argument("--slots", type=int, dest="slots_per_host",
                        help="Slots per discovered host (elastic).")
    parser.add_argument("--reset-limit", type=int, dest="reset_limit")

    # Fault tolerance (defaults resolve from HOROVOD_* env in the elastic
    # driver).
    parser.add_argument("--lease-ttl", type=float, dest="lease_ttl",
                        help="Heartbeat lease TTL seconds (0 disables).")
    parser.add_argument("--lease-start-grace", type=float,
                        dest="lease_start_grace",
                        help="Heartbeat silence allowed after spawn.")
    parser.add_argument("--blacklist-threshold", type=int,
                        dest="blacklist_threshold",
                        help="Failure strikes before a host is blacklisted.")
    parser.add_argument("--max-respawns", type=int, dest="max_respawns",
                        help="Per-host respawn budget before blacklisting.")

    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="Training command to run on every slot.")
    return parser.parse_args(argv)


def check_build() -> str:
    """Reference: `horovodrun --check-build` output shape.  Reads the
    build flags of torch.distributed and of the port's CUDA sources, and
    loads the native control plane (building it with g++ when it is not
    built yet: [X] means it serves); initializes no CUDA."""
    from .. import _build, _native
    from ..common import basics

    def mark(ok: bool) -> str:
        return "X" if ok else " "

    lines = [
        f"horovod_tpu_torch v{__version__}:",
        "",
        "Available backends:",
        f"    [{mark(basics.nccl_built())}] NCCL",
        f"    [{mark(basics.gloo_built())}] gloo (CPU, ranks sharing a card)",
        f"    [{mark(basics.cuda_built())}] CUDA",
        f"    [{mark(basics.mpi_built())}] MPI",
        "",
        "Available controllers:",
        "    [X] torch.distributed (c10d TCPStore)",
        "    [X] rendezvous KV (control plane)",
        "",
        "Available features:",
        "    [X] elastic",
        "    [X] adasum",
        "    [X] process sets",
        "    [X] timeline",
        "    [X] autotune",
        "    [X] quantized wire (int8/fp8 ring)",
        f"    [{mark(_build.available())}] CUDA kernels (adasum, flash "
        "attention, tiled matmul)",
        f"    [{mark(_native.load() is not None)}] native control plane "
        "(C++)",
    ]
    return "\n".join(lines)


def make_settings(args: argparse.Namespace) -> Settings:
    command = list(args.command or [])
    if command and command[0] == "--":
        command = command[1:]
    host_list = None
    if args.hosts:
        host_list = hosts_mod.parse_hosts(args.hosts)
    elif args.hostfile:
        host_list = hosts_mod.parse_hostfile(args.hostfile)
    return Settings(
        num_proc=args.np or 1,
        hosts=host_list,
        command=command,
        verbose=args.verbose,
        ssh_port=args.ssh_port,
        ssh_identity_file=args.ssh_identity_file,
        nics=args.nics,
        start_timeout=args.start_timeout,
        output_filename=args.output_filename,
        timeline_filename=args.timeline_filename,
        timeline_mark_cycles=args.timeline_mark_cycles,
        fusion_threshold_mb=args.fusion_threshold_mb,
        cycle_time_ms=args.cycle_time_ms,
        cache_capacity=args.cache_capacity,
        autotune=args.autotune,
        autotune_log_file=args.autotune_log_file,
        stall_check_time_seconds=args.stall_check_time_seconds,
        stall_shutdown_time_seconds=args.stall_shutdown_time_seconds,
        log_level=args.log_level,
        elastic=args.host_discovery_script is not None,
        min_np=args.min_np,
        max_np=args.max_np,
        host_discovery_script=args.host_discovery_script,
        slots_per_host=args.slots_per_host,
        reset_limit=args.reset_limit,
        lease_ttl=args.lease_ttl,
        lease_start_grace=args.lease_start_grace,
        blacklist_threshold=args.blacklist_threshold,
        max_respawns=args.max_respawns,
    )


def run_commandline(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.check_build:
        print(check_build())
        return 0
    if args.log_level:
        logging.basicConfig(level=getattr(
            logging, args.log_level.replace("TRACE", "DEBUG")))
    elif args.verbose:
        logging.basicConfig(level=logging.DEBUG)

    settings = make_settings(args)
    if not settings.command:
        print("Error: no training command given "
              "(usage: horovodrun_tpu -np 2 python train.py)",
              file=sys.stderr)
        return 2

    try:
        if settings.elastic:
            from .elastic.driver import elastic_run
            return elastic_run(settings)
        # Inside an LSF batch job with no explicit hosts, the scheduler's
        # allocation IS the host list (reference: launch.py auto-detects
        # LSF and routes through js_run).
        from . import lsf
        if settings.hosts is None and lsf.in_lsf_job():
            settings.hosts = lsf.lsf_hosts()
            if not args.np:
                settings.num_proc = sum(h.slots for h in settings.hosts)
                args.np = settings.num_proc
            if lsf.jsrun_available():
                return lsf.js_run(settings)
        if not args.np:
            print("Error: -np is required for static runs", file=sys.stderr)
            return 2
        if settings.hosts is None:
            settings.hosts = [hosts_mod.HostInfo("localhost", settings.num_proc)]
        slots = hosts_mod.get_host_assignments(settings.hosts,
                                               settings.num_proc)
        from .exec_run import exec_run
        return exec_run(settings, slots)
    except HorovodTpuError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
