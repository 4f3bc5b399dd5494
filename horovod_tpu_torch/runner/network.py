"""NIC discovery and interface selection (counterpart of
`horovod_tpu/runner/network.py`).

Reference parity: horovod/runner/driver/driver_service.py +
horovod/runner/common/util/network.py — pre-launch probing of each
host's routable interfaces, the common-interface intersection, and the
`--network-interfaces` restriction.

The interface chosen here governs the control plane and the bootstrap
of the data plane: the address the rendezvous KV server advertises, the
address of rank 0's c10d `TCPStore` (HOROVOD_COORDINATOR_ADDR), and so
the address NCCL and gloo exchange their bootstrap through.  The
collectives themselves go where NCCL or gloo route them.
`--network-interfaces` pins that choice; without it the launcher probes
the route toward the first remote host.
"""

from __future__ import annotations

import logging
import shlex
import socket
import struct
import subprocess
from typing import Dict, List, Optional

from ..common.exceptions import HorovodTpuError

logger = logging.getLogger("horovod_tpu_torch.runner.network")


def _ifaddr_ioctl(name: str) -> Optional[str]:
    """IPv4 address of one interface via SIOCGIFADDR (Linux)."""
    import fcntl

    SIOCGIFADDR = 0x8915
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        packed = struct.pack("256s", name.encode()[:15])
        return socket.inet_ntoa(
            fcntl.ioctl(s.fileno(), SIOCGIFADDR, packed)[20:24])
    except OSError:
        return None
    finally:
        s.close()


def local_interfaces() -> Dict[str, str]:
    """name → IPv4 address for every interface with one (reference:
    network.get_local_host_addresses / psutil.net_if_addrs usage)."""
    out: Dict[str, str] = {}
    try:
        names = [name for _idx, name in socket.if_nameindex()]
    except OSError:
        return out
    for name in names:
        addr = _ifaddr_ioctl(name)
        if addr:
            out[name] = addr
    return out


def parse_nics(nics: Optional[str]) -> List[str]:
    if not nics:
        return []
    return [n.strip() for n in nics.split(",") if n.strip()]


def resolve_advertise_address(
    nics: Optional[str] = None,
    remote_host: Optional[str] = None,
) -> str:
    """The address this process should advertise to workers.

    `nics` (from --network-interfaces) pins the choice to the first
    listed interface that exists locally — and now actually does
    something (reference: driver_service passes the intersected NIC set
    to every worker).  Without it, probe the route toward a remote host,
    falling back to the hostname's address.
    """
    wanted = parse_nics(nics)
    if wanted:
        ifaces = local_interfaces()
        for name in wanted:
            if name in ifaces:
                return ifaces[name]
        raise HorovodTpuError(
            f"none of --network-interfaces {wanted} exists locally; "
            f"available: {sorted(ifaces)}")
    if remote_host:
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.connect((remote_host, 1))
                return s.getsockname()[0]
        except OSError:
            pass
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


_REMOTE_PROBE = (
    "import json,socket,struct\n"
    "try:\n"
    " import fcntl\n"
    " out={}\n"
    " for _i,n in socket.if_nameindex():\n"
    "  s=socket.socket(socket.AF_INET,socket.SOCK_DGRAM)\n"
    "  try:\n"
    "   out[n]=socket.inet_ntoa(fcntl.ioctl(s.fileno(),0x8915,"
    "struct.pack('256s',n.encode()[:15]))[20:24])\n"
    "  except OSError: pass\n"
    "  finally: s.close()\n"
    "except Exception: out={}\n"
    "print(json.dumps(out))\n"
)


def probe_remote_interfaces(
    hostname: str,
    ssh_port: Optional[int] = None,
    ssh_identity_file: Optional[str] = None,
    runner=subprocess.run,
) -> Dict[str, str]:
    """Interface table of a remote host over SSH (reference:
    driver_service's task-service NIC probe).  `runner` is injectable so
    launcher tests mock the SSH hop, as the reference's do."""
    import json

    ssh = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        ssh += ["-p", str(ssh_port)]
    if ssh_identity_file:
        ssh += ["-i", ssh_identity_file]
    cmd = ssh + [hostname, f"python3 -c {shlex.quote(_REMOTE_PROBE)}"]
    r = runner(cmd, capture_output=True, text=True, timeout=30)
    if r.returncode != 0:
        raise HorovodTpuError(
            f"NIC probe of {hostname} failed: {r.stderr.strip()}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def common_interfaces(per_host: Dict[str, Dict[str, str]],
                      exclude_loopback: bool = True) -> List[str]:
    """Interface names present on EVERY host (reference:
    driver_service.run: the intersection the workers are told to use)."""
    if not per_host:
        return []
    names: Optional[set] = None
    for table in per_host.values():
        cur = set(table)
        names = cur if names is None else (names & cur)
    out = sorted(names or ())
    if exclude_loopback:
        out = [n for n in out if not n.startswith("lo")]
    return out


__all__ = [
    "common_interfaces",
    "local_interfaces",
    "parse_nics",
    "probe_remote_interfaces",
    "resolve_advertise_address",
]
