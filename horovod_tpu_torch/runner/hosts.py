"""Host parsing and rank→slot assignment (counterpart of
`horovod_tpu/runner/hosts.py`).

Reference parity: horovod/runner/common/util/hosts.py (`parse_hosts`,
`parse_host_files`, `get_host_assignments`, `SlotInfo`).  The rank math is
kept identical to the reference so tests can assert the same assignments:
ranks are filled host-major; `cross_rank` of a slot with local_rank=L is
the index of its host among all hosts that have more than L slots, and
`cross_size` is the count of such hosts.

GPU note: as in the reference, one slot is one worker process, and one
process drives one GPU: `hvd.init()` picks card `local_rank %
device_count` (`common/basics.py _resolve_device`), so a host with 8
cards has 8 slots.  More slots than cards share them over gloo.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

from ..common.exceptions import HorovodTpuError


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int

    @staticmethod
    def from_string(host_string: str) -> "HostInfo":
        m = re.match(r"^([\w.\-\[\]]+):([0-9]+)$", host_string.strip())
        if not m:
            raise HorovodTpuError(
                f"Invalid host input '{host_string}': expected "
                f"<hostname>:<slots>"
            )
        return HostInfo(m.group(1), int(m.group(2)))


@dataclasses.dataclass
class SlotInfo:
    """One worker process's coordinates (reference: hosts.py SlotInfo)."""

    hostname: str
    rank: int = -1
    local_rank: int = -1
    cross_rank: int = -1
    size: int = -1
    local_size: int = -1
    cross_size: int = -1

    def to_response_string(self) -> str:
        return (
            f"{self.hostname}[{self.rank}]: local={self.local_rank}/"
            f"{self.local_size} cross={self.cross_rank}/{self.cross_size}"
        )


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """Parse ``-H host1:2,host2:4`` into HostInfo records."""
    hosts = [HostInfo.from_string(h)
             for h in hosts_string.split(",") if h.strip()]
    if not hosts:
        raise HorovodTpuError(f"No hosts in host string '{hosts_string}'")
    names = [h.hostname for h in hosts]
    if len(set(names)) != len(names):
        raise HorovodTpuError(f"Duplicate host names in '{hosts_string}'")
    return hosts


def parse_hostfile(path: str) -> List[HostInfo]:
    """Parse a hostfile with lines ``hostname slots=N`` (or ``hostname N``,
    or bare ``hostname`` meaning 1 slot).  Reference: parse_host_files."""
    hosts: List[HostInfo] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r"^([\w.\-\[\]]+)(?:\s+(?:slots=)?([0-9]+))?$", line)
            if not m:
                raise HorovodTpuError(
                    f"{path}:{lineno}: invalid hostfile line '{line}'"
                )
            hosts.append(HostInfo(m.group(1), int(m.group(2) or 1)))
    if not hosts:
        raise HorovodTpuError(f"Hostfile '{path}' contains no hosts")
    return hosts


def get_host_assignments(
    hosts: List[HostInfo],
    min_np: int,
    max_np: Optional[int] = None,
) -> List[SlotInfo]:
    """Assign ranks to host slots, host-major (reference:
    hosts.py get_host_assignments).

    Returns one SlotInfo per assigned rank.  Raises if fewer than `min_np`
    slots are available; assigns at most `max_np` (or min_np when max_np is
    None, matching the static-launch path where min_np == -np).
    """
    total_slots = sum(h.slots for h in hosts)
    if total_slots < min_np:
        raise HorovodTpuError(
            f"Requested {min_np} processes but only {total_slots} slots "
            f"available on {[h.hostname for h in hosts]}"
        )
    np_ = min(total_slots, max_np) if max_np is not None else min_np

    slots: List[SlotInfo] = []
    rank = 0
    for host in hosts:
        for local_rank in range(host.slots):
            if rank >= np_:
                break
            slots.append(SlotInfo(
                hostname=host.hostname, rank=rank, local_rank=local_rank,
            ))
            rank += 1

    annotate_slots(slots)
    return slots


def annotate_slots(slots: List[SlotInfo]) -> None:
    """Fill in size/local_size/cross_rank/cross_size for an assignment —
    identical math to the reference.  Also used to re-annotate a filtered
    slot list (elastic generations exclude finished slots)."""
    by_host: dict = {}
    by_column: dict = {}
    for s in slots:
        by_host.setdefault(s.hostname, []).append(s)
        by_column.setdefault(s.local_rank, []).append(s)
    for s in slots:
        s.size = len(slots)
        s.local_size = len(by_host[s.hostname])
        column = by_column[s.local_rank]
        s.cross_rank = column.index(s)
        s.cross_size = len(column)
