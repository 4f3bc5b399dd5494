"""Host discovery for elastic jobs (counterpart of
`horovod_tpu/runner/elastic/discovery.py`).

Reference parity: horovod/runner/elastic/discovery.py — `HostDiscovery`
(interface), `HostDiscoveryScript` (runs the user's
`--host-discovery-script`, one `hostname[:slots]` per output line).
`FixedHosts` is the test double the reference uses in its elastic unit
tests.
"""

from __future__ import annotations

import logging
import subprocess
from typing import Dict

from ...common.exceptions import HorovodTpuError

logger = logging.getLogger("horovod_tpu_torch.runner.elastic")


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        """Return {hostname: slots} currently available."""
        raise NotImplementedError


class FixedHosts(HostDiscovery):
    """Static host set (test double; reference: discovery.FixedHosts)."""

    def __init__(self, hosts: Dict[str, int]):
        self._hosts = dict(hosts)

    def set(self, hosts: Dict[str, int]) -> None:
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._hosts)


class HostDiscoveryScript(HostDiscovery):
    """Runs the user-provided script; each stdout line is
    `hostname[:slots]` (reference: HostDiscoveryScript.execute)."""

    def __init__(self, script: str, default_slots: int = 1):
        self._script = script
        self._default_slots = default_slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        try:
            out = subprocess.run(
                self._script, shell=True, capture_output=True, text=True,
                timeout=60,
            )
        except subprocess.TimeoutExpired as e:
            raise HorovodTpuError(
                f"host discovery script timed out: {self._script}") from e
        if out.returncode != 0:
            raise HorovodTpuError(
                f"host discovery script failed "
                f"(rc={out.returncode}): {out.stderr.strip()}")
        hosts: Dict[str, int] = {}
        for line in out.stdout.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                name, slots = line.rsplit(":", 1)
                try:
                    hosts[name] = int(slots)
                except ValueError:
                    raise HorovodTpuError(
                        f"bad discovery line {line!r}") from None
            else:
                hosts[line] = self._default_slots
        return hosts
