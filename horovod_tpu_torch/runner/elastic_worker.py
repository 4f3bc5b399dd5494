"""Worker-side client of the rendezvous KV: the client from the
launcher's env, the heartbeat and its lease (counterpart of
`horovod_tpu/runner/elastic_worker.py`).

Reference parity: horovod/runner/elastic/worker.py.  The JAX module also
holds the elastic driver's membership watch (`refresh_from_control_plane`,
`_poll_loop`, `maybe_start_notification_client`); those read the driver's
`elastic/gen/*` keys and come with the elastic driver, which the port
does not have yet.  What is here serves any launched job: the KV client
(`client_from_env`, used by the consistency check and the metrics
fleet), the generation counter, and the heartbeat whose age `/healthz`
reads.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

from .. import faults as _faults
from ..common import util as _util
from ..common.exceptions import HorovodTpuError
from ..faults import FaultInjected
from .rendezvous import RendezvousClient

logger = logging.getLogger("horovod_tpu_torch.runner.elastic_worker")

# Distinguishes this incarnation's heartbeats from a predecessor's on the
# same host:slot — the driver detects liveness by VALUE CHANGE, so two
# incarnations must never publish identical payloads.
_HEARTBEAT_NONCE = f"{os.getpid():x}-{os.urandom(4).hex()}"

# Monotonic timestamp of the last heartbeat that reached the KV — the
# local liveness signal behind the metrics endpoint's /healthz (a probe
# that can't parse Prometheus text still learns "this worker's lease is
# being renewed").  None until the first successful beat.
_last_beat_monotonic: Optional[float] = None


def heartbeat_age() -> Optional[float]:
    """Seconds since the last successfully published heartbeat, or None
    when no heartbeat has ever landed (heartbeats disabled, not elastic,
    or the loop hasn't beaten yet)."""
    last = _last_beat_monotonic
    return None if last is None else time.monotonic() - last


def lease_ttl() -> float:
    """Heartbeat lease TTL in seconds (0 disables heartbeats).  The
    driver injects its resolved value into worker env so both sides
    agree on the deadline."""
    return _util.env_float("ELASTIC_LEASE_TTL", 15.0)


def heartbeat_key() -> str:
    host = os.environ.get("HOROVOD_HOSTNAME", "localhost")
    slot = os.environ.get("HOROVOD_SLOT", "0")
    return f"elastic/heartbeat/{host}:{slot}"


def publish_heartbeat(client: RendezvousClient, seq: int,
                      ttl: float) -> None:
    """One TTL'd heartbeat: a changing KV value (driver watches for
    change with its own clock — immune to cross-host clock skew) plus a
    server-side lease renewal for barrier fast-fail (Python engine)."""
    _faults.point("worker.heartbeat")
    key = heartbeat_key()
    client.put(key, json.dumps(
        {"seq": seq, "nonce": _HEARTBEAT_NONCE, "ts": time.time()}))
    client.renew_lease(f"worker/{key.rsplit('/', 1)[1]}", ttl)
    global _last_beat_monotonic
    _last_beat_monotonic = time.monotonic()


def _heartbeat_loop(ttl: float) -> None:
    interval = _util.env_float(
        "HEARTBEAT_INTERVAL", max(ttl / 3.0, 0.5))
    client = client_from_env()
    seq = 0
    while True:
        seq += 1
        try:
            publish_heartbeat(client, seq, ttl)
        except FaultInjected:
            logger.warning("heartbeat %d dropped (injected fault)", seq)
        except Exception:  # noqa: BLE001 — keep beating through restarts
            logger.debug("heartbeat %d failed (server mid-restart?)", seq,
                         exc_info=True)
        time.sleep(interval)


def client_from_env() -> RendezvousClient:
    try:
        return RendezvousClient(
            os.environ["HOROVOD_RENDEZVOUS_ADDR"],
            int(os.environ["HOROVOD_RENDEZVOUS_PORT"]),
            os.environ["HOROVOD_SECRET_KEY"],
        )
    except KeyError as e:
        raise HorovodTpuError(
            f"elastic worker missing rendezvous env: {e}") from e


def current_generation(client: Optional[RendezvousClient] = None) -> int:
    client = client or client_from_env()
    val = client.get("elastic/current_gen")
    return int(val) if val is not None else -1


def is_joining_worker() -> bool:
    """True when this process was spawned into an already-running job and
    must sync state from rank 0 before its first step."""
    return os.environ.get("HOROVOD_ELASTIC_JOINING") == "1"
