"""Worker-side elastic client: the KV client from the launcher's env,
the heartbeat and its lease, and the membership watch (counterpart of
`horovod_tpu/runner/elastic_worker.py`).

Reference parity: horovod/runner/elastic/worker.py
(`WorkerNotificationService/Client/Manager`) — but instead of hosting an
HTTP endpoint per worker for driver pushes, workers watch the
`elastic/current_gen` counter on the rendezvous KV store (the driver
bumps it after publishing each generation) and raise
`HostsUpdatedInterrupt` through `horovod_tpu_torch.elastic
.notify_hosts_updated` at the next commit boundary.

`refresh_from_control_plane` reads the current generation and sets the
env the next `hvd.init()` reads: rank, size and, whenever the
generation has more than one rank, HOROVOD_COORDINATOR_ADDR (every rank
of the port joins a real process group; the JAX package sets it only
under HVD_TPU_MULTIPROCESS_JAX=1).  It also takes the local and cross
rank and size from the generation's assignment (`_generation_env`), so
survivors and joiners of one generation choose the same backend.  What
serves any launched job: the KV client (`client_from_env`, used by the
consistency check and the metrics fleet), the generation counter, and
the heartbeat whose age `/healthz` reads.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Optional

from .. import faults as _faults
from ..common import util as _util
from ..common.exceptions import HorovodTpuError
from ..faults import FaultInjected, RetryPolicy
from .rendezvous import RendezvousClient

logger = logging.getLogger("horovod_tpu_torch.runner.elastic_worker")

_POLL_INTERVAL_S = 0.5
_client_thread: Optional[threading.Thread] = None
_heartbeat_thread: Optional[threading.Thread] = None
# The generation this process last joined (-1: not registered yet), and
# the newest one the watch has announced.  `_gen_lock` orders the watch's
# announcement against a refresh: a refresh drops every announcement
# queued before it (they name a generation it has now joined), and the
# watch announces again any newer generation it dropped.
_known_gen = -1
_announced_gen = -1
_gen_lock = threading.Lock()

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


def _elastic_env() -> bool:
    return os.environ.get("HOROVOD_ELASTIC") == "1"


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


def _generation_env(info: dict, me: str) -> dict:
    """The topology env of slot `me` ("host:slot") in generation `info`:
    rank and size, and the local and cross rank and size as the driver's
    `annotate_slots` derives them from the generation's slots (a host's
    slots are its local ranks; a column of equal local ranks, in rank
    order, gives the cross rank and size).  Under the fake-cluster hook
    (HVD_TPU_FAKE_LOCAL_HOSTS) the listed hosts are this one machine:
    all their ranks are local ranks of one host, so ranks that share its
    cards choose gloo as they do under one hostname."""
    host, slot = me.rsplit(":", 1)
    rank, size = info["assignments"][me], info["size"]
    fake = set(filter(None, os.environ.get(
        "HVD_TPU_FAKE_LOCAL_HOSTS", "").split(",")))
    if host in fake:
        local = sorted(r for key, r in info["assignments"].items()
                       if key.rsplit(":", 1)[0] in fake)
        local_rank, local_size = local.index(rank), len(local)
        cross_rank, cross_size = 0, 1
    else:
        column = sorted(r for key, r in info["assignments"].items()
                        if key.rsplit(":", 1)[1] == slot)
        local_rank, local_size = int(slot), info["hosts"][host]
        cross_rank, cross_size = column.index(rank), len(column)
    return {"HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(size),
            "HOROVOD_NUM_PROCESSES": str(size),
            "HOROVOD_PROCESS_ID": str(rank),
            "HOROVOD_LOCAL_RANK": str(local_rank),
            "HOROVOD_LOCAL_SIZE": str(local_size),
            "HOROVOD_CROSS_RANK": str(cross_rank),
            "HOROVOD_CROSS_SIZE": str(cross_size)}


def refresh_from_control_plane(timeout: float = 60.0) -> dict:
    """Fetch the latest generation's assignment and update this process's
    env so the next `hvd.init()` builds the new process group.

    Returns the generation info dict.  If this worker's host:slot is no
    longer assigned, exits cleanly (the driver is tearing us down).  A
    generation other than the last one joined drops the process's cached
    coordinator store (`basics.forget_store`): each generation has a
    coordinator of its own, and a rank that served the last one's store
    must not serve the next group from it.
    """
    global _known_gen, _announced_gen
    _faults.point("worker.refresh")
    client = client_from_env()
    gen = current_generation(client)
    if gen < 0:
        raise HorovodTpuError("no generation published yet")
    info = json.loads(client.wait(f"elastic/gen/{gen}/info", timeout))
    me = (f"{os.environ.get('HOROVOD_HOSTNAME', 'localhost')}:"
          f"{os.environ.get('HOROVOD_SLOT', '0')}")
    if me not in info["assignments"]:
        logger.info("worker %s not in generation %d — exiting", me, gen)
        sys.exit(0)
    os.environ.update(_generation_env(info, me))
    if info["size"] > 1:
        os.environ["HOROVOD_COORDINATOR_ADDR"] = info["coordinator"]
    else:
        # One rank: no process group to bootstrap.
        os.environ.pop("HOROVOD_COORDINATOR_ADDR", None)
    if gen != _known_gen:
        from ..common import basics
        basics.forget_store()
    # The package `elastic/`, not the torch namespace's `hvd.elastic`.
    from ..elastic import drop_host_updates
    with _gen_lock:
        _known_gen = gen
        _announced_gen = gen
        drop_host_updates()
    client.put(f"elastic/gen/{gen}/ready/{info['assignments'][me]}", "1")
    return info


def await_next_generation(timeout: float) -> bool:
    """After a failed collective: wait up to `timeout` seconds for a
    generation newer than the one joined.  A dead peer makes the driver
    publish one (it reaps the exit within its 0.2 s poll); an injected
    fault with no death behind it never does, and then the reset rejoins
    the same generation in place.  True when a newer one appeared."""
    client = client_from_env()
    deadline = time.monotonic() + timeout
    while True:
        try:
            if current_generation(client) > _known_gen:
                return True
        except HorovodTpuError:
            pass  # driver mid-restart; keep waiting
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.1)


def _poll_loop() -> None:
    global _announced_gen
    from ..elastic import notify_hosts_updated

    client = client_from_env()
    while True:
        try:
            gen = current_generation(client)
            with _gen_lock:
                if gen > _known_gen >= 0 and gen > _announced_gen:
                    logger.info("observed generation bump %d -> %d",
                                _known_gen, gen)
                    _announced_gen = gen
                    notify_hosts_updated()
        except HorovodTpuError:
            pass  # driver may be mid-restart; keep polling
        except Exception:
            logger.exception("elastic poll loop error")
        time.sleep(_POLL_INTERVAL_S)


def register() -> None:
    """The first rendezvous with the driver, under the shared
    RetryPolicy: a worker spawned while the driver is still publishing
    the first generation must not die on the race.  Nothing when this
    process has registered already or runs outside the driver.
    `hvd.init()` calls it before its first bootstrap: the driver spawns
    workers without a coordinator."""
    if not _elastic_env() or _known_gen >= 0:
        return
    RetryPolicy.from_env(
        "REGISTRATION", max_attempts=10, base_delay=0.5,
        multiplier=2.0, max_delay=4.0, jitter=0.2).run(
        refresh_from_control_plane,
        retry_on=(HorovodTpuError, OSError),
        site="worker.registration")


def maybe_start_notification_client() -> None:
    """Called from `hvd.elastic.run`'s wrapper (reference:
    WorkerNotificationManager.init).  Registers if `hvd.init()` has not,
    then starts the generation-watch thread and the heartbeat-lease
    publisher."""
    global _client_thread, _heartbeat_thread
    if not _elastic_env() or _client_thread is not None:
        return
    register()
    _client_thread = threading.Thread(target=_poll_loop, daemon=True,
                                      name="hvd-elastic-watch")
    _client_thread.start()
    ttl = lease_ttl()
    if ttl > 0 and _heartbeat_thread is None:
        _heartbeat_thread = threading.Thread(
            target=_heartbeat_loop, args=(ttl,), daemon=True,
            name="hvd-elastic-heartbeat")
        _heartbeat_thread.start()


def registered_late() -> bool:
    """True when this worker's first generation is a later one than the
    generation it was spawned for (HOROVOD_ELASTIC_GEN): it started
    slower than the job changed, and never saw the change as a bump.
    Every other member of that generation syncs on entering it (a
    joiner at its start, a rank already there in its reset), so this
    one must too."""
    spawned = os.environ.get("HOROVOD_ELASTIC_GEN")
    return (_elastic_env() and spawned is not None
            and _known_gen > int(spawned))


def is_joining_worker() -> bool:
    """True when this process was spawned into an already-running job and
    must sync state from rank 0 before its first step."""
    return os.environ.get("HOROVOD_ELASTIC_JOINING") == "1"
