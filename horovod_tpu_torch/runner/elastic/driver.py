"""Elastic driver: membership authority + worker lifecycle manager
(counterpart of `horovod_tpu/runner/elastic/driver.py`).

Reference parity: horovod/runner/elastic/driver.py (`ElasticDriver`:
`wait_for_available_slots`, `_discovery_thread`, host blacklisting, rank
reassignment, worker restart) and `gloo_run_elastic`.

Protocol over the rendezvous KV store (TPU-native replacement for the
reference's per-worker notification HTTP services):

    elastic/current_gen                = "g"     (bumped last)
    elastic/gen/{g}/info               = JSON {size, coordinator,
                                         assignments: {"host:slot": rank},
                                         hosts: {host: slots}}
    elastic/gen/{g}/ready/{rank}       = "1"     (worker rendezvoused)

The driver computes a new generation whenever discovery output or worker
failures change the usable host set; workers observe `current_gen` (poll
thread → `HostsUpdatedInterrupt` at the next `state.commit()`), fetch the
new generation's info, and build its process group (coordinator = the
TCPStore rank 0 binds).  Hosts whose workers fail are
blacklisted.  The job succeeds when every worker of the current
generation exits 0; it aborts when usable slots fall below --min-np or
the reset count exceeds --reset-limit.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ... import faults as _faults
from ...common import util as _util
from ...common.exceptions import HorovodTpuError
from ...metrics import catalog as _met
from .. import safe_exec
from ..exec_run import (
    DEFAULT_COORDINATOR_PORT,
    _free_port,
    _is_local,
    _my_addr,
    build_command,
    slot_env,
)
from ..hosts import HostInfo, SlotInfo, annotate_slots, get_host_assignments
from ..rendezvous import RendezvousServer
from ..settings import Settings
from .discovery import HostDiscovery, HostDiscoveryScript
from . import registration
from .registration import WorkerStateRegistry

logger = logging.getLogger("horovod_tpu_torch.runner.elastic")

DISCOVERY_INTERVAL_S = 1.0


class ExecTransport:
    """Worker spawn/teardown seam.

    The driver owns membership and generations; HOW a worker process is
    started on its host is a transport decision: local fork / ssh (the
    default below, the reference's gloo_run path) or another backend
    passed to `elastic_run` (the JAX package's Ray actors).  A handle
    must expose `poll() -> rc|None`; the transport owns termination of
    its handles.
    """

    def command_for(self, slot: SlotInfo, settings: Settings,
                    env: Dict[str, str]) -> List[str]:
        raise NotImplementedError

    def execute(self, cmd: List[str], env: Dict[str, str],
                prefix: str) -> object:
        raise NotImplementedError

    def terminate(self, handles: List[object]) -> None:
        raise NotImplementedError


class LocalSshTransport(ExecTransport):
    """Default transport: direct exec for local slots, ssh for remote
    (build_command), process-group teardown via safe_exec."""

    def command_for(self, slot, settings, env):
        return build_command(slot, settings, env)

    def execute(self, cmd, env, prefix):
        return safe_exec.execute(cmd, env=env, prefix=prefix,
                                 background=True)

    def terminate(self, handles):
        pids = [h.pid for h in handles if h.poll() is None]
        if pids:
            # One shared grace deadline for the whole group — serial
            # terminate() would stall the monitor loop N*5s.
            safe_exec.terminate_trees(pids)


class ElasticDriver:
    def __init__(self, settings: Settings, discovery: HostDiscovery,
                 transport: Optional[ExecTransport] = None):
        self.settings = settings
        self.discovery = discovery
        self.transport = transport or LocalSshTransport()
        self.registry = WorkerStateRegistry(
            getattr(settings, "blacklist_threshold", None))
        self.server = RendezvousServer(verbose=settings.verbose)
        self.gen = -1
        self.reset_count = 0
        # (host, slot) -> (process handle, assigned rank, generation)
        self.workers: Dict[Tuple[str, int], Tuple[object, int, int]] = {}
        self.assignments: Dict[Tuple[str, int], SlotInfo] = {}
        # Slots whose worker exited 0: their training is complete; they are
        # never re-assigned (a new worker there would redo finished work).
        self.finished_slots: set = set()
        self._last_discovery = 0.0
        self._active_hosts: Dict[str, int] = {}
        self.min_np = settings.min_np or settings.num_proc or 1
        self.max_np = settings.max_np

        # -- fault-tolerance knobs (Settings wins, then env, then default)
        def _knob(value, from_env):
            return from_env if value is None else value

        # Heartbeat lease: a worker whose beats stop for lease_ttl is
        # failed while its process still runs (0 disables).
        self.lease_ttl = _knob(settings.lease_ttl,
                               _util.env_float("ELASTIC_LEASE_TTL", 15.0))
        # Grace after spawn before a silent (never-beaten) worker is
        # failed — covers interpreter + torch import + first rendezvous.
        self.start_grace = _knob(
            settings.lease_start_grace,
            _util.env_float("ELASTIC_START_GRACE", 60.0))
        # Per-host respawn budget: beyond this many respawns the host is
        # blacklisted outright (a host that fails instantly in a loop
        # must not be retried forever).
        self.max_respawns = _knob(
            settings.max_respawns, _util.env_int("MAX_RESPAWNS_PER_HOST", 3))
        self._backoff_base = _util.env_float("RESPAWN_BACKOFF_BASE", 1.0)
        self._backoff_max = _util.env_float("RESPAWN_BACKOFF_MAX", 30.0)

        # Heartbeat bookkeeping: last seen value + expiry deadline per
        # slot (driver clock only — cross-host clock skew irrelevant).
        self._hb_value: Dict[Tuple[str, int], str] = {}
        self._hb_deadline: Dict[Tuple[str, int], float] = {}
        self._next_lease_check = 0.0
        # Respawn bookkeeping.
        self._respawn_after: Dict[str, float] = {}   # host -> not-before
        self._respawns: Dict[str, int] = {}          # host -> respawn count
        self._spawned_once: set = set()              # slots spawned >= once
        self._need_transition = False
        self._kv = None
        self._published_size = 0

    # -- membership ------------------------------------------------------

    def _discover(self) -> Dict[str, int]:
        hosts = self.discovery.find_available_hosts_and_slots()
        return {h: s for h, s in hosts.items()
                if not self.registry.is_blacklisted(h)}

    def wait_for_available_slots(self, min_np: int,
                                 timeout: float) -> Dict[str, int]:
        """Block until discovery yields >= min_np usable slots (reference:
        ElasticDriver.wait_for_available_slots)."""
        deadline = time.time() + timeout
        while True:
            hosts = self._discover()
            if sum(hosts.values()) >= min_np:
                return hosts
            if time.time() > deadline:
                raise HorovodTpuError(
                    f"Timed out waiting for {min_np} slots; discovered "
                    f"{hosts} (blacklist: {self.registry.blacklist()})")
            time.sleep(DISCOVERY_INTERVAL_S)

    def _compute_assignments(
            self, hosts: Dict[str, int]) -> List[SlotInfo]:
        host_list = [HostInfo(h, s) for h, s in sorted(hosts.items())]
        total = sum(hosts.values())
        np_ = min(total, self.max_np) if self.max_np else total
        return get_host_assignments(host_list, min(self.min_np, np_), np_)

    # -- generation transitions ------------------------------------------

    def _publish_generation(self, slots: List[SlotInfo]) -> None:
        # Finished slots stay out of the published membership: their worker
        # exited 0 and will never be respawned, so a generation that counts
        # them would make survivors wait on a rank that never connects
        # (every published rank must reach the generation's process
        # group).  They remain in the driver's completion bookkeeping
        # only.
        live = [s for s in slots
                if (s.hostname, s.local_rank) not in self.finished_slots]
        if not live:
            # Every assigned worker already finished; the monitor loop's
            # completion check will end the job — nothing to publish.
            logger.info("all assigned workers finished; skipping generation")
            return
        _faults.point("elastic.publish")
        live.sort(key=lambda s: s.rank)
        for i, s in enumerate(live):  # contiguous ranks over live workers
            s.rank = i
        # Re-derive size/local_size/cross_* over the live set so the env a
        # respawned worker receives is self-consistent (no phantom peers).
        annotate_slots(live)
        slots = live
        self.gen += 1
        # A remote host may join a job that started all-local; loopback
        # rendezvous would point new remote workers at themselves.
        if (not self._all_local(slots)
                and self.settings.rendezvous_addr in (None, "127.0.0.1")):
            self.settings.rendezvous_addr = _my_addr(slots, self.settings.nics)
        rank0 = slots[0]
        if _is_local(rank0.hostname):
            coord = (f"{'127.0.0.1' if self._all_local(slots) else _my_addr(slots, self.settings.nics)}"
                     f":{_free_port()}")
        else:
            coord = f"{rank0.hostname}:{self._coordinator_port()}"
        info = {
            "size": len(slots),
            "coordinator": coord,
            "assignments": {f"{s.hostname}:{s.local_rank}": s.rank
                            for s in slots},
            "hosts": {s.hostname: s.local_size for s in slots},
        }
        kv = self.server.kv()
        kv.put(f"elastic/gen/{self.gen}/info", json.dumps(info))
        kv.put("elastic/current_gen", str(self.gen))
        old_slots = set(self.assignments)
        new_slots = {(s.hostname, s.local_rank) for s in slots}
        if _met.enabled():
            if new_slots - old_slots:
                _met.elastic_rank_added.inc(len(new_slots - old_slots))
            if old_slots - new_slots:
                _met.elastic_rank_removed.inc(len(old_slots - new_slots))
        self.assignments = {(s.hostname, s.local_rank): s for s in slots}
        if _met.enabled():
            _met.elastic_slots.set(len(slots))
        if 0 < len(slots) < self._published_size:
            # Graceful degradation: fewer slots than last generation but
            # still >= min_np — keep running shrunken rather than abort.
            logger.warning(
                "generation %d runs DEGRADED: %d workers (was %d, "
                "min_np=%d)", self.gen, len(slots), self._published_size,
                self.min_np)
        self._published_size = len(slots)
        logger.info("generation %d: %d workers on %s", self.gen,
                    len(slots), sorted(info["hosts"]))

    @staticmethod
    def _all_local(slots: List[SlotInfo]) -> bool:
        return all(_is_local(s.hostname) for s in slots)

    def _coordinator_port(self) -> int:
        """Remote rank-0 coordinator (TCPStore) port for this job +
        generation.

        Offset by a hash of the job's rendezvous secret so two concurrent
        jobs sharing a host don't collide on a fixed base, and spread
        generations over a window wide enough that a lingering listener
        from gen N (TIME_WAIT / late shutdown) can't collide with gen
        N+100.  For guaranteed isolation pass an explicit base via
        HOROVOD_COORDINATOR_BASE_PORT.
        """
        env_base = os.environ.get("HOROVOD_COORDINATOR_BASE_PORT")
        if env_base:
            base = int(env_base)
        else:
            job_off = int(hashlib.sha256(
                self.server.secret.encode()).hexdigest(), 16) % 2000
            base = DEFAULT_COORDINATOR_PORT + job_off
        return base + (self.gen % 500)

    def _spawn_missing_workers(self) -> None:
        now = time.time()
        for (host, slot_idx), slot in self.assignments.items():
            key = (host, slot_idx)
            if key in self.finished_slots:
                continue  # completed training; never redo finished work
            live = self.workers.get(key)
            if live is not None:
                # Alive — or exited but not yet reaped.  Never respawn
                # over an unreaped handle: the monitor's reap must
                # classify that exit (success/failure) exactly once, and
                # overwriting the entry here would silently drop an rc=0
                # completion that raced the generation transition.
                continue
            if self.registry.is_blacklisted(host):
                continue  # next transition drops the host from assignments
            if now < self._respawn_after.get(host, 0.0):
                continue  # exponential backoff; retried next monitor tick
            if key in self._spawned_once:
                # This is a RE-spawn — charge the per-host budget.  Beyond
                # it, a host that keeps killing its workers gets
                # blacklisted outright instead of being retried forever.
                if self._respawns.get(host, 0) >= self.max_respawns:
                    self.registry.blacklist_host(
                        host, f"respawn budget exhausted "
                              f"({self.max_respawns})")
                    self._need_transition = True
                    continue
                self._respawns[host] = self._respawns.get(host, 0) + 1
                if _met.enabled():
                    _met.worker_respawns.inc()
            env = slot_env(slot, self.settings, self.server.secret,
                           coordinator_addr="")  # workers read gen info
            env.update({
                "HOROVOD_ELASTIC": "1",
                "HOROVOD_HOSTNAME": host,
                "HOROVOD_SLOT": str(slot_idx),
                "HOROVOD_ELASTIC_GEN": str(self.gen),
                # Driver's resolved TTL so worker heartbeat cadence and
                # driver expiry agree even if only one side was configured.
                "HOROVOD_ELASTIC_LEASE_TTL": str(self.lease_ttl),
                # And its start grace: a worker's bootstrap waits that
                # long, and a little more, for the generation's other
                # ranks (`basics._bootstrap_timeout`).
                "HOROVOD_ELASTIC_START_GRACE": str(self.start_grace),
                # Workers spawned into a running job must state.sync()
                # before their first step.
                "HOROVOD_ELASTIC_JOINING": "1" if self.gen > 0 else "0",
            })
            env.pop("HOROVOD_COORDINATOR_ADDR", None)
            try:
                _faults.point("elastic.spawn")
                cmd = self.transport.command_for(slot, self.settings, env)
                handle = self.transport.execute(cmd, env=env,
                                                prefix=f"{slot.rank}")
            except Exception as e:  # noqa: BLE001 — transport/injected
                logger.warning("spawn failed for %s:%d: %s",
                               host, slot_idx, e)
                self._record_worker_failure(host, slot_idx,
                                            registration.SPAWN)
                self._need_transition = True
                continue
            self.workers[key] = (handle, slot.rank, self.gen)
            self._spawned_once.add(key)
            # Fresh lease deadline; keep any stale _hb_value so a leftover
            # beat from the previous incarnation can't count as fresh (the
            # new worker's nonce makes its first beat differ).
            self._hb_deadline[key] = now + max(self.start_grace,
                                               self.lease_ttl)
            logger.info("spawned worker %s:%d rank=%d pid=%s",
                        host, slot_idx, slot.rank,
                        getattr(handle, "pid", "?"))

    def _kill_removed_workers(self) -> None:
        doomed = []
        for key, (handle, rank, _) in list(self.workers.items()):
            if key not in self.assignments and handle.poll() is None:
                logger.info("terminating worker %s (no longer assigned)", key)
                doomed.append(handle)
        if doomed:
            self.transport.terminate(doomed)

    # -- failure accounting / heartbeat leases ---------------------------

    def _record_worker_failure(self, host: str, slot_idx: int,
                               reason: str) -> None:
        """Strike the registry and push the host's next spawn out by an
        exponential backoff — a crash-looping host must not be respawned
        at monitor-loop frequency."""
        self.registry.record_failure(host, slot_idx, reason)
        fails = self.registry.failure_count(host)
        backoff = min(self._backoff_base * (2.0 ** max(fails - 1, 0)),
                      self._backoff_max)
        self._respawn_after[host] = time.time() + backoff
        logger.info("host %s failure #%d (%s): next spawn in %.1fs",
                    host, fails, reason, backoff)

    def _check_leases(self, now: float) -> bool:
        """Detect hung-but-alive workers by heartbeat-lease expiry.

        Liveness = the worker's heartbeat KV value CHANGED since last
        check (value comparison + driver clock only, so cross-host clock
        skew can't produce false expiries).  A worker whose value stops
        changing for lease_ttl — while its process still runs — is
        terminated and failed, exactly as if it had crashed.  Engine
        agnostic: plain GETs work against both the Python and native KV
        stores.  Returns True when a lease expiry requires a new
        generation.
        """
        if self.lease_ttl <= 0 or self._kv is None:
            return False
        if now < self._next_lease_check:
            return False
        self._next_lease_check = now + max(self.lease_ttl / 3.0, 0.5)
        need_new_gen = False
        for key, (handle, rank, gen) in list(self.workers.items()):
            if handle.poll() is not None:
                continue  # exit path reaps it with the real rc
            host, slot_idx = key
            try:
                val = self._kv.get(f"elastic/heartbeat/{host}:{slot_idx}")
            except HorovodTpuError:
                continue  # KV hiccup; judged again next interval
            if val is not None and val != self._hb_value.get(key):
                self._hb_value[key] = val
                self._hb_deadline[key] = now + self.lease_ttl
                continue
            deadline = self._hb_deadline.get(key)
            if deadline is None:
                # Pre-existing worker adopted mid-run (first lease pass):
                # start its clock now rather than expiring it instantly.
                self._hb_deadline[key] = now + max(self.start_grace,
                                                   self.lease_ttl)
                continue
            if now >= deadline:
                logger.warning(
                    "worker %s:%d (rank %d) heartbeat lease EXPIRED "
                    "(no beat for %.1fs) — failing it while alive",
                    host, slot_idx, rank, self.lease_ttl)
                if _met.enabled():
                    _met.worker_lease_expired.inc()
                # Terminate OFF the monitor thread: terminate() waits a
                # multi-second grace for the tree to die (and a SIGTERMed
                # child stays a zombie until we reap it, which we can't
                # while blocked there) — stalling here would delay the
                # degraded-generation publish past the point survivors
                # can still use it.
                threading.Thread(
                    target=self.transport.terminate, args=([handle],),
                    daemon=True, name=f"terminate-{host}:{slot_idx}",
                ).start()
                # Remove now so the exit-reap path can't double-strike
                # the host when the terminated process is next polled.
                del self.workers[key]
                self._record_worker_failure(host, slot_idx,
                                            registration.LEASE_EXPIRED)
                need_new_gen = True
        return need_new_gen

    # -- main loop -------------------------------------------------------

    def run(self, result_hook=None) -> int:
        # Ensure workers are torn down even when the driver is SIGTERMed
        # (tests and schedulers kill the driver; workers live in their own
        # process groups and would otherwise leak).
        import signal

        def _terminate(_sig, _frm):
            raise KeyboardInterrupt

        try:
            signal.signal(signal.SIGTERM, _terminate)
        except ValueError:
            pass  # not the main thread (embedded use)
        port = self.server.start()
        self._kv = self.server.kv()
        self.settings.rendezvous_port = port
        self.settings.rendezvous_addr = "127.0.0.1"

        hosts = self.wait_for_available_slots(
            self.min_np, timeout=self.settings.start_timeout)
        # Multi-host: advertise a routable rendezvous address.
        if any(not _is_local(h) for h in hosts):
            slots_probe = self._compute_assignments(hosts)
            self.settings.rendezvous_addr = _my_addr(slots_probe, self.settings.nics)
        self._active_hosts = hosts
        self._publish_generation(self._compute_assignments(hosts))
        self._spawn_missing_workers()

        try:
            rc = self._monitor_loop()
            if rc == 0 and result_hook is not None:
                # Same contract as exec_run's result_hook: pull worker
                # results off the KV store before the server stops.
                result_hook(self.server)
            return rc
        finally:
            self.transport.terminate([
                h for h, _, _ in self.workers.values()
                if h.poll() is None])
            self.server.stop()

    def _monitor_loop(self) -> int:
        while True:
            rc = self._monitor_once()
            if rc is not None:
                return rc
            time.sleep(0.2)

    def _monitor_once(self) -> Optional[int]:
        """One monitor iteration (split out so tests can drive the state
        machine deterministically).  Returns the job's exit code when it
        finishes, else None."""
        need_new_gen = False

        # 1. Reap worker exits.
        for key, (handle, rank, gen) in list(self.workers.items()):
            rc = handle.poll()
            if rc is None:
                continue
            host, slot_idx = key
            del self.workers[key]
            if key not in self.assignments:
                continue  # removed worker exiting, expected
            if rc == 0:
                self.registry.record_success(host, slot_idx)
                self.finished_slots.add((host, slot_idx))
                logger.info("worker %s:%d (rank %d) finished",
                            host, slot_idx, rank)
            else:
                logger.warning("worker %s:%d (rank %d) failed rc=%d",
                               host, slot_idx, rank, rc)
                self._record_worker_failure(host, slot_idx,
                                            registration.EXIT)
                need_new_gen = True

        # 2. Every currently-assigned slot finished → job done.  Keyed
        # on finished_slots (not registry states, which persist across
        # generations and would mis-declare success for a respawned
        # slot that merely shares a host with an old SUCCESS record).
        current = list(self.assignments)
        if current and all(k in self.finished_slots for k in current):
            return 0

        now = time.time()

        # 3. Heartbeat leases: fail hung-but-alive workers BEFORE any
        # process-exit signal arrives.
        if self._check_leases(now):
            need_new_gen = True

        # 4. Periodic re-discovery.
        if now - self._last_discovery > DISCOVERY_INTERVAL_S:
            self._last_discovery = now
            try:
                hosts = self._discover()
            except HorovodTpuError as e:
                logger.warning("discovery failed: %s", e)
                hosts = self._active_hosts
            if hosts != self._active_hosts:
                logger.info("host set changed: %s -> %s",
                            self._active_hosts, hosts)
                need_new_gen = True
                self._active_hosts = hosts

        # Deferred transitions (spawn failure, respawn budget exhausted).
        if self._need_transition:
            self._need_transition = False
            need_new_gen = True

        # 5. Generation transition.
        if need_new_gen:
            # _active_hosts may predate the failure that triggered this
            # transition; re-apply the blacklist.  Finished slots stay
            # in the assignment (their work is done and they are never
            # respawned) so staggered completion neither churns
            # generations nor trips the min-np abort.
            usable = {
                h: s for h, s in self._active_hosts.items()
                if not self.registry.is_blacklisted(h)
            }
            if sum(usable.values()) < self.min_np:
                logger.error(
                    "only %d usable slots < min_np=%d — aborting",
                    sum(usable.values()), self.min_np)
                return 1
            if (self.settings.reset_limit is not None
                    and self.reset_count >= self.settings.reset_limit):
                logger.error("reset limit %d reached — aborting",
                             self.settings.reset_limit)
                return 1
            self.reset_count += 1
            if _met.enabled():
                _met.elastic_restarts.inc()
            self._active_hosts = usable
            self._publish_generation(self._compute_assignments(usable))
            self._kill_removed_workers()

        # 6. (Re)spawn: every iteration, not just on transitions, so
        # spawns deferred by backoff windows are retried promptly.
        self._spawn_missing_workers()
        return None


def elastic_run(settings: Settings, result_hook=None,
                discovery: Optional[HostDiscovery] = None,
                transport: Optional[ExecTransport] = None) -> int:
    """Entry from launch.py for `--host-discovery-script` runs, `run()`
    and `ElasticExecutor`; also the programmatic entry for other
    discovery / transport backends."""
    if discovery is None:
        if not settings.host_discovery_script:
            raise HorovodTpuError(
                "elastic runs require --host-discovery-script (or a "
                "HostDiscovery instance)")
        discovery = HostDiscoveryScript(
            settings.host_discovery_script,
            default_slots=settings.slots_per_host or 1)
    return ElasticDriver(settings, discovery, transport).run(result_hook)
