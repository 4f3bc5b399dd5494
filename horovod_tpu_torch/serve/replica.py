"""Elastic multi-replica serving: lease/respawn over inference replicas
(counterpart of `horovod_tpu/serve/replica.py`).

Training already has the machinery (`runner/elastic/`): value-change
heartbeat leases find hung-but-alive workers, `WorkerStateRegistry`
counts strikes and blacklists hosts, the driver respawns with backoff.
Serving reuses those pieces; only the unit of recovery changes: not a
training generation, but the set of in-flight sequences a dead replica
was decoding.

Topology: the manager runs a `RendezvousServer` (the launcher's control
plane) and spawns N ``python -m horovod_tpu_torch.serve.replica``
worker processes.  All coordination is KV keys, the JAX package's, so a
manager of either package drives replicas of either:

  serve/config              model + server spec, JSON (manager -> all)
  serve/assign/<rid>/<req>  request payload, JSON (manager -> replica)
  serve/result/<req>        generated tokens, JSON (replica -> manager)
  serve/heartbeat/<rid>     incrementing counter (replica liveness)
  serve/digest/<rid>        sha256 of the replica's parameters (the
                            split-brain check: every member must agree)
  serve/retire/<rid>        set to drain and exit ONE replica (shrink)
  serve/cancel/<req>        set to shed one queued request fleet-wide
  serve/stop                set to drain and exit every replica

The fleet is elastic: ``scale_to(n)`` grows by spawning fresh replica
ids and shrinks by retiring the highest ones (a ``serve/retire`` key;
their unfinished work is reassigned to survivors, and because decode is
deterministic a request finished by both produces the same tokens).
``digest_agreement`` is the no-split-brain check that
`serve/autoscale.py run_scale_chaos` asserts after every faulted event.

Failure model: a replica dies (a crash, or the ``serve.replica_die``
fault point) or its heartbeat value stops changing for ``lease_ttl``
seconds.  The manager records the strike, reassigns every request the
dead replica had not finished to the live replicas (deleting its
assign key, so that the respawn does not decode it again; with no live
replica it stays and the respawn takes it), and respawns the process
unless the registry has blacklisted it.  Replicas build their
weights from the config seed and decode greedily, so a recovered
sequence's tokens are those of the no-fault run where decode does not
depend on the batch (the CPU at f32); on the card a reassigned request
is decoded again in another batch, and a greedy near-tie may go either
way.

The replica builds its model on the device of the config's ``serve``
dict (``"device": "cpu"``), else on the card, the server's default.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Set

from .. import faults as _faults
from ..common.exceptions import HorovodTpuError, InvalidRequestError
from ..metrics import catalog as _met
from ..runner.elastic.registration import WorkerStateRegistry
from ..runner.rendezvous import RendezvousClient, RendezvousServer

logger = logging.getLogger("horovod_tpu_torch.serve.replica")

# The directory that holds the package: a spawned replica imports it
# from there whatever its working directory.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ReplicaManager:
    """Spawns, monitors, and heals a fleet of serving replicas."""

    def __init__(self, n_replicas: int, config: Dict, *,
                 lease_ttl: float = 5.0, respawn_backoff: float = 0.5,
                 failure_threshold: int = 3,
                 child_env: Optional[Dict[str, str]] = None):
        if n_replicas < 1:
            raise InvalidRequestError(
                f"n_replicas must be >= 1, got {n_replicas}")
        self.n_replicas = n_replicas
        self.config = config
        self.lease_ttl = lease_ttl
        self.respawn_backoff = respawn_backoff
        self.child_env = dict(child_env or {})
        self.registry = WorkerStateRegistry(
            failure_threshold=failure_threshold)
        self.server = RendezvousServer()
        self.port = self.server.start(0)
        self.kv = self.server.kv()
        self.kv.put("serve/config", json.dumps(config))
        self.procs: Dict[int, subprocess.Popen] = {}
        self.assigned: Dict[int, Set[int]] = {}
        self.results: Dict[int, List[int]] = {}
        self._requests: Dict[int, Dict] = {}
        self._submit_ts: Dict[int, float] = {}
        self._next_req = 0
        self._rr = 0
        self._hb_last: Dict[int, Optional[str]] = {}
        self._hb_deadline: Dict[int, float] = {}
        self._spawn_ts: Dict[int, float] = {}
        self._hb_stale: Dict[int, Optional[str]] = {}
        #: (rid, seconds from spawn to the first heartbeat seen) of
        #: every incarnation, in the order they beat.
        self.first_beats: List[tuple] = []
        self._down: Set[int] = set()
        self._shed: Set[int] = set()
        self._respawns = 0
        #: Active fleet membership (rids).  Grow adds fresh ids, shrink
        #: retires the highest: ids are never reused, so a late
        #: heartbeat from a retired incarnation is never a member's.
        self.members: Set[int] = set(range(n_replicas))
        for r in sorted(self.members):
            self._spawn(r)

    # -- process control -----------------------------------------------

    def _host(self, rid: int) -> str:
        return f"replica{rid}"

    def _spawn(self, rid: int) -> None:
        env = dict(os.environ)
        env.update(self.child_env)
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
        env.update({
            "HOROVOD_RENDEZVOUS_ADDR": "127.0.0.1",
            "HOROVOD_RENDEZVOUS_PORT": str(self.port),
            "HOROVOD_SECRET_KEY": self.server.secret,
            "HOROVOD_SERVE_REPLICA_ID": str(rid),
            "HOROVOD_HOSTNAME": self._host(rid),
        })
        self.procs[rid] = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.serve.replica"],
            env=env)
        self.assigned.setdefault(rid, set())
        self._hb_last[rid] = None
        # The beat a dead predecessor left: a respawn's first beat is
        # the first value after it.
        self._hb_stale[rid] = self.kv.get(f"serve/heartbeat/{rid}")
        self._spawn_ts[rid] = time.time()
        # Start grace of two TTLs: the first beat comes after the
        # model's init, its move to the device and the digest.
        self._hb_deadline[rid] = time.time() + 2 * self.lease_ttl
        logger.info("replica %d spawned (pid %d)", rid,
                    self.procs[rid].pid)

    def _live(self, exclude: Optional[int] = None) -> List[int]:
        return [r for r in sorted(self.members)
                if r != exclude and r not in self._down
                and not self.registry.is_blacklisted(self._host(r))]

    # -- request intake ------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               slo_class: str = "standard") -> int:
        req_id = self._next_req
        self._next_req += 1
        payload = {"prompt": [int(t) for t in prompt],
                   "max_new_tokens": int(max_new_tokens),
                   "slo_class": slo_class}
        self._requests[req_id] = payload
        self._submit_ts[req_id] = time.time()
        live = self._live()
        if not live:
            raise HorovodTpuError("no live serving replicas left")
        rid = live[self._rr % len(live)]
        self._rr += 1
        self._assign(rid, req_id)
        return req_id

    def _assign(self, rid: int, req_id: int) -> None:
        self.assigned.setdefault(rid, set()).add(req_id)
        self.kv.put(f"serve/assign/{rid}/{req_id}",
                    json.dumps(self._requests[req_id]))

    # -- autoscaler signals / actuation edges ---------------------------

    def fleet_size(self) -> int:
        return len(self._live())

    def unfinished_ids(self) -> Set[int]:
        return set(self._requests) - set(self.results) - self._shed

    def outstanding(self) -> int:
        return len(self.unfinished_ids())

    def oldest_unfinished_ts(self) -> Optional[float]:
        ids = self.unfinished_ids()
        if not ids:
            return None
        return min(self._submit_ts[r] for r in ids
                   if r in self._submit_ts)

    def scale_to(self, n: int, drain_timeout: float = 30.0) -> int:
        """Grow or shrink the fleet to ``n`` live replicas without
        stopping the world: joiners spawn fresh ids and pick up the
        config through the KV; retirees (highest ids first) get a
        ``serve/retire`` key, their unfinished work is reassigned to
        survivors, and the processes drain out.  Returns the converged
        live size."""
        if n < 1:
            raise InvalidRequestError(f"fleet size must be >= 1, got {n}")
        while self.fleet_size() < n:
            rid = max(self.procs, default=-1) + 1
            self.members.add(rid)
            self._spawn(rid)
        retire = sorted(self._live(), reverse=True)[:max(
            0, self.fleet_size() - n)]
        for rid in retire:
            self.kv.put(f"serve/retire/{rid}", "1")
            self.members.discard(rid)
            unfinished = {r for r in self.assigned.get(rid, set())
                          if r in self.unfinished_ids()}
            self.assigned[rid] = set()
            live = self._live()
            for i, req_id in enumerate(sorted(unfinished)):
                if not live:
                    raise HorovodTpuError(
                        f"shrink stranded {len(unfinished)} requests: "
                        "no survivors")
                self._assign(live[i % len(live)], req_id)
            proc = self.procs.pop(rid)
            try:
                proc.wait(timeout=drain_timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            logger.info("replica %d retired", rid)
        self.n_replicas = n
        return self.fleet_size()

    def shed(self, n: int,
             tenant_priority: Optional[Dict[str, int]] = None) -> int:
        """Cancel up to ``n`` unfinished requests fleet-wide, lowest-
        priority tenant class first, newest first (the order of
        `ContinuousScheduler.shed`).  Best-effort: a replica that
        already started decoding a canceled request finishes it (its
        result is kept); replicas skip canceled requests they have not
        claimed yet."""
        if n <= 0:
            return 0
        prio = dict(tenant_priority or {"premium": 0, "standard": 1,
                                        "batch": 2})
        worst = max(prio.values(), default=0) + 1
        ids = sorted(
            self.unfinished_ids(),
            key=lambda r: (-prio.get(
                self._requests[r].get("slo_class", "standard"), worst),
                -r))
        out = 0
        for req_id in ids[:n]:
            self.kv.put(f"serve/cancel/{req_id}", "1")
            self._shed.add(req_id)
            out += 1
            logger.info("request %d shed (%s)", req_id,
                        self._requests[req_id].get("slo_class"))
        return out

    def digest_agreement(self, timeout: float = 30.0) -> bool:
        """No-split-brain check: every live member must publish the
        same parameter digest (serve/digest/<rid>).  Replicas rebuild
        from the config seed, so a disagreement means a member serves
        other weights: the one failure a scale event must never commit
        over."""
        deadline = time.time() + timeout
        while True:
            live = self._live()
            digests = {r: self.kv.get(f"serve/digest/{r}") for r in live}
            if all(d is not None for d in digests.values()):
                vals = set(digests.values())
                if len(vals) > 1:
                    logger.error("params digest SPLIT BRAIN: %s",
                                 digests)
                return len(vals) == 1 and bool(live)
            if time.time() > deadline:
                missing = [r for r, d in digests.items() if d is None]
                logger.warning("digest check timed out waiting on "
                               "replicas %s", missing)
                return False
            time.sleep(0.05)

    # -- failure detection / healing -----------------------------------

    def _check_replica(self, rid: int, now: float) -> Optional[str]:
        """A failure reason, or None while the replica is healthy."""
        proc = self.procs[rid]
        code = proc.poll()
        if code is not None:
            return f"exited with code {code}"
        hb = self.kv.get(f"serve/heartbeat/{rid}")
        if hb != self._hb_last[rid] and hb is not None:
            if self._spawn_ts.get(rid) is not None and \
                    hb != self._hb_stale[rid]:
                self.first_beats.append(
                    (rid, now - self._spawn_ts.pop(rid)))
            self._hb_last[rid] = hb
            self._hb_deadline[rid] = now + self.lease_ttl
        elif now > self._hb_deadline[rid]:
            if _met.enabled():
                _met.worker_lease_expired.inc()
            return (f"heartbeat lease expired "
                    f"({self.lease_ttl:.1f}s without a value change)")
        return None

    def _heal(self, rid: int, why: str) -> None:
        logger.warning("replica %d FAILED: %s", rid, why)
        proc = self.procs[rid]
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        self.registry.record_failure(self._host(rid), 0, why)
        unfinished = {r for r in self.assigned.get(rid, set())
                      if r in self.unfinished_ids()}
        self.assigned[rid] = set()
        live = [r for r in self._live(exclude=rid)
                if self.procs[r].poll() is None]
        for i, req_id in enumerate(sorted(unfinished)):
            if not live:
                break
            new_rid = live[i % len(live)]
            logger.info("request %d reassigned: replica %d -> %d",
                        req_id, rid, new_rid)
            self._assign(new_rid, req_id)
            # The respawn claims what is assigned to its id: not this.
            self.kv.delete(f"serve/assign/{rid}/{req_id}")
        if self.registry.is_blacklisted(self._host(rid)):
            logger.warning("replica %d blacklisted — not respawning",
                           rid)
            self._down.add(rid)
            if not live and unfinished:
                raise HorovodTpuError(
                    f"{len(unfinished)} requests stranded: every "
                    f"replica is dead or blacklisted")
            return
        time.sleep(self.respawn_backoff * (2 ** min(self._respawns, 4)))
        self._respawns += 1
        if _met.enabled():
            _met.worker_respawns.inc()
        self._spawn(rid)
        # The respawned replica rebuilds its weights from the seed; with
        # no survivor its old unserved requests go back to it.
        for req_id in sorted(unfinished):
            if not live:
                self._assign(rid, req_id)

    # -- completion ----------------------------------------------------

    def poll_results(self) -> None:
        for key in self.kv.keys("serve/result/"):
            req_id = int(key.rsplit("/", 1)[1])
            if req_id in self.results:
                continue
            val = self.kv.get(key)
            if val is not None:
                self.results[req_id] = json.loads(val)

    def wait_all(self, timeout: float = 120.0) -> Dict[int, List[int]]:
        """Block until every submitted request has a result, healing
        replicas along the way."""
        deadline = time.time() + timeout
        while True:
            now = time.time()
            self.poll_results()
            if not self.unfinished_ids():
                return dict(self.results)
            for rid in sorted(self.members):
                if rid in self._down or rid not in self.procs:
                    continue
                why = self._check_replica(rid, now)
                if why is not None:
                    self._heal(rid, why)
            if now > deadline:
                missing = sorted(self.unfinished_ids())
                raise HorovodTpuError(
                    f"serving timed out after {timeout:.0f}s with "
                    f"requests {missing} unfinished")
            time.sleep(0.05)

    def stop(self) -> None:
        try:
            self.kv.put("serve/stop", "1")
            for proc in self.procs.values():
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        finally:
            self.server.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


# -- the replica worker process ---------------------------------------------

def _sorted_leaves(tree) -> list:
    """The leaves of a parameter tree in the JAX package's flatten order:
    dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _params_digest(params) -> str:
    """sha256 over every parameter leaf's dtype name, shape and bytes,
    leaves in the JAX package's order, as its `_params_digest` hashes
    the same tree in the JAX layout (`transformer_params`): the numpy
    dtype name ("bfloat16" for bf16, whose raw bytes are hashed) and the
    shape as a Python tuple.  `digest_agreement` is one compare."""
    import torch

    h = hashlib.sha256()
    for leaf in _sorted_leaves(params):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            arr = t.numpy()
            name, raw = str(arr.dtype), arr.tobytes()
        h.update(name.encode())
        h.update(str(tuple(int(d) for d in t.shape)).encode())
        h.update(raw)
    return h.hexdigest()


def _build_server(config: Dict):
    """(InferenceServer, the parameters it was built from): the
    `TransformerConfig` of the config's "cfg" (its compute_dtype a
    dtype name), `transformer_init` of its "seed", the server with its
    "serve" dict (the card unless that names a "device")."""
    import torch

    from ..models import TransformerConfig, transformer_init
    from .server import InferenceServer

    kw = dict(config["cfg"])
    kw["compute_dtype"] = getattr(torch, kw.get("compute_dtype",
                                                "float32"))
    cfg = TransformerConfig(**kw)
    params = transformer_init(int(config.get("seed", 0)), cfg)
    return InferenceServer(params, cfg, **config.get("serve", {})), params


def _stats(server, served: int) -> Dict:
    """What a replica records in its timeline when it leaves: the
    requests it finished, the flash kernels' launch counts (K4 at each
    prefill of a long prompt) and the card's peak memory."""
    import torch

    from ..ops import flash_attention as FA

    out = {"served": served, "launches": FA.launch_counts(),
           "sm90": FA.sm90_launch_counts(), "peak_mem_gb": None}
    if server.device.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(
            server.device) / 1e9
    return out


def main() -> None:
    rid = int(os.environ["HOROVOD_SERVE_REPLICA_ID"])
    client = RendezvousClient(
        os.environ["HOROVOD_RENDEZVOUS_ADDR"],
        int(os.environ["HOROVOD_RENDEZVOUS_PORT"]),
        os.environ["HOROVOD_SECRET_KEY"])
    config = json.loads(client.wait("serve/config", 30.0))
    if client.get("serve/stop") or client.get(f"serve/retire/{rid}"):
        return   # retired before it started: no model to build
    # Per-replica timeline: HOROVOD_TIMELINE=/path.json on the manager
    # (or in child_env) gives each replica its own `.rank<rid>` file
    # with pid=rid, so `python -m horovod_tpu_torch.trace merge` lays
    # the replicas' request lanes side by side and stitches a reassigned
    # request's spans across processes.
    tl_base = os.environ.get("HOROVOD_TIMELINE")
    tl = None
    if tl_base:
        from ..utils.timeline import start_timeline
        # A respawned incarnation must not overwrite the dead one's
        # file: its events let the merge stitch a reassigned request.
        tl_path, k = f"{tl_base}.rank{rid}", 0
        while os.path.exists(tl_path):
            k += 1
            tl_path = f"{tl_base}.rank{rid}.respawn{k}"
        tl = start_timeline(tl_path, rank=rid)
    server, params = _build_server(config)
    # Publish the digest before serving: the manager's no-split-brain
    # check compares it across members after every scale event; a
    # respawned incarnation republishes the same one.
    client.put(f"serve/digest/{rid}", _params_digest(params))
    del params
    claimed: Set[str] = set()
    beat = served = 0
    logger.info("replica %d serving (pid %d)", rid, os.getpid())
    while True:
        beat += 1
        client.put(f"serve/heartbeat/{rid}", str(beat))
        if client.get("serve/stop"):
            break
        if client.get(f"serve/retire/{rid}"):
            # Shrink: stop claiming, drain what is active, exit.  The
            # manager has reassigned this replica's unfinished work;
            # what it still finishes here is the same tokens.
            while not server.sched.drained():
                for seq in server.step():
                    client.put(f"serve/result/{seq.req.req_id}",
                               json.dumps(seq.generated))
                    served += 1
            logger.info("replica %d retiring", rid)
            break
        for key in client.keys(f"serve/assign/{rid}/"):
            if key in claimed:
                continue
            req_id = int(key.rsplit("/", 1)[1])
            if client.get(f"serve/cancel/{req_id}"):
                claimed.add(key)     # shed before claim: never decode
                continue
            claimed.add(key)
            payload = json.loads(client.get(key))
            server.submit(payload["prompt"], payload["max_new_tokens"],
                          req_id=req_id,
                          slo_class=payload.get("slo_class",
                                                "standard"))
        # The fault point that kills a replica mid-stream
        # (serve.replica_die@N:exit:1, host-scoped with
        # HOROVOD_FAULT_HOSTS=replicaK).
        _faults.point("serve.replica_die")
        if server.sched.drained():
            time.sleep(0.05)
            continue
        for seq in server.step():
            client.put(f"serve/result/{seq.req.req_id}",
                       json.dumps(seq.generated))
            served += 1
    if tl is not None:
        tl.instant("replica_stats", category="serve",
                   args=_stats(server, served))
        from ..utils.timeline import stop_timeline
        stop_timeline()


if __name__ == "__main__":
    main()


__all__ = ["ReplicaManager", "main"]
