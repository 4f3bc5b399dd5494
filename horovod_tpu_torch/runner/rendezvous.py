"""Rendezvous: an HMAC-authenticated TCP key-value store with barriers
(counterpart of `horovod_tpu/runner/rendezvous.py`).

Reference parity: horovod/runner/http/http_server.py (`RendezvousServer`,
the KV store the Gloo controller rendezvouses against) plus
runner/common/service/network.py's HMAC-signed message envelope.

Role in the port: the process group bootstraps over rank 0's c10d
`TCPStore` (HOROVOD_COORDINATOR_ADDR), so this store carries the rest
of the control plane: `run()`'s results, the Executor's commands, the
collective consistency check, heartbeat leases and the metrics fleet.
The data plane never touches it.

Wire protocol (one request per line, newline-terminated):
    <hmac_sha256_hex(secret, payload)> <base64(payload)>\n
payload = JSON {"op": PUT|GET|WAIT|DEL|KEYS|BARRIER|LEASE|PING|SHUTDOWN,
...}.  Responses use the same envelope.  It is byte for byte the JAX
package's, so a client of either package talks to a server of the
other.  `RendezvousServer(prefer_native=True)` serves with the C++
engine (`horovod_tpu_torch._native`, built with g++ at first use) and,
where it cannot be built or loaded, runs the threaded Python server, as
the JAX package does.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import logging
import secrets as _secrets
import socket
import socketserver
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..common.exceptions import (
    HorovodTpuError,
    RendezvousConnectionError,
)
from .. import faults as _faults
from ..faults import FaultInjected, RetryPolicy

logger = logging.getLogger("horovod_tpu_torch.runner.rendezvous")


def new_secret() -> str:
    """Reference: horovod/runner/common/util/secret.py make_secret_key."""
    return _secrets.token_hex(16)


def _sign(secret: str, payload: bytes) -> str:
    return hmac.new(secret.encode(), payload, hashlib.sha256).hexdigest()


def _json_value(v) -> str:
    """`json.dumps(v)`, with a fast path for a printable ASCII string that
    needs no escape (a reshard chunk's megabytes of base64 text): the same
    text, without the encoder's scan for escapes."""
    if (isinstance(v, str) and v.isascii() and v.isprintable()
            and '"' not in v and "\\" not in v):
        return '"' + v + '"'
    return json.dumps(v, separators=(",", ":"))


def _encode(secret: str, obj: dict) -> bytes:
    """`sig b64(json)\n`, the JSON as `json.dumps(obj, separators=(",",
    ":"))` writes it."""
    payload = ("{" + ",".join(json.dumps(k) + ":" + _json_value(v)
                              for k, v in obj.items()) + "}").encode()
    return b"".join((_sign(secret, payload).encode(), b" ",
                     base64.b64encode(payload), b"\n"))


def _decode(secret: str, line: bytes) -> dict:
    try:
        sig, b64 = line.strip().split(b" ", 1)
        payload = base64.b64decode(b64)
        sig_text = sig.decode()  # non-UTF-8 bytes are "malformed", not fatal
    except Exception as e:
        raise HorovodTpuError(f"Malformed rendezvous message: {e}") from e
    if not hmac.compare_digest(sig_text, _sign(secret, payload)):
        raise HorovodTpuError("Rendezvous message failed HMAC verification")
    return json.loads(payload)


class KVStore:
    """The in-memory store + barrier table (shared by the Python server;
    the C++ engine keeps its own equivalent)."""

    def __init__(self):
        self._data: Dict[str, str] = {}
        self._cv = threading.Condition()
        # barrier name -> (generation, arrived_count)
        self._barriers: Dict[str, Tuple[int, int]] = {}
        # lease name -> monotonic expiry deadline (heartbeat leases:
        # workers renew, barrier waiters fail fast on expiry)
        self._leases: Dict[str, float] = {}

    def put(self, key: str, value: str) -> None:
        with self._cv:
            self._data[key] = value
            self._cv.notify_all()

    def get(self, key: str) -> Optional[str]:
        with self._cv:
            return self._data.get(key)

    def wait(self, key: str, timeout: float) -> Optional[str]:
        # monotonic, not wall clock: an NTP step must not fire timeouts
        # early or extend them (the C++ engine uses steady_clock).
        deadline = time.monotonic() + timeout
        with self._cv:
            while key not in self._data:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(remaining):
                    return None
            return self._data[key]

    def delete(self, key: str) -> bool:
        with self._cv:
            return self._data.pop(key, None) is not None

    def keys(self, prefix: str = "") -> List[str]:
        with self._cv:
            return sorted(k for k in self._data if k.startswith(prefix))

    # -- leases ----------------------------------------------------------
    def renew_lease(self, name: str, ttl: float) -> None:
        """Refresh lease `name` for `ttl` seconds (ttl <= 0 revokes)."""
        with self._cv:
            self._leases[name] = time.monotonic() + ttl
            self._cv.notify_all()

    def lease_expired(self, name: str) -> bool:
        """True only for a lease that was granted and has lapsed.  A name
        never leased reads as NOT expired — barrier participants without
        heartbeats degrade to plain timeout semantics."""
        with self._cv:
            deadline = self._leases.get(name)
            return deadline is not None and deadline <= time.monotonic()

    def _nearest_lease_expiry(self, names) -> Optional[float]:
        """Soonest expiry among known leases in `names` (caller holds
        the cv)."""
        deadlines = [self._leases[n] for n in names if n in self._leases]
        return min(deadlines) if deadlines else None

    def barrier(self, name: str, count: int, timeout: float,
                participants: Optional[List[str]] = None) -> bool:
        """Block until `count` callers reach barrier `name`.  Generation
        counter makes the barrier reusable (successive barriers with the
        same name don't bleed into each other).

        `participants` optionally names the lease of every expected
        participant: if any of those leases expires mid-barrier the wait
        fails promptly (within a lease-check wakeup, not the full
        `timeout`) — a dead worker must not stall the fleet for the
        whole barrier deadline."""
        deadline = time.monotonic() + timeout
        with self._cv:
            if participants:
                for p in participants:
                    if self.lease_expired_locked(p):
                        return False  # known-dead peer: don't even arrive
            gen, arrived = self._barriers.get(name, (0, 0))
            arrived += 1
            my_gen = gen
            if arrived >= count:
                self._barriers[name] = (gen + 1, 0)
                self._cv.notify_all()
                return True
            self._barriers[name] = (gen, arrived)
            while True:
                # Order matters: release check FIRST, so a barrier that
                # completed in the same instant a deadline/lease lapsed
                # still reports success.
                cur_gen, _ = self._barriers.get(name, (0, 0))
                if cur_gen > my_gen:
                    return True
                now = time.monotonic()
                expired = participants and any(
                    self.lease_expired_locked(p) for p in participants)
                if expired or now >= deadline:
                    # A lapsed peer can never arrive — fail fast instead
                    # of waiting out the timeout.  Withdraw our arrival
                    # so a retry with surviving membership starts clean.
                    g, a = self._barriers.get(name, (0, 0))
                    if g == my_gen and a > 0:
                        self._barriers[name] = (g, a - 1)
                    return False
                wait_for = deadline - now
                if participants:
                    nearest = self._nearest_lease_expiry(participants)
                    if nearest is not None:
                        # Wake at the next possible lease expiry (plus a
                        # hair for clock granularity) even if nobody
                        # notifies — that's what makes the failure prompt.
                        wait_for = min(wait_for,
                                       max(nearest - now, 0.0) + 0.01)
                self._cv.wait(wait_for)

    def lease_expired_locked(self, name: str) -> bool:
        """lease_expired for callers already holding the cv."""
        deadline = self._leases.get(name)
        return deadline is not None and deadline <= time.monotonic()


class _LoopbackStore:
    """KVStore-compatible facade over a RendezvousClient (used when the
    store lives in the native server)."""

    def __init__(self, client: "RendezvousClient"):
        self._c = client

    def put(self, key: str, value: str) -> None:
        self._c.put(key, value)

    def get(self, key: str) -> Optional[str]:
        return self._c.get(key)

    def wait(self, key: str, timeout: float) -> Optional[str]:
        try:
            return self._c.wait(key, timeout)
        except HorovodTpuError:
            return None

    def delete(self, key: str) -> bool:
        return self._c.delete(key)

    def keys(self, prefix: str = "") -> List[str]:
        return self._c.keys(prefix)

    def barrier(self, name: str, count: int, timeout: float,
                participants: Optional[List[str]] = None) -> bool:
        try:
            self._c.barrier(name, count, timeout,
                            participants=participants)
            return True
        except HorovodTpuError:
            return False

    def renew_lease(self, name: str, ttl: float) -> bool:
        return self._c.renew_lease(name, ttl)

    def lease_expired(self, name: str) -> bool:
        # The native engine has no lease table (yet): absent lease reads
        # as not-expired, matching KVStore semantics for unknown names.
        return False


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        server: "RendezvousServer" = self.server.owner  # type: ignore
        try:
            for line in self.rfile:
                if not line.strip():
                    continue
                try:
                    req = _decode(server.secret, line)
                except HorovodTpuError as e:
                    self.wfile.write(_encode(server.secret,
                                             {"ok": False, "error": str(e)}))
                    return
                resp = server.handle_request(req)
                self.wfile.write(_encode(server.secret, resp))
                self.wfile.flush()
                if req.get("op") == "SHUTDOWN":
                    return
        except (ConnectionError, BrokenPipeError):
            pass


class _ThreadedTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class RendezvousServer:
    """Control-plane server run by the launcher (reference:
    RendezvousServer in runner/http/http_server.py).

    Uses the C++ engine from `horovod_tpu_torch._native` when available
    (same wire protocol), falling back to the threaded Python server.
    """

    def __init__(self, secret: Optional[str] = None, verbose: int = 0,
                 prefer_native: bool = True):
        self.secret = secret or new_secret()
        self.verbose = verbose
        self.store = KVStore()
        self._server: Optional[_ThreadedTCPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._native = None
        self._port: Optional[int] = None
        self._prefer_native = prefer_native

    # -- request dispatch (shared with tests; mirrors the C++ engine) ----
    def handle_request(self, req: dict) -> dict:
        op = req.get("op")
        if op == "PUT":
            self.store.put(req["key"], req["value"])
            return {"ok": True}
        if op == "GET":
            val = self.store.get(req["key"])
            return {"ok": True, "value": val}
        if op == "WAIT":
            val = self.store.wait(req["key"], float(req.get("timeout", 30)))
            if val is None:
                return {"ok": False, "error": f"timeout waiting {req['key']}"}
            return {"ok": True, "value": val}
        if op == "DEL":
            return {"ok": self.store.delete(req["key"])}
        if op == "KEYS":
            return {"ok": True, "keys": self.store.keys(req.get("prefix", ""))}
        if op == "BARRIER":
            ok = self.store.barrier(req["name"], int(req["count"]),
                                    float(req.get("timeout", 30)),
                                    participants=req.get("participants"))
            return {"ok": ok} if ok else {"ok": False, "error": "barrier timeout"}
        if op == "LEASE":
            self.store.renew_lease(req["name"], float(req.get("ttl", 0)))
            return {"ok": True}
        if op == "PING":
            return {"ok": True, "value": "pong"}
        if op == "SHUTDOWN":
            threading.Thread(target=self.stop, daemon=True).start()
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def start(self, port: int = 0) -> int:
        """Start serving; returns the bound port."""
        if self._prefer_native:
            try:
                from .._native import control_plane as _cp
                self._native = _cp.NativeRendezvousServer(self.secret)
                self._port = self._native.start(port)
                logger.info("native rendezvous server on port %d", self._port)
                return self._port
            except Exception as e:  # fall back to Python implementation
                logger.info("native control plane unavailable (%s); "
                            "using the Python server", e)
                self._native = None
        self._server = _ThreadedTCPServer(("0.0.0.0", port), _Handler)
        self._server.owner = self  # type: ignore
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        logger.info("rendezvous server on port %d", self._port)
        return self._port

    @property
    def port(self) -> Optional[int]:
        return self._port

    def kv(self) -> "KVStore":
        """Store accessor valid for either engine: the in-process store
        for the Python server, a loopback client for the native one
        (whose store lives in C++)."""
        if self._native is not None:
            return _LoopbackStore(
                RendezvousClient("127.0.0.1", self._port, self.secret))
        return self.store

    def stop(self) -> None:
        if self._native is not None:
            self._native.stop()
            self._native = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class RendezvousClient:
    """Worker-side client (reference: runner/http/http_client.py).

    One short-lived connection per request.  Two retry layers, both
    driven by the shared RetryPolicy (faults/retry.py):

      - every request retries the *connection* (the server may not be up
        yet, or mid-restart);
      - idempotent ops (GET/WAIT/KEYS/PING) additionally retry
        transport failures *mid-flight* — re-reading a key is safe.
        Non-idempotent ops (PUT/BARRIER arrival) never re-send: the
        request may already have been delivered and applied.
    """

    def __init__(self, addr: str, port: int, secret: str,
                 connect_retries: int = 3,
                 retry: Optional[RetryPolicy] = None):
        self.addr = addr
        self.port = port
        self.secret = secret
        self.retry = retry or RetryPolicy.from_env(
            "RENDEZVOUS", max_attempts=connect_retries,
            base_delay=0.5, multiplier=2.0, max_delay=5.0, jitter=0.1)
        self.connect_retries = self.retry.max_attempts

    def _connect(self, timeout: float) -> socket.socket:
        _faults.point("rendezvous.connect")
        try:
            return socket.create_connection(
                (self.addr, self.port), timeout=timeout)
        except (ConnectionError, socket.timeout, OSError) as e:
            raise RendezvousConnectionError(
                f"Cannot reach rendezvous server "
                f"{self.addr}:{self.port}: {e}") from e

    def _request_once(self, req: dict, timeout: float) -> dict:
        sock = self.retry.run(
            lambda: self._connect(timeout),
            retry_on=(RendezvousConnectionError, FaultInjected),
            site="rendezvous.connect")
        try:
            with sock:
                sock.sendall(_encode(self.secret, req))
                f = sock.makefile("rb")
                line = f.readline()
                if not line:
                    raise ConnectionError("empty rendezvous response")
                return _decode(self.secret, line)
        except (ConnectionError, socket.timeout, OSError) as e:
            raise RendezvousConnectionError(
                f"Rendezvous request {req.get('op')} to "
                f"{self.addr}:{self.port} failed mid-flight: {e}") from e

    def _request(self, req: dict, timeout: float = 60.0,
                 idempotent: bool = False) -> dict:
        if not idempotent:
            return self._request_once(req, timeout)
        return self.retry.run(
            lambda: self._request_once(req, timeout),
            retry_on=(RendezvousConnectionError,),
            site=f"rendezvous.{req.get('op', '?').lower()}")

    def put(self, key: str, value: str) -> None:
        _faults.point("rendezvous.put")
        resp = self._request({"op": "PUT", "key": key, "value": value})
        if not resp.get("ok"):
            raise HorovodTpuError(resp.get("error", "PUT failed"))

    def get(self, key: str) -> Optional[str]:
        _faults.point("rendezvous.get")
        resp = self._request({"op": "GET", "key": key}, idempotent=True)
        return resp.get("value")

    def wait(self, key: str, timeout: float = 30.0) -> str:
        _faults.point("rendezvous.wait")
        resp = self._request({"op": "WAIT", "key": key, "timeout": timeout},
                             timeout=timeout + 10, idempotent=True)
        if not resp.get("ok"):
            raise HorovodTpuError(resp.get("error", f"WAIT {key} failed"))
        return resp["value"]

    def delete(self, key: str) -> bool:
        _faults.point("rendezvous.delete")
        return bool(self._request({"op": "DEL", "key": key}).get("ok"))

    def keys(self, prefix: str = "") -> List[str]:
        _faults.point("rendezvous.keys")
        return self._request({"op": "KEYS", "prefix": prefix},
                             idempotent=True).get("keys", [])

    def barrier(self, name: str, count: int, timeout: float = 30.0,
                participants: Optional[List[str]] = None) -> None:
        _faults.point("rendezvous.barrier")
        req = {"op": "BARRIER", "name": name, "count": count,
               "timeout": timeout}
        if participants:
            req["participants"] = list(participants)
        resp = self._request(req, timeout=timeout + 10)
        if not resp.get("ok"):
            raise HorovodTpuError(
                resp.get("error", f"barrier {name} failed"))

    def renew_lease(self, name: str, ttl: float) -> bool:
        """Refresh heartbeat lease `name`.  Best-effort: returns False
        instead of raising when the engine doesn't support leases (the
        native C++ server) or the server is unreachable — a missed renew
        must never kill an otherwise-healthy worker."""
        try:
            return bool(
                self._request({"op": "LEASE", "name": name,
                               "ttl": ttl}).get("ok"))
        except HorovodTpuError:
            return False

    def ping(self) -> bool:
        try:
            return self._request({"op": "PING"}).get("value") == "pong"
        except HorovodTpuError:
            return False

    def shutdown_server(self) -> None:
        try:
            self._request({"op": "SHUTDOWN"})
        except HorovodTpuError:
            pass
