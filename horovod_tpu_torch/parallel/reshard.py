"""Live resharding: move ZeRO shard state between world sizes without a
stop-the-world checkpoint restore.

Counterpart of `horovod_tpu/parallel/reshard.py`.  A membership change
(elastic shrink or grow), a train-to-serve handoff, or a checkpoint
saved at world N and loaded at world M all re-cut 1/N flat shards of
each `shard_group_partition` group into 1/M shards: data movement,
checked bitwise.  Every group's logical flat buffer is cut on a fixed
chunk grid; each old owner publishes only the grid intervals it owns
and each new owner fetches only those overlapping its new range, so no
host ever stages a full buffer: the staging peak stays under
HOROVOD_RESHARD_PEAK_BYTES (chunks are at most a quarter of it) and is
measured (`ReshardReport.peak_bytes`, `hvd_reshard_peak_bytes`).

Stream kinds (one group of L logical elements, its leaves concatenated,
unpadded):

  - ``shard``: parameter rows, f32 master rows, per-element optimizer
    state, the stage-2 accumulator.  Old rank r owns
    ``[r*ceil(L/N), min((r+1)*ceil(L/N), L))``; padding never travels.
  - ``perrank``: the wire policy's sender-side error-feedback rows.
    Every old rank holds a full row, and rows fold
    ``new[j] = sum over r < N, r = j (mod M) of old[r]`` (ascending r,
    f32): the residual is conserved on a shrink, joiners start at zero
    on a grow.  The fetch and the local restack fold in the same order,
    so the live and restore paths stay bitwise equal.
  - ``replicated``: scalars every rank holds alike (Adam's `step`, the
    pass counter): old rank 0 publishes them once.

Integrity: every published interval carries a sha256 of its payload
(`reshard.chunk_corrupt`), every stream an order-free bit-pattern
digest (uint64 sum and xor of the element words) whose per-old-rank
partials must combine to the assembled buffer's, and every participant
publishes a verdict the others wait on, so a dead peer
(`reshard.peer_die`) becomes a `ReshardError` after
HOROVOD_RESHARD_TIMEOUT and the caller falls back to the restore path,
never to corrupt state.

The port's state is placed, not compat: each rank holds only its own
shard of every group (`parallel/optimizer.py`'s local optimizer over one
flat shard per group, `zero3.py`'s (1, shard) rows).  The adapters at
the end (`opt_state_streams`, `streams_to_opt_state`,
`reshard_rank_streams`, ...) turn a `DistributedOptimizer(zero_stage=k)`
into this rank's streams and a fresh one at the new world size back
into the optimizer it would have built, holding the same values.  The
stream core is numpy on both sides, as in the JAX package, so streams
published by one package can be fetched by the other.
"""

from __future__ import annotations

import base64
import hashlib
import json
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from .. import faults as _faults
from ..common import util
from ..common.exceptions import HorovodTpuError, ReshardError
from ..metrics import catalog as _met
from ..ops import wire as _wire

__all__ = [
    "KVTransport", "LocalTransport", "ReshardError", "ReshardPlan",
    "ReshardReport", "StreamSpec", "bitsum_digest", "decode_leaf_slices",
    "default_chunk_bytes", "default_peak_bytes", "fetch_streams",
    "opt_state_streams", "publish_streams", "reshard_ef_rows",
    "reshard_rank_streams", "reshard_replicated_rows",
    "reshard_shard_rows", "reshard_streams", "streams_to_opt_state",
]


# ---------------------------------------------------------------------------
# knobs

def default_peak_bytes() -> int:
    """The per-host staging ceiling: HOROVOD_RESHARD_PEAK_BYTES (64 MiB).
    Chunks are at most a quarter of it (raw slice, encoded payload, its
    base64 text and the decoded copy can be live at once), and the
    executor checks the measured peak against it."""
    return max(4096, util.env_int("RESHARD_PEAK_BYTES", 64 << 20))


def default_chunk_bytes(peak_bytes: Optional[int] = None) -> int:
    """The chunk-grid cell size: HOROVOD_RESHARD_CHUNK_BYTES, else the
    tuner's `reshard_chunk_bytes` (4 MiB without it), clamped to
    peak_bytes // 4."""
    if peak_bytes is None:
        peak_bytes = default_peak_bytes()
    from ..utils.autotune import current_reshard_chunk_bytes
    return max(1, min(current_reshard_chunk_bytes(), peak_bytes // 4))


def default_timeout() -> float:
    """How long a fetch waits for a peer's chunk or verdict before it
    declares the peer dead: HOROVOD_RESHARD_TIMEOUT (60 s)."""
    return util.env_float("RESHARD_TIMEOUT", 60.0)


# ---------------------------------------------------------------------------
# plan

class StreamSpec(NamedTuple):
    """One named flat buffer to redistribute: `elems` is its logical
    (unpadded) length, `kind` its ownership model (module docstring)."""
    name: str
    elems: int
    dtype: str          # numpy dtype name, so that specs are JSON
    kind: str           # "shard" | "perrank" | "replicated"


class Interval(NamedTuple):
    """One published payload: `[start, stop)` of a stream's logical
    buffer, owned by old rank `src` (a grid cell within src's range)."""
    src: int
    start: int
    stop: int


def _shard_sz(elems: int, n: int) -> int:
    return (elems + (-elems) % n) // n if n else 0


def _owned_range(elems: int, n: int, rank: int) -> Tuple[int, int]:
    """A rank's logical (unpadded) range of a shard stream at world n."""
    s = _shard_sz(elems, n)
    return min(rank * s, elems), min((rank + 1) * s, elems)


class ReshardPlan:
    """The movement plan for one (n_old, n_new) pair over a set of
    streams.  Every rank computes the same plan from (specs, n_old,
    n_new, chunk_bytes), so publish and fetch keys agree with no
    negotiation."""

    def __init__(self, specs: List[StreamSpec], n_old: int, n_new: int,
                 chunk_bytes: Optional[int] = None,
                 peak_bytes: Optional[int] = None):
        if n_old < 1 or n_new < 1:
            raise ValueError(
                f"reshard needs n_old >= 1 and n_new >= 1, got "
                f"({n_old}, {n_new})")
        self.specs = list(specs)
        self.n_old = int(n_old)
        self.n_new = int(n_new)
        self.peak_bytes = int(peak_bytes if peak_bytes is not None
                              else default_peak_bytes())
        self.chunk_bytes = int(chunk_bytes if chunk_bytes is not None
                               else default_chunk_bytes(self.peak_bytes))
        self.chunk_bytes = max(1, min(self.chunk_bytes,
                                      self.peak_bytes // 4))

    def _chunk_elems(self, spec: StreamSpec) -> int:
        return max(1, self.chunk_bytes // np.dtype(spec.dtype).itemsize)

    def _grid_cut(self, spec: StreamSpec, start: int,
                  stop: int) -> List[Tuple[int, int]]:
        """`[start, stop)` cut at the stream's chunk-grid boundaries (the
        grid is anchored at 0, so both sides agree)."""
        ce = self._chunk_elems(spec)
        out = []
        a = start
        while a < stop:
            b = min(stop, (a // ce + 1) * ce)
            out.append((a, b))
            a = b
        return out

    def publish_intervals(self, spec: StreamSpec,
                          old_rank: int) -> List[Interval]:
        """The payloads old rank `old_rank` publishes for one stream."""
        if spec.kind == "replicated":
            if old_rank != 0 or spec.elems == 0:
                return []
            return [Interval(0, a, b)
                    for a, b in self._grid_cut(spec, 0, spec.elems)]
        if spec.kind == "perrank":
            return [Interval(old_rank, a, b)
                    for a, b in self._grid_cut(spec, 0, spec.elems)]
        lo, hi = _owned_range(spec.elems, self.n_old, old_rank)
        return [Interval(old_rank, a, b)
                for a, b in self._grid_cut(spec, lo, hi)]

    def fetch_intervals(self, spec: StreamSpec,
                        new_rank: int) -> List[Interval]:
        """The intervals new rank `new_rank` needs for one stream (each
        within one published payload; it slices locally)."""
        if spec.kind == "replicated":
            if spec.elems == 0:
                return []
            return self.publish_intervals(spec, 0)
        if spec.kind == "perrank":
            out = []
            for r in range(new_rank % self.n_new, self.n_old, self.n_new):
                out.extend(Interval(r, a, b)
                           for a, b in self._grid_cut(spec, 0, spec.elems))
            return out
        lo, hi = _owned_range(spec.elems, self.n_new, new_rank)
        out = []
        for r in range(self.n_old):
            olo, ohi = _owned_range(spec.elems, self.n_old, r)
            a, b = max(lo, olo), min(hi, ohi)
            if a < b:
                out.extend(Interval(r, c, d)
                           for c, d in self._grid_cut(spec, a, b))
        return out

    def publish_bytes(self, old_rank: int) -> int:
        """Payload bytes this old rank publishes."""
        return sum((iv.stop - iv.start) * np.dtype(s.dtype).itemsize
                   for s in self.specs
                   for iv in self.publish_intervals(s, old_rank))

    def max_chunk_bytes(self) -> int:
        return max(self._chunk_elems(s) * np.dtype(s.dtype).itemsize
                   for s in self.specs) if self.specs else 0


def _fix_grid_cut_overlap(plan: ReshardPlan, spec: StreamSpec,
                          iv: Interval) -> Interval:
    """The published interval holding fetch interval `iv`: published
    keys are grid cell ∩ old range, while a fetch interval (new range ∩
    old range) may start or stop inside a cell."""
    olo, ohi = (0, spec.elems) if spec.kind != "shard" else \
        _owned_range(spec.elems, plan.n_old, iv.src)
    ce = plan._chunk_elems(spec)
    a = max(olo, (iv.start // ce) * ce)
    b = min(ohi, (iv.start // ce + 1) * ce)
    return Interval(iv.src, a, b)


# ---------------------------------------------------------------------------
# transports

class LocalTransport:
    """In-process key/value transport (tests, bench.py's simulation).
    Same contract as `KVTransport`: string values, a blocking `wait`."""

    def __init__(self):
        self._kv: Dict[str, str] = {}
        self._cv = threading.Condition()

    def put(self, key: str, value: str) -> None:
        with self._cv:
            self._kv[key] = value
            self._cv.notify_all()

    def wait(self, key: str, timeout: float = 30.0) -> str:
        deadline = time.monotonic() + timeout
        with self._cv:
            while key not in self._kv:
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=left):
                    raise ReshardError(
                        f"timed out after {timeout:.1f}s waiting for "
                        f"reshard key {key!r} (peer dead?)")
            return self._kv[key]

    def get(self, key: str) -> Optional[str]:
        with self._cv:
            return self._kv.get(key)

    def delete(self, key: str) -> None:
        with self._cv:
            self._kv.pop(key, None)

    def keys(self, prefix: str = "") -> List[str]:
        with self._cv:
            return [k for k in self._kv if k.startswith(prefix)]


class KVTransport:
    """Transport over the launcher's rendezvous KV
    (`runner.rendezvous.RendezvousClient`), which every rank of a
    `horovodrun_tpu_torch` launch reaches through the
    HOROVOD_RENDEZVOUS_* env (`runner.elastic_worker.client_from_env`).
    Values are base64 text; a WAIT that times out (a dead peer) raises
    `ReshardError`, so that the caller falls back to restore."""

    def __init__(self, client, namespace: str = "reshard"):
        self._c = client
        self._ns = namespace.rstrip("/")

    @classmethod
    def from_env(cls, namespace: str = "reshard") -> "KVTransport":
        """Over the launch's rendezvous KV (raises HorovodTpuError
        outside a launch)."""
        from ..runner.elastic_worker import client_from_env
        return cls(client_from_env(), namespace=namespace)

    def _k(self, key: str) -> str:
        return f"{self._ns}/{key}"

    def put(self, key: str, value: str) -> None:
        self._c.put(self._k(key), value)

    def wait(self, key: str, timeout: float = 30.0) -> str:
        try:
            return self._c.wait(self._k(key), timeout=timeout)
        except HorovodTpuError as e:
            raise ReshardError(
                f"timed out after {timeout:.1f}s waiting for reshard "
                f"key {key!r} (peer dead?): {e}") from e

    def get(self, key: str) -> Optional[str]:
        return self._c.get(self._k(key))

    def delete(self, key: str) -> None:
        self._c.delete(self._k(key))

    def keys(self, prefix: str = "") -> List[str]:
        ns = self._k(prefix)
        return [k[len(self._ns) + 1:] for k in self._c.keys(ns)]


# ---------------------------------------------------------------------------
# integrity

def bitsum_digest(arr: np.ndarray) -> Tuple[int, int]:
    """Order-free exact digest of an array's bit pattern: (sum mod 2^64,
    xor) over each element's word widened to uint64, so the partials of
    disjoint slices combine to the whole buffer's at any element
    boundary, with no rounding order to agree on."""
    a = np.ascontiguousarray(arr).reshape(-1)
    size = a.dtype.itemsize
    if size == 8:
        w = a.view(np.uint64)
    elif size == 4:
        w = a.view(np.uint32).astype(np.uint64)
    elif size == 2:
        w = a.view(np.uint16).astype(np.uint64)
    else:  # bytes, bools and other widths: one word per byte
        w = np.frombuffer(a.tobytes(), np.uint8).astype(np.uint64)
    s = int(np.sum(w, dtype=np.uint64))
    x = int(np.bitwise_xor.reduce(w)) if w.size else 0
    return s & 0xFFFFFFFFFFFFFFFF, x


def _combine_digests(parts: List[Tuple[int, int]]) -> Tuple[int, int]:
    s = 0
    x = 0
    for ps, px in parts:
        s = (s + ps) & 0xFFFFFFFFFFFFFFFF
        x ^= px
    return s, x


class _PeakTracker:
    """Measured peak of the reshard bytes staged on this host (the
    chunks of every worker in flight)."""

    def __init__(self):
        self.cur = 0
        self.peak = 0
        self._lock = threading.Lock()

    def add(self, n: int) -> None:
        with self._lock:
            self.cur += n
            self.peak = max(self.peak, self.cur)

    def sub(self, n: int) -> None:
        with self._lock:
            self.cur = max(0, self.cur - n)


def parallel_workers(peak_bytes: int, chunk_bytes: int) -> int:
    """How many chunks may be in flight at once under a staging ceiling:
    each stages at most a quarter of the ceiling's share (the planner's
    sizing for one), so peak_bytes // (4 * chunk_bytes), 1 to 8."""
    return max(1, min(8, int(peak_bytes) // max(1, 4 * int(chunk_bytes))))


def _windowed(fn, items, plan: "ReshardPlan"):
    """fn over items, results in order, with at most the plan's
    `parallel_workers` calls in flight (each a chunk staged and on the
    wire): the transport's round trips overlap while the staging stays
    under the ceiling.  The assembly is bitwise the JAX package's one
    chunk at a time."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    workers = parallel_workers(plan.peak_bytes, plan.chunk_bytes)
    it = iter(items)
    with ThreadPoolExecutor(workers) as pool:
        pending = collections.deque(
            pool.submit(fn, x) for _, x in zip(range(workers), it))
        while pending:
            out = pending.popleft().result()
            for x in it:
                pending.append(pool.submit(fn, x))
                break
            yield out


def _encode_payload(chunk: np.ndarray, wire: Optional[str],
                    tracker: _PeakTracker) -> str:
    """`sha:wire:base64(payload)` for one interval.  The sha covers the
    wire payload; `reshard.chunk_corrupt`'s err flips a payload byte
    after the sha is taken, a corruption in transit the receiver must
    catch."""
    raw = _wire.host_encode(chunk, wire)
    tracker.add(len(raw))
    sha = hashlib.sha256(raw).hexdigest()[:32]
    try:
        _faults.point("reshard.chunk_corrupt")
    except _faults.FaultInjected:
        flipped = bytearray(raw)
        if flipped:
            flipped[0] ^= 0x40
        raw = bytes(flipped)
    text = base64.b64encode(raw).decode("ascii")
    tracker.sub(len(raw))
    return f"{sha}:{wire or 'none'}:{text}"


def _decode_payload(value: str, dtype, tracker: _PeakTracker) -> np.ndarray:
    sha, wire, text = value.split(":", 2)
    raw = base64.b64decode(text)
    tracker.add(len(raw))
    try:
        if hashlib.sha256(raw).hexdigest()[:32] != sha:
            raise ReshardError(
                "reshard chunk payload failed its sha256 check "
                "(corrupt in transit)")
        return _wire.host_decode(raw, dtype,
                                 None if wire == "none" else wire)
    finally:
        tracker.sub(len(raw))


class ReshardReport(NamedTuple):
    """What one reshard cost on this host."""
    bytes_moved: int     # payload bytes published and fetched here
    peak_bytes: int      # measured peak of staged bytes (<= the ceiling)
    wall_ms: float
    chunks: int          # intervals published and fetched here


# ---------------------------------------------------------------------------
# executor

def _iv_key(stream: str, iv: Interval) -> str:
    return f"{stream}/r{iv.src}/{iv.start}-{iv.stop}"


def publish_streams(plan: ReshardPlan, streams: Dict[str, np.ndarray],
                    old_rank: int, transport, tag: str = "g",
                    wire: Optional[str] = None,
                    tracker: Optional[_PeakTracker] = None
                    ) -> Tuple[int, int]:
    """The send half: this old rank's intervals of every stream (several
    staged payloads at a time, `_windowed`), then its per-stream digest
    partials and its `done` marker.  `streams` maps a spec's name to this
    rank's data: its owned slice ("shard"), its full row ("perrank"), the
    scalar row ("replicated", rank 0 only).  `reshard.peer_die` fires
    once a stream: an injected death aborts mid-publish with chunks
    already out."""
    tracker = tracker or _PeakTracker()
    nbytes = 0
    chunks = 0
    for spec in plan.specs:
        ivs = plan.publish_intervals(spec, old_rank)
        if not ivs:
            continue
        _faults.point("reshard.peer_die")
        arr = np.ascontiguousarray(np.asarray(streams[spec.name]).reshape(-1))
        base = ivs[0].start if spec.kind == "shard" else 0

        def put(iv, arr=arr, base=base, spec=spec):
            chunk = arr[iv.start - base:iv.stop - base]
            if chunk.size != iv.stop - iv.start:
                raise ReshardError(
                    f"stream {spec.name!r}: local data ({arr.size} elems "
                    f"from {base}) does not cover published interval "
                    f"[{iv.start}, {iv.stop})")
            transport.put(f"{tag}/{_iv_key(spec.name, iv)}",
                          _encode_payload(chunk, wire, tracker))
            return bitsum_digest(chunk), chunk.size * chunk.dtype.itemsize

        digest = []
        for d, nb in _windowed(put, ivs, plan):
            digest.append(d)
            nbytes += nb
            chunks += 1
        s, x = _combine_digests(digest)
        transport.put(f"{tag}/digest/{spec.name}/r{old_rank}", f"{s}:{x}")
    transport.put(f"{tag}/done/r{old_rank}", "ok")
    return nbytes, chunks


def _check_failed(plan: ReshardPlan, transport, tag: str) -> None:
    """Raise at once when an old rank already reported a failure (its
    fail marker): its chunks will not come, and waiting for them would
    only burn the timeout."""
    for r in range(plan.n_old):
        fail = transport.get(f"{tag}/fail/r{r}")
        if fail is not None:
            raise ReshardError(f"old rank {r} reported a failure: {fail}")


def fetch_streams(plan: ReshardPlan, new_rank: int, transport,
                  tag: str = "g", timeout: Optional[float] = None,
                  tracker: Optional[_PeakTracker] = None
                  ) -> Tuple[Dict[str, np.ndarray], int, int]:
    """The receive half: fetch (several chunks in flight, `_windowed`),
    verify and assemble this new rank's data of every stream.  Returns
    (streams, bytes, chunks): its owned slice of each "shard" stream,
    the folded row of each "perrank" one, the scalar row of each
    "replicated" one.  Raises `ReshardError` on a peer that reported a failure,
    a missing peer (timeout), a sha mismatch or a stream digest that
    does not combine."""
    timeout = default_timeout() if timeout is None else timeout
    tracker = tracker or _PeakTracker()
    _check_failed(plan, transport, tag)
    out: Dict[str, np.ndarray] = {}
    nbytes = 0
    chunks = 0

    def get(spec, pub, dt):
        return _decode_payload(transport.wait(
            f"{tag}/{_iv_key(spec.name, pub)}", timeout=timeout), dt,
            tracker)

    for spec in plan.specs:
        dt = np.dtype(spec.dtype)
        if spec.kind == "perrank":
            buf = np.zeros((spec.elems,), np.float32)
            srcs = sorted({iv.src
                           for iv in plan.fetch_intervals(spec, new_rank)})
            # Ascending sources: the fold's defined order.
            for r in srcs:
                part = []
                pubs = [Interval(r, a, b)
                        for a, b in plan._grid_cut(spec, 0, spec.elems)]
                for pub, chunk in zip(pubs, _windowed(
                        lambda p, dt=dt, spec=spec: get(spec, p, dt), pubs,
                        plan)):
                    part.append(bitsum_digest(chunk))
                    buf[pub.start:pub.stop] += chunk.astype(np.float32)
                    nbytes += chunk.size * chunk.dtype.itemsize
                    chunks += 1
                _verify_stream_digest(transport, tag, spec, [r], part,
                                      timeout)
            out[spec.name] = buf
            continue
        lo, hi = (0, spec.elems) if spec.kind == "replicated" else \
            _owned_range(spec.elems, plan.n_new, new_rank)
        buf = np.zeros((hi - lo,), dt)
        srcs_seen = set()
        ivs = plan.fetch_intervals(spec, new_rank)
        pubs = [_fix_grid_cut_overlap(plan, spec, iv) for iv in ivs]
        for iv, pub, chunk in zip(ivs, pubs, _windowed(
                lambda p, dt=dt, spec=spec: get(spec, p, dt), pubs, plan)):
            a, b = max(iv.start, lo), min(iv.stop, hi)
            buf[a - lo:b - lo] = chunk[a - pub.start:b - pub.start]
            nbytes += (b - a) * dt.itemsize
            chunks += 1
            srcs_seen.add(pub.src)
        # A stream digest is checkable only where this rank fetched a
        # source's whole extent (a shrink, or a replicated stream);
        # partial fetches rest on the chunks' sha and the guard's
        # cross-replica digest.
        if spec.kind == "replicated":
            _verify_stream_digest(transport, tag, spec, [0],
                                  [bitsum_digest(buf)], timeout)
        else:
            for r in (r for r in sorted(srcs_seen)
                      if _covers(plan, spec, r, lo, hi)):
                olo, ohi = _owned_range(spec.elems, plan.n_old, r)
                _verify_stream_digest(
                    transport, tag, spec, [r],
                    [bitsum_digest(buf[olo - lo:ohi - lo])], timeout)
        out[spec.name] = buf
    return out, nbytes, chunks


def _covers(plan: ReshardPlan, spec: StreamSpec, src: int, lo: int,
            hi: int) -> bool:
    olo, ohi = _owned_range(spec.elems, plan.n_old, src)
    return lo <= olo and ohi <= hi and olo < ohi


def _verify_stream_digest(transport, tag: str, spec: StreamSpec,
                          srcs: List[int], local: List[Tuple[int, int]],
                          timeout: float) -> None:
    parts = []
    for r in srcs:
        v = transport.wait(f"{tag}/digest/{spec.name}/r{r}",
                           timeout=timeout)
        s, x = v.split(":")
        parts.append((int(s), int(x)))
    if _combine_digests(parts) != _combine_digests(local):
        raise ReshardError(
            f"stream {spec.name!r}: assembled bit-pattern digest does not "
            f"match the publishers' partial digests (ranks {srcs}) — "
            "resharded state would be corrupt")


def reshard_streams(specs: List[StreamSpec],
                    streams: Optional[Dict[str, np.ndarray]],
                    n_old: int, n_new: int,
                    old_rank: Optional[int], new_rank: Optional[int],
                    transport, tag: str = "g",
                    chunk_bytes: Optional[int] = None,
                    peak_bytes: Optional[int] = None,
                    timeout: Optional[float] = None,
                    wire: Optional[str] = None,
                    ) -> Tuple[Optional[Dict[str, np.ndarray]],
                               ReshardReport]:
    """One host's whole reshard: publish (as an old owner), fetch (as a
    new owner), then the verdicts: every new rank waits for every old
    rank's `done` and every new rank's `recv_ok` before it trusts the
    result, so one dead or failed peer fails all of them into the
    fallback.  As many chunks are in flight at once as the staging
    ceiling allows (`parallel_workers`).
    Returns (this rank's new streams, or None for a leaving rank; the
    report, whose bytes and chunks count what crossed the transport);
    the measured staging peak is checked against the ceiling."""
    t0 = time.perf_counter()
    plan = ReshardPlan(specs, n_old, n_new, chunk_bytes=chunk_bytes,
                       peak_bytes=peak_bytes)
    timeout = default_timeout() if timeout is None else timeout
    tracker = _PeakTracker()
    nbytes = 0
    chunks = 0
    out = None
    try:
        if old_rank is not None:
            if streams is None:
                raise ValueError("an old owner needs its local streams")
            b, c = publish_streams(
                plan, streams, old_rank, transport, tag=tag, wire=wire,
                tracker=tracker)
            nbytes += b
            chunks += c
        if new_rank is not None:
            out, b, c = fetch_streams(
                plan, new_rank, transport, tag=tag, timeout=timeout,
                tracker=tracker)
            nbytes += b
            chunks += c
            transport.put(f"{tag}/recv_ok/r{new_rank}", "ok")
    except Exception as e:
        # A fail marker, so that live peers fail at once instead of at
        # the timeout (a dead peer writes none: the same outcome later).
        try:
            who = new_rank if new_rank is not None else old_rank
            transport.put(f"{tag}/fail/r{who}", str(e)[:200])
        except Exception:  # noqa: BLE001 — the transport may be gone
            pass
        raise
    if new_rank is not None:
        _await_verdicts(plan, transport, tag, timeout)
    report = ReshardReport(
        bytes_moved=nbytes, peak_bytes=tracker.peak,
        wall_ms=(time.perf_counter() - t0) * 1e3, chunks=chunks)
    if report.peak_bytes > plan.peak_bytes:
        raise ReshardError(
            f"reshard staging peaked at {report.peak_bytes} bytes, over "
            f"the HOROVOD_RESHARD_PEAK_BYTES ceiling {plan.peak_bytes} — "
            "a planner bug, not a transient")
    if _met.enabled():
        _met.reshard_bytes.set(report.bytes_moved)
        _met.reshard_peak_bytes.set(report.peak_bytes)
        _met.reshard_ms.set(report.wall_ms)
    return out, report


def _await_verdicts(plan: ReshardPlan, transport, tag: str,
                    timeout: float) -> None:
    deadline = time.monotonic() + timeout
    _check_failed(plan, transport, tag)
    for r in range(plan.n_old):
        left = max(0.5, deadline - time.monotonic())
        try:
            transport.wait(f"{tag}/done/r{r}", timeout=left)
        except ReshardError:
            fail = transport.get(f"{tag}/fail/r{r}")
            raise ReshardError(
                f"old rank {r} never finished publishing"
                + (f" (reported: {fail})" if fail else " (dead peer?)"))
    for r in range(plan.n_new):
        left = max(0.5, deadline - time.monotonic())
        try:
            transport.wait(f"{tag}/recv_ok/r{r}", timeout=left)
        except ReshardError:
            fail = transport.get(f"{tag}/fail/r{r}")
            raise ReshardError(
                f"new rank {r} did not verify its fetch"
                + (f" (reported: {fail})" if fail else " (dead peer?)"))


def cleanup(transport, tag: str = "g") -> None:
    """Delete a finished (or abandoned) reshard's keys, best effort:
    from the new rank 0 after the verdicts."""
    try:
        for k in transport.keys(f"{tag}/"):
            transport.delete(k)
    except Exception:  # noqa: BLE001 — cleanup is best effort
        pass


# ---------------------------------------------------------------------------
# local restack: the restore path

def reshard_shard_rows(rows: np.ndarray, elems: int,
                       n_new: int) -> np.ndarray:
    """One group's (n_old, shard_old) rows as (n_new, shard_new): concat,
    drop the padding, pad again, cut.  Bitwise."""
    rows = np.asarray(rows)
    flat = rows.reshape(-1)[:elems]
    s = _shard_sz(elems, n_new)
    out = np.zeros((n_new * s,), rows.dtype)
    out[:elems] = flat
    return out.reshape(n_new, s)


def reshard_ef_rows(rows: np.ndarray, elems: int, n_new: int) -> np.ndarray:
    """One group's (n_old, W_old) error-feedback rows folded to
    (n_new, W_new): `new[j] = sum over r = j (mod n_new) of old[r]` on
    the logical extent (ascending r, f32: the fetch's order), zeros
    beyond."""
    rows = np.asarray(rows, np.float32)
    n_old = rows.shape[0]
    w_new = elems + (-elems) % n_new
    out = np.zeros((n_new, w_new), np.float32)
    for r in range(n_old):
        out[r % n_new, :elems] += rows[r, :elems]
    return out


def reshard_replicated_rows(rows: np.ndarray, n_new: int) -> np.ndarray:
    """A rank-stacked (n_old, ...) scalar as (n_new, ...): the rows must
    be equal (checked), and row 0 is tiled."""
    rows = np.asarray(rows)
    if rows.shape[0] > 1 and not all(
            np.array_equal(rows[0], rows[r]) for r in range(1, rows.shape[0])):
        raise ReshardError(
            "rank-stacked scalar optimizer leaf has diverged rows — "
            "cannot reshard a replicated stream that is not replicated")
    return np.broadcast_to(rows[0], (n_new,) + rows.shape[1:]).copy()


def merge_rank_streams(specs: List[StreamSpec],
                       per_rank: List[Dict[str, np.ndarray]],
                       n: int) -> Dict[str, np.ndarray]:
    """Every rank's data of a world of n (fetched streams, or
    `opt_state_streams` of each rank) merged into whole buffers: "shard"
    → the (elems,) logical buffer, "perrank" → the (n, elems) rows,
    "replicated" → rank 0's row.  The one place a whole buffer exists
    (a checkpoint, the local restack); the transport never holds more
    than a chunk."""
    out: Dict[str, np.ndarray] = {}
    for spec in specs:
        if spec.kind == "replicated":
            out[spec.name] = np.asarray(per_rank[0][spec.name])
            continue
        if spec.kind == "perrank":
            out[spec.name] = np.stack(
                [np.asarray(per_rank[r][spec.name]) for r in range(n)])
            continue
        buf = np.zeros((spec.elems,), np.dtype(spec.dtype))
        for r in range(n):
            lo, hi = _owned_range(spec.elems, n, r)
            buf[lo:hi] = np.asarray(per_rank[r][spec.name])[:hi - lo]
        out[spec.name] = buf
    return out


def rank_streams_from_merged(specs: List[StreamSpec],
                             merged: Dict[str, np.ndarray], n_new: int,
                             new_rank: int) -> Dict[str, np.ndarray]:
    """New rank `new_rank`'s data of every stream, cut from whole buffers
    (`merge_rank_streams` of the old world): what the transport would
    deliver it, the error-feedback rows folded in the fetch's order."""
    out: Dict[str, np.ndarray] = {}
    for spec in specs:
        m = np.asarray(merged[spec.name])
        if spec.kind == "replicated":
            out[spec.name] = m.copy()
        elif spec.kind == "perrank":
            buf = np.zeros((spec.elems,), np.float32)
            for r in range(new_rank % n_new, m.shape[0], n_new):
                buf += m[r, :spec.elems].astype(np.float32)
            out[spec.name] = buf
        else:
            lo, hi = _owned_range(spec.elems, n_new, new_rank)
            out[spec.name] = m[lo:hi].copy()
    return out


def reshard_rank_streams(specs: List[StreamSpec],
                         per_old: List[Dict[str, np.ndarray]],
                         n_new: int) -> List[Dict[str, np.ndarray]]:
    """The local restack of the port's placed state: every old rank's
    data (`opt_state_streams` / `param_streams` of each) as every new
    rank's, bitwise what `reshard_streams` would deliver.  The
    counterpart of the JAX package's `reshard_opt_state` on compat
    stacks."""
    merged = merge_rank_streams(specs, per_old, len(per_old))
    return [rank_streams_from_merged(specs, merged, n_new, j)
            for j in range(n_new)]


# ---------------------------------------------------------------------------
# the port's ZeRO layout <-> streams

def _np(t) -> np.ndarray:
    """A tensor (or array) as a host numpy array (a copy of a tensor)."""
    if hasattr(t, "detach"):
        import torch
        if t.dtype == torch.bfloat16:
            raise HorovodTpuError(
                "a bfloat16 ZeRO state tensor has no numpy form for the "
                "reshard transport; keep the parameters and the optimizer "
                "state in f32 (compute in bf16)")
        return t.detach().to("cpu", copy=True).numpy()
    return np.asarray(t)


def _torch_of(arr: np.ndarray, like_dtype, device):
    import torch
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        device=device, dtype=like_dtype)


def _sharded(optimizer):
    """The `_ShardedOptimizer` behind `optimizer` (what
    `DistributedOptimizer(zero_stage>=1)` returns)."""
    from .optimizer import _ShardedOptimizer
    if not isinstance(optimizer, _ShardedOptimizer):
        raise HorovodTpuError(
            "live resharding needs a DistributedOptimizer(zero_stage=1..3) "
            f"(got {type(optimizer).__name__})")
    return optimizer


def opt_state_streams(optimizer, rows=None
                      ) -> Tuple[List[StreamSpec], Dict[str, np.ndarray]]:
    """This rank's ZeRO state as streams (the counterpart of the JAX
    package's `opt_state_streams` over compat stacks): the local
    optimizer's per-element tensors of group g as "shard" streams
    `o{g}.{key}` and its scalars (Adam's `step`) as "replicated" ones,
    the f32 masters of an allgather wire `m{g}`, the stage-2 accumulator
    `a{g}` ("shard"), the error-feedback rows `e{g}` ("perrank"), the
    pass counter `c` ("replicated"), and, given the stage-3 placement's
    rows, the parameter rows `p{g}` ("shard").  `shard` slices drop the
    padding; every rank carries the replicated scalars (only old rank 0's
    are published), so that its own data restores it.  Inverse:
    `streams_to_opt_state`."""
    opt = _sharded(optimizer)
    n, rank = opt.n, opt.rank
    specs: List[StreamSpec] = []
    data: Dict[str, np.ndarray] = {}

    def _shard(name, t, elems):
        lo, hi = _owned_range(elems, n, rank)
        a = _np(t).reshape(-1)
        specs.append(StreamSpec(name, elems, str(a.dtype), "shard"))
        data[name] = a[:hi - lo]

    def _replicated(name, a):
        a = np.asarray(a).reshape(1)
        specs.append(StreamSpec(name, 1, str(a.dtype), "replicated"))
        data[name] = a.copy()

    for gi, (g, sh) in enumerate(zip(opt._groups, opt._shards)):
        elems = sum(g.sizes)
        st = opt._local.state.get(sh, {})
        for key in sorted(st):
            v = st[key]
            if not hasattr(v, "numel"):
                continue
            if v.numel() == g.shard_sz and v.dim() >= 1:
                _shard(f"o{gi}.{key}", v, elems)
            elif v.numel() == 1:
                _replicated(f"o{gi}.{key}", _np(v))
            else:
                raise HorovodTpuError(
                    f"optimizer state {key!r} of group {gi} has "
                    f"{v.numel()} elements, neither the shard's "
                    f"{g.shard_sz} nor a scalar")
        if opt.allgather_wire and opt._masters_ready:
            _shard(f"m{gi}", sh, elems)
        if opt._accum is not None:
            _shard(f"a{gi}", opt._accum[gi], elems)
        if opt._ef_rows[gi] is not None:
            specs.append(StreamSpec(f"e{gi}", elems, "float32", "perrank"))
            data[f"e{gi}"] = _np(opt._ef_rows[gi]).reshape(-1)[:elems]
    _replicated("c", np.asarray(opt._pass_count, np.int64))
    if rows is not None:
        ps, pd = param_streams(rows, [sum(g.sizes) for g in opt._groups],
                               n, rank)
        specs += ps
        data.update(pd)
    return specs, data


def streams_to_opt_state(optimizer, specs: List[StreamSpec],
                         streams: Dict[str, np.ndarray]):
    """Install this rank's streams (fetched, or cut by
    `rank_streams_from_merged`) into `optimizer`, a
    `DistributedOptimizer(zero_stage=k)` built at the new world size
    (fresh, or to be overwritten): it then holds what that optimizer at
    that size would hold after the old one's steps.  Returns the stage-3
    placement's (1, shard) rows when the streams carry `p{g}`, else
    None."""
    import torch

    opt = _sharded(optimizer)
    n, rank = opt.n, opt.rank
    by_name = {s.name: s for s in specs}
    missing = [s.name for s in specs if s.name not in streams]
    if missing:
        raise HorovodTpuError(f"missing fetched streams {missing[:4]}")
    group = opt._local.param_groups[0]
    on_device = bool(group.get("capturable") or group.get("fused"))
    for gi, (g, sh) in enumerate(zip(opt._groups, opt._shards)):
        elems = sum(g.sizes)
        lo, hi = _owned_range(elems, n, rank)
        dev = sh.device

        def _row(name, dtype):
            spec = by_name[name]
            if spec.elems != elems:
                raise HorovodTpuError(
                    f"stream {name!r} holds {spec.elems} elements, group "
                    f"{gi} {elems}: the shard-group partition drifted")
            t = torch.zeros(g.shard_sz, dtype=dtype, device=dev)
            t[:hi - lo] = _torch_of(streams[name], dtype, dev)
            return t

        state = {}
        prefix = f"o{gi}."
        for spec in specs:
            if not spec.name.startswith(prefix):
                continue
            key = spec.name[len(prefix):]
            dt = torch.from_numpy(np.zeros(0, spec.dtype)).dtype
            if spec.kind == "shard":
                state[key] = _row(spec.name, dt)
            else:
                state[key] = torch.tensor(
                    streams[spec.name].reshape(()).item(), dtype=dt,
                    device=dev if on_device else "cpu")
        opt._local.state.pop(sh, None)
        if state:
            opt._local.state[sh] = state
        if f"m{gi}" in by_name:
            sh.untyped_storage().resize_(sh.numel() * sh.element_size())
            sh.copy_(_row(f"m{gi}", sh.dtype))
            opt._masters_ready = True
        if opt._accum is not None:
            opt._accum[gi].copy_(_row(f"a{gi}", opt._accum[gi].dtype)
                                 if f"a{gi}" in by_name else
                                 torch.zeros_like(opt._accum[gi]))
        if opt._ef_rows[gi] is not None:
            row = torch.zeros(g.padded, dtype=torch.float32, device=dev)
            if f"e{gi}" in by_name:
                row[:elems] = _torch_of(streams[f"e{gi}"], torch.float32,
                                        dev)
            opt._ef_rows[gi] = row
    opt._ef_gen = _wire.error_feedback_generation()
    if "c" in streams:
        opt._pass_count = int(np.asarray(streams["c"]).reshape(-1)[0])
    if not any(s.name.startswith("p") for s in specs):
        return None
    dtypes = [np.dtype(by_name[f"p{gi}"].dtype)
              for gi in range(len(opt._groups))]
    return streams_to_param_rows(
        streams, tuple(sum(g.sizes) for g in opt._groups), dtypes, n, rank,
        device=opt._shards[0].device)


def param_streams(rows, group_elems, n_old: int, old_rank: int
                  ) -> Tuple[List[StreamSpec], Dict[str, np.ndarray]]:
    """Stage-3 parameter rows (the placement's (1, shard) rows, or
    (n_old, shard) stacks) as "shard" streams `p{g}`."""
    specs = []
    data = {}
    for gi, (r, elems) in enumerate(zip(rows, group_elems)):
        a = _np(r)
        row = a[old_rank] if a.ndim == 2 and a.shape[0] == n_old \
            else a.reshape(-1)
        lo, hi = _owned_range(elems, n_old, old_rank)
        specs.append(StreamSpec(f"p{gi}", int(elems), str(row.dtype),
                                "shard"))
        data[f"p{gi}"] = row.reshape(-1)[:hi - lo]
    return specs, data


def streams_to_param_rows(streams: Dict[str, np.ndarray], group_elems,
                          dtypes, n_new: int, new_rank: int, device="cpu"):
    """Fetched `p{g}` streams as this rank's stage-3 rows: one (1,
    shard_new) tensor per group, the padding zero (the placement's
    layout; the JAX package returns (n_new, shard) compat stacks with
    only this rank's row filled)."""
    import torch

    out = []
    for gi, (elems, dt) in enumerate(zip(group_elems, dtypes)):
        s = _shard_sz(elems, n_new)
        lo, hi = _owned_range(elems, n_new, new_rank)
        row = np.zeros((1, s), np.dtype(dt))
        row[0, :hi - lo] = streams[f"p{gi}"]
        out.append(torch.from_numpy(row).to(device))
    return tuple(out)


# ---------------------------------------------------------------------------
# decode handoff helpers (serve/handoff.py's primitives)

def _leaf_flat_intervals(shape: Tuple[int, ...], axis, tp: int,
                         tp_rank: int) -> List[Tuple[int, int, int]]:
    """(leaf-flat start, stop, destination offset) covering tp rank
    `tp_rank`'s slice of `axis` in row-major order: one interval when
    axis 0 is split, `prod(shape[:axis])` strided ones otherwise."""
    if axis is None:
        total = int(np.prod(shape, dtype=int)) if shape else 1
        return [(0, total, 0)]
    d = shape[axis]
    if d % tp:
        raise HorovodTpuError(
            f"decode handoff: axis {axis} of {shape} does not divide "
            f"tp={tp}")
    per = d // tp
    inner = int(np.prod(shape[axis + 1:], dtype=int))
    outer = int(np.prod(shape[:axis], dtype=int))
    run = per * inner
    out = []
    for o in range(outer):
        start = o * d * inner + tp_rank * run
        out.append((start, start + run, o * run))
    return out


def leaf_runs(leaf_meta, groups, tp: int, tp_rank: int):
    """(leaf, group, group-logical start, stop, destination offset) of
    every run `decode_leaf_slices` reads, in its order."""
    offsets = {}
    for gi, (idxs, sizes) in enumerate(groups):
        off = 0
        for i, sz in zip(idxs, sizes):
            offsets[i] = (gi, off)
            off += sz
    for li, (shape, _, axis) in enumerate(leaf_meta):
        gi, base = offsets[li]
        for start, stop, dest in _leaf_flat_intervals(tuple(shape), axis,
                                                      tp, tp_rank):
            yield li, gi, base + start, base + stop, dest


def decode_leaf_slices(leaf_meta, groups, streams_fetch: Callable,
                       tp: int, tp_rank: int):
    """Each decode leaf's tp slice, assembled from group-logical
    intervals.  `leaf_meta`: [(shape, dtype, tp_axis or None)] in leaf
    order; `groups`: [(idxs, sizes)] per shard group (the training
    partition); `streams_fetch(g, start, stop)` returns `[start, stop)`
    of group g's logical parameter buffer.  No host builds a whole leaf
    it needs 1/tp of."""
    leaves = []
    for shape, dt, axis in leaf_meta:
        out_shape = list(shape)
        if axis is not None:
            out_shape[axis] = shape[axis] // tp
        leaves.append(np.zeros(out_shape, np.dtype(dt)))
    for li, gi, start, stop, dest in leaf_runs(leaf_meta, groups, tp,
                                               tp_rank):
        flat = leaves[li].reshape(-1)
        flat[dest:dest + (stop - start)] = streams_fetch(
            gi, start, stop).astype(flat.dtype)
    return leaves


def _slice_payloads(plan: ReshardPlan, spec: StreamSpec, tag: str,
                    start: int, stop: int):
    """(c, d, published interval, its key) of each payload piece that
    covers `[start, stop)` of one "shard" stream, in order."""
    for r in range(plan.n_old):
        olo, ohi = _owned_range(spec.elems, plan.n_old, r)
        a, b = max(start, olo), min(stop, ohi)
        if a >= b:
            continue
        for c, d in plan._grid_cut(spec, a, b):
            pub = _fix_grid_cut_overlap(plan, spec, Interval(r, c, d))
            yield c, d, pub, f"{tag}/{_iv_key(spec.name, pub)}"


def fetch_group_slice(plan: ReshardPlan, spec: StreamSpec, transport,
                      tag: str, start: int, stop: int,
                      timeout: Optional[float] = None,
                      tracker: Optional[_PeakTracker] = None,
                      payloads: Optional["PayloadReader"] = None
                      ) -> np.ndarray:
    """Any logical `[start, stop)` of one "shard" stream, from the old
    owners that published it, one payload staged at a time: the fetch
    behind `decode_leaf_slices`.  `payloads` reads them instead (ahead,
    in the order of a known sequence of slices)."""
    timeout = default_timeout() if timeout is None else timeout
    tracker = tracker or _PeakTracker()
    dt = np.dtype(spec.dtype)
    out = np.zeros((stop - start,), dt)
    for c, d, pub, key in _slice_payloads(plan, spec, tag, start, stop):
        chunk = (payloads(key) if payloads is not None else
                 _decode_payload(transport.wait(key, timeout=timeout), dt,
                                 tracker))
        out[c - start:d - start] = chunk[c - pub.start:d - pub.start]
    return out


class PayloadReader:
    """The payloads a known sequence of slice fetches (`(spec, start,
    stop)`, in order) reads, fetched and decoded ahead by the plan's
    `parallel_workers` threads (`_windowed`): each payload is read
    once for each run of consecutive slices that need it, the staged
    ones counted in the tracker's peak.  Call with the key of the
    payload a slice needs next; `close()` when done."""

    def __init__(self, plan: ReshardPlan, transport, tag: str, slices,
                 timeout: float, tracker: _PeakTracker):
        order = []
        for spec, start, stop in slices:
            for _, _, _, key in _slice_payloads(plan, spec, tag, start,
                                                 stop):
                if not order or order[-1][0] != key:
                    order.append((key, np.dtype(spec.dtype)))
        self._tracker = tracker

        def load(item):
            key, dt = item
            chunk = _decode_payload(transport.wait(key, timeout=timeout),
                                    dt, tracker)
            tracker.add(chunk.nbytes)
            return key, chunk

        self._ahead = _windowed(load, order, plan)
        self._key, self._chunk = None, None

    def __call__(self, key: str) -> np.ndarray:
        if key != self._key:
            if self._chunk is not None:
                self._tracker.sub(self._chunk.nbytes)
            self._key, self._chunk = next(self._ahead)
            if self._key != key:
                raise HorovodTpuError(
                    f"reshard read {self._key!r} where a slice needs "
                    f"{key!r}: the slices differ from those announced")
        return self._chunk

    def close(self) -> None:
        self._ahead.close()


def plan_meta_json(specs: List[StreamSpec], n_old: int) -> str:
    """(specs, n_old) as deterministic JSON: the publish side writes it
    under `{tag}/meta`, so that a fetch side absent at publish time (a
    joiner, a serving host) builds the same plan."""
    return json.dumps({"n_old": n_old, "specs": [list(s) for s in specs]},
                      sort_keys=True, separators=(",", ":"))


def plan_meta_parse(text: str) -> Tuple[List[StreamSpec], int]:
    d = json.loads(text)
    return [StreamSpec(*s) for s in d["specs"]], int(d["n_old"])


def check_plan_drift(specs: List[StreamSpec], group_elems) -> None:
    """Raise when a published plan's parameter streams `p{g}` do not
    match the fetch side's shard-group geometry `group_elems` (a
    partition that drifted between publisher and fetcher); the handoff's
    check before any fetch."""
    have = {s.name: s.elems for s in specs if s.name.startswith("p")}
    want = {f"p{gi}": int(e) for gi, e in enumerate(group_elems)}
    if have != want:
        raise HorovodTpuError(
            f"reshard plan drift: published parameter streams {have} do "
            f"not match this side's shard groups {want}")
