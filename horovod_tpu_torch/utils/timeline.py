"""Chrome-trace timeline of the host-side control plane.

Counterpart of `horovod_tpu/utils/timeline.py` (reference:
horovod/common/timeline.cc): `HOROVOD_TIMELINE=/path.json` starts it at
`hvd.init()` (`init_from_env`; `hvd.shutdown()` stops it),
`HOROVOD_TIMELINE_MARK_CYCLES=1` marks step cycles.  Events go to an
in-memory queue on the hot path (no IO) and a writer thread drains it to
a Chrome ``chrome://tracing`` JSON array: the native C++ writer of
`_native/` when its library is built (it is never built inside
`hvd.init()`), else a Python thread; HOROVOD_TIMELINE_DISABLE_NATIVE=1
keeps the Python one.  Both write the same events.
Its callers: every eager collective (`ops/collectives.py _traced`: one
``KIND:name`` activity), the optimizers' step boundary (a cycle mark
and a ``step`` span a step, `parallel/data_parallel.py record_step`;
megastep's one a call), the reduction's ``wire_bucket_k`` /
``fused_bucket_k`` / ``guard_bucket_k`` instants, the serving stack's
request spans (`serve/server.py`: tid ``req/<id>``) and `slo_toggle`
instants, and the profiler's alignment marker.  The device side belongs
to `torch.profiler` (`utils/profiler.py` merges the two).
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import queue
import threading
import time
from typing import Optional

from ..common import util

logger = logging.getLogger("horovod_tpu_torch.timeline")


class _TimelineWriter:
    """Background thread draining event records to a Chrome-trace JSON file.

    Reference: timeline.cc `TimelineWriter` — own thread, lock-free-ish
    handoff.  We use a `queue.Queue`; the hot path only does `put_nowait`.
    """

    _SENTINEL = object()

    def __init__(self, filename: str):
        self.filename = filename
        self._queue: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name="hvd-timeline-writer", daemon=True
        )
        self._healthy = True
        self._thread.start()

    def enqueue(self, record: dict) -> None:
        if self._healthy:
            self._queue.put_nowait(record)

    def _run(self) -> None:
        try:
            with open(self.filename, "w") as f:
                # Chrome trace "JSON Array Format": open bracket, one event
                # per line; readers accept a missing close bracket, so the
                # file is valid even if the process dies mid-run (same
                # property the reference relies on).
                f.write("[\n")
                first = True
                while True:
                    rec = self._queue.get()
                    if rec is _TimelineWriter._SENTINEL:
                        break
                    if not first:
                        f.write(",\n")
                    # default=str: event args may carry numpy or torch scalars.
                    f.write(json.dumps(rec, default=str))
                    first = False
                    # Flush only when the queue drains: under a burst of
                    # events a flush per record turns the writer thread
                    # into one syscall per event (the reference's writer
                    # batches for the same reason); an empty queue means
                    # nobody is waiting, so make the file current then.
                    if self._queue.empty():
                        f.flush()
                f.write("\n]\n")
        except Exception:
            # Mark unhealthy so the hot path stops feeding a dead writer
            # (otherwise the queue grows unboundedly).
            self._healthy = False

    def close(self) -> None:
        if self._thread.is_alive():
            self._queue.put(_TimelineWriter._SENTINEL)
            self._thread.join(timeout=5)


class _NativeWriterAdapter:
    """Routes records into the C++ buffered writer thread
    (`_native/`: TimelineWriter, reference timeline.cc)."""

    def __init__(self, filename: str):
        from .._native import load
        from .._native.control_plane import NativeTimelineWriter
        # Only a built library: this runs inside hvd.init() and must not
        # start a synchronous g++ build.
        if load(build_if_missing=False) is None:
            raise RuntimeError("native library not built")
        self.filename = filename
        self._w = NativeTimelineWriter(filename)

    # Chrome-trace keys the native writer's fixed parameter list covers.
    _KNOWN = frozenset(("name", "cat", "ph", "ts", "dur", "pid", "tid",
                        "s", "args"))

    def enqueue(self, record: dict) -> None:
        args = record.get("args")
        # Other keys ("step", "id" pairing async/flow events) travel as
        # top-level keys through extra_json, as the Python writer keeps
        # them.
        extra = {k: v for k, v in record.items() if k not in self._KNOWN}
        self._w.event(
            name=str(record.get("name", "")),
            cat=str(record.get("cat", "")),
            ph=str(record.get("ph", "i")),
            ts_us=float(record.get("ts", 0.0)),
            dur_us=float(record.get("dur", -1.0)),
            pid=int(record.get("pid", 0)),
            tid=str(record.get("tid", "")),
            scope=str(record.get("s", "")),
            args_json=json.dumps(args, default=str) if args else "",
            extra_json=(json.dumps(extra, default=str)[1:-1]
                        if extra else ""),
        )

    def close(self) -> None:
        self._w.close()


def _make_writer(filename: str):
    """The native C++ writer when it is built, else the Python thread."""
    if not util.env_bool("TIMELINE_DISABLE_NATIVE", False):
        try:
            return _NativeWriterAdapter(filename)
        except Exception as e:  # noqa: BLE001 — native engine optional
            logger.debug("native timeline writer unavailable (%s); "
                         "using the Python writer", e)
    return _TimelineWriter(filename)


class Timeline:
    """Per-process timeline of control-plane activities.

    Chrome-trace mapping: pid = global rank, tid = tensor/activity name.
    Complete events (`ph="X"`) are emitted on activity end so each phase is
    a single record (the reference emits B/E pairs; X halves the volume).
    """

    def __init__(self, filename: str, rank: int = 0,
                 mark_cycles: bool = False):
        self._writer = _make_writer(filename)
        self._rank = rank
        self._mark_cycles = mark_cycles
        # token -> (tensor_name, activity, start_us); tokens are unique per
        # bracket so concurrent unnamed collectives never collide.
        self._starts: dict = {}
        self._next_token = 0
        self._lock = threading.Lock()
        self._cycle = 0
        self._t0 = time.perf_counter()

    # -- clock ------------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def now_us(self) -> float:
        """Timeline-clock timestamp, for `complete()` callers bracketing
        their own spans (e.g. the per-step span in data_parallel)."""
        return self._now_us()

    @property
    def current_cycle(self) -> int:
        """Cycles marked so far (= completed steps when the pipeline marks
        one cycle per step)."""
        return self._cycle

    def _step_stamp(self) -> dict:
        # Stable step ID for the cross-rank merger (horovod_tpu/trace):
        # the number of completed cycles when the event fired.  Emitted as
        # a TOP-LEVEL key — chrome://tracing ignores unknown keys and the
        # writer keeps them as they are — so event `args`
        # stay exactly what the call site passed.
        return {"step": self._cycle} if self._mark_cycles else {}

    # -- per-tensor activities (reference: ActivityStart/ActivityEnd) -----
    def activity_start(self, tensor_name: str, activity: str) -> int:
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._starts[token] = (tensor_name, activity, self._now_us(),
                                   self._cycle)
        return token

    def activity_end(self, token: int,
                     dispatch: Optional[str] = None) -> None:
        """End the span `token` opened; `dispatch="async"` marks a span
        that ends when its collective is dispatched, not completed."""
        now = self._now_us()
        with self._lock:
            entry = self._starts.pop(token, None)
        if entry is None:
            return
        tensor_name, activity, start, cycle = entry
        self._writer.enqueue({
            "name": activity,
            "cat": "collective",
            "ph": "X",
            "ts": round(start, 1),
            "dur": round(now - start, 1),
            "pid": self._rank,
            "tid": tensor_name,
            # Stamp the step the collective STARTED in, so a bracket that
            # straddles a cycle mark stays attributed to its issue step.
            **({"step": cycle} if self._mark_cycles else {}),
            **({"dispatch": dispatch} if dispatch else {}),
        })

    # -- instant events ---------------------------------------------------
    def instant(self, name: str, category: str = "event",
                args: Optional[dict] = None,
                tid: Optional[str] = None) -> None:
        self._writer.enqueue({
            "name": name,
            "cat": category,
            "ph": "i",
            "s": "p",
            "ts": round(self._now_us(), 1),
            "pid": self._rank,
            "tid": tid if tid is not None else category,
            **self._step_stamp(),
            **({"args": args} if args else {}),
        })

    # -- complete spans with caller-held start (trace span model) ---------
    def complete(self, name: str, category: str, start_us: float,
                 args: Optional[dict] = None,
                 tid: Optional[str] = None) -> None:
        """Emit a `ph="X"` span from a caller-captured `now_us()` start to
        now — the per-step host span the fleet tracer's critical-path
        analysis consumes.  `tid` defaults to the category (the training
        step lane); the serve layer overrides it with `req/<id>` so every
        request renders as its own Gantt row (docs/TIMELINE.md)."""
        now = self._now_us()
        self._writer.enqueue({
            "name": name,
            "cat": category,
            "ph": "X",
            "ts": round(start_us, 1),
            "dur": round(now - start_us, 1),
            "pid": self._rank,
            "tid": tid if tid is not None else category,
            **self._step_stamp(),
            **({"args": args} if args else {}),
        })

    # -- cycle marks (reference: HOROVOD_TIMELINE_MARK_CYCLES) ------------
    def mark_cycle(self) -> None:
        if not self._mark_cycles:
            return
        self._cycle += 1
        self.instant(f"CYCLE_{self._cycle}", category="cycle")

    def close(self) -> None:
        self._writer.close()


# ---------------------------------------------------------------------------
# Module-level hooks used by the collectives hot path.  Kept as a plain
# global so the disabled-case check is one attribute load (the reference
# guards every Timeline call on `timeline_enabled_`).
# ---------------------------------------------------------------------------

_timeline: Optional[Timeline] = None


def get_timeline() -> Optional[Timeline]:
    return _timeline


def start_timeline(filename: str, rank: int = 0,
                   mark_cycles: Optional[bool] = None) -> Timeline:
    """Programmatic start (reference: horovod_start_timeline API)."""
    global _timeline
    stop_timeline()
    if mark_cycles is None:
        mark_cycles = util.env_bool("TIMELINE_MARK_CYCLES", False)
    _timeline = Timeline(filename, rank=rank, mark_cycles=mark_cycles)
    return _timeline


def stop_timeline() -> None:
    global _timeline
    if _timeline is not None:
        _timeline.close()
        _timeline = None


# Close the trace (emitting the closing bracket / draining the
# buffer) even when users never call hvd.shutdown(); stop_timeline() is
# idempotent, so the normal shutdown path stays unaffected.
atexit.register(stop_timeline)


def init_from_env(rank: int) -> None:
    """Honor HOROVOD_TIMELINE like the reference (`hvd.init()` calls it,
    and `serve_benchmark`, which runs without `init`).

    Like the reference, only rank 0 writes (timeline.cc gates on rank)
    unless HOROVOD_TIMELINE_ALL_RANKS is set, in which case the filename
    gets a per-rank suffix.
    """
    fname = util.getenv("TIMELINE")
    if not fname:
        return
    all_ranks = util.env_bool("TIMELINE_ALL_RANKS", False)
    if rank != 0 and not all_ranks:
        return
    if all_ranks and rank != 0:
        base, ext = os.path.splitext(fname)
        fname = f"{base}.rank{rank}{ext or '.json'}"
    start_timeline(fname, rank=rank)
