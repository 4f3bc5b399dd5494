"""Device-trace capture and the merged host + device timeline.

Counterpart of `horovod_tpu/utils/profiler.py`.  The merged view is
assembled from two captures over the same steps:

  - the control-plane timeline (`utils/timeline.py`, HOROVOD_TIMELINE):
    collectives, cycle marks, step spans, bucket instants;
  - a `torch.profiler` trace of the host and the card (CPU and CUDA
    activities), exported as Chrome-trace JSON.

`start_device_trace(logdir)` starts the profiler and stamps the
alignment marker TRACE_START_MARKER into both: a `record_function`
range in the torch trace, then an instant in the timeline.
`stop_device_trace()` stops it and writes `<host>_<pid>.pt.trace.json`
into the logdir.  `merge_traces` shifts the timeline's events onto the
torch trace's clock so that the two markers coincide (Kineto's clock
does not start at 0), offsets the timeline's pids and writes ONE
Chrome-trace JSON that chrome://tracing and Perfetto load.  A device
trace with no marker of its own (the JAX package's, from
`jax.profiler`, which starts its clock at the trace's start) falls back
to the JAX rule: the timeline's marker lands at t = 0.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import socket
import time
from typing import Optional

from . import timeline as _tl

#: The event name used to align the two clocks.
TRACE_START_MARKER = "PROFILER_TRACE_START"

# Host pids are offset so they never collide with the device trace's
# process ids in the merged view.
HOST_PID_OFFSET = 100000

_active = None  # (torch.profiler.profile, logdir) while a trace runs


def start_device_trace(logdir: str) -> None:
    """Start a `torch.profiler` trace (the CPU, and the card when there
    is one) and stamp the alignment marker into it and into the
    timeline (if one is active)."""
    global _active
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if _active is not None:
        raise RuntimeError("a device trace is already running")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _active = (prof, logdir)
    with record_function(TRACE_START_MARKER):
        pass
    tl = _tl.get_timeline()
    if tl is not None:
        tl.instant(TRACE_START_MARKER, category="profiler",
                   args={"logdir": logdir, "wall": time.time()})


def stop_device_trace() -> str:
    """Stop the trace and export it into its logdir; returns the file."""
    global _active
    if _active is None:
        raise RuntimeError("no device trace is running")
    prof, logdir = _active
    _active = None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def _load_timeline_events(timeline_json: str) -> list:
    with open(timeline_json) as f:
        text = f.read()
    # The writer's array may lack the closing bracket if the process
    # died mid-run (valid for the Chrome trace reader; tolerate it too).
    text = text.strip()
    if text.endswith(","):
        text = text[:-1]
    if not text.endswith("]"):
        text += "]"
    return json.loads(text)


def _find_device_trace(profile_logdir: str) -> Optional[str]:
    """The newest device trace under a logdir: `torch.profiler`'s
    `*.pt.trace.json[.gz]`, or a `jax.profiler` logdir's
    `plugins/profile/<run>/<host>.trace.json.gz`."""
    pats = [
        os.path.join(profile_logdir, "plugins", "profile", "*",
                     "*.trace.json.gz"),
        os.path.join(profile_logdir, "**", "*.trace.json.gz"),
        os.path.join(profile_logdir, "**", "*.pt.trace.json"),
    ]
    hits: list = []
    for p in pats:
        hits.extend(glob.glob(p, recursive=True))
        if hits:
            break
    return max(hits, key=os.path.getmtime) if hits else None


def merge_traces(timeline_json: str, device_trace: str,
                 out_path: str) -> dict:
    """Merge the control-plane timeline with a device trace into one
    Chrome-trace JSON.

    `device_trace` is a trace file (`.json` or `.json.gz`) or a logdir
    (searched for the newest trace).  The timeline's events are shifted
    by (the device trace's TRACE_START_MARKER ts - the timeline's), so
    the two markers coincide; without a device-side marker, by minus the
    timeline's marker ts (the JAX rule: the marker at t = 0).  Host pids
    are offset and labeled via process_name metadata.  Returns summary
    stats."""
    if os.path.isdir(device_trace):
        found = _find_device_trace(device_trace)
        if found is None:
            raise FileNotFoundError(
                f"no *.trace.json[.gz] under {device_trace}; pass the "
                "trace file directly")
        device_trace = found

    opener = gzip.open if device_trace.endswith(".gz") else open
    with opener(device_trace, "rt") as f:
        dev = json.load(f)
    dev_events = dev.get("traceEvents", dev if isinstance(dev, list) else [])

    host_events = _load_timeline_events(timeline_json)
    marker_ts = None
    for ev in host_events:
        if ev.get("name") == TRACE_START_MARKER:
            marker_ts = float(ev.get("ts", 0.0))
            break
    dev_marker = None
    for ev in dev_events:
        if ev.get("name") == TRACE_START_MARKER and "ts" in ev:
            dev_marker = float(ev["ts"])
            break
    shift = 0.0
    if marker_ts is not None:
        shift = (dev_marker if dev_marker is not None else 0.0) - marker_ts

    merged = list(dev_events)
    host_pids = set()
    for ev in host_events:
        ev = dict(ev)
        ev["ts"] = round(float(ev.get("ts", 0.0)) + shift, 1)
        ev["pid"] = HOST_PID_OFFSET + int(ev.get("pid", 0))
        host_pids.add(ev["pid"])
        merged.append(ev)
    for pid in sorted(host_pids):
        merged.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name":
                     f"horovod control plane (rank {pid - HOST_PID_OFFSET})"},
        })

    with open(out_path, "w") as f:
        json.dump({"traceEvents": merged}, f, default=str)
    return {
        "device_events": len(dev_events),
        "host_events": len(host_events),
        "aligned": marker_ts is not None,
        "out": out_path,
    }


__all__ = ["HOST_PID_OFFSET", "TRACE_START_MARKER", "merge_traces",
           "start_device_trace", "stop_device_trace"]
