"""Cross-rank fleet-trace merge + critical-path / straggler analysis.

Counterpart of `horovod_tpu/trace/core.py` (copied: pure stdlib).

The per-rank control-plane timelines (utils/timeline.py, HOROVOD_TIMELINE
with HOROVOD_TIMELINE_ALL_RANKS=1 + HOROVOD_TIMELINE_MARK_CYCLES=1) are
forensic but blind to each other: each rank's clock is its own
`perf_counter` origin, so raw wall clocks cannot say whether a slow
collective was wire time or wait-for-straggler skew.  This module turns
them into one attributed story:

  - `merge`   — one Perfetto/chrome://tracing JSON, ranks clock-aligned
    on the per-step barrier (the CYCLE_n instants every rank emits at
    the same logical point), with flow events linking the same
    collective across ranks.
  - `analyze` — per-step critical path, cross-rank barrier skew, and a
    per-bucket decomposition of collective time into straggler-wait
    (skew between the last-arriving rank and the rest) vs wire, naming
    the blamed rank.

Attribution semantics:

  - skew_ms(step n)      = max_r ts(CYCLE_n) - min_r ts(CYCLE_n)
  - critical_path_ms(n)  = max_r ts(CYCLE_n) - min_r ts(CYCLE_{n-1})
  - per collective bucket observed on >= 2 ranks in the same step:
      wait_ms = max_r start - min_r start   (straggler wait)
      wire_ms = max_r end   - max_r start   (transfer after last arrival)
      blamed  = the last-arriving rank
    except where the data plane dispatches buckets asynchronously: a
    bucket whose first start comes before the previous bucket's last
    start (in start order) was dispatched while the earliest rank still
    waited for the previous one, so its start skew holds the lag the
    previous bucket already counted, and only what it adds counts:
      wait_ms = max(0, skew - previous bucket's skew)
    Synchronous buckets (the JAX package's, whose `analyze` has only
    the plain rule) never overlap so, and read the same under both.
  - compute_ms(n) = critical_path_ms(n) - wait - wire, clamped at 0.

Pure stdlib ON PURPOSE: the offline CLI (`python -m
horovod_tpu_torch.trace`) analyzes rank files on any host, with no
torch needed beyond the package import.
"""

from __future__ import annotations

import json
import os
import re
import statistics
from typing import Dict, List, Optional, Sequence, Union

__all__ = ["load_events", "load_rank_traces", "cycle_arrivals",
           "clock_offsets", "merge", "write_merged", "analyze",
           "analyze_serve", "flightrec_to_trace", "load_flightrec"]

_CYCLE_RE = re.compile(r"^CYCLE_(\d+)$")
_RANK_FILE_RE = re.compile(r"\.rank(\d+)\.")

#: Instant categories that are emitted once per compile per rank and are
#: therefore linked across ranks by name alone (no step key needed).
_STATIC_LINK_CATS = frozenset(("wire", "guard", "fused"))

Traces = Dict[int, List[dict]]


def _true(value: str) -> bool:
    return value.strip().lower() not in ("0", "false", "no", "off", "")


def load_events(path: str) -> List[dict]:
    """Parse one rank's timeline.  The writer's array may lack the
    closing bracket if the process died mid-run (valid per the Chrome
    trace reader; tolerate it here too, like utils/profiler.py)."""
    with open(path) as f:
        text = f.read().strip()
    if text.endswith(","):
        text = text[:-1]
    if text.startswith("[") and not text.endswith("]"):
        text += "]"
    events = json.loads(text)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    if not isinstance(events, list):
        raise ValueError(f"{path}: expected a Chrome-trace event array")
    return events


def _rank_of(path: str, events: Sequence[dict]) -> int:
    for ev in events:
        if "pid" in ev:
            return int(ev["pid"])
    m = _RANK_FILE_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else 0


def load_rank_traces(paths: Sequence[str]) -> Traces:
    """Load `<name>.rank*.json` files into {rank: events}."""
    traces: Traces = {}
    for p in paths:
        events = load_events(p)
        rank = _rank_of(p, events)
        # Several files carrying the same pid concatenate into one lane:
        # a respawned serving replica's incarnations each write their own
        # file (`.rank<k>` / `.rank<k>.respawn<j>`) but share a replica id.
        traces.setdefault(rank, []).extend(events)
    return traces


def cycle_arrivals(events: Sequence[dict]) -> Dict[int, float]:
    """{step n: ts_us of the CYCLE_n barrier instant}."""
    out: Dict[int, float] = {}
    for ev in events:
        m = _CYCLE_RE.match(str(ev.get("name", "")))
        if m and ev.get("ph") == "i":
            out[int(m.group(1))] = float(ev.get("ts", 0.0))
    return out


def clock_offsets(traces: Traces, align: str = "cycle") -> Dict[int, float]:
    """Per-rank clock offset (us) subtracted to land every rank on the
    reference rank's clock.  `cycle` aligns on the per-step barrier: the
    median over common steps of ts_r(CYCLE_n) - ts_ref(CYCLE_n) — the
    median keeps one skewed step from biasing the whole alignment.
    `wall` trusts the raw clocks (offset 0)."""
    ranks = sorted(traces)
    offsets = {r: 0.0 for r in ranks}
    if align != "cycle" or not ranks:
        return offsets
    ref = ranks[0]
    ref_cycles = cycle_arrivals(traces[ref])
    for r in ranks[1:]:
        cyc = cycle_arrivals(traces[r])
        common = sorted(set(cyc) & set(ref_cycles))
        if common:
            offsets[r] = statistics.median(
                cyc[n] - ref_cycles[n] for n in common)
    return offsets


def _aligned(traces: Traces, offsets: Dict[int, float]) -> Traces:
    out: Traces = {}
    for r, events in traces.items():
        off = offsets.get(r, 0.0)
        shifted = []
        for ev in events:
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = round(float(ev["ts"]) - off, 1)
            ev["pid"] = r
            shifted.append(ev)
        out[r] = shifted
    return out


def _flow_groups(traces: Traces) -> Dict[tuple, List[dict]]:
    """Group events representing the SAME logical operation across
    ranks.  Collective spans match on (step, name, tid); the trace-time
    instants (wire/guard/fused buckets) and the CYCLE_n barriers match
    on name alone."""
    groups: Dict[tuple, List[dict]] = {}
    for r, events in traces.items():
        for ev in events:
            name = str(ev.get("name", ""))
            cat = str(ev.get("cat", ""))
            tid = str(ev.get("tid", ""))
            if ev.get("ph") == "X" and cat == "collective":
                key = ("coll", ev.get("step"), name, tid)
            elif ev.get("ph") == "i" and (cat in _STATIC_LINK_CATS
                                          or _CYCLE_RE.match(name)):
                key = ("instant", cat, name)
            elif cat == "serve" and tid.startswith("req/"):
                # One group per request lane: a request whose lifecycle
                # events land on >= 2 pids was REASSIGNED between
                # replicas — the >=2-pid rule below draws the flow arrow
                # exactly for those.
                key = ("serve", tid)
            else:
                continue
            groups.setdefault(key, []).append(ev)
    return groups


def _flow_events(traces: Traces) -> List[dict]:
    flows: List[dict] = []
    next_id = 1
    for key, evs in sorted(_flow_groups(traces).items(),
                           key=lambda kv: str(kv[0])):
        if len({ev["pid"] for ev in evs}) < 2:
            continue
        evs = sorted(evs, key=lambda ev: float(ev.get("ts", 0.0)))
        for i, ev in enumerate(evs):
            ts = float(ev.get("ts", 0.0))
            if ev.get("ph") == "X":
                # Bind the flow inside the slice, not at its left edge.
                ts += float(ev.get("dur", 0.0)) / 2.0
            ph = "s" if i == 0 else ("f" if i == len(evs) - 1 else "t")
            flow = {
                "name": f"xrank {ev.get('name', '')}",
                "cat": "xrank",
                "ph": ph,
                "id": next_id,
                "ts": round(ts, 1),
                "pid": ev["pid"],
                "tid": ev.get("tid", ""),
            }
            if ph == "f":
                flow["bp"] = "e"
            flows.append(flow)
        next_id += 1
    return flows


def merge(traces_or_paths: Union[Traces, Sequence[str]],
          align: Optional[str] = None,
          flow: Optional[bool] = None) -> dict:
    """Join all ranks' timelines into one Perfetto-compatible trace.

    Returns the Chrome-trace "JSON Object Format": {"traceEvents": [...],
    "metadata": {...}} with pid = rank (process_name metadata included)
    and, when `flow`, s/t/f flow events linking the same collective
    across ranks.
    """
    if align is None:
        align = os.environ.get("HOROVOD_TRACE_ALIGN", "cycle")
    if flow is None:
        flow = _true(os.environ.get("HOROVOD_TRACE_FLOW_EVENTS", "1"))
    traces = (traces_or_paths if isinstance(traces_or_paths, dict)
              else load_rank_traces(traces_or_paths))
    offsets = clock_offsets(traces, align=align)
    aligned = _aligned(traces, offsets)

    events: List[dict] = []
    for r in sorted(aligned):
        events.append({"name": "process_name", "ph": "M", "pid": r,
                       "args": {"name": f"hvd rank {r}"}})
        events.append({"name": "process_sort_index", "ph": "M", "pid": r,
                       "args": {"sort_index": r}})
        events.extend(aligned[r])
    flows = _flow_events(aligned) if flow else []
    events.extend(flows)
    return {
        "traceEvents": events,
        "metadata": {
            "align": align,
            "ranks": sorted(traces),
            "clock_offsets_us": {str(r): round(o, 1)
                                 for r, o in offsets.items()},
            "flow_events": len(flows),
        },
    }


def write_merged(merged: dict, out_path: str) -> None:
    with open(out_path, "w") as f:
        json.dump(merged, f, default=str)


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------

def _bucket_window(ev: dict, cycles: Dict[int, float]) -> Optional[int]:
    """The step a collective span belongs to.  The timeline stamps the
    number of COMPLETED cycles at bracket start, so a span issued during
    step n carries step=n-1; fall back to the ts window for records from
    older traces without the stamp."""
    if "step" in ev:
        return int(ev["step"]) + 1
    ts = float(ev.get("ts", 0.0))
    for n in sorted(cycles):
        if (n - 1) in cycles and cycles[n - 1] <= ts < cycles[n]:
            return n
    return None


def _carried_skews(buckets: List[List[tuple]]) -> Dict[int, float]:
    """For each bucket (its (rank, start, end) entries, >= 2 ranks) that
    was dispatched before the previous one in start order had started
    everywhere, the previous bucket's start skew (us) by `id`: the lag
    it carries over (module docstring)."""
    spans = sorted((min(s for _, s, _ in es), max(s for _, s, _ in es),
                    id(es)) for es in buckets if len(es) >= 2)
    return {key: prev_hi - prev_lo
            for (prev_lo, prev_hi, _), (lo, _, key) in zip(spans, spans[1:])
            if lo < prev_hi}


def analyze(traces_or_paths: Union[Traces, Sequence[str]],
            align: Optional[str] = None) -> dict:
    """Per-step critical path + straggler attribution (see module
    docstring for the formulas).  Returns a JSON-serializable report."""
    if align is None:
        align = os.environ.get("HOROVOD_TRACE_ALIGN", "cycle")
    traces = (traces_or_paths if isinstance(traces_or_paths, dict)
              else load_rank_traces(traces_or_paths))
    offsets = clock_offsets(traces, align=align)
    aligned = _aligned(traces, offsets)
    ranks = sorted(aligned)
    cycles = {r: cycle_arrivals(aligned[r]) for r in ranks}
    common_set = (set.intersection(*(set(c) for c in cycles.values()))
                  if cycles else set())
    common = sorted(common_set)

    # Collective spans per (step, name, tid, occurrence) across ranks.
    # Unnamed eager buckets all share name/tid ("ALLREDUCE"), so a step
    # with B gradient buckets emits B identical keys per rank; pairing
    # the k-th occurrence on each rank is sound because dispatch order
    # is the SPMD program order — without it, later spans overwrite
    # earlier ones and per-step wait undercounts to one bucket's skew.
    coll: Dict[tuple, List[tuple]] = {}
    occ: Dict[tuple, int] = {}
    for r in ranks:
        for ev in aligned[r]:
            if ev.get("ph") != "X" or ev.get("cat") != "collective":
                continue
            n = _bucket_window(ev, cycles[r])
            if n is None:
                continue
            base = (n, str(ev.get("name", "")), str(ev.get("tid", "")))
            k = occ.get((r,) + base, 0)
            occ[(r,) + base] = k + 1
            start = float(ev.get("ts", 0.0))
            coll.setdefault(base + (k,), []).append(
                (r, start, start + float(ev.get("dur", 0.0))))

    steps: List[dict] = []
    straggler_votes: Dict[int, int] = {}
    cp_total = wait_total = wire_total = 0.0
    for n in common:
        arr = {r: cycles[r][n] for r in ranks}
        last = max(ranks, key=lambda r: arr[r])
        skew_ms = (max(arr.values()) - min(arr.values())) / 1e3
        cp_ms = None
        if (n - 1) in common_set:
            cp_ms = (max(arr.values())
                     - min(cycles[r][n - 1] for r in ranks)) / 1e3
        buckets = []
        step_wait = step_wire = 0.0
        carried = _carried_skews([e for (bn, *_), e in coll.items()
                                  if bn == n])
        for (bn, name, tid, _k), entries in sorted(coll.items()):
            if bn != n:
                continue
            starts = {r: s for r, s, _ in entries}
            ends = {r: e for r, _, e in entries}
            if len(entries) >= 2:
                wait_ms = max(0.0, max(starts.values()) - min(starts.values())
                              - carried.get(id(entries), 0.0)) / 1e3
                wire_ms = max(0.0, (max(ends.values())
                                    - max(starts.values())) / 1e3)
                blamed = max(starts, key=lambda r: starts[r])
            else:
                only_r, s, e = entries[0]
                wait_ms, wire_ms, blamed = 0.0, (e - s) / 1e3, None
            step_wait += wait_ms
            step_wire += wire_ms
            # Bucket-level blame votes too: barrier-arrival skew is
            # median-aligned away for a PERSISTENT straggler (every
            # step equally late ⇒ the offset is absorbed into its
            # clock), but its per-bucket dispatch starts stay late
            # within each step, so span starts are the robust signal.
            if blamed is not None and wait_ms > 0:
                straggler_votes[blamed] = (
                    straggler_votes.get(blamed, 0) + 1)
            buckets.append({
                "name": name, "tid": tid, "ranks": len(entries),
                "wait_ms": round(wait_ms, 3), "wire_ms": round(wire_ms, 3),
                "blamed_rank": blamed,
            })
        compute_ms = (max(0.0, cp_ms - step_wait - step_wire)
                      if cp_ms is not None else None)
        if skew_ms > 0:
            straggler_votes[last] = straggler_votes.get(last, 0) + 1
        if cp_ms is not None:
            cp_total += cp_ms
            wait_total += step_wait
            wire_total += step_wire
        steps.append({
            "step": n,
            "skew_ms": round(skew_ms, 3),
            "straggler_rank": last if skew_ms > 0 else None,
            "critical_path_ms": (round(cp_ms, 3)
                                 if cp_ms is not None else None),
            "compute_ms": (round(compute_ms, 3)
                           if compute_ms is not None else None),
            "wait_ms": round(step_wait, 3),
            "wire_ms": round(step_wire, 3),
            "buckets": buckets,
        })

    skews = [s["skew_ms"] for s in steps]
    cps = [s["critical_path_ms"] for s in steps
           if s["critical_path_ms"] is not None]
    straggler = (max(sorted(straggler_votes), key=straggler_votes.get)
                 if straggler_votes else -1)
    summary = {
        "ranks": ranks,
        "steps_analyzed": len(steps),
        "step_skew_ms_median": round(statistics.median(skews), 3)
        if skews else 0.0,
        "step_skew_ms_max": round(max(skews), 3) if skews else 0.0,
        "critical_path_ms_median": round(statistics.median(cps), 3)
        if cps else 0.0,
        "straggler_rank": straggler,
        "skew_share": round(wait_total / cp_total, 4) if cp_total else 0.0,
        "wire_share": round(wire_total / cp_total, 4) if cp_total else 0.0,
        "collective_share_measured": (
            round((wait_total + wire_total) / cp_total, 4)
            if cp_total else 0.0),
    }
    return {
        "align": align,
        "clock_offsets_us": {str(r): round(o, 1)
                             for r, o in offsets.items()},
        "steps": steps,
        "summary": summary,
    }


# ---------------------------------------------------------------------------
# Serving analysis (`analyze --serve`)
# ---------------------------------------------------------------------------

_REQ_TID_RE = re.compile(r"^req/(\d+)$")


def _pctl(vals: List[float], q: float) -> float:
    """Nearest-rank percentile (matches loadgen._pct)."""
    if not vals:
        return 0.0
    vals = sorted(vals)
    k = max(0, min(len(vals) - 1, int(round(q / 100.0 * len(vals))) - 1))
    return vals[k]


def analyze_serve(traces_or_paths: Union[Traces, Sequence[str]],
                  align: Optional[str] = None) -> dict:
    """Per-request latency decomposition from serve lifecycle spans.

    Each request renders as a `req/<id>` lane carrying (at most) three
    abutting spans — `queue_wait`, `prefill`, `decode` — plus the
    `serve_submit` / `serve_first_token` / `serve_evict` instants
    (utils/timeline.py).  The pid owning the `decode` span COMPLETED the
    request; any other pid that saw the same request lane held it
    before a reassignment and is the blamed replica.  All component
    durations come from the completing replica's own clock, so
    queue + prefill + decode sums to its measured e2e within the
    clock-alignment tolerance (the spans abut; only the us-scale stamp
    gaps between them are unaccounted)."""
    if align is None:
        align = os.environ.get("HOROVOD_TRACE_ALIGN", "cycle")
    traces = (traces_or_paths if isinstance(traces_or_paths, dict)
              else load_rank_traces(traces_or_paths))
    offsets = clock_offsets(traces, align=align)
    aligned = _aligned(traces, offsets)

    # req_id -> pid -> {"spans": {name: ev}, "instants": {name: ev}}
    reqs: Dict[int, Dict[int, dict]] = {}
    for r in sorted(aligned):
        for ev in aligned[r]:
            if str(ev.get("cat", "")) != "serve":
                continue
            m = _REQ_TID_RE.match(str(ev.get("tid", "")))
            if not m:
                continue
            rid = int(m.group(1))
            slot = reqs.setdefault(rid, {}).setdefault(
                r, {"spans": {}, "instants": {}})
            kind = "spans" if ev.get("ph") == "X" else "instants"
            slot[kind][str(ev.get("name", ""))] = ev

    requests: List[dict] = []
    e2es: List[float] = []
    ttfts: List[float] = []
    n_reassigned = 0
    for rid in sorted(reqs):
        by_pid = reqs[rid]
        completer = None
        for pid, slot in sorted(by_pid.items()):
            if "decode" in slot["spans"]:
                completer = pid
        replicas = sorted(by_pid)
        reassigned = len(replicas) > 1
        n_reassigned += reassigned
        row: dict = {
            "req": rid,
            "replicas": replicas,
            "reassigned": reassigned,
            "blamed_replica": (min(r for r in replicas
                                   if r != completer)
                               if reassigned and completer is not None
                               else None),
            "completed_by": completer,
        }
        if completer is None:
            row["complete"] = False
            requests.append(row)
            continue
        slot = by_pid[completer]
        comp = {}
        for name in ("queue_wait", "prefill", "decode"):
            ev = slot["spans"].get(name)
            comp[name] = (float(ev.get("dur", 0.0)) / 1e3
                          if ev is not None else 0.0)
        dec = slot["spans"]["decode"]
        spec_ms = float((dec.get("args") or {}).get("spec_ms", 0.0))
        dec_end = float(dec.get("ts", 0.0)) + float(dec.get("dur", 0.0))
        sub = slot["instants"].get("serve_submit")
        e2e_ms = ((dec_end - float(sub.get("ts", 0.0))) / 1e3
                  if sub is not None
                  else comp["queue_wait"] + comp["prefill"]
                  + comp["decode"])
        ft = slot["instants"].get("serve_first_token")
        ttft_ms = ((float(ft.get("ts", 0.0))
                    - float(sub.get("ts", 0.0))) / 1e3
                   if ft is not None and sub is not None else None)
        row.update({
            "complete": True,
            "queue_ms": round(comp["queue_wait"], 3),
            "prefill_ms": round(comp["prefill"], 3),
            "decode_ms": round(comp["decode"], 3),
            "spec_verify_ms": round(spec_ms, 3),
            "e2e_ms": round(e2e_ms, 3),
            "ttft_ms": (round(ttft_ms, 3)
                        if ttft_ms is not None else None),
            "tokens": (dec.get("args") or {}).get("tokens"),
        })
        e2es.append(e2e_ms)
        if ttft_ms is not None:
            ttfts.append(ttft_ms)
        requests.append(row)

    done = [r for r in requests if r.get("complete")]
    summary = {
        "requests": len(requests),
        "completed": len(done),
        "reassigned": n_reassigned,
        "e2e_ms_p50": round(_pctl(e2es, 50), 3),
        "e2e_ms_p99": round(_pctl(e2es, 99), 3),
        "ttft_ms_p50": round(_pctl(ttfts, 50), 3),
        "ttft_ms_p99": round(_pctl(ttfts, 99), 3),
        "queue_ms_mean": round(
            statistics.mean([r["queue_ms"] for r in done]), 3)
        if done else 0.0,
        "decode_ms_mean": round(
            statistics.mean([r["decode_ms"] for r in done]), 3)
        if done else 0.0,
    }
    return {
        "align": align,
        "clock_offsets_us": {str(r): round(o, 1)
                             for r, o in offsets.items()},
        "requests": requests,
        "summary": summary,
    }


# ---------------------------------------------------------------------------
# Flight-recorder dumps (`trace flightrec`)
# ---------------------------------------------------------------------------

def load_flightrec(path: str) -> dict:
    """Load + validate one flight-recorder dump (serve/flightrec.py
    writes them atomically, so no torn-file tolerance is needed —
    unlike `load_events`)."""
    with open(path) as f:
        dump = json.load(f)
    if not isinstance(dump, dict) or "events" not in dump:
        raise ValueError(
            f"{path}: not a flight-recorder dump (no 'events' key)")
    return dump


def flightrec_to_trace(dump_or_path: Union[dict, str]) -> dict:
    """Render a flight-recorder dump as a Perfetto-compatible trace.

    `span` records (prefill/decode mirrors with a duration) become
    ph="X" slices on their request lane; every other kind (sched, pool,
    slo, step, error, ...) becomes a ph="i" instant on a per-kind lane,
    with the recorded payload as args.  pid is the replica id from the
    dump so multiple replicas' dumps can be concatenated in one view.
    """
    dump = (dump_or_path if isinstance(dump_or_path, dict)
            else load_flightrec(dump_or_path))
    pid = dump.get("replica")
    pid = int(pid) if pid is not None else 0
    events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": f"flightrec replica {pid} "
                          f"({dump.get('reason', '?')})"}},
    ]
    for rec in dump.get("events", []):
        data = rec.get("data") or {}
        ts = round(float(rec.get("ts_us", 0.0)), 1)
        base = {"pid": pid, "cat": "flightrec"}
        if rec.get("step") is not None:
            base["step"] = rec["step"]
        if rec.get("kind") == "span" and rec.get("dur_us") is not None:
            req = data.get("req")
            events.append({
                "name": str(data.get("name", "span")),
                "ph": "X", "ts": ts,
                "dur": round(float(rec["dur_us"]), 1),
                "tid": f"req/{req}" if req is not None else "span",
                "args": data, **base,
            })
        else:
            events.append({
                "name": str(rec.get("kind", "event")),
                "ph": "i", "s": "t", "ts": ts,
                "tid": str(rec.get("kind", "event")),
                "args": data, **base,
            })
    return {
        "traceEvents": events,
        "metadata": {
            "reason": dump.get("reason"),
            "host": dump.get("host"),
            "replica": dump.get("replica"),
            "depth": dump.get("depth"),
            "recorded_total": dump.get("recorded_total"),
            "dropped": dump.get("dropped"),
        },
    }
