"""Port parity: the merged host + device trace (`horovod_tpu_torch/utils/
profiler.py`) against the JAX package's (`horovod_tpu/utils/
profiler.py`), mirroring tests/test_profiler.py and tests/test_aux.py's
profiler tests.

JAX's hand-made traces (a device trace with no marker of its own) merge
through both packages to the same JSON.  A live `torch.profiler` run on
the CPU with the timeline on merges with the two markers coinciding, and
a collective's host span lands on the torch ops it ran.
"""

import gzip
import json

import pytest
import torch

from horovod_tpu.utils import profiler as JP
from horovod_tpu_torch.utils import profiler as P
from horovod_tpu_torch.utils import timeline as TL

from test_torch_port_collectives import no_launcher_env  # noqa: F401


def _write_host(path, events, close=True):
    text = "[\n" + ",\n".join(json.dumps(e) for e in events)
    path.write_text(text + ("\n]\n" if close else ""))
    return str(path)


def _write_dev(path, events):
    payload = {"traceEvents": events}
    if str(path).endswith(".gz"):
        with gzip.open(path, "wt") as f:
            json.dump(payload, f)
    else:
        path.write_text(json.dumps(payload))
    return str(path)


def _merge_both(tmp_path, host, dev):
    """(JAX's stats, merged events), (the port's), on the same inputs."""
    out = []
    for name, mod in (("jax", JP), ("port", P)):
        path = tmp_path / f"merged_{name}.json"
        stats = mod.merge_traces(host, dev, str(path))
        assert stats.pop("out") == str(path)
        out.append((stats, json.load(open(path))["traceEvents"]))
    return out


MARKED = [
    {"name": "before", "ph": "i", "ts": 100.0, "pid": 0, "tid": "t"},
    {"name": "PROFILER_TRACE_START", "ph": "i", "ts": 250.0, "pid": 0,
     "tid": "profiler"},
    {"name": "EXECUTE", "ph": "X", "ts": 400.0, "dur": 25.0, "pid": 0,
     "tid": "grad.w"},
]
UNMARKED = [{"name": "EXECUTE", "ph": "X", "ts": 400.0, "dur": 25.0,
             "pid": 2, "tid": "g"}]
DEVICE = [{"name": "fusion.7", "ph": "X", "ts": 5.0, "dur": 10.0, "pid": 1,
           "tid": 2}]


@pytest.mark.parametrize("case", [
    "marker_shift", "no_marker", "truncated_host", "uncompressed_device"])
def test_jax_traces_merge_to_the_same_events(tmp_path, case):
    assert P.TRACE_START_MARKER == JP.TRACE_START_MARKER
    assert P.HOST_PID_OFFSET == JP.HOST_PID_OFFSET
    host_events = UNMARKED if case == "no_marker" else MARKED
    host = _write_host(tmp_path / "host.json", host_events,
                       close=case != "truncated_host")
    dev = _write_dev(tmp_path / ("dev.trace.json" if case ==
                                 "uncompressed_device"
                                 else "dev.trace.json.gz"), DEVICE)
    (jstats, jev), (pstats, pev) = _merge_both(tmp_path, host, dev)
    assert pstats == jstats
    assert pev == jev
    by_name = {e["name"]: e for e in pev}
    if case == "no_marker":
        assert not pstats["aligned"] and by_name["EXECUTE"]["ts"] == 400.0
    else:
        assert pstats["aligned"]
        assert by_name[P.TRACE_START_MARKER]["ts"] == 0.0
        assert by_name["before"]["ts"] == -150.0
        assert by_name["EXECUTE"]["ts"] == 150.0
        assert by_name["EXECUTE"]["pid"] == P.HOST_PID_OFFSET


def test_logdir_search_matches_jax(tmp_path):
    run = tmp_path / "plugins" / "profile" / "run1"
    run.mkdir(parents=True)
    _write_dev(run / "host.trace.json.gz", [])
    host = _write_host(tmp_path / "host.json", [])
    (jstats, jev), (pstats, pev) = _merge_both(tmp_path, host,
                                               str(tmp_path))
    assert pstats == jstats == {"device_events": 0, "host_events": 0,
                                "aligned": False}
    assert pev == jev
    # The port also finds torch.profiler's own export.
    other = tmp_path / "torch"
    other.mkdir()
    _write_dev(other / "h_1.pt.trace.json", DEVICE)
    assert P._find_device_trace(str(other)).endswith("h_1.pt.trace.json")


def test_live_torch_trace_aligns_both_markers(tmp_path):
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    tl = TL.start_timeline(str(tmp_path / "host.json"))
    try:
        tl.instant("before_trace", category="probe")
        P.start_device_trace(str(tmp_path / "logdir"))
        x = torch.randn(256, 256)
        hvd.allreduce(x @ x, name="live")
        path = P.stop_device_trace()
    finally:
        TL.stop_timeline()
    assert path.endswith(".pt.trace.json")
    out = tmp_path / "merged.json"
    stats = P.merge_traces(str(tmp_path / "host.json"),
                           str(tmp_path / "logdir"), str(out))
    assert stats["aligned"] and stats["device_events"] > 0
    merged = json.load(open(out))["traceEvents"]

    def host(e):  # Kineto's pids may be strings
        return isinstance(e.get("pid"), int) and e["pid"] >= P.HOST_PID_OFFSET

    markers = [e for e in merged if e.get("name") == P.TRACE_START_MARKER]
    host_m = [e for e in markers if host(e)]
    dev_m = [e for e in markers if not host(e)]
    assert len(host_m) == 1 and dev_m
    # The shift puts the timeline's marker on the torch trace's; the
    # clocks agree if a collective's span then covers its torch ops.
    assert abs(host_m[0]["ts"] - dev_m[0]["ts"]) <= 0.1
    span = next(e for e in merged if e.get("tid") == "ALLREDUCE:live")
    lo, hi = span["ts"] - 50, span["ts"] + span["dur"] + 50
    inside = [e for e in merged if not host(e)
              and str(e.get("name", "")).startswith("aten::")
              and lo <= e.get("ts", -1) <= hi]
    assert inside, "no torch op inside the collective's shifted span"
    before = next(e for e in merged if e.get("name") == "before_trace")
    assert before["ts"] < host_m[0]["ts"]
