"""Port parity: the telemetry plane (`horovod_tpu_torch/metrics/`: the
history rings, the anomaly detectors, the Prometheus rendering and
endpoint, the fleet view, the console) against the JAX package's
`horovod_tpu/metrics/`, on the same seeded inputs.

- The detectors and the history are pure Python float math: trips,
  scores, ring points, rates, window statistics and delta quantiles are
  held bitwise to JAX's.
- The renderings (`render`, `render_fleet`, `render_frame(color=False)`)
  and `aggregate` give the same text and dicts on the same registry
  contents, the fleet view's trace section included.
- `/healthz` answers 200 by default and 503 under a failing probe;
  `hvd.init` with HOROVOD_METRICS_PORT=0 serves `/metrics` and starts the
  history sampler, `shutdown` releases both.
- Two gloo ranks publish their snapshots on the process group's store
  (through the stall watchdog, and through the fallback publisher where
  the watchdog is off) and read the fleet back.
- `hvd_fault_injections_total` counts an injected delay as JAX's does.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu.faults import spec as JSPEC
from horovod_tpu.metrics import anomaly as JAN
from horovod_tpu.metrics import catalog as JMET
from horovod_tpu.metrics import exposition as JEXP
from horovod_tpu.metrics import fleet as JFLEET
from horovod_tpu.metrics import history as JHIST
from horovod_tpu.metrics import registry as JREG
from horovod_tpu.metrics import top as JTOP
import horovod_tpu_torch as hvd
from horovod_tpu_torch import faults as PFAULTS
from horovod_tpu_torch.metrics import anomaly as PAN
from horovod_tpu_torch.metrics import catalog as PMET
from horovod_tpu_torch.metrics import exposition as PEXP
from horovod_tpu_torch.metrics import fleet as PFLEET
from horovod_tpu_torch.metrics import history as PHIST
from horovod_tpu_torch.metrics import registry as PREG
from horovod_tpu_torch.metrics import top as PTOP

from test_torch_port_collectives import no_launcher_env, run_world  # noqa: F401

PAIRS = {"jax": (JAN, JHIST, JREG, JEXP, JFLEET, JTOP),
         "port": (PAN, PHIST, PREG, PEXP, PFLEET, PTOP)}


def _series(seed, n=60, spikes=(25, 41), shift=48):
    """A latency-like series: noise around 100, spikes, a level shift."""
    rng = np.random.RandomState(seed)
    vals = 100.0 + rng.randn(n) * 3.0
    for s in spikes:
        vals[s] *= 3.0
    vals[shift:] += 60.0
    return [float(v) for v in vals]


def _counter(seed, n=40):
    """A cumulative counter that moves, stalls, moves, stalls."""
    rng = np.random.RandomState(seed)
    out, v = [], 0.0
    for i in range(n):
        if not (12 <= i < 20 or 30 <= i < 37):
            v += float(rng.randint(1, 5))
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# Detectors: bitwise trips and scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    {}, {"one_sided": False}, {"alpha": 0.1, "warmup": 3, "rel_floor": 0.05},
    {"z_thresh": 2.5, "rel_floor": 0.0}], ids=["default", "two_sided",
                                               "fast", "z2.5"])
def test_ewma_detector_is_jax_bitwise(seed, kw):
    vals = _series(seed)
    got = []
    for mod in (JAN, PAN):
        det = mod.EwmaDetector(**kw)
        got.append([(det.update(v), det.mean, det.std) for v in vals])
    assert got[0] == got[1]
    assert any(z is not None for z, _, _ in got[1])


@pytest.mark.parametrize("stall", [1, 3, 5])
def test_counter_stall_detector_is_jax_bitwise(stall):
    vals = _counter(7)
    got = []
    for mod in (JAN, PAN):
        det = mod.CounterStallDetector(stall_samples=stall)
        got.append([(det.update(v), det.stalled) for v in vals])
    assert got[0] == got[1]
    assert any(s is not None for s, _ in got[1])


@pytest.mark.parametrize("emit", [False, True])
def test_anomaly_monitor_is_jax_bitwise(emit):
    lat, cnt = _series(3), _counter(4)
    out = []
    for mod, met in ((JAN, JMET), (PAN, PMET)):
        before = {k: c.get() for k, c in met.anomaly_events.samples()}
        mon = mod.AnomalyMonitor(z_thresh=4.0, warmup=4, emit=emit)
        trips = []
        for i, (v, c) in enumerate(zip(lat, cnt)):
            trips.append(mon.observe("hvd_critical_path_ms", v, step=i,
                                     ts=float(i)))
            trips.append(mon.observe_counter("hvd_steps_total", c, step=i,
                                             ts=float(i)))
            trips.append(sorted(mon.active))
        after = {k: c.get() - before.get(k, 0.0)
                 for k, c in met.anomaly_events.samples()}
        out.append((trips, mon.events, {k: v for k, v in after.items()
                                        if v}))
    (jt, je, jm), (pt, pe, pm) = out
    assert [(a.series, a.kind, a.value, a.score, a.ts, a.step)
            for a in je] == [(a.series, a.kind, a.value, a.score, a.ts,
                              a.step) for a in pe]
    assert [t if not hasattr(t, "score") else (t.series, t.score)
            for t in jt] == [t if not hasattr(t, "score")
                             else (t.series, t.score) for t in pt]
    assert {e.kind for e in pe} == {"ewma_z", "counter_stall"}
    assert jm == pm and (bool(pm) == emit)


def test_anomaly_z_env_sets_the_threshold(monkeypatch):
    monkeypatch.setenv("HOROVOD_ANOMALY_Z", "2.5")
    assert PAN.AnomalyMonitor().z_thresh == JAN.AnomalyMonitor().z_thresh \
        == 2.5


def test_monitor_watch_on_history_is_jax():
    events = []
    for an, hist in ((JAN, JHIST), (PAN, PHIST)):
        h = hist.MetricsHistory(depth=32)
        mon = an.AnomalyMonitor(z_thresh=4.0, warmup=4, emit=False)
        mon.watch(h, gauges=("hvd_g",), counters=("hvd_c",))
        for i, (g, c) in enumerate(zip(_series(5, 30, spikes=(15,), shift=25),
                                             _counter(6, 30))):
            h.record("hvd_g", g, ts=float(i))
            h.record("hvd_c", c, kind="counter", ts=float(i))
            h.sample(now=float(i))
        events.append([(e.series, e.kind, e.value, e.score, e.ts)
                       for e in mon.events])
    assert events[0] == events[1] and events[1]


# ---------------------------------------------------------------------------
# History: rings, rates, window statistics, delta quantiles
# ---------------------------------------------------------------------------

def _fill(reg_mod, hist_mod, seed):
    """The same registry contents and sampler ticks in one package."""
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("hvd_t_ticks_total", "ticks")
    g = reg.gauge("hvd_t_level", "level", ("which",))
    lat = reg.histogram("hvd_t_lat_seconds", "lat", buckets=(0.01, 0.1, 1.0))
    h = hist_mod.MetricsHistory(depth=16, registry=reg)
    rng = np.random.RandomState(seed)
    for t in range(24):
        if t == 15:
            c._solo()._value = 0.0  # a respawn: the counter restarts
        c.inc(float(rng.randint(0, 7)))
        g.labels("a").set(float(rng.randn()))
        g.labels("b").set(float(rng.rand() * 10))
        for v in rng.exponential(0.2, size=rng.randint(0, 6)):
            lat.observe(float(v))
        h.sample(now=100.0 + 0.5 * t)
    return reg, h


@pytest.mark.parametrize("seed", [0, 1])
def test_history_is_jax_bitwise(seed):
    (_, jh), (_, ph) = _fill(JREG, JHIST, seed), _fill(PREG, PHIST, seed)
    assert jh.series() == ph.series()
    for key in jh.series():
        assert jh.points(*key) == ph.points(*key), key
        for w in (None, 2.0, 5.0):
            assert jh.rate(*key, window_s=w, now=111.5) == \
                ph.rate(*key, window_s=w, now=111.5)
            assert jh.window_stats(*key, window_s=w, now=111.5) == \
                ph.window_stats(*key, window_s=w, now=111.5)
    assert jh.samples_taken == ph.samples_taken == 24
    assert ph.rate("hvd_t_ticks_total") is not None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hist_delta_quantile_and_ring_are_jax(seed):
    rng = np.random.RandomState(seed)
    bounds = sorted(float(b) for b in rng.rand(6)) + [float("inf")]
    deltas = [int(d) for d in rng.randint(0, 5, size=7)]
    for q in (1.0, 50.0, 90.0, 99.0, 100.0):
        assert JHIST._hist_delta_quantile(bounds, deltas, q) == \
            PHIST._hist_delta_quantile(bounds, deltas, q)
    rings = [mod.Ring(5, "counter") for mod in (JHIST, PHIST)]
    for t, v in enumerate(rng.randn(9)):
        for r in rings:
            r.append(float(t), float(v))
    assert rings[0].points() == rings[1].points() and len(rings[1]) == 5


def test_history_dump_matches_jax(tmp_path):
    heads, bodies = [], []
    for name, hist in (("jax", JHIST), ("port", PHIST)):
        h = hist.MetricsHistory(depth=8)
        h.record("g", 1.25, ts=1.0)
        h.record("g", 2.5, ts=2.0)
        h.record("c", 4.0, labels=("x",), kind="counter", ts=2.0)
        path = h.dump("unit-test", path=str(tmp_path / name / "d.jsonl"))
        lines = [json.loads(ln) for ln in open(path).read().splitlines()]
        heads.append({k: v for k, v in lines[0].items()
                      if k not in ("dumped_unix", "pid")})
        bodies.append(lines[1:])
    assert heads[0] == heads[1] and bodies[0] == bodies[1]


def test_flightrec_trigger_dumps_the_port_history(tmp_path, monkeypatch):
    from horovod_tpu_torch.serve import flightrec

    monkeypatch.setenv("HOROVOD_METRICS_HISTORY_DIR", str(tmp_path))
    PHIST.stop_history()
    try:
        h = PHIST.start_history(interval=3600.0)
        h.record("g", 1.0, ts=1.0)
        flightrec.dump_all("unit-test")
        dumped = [f for f in tmp_path.iterdir()
                  if f.name.startswith("metrics_history.")]
        assert len(dumped) == 1
        assert json.loads(dumped[0].read_text().splitlines()[0])[
            "reason"] == "unit-test"
    finally:
        PHIST.stop_history()
    assert PHIST.get_history() is None


# ---------------------------------------------------------------------------
# Rendering and aggregation
# ---------------------------------------------------------------------------

@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_000_000.0)


def _registry(reg_mod, rank, seed):
    """One rank's registry: counters, gauges (the trace gauges too) and
    a histogram, from a seed."""
    rng = np.random.RandomState(seed + rank)
    reg = reg_mod.MetricsRegistry()
    reg.counter("hvd_steps_total", "steps").inc(10 + rank)
    calls = reg.counter("hvd_collective_calls_total", "calls",
                        ("kind", "dtype", "process_set"))
    calls.labels("ALLREDUCE", "float32", "0").inc(7)
    calls.labels("BROADCAST", "float32", "0").inc(2 + rank)
    reg.counter("hvd_collective_bytes_total", "bytes").inc(4096 * (rank + 1))
    lat = reg.histogram("hvd_collective_latency_seconds", "latency")
    for v in rng.exponential(0.01, size=9):
        lat.observe(float(v))
    reg.gauge("hvd_critical_path_ms", "cp").set(100.0 + 10 * rank)
    if rank == 0:
        reg.gauge("hvd_step_skew_ms", "skew").set(3.5)
        reg.gauge("hvd_straggler_rank", "straggler").set(1)
        reg.gauge("hvd_stall_laggards", "laggards").set(1)
    reg.gauge("hvd_serve_p99_ms", "p99").set(float(rng.rand() * 50))
    reg.gauge("hvd_slo_budget_remaining", "budget", ("slo",)).labels(
        "serve_latency").set(0.75 - 0.1 * rank)
    burn = reg.gauge("hvd_slo_burn_rate", "burn", ("slo", "window"))
    burn.labels("serve_latency", "fast").set(2.0)
    burn.labels("serve_latency", "slow").set(0.5)
    reg.counter("hvd_anomaly_events_total", "anomalies",
                ("series", "kind")).labels("hvd_critical_path_ms",
                                           "ewma_z").inc(rank + 1)
    reg.gauge("hvd_anomaly_active", "active").set(rank)
    reg.counter("hvd_autoscale_events_total", "autoscale",
                ("verdict",)).labels("hold").inc(3)
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_render_is_jax(seed):
    texts = [mods[3].render(_registry(mods[2], 0, seed))
             for mods in PAIRS.values()]
    assert texts[0] == texts[1]
    assert "hvd_collective_latency_seconds_bucket{le=\"+Inf\"} 9" in texts[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_views_are_jax(fixed_clock, seed):
    out = {}
    for name, (_, _, reg, _, fleet, top) in PAIRS.items():
        snaps = [fleet.snapshot(_registry(reg, r, seed), rank=r)
                 for r in (0, 1)]
        state = top.TopState()
        state.update(snaps, now=1.0)
        for s in snaps:
            s["metrics"]["hvd_steps_total"]["samples"][0][1] += 4
        state.update(snaps, now=3.0)
        out[name] = (fleet.aggregate(snaps), fleet.render_fleet(snaps),
                     top.render_frame(snaps, state, color=False),
                     top.render_frame(snaps, state, color=True),
                     state.series("steps/s"), snaps)
    assert out["jax"][:5] == out["port"][:5]
    text = out["port"][1]
    assert "fleet view: 2 rank(s)" in text
    assert "blamed straggler (rank 0's analysis): rank 1" in text
    assert "step critical path (ms): rank0=100.0  rank1=110.0" in text
    assert "ACTIVE ANOMALIES" in out["port"][2]
    assert json.dumps(out["port"][5]) and out["port"][4] == [4.0]


def test_sparkline_and_empty_views_are_jax():
    for vals in ([], [5.0, 5.0], list(range(8)), list(range(100))):
        assert JTOP.sparkline(vals) == PTOP.sparkline(vals)
    assert JFLEET.render_fleet([]) == PFLEET.render_fleet([])
    assert JTOP.render_frame([], JTOP.TopState()) == \
        PTOP.render_frame([], PTOP.TopState())
    assert PTOP.run_top(lambda: [], once=True) == 1


def test_scrape_parser_and_top_once_are_jax(capsys, monkeypatch):
    from horovod_tpu.metrics.__main__ import _parse_prometheus as jparse
    from horovod_tpu_torch.metrics.__main__ import _parse_prometheus as pparse
    from horovod_tpu_torch.metrics.__main__ import main

    text = PEXP.render(_registry(PREG, 0, 3))
    assert {k: v for k, v in pparse(text, rank=2).items() if k != "ts"} == \
        {k: v for k, v in jparse(text, rank=2).items() if k != "ts"}
    PMET.steps.inc(5)
    port = PEXP.start_server(0, addr="127.0.0.1")
    try:
        assert main(["top", "--once", "--scrape", f"127.0.0.1:{port}"]) == 0
        assert main(["--scrape", f"127.0.0.1:{port}"]) == 0
    finally:
        PEXP.stop_server()
    out = capsys.readouterr().out
    assert "hvd top" in out and "fleet view: 1 rank(s)" in out
    # The KV source wants the rendezvous secret, as JAX's CLI does.
    monkeypatch.delenv("HOROVOD_SECRET_KEY", raising=False)
    with pytest.raises(SystemExit):
        main(["--kv", "127.0.0.1:1"])
    assert "no --secret" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The endpoint: /metrics, /healthz, hvd.init / shutdown
# ---------------------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_healthz_default_200_and_503_under_a_failing_probe():
    port = PEXP.start_server(0, addr="127.0.0.1")
    try:
        assert PEXP.server_port() == port
        assert _get(f"http://127.0.0.1:{port}/healthz") == (200, "ok\n")
        PEXP.set_liveness_probe(lambda: (False, "down for a test"))
        assert _get(f"http://127.0.0.1:{port}/healthz") == (
            503, "down for a test\n")

        def boom():
            raise RuntimeError("probe broke")

        PEXP.set_liveness_probe(boom)
        code, body = _get(f"http://127.0.0.1:{port}/healthz")
        assert code == 503 and "RuntimeError" in body
        assert _get(f"http://127.0.0.1:{port}/nothing")[0] == 404
        code, body = _get(f"http://127.0.0.1:{port}/metrics")
        assert code == 200 and "# TYPE hvd_steps_total counter" in body
    finally:
        PEXP.set_liveness_probe(None)
        PEXP.stop_server()
    assert PEXP.server_port() is None


def test_init_serves_metrics_and_history_and_shutdown_releases(monkeypatch):
    hvd.shutdown()
    monkeypatch.setenv("HOROVOD_METRICS_PORT", "0")
    monkeypatch.setenv("HOROVOD_METRICS_HISTORY_INTERVAL", "0.05")
    hvd.init(device="cpu")
    try:
        port = PEXP.server_port()
        assert port is not None
        hvd.allreduce(torch.ones(3), name="scraped")
        code, body = _get(f"http://127.0.0.1:{port}/metrics")
        assert code == 200
        assert 'hvd_collective_calls_total{kind="ALLREDUCE"' in body
        hist = PHIST.get_history()
        assert hist is not None
        deadline = time.time() + 10
        while hist.samples_taken < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert hist.points("hvd_collective_calls_total",
                           ("ALLREDUCE", "float32", "0"))
    finally:
        hvd.shutdown()
    assert PEXP.server_port() is None and PHIST.get_history() is None
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2)


def test_init_without_the_env_starts_neither():
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        assert PEXP.server_port() is None and PHIST.get_history() is None
        # One rank: no store, so no fallback publisher either.
        assert not PFLEET.maybe_start_kv_publisher()
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# The fault points' counter
# ---------------------------------------------------------------------------

def _injections(met):
    return {k: c.get() for k, c in met.fault_injections.samples()}


@pytest.mark.parametrize("spec", [
    "chaos.straggler_delay:delay:1ms",
    "chaos.straggler_delay@2:delay:1ms:0.5"])
def test_fault_injections_counted_as_jax(spec):
    """The same schedule fired eight times counts the same injections in
    both packages' `hvd_fault_injections_total`; the port's collective
    bracket fires the point."""
    jb, pb = _injections(JMET), _injections(PMET)
    jsched = JSPEC.FaultSchedule(JSPEC.parse_spec(spec), seed=3)
    for _ in range(8):
        jsched.fire("chaos.straggler_delay")
    hvd.init(device="cpu")
    try:
        PFAULTS.install(spec, seed=3)
        for _ in range(8):
            hvd.allreduce(torch.ones(2))
        counts = PFAULTS.injections()
    finally:
        PFAULTS.clear()
        hvd.shutdown()
    jd = {k: v - jb.get(k, 0.0) for k, v in _injections(JMET).items()
          if v != jb.get(k, 0.0)}
    pd = {k: v - pb.get(k, 0.0) for k, v in _injections(PMET).items()
          if v != pb.get(k, 0.0)}
    assert pd == jd and pd
    assert pd == {k: float(v) for k, v in counts.items()}


# ---------------------------------------------------------------------------
# The fleet over the process group's store, two gloo ranks
# ---------------------------------------------------------------------------

FLEET_WORKER = r'''
import os, sys, time
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.metrics import catalog as MET, fleet
from horovod_tpu_torch.utils import stall_inspector

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
res = {}
# (a) The stall watchdog publishes (its poll every 0.1 s here).
os.environ["HOROVOD_STALL_CHECK_TIME_SECONDS"] = "0.4"
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
res["watchdog"] = stall_inspector.get_inspector() is not None
res["fallback_a"] = fleet._publisher_thread is not None
MET.step_skew_ms.set(2.5 * (r + 1))
MET.straggler_rank.set(1)
hvd.allreduce(torch.ones(4), name="fleet")
time.sleep(0.6)
hvd.barrier()
snaps = fleet.read_fleet(basics.kv_store())
res["ranks_a"] = [s["rank"] for s in snaps]
res["skew_a"] = [s["metrics"]["hvd_step_skew_ms"]["samples"][0][1]
                 for s in snaps]
res["view_a"] = fleet.render_fleet(snaps)
hvd.barrier()
hvd.shutdown()
# (b) The watchdog off: the fallback publisher does it.
os.environ["HOROVOD_STALL_CHECK_DISABLE"] = "1"
os.environ["HOROVOD_METRICS_KV_INTERVAL"] = "0.1"
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
res["fallback_b"] = fleet._publisher_thread is not None
time.sleep(0.5)
hvd.barrier()
res["ranks_b"] = [s["rank"] for s in fleet.read_fleet(basics.kv_store())]
hvd.barrier()
hvd.shutdown()
res["fallback_after"] = fleet._publisher_thread is not None
torch.save(res, f"{out_dir}/rank{r}.pt")
'''


def test_fleet_publish_and_read_over_the_store_at_two_ranks(tmp_path):
    res = run_world(tmp_path, 2, FLEET_WORKER)
    for r, rec in enumerate(res):
        assert rec["watchdog"] and not rec["fallback_a"]
        assert rec["ranks_a"] == [0, 1] and rec["skew_a"] == [2.5, 5.0]
        assert "fleet view: 2 rank(s)" in rec["view_a"]
        assert "blamed straggler (rank 1's analysis): rank 1" in \
            rec["view_a"]
        assert rec["fallback_b"] and rec["ranks_b"] == [0, 1]
        assert not rec["fallback_after"]
