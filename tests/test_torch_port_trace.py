"""Port parity: the fleet tracer (`horovod_tpu_torch/trace/`) and the
straggler reaction's bucket cap, against the JAX package's
`horovod_tpu/trace/` and `parallel/data_parallel.py`.

- `analyze`, `merge`, `clock_offsets`, `analyze_serve` and
  `flightrec_to_trace` give dicts equal to JAX's on JAX's own fixtures
  (tests/test_trace.py, tests/test_serve_obs.py) and on the timelines
  two gloo CPU ranks of the port write with a seeded straggler delay on
  rank 1, which both packages blame.
- `TraceMeasurements.from_report` and the reaction policy's decision
  stream equal JAX's on the same reports, the degrade branches too.
- `gradient_bucket_partition` under `set_reaction_rebalance(1)` and
  `(3)` gives JAX's index lists, on the exact wire and on int8.
- Two gloo ranks train a tiny transformer with the eager
  `allreduce_gradients`; arming the rebalance mid-run ends bitwise equal
  to a run that does not (at two ranks every element is one a+b,
  whatever the buckets).
- `fused_apply` and ZeRO 1-3 raise their "partition changed" errors on
  the step after an arm or a disarm.
"""

import dataclasses
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.ops.compression import Compression as JCompression
from horovod_tpu.parallel import data_parallel as JDP
from horovod_tpu.trace import core as JCORE
from horovod_tpu.trace import measure as JMEAS
from horovod_tpu.trace import reaction as JREACT
from horovod_tpu.trace.__main__ import main as jax_cli
import horovod_tpu_torch as hvd
from horovod_tpu_torch.metrics import catalog as PMET
from horovod_tpu_torch.ops.compression import Compression as PCompression
from horovod_tpu_torch.parallel import data_parallel as PDP
from horovod_tpu_torch.serve.flightrec import FlightRecorder as PFlightRecorder
from horovod_tpu_torch.trace import core as PCORE
from horovod_tpu_torch.trace import measure as PMEAS
from horovod_tpu_torch.trace import reaction as PREACT
from horovod_tpu_torch.trace.__main__ import main as port_cli

from test_torch_port_collectives import no_launcher_env, run_world  # noqa: F401
from test_trace import OFFSET_US, _fixture


@pytest.fixture(autouse=True)
def _clean_reaction_state():
    saved = dict(JDP._REACTION), dict(PDP._REACTION)
    yield
    for mod, s in zip((JDP, PDP), saved):
        mod._REACTION.clear()
        mod._REACTION.update(s)


def _serve_fixture():
    """tests/test_serve_obs.py's two-replica request lanes."""
    def span(pid, name, ts, dur, args=None):
        return {"ph": "X", "cat": "serve", "name": name, "pid": pid,
                "tid": "req/7", "ts": ts, "dur": dur, "args": args or {}}

    def inst(pid, name, ts):
        return {"ph": "i", "cat": "serve", "name": name, "pid": pid,
                "tid": "req/7", "ts": ts, "s": "t"}

    return {
        0: [inst(0, "serve_submit", 1000.0),
            span(0, "queue_wait", 1000.0, 500.0),
            span(0, "prefill", 1500.0, 300.0),
            inst(0, "serve_first_token", 2000.0),
            span(0, "decode", 1800.0, 700.0, {"tokens": 4, "spec_ms": 0.1}),
            inst(0, "serve_evict", 2500.0)],
        1: [inst(1, "serve_submit", 100.0),
            span(1, "queue_wait", 100.0, 200.0)],
    }


def _seeded_traces(seed, ranks=3, steps=6, buckets=3):
    """Random rank timelines: per-rank clock offsets, per-step arrival
    jitter, `buckets` unnamed collectives a step (the k-th occurrence
    pairing), a late rank, a missing cycle on one rank."""
    rng = np.random.RandomState(seed)
    late = int(rng.randint(ranks))
    traces = {}
    for r in range(ranks):
        off = float(rng.randint(0, 10 ** 6))
        evs, t = [], 0.0
        for n in range(1, steps + 1):
            t += 1000.0 + float(rng.randint(0, 300))
            for k in range(buckets):
                start = t + 50.0 * k + float(rng.randint(0, 40)) + (
                    120.0 if r == late else 0.0)
                evs.append({"name": "ALLREDUCE", "cat": "collective",
                            "ph": "X", "ts": round(start + off, 1),
                            "dur": float(rng.randint(10, 90)), "pid": r,
                            "tid": "ALLREDUCE", "step": n - 1})
            t += 300.0
            if not (r == 0 and n == steps - 1):
                evs.append({"name": f"CYCLE_{n}", "cat": "cycle",
                            "ph": "i", "s": "p", "ts": round(t + off, 1),
                            "pid": r, "tid": "cycle", "step": n})
        traces[r] = evs
    return traces


FIXTURES = {
    "test_trace": _fixture,
    "single_rank": lambda: {0: _fixture()[0]},
    "seeded0": lambda: _seeded_traces(0),
    "seeded1": lambda: _seeded_traces(1, ranks=2, buckets=5),
    "seeded2": lambda: _seeded_traces(2, ranks=4, steps=3),
}


# ---------------------------------------------------------------------------
# core: analyze, merge, offsets, serve, flight-recorder dumps
# ---------------------------------------------------------------------------

def _bucket_windows(traces, align):
    """Each step's buckets' (first start, last start) across ranks, in
    start order, from the aligned traces (JAX's pairing rule)."""
    offsets = JCORE.clock_offsets(traces, align=align)
    windows = {}
    for r, evs in traces.items():
        cycles = JCORE.cycle_arrivals(
            [dict(e, ts=float(e.get("ts", 0.0)) - offsets[r]) for e in evs])
        occ = {}
        for ev in evs:
            if ev.get("ph") != "X" or ev.get("cat") != "collective":
                continue
            ev = dict(ev, ts=float(ev.get("ts", 0.0)) - offsets[r])
            n = JCORE._bucket_window(ev, cycles)
            if n is None:
                continue
            base = (n, str(ev.get("name", "")), str(ev.get("tid", "")))
            occ[base] = occ.get(base, -1) + 1
            windows.setdefault(base + (occ[base],), []).append(ev["ts"])
    out = {}
    for (n, *_), starts in windows.items():
        if len(starts) >= 2:
            out.setdefault(n, []).append((min(starts), max(starts)))
    return {n: sorted(w) for n, w in out.items()}


def _overlapping(traces, align):
    """Whether a bucket starts somewhere before the previous one (in
    start order) has started everywhere: the data plane dispatched it
    asynchronously."""
    return any(lo < prev_hi
               for w in _bucket_windows(traces, align).values()
               for (_, prev_hi), (lo, _) in zip(w, w[1:]))


# The fields the port's netting of a carried lag changes (trace/core.py).
_WAIT_FIELDS = {"wait_ms", "compute_ms", "skew_share",
                "collective_share_measured"}


def _without_waits(report):
    if isinstance(report, dict):
        return {k: _without_waits(v) for k, v in report.items()
                if k not in _WAIT_FIELDS}
    if isinstance(report, list):
        return [_without_waits(v) for v in report]
    return report


def _marked_async(traces):
    """`traces` with every collective span marked as the port's traced
    bracket marks a span that ends at dispatch."""
    return {r: [dict(e, dispatch="async") if e.get("cat") == "collective"
                else e for e in evs] for r, evs in traces.items()}


@pytest.mark.parametrize("align", ["cycle", "wall"])
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_analyze_and_offsets_are_jax(fixture, align):
    """JAX's report on every fixture as it is: no span carries the
    async dispatch mark, so aligned starts that overlap (the seeded
    fixtures') read under the plain rule.  With every span marked, the
    overlapping ones give the same report but for the straggler wait,
    which the port counts once per lag (never more than JAX does)."""
    traces = FIXTURES[fixture]()
    assert PCORE.clock_offsets(traces, align=align) == \
        JCORE.clock_offsets(traces, align=align)
    want = JCORE.analyze(traces, align=align)
    assert PCORE.analyze(traces, align=align) == want
    got = PCORE.analyze(_marked_async(traces), align=align)
    if not _overlapping(traces, align):
        assert got == want
    else:
        assert fixture.startswith("seeded")
        assert _without_waits(got) == _without_waits(want)
        waits = [(b["wait_ms"], wb["wait_ms"])
                 for st, wst in zip(got["steps"], want["steps"])
                 for b, wb in zip(st["buckets"], wst["buckets"])]
        assert all(g <= w for g, w in waits)
        assert any(g < w for g, w in waits)
        assert got["summary"]["skew_share"] <= want["summary"]["skew_share"]
    if fixture == "test_trace" and align == "cycle":
        assert got["summary"]["straggler_rank"] == 1
        assert got["clock_offsets_us"] == {"0": 0.0, "1": OFFSET_US}


def _lagged_step(sync):
    """Two ranks, one 200 ms step, three buckets; rank 1 is 20 ms later
    to each than the last.  Async (the port's hooks, spans marked
    `dispatch: async`): rank 0 dispatches its buckets 1 ms apart without
    waiting, so rank 1's lag grows to 20, 40, 60 ms.  Sync (JAX's eager buckets): rank 0 starts a bucket once
    the last one is done, 1 ms after rank 1 joined it, so each lag is
    20 ms."""
    def ev(r, k, ts):
        return {"name": "ALLREDUCE", "cat": "collective", "ph": "X",
                "ts": ts, "dur": 500.0, "pid": r, "tid": "ALLREDUCE",
                "step": 1, **({} if sync else {"dispatch": "async"})}

    def cyc(r, n, ts):
        return {"name": f"CYCLE_{n}", "cat": "cycle", "ph": "i", "s": "p",
                "ts": ts, "pid": r, "tid": "cycle", "step": n}

    traces = {r: [cyc(r, 1, 0.0)] for r in (0, 1)}
    t0 = 1000.0
    for k in range(3):
        start0 = (t0 + 1000.0 * k if not sync
                  else t0 + 21000.0 * k)
        start1 = (t0 + 1000.0 * k + 20000.0 * (k + 1) if not sync
                  else start0 + 20000.0)
        traces[0].append(ev(0, k, start0))
        traces[1].append(ev(1, k, start1))
    for r in (0, 1):
        traces[r].append(cyc(r, 2, 200000.0))
    return traces


@pytest.mark.parametrize("sync", [False, True], ids=["async", "sync"])
def test_a_carried_lag_counts_once(sync):
    """The port's netting (trace/core.py): asynchronously dispatched
    buckets count each 20 ms of a straggler's lag once, 60 ms of the
    200 ms step, where JAX's rule sums 20 + 40 + 60; synchronous ones
    read as JAX's."""
    traces = _lagged_step(sync)
    got, want = PCORE.analyze(traces), JCORE.analyze(traces)
    step = got["steps"][-1]
    assert step["critical_path_ms"] == 200.0
    assert [b["wait_ms"] for b in step["buckets"]] == [20.0, 20.0, 20.0]
    assert all(b["blamed_rank"] == 1 for b in step["buckets"])
    assert got["summary"]["skew_share"] == 0.3
    if sync:
        assert got == want
    else:
        assert [b["wait_ms"] for b in want["steps"][-1]["buckets"]] == \
            [20.0, 40.0, 60.0]
        assert want["summary"]["skew_share"] == 0.6


@pytest.mark.parametrize("flow", [True, False])
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_merge_is_jax(fixture, flow):
    traces = FIXTURES[fixture]()
    got = PCORE.merge(traces, align="cycle", flow=flow)
    assert got == JCORE.merge(traces, align="cycle", flow=flow)
    assert (got["metadata"]["flow_events"] > 0) == (
        flow and len(traces) > 1)


def test_env_defaults_of_merge_are_jax(monkeypatch):
    monkeypatch.setenv("HOROVOD_TRACE_ALIGN", "wall")
    monkeypatch.setenv("HOROVOD_TRACE_FLOW_EVENTS", "off")
    got = PCORE.merge(_fixture())
    assert got == JCORE.merge(_fixture())
    assert got["metadata"]["align"] == "wall"
    assert got["metadata"]["flow_events"] == 0


@pytest.mark.parametrize("align", ["cycle", "wall"])
def test_analyze_serve_is_jax(align):
    got = PCORE.analyze_serve(_serve_fixture(), align=align)
    assert got == JCORE.analyze_serve(_serve_fixture(), align=align)
    (row,) = got["requests"]
    assert row["completed_by"] == 0 and row["blamed_replica"] == 1


def test_flightrec_dump_renders_as_jax(tmp_path):
    """The port's flight-recorder dump through both packages'
    `load_flightrec` / `flightrec_to_trace` (the dump format is JAX's)."""
    rec = PFlightRecorder(4, out_dir=str(tmp_path))
    rec.record("slo", {"event": "spec_on"}, step=3)
    rec.record("span", {"name": "prefill", "req": 1}, ts_us=10.0, dur_us=5.0)
    rec.record("pool", {"free": 3})
    path = rec.dump("manual")
    got = PCORE.flightrec_to_trace(PCORE.load_flightrec(path))
    assert got == JCORE.flightrec_to_trace(JCORE.load_flightrec(path))
    span = next(e for e in got["traceEvents"] if e.get("ph") == "X")
    assert span["tid"] == "req/1" and span["dur"] == 5.0
    with pytest.raises(ValueError):
        (tmp_path / "x.json").write_text("[]")
        PCORE.load_flightrec(str(tmp_path / "x.json"))


def test_loaders_are_jax(tmp_path):
    paths = []
    for r, events in sorted(_fixture().items()):
        p = tmp_path / f"tl.rank{r}.json"
        # The writer's crash-safe form: no closing bracket, a trailing comma.
        p.write_text("[" + json.dumps(events)[1:-1] + ",")
        paths.append(str(p))
    assert PCORE.load_rank_traces(paths) == JCORE.load_rank_traces(paths)
    assert PCORE.load_rank_traces(paths + paths[:1]) == \
        JCORE.load_rank_traces(paths + paths[:1])
    q = tmp_path / "t.rank3.json"
    q.write_text(json.dumps({"traceEvents": [
        {"name": "CYCLE_1", "ph": "i", "ts": 1.0}]}))
    assert sorted(PCORE.load_rank_traces([str(q)])) == [3]
    assert PCORE.cycle_arrivals(_fixture()[1]) == \
        JCORE.cycle_arrivals(_fixture()[1])


def test_cli_is_jax(tmp_path, capsys):
    paths = []
    for r, events in sorted(_fixture().items()):
        p = tmp_path / f"tl.rank{r}.json"
        p.write_text(json.dumps(events))
        paths.append(str(p))
    outs = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        merged = tmp_path / f"{name}_merged.json"
        assert cli(["merge", *paths, "-o", str(merged)]) == 0
        said = capsys.readouterr().out.replace(str(merged), "OUT")
        assert cli(["analyze", *paths]) == 0
        report = json.loads(capsys.readouterr().out)
        outs[name] = (said, json.loads(merged.read_text()), report)
    assert outs["jax"] == outs["port"]
    assert outs["port"][2]["summary"]["straggler_rank"] == 1


# ---------------------------------------------------------------------------
# TraceMeasurements and the reaction policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_trace_measurements_are_jax(fixture):
    report = JCORE.analyze(FIXTURES[fixture]())
    got = dataclasses.asdict(PMEAS.TraceMeasurements.from_report(report))
    assert got == dataclasses.asdict(
        JMEAS.TraceMeasurements.from_report(report))


def test_trace_measurements_feed_metrics_and_autotune():
    tm = PMEAS.TraceMeasurements.from_report(PCORE.analyze(_fixture()))
    assert tm.apply_to_metrics()
    assert PMET.critical_path_ms._solo().get() == 1.45
    assert PMET.straggler_rank._solo().get() == 1

    class FakePM:
        def record_trace(self, step_ms, items_per_step=1.0, bucket_ms=None):
            self.call = (step_ms, items_per_step, bucket_ms)

    pm = FakePM()
    assert tm.feed_autotune(pm=pm, items_per_step=32.0)
    assert pm.call == (1.45, 32.0, {"allreduce.b0/grad.w": 0.875})
    assert not PMEAS.TraceMeasurements().feed_autotune(pm=pm)


def _stream(seed, n=24):
    """A seeded stream of window measurements: blame runs, noise, high
    skew shares."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        rank = int(rng.choice([-1, 0, 1, 1, 1, 2]))
        skew = float(rng.choice([0.01, 0.2, 0.3, 0.5, 0.8]))
        out.append(types.SimpleNamespace(straggler_rank=rank,
                                         skew_share=skew))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kw", [
    dict(patience=2, cooldown=1), dict(patience=3, cooldown=0),
    dict(patience=1, cooldown=2, skew_threshold=0.4)],
    ids=["p2c1", "p3c0", "p1c2t0.4"])
def test_reaction_decisions_are_jax(seed, kw):
    """The same window stream gives the same decisions, callbacks and
    partition actuations (the default actuator arms each package's own
    `set_reaction_rebalance`)."""
    out = []
    for react, dp in ((JREACT, JDP), (PREACT, PDP)):
        dp.clear_reaction_rebalance()
        acted = []
        pol = react.StragglerReactionPolicy(
            on_degrade=lambda r: acted.append(("degrade", r)), **kw)
        decisions = []
        for m in _stream(seed):
            decisions.append(dataclasses.asdict(pol.observe(m)))
            decisions.append(dp.reaction_rebalance())
        pol.reset()
        out.append((decisions, acted, dp.reaction_rebalance()))
    assert out[0] == out[1]
    assert out[1][2] == (0, -1)


def test_reaction_covers_both_degrade_branches():
    """Over the skew threshold, and still blamed after a rebalance."""
    for react in (JREACT, PREACT):
        acted = []
        pol = react.StragglerReactionPolicy(
            patience=2, cooldown=1, skew_threshold=0.75,
            on_rebalance=lambda r: acted.append(("rb", r)),
            on_degrade=lambda r: acted.append(("dg", r)))
        m = types.SimpleNamespace(straggler_rank=1, skew_share=0.2)
        reasons = [pol.observe(m).reason for _ in range(5)]
        hi = types.SimpleNamespace(straggler_rank=2, skew_share=0.9)
        d = [pol.observe(hi) for _ in range(3)][-1]
        assert reasons == ["streak 1/2", "patience exhausted", "cooldown",
                           "streak 1/2", "still blamed after rebalance"]
        assert d.action == "degrade" and "over threshold" in d.reason
        assert acted == [("rb", 1), ("dg", 1), ("dg", 2)]


def test_reaction_env_knobs_are_jax(monkeypatch):
    monkeypatch.setenv("HOROVOD_STRAGGLER_PATIENCE", "5")
    monkeypatch.setenv("HOROVOD_STRAGGLER_SKEW_THRESHOLD", "0.33")
    monkeypatch.setenv("HOROVOD_STRAGGLER_COOLDOWN", "7")
    p, j = PREACT.StragglerReactionPolicy(), JREACT.StragglerReactionPolicy()
    assert (p.patience, p.skew_threshold, p.cooldown) == \
        (j.patience, j.skew_threshold, j.cooldown) == (5, 0.33, 7)


# ---------------------------------------------------------------------------
# The bucket cap
# ---------------------------------------------------------------------------

LEAVES = [((64, 33), np.float32), ((7,), np.int32), ((1000,), np.float32),
          ((5, 5, 5), np.float16), ((3,), np.int32), ((2048,), np.float32),
          ((31, 17), np.float32), ((9,), np.float32)]


@pytest.mark.parametrize("order", ["forward", "reverse"])
@pytest.mark.parametrize("min_buckets", ["1", "4"])
@pytest.mark.parametrize("max_buckets", [0, 1, 3])
@pytest.mark.parametrize("wire", ["none", "int8"])
def test_reaction_cap_partition_is_jax(monkeypatch, wire, max_buckets,
                                       min_buckets, order):
    monkeypatch.setenv("HOROVOD_MIN_BUCKETS", min_buckets)
    jl = [jnp.zeros(s, d) for s, d in LEAVES]
    pl = [torch.zeros(s, dtype=getattr(torch, np.dtype(d).name))
          for s, d in LEAVES]
    JDP.set_reaction_rebalance(max_buckets, avoid_rank=1)
    gen = PDP.set_reaction_rebalance(max_buckets, avoid_rank=1)
    assert gen == PDP.reaction_generation()
    assert PDP.reaction_rebalance() == (max_buckets, 1)
    kw = dict(fusion_threshold_bytes=4096, bucket_order=order)
    want = JDP.gradient_bucket_partition(
        jl, compression=getattr(JCompression, wire), **kw)
    got = PDP.gradient_bucket_partition(
        pl, compression=getattr(PCompression, wire), **kw)
    assert got == [list(b) for b in want]
    assert PDP.shard_group_partition(
        pl, compression=getattr(PCompression, wire), **kw) == [
        list(g) for g in JDP.shard_group_partition(
            jl, compression=getattr(JCompression, wire), **kw)]
    if max_buckets == 1:
        floats = [b for b in got if any(
            pl[i].dtype.is_floating_point for i in b)]
        assert len(floats) == 1
    PDP.clear_reaction_rebalance()
    assert PDP.reaction_rebalance() == (0, -1)
    assert PDP.reaction_generation() == gen + 1


def test_reaction_gauge_is_set():
    PDP.set_reaction_rebalance(1, avoid_rank=1)
    assert PMET.reaction_max_buckets._solo().get() == 1
    PDP.clear_reaction_rebalance()
    assert PMET.reaction_max_buckets._solo().get() == 0


# ---------------------------------------------------------------------------
# Consumers that bake the partition raise on the step after a change
# ---------------------------------------------------------------------------

SHAPES = [(1024,), (32, 32), (1024,), (16, 64)]  # 4 KiB each
THRESHOLD = 8192  # two leaves a bucket: 2 buckets


@pytest.mark.parametrize("change", ["arm", "disarm"])
@pytest.mark.parametrize("kw", [dict(fused_apply=True), dict(zero_stage=1),
                                dict(zero_stage=2), dict(zero_stage=3)],
                         ids=["fused_apply", "zero1", "zero2", "zero3"])
def test_baked_partitions_raise_on_the_step_after_a_change(kw, change):
    if change == "disarm":
        PDP.set_reaction_rebalance(1)
    hvd.init(device="cpu")
    try:
        rng = np.random.RandomState(0)
        params = [torch.nn.Parameter(torch.from_numpy(
            rng.randn(*s).astype(np.float32))) for s in SHAPES]
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(params, lr=0.1),
            fusion_threshold_bytes=THRESHOLD, **kw)
        placement = rows = None
        if kw.get("zero_stage") == 3:
            placement = hvd.zero3_placement(params,
                                            fusion_threshold_bytes=THRESHOLD)
            rows = placement.shard(params)
            placement.bind(params)

        def step():
            nonlocal rows
            if placement is not None:
                with torch.no_grad():
                    placement.gather(rows)
            for p in params:
                p.grad = torch.ones_like(p)
            u = opt.step()
            if placement is not None:
                rows = placement.apply_updates(rows, u)
                placement.release()

        step()
        if change == "arm":
            PDP.set_reaction_rebalance(1, avoid_rank=1)
        else:
            PDP.clear_reaction_rebalance()
        with pytest.raises(ValueError, match="partition changed"):
            step()
    finally:
        hvd.shutdown()


def test_jax_fused_apply_raises_on_the_step_after_an_arm():
    """The reference behaviour the port's raise mirrors."""
    jhvd.init()
    params = [jnp.ones(s, jnp.float32) for s in SHAPES]
    opt = jhvd.DistributedOptimizer(optax.sgd(0.1), fused_apply=True,
                                    fusion_threshold_bytes=THRESHOLD)
    state = opt.init(params)
    grads = [jnp.ones_like(p) for p in params]
    step = jhvd.data_parallel(lambda p, s, g: opt.update(g, s, p),
                              batch_args=())
    step(params, state, grads)
    JDP.set_reaction_rebalance(1, avoid_rank=1)
    with pytest.raises(ValueError, match="partition changed"):
        step(params, state, grads)


# ---------------------------------------------------------------------------
# Two gloo ranks: a seeded straggler, and the twin run
# ---------------------------------------------------------------------------

TRACE_WORKER = r'''
import os, sys
import numpy as np
import torch
out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
os.environ["HOROVOD_TIMELINE"] = f"{out_dir}/tl.json"
os.environ["HOROVOD_TIMELINE_ALL_RANKS"] = "1"
os.environ["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
if r == 1:
    os.environ["HOROVOD_FAULT_SPEC"] = "chaos.straggler_delay:delay:30ms"
    os.environ["HOROVOD_FAULT_SEED"] = "5"
import horovod_tpu_torch as hvd
from horovod_tpu_torch import faults
from horovod_tpu_torch.parallel import data_parallel as dp

hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
rng = np.random.RandomState(r)
leaves = [torch.from_numpy(rng.randn(*s).astype(np.float32))
          for s in [(64, 64), (300,), (128, 32), (1000,)]]
buckets = []
for _ in range(5):
    clock = dp.step_clock()
    dp.allreduce_gradients(leaves, fusion_threshold_bytes=8192)
    buckets.append(len(dp.gradient_bucket_partition(
        leaves, fusion_threshold_bytes=8192)))
    dp.record_step(clock)
res = {"buckets": buckets, "injections": faults.injections()}
hvd.shutdown()
torch.save(res, f"{out_dir}/rank{r}.pt")
'''


@pytest.fixture(scope="module")
def straggler_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("straggler")
    res = run_world(d, 2, TRACE_WORKER)
    return d, res


def test_port_timelines_blame_the_straggler_as_jax(straggler_world):
    d, res = straggler_world
    assert res[0]["injections"] == {}
    assert res[1]["injections"][("chaos.straggler_delay", "delay")] >= 15
    paths = [str(d / "tl.json"), str(d / "tl.rank1.json")]
    traces = PCORE.load_rank_traces(paths)
    assert sorted(traces) == [0, 1]
    got = PCORE.analyze(traces)
    assert got == JCORE.analyze(JCORE.load_rank_traces(paths))
    assert got["summary"]["straggler_rank"] == 1
    assert got["summary"]["steps_analyzed"] == 5
    assert 0.0 < got["summary"]["skew_share"] < 1.0
    for step in got["steps"][1:]:
        assert len(step["buckets"]) == res[0]["buckets"][0] == 4
        assert all(b["blamed_rank"] == 1 and b["wait_ms"] > 10.0
                   for b in step["buckets"])
    merged = PCORE.merge(paths)
    assert merged == JCORE.merge(paths)
    flows = [e for e in merged["traceEvents"] if e.get("cat") == "xrank"]
    assert {e["pid"] for e in flows} == {0, 1}
    tm = PMEAS.TraceMeasurements.from_report(got)
    assert tm.straggler_rank == 1 and tm.wait_ms_per_step > 30.0


TWIN_WORKER = r'''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.models.transformer import lm_loss
from horovod_tpu_torch.parallel import data_parallel as dp

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
cfg = TransformerConfig(vocab_size=64, d_model=64, n_heads=2, d_head=32,
                        d_ff=128, n_layers=2, compute_dtype=torch.float32)
STEPS, ARM = 6, 3


def run(arm):
    model = Transformer(cfg, seed=0)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    rng = np.random.RandomState(10 + r)
    losses, buckets = [], []
    for t in range(STEPS):
        if arm and t == ARM:
            dp.set_reaction_rebalance(1, avoid_rank=1)
        tok = torch.from_numpy(rng.randint(0, 64, (2, 17)))
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model(tok[:, :-1]), tok[:, 1:])
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        buckets.append(len(dp.gradient_bucket_partition(
            grads, fusion_threshold_bytes=16384)))
        red = dp.allreduce_gradients(grads, fusion_threshold_bytes=16384)
        for p, g in zip(model.parameters(), red):
            p.grad = g
        opt.step()
        losses.append(float(loss))
    dp.clear_reaction_rebalance()
    return {"params": [p.detach().clone() for p in model.parameters()],
            "losses": losses, "buckets": buckets}


res = {"plain": run(False), "armed": run(True)}
hvd.shutdown()
torch.save(res, f"{out_dir}/rank{r}.pt")
'''


def test_twin_run_armed_mid_run_is_bitwise_the_plain_run(tmp_path):
    res = run_world(tmp_path, 2, TWIN_WORKER)
    for rec in res:
        plain, armed = rec["plain"], rec["armed"]
        assert plain["buckets"][0] > 1
        assert armed["buckets"] == plain["buckets"][:3] + [1, 1, 1]
        assert armed["losses"] == plain["losses"]
        assert all(np.isfinite(plain["losses"]))
        for a, b in zip(armed["params"], plain["params"]):
            assert torch.equal(a, b)
    for a, b in zip(res[0]["armed"]["params"], res[1]["armed"]["params"]):
        assert torch.equal(a, b)


def test_trace_cli_runs_on_port_rank_files(straggler_world, tmp_path):
    d, _ = straggler_world
    out = tmp_path / "report.json"
    assert port_cli(["analyze", str(d / "tl.json"), str(d / "tl.rank1.json"),
                     "-o", str(out)]) == 0
    assert json.loads(out.read_text())["summary"]["straggler_rank"] == 1
    assert os.path.getsize(out) > 0
