"""Port parity: the serving autoscaler (`horovod_tpu_torch/serve/
autoscale.py`) against the JAX package's `horovod_tpu/serve/
autoscale.py`, a counterpart of each of JAX's tests/test_autoscale.py
cases, and:

- the decision log (every decision, fired or held, as JSON) equal to
  JAX's controller's on the same replayed snapshot sequences;
- `simulate_autoscale`'s records equal to JAX's on every shape of
  `make_shaped_trace`, autoscaled and static;
- the real control loop over a real port fleet on the CPU: grow under
  fire with the joiner killed by `serve.replica_die`, and
  `run_scale_chaos(device="cpu")` at JAX's defaults, all recovered,
  with the events JAX's run records.
"""

import dataclasses
import json
import os
import random

import numpy as np
import pytest
import torch

from horovod_tpu.serve import autoscale as JA
from horovod_tpu.serve import loadgen as JL
import horovod_tpu_torch.faults as _faults
from horovod_tpu_torch.common.exceptions import InvalidRequestError
from horovod_tpu_torch.parallel import reshard as _rs
from horovod_tpu_torch.serve import autoscale as PA
from horovod_tpu_torch.serve.autoscale import (
    AutoscaleConfig,
    AutoscaleController,
    BorrowLedger,
    parse_tenant_classes,
    simulate_autoscale,
)
from horovod_tpu_torch.serve.loadgen import SHAPES, make_shaped_trace
from horovod_tpu_torch.serve.scheduler import ContinuousScheduler, Request

from test_torch_port_collectives import no_launcher_env  # noqa: F401

CLASSES = {"premium": 0, "standard": 1, "batch": 2}


def _kw(**kw):
    base = dict(min_replicas=1, max_replicas=4, cooldown_steps=6,
                dwell_steps=3, occ_high=0.85, occ_low=0.30,
                queue_wait_high_ms=1000.0, tenant_classes=dict(CLASSES))
    base.update(kw)
    return base


def _cfg(**kw):
    return AutoscaleConfig(**_kw(**kw))


def _snap(step, fleet=1, occ=0.5, depth=0, wait=0.0, mod=PA, **kw):
    return mod.SignalSnapshot(step=step, fleet_size=fleet, occupancy=occ,
                              queue_depth=depth, queue_wait_ms=wait,
                              pool_free_frac=1.0 - occ, **kw)


def _pressure(step, fleet=1, **kw):
    return _snap(step, fleet=fleet, occ=0.95, depth=4, **kw)


def _relief(step, fleet=2, **kw):
    return _snap(step, fleet=fleet, occ=0.1, depth=0, **kw)


# -- the decision core (JAX's TestDecisionCore) ------------------------------

def test_dwell_gates_grow():
    c = AutoscaleController(_cfg(dwell_steps=3))
    assert c.observe(_pressure(0)).verdict == "hold"
    assert c.observe(_pressure(1)).verdict == "hold"
    assert c.observe(_pressure(2)).verdict == "grow"


def test_broken_streak_resets_dwell():
    c = AutoscaleController(_cfg(dwell_steps=3))
    c.observe(_pressure(0))
    c.observe(_pressure(1))
    c.observe(_snap(2))
    assert c.observe(_pressure(3)).verdict == "hold"
    assert c.observe(_pressure(4)).verdict == "hold"
    assert c.observe(_pressure(5)).verdict == "grow"


def test_cooldown_suppresses_next_event():
    c = AutoscaleController(_cfg(dwell_steps=1, cooldown_steps=5))
    d, _ = c.step(_pressure(0))
    assert d.verdict == "grow"
    for s in range(1, 6):
        d = c.observe(_pressure(s, fleet=2))
        assert d.verdict == "hold"
        assert "cooldown" in d.reason
    assert c.observe(_pressure(6, fleet=2)).verdict == "grow"


def test_flap_suppression_doubles_reversal_cooldown():
    c = AutoscaleController(_cfg(dwell_steps=1, cooldown_steps=4,
                                 flap_mult=2))
    d, _ = c.step(_pressure(0))
    assert d.verdict == "grow"
    assert c.observe(_relief(6)).verdict == "hold"
    assert c.observe(_relief(8)).verdict == "hold"
    assert c.observe(_relief(9)).verdict == "shrink"


def test_budget_latch_forbids_shrink():
    c = AutoscaleController(_cfg(dwell_steps=1, cooldown_steps=0,
                                 max_replicas=2))
    assert c.observe(_relief(0, breaching=True)).verdict == "hold"
    assert c.observe(_relief(1, burn_fast=1.5)).verdict == "hold"
    assert c.observe(_relief(2)).verdict == "shrink"


def test_min_max_bounds():
    c = AutoscaleController(_cfg(dwell_steps=1, cooldown_steps=0,
                                 max_replicas=2))
    assert c.observe(_relief(0, fleet=1)).verdict == "hold"
    d, _ = c.step(_pressure(1, fleet=2))
    assert d.verdict == "shed"
    d = c.observe(_snap(2, fleet=2, occ=0.95, depth=0))
    assert d.verdict == "hold"


def test_degrade_ladder_borrow_then_shed():
    c = AutoscaleController(_cfg(dwell_steps=1, cooldown_steps=0,
                                 max_replicas=1))
    assert c.observe(_pressure(0, fleet=1, borrowable=1)).verdict == \
        "borrow"
    assert c.observe(_pressure(1, fleet=1, borrowable=0)).verdict == "shed"


def test_handback_before_shrink():
    c = AutoscaleController(_cfg(dwell_steps=1, cooldown_steps=0))
    assert c.observe(_relief(0, fleet=3, borrowed=1)).verdict == "handback"
    assert c.observe(_relief(1, fleet=2, borrowed=0)).verdict == "shrink"


def _log(mod, kw, trace):
    c = mod.AutoscaleController(mod.AutoscaleConfig(**kw))
    for s in trace:
        c.step(mod.SignalSnapshot(**s))
    return json.dumps([dataclasses.asdict(d) for d in c.decisions],
                      sort_keys=True)


def test_replayed_decision_log_identical():
    trace = ([_pressure(s) for s in range(4)]
             + [_snap(s) for s in range(4, 10)]
             + [_relief(s, breaching=(s % 3 == 0)) for s in range(10, 20)])
    trace = [s.as_dict() for s in trace]
    logs = [_log(PA, _kw(), trace) for _ in range(2)]
    assert logs[0] == logs[1] == _log(JA, _kw(), trace)


def _random_trace(seed, n=120):
    """Seeded snapshots in regimes of 2-8 steps (pressure, relief, in
    band, a breach, a long queue wait), the fleet moving by one at
    random, borrowable and borrowed chips now and then."""
    rng = random.Random(seed)
    regimes = {"pressure": (0.95, 4, 0.0), "relief": (0.1, 0, 0.0),
               "band": (0.5, 0, 0.0), "breach": (0.6, 2, 0.0),
               "wait": (0.5, 1, 2500.0)}
    fleet, out, step = 1, [], 0
    while step < n:
        name = rng.choice(sorted(regimes))
        occ, depth, wait = regimes[name]
        for _ in range(rng.randint(2, 8)):
            fleet = max(1, min(6, fleet + rng.choice((-1, 0, 0, 0, 1))))
            out.append(dict(
                step=step, fleet_size=fleet, occupancy=occ,
                queue_depth=depth, queue_wait_ms=wait,
                pool_free_frac=1.0 - occ,
                burn_fast=rng.choice((0.0, 0.5, 1.2)),
                burn_slow=rng.choice((0.0, 0.4)),
                breaching=name == "breach",
                borrowable=rng.choice((0, 0, 1)),
                borrowed=rng.choice((0, 0, 1))))
            step += 1
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kw", [
    {}, {"dwell_steps": 1, "cooldown_steps": 0},
    {"dwell_steps": 2, "cooldown_steps": 3, "flap_mult": 3,
     "max_replicas": 3, "grow_step": 2},
    {"queue_wait_high_ms": 0.0, "min_replicas": 2, "max_replicas": 5}])
def test_decision_log_is_jax_on_replayed_snapshots(seed, kw):
    trace = _random_trace(seed)
    got = _log(PA, _kw(**kw), trace)
    assert got == _log(JA, _kw(**kw), trace)
    assert len({d["verdict"] for d in json.loads(got)}) >= 2


def test_config_validation():
    with pytest.raises(InvalidRequestError):
        _cfg(min_replicas=3, max_replicas=2)
    with pytest.raises(InvalidRequestError):
        _cfg(occ_high=0.2, occ_low=0.5)
    with pytest.raises(InvalidRequestError):
        _cfg(dwell_steps=0)


def test_config_env_knobs(monkeypatch):
    for k, v in {"MIN_REPLICAS": "2", "MAX_REPLICAS": "5",
                 "COOLDOWN": "11", "DWELL": "4", "OCC_HIGH": "0.7",
                 "OCC_LOW": "0.2", "QUEUE_MS": "500",
                 "TENANT_CLASSES": "gold:0,bronze:5"}.items():
        monkeypatch.setenv("HOROVOD_AUTOSCALE_" + k, v)
    cfg = AutoscaleConfig()
    assert (cfg.min_replicas, cfg.max_replicas) == (2, 5)
    assert (cfg.cooldown_steps, cfg.dwell_steps) == (11, 4)
    assert (cfg.occ_high, cfg.occ_low) == (0.7, 0.2)
    assert cfg.queue_wait_high_ms == 500.0
    assert cfg.tenant_classes == {"gold": 0, "bronze": 5}
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JA.AutoscaleConfig())


def test_cooldown_and_dwell_follow_the_tuner(monkeypatch):
    """The tuner's host-only autoscale knobs are the config's defaults
    while it runs (the readers `utils/autotune.py` registered them
    for)."""
    from horovod_tpu_torch.utils import autotune as at

    monkeypatch.setenv("HOROVOD_AUTOSCALE_COOLDOWN", "11")
    monkeypatch.setenv("HOROVOD_AUTOSCALE_DWELL", "4")
    pm = at.ParameterManager()
    pm.register("autoscale_cooldown", 4, 512, log_scale=True, integer=True,
                host_only=True, initial=40)
    pm.register("autoscale_dwell", 1, 128, log_scale=True, integer=True,
                host_only=True, initial=6)
    monkeypatch.setattr(at, "_manager", pm)
    cfg = AutoscaleConfig()
    assert (cfg.cooldown_steps, cfg.dwell_steps) == (40, 6)
    monkeypatch.setattr(at, "_manager", None)
    cfg = AutoscaleConfig()
    assert (cfg.cooldown_steps, cfg.dwell_steps) == (11, 4)


def test_parse_tenant_classes_rejects_garbage():
    for bad in ("premium", "premium:x", ","):
        with pytest.raises(InvalidRequestError):
            parse_tenant_classes(bad)
    assert parse_tenant_classes("a:1, b:0") == JA.parse_tenant_classes(
        "a:1, b:0")


# -- actuation (JAX's TestActuation) -----------------------------------------

class _Fleet:
    def __init__(self, size=1, fail=False):
        self.size = size
        self.fail = fail
        self.sheds = []

    def fleet_size(self):
        return self.size

    def scale_to(self, n):
        if self.fail:
            raise RuntimeError("actuator down")
        self.size = n
        return n

    def shed(self, n):
        self.sheds.append(n)
        return min(n, 2)


def test_scale_event_commits():
    fleet = _Fleet(1)
    c = AutoscaleController(_cfg(dwell_steps=1), actuator=fleet)
    d, ev = c.step(_pressure(0))
    assert (d.verdict, ev.state) == ("grow", "committed")
    assert fleet.size == 2 and ev.converged_size == 2


def test_mid_event_fault_aborts_and_dumps(tmp_path):
    from horovod_tpu_torch.serve.flightrec import FlightRecorder
    from horovod_tpu_torch.utils import timeline as tlm

    rec = FlightRecorder(64, out_dir=str(tmp_path))
    tlm.start_timeline(str(tmp_path / "tl.json"))
    try:
        c = AutoscaleController(_cfg(dwell_steps=1),
                                actuator=_Fleet(1, fail=True),
                                flightrec=rec)
        d, ev = c.step(_pressure(0))
    finally:
        tlm.stop_timeline()
    assert ev.state == "aborted"
    assert ev.converged_size == 1
    dumps = [p for p in os.listdir(tmp_path)
             if p.startswith("serve_flightrec")]
    assert len(dumps) == 1
    payload = json.load(open(tmp_path / dumps[0]))
    assert payload["reason"] == "scale_event_failed"
    kinds = [e["kind"] for e in payload["events"]]
    assert "autoscale" in kinds and "autoscale_abort" in kinds
    text = (tmp_path / "tl.json").read_text()
    assert '"autoscale_event"' in text and '"aborted"' in text
    rec.close()


def test_control_loop_outlives_aborted_events():
    c = AutoscaleController(_cfg(dwell_steps=1, cooldown_steps=0),
                            actuator=_Fleet(1, fail=True))
    for s in range(3):
        _, ev = c.step(_pressure(s))
        assert ev.state == "aborted"
    assert len(c.events) == 3


def test_shed_event_counts():
    fleet = _Fleet(2)
    c = AutoscaleController(_cfg(dwell_steps=1, max_replicas=2),
                            actuator=fleet)
    d, ev = c.step(_pressure(0, fleet=2))
    assert (d.verdict, ev.state) == ("shed", "committed")
    assert fleet.sheds == [4] and c.shed_total == 2
    assert ev.detail == "shed 2 request(s)"


# -- the borrow ledger (JAX's TestBorrowLedger) ------------------------------

def test_borrow_handback_and_close_guarantee():
    lent, returned = [], []
    led = BorrowLedger(lambda n: lent.append(n) or n,
                       lambda n: returned.append(n), capacity=3)
    assert led.borrow(2) == 2
    assert led.borrow(5) == 1
    assert led.outstanding == 3 and led.borrowable() == 0
    assert led.handback(1) == 1
    assert led.close() == 2
    assert led.outstanding == 0 and sum(returned) == sum(lent)


def test_borrow_fault_leaves_ledger_clean():
    def boom(n):
        raise RuntimeError("reshard peer died")
    led = BorrowLedger(boom, lambda n: None, capacity=2)
    c = AutoscaleController(_cfg(dwell_steps=1, max_replicas=1), ledger=led)
    d, ev = c.step(_pressure(0, fleet=1, borrowable=2))
    assert (d.verdict, ev.state) == ("borrow", "aborted")
    assert led.outstanding == 0


def test_close_hands_back_on_drain():
    led = BorrowLedger(lambda n: n, lambda n: None, capacity=2)
    c = AutoscaleController(_cfg(), ledger=led)
    led.borrow(2)
    c.close()
    assert led.outstanding == 0


# -- the real borrow edges (JAX's TestBorrowStashRestore) --------------------

GROUPS = (10, 6)


def _rows(n_old):
    out = []
    for full in (np.arange(10, dtype=np.float32) + 1,
                 np.arange(6, dtype=np.float32) * 0.5 - 1):
        s = -(-full.size // n_old)
        pad = np.zeros(s * n_old, full.dtype)
        pad[:full.size] = full
        out.append(pad.reshape(n_old, s))
    return out


def test_roundtrip_any_world_size():
    from horovod_tpu_torch.serve.handoff import (
        restore_train_state,
        stash_train_state,
    )
    t = _rs.LocalTransport()
    for rank in range(2):
        stash_train_state(_rows(2), GROUPS, 2, rank, t)
    rows = restore_train_state(GROUPS, ("float32", "float32"), 1, 0, t)
    assert np.array_equal(rows[0].numpy().reshape(-1)[:10],
                          np.arange(10, dtype=np.float32) + 1)
    assert np.array_equal(rows[1].numpy().reshape(-1)[:6],
                          np.arange(6, dtype=np.float32) * 0.5 - 1)


def test_peer_die_mid_stash_aborts_borrow():
    from horovod_tpu_torch.serve.handoff import stash_train_state
    t = _rs.LocalTransport()
    _faults.install("reshard.peer_die@1:err")
    try:
        def borrow_fn(n):
            stash_train_state(_rows(2), GROUPS, 2, 0, t)
            return n
        led = BorrowLedger(borrow_fn, lambda n: None, capacity=1)
        c = AutoscaleController(_cfg(dwell_steps=1, max_replicas=1),
                                ledger=led)
        d, ev = c.step(_pressure(0, fleet=1, borrowable=1))
        assert ev.state == "aborted"
        assert led.outstanding == 0
    finally:
        _faults.clear()


# -- the tenant shed (JAX's TestTenantShed) ----------------------------------

def _sched():
    sched = ContinuousScheduler(max_batch=2)
    for i, (cls, arr) in enumerate([("premium", 0), ("batch", 0),
                                    ("standard", 1), ("batch", 2),
                                    ("standard", 3)]):
        sched.submit(Request(req_id=i, prompt=np.ones(4, np.int32),
                             max_new_tokens=2, arrival_step=arr,
                             slo_class=cls), step=arr)
    return sched


def test_shed_order_lowest_class_newest_first():
    sched = _sched()
    shed = sched.shed(10, 4)
    assert [r.req_id for r in shed] == [3, 1, 4, 2]
    assert [r.req_id for r in sched.queue] == [0]
    assert [e for e in sched.decision_log if e[1] == "shed"] == [
        (10, "shed", 3, -1), (10, "shed", 1, -1),
        (10, "shed", 4, -1), (10, "shed", 2, -1)]


def test_shed_never_touches_active():
    sched = _sched()
    sched.admit(5, lambda req: True)
    n_active = len(sched.active)
    queued = sched.queue_depth()
    shed = sched.shed(5, 99)
    assert len(shed) == queued and sched.queue_depth() == 0
    assert len(sched.active) == n_active


def test_unknown_class_sheds_first():
    sched = ContinuousScheduler(max_batch=1)
    for i, cls in enumerate(["standard", "mystery"]):
        sched.submit(Request(req_id=i, prompt=np.ones(2, np.int32),
                             max_new_tokens=1, slo_class=cls), step=0)
    assert [r.req_id for r in sched.shed(1, 1)] == [1]


# -- signals from a live server (JAX's TestSnapshotFromServer) ---------------

def test_live_server_signals():
    from horovod_tpu_torch.models import TransformerConfig, transformer_init
    from horovod_tpu_torch.serve import InferenceServer
    from horovod_tpu_torch.serve.autoscale import snapshot_from_server

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, d_head=8,
                            d_ff=64, n_layers=2, compute_dtype=torch.float32)
    srv = InferenceServer(transformer_init(0, cfg), cfg, max_seq_tokens=24,
                          max_batch=2, page_tokens=4, device="cpu")
    for _ in range(3):
        srv.submit(np.ones(4, np.int32), 2)
    s = snapshot_from_server(srv, step=5, fleet_size=2)
    assert (s.step, s.fleet_size) == (5, 2)
    assert s.queue_depth == 3
    assert s.pool_free_frac == 1.0
    assert s.occupancy == 0.0
    srv.step()
    s = snapshot_from_server(srv)
    assert s.occupancy > 0 and s.pool_free_frac < 1.0
    list(srv.run())
    s = snapshot_from_server(srv)
    assert s.queue_depth == 0 and s.pool_free_frac == 1.0


# -- the shaped traces and the simulator (JAX's TestShapedTraces, TestSimBench)

def test_shapes_deterministic_and_tagged():
    for shape in SHAPES:
        t1 = make_shaped_trace(shape, 3, 50, 64)
        t2 = make_shaped_trace(shape, 3, 50, 64)
        want = JL.make_shaped_trace(shape, 3, 50, 64)
        assert len(t1) == 50
        for a, b, w in zip(t1, t2, want):
            assert a[0] == b[0] == w[0] and a[2] == b[2] == w[2]
            assert a[3] == b[3] == w[3]
            assert np.array_equal(a[1], b[1]) and np.array_equal(a[1], w[1])
        arrivals = [it[0] for it in t1]
        assert arrivals == sorted(arrivals)
        assert all(it[3] in CLASSES for it in t1)


def test_burst_has_clumps():
    from collections import Counter
    t = make_shaped_trace("burst", 0, 120, 64, base_every=4.0,
                          burst_every=32, burst_size=16)
    assert max(Counter(it[0] for it in t).values()) >= 8


def test_multi_tenant_has_all_classes():
    t = make_shaped_trace("multi_tenant", 1, 60, 64)
    assert {it[3] for it in t} == set(CLASSES)


def test_unknown_shape_rejected():
    with pytest.raises(InvalidRequestError):
        make_shaped_trace("sawtooth", 0, 10, 64)


def test_autoscaled_beats_static_on_burst():
    cfg = _cfg(max_replicas=8, cooldown_steps=4, dwell_steps=2, grow_step=2)
    trace = make_shaped_trace("burst", 7, 500, 64, base_every=4.0,
                              burst_every=128, burst_size=80)
    auto = simulate_autoscale(trace, cfg)
    static = simulate_autoscale(
        trace, cfg, static_size=max(1, round(auto["fleet_mean"])))
    assert auto["completed"] == 500
    assert auto["slo_violation_minutes"] < static["slo_violation_minutes"]
    assert abs(auto["fleet_mean"] - static["fleet_mean"]) < 0.5


def test_sim_sheds_by_class_at_max():
    cfg = _cfg(max_replicas=1, cooldown_steps=2, dwell_steps=2)
    trace = make_shaped_trace("burst", 3, 200, 64, base_every=2.0,
                              burst_every=32, burst_size=40)
    rec = simulate_autoscale(trace, cfg, max_batch=2, extra_steps=4096)
    assert rec["shed"] > 0
    assert rec["shed_by_class"].get("batch", 0) > 0
    assert rec["shed_by_class"].get("batch", 0) >= \
        rec["shed_by_class"].get("premium", 0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", [
    {"max_replicas": 8, "cooldown_steps": 4, "dwell_steps": 2,
     "grow_step": 2},
    {"max_replicas": 1, "cooldown_steps": 2, "dwell_steps": 2}])
def test_simulate_autoscale_records_are_jax(shape, kw):
    """The simulator's records (autoscaled, then static at its mean
    size) equal JAX's on the same shaped trace."""
    args = dict(seed=4, n_requests=300, vocab_size=64)
    trace = make_shaped_trace(shape, **args)
    jtrace = JL.make_shaped_trace(shape, **args)
    auto = simulate_autoscale(trace, _cfg(**kw), max_batch=4)
    assert auto == JA.simulate_autoscale(
        jtrace, JA.AutoscaleConfig(**_kw(**kw)), max_batch=4)
    size = max(1, round(auto["fleet_mean"]))
    assert simulate_autoscale(trace, _cfg(**kw), static_size=size,
                              max_batch=4) == \
        JA.simulate_autoscale(jtrace, JA.AutoscaleConfig(**_kw(**kw)),
                              static_size=size, max_batch=4)
    assert auto["completed"] + auto["shed"] == 300


# -- the control loop over a real fleet (JAX's TestAutoscaleScaleChaosE2E) ---

# The lease: JAX's tests take 10 s (a start grace of 20); a replica can
# take longer than that to start on a loaded CPU.
LEASE_TTL = 60.0
CONFIG = {
    "cfg": dict(vocab_size=64, d_model=32, n_heads=4, d_head=8,
                d_ff=64, n_layers=2, compute_dtype="float32"),
    "seed": 0,
    "serve": dict(max_seq_tokens=24, max_batch=2, page_tokens=4,
                  device="cpu"),
}


def _trace():
    return make_shaped_trace("burst", 2, 8, 64, prompt_lens=(4,),
                             max_new_lo=2, max_new_hi=5, base_every=1.0,
                             burst_every=4, burst_size=4)


# Two requests submitted after the grow (the second goes to the joiner,
# long enough that it is still decoding at the beat it dies at).
EXTRA = [([7, 3, 9, 1], 16), ([2, 8, 4, 6], 16)]


def test_grow_under_fire_converges_digest_verified():
    """JAX's e2e with two long requests after the grow, so that the
    joiner dies holding one (JAX's test leaves it to a race whether the
    joiner reaches its third beat before the burst is served)."""
    from horovod_tpu_torch.serve.autoscale import (
        ReplicaFleetActuator,
        snapshot_from_manager,
    )
    from horovod_tpu_torch.serve.replica import ReplicaManager

    with ReplicaManager(1, CONFIG, lease_ttl=LEASE_TTL,
                        respawn_backoff=0.2) as mgr:
        for it in _trace():
            mgr.submit(it[1].tolist(), it[2], slo_class=it[3])
        for prompt, mn in EXTRA:
            mgr.submit(prompt, mn)
        baseline = mgr.wait_all(timeout=180)
    with ReplicaManager(1, CONFIG, lease_ttl=LEASE_TTL,
                        respawn_backoff=0.2) as mgr:
        ctrl = AutoscaleController(
            _cfg(dwell_steps=2, cooldown_steps=2, max_replicas=2),
            actuator=ReplicaFleetActuator(mgr))
        for it in _trace():
            mgr.submit(it[1].tolist(), it[2], slo_class=it[3])
        mgr.child_env.update({
            "HOROVOD_FAULT_SPEC": "serve.replica_die@3:exit:1",
            "HOROVOD_FAULT_HOSTS": "replica1",
        })
        grew = None
        for step in range(64):
            d, ev = ctrl.step(snapshot_from_manager(mgr, step, max_batch=2))
            if ev is not None and d.verdict == "grow":
                grew = ev
                break
        assert grew is not None, [d.verdict for d in ctrl.decisions]
        assert grew.state == "committed" and grew.converged_size == 2
        for prompt, mn in EXTRA:
            mgr.submit(prompt, mn)
        results = mgr.wait_all(timeout=180)
        mgr.child_env.pop("HOROVOD_FAULT_SPEC")
        mgr.child_env.pop("HOROVOD_FAULT_HOSTS")
        assert mgr._respawns >= 1
        assert mgr.fleet_size() == 2
        assert mgr.digest_agreement(timeout=60.0)
        assert results == baseline


def test_run_scale_chaos_all_recover():
    """At JAX's defaults (four events, the joiner of each grow killed)
    but the lease (LEASE_TTL): all recovered, with the events of JAX's
    own run (their sizes, faults and checks; the walls and respawn
    counts are each run's)."""
    rec = PA.run_scale_chaos(lease_ttl=LEASE_TTL, device="cpu")
    assert rec["all_recovered"], rec
    assert any(e["faulted"] for e in rec["events"])
    assert rec["respawns"] >= 1
    jrec = JA.run_scale_chaos(lease_ttl=LEASE_TTL)
    keys = ("event", "faulted", "planned", "converged", "fleet",
            "digest_agreement", "tokens_identical")
    got = [{k: e[k] for k in keys} for e in rec["events"]]
    assert got == [{k: e[k] for k in keys} for e in jrec["events"]]
    assert [e["event"] for e in got] == ["grow", "shrink"] * 2
    assert rec["final_fleet"] == jrec["final_fleet"] == 1
