"""The port's chaos soak (`horovod_tpu_torch/faults/chaos.py`) against
the JAX package's (`horovod_tpu/faults/chaos.py`): `build_plan` bitwise
over a grid, then an np=2 soak of each package under its own launcher
at the same settings, side by side (the port's over gloo on the CPU),
held to the invariants of JAX's `_assert_soak_invariants` and
`test_two_process_soak`, the same plan and events, a `final_w` within
FINAL_W_RTOL of the largest |w| of JAX's, and each package's reactions
the one straggler policy's on its windows.  The reactions themselves
differ: the port's step is shorter, so the straggler takes a larger
share of it (ROADMAP, "Reference behaviours"); a second port soak with
the degrade branch off holds JAX's rebalance invariants.  The np=4 soak
is `slow`, as JAX's `TestChaosSoakFleet` is."""

import glob
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from horovod_tpu.faults import chaos as jchaos
from horovod_tpu.trace import core as jcore
from horovod_tpu.trace import reaction as jreaction
from horovod_tpu_torch.faults import chaos as chaos
from horovod_tpu_torch.trace import core as pcore
from horovod_tpu_torch.trace import reaction as preaction

from test_torch_port_collectives import REPO, no_launcher_env  # noqa: F401

# The two packages differ only in summation order (XLA against torch on
# the CPU): 1e-5 of the largest |w| bounds that over 20 SGD steps.
FINAL_W_RTOL = 1e-5

# The reaction's degrade branch off (no skew share reaches it): the
# port's rebalance, its loud re-init and JAX's rebalance invariants.
DEGRADE_OFF = {"HOROVOD_STRAGGLER_SKEW_THRESHOLD": "inf"}

WORKER = r'''
import json, os, sys
import horovod_tpu_torch as hvd
from horovod_tpu_torch.faults.chaos import ChaosSoak

hvd.init(device="cpu")
res = ChaosSoak(seed=int(os.environ.get("HVD_CHAOS_SEED", "7"))).run()
with open(os.path.join(os.environ["HVD_TEST_OUT"],
                       f"rank{hvd.rank()}.json"), "w") as f:
    json.dump(res, f)
hvd.shutdown()
'''


@pytest.mark.parametrize("generations", [1, 3, 5, 8, 12])
@pytest.mark.parametrize("steps", [2, 3, 4, 6])
def test_build_plan_is_jax(generations, steps):
    for n in (1, 2, 4, 5):
        for seed in (0, 7, 123):
            for sg in (0, 2, 4):
                got = chaos.build_plan(generations, steps, n, seed=seed,
                                       straggler_gens=sg)
                want = jchaos.build_plan(generations, steps, n, seed=seed,
                                         straggler_gens=sg)
                assert [tuple(vars(i).values()) for i in got] == \
                    [tuple(vars(i).values()) for i in want]
    assert chaos.KINDS == jchaos.KINDS


def test_soak_refuses_one_step_generations():
    with pytest.raises(ValueError, match=">= 2 steps"):
        chaos.ChaosSoak(steps_per_gen=1)


def _soak_env(out_dir, generations, steps_per_gen, extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    env["HVD_TEST_OUT"] = str(out_dir)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env.update({
        "HOROVOD_TIMELINE": str(out_dir / "tl.json"),
        "HOROVOD_TIMELINE_ALL_RANKS": "1",
        "HOROVOD_TIMELINE_MARK_CYCLES": "1",
        "HOROVOD_TIMELINE_DISABLE_NATIVE": "1",
        "HOROVOD_AUTOTUNE": "1",
        "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
        "HOROVOD_STRAGGLER_PATIENCE": "2",
        "HOROVOD_STRAGGLER_COOLDOWN": "1",
        "HOROVOD_CHAOS_GENERATIONS": str(generations),
        "HOROVOD_CHAOS_STEPS_PER_GEN": str(steps_per_gen),
        "HVD_CHAOS_SEED": "7",
    })
    env.update(extra or {})
    return env


def _soaks(tmp_path, np_, generations, steps_per_gen, timeout, extra=None,
           jax=True):
    """The port's soak and JAX's (tests/data/chaos_main.py) launched side
    by side (`jax=False`: the port's alone); returns ({rank: result} of
    each)."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    worker = tmp_path / "chaos_worker.py"
    worker.write_text(WORKER)
    procs = {
        "port": subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
             str(np_), sys.executable, str(worker)], cwd=REPO,
            env=_soak_env(port_dir, generations, steps_per_gen, extra),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    if jax:
        procs["jax"] = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu.runner", "-np", str(np_),
             "python", os.path.join(REPO, "tests", "data", "chaos_main.py")],
            cwd=REPO, env=_soak_env(jax_dir, generations, steps_per_gen,
                                    extra),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {"jax": None}
    try:
        for name, p in procs.items():
            text, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"{name} soak failed:\n{text[-6000:]}"
            d = port_dir if name == "port" else jax_dir
            out[name] = {r: json.loads((d / f"rank{r}.json").read_text())
                         for r in range(np_)}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out["port"], out["jax"]


def _assert_soak_invariants(res, np_):
    """JAX's `_assert_soak_invariants` (tests/test_multiprocess.py)."""
    for out in res.values():
        assert not out["split_brain"], out
        assert out["final_digest_mismatch"] is None, out
        for ev in out["events"]:
            assert ev["outcome"] in ("recovered", "degraded"), ev
            assert ev["mttr_ms"] >= 0, ev
    for rank in range(1, np_):
        assert res[rank]["final_w"] == res[0]["final_w"], \
            f"rank {rank} params diverged from rank 0"
        assert [(e["kind"], e["gen"], e["step"])
                for e in res[rank]["events"]] == \
            [(e["kind"], e["gen"], e["step"]) for e in res[0]["events"]]
    out0 = res[0]
    assert out0["autotune_enabled"]
    bests = [w["autotune_best"] for w in out0["windows"]
             if w["autotune_best"] is not None]
    assert bests, "autotuner never recorded a window sample"
    assert all(b2 >= b1 for b1, b2 in zip(bests, bests[1:])), bests
    samples = [w["autotune_samples"] for w in out0["windows"]]
    assert samples[-1] >= 1 and samples == sorted(samples), samples


def _policy_reactions(mod, windows):
    """(gen, action, rank) of each reaction package `mod`'s straggler
    policy fires on a soak's windows (the soak's patience and
    cooldown, the threshold from the environment)."""
    policy = mod.StragglerReactionPolicy(
        patience=2, cooldown=1, on_rebalance=lambda rank: None,
        on_degrade=lambda rank: None)
    out = []
    for w in windows:
        if w["skew_share"] is not None:
            d = policy.observe(types.SimpleNamespace(
                straggler_rank=w["straggler_rank"],
                skew_share=w["skew_share"]))
            if d.fired:
                out.append((w["gen"], d.action, d.rank))
    return out


def _reactions(res):
    return [(r["gen"], r["action"], r["rank"]) for r in res[0]["reactions"]]


def _assert_as_jax(port, jres):
    """The same plan, the same events' kinds, steps and outcomes, the
    final parameters within FINAL_W_RTOL of JAX's, and each package's
    reactions what both packages' policies fire on its windows, whose
    skew shares are shares of the critical path."""
    p0, j0 = port[0], jres[0]
    for mod in (preaction, jreaction):
        assert _reactions(port) == _policy_reactions(mod, p0["windows"])
        assert _reactions(jres) == _policy_reactions(mod, j0["windows"])
    assert all(0.0 <= w["skew_share"] <= 1.0 for w in p0["windows"]
               if w["skew_share"] is not None), p0["windows"]
    assert p0["plan"] == j0["plan"]
    assert [(e["kind"], e["gen"], e["step"], e["target"], e["outcome"])
            for e in p0["events"]] == \
        [(e["kind"], e["gen"], e["step"], e["target"], e["outcome"])
         for e in j0["events"]]
    assert p0["straggler_target"] == j0["straggler_target"]
    pw = np.array([p0["final_w"][k] for k in sorted(p0["final_w"])])
    jw = np.array([j0["final_w"][k] for k in sorted(j0["final_w"])])
    assert pw.shape == jw.shape
    tol = FINAL_W_RTOL * np.abs(jw).max()
    assert np.abs(pw - jw).max() <= tol, (np.abs(pw - jw).max(), tol)


def test_two_process_soak(tmp_path):
    res, jres = _soaks(tmp_path, 2, generations=5, steps_per_gen=4,
                       timeout=300)
    _assert_soak_invariants(res, 2)
    _assert_as_jax(res, jres)
    # The port's analysis reads JAX's synchronous buckets as JAX does.
    paths = sorted(glob.glob(str(tmp_path / "jax" / "tl*.json")))
    assert len(paths) == 2
    assert pcore.analyze(pcore.load_rank_traces(paths)) == \
        jcore.analyze(jcore.load_rank_traces(paths))
    out = res[0]
    assert out["straggler_target"] >= 0
    assert any(r["rank"] == out["straggler_target"]
               for r in out["reactions"]), out["reactions"]
    blamed = [w["straggler_rank"] for w in out["windows"]
              if w["straggler_armed"]]
    assert out["straggler_target"] in blamed, out["windows"]
    assert out["loud_reinits"] >= 1, out
    kinds = {e["kind"]: e for e in out["events"]}
    assert "worker_stall" in kinds and "nan_grad" in kinds, kinds
    assert kinds["nan_grad"]["outcome"] == "recovered", kinds
    assert kinds["nan_grad"]["steps_lost"] >= 1, kinds
    assert res[1]["reactions"] == out["reactions"]
    _assert_anomalies(out, detected=False)


def _assert_anomalies(out, detected):
    """JAX's checks of the anomaly monitor; `detected`: at least one
    anomaly caught (JAX's soak catches the stall once its rebalance has
    settled the step time; the port's degraded straggler leaves the
    steps long and uneven, and the stall below the monitor's z)."""
    anom = out["anomaly"]
    assert anom["false_positives"] == 0, anom["events"]
    assert len(anom["detected_kinds"]) >= (1 if detected else 0), anom
    assert set(anom["detected_kinds"]) <= set(anom["injected_kinds"])
    for ev in anom["events"]:
        assert ev["series"] in ("hvd_critical_path_ms", "hvd_steps_total"), ev


def test_two_process_soak_rebalances_with_degrade_off(tmp_path):
    """The port's soak alone with the degrade branch off (DEGRADE_OFF):
    JAX's `test_two_process_soak` rebalance invariants, the straggler
    blamed, rebalanced away from and the fused optimizer re-initialized
    loudly after it."""
    res, _ = _soaks(tmp_path, 2, generations=5, steps_per_gen=4,
                    timeout=300, extra=DEGRADE_OFF, jax=False)
    _assert_soak_invariants(res, 2)
    out = res[0]
    with_env = dict(os.environ)
    os.environ.update(DEGRADE_OFF)
    try:
        assert _reactions(res) == _policy_reactions(preaction,
                                                    out["windows"])
    finally:
        os.environ.clear()
        os.environ.update(with_env)
    assert [r["action"] for r in out["reactions"]][:1] == ["rebalance"], \
        out["reactions"]
    assert out["reactions"][0]["rank"] == out["straggler_target"]
    assert out["loud_reinits"] >= 1, out
    assert res[1]["reactions"] == out["reactions"]
    _assert_anomalies(out, detected=True)


@pytest.mark.slow
def test_four_process_fault_loaded_soak(tmp_path):
    """JAX's TestChaosSoakFleet at np=4: >= 5 fault kinds in one run,
    the reshard drills among them over the launcher's KV.  Its wire
    policy is JAX's test's in the grammar both packages parse ("bf16:
    65536" is refused by both)."""
    res, jres = _soaks(tmp_path, 4, generations=8, steps_per_gen=5,
                       timeout=540, extra={
                           "HOROVOD_WIRE_POLICY": "big=bf16,threshold=65536"})
    _assert_soak_invariants(res, 4)
    _assert_as_jax(res, jres)
    out = res[0]
    assert len(out["kinds_injected"]) >= 5, out["kinds_injected"]
    recovered = {e["kind"] for e in out["events"]
                 if e["outcome"] == "recovered"}
    assert len(recovered) >= 5, out["events"]
    assert any(r["rank"] == out["straggler_target"]
               for r in out["reactions"])
    assert out["loud_reinits"] >= 1, out
