"""Port parity: elastic multi-replica serving (`horovod_tpu_torch/serve/
replica.py`) against the JAX package's `horovod_tpu/serve/replica.py`.

- JAX's `TestReplicaElastic` and `TestServeObsE2E` (tests/test_serve.py,
  tests/test_serve_obs.py) on the port at their config: two replicas,
  `serve.replica_die@3:exit:1` on replica1, every sequence recovered
  with the no-fault run's tokens (CPU, f32: exact), the dead
  incarnation's flight-recorder dump, the per-replica timelines stitched
  across replicas by both packages' `analyze_serve`.
- The protocol across the packages (the KV keys are JAX's): the port's
  manager drives JAX's replica workers and gets JAX's own manager's
  results, respawns included; JAX's manager drives the port's workers
  and gets the port's manager's results.
- `_params_digest` of a port tree built by `transformer_from_jax(p)`
  is JAX's `_params_digest(p)`, in f32 and in bf16; a fleet of one JAX
  and one port replica fails `digest_agreement` (split brain found).
- `scale_to`, the retire path and `shed` put JAX's KV keys and values
  in JAX's order.
"""

import glob
import json
import os
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import TransformerConfig as JConfig
from horovod_tpu.models import transformer_init as jinit
from horovod_tpu.serve import replica as jrep
from horovod_tpu.trace import core as jcore
from horovod_tpu_torch.models import TransformerConfig, transformer_from_jax
from horovod_tpu_torch.models.transformer import transformer_params
from horovod_tpu_torch.serve import flightrec as pflightrec
from horovod_tpu_torch.serve import replica as prep
from horovod_tpu_torch.trace import core as pcore

from test_torch_port_collectives import REPO, no_launcher_env  # noqa: F401

# tests/test_serve.py TestReplicaElastic's config; the replicas build
# their servers on the CPU.
CONFIG = {
    "cfg": dict(vocab_size=64, d_model=32, n_heads=4, d_head=8,
                d_ff=64, n_layers=2, compute_dtype="float32"),
    "seed": 0,
    "serve": dict(max_seq_tokens=24, max_batch=2, page_tokens=4,
                  device="cpu"),
}
DIE = {"HOROVOD_FAULT_SPEC": "serve.replica_die@3:exit:1",
       "HOROVOD_FAULT_HOSTS": "replica1"}
# The lease: JAX's tests take 10 s (a start grace of 20); a replica of
# either package can take longer than that to start on a loaded CPU.
LEASE_TTL = 60.0

# JAX's replica worker with the config's "device" dropped (the JAX
# server places by JAX_PLATFORMS and takes no such argument).
JAX_WORKER = '''
from horovod_tpu.serve import replica as R

_build = R._build_server


def _build_server(config):
    serve = {k: v for k, v in config.get("serve", {}).items()
             if k != "device"}
    return _build(dict(config, serve=serve))


R._build_server = _build_server
R.main()
'''


def _requests():
    rng = np.random.RandomState(1)
    return [(rng.randint(0, 64, size=4).tolist(), int(rng.randint(2, 6)))
            for _ in range(6)]


def _child_env(tmp_path, extra=None):
    with open(tmp_path / "jax_replica_worker.py", "w") as f:
        f.write(JAX_WORKER)
    env = {"JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(tmp_path), REPO])}
    env.update(extra or {})
    return env


def _spawning(mod, modules):
    """A `subprocess` for package `mod`'s manager whose replica rid runs
    as `python -m modules[rid]` (others as the manager's own worker)."""
    own = mod.__name__

    def popen(args, **kw):
        rid = int(kw["env"]["HOROVOD_SERVE_REPLICA_ID"])
        args = [modules.get(rid, a) if a == own else a for a in args]
        return subprocess.Popen(args, **kw)

    return types.SimpleNamespace(Popen=popen,
                                 TimeoutExpired=subprocess.TimeoutExpired)


class _swapped:
    """Package `mod`'s replica module with its spawns rerouted."""

    def __init__(self, mod, modules):
        self.mod, self.sub = mod, _spawning(mod, modules)

    def __enter__(self):
        self.saved, self.mod.subprocess = self.mod.subprocess, self.sub

    def __exit__(self, *exc):
        self.mod.subprocess = self.saved


def _serve(manager_cls, env):
    """Six requests on two replicas; (results, respawns)."""
    with manager_cls(2, CONFIG, lease_ttl=LEASE_TTL, respawn_backoff=0.2,
                     child_env=env) as mgr:
        for prompt, mn in _requests():
            mgr.submit(prompt, mn)
        results = mgr.wait_all(timeout=180)
        respawns = mgr._respawns
        assert mgr.digest_agreement(timeout=60.0)
    return results, respawns


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's manager and workers: the no-fault run, and the run
    with replica1 killed, its timelines and flight-recorder dumps."""
    d = tmp_path_factory.mktemp("port_replicas")
    base = _serve(prep.ReplicaManager, _child_env(d))
    tl = str(d / "serve_tl.json")
    died = _serve(prep.ReplicaManager, _child_env(d, dict(
        DIE, HOROVOD_TIMELINE=tl, HOROVOD_SERVE_FLIGHTREC_DIR=str(d))))
    return {"base": base, "died": died, "dir": d, "tl": tl}


def test_replica_death_recovers_all_sequences(port_runs):
    """JAX's TestReplicaElastic on the port."""
    baseline, r0 = port_runs["base"]
    recovered, r1 = port_runs["died"]
    assert r0 == 0
    assert len(baseline) == 6
    assert r1 >= 1                      # the dead replica respawned
    assert recovered == baseline        # no lost or garbled sequence


def test_replica_death_dump_and_stitched_trace(port_runs):
    """JAX's TestServeObsE2E on the port: the dead incarnation's dump
    through the fault-exit hook, the per-replica timelines (the dead
    one's kept as `.respawn<k>`) stitched across replicas, each report
    JAX's."""
    d, tl = port_runs["dir"], port_runs["tl"]
    dumps = sorted(glob.glob(str(d / "serve_flightrec.replica1.*.json")))
    assert dumps, "dead replica left no flight-recorder dump"
    payload = pflightrec.load_dump(dumps[0])
    assert payload["reason"] == "fault_exit:serve.replica_die"
    assert payload["replica"] == 1
    assert payload["events"]
    trace = pcore.flightrec_to_trace(payload)
    assert trace == jcore.flightrec_to_trace(payload)
    evs = trace["traceEvents"]
    assert evs and all(e.get("pid") == 1 for e in evs
                       if e.get("ph") in ("X", "i"))
    json.dumps(trace)
    files = sorted(glob.glob(tl + ".rank*"))
    assert len(files) >= 2              # replica0, replica1 (and a respawn)
    report = pcore.analyze_serve(files, align="wall")
    assert report == jcore.analyze_serve(files, align="wall")
    assert report["summary"]["completed"] == 6
    stitched = [r for r in report["requests"] if r["reassigned"]]
    assert stitched, "no request lane spans both replicas"
    for row in stitched:
        assert row["blamed_replica"] == 1
        assert row["completed_by"] is not None
    merged = pcore.merge(files, align="wall", flow=True)
    flow_tids = {e["tid"] for e in merged["traceEvents"]
                 if e.get("cat") == "xrank"
                 and str(e.get("tid", "")).startswith("req/")}
    assert {f"req/{r['req']}" for r in stitched} <= flow_tids
    stats = [e for f in files
             for evs in pcore.load_rank_traces([f]).values()
             for e in evs if e.get("name") == "replica_stats"]
    # Replica0, and replica1's respawn unless the stop came before it
    # had built its model.
    assert 1 <= len(stats) <= 2 and any(s["args"]["served"] for s in stats)
    assert all(s["args"]["peak_mem_gb"] is None for s in stats)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Replica1 killed in three fleets: JAX's manager and workers, the
    port's manager driving JAX's workers, JAX's manager driving the
    port's workers."""
    d = tmp_path_factory.mktemp("cross_replicas")
    env = _child_env(d, DIE)
    jax_workers = {0: "jax_replica_worker", 1: "jax_replica_worker"}
    out = {}
    with _swapped(jrep, jax_workers):
        out["jax"] = _serve(jrep.ReplicaManager, env)
    with _swapped(prep, jax_workers):
        out["port_on_jax"] = _serve(prep.ReplicaManager, env)
    with _swapped(jrep, {0: prep.__name__, 1: prep.__name__}):
        out["jax_on_port"] = _serve(jrep.ReplicaManager, env)
    return out


def test_port_manager_drives_jax_replicas(jax_runs):
    got, respawns = jax_runs["port_on_jax"]
    want, jax_respawns = jax_runs["jax"]
    assert respawns >= 1 and jax_respawns >= 1
    assert len(want) == 6
    assert got == want


def test_jax_manager_drives_port_replicas(jax_runs, port_runs):
    got, respawns = jax_runs["jax_on_port"]
    assert respawns >= 1
    assert got == port_runs["died"][0] == port_runs["base"][0]


def test_mixed_fleet_is_split_brain(tmp_path):
    """One JAX and one port replica of the same config and seed hold
    different weights (each package draws its own): the digest check
    refuses the fleet."""
    with _swapped(prep, {0: "jax_replica_worker"}), prep.ReplicaManager(
            2, CONFIG, lease_ttl=LEASE_TTL,
            child_env=_child_env(tmp_path)) as mgr:
        assert not mgr.digest_agreement(timeout=120.0)
        digests = {r: mgr.kv.get(f"serve/digest/{r}") for r in (0, 1)}
    assert None not in digests.values()
    assert digests[0] != digests[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_digest_is_jax(dtype):
    """A port replica holding `transformer_from_jax(p)` publishes JAX's
    digest of p: leaves in JAX's sorted-key order, numpy dtype names,
    JAX's shape text, bf16's raw bytes."""
    kw = dict(CONFIG["cfg"], compute_dtype=jnp.float32)
    jcfg = JConfig(**kw)
    p = jinit(jax.random.PRNGKey(3), jcfg)
    cfg = TransformerConfig(**dict(kw, compute_dtype=torch.float32))
    tree = transformer_params(transformer_from_jax(
        jax.tree_util.tree_map(np.asarray, p), cfg))
    if dtype == "bfloat16":
        p = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
        tree = _tree_map(lambda t: t.to(torch.bfloat16), tree)
    assert prep._params_digest(tree) == jrep._params_digest(p)
    # Any other tree of the same shapes digests otherwise.
    other = _tree_map(lambda t: t + 1, tree)
    assert prep._params_digest(other) != jrep._params_digest(p)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


class _FakeProc:
    pid = 0

    def poll(self):
        return None

    def wait(self, timeout=None):
        return 0

    def kill(self):
        pass


class _RecordingKV:
    def __init__(self, kv, log):
        self._kv, self._log = kv, log

    def put(self, key, value):
        self._log.append((key, value))
        self._kv.put(key, value)

    def __getattr__(self, name):
        return getattr(self._kv, name)


def _kv_puts(mod):
    """The KV puts of package `mod`'s manager (no processes spawned)
    through submits, a grow, two shrinks (reassigning a retiree's
    unfinished work) and a shed."""
    saved = mod.subprocess
    mod.subprocess = types.SimpleNamespace(
        Popen=lambda *a, **k: _FakeProc(),
        TimeoutExpired=subprocess.TimeoutExpired)
    log = []
    try:
        mgr = mod.ReplicaManager(2, CONFIG)
        try:
            mgr.kv = _RecordingKV(mgr.kv, log)
            for i in range(5):
                mgr.submit([1, 2, i], 3,
                           slo_class=("premium", "standard", "batch")[i % 3])
            mgr.scale_to(3)
            for i in range(3):
                mgr.submit([4, i], 2, slo_class="batch")
            mgr.scale_to(2)
            mgr.scale_to(1)
            shed = mgr.shed(3)
            sizes = (mgr.fleet_size(), mgr.outstanding(), shed)
        finally:
            mgr.server.stop()
    finally:
        mod.subprocess = saved
    return log, sizes


def test_scale_retire_and_shed_keys_are_jax():
    got, got_sizes = _kv_puts(prep)
    want, want_sizes = _kv_puts(jrep)
    assert got == want
    assert got_sizes == want_sizes == (1, 5, 3)
    keys = [k for k, _ in got]
    assert "serve/retire/2" in keys and "serve/retire/1" in keys
    assert sum(k.startswith("serve/cancel/") for k in keys) == 3


def test_manager_refuses_an_empty_fleet():
    with pytest.raises(ValueError, match="n_replicas"):
        prep.ReplicaManager(0, CONFIG)


def test_this_slices_modules_import_neither_jax_nor_the_reference():
    """The replica worker, the handoff, the autoscaler and chip_smoke
    load without JAX and without the JAX package (a fresh
    interpreter)."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import horovod_tpu_torch.serve.replica, "
            "horovod_tpu_torch.serve.handoff, "
            "horovod_tpu_torch.serve.autoscale, chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'horovod_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
