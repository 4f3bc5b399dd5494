"""Port parity: the elastic driver and its control plane
(`horovod_tpu_torch/runner/elastic/`, `runner/elastic_worker.py`,
`_native/`).

- The driver's state machine against the JAX package's: both drivers get
  the same `FixedHosts` sequences, a recording fake transport and KV and
  one fake clock, and run one `_monitor_once` at a time.  Every tick
  compares the generations published (the local coordinator's port
  masked: each driver asks the kernel for a free one), the spawn envs
  (HOROVOD_* only, less the two variables the port does not write and
  the start grace it adds for the workers' bootstrap timeout), the
  registry's states, strikes and blacklist, `reset_count`, the respawn
  budget and backoff, the lease deadlines, the workers terminated and
  the elastic metrics' increments.
- `HostDiscoveryScript` against JAX's on the same script outputs, good
  and bad lines, a failing and a timed-out script.
- The workers' clients across packages: JAX's `refresh_from_control_plane`
  reads a generation the port's driver published, and the reverse; both
  set the same env, but for the port's documented additions.
- The native KV (`_native/`), driven by JAX's Python client and by the
  port's, and answering every request byte for byte as the Python
  engine does; the native timeline writer's events equal the Python
  writer's.
- The joiner's sync: at np=2 over gloo, under HOROVOD_ELASTIC=1, a
  joining rank's `TorchState.sync` leaves its parameters, buffers and
  optimizer `state_dict` bitwise those of the rank that trained (SGD
  with momentum, and Adam), whether the joiner is rank 1 or rank 0.
"""

import importlib
import json
import os
import socket
import stat
import subprocess
import threading
import time
from types import SimpleNamespace

import pytest
import torch

import horovod_tpu.metrics.catalog as JMET
import horovod_tpu.runner.elastic.discovery as JD
import horovod_tpu.runner.elastic.driver as JDRV
import horovod_tpu.runner.elastic_worker as JEW
import horovod_tpu.runner.rendezvous as JR
import horovod_tpu.runner.settings as JS
import horovod_tpu_torch.metrics.catalog as PMET
import horovod_tpu_torch.runner.elastic.discovery as PD
import horovod_tpu_torch.runner.elastic.driver as PDRV
import horovod_tpu_torch.runner.elastic_worker as PEW
import horovod_tpu_torch.runner.rendezvous as PR
import horovod_tpu_torch.runner.settings as PS
from horovod_tpu.common.exceptions import HorovodTpuError as JErr
from horovod_tpu_torch import _native
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import HorovodTpuError as PErr

from test_torch_port_collectives import (  # noqa: F401  (autouse)
    no_launcher_env,
    run_world,
)

PKGS = {"jax": (JDRV, JS, JMET, JErr), "port": (PDRV, PS, PMET, PErr)}
# Written by the JAX package's slot_env only (the port's init chooses
# its backend itself; exec_run.slot_env's docstring).
NOT_WRITTEN = ("HOROVOD_CONTROLLER", "HOROVOD_CPU_OPERATIONS")
# Written by the port's driver only: a worker's bootstrap waits for its
# generation's other ranks about that long (`basics._bootstrap_timeout`).
PORT_ONLY = ("HOROVOD_ELASTIC_START_GRACE",)
METRICS = ("elastic_rank_added", "elastic_rank_removed", "elastic_restarts",
           "elastic_slots", "worker_respawns", "worker_lease_expired",
           "hosts_blacklisted")


# ---------------------------------------------------------------------------
# The driver's state machine, tick by tick
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now

    def sleep(self, _s):
        pass


class _Handle:
    def __init__(self, host, rc=None):
        self.host, self.rc, self.pid = host, rc, 4242
        self.terminated = False

    def poll(self):
        return self.rc


class _Transport:
    def __init__(self, spawn_rc=None, refuse=()):
        self.spawn_rc, self.refuse = spawn_rc, refuse
        self.spawned, self.terminated = [], []

    def command_for(self, slot, settings, env):
        return ["true"]

    def execute(self, cmd, env, prefix):
        host = env["HOROVOD_HOSTNAME"]
        if host in self.refuse:
            raise OSError("ssh: connection refused")
        h = _Handle(host, self.spawn_rc)
        self.spawned.append((host, prefix, {
            k: v for k, v in env.items()
            if k.startswith("HOROVOD_") and k not in NOT_WRITTEN}, h))
        return h

    def terminate(self, handles):
        for h in handles:
            h.terminated, h.rc = True, -15
            self.terminated.append(h.host)


class _KV:
    def __init__(self):
        self.data, self.log = {}, []

    def get(self, key):
        return self.data.get(key)

    def put(self, key, value):
        self.data[key] = value
        self.log.append((key, value))


def _driver(pkg, hosts, transport, monkeypatch, **settings_kw):
    drv, settings_mod, met, _ = PKGS[pkg]
    clock = _Clock()
    monkeypatch.setattr(drv, "time", clock)
    monkeypatch.setattr(met, "_enabled", True)  # whatever ran before
    discovery = (JD if pkg == "jax" else PD).FixedHosts(hosts)
    settings = settings_mod.Settings(
        num_proc=sum(hosts.values()), command=["true"],
        rendezvous_addr="127.0.0.1", rendezvous_port=1, **settings_kw)
    d = drv.ElasticDriver(settings, discovery, transport)
    kv = _KV()
    d.server = SimpleNamespace(kv=lambda: kv, secret="s", stop=lambda: None)
    d._kv = kv
    return d, discovery, clock, kv


def _metric_values(met):
    return {name: getattr(met, name).labels().get() for name in METRICS}


def _mask(info):
    host, port = info["coordinator"].rsplit(":", 1)
    assert int(port) > 0
    if host == "127.0.0.1":
        info = dict(info, coordinator="127.0.0.1:<free port>")
    return info


def _snapshot(d, tr, kv, clock, met, m0, seen):
    infos = [(k, _mask(json.loads(v)) if k.endswith("/info") else v)
             for k, v in kv.log]
    kv.log.clear()
    spawned = [(h, p, {k: v for k, v in env.items() if k not in PORT_ONLY})
               for h, p, env, _ in tr.spawned]
    tr.spawned.clear()
    terminated = sorted(tr.terminated)
    tr.terminated.clear()
    m = _metric_values(met)
    return {
        "published": infos, "spawned": spawned, "terminated": terminated,
        "gen": d.gen, "reset_count": d.reset_count,
        "workers": sorted((k, r, g) for k, (_, r, g) in d.workers.items()),
        "assignments": sorted(d.assignments),
        "finished": sorted(d.finished_slots),
        "states": sorted(d.registry._states.items()),
        "strikes": {h: d.registry.failure_reasons(h) for h in sorted(seen)},
        "blacklist": sorted(d.registry.blacklist()),
        "respawns": dict(d._respawns),
        "respawn_after": {h: round(t - 1000.0, 6)
                          for h, t in d._respawn_after.items()},
        "hb_deadline": {k: round(t - 1000.0, 6)
                        for k, t in d._hb_deadline.items()},
        "need_transition": d._need_transition,
        # counters as increments; the slots gauge as its value
        "metrics": {k: m[k] if k == "elastic_slots" else m[k] - m0[k]
                    for k in m},
    }


def _drive(pkg, monkeypatch, hosts, steps, transport_kw=None,
           **settings_kw):
    """Publish generation 0 and spawn as `run` does, then for each step
    apply its actions and run one `_monitor_once`; return the snapshot
    after the start and after each step."""
    tr = _Transport(**(transport_kw or {}))
    d, disc, clock, kv = _driver(pkg, hosts, tr, monkeypatch, **settings_kw)
    met = PKGS[pkg][2]
    m0 = _metric_values(met)
    seen = set(hosts)
    d._active_hosts = d._discover()
    d._publish_generation(d._compute_assignments(d._active_hosts))
    d._spawn_missing_workers()
    trace = [_snapshot(d, tr, kv, clock, met, m0, seen)]
    beats = {}
    for step in steps:
        clock.now += step.get("dt", 1.5)
        if "hosts" in step:
            disc.set(step["hosts"])
            seen |= set(step["hosts"])
        for host, rc in step.get("exit", {}).items():
            d.workers[(host, 0)][0].rc = rc
        for host in step.get("beat", ()):
            beats[host] = beats.get(host, 0) + 1
            kv.data[f"elastic/heartbeat/{host}:0"] = f"beat-{beats[host]}"
        rc = d._monitor_once()
        for t in threading.enumerate():
            if t.name.startswith("terminate-"):
                t.join(5)
        snap = _snapshot(d, tr, kv, clock, met, m0, seen)
        snap["rc"] = rc
        trace.append(snap)
        if rc is not None:
            break
    return trace


FAKE = "hostA,hostB,hostC"
SCENARIOS = {
    # scale up, a joiner's failure and blacklist, the degraded
    # generation, completion
    "scale_up_fail_degrade": dict(
        hosts={"hostA": 1}, settings={"min_np": 1, "max_np": 3},
        steps=[{"hosts": {"hostA": 1, "hostB": 1}}, {},
               {"exit": {"hostB": 1}}, {}, {"exit": {"hostA": 0}}]),
    # a host leaves discovery: its worker is terminated, the survivor
    # finishes
    "scale_down": dict(
        hosts={"hostA": 1, "hostB": 1}, settings={"min_np": 1},
        steps=[{"hosts": {"hostA": 1}}, {}, {"exit": {"hostA": 0}}]),
    # staggered completion: a finished slot is never respawned and
    # stays out of later generations
    "staggered_finish": dict(
        hosts={"hostA": 1, "hostB": 1}, settings={},
        steps=[{"exit": {"hostB": 0}}, {"hosts": {"hostA": 1, "hostB": 1,
                                                  "hostC": 1}},
               {"exit": {"hostA": 0}}, {"exit": {"hostC": 0}}]),
    "min_np_abort": dict(
        hosts={"hostA": 1, "hostB": 1}, settings={"min_np": 2},
        steps=[{"exit": {"hostB": 1}}]),
    "reset_limit": dict(
        hosts={"hostA": 1}, settings={"reset_limit": 1},
        steps=[{"hosts": {"hostA": 1, "hostB": 1}},
               {"hosts": {"hostA": 1, "hostB": 1, "hostC": 1}}]),
    # workers that die at once: backoff doubling per strike, then the
    # per-host respawn budget blacklists the host and the job aborts
    "respawn_budget": dict(
        hosts={"hostA": 1}, transport={"spawn_rc": 1},
        settings={"lease_ttl": 0.0, "blacklist_threshold": 100,
                  "max_respawns": 2},
        steps=[{"dt": 0.5}] * 4 + [{"dt": 3.0}] * 12),
    # a silent worker's lease expires while its process runs
    "lease_expiry": dict(
        hosts={"hostA": 1, "hostB": 1},
        settings={"min_np": 1, "lease_ttl": 3.0, "lease_start_grace": 4.0},
        steps=[{"beat": ["hostA", "hostB"], "dt": 1.0},
               {"beat": ["hostA"], "dt": 1.0}]
        + [{"beat": ["hostA"], "dt": 1.0}] * 5 + [{"exit": {"hostA": 0}}]),
    # the transport cannot start hostB's worker: a SPAWN strike and a
    # deferred transition
    "spawn_failure": dict(
        hosts={"hostA": 1, "hostB": 1}, transport={"refuse": ("hostB",)},
        settings={"min_np": 1, "blacklist_threshold": 1},
        steps=[{}, {}, {"exit": {"hostA": 0}}]),
    # hosts that are not local: rank 0's coordinator port is hashed from
    # the job's secret and advances with the generation
    # (`nics` pins the advertised address to the loopback interface: no
    # route is probed toward the made-up hosts.)
    "remote_coordinator": dict(
        hosts={"nodeA": 2}, settings={"nics": "lo"}, fake="",
        steps=[{"hosts": {"nodeA": 2, "nodeB": 1}}, {"exit": {"nodeB": 1}}]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_driver_state_machine_matches_jax(name, monkeypatch):
    sc = SCENARIOS[name]
    monkeypatch.setenv("HVD_TPU_FAKE_LOCAL_HOSTS", sc.get("fake", FAKE))
    monkeypatch.delenv("HOROVOD_COORDINATOR_BASE_PORT", raising=False)
    for var in ("HOROVOD_ELASTIC_LEASE_TTL", "HOROVOD_BLACKLIST_THRESHOLD",
                "HOROVOD_RESPAWN_BACKOFF_BASE", "HOROVOD_RESPAWN_BACKOFF_MAX",
                "HOROVOD_MAX_RESPAWNS_PER_HOST",
                "HOROVOD_ELASTIC_START_GRACE"):
        monkeypatch.delenv(var, raising=False)
    traces = {pkg: _drive(pkg, monkeypatch, sc["hosts"], sc["steps"],
                          sc.get("transport"), **sc["settings"])
              for pkg in PKGS}
    assert len(traces["jax"]) == len(traces["port"])
    for i, (j, p) in enumerate(zip(traces["jax"], traces["port"])):
        assert p == j, f"tick {i}"
    last = traces["port"][-1]
    want_rc = {"min_np_abort": 1, "reset_limit": 1, "respawn_budget": 1,
               "remote_coordinator": None}
    assert last.get("rc") == want_rc.get(name, 0)


def test_driver_scenarios_reach_their_states(monkeypatch):
    """What the parity above holds both drivers to, spelled out for three
    scenarios (so that two drivers wrong alike cannot pass)."""
    monkeypatch.setenv("HVD_TPU_FAKE_LOCAL_HOSTS", FAKE)
    sc = SCENARIOS["scale_up_fail_degrade"]
    t = _drive("port", monkeypatch, sc["hosts"], sc["steps"],
               **sc["settings"])
    gens = [v for snap in t for k, v in snap["published"]
            if k.endswith("/info")]
    assert [g["size"] for g in gens] == [1, 2, 1]
    assert gens[1]["assignments"] == {"hostA:0": 0, "hostB:0": 1}
    assert gens[2]["hosts"] == {"hostA": 1}
    joiner = [env for snap in t for h, _, env in snap["spawned"]
              if h == "hostB"]
    assert joiner[0]["HOROVOD_ELASTIC_JOINING"] == "1"
    assert joiner[0]["HOROVOD_ELASTIC_GEN"] == "1"
    assert "HOROVOD_COORDINATOR_ADDR" not in joiner[0]
    assert t[-1]["blacklist"] == ["hostB"] and t[-1]["rc"] == 0
    assert t[-1]["metrics"]["elastic_restarts"] == 2
    assert t[-1]["metrics"]["hosts_blacklisted"] == 1

    sc = SCENARIOS["respawn_budget"]
    t = _drive("port", monkeypatch, sc["hosts"], sc["steps"],
               sc["transport"], **sc["settings"])
    assert t[-1]["rc"] == 1 and t[-1]["respawns"] == {"hostA": 2}
    assert t[-1]["blacklist"] == ["hostA"]
    assert t[-1]["metrics"]["worker_respawns"] == 2
    backoffs = [s["respawn_after"].get("hostA") for s in t]
    # 1, 2, then 4 s after each strike (HOROVOD_RESPAWN_BACKOFF_BASE=1)
    strikes = sorted({b for b in backoffs if b is not None})
    assert len(strikes) == 3

    sc = SCENARIOS["lease_expiry"]
    t = _drive("port", monkeypatch, sc["hosts"], sc["steps"],
               **sc["settings"])
    assert any(s["terminated"] == ["hostB"] for s in t)
    assert t[-1]["strikes"]["hostB"] == {"lease": 1}
    assert t[-1]["metrics"]["worker_lease_expired"] == 1
    assert t[-1]["rc"] == 0


def test_spawn_env_names_the_slot_and_its_generation(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FAKE_LOCAL_HOSTS", FAKE)
    tr = _Transport()
    d, _, _, _ = _driver("port", {"hostA": 2}, tr, monkeypatch,
                         lease_ttl=7.5, lease_start_grace=12.0)
    d._active_hosts = d._discover()
    d._publish_generation(d._compute_assignments(d._active_hosts))
    d._spawn_missing_workers()
    envs = {env["HOROVOD_SLOT"]: env for _, _, env, _ in tr.spawned}
    assert sorted(envs) == ["0", "1"]
    for slot, env in envs.items():
        assert env["HOROVOD_ELASTIC"] == "1"
        assert env["HOROVOD_HOSTNAME"] == "hostA"
        assert env["HOROVOD_ELASTIC_LEASE_TTL"] == "7.5"
        assert env["HOROVOD_ELASTIC_START_GRACE"] == "12.0"
        assert env["HOROVOD_ELASTIC_JOINING"] == "0"
        assert env["HOROVOD_RANK"] == slot == env["HOROVOD_LOCAL_RANK"]
        assert env["HOROVOD_LOCAL_SIZE"] == "2"


# ---------------------------------------------------------------------------
# Host discovery
# ---------------------------------------------------------------------------

def _script(tmp_path, body, name="discover.sh"):
    p = tmp_path / name
    p.write_text("#!/bin/sh\n" + body)
    p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return str(p)


@pytest.mark.parametrize("body,slots", [
    ("echo hostA:2\necho hostB\necho\necho '  hostC:4  '\n", 3),
    ("echo 10.0.0.1:1\necho host-with-dash\n", 1),
    ("true\n", 1),
])
def test_discovery_script_matches_jax(tmp_path, body, slots):
    script = _script(tmp_path, body)
    got = PD.HostDiscoveryScript(script, slots).find_available_hosts_and_slots()
    assert got == JD.HostDiscoveryScript(
        script, slots).find_available_hosts_and_slots()
    if "hostA" in body:
        assert got == {"hostA": 2, "hostB": 3, "hostC": 4}


@pytest.mark.parametrize("body,msg", [
    ("echo hostA:two\n", "bad discovery line 'hostA:two'"),
    ("echo oops >&2\nexit 3\n", "host discovery script failed (rc=3): oops"),
])
def test_discovery_script_errors_match_jax(tmp_path, body, msg):
    script = _script(tmp_path, body)
    with pytest.raises(PErr) as p:
        PD.HostDiscoveryScript(script).find_available_hosts_and_slots()
    with pytest.raises(JErr) as j:
        JD.HostDiscoveryScript(script).find_available_hosts_and_slots()
    assert str(p.value) == str(j.value) == msg


def test_discovery_script_timeout_matches_jax(monkeypatch):
    def expire(*a, **k):
        raise subprocess.TimeoutExpired("discover.sh", 60)

    monkeypatch.setattr(subprocess, "run", expire)
    with pytest.raises(PErr) as p:
        PD.HostDiscoveryScript("discover.sh").find_available_hosts_and_slots()
    with pytest.raises(JErr) as j:
        JD.HostDiscoveryScript("discover.sh").find_available_hosts_and_slots()
    assert str(p.value) == str(j.value) == \
        "host discovery script timed out: discover.sh"


# ---------------------------------------------------------------------------
# The workers' clients across packages
# ---------------------------------------------------------------------------

TOPOLOGY = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_NUM_PROCESSES",
            "HOROVOD_PROCESS_ID", "HOROVOD_COORDINATOR_ADDR",
            "HOROVOD_LOCAL_RANK", "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
            "HOROVOD_CROSS_SIZE")


@pytest.fixture
def clean_env(monkeypatch):
    saved = dict(os.environ)
    for k in TOPOLOGY:
        monkeypatch.delenv(k, raising=False)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _published_server(pkg, monkeypatch, hosts):
    """A real rendezvous server of `pkg` with generation 0 of `hosts`
    published by that package's driver."""
    drv = PKGS[pkg][0]
    server = (JR if pkg == "jax" else PR).RendezvousServer(
        prefer_native=False)
    port = server.start()
    d, _, _, _ = _driver(pkg, hosts, _Transport(), monkeypatch)
    d.server = server
    d._publish_generation(d._compute_assignments(hosts))
    del drv
    return server, port


def _refresh(mod, port, secret, host, slot, monkeypatch):
    for k in TOPOLOGY:
        os.environ.pop(k, None)
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_PORT", str(port))
    monkeypatch.setenv("HOROVOD_SECRET_KEY", secret)
    monkeypatch.setenv("HOROVOD_HOSTNAME", host)
    monkeypatch.setenv("HOROVOD_SLOT", str(slot))
    info = mod.refresh_from_control_plane(timeout=5)
    return info, {k: os.environ.get(k) for k in TOPOLOGY}


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_refresh_reads_either_drivers_generation(server_pkg, monkeypatch,
                                                 clean_env):
    monkeypatch.setenv("HVD_TPU_FAKE_LOCAL_HOSTS", FAKE)
    monkeypatch.setenv("HVD_TPU_MULTIPROCESS_JAX", "1")
    server, port = _published_server(server_pkg, monkeypatch,
                                     {"hostA": 2, "hostB": 1})
    try:
        for host, slot in (("hostA", 0), ("hostA", 1), ("hostB", 0)):
            ji, jenv = _refresh(JEW, port, server.secret, host, slot,
                                monkeypatch)
            pi, penv = _refresh(PEW, port, server.secret, host, slot,
                                monkeypatch)
            assert pi == ji and JEW._known_gen == PEW._known_gen == 0
            # The port adds the local and cross topology of the
            # generation (so survivors and joiners choose one backend).
            assert {k: penv[k] for k in jenv if jenv[k] is not None} == \
                {k: v for k, v in jenv.items() if v is not None}
            rank = ji["assignments"][f"{host}:{slot}"]
            assert penv["HOROVOD_RANK"] == str(rank)
            assert penv["HOROVOD_COORDINATOR_ADDR"] == ji["coordinator"]
            # hostA and hostB are this machine (the fake-cluster hook)
            assert penv["HOROVOD_LOCAL_SIZE"] == "3"
            assert penv["HOROVOD_LOCAL_RANK"] == str(rank)
            assert server.kv().get(f"elastic/gen/0/ready/{rank}") == "1"
    finally:
        server.stop()


def test_refresh_of_a_one_rank_generation_drops_the_coordinator(
        monkeypatch, clean_env):
    monkeypatch.setenv("HVD_TPU_FAKE_LOCAL_HOSTS", FAKE)
    server, port = _published_server("port", monkeypatch, {"hostA": 1})
    try:
        os.environ["HOROVOD_COORDINATOR_ADDR"] = "127.0.0.1:1"
        _, env = _refresh(PEW, port, server.secret, "hostA", 0, monkeypatch)
        assert env["HOROVOD_COORDINATOR_ADDR"] is None
        assert env["HOROVOD_SIZE"] == "1" and env["HOROVOD_RANK"] == "0"
        with pytest.raises(SystemExit) as e:  # not in the generation
            _refresh(PEW, port, server.secret, "hostB", 0, monkeypatch)
        assert e.value.code == 0
    finally:
        server.stop()


def test_generation_env_is_the_drivers_slot_annotation(monkeypatch):
    """Local and cross rank and size from a generation's info are what
    the driver's `annotate_slots` gave each slot: the backend a rank
    chooses (HOROVOD_LOCAL_SIZE) is the same on survivors and joiners.
    Under the fake-cluster hook its hosts are one machine."""
    from horovod_tpu_torch.runner.hosts import HostInfo, get_host_assignments

    monkeypatch.delenv("HVD_TPU_FAKE_LOCAL_HOSTS", raising=False)

    slots = get_host_assignments([HostInfo("hostA", 2), HostInfo("hostB", 3),
                                  HostInfo("hostC", 1)], 6, 6)
    info = {"size": 6, "assignments": {f"{s.hostname}:{s.local_rank}": s.rank
                                       for s in slots},
            "hosts": {s.hostname: s.local_size for s in slots}}
    for s in slots:
        env = PEW._generation_env(info, f"{s.hostname}:{s.local_rank}")
        assert env == {
            "HOROVOD_RANK": str(s.rank), "HOROVOD_SIZE": "6",
            "HOROVOD_NUM_PROCESSES": "6", "HOROVOD_PROCESS_ID": str(s.rank),
            "HOROVOD_LOCAL_RANK": str(s.local_rank),
            "HOROVOD_LOCAL_SIZE": str(s.local_size),
            "HOROVOD_CROSS_RANK": str(s.cross_rank),
            "HOROVOD_CROSS_SIZE": str(s.cross_size)}
    monkeypatch.setenv("HVD_TPU_FAKE_LOCAL_HOSTS", "hostA,hostC")
    env = {s.rank: PEW._generation_env(info, f"{s.hostname}:{s.local_rank}")
           for s in slots}
    # hostA's ranks 0, 1 and hostC's rank 5 share this machine
    assert [(env[r]["HOROVOD_LOCAL_RANK"], env[r]["HOROVOD_LOCAL_SIZE"],
             env[r]["HOROVOD_CROSS_SIZE"]) for r in (0, 1, 5)] == \
        [("0", "3", "1"), ("1", "3", "1"), ("2", "3", "1")]
    assert env[3]["HOROVOD_LOCAL_SIZE"] == "3"  # hostB: its own 3 slots


def test_a_new_generation_drops_the_cached_store(monkeypatch, clean_env):
    """Each generation has its own coordinator: a rank that served the
    last one's TCPStore must not serve the next group from it.  The same
    generation again (an in-place reset) keeps the store."""
    monkeypatch.setenv("HVD_TPU_FAKE_LOCAL_HOSTS", FAKE)
    server, port = _published_server("port", monkeypatch,
                                     {"hostA": 1, "hostB": 1})
    sentinel = object()
    try:
        _refresh(PEW, port, server.secret, "hostA", 0, monkeypatch)
        monkeypatch.setattr(basics, "_store", sentinel)
        monkeypatch.setattr(basics, "_store_key", ("tcp://x:1", 2))
        _refresh(PEW, port, server.secret, "hostA", 0, monkeypatch)
        assert basics._store is sentinel
        server.kv().put("elastic/gen/1/info", server.kv().get(
            "elastic/gen/0/info"))
        server.kv().put("elastic/current_gen", "1")
        _refresh(PEW, port, server.secret, "hostA", 0, monkeypatch)
        assert basics._store is None and basics._store_key is None
    finally:
        server.stop()


def test_watch_announces_each_new_generation_once(monkeypatch, clean_env):
    """The watch announces a newer generation once; a refresh drops the
    announcements it has made stale, and the watch announces again a
    generation newer than the one the refresh joined."""
    TE = importlib.import_module("horovod_tpu_torch.elastic")
    monkeypatch.setenv("HVD_TPU_FAKE_LOCAL_HOSTS", FAKE)
    monkeypatch.setattr(PEW, "_POLL_INTERVAL_S", 0.02)
    stop = threading.Event()

    class _Stop(BaseException):
        pass

    def sleep(s):
        if stop.is_set():
            raise _Stop  # ends the watch thread
        time.sleep(s)

    monkeypatch.setattr(PEW, "time", SimpleNamespace(
        time=time.time, monotonic=time.monotonic, sleep=sleep))
    server, port = _published_server("port", monkeypatch, {"hostA": 1})
    kv = server.kv()
    info0 = kv.get("elastic/gen/0/info")
    def poll():
        try:
            PEW._poll_loop()
        except _Stop:
            pass

    watch = threading.Thread(target=poll, daemon=True)
    try:
        _refresh(PEW, port, server.secret, "hostA", 0, monkeypatch)
        TE.drop_host_updates()
        watch.start()
        time.sleep(0.2)
        assert TE._host_update_queue.qsize() == 0
        for g in (1, 2):
            kv.put(f"elastic/gen/{g}/info", info0)
        kv.put("elastic/current_gen", "1")
        time.sleep(0.2)
        assert TE._host_update_queue.qsize() == 1
        kv.put("elastic/current_gen", "2")
        time.sleep(0.2)
        assert TE._host_update_queue.qsize() == 2
        assert PEW.refresh_from_control_plane(timeout=5)["size"] == 1
        assert TE._host_update_queue.qsize() == 0 and PEW._known_gen == 2
        time.sleep(0.2)
        assert TE._host_update_queue.qsize() == 0
        # bounded wait for a generation newer than the one joined
        t0 = time.monotonic()
        assert not PEW.await_next_generation(0.3)
        assert 0.3 <= time.monotonic() - t0 < 3
        threading.Timer(0.2, kv.put, ("elastic/current_gen", "3")).start()
        kv.put("elastic/gen/3/info", info0)
        assert PEW.await_next_generation(5)
        time.sleep(0.2)
        assert TE._host_update_queue.qsize() == 1
    finally:
        stop.set()
        if watch.is_alive():
            watch.join(5)
        PEW._known_gen = PEW._announced_gen = -1
        TE.drop_host_updates()
        server.stop()


# ---------------------------------------------------------------------------
# The native control plane
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def native_lib():
    lib = _native.load()
    if lib is None:
        pytest.fail("the native control plane did not build with g++")
    return lib


def _raw(port, line: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(line)
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
        return buf


NATIVE_REQUESTS = [
    {"op": "PING"},
    {"op": "PUT", "key": "a/1", "value": "v1"},
    {"op": "PUT", "key": "a/2",
     "value": 'quote " slash \\ nl \n tab \t cr \r ctl \x01 json {"k": [1]}'},
    {"op": "GET", "key": "a/2"},
    {"op": "GET", "key": "missing"},
    {"op": "KEYS", "prefix": "a/"},
    {"op": "KEYS", "prefix": "none/"},
    {"op": "WAIT", "key": "a/1", "timeout": 1.0},
    {"op": "WAIT", "key": "never", "timeout": 0.2},
    {"op": "DEL", "key": "a/1"},
    {"op": "DEL", "key": "a/1"},
    {"op": "BARRIER", "name": "b", "count": 1, "timeout": 1.0},
    {"op": "BARRIER", "name": "b2", "count": 2, "timeout": 0.2},
]


def test_native_kv_answers_byte_for_byte_as_the_python_engine(native_lib):
    secret = PR.new_secret()
    servers = {"python": PR.RendezvousServer(secret, prefer_native=False),
               "native": PR.RendezvousServer(secret)}
    ports = {k: s.start() for k, s in servers.items()}
    try:
        assert servers["native"]._native is not None
        assert servers["python"]._native is None
        for req in NATIVE_REQUESTS:
            line = PR._encode(secret, req)
            assert line == JR._encode(secret, req)
            got = {k: _raw(p, line) for k, p in ports.items()}
            assert got["native"] == got["python"], req
            assert JR._decode(secret, got["native"])["ok"] in (True, False)
        # A message that fails the HMAC: the same refusal, then the close.
        bad = PR._encode("another secret", {"op": "PING"})
        got = {k: _raw(p, bad) for k, p in ports.items()}
        assert got["native"] == got["python"]
        assert "HMAC" in PR._decode(secret, got["native"])["error"]
    finally:
        for s in servers.values():
            s.stop()


@pytest.mark.parametrize("lengths", [range(0, 200), (255, 256, 257, 1000),
                                     (4103, (1 << 20) + 13, 4 << 20)])
def test_native_kv_answers_values_of_every_length_byte_for_byte(
        native_lib, lengths):
    """Values across the hash's 64-byte blocks and the envelope's base64
    groups, megabytes long as a reshard payload is (the engine hashes a
    run of whole blocks at once, with the x86 SHA extensions where the
    CPU has them): every PUT and GET answer byte for byte the Python
    engine's."""
    import random

    rng = random.Random(len(lengths))
    secret = PR.new_secret()
    servers = {"python": PR.RendezvousServer(secret, prefer_native=False),
               "native": PR.RendezvousServer(secret)}
    ports = {k: s.start() for k, s in servers.items()}
    try:
        for n in lengths:
            value = "".join(rng.choice('ab+/=9"\\\n\x01')
                            for _ in range(min(n, 512)))
            value = (value * (n // max(1, len(value)) + 1))[:n]
            for req in ({"op": "PUT", "key": f"v/{n}", "value": value},
                        {"op": "GET", "key": f"v/{n}"}):
                line = PR._encode(secret, req)
                got = {k: _raw(p, line) for k, p in ports.items()}
                assert got["native"] == got["python"], (n, req["op"])
            assert PR._decode(secret, got["native"])["value"] == value
    finally:
        for s in servers.values():
            s.stop()


def test_native_kv_serves_both_packages_clients(native_lib):
    server = PR.RendezvousServer()
    port = server.start()
    try:
        assert server._native is not None
        jc = JR.RendezvousClient("127.0.0.1", port, server.secret)
        pc = PR.RendezvousClient("127.0.0.1", port, server.secret)
        jc.put("x/1", "from jax")
        pc.put("x/2", "from the port")
        assert pc.get("x/1") == "from jax" and jc.get("x/2") == "from the port"
        assert jc.keys("x/") == pc.keys("x/") == ["x/1", "x/2"]
        assert server.kv().keys("x/") == ["x/1", "x/2"]
        threading.Timer(0.2, jc.put, ("late", "v")).start()
        assert pc.wait("late", 5) == "v"
        with pytest.raises(PErr, match="timeout waiting nope"):
            pc.wait("nope", 0.2)
        done = []
        t = threading.Thread(target=lambda: done.append(
            jc.barrier("bar", 2, 5)))
        t.start()
        pc.barrier("bar", 2, 5)
        t.join(5)
        assert done == [None]
        assert jc.delete("x/1") and not pc.delete("x/1")
        assert jc.ping() and pc.ping()
        # LEASE is not served by the engine: renewal is best-effort.
        assert not pc.renew_lease("worker/hostA:0", 1.0)
        assert not jc.renew_lease("worker/hostA:0", 1.0)
    finally:
        server.stop()


def test_native_timeline_events_equal_the_python_writers(native_lib,
                                                          tmp_path):
    from horovod_tpu_torch.utils import timeline as TL

    records = [
        {"name": "ALLREDUCE", "cat": "collective", "ph": "X", "ts": 1.5,
         "dur": 20.3, "pid": 0, "tid": "grad/0", "step": 3},
        {"name": "CYCLE_1", "cat": "cycle", "ph": "i", "s": "p",
         "ts": 30.0, "pid": 1, "tid": "cycle", "step": 1},
        {"name": "wire_bucket_0", "cat": "wire", "ph": "i", "s": "p",
         "ts": 41.1, "pid": 1, "tid": "wire",
         "args": {"codec": "int8", "bytes": 1024, "quote": 'a"b\\c'}},
        {"name": "step", "cat": "step", "ph": "X", "ts": 50.0, "dur": 7.5,
         "pid": 0, "tid": "req/7", "args": {"n": [1, 2]}, "id": 9},
    ]
    paths = {"python": tmp_path / "py.json", "native": tmp_path / "nat.json"}
    writers = {"python": TL._TimelineWriter(str(paths["python"])),
               "native": TL._NativeWriterAdapter(str(paths["native"]))}
    for rec in records:
        for w in writers.values():
            w.enqueue(dict(rec))
    for w in writers.values():
        w.close()
    events = {k: json.loads(p.read_text()) for k, p in paths.items()}
    assert events["native"] == events["python"] == records


def test_the_timeline_takes_the_native_writer_when_it_is_built(
        native_lib, tmp_path, monkeypatch):
    from horovod_tpu_torch.utils import timeline as TL

    tl = TL.Timeline(str(tmp_path / "a.json"))
    assert isinstance(tl._writer, TL._NativeWriterAdapter)
    tl.instant("x")
    tl.close()
    assert json.loads((tmp_path / "a.json").read_text())[0]["name"] == "x"
    monkeypatch.setenv("HOROVOD_TIMELINE_DISABLE_NATIVE", "1")
    tl = TL.Timeline(str(tmp_path / "b.json"))
    assert isinstance(tl._writer, TL._TimelineWriter)
    tl.close()


# ---------------------------------------------------------------------------
# The joiner's sync: a fresh rank takes the trained rank's state bitwise
# ---------------------------------------------------------------------------

JOINER = r'''
import hashlib, os, sys
import torch
import horovod_tpu_torch as hvd

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
TRAINED = int(os.environ["TEST_TRAINED_RANK"])
# As the elastic driver spawns them: the other rank joins a running job.
os.environ["HOROVOD_ELASTIC"] = "1"
os.environ["HOROVOD_ELASTIC_JOINING"] = "0" if r == TRAINED else "1"
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")

def digest(model, opt):
    sd = opt.state_dict()
    return {"params": {k: v.numpy().tobytes()
                       for k, v in model.state_dict().items()},
            "state": {i: {k: (v.numpy().tobytes() if torch.is_tensor(v) else v)
                          for k, v in st.items()}
                      for i, st in sd["state"].items()},
            "groups": sd["param_groups"]}

out = {}
for name, make in (("sgd", lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9,
                                                     weight_decay=1e-2)),
                   ("adam", lambda p: torch.optim.Adam(p, lr=1e-3 * (r + 1)))):
    torch.manual_seed(10 + r)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4),
                                torch.nn.Flatten(), torch.nn.Linear(4 * 6 * 6, 2))
    opt = make(model.parameters())
    if r == TRAINED:  # it has trained alone: momentum, running stats
        for i in range(3):
            opt.zero_grad()
            x = torch.randn(4, 3, 8, 8, generator=torch.Generator().manual_seed(i))
            model(x).square().mean().backward()
            opt.step()
    dopt = hvd.DistributedOptimizer(opt, named_parameters=model.named_parameters())
    state = hvd.elastic.TorchState(model, dopt, epoch=5 if r == TRAINED else 0)
    before = len(opt.state_dict()["state"])
    state.sync()
    out[name] = (before, state.epoch, digest(model, opt))
    # one more step after the sync: the ranks stay equal
    dopt.zero_grad()
    model(torch.ones(2, 3, 8, 8)).sum().backward()
    dopt.step()
    out[name + "_after"] = digest(model, opt)["params"]
torch.save(out, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.mark.parametrize("trained", [0, 1],
                         ids=["joiner_rank1", "joiner_rank0"])
def test_a_joiners_sync_takes_the_trained_ranks_state_bitwise(
        tmp_path, monkeypatch, trained):
    """The driver gives out ranks in host-name order, so a joiner can be
    rank 0: the sync's root is then rank 1, the rank that holds the
    job's state (`elastic._sync_root`)."""
    monkeypatch.setenv("TEST_TRAINED_RANK", str(trained))
    res = run_world(tmp_path, 2, JOINER, timeout=180)
    fresh = 1 - trained
    for name in ("sgd", "adam"):
        (bt, et, dt), (bf, ef, df) = res[trained][name], res[fresh][name]
        assert bt == 6 and bf == 0  # conv, batch norm, linear: w and b
        assert et == ef == 5
        assert df == dt
        assert res[0][name + "_after"] == res[1][name + "_after"]
