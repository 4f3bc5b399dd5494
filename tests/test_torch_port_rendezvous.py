"""The port's rendezvous KV (`horovod_tpu_torch/runner/rendezvous.py`)
against the JAX package's: the HMAC envelope byte for byte, a port
client against a JAX server and a JAX client against a port server for
every op, the refusal of a wrong secret, the fault points and their
retry policy, the heartbeat and its lease, the lease-based `/healthz`,
and `python -m horovod_tpu_torch.metrics --kv` reading a fleet from the
KV."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from horovod_tpu import faults as JF
from horovod_tpu.metrics import exposition as JEXP
from horovod_tpu.metrics import fleet as JFLEET
from horovod_tpu.runner import elastic_worker as JEW
from horovod_tpu.runner import rendezvous as JR
from horovod_tpu_torch import faults as PF
from horovod_tpu_torch.common.exceptions import HorovodTpuError as PErr
from horovod_tpu_torch.metrics import exposition as PEXP
from horovod_tpu_torch.metrics import fleet as PFLEET
from horovod_tpu_torch.runner import elastic_worker as PEW
from horovod_tpu_torch.runner import rendezvous as PR

from test_torch_port_collectives import no_launcher_env  # noqa: F401

PKG = {"jax": (JR, JF), "port": (PR, PF)}

PAYLOADS = [
    {"op": "PING"},
    {"op": "PUT", "key": "a/b", "value": "x" * 100},
    {"op": "BARRIER", "name": "n", "count": 3, "timeout": 2.5,
     "participants": ["worker/h:0", "worker/h:1"]},
    {"ok": True, "keys": ["k/0", "k/1"], "value": "é ✓ \n"},
    {"ok": False, "error": "timeout waiting k"},
]


@pytest.mark.parametrize("obj", PAYLOADS)
def test_envelope_is_the_jax_bytes(obj):
    secret = "s3cr3t-" + str(len(json.dumps(obj)))
    line = PR._encode(secret, obj)
    assert line == JR._encode(secret, obj)
    assert PR._decode(secret, line) == obj == JR._decode(secret, line)
    payload = json.dumps(obj, separators=(",", ":")).encode()
    assert PR._sign(secret, payload) == JR._sign(secret, payload)


def test_decode_refuses_a_wrong_secret_and_garbage():
    line = JR._encode("right", {"op": "PING"})
    for bad in (line, b"garbage", b"\xff\xfe zzz"):
        with pytest.raises(PErr) as pe:
            PR._decode("wrong", bad)
        with pytest.raises(JR.HorovodTpuError) as je:
            JR._decode("wrong", bad)
        assert str(pe.value) == str(je.value)


def _policy(pkg):
    return PKG[pkg][1].RetryPolicy(max_attempts=6, base_delay=0.001,
                                   max_delay=0.002, jitter=0.0)


@pytest.fixture(params=[("jax", "port"), ("port", "jax"),
                        ("port", "port")], ids=lambda p: "-".join(p))
def pair(request):
    """(server, client) of the named packages: a JAX server and a port
    client, a port server and a JAX client, both of the port."""
    srv_pkg, cli_pkg = request.param
    server = PKG[srv_pkg][0].RendezvousServer(prefer_native=False)
    port = server.start()
    client = PKG[cli_pkg][0].RendezvousClient(
        "127.0.0.1", port, server.secret, retry=_policy(cli_pkg))
    yield server, client
    server.stop()


def test_every_op_across_the_packages(pair):
    server, c = pair
    assert c.ping()
    c.put("job/a", "1")
    c.put("job/b", "2")
    c.put("other", "3")
    assert c.get("job/a") == "1" and c.get("missing") is None
    assert c.keys("job/") == ["job/a", "job/b"]
    assert c.wait("job/b", timeout=1.0) == "2"
    threading.Timer(0.2, lambda: server.kv().put("late", "v")).start()
    assert c.wait("late", timeout=5.0) == "v"
    t0 = time.monotonic()
    with pytest.raises(Exception, match="timeout waiting never"):
        c.wait("never", timeout=0.3)
    assert time.monotonic() - t0 < 3.0
    assert c.delete("job/a") is True and c.delete("job/a") is False
    assert server.kv().keys("job/") == ["job/b"]

    # A barrier of two: the other arrival through the server's store.
    other = threading.Thread(target=server.kv().barrier,
                             args=("b2", 2, 5.0))
    other.start()
    c.barrier("b2", 2, timeout=5.0)
    other.join(timeout=5)
    assert not other.is_alive()
    with pytest.raises(Exception, match="barrier timeout"):
        c.barrier("b-alone", 2, timeout=0.3)

    # A lease that expires: renewed, lapsed, and a barrier naming it
    # fails within a lease wake-up, not its timeout.
    assert c.renew_lease("worker/h:0", 0.3)
    assert not server.store.lease_expired("worker/h:0")
    time.sleep(0.4)
    assert server.store.lease_expired("worker/h:0")
    t0 = time.monotonic()
    with pytest.raises(Exception, match="barrier timeout"):
        c.barrier("b-lease", 2, timeout=20.0, participants=["worker/h:0"])
    assert time.monotonic() - t0 < 5.0


def test_a_wrong_secret_is_refused(pair):
    server, c = pair
    c.put("k", "v")
    bad = type(c)("127.0.0.1", server.port, "not-the-secret",
                  retry=c.retry)
    with pytest.raises(Exception, match="HMAC verification"):
        bad.put("k", "forged")
    assert not bad.ping()
    assert server.kv().get("k") == "v"


def _connect_hits(pkg, spec, seeds):
    """For each seed, put once through `pkg`'s client under `spec`:
    (connect hits, whether the put landed)."""
    R, F = PKG[pkg]
    server = R.RendezvousServer(prefer_native=False)
    port = server.start()
    out = []
    try:
        c = R.RendezvousClient("127.0.0.1", port, server.secret,
                               retry=_policy(pkg))
        for seed in seeds:
            server.kv().delete("k")
            F.install(spec, seed=seed)
            try:
                c.put("k", "v")
            except F.FaultInjected:
                pass
            finally:
                hits = F.points_hit("rendezvous.connect")
                F.clear()
            out.append((hits, server.kv().get("k")))
        return out
    finally:
        server.stop()


def test_a_connect_fault_is_retried_by_the_policy_as_in_jax():
    """The same spec and seed fault the same connects in both packages,
    and the policy retries them (six attempts)."""
    spec = "rendezvous.connect:err:0.5"
    seeds = list(range(16))
    got = _connect_hits("port", spec, seeds)
    assert got == _connect_hits("jax", spec, seeds)
    assert any(hits > 1 and landed == "v" for hits, landed in got)
    assert all(landed == "v" or hits == 6 for hits, landed in got)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_put_fault_raises_and_sends_nothing(pkg):
    """PUT is not idempotent: its fault point fires before the request,
    and nothing re-sends it (the caller decides)."""
    R, F = PKG[pkg]
    server = R.RendezvousServer(prefer_native=False)
    port = server.start()
    F.install("rendezvous.put:err")
    try:
        c = R.RendezvousClient("127.0.0.1", port, server.secret,
                               retry=_policy(pkg))
        with pytest.raises(F.FaultInjected):
            c.put("k", "v")
        assert F.points_hit("rendezvous.put") == 1
        assert c.get("k") is None
    finally:
        F.clear()
        server.stop()


def test_publish_heartbeat_renews_the_lease(monkeypatch):
    monkeypatch.setenv("HOROVOD_HOSTNAME", "hostA")
    monkeypatch.setenv("HOROVOD_SLOT", "2")
    monkeypatch.setattr(PEW, "_last_beat_monotonic", None)
    assert PEW.heartbeat_key() == JEW.heartbeat_key() == \
        "elastic/heartbeat/hostA:2"
    assert PEW.heartbeat_age() is None
    server = PR.RendezvousServer(prefer_native=False)
    port = server.start()
    try:
        c = PR.RendezvousClient("127.0.0.1", port, server.secret)
        PEW.publish_heartbeat(c, 1, ttl=0.3)
        beat = json.loads(c.get("elastic/heartbeat/hostA:2"))
        assert beat["seq"] == 1 and beat["nonce"] == PEW._HEARTBEAT_NONCE
        assert not server.store.lease_expired("worker/hostA:2")
        assert 0 <= PEW.heartbeat_age() < 1.0
        time.sleep(0.4)
        assert server.store.lease_expired("worker/hostA:2")
        PEW.publish_heartbeat(c, 2, ttl=0.3)
        assert not server.store.lease_expired("worker/hostA:2")
        assert json.loads(c.get("elastic/heartbeat/hostA:2"))["seq"] == 2
    finally:
        server.stop()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("ttl,age,code", [
    ("5", None, 200), ("5", 1.0, 200), ("5", 10.0, 503), ("0", 10.0, 200)])
def test_healthz_follows_the_heartbeat_lease(monkeypatch, ttl, age, code):
    monkeypatch.setenv("HOROVOD_ELASTIC_LEASE_TTL", ttl)
    now = time.monotonic()
    last = None if age is None else now - age
    monkeypatch.setattr(PEW, "_last_beat_monotonic", last)
    monkeypatch.setattr(JEW, "_last_beat_monotonic", last)
    monkeypatch.setattr(time, "monotonic", lambda: now)
    want = JEXP._default_liveness()
    assert PEXP._default_liveness() == want
    assert want[0] == (code == 200)
    monkeypatch.undo()
    monkeypatch.setenv("HOROVOD_ELASTIC_LEASE_TTL", ttl)
    monkeypatch.setattr(PEW, "_last_beat_monotonic",
                        None if age is None else time.monotonic() - age)
    port = PEXP.start_server(0, addr="127.0.0.1")
    try:
        got, body = _get(f"http://127.0.0.1:{port}/healthz")
    finally:
        PEXP.stop_server()
    assert got == code
    assert body.split(" ")[0].rstrip("\n") == want[1].split(" ")[0]


def test_metrics_kv_prints_the_fleet_a_port_publisher_wrote(
        capsys, monkeypatch):
    from horovod_tpu_torch.metrics.__main__ import main

    server = PR.RendezvousServer(prefer_native=False)
    port = server.start()
    try:
        c = PR.RendezvousClient("127.0.0.1", port, server.secret)
        for r in (1, 0):
            PFLEET.publish(c, rank=r)
        snaps = PFLEET.read_fleet(c)
        assert [s["rank"] for s in snaps] == [0, 1]
        jc = JR.RendezvousClient("127.0.0.1", port, server.secret)
        assert JFLEET.read_fleet(jc) == snaps
        addr = f"127.0.0.1:{port}"
        assert main(["--kv", addr, "--secret", server.secret]) == 0
        out = capsys.readouterr().out
        assert "fleet view: 2 rank(s)" in out
        assert main(["--raw", "--kv", addr, "--secret", server.secret]) == 0
        assert [s["rank"] for s in json.loads(capsys.readouterr().out)] \
            == [0, 1]
        # The default source: the launcher's env.
        monkeypatch.setenv("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1")
        monkeypatch.setenv("HOROVOD_RENDEZVOUS_PORT", str(port))
        monkeypatch.setenv("HOROVOD_SECRET_KEY", server.secret)
        assert main(["top", "--once"]) == 0
        assert "hvd top" in capsys.readouterr().out
        # ... which is also where a launched rank's snapshots go.
        target = PFLEET.fleet_store(object())
        assert isinstance(target, PR.RendezvousClient)
        assert (target.addr, target.port) == ("127.0.0.1", port)
    finally:
        server.stop()
    monkeypatch.delenv("HOROVOD_RENDEZVOUS_ADDR")
    store = object()
    assert PFLEET.fleet_store(store) is store


@pytest.mark.parametrize("stall_off", [False, True])
@pytest.mark.parametrize("env", [
    {"HOROVOD_RENDEZVOUS_ADDR": "127.0.0.1"},
    {"HOROVOD_RENDEZVOUS_ADDR": "127.0.0.1",
     "HOROVOD_RENDEZVOUS_PORT": "not-a-port", "HOROVOD_SECRET_KEY": "s"}],
    ids=["no-port", "bad-port"])
def test_a_broken_launcher_env_leaves_init_and_the_watchdog_running(
        monkeypatch, env, stall_off):
    """The fleet's KV is best-effort, as in the JAX package: a launcher
    env without a usable port neither fails `hvd.init()` (the fallback
    publisher's path, with the watchdog off) nor stops the watchdog."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils import stall_inspector as PSTALL

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if stall_off:
        monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    assert PFLEET.fleet_store(object()) is None
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        inspector = PSTALL.get_inspector()
        if stall_off:
            assert inspector is None
            assert not PFLEET.maybe_start_kv_publisher()
        else:
            time.sleep(0.3)
            assert inspector._thread.is_alive()
    finally:
        hvd.shutdown()


def test_prefer_native_finds_no_engine_and_serves_in_python(monkeypatch):
    # A host without a compiler: the native library cannot be had.
    from horovod_tpu_torch._native import control_plane
    monkeypatch.setattr(control_plane, "load", lambda **_: None)
    server = PR.RendezvousServer()
    port = server.start()
    try:
        assert server._native is None and server.kv() is server.store
        assert PR.RendezvousClient("127.0.0.1", port, server.secret).ping()
    finally:
        server.stop()


def test_client_from_env_and_generation(monkeypatch):
    with pytest.raises(PErr, match="missing rendezvous env"):
        PEW.client_from_env()
    server = PR.RendezvousServer(prefer_native=False)
    port = server.start()
    try:
        monkeypatch.setenv("HOROVOD_RENDEZVOUS_ADDR", "127.0.0.1")
        monkeypatch.setenv("HOROVOD_RENDEZVOUS_PORT", str(port))
        monkeypatch.setenv("HOROVOD_SECRET_KEY", server.secret)
        assert PEW.current_generation() == -1 == JEW.current_generation()
        server.kv().put("elastic/current_gen", "3")
        assert PEW.current_generation() == 3 == JEW.current_generation()
    finally:
        server.stop()
    assert not PEW.is_joining_worker()
    monkeypatch.setenv("HOROVOD_ELASTIC_JOINING", "1")
    assert PEW.is_joining_worker() and JEW.is_joining_worker()
