"""The port's launcher (`horovod_tpu_torch/runner/`) against the JAX
package's: host parsing and the rank math, the flags and the settings,
each slot's environment, the ssh command, the LSF and network helpers,
all equal on the same inputs; then the launcher end to end at np=2 on
gloo on the CPU (the environment each rank reads, an allreduce bitwise
numpy's, a failing rank's exit code and the teardown of the others,
`--output-filename` logs, `--check-build`, the elastic refusals), and
`run()` and the static `Executor`."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from horovod_tpu.common.exceptions import HorovodTpuError as JErr
from horovod_tpu.runner import exec_run as JEX
from horovod_tpu.runner import hosts as JH
from horovod_tpu.runner import launch as JL
from horovod_tpu.runner import lsf as JLSF
from horovod_tpu.runner import lsf_bootstrap as JLB
from horovod_tpu.runner import network as JN
from horovod_tpu.runner.settings import Settings as JSettings
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import HorovodTpuError as PErr
from horovod_tpu_torch.runner import exec_run as PEX
from horovod_tpu_torch.runner import hosts as PH
from horovod_tpu_torch.runner import launch as PL
from horovod_tpu_torch.runner import lsf as PLSF
from horovod_tpu_torch.runner import lsf_bootstrap as PLB
from horovod_tpu_torch.runner import network as PN
from horovod_tpu_torch.runner.settings import Settings as PSettings

from test_torch_port_collectives import REPO, no_launcher_env  # noqa: F401


def _slots(mod, hosts, np_, max_np=None):
    return [dataclasses.asdict(s) for s in mod.get_host_assignments(
        mod.parse_hosts(hosts), np_, max_np=max_np)]


def _same_error(fn_port, fn_jax):
    with pytest.raises(PErr) as pe:
        fn_port()
    with pytest.raises(JErr) as je:
        fn_jax()
    assert str(pe.value) == str(je.value)


# ---------------------------------------------------------------------------
# Hosts: tests/test_runner.py's cases, then a seeded sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts,np_,max_np", [
    ("a:2,b:4", 6, None), ("a:2,b:2", 4, None), ("a:1,b:2", 3, None),
    ("a:4", 1, 2), ("a:3,b:1,c:2", 5, None), ("a:2,b:2", 3, None),
    ("node-1.x:8,node-2.x:8", 16, None), ("localhost:2", 2, None)])
def test_assignments_are_jax(hosts, np_, max_np):
    assert _slots(PH, hosts, np_, max_np) == _slots(JH, hosts, np_, max_np)


def test_assignments_sweep_is_jax():
    rng = np.random.RandomState(16)
    for _ in range(200):
        n = rng.randint(1, 6)
        hosts = ",".join(f"h{i}:{rng.randint(1, 9)}" for i in range(n))
        total = sum(int(h.split(":")[1]) for h in hosts.split(","))
        np_ = rng.randint(1, total + 1)
        max_np = int(rng.randint(np_, total + 3)) if rng.rand() < 0.3 \
            else None
        got = _slots(PH, hosts, np_, max_np)
        assert got == _slots(JH, hosts, np_, max_np)
        p = PH.get_host_assignments(PH.parse_hosts(hosts), np_, max_np)
        PH.annotate_slots(p[::2])
        j = JH.get_host_assignments(JH.parse_hosts(hosts), np_, max_np)
        JH.annotate_slots(j[::2])
        assert [dataclasses.asdict(s) for s in p] == \
            [dataclasses.asdict(s) for s in j]
        assert [s.to_response_string() for s in p] == \
            [s.to_response_string() for s in j]


@pytest.mark.parametrize("bad", ["a", "a:", ":2", "a:2:3", "a:x", "",
                                 "a:2,a:2"])
def test_bad_host_strings_raise_as_in_jax(bad):
    _same_error(lambda: PH.parse_hosts(bad), lambda: JH.parse_hosts(bad))


def test_insufficient_slots_raise_as_in_jax():
    _same_error(lambda: PH.get_host_assignments(PH.parse_hosts("a:1"), 2),
                lambda: JH.get_host_assignments(JH.parse_hosts("a:1"), 2))


def test_hostfile_is_jax(tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("# comment\nnode1 slots=2\nnode2 4\nnode3\n\n"
                  "n4  slots=3  # trailing\n")
    assert [dataclasses.asdict(h) for h in PH.parse_hostfile(str(hf))] == \
        [dataclasses.asdict(h) for h in JH.parse_hostfile(str(hf))]
    bad = tmp_path / "bad"
    bad.write_text("node1 slots=x\n")
    _same_error(lambda: PH.parse_hostfile(str(bad)),
                lambda: JH.parse_hostfile(str(bad)))


# ---------------------------------------------------------------------------
# Flags, settings, the slot env, the ssh command
# ---------------------------------------------------------------------------

FLAG_SETS = [
    ["-np", "2", "python", "train.py"],
    ["-np", "8", "-H", "a:4,b:4", "--timeline-filename", "/tmp/t.json",
     "--fusion-threshold-mb", "32", "--cycle-time-ms", "3.5",
     "--cache-capacity", "2048", "--autotune",
     "--autotune-log-file", "/tmp/at.csv", "--verbose",
     "--start-timeout", "60", "--output-filename", "/tmp/logs",
     "--log-level", "DEBUG", "python", "train.py", "--lr", "0.1"],
    ["--min-np", "2", "--max-np", "4", "--host-discovery-script",
     "/tmp/discover.sh", "--slots", "1", "python", "train.py"],
    ["-np", "2", "--gloo", "python", "x.py"],
    ["-np", "3", "--mpi", "--ssh-port", "2222", "--ssh-identity-file",
     "/k", "--network-interfaces", "eth0,ib0", "--stall-check-time", "5",
     "--stall-shutdown-time", "60", "--timeline-mark-cycles",
     "--lease-ttl", "7", "--lease-start-grace", "3",
     "--blacklist-threshold", "2", "--max-respawns", "4",
     "--reset-limit", "9", "--", "python", "-m", "mod"],
]


def _settings(mod, argv):
    return mod.make_settings(mod.parse_args(argv))


@pytest.mark.parametrize("argv", FLAG_SETS, ids=range(len(FLAG_SETS)))
def test_flags_and_settings_are_jax(argv):
    assert vars(PL.parse_args(argv)) == vars(JL.parse_args(argv))
    assert dataclasses.asdict(_settings(PL, argv)) == \
        dataclasses.asdict(_settings(JL, argv))


def _full_settings(mod_settings, command):
    return mod_settings(
        num_proc=4, command=command, extra_env={"EXTRA": 1, "HOROVOD_X": "y"},
        timeline_filename="/tmp/tl.json", timeline_mark_cycles=True,
        fusion_threshold_mb=32, cycle_time_ms=2.5, cache_capacity=64,
        autotune=True, autotune_log_file="/tmp/at.csv",
        stall_check_time_seconds=5.0, stall_shutdown_time_seconds=60.0,
        log_level="INFO", rendezvous_addr="10.0.0.1", rendezvous_port=4242,
        ssh_port=2222, ssh_identity_file="/id")


# The JAX package names its XLA controller there; the port leaves both
# out (its process group's backend is chosen by each rank's init).
JAX_ONLY = {"HOROVOD_CONTROLLER": "xla", "HOROVOD_CPU_OPERATIONS": "xla"}


@pytest.mark.parametrize("hosts,np_", [("a:2,b:2", 4), ("a:1,b:3", 4),
                                       ("localhost:2", 2)])
def test_slot_env_is_jax_but_the_controller(monkeypatch, hosts, np_):
    for k in JAX_ONLY:
        monkeypatch.delenv(k, raising=False)
    ps = _full_settings(PSettings, ["python", "t.py"])
    js = _full_settings(JSettings, ["python", "t.py"])
    for p, j in zip(PH.get_host_assignments(PH.parse_hosts(hosts), np_),
                    JH.get_host_assignments(JH.parse_hosts(hosts), np_)):
        penv = PEX.slot_env(p, ps, "sec", "a:1234")
        jenv = JEX.slot_env(j, js, "sec", "a:1234")
        assert {k: v for k, v in jenv.items() if k not in JAX_ONLY} == penv
        assert {k: jenv[k] for k in JAX_ONLY} == JAX_ONLY
        assert not set(JAX_ONLY) & set(penv)
        assert penv["HOROVOD_RANK"] == str(p.rank)
        assert penv["HOROVOD_FUSION_THRESHOLD"] == str(32 * 1024 * 1024)


def test_ssh_command_is_jax_but_the_export_prefixes(monkeypatch):
    monkeypatch.chdir(REPO)
    slot = PH.SlotInfo("remote-host", rank=1, local_rank=0)
    jslot = JH.SlotInfo("remote-host", rank=1, local_rank=0)
    ps = _full_settings(PSettings, ["python", "train.py", "--x", "a b"])
    js = _full_settings(JSettings, ["python", "train.py", "--x", "a b"])
    common = {"HOROVOD_RANK": "1", "HVD_TPU_X": "1", "PATH": "/bin",
              "PYTHONPATH": "/r", "HOME": "/h", "LD_LIBRARY_PATH": "/l"}
    assert PEX.build_command(slot, ps, common) == \
        JEX.build_command(jslot, js, common)
    env = dict(common, CUDA_VISIBLE_DEVICES="0", NCCL_DEBUG="INFO",
               TORCH_NCCL_ASYNC_ERROR_HANDLING="1", JAX_PLATFORMS="tpu",
               XLA_FLAGS="-x", TPU_NAME="t")
    pcmd = PEX.build_command(slot, ps, env)
    jcmd = JEX.build_command(jslot, js, env)
    assert pcmd[:-1] == jcmd[:-1] == [
        "ssh", "-o", "StrictHostKeyChecking=no", "-p", "2222", "-i", "/id",
        "remote-host"]
    for k in ("CUDA_VISIBLE_DEVICES", "NCCL_DEBUG",
              "TORCH_NCCL_ASYNC_ERROR_HANDLING"):
        assert f"{k}=" in pcmd[-1] and f"{k}=" not in jcmd[-1]
    for k in ("JAX_PLATFORMS", "XLA_FLAGS", "TPU_NAME"):
        assert f"{k}=" in jcmd[-1] and f"{k}=" not in pcmd[-1]
    for k in ("HOME", "LD_LIBRARY_PATH"):
        assert f"{k}=" not in pcmd[-1]
    local = PH.SlotInfo("localhost", rank=0)
    assert PEX.build_command(local, ps, env) == \
        JEX.build_command(JH.SlotInfo("localhost", rank=0), js, env) == \
        ["python", "train.py", "--x", "a b"]
    ps.command = []
    with pytest.raises(PErr, match="no command to launch"):
        PEX.build_command(local, ps, env)


# ---------------------------------------------------------------------------
# LSF and network helpers
# ---------------------------------------------------------------------------

LSF_ENVS = [
    {"LSB_JOBID": "1", "LSB_MCPU_HOSTS": "batch1 1 n1 4 n2 4"},
    {"LSB_JOBID": "1", "LSB_HOSTS": "launch0 n1 n1 n2 n3 n3 n3"},
    {"LSB_JOBID": "1", "LSB_MCPU_HOSTS": "n1 2 n1 2"},
    {"LSB_JOBID": "1"},
    {"LSB_MCPU_HOSTS": "n1 2"},
    {"LSB_JOBID": "1", "LSB_MCPU_HOSTS": "n1 2 n2"},
    {"LSB_JOBID": "1", "LSB_MCPU_HOSTS": "batch1 2"},
]


@pytest.mark.parametrize("env", LSF_ENVS, ids=range(len(LSF_ENVS)))
def test_lsf_hosts_are_jax(env):
    assert PLSF.in_lsf_job(env) == JLSF.in_lsf_job(env)
    try:
        want = [dataclasses.asdict(h) for h in JLSF.lsf_hosts(env)]
    except JErr as e:
        with pytest.raises(PErr) as pe:
            PLSF.lsf_hosts(env)
        assert str(pe.value) == str(e)
        return
    assert [dataclasses.asdict(h) for h in PLSF.lsf_hosts(env)] == want


BOOT_ENVS = [
    {"OMPI_COMM_WORLD_RANK": "3", "OMPI_COMM_WORLD_SIZE": "8",
     "OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_SIZE": "4",
     "LSB_MCPU_HOSTS": "batch 1 n1 4 n2 4", "LSB_JOBID": "9"},
    {"PMIX_RANK": "0", "JSM_NAMESPACE_SIZE": "2"},
    {"JSM_NAMESPACE_RANK": "1", "HOROVOD_SIZE": "2",
     "HOROVOD_COORDINATOR_ADDR": "x:1"},
    {"PMI_RANK": "2", "PMI_SIZE": "4", "MPI_LOCALRANKID": "0",
     "MPI_LOCALNRANKS": "2"},
]


@pytest.mark.parametrize("env", BOOT_ENVS, ids=range(len(BOOT_ENVS)))
def test_lsf_bootstrap_env_is_jax(env):
    assert PLB.derive_horovod_env(env) == JLB.derive_horovod_env(env)


def test_lsf_bootstrap_refusals_are_jax():
    for env in ({}, {"PMIX_RANK": "0"}):
        with pytest.raises(RuntimeError) as pe:
            PLB.derive_horovod_env(env)
        with pytest.raises(RuntimeError) as je:
            JLB.derive_horovod_env(env)
        assert str(pe.value) == str(je.value)


def test_jsrun_command_is_jax_but_the_bootstrap_module():
    for out in (None, "/tmp/o"):
        ps = PSettings(num_proc=4, command=["python", "t.py"],
                       output_filename=out)
        js = JSettings(num_proc=4, command=["python", "t.py"],
                       output_filename=out)
        want = [("horovod_tpu_torch.runner.lsf_bootstrap"
                 if a == "horovod_tpu.runner.lsf_bootstrap" else a)
                for a in JLSF.build_jsrun_command(js, 4)]
        assert PLSF.build_jsrun_command(ps, 4) == want
    with pytest.raises(PErr, match="no command to launch"):
        PLSF.build_jsrun_command(PSettings(num_proc=1), 1)


def test_js_run_env_is_jax_but_the_controller(monkeypatch):
    seen = {}

    class _R:
        returncode = 0

    def fake(pkg):
        def run(cmd, env):
            seen[pkg] = (cmd, env)
            return _R()
        return run

    for pkg, mod, st in (("port", PLSF, PSettings), ("jax", JLSF, JSettings)):
        s = st(num_proc=2, command=["python", "t.py"], nics="lo")
        assert mod.js_run(s, runner=fake(pkg)) == 0
    penv, jenv = seen["port"][1], seen["jax"][1]
    drop = set(JAX_ONLY) | {"HOROVOD_RENDEZVOUS_PORT", "HOROVOD_SECRET_KEY"}
    assert {k: v for k, v in penv.items() if k not in drop} == \
        {k: v for k, v in jenv.items() if k not in drop}
    assert penv["HOROVOD_RENDEZVOUS_ADDR"] == "127.0.0.1"
    assert not set(JAX_ONLY) & set(penv)


@pytest.mark.parametrize("nics", [None, "", "eth0", " eth0 , ib0 ,,"])
def test_parse_nics_is_jax(nics):
    assert PN.parse_nics(nics) == JN.parse_nics(nics)


def test_interfaces_are_jax():
    tables = {"a": {"lo": "127.0.0.1", "eth0": "10.0.0.1", "ib0": "x"},
              "b": {"lo": "127.0.0.1", "eth0": "10.0.0.2"},
              "c": {"lo0": "127.0.0.1", "eth0": "10.0.0.3", "ib0": "y"}}
    for per_host in (tables, {}, {"a": tables["a"]}):
        for lo in (True, False):
            assert PN.common_interfaces(per_host, lo) == \
                JN.common_interfaces(per_host, lo)
    assert PN.local_interfaces() == JN.local_interfaces()
    assert PN.resolve_advertise_address("lo") == \
        JN.resolve_advertise_address("lo") == "127.0.0.1"
    with pytest.raises(PErr) as pe:
        PN.resolve_advertise_address("no-such-nic")
    with pytest.raises(JErr) as je:
        JN.resolve_advertise_address("no-such-nic")
    assert str(pe.value) == str(je.value)

    calls = []

    class _R:
        returncode = 0
        stdout = 'noise\n{"eth0": "10.1.1.1"}\n'
        stderr = ""

    def fake(cmd, **kw):
        calls.append(cmd)
        return _R()

    assert PN.probe_remote_interfaces("h", 22, "/id", runner=fake) == \
        JN.probe_remote_interfaces("h", 22, "/id", runner=fake) == \
        {"eth0": "10.1.1.1"}
    assert calls[0] == calls[1]


# ---------------------------------------------------------------------------
# End to end at np=2 on gloo on the CPU
# ---------------------------------------------------------------------------

WORKER = r'''
import json, os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
x = np.random.RandomState(100 + r).randn(7, 5).astype(np.float32)
y = hvd.allreduce(torch.from_numpy(x), op=hvd.Sum)
# More collectives under the consistency check: each rank issues the
# same sequence, so every check passes.
g = hvd.allgather(torch.full((r + 1, 2), float(r)))
b = hvd.broadcast(torch.arange(3.0) + r, root_rank=1)
env = {k: v for k, v in os.environ.items()
       if k.startswith("HOROVOD_") and k != "HOROVOD_SECRET_KEY"}
res = {"env": env, "rank": r, "size": hvd.size(),
       "local_rank": hvd.local_rank(), "local_size": hvd.local_size(),
       "cross_rank": hvd.cross_rank(), "cross_size": hvd.cross_size(),
       "device": str(hvd.device()), "backend": hvd.backend(),
       "sum": y.numpy().tobytes().hex(), "gather": g.tolist(),
       "bcast": b.tolist(), "secret": bool(os.environ["HOROVOD_SECRET_KEY"])}
print("RANK_DONE", r, flush=True)
with open(os.path.join(out, f"res{r}.json"), "w") as f:
    json.dump(res, f)
hvd.shutdown()
'''


def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    return env


def _launcher(args, timeout=120, **env):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", *args],
        cwd=REPO, env=_env(**env), capture_output=True, text=True,
        timeout=timeout)


def test_launch_np2_env_allreduce_and_logs(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    logs = tmp_path / "logs"
    r = _launcher(["-np", "2", "--output-filename", str(logs),
                   "--fusion-threshold-mb", "8", sys.executable,
                   str(worker), str(tmp_path)],
                  HOROVOD_COLLECTIVE_CONSISTENCY_CHECK="1")
    assert r.returncode == 0, r.stdout + r.stderr
    res = [json.loads((tmp_path / f"res{k}.json").read_text())
           for k in range(2)]
    want = sum(np.random.RandomState(100 + k).randn(7, 5).astype(np.float32)
               for k in range(2))
    slots = JH.get_host_assignments([JH.HostInfo("localhost", 2)], 2)
    for k, (got, slot) in enumerate(zip(res, slots)):
        e = got["env"]
        assert (got["rank"], got["size"], got["local_rank"],
                got["local_size"], got["cross_rank"], got["cross_size"]) == \
            (slot.rank, slot.size, slot.local_rank, slot.local_size,
             slot.cross_rank, slot.cross_size)
        for key, val in (("RANK", slot.rank), ("SIZE", 2),
                         ("LOCAL_RANK", slot.local_rank),
                         ("LOCAL_SIZE", 2), ("CROSS_RANK", 0),
                         ("CROSS_SIZE", 1), ("PROCESS_ID", slot.rank),
                         ("NUM_PROCESSES", 2)):
            assert e["HOROVOD_" + key] == str(val), key
        assert e["HOROVOD_COORDINATOR_ADDR"].startswith("127.0.0.1:")
        assert e["HOROVOD_RENDEZVOUS_ADDR"] == "127.0.0.1"
        assert int(e["HOROVOD_RENDEZVOUS_PORT"]) > 0 and got["secret"]
        assert e["HOROVOD_FUSION_THRESHOLD"] == str(8 * 1024 * 1024)
        assert "HOROVOD_CONTROLLER" not in e
        assert (got["device"], got["backend"]) == ("cpu", "gloo")
        assert bytes.fromhex(got["sum"]) == want.tobytes()
        assert got["gather"] == [[0.0, 0.0], [1.0, 1.0], [1.0, 1.0]]
        assert got["bcast"] == [1.0, 2.0, 3.0]
        log = (logs / f"rank.{k}.log").read_text()
        assert f"RANK_DONE {k}" in log
    assert res[0]["env"]["HOROVOD_COORDINATOR_ADDR"] == \
        res[1]["env"]["HOROVOD_COORDINATOR_ADDR"]


def test_a_failing_rank_exit_code_is_returned_and_the_rest_torn_down(
        tmp_path):
    code = (
        "import os, sys, time\n"
        f"d = {str(tmp_path)!r}\n"
        "r = os.environ['HOROVOD_RANK']\n"
        "if r == '0':\n"
        "    open(os.path.join(d, 'pid0'), 'w').write(str(os.getpid()))\n"
        "    time.sleep(120)\n"
        "while not os.path.exists(os.path.join(d, 'pid0')):\n"
        "    time.sleep(0.05)\n"
        "print('rank 1 fails', flush=True)\n"
        "sys.exit(3)\n")
    t0 = time.monotonic()
    r = _launcher(["-np", "2", sys.executable, "-c", code])
    assert r.returncode == 3, r.stdout + r.stderr
    assert time.monotonic() - t0 < 60
    assert "[1]" in r.stdout and "rank 1 fails" in r.stdout
    assert "rank 1 (pid" in r.stderr and "exited with code 3" in r.stderr
    pid = int((tmp_path / "pid0").read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


def test_check_build_output_shape():
    out = PL.check_build()
    r = _launcher(["--check-build"])
    assert r.returncode == 0 and r.stdout.rstrip("\n") == out
    lines = out.splitlines()
    assert lines[0] == f"horovod_tpu_torch v{JL.__version__}:"
    for heading in ("Available backends:", "Available controllers:",
                    "Available features:"):
        assert heading in lines
    mark = {ln[8:]: ln[5] for ln in lines if ln.startswith("    [")}
    assert mark["NCCL"] == ("X" if basics.nccl_built() else " ")
    assert mark["CUDA"] == ("X" if basics.cuda_built() else " ")
    assert mark["gloo (CPU, ranks sharing a card)"] == "X"
    assert mark["torch.distributed (c10d TCPStore)"] == "X"
    from horovod_tpu_torch import _native
    assert mark["elastic"] == "X"
    assert mark["native control plane (C++)"] == \
        ("X" if _native.load() is not None else " ")
    from horovod_tpu_torch import _build
    assert mark["CUDA kernels (adasum, flash attention, tiled matmul)"] == \
        ("X" if _build.available() else " ")
    # The JAX package's shape: the same headings, in the same order.
    jl = JL.check_build().splitlines()
    assert [ln for ln in lines if ln.endswith(":")][1:] == \
        [ln for ln in jl if ln.endswith(":")][1:]


def test_the_usage_errors_refuse(capsys):
    from horovod_tpu_torch.runner import run

    with pytest.raises(ValueError, match="conflict"):
        run(len, np=2, hosts="a:2", host_discovery_script="d.sh")
    with pytest.raises(ValueError, match="either hosts or hostfile"):
        run(len, np=2, hosts="a:2", hostfile="f")
    for argv, msg in ((["-np", "2"], "no training command"),
                      (["python", "x.py"], "-np is required")):
        assert PL.run_commandline(argv) == JL.run_commandline(argv) == 2
        out = capsys.readouterr().err
        assert out.count(msg) == 2


# ---------------------------------------------------------------------------
# run() and the static Executor
# ---------------------------------------------------------------------------

FNS = r'''
import os


def allreduce_on_init(scale):
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    r = hvd.rank()
    x = np.random.RandomState(200 + r).randn(4).astype(np.float32)
    y = hvd.allreduce(torch.from_numpy(x) * scale, op=hvd.Sum)
    out = (r, str(hvd.device()), y.numpy().tobytes().hex())
    hvd.shutdown()
    return out


def add_rank(a, b=0):
    return a + b + int(os.environ["HOROVOD_RANK"])
'''


def test_run_returns_per_rank_results(tmp_path, monkeypatch):
    from horovod_tpu_torch.runner import run

    (tmp_path / "port_run_fns.py").write_text(FNS)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", _env()["PYTHONPATH"])
    import port_run_fns

    out = run(port_run_fns.allreduce_on_init, args=(2.0,), np=2)
    want = sum(np.random.RandomState(200 + k).randn(4).astype(np.float32)
               * np.float32(2.0) for k in range(2))
    assert [(r, d) for r, d, _ in out] == [(0, "cpu"), (1, "cpu")]
    assert all(bytes.fromhex(h) == want.tobytes() for _, _, h in out)


DRIVER = r'''
import functools, os, sys
from horovod_tpu_torch.runner.executor import Executor
from horovod_tpu_torch.common.exceptions import HorovodTpuError
import port_run_fns


class Box:
    def __init__(self, v):
        self.v = v


def main_fn(k):
    return Box(k * 10 + int(os.environ["HOROVOD_RANK"]))


def boom():
    raise RuntimeError("boom from worker")


if __name__ == "__main__":
    with Executor(np=2) as ex:
        assert [b.v for b in ex.run(main_fn, args=(4,))] == [40, 41]
        closure = functools.partial(port_run_fns.add_rank, 10, b=5)
        assert ex.run(closure) == [15, 16]
        tok = ex.run_remote(port_run_fns.add_rank, args=(1,))
        assert ex.get(tok) == [1, 2]
        try:
            ex.run(boom)
            raise SystemExit("no error surfaced")
        except HorovodTpuError as e:
            assert "boom from worker" in str(e)
        assert ex.execute(functools.partial(port_run_fns.add_rank, 0)) \
            == [0, 1]
        res = ex.run(port_run_fns.allreduce_on_init, args=(1.0,))
        assert [r for r, _, _ in res] == [0, 1] and res[0][2] == res[1][2]
    print("EXECUTOR_OK", flush=True)
'''


def test_executor_runs_a_closure_and_a_main_defined_function(tmp_path):
    (tmp_path / "port_run_fns.py").write_text(FNS)
    (tmp_path / "driver.py").write_text(DRIVER)
    env = _env()
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), env["PYTHONPATH"]])
    r = subprocess.run([sys.executable, str(tmp_path / "driver.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=180)
    assert r.returncode == 0 and "EXECUTOR_OK" in r.stdout, \
        r.stdout + r.stderr


def test_teardown_reaps_an_exited_leader_at_once():
    """An exited rank that was not reaped yet stays a zombie member of
    its process group; terminating it must not wait out the grace
    period (the live child of another rank is still killed)."""
    from horovod_tpu_torch.runner import safe_exec

    done = safe_exec.execute(["true"], background=True)
    deadline = time.monotonic() + 10
    with open(f"/proc/{done.pid}/stat") as f:
        while f.read().split()[2] != "Z":  # exited, not reaped
            assert time.monotonic() < deadline
            time.sleep(0.02)
            f.seek(0)
    t0 = time.monotonic()
    done.terminate()
    assert time.monotonic() - t0 < 2.0
    assert done.wait(timeout=5) == 0
    live = safe_exec.execute(["sleep", "60"], background=True)
    t0 = time.monotonic()
    live.terminate()
    assert live.wait(timeout=5) == -15
    assert time.monotonic() - t0 < safe_exec.GRACEFUL_TERMINATION_TIME_S
