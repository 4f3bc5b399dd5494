"""The port's public surfaces against `tests/test_api_parity.py`: every
name that file requires of a JAX namespace (`SURFACES`, `CALLBACKS`, the
elastic names of `test_elastic_surface`) resolves on the port's
counterpart (`horovod_tpu.X` -> `horovod_tpu_torch.X`), and every public
top-level name of `horovod_tpu` is the port's too or one of JAX_ONLY,
each with what takes its place in the port (ROADMAP, "Reference
behaviours")."""

import ast
import importlib
import inspect
import json
import subprocess
import sys

import pytest

import test_api_parity as P
from test_torch_port_guard import REPO, _env

# The JAX package's top-level names with no counterpart of that name,
# and the port's name that takes each one's place (None: nothing does).
JAX_ONLY = {
    # An optax GradientTransformation wrapper: the port's optimizers are
    # torch.optim ones, wrapped by DistributedOptimizer.
    "DistributedGradientTransformation": "DistributedOptimizer",
    # The one-process simulation's per-rank values: each port process is
    # one rank and passes its own tensor.
    "PerRank": None,
    # The mesh axis and the device mesh: one device a rank, `device()`.
    "GLOBAL_AXIS": None,
    "global_mesh": "device",
    "global_devices": "device",
    # ZeRO-1's PartitionSpecs for shard_map: the port's sharded
    # optimizer places each shard on its rank itself.
    "sharded_state_specs": None,
}


def _port(modname: str) -> str:
    return "horovod_tpu_torch" + modname[len("horovod_tpu"):]


def _elastic_names():
    """(module, names) pairs of `test_elastic_surface`: the modules it
    imports, and the names it asserts on each (`hasattr(mod, "name")`,
    or a loop over a list of names)."""
    tree = ast.parse(inspect.getsource(P.test_elastic_surface))
    alias, names = {}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                alias[a.asname or a.name] = a.name
    loops = {}  # a hasattr call inside a loop over a list: the list
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and isinstance(node.iter, ast.List):
            for c in ast.walk(node):
                loops[id(c)] = [e.value for e in node.iter.elts]
    for c in ast.walk(tree):
        if not (isinstance(c, ast.Call)
                and getattr(c.func, "id", None) == "hasattr"):
            continue
        arg = c.args[1]
        got = [arg.value] if isinstance(arg, ast.Constant) else loops[id(c)]
        names.setdefault(alias[c.args[0].id], []).extend(got)
    return sorted((m, tuple(v)) for m, v in names.items())


@pytest.mark.parametrize("modname", sorted(P.SURFACES))
def test_port_surface_complete(modname):
    mod = importlib.import_module(_port(modname))
    missing = [s for s in P.SURFACES[modname] if not hasattr(mod, s)]
    assert not missing, f"{_port(modname)} missing: {missing}"


@pytest.mark.parametrize("modname", ["horovod_tpu.tensorflow.keras.callbacks",
                                     "horovod_tpu.keras.callbacks",
                                     "horovod_tpu.callbacks"])
def test_port_callbacks_complete(modname):
    mod = importlib.import_module(_port(modname))
    missing = [s for s in P.CALLBACKS if not hasattr(mod, s)]
    assert not missing, f"{_port(modname)} missing: {missing}"


def test_the_elastic_names_are_read_from_the_parity_test():
    got = dict(_elastic_names())
    assert got["horovod_tpu.elastic"] == ("run", "State", "ObjectState")
    assert got["horovod_tpu.tensorflow.keras.elastic"][0] == "KerasState"


@pytest.mark.parametrize("modname,names", _elastic_names())
def test_port_elastic_surface(modname, names):
    mod = importlib.import_module(_port(modname))
    missing = [s for s in names if not hasattr(mod, s)]
    assert not missing, f"{_port(modname)} missing: {missing}"


def test_every_top_level_name_is_ported_or_recorded():
    """In a fresh interpreter: in this one, other tests' imports add
    submodules (`horovod_tpu.ray`, `.spark`) to the package's names."""
    code = ("import json, horovod_tpu, horovod_tpu_torch\n"
            "print(json.dumps([sorted(n for n in dir(m) if not "
            "n.startswith('_')) for m in (horovod_tpu, horovod_tpu_torch)]))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    public, port = (set(names) for names in json.loads(
        r.stdout.splitlines()[-1]))
    missing = public - port
    assert missing == set(JAX_ONLY), sorted(missing ^ set(JAX_ONLY))
    for name, instead in JAX_ONLY.items():
        assert instead is None or instead in port, name


@pytest.mark.parametrize("name", ["callbacks", "distributed_grad",
                                  "DistributedGradientTape", "data_parallel",
                                  "shard_batch"])
def test_the_tape_frontend_is_the_defining_modules(name):
    import horovod_tpu_torch
    from horovod_tpu_torch import callbacks
    from horovod_tpu_torch.parallel import data_parallel

    want = callbacks if name == "callbacks" else getattr(data_parallel, name)
    assert getattr(horovod_tpu_torch, name) is want
