"""Guards of the PyTorch/CUDA port: it imports neither jax nor the JAX
package, its entry points refuse a host without a card unless asked for
the CPU, and its single-rank and routing behaviour."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics, util
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch import torch as hvd_torch

from test_torch_port_collectives import no_launcher_env  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "horovod_tpu_torch"


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys, chip_smoke, horovod_tpu_torch, horovod_tpu_torch.torch, "
        "horovod_tpu_torch._build, horovod_tpu_torch.ops.adasum, "
        "horovod_tpu_torch.ops.functions, horovod_tpu_torch.models.convert, "
        "horovod_tpu_torch.synthetic_benchmark, "
        "horovod_tpu_torch.torch_mnist, horovod_tpu_torch.bench, "
        "horovod_tpu_torch.models.inception, horovod_tpu_torch.models.vgg, "
        "horovod_tpu_torch.models.mnist, "
        "horovod_tpu_torch.ops.flash_attention, "
        "horovod_tpu_torch.parallel.sequence, "
        "horovod_tpu_torch.models.transformer, "
        "horovod_tpu_torch.transformer_benchmark, "
        "horovod_tpu_torch.ops.fused_collectives, "
        "horovod_tpu_torch.ops.matmul_kernels, horovod_tpu_torch.ops.wire, "
        "horovod_tpu_torch.ops.quantized, "
        "horovod_tpu_torch.parallel.optimizer, "
        "horovod_tpu_torch.parallel.zero3, "
        "horovod_tpu_torch.parallel.data_parallel, "
        "horovod_tpu_torch.parallel.mesh, horovod_tpu_torch.parallel.moe, "
        "horovod_tpu_torch.parallel.pipeline, "
        "horovod_tpu_torch.parallel._collectives, "
        "horovod_tpu_torch.utils.autotune, horovod_tpu_torch.models.decode, "
        "horovod_tpu_torch.serve, horovod_tpu_torch.serve.loadgen, "
        "horovod_tpu_torch.metrics, horovod_tpu_torch.utils.timeline, "
        "horovod_tpu_torch.serve_benchmark, horovod_tpu_torch.guard, "
        "horovod_tpu_torch.guard.controller, horovod_tpu_torch.guard.digest, "
        "horovod_tpu_torch.guard.loss_scale, "
        "horovod_tpu_torch.guard.sentinel, "
        "horovod_tpu_torch.utils.checkpoint, horovod_tpu_torch.runner, "
        "horovod_tpu_torch.runner.launch, horovod_tpu_torch.runner.api, "
        "horovod_tpu_torch.runner.exec_run, "
        "horovod_tpu_torch.runner.executor, horovod_tpu_torch.runner.lsf, "
        "horovod_tpu_torch.runner.lsf_bootstrap, "
        "horovod_tpu_torch.runner.network, "
        "horovod_tpu_torch.runner.rendezvous, "
        "horovod_tpu_torch.runner.elastic_worker, "
        "horovod_tpu_torch.runner.safe_exec, "
        "horovod_tpu_torch.utils.consistency, horovod_tpu_torch.version, "
        "horovod_tpu_torch.metrics.__main__\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'horovod_tpu' or m.startswith('horovod_tpu.')]\n"
        "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"])
def test_port_sources_import_neither_jax_nor_the_reference(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "horovod_tpu"), (path, n)


def test_init_without_a_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: init() would use it")
    with pytest.raises(HorovodTpuError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_single_rank_on_the_cpu():
    """No coordinator: one rank, no process group; every collective
    returns its local result."""
    hvd.init(device="cpu")
    try:
        assert (hvd.size(), hvd.rank(), hvd.local_size(), hvd.local_rank(),
                hvd.cross_size(), hvd.cross_rank()) == (1, 0, 1, 0, 1, 0)
        assert hvd.backend() is None and hvd.device() == torch.device("cpu")
        assert hvd.is_homogeneous()
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        for op in (hvd.Average, hvd.Sum, hvd.Min, hvd.Max, hvd.Product,
                   hvd.Adasum):
            torch.testing.assert_close(hvd.allreduce(x, op=op), x)
        torch.testing.assert_close(
            hvd.allreduce(x, op=hvd.Sum, prescale_factor=2.0,
                          postscale_factor=0.5), x)
        torch.testing.assert_close(hvd.allgather(x), x)
        torch.testing.assert_close(hvd.broadcast(x, root_rank=0), x)
        assert hvd.broadcast_object({"a": 1}) == {"a": 1}
        assert hvd.allgather_object([1, 2]) == [[1, 2]]
        h = hvd.allreduce_async_(x.clone(), op=hvd.Sum)
        assert hvd.poll(h)
        torch.testing.assert_close(hvd.synchronize(h), x)
        hvd.barrier()
    finally:
        hvd.shutdown()
    assert not hvd.is_initialized()


def test_build_flags_tell_the_truth():
    assert hvd.tpu_built() is False and hvd.xla_built() is False
    assert hvd.cuda_built() == torch.backends.cuda.is_built()
    assert hvd.nccl_built() == dist.is_nccl_available()
    assert hvd.gloo_built() == dist.is_gloo_available()


@pytest.mark.parametrize("device,local_size,cards,want", [
    ("cpu", 1, 0, "gloo"), ("cpu", 4, 8, "gloo"), ("cuda:0", 1, 1, "nccl"),
    ("cuda:0", 4, 4, "nccl"), ("cuda:0", 2, 1, "gloo")])
def test_backend_choice(monkeypatch, device, local_size, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert basics._choose_backend(torch.device(device), local_size) == want


def test_env_helpers(monkeypatch):
    monkeypatch.setenv("HVD_TPU_X_KNOB", "3")
    assert util.env_int("X_KNOB", 0) == 3
    monkeypatch.setenv("HOROVOD_X_KNOB", "7")
    assert util.env_int("X_KNOB", 0) == 7
    monkeypatch.setenv("HOROVOD_X_KNOB", "junk")
    assert util.env_int("X_KNOB", 5) == 5
    monkeypatch.setenv("HOROVOD_X_FLAG", "yes")
    assert util.env_bool("X_FLAG") is True
    assert util.getenv("X_ABSENT", "d") == "d"


def test_fusion_threshold_reads_env(monkeypatch):
    monkeypatch.delenv("HOROVOD_FUSION_THRESHOLD", raising=False)
    assert hvd_torch._fusion_threshold() == 64 * 1024 * 1024
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1024")
    assert hvd_torch._fusion_threshold() == 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_compression_round_trip(dtype):
    x = (torch.randn(10) * 4).to(dtype)
    c, ctx = Compression.fp16.compress(x)
    assert c.dtype == (torch.float16 if dtype.is_floating_point else dtype)
    y = Compression.fp16.decompress(c, ctx)
    assert y.dtype == dtype
    torch.testing.assert_close(y.float(), x.float(), rtol=1e-2, atol=1e-2)
    c, ctx = Compression.none.compress(x)
    assert c is x and Compression.none.decompress(c, ctx) is x


def test_distributed_optimizer_routing():
    lin = torch.nn.Linear(2, 2)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1.0),
                                   op=hvd.Adasum)
    assert isinstance(opt, hvd_torch._DistributedAdasumOptimizer)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1.0))
    assert isinstance(opt, hvd_torch._DistributedOptimizer)
    assert opt.param_groups[0]["lr"] == 1.0  # delegated to the wrapped one
    with pytest.raises(ValueError, match="predivide"):
        hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1.0),
                                 op=hvd.Sum, gradient_predivide_factor=2.0)
    with pytest.raises(ValueError, match="Duplicate"):
        hvd.DistributedOptimizer(
            torch.optim.SGD(lin.parameters(), lr=1.0),
            named_parameters=[("w", lin.weight), ("w", lin.bias)])


# A finder that refuses the JAX package and jax itself: TensorFlow and
# Keras load jax when it is installed, so the sys.modules check above
# cannot hold the frontends; refusing the imports shows that they run
# without them.
REFUSE = r'''
import sys


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "horovod_tpu"):
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
'''


def test_the_frontends_run_with_jax_and_the_reference_refused():
    code = REFUSE + (
        "import numpy as np, torch, tensorflow as tf\n"
        "import horovod_tpu_torch.tensorflow as htf\n"
        "import horovod_tpu_torch.tensorflow.keras as hk\n"
        "import horovod_tpu_torch.keras, horovod_tpu_torch.mxnet as hmx\n"
        "import horovod_tpu_torch.callbacks as cb\n"
        "htf.init(device='cpu')\n"
        "out = htf.allreduce(tf.constant([1.5, -2.0]), op=htf.Sum)\n"
        "assert out.numpy().tolist() == [1.5, -2.0], out\n"
        "assert hmx.allreduce(np.ones(2, np.float32)).tolist() == [1, 1]\n"
        "assert cb.MetricAverageCallback().on_epoch_end({'l': 2.0})['l'] == 2\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'horovod_tpu')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
