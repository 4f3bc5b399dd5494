"""The port's package surfaces against the JAX package's: every name
that `horovod_tpu.parallel` and `horovod_tpu.models` export for the
parallel strategies and decoding resolves on the port's packages, and
the version is the JAX package's."""

import subprocess
import sys

import pytest

import horovod_tpu
import horovod_tpu_torch

from test_torch_port_guard import REPO, _env

# horovod_tpu/parallel/__init__.py:10-33.
PARALLEL = (
    "AXIS_ORDER", "MeshConfig", "create_hierarchical_mesh",
    "create_hybrid_mesh", "mesh_axis_size", "dcn_shard_size",
    "hierarchical_all_gather", "hierarchical_allreduce",
    "hierarchical_error_feedback_init", "hierarchical_reduce_scatter",
    "dense_attention_oracle", "full_attention", "ring_attention",
    "ring_attention_shard", "ulysses_attention", "ulysses_attention_shard",
    "gpipe", "gpipe_shard", "moe_apply_dense", "moe_apply_shard", "moe_init",
)
# horovod_tpu/models/__init__.py:39-49.
DECODE = (
    "ShardedDecode", "init_decode_cache", "make_decode_step",
    "transformer_beam_search", "transformer_decode_step",
    "transformer_extend", "transformer_generate", "transformer_prefill",
    "transformer_speculative_generate",
)


@pytest.mark.parametrize("name", PARALLEL)
def test_parallel_exports_the_jax_name(name):
    import horovod_tpu.parallel as jp
    import horovod_tpu_torch.parallel as pp

    assert hasattr(jp, name)
    assert getattr(pp, name) is not None


@pytest.mark.parametrize("name", DECODE)
def test_models_export_the_jax_decode_name(name):
    import horovod_tpu.models as jm
    import horovod_tpu_torch.models as pm
    from horovod_tpu_torch.models import decode

    assert hasattr(jm, name)
    assert getattr(pm, name) is getattr(decode, name)


def test_parallel_names_are_the_defining_modules_objects():
    import horovod_tpu_torch.parallel as pp
    from horovod_tpu_torch.parallel import (hierarchical, mesh, moe,
                                            pipeline, sequence)

    mods = (mesh, hierarchical, sequence, pipeline, moe)
    for name in PARALLEL:
        assert any(getattr(m, name, None) is getattr(pp, name)
                   for m in mods), name
    from horovod_tpu_torch.parallel import ring_attention  # noqa: F401


def test_version_is_the_jax_packages():
    from horovod_tpu_torch.version import __version__

    assert horovod_tpu_torch.__version__ == horovod_tpu.__version__
    assert __version__ == horovod_tpu.__version__


def test_fresh_import_of_the_surfaces_has_no_cycle():
    """Each surface imports first in a fresh interpreter (an import
    cycle shows as an ImportError of a partially initialized module)."""
    for stmt in ("from horovod_tpu_torch.parallel import ring_attention",
                 "from horovod_tpu_torch.models import transformer_generate",
                 "import horovod_tpu_torch.runner",
                 "from horovod_tpu_torch import __version__"):
        r = subprocess.run([sys.executable, "-c", stmt], cwd=REPO,
                           env=_env(), capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, stmt + "\n" + r.stderr
