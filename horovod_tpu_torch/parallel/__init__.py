"""Parallelism strategies over the device mesh (counterpart of
`horovod_tpu/parallel/__init__.py`).

`data_parallel` / `optimizer` are the horovod.torch parity surface;
`mesh`, `sequence`, `pipeline` and `moe` compose TP/SP/PP/EP over the
named axes of `create_hybrid_mesh`, one process group per axis, and
`hierarchical` is the two-tier (dcn x ici) data plane.  The names below
are the JAX package's; its JAX-only `transformer_dryrun` has no
counterpart.
"""

from .mesh import (  # noqa: F401
    AXIS_ORDER,
    MeshConfig,
    create_hierarchical_mesh,
    create_hybrid_mesh,
    mesh_axis_size,
)
from .hierarchical import (  # noqa: F401
    dcn_shard_size,
    hierarchical_all_gather,
    hierarchical_allreduce,
    hierarchical_error_feedback_init,
    hierarchical_reduce_scatter,
)
from .sequence import (  # noqa: F401
    dense_attention_oracle,
    full_attention,
    ring_attention,
    ring_attention_shard,
    ulysses_attention,
    ulysses_attention_shard,
)
from .pipeline import gpipe, gpipe_shard  # noqa: F401
from .moe import moe_apply_dense, moe_apply_shard, moe_init  # noqa: F401
