"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

A package of its own beside the JAX package `horovod_tpu`, which stays
the reference.  It imports torch and numpy, never jax, and nothing of
`horovod_tpu`.  Collectives run through `torch.distributed` (NCCL on the
card, gloo where ranks share a card or run on the CPU); the JAX
package's Pallas kernels are CUDA kernels written for Hopper
(`csrc/`, built with nvcc at first use).

    import horovod_tpu_torch as hvd          # or: horovod_tpu_torch.torch
    hvd.init()                               # init(device="cpu") on a host
    opt = hvd.DistributedOptimizer(opt, named_parameters=model.named_parameters(),
                                   op=hvd.Adasum)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
"""

from .torch import *  # noqa: F401,F403
from .torch import __all__  # noqa: F401
from .version import __version__  # noqa: F401

# The training-health guard (horovod_tpu/__init__.py:196-203).
from . import guard  # noqa: F401,E402
from .guard import DynamicLossScale, GuardState, TrainingGuard  # noqa: F401,E402

# The hierarchical data plane (horovod_tpu/__init__.py:186-192).
from .parallel.hierarchical import (  # noqa: F401,E402
    dcn_shard_size,
    hierarchical_all_gather,
    hierarchical_allreduce,
    hierarchical_error_feedback_init,
    hierarchical_reduce_scatter,
)

# The runtime utilities (horovod_tpu/__init__.py:161-169).
from .utils.prefetch import BackgroundPrefetcher, prefetch_to_device  # noqa: F401,E402
from .utils.timeline import start_timeline, stop_timeline  # noqa: F401,E402

# The rest of the JAX package's top level (horovod_tpu/__init__.py:44-194):
# the process queries of a one-rank-a-process port, the errors, the
# wire codecs, the gradient reduction and its plans, the tuner, and the
# framework-neutral frontend (the tape and the callbacks).  The
# torch-level `broadcast_parameters` / `broadcast_optimizer_state` above
# stay the in-place horovod.torch forms; the tree forms are
# `ops.functions`'.
from .common.basics import (  # noqa: F401,E402
    local_device_ranks,
    num_processes,
    process_index,
)
from .common.exceptions import HorovodTpuError, HostsUpdatedInterrupt  # noqa: F401,E402
from .ops.join import joined_ranks  # noqa: F401,E402
from .ops.wire import (  # noqa: F401,E402
    WireCodec,
    WirePolicy,
    get_codec,
    parse_wire_policy,
    wire_names,
)
from .parallel.data_parallel import (  # noqa: F401,E402
    DistributedGradientTape,
    allreduce_gradients,
    data_parallel,
    distributed_grad,
    error_feedback_init,
    fused_pipeline_plan,
    gradient_bucket_partition,
    shard_batch,
    wire_policy_plan,
)
from .utils.autotune import ParameterManager  # noqa: F401,E402
from .utils.autotune import get_manager as autotune_manager  # noqa: F401,E402
from . import callbacks  # noqa: F401,E402
