"""The training-health guard (counterpart of `horovod_tpu/guard/`).

Four layers:

1. **Non-finite sentinel** (`sentinel`): per-bucket any-NaN/Inf flags
   taken as the gradient reduction finishes each bucket, OR-ed across
   ranks with one Max allreduce, one scalar per bucket.
2. **Coordinated skip-step and dynamic loss scaling** (`loss_scale`):
   on a flagged step every rank skips the optimizer step and decays the
   scale; clean streaks grow it back.
3. **Cross-replica divergence detection** (`digest`): periodic
   per-bucket parameter checksums, allgathered and compared bit for bit.
4. **Escalation ladder** (`controller.TrainingGuard`): K consecutive
   flagged steps or any digest mismatch restore the last
   digest-verified checkpoint, reset the wire's error feedback, bump the
   generation, and resume.

Arm the first two with `DistributedOptimizer(..., guard=True)` (or
HOROVOD_GUARD=1, or a `DynamicLossScale`); wrap the loop with
`TrainingGuard` for the other two.
"""

from .controller import GuardVerdict, TrainingGuard  # noqa: F401
from .digest import check_replica_divergence, param_digests  # noqa: F401
from .loss_scale import (  # noqa: F401
    DynamicLossScale,
    GuardState,
    select_on_flag,
)
from .sentinel import (  # noqa: F401
    bucket_flags_local,
    crossrank_or,
    local_nonfinite,
    sliced_nonfinite,
)

__all__ = [
    "DynamicLossScale",
    "GuardState",
    "GuardVerdict",
    "TrainingGuard",
    "bucket_flags_local",
    "check_replica_divergence",
    "crossrank_or",
    "local_nonfinite",
    "param_digests",
    "select_on_flag",
    "sliced_nonfinite",
]
