"""The env-seeded tunables that the shard-group partition and the fused
pipeline's chunk plan read.

Counterpart of the `current_*` readers of `horovod_tpu/utils/autotune.py`
(`current_bucket_order` :491, `current_min_buckets` :506,
`current_zero_stage` :549, `current_fusion_threshold` :564,
`current_fused_chunk_bytes` :631).  The JAX package lets a live tuner
override each of them; the port has no tuner yet, so each returns its
env value (HOROVOD_*), validated as the JAX readers validate it.
"""

from __future__ import annotations

from ..common import util

BUCKET_ORDERS = ("forward", "reverse")


def current_bucket_order() -> str:
    """HOROVOD_BUCKET_ORDER: "reverse" (default, backward-availability
    order) or "forward"."""
    order = util.bucket_order()
    if order not in BUCKET_ORDERS:
        raise ValueError(f"HOROVOD_BUCKET_ORDER must be one of "
                         f"{BUCKET_ORDERS}, got {order!r}")
    return order


def current_min_buckets() -> int:
    """HOROVOD_MIN_BUCKETS (1 = no floor on the bucket count)."""
    return util.min_buckets()


def current_zero_stage() -> int:
    """HOROVOD_ZERO_STAGE (default 0, or 1 when HOROVOD_SHARD_OPTIMIZER
    is set)."""
    stage = util.zero_stage()
    if stage not in (0, 1, 2, 3):
        raise ValueError(f"HOROVOD_ZERO_STAGE must be 0..3, got {stage}")
    return stage


def current_fusion_threshold() -> int:
    """HOROVOD_FUSION_THRESHOLD in bytes (64 MiB default)."""
    return util.fusion_threshold()


def current_fused_chunk_bytes() -> int:
    """HOROVOD_FUSED_CHUNK_BYTES (1 MiB default)."""
    return util.fused_chunk_bytes()
