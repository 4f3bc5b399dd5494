"""Gradient bucketing: the partitions the ZeRO ladder is built on.

Counterpart of the pure functions of `horovod_tpu/parallel/data_parallel.py`:
`_buckets_by_nbytes` (:70), `gradient_bucket_partition` (:143) and
`shard_group_partition` (:204).  For the same leaf shapes and dtypes they
give the same index lists as the JAX package.  Wire sizes are read from
tensor metadata: each leaf's compressor runs on a `meta` tensor of its
shape and dtype, so nothing is computed or allocated.

Not ported yet: the straggler-reaction cap on the bucket count, the
cooperative compressors' integer-leaves-first bucket (no cooperative
compressor is ported), `wire_policy_plan` and `fused_pipeline_plan`.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from ..ops.compression import Compression


def _bucket_permutation(n: int, bucket_order) -> List[int]:
    """Leaf traversal order for bucket formation: "forward" (leaf
    order), "reverse" (backward-availability order: autograd produces the
    last layer's gradients first), or an explicit permutation."""
    if bucket_order is None or bucket_order == "forward":
        return list(range(n))
    if bucket_order == "reverse":
        return list(range(n - 1, -1, -1))
    if isinstance(bucket_order, str):
        raise ValueError(
            f"bucket_order must be 'forward', 'reverse', or an explicit "
            f"permutation sequence, got {bucket_order!r}")
    perm = [int(i) for i in bucket_order]
    if sorted(perm) != list(range(n)):
        raise ValueError(
            f"bucket_order permutation must rearrange range({n}) exactly "
            f"once each, got {perm}")
    return perm


def _buckets_by_nbytes(nbytes: Sequence[int], threshold_bytes: int,
                       bucket_order="forward") -> List[List[int]]:
    """Greedy size-capped bucketing over per-item byte counts; buckets
    hold original indices, in `bucket_order` traversal order."""
    buckets: List[List[int]] = [[]]
    cur = 0
    for i in _bucket_permutation(len(nbytes), bucket_order):
        if buckets[-1] and cur + nbytes[i] > threshold_bytes:
            buckets.append([])
            cur = 0
        buckets[-1].append(i)
        cur += nbytes[i]
    return buckets


def _wire_nbytes(t: torch.Tensor, compression) -> int:
    """Bytes of `t` on the wire after `compression`, from metadata (the
    optimizer's hooks call this for every gradient: the exact wire needs
    no compressor call)."""
    if compression is Compression.none:
        return math.prod(t.shape) * t.dtype.itemsize
    c = compression.compress(torch.empty(t.shape, dtype=t.dtype,
                                         device="meta"))[0]
    return c.numel() * c.element_size()


def gradient_bucket_partition(leaves: Sequence[torch.Tensor],
                              compression=Compression.none,
                              fusion_threshold_bytes: Optional[int] = None,
                              bucket_order=None) -> List[List[int]]:
    """The bucket partition of `leaves` (tensors, or anything with their
    shape and dtype): a list of original-index lists covering every leaf
    once, in collective-issue order.  Defaults come from the live
    tunables (HOROVOD_FUSION_THRESHOLD, HOROVOD_BUCKET_ORDER,
    HOROVOD_MIN_BUCKETS)."""
    from ..utils.autotune import (current_bucket_order,
                                  current_fusion_threshold,
                                  current_min_buckets)

    if fusion_threshold_bytes is None:
        fusion_threshold_bytes = current_fusion_threshold()
    if bucket_order is None:
        bucket_order = current_bucket_order()
    nbytes = [_wire_nbytes(t, compression) for t in leaves]
    cap = fusion_threshold_bytes
    m = current_min_buckets()
    if m > 1 and nbytes:
        # At least `m` buckets: cap the effective threshold.
        cap = min(cap, max(1, -(-sum(nbytes) // m)))
    return [b for b in _buckets_by_nbytes(nbytes, cap, bucket_order) if b]


def shard_group_partition(leaves: Sequence[torch.Tensor],
                          compression=Compression.none,
                          fusion_threshold_bytes: Optional[int] = None,
                          bucket_order=None) -> List[List[int]]:
    """The ZeRO shard groups: the buckets of `gradient_bucket_partition`
    split further by dtype (a flat shard buffer holds one dtype), in
    order of first appearance.  The sharded optimizer and
    `zero3_placement` both bake this partition, so gradient shards,
    optimizer-state shards and parameter rows cover the same groups."""
    groups = []
    for idxs in gradient_bucket_partition(
            leaves, compression=compression,
            fusion_threshold_bytes=fusion_threshold_bytes,
            bucket_order=bucket_order):
        by_dt: dict = {}
        for i in idxs:
            by_dt.setdefault(leaves[i].dtype, []).append(i)
        groups.extend(by_dt.values())
    return groups
