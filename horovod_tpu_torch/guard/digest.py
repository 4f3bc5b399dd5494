"""Cross-replica divergence detection: periodic parameter digests.

Counterpart of `horovod_tpu/guard/digest.py`.  Every
HOROVOD_GUARD_DIGEST_INTERVAL steps the controller takes a per-bucket
checksum of the (nominally replicated) parameters, `[sum, sum|x|]` in
f64 per bucket of the same `gradient_bucket_partition` the reduction
uses, so that a mismatch names the bucket that diverged, and allgathers
the digest matrix.  Replicas that drifted apart silently (a flipped bit,
a stale error-feedback residual, a partition fault) disagree bit for bit
in at least one row; the controller turns that into a rollback.

The port sums on the device, in f64 (`torch.sum(..., dtype=float64)`,
one leaf at a time, the leaf sums added in order): deterministic on each
rank for the same bits, and one host read per digest.  The JAX package
sums on the host in numpy; the two agree to the rounding of the
summation order.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..common import basics
from ..ops import collectives as C
from ._tree import is_float, leaves as tree_leaves


def param_digests(params: Any,
                  parts: Optional[Sequence[Sequence[int]]] = None
                  ) -> np.ndarray:
    """f64[B, 2] per-bucket `[sum, sum|x|]` over the parameter tree,
    bucketed like the gradient reduction (`parts`, index lists into the
    tree's tensor leaves, overrides the partition).  Integer tensors
    are skipped, and leaves that are not tensors (an optimizer
    `state_dict`'s hyperparameters) are not counted."""
    leaves = [l for l in tree_leaves(params) if isinstance(l, torch.Tensor)]
    if parts is None:
        from ..parallel.data_parallel import gradient_bucket_partition
        parts = gradient_bucket_partition(leaves)
    rows = []
    for idxs in parts:
        s = a = None
        for i in idxs:
            leaf = leaves[i]
            if not is_float(leaf):
                continue
            x = leaf.detach()
            ls = torch.sum(x, dtype=torch.float64)
            la = torch.sum(x.abs(), dtype=torch.float64)
            s = ls if s is None else s + ls
            a = la if a is None else a + la
        if s is None:
            rows.append(torch.zeros((2,), dtype=torch.float64))
        else:
            rows.append(torch.stack([s, a]))
    if not rows:
        return np.zeros((1, 2), np.float64)
    dev = next((r.device for r in rows if r.device.type != "cpu"),
               torch.device("cpu"))
    return torch.stack([r.to(dev) for r in rows]).cpu().numpy()


def check_replica_divergence(digests: np.ndarray,
                             process_set=None) -> Optional[int]:
    """Allgather this rank's digest matrix and compare: the index of the
    first bucket whose digest differs between any two ranks (bit for
    bit), or None when the replicas agree, when the port is not
    initialized, or at one rank."""
    if not basics.is_initialized():
        return None
    ps_size = basics.size() if process_set is None else process_set.size()
    if ps_size <= 1:
        return None
    # The f64 bit patterns, as int32 words: the comparison is bitwise.
    bits = np.ascontiguousarray(digests, np.float64).view(np.int32)
    gathered = C.allgather(torch.from_numpy(bits.copy()).to(basics.device()),
                           process_set=process_set).cpu().numpy()
    per_rank = gathered.reshape((ps_size,) + bits.shape)
    ref = per_rank[0]
    for r in range(1, ps_size):
        neq = (per_rank[r] != ref).any(axis=-1)
        if neq.any():
            return int(np.argmax(neq))
    return None


__all__ = ["check_replica_divergence", "param_digests"]
