"""The non-finite sentinel: per-bucket any-NaN/Inf flags.

Counterpart of `horovod_tpu/guard/sentinel.py`.  Each flag is an f32 0/1
scalar per gradient bucket, max-reduced over the bucket's float leaves
on the device, then OR-ed across ranks with one Max allreduce of the
stacked flag vector, so every rank holds the identical verdict the
skip-step gate keys on.  Both the input leaves (before the wire: a
quantized codec can launder a NaN through its integer cast) and the
reduced output leaves (after the reduction: overflow) feed the flag.
Nothing here reads the host.

Where the JAX package takes a mesh axis, the port takes a `ProcessSet`
(its rank and size); with no set the scan covers everything.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from ..common import basics
from ..common.basics import ProcessSet
from ..ops import collectives as C
from ._tree import is_float


def _device(leaves: Sequence[Any]) -> torch.device:
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return basics.device() if basics.is_initialized() else \
        torch.device("cpu")


def _scan(parts: List[torch.Tensor], device) -> torch.Tensor:
    """f32 0/1: whether any of the float tensors `parts` holds a
    non-finite value.  The parts of one dtype are scanned as one flat
    buffer (one `torch.cat`, then one isfinite-and-reduce), so a bucket
    of a few hundred leaves costs a handful of launches, not four a
    leaf."""
    by_dtype: dict = {}
    for t in parts:
        if t.numel():
            by_dtype.setdefault(t.dtype, []).append(
                t if t.dim() == 1 else t.reshape(-1))
    flags = [torch.logical_not(torch.isfinite(
        ts[0] if len(ts) == 1 else torch.cat(ts)).all())
        for ts in by_dtype.values()]
    if not flags:
        return torch.zeros((), dtype=torch.float32, device=device)
    flag = flags[0] if len(flags) == 1 else torch.stack(flags).any()
    return flag.to(torch.float32)


def local_nonfinite(leaves: Sequence[Any]) -> torch.Tensor:
    """f32 0/1 scalar over a flat leaf list (this rank's view only);
    integer leaves give no flag."""
    return _scan([l for l in leaves if is_float(l)], _device(leaves))


def bucket_flags_local(leaves: Sequence[Any],
                       parts: Sequence[Sequence[int]],
                       outputs: Optional[Sequence[Any]] = None
                       ) -> torch.Tensor:
    """f32[B] local per-bucket flags over the partition `parts` (index
    lists into `leaves`, as `gradient_bucket_partition` returns them).
    With `outputs` (same indexing) each bucket's flag also covers its
    reduced output leaves."""
    out: List[torch.Tensor] = []
    for idxs in parts:
        flag = local_nonfinite([leaves[i] for i in idxs])
        if outputs is not None:
            flag = torch.maximum(
                flag, local_nonfinite([outputs[i] for i in idxs]))
        out.append(flag)
    if not out:
        return torch.zeros((1,), dtype=torch.float32, device=_device(leaves))
    return torch.stack(out)


def sliced_nonfinite(leaves: Sequence[Any],
                     process_set: Optional[ProcessSet] = None
                     ) -> torch.Tensor:
    """f32 0/1 scalar over a flat leaf list, where rank r of
    `process_set` scans only the contiguous slice [r·per, (r+1)·per) of
    every float leaf (per = numel // n), plus the tail past n·per that
    every rank scans.  For replicated data (an allreduce's output) the
    cross-rank OR that follows restores full coverage while cutting the
    redundant scan n-fold; the split depends on shapes only, so the
    OR-ed verdict is the same everywhere.  With no set (or a set of
    one), the full local scan."""
    if process_set is None or process_set.size() == 1:
        return local_nonfinite(leaves)
    idx, n = process_set.rank(), process_set.size()
    parts: List[torch.Tensor] = []
    for leaf in leaves:
        if not is_float(leaf):
            continue
        flat = leaf.reshape(-1)
        per = flat.numel() // n
        parts.append(flat[idx * per:(idx + 1) * per])
        parts.append(flat[n * per:])  # the tail every rank scans
    return _scan(parts, _device(leaves))


def crossrank_or(flags: torch.Tensor,
                 process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """OR the 0/1 flag vector across ranks: one Max allreduce, exact on
    0/1 values, so every rank holds the same vector."""
    return C.allreduce(flags, op=C.Max, process_set=process_set)


__all__ = ["bucket_flags_local", "crossrank_or", "local_nonfinite",
           "sliced_nonfinite"]
