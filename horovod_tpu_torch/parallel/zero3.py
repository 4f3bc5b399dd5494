"""ZeRO-3: parameters sharded at rest, gathered just in time.

Counterpart of `horovod_tpu/parallel/zero3.py` (`ZeroParamPlacement`
:76, `zero3_placement` :406).  The placement bakes the same
`shard_group_partition` as `DistributedOptimizer(zero_stage=3)` and
keeps, per shard group, only this rank's (1, shard) row of the group's
flat, padded buffer (the JAX package's placed layout: one process is one
rank here, so the (n, shard) compat stack has no use).

    placement = hvd.zero3_placement(model.parameters())
    rows = placement.shard(model.parameters())
    for p, full in zip(model.parameters(), placement.gather(rows)):
        p.data.copy_(full)                  # just-in-time gather
    ... backward; updates = opt.step()       # zero_stage=3
    rows = placement.apply_updates(rows, updates)

`gather` issues every group's allgather at once, in `prefetch_order`
(the reversed partition order: the partition's first group holds the
last layers, so the forward consumes groups back to front), and unpacks
them in that order.  Routing (`_gather_flat`): HOROVOD_FUSED_COLLECTIVES=1
takes `pipelined_allgather_shard`; a cast gather wire (bf16 / fp16,
HOROVOD_ZERO_GATHER_WIRE) gathers in the cast dtype; the exact wire
gathers the row as it is.  The cooperative wires are not ported yet and
raise.

`gather_matmul` computes `x @ Wᵀ` for a group that holds one 2-D leaf W,
the gather fused behind the matmul (`fused_allgather_matmul`): the
transformer's tied head.  Like the JAX kernel path it serves forward
products only.  `regroup` (the elastic reshard) is not ported yet.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..common import basics, util
from ..common.basics import ProcessSet
from ..common.exceptions import HorovodTpuError
from ..ops import collectives as C
from ..ops import fused_collectives as _fc
from ..ops import wire as _wire
from ..ops.compression import Compression
from .data_parallel import shard_group_partition


class _GroupMeta(NamedTuple):
    idxs: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    dtype: torch.dtype
    padded: int
    shard_sz: int


def shard_groups(leaves: Sequence[torch.Tensor], n: int,
                 **partition_kw) -> Tuple[_GroupMeta, ...]:
    """The geometry of every shard group of `shard_group_partition` over
    `leaves` (tensors or meta tensors) at world size n: each group's
    flat buffer padded to a multiple of n, cut into n shards."""
    groups = []
    for idxs in shard_group_partition(leaves, **partition_kw):
        sizes = tuple(leaves[i].numel() for i in idxs)
        padded = sum(sizes) + (-sum(sizes)) % n
        groups.append(_GroupMeta(
            tuple(idxs), tuple(tuple(leaves[i].shape) for i in idxs), sizes,
            leaves[idxs[0]].dtype, padded, padded // n))
    return tuple(groups)


def unpack(g: _GroupMeta, full: torch.Tensor):
    """(leaf index, view) for each leaf of group g in its flat buffer."""
    off = 0
    for i, sz, shp in zip(g.idxs, g.sizes, g.shapes):
        yield i, full[off:off + sz].reshape(shp)
        off += sz


def _leaves(params) -> List[torch.Tensor]:
    """Parameters as a list: a module's `parameters()`, a
    `named_parameters()` iterable, a dict or a sequence of tensors."""
    if hasattr(params, "values"):
        params = params.values()
    out = []
    for p in params:
        out.append(p[1] if isinstance(p, tuple) else p)
    return out


def group_slice(leaves: Sequence[torch.Tensor], idxs: Sequence[int],
                dtype: torch.dtype, lo: int, hi: int) -> torch.Tensor:
    """Elements [lo, hi) of one shard group's flat buffer (its leaves
    concatenated in `dtype`, zero-padded at the end), copied from only
    the leaves that overlap it."""
    out = torch.zeros(hi - lo, dtype=dtype, device=leaves[idxs[0]].device)
    s = 0
    for i in idxs:
        f = leaves[i].detach().reshape(-1)
        a, b = max(lo, s), min(hi, s + f.numel())
        if a < b:
            out[a - lo:b - lo].copy_(f[a - s:b - s])
        s += f.numel()
    return out


class ZeroParamPlacement:
    """Parameter residency for ZeRO stage 3 (build it with
    `zero3_placement`).  Holds the baked shard-group partition and moves
    parameters between the sharded at-rest rows (`shard`,
    `apply_updates`) and the full live tensors (`gather`,
    `gather_matmul`)."""

    def __init__(self, params, process_set: Optional[ProcessSet] = None,
                 compression=Compression.none,
                 fusion_threshold_bytes: Optional[int] = None,
                 bucket_order=None, gather_wire: Optional[str] = None):
        if gather_wire is None:
            gather_wire = util.zero_gather_wire()
        codec = _wire.get_codec(gather_wire)
        self._codec = codec
        self.gather_wire = None if codec.exact else codec.name
        if process_set is not None and process_set.process_set_id != 0:
            raise ValueError(
                "zero3_placement requires the global process set: subset "
                "gathers would need group-aware shard ownership")
        self.process_set = basics.global_process_set()
        self.n = self.process_set.size()
        self.rank = self.process_set.rank()
        self._compression = compression
        self._fusion_threshold_bytes = fusion_threshold_bytes
        self._bucket_order = bucket_order
        leaves = _leaves(params)
        self._leaf_meta = tuple((tuple(l.shape), l.numel(), l.dtype)
                                for l in leaves)
        self.groups = shard_groups(
            leaves, self.n, compression=compression,
            fusion_threshold_bytes=fusion_threshold_bytes,
            bucket_order=bucket_order)
        # Reverse-availability prefetch: the forward consumes the groups
        # back to front.
        self.prefetch_order = tuple(reversed(range(len(self.groups))))

    # -- layout ------------------------------------------------------------

    @property
    def full_bytes(self) -> int:
        """Replicated parameter bytes."""
        return sum(sz * torch.empty((), dtype=dt).element_size()
                   for _, sz, dt in self._leaf_meta)

    def resident_bytes(self) -> int:
        """This rank's at-rest parameter bytes: one shard row per group,
        about full_bytes / n plus at most one pad element per group."""
        return sum(g.shard_sz * torch.empty((), dtype=g.dtype).element_size()
                   for g in self.groups)

    def _check_drift(self, rows) -> None:
        if len(rows) != len(self.groups):
            raise ValueError(
                f"zero3 shard rows do not match the baked partition "
                f"({len(rows)} vs {len(self.groups)} shard groups) — "
                "re-init the placement (and optimizer state) after "
                "tunables change")
        # The partition with the live tunables, over metadata: a moved
        # fusion threshold or bucket order fails loudly.
        fakes = [torch.empty(shp, dtype=dt, device="meta")
                 for shp, _, dt in self._leaf_meta]
        live = shard_group_partition(
            fakes, compression=self._compression,
            fusion_threshold_bytes=self._fusion_threshold_bytes,
            bucket_order=self._bucket_order)
        if [list(g.idxs) for g in self.groups] != [list(i) for i in live]:
            raise ValueError(
                "zero3 shard-group partition changed since construction "
                "(fusion threshold / bucket order moved?) — re-init the "
                "placement (and optimizer state) after tunables change")
        for g, r in zip(self.groups, rows):
            if tuple(r.shape) != (1, g.shard_sz):
                raise ValueError(
                    f"zero3 shard row {tuple(r.shape)} does not match "
                    f"(1, {g.shard_sz}) at n={self.n}: world size or "
                    "bucket contents moved since construction — re-init "
                    "the placement")

    def _band(self, leaves, g: _GroupMeta) -> torch.Tensor:
        """This rank's (1, shard) band of group g's buffer over `leaves`."""
        lo = self.rank * g.shard_sz
        return group_slice(leaves, g.idxs, g.dtype, lo,
                           lo + g.shard_sz).reshape(1, g.shard_sz)

    def shard(self, params) -> Tuple[torch.Tensor, ...]:
        """Parameters → this rank's at-rest rows: one (1, shard) tensor
        per shard group (a copy; the parameters are not touched)."""
        leaves = _leaves(params)
        if len(leaves) != len(self._leaf_meta) or any(
                tuple(l.shape) != m[0] for l, m in zip(leaves,
                                                       self._leaf_meta)):
            raise ValueError(
                "zero3_placement.shard: params do not match the leaves "
                "the placement was built from — re-init the placement")
        return tuple(self._band(leaves, g) for g in self.groups)

    # -- just-in-time gather ----------------------------------------------

    def _gather_start(self, row: torch.Tensor, g: _GroupMeta):
        """Start gathering one group's rows (`_gather_flat`'s routing);
        returns a function that waits and gives the rank-major flat
        buffer in the group's dtype."""
        cast = self._codec.cast_dtype
        send = row.reshape(-1)
        send = send.to(cast) if cast is not None else send
        if _fc.fused_enabled():
            full = _fc.pipelined_allgather_shard(send, self.process_set)
            return lambda: full.to(g.dtype)
        h = C._allgather_start(send, self.process_set)
        return lambda: h.wait().to(g.dtype)

    def gather(self, rows) -> List[torch.Tensor]:
        """At-rest rows → the full parameters, as a list in leaf order.
        Every group's gather is issued in `prefetch_order` before the
        first is unpacked."""
        rows = tuple(rows)
        self._check_drift(rows)
        started = [(gi, self._gather_start(rows[gi], self.groups[gi]))
                   for gi in self.prefetch_order]
        leaves: List[Any] = [None] * len(self._leaf_meta)
        for gi, wait in started:
            for i, t in unpack(self.groups[gi], wait()):
                leaves[i] = t.to(self._leaf_meta[i][2])
        return leaves

    def gather_matmul(self, x: torch.Tensor, rows, gi: int) -> torch.Tensor:
        """`x @ Wᵀ` for a group holding one 2-D leaf W (R, K), the
        gather fused behind the consuming matmul
        (`fused_allgather_matmul`).  x: (B, K).  Returns (B, R), columns
        in W's row order.  Forward only: it raises on tensors that
        require grad, and when torch.distributed is not initialised (the
        JAX package's in-jit-only refusal)."""
        rows = tuple(rows)
        self._check_drift(rows)
        g = self.groups[gi]
        if len(g.idxs) != 1 or len(g.shapes[0]) != 2:
            raise ValueError(
                f"gather_matmul needs a single-2D-leaf shard group; group "
                f"{gi} holds leaves {g.idxs} of shapes {g.shapes}")
        rdim, k = g.shapes[0]
        if g.padded != g.sizes[0]:
            raise ValueError(
                f"gather_matmul needs the leaf's rows to divide the rank "
                f"count evenly (got ({rdim}, {k}) over n={self.n} with "
                "padding) — gather() the group instead")
        if x.requires_grad or rows[gi].requires_grad:
            raise HorovodTpuError(
                "gather_matmul is forward-only, as in the JAX package (its "
                "K3 kernel has no backward): call it under torch.no_grad() "
                "on tensors that do not require grad")
        if not torch.distributed.is_initialized():
            raise HorovodTpuError(
                "gather_matmul needs torch.distributed initialised (the "
                "fused allgather runs over the process group); start the "
                "job with a coordinator")
        w_shard = rows[gi].reshape(rdim // self.n, k)
        return _fc.fused_allgather_matmul(x, w_shard, self.process_set,
                                          wire=self.gather_wire)

    # -- update ------------------------------------------------------------

    def apply_updates(self, rows, updates) -> Tuple[torch.Tensor, ...]:
        """Fold a full list of additive updates (the rank-identical output
        of `DistributedOptimizer(zero_stage=3).step()`) into the at-rest
        rows: each row adds this rank's band.  Returns new rows."""
        rows = tuple(rows)
        self._check_drift(rows)
        leaves = _leaves(updates)
        if len(leaves) != len(self._leaf_meta):
            raise ValueError(
                "zero3_placement.apply_updates: updates do not match the "
                "leaves the placement was built from")
        return tuple(r + self._band(leaves, g).to(r.dtype)
                     for g, r in zip(self.groups, rows))


def zero3_placement(params, process_set: Optional[ProcessSet] = None,
                    compression=Compression.none,
                    fusion_threshold_bytes: Optional[int] = None,
                    bucket_order=None,
                    gather_wire: Optional[str] = None
                    ) -> ZeroParamPlacement:
    """Build the ZeRO-3 parameter placement over `params` (env:
    HOROVOD_ZERO_GATHER_WIRE for the gather wire).  Pass the same
    `compression` / `fusion_threshold_bytes` / `bucket_order` as the
    companion `DistributedOptimizer(zero_stage=3)`, so that both bake
    the same shard-group partition."""
    return ZeroParamPlacement(
        params, process_set=process_set, compression=compression,
        fusion_threshold_bytes=fusion_threshold_bytes,
        bucket_order=bucket_order, gather_wire=gather_wire)


__all__ = ["ZeroParamPlacement", "zero3_placement"]
