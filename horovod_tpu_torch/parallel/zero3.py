"""ZeRO-3: parameters sharded at rest, gathered for each step.

Counterpart of `horovod_tpu/parallel/zero3.py` (`ZeroParamPlacement`
:76, `zero3_placement` :406).  The placement bakes the same
`shard_group_partition` as `DistributedOptimizer(zero_stage=3)` and
keeps, per shard group, only this rank's (1, shard) row of the group's
flat, padded buffer (the JAX package's placed layout: one process is one
rank here, so the (n, shard) compat stack has no use).

    placement = hvd.zero3_placement(model.parameters())
    rows = placement.shard(model.parameters())
    placement.bind(model.parameters())       # views, released
    for step ...:
        placement.gather(rows)               # into the group buffers
        ... forward, backward; updates = opt.step()   # zero_stage=3
        rows = placement.apply_updates(rows, updates)
        placement.release()                  # only the rows stay

`bind` makes every parameter a view of its group's flat buffer, at
`unpack`'s offsets, so that `gather` writes each group's allgather
straight into the buffer the parameters read (no per-leaf copy), and
`release` frees every buffer's storage between steps: the parameters
keep their shapes, and reading one while released raises.  As in the
JAX package's compiled step, every group stays gathered from the
forward through the backward and the optimizer step.  Unbound, `gather`
returns fresh full tensors in leaf order.

`gather` issues every group's allgather at once, in `prefetch_order`
(the reversed partition order: the partition's first group holds the
last layers, so the forward consumes groups back to front).  Routing
(`_gather_start`): HOROVOD_FUSED_COLLECTIVES=1 takes
`pipelined_allgather_shard`; a cast gather wire (bf16 / fp16,
HOROVOD_ZERO_GATHER_WIRE) gathers in the cast dtype and copies once per
group; the exact wire gathers the row as it is.  A cooperative gather
wire (int8, int4, fp8_*) is routed as the JAX package routes it
(zero3.py:255-275): under the fused pipeline
`pipelined_allgather_shard(wire=)`, else `quantized_allgather_shard`.
Every rank, the owner included, holds the decoded row, so the gathered
parameters are bitwise equal across ranks, while the rows at rest stay
exact.

`gather_matmul` computes `x @ Wᵀ` for a group that holds one 2-D leaf W,
the gather fused behind the matmul (`fused_allgather_matmul`, on the
gather wire): the transformer's tied head.  Like the JAX kernel path it serves forward
products only.  `regroup(n_new)` re-cuts the placement for another world
size (the elastic reshard's companion, JAX :224-240).

`axis_name=` a `create_hierarchical_mesh` (JAX :94-99, :255-259, :287):
every group's gather is `hierarchical_all_gather` (ici, then dcn; a cast
gather wire casts the row first), the dcn-major owner of a row being
the rank itself.  A cooperative gather wire and `gather_matmul` refuse
the pair, as in the JAX package: the ring spans one set.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..common import basics, util
from ..common.basics import ProcessSet
from ..common.exceptions import HorovodTpuError
from ..ops import collectives as C
from ..ops import fused_collectives as _fc
from ..ops import quantized as Q
from ..ops import wire as _wire
from ..ops.compression import Compression
from . import hierarchical as _hier
from .data_parallel import check_axis, shard_group_partition


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


def group_buffer(leaves: Sequence[torch.Tensor],
                 g: _GroupMeta) -> Optional[torch.Tensor]:
    """Group g's flat buffer of `g.padded` elements, when its leaves are
    contiguous views of one laid out as `unpack` lays them (a bound
    placement's parameters, the updates of a stage-3 step); else None.
    Read from the leaves' storages and offsets alone."""
    first = leaves[g.idxs[0]]
    st = first.untyped_storage()
    if st.data_ptr() == 0:
        return None
    base = off = first.storage_offset()
    for i, sz, shp in zip(g.idxs, g.sizes, g.shapes):
        leaf = leaves[i]
        if (leaf.dtype != g.dtype or tuple(leaf.shape) != shp
                or not leaf.is_contiguous()
                or leaf.untyped_storage().data_ptr() != st.data_ptr()
                or leaf.storage_offset() != off):
            return None
        off += sz
    if st.nbytes() < (base + g.padded) * first.element_size():
        return None
    return torch.empty(0, dtype=g.dtype, device=first.device).set_(
        st, base, (g.padded,))


class _ReleasedParameter(torch.nn.Parameter):
    """A bound parameter while its group's storage is released.  It
    keeps its shape, dtype, device and `.grad`, so the optimizer's param
    groups and the partition checks stay valid; any operation that would
    read its values raises instead of reading freed memory (torch's
    `UninitializedParameter` swaps its class the same way)."""

    _metadata = {torch.Tensor.__hash__, torch.Tensor.size,
                 torch.Tensor.dim, torch.Tensor.numel,
                 torch.Tensor.nelement, torch.Tensor.element_size,
                 torch.Tensor.untyped_storage, torch.Tensor.storage_offset,
                 torch.Tensor.stride, torch.Tensor.is_contiguous,
                 torch.Tensor.is_floating_point, torch.Tensor.is_complex}

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        # Attribute reads and writes (shape, dtype, grad, ...) arrive as
        # a descriptor's method-wrapper; `.data` would hand out the
        # freed storage.
        attr = getattr(getattr(func, "__self__", None), "__name__", None)
        if func in cls._metadata or (
                type(func).__name__ == "method-wrapper" and attr != "data"):
            return super().__torch_function__(func, types, args,
                                              kwargs or {})
        raise HorovodTpuError(
            f"{getattr(func, '__name__', func)} read a ZeRO-3 parameter "
            "whose storage is released between steps: call "
            "placement.gather(rows) first")

    def __repr__(self):
        return (f"ReleasedParameter(shape={tuple(self.shape)}, "
                f"dtype={self.dtype})")


class ZeroParamPlacement:
    """Parameter residency for ZeRO stage 3 (build it with
    `zero3_placement`).  Holds the baked shard-group partition and moves
    parameters between the sharded at-rest rows (`shard`,
    `apply_updates`) and the full live tensors (`gather`,
    `gather_matmul`)."""

    def __init__(self, params, process_set: Optional[ProcessSet] = None,
                 compression=Compression.none,
                 fusion_threshold_bytes: Optional[int] = None,
                 bucket_order=None, gather_wire: Optional[str] = None,
                 axis_name=None):
        if gather_wire is None:
            gather_wire = util.zero_gather_wire()
        codec = _wire.get_codec(gather_wire)
        self._codec = codec
        self.gather_wire = None if codec.exact else codec.name
        self._mesh = check_axis(axis_name, process_set)
        if codec.cooperative and self._mesh is not None:
            raise ValueError(
                f"gather_wire={codec.name!r} rides the ring payload "
                "gather, which spans ONE named axis — with a "
                "hierarchical 2-tuple axis_name use a cast wire "
                f"({', '.join(_wire.cast_wire_names())}) instead")
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
        self._rows: Tuple[torch.Tensor, ...] = ()  # the last rows seen
        self._bound: Optional[List[torch.Tensor]] = None
        self._flats: List[torch.Tensor] = []

    # -- layout ------------------------------------------------------------

    @property
    def full_bytes(self) -> int:
        """Replicated parameter bytes."""
        return sum(sz * torch.empty((), dtype=dt).element_size()
                   for _, sz, dt in self._leaf_meta)

    def resident_bytes(self) -> int:
        """The parameter bytes this placement holds now, read from the
        storages: the rows it last made or was given, and every bound
        parameter and group buffer (0 once released).  Between steps,
        one shard row per group: about full_bytes / n plus at most one
        pad element per group."""
        held = {}
        for t in (*self._rows, *self._flats, *(self._bound or ())):
            st = t.untyped_storage()
            held[st.data_ptr()] = st.nbytes()
        return sum(held.values())

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
        """This rank's (1, shard) band of group g's buffer over `leaves`:
        a view when the leaves are views of one buffer (`group_buffer`),
        else a copy from the leaves that overlap it."""
        lo = self.rank * g.shard_sz
        flat = group_buffer(leaves, g)
        if flat is not None:
            return flat[lo:lo + g.shard_sz].reshape(1, g.shard_sz)
        return group_slice(leaves, g.idxs, g.dtype, lo,
                           lo + g.shard_sz).reshape(1, g.shard_sz)

    def _check_leaves(self, leaves, what: str) -> None:
        if len(leaves) != len(self._leaf_meta) or any(
                tuple(l.shape) != m[0] for l, m in zip(leaves,
                                                       self._leaf_meta)):
            raise ValueError(
                f"zero3_placement.{what}: params do not match the leaves "
                "the placement was built from — re-init the placement")

    def shard(self, params) -> Tuple[torch.Tensor, ...]:
        """Parameters → this rank's at-rest rows: one (1, shard) tensor
        per shard group (a copy; the parameters are not touched)."""
        leaves = _leaves(params)
        self._check_leaves(leaves, "shard")
        self._rows = tuple(self._band(leaves, g).clone()
                           for g in self.groups)
        return self._rows

    # -- residency: parameters as views of the group buffers ---------------

    def bind(self, params) -> None:
        """Make every parameter (the leaves the placement was built from)
        a view of its group's flat buffer, at `unpack`'s offsets, and
        release the buffers.  From here on the parameters' values live in
        the rows: `gather(rows)` writes them into the buffers, `release()`
        frees the buffers again.  Take `shard` (and broadcast the
        parameters or the optimizer's state) before binding."""
        leaves = _leaves(params)
        self._check_leaves(leaves, "bind")
        self._flats = []
        for g in self.groups:
            flat = torch.empty(g.padded, dtype=g.dtype,
                               device=leaves[g.idxs[0]].device)
            for i, view in unpack(g, flat):
                leaves[i].data = view
            self._flats.append(flat)
        self._bound = leaves
        self.release()

    def release(self) -> None:
        """Free every group buffer's storage: the bound parameters hold 0
        bytes and raise if read, until the next `gather`."""
        if self._bound is None:
            raise HorovodTpuError("release() needs bind(params) first")
        for flat in self._flats:
            flat.untyped_storage().resize_(0)
        for p in self._bound:
            p.__class__ = _ReleasedParameter

    # -- gather -------------------------------------------------------------

    def _gather_start(self, row: torch.Tensor, g: _GroupMeta,
                      out: Optional[torch.Tensor] = None):
        """Start gathering one group's rows (`_gather_flat`'s routing);
        returns a function that waits and gives the rank-major flat
        buffer in the group's dtype: `out` when given (a cast wire lands
        in a buffer of its own and is copied into `out` once)."""
        codec = self._codec
        if self._mesh is not None:
            send = row.reshape(-1)
            if codec.cast_dtype is not None:
                send = send.to(codec.cast_dtype)
            finish = _hier.all_gather_start(send, self._mesh)
            if out is None:
                return lambda: finish().to(g.dtype)
            return lambda: out.copy_(finish())
        if codec.cooperative:
            send = row.reshape(-1)
            if _fc.fused_enabled():
                full = _fc.pipelined_allgather_shard(
                    send, self.process_set, wire=codec.name, out=out)
                return lambda: full if out is not None else full.to(g.dtype)
            wait = Q.allgather_start(send, self.process_set, codec)
            if out is None:
                return lambda: wait().reshape(-1).to(g.dtype)
            return lambda: out.copy_(wait().reshape(-1))
        cast = codec.cast_dtype
        send = row.reshape(-1)
        send = send.to(cast) if cast is not None else send
        land = out if cast is None else None
        if _fc.fused_enabled():
            full = _fc.pipelined_allgather_shard(send, self.process_set,
                                                 out=land)
            wait = lambda: full  # noqa: E731
        else:
            wait = C._allgather_start(send, self.process_set, out=land).wait
        if out is None:
            return lambda: wait().to(g.dtype)
        if land is None:
            return lambda: out.copy_(wait())
        return wait

    def gather(self, rows) -> List[torch.Tensor]:
        """At-rest rows → the full parameters, as a list in leaf order.
        Every group's gather is issued in `prefetch_order` before the
        first is waited for.  Bound (`bind`), each group's gather lands
        in its buffer, whose storage it restores, and the list holds the
        parameters themselves; unbound, fresh tensors."""
        rows = tuple(rows)
        self._check_drift(rows)
        self._rows = rows
        if self._bound is not None:
            started = []
            for gi in self.prefetch_order:
                g, flat = self.groups[gi], self._flats[gi]
                flat.untyped_storage().resize_(g.padded * flat.element_size())
                started.append(self._gather_start(rows[gi], g, out=flat))
            for wait in started:
                wait()
            for p in self._bound:
                p.__class__ = torch.nn.Parameter
            return list(self._bound)
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
        self._rows = rows
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
        if self._mesh is not None:
            raise ValueError(
                "gather_matmul spans ONE named axis (the fused gather "
                "rides the flat ring) — gather() the group instead")
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

    def regroup(self, n_new: int) -> "ZeroParamPlacement":
        """The same placement re-cut for a world of `n_new` ranks (the
        companion object after an elastic shrink or grow, or a
        checkpoint load on another mesh): the leaves, tunables and
        shard-group partition carry over (the partition does not depend
        on the world size); each group's padded length and shard size
        are recomputed.  The copy is unbound and holds no rows."""
        if n_new < 1:
            raise ValueError(f"regroup needs n_new >= 1, got {n_new}")
        clone = object.__new__(ZeroParamPlacement)
        clone.__dict__.update(self.__dict__)
        clone.n = int(n_new)
        clone.groups = tuple(
            g._replace(padded=sum(g.sizes) + (-sum(g.sizes)) % clone.n,
                       shard_sz=(sum(g.sizes) + (-sum(g.sizes)) % clone.n)
                       // clone.n)
            for g in self.groups)
        clone._rows, clone._bound, clone._flats = (), None, []
        return clone

    # -- update ------------------------------------------------------------

    def apply_updates(self, rows, updates) -> Tuple[torch.Tensor, ...]:
        """Fold a full list of additive updates (the rank-identical output
        of `DistributedOptimizer(zero_stage=3).step()`) into the at-rest
        rows: each row adds this rank's band, one op per group when the
        updates are views of one flat buffer per group (as the step
        returns them).  Returns new rows."""
        rows = tuple(rows)
        self._check_drift(rows)
        leaves = _leaves(updates)
        if len(leaves) != len(self._leaf_meta):
            raise ValueError(
                "zero3_placement.apply_updates: updates do not match the "
                "leaves the placement was built from")
        self._rows = tuple(r + self._band(leaves, g).to(r.dtype)
                           for g, r in zip(self.groups, rows))
        return self._rows


def zero3_placement(params, process_set: Optional[ProcessSet] = None,
                    compression=Compression.none,
                    fusion_threshold_bytes: Optional[int] = None,
                    bucket_order=None,
                    gather_wire: Optional[str] = None,
                    axis_name=None) -> ZeroParamPlacement:
    """Build the ZeRO-3 parameter placement over `params` (env:
    HOROVOD_ZERO_GATHER_WIRE for the gather wire).  Pass the same
    `compression` / `fusion_threshold_bytes` / `bucket_order` as the
    companion `DistributedOptimizer(zero_stage=3)`, so that both bake
    the same shard-group partition, and the same `axis_name` (a
    `create_hierarchical_mesh`)."""
    return ZeroParamPlacement(
        params, process_set=process_set, compression=compression,
        fusion_threshold_bytes=fusion_threshold_bytes,
        bucket_order=bucket_order, gather_wire=gather_wire,
        axis_name=axis_name)


__all__ = ["ZeroParamPlacement", "group_buffer", "zero3_placement"]
