"""Hierarchical (two-tier) allreduce: ici reduce-scatter, dcn allreduce,
ici allgather.

Counterpart of `horovod_tpu/parallel/hierarchical.py` (reference:
`NCCLHierarchicalAllreduce`, selected by HOROVOD_HIERARCHICAL_ALLREDUCE):
a reduce-scatter within the slice, an allreduce of the 1/n_ici shard
across slices, an allgather within the slice, so each element crosses
the slow tier once per 1/n_ici shard.  The JAX package runs it in-jit on
the axis pair ("dcn", "hvd"); here the pair is a
`create_hierarchical_mesh` (parallel/mesh.py), whose "hvd" set is this
rank's slice and whose "dcn" set the ranks with its in-slice index, and
every leg is a `torch.distributed` collective on one of the two sets.

- `hierarchical_reduce_leaf(x, mesh, average, dcn_wire, error_feedback)`
  (:56): the flat leaf padded to a multiple of n_ici rides the three
  legs; Average divides in f32 at the end.  A cooperative `dcn_wire`
  (int8, int4, fp8_*) puts the dcn leg on the quantized ring
  (`ops/quantized.py`), with sender-side error feedback when a residual
  is passed; a cast wire (bf16, fp16) is the ring's encode = cast.
- `hierarchical_reduce_scatter(flat, mesh, dcn_wire)` (:112): the ZeRO
  substrate, Sum, ownership dcn-major: rank (d, i) gets segment
  d*n_ici + i, its position in the mesh's ranks.
- `hierarchical_all_gather(shard, mesh)` (:157): its inverse.
- `hierarchical_allreduce(tree, mesh, ...)` (:243) fuses the leaves of a
  dtype into one buffer (or size-capped sub-buckets), with the error
  feedback state of `hierarchical_error_feedback_init` (:218).
- `maybe_hierarchical(x, mesh, op_name)` (:323): the flag, the pair and
  Average or Sum route to the leaf; None otherwise (run flat).

The `*_start` forms dispatch the first (ici) leg and return a function
that waits for it and runs the rest: the stage-0 optimizer dispatches
the first leg from its backward hook and finishes at `synchronize()`.
Each leg runs in a `record_function` range (`hvd.hier.ici_rs`,
`hvd.hier.dcn`, `hvd.hier.ici_ag`).  Every rank of the mesh calls these
in the same order.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
from torch.profiler import record_function

from ..common import util
from ..common.exceptions import HorovodTpuError
from ..ops import collectives as C
from ..ops import quantized as Q
from ..ops import wire as _wire
from .mesh import is_hierarchical


def _env_dcn_wire(dtype: torch.dtype, average: bool) -> Optional[str]:
    """The env's wire of a leaf's dcn leg (HOROVOD_HIERARCHICAL_DCN_WIRE):
    float leaves under Average only (integers must sum exactly, and a
    Sum keeps exact semantics).  An unknown name raises, naming the
    valid formats."""
    if not average or not dtype.is_floating_point:
        return None
    spec = util.getenv("HIERARCHICAL_DCN_WIRE") or None
    if spec is None:
        return None
    codec = _wire.get_codec(spec)
    return None if codec.exact else codec.name


def enabled() -> bool:
    """HOROVOD_HIERARCHICAL_ALLREDUCE (the reference's name)."""
    return util.env_bool("HIERARCHICAL_ALLREDUCE", False)


def _legs(mesh):
    """(dcn set, ici set) of a hierarchical mesh."""
    if not is_hierarchical(mesh):
        raise HorovodTpuError(
            "the hierarchical collectives take a create_hierarchical_mesh "
            f"(the ('dcn', 'hvd') axis pair); got {mesh!r}")
    return mesh.sets["dcn"], mesh.sets["hvd"]


def _scatter(buf: torch.Tensor, ps) -> torch.Tensor:
    return C._reducescatter_flat(buf.contiguous(), C.Sum, ps,
                                 masked=False).wait()


def _sum(buf: torch.Tensor, ps) -> torch.Tensor:
    return C._allreduce_start(buf, C.Sum, 1.0, 1.0, ps, owned=True).wait()


def _gather(buf: torch.Tensor, ps) -> torch.Tensor:
    return C._allgather_start(buf.contiguous(), ps).wait().reshape(-1)


def reduce_leaf_start(x: torch.Tensor, mesh, average: bool,
                      dcn_wire: Optional[str] = None,
                      error_feedback: Optional[torch.Tensor] = None
                      ) -> Callable[[], Any]:
    """Dispatch `hierarchical_reduce_leaf`'s ici reduce-scatter; the
    returned function waits for it, runs the dcn and ici legs and gives
    the leaf's result."""
    if error_feedback is not None and not dcn_wire:
        raise ValueError(
            "error_feedback requires a quantized dcn_wire (the exact "
            "psum drops nothing)")
    if dcn_wire:
        _wire.get_codec(dcn_wire)
    dcn, ici = _legs(mesh)
    n_ici, n_dcn = ici.size(), dcn.size()
    flat = x.detach().reshape(-1)
    pad = (-flat.numel()) % n_ici
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    with record_function("hvd.hier.ici_rs"):
        rs = C._reducescatter_flat(flat.contiguous(), C.Sum, ici,
                                   masked=False)

    def finish():
        with record_function("hvd.hier.ici_rs"):
            s = rs.wait()
        resid = None
        with record_function("hvd.hier.dcn"):
            if dcn_wire:
                s = Q.quantized_allreduce_shard(
                    s, dcn, average=False, wire=dcn_wire,
                    error_feedback=error_feedback)
                if error_feedback is not None:
                    s, resid = s
            else:
                s = _sum(s, dcn)
        with record_function("hvd.hier.ici_ag"):
            g = _gather(s, ici)
        out = g[:x.numel()].reshape(x.shape)
        if average:
            out = _wire.true_div(out.float(), n_ici * n_dcn).to(x.dtype)
        if error_feedback is not None:
            return out, resid
        return out

    return finish


def hierarchical_reduce_leaf(x: torch.Tensor, mesh, average: bool,
                             dcn_wire: Optional[str] = None,
                             error_feedback: Optional[torch.Tensor] = None):
    """One leaf through the three legs (the module docstring).  With
    `error_feedback` (f32, `dcn_shard_size(x.numel(), n_ici)` elements:
    this rank's dcn shard) returns `(out, new_residual)`: the residual
    lives in the ici-scattered sum space, and since the scatter is
    static, carrying it per rank telescopes the dcn wire's dropped bits
    as in the flat ring."""
    return reduce_leaf_start(x, mesh, average, dcn_wire, error_feedback)()


def reduce_scatter_start(flat: torch.Tensor, mesh,
                         dcn_wire: Optional[str] = None
                         ) -> Callable[[], torch.Tensor]:
    """Dispatch `hierarchical_reduce_scatter`'s ici leg; the returned
    function finishes it."""
    codec = _wire.get_codec(dcn_wire)
    dcn, ici = _legs(mesh)
    n_ici, n_dcn = ici.size(), dcn.size()
    total = n_ici * n_dcn
    if flat.dim() != 1 or flat.numel() % total:
        raise HorovodTpuError(
            f"hierarchical_reduce_scatter needs a flat buffer divisible "
            f"by n_ici*n_dcn ({total}); got shape {tuple(flat.shape)}")
    seg = flat.numel() // total
    # Pre-permute so that the ici-then-dcn scatter lands segment
    # d*n_ici + i on rank (d, i): the ici scatter hands in-slice rank i
    # the i-th (n_dcn*seg)-block, which must hold segments {d*n_ici+i}_d.
    f2 = flat.detach().reshape(n_dcn, n_ici, seg).transpose(0, 1).reshape(-1)
    with record_function("hvd.hier.ici_rs"):
        rs = C._reducescatter_flat(f2.contiguous(), C.Sum, ici, masked=False)

    def finish():
        with record_function("hvd.hier.ici_rs"):
            a = rs.wait()
        with record_function("hvd.hier.dcn"):
            if codec.cooperative:
                return Q.quantized_reducescatter_shard(
                    a.float(), dcn, wire=codec.name).to(flat.dtype)
            if not codec.exact:
                return _scatter(a.to(codec.cast_dtype), dcn).to(flat.dtype)
            return _scatter(a, dcn)

    return finish


def hierarchical_reduce_scatter(flat: torch.Tensor, mesh,
                                dcn_wire: Optional[str] = None
                                ) -> torch.Tensor:
    """Two-level reduce-scatter of a flat buffer (Sum): the ici leg at
    full width, then a dcn reduce-scatter of the 1/n_ici shard, on
    `dcn_wire` if given (a cast wire reduces in the cast dtype; a
    cooperative one rides the quantized reduce-scatter ring with f32
    accumulation).  Ownership is dcn-major: rank (d, i) returns segment
    d*n_ici + i.  `flat.numel()` must divide by n_ici*n_dcn; callers
    pad."""
    return reduce_scatter_start(flat, mesh, dcn_wire)()


def all_gather_start(shard: torch.Tensor, mesh
                     ) -> Callable[[], torch.Tensor]:
    """Dispatch `hierarchical_all_gather`'s ici leg; the returned
    function runs the dcn leg and gives the flat result."""
    dcn, ici = _legs(mesh)
    with record_function("hvd.hier.ici_ag"):
        g = C._allgather_start(shard.detach().reshape(-1).contiguous(), ici)

    def finish():
        with record_function("hvd.hier.ici_ag"):
            block = g.wait().reshape(-1)
        with record_function("hvd.hier.dcn"):
            return _gather(block, dcn)

    return finish


def hierarchical_all_gather(shard: torch.Tensor, mesh) -> torch.Tensor:
    """Inverse of `hierarchical_reduce_scatter`: gather within the slice
    (the slice's contiguous block under dcn-major ownership), then
    across slices.  Dtype kept: a caller wanting a cast wire casts the
    shard before gathering."""
    return all_gather_start(shard, mesh)()


def dcn_shard_size(size: int, n_ici: int) -> int:
    """Elements of one rank's dcn shard for a leaf of `size` elements:
    the shape of the `error_feedback` residual a caller carries."""
    return (size + (-size) % n_ici) // n_ici


def _leaf_wire(dt: torch.dtype, average: bool,
               dcn_wire: Optional[str]) -> Optional[str]:
    """The one wire-eligibility rule of the allreduce and the error
    feedback state: the env's route when `dcn_wire` is None, else the
    explicit wire for float dtypes only."""
    if dcn_wire is None:
        return _env_dcn_wire(dt, average)
    return dcn_wire if dt.is_floating_point else None


def _fusion_groups(leaves, fusion_threshold_bytes: Optional[int] = None,
                   bucket_order=None) -> list:
    """The fused buffers of `hierarchical_allreduce` and
    `hierarchical_error_feedback_init`: `(dtype, indices)` per group, one
    group per dtype in first-occurrence order of the (permuted)
    traversal, each split into size-capped buckets under a threshold."""
    from .data_parallel import _bucket_permutation, _buckets_by_nbytes

    by_dtype: dict = {}
    for i in _bucket_permutation(len(leaves), bucket_order):
        by_dtype.setdefault(leaves[i].dtype, []).append(i)
    groups = []
    for dt, idxs in by_dtype.items():
        if fusion_threshold_bytes is None:
            groups.append((dt, idxs))
            continue
        nbytes = [leaves[i].numel() * leaves[i].element_size() for i in idxs]
        for b in _buckets_by_nbytes(nbytes, fusion_threshold_bytes):
            if b:
                groups.append((dt, [idxs[j] for j in b]))
    return groups


def hierarchical_error_feedback_init(tree: Any, ici_size: int,
                                     dcn_wire: Optional[str] = None,
                                     average: bool = True,
                                     fusion_threshold_bytes: Optional[int]
                                     = None,
                                     bucket_order=None) -> List[torch.Tensor]:
    """Zero residuals for `hierarchical_allreduce(...,
    error_feedback_state=)`: one f32 zero tensor per fused wire-eligible
    buffer of `tree` (the allreduce's grouping; pass it the same
    threshold and order), sized to this rank's dcn shard.
    `dcn_wire=None` reads the env's route."""
    from .data_parallel import _flatten

    leaves, _ = _flatten(tree)
    state = []
    for dt, idxs in _fusion_groups(leaves, fusion_threshold_bytes,
                                   bucket_order):
        if _leaf_wire(dt, average, dcn_wire):
            total = sum(leaves[i].numel() for i in idxs)
            state.append(torch.zeros(dcn_shard_size(total, ici_size),
                                     dtype=torch.float32,
                                     device=leaves[idxs[0]].device))
    return state


def hierarchical_allreduce(tree: Any, mesh, average: bool = True,
                           dcn_wire: Optional[str] = None,
                           error_feedback_state: Optional[List[torch.Tensor]]
                           = None,
                           fusion_threshold_bytes: Optional[int] = None,
                           bucket_order=None):
    """Hierarchical allreduce of a list, tuple, dict or tensor: the
    leaves of one dtype fused into one flat buffer (or size-capped
    buckets under `fusion_threshold_bytes`, in `bucket_order`), each
    buffer's first leg in flight before the first is finished.  Integer
    buffers never ride a wire.  With `error_feedback_state` (a quantized
    wire; `hierarchical_error_feedback_init` with the same threshold and
    order) returns `(reduced, new_state)`."""
    from .data_parallel import _flatten

    leaves, rebuild = _flatten(tree)
    if not leaves:
        return ((tree, error_feedback_state)
                if error_feedback_state is not None else tree)
    ef_iter = (iter(error_feedback_state)
               if error_feedback_state is not None else None)
    started = []
    wired = 0
    for dt, idxs in _fusion_groups(leaves, fusion_threshold_bytes,
                                   bucket_order):
        flats = [leaves[i].detach().reshape(-1) for i in idxs]
        buf = torch.cat(flats) if len(flats) > 1 else flats[0]
        leaf_wire = _leaf_wire(dt, average, dcn_wire)
        e = None
        if ef_iter is not None and leaf_wire:
            wired += 1
            e = next(ef_iter, None)
            if e is None:
                raise ValueError(
                    "error_feedback_state has fewer entries than "
                    "wire-eligible dtype buffers — build it with "
                    "hierarchical_error_feedback_init(tree, ici_size)")
        started.append((idxs, e is not None, reduce_leaf_start(
            buf, mesh, average, dcn_wire=leaf_wire, error_feedback=e)))
    if ef_iter is not None and next(ef_iter, None) is not None:
        raise ValueError(
            f"error_feedback_state has more entries than the {wired} "
            "wire-eligible dtype buffers — build it with "
            "hierarchical_error_feedback_init")
    out: List[Any] = [None] * len(leaves)
    new_ef = []
    for idxs, has_ef, finish in started:
        red = finish()
        if has_ef:
            red, e2 = red
            new_ef.append(e2)
        off = 0
        for i in idxs:
            sz = leaves[i].numel()
            out[i] = red[off:off + sz].reshape(leaves[i].shape)
            off += sz
    result = rebuild(out)
    if ef_iter is not None:
        return result, new_ef
    return result


def grouped_start(tensors: List[torch.Tensor], mesh, average: bool
                  ) -> Callable[[], List[torch.Tensor]]:
    """The hierarchical form of a grouped allreduce (the JAX package's
    in-jit `grouped_allreduce` on the pair under the flag): one buffer a
    dtype, each through `reduce_leaf_start` with the env's dcn wire.
    Returns a function that finishes every buffer and gives the results
    in `tensors`' order."""
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    started = []
    for dt, idxs in by_dtype.items():
        buf = torch.cat([tensors[i].detach().reshape(-1) for i in idxs])
        started.append((idxs, reduce_leaf_start(
            buf, mesh, average, dcn_wire=_env_dcn_wire(dt, average))))

    def finish():
        out: List[Any] = [None] * len(tensors)
        for idxs, fin in started:
            red = fin()
            off = 0
            for i in idxs:
                sz = tensors[i].numel()
                out[i] = red[off:off + sz].reshape(tensors[i].shape)
                off += sz
        return out

    return finish


def routes(axis_name, op) -> bool:
    """Whether a reduction over `axis_name` with `op` takes the
    hierarchical path: a hierarchical mesh, the flag, Average or Sum."""
    return (is_hierarchical(axis_name) and enabled()
            and op in (C.Average, C.Sum))


def maybe_hierarchical(x: torch.Tensor, axes, op_name: str):
    """`hvd.allreduce`'s dispatch hook in the JAX package: a hierarchical
    mesh plus the flag routes Average / Sum through the leaf, with the
    env's dcn wire.  None when the flat path should run instead."""
    if not is_hierarchical(axes):
        return None
    if not enabled() or op_name not in ("Average", "Sum"):
        return None
    average = op_name == "Average"
    return hierarchical_reduce_leaf(
        x, axes, average=average,
        dcn_wire=_env_dcn_wire(x.dtype, average))


__all__ = [
    "dcn_shard_size",
    "enabled",
    "hierarchical_all_gather",
    "hierarchical_allreduce",
    "hierarchical_error_feedback_init",
    "hierarchical_reduce_leaf",
    "hierarchical_reduce_scatter",
    "maybe_hierarchical",
]
