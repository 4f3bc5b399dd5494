"""The collectives of the mesh axes, differentiable: the counterparts of
what `shard_map` bodies in the JAX package call on a named axis.

- `ppermute(x, perm, ps)`: `lax.ppermute`.  `perm` holds (source,
  destination) pairs of set ranks; a rank that receives nothing gets
  zeros.  Its backward is the inverse permutation.
- `all_to_all_tiled(x, split_axis, concat_axis, ps)`: tiled
  `lax.all_to_all`.  Chunk j of `split_axis` goes to set rank j, and
  the chunks received are concatenated along `concat_axis` in rank
  order.  Its backward is the inverse exchange (the two axes swapped).
- `psum(x, ps)` / `pmean(x, ps)`: forward allreduce (sum, or mean),
  backward the same allreduce of the cotangent.
- The tensor-parallel pair of Megatron: `copy_to(x, ps)` at a
  column-parallel input (forward identity, backward allreduce) and
  `reduce_from(x, ps)` at a row-parallel output (forward allreduce,
  backward identity).

Gradient convention.  Every rank runs backward from its own scalar
objective, and each backward above gives every rank the derivative of
the SUM of the ranks' objectives (the transposes that `shard_map` takes
without replication checks).  Over `tp`, whose ranks hold one objective
between them, the Megatron pair instead gives each rank the derivative
of that one objective.

Each op runs inside a `record_function` range named by its caller
(`hvd.sp.hop`, `hvd.tp.psum`, ...), forward and backward.  Over gloo a
point-to-point op of CUDA tensors stages through host memory (gloo's
send and receive take host buffers only); its all-to-all and allreduce
take CUDA tensors (`ops.collectives.sendrecv` owns that choice).  A set
of one rank exchanges nothing.  Every rank of
a set must call these in the same order: their backwards run in the
order of the autograd graph, which is the same on every rank only if
the forward is.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..common.basics import ProcessSet
from ..ops import collectives as C
from ..ops.collectives import sendrecv

Perm = Sequence[Tuple[int, int]]


def _permute(x: torch.Tensor, perm: Perm, ps: ProcessSet) -> torch.Tensor:
    me = ps.rank()
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    out = torch.zeros_like(x)
    sendrecv(ps, x if dst is not None else None, dst,
             out if src is not None else None, src)
    return out


def _check_perm(perm: Perm, n: int) -> Tuple[Tuple[int, int], ...]:
    perm = tuple((int(s), int(d)) for s, d in perm)
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
            not (0 <= r < n) for r in srcs + dsts):
        raise ValueError(f"ppermute: {perm} is not a partial permutation "
                         f"of {n} ranks")
    return perm


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, ps, name):
        ctx.perm, ctx.ps, ctx.name = perm, ps, name
        with record_function(name):
            return _permute(x, perm, ps)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        with record_function(ctx.name):
            return _permute(g.contiguous(), inverse, ctx.ps), None, None, None


def ppermute(x: torch.Tensor, perm: Perm, ps: ProcessSet,
             name: str = "hvd.ppermute") -> torch.Tensor:
    """`lax.ppermute(x, axis, perm)` over the set `ps` (see the module
    docstring)."""
    return _PPermute.apply(x, _check_perm(perm, ps.size()), ps, name)


def _a2a(x: torch.Tensor, split_axis: int, concat_axis: int,
         ps: ProcessSet) -> torch.Tensor:
    n = ps.size()
    nd = x.dim()
    split_axis, concat_axis = split_axis % nd, concat_axis % nd
    if x.shape[split_axis] % n:
        raise ValueError(
            f"all_to_all: axis {split_axis} of {tuple(x.shape)} does not "
            f"split into {n} chunks")
    xs = x.movedim(split_axis, 0)
    xs = xs.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:]))
    # out[j] is rank j's chunk for this rank.
    out = C._alltoall_start(xs.contiguous(), [1] * n, [1] * n, ps).wait()
    y = out.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(y.shape)
    shape[concat_axis:concat_axis + 2] = [n * shape[concat_axis + 1]]
    return y.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, ps, name):
        ctx.axes, ctx.ps, ctx.name = (split_axis, concat_axis), ps, name
        with record_function(name):
            return _a2a(x, split_axis, concat_axis, ps)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        with record_function(ctx.name):
            return (_a2a(g, concat_axis, split_axis, ctx.ps), None, None,
                    None, None)


def all_to_all_tiled(x: torch.Tensor, split_axis: int, concat_axis: int,
                     ps: ProcessSet, name: str = "hvd.all_to_all"
                     ) -> torch.Tensor:
    """Tiled `lax.all_to_all(x, axis, split_axis, concat_axis)` over the
    set `ps`."""
    return _AllToAll.apply(x, split_axis, concat_axis, ps, name)


def _sum(x: torch.Tensor, ps: ProcessSet) -> torch.Tensor:
    out = x.contiguous().clone()
    if ps.comm is not None:
        work = C._launch(dist.all_reduce, out, dist.ReduceOp.SUM,
                         group=ps.comm, async_op=True)
        C._Pending([work], lambda: None).wait()
    return out


class _Reduce(torch.autograd.Function):
    """forward: the sum over the set times `fwd`, or the identity where
    `fwd` is None; backward likewise with `bwd`."""

    @staticmethod
    def forward(ctx, x, ps, fwd, bwd, name):
        ctx.ps, ctx.bwd, ctx.name = ps, bwd, name
        if fwd is None:
            return x.view_as(x)
        with record_function(name):
            out = _sum(x, ps)
            return out if fwd == 1.0 else out * fwd

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd is not None:
            with record_function(ctx.name):
                g = _sum(g, ctx.ps)
                if ctx.bwd != 1.0:
                    g = g * ctx.bwd
        return g, None, None, None, None


def psum(x: torch.Tensor, ps: ProcessSet, name: str = "hvd.psum"):
    """`lax.psum`: the sum over the set; backward the same sum."""
    return _Reduce.apply(x, ps, 1.0, 1.0, name)


def pmean(x: torch.Tensor, ps: ProcessSet, name: str = "hvd.pmean"):
    """`lax.pmean`: the mean over the set; backward the same mean."""
    return _Reduce.apply(x, ps, 1.0 / ps.size(), 1.0 / ps.size(), name)


def copy_to(x: torch.Tensor, ps: ProcessSet, name: str = "hvd.tp.psum"):
    """Megatron's f, at a column-parallel input: forward the identity,
    backward the sum of the cotangent over the set."""
    return _Reduce.apply(x, ps, None, 1.0, name)


def reduce_from(x: torch.Tensor, ps: ProcessSet, name: str = "hvd.tp.psum",
                scale: float = 1.0):
    """Megatron's g, at a row-parallel output: forward the sum over the
    set times `scale`, backward the identity.  Right wherever every rank
    of the set receives the same cotangent: the sum (or mean) of the
    ranks' objectives then moves each input by exactly that cotangent."""
    return _Reduce.apply(x, ps, scale, None, name)
