"""`horovod_tpu_torch.torch` — the horovod.torch surface.

Counterpart of `horovod_tpu/torch/__init__.py` (reference: horovod/torch/
__init__.py, mpi_ops.py, optimizer.py, functions.py).  The JAX package
bridges torch tensors to numpy and back; here the tensors stay where
they are and the collectives run on them through `torch.distributed`.

    import horovod_tpu_torch.torch as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(opt, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

It also carries `SyncBatchNorm`, the sparse allreduce and the elastic
namespace (`hvd.elastic.run`, `TorchState`, `ElasticSampler`).
"""

from __future__ import annotations

import inspect
import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.profiler import record_function

from ..common import basics, util
from ..common.basics import (  # noqa: F401
    ProcessSet,
    add_process_set,
    autotune_record_step,
    backend,
    ccl_built,
    cross_rank,
    cross_size,
    cuda_built,
    ddl_built,
    device,
    get_process_set,
    global_process_set,
    gloo_built,
    gloo_enabled,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    rank,
    remove_process_set,
    rocm_built,
    shutdown,
    size,
    tpu_built,
    xla_built,
)
from ..common.exceptions import HorovodInternalError  # noqa: F401
from ..common.exceptions import HorovodTpuError
from ..ops import collectives as C
from ..ops.collectives import (  # noqa: F401
    Adasum,
    Average,
    HandleManager,
    Max,
    Min,
    Product,
    ReduceOp,
    Sum,
    allgather_async,
    allreduce_async,
    alltoall_async,
    barrier,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    grouped_allgather,
    grouped_allgather_async,
    grouped_allreduce_async,
    grouped_reducescatter,
    join,
    poll,
    reducescatter_async,
)
from ..ops.compression import Compression, is_cooperative  # noqa: F401
from ..ops.functions import allgather_object, broadcast_object  # noqa: F401
from ..ops.join import join_mode  # noqa: F401
from ..parallel.optimizer import (  # noqa: F401
    _ShardedOptimizer,
    grad_accum_bytes,
    optimizer_state_bytes,
)
from ..ops import wire as _wire
from ..ops.quantized import quantized_allreduce_shard
from ..guard import sentinel as _sentinel
from ..guard.loss_scale import DynamicLossScale, unscale_
from ..parallel import hierarchical as _hier
from ..metrics import catalog as _met
from ..parallel import data_parallel as _dp
from ..parallel.data_parallel import (_wire_nbytes, active_wire_policy,
                                      bucket_codec, check_axis, check_wire,
                                      gradient_bucket_partition, hier_route)
from ..parallel.zero3 import ZeroParamPlacement, zero3_placement  # noqa: F401
from ..utils.autotune import current_fusion_threshold, current_zero_stage

__all__ = [
    "Adasum", "Average", "Compression", "DistributedOptimizer",
    "HandleManager", "HorovodInternalError", "Max", "Min", "ProcessSet",
    "Product", "ReduceOp", "Sum", "SyncBatchNorm", "add_process_set",
    "allgather", "autotune_record_step", "elastic",
    "allgather_async", "allgather_object", "allreduce", "allreduce_",
    "allreduce_async", "allreduce_async_", "alltoall", "alltoall_async",
    "backend", "barrier", "broadcast", "broadcast_", "broadcast_async",
    "broadcast_async_", "broadcast_object", "broadcast_optimizer_state",
    "broadcast_parameters", "ccl_built", "cross_rank", "cross_size",
    "cuda_built", "ddl_built", "device", "get_process_set",
    "global_process_set", "gloo_built", "gloo_enabled",
    "grouped_allgather", "grouped_allgather_async", "grouped_allreduce",
    "grouped_allreduce_", "grouped_allreduce_async",
    "grouped_allreduce_async_", "grouped_reducescatter", "grad_accum_bytes",
    "init", "is_homogeneous", "is_initialized", "join", "join_mode",
    "local_rank", "local_size", "mpi_built", "mpi_enabled",
    "mpi_threads_supported", "nccl_built", "optimizer_state_bytes", "poll",
    "rank", "reducescatter", "reducescatter_async", "remove_process_set",
    "rocm_built", "shutdown", "size", "sparse_allreduce_async",
    "synchronize", "tpu_built",
    "xla_built", "ZeroParamPlacement", "zero3_placement",
]


# ---------------------------------------------------------------------------
# Differentiable collectives (reference: torch/mpi_ops.py autograd
# Functions; the JAX shim's `_AllreduceFn` ... `_GroupedAllreduceFn`).  A
# tensor that requires grad goes through its Function; any other takes
# the plain collective.
# ---------------------------------------------------------------------------

def _set_rank(ps: Optional[ProcessSet]) -> int:
    return C._resolve_set(ps).rank()


class _AllreduceFn(torch.autograd.Function):
    """The gradient of an allreduce is the allreduce of the gradients
    with the same op and scale factors."""

    @staticmethod
    def forward(ctx, tensor, op, prescale, postscale, process_set):
        ctx.args = dict(op=op, prescale_factor=prescale,
                        postscale_factor=postscale, process_set=process_set)
        return C.allreduce(tensor, **ctx.args)

    @staticmethod
    def backward(ctx, grad):
        return C.allreduce(grad, **ctx.args), None, None, None, None


class _AllgatherFn(torch.autograd.Function):
    """Backward sums the output gradient over the ranks and takes this
    rank's rows, dim 0 ragged included."""

    @staticmethod
    def forward(ctx, tensor, process_set):
        ctx.ps, ctx.n0 = process_set, tensor.shape[0]
        return C.allgather(tensor, process_set=process_set)

    @staticmethod
    def backward(ctx, grad):
        summed = C.allreduce(grad, op=Sum, process_set=ctx.ps)
        sizes = C.allgather(torch.tensor([ctx.n0], dtype=torch.int64,
                                         device=grad.device),
                            process_set=ctx.ps)
        begin = int(sizes[:_set_rank(ctx.ps)].sum())
        return summed[begin:begin + ctx.n0], None


class _BroadcastFn(torch.autograd.Function):
    """The gradients sum onto the root; the other ranks' inputs did not
    reach the output, so theirs is zero."""

    @staticmethod
    def forward(ctx, tensor, root_rank, process_set):
        ctx.ps, ctx.root = process_set, root_rank
        return C.broadcast(tensor, root_rank=root_rank,
                           process_set=process_set)

    @staticmethod
    def backward(ctx, grad):
        red = C.allreduce(grad, op=Sum, process_set=ctx.ps)
        if _set_rank(ctx.ps) != ctx.root:
            red = torch.zeros_like(red)
        return red, None, None


class _ReducescatterFn(torch.autograd.Function):
    """Backward allgathers the rows' gradients (ragged when the rows did
    not divide), divided by n for Average."""

    @staticmethod
    def forward(ctx, tensor, op, process_set):
        ctx.op, ctx.ps = op, process_set
        return C.reducescatter(tensor, op=op, process_set=process_set)

    @staticmethod
    def backward(ctx, grad):
        g = C.allgather(grad, process_set=ctx.ps)
        if ctx.op is Average:
            g = g / C._resolve_set(ctx.ps).size()
        return g, None, None


class _AlltoallFn(torch.autograd.Function):
    """The gradient goes back by another alltoall: with the received
    splits when splits were given (each rank returns what it got), by
    equal chunks when not."""

    @staticmethod
    def forward(ctx, tensor, splits, process_set):
        ctx.ps = process_set
        if splits is None:
            ctx.back = None
            return C.alltoall(tensor, process_set=process_set)
        out, rsplits = C.alltoall(tensor, splits=splits,
                                  process_set=process_set)
        ctx.back = rsplits
        ctx.mark_non_differentiable(rsplits)
        return out, rsplits

    @staticmethod
    def backward(ctx, grad, *_):
        if ctx.back is None:
            return C.alltoall(grad, process_set=ctx.ps), None, None
        g, _ = C.alltoall(grad, splits=ctx.back, process_set=ctx.ps)
        return g, None, None


class _GroupedAllreduceFn(torch.autograd.Function):
    """The gradient of a grouped allreduce is the grouped allreduce of
    the gradients (one fused collective each way)."""

    @staticmethod
    def forward(ctx, op, prescale, postscale, process_set, *tensors):
        ctx.args = dict(op=op, prescale_factor=prescale,
                        postscale_factor=postscale, process_set=process_set)
        return tuple(C.grouped_allreduce(list(tensors), **ctx.args))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, None) + tuple(
            C.grouped_allreduce(list(grads), **ctx.args))


def _resolve_op(op, average):
    if op is None:
        op = Sum if average is False else Average
    return op


def allreduce(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """`ops.collectives.allreduce`, differentiable."""
    op = _resolve_op(op, average)
    if tensor.requires_grad:
        return _AllreduceFn.apply(tensor, op, prescale_factor,
                                  postscale_factor, process_set)
    return C.allreduce(tensor, name=name, op=op,
                       prescale_factor=prescale_factor,
                       postscale_factor=postscale_factor,
                       process_set=process_set)


def grouped_allreduce(tensors, average: Optional[bool] = None,
                      name: Optional[str] = None, op=None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set: Optional[ProcessSet] = None
                      ) -> List[torch.Tensor]:
    """`ops.collectives.grouped_allreduce`, differentiable."""
    op = _resolve_op(op, average)
    if any(t.requires_grad for t in tensors):
        return list(_GroupedAllreduceFn.apply(
            op, prescale_factor, postscale_factor, process_set, *tensors))
    return C.grouped_allreduce(tensors, name=name, op=op,
                               prescale_factor=prescale_factor,
                               postscale_factor=postscale_factor,
                               process_set=process_set)


def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """`ops.collectives.allgather` (dim 0 may be ragged),
    differentiable."""
    if tensor.requires_grad:
        # 0-d: gathered as [1] slices; unsqueeze so that the backward's
        # row slice sees the same shape.
        t = tensor.unsqueeze(0) if tensor.dim() == 0 else tensor
        return _AllgatherFn.apply(t, process_set)
    return C.allgather(tensor, name=name, process_set=process_set)


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """`ops.collectives.broadcast`, differentiable."""
    if tensor.requires_grad:
        return _BroadcastFn.apply(tensor, root_rank, process_set)
    return C.broadcast(tensor, root_rank=root_rank, name=name,
                       process_set=process_set)


def reducescatter(tensor: torch.Tensor, op=Average,
                  name: Optional[str] = None,
                  process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """`ops.collectives.reducescatter` (any dim 0), differentiable."""
    if tensor.requires_grad:
        return _ReducescatterFn.apply(tensor, op, process_set)
    return C.reducescatter(tensor, op=op, name=name,
                           process_set=process_set)


def alltoall(tensor: torch.Tensor, splits=None, name: Optional[str] = None,
             process_set: Optional[ProcessSet] = None):
    """`ops.collectives.alltoall`, differentiable: the received tensor,
    or with `splits` (received, received_splits)."""
    if tensor.requires_grad:
        return _AlltoallFn.apply(tensor, splits, process_set)
    return C.alltoall(tensor, splits=splits, name=name,
                      process_set=process_set)

# handle -> tensors an in-place async op writes its result into
_inplace: Dict[int, List[torch.Tensor]] = {}


def allreduce_(tensor: torch.Tensor, **kw) -> torch.Tensor:
    with torch.no_grad():
        tensor.copy_(allreduce(tensor, **kw))
    return tensor


def grouped_allreduce_(tensors, **kw) -> List[torch.Tensor]:
    with torch.no_grad():
        for t, o in zip(tensors, grouped_allreduce(tensors, **kw)):
            t.copy_(o)
    return list(tensors)


def allreduce_async_(tensor: torch.Tensor, **kw) -> int:
    h = allreduce_async(tensor, **kw)
    _inplace[h] = [tensor]
    return h


def grouped_allreduce_async_(tensors, **kw) -> int:
    h = grouped_allreduce_async(tensors, **kw)
    _inplace[h] = list(tensors)
    return h


def sparse_allreduce_async(tensor: torch.Tensor, name: Optional[str] = None,
                           op=Average,
                           process_set: Optional[ProcessSet] = None) -> int:
    """Allreduce a sparse COO tensor (reference: torch/mpi_ops.py
    `sparse_allreduce_async`; JAX shim :275-301): each rank's coalesced
    (indices [nnz, ndim], values) go through the ragged allgather, and
    `synchronize(handle)` returns the sparse tensor of every entry, each
    value divided by the set size under Average, then coalesced (the
    duplicates summed), in the JAX package's order."""
    del name
    if not getattr(tensor, "is_sparse", False):
        raise ValueError(
            "sparse_allreduce_async expects a torch sparse COO tensor; "
            "use allreduce/allreduce_async for dense tensors")
    ps = C._resolve_set(process_set)
    t = tensor.coalesce()
    idx = t.indices().t().contiguous()
    vals = t.values().contiguous()
    with C._joinable("allgather", [idx], process_set=ps):
        gi = C._allgather_any_start(idx, ps)
    with C._joinable("allgather", [vals], process_set=ps):
        gv = C._allgather_any_start(vals, ps)
    denom = ps.size() if op is Average else 1

    def finish():
        i, v = gi.wait(), gv.wait()
        if denom != 1:
            v = v / denom
        return torch.sparse_coo_tensor(i.t(), v.to(t.dtype),
                                       size=tuple(t.shape)).coalesce()

    return C._handle(C._Pending(gi._works + gv._works, finish))


def synchronize(handle: int):
    """Wait for the handle's collective; return its result (in-place
    variants copy into, and return, the original tensors)."""
    out = C.synchronize(handle)
    targets = _inplace.pop(handle, None)
    if targets is None:
        return out
    outs = out if isinstance(out, list) else [out]
    with torch.no_grad():
        for t, o in zip(targets, outs):
            t.copy_(o)
    return targets if isinstance(out, list) else targets[0]


# ---------------------------------------------------------------------------
# Parameter / optimizer-state broadcast (reference: horovod/torch/functions.py)
# ---------------------------------------------------------------------------

def _broadcast_inplace(tensors: List[torch.Tensor], root_rank: int) -> None:
    """Broadcast every tensor in place, all in flight at once.  A tensor
    off the rank's device (an optimizer's CPU step count) travels
    through a copy on the device."""
    dev = basics.device()
    pending = []
    for t in tensors:
        moved = t.device != dev
        buf = t.detach().to(dev) if moved else t.detach()
        pending.append((t, buf, moved,
                        C.broadcast_async_(buf, root_rank=root_rank)))
    with torch.no_grad():
        for t, buf, moved, h in pending:
            C.synchronize(h)
            if moved:
                t.copy_(buf)


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """In-place broadcast of a state_dict or a named_parameters
    iterable."""
    items = list(params.items()) if hasattr(params, "items") else list(params)
    _broadcast_inplace([p for _, p in items if isinstance(p, torch.Tensor)],
                       root_rank)


def _create_optimizer_state(optimizer) -> None:
    """Give a fresh optimizer its state, as upstream's
    `broadcast_optimizer_state` does: one step of the wrapped
    optimizer (not the distributed step, which would allreduce) on zero
    gradients, with the parameters and gradients put back after it (a
    weight decay would move them)."""
    inner = getattr(optimizer, "_opt", optimizer)
    kept = []
    with torch.no_grad():
        for group in inner.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    kept.append((p, p.grad, p.detach().clone()))
                    p.grad = torch.zeros_like(p)
        inner.step()
        for p, grad, data in kept:
            p.copy_(data)
            p.grad = grad


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Broadcast optimizer state tensors and hyperparameters from root
    (reference: broadcast_optimizer_state's state_dict walk).  Every
    rank takes root's state: a rank with none where root has some (a
    worker that joined a running elastic job) creates it first
    (`_create_optimizer_state`), and a rank with some where root has
    none drops it, so that every rank broadcasts the same tensors, in
    the order of their parameter index and name."""
    sd = optimizer.state_dict()
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in sd.get("param_groups", [])]
    n_root, synced = broadcast_object((len(sd["state"]), hyper),
                                      root_rank=root_rank)
    if len(sd["state"]) != n_root:
        if n_root == 0:
            getattr(optimizer, "_opt", optimizer).state.clear()
        elif not sd["state"]:
            _create_optimizer_state(optimizer)
        else:
            raise HorovodTpuError(
                f"optimizer state of {len(sd['state'])} parameters here "
                f"and {n_root} on root rank {root_rank}: cannot broadcast")
        sd = optimizer.state_dict()
    _broadcast_inplace([v for i in sorted(sd["state"])
                        for _, v in sorted(sd["state"][i].items())
                        if isinstance(v, torch.Tensor)], root_rank)
    for g, h in zip(optimizer.param_groups, synced):
        g.update(h)


# ---------------------------------------------------------------------------
# DistributedOptimizer (reference: horovod/torch/optimizer.py)
# ---------------------------------------------------------------------------

def _fusion_threshold() -> int:
    """The fusion threshold in force, in bytes: the autotuner's while
    it is active, else HOROVOD_FUSION_THRESHOLD (64 MiB by default).
    Read on every enqueue, as the JAX shim does."""
    return current_fusion_threshold()


_POLICY_COMPRESSORS = {c.wire: c for c in (Compression.none, Compression.fp16,
                                           Compression.bf16)}


def _no_hook(p: torch.Tensor) -> None:
    """A gradient hook whose optimizer is gone."""


class _DistributedOptimizer:
    """Wraps a torch.optim.Optimizer: gradients are allreduced before
    each step.  Post-accumulate-grad hooks enqueue each gradient as it
    is final, into size-capped buckets (HOROVOD_FUSION_THRESHOLD, read
    live on every enqueue, so the autotuner's moves take effect at
    once), formed as the JAX package's `gradient_bucket_partition`
    forms them over the same wire sizes in the same order (a cooperative
    wire counts 4 bytes an element, its f32 staging buffer).  A full
    bucket is dispatched at once as one async grouped allreduce, so
    communication overlaps the rest of backward.  `step()` waits for the
    buckets and copies the results into `p.grad`.  A sparse gradient is
    densified (`sparse_as_dense`) or goes through `sparse_allreduce_async`
    and is replaced by its result.  `backward_passes_per_step`
    accumulates locally and reduces every Nth pass.

    The wire of a bucket: with a cooperative `compression=` (int8, int4,
    fp8_*) every bucket is packed as one flat f32 buffer and reduced by
    the quantized ring (`ops/quantized.py`); with compression none and
    HOROVOD_WIRE_POLICY set (on the global set) each bucket takes the
    codec `WirePolicy.codec_for(raw_bytes, all_float)` picks: an exact
    bucket the grouped allreduce above (so "exact" is bitwise the unset
    policy), a cast bucket the cast, a cooperative one the ring.  A ring
    is a sequence of point-to-point hops, not one async handle, so the
    ring buckets run at `synchronize()`, in bucket order on every rank.
    The bucket's wire is `data_parallel.bucket_codec` and the refusals
    are `data_parallel.check_wire`: as in the JAX package, a cooperative
    wire refuses a process-set subset, and it and the policy any op but
    Average and Sum; a wire that can reach the ring also refuses
    `gradient_predivide_factor` != 1 (at construction), which has no
    ring form there.  The
    replicated path carries no error feedback (the JAX
    `DistributedOptimizer`'s update carries none either);
    `allreduce_gradients(error_feedback_state=)` does.

    `axis_name` (a `create_hierarchical_mesh`) with
    HOROVOD_HIERARCHICAL_ALLREDUCE=1 (read at construction) and op
    Average or Sum reduces every exact or cast bucket hierarchically: the
    hook dispatches the ici reduce-scatter, and `synchronize()` runs the
    dcn allreduce (on HOROVOD_HIERARCHICAL_DCN_WIRE) and the ici
    allgather (`hierarchical.grouped_start`).

    `fused_apply` (JAX `_fused_update`, parallel/optimizer.py:873): the
    parameters are split by `gradient_bucket_partition` at construction,
    each bucket has a local optimizer of the wrapped class and defaults
    (its param groups the wrapped ones' hyperparameters, its state the
    wrapped optimizer's `state` dict), a bucket is dispatched once all
    its gradients are final, and on the sync pass each bucket steps
    against its own reduced gradients as its reduction completes.  Under
    the guard every bucket waits for the one Max allreduce of the
    flags, so a flagged step applies no bucket.  The inner optimizer
    must be elementwise (SGD, Adam, ...).  A step whose partition moved
    (the tuner's threshold or order) raises.

    `early_reduction` (JAX `update_fn`, :1191-1230) with
    `backward_passes_per_step` K > 1: every pass's buckets are reduced
    from the hooks, each pass's reduced gradients are added into an
    accumulator and released, and the Kth pass applies the accumulator
    times 1/K with no further collective; under the guard each pass's
    flags fold into `pending_flag` and the Kth pass gates on them.
    Under either, a sparse gradient is densified.

    Every `step()` (each pass) is a step boundary of the data plane's
    instruments (`data_parallel.record_step`: a cycle mark and a `step`
    span from the pass's `zero_grad()` or first final gradient, `steps`,
    `critical_path_ms`), and every sync records its buckets
    (`buckets_per_step`, `bucket_bytes`, the wire metrics, the
    `wire_bucket_k` instants under a wire policy), `grad_bytes_reduced` and
    `optimizer_syncs`; megastep holds these off
    (`data_parallel.hold_step_hooks`).  At one rank the step reaches the
    host nowhere (no `.item()`, no synchronize), so that megastep can
    capture it into a CUDA graph, the guard excepted (its verdict is one
    host read)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[Iterable[Tuple[str, Any]]] = None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op=Average,
                 sparse_as_dense: bool = False,
                 gradient_predivide_factor: float = 1.0,
                 process_set: Optional[ProcessSet] = None,
                 guard=None, axis_name=None, fused_apply: bool = False,
                 early_reduction: bool = False,
                 fusion_threshold_bytes: Optional[int] = None,
                 bucket_order=None):
        self._policy = active_wire_policy(compression, process_set)
        check_wire(compression, op, process_set, self._policy,
                   gradient_predivide_factor)
        self._hier_mesh = hier_route(axis_name, op, process_set)
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self._predivide = gradient_predivide_factor
        self._ps = process_set
        self._bpps = max(1, backward_passes_per_step)
        self._early = early_reduction and self._bpps > 1
        self._sparse_as_dense = (sparse_as_dense or fused_apply
                                 or self._early)
        self._fusion_threshold_bytes = fusion_threshold_bytes
        self._bucket_order = bucket_order
        self._pass_count = 0
        _check_names(named_parameters)
        self._params = [p for g in optimizer.param_groups
                        for p in g["params"]]
        self.total_flushes = 0  # observable: fused buckets dispatched
        self.ring_buckets = 0  # observable: buckets reduced by the ring
        # (wire, raw bytes, wire bytes) of each bucket of the last step.
        self.last_buckets: List[Tuple[str, int, int]] = []
        self._parts: Optional[List[List[int]]] = None
        if fused_apply:
            self._parts = self._partition()
            self._bucket_of = {id(self._params[i]): b
                               for b, idxs in enumerate(self._parts)
                               for i in idxs}
            # Each bucket's local optimizer, and for each of its param
            # groups the index of the wrapped group it mirrors.
            self.bucket_optimizers, self._bucket_groups = zip(*(
                _bucket_optimizer(optimizer, [self._params[i] for i in idxs])
                for idxs in self._parts))
        self._accum: Dict[int, torch.Tensor] = {}
        self._clock: Optional[_dp.StepClock] = None  # this step's start
        self._scaler = guard
        self.guard_state = None
        if guard is not None:
            # One flag a hook bucket; `_gate` sets the vector's length to
            # the step's bucket count, which is known only once it runs.
            self.guard_state = guard.init(1, device=self._params[0].device)
        self.reset_step_state()
        # The hooks hold the optimizer weakly: a strong one would tie it
        # to its parameters through autograd's C++ side, where the
        # garbage collector cannot see the cycle, and keep the model, its
        # gradients and its optimizer state alive after their last use.
        hook = weakref.WeakMethod(self._hook)
        for p in self._params:
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(
                    lambda t: (hook() or _no_hook)(t))

    def _partition(self) -> List[List[int]]:
        return [list(b) for b in gradient_bucket_partition(
            self._params, compression=self._compression,
            fusion_threshold_bytes=self._fusion_threshold_bytes,
            bucket_order=self._bucket_order)]

    def reset_step_state(self) -> None:
        """Drop the state of the step in progress: the open bucket, the
        handles in flight, the gradients already enqueued, and a partial
        accumulation of `backward_passes_per_step` (early reduction's
        accumulator too).  Elastic recovery (`TorchState.on_reset`)
        calls it after a failed step: that state belongs to the step the
        restore rolled back.  (The JAX shim has no such state to drop:
        its work in flight is XLA programs.)"""
        self._bucket: List[torch.Tensor] = []
        self._bucket_bytes = 0
        # fused_apply: the gradients of each bucket that are final.
        self._ready: Dict[int, List[torch.Tensor]] = {}
        # (kind, handle, params, ctx, bucket) per dispatched bucket.
        self._in_flight: list = []
        # (param, handle) per sparse gradient in flight.
        self._sparse_in_flight: list = []
        self._reduced_ids: set = set()
        self._synchronized = False
        self._finished: list = []  # (bucket, params), this pass
        self._step_buckets: List[Tuple[str, int, int]] = []
        self._flags: List[torch.Tensor] = []  # per bucket, flush order
        self._accum = {}
        self._pass_count -= self._pass_count % self._bpps

    def _enqueue(self, p: torch.Tensor) -> None:
        """Add a gradient to the current bucket once per step; a full
        bucket is dispatched.  Sparse gradients never share a bucket with
        dense ones (JAX shim :543-554).  Under fused_apply the buckets
        are the baked partition's, each dispatched once complete."""
        if id(p) in self._reduced_ids:
            return
        if p.grad.is_sparse:
            if self._sparse_as_dense:
                p.grad = p.grad.to_dense()
            else:
                self._reduced_ids.add(id(p))
                self._sparse_in_flight.append(
                    (p, sparse_allreduce_async(p.grad, op=self._op,
                                               process_set=self._ps)))
                return
        self._reduced_ids.add(id(p))
        if self._parts is not None:
            b = self._bucket_of[id(p)]
            ready = self._ready.setdefault(b, [])
            ready.append(p)
            if len(ready) == len(self._parts[b]):
                self._dispatch(self._ready.pop(b), b)
            return
        # The JAX package's greedy partition (`_buckets_by_nbytes`) over
        # the gradients in the order they become final: a gradient that
        # would take the bucket past the threshold starts the next one,
        # and a bucket at or past it is full (no gradient could join).
        nbytes = _wire_nbytes(p.grad, self._compression)
        threshold = self._fusion_threshold_bytes or _fusion_threshold()
        if self._bucket and self._bucket_bytes + nbytes > threshold:
            self._flush()
        self._bucket.append(p)
        self._bucket_bytes += nbytes
        if self._bucket_bytes >= threshold:
            self._flush()

    def _hook(self, p: torch.Tensor) -> None:
        if self._clock is None:
            self._clock = _dp.step_clock()
        if (not self._early
                and self._pass_count % self._bpps != self._bpps - 1):
            return
        self._enqueue(p)

    def _flush(self) -> None:
        """Dispatch the current bucket (under fused_apply: every bucket
        with final gradients not yet dispatched, in partition order)."""
        if self._parts is not None:
            for b in sorted(self._ready):
                self._dispatch(self._ready.pop(b), b)
            return
        if not self._bucket:
            return
        params, self._bucket, self._bucket_bytes = self._bucket, [], 0
        self._dispatch(params, None)

    def _dispatch(self, params: List[torch.Tensor],
                  b: Optional[int]) -> None:
        """One bucket: one grouped allreduce (or its hierarchical first
        leg), or (a ring bucket) a place in the queue that `synchronize`
        reduces."""
        raw = sum(p.grad.numel() * p.grad.element_size() for p in params)
        codec = bucket_codec(self._compression, self._policy, raw,
                             all(p.grad.is_floating_point() for p in params))
        self.total_flushes += 1
        if codec is not None and codec.cooperative:
            self._step_buckets.append((codec.name, raw, codec.wire_nbytes(
                sum(p.grad.numel() for p in params))))
            self._bucket_instant(len(params))
            self._in_flight.append(("ring", None, params, codec.name, b))
            return
        # The policy's exact and cast wires are those compressors' casts.
        comp = (self._compression if codec is None
                else _POLICY_COMPRESSORS[codec.name])
        compressed, ctxs = [], []
        for p in params:
            c, ctx = comp.compress(p.grad)
            compressed.append(c)
            ctxs.append(ctx)
        self._step_buckets.append(
            (_wire.compressor_wire(comp), raw,
             sum(c.numel() * c.element_size() for c in compressed)))
        self._bucket_instant(len(params))
        wire_op, pre, post = self._op, 1.0, 1.0
        if self._predivide != 1.0:
            # Reference: averaging split around the Sum wire.
            n = self._ps.size() if self._ps is not None else size()
            wire_op, pre = Sum, 1.0 / self._predivide
            post = self._predivide / n
        if self._hier_mesh is not None:
            finish = _hier.grouped_start(
                [C._scale(c, pre) for c in compressed], self._hier_mesh,
                wire_op is Average)
            self._in_flight.append(("hier", finish, params,
                                    (ctxs, comp, post), b))
            return
        h = grouped_allreduce_async(compressed, op=wire_op,
                                    prescale_factor=pre,
                                    postscale_factor=post,
                                    process_set=self._ps)
        self._in_flight.append(("flat", h, params, (ctxs, comp, 1.0), b))

    def _bucket_instant(self, leaves: int) -> None:
        """The timeline's `wire_bucket_k` of the bucket just dispatched
        (under a wire policy, as the JAX package)."""
        if self._policy is None:
            return
        wire, raw, wbytes = self._step_buckets[-1]
        _dp.bucket_instant(len(self._step_buckets) - 1, wire, leaves, raw,
                           wbytes)

    def _ring(self, flat: torch.Tensor, wire: str) -> torch.Tensor:
        """One bucket's flat f32 gradients through the quantized ring."""
        return quantized_allreduce_shard(flat, average=self._op is Average,
                                         wire=wire)

    def _flag(self, grads: List[torch.Tensor],
              inputs: Optional[torch.Tensor] = None) -> None:
        """The guard's flag of one finished bucket: its reduced gradients
        (replicated: this rank scans its slice), and a ring bucket's
        inputs (a quantizing codec can launder a NaN)."""
        if self._scaler is None:
            return
        f = _sentinel.sliced_nonfinite(grads, C._resolve_set(self._ps))
        if inputs is not None:
            f = torch.maximum(f, inputs)
        self._flags.append(f)

    def _finish(self, kind, h, params, ctx) -> None:
        """Wait for one bucket and write its reduced gradients into
        `p.grad`."""
        if kind == "ring":
            with record_function("hvd.ring"):
                grads = [p.grad for p in params]
                in_flag = (_sentinel.local_nonfinite(grads)
                           if self._scaler is not None else None)
                red = self._ring(torch.cat(
                    [g.reshape(-1).to(torch.float32) for g in grads]), ctx)
                off = 0
                for g in grads:
                    g.copy_(red[off:off + g.numel()].reshape(g.shape))
                    off += g.numel()
            self._flag(grads, in_flag)
            self.ring_buckets += 1
            return
        ctxs, comp, post = ctx
        outs = h() if kind == "hier" else C.synchronize(h)
        for p, o, c in zip(params, outs, ctxs):
            if post != 1.0:
                o = C._scale(o, post)
            p.grad.copy_(comp.decompress(o, c))
        self._flag([p.grad for p in params])

    def synchronize(self) -> None:
        self._sync(None)

    def _sync(self, on_bucket) -> None:
        """Finish every bucket in dispatch order (calling
        `on_bucket(bucket, params)` after each), then the sparse ones."""
        self._flush()
        with torch.no_grad(), record_function("hvd.synchronize"):
            for kind, h, params, ctx, b in self._in_flight:
                self._finish(kind, h, params, ctx)
                self._finished.append((b, params))
                if on_bucket is not None:
                    on_bucket(b, params)
            for p, h in self._sparse_in_flight:
                # Replaced, not copied into: the reduced gradient has
                # other entries than the local one.
                p.grad = synchronize(h)
                self._finished.append((None, [p]))
                if self._scaler is not None:
                    self._flags.append(_sentinel.local_nonfinite(
                        [p.grad.coalesce().values()]))
                if on_bucket is not None:
                    on_bucket(None, [p])
        self._in_flight = []
        self._sparse_in_flight = []
        self._synchronized = True
        self.last_buckets, self._step_buckets = self._step_buckets, []
        if _met.enabled() and not _dp.step_hooks_held():
            _dp.record_buckets(self.last_buckets, self._policy is not None)
            raw = sum(b[1] for b in self.last_buckets)
            _met.grad_bytes_reduced.inc(raw)
            _met.grad_bytes_per_step.set(raw)
            _met.optimizer_syncs.inc()

    @torch.no_grad()
    def _fold(self, params: List[torch.Tensor], last: bool) -> None:
        """This pass's reduced gradients of `params` into what the step
        applies: under early reduction added into the accumulator (from
        zeros, as the JAX package's), released on an accumulation pass
        and replaced by accumulator times 1/K on the last; else divided
        by K once the Kth pass is reduced."""
        for p in params:
            if p.grad is None:
                continue
            if not self._early:
                if self._bpps > 1:
                    p.grad.div_(self._bpps)
                continue
            acc = self._accum.get(id(p))
            if acc is None:
                acc = self._accum[id(p)] = torch.zeros_like(p.grad)
            acc.add_(p.grad)
            if last:
                p.grad = (acc * (1.0 / self._bpps)).to(acc.dtype)
                del self._accum[id(p)]
            else:
                p.grad = None

    def _check_partition(self) -> None:
        live = self._partition()
        if live != self._parts:
            raise ValueError(
                f"fused_apply bucket partition changed since init "
                f"({len(self._parts)} -> {len(live)} buckets): the "
                "fusion threshold / bucket order moved under the state "
                "(autotuner proposal?) — re-init the optimizer state "
                "after tunables change")

    def _apply_bucket(self, b: int) -> None:
        """Bucket b's local step, with the wrapped optimizer's state and
        its param groups' hyperparameters as they are now."""
        local = self.bucket_optimizers[b]
        local.state = self._opt.state
        for lg, gi in zip(local.param_groups, self._bucket_groups[b]):
            lg.update(_hyper(self._opt.param_groups[gi]))
        with record_function("hvd.fused_apply"):
            local.step()

    def step(self, closure=None):
        clock = self._clock or _dp.step_clock()
        self._clock = None
        out = self._step(closure)
        if not _dp.step_hooks_held():
            _dp.record_step(clock)
        return out

    def _step(self, closure):
        self._pass_count += 1
        last = self._pass_count % self._bpps == 0
        if not last and not self._early:
            return None  # accumulation pass: no sync, no step
        if self._parts is not None:
            if closure is not None:
                raise HorovodTpuError(
                    "fused_apply takes no closure: run forward and "
                    "backward before step()")
            self._check_partition()
        # Without the guard each bucket of the sync pass steps as its
        # reduction completes; the guard's verdict needs every bucket.
        stream = self._parts is not None and last and self._scaler is None
        applied = set()

        def settle(b, params):
            self._fold(params, last)
            if stream and b is not None:
                self._apply_bucket(b)
                applied.add(b)

        if not self._synchronized:
            # Gradients produced outside autograd never fired a hook:
            # reduce the stragglers now (_enqueue skips those already
            # bucketed).
            for p in self._params:
                if p.grad is not None:
                    self._enqueue(p)
            self._sync(settle)
        else:  # synchronize() ran already
            for b, params in self._finished:
                settle(b, params)
        finished, self._finished = self._finished, []
        self._synchronized = False
        self._reduced_ids = set()
        if not last:
            if self._scaler is not None:
                # This pass's flags fold into pending_flag now (the
                # poisoned pass is already in the accumulator).
                self.guard_state = self._scaler.accumulate(
                    self.guard_state, self._pass_flags())
            return None
        if self._scaler is not None:
            flags = None
            if self._early:
                self.guard_state = self._scaler.accumulate(
                    self.guard_state, self._pass_flags())
                # The applied gradients are rank-identical: local flags
                # (the JAX package's `bucket_flags_local`).
                flags = torch.stack([
                    _sentinel.local_nonfinite(
                        [p.grad for p in params if p.grad is not None])
                    for _, params in finished]) if finished else None
            if not self._gate(flags):
                return None  # flagged: skipped on every rank alike
        if self._parts is None:
            return self._opt.step(closure)
        for b in range(len(self._parts)):
            if b not in applied:
                self._apply_bucket(b)
        return None

    def _pass_flags(self) -> torch.Tensor:
        """The cross-rank OR of this pass's bucket flags (one Max
        allreduce)."""
        vec = (torch.stack(self._flags) if self._flags else
               torch.zeros((1,), dtype=torch.float32,
                           device=self.guard_state.loss_scale.device))
        self._flags = []
        return _sentinel.crossrank_or(vec, process_set=self._ps)

    @torch.no_grad()
    def _gate(self, flags: Optional[torch.Tensor] = None) -> bool:
        """The guard's coordinated skip-step (the JAX package's `_gate`):
        OR the buckets' flags across ranks (one Max allreduce; `flags`
        when given), unscale the gradients, advance the schedule on the
        device, and read the verdict once on the host.  Returns whether
        the inner step runs."""
        gs = self.guard_state
        if flags is None:
            flags = self._pass_flags()
        self._flags = []
        bad = torch.maximum(flags.max(), gs.pending_flag) > 0
        unscale_(self._scaler, gs,
                 [p.grad for p in self._params if p.grad is not None])
        self.guard_state = self._scaler.update(gs, flags)
        return not bool(bad)

    def zero_grad(self, *a, **kw):
        if self._clock is None:
            self._clock = _dp.step_clock()
        return self._opt.zero_grad(*a, **kw)

    def __getattr__(self, item):
        return getattr(self._opt, item)


def _hyper(group: dict) -> dict:
    return {k: v for k, v in group.items() if k != "params"}


def _bucket_optimizer(optimizer: torch.optim.Optimizer,
                      params: List[torch.Tensor]):
    """fused_apply's local optimizer of one bucket: the wrapped one's
    class and constructor defaults over `params`, one param group per
    wrapped group they belong to, with its hyperparameters, and the
    wrapped optimizer's `state` dict, so that its `state_dict()` covers
    every bucket.  Returns (optimizer, the wrapped group index of each
    of its param groups)."""
    ids = {id(p) for p in params}
    groups, index = [], []
    for gi, g in enumerate(optimizer.param_groups):
        mine = [p for p in g["params"] if id(p) in ids]
        if mine:
            groups.append(dict(_hyper(g), params=mine))
            index.append(gi)
    cls = type(optimizer)
    sig = inspect.signature(cls.__init__).parameters
    local = cls(groups, **{k: v for k, v in optimizer.defaults.items()
                           if k in sig})
    local.state = optimizer.state
    return local, index


def _guard_scaler(guard, op):
    """The guard's schedule from `DistributedOptimizer(guard=)` and
    HOROVOD_GUARD, with the JAX package's refusals; None when off."""
    if guard is None:
        guard = util.env_bool("GUARD", False)
    if guard is False:
        return None
    scaler = DynamicLossScale.from_env() if guard is True else guard
    if not isinstance(scaler, DynamicLossScale):
        raise ValueError(
            f"guard= takes True/False or a guard.DynamicLossScale, "
            f"got {guard!r}")
    if op is Adasum:
        raise ValueError(
            "guard= is incompatible with op=Adasum: Adasum combines "
            "post-update deltas, so there is no per-bucket "
            "reduction result for the non-finite sentinel to flag")
    return scaler


class _DistributedAdasumOptimizer:
    """Adasum DELTA optimizer (reference: horovod/torch/optimizer.py
    `_DistributedAdasumOptimizer`).

    (1) The wrapped optimizer applies its LOCAL step (LR, momentum,
    weight decay); (2) each parameter's delta is p_new - p_start;
    (3) the deltas are Adasum-combined across ranks as one grouped
    allreduce, which fuses them into one flat buffer per dtype; (4) every
    rank sets p = p_start + adasum(deltas).

    p_start is taken at the start of every step, as upstream does.  (The
    JAX package snapshots it once, when the optimizer is built, so a
    `broadcast_parameters` after that leaves the other ranks measuring
    from their own initial weights.)"""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[Iterable[Tuple[str, Any]]] = None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1):
        self._opt = optimizer
        self._compression = compression
        self._bpps = max(1, backward_passes_per_step)
        self._pass_count = 0
        _check_names(named_parameters)
        self._params = [p for g in optimizer.param_groups
                        for p in g["params"]]
        self._starting = {id(p): torch.empty_like(p) for p in self._params}
        self._clock: Optional[_dp.StepClock] = None

    def reset_step_state(self) -> None:
        """Drop a partial accumulation of `backward_passes_per_step`
        (elastic recovery; the delta reduction holds nothing else
        between calls)."""
        self._pass_count -= self._pass_count % self._bpps

    def _reduce_deltas(self, deltas: List[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Adasum-combine the per-rank deltas (one grouped allreduce)."""
        compressed, ctxs = [], []
        for d in deltas:
            c, ctx = self._compression.compress(d)
            compressed.append(c)
            ctxs.append(ctx)
        outs = grouped_allreduce(compressed, op=Adasum)
        return [self._compression.decompress(o, ctx)
                for o, ctx in zip(outs, ctxs)]

    def step(self, closure=None):
        """One pass (a step boundary of the instruments, as
        `_DistributedOptimizer.step`'s)."""
        clock = self._clock or _dp.step_clock()
        self._clock = None
        out = self._step(closure)
        if not _dp.step_hooks_held():
            _dp.record_step(clock)
        return out

    def _step(self, closure):
        self._pass_count += 1
        if self._pass_count % self._bpps != 0:
            return None  # accumulation pass
        with torch.no_grad(), record_function("hvd.adasum.local_step"):
            for p in self._params:
                if self._bpps > 1 and p.grad is not None:
                    p.grad.div_(self._bpps)
                self._starting[id(p)].copy_(p)
            loss = self._opt.step(closure)  # LOCAL step first
        # torch optimizers skip grad-less params, so only params with a
        # gradient can have moved this step.
        stepped = [p for p in self._params if p.grad is not None]
        with torch.no_grad():
            deltas = [p - self._starting[id(p)] for p in stepped]
            with record_function("hvd.adasum.reduce_deltas"):
                reduced = self._reduce_deltas(deltas)
            with record_function("hvd.adasum.apply"):
                for p, d in zip(stepped, reduced):
                    p.copy_(self._starting[id(p)] + d)
        if _met.enabled() and not _dp.step_hooks_held():
            _met.optimizer_syncs.inc()
        return loss

    def zero_grad(self, *a, **kw):
        if self._clock is None:
            self._clock = _dp.step_clock()
        return self._opt.zero_grad(*a, **kw)

    def synchronize(self) -> None:
        """No-op for API compatibility: the delta reduction is
        synchronous inside step()."""

    def __getattr__(self, item):
        return getattr(self._opt, item)


def _check_names(named_parameters) -> None:
    if named_parameters is None:
        return
    names = [n for n, _ in named_parameters]
    if len(names) != len(set(names)):
        raise ValueError("Duplicate parameter names "
                         "(reference: duplicated-name error)")


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op=Average,
                         gradient_predivide_factor: float = 1.0,
                         num_groups: int = 0, groups=None,
                         sparse_as_dense: bool = False,
                         process_set: Optional[ProcessSet] = None,
                         zero_stage: Optional[int] = None,
                         shard_optimizer_states: Optional[bool] = None,
                         fusion_threshold_bytes: Optional[int] = None,
                         bucket_order=None,
                         allgather_wire: Optional[str] = None,
                         guard=None, axis_name=None,
                         fused_apply: bool = False,
                         early_reduction: bool = False):
    """op=Adasum returns the delta-semantics `_DistributedAdasumOptimizer`
    (reference: optimizer.py routes op=Adasum there); any other op the
    hook-bucketed `_DistributedOptimizer`.  `gradient_predivide_factor`
    splits the averaging around a Sum wire (prescale 1/f, postscale
    f/size).  `num_groups` and `groups` are accepted and ignored, as in
    the JAX package (buckets follow the live fusion threshold).
    `sparse_as_dense` densifies sparse gradients; by default they go
    through `sparse_allreduce_async`.

    `zero_stage` (env HOROVOD_ZERO_STAGE) picks the ZeRO rung: 0
    replicated; 1 (alias `shard_optimizer_states`, env
    HOROVOD_SHARD_OPTIMIZER) the optimizer stepped on this rank's shard;
    2 adds sharded gradient accumulation; 3 leaves the parameters to
    `zero3_placement`, and `step()` returns the updates for
    `placement.apply_updates` (parallel/optimizer.py).
    `fusion_threshold_bytes` and `bucket_order` set the shard groups,
    and at stage 0 the buckets (the hooks' threshold; fused_apply's
    partition) (defaults: HOROVOD_FUSION_THRESHOLD,
    HOROVOD_BUCKET_ORDER).
    `allgather_wire` (env HOROVOD_SHARD_AG_WIRE) is the wire of the
    sharded path's parameter allgather, with f32 masters on the owner;
    it needs zero_stage >= 1.

    `compression` may be a cooperative wire (Compression.int8, int4,
    fp8_*): at stage 0 each bucket rides the quantized ring (see
    `_DistributedOptimizer`); Adasum and the sharded path refuse it, as
    the JAX package does.  HOROVOD_WIRE_POLICY picks a wire per bucket
    at stage 0 and per shard group at stages 1-3.

    `guard` (env HOROVOD_GUARD) arms the training-health guard: True
    reads the schedule from the env (`DynamicLossScale.from_env`), or
    pass a `DynamicLossScale`.  Each bucket (each shard group at stages
    1-3) gets a non-finite flag as its reduction finishes, the flags are
    OR-ed across ranks, the gradients are multiplied by 1/scale, and on
    a flagged step every rank skips the inner step (the parameters and
    the optimizer state stay as they were) while the scale decays.  The
    state is the optimizer's `guard_state` (a `GuardState`).  Refused
    with op=Adasum.

    `axis_name` takes a `create_hierarchical_mesh` (the JAX package's
    ("dcn", "hvd") pair): at stage 0 under HOROVOD_HIERARCHICAL_ALLREDUCE
    the buckets reduce hierarchically (`_DistributedOptimizer`); at
    stages 1-3 the reduce-scatter and the parameter allgather always run
    over the pair's two tiers, ownership dcn-major
    (parallel/optimizer.py).  `fused_apply` steps each bucket's share of
    the inner optimizer against its own reduced gradients (stage 0
    only); `early_reduction` reduces every pass of
    `backward_passes_per_step` and accumulates the reduced gradients.
    Both refuse op=Adasum, as in the JAX package."""
    del num_groups, groups
    _check_names(named_parameters)
    if op is Adasum and (fused_apply or early_reduction):
        raise ValueError(
            "fused_apply / early_reduction are incompatible with "
            "op=Adasum: Adasum combines post-update deltas, so there is "
            "no per-bucket reduction result to consume early")
    check_axis(axis_name, process_set)
    scaler = _guard_scaler(guard, op)
    if is_cooperative(compression) and op is Adasum:
        raise ValueError(
            f"Compression.{compression.wire} has no Adasum form: Adasum "
            "combines whole deltas, the quantized ring sums chunks")
    if zero_stage is None:
        zero_stage = current_zero_stage()
    zero_stage = int(zero_stage)
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(
            f"zero_stage must be 0..3, got {zero_stage} (0 replicated, 1 "
            "optimizer-state sharding, 2 + gradient-sharded accumulation, "
            "3 + parameter sharding via zero3_placement)")
    if zero_stage >= 1 and shard_optimizer_states is False:
        raise ValueError(f"zero_stage={zero_stage} requires the sharded "
                         "path; shard_optimizer_states=False contradicts it")
    if shard_optimizer_states is None:
        shard_optimizer_states = util.shard_optimizer()
    if shard_optimizer_states and zero_stage == 0:
        zero_stage = 1
    if gradient_predivide_factor != 1.0 and op is not Average:
        raise ValueError("gradient_predivide_factor requires op=Average")
    if not zero_stage and not _wire.get_codec(
            allgather_wire or util.shard_ag_wire()).exact:
        raise ValueError(
            "allgather_wire requires zero_stage >= 1 (it is the wire of "
            "the sharded parameter allgather)")
    if zero_stage:
        if gradient_predivide_factor != 1.0:
            raise ValueError(f"zero_stage={zero_stage} takes no "
                             "gradient_predivide_factor")
        if fused_apply:
            raise ValueError(
                "shard_optimizer_states and fused_apply are mutually "
                "exclusive: both partition the inner optimizer state "
                "by bucket — the sharded path already applies per "
                "shard group")
        return _ShardedOptimizer(
            optimizer, zero_stage, compression=compression,
            backward_passes_per_step=backward_passes_per_step, op=op,
            process_set=process_set,
            fusion_threshold_bytes=fusion_threshold_bytes,
            bucket_order=bucket_order, allgather_wire=allgather_wire,
            guard=scaler, axis_name=axis_name,
            early_reduction=early_reduction)
    if op is Adasum:
        return _DistributedAdasumOptimizer(
            optimizer, named_parameters=named_parameters,
            compression=compression,
            backward_passes_per_step=backward_passes_per_step)
    return _DistributedOptimizer(
        optimizer, named_parameters=named_parameters,
        compression=compression,
        backward_passes_per_step=backward_passes_per_step, op=op,
        sparse_as_dense=sparse_as_dense,
        gradient_predivide_factor=gradient_predivide_factor,
        process_set=process_set, guard=scaler, axis_name=axis_name,
        fused_apply=fused_apply, early_reduction=early_reduction,
        fusion_threshold_bytes=fusion_threshold_bytes,
        bucket_order=bucket_order)


class SyncBatchNorm(torch.nn.modules.batchnorm._BatchNorm):
    """Batch norm with the global batch's statistics (reference:
    horovod/torch/sync_batch_norm.py; JAX shim :750-804).

    The torch `_BatchNorm` contract holds: the running variance is the
    unbiased one of the global batch, `momentum=None` is a cumulative
    average, the input is at least 2-D, and in eval mode or at one rank
    this is the plain `_BatchNorm`.  In train mode the statistics are
    computed in f32 whatever the input's dtype, and [mean, mean of the
    squares] travel as one tensor through one allreduce (Average) of the
    autograd wrapper, whose backward is the allreduce of the cotangents:
    the gradient is the exact cross-rank one, that of the JAX package's
    `batchnorm_apply(axis_name=...)` and of upstream.  (The JAX shim
    takes a straight-through gradient through the local statistics; the
    two agree where every rank has the same input.)"""

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D)")

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if not self.training or size() == 1:
            return super().forward(input)
        self._check_input_dim(input)
        dims = [0] + list(range(2, input.dim()))
        shape = [1, -1] + [1] * (input.dim() - 2)
        xf = input.float()
        local = torch.stack([xf.mean(dims), xf.square().mean(dims)])
        mean, mean2 = allreduce(local, op=Average)
        # E[x^2] - mean^2 can round below 0 in f32 for a channel of large
        # mean and small variance; the sqrt below must not see it.
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if self.track_running_stats and self.running_mean is not None:
            n = input.numel() // input.size(1) * size()
            unbiased = var.detach() * n / max(n - 1, 1)
            if self.num_batches_tracked is not None:
                self.num_batches_tracked.add_(1)
            if self.momentum is None:
                m = 1.0 / float(self.num_batches_tracked)
            else:
                m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1 - m).add_(unbiased, alpha=m)
        out = (xf - mean.reshape(shape)) / torch.sqrt(
            var.reshape(shape) + self.eps)
        if self.affine:
            out = out * self.weight.float().reshape(shape) + \
                self.bias.float().reshape(shape)
        return out.to(input.dtype)


# The elastic namespace (hvd.elastic.run, TorchState, ...); last, because
# torch/elastic.py imports the names above.
from . import elastic  # noqa: F401,E402
