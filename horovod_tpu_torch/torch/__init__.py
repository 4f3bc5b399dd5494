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
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.profiler import record_function

from ..common import basics, util
from ..common.basics import (  # noqa: F401
    ProcessSet,
    backend,
    ccl_built,
    cross_rank,
    cross_size,
    cuda_built,
    ddl_built,
    device,
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
    rocm_built,
    shutdown,
    size,
    tpu_built,
    xla_built,
)
from ..common.exceptions import HorovodInternalError  # noqa: F401
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
    allgather,
    allgather_async,
    allreduce,
    allreduce_async,
    barrier,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    grouped_allreduce,
    grouped_allreduce_async,
    poll,
    reducescatter,
    reducescatter_async,
)
from ..ops.compression import Compression  # noqa: F401
from ..ops.functions import allgather_object, broadcast_object  # noqa: F401
from ..parallel.optimizer import (  # noqa: F401
    _ShardedOptimizer,
    grad_accum_bytes,
    optimizer_state_bytes,
)
from ..parallel.zero3 import ZeroParamPlacement, zero3_placement  # noqa: F401
from ..utils.autotune import current_zero_stage

__all__ = [
    "Adasum", "Average", "Compression", "DistributedOptimizer",
    "HandleManager", "HorovodInternalError", "Max", "Min", "ProcessSet",
    "Product", "ReduceOp", "Sum", "allgather", "allgather_async",
    "allgather_object", "allreduce", "allreduce_", "allreduce_async",
    "allreduce_async_", "backend", "barrier", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_", "broadcast_object",
    "broadcast_optimizer_state", "broadcast_parameters", "ccl_built",
    "cross_rank", "cross_size", "cuda_built", "ddl_built", "device",
    "global_process_set", "gloo_built", "gloo_enabled", "grouped_allreduce",
    "grouped_allreduce_", "grouped_allreduce_async",
    "grouped_allreduce_async_", "grad_accum_bytes", "init",
    "is_homogeneous", "is_initialized", "local_rank", "local_size",
    "mpi_built", "mpi_enabled", "mpi_threads_supported", "nccl_built",
    "optimizer_state_bytes", "poll", "rank", "reducescatter",
    "reducescatter_async", "rocm_built", "shutdown", "size", "synchronize",
    "tpu_built", "xla_built", "ZeroParamPlacement", "zero3_placement",
]

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


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Broadcast optimizer state tensors and hyperparameters from root
    (reference: broadcast_optimizer_state's state_dict walk)."""
    sd = optimizer.state_dict()
    _broadcast_inplace([v for st in sd.get("state", {}).values()
                        for v in st.values() if isinstance(v, torch.Tensor)],
                       root_rank)
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in sd.get("param_groups", [])]
    synced = broadcast_object(hyper, root_rank=root_rank)
    for g, h in zip(optimizer.param_groups, synced):
        g.update(h)


# ---------------------------------------------------------------------------
# DistributedOptimizer (reference: horovod/torch/optimizer.py)
# ---------------------------------------------------------------------------

def _fusion_threshold() -> int:
    """HOROVOD_FUSION_THRESHOLD in bytes, default 64 MiB (the JAX
    package's default; its autotuner is not ported yet)."""
    return util.fusion_threshold()


class _DistributedOptimizer:
    """Wraps a torch.optim.Optimizer: gradients are allreduced before
    each step.  Post-accumulate-grad hooks enqueue each gradient as it
    is final, into size-capped buckets (HOROVOD_FUSION_THRESHOLD); a full
    bucket is dispatched at once as one async grouped allreduce, so
    communication overlaps the rest of backward.  `step()` waits for the
    buckets and copies the results into `p.grad`.
    `backward_passes_per_step` accumulates locally and reduces every Nth
    pass."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[Iterable[Tuple[str, Any]]] = None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op=Average,
                 gradient_predivide_factor: float = 1.0,
                 process_set: Optional[ProcessSet] = None):
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self._predivide = gradient_predivide_factor
        self._ps = process_set
        self._bpps = max(1, backward_passes_per_step)
        self._pass_count = 0
        _check_names(named_parameters)
        self._params = [p for g in optimizer.param_groups
                        for p in g["params"]]
        self._threshold = _fusion_threshold()
        self._bucket: List[torch.Tensor] = []
        self._bucket_bytes = 0
        # (handle, params, ctxs) per dispatched bucket.
        self._in_flight: list = []
        self._reduced_ids: set = set()
        self.total_flushes = 0  # observable: fused buckets dispatched
        for p in self._params:
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(self._hook)
        self._synchronized = False

    def _enqueue(self, p: torch.Tensor) -> None:
        """Add a gradient to the current bucket once per step; a full
        bucket is dispatched."""
        if id(p) in self._reduced_ids:
            return
        self._reduced_ids.add(id(p))
        self._bucket.append(p)
        self._bucket_bytes += p.grad.numel() * p.grad.element_size()
        if self._bucket_bytes >= self._threshold:
            self._flush()

    def _hook(self, p: torch.Tensor) -> None:
        if self._pass_count % self._bpps != self._bpps - 1:
            return
        self._enqueue(p)

    def _flush(self) -> None:
        """Dispatch the current bucket as one grouped allreduce."""
        if not self._bucket:
            return
        params, self._bucket, self._bucket_bytes = self._bucket, [], 0
        compressed, ctxs = [], []
        for p in params:
            c, ctx = self._compression.compress(p.grad)
            compressed.append(c)
            ctxs.append(ctx)
        wire_op, pre, post = self._op, 1.0, 1.0
        if self._predivide != 1.0:
            # Reference: averaging split around the Sum wire.
            n = self._ps.size() if self._ps is not None else size()
            wire_op, pre = Sum, 1.0 / self._predivide
            post = self._predivide / n
        h = grouped_allreduce_async(compressed, op=wire_op,
                                    prescale_factor=pre,
                                    postscale_factor=post,
                                    process_set=self._ps)
        self._in_flight.append((h, params, ctxs))
        self.total_flushes += 1

    def synchronize(self) -> None:
        self._flush()
        with torch.no_grad(), record_function("hvd.synchronize"):
            for h, params, ctxs in self._in_flight:
                outs = C.synchronize(h)
                for p, o, ctx in zip(params, outs, ctxs):
                    p.grad.copy_(self._compression.decompress(o, ctx))
        self._in_flight = []
        self._synchronized = True

    def step(self, closure=None):
        self._pass_count += 1
        if self._pass_count % self._bpps != 0:
            return None  # accumulation pass: no sync, no step
        if not self._synchronized:
            # Gradients produced outside autograd never fired a hook:
            # reduce the stragglers now (_enqueue skips those already
            # bucketed).
            for p in self._params:
                if p.grad is not None:
                    self._enqueue(p)
            self.synchronize()
        self._synchronized = False
        self._reduced_ids = set()
        if self._bpps > 1:
            with torch.no_grad():
                for p in self._params:
                    if p.grad is not None:
                        p.grad.div_(self._bpps)
        return self._opt.step(closure)

    def zero_grad(self, *a, **kw):
        return self._opt.zero_grad(*a, **kw)

    def __getattr__(self, item):
        return getattr(self._opt, item)


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
        return loss

    def zero_grad(self, *a, **kw):
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
                         process_set: Optional[ProcessSet] = None,
                         zero_stage: Optional[int] = None,
                         shard_optimizer_states: Optional[bool] = None,
                         fusion_threshold_bytes: Optional[int] = None,
                         bucket_order=None):
    """op=Adasum returns the delta-semantics `_DistributedAdasumOptimizer`
    (reference: optimizer.py routes op=Adasum there); any other op the
    hook-bucketed `_DistributedOptimizer`.  `gradient_predivide_factor`
    splits the averaging around a Sum wire (prescale 1/f, postscale
    f/size).

    `zero_stage` (env HOROVOD_ZERO_STAGE) picks the ZeRO rung: 0
    replicated; 1 (alias `shard_optimizer_states`, env
    HOROVOD_SHARD_OPTIMIZER) the optimizer stepped on this rank's shard;
    2 adds sharded gradient accumulation; 3 leaves the parameters to
    `zero3_placement`, and `step()` returns the updates for
    `placement.apply_updates` (parallel/optimizer.py).
    `fusion_threshold_bytes` and `bucket_order` set the shard groups
    (defaults: HOROVOD_FUSION_THRESHOLD, HOROVOD_BUCKET_ORDER)."""
    _check_names(named_parameters)
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
    if zero_stage:
        if gradient_predivide_factor != 1.0:
            raise ValueError(f"zero_stage={zero_stage} takes no "
                             "gradient_predivide_factor")
        return _ShardedOptimizer(
            optimizer, zero_stage, compression=compression,
            backward_passes_per_step=backward_passes_per_step, op=op,
            process_set=process_set,
            fusion_threshold_bytes=fusion_threshold_bytes,
            bucket_order=bucket_order)
    if op is Adasum:
        return _DistributedAdasumOptimizer(
            optimizer, named_parameters=named_parameters,
            compression=compression,
            backward_passes_per_step=backward_passes_per_step)
    return _DistributedOptimizer(
        optimizer, named_parameters=named_parameters,
        compression=compression,
        backward_passes_per_step=backward_passes_per_step, op=op,
        gradient_predivide_factor=gradient_predivide_factor,
        process_set=process_set)
