"""`horovod_tpu_torch.mxnet` — the MXNet frontend over the port's
collectives (counterpart of `horovod_tpu/mxnet/__init__.py`; reference:
horovod/mxnet/__init__.py, mpi_ops.py).

MXNet is duck-typed on the NDArray contract: anything with `.asnumpy()`
and slice assignment (`arr[:] = value`).  Every collective takes the
array to a torch tensor on the rank's device (`hvd.device()`: the card,
or the CPU where `init(device="cpu")` asked for it), runs the port's
collective there and hands the result back as an array like the input
(`_like`) or written into it (`_assign_`).  The module imports without
mxnet; only `DistributedTrainer` (a gluon subclass) needs the package.

    import horovod_tpu_torch.mxnet as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(mx.optimizer.SGD(learning_rate=0.1))
    hvd.broadcast_parameters(net.collect_params(), root_rank=0)
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..common import basics
from ..common.basics import (  # noqa: F401
    ProcessSet,
    add_process_set,
    ccl_built,
    cross_rank,
    cross_size,
    cuda_built,
    ddl_built,
    global_process_set,
    gloo_built,
    gloo_enabled,
    init,
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
from ..ops import collectives as C
from ..ops.collectives import (  # noqa: F401
    Adasum, Average, Max, Min, Product, Sum, barrier, join)
from ..ops.compression import Compression  # noqa: F401

try:  # mxnet is not a dependency of the port
    import mxnet as mx
except ImportError:
    mx = None


def _to_np(t: Any) -> np.ndarray:
    """NDArray (or anything NDArray-shaped) -> numpy."""
    if hasattr(t, "asnumpy"):
        return t.asnumpy()
    return np.asarray(t)


def _to_torch(t: Any) -> torch.Tensor:
    """The array as a torch tensor on the rank's device."""
    return torch.from_numpy(np.ascontiguousarray(_to_np(t))).to(
        basics.device())


def _host(out) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def _like(t: Any, data) -> Any:
    """The result `data` as an array of the input's kind."""
    out = _host(data)
    if hasattr(t, "asnumpy") and mx is not None:
        return mx.nd.array(out, dtype=out.dtype)
    if hasattr(t, "asnumpy"):
        return type(t)(out)  # a duck-typed NDArray: its own class
    return out


def _assign_(t: Any, data) -> Any:
    """Write `data` into `t` through the NDArray slice assignment."""
    t[:] = _host(data)
    return t


# ---------------------------------------------------------------------------
# Collective ops (reference: horovod/mxnet/mpi_ops.py)
# ---------------------------------------------------------------------------

def allreduce(tensor, average: bool = True, name: Optional[str] = None,
              priority: int = 0,
              process_set: Optional[ProcessSet] = None):
    """`priority` (the MXNet engine's) is taken for parity: each
    collective runs when called."""
    out = C.allreduce(_to_torch(tensor), average=average, name=name,
                      process_set=process_set)
    return _like(tensor, out)


def allreduce_(tensor, average: bool = True, name: Optional[str] = None,
               priority: int = 0,
               process_set: Optional[ProcessSet] = None):
    out = C.allreduce(_to_torch(tensor), average=average, name=name,
                      process_set=process_set)
    return _assign_(tensor, out)


def grouped_allreduce(tensors, average: bool = True,
                      name: Optional[str] = None, priority: int = 0):
    outs = C.grouped_allreduce([_to_torch(t) for t in tensors],
                               average=average)
    return [_like(t, o) for t, o in zip(tensors, outs)]


def grouped_allreduce_(tensors, average: bool = True,
                       name: Optional[str] = None, priority: int = 0):
    outs = C.grouped_allreduce([_to_torch(t) for t in tensors],
                               average=average)
    for t, o in zip(tensors, outs):
        _assign_(t, o)
    return tensors


def allgather(tensor, name: Optional[str] = None, priority: int = 0,
              process_set: Optional[ProcessSet] = None):
    out = C.allgather(_to_torch(tensor), name=name, process_set=process_set)
    return _like(tensor, out)


def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None,
              priority: int = 0,
              process_set: Optional[ProcessSet] = None):
    out = C.broadcast(_to_torch(tensor), root_rank=root_rank, name=name,
                      process_set=process_set)
    return _like(tensor, out)


def broadcast_(tensor, root_rank: int = 0, name: Optional[str] = None,
               priority: int = 0,
               process_set: Optional[ProcessSet] = None):
    out = C.broadcast(_to_torch(tensor), root_rank=root_rank, name=name,
                      process_set=process_set)
    return _assign_(tensor, out)


def alltoall(tensor, splits=None, name: Optional[str] = None,
             priority: int = 0,
             process_set: Optional[ProcessSet] = None):
    if splits is not None:
        splits = [int(s) for s in np.asarray(_to_np(splits)).reshape(-1)]
    out = C.alltoall(_to_torch(tensor), splits=splits, name=name,
                     process_set=process_set)
    if isinstance(out, tuple):
        recv, rsplits = out
        return _like(tensor, recv), _like(tensor, rsplits)
    return _like(tensor, out)


def reducescatter(tensor, op=C.Average, name: Optional[str] = None,
                  priority: int = 0,
                  process_set: Optional[ProcessSet] = None):
    """Reduce over the ranks; return this rank's 1/size slice of dim 0
    (reference: mxnet/mpi_ops.py reducescatter)."""
    out = C.reducescatter(_to_torch(tensor), op=op, name=name,
                          process_set=process_set)
    return _like(tensor, out)


def grouped_reducescatter(tensors, op=C.Average,
                          name: Optional[str] = None, priority: int = 0,
                          process_set: Optional[ProcessSet] = None):
    outs = C.grouped_reducescatter([_to_torch(t) for t in tensors], op=op,
                                   process_set=process_set)
    return [_like(t, o) for t, o in zip(tensors, outs)]


def grouped_allgather(tensors, name: Optional[str] = None,
                      priority: int = 0,
                      process_set: Optional[ProcessSet] = None):
    outs = C.grouped_allgather([_to_torch(t) for t in tensors],
                               process_set=process_set)
    return [_like(t, o) for t, o in zip(tensors, outs)]


# ---------------------------------------------------------------------------
# Parameter broadcast (reference: horovod/mxnet/__init__.py
# broadcast_parameters)
# ---------------------------------------------------------------------------

def broadcast_parameters(params, root_rank: int = 0,
                         prefix: Optional[str] = None) -> None:
    """In-place broadcast of a dict of NDArrays or of a gluon
    ParameterDict (values with `.list_data()`), in sorted name order."""
    if hasattr(params, "items"):
        items = sorted(params.items())
    else:
        raise ValueError("invalid params of type: %s" % type(params))
    for name, p in items:
        if hasattr(p, "list_data"):  # a gluon Parameter
            for arr in p.list_data():
                broadcast_(arr, root_rank=root_rank, name=str(name))
        elif p is not None:
            broadcast_(p, root_rank=root_rank, name=str(name))


def broadcast_object(obj: Any, root_rank: int = 0) -> Any:
    from ..ops.functions import broadcast_object as _bo
    return _bo(obj, root_rank=root_rank)


# ---------------------------------------------------------------------------
# DistributedOptimizer / DistributedTrainer (reference:
# horovod/mxnet/__init__.py)
# ---------------------------------------------------------------------------

class DistributedOptimizer:
    """Wraps an mx.optimizer.Optimizer: each `update` allreduces the
    gradient (a list of them for a list of indices, in one grouped
    allreduce) before the wrapped update."""

    def __init__(self, optimizer, gradient_predivide_factor: float = 1.0,
                 num_groups: int = 0,
                 process_set: Optional[ProcessSet] = None):
        self._opt = optimizer
        self._predivide = gradient_predivide_factor
        self._process_set = process_set

    def _do_allreduce(self, index, grad) -> None:
        if size() == 1:
            return
        # The predivide is scale-neutral (horovod/mxnet/__init__.py
        # _do_allreduce): 1/f before the reduction, f after, so the
        # result is the average still.
        pre, post = 1.0 / self._predivide, self._predivide
        if isinstance(index, (tuple, list)):
            outs = C.grouped_allreduce(
                [_to_torch(g) for g in grad], average=True,
                prescale_factor=pre, postscale_factor=post,
                process_set=self._process_set)
            for g, o in zip(grad, outs):
                _assign_(g, o)
        else:
            out = C.allreduce(_to_torch(grad), average=True,
                              prescale_factor=pre, postscale_factor=post,
                              process_set=self._process_set)
            _assign_(grad, out)

    def update(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        return self._opt.update(index, weight, grad, state)

    def update_multi_precision(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        return self._opt.update_multi_precision(index, weight, grad, state)

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def set_learning_rate(self, lr):
        return self._opt.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        return self._opt.set_lr_mult(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        return self._opt.set_wd_mult(args_wd_mult)


def DistributedTrainer(params, optimizer, optimizer_params=None,
                       compression=Compression.none,
                       gradient_predivide_factor: float = 1.0):
    """A gluon Trainer whose `_allreduce_grads` averages the gradients
    over the ranks in one grouped allreduce (reference:
    DistributedTrainer(mx.gluon.Trainer)).  Needs mxnet (or a duck-typed
    gluon); built at the call, so the module imports without it."""
    if mx is None:
        raise ImportError(
            "horovod_tpu_torch.mxnet.DistributedTrainer requires mxnet; "
            "use DistributedOptimizer for the engine-level API")

    class _Trainer(mx.gluon.Trainer):
        def __init__(self):
            opt_params = dict(optimizer_params or {})
            super().__init__(params, optimizer, opt_params, kvstore=None)
            self._update_on_kvstore = False

        def _allreduce_grads(self):
            if size() == 1:
                return
            grads = [p.grad(d) for p in self._params.values()
                     if p.grad_req != "null" for d in [p.list_ctx()[0]]]
            grouped_allreduce_(grads, average=True)

    return _Trainer()


__all__ = [
    "reducescatter", "grouped_reducescatter", "grouped_allgather",
    "init", "shutdown", "size", "rank", "local_size", "local_rank",
    "cross_size", "cross_rank",
    "allreduce", "allreduce_", "grouped_allreduce", "grouped_allreduce_",
    "allgather", "broadcast", "broadcast_", "alltoall",
    "broadcast_parameters", "broadcast_object",
    "DistributedOptimizer", "DistributedTrainer",
    "Average", "Sum", "Adasum", "Compression", "barrier", "join",
]
