"""Eager collectives on torch tensors over a `torch.distributed` group.

Counterpart of `horovod_tpu/ops/collectives.py` (eager path).  The ops
keep the JAX package's semantics:

- `Average` sums in the tensor's dtype, divides at f32 and casts back
  (`_reduce_in_graph`); prescale and postscale are cast to the tensor's
  dtype before they multiply.
- `Adasum` is nonlinear, so prescale multiplies the inputs and
  postscale the result (`allreduce`, JAX :645-665).
- `grouped_allreduce` fuses every same-dtype tensor into ONE flat
  buffer per dtype, in order of first appearance, and reduces that
  buffer (JAX :761-789).  Grouped Adasum therefore combines over the
  whole fused buffer, not tensor by tensor.

Async ops return integer handles (`HandleManager`) over torch `Work`
objects; `synchronize` waits and finishes the result.

Gloo (ranks sharing a card) takes CUDA tensors for `all_reduce`,
`broadcast`, `all_gather_into_tensor` and `reduce_scatter_tensor` in
every dtype the port uses (torch 2.11 on an H100:
tests/test_torch_port_cuda.py runs these collectives on the card over
gloo), so every backend gets the tensors where they lie.  Allgather and broadcast move raw bytes (a uint8 view),
so every dtype takes the same path.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..common import basics
from ..common.basics import ProcessSet
from ..common.exceptions import HorovodTpuError


class ReduceOp:
    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"ReduceOp.{self.name}"


Average = ReduceOp("Average")
Sum = ReduceOp("Sum")
Min = ReduceOp("Min")
Max = ReduceOp("Max")
Product = ReduceOp("Product")
Adasum = ReduceOp("Adasum")

_WIRE_OPS = {
    "Average": dist.ReduceOp.SUM,
    "Sum": dist.ReduceOp.SUM,
    "Min": dist.ReduceOp.MIN,
    "Max": dist.ReduceOp.MAX,
    "Product": dist.ReduceOp.PRODUCT,
}


def _resolve_set(process_set: Optional[ProcessSet]) -> ProcessSet:
    return process_set if process_set is not None \
        else basics.global_process_set()


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


class _Pending:
    """One in-flight collective: its torch `Work` objects and the
    function that turns the exchanged buffers into the result."""

    def __init__(self, works: Sequence[Any], finish: Callable[[], Any]):
        self._works = list(works)
        self._finish = finish

    def ready(self) -> bool:
        return all(w.is_completed() for w in self._works)

    def wait(self) -> Any:
        for w in self._works:
            w.wait()
        return self._finish()


def _scale(t: torch.Tensor, factor: float) -> torch.Tensor:
    """`t * factor` with the factor cast to t's dtype first, as the JAX
    package does (`xs * prescale.astype(xs.dtype)`)."""
    if factor == 1.0:
        return t
    return t * torch.tensor(factor, dtype=t.dtype, device=t.device)


# ---------------------------------------------------------------------------
# Allreduce
# ---------------------------------------------------------------------------

def _allreduce_start(tensor: torch.Tensor, op: ReduceOp, prescale: float,
                     postscale: float, ps: ProcessSet,
                     owned: bool = False) -> _Pending:
    """`owned`: `tensor` is a scratch buffer of the caller's (a fused
    bucket) that the wire may reduce into."""
    if op.name not in _WIRE_OPS:
        raise HorovodTpuError(f"Unsupported reduce op {op}")
    n = ps.size()
    src = tensor.detach()
    buf = _scale(src, prescale)
    # The wire reduces in place: never into the caller's tensor.
    buf = (src.clone(memory_format=torch.contiguous_format)
           if buf is src and not owned else buf.contiguous())
    works = []
    if ps.group is not None:
        works.append(dist.all_reduce(buf, op=_WIRE_OPS[op.name],
                                     group=ps.group, async_op=True))

    def finish():
        out = buf
        if op is Average:
            out = (out.float() / n).to(out.dtype)
        return _scale(out, postscale)

    return _Pending(works, finish)


def allreduce(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Allreduce `tensor` across the ranks of the process set; returns
    a new tensor (reference: EnqueueTensorAllreduce)."""
    del name
    if op is None:
        op = Sum if average is False else Average
    ps = _resolve_set(process_set)
    if op is Adasum:
        from . import adasum as _adasum

        x = _scale(tensor.detach(), prescale_factor)
        out = _adasum.adasum_allreduce(x, process_set=ps)
        return _scale(out, postscale_factor)
    return _allreduce_start(tensor, op, prescale_factor, postscale_factor,
                            ps).wait()


def _grouped_allreduce_start(tensors: Sequence[torch.Tensor], op: ReduceOp,
                             prescale: float, postscale: float,
                             ps: ProcessSet) -> _Pending:
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    buckets = []
    for idxs in by_dtype.values():
        fused = torch.cat([tensors[i].detach().reshape(-1) for i in idxs])
        if op is Adasum:
            red = allreduce(fused, op=op, prescale_factor=prescale,
                            postscale_factor=postscale, process_set=ps)
            buckets.append((idxs, _Pending([], lambda red=red: red)))
        else:
            buckets.append((idxs, _allreduce_start(
                fused, op, prescale, postscale, ps, owned=True)))

    def finish():
        out: List[Any] = [None] * len(tensors)
        for idxs, pending in buckets:
            red = pending.wait()
            offset = 0
            for i in idxs:
                sz = tensors[i].numel()
                out[i] = red[offset: offset + sz].reshape(tensors[i].shape)
                offset += sz
        return out

    works = [w for _, p in buckets for w in p._works]
    return _Pending(works, finish)


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      average: Optional[bool] = None,
                      name: Optional[str] = None,
                      op: Optional[ReduceOp] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set: Optional[ProcessSet] = None
                      ) -> List[torch.Tensor]:
    """Fused allreduce of a tensor group: one flat buffer and one
    collective per dtype (reference: EnqueueTensorAllreduces +
    group_table.cc)."""
    del name
    if op is None:
        op = Sum if average is False else Average
    if not tensors:
        return []
    return _grouped_allreduce_start(tensors, op, prescale_factor,
                                    postscale_factor,
                                    _resolve_set(process_set)).wait()


# ---------------------------------------------------------------------------
# Allgather / broadcast / barrier
# ---------------------------------------------------------------------------

def _allgather_start(tensor: torch.Tensor, ps: ProcessSet) -> _Pending:
    t = tensor.detach()
    if t.dim() == 0:
        t = t.reshape(1)
    n = ps.size()
    out_shape = (n * t.shape[0],) + tuple(t.shape[1:])
    if ps.group is None:
        return _Pending([], lambda: t.clone().reshape(out_shape))
    flat = _as_bytes(t)
    gathered = torch.empty(n * flat.numel(), dtype=torch.uint8,
                           device=flat.device)
    works = [dist.all_gather_into_tensor(gathered, flat, group=ps.group,
                                         async_op=True)]
    return _Pending(works,
                    lambda: gathered.view(t.dtype).reshape(out_shape))


def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0, in rank order.  All
    ranks give the same shape (ragged dim 0 waits for a later slice)."""
    del name
    return _allgather_start(tensor, _resolve_set(process_set)).wait()


def _broadcast_start(tensor: torch.Tensor, root_rank: int,
                     ps: ProcessSet, out: torch.Tensor,
                     result: Optional[torch.Tensor] = None) -> _Pending:
    """Broadcast `tensor` from set-rank `root_rank` into `out` (which may
    be `tensor` itself); the handle yields `result` (default `out`): the
    caller's own tensor for the in-place variants."""
    result = out if result is None else result
    if out is not tensor:
        out.copy_(tensor)
    if ps.group is None:
        return _Pending([], lambda: result)
    buf = out if out.is_contiguous() else out.contiguous()
    works = [dist.broadcast(_as_bytes(buf), src=ps.ranks[root_rank],
                            group=ps.group, async_op=True)]

    def finish():
        if buf is not out:
            out.copy_(buf)
        return result

    return _Pending(works, finish)


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Return root's value of `tensor` on every rank (a new tensor)."""
    del name
    out = torch.empty_like(tensor.detach(),
                           memory_format=torch.contiguous_format)
    return _broadcast_start(tensor.detach(), root_rank,
                            _resolve_set(process_set), out).wait()


def broadcast_(tensor: torch.Tensor, root_rank: int = 0,
               name: Optional[str] = None,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """In-place broadcast from root."""
    del name
    t = tensor.detach()
    return _broadcast_start(t, root_rank, _resolve_set(process_set), t,
                            result=tensor).wait()


# ---------------------------------------------------------------------------
# Reduce-scatter
# ---------------------------------------------------------------------------

def _reducescatter_start(tensor: torch.Tensor, op: ReduceOp,
                         ps: ProcessSet) -> _Pending:
    if op is not Sum and op is not Average:
        raise HorovodTpuError(
            f"reducescatter supports Sum and Average, got {op}")
    t = tensor.detach()
    n = ps.size()
    if t.dim() != 1 or t.numel() % n:
        raise HorovodTpuError(
            f"reducescatter needs a flat buffer whose length divides by "
            f"the set size ({n}); got shape {tuple(t.shape)}")
    if ps.group is None:
        out = t.clone()
        works = []
    else:
        out = torch.empty(t.numel() // n, dtype=t.dtype, device=t.device)
        works = [dist.reduce_scatter_tensor(out, t.contiguous(),
                                            op=dist.ReduceOp.SUM,
                                            group=ps.group, async_op=True)]

    def finish():
        if op is Average:
            return (out.float() / n).to(out.dtype)
        return out

    return _Pending(works, finish)


def reducescatter(tensor: torch.Tensor, op: ReduceOp = Average,
                  name: Optional[str] = None,
                  process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Sum (or average) a flat buffer across the ranks and return this
    rank's band of the result: elements [r·L/n, (r+1)·L/n) on set rank
    r, for a buffer of length L divisible by the set size n (the ZeRO
    layout; ragged dim 0 waits for a later slice).  Average sums in the
    buffer's dtype and divides at f32, as `allreduce` does.

    Every backend runs `reduce_scatter_tensor`, gloo on CUDA tensors
    included (torch 2.11 on an H100: tests/test_torch_port_cuda.py
    `test_gloo_on_card_reducescatter`)."""
    del name
    return _reducescatter_start(tensor, op, _resolve_set(process_set)).wait()


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    """Block until every rank reaches the barrier (reference: BarrierOp;
    a 1-element allreduce, as in the JAX package)."""
    allreduce(torch.zeros((1,), dtype=torch.int32, device=basics.device()),
              op=Sum, process_set=process_set)


# ---------------------------------------------------------------------------
# Async API (reference: torch/handle_manager.* + mpi_ops.py poll/synchronize)
# ---------------------------------------------------------------------------

class HandleManager:
    """Integer handles → in-flight collectives."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._pending: Dict[int, _Pending] = {}

    @classmethod
    def global_instance(cls) -> "HandleManager":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def allocate(self, pending: _Pending) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._pending[h] = pending
            return h

    def poll(self, handle: int) -> bool:
        with self._lock:
            pending = self._pending[handle]
        return pending.ready()

    def release(self, handle: int) -> Any:
        with self._lock:
            pending = self._pending.pop(handle)
        return pending.wait()


def _handle(pending: _Pending) -> int:
    return HandleManager.global_instance().allocate(pending)


def allreduce_async(tensor: torch.Tensor, average: Optional[bool] = None,
                    name: Optional[str] = None,
                    op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set: Optional[ProcessSet] = None) -> int:
    if op is None:
        op = Sum if average is False else Average
    if op is Adasum:
        out = allreduce(tensor, op=op, prescale_factor=prescale_factor,
                        postscale_factor=postscale_factor,
                        process_set=process_set)
        return _handle(_Pending([], lambda: out))
    return _handle(_allreduce_start(tensor, op, prescale_factor,
                                    postscale_factor,
                                    _resolve_set(process_set)))


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            average: Optional[bool] = None,
                            name: Optional[str] = None,
                            op: Optional[ReduceOp] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            process_set: Optional[ProcessSet] = None) -> int:
    """One handle for the whole fused group."""
    del name
    if op is None:
        op = Sum if average is False else Average
    if not tensors:
        return _handle(_Pending([], lambda: []))
    return _handle(_grouped_allreduce_start(
        tensors, op, prescale_factor, postscale_factor,
        _resolve_set(process_set)))


def reducescatter_async(tensor: torch.Tensor, op: ReduceOp = Average,
                        name: Optional[str] = None,
                        process_set: Optional[ProcessSet] = None) -> int:
    del name
    return _handle(_reducescatter_start(tensor, op,
                                        _resolve_set(process_set)))


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    del name
    return _handle(_allgather_start(tensor, _resolve_set(process_set)))


def broadcast_async(tensor: torch.Tensor, root_rank: int = 0,
                    name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    del name
    t = tensor.detach()
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    return _handle(_broadcast_start(t, root_rank,
                                    _resolve_set(process_set), out))


def broadcast_async_(tensor: torch.Tensor, root_rank: int = 0,
                     name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> int:
    del name
    t = tensor.detach()
    return _handle(_broadcast_start(t, root_rank, _resolve_set(process_set),
                                    t, result=tensor))


def poll(handle: int) -> bool:
    """True when the handle's collective has completed."""
    return HandleManager.global_instance().poll(handle)


def synchronize(handle: int) -> Any:
    """Wait for the handle's collective and return its result."""
    return HandleManager.global_instance().release(handle)
