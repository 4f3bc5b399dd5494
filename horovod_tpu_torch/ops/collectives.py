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

- `allgather` takes a ragged dim 0 (sizes exchanged first, each rank
  padded to the largest and sliced back); `reducescatter` takes any dim
  0 under the JAX package's eager rule (ceil(dim0 / n) rows per rank,
  the padding cut off); `alltoall` takes splits and returns the
  received splits; `grouped_allgather` and `grouped_reducescatter`
  fuse as the JAX eager path does.
- Every collective takes `process_set=` (`add_process_set`: a
  `dist.new_group` of its own) and refuses a removed set or a rank
  outside it.  A set of one rank exchanges nothing (`ProcessSet.comm`).
- Under join mode (`ops/join.py`) each outermost collective publishes
  its signature for joined ranks to mirror, and a joined rank
  contributes its op's identity: Average divides by the active count.
- Every eager dispatch runs in the `_traced` bracket (JAX `_traced`,
  :150-247), nested ones included: the fault points `collective.<kind>`
  and `chaos.straggler_delay` first (so hit indices line up with the
  JAX package's, and an injected straggler delay lands before the
  span), then a stall-inspector entry, a timeline activity `KIND:name`
  and, on exit, the `collective_calls` / `collective_bytes` /
  `collective_latency` metrics.  An injected error, and a failure of
  `torch.distributed` at dispatch or at the wait, surfaces as
  HorovodInternalError, the signal elastic recovery catches.

Async ops return integer handles (`HandleManager`) over torch `Work`
objects; `synchronize` waits and finishes the result.

Gloo (ranks sharing a card) takes CUDA tensors for `all_reduce`,
`broadcast`, `all_gather_into_tensor`, `reduce_scatter_tensor` and
`all_to_all_single` (uneven splits included) in every dtype the port
uses (torch 2.11 on an H100: tests/test_torch_port_cuda.py and
chip_smoke.py phase `surface_np2` run these collectives on the card
over gloo), so every backend gets the tensors where they lie.
Allgather, broadcast and alltoall move raw bytes (a uint8 view), so
every dtype takes the same path.  Gloo's send and receive take host
buffers only: `sendrecv` stages a CUDA tensor through host memory
there.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import faults as _faults
from ..common import basics
from ..common.basics import ProcessSet
from ..common.exceptions import HorovodInternalError, HorovodTpuError
from ..metrics import catalog as _met
from ..utils import consistency as _cc
from ..utils import stall_inspector as _stall
from ..utils import timeline as _tl
from . import join as _join

logger = logging.getLogger("horovod_tpu_torch")


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
    """The set a collective runs over (default: the global one); raises
    for a removed set and on a rank outside the set, as the JAX package
    does."""
    ps = process_set if process_set is not None \
        else basics.global_process_set()
    if ps.removed:
        raise HorovodTpuError(
            f"process set {ps.process_set_id} was removed")
    if not ps.included():
        raise HorovodTpuError(
            f"This process has no ranks in process set {ps.process_set_id}")
    return ps


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


class _Pending:
    """One in-flight collective: its torch `Work` objects and the
    function that turns the exchanged buffers into the result.  `stall`
    is the stall-inspector entry that `wait()` closes (set by
    `_traced.track`)."""

    def __init__(self, works: Sequence[Any], finish: Callable[[], Any]):
        self._works = list(works)
        self._finish = finish
        self.stall = None

    def ready(self) -> bool:
        return all(w.is_completed() for w in self._works)

    def wait(self) -> Any:
        try:
            for w in self._works:
                w.wait()
        except RuntimeError as e:
            raise HorovodInternalError(f"collective failed: {e}") from e
        finally:
            if self.stall is not None:
                si, key = self.stall
                si.record_end(key)
        return self._finish()


def _done(result: Any) -> _Pending:
    """A handle over a result that is already there."""
    return _Pending([], lambda: result)


def _launch(fn: Callable, *args, **kwargs) -> Any:
    """Start a `torch.distributed` collective.  A failure of the process
    group (a DistBackendError, or another RuntimeError out of the
    backend) becomes HorovodInternalError, as a failed collective does
    in the JAX package."""
    try:
        return fn(*args, **kwargs)
    except RuntimeError as e:
        raise HorovodInternalError(f"{fn.__name__} failed: {e}") from e


def _capturing() -> bool:
    """Whether this thread's stream is being captured into a CUDA graph
    (`utils/megastep.py`); never in a process that has not initialized
    CUDA."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _stream_ordered() -> bool:
    """Whether waiting for a collective orders the current stream rather
    than the host: NCCL's `Work.wait()` does; gloo's returns when the
    exchange is done."""
    return basics.backend() == "nccl"


class _traced:
    """The bracket of one eager collective (JAX `_traced`,
    ops/collectives.py:150-247), in its order:

    - on entry the fault points: `collective.<kind>` when the catalog
      names it, then `chaos.straggler_delay` (an injected error becomes
      HorovodInternalError; a straggler's delay lands before the span
      starts, so the span blames the rank that was late);
    - a stall-inspector entry (`utils/stall_inspector.py`), closed on
      exit, or, for a handle passed to `track`, when its `Work`
      completes or `wait()` runs;
    - a timeline activity `KIND:name` (`utils/timeline.py`);
    - on a clean exit the metrics: one `collective_calls` and the host
      latency, and `collective_bytes` when the call site gave `stat` the
      payload: every rank's contribution, the set size times the bytes
      one rank stages (JAX's staged global (set_size, ...) array).

    A synchronous collective waits inside the bracket, so its span and
    its stall entry cover the exchange; over NCCL that wait orders the
    current stream and the host goes on (`_stream_ordered`), so the
    span ends at dispatch and says so, as a tracked one does.  While
    the stream is captured
    into a CUDA graph the bracket fires the fault points only: a replay
    runs none of this Python, and the watchdog must not poll a captured
    event.  Hooks run on autograd's device thread: the inspector, the
    timeline and the registry each take their own lock.  Overhead with
    no inspector, timeline or metrics: a few attribute loads."""

    __slots__ = ("_desc", "_kind", "_si", "_key", "_tl", "_token",
                 "_tracked", "_async", "_t0", "_nbytes", "_dtype", "_ps")

    def __init__(self, kind: str, name: Optional[str] = None):
        self._desc = f"{kind}:{name}" if name else kind
        self._kind = kind
        self._si = self._tl = self._key = self._token = None
        self._tracked = self._async = False
        self._t0 = 0.0
        self._nbytes = 0
        self._dtype = "none"
        self._ps = 0

    def __enter__(self):
        if _faults.active():
            try:
                pt = f"collective.{self._kind.lower()}"
                if pt in _faults.CATALOG:
                    _faults.point(pt)
                _faults.point("chaos.straggler_delay")
            except _faults.FaultInjected as e:
                raise HorovodInternalError(str(e)) from e
        if _capturing():
            return self
        self._si = _stall.get_inspector()
        self._tl = _tl.get_timeline()
        if self._si is not None:
            self._key = self._si.record_start(self._desc)
        if self._tl is not None:
            self._token = self._tl.activity_start(self._desc, self._kind)
        self._t0 = time.perf_counter()
        return self

    def stat(self, nbytes: int, dtype: torch.dtype, ps: ProcessSet) -> None:
        """The payload: `nbytes` staged by this rank (counted set-size
        times), its dtype and the process set."""
        self._nbytes = int(nbytes) * ps.size()
        self._dtype = _dtype_name(dtype)
        self._ps = ps.process_set_id

    def track(self, pending: _Pending) -> _Pending:
        """Keep the stall entry open until `pending` completes.  The
        span then ends at dispatch, and says so (`dispatch: async`):
        `trace.core.analyze` nets a lag such a bucket carries over."""
        self._async = True
        if self._key is not None:
            self._si.record_result(self._key, pending)
            pending.stall = (self._si, self._key)
            self._tracked = True
        return pending

    def complete(self, pending: _Pending, sync: bool) -> _Pending:
        """`pending` waited for inside the bracket (sync), or tracked."""
        if sync:
            self._async = _stream_ordered()
            return _done(pending.wait())
        return self.track(pending)

    def __exit__(self, exc_type, *exc):
        if self._token is not None:
            self._tl.activity_end(self._token,
                                  dispatch="async" if self._async else None)
        if self._key is not None and (exc_type is not None
                                      or not self._tracked):
            self._si.record_end(self._key)
        if self._t0 and exc_type is None and _met.enabled():
            lbl = (self._kind, self._dtype, str(self._ps))
            _met.collective_calls.labels(*lbl).inc()
            if self._nbytes:
                _met.collective_bytes.labels(*lbl).inc(self._nbytes)
            _met.collective_latency.labels(*lbl).observe(
                time.perf_counter() - self._t0)
        return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _scale(t: torch.Tensor, factor: float) -> torch.Tensor:
    """`t * factor` with the factor cast to t's dtype first, as the JAX
    package does (`xs * prescale.astype(xs.dtype)`).  The factor is
    filled on t's device (no host copy: a CUDA graph can capture it)."""
    if factor == 1.0:
        return t
    return t * torch.full((), factor, dtype=t.dtype, device=t.device)


# ---------------------------------------------------------------------------
# Join mode: signatures and masked contributions (ops/join.py)
# ---------------------------------------------------------------------------

_join_tls = threading.local()


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class _joinable:
    """Bracket for the outermost eager collective: when join mode is
    armed, publish this op's signature so that joined ranks can mirror
    it; otherwise, under HOROVOD_COLLECTIVE_CONSISTENCY_CHECK=1, hold the
    same signature to every rank's of the op's process set
    (`utils/consistency.py`; JAX `_joinable`).  Collectives nested inside
    it (a barrier's allreduce, the size exchange of a ragged allgather)
    publish nothing."""

    __slots__ = ("_outer",)

    def __init__(self, kind: str, tensors: Sequence[torch.Tensor] = (),
                 op: Optional["ReduceOp"] = None,
                 root_rank: Optional[int] = None,
                 process_set: Optional[ProcessSet] = None,
                 prescale: float = 1.0, postscale: float = 1.0,
                 extra: Optional[Dict[str, Any]] = None):
        self._outer = not getattr(_join_tls, "nested", False)
        if not (self._outer and (_join.armed() or _cc.enabled())):
            return
        shapes = [list(t.shape) for t in tensors]
        if kind == "allgather":
            # Ragged dim 0: the mirror sends no rows anyway.
            shapes = [[0] + s[1:] if s else s for s in shapes]
        sig: Dict[str, Any] = {
            "kind": kind, "shapes": shapes,
            "dtypes": [_dtype_name(t.dtype) for t in tensors]}
        if op is not None:
            sig["op"] = op.name
        if root_rank is not None:
            sig["root_rank"] = root_rank
        if process_set is not None and process_set.process_set_id:
            sig["ps"] = process_set.process_set_id
        if prescale != 1.0:
            sig["pre"] = float(prescale)
        if postscale != 1.0:
            sig["post"] = float(postscale)
        sig.update(extra or {})
        if _join.armed():
            # Join mode owns the signature protocol: the blocking
            # consistency barrier would deadlock against a joined rank,
            # which mirrors only after the signature is published, and
            # the mirroring itself enforces cross-rank agreement.
            _join.publish_signature(sig)
        else:
            _cc.check(sig, ranks=process_set.ranks if process_set else None)

    def __enter__(self):
        if self._outer:
            _join_tls.nested = True
        return self

    def __exit__(self, *exc):
        if self._outer:
            _join_tls.nested = False
        return False


def _masked(x: torch.Tensor, op: "ReduceOp") -> torch.Tensor:
    """This rank's contribution to a reduction under join mode: itself
    while active; once joined, the op's identity (JAX
    `masked_reduce_in_graph`: x · mask for Sum and Average, the dtype's
    largest value for Min, its smallest for Max, 1 for Product)."""
    if not _join.is_joined():
        return x  # x · 1 is x
    if op is Sum or op is Average:
        return torch.zeros_like(x)
    info = (torch.finfo if x.dtype.is_floating_point else torch.iinfo)(
        x.dtype)
    fill = {"Min": info.max, "Max": info.min, "Product": 1}[op.name]
    return torch.full_like(x, fill)


def _active_count(ps: ProcessSet, device) -> tuple:
    """Start the sum of the ranks' active flags (the divisor of a masked
    Average); returns (works, the count's buffer)."""
    flag = torch.tensor([0.0 if _join.is_joined() else 1.0],
                        dtype=torch.float32, device=device)
    works = []
    if ps.comm is not None:
        works.append(_launch(dist.all_reduce, flag, op=dist.ReduceOp.SUM,
                             group=ps.comm, async_op=True))
    return works, flag


def _divide(out: torch.Tensor, n: int, count) -> torch.Tensor:
    """Average's division at f32, cast back: by the set size, or under
    join mode by the active count (at least 1)."""
    if count is not None:
        return (out.float() / count.clamp(min=1.0)).to(out.dtype)
    return (out.float() / n).to(out.dtype)


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
    if _join.armed():
        buf = _masked(buf, op)
    # The wire reduces in place: never into the caller's tensor.
    buf = (src.clone(memory_format=torch.contiguous_format)
           if buf is src and not owned else buf.contiguous())
    works, count = [], None
    if ps.comm is not None:
        works.append(_launch(dist.all_reduce, buf, op=_WIRE_OPS[op.name],
                             group=ps.comm, async_op=True))
    if _join.armed() and op is Average:
        count_works, count = _active_count(ps, buf.device)
        works += count_works

    def finish():
        out = buf
        if op is Average:
            out = _divide(out, n, count)
        return _scale(out, postscale)

    return _Pending(works, finish)


def _allreduce_traced(tensor: torch.Tensor, op: ReduceOp,
                      prescale: float, postscale: float, ps: ProcessSet,
                      name: Optional[str] = None,
                      sync: bool = False) -> _Pending:
    """One eager allreduce in its bracket (a hit of
    `collective.allreduce`)."""
    with _traced("ALLREDUCE", name) as tr:
        tr.stat(_nbytes(tensor), tensor.dtype, ps)
        return tr.complete(
            _allreduce_start(tensor, op, prescale, postscale, ps), sync)


def allreduce(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Allreduce `tensor` across the ranks of the process set; returns
    a new tensor (reference: EnqueueTensorAllreduce)."""
    if op is None:
        op = Sum if average is False else Average
    ps = _resolve_set(process_set)
    with _joinable("allreduce", [tensor], op=op, process_set=ps,
                   prescale=prescale_factor, postscale=postscale_factor):
        if op is Adasum:
            from . import adasum as _adasum

            with _traced("ALLREDUCE", name) as tr:
                tr.stat(_nbytes(tensor), tensor.dtype, ps)
                x = _scale(tensor.detach(), prescale_factor)
                out = _adasum.adasum_allreduce(x, process_set=ps)
                return tr.complete(_done(_scale(out, postscale_factor)),
                                   sync=True).wait()
        return _allreduce_traced(tensor, op, prescale_factor,
                                 postscale_factor, ps, name,
                                 sync=True).wait()


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
            buckets.append((idxs, _done(red)))
        else:
            with _traced("ALLREDUCE") as tr:  # one per dtype, as in JAX
                tr.stat(_nbytes(fused), fused.dtype, ps)
                buckets.append((idxs, tr.track(_allreduce_start(
                    fused, op, prescale, postscale, ps, owned=True))))

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
    ps = _resolve_set(process_set)
    with _joinable("grouped_allreduce", tensors, op=op, process_set=ps,
                   prescale=prescale_factor, postscale=postscale_factor):
        return _grouped_allreduce_start(tensors, op, prescale_factor,
                                        postscale_factor, ps).wait()


# ---------------------------------------------------------------------------
# Allgather: equal shapes, ragged dim 0, groups
# ---------------------------------------------------------------------------

def _gather_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """t (at least 1-D) zero-padded along dim 0 to `rows` rows."""
    if t.shape[0] == rows:
        return t
    pad = t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat([t, pad])


def _allgather_start(tensor: torch.Tensor, ps: ProcessSet,
                     out: Optional[torch.Tensor] = None) -> _Pending:
    """Allgather a tensor whose shape is the same on every rank: one
    `all_gather_into_tensor` of its bytes, with no size exchange.
    `out` (n·dim0 rows, the tensor's dtype, contiguous) receives the
    gather when given."""
    t = tensor.detach()
    if t.dim() == 0:
        t = t.reshape(1)
    n = ps.size()
    out_shape = (n * t.shape[0],) + tuple(t.shape[1:])
    if out is None:
        out = torch.empty(out_shape, dtype=t.dtype, device=t.device)
    if ps.comm is None:
        out.copy_(t.reshape(out_shape))
    if ps.comm is None or t.numel() == 0:
        return _Pending([], lambda: out.reshape(out_shape))
    works = [_launch(dist.all_gather_into_tensor, _as_bytes(out),
                     _as_bytes(t), group=ps.comm, async_op=True)]
    return _Pending(works, lambda: out.reshape(out_shape))


def _exchange_dims(dims: Sequence[int], ps: ProcessSet,
                   device) -> List[List[int]]:
    """Every rank's list of k integers (the same k on each rank), as an
    (n, k) table in rank order: one small blocking allgather."""
    mine = torch.tensor(list(dims), dtype=torch.int64, device=device)
    if ps.comm is None:
        return [list(dims)]
    table = _allgather_start(mine.reshape(1, -1), ps).wait()
    return table.cpu().tolist()


def allgather_sizes(local_dim0: Sequence[int], ps: ProcessSet,
                    device=None) -> List[int]:
    """Every rank's first-dim size, in rank order (the displacement
    exchange of AllgatherOp::SetDisplacements; JAX `allgather_sizes`).
    `local_dim0` holds this process's one rank's size."""
    if len(local_dim0) != 1:
        raise HorovodTpuError(
            f"allgather_sizes takes this process's one rank's size; got "
            f"{len(local_dim0)} values")
    device = basics.device() if device is None else device
    with _traced("ALLGATHER_SIZES"):
        return [row[0] for row in _exchange_dims(local_dim0, ps, device)]


def _ragged_allgather_start(t: torch.Tensor, sizes: List[int],
                            ps: ProcessSet) -> _Pending:
    """Allgather where rank r holds sizes[r] rows: each rank pads to the
    largest, and the padding is sliced off again."""
    top = max(sizes)
    if all(s == top for s in sizes):
        return _allgather_start(t, ps)
    padded = _allgather_start(_gather_rows(t, top), ps)

    def finish():
        got = padded.wait()
        return torch.cat([got[r * top: r * top + s]
                          for r, s in enumerate(sizes)])

    return _Pending(padded._works, finish)


def _row_bytes(t: torch.Tensor) -> int:
    """Bytes of one row along dim 0."""
    rest = 1
    for d in t.shape[1:]:
        rest *= d
    return rest * t.element_size()


def _allgather_traced(t: torch.Tensor, sizes: List[int], ps: ProcessSet,
                      name: Optional[str] = None,
                      sync: bool = False) -> _Pending:
    """One gather of t (at least 1-D; rank r holds sizes[r] rows) in its
    bracket: each rank stages the largest row count."""
    with _traced("ALLGATHER", name) as tr:
        tr.stat(max(sizes) * _row_bytes(t), t.dtype, ps)
        if ps.comm is None:
            return tr.complete(_allgather_start(t, ps), sync)
        return tr.complete(_ragged_allgather_start(t, sizes, ps), sync)


def _allgather_any_start(tensor: torch.Tensor, ps: ProcessSet,
                         name: Optional[str] = None,
                         sync: bool = False) -> _Pending:
    """A multi-rank job exchanges the sizes first, over any set, as the
    JAX package's multi-process path does."""
    t = tensor.detach()
    if t.dim() == 0:
        t = t.reshape(1)
    sizes = (allgather_sizes([t.shape[0]], ps, t.device)
             if basics.size() > 1 else [t.shape[0]])
    return _allgather_traced(t, sizes, ps, name, sync)


def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0, in rank order
    (reference: EnqueueTensorAllgather).  Dim 0 may differ between
    ranks: the sizes are exchanged first (`allgather_sizes`), and when
    they differ each rank pads to the largest and the padding is sliced
    off; when they agree the data moves in one
    `all_gather_into_tensor`."""
    ps = _resolve_set(process_set)
    with _joinable("allgather", [tensor], process_set=ps):
        return _allgather_any_start(tensor, ps, name, sync=True).wait()


def _grouped_allgather_start(tensors: Sequence[torch.Tensor],
                             ps: ProcessSet) -> _Pending:
    """One size exchange for the whole group, then each tensor's gather
    in flight at once.  The brackets follow JAX's tensor-by-tensor
    sequence (sizes, then rows, for each tensor): the first sizes
    bracket holds the group's one exchange."""
    ts = [t.detach().reshape(1) if t.dim() == 0 else t.detach()
          for t in tensors]
    table = None
    starts = []
    for j, t in enumerate(ts):
        if basics.size() > 1:
            with _traced("ALLGATHER_SIZES"):
                if j == 0 and ps.comm is not None:
                    table = _exchange_dims([u.shape[0] for u in ts], ps,
                                           ts[0].device)
        sizes = ([row[j] for row in table] if table is not None
                 else [t.shape[0]])
        starts.append(_allgather_traced(t, sizes, ps))
    return _Pending([w for p in starts for w in p._works],
                    lambda: [p.wait() for p in starts])


def grouped_allgather(tensors: Sequence[torch.Tensor],
                      name: Optional[str] = None,
                      process_set: Optional[ProcessSet] = None
                      ) -> List[torch.Tensor]:
    """Allgather each tensor of a group (JAX `grouped_allgather`'s exact
    path), dim 0 ragged as in `allgather`; the sizes of the whole group
    are exchanged in one collective."""
    del name
    if not tensors:
        return []
    ps = _resolve_set(process_set)
    with _joinable("grouped_allgather", tensors, process_set=ps):
        return _grouped_allgather_start(tensors, ps).wait()


# ---------------------------------------------------------------------------
# Broadcast / barrier
# ---------------------------------------------------------------------------

def _broadcast_start(tensor: torch.Tensor, root_rank: int,
                     ps: ProcessSet, out: torch.Tensor,
                     result: Optional[torch.Tensor] = None,
                     name: Optional[str] = None,
                     sync: bool = False) -> _Pending:
    """Broadcast `tensor` from set-rank `root_rank` into `out` (which may
    be `tensor` itself), in its bracket; the handle yields `result`
    (default `out`): the caller's own tensor for the in-place
    variants."""
    if root_rank not in range(ps.size()):
        raise HorovodTpuError(
            f"root_rank {root_rank} out of range for set of size "
            f"{ps.size()}")
    with _traced("BROADCAST", name) as tr:
        tr.stat(_nbytes(tensor), tensor.dtype, ps)
        return tr.complete(_broadcast_pending(
            tensor, root_rank, ps, out,
            out if result is None else result), sync)


def _broadcast_pending(tensor: torch.Tensor, root_rank: int,
                       ps: ProcessSet, out: torch.Tensor,
                       result: torch.Tensor) -> _Pending:
    if out is not tensor:
        out.copy_(tensor)
    if ps.comm is None:
        return _Pending([], lambda: result)
    buf = out if out.is_contiguous() else out.contiguous()
    works = [_launch(dist.broadcast, _as_bytes(buf), src=ps.ranks[root_rank],
                     group=ps.comm, async_op=True)]

    def finish():
        if buf is not out:
            out.copy_(buf)
        return result

    return _Pending(works, finish)


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Return root's value of `tensor` on every rank (a new tensor)."""
    ps = _resolve_set(process_set)
    out = torch.empty_like(tensor.detach(),
                           memory_format=torch.contiguous_format)
    with _joinable("broadcast", [tensor], root_rank=root_rank,
                   process_set=ps):
        return _broadcast_start(tensor.detach(), root_rank, ps, out,
                                name=name, sync=True).wait()


def broadcast_(tensor: torch.Tensor, root_rank: int = 0,
               name: Optional[str] = None,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """In-place broadcast from root."""
    ps = _resolve_set(process_set)
    t = tensor.detach()
    with _joinable("broadcast", [tensor], root_rank=root_rank,
                   process_set=ps):
        return _broadcast_start(t, root_rank, ps, t, result=tensor,
                                name=name, sync=True).wait()


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    """Block until every rank reaches the barrier (reference: BarrierOp;
    a 1-element allreduce, as in the JAX package)."""
    ps = _resolve_set(process_set)
    with _joinable("barrier", process_set=ps), _traced("BARRIER"):
        allreduce(torch.zeros((1,), dtype=torch.int32,
                              device=basics.device()),
                  op=Sum, process_set=ps)


def join(process_set: Optional[ProcessSet] = None) -> int:
    """Uneven-data join (reference: EnqueueJoin / JoinOp; ops/join.py):
    from now on this rank contributes zeros to every collective of the
    others until all ranks have joined; returns the last rank to join."""
    return _join.join(process_set)


# ---------------------------------------------------------------------------
# Point-to-point (the quantized ring's hops, the Adasum ladder, ppermute)
# ---------------------------------------------------------------------------

def _staged(ps: ProcessSet, t: torch.Tensor) -> bool:
    """Whether a point-to-point op of `t` goes through host memory: gloo
    sends and receives host buffers only."""
    return t.is_cuda and dist.get_backend(ps.comm) == "gloo"


def _p2p_ready(ps: ProcessSet) -> None:
    """The set's first point-to-point exchange: every rank of it sends
    one element to the next set rank and receives one from the one
    before, in one `batch_isend_irecv`.  On NCCL a batch of
    point-to-point ops builds the group's communicator the first time,
    over every rank of the group, so every rank must post that first
    batch (torch's `batch_isend_irecv`); an exchange between some of
    the ranks hangs there until the others come.  After it, batches
    between any of them run.  Gloo needs none of this and runs the same
    exchange, so that both backends take one path."""
    n, i = ps.size(), ps.rank()
    dev = ("cpu" if dist.get_backend(ps.comm) == "gloo"
           else basics.device())
    send = torch.zeros(1, dtype=torch.int32, device=dev)
    recv = torch.empty_like(send)
    works = _launch(dist.batch_isend_irecv, [
        dist.P2POp(dist.isend, send, ps.ranks[(i + 1) % n], group=ps.comm),
        dist.P2POp(dist.irecv, recv, ps.ranks[(i - 1) % n], group=ps.comm)])
    _Pending(works, lambda: None).wait()
    ps.p2p_ready = True


def sendrecv(ps: ProcessSet, send: Optional[torch.Tensor],
             dst: Optional[int], recv: Optional[torch.Tensor],
             src: Optional[int]) -> None:
    """Send `send` to set rank `dst` and receive into `recv` from set
    rank `src`, both posted together (`batch_isend_irecv`), then wait.
    Either side may be None.  Nothing to do on a set of one rank.

    Every rank of the set calls this at the same points of its program,
    a rank with nothing to exchange passing None for both sides (as
    JAX's `ppermute` is collective over its axis): the set's first call
    runs `_p2p_ready` on every rank before its exchange.  On NCCL the
    wait orders the current stream after the exchange; the host goes
    on, and the buffers stay alive until the exchange is done (the
    process group holds them)."""
    if ps.comm is None:
        if send is not None and recv is not None:
            recv.copy_(send)
        return
    if not ps.p2p_ready:
        _p2p_ready(ps)
    ops, host = [], None
    if send is not None and dst is not None:
        s = send.cpu() if _staged(ps, send) else send.contiguous()
        ops.append(dist.P2POp(dist.isend, s, ps.ranks[dst], group=ps.comm))
    if recv is not None and src is not None:
        host = (torch.empty_like(recv, device="cpu")
                if _staged(ps, recv) else None)
        ops.append(dist.P2POp(dist.irecv, recv if host is None else host,
                              ps.ranks[src], group=ps.comm))
    if not ops:
        return
    works = _launch(dist.batch_isend_irecv, ops)
    _Pending(works, lambda: None).wait()
    if host is not None:
        recv.copy_(host)


# ---------------------------------------------------------------------------
# Alltoall
# ---------------------------------------------------------------------------

def _rows_as_bytes(t: torch.Tensor) -> torch.Tensor:
    """t (at least 1-D) as (dim0, row bytes) uint8, so that split sizes
    count rows and every dtype takes the same path."""
    rest = 1
    for d in t.shape[1:]:
        rest *= d
    return t.contiguous().reshape(t.shape[0], rest).view(torch.uint8)


def _alltoall_exchange_splits(splits: Sequence[int], ps: ProcessSet,
                              device) -> List[List[int]]:
    """Every rank's send splits as an (n, n) table: row s is what rank s
    sends to each rank (reference: MPIController::
    AlltoallGetRecvSplits; JAX `_alltoall_exchange_splits`)."""
    with _traced("ALLTOALL_SPLITS"):
        return _exchange_dims([int(s) for s in splits], ps, device)


def _alltoall_start(t: torch.Tensor, send: List[int], recv: List[int],
                    ps: ProcessSet, staged: Optional[int] = None,
                    name: Optional[str] = None,
                    sync: bool = False) -> _Pending:
    """One `all_to_all_single` of t's rows in its bracket: send[i] rows
    to set rank i, recv[i] rows from it.  `staged`: the bytes one rank
    stages in the JAX package's program (its payload counts those;
    default t's bytes).
    Gloo takes CUDA tensors here too (torch 2.11 on an H100, uneven
    splits included)."""
    with _traced("ALLTOALL", name) as tr:
        tr.stat(_nbytes(t) if staged is None else staged, t.dtype, ps)
        return tr.complete(_alltoall_pending(t, send, recv, ps), sync)


def _alltoall_pending(t: torch.Tensor, send: List[int], recv: List[int],
                      ps: ProcessSet) -> _Pending:
    out = torch.empty((sum(recv),) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    if ps.comm is None:
        out.copy_(t)
        return _Pending([], lambda: out)
    works = [_launch(
        dist.all_to_all_single, _rows_as_bytes(out), _rows_as_bytes(t),
        output_split_sizes=recv, input_split_sizes=send, group=ps.comm,
        async_op=True)]
    return _Pending(works, lambda: out)


def _alltoall_any_start(tensor: torch.Tensor, splits, ps: ProcessSet,
                        name: Optional[str] = None,
                        sync: bool = False) -> _Pending:
    t = tensor.detach()
    n = ps.size()
    if splits is None:
        d0 = t.shape[0] if t.dim() else 1
        if t.dim() == 0 or d0 % n:
            raise HorovodTpuError(
                f"alltoall without splits requires dim0 ({d0}) divisible "
                f"by set size ({n})")
        even = [d0 // n] * n
        return _alltoall_start(t, even, even, ps, _nbytes(t), name, sync)
    send = [int(s) for s in (splits.tolist() if isinstance(
        splits, torch.Tensor) else splits)]
    if len(send) != n:
        raise HorovodTpuError(
            f"alltoall splits must have one entry per rank ({n}), got "
            f"shape ({len(send)},)")
    d0 = t.shape[0] if t.dim() else 1
    if any(s < 0 for s in send) or sum(send) != d0:
        raise HorovodTpuError(
            f"alltoall splits must be non-negative and sum to dim0 ({d0}), "
            f"got {send}")
    table = _alltoall_exchange_splits(send, ps, t.device)
    me = ps.rank()
    recv = [int(table[s][me]) for s in range(n)]
    # JAX pads every chunk to the table's largest split (at least 1).
    maxc = max(max(row) for row in table) or 1
    moved = _alltoall_start(t, send, recv, ps, n * maxc * _row_bytes(t),
                            name, sync)
    rsplits = torch.tensor(recv, dtype=torch.int32)
    return _Pending(moved._works, lambda: (moved.wait(), rsplits))


def alltoall(tensor: torch.Tensor, splits=None, name: Optional[str] = None,
             process_set: Optional[ProcessSet] = None):
    """Send slices of `tensor`'s dim 0 to every rank (reference:
    EnqueueTensorAlltoall).  Without `splits`, dim 0 divides by the set
    size n and rank r receives the r-th chunk of every rank, in rank
    order.  With `splits` (n non-negative counts summing to dim 0): rank
    r sends splits[i] rows to rank i, and the call returns (received,
    received_splits) as the JAX package's `alltoall` does, the splits an
    int32 tensor."""
    ps = _resolve_set(process_set)
    t = tensor.detach()
    if splits is None:
        with _joinable("alltoall", [t], process_set=ps):
            return _alltoall_any_start(t, None, ps, name, sync=True).wait()
    # A joined rank mirrors with zero rows and zero splits.
    sig = [0] + list(t.shape[1:])
    with _joinable("alltoallv", [], process_set=ps,
                   extra={"shapes": [sig],
                          "dtypes": [_dtype_name(t.dtype)]}):
        return _alltoall_any_start(t, splits, ps, name, sync=True).wait()


# ---------------------------------------------------------------------------
# Reduce-scatter: any dim 0, groups
# ---------------------------------------------------------------------------

def _scatter_geometry(t: torch.Tensor, n: int):
    """(dim0, rows per rank c = ceil(dim0 / n), elements per row)."""
    if t.dim() == 0:
        raise HorovodTpuError("reducescatter needs at least one dimension")
    d0 = t.shape[0]
    rest = 1
    for d in t.shape[1:]:
        rest *= d
    return d0, -(-d0 // n) if d0 else 0, rest


def _keep_rows(d0: int, c: int, pos: int) -> int:
    """Rows of the scattered result that set rank `pos` keeps: the
    padding is cut off, so trailing ranks may keep fewer, or none."""
    return max(0, min(d0 - pos * c, c))


def _reducescatter_flat(buf: torch.Tensor, op: ReduceOp, ps: ProcessSet,
                        masked: bool) -> _Pending:
    """Reduce-scatter a flat buffer of n·w elements into this rank's w:
    Sum, or Average divided at f32 (by the active count under join
    mode)."""
    n = ps.size()
    if masked:
        buf = _masked(buf, op)
    if ps.comm is None or buf.numel() == 0:
        out = buf.clone()
        works = []
    else:
        out = torch.empty(buf.numel() // n, dtype=buf.dtype,
                          device=buf.device)
        works = [_launch(dist.reduce_scatter_tensor, out, buf.contiguous(),
                         op=dist.ReduceOp.SUM, group=ps.comm,
                         async_op=True)]
    count = None
    if masked and op is Average:
        count_works, count = _active_count(ps, buf.device)
        works += count_works

    def finish():
        if op is not Average:
            return out
        if count is None and not out.dtype.is_floating_point:
            return out.float() / n  # jnp.mean of integers: float32
        return _divide(out, n, count)

    return _Pending(works, finish)


def _check_scatter_op(op: ReduceOp) -> None:
    if op is not Sum and op is not Average:
        raise HorovodTpuError(
            f"reducescatter supports Sum and Average, got {op}")


def _reducescatter_start(tensor: torch.Tensor, op: ReduceOp,
                         ps: ProcessSet) -> _Pending:
    _check_scatter_op(op)
    t = tensor.detach()
    n = ps.size()
    d0, c, rest = _scatter_geometry(t, n)
    pos = ps.rank()
    keep = _keep_rows(d0, c, pos)
    flat = _gather_rows(t, n * c).reshape(-1) if d0 else t.reshape(-1)
    red = _reducescatter_flat(flat, op, ps, _join.armed())

    def finish():
        return red.wait().reshape((c,) + tuple(t.shape[1:]))[:keep]

    return _Pending(red._works, finish)


def _reducescatter_traced(tensor: torch.Tensor, op: ReduceOp,
                          ps: ProcessSet, name: Optional[str] = None,
                          sync: bool = False) -> _Pending:
    """One reduce-scatter in its bracket: each rank stages its tensor
    padded to n·c rows."""
    with _traced("REDUCESCATTER", name) as tr:
        pending = _reducescatter_start(tensor, op, ps)
        _, c, rest = _scatter_geometry(tensor, ps.size())
        tr.stat(ps.size() * c * rest * tensor.element_size(), tensor.dtype,
                ps)
        return tr.complete(pending, sync)


def reducescatter(tensor: torch.Tensor, op: ReduceOp = Average,
                  name: Optional[str] = None,
                  process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Reduce across the ranks and return this rank's rows of dim 0
    (JAX `reducescatter`, eager rule): dim 0 is zero-padded to n·c rows,
    c = ceil(dim0 / n), and set rank r gets rows [r·c, (r+1)·c) with
    the padding cut off, so trailing ranks may get fewer rows, or none.
    Sum and Average only; Average sums in the tensor's dtype and divides
    at f32, as `allreduce` does, except that an integer tensor's Average
    comes back in f32 (the JAX eager path's `jnp.mean`).  A flat buffer whose length divides by
    n (the ZeRO layout) gets its band [r·L/n, (r+1)·L/n).

    Every backend runs `reduce_scatter_tensor`, gloo on CUDA tensors
    included (torch 2.11 on an H100: tests/test_torch_port_cuda.py
    `test_gloo_on_card_reducescatter`)."""
    ps = _resolve_set(process_set)
    with _joinable("reducescatter", [tensor], op=op, process_set=ps):
        _check_scatter_op(op)
        return _reducescatter_traced(tensor, op, ps, name, sync=True).wait()


def _grouped_reducescatter_start(tensors: Sequence[torch.Tensor],
                                 op: ReduceOp, ps: ProcessSet) -> _Pending:
    """The JAX eager fusion: per dtype, each tensor padded to n·c_i rows
    and viewed as (n, c_i·rest_i), the views concatenated along their
    second axis, and the (n, W) buffer scattered in one collective."""
    n = ps.size()
    pos = ps.rank()
    ts = [t.detach() for t in tensors]
    geo = [_scatter_geometry(t, n) for t in ts]
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(ts):
        by_dtype.setdefault(t.dtype, []).append(i)
    buckets = []
    for idxs in by_dtype.values():
        with _traced("REDUCESCATTER") as tr:  # one per dtype, as in JAX
            fused = torch.cat([_gather_rows(ts[i], n * geo[i][1])
                               .reshape(n, -1) for i in idxs], dim=1)
            tr.stat(_nbytes(fused), fused.dtype, ps)
            buckets.append((idxs, tr.track(_reducescatter_flat(
                fused.reshape(-1), op, ps, masked=False))))

    def finish():
        out: List[Any] = [None] * len(ts)
        for idxs, pending in buckets:
            red = pending.wait()
            off = 0
            for i in idxs:
                d0, c, rest = geo[i]
                out[i] = red[off: off + c * rest].reshape(
                    (c,) + tuple(ts[i].shape[1:]))[:_keep_rows(d0, c, pos)]
                off += c * rest
        return out

    return _Pending([w for _, p in buckets for w in p._works], finish)


def grouped_reducescatter(tensors: Sequence[torch.Tensor],
                          op: ReduceOp = Average,
                          name: Optional[str] = None,
                          process_set: Optional[ProcessSet] = None
                          ) -> List[torch.Tensor]:
    """Fused reduce-scatter of a tensor group, one collective per dtype
    (JAX `grouped_reducescatter`, eager path), each tensor under
    `reducescatter`'s rule.  Under join mode each tensor is scattered
    on its own, as in the JAX package."""
    del name
    _check_scatter_op(op)
    if not tensors:
        return []
    ps = _resolve_set(process_set)
    if _join.armed():
        return [reducescatter(t, op=op, process_set=ps) for t in tensors]
    return _grouped_reducescatter_start(tensors, op, ps).wait()


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

    def drain(self) -> None:
        """Wait for every collective still in flight and drop the
        handles (`shutdown`: a process group is destroyed only with no
        work on it).  A failure here is logged, not raised: draining
        follows a failure that is already being handled, such as the
        collective error that started an elastic reset."""
        with self._lock:
            pending, self._pending = list(self._pending.values()), {}
        for p in pending:
            try:
                p.wait()
            except HorovodTpuError as e:
                logger.warning("dropped collective failed: %s", e)


def _handle(pending: _Pending) -> int:
    return HandleManager.global_instance().allocate(pending)


def _async(kind: str, tensors, start, **sig) -> int:
    """A handle over `start()`, under the collective's join bracket."""
    with _joinable(kind, tensors, **sig):
        return _handle(start())


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
    ps = _resolve_set(process_set)
    return _async("allreduce", [tensor], lambda: _allreduce_traced(
        tensor, op, prescale_factor, postscale_factor, ps, name), op=op,
        process_set=ps, prescale=prescale_factor, postscale=postscale_factor)


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
    ps = _resolve_set(process_set)
    return _async("grouped_allreduce", tensors,
                  lambda: _grouped_allreduce_start(
                      tensors, op, prescale_factor, postscale_factor, ps),
                  op=op, process_set=ps, prescale=prescale_factor,
                  postscale=postscale_factor)


def reducescatter_async(tensor: torch.Tensor, op: ReduceOp = Average,
                        name: Optional[str] = None,
                        process_set: Optional[ProcessSet] = None) -> int:
    """`reducescatter`'s handle, any dim 0 (JAX `reducescatter_async`)."""
    ps = _resolve_set(process_set)

    def start():
        _check_scatter_op(op)
        return _reducescatter_traced(tensor, op, ps, name)

    return _async("reducescatter", [tensor], start, op=op, process_set=ps)


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    """`allgather`'s handle; a ragged dim 0's sizes are exchanged before
    it returns."""
    ps = _resolve_set(process_set)
    return _async("allgather", [tensor],
                  lambda: _allgather_any_start(tensor, ps, name),
                  process_set=ps)


def grouped_allgather_async(tensors: Sequence[torch.Tensor],
                            name: Optional[str] = None,
                            process_set: Optional[ProcessSet] = None) -> int:
    """One handle for `grouped_allgather`."""
    del name
    if not tensors:
        return _handle(_Pending([], lambda: []))
    ps = _resolve_set(process_set)
    return _async("grouped_allgather", tensors,
                  lambda: _grouped_allgather_start(tensors, ps),
                  process_set=ps)


def alltoall_async(tensor: torch.Tensor, splits=None,
                   name: Optional[str] = None,
                   process_set: Optional[ProcessSet] = None) -> int:
    """`alltoall`'s handle: the received tensor, or with `splits`
    (received, received_splits).  The split table is exchanged before it
    returns."""
    ps = _resolve_set(process_set)
    t = tensor.detach()
    if splits is None:
        return _async("alltoall", [t],
                      lambda: _alltoall_any_start(t, None, ps, name),
                      process_set=ps)
    return _async("alltoallv", [],
                  lambda: _alltoall_any_start(t, splits, ps, name),
                  process_set=ps, extra={
                      "shapes": [[0] + list(t.shape[1:])],
                      "dtypes": [_dtype_name(t.dtype)]})


def broadcast_async(tensor: torch.Tensor, root_rank: int = 0,
                    name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    ps = _resolve_set(process_set)
    t = tensor.detach()
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    return _async("broadcast", [t],
                  lambda: _broadcast_start(t, root_rank, ps, out,
                                           name=name),
                  root_rank=root_rank, process_set=ps)


def broadcast_async_(tensor: torch.Tensor, root_rank: int = 0,
                     name: Optional[str] = None,
                     process_set: Optional[ProcessSet] = None) -> int:
    ps = _resolve_set(process_set)
    t = tensor.detach()
    return _async("broadcast", [t],
                  lambda: _broadcast_start(t, root_rank, ps, t,
                                           result=tensor, name=name),
                  root_rank=root_rank, process_set=ps)


def poll(handle: int) -> bool:
    """True when the handle's collective has completed."""
    return HandleManager.global_instance().poll(handle)


def synchronize(handle: int) -> Any:
    """Wait for the handle's collective and return its result."""
    return HandleManager.global_instance().release(handle)
