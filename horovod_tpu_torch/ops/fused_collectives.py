"""The fused computation-collective pipeline: collectives cut into chunks
that are in flight while the next chunk is packed or computed.

Counterpart of `horovod_tpu/ops/fused_collectives.py`.  The JAX package
lets XLA schedule independent chunk chains inside one program; here each
chunk's collective is issued at once as an async `torch.distributed`
`Work`, so chunk j's transfer runs while chunk j+1 is packed (or, in
the fused matmuls, computed), and the works are waited for in order.

- `pipelined_grouped_allreduce`, `pipelined_psum_scatter` and
  `pipelined_allgather_shard`: the bucket collectives in
  `fused_chunk_bytes` chunks.  Each chunk keeps its elements' rank
  ownership and the sum is elementwise.  A gather moves bytes, and a sum
  of two ranks' terms is the same in either order, so at two ranks every
  result is bitwise equal to the unchunked collective.  With more ranks
  the backend may add an element's terms in an order set by its place in
  the buffer (gloo's ring allreduce does, tests/test_torch_port_zero.py),
  and then a chunked result agrees with the unchunked one to the sum's
  rounding; XLA's, in the JAX package, is bitwise.
- `fused_allgather_matmul`: the ZeRO-3 weight gather fused with the
  matmul that consumes it (`gather_matmul`, the transformer's tied head);
  `fused_matmul_reduce_scatter`: a matmul whose output columns are
  reduce-scattered chunk by chunk.  Their chunk products run K3
  (`ops/matmul_kernels.tiled_matmul`) when HOROVOD_FUSED_PALLAS=1 and
  the operands hold at least 128² elements, else `torch.matmul` (the
  dot the JAX package leaves to XLA).

Armed by HOROVOD_FUSED_COLLECTIVES=1 (`fused_enabled`), sized by
HOROVOD_FUSED_CHUNK_BYTES.  A set of one rank exchanges nothing
(`ProcessSet.comm`): its scatter and gather are one copy each.  A cast wire's cast belongs to the caller, as
in the JAX package; the cooperative codecs and the quantized ring
(`pipelined_allreduce_shard`) are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common import util
from ..common.basics import ProcessSet
from ..common.exceptions import HorovodTpuError
from . import collectives as C
from .matmul_kernels import tiled_matmul
from .wire import _BLOCK, get_codec

_LANES = 128  # the JAX package's Pallas threshold: 128² elements


def fused_enabled() -> bool:
    """Whether the fused pipeline is armed (HOROVOD_FUSED_COLLECTIVES=1).
    Read at each call."""
    return util.fused_collectives()


def fused_pallas_enabled(n_elements: int) -> bool:
    """Whether a fused matmul chunk runs K3 (HOROVOD_FUSED_PALLAS=1)
    rather than `torch.matmul`: opt-in, and only for operands of at
    least 128² elements, as in the JAX package."""
    return n_elements >= _LANES * _LANES and util.fused_pallas()


def plan_chunks(n_elements: int, itemsize: int,
                chunk_bytes: Optional[int] = None,
                align: int = _BLOCK) -> List[Tuple[int, int]]:
    """The pipeline schedule `[(offset, length), ...]` covering a flat
    n-element buffer in `chunk_bytes` pieces (default: the live
    HOROVOD_FUSED_CHUNK_BYTES).  Every offset is a multiple of `align`."""
    if n_elements <= 0:
        return [(0, max(0, n_elements))]
    if chunk_bytes is None:
        from ..utils.autotune import current_fused_chunk_bytes
        chunk_bytes = current_fused_chunk_bytes()
    per = max(1, int(chunk_bytes) // max(1, int(itemsize)))
    per = max(align, (per // align) * align)
    out = []
    off = 0
    while off < n_elements:
        w = min(per, n_elements - off)
        out.append((off, w))
        off += w
    return out


def _resolve(process_set: Optional[ProcessSet]) -> ProcessSet:
    return C._resolve_set(process_set)


def _wait(works) -> None:
    """Wait for chunk collectives; a failure of the process group is
    HorovodInternalError, as in `ops/collectives.py`."""
    C._Pending(works, lambda: None).wait()


# ---------------------------------------------------------------------------
# Chunked bucket collectives
# ---------------------------------------------------------------------------

def pipelined_grouped_allreduce(tensors: Sequence[torch.Tensor],
                                op=None,
                                process_set: Optional[ProcessSet] = None,
                                chunk_bytes: Optional[int] = None
                                ) -> List[torch.Tensor]:
    """`grouped_allreduce` in chunks: the same fused buffer per dtype (in
    order of first appearance), packed chunk by chunk, each chunk's
    allreduce issued as soon as it is packed.  Equal to the unchunked
    grouped collective (bitwise at two ranks; see the module
    docstring)."""
    op = C.Average if op is None else op
    if op.name not in C._WIRE_OPS:
        raise HorovodTpuError(
            f"pipelined_grouped_allreduce supports "
            f"{', '.join(C._WIRE_OPS)}, got {op}")
    if not tensors:
        return []
    ps = _resolve(process_set)
    n = ps.size()
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    pending = []
    for dt, idxs in by_dtype.items():
        flats = [tensors[i].detach().reshape(-1) for i in idxs]
        starts, total = [], 0
        for f in flats:
            starts.append(total)
            total += f.numel()
        buf = torch.empty(total, dtype=dt, device=flats[0].device)
        works = []
        for off, w in plan_chunks(total, buf.element_size(),
                                  chunk_bytes=chunk_bytes):
            for f, s in zip(flats, starts):
                lo, hi = max(off, s), min(off + w, s + f.numel())
                if lo < hi:
                    buf[lo:hi].copy_(f[lo - s:hi - s])
            if ps.comm is not None:
                works.append(C._launch(
                    dist.all_reduce, buf[off:off + w],
                    op=C._WIRE_OPS[op.name], group=ps.comm, async_op=True))
        pending.append((idxs, buf, works))
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idxs, buf, works in pending:
        _wait(works)
        if op is C.Average:
            buf = (buf.float() / n).to(buf.dtype)
        off = 0
        for i in idxs:
            sz = tensors[i].numel()
            out[i] = buf[off:off + sz].reshape(tensors[i].shape)
            off += sz
    return out


def pipelined_psum_scatter(flat: torch.Tensor,
                           process_set: Optional[ProcessSet] = None,
                           chunk_bytes: Optional[int] = None
                           ) -> torch.Tensor:
    """Chunked reduce-scatter (a sum) of a flat buffer whose length
    divides by the set size n: the buffer is viewed as (n, shard) bands,
    and each chunk of the shard dimension is packed from every band and
    scattered on its own.  Returns this rank's (shard,) sum, equal to one
    `reduce_scatter_tensor` of the whole buffer (bitwise at two ranks;
    see the module docstring)."""
    ps = _resolve(process_set)
    n = ps.size()
    if flat.dim() != 1 or flat.numel() % n:
        raise HorovodTpuError(
            f"pipelined_psum_scatter needs a flat buffer divisible by the "
            f"set size ({n}); got shape {tuple(flat.shape)}")
    if ps.comm is None:
        return flat.detach().clone()  # one rank: the sum is the buffer
    shard = flat.numel() // n
    band = flat.detach().reshape(n, shard)
    out = torch.empty(shard, dtype=flat.dtype, device=flat.device)
    works, keep = [], []
    for off, w in plan_chunks(shard, flat.element_size(),
                              chunk_bytes=chunk_bytes):
        send = band[:, off:off + w].contiguous().reshape(-1)
        keep.append(send)
        works.append(C._launch(
            dist.reduce_scatter_tensor, out[off:off + w], send,
            op=dist.ReduceOp.SUM, group=ps.comm, async_op=True))
    _wait(works)
    return out


def pipelined_allgather_shard(shard: torch.Tensor,
                              process_set: Optional[ProcessSet] = None,
                              wire: Optional[str] = None,
                              chunk_bytes: Optional[int] = None,
                              stacked: bool = False,
                              out: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Chunked allgather of a flat local shard, every chunk in flight at
    once and unpacked in order.  Returns the rank-major flat gather, or
    the (n, shard) stacked view with `stacked=True`; `out` (n·shard
    elements of the shard's dtype, contiguous) receives it when given.
    Gathers move bytes, so the result is bitwise the unchunked gather.
    `wire` is resolved (a cooperative codec raises); a cast wire's cast
    is the caller's."""
    get_codec(wire)
    if shard.dim() != 1:
        raise HorovodTpuError(
            f"pipelined_allgather_shard needs a flat shard; got shape "
            f"{tuple(shard.shape)}")
    ps = _resolve(process_set)
    n = ps.size()
    s = shard.detach()
    band = (out.view(n, s.numel()) if out is not None else
            torch.empty((n, s.numel()), dtype=s.dtype, device=s.device))
    if ps.comm is None:
        band[0].copy_(s)
        return band if stacked else band.reshape(-1)
    chunks = []
    for off, w in plan_chunks(s.numel(), s.element_size(),
                              chunk_bytes=chunk_bytes):
        seg = C._as_bytes(s[off:off + w])
        got = torch.empty(n * seg.numel(), dtype=torch.uint8,
                          device=s.device)
        chunks.append((off, w, got, C._launch(
            dist.all_gather_into_tensor, got, seg, group=ps.comm,
            async_op=True)))
    for off, w, got, work in chunks:
        _wait([work])
        band[:, off:off + w] = got.view(s.dtype).view(n, w)
    return band if stacked else band.reshape(-1)


# ---------------------------------------------------------------------------
# The fused matmuls
# ---------------------------------------------------------------------------

def _chunk_matmul(a: torch.Tensor, b: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused chunk's product: K3 when `fused_pallas_enabled`, else
    `torch.matmul`.  Writes into `out` when given."""
    if fused_pallas_enabled(a.numel() + b.numel()):
        return tiled_matmul(a, b, out=out)
    prod = torch.matmul(a, b)
    return prod if out is None else out.copy_(prod)


def fused_matmul_reduce_scatter(a: torch.Tensor, b: torch.Tensor,
                                average: bool = False,
                                process_set: Optional[ProcessSet] = None,
                                chunk_bytes: Optional[int] = None
                                ) -> torch.Tensor:
    """Reduce-scatter of `a @ b` over dim 0, the product's column chunks
    scattered as each is computed: a (M, K) with M divisible by the set
    size n, b (K, N).  Returns this rank's (M/n, N) row band of the sum
    (of the mean with `average`), elementwise equal to scattering the
    whole product."""
    ps = _resolve(process_set)
    n = ps.size()
    (m, _), cols = a.shape, b.shape[1]
    if m % n:
        raise HorovodTpuError(
            f"fused_matmul_reduce_scatter needs the output rows ({m}) "
            f"divisible by the set size ({n})")
    out = torch.empty((m // n, cols), dtype=a.dtype, device=a.device)
    pending = []
    for off, w in plan_chunks(cols, max(1, m * a.element_size()),
                              chunk_bytes=chunk_bytes, align=1):
        partial = _chunk_matmul(a, b[:, off:off + w])
        if ps.comm is None:
            out[:, off:off + w] = partial
            continue
        recv = torch.empty((m // n, w), dtype=a.dtype, device=a.device)
        pending.append((off, w, recv, partial, C._launch(
            dist.reduce_scatter_tensor, recv, partial.contiguous(),
            op=dist.ReduceOp.SUM, group=ps.comm, async_op=True)))
    for off, w, recv, _, work in pending:
        _wait([work])
        out[:, off:off + w] = recv
    return out / n if average else out


def fused_allgather_matmul(x: torch.Tensor, w_shard: torch.Tensor,
                           process_set: Optional[ProcessSet] = None,
                           chunk_bytes: Optional[int] = None,
                           wire: Optional[str] = None) -> torch.Tensor:
    """`x @ allgather(w_shard)ᵀ` with the gather still in flight: the
    local (S, K) weight shard gathers in row chunks, all issued at once,
    and each gathered (n, w, K) band is multiplied as soon as it has
    arrived, while the later chunks are still on the wire.

    Returns (B, n·S): columns r·S..(r+1)·S hold x @ rank r's rows, in x's
    dtype; each chunk product is written into its columns in place."""
    get_codec(wire)
    ps = _resolve(process_set)
    n = ps.size()
    s, k = w_shard.shape
    out = torch.empty((x.shape[0], n * s), dtype=x.dtype, device=x.device)
    ws = w_shard.detach()
    chunks = []
    for off, w in plan_chunks(s, max(1, k * ws.element_size()),
                              chunk_bytes=chunk_bytes, align=1):
        seg = ws[off:off + w]
        if ps.comm is None:
            chunks.append((off, w, seg.reshape(1, w, k), None))
            continue
        got = torch.empty(n * w * k * ws.element_size(), dtype=torch.uint8,
                          device=ws.device)
        chunks.append((off, w, got, C._launch(
            dist.all_gather_into_tensor, got, C._as_bytes(seg),
            group=ps.comm, async_op=True)))
    for off, w, got, work in chunks:
        if work is not None:
            _wait([work])
            got = got.view(ws.dtype).view(n, w, k)
        for r in range(n):
            _chunk_matmul(x, got[r].t(),
                          out=out[:, r * s + off:r * s + off + w])
    return out


__all__ = [
    "fused_allgather_matmul",
    "fused_enabled",
    "fused_matmul_reduce_scatter",
    "fused_pallas_enabled",
    "pipelined_allgather_shard",
    "pipelined_grouped_allreduce",
    "pipelined_psum_scatter",
    "plan_chunks",
]
