"""The quantized ring: collectives whose wire is a block-scaled codec of a
byte or less per element, with every sum in f32.

Counterpart of `horovod_tpu/ops/quantized.py`.  A cooperative payload
(int8, int4, fp8_e4m3, fp8_e5m2 of `ops/wire.py`) cannot be summed by the
collective itself: int8 payloads under different scales do not add, and
e4m3 partial sums overflow ±448.  So the ring runs here, over a
`ProcessSet`, in the JAX package's order:

- `quantized_allreduce_shard`: the flat f32 input is padded so that each
  of the n chunks is a whole number of blocks (chunk = ceil(L / (n·128))
  ·128).  On hop s = 0..n-2 rank i encodes chunk (i - s) % n, sends it
  to rank i + 1, and adds the decoded payload it receives into chunk
  (i - s - 1) % n.  Rank i then owns the reduced chunk (i + 1) % n,
  encodes it once more, and every rank allgathers the encoded chunks and
  decodes them (the owner too, so every rank holds the same values).
  Averaging divides after the decode; the result takes the input's
  dtype.
- `quantized_reducescatter_shard`: the reduce half with
  `psum_scatter(tiled=True)` ownership (the hop indices one lower):
  rank i returns segment i, which it accumulates itself and never
  encodes.
- `quantized_allgather_shard`: one encode per element, the payloads
  gathered and every row decoded.

`error_feedback` (f32, the input's shape) is sender-side error
feedback: the residual is added to the input, and every encode's error
(first hops, re-encoded partial sums, the owner's last encode) is kept
by the rank that encoded it, so that carried across steps the dropped
bits telescope exactly: n·out_t = Σ_r g_r + Σ_r e_{r,t} − Σ_r e_{r,t+1}.

Each hop posts its send and its receive together (`batch_isend_irecv`;
a ring of blocking sends would deadlock), payload and scales packed as
one uint8 buffer, the same bytes on every backend.  Gloo's point-to-point
ops take host buffers, so over gloo a hop of CUDA tensors stages its two
buffers through host memory; NCCL moves them on the card.  The
allgather is one `all_gather_into_tensor`.  A set of one rank exchanges
nothing: the allreduce and the reduce-scatter return the input (plus
the residual), the allgather its own decoded row.

`allreduce_model`, `reducescatter_model` and `allgather_model` compute
every rank's result of the same collectives in one process, by the same
arithmetic in the same order (and a bound on each element's distance
from the exact sum): the tests and `chip_smoke.py` hold the collectives
to them bitwise.  Nothing on the training path calls them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common.basics import ProcessSet
from . import collectives as C
from .wire import _BLOCK, WireCodec, get_codec, local_roundtrip, true_div

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Transport: payloads as bytes
# ---------------------------------------------------------------------------

def _pack(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """An encoded tuple (payload, scales) as one uint8 buffer."""
    return torch.cat([p.contiguous().view(torch.uint8).reshape(-1)
                      for p in parts])


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]
            ) -> Tuple[torch.Tensor, ...]:
    """The tuple `_pack` made, from its bytes; `like` is an encoding of
    the same length (every part's byte count is a multiple of 4, so the
    views stay aligned)."""
    out, off = [], 0
    for p in like:
        nb = p.numel() * p.element_size()
        out.append(buf[off:off + nb].view(p.dtype).reshape(p.shape))
        off += nb
    return tuple(out)


def _hop(ps: ProcessSet, send: torch.Tensor, recv: torch.Tensor) -> None:
    """One ring hop: send `send` to the next rank of the set and receive
    `recv` from the previous one, both posted together."""
    n, i = ps.size(), ps.rank()
    C.sendrecv(ps, send, (i + 1) % n, recv, (i - 1) % n)


def _gather_start(ps: ProcessSet, buf: torch.Tensor
                  ) -> Callable[[], torch.Tensor]:
    """Start an allgather of every rank's `buf` (the same byte count on
    each); returns a function that waits and gives the (n, bytes) rows."""
    n = ps.size()
    if ps.comm is None:
        return lambda: buf.reshape(1, -1)
    out = torch.empty(n * buf.numel(), dtype=torch.uint8, device=buf.device)
    work = C._launch(dist.all_gather_into_tensor, out, buf, group=ps.comm,
                     async_op=True)
    pending = C._Pending([work], lambda: out.reshape(n, -1))
    return pending.wait


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------

def _chunk(length: int, n: int) -> int:
    """Elements per ring chunk: a whole number of blocks, n of them
    covering `length`."""
    return -(-length // (n * _BLOCK)) * _BLOCK


def quantized_allreduce_shard(x: torch.Tensor,
                              process_set: Optional[ProcessSet] = None,
                              average: bool = False, wire: str = "int8",
                              error_feedback: Optional[torch.Tensor] = None):
    """Sum (or average) `x` over the set with the ring above, on `wire`
    (any registered codec: the cooperative ones, and the cast wires as
    encode = cast).  Any shape and float dtype; computes in f32 and
    returns x's dtype.  With `error_feedback` returns (result,
    new_residual)."""
    codec = get_codec(wire)
    ps = C._resolve_set(process_set)
    n, ef = ps.size(), error_feedback
    if ps.comm is None:
        if ef is not None:
            out = (x.to(_F32) + ef.to(_F32)).to(x.dtype)
            return out, torch.zeros(x.shape, dtype=_F32, device=x.device)
        return x.detach().clone()
    idx = ps.rank()
    shape, dtype = x.shape, x.dtype
    flat = x.detach().to(_F32).reshape(-1)
    if ef is not None:
        flat = flat + ef.to(_F32).reshape(-1)
    length = flat.numel()
    chunk = _chunk(length, n)
    acc = flat.new_zeros(n * chunk)
    acc[:length] = flat
    acc = acc.reshape(n, chunk)
    resid = torch.zeros_like(acc) if ef is not None else None
    for s in range(n - 1):
        send_idx = (idx - s) % n
        v = acc[send_idx]
        enc = codec.encode(v)
        if resid is not None:
            resid[send_idx] = v - codec.decode(enc)
        sbuf = _pack(enc)
        rbuf = torch.empty_like(sbuf)
        _hop(ps, sbuf, rbuf)
        recv_idx = (idx - s - 1) % n
        acc[recv_idx] = acc[recv_idx] + codec.decode(_unpack(rbuf, enc))
    own_idx = (idx + 1) % n
    own = acc[own_idx]
    payload = codec.encode(own)
    if resid is not None:
        resid[own_idx] = own - codec.decode(payload)
    rows = _gather_start(ps, _pack(payload))()
    out = torch.empty_like(acc)
    for c in range(n):
        # Chunk c was reduced by rank (c - 1) % n.
        out[c] = codec.decode(_unpack(rows[(c - 1) % n], payload))
    out = out.reshape(-1)[:length].reshape(shape)
    if average:
        out = true_div(out, n)
    out = out.to(dtype)
    if ef is not None:
        return out, resid.reshape(-1)[:length].reshape(shape)
    return out


def quantized_reducescatter_shard(x: torch.Tensor,
                                  process_set: Optional[ProcessSet] = None,
                                  average: bool = False, wire: str = "int8",
                                  error_feedback: Optional[
                                      torch.Tensor] = None):
    """Ring reduce-scatter: `x` flat, its length a multiple of the set
    size n; rank i returns the sum (or mean) of segment i in x's dtype.
    Each rank's own segment is accumulated where it lies and never
    encoded (n - 1 lossy hops per segment).  With `error_feedback`
    returns (segment, new_residual), the residual of x's shape (the rows
    this rank never encodes stay zero)."""
    codec = get_codec(wire)
    ps = C._resolve_set(process_set)
    n, ef = ps.size(), error_feedback
    if x.dim() != 1 or x.numel() % n:
        raise ValueError(
            f"quantized_reducescatter_shard needs a flat buffer divisible "
            f"by the set size ({n}); got shape {tuple(x.shape)}")
    seg = x.numel() // n
    if ps.comm is None:
        out = x.detach().to(_F32)
        if ef is not None:
            out = out + ef.to(_F32)
            return out.to(x.dtype), torch.zeros(x.shape, dtype=_F32,
                                                device=x.device)
        return out.to(x.dtype)
    idx = ps.rank()
    chunk = -(-seg // _BLOCK) * _BLOCK
    rows_in = x.detach().to(_F32).reshape(n, seg)
    if ef is not None:
        rows_in = rows_in + ef.to(_F32).reshape(n, seg)
    acc = rows_in.new_zeros(n, chunk)
    acc[:, :seg] = rows_in
    resid = torch.zeros_like(acc) if ef is not None else None
    for s in range(n - 1):
        # One lower than the allreduce's indices, so that rank i ends up
        # owning chunk i.
        send_idx = (idx - s - 1) % n
        v = acc[send_idx]
        enc = codec.encode(v)
        if resid is not None:
            resid[send_idx] = v - codec.decode(enc)
        sbuf = _pack(enc)
        rbuf = torch.empty_like(sbuf)
        _hop(ps, sbuf, rbuf)
        recv_idx = (idx - s - 2) % n
        acc[recv_idx] = acc[recv_idx] + codec.decode(_unpack(rbuf, enc))
    own = acc[idx][:seg]
    if average:
        own = true_div(own, n)
    own = own.to(x.dtype)
    if ef is not None:
        return own, resid[:, :seg].reshape(-1)
    return own


def allgather_start(x: torch.Tensor, process_set: Optional[ProcessSet],
                    codec: WireCodec) -> Callable[[], torch.Tensor]:
    """Start `quantized_allgather_shard` of a flat shard on a non-exact
    codec: encode now, gather in flight; the returned function waits and
    gives the decoded (n, size) rows in x's dtype."""
    ps = C._resolve_set(process_set)
    if x.dim() != 1:
        raise ValueError(
            f"quantized_allgather_shard needs a flat shard; got shape "
            f"{tuple(x.shape)}")
    size = x.numel()
    flat = x.detach().to(_F32)
    padded = flat.new_zeros(size + (-size) % _BLOCK)
    padded[:size] = flat
    payload = codec.encode(padded)
    wait = _gather_start(ps, _pack(payload))

    def finish() -> torch.Tensor:
        rows = wait()
        out = torch.stack([codec.decode(_unpack(row, payload))
                           for row in rows])
        return out[:, :size].to(x.dtype)

    return finish


def quantized_allgather_shard(x: torch.Tensor,
                              process_set: Optional[ProcessSet] = None,
                              wire: str = "int8") -> torch.Tensor:
    """Allgather a flat shard at wire width: one encode, the payloads
    gathered, every row decoded in f32 (the owner's too); rank r's shard
    lands at segment r of the flat result, in x's dtype.  Nothing
    accumulates through the wire, which is why the ZeRO parameter gathers
    can ride a 1-byte format while the f32 masters stay exact."""
    codec = get_codec(wire)
    if codec.exact:
        ps = C._resolve_set(process_set)
        if x.dim() != 1:
            raise ValueError(
                f"quantized_allgather_shard needs a flat shard; got shape "
                f"{tuple(x.shape)}")
        return C._allgather_start(x, ps).wait().reshape(-1)
    return allgather_start(x, process_set, codec)().reshape(-1)


# ---------------------------------------------------------------------------
# The plain single-process model of the ring
# ---------------------------------------------------------------------------

def _half_step(codec: WireCodec, v: torch.Tensor) -> torch.Tensor:
    """Per element of v (flat f32, whole blocks), the most one encode of
    v can move it: half a quantization step of its block (int8 and int4:
    half the block scale; fp8: half the spacing of the [1/2, 1) binade,
    2^-5 (e4m3) or 2^-4 (e5m2) of the block's max-abs), or half an ulp
    of a cast."""
    if codec.exact:
        return torch.zeros_like(v)
    if codec.cast_dtype is not None:
        return v.abs() * (torch.finfo(codec.cast_dtype).eps / 2)
    blocks = v.reshape(-1, _BLOCK)
    top = blocks.abs().amax(dim=1)
    factor = {"int8": 0.5 / 127, "int4": 0.5 / 7, "fp8_e4m3": 2.0 ** -5,
              "fp8_e5m2": 2.0 ** -4}[codec.name]
    return (top * factor)[:, None].expand_as(blocks).reshape(-1)


def allreduce_model(xs: Sequence[torch.Tensor], average: bool = False,
                    wire: str = "int8",
                    error_feedback: Optional[Sequence[torch.Tensor]] = None):
    """Every rank's result of `quantized_allreduce_shard` over n = len(xs)
    ranks, rank r's input xs[r] (and residual error_feedback[r]), by the
    same arithmetic: returns (outs, residuals or None, bound), `bound`
    (x's shape, f32) the sum over the encodes each element went through
    of their `_half_step` (divided by n when averaging): the ring's
    distance from the exact sum, up to the f32 adds' rounding."""
    codec = get_codec(wire)
    n = len(xs)
    shape, dtype = xs[0].shape, xs[0].dtype
    flats = [x.detach().to(_F32).reshape(-1) for x in xs]
    if error_feedback is not None:
        flats = [f + e.to(_F32).reshape(-1)
                 for f, e in zip(flats, error_feedback)]
    length = flats[0].numel()
    if n == 1:
        out = flats[0].reshape(shape).to(dtype)
        zero = torch.zeros(shape, dtype=_F32, device=out.device)
        return [out], ([zero] if error_feedback is not None else None), zero
    chunk = _chunk(length, n)
    acc, bnd = [], []
    for f in flats:
        a = f.new_zeros(n * chunk)
        a[:length] = f
        acc.append(a.reshape(n, chunk))
        bnd.append(torch.zeros_like(acc[-1]))
    resid = [torch.zeros_like(a) for a in acc]
    for s in range(n - 1):
        sent = []
        for i in range(n):
            c = (i - s) % n
            v = acc[i][c]
            enc = codec.encode(v)
            resid[i][c] = v - codec.decode(enc)
            sent.append((codec.decode(enc), bnd[i][c] + _half_step(codec, v)))
        for i in range(n):
            dec, b = sent[(i - 1) % n]
            c = (i - s - 1) % n
            acc[i][c] = acc[i][c] + dec
            bnd[i][c] = bnd[i][c] + b
    out = acc[0].new_empty(n, chunk)
    bound = torch.empty_like(out)
    for c in range(n):
        owner = (c - 1) % n
        own = acc[owner][c]
        payload = codec.encode(own)
        resid[owner][c] = own - codec.decode(payload)
        out[c] = codec.decode(payload)
        bound[c] = bnd[owner][c] + _half_step(codec, own)
    out = out.reshape(-1)[:length].reshape(shape)
    bound = bound.reshape(-1)[:length].reshape(shape)
    if average:
        out = true_div(out, n)
        bound = bound / n
    out = out.to(dtype)
    res = ([r.reshape(-1)[:length].reshape(shape) for r in resid]
           if error_feedback is not None else None)
    return [out.clone() for _ in range(n)], res, bound


def reducescatter_model(xs: Sequence[torch.Tensor], average: bool = False,
                        wire: str = "int8",
                        error_feedback: Optional[
                            Sequence[torch.Tensor]] = None):
    """Every rank's result of `quantized_reducescatter_shard` (flat
    inputs of a length divisible by n): returns (segments, residuals or
    None, bound), `bound` the flat (n·seg) bound as in
    `allreduce_model`."""
    codec = get_codec(wire)
    n = len(xs)
    seg = xs[0].numel() // n
    dtype = xs[0].dtype
    rows_in = [x.detach().to(_F32).reshape(n, seg) for x in xs]
    if error_feedback is not None:
        rows_in = [r + e.to(_F32).reshape(n, seg)
                   for r, e in zip(rows_in, error_feedback)]
    if n == 1:
        out = rows_in[0].reshape(-1).to(dtype)
        zero = torch.zeros(seg, dtype=_F32, device=out.device)
        return [out], ([zero] if error_feedback is not None else None), zero
    chunk = -(-seg // _BLOCK) * _BLOCK
    acc, bnd = [], []
    for r in rows_in:
        a = r.new_zeros(n, chunk)
        a[:, :seg] = r
        acc.append(a)
        bnd.append(torch.zeros_like(a))
    resid = [torch.zeros_like(a) for a in acc]
    for s in range(n - 1):
        sent = []
        for i in range(n):
            c = (i - s - 1) % n
            v = acc[i][c]
            enc = codec.encode(v)
            resid[i][c] = v - codec.decode(enc)
            sent.append((codec.decode(enc), bnd[i][c] + _half_step(codec, v)))
        for i in range(n):
            dec, b = sent[(i - 1) % n]
            c = (i - s - 2) % n
            acc[i][c] = acc[i][c] + dec
            bnd[i][c] = bnd[i][c] + b
    outs = []
    for i in range(n):
        own = acc[i][i][:seg]
        outs.append((true_div(own, n) if average else own).to(dtype))
    bound = torch.cat([bnd[i][i][:seg] for i in range(n)])
    if average:
        bound = bound / n
    res = ([r[:, :seg].reshape(-1) for r in resid]
           if error_feedback is not None else None)
    return outs, res, bound


def allgather_model(xs: Sequence[torch.Tensor], wire: str = "int8"
                    ) -> torch.Tensor:
    """The flat result `quantized_allgather_shard` gives every rank for
    the shards xs (rank-major; each shard's encode → decode)."""
    codec = get_codec(wire)
    if codec.exact:
        return torch.cat([x.reshape(-1) for x in xs])
    return torch.cat([local_roundtrip(x.reshape(-1), codec.name)
                      .to(x.dtype) for x in xs])


__all__ = [
    "allgather_model",
    "allreduce_model",
    "quantized_allgather_shard",
    "quantized_allreduce_shard",
    "quantized_reducescatter_shard",
    "reducescatter_model",
]
