"""The wire-format registry: how a buffer travels through a collective.

Counterpart of `horovod_tpu/ops/wire.py`.  Every wire the port speaks
(the quantized ring of `ops/quantized.py`, the cast compressors of
`ops/compression.py`, the ZeRO reduce-scatter and allgathers, the
per-bucket wire policy) resolves its name here, and an unknown name
fails in one place (`get_codec`).

- ``none``: the exact wire.
- Cast wires (``fp16``, ``bf16``): `cast_dtype` is set; a sum, a
  reduce-scatter or an allgather rides the cast dtype directly.
- Cooperative wires (``int8``, ``int4``, ``fp8_e4m3``, ``fp8_e5m2``):
  block-scaled payloads of a byte or less per element that cannot be a
  cast before the collective (int8 payloads under different scales do
  not sum, e4m3 saturates at ±448), so a collective encodes, moves the
  payload, decodes and accumulates in f32 (the ring of
  `ops/quantized.py`).  Every cooperative codec ships one f32 max-abs
  scale per `_BLOCK` = 128 elements; ``int4`` packs two 4-bit
  two's-complement values per byte (element 2k in the low nibble, 2k+1
  in the high one).  fp8 maps to `torch.float8_e4m3fn` and
  `torch.float8_e5m2`.

The codecs are elementwise torch ops, bitwise the JAX package's on the
CPU (`jnp.round` and `torch.round` both round half to even) where torch
and XLA convert alike, and made to agree where the values would differ:
a NaN that the int8 / int4 cast meets becomes 0 (a C cast of NaN is
undefined), and a subnormal block scale is flushed as XLA flushes it.
A NaN is left with the code torch writes: the fp8 payload and the
decoded f32 NaN may carry other sign and payload bits than XLA's.  In a
block that holds a NaN the values reach the e4m3 cast unnormalised;
torch's cast saturates those past 464 (and ±inf) at ±448 where XLA's
writes NaN, so the encode writes NaN there first.  (XLA's CPU also reads
subnormal inputs as zero; a block that mixes them with a normal maximum
may differ.)

Also here: the per-bucket `WirePolicy` (HOROVOD_WIRE_POLICY: "exact",
"auto", or ``big=int4,small=none,threshold=1048576``), the host codec of
a reshard chunk (`host_encode` / `host_decode`, byte-compatible with the
JAX package's), and the error-feedback reset protocol
(`reset_error_feedback`, called by the elastic reset).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..common import util
from ..common.exceptions import HorovodTpuError

#: Quantization block (elements) of the block-scaled codecs; one f32
#: scale ships per block, and the fused pipeline aligns its chunks to it.
_BLOCK = 128


# ---------------------------------------------------------------------------
# Codec primitives (flat f32 of a length that is a multiple of _BLOCK)
# ---------------------------------------------------------------------------

_TINY = torch.finfo(torch.float32).tiny


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, rounded once as IEEE division rounds it.  (On the card
    torch divides by a Python number as a product with its reciprocal,
    which can round apart by an ulp; a divisor tensor on x's device is
    divided.)"""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _block_scale(blocks: torch.Tensor, levels: float) -> torch.Tensor:
    """Per-block max-abs / levels; 1.0 where that is not a normal
    positive number: all-zero blocks, NaN ones (the max of a NaN block
    is NaN), and a subnormal scale, which XLA flushes to zero."""
    scale = true_div(blocks.abs().amax(dim=1), levels)
    return torch.where(scale >= _TINY, scale, torch.ones_like(scale))


def _round_to_int8(q: torch.Tensor) -> torch.Tensor:
    """Rounded, clipped f32 levels to int8; NaN becomes 0 (XLA's
    conversion; a C cast of NaN is undefined)."""
    return torch.where(torch.isnan(q), torch.zeros_like(q), q).to(torch.int8)


def _quant(v: torch.Tensor):
    """v: (L,) f32 → (q int8 (L,), scales f32 (L / _BLOCK,))."""
    blocks = v.reshape(-1, _BLOCK)
    scale = _block_scale(blocks, 127.0)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return _round_to_int8(q).reshape(-1), scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    blocks = q.to(torch.float32).reshape(-1, _BLOCK)
    return (blocks * scale[:, None]).reshape(-1)


def _int4_encode(v: torch.Tensor):
    """Nibble-packed int4: block max-abs scales over ±7 levels, two 4-bit
    two's-complement values per uint8 byte (element 2k low, 2k+1 high)."""
    blocks = v.reshape(-1, _BLOCK)
    scale = _block_scale(blocks, 7.0)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -7, 7)
    u = _round_to_int8(q).reshape(-1).to(torch.uint8) & 0xF
    return u[0::2] | (u[1::2] << 4), scale


def _int4_decode(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return _dequant(torch.stack([lo, hi], dim=1).reshape(-1), scale)


def _fp8_encode(v: torch.Tensor, dt: torch.dtype):
    """Block-normalised fp8: each block divided by its max-abs, so the
    payload lies in [-1, 1] and a later hop's partial sum, encoded with
    its own scale, never overflows e4m3's ±448.  (A block holding a NaN
    keeps the scale 1, so its other values reach the cast unnormalised.
    torch's e4m3 cast saturates those past 464 and ±inf at ±448, where
    XLA's convert writes NaN: they are made NaN before the cast.  Only
    such a block can hold them, since every other block is normalised
    into [-1, 1] or is all zero.)"""
    blocks = v.reshape(-1, _BLOCK)
    scale = _block_scale(blocks, 1.0)
    x = (blocks / scale[:, None]).reshape(-1)
    if dt == torch.float8_e4m3fn:
        x = torch.where(x.abs() > 464.0,
                        torch.full((), float("nan"), device=x.device), x)
    return x.to(dt), scale


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WireCodec:
    """One wire format: `encode` maps a flat f32 tensor (a multiple of
    _BLOCK long) to a tuple of wire tensors (payload first, then the
    scales); `decode` inverts it to f32.  `payload_bits` is the bits per
    element without the scales (`wire_nbytes` counts both).  `cast_dtype`
    is set for the cast wires only."""

    name: str
    payload_bits: int
    encode: Callable[[torch.Tensor], Tuple[torch.Tensor, ...]]
    decode: Callable[[Tuple[torch.Tensor, ...]], torch.Tensor]
    cast_dtype: Optional[torch.dtype] = None

    @property
    def exact(self) -> bool:
        return self.name == "none"

    @property
    def cooperative(self) -> bool:
        """True for the formats that need f32 accumulation around the
        wire (the ring); False for none and the cast wires."""
        return self.cast_dtype is None and not self.exact

    def scale_bytes(self, n_elements: int) -> int:
        """The f32 scales' bytes for an n-element payload."""
        if not self.cooperative:
            return 0
        return 4 * (-(-n_elements // _BLOCK))

    def wire_nbytes(self, n_elements: int) -> int:
        """Wire bytes of n elements: payload and scales."""
        return (n_elements * self.payload_bits + 7) // 8 \
            + self.scale_bytes(n_elements)


_REGISTRY: Dict[str, WireCodec] = {}


def _register(codec: WireCodec) -> WireCodec:
    _REGISTRY[codec.name] = codec
    return codec


def _cast_codec(name: str, dt: torch.dtype) -> WireCodec:
    return WireCodec(
        name=name, payload_bits=16, cast_dtype=dt,
        encode=lambda v, _dt=dt: (v.to(_dt),),
        decode=lambda p: p[0].to(torch.float32))


NONE = _register(WireCodec(
    name="none", payload_bits=32,
    encode=lambda v: (v,), decode=lambda p: p[0]))
FP16 = _register(_cast_codec("fp16", torch.float16))
BF16 = _register(_cast_codec("bf16", torch.bfloat16))
INT8 = _register(WireCodec(
    name="int8", payload_bits=8,
    encode=_quant, decode=lambda p: _dequant(*p)))
INT4 = _register(WireCodec(
    name="int4", payload_bits=4,
    encode=_int4_encode, decode=lambda p: _int4_decode(*p)))
FP8_E4M3 = _register(WireCodec(
    name="fp8_e4m3", payload_bits=8,
    encode=lambda v: _fp8_encode(v, torch.float8_e4m3fn),
    decode=lambda p: _dequant(*p)))
FP8_E5M2 = _register(WireCodec(
    name="fp8_e5m2", payload_bits=8,
    encode=lambda v: _fp8_encode(v, torch.float8_e5m2),
    decode=lambda p: _dequant(*p)))


def wire_names() -> Tuple[str, ...]:
    """Every registered codec name, sorted."""
    return tuple(sorted(_REGISTRY))


def cast_wire_names() -> Tuple[str, ...]:
    """The cast wires: formats a sum or a reduce-scatter can ride
    directly."""
    return tuple(sorted(n for n, c in _REGISTRY.items()
                        if c.cast_dtype is not None))


def get_codec(wire: Optional[str]) -> WireCodec:
    """Resolve a wire-format string; None (and "none") is the exact
    codec.  Raises `HorovodTpuError` naming the valid formats for an
    unknown name: the one failure path every consumer shares."""
    if wire is None:
        return NONE
    codec = _REGISTRY.get(wire)
    if codec is None:
        raise HorovodTpuError(
            f"unknown wire format {wire!r}: valid formats are "
            f"{', '.join(wire_names())} (see docs/WIRE.md)")
    return codec


def compressor_wire(compression) -> str:
    """The wire name a Compressor class speaks (its `wire` attribute),
    checked against the registry; a compressor without one is an opaque
    transform on the exact wire."""
    name = getattr(compression, "wire", None)
    if name is None:
        return "none"
    return get_codec(name).name


# ---------------------------------------------------------------------------
# Host codec of a reshard chunk (numpy bytes)
# ---------------------------------------------------------------------------

def _as_numpy(chunk) -> np.ndarray:
    if isinstance(chunk, torch.Tensor):
        chunk = chunk.detach().cpu()
        if chunk.dtype == torch.bfloat16:
            chunk = chunk.float()
        chunk = chunk.numpy()
    return np.ascontiguousarray(chunk)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 → bf16 bit patterns (uint16), rounded to nearest even; a NaN
    keeps its sign and upper bits, made quiet (the JAX package's
    bfloat16 conversion)."""
    bits = x.view(np.uint32)
    rounded = (bits + (0x7FFF + ((bits >> 16) & 1))) >> 16
    quiet = (bits >> 16) | 0x40
    return np.where(np.isnan(x), quiet, rounded).astype(np.uint16)


def host_encode(chunk, wire: Optional[str]) -> bytes:
    """Host-side wire encode of one reshard chunk (a numpy array or a
    tensor): exact → its raw bytes, cast wires → the cast dtype's bytes
    (bf16 as the JAX package writes it: the upper half of an f32, rounded
    to nearest even).  Cooperative codecs are refused: a lossy reshard
    wire would break the bitwise reshard-vs-restore contract."""
    codec = get_codec(wire)
    arr = _as_numpy(chunk)
    if codec.exact:
        return arr.tobytes()
    if codec.cast_dtype is None:
        raise HorovodTpuError(
            f"HOROVOD_RESHARD_WIRE={codec.name!r} is a cooperative "
            "codec; the host-side reshard transport supports the exact "
            f"wire and the cast wires ({', '.join(cast_wire_names())})")
    if codec.cast_dtype == torch.float16:
        return arr.astype(np.float16).tobytes()
    return _bf16_bits(arr.astype(np.float32)).tobytes()


def host_decode(buf: bytes, dtype, wire: Optional[str]) -> np.ndarray:
    """Inverse of `host_encode`: bytes → numpy array of `dtype`."""
    codec = get_codec(wire)
    if codec.exact:
        return np.frombuffer(buf, dtype=np.dtype(dtype)).copy()
    if codec.cast_dtype is None:
        raise HorovodTpuError(
            f"reshard wire {codec.name!r} has no host-side decode "
            "(cooperative codec) — see host_encode")
    if codec.cast_dtype == torch.float16:
        return np.frombuffer(buf, dtype=np.float16).astype(np.dtype(dtype))
    hi = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
    return hi.view(np.float32).astype(np.dtype(dtype))


def local_roundtrip(v: torch.Tensor, wire: str = "int8") -> torch.Tensor:
    """encode → decode through the local codec, with the block scales a
    ring's first hop uses: the compression operator C whose error error
    feedback carries to the next step.  Returns v's shape (in v's dtype
    for a cast wire, f32 otherwise)."""
    codec = get_codec(wire)
    flat = v.to(torch.float32).reshape(-1)
    padded = torch.nn.functional.pad(flat, (0, (-flat.numel()) % _BLOCK))
    out = codec.decode(codec.encode(padded))[: flat.numel()]
    return out.reshape(v.shape).to(v.dtype) if codec.cast_dtype \
        else out.reshape(v.shape)


# ---------------------------------------------------------------------------
# Per-bucket wire policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WirePolicy:
    """Maps a gradient bucket to a codec name by its raw bytes and dtype
    class: all-float buckets of at least `threshold_bytes` ride `big`,
    smaller ones `small`; a bucket with any integer leaf stays exact.
    `threshold_bytes=None` reads the live `wire_threshold` knob at each
    classification, `big=None` the live `wire_big_format` knob."""

    big: Optional[str] = "none"
    small: str = "none"
    threshold_bytes: Optional[int] = None

    @property
    def exact(self) -> bool:
        return self.big == "none" and self.small == "none"

    def _threshold(self) -> int:
        if self.threshold_bytes is not None:
            return self.threshold_bytes
        from ..utils.autotune import current_wire_threshold
        return current_wire_threshold()

    def _big(self) -> str:
        if self.big is not None:
            return self.big
        from ..utils.autotune import current_wire_big_format
        return get_codec(current_wire_big_format()).name

    def codec_for(self, nbytes: int, all_float: bool) -> str:
        if not all_float:
            return "none"
        return self._big() if nbytes >= self._threshold() else self.small


def parse_wire_policy(spec: str) -> WirePolicy:
    """Parse a HOROVOD_WIRE_POLICY spec: ``"exact"`` (every bucket exact,
    bitwise the unset policy), ``"auto"`` (big buckets ride the
    `wire_big_format` knob's codec, small ones stay exact, the threshold
    from the `wire_threshold` knob), or ``key=value`` pairs ``big=``,
    ``small=``, ``threshold=`` (omitted keys: big from the knob,
    small=none, threshold from the knob).  Unknown codecs and malformed
    pairs raise `HorovodTpuError`."""
    spec = spec.strip()
    if spec == "exact":
        return WirePolicy()
    if spec == "auto":
        return WirePolicy(big=None, small="none")
    big, small, threshold = None, "none", None
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise HorovodTpuError(
                f"bad HOROVOD_WIRE_POLICY entry {part!r}: expected "
                "'exact', 'auto', or comma-separated key=value pairs "
                "(big=, small=, threshold=; see docs/WIRE.md)")
        key, _, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if key == "big":
            big = get_codec(val).name
        elif key == "small":
            small = get_codec(val).name
        elif key == "threshold":
            try:
                threshold = int(val)
            except ValueError:
                raise HorovodTpuError(
                    f"bad HOROVOD_WIRE_POLICY threshold {val!r}: "
                    "expected an integer byte count") from None
        else:
            raise HorovodTpuError(
                f"unknown HOROVOD_WIRE_POLICY key {key!r}: valid keys "
                "are big, small, threshold (see docs/WIRE.md)")
    return WirePolicy(big=big, small=small, threshold_bytes=threshold)


def policy_from_env() -> Optional[WirePolicy]:
    """The policy of HOROVOD_WIRE_POLICY, or None when it is unset (then
    the `compression=` argument alone sets the wire)."""
    spec = util.wire_policy()
    if not spec:
        return None
    return parse_wire_policy(spec)


# ---------------------------------------------------------------------------
# Error-feedback reset protocol
# ---------------------------------------------------------------------------
# Residuals belong to their holders (the sharded optimizer's rows, the
# caller's state of `allreduce_gradients`); the wire layer owns the reset:
# holders register a hook or compare the generation they stamped, and the
# elastic reset calls `reset_error_feedback()`, so that a residual encoded
# against the old membership never reaches the first step after it.
_ef_generation = 0
_ef_reset_hooks: list = []


def register_error_feedback_reset(hook) -> None:
    """Run `hook()` on every `reset_error_feedback()`."""
    _ef_reset_hooks.append(hook)


def unregister_error_feedback_reset(hook) -> None:
    """Remove a reset hook (nothing if it is absent)."""
    try:
        _ef_reset_hooks.remove(hook)
    except ValueError:
        pass


def reset_error_feedback() -> int:
    """Invalidate every outstanding error-feedback residual: bump the
    generation and run the hooks.  Returns the new generation."""
    global _ef_generation
    _ef_generation += 1
    for hook in list(_ef_reset_hooks):
        hook()
    return _ef_generation


def error_feedback_generation() -> int:
    """The current generation: a holder that stamped an older one zeroes
    its residual before use."""
    return _ef_generation


__all__ = [
    "WireCodec",
    "WirePolicy",
    "cast_wire_names",
    "compressor_wire",
    "error_feedback_generation",
    "get_codec",
    "host_decode",
    "host_encode",
    "local_roundtrip",
    "parse_wire_policy",
    "policy_from_env",
    "register_error_feedback_reset",
    "reset_error_feedback",
    "unregister_error_feedback_reset",
    "wire_names",
]
