"""Gradient wire compression (counterpart of `horovod_tpu/ops/
compression.py`; reference: horovod/torch/compression.py).

The whole `hvd.Compression` namespace of the JAX package.  Every
compressor names its wire format (`wire`, a codec of `ops/wire.py` in
the JAX package).  `none` passes tensors through; `fp16` and `bf16` cast
floating tensors to the wire dtype and back.  The cooperative formats
(`int8`, `int4`, `fp8_e4m3`, `fp8_e5m2`) cannot be a cast before the
collective: their sums need a ring that accumulates in f32 at every
hop (`ops/quantized.py`).  The gradient paths route them to the ring
before any compress (`DistributedOptimizer`, `allreduce_gradients`), so
their `compress` raises, as the JAX package's does, on any path that
reaches it; nothing sums in a 1-byte dtype.
"""

from __future__ import annotations

import torch


class Compressor:
    #: Name of the wire format this compressor speaks.
    wire: str = "none"

    @staticmethod
    def compress(tensor: torch.Tensor):
        """Returns (compressed_tensor, context_for_decompress)."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    wire = "none"

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    """Floating tensors travel in `wire_dtype`; others pass unchanged."""

    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point():
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class FP16Compressor(_CastCompressor):
    wire = "fp16"
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire = "bf16"
    wire_dtype = torch.bfloat16


class _CooperativeCompressor(Compressor):
    """A block-scaled low-bit wire: the collective itself quantizes each
    hop and accumulates in f32 (the quantized ring), so the gradient
    paths take the ring before compress, and compress refuses."""

    @classmethod
    def compress(cls, tensor):
        raise NotImplementedError(
            f"Compression.{cls.wire} is a cooperative wire: its sums need "
            "the quantized ring (ops/quantized.py), which the gradient "
            "paths (DistributedOptimizer, allreduce_gradients) route to "
            "before any compress; a single tensor's compress has no such "
            "form")

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP8E4M3Compressor(_CooperativeCompressor):
    """1-byte fp8 ring wire (e4m3: 3 mantissa bits, ±448 range)."""

    wire = "fp8_e4m3"


class FP8E5M2Compressor(_CooperativeCompressor):
    """1-byte fp8 ring wire (e5m2: bf16-like range, 2 mantissa bits)."""

    wire = "fp8_e5m2"


class Int8Compressor(_CooperativeCompressor):
    """1-byte int8 ring wire (blockwise max-abs scales)."""

    wire = "int8"


class Int4Compressor(_CooperativeCompressor):
    """Half-byte int4 ring wire (±7 levels per blockwise max-abs scale,
    two values packed per byte)."""

    wire = "int4"


def is_cooperative(compression) -> bool:
    return isinstance(compression, type) and issubclass(
        compression, _CooperativeCompressor)


class Compression:
    """Namespace matching ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    int4 = Int4Compressor
    fp8_e4m3 = FP8E4M3Compressor
    fp8_e5m2 = FP8E5M2Compressor
