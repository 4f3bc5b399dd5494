"""Gradient wire compression (counterpart of `horovod_tpu/ops/
compression.py`; reference: horovod/torch/compression.py).

This slice ports `Compression.none` and `Compression.fp16`; the
block-scaled wire codecs (`ops/wire.py`, `ops/quantized.py`) come later.
"""

from __future__ import annotations

import torch


class Compressor:
    @staticmethod
    def compress(tensor: torch.Tensor):
        """Returns (compressed_tensor, context_for_decompress)."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    """Floating tensors travel as float16; others pass unchanged."""

    @staticmethod
    def compress(tensor):
        if tensor.is_floating_point():
            return tensor.to(torch.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class Compression:
    """Namespace matching ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
