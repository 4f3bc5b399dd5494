"""NN layers as `nn.Module`s, with the JAX package's numerics.

Counterpart of `horovod_tpu/models/layers.py`.  Activations are NCHW
(PyTorch's habit; the JAX package is NHWC), conv weights OIHW (JAX:
HWIO), dense weights (out, in) (JAX: (in, out)).  What carries over
exactly:

- "SAME" padding as XLA computes it, asymmetric at stride 2: the 7×7/s2
  stem pads (2, 3), a 3×3/s2 conv on an even input (0, 1), the 3/s2
  max-pool (0, 1) with -inf.  `nn.Conv2d(padding=k // 2)` is not this.
- Batch norm as `batchnorm_apply`: statistics in f32 with
  var = E[x²] - mean², running update 0.9·old + 0.1·batch with the
  biased var, eps 1e-5.  (`nn.BatchNorm2d` weights the new value by its
  momentum and keeps the unbiased var.)  `process_set` is the
  counterpart of its `axis_name`: the statistics of the set's global
  batch.
- `compute_dtype` casts the input and the weight before a conv or a
  dense layer.
- SAME average pooling divides by the count of unpadded elements
  (`avg_pool`), as the JAX package's does.

Initializers take an explicit `torch.Generator`; they draw from the same
distributions as the JAX initializers, not the same numbers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def he_normal(shape, fan_in: int, generator: Optional[torch.Generator] = None,
              dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype) * \
        math.sqrt(2.0 / fan_in)


def uniform_fan_in(shape, fan_in: int,
                   generator: Optional[torch.Generator] = None,
                   dtype=torch.float32) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return u * (2 * bound) - bound


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's "SAME" along one dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int,
              value: float = 0.0):
    """Pad x (N, C, H, W) for a SAME window.  Returns (x, symmetric
    padding left for the op itself)."""
    ph = same_padding(x.shape[2], kh, stride)
    pw = same_padding(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1] and value == 0.0:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """y = x Wᵀ + b (JAX `dense_apply`)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(uniform_fan_in(
            (out_features, in_features), in_features, generator))
        self.bias = nn.Parameter(uniform_fan_in(
            (out_features,), in_features, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
            w = w.to(self.compute_dtype)
        return x @ w.t() + self.bias.to(x.dtype)


class Conv2d(nn.Module):
    """2-D convolution (JAX `conv2d_apply`): `padding` "SAME" (as XLA
    computes it) or "VALID"; `bias` adds a per-channel bias, zeros at
    init as `conv2d_init(bias=True)` draws it.  `kernel` is an int or
    (kh, kw): Inception's 1×7 / 7×1 convs need the rectangular form."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride: int = 1,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 padding: str = "SAME", bias: bool = False):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                             f"{padding!r}")
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.stride = stride
        self.padding = padding
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(he_normal(
            (out_ch, in_ch, kh, kw), in_ch * kh * kw, generator))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
            w = w.to(self.compute_dtype)
        pad = (0, 0)
        if self.padding == "SAME":
            x, pad = _pad_same(x, w.shape[2], w.shape[3], self.stride)
        y = F.conv2d(x, w, stride=self.stride, padding=pad)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).reshape(1, -1, 1, 1)
        return y


class BatchNorm(nn.Module):
    """Batch norm over every axis but channels (JAX `batchnorm_apply`,
    train-mode batch statistics).

    `process_set`: None (or False) keeps the statistics local to the
    rank; a `ProcessSet`, or True for the global set (looked up at each
    call, so that it follows an elastic reset), averages the train-mode
    mean and mean of the squares across the set, as `axis_name` does
    with `lax.pmean`: [mean, mean2] as one tensor through one allreduce
    of the autograd wrapper, whose backward is the allreduce of the
    cotangents (the transpose of pmean)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, process_set=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.process_set = process_set
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        if self.training:
            mean = xf.mean(dims)
            mean2 = xf.square().mean(dims)
            if self.process_set is not None and self.process_set is not False:
                from ..torch import Average, allreduce

                ps = None if self.process_set is True else self.process_set
                mean, mean2 = allreduce(torch.stack([mean, mean2]),
                                        op=Average, process_set=ps)
            var = mean2 - mean.square()
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean = self.running_mean.float()
            var = self.running_var.float()
        inv = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean.reshape(shape)) * inv.reshape(shape) \
            + self.bias.float().reshape(shape)
        return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: str = "VALID") -> torch.Tensor:
    if padding == "SAME":
        x, _ = _pad_same(x, window, window, stride, value=-math.inf)
    return F.max_pool2d(x, window, stride)


def avg_pool(x: torch.Tensor, window: int, stride: int,
             padding: str = "VALID") -> torch.Tensor:
    """JAX `avg_pool`: VALID divides by the window's size; SAME pads as
    XLA does and divides each output by the count of the input elements
    under its window, the padding left out (`count_include_pad=False`,
    not torch's default)."""
    if padding == "VALID":
        return F.avg_pool2d(x, window, stride)
    ph = same_padding(x.shape[2], window, stride)
    pw = same_padding(x.shape[3], window, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.avg_pool2d(x, window, stride, padding=(ph[0], pw[0]),
                            count_include_pad=False)
    # Asymmetric SAME (stride 2 on an even size): the window sums over
    # the zero-padded input, divided by the counts of a padded ones map.
    pad = (pw[0], pw[1], ph[0], ph[1])
    sums = F.avg_pool2d(F.pad(x, pad), window, stride, divisor_override=1)
    ones = F.pad(torch.ones_like(x[:1, :1]), pad)
    counts = F.avg_pool2d(ones, window, stride, divisor_override=1)
    return sums / counts


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3))
