"""Inception V3 as an `nn.Module`: the reference's ~90%-scaling row.

Counterpart of `horovod_tpu/models/inception.py` (`inception3_init`,
`inception3_apply`): stem → 3 × Inception-A (35×35) → reduction A → 4 ×
Inception-B (17×17, factorized 1×7 / 7×1) → reduction B → 2 ×
Inception-C (8×8) → global average pool → head, without the auxiliary
classifier.  Every conv is a unit of conv (no bias), batch norm (f32
statistics, JAX momentum: `layers.BatchNorm`) and relu.  Pads, strides
and the branches' concatenation order are the JAX ones; the pool
branches average over SAME windows without the padding
(`layers.avg_pool`).  23,834,568 parameters at 1000 classes; inputs of
at least 75×75 (299 canonical).

Module names follow the JAX parameter tree: the unit `mixed0.b1x1` is
the JAX entry "mixed0/b1x1" ({"conv", "bn"} in the parameters, its
statistics in the batch stats), `stem.conv1` is "stem/conv1", and the
head is `head`; `convert.inception_from_jax` walks it.

`sync_bn` (None, True for the global set, or a `ProcessSet`) is the
counterpart of `inception3_apply(axis_name=...)`: every batch norm takes
the statistics of the set's global batch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L


class ConvBN(nn.Module):
    """conv → batch norm → relu (JAX `_cbr_apply`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride: int = 1,
                 padding: str = "SAME", *, compute_dtype, generator,
                 sync_bn=None):
        super().__init__()
        self.conv = L.Conv2d(in_ch, out_ch, kernel, stride,
                             compute_dtype=compute_dtype, generator=generator,
                             padding=padding)
        self.bn = L.BatchNorm(out_ch, process_set=sync_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class _Block(nn.Module):
    """Holds the units of one stem or mixed block; `unit` registers one
    under the JAX name's last part and returns its output channels."""

    def __init__(self, **unit_kw):
        super().__init__()
        self._unit_kw = unit_kw

    def unit(self, name: str, in_ch: int, out_ch: int, kernel,
             stride: int = 1, padding: str = "SAME") -> int:
        self.add_module(name, ConvBN(in_ch, out_ch, kernel, stride, padding,
                                     **self._unit_kw))
        return out_ch

    def chain(self, x: torch.Tensor, *names: str) -> torch.Tensor:
        for name in names:
            x = getattr(self, name)(x)
        return x


def _pool_branch(block: _Block, x: torch.Tensor) -> torch.Tensor:
    return block.pool(L.avg_pool(x, 3, 1, padding="SAME"))


class Stem(_Block):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.unit("conv1", 3, 32, 3, stride=2, padding="VALID")
        self.unit("conv2", 32, 32, 3, padding="VALID")
        self.unit("conv3", 32, 64, 3)
        self.unit("conv4", 64, 80, 1, padding="VALID")
        self.out_ch = self.unit("conv5", 80, 192, 3, padding="VALID")

    def forward(self, x):
        y = L.max_pool(self.chain(x, "conv1", "conv2", "conv3"), 3, 2)
        return L.max_pool(self.chain(y, "conv4", "conv5"), 3, 2)


class InceptionA(_Block):
    def __init__(self, in_ch: int, pool_ch: int, **kw):
        super().__init__(**kw)
        self.unit("b1x1", in_ch, 64, 1)
        self.unit("b5x5_1", in_ch, 48, 1)
        self.unit("b5x5_2", 48, 64, 5)
        self.unit("b3x3_1", in_ch, 64, 1)
        self.unit("b3x3_2", 64, 96, 3)
        self.unit("b3x3_3", 96, 96, 3)
        self.unit("pool", in_ch, pool_ch, 1)
        self.out_ch = 64 + 64 + 96 + pool_ch

    def forward(self, x):
        return torch.cat([
            self.b1x1(x), self.chain(x, "b5x5_1", "b5x5_2"),
            self.chain(x, "b3x3_1", "b3x3_2", "b3x3_3"),
            _pool_branch(self, x)], dim=1)


class ReductionA(_Block):
    def __init__(self, in_ch: int, **kw):
        super().__init__(**kw)
        self.unit("b3x3", in_ch, 384, 3, stride=2, padding="VALID")
        self.unit("b3x3dbl_1", in_ch, 64, 1)
        self.unit("b3x3dbl_2", 64, 96, 3)
        self.unit("b3x3dbl_3", 96, 96, 3, stride=2, padding="VALID")
        self.out_ch = 384 + 96 + in_ch  # + the max-pooled input

    def forward(self, x):
        return torch.cat([
            self.b3x3(x), self.chain(x, "b3x3dbl_1", "b3x3dbl_2",
                                     "b3x3dbl_3"),
            L.max_pool(x, 3, 2)], dim=1)


class InceptionB(_Block):
    def __init__(self, in_ch: int, mid: int, **kw):
        super().__init__(**kw)
        self.unit("b1x1", in_ch, 192, 1)
        self.unit("b7x7_1", in_ch, mid, 1)
        self.unit("b7x7_2", mid, mid, (1, 7))
        self.unit("b7x7_3", mid, 192, (7, 1))
        self.unit("b7x7dbl_1", in_ch, mid, 1)
        self.unit("b7x7dbl_2", mid, mid, (7, 1))
        self.unit("b7x7dbl_3", mid, mid, (1, 7))
        self.unit("b7x7dbl_4", mid, mid, (7, 1))
        self.unit("b7x7dbl_5", mid, 192, (1, 7))
        self.unit("pool", in_ch, 192, 1)
        self.out_ch = 192 * 4

    def forward(self, x):
        return torch.cat([
            self.b1x1(x), self.chain(x, *(f"b7x7_{i}" for i in (1, 2, 3))),
            self.chain(x, *(f"b7x7dbl_{i}" for i in (1, 2, 3, 4, 5))),
            _pool_branch(self, x)], dim=1)


class ReductionB(_Block):
    def __init__(self, in_ch: int, **kw):
        super().__init__(**kw)
        self.unit("b3x3_1", in_ch, 192, 1)
        self.unit("b3x3_2", 192, 320, 3, stride=2, padding="VALID")
        self.unit("b7x7x3_1", in_ch, 192, 1)
        self.unit("b7x7x3_2", 192, 192, (1, 7))
        self.unit("b7x7x3_3", 192, 192, (7, 1))
        self.unit("b7x7x3_4", 192, 192, 3, stride=2, padding="VALID")
        self.out_ch = 320 + 192 + in_ch

    def forward(self, x):
        return torch.cat([
            self.chain(x, "b3x3_1", "b3x3_2"),
            self.chain(x, *(f"b7x7x3_{i}" for i in (1, 2, 3, 4))),
            L.max_pool(x, 3, 2)], dim=1)


class InceptionC(_Block):
    def __init__(self, in_ch: int, **kw):
        super().__init__(**kw)
        self.unit("b1x1", in_ch, 320, 1)
        self.unit("b3x3_1", in_ch, 384, 1)
        self.unit("b3x3_2a", 384, 384, (1, 3))
        self.unit("b3x3_2b", 384, 384, (3, 1))
        self.unit("b3x3dbl_1", in_ch, 448, 1)
        self.unit("b3x3dbl_2", 448, 384, 3)
        self.unit("b3x3dbl_3a", 384, 384, (1, 3))
        self.unit("b3x3dbl_3b", 384, 384, (3, 1))
        self.unit("pool", in_ch, 192, 1)
        self.out_ch = 320 + 768 + 768 + 192

    def forward(self, x):
        c = self.b3x3_1(x)
        d = self.chain(x, "b3x3dbl_1", "b3x3dbl_2")
        return torch.cat([
            self.b1x1(x), self.b3x3_2a(c), self.b3x3_2b(c),
            self.b3x3dbl_3a(d), self.b3x3dbl_3b(d),
            _pool_branch(self, x)], dim=1)


class Inception3(nn.Module):
    """Inception V3.  Weights are drawn on the CPU from
    `torch.Generator().manual_seed(seed)`."""

    MIN_SIZE = 75

    def __init__(self, num_classes: int = 1000,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                 seed: int = 0, sync_bn=None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype,
                  generator=torch.Generator().manual_seed(seed),
                  sync_bn=sync_bn)
        self.stem = Stem(**kw)
        ch = self.stem.out_ch
        self.block_names = []

        def add(name, block):
            nonlocal ch
            self.add_module(name, block)
            self.block_names.append(name)
            ch = block.out_ch

        for i, pool_ch in enumerate((32, 64, 64)):
            add(f"mixed{i}", InceptionA(ch, pool_ch, **kw))
        add("mixed3", ReductionA(ch, **kw))
        for i, mid in zip((4, 5, 6, 7), (128, 160, 160, 192)):
            add(f"mixed{i}", InceptionB(ch, mid, **kw))
        add("mixed8", ReductionB(ch, **kw))
        for i in (9, 10):
            add(f"mixed{i}", InceptionC(ch, **kw))
        self.head = L.Dense(ch, num_classes, compute_dtype=compute_dtype,
                            generator=kw["generator"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, 3, H, W), H, W >= 75 → f32 logits."""
        if x.shape[2] < self.MIN_SIZE or x.shape[3] < self.MIN_SIZE:
            raise ValueError(
                f"inception3 needs input >= 75x75 (299 canonical), got "
                f"{x.shape[2]}x{x.shape[3]}")
        y = self.stem(x)
        for name in self.block_names:
            y = getattr(self, name)(y)
        return self.head(L.global_avg_pool(y)).float()
