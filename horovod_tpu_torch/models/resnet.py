"""ResNet family (v1.5) as an `nn.Module` — the benchmark model.

Counterpart of `horovod_tpu/models/resnet.py`: stride on the 3×3 of a
bottleneck, projection shortcut where the shape changes, bf16-capable
compute with f32 batch-norm statistics.  The stem is the plain 7×7/s2
SAME conv (the JAX package's space-to-depth stem is a TPU layout trick).
Module names follow the JAX parameter tree (`stem`, `bn_stem`,
`stage{s}_block{b}.conv1`, ..., `head`), which `convert.resnet_from_jax`
relies on.

    model = ResNet(50, num_classes=1000, compute_dtype=torch.bfloat16)
    logits = model(images)              # images: (N, 3, H, W); logits f32
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L

STAGE_SIZES = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}
BOTTLENECK = {18: False, 34: False, 50: True, 101: True, 152: True}
STAGE_WIDTHS = [64, 128, 256, 512]


class Block(nn.Module):
    """One residual block (JAX `_block_init` / `_block_apply`)."""

    def __init__(self, in_ch: int, width: int, stride: int, bottleneck: bool,
                 compute_dtype: Optional[torch.dtype],
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.bottleneck = bottleneck
        self.out_ch = width * 4 if bottleneck else width
        cd, g = compute_dtype, generator
        if bottleneck:
            self.conv1 = L.Conv2d(in_ch, width, 1, 1, compute_dtype=cd,
                                  generator=g)
            self.conv2 = L.Conv2d(width, width, 3, stride, compute_dtype=cd,
                                  generator=g)
            self.conv3 = L.Conv2d(width, self.out_ch, 1, 1,
                                  compute_dtype=cd, generator=g)
            self.bn3 = L.BatchNorm(self.out_ch)
        else:
            self.conv1 = L.Conv2d(in_ch, width, 3, stride, compute_dtype=cd,
                                  generator=g)
            self.conv2 = L.Conv2d(width, self.out_ch, 3, 1,
                                  compute_dtype=cd, generator=g)
        self.bn1 = L.BatchNorm(width)
        self.bn2 = L.BatchNorm(width if bottleneck else self.out_ch)
        if stride != 1 or in_ch != self.out_ch:
            self.proj = L.Conv2d(in_ch, self.out_ch, 1, stride,
                                 compute_dtype=cd, generator=g)
            self.bn_proj = L.BatchNorm(self.out_ch)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.bottleneck:
            y = self.bn3(self.conv3(F.relu(y)))
        residual = x if self.proj is None else self.bn_proj(self.proj(x))
        return F.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """ResNet v1.5 of depth 18, 34, 50, 101 or 152.  Weights are drawn
    on the CPU from `torch.Generator().manual_seed(seed)`."""

    def __init__(self, depth: int = 50, num_classes: int = 1000,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                 seed: int = 0):
        super().__init__()
        if depth not in STAGE_SIZES:
            raise ValueError(f"Unsupported ResNet depth {depth}")
        bottleneck = BOTTLENECK[depth]
        g = torch.Generator().manual_seed(seed)
        self.stem = L.Conv2d(3, 64, 7, 2, compute_dtype=compute_dtype,
                             generator=g)
        self.bn_stem = L.BatchNorm(64)
        in_ch = 64
        self.block_names = []
        for stage, (n_blocks, width) in enumerate(
                zip(STAGE_SIZES[depth], STAGE_WIDTHS)):
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"stage{stage}_block{b}"
                block = Block(in_ch, width, stride, bottleneck,
                              compute_dtype, g)
                self.add_module(name, block)
                self.block_names.append(name)
                in_ch = block.out_ch
        self.head = L.Dense(in_ch, num_classes, compute_dtype=compute_dtype,
                            generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn_stem(self.stem(x)))
        y = L.max_pool(y, 3, 2, padding="SAME")
        for name in self.block_names:
            y = getattr(self, name)(y)
        y = L.global_avg_pool(y)
        return self.head(y).float()


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
