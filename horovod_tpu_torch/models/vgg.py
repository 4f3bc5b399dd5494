"""VGG-16 as an `nn.Module`: the bandwidth-bound benchmark model.

Counterpart of `horovod_tpu/models/vgg.py` (`vgg16_init`,
`vgg16_apply`): configuration "D", thirteen 3×3 SAME convs with bias and
relu in five stages, each closed by a 2×2 max-pool, then fc1, fc2 (4096
wide, relu) and the head; no batch norm and no dropout (the benchmark
configuration).  At 224×224 it holds 138,357,544 parameters, about 74%
of them in fc1 — the stress test of gradient fusion.  Compute in
`compute_dtype` (bf16 by default) with f32 weights; logits in f32.

Module names follow the JAX parameter tree (`conv{stage}_{i}`, `fc1`,
`fc2`, `head`).  The flatten before fc1 is PyTorch's (c, h, w) order;
the JAX model flattens NHWC, so `convert.vgg_from_jax` permutes fc1's
input rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L

# (convs, channels) per stage: VGG-16 configuration "D".
STAGES = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
FC_DIM = 4096


class VGG16(nn.Module):
    """`image_size` (a multiple of 32) sizes the flatten → fc1 boundary,
    and the forward takes only inputs of that size.  Weights are drawn
    on the CPU from `torch.Generator().manual_seed(seed)`."""

    def __init__(self, num_classes: int = 1000, image_size: int = 224,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                 seed: int = 0):
        super().__init__()
        if image_size % 32:
            raise ValueError(f"vgg16 needs image_size % 32 == 0, "
                             f"got {image_size}")
        self.image_size = image_size
        g = torch.Generator().manual_seed(seed)
        in_ch = 3
        for si, (n_convs, ch) in enumerate(STAGES):
            for ci in range(n_convs):
                self.add_module(f"conv{si}_{ci}", L.Conv2d(
                    in_ch, ch, 3, compute_dtype=compute_dtype, generator=g,
                    bias=True))
                in_ch = ch
        spatial = image_size // 32
        self.fc1 = L.Dense(spatial * spatial * in_ch, FC_DIM,
                           compute_dtype=compute_dtype, generator=g)
        self.fc2 = L.Dense(FC_DIM, FC_DIM, compute_dtype=compute_dtype,
                           generator=g)
        self.head = L.Dense(FC_DIM, num_classes, compute_dtype=compute_dtype,
                            generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, 3, H, W) with H = W = image_size → f32 logits."""
        if x.shape[2] != self.image_size or x.shape[3] != self.image_size:
            raise ValueError(
                f"vgg16 was built for {self.image_size}x{self.image_size} "
                f"inputs (the flatten->fc1 boundary is size-dependent), got "
                f"{x.shape[2]}x{x.shape[3]}; build it with image_size=")
        y = x
        for si, (n_convs, _) in enumerate(STAGES):
            for ci in range(n_convs):
                y = F.relu(getattr(self, f"conv{si}_{ci}")(y))
            y = L.max_pool(y, 2, 2)
        y = F.relu(self.fc1(y.flatten(1)))
        y = F.relu(self.fc2(y))
        return self.head(y).float()
