"""The MNIST conv net as an `nn.Module`: BASELINE config 1's model.

Counterpart of `horovod_tpu/models/mnist.py` (`mnist_cnn_init`,
`mnist_cnn_apply`, `nll_loss`), itself the `Net` of the reference's
`examples/pytorch/pytorch_mnist.py`: conv(1→10, 5) → max-pool 2 → relu →
conv(10→20, 5) → channel dropout → max-pool 2 → relu → fc(320→50) →
relu → fc(50→10) → log-softmax, in f32.

As in the JAX model, and unlike upstream's `Net`, there is no dropout
after fc1, and conv2's channel dropout runs only when the forward is
given a generator (the JAX model's `dropout_rng`): whole channels are
dropped with probability 0.5 and the rest scaled by 2.

The flatten before fc1 is PyTorch's (c, h, w) order; the JAX model
flattens NHWC, (h, w, c), so `convert.mnist_from_jax` permutes fc1's
input rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L


class MnistNet(nn.Module):
    """Weights drawn on the CPU from `torch.Generator().manual_seed(seed)`
    with the JAX initializers' distributions."""

    def __init__(self, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.conv1 = L.Conv2d(1, 10, 5, padding="VALID", bias=True,
                              generator=g)
        self.conv2 = L.Conv2d(10, 20, 5, padding="VALID", bias=True,
                              generator=g)
        self.fc1 = L.Dense(320, 50, generator=g)
        self.fc2 = L.Dense(50, 10, generator=g)

    def forward(self, x: torch.Tensor,
                dropout: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (N, 1, 28, 28) → log-probabilities (N, 10).  `dropout`: a
        generator for conv2's channel dropout in training; None (the
        default, as in the JAX trainer) keeps every channel."""
        y = F.relu(L.max_pool(self.conv1(x), 2, 2))
        y = self.conv2(y)
        if self.training and dropout is not None:
            keep = torch.rand(y.shape[:2] + (1, 1), generator=dropout,
                              device=dropout.device) < 0.5
            y = torch.where(keep.to(y.device), y / 0.5, 0.0)
        y = F.relu(L.max_pool(y, 2, 2))
        y = F.relu(self.fc1(y.flatten(1)))
        return F.log_softmax(self.fc2(y), dim=-1)


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood, the mean over the batch (JAX `nll_loss`;
    reference: F.nll_loss in pytorch_mnist.py)."""
    return F.nll_loss(log_probs, labels)
