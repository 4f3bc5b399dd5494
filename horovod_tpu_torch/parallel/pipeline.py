"""Pipeline parallelism: the GPipe schedule over a `pp` set.

Counterpart of `horovod_tpu/parallel/pipeline.py`.  Stages are the
ranks of the set; activations move stage to stage by forward-only
`ppermute` hops (i → i+1), and autograd through the schedule gives the
reverse schedule for the backward (each hop's backward is the hop
back).

Schedule (forward): M + pp − 1 ticks for M microbatches.  Stage i works
on microbatch m at tick m + i.  Every stage computes every tick (bubble
ticks compute on zeros and are masked out) and every tick but the last
hops, as in the JAX module, so that every rank issues the same
collectives.  The last stage's outputs are replicated over the set by a
psum, so every rank returns the full [M, ...] block.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..common.basics import ProcessSet
from ..common.exceptions import HorovodTpuError
from . import _collectives as pc
from .mesh import Mesh


def gpipe_shard(stage_fn: Callable, stage_params: Any, x_mb: torch.Tensor,
                ps: ProcessSet) -> torch.Tensor:
    """GPipe forward on this rank's stage.

    stage_fn(stage_params, x) applies this stage's layers and keeps x's
    shape.  x_mb [M, B_mb, ...]: the microbatches (stage 0 reads them).
    Returns [M, B_mb, ...]: the last stage's outputs on every rank."""
    pp, idx = ps.size(), ps.rank()
    M = x_mb.shape[0]
    is_first = torch.tensor(idx == 0, device=x_mb.device)
    last = 1.0 if idx == pp - 1 else 0.0
    perm = [(i, i + 1) for i in range(pp - 1)]
    recv = torch.zeros_like(x_mb[0])
    outs = []
    for t in range(M + pp - 1):
        inp = torch.where(is_first & (t < M), x_mb[min(t, M - 1)], recv)
        y = stage_fn(stage_params, inp)
        if tuple(y.shape) != tuple(x_mb.shape[1:]):
            raise ValueError(
                f"GPipe stages must preserve activation shape; stage maps "
                f"{tuple(x_mb.shape[1:])} -> {tuple(y.shape)}")
        # The last stage completes microbatch t - (pp - 1) at this tick.
        if t >= pp - 1:
            outs.append(y)
        if t < M + pp - 2:
            recv = pc.ppermute(y, perm, ps, name="hvd.pp.hop")
    outputs = torch.stack(outs) * last
    return pc.psum(outputs, ps, name="hvd.pp.psum")


def gpipe(mesh: Mesh, stage_fn: Callable, params: Any, x: torch.Tensor,
          n_microbatches: int, axis: str = "pp") -> torch.Tensor:
    """Mesh-level GPipe: `params` is this rank's stage (the leaves'
    leading pp dimension already taken); x [B, ...] with B divisible by
    n_microbatches, the same on every rank.  Returns [B, ...]."""
    B = x.shape[0]
    if B % n_microbatches != 0:
        raise HorovodTpuError(
            f"gpipe: batch {B} not divisible by {n_microbatches} "
            "microbatches")
    x_mb = x.reshape((n_microbatches, B // n_microbatches) + x.shape[1:])
    out = gpipe_shard(stage_fn, params, x_mb, mesh.sets[axis])
    return out.reshape((B,) + out.shape[2:])
