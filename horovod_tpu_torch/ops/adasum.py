"""Adasum: convergence-preserving gradient combination.

Counterpart of `horovod_tpu/ops/adasum.py` (reference: horovod/common/
ops/adasum/adasum.h).  Two gradients a, b combine as

    adasum(a, b) = (1 - a.b / (2 ||a||^2)) * a  +  (1 - a.b / (2 ||b||^2)) * b

pairwise in a binary tree over the ranks, log2(n) levels.  A rank count
n = 2^k + r first folds the r residual entries into the leading ones
with one pair combine each (unbalanced leaves), then runs the balanced
tree; `adasum_reference` (numpy f64) defines the semantics for every n.

`adasum_allreduce` runs the JAX package's on-device route,
`adasum_in_axis`: the XOR ladder over point-to-point hops.  At level d
rank r exchanges its vector with rank r ^ d and combines, the lower
index as `a`; a rank receives log2(n)·N elements where an allgather
receives (n−1)·N.  `adasum_tree_reduce` on an allgathered (n, N) stack
(the JAX eager path) is the plain route that the tests and the card
check hold the ladder to: both pair the same vectors in the same
order, so they agree bitwise.  Every level's combine runs through the
two CUDA kernels of `adasum_kernels` (the plain versions for tensors on
the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..common.basics import ProcessSet
from . import adasum_kernels as K

_EPS = 1e-30


def _pair_combine_batched(a: torch.Tensor, b: torch.Tensor,
                          plain: bool = False) -> torch.Tensor:
    """(k, *s) pairwise combine through the two kernels (counterpart of
    `pallas_pair_combine_batched`): K1 gives [a·b, ‖a‖², ‖b‖²] per row,
    the coefficients get the JAX package's zero-norm guards, and K2 forms
    ca·a + cb·b.  `plain=True` runs the kernels' plain versions on any
    device (the check against the kernels)."""
    k = a.shape[0]
    a2 = a.reshape(k, -1)
    b2 = b.reshape(k, -1)
    dot_norms = K.fused_dot_norms_plain if plain else K.fused_dot_norms
    scaled_add = K.fused_scaled_add_plain if plain else K.fused_scaled_add
    d = dot_norms(a2, b2)
    dot, na, nb = d[:, 0], d[:, 1], d[:, 2]
    one = torch.ones_like(na)
    ca = torch.where(na > _EPS, 1.0 - dot / (2.0 * na.clamp_min(_EPS)), one)
    cb = torch.where(nb > _EPS, 1.0 - dot / (2.0 * nb.clamp_min(_EPS)), one)
    out = scaled_add(ca.contiguous(), cb.contiguous(), a2, b2)
    return out.reshape(a.shape)


def _pair_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine one pair of gradients (computed at f32)."""
    return _pair_combine_batched(a[None], b[None])[0]


def _pow2_floor(n: int) -> int:
    k = 1
    while k * 2 <= n:
        k *= 2
    return k


def adasum_tree_reduce(xs: torch.Tensor, plain: bool = False
                       ) -> torch.Tensor:
    """Reduce (n, *s) stacked gradients with the Adasum binary tree.

    `plain=True` runs every combine through the plain versions of the
    kernels, on whatever device xs is on."""
    n = xs.shape[0]
    if n & (n - 1):
        k = _pow2_floor(n)
        r = n - k
        folded = _pair_combine_batched(xs[:r], xs[k:], plain)
        xs = torch.cat([folded, xs[r:k]], dim=0)
        n = k
    while n > 1:
        xs = _pair_combine_batched(xs[0::2], xs[1::2], plain)
        n //= 2
    return xs[0]


def adasum_in_axis(x: torch.Tensor,
                   process_set: Optional[ProcessSet] = None
                   ) -> torch.Tensor:
    """Adasum over the set by the pairing ladder (JAX `adasum_in_axis`).

    Level d = 1, 2, 4, ...: rank r exchanges its current vector with
    rank r ^ d (one `isend`/`irecv` pair, posted together) and combines,
    the lower index as `a`.  After log2(n) levels every rank holds what
    `adasum_tree_reduce` computes on the stacked vectors.  For n = 2^k +
    r, ranks k..n-1 first send their vectors to ranks 0..r-1, which
    combine once more (the unbalanced leaves of the tree), sit out the
    ladder, and receive the result with one last hop."""
    from . import collectives as C

    ps = C._resolve_set(process_set)
    n, idx = ps.size(), ps.rank()
    v = x.detach()
    k = _pow2_floor(n)
    r = n - k
    if r and (idx >= k or idx < r):
        w = torch.empty_like(v) if idx < r else None
        C.sendrecv(ps, v if idx >= k else None, idx - k, w, k + idx)
        if idx < r:
            v = _pair_combine(v, w)
    d = 1
    while d < k:
        if idx < k:
            w = torch.empty_like(v)
            C.sendrecv(ps, v, idx ^ d, w, idx ^ d)
            v = _pair_combine(v, w) if idx & d == 0 else _pair_combine(w, v)
        d *= 2
    if r and (idx >= k or idx < r):
        w = torch.empty_like(v) if idx >= k else None
        C.sendrecv(ps, v if idx < r else None, k + idx, w, idx - k)
        if idx >= k:
            v = w
    return v


def adasum_allreduce(tensor: torch.Tensor,
                     process_set: Optional[ProcessSet] = None
                     ) -> torch.Tensor:
    """Eager entry used by `allreduce(op=Adasum)`: the ladder
    (`adasum_in_axis`) when the set has more than one rank, else a copy
    of the tensor (allreduce returns a new tensor)."""
    from . import collectives as C

    ps = C._resolve_set(process_set)
    if ps.size() == 1:
        return tensor.detach().clone()
    with record_function("hvd.adasum.ladder"):
        return adasum_in_axis(tensor, ps)


def adasum_reference(arrays):
    """NumPy f64 reference model of the Adasum recursion (own copy of the
    JAX package's `adasum_reference`)."""
    arrays = [np.asarray(a, np.float64) for a in arrays]

    def pair(a, b):
        dot = float(np.vdot(a.ravel(), b.ravel()))
        na = float(np.vdot(a.ravel(), a.ravel()))
        nb = float(np.vdot(b.ravel(), b.ravel()))
        ca = 1.0 - dot / (2 * na) if na > _EPS else 1.0
        cb = 1.0 - dot / (2 * nb) if nb > _EPS else 1.0
        return ca * a + cb * b

    n = len(arrays)
    if n & (n - 1):
        k = _pow2_floor(n)
        r = n - k
        arrays = ([pair(arrays[i], arrays[k + i]) for i in range(r)]
                  + arrays[r:k])
    while len(arrays) > 1:
        arrays = [pair(arrays[i], arrays[i + 1])
                  for i in range(0, len(arrays), 2)]
    return arrays[0]
