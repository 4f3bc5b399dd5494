"""Expert parallelism: the Switch MoE layer over an `ep` set.

Counterpart of `horovod_tpu/parallel/moe.py`.  Top-1 gating builds
one-hot dispatch and combine tensors [T, E, C]; tokens reach their
experts' owners by a tiled all-to-all over the set and come back by its
exact inverse; each expert FFN (relu MLP) is one batched matmul.  The
expert matmuls stay `torch.einsum`: the JAX package computes them
outside any Pallas kernel.

Capacity: each expert takes at most
capacity = ceil(tokens_per_shard / n_experts) · capacity_factor tokens
of a shard, counted from the shard's LOCAL tokens, in token order;
tokens past it are dropped (they pass through the residual).  So a
sharded run routes as the JAX package's sharded run does, not as the
dense model over the whole batch.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..common.basics import ProcessSet
from . import _collectives as pc


def moe_init(gen: torch.Generator, n_experts: int, d_model: int, d_ff: int,
             dtype=torch.float32) -> Dict:
    """Stacked expert FFN weights with a leading expert axis [E, ...]
    (sharded over `ep` by the caller), and the gate kernel [D, E]: the
    JAX initializer's shapes and scales (the same distributions, not the
    same numbers)."""
    scale_in = 1.0 / math.sqrt(d_model)
    scale_out = 1.0 / math.sqrt(d_ff)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dtype)

    return {
        "gate": {"kernel": normal((d_model, n_experts), scale_in)},
        "wi": normal((n_experts, d_model, d_ff), scale_in),
        "wo": normal((n_experts, d_ff, d_model), scale_out),
    }


def top1_route(logits: torch.Tensor):
    """(probs f32, expert_idx, gate): softmax in f32, argmax (the first
    of equal maxima, as jnp.argmax), the winning probability."""
    probs = torch.softmax(logits.float(), dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, -1, expert_idx[:, None])[:, 0]
    return probs, expert_idx, gate


def _gating(logits: torch.Tensor, n_experts: int, capacity: int):
    """Top-1 gating: dispatch [T, E, C] (0/1 f32), combine [T, E, C]
    (f32 weights), expert_idx [T], probs [T, E].  T = local tokens;
    queue positions by a cumulative sum, drops past capacity."""
    probs, expert_idx, gate = top1_route(logits)
    onehot = F.one_hot(expert_idx, n_experts).float()
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0          # [T, E]
    keep = (pos >= 0) & (pos < capacity)
    # one_hot of a position outside [0, capacity) is all zeros, as in jax.
    pos_i = pos.long()
    inside = (pos_i >= 0) & (pos_i < capacity)
    pos_oh = F.one_hot(torch.where(inside, pos_i, 0), capacity).float() \
        * inside[..., None]
    dispatch = pos_oh * keep[..., None]
    combine = dispatch * gate[:, None, None]
    return dispatch, combine, expert_idx, probs


def _capacity(tokens: int, n_experts: int, capacity_factor: float) -> int:
    return max(1, int(math.ceil(tokens / n_experts) * capacity_factor))


def _expert_ffn(expert_inputs, params, dtype):
    h = torch.relu(torch.einsum("ecd,edf->ecf", expert_inputs,
                                params["wi"].to(dtype)))
    return torch.einsum("ecf,efd->ecd", h, params["wo"].to(dtype))


def moe_apply_shard(params: Dict, x: torch.Tensor, ps: ProcessSet,
                    capacity_factor: float = 1.25,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, Dict]:
    """Switch MoE on this rank's tokens, the experts sharded over the set
    `ps`: `params["wi"]` / `["wo"]` hold this rank's E/ep experts, the
    gate kernel [D, E] all of them.

    x [B, T_local, D].  Returns (out [B, T_local, D], {"aux_loss",
    "frac_tokens", "frac_probs"}): the Switch load-balancing loss
    E · Σₑ frac_tokensₑ · frac_probsₑ, and its two fractions [E],
    averaged over the set.  frac_tokens carries no gradient,
    so every rank of the set gives frac_probs the same cotangent, and
    its mean's backward is the identity (`reduce_from`)."""
    ep = ps.size()
    B, Tl, D = x.shape
    e_local = params["wi"].shape[0]
    E = e_local * ep
    if params["gate"]["kernel"].shape[-1] != E:
        raise ValueError(
            f"gate kernel expects {params['gate']['kernel'].shape[-1]} "
            f"experts, but sharded weights imply {E}")
    tokens = x.reshape(B * Tl, D)
    dtype = compute_dtype or x.dtype
    logits = tokens.to(dtype) @ params["gate"]["kernel"].to(dtype)
    dispatch, combine, expert_idx, probs = _gating(
        logits, E, _capacity(B * Tl, E, capacity_factor))

    with torch.no_grad():
        frac_tokens = pc.pmean(F.one_hot(expert_idx, E).float().mean(0), ps,
                               name="hvd.ep.psum")
    frac_probs = pc.reduce_from(probs.mean(0), ps, name="hvd.ep.psum",
                                scale=1.0 / ep)
    aux_loss = E * torch.sum(frac_tokens * frac_probs)

    # [T, E, C] x [T, D] -> [E, C, D]; expert groups to their owners:
    # [e_local, ep*C, D] (peer-major queue order); the way back is the
    # exact inverse, restoring the gate's global expert order.
    expert_inputs = torch.einsum("tec,td->ecd", dispatch.to(dtype),
                                 tokens.to(dtype))
    expert_inputs = pc.all_to_all_tiled(expert_inputs, 0, 1, ps,
                                        name="hvd.ep.a2a")
    expert_out = _expert_ffn(expert_inputs, params, dtype)
    expert_out = pc.all_to_all_tiled(expert_out, 1, 0, ps,
                                     name="hvd.ep.a2a")
    out = torch.einsum("tec,ecd->td", combine.to(dtype), expert_out)
    return out.reshape(B, Tl, D).to(x.dtype), {
        "aux_loss": aux_loss, "frac_tokens": frac_tokens,
        "frac_probs": frac_probs}


def moe_apply_dense(params: Dict, x: torch.Tensor,
                    capacity_factor: float = 1.25,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, Dict]:
    """The single-device form: the same math with ep = 1 (the same aux
    dict)."""
    B, Tl, D = x.shape
    E = params["wi"].shape[0]
    tokens = x.reshape(B * Tl, D)
    dtype = compute_dtype or x.dtype
    logits = tokens.to(dtype) @ params["gate"]["kernel"].to(dtype)
    dispatch, combine, expert_idx, probs = _gating(
        logits, E, _capacity(B * Tl, E, capacity_factor))
    frac_tokens = F.one_hot(expert_idx, E).float().mean(0)
    frac_probs = probs.mean(0)
    aux_loss = E * torch.sum(frac_tokens * frac_probs)
    expert_inputs = torch.einsum("tec,td->ecd", dispatch.to(dtype),
                                 tokens.to(dtype))
    expert_out = _expert_ffn(expert_inputs, params, dtype)
    out = torch.einsum("tec,ecd->td", combine.to(dtype), expert_out)
    return out.reshape(B, Tl, D).to(x.dtype), {
        "aux_loss": aux_loss, "frac_tokens": frac_tokens,
        "frac_probs": frac_probs}
