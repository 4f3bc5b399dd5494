"""The flagship decoder-only transformer LM as an `nn.Module`, dense and
on one replica.

Counterpart of the single-device reference of
`horovod_tpu/models/transformer.py` (`transformer_ref_apply`,
`transformer_ref_loss`): pre-norm blocks of RoPE attention and a SwiGLU
MLP, RMSNorm, a head tied to the embedding, logits in f32 and a fused
logsumexp-minus-picked cross-entropy.  Parameters are f32 and keep the
JAX shapes (wq [D, H, Dh], wo [H, Dh, D], wi [D, F], ...), so
`convert.transformer_from_jax` copies them leaf for leaf; compute runs
in `compute_dtype` as in the JAX package.  Attention goes through
`parallel.sequence.full_attention`, which routes to the flash kernels
(K4-K6).  The projections are plain matmuls (cuBLAS), as the JAX
package leaves them to XLA.

    model = Transformer(TransformerConfig(), seed=0).to("cuda")
    loss = model.loss(tokens, targets)      # tokens, targets: [B, T] int

Not ported yet: MoE layers (`moe_every > 0` raises), the tp / sp / pp /
ep mesh axes of `make_train_step`, and `stack_for_pipeline`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import sequence as seq_mod


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    d_head: int = 64
    d_ff: int = 2048
    n_layers: int = 8
    moe_every: int = 0          # 0 = dense; MoE is not ported yet
    rope_theta: float = 10000.0
    compute_dtype: torch.dtype = torch.bfloat16
    n_kv_heads: int = 0         # 0 = MHA; else GQA/MQA kv head count
    attn_window: int = 0        # 0 = full causal; else sliding window

    def __post_init__(self):
        if self.attn_window < 0:
            raise ValueError(
                f"attn_window must be >= 0, got {self.attn_window}")
        if self.n_kv_heads < 0 or (
                self.n_kv_heads and self.n_heads % self.n_kv_heads):
            raise ValueError(
                f"n_kv_heads ({self.n_kv_heads}) must be 0 (MHA) or a "
                f"divisor of n_heads ({self.n_heads})")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding: x [B, T, H, Dh], positions [T].  The result is
    f32 (x times f32 angles), as in the JAX package."""
    Dh = x.shape[-1]
    freqs = theta ** (-torch.arange(0, Dh, 2, dtype=torch.float32,
                                    device=x.device) / Dh)
    angles = positions[:, None].float() * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def _rmsnorm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Next-token loss: mean(logsumexp(logits) - picked logit)."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - picked).mean()


class TiedHead(torch.autograd.Function):
    """The tied head's logits: h [B, T, D] against the embedding [V, D],
    both rounded to `dt` (compute_dtype), products summed in f32, logits
    [B, T, V] f32 (the JAX head's `preferred_element_type=float32`).

    Forward: on a CUDA tensor with a 16-bit `dt`, one tensor-core GEMM
    with f32 output (`torch.mm(..., out_dtype=torch.float32)`): a
    16-bit by 16-bit product is exact in f32, so it differs from the f32
    GEMM of the upcast operands only in the order of the sums over D.
    Otherwise (the CPU, or an f32 `dt`) the plain version: that f32
    einsum of the upcast operands.

    Backward: the products autograd takes through the plain version's
    einsum (a bmm of the f32 cotangent with the f32-upcast operands,
    strides and all), each gradient rounded through `dt` by the casts,
    so both gradients are those of the plain version."""

    @staticmethod
    def forward(ctx, h, embed, dt):
        hc, ec = h.to(dt), embed.to(dt)
        ctx.save_for_backward(hc, ec)
        ctx.dtypes = (h.dtype, embed.dtype, dt)
        if hc.is_cuda and dt in (torch.bfloat16, torch.float16):
            b, t, d = hc.shape
            return torch.mm(hc.reshape(b * t, d), ec.t(),
                            out_dtype=torch.float32).reshape(b, t, -1)
        return torch.einsum("btd,vd->btv", hc.float(), ec.float())

    @staticmethod
    def backward(ctx, g):
        hc, ec = ctx.saved_tensors
        h_dtype, e_dtype, dt = ctx.dtypes
        b, t, d = hc.shape
        hf, ef = hc.float(), ec.float()
        g3 = g.reshape(1, b * t, -1)
        # einsum ran bmm(h (1, BT, D), embed viewed (1, D, V)); its
        # backward: g @ (1, V, D), and (1, D, BT) @ g.
        dh = torch.bmm(g3, ef.unsqueeze(0)).reshape(b, t, d)
        de = torch.bmm(hf.reshape(1, b * t, d).transpose(1, 2), g3)[0].t()
        return dh.to(dt).to(h_dtype), de.to(dt).to(e_dtype), None


def _normal(shape, scale: float, g: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=g) * scale)


class Block(nn.Module):
    """One layer: pre-norm attention with RoPE, then the SwiGLU MLP."""

    def __init__(self, cfg: TransformerConfig, g: torch.Generator):
        super().__init__()
        D, H, Dh, F_, Hkv = (cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff,
                             cfg.kv_heads)
        s_d, s_f = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F_)
        self.cfg = cfg
        self.ln1 = nn.Parameter(torch.ones(D))
        self.ln2 = nn.Parameter(torch.ones(D))
        self.wq = _normal((D, H, Dh), s_d, g)
        self.wk = _normal((D, Hkv, Dh), s_d, g)
        self.wv = _normal((D, Hkv, Dh), s_d, g)
        self.wo = _normal((H, Dh, D), 1.0 / math.sqrt(H * Dh), g)
        self.wi = _normal((D, F_), s_d, g)
        self.wg = _normal((D, F_), s_d, g)
        self.wd = _normal((F_, D), s_f, g)

    def attention(self, x, positions, attn: Callable):
        dt = self.cfg.compute_dtype
        h = _rmsnorm(self.ln1, x)
        q = torch.einsum("btd,dhk->bthk", h, self.wq.to(dt))
        k = torch.einsum("btd,dhk->bthk", h, self.wk.to(dt))
        v = torch.einsum("btd,dhk->bthk", h, self.wv.to(dt))
        q = _rope(q, positions, self.cfg.rope_theta).to(dt)
        k = _rope(k, positions, self.cfg.rope_theta).to(dt)
        o = attn(q, k, v, causal=True, window=self.cfg.attn_window or None)
        out = torch.einsum("bthk,hkd->btd", o, self.wo.to(dt))
        return x + out.to(x.dtype)

    def mlp(self, x):
        dt = self.cfg.compute_dtype
        h = _rmsnorm(self.ln2, x)
        up = h @ self.wi.to(dt)
        gate = F.silu(h @ self.wg.to(dt))
        return x + ((up * gate) @ self.wd.to(dt)).to(x.dtype)

    def forward(self, x, positions, attn: Callable):
        return self.mlp(self.attention(x, positions, attn))


class Transformer(nn.Module):
    """The dense LM.  Weights are drawn on the CPU from
    `torch.Generator().manual_seed(seed)` with the JAX initializer's
    scales (the same distributions, not the same numbers)."""

    def __init__(self, cfg: TransformerConfig = TransformerConfig(),
                 seed: int = 0):
        super().__init__()
        if cfg.moe_every:
            raise NotImplementedError(
                "MoE layers (moe_every > 0) are not ported yet; the port "
                "runs the dense transformer")
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        self.embed = _normal((cfg.vocab_size, cfg.d_model),
                             1.0 / math.sqrt(cfg.d_model), g)
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model))
        self.blocks = nn.ModuleList(Block(cfg, g)
                                    for _ in range(cfg.n_layers))

    def hidden(self, tokens: torch.Tensor,
               attn: Optional[Callable] = None) -> torch.Tensor:
        """tokens [B, T] -> the final-normed activations [B, T, D] in
        compute_dtype.  `attn` replaces `full_attention` (a check runs
        the plain attention through it)."""
        attn = attn or seq_mod.full_attention
        x = self.embed[tokens].to(self.cfg.compute_dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for block in self.blocks:
            x = block(x, positions, attn)
        return _rmsnorm(self.final_norm, x)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The head tied to the embedding: h [B, T, D] -> logits
        [B, T, V] f32, inputs in compute_dtype and the products summed in
        f32 (the JAX head's preferred_element_type; `TiedHead`)."""
        return TiedHead.apply(h, self.embed, self.cfg.compute_dtype)

    def forward(self, tokens: torch.Tensor,
                attn: Optional[Callable] = None) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] f32."""
        return self.head(self.hidden(tokens, attn))

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor,
             attn: Optional[Callable] = None) -> torch.Tensor:
        """Next-token loss of `forward(tokens, attn)` (`lm_loss`)."""
        return lm_loss(self.forward(tokens, attn), targets)
