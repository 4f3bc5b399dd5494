"""The flagship decoder-only transformer LM: dense on one replica as an
`nn.Module`, and sharded over a dp × pp × ep × tp × sp mesh by
`make_train_step`.

Counterpart of `horovod_tpu/models/transformer.py`: pre-norm blocks of
RoPE attention and a SwiGLU MLP (every `moe_every`-th MLP a Switch MoE
layer, `parallel/moe.py`), RMSNorm, a head tied to the embedding,
logits in f32 and a fused logsumexp-minus-picked cross-entropy plus the
weighted MoE balance loss.  Parameters are f32 and keep the JAX shapes
(wq [D, H, Dh], wo [H, Dh, D], wi [D, F], ...); compute runs in
`compute_dtype`.  Attention goes through `parallel.sequence`, which
routes to the flash kernels (K4-K6).  The projections and expert
matmuls are plain matmuls (cuBLAS), as the JAX package leaves them to
XLA.

    model = Transformer(TransformerConfig(), seed=0).to("cuda")
    loss = model.loss(tokens, targets)      # tokens, targets: [B, T] int

The mesh: `transformer_init` gives the JAX layout (layer-stacked
leaves [L, ...]); `make_train_step(mesh, cfg, optimizer)` gives
`shard_state`, which keeps only this rank's shards (by
`transformer_pspecs`, after `stack_for_pipeline` when pp > 1), and
`train_step`, which runs the shard forward (`_forward_shard`: heads and
d_ff over tp with Megatron's pair, the sequence over sp by ring
attention or Ulysses, experts over ep, GPipe over pp), backward from
this rank's part of the loss, sums each gradient over the mesh axes
along which its parameter is replicated (`_reduce_grads`), so that it is
the dense gradient's shard, and steps a `torch.optim` optimizer.
"""

from __future__ import annotations

import dataclasses
import math
import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..common import basics
from ..common.exceptions import HorovodTpuError
from ..parallel import _collectives as pc
from ..parallel import moe as moe_mod
from ..parallel import sequence as seq_mod
from ..parallel.mesh import Mesh
from ..parallel.pipeline import gpipe_shard


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    d_head: int = 64
    d_ff: int = 2048
    n_layers: int = 8
    moe_every: int = 0          # 0 = dense; k = every k-th layer is MoE
    n_experts: int = 8
    capacity_factor: float = 1.25
    rope_theta: float = 10000.0
    compute_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "ring"     # "ring" | "ulysses" (used when sp > 1)
    aux_loss_weight: float = 0.01
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


def head_logits(h: torch.Tensor, embed: torch.Tensor, dt) -> torch.Tensor:
    """The tied head's forward (`TiedHead`), with no autograd: h [B, T,
    D] against embed [V, D], both rounded to `dt`, logits [B, T, V] f32."""
    hc, ec = h.to(dt), embed.to(dt)
    if hc.is_cuda and dt in (torch.bfloat16, torch.float16):
        b, t, d = hc.shape
        return torch.mm(hc.reshape(b * t, d), ec.t(),
                        out_dtype=torch.float32).reshape(b, t, -1)
    return torch.einsum("btd,vd->btv", hc.float(), ec.float())


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
        return head_logits(hc, ec, dt)

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


def _is_moe_layer(cfg: TransformerConfig, i: int) -> bool:
    return bool(cfg.moe_every) and (i + 1) % cfg.moe_every == 0


# ---------------------------------------------------------------------------
# Layer math on a parameter tree (full or this rank's shards).  `tp`,
# `sp`, `ep`: the mesh axis' ProcessSet, or None where the axis is
# absent (the dense model passes None for all).
# ---------------------------------------------------------------------------

def _attention_block(lp, x, positions, cfg: TransformerConfig, tp=None,
                     sp=None, attn: Optional[Callable] = None):
    """Pre-norm attention with RoPE on the heads this rank holds (heads
    over tp: wq/wk/wv column-parallel, wo row-parallel), the sequence
    over sp (ring attention, or Ulysses with the kv heads repeated
    before its all-to-all).  `attn` replaces `full_attention` where
    there is no sp (a check runs the plain attention through it)."""
    dt = cfg.compute_dtype
    h = _rmsnorm(lp["ln1"]["scale"], x)
    if tp is not None:
        h = pc.copy_to(h, tp)
    q = torch.einsum("btd,dhk->bthk", h, lp["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", h, lp["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", h, lp["wv"].to(dt))
    q = _rope(q, positions, cfg.rope_theta).to(dt)
    k = _rope(k, positions, cfg.rope_theta).to(dt)
    window = cfg.attn_window or None
    if sp is not None:
        if cfg.attn_impl == "ulysses":
            k, v = seq_mod.repeat_kv(q, k, v)
            o = seq_mod.ulysses_attention_shard(q, k, v, sp, window=window)
        else:
            o = seq_mod.ring_attention_shard(q, k, v, sp, window=window)
    else:
        o = (attn or seq_mod.full_attention)(q, k, v, causal=True,
                                             window=window)
    out = torch.einsum("bthk,hkd->btd", o, lp["wo"].to(dt))
    if tp is not None:
        out = pc.reduce_from(out, tp)   # row-parallel wo
    return x + out.to(x.dtype)


def _mlp_block(lp, x, cfg: TransformerConfig, tp=None):
    """Pre-norm SwiGLU MLP; d_ff over tp (wi/wg column, wd row)."""
    dt = cfg.compute_dtype
    h = _rmsnorm(lp["ln2"]["scale"], x)
    if tp is not None:
        h = pc.copy_to(h, tp)
    up = h @ lp["wi"].to(dt)
    gate = F.silu(h @ lp["wg"].to(dt))
    out = (up * gate) @ lp["wd"].to(dt)
    if tp is not None:
        out = pc.reduce_from(out, tp)
    return x + out.to(x.dtype)


def _moe_block(mp, scale, x, cfg: TransformerConfig, ep=None, stats=None):
    """The MoE layer in place of the MLP; reuses the layer's ln2 scale.
    Appends the layer's aux dict to `stats` when given."""
    h = _rmsnorm(scale, x)
    if ep is not None:
        out, aux = moe_mod.moe_apply_shard(
            mp, h, ep, capacity_factor=cfg.capacity_factor,
            compute_dtype=cfg.compute_dtype)
    else:
        out, aux = moe_mod.moe_apply_dense(
            mp, h, capacity_factor=cfg.capacity_factor,
            compute_dtype=cfg.compute_dtype)
    if stats is not None:
        stats.append(aux)
    return x + out.to(x.dtype), aux["aux_loss"]


def _index(tree, j: int):
    return {k: _index(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


def _layer_seq(block_params, moe_params, x, positions, cfg, layer_offset: int,
               n_layers: int, tp=None, sp=None, ep=None, attn=None,
               stats=None):
    """`n_layers` consecutive layers from global index `layer_offset`;
    the parameters carry a leading [n_layers] (and [n_moe]) axis.
    Returns (x, the layers' summed aux loss); `stats` collects the MoE
    layers' aux dicts."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    moe_idx = 0
    for j in range(n_layers):
        lp = _index(block_params, j)
        x = _attention_block(lp, x, positions, cfg, tp, sp, attn)
        if _is_moe_layer(cfg, layer_offset + j):
            x, aux = _moe_block(_index(moe_params, moe_idx),
                                lp["ln2"]["scale"], x, cfg, ep, stats)
            aux_total = aux_total + aux
            moe_idx += 1
        else:
            x = _mlp_block(lp, x, cfg, tp)
    return x, aux_total


# ---------------------------------------------------------------------------
# The dense model
# ---------------------------------------------------------------------------

_BLOCK_LEAVES = ("wq", "wk", "wv", "wo", "wi", "wg", "wd")


class MoE(nn.Module):
    """One MoE layer's parameters: gate [D, E], wi [E, D, F], wo
    [E, F, D] (`moe.moe_init`)."""

    def __init__(self, cfg: TransformerConfig, g: torch.Generator):
        super().__init__()
        p = moe_mod.moe_init(g, cfg.n_experts, cfg.d_model, cfg.d_ff)
        self.gate = nn.Parameter(p["gate"]["kernel"])
        self.wi = nn.Parameter(p["wi"])
        self.wo = nn.Parameter(p["wo"])

    def tree(self) -> dict:
        return {"gate": {"kernel": self.gate}, "wi": self.wi, "wo": self.wo}


class Block(nn.Module):
    """One layer: pre-norm attention with RoPE, then the SwiGLU MLP (or,
    on an MoE layer, `moe`: the MLP's weights are kept but unused, as in
    the JAX tree)."""

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
        self.moe: Optional[MoE] = None

    def tree(self) -> dict:
        """The layer's parameters as the JAX tree names them."""
        return {"ln1": {"scale": self.ln1}, "ln2": {"scale": self.ln2},
                **{n: getattr(self, n) for n in _BLOCK_LEAVES}}

    def forward(self, x, positions, attn: Callable):
        """-> (x, this layer's aux loss, or None on a dense layer)."""
        lp = self.tree()
        x = _attention_block(lp, x, positions, self.cfg, attn=attn)
        if self.moe is not None:
            return _moe_block(self.moe.tree(), self.ln2, x, self.cfg)
        return _mlp_block(lp, x, self.cfg), None


class Transformer(nn.Module):
    """The dense LM.  Weights are drawn on the CPU from
    `torch.Generator().manual_seed(seed)` with the JAX initializer's
    scales (the same distributions, not the same numbers); the MoE
    layers' after every block's."""

    def __init__(self, cfg: TransformerConfig = TransformerConfig(),
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        self.embed = _normal((cfg.vocab_size, cfg.d_model),
                             1.0 / math.sqrt(cfg.d_model), g)
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model))
        self.blocks = nn.ModuleList(Block(cfg, g)
                                    for _ in range(cfg.n_layers))
        for i, block in enumerate(self.blocks):
            if _is_moe_layer(cfg, i):
                block.moe = MoE(cfg, g)

    def hidden_aux(self, tokens: torch.Tensor,
                   attn: Optional[Callable] = None):
        """tokens [B, T] -> (the final-normed activations [B, T, D] in
        compute_dtype, the MoE layers' summed aux loss, or None)."""
        x = self.embed[tokens].to(self.cfg.compute_dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        aux_total = None
        for block in self.blocks:
            x, aux = block(x, positions, attn)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        return _rmsnorm(self.final_norm, x), aux_total

    def hidden(self, tokens: torch.Tensor,
               attn: Optional[Callable] = None) -> torch.Tensor:
        """tokens [B, T] -> the final-normed activations [B, T, D] in
        compute_dtype.  `attn` replaces `full_attention` (a check runs
        the plain attention through it)."""
        return self.hidden_aux(tokens, attn)[0]

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
        """Next-token loss (`lm_loss`), plus aux_loss_weight times the
        MoE layers' aux loss when there are any (JAX
        `transformer_ref_loss`)."""
        h, aux = self.hidden_aux(tokens, attn)
        loss = lm_loss(self.head(h), targets)
        if aux is not None:
            loss = loss + self.cfg.aux_loss_weight * aux
        return loss


# ---------------------------------------------------------------------------
# Parameter trees in the JAX layout
# ---------------------------------------------------------------------------

def transformer_params(model: Transformer) -> Dict:
    """The model's parameters as the JAX tree: {"embed", "final_norm":
    {"scale"}, "blocks": {leaf: [L, ...]}, "moe": {"gate": {"kernel"},
    "wi", "wo"} with [n_moe, ...]} (copies, f32, on the model's
    device)."""
    trees = [b.tree() for b in model.blocks]

    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        return torch.stack([t.detach() for t in ts]).clone()

    params = {"embed": model.embed.detach().clone(),
              "final_norm": {"scale": model.final_norm.detach().clone()},
              "blocks": stack(trees)}
    moes = [b.moe.tree() for b in model.blocks if b.moe is not None]
    if moes:
        params["moe"] = stack(moes)
    return params


def transformer_init(seed: int, cfg: TransformerConfig) -> Dict:
    """The parameters of `Transformer(cfg, seed)` in the JAX layout
    (`transformer_params`), on the CPU."""
    return transformer_params(Transformer(cfg, seed))


def tree_leaves(tree, prefix: Tuple[str, ...] = ()
                ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of a nested dict, in its insertion order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += tree_leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the same paths of `rest`)."""
    return {k: tree_map(fn, v, *[r[k] for r in rest]) if isinstance(v, dict)
            else fn(v, *[r[k] for r in rest]) for k, v in tree.items()}


def stack_for_pipeline(params: Dict, pp: int, cfg: TransformerConfig) -> Dict:
    """Reshape the layer-stacked [L, ...] leaves to [pp, L/pp, ...] (and
    the MoE leaves [Lm, ...] to [pp, Lm/pp, ...]) for the pp-sharded
    specs."""
    if pp <= 1:
        return params
    L = cfg.n_layers
    if L % pp:
        raise ValueError(f"n_layers {L} not divisible by pp {pp}")
    if cfg.moe_every and (L // pp) % cfg.moe_every:
        raise ValueError(
            f"layers-per-stage {L // pp} must be a multiple of "
            f"moe_every {cfg.moe_every} so stages are uniform")
    out = dict(params)
    out["blocks"] = tree_map(
        lambda p: p.reshape((pp, L // pp) + tuple(p.shape[1:])),
        params["blocks"])
    if "moe" in params:
        Lm = tree_leaves(params["moe"])[0][1].shape[0]
        out["moe"] = tree_map(
            lambda p: p.reshape((pp, Lm // pp) + tuple(p.shape[1:])),
            params["moe"])
    return out


def unstack_pipeline(params: Dict) -> Dict:
    """The inverse of `stack_for_pipeline`: [pp, L/pp, ...] block (and
    MoE) leaves back to [L, ...]."""
    out = dict(params)
    for key in ("blocks", "moe"):
        if key in params:
            out[key] = tree_map(
                lambda p: p.reshape((-1,) + tuple(p.shape[2:])), params[key])
    return out


def transformer_pspecs(cfg: TransformerConfig, pp: int = 1) -> Dict:
    """The spec of every leaf of `transformer_init`'s tree (after
    `stack_for_pipeline` when pp > 1): per dimension the mesh axis it is
    sharded over, or None (the JAX PartitionSpecs as tuples).  wk/wv
    shard their heads over tp like wq, so GQA needs n_kv_heads % tp ==
    0."""
    lead = ("pp",) if pp > 1 else ()

    def bspec(*rest):
        return (*lead, None, *rest)   # [pp?, L(/pp), ...]

    specs = {
        "embed": (None, None),
        "final_norm": {"scale": (None,)},
        "blocks": {
            "ln1": {"scale": bspec(None)},
            "ln2": {"scale": bspec(None)},
            "wq": bspec(None, "tp", None),
            "wk": bspec(None, "tp", None),
            "wv": bspec(None, "tp", None),
            "wo": bspec("tp", None, None),
            "wi": bspec(None, "tp"),
            "wg": bspec(None, "tp"),
            "wd": bspec("tp", None),
        },
    }
    if cfg.moe_every:
        specs["moe"] = {
            "gate": {"kernel": bspec(None, None)},
            "wi": bspec("ep", None, None),
            "wo": bspec("ep", None, None),
        }
    return specs


def shard_leaf(a, spec, mesh: Mesh):
    """This rank's block of the full array `a` (numpy or torch) under
    `spec`."""
    for dim, axis in enumerate(spec):
        n = mesh.size(axis) if axis else 1
        if n > 1:
            if a.shape[dim] % n:
                raise HorovodTpuError(
                    f"dim {dim} of {tuple(a.shape)} does not split over "
                    f"{axis}={n}")
            c = a.shape[dim] // n
            i = mesh.index(axis)
            a = a[(slice(None),) * dim + (slice(i * c, (i + 1) * c),)]
    return a


def shard_params(params: Dict, cfg: TransformerConfig, mesh: Mesh) -> Dict:
    """This rank's shards of the full tree (`transformer_init`'s layout;
    stacked for the pipeline here when pp > 1), sliced by
    `transformer_pspecs`: the counterpart of `shard_state`'s placement."""
    pp = mesh.size("pp")
    return tree_map(lambda a, s: shard_leaf(a, s, mesh),
                    stack_for_pipeline(params, pp, cfg),
                    transformer_pspecs(cfg, pp))


def _gather_dim(t: torch.Tensor, dim: int, ps) -> torch.Tensor:
    from ..ops import collectives as C

    moved = t.detach().movedim(dim, 0).contiguous()
    return C.allgather(moved, process_set=ps).movedim(0, dim)


def unshard(shards: Dict, cfg: TransformerConfig, mesh: Mesh) -> Dict:
    """The full tree from every rank's shards (allgathers over each
    sharded axis; collective over the mesh), in the pp-stacked layout
    when pp > 1.  Every rank gets the same tree."""
    def full(t, spec):
        for dim, axis in enumerate(spec):
            if axis and mesh.size(axis) > 1:
                t = _gather_dim(t, dim, mesh.sets[axis])
        return t
    return tree_map(full, shards, transformer_pspecs(cfg, mesh.size("pp")))


def tree_digest(tree: Dict) -> str:
    """SHA-256 of the leaves (as f32, in tree order)."""
    h = hashlib.sha256()
    for _, leaf in tree_leaves(tree):
        h.update(leaf.detach().float().cpu().clone().numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# The shard forward and loss
# ---------------------------------------------------------------------------

def _forward_shard(params, tokens, cfg: TransformerConfig, mesh: Mesh,
                   n_microbatches: int):
    """Per-shard forward: tokens [B_local, T_local] -> (x [B_local,
    T_local, D], aux loss)."""
    tp, sp, ep = mesh.on("tp"), mesh.on("sp"), mesh.on("ep")
    pp = mesh.on("pp")
    Tl = tokens.shape[1]
    sp_off = mesh.index("sp") * Tl if sp is not None else 0
    positions = sp_off + torch.arange(Tl, device=tokens.device)
    x = params["embed"][tokens].to(cfg.compute_dtype)
    if pp is None:
        return _layer_seq(params["blocks"], params.get("moe"), x, positions,
                          cfg, 0, cfg.n_layers, tp, sp, ep)

    # Pipeline: the blocks arrive as [1, L/pp, ...].  The layer pattern
    # is stage-periodic (stack_for_pipeline checks), so every stage runs
    # the same program from layer offset 0.  The aux loss is not
    # threaded through the pipeline: with pp > 1 it is left out, as in
    # the JAX package.
    stage = {"blocks": _index(params["blocks"], 0)}
    if "moe" in params:
        stage["moe"] = _index(params["moe"], 0)
    l_per_stage = stage["blocks"]["wq"].shape[0]

    def stage_fn(sp_params, h):
        return _layer_seq(sp_params["blocks"], sp_params.get("moe"), h,
                          positions, cfg, 0, l_per_stage, tp, sp, ep)[0]

    B, M = x.shape[0], n_microbatches
    if B % M != 0:
        raise HorovodTpuError(
            f"local batch {B} not divisible by {M} microbatches")
    out = gpipe_shard(stage_fn, stage, x.reshape((M, B // M) + x.shape[1:]),
                      pp)
    return out.reshape((B,) + out.shape[2:]), None


def _batch_axes(mesh: Mesh) -> List[str]:
    return [a for a in ("dp", "ep", "sp", "pp") if mesh.size(a) > 1]


def _loss_shard(params, tokens, targets, cfg: TransformerConfig, mesh: Mesh,
                n_microbatches: int, count: int):
    """(this rank's objective, the loss).

    The loss is JAX `_loss_shard`'s: the mean cross-entropy over every
    token of the global batch (`count` of them; under pp only the last
    stage's head counts), plus aux_loss_weight times the aux loss
    averaged over dp/ep/sp (left out under pp).  The objective is this
    rank's part of it, so that the objectives of the ranks (one per tp
    group) add up to the loss: the cross-entropy sum of its tokens over
    `count`, and its aux loss over the number of dp·ep·sp ranks."""
    x, aux = _forward_shard(params, tokens, cfg, mesh, n_microbatches)
    x = _rmsnorm(params["final_norm"]["scale"], x)
    logits = TiedHead.apply(x, params["embed"], cfg.compute_dtype)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    local_sum = (lse - picked).sum()
    if mesh.size("pp") > 1:
        local_sum = local_sum * float(mesh.index("pp") == mesh.size("pp") - 1)
    obj = local_sum / count
    with_aux = cfg.moe_every and mesh.size("pp") == 1
    n_aux = 1
    for a in ("dp", "ep", "sp"):
        n_aux *= mesh.size(a)
    if with_aux:
        obj = obj + cfg.aux_loss_weight * aux / n_aux
    parts = torch.stack([local_sum.detach(),
                         aux.detach() if with_aux else local_sum.new_zeros(())])
    with record_function("hvd.mesh.loss_sum"):
        for a in _batch_axes(mesh):
            parts = pc._sum(parts, mesh.sets[a])
    loss = parts[0] / count
    if with_aux:
        loss = loss + cfg.aux_loss_weight * parts[1] / n_aux
    return obj, loss


def reference_loss(params: Dict, tokens: torch.Tensor,
                   targets: torch.Tensor, cfg: TransformerConfig,
                   dp: int = 1, ep: int = 1, pp: int = 1) -> float:
    """The loss a mesh step reports, computed on one rank with the dense
    layers (no_grad): the full parameters (`transformer_init`'s layout)
    and the global batch [B, T].  The MoE layers route each of the
    dp·ep row blocks of the batch on its own, as the (dp, ep) shards do
    (capacity from local tokens), and the aux loss is the mesh's: per
    layer E · Σₑ of the fractions averaged over the ep shards, averaged
    over dp, left out under pp.  MoE under sp routes by sequence chunk
    and has no such reference here."""
    groups = dp * ep
    if cfg.moe_every and tokens.shape[0] % groups:
        raise ValueError(f"batch {tokens.shape[0]} does not split into "
                         f"{groups} row blocks")
    dt = cfg.compute_dtype
    rows = tokens.shape[0] // groups
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    ce, stats = 0.0, []
    with torch.no_grad():
        for g in range(groups if cfg.moe_every else 1):
            sl = (slice(g * rows, (g + 1) * rows) if cfg.moe_every
                  else slice(None))
            st = []
            x = params["embed"][tokens[sl]].to(dt)
            x, _ = _layer_seq(params["blocks"], params.get("moe"), x,
                              positions, cfg, 0, cfg.n_layers, stats=st)
            logits = TiedHead.apply(_rmsnorm(params["final_norm"]["scale"],
                                             x), params["embed"], dt)
            lse = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1, targets[sl][..., None])[..., 0]
            ce += float((lse - picked).sum())
            stats.append(st)
            del x, logits, lse, picked
    loss = ce / targets.numel()
    if cfg.moe_every and pp == 1:
        aux = 0.0
        for d in range(dp):
            blocks = stats[d * ep:(d + 1) * ep]
            for layer in range(len(blocks[0])):
                ft = sum(b[layer]["frac_tokens"] for b in blocks) / ep
                fp = sum(b[layer]["frac_probs"] for b in blocks) / ep
                aux += float(cfg.n_experts * torch.sum(ft * fp))
        loss += cfg.aux_loss_weight * aux / dp
    return loss


def _grad_axes(spec, mesh: Mesh) -> Tuple[str, ...]:
    """The axes over which a leaf's gradient is summed: the batch-like
    axes (dp, pp, ep, sp) along which the leaf is replicated.  Never tp:
    Megatron's pair already gives each tp rank the whole gradient of its
    shard."""
    return tuple(a for a in ("dp", "pp", "ep", "sp")
                 if mesh.size(a) > 1 and a not in spec)


def _reduce_grads(shards: Dict, cfg: TransformerConfig, mesh: Mesh) -> None:
    """Sum every gradient over `_grad_axes`: one flat buffer for the
    leaves that share their axes, one allreduce per axis."""
    specs = dict(tree_leaves(transformer_pspecs(cfg, mesh.size("pp"))))
    groups: Dict[Tuple[str, ...], list] = {}
    for path, leaf in tree_leaves(shards):
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
        axes = _grad_axes(specs[path], mesh)
        if axes:
            groups.setdefault(axes, []).append(leaf)
    for axes, leaves in groups.items():
        flat = torch.cat([p.grad.reshape(-1) for p in leaves])
        with record_function("hvd.mesh.grad_sum"):
            for a in axes:
                flat = pc._sum(flat, mesh.sets[a])
        off = 0
        for p in leaves:
            p.grad.copy_(flat[off:off + p.numel()].view_as(p))
            off += p.numel()


def make_train_step(mesh: Mesh, cfg: TransformerConfig,
                    optimizer: Callable, n_microbatches: Optional[int] = None):
    """(train_step, shard_state, shard_lm_batch) for the mesh (JAX
    `make_train_step`).

    shard_state(params) -> (shards, opt): this rank's shards of the full
    tree (`transformer_init`'s layout) as leaf tensors on the rank's
    device that require grad, and `optimizer(list_of_leaves)` (e.g.
    `functools.partial(torch.optim.AdamW, lr=3e-4)`) over them.

    shard_lm_batch((tokens, targets)) -> this rank's block of the global
    [B, T] batch: B over (dp, ep), T over sp, replicated over tp and pp.

    train_step(shards, opt, batch) -> (shards, opt, loss): forward and
    backward of this rank's objective (`_loss_shard`), the gradients
    summed over the axes along which each leaf is replicated
    (`_reduce_grads`; each leaf's `.grad` is then the dense gradient's
    shard), one optimizer step.  `loss` is the global loss, the same on
    every rank.  Collective over the mesh."""
    if mesh.size("dcn") > 1:
        raise NotImplementedError(
            "a dcn axis needs parallel/hierarchical.py, not ported yet")
    pp = mesh.size("pp")
    M = n_microbatches or max(1, pp)
    dev = basics.device()

    def shard_state(params):
        shards = tree_map(
            lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)
            .detach().clone().requires_grad_(),
            shard_params(params, cfg, mesh))
        return shards, optimizer([p for _, p in tree_leaves(shards)])

    def shard_lm_batch(batch):
        nb = mesh.size("dp") * mesh.size("ep")
        ib = mesh.index("dp") * mesh.size("ep") + mesh.index("ep")
        out = []
        for t in batch:
            t = torch.as_tensor(t)
            b, s = t.shape[0] // nb, t.shape[1] // mesh.size("sp")
            j = mesh.index("sp")
            out.append(t[ib * b:(ib + 1) * b, j * s:(j + 1) * s]
                       .to(dev, torch.int64))
        return tuple(out)

    def train_step(shards, opt, batch):
        tokens, targets = batch
        count = (tokens.numel() * mesh.size("dp") * mesh.size("ep")
                 * mesh.size("sp"))
        opt.zero_grad(set_to_none=True)
        obj, loss = _loss_shard(shards, tokens, targets, cfg, mesh, M, count)
        obj.backward()
        _reduce_grads(shards, cfg, mesh)
        opt.step()
        return shards, opt, loss

    return train_step, shard_state, shard_lm_batch

