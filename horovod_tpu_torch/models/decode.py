"""KV-cache decoding for the flagship transformer: prefill, decode steps,
chunked extend, greedy / sampled / speculative generation, beam search,
and the decode step sharded over a dp x tp mesh.

Counterpart of `horovod_tpu/models/decode.py`, on parameter trees in the
JAX layout (`transformer_init`, `transformer_from_jax`'s source tree,
`shard_from_jax`).  Layout as there: cache k/v are [L, B, max_len, Hkv,
Dh] in `cfg.compute_dtype` (or, quantized, {"q": int8 / float8_e4m3fn
payload, "scale": f32 [L, B, max_len, Hkv]}), and "pos" counts the
tokens absorbed: a scalar, or a [B] vector when the rows of one step sit
at different depths (the serving pool's continuous batching).  "pos"
lives on the host (a CPU int64 tensor): slots and masks are computed from
it once per call.  The cache is a ring over absolute positions: with
`cfg.attn_window`, max_len may be as small as the window and slot
`pos % max_len` is overwritten.

Where the JAX functions return a new cache, these write the cache
tensors in place and return them (with a new "pos"): a caller that
needs the old cache keeps a copy.  Per-row writes (vector pos) are one
index op over the rows, never a loop.

Prefill is one batched forward through the training attention,
`parallel.sequence.full_attention`: on the card, at a prompt length of
at least HOROVOD_FLASH_ATTENTION_MIN_T that is a multiple of 128, the
flash forward kernel K4 (`ops/flash_attention.py`), once per layer and
with no backward saved.  Decode steps and chunks attend to the cache
through plain contractions (the JAX package leaves them to XLA, outside
any Pallas kernel): grouped-query attention without repeating the kv
heads, f32 scores, the per-vector scales of a quantized cache factored
out of the contractions.

MoE layers decode with no-capacity top-1 routing (`_moe_tokens`): every
token reaches its expert, all experts run and the routing one-hot
selects.  Every entry point runs without autograd.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..common.exceptions import InvalidRequestError
from ..ops.wire import true_div
from ..parallel import _collectives as pc
from ..parallel import moe as moe_mod
from ..parallel import sequence as seq_mod
from .transformer import (
    TransformerConfig,
    _index,
    _is_moe_layer,
    _mlp_block,
    _rmsnorm,
    _rope,
    head_logits,
    shard_leaf,
    transformer_pspecs,
    tree_map,
)

_QUANT = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}
# The leaves that only enter matmuls: `decode_params` rounds them to the
# compute dtype once (the norms' scales stay f32).
_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "wi", "wg", "wd")


def init_decode_cache(cfg: TransformerConfig, batch: int, max_len: int,
                      quantize=None, device=None) -> Dict:
    """Empty KV cache for `batch` sequences, on `device` (the card unless
    given).

    `max_len` is the ring capacity: without a window it must cover the
    whole sequence; with `cfg.attn_window` it may be as small as the
    window.  `quantize="int8"` or `"fp8_e4m3"` stores k/v as a 1-byte
    payload with one f32 scale per vector (max-abs over the head dim)."""
    if batch < 1:
        raise InvalidRequestError(
            f"batch must be >= 1, got {batch} (an empty cache would "
            "fail silently at the first decode step)")
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    if quantize not in (None, "int8", "fp8_e4m3"):
        raise ValueError(f"quantize must be None, 'int8', or "
                         f"'fp8_e4m3', got {quantize!r}")
    dev = torch.device("cuda" if device is None else device)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.d_head)
    pos = torch.zeros((), dtype=torch.int64)
    if quantize is not None:
        def kv():
            return {"q": torch.zeros(shape, dtype=_QUANT[quantize],
                                     device=dev),
                    "scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                         device=dev)}
        return {"k": kv(), "v": kv(), "pos": pos}
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "pos": pos}


def decode_params(params: Dict, cfg: TransformerConfig) -> Dict:
    """The parameter tree with the matmul weights (and the embedding)
    rounded to the compute dtype once, so that a decode step does not
    round them again: every use rounds them to that dtype first, so the
    results are unchanged.  The norms' scales stay as they are."""
    dt = cfg.compute_dtype

    def cast(tree, names):
        return {k: (cast(v, names) if isinstance(v, dict)
                    else v.to(dt) if k in names else v)
                for k, v in tree.items()}

    out = dict(params)
    out["embed"] = params["embed"].to(dt)
    out["blocks"] = cast(params["blocks"], _MATMUL_LEAVES)
    if "moe" in params:
        out["moe"] = cast(params["moe"], ("kernel", "wi", "wo"))
    return out


def _ring(cache) -> int:
    c = cache["k"]
    return (c["q"] if isinstance(c, dict) else c).shape[2]


def _quant_vec(x: torch.Tensor, qdt):
    """Per-vector quantization to `qdt` (int8 or float8_e4m3fn): scale =
    max|x| / payload_max over the trailing dim, so the largest element
    lands at the payload's edge and nothing saturates.  int8 rounds half
    to even, as `jnp.round`."""
    payload_max = 127.0 if qdt == torch.int8 else 448.0
    xf = x.float()
    scale = torch.clamp_min(true_div(xf.abs().amax(-1), payload_max), 1e-12)
    scaled = xf / scale[..., None]
    q = (torch.round(scaled) if qdt == torch.int8 else scaled).to(qdt)
    return q, scale


def _layer_kv(c, i: int):
    """Layer i's slice of a cache half (views: writes land in the cache)."""
    if isinstance(c, dict):
        return {"q": c["q"][i], "scale": c["scale"][i]}
    return c[i]


def _cache_write(c, val: torch.Tensor, slot: int) -> None:
    """Write `val` [B, n, Hkv, Dh] (one position at decode, the prompt at
    prefill) into a layer's (possibly quantized) ring from `slot`."""
    n = val.shape[1]
    if isinstance(c, dict):
        q, scale = _quant_vec(val, c["q"].dtype)
        c["q"][:, slot:slot + n] = q
        c["scale"][:, slot:slot + n] = scale
    else:
        c[:, slot:slot + n] = val


def _cache_write_rows(c, val: torch.Tensor, cols: torch.Tensor) -> None:
    """Per-row variant: row b writes its n positions at the ring slots
    cols[b] (cols [B, n] on the cache's device), one index op over every
    row.  The same bytes `_cache_write` writes per row (quantization is
    per vector)."""
    rows = torch.arange(val.shape[0], device=cols.device)[:, None]
    if isinstance(c, dict):
        q, scale = _quant_vec(val, c["q"].dtype)
        c["q"][rows, cols] = q
        c["scale"][rows, cols] = scale
    else:
        c[rows, cols] = val


def _rope_rows(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding with per-row positions: x [B, c, H, Dh],
    positions [B, c] (`transformer._rope` is the shared-[T] variant; the
    same elementwise math row by row)."""
    Dh = x.shape[-1]
    freqs = theta ** (-torch.arange(0, Dh, 2, dtype=torch.float32,
                                    device=x.device) / Dh)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


class _Geometry(NamedTuple):
    """Where a chunk of c tokens lands, shared by every layer of a call:
    the query positions ([c], or [B, c] for a vector pos), the slot to
    write (an int, or the [B, c] slots of each row), and the mask of
    visible slots, shaped to broadcast over the scores [B, Hkv, g, c,
    S]."""

    vec: bool
    positions: torch.Tensor
    slots: Any
    valid: torch.Tensor


def _geometry(pos: torch.Tensor, c: int, S: int, cfg: TransformerConfig,
              device) -> _Geometry:
    """Query positions, ring slots and the causal (and window) mask over
    the absolute position each slot holds after this chunk's write: slot
    j holds last - ((last - j) mod S), negative where never written."""
    pos = torch.as_tensor(pos, dtype=torch.int64).cpu()
    vec = pos.dim() == 1
    j = torch.arange(S)
    ar = torch.arange(c)
    if vec:
        positions = pos[:, None] + ar[None, :]                # [B, c]
        last = pos[:, None] + (c - 1)                         # [B, 1]
        abs_pos = last - torch.remainder(last - j[None, :], S)  # [B, S]
        valid = (abs_pos[:, None, :] >= 0) & \
            (abs_pos[:, None, :] <= positions[:, :, None])    # [B, c, S]
        if cfg.attn_window:
            valid &= (positions[:, :, None] - abs_pos[:, None, :]) \
                < cfg.attn_window
        slots = torch.remainder(positions, S).to(device)
        valid = valid[:, None, None]
    else:
        p = int(pos)
        positions = p + ar                                    # [c]
        last = p + c - 1
        abs_pos = last - torch.remainder(last - j, S)         # [S]
        valid = (abs_pos[None, :] >= 0) & \
            (abs_pos[None, :] <= positions[:, None])          # [c, S]
        if cfg.attn_window:
            valid &= (positions[:, None] - abs_pos[None, :]) \
                < cfg.attn_window
        slots = p % S
        valid = valid[None, None, None]
    return _Geometry(vec, positions.to(device), slots, valid.to(device))


def _decode_layer(lp, ck, cv, x, geo: _Geometry, cfg: TransformerConfig,
                  tp=None):
    """One layer's attention for a chunk of c new positions (c == 1 is
    the decode step) against this layer's ring slices ck/cv [B, S, Hkv,
    Dh] (local head counts under tp: the head dims come from the
    weights).  Writes the chunk's k/v into the ring and returns x."""
    dt = cfg.compute_dtype
    B, c = x.shape[0], x.shape[1]
    Dh = cfg.d_head
    h = _rmsnorm(lp["ln1"]["scale"], x)
    q = torch.einsum("bod,dhk->bohk", h, lp["wq"].to(dt))
    k = torch.einsum("bod,dhk->bohk", h, lp["wk"].to(dt))
    v = torch.einsum("bod,dhk->bohk", h, lp["wv"].to(dt))
    Hq, Hkv = q.shape[2], k.shape[2]
    g = Hq // Hkv
    if geo.vec:
        q = _rope_rows(q, geo.positions, cfg.rope_theta).to(dt)
        k = _rope_rows(k, geo.positions, cfg.rope_theta).to(dt)
        _cache_write_rows(ck, k, geo.slots)
        _cache_write_rows(cv, v, geo.slots)
    else:
        q = _rope(q, geo.positions, cfg.rope_theta).to(dt)
        k = _rope(k, geo.positions, cfg.rope_theta).to(dt)
        _cache_write(ck, k, geo.slots)
        _cache_write(cv, v, geo.slots)

    # Grouped attention against the ring: q [B, c, Hkv, g, Dh] x cache
    # [B, S, Hkv, Dh]; a quantized cache's scales (constant over Dh)
    # multiply the [.., S] scores and probabilities.
    qg = q.reshape(B, c, Hkv, g, Dh).float()
    if isinstance(ck, dict):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck["q"].float())
        s = s * ck["scale"].transpose(1, 2)[:, :, None, None, :]
        s = s / (Dh ** 0.5)
    else:
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float()) / (Dh ** 0.5)
    s = torch.where(geo.valid, s, torch.full((), -1e30, device=s.device))
    p = torch.softmax(s, dim=-1)
    if isinstance(cv, dict):
        pv = p * cv["scale"].transpose(1, 2)[:, :, None, None, :]
        o = torch.einsum("bhgqk,bkhd->bqhgd", pv, cv["q"].float())
    else:
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, cv.float())
    o = o.reshape(B, c, Hq, Dh).to(dt)
    out = torch.einsum("bthk,hkd->btd", o, lp["wo"].to(dt))
    if tp is not None:
        out = pc.reduce_from(out, tp)   # row-parallel wo
    return x + out.to(x.dtype)


def _moe_tokens(mp, scale, x, cfg: TransformerConfig):
    """No-capacity top-1 MoE for decode and prefill: x [B, T, D] -> the
    residual-added output.  Every expert runs on every token and the
    routing one-hot selects (as the JAX function)."""
    dt = cfg.compute_dtype
    B, T, D = x.shape
    h = _rmsnorm(scale, x).reshape(B * T, D).to(dt)
    logits = h @ mp["gate"]["kernel"].to(dt)                    # [N, E]
    _, eidx, gate = moe_mod.top1_route(logits)
    he = F.relu(torch.einsum("nd,edf->enf", h, mp["wi"].to(dt)))
    oe = torch.einsum("enf,efd->end", he, mp["wo"].to(dt))
    onehot = F.one_hot(eidx, oe.shape[0]).float()
    out = torch.einsum("ne,end->nd", onehot * gate[:, None], oe.float())
    return x + out.reshape(B, T, D).to(x.dtype)


def _layer_walk(params, cache, x, attn_fn, cfg, tp=None):
    """The layers in order: attn_fn(lp, ck_i, cv_i, x) -> x supplies the
    step-, chunk- or prompt-shaped attention, then the MLP (or, on an MoE
    layer, the no-capacity MoE with the layer's ln2 scale; its weights
    are replicated over tp)."""
    moe_idx = 0
    for i in range(cfg.n_layers):
        lp = _index(params["blocks"], i)
        x = attn_fn(lp, _layer_kv(cache["k"], i), _layer_kv(cache["v"], i),
                    x)
        if _is_moe_layer(cfg, i):
            x = _moe_tokens(_index(params["moe"], moe_idx),
                            lp["ln2"]["scale"], x, cfg)
            moe_idx += 1
        else:
            x = _mlp_block(lp, x, cfg, tp)
    return x


def _chunk(params, cache, tokens, cfg, tp, pos):
    """Absorb tokens [B, c] at `pos`; (logits [B, c, V] f32, cache)."""
    dt = cfg.compute_dtype
    x = params["embed"][tokens].to(dt)                        # [B, c, D]
    geo = _geometry(pos, tokens.shape[1], _ring(cache), cfg, x.device)
    x = _layer_walk(params, cache, x,
                    lambda lp, ck, cv, x: _decode_layer(lp, ck, cv, x, geo,
                                                        cfg, tp),
                    cfg, tp)
    x = _rmsnorm(params["final_norm"]["scale"], x)
    logits = head_logits(x, params["embed"], dt)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "pos": torch.as_tensor(pos, dtype=torch.int64).cpu()
                    + tokens.shape[1]}


def _tokens(tokens, params) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["embed"].device).long()


@torch.no_grad()
def transformer_decode_step(params: Dict, cache: Dict, tokens,
                            cfg: TransformerConfig, tp=None):
    """Absorb one token per sequence; return (logits [B, V] f32, cache).

    `tokens` [B].  With `cfg.attn_window` and max_len >= the window,
    decoding may continue past max_len indefinitely; otherwise the caller
    keeps the total sequence within max_len (older positions would be
    evicted; generate and beam search enforce it).  `cache["pos"]` may be
    a [B] vector: each row then ropes, writes and masks at its own depth.
    `tp`: the tensor-parallel ProcessSet of a sharded decode, or None."""
    tokens = _tokens(tokens, params)
    logits, cache = _chunk(params, cache, tokens[:, None], cfg, tp,
                           cache["pos"])
    return logits[:, 0], cache


@torch.no_grad()
def transformer_extend(params: Dict, cache: Dict, tokens,
                       cfg: TransformerConfig, tp=None):
    """Absorb a chunk of c tokens [B, c] at the cache position; return
    (logits [B, c, V], cache): the per-position next-token logits the
    speculative verify pass needs.

    The chunk must fit without wrapping the ring (pos % max_len + c <=
    max_len, for every row of a vector pos).  Windowed configs also need
    pos < max_len: once the ring has wrapped, the slot reconstruction
    anchors at the chunk's last query, so keys still inside an earlier
    query's window may already be overwritten; decode token by token
    past max_len instead."""
    tokens = _tokens(tokens, params)
    c = tokens.shape[1]
    S = _ring(cache)
    pos = torch.as_tensor(cache["pos"], dtype=torch.int64).reshape(-1)
    pmax = int(pos.max())
    if int(torch.remainder(pos, S).max()) + c > S:
        raise ValueError(
            f"extend chunk of {c} tokens at pos {pmax} would "
            f"wrap the ring (max_len {S}); split the chunk or size "
            f"the cache larger")
    if cfg.attn_window and pmax >= S:
        raise ValueError(
            f"extend on a wrapped windowed ring (attn_window "
            f"{cfg.attn_window}, pos {pmax} >= max_len {S}) "
            "would silently drop still-in-window keys for the "
            "chunk's earlier queries; decode token-by-token with "
            "transformer_decode_step past max_len")
    return _chunk(params, cache, tokens, cfg, tp, cache["pos"])


@torch.no_grad()
def transformer_prefill(params: Dict, cache: Dict, prompt,
                        cfg: TransformerConfig, tp=None):
    """Absorb the whole prompt [B, T0] in one batched forward (the
    training attention, `full_attention`: K4 on the card where it
    routes), filling ring slots 0..T0-1.  Returns (last-position logits
    [B, V] f32, cache).  Needs a fresh cache (pos == 0) and T0 <=
    max_len.  The prompt attends at full precision; a quantized cache
    stores the quantized k/v for the decode steps."""
    dt = cfg.compute_dtype
    prompt = _tokens(prompt, params)
    B, T0 = prompt.shape
    if B < 1 or T0 < 1:
        raise InvalidRequestError(
            f"prompt must be non-empty, got shape {(B, T0)} (an empty "
            "prefill would silently leave the cache desynced)")
    S = _ring(cache)
    if T0 > S:
        raise InvalidRequestError(
            f"prompt length {T0} > cache max_len {S}")
    pos = torch.as_tensor(cache["pos"], dtype=torch.int64).cpu()
    if pos.dim() or int(pos) != 0:
        raise ValueError(
            f"transformer_prefill requires a fresh cache "
            f"(pos == 0), got pos = {pos.tolist()}")
    window = cfg.attn_window or None
    x = params["embed"][prompt].to(dt)                        # [B, T0, D]
    positions = torch.arange(T0, device=x.device)

    def attn(lp, ck, cv, x):
        h = _rmsnorm(lp["ln1"]["scale"], x)
        q = torch.einsum("btd,dhk->bthk", h, lp["wq"].to(dt))
        k = torch.einsum("btd,dhk->bthk", h, lp["wk"].to(dt))
        v = torch.einsum("btd,dhk->bthk", h, lp["wv"].to(dt))
        q = _rope(q, positions, cfg.rope_theta).to(dt)
        k = _rope(k, positions, cfg.rope_theta).to(dt)
        _cache_write(ck, k, 0)
        _cache_write(cv, v, 0)
        o = seq_mod.full_attention(q, k, v, causal=True, window=window)
        out = torch.einsum("bthk,hkd->btd", o.to(dt), lp["wo"].to(dt))
        if tp is not None:
            out = pc.reduce_from(out, tp)
        return x + out.to(x.dtype)

    x = _layer_walk(params, cache, x, attn, cfg, tp)
    x = _rmsnorm(params["final_norm"]["scale"], x[:, -1:])
    logits = head_logits(x, params["embed"], dt)
    return logits[:, 0], {"k": cache["k"], "v": cache["v"], "pos": pos + T0}


def _resolve_max_len(cfg, T0, max_new_tokens, max_len):
    """Generate / beam search's cache capacity: the full sequence by
    default; a smaller rolling ring only for windowed configs."""
    max_len = max_len or (T0 + max_new_tokens)
    if T0 + max_new_tokens > max_len:
        if not cfg.attn_window:
            raise InvalidRequestError(
                f"max_len {max_len} < prompt {T0} + new "
                f"{max_new_tokens} (only windowed configs may roll "
                f"the cache)")
        if max_len < cfg.attn_window:
            raise InvalidRequestError(
                f"max_len {max_len} < attn_window {cfg.attn_window} "
                f"and the sequence ({T0} + {max_new_tokens} tokens) "
                f"wraps the ring: positions still inside the band "
                f"would be evicted — size max_len >= "
                f"max(attn_window, prompt length) = "
                f"{max(cfg.attn_window, T0)}")
    return max_len


def _categorical(logits: torch.Tensor, rng: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits) with `rng` (on the
    generator's device; -inf logits are never drawn)."""
    probs = torch.softmax(logits.float(), dim=-1).to(rng.device)
    return torch.multinomial(probs, 1, generator=rng)[:, 0].to(
        logits.device)


def _pick(logits, temperature: float, top_p: float, top_k: int, rng):
    """The next token per row: argmax when greedy; else a draw at the
    temperature, restricted to the top_k ranks and then to the nucleus
    top_p of the renormalised top-k distribution, drawn in sorted space
    and mapped back."""
    if not temperature:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_p < 1.0 or top_k:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1,
                                             descending=True, stable=True)
        if top_k:
            sorted_logits = torch.where(
                torch.arange(logits.shape[-1], device=logits.device) < top_k,
                sorted_logits, torch.full((), -torch.inf,
                                          device=logits.device))
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        masked = torch.where(keep, sorted_logits,
                             torch.full((), -torch.inf, device=logits.device))
        rank = _categorical(masked, rng)
        return torch.gather(sort_idx, -1, rank[:, None])[:, 0]
    return _categorical(logits, rng)


@torch.no_grad()
def transformer_generate(params: Dict, cfg: TransformerConfig, prompt,
                         max_new_tokens: int,
                         temperature: float = 0.0,
                         top_p: float = 1.0,
                         top_k: int = 0,
                         eos_id: Optional[int] = None,
                         rng: Optional[torch.Generator] = None,
                         max_len: Optional[int] = None,
                         quantize=None) -> Tuple[torch.Tensor, Dict]:
    """Generate `max_new_tokens` continuations of `prompt` [B, T0] on
    the parameters' device.

    Greedy when temperature == 0 (default), else softmax sampling at the
    temperature with the torch.Generator `rng`; `top_k > 0` keeps the k
    most likely tokens, `top_p < 1` the nucleus of the (renormalised)
    rest.  `eos_id`: every position strictly after a row's first eos
    reads eos_id.  Returns (tokens [B, max_new_tokens] int64, the final
    cache).  `max_len` defaults to T0 + max_new_tokens; with
    `cfg.attn_window` it may be as small as max(window, T0)."""
    prompt = _tokens(prompt, params)
    B, T0 = prompt.shape
    if B < 1 or T0 < 1:
        raise InvalidRequestError(
            f"prompt must be non-empty, got shape {(B, T0)}")
    if max_new_tokens < 1:
        raise InvalidRequestError(
            f"max_new_tokens must be >= 1, got {max_new_tokens} (a "
            "zero-length scan would silently return an empty batch)")
    max_len = _resolve_max_len(cfg, T0, max_new_tokens, max_len)
    if max_len < T0:
        raise InvalidRequestError(
            f"max_len {max_len} < prompt length {T0}: the prefill "
            "would overrun the ring before the first generated token")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature and rng is None:
        raise ValueError("sampling (temperature > 0) needs rng")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0 or top_k > cfg.vocab_size:
        raise ValueError(
            f"top_k must be in [0, vocab_size], got {top_k}")
    if (top_p < 1.0 or top_k) and not temperature:
        raise ValueError(
            "top_p < 1 / top_k > 0 need temperature > 0 (greedy "
            "decoding ignores them)")
    if eos_id is not None and not 0 <= int(eos_id) < cfg.vocab_size:
        raise ValueError(
            f"eos_id {eos_id} outside vocab [0, {cfg.vocab_size})")
    params = decode_params(params, cfg)
    cache = init_decode_cache(cfg, B, max_len, quantize=quantize,
                              device=prompt.device)
    logits, cache = transformer_prefill(params, cache, prompt, cfg)
    toks = []
    for _ in range(max_new_tokens):
        tok = _pick(logits, temperature, top_p, top_k, rng)
        logits, cache = transformer_decode_step(params, cache, tok, cfg)
        toks.append(tok)
    toks = torch.stack(toks, dim=1)                        # [B, max_new]
    if eos_id is not None:
        hit = (toks == eos_id).long()
        after = (torch.cumsum(hit, dim=1) - hit) > 0
        toks = torch.where(after, torch.full_like(toks, int(eos_id)), toks)
    return toks, cache


def _softmax_np(x):
    e = np.exp(x - np.max(x))
    return e / e.sum()


def _spec_accept(d_tok: int, p, q, rng_np):
    """One speculative accept/resample decision (Leviathan et al.):
    accept draft token `d_tok` (drawn from q) with probability
    min(1, p[d]/q[d]); otherwise resample from norm(max(p - q, 0)).  The
    emitted token is distributed exactly per p."""
    if rng_np.uniform() < min(1.0, float(p[d_tok])
                              / max(float(q[d_tok]), 1e-20)):
        return True, int(d_tok)
    resid = np.maximum(p - q, 0.0)
    resid = resid / max(resid.sum(), 1e-20)
    return False, int(rng_np.choice(len(resid), p=resid))


def _at(cache, pos: int) -> Dict:
    return {"k": cache["k"], "v": cache["v"],
            "pos": torch.tensor(pos, dtype=torch.int64)}


@torch.no_grad()
def transformer_speculative_generate(
        params: Dict, cfg: TransformerConfig,
        draft_params: Dict, draft_cfg: TransformerConfig,
        prompt, max_new_tokens: int, gamma: int = 4,
        temperature: float = 0.0,
        rng: Optional[torch.Generator] = None,
        max_len: Optional[int] = None):
    """Speculative decoding: the draft model proposes `gamma` tokens per
    round, the target scores them in one chunked forward
    (`transformer_extend`), and the longest valid prefix is accepted.

    temperature == 0: accept while the draft equals the target's argmax;
    the first mismatch takes the target's own argmax (the target-only
    greedy chain, up to near-ties, where the chunked verify and the
    step-by-step chain may break a tie apart).  temperature > 0:
    speculative sampling (accept with min(1, p/q), else resample from
    norm(max(0, p - q)); `rng` a torch.Generator, which also seeds the
    host stream of the accept rule), whose output is distributed as
    target-only sampling.  Batches advance by the batch-minimum accepted
    length + 1 per round.  Returns (tokens [B, max_new_tokens], stats
    {"rounds", "accept_rate"}).  Both models share the vocabulary;
    attn_window configs are not supported."""
    prompt = _tokens(prompt, params)
    B, T0 = prompt.shape
    if cfg.attn_window or draft_cfg.attn_window:
        raise ValueError(
            "speculative decoding does not support attn_window configs")
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(
            f"draft/target vocab mismatch: {draft_cfg.vocab_size} vs "
            f"{cfg.vocab_size}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature and rng is None:
        raise ValueError("sampling (temperature > 0) needs rng")
    # +gamma headroom: a round writes gamma speculative slots past the
    # accepted frontier before rolling back; the ring must never wrap.
    need = T0 + max_new_tokens + gamma + 1
    cap = max_len or need
    if cap < need:
        raise ValueError(
            f"max_len {cap} < prompt {T0} + max_new {max_new_tokens} + "
            f"gamma {gamma} + 1: speculative rounds write up to gamma "
            f"slots past the accepted frontier before rolling back")
    params = decode_params(params, cfg)
    draft_params = decode_params(draft_params, draft_cfg)
    dev = prompt.device
    cache = init_decode_cache(cfg, B, cap, device=dev)
    dcache = init_decode_cache(draft_cfg, B, cap, device=dev)
    # Invariant at the end of every round: every decided token is fed
    # into both caches, and tlast / dlast are the [B, V] host logits of
    # the next undecided position.
    tlast, cache = transformer_prefill(params, cache, prompt, cfg)
    dlast, dcache = transformer_prefill(draft_params, dcache, prompt,
                                        draft_cfg)
    tlast, dlast = tlast.cpu().numpy(), dlast.cpu().numpy()
    seed = (int(torch.randint(0, 2 ** 31 - 1, (1,), generator=rng,
                              device=rng.device))
            if rng is not None else 0)
    rng_np = np.random.default_rng(seed)

    def _host_pick(logits_np):
        if not temperature:
            return int(np.argmax(logits_np))
        p = _softmax_np(logits_np / temperature)
        return int(rng_np.choice(len(p), p=p))

    out: List[List[int]] = [[] for _ in range(B)]
    rounds = accepted_total = proposed_total = 0
    base = T0                       # first undecided position
    while len(out[0]) < max_new_tokens:
        rounds += 1
        n = gamma
        # The draft proposes n tokens per row; qlogits[i] is the
        # distribution row b's d_i was drawn from.
        cur = torch.from_numpy(dlast).to(dev)
        drafts_l, qlogits_l = [], []
        for _ in range(n):
            tok = (_categorical(cur / temperature, rng) if temperature
                   else torch.argmax(cur, dim=-1))
            drafts_l.append(tok)
            if temperature:
                qlogits_l.append(cur)
            cur, dcache = transformer_decode_step(draft_params, dcache, tok,
                                                  draft_cfg)
        drafts = torch.stack(drafts_l).cpu().numpy()        # [n, B]
        qlogits = (torch.stack(qlogits_l).cpu().numpy() if temperature
                   else None)
        proposed_total += n
        # Row i of the chunk predicts position base+1+i: each row's target
        # distributions are [tlast[b], tlogits[b, 0..n-2]], and tlogits[b,
        # n-1] gives the all-accepted bonus position base+n.
        tlogits_t, cache = transformer_extend(
            params, cache, torch.from_numpy(drafts.T.copy()).to(dev), cfg)
        tlogits = tlogits_t.cpu().numpy()                    # [B, n, V]
        per_acc = [0] * B
        per_extra: list = [None] * B
        for b in range(B):
            tdists = [tlast[b]] + [tlogits[b, i] for i in range(n - 1)]
            for i in range(n):
                d_i = int(drafts[i, b])
                if not temperature:
                    t_tok = int(np.argmax(tdists[i]))
                    if d_i == t_tok:
                        per_acc[b] += 1
                        continue
                    per_extra[b] = t_tok
                    break
                p = _softmax_np(tdists[i] / temperature)
                q = _softmax_np(qlogits[i, b] / temperature)
                ok, tok = _spec_accept(d_i, p, q, rng_np)
                if ok:
                    per_acc[b] += 1
                    continue
                per_extra[b] = tok
                break
        # Min-acceptance: every row advances n_acc + 1 tokens; a row that
        # accepted further takes its own verified draft at n_acc.
        n_acc = min(per_acc)
        extra = [0] * B
        for b in range(B):
            if per_acc[b] > n_acc:
                extra[b] = int(drafts[n_acc, b])
            elif per_extra[b] is not None:
                extra[b] = per_extra[b]
            else:
                extra[b] = _host_pick(tlogits[b, n - 1])
        accepted_total += n_acc
        for b in range(B):
            out[b].extend(int(t) for t in drafts[:n_acc, b])
        if len(out[0]) < max_new_tokens:
            for b in range(B):
                out[b].append(extra[b])
            # Roll both caches back to the accepted frontier and feed the
            # extra tokens; the stale speculative slots beyond it are
            # masked and later overwritten.
            feed = torch.tensor(extra, dtype=torch.int64, device=dev)
            tl, cache = transformer_decode_step(
                params, _at(cache, base + n_acc), feed, cfg)
            dl, dcache = transformer_decode_step(
                draft_params, _at(dcache, base + n_acc), feed, draft_cfg)
            tlast, dlast = tl.cpu().numpy(), dl.cpu().numpy()
            base = base + n_acc + 1
        else:
            base = base + n_acc
    toks = torch.tensor([row[:max_new_tokens] for row in out],
                        dtype=torch.int64, device=dev)
    stats = {"rounds": rounds,
             "accept_rate": accepted_total / max(1, proposed_total)}
    return toks, stats


class ShardedDecode(NamedTuple):
    """Sharded inference bundle from `make_decode_step`.  Unpacks as
    (step, prefill, shard_params, shard_cache, shard_tokens, extend)."""

    step: Any
    prefill: Any
    shard_params: Any
    shard_cache: Any
    shard_tokens: Any
    extend: Any


def make_decode_step(mesh, cfg: TransformerConfig, quantize=None
                     ) -> ShardedDecode:
    """Sharded inference over a dp x tp mesh (every rank of the mesh
    calls the returned functions together).

    - the batch shards over dp; the heads and the KV cache's head axis
      over tp (n_heads % tp == 0 and kv_heads % tp == 0);
    - wo and wd are row-parallel: one sum over tp per attention and per
      MLP (`parallel/_collectives.py`);
    - ep, pp and sp are not supported at decode; MoE weights stay
      replicated and route with the no-capacity inference semantics.

    shard_params(full tree) / shard_cache(full cache) / shard_tokens
    (full [B] or [B, T] tokens) give this rank's block on its device;
    step, prefill and extend take and return this rank's blocks (logits
    [B / dp, ...])."""
    from ..common import basics

    axes = {a: mesh.size(a) > 1 for a in mesh.axis_names}
    if axes.get("ep") and cfg.moe_every:
        raise NotImplementedError(
            "expert-parallel decode is not supported; decode MoE runs "
            "replicated (drop ep from the mesh)")
    if axes.get("pp") or axes.get("sp"):
        raise NotImplementedError(
            "decode shards over dp/tp only (no pp/sp schedule at "
            "one-token granularity)")
    tp = mesh.on("tp")
    dev = basics.device()

    def _clean(spec):
        # transformer_pspecs names tp and ep; the decode shards over dp
        # and tp only.
        return tuple(a if a in ("dp", "tp") else None for a in spec)

    pspecs = tree_map(_clean, transformer_pspecs(cfg, 1))
    kv_spec = (None, "dp", None, "tp", None)
    if quantize is not None:
        kv_spec = {"q": kv_spec, "scale": kv_spec[:4]}

    def _put(a, spec):
        return shard_leaf(torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a), spec, mesh).contiguous().to(dev)

    def shard_params(params):
        return tree_map(lambda a, s: _put(a, s), params, pspecs)

    def shard_cache(cache):
        def half(c):
            if isinstance(c, dict):
                return {k: _put(c[k], kv_spec[k]) for k in ("q", "scale")}
            return _put(c, kv_spec)
        return {"k": half(cache["k"]), "v": half(cache["v"]),
                "pos": torch.as_tensor(cache["pos"],
                                       dtype=torch.int64).cpu()}

    def shard_tokens(tokens):
        t = torch.as_tensor(np.asarray(tokens) if not isinstance(
            tokens, torch.Tensor) else tokens)
        return _put(t, ("dp",) + (None,) * (t.dim() - 1)).long()

    def step(p, c, t):
        return transformer_decode_step(p, c, t, cfg, tp)

    def prefill(p, c, t):
        return transformer_prefill(p, c, t, cfg, tp)

    def extend(p, c, t):
        return transformer_extend(p, c, t, cfg, tp)

    return ShardedDecode(step, prefill, shard_params, shard_cache,
                         shard_tokens, extend)


@torch.no_grad()
def transformer_beam_search(params: Dict, cfg: TransformerConfig,
                            prompt, max_new_tokens: int,
                            beam_width: int = 4,
                            length_penalty: float = 0.0,
                            eos_id: Optional[int] = None,
                            max_len: Optional[int] = None,
                            quantize=None):
    """Beam search over the KV-cache decode path.

    prompt [B, T0] -> (tokens [B, W, max_new], scores [B, W]) sorted
    best-first; scores are sums of the chosen tokens' log-probabilities.
    Without `eos_id` every beam decodes max_new tokens and
    `length_penalty` only normalises the reported scores (score /
    max_new**penalty).  With `eos_id` a beam that emits it is finished:
    its score freezes and its tail reads eos_id; the penalty then
    normalises the W survivors by their actual lengths and re-sorts
    (beams compete on raw scores during the search).  The cache carries
    B*W rows (beam-major within a batch row); each step keeps the top W
    of the W*V continuations and gathers the parents' cache rows."""
    prompt = _tokens(prompt, params)
    B, T0 = prompt.shape
    W = int(beam_width)
    if W < 1:
        raise ValueError(f"beam_width must be >= 1, got {W}")
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    V = cfg.vocab_size
    if eos_id is not None and not 0 <= int(eos_id) < V:
        raise ValueError(f"eos_id {eos_id} outside vocab [0, {V})")
    max_len = _resolve_max_len(cfg, T0, max_new_tokens, max_len)
    params = decode_params(params, cfg)
    dev = prompt.device
    cache = init_decode_cache(cfg, B, max_len, quantize=quantize, device=dev)
    logits, cache = transformer_prefill(params, cache, prompt, cfg)

    def rows_of(c, fn):
        if isinstance(c, dict):
            return {k: fn(v) for k, v in c.items()}
        return fn(c)

    cache = {"k": rows_of(cache["k"], lambda a: a.repeat_interleave(W, 1)),
             "v": rows_of(cache["v"], lambda a: a.repeat_interleave(W, 1)),
             "pos": cache["pos"]}
    logp = torch.log_softmax(logits, dim=-1)                    # [B, V]
    seed_lp, seed_tok = torch.topk(logp, W, dim=-1)             # [B, W]
    scores = seed_lp.reshape(B * W)
    tok = seed_tok.reshape(B * W)
    done = (tok == eos_id) if eos_id is not None else \
        torch.zeros(B * W, dtype=torch.bool, device=dev)
    if eos_id is not None:
        # A finished beam's only continuation is eos at logprob 0.
        frozen_lp = torch.full((V,), -1e30, device=dev)
        frozen_lp[int(eos_id)] = 0.0
    toks, parents = [seed_tok.reshape(B * W)], []
    for _ in range(max_new_tokens - 1):
        logits, cache = transformer_decode_step(params, cache, tok, cfg)
        logp = torch.log_softmax(logits, dim=-1)                # [B*W, V]
        if eos_id is not None:
            logp = torch.where(done[:, None], frozen_lp[None, :], logp)
        cand = (scores[:, None] + logp).reshape(B, W * V)
        new_scores, flat_idx = torch.topk(cand, W, dim=-1)      # [B, W]
        parent = flat_idx // V
        new_tok = flat_idx % V
        rows = (torch.arange(B, device=dev)[:, None] * W
                + parent).reshape(B * W)
        cache = {"k": rows_of(cache["k"], lambda a: a[:, rows]),
                 "v": rows_of(cache["v"], lambda a: a[:, rows]),
                 "pos": cache["pos"]}
        tok = new_tok.reshape(B * W)
        done = done[rows]
        if eos_id is not None:
            done = done | (tok == eos_id)
        scores = new_scores.reshape(B * W)
        toks.append(tok)
        parents.append(rows)

    # Each surviving beam's path, walking the parent pointers back.
    toks_np = torch.stack(toks).cpu().numpy()
    parents_np = (torch.stack(parents).cpu().numpy() if parents
                  else np.zeros((0, B * W), np.int64))
    paths = np.zeros((max_new_tokens, B * W), np.int64)
    live = np.arange(B * W)
    for t in range(max_new_tokens - 1, 0, -1):
        paths[t] = toks_np[t, live]
        live = parents_np[t - 1, live]
    paths[0] = toks_np[0, live]
    out = torch.from_numpy(paths.T.copy()).reshape(B, W, max_new_tokens)
    scores = scores.reshape(B, W).cpu()
    if length_penalty:
        if eos_id is not None:
            hit = out.numpy() == int(eos_id)
            lengths = np.where(hit.any(axis=-1), hit.argmax(axis=-1) + 1,
                               max_new_tokens).astype(np.float64)
            scores = scores / torch.from_numpy(
                lengths ** length_penalty).to(scores.dtype)
            order = torch.argsort(-scores, dim=-1, stable=True)
            scores = torch.gather(scores, -1, order)
            out = torch.gather(out, 1, order[..., None].expand_as(out))
        else:
            scores = scores / (float(max_new_tokens) ** length_penalty)
    return out.to(dev), scores.to(dev)


__all__ = ["init_decode_cache", "decode_params", "transformer_decode_step",
           "transformer_prefill", "transformer_extend",
           "transformer_generate", "transformer_speculative_generate",
           "transformer_beam_search", "make_decode_step", "ShardedDecode"]
