"""Sequence parallelism: ring attention and Ulysses over an `sp` set,
and the local attention they run.

Counterpart of `horovod_tpu/parallel/sequence.py`, on [B, T, H, D]:

- **Ring attention** (`ring_attention_shard`): the sequence is sharded
  over the set; K/V blocks rotate around it by `ppermute` while each
  rank folds them into its queries' online softmax.  With
  `flash_routed(T_local)`, no window and T_local % 128 == 0, the
  per-pair engine is the flash kernels (`ring_flash_attention_shard`:
  K4 forward, K5 + K6 backward through `flash_attention_lse`), whose
  (o, lse) partials merge in f32 by logaddexp; otherwise the blockwise
  f32 update `_block_attn_update`, which also carries windows.
- **Ulysses** (`ulysses_attention_shard`): a tiled all-to-all switches
  tokens for heads, `full_attention` runs over the whole sequence on
  H/sp heads (the flash kernels when routed), and a second one switches
  back.  H must divide by the set's size.

`*_shard` functions run on this rank's shard with the set in hand (as
the transformer calls them); `ring_attention` / `ulysses_attention`
take the full [B, T, H, D] arrays and a mesh, shard T over `sp`, and
gather the result.

Every rank posts every hop: a causal ring skips the future pairs' math
(rank i runs pairs with blocks i, i-1, ..., 0), never their hops, and a
skipped block still enters the autograd graph (`_tie`), so that each
hop's backward runs on every rank.  K and V travel as one tensor, one
hop per ring step, and the last step's rotation, which no rank reads,
is not made.  Numerics as in the JAX module: f32 accumulation, masked
logits at -1e30 rather than -inf.
"""

from __future__ import annotations


import torch

from ..ops import flash_attention as fa
from . import _collectives as pc
from .mesh import Mesh

_NEG = -1e30


class _Tie(torch.autograd.Function):
    """`x` unchanged, with `deps` as inputs whose gradients are zero: a
    block whose pair a rank skips still reaches the loss, so the hop
    that brought it runs its backward on every rank."""

    @staticmethod
    def forward(ctx, x, *deps):
        ctx.shapes = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=t, device=d)
                            for s, t, d in ctx.shapes)


def _tie(x, *deps):
    return _Tie.apply(x, *deps)


def _rotate(kv: torch.Tensor, ps) -> torch.Tensor:
    """One ring hop: this rank's [2, B, T_local, Hkv, D] K/V block to
    the next rank, the previous rank's block back."""
    n = ps.size()
    return pc.ppermute(kv, [(i, (i + 1) % n) for i in range(n)], ps,
                       name="hvd.sp.hop")


def _block_attn_update(q, k, v, o, m, l, q_pos, k_pos, scale: float,
                       causal: bool, window=None):
    """One online-softmax update of (o, m, l) with a K/V block.

    q [B, Tq, H, D], k/v [B, Tk, Hkv, D] (GQA blocks are repeated here;
    the ring still rotates the small ones), o [B, Tq, H, D] f32, m, l
    [B, H, Tq] f32.  `window` adds the causal band q - k < window."""
    k, v = repeat_kv(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        wmask = (q_pos[:, None] - k_pos[None, :]) < window
        mask = wmask if mask is None else (mask & wmask)
    if mask is not None:
        s = torch.where(mask[None, None], s,
                        torch.full((), _NEG, device=s.device))
    m_new = torch.maximum(m, s.amax(-1))
    # exp of _NEG-filled rows underflows to 0: no NaN path.
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def ring_flash_attention_shard(q, k, v, ps, causal: bool = True):
    """Ring attention with the flash kernels as the per-pair engine.

    Step s pairs this rank's queries with block (i - s) mod n: the
    diagonal pair (s = 0) runs causal, past pairs non-causal, future
    pairs nothing (`_tie` keeps their block in the graph).  Each pair's
    (o, lse) merges into the running pair in f32 by logaddexp from a
    -1e30 start: the single online softmax, with the O(T_local²) scores
    never in memory.  The merge differentiates through lse (the flash
    backward folds its cotangent into delta)."""
    n, idx = ps.size(), ps.rank()
    B, Tl, H, D = q.shape
    o = torch.zeros((B, Tl, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, Tl, H), _NEG, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        kv_idx = (idx - step) % n
        if causal and kv_idx > idx:
            o = _tie(o, kv)
        else:
            o_p, lse_p = fa.flash_attention_lse(
                q, kv[0], kv[1], causal=causal and kv_idx == idx)
            lse_new = torch.logaddexp(lse, lse_p)
            o = (o * torch.exp(lse - lse_new)[..., None]
                 + o_p.float() * torch.exp(lse_p - lse_new)[..., None])
            lse = lse_new
        if step < n - 1:
            kv = _rotate(kv, ps)
    return o.to(q.dtype)


def ring_attention_shard(q, k, v, ps, causal: bool = True, window=None):
    """Ring attention on this rank's shard of the sequence (q/k/v
    [B, T_local, H(kv), D], the global sequence sharded over the set
    `ps` in rank order); returns [B, T_local, H, D] in q's dtype.

    Routes to `ring_flash_attention_shard` when `flash_routed(T_local)`,
    `window` is None and T_local % 128 == 0, as the JAX module does; the
    blockwise f32 path below serves windows and short shards and is the
    numerical oracle.  Pairs wholly outside the causal or window band
    are skipped."""
    fa.validate_window(window, causal)
    Tl = q.shape[1]
    if (window is None and fa.flash_routed(Tl, q.device)
            and Tl % 128 == 0):
        return ring_flash_attention_shard(q, k, v, ps, causal=causal)
    n, idx = ps.size(), ps.rank()
    B, _, H, D = q.shape
    scale = 1.0 / (D ** 0.5)
    ar = torch.arange(Tl, device=q.device)
    q_pos = idx * Tl + ar
    o = torch.zeros((B, Tl, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tl), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        kv_idx = (idx - step) % n
        run = not causal or kv_idx <= idx
        if window is not None:
            run = run and (kv_idx + 1) * Tl - 1 >= idx * Tl - (window - 1)
        if run:
            o, m, l = _block_attn_update(q, kv[0], kv[1], o, m, l, q_pos,
                                         kv_idx * Tl + ar, scale, causal,
                                         window)
        else:
            o = _tie(o, kv)
        if step < n - 1:
            kv = _rotate(kv, ps)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def repeat_kv(q, k, v):
    """Repeat GQA kv heads up to q's head count (no-op for MHA).  The
    flash kernels never need this; the dense oracle does."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


def full_attention(q, k, v, causal: bool = True, q_offset: int = 0,
                   window=None, segment_ids=None):
    """Attention on [B, T, H, D] as the model calls it.

    Routes to `flash_attention` (K4-K6) when `flash_routed` says so and
    the shapes allow it: no query offset, as many queries as keys, T a
    multiple of 128, and a window only with causal.  Otherwise the dense
    oracle."""
    if (fa.flash_routed(q.shape[1], q.device) and q_offset == 0 and
            q.shape[1] == k.shape[1] and q.shape[1] % 128 == 0 and
            (window is None or causal)):
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  segment_ids=segment_ids)
    return dense_attention_oracle(q, k, v, causal=causal, q_offset=q_offset,
                                  window=window, segment_ids=segment_ids)


def dense_attention_oracle(q, k, v, causal: bool = True, q_offset: int = 0,
                           window=None, segment_ids=None):
    """The O(T²) dense softmax attention in f32, which never routes to
    the flash kernels whatever HOROVOD_FLASH_ATTENTION says: the fixed
    point they are tested against.  GQA/MQA as the kernels read it
    (q head h attends kv head h // (Hq // Hkv)); causal sliding window;
    segment ids over the key sequence, read for the queries at
    q_offset."""
    fa.validate_window(window, causal)
    B, Tq, Hq, D = q.shape
    Tk = k.shape[1]
    k, v = repeat_kv(q, k, v)
    scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(Tq, device=q.device)
    k_pos = torch.arange(Tk, device=q.device)
    neg = torch.full((), fa._NEG, device=q.device)
    mask = None
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        wmask = (q_pos[:, None] - k_pos[None, :]) < window
        mask = wmask if mask is None else (mask & wmask)
    if mask is not None:
        s = torch.where(mask[None, None], s, neg)
    if segment_ids is not None:
        segment_ids = torch.as_tensor(segment_ids, device=q.device)
        if tuple(segment_ids.shape) != (B, Tk):
            raise ValueError(
                f"segment_ids must be (batch, key_len) = ({B}, {Tk}), "
                f"got {tuple(segment_ids.shape)}")
        if q_offset < 0 or q_offset + Tq > Tk:
            raise ValueError(
                f"q_offset {q_offset} + Tq {Tq} out of range for "
                f"key_len {Tk}")
        q_seg = segment_ids[:, q_offset:q_offset + Tq]
        smask = q_seg[:, :, None] == segment_ids[:, None, :]
        s = torch.where(smask[:, None], s, neg)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def ulysses_attention_shard(q, k, v, ps, causal: bool = True, window=None):
    """Ulysses attention on this rank's shard: a tiled all-to-all takes
    q/k/v [B, T_local, H, D] to [B, T, H/n, D], `full_attention` runs
    over the whole sequence on this rank's heads (so a window applies
    directly), and the inverse exchange takes the result back to
    [B, T_local, H, D].  q, k and v travel together (one exchange) when
    they have the same shape, k and v together otherwise."""
    n = ps.size()
    H = q.shape[2]
    if H % n:
        raise ValueError(f"Ulysses needs heads ({H}) divisible by sp ({n})")

    def to_heads(x):  # [..., B, Tl, H, D] -> [..., B, T, H/n, D]
        return pc.all_to_all_tiled(x, -2, -3, ps, name="hvd.sp.a2a")

    if k.shape == q.shape:
        qh, kh, vh = to_heads(torch.stack([q, k, v])).unbind(0)
    else:
        qh = to_heads(q)
        kh, vh = to_heads(torch.stack([k, v])).unbind(0)
    out = full_attention(qh, kh, vh, causal=causal, window=window)
    return pc.all_to_all_tiled(out, 1, 2, ps, name="hvd.sp.a2a")


def _mesh_wrap(shard_fn, mesh: Mesh, axis: str, q, k, v, causal: bool,
               window=None):
    """Full [B, T, H, D] arrays in, this rank's sequence shard through
    `shard_fn`, the shards gathered back to [B, T, H, D]."""
    ps = mesh.sets[axis]
    n, i = ps.size(), ps.rank()
    Tl = q.shape[1] // n
    sl = slice(i * Tl, (i + 1) * Tl)
    out = shard_fn(q[:, sl], k[:, sl], v[:, sl], ps, causal=causal,
                   window=window)
    return pc.all_to_all_tiled(
        out.unsqueeze(0).expand(n, *out.shape).contiguous(), 0, 2, ps,
        name="hvd.sp.gather")[0]


def ring_attention(q, k, v, mesh: Mesh, axis: str = "sp",
                   causal: bool = True, window=None):
    """Mesh-level ring attention: q/k/v [B, T, H, D] with T sharded over
    `axis`; returns [B, T, H, D] on every rank."""
    return _mesh_wrap(ring_attention_shard, mesh, axis, q, k, v, causal,
                      window)


def ulysses_attention(q, k, v, mesh: Mesh, axis: str = "sp",
                      causal: bool = True, window=None):
    """Mesh-level Ulysses attention: q/k/v [B, T, H, D] with T sharded
    over `axis`; returns [B, T, H, D] on every rank."""
    return _mesh_wrap(ulysses_attention_shard, mesh, axis, q, k, v,
                      causal, window)
