"""Local attention of the sequence-parallel module: the dense oracle and
the routing to the flash kernels.

Counterpart of the local part of `horovod_tpu/parallel/sequence.py`
(`repeat_kv`, `full_attention`, `dense_attention_oracle`), on
[B, T, H, D].  Ring attention and Ulysses, which need an `sp` group of
cards, are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops import flash_attention as fa


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
