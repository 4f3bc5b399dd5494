"""Flash attention, forward and backward, on [B, T, H, D]: three kernels,
each beside its plain version.

Counterpart of `horovod_tpu/ops/flash_attention.py`:

- K4 `flash_fwd` replaces `_fwd` (`_fwd_kernel`, the `pl.pallas_call`
  at flash_attention.py:242): online softmax in f32, o in q's dtype and
  the per-row logsumexp lse (f32, [B, T, H]).
- K5 `flash_bwd_dq` replaces `_bwd`'s dq kernel (`_bwd_dq_kernel`,
  :393): p = exp(s - lse), ds = p·(dp - delta)·scale, dQ = Σₖ ds·K.
- K6 `flash_bwd_dkv` replaces `_bwd`'s dk/dv kernel (`_bwd_dkv_kernel`,
  :427): dV = Σ_q pᵀ·dO, dK = Σ_q dsᵀ·Q; under GQA f32 partials per q
  head, summed over the group by the caller (`_Flash3.backward`).

The kernels are CUDA C++, built with nvcc for sm_90a at first use
(`_build.py`) and called through ctypes on PyTorch's current stream.
They read the public [B, T, H, D] layout in place.  Each kernel has
two routes, fixed by dtype and D (`_sm90_route`): bf16 and f16 at D in
{64, 128} run the tensor-core kernels of `csrc/flash_attention_sm90.cu`
(wgmma, TMA, a warp-specialised pipeline); f32 and every other D run
the CUDA-core kernels of `csrc/flash_attention.cu`.  A caller may name
the route (`sm90=False` runs the CUDA-core kernel at any dtype and D);
naming the tensor cores where they do not apply raises.  A wrapper
takes the plain version only for tensors on the CPU; for a CUDA tensor
it launches its kernel or raises (a failed build or launch of either
route raises; nothing falls back to the other).  Each wrapper counts
its launches in a plain integer attribute (`flash_fwd.launches`), and
those of the tensor-core route apart (`flash_fwd.sm90_launches`).

Numerics, as in the JAX module: every product is formed from the input
dtype's values and summed in f32; the online-softmax state and p, ds
stay f32; p is rounded to v's dtype before P·V, ds to k's dtype for dQ,
p to dO's and ds to q's dtype for dV and dK; masked scores are -1e30.
The plain versions round at the same points but take each row's softmax
over the whole row at once (per head, a dense [T, T] f32 score matrix).

The port does not read HOROVOD_FLASH_BLOCK_Q/K: they size the TPU
kernels' VMEM tiles, and the CUDA kernels fix their own tiles (CUDA
cores: 64 rows, 32 at D > 128 where shared memory runs short; tensor
cores: 128 resident rows, 128 keys (K4), 64 keys (K5) or 64 queries
(K6) per step).
It does read HOROVOD_FLASH_ATTENTION and HOROVOD_FLASH_ATTENTION_MIN_T
(`flash_routed`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _build
from ..common import util
from ..common.exceptions import HorovodTpuError

_NEG = -1e30
_BLOCK = 128  # T must be a multiple of this, as in the JAX module
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_D = 256

# Head widths of the tensor-core route: its tiles are 64 columns of
# 16-bit values wide (one 128-byte swizzled row), so D is a multiple of
# 64; 64 is the transformer's head width and 128 the other common one.
# D = 256 would need K6's two f32 accumulators of 128 registers each per
# thread, more than a thread has; it stays on the CUDA cores, as D = 32
# (half a tile) does.
_SM90_D = (64, 128)
_c_libs = {}


def _sm90_route(dtype, D: int) -> bool:
    """Do K4, K5 and K6 take the tensor-core kernels for `dtype` and head
    width `D`?  bf16 and f16 at D in {64, 128} do.  f32 does not: the
    tensor cores' only f32 path is TF32 (10 mantissa bits), which would
    break the f32 contract and its 1e-4 tolerance.  Nor do other D
    (`_SM90_D`).  Pure dispatch: the route is fixed by these two."""
    return dtype in (torch.bfloat16, torch.float16) and D in _SM90_D


_SHAPE = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
# B T Hq Hkv D dtype causal window, scale, stream


def _lib() -> ctypes.CDLL:
    """csrc/flash_attention.cu: K4, K5, K6 on the CUDA cores."""
    lib = _c_libs.get("cuda_cores")
    if lib is None:
        lib = _build.library("flash_attention")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.hvd_flash_fwd.argtypes = [p] * 6 + _SHAPE
        lib.hvd_flash_fwd.restype = i32
        lib.hvd_flash_bwd_dq.argtypes = [p] * 8 + _SHAPE
        lib.hvd_flash_bwd_dq.restype = i32
        lib.hvd_flash_bwd_dkv.argtypes = [p] * 9 + [i32] + _SHAPE
        lib.hvd_flash_bwd_dkv.restype = i32
        _c_libs["cuda_cores"] = lib
    return lib


def _lib_sm90() -> ctypes.CDLL:
    """csrc/flash_attention_sm90.cu: K4, K5, K6 on the tensor cores."""
    lib = _c_libs.get("sm90")
    if lib is None:
        lib = _build.library("flash_attention_sm90")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.hvd_flash_fwd_sm90.argtypes = [p] * 6 + _SHAPE
        lib.hvd_flash_fwd_sm90.restype = i32
        lib.hvd_flash_bwd_dq_sm90.argtypes = [p] * 8 + _SHAPE
        lib.hvd_flash_bwd_dq_sm90.restype = i32
        lib.hvd_flash_bwd_dkv_sm90.argtypes = [p] * 9 + [i32] + _SHAPE
        lib.hvd_flash_bwd_dkv_sm90.restype = i32
        _c_libs["sm90"] = lib
    return lib


def flash_routed(seq_len: int, device) -> bool:
    """Should attention at `seq_len` on `device` run the flash kernels?

    Forced by HOROVOD_FLASH_ATTENTION=1/0 when set; an empty value counts
    as unset.  Otherwise on for a CUDA device at seq_len >=
    HOROVOD_FLASH_ATTENTION_MIN_T (default 16384, the JAX package's
    value, kept for parity until H100 runs set the port's own), where
    the dense [T, T] scores of every layer no longer fit; off on the
    CPU."""
    forced = util.getenv("FLASH_ATTENTION")
    if forced is not None and forced.strip() != "":
        return util.env_bool("FLASH_ATTENTION", False)
    if torch.device(device).type != "cuda":
        return False
    return seq_len >= util.env_int("FLASH_ATTENTION_MIN_T", 16384)


def validate_window(window, causal) -> None:
    """The window/causal contract every attention entry point shares."""
    if window is None:
        return
    if not causal:
        raise ValueError(
            "window requires causal=True (a non-causal symmetric band "
            "is not implemented)")
    if int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _check_and_to3(q, k, v, window=None, causal=True, segment_ids=None):
    """The JAX module's argument checks, raising on the same cases.  The
    kernels read [B, T, H, D] in place, so unlike the JAX function (whose
    name this keeps) nothing is reshaped to 3-D; returns the segment ids
    as int32 on q's device (or None)."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != T \
            or k.shape[3] != D or H % max(Hkv, 1):
        raise ValueError(
            f"flash_attention: incompatible shapes q={tuple(q.shape)} "
            f"k={tuple(k.shape)} v={tuple(v.shape)} (GQA needs "
            f"n_heads % n_kv_heads == 0)")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"flash_attention needs matching q/k/v dtypes, got "
            f"({q.dtype}, {k.dtype}, {v.dtype})")
    if T % _BLOCK:
        raise ValueError(
            f"flash_attention needs seq len % {_BLOCK} == 0, got {T}")
    validate_window(window, causal)
    seg = None
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (B, T):
            raise ValueError(
                f"flash_attention: segment_ids must be (batch, seq) = "
                f"({B}, {T}), got {tuple(segment_ids.shape)}")
        seg = torch.as_tensor(segment_ids, device=q.device).to(
            torch.int32).contiguous()
    return seg


# ---------------------------------------------------------------------------
# Plain versions: per head, the dense [T, T] f32 scores, rounded where the
# kernels round.
# ---------------------------------------------------------------------------

def _keep(T: int, causal: bool, window: Optional[int], seg, device):
    """Boolean [1 or B, T, T] of the unmasked (query, key) pairs, or
    None when nothing is masked (`_apply_mask`)."""
    keep = None
    if causal or window is not None:
        pos = torch.arange(T, device=device)
        dist = pos[:, None] - pos[None, :]
        if causal:
            keep = dist >= 0
        if window is not None:
            w = dist < window
            keep = w if keep is None else keep & w
        keep = keep[None]
    if seg is not None:
        same = seg[:, :, None] == seg[:, None, :]
        keep = same if keep is None else keep & same
    return keep


def _scores(q, k, h: int, group: int, scale: float, keep):
    """f32 [B, T, T] masked scores of q head h."""
    s = torch.matmul(q[:, :, h].float(),
                     k[:, :, h // group].float().transpose(1, 2)) * scale
    if keep is not None:
        s = torch.where(keep, s, torch.full((), _NEG, device=s.device))
    return s


def flash_fwd_plain(q, k, v, causal: bool = True,
                    window: Optional[int] = None, seg=None):
    B, T, H, D = q.shape
    group = H // k.shape[2]
    scale = 1.0 / math.sqrt(D)
    keep = _keep(T, causal, window, seg, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((B, T, H), dtype=torch.float32, device=q.device)
    for h in range(H):
        s = _scores(q, k, h, group, scale, keep)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).float(), v[:, :, h // group].float())
        o[:, :, h] = (pv / l).to(q.dtype)
        lse[:, :, h] = (m + torch.log(l))[..., 0]
    return o, lse


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                       window: Optional[int] = None, seg=None):
    B, T, H, D = q.shape
    group = H // k.shape[2]
    scale = 1.0 / math.sqrt(D)
    keep = _keep(T, causal, window, seg, q.device)
    dq = torch.empty_like(q)
    for h in range(H):
        kh, vh = k[:, :, h // group].float(), v[:, :, h // group].float()
        p = torch.exp(_scores(q, k, h, group, scale, keep)
                      - lse[:, :, h, None])
        dp = torch.matmul(do[:, :, h].float(), vh.transpose(1, 2))
        ds = p * (dp - delta[:, :, h, None]) * scale
        dq[:, :, h] = torch.matmul(ds.to(k.dtype).float(), kh).to(q.dtype)
    return dq


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                        window: Optional[int] = None, seg=None):
    """dk, dv per q head, [B, T, Hq, D]: f32 under GQA, else in k's and
    v's dtype (as K6 writes them)."""
    B, T, H, D = q.shape
    group = H // k.shape[2]
    scale = 1.0 / math.sqrt(D)
    keep = _keep(T, causal, window, seg, q.device)
    out = torch.float32 if group > 1 else k.dtype
    dk = torch.empty(q.shape, dtype=out, device=q.device)
    dv = torch.empty(q.shape, dtype=out, device=q.device)
    for h in range(H):
        qh, doh = q[:, :, h].float(), do[:, :, h].float()
        p = torch.exp(_scores(q, k, h, group, scale, keep)
                      - lse[:, :, h, None])
        dv[:, :, h] = torch.matmul(
            p.to(do.dtype).float().transpose(1, 2), doh).to(out)
        dp = torch.matmul(doh, v[:, :, h // group].float().transpose(1, 2))
        ds = p * (dp - delta[:, :, h, None]) * scale
        dk[:, :, h] = torch.matmul(
            ds.to(q.dtype).float().transpose(1, 2), qh).to(out)
    return dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _on_card(name: str, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Check what the kernel takes and return the tensors as it reads
    them: contiguous and 16-byte aligned."""
    q = ts[0]
    for t in ts:
        if t.device != q.device or t.device.type != "cuda":
            raise HorovodTpuError(
                f"{name}: tensors on {[str(x.device) for x in ts]}; the "
                "kernel runs on one CUDA device and the plain version on "
                "the CPU")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise HorovodTpuError(
                f"{name}: dtypes {[x.dtype for x in ts]}; float32, "
                "bfloat16 or float16, all the same")
    D = q.shape[-1]
    if D % 8 or D > _MAX_D:
        raise HorovodTpuError(
            f"{name}: head dim {D}; the kernels take D <= {_MAX_D} with "
            "D % 8 == 0")
    if q.shape[1] % _BLOCK:
        raise HorovodTpuError(f"{name}: seq len {q.shape[1]} is not a "
                              f"multiple of {_BLOCK}")
    out = []
    for t in ts:
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return tuple(out)


def _rows(x: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if x is None else x.to(dtype).contiguous()


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _shape_args(q, k, causal, window, stream):
    B, T, H, D = q.shape
    return [B, T, H, k.shape[2], D, _DTYPE_CODES[q.dtype], int(causal),
            int(window or 0), 1.0 / math.sqrt(D), stream]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(name: str, rc: int) -> None:
    if rc:
        raise HorovodTpuError(f"{name}: CUDA error {rc} at launch")


def _route(name: str, q: torch.Tensor, sm90: Optional[bool]) -> bool:
    """The route of a flash kernel for q: `_sm90_route`'s unless `sm90` names
    one.  Naming the tensor cores where they do not apply raises."""
    fits = _sm90_route(q.dtype, q.shape[-1])
    if sm90 is None:
        return fits
    if sm90 and not fits:
        raise HorovodTpuError(
            f"{name}: the tensor-core kernels take bfloat16 and float16 "
            f"at D in {_SM90_D}, not {q.dtype} at D = {q.shape[-1]}")
    return bool(sm90)


def flash_fwd(q, k, v, causal: bool = True, window: Optional[int] = None,
              seg=None, *, sm90: Optional[bool] = None):
    """K4: (o [B, T, H, D] in q's dtype, lse [B, T, H] f32).  `sm90`
    names the route (default: `_sm90_route`'s); False runs the CUDA-core
    kernel at any dtype and D, to set its time beside the other's."""
    sm90 = _route("flash_fwd", q, sm90)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, window, seg)
    q, k, v = _on_card("flash_fwd", q, k, v)
    seg = _rows(seg, torch.int32)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    entry = (_lib_sm90().hvd_flash_fwd_sm90 if sm90
             else _lib().hvd_flash_fwd)
    _raise_on("flash_fwd", entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), o.data_ptr(),
        lse.data_ptr(), *_shape_args(q, k, causal, window, _stream(q))))
    flash_fwd.launches += 1
    flash_fwd.sm90_launches += sm90
    return o, lse


flash_fwd.launches = 0
flash_fwd.sm90_launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 window: Optional[int] = None, seg=None, *,
                 sm90: Optional[bool] = None):
    """K5: dq [B, T, H, D] in q's dtype.  lse, delta: [B, T, H] f32.
    `sm90` as in `flash_fwd`."""
    sm90 = _route("flash_bwd_dq", q, sm90)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, window,
                                  seg)
    q, k, v, do = _on_card("flash_bwd_dq", q, k, v, do)
    lse, delta = _rows(lse, torch.float32), _rows(delta, torch.float32)
    seg = _rows(seg, torch.int32)
    dq = torch.empty_like(q)
    entry = (_lib_sm90().hvd_flash_bwd_dq_sm90 if sm90
             else _lib().hvd_flash_bwd_dq)
    _raise_on("flash_bwd_dq", entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(seg), dq.data_ptr(),
        *_shape_args(q, k, causal, window, _stream(q))))
    flash_bwd_dq.launches += 1
    flash_bwd_dq.sm90_launches += sm90
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.sm90_launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                  window: Optional[int] = None, seg=None, *,
                  sm90: Optional[bool] = None):
    """K6: (dk, dv) per q head, [B, T, Hq, D]: f32 partials under GQA
    (Hq > Hkv), else in k's dtype.  `sm90` as in `flash_fwd`."""
    sm90 = _route("flash_bwd_dkv", q, sm90)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, window,
                                   seg)
    q, k, v, do = _on_card("flash_bwd_dkv", q, k, v, do)
    lse, delta = _rows(lse, torch.float32), _rows(delta, torch.float32)
    seg = _rows(seg, torch.int32)
    out = torch.float32 if q.shape[2] > k.shape[2] else k.dtype
    dk = torch.empty(q.shape, dtype=out, device=q.device)
    dv = torch.empty(q.shape, dtype=out, device=q.device)
    entry = (_lib_sm90().hvd_flash_bwd_dkv_sm90 if sm90
             else _lib().hvd_flash_bwd_dkv)
    _raise_on("flash_bwd_dkv", entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(seg), dk.data_ptr(),
        dv.data_ptr(), _DTYPE_CODES[out],
        *_shape_args(q, k, causal, window, _stream(q))))
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.sm90_launches += sm90
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.sm90_launches = 0

KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.sm90_launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def sm90_launch_counts() -> dict:
    """Launches of K4, K5 and K6 that took the tensor-core route."""
    return {fn.__name__: fn.sm90_launches for fn in KERNELS}


# ---------------------------------------------------------------------------
# Autograd and the public API
# ---------------------------------------------------------------------------

def _group_sum(d: torch.Tensor, hkv: int, dtype) -> torch.Tensor:
    """Sum per-q-head partials [B, T, Hq, D] over each kv head's group."""
    B, T, H, D = d.shape
    if H == hkv:
        return d
    return d.view(B, T, hkv, H // hkv, D).sum(3).to(dtype)


class _Flash3(torch.autograd.Function):
    """Counterpart of `_flash3` (the JAX module's custom_vjp): forward
    launches K4, backward K5 then K6.  Both outputs, o and lse, are
    differentiable; the lse cotangent folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal, window):
        o, lse = flash_fwd(q, k, v, causal, window, seg)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.causal, ctx.window = causal, window
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, seg, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.to(o.dtype)
        # delta = rowsum(dO·O) - dlse: dL/ds = p·(dp - delta).
        delta = (do.float() * o.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse.float()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.window,
                          seg)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                               ctx.window, seg)
        hkv = k.shape[2]
        return (dq, _group_sum(dk, hkv, k.dtype), _group_sum(dv, hkv, v.dtype),
                None, None, None)


def flash_attention(q, k, v, causal: bool = True, window=None,
                    segment_ids=None):
    """Flash attention on [B, T, H, D], differentiable, O(T) memory.

    T must be a multiple of 128.  GQA/MQA: k/v may have fewer heads than
    q (H % Hkv == 0); q head h attends kv head h // (H // Hkv), read in
    place, never repeated.  `window` (requires causal): each query sees
    at most the last `window` keys.  `segment_ids` [B, T]: tokens attend
    only within their own segment.  Output in q's dtype."""
    window = None if window is None else int(window)
    seg = _check_and_to3(q, k, v, window, causal, segment_ids)
    o, _ = _Flash3.apply(q, k, v, seg, causal, window)
    return o


def flash_attention_lse(q, k, v, causal: bool = True, window=None,
                        segment_ids=None):
    """Like `flash_attention`, and also the per-row logsumexp (f32,
    [B, T, H]); both outputs are differentiable."""
    window = None if window is None else int(window)
    seg = _check_and_to3(q, k, v, window, causal, segment_ids)
    return _Flash3.apply(q, k, v, seg, causal, window)


def flash_attention_plain(q, k, v, causal: bool = True, window=None,
                          segment_ids=None):
    """The forward of `flash_attention` through K4's plain version on
    any device (not differentiable): what a check recomputes without
    the kernels."""
    window = None if window is None else int(window)
    seg = _check_and_to3(q, k, v, window, causal, segment_ids)
    return flash_fwd_plain(q, k, v, causal, window, seg)[0]


__all__ = ["flash_attention", "flash_attention_lse", "flash_routed",
           "validate_window"]
