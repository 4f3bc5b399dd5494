"""The Adasum pair combine's two kernels, each beside its plain version.

Counterpart of `horovod_tpu/ops/pallas_kernels.py`:

- K1 `fused_dot_norms` replaces `fused_dot_norms` (`_dot_norms_kernel`,
  the `pl.pallas_call` at pallas_kernels.py:117): [a·b, ‖a‖², ‖b‖²] per
  row, f32 accumulation, for f32, bf16 and f16 (the wire dtype of
  `Compression.fp16`) inputs.
- K2 `fused_scaled_add` replaces `fused_scaled_add`
  (`_scaled_add_kernel`, pallas_kernels.py:147): `ca[i]·a + cb[i]·b` per
  row at f32, rounded once to the input dtype.

The kernels are CUDA C++ in `csrc/adasum_kernels.cu`, built with nvcc
for sm_90a at first use (`_build.py`) and called through ctypes on
PyTorch's current stream.  Both are bound by device-memory bytes (see
the note at the top of the source).  On the pair combine of one fused
ResNet-50 delta (n = 25,557,032 f32, 102.2 MB per input) the H100 SXM's
3.35 TB/s gives bounds of 61 µs for K1 (reads 204.5 MB) and 92 µs for
K2 (reads 204.5 MB, writes 102.2 MB).

A wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  There is no opt-in gate,
no size threshold and no fallback: the JAX package's
HOROVOD_ADASUM_PALLAS gate exists because XLA fuses the three reductions
on a TPU, and nothing does that here.  Each wrapper counts its launches
in a plain integer attribute (`fused_dot_norms.launches`).  The Adasum
coefficients that join the two kernels are formed in `adasum.py`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common.exceptions import HorovodTpuError

# float16 is the wire dtype of Compression.fp16.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS = 256
# Blocks per row: about one wave of 256-thread blocks on an H100
# (132 SMs x 8), chosen from n alone so that K1's partial sums, and so
# its result's bits, are the same on every card.
_MAX_BLOCKS = 1024

_c_lib = None


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.library("adasum_kernels")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.hvd_adasum_dot_norms.argtypes = [
            p, p, i64, i64, i64, i64, i32, p, i64, p, p]
        lib.hvd_adasum_dot_norms.restype = i32
        lib.hvd_adasum_scaled_add.argtypes = [
            p, p, p, p, p, i64, i64, i64, i64, i64, i32, i64, p]
        lib.hvd_adasum_scaled_add.restype = i32
        _c_lib = lib
    return _c_lib


def blocks_per_row(n: int, element_size: int) -> int:
    """Grid width of both kernels for rows of n elements: each thread
    walks at least four 16-byte packs, capped at `_MAX_BLOCKS`."""
    packs = -(-n * element_size // 16)
    return max(1, min(_MAX_BLOCKS, -(-packs // (_THREADS * 4))))


def _check_rows(name: str, *ts: torch.Tensor) -> None:
    a = ts[0]
    for t in ts:
        if t.dim() != 2 or t.shape != a.shape:
            raise HorovodTpuError(
                f"{name}: expected equal (k, n) shapes, got "
                f"{[tuple(x.shape) for x in ts]}")
        if t.dtype != a.dtype or t.dtype not in _DTYPE_CODES:
            raise HorovodTpuError(
                f"{name}: dtypes {[x.dtype for x in ts]}; float32, "
                "bfloat16 or float16, all the same")
        if t.device != a.device:
            raise HorovodTpuError(f"{name}: tensors on different devices")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise HorovodTpuError(f"{name}: each row must be contiguous")


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise HorovodTpuError(
            f"{name}: tensors on {t.device}; the kernel runs on CUDA and "
            "the plain version on the CPU")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K1: fused dot and norms
# ---------------------------------------------------------------------------

def fused_dot_norms_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    af = a.float()
    bf = b.float()
    return torch.stack([(af * bf).sum(-1), (af * af).sum(-1),
                        (bf * bf).sum(-1)], -1)


def fused_dot_norms(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One pass over a and b: (k, 3) f32 [a·b, ‖a‖², ‖b‖²] per row.

    a, b: (k, n), same dtype (f32, bf16 or f16), rows contiguous (the row
    stride may be anything)."""
    _check_rows("fused_dot_norms", a, b)
    if a.device.type == "cpu":
        return fused_dot_norms_plain(a, b)
    _check_cuda("fused_dot_norms", a)
    k, n = a.shape
    out = torch.empty((k, 3), dtype=torch.float32, device=a.device)
    if k == 0:
        return out
    blocks = blocks_per_row(n, a.element_size())
    partials = torch.empty((k, blocks, 3), dtype=torch.float32,
                           device=a.device)
    rc = _lib().hvd_adasum_dot_norms(
        a.data_ptr(), b.data_ptr(), n, k, a.stride(0), b.stride(0),
        _DTYPE_CODES[a.dtype], partials.data_ptr(), blocks, out.data_ptr(),
        _stream(a))
    if rc:
        raise HorovodTpuError(f"fused_dot_norms: CUDA error {rc} at launch")
    fused_dot_norms.launches += 1
    return out


fused_dot_norms.launches = 0


# ---------------------------------------------------------------------------
# K2: fused scaled add
# ---------------------------------------------------------------------------

def fused_scaled_add_plain(ca: torch.Tensor, cb: torch.Tensor,
                           a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (ca[:, None] * a.float() + cb[:, None] * b.float()).to(a.dtype)


def fused_scaled_add(ca: torch.Tensor, cb: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """out = ca[i]·a + cb[i]·b per row, at f32, cast back to a.dtype.

    ca, cb: (k,) f32; a, b: (k, n) as for `fused_dot_norms`.  Returns a
    new contiguous (k, n) tensor."""
    _check_rows("fused_scaled_add", a, b)
    k, n = a.shape
    for c in (ca, cb):
        if c.shape != (k,) or c.dtype != torch.float32 or \
                c.device != a.device or (k > 1 and c.stride(0) != 1):
            raise HorovodTpuError(
                "fused_scaled_add: coefficients must be contiguous (k,) "
                "float32 on the inputs' device")
    if a.device.type == "cpu":
        return fused_scaled_add_plain(ca, cb, a, b)
    _check_cuda("fused_scaled_add", a)
    out = torch.empty((k, n), dtype=a.dtype, device=a.device)
    if k == 0 or n == 0:
        return out
    rc = _lib().hvd_adasum_scaled_add(
        ca.data_ptr(), cb.data_ptr(), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), n, k, a.stride(0), b.stride(0), out.stride(0),
        _DTYPE_CODES[a.dtype], blocks_per_row(n, a.element_size()),
        _stream(a))
    if rc:
        raise HorovodTpuError(f"fused_scaled_add: CUDA error {rc} at launch")
    fused_scaled_add.launches += 1
    return out


fused_scaled_add.launches = 0

KERNELS = (fused_dot_norms, fused_scaled_add)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
