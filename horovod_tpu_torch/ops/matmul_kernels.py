"""K3, the tiled matrix product of the fused allgather-matmul chunks,
beside its plain version.

Counterpart of `pallas_matmul` in `horovod_tpu/ops/fused_collectives.py`
(`_matmul_kernel`, the `pl.pallas_call` at :286): (M, K) @ (K, N) in
the input dtype (f32, bf16 or f16), every product and the whole sum
over K in f32, rounded once to the output dtype.  `_chunk_matmul`
(`ops/fused_collectives.py`) takes it when HOROVOD_FUSED_PALLAS=1 and
the operands hold at least 128² elements, as the JAX package does; the
ZeRO-3 head (`ZeroParamPlacement.gather_matmul`) runs it that way.

The kernel is CUDA C++ in `csrc/tiled_matmul.cu`, built with nvcc for
sm_90a at first use (`_build.py`) and called through ctypes on
PyTorch's current stream.  It is bound by operations: at the head chunk
(16384, 512) @ (512, 512) f32 the H100 SXM's 67 TFLOP/s f32 rate
outside the tensor cores gives 0.128 ms (see the note at the top of the
source).  It has two load paths, chosen by layout (`vector_path`): 16-byte
`cp.async` copies of K-contiguous, 16-byte aligned rows with 4-wide
stores of C, which the head's operands take, and element loads and
stores through any strides.  `tiled_matmul.strided_launches` counts the
launches of the second.

Numerics.  The Pallas kernel pads each dimension to a multiple of 128
and, for bf16 and f16 outputs, rounds the running sum to the output
dtype after every 128-wide K tile.  The port keeps the whole sum in f32
and rounds once (the reference's docstring; the per-tile rounding is
recorded in ROADMAP.md).  `tiled_matmul_plain` adds the f32 products of
the 128-wide K tiles in order into one f32 sum and rounds once, so it
differs from the kernel only in the order of the additions inside a
tile.

A wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  Like the JAX kernel it
has no backward.  `tiled_matmul.launches` counts its launches, and
`tiled_matmul.plain_calls` the calls on CPU tensors (so a CPU run can
show how often the path reached K3's wrapper).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..common.exceptions import HorovodTpuError

_MM_BLOCK = 128  # the Pallas kernel's tile, and the plain version's K step
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_COPY_BYTES = 16  # one cp.async copy

_c_lib = None


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.library("tiled_matmul")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.hvd_tiled_matmul.argtypes = [p, p, p] + [i64] * 8 + [i32, i32, p]
        lib.hvd_tiled_matmul.restype = i32
        _c_lib = lib
    return _c_lib


def _check(a: torch.Tensor, b: torch.Tensor,
           out: Optional[torch.Tensor]) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise HorovodTpuError(
            f"tiled_matmul: needs 2-D operands, got {tuple(a.shape)} @ "
            f"{tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise HorovodTpuError(
            f"tiled_matmul: inner dims disagree ({tuple(a.shape)} @ "
            f"{tuple(b.shape)})")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise HorovodTpuError(
            f"tiled_matmul: dtypes {a.dtype}, {b.dtype}; float32, bfloat16 "
            "or float16, both the same")
    if a.device != b.device:
        raise HorovodTpuError("tiled_matmul: operands on different devices")
    if out is not None:
        want = (a.shape[0], b.shape[1])
        if (tuple(out.shape) != want or out.dtype != a.dtype
                or out.device != a.device
                or (out.shape[1] > 1 and out.stride(1) != 1)):
            raise HorovodTpuError(
                f"tiled_matmul: out must be {want} {a.dtype} on "
                f"{a.device} with contiguous rows, got {tuple(out.shape)} "
                f"{out.dtype} on {out.device}")


def vector_path(es: int, m: int, n: int, k: int, a_ptr: int, sam: int,
                sak: int, b_ptr: int, sbk: int, sbn: int, c_ptr: int,
                ldc: int) -> bool:
    """Does K3 take its vector path for these operands?  Elements of
    `es` bytes; A (m, k) at a_ptr with strides (sam, sak), B (k, n) at
    b_ptr with (sbk, sbn), C (m, n) at c_ptr with row stride ldc.

    Each row of A and each column of B must be contiguous along K and
    start on a 16-byte boundary (the copies are 16 bytes), and C's rows
    must take stores of 4 elements.  A dimension of length 1 imposes no
    stride.  Pure dispatch by layout: anything else takes the strided
    path."""
    def rows_copy(ptr, rows, row_stride, k_stride):
        return ((k == 1 or k_stride == 1) and ptr % _COPY_BYTES == 0
                and (rows == 1 or row_stride * es % _COPY_BYTES == 0))

    return (rows_copy(a_ptr, m, sam, sak) and rows_copy(b_ptr, n, sbn, sbk)
            and (m == 1 or ldc % 4 == 0) and c_ptr % (4 * es) == 0)


def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the f32 products of the
    128-wide K tiles added in order into one f32 sum, rounded once to
    a's dtype (written into `out` when given)."""
    _check(a, b, out)
    m, k = a.shape
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, _MM_BLOCK):
        acc += a[:, k0:k0 + _MM_BLOCK].float() @ b[k0:k0 + _MM_BLOCK].float()
    if out is None:
        return acc.to(a.dtype)
    return out.copy_(acc)


def tiled_matmul(a: torch.Tensor, b: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) in a's dtype, f32 sums.

    Operands may have any strides (b is often a transposed view); `out`,
    when given, is an (M, N) tensor with contiguous rows (a column band
    of a wider result) that receives the product.  No gradient: the JAX
    kernel has none either."""
    _check(a, b, out)
    if a.device.type == "cpu":
        tiled_matmul.plain_calls += 1
        return tiled_matmul_plain(a, b, out)
    if a.device.type != "cuda":
        raise HorovodTpuError(
            f"tiled_matmul: tensors on {a.device}; the kernel runs on CUDA "
            "and the plain version on the CPU")
    m, k = a.shape
    n = b.shape[1]
    if out is None:
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    ldc = out.stride(0) if m > 1 else n
    strides = (a.stride(0), a.stride(1), b.stride(0), b.stride(1))
    vec = vector_path(a.element_size(), m, n, k, a.data_ptr(), strides[0],
                      strides[1], b.data_ptr(), strides[2], strides[3],
                      out.data_ptr(), ldc)
    rc = _lib().hvd_tiled_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, *strides, ldc,
        int(vec), _DTYPE_CODES[a.dtype],
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc:
        raise HorovodTpuError(f"tiled_matmul: CUDA error {rc} at launch")
    tiled_matmul.launches += 1
    tiled_matmul.strided_launches += not vec
    return out


tiled_matmul.launches = 0
tiled_matmul.strided_launches = 0  # launches that took the strided path
tiled_matmul.plain_calls = 0  # CPU calls, which take the plain version

KERNELS = (tiled_matmul,)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    tiled_matmul.strided_launches = 0
    tiled_matmul.plain_calls = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
