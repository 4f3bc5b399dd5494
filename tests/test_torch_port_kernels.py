"""Port parity: the plain versions of the Adasum kernels (K1
`fused_dot_norms`, K2 `fused_scaled_add`, horovod_tpu_torch/ops/
adasum_kernels.py) against the JAX package's Pallas kernels run in
interpret mode, as tests/test_pallas_kernels.py runs them.

Tolerances: K1's sums are f32 in another order than the interpreter's,
so rtol 2e-5 / atol 1e-4 (as the JAX package holds its kernel to
jnp).  K2 is elementwise: f32 within 1e-6 relative, bf16 and f16 (the
wire dtype of Compression.fp16) within 1 ulp.
The CUDA kernels themselves need the card: tests/test_torch_port_cuda.py
and chip_smoke.py hold them to these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_kernels as PK
from horovod_tpu_torch import _build
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.ops import adasum as TA
from horovod_tpu_torch.ops import adasum_kernels as K

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
NS = [128 * 256, 128 * 256 + 1, 1000, 7]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setenv("HOROVOD_PALLAS_INTERPRET", "1")


def _inputs(shape, dtype_name, seed):
    """The same values for both frameworks: rounded to the dtype by JAX,
    handed to torch through f32 (exact for bf16 and f16)."""
    jdt, tdt = DTYPES[dtype_name]
    x = jnp.asarray(np.random.RandomState(seed).randn(*shape), jdt)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)


def _half_ulps(x: torch.Tensor, y: torch.Tensor) -> int:
    """Largest distance in ulps between two bf16 or two f16 tensors."""
    xi = x.contiguous().view(torch.int16).int()
    yi = y.contiguous().view(torch.int16).int()
    xi = torch.where(xi < 0, -32768 - xi, xi)
    yi = torch.where(yi < 0, -32768 - yi, yi)
    return int((xi - yi).abs().max())


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dot_norms_matches_pallas(n, dtype):
    ja, ta = _inputs((2, n), dtype, 0)
    jb, tb = _inputs((2, n), dtype, 1)
    want = np.asarray(PK.fused_dot_norms(ja, jb))
    got = K.fused_dot_norms(ta, tb)
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_scaled_add_matches_pallas(n, dtype):
    ja, ta = _inputs((3, n), dtype, 2)
    jb, tb = _inputs((3, n), dtype, 3)
    ca = np.asarray([0.5, 1.0, -2.0], np.float32)
    cb = np.asarray([1.5, 0.0, 3.0], np.float32)
    want = PK.fused_scaled_add(jnp.asarray(ca), jnp.asarray(cb), ja, jb)
    got = K.fused_scaled_add(torch.from_numpy(ca), torch.from_numpy(cb),
                             ta, tb)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (3, n)
    want_t = torch.from_numpy(np.array(want.astype(jnp.float32))).to(
        got.dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want_t.numpy(), rtol=1e-6,
                                   atol=0)
    else:
        assert _half_ulps(got, want_t) <= 1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 3])
def test_pair_combine_matches_pallas(dtype, k):
    ja, ta = _inputs((k, 4, 300), dtype, 4)
    jb, tb = _inputs((k, 4, 300), dtype, 5)
    want = PK.pallas_pair_combine_batched(ja, jb).astype(jnp.float32)
    got = TA._pair_combine_batched(ta, tb)
    assert got.shape == (k, 4, 300) and got.dtype == DTYPES[dtype][1]
    rtol = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 2e-3}[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=rtol, atol=rtol)


def test_strided_rows_match_contiguous():
    """The tree hands the kernels xs[0::2] / xs[1::2] views: rows with a
    stride, no copies."""
    xs = torch.from_numpy(np.random.RandomState(6).randn(4, 257)
                          .astype(np.float32))
    a, b = xs[0::2], xs[1::2]
    assert a.stride(0) == 2 * 257
    torch.testing.assert_close(K.fused_dot_norms(a, b),
                               K.fused_dot_norms(a.contiguous(),
                                                 b.contiguous()))
    ca = torch.tensor([0.25, -1.0])
    cb = torch.tensor([2.0, 0.5])
    torch.testing.assert_close(K.fused_scaled_add(ca, cb, a, b),
                               ca[:, None] * a + cb[:, None] * b,
                               rtol=0, atol=0)


def test_cpu_takes_plain_version_and_counts_no_launch():
    K.reset_launch_counts()
    a = torch.randn(2, 100)
    K.fused_scaled_add(torch.ones(2), torch.ones(2), a, a)
    K.fused_dot_norms(a, a)
    assert K.launch_counts() == {"fused_dot_norms": 0,
                                 "fused_scaled_add": 0}


def test_off_cpu_tensor_launches_or_raises():
    """A tensor that is not on the CPU never takes the plain version:
    off CUDA the wrapper raises."""
    a = torch.empty((2, 64), device="meta")
    with pytest.raises(HorovodTpuError, match="kernel runs on CUDA"):
        K.fused_dot_norms(a, a)
    with pytest.raises(HorovodTpuError, match="kernel runs on CUDA"):
        K.fused_scaled_add(torch.empty(2, device="meta"),
                           torch.empty(2, device="meta"), a, a)


@pytest.mark.parametrize("bad", ["shape", "dtype", "mixed", "column",
                                 "coef"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = torch.randn(2, 8)
    b = torch.randn(2, 8)
    ca = cb = torch.ones(2)
    if bad == "shape":
        b = torch.randn(2, 9)
    elif bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "mixed":
        b = b.bfloat16()
    elif bad == "column":
        a, b = torch.randn(8, 2).t(), torch.randn(8, 2).t()
    else:
        ca = torch.ones(3)
    with pytest.raises(HorovodTpuError):
        K.fused_scaled_add(ca, cb, a, b)
    if bad != "coef":
        with pytest.raises(HorovodTpuError):
            K.fused_dot_norms(a, b)


@pytest.mark.parametrize("n,es,want", [
    (0, 4, 1), (7, 4, 1), (4096, 4, 1), (4097, 4, 2),
    (25_557_032, 4, 1024), (25_557_032, 2, 1024), (1_000_000, 2, 123)])
def test_blocks_per_row_depends_on_n_only(n, es, want):
    assert K.blocks_per_row(n, es) == want


def test_build_targets_hopper_and_lists_every_source():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.sources() == ["adasum_kernels", "flash_attention",
                                "flash_attention_sm90", "tiled_matmul"]
    for name in _build.sources():
        path = _build._library_path(name)
        assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
