"""Port parity: the plain version of K3 (`tiled_matmul`, horovod_tpu_torch/
ops/matmul_kernels.py) against the JAX package's Pallas `pallas_matmul`
run in interpret mode, as tests/test_pallas_kernels.py runs it, and the
routing of the fused chunks' products (`_chunk_matmul`).

Tolerances, relative to the largest value of the result: f32 1e-6 (the
same f32 products summed in another order).  bf16 and f16: the Pallas
kernel rounds its running sum to the output dtype after every 128-wide K
tile, the port once at the end, so the two differ by up to one rounding
per K tile: 2^-8 (bf16) and 2^-11 (f16) of the largest value per tile.
The CUDA kernel itself needs the card: tests/test_torch_port_cuda.py and
chip_smoke.py hold it to this plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import fused_collectives as JF
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.ops import fused_collectives as F
from horovod_tpu_torch.ops import matmul_kernels as MK

DTYPES = {"float32": (jnp.float32, torch.float32, 0.0),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -8),
          "float16": (jnp.float16, torch.float16, 2.0 ** -11)}
SHAPES = [(128, 128, 128), (200, 300, 150), (7, 5, 3), (129, 257, 129),
          (64, 512, 96), (1, 1, 1), (3, 1000, 2)]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setenv("HOROVOD_PALLAS_INTERPRET", "1")


def _inputs(shape, jdt, tdt, seed):
    x = jnp.asarray(np.random.RandomState(seed).randn(*shape), jdt)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    return float(np.abs(got.float().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_matmul(shape, dtype):
    jdt, tdt, per_tile = DTYPES[dtype]
    m, k, n = shape
    ja, ta = _inputs((m, k), jdt, tdt, sum(shape))
    jb, tb = _inputs((k, n), jdt, tdt, sum(shape) + 1)
    want = JF.pallas_matmul(ja, jb)
    got = MK.tiled_matmul_plain(ta, tb)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    tiles = -(-k // 128)
    tol = 1e-6 if dtype == "float32" else per_tile * (tiles + 1)
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_rounds_once_from_an_f32_sum(dtype):
    """The port's bf16 / f16 result is the f32 product rounded once (the
    reference's docstring), where the Pallas body rounds per K tile."""
    _, tdt, _ = DTYPES[dtype]
    g = torch.Generator().manual_seed(3)
    a = torch.randn((33, 700), generator=g).to(tdt)
    b = torch.randn((700, 17), generator=g).to(tdt)
    want = (a.double() @ b.double()).to(tdt)
    got = MK.tiled_matmul_plain(a, b)
    scale = float(want.float().abs().max())
    ulp = {"float32": 1e-6, "bfloat16": 2.0 ** -7,
           "float16": 2.0 ** -10}[dtype]
    assert float((got.float() - want.float()).abs().max()) <= ulp * scale


def test_transposed_operand_and_output_band():
    g = torch.Generator().manual_seed(4)
    a = torch.randn((50, 130), generator=g)
    w = torch.randn((40, 130), generator=g)
    want = MK.tiled_matmul_plain(a, w.t().contiguous())
    assert torch.equal(MK.tiled_matmul(a, w.t()), want)
    wide = torch.zeros((50, 60))
    MK.tiled_matmul(a, w.t(), out=wide[:, 10:50])
    assert torch.equal(wide[:, 10:50], want)
    assert not wide[:, :10].any() and not wide[:, 50:].any()


def test_inner_dims_mismatch_raises():
    with pytest.raises(HorovodTpuError, match="inner dims"):
        MK.tiled_matmul(torch.zeros((4, 5)), torch.zeros((6, 7)))
    with pytest.raises(HorovodTpuError, match="inner dims"):
        MK.tiled_matmul_plain(torch.zeros((4, 5)), torch.zeros((6, 7)))


@pytest.mark.parametrize("bad", ["1d", "dtype", "mixed", "out_shape",
                                 "out_cols"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a, b, out = torch.zeros((4, 5)), torch.zeros((5, 6)), None
    if bad == "1d":
        a = torch.zeros(5)
    elif bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "mixed":
        b = b.bfloat16()
    elif bad == "out_shape":
        out = torch.zeros((4, 7))
    else:
        out = torch.zeros((6, 4)).t()
    with pytest.raises(HorovodTpuError):
        MK.tiled_matmul(a, b, out=out)


def test_cpu_takes_plain_version_and_counts_no_launch():
    MK.reset_launch_counts()
    MK.tiled_matmul(torch.ones((3, 4)), torch.ones((4, 2)))
    assert MK.launch_counts() == {"tiled_matmul": 0}
    assert MK.tiled_matmul.strided_launches == 0
    assert MK.tiled_matmul.plain_calls == 1
    MK.reset_launch_counts()
    assert MK.tiled_matmul.plain_calls == 0


def test_off_cpu_tensor_launches_or_raises():
    a = torch.empty((4, 4), device="meta")
    with pytest.raises(HorovodTpuError, match="kernel runs on CUDA"):
        MK.tiled_matmul(a, a)


# vector_path's arguments at the head's chunk, (16384, 512) @ (512, 512)
# f32: a contiguous, b the transposed view of a band of the gathered
# weight at row 512, the output a column band of the (16384, 32000)
# logits at column 512.
HEAD = dict(es=4, m=16384, n=512, k=512, a_ptr=1 << 20, sam=512, sak=1,
            b_ptr=(1 << 30) + 512 * 512 * 4, sbk=1, sbn=512,
            c_ptr=(1 << 32) + 512 * 4, ldc=32000)


@pytest.mark.parametrize("change,vec", [
    ({}, True),
    ({"es": 2}, True),                            # bf16 / f16 rows, 1 KiB
    ({"k": 304, "sam": 304, "sbn": 304}, True),   # K off the 32-deep stage
    ({"n": 130, "ldc": 132}, True),               # N off 4, ldc a multiple
    ({"m": 1, "sam": 7, "ldc": 3}, True),         # one row: no pitch
    ({"k": 1, "sak": 9, "sbk": 5}, True),         # K = 1: no K stride
    ({"a_ptr": (1 << 20) + 4}, False),            # a's base one element off
    ({"b_ptr": (1 << 30) + 8}, False),            # b's base off 16 bytes
    ({"c_ptr": (1 << 32) + 4}, False),            # C's base off 4 elements
    ({"ldc": 32001}, False),                      # an odd ldc
    ({"ldc": 32002}, False),                      # ldc off 4
    ({"sam": 1, "sak": 16384}, False),            # a strided along K
    ({"sbk": 512, "sbn": 1}, False),              # b strided along K
    ({"k": 300, "sam": 300, "sbn": 300, "es": 2}, False),  # 600-byte rows
    ({"k": 257, "sam": 257, "sbn": 257}, False),  # 1028-byte rows
])
def test_vector_path_is_chosen_by_layout(change, vec):
    """K3 takes its vector path (16-byte copies of K-contiguous rows,
    4-wide stores) for the head's operands; a base, a row pitch or an
    ldc off those boundaries, or an operand strided along K, takes the
    strided path."""
    assert MK.vector_path(**dict(HEAD, **change)) is vec


def test_vector_path_of_the_head_operands_as_torch_lays_them_out():
    """The tensors `fused_allgather_matmul` hands K3 at the head: the
    flattened hidden rows, a band of the gathered weight transposed, and
    a column band of the logits."""
    hidden = torch.zeros((64, 512))
    weight = torch.zeros((2048, 512))
    logits = torch.zeros((64, 2048))
    a, b, c = hidden, weight[512:1024].t(), logits[:, 512:1024]
    args = (4, 64, 512, 512, a.data_ptr(), *a.stride(), b.data_ptr(),
            *b.stride(), c.data_ptr(), c.stride(0))
    assert MK.vector_path(*args)
    off = torch.zeros(64 * 512 + 1)[1:].view(64, 512)
    assert not MK.vector_path(4, 64, 512, 512, off.data_ptr(),
                              *off.stride(), *args[7:])


@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("n_elements", [0, 128 * 128 - 1, 128 * 128,
                                        10 ** 6])
def test_fused_pallas_gate_matches_jax(monkeypatch, env, n_elements):
    if env is None:
        monkeypatch.delenv("HOROVOD_FUSED_PALLAS", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_FUSED_PALLAS", env)
    assert F.fused_pallas_enabled(n_elements) == \
        JF.fused_pallas_enabled(n_elements)


@pytest.mark.parametrize("env,shape,k3", [
    (None, (128, 128, 64), False), ("1", (128, 128, 64), True),
    ("1", (8, 8, 8), False), ("0", (256, 256, 256), False)])
def test_chunk_matmul_routes_by_env_and_size(monkeypatch, env, shape, k3):
    """K3 only under HOROVOD_FUSED_PALLAS=1 and at 128² elements or more,
    else torch.matmul; the same product either way (f32, 1e-6)."""
    if env is None:
        monkeypatch.delenv("HOROVOD_FUSED_PALLAS", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_FUSED_PALLAS", env)
    m, k, n = shape
    g = torch.Generator().manual_seed(m + n)
    a, b = torch.randn((m, k), generator=g), torch.randn((k, n), generator=g)
    MK.reset_launch_counts()
    out = F._chunk_matmul(a, b)
    assert MK.tiled_matmul.plain_calls == int(k3)
    want = a.double() @ b.double()
    assert float((out.double() - want).abs().max()) <= \
        1e-6 * float(want.abs().max())
