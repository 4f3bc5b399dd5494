"""Tests of the PyTorch/CUDA port that need a CUDA card: the hand-written
kernels against their plain versions, the Adasum tree, the models, a
one-rank job, and two ranks sharing the card over gloo with the
collectives on CUDA tensors.  On a host without CUDA every test skips.

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed; tests/conftest.py imports JAX, so there run

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: K1 rtol 2e-5 / atol 1e-4 (f32 sums in another order), K2
bitwise (no FMA contraction on either side), the tree 1e-5 relative to
its largest value, the ResNet forward 1e-3 relative with TF32 off, the
MNIST net's 1e-4 (f32), the zoo's bf16 forwards within 10% of the f32
CPU logits' largest value; K4-K6
1e-4 (f32), 2^-6 (bf16), 2^-9 (f16) of each output's largest value, lse
1e-5 (f32 sums in another order; p and the outputs rounded to the
working dtype from values that differ in their last bits); K3 1e-5
(f32), 2^-7 (bf16), 2^-10 (f16) of the largest value (f32 sums in
another order inside each K tile, then one rounding of the output).
The wire codecs on the card are bitwise their CPU runs (a decoded NaN
any NaN, and an fp8 NaN code of either sign: a NaN made by inf / inf
has the hardware's sign), and the quantized ring over
gloo on CUDA tensors bitwise its plain model run on the card.  A
megastep's CUDA-graph replay is bitwise the eager loop (the same
kernels on the same inputs), also after the straggler reaction's cap
made it capture again; the cap gives CUDA leaves the partition of their
CPU copies.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.models import (MnistNet, ResNet, Transformer,
                                      TransformerConfig, zoo_build)
from horovod_tpu_torch.ops import adasum, adasum_kernels as K
from horovod_tpu_torch.ops import flash_attention as FA
from horovod_tpu_torch.ops import matmul_kernels as MK

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(1, 1 << 20), (3, 1000), (2, 7),
                                   (4, 4097)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernels_match_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    xs = torch.randn((2 * shape[0], shape[1]), generator=g,
                     device=cuda).to(dtype)
    a, b = xs[0::2], xs[1::2]
    before = K.launch_counts()
    torch.testing.assert_close(K.fused_dot_norms(a, b),
                               K.fused_dot_norms_plain(a, b),
                               rtol=2e-5, atol=1e-4)
    ca = torch.rand(shape[0], generator=g, device=cuda)
    cb = torch.rand(shape[0], generator=g, device=cuda)
    torch.testing.assert_close(K.fused_scaled_add(ca, cb, a, b),
                               K.fused_scaled_add_plain(ca, cb, a, b),
                               rtol=0, atol=0)
    after = K.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)


def test_kernel_results_are_reproducible(cuda):
    """No atomics: the same inputs give the same bits every launch."""
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn((1, 3_000_001), generator=g, device=cuda)
    b = torch.randn((1, 3_000_001), generator=g, device=cuda)
    first = K.fused_dot_norms(a, b)
    for _ in range(5):
        assert torch.equal(K.fused_dot_norms(a, b), first)


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    a = torch.randn((2, 64), device=cuda, dtype=torch.float64)
    with pytest.raises(HorovodTpuError):
        K.fused_dot_norms(a, a)
    b = torch.randn((2, 64), device=cuda)
    with pytest.raises(HorovodTpuError):
        K.fused_scaled_add(torch.ones(2), torch.ones(2), b, b)  # coef on CPU


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_tree_on_the_card_matches_the_cpu(cuda, n):
    xs = torch.from_numpy(np.random.RandomState(n).randn(n, 4, 1000)
                          .astype(np.float32))
    want = adasum.adasum_tree_reduce(xs)
    got = adasum.adasum_tree_reduce(xs.to(cuda)).cpu()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    ref = adasum.adasum_reference(list(xs.numpy()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * scale)


def test_resnet_forward_on_the_card_matches_the_cpu(cuda):
    model = ResNet(18, 10, compute_dtype=None, seed=3)
    x = torch.rand(8, 3, 32, 32, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3 * scale)


@pytest.mark.parametrize("name,size", [("resnet50", 64), ("inception3", 75),
                                       ("vgg16", 64)])
def test_zoo_bf16_forward_on_the_card_matches_the_f32_cpu(cuda, name, size):
    """bf16 compute on the card against f32 on the CPU, same weights, eval
    mode (the initial statistics): within 10% of the largest logit, as
    the CPU test of the ResNet's bf16 forward."""
    want_model = zoo_build(name, 10, compute_dtype=None, seed=3,
                           image_size=size).eval()
    model = zoo_build(name, 10, compute_dtype=torch.bfloat16, seed=3,
                      image_size=size).eval().to(cuda)
    x = torch.rand(4, 3, size, size, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = want_model(x)
        got = model(x.to(cuda)).cpu()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 0.1 * float(want.abs().max())


def test_mnist_net_on_the_card_matches_the_cpu(cuda):
    model = MnistNet(seed=2)
    x = torch.rand(16, 1, 28, 28, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_kernels_match_plain_at_the_vgg16_delta(cuda):
    """K1 and K2 at VGG-16's fused f32 delta (138,357,544 elements), the
    largest the zoo makes."""
    n = 138_357_544
    g = torch.Generator(device=cuda).manual_seed(2)
    xs = torch.randn((2, n), generator=g, device=cuda)
    a, b = xs[0::2], xs[1::2]
    torch.testing.assert_close(K.fused_dot_norms(a, b),
                               K.fused_dot_norms_plain(a, b),
                               rtol=2e-5, atol=1e-4)
    ca = torch.rand(1, generator=g, device=cuda)
    cb = torch.rand(1, generator=g, device=cuda)
    torch.testing.assert_close(K.fused_scaled_add(ca, cb, a, b),
                               K.fused_scaled_add_plain(ca, cb, a, b),
                               rtol=0, atol=0)


def test_one_rank_job_on_the_card(cuda):
    hvd.init()
    try:
        assert hvd.device().type == "cuda" and hvd.backend() is None
        x = torch.arange(6.0, device=cuda)
        for op in (hvd.Average, hvd.Sum, hvd.Adasum):
            torch.testing.assert_close(hvd.allreduce(x, op=op), x)
        torch.testing.assert_close(hvd.allgather(x), x)
        assert hvd.broadcast_object([1, "a"]) == [1, "a"]
    finally:
        hvd.shutdown()


FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6,
             torch.float16: 2 ** -9}


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _row_rel(got, want):
    """Largest error of a row (the last dim) relative to that row's size,
    floored at 2^-8 of the rows' RMS size (as chip_smoke.py)."""
    got, want = got.double(), want.double()
    size = want.norm(dim=-1)
    floor = 2 ** -8 * float(size.square().mean().sqrt())
    return float(((got - want).norm(dim=-1) / size.clamp_min(floor)).max())


@pytest.mark.parametrize("case", [
    # (B, T, Hq, Hkv, D, causal, window, segments)
    (2, 256, 4, 4, 64, True, None, 0), (1, 384, 4, 4, 64, False, None, 0),
    (1, 512, 4, 4, 32, True, 128, 0), (2, 256, 8, 2, 64, True, None, 0),
    (1, 256, 4, 1, 128, True, None, 0), (2, 256, 4, 4, 64, True, None, 3),
    (1, 256, 2, 2, 256, False, None, 2), (1, 128, 2, 2, 24, True, 50, 0),
    (1, 2048, 4, 4, 128, True, None, 0), (2, 512, 8, 2, 64, True, 200, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_kernels_match_plain(cuda, case, dtype):
    """bf16 and f16 at D in {64, 128} take the tensor-core K4, K5 and
    K6 (their sm90 counts grow); f32 and other D the CUDA-core ones."""
    B, T, Hq, Hkv, D, causal, window, n_seg = case
    g = torch.Generator(device=cuda).manual_seed(T + D)
    q, do = (torch.randn((B, T, Hq, D), generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, T, Hkv, D), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    seg = None
    if n_seg:
        seg = torch.sort(torch.randint(0, n_seg, (B, T), generator=g,
                                       device=cuda), 1)[0].int()
    before = FA.launch_counts()
    sm90_before = FA.sm90_launch_counts()
    o, lse = FA.flash_fwd(q, k, v, causal, window, seg)
    po, plse = FA.flash_fwd_plain(q, k, v, causal, window, seg)
    delta = (do.float() * po.float()).sum(-1) - 0.5
    dq = FA.flash_bwd_dq(q, k, v, do, plse, delta, causal, window, seg)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, plse, delta, causal, window, seg)
    pdq = FA.flash_bwd_dq_plain(q, k, v, do, plse, delta, causal, window, seg)
    pdk, pdv = FA.flash_bwd_dkv_plain(q, k, v, do, plse, delta, causal,
                                      window, seg)
    torch.cuda.synchronize()
    assert FA.launch_counts() == {n: c + 1 for n, c in before.items()}
    sm90 = dtype != torch.float32 and D in (64, 128)
    assert FA.sm90_launch_counts() == {n: c + sm90
                                       for n, c in sm90_before.items()}
    assert o.dtype == dq.dtype == dtype and lse.dtype == torch.float32
    assert dk.dtype == (dtype if Hq == Hkv else torch.float32)
    assert _rel(lse, plse) <= 1e-5
    for got, want in ((o, po), (dq, pdq), (dk, pdk), (dv, pdv)):
        assert _rel(got, want) <= FLASH_TOL[dtype]
        assert _row_rel(got, want) <= FLASH_TOL[dtype]


@pytest.mark.parametrize("D", [64, 128])
def test_cuda_core_route_named_at_a_tensor_core_shape(cuda, D):
    """`sm90=False` runs the CUDA-core K4, K5 and K6 at bf16 (whose
    route is the tensor cores by default): within the same limits of the
    plain versions, counted as launches but not as tensor-core ones."""
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v, do = (torch.randn((1, 512, 4, D), generator=g, device=cuda)
                   .bfloat16() for _ in range(4))
    before = FA.launch_counts()
    sm90_before = FA.sm90_launch_counts()
    o, lse = FA.flash_fwd(q, k, v, sm90=False)
    po, plse = FA.flash_fwd_plain(q, k, v)
    delta = (do.float() * po.float()).sum(-1)
    dq = FA.flash_bwd_dq(q, k, v, do, plse, delta, sm90=False)
    pdq = FA.flash_bwd_dq_plain(q, k, v, do, plse, delta)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, plse, delta, sm90=False)
    pdk, pdv = FA.flash_bwd_dkv_plain(q, k, v, do, plse, delta)
    torch.cuda.synchronize()
    assert FA.sm90_launch_counts() == sm90_before
    assert FA.launch_counts() == {n: c + 1 for n, c in before.items()}
    assert _rel(lse, plse) <= 1e-5
    for got, want in ((o, po), (dq, pdq), (dk, pdk), (dv, pdv)):
        assert _rel(got, want) <= FLASH_TOL[torch.bfloat16]
        assert _row_rel(got, want) <= FLASH_TOL[torch.bfloat16]


def test_flash_attention_lse_gradients_on_the_card_match_the_cpu(cuda):
    """Autograd through K4-K6 (GQA, a cotangent on lse) against the same
    function on the CPU, where it runs the plain versions."""
    g = torch.Generator().manual_seed(9)
    q = torch.randn((2, 256, 4, 64), generator=g)
    k, v = (torch.randn((2, 256, 2, 64), generator=g) for _ in range(2))
    do = torch.randn((2, 256, 4, 64), generator=g)
    dlse = torch.randn((2, 256, 4), generator=g)
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        o, lse = FA.flash_attention_lse(*leaves, window=100)
        torch.autograd.backward((o, lse), (do.to(dev), dlse.to(dev)))
        grads.append([t.grad.cpu() for t in leaves])
    for want, got in zip(*grads):
        assert _rel(got, want) <= 1e-4


def test_flash_kernel_results_are_reproducible(cuda):
    """No atomics: the same inputs give the same bits every launch (bf16,
    D = 64: K4, K5 and K6 on the tensor-core route)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (torch.randn((1, 1024, 8, 64), generator=g, device=cuda)
                   .bfloat16() for _ in range(4))
    sm90_before = FA.sm90_launch_counts()
    o, lse = FA.flash_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    first = (o, FA.flash_bwd_dq(q, k, v, do, lse, delta),
             *FA.flash_bwd_dkv(q, k, v, do, lse, delta))
    for _ in range(3):
        o2, _ = FA.flash_fwd(q, k, v)
        again = (o2, FA.flash_bwd_dq(q, k, v, do, lse, delta),
                 *FA.flash_bwd_dkv(q, k, v, do, lse, delta))
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert FA.sm90_launch_counts() == {n: c + 4
                                       for n, c in sm90_before.items()}


def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    for shape, dtype in (((1, 128, 2, 12), torch.float32),
                         ((1, 128, 2, 264), torch.float32),
                         ((1, 128, 2, 64), torch.float64),
                         ((1, 100, 2, 64), torch.float32)):
        q = torch.zeros(shape, dtype=dtype, device=cuda)
        with pytest.raises(HorovodTpuError):
            FA.flash_fwd(q, q, q)
    q = torch.zeros((1, 128, 2, 64), device=cuda)
    with pytest.raises(HorovodTpuError):
        FA.flash_fwd(q, q.cpu(), q)


def test_transformer_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """A small model with attention routed to the kernels: logits and
    gradients against the CPU (plain versions), f32 with TF32 off."""
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "1")
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                            d_head=32, d_ff=512, n_layers=2,
                            n_kv_heads=2, compute_dtype=torch.float32)
    model = Transformer(cfg, seed=5)
    x = torch.randint(0, 256, (2, 257), generator=torch.Generator()
                      .manual_seed(6))
    before = FA.launch_counts()["flash_fwd"]
    out = []
    for m, dev in ((model, "cpu"), (Transformer(cfg, seed=5).to(cuda),
                                    cuda)):
        loss = m.loss(x[:, :-1].to(dev), x[:, 1:].to(dev))
        loss.backward()
        out.append((float(loss), [p.grad.cpu() for p in m.parameters()]))
    assert FA.launch_counts()["flash_fwd"] == before + 2
    assert abs(out[0][0] - out[1][0]) <= 1e-5 * abs(out[0][0])
    for want, got in zip(out[0][1], out[1][1]):
        assert _rel(got, want) <= 1e-4


K3_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7,
          torch.float16: 2 ** -10}


def _k3_operands(cuda, shape, dtype, layout, g):
    """a (m, k) and b = w.t() for a (n, k) weight band, as on the fused
    path: "contiguous", or a's base one element off ("offset"), or a
    stored K-major ("k_strided")."""
    m, k, n = shape
    a = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    if layout == "offset":
        a = torch.empty((m * k + 1,), dtype=dtype, device=cuda)[1:] \
            .view(m, k).copy_(a)
    elif layout == "k_strided":
        a = a.t().contiguous().t()
    w = torch.randn((n, k), generator=g, device=cuda).to(dtype)
    return a, w.t()


def _k3_vector_path(a, b, out) -> bool:
    m, n = out.shape
    return MK.vector_path(a.element_size(), m, n, a.shape[1], a.data_ptr(),
                          a.stride(0), a.stride(1), b.data_ptr(),
                          b.stride(0), b.stride(1), out.data_ptr(),
                          out.stride(0) if m > 1 else n)


@pytest.mark.parametrize("layout", ["contiguous", "offset", "k_strided"])
@pytest.mark.parametrize("shape", [(16384, 512, 512), (16384, 512, 128),
                                   (200, 304, 132), (200, 300, 130),
                                   (129, 257, 3), (7, 1000, 513), (1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_tiled_matmul_matches_plain(cuda, shape, dtype, layout):
    """K3 at the ZeRO-3 head's chunk shapes and unaligned ones, b the
    transposed view of a weight band as on the fused path, on the load
    path `vector_path` picks: the head's layout takes the vector path, a
    base one element off or an operand strided along K the strided one."""
    m, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a, b = _k3_operands(cuda, shape, dtype, layout, g)
    out = torch.empty((m, n), dtype=dtype, device=cuda)
    vec = _k3_vector_path(a, b, out)
    if shape[0] == 16384:
        assert vec == (layout == "contiguous")
    elif layout != "contiguous" and k > 1:
        assert not vec
    before = (MK.tiled_matmul.launches, MK.tiled_matmul.strided_launches)
    got = MK.tiled_matmul(a, b, out=out)
    want = MK.tiled_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert (MK.tiled_matmul.launches, MK.tiled_matmul.strided_launches) == \
        (before[0] + 1, before[1] + (not vec))
    assert got.dtype == dtype and _rel(got, want) <= K3_TOL[dtype]


@pytest.mark.parametrize("col0,vec", [(7, False), (8, True)])
def test_tiled_matmul_into_a_column_band_and_reproducible(cuda, col0, vec):
    """Into a column band of a wider output, as the fused head writes it:
    at column 7 (not 16-byte aligned: the strided path) and at 8 (the
    vector path); the same bits on every launch of either path."""
    g = torch.Generator(device=cuda).manual_seed(11)
    a = torch.randn((300, 384), generator=g, device=cuda)
    w = torch.randn((130, 384), generator=g, device=cuda)
    wide = torch.zeros((300, 400), device=cuda)
    band = wide[:, col0:col0 + 130]
    assert _k3_vector_path(a, w.t(), band) is vec
    before = MK.tiled_matmul.strided_launches
    MK.tiled_matmul(a, w.t(), out=band)
    assert MK.tiled_matmul.strided_launches == before + (not vec)
    assert _rel(band, MK.tiled_matmul_plain(a, w.t())) <= 1e-5
    assert not wide[:, :col0].any() and not wide[:, col0 + 130:].any()
    first = band.clone()
    for _ in range(3):
        MK.tiled_matmul(a, w.t(), out=band)
        assert torch.equal(band, first)


def test_tiled_matmul_raises_on_what_the_kernel_does_not_take(cuda):
    a = torch.zeros((4, 4), device=cuda, dtype=torch.float64)
    with pytest.raises(HorovodTpuError):
        MK.tiled_matmul(a, a)
    b = torch.zeros((4, 4), device=cuda)
    with pytest.raises(HorovodTpuError):
        MK.tiled_matmul(b, b.cpu())


ZERO_NCCL_WORKER = r'''
import sys
import torch
import horovod_tpu_torch as hvd
hvd.init(coordinator_address=sys.argv[1], num_processes=1, process_id=0)
dev = hvd.device()
g = torch.Generator().manual_seed(0)
base = [torch.randn(64, 33, generator=g), torch.randn(70, generator=g)]
grads = [[torch.randn_like(b) for b in base] for _ in range(3)]
out = {}
for stage in (0, 1):
    ps = [torch.nn.Parameter(b.to(dev)) for b in base]
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(ps, lr=1e-2, weight_decay=1e-2), zero_stage=stage,
        fusion_threshold_bytes=4096)
    for gs in grads:
        for p, gg in zip(ps, gs):
            p.grad = gg.to(dev)
        opt.step()
        opt.zero_grad()
    out[stage] = [p.detach().cpu() for p in ps]
ok = all(torch.equal(a, b) for a, b in zip(out[0], out[1]))
print("BACKEND", hvd.backend(), "EQUAL", ok, flush=True)
hvd.shutdown()
'''


def test_zero_stage1_one_rank_on_nccl(cuda):
    """ZeRO-1 at np=1 over an NCCL group of one: the reduce-scatter and
    the allgather run on the card, and the parameters equal stage 0's
    bit for bit (AdamW is elementwise)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for k in [k for k in env if k.startswith("HOROVOD_")]:
        env.pop(k)
    r = subprocess.run([sys.executable, "-c", ZERO_NCCL_WORKER,
                        f"tcp://127.0.0.1:{port}"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BACKEND nccl EQUAL True" in r.stdout, r.stdout + r.stderr


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GLOO_WORKER = r'''
import sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import adasum_kernels as K

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r)
dev = hvd.device()
x = torch.randn(1000, generator=torch.Generator().manual_seed(r))
res = {"backend": hvd.backend(), "device": str(dev), "x": x}
for op in ("Sum", "Average", "Max"):
    res[op] = hvd.allreduce(x.to(dev), op=getattr(hvd, op))
for dt in (torch.float32, torch.bfloat16, torch.float16):
    res[f"Adasum_{dt}"] = hvd.allreduce(x.to(dev, dt), op=hvd.Adasum)
res["grouped_Adasum"] = hvd.grouped_allreduce(
    [x[:300].to(dev), x[300:].to(dev, torch.float16)], op=hvd.Adasum)
res["allgather"] = hvd.allgather(x.to(dev, torch.bfloat16)[None])
res["broadcast"] = hvd.broadcast(x.to(dev), root_rank=1)
ii = torch.arange(5, device=dev) * (r + 1)
hvd.broadcast_(ii, root_rank=1)
res["broadcast_"] = ii
from horovod_tpu_torch.ops import fused_collectives as F
flat = torch.arange(2 * 640, dtype=torch.float32, device=dev) * (r + 1)
res["reducescatter"] = hvd.reducescatter(flat, op=hvd.Sum)
res["reducescatter_bf16"] = hvd.reducescatter(flat.bfloat16(), op=hvd.Average)
res["psum_scatter"] = F.pipelined_psum_scatter(flat, chunk_bytes=1024)
from horovod_tpu_torch.ops import quantized as Q
for w in ("int8", "int4", "fp8_e4m3", "fp8_e5m2"):
    res["ring_" + w] = Q.quantized_allreduce_shard(x.to(dev), average=True,
                                                   wire=w)
    res["rs_" + w] = Q.quantized_reducescatter_shard(x.to(dev), wire=w)
res["on_card"] = all(t.is_cuda for v in res.values()
                     for t in (v if isinstance(v, list) else [v])
                     if isinstance(t, torch.Tensor) and t is not x)
res = {k: ([t.cpu() for t in v] if isinstance(v, list) else
           v.cpu() if isinstance(v, torch.Tensor) else v)
       for k, v in res.items()}
res["launches"] = K.launch_counts()
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def gloo_on_card(tmp_path_factory):
    """Two ranks on card 0 over gloo (NCCL refuses two ranks on one
    card), every collective on CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tmp = tmp_path_factory.mktemp("gloo_card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for k in [k for k in env if k.startswith("HOROVOD_")]:
        env.pop(k)
    url = f"file://{tmp}/rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_WORKER, str(tmp), "2", str(r), url],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return [torch.load(tmp / f"rank{r}.pt") for r in range(2)]


def test_gloo_on_card_runs_on_cuda_tensors(gloo_on_card):
    for d in gloo_on_card:
        assert d["backend"] == "gloo" and d["device"] == "cuda:0"
        assert d["on_card"]
        # Five Adasum trees (three allreduces, the grouped one's two
        # dtype buckets), one level each at two ranks.
        assert d["launches"] == {"fused_dot_norms": 5, "fused_scaled_add": 5}


@pytest.mark.parametrize("key", ["Sum", "Average", "Max", "allgather",
                                 "broadcast", "broadcast_"])
def test_gloo_on_card_moves_the_right_values(gloo_on_card, key):
    x0, x1 = (d["x"] for d in gloo_on_card)
    want = {"Sum": x0 + x1, "Average": (x0 + x1) / 2,
            "Max": torch.maximum(x0, x1),
            "allgather": torch.stack([x0, x1]).bfloat16(),
            "broadcast": x1, "broadcast_": torch.arange(5) * 2}[key]
    for d in gloo_on_card:
        assert torch.equal(d[key], want)


@pytest.mark.parametrize("wire", ["int8", "int4", "fp8_e4m3", "fp8_e5m2"])
def test_gloo_on_card_ring_is_bitwise_its_model(gloo_on_card, wire):
    """The ring's hops over gloo stage through host memory; its encodes,
    decodes and adds run on the card, bitwise the plain model's on the
    card."""
    from horovod_tpu_torch.ops import quantized as Q
    xs = [d["x"].cuda() for d in gloo_on_card]
    outs, _, _ = Q.allreduce_model(xs, average=True, wire=wire)
    segs, _, _ = Q.reducescatter_model(xs, wire=wire)
    for r, d in enumerate(gloo_on_card):
        assert torch.equal(d["ring_" + wire], outs[0].cpu())
        assert torch.equal(d["rs_" + wire], segs[r].cpu())


def test_gloo_on_card_reducescatter(gloo_on_card):
    """Gloo takes CUDA tensors for reduce_scatter_tensor (the ZeRO
    gradient path of two ranks sharing a card), whole and chunked."""
    flat = torch.arange(2 * 640, dtype=torch.float32)
    total = flat * 1 + flat * 2
    for r, d in enumerate(gloo_on_card):
        band = total[r * 640:(r + 1) * 640]
        assert torch.equal(d["reducescatter"], band)
        assert torch.equal(d["psum_scatter"], band)
        assert torch.equal(d["reducescatter_bf16"],
                           (flat.bfloat16() * 1 + flat.bfloat16() * 2)
                           [r * 640:(r + 1) * 640].float().div(2).bfloat16())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_gloo_on_card_adasum_matches_the_cpu_tree(gloo_on_card, dtype):
    """The kernels' tree on the gathered stack against the plain tree on
    the CPU: 1e-5 of the largest value in f32, one rounding of the
    result apart in bf16 / f16."""
    stack = torch.stack([d["x"] for d in gloo_on_card]).to(dtype)
    want = adasum.adasum_tree_reduce(stack).float()
    got = gloo_on_card[0][f"Adasum_{dtype}"]
    assert got.dtype == dtype
    assert torch.equal(got, gloo_on_card[1][f"Adasum_{dtype}"])
    tol = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7,
           torch.float16: 2 ** -10}[dtype] * float(want.abs().max())
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


def test_gloo_on_card_grouped_adasum_fuses_by_dtype(gloo_on_card):
    xs = [d["x"] for d in gloo_on_card]
    want32 = adasum.adasum_tree_reduce(torch.stack([x[:300] for x in xs]))
    want16 = adasum.adasum_tree_reduce(
        torch.stack([x[300:] for x in xs]).half())
    got32, got16 = gloo_on_card[0]["grouped_Adasum"]
    assert got16.dtype == torch.float16
    torch.testing.assert_close(got32, want32, rtol=0,
                               atol=1e-5 * float(want32.abs().max()))
    torch.testing.assert_close(got16.float(), want16.float(), rtol=0,
                               atol=2 ** -10 * float(want16.abs().max()))


# ---------------------------------------------------------------------------
# SyncBatchNorm, the sparse allreduce and an elastic reset on the card
# ---------------------------------------------------------------------------

SURFACE7_WORKER = r'''
import sys
import torch
import horovod_tpu_torch as hvd
import chip_smoke

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r)
res = chip_smoke.surface_sparse_and_syncbn(hvd, hvd.device(),
                                           lambda name, fn: fn())
res["backend"] = hvd.backend()
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def sparse_syncbn_on_card(tmp_path_factory):
    """Two ranks on card 0 over gloo at chip_smoke's surface_np2 shapes:
    the gradient of nn.Embedding(32000, 512, sparse=True) over 16,384
    ids per rank, and SyncBatchNorm(256) on (32, 256, 56, 56) bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tmp = tmp_path_factory.mktemp("sparse_syncbn_card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for k in [k for k in env if k.startswith("HOROVOD_")]:
        env.pop(k)
    url = f"file://{tmp}/rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-c", SURFACE7_WORKER, str(tmp), "2", str(r), url],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return [torch.load(tmp / f"rank{r}.pt") for r in range(2)]


def test_sparse_allreduce_on_card_matches_the_dense_allreduce(
        sparse_syncbn_on_card):
    """Within chip_smoke.SPARSE_RTOL of the largest value (each value
    divided before the duplicates are summed); the optimizer's sparse
    route stays sparse, sparse_as_dense is dense, both within it too."""
    import chip_smoke

    for d in sparse_syncbn_on_card:
        assert d["backend"] == "gloo"
        tol = chip_smoke.SPARSE_RTOL * d["sparse"]["scale"]
        assert d["sparse"]["is_sparse"] and d["sparse"]["err"] <= tol
        assert d["sparse_opt_False"]["is_sparse"]
        assert not d["sparse_opt_True"]["is_sparse"]
        for k in ("sparse_opt_False", "sparse_opt_True"):
            assert d[k]["err"] <= tol, (k, d[k])


@pytest.mark.parametrize("key", ["y", "grad_x", "grad_weight", "grad_bias",
                                 "running_mean", "running_var"])
def test_sync_batchnorm_on_card_is_batchnorm2d_over_both_batches(
        sparse_syncbn_on_card, key):
    """bf16 output and gradients within one bf16 ulp of the largest
    value (chip_smoke.SYNC_BN_TOL), the f32 running statistics within
    SYNC_BN_STAT_TOL, of one f32 BatchNorm2d over both ranks' batches."""
    import chip_smoke

    tol = (chip_smoke.SYNC_BN_STAT_TOL if key.startswith("running")
           else chip_smoke.SYNC_BN_TOL)
    for d in sparse_syncbn_on_card:
        assert d["sync_bn"]["dtype"] == "torch.bfloat16"
        assert d["sync_bn"][key] <= tol, (key, d["sync_bn"])


NCCL_RESET_WORKER = r'''
import importlib, json, os, sys
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd

elastic = importlib.import_module("horovod_tpu_torch.elastic")
hvd.init(coordinator_address=sys.argv[1], num_processes=1, process_id=0)
dev = hvd.device()
out = {"backend": [hvd.backend()]}
model = torch.nn.Sequential(*[torch.nn.Linear(1024, 1024) for _ in range(4)]).to(dev)
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1))
os.environ["HOROVOD_FUSION_THRESHOLD"] = str(4 << 20)
model(torch.ones(8, 1024, device=dev)).sum().backward()
out["in_flight_handles"] = len(opt._in_flight)
# NCCL work still queued on the group when it is torn down.
big = torch.ones(1 << 24, device=dev)
work = dist.all_reduce(big, async_op=True)
elastic._reset()
opt.reset_step_state()
out["backend"].append(hvd.backend())
out["after_reset"] = (len(opt._in_flight), len(opt._bucket))
opt.zero_grad()
model(torch.ones(8, 1024, device=dev)).sum().backward()
opt.step()
out["allreduce"] = float(hvd.allreduce(torch.full((3,), 2.0, device=dev))[0])
out["finite"] = all(torch.isfinite(p).all().item() for p in model.parameters())
print("RESULT " + json.dumps(out), flush=True)
hvd.shutdown()
'''


def test_elastic_reset_of_an_nccl_group_with_buckets_in_flight(cuda):
    """np=1 on NCCL: gradient buckets dispatched and not waited for, and
    an NCCL allreduce queued on the group, when `_reset` tears the
    group down and builds it again on the same tcp:// store; the
    optimizer drops the failed step's state, and the next step runs."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for k in [k for k in env if k.startswith("HOROVOD_")]:
        env.pop(k)
    r = subprocess.run([sys.executable, "-c", NCCL_RESET_WORKER,
                        f"tcp://127.0.0.1:{port}"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [l for l in r.stdout.splitlines() if l.startswith("RESULT ")][0]
    out = json.loads(line[7:])
    assert out["backend"] == ["nccl", "nccl"]
    assert out["in_flight_handles"] >= 1
    assert out["after_reset"] == [0, 0]
    assert out["allreduce"] == 2.0 and out["finite"]


@pytest.mark.parametrize("wire", ["int8", "int4", "fp8_e4m3", "fp8_e5m2",
                                  "bf16", "fp16"])
def test_codecs_on_card_are_bitwise_the_cpu(cuda, wire):
    from horovod_tpu_torch.ops import wire as W
    sys.path.insert(0, REPO)
    import chip_smoke
    g = torch.Generator().manual_seed(9)
    v = torch.randn(128 * 300, generator=g) * torch.tensor(
        [1e-3, 1.0, 30.0])[torch.randint(0, 3, (128 * 300,), generator=g)]
    v[:128] = 0.0
    v[130], v[260], v[261] = float("nan"), float("inf"), float("-inf")
    v[384:512] = torch.arange(-127.0, 1.0)
    v[512:640] = torch.arange(-7.0, 8.0, 0.5).repeat(9)[:128]
    # A NaN block keeps the scale 1: its values past e4m3's 464 and an
    # inf reach the cast unnormalised (e4m3 writes NaN there, as XLA).
    v[640:768] = torch.linspace(-600.0, 600.0, 128)
    v[641], v[642] = float("nan"), float("inf")
    codec = W.get_codec(wire)
    if codec.cast_dtype is not None:
        # A cast's NaN code is the backend's own.
        v = torch.where(torch.isfinite(v), v, torch.ones_like(v))
    enc_c, enc_g = codec.encode(v), codec.encode(v.to(cuda))
    # (part, byte, cpu, card); an fp8 NaN code of either sign matches one
    # (inf / inf is x86's negative default NaN, CUDA's positive one).
    assert not chip_smoke.wire_mismatch(enc_c, enc_g)
    dec_c, dec_g = codec.decode(enc_c), codec.decode(enc_g).cpu()
    nan = torch.isnan(dec_c)
    assert torch.equal(nan, torch.isnan(dec_g))
    bad = torch.nonzero((dec_c.view(torch.int32) != dec_g.view(torch.int32))
                        & ~nan).reshape(-1)[:5]
    assert not bad.numel(), (f"decode differs at {bad.tolist()}: cpu "
                             f"{dec_c[bad].tolist()}, card "
                             f"{dec_g[bad].tolist()}")


# ---------------------------------------------------------------------------
# The mesh on the card: the Adasum ladder and the flash ring over gloo
# ---------------------------------------------------------------------------

MESH_WORKER = r'''
import os, sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import adasum
from horovod_tpu_torch.ops import flash_attention as FA
from horovod_tpu_torch.parallel import sequence as S

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r)
dev = hvd.device()
res = {}
x = torch.randn(70001, generator=torch.Generator().manual_seed(r))
for dt in (torch.float32, torch.bfloat16, torch.float16):
    res[f"ladder_{dt}"] = adasum.adasum_in_axis(x.to(dev, dt)).cpu()
    res[f"stack_{dt}"] = hvd.allgather(x.to(dev, dt)[None]).cpu()
ps = hvd.global_process_set()
for name, (H, Hkv, causal, dt) in {
        "bf16_causal": (4, 4, True, torch.bfloat16),
        "bf16_dense": (4, 4, False, torch.bfloat16),
        "bf16_gqa": (4, 2, True, torch.bfloat16),
        "f32_causal": (2, 2, True, torch.float32)}.items():
    g = torch.Generator().manual_seed(100 + r)
    base = [torch.randn(1, 128, h, 64, generator=g) for h in (H, Hkv, Hkv, H)]
    for where, flash in (("card", "1"), ("cpu", "1"), ("blockwise", "0")):
        os.environ["HOROVOD_FLASH_ATTENTION"] = flash
        d = "cpu" if where == "cpu" else dev
        q, k, v, c = (t.to(d, dt if i < 3 else torch.float32).detach()
                      .requires_grad_(i < 3) for i, t in enumerate(base))
        before = FA.sm90_launch_counts()
        out = S.ring_attention_shard(q, k, v, ps, causal=causal)
        (out.float() * c).sum().backward()
        after = FA.sm90_launch_counts()
        res[(name, where)] = [t.detach().float().cpu()
                              for t in (out, q.grad, k.grad, v.grad)]
        res[(name, where, "sm90")] = after["flash_fwd"] - before["flash_fwd"]
res["launches"] = FA.launch_counts()
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def mesh_on_card(tmp_path_factory):
    """Three ranks on card 0 over gloo: the Adasum ladder (a residual
    fold, one level, the result back) and the sp=3 flash ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tmp = tmp_path_factory.mktemp("mesh_card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for k in [k for k in env if k.startswith("HOROVOD_")]:
        env.pop(k)
    url = f"file://{tmp}/rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_WORKER, str(tmp), "3", str(r), url],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(3)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_ladder_on_card_is_bitwise_the_kernel_tree(mesh_on_card, dtype):
    """The ladder pairs the same vectors in the same order as the tree on
    the gathered stack, through the same kernels: bitwise."""
    stack = mesh_on_card[0][f"stack_{dtype}"].cuda()
    want = adasum.adasum_tree_reduce(stack).cpu()
    for d in mesh_on_card:
        assert torch.equal(d[f"ladder_{dtype}"], want)


@pytest.mark.parametrize("name", ["bf16_causal", "bf16_dense", "bf16_gqa",
                                  "f32_causal"])
def test_flash_ring_on_card_matches_its_plain_engine(mesh_on_card, name):
    """The sp=3 flash ring on the card (bf16 on the tensor-core K4-K6,
    f32 on the CUDA cores; causal diagonal pairs, non-causal past pairs,
    skipped future pairs) against the same ring on the CPU (the kernels'
    plain versions) and against the blockwise ring on the card: output
    and input gradients within the dtype's flash tolerance (2^-6 bf16,
    1e-4 f32) of their largest value."""
    tol = 2 ** -6 if name.startswith("bf16") else 1e-4
    for r, d in enumerate(mesh_on_card):
        want_launches = (r + 1) if name != "bf16_dense" else 3
        assert d[(name, "card", "sm90")] == (
            want_launches if name.startswith("bf16") else 0)
        for other in ("cpu", "blockwise"):
            for got, want in zip(d[(name, "card")], d[(name, other)]):
                err = float((got - want).abs().max())
                assert err <= tol * float(want.abs().max()), (name, other,
                                                              err)


# ---------------------------------------------------------------------------
# Decode and serving on the card
# ---------------------------------------------------------------------------

def test_flash_attention_without_autograd_launches_k4_alone(cuda):
    """Inference (no_grad, or inputs that need no gradient) runs K4 only,
    with nothing saved for a backward, and gives the autograd path's
    output."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn((2, 512, 8, 64), generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    FA.reset_launch_counts()
    with torch.no_grad():
        o = FA.flash_attention(q, k, v)
    assert FA.launch_counts() == {"flash_fwd": 1, "flash_bwd_dq": 0,
                                  "flash_bwd_dkv": 0}
    assert o.grad_fn is None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o2 = FA.flash_attention(*leaves)
    assert o2.grad_fn is not None and torch.equal(o, o2.detach())


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_decode_on_the_card_matches_the_cpu(cuda, quantize, monkeypatch):
    """A 2-layer bf16 model at d_head 64: the prefill at T0 = 256 takes
    K4 once per layer on the tensor cores (HOROVOD_FLASH_ATTENTION=1),
    the decode steps none; the card's greedy tokens follow the CPU
    chain's (plain attention) up to the first near-tie (0.05), the
    prefill logits within 5e-2 of the CPU's largest."""
    from horovod_tpu_torch.models import decode as D
    from horovod_tpu_torch.models import transformer as T

    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "1")
    cfg = TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                            d_head=64, d_ff=256, n_layers=2)
    params = T.transformer_init(0, cfg)
    prompt = torch.randint(0, 512, (2, 256),
                           generator=torch.Generator().manual_seed(1))
    FA.reset_launch_counts()
    toks, _ = D.transformer_generate(T.tree_map(lambda a: a.to(cuda),
                                                params), cfg,
                                     prompt.to(cuda), 8, quantize=quantize)
    assert FA.launch_counts()["flash_fwd"] == 2
    assert FA.sm90_launch_counts()["flash_fwd"] == 2
    cache = D.init_decode_cache(cfg, 2, 264, quantize=quantize,
                                device="cpu")
    lg, cache = D.transformer_prefill(D.decode_params(params, cfg), cache,
                                      prompt, cfg)
    dp = D.decode_params(params, cfg)
    cache_c = D.init_decode_cache(cfg, 2, 264, quantize=quantize,
                                  device=cuda)
    lg_c, _ = D.transformer_prefill(T.tree_map(lambda a: a.to(cuda), dp),
                                    cache_c, prompt.to(cuda), cfg)
    assert float((lg_c.cpu() - lg).abs().max()) <= \
        5e-2 * float(lg.abs().max())
    want, margins = [], []
    for _ in range(8):
        top2 = torch.topk(lg, 2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        want.append(torch.argmax(lg, -1))
        lg, cache = D.transformer_decode_step(dp, cache, want[-1], cfg)
    want, margins = torch.stack(want, 1), torch.stack(margins, 1)
    for b in range(2):
        ties = (margins[b] < 0.05).nonzero()
        upto = int(ties[0]) if len(ties) else 8
        assert toks[b, :upto].cpu().tolist() == want[b, :upto].tolist()


def test_server_on_the_card_matches_generate(cuda):
    """f32, int8 cache: each request's tokens follow its own batch-1
    chain up to the first near-tie (1e-3: the server's rows and the
    chain's one row may take cuBLAS kernels that sum in another order)."""
    from horovod_tpu_torch.models import decode as D
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.serve import InferenceServer

    cfg = TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                            d_head=64, d_ff=256, n_layers=2,
                            compute_dtype=torch.float32)
    params = T.tree_map(lambda a: a.to(cuda), T.transformer_init(0, cfg))
    srv = InferenceServer(params, cfg, max_seq_tokens=40, max_batch=3,
                          page_tokens=8, quantize="int8")
    rng = np.random.RandomState(2)
    reqs = [(srv.submit(p, 6), p) for p in
            (rng.randint(0, 512, size=int(rng.choice([5, 9])))
             for _ in range(5))]
    by_id = {s.req.req_id: s.generated for s in srv.run()}
    assert srv.pool.pages_free() == srv.pool.total_pages
    dp = D.decode_params(params, cfg)
    for rid, p in reqs:
        cache = D.init_decode_cache(cfg, 1, len(p) + 6, quantize="int8",
                                    device=cuda)
        lg, cache = D.transformer_prefill(dp, cache, torch.from_numpy(
            p[None]).to(cuda), cfg)
        want = []
        for _ in range(6):
            top2 = torch.topk(lg[0], 2).values
            if float(top2[0] - top2[1]) < 1e-3:
                break
            want.append(int(torch.argmax(lg[0])))
            lg, cache = D.transformer_decode_step(
                dp, cache, torch.tensor([want[-1]], device=cuda), cfg)
        assert by_id[rid][:len(want)] == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_sentinel_flags_on_card_equal_the_cpu(cuda, dtype):
    """The guard's sentinel on CUDA buckets with NaN, +Inf and -Inf at
    seeded positions: the flags are the CPU's, bit for bit, and stay on
    the card."""
    from horovod_tpu_torch.guard import bucket_flags_local, local_nonfinite

    rng = np.random.RandomState(7)
    leaves = [torch.from_numpy(rng.randn(n).astype(np.float32)).to(dtype)
              for n in (1000, 37, 4096, 5, 513, 2048)]
    for i, v in ((1, float("nan")), (2, float("inf")), (4, float("-inf"))):
        leaves[i][rng.randint(leaves[i].numel())] = v
    leaves.append(torch.arange(6))  # an integer leaf gives no flag
    parts = [[0, 6], [1], [2, 3], [4, 5]]
    want = bucket_flags_local(leaves, parts)
    got = bucket_flags_local([l.to(cuda) for l in leaves], parts)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert want.tolist() == [0.0, 1.0, 1.0, 1.0]
    for l in leaves:
        f = local_nonfinite([l.to(cuda)])
        assert f.is_cuda and torch.equal(f.cpu(), local_nonfinite([l]))


@pytest.mark.parametrize("zero_stage", [0, 1])
def test_guard_at_static_scale_on_card_is_bitwise_unguarded(cuda,
                                                            zero_stage):
    """One rank on the card: AdamW over a small transformer (bf16
    compute) for 4 steps, with guard=True at the static scale (no
    HOROVOD_GUARD_LOSS_SCALE) and without the guard: the same bits, the
    guard state on the card."""
    os.environ.pop("HOROVOD_GUARD_LOSS_SCALE", None)
    cfg = TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                            d_head=64, d_ff=256, n_layers=2,
                            compute_dtype=torch.bfloat16)
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, 512, (2, 65))).to(cuda)

    def run(guard):
        model = Transformer(cfg, seed=0).to(cuda)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3),
            named_parameters=model.named_parameters(),
            zero_stage=zero_stage, guard=guard)
        for _ in range(4):
            opt.zero_grad(set_to_none=True)
            logits = model(tokens[:, :-1])
            torch.nn.functional.cross_entropy(
                logits.reshape(-1, 512).float(),
                tokens[:, 1:].reshape(-1)).backward()
            opt.step()
        if guard:
            assert opt.guard_state.loss_scale.is_cuda
            assert float(opt.guard_state.loss_scale) == 1.0
        return [p.detach().cpu() for p in model.parameters()]

    hvd.init()
    try:
        off, on = run(False), run(True)
    finally:
        hvd.shutdown()
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(off, on))


# ---------------------------------------------------------------------------
# The hierarchical data plane and fused_apply on the card
# ---------------------------------------------------------------------------

HIER_WORKER = r'''
import os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import hierarchical as H
from horovod_tpu_torch.parallel.mesh import create_hierarchical_mesh

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r)
dev = hvd.device()
mesh = create_hierarchical_mesh(2, 2)
rng = np.random.RandomState(r)
x = torch.from_numpy(rng.randn(100_003).astype(np.float32)).to(dev)
xi = torch.from_numpy(np.round(rng.randn(4 * 2500) * 8).astype(
    np.float32)).to(dev)
res = {"on_card": x.is_cuda}
res["hier"] = H.hierarchical_reduce_leaf(x, mesh, average=True).cpu()
res["flat"] = hvd.allreduce(x, op=hvd.Average).cpu()
res["int8"] = H.hierarchical_reduce_leaf(x, mesh, average=True,
                                         dcn_wire="int8").cpu()
shard = H.hierarchical_reduce_scatter(xi, mesh)
res["rs_ag"] = H.hierarchical_all_gather(shard, mesh).cpu()
res["int_sum"] = hvd.allreduce(xi, op=hvd.Sum).cpu()
res["x_max"] = float(x.abs().max())

SHAPES = [(64, 33), (17,), (8, 8, 8), (1000,)]


def run(hier, **kw):
    if hier:
        os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    params = [torch.nn.Parameter(torch.zeros(s, device=dev)) for s in SHAPES]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=1.0, momentum=0.5),
        axis_name=mesh if hier else None, fusion_threshold_bytes=4096,
        backward_passes_per_step=2, **kw)
    for t in range(6):
        g = np.random.RandomState(100 * t + r)
        for p in params:
            v = torch.from_numpy((g.randint(-20, 20, p.shape) * 8).astype(
                np.float32)).to(dev)
            p.grad = v if p.grad is None else p.grad + v
        opt.step()
        if t % 2:
            opt.zero_grad(set_to_none=True)
    os.environ.pop("HOROVOD_HIERARCHICAL_ALLREDUCE", None)
    return [p.detach().cpu() for p in params]


res["opt_flat"] = run(False)
res["opt_hier"] = run(True, fused_apply=True, early_reduction=True)
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def hier_on_card(tmp_path_factory):
    """Four ranks on card 0 over gloo as create_hierarchical_mesh(2, 2),
    every leg on CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tmp = tmp_path_factory.mktemp("hier_card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for k in [k for k in env if k.startswith("HOROVOD_")]:
        env.pop(k)
    url = f"file://{tmp}/rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-c", HIER_WORKER, str(tmp), "4", str(r), url],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


def test_hierarchical_leaf_on_card_matches_the_flat_allreduce(hier_on_card):
    """The three legs on CUDA tensors over gloo: within 1e-6 of the
    largest value of the flat allreduce (four addends summed in another
    order), bitwise on integer values (the reduce-scatter and allgather
    round trip, dcn-major); the int8 dcn leg within two int8 encodes of
    the exact one (half a step each of a block at most the four ranks'
    largest |x| summed, over 4), and not equal to it."""
    for d in hier_on_card:
        assert d["on_card"]
        top = float(d["flat"].abs().max())
        assert float((d["hier"] - d["flat"]).abs().max()) <= 1e-6 * top
        assert torch.equal(d["rs_ag"], d["int_sum"])
        bound = 2 * sum(e["x_max"] for e in hier_on_card) / 254 / 4
        err = float((d["int8"] - d["hier"]).abs().max())
        assert 0 < err <= bound
    assert all(torch.equal(d["hier"], hier_on_card[0]["hier"])
               for d in hier_on_card)


def test_hierarchical_optimizer_on_card_is_bitwise_the_flat_one(
        hier_on_card):
    """Stage 0 over the pair with fused_apply and early_reduction (K = 2)
    on integer gradients: bitwise the flat, unfused path on every rank."""
    for d in hier_on_card:
        assert all(torch.equal(a, b) for a, b in zip(d["opt_hier"],
                                                     d["opt_flat"]))


def test_fused_apply_on_card_is_bitwise_unfused(cuda):
    """One rank on the card: AdamW over a small transformer (bf16
    compute), several buckets each stepping its own local optimizer, the
    same bits as the one inner step."""
    cfg = TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                            d_head=64, d_ff=256, n_layers=2,
                            compute_dtype=torch.bfloat16)
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, 512, (2, 65))).to(cuda)

    def run(fused):
        model = Transformer(cfg, seed=0).to(cuda)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3),
            named_parameters=model.named_parameters(), fused_apply=fused,
            fusion_threshold_bytes=1 << 18)
        if fused:
            assert len(opt.bucket_optimizers) > 1
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            logits = model(tokens[:, :-1])
            torch.nn.functional.cross_entropy(
                logits.reshape(-1, 512).float(),
                tokens[:, 1:].reshape(-1)).backward()
            opt.step()
        return [p.detach().cpu() for p in model.parameters()]

    hvd.init()
    try:
        off, on = run(False), run(True)
    finally:
        hvd.shutdown()
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(off, on))


# ---------------------------------------------------------------------------
# The runtime utilities on the card: megastep's CUDA graph, the prefetcher
# ---------------------------------------------------------------------------

MEGA_CFG = dict(vocab_size=512, d_model=128, n_heads=2, d_head=64, d_ff=256,
                n_layers=2)
MEGA_T = 512  # flash routes from HOROVOD_FLASH_ATTENTION_MIN_T (512) up


def _mega_setup(cuda):
    from horovod_tpu_torch.models.transformer import lm_loss

    cfg = TransformerConfig(**MEGA_CFG, compute_dtype=torch.bfloat16)
    model = Transformer(cfg, seed=0).to(cuda)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3, capturable=True),
        named_parameters=model.named_parameters())

    def step(carry, tokens):
        m, o = carry
        o.zero_grad(set_to_none=True)
        loss = lm_loss(m(tokens[:, :-1]), tokens[:, 1:])
        loss.backward()
        o.step()
        return carry, loss.detach()

    return model, opt, step


def _tokens(seed, shape, cuda=None):
    t = torch.from_numpy(np.random.RandomState(seed).randint(
        0, MEGA_CFG["vocab_size"], shape))
    return t if cuda is None else t.to(cuda)


def _bits(model):
    return [p.detach().cpu().view(torch.uint8) for p in model.parameters()]


def test_megastep_replay_is_bitwise_the_eager_loop(cuda):
    """repeat_steps(k=2): the warm-up, the capture (which replays once)
    and a pure replay give the eager loop's losses and parameters bit for
    bit; the flash kernels run inside the graph."""
    from horovod_tpu_torch.utils import megastep

    tokens = _tokens(5, (1, MEGA_T + 1), cuda)
    hvd.init()
    try:
        model, opt, step = _mega_setup(cuda)
        eager = [step((model, opt), tokens)[1].clone() for _ in range(6)]
        want = _bits(model)
        model, opt, step = _mega_setup(cuda)
        mstep = megastep.repeat_steps(step, 2, out_mode="all")
        FA.reset_launch_counts()
        got = []
        for c in range(3):
            _, losses = mstep((model, opt), tokens)
            got.append(losses.clone())
            assert (mstep.graph is not None) == (c >= 1)
        counts = FA.sm90_launch_counts()
    finally:
        hvd.shutdown()
    assert torch.equal(torch.stack(eager), torch.cat(got))
    assert all(torch.equal(a, b) for a, b in zip(want, _bits(model)))
    # The warm-up's 2 steps and the capture's 2 (replays count none).
    assert all(c == 4 * MEGA_CFG["n_layers"] for c in counts.values())



def test_megastep_captures_again_after_a_reaction_change(cuda):
    """`set_reaction_rebalance` between two calls moves the reaction
    generation: the next call captures the graph again (the port's
    retrace) and the replays after it are bitwise the eager steps."""
    from horovod_tpu_torch.parallel import data_parallel as dp
    from horovod_tpu_torch.utils import megastep

    tokens = _tokens(6, (1, MEGA_T + 1), cuda)
    saved = dict(dp._REACTION)
    hvd.init()
    try:
        model, opt, step = _mega_setup(cuda)
        eager = [step((model, opt), tokens)[1].clone() for _ in range(8)]
        want = _bits(model)
        model, opt, step = _mega_setup(cuda)
        mstep = megastep.repeat_steps(step, 2, out_mode="all")
        got, graphs = [], []
        for c in range(4):
            if c == 2:
                dp.set_reaction_rebalance(1, avoid_rank=0)
            _, losses = mstep((model, opt), tokens)
            got.append(losses.clone())
            graphs.append(mstep.graph)
        captures = mstep.captures
    finally:
        dp._REACTION.clear()
        dp._REACTION.update(saved)
        hvd.shutdown()
    assert captures == 2
    assert graphs[2] is not graphs[1] and graphs[3] is graphs[2]
    assert torch.equal(torch.stack(eager), torch.cat(got))
    assert all(torch.equal(a, b) for a, b in zip(want, _bits(model)))


@pytest.mark.parametrize("max_buckets", [0, 1, 3])
def test_reaction_cap_on_cuda_leaves(cuda, max_buckets):
    """The cap reads metadata only: CUDA leaves get their CPU copies'
    partition, on the exact wire and on int8, and one bucket under a cap
    of 1; the eager reduction at one rank gives the same values armed
    or not."""
    from horovod_tpu_torch.parallel import data_parallel as dp

    g = torch.Generator().manual_seed(3)
    cpu = [torch.randn(s, generator=g).to(dt) for s, dt in [
        ((64, 33), torch.float32), ((1000,), torch.float32),
        ((5, 5, 5), torch.bfloat16), ((2048,), torch.float32),
        ((31, 17), torch.float16)]] + [torch.arange(7, dtype=torch.int32)]
    leaves = [t.to(cuda) for t in cpu]
    saved = dict(dp._REACTION)
    hvd.init()
    try:
        plain = dp.allreduce_gradients(leaves, fusion_threshold_bytes=4096)
        dp.set_reaction_rebalance(max_buckets, avoid_rank=0)
        for wire in (hvd.Compression.none, hvd.Compression.int8):
            got = dp.gradient_bucket_partition(
                leaves, compression=wire, fusion_threshold_bytes=4096)
            assert got == dp.gradient_bucket_partition(
                cpu, compression=wire, fusion_threshold_bytes=4096)
            if max_buckets == 1:
                assert sum(any(leaves[i].dtype.is_floating_point
                               for i in b) for b in got) == 1
        armed = dp.allreduce_gradients(leaves, fusion_threshold_bytes=4096)
    finally:
        dp._REACTION.clear()
        dp._REACTION.update(saved)
        hvd.shutdown()
    assert all(a.is_cuda and torch.equal(a, b)
               for a, b in zip(armed, plain))

def test_scan_steps_on_prefetched_batches_is_bitwise_the_loop(cuda):
    from horovod_tpu_torch.utils import megastep

    sources = [_tokens(10 + c, (2, 1, MEGA_T + 1)) for c in range(3)]
    hvd.init()
    try:
        model, opt, step = _mega_setup(cuda)
        eager = [step((model, opt), s[j].to(cuda))[1].clone()
                 for s in sources for j in range(2)]
        want = _bits(model)
        model, opt, step = _mega_setup(cuda)
        sstep = megastep.scan_steps(step, 2)
        got = []
        for src, batch in zip(sources, hvd.prefetch_to_device(
                iter(sources), size=2)):
            assert batch.is_cuda and torch.equal(batch.cpu(), src)
            _, last = sstep((model, opt), batch)
            got.append(last.clone())
    finally:
        hvd.shutdown()
    assert torch.equal(torch.stack(eager[1::2]), torch.stack(got))
    assert all(torch.equal(a, b) for a, b in zip(want, _bits(model)))


def test_prefetch_copies_on_a_side_stream(cuda):
    """The host-to-device copies run on the prefetcher's own stream, not
    on the stream that computes."""
    from torch.profiler import ProfilerActivity, profile

    src = [torch.randn(1 << 20) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = [(b * 2).sum() for b in hvd.prefetch_to_device(
            iter(src), size=2, device=cuda)]
        torch.cuda.synchronize()
    for o, s in zip(out, src):
        torch.testing.assert_close(o.cpu(), (s * 2).sum())
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"prefetch_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            ev = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    copies = {e["args"]["stream"] for e in ev
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]}
    kernels = {e["args"]["stream"] for e in ev if e.get("cat") == "kernel"}
    assert copies and kernels and not copies & kernels


def test_megastep_refusals_on_card(cuda, monkeypatch):
    """No fallback: the guard, a multi-rank gloo group, a batch on the
    host and a step that reads the host each raise."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.utils import megastep

    tokens = _tokens(5, (1, MEGA_T + 1), cuda)
    hvd.init()
    try:
        model, _, step = _mega_setup(cuda)
        guarded = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3, capturable=True),
            guard=True)
        with pytest.raises(HorovodTpuError, match="under the guard"):
            megastep.repeat_steps(step, 2)((model, guarded), tokens)
        model, opt, step = _mega_setup(cuda)
        with pytest.raises(HorovodTpuError, match="as CUDA tensors"):
            megastep.repeat_steps(step, 2)((model, opt), tokens.cpu())

        with monkeypatch.context() as m:
            m.setattr(basics, "size", lambda: 2)
            m.setattr(basics, "backend", lambda: "gloo")
            with pytest.raises(HorovodTpuError, match="gloo group"):
                megastep.repeat_steps(step, 2)((model, opt), tokens)

        def reads_host(carry, t):
            carry, loss = step(carry, t)
            return carry, torch.tensor(float(loss), device=cuda)

        mstep = megastep.repeat_steps(reads_host, 2)
        mstep((model, opt), tokens)  # the eager warm-up reads it fine
        with pytest.raises(RuntimeError):
            mstep((model, opt), tokens)  # the capture cannot
        assert mstep.graph is None
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# The launcher on the card
# ---------------------------------------------------------------------------

RUN_FNS = r'''
def allreduce_on_the_card(seed):
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    hvd.init()
    r = hvd.rank()
    x = np.random.RandomState(seed + r).randn(4096).astype(np.float32)
    y = hvd.allreduce(torch.from_numpy(x).to(hvd.device()), op=hvd.Sum)
    out = (r, str(hvd.device()), hvd.backend(),
           y.cpu().numpy().tobytes().hex())
    hvd.shutdown()
    return out
'''


def test_run_np2_allreduces_on_the_card(cuda, tmp_path, monkeypatch):
    """`runner.run(np=2)`: each rank calls `hvd.init()` with no device
    and lands on card local_rank mod the card count (gloo where the two
    share one), and the sum is bitwise numpy's."""
    from horovod_tpu_torch.runner import run

    for k in ("HOROVOD_COORDINATOR_ADDR", "HOROVOD_RENDEZVOUS_ADDR"):
        monkeypatch.delenv(k, raising=False)
    (tmp_path / "card_run_fns.py").write_text(RUN_FNS)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    import card_run_fns

    out = run(card_run_fns.allreduce_on_the_card, args=(7,), np=2)
    want = sum(np.random.RandomState(7 + k).randn(4096).astype(np.float32)
               for k in range(2))
    n = torch.cuda.device_count()
    backend = "nccl" if n >= 2 else "gloo"
    assert [tuple(o[:3]) for o in out] == [
        (r, f"cuda:{r % n}", backend) for r in range(2)]
    assert all(bytes.fromhex(o[3]) == want.tobytes() for o in out)


def test_check_build_on_the_card(cuda):
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "--check-build"],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=dict(
            os.environ, PYTHONPATH=os.pathsep.join(
                [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])))
    assert r.returncode == 0, r.stderr
    for line in ("    [X] NCCL", "    [X] CUDA",
                 "    [X] CUDA kernels (adasum, flash attention, tiled "
                 "matmul)", "    [X] torch.distributed (c10d TCPStore)"):
        assert line in r.stdout.splitlines(), r.stdout
