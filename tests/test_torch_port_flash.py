"""Port parity: `horovod_tpu_torch.ops.flash_attention` against the JAX
package's Pallas flash attention, run as tests/test_flash_attention.py
runs it (CPU platform, so the Pallas kernels run in interpret mode).

On CPU tensors the port's wrappers run the kernels' plain versions, so
this holds K4-K6's arithmetic (rounding points, masks, GQA, the lse
cotangent) to the TPU kernels'.  Inputs come from numpy seeds; both
sides take the same arrays.

Tolerances: f32, 5e-5 of the largest value of each output (sums in
another order; the plain versions take the softmax over the whole row,
the TPU kernel online over 128-key blocks); bf16, 2^-6 of it (a few
bf16 ulps: p and the outputs are rounded to bf16 from f32 values that
differ in their last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as JFA
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.ops import flash_attention as FA

TOL = {"f32": 5e-5, "bf16": 2 ** -6}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(B, T, H, Hkv, D, n_seg, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, T, Hkv, D).astype(np.float32)
    v = rng.randn(B, T, Hkv, D).astype(np.float32)
    do = rng.randn(B, T, H, D).astype(np.float32)
    dlse = rng.randn(B, T, H).astype(np.float32)
    seg = None
    if n_seg:
        seg = np.sort(rng.randint(0, n_seg, (B, T)), axis=1).astype(np.int32)
    return q, k, v, do, dlse, seg


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


# (B, T, Hq, Hkv, D, causal, window, segments, dtype)
CASES = {
    "causal": (2, 256, 4, 4, 32, True, None, 0, "f32"),
    "noncausal": (1, 256, 2, 2, 64, False, None, 0, "f32"),
    "single_block": (2, 128, 2, 2, 32, True, None, 0, "f32"),
    "window": (1, 256, 2, 2, 32, True, 100, 0, "f32"),
    "gqa": (2, 256, 4, 2, 32, True, None, 0, "f32"),
    "mqa_window": (1, 256, 4, 1, 32, True, 64, 0, "f32"),
    "segments": (2, 256, 2, 2, 32, True, None, 3, "f32"),
    "segments_noncausal_gqa": (1, 128, 4, 2, 32, False, None, 4, "f32"),
    "bf16": (1, 256, 2, 2, 64, True, None, 0, "bf16"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_gradients_match_the_pallas_kernels(name):
    """o, lse and the gradients of q, k, v under cotangents on both o
    and lse (the lse one folds into delta)."""
    B, T, H, Hkv, D, causal, window, n_seg, dt = CASES[name]
    q, k, v, do, dlse, seg = _inputs(B, T, H, Hkv, D, n_seg,
                                     seed=len(name))
    tol = TOL[dt]

    def jax_loss(q, k, v):
        o, lse = JFA.flash_attention_lse(
            q, k, v, causal=causal, window=window,
            segment_ids=None if seg is None else jnp.asarray(seg))
        return (jnp.sum(o.astype(jnp.float32) * do) + jnp.sum(lse * dlse),
                (o, lse))

    jargs = [jnp.asarray(x, JDT[dt]) for x in (q, k, v)]
    (_, (jo, jlse)), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(*jargs)

    targs = [torch.tensor(x, dtype=TDT[dt], requires_grad=True)
             for x in (q, k, v)]
    o, lse = FA.flash_attention_lse(
        *targs, causal=causal, window=window,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    assert o.dtype == TDT[dt] and lse.dtype == torch.float32
    assert o.shape == (B, T, H, D) and lse.shape == (B, T, H)
    (torch.sum(o.float() * torch.from_numpy(do))
     + torch.sum(lse * torch.from_numpy(dlse))).backward()

    _close(o.detach().float(), jo.astype(jnp.float32), tol, "o")
    _close(lse.detach(), jlse, 1e-5, "lse")
    for n, t, g in zip("qkv", targs, jgrads):
        assert t.grad.dtype == TDT[dt]
        _close(t.grad.float(), g.astype(jnp.float32), tol, f"d{n}")


def test_flash_attention_is_the_lse_variant_without_lse():
    q, k, v, *_ = _inputs(1, 128, 2, 2, 32, 0, seed=3)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    o = FA.flash_attention(q, k, v)
    o2, _ = FA.flash_attention_lse(q, k, v)
    assert torch.equal(o, o2)
    assert torch.equal(FA.flash_attention_plain(q, k, v), o)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = FA.launch_counts()
    q, k, v, *_ = _inputs(1, 128, 2, 2, 32, 0, seed=4)
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    FA.flash_attention(q, k, v).sum().backward()
    assert FA.launch_counts() == before


def test_wrapper_refuses_a_tensor_neither_on_the_cpu_nor_on_a_card():
    q = torch.zeros((1, 128, 2, 32), device="meta")
    for fn, args in ((FA.flash_fwd, (q, q, q)),
                     (FA.flash_bwd_dq, (q, q, q, q, q[..., 0], q[..., 0])),
                     (FA.flash_bwd_dkv, (q, q, q, q, q[..., 0], q[..., 0]))):
        with pytest.raises(HorovodTpuError, match="CUDA"):
            fn(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [24, 32, 40, 64, 128, 256])
def test_sm90_route_is_fixed_by_dtype_and_head_width(dtype, D):
    """bf16 and f16 at D in {64, 128} take the tensor-core K4, K5 and
    K6; f32 (TF32 would break its contract) and every other D do not."""
    want = dtype != torch.float32 and D in (64, 128)
    assert FA._sm90_route(dtype, D) is want


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64),
                                     (torch.float16, 128)])
def test_sm90_wrappers_raise_without_a_card(dtype, D):
    """A tensor that is neither on the CPU nor on a card raises before
    any route is taken; nothing counts as launched."""
    before = (FA.launch_counts(), FA.sm90_launch_counts())
    q = torch.zeros((1, 128, 2, D), dtype=dtype, device="meta")
    lse = torch.zeros((1, 128, 2), device="meta")
    for fn, args in ((FA.flash_fwd, (q, q, q)),
                     (FA.flash_bwd_dq, (q, q, q, q, lse, lse)),
                     (FA.flash_bwd_dkv, (q, q, q, q, lse, lse))):
        with pytest.raises(HorovodTpuError, match="CUDA"):
            fn(*args)
    assert (FA.launch_counts(), FA.sm90_launch_counts()) == before


def test_cpu_bf16_takes_the_plain_versions_on_either_route():
    """On the CPU the wrappers run the plain versions whatever the route
    of the dtype and D would be on a card: no launch of either kind."""
    before = (FA.launch_counts(), FA.sm90_launch_counts())
    q, k, v, *_ = _inputs(1, 128, 2, 2, 64, 0, seed=6)
    q, k, v = (torch.tensor(x, dtype=torch.bfloat16, requires_grad=True)
               for x in (q, k, v))
    FA.flash_attention(q, k, v).float().sum().backward()
    assert (FA.launch_counts(), FA.sm90_launch_counts()) == before


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.bfloat16, 40),
                                     (torch.float16, 256)])
def test_naming_the_tensor_cores_where_they_do_not_apply_raises(dtype, D):
    """`sm90=True` outside bf16 / f16 at D in {64, 128} raises, on the
    CPU as on a card, and launches nothing; `sm90=False` names the
    CUDA-core route, which on the CPU is the plain version."""
    before = (FA.launch_counts(), FA.sm90_launch_counts())
    q = torch.zeros((1, 128, 2, D), dtype=dtype)
    lse = torch.zeros((1, 128, 2))
    for fn, args in ((FA.flash_fwd, (q, q, q)),
                     (FA.flash_bwd_dq, (q, q, q, q, lse, lse)),
                     (FA.flash_bwd_dkv, (q, q, q, q, lse, lse))):
        with pytest.raises(HorovodTpuError, match="tensor-core"):
            fn(*args, sm90=True)
    o, _ = FA.flash_fwd(q, q, q, sm90=False)
    assert torch.equal(o, FA.flash_fwd_plain(q, q, q)[0])
    dq = FA.flash_bwd_dq(q, q, q, q, lse, lse, sm90=False)
    assert torch.equal(dq, FA.flash_bwd_dq_plain(q, q, q, q, lse, lse))
    assert (FA.launch_counts(), FA.sm90_launch_counts()) == before


def test_every_flash_kernel_counts_its_tensor_core_launches():
    """K4, K5 and K6 each count the launches that took the tensor-core
    route, under their own names; a reset sets every count to 0."""
    names = {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}
    assert set(FA.launch_counts()) == set(FA.sm90_launch_counts()) == names
    FA.reset_launch_counts()
    assert not any(FA.launch_counts().values())
    assert not any(FA.sm90_launch_counts().values())


# Argument errors: each must raise ValueError on both sides.
BAD = {
    "kv_shape": dict(k=(1, 128, 2, 32), v=(1, 128, 1, 32)),
    "kv_batch": dict(k=(2, 128, 2, 32), v=(2, 128, 2, 32)),
    "kv_len": dict(k=(1, 256, 2, 32), v=(1, 256, 2, 32)),
    "kv_dim": dict(k=(1, 128, 2, 16), v=(1, 128, 2, 16)),
    "gqa_heads": dict(q=(1, 128, 3, 32)),
    "dtypes": dict(kdtype="bf16"),
    "seq_len": dict(q=(1, 100, 2, 32), k=(1, 100, 2, 32),
                    v=(1, 100, 2, 32)),
    "window_noncausal": dict(window=16, causal=False),
    "window_zero": dict(window=0),
    "segment_shape": dict(seg=(1, 64)),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_argument_errors_match_the_jax_module(name):
    bad = BAD[name]
    shapes = {n: bad.get(n, (1, 128, 2, 32)) for n in "qkv"}
    arrays = {n: np.zeros(s, np.float32) for n, s in shapes.items()}
    kw = dict(causal=bad.get("causal", True), window=bad.get("window"),
              segment_ids=(np.zeros(bad["seg"], np.int32)
                           if "seg" in bad else None))
    kdt = bad.get("kdtype", "f32")
    with pytest.raises(ValueError) as jerr:
        JFA._check_and_to3(jnp.asarray(arrays["q"]),
                           jnp.asarray(arrays["k"], JDT[kdt]),
                           jnp.asarray(arrays["v"]), kw["window"],
                           kw["causal"], kw["segment_ids"])
    with pytest.raises(ValueError) as terr:
        FA.flash_attention(torch.from_numpy(arrays["q"]),
                           torch.from_numpy(arrays["k"]).to(TDT[kdt]),
                           torch.from_numpy(arrays["v"]), **kw)
    # The same check fires: the messages agree up to the framework's
    # spelling of shapes and dtypes.
    assert str(terr.value).split(" ")[:3] == str(jerr.value).split(" ")[:3]


@pytest.mark.parametrize("env,device,seq_len,want", [
    ({}, "cpu", 16384, False),
    ({}, "cuda", 16384, True),
    ({}, "cuda", 8192, False),
    ({"HOROVOD_FLASH_ATTENTION_MIN_T": "4096"}, "cuda", 8192, True),
    ({"HOROVOD_FLASH_ATTENTION": "1"}, "cpu", 128, True),
    ({"HOROVOD_FLASH_ATTENTION": "0"}, "cuda", 65536, False),
    ({"HOROVOD_FLASH_ATTENTION": ""}, "cuda", 16384, True),
    ({"HOROVOD_FLASH_ATTENTION": " "}, "cpu", 16384, False),
    ({"HVD_TPU_FLASH_ATTENTION": "yes"}, "cpu", 128, True),
])
def test_flash_routed(monkeypatch, env, device, seq_len, want):
    for k in ("HOROVOD_FLASH_ATTENTION", "HVD_TPU_FLASH_ATTENTION",
              "HOROVOD_FLASH_ATTENTION_MIN_T",
              "HVD_TPU_FLASH_ATTENTION_MIN_T"):
        monkeypatch.delenv(k, raising=False)
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    assert FA.flash_routed(seq_len, torch.device(device)) is want


def test_the_port_ignores_the_tpu_block_sizes(monkeypatch):
    """HOROVOD_FLASH_BLOCK_Q/K size the TPU kernels' VMEM tiles; the
    port's results do not depend on them."""
    q, k, v, *_ = _inputs(1, 256, 2, 2, 32, 0, seed=5)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    want = FA.flash_attention(q, k, v)
    monkeypatch.setenv("HOROVOD_FLASH_BLOCK_Q", "7")
    monkeypatch.setenv("HOROVOD_FLASH_BLOCK_K", "-1")
    assert torch.equal(FA.flash_attention(q, k, v), want)
