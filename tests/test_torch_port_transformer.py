"""Port parity: the port's transformer LM against the JAX package's
single-device reference (`transformer_ref_apply`, `transformer_ref_loss`)
on the same numpy weights, carried over by `transformer_from_jax`; the
local attention routing of `parallel/sequence.py`.  (The data-parallel
trainer's tests are in test_torch_port_transformer_trainer.py.)

Config: vocab 256, d_model 128, 4 heads of 32, d_ff 512, 2 layers,
T = 256.  Both sides run with HOROVOD_FLASH_ATTENTION=1, so the JAX
reference takes its Pallas flash path (interpret mode on the CPU) and
the port its flash path (the kernels' plain versions on CPU tensors).

Tolerances: f32, 2e-5 of the largest logit and of the loss, 1e-4 of
each gradient's largest value (sums in another order through two
layers); bf16, 2^-5 of the largest logit, 1e-2 of the loss and 2^-4 of
each gradient's largest value (bf16 activations are rounded at the
same points, but from f32 values that differ in their last bits, and
the differences grow through the layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel import sequence as JS
from horovod_tpu_torch.models import Transformer, TransformerConfig, \
    transformer_from_jax
from horovod_tpu_torch.models.transformer import transformer_params
from horovod_tpu_torch.ops import flash_attention as FA
from horovod_tpu_torch.parallel import sequence as TS

SMALL = dict(vocab_size=256, d_model=128, n_heads=4, d_head=32, d_ff=512,
             n_layers=2)
T = 256
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(logits=2e-5, loss=2e-5, grad=1e-4),
       "bf16": dict(logits=2 ** -5, loss=1e-2, grad=2 ** -4)}


@pytest.fixture
def flash_on(monkeypatch):
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "1")


def _configs(dt: str, **kw):
    jdt, tdt = DTYPES[dt]
    return (JT.TransformerConfig(**SMALL, compute_dtype=jdt, **kw),
            TransformerConfig(**SMALL, compute_dtype=tdt, **kw))


def _setup(dt: str, **kw):
    jcfg, tcfg = _configs(dt, **kw)
    params = JT.transformer_init(jax.random.PRNGKey(0), jcfg)
    # Non-trivial norm scales, so the weights test sees every leaf.
    rng = np.random.RandomState(7)
    params = jax.tree_util.tree_map(np.asarray, params)
    for tree, key in ((params["blocks"]["ln1"], "scale"),
                      (params["blocks"]["ln2"], "scale"),
                      (params["final_norm"], "scale")):
        tree[key] = (1 + 0.1 * rng.randn(*tree[key].shape)).astype(
            np.float32)
    tokens = rng.randint(0, SMALL["vocab_size"], (2, T + 1))
    return jcfg, tcfg, params, tokens[:, :-1], tokens[:, 1:]


def _scaled_close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def test_transformer_from_jax_copies_every_leaf():
    _, tcfg, params, _, _ = _setup("f32")
    model = transformer_from_jax(params, tcfg)
    np.testing.assert_array_equal(model.embed.detach().numpy(),
                                  params["embed"])
    np.testing.assert_array_equal(model.final_norm.detach().numpy(),
                                  params["final_norm"]["scale"])
    blocks = params["blocks"]
    for i, block in enumerate(model.blocks):
        np.testing.assert_array_equal(block.ln1.detach().numpy(),
                                      blocks["ln1"]["scale"][i])
        np.testing.assert_array_equal(block.ln2.detach().numpy(),
                                      blocks["ln2"]["scale"][i])
        for name in ("wq", "wk", "wv", "wo", "wi", "wg", "wd"):
            np.testing.assert_array_equal(
                getattr(block, name).detach().numpy(), blocks[name][i])
    n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax


@pytest.mark.parametrize("dt,kw", [("f32", {}), ("bf16", {}),
                                   ("f32", dict(n_kv_heads=2,
                                                attn_window=100))])
def test_logits_loss_and_gradients_match_the_reference(flash_on, dt, kw):
    jcfg, tcfg, params, x, y = _setup(dt, **kw)
    tol = TOL[dt]
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jlogits, _ = JT.transformer_ref_apply(jparams, jnp.asarray(x), jcfg)
    jloss, jgrads = jax.value_and_grad(JT.transformer_ref_loss)(
        jparams, jnp.asarray(x), jnp.asarray(y), jcfg)

    model = transformer_from_jax(params, tcfg)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    logits = model(tx)
    assert logits.dtype == torch.float32
    _scaled_close(logits.detach(), jlogits, tol["logits"], "logits")
    loss = model.loss(tx, ty)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=tol["loss"])

    grads = {"embed": model.embed.grad,
             "final_norm": model.final_norm.grad}
    for name in ("ln1", "ln2", "wq", "wk", "wv", "wo", "wi", "wg", "wd"):
        grads[name] = torch.stack([getattr(b, name).grad
                                   for b in model.blocks])
    want = {"embed": jgrads["embed"],
            "final_norm": jgrads["final_norm"]["scale"],
            "ln1": jgrads["blocks"]["ln1"]["scale"],
            "ln2": jgrads["blocks"]["ln2"]["scale"]}
    want.update({n: jgrads["blocks"][n] for n in
                 ("wq", "wk", "wv", "wo", "wi", "wg", "wd")})
    for name, g in grads.items():
        _scaled_close(g, want[name], tol["grad"], f"grad {name}")


def test_the_forward_runs_the_flash_path_when_routed(flash_on, monkeypatch):
    _, tcfg, params, x, _ = _setup("f32")
    model = transformer_from_jax(params, tcfg)
    calls = []
    real = FA.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(FA, "flash_attention", counted)
    model(torch.from_numpy(x))
    assert calls == [(2, T, 4, 32)] * SMALL["n_layers"]
    monkeypatch.setenv("HOROVOD_FLASH_ATTENTION", "0")
    calls.clear()
    model(torch.from_numpy(x))
    assert calls == []


def test_config_validation_and_moe_refusal():
    with pytest.raises(ValueError, match="attn_window"):
        TransformerConfig(attn_window=-1)
    with pytest.raises(ValueError, match="n_kv_heads"):
        TransformerConfig(n_heads=8, n_kv_heads=3)
    assert TransformerConfig(n_kv_heads=2).kv_heads == 2
    assert TransformerConfig().kv_heads == 8
    # MoE layers are ported: every moe_every-th layer holds one, and the
    # converter refuses a tree whose MoE leaves do not match the config.
    cfg = TransformerConfig(**SMALL, moe_every=2)
    model = Transformer(cfg)
    assert [b.moe is not None for b in model.blocks] == [
        (i + 1) % 2 == 0 for i in range(cfg.n_layers)]
    dense = transformer_params(Transformer(TransformerConfig(**SMALL)))
    with pytest.raises(ValueError, match="MoE"):
        transformer_from_jax(dense, cfg)


# ---------------------------------------------------------------------------
# parallel/sequence.py: the dense oracle and the routing of full_attention
# ---------------------------------------------------------------------------

def _qkv(B=2, Tq=128, Tk=128, H=4, Hkv=2, D=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Tq, H, D).astype(np.float32),
            rng.randn(B, Tk, Hkv, D).astype(np.float32),
            rng.randn(B, Tk, Hkv, D).astype(np.float32))


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=40),
    dict(causal=True, q_offset=64, Tq=64),
    dict(causal=False, segments=True),
    dict(causal=True, q_offset=32, Tq=64, segments=True)])
def test_dense_attention_oracle_matches_the_jax_oracle(kw):
    kw = dict(kw)
    Tq = kw.pop("Tq", 128)
    segments = kw.pop("segments", False)
    q, k, v = _qkv(Tq=Tq)
    seg = (np.sort(np.random.RandomState(1).randint(0, 3, (2, 128)), 1)
           .astype(np.int32) if segments else None)
    want = JS.dense_attention_oracle(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), segment_ids=(
            None if seg is None else jnp.asarray(seg)), **kw)
    got = TS.dense_attention_oracle(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        segment_ids=None if seg is None else torch.from_numpy(seg), **kw)
    _scaled_close(got, want, 1e-5, "oracle")


def test_repeat_kv_matches():
    q, k, v = _qkv()
    jk, jv = JS.repeat_kv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tk, tv = TS.repeat_kv(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("shape,kw,routed", [
    ((128, 128), dict(causal=True), True),
    ((128, 128), dict(causal=True, window=32), True),
    ((128, 128), dict(causal=False), True),
    ((64, 128), dict(causal=True, q_offset=64), False),
    ((128, 128), dict(causal=True, q_offset=1), False),
    ((96, 96), dict(causal=True), False),
])
def test_full_attention_routing(flash_on, monkeypatch, shape, kw, routed):
    """full_attention takes the flash path under exactly the JAX
    package's conditions, and gives the oracle's result either way."""
    Tq, Tk = shape
    q, k, v = (torch.from_numpy(a) for a in _qkv(Tq=Tq, Tk=Tk))
    calls = []
    real = FA.flash_attention
    monkeypatch.setattr(FA, "flash_attention",
                        lambda *a, **k_: calls.append(1) or real(*a, **k_))
    got = TS.full_attention(q, k, v, **kw)
    assert bool(calls) is routed
    want = JS.full_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                             **kw)
    _scaled_close(got, want, 5e-5, "full_attention")


def test_full_attention_refuses_a_window_without_causal(flash_on):
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    with pytest.raises(ValueError, match="window requires causal"):
        TS.full_attention(q, k, v, causal=False, window=8)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("h_dt", ["compute", "f32"])
def test_tied_head_matches_the_f32_path(dt, h_dt):
    """`TiedHead` on CPU tensors (its plain version) against the head it
    replaced: the f32 einsum of the operands rounded to compute_dtype,
    through autograd.  The logits and both gradients are bitwise equal;
    the logits are also the JAX head's (`preferred_element_type=f32`)
    within 1e-6 of their largest value (f32 sums over D = 32 in another
    order)."""
    from horovod_tpu_torch.models.transformer import TiedHead

    jdt, tdt = DTYPES[dt]
    rng = np.random.RandomState(11)
    h_np = rng.randn(2, 64, 32).astype(np.float32)
    e_np = rng.randn(48, 32).astype(np.float32)
    g = torch.from_numpy(rng.randn(2, 64, 48).astype(np.float32))

    def leaves():
        h = torch.from_numpy(h_np).to(tdt if h_dt == "compute"
                                      else torch.float32)
        return h.requires_grad_(), torch.from_numpy(e_np).requires_grad_()

    h0, e0 = leaves()
    old = torch.einsum("btd,vd->btv", h0.to(tdt).float(), e0.to(tdt).float())
    old.backward(g)
    h1, e1 = leaves()
    new = TiedHead.apply(h1, e1, tdt)
    new.backward(g)
    assert new.dtype == torch.float32
    assert torch.equal(new, old)
    assert h1.grad.dtype == h0.dtype and torch.equal(h1.grad, h0.grad)
    assert torch.equal(e1.grad, e0.grad)
    want = np.asarray(jnp.einsum(
        "btd,vd->btv", jnp.asarray(h_np).astype(jdt),
        jnp.asarray(e_np).astype(jdt), preferred_element_type=jnp.float32))
    np.testing.assert_allclose(new.detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
