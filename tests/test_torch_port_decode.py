"""Port parity: KV-cache decoding (`horovod_tpu_torch/models/decode.py`)
against the JAX package's `horovod_tpu/models/decode.py`, on the CPU.

The JAX tests' small config (vocab 64, d_model 32, 4 heads x 8, d_ff 64,
2 layers, f32); weights from the JAX package's `transformer_init` carried
across as numpy, prompts from seeded numpy.  Tolerances:

- logits (prefill, decode steps, extend, quantized caches): within
  LOGIT_TOL = 1e-4 of the JAX logits' largest magnitude (measured: about
  2e-6; the two sides sum the projections in another order);
- greedy tokens equal JAX's up to the first position where the JAX
  chain's top-2 logit margin is below TIE_TOL = 1e-3 (a near-tie may
  break either way; past it the chains may part);
- the quantized caches' payloads and scales: bitwise JAX's for the same
  k/v (`_quant_vec`, and the cache writes);
- beam scores: within 2e-4 of the chain's log-probabilities under the
  port's teacher-forced forward (as the JAX test holds its own);
- `make_decode_step` on four CPU ranks over gloo (dp2 x tp2 with an
  extend and an int8 cache, tp2-gqa, dp2-moe, tp2-moe): every logit
  within 3e-4 (absolute and relative, the JAX test's tolerance) of JAX's
  `make_decode_step` on the same mesh of CPU devices, fed the same
  tokens.

Sampling cannot share JAX's PRNG streams, so sampled output is held to
its rules (top-k / top-p sets, eos padding, the accept rule preserving
the target distribution); the host-side accept rule `_spec_accept` is
bitwise JAX's under the same numpy seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from horovod_tpu.models import decode as JD
from horovod_tpu.models import transformer as JT
from horovod_tpu_torch.common.exceptions import InvalidRequestError
from horovod_tpu_torch.models import convert as TC
from horovod_tpu_torch.models import decode as TD
from horovod_tpu_torch.models import transformer as TT
from test_torch_port_collectives import no_launcher_env, run_world  # noqa: F401

LOGIT_TOL = 1e-4
TIE_TOL = 1e-3
SHARD_TOL = 3e-4
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, d_head=8, d_ff=64,
             n_layers=2)
KINDS = {"mha": {}, "gqa": dict(n_kv_heads=2),
         "moe": dict(moe_every=2, n_experts=4),
         "window": dict(n_kv_heads=2, attn_window=5)}


# The JAX functions jitted once per config and shape (the config is
# hashable), so that a chain of steps compiles once.
_jprefill = jax.jit(JD.transformer_prefill, static_argnums=3)
_jstep = jax.jit(JD.transformer_decode_step, static_argnums=3)
_jextend = jax.jit(JD.transformer_extend, static_argnums=3)


def _jcfg(**kw):
    return JT.TransformerConfig(**dict(SMALL, **kw),
                                compute_dtype=jnp.float32)


def _tcfg(**kw):
    return TT.TransformerConfig(**dict(SMALL, **kw),
                                compute_dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _params(kind):
    """(jax params, numpy params, torch params) of one config."""
    extra = KINDS[kind] if isinstance(kind, str) else dict(kind)
    jp = JT.transformer_init(jax.random.PRNGKey(0), _jcfg(**extra))
    npp = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    return jp, npp, TT.tree_map(torch.from_numpy, npp)


def _prompt(B, T, seed=1):
    return np.random.RandomState(seed).randint(0, 64, (B, T)).astype(
        np.int32)


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_TOL * float(np.abs(want).max()), (what, err)


def _jax_chain(jp, jcfg, prompt, n, quantize=None, max_len=None):
    """JAX's greedy chain: tokens [B, n] and each step's top-2 margin."""
    T0 = prompt.shape[1]
    cache = JD.init_decode_cache(jcfg, prompt.shape[0],
                                 max_len or T0 + n, quantize=quantize)
    lg, cache = _jprefill(jp, cache, jnp.asarray(prompt), jcfg)
    toks, margins = [], []
    for _ in range(n):
        lg = np.asarray(lg)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = lg.argmax(-1)
        toks.append(tok)
        lg, cache = _jstep(jp, cache, jnp.asarray(tok, jnp.int32), jcfg)
    return np.stack(toks, 1), np.stack(margins, 1)


def assert_greedy_equal(got, want, margins):
    """Tokens equal up to the first position of each row whose top-2
    margin in the reference chain is below TIE_TOL."""
    got = np.asarray(got)
    for b in range(want.shape[0]):
        ties = np.nonzero(margins[b] < TIE_TOL)[0]
        upto = int(ties[0]) if ties.size else want.shape[1]
        assert got[b, :upto].tolist() == want[b, :upto].tolist(), (
            b, upto, got[b], want[b])


# ---------------------------------------------------------------------------
# Prefill, decode steps, extend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("quantize", [None, "int8", "fp8_e4m3"])
def test_prefill_and_decode_steps_match_jax(kind, quantize):
    jp, _, tp = _params(kind)
    jcfg, tcfg = _jcfg(**KINDS[kind]), _tcfg(**KINDS[kind])
    prompt = _prompt(2, 7)
    S = 16
    jc = JD.init_decode_cache(jcfg, 2, S, quantize=quantize)
    tc = TD.init_decode_cache(tcfg, 2, S, quantize=quantize, device="cpu")
    jl, jc = _jprefill(jp, jc, jnp.asarray(prompt), jcfg)
    tl, tc = TD.transformer_prefill(tp, tc, prompt, tcfg)
    _close(tl, jl, "prefill")
    feed = np.random.RandomState(2).randint(0, 64, (5, 2)).astype(np.int32)
    for i, tok in enumerate(feed):
        jl, jc = _jstep(jp, jc, jnp.asarray(tok), jcfg)
        tl, tc = TD.transformer_decode_step(tp, tc, tok, tcfg)
        _close(tl, jl, f"step {i}")
    assert int(tc["pos"]) == int(jc["pos"]) == 12


def _leaves(c):
    return [c["q"], c["scale"]] if isinstance(c, dict) else [c]


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_vector_pos_is_bitwise_the_scalar_path_and_matches_jax(quantize):
    """Rows at one depth through a [B] pos: bitwise the scalar step.
    Rows at different depths (the serving view): JAX's vector step."""
    jp, _, tp = _params("gqa")
    jcfg, tcfg = _jcfg(**KINDS["gqa"]), _tcfg(**KINDS["gqa"])
    prompt = _prompt(3, 5)
    tc = TD.init_decode_cache(tcfg, 3, 12, quantize=quantize, device="cpu")
    _, tc = TD.transformer_prefill(tp, tc, prompt, tcfg)
    tc2 = {k: TT.tree_map(torch.clone, v) if isinstance(v, dict)
           else v.clone() for k, v in tc.items()}
    tc2["pos"] = torch.full((3,), 5, dtype=torch.int64)
    tok = np.array([4, 9, 33], np.int32)
    a, tc = TD.transformer_decode_step(tp, tc, tok, tcfg)
    b, tc2 = TD.transformer_decode_step(tp, tc2, tok, tcfg)
    assert torch.equal(a, b)
    for h in ("k", "v"):
        for x, y in zip(_leaves(tc[h]), _leaves(tc2[h])):
            assert torch.equal(x, y)
    # Different depths: rows 0..2 at positions 2, 5, 7 of one ring.
    pos = np.array([2, 5, 7])
    jc = JD.init_decode_cache(jcfg, 3, 12, quantize=quantize)
    jl, jc = _jprefill(jp, jc, jnp.asarray(_prompt(3, 8)), jcfg)
    tc = TD.init_decode_cache(tcfg, 3, 12, quantize=quantize, device="cpu")
    tl, tc = TD.transformer_prefill(tp, tc, _prompt(3, 8), tcfg)
    jc = dict(jc, pos=jnp.asarray(pos, jnp.int32))
    tc = dict(tc, pos=torch.from_numpy(pos))
    for i in range(3):
        jl, jc = _jstep(jp, jc, jnp.asarray(tok), jcfg)
        tl, tc = TD.transformer_decode_step(tp, tc, tok, tcfg)
        _close(tl, jl, f"vector step {i}")
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == \
        [5, 8, 10]


def test_extend_matches_jax_and_the_stepwise_decode():
    jp, _, tp = _params("gqa")
    jcfg, tcfg = _jcfg(**KINDS["gqa"]), _tcfg(**KINDS["gqa"])
    prompt, chunk = _prompt(2, 4), _prompt(2, 3, seed=2)
    jc = JD.init_decode_cache(jcfg, 2, 16)
    _, jc = _jprefill(jp, jc, jnp.asarray(prompt), jcfg)
    jl, jc = _jextend(jp, jc, jnp.asarray(chunk), jcfg)
    tc = TD.init_decode_cache(tcfg, 2, 16, device="cpu")
    _, tc = TD.transformer_prefill(tp, tc, prompt, tcfg)
    tl, tc = TD.transformer_extend(tp, tc, chunk, tcfg)
    _close(tl, jl, "extend")
    assert int(tc["pos"]) == 7
    tc2 = TD.init_decode_cache(tcfg, 2, 16, device="cpu")
    _, tc2 = TD.transformer_prefill(tp, tc2, prompt, tcfg)
    steps = []
    for i in range(3):
        lg, tc2 = TD.transformer_decode_step(tp, tc2, chunk[:, i], tcfg)
        steps.append(lg)
    np.testing.assert_allclose(tl.numpy(), torch.stack(steps, 1).numpy(),
                               rtol=2e-5, atol=2e-5)


def test_extend_and_prefill_rejections_match_jax():
    _, _, tp = _params("mha")
    tcfg = _tcfg()
    c = TD.init_decode_cache(tcfg, 1, 6, device="cpu")
    _, c = TD.transformer_prefill(tp, c, _prompt(1, 4), tcfg)
    with pytest.raises(ValueError, match="would wrap the ring"):
        TD.transformer_extend(tp, c, _prompt(1, 3), tcfg)
    with pytest.raises(ValueError, match="fresh cache"):
        TD.transformer_prefill(tp, c, _prompt(1, 4), tcfg)
    with pytest.raises(InvalidRequestError, match="max_len"):
        TD.transformer_prefill(tp, TD.init_decode_cache(tcfg, 1, 3,
                                                        device="cpu"),
                               _prompt(1, 4), tcfg)
    # A windowed ring that has wrapped refuses an extend that would not
    # wrap (JAX: keys still in an earlier query's window are gone); the
    # same chunk on a windowless ring is the caller's contract.
    for kind, raises in (("window", True), ("mha", False)):
        _, _, tpk = _params(kind)
        cfg = _tcfg(**KINDS[kind])
        c = TD.init_decode_cache(cfg, 1, 4, device="cpu")
        for _ in range(4):
            _, c = TD.transformer_decode_step(tpk, c, [0], cfg)
        if raises:
            with pytest.raises(ValueError, match="attn_window"):
                TD.transformer_extend(tpk, c, [[0, 0]], cfg)
        else:
            lg, _ = TD.transformer_extend(tpk, c, [[0, 0]], cfg)
            assert lg.shape == (1, 2, 64)
    with pytest.raises(InvalidRequestError, match="batch must be"):
        TD.init_decode_cache(tcfg, 0, 4, device="cpu")
    with pytest.raises(ValueError, match="quantize must be"):
        TD.init_decode_cache(tcfg, 1, 4, quantize="int4", device="cpu")


@pytest.mark.parametrize("name", ["int8", "fp8_e4m3"])
def test_quantized_cache_payload_and_scales_are_bitwise_jax(name):
    """The same k/v through `_quant_vec` and into a cache slice: payload
    bytes and scales bitwise (int8 rounds half to even on both sides)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 9, 4, 64) * rng.choice([1e-3, 1.0, 30.0],
                                             (2, 9, 4, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 3, :4] = [127.5, -0.5, 1.5, 2.5]
    jdt = jnp.int8 if name == "int8" else jnp.float8_e4m3fn
    for xx in (x, x.astype(jnp.bfloat16)):
        jq, js = JD._quant_vec(jnp.asarray(xx), jdt)
        tq, ts = TD._quant_vec(torch.from_numpy(np.asarray(xx, np.float32))
                               .to(torch.bfloat16 if xx.dtype != np.float32
                                   else torch.float32), TD._QUANT[name])
        assert np.asarray(jq).view(np.uint8).tobytes() == \
            tq.view(torch.uint8).numpy().tobytes()
        assert np.asarray(js).tobytes() == ts.numpy().tobytes()
    # The scalar and per-row cache writes: JAX's bytes.
    c = {"q": jnp.zeros((2, 12, 4, 64), jdt),
         "scale": jnp.zeros((2, 12, 4), jnp.float32)}
    jw = JD._cache_write_rows(c, jnp.asarray(x[:, :1]),
                              jnp.asarray([3, 7]))
    tc = {"q": torch.zeros((2, 12, 4, 64), dtype=TD._QUANT[name]),
          "scale": torch.zeros((2, 12, 4))}
    TD._cache_write_rows(tc, torch.from_numpy(x[:, :1]),
                         torch.tensor([[3], [7]]))
    assert np.asarray(jw["q"]).view(np.uint8).tobytes() == \
        tc["q"].view(torch.uint8).numpy().tobytes()
    assert np.asarray(jw["scale"]).tobytes() == tc["scale"].numpy().tobytes()
    jw = JD._cache_write(c, jnp.asarray(x), 2)
    TD._cache_write(tc, torch.from_numpy(x), 2)
    assert np.asarray(jw["q"]).view(np.uint8).tobytes() == \
        tc["q"].view(torch.uint8).numpy().tobytes()


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_greedy_generate_matches_jax(kind):
    jp, _, tp = _params(kind)
    jcfg, tcfg = _jcfg(**KINDS[kind]), _tcfg(**KINDS[kind])
    prompt = _prompt(2, 6, seed=3)
    want, margins = _jax_chain(jp, jcfg, prompt, 10)
    got, cache = TD.transformer_generate(tp, tcfg, prompt, 10)
    assert got.shape == (2, 10) and int(cache["pos"]) == 16
    assert_greedy_equal(got, want, margins)
    if kind == "mha":
        # JAX's own generate takes its chain (its scan of the same step).
        jt, _ = JD.transformer_generate(jp, jcfg, jnp.asarray(prompt), 10)
        assert_greedy_equal(np.asarray(jt), want, margins)


@pytest.mark.parametrize("quantize", ["int8", "fp8_e4m3"])
def test_greedy_generate_on_a_quantized_cache_matches_jax(quantize):
    jp, _, tp = _params("gqa")
    jcfg, tcfg = _jcfg(**KINDS["gqa"]), _tcfg(**KINDS["gqa"])
    prompt = _prompt(2, 5, seed=4)
    want, margins = _jax_chain(jp, jcfg, prompt, 8, quantize=quantize)
    got, _ = TD.transformer_generate(tp, tcfg, prompt, 8, quantize=quantize)
    assert_greedy_equal(got, want, margins)


def test_windowed_generate_on_a_ring_smaller_than_the_sequence():
    jp, _, tp = _params("window")
    jcfg, tcfg = _jcfg(**KINDS["window"]), _tcfg(**KINDS["window"])
    prompt = _prompt(1, 5, seed=5)
    want, margins = _jax_chain(jp, jcfg, prompt, 12, max_len=6)
    got, cache = TD.transformer_generate(tp, tcfg, prompt, 12, max_len=6)
    assert int(cache["pos"]) == 17
    assert_greedy_equal(got, want, margins)
    with pytest.raises(InvalidRequestError, match="wraps the ring"):
        TD.transformer_generate(tp, tcfg, prompt, 12, max_len=4)
    with pytest.raises(InvalidRequestError, match="only windowed"):
        TD.transformer_generate(*_params("mha")[2:], _tcfg(), prompt, 12,
                                max_len=6)


def test_eos_pads_the_tail_and_truncated_sampling_reduces_to_greedy():
    _, _, tp = _params("mha")
    tcfg = _tcfg()
    prompt = _prompt(2, 4, seed=6)
    greedy, _ = TD.transformer_generate(tp, tcfg, prompt, 8)
    eos = int(greedy[0, 2])
    out, _ = TD.transformer_generate(tp, tcfg, prompt, 8, eos_id=eos)
    for b in range(2):
        row, g = out[b].tolist(), greedy[b].tolist()
        if eos in g:
            first = g.index(eos)
            assert row[:first + 1] == g[:first + 1]
            assert row[first:] == [eos] * (8 - first)
        else:
            assert row == g
    gen = torch.Generator().manual_seed(0)
    top1, _ = TD.transformer_generate(tp, tcfg, prompt, 8, temperature=0.7,
                                      top_k=1, rng=gen)
    assert torch.equal(top1, greedy)
    nucleus, _ = TD.transformer_generate(tp, tcfg, prompt, 8,
                                         temperature=0.7, top_p=1e-6,
                                         rng=gen)
    assert torch.equal(nucleus, greedy)
    with pytest.raises(ValueError, match="need temperature"):
        TD.transformer_generate(tp, tcfg, prompt, 4, top_k=2)
    with pytest.raises(ValueError, match="needs rng"):
        TD.transformer_generate(tp, tcfg, prompt, 4, temperature=1.0)
    with pytest.raises(ValueError, match="top_p"):
        TD.transformer_generate(tp, tcfg, prompt, 4, temperature=1.0,
                                top_p=0.0, rng=gen)
    with pytest.raises(ValueError, match="eos_id"):
        TD.transformer_generate(tp, tcfg, prompt, 4, eos_id=64)
    with pytest.raises(InvalidRequestError, match="max_new_tokens"):
        TD.transformer_generate(tp, tcfg, prompt, 0)


def test_sampled_tokens_lie_in_the_top_k_and_top_p_sets():
    """Each sampled token is one of the top_k tokens (or of the nucleus)
    of the logits it was drawn from: the chain is replayed step by step
    with the same generator."""
    _, _, tp = _params("mha")
    tcfg = _tcfg()
    prompt = _prompt(3, 4, seed=7)
    for kw in (dict(top_k=3), dict(top_p=0.5), dict(top_k=4, top_p=0.6)):
        out, _ = TD.transformer_generate(
            tp, tcfg, prompt, 6, temperature=1.3,
            rng=torch.Generator().manual_seed(11), **kw)
        cache = TD.init_decode_cache(tcfg, 3, 10, device="cpu")
        lg, cache = TD.transformer_prefill(tp, cache, prompt, tcfg)
        for i in range(6):
            logits = (lg / 1.3).numpy()
            order = np.argsort(-logits, axis=-1, kind="stable")
            for b in range(3):
                ranked = logits[b, order[b]]
                keep = np.ones(64, bool)
                if "top_k" in kw:
                    keep[kw["top_k"]:] = False
                p = np.exp(ranked - ranked.max()) * keep
                p /= p.sum()
                if "top_p" in kw:
                    keep &= (np.cumsum(p) - p) < kw["top_p"]
                assert int(out[b, i]) in set(order[b][keep].tolist()), kw
            lg, cache = TD.transformer_decode_step(tp, cache, out[:, i],
                                                   tcfg)


# ---------------------------------------------------------------------------
# Speculative decoding
# ---------------------------------------------------------------------------

DRAFT = dict(d_model=16, n_heads=2, d_head=8, d_ff=32, n_layers=1)


def test_speculative_greedy_matches_plain_generate_and_jax():
    jp, _, tp = _params("mha")
    _, _, dp = _params(tuple(sorted(DRAFT.items())))
    tcfg, dcfg = _tcfg(), _tcfg(**DRAFT)
    prompt = _prompt(3, 5, seed=8)
    want, margins = _jax_chain(jp, _jcfg(), prompt, 9)
    plain, _ = TD.transformer_generate(tp, tcfg, prompt, 9)
    assert_greedy_equal(plain, want, margins)
    spec, stats = TD.transformer_speculative_generate(
        tp, tcfg, dp, dcfg, prompt, 9, gamma=3)
    assert_greedy_equal(spec, want, margins)
    assert stats["rounds"] >= 1 and 0.0 <= stats["accept_rate"] <= 1.0
    # Self-speculation accepts (nearly) everything.
    spec2, st2 = TD.transformer_speculative_generate(
        tp, tcfg, tp, tcfg, prompt, 9, gamma=4)
    assert_greedy_equal(spec2, want, margins)
    assert st2["accept_rate"] >= 0.9
    sampled, _ = TD.transformer_speculative_generate(
        tp, tcfg, dp, dcfg, prompt, 8, gamma=3, temperature=0.8,
        rng=torch.Generator().manual_seed(3))
    assert sampled.shape == (3, 8) and bool(((sampled >= 0)
                                             & (sampled < 64)).all())
    with pytest.raises(ValueError, match="attn_window"):
        TD.transformer_speculative_generate(
            tp, _tcfg(attn_window=4), dp, dcfg, prompt, 4)
    with pytest.raises(ValueError, match="max_len"):
        TD.transformer_speculative_generate(tp, tcfg, dp, dcfg, prompt, 4,
                                            gamma=3, max_len=8)


def test_spec_accept_is_bitwise_jax_and_preserves_the_target():
    rng = np.random.default_rng(0)
    V = 8
    p = rng.dirichlet(np.ones(V) * 0.7)
    q = rng.dirichlet(np.ones(V) * 0.7)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    draws = np.random.default_rng(9).choice(V, size=2000, p=q)
    for d in draws:
        assert TD._spec_accept(int(d), p, q, tr) == \
            JD._spec_accept(int(d), p, q, jr)
    # The emitted token is distributed as p (JAX's property test, 50k
    # trials, total variation below 0.02).
    n, counts, accepted = 50_000, np.zeros(V), 0
    for _ in range(n):
        d = int(rng.choice(V, p=q))
        ok, tok = TD._spec_accept(d, p, q, rng)
        counts[tok] += 1
        accepted += ok
    assert 0.5 * np.abs(counts / n - p).sum() < 0.02
    assert abs(accepted / n - np.minimum(p, q).sum()) < 0.02


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def _chain_logprob(model, prompt, row):
    seq = torch.cat([torch.as_tensor(prompt, dtype=torch.int64),
                     torch.as_tensor(row)[None]], dim=1)
    with torch.no_grad():
        lp = torch.log_softmax(model(seq), dim=-1)
    T0 = prompt.shape[1]
    return float(torch.gather(lp[:, T0 - 1:-1], -1,
                              seq[:, T0:, None])[..., 0].sum())


def test_beam_search_width_one_is_greedy_and_scores_are_chain_logprobs():
    jp, npp, tp = _params("mha")
    tcfg = _tcfg()
    prompt = _prompt(2, 4, seed=9)
    greedy, _ = TD.transformer_generate(tp, tcfg, prompt, 6)
    beams, scores = TD.transformer_beam_search(tp, tcfg, prompt, 6,
                                               beam_width=1)
    assert beams.shape == (2, 1, 6) and torch.equal(beams[:, 0], greedy)
    model = TC.transformer_from_jax(npp, tcfg)
    p1 = prompt[:1]
    beams, scores = TD.transformer_beam_search(tp, tcfg, p1, 5,
                                               beam_width=3)
    for w in range(3):
        want = _chain_logprob(model, p1, beams[0, w])
        assert abs(want - float(scores[0, w])) < 2e-4, (w, want, scores)
    s = scores[0].numpy()
    assert (np.diff(s) <= 1e-6).all()
    jb, js = JD.transformer_beam_search(jp, _jcfg(), jnp.asarray(p1), 5,
                                        beam_width=3)
    np.testing.assert_allclose(s, np.asarray(js)[0], atol=2e-4)
    # eos freezes a beam: its tail reads eos, its score is the chain's up
    # to and including the first eos; a length penalty divides by the
    # actual lengths and re-sorts.
    eos = int(beams[0, 0, 2])
    for penalty in (0.0, 1.0):
        eb, es = TD.transformer_beam_search(tp, tcfg, p1, 6, beam_width=3,
                                            eos_id=eos,
                                            length_penalty=penalty)
        rows = eb[0].numpy()
        assert any(eos in r for r in rows)
        for w, row in enumerate(rows):
            first = int(np.argmax(row == eos)) if eos in row else 5
            assert (row[first:] == eos).all() or eos not in row
            raw = _chain_logprob(model, p1, row[:first + 1])
            want = raw / (first + 1) ** penalty
            assert abs(want - float(es[0, w])) < 3e-4, (penalty, w)
    with pytest.raises(ValueError, match="beam_width"):
        TD.transformer_beam_search(tp, tcfg, p1, 4, beam_width=0)


# ---------------------------------------------------------------------------
# make_decode_step over a mesh of CPU ranks
# ---------------------------------------------------------------------------

N = 4
# name, mesh sizes, config, quantize, with an extend
SHARDED = [("dp2_tp2", dict(dp=2, tp=2), "gqa", None, True),
           ("dp2_tp2_int8", dict(dp=2, tp=2), "mha", "int8", False),
           ("tp2_gqa", dict(tp=2), "gqa", None, False),
           ("dp2_moe", dict(dp=2), (("moe_every", 2), ("n_experts", 2)),
            None, False),
           ("tp2_moe", dict(tp=2), (("moe_every", 2), ("n_experts", 2)),
            None, False)]

WORKER = r'''
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import decode as D, transformer as T
from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh

out_dir, n, r, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
hvd.init(coordinator_address=url, num_processes=n, process_id=r, device="cpu")
data = torch.load(f"{out_dir}/inputs.pt", weights_only=False)
res = {}
for name, sizes, extra, quantize, extend in data["cases"]:
    k = 1
    for v in sizes.values():
        k *= v
    mesh = create_hybrid_mesh(**sizes, ranks=range(k))
    if r >= k:
        continue
    cfg = T.TransformerConfig(**data["cfg"], **extra,
                              compute_dtype=torch.float32)
    b = D.make_decode_step(mesh, cfg, quantize=quantize)
    sp = b.shard_params(data["params"][name])
    sc = b.shard_cache(D.init_decode_cache(cfg, 2, 10, quantize=quantize,
                                           device="cpu"))
    lg, sc = b.prefill(sp, sc, b.shard_tokens(data["prompt"]))
    out = [lg]
    for tok in data["feed"][name]:
        lg, sc = b.step(sp, sc, b.shard_tokens(tok))
        out.append(lg)
    if extend:
        lg, sc = b.extend(sp, sc, b.shard_tokens(data["chunk"]))
        out.append(lg)
    res[name] = {"logits": [o.numpy() for o in out], "dp": mesh.index("dp"),
                 "tp": mesh.index("tp"), "pos": int(sc["pos"])}
torch.save(res, f"{out_dir}/rank{r}.pt")
hvd.shutdown()
'''


def _extra(cfg_key):
    return KINDS[cfg_key] if isinstance(cfg_key, str) else dict(cfg_key)


def _jax_sharded(name, sizes, cfg_key, quantize, extend, prompt, chunk):
    """JAX make_decode_step on the same mesh of CPU devices: the prefill
    and three greedy steps (the fed tokens) and the extend."""
    jcfg = _jcfg(**_extra(cfg_key))
    jp = _params(cfg_key)[0]
    k = int(np.prod(list(sizes.values())))
    mesh = JMesh(np.array(jax.devices()[:k]).reshape(*sizes.values()),
                 tuple(sizes))
    b = JD.make_decode_step(mesh, jcfg, quantize=quantize)
    sp = b.shard_params(jp)
    sc = b.shard_cache(JD.init_decode_cache(jcfg, 2, 10, quantize=quantize))
    lg, sc = b.prefill(sp, sc, jnp.asarray(prompt))
    out, feed = [np.asarray(lg)], []
    for _ in range(3):
        tok = np.asarray(lg).argmax(-1).astype(np.int32)
        feed.append(tok)
        lg, sc = b.step(sp, sc, b.shard_tokens(jnp.asarray(tok)))
        out.append(np.asarray(lg))
    if extend:
        lg, sc = b.extend(sp, sc, jnp.asarray(chunk))
        out.append(np.asarray(lg))
    return out, feed


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode")
    prompt, chunk = _prompt(2, 4, seed=1), _prompt(2, 3, seed=2)
    want, feed = {}, {}
    for case in SHARDED:
        want[case[0]], feed[case[0]] = _jax_sharded(*case, prompt, chunk)
    torch.save({"cases": [(n, s, _extra(c), q, e)
                          for n, s, c, q, e in SHARDED],
                "cfg": SMALL, "prompt": prompt, "chunk": chunk,
                "feed": feed,
                "params": {c[0]: _params(c[2])[1] for c in SHARDED}},
               tmp / "inputs.pt")
    return want, run_world(tmp, N, WORKER, timeout=300)


@pytest.mark.parametrize("case", SHARDED, ids=[c[0] for c in SHARDED])
def test_make_decode_step_matches_jax_on_the_same_mesh(sharded, case):
    name, sizes = case[0], case[1]
    want, res = sharded
    ranks = [d[name] for d in res if name in d]
    assert len(ranks) == int(np.prod(list(sizes.values())))
    dp = sizes.get("dp", 1)
    for i, w in enumerate(want[name]):
        # Each dp block's rows, from its tp = 0 rank (every tp rank of a
        # block holds the same logits).
        blocks = {d["dp"]: d["logits"][i] for d in ranks if d["tp"] == 0}
        got = np.concatenate([blocks[j] for j in range(dp)])
        for d in ranks:
            np.testing.assert_array_equal(d["logits"][i], blocks[d["dp"]])
        np.testing.assert_allclose(got, w, atol=SHARD_TOL, rtol=SHARD_TOL,
                                   err_msg=f"{name} call {i}")
    assert all(d["pos"] == (10 if case[4] else 7) for d in ranks)


def test_make_decode_step_refuses_the_axes_jax_refuses():
    from horovod_tpu_torch.parallel.mesh import Mesh

    def mesh(**sizes):
        shape = dict.fromkeys(("dcn", "dp", "pp", "ep", "tp", "sp"), 1)
        shape.update(sizes)
        return Mesh(shape=shape, coords=dict.fromkeys(shape, 0),
                    sets={}, ranks=(0,))

    for axis in ("sp", "pp"):
        with pytest.raises(NotImplementedError, match="dp/tp"):
            TD.make_decode_step(mesh(**{axis: 2}), _tcfg())
    with pytest.raises(NotImplementedError, match="expert-parallel"):
        TD.make_decode_step(mesh(ep=2), _tcfg(moe_every=2, n_experts=2))
