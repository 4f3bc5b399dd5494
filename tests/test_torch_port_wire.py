"""Port parity: the wire registry of `horovod_tpu_torch/ops/wire.py`
against the JAX package's `horovod_tpu/ops/wire.py` on the same inputs.

The cooperative codecs are elementwise, so every payload byte, scale and
decoded value is held bitwise to the JAX package's, on blocks chosen to
reach every branch: all zero, holding a NaN, holding ±inf, values on the
clip (±127 and ±7 levels, and the halfway points that round to even),
tiny ones, and ordinary N(0, 1) blocks.  A NaN is compared by its
position, not its bits: the port keeps torch's NaN codes.  One
difference is held explicitly: in a block holding a NaN (scale 1, values
unnormalised) e4m3 saturates a value past 464 at ±448 where XLA writes
NaN.  (A block that mixes subnormal values with a normal maximum is left
out: XLA's CPU reads subnormals as zero, torch does not.)

Also here: byte accounting, the host codec of a reshard chunk both
ways, the policy grammar and its live knobs, the error-feedback reset
protocol, and the bucket plans of `parallel/data_parallel.py` against
the JAX package's for the same leaves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.common.exceptions import HorovodTpuError as JErr
from horovod_tpu.ops import wire as JW
from horovod_tpu.parallel import data_parallel as JD
from horovod_tpu_torch.common.exceptions import HorovodTpuError
from horovod_tpu_torch.ops import wire as TW
from horovod_tpu_torch.ops.compression import Compression as TComp
from horovod_tpu.ops.compression import Compression as JComp
from horovod_tpu_torch.parallel import data_parallel as TD

COOPERATIVE = ["int8", "int4", "fp8_e4m3", "fp8_e5m2"]
ALL = ["none", "fp16", "bf16"] + COOPERATIVE


def _special_blocks(seed: int = 0, blocks: int = 24) -> np.ndarray:
    """A flat f32 vector of `blocks` blocks of 128 that reaches every
    branch of the codecs (see the module docstring)."""
    rng = np.random.RandomState(seed)
    v = (rng.randn(blocks * 128) * rng.choice([1e-3, 1.0, 40.0],
                                              blocks * 128)).astype(np.float32)
    b = lambda k: slice(128 * k, 128 * (k + 1))  # noqa: E731
    v[b(0)] = 0.0
    v[b(1)][5] = np.nan
    v[b(2)][7], v[b(2)][9] = np.inf, -np.inf
    v[b(3)][11] = -np.inf
    v[b(4)][0] = np.nan
    v[b(4)][1] = -np.inf
    # Every int8 level and the halfway points between them (round half
    # to even), with the block max at 127 so that the scale is 1.
    v[b(5)] = np.concatenate([np.arange(-127, 1, 1.0),
                              ]).astype(np.float32)
    v[b(6)] = (np.arange(128) - 63.5).astype(np.float32)
    v[b(6)][0] = 127.0
    # The int4 levels and halfway points, block max 7.
    v[b(7)] = np.tile(np.arange(-7, 8, 0.5), 9)[:128].astype(np.float32)
    v[b(8)] = -v[b(7)]
    # Tiny magnitudes: a subnormal scale (XLA flushes it to zero, and
    # then the scale is 1), and blocks of subnormal values.
    v[b(9)] = (rng.randn(128) * 1e-30).astype(np.float32)
    v[b(10)][:] = 3.0e-37
    v[b(11)] = (rng.randn(128) * 1e-40).astype(np.float32)
    # A NaN block's scale is 1: its other values reach fp8 unnormalised,
    # past e4m3's 448 and its rounding point 464.
    v[b(12)] = np.linspace(-600, 600, 128).astype(np.float32)
    v[b(12)][3] = np.nan
    v[b(12)][4:7] = [464.0, -464.0, 465.0]
    return v


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        if t.element_size() == 1:
            return t.view(torch.uint8).numpy().tobytes()
        if t.element_size() == 2:
            return t.view(torch.int16).numpy().tobytes()
        return t.numpy().tobytes()
    return np.asarray(t).tobytes()


_FP8 = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


def _e4m3_saturated(v: np.ndarray, name: str) -> np.ndarray:
    """The elements where the port's e4m3 saturates and XLA's writes
    NaN: |v| past 464 (or ±inf) in a block that holds a NaN."""
    if name != "fp8_e4m3":
        return np.zeros(v.shape, bool)
    blocks = v.reshape(-1, 128)
    nan_block = np.isnan(blocks).any(axis=1, keepdims=True)
    with np.errstate(invalid="ignore"):
        return (nan_block & (np.abs(blocks) > 464.0)).reshape(-1)


def _assert_payload_matches(t, j, name, sat):
    """Payload bytes equal, an fp8 NaN code matched by position only;
    where `sat`, the port's ±448 (the sign of v) against XLA's NaN."""
    tb = np.frombuffer(_bytes(t), np.uint8)
    jb = np.frombuffer(_bytes(j), np.uint8)
    if name not in _FP8:
        assert tb.tobytes() == jb.tobytes(), name
        return
    tf = t.contiguous().to(torch.float32).numpy()
    jf = np.asarray(j).astype(np.float32)
    assert np.array_equal(np.isnan(tf), np.isnan(jf) & ~sat), name
    assert np.isnan(jf[sat]).all() and (np.abs(tf[sat]) == 448.0).all()
    keep = ~np.isnan(jf)
    assert tb[keep].tobytes() == jb[keep].tobytes(), name


def _assert_decode_matches(got: np.ndarray, want: np.ndarray, sat):
    """Decoded f32 bitwise where finite; NaN at the same places (the
    e4m3 saturation aside), its sign and payload bits not compared."""
    assert np.array_equal(np.isnan(got), np.isnan(want) & ~sat)
    assert (np.abs(got[sat]) == 448.0).all()
    keep = ~np.isnan(want)
    assert got[keep].tobytes() == want[keep].tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", COOPERATIVE)
def test_cooperative_codec_encodes_and_decodes_bitwise_jax(name, seed):
    v = _special_blocks(seed)
    sat = _e4m3_saturated(v, name)
    assert sat.any() == (name == "fp8_e4m3")
    jenc = JW.get_codec(name).encode(jnp.asarray(v))
    tenc = TW.get_codec(name).encode(torch.from_numpy(v))
    assert len(jenc) == len(tenc) == 2
    for j, t in zip(jenc, tenc):
        assert t.shape == tuple(j.shape)
    _assert_payload_matches(tenc[0], jenc[0], name, sat)
    assert _bytes(tenc[1]) == _bytes(jenc[1]), name
    jdec = np.asarray(JW.get_codec(name).decode(jenc))
    tdec = TW.get_codec(name).decode(tenc)
    assert tdec.dtype == torch.float32
    _assert_decode_matches(tdec.numpy(), jdec, sat)


@pytest.mark.parametrize("name", COOPERATIVE)
def test_port_decodes_the_jax_payload_bitwise(name):
    """The decode of bytes the JAX package encoded (the payload that
    would cross a wire between the two)."""
    v = _special_blocks(5)
    jenc = JW.get_codec(name).encode(jnp.asarray(v))
    payload = torch.from_numpy(np.frombuffer(
        _bytes(jenc[0]), np.uint8).copy())
    dt = {"int8": torch.int8, "int4": torch.uint8, **_FP8}[name]
    parts = (payload.view(dt), torch.from_numpy(np.array(jenc[1])))
    got = TW.get_codec(name).decode(parts)
    want = np.asarray(JW.get_codec(name).decode(jenc))
    _assert_decode_matches(got.numpy(), want, np.zeros(v.shape, bool))


def test_int4_packs_element_2k_low_and_2k_plus_1_high():
    v = np.zeros(128, np.float32)
    v[0], v[1], v[2], v[3] = 7.0, -7.0, -1.0, 3.0
    packed, scale = TW.get_codec("int4").encode(torch.from_numpy(v))
    assert float(scale[0]) == 1.0 and packed.numel() == 64
    assert int(packed[0]) == (7 | (0x9 << 4))  # -7: nibble 0b1001
    assert int(packed[1]) == (0xF | (3 << 4))  # -1: nibble 0b1111


@pytest.mark.parametrize("name", ["fp16", "bf16", "none"])
def test_cast_codecs_match_jax_on_finite_values(name):
    v = _special_blocks(3)
    v = np.where(np.isfinite(v), v, 1.5).astype(np.float32)
    jenc = JW.get_codec(name).encode(jnp.asarray(v))
    tenc = TW.get_codec(name).encode(torch.from_numpy(v))
    assert _bytes(tenc[0]) == _bytes(jenc[0])
    assert TW.get_codec(name).decode(tenc).numpy().tobytes() == \
        np.asarray(JW.get_codec(name).decode(jenc)).tobytes()


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 25_557_032])
@pytest.mark.parametrize("name", ALL)
def test_wire_bytes_match_jax(name, n):
    t, j = TW.get_codec(name), JW.get_codec(name)
    assert (t.payload_bits, t.exact, t.cooperative) == \
        (j.payload_bits, j.exact, j.cooperative)
    assert t.wire_nbytes(n) == j.wire_nbytes(n)
    assert t.scale_bytes(n) == j.scale_bytes(n)


def test_registry_names_match_jax():
    assert TW.wire_names() == JW.wire_names()
    assert TW.cast_wire_names() == JW.cast_wire_names()
    for name in ALL:
        assert TW.get_codec(name).name == name
    assert TW.get_codec(None).exact
    assert TW.get_codec("bf16").cast_dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["int9", "q8", "", "INT8"])
def test_unknown_names_raise_like_jax(name):
    with pytest.raises(JErr, match="unknown wire format"):
        JW.get_codec(name)
    with pytest.raises(HorovodTpuError, match="unknown wire format"):
        TW.get_codec(name)


@pytest.mark.parametrize("comp", ["none", "fp16", "bf16", "int8", "int4",
                                  "fp8_e4m3", "fp8_e5m2"])
def test_compressor_wire_matches_jax(comp):
    assert TW.compressor_wire(getattr(TComp, comp)) == \
        JW.compressor_wire(getattr(JComp, comp))


@pytest.mark.parametrize("name", ALL)
def test_local_roundtrip_matches_jax(name):
    v = np.random.RandomState(4).randn(3, 100).astype(np.float32) * 5
    got = TW.local_roundtrip(torch.from_numpy(v), name)
    want = np.asarray(JW.local_roundtrip(jnp.asarray(v), name))
    assert tuple(got.shape) == want.shape
    assert got.float().numpy().tobytes() == \
        want.astype(np.float32).tobytes()


# ---------------------------------------------------------------------------
# The host codec of a reshard chunk
# ---------------------------------------------------------------------------

def _host_input():
    v = np.random.RandomState(9).randn(257).astype(np.float32) * 3
    v[:6] = [0.0, -0.0, np.inf, -np.inf, 65504.0, 1e-30]
    v[6] = np.nan
    return v


@pytest.mark.parametrize("name", ["none", "fp16", "bf16"])
def test_host_encode_is_byte_compatible_both_ways(name):
    v = _host_input()
    tb = TW.host_encode(v, name)
    assert tb == JW.host_encode(v, name)
    assert TW.host_encode(torch.from_numpy(v), name) == tb
    got = TW.host_decode(JW.host_encode(v, name), np.float32, name)
    want = JW.host_decode(tb, np.float32, name)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", COOPERATIVE)
def test_host_codec_refuses_cooperative_like_jax(name):
    v = _host_input()
    for enc, err in ((JW.host_encode, JErr), (TW.host_encode,
                                              HorovodTpuError)):
        with pytest.raises(err, match="cooperative"):
            enc(v, name)
    for dec, err in ((JW.host_decode, JErr), (TW.host_decode,
                                              HorovodTpuError)):
        with pytest.raises(err, match="cooperative"):
            dec(b"\0" * 8, np.float32, name)


# ---------------------------------------------------------------------------
# The policy
# ---------------------------------------------------------------------------

GOOD_SPECS = ["exact", "auto", " auto ", "big=int4,small=none,threshold=1048576",
              "big=int8", "small=bf16", "threshold=4096", "big=fp8_e4m3,",
              "big=int4 , small=fp16", "big=none,small=none"]
BAD_SPECS = ["int8", "big=int9", "huge=int8", "threshold=1MB", "big",
             "small=q8"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_wire_policy_accepts_what_jax_accepts(spec):
    j, t = JW.parse_wire_policy(spec), TW.parse_wire_policy(spec)
    assert (t.big, t.small, t.threshold_bytes, t.exact) == \
        (j.big, j.small, j.threshold_bytes, j.exact)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_wire_policy_rejects_what_jax_rejects(spec):
    with pytest.raises(JErr) as je:
        JW.parse_wire_policy(spec)
    with pytest.raises(HorovodTpuError) as te:
        TW.parse_wire_policy(spec)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("env", [{}, {"HOROVOD_WIRE_THRESHOLD": "2048"},
                                 {"HOROVOD_WIRE_BIG_FORMAT": "int4"},
                                 {"HOROVOD_WIRE_BIG_FORMAT": "bf16",
                                  "HOROVOD_WIRE_THRESHOLD": "100"}])
@pytest.mark.parametrize("spec", ["auto", "big=fp8_e5m2,small=bf16",
                                  "small=fp16,threshold=5000"])
def test_classification_and_live_knobs_match_jax(monkeypatch, spec, env):
    for k in ("HOROVOD_WIRE_THRESHOLD", "HOROVOD_WIRE_BIG_FORMAT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    from horovod_tpu.utils import autotune as JA
    from horovod_tpu_torch.utils import autotune as TA
    assert TA.current_wire_threshold() == JA.current_wire_threshold()
    assert TA.current_wire_big_format() == JA.current_wire_big_format()
    j, t = JW.parse_wire_policy(spec), TW.parse_wire_policy(spec)
    for nbytes in (0, 99, 100, 2047, 2048, 4999, 5000, 1 << 20, 10 ** 9):
        for all_float in (True, False):
            assert t.codec_for(nbytes, all_float) == \
                j.codec_for(nbytes, all_float)


def test_policy_from_env(monkeypatch):
    monkeypatch.delenv("HOROVOD_WIRE_POLICY", raising=False)
    assert TW.policy_from_env() is None
    monkeypatch.setenv("HOROVOD_WIRE_POLICY", "big=int4,threshold=64")
    p = TW.policy_from_env()
    assert p.codec_for(64, True) == "int4" and p.codec_for(63, True) == \
        "none"


def test_error_feedback_reset_protocol():
    calls = []
    hook = lambda: calls.append(1)  # noqa: E731
    g0 = TW.error_feedback_generation()
    TW.register_error_feedback_reset(hook)
    try:
        assert TW.reset_error_feedback() == g0 + 1
        assert TW.error_feedback_generation() == g0 + 1 and calls == [1]
    finally:
        TW.unregister_error_feedback_reset(hook)
    TW.unregister_error_feedback_reset(hook)  # absent: nothing
    TW.reset_error_feedback()
    assert calls == [1] and TW.error_feedback_generation() == g0 + 2


def test_elastic_reset_bumps_the_generation(monkeypatch):
    import importlib

    E = importlib.import_module("horovod_tpu_torch.elastic")
    from horovod_tpu_torch.common import basics
    seen = []
    monkeypatch.setattr(basics, "init_arguments", lambda: {})
    monkeypatch.setattr(basics, "shutdown",
                        lambda: seen.append(TW.error_feedback_generation()))
    monkeypatch.setattr(basics, "init", lambda **kw: None)
    g0 = TW.error_feedback_generation()
    E._reset()
    # Bumped before the process group was torn down.
    assert seen == [g0 + 1] and TW.error_feedback_generation() == g0 + 1


# ---------------------------------------------------------------------------
# The bucket plans against the JAX package's
# ---------------------------------------------------------------------------

LEAF_SETS = {
    "mixed": [((4096,), "float32"), ((64,), "float32"), ((3,), "int32"),
              ((300, 20), "float32"), ((7,), "int32"), ((2048,), "bfloat16"),
              ((128, 64), "float32"), ((5,), "float16")],
    "floats": [((1000,), "float32")] * 9 + [((70000,), "float32")],
    "ints_first": [((10,), "int32"), ((9000,), "float32"),
                   ((17,), "float32")],
}


def _leaves(kind):
    t = [torch.empty(s, dtype=getattr(torch, d), device="meta")
         for s, d in LEAF_SETS[kind]]
    j = [jnp.zeros(s, getattr(jnp, d)) for s, d in LEAF_SETS[kind]]
    return t, j


@pytest.mark.parametrize("order", ["forward", "reverse"])
@pytest.mark.parametrize("threshold", [4096, 20000, 1 << 20])
@pytest.mark.parametrize("comp", ["none", "bf16", "int8", "int4",
                                  "fp8_e4m3"])
@pytest.mark.parametrize("kind", sorted(LEAF_SETS))
def test_gradient_bucket_partition_matches_jax(kind, comp, threshold,
                                               order):
    t, j = _leaves(kind)
    assert TD.gradient_bucket_partition(
        t, compression=getattr(TComp, comp),
        fusion_threshold_bytes=threshold, bucket_order=order) == \
        JD.gradient_bucket_partition(
            j, compression=getattr(JComp, comp),
            fusion_threshold_bytes=threshold, bucket_order=order)


@pytest.mark.parametrize("spec", ["auto", "big=int4,small=none,threshold=8192",
                                  "big=fp8_e5m2,small=bf16,threshold=1000",
                                  "exact"])
@pytest.mark.parametrize("kind", sorted(LEAF_SETS))
def test_wire_policy_plan_and_fused_plan_match_jax(monkeypatch, kind,
                                                   spec):
    monkeypatch.setenv("HOROVOD_WIRE_POLICY", spec)
    monkeypatch.setenv("HOROVOD_WIRE_THRESHOLD", "16384")
    t, j = _leaves(kind)
    kw = dict(fusion_threshold_bytes=20000, bucket_order="reverse")
    assert TD.wire_policy_plan(t, **kw) == \
        [tuple(x) for x in JD.wire_policy_plan(j, **kw)]
    assert TD.fused_pipeline_plan(t, chunk_bytes=8192, **kw) == \
        [tuple(x) for x in JD.fused_pipeline_plan(j, chunk_bytes=8192,
                                                  **kw)]


@pytest.mark.parametrize("spec,comp,subset,active", [
    (None, "none", False, False), ("exact", "none", False, False),
    ("auto", "none", False, True), ("auto", "fp16", False, False),
    ("auto", "int8", False, False), ("auto", "none", True, False)])
def test_active_wire_policy_matches_jax(monkeypatch, spec, comp, subset,
                                        active):
    if spec is None:
        monkeypatch.delenv("HOROVOD_WIRE_POLICY", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_WIRE_POLICY", spec)

    class _Set:
        process_set_id = 1

    ps = _Set() if subset else None
    j = JD.active_wire_policy(getattr(JComp, comp), ps)
    t = TD.active_wire_policy(getattr(TComp, comp), ps)
    assert (j is not None) == (t is not None) == active
