"""Port parity: the input prefetcher (`horovod_tpu_torch/utils/
prefetch.py`) against the JAX package's (`horovod_tpu/utils/
prefetch.py`), mirroring tests/test_prefetch.py.

The same host stream (numpy batches from a seed) goes through both; the
port's batches, on the CPU, equal JAX's bitwise and in order.  Errors of
the source reach the consumer at their position, a size below 1 is
refused, and `close()` unblocks the producer thread.
"""

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.utils import prefetch as JPF
import horovod_tpu_torch as hvd
from horovod_tpu_torch.utils import prefetch as PF

from test_torch_port_collectives import no_launcher_env  # noqa: F401


@pytest.fixture(autouse=True)
def _init():
    jhvd.init()
    hvd.init(device="cpu")
    yield


def _host_batches(n, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    for i in range(n):
        yield {"x": rng.randn(batch, 4).astype(np.float32) + i,
               "y": np.arange(batch, dtype=np.int32) * (i + 1)}


def _np(b):
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("size", [1, 2, 4])
def test_stream_equals_jax_bitwise(size):
    jax_out = [_np(b) for b in JPF.prefetch_to_device(_host_batches(5),
                                                      size=size)]
    port_out = list(PF.prefetch_to_device(_host_batches(5), size=size))
    assert len(port_out) == len(jax_out) == 5
    for j, p in zip(jax_out, port_out):
        assert set(p) == {"x", "y"}
        for k in ("x", "y"):
            assert isinstance(p[k], torch.Tensor)
            assert p[k].device.type == "cpu"
            np.testing.assert_array_equal(p[k].numpy(), j[k])
            assert p[k].numpy().dtype == j[k].dtype


def test_default_device_is_hvds_and_tensors_pass_through():
    t = torch.arange(6).reshape(2, 3)
    (b,) = list(hvd.prefetch_to_device([(t, "label", 3)], size=2))
    assert b[0] is t and b[1:] == ("label", 3)
    assert PF._resolve(None) == hvd.device()


def test_size_one_and_short_stream():
    assert len(list(PF.prefetch_to_device(_host_batches(1), size=4))) == 1
    assert list(PF.prefetch_to_device(iter([]), size=2)) == []


def test_bad_size_matches_jax():
    for mod, kw in ((JPF, {}), (PF, {"device": "cpu"})):
        with pytest.raises(ValueError, match="prefetch size must be >= 1"):
            list(mod.prefetch_to_device(_host_batches(1), size=0, **kw))
        with pytest.raises(ValueError, match="prefetch size must be >= 1"):
            mod.BackgroundPrefetcher(_host_batches(1), size=0, **kw)


def _bad():
    yield {"x": np.zeros((8, 4), np.float32)}
    yield {"x": np.ones((8, 4), np.float32)}
    raise RuntimeError("decode failed")


@pytest.mark.parametrize("size", [1, 3])
def test_source_error_at_its_position(size):
    for mod in (JPF, PF):
        it = mod.prefetch_to_device(_bad(), size=size)
        got = [float(np.asarray(next(it)["x"])[0, 0]) for _ in range(2)]
        assert got == [0.0, 1.0]
        with pytest.raises(RuntimeError, match="decode failed"):
            next(it)


def test_background_stream_order_equals_jax():
    with JPF.BackgroundPrefetcher(_host_batches(6), size=2) as it:
        jax_out = [_np(b) for b in it]
    with PF.BackgroundPrefetcher(_host_batches(6), size=2) as it:
        port_out = list(it)
    assert len(port_out) == 6
    for j, p in zip(jax_out, port_out):
        for k in ("x", "y"):
            np.testing.assert_array_equal(p[k].numpy(), j[k])


def test_background_exception_reraises_in_order():
    p = PF.BackgroundPrefetcher(_bad(), size=2)
    it = iter(p)
    assert float(next(it)["x"][0, 0]) == 0.0
    assert float(next(it)["x"][0, 0]) == 1.0
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    assert list(iter(p)) == []


def test_close_unblocks_producer():
    p = PF.BackgroundPrefetcher(_host_batches(100), size=1)
    it = iter(p)
    next(it)
    p.close(timeout=5.0)  # must not hang on the full queue
    assert not p._thread.is_alive()


def test_second_iteration_returns_immediately():
    p = PF.BackgroundPrefetcher(_host_batches(2), size=2)
    assert len(list(iter(p))) == 2
    assert list(iter(p)) == []


def test_close_before_start():
    p = PF.BackgroundPrefetcher(_host_batches(2), size=2)
    p.close()
    assert not p._started
