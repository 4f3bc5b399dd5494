"""The TensorFlow <-> torch tensor bridge (counterpart of
`horovod_tpu/tensorflow/_bridge.py`'s `tf_to_jax` / `jax_to_tf`).

A TF gradient enters the port's collectives as a torch tensor on the
rank's device (`hvd.device()`) and comes back as a tf.Tensor of the
caller's dtype.  Both legs cross by DLPack, which carries every dtype
TF and torch share (bf16 and f16 included); an IndexedSlices or a
Variable is densified first.  A host copy through numpy is taken only
for a dtype DLPack does not carry (`_DLPACK`, chosen by dtype, never by
a caught exception).  The torch tensor then moves to the rank's device:
the collective never stays on the CPU because TF's tensor is there.

Return leg: a result on the card goes to host memory first unless TF
sees a GPU (a CPU build of TF adopts no card buffer); a result whose
buffer is not 64-byte aligned (a view into a larger tensor) is copied
first, since TF adopts only aligned buffers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import tensorflow as tf
import torch

from ..common import basics

# The dtypes DLPack carries between TF and torch both ways.
_DLPACK = {
    tf.float16: torch.float16, tf.bfloat16: torch.bfloat16,
    tf.float32: torch.float32, tf.float64: torch.float64,
    tf.int8: torch.int8, tf.int16: torch.int16, tf.int32: torch.int32,
    tf.int64: torch.int64, tf.uint8: torch.uint8, tf.bool: torch.bool,
    tf.complex64: torch.complex64, tf.complex128: torch.complex128,
}
_TORCH_TO_TF = {v: k for k, v in _DLPACK.items()}

# The alignment TF requires of a buffer it adopts (Eigen's largest).
_TF_ALIGN = 64

_tf_gpu: Optional[bool] = None


def _densify(t):
    if isinstance(t, tf.IndexedSlices):
        t = tf.convert_to_tensor(t)
    if isinstance(t, tf.Variable):
        t = t.value()
    return tf.convert_to_tensor(t)


def _host_array_to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a torch tensor; an ml_dtypes array (a float8)
    by its bits, viewed as the torch dtype of its name."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V":
        return torch.from_numpy(a.view(f"int{a.dtype.itemsize * 8}")).view(
            getattr(torch, a.dtype.name))
    return torch.from_numpy(a)


def tf_to_torch(t) -> torch.Tensor:
    """tf.Tensor / Variable / IndexedSlices -> a torch tensor on the
    rank's device: by DLPack where the dtype crosses, else one host
    copy."""
    t = _densify(t)
    if t.dtype in _DLPACK:
        out = torch.from_dlpack(t)
    else:
        out = _host_array_to_torch(t.numpy())
    return out.to(basics.device())


def _tf_sees_gpu() -> bool:
    global _tf_gpu
    if _tf_gpu is None:
        _tf_gpu = bool(tf.config.list_logical_devices("GPU"))
    return _tf_gpu


def torch_to_tf(a, like=None):
    """A torch tensor (or numpy array) -> tf.Tensor, by DLPack where the
    dtype crosses, else one host copy.  `like` gives the dtype the caller
    sees (an IndexedSlices' values' dtype)."""
    dtype = None
    if like is not None and hasattr(like, "dtype"):
        dtype = like.values.dtype if isinstance(
            like, tf.IndexedSlices) else like.dtype
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.device.type != "cpu" and not _tf_sees_gpu():
            a = a.cpu()
        if a.dtype in _TORCH_TO_TF:
            a = a.contiguous()
            if a.data_ptr() % _TF_ALIGN:
                # TF adopts only aligned buffers (it aborts the process
                # on another): a view into a larger tensor is copied.
                a = a.clone()
            out = tf.experimental.dlpack.from_dlpack(
                torch.utils.dlpack.to_dlpack(a))
        else:  # by its bits (a float8), as the TF dtype of its name
            bits = a.cpu().contiguous().view(
                getattr(torch, f"int{a.element_size() * 8}"))
            dt = tf.as_dtype(str(a.dtype).split(".")[-1])
            out = tf.convert_to_tensor(bits.numpy().view(dt.as_numpy_dtype))
    else:
        out = tf.convert_to_tensor(np.asarray(a))
    if dtype is not None and out.dtype != dtype:
        out = tf.cast(out, dtype)
    return out
