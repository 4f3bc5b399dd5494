"""Exception types, mirroring `horovod_tpu/common/exceptions.py`.

The port keeps its own copy: it imports nothing of the JAX package.
"""


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class HorovodInternalError(HorovodTpuError):
    """A collective failed mid-flight; elastic training treats this as a
    signal to restore state and re-initialize (reference:
    horovod/common/exceptions.py)."""


class NotInitializedError(HorovodTpuError):
    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call "
            "horovod_tpu_torch.init() first.")
