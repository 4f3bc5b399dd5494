"""Exception types, mirroring `horovod_tpu/common/exceptions.py`.

The port keeps its own copy: it imports nothing of the JAX package.
"""


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class CheckpointCorruptError(HorovodTpuError):
    """A persisted checkpoint failed its integrity check (sha256
    mismatch, truncated or unreadable payload).  Restore treats the step
    as unusable and rolls back to the previous good one rather than
    ending the job."""


class HorovodInternalError(HorovodTpuError):
    """A collective failed mid-flight; elastic training treats this as a
    signal to restore state and re-initialize (reference:
    horovod/common/exceptions.py)."""


class NotInitializedError(HorovodTpuError):
    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call "
            "horovod_tpu_torch.init() first.")


class HostsUpdatedInterrupt(HorovodTpuError):
    """Cluster membership changed; raised at a commit boundary so elastic
    training can re-rendezvous without losing state."""

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class InvalidRequestError(HorovodTpuError, ValueError):
    """A caller handed the decode/serve stack an impossible request:
    non-positive batch, max_len shorter than the prompt, a prompt
    longer than the cache window, or a non-positive token budget.
    Doubly inherits ValueError so callers catching ValueError keep
    working while the serving layer can catch the whole framework
    family via HorovodTpuError."""
