"""Exception types, mirroring `horovod_tpu/common/exceptions.py`.

The port keeps its own copy: it imports nothing of the JAX package.
"""


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class RendezvousConnectionError(HorovodTpuError):
    """Transport-level rendezvous failure (connect refused, reset,
    mid-flight drop).  Distinct from logical server errors (key timeout,
    barrier timeout) so retry policies can retry ONLY the transport
    class: transport errors are safe to retry for idempotent ops, while
    a logical timeout already consumed its deadline."""


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


class ReshardError(HorovodTpuError):
    """A live reshard (parallel/reshard.py) could not complete or
    verify: a peer died mid-transfer, a chunk failed its sha256, a
    stream's bit-pattern digest did not combine, or staging exceeded
    the HOROVOD_RESHARD_PEAK_BYTES ceiling.  The resharded state is
    discarded and the caller falls back to the restore path; the error
    is never swallowed into partially resharded state."""


class InvalidRequestError(HorovodTpuError, ValueError):
    """A caller handed the decode/serve stack an impossible request:
    non-positive batch, max_len shorter than the prompt, a prompt
    longer than the cache window, or a non-positive token budget.
    Doubly inherits ValueError so callers catching ValueError keep
    working while the serving layer can catch the whole framework
    family via HorovodTpuError."""
