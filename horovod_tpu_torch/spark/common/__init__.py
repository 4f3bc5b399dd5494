"""Common estimator machinery (counterpart of
`horovod_tpu/spark/common/`; reference: horovod/spark/common/)."""

from .backend import Backend, LocalBackend, SparkBackend  # noqa: F401
from .data_loader import ShardDataLoader  # noqa: F401
from .estimator import HorovodEstimator, HorovodModel  # noqa: F401
from .params import EstimatorParams, Params  # noqa: F401
from .store import LocalStore, Store  # noqa: F401
