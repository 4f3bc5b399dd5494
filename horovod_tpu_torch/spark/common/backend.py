"""Worker-placement backends for estimators (counterpart of
`horovod_tpu/spark/common/backend.py`).

Reference parity: `horovod/spark/common/backend.py` (`Backend`,
`SparkBackend` — runs the training fn on `num_proc` barrier tasks) —
plus a `LocalBackend` the reference keeps implicit (its tests run Spark
in `local-cluster` mode; without a JVM here, local worker processes
through `horovod_tpu_torch.runner.api.run` fill the same role).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from ...common.exceptions import HorovodTpuError


class Backend:
    """Abstract backend (reference: backend.py `Backend`)."""

    def num_processes(self) -> int:
        raise NotImplementedError

    def run(self, fn: Callable, args: tuple = (),
            env: Optional[dict] = None,
            np: Optional[int] = None) -> List[Any]:
        """Run `fn(*args)` on every worker; results by rank.  `np`
        pins the worker count the caller already planned for (fit()
        shards data for exactly num_processes() workers — re-reading a
        dynamic cluster size here could mismatch the shard count)."""
        raise NotImplementedError


class SparkBackend(Backend):
    """Barrier-stage backend (reference: backend.py `SparkBackend`)."""

    def __init__(self, num_proc: Optional[int] = None, verbose: int = 0):
        self._num_proc = num_proc
        self._verbose = verbose

    def num_processes(self) -> int:
        if self._num_proc:
            return self._num_proc
        import pyspark

        sc = pyspark.SparkContext._active_spark_context
        if sc is None:
            raise HorovodTpuError("SparkBackend: no active SparkContext")
        return sc.defaultParallelism

    def run(self, fn, args=(), env=None, np=None):
        from .. import run as spark_run

        return spark_run(fn, args=args,
                         num_proc=np or self.num_processes(),
                         extra_env=env, verbose=self._verbose)


class LocalBackend(Backend):
    """Local-process backend: `num_proc` workers on this host via the
    `run()` API (`runner/api.py`), each a real process with its own rank
    and process group — the same worker contract a barrier task gets.
    Each worker trains on the device the estimator names (`device`:
    its card by default), so nothing in the env pins it to the CPU."""

    def __init__(self, num_proc: int = 1, verbose: int = 0,
                 start_timeout: float = 180.0):
        self._num_proc = num_proc
        self._verbose = verbose
        self._start_timeout = start_timeout

    def num_processes(self) -> int:
        return self._num_proc

    def run(self, fn, args=(), env=None, np=None):
        from ...runner.api import run as api_run

        return api_run(fn, args=args, np=np or self._num_proc,
                       extra_env=dict(env or {}), verbose=self._verbose,
                       start_timeout=self._start_timeout)


def default_backend(num_proc: Optional[int], verbose: int = 0) -> Backend:
    """Auto-pick (reference: estimators build a SparkBackend by default):
    Spark barrier stage when a SparkContext is live, local processes
    otherwise."""
    try:
        import pyspark

        if pyspark.SparkContext._active_spark_context is not None:
            return SparkBackend(num_proc, verbose=verbose)
    except ImportError:
        pass
    return LocalBackend(num_proc or 1, verbose=verbose)


__all__ = ["Backend", "SparkBackend", "LocalBackend", "default_backend"]
