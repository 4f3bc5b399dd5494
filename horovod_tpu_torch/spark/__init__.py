"""`horovod_tpu_torch.spark` — run distributed training inside Spark
executors (counterpart of `horovod_tpu/spark/__init__.py`; reference:
horovod/spark/__init__.py `run`, `run_elastic`).

The barrier stage is the cluster.  Each barrier task derives its Horovod
env (rank = partition id, coordinator = task 0's host) from
`BarrierTaskContext`; rendezvous rides the driver's KV server, and each
task's `hvd.init()` bootstraps its process group on task 0's c10d
TCPStore (`COORDINATOR_PORT`), picking NCCL or gloo itself.

The Spark Estimator API lives in `horovod_tpu_torch.spark.torch` /
`.lightning` / `.keras` over the `common/` store and backend machinery;
the estimators also work without Spark (pandas DataFrame in, local
worker processes) — see spark/common/.

    import horovod_tpu_torch.spark
    results = horovod_tpu_torch.spark.run(train_fn, args=(cfg,), num_proc=4)
"""

from __future__ import annotations

import base64
import pickle
import socket
from typing import Any, Callable, List, Optional

from ..common.exceptions import HorovodTpuError

# The port on which barrier task 0's c10d TCPStore listens (fixed:
# free-port probing on a remote executor is impossible before the task
# runs).
COORDINATOR_PORT = 46329


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
        return pyspark
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark requires pyspark "
            "(pip install pyspark)") from e


def _spark_context(pyspark):
    sc = pyspark.SparkContext._active_spark_context
    if sc is None:
        raise HorovodTpuError(
            "No active SparkContext; create a SparkSession first")
    return sc


def _driver_ip(sc) -> str:
    host = sc.getConf().get("spark.driver.host", None)
    if host:
        return host
    return socket.gethostbyname(socket.gethostname())


def make_barrier_mapper(payload: str, rendezvous_addr: str,
                        rendezvous_port: int, secret: str,
                        extra_env: Optional[dict] = None) -> Callable:
    """The function each barrier task runs.  Exposed for testability:
    anything implementing the BarrierTaskContext surface (partitionId,
    getTaskInfos, barrier) can drive it — the fake-cluster pattern the
    reference uses for its Spark tests."""

    def mapper(index, iterator, ctx=None):
        import os as _os
        import pickle as _pickle

        if ctx is None:  # real Spark path
            from pyspark import BarrierTaskContext
            ctx = BarrierTaskContext.get()
        rank = ctx.partitionId()
        infos = ctx.getTaskInfos()
        size = len(infos)
        coord_host = infos[0].address.split(":")[0]
        # No HOROVOD_CONTROLLER / HOROVOD_CPU_OPERATIONS: each rank picks
        # NCCL or gloo in hvd.init(), as under the port's launcher.
        env = {
            "HOROVOD_RANK": str(rank),
            "HOROVOD_SIZE": str(size),
            "HOROVOD_LOCAL_RANK": "0",
            "HOROVOD_NUM_PROCESSES": str(size),
            "HOROVOD_PROCESS_ID": str(rank),
            "HOROVOD_COORDINATOR_ADDR": f"{coord_host}:{COORDINATOR_PORT}",
            "HOROVOD_RENDEZVOUS_ADDR": rendezvous_addr,
            "HOROVOD_RENDEZVOUS_PORT": str(rendezvous_port),
            "HOROVOD_SECRET_KEY": secret,
        }
        env.update({k: str(v) for k, v in (extra_env or {}).items()})
        _os.environ.update(env)
        # All tasks present and env ready before anyone inits.
        ctx.barrier()
        fn, args, kwargs = _pickle.loads(base64.b64decode(payload))
        result = fn(*args, **kwargs)
        yield rank, base64.b64encode(_pickle.dumps(result)).decode()

    return mapper


def run(
    fn: Callable,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    num_proc: Optional[int] = None,
    extra_env: Optional[dict] = None,
    verbose: int = 0,
) -> List[Any]:
    """Run `fn` on `num_proc` Spark barrier tasks; results by rank
    (reference: horovod.spark.run).

    `fn` runs one Horovod worker per task — it should call
    `horovod_tpu_torch.init()` itself, exactly like a launched worker.
    """
    pyspark = _require_pyspark()
    sc = _spark_context(pyspark)
    num_proc = num_proc or sc.defaultParallelism

    from ..runner.rendezvous import RendezvousServer
    server = RendezvousServer(verbose=verbose)
    port = server.start()
    payload = base64.b64encode(
        pickle.dumps((fn, args, kwargs or {}))).decode()
    mapper = make_barrier_mapper(
        payload, _driver_ip(sc), port, server.secret, extra_env)
    try:
        rows = (sc.parallelize(range(num_proc), num_proc)
                .barrier()
                .mapPartitionsWithIndex(mapper)
                .collect())
    finally:
        server.stop()
    by_rank = dict(rows)
    missing = [r for r in range(num_proc) if r not in by_rank]
    if missing:
        raise HorovodTpuError(f"spark.run: no result from ranks {missing}")
    return [pickle.loads(base64.b64decode(by_rank[r]))
            for r in range(num_proc)]


def run_elastic(
    fn: Callable,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    num_proc: Optional[int] = None,
    min_np: Optional[int] = None,
    max_np: Optional[int] = None,
    extra_env: Optional[dict] = None,
    verbose: int = 0,
) -> List[Any]:
    """Elastic variant (reference: horovod.spark.run_elastic).

    Spark barrier stages are gang-scheduled: the stage itself cannot
    grow/shrink mid-run, so elasticity is retry-granular — the
    reference's model, where a failed barrier stage is resubmitted and
    `fn` (wrapped in `hvd.elastic.run`) restores from its last commit.
    Here the stage is retried with one task fewer each time, down to
    `min_np`.
    """
    pyspark = _require_pyspark()
    sc = _spark_context(pyspark)
    want = num_proc or max_np or sc.defaultParallelism
    floor = min_np or 1
    last_err: Optional[Exception] = None
    n = want
    while n >= floor:
        try:
            return run(fn, args=args, kwargs=kwargs, num_proc=n,
                       extra_env=extra_env, verbose=verbose)
        except Exception as e:  # noqa: BLE001 — stage failure → shrink
            last_err = e
            n -= 1
    raise HorovodTpuError(
        f"spark.run_elastic: no successful run with np in "
        f"[{floor}, {want}]: {last_err}") from last_err


__all__ = ["run", "run_elastic", "make_barrier_mapper", "COORDINATOR_PORT"]
