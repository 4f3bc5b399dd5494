"""Estimator/Model base classes (counterpart of
`horovod_tpu/spark/common/estimator.py`).

Reference parity: `horovod/spark/common/estimator.py` (`HorovodEstimator`,
`HorovodModel` — the Spark-ML Estimator/Transformer pair whose `fit(df)`
materializes data, launches distributed training, and returns a
Transformer holding the trained model).

The orchestration here is the reference's, re-plumbed onto this repo's
primitives: `util.prepare_data` shards the DataFrame into the store,
a `Backend` runs the framework-specific remote trainer on every worker
(rank/size via the standard worker env), rank 0's trained weights come
back through the backend's result channel, and `fit` wraps them in a
Model whose `transform(df)` appends prediction columns.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List

from ...common.exceptions import HorovodTpuError
from .backend import default_backend
from .params import EstimatorParams, Params
from .store import CHECKPOINT_FILE, Store  # noqa: F401  (trainer import point)
from .util import VALID_COMPRESSION, prepare_data, to_output_frame


class HorovodEstimator(EstimatorParams):
    """Base estimator. Subclasses supply:

    - `_remote_trainer()` → a module-level function `fn(spec) -> result`
      run on every worker (must be picklable by reference);
    - `_serialize_model()` → bytes for the spec;
    - `_make_model(result, meta)` → the fitted `HorovodModel`.
    """

    def fit(self, df) -> "HorovodModel":
        if self.model is None:
            raise HorovodTpuError(f"{type(self).__name__}: model is required")
        if not self.feature_cols or not self.label_cols:
            raise HorovodTpuError(
                f"{type(self).__name__}: feature_cols and label_cols are "
                "required")
        # Cheap framework-specific validation BEFORE prepare_data shards
        # the dataset into the store — a bad param must not leave
        # dataset-sized scratch behind.
        self._validate_params()
        store = self.store or Store.create(None)
        # Expose an auto-created store so the caller can locate the
        # run's checkpoint/artifacts after fit().
        self.store = store
        backend = self.backend or default_backend(
            self.num_proc, verbose=self.verbose)
        self._check_store_reachable(store, backend)
        num_proc = backend.num_processes()
        run_id = self.run_id or f"run_{uuid.uuid4().hex[:12]}"

        meta = prepare_data(
            df, store, run_id, num_proc,
            feature_cols=self.feature_cols, label_cols=self.label_cols,
            validation=self.validation, shuffle=self.shuffle,
            seed=self.random_seed)

        try:
            # Inside the try: a serialization failure must still clean
            # up the freshly-written shards.
            spec = self._build_spec(store, run_id, meta)
            results = backend.run(self._remote_trainer(), args=(spec,),
                                  np=num_proc)
        finally:
            # Intermediate shards are per-fit scratch; without this,
            # repeated fits with the default temp store accumulate
            # dataset-sized directories.  Checkpoints/logs stay.
            self._cleanup_intermediate(store, run_id)
        # Trainers return the model payload from rank 0 only (results
        # are rank-ordered) to avoid shipping N copies of the weights.
        if not results or results[0] is None:
            raise HorovodTpuError("fit(): no result from rank 0")
        return self._make_model(results[0], meta, store=store,
                                run_id=run_id)

    @staticmethod
    def _cleanup_intermediate(store: Store, run_id: str) -> None:
        import os
        import shutil

        for path in (store.get_train_data_path(run_id),
                     store.get_val_data_path(run_id)):
            if isinstance(path, str) and os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)

    @staticmethod
    def _check_store_reachable(store, backend) -> None:
        """Fail fast instead of a FileNotFoundError deep in a barrier
        stage: a driver-local temp store cannot be read by executors on
        other hosts."""
        from .backend import SparkBackend

        if not isinstance(backend, SparkBackend):
            return
        if not getattr(store, "_owns_prefix", False):
            return  # user-chosen path: their responsibility (NFS etc.)
        try:
            import pyspark

            sc = pyspark.SparkContext._active_spark_context
            master = sc.master if sc is not None else ""
        except ImportError:
            return
        if master and not master.startswith("local"):
            raise HorovodTpuError(
                f"fit() on a non-local Spark cluster (master={master!r}) "
                "needs an explicit store on a path every executor can "
                "read (shared/NFS mount); the default store is a "
                "driver-local temp dir")

    # -- spec shared by all frameworks --
    # Shared distributed-training knobs (reference: both estimators
    # expose them — keras/estimator.py, torch/estimator.py).
    _params = dict(EstimatorParams._params, compression=None,
                   backward_passes_per_step=1)

    def _build_spec(self, store: Store, run_id: str,
                    meta: Dict[str, int]) -> Dict[str, Any]:
        return {
            "compression": self.compression,
            "backward_passes_per_step": self.backward_passes_per_step,
            "train_dir": store.get_train_data_path(run_id),
            "val_dir": store.get_val_data_path(run_id) if meta["val_rows"]
            else None,
            "run_path": store.get_run_path(run_id),
            "model_bytes": self._serialize_model(),
            "batch_size": self.batch_size,
            "epochs": self.epochs,
            "shuffle": self.shuffle,
            "verbose": self.verbose,
            "seed": self.random_seed,
            "callbacks": self.callbacks,
            "meta": meta,
            "device": self.device,
        }

    def _validate_params(self) -> None:
        """Fail-fast checks; run at the top of `fit`, before any data
        materialization.  Subclasses add framework-specific checks and
        call `super()._validate_params()` for these common ones."""
        if self.compression not in VALID_COMPRESSION:
            raise HorovodTpuError(
                f"compression must be one of "
                f"{[c for c in VALID_COMPRESSION if c]}, got "
                f"{self.compression!r}")
        if not isinstance(self.backward_passes_per_step, int) or \
                self.backward_passes_per_step < 1:
            raise HorovodTpuError(
                f"backward_passes_per_step must be an int >= 1, got "
                f"{self.backward_passes_per_step!r}")

    def _remote_trainer(self):
        raise NotImplementedError

    def _serialize_model(self) -> bytes:
        raise NotImplementedError

    def _make_model(self, result, meta, store, run_id) -> "HorovodModel":
        raise NotImplementedError


class HorovodModel(Params):
    """Fitted transformer (reference: estimator.py `HorovodModel`).

    `transform(df)` appends `output_cols` prediction columns, keeping
    the DataFrame flavor of the input (pandas or pyspark).
    """

    _params = {
        "model": None,
        "feature_cols": None,
        "output_cols": None,
        "history": None,
        "run_id": None,
    }

    def getModel(self):  # noqa: N802 — reference API name
        return self.model

    def get_history(self):
        return self.history

    def _predict(self, x):
        raise NotImplementedError

    def transform(self, df):
        from .util import _column_matrix, to_pandas

        # Materialize ONCE: a second toPandas() on a Spark plan with
        # non-deterministic ordering could misalign prediction rows.
        pdf = to_pandas(df)
        x = _column_matrix(pdf, self.feature_cols)
        preds = self._predict(x)
        cols: List[str] = self.output_cols or ["prediction"]
        out = to_output_frame(pdf, cols, preds)
        if hasattr(df, "toPandas"):  # Spark in → Spark out
            session = getattr(df, "sparkSession", None)
            if session is not None:
                return session.createDataFrame(out)
        return out


__all__ = ["HorovodEstimator", "HorovodModel", "CHECKPOINT_FILE"]
