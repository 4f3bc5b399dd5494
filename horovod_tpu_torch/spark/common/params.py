"""Estimator parameter machinery (counterpart of
`horovod_tpu/spark/common/params.py`).

Reference parity: `horovod/spark/common/params.py` (`EstimatorParams`,
≈500 LoC of Spark-ML `Param` declarations with `setX`/`getX` pairs).

The reference builds on pyspark.ml.param so its estimators compose with
Spark ML pipelines.  Here the same surface — constructor keywords plus
`setFeatureCols(...)`-style fluent setters and `getFeatureCols()`
getters — is generated from one table, with no pyspark dependency, so
the estimators work against pandas DataFrames and plain Python in this
environment while keeping the reference's API shape.
"""

from __future__ import annotations

import re
from typing import Any, Dict


def _snake(camel: str) -> str:
    """setFeatureCols → feature_cols (reference accessor names are
    camelCase over snake_case param names)."""
    return re.sub(r"(?<!^)(?=[A-Z])", "_", camel).lower()


class Params:
    """Declarative param table → attributes + fluent setters/getters.

    Subclasses define `_params = {"name": default, ...}`; instances get
    `self.name`, `self.setName(v) -> self` and `self.getName()`.
    """

    _params: Dict[str, Any] = {}

    def __init__(self, **kwargs):
        table = self._collect_params()
        for name, default in table.items():
            setattr(self, name, kwargs.pop(name, default))
        if kwargs:
            raise TypeError(
                f"{type(self).__name__}: unknown params {sorted(kwargs)}; "
                f"valid: {sorted(table)}")

    @classmethod
    def _collect_params(cls) -> Dict[str, Any]:
        table: Dict[str, Any] = {}
        for klass in reversed(cls.__mro__):
            table.update(getattr(klass, "_params", {}))
        return table

    def __getattr__(self, item: str):
        # Fluent accessors are synthesized on demand: setX / getX.
        if item.startswith("set") and len(item) > 3:
            name = _snake(item[3:])
            if name in self._collect_params():
                def setter(value, _name=name):
                    setattr(self, _name, value)
                    return self
                return setter
        if item.startswith("get") and len(item) > 3:
            name = _snake(item[3:])
            if name in self._collect_params():
                return lambda _name=name: getattr(self, _name)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {item!r}")

    def param_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._collect_params()}


class EstimatorParams(Params):
    """Common estimator params (reference: params.py `EstimatorParams`).

    Names follow the reference: `feature_cols`/`label_cols` select
    DataFrame columns, `validation` is a fraction in (0,1) or the name
    of a boolean column, `num_proc` is the worker count, `store` holds
    intermediate data and checkpoints, `backend` overrides worker
    placement (auto: Spark barrier stage if a SparkContext is active,
    local processes otherwise).  `device` is where each worker trains
    and the fitted model predicts: None is the worker's card
    (`hvd.init()`'s default), "cpu" the CPU.
    """

    _params = {
        "model": None,
        "loss": None,
        "optimizer": None,
        "metrics": None,
        "feature_cols": None,
        "label_cols": None,
        "validation": None,
        "batch_size": 32,
        "epochs": 1,
        "callbacks": None,
        "shuffle": True,
        "verbose": 1,
        "random_seed": None,
        "num_proc": None,
        "store": None,
        "backend": None,
        "run_id": None,
        "custom_objects": None,
        "device": None,
    }


__all__ = ["Params", "EstimatorParams"]
