"""Torch Spark estimator (counterpart of
`horovod_tpu/spark/torch/__init__.py`).

Reference parity: `horovod/spark/torch/` (`TorchEstimator`,
`TorchModel`, `remote.py` ≈1.5k LoC) — `TorchEstimator.fit(df)` trains
a torch module across workers and returns a `TorchModel` transformer.

Mechanism mapping:
  - reference `remote.py` trainer (Petastorm loader, hook-driven
    `hvd.DistributedOptimizer`, `broadcast_parameters` /
    `broadcast_optimizer_state`) → `_torch_remote_trainer` over this
    rank's `.npy` shard with the same `horovod_tpu_torch.torch` pieces;
  - the reference passes an *instantiated* optimizer and rebinds it to
    the deserialized model's parameters (`torch/estimator.py`); both
    that and a factory callable are accepted here;
  - rank-0 checkpoint (pickled state_dict) into the store's run path;
  - the module trains on each worker's `hvd.device()` (the estimator's
    `device`: the card unless it says "cpu") and comes back, and is
    checkpointed, with CPU tensors.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict

import numpy as np

from ...common.exceptions import HorovodTpuError
from ..common.estimator import HorovodEstimator, HorovodModel
from ._worker import init_worker, run_worker


def _optimizer_recipe(optimizer):
    """Reduce an instantiated optimizer to (class, per-group
    hyperparams + group sizes) — preserving param groups, which the
    reference also rebinds on the worker (torch/estimator.py) — or keep
    a factory callable as-is."""
    import torch

    if optimizer is None:
        raise HorovodTpuError("TorchEstimator: optimizer is required")
    if isinstance(optimizer, torch.optim.Optimizer):
        groups = [
            {"shapes": [tuple(p.shape) for p in g["params"]],
             "options": {k: v for k, v in g.items() if k != "params"}}
            for g in optimizer.param_groups
        ]
        return ("class", type(optimizer), groups)
    if callable(optimizer):
        return ("factory", optimizer, None)
    raise HorovodTpuError(
        f"TorchEstimator: optimizer must be a torch Optimizer or a "
        f"callable(params) -> Optimizer, got {type(optimizer).__name__}")


def _build_optimizer(recipe, model):
    """Rebuild on the worker against the deserialized model's params.

    Group structure is restored positionally: the i-th group consumes
    the next len(shapes) of `model.parameters()` — exact when the
    original optimizer was built over the same module's parameters in
    order (the torch convention; param identity cannot cross pickling).
    Recorded per-param shapes are checked against what each slot
    receives — a best-effort guard: out-of-order groups with
    DISTINCT shapes fail loudly; identically-shaped groups cannot be
    distinguished positionally (pass a factory callable to be exact).
    """
    kind, obj, groups = recipe
    params = list(model.parameters())
    if kind == "factory":
        return obj(params)
    total = sum(len(g["shapes"]) for g in groups)
    if total != len(params):
        raise HorovodTpuError(
            f"TorchEstimator: optimizer covered {total} params but the "
            f"model has {len(params)}; build the optimizer over exactly "
            "model.parameters() (or pass a factory callable)")
    param_groups, i = [], 0
    for gi, g in enumerate(groups):
        take = params[i:i + len(g["shapes"])]
        got = [tuple(p.shape) for p in take]
        if got != [tuple(s) for s in g["shapes"]]:
            raise HorovodTpuError(
                f"TorchEstimator: param group {gi} shapes {g['shapes']} "
                f"don't match model.parameters() order (got {got}); "
                "build groups in model.parameters() order or pass a "
                "factory callable(params) -> Optimizer")
        param_groups.append({"params": take, **g["options"]})
        i += len(take)
    return obj(param_groups)


def _torch_remote_trainer(spec: Dict[str, Any]):
    """Per-worker training fn (reference: torch/remote.py).  The epoch
    loop lives in `_worker.run_worker`, shared with the lightning
    estimator; only the loss computation is supplied here."""
    import torch

    hvd_t = init_worker(spec)
    payload = pickle.loads(spec["model_bytes"])
    model = torch.load(io.BytesIO(payload["model"]),
                       weights_only=False).to(hvd_t.device())
    loss_fn = payload["loss"]
    opt = _build_optimizer(payload["opt_recipe"], model)

    return run_worker(
        spec, hvd_t, model, opt,
        train_step=lambda batch, i: loss_fn(model(batch[0]), batch[1]),
        val_step=lambda val: loss_fn(model(val[0]), val[1]))


class TorchModel(HorovodModel):
    """Fitted torch transformer (reference: torch/estimator.py
    `TorchModel`).  `_predict` runs the module on `device` (the card by
    default, "cpu" for the CPU): the estimator's."""

    _params = dict(HorovodModel._params, _model_bytes=None, device=None)

    def _materialize(self):
        if self.model is None:
            import torch

            self.model = torch.load(io.BytesIO(self._model_bytes),
                                    weights_only=False)
        return self.model

    def getModel(self):  # noqa: N802
        return self._materialize()

    def _predict(self, x: np.ndarray) -> np.ndarray:
        import torch

        dev = torch.device(self.device or "cuda")
        model = self._materialize().to(dev)
        model.eval()
        with torch.no_grad():
            out = model(torch.from_numpy(np.ascontiguousarray(x)).to(dev))
        return out.cpu().numpy()


class TorchFamilyEstimator(HorovodEstimator):
    """Shared base for estimators whose fitted model is a torch module
    shipped back as `torch.save` bytes (torch + lightning): the
    `_make_model` wiring is identical, parameterized by `_model_cls`."""

    _params = dict(HorovodEstimator._params, output_cols=None)
    _model_cls: type = None  # set by subclasses

    def _make_model(self, result, meta, store, run_id):
        return self._model_cls(
            _model_bytes=result["model"],
            feature_cols=self.feature_cols,
            output_cols=self.output_cols or ["prediction"],
            history=result["history"], run_id=run_id, device=self.device)


class TorchEstimator(TorchFamilyEstimator):
    """Distributed torch estimator (reference: torch/estimator.py
    `TorchEstimator`).

        est = TorchEstimator(model=net, optimizer=torch.optim.SGD(
                                 net.parameters(), lr=0.1),
                             loss=torch.nn.functional.mse_loss,
                             feature_cols=["x"], label_cols=["y"],
                             epochs=3, num_proc=2)
        torch_model = est.fit(df)
    """

    def _validate_params(self) -> None:
        if self.loss is None:
            raise HorovodTpuError("TorchEstimator: loss is required")
        if self.callbacks:
            raise HorovodTpuError(
                "TorchEstimator does not take callbacks (a Keras-style "
                "API); use KerasEstimator or drive the loop via "
                "horovod_tpu_torch.spark.run")
        _optimizer_recipe(self.optimizer)  # type check, fail fast
        super()._validate_params()

    def _remote_trainer(self):
        return _torch_remote_trainer

    def _serialize_model(self) -> bytes:
        import torch

        buf = io.BytesIO()
        torch.save(self.model, buf)
        return pickle.dumps({
            "model": buf.getvalue(),
            "loss": self.loss,
            "opt_recipe": _optimizer_recipe(self.optimizer),
        })


TorchEstimator._model_cls = TorchModel

__all__ = ["TorchEstimator", "TorchModel", "TorchFamilyEstimator"]
