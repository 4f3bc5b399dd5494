"""Lightning Spark estimator (counterpart of
`horovod_tpu/spark/lightning/__init__.py`).

Reference parity: `horovod/spark/lightning/` (`LightningEstimator`,
`LightningModel`, `remote.py` ≈2k LoC) — `fit(df)` trains a
`pl.LightningModule` across workers and returns a Spark transformer.

The reference drives a full `pl.Trainer` with a Horovod accelerator
plugin.  pytorch_lightning is not in this image, so this estimator
drives the *LightningModule contract* directly — the subset of the
Trainer loop the reference's remote trainer exercises:

  - ``configure_optimizers()`` supplies the optimizer (single-optimizer
    configs: a bare optimizer, ``([opts], [scheds])``, or a dict with
    an ``"optimizer"`` key);
  - ``training_step(batch, batch_idx)`` returns the loss (a tensor or a
    dict with a ``"loss"`` key);
  - ``validation_step(batch, batch_idx)`` (optional) produces val loss;
  - ``on_train_epoch_start/end`` hooks run when present.

A real ``pl.LightningModule`` is an ``nn.Module`` exposing exactly
these methods, so genuine Lightning modules work unchanged; any
duck-typed module with the same surface works too (how the tests run
without lightning installed).  Multi-optimizer configs (GAN-style) and
non-epoch scheduler intervals raise — the supported surface is
explicit, never silently approximated.

The worker epoch loop is `torch._worker.run_worker`, shared with
`TorchEstimator`; only the module-driven step/val/hook wiring lives
here.
"""

from __future__ import annotations

import io
from typing import Any, Dict

from ...common.exceptions import HorovodTpuError
from ..torch import TorchFamilyEstimator, TorchModel
from ..torch._worker import init_worker, run_worker

_CONTRACT = ("training_step", "configure_optimizers")


def _check_contract(module) -> None:
    missing = [m for m in _CONTRACT if not callable(getattr(module, m, None))]
    if missing:
        raise HorovodTpuError(
            "LightningEstimator: model must implement the LightningModule "
            f"contract; missing {missing} (any pl.LightningModule, or a "
            "torch module providing training_step/configure_optimizers)")


def _one_scheduler(s):
    """Scheduler entry → scheduler, rejecting cadences the epoch loop
    cannot honor (lightning dicts: {"scheduler": ..., "interval":
    "epoch"|"step", "frequency": n})."""
    if isinstance(s, dict):
        if s.get("interval", "epoch") != "epoch" or s.get("frequency", 1) != 1:
            raise HorovodTpuError(
                "LightningEstimator steps schedulers once per epoch; "
                f"unsupported lr_scheduler config {{'interval': "
                f"{s.get('interval', 'epoch')!r}, 'frequency': "
                f"{s.get('frequency', 1)!r}}}")
        if s.get("scheduler") is None:
            raise HorovodTpuError(
                "LightningEstimator: lr_scheduler dict needs a "
                "'scheduler' key")
        return s["scheduler"]
    return s


def _single_optimizer(cfg):
    """Normalize configure_optimizers() output to one optimizer.

    Accepted shapes (reference: lightning's init_optimizers): a bare
    Optimizer; ``([optimizers], [schedulers])``; a list/tuple of
    optimizers (must be exactly one — the bare ``return opt_g, opt_d``
    GAN form lands here and is rejected); a dict with an
    ``"optimizer"`` key.  Schedulers are returned so the epoch loop can
    ``step()`` them.
    """
    scheds: list = []
    # Lightning's "two lists" form ([opts], [scheds]) — accepted as a
    # tuple OR a list of two list/tuples (both are valid upstream).
    if (isinstance(cfg, (tuple, list)) and len(cfg) == 2
            and all(isinstance(c, (list, tuple)) for c in cfg)):
        opts, scheds = list(cfg[0]), list(cfg[1])
    elif isinstance(cfg, dict):
        if cfg.get("optimizer") is None:
            raise HorovodTpuError(
                "LightningEstimator: configure_optimizers() dict needs "
                "an 'optimizer' key")
        opts = [cfg["optimizer"]]
        s = cfg.get("lr_scheduler")
        scheds = [s] if s is not None else []
    elif isinstance(cfg, (list, tuple)):
        opts = list(cfg)
    else:
        opts = [cfg]
    if len(opts) != 1:
        raise HorovodTpuError(
            f"LightningEstimator supports single-optimizer modules; "
            f"configure_optimizers() returned {len(opts)}")
    return opts[0], [_one_scheduler(s) for s in scheds]


def _step_loss(out):
    """training_step/validation_step → scalar loss tensor."""
    if isinstance(out, dict):
        out = out.get("loss")
    if out is None:
        raise HorovodTpuError(
            "LightningEstimator: training_step must return a loss tensor "
            "or a dict with a 'loss' key")
    return out


def _lightning_remote_trainer(spec: Dict[str, Any]):
    """Per-worker training fn (reference: lightning/remote.py)."""
    import torch

    hvd_t = init_worker(spec)
    module = torch.load(io.BytesIO(spec["model_bytes"]),
                        weights_only=False).to(hvd_t.device())
    _check_contract(module)
    opt, scheds = _single_optimizer(module.configure_optimizers())

    val_step = None
    if callable(getattr(module, "validation_step", None)):
        val_step = lambda val: _step_loss(module.validation_step(val, 0))  # noqa: E731

    def _hook(name):
        fn = getattr(module, name, None)
        return fn if callable(fn) else None

    return run_worker(
        spec, hvd_t, module, opt,
        train_step=lambda batch, i: _step_loss(
            module.training_step(batch, i)),
        val_step=val_step,
        schedulers=scheds,
        on_epoch_start=_hook("on_train_epoch_start"),
        on_epoch_end=_hook("on_train_epoch_end"))


class LightningModel(TorchModel):
    """Fitted transformer (reference: lightning/estimator.py
    `LightningModel`): `transform(df)` runs the module's forward.
    Deserialization/prediction are `TorchModel`'s — a LightningModule
    IS a torch module."""


class LightningEstimator(TorchFamilyEstimator):
    """Distributed LightningModule estimator (reference:
    lightning/estimator.py `LightningEstimator`).

        est = LightningEstimator(model=lit_module,
                                 feature_cols=["x"], label_cols=["y"],
                                 epochs=3, num_proc=2)
        lit_model = est.fit(df)

    The module's own `configure_optimizers`/`training_step` drive
    training; `optimizer`/`loss`/`callbacks` estimator params are
    rejected to match the Lightning division of labor.
    """

    _model_cls = LightningModel

    def _validate_params(self) -> None:
        if self.loss is not None or self.optimizer is not None:
            raise HorovodTpuError(
                "LightningEstimator: loss/optimizer come from the "
                "LightningModule (training_step/configure_optimizers), "
                "not estimator params — use TorchEstimator for bare "
                "modules")
        if self.callbacks:
            raise HorovodTpuError(
                "LightningEstimator does not take callbacks; put the "
                "behavior in the module's epoch hooks "
                "(on_train_epoch_start/end)")
        _check_contract(self.model)
        # Driver-side rejection of unsupported optimizer configs — the
        # workers would otherwise all fail after data prep.
        _single_optimizer(self.model.configure_optimizers())
        if self.validation and not callable(
                getattr(self.model, "validation_step", None)):
            raise HorovodTpuError(
                "LightningEstimator: validation is set but the module "
                "has no validation_step — the val split would be carved "
                "out of training and never evaluated")
        super()._validate_params()

    def _remote_trainer(self):
        return _lightning_remote_trainer

    def _serialize_model(self) -> bytes:
        import torch

        buf = io.BytesIO()
        torch.save(self.model, buf)
        return buf.getvalue()


__all__ = ["LightningEstimator", "LightningModel"]
