"""`horovod_tpu_torch.tensorflow.keras` — the Keras frontend
(counterpart of `horovod_tpu/tensorflow/keras/__init__.py`; reference:
horovod/tensorflow/keras/__init__.py + shared impl horovod/_keras/).

`DistributedOptimizer` returns a dynamic subclass of the wrapped
optimizer's own class (the reference's pattern from
horovod/_keras/__init__.py `create_distributed_optimizer`) so Keras
serialization, `model.compile`, and isinstance checks keep working; the
subclass allreduces gradients in `apply_gradients` before the update.
Under `model.fit` the train step is a tf.function — the collective bridges
through `tf.py_function` (see horovod_tpu_torch.tensorflow).
"""

from __future__ import annotations

from typing import List, Optional

import tensorflow as tf

from .. import (  # noqa: F401
    init, shutdown, is_initialized, size, rank, local_size, local_rank,
    cross_size, cross_rank, tpu_built, xla_built, mpi_built, nccl_built,
    gloo_built, add_process_set, remove_process_set, ProcessSet,
    allreduce, allgather, broadcast, alltoall, grouped_allreduce,
    broadcast_variables, broadcast_object, join, barrier,
    Average, Sum, Adasum, Compression,
    _allreduce_grads,
)
from . import callbacks  # noqa: F401
from . import elastic  # noqa: F401


def DistributedOptimizer(optimizer, name: Optional[str] = None,
                         device_dense="", device_sparse="",
                         op=Average, compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         average_aggregated_gradients: bool = False,
                         sparse_as_dense: bool = False,
                         gradient_predivide_factor: float = 1.0,
                         num_groups: int = 0, groups=None,
                         process_set: Optional[ProcessSet] = None):
    """Wrap a Keras optimizer so every `apply_gradients` first averages
    gradients across ranks (reference: create_distributed_optimizer).

    `backward_passes_per_step > 1` locally accumulates gradients in
    non-trainable slots and only every Nth call allreduces and applies
    them (the reference's LocalGradientAggregationHelper,
    horovod/tensorflow/gradient_aggregation.py) — tf.Variable counter +
    tf.cond so it works inside model.fit's compiled train step.
    `average_aggregated_gradients` matches the reference flag and
    default: False SUMS the N locally-accumulated passes (effective
    batch-size scaling is the user's job, as upstream); True divides the
    accumulator by N before the allreduce."""
    cls = optimizer.__class__

    class _DistributedKerasOptimizer(cls):
        _hvd_op = op
        _hvd_compression = compression
        _hvd_process_set = process_set
        _hvd_bpps = int(backward_passes_per_step)
        _hvd_avg_agg = bool(average_aggregated_gradients)
        _hvd_sparse_as_dense = bool(sparse_as_dense)
        _hvd_predivide = float(gradient_predivide_factor)
        _hvd_local_layers = ()   # PartialDistributedOptimizer fills this

        def _hvd_local_refs(self):
            """Variable refs excluded from sync, resolved lazily so
            layers may build after the optimizer wraps."""
            # Keyed by id(): Keras-3 variables have no .ref(), and the
            # layer's variable objects ARE the ones Keras passes to
            # apply_gradients.
            refs = set()
            for entry in self._hvd_local_layers:
                vs = getattr(entry, "trainable_variables", None)
                for v in (vs if vs is not None else [entry]):
                    refs.add(id(v))
            return refs

        def _hvd_allreduce_partial(self, grads, tvars):
            """_allreduce_grads, skipping variables owned by local
            layers (their gradients apply as-is on every rank)."""
            refs = self._hvd_local_refs()
            # With no local refs every flag is False and the masked
            # call below degenerates to the plain _allreduce_grads —
            # one call site, no special case.
            flags = [v is not None and id(v) in refs for v in tvars]
            synced = _allreduce_grads(
                [None if f else g for g, f in zip(grads, flags)],
                self._hvd_op, self._hvd_compression,
                self._hvd_process_set, self._hvd_sparse_as_dense,
                gradient_predivide_factor=self._hvd_predivide)
            return [g if f else s
                    for g, s, f in zip(grads, synced, flags)]

        def _hvd_reduce_then(self, grads, tvars, apply_fn):
            """Allreduce-and-apply now (bpps==1), or accumulate and do
            so every Nth call (shared by both public entry points).

            `apply_fn(reduced)` runs the wrapped optimizer's own update
            with the inner-flag set so it is not re-intercepted."""

            def _apply_inner(reduced):
                self._hvd_inner = True
                try:
                    return apply_fn(reduced)
                finally:
                    self._hvd_inner = False

            if self._hvd_bpps == 1:
                # Preserve the wrapped optimizer's return value (Keras
                # contract: apply_gradients returns the iteration
                # counter).
                return _apply_inner(
                    self._hvd_allreduce_partial(grads, tvars))

            if getattr(self, "_hvd_accum_vars", None) is None:
                # First trace: create the aggregation slots.
                self._hvd_accum_vars = [
                    tf.Variable(tf.zeros_like(v), trainable=False)
                    for v in tvars]
                self._hvd_counter = tf.Variable(
                    0, dtype=tf.int64, trainable=False)
            for acc, g in zip(self._hvd_accum_vars, grads):
                acc.assign_add(tf.cast(tf.convert_to_tensor(g), acc.dtype))
            count = self._hvd_counter.assign_add(1)

            def _sync():
                if self._hvd_avg_agg:
                    local = [acc / tf.cast(self._hvd_bpps, acc.dtype)
                             for acc in self._hvd_accum_vars]
                else:
                    local = [tf.convert_to_tensor(acc)
                             for acc in self._hvd_accum_vars]
                _apply_inner(
                    self._hvd_allreduce_partial(local, tvars))
                for acc in self._hvd_accum_vars:
                    acc.assign(tf.zeros_like(acc))
                return tf.convert_to_tensor(self.iterations)

            def _skip():
                # Iteration-keyed LR schedules must count every batch
                # (reference: gradient_aggregation.py's non-aggregation
                # branch does the same assign_add).
                self.iterations.assign_add(1)
                return tf.convert_to_tensor(self.iterations)

            # Both branches return the iteration counter, matching the
            # Keras apply_gradients contract.
            return tf.cond(tf.equal(count % self._hvd_bpps, 0),
                           _sync, _skip)

        def apply_gradients(self, grads_and_vars, *args, **kwargs):
            gv = list(grads_and_vars)
            grads = [g for g, _ in gv]
            tvars = [v for _, v in gv]
            return self._hvd_reduce_then(
                grads, tvars,
                lambda reduced: super(
                    _DistributedKerasOptimizer, self).apply_gradients(
                        zip(reduced, tvars), *args, **kwargs))

        def apply(self, grads, trainable_variables=None, **kwargs):
            if getattr(self, "_hvd_inner", False):
                return super().apply(grads, trainable_variables, **kwargs)
            grads = list(grads)
            tvars = (list(trainable_variables)
                     if trainable_variables is not None else None)
            # Keras 3 allows apply(grads) with the optimizer's stored
            # variables implied — resolve them so local-layer flags
            # (PartialDistributedOptimizer) still match by identity.
            flag_vars = tvars
            if flag_vars is None:
                stored = getattr(self, "_trainable_variables", None)
                flag_vars = list(stored) if stored else grads
            return self._hvd_reduce_then(
                grads, flag_vars,
                lambda reduced: super(
                    _DistributedKerasOptimizer, self).apply(
                        reduced, tvars, **kwargs))

    _DistributedKerasOptimizer.__name__ = (
        name or "Distributed" + cls.__name__)
    cfg = optimizer.get_config()
    return _DistributedKerasOptimizer.from_config(cfg)


def PartialDistributedOptimizer(optimizer, local_layers=None, **kwargs):
    """Reference horovod/tensorflow/keras `PartialDistributedOptimizer`:
    a DistributedOptimizer that SKIPS synchronization for the variables
    of `local_layers` — those train with purely local gradients (e.g.
    per-rank embeddings or heads), everything else allreduces as usual.

    `local_layers` takes Keras layers (their `trainable_variables`,
    resolved lazily so layers may build after wrapping) or variables
    directly.  All DistributedOptimizer kwargs apply.

    Serialization boundary: the local-layer set references live layer
    objects and does NOT survive model save/load — `load_model`
    rewraps with a plain DistributedOptimizer; re-apply
    PartialDistributedOptimizer (and recompile) after loading."""
    opt = DistributedOptimizer(optimizer, **kwargs)
    opt._hvd_local_layers = tuple(local_layers or ())
    return opt


def _distributed_from_config_class(cls, compression, **dist_kwargs):
    """A deserialization proxy for `cls`: from_config builds the base
    optimizer and hands it to DistributedOptimizer (reference:
    horovod/_keras/__init__.py load_model's wrap_optimizer)."""

    class _Proxy(cls):
        @classmethod
        def from_config(klass, config, **kwargs):
            base = cls.from_config(config, **kwargs)
            return DistributedOptimizer(
                base, compression=compression, **dist_kwargs)

    _Proxy.__name__ = cls.__name__
    return _Proxy


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=Compression.none, **dist_kwargs):
    """Load a saved Keras model with its optimizer wrapped in
    `DistributedOptimizer` (reference: horovod/tensorflow/keras
    `load_model` → horovod/_keras/__init__.py).

    Every known `tf.keras.optimizers` class — plus any classes in
    `custom_optimizers` — is registered so that whichever optimizer the
    file deserializes comes back distributed.  Models saved while
    compiled with a `DistributedOptimizer` are also handled (their
    serialized class name is ``Distributed<Base>``).  `custom_objects`
    entries take precedence, matching the reference's merge order.
    Extra keyword arguments are forwarded to `DistributedOptimizer`.
    A PartialDistributedOptimizer's local-layer set does not survive
    serialization — models load with a plain DistributedOptimizer
    (re-apply the partial wrapper after loading).
    """
    import inspect

    opt_classes = [
        obj for _, obj in inspect.getmembers(tf.keras.optimizers)
        if inspect.isclass(obj)
        and issubclass(obj, tf.keras.optimizers.Optimizer)
        and obj is not tf.keras.optimizers.Optimizer
    ]
    for cls in (custom_optimizers or []):
        if cls not in opt_classes:
            opt_classes.append(cls)

    horovod_objects = {}
    for cls in opt_classes:
        proxy = _distributed_from_config_class(
            cls, compression, **dist_kwargs)
        for key in (cls.__name__, cls.__name__.lower(),
                    "Distributed" + cls.__name__):
            horovod_objects[key] = proxy
    if custom_objects:
        horovod_objects.update(custom_objects)
    model = tf.keras.models.load_model(
        filepath, custom_objects=horovod_objects)

    # Keras 3 resolves BUILT-IN optimizer class names by module path,
    # bypassing custom_objects (only custom/"Distributed*" names hit the
    # proxies above) — so a model saved with a plain optimizer arrives
    # unwrapped.  Wrap it now, transferring the restored slot state —
    # unless the user's custom_objects explicitly claimed this class
    # (the upstream merge-precedence opt-out).
    opt = getattr(model, "optimizer", None)
    user_claimed = opt is not None and custom_objects and (
        type(opt).__name__ in custom_objects
        or type(opt).__name__.lower() in custom_objects)
    if opt is not None and not user_claimed and not hasattr(opt, "_hvd_op"):
        wrapped = DistributedOptimizer(
            opt, compression=compression, **dist_kwargs)
        if getattr(opt, "built", False):
            wrapped.build(model.trainable_variables)
            if len(wrapped.variables) == len(opt.variables):
                for dst, src in zip(wrapped.variables, opt.variables):
                    dst.assign(src)
            else:
                # Keras restored a partial optimizer (its own "Skipping
                # variable loading" case): a prefix copy could misalign
                # slots silently, so keep the fresh state and say so.
                import warnings

                warnings.warn(
                    f"load_model: restored optimizer has "
                    f"{len(opt.variables)} variables but the wrapped "
                    f"optimizer builds {len(wrapped.variables)}; slot "
                    f"state NOT transferred (fresh optimizer state)",
                    stacklevel=2)
        model.optimizer = wrapped
    return model


def broadcast_model(model, root_rank: int = 0) -> None:
    """Broadcast model (and, when built, optimizer) variables from root."""
    broadcast_variables(model.variables, root_rank=root_rank)
    opt = getattr(model, "optimizer", None)
    if opt is not None and getattr(opt, "variables", None):
        broadcast_variables(
            [v for v in opt.variables if v.shape.num_elements()],
            root_rank=root_rank)
