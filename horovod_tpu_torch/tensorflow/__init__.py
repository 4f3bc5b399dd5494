"""`horovod_tpu_torch.tensorflow` — the TensorFlow 2 frontend over the
port's collectives (counterpart of `horovod_tpu/tensorflow/__init__.py`;
reference: horovod/tensorflow/__init__.py, mpi_ops.py).

Collectives on tf.Tensors, each with its gradient (`tf.custom_gradient`),
`DistributedGradientTape` (wraps `tf.GradientTape`: `gradient()`
allreduces every gradient in `_allreduce_grads`), `DistributedOptimizer`,
`broadcast_variables`, IndexedSlices (sparse, or sparse-as-dense),
`SyncBatchNormalization` and `join`.

A tf.Tensor crosses to a torch tensor on the rank's device by DLPack
(`_bridge.tf_to_torch`), runs through the port's collective core
(`ops/collectives.py`: NCCL on the card, gloo where ranks share a card
or run on the CPU) and comes back as a tf.Tensor of the caller's dtype
(`_bridge.torch_to_tf`).  Eager execution is the native mode; inside a
`tf.function` (`model.fit`'s step) the collective runs through
`tf.py_function`, on a TF executor thread, with the static shapes set.
Three things keep the crossings few, as in the JAX package:

  - DLPack: no numpy detour for any dtype TF and torch share;
  - `_fused_flat_allreduce`: the gradients are packed into one flat
    tensor a dtype on the TF side, so a model's update crosses once a
    dtype each way;
  - the size-1 short-circuit in `_allreduce_grads`: an allreduce over
    one rank is the identity and skips the bridge.

    import horovod_tpu_torch.tensorflow as hvd
    hvd.init()
    tape = hvd.DistributedGradientTape(tape)
    grads = tape.gradient(loss, model.trainable_variables)
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

try:
    import tensorflow as tf
except ImportError as e:  # pragma: no cover
    raise ImportError(
        "horovod_tpu_torch.tensorflow requires TensorFlow 2.x") from e

# Re-export the core surface (reference: horovod.tensorflow re-exports
# basics + mpi_ops).
from ..common.basics import (  # noqa: F401
    init,
    shutdown,
    is_initialized,
    size,
    rank,
    local_size,
    local_rank,
    cross_size,
    cross_rank,
    tpu_built,
    xla_built,
    mpi_built,
    nccl_built,
    gloo_built,
    ccl_built,
    cuda_built,
    rocm_built,
    ddl_built,
    mpi_enabled,
    gloo_enabled,
    global_process_set,
    mpi_threads_supported,
    add_process_set,
    remove_process_set,
    ProcessSet,
)
from ..common.exceptions import HorovodInternalError  # noqa: F401
from ..ops import collectives as C
from ..ops.collectives import (  # noqa: F401
    Average,
    Sum,
    Adasum,
    Min,
    Max,
    Product,
    HandleManager,
    barrier,
    join,
    poll,
)
from ..ops.compression import Compression  # noqa: F401
from ._bridge import tf_to_torch, torch_to_tf


def _to_np(t) -> np.ndarray:
    """tf.Tensor / tf.Variable / tf.IndexedSlices → numpy.

    IndexedSlices (sparse gradients from embedding lookups) densify first
    — the reference's `sparse_as_dense` path (tensorflow/__init__.py
    `_allreduce_cond`/convert_to_tensor on IndexedSlices).
    """
    if isinstance(t, tf.IndexedSlices):
        t = tf.convert_to_tensor(t)
    if isinstance(t, tf.Variable):
        t = t.value()
    return t.numpy() if hasattr(t, "numpy") else np.asarray(t)


def _eager_or_py_function(fn, tensors: Sequence, name: str,
                          out_shape_fn=None) -> List:
    """Run `fn(list_of_torch_tensors) -> list_of_torch_tensors` on tf
    tensors, through `tf.py_function` inside a tf.function graph (the
    reference's custom-op kernels serve the same role at graph execution
    time).  The inputs cross by DLPack to the rank's device
    (`tf_to_torch`), `fn` works on torch tensors there, and each result
    crosses back once, in its input's dtype (`torch_to_tf`).

    `out_shape_fn(input_shape) -> output_shape` sets the static shape of
    each graph-mode output (identity when omitted); return None entries
    for outputs whose shape is data-dependent (e.g. variable-dim0
    allgather)."""
    if tf.executing_eagerly():
        outs = fn([tf_to_torch(t) for t in tensors])
        return [torch_to_tf(o, like=t) for o, t in zip(outs, tensors)]

    dense = [tf.convert_to_tensor(t) if isinstance(t, tf.IndexedSlices)
             else t for t in tensors]

    def _bridge(*eager_tensors):
        outs = fn([tf_to_torch(t) for t in eager_tensors])
        return [torch_to_tf(o, like=t)
                for o, t in zip(outs, eager_tensors)]

    outs = tf.py_function(
        func=_bridge, inp=list(dense),
        Tout=[t.dtype for t in dense], name=name)
    for o, t in zip(outs, dense):
        shape = out_shape_fn(t.shape) if out_shape_fn else t.shape
        if shape is not None:
            o.set_shape(shape)
    return list(outs)


# ---------------------------------------------------------------------------
# Collective ops on tf tensors (reference: horovod/tensorflow/mpi_ops.py)
# ---------------------------------------------------------------------------

def _sparse_allreduce(slices: "tf.IndexedSlices", op,
                      process_set: Optional[ProcessSet] = None
                      ) -> "tf.IndexedSlices":
    """Allgather-based sparse allreduce of tf.IndexedSlices (reference:
    horovod/tensorflow/__init__.py ≈L350-450, the `sparse_as_dense=False`
    branch of allreduce): gather every rank's (values, indices) slabs and
    return IndexedSlices whose scatter-add equals the dense allreduce of
    the scattered input.  Average divides the gathered values by the
    participating size.  An embedding-heavy model moves only its touched
    rows instead of the full dense [vocab, dim] gradient per step."""
    if op not in (Average, Sum):
        raise NotImplementedError(
            "sparse (IndexedSlices) allreduce supports op=Average or Sum; "
            "densify first for other ops")
    values = allgather(slices.values, process_set=process_set)
    indices = allgather(slices.indices, process_set=process_set)
    if op is Average:
        n = len(process_set.ranks) if process_set is not None else size()
        values = values / tf.cast(n, values.dtype)
    return tf.IndexedSlices(values=values, indices=indices,
                            dense_shape=slices.dense_shape)


def allreduce(tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=Compression.none,
              process_set: Optional[ProcessSet] = None):
    if op is None:
        op = Sum if average is False else Average

    if isinstance(tensor, tf.IndexedSlices):
        # Reference semantics: allreduce of IndexedSlices is the
        # allgather-based sparse path and returns IndexedSlices.
        if prescale_factor != 1.0 or postscale_factor != 1.0:
            raise NotImplementedError(
                "prescale/postscale not supported for IndexedSlices; "
                "densify first")
        return _sparse_allreduce(tensor, op, process_set=process_set)

    def _fn(ts):
        x = ts[0]
        c, ctx = compression.compress(x)
        out = C.allreduce(c, op=op, name=name,
                          prescale_factor=prescale_factor,
                          postscale_factor=postscale_factor,
                          process_set=process_set)
        return [compression.decompress(out, ctx)]

    @tf.custom_gradient
    def _differentiable(x):
        out = _eager_or_py_function(_fn, [x], "HorovodAllreduce")[0]

        def grad(dy):
            # Reference: RegisterGradient('HorovodAllreduce') — the
            # gradient of allreduce is allreduce with the same op.
            return allreduce(dy, op=op, prescale_factor=prescale_factor,
                             postscale_factor=postscale_factor,
                             compression=compression,
                             process_set=process_set)

        return out, grad

    return _differentiable(tf.convert_to_tensor(tensor))


def grouped_allreduce(tensors: Sequence, average: Optional[bool] = None,
                      name: Optional[str] = None, op=None,
                      compression=Compression.none,
                      process_set: Optional[ProcessSet] = None) -> List:
    if op is None:
        op = Sum if average is False else Average

    def _fn(ts):
        comp, ctxs = [], []
        for x in ts:
            c, ctx = compression.compress(x)
            comp.append(c)
            ctxs.append(ctx)
        outs = C.grouped_allreduce(comp, op=op, process_set=process_set)
        return [compression.decompress(o, ctx)
                for o, ctx in zip(outs, ctxs)]

    @tf.custom_gradient
    def _differentiable(*xs):
        outs = _eager_or_py_function(_fn, list(xs),
                                     "HorovodGroupedAllreduce")

        def grad(*dys):
            # Reference: grouped allreduce gradient is the grouped
            # allreduce of the gradients (one fused pass both ways).
            return grouped_allreduce(list(dys), op=op,
                                     compression=compression,
                                     process_set=process_set)

        return outs, grad

    return list(_differentiable(*[tf.convert_to_tensor(t)
                                  for t in tensors]))


def grouped_allgather(tensors: Sequence, name: Optional[str] = None,
                      process_set: Optional[ProcessSet] = None) -> List:
    """Reference: hvd.grouped_allgather (tensorflow/mpi_ops.py)."""

    def _fn(ts):
        return C.grouped_allgather(list(ts), process_set=process_set)

    def _out_shape(shape):
        # dim0 is the sum of per-rank dim0s — data-dependent in general.
        return tf.TensorShape([None]).concatenate(shape[1:]) \
            if shape.rank else None

    return _eager_or_py_function(_fn, list(tensors),
                                 "HorovodGroupedAllgather",
                                 out_shape_fn=_out_shape)


def grouped_reducescatter(tensors: Sequence, op=Average,
                          name: Optional[str] = None,
                          process_set: Optional[ProcessSet] = None) -> List:
    """Reference: hvd.grouped_reducescatter (tensorflow/mpi_ops.py)."""

    def _fn(ts):
        return C.grouped_reducescatter(
            list(ts), op=op, process_set=process_set)

    def _out_shape(shape):
        # dim0 shrinks to this rank's 1/size slice.
        return tf.TensorShape([None]).concatenate(shape[1:]) \
            if shape.rank else None

    return _eager_or_py_function(_fn, list(tensors),
                                 "HorovodGroupedReducescatter",
                                 out_shape_fn=_out_shape)


def size_op(process_set: Optional[ProcessSet] = None,
            name: Optional[str] = None):
    """Graph-mode tensor variant (reference: tensorflow/mpi_ops.py
    size_op).  The world size is a CONSTANT baked into any tf.function
    trace that captures it, as in the JAX package.  After an elastic
    resize, rebuild such tf.functions (`TensorFlowKerasState.sync`
    rebuilds the model-side state; size-dependent step functions must be
    re-created alongside it)."""
    n = len(process_set.ranks) if process_set is not None else size()
    return tf.constant(n, dtype=tf.int32, name=name)


def rank_op(name: Optional[str] = None):
    """Graph-mode rank tensor (reference: mpi_ops.py rank_op)."""
    return tf.constant(rank(), dtype=tf.int32, name=name)


def local_rank_op(name: Optional[str] = None):
    return tf.constant(local_rank(), dtype=tf.int32, name=name)


def local_size_op(name: Optional[str] = None):
    return tf.constant(local_size(), dtype=tf.int32, name=name)


def process_set_included_op(process_set: ProcessSet,
                            name: Optional[str] = None):
    """1 if this process participates in `process_set` else 0
    (reference: mpi_ops.py process_set_included_op).  Uses the same
    membership predicate the collectives use, which accounts for every
    local device this process drives."""
    return tf.constant(int(process_set.included()), dtype=tf.int32,
                       name=name)


def allgather(tensor, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None):
    """First-dim concatenation across ranks (variable dim0 supported, like
    the reference's allgather with displacements)."""

    def _fn(ts):
        return [C.allgather(ts[0], name=name,
                            process_set=process_set)]

    def _out_shape(shape):
        # dim0 is the sum of per-rank dim0s — data-dependent in general.
        return tf.TensorShape([None]).concatenate(shape[1:]) \
            if shape.rank else None

    @tf.custom_gradient
    def _differentiable(x):
        out = _eager_or_py_function(_fn, [x], "HorovodAllgather",
                                    out_shape_fn=_out_shape)[0]
        n0 = tf.shape(x)[0]

        def grad(dy):
            # Reference: _allgather_grad — sum the output gradient
            # across ranks, then take this rank's slice (ragged offsets
            # from the gathered per-rank sizes).
            summed = allreduce(dy, op=Sum, process_set=process_set)
            sizes = allgather(tf.reshape(n0, [1]),
                              process_set=process_set)
            r = (process_set.rank() if process_set is not None
                 else rank())
            begin = tf.reduce_sum(sizes[:r])
            return summed[begin:begin + n0]

        return out, grad

    x = tf.convert_to_tensor(tensor)
    if x.shape.rank == 0:
        # The collective gathers scalars as [1]-slices; reshape so the
        # backward slice math sees the same shape (grad flows through).
        x = tf.reshape(x, [1])
    return _differentiable(x)


def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None):
    def _fn(ts):
        return [C.broadcast(ts[0], root_rank=root_rank,
                            name=name, process_set=process_set)]

    @tf.custom_gradient
    def _differentiable(x):
        out = _eager_or_py_function(_fn, [x], "HorovodBroadcast")[0]

        def grad(dy):
            # Reference: _broadcast_grad — gradients sum to the root;
            # non-root inputs did not influence the output.
            red = allreduce(dy, op=Sum, process_set=process_set)
            r = (process_set.rank() if process_set is not None
                 else rank())
            return red if r == root_rank else tf.zeros_like(red)

        return out, grad

    return _differentiable(tf.convert_to_tensor(tensor))


def alltoall(tensor, splits=None, name: Optional[str] = None,
             process_set: Optional[ProcessSet] = None):
    def _out_shape(shape):
        return tf.TensorShape([None]).concatenate(shape[1:]) \
            if shape.rank else None

    if splits is None:
        def _fn(ts):
            return [C.alltoall(ts[0], name=name,
                               process_set=process_set)]

        @tf.custom_gradient
        def _differentiable(x):
            out = _eager_or_py_function(_fn, [x], "HorovodAlltoall",
                                        out_shape_fn=_out_shape)[0]

            def grad(dy):
                # Reference: _alltoall_grad — equal splits invert
                # themselves by another alltoall.  (The explicit-splits
                # variant below is not differentiable here.)
                return alltoall(dy, process_set=process_set)

            return out, grad

        return _differentiable(tf.convert_to_tensor(tensor))

    # With splits the reference returns (received, received_splits); the
    # splits tensor rides the same bridge so graph mode works.
    def _fn2(ts):
        recv, recv_splits = C.alltoall(ts[0], splits=ts[1], name=name,
                                       process_set=process_set)
        return [recv, recv_splits]

    @tf.custom_gradient
    def _differentiable(x, s):
        out, recv_splits = _eager_or_py_function(
            _fn2, [x, s], "HorovodAlltoall", out_shape_fn=_out_shape)

        def grad(dy, d_recv_splits=None):
            # Reference: _alltoall_grad — the received splits describe
            # exactly how to route the gradient back; splits get none.
            back, _ = alltoall(dy, splits=recv_splits,
                               process_set=process_set)
            return back, None

        return (out, recv_splits), grad

    splits_t = tf.convert_to_tensor(splits, dtype=tf.int32)
    return _differentiable(tf.convert_to_tensor(tensor), splits_t)


def reducescatter(tensor, op=Average, name: Optional[str] = None,
                  process_set: Optional[ProcessSet] = None):
    def _fn(ts):
        return [C.reducescatter(ts[0], op=op, name=name,
                                process_set=process_set)]

    def _out_shape(shape):
        return tf.TensorShape([None]).concatenate(shape[1:]) \
            if shape.rank else None

    @tf.custom_gradient
    def _differentiable(x):
        out = _eager_or_py_function(_fn, [x], "HorovodReducescatter",
                                    out_shape_fn=_out_shape)[0]

        def grad(dy):
            # Reference: _reducescatter_grad — allgather the slice
            # gradients; Average needs the same 1/N the forward applied.
            g = allgather(dy, process_set=process_set)
            if op is Average:
                n = (len(process_set.ranks) if process_set is not None
                     else size())
                g = g / tf.cast(n, g.dtype)
            return g

        return out, grad

    return _differentiable(tf.convert_to_tensor(tensor))


# -- async variants (reference: *_async in mpi_ops.py) ----------------------
# Each runs its collective when called, as the JAX package's do, and
# hands back a handle over the finished result.

def _handle(result) -> int:
    return HandleManager.global_instance().allocate(C._done(result))


def allreduce_async(tensor, **kw) -> int:
    return _handle(allreduce(tensor, **kw))


def allgather_async(tensor, **kw) -> int:
    return _handle(allgather(tensor, **kw))


def broadcast_async(tensor, root_rank: int = 0, **kw) -> int:
    return _handle(broadcast(tensor, root_rank=root_rank, **kw))


def synchronize(handle: int):
    return C.synchronize(handle)


# ---------------------------------------------------------------------------
# Variable broadcast (reference: horovod/tensorflow/functions.py
# broadcast_variables, broadcast_object)
# ---------------------------------------------------------------------------

def broadcast_variables(variables: Sequence["tf.Variable"],
                        root_rank: int = 0,
                        process_set: Optional[ProcessSet] = None) -> None:
    """Assign every variable its root-rank value (reference:
    broadcast_variables — run once after init so all ranks start
    identical).  Crosses via the dlpack bridge like every other op."""
    for v in variables:
        v.assign(torch_to_tf(
            C.broadcast(tf_to_torch(v), root_rank=root_rank,
                        process_set=process_set),
            like=v))


def broadcast_object(obj: Any, root_rank: int = 0) -> Any:
    from ..ops.functions import broadcast_object as _bo
    return _bo(obj, root_rank=root_rank)


def broadcast_object_fn(root_rank: int = 0):
    """Reference horovod/tensorflow/functions.py `broadcast_object_fn`:
    returns a callable capturing `root_rank` (the session-reusable form
    of broadcast_object)."""

    def _fn(obj: Any) -> Any:
        return broadcast_object(obj, root_rank=root_rank)

    return _fn


def allgather_object(obj: Any, name: Optional[str] = None) -> List[Any]:
    """Reference horovod/tensorflow/functions.py `allgather_object`:
    gather an arbitrary picklable object from every rank, returning the
    rank-ordered list.  `name` is accepted for signature parity (the
    compiled path needs no tensor-name tag)."""
    del name
    from ..ops.functions import allgather_object as _ao
    return _ao(obj)


def broadcast_global_variables(root_rank: int = 0) -> None:
    """TF1-compat API: broadcast every global variable (reference:
    broadcast_global_variables)."""
    try:
        gvars = tf.compat.v1.global_variables()
    except Exception:
        gvars = []
    broadcast_variables(gvars, root_rank=root_rank)


# ---------------------------------------------------------------------------
# DistributedGradientTape (reference: horovod/tensorflow/__init__.py)
# ---------------------------------------------------------------------------

def _fused_flat_allreduce(dense: Sequence, op, compression,
                          process_set: Optional[ProcessSet],
                          prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0) -> List:
    """TF-side fusion buffer: concat same-dtype gradients into ONE flat
    tensor per dtype *before* crossing the bridge, allreduce once, split
    back with tf.split.  The reference's FusionBufferManager does this
    pack/unpack in C++ before one NCCL launch; here it collapses the
    per-tensor bridge crossings (TF -> the rank's device -> TF) into one
    a dtype."""
    by_dtype = {}
    for i, g in enumerate(dense):
        g = tf.convert_to_tensor(g)
        by_dtype.setdefault(g.dtype, []).append((i, g))
    out = [None] * len(dense)
    for dt, items in by_dtype.items():
        if len(items) == 1:
            i, g = items[0]
            out[i] = allreduce(g, op=op, compression=compression,
                               prescale_factor=prescale_factor,
                               postscale_factor=postscale_factor,
                               process_set=process_set)
            continue
        shapes = [g.shape for _, g in items]
        sizes = [int(np.prod(s)) if s.rank else 1 for s in shapes]
        flat = tf.concat([tf.reshape(g, [-1]) for _, g in items], axis=0)
        red = allreduce(flat, op=op, compression=compression,
                        prescale_factor=prescale_factor,
                        postscale_factor=postscale_factor,
                        process_set=process_set)
        parts = tf.split(red, sizes)
        for (i, _), part, shape in zip(items, parts, shapes):
            out[i] = tf.reshape(part, shape)
    return out


def _allreduce_grads(grads: Sequence, op, compression,
                     process_set: Optional[ProcessSet],
                     sparse_as_dense: bool,
                     gradient_predivide_factor: float = 1.0) -> List:
    """The reference's `_allreduce_grads`: fused (grouped) allreduce of all
    non-None gradients, None passed through at its position.

    IndexedSlices gradients follow `sparse_as_dense`: True densifies and
    rides the fused dense path (often faster for small vocabs);
    False (the reference default) keeps them sparse through the
    allgather-based `_sparse_allreduce`, moving only touched rows."""
    idx = [i for i, g in enumerate(grads) if g is not None]
    if not idx:
        return list(grads)
    n = len(process_set.ranks) if process_set is not None else size()
    if n == 1:
        # Allreduce over one rank is the identity for Sum and Average
        # alike (the reference's np=1 op is a memcpy); skip the bridge
        # entirely.  Densify IndexedSlices when asked so the output
        # types match the n>1 path.
        out = list(grads)
        for i in idx:
            if isinstance(out[i], tf.IndexedSlices) and sparse_as_dense:
                out[i] = tf.convert_to_tensor(out[i])
        return out
    out = list(grads)
    dense_idx, dense = [], []
    for i in idx:
        g = grads[i]
        if isinstance(g, tf.IndexedSlices):
            if sparse_as_dense:
                g = tf.convert_to_tensor(g)
            else:
                out[i] = _sparse_allreduce(g, op, process_set=process_set)
                continue
        dense_idx.append(i)
        dense.append(g)
    wire_op, pre, post = op, 1.0, 1.0
    if gradient_predivide_factor != 1.0:
        # Reference (gradient_predivide_factor): split the averaging
        # around the sum — scale by 1/f before, f/size after (numeric
        # range control for low-precision wires); the net is still the
        # exact average.
        if op is not Average:
            raise ValueError(
                "gradient_predivide_factor requires op=Average")
        wire_op, pre = Sum, 1.0 / gradient_predivide_factor
        post = gradient_predivide_factor / n
    if dense:
        reduced = _fused_flat_allreduce(dense, op=wire_op,
                                        compression=compression,
                                        process_set=process_set,
                                        prescale_factor=pre,
                                        postscale_factor=post)
        for i, r in zip(dense_idx, reduced):
            out[i] = r
    return out


class _DistributedGradientTape:
    """Wraps a `tf.GradientTape`: `gradient()` returns allreduced grads
    (reference: DistributedGradientTape / _make_gradient_tape)."""

    def __init__(self, tape: "tf.GradientTape", op=Average,
                 compression=Compression.none,
                 sparse_as_dense: bool = False,
                 gradient_predivide_factor: float = 1.0,
                 process_set: Optional[ProcessSet] = None):
        self._tape = tape
        self._op = op
        self._compression = compression
        self._sparse_as_dense = sparse_as_dense
        self._predivide = gradient_predivide_factor
        self._process_set = process_set

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources, output_gradients)
        flat = tf.nest.flatten(grads)
        reduced = _allreduce_grads(
            flat, self._op, self._compression, self._process_set,
            self._sparse_as_dense,
            gradient_predivide_factor=self._predivide)
        return tf.nest.pack_sequence_as(grads, reduced)

    # Context-manager & watch API pass through to the underlying tape.
    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def __getattr__(self, item):
        return getattr(self._tape, item)


def DistributedGradientTape(gradtape: "tf.GradientTape", device_dense="",
                            device_sparse="", op=Average,
                            compression=Compression.none,
                            sparse_as_dense: bool = False,
                            gradient_predivide_factor: float = 1.0,
                            num_groups: int = 0, groups=None,
                            process_set: Optional[ProcessSet] = None):
    """`device_dense/device_sparse/num_groups/groups` accepted for
    reference signature parity; the fusion groups are by dtype."""
    del device_dense, device_sparse, num_groups, groups
    return _DistributedGradientTape(
        gradtape, op=op, compression=compression,
        sparse_as_dense=sparse_as_dense,
        gradient_predivide_factor=gradient_predivide_factor,
        process_set=process_set)


# ---------------------------------------------------------------------------
# DistributedOptimizer for raw-TF training loops (reference:
# hvd.DistributedOptimizer in horovod/tensorflow/__init__.py)
# ---------------------------------------------------------------------------

class _DistributedOptimizer:
    """Wraps a Keras-3-style optimizer: gradients are allreduced in
    `apply_gradients`/`apply` before the update."""

    def __init__(self, optimizer, op=Average,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 sparse_as_dense: bool = False,
                 gradient_predivide_factor: float = 1.0,
                 process_set: Optional[ProcessSet] = None):
        self._opt = optimizer
        self._op = op
        self._compression = compression
        self._process_set = process_set
        self._sparse_as_dense = sparse_as_dense
        self._predivide = gradient_predivide_factor
        self._bpps = max(1, backward_passes_per_step)
        self._pass = 0
        self._acc: Optional[List[np.ndarray]] = None

    def _reduce(self, grads: Sequence) -> List:
        return _allreduce_grads(list(grads), self._op, self._compression,
                                self._process_set, self._sparse_as_dense,
                                gradient_predivide_factor=self._predivide)

    def apply_gradients(self, grads_and_vars, **kwargs):
        gv = list(grads_and_vars)
        grads = [g for g, _ in gv]
        tvars = [v for _, v in gv]
        if self._bpps > 1:
            # Local accumulation (reference: backward_passes_per_step /
            # LocalGradientAggregationHelper) — eager-mode only.  The
            # reference also aggregates inside tf.compat.v1 graphs
            # (gradient_aggregation.py); that path is excluded here, as
            # in the JAX package (its docs/MIGRATION.md "TF1 / graph
            # mode").
            if not tf.executing_eagerly():
                raise RuntimeError(
                    "backward_passes_per_step > 1 requires eager "
                    "execution; TF1/graph-mode local aggregation is a "
                    "documented exclusion (the JAX package's docs/"
                    "MIGRATION.md)")
            nps = [None if g is None else _to_np(g) for g in grads]
            if self._acc is None:
                self._acc = nps
            else:
                self._acc = [a if n is None else
                             (n if a is None else a + n)
                             for a, n in zip(self._acc, nps)]
            self._pass += 1
            if self._pass % self._bpps != 0:
                return None
            grads = [None if a is None else
                     tf.convert_to_tensor(a / self._bpps)
                     for a in self._acc]
            self._acc = None
        reduced = self._reduce(grads)
        return self._opt.apply_gradients(zip(reduced, tvars), **kwargs)

    def apply(self, grads, trainable_variables=None, **kwargs):
        if trainable_variables is None:
            return self.apply_gradients(grads, **kwargs)
        return self.apply_gradients(zip(grads, trainable_variables),
                                    **kwargs)

    def __getattr__(self, item):
        return getattr(self._opt, item)


def DistributedOptimizer(optimizer, name=None, device_dense="",
                         device_sparse="", op=Average,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         sparse_as_dense: bool = False,
                         gradient_predivide_factor: float = 1.0,
                         num_groups: int = 0, groups=None,
                         process_set: Optional[ProcessSet] = None):
    """`name`, `device_dense/device_sparse` and `num_groups/groups`
    (fusion groups are by dtype) are accepted for reference signature
    parity and ignored."""
    del name, device_dense, device_sparse, num_groups, groups
    return _DistributedOptimizer(
        optimizer, op=op, compression=compression,
        backward_passes_per_step=backward_passes_per_step,
        sparse_as_dense=sparse_as_dense,
        gradient_predivide_factor=gradient_predivide_factor,
        process_set=process_set)


def SyncBatchNormalization(*args, process_set: Optional[ProcessSet] = None,
                           **kwargs):
    """Batch normalization with cross-rank statistics (reference:
    horovod/tensorflow/sync_batch_norm.py `SyncBatchNormalization`).

    Overrides Keras BN's `_moments`: local moments are combined across
    ranks (mean of means; variance via E[x^2]-E[x]^2), assuming equal
    per-rank batch sizes like the reference.
    """
    import tensorflow as tf

    class _SyncBatchNormalization(tf.keras.layers.BatchNormalization):
        def __init__(self, *a, **kw):
            if kw.pop("synchronized", False):
                pass  # our sync replaces keras's own
            super().__init__(*a, **kw)
            self._hvd_process_set = process_set

        def _moments(self, inputs, mask):
            mean, var = super()._moments(inputs, mask)
            n = (self._hvd_process_set.size()
                 if self._hvd_process_set else size())
            if n == 1:
                return mean, var
            sq = var + tf.square(mean)
            group_mean, group_sq = grouped_allreduce(
                [mean, sq], op=Average,
                process_set=self._hvd_process_set)
            # Straight-through, as in the JAX package: the global value
            # with the LOCAL moments' gradient path (with gradient
            # averaging this matches the reference up to rank-identical
            # loss terms).  The port's torch SyncBatchNorm takes the
            # exact cross-rank gradient instead.
            group_mean = mean + tf.stop_gradient(group_mean - mean)
            group_sq = sq + tf.stop_gradient(group_sq - sq)
            # E[x^2] - mean^2 can round slightly negative in f32; a
            # negative variance would NaN the rsqrt downstream.
            return group_mean, tf.maximum(
                group_sq - tf.square(group_mean), 0.0)

    return _SyncBatchNormalization(*args, **kwargs)


# Framework-specific elastic namespace (hvd.elastic.TorchState / TensorFlowKerasState analog); at the end of the module because elastic.py imports symbols defined above.
from . import elastic  # noqa: F401,E402
