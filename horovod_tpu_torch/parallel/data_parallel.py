"""Gradient bucketing and the bucket-by-bucket gradient reduction.

Counterpart of `horovod_tpu/parallel/data_parallel.py`: the pure
partition functions `_buckets_by_nbytes` (:70), `gradient_bucket_partition`
(:143) and `shard_group_partition` (:204), the wire policy's plans
`active_wire_policy` (:229), `wire_policy_plan` (:248) and
`fused_pipeline_plan` (:286), and the reduction `reduce_gradient_buckets`
/ `allreduce_gradients` / `error_feedback_init` (:365, :671, :760),
eager here.  For the same leaf shapes and dtypes the partitions are the
JAX package's index lists.  Wire sizes come from tensor metadata: a cast
compressor runs on a `meta` tensor, and a cooperative wire counts each
float element at 4 bytes (the ring's f32 staging buffer) while the
integer leaves form a leading bucket of their own, reduced exactly.

The reduction routes each bucket as the JAX package does (`bucket_codec`,
the one rule every gradient path of the port applies, and `check_wire`,
its refusals): a cooperative `compression=` rides the quantized ring
(`ops/quantized.py`), with sender-side error feedback when a state is
passed; with `compression` none and HOROVOD_WIRE_POLICY set (on the
global set), each bucket takes the codec the policy picks for its raw
bytes and dtype class: exact buckets the grouped allreduce, cast buckets
the cast, cooperative ones the ring.  The JAX package applies the policy
on its in-jit path only; the port is eager throughout, so its eager
reduction applies it.  The ring runs whole even under
HOROVOD_FUSED_COLLECTIVES=1: the JAX package chunks it there
(`pipelined_allreduce_shard`) so that XLA overlaps the chunks, but the
port's hops block, so chunks would only add hops.

`axis_name=` takes a `create_hierarchical_mesh` (the port's stand-in
for the JAX package's ("dcn", "hvd") axis pair; `check_axis` holds its
refusals).  With HOROVOD_HIERARCHICAL_ALLREDUCE=1 and op Average or Sum,
each exact or cast bucket is reduced hierarchically
(`hierarchical.grouped_start`: a buffer a dtype through the ici
reduce-scatter, the dcn allreduce on HOROVOD_HIERARCHICAL_DCN_WIRE, the
ici allgather), as the JAX package's `grouped_allreduce` routes a bucket
on the pair (ops/collectives.py:667-676); a cooperative bucket rides the
ring over the pair's ranks, which is the global set.  Without the flag
the pair reduces flat.

The step hooks (JAX :342-357, :422-426, :537-637, :723-733, :981-1015)
live here too: the reduction records `buckets_per_step`, `bucket_bytes`,
the wire metrics and the `wire_bucket_k` / `fused_bucket_k` instants,
and `allreduce_gradients` the gradient bytes.  The port has no compiled
dispatch, so its step boundary is the optimizer's `step()`
(`torch/__init__.py`, `parallel/optimizer.py`), which calls
`record_step`: one cycle mark, then one `step` span, `steps` and
`critical_path_ms`, in JAX's order; `utils/megastep.py` holds these
hooks off (`hold_step_hooks`) and records one per call instead.

The straggler reaction (JAX :96-137, :172-186): `set_reaction_rebalance`
caps the bucket COUNT of every partition (`trace/reaction.py` arms it
with 1 against a blamed rank), and `reaction_generation` counts the
arms and disarms.  The eager reduction reads the partition at every
call, so it follows at once; `fused_apply` and ZeRO 1-3 bake theirs and
raise on the step after a change; megastep captures its graph again.
The stage-0 hook optimizer forms its buckets from the running threshold
as gradients arrive and does not read the cap, as the JAX package's
torch shim does not.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import torch

from ..common import basics, util
from ..common.basics import ProcessSet
from ..common.exceptions import HorovodTpuError
from ..ops import collectives as C
from ..ops import fused_collectives as _fc
from ..ops import wire as _wire
from ..ops.compression import Compression, NoneCompressor, is_cooperative
from ..ops.quantized import quantized_allreduce_shard
from ..metrics import catalog as _met
from ..utils import timeline as _tl
from . import hierarchical as _hier
from .mesh import is_hierarchical


# -- the step hooks ----------------------------------------------------------

_held = 0  # hold_step_hooks depth


@contextlib.contextmanager
def hold_step_hooks() -> Iterator[None]:
    """Hold the optimizers' step hooks off (`step_hooks_held`): megastep
    runs k steps a call, and a CUDA graph's replay runs none of their
    Python, so it records one step per call itself."""
    global _held
    _held += 1
    try:
        yield
    finally:
        _held -= 1


def step_hooks_held() -> bool:
    return _held > 0


StepClock = Tuple[float, Optional[float]]


def step_clock() -> StepClock:
    """The start of a step: the host clock, and the timeline's clock when
    a timeline is on and HOROVOD_TRACE_STEP_SPANS (default 1) asks for
    step spans."""
    tl = _tl.get_timeline()
    return (time.perf_counter(),
            tl.now_us() if tl is not None
            and util.env_bool("TRACE_STEP_SPANS", True) else None)


def record_step(clock: StepClock, steps: int = 1) -> None:
    """The step boundary's instruments (JAX data_parallel :995-1015):
    mark a cycle, then a `step` span from `clock` (after the mark, so the
    span carries the ID of the step it measured), and `steps`,
    `critical_path_ms` (this step's host wall ms) and, under the fused
    pipeline, `fused_steps`."""
    t0, t0_us = clock
    tl = _tl.get_timeline()
    if tl is not None:
        tl.mark_cycle()
        if t0_us is not None:
            tl.complete("step", category="step", start_us=t0_us)
    if _met.enabled():
        _met.steps.inc(steps)
        _met.critical_path_ms.set((time.perf_counter() - t0) * 1e3)
        if _fc.fused_enabled():
            _met.fused_steps.inc(steps)


def record_buckets(buckets: Sequence[Tuple[str, int, int]],
                   policy: bool) -> None:
    """One eager reduction's bucket metrics from its (wire, raw bytes,
    wire bytes) per bucket: `buckets_per_step` and `bucket_bytes` (the
    mean raw bytes), and under a wire policy, as in the JAX package,
    `wire_bytes_saved` and the per-step wire gauges."""
    if not _met.enabled() or not buckets:
        return
    raw = sum(b[1] for b in buckets)
    wire = sum(b[2] for b in buckets)
    _met.buckets_per_step.set(len(buckets))
    _met.bucket_bytes.set(raw // len(buckets))
    if not policy:
        return
    _met.wire_bytes_saved.inc(raw - wire)
    _met.wire_bytes_saved_per_step.set(raw - wire)
    fmt: dict = {}
    for name, _, w in buckets:
        fmt[name] = fmt.get(name, 0) + w
    for name, w in fmt.items():
        _met.wire_format_bytes.labels(name).set(w)


def bucket_instant(k: int, wire: str, leaves: int, raw: int, wbytes: int,
                   chunks: Optional[List[Tuple[int, int]]] = None) -> None:
    """The timeline's `wire_bucket_k` instant (and `fused_bucket_k` when
    the bucket went through the fused pipeline in `chunks`): the JAX
    package labels the buckets of a wire policy's reduction."""
    tl = _tl.get_timeline()
    if tl is None:
        return
    tl.instant(f"wire_bucket_{k}", category="wire",
               args={"bucket": k, "format": wire, "leaves": leaves,
                     "raw_bytes": raw, "wire_bytes": wbytes})
    if chunks:
        tl.instant(f"fused_bucket_{k}", category="fused",
                   args={"bucket": k, "format": wire,
                         "chunks": len(chunks),
                         "chunk_bytes": 4 * chunks[0][1]})


def _bucket_permutation(n: int, bucket_order) -> List[int]:
    """Leaf traversal order for bucket formation: "forward" (leaf
    order), "reverse" (backward-availability order: autograd produces the
    last layer's gradients first), or an explicit permutation."""
    if bucket_order is None or bucket_order == "forward":
        return list(range(n))
    if bucket_order == "reverse":
        return list(range(n - 1, -1, -1))
    if isinstance(bucket_order, str):
        raise ValueError(
            f"bucket_order must be 'forward', 'reverse', or an explicit "
            f"permutation sequence, got {bucket_order!r}")
    perm = [int(i) for i in bucket_order]
    if sorted(perm) != list(range(n)):
        raise ValueError(
            f"bucket_order permutation must rearrange range({n}) exactly "
            f"once each, got {perm}")
    return perm


def _buckets_by_nbytes(nbytes: Sequence[int], threshold_bytes: int,
                       bucket_order="forward") -> List[List[int]]:
    """Greedy size-capped bucketing over per-item byte counts; buckets
    hold original indices, in `bucket_order` traversal order."""
    buckets: List[List[int]] = [[]]
    cur = 0
    for i in _bucket_permutation(len(nbytes), bucket_order):
        if buckets[-1] and cur + nbytes[i] > threshold_bytes:
            buckets.append([])
            cur = 0
        buckets[-1].append(i)
        cur += nbytes[i]
    return buckets


def _wire_nbytes(t: torch.Tensor, compression) -> int:
    """Bytes of `t` on the wire after `compression`, from metadata (the
    optimizer's hooks call this for every gradient: the exact wire needs
    no compressor call, and a cooperative wire stages each element in an
    f32 buffer)."""
    if compression is Compression.none:
        return math.prod(t.shape) * t.dtype.itemsize
    if is_cooperative(compression):
        return math.prod(t.shape) * 4
    c = compression.compress(torch.empty(t.shape, dtype=t.dtype,
                                         device="meta"))[0]
    return c.numel() * c.element_size()


# -- the straggler reaction's partition override ------------------------
# Fewer, larger buckets mean a straggler pays its per-collective overhead
# once per step instead of once per bucket.  Module-level so that every
# consumer of the partition sees the same override; generation-counted
# so that baked partitions and captured graphs are invalidated loudly.
_REACTION = {"max_buckets": 0, "avoid_rank": -1, "generation": 0}


def set_reaction_rebalance(max_buckets: int, avoid_rank: int = -1) -> int:
    """Arm the straggler rebalance: cap the gradient bucket partition at
    `max_buckets` buckets (1: one bucket, the strongest form).
    `avoid_rank` records whom the rebalance shields (informational: the
    partition is rank-symmetric, so every rank arms the same override
    in lockstep).  Returns the new reaction generation."""
    _REACTION["max_buckets"] = max(0, int(max_buckets))
    _REACTION["avoid_rank"] = int(avoid_rank)
    _REACTION["generation"] += 1
    if _met.enabled():
        _met.reaction_max_buckets.set(_REACTION["max_buckets"])
    return _REACTION["generation"]


def clear_reaction_rebalance() -> int:
    """Disarm the straggler rebalance (also a new generation: the
    partition changes back)."""
    return set_reaction_rebalance(0, -1)


def reaction_rebalance() -> Tuple[int, int]:
    """(max_buckets, avoid_rank) of the armed override; (0, -1) when
    disarmed."""
    return (_REACTION["max_buckets"], _REACTION["avoid_rank"])


def reaction_generation() -> int:
    """Monotone counter bumped on every arm and disarm."""
    return _REACTION["generation"]


def gradient_bucket_partition(leaves: Sequence[torch.Tensor],
                              compression=Compression.none,
                              fusion_threshold_bytes: Optional[int] = None,
                              bucket_order=None) -> List[List[int]]:
    """The bucket partition of `leaves` (tensors, or anything with their
    shape and dtype): a list of original-index lists covering every leaf
    once, in collective-issue order.  Under a cooperative compressor the
    integer leaves form a leading bucket and the float leaves are counted
    at 4 bytes an element.  Defaults come from the live tunables
    (HOROVOD_FUSION_THRESHOLD, HOROVOD_BUCKET_ORDER,
    HOROVOD_MIN_BUCKETS); an armed straggler rebalance caps the bucket
    count."""
    from ..utils.autotune import (current_bucket_order,
                                  current_fusion_threshold,
                                  current_min_buckets)

    if fusion_threshold_bytes is None:
        fusion_threshold_bytes = current_fusion_threshold()
    if bucket_order is None:
        bucket_order = current_bucket_order()

    def cap(nbytes):
        m = current_min_buckets()
        threshold = fusion_threshold_bytes
        if m > 1 and nbytes:
            # At least `m` buckets: cap the effective threshold.
            threshold = min(threshold, max(1, -(-sum(nbytes) // m)))
        # The straggler rebalance: at most `max_buckets` buckets, by
        # RAISING the threshold (wins over both knobs above).  Exact for
        # 1 (the greedy split is strict-`>`), best-effort above.
        mb = _REACTION["max_buckets"]
        if mb >= 1 and nbytes:
            threshold = max(threshold, -(-sum(nbytes) // mb))
        return threshold

    if is_cooperative(compression):
        float_idx = [i for i, t in enumerate(leaves)
                     if t.dtype.is_floating_point]
        floats = set(float_idx)
        int_idx = [i for i in range(len(leaves)) if i not in floats]
        nbytes = [math.prod(leaves[i].shape) * 4 for i in float_idx]
        buckets = _buckets_by_nbytes(nbytes, cap(nbytes), bucket_order)
        parts = [[float_idx[j] for j in b] for b in buckets if b]
        return ([int_idx] if int_idx else []) + parts
    nbytes = [_wire_nbytes(t, compression) for t in leaves]
    return [b for b in _buckets_by_nbytes(nbytes, cap(nbytes), bucket_order)
            if b]


def shard_group_partition(leaves: Sequence[torch.Tensor],
                          compression=Compression.none,
                          fusion_threshold_bytes: Optional[int] = None,
                          bucket_order=None) -> List[List[int]]:
    """The ZeRO shard groups: the buckets of `gradient_bucket_partition`
    split further by dtype (a flat shard buffer holds one dtype), in
    order of first appearance.  The sharded optimizer and
    `zero3_placement` both bake this partition, so gradient shards,
    optimizer-state shards and parameter rows cover the same groups."""
    groups = []
    for idxs in gradient_bucket_partition(
            leaves, compression=compression,
            fusion_threshold_bytes=fusion_threshold_bytes,
            bucket_order=bucket_order):
        by_dt: dict = {}
        for i in idxs:
            by_dt.setdefault(leaves[i].dtype, []).append(i)
        groups.extend(by_dt.values())
    return groups


# ---------------------------------------------------------------------------
# The wire policy's plans
# ---------------------------------------------------------------------------

def active_wire_policy(compression=Compression.none,
                       process_set: Optional[ProcessSet] = None
                       ) -> Optional[_wire.WirePolicy]:
    """The per-bucket wire policy a gradient reduction applies, or None:
    HOROVOD_WIRE_POLICY engages only with compression none on the global
    set (an explicit `compression=` wins, and the ring spans the whole
    set, so subsets stay exact), and "exact" switches it off, so that
    path is bitwise the unset one."""
    if process_set is not None and process_set.process_set_id != 0:
        return None
    if not (isinstance(compression, type)
            and issubclass(compression, NoneCompressor)):
        return None
    policy = _wire.policy_from_env()
    if policy is None or policy.exact:
        return None
    return policy


def _numel(t) -> int:
    return math.prod(t.shape)


def wire_policy_plan(leaves: Sequence[torch.Tensor],
                     policy: Optional[_wire.WirePolicy] = None,
                     fusion_threshold_bytes: Optional[int] = None,
                     bucket_order=None) -> list:
    """The policy's wire for each bucket of `leaves`: a list of
    `(indices, wire_name, raw_bytes, wire_bytes)` over the partition with
    compression none.  `policy=None` reads HOROVOD_WIRE_POLICY (unset:
    every bucket exact).  Metadata only."""
    if policy is None:
        policy = _wire.policy_from_env() or _wire.WirePolicy()
    plan = []
    for idxs in gradient_bucket_partition(
            leaves, compression=Compression.none,
            fusion_threshold_bytes=fusion_threshold_bytes,
            bucket_order=bucket_order):
        all_float = all(leaves[i].dtype.is_floating_point for i in idxs)
        raw = sum(_numel(leaves[i]) * leaves[i].dtype.itemsize
                  for i in idxs)
        codec = bucket_codec(Compression.none, policy, raw, all_float)
        if codec.exact:
            wire_bytes = raw
        elif codec.cast_dtype is not None:
            wire_bytes = sum(_numel(leaves[i]) * codec.cast_dtype.itemsize
                             for i in idxs)
        else:
            wire_bytes = codec.wire_nbytes(sum(_numel(leaves[i])
                                               for i in idxs))
        plan.append((idxs, codec.name, raw, wire_bytes))
    return plan


def fused_pipeline_plan(leaves: Sequence[torch.Tensor],
                        policy: Optional[_wire.WirePolicy] = None,
                        fusion_threshold_bytes: Optional[int] = None,
                        bucket_order=None,
                        chunk_bytes: Optional[int] = None) -> list:
    """The chunk schedule of the fused pipeline over the
    `wire_policy_plan` partition: one `(indices, wire_name, n_chunks,
    chunk_bytes, occupancy)` per bucket, occupancy = 1 - 1/n_chunks (the
    share of a bucket's wire time that another chunk's stage can hide).
    Metadata only."""
    if chunk_bytes is None:
        from ..utils.autotune import current_fused_chunk_bytes
        chunk_bytes = current_fused_chunk_bytes()
    plan = []
    for idxs, name, _raw, _wb in wire_policy_plan(
            leaves, policy=policy,
            fusion_threshold_bytes=fusion_threshold_bytes,
            bucket_order=bucket_order):
        nelem = sum(_numel(leaves[i]) for i in idxs)
        itemsize = max((leaves[i].dtype.itemsize for i in idxs), default=4)
        k = len(_fc.plan_chunks(nelem, itemsize, chunk_bytes=chunk_bytes))
        plan.append((idxs, name, k, chunk_bytes, 1.0 - 1.0 / k))
    return plan


# ---------------------------------------------------------------------------
# The reduction
# ---------------------------------------------------------------------------

def bucket_codec(compression, policy: Optional[_wire.WirePolicy],
                 raw_bytes: int, all_float: bool
                 ) -> Optional[_wire.WireCodec]:
    """The wire of one gradient bucket: a cooperative `compression=`'s
    codec (exact for the leading bucket of integer leaves), else the
    policy's pick for the bucket's raw bytes and dtype class, else None
    (the bucket rides `compression`'s compress / decompress)."""
    if is_cooperative(compression):
        return _wire.get_codec(compression.wire if all_float else "none")
    if policy is None:
        return None
    return _wire.get_codec(policy.codec_for(raw_bytes, all_float))


def _may_ring(policy: Optional[_wire.WirePolicy]) -> bool:
    """Whether the policy can send a bucket to the ring (a `big` read
    from the live knob can)."""
    return policy is not None and (
        policy.big is None or _wire.get_codec(policy.big).cooperative
        or _wire.get_codec(policy.small).cooperative)


def check_wire(compression, op, process_set: Optional[ProcessSet],
               policy: Optional[_wire.WirePolicy],
               gradient_predivide_factor: float = 1.0) -> None:
    """The JAX package's refusals of a gradient reduction's wire: a
    cooperative `compression=` takes no process-set subset, and both it
    and a policy take no op but Average and Sum.  A wire that can reach
    the ring also takes no `gradient_predivide_factor` != 1: the ring
    divides once, after its last decode, and has no prescaled form."""
    if is_cooperative(compression):
        what = f"Compression.{compression.wire}"
        if process_set is not None and process_set.process_set_id != 0:
            raise ValueError(
                f"{what} does not support process_set subsets; use "
                "fp16/bf16 compression for subset reductions")
    elif policy is not None:
        what = "HOROVOD_WIRE_POLICY"
    else:
        return
    if op is not C.Average and op is not C.Sum:
        raise ValueError(f"{what} supports op=Average or Sum, got {op}")
    if gradient_predivide_factor != 1.0 and (is_cooperative(compression)
                                             or _may_ring(policy)):
        raise ValueError(
            f"{what} takes no gradient_predivide_factor: the quantized "
            "ring divides once, after its last decode")


def check_axis(axis_name, process_set: Optional[ProcessSet] = None):
    """The refusals of `axis_name=`: only a hierarchical mesh (the
    ("dcn", "hvd") pair), over every rank of the job, and no process-set
    subset with it, since its "hvd" axis is slice-local (the JAX
    package's message).  Returns the mesh, or None."""
    if axis_name is None:
        return None
    if not is_hierarchical(axis_name):
        raise ValueError(
            "axis_name takes a create_hierarchical_mesh (the ('dcn', "
            f"'hvd') axis pair); got {axis_name!r} — the flat path runs "
            "over process_set")
    if axis_name.ranks != tuple(range(basics.size())):
        raise ValueError(
            f"the hierarchical mesh spans ranks {axis_name.ranks}; the "
            f"gradient paths need all {basics.size()}")
    if process_set is not None and process_set.process_set_id != 0:
        raise HorovodTpuError(
            f"process_set with a hierarchical axis_name requires the "
            f"'hvd' axis to span all {basics.size()} ranks; this mesh's "
            f"spans {axis_name.size('hvd')} (hierarchical sub-axis?) — "
            "use the flat path (no axis_name) instead")
    return axis_name


def hier_route(axis_name, op, process_set: Optional[ProcessSet] = None):
    """The mesh a bucket's exact or cast wire reduces over
    hierarchically, or None (the flat path): the JAX package's rule (a
    pair, the flag, Average or Sum, no explicit process set)."""
    mesh = check_axis(axis_name, process_set)
    if mesh is not None and process_set is None and _hier.routes(mesh, op):
        return mesh
    return None


def _grouped(group: List[torch.Tensor], op, process_set,
             hier_mesh=None) -> list:
    """The exact grouped allreduce of one bucket (chunked under the fused
    pipeline on the global set, bitwise the same sums), or its
    hierarchical form on `hier_mesh`."""
    if hier_mesh is not None:
        return _hier.grouped_start(group, hier_mesh, op is C.Average)()
    if _fused_route(op, process_set, hier_mesh):
        return _fc.pipelined_grouped_allreduce(group, op=op)
    return C.grouped_allreduce(group, op=op, process_set=process_set)


def _fused_route(op, process_set, hier_mesh) -> bool:
    """Whether `_grouped` takes the fused pipeline."""
    return (hier_mesh is None and _fc.fused_enabled()
            and op in (C.Average, C.Sum)
            and (process_set is None or process_set.process_set_id == 0))


def _sentinel_flags(leaves: Sequence[torch.Tensor], results,
                    process_set: Optional[ProcessSet],
                    input_buckets=()) -> torch.Tensor:
    """The sentinel of the eager reduction: per-bucket 0/1 flags over the
    reduced output leaves, OR-ed across ranks with one Max allreduce, so
    every rank gates on the same f32[B] vector.

    The outputs are replicated, so each rank scans its 1/n slice of them
    (`sliced_nonfinite`; the OR restores full coverage).  Exact and cast
    wires carry a non-finite value into the output (NaN + x is NaN, an
    f16 overflow is Inf), so the output check is complete for them.  A
    quantizing codec's integer cast can launder a NaN: the buckets on
    one are listed in `input_buckets` (positions, or True for all) and
    also get the full check of their input leaves.  (The JAX package
    adds a sliced scan of the other buckets' inputs too, which flags
    nothing more; it is there for XLA's scheduling.)"""
    from ..guard import sentinel as _sent
    from ..utils import timeline as _tl
    ps = C._resolve_set(process_set)
    tl = _tl.get_timeline()
    flags = []
    for k, (idxs, outs) in enumerate(results):
        f = _sent.sliced_nonfinite(outs, ps)
        if input_buckets is True or k in input_buckets:
            f = torch.maximum(
                f, _sent.local_nonfinite([leaves[i] for i in idxs]))
        flags.append(f)
        if tl is not None:
            tl.instant(f"guard_bucket_{k}", category="guard",
                       args={"bucket": k, "leaves": len(idxs)})
    vec = (torch.stack(flags) if flags else
           torch.zeros((1,), dtype=torch.float32,
                       device=leaves[0].device if leaves else None))
    return _sent.crossrank_or(vec, process_set=process_set)


def reduce_gradient_buckets(leaves: Sequence[torch.Tensor],
                            op=C.Average, compression=Compression.none,
                            process_set: Optional[ProcessSet] = None,
                            fusion_threshold_bytes: Optional[int] = None,
                            bucket_order=None,
                            error_feedback_leaves=None,
                            sentinel: bool = False, axis_name=None):
    """Reduce a flat list of gradients bucket by bucket (the routing of
    the module docstring; `axis_name` a hierarchical mesh or None).  Returns `(bucket_results, new_ef)`:
    `(original_indices, reduced_leaves)` per bucket in issue order, and
    the new residual per float leaf in float-leaf order (None unless
    `error_feedback_leaves` was passed).  `sentinel=True` appends a third
    element: the cross-rank f32[B] per-bucket non-finite flags
    (`_sentinel_flags`)."""
    policy = active_wire_policy(compression, process_set)
    hier_mesh = hier_route(axis_name, op, process_set)
    ef = error_feedback_leaves
    if ef is not None and not (is_cooperative(compression)
                               or policy is not None):
        raise ValueError(
            "error_feedback_state only applies to the quantized wire "
            "formats (Compression.int8 / int4 / fp8_*, or a quantizing "
            "HOROVOD_WIRE_POLICY) — exact and fp16/bf16 wires have no "
            "compression error to feed back")
    check_wire(compression, op, process_set, policy)
    float_ord = {}
    for i, t in enumerate(leaves):
        if t.dtype.is_floating_point:
            float_ord[i] = len(float_ord)
    if ef is not None and len(ef) != len(float_ord):
        raise ValueError(
            f"error_feedback_state has {len(ef)} leaves; expected one per "
            f"float gradient leaf ({len(float_ord)}) — build it with "
            "error_feedback_init(grads)")
    new_ef = list(ef) if ef is not None else None
    parts = gradient_bucket_partition(
        leaves, compression=compression,
        fusion_threshold_bytes=fusion_threshold_bytes,
        bucket_order=bucket_order)
    results = []
    launder = set()  # buckets on a quantizing codec
    stats = []  # (wire, raw bytes, wire bytes) per bucket
    for k, idxs in enumerate(parts):
        group = [leaves[i].detach() for i in idxs]
        raw = sum(t.numel() * t.element_size() for t in group)
        nelem = sum(t.numel() for t in group)
        codec = bucket_codec(compression, policy, raw,
                             all(i in float_ord for i in idxs))
        if codec is not None:
            wbytes = (codec.wire_nbytes(nelem) if codec.cooperative
                      else nelem * codec.cast_dtype.itemsize
                      if codec.cast_dtype is not None else raw)
            stats.append((codec.name, raw, wbytes))
            if policy is not None:
                chunks = (_fc.plan_chunks(nelem, 4) if not codec.cooperative
                          and _fused_route(op, process_set, hier_mesh)
                          else None)
                bucket_instant(k, codec.name, len(idxs), raw, wbytes, chunks)
            if codec.cooperative:
                launder.add(k)
                flat = torch.cat([t.to(torch.float32).reshape(-1)
                                  for t in group])
                e = None if ef is None else torch.cat(
                    [ef[float_ord[i]].reshape(-1) for i in idxs])
                red = quantized_allreduce_shard(
                    flat, average=op is C.Average, wire=codec.name,
                    error_feedback=e)
                if e is not None:
                    red, err = red
                outs, off = [], 0
                for i, t in zip(idxs, group):
                    outs.append(red[off:off + t.numel()].reshape(t.shape)
                                .to(t.dtype))
                    if e is not None:
                        new_ef[float_ord[i]] = err[off:off + t.numel()] \
                            .reshape(t.shape)
                    off += t.numel()
            elif codec.cast_dtype is not None:
                red = _grouped([t.to(codec.cast_dtype) for t in group], op,
                               process_set, hier_mesh)
                outs = [r.to(t.dtype) for r, t in zip(red, group)]
            else:
                outs = list(_grouped(group, op, process_set, hier_mesh))
            results.append((idxs, outs))
            continue
        compressed, ctxs = [], []
        for t in group:
            c, ctx = compression.compress(t)
            compressed.append(c)
            ctxs.append(ctx)
        stats.append((_wire.compressor_wire(compression), raw,
                      sum(c.numel() * c.element_size() for c in compressed)))
        red = _grouped(compressed, op, process_set, hier_mesh)
        results.append((idxs, [compression.decompress(r, ctx)
                               for r, ctx in zip(red, ctxs)]))
    if not step_hooks_held():
        record_buckets(stats, policy is not None)
    if sentinel:
        # Under a cooperative compression= every bucket's inputs are
        # checked, its exact integer bucket too (the JAX package's rule).
        return results, new_ef, _sentinel_flags(
            leaves, results, process_set,
            input_buckets=True if is_cooperative(compression) else launder)
    return results, new_ef


def _flatten(tree):
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda vals: dict(zip(keys, vals))
    if isinstance(tree, (list, tuple)):
        kind = type(tree)
        return list(tree), lambda vals: kind(vals)
    return [tree], lambda vals: vals[0]


def allreduce_gradients(grads: Any, op=C.Average,
                        compression=Compression.none,
                        process_set: Optional[ProcessSet] = None,
                        fusion_threshold_bytes: Optional[int] = None,
                        bucket_order=None,
                        error_feedback_state: Optional[List[torch.Tensor]]
                        = None, sentinel: bool = False, axis_name=None):
    """Reduce a list, tuple or dict of gradients (or one tensor) across
    ranks bucket by bucket (`reduce_gradient_buckets`, `axis_name` a
    hierarchical mesh or None); returns the same structure.  `error_feedback_state` (quantized wires only; build it
    with `error_feedback_init(grads)`): each rank adds its carried
    residual before encoding and keeps its new encode errors, so the
    quantization error telescopes across steps instead of biasing each
    one; the return value is then `(reduced, new_state)`.  `sentinel=True`
    appends the cross-rank f32[B] per-bucket non-finite flags as the last
    element: `(reduced, flags)` or `(reduced, new_state, flags)`."""
    leaves, rebuild = _flatten(grads)
    if _met.enabled() and not step_hooks_held():
        _met.grad_bytes_reduced.inc(
            sum(t.numel() * t.element_size() for t in leaves))
    red = reduce_gradient_buckets(
        leaves, op=op, compression=compression, process_set=process_set,
        fusion_threshold_bytes=fusion_threshold_bytes,
        bucket_order=bucket_order, error_feedback_leaves=error_feedback_state,
        sentinel=sentinel, axis_name=axis_name)
    results, new_ef = red[0], red[1]
    out: List[Any] = [None] * len(leaves)
    for idxs, reduced in results:
        for i, r in zip(idxs, reduced):
            out[i] = r
    ret = [rebuild(out)]
    if error_feedback_state is not None:
        ret.append(new_ef)
    if sentinel:
        ret.append(red[2])
    return tuple(ret) if len(ret) > 1 else ret[0]


def error_feedback_init(grads: Any) -> List[torch.Tensor]:
    """Zero residuals for `allreduce_gradients(...,
    error_feedback_state=...)`: one f32 zero tensor per float leaf, in
    leaf order (integer leaves ride the exact wire)."""
    leaves, _ = _flatten(grads)
    return [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for t in leaves if t.dtype.is_floating_point]
