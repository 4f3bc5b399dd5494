"""The ZeRO ladder: a torch optimizer stepped on this rank's shard only.

Counterpart of `DistributedGradientTransformation(zero_stage=...)` in
`horovod_tpu/parallel/optimizer.py` (:194; the stage semantics in its
docstring, :235-276), reached as
`hvd.DistributedOptimizer(opt, named_parameters=..., zero_stage=k)`:

- Stage 1 (alias: `shard_optimizer_states`, HOROVOD_SHARD_OPTIMIZER).
  Parameters are grouped by `shard_group_partition`.  At the step each
  group's gradients are packed into a flat buffer padded to a multiple
  of n and reduce-scattered (`pipelined_psum_scatter` when
  HOROVOD_FUSED_COLLECTIVES=1), averaged, and the inner optimizer steps
  this rank's shard: a local `torch.optim` optimizer of the wrapped
  one's class and defaults over one flat tensor per group, the way
  torch's ZeroRedundancyOptimizer builds its own.  The new shards are
  allgathered back into the parameters (`pipelined_allgather_shard` when
  fused).  With `backward_passes_per_step` K > 1 the gradients
  accumulate in `p.grad` and the Kth pass scatters their mean.
- Stage 2 adds sharded accumulation: with K > 1 every pass's gradients
  are reduce-scattered at once and only the local shard accumulates
  (`p.grad` is released after each pass).
- At every stage the shards are scratch: each step copies them in from
  the parameters, and between steps only their optimizer state holds
  memory.
- Stage 3 is stage 2 with the parameters held by `zero3_placement`:
  `step()` leaves the parameters alone, releases `p.grad` once it is
  scattered, and returns the rank-identical list of updates (this rank's
  new shard minus its old one, allgathered; each leaf a view of its
  group's flat update) for `placement.apply_updates`.  Parameters bound
  to the placement are views of their group's buffer, and the step
  takes its shard as one slice of it.

The wires, as in the JAX package (:245-290, :598-790):

- An explicit cooperative `compression=` is refused: only the policy
  path carries the error feedback that keeps a lossy reduce-scatter from
  biasing every step.
- Under HOROVOD_WIRE_POLICY (compression none), each shard group's
  reduce-scatter takes the codec the policy picks for the group's raw
  bytes and dtype class.  A cast group reduce-scatters in the cast dtype;
  a cooperative one rides `quantized_reducescatter_shard` with a
  sender-side error-feedback row per group (this rank's residual over
  the whole padded group buffer, the JAX `_WireEF`), stamped with
  `wire.error_feedback_generation()` and zeroed when the generation moves
  (`wire.reset_error_feedback()`, which the elastic reset calls).
- `allgather_wire` (HOROVOD_SHARD_AG_WIRE) puts the parameter allgather
  on a wire while f32 master shards stay exact on their owner: the local
  optimizer steps the masters (kept between steps, taken from the
  parameters at the first step), each step gathers wire(master) (a cast
  wire casts it, a cooperative one encodes it at the gather; every rank,
  the owner too, reads the decoded values), and the update is
  reconstructed as wire(master) − param, so the wire's error never
  accumulates.  `master_wire_diff` is the largest |master − decoded| of
  this rank's shards after the last step (0-d tensor, None without the
  wire).

The hierarchical pair (JAX :584-595, :699-700, :807-830, :1046-1091):
with `axis_name=` a `create_hierarchical_mesh`, each group's
reduce-scatter is `hierarchical_reduce_scatter` (the ici leg at full
width, the dcn leg on `compression`'s cast wire) and the allgather
`hierarchical_all_gather`, whatever HOROVOD_HIERARCHICAL_ALLREDUCE says.
Ownership is dcn-major, and rank (d, i) of the mesh is global rank
d*n_ici + i, so each rank still owns its rank's shard.  No wire policy
and no chunked pipeline on the pair, and a cooperative allgather wire
is refused (the ring spans one set).

`early_reduction` with `backward_passes_per_step` K > 1 at stage 1
(JAX's `_no_rs` branch, :493): every pass's gradients are allreduced
(`reduce_gradient_buckets`, hierarchical under the pair and the flag)
and accumulated, and the Kth pass steps on its slice of their mean,
with no reduce-scatter.  Stages 2 and 3 scatter every pass anyway.

HOROVOD_SHARD_AG_FUSION (the tuner's `ag_fusion` knob,
`current_ag_fusion`; JAX :609, :807-830): every group's new shard is
gathered in one allgather per dtype, then split; gathers move bytes, so
the parameters are bitwise those of the per-group gathers (on a
cooperative wire the blocks then span the groups' shards).

The arithmetic follows the JAX package's order: the mean of K passes is
taken before the scatter at stage 1 and after it at stage 2; Average
divides the scattered sum by n.  So integer-valued trajectories are
bitwise equal to the JAX package's.  Contracts kept: the partition is
baked at construction and a step raises on drift (re-init after tunables
change), the global process set only, no Adasum.  A parameter without a
gradient at the step counts as a zero gradient.  Every param group must
carry the same hyperparameters.
"""

from __future__ import annotations

import inspect
from typing import List, Optional

import torch
from torch.profiler import record_function

from ..common import basics, util
from ..common.basics import ProcessSet
from ..common.exceptions import HorovodTpuError
from ..guard import sentinel as _sentinel
from ..guard.loss_scale import unscale_
from ..ops import collectives as C
from ..ops import fused_collectives as _fc
from ..ops import quantized as Q
from ..ops import wire as _wire
from ..ops.compression import Compression, is_cooperative
from ..utils.autotune import current_ag_fusion
from . import hierarchical as _hier
from .data_parallel import (active_wire_policy, bucket_codec, check_axis,
                            reduce_gradient_buckets, shard_group_partition)
from .zero3 import group_buffer, group_slice, shard_groups, unpack


def optimizer_state_bytes(optimizer) -> int:
    """This rank's resident bytes of the inner optimizer state (the ZeRO-1
    denominator).  A sharded optimizer holds only its shard's state; a
    plain or stage-0 optimizer counts all of it."""
    inner = getattr(optimizer, "_local", None) or getattr(
        optimizer, "_opt", optimizer)
    return sum(v.numel() * v.element_size()
               for st in inner.state.values() for v in st.values()
               if isinstance(v, torch.Tensor))


def grad_accum_bytes(optimizer) -> int:
    """This rank's resident bytes of the gradient accumulator (the ZeRO-2
    denominator): the local shard rows under stage >= 2 with
    `backward_passes_per_step` > 1, else the parameter-shaped `p.grad`
    accumulator."""
    accum = getattr(optimizer, "_accum", None)
    if accum is not None:
        return sum(a.numel() * a.element_size() for a in accum)
    opt = getattr(optimizer, "_opt", optimizer)
    return sum(p.numel() * p.element_size()
               for g in opt.param_groups for p in g["params"])


def _hyper(group: dict) -> dict:
    return {k: v for k, v in group.items() if k != "params"}


def _local_optimizer(optimizer: torch.optim.Optimizer,
                     shards: List[torch.Tensor]) -> torch.optim.Optimizer:
    """An optimizer of `optimizer`'s class over `shards`, built from its
    defaults (those its constructor takes: AdamW's defaults also carry
    Adam's `decoupled_weight_decay`), then given its param group's
    hyperparameters."""
    cls = type(optimizer)
    sig = inspect.signature(cls.__init__).parameters
    kw = {k: v for k, v in optimizer.defaults.items() if k in sig}
    local = cls(shards, **kw)
    local.param_groups[0].update(_hyper(optimizer.param_groups[0]))
    return local


class _ShardedOptimizer:
    """`DistributedOptimizer` at zero_stage 1, 2 or 3 (see the module
    docstring)."""

    def __init__(self, optimizer: torch.optim.Optimizer, zero_stage: int,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1, op=C.Average,
                 process_set: Optional[ProcessSet] = None,
                 fusion_threshold_bytes: Optional[int] = None,
                 bucket_order=None, allgather_wire: Optional[str] = None,
                 guard=None, axis_name=None, early_reduction: bool = False):
        if op is not C.Average and op is not C.Sum:
            raise ValueError(
                f"zero_stage={zero_stage} supports op=Average/Sum, got {op}: "
                "Adasum combines post-update deltas, which have no "
                "reduce-scatter form")
        if process_set is not None and process_set.process_set_id != 0:
            raise ValueError(
                "zero_stage >= 1 requires the global process set: subset "
                "reduce-scatter would need group-aware shard ownership")
        if is_cooperative(compression):
            raise ValueError(
                f"Compression.{compression.wire} has no reduce-scatter "
                "form here (only the HOROVOD_WIRE_POLICY path carries "
                "the sender-side error-feedback residual that keeps "
                "the lossy ring from biasing every step); use "
                "Compression.fp16/bf16, or HOROVOD_WIRE_POLICY with "
                "zero_stage >= 1")
        hypers = [_hyper(g) for g in optimizer.param_groups]
        if any(h != hypers[0] for h in hypers[1:]):
            raise ValueError(
                "zero_stage >= 1 steps one local optimizer over flat "
                "shards, so every param group must carry the same "
                f"hyperparameters; got {hypers}")
        self._mesh = check_axis(axis_name, process_set)
        self._opt = optimizer
        self.zero_stage = zero_stage
        self._compression = compression
        self._op = op
        self._bpps = max(1, backward_passes_per_step)
        # Stage 1 under early reduction allreduces every pass and never
        # reduce-scatters (JAX `_no_rs`).
        self._no_rs = (early_reduction and self._bpps > 1
                       and zero_stage < 2)
        self._er_accum: Optional[List[torch.Tensor]] = None
        self._pass_count = 0
        self._fusion_threshold_bytes = fusion_threshold_bytes
        self._bucket_order = bucket_order
        self._ps = basics.global_process_set()
        self.n = self._ps.size()
        self.rank = self._ps.rank()
        self._params = [p for g in optimizer.param_groups
                        for p in g["params"]]
        self._groups = shard_groups(
            self._params, self.n, compression=compression,
            fusion_threshold_bytes=fusion_threshold_bytes,
            bucket_order=bucket_order)
        if allgather_wire is None:
            allgather_wire = util.shard_ag_wire()
        self._ag_codec = _wire.get_codec(allgather_wire)
        if self._ag_codec.cooperative and self._mesh is not None:
            raise ValueError(
                f"allgather_wire={self._ag_codec.name!r} rides the ring "
                "payload gather, which spans ONE named axis — with a "
                "hierarchical 2-tuple axis_name use a cast wire "
                f"({', '.join(_wire.cast_wire_names())}) instead")
        self.allgather_wire = (None if self._ag_codec.exact
                               else self._ag_codec.name)
        self.master_wire_diff: Optional[torch.Tensor] = None
        # The hierarchical scatter's dcn wire: the compressor's cast.
        rs = _wire.get_codec(_wire.compressor_wire(compression))
        self._rs_wire = None if rs.exact else rs.name
        # The policy engages only on a flat reduce-scatter that runs.
        policy = (None if self._mesh is not None or self._no_rs
                  else active_wire_policy(compression, process_set))
        self._rs_codecs = [bucket_codec(compression, policy,
                                        sum(g.sizes) * g.dtype.itemsize,
                                        g.dtype.is_floating_point)
                           for g in self._groups]
        dev = self._params[0].device
        # Sender-side error-feedback rows of the cooperative groups.
        self._ef_rows = [torch.zeros(g.padded, dtype=torch.float32,
                                     device=dev)
                         if c is not None and c.cooperative else None
                         for g, c in zip(self._groups, self._rs_codecs)]
        self._ef_gen = _wire.error_feedback_generation()
        # One flat shard per group: the local optimizer's parameters.
        # Each step copies them in from the parameters (`_apply`), so
        # between steps they hold no storage; their state stays.  Under
        # an allgather wire they are the f32 masters and stay.
        self._shards = [torch.zeros(
            g.shard_sz, dtype=torch.float32 if self.allgather_wire
            else g.dtype, device=dev) for g in self._groups]
        self._masters_ready = False
        self._local = _local_optimizer(optimizer, self._shards)
        self._accum = ([torch.zeros_like(s) for s in self._shards]
                       if zero_stage >= 2 and self._bpps > 1 else None)
        if not self.allgather_wire:
            self._release_shards()
        self._scaler = guard
        self.guard_state = (guard.init(len(self._groups), device=dev)
                            if guard is not None else None)

    def _release_shards(self) -> None:
        for sh in self._shards:
            sh.untyped_storage().resize_(0)

    def _check_drift(self) -> None:
        live = shard_group_partition(
            self._params, compression=self._compression,
            fusion_threshold_bytes=self._fusion_threshold_bytes,
            bucket_order=self._bucket_order)
        if [list(g.idxs) for g in self._groups] != live:
            raise ValueError(
                f"zero_stage={self.zero_stage} partition changed since the "
                "optimizer was built (fusion threshold / bucket order "
                "moved?) — re-init the optimizer after tunables change")

    # -- the data path -----------------------------------------------------

    def _scatter(self, scale: Optional[float]) -> List[torch.Tensor]:
        """Reduce-scatter every group's gradients (all in flight before
        the first is finished, the ring groups excepted: a ring runs
        when it is reached); returns this rank's averaged shards.  Each
        group's gradients are packed by one `torch.cat`, the pad
        appended.  Under the guard, `self._in_flags` gets each group's
        input flag (None unless its wire is a quantizing one, whose
        integer cast can launder a NaN; the other wires carry it into
        some rank's shard)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        fused = _fc.fused_enabled() and self._mesh is None
        if self._ef_gen != _wire.error_feedback_generation():
            # reset_error_feedback() ran: the residuals belong to
            # gradients from before it.
            for row in self._ef_rows:
                if row is not None:
                    row.zero_()
            self._ef_gen = _wire.error_feedback_generation()
        average = self._op is C.Average
        started = []
        self._in_flags = []
        for gi, (g, codec) in enumerate(zip(self._groups, self._rs_codecs)):
            parts = [grads[i].reshape(-1) for i in g.idxs]
            pad = g.padded - sum(g.sizes)
            if pad:
                parts.append(parts[0].new_zeros(pad))
            flat = torch.cat(parts)
            if scale is not None:
                flat = (flat * scale).to(flat.dtype)
            coop = codec is not None and codec.cooperative
            self._in_flags.append(_sentinel.local_nonfinite([flat])
                                  if self._scaler is not None and coop
                                  else None)
            if self._mesh is not None:
                started.append((_hier.reduce_scatter_start(
                    flat, self._mesh, dcn_wire=self._rs_wire), average,
                    lambda t: t))
                continue
            if coop:
                red, self._ef_rows[gi] = Q.quantized_reducescatter_shard(
                    flat, self._ps, average=average, wire=codec.name,
                    error_feedback=self._ef_rows[gi])
                red = red.to(g.dtype)
                started.append((lambda red=red: red, False,
                                lambda t: t))
                continue
            if codec is not None and codec.cast_dtype is not None:
                c = flat.to(codec.cast_dtype)
                back = (lambda t, dt=g.dtype: t.to(dt))
            else:
                c, ctx = self._compression.compress(flat)
                back = (lambda t, ctx=ctx:
                        self._compression.decompress(t, ctx))
            if fused:
                red = _fc.pipelined_psum_scatter(c, self._ps)
                started.append((lambda red=red: red, average, back))
            else:
                h = C._reducescatter_start(c, C.Sum, self._ps)
                started.append((h.wait, average, back))
        out = []
        for wait, divide, back in started:
            red = wait()
            if divide:
                red = (red.float() / self.n).to(red.dtype)
            out.append(back(red))
        return out

    def _gather(self, sends: List[torch.Tensor]) -> List[torch.Tensor]:
        """Allgather one flat shard per group on the allgather wire;
        returns each group's rank-major flat buffer (decoded, in the
        send's dtype).  Under the tuner's `ag_fusion` knob, one gather a
        send dtype of the groups' shards concatenated, each group's
        buffer its column band of the (n, total) result."""
        if not current_ag_fusion():
            return self._gather_each(sends)
        out: List[Optional[torch.Tensor]] = [None] * len(sends)
        by_dt: dict = {}
        for k, sh in enumerate(sends):
            by_dt.setdefault(sh.dtype, []).append(k)
        for ks in by_dt.values():
            cat = torch.cat([sends[k].reshape(-1) for k in ks])
            (full,) = self._gather_each([cat])
            stacked = full.reshape(self.n, cat.numel())
            off = 0
            for k in ks:
                w = sends[k].numel()
                out[k] = stacked[:, off:off + w].reshape(-1)
                off += w
        return out

    def _gather_each(self, sends: List[torch.Tensor]) -> List[torch.Tensor]:
        codec = self._ag_codec
        if self._mesh is not None:
            started = [_hier.all_gather_start(s, self._mesh) for s in sends]
            return [finish() for finish in started]
        if codec.cooperative:
            if _fc.fused_enabled():
                return [_fc.pipelined_allgather_shard(
                    s, self._ps, wire=codec.name) for s in sends]
            started = [Q.allgather_start(s, self._ps, codec) for s in sends]
            return [wait().reshape(-1) for wait in started]
        if _fc.fused_enabled():
            return [_fc.pipelined_allgather_shard(s, self._ps)
                    for s in sends]
        started = [C._allgather_start(s, self._ps) for s in sends]
        return [h.wait() for h in started]

    def _apply(self, g_shards: List[torch.Tensor]):
        r = self.rank
        wired = self.allgather_wire is not None
        for g, sh, gs in zip(self._groups, self._shards, g_shards):
            lo, hi = r * g.shard_sz, (r + 1) * g.shard_sz
            if not wired or not self._masters_ready:
                if not wired:
                    sh.untyped_storage().resize_(
                        sh.numel() * sh.element_size())
                # Parameters bound to a zero3_placement are views of
                # their group's buffer: the shard is one slice of it.
                flat = group_buffer(self._params, g)
                sh.copy_(flat[lo:hi] if flat is not None else
                         group_slice(self._params, g.idxs, g.dtype, lo, hi))
            sh.grad = gs.to(sh.dtype)
        self._masters_ready = wired
        old = ([sh.clone() for sh in self._shards]
               if self.zero_stage == 3 and not wired else None)
        self._local.param_groups[0].update(_hyper(self._opt.param_groups[0]))
        with record_function("hvd.zero.local_step"):
            self._local.step()
        for sh in self._shards:
            sh.grad = None
        if wired:
            return self._apply_wired()
        if self.zero_stage < 3:
            with record_function("hvd.zero.allgather"):
                fulls = self._gather(self._shards)
            self._release_shards()
            for g, full in zip(self._groups, fulls):
                for i, t in unpack(g, full):
                    self._params[i].copy_(t)
            return None
        with record_function("hvd.zero.allgather"):
            fulls = self._gather([sh - o for sh, o in zip(self._shards,
                                                          old)])
        self._release_shards()
        updates: List[Optional[torch.Tensor]] = [None] * len(self._params)
        for g, full in zip(self._groups, fulls):
            for i, t in unpack(g, full):
                updates[i] = t.to(self._params[i].dtype)
        return updates

    def _apply_wired(self):
        """The allgather of wire(master): the parameters take
        param + (wire(master) - param), the JAX package's update (stage 3
        returns the updates instead)."""
        cast = self._ag_codec.cast_dtype
        sends = [sh.to(cast) if cast is not None else sh
                 for sh in self._shards]
        with record_function("hvd.zero.allgather"):
            fulls = self._gather(sends)
        r = self.rank
        self.master_wire_diff = torch.stack([
            (sh - full[r * g.shard_sz:(r + 1) * g.shard_sz].float())
            .abs().max() for g, sh, full in zip(self._groups, self._shards,
                                                fulls)]).max()
        updates: List[Optional[torch.Tensor]] = [None] * len(self._params)
        for g, full in zip(self._groups, fulls):
            for i, t in unpack(g, full):
                p = self._params[i]
                updates[i] = t.to(p.dtype) - p
        if self.zero_stage == 3:
            return updates
        for p, u in zip(self._params, updates):
            p.add_(u)
        return None

    def _early_pass(self, sync: bool) -> Optional[List[torch.Tensor]]:
        """Early reduction at stage 1: allreduce this pass's gradients
        (their flags, under the guard, fold into `pending_flag`), add
        them into the full-size accumulator and release `p.grad`.  On
        the Kth pass returns this rank's slice of each group's mean
        (accumulator times 1/K), else None."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        with record_function("hvd.zero.early_reduce"):
            red = reduce_gradient_buckets(
                grads, op=self._op, compression=self._compression,
                fusion_threshold_bytes=self._fusion_threshold_bytes,
                bucket_order=self._bucket_order,
                sentinel=self._scaler is not None, axis_name=self._mesh)
        if self._scaler is not None:
            self.guard_state = self._scaler.accumulate(self.guard_state,
                                                       red[2])
        if self._er_accum is None:
            self._er_accum = [torch.zeros_like(g) for g in grads]
        for idxs, outs in red[0]:
            for i, o in zip(idxs, outs):
                self._er_accum[i].add_(o)
        for p in self._params:
            p.grad = None
        if not sync:
            return None
        means = [(a * (1.0 / self._bpps)).to(a.dtype)
                 for a in self._er_accum]
        self._er_accum = None
        lo = self.rank
        return [group_slice(means, g.idxs, g.dtype, lo * g.shard_sz,
                            (lo + 1) * g.shard_sz) for g in self._groups]

    # -- the guard (the JAX package's `_gate`, :965-990) ----------------

    def _group_flags(self, g_shards: List[torch.Tensor],
                     in_flags) -> torch.Tensor:
        """Each group's flag, OR-ed across ranks (one Max allreduce): its
        scattered shard (each rank scans its own) and its input flag."""
        flags = []
        for gs, fin in zip(g_shards, in_flags):
            f = _sentinel.local_nonfinite([gs])
            flags.append(f if fin is None else torch.maximum(f, fin))
        return _sentinel.crossrank_or(torch.stack(flags), self._ps)

    def _gate(self, g_shards: List[torch.Tensor], in_flags) -> bool:
        """Flag, unscale (in place), advance the schedule; on a flagged step zero the error-feedback rows (a
        residual can carry the very non-finites the sentinel caught).
        Returns whether the local step runs (one host read)."""
        gs = self.guard_state
        flags = self._group_flags(g_shards, in_flags)
        bad = bool(torch.maximum(flags.max(), gs.pending_flag) > 0)
        unscale_(self._scaler, gs, g_shards)
        self.guard_state = self._scaler.update(gs, flags)
        if bad:
            for row in self._ef_rows:
                if row is not None:
                    row.zero_()
        return not bad

    def _skipped(self):
        """A flagged step's result: the parameters stay; stage 3 returns
        zero updates (views of one zero buffer per group, as `_apply`'s
        are)."""
        if self.zero_stage < 3:
            return None
        updates: List[Optional[torch.Tensor]] = [None] * len(self._params)
        for g in self._groups:
            full = torch.zeros(g.padded, dtype=g.dtype,
                               device=self._shards[0].device)
            for i, t in unpack(g, full):
                updates[i] = t.to(self._params[i].dtype)
        return updates

    @torch.no_grad()
    def step(self, closure=None):
        """One pass.  On every `backward_passes_per_step`-th pass the
        sharded step runs; at stage 3 it returns the updates for
        `placement.apply_updates`, else None."""
        if closure is not None:
            raise HorovodTpuError(
                "zero_stage >= 1 takes no closure: run forward and backward "
                "before step()")
        self._pass_count += 1
        sync = self._pass_count % self._bpps == 0
        self._check_drift()
        if self._no_rs:
            g_shards = self._early_pass(sync)
            if g_shards is None:
                return None
            in_flags = [None] * len(g_shards)
        elif self._accum is not None:
            # Stage 2/3 accumulation: scatter this pass now, keep only
            # the local shard, release the full-size gradients.
            with record_function("hvd.zero.reduce_scatter"):
                shards = self._scatter(None)
            if self._scaler is not None:
                # Each pass's flags fold into pending_flag now (a
                # poisoned pass is already in the accumulator) and gate
                # the Kth pass's step.
                self.guard_state = self._scaler.accumulate(
                    self.guard_state,
                    self._group_flags(shards, self._in_flags))
            for a, s in zip(self._accum, shards):
                a.add_(s)
            for p in self._params:
                p.grad = None
            if not sync:
                return None
            scale = 1.0 / self._bpps
            g_shards = [(a * scale).to(a.dtype) for a in self._accum]
            for a in self._accum:
                a.zero_()
            in_flags = [None] * len(g_shards)
        else:
            if not sync:
                return None  # gradients accumulate in p.grad
            with record_function("hvd.zero.reduce_scatter"):
                g_shards = self._scatter(
                    1.0 / self._bpps if self._bpps > 1 else None)
            in_flags = self._in_flags
            if self.zero_stage == 3:
                # Scattered: only the shards of the gradients stay.
                for p in self._params:
                    p.grad = None
        if self._scaler is not None and not self._gate(g_shards, in_flags):
            return self._skipped()  # flagged: skipped on every rank alike
        return self._apply(g_shards)

    def zero_grad(self, *a, **kw):
        return self._opt.zero_grad(*a, **kw)

    def synchronize(self) -> None:
        """No-op for API compatibility: the collectives run in step()."""

    def __getattr__(self, item):
        return getattr(self._opt, item)
