"""Torch elastic state and the `hvd.elastic` namespace (counterpart of
`horovod_tpu/torch/elastic.py`; reference: horovod/torch/elastic/
state.py `TorchState`).

    state = hvd.elastic.TorchState(model, optimizer, epoch=0,
                                   batch_idx=0, sampler=sampler)

    @hvd.elastic.run
    def train(state):
        ...
        state.commit()
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Dict, List, Optional

import torch

from ..elastic import (  # noqa: F401  (the hvd.elastic surface)
    ElasticSampler,
    ObjectState,
    State,
    _sync_root,
    notify_hosts_updated,
    run,
)
from ..common import basics, util
from ..common.exceptions import HorovodInternalError, ReshardError
from ..ops import functions as F
from . import broadcast_object  # noqa: F401
from . import broadcast_optimizer_state, broadcast_parameters

logger = logging.getLogger("horovod_tpu_torch.elastic")


def _to_host(tree: Any) -> Any:
    """A copy of a state dict with every tensor in host memory, so that
    no later in-place step on the card can reach the snapshot (the JAX
    `TpuState._to_host`)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return type(tree)((k, _to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return copy.deepcopy(tree)


class TorchState(ObjectState):
    """Elastic state of a torch model, its optimizer and scalars.

    `save` copies `model.state_dict()` (buffers included: batch-norm
    statistics) and `optimizer.state_dict()` to host memory; `restore`
    loads them back in place; `sync` broadcasts them from rank 0, or
    under the driver from the lowest rank that holds the job's state
    (`elastic._sync_root`).  An `ElasticSampler` among the scalars is
    kept in place: its epoch and indices are saved and restored, and
    `sync` takes the root's epoch and length (a worker that joined a
    running job has neither), then the
    union of every rank's processed indices, and shards the rest again
    (`ElasticSampler.reset`), as upstream's sampler handler does.

    `on_reset` also drops the `DistributedOptimizer` wrapper's state of
    the failed step (`reset_step_state`): its open bucket, the handles
    of the buckets already in flight, the gradients marked as enqueued,
    and a partial accumulation of `backward_passes_per_step` (a ZeRO
    optimizer's: its shard accumulator and pass count).  That state
    belongs to the step the restore rolled back.  The JAX shim has no
    such state: its work in flight is XLA programs.  A ZeRO optimizer
    (`zero_stage` >= 1) keeps its state in shards: hold it in
    `ShardedTorchState`, which reshards it when the world size changes.
    """

    def __init__(self, model: torch.nn.Module = None,
                 optimizer: torch.optim.Optimizer = None, **kwargs):
        self.model = model
        self.optimizer = optimizer
        self._samplers = [k for k, v in kwargs.items()
                          if isinstance(v, ElasticSampler)]
        super().__init__(**kwargs)

    def _scalars(self):
        return [k for k in self._known if k not in self._samplers]

    def _snapshot(self) -> Dict[str, Any]:
        snap = {k: copy.deepcopy(getattr(self, k)) for k in self._scalars()}
        for k in self._samplers:
            s = getattr(self, k)
            snap[k] = (s.epoch, list(s.processed_indices),
                       list(s.local_indices))
        if self.model is not None:
            snap["__model__"] = _to_host(self.model.state_dict())
        if self.optimizer is not None:
            snap["__optimizer__"] = _to_host(self.optimizer.state_dict())
        return snap

    def _restore_from(self, saved: Dict[str, Any]) -> None:
        if self.model is not None:
            self.model.load_state_dict(saved["__model__"])
        if self.optimizer is not None:
            # load_state_dict copies, so the snapshot stays as it is.
            self.optimizer.load_state_dict(saved["__optimizer__"])
        for k in self._samplers:
            s = getattr(self, k)
            s.epoch, processed, local = saved[k]
            s.processed_indices, s.local_indices = list(processed), \
                list(local)
        for k in self._scalars():
            setattr(self, k, copy.deepcopy(saved[k]))

    def on_reset(self) -> None:
        reset = getattr(self.optimizer, "reset_step_state", None)
        if reset is not None:
            reset()
        super().on_reset()

    def sync(self) -> None:
        root = _sync_root(self.holds_state)
        if self.model is not None:
            broadcast_parameters(self.model.state_dict(), root_rank=root)
        if self.optimizer is not None:
            broadcast_optimizer_state(self.optimizer, root_rank=root)
        if self._samplers:
            samplers = [getattr(self, k) for k in self._samplers]
            roots = broadcast_object([(s.epoch, s.num_samples)
                                      for s in samplers], root_rank=root)
            for s, (epoch, num_samples) in zip(samplers, roots):
                s.epoch, s.num_samples = epoch, num_samples
                s.reset()
        self._sync_scalars(self._scalars(), root)
        self.holds_state = True
        self.save()


class ShardedTorchState(TorchState):
    """`TorchState` for ZeRO (`DistributedOptimizer(zero_stage=1..3)`)
    with live resharding (counterpart of the JAX package's
    `ShardedTpuState`).  On a membership change the old generation
    publishes this rank's shards (the local optimizer's per-element
    state and scalars, f32 masters, the stage-2 accumulator, the wire's
    error-feedback rows, the pass count and, at stage 3, the placement's
    parameter rows) through the launch's rendezvous KV in chunks under
    HOROVOD_RESHARD_PEAK_BYTES (`on_hosts_updated`, before the
    teardown), and `sync` on the new generation fetches exactly the
    shards each new rank owns: no checkpoint restore, never a whole
    buffer on the transport.  The result is checked by each chunk's
    sha256, each stream's bit-pattern digest and the verdict barrier,
    then by the guard's cross-replica parameter digest
    (`_verify_or_raise`) before the generation commits.

    Any failure (a dead peer, a corrupt chunk, a digest mismatch, a
    staging peak over the ceiling, or no publish: a crash shrink, whose
    old generation never ran `on_hosts_updated`) takes the restore path:
    the `checkpoint_manager`'s latest step when it holds one (written by
    `checkpoint(step)`), else every rank's committed shards gathered
    from the ranks that hold state (which must be every old rank: a
    crash shrink without a checkpoint raises HorovodInternalError),
    then a local restack to the new world size
    (`reshard.rank_streams_from_merged`), bitwise the live path.  The
    model's replicated parameters (stages 1 and 2) and the scalars are
    broadcast from `elastic._sync_root`, as `TorchState`'s.

    The optimizer and the placement are bound to a world size and a
    process set, so after a reset `sync` builds them again
    (`_ShardedOptimizer.rebuilt`, `zero3_placement` over the same
    parameters with the same tunables) and fills them: read
    `state.optimizer`, `state.placement` and `state.rows` after it.
    `transport` defaults to the launch's KV (`KVTransport.from_env`),
    none outside a launch.  `last_reshard` is the last live reshard's
    `ReshardReport` (None after the restore path) and `last_sync_path`
    "reshard" or "restore"."""

    def __init__(self, model: torch.nn.Module = None, optimizer=None, *,
                 placement=None, rows=None, checkpoint_manager=None,
                 transport=None, reshard_namespace: str = "elastic",
                 chunk_bytes: Optional[int] = None,
                 peak_bytes: Optional[int] = None,
                 reshard_timeout: Optional[float] = None, **kwargs):
        from ..parallel import reshard as rs
        rs._sharded(optimizer)
        if optimizer.zero_stage == 3 and (placement is None or rows is None):
            raise ValueError("zero_stage=3 needs the placement and its rows")
        self.placement = placement
        self.rows = None if rows is None else tuple(rows)
        self.checkpoint_manager = checkpoint_manager
        self._transport = transport
        self._ns = reshard_namespace.rstrip("/")
        self._chunk_bytes = chunk_bytes
        self._peak_bytes = peak_bytes
        self._reshard_timeout = reshard_timeout
        self._published = 0      # the last reshard epoch this rank published
        self._consumed = 0       # the last epoch a sync of this rank took
        self.last_reshard = None
        self.last_sync_path: Optional[str] = None
        super().__init__(model=model, optimizer=optimizer, **kwargs)

    # -- snapshot --------------------------------------------------------
    def _model_state(self) -> Dict[str, Any]:
        """The model's state outside the shards: its state dict at stages
        1-2, its buffers at stage 3 (the parameters live in the rows)."""
        if self.placement is None:
            return self.model.state_dict()
        return dict(self.model.named_buffers())

    def _snapshot(self) -> Dict[str, Any]:
        from ..parallel import reshard as rs
        model, opt = self.model, self.optimizer
        self.model = self.optimizer = None
        try:
            snap = super()._snapshot()
        finally:
            self.model, self.optimizer = model, opt
        if model is not None:
            snap["__model__"] = _to_host(self._model_state())
        specs, data = rs.opt_state_streams(opt, self.rows)
        snap["__zero__"] = {"n": opt.n, "rank": opt.rank, "specs": specs,
                            "data": {k: v.copy() for k, v in data.items()}}
        return snap

    def _restore_from(self, saved: Dict[str, Any]) -> None:
        model, opt = self.model, self.optimizer
        self.model = self.optimizer = None
        try:
            super()._restore_from(saved)
        finally:
            self.model, self.optimizer = model, opt
        if model is not None:
            model.load_state_dict(saved["__model__"], strict=False)
        z = saved["__zero__"]
        if (z["n"], z["rank"]) != (opt.n, opt.rank):
            raise HorovodInternalError(
                f"a snapshot of rank {z['rank']} of {z['n']} cannot restore "
                f"rank {opt.rank} of {opt.n}: sync reshards it")
        self._install(z["specs"], z["data"], rebuild=False)

    # -- plumbing --------------------------------------------------------
    def _reshard_kw(self) -> Dict[str, Any]:
        """The executor's chunk and staging ceiling."""
        return {"chunk_bytes": self._chunk_bytes,
                "peak_bytes": self._peak_bytes}

    def _get_transport(self):
        if self._transport is None and util.getenv("RENDEZVOUS_ADDR"):
            from ..parallel import reshard as rs
            self._transport = rs.KVTransport.from_env(self._ns)
        return self._transport

    def _install(self, specs, streams, rebuild: bool = True) -> None:
        """Fill the optimizer (built again for the current world and
        process set when it is stale) and, at stage 3, the placement's
        rows from this rank's streams."""
        from ..parallel import reshard as rs
        from ..parallel.zero3 import _leaves, zero3_placement

        opt = self.optimizer
        if rebuild and (opt._ps is not basics.global_process_set()):
            opt = self.optimizer = opt.rebuilt()
            if self.placement is not None:
                old = self.placement
                leaves = _leaves(self.model.parameters())
                for p in leaves:
                    p.__class__ = torch.nn.Parameter
                self.placement = zero3_placement(
                    leaves, compression=old._compression,
                    fusion_threshold_bytes=old._fusion_threshold_bytes,
                    bucket_order=old._bucket_order,
                    gather_wire=old._codec.name)
                self.placement.bind(leaves)
        rows = rs.streams_to_opt_state(opt, specs, streams)
        if self.placement is not None:
            self.rows = rows

    def _verify_or_raise(self) -> None:
        """The gate after a reshard: the guard's cross-replica parameter
        digest over the new world (stage 3 gathers the rows for it).  A
        mismatch refuses to commit the generation."""
        if basics.size() <= 1:
            return
        from ..guard import digest as _digest
        if self.placement is not None:
            with torch.no_grad():
                params = self.placement.gather(self.rows)
            d = _digest.param_digests(list(params))
            self.placement.release()
        else:
            d = _digest.param_digests(list(self.model.parameters()))
        bucket = _digest.check_replica_divergence(d)
        if bucket is not None:
            raise ReshardError(
                f"post-reshard digest mismatch in bucket {bucket} — "
                "refusing to commit the resharded generation")

    def _sync_replicated(self, root: int) -> None:
        """The model's state outside the shards, and the scalars and
        samplers (`TorchState.sync`'s tail), from `root`."""
        if self.model is not None:
            state = self._model_state()
            if state:
                broadcast_parameters(state, root_rank=root)
        if self._samplers:
            samplers = [getattr(self, k) for k in self._samplers]
            roots = broadcast_object([(s.epoch, s.num_samples)
                                      for s in samplers], root_rank=root)
            for smp, (epoch, num_samples) in zip(samplers, roots):
                smp.epoch, smp.num_samples = epoch, num_samples
                smp.reset()
        self._sync_scalars(self._scalars(), root)

    # -- full state (checkpoints) -----------------------------------------
    def full_state(self) -> Dict[str, Any]:
        """The whole job's state at the last commit, on every rank (a
        collective: one `allgather_object` of every rank's shards): the
        plan's metadata, every stream merged into its whole buffer, the
        model's replicated state and the scalars.  What `checkpoint`
        writes and the restore path reads."""
        from ..parallel import reshard as rs
        z = self._saved["__zero__"]
        per_rank = F.allgather_object(z["data"])
        return {"meta": rs.plan_meta_json(z["specs"], z["n"]),
                "streams": rs.merge_rank_streams(z["specs"], per_rank,
                                                 z["n"]),
                "model": self._saved.get("__model__"),
                "scalars": {k: self._saved[k] for k in self._scalars()}}

    def checkpoint(self, step: int) -> bool:
        """Write `full_state()` at `step` through the checkpoint manager
        (every rank calls it; rank 0 writes)."""
        if self.checkpoint_manager is None:
            raise ValueError("checkpoint() needs a checkpoint_manager")
        return self.checkpoint_manager.save(step, self.full_state())

    # -- old generation: publish before the teardown -----------------------
    def on_hosts_updated(self) -> None:
        t = self._get_transport()
        if t is None or not basics.is_initialized():
            return
        try:
            self._publish_for_reshard(t)
        except Exception as e:  # noqa: BLE001 — publishing is best effort
            logger.warning(
                "reshard publish failed (%s: %s) — the next generation "
                "will take the restore path", type(e).__name__, e)

    def _publish_for_reshard(self, t) -> None:
        from ..parallel import reshard as rs
        z = self._saved["__zero__"]
        self._published = max(self._published, self._consumed) + 1
        tag = f"g{self._published}"
        t.put(f"{tag}/meta", rs.plan_meta_json(z["specs"], z["n"]))
        t.put("epoch", str(self._published))
        rs.reshard_streams(
            z["specs"], z["data"], z["n"], z["n"], z["rank"], None, t,
            tag=tag, timeout=self._reshard_timeout,
            wire=util.getenv("RESHARD_WIRE"), **self._reshard_kw())
        logger.info("reshard epoch %d: published %d stream(s) as old rank "
                    "%d/%d", self._published, len(z["specs"]), z["rank"],
                    z["n"])

    # -- new generation: fetch instead of restoring -------------------------
    def sync(self) -> None:
        t = self._get_transport()
        if t is not None and basics.is_initialized():
            try:
                self._reshard_sync(t)
                return
            except ReshardError as e:
                logger.warning("live reshard failed (%s) — taking the "
                               "restore path", e)
        self._fallback_sync()

    def _reshard_sync(self, t) -> None:
        from ..parallel import reshard as rs
        n_new, new_rank = basics.size(), basics.rank()
        epoch_s = t.get("epoch")
        epoch = int(epoch_s) if epoch_s is not None else 0
        # One decision for every rank: a joiner has consumed nothing, a
        # survivor the epochs before the one it just published.
        consumed = max(F.allgather_object(self._consumed))
        if epoch <= consumed:
            raise ReshardError(
                "no published reshard epoch (a crash shrink, or the old "
                "generation never ran on_hosts_updated)")
        # Taken now, on every rank alike: a failed fetch of this epoch is
        # not tried again by a later sync.
        self._consumed = epoch
        tag = f"g{epoch}"
        timeout = (rs.default_timeout() if self._reshard_timeout is None
                   else self._reshard_timeout)
        specs, n_old = rs.plan_meta_parse(
            t.wait(f"{tag}/meta", timeout=timeout))
        streams, report = rs.reshard_streams(
            specs, None, n_old, n_new, None, new_rank, t, tag=tag,
            timeout=timeout, **self._reshard_kw())
        self._install(specs, streams)
        root = _sync_root(self.holds_state)
        self._sync_replicated(root)
        self._verify_or_raise()
        if new_rank == 0:
            rs.cleanup(t, tag)
        self.last_reshard, self.last_sync_path = report, "reshard"
        self.holds_state = True
        self.save()
        logger.info(
            "reshard epoch %d: synced as new rank %d/%d from old world %d "
            "(%d bytes moved, staging peak %d, %.1f ms), no checkpoint "
            "restore", epoch, new_rank, n_new, n_old, report.bytes_moved,
            report.peak_bytes, report.wall_ms)

    # -- the restore path --------------------------------------------------
    def _fallback_sync(self) -> None:
        from ..parallel import reshard as rs
        n_new, new_rank = basics.size(), basics.rank()
        root = _sync_root(self.holds_state)
        mine = None
        if self.checkpoint_manager is not None and \
                self.checkpoint_manager.latest_step() is not None:
            blob = self.checkpoint_manager.restore_latest()
            specs, _ = rs.plan_meta_parse(blob["meta"])
            mine = rs.rank_streams_from_merged(specs, blob["streams"], n_new,
                                               new_rank)
            if self.model is not None and blob.get("model"):
                self.model.load_state_dict(blob["model"], strict=False)
            for k, v in blob.get("scalars", {}).items():
                if k in self._scalars():
                    setattr(self, k, v)
            logger.warning("reshard fallback: restored checkpoint step %s",
                           self.checkpoint_manager.latest_step())
        else:
            z = self._saved["__zero__"] if self.holds_state else None
            held = F.allgather_object(
                None if z is None else (z["n"], z["rank"]))
            olds = [h for h in held if h is not None]
            n_olds = {n for n, _ in olds}
            if len(n_olds) != 1:
                raise HorovodInternalError(
                    f"no rank holds the job's state, or ranks hold states "
                    f"of different worlds {sorted(n_olds)}")
            n_old = n_olds.pop()
            if held == [(n_new, r) for r in range(n_new)]:
                specs, mine = z["specs"], z["data"]   # the same world
            else:
                if sorted(r for _, r in olds) != list(range(n_old)):
                    raise HorovodInternalError(
                        f"the shards of old ranks "
                        f"{sorted(set(range(n_old)) - {r for _, r in olds})}"
                        f" of {n_old} are gone (a crash shrink) and no "
                        "checkpoint manager holds a step")
                gathered = F.allgather_object(
                    None if z is None else (z["rank"], z["specs"],
                                            z["data"]))
                per_old: List[Any] = [None] * n_old
                for g in gathered:
                    if g is not None:
                        per_old[g[0]] = g[2]
                        specs = g[1]
                merged = rs.merge_rank_streams(specs, per_old, n_old)
                mine = rs.rank_streams_from_merged(specs, merged, n_new,
                                                   new_rank)
        self._install(specs, mine)
        self._sync_replicated(root)
        self._verify_or_raise()
        self.last_reshard, self.last_sync_path = None, "restore"
        self.holds_state = True
        self.save()


__all__ = ["ElasticSampler", "ObjectState", "ShardedTorchState", "State",
           "TorchState", "broadcast_object", "notify_hosts_updated", "run"]
