"""The guard controller: the host-side escalation ladder.

Counterpart of `horovod_tpu/guard/controller.py`.  `TrainingGuard` sits
in the training loop around the step.  The sentinel, the skip-step and
the loss scale already ran inside `DistributedOptimizer(guard=...)`; the
controller reads that verdict once a step, keeps the metrics current,
schedules the periodic cross-replica digest check, and, after K
consecutive flagged steps or on any digest mismatch, restores the last
digest-verified checkpoint, resets the wire's error feedback and bumps
the generation.

It also owns the two guard fault points (`guard.nan_grad`,
`guard.param_bitflip`): their `err` mode is turned into data corruption
rather than raised, since the guard loop must detect and recover, not
crash.
"""

from __future__ import annotations

import logging
from typing import Any, NamedTuple, Optional

import torch

from .. import faults as _faults
from ..common import basics, util
from ..metrics import catalog as _met
from . import digest as _digest
from ._tree import flatten, is_float
from .loss_scale import DynamicLossScale, GuardState

logger = logging.getLogger("horovod_tpu_torch.guard")


class GuardVerdict(NamedTuple):
    """What `TrainingGuard.observe` concluded about one step."""

    flagged: bool                   # this step's sentinel fired
    loss_scale: float               # the loss scale after the step
    nonfinite_steps: int            # consecutive flagged steps
    rollback: bool                  # escalate: restore and reset now
    mismatch_bucket: Optional[int]  # the digest-diverged bucket, if any


def _first_float_leaf(tree: Any):
    leaves, rebuild = flatten(tree)
    for i, leaf in enumerate(leaves):
        if is_float(leaf):
            return leaves, rebuild, i
    return leaves, rebuild, None


def _poison_nan(batch: Any) -> Any:
    """The batch with the first element of its first float leaf set to
    NaN (a copy of that leaf; the caller's tensor is untouched): the
    `guard.nan_grad` translation, so that backward makes non-finite
    gradients on this rank only."""
    leaves, rebuild, i = _first_float_leaf(batch)
    if i is None:
        return batch
    leaf = leaves[i].detach().clone()
    leaf.reshape(-1)[0] = float("nan")
    leaves[i] = leaf
    return rebuild(leaves)


_FLIP = {2: (torch.int16, 1 << 6), 4: (torch.int32, 1 << 20),
         8: (torch.int64, 1 << 40)}


def _flip_bit(params: Any) -> Any:
    """Flip one mantissa bit of the first element of the first float
    parameter, in place (bit 6, 20 or 40 of a 2-, 4- or 8-byte element):
    the `guard.param_bitflip` translation, a silent, still finite
    divergence of this replica for the digest check."""
    leaves, rebuild, i = _first_float_leaf(params)
    if i is None:
        return params
    leaf = leaves[i]
    first = leaf.detach()[(0,) * leaf.dim()]   # a 0-d view
    with torch.no_grad():
        if leaf.element_size() in _FLIP:
            view, bit = _FLIP[leaf.element_size()]
            first.view(view).bitwise_xor_(bit)
        else:
            # Other widths: through f32, as the JAX package does.
            v = first.to(torch.float32)
            v.view(torch.int32).bitwise_xor_(_FLIP[4][1])
            first.copy_(v)
    return rebuild(leaves)


class TrainingGuard:
    """The host-side training-health controller.

    A loop (tests/data/guard_main.py is the JAX package's recipe; the
    port's drill is in tests/test_torch_port_training_guard.py)::

        guard = TrainingGuard(scaler, checkpoint_dir=path)
        for step in range(n):
            batch, _ = guard.maybe_inject(batch, model)
            loss = scaler.scale_loss(opt.guard_state, loss_fn(model, batch))
            loss.backward(); opt.step(); opt.zero_grad()
            v = guard.observe(opt, model, step)
            if v.rollback:
                st = guard.rollback({"model": model.state_dict(),
                                     "opt": opt.state_dict()})
                model.load_state_dict(st["model"])
                opt.load_state_dict(st["opt"])
                guard.reset_guard_state(opt, scaler)
    """

    def __init__(self, scaler: Optional[DynamicLossScale] = None,
                 checkpoint_dir: Optional[str] = None, manager=None,
                 digest_interval: Optional[int] = None,
                 max_nonfinite: Optional[int] = None, process_set=None):
        self.scaler = scaler or DynamicLossScale.from_env()
        if manager is None and checkpoint_dir is not None:
            from ..utils.checkpoint import CheckpointManager
            manager = CheckpointManager(checkpoint_dir)
        self._mgr = manager
        self._digest_interval = digest_interval
        self._max_nonfinite = (
            max_nonfinite if max_nonfinite is not None
            else util.env_int("GUARD_MAX_NONFINITE", 3))
        self._ps = process_set
        self.generation = 0
        self.last_verified_step: Optional[int] = None
        self._digest_parts = None

    def digest_interval(self) -> int:
        if self._digest_interval is not None:
            return int(self._digest_interval)
        from ..utils.autotune import current_guard_digest_interval
        return current_guard_digest_interval()

    # -- fault translation ----------------------------------------------
    def maybe_inject(self, batch: Any, params: Any):
        """Fire the guard's fault points, turning `err` into data
        corruption (a NaN in a copy of the batch, a flipped bit in the
        parameters, in place) instead of raising.  Call once a step,
        before the step."""
        if not _faults.active():
            return batch, params
        try:
            _faults.point("guard.nan_grad")
        except _faults.FaultInjected:
            logger.warning("guard.nan_grad fired: poisoning batch")
            batch = _poison_nan(batch)
        try:
            _faults.point("guard.param_bitflip")
        except _faults.FaultInjected:
            logger.warning("guard.param_bitflip fired: flipping one "
                           "parameter bit")
            params = _flip_bit(params)
        return batch, params

    # -- per-step observation -------------------------------------------
    @staticmethod
    def _guard_state(opt_state: Any) -> Optional[GuardState]:
        """A `GuardState` as is, or the optimizer's `guard_state`."""
        if isinstance(opt_state, GuardState):
            return opt_state
        g = getattr(opt_state, "guard_state", None)
        return g if isinstance(g, GuardState) else None

    def observe(self, opt_state: Any, params: Any, step: int) -> GuardVerdict:
        """Read the step's verdict (one host read of three numbers),
        update the metrics, run the periodic digest check, and decide
        whether to escalate.  The caller performs the rollback."""
        gs = self._guard_state(opt_state)
        flagged, scale, nonfinite = False, 1.0, 0
        if gs is not None:
            f, scale, nf = torch.stack([
                gs.bucket_flags.max(), gs.loss_scale,
                gs.nonfinite_steps.to(torch.float32)]).tolist()
            flagged, nonfinite = f > 0, int(nf)
            if _met.enabled():
                _met.loss_scale.set(scale)
                if flagged:
                    _met.nonfinite_steps.inc()
        if flagged:
            logger.warning(
                "step %d: non-finite gradients (bucket flags %s); "
                "optimizer step skipped on all ranks, loss scale now %g "
                "(%d consecutive)", step, gs.bucket_flags.tolist(), scale,
                nonfinite)
        mismatch = None
        interval = self.digest_interval()
        if (not flagged and interval > 0 and step > 0
                and step % interval == 0):
            mismatch = self._check_digests(params)
            if mismatch is not None:
                logger.error(
                    "step %d: cross-replica parameter digest mismatch in "
                    "bucket %d (silent divergence)", step, mismatch)
                if _met.enabled():
                    _met.digest_mismatch.inc()
        rollback = mismatch is not None or (
            self._max_nonfinite > 0 and nonfinite >= self._max_nonfinite)
        return GuardVerdict(flagged=flagged, loss_scale=scale,
                            nonfinite_steps=nonfinite, rollback=rollback,
                            mismatch_bucket=mismatch)

    def _check_digests(self, params: Any) -> Optional[int]:
        if not (basics.is_initialized() and basics.size() > 1):
            return None
        d = _digest.param_digests(params, parts=self._digest_parts)
        return _digest.check_replica_divergence(d, process_set=self._ps)

    def verify_state(self, state: Any) -> Optional[int]:
        """The cross-replica digest check over any state tree: the
        diverged bucket, or None when the replicas agree (and at one
        rank, where there is nothing to compare)."""
        return self._check_digests(state)

    # -- checkpoint / rollback ------------------------------------------
    def checkpoint(self, step: int, state: Any) -> bool:
        """Digest-check `state` across replicas, then save it.  A state
        whose replicas already diverged is refused: rolling back to it
        would keep the corruption."""
        if self._mgr is None:
            return False
        mismatch = self._check_digests(state)
        if mismatch is not None:
            logger.error("refusing checkpoint at step %d: replicas already "
                         "diverged (bucket %d)", step, mismatch)
            if _met.enabled():
                _met.digest_mismatch.inc()
            return False
        self._mgr.save(step, state)
        self.last_verified_step = step
        return True

    def rollback(self, template: Any) -> Any:
        """Escalate: dump the flight recorders, restore the last
        digest-verified checkpoint (onto `template`'s devices), reset the
        wire's error-feedback residuals and bump the generation.  Returns
        the restored state, or None when there is no checkpoint (the
        caller must then re-initialize)."""
        from ..ops import wire as _wire
        if _met.enabled():
            _met.guard_rollbacks.inc()
        try:
            # A serving replica's recent history in this process is
            # context for whatever corrupted training.
            from ..serve import flightrec as _fr
            _fr.dump_all("guard_escalation")
        except Exception:  # noqa: BLE001 — forensics only
            pass           # the rollback proceeds regardless
        restored = None
        if self._mgr is not None:
            restored = self._mgr.restore_latest(template=template)
        _wire.reset_error_feedback()
        self.generation += 1
        logger.warning(
            "guard rollback: generation now %d (restored step %s)",
            self.generation,
            self._mgr.latest_step() if self._mgr is not None else None)
        return restored

    @staticmethod
    def reset_guard_state(opt_state: Any, scaler: DynamicLossScale) -> Any:
        """A fresh `GuardState` (same bucket count, same device) after a
        restore, so that stale counters do not survive the generation
        bump: set on an optimizer's `guard_state` (the optimizer is
        returned), or returned for a `GuardState`."""
        gs = TrainingGuard._guard_state(opt_state)
        if gs is None:
            return opt_state
        fresh = scaler.init(int(gs.bucket_flags.shape[0]),
                            device=gs.loss_scale.device)
        if isinstance(opt_state, GuardState):
            return fresh
        opt_state.guard_state = fresh
        return opt_state


__all__ = ["GuardVerdict", "TrainingGuard"]
