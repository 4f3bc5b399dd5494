"""Straggler-adaptive reaction: close the tracer's blame loop.

Counterpart of `horovod_tpu/trace/reaction.py`.

`core.analyze` attributes each step's critical path to a blamed rank and
a skew share; `TraceMeasurements` carries both back into the runtime.
This module is the missing actuator: a small hysteresis policy that
watches the per-window blame stream and, once one rank has been blamed
`HOROVOD_STRAGGLER_PATIENCE` windows in a row, REACTS instead of just
reporting —

* **rebalance** (default): collapse `gradient_bucket_partition` into
  fewer, larger buckets via `data_parallel.set_reaction_rebalance`, so
  the straggler pays its per-collective overhead once per step instead
  of once per bucket.  The partition change deliberately goes through
  the LOUD re-init path: the next `fused_apply` or ZeRO step raises its
  "partition changed" ValueError and the training loop must re-init
  optimizer state (fused_apply/ZeRO shards stay coherent by
  construction, never silently); the eager `allreduce_gradients`
  follows at once, and a megastep captures its graph again.
* **degrade**: past `HOROVOD_STRAGGLER_SKEW_THRESHOLD` skew share — or
  when a rank keeps drawing blame after a rebalance — escalate to the
  graceful-degradation path (evict the rank via the elastic driver).
  The policy only *decides*; eviction itself belongs to the caller
  because it is a fleet-membership action (the elastic driver's).

Every rank must feed the policy the SAME merged-trace measurements
(allgather the per-rank events and analyze identically everywhere), so
decisions stay in lockstep without an extra coordination round.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

from ..common import util

logger = logging.getLogger("horovod_tpu_torch.trace.reaction")

__all__ = ["ReactionDecision", "StragglerReactionPolicy"]


@dataclasses.dataclass(frozen=True)
class ReactionDecision:
    """One window's verdict.  `action` is "none", "rebalance", or
    "degrade"; `rank` is the blamed rank acted on (-1 for none)."""

    action: str = "none"
    rank: int = -1
    streak: int = 0
    skew_share: float = 0.0
    reason: str = ""

    @property
    def fired(self) -> bool:
        return self.action != "none"


class StragglerReactionPolicy:
    """Hysteresis policy over the per-window blamed-rank stream.

    Feed it one `TraceMeasurements` per analysis window via
    `observe()`.  A rank must be blamed `patience` consecutive windows
    (with a meaningful skew share) before anything fires; after a
    reaction the policy sleeps for `cooldown` windows so the fleet can
    settle and the next windows measure the post-reaction skew.
    """

    def __init__(
        self,
        patience: Optional[int] = None,
        skew_threshold: Optional[float] = None,
        cooldown: Optional[int] = None,
        min_skew_share: float = 0.05,
        on_rebalance: Optional[Callable[[int], None]] = None,
        on_degrade: Optional[Callable[[int], None]] = None,
    ):
        self.patience = max(1, int(
            util.env_int("STRAGGLER_PATIENCE", 3)
            if patience is None else patience))
        self.skew_threshold = float(
            util.env_float("STRAGGLER_SKEW_THRESHOLD", 0.75)
            if skew_threshold is None else skew_threshold)
        self.cooldown = max(0, int(
            util.env_int("STRAGGLER_COOLDOWN", 2)
            if cooldown is None else cooldown))
        # Below this skew share a blame is noise, not a straggler: an
        # idle fleet always blames SOMEONE (max - min > 0), and acting
        # on that would thrash the partition forever.
        self.min_skew_share = float(min_skew_share)
        self._on_rebalance = on_rebalance
        self._on_degrade = on_degrade
        self._streak_rank = -1
        self._streak = 0
        self._cooldown_left = 0
        self._rebalanced_against = -1

    # -- introspection ---------------------------------------------------
    @property
    def streak(self) -> int:
        return self._streak

    @property
    def streak_rank(self) -> int:
        return self._streak_rank

    @property
    def rebalanced_against(self) -> int:
        """Rank the partition is currently rebalanced away from (-1
        when no rebalance is active)."""
        return self._rebalanced_against

    def reset(self) -> None:
        """Forget all history (elastic generation change: rank numbers
        are reassigned, so carried-over blame would libel the wrong
        host).  An active rebalance is cleared too."""
        self._streak_rank = -1
        self._streak = 0
        self._cooldown_left = 0
        if self._rebalanced_against >= 0:
            self._rebalanced_against = -1
            if self._on_rebalance is None:
                from ..parallel import data_parallel as _dp
                _dp.clear_reaction_rebalance()

    # -- the loop --------------------------------------------------------
    def observe(self, m) -> ReactionDecision:
        """Digest one window's `TraceMeasurements`; maybe react."""
        blamed = int(getattr(m, "straggler_rank", -1))
        skew = float(getattr(m, "skew_share", 0.0))
        from ..metrics import catalog as _met
        if _met.enabled():
            _met.straggler_streak.set(self._streak)
        if self._cooldown_left > 0:
            # Settling period after a reaction: the first windows still
            # mix pre- and post-reaction steps, so blames there don't
            # count toward a new streak.
            self._cooldown_left -= 1
            return ReactionDecision(reason="cooldown")
        if blamed < 0 or skew < self.min_skew_share:
            self._streak_rank = -1
            self._streak = 0
            return ReactionDecision(reason="no credible straggler")
        if blamed == self._streak_rank:
            self._streak += 1
        else:
            self._streak_rank = blamed
            self._streak = 1
        if _met.enabled():
            _met.straggler_streak.set(self._streak)
        if self._streak < self.patience:
            return ReactionDecision(
                rank=blamed, streak=self._streak, skew_share=skew,
                reason=f"streak {self._streak}/{self.patience}")
        # Patience exhausted — act, then cool down.
        streak = self._streak
        self._streak = 0
        self._streak_rank = -1
        self._cooldown_left = self.cooldown
        if skew >= self.skew_threshold or blamed == self._rebalanced_against:
            why = ("skew share %.2f over threshold %.2f" %
                   (skew, self.skew_threshold)
                   if skew >= self.skew_threshold else
                   "still blamed after rebalance")
            logger.warning(
                "straggler reaction: DEGRADE rank %d (%s, %d blames)",
                blamed, why, streak)
            if _met.enabled():
                _met.straggler_reactions.labels("degrade").inc()
            if self._on_degrade is not None:
                self._on_degrade(blamed)
            return ReactionDecision(action="degrade", rank=blamed,
                                    streak=streak, skew_share=skew,
                                    reason=why)
        logger.warning(
            "straggler reaction: REBALANCE away from rank %d "
            "(%d consecutive blames, skew share %.2f)",
            blamed, streak, skew)
        self._rebalanced_against = blamed
        if _met.enabled():
            _met.straggler_reactions.labels("rebalance").inc()
        if self._on_rebalance is not None:
            self._on_rebalance(blamed)
        else:
            from ..parallel import data_parallel as _dp
            _dp.set_reaction_rebalance(max_buckets=1, avoid_rank=blamed)
        return ReactionDecision(action="rebalance", rank=blamed,
                                streak=streak, skew_share=skew,
                                reason="patience exhausted")
