"""Dynamic loss scaling: the GradScaler-style schedule the guard applies.

Counterpart of `horovod_tpu/guard/loss_scale.py`.  Multiply the loss by
`scale` so that small bf16 / f16 gradients survive the backward pass,
multiply the reduced gradients by 1/scale before the optimizer step,
halve the scale whenever the cross-rank sentinel flags a step (the step
is skipped on every rank alike), and grow it again after
`growth_interval` consecutive clean steps.  Every update is a
`torch.where` on the device, so the schedule reads nothing back.

The scale and the counters live in `GuardState`, which
`DistributedOptimizer(guard=...)` keeps as its `guard_state`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Union

import torch

from ..common import util
from ._tree import leaves, tree_map


class GuardState(NamedTuple):
    """The guard's per-step state: 0-d tensors and an f32[B] vector on
    the optimizer's device."""

    loss_scale: torch.Tensor       # f32 scalar: the current loss scale
    good_steps: torch.Tensor       # i32 scalar: consecutive clean steps
    nonfinite_steps: torch.Tensor  # i32 scalar: consecutive flagged
    #                                steps (the escalation ladder's K)
    bucket_flags: torch.Tensor     # f32[B]: the last step's cross-rank
    #                                per-bucket flags (attribution)
    pending_flag: torch.Tensor     # f32 scalar: OR of the accumulation
    #                                passes' flags since the last step


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class DynamicLossScale:
    """The schedule's configuration (the mutable scale and counters live
    in `GuardState`).

    `dynamic=False` pins the scale at `init_scale`: the coordinated
    skip-step still runs, and at `init_scale == 1.0` (what `from_env`
    returns when HOROVOD_GUARD_LOSS_SCALE is unset) no scaling
    arithmetic touches the gradients.  `growth_interval=None` reads the
    tuner's `loss_scale_growth_interval` (HOROVOD_GUARD_GROWTH_INTERVAL)
    at every update."""

    init_scale: float = 65536.0
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: Optional[int] = None
    dynamic: bool = True

    @classmethod
    def from_env(cls) -> "DynamicLossScale":
        """HOROVOD_GUARD_LOSS_SCALE=<initial scale> arms dynamic
        scaling; unset means skip-step only (static scale 1.0)."""
        spec = util.getenv("GUARD_LOSS_SCALE")
        if not spec:
            return cls(init_scale=1.0, dynamic=False)
        return cls(init_scale=float(spec), dynamic=True)

    def _growth_interval(self) -> int:
        if self.growth_interval is not None:
            return int(self.growth_interval)
        from ..utils.autotune import current_guard_growth_interval
        return current_guard_growth_interval()

    def init(self, n_buckets: int = 1,
             device: Union[str, torch.device, None] = None) -> GuardState:
        dev = torch.device(device if device is not None else "cpu")
        return GuardState(
            loss_scale=torch.tensor(self.init_scale, dtype=torch.float32,
                                    device=dev),
            good_steps=torch.zeros((), dtype=torch.int32, device=dev),
            nonfinite_steps=torch.zeros((), dtype=torch.int32, device=dev),
            bucket_flags=torch.zeros((max(1, n_buckets),),
                                     dtype=torch.float32, device=dev),
            pending_flag=torch.zeros((), dtype=torch.float32, device=dev))

    def scale_loss(self, state: GuardState, loss: Any) -> Any:
        """The loss (a tensor, or a tree of them) times the current
        scale: call before `backward()`; the optimizer unscales."""
        return tree_map(lambda v: v * state.loss_scale.to(v.dtype), loss)

    def unscale(self, state: GuardState, grads: Any) -> Any:
        """Gradients times 1/scale, computed in at least f32 and cast
        back to each gradient's dtype."""
        inv = torch.ones_like(state.loss_scale) / state.loss_scale

        def one(g):
            wide = torch.promote_types(g.dtype, torch.float32)
            return (g.to(wide) * inv.to(g.device)).to(g.dtype)
        return tree_map(one, grads)

    def update(self, state: GuardState,
               bucket_flags: torch.Tensor) -> GuardState:
        """Advance the schedule by one step given its cross-rank
        per-bucket flags: on a flag halve the scale and count the
        consecutive flags; on a clean step grow the scale after
        `growth_interval` of them.  The same on every rank, because the
        flags are."""
        flag = torch.maximum(bucket_flags.max(), state.pending_flag)
        bad = flag > 0
        zero = torch.zeros_like(state.nonfinite_steps)
        nonfinite = torch.where(bad, state.nonfinite_steps + 1, zero)
        good = torch.where(bad, zero, state.good_steps + 1)
        scale = state.loss_scale
        if self.dynamic:
            grow = torch.logical_and(
                torch.logical_not(bad), good >= self._growth_interval())
            scale = torch.where(
                bad, scale * _f32(self.backoff_factor, scale),
                torch.where(grow, scale * _f32(self.growth_factor, scale),
                            scale))
            good = torch.where(grow, zero, good)
        return GuardState(
            loss_scale=scale, good_steps=good, nonfinite_steps=nonfinite,
            bucket_flags=bucket_flags,
            pending_flag=torch.zeros_like(state.pending_flag))

    def accumulate(self, state: GuardState,
                   pass_flags: torch.Tensor) -> GuardState:
        """Fold one accumulation pass's flags into `pending_flag`
        (consumed and cleared by the next `update`)."""
        return state._replace(pending_flag=torch.maximum(
            state.pending_flag, pass_flags.max()))


def unscale_(scaler: DynamicLossScale, state: GuardState, grads) -> None:
    """The optimizers' unscale (the JAX package's `_unscale`,
    parallel/optimizer.py:469-483): each gradient times 1/scale rounded
    to its dtype, in place.  Nothing at a static scale of 1.0, where even
    a product by 1 could change a NaN's payload bits and break "a clean
    guarded run is bitwise the unguarded one"."""
    if not scaler.dynamic and scaler.init_scale == 1.0:
        return
    inv = torch.ones_like(state.loss_scale) / state.loss_scale
    for g in grads:
        g.mul_(inv.to(g.dtype))


def select_on_flag(flag: torch.Tensor, clean: Any, flagged: Any) -> Any:
    """Leaf by leaf `torch.where(flag > 0, flagged, clean)` over two
    matching trees: the gate a caller uses to revert state it carries
    itself on a flagged step."""
    bad = flag > 0
    fl = iter(leaves(flagged))
    return tree_map(lambda c: torch.where(bad, next(fl), c), clean)


__all__ = ["DynamicLossScale", "GuardState", "select_on_flag", "unscale_"]
